"""Host data pieces of the port: datasets, the loader and the device
prefetch."""
