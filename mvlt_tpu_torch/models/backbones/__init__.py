"""Visual backbones of the port."""
