"""Task drivers of the port (counterpart of :mod:`mvlt_tpu.tasks`)."""
