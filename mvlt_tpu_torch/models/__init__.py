"""Model modules of the port: backbones, the fusion encoder and the task heads."""
