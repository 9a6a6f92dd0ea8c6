"""Training of the port: optimizer and train steps."""
