"""ResNet-50 and IRNet modules of the port (NCHW)."""
