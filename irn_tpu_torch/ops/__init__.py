"""Kernels and device ops of the port (see ``irn_tpu_torch``)."""
