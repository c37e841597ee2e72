"""Evaluation of the port: numpy copies of ``irn_tpu.eval``."""
