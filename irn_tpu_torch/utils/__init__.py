"""Checkpoint I/O and weight conversion of the port."""
