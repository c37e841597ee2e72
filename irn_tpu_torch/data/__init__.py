"""Image I/O and data sources of the port."""
