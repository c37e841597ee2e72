"""The port's CLI and stages."""
