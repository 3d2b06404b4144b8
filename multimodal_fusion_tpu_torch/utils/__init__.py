"""Utilities of the port: the fold logger."""
