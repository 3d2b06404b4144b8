"""HDF5 storage and synthetic fixtures of the port."""
