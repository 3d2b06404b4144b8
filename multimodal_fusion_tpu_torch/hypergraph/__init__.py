"""Hypergraph construction (PyTorch port of the per-slide build)."""
