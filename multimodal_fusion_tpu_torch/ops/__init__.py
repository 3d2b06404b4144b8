"""Numeric ops of the port: similarity, KMeans, KNN and their CUDA kernels."""
