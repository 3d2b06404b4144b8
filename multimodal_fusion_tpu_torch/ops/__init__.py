"""Numeric ops of the port: similarity, KMeans, KNN, attention, resizing and their CUDA kernels."""
