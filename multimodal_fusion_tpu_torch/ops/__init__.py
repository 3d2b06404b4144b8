"""Numeric ops of the port: similarity, KMeans, KNN, attention (forward and backward), masking, losses, resizing and their CUDA kernels."""
