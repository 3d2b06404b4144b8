"""Data pipelines of the port: TMA patch feature extraction."""
