"""Data pipelines of the port: TMA patch feature extraction, the survival dataset, its k-fold splits and window batching."""
