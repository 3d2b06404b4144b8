"""Models of the port: the ViT-L/16 patch encoder."""
