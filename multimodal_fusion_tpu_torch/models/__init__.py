"""Models of the port: the ViT-L/16 patch encoder and the MFMF survival model with its factory."""
