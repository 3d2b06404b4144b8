"""Models of the port: the ViT-L/16 patch encoder, MFMF, MIL, CLAM, the ClamMLP trunk and the flagship svd_gate family, with their factory."""
