"""Models of the port: the ViT patch encoders (UNI's ViT-L/16, UNI2-h), MFMF, MIL, CLAM, the ClamMLP trunk and the flagship svd_gate family, with their factory."""
