"""The demo of the PyTorch port (counterpart of the repo's ``demo/``)."""
