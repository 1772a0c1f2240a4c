"""Models of the PyTorch port (counterparts of ``dalle_tpu/models``)."""
