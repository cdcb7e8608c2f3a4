"""utilities of the PyTorch port (counterpart of deeppicarditeration_tpu/utils)."""
