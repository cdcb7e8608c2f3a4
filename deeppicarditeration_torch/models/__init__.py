"""models layer of the PyTorch port (counterpart of deeppicarditeration_tpu/models)."""
