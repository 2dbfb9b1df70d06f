"""The batched ray-cast renderer of the PyTorch port."""
