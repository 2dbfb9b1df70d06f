"""Batched physics of the PyTorch port (batch-first tensors)."""
