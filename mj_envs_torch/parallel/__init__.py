"""Vectorized (chunked) environments."""
