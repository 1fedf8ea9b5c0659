"""Packed training data (``packing``, ``distributions``, ``pipeline``):
host numpy arrays, made from a seed exactly as the JAX package makes
them."""
