"""The decoder for serving (``model``), its layers and the converter from
the JAX package's parameters (``convert``)."""
