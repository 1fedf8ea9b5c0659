"""Data layout constants (see ``packing``)."""
