"""Host-side cost model (``cost_model``)."""
