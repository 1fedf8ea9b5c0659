"""Step factories (``step``)."""
