"""Block alignment shared by the serving scheduler and the cache layout.

The port's counterpart of ``repro.data.packing``, cut to what the serving
slice uses: ``BLOCK``, the 128-token piece alignment.  Every prefill piece
is aligned to it so q blocks stay request-pure, and the serving cache
length is padded to it.  Document packing for training comes with the
training slice.
"""
from __future__ import annotations

BLOCK = 128
