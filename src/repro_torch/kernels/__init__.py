"""Hand-written Hopper kernels of the port (``range_match``: K1-K5;
``decode_attn``: K6; ``ssd_chunk``: K7)."""
