"""Hand-written Hopper kernels of the port (see ``range_match``)."""
