"""Serving engine and request router on PyTorch (counterpart of
``repro.serving``)."""
