"""Optimizers of the port: AdamW (``adamw``)."""
