"""Synthetic, seeded host-side data for the port's models (numpy only)."""
