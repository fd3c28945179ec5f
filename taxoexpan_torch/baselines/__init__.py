"""Baselines on the port's data modules (numpy only)."""
