"""Synthetic data (host numpy)."""
