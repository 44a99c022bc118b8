"""Synthetic, sharded, resumable training data (numpy)."""
