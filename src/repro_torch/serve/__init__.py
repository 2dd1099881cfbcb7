"""Batched serving with grid-routed request placement."""
