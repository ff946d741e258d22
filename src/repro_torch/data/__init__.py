"""Synthetic graph data."""
