"""Atomic checkpoints with per-leaf checksums."""
