"""Checkpoints and image files."""
