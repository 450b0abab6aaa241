"""Synthetic scenes and camera fixtures."""
