"""Metrics for training runs."""
