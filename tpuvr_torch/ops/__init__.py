"""Geometry, the sweep op, render and lighting entry points."""
