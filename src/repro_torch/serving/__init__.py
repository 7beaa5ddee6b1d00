"""Serving over compiled int8 programs."""
