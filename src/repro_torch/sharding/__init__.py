"""Logical axis names and the one-device topology."""
