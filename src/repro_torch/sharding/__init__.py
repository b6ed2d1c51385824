"""Logical axis names, meshes of (possibly repeated) devices, the
per-axis layout rules and the in-process collectives."""
