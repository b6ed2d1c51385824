"""Reaction-network generators, one file per configuration kind."""
