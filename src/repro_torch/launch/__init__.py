"""Launchers: the simulate command line."""
