"""Data pipeline: deterministic synthetic token streams with prefetch;
port of `repro/data`."""
