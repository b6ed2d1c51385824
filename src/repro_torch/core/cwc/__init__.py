"""Calculus of Wrapped Compartments: terms, rules, compiler, models."""
