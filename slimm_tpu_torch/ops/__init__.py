"""Kernels of the profile core (ops/hist.py) and their build (ops/_build.py)."""
