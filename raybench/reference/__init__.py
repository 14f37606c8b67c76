"""The benchmark's plain reference (``terrain.py``): it imports nothing of
the program and nothing the program made."""
