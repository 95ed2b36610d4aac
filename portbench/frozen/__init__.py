"""Frozen copies of the program's generators, codec and bound constants."""
