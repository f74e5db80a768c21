"""Sinnamon sketch + bit-packed streaming inverted index + the engine."""
