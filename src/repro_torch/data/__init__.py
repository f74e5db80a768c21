"""Synthetic sparse corpora (paper Table 3 shapes), shared draw-for-draw
with the JAX reference."""
