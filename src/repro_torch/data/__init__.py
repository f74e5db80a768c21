"""Synthetic data shared draw-for-draw with the JAX reference: sparse
corpora (paper Table 3 shapes, ``synth``) and LM and recsys batches
(``loaders``)."""
