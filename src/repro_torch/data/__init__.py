"""Synthetic data shared draw-for-draw with the JAX reference: sparse
corpora (paper Table 3 shapes, ``synth``), LM and recsys batches
(``loaders``) and graphs (``graph``)."""
