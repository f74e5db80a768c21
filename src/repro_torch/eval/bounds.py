"""Empirical-vs-theory: measured sketch overestimates against the §5 bounds.

Counterpart of ``repro.eval.bounds``.  Theorem 5.1 promises that the
decoded value of an active coordinate never undershoots the true value;
Eq. (13) (:mod:`repro_torch.core.theory`) predicts how far it overshoots.
This module decodes every active coordinate of (a sample of) the stored
documents of a live index, subtracts the stored truth, and compares the
measured tail ``P[err > δ]`` with the theoretical one.

Two deliberate wrinkles, as in the reference:

* **Quantized cells** (bf16/f8) sit up to one directed-rounding ulp above
  the real-valued sketch the theory models, so the empirical tail is
  measured at ``δ + margin`` (:func:`quantization_margin`).
* **Churn drift** (§4.3 delete-then-recycle residue) makes a live index
  looser than theory on purpose; :func:`churn_overestimate` measures the
  clean -> churned -> compacted trajectory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import sketch, theory


def per_coordinate_overestimate(index: eng.SinnamonIndex, *,
                                max_docs: int = 4096,
                                seed: int = 0) -> np.ndarray:
    """Measured ``decode(j) - x[j]`` over active (doc, coordinate) pairs of
    up to ``max_docs`` live documents (the reference's numpy sample), f32.

    Non-negative everywhere on a clean index with float32 raw storage
    (Theorem 5.1); dirty columns show churn residue.
    """
    state = index.state
    active = np.flatnonzero(state.active.cpu().numpy())
    if active.size == 0:
        return np.zeros((0,), np.float32)
    if active.size > max_docs:
        gen = np.random.default_rng(seed)
        active = gen.choice(active, size=max_docs, replace=False)
    slots = torch.as_tensor(np.sort(active), device=state.device)
    idx = state.store.indices[slots]                        # [S, P]
    val = state.store.values[slots].to(torch.float32)       # [S, P]
    cols = lambda side: sketch.cell_bits(side)[:, slots].T.view(  # noqa: E731
        side.dtype)                                         # [S, m]
    ub, _ = sketch.decode_vector(state.mappings, cols(state.u),
                                 None if state.l is None else cols(state.l),
                                 idx)
    err = (ub - val)[idx >= 0]
    return err.cpu().numpy().astype(np.float32)


def quantization_margin(index: eng.SinnamonIndex) -> float:
    """One directed-rounding ulp at the largest stored cell magnitude
    (0 for f32 cells): ``eps(dtype) · max|cell|``, conservative."""
    sk = index.state.sketch
    if sk.dtype == torch.float32:
        return 0.0
    top = float(sk.to(torch.float32).abs().max())
    return float(torch.finfo(sk.dtype).eps) * top


def check_upper_bounds(index: eng.SinnamonIndex, *, value_dist,
                       sum_p: Optional[float] = None,
                       deltas: Sequence[float] = (0.25, 0.5, 1.0),
                       slack: float = 0.05, max_docs: int = 4096,
                       seed: int = 0) -> dict:
    """Measured overestimate tails vs the Eq. (13) theoretical tails.

    value_dist: a ``(pdf, cdf, grid)`` triple from
    :mod:`repro_torch.core.theory` matching the corpus's value law.
    ``sum_p``: the active mass Σp (mean actives per document), estimated
    from the stored documents when None.  The verdict per δ is
    ``P̂[err > δ + margin] <= P_theory[err > δ] + slack``.

    Returns ``{"ok", "n_coords", "sum_p", "margin", "min_err", "checks"}``
    with one ``{"delta", "empirical", "bound", "ok"}`` row per δ.
    """
    errs = per_coordinate_overestimate(index, max_docs=max_docs, seed=seed)
    if errs.size == 0:
        raise ValueError("index holds no active documents to measure")
    if sum_p is None:
        state = index.state
        act = state.active.cpu().numpy()
        nnz = (state.store.indices >= 0).sum(dim=1).cpu().numpy()
        sum_p = float(nnz[act].mean())
    pdf, cdf, grid = value_dist
    margin = quantization_margin(index)
    spec = index.spec
    checks = []
    for delta in deltas:
        emp = float((errs > delta + margin).mean())
        bound = float(1.0 - theory.error_cdf(float(delta), pdf, cdf, grid,
                                             sum_p, spec.m, spec.h))
        checks.append({"delta": float(delta), "empirical": emp,
                       "bound": bound, "ok": emp <= bound + slack})
    return {"ok": all(c["ok"] for c in checks),
            "n_coords": int(errs.size), "sum_p": float(sum_p),
            "margin": float(margin), "min_err": float(errs.min()),
            "checks": checks}


def churn_overestimate(spec: eng.EngineSpec, doc_idx, doc_val, *,
                       rounds: int = 2, frac: float = 0.25,
                       seed: int = 0, max_docs: int = 2048,
                       device=None) -> dict:
    """The drift trajectory: clean -> churned -> compacted overestimates.

    Builds an index on ``device`` (None: the card), then runs ``rounds`` of
    §4.3 churn (delete a random ``frac`` of the corpus, re-insert the same
    vectors into the recycled, dirty slots), measuring the maximum
    per-coordinate overestimate and ``slot_drift`` at each stage;
    ``compact()`` must return both to the clean regime.  Each round's
    deletes are one ``delete_many``, which leaves the state of the
    reference's one-by-one deletes.
    """
    from repro_torch.eval import recall as _recall

    index = _recall.build_index(spec, doc_idx, doc_val, device=device)
    gen = np.random.default_rng(seed)
    docs = len(doc_idx)

    def stage() -> dict:
        errs = per_coordinate_overestimate(index, max_docs=max_docs,
                                           seed=seed)
        return {"err_max": float(errs.max()),
                "err_mean": float(errs.mean()),
                "drift_max": float(index.slot_drift().max())}

    def rows(x, pick):
        return x[torch.as_tensor(pick, device=x.device)] \
            if isinstance(x, torch.Tensor) \
            else np.asarray(x)[pick]

    clean = stage()
    for _ in range(rounds):
        pick = gen.choice(docs, size=max(1, int(frac * docs)), replace=False)
        index.delete_many(pick.tolist())
        index.insert_many(pick.tolist(), rows(doc_idx, pick),
                          rows(doc_val, pick))
    churned = stage()
    rebuilt = index.compact()
    compacted = stage()
    return {"clean": clean, "churned": churned, "compacted": compacted,
            "columns_rebuilt": int(rebuilt)}
