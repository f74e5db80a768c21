"""The comparison that decides ``correct``: served answers against the
plain reference, query by query.

For each judged query the reference gives its candidate threshold τ (the
k'-th largest upper bound over the live documents), its k' candidates
with float64 upper bounds and exact scores, and the float64 scores of
every document the program returned.  Two numbers come out:

* ``score_err``: the largest gap between a served score and the exact
  inner product of the document served, over every served answer, as a
  share of the query's best exact score.  It holds the rerank, the store's
  precision and the external-id map.
* ``rank_faults``: served answers that no correct run of Algorithms 6-7
  could give, plus answers that every correct run gives and the program
  left out.  An answer is at fault when its document is not live, appears
  twice, stands out of score order, or has an upper bound below
  τ·(1 - band) (it could not have been a candidate); a document is missing
  when its upper bound is above τ·(1 + band) (every correct run keeps it as
  a candidate), its exact score beats the program's k-th by more than
  twice the ``score_err`` limit, and it was not served.  The band covers
  float32 sums in another order than the reference's; upper bounds within
  it may fall on either side of the cut.

Also returned, not judged: recall@k against the exact top-k.
"""

from __future__ import annotations

import numpy as np
import torch


def judge(prog_ids: np.ndarray, prog_scores: np.ndarray, ref: dict,
          served_ub: torch.Tensor, served_exact: torch.Tensor,
          cand_ub: torch.Tensor, cand_exact: torch.Tensor,
          cand_ids: torch.Tensor, top_ids: torch.Tensor, kprime: int,
          band: float, score_limit: float) -> dict:
    """Judge one group of queries [B] (see the module docstring).

    ``ref``: the reference's :meth:`RefIndex.candidates` result;
    ``served_ub`` / ``served_exact`` float64 [B, k] at the served ids (-inf
    where the id is not live); ``cand_*`` [B, k'] for the candidates;
    ``top_ids`` the exact top-k ids [B, k].
    """
    ids = torch.as_tensor(prog_ids, dtype=torch.int64)
    scores = torch.as_tensor(prog_scores, dtype=torch.float64)
    served_ub, served_exact = served_ub.cpu(), served_exact.cpu()
    cand_ub, cand_exact = cand_ub.cpu(), cand_exact.cpu()
    cand_ids, top_ids = cand_ids.cpu(), top_ids.cpu()
    B, k = ids.shape
    kp = ref["ub"].shape[1]
    tau = ref["ub"][:, kp - 1].cpu().to(torch.float64) if kp >= kprime \
        else torch.full((B,), -torch.inf, dtype=torch.float64)
    best = ref["top"][:, 0].cpu().to(torch.float64)
    scale = torch.where(torch.isfinite(best) & (best.abs() > 0), best.abs(),
                        torch.ones_like(best))

    live = torch.isfinite(served_exact)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    for j in range(1, k):
        dup[:, j] = (ids[:, j:j + 1] == ids[:, :j]).any(1)
    disorder = torch.zeros_like(dup)
    disorder[:, 1:] = ~(scores[:, 1:] <= scores[:, :-1])
    low = tau[:, None] - band * tau.abs()[:, None]
    not_cand = live & (served_ub < low)
    finite = torch.isfinite(scores)
    gap = torch.where(live & finite, (scores - served_exact).abs()
                      / scale[:, None], torch.inf)
    gap = torch.where(live, gap, 0.0)
    score_err = float(gap.max()) if gap.numel() else 0.0

    high = tau[:, None] + band * tau.abs()[:, None]
    kth = scores[:, k - 1:k]
    sure = cand_ub > high
    beats = cand_exact > kth + 2 * score_limit * scale[:, None]
    served = (cand_ids[:, :, None] == ids[:, None, :]).any(-1)
    missing = sure & beats & ~served

    faults = {"not_live": int((~live).sum()), "duplicate": int(dup.sum()),
              "out_of_order": int(disorder.sum()),
              "not_a_candidate": int(not_cand.sum()),
              "not_finite": int((live & ~finite).sum()),
              "missing": int(missing.sum())}
    hits = (ids[:, :, None] == top_ids[:, None, :]).any(-1).sum()
    return {"score_err": score_err, "rank_faults": sum(faults.values()),
            "faults": faults, "recall_hits": int(hits),
            "recall_total": int(B * k)}


def merge(parts: list) -> dict:
    """Combine the :func:`judge` results of several groups."""
    out = {"score_err": 0.0, "rank_faults": 0, "faults": {},
           "recall_hits": 0, "recall_total": 0}
    for p in parts:
        out["score_err"] = max(out["score_err"], p["score_err"])
        out["rank_faults"] += p["rank_faults"]
        out["recall_hits"] += p["recall_hits"]
        out["recall_total"] += p["recall_total"]
        for key, v in p["faults"].items():
            out["faults"][key] = out["faults"].get(key, 0) + v
    return out
