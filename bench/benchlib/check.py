"""Deciding ``correct``: the window's answers against the plain reference.

Once the window has closed and the system's state is freed, a sample of
the window's steps is drawn from the seed and their query batches are
judged.  The reference (``bench/reference``) is given the same inputs the
system was given: the corpus, redrawn chunk by chunk from the seed.  It
scores every live document for all the judged queries in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import data as bdata
from reference import compare
from reference.sinnamon import RefIndex


def sample_steps(steps: list, seed: int, traffic: dict) -> dict:
    """{step position: query rows judged} for ``check.steps`` window steps
    drawn from the seed (the last window step always among them) and up to
    ``check.queries_per_step`` queries of each."""
    chk = traffic["check"]
    win = [i for i, s in enumerate(steps) if s.phase == "window"]
    rng = np.random.Generator(np.random.Philox(
        key=bdata.stream_seed(seed, "check")))
    n = min(int(chk["steps"]), len(win))
    picked = set(rng.choice(win[:-1], size=max(n - 1, 0), replace=False)
                 .tolist()) | {win[-1]} if win else set()
    out = {}
    for i in sorted(picked):
        B = int(traffic["query_batch"])
        q = min(int(chk["queries_per_step"]), B)
        out[i] = np.sort(rng.choice(B, size=q, replace=False))
    return out


def build(cfg: dict, seed: int, device, cell_dtype=None,
          store_dtype=None) -> RefIndex:
    """The reference index of the configuration's corpus, drawn again
    from the seed."""
    data = cfg["data"]
    ref = RefIndex(cfg["index"], device, int(data["docs"]), cell_dtype,
                   store_dtype)
    cdf = bdata.activation_cdf(data, device)
    for c in range(bdata.n_chunks(data)):
        numbers, idx, val = bdata.corpus_chunk(seed, data, c, cdf, device)
        ref.insert(numbers, bdata.doc_id(numbers), idx, val)
    return ref


def _queries(steps, pools, judged):
    qi = torch.cat([pools["query_idx"][steps[i].query_batch][rows]
                    for i, rows in judged.items()])
    qv = torch.cat([pools["query_val"][steps[i].query_batch][rows]
                    for i, rows in judged.items()])
    return qi, qv


def _slots_of(ref: RefIndex, ids: np.ndarray) -> torch.Tensor:
    """Reference slots of external ids (-1 where no live document has
    the id)."""
    live_ids = torch.where(ref.live, ref.ids, -1)
    order = torch.argsort(live_ids)
    srt = live_ids[order]
    want = torch.as_tensor(ids, dtype=torch.int64, device=ref.device)
    pos = torch.searchsorted(srt, want.reshape(-1)).clamp_max(len(srt) - 1)
    hit = (srt[pos] == want.reshape(-1)) & (want.reshape(-1) >= 0)
    return torch.where(hit, order[pos], -1).view(want.shape)


def check(cfg: dict, traffic: dict, seed: int, steps: list, pools: dict,
          device, answers=None) -> dict:
    """Judge the sampled queries.  ``answers`` (optional) maps a step
    position to (ids, scores) that stand in for the system's answers of
    that step (the control).  Returns :func:`reference.compare.judge`'s
    result plus ``judged`` (queries)."""
    judged = sample_steps(steps, seed, traffic)
    kprime, k = int(cfg["serving"]["kprime"]), int(cfg["serving"]["k"])
    chk = cfg["check"]
    ref = build(cfg, seed, device)
    qi, qv = _queries(steps, pools, judged)
    ids = np.concatenate([(answers[i][0] if answers else steps[i].ids)[rows]
                          for i, rows in judged.items()])
    scores = np.concatenate([(answers[i][1] if answers
                              else steps[i].scores)[rows]
                             for i, rows in judged.items()])
    cand = ref.candidates(qi, qv, kprime, k)
    s_ub, s_ex = ref.rows_scores(qi, qv, _slots_of(ref, ids))
    c_ub, c_ex = ref.rows_scores(qi, qv, cand["ub_slots"])
    out = compare.judge(
        ids, scores, cand, s_ub, s_ex, c_ub, c_ex,
        ref.ids[cand["ub_slots"]], ref.ids[cand["top_slots"]], kprime,
        float(chk["ub_band"]), float(chk["score_err"]))
    out["judged"] = len(ids)
    return out


def reference_answers(cfg: dict, traffic: dict, seed: int, steps: list,
                      pools: dict, device, cell_dtype, store_dtype) -> dict:
    """The control: the reference's own answers (Algorithm 7 over its own
    candidates) at the sampled steps, its cells and store in the given
    types.  {step position: (ids [B, k], scores [B, k])}."""
    judged = sample_steps(steps, seed, traffic)
    kprime, k = int(cfg["serving"]["kprime"]), int(cfg["serving"]["k"])
    B = int(traffic["query_batch"])
    ref = build(cfg, seed, device, cell_dtype, store_dtype)
    qi, qv = _queries(steps, pools, judged)
    ids, scores = ref.answers(qi, qv, kprime, k)
    out, at = {}, 0
    for i, rows in judged.items():
        out[i] = (np.full((B, k), -1, np.int64), np.zeros((B, k), np.float32))
        out[i][0][rows] = ids[at:at + len(rows)]
        out[i][1][rows] = scores[at:at + len(rows)]
        at += len(rows)
    return out
