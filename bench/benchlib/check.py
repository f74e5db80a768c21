"""Deciding ``correct``: the window's answers against the plain reference.

Once the window has closed and the system's state is freed, a sample of
the window's steps is drawn from the seed and their query batches are
judged.  The reference is the module at the configuration's ``reference``
path (:func:`benchlib.spec.reference`).  It is given the same inputs the
system was given (the corpus, redrawn chunk by chunk from the seed, and
each step's ``writes``) and its ``states(cfg, seed, device, steps,
judged, cell_dtype, store_dtype)`` yields, in step order, (positions,
state): the state that the judged steps at those positions are judged
against.  Each group's queries are scored against every live document of
its state in one pass, and ``reference/compare.py`` judges them; the
groups' results are merged.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import data as bdata
from benchlib import spec as bspec
from reference import compare


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


def _queries(steps, pools, judged):
    qi = torch.cat([pools["query_idx"][steps[i].query_batch][rows]
                    for i, rows in judged.items()])
    qv = torch.cat([pools["query_val"][steps[i].query_batch][rows]
                    for i, rows in judged.items()])
    return qi, qv


def _slots_of(ref, ids: np.ndarray) -> torch.Tensor:
    """Reference slots of external ids (-1 where no live document has
    the id)."""
    live_ids = torch.where(ref.live, ref.ids, -1)
    order = torch.argsort(live_ids)
    srt = live_ids[order]
    want = torch.as_tensor(ids, dtype=torch.int64, device=ref.device)
    pos = torch.searchsorted(srt, want.reshape(-1)).clamp_max(len(srt) - 1)
    hit = (srt[pos] == want.reshape(-1)) & (want.reshape(-1) >= 0)
    return torch.where(hit, order[pos], -1).view(want.shape)


def _states(cfg, seed, device, steps, judged, cell_dtype=None,
            store_dtype=None):
    """(judged steps of one group, reference state) in step order."""
    mod = bspec.reference(cfg["reference"])
    for positions, ref in mod.states(cfg, seed, device, steps, judged,
                                     cell_dtype, store_dtype):
        yield {i: judged[i] for i in positions}, ref


def check(cfg: dict, traffic: dict, seed: int, steps: list, pools: dict,
          device, answers=None) -> dict:
    """Judge the sampled queries.  ``answers`` (optional) maps a step
    position to (ids, scores) that stand in for the system's answers of
    that step (the control).  Returns :func:`reference.compare.judge`'s
    result, merged over the groups, plus ``judged`` (queries)."""
    judged = sample_steps(steps, seed, traffic)
    kprime, k = int(cfg["serving"]["kprime"]), int(cfg["serving"]["k"])
    chk = cfg["check"]
    parts, n = [], 0
    for group, ref in _states(cfg, seed, device, steps, judged):
        qi, qv = _queries(steps, pools, group)
        ids = np.concatenate([(answers[i][0] if answers
                               else steps[i].ids)[rows]
                              for i, rows in group.items()])
        scores = np.concatenate([(answers[i][1] if answers
                                  else steps[i].scores)[rows]
                                 for i, rows in group.items()])
        cand = ref.candidates(qi, qv, kprime, k)
        s_ub, s_ex = ref.rows_scores(qi, qv, _slots_of(ref, ids))
        c_ub, c_ex = ref.rows_scores(qi, qv, cand["ub_slots"])
        parts.append(compare.judge(
            ids, scores, cand, s_ub, s_ex, c_ub, c_ex,
            ref.ids[cand["ub_slots"]], ref.ids[cand["top_slots"]], kprime,
            float(chk["ub_band"]), float(chk["score_err"])))
        n += len(ids)
    out = compare.merge(parts)
    out["judged"] = n
    return out


def reference_answers(cfg: dict, traffic: dict, seed: int, steps: list,
                      pools: dict, device, cell_dtype, store_dtype) -> dict:
    """The control: the reference's own answers (Algorithm 7 over its own
    candidates) at the sampled steps, its cells and store in the given
    types.  {step position: (ids [B, k], scores [B, k])}."""
    judged = sample_steps(steps, seed, traffic)
    kprime, k = int(cfg["serving"]["kprime"]), int(cfg["serving"]["k"])
    B = int(traffic["query_batch"])
    out = {}
    for group, ref in _states(cfg, seed, device, steps, judged, cell_dtype,
                              store_dtype):
        qi, qv = _queries(steps, pools, group)
        ids, scores = ref.answers(qi, qv, kprime, k)
        at = 0
        for i, rows in group.items():
            out[i] = (np.full((B, k), -1, np.int64),
                      np.zeros((B, k), np.float32))
            out[i][0][rows] = ids[at:at + len(rows)]
            out[i][1][rows] = scores[at:at + len(rows)]
            at += len(rows)
    return out
