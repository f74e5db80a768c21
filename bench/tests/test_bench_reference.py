"""The plain reference: what it imports, its directed rounding, and its
inserts (slots, sketch columns) against a brute-force model of the same
semantics."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from benchtest import BENCH  # noqa: E402

sys.path.insert(0, str(BENCH))
from reference import compare  # noqa: E402
from reference.sinnamon import RefIndex, round_directed  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("sub", ("reference", "roofline", "laws", "loops"))
def test_yardstick_imports_neither_jax_nor_the_program(sub):
    files = sorted((BENCH / sub).rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & BANNED, f


def test_harness_imports_the_port_in_one_place():
    """Only ``benchlib/system.py`` imports the port, and nothing of the
    harness imports JAX or the JAX package."""
    users = {}
    for f in BENCH.rglob("*.py"):
        if "tests" not in f.parts:
            found = _imports(f) & BANNED
            if found:
                users[f.name] = found
    assert users == {"system.py": {"repro_torch"}}


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float8_e4m3fn))
def test_round_directed_brackets(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(20_000, generator=g) * torch.exp(
        4 * torch.randn(20_000, generator=g))
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-30, 448.0,
                                    500.0])])
    top = torch.finfo(dtype).max
    up = round_directed(x, dtype, True).to(torch.float32)
    dn = round_directed(x, dtype, False).to(torch.float32)
    xc = x.clamp(-top, top)
    assert (up >= xc).all() and (dn <= xc).all()
    # each is the nearest value of the type on its side: nothing between
    grid = torch.arange(0, 2 ** (8 * dtype.itemsize), dtype=torch.int64)
    vals = grid.to(torch.int16 if dtype.itemsize == 2 else torch.uint8) \
        .view(dtype).to(torch.float32)
    vals = vals[torch.isfinite(vals)].unique()
    ok = torch.isfinite(xc)
    lo = torch.searchsorted(vals, xc[ok], right=True) - 1
    hi = torch.searchsorted(vals, xc[ok], right=False)
    assert torch.equal(dn[ok], vals[lo.clamp(0, len(vals) - 1)])
    assert torch.equal(up[ok], vals[hi.clamp(0, len(vals) - 1)])


def _brute_state(batches, m, maps):
    """Slots and sketch columns, written out the long way: documents take
    slots in the order they come, each cell the largest value mapped to
    it."""
    slot_of, col = {}, {}
    for nums, docs in batches:
        for x, (idx, val) in zip(nums, docs):
            s = len(slot_of)
            u = np.zeros(m, np.float32)
            for i, v in zip(idx, val):
                if i >= 0:
                    u[maps[i]] = max(u[maps[i]], v) if u[maps[i]] else v
            col[s] = u
            slot_of[x] = s
    return slot_of, col


def test_inserts_match_brute_force():
    cfg = {"n": 50, "m": 8, "h": 1, "capacity": 64, "max_nnz": 6,
           "cell_dtype": "f32", "store_dtype": "float32", "seed": 3}
    g = np.random.default_rng(1)
    ref = RefIndex(cfg, "cpu", 200)
    maps = ref.maps[0, :50].numpy()
    batches, nxt = [], 0
    for _ in range(8):
        nums = list(range(nxt, nxt + 7))
        nxt += 7
        docs = []
        for _ in nums:
            k = g.integers(1, 7)
            idx = np.full(6, -1)
            idx[:k] = np.sort(g.choice(50, size=k, replace=False))
            val = np.where(idx >= 0, g.random(6) + 0.1, 0).astype(np.float32)
            docs.append((idx, val))
        batches.append((nums, docs))
        t = torch.tensor(nums)
        ref.insert(t, t + 1000, torch.tensor(np.stack([d[0] for d in docs]),
                                             dtype=torch.int32),
                   torch.tensor(np.stack([d[1] for d in docs])))
    slot_of, col = _brute_state(batches, 8, maps)
    for x, s in slot_of.items():
        assert int(ref.slot_of[x]) == s
        assert int(ref.ids[s]) == x + 1000
        np.testing.assert_array_equal(ref.u[s].numpy(), col[s])
    assert int(ref.live.sum()) == len(slot_of)
    with pytest.raises(RuntimeError):
        ref.insert(torch.tensor([0]), torch.tensor([1000]),
                   torch.full((1, 6), -1, dtype=torch.int32),
                   torch.zeros((1, 6)))


def test_judge_counts_each_fault():
    B, k, kp = 2, 3, 4
    ref = {"ub": torch.tensor([[9.0, 8, 7, 6], [5.0, 4, 3, 2]]),
           "top": torch.tensor([[8.0, 7, 6], [4.0, 3, 2]])}
    cand_ids = torch.tensor([[10, 11, 12, 13], [20, 21, 22, 23]])
    cand_ub = ref["ub"].double()
    cand_ex = torch.tensor([[8.0, 7, 6, 1], [4.0, 3, 2, 1]]).double()
    ids = np.array([[10, 11, 12], [20, 21, 22]])
    scores = np.array([[8.0, 7, 6], [4.0, 3, 2]], np.float32)
    ok = compare.judge(ids, scores, ref, cand_ub[:, :3], cand_ex[:, :3],
                       cand_ub, cand_ex, cand_ids, cand_ids[:, :3], kp,
                       1e-4, 1e-5)
    assert ok["rank_faults"] == 0 and ok["score_err"] < 1e-9
    assert ok["recall_hits"] == B * k
    bad_ids = ids.copy()
    bad_ids[0, 2] = 99                          # no live document
    s_ex = cand_ex[:, :3].clone()
    s_ex[0, 2] = -torch.inf
    out = compare.judge(bad_ids, scores, ref, cand_ub[:, :3], s_ex, cand_ub,
                        cand_ex, cand_ids, cand_ids[:, :3], kp, 1e-4, 1e-5)
    assert out["faults"]["not_live"] == 1
    bad_scores = scores.copy()
    bad_scores[1, 0] = 4.01                     # off by 0.25% of the best
    out = compare.judge(ids, bad_scores, ref, cand_ub[:, :3], cand_ex[:, :3],
                        cand_ub, cand_ex, cand_ids, cand_ids[:, :3], kp,
                        1e-4, 1e-5)
    assert out["score_err"] == pytest.approx(0.01 / 4, rel=1e-3)
    low_ub = cand_ub[:, :3].clone()
    low_ub[1, 2] = 1.0                          # below tau = 2
    out = compare.judge(ids, scores, ref, low_ub, cand_ex[:, :3], cand_ub,
                        cand_ex, cand_ids, cand_ids[:, :3], kp, 1e-4, 1e-5)
    assert out["faults"]["not_a_candidate"] == 1
