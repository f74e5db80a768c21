"""Kernel B's rerank form: ``csr_rerank_topk`` against the reference.

``repro_torch.kernels.csr_rerank.csr_rerank_topk_plain`` (the kernel's
plain twin) and the port's ``engine.rerank_topk`` are held against
``repro.core.engine.rerank_topk`` on the same seeded numpy inputs: ids and
slots equal, scores within rtol = atol = 1e-6 (f32 sums in another order).
The cases cover duplicate and padded query coordinates, row pads, f32 and
bf16 values, P in {1, 7, 128}, B in {1, 16}, k in {1, 10, K'}, candidates
gated to -inf (fewer finite than k included) and exact ties, which both
break by candidate position.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``); here the wrapper's checks and its launch
count are pinned on CPU tensors.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import engine as jeng  # noqa: E402
from repro.storage import vecstore as jvs  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import csr_rerank  # noqa: E402
from repro_torch.storage import vecstore as tvs  # noqa: E402

N, C, KP, LQ = 300, 96, 40, 16
VDT = {"f32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}


def _operands(seed, B, P, vdt="f32", integer=False, gate=0.2):
    """Padded-CSR rows with pads, queries with duplicate and padded
    coordinates, candidate lists (distinct slots per query) with a share
    gated to -inf.  ``integer`` draws small integers, so every sum is
    exact and ties are common."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (C, P)).astype(np.int32)
    idx[rng.random((C, P)) < 0.25] = -1                     # row pads
    qi = rng.integers(0, N // 4, (B, LQ)).astype(np.int32)  # duplicates
    qi[:, -3:] = -1                                          # query pads
    h = min(P // 2, LQ // 2)
    if h:                                            # overlap with some rows
        qi[:, :h] = idx[rng.integers(0, C, B), :h]
    if integer:
        val = rng.integers(-3, 4, (C, P)).astype(np.float32)
        qv = rng.integers(-2, 3, (B, LQ)).astype(np.float32)
    else:
        val = rng.normal(0, 1, (C, P)).astype(np.float32)
        qv = rng.normal(0, 1, (B, LQ)).astype(np.float32)
    tdt, jdt = VDT[vdt]
    val = torch.from_numpy(val).to(tdt)
    slots = np.stack([rng.permutation(C)[:KP] for _ in range(B)]
                     ).astype(np.int32)
    cand = rng.normal(0, 1, (B, KP)).astype(np.float32)
    cand[rng.random((B, KP)) < gate] = -np.inf
    ids = rng.integers(0, 2**40, C).astype(np.int64)
    return dict(q_idx=qi, q_val=qv, indices=idx, values=val, ids=ids,
                cand_scores=cand, cand_slots=slots, jdt=jdt)


def _reference(op, k):
    vals = jnp.asarray(op["values"].float().numpy()).astype(op["jdt"])
    state = types.SimpleNamespace(
        store=jvs.VecStore(indices=jnp.asarray(op["indices"]), values=vals),
        ids=jnp.asarray(jeng.pack_ids64(op["ids"])))
    ids, scores, slots = jeng.rerank_topk(
        state, jnp.asarray(op["cand_scores"]), jnp.asarray(op["cand_slots"]),
        jnp.asarray(op["q_idx"]), jnp.asarray(op["q_val"]), k)
    return (jeng.unpack_ids64(np.asarray(ids)), np.asarray(scores),
            np.asarray(slots))


def _torch(op):
    t = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v))
         for k, v in op.items() if k != "jdt"}
    return (t["q_idx"], t["q_val"], t["indices"], t["values"], t["ids"],
            t["cand_scores"], t["cand_slots"])


def _port_paths(op, k):
    """(twin, engine.rerank_topk) outputs on CPU tensors."""
    qi, qv, idx, val, ids, cs, sl = _torch(op)
    state = types.SimpleNamespace(store=tvs.VecStore(idx, val), ids=ids)
    return {"twin": csr_rerank.csr_rerank_topk_plain(qi, qv, idx, val, ids,
                                                     cs, sl, k),
            "engine": teng.rerank_topk(state, cs, sl, qi, qv, k)}


def _assert_matches(op, k, exact=False):
    want_ids, want_sc, want_sl = _reference(op, k)
    for name, (ids, sc, sl) in _port_paths(op, k).items():
        np.testing.assert_array_equal(sl.numpy(), want_sl, err_msg=name)
        np.testing.assert_array_equal(ids.numpy(), want_ids, err_msg=name)
        if exact:
            assert np.array_equal(sc.numpy().view(np.int32),
                                  want_sc.view(np.int32)), name
        else:
            np.testing.assert_allclose(sc.numpy(), want_sc, rtol=1e-6,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("vdt", list(VDT))
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("P", [1, 7, 128])
def test_rerank_matches_reference(P, B, vdt):
    op = _operands(P * 100 + B, B, P, vdt)
    for k in (1, 10, KP):
        _assert_matches(op, k)


@pytest.mark.parametrize("n_finite", [0, 3])
def test_rerank_fewer_finite_than_k(n_finite):
    """Fewer candidates survive the gate than k: the -inf tail follows in
    position order, as ``lax.top_k`` gives it."""
    op = _operands(11 + n_finite, 16, 7)
    rng = np.random.default_rng(n_finite)
    for b in range(16):
        keep = rng.permutation(KP)[:n_finite]
        row = np.full(KP, -np.inf, np.float32)
        row[keep] = 1.0
        op["cand_scores"][b] = row
    _assert_matches(op, 10)
    _, scores, _ = _port_paths(op, 10)["twin"]
    assert torch.isneginf(scores[:, n_finite:]).all()


@pytest.mark.parametrize("vdt", list(VDT))
def test_rerank_exact_ties_break_by_position(vdt):
    """Integer-valued rows and queries: every sum is exact, many scores tie,
    and ties go to the earlier candidate position; scores bit-equal."""
    op = _operands(5, 16, 7, vdt, integer=True)
    _assert_matches(op, KP, exact=True)
    _, scores, slots = _port_paths(op, KP)["twin"]
    pos = {int(s): i for i, s in enumerate(op["cand_slots"][0])}
    order = [pos[int(s)] for s in slots[0]]
    for a in range(KP - 1):
        if scores[0, a] == scores[0, a + 1]:
            assert order[a] < order[a + 1]
    assert (scores[:, :-1] == scores[:, 1:]).any()


def test_duplicate_query_coordinates_add_in_query_order():
    """A coordinate repeated in the query counts with its summed value: the
    same answer as the query with the duplicates combined."""
    op = _operands(3, 4, 7)
    op["q_idx"][:, 1] = op["q_idx"][:, 0]
    op["q_idx"][:, 2] = op["q_idx"][:, 0]
    _assert_matches(op, 10)
    comb = {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in op.items()}
    comb["q_val"][:, 0] = (op["q_val"][:, 0] + op["q_val"][:, 1]
                           + op["q_val"][:, 2])
    comb["q_idx"][:, 1:3] = -1
    a = _port_paths(op, 10)["twin"]
    b = _port_paths(comb, 10)["twin"]
    assert torch.equal(a[2], b[2])
    torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=1e-6)


def test_one_entry_rows_keep_signed_zero():
    """P = 1: a row that misses the query scores q * v = -0.0 when its
    value is negative, as the reference's length-1 sum does, and -0.0
    ranks below +0.0 (the fault this pins made every zero +0.0)."""
    op = _operands(9, 1, 1, gate=0.0)
    op["q_idx"][:] = -1
    _, scores, _ = _port_paths(op, KP)["twin"]
    assert torch.signbit(scores).any() and (scores == 0).all()
    _assert_matches(op, KP, exact=True)


def _bad(op, **repl):
    args = dict(zip(("q_idx", "q_val", "indices", "values", "ids",
                     "cand_scores", "cand_slots"), _torch(op)))
    args.update(repl)
    return args


BAD = {
    "q_idx int64": lambda a: {"q_idx": a["q_idx"].long()},
    "q_val bf16": lambda a: {"q_val": a["q_val"].bfloat16()},
    "values f16": lambda a: {"values": a["values"].half()},
    "ids int32": lambda a: {"ids": a["ids"].int()},
    "slots int64": lambda a: {"cand_slots": a["cand_slots"].long()},
    "scores shape": lambda a: {"cand_scores": a["cand_scores"][:, :-1]
                               .contiguous()},
    "queries shape": lambda a: {"q_val": a["q_val"][:, :-1].contiguous()},
    "values shape": lambda a: {"values": a["values"][:-1]},
    "non-contiguous slots": lambda a: {
        "cand_slots": a["cand_slots"].t().contiguous().t()},
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_bad_operands(case):
    op = _operands(1, 4, 8)
    args = _bad(op)
    args.update(BAD[case](args))
    before = csr_rerank.csr_rerank_topk.launches
    with pytest.raises(ValueError):
        csr_rerank.csr_rerank_topk(**args, k=10)
    assert csr_rerank.csr_rerank_topk.launches == before


@pytest.mark.parametrize("k", [-1, KP + 1])
def test_wrapper_rejects_k_outside_kprime(k):
    with pytest.raises(ValueError, match="k="):
        csr_rerank.csr_rerank_topk(**_bad(_operands(1, 2, 8)), k=k)


def test_wrapper_caps_kprime_and_query_nnz():
    """K' and Lq at the kernel's caps are taken; one more raises."""
    rng = np.random.default_rng(0)
    rows = csr_rerank.MAX_KPRIME
    idx = torch.from_numpy(rng.integers(-1, N, (rows, 1)).astype(np.int32))
    val = torch.ones((rows, 1))
    ids = torch.arange(rows, dtype=torch.int64)
    qi = torch.full((1, csr_rerank.MAX_QUERY_NNZ), 5, dtype=torch.int32)
    qv = torch.ones((1, csr_rerank.MAX_QUERY_NNZ))
    slots = torch.arange(rows, dtype=torch.int32)[None]
    cand = torch.zeros((1, rows))
    got_ids, got_sc, _ = csr_rerank.csr_rerank_topk(qi, qv, idx, val, ids,
                                                    cand, slots, 3)
    hit = (idx[:, 0] == 5).nonzero()[:, 0]
    assert torch.equal(got_ids[0, :min(3, hit.numel())],
                       hit[:3].to(torch.int64))
    assert (got_sc[0, :min(3, hit.numel())] == csr_rerank.MAX_QUERY_NNZ).all()
    with pytest.raises(ValueError, match="shared memory"):
        csr_rerank.csr_rerank_topk(
            qi, qv, torch.cat([idx, idx[:1]]), torch.cat([val, val[:1]]),
            torch.cat([ids, ids[:1]]), torch.zeros((1, rows + 1)),
            torch.arange(rows + 1, dtype=torch.int32)[None], 3)
    with pytest.raises(ValueError, match="shared memory"):
        csr_rerank.csr_rerank_topk(
            torch.cat([qi, qi[:, :1]], 1), torch.cat([qv, qv[:, :1]], 1),
            idx, val, ids, cand, slots, 3)


def test_no_launch_counted_on_cpu():
    """CPU tensors run the twin and count no launch; asking for the kernel
    on them raises."""
    args = _bad(_operands(2, 4, 8))
    before = csr_rerank.csr_rerank_topk.launches
    out = csr_rerank.csr_rerank_topk(**args, k=10)
    want = csr_rerank.csr_rerank_topk_plain(**args, k=10)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert csr_rerank.csr_rerank_topk.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        csr_rerank.csr_rerank_topk(**args, k=10, use_kernel=True)
    assert csr_rerank.csr_rerank_topk.launches == before


@pytest.mark.parametrize("B,kprime,want", [
    (1, 800, 8), (16, 800, 8), (17, 800, 8), (64, 800, 3), (256, 800, 1),
    (16, 50, 1), (16, 130, 3), (256, csr_rerank.MAX_KPRIME, 8),
    (1, 5_000, 8)])
def test_split_covers_the_sms(B, kprime, want):
    """Blocks per query on a 132-SM card: enough to cover the SMs, at most
    a cluster of 8, at least 64 positions and at most 4,096 a block, and
    every block of the cluster has positions."""
    S = csr_rerank.split(B, kprime, 132)
    assert S == want
    chunk = -(-kprime // S)
    assert chunk <= csr_rerank.MAX_KPRIME // 8
    assert (S - 1) * chunk < kprime


@pytest.mark.parametrize("P,vec,bits", [(1, 1, 0), (7, 1, 3), (16, 4, 2),
                                        (128, 4, 5), (200, 4, 5),
                                        (128, 1, 5), (3, 1, 2), (128, 8, 4),
                                        (16, 8, 1), (8, 8, 0)])
def test_lanes_per_row(P, vec, bits):
    assert csr_rerank.lanes_per_row(P, vec) == bits
