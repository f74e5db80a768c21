"""The benchmark's G200 deployment (Sinnamon §6.5: n 32,000, 200 signed
N(0, 1) coordinates a row, uniform activation) through the port's normal
path on the CPU, held against the benchmark's plain reference.

At the configuration's widths (n, ψ, ``max_nnz`` 256, query pad 256, m 64,
h 1, bf16 cells) and a few thousand slots, with the benchmark's own laws
(``bench/laws/values/normal.py``, ``bench/laws/activations/uniform.py``):

* ``insert_many`` + ``QueryServer.query_many`` (the plain twins of
  kernels A and B) agree with ``bench/reference/sinnamon.py`` as judged by
  ``bench/reference/compare.py``: no rank fault, score error under the
  configuration's limit;
* the L rows the port writes for negative values are the reference's
  downward-rounded cells bit for bit (and the U rows its upward-rounded);
* a planted fault that scores negative coordinates through the U rows
  comes out not correct;
* kernel A's two-pass selection gives the single pass's candidates on
  signed scores.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import check as bcheck  # noqa: E402
from benchlib import data as bdata  # noqa: E402
from reference import compare  # noqa: E402
from reference.sinnamon import RefIndex  # noqa: E402
from repro_torch.api import IndexConfig, open_index  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sinnamon_score as ss  # noqa: E402
from repro_torch.serving.serve import QueryServer  # noqa: E402

DOCS, CAPACITY, BATCH = 3000, 3072, 16
SEEDS = (2**31 + 5, 2**32 + 17)


def _cfg(cell_dtype="bf16", kprime=100) -> dict:
    cfg = json.loads((BENCH / "configs" / "g200.json").read_text())
    cfg["index"]["capacity"] = CAPACITY
    cfg["index"]["cell_dtype"] = cell_dtype
    cfg["data"]["docs"] = DOCS
    cfg["serving"]["kprime"] = kprime
    return cfg


def _corpus(cfg, seed):
    data = cfg["data"]
    cdf = bdata.activation_cdf(data, "cpu")
    numbers, idx, val = bdata.corpus_chunk(seed, data, 0, cdf, "cpu")
    q_idx, q_val = bdata.query_pool(seed, data, 1, BATCH, cdf, "cpu")
    return numbers, idx, val, q_idx[0], q_val[0]


def _port(cfg, numbers, idx, val):
    index = open_index(IndexConfig(**cfg["index"]), device="cpu")
    index.insert_many(bdata.doc_id(numbers), idx, val)
    return index


def _reference(cfg, numbers, idx, val):
    ref = RefIndex(cfg["index"], "cpu", len(numbers))
    ref.insert(numbers, bdata.doc_id(numbers), idx, val)
    return ref


def _judge(cfg, ref, q_idx, q_val, ids, scores) -> dict:
    """``bench/benchlib/check.py``'s comparison of one group of queries."""
    k, kprime = int(cfg["serving"]["k"]), int(cfg["serving"]["kprime"])
    chk = cfg["check"]
    cand = ref.candidates(q_idx, q_val, kprime, k)
    s_ub, s_ex = ref.rows_scores(q_idx, q_val, bcheck._slots_of(ref, ids))
    c_ub, c_ex = ref.rows_scores(q_idx, q_val, cand["ub_slots"])
    return compare.judge(ids, scores, cand, s_ub, s_ex, c_ub, c_ex,
                         ref.ids[cand["ub_slots"]], ref.ids[cand["top_slots"]],
                         kprime, float(chk["ub_band"]),
                         float(chk["score_err"]))


def _served(cfg, index, q_idx, q_val):
    res = QueryServer(index, k=int(cfg["serving"]["k"]),
                      kprime=int(cfg["serving"]["kprime"])).query_many(
                          q_idx, q_val)
    return res.ids, res.scores


def _is_correct(cfg, verdict) -> bool:
    return (verdict["score_err"] <= float(cfg["check"]["score_err"])
            and verdict["rank_faults"] <= int(cfg["check"]["rank_faults"]))


@pytest.mark.parametrize("kprime", (100, 400))
@pytest.mark.parametrize("seed", SEEDS)
def test_port_agrees_with_reference(seed, kprime):
    cfg = _cfg(kprime=kprime)
    numbers, idx, val, q_idx, q_val = _corpus(cfg, seed)
    # the deployment's shape: signed values, half of a query's coordinates
    # negative, rows as wide as the pads allow
    ok = q_idx >= 0
    neg_share = float((q_val[ok] < 0).float().mean())
    assert 0.4 < neg_share < 0.6
    assert idx.shape[1] == 256 and q_idx.shape[1] == 256
    index = _port(cfg, numbers, idx, val)
    ids, scores = _served(cfg, index, q_idx, q_val)
    verdict = _judge(cfg, _reference(cfg, numbers, idx, val), q_idx, q_val,
                     ids, scores)
    assert verdict["rank_faults"] == 0, verdict["faults"]
    assert verdict["score_err"] <= float(cfg["check"]["score_err"])
    assert verdict["recall_hits"] > 0.9 * verdict["recall_total"]


@pytest.mark.parametrize("cell_dtype", ("bf16", "f32"))
@pytest.mark.parametrize("seed", SEEDS)
def test_sketch_rows_equal_reference_cells(seed, cell_dtype):
    """The port's L rows (and U rows) at each document's slot, bit for bit
    against the reference's directed-rounded cells of the same document."""
    cfg = _cfg(cell_dtype)
    numbers, idx, val, _, _ = _corpus(cfg, seed)
    index = _port(cfg, numbers, idx, val)
    ref = _reference(cfg, numbers, idx, val)
    ids = bdata.doc_id(numbers).tolist()
    port_slots = torch.tensor([index._id2slot[i] for i in ids])
    ref_slots = ref.slot_of[numbers]
    state = index.state
    bits = {2: torch.int16, 4: torch.int32}[state.sketch.element_size()]
    for port_side, ref_side in ((state.l, ref.l), (state.u, ref.u)):
        got = port_side[:, port_slots].T.contiguous()          # [docs, m]
        want = ref_side[ref_slots].to(got.dtype)
        assert torch.equal(got.view(bits), want.view(bits))
    lower = state.l[:, port_slots].float()
    assert float((lower < 0).float().mean()) > 0.5   # most L cells negative


def _upper_rows_for_negative(state, spec, q_idx, q_val, budget=None):
    """A planted fault: every coordinate reads its U rows, so a negative
    coordinate's term is q·max(u), a lower bound where the L rows give an
    upper one."""
    qv, rows, brows = ops.prepare_query_operands(state, spec, q_idx, q_val,
                                                 budget)
    return qv, rows, brows, state.sketch, True


@pytest.mark.parametrize("seed", SEEDS)
def test_negative_coordinates_through_upper_rows_is_not_correct(
        seed, monkeypatch):
    cfg = _cfg()
    numbers, idx, val, q_idx, q_val = _corpus(cfg, seed)
    index = _port(cfg, numbers, idx, val)
    ref = _reference(cfg, numbers, idx, val)
    good = _judge(cfg, ref, q_idx, q_val, *_served(cfg, index, q_idx, q_val))
    assert _is_correct(cfg, good)
    monkeypatch.setattr(ops, "prepare_fused_operands",
                        _upper_rows_for_negative)
    bad = _judge(cfg, ref, q_idx, q_val, *_served(cfg, index, q_idx, q_val))
    assert not _is_correct(cfg, bad)
    assert bad["rank_faults"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_two_pass_selection_equals_single_pass_on_signed_scores(seed):
    """The sample-and-threshold selection over G200's signed bounds gives
    the single pass's keys, with the survivor cap holding (no flag): slots
    are filled independently of the query.  The twin's tile is cut to 32
    slots so that a few thousand slots make enough tiles for two passes."""
    cfg = _cfg()
    numbers, idx, val, _, _ = _corpus(cfg, seed)
    index = _port(cfg, numbers, idx, val)
    q_idx, q_val = bdata.query_pool(seed + 1, cfg["data"], 1, 64,
                                    bdata.activation_cdf(cfg["data"], "cpu"),
                                    "cpu")
    state, spec = index.state, index.spec
    qv, rows, brows, skmat, one_sided = ops.prepare_fused_operands(
        state, spec, q_idx[0], q_val[0])
    args = (qv, rows, brows, state.bits, state.active, skmat)
    kw = dict(kprime=40, one_sided=one_sided, tile_c=32)
    T = -(-CAPACITY // 32)
    assert ss.two_pass_stride(64, T, 40, 32) == ss.SAMPLE_STRIDE
    keys, flag = ss.candidate_scan(*args, **kw)
    assert flag is not None and int(flag) == 0
    want = ss.merge_keys(ss.rescan(*args, **kw), 40)
    got = ss.merge_keys(keys, 40)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
