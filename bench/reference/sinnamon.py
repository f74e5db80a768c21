"""A plain reference of a streaming Sinnamon index (Bruch et al.,
arXiv:2301.10622, Algorithms 5-7 and §4.3), in plain PyTorch.

It holds what the configuration says an index holds and works every part
of it out again from the inputs: the h random mappings from the index
seed (a numpy Philox draw), each document's sketch columns with directed
rounding into the cell type (up for the upper sketch, down for the lower),
the raw rows in the store type, and membership from the stored rows.
Documents take the slots in the order they are inserted; answers are
judged by external id, so the slots need not be the program's.

:meth:`RefIndex.candidates` scores every live slot for a batch of queries
(upper bounds of Algorithm 6 and exact inner products, in blocks of
slots) and keeps each query's k' largest upper bounds;
:meth:`RefIndex.rows_scores` gives both scores of chosen slots in float64;
:meth:`RefIndex.answers` reranks the k' candidates exactly (Algorithm 7).
Nothing here reads the index under test.

A configuration names its reference module by its ``reference`` key; the
harness reads two things of it: :func:`mappings` (the index's hash, for
the roofline's counts) and :func:`states`, the reference state that each
judged step is judged against.  This module's loop never writes, so one
state, the corpus drawn again from the seed, serves every judged step.  A
reference for a loop that writes replays each step's ``writes`` up to the
step it judges.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import data as bdata

_DTYPES = {"f32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f8": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn}
_INT_OF = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def dtype_of(name) -> torch.dtype:
    return _DTYPES[str(name).removeprefix("torch.")]


def mappings(seed: int, n: int, m: int, h: int) -> np.ndarray:
    """The h mappings [n] -> [m] as int64[h, n]: uniform draws of numpy's
    Philox generator keyed by the index seed."""
    gen = np.random.Generator(np.random.Philox(key=seed))
    return gen.integers(0, m, size=(h, n), dtype=np.int32).astype(np.int64)


def _step(r: torch.Tensor, up: bool) -> torch.Tensor:
    """The neighbour of non-negative representable values ``r`` one step
    up (or down) in magnitude, through the integer bit patterns, which
    order non-negative floats."""
    bits = r.view(_INT_OF[r.element_size()])
    return (bits + (1 if up else -1)).view(r.dtype)


def round_directed(x: torch.Tensor, dtype: torch.dtype, up: bool
                   ) -> torch.Tensor:
    """f32 ``x`` into ``dtype``, rounded toward +inf (``up``) or -inf,
    saturating at the type's largest finite value."""
    x = x.to(torch.float32)
    if dtype == torch.float32:
        return x.clone()
    top = float(torch.finfo(dtype).max)
    a = x.abs().clamp_max(top)
    r = a.to(dtype)                                   # nearest
    rf = r.to(torch.float32)
    ceil = torch.where(rf < a, _step(r, True), r)     # smallest >= a
    floor = torch.where(rf > a, _step(r, False), r)   # largest <= a
    away = (x >= 0) if up else (x < 0)                # magnitude grows
    mag = torch.where(away, ceil, floor)
    return torch.where(x < 0, -mag.to(torch.float32),
                       mag.to(torch.float32)).to(dtype)


class RefIndex:
    """The state a Sinnamon index of ``index_cfg`` holds after the
    inserts it was given (document numbers, external ids, rows)."""

    def __init__(self, index_cfg: dict, device, total_numbers: int,
                 cell_dtype=None, store_dtype=None):
        self.n = int(index_cfg["n"])
        self.m = int(index_cfg["m"])
        self.h = int(index_cfg["h"])
        self.C = int(index_cfg["capacity"])
        self.P = int(index_cfg["max_nnz"])
        if index_cfg.get("index_buckets") is not None:
            raise NotImplementedError("hashed bitmap buckets")
        self.two_sided = not (index_cfg.get("positive_only", False)
                              or index_cfg.get("sketch_kind", "full")
                              == "lite")
        self.cell = dtype_of(cell_dtype or index_cfg["cell_dtype"])
        self.store = dtype_of(store_dtype or index_cfg["store_dtype"])
        # float8 values are held as float32 (exactly), where indexing works
        hold = lambda t: t if t.itemsize > 1 else torch.float32  # noqa: E731
        self.device = torch.device(device)
        dev = self.device
        # one extra column: padded coordinates (-1 -> n) map to cell 0
        maps = mappings(int(index_cfg["seed"]), self.n, self.m, self.h)
        self.maps = torch.from_numpy(np.concatenate(
            [maps, np.zeros((self.h, 1), np.int64)], 1)).to(dev)
        self.idx = torch.full((self.C, self.P), -1, dtype=torch.int32,
                              device=dev)
        self.val = torch.zeros((self.C, self.P), dtype=hold(self.store),
                               device=dev)
        self.u = torch.zeros((self.C, self.m), dtype=hold(self.cell),
                             device=dev)
        self.l = torch.zeros((self.C, self.m), dtype=hold(self.cell),
                             device=dev) if self.two_sided else None
        self.live = torch.zeros(self.C, dtype=torch.bool, device=dev)
        self.ids = torch.full((self.C,), -1, dtype=torch.int64, device=dev)
        self.slot_of = torch.full((total_numbers,), -1, dtype=torch.int64,
                                  device=dev)
        self.used = 0                     # slots handed out so far

    # -- inserts -------------------------------------------------------------
    def _columns(self, idx: torch.Tensor, val: torch.Tensor):
        """Sketch columns (u, l) [B, m] of rows idx/val [B, P]: each cell
        the max (min) of the values its coordinates map to, 0 where none
        maps, rounded outward into the cell type."""
        B = idx.shape[0]
        ok = idx >= 0
        safe = torch.where(ok, idx.long(), self.n)
        v = val.to(torch.float32)
        u = torch.full((B, self.m), -torch.inf, device=idx.device)
        l = torch.full((B, self.m), torch.inf, device=idx.device)
        for o in range(self.h):
            cells = self.maps[o][safe]
            u.scatter_reduce_(1, cells, torch.where(ok, v, -torch.inf),
                              "amax")
            l.scatter_reduce_(1, cells, torch.where(ok, v, torch.inf),
                              "amin")
        u = torch.where(torch.isinf(u), 0.0, u)
        l = torch.where(torch.isinf(l), 0.0, l)
        return (round_directed(u, self.cell, up=True).to(self.u.dtype),
                round_directed(l, self.cell, up=False).to(self.u.dtype))

    def insert(self, numbers: torch.Tensor, ids: torch.Tensor,
               idx: torch.Tensor, val: torch.Tensor) -> None:
        """Insert new documents into the next free slots (their numbers
        must not be live)."""
        dev = self.device
        numbers, ids = numbers.to(dev), ids.to(dev)
        idx, val = idx.to(dev), val.to(dev)
        B = numbers.shape[0]
        if B > self.C - self.used:
            raise RuntimeError("reference index is full")
        if bool((self.slot_of[numbers] >= 0).any()):
            raise RuntimeError("a document number is inserted twice")
        slots = torch.arange(self.used, self.used + B, device=dev)
        self.used += B
        u, l = self._columns(idx, val)
        self.u[slots] = u
        if self.l is not None:
            self.l[slots] = l
        width = idx.shape[1]
        self.idx[slots, :width] = idx.to(torch.int32)
        self.val[slots, :width] = val.to(torch.float32).to(
            self.store).to(self.val.dtype)
        self.live[slots] = True
        self.ids[slots] = ids
        self.slot_of[numbers] = slots

    # -- scores -------------------------------------------------------------
    def _dense_queries(self, q_idx, q_val, dtype):
        """Queries as dense columns [n + 1, B] (row n stays zero)."""
        B = q_idx.shape[0]
        q_idx, q_val = q_idx.to(self.device), q_val.to(self.device)
        ok = q_idx >= 0
        qT = torch.zeros((self.n + 1, B), dtype=dtype, device=self.device)
        rows = torch.where(ok, q_idx.long(), self.n)
        cols = torch.arange(B, device=self.device)[:, None].expand_as(rows)
        qT.index_put_((rows, cols), torch.where(ok, q_val.to(dtype), 0),
                      accumulate=True)
        qT[self.n] = 0
        return qT

    def _cells(self, slots: torch.Tensor, coords: torch.Tensor,
               lower: bool = True):
        """Decoded cells at each stored coordinate of the rows at
        ``slots``: (min over the mappings of u, max of l or None), f32;
        ``lower=False`` skips l (no query coordinate is negative)."""
        cu = cl = None
        for o in range(self.h):
            c = self.maps[o][coords]                        # [..., P]
            su = self.u[slots[..., None], c].to(torch.float32)
            cu = su if cu is None else torch.minimum(cu, su)
            if lower and self.l is not None:
                sl = self.l[slots[..., None], c].to(torch.float32)
                cl = sl if cl is None else torch.maximum(cl, sl)
        return cu, cl

    def candidates(self, q_idx, q_val, kprime: int, k: int,
                   block: int = 0) -> dict:
        """Score every live slot for queries [B, Lq]; keep each query's
        ``kprime`` largest upper bounds and ``k`` largest exact scores.

        Upper bound of a slot: the sum over the query's coordinates that
        the row holds of q·min_o u (q > 0) or q·max_o l (q < 0; 0 with no
        lower sketch).  Exact: the sum of q·value over the same
        coordinates.  Both summed in float32 here; dead slots are -inf.
        Returns float32 / int64 tensors: ``ub`` [B, k'], ``ub_slots``,
        ``top`` [B, k], ``top_slots``.
        """
        qT = self._dense_queries(q_idx, q_val, torch.float32)
        neg = bool((q_val < 0).any())
        B = qT.shape[1]
        dev = self.device
        # blocks of about 2**27 gathered query values (512 MiB)
        block = block or max(256, min(65_536, (1 << 27) // (self.P * B)))
        ub_v = torch.empty((B, 0), device=dev)
        ub_s = torch.empty((B, 0), dtype=torch.int64, device=dev)
        ex_v = torch.empty((B, 0), device=dev)
        ex_s = torch.empty((B, 0), dtype=torch.int64, device=dev)
        for lo in range(0, self.C, block):
            hi = min(lo + block, self.C)
            slots = torch.arange(lo, hi, device=dev)
            coords = torch.where(self.idx[lo:hi] >= 0, self.idx[lo:hi].long(),
                                 self.n)
            G = qT[coords]                                     # [D, P, B]
            vals = self.val[lo:hi].to(torch.float32)
            exact = torch.bmm(vals[:, None, :], G)[:, 0]       # [D, B]
            cu, cl = self._cells(slots, coords, lower=neg)
            if neg:
                ub = torch.bmm(cu[:, None, :], G.clamp_min(0))[:, 0]
                if cl is not None:
                    ub = ub + torch.bmm(cl[:, None, :], G.clamp_max(0))[:, 0]
            else:
                ub = torch.bmm(cu[:, None, :], G)[:, 0]
            dead = ~self.live[lo:hi, None]
            ub = torch.where(dead, -torch.inf, ub).T
            exact = torch.where(dead, -torch.inf, exact).T
            ids = slots[None].expand(B, -1)
            ub_v, ub_s = _keep(ub_v, ub_s, ub, ids, kprime)
            ex_v, ex_s = _keep(ex_v, ex_s, exact, ids, k)
        return {"ub": ub_v, "ub_slots": ub_s, "top": ex_v, "top_slots": ex_s}

    def rows_scores(self, q_idx, q_val, slots: torch.Tensor):
        """Float64 (upper bound, exact score) of each query [B, Lq] against
        the rows at ``slots`` [B, K] (slots < 0 give -inf)."""
        qT = self._dense_queries(q_idx, q_val, torch.float64)
        ok = slots >= 0
        s = torch.where(ok, slots, 0).to(self.device)
        coords = torch.where(self.idx[s] >= 0, self.idx[s].long(), self.n)
        B = qT.shape[1]
        q = qT.T[torch.arange(B, device=self.device)[:, None, None], coords]
        exact = (q * self.val[s].to(torch.float64)).sum(-1)
        cu, cl = self._cells(s, coords)
        pos = q * cu.to(torch.float64)
        if cl is not None:
            pos = torch.where(q < 0, q * cl.to(torch.float64), pos)
        else:
            pos = torch.where(q < 0, 0.0, pos)
        ub = pos.sum(-1)
        ok = ok.to(self.device) & self.live[s]
        return (torch.where(ok, ub, -torch.inf),
                torch.where(ok, exact, -torch.inf))

    def answers(self, q_idx, q_val, kprime: int, k: int):
        """Algorithm 7 over the reference's own candidates: the k' largest
        upper bounds reranked by exact score.  Returns (ids int64[B, k],
        scores f32[B, k]) on the host."""
        cand = self.candidates(q_idx, q_val, kprime, k)
        _, exact = self.rows_scores(q_idx, q_val, cand["ub_slots"])
        top, pos = torch.topk(exact, k, dim=1)
        slots = cand["ub_slots"].gather(1, pos)
        return (self.ids[slots].cpu().numpy(),
                top.to(torch.float32).cpu().numpy())


def build(cfg: dict, seed: int, device, cell_dtype=None,
          store_dtype=None) -> RefIndex:
    """The reference index of the configuration's corpus, drawn again
    from the seed chunk by chunk."""
    data = cfg["data"]
    ref = RefIndex(cfg["index"], device, int(data["docs"]), cell_dtype,
                   store_dtype)
    cdf = bdata.activation_cdf(data, device)
    for c in range(bdata.n_chunks(data)):
        numbers, idx, val = bdata.corpus_chunk(seed, data, c, cdf, device)
        ref.insert(numbers, bdata.doc_id(numbers), idx, val)
    return ref


def states(cfg: dict, seed: int, device, steps: list, judged, cell_dtype=None,
           store_dtype=None):
    """Yield (positions, reference state) in step order, covering every
    step position in ``judged``: here once, the corpus for all of them,
    since no step writes (a step that wrote is an error: this reference
    would judge it against writes it never saw)."""
    for i, st in enumerate(steps):
        if st.writes:
            raise ValueError(f"step {i} wrote {len(st.writes)} time(s); "
                             "this reference replays no writes")
    yield sorted(judged), build(cfg, seed, device, cell_dtype, store_dtype)


def _keep(vals, slots, new_vals, new_slots, k):
    """The ``k`` largest of two [B, *] score lists, with their slots."""
    v = torch.cat([vals, new_vals], 1)
    s = torch.cat([slots, new_slots], 1)
    if v.shape[1] <= k:
        return v, s
    top, pos = torch.topk(v, k, dim=1)
    return top, s.gather(1, pos)
