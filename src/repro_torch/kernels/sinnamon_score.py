"""Kernels A and C: Algorithm 6 upper-bound scoring on the card.

* Kernel A, :func:`sinnamon_score_topk`: fused candidate generation (score
  -> per-tile top-kp).  Replaces the Pallas TPU kernel
  ``sinnamon_score_topk`` of ``repro/kernels/sinnamon_score.py``; CUDA
  source ``csrc/sinnamon_score.cu``.  :func:`merge_tile_topk` merges the
  per-tile buffers into the global top-k' — plain torch, as the merge is
  XLA in the reference.  Its threshold form,
  :func:`sinnamon_score_threshold`, keeps only the keys below a bound;
  :func:`candidate_scan` runs the two as a sample pass and a threshold
  pass where the batch's shape pays for it, for the same candidates.
* Kernel C, :func:`sinnamon_score`: dense upper bounds f32[B, C] (the
  ``score_fn`` hook's scorer).  Replaces the Pallas TPU kernel
  ``sinnamon_score``; CUDA source ``csrc/sinnamon_dense.cu``.  A block
  stages a tile's sketch cells in shared memory once for the whole batch;
  :func:`dense_tile` picks the tile from the sketch's rows and cell width
  and states the limit.

Each source's header says what bounds the kernel on an H100 and how the
design meets that.  Each wrapper launches its kernel for CUDA tensors and
raises if the build or the launch fails; for CPU tensors it runs its plain
twin (:func:`sinnamon_score_topk_plain`, :func:`sinnamon_score_plain`).
Both twins share one per-slot float program (:func:`sinnamon_score_plain`:
coordinates added one at a time, in order), which the kernels repeat, so
kernel and twin agree bit for bit on the card.

Operands differ from the TPU kernels' in one place: membership comes as
``brows`` (each coordinate's bitmap row, -1 for a padded coordinate) plus
the bitmap ``bits`` itself, instead of pre-gathered words.  The kernels
read the words they need; at a 1.1M-slot shard the pre-gathered block
would be L·C/8 bytes per query.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import bitindex, sketch
from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Slots per block of kernel A (``kTileC`` in its source).
TILE_C = 8192
#: Kernel A's threads per block, radix-select histogram bins, and
#: coordinates per staged chunk of membership words (``kChunk``).
_THREADS, _RADIX_BINS, _CHUNK = 512, 256, 16

_CELL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_TWO32 = 1 << 32
#: The order key that sorts after every real key (the survivors' padding).
KEY_PAD = torch.iinfo(torch.int64).max
#: Smallest order key of a -inf score (a gated slot): the high word of
#: ``order_key`` at -inf.
GATED_KEY = 0x7F800000 * _TWO32
#: Two-pass candidate selection: every SAMPLE_STRIDE-th tile is the sample,
#: and a batch takes the two passes from TWO_PASS_MIN_BLOCKS (query, tile)
#: blocks on (see :func:`two_pass_stride`).
SAMPLE_STRIDE = 32
TWO_PASS_MIN_BLOCKS = 4_096
#: Kernel C's tile widths in 32-slot words, widest first, its warps per
#: block, and the shared memory each of two blocks on one SM may take
#: (228 KB per SM, 1 KB of it reserved per block).
_DENSE_WORDS = (8, 4, 2, 1)
_DENSE_WARPS = 16
_DENSE_SMEM_TWO_PER_SM = 233_472 // 2 - 1_024


# -- the (score desc, slot asc) order key -------------------------------------

def order_key(vals: Tensor, slots: Tensor) -> Tensor:
    """int64 key whose ascending order is (score desc, slot asc).

    High word: the float32 bits of the score made order-preserving and
    inverted; low word: the slot (non-negative).  Built exactly as the CUDA
    kernel builds it.
    """
    hi = torch.bitwise_not(sketch.sortable_bits(vals)).to(torch.int64)
    return hi * _TWO32 + slots.to(torch.int64)


def split_key(key: Tensor):
    """Inverse of :func:`order_key`: (vals f32, slots int32)."""
    hi = torch.div(key, _TWO32, rounding_mode="floor")
    slots = (key - hi * _TWO32).to(torch.int32)
    sortable = torch.bitwise_not(hi.to(torch.int32))
    bits = torch.where(sortable >= 0, sortable, sortable ^ 0x7FFFFFFF)
    return bits.view(torch.float32), slots


def topk_desc(vals: Tensor, k: int):
    """Top-k along the last axis in (value desc, index asc) order — the tie
    order of ``lax.top_k``.  Returns (vals, idx int32)."""
    idx = torch.arange(vals.shape[-1], device=vals.device).expand_as(vals)
    key = torch.topk(order_key(vals, idx), k, dim=-1, largest=False,
                     sorted=True).values
    return split_key(key)


def _smallest(key: Tensor, k: int) -> Tensor:
    """The k smallest keys of each row, ascending."""
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values


def merge_tile_topk(vals: Tensor, slots: Tensor, kprime: int):
    """Per-tile candidates [B, T, kp] -> global top-kprime [B, kprime].

    One selection on the (score desc, slot asc) key over all tiles: the
    order of a dense ``lax.top_k``, including the all -inf tail when fewer
    than kprime slots survive the gate.  Needs T * kp >= kprime.
    """
    return merge_keys(order_key(vals, slots).reshape(vals.shape[0], -1),
                      kprime)


# -- plain twins -----------------------------------------------------------------

def sinnamon_score_plain(qv: Tensor, rows: Tensor, brows: Tensor,
                         bits: Tensor, skmat: Tensor, *,
                         one_sided: bool = True) -> Tensor:
    """Plain-torch twin of kernel C: upper bounds f32[B, C].

    qv f32[B, L]; rows int32[B, L, h] (pre-offset by +m for coordinates
    with q <= 0 when ``one_sided``); brows int32[B, L] (-1 = padded);
    bits int32[nrows, C/32]; skmat [R, C].  Coordinate t adds
    ``q * min`` over its U rows (q > 0) or ``q * max`` over its L rows
    (q <= 0; ``q * 0`` without a lower sketch) at each member slot, for
    t = 0 .. L-1 in order.
    """
    B, L = qv.shape
    h = rows.shape[-1]
    C = skmat.shape[1]
    pos = qv > 0
    acc = torch.zeros((B, C), dtype=torch.float32, device=qv.device)
    for t in range(L):
        r = rows[:, t].long()                               # [B, h]
        x = sketch.cell_rows(skmat, r[:, 0])                # [B, C]
        p = pos[:, t, None]
        for o in range(1, h):
            y = sketch.cell_rows(skmat, r[:, o])
            if one_sided:
                x = torch.where(p, torch.minimum(x, y), torch.maximum(x, y))
            else:
                x = torch.minimum(x, y)
        if not one_sided:
            x = torch.where(p, x, 0.0)
        contrib = qv[:, t, None] * x
        br = brows[:, t]
        mask = bitindex.unpack_row(bits[br.clamp_min(0).long()])
        mask = mask & (br >= 0)[:, None]
        acc = acc + torch.where(mask, contrib, 0.0)
    return acc


def sinnamon_score_topk_plain(qv: Tensor, rows: Tensor, brows: Tensor,
                              bits: Tensor, ok: Tensor, skmat: Tensor, *,
                              kp: int, tile_c: int = TILE_C,
                              one_sided: bool = True):
    """Plain-torch twin of kernel A: same operands, same result.

    The operands of :func:`sinnamon_score_plain` plus ok bool[C].  Returns
    (vals f32[B, T, kp], slots int32[B, T, kp]) with T = ceil(C / tile_c);
    slots past C are gated to -inf.
    """
    B = qv.shape[0]
    C = skmat.shape[1]
    if kp > tile_c:
        raise ValueError(f"kp={kp} cannot exceed tile_c={tile_c}")
    T = -(-C // tile_c)
    acc = sinnamon_score_plain(qv, rows, brows, bits, skmat,
                               one_sided=one_sided)
    s = torch.where(ok[None, :], acc, -torch.inf)
    s = torch.nn.functional.pad(s, (0, T * tile_c - C), value=-torch.inf)
    slot_ids = torch.arange(T * tile_c, device=qv.device).expand(B, -1)
    key = order_key(s, slot_ids).reshape(B, T, tile_c)
    key = torch.topk(key, kp, dim=-1, largest=False, sorted=True).values
    return split_key(key)


def sinnamon_score_threshold_plain(qv: Tensor, rows: Tensor, brows: Tensor,
                                   bits: Tensor, ok: Tensor, skmat: Tensor,
                                   theta: Tensor, head: Tensor, *,
                                   stride: int, cap: int,
                                   tile_c: int = TILE_C,
                                   one_sided: bool = True):
    """Plain-torch twin of kernel A's threshold form.

    The operands of :func:`sinnamon_score_topk_plain`, each query's bound
    ``theta`` int64[B] (an order key) and ``head`` int64[B, H].  Over the
    tiles whose index is not a multiple of ``stride``, the keys below
    ``theta[b]`` are query b's survivors.  Returns (keys int64[B, H + cap]:
    ``head``, then the survivors, then :data:`KEY_PAD`; counts int32[B];
    flag int32[1]).  A count may pass ``cap``: the survivors kept are then
    ``cap`` of them, and the flag is 1.  A bound at or past
    :data:`GATED_KEY` (the sample held fewer than k' live slots) gives that
    query no survivors and sets the flag.  The kernel appends in no set
    order; the twin in key order.
    """
    B = qv.shape[0]
    C = skmat.shape[1]
    T = -(-C // tile_c)
    acc = sinnamon_score_plain(qv, rows, brows, bits, skmat,
                               one_sided=one_sided)
    s = torch.where(ok[None, :], acc, -torch.inf)
    s = torch.nn.functional.pad(s, (0, T * tile_c - C), value=-torch.inf)
    slot_ids = torch.arange(T * tile_c, device=qv.device)
    key = order_key(s, slot_ids.expand(B, -1))
    gated = theta >= GATED_KEY
    rest = (slot_ids // tile_c) % stride != 0
    surv = (key < theta[:, None]) & rest[None, :] & ~gated[:, None]
    counts = surv.sum(-1, dtype=torch.int32)
    kept = min(cap, key.shape[1])
    keys = torch.full((B, head.shape[1] + cap), KEY_PAD, dtype=torch.int64,
                      device=qv.device)
    keys[:, :head.shape[1]] = head
    keys[:, head.shape[1]:head.shape[1] + kept] = _smallest(
        torch.where(surv, key, KEY_PAD), kept)
    flag = ((counts > cap).any() | gated.any()).to(torch.int32).reshape(1)
    return keys, counts, flag


# -- CUDA kernels ---------------------------------------------------------------

def _lib():
    lib = _build.load("sinnamon_score")
    fn = lib.sinnamon_topk_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        th = lib.sinnamon_threshold_launch
        th.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        th.restype = ctypes.c_int
        lib.sinnamon_tile_c.argtypes = []
        lib.sinnamon_tile_c.restype = ctypes.c_int
        lib.sinnamon_topk_smem.argtypes = [ctypes.c_int] * 3
        lib.sinnamon_topk_smem.restype = ctypes.c_longlong
        if lib.sinnamon_tile_c() != TILE_C:
            raise _build.KernelBuildFailure(
                f"kernel tile {lib.sinnamon_tile_c()} != TILE_C {TILE_C}")
    return lib


def _dense_lib():
    lib = _build.load("sinnamon_dense")
    fn = lib.sinnamon_dense_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        lib.sinnamon_dense_smem.argtypes = [ctypes.c_int] * 4
        lib.sinnamon_dense_smem.restype = ctypes.c_longlong
    return lib


def _check(t: Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} with {ndim} dims "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _check_scoring(qv, rows, brows, bits, skmat):
    """Validate the operands kernels A and C share -> (B, L, h, C)."""
    dev = qv.device
    B, L = qv.shape
    h = rows.shape[-1]
    C = skmat.shape[1]
    _check(qv, "qv", torch.float32, 2, dev)
    _check(rows, "rows", torch.int32, 3, dev)
    _check(brows, "brows", torch.int32, 2, dev)
    _check(bits, "bits", torch.int32, 2, dev)
    if skmat.dtype not in _CELL_KIND:
        raise ValueError(f"skmat dtype {skmat.dtype} not supported")
    _check(skmat, "skmat", skmat.dtype, 2, dev)
    if rows.shape[:2] != (B, L) or brows.shape != (B, L) \
            or bits.shape[1] * bitindex.WORD != C:
        raise ValueError("operand shapes disagree: "
                         f"qv {tuple(qv.shape)} rows {tuple(rows.shape)} "
                         f"brows {tuple(brows.shape)} bits "
                         f"{tuple(bits.shape)} skmat {tuple(skmat.shape)}")
    return B, L, h, C


def _topk_smem_fixed(kp: int) -> int:
    """Kernel A's shared memory apart from the per-coordinate arrays
    (``Layout`` in its source): the survivors' sort buffer, u64[next power
    of two >= kp], which the two staged chunks of membership words,
    int32[2][_CHUNK][TILE_C / 32], alias; the tie scan's warp totals, one
    u64 per warp for each four slots a thread; two radix histograms; four
    ints."""
    n2 = 1 << max(kp - 1, 0).bit_length()
    stage = 2 * _CHUNK * (TILE_C // 32) * 4
    scan = (TILE_C // _THREADS // 4) * (_THREADS // 32) * 8
    return max(n2 * 8, stage) + scan + 2 * _RADIX_BINS * 4 + 16


def _check_topk(qv, rows, brows, bits, ok, skmat, kp):
    """Validate kernel A's operands -> (B, L, h, C, T)."""
    dev = qv.device
    B, L, h, C = _check_scoring(qv, rows, brows, bits, skmat)
    smem = _topk_smem_fixed(kp) + L * (2 + h) * 4
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"L={L}, h={h} need {smem} B of shared memory")
    _check(ok, "ok", torch.bool, 1, dev)
    if ok.shape != (C,):
        raise ValueError(f"ok {tuple(ok.shape)} != ({C},)")
    if C > 2**31 - TILE_C:
        raise ValueError(f"C={C} slots exceed the kernel's int32 slot ids")
    return B, L, h, C, -(-C // TILE_C)


def _launch(qv, rows, brows, bits, ok, skmat, kp, one_sided, stride=1):
    if not 0 <= kp <= TILE_C:
        raise ValueError(f"kp={kp} must lie in [0, TILE_C={TILE_C}]")
    dev = qv.device
    B, L, h, C, T = _check_topk(qv, rows, brows, bits, ok, skmat, kp)
    T = -(-T // stride)
    vals = torch.empty((B, T, kp), dtype=torch.float32, device=dev)
    slots = torch.empty((B, T, kp), dtype=torch.int32, device=dev)
    if B == 0 or kp == 0:
        return vals, slots
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().sinnamon_topk_launch(
        _CELL_KIND[skmat.dtype], qv.data_ptr(), rows.data_ptr(),
        brows.data_ptr(), bits.data_ptr(), ok.data_ptr(), skmat.data_ptr(),
        B, L, h, C, bits.shape[1], kp, int(one_sided), T, stride,
        vals.data_ptr(), slots.data_ptr(), stream)
    _build.check(err, "sinnamon_score_topk")
    sinnamon_score_topk.launches += 1
    return vals, slots


def _launch_threshold(qv, rows, brows, bits, ok, skmat, theta, head, stride,
                      cap, one_sided):
    dev = qv.device
    B, L, h, C, T = _check_topk(qv, rows, brows, bits, ok, skmat, 1)
    _check(theta, "theta", torch.int64, 1, dev)
    _check(head, "head", torch.int64, 2, dev)
    if theta.shape != (B,) or head.shape[0] != B or stride < 2:
        raise ValueError(f"theta {tuple(theta.shape)}, head "
                         f"{tuple(head.shape)}, stride {stride} for B={B}")
    H = head.shape[1]
    keys = torch.full((B, H + cap), KEY_PAD, dtype=torch.int64, device=dev)
    keys[:, :H] = head
    found = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    rest = T - -(-T // stride)
    if B and rest:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sinnamon_threshold_launch(
            _CELL_KIND[skmat.dtype], qv.data_ptr(), rows.data_ptr(),
            brows.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            skmat.data_ptr(), B, L, h, C, bits.shape[1], int(one_sided),
            rest, stride, theta.data_ptr(), keys.data_ptr(), H + cap, H, cap,
            found.data_ptr(), found[B:].data_ptr(), stream)
        _build.check(err, "sinnamon_score_threshold")
        sinnamon_score_threshold.launches += 1
    return keys, found[:B], found[B:]


def _dense_smem(R: int, cell_bytes: int, words: int, h: int) -> int:
    """Kernel C's shared memory per block (``Layout`` in its source): the
    tile's cells [R, 32 * words], then, for each of its 16 warps, two staged
    chunks of 32 coordinates: words int32[32, words], q f32[32], cell
    offsets int32[32, h]."""
    return (R * 32 * words * cell_bytes
            + _DENSE_WARPS * 2 * 32 * (words + 1 + h) * 4)


def dense_tile(R: int, cell_bytes: int, h: int = 1):
    """Kernel C's tile for a sketch of R rows: (words, smem bytes); a block
    scores 32 * words slots.

    The widest tile of ``_DENSE_WORDS`` whose block fits twice on an SM, else
    32 slots at one block per SM.  Raises ``ValueError`` when R rows of 32
    slots do not fit in one block's shared memory (232,448 B): at h=1 that
    is R > 1,720 rows of f32 cells (3,440 bf16, 6,880 f8).  The largest
    sketch the tuner builds, m=96 one-sided (R=192), takes 64-slot tiles in
    f32.
    """
    for words in _DENSE_WORDS:
        smem = _dense_smem(R, cell_bytes, words, h)
        if smem <= _DENSE_SMEM_TWO_PER_SM:
            return words, smem
    if smem <= _build.SMEM_PER_BLOCK:
        return words, smem
    raise ValueError(f"kernel C: {R} sketch rows of {cell_bytes}-byte cells "
                     f"(h={h}) need {smem} B of shared memory even in "
                     f"{32 * words}-slot tiles; a block has "
                     f"{_build.SMEM_PER_BLOCK} B")


def _launch_dense(qv, rows, brows, bits, skmat, one_sided):
    dev = qv.device
    B, L, h, C = _check_scoring(qv, rows, brows, bits, skmat)
    R = skmat.shape[0]
    words, _ = dense_tile(R, skmat.element_size(), h)
    if skmat.data_ptr() % 16:
        raise ValueError("skmat must start on a 16-byte boundary (the "
                         "kernel copies its rows in 16-byte pieces)")
    if C > 2**31 - 32 * words:
        raise ValueError(f"C={C} slots exceed the kernel's int32 slot ids")
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    used = torch.empty(R, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _dense_lib().sinnamon_dense_launch(
        _CELL_KIND[skmat.dtype], words, qv.data_ptr(), rows.data_ptr(),
        brows.data_ptr(), bits.data_ptr(), skmat.data_ptr(), used.data_ptr(),
        B, L, h, C, bits.shape[1], R, int(one_sided), out.data_ptr(),
        stream)
    _build.check(err, "sinnamon_score")
    sinnamon_score.launches += 1
    return out


def _use_kernel(use_kernel: Optional[bool], qv: Tensor) -> bool:
    """None -> the kernel for CUDA tensors, the twin for CPU tensors; True
    on CPU tensors raises."""
    if use_kernel is None:
        return qv.is_cuda
    if use_kernel and not qv.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors")
    return use_kernel


def sinnamon_score_topk(qv: Tensor, rows: Tensor, brows: Tensor,
                        bits: Tensor, ok: Tensor, skmat: Tensor, *, kp: int,
                        one_sided: bool = True,
                        use_kernel: Optional[bool] = None):
    """Kernel A: fused scoring + per-tile top-kp over tiles of ``TILE_C``
    slots: (vals f32[B, T, kp], slots int32[B, T, kp]); feed to
    :func:`merge_tile_topk`.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors; False forces the twin (the comparison
    path); True on CPU tensors raises.
    """
    return _tile_topk(qv, rows, brows, bits, ok, skmat, kp=kp,
                      one_sided=one_sided, use_kernel=use_kernel,
                      tile_c=TILE_C)


def sinnamon_score_threshold(qv: Tensor, rows: Tensor, brows: Tensor,
                             bits: Tensor, ok: Tensor, skmat: Tensor,
                             theta: Tensor, head: Tensor, *, stride: int,
                             cap: int, one_sided: bool = True,
                             use_kernel: Optional[bool] = None,
                             tile_c: int = TILE_C):
    """Kernel A's threshold form: the keys below each query's bound in the
    tiles that are not multiples of ``stride``, as
    :func:`sinnamon_score_threshold_plain` states (the kernel's survivors
    come in no set order).  ``use_kernel`` as for
    :func:`sinnamon_score_topk`; ``tile_c`` other than ``TILE_C`` only for
    the twin."""
    if _use_kernel(use_kernel, qv):
        if tile_c != TILE_C:
            raise ValueError(f"the kernel's tile is TILE_C={TILE_C}")
        return _launch_threshold(qv, rows, brows, bits, ok, skmat, theta,
                                 head, stride, cap, one_sided)
    return sinnamon_score_threshold_plain(
        qv, rows, brows, bits, ok, skmat, theta, head, stride=stride,
        cap=cap, tile_c=tile_c, one_sided=one_sided)


# -- candidate selection: one pass, or a sample and a threshold --------------

def two_pass_stride(B: int, T: int, kprime: int, tile_c: int = TILE_C) -> int:
    """The sample's tile stride s for a batch of B queries over T tiles, or
    0 for the single pass.

    Two passes need T >= 2 s (the sample leaves most tiles to the
    threshold), a sample of ceil(T / s) tiles whose per-tile candidates
    hold k', and at least ``TWO_PASS_MIN_BLOCKS`` (query, tile) blocks:
    below that the card finishes the single pass before the host has
    issued the extra steps."""
    s = SAMPLE_STRIDE
    if T < 2 * s or B * T < TWO_PASS_MIN_BLOCKS \
            or -(-T // s) * min(kprime, tile_c) < kprime:
        return 0
    return s


def survivor_cap(kprime: int, stride: int) -> int:
    """Survivors kept a query: 4 k' s, over four times their mean k' (s - 1)
    where slots are filled independently of the query."""
    return 4 * kprime * stride


def _tile_topk(*args, kp, one_sided, use_kernel, tile_c, stride=1):
    """Kernel A's top-k form over tiles 0, stride, 2 stride, ..."""
    if _use_kernel(use_kernel, args[0]):
        if tile_c != TILE_C:
            raise ValueError(f"the kernel's tile is TILE_C={TILE_C}")
        return _launch(*args, kp, one_sided, stride)
    vals, slots = sinnamon_score_topk_plain(*args, kp=kp, tile_c=tile_c,
                                            one_sided=one_sided)
    return vals[:, ::stride], slots[:, ::stride]


def candidate_scan(qv: Tensor, rows: Tensor, brows: Tensor, bits: Tensor,
                   ok: Tensor, skmat: Tensor, *, kprime: int,
                   one_sided: bool = True, use_kernel: Optional[bool] = None,
                   tile_c: int = TILE_C):
    """Issue kernel A over a batch (the operands of
    :func:`sinnamon_score_topk`) for its global top-``kprime`` -> (keys
    int64[B, N], flag int32[1] or None).  The k' smallest keys
    (:func:`merge_keys`) are the answer unless the flag, which is left on
    the device, reads nonzero; then :func:`rescan`'s are.

    Below :func:`two_pass_stride`'s cut: the single pass, every tile's
    top-kp, and no flag.  Above it, two passes.  The sample, tiles 0, s,
    2 s, ..., in the top-k form, merged to each query's k' smallest keys,
    whose last, theta, bounds the global k'-th key from above (a subset's
    k'-th smallest is never below the whole set's).  Then the threshold
    form over the other tiles keeps the keys below theta: a global top-k'
    member outside the sample has a key <= the global k'-th <= theta, and
    keys are unique, so it is below theta.  The k' smallest of [sample's
    k' | survivors] are then the single pass's answer, bit for bit.
    ``tile_c`` other than ``TILE_C`` only for the twin.  Counts the batches
    that take two passes in ``candidate_scan.two_pass``.
    """
    T = -(-skmat.shape[1] // tile_c)
    return _scan((qv, rows, brows, bits, ok, skmat), kprime,
                 two_pass_stride(qv.shape[0], T, kprime, tile_c),
                 dict(one_sided=one_sided, use_kernel=use_kernel,
                      tile_c=tile_c))


def rescan(qv: Tensor, rows: Tensor, brows: Tensor, bits: Tensor,
           ok: Tensor, skmat: Tensor, *, kprime: int, one_sided: bool = True,
           use_kernel: Optional[bool] = None, tile_c: int = TILE_C) -> Tensor:
    """The single pass's keys, for a batch whose flag was set; counted in
    ``candidate_scan.fallbacks``."""
    candidate_scan.fallbacks += 1
    return _scan((qv, rows, brows, bits, ok, skmat), kprime, 0,
                 dict(one_sided=one_sided, use_kernel=use_kernel,
                      tile_c=tile_c))[0]


def _scan(args, kprime: int, stride: int, kw: dict):
    """:func:`candidate_scan` with the sample's stride given (0: the single
    pass)."""
    B = args[0].shape[0]
    kp = min(kprime, kw["tile_c"])
    if not stride:
        vals, slots = _tile_topk(*args, kp=kp, **kw)
        return order_key(vals, slots).reshape(B, -1), None
    candidate_scan.two_pass += 1
    sv, ss = _tile_topk(*args, kp=kp, stride=stride, **kw)
    head = _smallest(order_key(sv, ss).reshape(B, -1), kprime)
    keys, _, flag = sinnamon_score_threshold(
        *args, head[:, -1].contiguous(), head, stride=stride,
        cap=survivor_cap(kprime, stride), **kw)
    return keys, flag


def merge_keys(keys: Tensor, kprime: int):
    """The k' smallest order keys of each row -> (vals f32[B, k'], slots
    int32[B, k']) in (score desc, slot asc) order."""
    return split_key(_smallest(keys, kprime))


def sinnamon_score(qv: Tensor, rows: Tensor, brows: Tensor, bits: Tensor,
                   skmat: Tensor, *, one_sided: bool = True,
                   use_kernel: Optional[bool] = None) -> Tensor:
    """Kernel C: dense Algorithm 6 upper bounds f32[B, C] (operands of
    :func:`sinnamon_score_plain`, ungated).  ``use_kernel`` as for
    :func:`sinnamon_score_topk`.  On the card, raises ``ValueError`` when
    the sketch's rows exceed :func:`dense_tile`'s limit or ``skmat`` does
    not start on a 16-byte boundary."""
    if _use_kernel(use_kernel, qv):
        return _launch_dense(qv, rows, brows, bits, skmat, one_sided)
    return sinnamon_score_plain(qv, rows, brows, bits, skmat,
                                one_sided=one_sided)


sinnamon_score_topk.launches = 0
sinnamon_score_threshold.launches = 0
sinnamon_score.launches = 0
candidate_scan.two_pass = 0
candidate_scan.fallbacks = 0
