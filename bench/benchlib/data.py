"""Inputs of every cell, drawn from ``--seed`` on the device.

One general generator serves every configuration: a configuration's
``data`` block names the dimensionality, the mean non-zeros of a document
and of a query (Poisson, clipped to the pad; that many distinct
coordinates drawn without replacement), the value law and the activation
law.  A law is a file of its own, found by the name the block gives
(:func:`benchlib.spec.value_law`, :func:`benchlib.spec.activation_law`):
``bench/laws/values/<value_law>.py`` gives ``values(gen, shape, data,
device)`` and ``bench/laws/activations/<activation>.py`` gives ``cdf(data,
device)``, so a new law comes as a new file.  Each stream of draws (the
corpus in chunks, the query pool, a loop's own feed) has its own
generator, seeded from ``(seed, stream, chunk)``, so any chunk can be
drawn again alone: the reference rebuilds the corpus chunk by chunk
instead of keeping a copy.

Document numbers map to external ids through an odd multiplier modulo
2**40 (:func:`doc_id`), so ids are not slots and an answer that
returned a slot for an id reads wrong.
"""

from __future__ import annotations

import hashlib

import torch

from benchlib import spec as bspec

#: Documents per corpus chunk (the unit the reference redraws).
CHUNK_DOCS = 65_536

_ID_MOD = 1 << 40
_ID_MUL = 2_654_435_761                 # odd, so the map is one to one
_ID_ADD = 1_000_003


def doc_id(number):
    """External id of document ``number`` (an int, int64 numpy array or
    tensor): ``(number * MUL + ADD) mod 2**40``; no int64 overflow below
    2**31 documents."""
    return (number * _ID_MUL + _ID_ADD) % _ID_MOD


def stream_seed(seed: int, stream: str, chunk: int = 0) -> int:
    """A 63-bit seed for one stream of draws (any whole ``seed``)."""
    h = hashlib.blake2b(f"{int(seed)}/{stream}/{int(chunk)}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def generator(seed: int, stream: str, chunk: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, chunk))
    return gen


def activation_cdf(data: dict, device) -> torch.Tensor:
    """f64[n] cumulative law of which coordinate a draw activates, over
    the coordinates in order: the ``cdf`` of the configuration's
    activation law."""
    return bspec.activation_law(data["activation"]).cdf(data, device)


def normal(gen, shape, device) -> torch.Tensor:
    """Standard normal draws by Box-Muller from uniform draws, the same on
    every call (the CPU's ``randn`` is not: its threads share the
    generator in no fixed order)."""
    u1 = 1.0 - torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)
    u2 = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * torch.pi * u2)
    return z.to(torch.float32)


#: Draws of the activation law a row takes per round, per place of its pad.
#: Four times the pad gives more than the pad distinct coordinates almost
#: always (Zipf(1.3) over 30,000: 512 draws hold 151 distinct on average),
#: so a second round is rare.
DRAWS_PER_PAD = 4


def _first_draws(seq: torch.Tensor) -> torch.Tensor:
    """bool[rows, L]: where a row's draw is the first of its value."""
    L = seq.shape[1]
    pos = torch.arange(L, device=seq.device)
    keys, order = torch.sort(seq * L + pos, dim=1)
    vals = keys // L
    first = torch.ones_like(vals, dtype=torch.bool)
    first[:, 1:] = vals[:, 1:] != vals[:, :-1]
    out = torch.empty_like(first)
    out.scatter_(1, order, first)
    return out


def draw_sparse(gen, rows: int, psi: float, pad: int, cdf: torch.Tensor,
                data: dict, device):
    """``rows`` sparse vectors: ψ ~ Poisson(psi) clipped to [1, pad], then
    exactly ψ distinct coordinates of the activation law, drawn without
    replacement, and values from the value law.

    Without replacement is successive sampling: draws of the law with
    replacement, in rounds of ``DRAWS_PER_PAD * pad`` a row, each
    coordinate taken at its first draw, until a row holds ψ distinct ones
    (the law of Gumbel-top-ψ).  Returns (idx int32[rows, pad] sorted with
    -1 padding last, val f32[rows, pad])."""
    n = int(data["n"])
    counts = torch.poisson(torch.full((rows,), float(psi), device=device),
                           generator=gen).long().clamp(1, min(pad, n))
    coords = torch.full((rows, pad), n, dtype=torch.int64, device=device)
    todo = torch.arange(rows, device=device)
    seq = torch.empty((rows, 0), dtype=torch.int64, device=device)
    while todo.numel():
        u = torch.rand((todo.numel(), DRAWS_PER_PAD * pad), generator=gen,
                       device=device, dtype=torch.float64)
        seq = torch.cat([seq, torch.searchsorted(cdf, u).clamp_max(n - 1)], 1)
        first = _first_draws(seq)
        want = counts[todo, None]
        keep = first & (torch.cumsum(first, 1) <= want)
        done = first.sum(1) >= want[:, 0]
        kept, _ = torch.sort(torch.where(keep[done], seq[done], n), dim=1)
        coords[todo[done]] = kept[:, :pad]
        todo, seq = todo[~done], seq[~done]
    valid = coords < n
    vals = bspec.value_law(data["value_law"]).values(gen, (rows, pad), data,
                                                    device)
    return (torch.where(valid, coords, -1).to(torch.int32),
            torch.where(valid, vals, 0.0).to(torch.float32))


def doc_rows(seed: int, stream: str, chunk: int, lo: int, hi: int,
             data: dict, cdf, device):
    """Documents numbered ``lo .. hi - 1``, drawn by the generator of
    ``(seed, stream, chunk)``: (numbers int64, idx, val), the same on
    every call."""
    gen = generator(seed, stream, chunk, device)
    idx, val = draw_sparse(gen, hi - lo, data["psi_doc"], int(data["doc_pad"]),
                           cdf, data, device)
    return torch.arange(lo, hi, dtype=torch.int64, device=device), idx, val


def corpus_chunk(seed: int, data: dict, chunk: int, cdf, device):
    """Documents ``chunk * CHUNK_DOCS ..`` of the corpus: (numbers int64,
    idx, val), the same on every call."""
    lo = chunk * CHUNK_DOCS
    hi = min(lo + CHUNK_DOCS, int(data["docs"]))
    return doc_rows(seed, "corpus", chunk, lo, hi, data, cdf, device)


def n_chunks(data: dict) -> int:
    return -(-int(data["docs"]) // CHUNK_DOCS)


def query_pool(seed: int, data: dict, batches: int, batch: int, cdf, device):
    """``batches`` query batches [batches, batch, pad] on the host, pinned
    where a card is present."""
    gen = generator(seed, "queries", 0, device)
    idx, val = draw_sparse(gen, batches * batch, data["psi_query"],
                           int(data["query_pad"]), cdf, data, device)
    shape = (batches, batch, idx.shape[1])
    return _host(idx.view(shape)), _host(val.view(shape))


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=t.device.type == "cuda")
    out.copy_(t)
    return out
