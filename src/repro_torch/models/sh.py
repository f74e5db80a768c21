"""Real spherical harmonics and Wigner-D rotations for the eSCN-style
SO(2) convolution (EquiformerV2, arXiv:2306.12059), as
``repro.models.sh``.

eSCN's trick needs, per edge, the Wigner matrix D_l(R_e) of the rotation
aligning the edge direction with the canonical axis.  We factorise it as

    R_e = R_y(-θ) · R_z(-φ)          (θ, φ) = polar/azimuth of the edge
    D_l(R_e) = Jᵀ_l · Dz_l(-θ) · J_l · Dz_l(-φ)

where ``Dz_l`` (rotation about z) is closed-form — cos/sin mixing of the
(m, −m) component pairs — and ``J_l = D_l(R_x(π/2))`` is a *constant* matrix
fitted once by least squares on sampled spherical-harmonic evaluations.
Per edge this is two small dense matmuls per degree — the O(L³) cost
profile that makes eSCN practical.

The numpy parts (``real_sh_numpy``, ``fit_wigner_numpy``, ``j_matrices``,
``_dz_masks`` / ``_dz_consts``) are the reference's, so their arrays are
bit-equal to it.  The torch parts keep its conventions: θ by ``arccos`` of
the clipped z, φ by ``atan2``, and the J and Dz constants as f32 tensors on
the edge vectors' device.

Conventions: components of degree l ordered m = −l..l; Condon–Shortley-free
real basis; ``D(R) Y(x) = Y(R x)``.
"""

from __future__ import annotations

import functools
import math
from typing import List

import numpy as np
import torch

Tensor = torch.Tensor


def num_coef(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slice(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


# ---------------------------------------------------------------------------
# Real spherical harmonics (NumPy — used for J fitting and tests)
# ---------------------------------------------------------------------------

def real_sh_numpy(l_max: int, xyz: np.ndarray) -> np.ndarray:
    """Y[l² + l + m] for unit vectors xyz [N, 3] → [N, (l_max+1)²]."""
    xyz = np.asarray(xyz, np.float64)
    r = np.linalg.norm(xyz, axis=-1, keepdims=True)
    x, y, z = (xyz / np.maximum(r, 1e-30)).T
    ct = np.clip(z, -1.0, 1.0)
    st = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
    phi = np.arctan2(y, x)

    # associated Legendre P_l^m(ct) without Condon–Shortley phase
    P = {}
    P[(0, 0)] = np.ones_like(ct)
    for m in range(1, l_max + 1):
        P[(m, m)] = (2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (((2 * l - 1) * ct * P[(l - 1, m)]
                          - (l + m - 1) * P[(l - 2, m)]) / (l - m))

    out = np.zeros((xyz.shape[0], num_coef(l_max)))
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            if m == 0:
                v = k * P[(l, 0)]
            elif m > 0:
                v = math.sqrt(2) * k * np.cos(m * phi) * P[(l, m)]
            else:
                v = math.sqrt(2) * k * np.sin(am * phi) * P[(l, am)]
            out[:, l * l + l + m] = v
    return out


def fit_wigner_numpy(l: int, R: np.ndarray) -> np.ndarray:
    """D_l(R) by least squares from Y(Rx) = D Y(x) on sampled points."""
    rng = np.random.Generator(np.random.Philox(key=1234 + l))
    pts = rng.normal(size=(8 * (2 * l + 1) + 16, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    Yx = real_sh_numpy(l, pts)[:, l_slice(l)]
    YRx = real_sh_numpy(l, pts @ R.T)[:, l_slice(l)]
    D, *_ = np.linalg.lstsq(Yx, YRx, rcond=None)
    return D.T   # rows: Y(Rx)_i = Σ_j D[i, j] Y(x)_j


@functools.lru_cache(maxsize=None)
def j_matrices(l_max: int) -> tuple:
    """Constant J_l = D_l(R_x(π/2)) for l = 0..l_max."""
    Rc = np.array([[1.0, 0.0, 0.0],
                   [0.0, 0.0, -1.0],
                   [0.0, 1.0, 0.0]])   # rotation by +π/2 about x: y→z
    return tuple(fit_wigner_numpy(l, Rc) for l in range(l_max + 1))


# ---------------------------------------------------------------------------
# Closed-form z-rotation blocks + per-edge Wigner matrices (torch)
# ---------------------------------------------------------------------------

def _dz_masks(l: int):
    """Constant masks: Dz(γ)[i,j] = diag_ij·cos(|m_i|γ) + anti_ij·sin(|m_i|γ)."""
    dim = 2 * l + 1
    ms = np.arange(-l, l + 1)
    diag = np.eye(dim)
    anti = np.zeros((dim, dim))
    for i, m in enumerate(ms):
        if m == 0:
            continue
        j = l - m   # index of −m
        anti[i, j] = -1.0 if m > 0 else 1.0
    return diag, anti, np.abs(ms).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _dz_consts(l: int):
    # numpy constants; _dz_tensors puts them on a device once
    diag, anti, absm = _dz_masks(l)
    return (np.asarray(diag, np.float32), np.asarray(anti, np.float32),
            np.asarray(absm, np.float32))


@functools.lru_cache(maxsize=None)
def _dz_tensors(l: int, device: torch.device) -> tuple:
    """``_dz_consts(l)`` as tensors on ``device``, made once: a copy from
    the host at each call would wait for the device."""
    return tuple(torch.from_numpy(a).to(device) for a in _dz_consts(l))


@functools.lru_cache(maxsize=None)
def _j_tensors(l_max: int, device: torch.device) -> tuple:
    """``j_matrices(l_max)`` as f32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.asarray(J, np.float32)).to(device)
                 for J in j_matrices(l_max))


def dz_block(l: int, gamma: Tensor) -> Tensor:
    """Dz_l(γ) for a batch of angles γ [...]:  [..., 2l+1, 2l+1]."""
    diag, anti, absm = _dz_tensors(l, gamma.device)
    c = torch.cos(gamma[..., None] * absm)                 # [..., 2l+1]
    s = torch.sin(gamma[..., None] * absm)
    return diag * c[..., None, :] + anti * s[..., None, :]


def wigner_blocks(l_max: int, edge_vec: Tensor) -> List[Tensor]:
    """Per-edge D_l(R_e), R_e aligning edge_vec [..., 3] with +z.

    Returns a list (l = 0..l_max) of [..., 2l+1, 2l+1] matrices.
    """
    v = edge_vec
    r = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    u = v / torch.clamp_min(r, 1e-12)
    theta = torch.arccos(torch.clamp(u[..., 2], -1.0, 1.0))
    phi = torch.atan2(u[..., 1], u[..., 0])
    out = []
    for l, J in enumerate(_j_tensors(l_max, v.device)):
        dz_t = dz_block(l, -theta)
        dz_p = dz_block(l, -phi)
        out.append(torch.matmul(torch.matmul(J.T, dz_t),
                                torch.matmul(J, dz_p)))
    return out


def apply_blocks(blocks: List[Tensor], feats: Tensor,
                 transpose: bool = False) -> Tensor:
    """Apply per-degree rotation blocks to features [..., (L+1)², C]."""
    outs = []
    for l, D in enumerate(blocks):
        f = feats[..., l_slice(l), :]
        outs.append(torch.matmul(D.transpose(-1, -2) if transpose else D, f))
    return torch.cat(outs, dim=-2)
