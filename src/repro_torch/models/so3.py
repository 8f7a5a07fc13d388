"""Real-spherical-harmonic rotation matrices (Wigner D) in PyTorch: twin of
``repro/models/so3.py``.

EquiformerV2's eSCN trick needs, per edge, the block-diagonal rotation
``D^l(R_e)`` (l = 0..l_max) for the rotation ``R_e`` that aligns the edge
direction with +z: features are rotated into the edge frame, convolved with
SO(2)-sparse weights, and rotated back.

``D^l`` is built by the Ivanic–Ruedenberg recursion (J. Phys. Chem. 1996,
with the 1998 erratum): ``R^l`` is assembled from ``R^{l-1}`` and ``R^1``
with coefficients u, v, w that depend only on (l, m, n). The tables and the
clamped gather indices are made in numpy once per l (:func:`_uvw_tables`)
and moved to a device once per (l, device, dtype) (:func:`_tables`), so the
per-edge work is batched gathers and products, differentiable through the
edge directions.

Real-SH conventions: l=1 basis ordered (Y_1^{-1}, Y_1^0, Y_1^1) ~ (y, z, x);
``R^1 = Pᵀ R P`` with P the (x,y,z)->(y,z,x) permutation.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Coefficient tables (host / numpy, cached per l; a copy of the reference's)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _uvw_tables(l: int):
    """u, v, w coefficients and gather indices for the recursion at level l.

    Returns dict of numpy arrays indexed [m+l, n+l] (shape [2l+1, 2l+1]).
    Index arrays address P[i, mu, n] with mu clamped into [-(l-1), l-1]
    (out-of-range entries always carry zero coefficient).
    """
    size = 2 * l + 1
    u = np.zeros((size, size))
    v = np.zeros((size, size))
    w = np.zeros((size, size))
    for m in range(-l, l + 1):
        for n in range(-l, l + 1):
            denom = (2 * l) * (2 * l - 1) if abs(n) == l else (l + n) * (l - n)
            d_m0 = 1.0 if m == 0 else 0.0
            u[m + l, n + l] = np.sqrt((l + m) * (l - m) / denom)
            v[m + l, n + l] = 0.5 * np.sqrt(
                (1 + d_m0) * (l + abs(m) - 1) * (l + abs(m)) / denom) \
                * (1 - 2 * d_m0)
            w[m + l, n + l] = -0.5 * np.sqrt(
                (l - abs(m) - 1) * (l - abs(m)) / denom) * (1 - d_m0)

    lm1 = l - 1
    def clamp(mu):
        return int(np.clip(mu, -lm1, lm1)) + lm1

    # V-term: indices and signs depend on sign(m); W-term similar.
    mu_u = np.zeros(size, dtype=np.int32)
    mu_v_a = np.zeros(size, dtype=np.int32)   # P_{+1}(...) argument
    mu_v_b = np.zeros(size, dtype=np.int32)   # P_{-1}(...) argument
    c_v_a = np.zeros(size)
    c_v_b = np.zeros(size)
    mu_w_a = np.zeros(size, dtype=np.int32)
    mu_w_b = np.zeros(size, dtype=np.int32)
    c_w_a = np.zeros(size)
    c_w_b = np.zeros(size)
    for m in range(-l, l + 1):
        i = m + l
        mu_u[i] = clamp(m)
        if m == 0:
            mu_v_a[i], c_v_a[i] = clamp(1), 1.0
            mu_v_b[i], c_v_b[i] = clamp(-1), 1.0
            mu_w_a[i], c_w_a[i] = 0, 0.0
            mu_w_b[i], c_w_b[i] = 0, 0.0
        elif m > 0:
            d_m1 = 1.0 if m == 1 else 0.0
            mu_v_a[i], c_v_a[i] = clamp(m - 1), np.sqrt(1 + d_m1)
            mu_v_b[i], c_v_b[i] = clamp(-m + 1), -(1 - d_m1)
            mu_w_a[i], c_w_a[i] = clamp(m + 1), 1.0
            mu_w_b[i], c_w_b[i] = clamp(-m - 1), 1.0
        else:
            d_m1 = 1.0 if m == -1 else 0.0
            mu_v_a[i], c_v_a[i] = clamp(m + 1), (1 - d_m1)
            mu_v_b[i], c_v_b[i] = clamp(-m - 1), np.sqrt(1 + d_m1)
            mu_w_a[i], c_w_a[i] = clamp(m - 1), 1.0
            mu_w_b[i], c_w_b[i] = clamp(-m + 1), -1.0
    return dict(u=u, v=v, w=w, mu_u=mu_u, mu_v_a=mu_v_a, mu_v_b=mu_v_b,
                c_v_a=c_v_a, c_v_b=c_v_b, mu_w_a=mu_w_a, mu_w_b=mu_w_b,
                c_w_a=c_w_a, c_w_b=c_w_b)


_TABLES: Dict[Tuple[int, str, torch.dtype], Dict[str, torch.Tensor]] = {}


def _tables(l: int, device: torch.device,
            dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """:func:`_uvw_tables` at level ``l`` as tensors on ``device``: the
    coefficients in ``dtype`` (the ``c_*`` columns as ``[2l+1, 1]``), the
    indices as int64. Made once per (l, device, dtype): the recursion runs
    in every layer of every step."""
    key = (l, str(device), dtype)
    if key not in _TABLES:
        out = {}
        for name, a in _uvw_tables(l).items():
            if name.startswith("mu_"):
                out[name] = torch.as_tensor(a, dtype=torch.long,
                                            device=device)
            else:
                t = torch.as_tensor(a, dtype=dtype, device=device)
                out[name] = t[:, None] if name.startswith("c_") else t
        _TABLES[key] = out
    return _TABLES[key]


# ---------------------------------------------------------------------------
# Recursion (batched over edges)
# ---------------------------------------------------------------------------

def _p_tensor(r1: torch.Tensor, r_prev: torch.Tensor, l: int) -> torch.Tensor:
    """P[i, mu, n] for i in {-1,0,1}, mu in [-(l-1), l-1], n in [-l, l].

    r1: [..., 3, 3] (indices m=-1,0,1); r_prev: [..., 2l-1, 2l-1].
    """
    # columns of r1: j index 0,1,2 = m -1, 0, +1
    c0, c1, c2 = r1[..., 0], r1[..., 1], r1[..., 2]          # [..., 3]
    first, last = r_prev[..., 0], r_prev[..., 2 * l - 2]     # [..., 2l-1]
    mid = c1[..., :, None, None] * r_prev[..., None, :, :]   # |n| < l
    hi = c2[..., :, None] * last[..., None, :] \
        - c0[..., :, None] * first[..., None, :]
    lo = c2[..., :, None] * first[..., None, :] \
        + c0[..., :, None] * last[..., None, :]
    return torch.cat([lo[..., None], mid, hi[..., None]], dim=-1)


def _next_level(r1: torch.Tensor, r_prev: torch.Tensor,
                l: int) -> torch.Tensor:
    t = _tables(l, r1.device, r1.dtype)
    P = _p_tensor(r1, r_prev, l)                       # [..., 3, 2l-1, 2l+1]
    pm, p0, pp = P[..., 0, :, :], P[..., 1, :, :], P[..., 2, :, :]
    U = p0.index_select(-2, t["mu_u"])                 # [..., 2l+1, 2l+1]
    V = (t["c_v_a"] * pp.index_select(-2, t["mu_v_a"])
         + t["c_v_b"] * pm.index_select(-2, t["mu_v_b"]))
    W = (t["c_w_a"] * pp.index_select(-2, t["mu_w_a"])
         + t["c_w_b"] * pm.index_select(-2, t["mu_w_b"]))
    return t["u"] * U + t["v"] * V + t["w"] * W


_PERM: Dict[str, torch.Tensor] = {}


def wigner_d_stack(rot: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """[D^0, D^1, ..., D^l_max] for rotation matrices ``rot`` [..., 3, 3].

    D^l has shape [..., 2l+1, 2l+1] in the real-SH basis.
    """
    batch = rot.shape[:-2]
    out: List[torch.Tensor] = [rot.new_ones(batch + (1, 1))]
    if l_max == 0:
        return out
    key = str(rot.device)
    if key not in _PERM:
        _PERM[key] = torch.tensor([1, 2, 0], device=rot.device)
    perm = _PERM[key]                                  # (x,y,z) -> (y,z,x)
    r1 = rot.index_select(-2, perm).index_select(-1, perm)
    out.append(r1)
    r_prev = r1
    for l in range(2, l_max + 1):
        r_prev = _next_level(r1, r_prev, l)
        out.append(r_prev)
    return out


def block_diag_wigner(rot: torch.Tensor, l_max: int) -> torch.Tensor:
    """Dense block-diagonal D over all l: [..., M, M], M = (l_max+1)^2."""
    ds = wigner_d_stack(rot, l_max)
    m = (l_max + 1) ** 2
    out = rot.new_zeros(rot.shape[:-2] + (m, m))
    off = 0
    for l, d in enumerate(ds):
        sz = 2 * l + 1
        out[..., off:off + sz, off:off + sz] = d
        off += sz
    return out


# ---------------------------------------------------------------------------
# Edge-alignment rotations
# ---------------------------------------------------------------------------

def edge_rotation(direction: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation R with R @ d = +z (rows: new basis). [..., 3, 3].

    Rodrigues about axis = d x z; for d ~ +-z we blend toward identity /
    a 180-degree flip about x, keeping everything differentiable. Both
    branches are computed and picked by ``torch.where``, as the reference's
    ``jnp.where`` picks them.
    """
    eps_t = direction.new_tensor(eps)
    d = direction / torch.maximum(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), eps_t)
    z = direction.new_tensor([0.0, 0.0, 1.0]).expand_as(d)
    v = torch.linalg.cross(d, z, dim=-1)                 # axis * sin
    c = d[..., 2]                                        # cos
    s2 = torch.sum(v * v, dim=-1)                        # sin^2
    zero = torch.zeros_like(c)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    vx = torch.stack([torch.stack([zero, -v2, v1], -1),
                      torch.stack([v2, zero, -v0], -1),
                      torch.stack([-v1, v0, zero], -1)], -2)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    coef = torch.where(s2 > eps, (1.0 - c) / torch.maximum(s2, eps_t),
                       direction.new_tensor(0.5))
    r = eye + vx + coef[..., None, None] * (vx @ vx)
    # antiparallel fallback: 180-degree rotation about x
    flip = direction.new_tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    anti = (c < -1.0 + 1e-5)[..., None, None]
    return torch.where(anti, flip, r)


# ---------------------------------------------------------------------------
# Real spherical harmonics (for tests: Y(R r) = D(R) Y(r); a numpy copy of
# the reference's oracle)
# ---------------------------------------------------------------------------

def real_sph_harm(xyz: np.ndarray, l_max: int) -> np.ndarray:
    """Real SH values [..., (l_max+1)^2] (numpy; test oracle only).

    No Condon–Shortley phase: the Ivanic–Ruedenberg recursion targets this
    convention (Y(R r) = D(R) Y(r)).
    """
    from math import factorial
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    theta = np.arccos(np.clip(z / np.maximum(r, 1e-12), -1, 1))
    phi = np.arctan2(y, x)
    ct = np.cos(theta)
    out = []
    for l in range(l_max + 1):
        # associated Legendre P_l^m(ct) via recursion
        pmm = {}
        for m in range(l + 1):
            p = np.ones_like(ct)
            somx2 = np.sqrt(np.maximum(1 - ct * ct, 0))
            fact = 1.0
            for _ in range(m):
                p *= fact * somx2          # no (-1)^m CS phase
                fact += 2.0
            if l == m:
                pmm[m] = p
                continue
            pmmp1 = ct * (2 * m + 1) * p
            if l == m + 1:
                pmm[m] = pmmp1
                continue
            pll = None
            for ll in range(m + 2, l + 1):
                pll = (ct * (2 * ll - 1) * pmmp1 - (ll + m - 1) * p) / (ll - m)
                p, pmmp1 = pmmp1, pll
            pmm[m] = pll
        for m in range(-l, l + 1):
            am = abs(m)
            norm = np.sqrt((2 * l + 1) / (4 * np.pi)
                           * factorial(l - am) / factorial(l + am))
            if m == 0:
                out.append(norm * pmm[0])
            elif m > 0:
                out.append(np.sqrt(2) * norm * pmm[am] * np.cos(am * phi))
            else:
                out.append(np.sqrt(2) * norm * pmm[am] * np.sin(am * phi))
    return np.stack(out, axis=-1)
