"""Plain rigid CPD, written from the upstream's equations (``SURVEY.md``
§2; Myronenko and Song; ``coherentpointdrift.cpp:96-278``,
``cpdutils.cpp:35-44``), with every E-step exact.

The moving cloud Y is ``before`` (M rows), the target X is ``after``
(N rows).  ``sigma^2_0 = sum_ij |y_i - x_j|^2 / (3 M N)``.  An E-step at
the pose (s, R, t) and ``sigma^2``:

    g_ij = exp(-|s R y_i + t - x_j|^2 / (2 sigma^2))
    denom_j = sum_i g_ij + c,   P_ij = g_ij / denom_j
    p1 = sum_j P_ij,  pt1 = 1 - c / denom,  px = P X
    L = -sum_j log denom_j + 3 N / 2 log sigma^2

with ``c = (2 pi sigma^2)^(3/2) w M / ((1 - w) N)``: taken from
``sigma^2_0`` once in exact mode, and from the current ``sigma^2`` in
Hybrid's fast phase, which runs while ``sigma^2 > 0.015 sigma^2_0``;
Hybrid's slow phase drops each ``g_ij`` under 1e-3.  (The upstream
approximates the fast phase's sums by the Fast Gauss Transform; here they
are exact.)  The M-step: ``Np = sum p1``, ``mu_x = X^T pt1 / Np``,
``mu_y = Y^T p1 / Np``, ``A = px^T Y - Np mu_x mu_y^T``, ``R = U C V^T``
with ``C = diag(1, 1, det(U V^T))`` from the SVD of A; with a constant
scale ``sigma^2 = |sum pt1 |x|^2 - Np |mu_x|^2 + sum p1 |y|^2 - Np
|mu_y|^2 - 2 tr(S C)| / (3 Np)``, else ``s = tr(S C) / (sum p1 |y|^2 -
Np |mu_y|^2)`` and ``sigma^2 = |sum pt1 |x|^2 - Np |mu_x|^2 - s tr(S C)|
/ (3 Np)``; ``t = mu_x - s R mu_y``.  The loop runs while L is finite,
``|(L - L_prev) / L| > tolerance``, ``sigma^2 > eps`` and fewer than
``max_iterations`` iterations have run (``L_prev`` starts at 0).  It
returns ``(s R, t, iterations, sigma^2)``.

``dtype`` is the precision of every tensor; the 3x3 SVD runs in float64
(torch has none in bfloat16).  Plain torch, blocked over target rows.
"""

from __future__ import annotations

import math

import torch

from reference.icp import sq_dist

HYBRID_SWITCH = 0.015
TRUNCATE = 1e-3


def _constant(sigma2: float, weight: float, m: int, n: int) -> float:
    return (2.0 * math.pi * sigma2) ** 1.5 * weight * m / ((1.0 - weight) * n)


def estep(moved, x, sigma2: float, c: float, truncate: bool, block_pairs: int = 2**27):
    """(p1, pt1, px, L) of one exact E-step, blocked over target rows."""
    dtype, dev = moved.dtype, moved.device
    m = moved.shape[0]
    rows = max(1, block_pairs // max(1, m))
    p1 = torch.zeros(m, dtype=dtype, device=dev)
    px = torch.zeros(m, 3, dtype=dtype, device=dev)
    pt1, log_denom = [], []
    k = -0.5 / sigma2
    for lo in range(0, x.shape[0], rows):
        xb = x[lo:lo + rows]
        d = sq_dist(moved, xb)
        g = torch.exp(d * k)
        if truncate:
            g = torch.where(d * k < math.log(TRUNCATE), torch.zeros_like(g), g)
        denom = g.sum(0) + c
        p = g / denom
        p1 += p.sum(1)
        px += p @ xb
        pt1.append(1.0 - c / denom)
        log_denom.append(torch.log(denom))
    n = x.shape[0]
    big_l = -float(torch.cat(log_denom).sum()) + 1.5 * n * math.log(sigma2)
    return p1, torch.cat(pt1), px, big_l


def cpd(before, after, weight: float, const_scale: bool, tolerance: float, eps: float,
        max_iterations: int, hybrid: bool, dtype=torch.float32, device="cpu"):
    """Register host ``before`` onto ``after``; returns (s R f64[3,3],
    t f64[3], iterations, sigma^2) on the host."""
    y = torch.as_tensor(before, device=device).to(dtype)
    x = torch.as_tensor(after, device=device).to(dtype)
    m, n = y.shape[0], x.shape[0]
    w = min(max(weight, 1e-6), 1.0 - 1e-6)
    y64, x64 = y.double(), x.double()
    sigma2_0 = float((n * (y64 * y64).sum() + m * (x64 * x64).sum()
                      - 2.0 * y64.sum(0) @ x64.sum(0)) / (3.0 * m * n))
    c_init = _constant(sigma2_0, w, m, n)
    r = torch.eye(3, dtype=dtype, device=device)
    t = torch.zeros(3, dtype=dtype, device=device)
    s, sigma2, big_l, ntol, iterations = 1.0, sigma2_0, 0.0, tolerance + 10.0, 0
    while (math.isfinite(big_l) and ntol > tolerance and sigma2 > eps
           and iterations < max_iterations):
        fast = hybrid and sigma2 > HYBRID_SWITCH * sigma2_0
        c = _constant(sigma2, w, m, n) if fast else c_init
        moved = s * (y @ r.T) + t
        p1, pt1, px, new_l = estep(moved, x, sigma2, c, truncate=hybrid and not fast)
        ntol = abs((new_l - big_l) / new_l)
        big_l = new_l
        np_ = p1.sum()
        mu_x = (x * pt1[:, None]).sum(0) / np_
        mu_y = (y * p1[:, None]).sum(0) / np_
        a = px.T @ y - np_ * torch.outer(mu_x, mu_y)
        u, sv, vt = torch.linalg.svd(a.double())
        det = torch.det(u @ vt)
        cdiag = torch.ones(3, dtype=torch.float64, device=device)
        cdiag[2] = det
        r = (u @ torch.diag(cdiag) @ vt).to(dtype)
        scale_num = float(sv[0] + sv[1] + det * sv[2])
        sigma_sub = float((pt1 * (x * x).sum(1)).sum() - np_ * (mu_x @ mu_x))
        scale_den = float((p1 * (y * y).sum(1)).sum() - np_ * (mu_y @ mu_y))
        np_ = float(np_)
        if const_scale:
            sigma2 = abs(sigma_sub + scale_den - 2.0 * scale_num) / (3.0 * np_)
        else:
            s = scale_num / scale_den
            sigma2 = abs(sigma_sub - s * scale_num) / (3.0 * np_)
        t = mu_x - s * (r @ mu_y)
        iterations += 1
    return ((s * r).double().cpu().numpy(), t.double().cpu().numpy(), iterations, sigma2)
