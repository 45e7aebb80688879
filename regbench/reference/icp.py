"""Plain ICP, written from the upstream's equations (``SURVEY.md`` §2:
``basicicp.cpp:23-61`` with the GPU build's homogeneous composition and
divergence guard, ``icpcuda.cu:35,43-49``).

Each iteration: transform the source by the current (R, t); exact
nearest neighbours in the target by the difference form of the squared
distance, blocked over source rows; correspondences with squared
distance ``>= max_distance_squared`` dropped; the weighted Procrustes
step by a 3x3 SVD; ``R <- R_step R``, ``t <- R_step t + t_step``; the
mean squared error of the kept correspondences under the new pose.
The loop stops on an error under ``eps`` (the new pose kept), on no
correspondence, an error above the last accepted one or a non-finite one
(the pose before the iteration kept), or after ``max_iterations``;
``iterations`` counts the iterations after which the loop went on.

``dtype`` is the precision of every tensor; the 3x3 SVD runs in float64
(torch has none in bfloat16).  Plain torch: no kernel, no cache, no
import of the program.
"""

from __future__ import annotations

import torch

FLT_MAX = 3.4028235e38


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a_i - b_j|^2`` in the difference form, coordinate by coordinate
    (never ``|a|^2 + |b|^2 - 2 a.b``, which cancels), in place where it
    can be."""
    d = (a[:, None, 0] - b[None, :, 0]).square_()
    for k in (1, 2):
        e = a[:, None, k] - b[None, :, k]
        d.addcmul_(e, e)
    return d


def nearest(src: torch.Tensor, tgt: torch.Tensor, block_pairs: int = 2**28):
    """(index, squared distance) of each source row's nearest target row."""
    rows = max(1, block_pairs // max(1, tgt.shape[0]))
    idx, d2 = [], []
    for lo in range(0, src.shape[0], rows):
        v, i = torch.min(sq_dist(src[lo:lo + rows], tgt), dim=1)
        idx.append(i)
        d2.append(v)
    return torch.cat(idx), torch.cat(d2)


def procrustes(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Rigid (R, t) minimising ``sum_i w_i |R p_i + t - q_i|^2``."""
    total = w.sum()
    pm = (w[:, None] * p).sum(0) / total
    qm = (w[:, None] * q).sum(0) / total
    h = ((w[:, None] * (p - pm)).T @ (q - qm)).to(torch.float64)
    u, _, vt = torch.linalg.svd(h)
    v = vt.T
    d = torch.ones(3, dtype=torch.float64, device=h.device)
    d[2] = torch.sign(torch.det(v @ u.T))
    r = (v @ torch.diag(d) @ u.T).to(p.dtype)
    return r, qm - r @ pm


def icp(before, after, eps: float, max_distance_squared: float, max_iterations: int,
        dtype=torch.float32, device="cpu"):
    """Register host ``before`` onto ``after`` (``after ~ R before + t``);
    returns (R f64[3,3], t f64[3], iterations, error) on the host."""
    src = torch.as_tensor(before, device=device).to(dtype)
    tgt = torch.as_tensor(after, device=device).to(dtype)
    r = torch.eye(3, dtype=dtype, device=device)
    t = torch.zeros(3, dtype=dtype, device=device)
    error, prev_error = 1e5, FLT_MAX
    iterations = 0
    while iterations < max_iterations:
        moved = src @ r.T + t
        idx, d2 = nearest(moved, tgt)
        w = (d2 < max_distance_squared).to(dtype)
        if float(w.sum()) == 0:
            break
        matched = tgt[idx]
        r_step, t_step = procrustes(moved, matched, w)
        r_new, t_new = r_step @ r, r_step @ t + t_step
        diff = matched - (src @ r_new.T + t_new)
        err = float((w * (diff * diff).sum(1)).sum() / w.sum())
        if not err == err or err in (float("inf"), float("-inf")) or err > prev_error:
            break
        r, t, error = r_new, t_new, err
        if err < eps:
            break
        prev_error = err
        iterations += 1
    return (r.double().cpu().numpy(), t.double().cpu().numpy(), iterations, error)
