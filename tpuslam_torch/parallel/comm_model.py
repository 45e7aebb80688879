"""Per-iteration communication model of the sharded algorithms (port of
``tpuslam/parallel/comm_model.py``, 206 lines).

Exact byte models of every collective each sharded algorithm issues per
iteration, counted as the PAYLOAD bytes of each collective's output,
with a reader of ``collectives.collective_log`` in place of the JAX
package's walk of the traced program (``:99-137``): the tests hold the
models to the collectives the port actually issues, so neither can drift
from the other.

``allreduce_seconds`` and ``predicted_efficiency`` are the JAX
package's formulas with the link rate and the per-collective latency
as required arguments.  The JAX package's v5e ICI and DCN rates and its
two-host report (``:33-38``, ``:175-206``) are TPU figures and are not
carried over.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def icp_comm_bytes(n_padded: int) -> Dict[str, int]:
    """Per ICP iteration (``nn.lexmin_combine``, shared by both arms):
    one ``pmin`` on f32[N] distances, one ``pmin`` on i32[N] global
    indices, one ``psum`` of the winning f32[N, 3] rows."""
    return {
        "pmin_dist_f32N": 4 * n_padded,
        "pmin_index_i32N": 4 * n_padded,
        "psum_matched_f32N3": 12 * n_padded,
        "total": 20 * n_padded,
        "n_collectives": 3,
    }


def cpd_comm_bytes(m_padded: int) -> Dict[str, int]:
    """Per CPD EM iteration, exact E-step (``cpd.estep_sharded``):
    ``psum`` of p1 f32[M], px f32[M, 3], the log-likelihood f32[] and the
    pt1-weighted target moments f32[] and f32[3].  The N-sized pt1 never
    crosses ranks."""
    return {
        "psum_p1_f32M": 4 * m_padded,
        "psum_px_f32M3": 12 * m_padded,
        "psum_scalars": 4 + 4 + 12,
        "total": 16 * m_padded + 20,
        "n_collectives": 5,
    }


def cpd_fgt_comm_bytes(k: int, terms: int) -> Dict[str, int]:
    """Per CPD EM iteration with the FGT E-step (``cpd.estep_fgt_sharded``):
    ``psum`` of the target expansion's coefficients f32[K, terms, 4] (its
    1/denominator and three weighted columns), of the log-likelihood and
    of the two pt1 moments.  p1 and px come from the summed expansion, the
    same on every rank, so they never cross ranks."""
    return {
        "psum_coefficients": 16 * k * terms,
        "psum_scalars": 4 + 4 + 12,
        "total": 16 * k * terms + 20,
        "n_collectives": 4,
    }


def cpd_init_comm_bytes() -> Dict[str, int]:
    """Once per registration, sigma^2_0: ``psum`` of the count, sum |a|^2
    and sum a."""
    return {"total": 4 + 4 + 12, "n_collectives": 3}


def nicp_comm_bytes(k_padded: int, n_candidates: int = 8) -> Dict[str, int]:
    """One NICP shot (``nicp.nicp_register_sharded``): the target's
    moments (count f32[], centroid partial f32[3], scatter f32[3, 3]) plus
    the sharded rescore of ``n_candidates`` x ``k_padded`` subcloud rows,
    the 20-bytes-a-row combine of ICP on all candidates at once."""
    rescore = 20 * n_candidates * k_padded
    return {
        "psum_moments": 4 + 12 + 36,
        "rescore_combine": rescore,
        "total": 52 + rescore,
        "n_collectives": 6,
    }


def collective_bytes(log: Iterable) -> List[Tuple[str, tuple, int]]:
    """(op, output shape, output bytes) of every collective of a
    ``collectives.collective_log``."""
    return [(c.op, tuple(c.shape), int(c.nbytes)) for c in log]


def total_collective_bytes(log: Iterable) -> int:
    return sum(b for _, _, b in collective_bytes(log))


def logged_iterations(log: Iterable, n_collectives: int, skip: int = 0) -> List[int]:
    """The payload bytes of each loop iteration in a sharded run's
    ``collective_log``: the records after the set-up's ``skip``, in groups
    of the model's ``n_collectives``.  An iteration frozen past the stop
    inside a chunk runs its collectives too, so the groups count the
    iterations the loop ran, not only those it kept.  Raises where the
    records do not split into whole iterations."""
    body = collective_bytes(log)[skip:]
    if len(body) % n_collectives:
        raise ValueError(f"{len(body)} collectives after the set-up's {skip} are not whole "
                         f"iterations of {n_collectives}")
    return [sum(b for _, _, b in body[i:i + n_collectives])
            for i in range(0, len(body), n_collectives)]


def logged_cpd_iterations(log: Iterable, skip: int) -> List[Tuple[str, int]]:
    """``(E-step, payload bytes)`` of each EM iteration in a sharded CPD
    run's ``collective_log`` after the set-up's ``skip`` records: an FGT
    iteration opens with the coefficients' 3-d ``psum`` and has
    ``cpd_fgt_comm_bytes``' 4 collectives, an exact one
    ``cpd_comm_bytes``' 5.  Frozen iterations count, as in
    ``logged_iterations``.  Raises where the records end inside an
    iteration."""
    body = collective_bytes(log)[skip:]
    out, i = [], 0
    while i < len(body):
        fgt = len(body[i][1]) == 3
        n = 4 if fgt else 5
        if i + n > len(body):
            raise ValueError(f"the log ends inside an iteration at record {skip + i}")
        out.append(("fgt" if fgt else "exact", sum(b for _, _, b in body[i:i + n])))
        i += n
    return out


def allreduce_seconds(payload_bytes: float, n_devices: int, link_bytes_per_s: float) -> float:
    """Bidirectional-ring all-reduce wire time over one axis of
    ``n_devices``, each link moving ``link_bytes_per_s`` one way."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * payload_bytes * (n_devices - 1) / (n_devices * link_bytes_per_s)


def predicted_efficiency(
    comm_bytes_per_iter: float,
    n_collectives_per_iter: int,
    single_device_iter_seconds: float,
    n_devices: int,
    link_bytes_per_s: float,
    collective_latency_s: float,
) -> float:
    """Parallel efficiency at ``n_devices`` against one device,
    ``T1 / (d Td)`` with ``Td = T1 / d + T_comm``: the target axis carries
    all the O(N M) work, the replicated 3x3 algebra is taken as free."""
    t_comp = single_device_iter_seconds / n_devices
    t_comm = (allreduce_seconds(comm_bytes_per_iter, n_devices, link_bytes_per_s)
              + n_collectives_per_iter * collective_latency_s)
    return t_comp / (t_comp + t_comm)
