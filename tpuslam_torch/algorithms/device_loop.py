"""The chunked run of the port's device-resident loops: ICP's
(``algorithms/icp.py``) and CPD's EM loop (``algorithms/cpd.py``).

A loop keeps all of its state on the device, as the JAX package's
``lax.while_loop``s do, and runs in chunks of iterations with one host
read a chunk: the chunk's status, an i32 vector whose first entries are
the launches the device counted (``kernels.TALLIED``).  ``run_chunks``
drives the chunks.  On CUDA the first chunk of a key runs eagerly (its
warm-up), the next is captured as a CUDA graph over static buffers
(``ChunkGraph``) and replayed; the graph is kept by its key in the open
``graph_scope``, so a later registration of the same key loads its
inputs and replays it.  A loop supplies its chunk, its status reader and
its keys (a loop with phases, as CPD's Hybrid, has one key a phase).
The sharded loops' chunks hold NCCL collectives (``parallel/``): a
replay books them to the open ``collectives.collective_log`` as it books
its launches, and their key names the process group.

The tree helpers (``leaves``, ``rebuild``, ``signature``, ``keep``) act
on trees of named tuples and tensors: a loop's inputs and carry.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Hashable, Optional

import torch

from tpuslam_torch import kernels
from tpuslam_torch.parallel import collectives


def leaves(tree) -> list:
    """The tensors of a tree of named tuples, in order (None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in leaves(sub)]


def rebuild(tree, new_leaves):
    """``tree`` with its tensors replaced, in order, from the iterator
    ``new_leaves``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(new_leaves)
    subs = [rebuild(sub, new_leaves) for sub in tree]
    return type(tree)(*subs) if hasattr(tree, "_fields") else type(tree)(subs)


def signature(tree):
    """Shapes, types and structure of a tree: part of a graph's cache key."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return (type(tree).__name__, tuple(signature(sub) for sub in tree))


def keep(cond: torch.Tensor, new, old):
    """``new`` where ``cond`` holds, else ``old``, leaf by leaf (``cond``
    broadcast over each leaf's trailing axes); an absent old leaf takes
    the new one.  The JAX loops' freeze."""
    if old is None or new is None:
        return new
    if isinstance(new, torch.Tensor):
        c = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
        return torch.where(c, new, old)
    subs = [keep(cond, n, o) for n, o in zip(new, old)]
    return type(new)(*subs) if hasattr(new, "_fields") else type(new)(subs)


class ChunkGraph:
    """One chunk of a device-resident loop captured as a CUDA graph over
    static buffers: ``load`` copies a registration's inputs and carry in
    (trees of tensors), ``replay`` runs the chunk and reads its status
    (the buffers then hold the new carry).  A replay runs no wrapper, so
    it books the launches the device counted in it (the status's first
    entries) to the wrappers' counters, with the batch sizes the capture
    recorded, and the collectives the capture recorded to the open
    ``collective_log``.  The capture is "thread_local"
    (``torch.cuda.graph``'s ``capture_error_mode``): in a rank's process
    the NCCL process group's watchdog thread queries its events
    meanwhile, which a "global" capture would count against it."""

    def __init__(self, fn: Callable, inputs, carry):
        self.inputs = [t.clone() for t in leaves(inputs)]
        self.carry = [t.clone() for t in leaves(carry)]
        self.template = rebuild(carry, iter(self.carry))
        device = self.inputs[0].device
        # made before the capture records their addresses
        kernels.tally(device)
        kernels.arrivals_ptr(device)
        self.graph = torch.cuda.CUDAGraph()
        with kernels.recording_capture() as self.captured, \
                collectives.recording_capture() as self.collectives, \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            out, self.status, _ = fn(rebuild(inputs, iter(self.inputs)), self.template)
            for buf, new in zip(self.carry, leaves(out)):
                buf.copy_(new)

    def load(self, inputs, carry) -> None:
        for buf, t in zip(self.inputs, leaves(inputs)):
            buf.copy_(t)
        for buf, t in zip(self.carry, leaves(carry)):
            buf.copy_(t)

    def replay(self) -> list:
        """Run the chunk; its status, read once, with its launches booked."""
        self.graph.replay()
        vals = self.status.tolist()
        kernels.book_replay(vals[:len(kernels.TALLIED)], self.captured)
        collectives.book_replay(self.collectives)
        return vals

    def result(self):
        """The carry after the last replay, copied out of the buffers."""
        return rebuild(self.template, (t.clone() for t in self.carry))


# the graphs of the open ``graph_scope`` by key, or None
_SCOPE: Optional[dict] = None


@contextmanager
def graph_scope(graphs: Optional[dict] = None):
    """Within the block, a loop keeps the CUDA graph it captures for a key
    in ``graphs`` (default: the open scope's, else a new dict) and replays
    it for every later registration of that key: the owner of a run of
    registrations (a sequence, a stream, a chunked run, a server, a
    measurement) holds one graph per key it meets, for as long as it
    holds the dict.  Outside any scope a registration's graphs serve that
    registration alone."""
    global _SCOPE
    prev = _SCOPE
    _SCOPE = graphs if graphs is not None else ({} if prev is None else prev)
    try:
        yield _SCOPE
    finally:
        _SCOPE = prev


def run_chunks(key_of: Callable[[], Hashable], chunk_of: Callable[[Hashable], Callable],
               inputs, carry, read: Callable[[list, object], bool], use_graph: bool):
    """Run a loop's chunks until it has stopped; returns the final carry.

    Before each chunk ``key_of()`` names it; ``chunk_of(key)`` is the
    chunk, ``fn(inputs, carry) -> (carry, status, extra)``, with no host
    read inside.  After it, ``read(status values, extra)`` books the
    status and says whether the loop has stopped (``extra`` is None after
    a replay).  With ``use_graph`` a key's chunk is captured after its
    first, eager, chunk and replayed from then on, kept in the open
    ``graph_scope``; a failed capture raises."""
    graphs = ({} if _SCOPE is None else _SCOPE) if use_graph else None
    runner = None  # the graph whose buffers hold the live carry
    stopped = False
    while not stopped:
        key = key_of()
        kept = None if graphs is None else graphs.get(key)
        if runner is not None and runner is not kept:
            carry, runner = runner.result(), None
        if kept is not None:
            if runner is None:
                kept.load(inputs, carry)
                runner = kept
            stopped = read(runner.replay(), None)
            continue
        fn = chunk_of(key)
        carry, status, extra = fn(inputs, carry)
        stopped = read(status.tolist(), extra)
        if graphs is not None and not stopped:
            # the eager chunk was the warm-up: capture the key's chunk
            runner = graphs[key] = ChunkGraph(fn, inputs, carry)
    return carry if runner is None else runner.result()
