"""The chunked run of the port's device-resident loops: ICP's
(``algorithms/icp.py``) and CPD's EM loop (``algorithms/cpd.py``).

A loop keeps all of its state on the device, as the JAX package's
``lax.while_loop``s do, and runs in chunks of iterations with one host
read a chunk.  ``run_chunks`` drives the chunks.  On CUDA the first
chunk of a key runs eagerly (its warm-up), the next is captured as a
CUDA graph over static buffers (``ChunkGraph``) and replayed; the graph
is kept by its key in the open ``graph_scope``, so a later registration
of the same key loads its inputs and replays it.  A loop supplies its
chunk, its status reader and its keys (a loop with phases, as CPD's
Hybrid, has one key a phase); ``chunk_policy`` sets the chunk's length
and whether it is captured, for every loop alike.
The sharded loops' chunks hold NCCL collectives (``parallel/``): a
replay books them to the open ``collectives.collective_log`` as it books
its launches, and their key names the process group.

A chunk's report is one i32 vector, read once, laid out here alone: the
launches the device counted (a row of ``kernels.TALLIED`` each), the
loop's own status (its stop flag, counts and states), then the codes of
the choices the device made (``core/choices.py``), each booked to its
trace as the report is read.

The tree helpers (``leaves``, ``rebuild``, ``signature``, ``keep``) act
on trees of named tuples and tensors: a loop's inputs and carry.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Hashable, List, NamedTuple, Optional, Tuple

import torch

from tpuslam_torch import kernels
from tpuslam_torch.core import choices
from tpuslam_torch.core.spans import span
from tpuslam_torch.parallel import collectives

# iterations a chunk of a device-resident loop (one host read a chunk),
# chosen from card runs of 1, 2, 4 and 8 (harness/loop_chunk.py, PERF.md):
# ICP at 102,400 and 8,192 rows on both arms, where 2 was within 6 % of the
# best in every row; CPD at 20,480 rows exact and 102,400 rows Hybrid, where
# 2 was the best Hybrid row (a frozen FGT iteration at the phase switch
# costs a whole E-step) and within 8 % of the best exact row.  With the
# chunk replayed as a graph the read costs little, and a chunk past the
# stop wastes up to k - 1 iterations of device time
LOOP_CHUNK = 2
# capture a chunk as a CUDA graph on CUDA (False: eager chunks of one
# iteration, the loop every chunked run is held to, a measurement's baseline)
CUDA_GRAPHS = True


def chunk_policy(device: torch.device, verbose: bool, capturable: bool) -> Tuple[bool, int]:
    """``(use_graph, k)`` of a loop on ``device``: on CUDA, chunks of
    ``LOOP_CHUNK`` iterations captured as CUDA graphs; eager chunks of one
    iteration with ``verbose`` (the reference's per-iteration printf),
    without ``CUDA_GRAPHS`` or where the loop cannot be captured (the
    sharded loops under gloo, which stage each collective through the
    host), as such a chunk reads the host at each choice anyway; eager
    chunks of ``LOOP_CHUNK`` iterations on the CPU."""
    use_graph = device.type == "cuda" and CUDA_GRAPHS and not verbose and capturable
    k = 1 if verbose or (device.type == "cuda" and not use_graph) else int(LOOP_CHUNK)
    if k < 1:
        raise ValueError(f"a chunk must be >= 1 iteration (LOOP_CHUNK), got {k}")
    return use_graph, k


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


class Layout(NamedTuple):
    """What a chunk's report holds past its launch tally: the length of
    the loop's own status, then ``(trace, names, length)`` of each booked
    choice's codes, in order."""

    own: int
    codes: List[tuple]


def _reporting(fn: Callable, predicated: bool) -> Callable:
    """The chunk ``fn(inputs, carry) -> (carry, own, extra)`` (``own``: the
    loop's status, i32 tensors) run with the launch tally read before and
    after it and the device's choices recorded (``predicated``: made on
    the device), as ``(carry, report, extra, layout)``: the report is
    ``[launches | own | codes]`` in one i32 vector."""
    def chunk(inputs, carry):
        device = leaves(inputs)[0].device
        tally = kernels.tally(device)
        before = None if tally is None else tally[:, 0].clone()
        with choices.recording(predicated) as rec:
            carry, own, extra = fn(inputs, carry)
        launched = (torch.zeros(len(kernels.TALLIED), dtype=torch.int32, device=device)
                    if tally is None else tally[:, 0] - before)
        codes = [code.to(torch.int32).flatten() for _, _, code in rec.booked]
        layout = Layout(sum(t.numel() for t in own),
                        [(trace, names, c.numel()) for (trace, names, _), c in
                         zip(rec.booked, codes)])
        return carry, torch.cat([launched, *own, *codes]), extra, layout
    return chunk


def read_report(vals: list, layout: Layout, captured=None) -> list:
    """A chunk's report, read: each choice that ran booked to its trace
    (a ``choices.FROZEN`` code is not), a replay's launches booked with
    the batch sizes its capture recorded (``captured``; None for an eager
    chunk, whose wrappers counted them); returns the loop's own status."""
    at = len(kernels.TALLIED)
    if captured is not None:
        kernels.book_replay(vals[:at], captured)
    own = vals[at:at + layout.own]
    at += layout.own
    for trace, names, n in layout.codes:
        trace.extend(names[code] for code in vals[at:at + n] if code != choices.FROZEN)
        at += n
    return own


class ChunkGraph:
    """One chunk of a device-resident loop captured as a CUDA graph over
    static buffers: ``load`` copies a registration's inputs and carry in
    (trees of tensors), ``replay`` runs the chunk and reads its status
    (the buffers then hold the new carry).  ``fn`` is a chunk as
    ``_reporting`` makes it.  A replay runs no wrapper, so it books the
    launches the device counted in it to the wrappers' counters, with the
    batch sizes the capture recorded, and the collectives the capture
    recorded to the open ``collective_log``.  The capture is "thread_local"
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
            out, self.status, _, self.layout = fn(rebuild(inputs, iter(self.inputs)),
                                                  self.template)
            for buf, new in zip(self.carry, leaves(out)):
                buf.copy_(new)

    def load(self, inputs, carry) -> None:
        for buf, t in zip(self.inputs, leaves(inputs)):
            buf.copy_(t)
        for buf, t in zip(self.carry, leaves(carry)):
            buf.copy_(t)

    def replay(self) -> list:
        """Run the chunk; the loop's own status from its report, read once,
        with its launches and choices booked."""
        self.graph.replay()
        collectives.book_replay(self.collectives)
        return read_report(self.status.tolist(), self.layout, self.captured)

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
               inputs, carry, read: Callable[[list, object], bool], use_graph: bool,
               span_of: Callable[[Hashable], Optional[str]] = lambda key: None):
    """Run a loop's chunks until it has stopped; returns the final carry.

    Before each chunk ``key_of()`` names it; ``chunk_of(key)`` is the
    chunk, ``fn(inputs, carry) -> (carry, own, extra)``, with no host read
    inside (``own``: the loop's status, a list of i32 tensors).  The chunk
    runs inside a ``choices.recording`` (``predicated`` with
    ``use_graph``) and its report is read once (``read_report``); then
    ``read(own status values, extra)`` says whether the loop has stopped
    (``extra`` is None after a replay).  With ``use_graph`` a key's chunk
    is captured after its first, eager, chunk and replayed from then on,
    kept in the open ``graph_scope``; a failed capture raises.  The call is the
    ``tpuslam.loop`` span, each capture a ``tpuslam.loop.capture`` span
    inside it, and each chunk whose key ``span_of`` names (None: none)
    that span, around its run, capture or replay and status read
    (``core/spans.py``)."""
    with span("tpuslam.loop"):
        graphs = ({} if _SCOPE is None else _SCOPE) if use_graph else None
        runner = None  # the graph whose buffers hold the live carry
        stopped = False
        while not stopped:
            key = key_of()
            with span(span_of(key)):
                kept = None if graphs is None else graphs.get(key)
                if runner is not None and runner is not kept:
                    carry, runner = runner.result(), None
                if kept is not None:
                    if runner is None:
                        kept.load(inputs, carry)
                        runner = kept
                    stopped = read(runner.replay(), None)
                    continue
                fn = _reporting(chunk_of(key), use_graph)
                carry, report, extra, layout = fn(inputs, carry)
                stopped = read(read_report(report.tolist(), layout), extra)
                if graphs is not None and not stopped:
                    # the eager chunk was the warm-up: capture the key's chunk
                    with span("tpuslam.loop.capture"):
                        runner = graphs[key] = ChunkGraph(fn, inputs, carry)
        return carry if runner is None else runner.result()
