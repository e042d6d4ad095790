"""CUDA graphs of the port's device programs (the counterpart of jax.jit over
the JAX engine's decode and of its lax.scan of k decode steps).

    graphs = Graphs(generators=(gen,), mesh=mesh)
    out = graphs(key, fn, *args)

fn takes tensors (or tuples of tensors, such as a WKVState, or a
parallel.sharding.ShardedState) and returns tensors. The first call for a key runs fn eagerly: that call is the warm-up,
in which the kernels are built and their pointer tables, per-width buffers
and split-K scratch are made. Then fn is captured into one CUDA graph on
static copies of the args, and every later call of the key copies its args
into those copies (an arg that is the static copy itself is not copied),
replays the graph and returns its outputs: copies of them, except for an
output that is one of the static inputs (a carry: fn wrote it in place),
which is returned as it is and is the next call's input. The key names
everything else fn depends on (shapes, k, the params); fn is not called
again for a captured key. A capture that fails raises; nothing falls back to
the eager path.

What a graph draws from a torch.Generator: the generators fn draws from are
registered with each graph (CUDAGraph.register_generator_state), so a replay
reads the generator's seed and offset when it starts and advances the offset
by what the capture drew: a generator reseeded with manual_seed draws on
replay what a fresh generator with that seed draws eagerly. A generator
that is not registered makes the capture raise.

Launch counts: the kernels' Python-side launch counters (COUNTERS) and the
mesh's collective counts rise while fn is captured, though nothing ran;
they are put back, and each replay adds what the capture added. Inside
another graph's capture a call enqueues fn eagerly into that capture, so
the outer graph's replays count its launches once. Every capture adds 1 to
the metrics registry's counter graphs.captures (utils/metrics.py): a capture
after the warm-up is a program built again.

Memory: every graph of the port allocates from one memory pool
(torch.cuda.graph_pool_handle()). A graph's temporaries may then lie where
another graph's temporaries or outputs lie. That is safe because the
engine and the pool replay their graphs on one stream, one after another,
and every output is copied or consumed before the next replay: no graph
runs while another one's memory is still in use.

On CPU tensors, or with enabled=False, fn runs eagerly on every call.

A mesh whose process drives several cards (four H100s of one host at tp =
4) is graphed as one capture across them, the counterpart of jax.jit over a
process's local devices (graphable). The capture begins on the first
input's card. An event recorded there before any work forks one stream a
card from the capturing stream, and that stream is the card's current
stream while fn runs: kernel K7's launch on each card (or K6 + K2, or the
plain ops), the mesh's NCCL collectives (torch.cuda.nccl, single-process)
and the copies between the cards all land in the one graph, and every
card's stream is joined back into the capturing one before the capture
ends. No card's work waits for another card's launch except through what fn
itself orders (a copy, a collective), so K7's launches, which spin on each
other's flags, are siblings in the graph. What fn allocates on the other
cards comes from the same pool on that card (memory_pool keeps one there
too). A replay runs from the first card's current stream: it first waits
for every other card's current stream (the input copies, and any write the
caller made there), and every other card's current stream then waits for
the replay before the outputs are read. Every card of the graph is
synchronized before the capture and before its graph is freed.

A row across processes of one card each (multihost.pod_mesh(model=tp)) is
graphed: each process's step is a capture on its one card, its row's NCCL
collectives and K7's launch inside it. The communicator exists before the
capture (the warm-up's collectives made it), and every process of the row
captures the same key at the same call, since the program is SPMD (the
engine and the pool run the same calls in every process). A row whose group
is gloo (processes sharing a card, or on the CPU) runs eagerly: a gloo
collective runs on the host and cannot be captured.

Teardown: NCCL destroys a communicator only once every CUDA graph that
captured one of its collectives is gone. Every Graphs object is registered
when it is made, and release_all frees their captures, whoever still holds
them (multihost.shutdown calls it before it destroys the process group, and
it runs at the process's exit, before torch.cuda.nccl's communicators are
destroyed); a Graphs whose captures were freed warms up and captures anew
at its next call of a key.
"""

from __future__ import annotations

import atexit
import contextlib
import weakref
from typing import Callable, Optional, Sequence

import torch

from rwkv_tpu_torch.ops.cuda import decode_stack as _ds
from rwkv_tpu_torch.ops.cuda import decode_stack_tp as _k7
from rwkv_tpu_torch.ops.cuda import mm4 as _mm4
from rwkv_tpu_torch.ops.cuda import mm8 as _mm8
from rwkv_tpu_torch.ops.cuda import tp_halves as _th
from rwkv_tpu_torch.utils.metrics import metrics

# every kernel wrapper's launch counter: K1 (and those of it on the tensor
# cores), K4, K5's stack; K7 q8 and q4; K2, K5's head; K3; K6's two halves
COUNTERS = ((_ds, "launches"), (_ds, "launches_tc"), (_ds, "launches_q4"),
            (_ds, "launches_a8"), (_k7, "launches"), (_k7, "launches_q4"), (_mm8, "launches"),
            (_mm8, "launches_a8"), (_mm4, "launches"), (_th, "launches_att"),
            (_th, "launches_ffn"))

_POOL: dict = {}  # the one graph memory pool: its handle, and per device a keeper
_STREAMS: dict = {}  # per device, the stream its captures begin on
_LIVE: "weakref.WeakSet[Graphs]" = weakref.WeakSet()  # every Graphs made (release_all)


def memory_pool(device: torch.device):
    """The memory pool that every graph of the port allocates from. The
    allocator retires a pool once the last graph captured into it is gone
    (and then refuses it to a new capture), so the first use on a device
    captures a one-op keeper graph into the pool and keeps it for the
    process's life."""
    if "handle" not in _POOL:
        _POOL["handle"] = torch.cuda.graph_pool_handle()
    handle = _POOL["handle"]
    if device not in _POOL:
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(keeper, pool=handle,
                                                         stream=_capture_stream(device)):
            held = torch.zeros(1, device=device)
        _POOL[device] = (keeper, held)
    return handle


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream captures on `device` begin on (torch.cuda.graph's default
    is one stream for the process, on whichever card made it first)."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _pool_begin(device: torch.device, handle) -> None:
    """Route this thread's allocations on `device` into the graph pool (a
    capture does so only on the card it began on)."""
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, handle)


def _pool_end(device: torch.device, handle) -> None:
    torch._C._cuda_endAllocateToPool(device.index, handle)
    torch._C._cuda_releasePool(device.index, handle)  # the keeper holds the pool


def memory_pool_bytes() -> int:
    """Device bytes the shared pool's segments hold (0 before the first
    capture)."""
    if "handle" not in _POOL:
        return 0
    pool = tuple(_POOL["handle"])
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def counts(mesh=None) -> list[int]:
    """The launch counters, then the mesh's collective counts."""
    return ([getattr(m, n) for m, n in COUNTERS]
            + (list(mesh.collectives.values()) if mesh is not None else []))


def set_counts(values: Sequence[int], mesh=None) -> None:
    """Put the counters (and the mesh's collective counts) to `values`."""
    for (m, n), v in zip(COUNTERS, values):
        setattr(m, n, v)
    if mesh is not None:
        for name, v in zip(mesh.collectives, values[len(COUNTERS):]):
            mesh.collectives[name] = v


def _leaves(tree) -> list[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if hasattr(tree, "with_leaves"):  # a ShardedState: its leaves, its layout
        return tree.with_leaves([fn(t) for t in tree])
    items = [_map(fn, sub) for sub in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _cards(args: tuple, mesh, first: torch.device) -> list[torch.device]:
    """The CUDA devices other than `first` that a program over args (and
    the mesh) runs on, in order."""
    devs = [t.device for t in _leaves(args)]
    if mesh is not None:
        devs += [d for row in mesh.devices for d in row]
    out: list[torch.device] = []
    for d in devs:
        if d.type == "cuda" and d != first and d not in out:
            out.append(d)
    return out


def _across(fn: Callable, args: tuple, first: torch.device, cards, handle):
    """fn(*args) inside a capture begun on `first`, every card in `cards`
    on a stream forked from the capturing one (the module docstring)."""
    if not cards:
        return fn(*args)
    origin = torch.cuda.current_stream(first)
    start = origin.record_event()  # before any work: the cards' launches stay siblings
    forks = []
    with contextlib.ExitStack() as stack:
        for c in cards:
            s = torch.cuda.Stream(c)
            s.wait_event(start)
            stack.enter_context(torch.cuda.stream(s))
            _pool_begin(c, handle)
            stack.callback(_pool_end, c, handle)
            forks.append(s)
        stack.enter_context(torch.cuda.device(first))
        out = fn(*args)
        for s in forks:
            origin.wait_event(s.record_event())
    return out


def _synchronize(captured) -> None:
    """Wait for every card a captured graph runs on."""
    for d in (captured.device, *captured.cards):
        torch.cuda.synchronize(d)


class _Captured:
    """One captured graph: its static inputs, its outputs and the counts its
    capture added."""

    def __init__(self, fn: Callable, args: tuple, generators, mesh):
        self.fn, self.mesh = fn, mesh  # fn kept alive: a key may hold id()s it owns
        self.device = device = _leaves(args)[0].device
        self.cards = _cards(args, mesh, device)
        self.inputs = _map(lambda t: t.clone(), args)
        self.input_ids = {id(t) for t in _leaves(self.inputs)}
        self._ready = [torch.cuda.Event() for _ in self.cards]
        self._done = torch.cuda.Event()
        before = counts(mesh)
        handle = memory_pool(device)
        for c in self.cards:
            memory_pool(c)
        _synchronize(self)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        try:
            with torch.cuda.device(device), torch.cuda.graph(self.graph, pool=handle,
                                                             stream=_capture_stream(device)):
                self.outputs = _across(fn, self.inputs, device, self.cards, handle)
            self.delta = [a - b for a, b in zip(counts(mesh), before)]
        finally:
            set_counts(before, mesh)  # the capture ran nothing
        metrics.inc("graphs.captures")

    def replay(self, args: tuple):
        for s, a in zip(_leaves(self.inputs), _leaves(args)):
            if a is not s:
                if a.shape != s.shape:
                    raise ValueError(f"graph input of shape {tuple(a.shape)} for a graph "
                                     f"captured at {tuple(s.shape)}: the key must name the shapes")
                s.copy_(a)
        stream = torch.cuda.current_stream(self.device)
        for c, ev in zip(self.cards, self._ready):
            ev.record(torch.cuda.current_stream(c))
            stream.wait_event(ev)
        self.graph.replay()
        if self.cards:
            self._done.record(stream)
            for c in self.cards:
                torch.cuda.current_stream(c).wait_event(self._done)
        set_counts([c + d for c, d in zip(counts(self.mesh), self.delta)], self.mesh)
        return _map(lambda t: t if id(t) in self.input_ids else t.clone(), self.outputs)


class Graphs:
    """CUDA graphs of device programs, one per key (the module docstring).

    generators: the torch.Generators the programs draw from, registered with
    every graph. mesh: a parallel.mesh.Mesh whose collective counts the
    programs advance, or None. enabled: False runs every call eagerly.
    replays counts the replays made."""

    def __init__(self, generators: Sequence[torch.Generator] = (), mesh=None,
                 enabled: bool = True):
        self.generators = tuple(generators)
        self.mesh = mesh
        self.enabled = enabled
        self.replays = 0
        self._graphs: dict = {}
        _LIVE.add(self)

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, key, fn: Callable, *args):
        if (not self.enabled or _leaves(args)[0].device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return fn(*args)
        g = self._graphs.get(key)
        if g is not None:
            self.replays += 1
            return g.replay(args)
        out = fn(*args)  # the warm-up
        self._graphs[key] = _Captured(fn, args, self.generators, self.mesh)
        return out

    def reset(self) -> None:
        """Free every captured graph, once its device has finished its work;
        the next call of a key warms up and captures anew."""
        graphs, self._graphs = list(self._graphs.values()), {}
        for g in graphs:
            _synchronize(g)
            g.graph.reset()


def release_all() -> None:
    """Free the captures of every Graphs still alive: the module
    docstring's teardown."""
    for g in list(_LIVE):
        g.reset()


atexit.register(release_all)


def graphable(mesh: Optional[object]) -> bool:
    """Whether a mesh (or no mesh) lets its decode be graphed: every shard
    of this process on a CUDA device (one card, or several, captured as one
    graph), and, for a row across processes, its group on NCCL. A mesh on
    the CPU, and a row on a gloo group, decode eagerly: the module
    docstring."""
    if mesh is None:
        return True
    if any(d.type != "cuda" for row in mesh.devices for d in row):
        return False
    if getattr(mesh, "spans_processes", False):
        import torch.distributed as dist

        group = mesh.model_group
        return group is not None and dist.get_backend(group) == "nccl"
    return True
