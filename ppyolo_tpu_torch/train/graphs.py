"""CUDA graphs of the port's units of work: capture once per shape, replay.

The JAX package compiles a step (or a scan of steps, or of predicts) once
per input shape and dispatches it as one program.  On the card the
counterpart is a CUDA graph: ``Graphs`` captures ``fn`` at the first use of
an input shape (static input buffers, outputs kept) and from then on copies
each input into the static buffers and replays the graph, so the host
enqueues one graph launch instead of every kernel.  On the CPU ``fn`` runs
eagerly: it is the plain version that the tests hold against the JAX
package.  A graph replays exactly the kernels ``fn`` launched while it was
captured; a capture or replay that fails raises (nothing falls back to the
eager function on the card).

Capture needs a warm-up run first (cuDNN and cuBLAS pick their algorithms,
lazily made constants and caches come into being), and that run changes
the live state a training step updates.  ``Graphs`` therefore snapshots
the tensors named by ``state`` (parameters, BN statistics, momentum
buffers, EMA, the device step) and the generators' states before it, and
restores them bitwise after it, as the JAX package's ``warmup_shapes`` steps
a copy of the state (``train.py:246``).  Generators are registered with
every graph (``CUDAGraph.register_generator_state``), so each replay draws
the numbers the eager function would and advances the generator as it would.

A replay reads the caches that modules derive from their parameters (the
packed DCN weights, the folded stem, BN's eval affine) without the check
an eager call makes.  So before a replay ``Graphs`` looks at the version
counts of ``model``'s parameters and buffers: when any was written since
the last look (a ``load_state_dict``, a restore, an EMA merge), it
recomputes those caches into their existing tensors (``refresh_caches``).
Writers need do nothing of their own.

The launch wrappers count a capture's calls apart (``ops/_build.py``): each
graph keeps those counts and adds them to the wrappers' ``launches`` at
every replay, so ``launches`` counts the kernels that ran.

``flops`` holds the FLOPs of one call of each shape (``utils/mfu.py``),
counted on a run that happens anyway: the warm-up before a capture, or on
the CPU the first call of the shape.

Under a process group the collectives of ``fn`` (the gradient bucket,
sync-BN's statistics) are captured with it, so a replay runs them too.
That needs NCCL: its communicator comes into being in the warm-up run,
before the capture, and every rank captures at the same unit (the size
schedule ignores the shard).  A gloo group stages CUDA collectives through
the host, which a graph cannot hold: ``Graphs`` on a card raises under
gloo unless made with ``capture=False``, which runs ``fn`` eagerly
(``parallel/dist.py::can_capture`` says which).  Under a group the capture
checks only its own thread's CUDA calls (``capture_error_mode=
"thread_local"``): NCCL's watchdog thread polls events of the warm-up
run's collectives while the capture runs.

torch.profiler tears CUPTI down at the end of each session and sets it up
again at the next; while CUDA graphs exist, a later set-up crashes the next
replay in the host or loses kernel records from the trace (torch's own
profiler turns the teardown off when inductor captures graphs,
``torch/profiler/profiler.py``).  A ``Graphs`` on a card turns it off the
same way, for the process (``keep_cupti_set_up``).

All graphs of one ``Graphs`` (and of those made with the same ``pool``)
share one memory pool: only one of them runs at a time, so they can share
their temporaries, and the pool peaks at the largest unit instead of the
sum over shapes.  The price: a graph's outputs are valid until the next
replay of any graph in the pool; read (or copy) them before that.

A pool's (``GraphPool``'s) memory is never freed (no ``cudaFree``).  After any
torch.profiler session, freeing the segments of a destroyed graph's pool
(``torch.cuda.empty_cache()``, which every capture also calls) made the
next profiled replay of a graph that was still alive segfault inside
CUPTI's graph-launch callback (``cuGraphLaunch`` -> libcupti -> libcuda;
torch 2.11, CUDA 12.8, H100), whether or not the graphs shared a
generator, also when the destroyed graphs' objects were kept and only
``reset``; with the segments kept, no replay crashed
(``tools/graph_teardown.py`` reproduces it).  So each pool holds an empty
graph of its own for the life of the process, and a pool that nothing
refers to any more goes back, with its segments and its capture stream,
to a spare list that the next ``GraphPool.get`` takes from: a destroyed
or released graph's memory is reused by the next capture instead of
freed.
"""
from __future__ import annotations

import gc
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import _build
from ..ops.module import refresh_caches
from ..parallel import dist
from ..utils.mfu import counting
from ..utils.profiling import span

WARMUP_ITERS = 1
Inputs = Dict[str, Any]   # name -> tensor, or a tuple of tensors


def keep_cupti_set_up() -> None:
    """Keep CUPTI set up from one torch.profiler session to the next (the
    variables torch's profiler sets for graphs captured by inductor)."""
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    os.environ["TEARDOWN_CUPTI"] = "0"


_SPARE_POOLS: Dict[torch.device, list] = {}


def _capture_mode() -> str:
    return "thread_local" if dist.active() else "global"


class _NoGC:
    """No garbage collection while capturing: a dead reference cycle that
    holds another CUDA graph (a Detector's graphs refer back to it) would
    call into CUDA from the graph's destructor on this thread and
    invalidate the capture.  Collects first."""

    def __enter__(self):
        gc.collect()
        self.was_on = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self.was_on:
            gc.enable()
        return False


class GraphPool:
    """A memory pool that CUDA graphs share, with the side stream they are
    captured on (the pool's free blocks serve later captures on the same
    stream).  ``GraphPool.get(device)`` gives a spare pool of the device or
    a new one; a pool goes back to the spare list when nothing refers to
    it.  An empty graph captured into the pool keeps it alive for the life
    of the process, so its segments are never freed (module docstring)."""

    def __init__(self, device: torch.device, parts):
        self.device = device
        self.handle, self.stream, self._anchor = parts

    @classmethod
    def get(cls, device) -> "GraphPool":
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        spare = _SPARE_POOLS.setdefault(device, [])
        if spare:
            return cls(device, spare.pop())
        handle = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        marker = torch.zeros(1, device=device)
        anchor = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        with _NoGC(), torch.cuda.graph(anchor, pool=handle, stream=stream,
                                       capture_error_mode=_capture_mode()):
            marker.add_(1)
        return cls(device, (handle, stream, (anchor, marker)))

    def __del__(self):
        try:
            _SPARE_POOLS.setdefault(self.device, []).append(
                (self.handle, self.stream, self._anchor))
        except Exception:   # interpreter shutdown
            pass


def _flat(inputs: Inputs):
    for k in sorted(inputs):
        v = inputs[k]
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            yield (k, i), t


def shape_key(inputs: Inputs) -> tuple:
    """What a graph is specialised to: every input's name, shape and dtype."""
    return tuple((name, tuple(t.shape), t.dtype) for name, t in _flat(inputs))


def _copy_into(static: Inputs, inputs: Inputs) -> None:
    for (_, t), (_, s) in zip(_flat(inputs), _flat(static)):
        s.copy_(t, non_blocking=True)


def _empty_like_on(inputs: Inputs, device: torch.device) -> Inputs:
    def one(t):
        return torch.empty(t.shape, dtype=t.dtype, device=device)

    return {k: (tuple(one(t) for t in v) if isinstance(v, tuple) else one(v))
            for k, v in inputs.items()}


class Graphs:
    """``fn(inputs) -> outputs`` (a dict of tensors), run as one CUDA graph
    per input shape on a card and eagerly on the CPU.

    ``state()`` returns the live tensors ``fn`` changes in place (a warm-up
    run's changes to them are undone); ``generators`` are the generators
    ``fn`` draws from; ``pool`` is a ``GraphPool`` to share with other
    ``Graphs`` (default: one of its own); ``model`` is
    the module whose parameter-derived caches ``fn`` reads.  ``captures``
    holds the capture seconds by shape key.  Each capture first runs ``fn``
    WARMUP_ITERS times eagerly.  ``capture=False`` runs ``fn`` eagerly on a
    card too (under a gloo group, which raises otherwise)."""

    def __init__(self, fn: Callable[[Inputs], Dict[str, torch.Tensor]], device, *,
                 state: Optional[Callable[[], Dict[str, torch.Tensor]]] = None,
                 generators: Sequence[torch.Generator] = (), pool=None,
                 model: Optional[nn.Module] = None, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.state = state
        self.generators = tuple(g for g in generators if g is not None)
        # shape key -> (graph, static inputs, outputs, {wrapper: calls it recorded})
        self.graphs: Dict[tuple, Tuple[Any, Inputs, Dict[str, torch.Tensor], dict]] = {}
        self.captures: Dict[tuple, float] = {}
        self.flops: Dict[tuple, float] = {}   # shape key -> FLOPs of one call
        self.captures_graphs = capture and self.device.type == "cuda"
        if self.captures_graphs and dist.backend() == "gloo":
            raise RuntimeError("a gloo process group cannot be captured in a CUDA graph: "
                               "run eagerly (capture=False) or use NCCL")
        self.model = model
        self._watched = [] if model is None else list(model.state_dict(keep_vars=True).values())
        self._versions = None
        if self.captures_graphs:
            keep_cupti_set_up()
            self.pool = GraphPool.get(self.device) if pool is None else pool
            self.stream = self.pool.stream

    def _snapshot(self):
        tensors = self.state() if self.state is not None else {}
        with torch.no_grad():
            saved = {k: v.clone() for k, v in tensors.items()}
        return tensors, saved, [g.get_state() for g in self.generators]

    def _restore(self, snap) -> None:
        tensors, saved, gen_states = snap
        with torch.no_grad():
            for k, v in tensors.items():
                v.copy_(saved[k])
        for g, st in zip(self.generators, gen_states):
            g.set_state(st)

    def prepare(self, inputs: Inputs) -> float:
        """Capture the graph of ``inputs``' shape now (on the CPU: run ``fn``
        once) and leave the state as it was.  Returns the seconds taken."""
        key = shape_key(inputs)
        if key in self.captures:
            return 0.0
        t0 = time.perf_counter()
        with span("graph.capture", key=key):
            snap = self._snapshot()
            if not self.captures_graphs:
                self._counted(key, inputs)
                self._restore(snap)
            else:
                static = _empty_like_on(inputs, self.device)
                _copy_into(static, inputs)
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    self._counted(key, static)
                    for _ in range(WARMUP_ITERS - 1):
                        self.fn(static)
                torch.cuda.current_stream(self.device).wait_stream(self.stream)
                self._restore(snap)
                graph = torch.cuda.CUDAGraph()
                for g in self.generators:
                    graph.register_generator_state(g)
                before = {fn: fn.captured for fn in _build.COUNTED}
                with _NoGC(), torch.cuda.graph(graph, pool=self.pool.handle, stream=self.stream,
                                               capture_error_mode=_capture_mode()):
                    out = self.fn(static)
                recorded = {fn: fn.captured - before.get(fn, 0) for fn in _build.COUNTED}
                self.graphs[key] = (graph, static, out, {f: n for f, n in recorded.items() if n})
                torch.cuda.synchronize(self.device)
        self.captures[key] = time.perf_counter() - t0
        return self.captures[key]

    def _counted(self, key: tuple, inputs: Inputs) -> Dict[str, torch.Tensor]:
        """``fn(inputs)``, its FLOPs counted into ``flops[key]``."""
        with counting() as c:
            out = self.fn(inputs)
        self.flops[key] = c.total
        return out

    def __call__(self, inputs: Inputs) -> Dict[str, torch.Tensor]:
        key = shape_key(inputs)
        if not self.captures_graphs:
            return self.fn(inputs) if key in self.flops else self._counted(key, inputs)
        if key not in self.graphs:
            self.prepare(inputs)
        graph, static, out, recorded = self.graphs[key]
        with span("graph.refresh"):
            self._refresh_caches()
        with span("graph.upload"):
            _copy_into(static, inputs)
        with span("graph.launch"):
            graph.replay()
        for fn, n in recorded.items():
            fn.launches += n
        return out

    def release(self) -> None:
        """Free every captured graph, its static inputs and its outputs,
        after the work queued on the graphs' and the caller's streams is
        done.  The blocks go back to the pool, where the next capture in it
        reuses them; later calls capture anew."""
        if self.captures_graphs and self.graphs:
            torch.cuda.current_stream(self.device).synchronize()
            self.stream.synchronize()
        self.graphs.clear()
        self.captures.clear()
        self.flops.clear()

    def _refresh_caches(self) -> None:
        if self.model is None:
            return
        versions = tuple(t._version for t in self._watched)
        if versions != self._versions:
            refresh_caches(self.model)
            self._versions = versions


class GraphedStep:
    """A unit of training, ``fn(state, unit, generator) -> (state, losses)``
    (``make_train_step`` with ``n_steps=1``, or ``make_multi_train_step``'s
    function of ``n_steps`` stacked batches), replayed as one CUDA graph per
    unit shape on the card.  Bound to one ``state`` and ``generator``: the
    graphs read and write their tensors.  The host step count advances by
    ``n_steps`` a unit, as the graph advances the device count.
    ``capture=False`` runs the unit eagerly on a card (``Graphs``)."""

    def __init__(self, fn, state, generator: Optional[torch.Generator], *, n_steps: int = 1,
                 capture: bool = True):
        self.state, self.generator, self.n_steps = state, generator, int(n_steps)

        def unit_fn(unit):
            step = state.step
            _, losses = fn(state, unit, generator)
            state.step = step   # the host count moves in __call__
            return losses

        self.graphs = Graphs(unit_fn, state.step_t.device, state=state.tensors,
                             generators=(generator,), model=state.model, capture=capture)

    def prepare(self, unit: Inputs) -> float:
        """Capture the graph of ``unit``'s shape (``warmup_shapes``); the
        state, the generator and the step stay as they were."""
        return self.graphs.prepare(unit)

    def unit_flops(self, unit: Inputs) -> Optional[float]:
        """FLOPs of one unit of ``unit``'s shape, once one ran (or was
        prepared)."""
        return self.graphs.flops.get(shape_key(unit))

    def __call__(self, state, unit: Inputs, generator: Optional[torch.Generator] = None):
        if state is not self.state or (generator is not None and generator is not self.generator):
            raise ValueError("GraphedStep is bound to the state and generator it was made with")
        losses = self.graphs(unit)
        state.step += self.n_steps
        return state, losses
