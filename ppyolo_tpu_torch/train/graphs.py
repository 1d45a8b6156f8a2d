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

All graphs of one ``Graphs`` (and of those made with the same ``pool``)
share one memory pool: only one of them runs at a time, so they can share
their temporaries, and the pool peaks at the largest unit instead of the
sum over shapes.  The price: a graph's outputs are valid until the next
replay of any graph in the pool; read (or copy) them before that.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import _build
from ..ops.module import refresh_caches

WARMUP_ITERS = 1
Inputs = Dict[str, Any]   # name -> tensor, or a tuple of tensors


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
    ``fn`` draws from; ``pool`` is a ``torch.cuda.graph_pool_handle()`` to
    share with other ``Graphs`` (default: one of its own); ``model`` is
    the module whose parameter-derived caches ``fn`` reads.  ``captures``
    holds the capture seconds by shape key.  Each capture first runs ``fn``
    WARMUP_ITERS times eagerly."""

    def __init__(self, fn: Callable[[Inputs], Dict[str, torch.Tensor]], device, *,
                 state: Optional[Callable[[], Dict[str, torch.Tensor]]] = None,
                 generators: Sequence[torch.Generator] = (), pool=None,
                 model: Optional[nn.Module] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.state = state
        self.generators = tuple(g for g in generators if g is not None)
        # shape key -> (graph, static inputs, outputs, {wrapper: calls it recorded})
        self.graphs: Dict[tuple, Tuple[Any, Inputs, Dict[str, torch.Tensor], dict]] = {}
        self.captures: Dict[tuple, float] = {}
        self.on_cuda = self.device.type == "cuda"
        self.model = model
        self._watched = [] if model is None else list(model.state_dict(keep_vars=True).values())
        self._versions = None
        if self.on_cuda:
            self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
            self.stream = torch.cuda.Stream(self.device)

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
        snap = self._snapshot()
        if not self.on_cuda:
            self.fn(inputs)
            self._restore(snap)
        else:
            static = _empty_like_on(inputs, self.device)
            _copy_into(static, inputs)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for _ in range(WARMUP_ITERS):
                    self.fn(static)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            self._restore(snap)
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            before = {fn: fn.captured for fn in _build.COUNTED}
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = self.fn(static)
            recorded = {fn: fn.captured - before.get(fn, 0) for fn in _build.COUNTED}
            self.graphs[key] = (graph, static, out, {f: n for f, n in recorded.items() if n})
            torch.cuda.synchronize(self.device)
        self.captures[key] = time.perf_counter() - t0
        return self.captures[key]

    def __call__(self, inputs: Inputs) -> Dict[str, torch.Tensor]:
        if not self.on_cuda:
            return self.fn(inputs)
        key = shape_key(inputs)
        if key not in self.graphs:
            self.prepare(inputs)
        graph, static, out, recorded = self.graphs[key]
        self._refresh_caches()
        _copy_into(static, inputs)
        graph.replay()
        for fn, n in recorded.items():
            fn.launches += n
        return out

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
    ``n_steps`` a unit, as the graph advances the device count."""

    def __init__(self, fn, state, generator: Optional[torch.Generator], *, n_steps: int = 1):
        self.state, self.generator, self.n_steps = state, generator, int(n_steps)

        def unit_fn(unit):
            step = state.step
            _, losses = fn(state, unit, generator)
            state.step = step   # the host count moves in __call__
            return losses

        self.graphs = Graphs(unit_fn, state.step_t.device, state=state.tensors,
                             generators=(generator,), model=state.model)

    def prepare(self, unit: Inputs) -> float:
        """Capture the graph of ``unit``'s shape (``warmup_shapes``); the
        state, the generator and the step stay as they were."""
        return self.graphs.prepare(unit)

    def __call__(self, state, unit: Inputs, generator: Optional[torch.Generator] = None):
        if state is not self.state or (generator is not None and generator is not self.generator):
            raise ValueError("GraphedStep is bound to the state and generator it was made with")
        losses = self.graphs(unit)
        state.step += self.n_steps
        return state, losses
