"""A function of one tensor replayed from CUDA graphs, for the training
steps' frozen towers (CLIP's image tower, the motion VAE's decoder).

``Cache(prefix, span)(fn, key, leaves, x)`` is ``fn(x)`` with the same
ops and numbers, where ``fn`` reads only ``x`` and frozen tensors
(``leaves``, held and checked by identity) and returns a tensor or a tuple
of tensors. It engages where the call is a training step's: ``x`` on a
CUDA device and requiring grad, grad mode on, no leaf requiring grad.
Anything else, every CPU call included, runs ``fn(x)`` itself and counts
nothing.

A key runs eager for its first ``WARMUP_CALLS`` calls (on the capture's
side stream), is captured on the next (a forward graph from a static input
to static outputs, and the input gradient's graph from static output
gradients to a static input gradient, sharing one memory pool) and
replayed from then on through :class:`Replay`, whose backward opens the
cache's ``span``. While a replay's backward is pending, a call of the same key
runs eager. Counters (utils/trace.py): ``<prefix>_eager`` (grad-mode CUDA
calls that ran eager: warm-up and pending replays), ``<prefix>_capture``,
``<prefix>_replay`` (calls that replayed an earlier capture).
"""

from __future__ import annotations

import collections
import threading
import weakref

import torch

from . import trace

WARMUP_CALLS = 2  # eager calls of a key before its capture, on the capture's stream
GRAPH_KEYS = 8  # keys kept at once by a cache; each holds its two graphs and their memory pool

LOCK = threading.RLock()  # every cache's; the backward runs on autograd's worker thread


def leaves(tree) -> list:
    """The tensors of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _map(f, y):
    """``f`` of a tensor, or of each tensor of a tuple."""
    return f(y) if isinstance(y, torch.Tensor) else tuple(f(t) for t in y)


class Graph:
    """One key's function as two CUDA graphs. ``y`` and ``gy`` are a tensor
    or a tuple of tensors, as the function returns.

    ``generation`` counts the forward replays and the spent backwards: a
    backward replays only over the activations of its own forward. ``live``
    weakly references the pending replay's autograd context while its
    backward has not run."""

    span = "backward"  # the input gradient's span, named in its errors; a Cache gives its own

    def __init__(self, held: list, device: torch.device, span: str):
        self.leaves = held  # held: the graphs read these tensors' memory
        self.span = span
        self.stream = torch.cuda.Stream(device)
        self.calls = 0
        self.fwd = self.bwd = None
        self.generation = 0
        self.live = None

    def busy(self) -> bool:
        return self.live is not None and self.live() is not None

    def warm(self, fn, x: torch.Tensor):
        """An eager call on the capture's stream (its backward runs there too)."""
        cur = torch.cuda.current_stream(x.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn(x)
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn, x: torch.Tensor) -> None:
        self.x = torch.empty(x.shape, dtype=x.dtype, device=x.device).requires_grad_(True)
        pool = torch.cuda.graph_pool_handle()
        # thread_local: another thread's CUDA calls (a validation worker's)
        # neither fail nor break the capture
        fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(fwd, pool=pool, stream=self.stream, capture_error_mode="thread_local"):
            y = fn(self.x)
        self.gy = _map(torch.empty_like, y)
        bwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(bwd, pool=pool, stream=self.stream, capture_error_mode="thread_local"):
            (self.gx,) = torch.autograd.grad(y, self.x, self.gy)
        self.y = _map(torch.Tensor.detach, y)
        self.fwd, self.bwd = fwd, bwd

    def forward(self, x: torch.Tensor) -> int:
        self.x.copy_(x)
        self.fwd.replay()
        self.generation += 1
        return self.generation

    def backward(self, generation: int, gys: tuple) -> torch.Tensor:
        with LOCK:
            if generation != self.generation:
                raise RuntimeError(
                    f"{self.span}: this backward's activations were overwritten by a "
                    "later replay or spent by an earlier backward")
            for dst, g in zip((self.gy,) if isinstance(self.gy, torch.Tensor) else self.gy, gys):
                dst.copy_(g)
            self.bwd.replay()
            self.generation += 1  # the backward frees the activations it reads
            self.live = None
            return self.gx.clone()


class Replay(torch.autograd.Function):
    """A captured graph's forward replay; its backward replays the input
    gradient's graph under the graph's span."""

    @staticmethod
    def forward(ctx, graph: Graph, x: torch.Tensor):
        ctx.graph, ctx.generation = graph, graph.forward(x)
        graph.live = weakref.ref(ctx)  # dead once autograd drops the node unrun
        return _map(torch.clone, graph.y)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gys: torch.Tensor):
        with trace.span(ctx.graph.span):
            return None, ctx.graph.backward(ctx.generation, gys)


class Cache:
    """The keys of one graphed function (module docstring)."""

    def __init__(self, prefix: str, span: str):
        self.prefix, self.span = prefix, span
        self.graphs: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, fn, key, held: list, x: torch.Tensor):
        if not (x.is_cuda and x.requires_grad and torch.is_grad_enabled()):
            return fn(x)
        if any(t.requires_grad for t in held):
            return fn(x)
        key = (tuple(x.shape), x.dtype, x.device, key)
        with LOCK:
            g = self.graphs.get(key)
            if g is None or len(g.leaves) != len(held) or any(a is not b for a, b in zip(g.leaves, held)):
                g = self.graphs[key] = Graph(held, x.device, self.span)
                while len(self.graphs) > GRAPH_KEYS:
                    self.graphs.popitem(last=False)
            self.graphs.move_to_end(key)
            if g.fwd is None and g.calls < WARMUP_CALLS:
                g.calls += 1
                trace.count(self.prefix + "_eager")
                return g.warm(fn, x)
            if g.busy():
                trace.count(self.prefix + "_eager")
                return fn(x)
            if g.fwd is None:
                g.capture(fn, x)
                trace.count(self.prefix + "_capture")
            else:
                trace.count(self.prefix + "_replay")
            return Replay.apply(g, x)
