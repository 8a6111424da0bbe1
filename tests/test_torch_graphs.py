"""The graph helper (avatarclip_torch/utils/graphs.py) on the CPU, for a
function of one tensor with a tuple of outputs, as the motion decoder's
is: every CPU call is the eager function (outputs and input gradient
equal, no graph kept, no counter moved), and the replay Function's guards
with a stand-in graph that computes eagerly into the static buffers as a
captured pair writes them on the card (each output's gradient reaches the
input; a backward over overwritten or spent activations raises; a pending
replay marks its graph busy). The graphs themselves run in the card tests
(tests/test_torch_cuda.py)."""

import pytest
import torch

from avatarclip_torch.utils import graphs, trace

W = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))


def fn(x):
    h = torch.tanh(x @ W)
    return h, (h * h).sum(-1)


def _eager(x, gys):
    x = x.clone().requires_grad_(True)
    ys = fn(x)
    return tuple(y.detach() for y in ys), torch.autograd.grad(ys, x, gys)[0]


def test_cpu_calls_run_the_function_and_count_nothing():
    cache = graphs.Cache("test_graph", "backward.test")
    gen = torch.Generator().manual_seed(1)
    for _ in range(graphs.WARMUP_CALLS + 2):
        x = torch.randn(3, 5, generator=gen)
        gys = (torch.randn(3, 4, generator=gen), torch.randn(3, generator=gen))
        xg = x.clone().requires_grad_(True)
        ys = cache(fn, "key", [W], xg)
        want, want_g = _eager(x, gys)
        assert all(torch.equal(a.detach(), b) for a, b in zip(ys, want))
        assert torch.equal(torch.autograd.grad(ys, xg, gys)[0], want_g)
        with torch.no_grad():
            assert torch.equal(cache(fn, "key", [W], xg)[0], want[0])
    assert not cache.graphs
    assert not any(k.startswith("test_graph") for k in trace.counters())


class _Eager:
    def __init__(self, run):
        self.replay = run


def _stand_in(shape):
    g = graphs.Graph.__new__(graphs.Graph)
    g.leaves, g.calls, g.generation, g.live = [W], 0, 0, None
    g.x = torch.zeros(shape)
    g.y = (torch.zeros(shape[0], 4), torch.zeros(shape[0]))
    g.gy = tuple(torch.zeros_like(t) for t in g.y)
    g.gx = torch.zeros(shape)
    saved = {}

    def fwd():
        with torch.enable_grad():
            x = g.x.detach().requires_grad_(True)
            ys = fn(x)
        saved.update(x=x, ys=ys)
        for dst, y in zip(g.y, ys):
            dst.copy_(y.detach())

    def bwd():
        g.gx.copy_(torch.autograd.grad(saved.pop("ys"), saved.pop("x"), g.gy)[0])

    g.fwd, g.bwd = _Eager(fwd), _Eager(bwd)
    return g


def test_replay_of_a_tuple_guards_its_activations():
    g = _stand_in((3, 5))
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn(3, 5, generator=gen) for _ in range(3)]
    gys = (torch.randn(3, 4, generator=gen), torch.randn(3, generator=gen))

    x0 = xs[0].clone().requires_grad_(True)
    y0 = graphs.Replay.apply(g, x0)
    assert isinstance(y0, tuple) and len(y0) == 2 and g.busy()
    want, want_g = _eager(xs[0], gys)
    assert all(torch.equal(a.detach(), b) for a, b in zip(y0, want))
    (got,) = torch.autograd.grad(y0, x0, gys, retain_graph=True)
    assert torch.equal(got, want_g) and not g.busy()
    with pytest.raises(RuntimeError, match="spent"):
        torch.autograd.grad(y0, x0, gys, retain_graph=True)

    x1 = xs[1].clone().requires_grad_(True)
    y1 = graphs.Replay.apply(g, x1)
    (got,) = torch.autograd.grad(y1[1].sum(), x1)  # one output's gradient alone: the other's is zero
    assert torch.equal(got, _eager(xs[1], (torch.zeros(3, 4), torch.ones(3)))[1])

    x2 = xs[2].clone().requires_grad_(True)
    y2 = graphs.Replay.apply(g, x2)
    y2b = graphs.Replay.apply(g, xs[2].clone().requires_grad_(True))  # overwrites y2's activations
    with pytest.raises(RuntimeError, match="overwritten"):
        torch.autograd.grad(y2, x2, gys)
    del y2b
    assert not g.busy()
