"""CLIP's image tower as CUDA graphs (avatarclip_torch/clip/model.py), on the
CPU: the constants the resize and the normalisation keep resident (equal to
freshly built ones bit for bit, built once per key), the graphed entry equal
to the eager ops (forward and input gradient, float32 and bfloat16) where it
bypasses the graphs, as it does for every CPU tensor, without touching any
``clip_graph_*`` counter, and the replay Function's guards (a backward over
overwritten or spent activations raises; a pending replay marks its graph
busy) with stand-in graphs that compute eagerly. The graphs themselves run
in the card tests (tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from avatarclip_torch.clip import model as clip_model
from avatarclip_torch.utils import trace

COUNTERS = ("clip_graph_eager", "clip_graph_capture", "clip_graph_replay")
WARM_AND_REPLAY = clip_model.WARMUP_CALLS + 2  # calls that would warm up, capture and replay on a card


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src,dst", [(256, 224), (112, 224), (224, 224)],
                         ids=["downsample", "upsample", "identity"])
def test_resize_weights_are_built_once_and_equal_fresh_ones(src, dst):
    fresh = clip_model._resize_weights.__wrapped__(src, dst, torch.device("cpu"), torch.float32)
    got = clip_model.resize_weights(src, dst)
    assert got.dtype == fresh.dtype == torch.float32 and got.shape == (src, dst)
    assert torch.equal(got, fresh)
    assert np.array_equal(got.numpy().view(np.uint32), fresh.numpy().view(np.uint32))
    hits = clip_model._resize_weights.cache_info().hits
    assert clip_model.resize_weights(src, dst, "cpu") is got
    assert clip_model.resize_weights(src, dst, torch.device("cpu")) is got
    assert clip_model._resize_weights.cache_info().hits == hits + 2
    if src == dst:  # the identity follows the default dtype, as torch.eye does
        assert torch.equal(got, torch.eye(src))
        torch.set_default_dtype(torch.float64)
        try:
            assert clip_model.resize_weights(src, dst).dtype == torch.float64
        finally:
            torch.set_default_dtype(torch.float32)


def test_resize_image_is_unchanged_by_the_cache():
    """The resize through the cached matrices equals the same einsum over
    matrices built on the spot."""
    img = torch.rand(2, 112, 112, 3, generator=torch.Generator().manual_seed(0))
    w = clip_model._resize_weights.__wrapped__(112, 224, torch.device("cpu"), torch.float32)
    want = torch.einsum("nhwc,ho,wp->nopc", img, w, w)
    assert torch.equal(clip_model.resize_to_clip(img, 224), want)


def test_normalisation_constants_are_resident_and_exact():
    mean, std = clip_model._mean_std(torch.device("cpu"))
    assert np.array_equal(mean.numpy(), clip_model.CLIP_IMAGE_MEAN)
    assert np.array_equal(std.numpy(), clip_model.CLIP_IMAGE_STD)
    assert clip_model._mean_std(torch.device("cpu"))[0] is mean
    x = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    want = (x - torch.as_tensor(clip_model.CLIP_IMAGE_MEAN)) / torch.as_tensor(clip_model.CLIP_IMAGE_STD)
    assert torch.equal(clip_model.normalize_image(x), want)


@pytest.fixture(scope="module")
def tiny_params():
    return clip_model.init_params(clip_model.TINY, torch.Generator().manual_seed(42))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_entry_on_the_cpu_is_the_eager_tower(tiny_params, dtype):
    """On the CPU the entry runs ``encode_image(normalize_image(x))`` itself:
    equal output and input gradient, nothing captured and no ``clip_graph_*``
    counter moved at all, in grad mode, with grad off and under no_grad."""
    cfg = dataclasses.replace(clip_model.TINY, compute_dtype=dtype)
    before = {k: trace.counters().get(k, 0) for k in COUNTERS}
    graphs = len(clip_model._graphs)
    gen = torch.Generator().manual_seed(2)
    for _ in range(WARM_AND_REPLAY):
        img = torch.rand(2, 64, 64, 3, generator=gen)
        gy = torch.randn(2, cfg.embed_dim, generator=gen)
        x1, x2 = img.clone().requires_grad_(True), img.clone().requires_grad_(True)
        got = clip_model.encode_image_graphed(tiny_params, cfg, x1)
        want = clip_model.encode_image(tiny_params, cfg, clip_model.normalize_image(x2))
        assert got.dtype == torch.float32 and torch.equal(got, want)
        (g1,), (g2,) = torch.autograd.grad(got, x1, gy), torch.autograd.grad(want, x2, gy)
        assert torch.equal(g1, g2)
        with torch.no_grad():
            assert torch.equal(clip_model.encode_image_graphed(tiny_params, cfg, img), want)
        assert torch.equal(clip_model.encode_image_graphed(tiny_params, cfg, img), want)
    assert {k: trace.counters().get(k, 0) for k in COUNTERS} == before
    assert len(clip_model._graphs) == graphs


class _Eager:
    """A stand-in for a captured graph: ``replay`` runs ``fn`` eagerly."""

    def __init__(self, fn):
        self.replay = fn


def _stand_in(params, cfg, shape):
    """An _ImageGraph whose 'graphs' compute eagerly into its static
    buffers, as a captured pair writes them on the card."""
    g = clip_model._ImageGraph.__new__(clip_model._ImageGraph)
    g.leaves, g.calls, g.generation, g.live = clip_model._leaves(params["visual"]), 0, 0, None
    g.x = torch.zeros(shape).requires_grad_(True)
    g.y = torch.zeros(shape[0], cfg.embed_dim)
    g.gy, g.gx = torch.zeros_like(g.y), torch.zeros(shape)
    saved = {}

    def fwd():
        with torch.enable_grad():
            x = g.x.detach().requires_grad_(True)
            y = clip_model.encode_image(params, cfg, clip_model.normalize_image(x))
        saved.update(x=x, y=y)
        g.y.copy_(y.detach())

    def bwd():
        (gx,) = torch.autograd.grad(saved.pop("y"), saved.pop("x"), g.gy)
        g.gx.copy_(gx)

    g.fwd, g.bwd = _Eager(fwd), _Eager(bwd)
    return g


def _eager(params, cfg, img, gy):
    x = img.clone().requires_grad_(True)
    y = clip_model.encode_image(params, cfg, clip_model.normalize_image(x))
    return y.detach(), torch.autograd.grad(y, x, gy)[0]


def test_replay_function_guards_its_activations(tiny_params):
    """Through the replay Function: the output and input gradient of the
    eager tower; busy while its backward is pending, free after it or once
    its autograd graph is dropped; a second backward of one replay (spent
    activations) and a backward after a later replay (overwritten ones)
    raise."""
    cfg = clip_model.TINY
    g = _stand_in(tiny_params, cfg, (2, 64, 64, 3))
    gen = torch.Generator().manual_seed(3)
    imgs = [torch.rand(2, 64, 64, 3, generator=gen) for _ in range(3)]
    gy = torch.randn(2, cfg.embed_dim, generator=gen)

    x0 = imgs[0].clone().requires_grad_(True)
    y0 = clip_model._Replay.apply(g, x0)
    assert g.busy()
    want_y, want_g = _eager(tiny_params, cfg, imgs[0], gy)
    assert torch.equal(y0, want_y)
    (got,) = torch.autograd.grad(y0, x0, gy, retain_graph=True)
    assert torch.equal(got, want_g) and not g.busy()
    with pytest.raises(RuntimeError, match="spent|overwritten"):
        torch.autograd.grad(y0, x0, gy, retain_graph=True)

    x1 = imgs[1].clone().requires_grad_(True)
    y1 = clip_model._Replay.apply(g, x1)
    assert g.busy()
    del y1  # the graph dropped before its backward: the key is free again
    assert not g.busy()

    x2 = imgs[2].clone().requires_grad_(True)
    y2 = clip_model._Replay.apply(g, x2)
    x2b = imgs[2].clone().requires_grad_(True)
    y2b = clip_model._Replay.apply(g, x2b)  # overwrites y2's activations
    with pytest.raises(RuntimeError, match="overwritten"):
        torch.autograd.grad(y2, x2, gy)
    (got,) = torch.autograd.grad(y2b, x2b, gy)
    assert torch.equal(got, _eager(tiny_params, cfg, imgs[2], gy)[1])
