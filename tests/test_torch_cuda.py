"""The CUDA kernels of the port against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``: they skip on a host without a CUDA
device and run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU host need not
have.) chip_smoke.py repeats these checks at the main path's shapes."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def test_zbuffer_kernel_matches_plain(dev):
    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.render import cameras, raster

    g = np.random.default_rng(0)
    v = torch.as_tensor(g.normal(0, 0.4, (300, 3)).astype(np.float32), device=dev)
    f = torch.as_tensor(g.integers(0, 300, (700, 3)), device=dev)
    pose = torch.as_tensor(cameras.lookat_np(np.array([0.1, -0.2, 1.5], np.float32),
                                             np.zeros(3, np.float32),
                                             np.array([0, 1, 0], np.float32)), device=dev)
    H, W = 50, 70
    proj = raster.project_vertices(v, pose, H, W, 60.0)
    coef, valid = raster._face_coefficients(proj, f)
    args = (coef, valid, proj.sx[f], proj.sy[f], H, W)
    n0 = rz.LAUNCHES["zbuffer_tiled"]
    got = rz.zbuffer_select_tiled(*args)
    assert rz.LAUNCHES["zbuffer_tiled"] == n0 + 1
    assert torch.equal(got, rz.zbuffer_select_tiled_plain(*args))


def test_neus_kernel_pair_matches_plain(dev):
    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_neus as fn

    g = torch.Generator().manual_seed(0)
    fields = nets.NeuSFields(
        nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), weight_norm=False),
        nets.ColorConfig(d_feature=128, d_hidden=128, n_layers=1, extra_color=True,
                         weight_norm=False), 0.3, g).to(dev)
    R, S = 64, 32
    ro = torch.tensor([[0.0, 0.0, -2.2]]).expand(R, 3) + 0.1 * torch.randn(R, 3, generator=g)
    rd = torch.tensor([[0.0, 0.0, 1.0]]) + 0.05 * torch.randn(R, 3, generator=g)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.linspace(1.2, 3.2, S)[None] + 0.01 * torch.rand(R, S, generator=g))[0]
    dt = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 2.0 / S)], -1)
    ins = [t.to(dev) for t in (ro, rd, z + dt * 0.5, dt)]

    def run(f):
        xs = [t.clone().requires_grad_(True) for t in ins]
        col, nw, ws, ge = f(fields.sdf, fields.color, *xs, fields.variance.inv_s(), 0.4)
        loss = col.sum() + nw.sum() + ws.sum() + ge
        return [col, nw, ws, ge], torch.autograd.grad(loss, list(fields.parameters()) + xs)

    ok, gk = run(fn.point_eval_ray)
    op, gp = run(fn.point_eval_ray_plain)
    for a, b in zip(ok, op):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    for a, b in zip(gk, gp):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def test_neus_point_kernel_pair_matches_plain(dev):
    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_neus as fn

    g = torch.Generator().manual_seed(1)
    fields = nets.NeuSFields(
        nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), weight_norm=False),
        nets.ColorConfig(d_feature=128, d_hidden=128, n_layers=1, extra_color=True,
                         weight_norm=False), 0.3, g).to(dev)
    R, S = 48, 40
    ro = torch.tensor([[0.0, 0.0, -2.2]]).expand(R, 3) + 0.1 * torch.randn(R, 3, generator=g)
    rd = torch.tensor([[0.0, 0.0, 1.0]]) + 0.05 * torch.randn(R, 3, generator=g)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.linspace(1.2, 3.2, S)[None] + 0.01 * torch.rand(R, S, generator=g))[0]
    dt = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 2.0 / S)], -1)
    ins = [t.to(dev) for t in (ro, rd, z + dt * 0.5, dt)]
    probes = [0.5 + torch.rand(R * S, k, generator=g).to(dev) for k in (1, 3, 6)]
    probes += [0.5 + torch.rand(R * S, generator=g).to(dev) for _ in range(2)]

    def run(f):
        xs = [t.clone().requires_grad_(True) for t in ins]
        outs = f(fields.sdf, fields.color, *xs, fields.variance.inv_s(), 0.4)
        loss = sum((o * p).sum() for o, p in zip(outs[:5], probes)) + outs[6]
        return outs, torch.autograd.grad(loss, list(fields.parameters()) + xs)

    n0 = dict(fn.LAUNCHES)
    ok, gk = run(fn.point_eval)
    assert fn.LAUNCHES["neus_point_fwd"] == n0["neus_point_fwd"] + 1
    assert fn.LAUNCHES["neus_point_bwd"] == n0["neus_point_bwd"] + 1
    op, gp = run(fn.point_eval_plain)
    for a, b in zip(ok, op):
        assert (a.detach() - b.detach()).abs().max() <= 1e-4 * max(b.detach().abs().max(), 1e-6)
    for a, b in zip(gk, gp):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
    with torch.no_grad():  # validation: the forward kernel alone, nothing kept
        outs = fn.point_eval(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
    assert outs[0].grad_fn is None


@pytest.mark.parametrize("W,R,S", [(6, 300, 64), (3, 70, 37)])
def test_composite_kernel_pair_matches_plain(dev, W, R, S):
    from avatarclip_torch.ops import fused_composite as fc

    g = torch.Generator().manual_seed(W)
    alpha = (0.3 * torch.rand(R, S, generator=g)).to(dev)
    rgb = torch.rand(R, S, W, generator=g).to(dev)
    grad = torch.randn(R, S, 3, generator=g).to(dev)
    cots = [torch.randn(R, S, generator=g).to(dev)] + [
        torch.randn(R, 3, generator=g).to(dev) for _ in range(3)]

    def run(f):
        xs = [t.clone().requires_grad_(True) for t in (alpha, rgb, grad)]
        outs = f(*xs)
        return outs, torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)), xs)

    n0 = dict(fc.LAUNCHES)
    ok, gk = run(fc.composite)
    assert fc.LAUNCHES["composite_fwd"] == n0["composite_fwd"] + 1
    assert fc.LAUNCHES["composite_bwd"] == n0["composite_bwd"] + 1
    op, gp = run(fc.composite_plain)
    for a, b in zip(list(ok) + list(gk), list(op) + list(gp)):
        assert (a.detach() - b.detach()).abs().max() <= 1e-5 * max(b.detach().abs().max(), 1e-6)
