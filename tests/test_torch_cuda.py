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
    coef, valid, _ = raster._face_coefficients(proj, f)
    args = (coef, valid, proj.sx[f], proj.sy[f], H, W)
    n0 = rz.LAUNCHES["zbuffer_tiled"]
    got = rz.zbuffer_select_tiled(*args)
    assert rz.LAUNCHES["zbuffer_tiled"] == n0 + 1
    assert torch.equal(got, rz.zbuffer_select_plain(coef, valid, H, W))


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


def test_soft_kernel_pair_matches_plain(dev):
    """B5 at a ragged size (partial tiles, a partial face block, 2 views)
    against the plain version in float64: sil_log, num and den to 1e-4 of
    their largest magnitude, the rgb and silhouette they form to 2e-4
    absolute, and the gradients of the x, y and constant edge coefficients,
    ezf and colf each to 1e-3 of its own largest magnitude."""
    from avatarclip_torch.ops import fused_soft as fs
    from avatarclip_torch.render import cameras, raster

    g = np.random.default_rng(2)
    n = 137
    c = g.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    c[:, 2] *= 0.3
    v = torch.as_tensor((c[:, None] + g.uniform(-0.08, 0.08, (n, 3, 3)).astype(np.float32))
                        .reshape(-1, 3), device=dev)
    f = torch.arange(3 * n, device=dev).reshape(n, 3)
    eyes = [np.array(e, np.float32) for e in ((0.0, 0.0, 2.0), (0.3, -0.2, 1.9))]
    poses = torch.stack([torch.as_tensor(cameras.lookat_np(e, np.zeros(3, np.float32),
                                                           np.array([0, 1, 0], np.float32)))
                         for e in eyes]).to(dev)
    H, W = 50, 70
    fi = raster.soft_face_inputs(v.expand(2, -1, -1), f, poses, H, W, 60.0)
    faces, tab = fs.prepare(fi["coef"], fi["valid"], fi["edge_inv_len"], fi["iz_face"],
                            fi["colors_face"], H, W, 0.5, 0.005, fi["face_sx"], fi["face_sy"])
    faces = faces.detach().contiguous()
    cot = [torch.rand(2, H * W, device=dev), torch.rand(2, H * W, 3, device=dev) * 1e-26,
           -torch.rand(2, H * W, device=dev) * 1e-26]

    def run(fn, x0, cots):
        x = x0.clone().requires_grad_(True)
        outs = fn(x)
        return [o.detach() for o in outs], torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cots)), [x])[0]

    n0 = dict(fs.LAUNCHES)
    ok, gk = run(lambda x: fs.aggregate(x, tab, H, W, 2.0), faces, cot)
    assert fs.LAUNCHES["soft_fwd"] == n0["soft_fwd"] + 1
    assert fs.LAUNCHES["soft_bwd"] == n0["soft_bwd"] + 1
    op, gp = run(lambda x: fs.aggregate_plain(x, H, W, 2.0), faces.double(), [c.double() for c in cot])
    for a, b in zip(ok, op):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    for a, b in ((ok[1] / (ok[2][..., None] + 1.0), op[1] / (op[2][..., None] + 1.0)),
                 (torch.exp(ok[0]), torch.exp(op[0]))):
        assert (a - b).abs().max() <= 2e-4
    for cols in (slice(0, 9, 3), slice(1, 9, 3), slice(2, 9, 3), slice(9, 10), slice(10, 13)):
        assert (gk[..., cols] - gp[..., cols]).abs().max() <= 1e-3 * gp[..., cols].abs().max()
    assert float(gk[..., 13:].abs().max()) == 0.0


def test_sdf_kernel_pair_matches_plain(dev):
    """B6 at 256 wide on a ragged 1,000 points (15 full blocks of 64 and
    one of 40) against the plain version in float64: sdf, feature and
    gradient to 1e-4, every weight gradient and d(points) to 1e-3 of their
    largest magnitude, with cotangents on all three outputs."""
    import copy

    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    g = torch.Generator().manual_seed(3)
    sdf = nets.SDFNetwork(nets.SDFConfig(weight_norm=False), g)
    with torch.no_grad():
        for p in sdf.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    sdf = sdf.to(dev)
    P = 1000
    pts = (0.6 * torch.randn(P, 3, generator=g)).to(dev)
    cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, 256, 3)]
    n0 = dict(fs.LAUNCHES)
    ok, gk = hold.net_grads(fs.sdf_with_gradient_fused, sdf, [pts], cots)
    assert fs.LAUNCHES == {**n0, "sdf_fwd": n0["sdf_fwd"] + 1, "sdf_bwd": n0["sdf_bwd"] + 1}
    ref = copy.deepcopy(sdf).double()
    orf, grf = hold.net_grads(fs.sdf_with_gradient_plain, ref, [pts.double()], [c.double() for c in cots])
    assert max(hold.rel_errors(ok, orf)) <= 1e-4
    assert max(hold.rel_errors(gk, grf)) <= 1e-3
    # the gate takes the kernels on the card
    assert nets.sdf_with_gradient(sdf, pts)[0].grad_fn.name().startswith("SDFFunction")


def test_sdf_only_kernel_matches_plain(dev):
    """#12 (the sdf-only forward) at 256 wide on a ragged 1,000 points
    against the plain version in float64: sdf to 1e-4 of its largest
    magnitude; the Function's VJP (autograd of the plain version) into every
    parameter and the points to 1e-3. The sweep hook, when on, takes it."""
    import copy

    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    g = torch.Generator().manual_seed(5)
    sdf = nets.SDFNetwork(nets.SDFConfig(), g)
    with torch.no_grad():
        for p in sdf.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    sdf = sdf.to(dev)
    P = 1000
    pts = (0.6 * torch.randn(P, 3, generator=g)).to(dev)
    cots = [(0.5 + torch.rand(P, 1, generator=g)).to(dev)]
    n0 = dict(fs.LAUNCHES)
    ok, gk = hold.net_grads(fs.sdf_value_fused, sdf, [pts], cots)
    assert fs.LAUNCHES == {**n0, "sdf_only_fwd": n0["sdf_only_fwd"] + 1}
    ref = copy.deepcopy(sdf).double()
    orf, grf = hold.net_grads(fs.sdf_only_plain, ref, [pts.double()], [cots[0].double()])
    assert max(hold.rel_errors(ok, orf)) <= 1e-4
    assert max(hold.rel_errors(gk, grf)) <= 1e-3
    nets._SWEEP_KERNEL = True
    try:
        with torch.no_grad():
            got = nets.sdf_value(sdf, pts)
    finally:
        nets._SWEEP_KERNEL = False
    assert fs.LAUNCHES["sdf_only_fwd"] == n0["sdf_only_fwd"] + 2
    assert torch.equal(got, ok[0].detach())


def test_zbuffer_brute_kernel_matches_plain_and_tiled(dev):
    """#15 (the brute-force z-buffer) on a ragged 200 x 136 screen and 1,100
    faces (a ragged last face block): equal to the plain version and to B2's
    winners, exactly."""
    from avatarclip_torch.ops import raster_zbuffer as rz
    from avatarclip_torch.render import cameras, raster

    g = np.random.default_rng(1)
    v = torch.as_tensor(g.normal(0, 0.4, (400, 3)).astype(np.float32), device=dev)
    f = torch.as_tensor(g.integers(0, 400, (1100, 3)), device=dev)
    pose = torch.as_tensor(cameras.lookat_np(np.array([0.05, -0.1, 1.6], np.float32),
                                             np.zeros(3, np.float32),
                                             np.array([0, 1, 0], np.float32)), device=dev)
    H, W = 200, 136
    proj = raster.project_vertices(v, pose, H, W, 150.0)
    coef, valid, _ = raster._face_coefficients(proj, f)
    n0 = dict(rz.LAUNCHES)
    got = rz.zbuffer_select(coef, valid, H, W)
    assert rz.LAUNCHES == {**n0, "zbuffer_brute": n0["zbuffer_brute"] + 1}
    assert int((got >= 0).sum()) > 1000
    assert torch.equal(got, rz.zbuffer_select_plain(coef, valid, H, W))
    assert torch.equal(got, rz.zbuffer_select_tiled(coef, valid, proj.sx[f], proj.sy[f], H, W))


@pytest.mark.parametrize("mode,extra", [("no_view_dir", True), ("idr", False)])
def test_color_kernel_pair_matches_plain(dev, mode, extra):
    """B7 at 256 wide on a ragged 1,000 points against the plain version in
    float64: the output to 1e-4, every weight gradient and the four input
    cotangents to 1e-3 of their largest magnitude, at every point (at a relu
    near-tie, under the masks the kernel took)."""
    import copy

    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_color as fc
    from avatarclip_torch.ops import hold

    g = torch.Generator().manual_seed(4)
    color = nets.ColorNetwork(nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6,
                                               extra_color=extra, weight_norm=False), g).to(dev)
    P = 1000
    ins = [torch.rand(P, 3, generator=g) * 2 - 1, torch.randn(P, 3, generator=g),
           torch.randn(P, 3, generator=g), torch.randn(P, 256, generator=g)]
    ins = [t.to(dev) for t in ins]
    cots = [(0.5 + torch.rand(P, 6 if extra else 3, generator=g)).to(dev)]

    n0 = dict(fc.LAUNCHES)
    ok, gk = hold.net_grads(fc.color_apply_fused, color, ins, cots)
    assert fc.LAUNCHES == {"color_fwd": n0["color_fwd"] + 1, "color_bwd": n0["color_bwd"] + 1}
    ref = copy.deepcopy(color).double()
    ins64 = [t.double() for t in ins]
    orf, grf = hold.net_grads(fc.color_apply_plain, ref, ins64, [c.double() for c in cots])
    assert max(hold.rel_errors(ok, orf)) <= 1e-4
    n_p = len(grf) - 4
    grf[n_p:], _ = hold.resolve_relu_ties(ref, ins64, cots[0].double(), gk[n_p:], grf[n_p:])
    assert max(hold.rel_errors(gk, grf)) <= 1e-3
