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

_KEYS = {"raster_zbuffer": ("zbuffer_tiled", "zbuffer_brute"),
         "fused_neus": ("neus_ray_fwd", "neus_ray_bwd", "neus_point_fwd", "neus_point_bwd"),
         "fused_composite": ("composite_fwd", "composite_bwd"),
         "fused_soft": ("soft_fwd", "soft_bwd", "soft_fwd_reduce", "soft_bwd_reduce"),
         "fused_sdf": ("sdf_fwd", "sdf_bwd", "sdf_only_fwd"),
         "fused_color": ("color_fwd", "color_bwd")}


def launches(module) -> dict:
    """The launch registry's counts of one kernel module's wrappers."""
    from avatarclip_torch.utils import trace

    counts = trace.launches()
    return {k: counts[k] for k in _KEYS[module.__name__.rsplit(".", 1)[1]]}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _zbuffer_scene(name, dev):
    """(coef, valid, face_sx, face_sy, H, W): a ragged 50 x 70 triangle soup,
    or the 13,776-face body at a 224^2 scoring view or visualize's 512^2
    camera."""
    from avatarclip_torch.pipelines import synthetic, visualize
    from avatarclip_torch.render import cameras, raster

    if name == "soup 50x70":
        g = np.random.default_rng(0)
        v = torch.as_tensor(g.normal(0, 0.4, (300, 3)).astype(np.float32), device=dev)
        f = torch.as_tensor(g.integers(0, 300, (700, 3)), device=dev)
        pose = torch.as_tensor(cameras.lookat_np(np.array([0.1, -0.2, 1.5], np.float32),
                                                 np.zeros(3, np.float32),
                                                 np.array([0, 1, 0], np.float32)), device=dev)
        H, W, focal = 50, 70, 60.0
    else:
        body_v, f, poses, focal = synthetic.humanoid_views(dev, elev_std=0.0)
        v = body_v[0]
        if name == "body 224^2":
            pose, H, W = poses[2], 224, 224
        else:
            pose, focal = visualize.camera(dev, 512)
            H = W = 512
    proj = raster.project_vertices(v, pose, H, W, focal)
    coef, valid, _ = raster._face_coefficients(proj, f)
    return coef, valid, proj.sx[f], proj.sy[f], H, W


@pytest.mark.parametrize("scene", ["soup 50x70", "body 224^2", "body 512^2"])
def test_zbuffer_kernel_matches_plain(dev, scene):
    """B2 equals the plain version at every pixel with one counted launch a
    call: on a ragged soup and on the 13,776-face body at 224^2 and 512^2."""
    from avatarclip_torch.ops import raster_zbuffer as rz

    coef, valid, sx, sy, H, W = _zbuffer_scene(scene, dev)
    n0 = launches(rz)["zbuffer_tiled"]
    got = rz.zbuffer_select_tiled(coef, valid, sx, sy, H, W)
    assert launches(rz)["zbuffer_tiled"] == n0 + 1
    want = rz.zbuffer_select_plain(coef, valid, H, W)
    assert int((want >= 0).sum()) > 500
    assert torch.equal(got, want)


@pytest.mark.parametrize("split", [1, 2, 4])
def test_zbuffer_kernel_matches_plain_at_every_split(dev, split):
    """B2's C call with each tile's faces split over a cluster of 1, 2 or 4
    CTAs (every size the entry picks: 4 at 224^2) on the 224^2 body: the
    plain version's winners, from a grid of that many CTAs a tile."""
    from avatarclip_torch.ops import raster_zbuffer as rz

    coef, valid, sx, sy, H, W = _zbuffer_scene("body 224^2", dev)
    ranges = torch.empty(2 * coef.shape[0], dtype=torch.int32, device=dev)
    out = torch.empty(H * W, dtype=torch.int32, device=dev)
    rz.launch(coef, valid, sx, sy, ranges, out, H, W, split)
    assert torch.equal(out, rz.zbuffer_select_plain(coef, valid, H, W))
    n_ty, n_tx = rz.bin_grid(H, W)
    assert rz._lib().zbuffer_ctas(H, W, split) == n_ty * n_tx * split
    assert rz.grid(H, W) == (n_ty * n_tx, n_ty * n_tx * 4)


def test_zbuffer_kernel_is_deterministic(dev):
    """Two launches of B2 on the 512^2 body give the same bits."""
    from avatarclip_torch.ops import raster_zbuffer as rz

    args = _zbuffer_scene("body 512^2", dev)
    assert torch.equal(rz.zbuffer_select_tiled(*args), rz.zbuffer_select_tiled(*args))


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
        col, nw, ws, eik = f(fields.sdf, fields.color, *xs, fields.variance.inv_s(), 0.4)
        ge = fn.eik_ratio(eik)
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
        outs = (*outs[:6], fn.eik_ratio(outs[6]))
        loss = sum((o * p).sum() for o, p in zip(outs[:5], probes)) + outs[6]
        return outs, torch.autograd.grad(loss, list(fields.parameters()) + xs)

    n0 = launches(fn)
    ok, gk = run(fn.point_eval)
    assert launches(fn)["neus_point_fwd"] == n0["neus_point_fwd"] + 1
    assert launches(fn)["neus_point_bwd"] == n0["neus_point_bwd"] + 1
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

    n0 = launches(fc)
    ok, gk = run(fc.composite)
    assert launches(fc)["composite_fwd"] == n0["composite_fwd"] + 1
    assert launches(fc)["composite_bwd"] == n0["composite_bwd"] + 1
    op, gp = run(fc.composite_plain)
    for a, b in zip(list(ok) + list(gk), list(op) + list(gp)):
        assert (a.detach() - b.detach()).abs().max() <= 1e-5 * max(b.detach().abs().max(), 1e-6)


def _soft_problem(v, f, poses, H, W, focal, sigma):
    from avatarclip_torch.ops import fused_soft as fs
    from avatarclip_torch.render import raster

    fi = raster.soft_face_inputs(v, f, poses, H, W, focal)
    faces, tab = fs.prepare(fi["coef"], fi["valid"], fi["edge_inv_len"], fi["iz_face"],
                            fi["colors_face"], H, W, sigma, 0.005, fi["face_sx"], fi["face_sy"])
    return faces.detach().contiguous(), tab


def _soft_cotangents(B, P, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(B, P, generator=g).to(dev), (torch.rand(B, P, 3, generator=g) * 1e-26).to(dev),
            (-torch.rand(B, P, generator=g) * 1e-26).to(dev)]


def _soft_f64_f32_edges(faces, H, W, inv_sigma):
    """The plain version in float64 with each pair's min over the edges
    taken at the edges float32 takes it at (ties split equally, as in the
    kernels and in XLA's reduce-min): along a face whose edge lines are
    nearly parallel, float32 rounds a band of pixels to the other edge, and
    the float32 function's edge gradients (the plain version's as the
    kernels') then differ from the float64 function's beyond the 1e-3
    tolerance under a silhouette cotangent on every pixel. So every pair is
    held in float64 under the float32 edge choice, as B7's relu near-ties
    are (ops/hold.resolve_relu_ties). Face chunks checkpointed, as in
    aggregate_plain."""
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    from avatarclip_torch.ops import fused_soft as fs

    B, Fp, _ = faces.shape
    px, py = fs._pixel_coords(H, W, faces.device, torch.float64)

    def chunk(fc):
        f32 = fc.detach().float()
        v32 = torch.stack([(px.float() * f32[:, None, :, 3 * e] + py.float() * f32[:, None, :, 3 * e + 1])
                           + f32[:, None, :, 3 * e + 2] for e in range(3)], -1)
        m = (v32 == v32.amin(-1, keepdim=True)).double()
        v = torch.stack([(px * fc[:, None, :, 3 * e] + py * fc[:, None, :, 3 * e + 1]) + fc[:, None, :, 3 * e + 2]
                         for e in range(3)], -1)
        x = (v * m).sum(-1) / m.sum(-1) * inv_sigma
        vmask = fc[:, None, :, 13]
        w = torch.sigmoid(x) * vmask * fc[:, None, :, 9]
        return (-F.softplus(x) * vmask).sum(-1), torch.bmm(w, fc[..., 10:13]), w.sum(-1)

    sil, num, den = faces.new_zeros(B, H * W), faces.new_zeros(B, H * W, 3), faces.new_zeros(B, H * W)
    for f0 in range(0, Fp, fs.PLAIN_CHUNK):
        s, n, d = checkpoint(chunk, faces[:, f0:f0 + fs.PLAIN_CHUNK], use_reentrant=False)
        sil, num, den = sil + s, num + n, den + d
    return sil, num, den


def _hold_soft(faces, tab, H, W, inv_sigma, cot, reference=None):
    """B5 through aggregate (one launch of each kernel and of each partial
    sum) against ``reference`` on the faces in float64 (the plain version
    by default): sil_log, num and den to 1e-4 of their largest magnitude,
    the rgb and silhouette they form to 2e-4 absolute, and the gradients of
    the x, y and constant edge coefficients, ezf and colf each to 1e-3 of
    its own largest magnitude; the vmask and padding columns' gradient 0."""
    from avatarclip_torch.ops import fused_soft as fs

    reference = reference or (lambda x: fs.aggregate_plain(x, H, W, inv_sigma))

    def run(fn, x0, cots):
        x = x0.clone().requires_grad_(True)
        outs = fn(x)
        return [o.detach() for o in outs], torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cots)), [x])[0]

    n0 = launches(fs)
    ok, gk = run(lambda x: fs.aggregate(x, tab, H, W, inv_sigma), faces, cot)
    assert {k: launches(fs)[k] - n0[k] for k in n0} == {k: 1 for k in n0}
    op, gp = run(reference, faces.double(), [c.double() for c in cot])
    for a, b in zip(ok, op):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    for a, b in ((ok[1] / (ok[2][..., None] + 1.0), op[1] / (op[2][..., None] + 1.0)),
                 (torch.exp(ok[0]), torch.exp(op[0]))):
        assert (a - b).abs().max() <= 2e-4
    for cols in (slice(0, 9, 3), slice(1, 9, 3), slice(2, 9, 3), slice(9, 10), slice(10, 13)):
        assert (gk[..., cols] - gp[..., cols]).abs().max() <= 1e-3 * gp[..., cols].abs().max()
    assert float(gk[..., 13:].abs().max()) == 0.0


def _soft_ragged(dev):
    from avatarclip_torch.render import cameras

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
    return _soft_problem(v.expand(2, -1, -1), f, poses, 50, 70, 60.0, 0.5)


def test_soft_kernel_pair_matches_plain(dev):
    """B5 at a ragged size (partial tiles, a partial face block, 2 views)
    against the plain version in float64 (_hold_soft)."""
    faces, tab = _soft_ragged(dev)
    _hold_soft(faces, tab, 50, 70, 2.0, _soft_cotangents(2, 50 * 70, dev))


def test_soft_kernel_pair_holds_at_motion_step(dev):
    """B5 at one MotionOptimizer step's shapes, the 13,776-face body at 2
    views x 224^2, sigma 0.5, against float64 (_hold_soft) under the edges
    float32 takes each pair's min at (_soft_f64_f32_edges)."""
    from avatarclip_torch.pipelines import synthetic

    v, f, poses, focal = synthetic.humanoid_views(dev, n_views=2)
    faces, tab = _soft_problem(v, f, poses, 224, 224, focal, 0.5)
    _hold_soft(faces, tab, 224, 224, 2.0, _soft_cotangents(2, 224 * 224, dev, seed=1),
               reference=lambda x: _soft_f64_f32_edges(x, 224, 224, 2.0))


def test_soft_kernels_are_deterministic(dev):
    """Two launches of B5's forward and of its backward on the same inputs
    give the same bits (fixed-order sums, no atomics), on the ragged scene
    and at the motion step's shapes."""
    from avatarclip_torch.ops import fused_soft as fs
    from avatarclip_torch.pipelines import synthetic

    v, f, poses, focal = synthetic.humanoid_views(dev, n_views=2)
    for (faces, tab), H, W in ((_soft_ragged(dev), 50, 70),
                               (_soft_problem(v, f, poses, 224, 224, focal, 0.5), 224, 224)):
        cot = _soft_cotangents(faces.shape[0], H * W, dev, seed=2)
        a, b = fs.soft_fwd(faces, tab, H, W, 2.0), fs.soft_fwd(faces, tab, H, W, 2.0)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(fs.soft_bwd(faces, tab, *cot, H, W, 2.0), fs.soft_bwd(faces, tab, *cot, H, W, 2.0))


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
    n0 = launches(fs)
    ok, gk = hold.net_grads(fs.sdf_with_gradient_fused, sdf, [pts], cots)
    assert launches(fs) == {**n0, "sdf_fwd": n0["sdf_fwd"] + 1, "sdf_bwd": n0["sdf_bwd"] + 1}
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
    n0 = launches(fs)
    ok, gk = hold.net_grads(fs.sdf_value_fused, sdf, [pts], cots)
    assert launches(fs) == {**n0, "sdf_only_fwd": n0["sdf_only_fwd"] + 1}
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
    assert launches(fs)["sdf_only_fwd"] == n0["sdf_only_fwd"] + 2
    assert torch.equal(got, ok[0].detach())


@pytest.mark.parametrize("name", ["soup", "ties", "negzero", "nan", "all invalid", "empty"])
@pytest.mark.parametrize("split", [1, 2, 0], ids=["split1", "split2", "entry"])
@pytest.mark.parametrize("shape", [(200, 136), (224, 224), (256, 256), (512, 512)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_zbuffer_brute_kernel_matches_plain_and_tiled(dev, shape, split, name):
    """#15 (the brute-force z-buffer) on tests/torch_zbuffer_scenes.py's
    scenes (1,100 soup faces: a ragged last face block; exact duplicates,
    -0.0 edge values, NaN coefficients, every face invalid, no face) at a
    ragged 200 x 136 and at 224^2, 256^2 and 512^2: through its entry (one
    counted launch) and at a forced face split of 1 or 2 (the C call's
    seam), equal to the plain version and to B2's winners, exactly; its
    grid is brute_plan's."""
    import torch_zbuffer_scenes as zs

    from avatarclip_torch.ops import raster_zbuffer as rz

    H, W = shape
    coef, valid, sx, sy = (torch.from_numpy(x).to(dev) for x in zs.scene(name, H, W))
    F = coef.shape[0]
    want = rz.zbuffer_select_plain(coef, valid, H, W)
    if name in ("all invalid", "empty"):
        assert bool((want == -1).all())
    else:
        assert int((want >= 0).sum()) > 1000
    n0 = launches(rz)
    got = rz.zbuffer_select(coef, valid, H, W)
    assert launches(rz) == {**n0, "zbuffer_brute": n0["zbuffer_brute"] + 1}
    if split:
        keys = torch.full((3 * H * W,), 7, dtype=torch.int32, device=dev)
        rz.brute_launch(coef, valid, keys, keys[2 * H * W:], H, W, split)
        assert torch.equal(keys[2 * H * W:], got)
    assert torch.equal(got, want)
    assert torch.equal(got, rz.zbuffer_select_tiled(coef, valid, sx, sy, H, W))
    assert rz.brute_ctas(H, W, F, split) == rz.brute_plan(H, W, F, split)[2]


def test_zbuffer_brute_kernel_takes_unaligned_coefficients(dev):
    """#15 on coefficients 4 bytes past a 16-byte boundary (its 4-byte
    staging copies): the plain version's winners."""
    import torch_zbuffer_scenes as zs

    from avatarclip_torch.ops import raster_zbuffer as rz

    H, W = 200, 136
    coef, valid, _, _ = (torch.from_numpy(x).to(dev) for x in zs.scene("nan", H, W))
    buf = torch.empty(coef.numel() + 1, device=dev)
    shifted = buf[1:].view(coef.shape)
    shifted.copy_(coef)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(rz.zbuffer_select(shifted, valid, H, W), rz.zbuffer_select_plain(coef, valid, H, W))


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

    n0 = launches(fc)
    ok, gk = hold.net_grads(fc.color_apply_fused, color, ins, cots)
    assert launches(fc) == {"color_fwd": n0["color_fwd"] + 1, "color_bwd": n0["color_bwd"] + 1}
    ref = copy.deepcopy(color).double()
    ins64 = [t.double() for t in ins]
    orf, grf = hold.net_grads(fc.color_apply_plain, ref, ins64, [c.double() for c in cots])
    assert max(hold.rel_errors(ok, orf)) <= 1e-4
    n_p = len(grf) - 4
    grf[n_p:], _ = hold.resolve_relu_ties(ref, ins64, cots[0].double(), gk[n_p:], grf[n_p:])
    assert max(hold.rel_errors(gk, grf)) <= 1e-3


def _bf16_nets(dev, seed=0):
    """3x128 / 1x128 nets (extra head, no weight norm) at the confs' bf16
    operand mode, and 64 rays x 32 samples."""
    from avatarclip_torch.fields import networks as nets

    g = torch.Generator().manual_seed(seed)
    fields = nets.NeuSFields(
        nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), weight_norm=False,
                       dtype="bfloat16"),
        nets.ColorConfig(d_feature=128, d_hidden=128, n_layers=1, extra_color=True,
                         weight_norm=False, dtype="bfloat16"), 0.3, g)
    with torch.no_grad():
        for p in fields.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    R, S = 64, 32
    ro = torch.tensor([[0.0, 0.0, -2.2]]).expand(R, 3) + 0.1 * torch.randn(R, 3, generator=g)
    rd = torch.tensor([[0.0, 0.0, 1.0]]) + 0.05 * torch.randn(R, 3, generator=g)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.linspace(1.2, 3.2, S)[None] + 0.01 * torch.rand(R, S, generator=g))[0]
    dt = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 2.0 / S)], -1)
    return fields.to(dev), [t.to(dev) for t in (ro, rd, z + dt * 0.5, dt)]


@pytest.mark.parametrize("kernel", ["B1", "B3", "B6", "B7", "sdf_only"])
def test_bf16_operand_mode_holds_against_the_f32_function(dev, kernel):
    """Each NeuS kernel at the bf16 operand mode (B1: the tensor-core pair)
    against its plain bf16 version, both held to the f32 function in
    float64: outputs and every gradient within ops/hold.bf16_within (twice
    the plain version's relative RMS error plus a floor)."""
    from avatarclip_torch.ops import fused_color as fc
    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    fields, ins = _bf16_nets(dev)
    f64 = hold.f32_copy(fields).double()
    if kernel in ("B1", "B3"):
        kernel_fn, plain_fn = ((fn.point_eval_ray, fn.point_eval_ray_plain) if kernel == "B1"
                               else (fn.point_eval, fn.point_eval_plain))
        used = (0, 1, 2, 3) if kernel == "B1" else (0, 1, 2, 3, 4, 6)

        def run(f, flds, xs_in):
            xs = [t.clone().requires_grad_(True) for t in xs_in]
            outs = f(flds.sdf, flds.color, *xs, flds.variance.inv_s(), 0.4)
            outs = [outs[i] for i in used[:-1]] + [fn.eik_ratio(outs[used[-1]])]
            loss = sum(((o * o).sum() if o.dim() else o) for o in outs)
            return outs + list(torch.autograd.grad(loss, list(flds.parameters()) + xs))

        before = launches(fn)["neus_ray_fwd" if kernel == "B1" else "neus_point_fwd"]
        got = run(kernel_fn, fields, ins)
        assert launches(fn)["neus_ray_fwd" if kernel == "B1" else "neus_point_fwd"] == before + 1
        plain = run(plain_fn, fields, ins)
        ref = run(plain_fn, f64, [t.double() for t in ins])
    else:
        ro, rd, mid, _ = ins
        pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3).contiguous()
        g = torch.Generator().manual_seed(3)
        if kernel == "B7":
            with torch.no_grad():
                _, feat, grad = fields.sdf.sdf_with_gradient(pts)
            net, fused, plain_fn = fields.color, fc.color_apply_fused, fc.color_apply_plain
            n = grad / (grad.norm(dim=-1, keepdim=True) + 1e-6)
            dirs = rd[:, None].expand(-1, mid.shape[1], -1).reshape(-1, 3).contiguous()
            xs, cots = [pts, n.contiguous(), dirs, feat.contiguous()], [torch.rand(len(pts), 6, generator=g)]
        else:
            net = fields.sdf
            fused, plain_fn = ((fs.sdf_with_gradient_fused, fs.sdf_with_gradient_plain) if kernel == "B6"
                               else (fs.sdf_value_fused, fs.sdf_only_plain))
            widths = (1, 128, 3) if kernel == "B6" else (1,)
            xs, cots = [pts], [torch.rand(len(pts), k, generator=g) for k in widths]
        cots = [c.to(dev) for c in cots]
        ok, gk = hold.net_grads(fused, net, xs, cots)
        op, gp = hold.net_grads(plain_fn, net, xs, cots)
        orf, grf = hold.net_grads(plain_fn, hold.f32_copy(net).double(), [t.double() for t in xs],
                                  [c.double() for c in cots])
        got, plain, ref = ok + gk, op + gp, orf + grf
    for i, (a, p, r) in enumerate(zip(got, plain, ref)):
        ek, ep, ok_ = hold.bf16_within(a, p, r)
        assert ok_, (kernel, i, ek, ep)


def _neus_fields(width: int, n_rays: int, dev, dtype: str, seed: int, S: int = 64):
    """Nets of the conf's shapes (4x256 / 2x256, or 3x128 / 1x128; extra
    head, no weight norm, perturbed) at ``dtype``, and n_rays rays of S
    samples through the unit sphere."""
    from avatarclip_torch.fields import networks as nets

    g = torch.Generator().manual_seed(seed)
    n_layers, c_layers = (4, 2) if width == 256 else (3, 1)
    fields = nets.NeuSFields(
        nets.SDFConfig(d_out=width + 1, d_hidden=width, n_layers=n_layers, skip_in=(n_layers,),
                       weight_norm=False, dtype=dtype),
        nets.ColorConfig(d_feature=width, d_hidden=width, n_layers=c_layers, extra_color=True,
                         weight_norm=False, dtype=dtype), 0.3, g)
    with torch.no_grad():
        for p in fields.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    eye = torch.tensor([0.0, 0.2, 2.2])
    rd = 0.5 * (torch.rand(n_rays, 3, generator=g) - 0.5) - eye
    rd = rd / rd.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.linspace(1.2, 3.2, S)[None] + 0.02 * torch.rand(n_rays, S, generator=g))[0]
    dt = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n_rays, 1), 2.0 / 32)], -1)
    ins = [eye.expand(n_rays, 3).clone(), rd, z + dt * 0.5, dt]
    return fields.to(dev), [t.to(dev) for t in ins]


def test_b1_tensor_core_backward_is_deterministic(dev):
    """B1's tensor-core backward, twice on the same inputs at the train_clip
    step's 12,544 rays x 64 samples (4x256 / 2x256): every gradient the same
    bits (the column sums and the weight-gradient partial rows in a fixed
    order, no atomics)."""
    from avatarclip_torch.ops import fused_neus as fn

    R = 12544
    fields, ins = _neus_fields(256, R, dev, "bfloat16", seed=21)
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
    with torch.no_grad():
        weights = fn.dense_weights(fields.sdf, fields.color)
        flat = torch.cat([w.reshape(-1) for w in weights])
        pk, pack = fn.pack_tc(spec, weights)
        inv_s = fields.variance.inv_s().reshape(()).float().contiguous()
    args = (flat, pk, pack, *ins, inv_s, 0.4)
    res = fn.neus_ray_tc_fwd(spec, *args)
    g = torch.Generator().manual_seed(4)
    cots = [torch.randn(R, k, generator=g).to(dev) for k in (spec.rgb_width, 3, 1)]
    cots.append(torch.tensor([0.5, 0.0], device=dev))
    first = fn.neus_ray_tc_bwd(spec, *args, res[3], res[4], *cots)
    second = fn.neus_ray_tc_bwd(spec, *args, res[3], res[4], *cots)
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


@pytest.mark.parametrize("width,n_rays", [(256, 2048), (256, 2045), (128, 2048), (128, 2045)])
def test_b3_tensor_core_forward_holds_at_bf16(dev, width, n_rays):
    """B3's forward in the bf16 operand mode (the tensor-core kernel) under
    no_grad, as the validation renders run it: sdf, grad, rgb, alpha, cdf and
    the eikonal term against the f32 function in float64, beside the plain
    bf16 version (ops/hold.bf16_within); inside exactly but at the sphere."""
    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import hold

    fields, ins = _neus_fields(width, n_rays, dev, "bfloat16", seed=7)
    f64 = hold.f32_copy(fields).double()
    n0 = launches(fn)["neus_point_fwd"]
    with torch.no_grad():
        got = fn.point_eval(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
        assert launches(fn)["neus_point_fwd"] == n0 + 1
        plain = fn.point_eval_plain(fields.sdf, fields.color, *ins, fields.variance.inv_s(), 0.4)
        ref = fn.point_eval_plain(f64.sdf, f64.color, *[t.double() for t in ins],
                                  f64.variance.inv_s(), 0.4)
    for i in (0, 1, 2, 3, 4, 6):
        pick = fn.eik_ratio if i == 6 else (lambda t: t)
        ek, ep, ok = hold.bf16_within(pick(got[i]), pick(plain[i]).detach(), pick(ref[i]).detach())
        assert ok, (i, ek, ep)
    # inside: exact but at points within rounding of |x|^2 = 1
    ro, rd, mid = (t.double() for t in ins[:3])
    r2 = ((ro[:, None] + rd[:, None] * mid[..., None]) ** 2).sum(-1).reshape(-1)
    assert ((r2[got[5] != ref[5].float()] - 1.0).abs() < 1e-5).all()


def test_b6_tensor_core_backward_holds_at_bf16(dev):
    """B6's backward in the bf16 operand mode (the tensor-core kernel, the
    weight gradients a GEMM over the points) at 4x256 on a ragged 131,071
    points: d(points) and every weight gradient, with cotangents on sdf,
    feature and gradient, against the f32 function in float64 beside the
    plain bf16 version (ops/hold.bf16_within)."""
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    fields, (ro, rd, mid, _) = _neus_fields(256, 2048, dev, "bfloat16", seed=8)
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3)[:-1].contiguous()
    P = pts.shape[0]
    g = torch.Generator().manual_seed(9)
    cots = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, 256, 3)]
    n0 = launches(fs)
    ok, gk = hold.net_grads(fs.sdf_with_gradient_fused, fields.sdf, [pts], cots)
    assert launches(fs) == {**n0, "sdf_fwd": n0["sdf_fwd"] + 1, "sdf_bwd": n0["sdf_bwd"] + 1}
    op, gp = hold.net_grads(fs.sdf_with_gradient_plain, fields.sdf, [pts], cots)
    orf, grf = hold.net_grads(fs.sdf_with_gradient_plain, hold.f32_copy(fields.sdf).double(),
                              [pts.double()], [c.double() for c in cots])
    for i, (a, p, r) in enumerate(zip(ok + gk, op + gp, orf + grf)):
        ek, ep, ok_ = hold.bf16_within(a, p, r)
        assert ok_, (i, ek, ep)


@pytest.mark.parametrize("width", [256, 128])
def test_b6_tensor_core_forward_holds_at_bf16(dev, width):
    """B6's forward in the bf16 operand mode (the tensor-core kernel) under
    no_grad on a ragged 131,071 points: sdf, feature and gradient each
    against the f32 function in float64 beside the plain bf16 version
    (ops/hold.bf16_within)."""
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    fields, (ro, rd, mid, _) = _neus_fields(width, 2048, dev, "bfloat16", seed=10)
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3)[:-1].contiguous()
    n0 = launches(fs)
    with torch.no_grad():
        got = fs.sdf_with_gradient_fused(fields.sdf, pts)
    assert launches(fs) == {**n0, "sdf_fwd": n0["sdf_fwd"] + 1}
    plain = [t.detach() for t in fs.sdf_with_gradient_plain(fields.sdf, pts)]
    ref = [t.detach() for t in fs.sdf_with_gradient_plain(hold.f32_copy(fields.sdf).double(),
                                                          pts.double())]
    for name, a, p, r in zip(("sdf", "feature", "gradient"), got, plain, ref):
        ek, ep, ok = hold.bf16_within(a, p, r)
        assert ok, (name, ek, ep)


@pytest.mark.parametrize("width,mode,extra", [(256, "no_view_dir", True), (256, "idr", False),
                                              (128, "no_view_dir", True), (128, "idr", False)])
def test_b7_tensor_core_backward_holds_at_bf16(dev, width, mode, extra):
    """B7's backward in the bf16 operand mode (the tensor-core kernel, the
    weight gradients a GEMM over the points) on a ragged 32,767 points at
    the path's inputs (the SDF net's points, unit normals and feature, the
    rays' directions): the output, every weight gradient and the four input
    cotangents against the f32 function in float64 beside the plain bf16
    version (ops/hold.bf16_within)."""
    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_color as fc
    from avatarclip_torch.ops import hold

    fields, (ro, rd, mid, _) = _neus_fields(width, 512, dev, "bfloat16", seed=11)
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3)
    dirs = rd[:, None].expand(-1, mid.shape[1], -1).reshape(-1, 3)
    with torch.no_grad():
        _, feat, grad = fields.sdf.sdf_with_gradient(pts)
    normals = grad / (grad.norm(dim=-1, keepdim=True) + 1e-6)
    P = pts.shape[0] - 1
    ins = [t[:P].contiguous() for t in (pts, normals, dirs, feat)]
    g = torch.Generator().manual_seed(12)
    net = nets.ColorNetwork(nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6,
                                             d_feature=width, d_hidden=width,
                                             n_layers=2 if width == 256 else 1, extra_color=extra,
                                             weight_norm=False, dtype="bfloat16"), g)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    net = net.to(dev)
    cots = [(0.5 + torch.rand(P, 6 if extra else 3, generator=g)).to(dev)]
    n0 = launches(fc)
    ok, gk = hold.net_grads(fc.color_apply_fused, net, ins, cots)
    assert launches(fc) == {"color_fwd": n0["color_fwd"] + 1, "color_bwd": n0["color_bwd"] + 1}
    op, gp = hold.net_grads(fc.color_apply_plain, net, ins, cots)
    orf, grf = hold.net_grads(fc.color_apply_plain, hold.f32_copy(net).double(),
                              [t.double() for t in ins], [c.double() for c in cots])
    names = ["rgb"] + [n for n, _ in net.named_parameters()] + ["points", "normals", "view_dirs",
                                                                "features"]
    for name, a, p, r in zip(names, ok + gk, op + gp, orf + grf):
        ek, ep, ok_ = hold.bf16_within(a, p, r)
        assert ok_, (name, ek, ep)


@pytest.mark.parametrize("width,mode,extra", [(256, "no_view_dir", True), (256, "idr", False),
                                              (128, "no_view_dir", True), (128, "idr", False)])
def test_b7_tensor_core_forward_holds_at_bf16(dev, width, mode, extra):
    """B7's forward in the bf16 operand mode (the tensor-core kernel, its
    feature streamed by bulk copies) under no_grad on a ragged 32,767 points
    at the path's inputs: the rgb against the f32 function in float64
    beside the plain bf16 version (ops/hold.bf16_within), one forward launch
    and no backward; two launches give the same bits."""
    from avatarclip_torch.fields import networks as nets
    from avatarclip_torch.ops import fused_color as fc
    from avatarclip_torch.ops import hold

    fields, (ro, rd, mid, _) = _neus_fields(width, 512, dev, "bfloat16", seed=13)
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3)
    dirs = rd[:, None].expand(-1, mid.shape[1], -1).reshape(-1, 3)
    with torch.no_grad():
        _, feat, grad = fields.sdf.sdf_with_gradient(pts)
    normals = grad / (grad.norm(dim=-1, keepdim=True) + 1e-6)
    P = pts.shape[0] - 1
    ins = [t[:P].contiguous() for t in (pts, normals, dirs, feat)]
    g = torch.Generator().manual_seed(14)
    net = nets.ColorNetwork(nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6,
                                             d_feature=width, d_hidden=width,
                                             n_layers=2 if width == 256 else 1, extra_color=extra,
                                             weight_norm=False, dtype="bfloat16"), g)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    net = net.to(dev)
    n0 = launches(fc)
    with torch.no_grad():
        got = fc.color_apply_fused(net, *ins)
        again = fc.color_apply_fused(net, *ins)
        plain = fc.color_apply_plain(net, *ins)
        ref = fc.color_apply_plain(hold.f32_copy(net).double(), *[t.double() for t in ins])
    assert launches(fc) == {"color_fwd": n0["color_fwd"] + 2, "color_bwd": n0["color_bwd"]}
    assert got.shape == (P, 6 if extra else 3) and torch.equal(got, again)
    ek, ep, ok = hold.bf16_within(got, plain, ref)
    assert ok, (ek, ep)


@pytest.mark.parametrize("W,R,S", [(6, 301, 64), (3, 301, 64), (6, 77, 37), (3, 19, 1)])
def test_composite_forward_holds_at_any_alignment(dev, W, R, S):
    """B4's forward (its rays' rows staged through shared memory by 16-byte
    copies) under no_grad on inputs that start 0 to 3 floats past a 16-byte
    boundary, a ragged ray count, S below 64 and W 6 and 3, against the
    plain version in float64: each output to 1e-5 of its largest magnitude,
    one launch each."""
    from avatarclip_torch.ops import fused_composite as fc

    g = torch.Generator().manual_seed(R + S + W)
    shapes = ((R, S), (R, S, W), (R, S, 3))
    for shift in ((0, 0, 0), (1, 2, 3), (3, 1, 2)):
        ins = []
        for shape, k in zip(shapes, shift):
            n = int(np.prod(shape))
            buf = torch.rand(n + k, generator=g).to(dev)
            ins.append(buf[k:].view(shape))  # contiguous, k floats into its buffer
        ins[0] = ins[0].mul_(0.3)
        ins[0][::5, S // 2] = 1.0  # opaque samples
        assert [t.data_ptr() % 16 // 4 for t in ins] == list(shift)
        n0 = launches(fc)["composite_fwd"]
        with torch.no_grad():
            got = fc.composite(*ins)
        assert launches(fc)["composite_fwd"] == n0 + 1
        ref = fc.composite_plain(*[t.double() for t in ins])
        for a, b in zip(got, ref):
            assert (a.double() - b).abs().max() <= 1e-5 * max(float(b.abs().max()), 1e-6)
        if W == 3:
            assert not got[2].any()


@pytest.mark.parametrize("width", [256, 128])
def test_sdf_only_tensor_core_forward_holds_at_bf16(dev, width):
    """#12 in the bf16 operand mode (the tensor-core kernel) through its
    entry on a ragged 20,001 points: the sdf and its VJP (autograd of the
    plain version) against the f32 function in float64 beside the plain
    bf16 version (ops/hold.bf16_within), one launch; after an in-place
    change of the weights the next call computes with the new ones (the
    weights are packed each call)."""
    from avatarclip_torch.ops import fused_sdf as fs
    from avatarclip_torch.ops import hold

    fields, (ro, rd, mid, _) = _neus_fields(width, 320, dev, "bfloat16", seed=15)
    sdf = fields.sdf
    pts = (ro[:, None] + rd[:, None] * mid[..., None]).reshape(-1, 3)[:20001].contiguous()
    cots = [torch.rand(pts.shape[0], 1, generator=torch.Generator().manual_seed(16)).to(dev)]
    for step in range(2):
        n0 = launches(fs)
        ok, gk = hold.net_grads(fs.sdf_value_fused, sdf, [pts], cots)
        assert launches(fs) == {**n0, "sdf_only_fwd": n0["sdf_only_fwd"] + 1}
        op, gp = hold.net_grads(fs.sdf_only_plain, sdf, [pts], cots)
        orf, grf = hold.net_grads(fs.sdf_only_plain, hold.f32_copy(sdf).double(), [pts.double()],
                                  [cots[0].double()])
        for i, (a, p, r) in enumerate(zip(ok + gk, op + gp, orf + grf)):
            ek, ep, good = hold.bf16_within(a, p, r)
            assert good, (step, i, ek, ep)
        with torch.no_grad():
            sdf.layers[1].w.mul_(1.5)


@pytest.mark.parametrize("width,n_rays,S", [(256, 1201, 64), (128, 1201, 64), (256, 301, 37),
                                            (128, 77, 8), (256, 40, 1)])
def test_b3_tensor_core_backward_holds_at_bf16(dev, width, n_rays, S):
    """#5, B3's backward in the bf16 operand mode (the tensor-core kernel,
    rays in chunks: 1,201 rays run in two), through point_eval with a
    cotangent on every output, at S 64 and below (37, the 8 of the dry
    run's kernel check, 1): every parameter's and input's gradient against
    the f32 function in float64 beside the plain bf16 version
    (ops/hold.bf16_within), one launch of each kernel; two backwards give
    the same bits."""
    from avatarclip_torch.ops import fused_neus as fn
    from avatarclip_torch.ops import hold

    fields, ins = _neus_fields(width, n_rays, dev, "bfloat16", seed=21, S=S)
    g = torch.Generator().manual_seed(22)
    P = n_rays * S
    probes = [(0.5 + torch.rand(P, k, generator=g)).to(dev) for k in (1, 3, 6)]
    probes += [(0.5 + torch.rand(P, generator=g)).to(dev) for _ in range(2)] + [1.3]

    def grads(f, flds, xs_in):
        xs = [t.clone().requires_grad_(True) for t in xs_in]
        outs = f(flds.sdf, flds.color, *xs, flds.variance.inv_s(), 0.4)
        used = [outs[i] for i in (0, 1, 2, 3, 4)] + [fn.eik_ratio(outs[6])]
        loss = sum((o * p).sum() for o, p in zip(used, probes))
        return list(torch.autograd.grad(loss, list(flds.parameters()) + xs))

    n0 = launches(fn)
    got = grads(fn.point_eval, fields, ins)
    assert launches(fn)["neus_point_bwd"] == n0["neus_point_bwd"] + 1
    assert all(torch.equal(a, b) for a, b in zip(got, grads(fn.point_eval, fields, ins)))
    plain = grads(fn.point_eval_plain, fields, ins)
    probes = [p.double() if torch.is_tensor(p) else p for p in probes]
    ref = grads(fn.point_eval_plain, hold.f32_copy(fields).double(), [t.double() for t in ins])
    for i, (a, p, r) in enumerate(zip(got, plain, ref)):
        ek, ep, ok = hold.bf16_within(a, p, r)
        assert ok, (i, ek, ep)


@pytest.mark.parametrize("W,R,S", [(6, 301, 64), (3, 301, 64), (6, 77, 37), (3, 19, 1)])
def test_composite_backward_holds_at_any_alignment(dev, W, R, S):
    """#7, B4's backward (rays staged through shared memory, d rgb and d
    grad written back by 16-byte stores), on inputs and cotangents that start
    0 to 3 floats past a 16-byte boundary, a ragged ray count, S below 64,
    W 6 and 3, against the plain version's VJP in float64 (each gradient to
    1e-5 of its largest magnitude); the C entry onto outputs at another
    offset gives the wrapper's bits."""
    from avatarclip_torch.ops import _build
    from avatarclip_torch.ops import fused_composite as fc

    g = torch.Generator().manual_seed(R + S + W + 7)

    def at(shape, k):
        n = int(np.prod(shape))
        return torch.rand(n + k, generator=g).to(dev)[k:].view(shape)

    for shift in (0, 1, 2, 3):
        ins = [at(s, (shift + i) % 4) for i, s in enumerate(((R, S), (R, S, W), (R, S, 3)))]
        ins[0] = ins[0].mul_(0.3)
        ins[0][::5, S // 2] = 1.0  # opaque samples
        cots = [at(s, (shift + i) % 4) for i, s in enumerate(((R, S), (R, 3), (R, 3), (R, 3)))]
        n0 = launches(fc)["composite_bwd"]
        got = fc.composite_bwd(*ins, *cots)
        assert launches(fc)["composite_bwd"] == n0 + 1
        xs = [t.double().requires_grad_(True) for t in ins]
        ref = torch.autograd.grad(sum((o * c.double()).sum() for o, c in
                                      zip(fc.composite_plain(*xs), cots)), xs)
        for a, b in zip(got, ref):
            assert (a.double() - b).abs().max() <= 1e-5 * max(float(b.abs().max()), 1e-6)
        outs = [at(t.shape, (shift + 1) % 4).fill_(float("nan")) for t in got]
        p = _build.ptr
        _build.check(fc._lib().composite_bwd(R, S, W, *[p(t) for t in ins + cots],
                                             *[p(t) for t in outs], _build.stream_ptr(dev)),
                     "composite_bwd launch")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, outs))


# ---------------------------------------------------------------------------
# CLIP's image tower replayed from CUDA graphs (clip/model.encode_image_graphed)
# ---------------------------------------------------------------------------

_CLIP_COUNTERS = ("clip_graph_eager", "clip_graph_capture", "clip_graph_replay")


def _clip_counts() -> dict:
    from avatarclip_torch.utils import trace

    c = trace.counters()
    return {k: c.get(k, 0) for k in _CLIP_COUNTERS}


def _vit_b32_visual(dev, dtype):
    """ViT-B/32's image tower from a seeded draw (the text tower dropped)."""
    import dataclasses

    from avatarclip_torch.clip import model as clip_model

    cfg = dataclasses.replace(clip_model.VIT_B32, compute_dtype=dtype, vocab_size=8, text_layers=0)
    params = clip_model.init_params(cfg, torch.Generator().manual_seed(7))
    return cfg, {"visual": clip_model.tree_to(params["visual"], dev)}


def _clip_eager(params, cfg, img, gy):
    from avatarclip_torch.clip import model as clip_model

    x = img.clone().requires_grad_(True)
    y = clip_model.encode_image(params, cfg, clip_model.normalize_image(x))
    return y.detach(), torch.autograd.grad(y, x, gy)[0]


def _clip_graphed(params, cfg, img, gy, **grad_kw):
    from avatarclip_torch.clip import model as clip_model

    x = img.clone().requires_grad_(True)
    y = clip_model.encode_image_graphed(params, cfg, x)
    return y.detach(), torch.autograd.grad(y, x, gy, **grad_kw)[0]


@pytest.mark.parametrize("dtype,n", [("float32", 5), ("bfloat16", 2)])
def test_clip_graph_matches_eager_bit_for_bit(dev, dtype, n):
    """At ViT-B/32's widths, (n, 224, 224, 3) images as the pose (f32, 5
    views) and sculpting (bf16, 2 images) steps give them: two eager calls,
    one capture, then replays, each with fresh images and output gradient,
    give the eager tower's output and input gradient bit for bit."""
    cfg, params = _vit_b32_visual(dev, dtype)
    gen = torch.Generator().manual_seed(11)
    c0 = _clip_counts()
    for k in range(8):
        img = torch.rand(n, 224, 224, 3, generator=gen).to(dev)
        gy = torch.randn(n, cfg.embed_dim, generator=gen).to(dev)
        got_y, got_g = _clip_graphed(params, cfg, img, gy)
        want_y, want_g = _clip_eager(params, cfg, img, gy)
        assert torch.equal(got_y, want_y), (k, float((got_y - want_y).abs().max()))
        assert torch.equal(got_g, want_g), (k, float((got_g - want_g).abs().max()))
        c = {key: v - c0[key] for key, v in _clip_counts().items()}
        assert c == {"clip_graph_eager": min(k + 1, 2), "clip_graph_capture": int(k >= 2),
                     "clip_graph_replay": max(k - 2, 0)}, (k, c)


def test_clip_graph_pending_replay_and_stale_backward(dev):
    """Two forwards then two backwards of one key: the second forward runs
    eager (its graph's replay still pending), both gradients right. A
    backward whose activations a later replay overwrote, or that an earlier
    backward spent, raises."""
    cfg, params = _vit_b32_visual(dev, "float32")
    from avatarclip_torch.clip import model as clip_model

    gen = torch.Generator().manual_seed(12)
    imgs = [torch.rand(5, 224, 224, 3, generator=gen).to(dev) for _ in range(3)]
    gy = torch.randn(5, cfg.embed_dim, generator=gen).to(dev)
    for _ in range(3):  # eager, eager, capture
        _clip_graphed(params, cfg, imgs[0], gy)
    c0 = _clip_counts()
    x1, x2 = (imgs[i].clone().requires_grad_(True) for i in (1, 2))
    y1 = clip_model.encode_image_graphed(params, cfg, x1)
    y2 = clip_model.encode_image_graphed(params, cfg, x2)
    c = {key: v - c0[key] for key, v in _clip_counts().items()}
    assert c == {"clip_graph_eager": 1, "clip_graph_capture": 0, "clip_graph_replay": 1}
    (g2,) = torch.autograd.grad(y2, x2, gy)
    (g1,) = torch.autograd.grad(y1, x1, gy, retain_graph=True)
    for y, g, img in ((y1, g1, imgs[1]), (y2, g2, imgs[2])):
        want_y, want_g = _clip_eager(params, cfg, img, gy)
        assert torch.equal(y.detach(), want_y) and torch.equal(g, want_g)
    with pytest.raises(RuntimeError, match="spent"):
        torch.autograd.grad(y1, x1, gy, retain_graph=True)
    x3 = imgs[0].clone().requires_grad_(True)
    y3 = clip_model.encode_image_graphed(params, cfg, x3)
    (g3,) = torch.autograd.grad(y3, x3, gy, retain_graph=True)
    clip_model.encode_image_graphed(params, cfg, imgs[1].clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="overwritten"):
        torch.autograd.grad(y3, x3, gy)
    assert torch.equal(g3, _clip_eager(params, cfg, imgs[0], gy)[1])


def test_clip_graph_bypasses_no_grad_and_trainable_weights(dev):
    """No grad mode, images without grad, or a tower weight that requires
    grad: the eager ops, no counter moved."""
    cfg, params = _vit_b32_visual(dev, "float32")
    from avatarclip_torch.clip import model as clip_model

    img = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(13)).to(dev)
    want = clip_model.encode_image(params, cfg, clip_model.normalize_image(img))
    c0 = _clip_counts()
    with torch.no_grad():
        assert torch.equal(clip_model.encode_image_graphed(params, cfg, img.requires_grad_(True)), want)
    img = img.detach()
    assert torch.equal(clip_model.encode_image_graphed(params, cfg, img), want)
    params["visual"]["proj"].requires_grad_(True)
    try:
        for _ in range(4):
            y = clip_model.encode_image_graphed(params, cfg, img.clone().requires_grad_(True))
            assert torch.equal(y.detach(), want) and y.grad_fn is not None
    finally:
        params["visual"]["proj"].requires_grad_(False)
    assert _clip_counts() == c0


def test_pose_step_graphed_equals_eager(dev):
    """One PoseOptimizer step at ViT-B/32 in float32 on 5 views, CLIP
    replayed after its warm-up, against the same step with CLIP eager (the
    weights under a new key): the same loss and pose gradient, bit for bit."""
    from avatarclip_torch.clip import model as clip_model
    from avatarclip_torch.pipelines import animate

    ctx = animate.AnimateContext(clip_size="tiny", render_res=64, device=dev)
    ctx.clip_cfg, ctx.clip_params = _vit_b32_visual(dev, "float32")
    text = torch.randn(ctx.clip_cfg.embed_dim, generator=torch.Generator().manual_seed(14)).to(dev)
    g = animate.PoseOptimizer(ctx=ctx, seed=3, num_iteration=100)
    var = g.draw_init().to(dev).requires_grad_(True)
    opt = g.make_optimizer(var)
    for _ in range(3):  # eager, eager, capture
        g.step(var, opt, text, g.draw_step())
    v0, s0, draws = var.detach().clone(), {k: dict(v) for k, v in opt.state.items()}, g.draw_step()

    def step():
        with torch.no_grad():
            var.copy_(v0)
        opt.state.clear()
        opt.state.update({k: {n: t.clone() for n, t in v.items()} for k, v in s0.items()})
        loss = g.step(var, opt, text, draws)
        return loss, var.grad.clone(), var.detach().clone()

    c0 = _clip_counts()
    graphed = step()
    assert _clip_counts()["clip_graph_replay"] == c0["clip_graph_replay"] + 1
    ctx.clip_params = dict(ctx.clip_params)  # a new key: its first call is eager
    eager = step()
    assert _clip_counts()["clip_graph_eager"] == c0["clip_graph_eager"] + 1
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)


def test_sculpt_step_graphed_equals_eager(dev, tmp_path):
    """One train_clip step of a tiny Runner on the card, CLIP replayed after
    its warm-up, against the same step with CLIP eager (the weights under a
    new key): the same loss and every parameter gradient, bit for bit."""
    from avatarclip_torch.pipelines import synthetic

    r = synthetic.make_runner(str(tmp_path), "tiny", res=32, device=dev)
    r.init_clip()
    r.init_smpl()
    for _ in range(3):  # eager, eager, capture
        cam, S = r.sample_iteration_camera(r.iter_step)
        r._clip_update(S, cam, r.iter_step)
        r.iter_step += 1
    it = r.iter_step
    cam, S = r.sample_iteration_camera(it)
    w0 = {k: v.detach().clone() for k, v in r.fields.state_dict().items()}
    g0 = r.gen.get_state()

    def step():
        r.fields.load_state_dict(w0)
        r.gen.set_state(g0)
        loss, _ = r.clip_loss(S, cam, r.draw_clip(S), it)
        r._backward(loss)
        return loss.detach(), {n: p.grad.clone() for n, p in r.fields.named_parameters()
                               if p.grad is not None}

    c0 = _clip_counts()
    loss_g, grads_g = step()
    assert _clip_counts()["clip_graph_replay"] == c0["clip_graph_replay"] + 1
    params, cfg = r._clip
    r._clip = (dict(params), cfg)  # a new key: its first call is eager
    loss_e, grads_e = step()
    assert _clip_counts()["clip_graph_eager"] == c0["clip_graph_eager"] + 1
    assert torch.equal(loss_g, loss_e)
    assert grads_g.keys() == grads_e.keys() and grads_g
    for n in grads_g:
        assert torch.equal(grads_g[n], grads_e[n]), n


# ---------------------------------------------------------------------------
# the motion decoder replayed from CUDA graphs (utils/graphs.py through
# pipelines/animate.MotionOptimizer.decode_6d)
# ---------------------------------------------------------------------------

_MOTION_COUNTERS = ("motion_graph_eager", "motion_graph_capture", "motion_graph_replay")


def _motion_counts() -> dict:
    from avatarclip_torch.utils import trace

    c = trace.counters()
    return {k: c.get(k, 0) for k in _MOTION_COUNTERS}


def test_motion_decoder_graph_matches_eager_bit_for_bit(dev):
    """At the published widths (60 frames, latent 256, 4 layers of 4
    heads), the decoder and the rotation chain (the motion and its 6d):
    two eager calls, one capture, then replays, each with a fresh latent
    and output gradients, give the eager function's outputs and latent
    gradient bit for bit; CPU and no-grad calls move no counter."""
    from avatarclip_torch.pipelines import animate

    ctx = animate.AnimateContext(clip_size="tiny", render_res=64, device=dev)
    m = animate.MotionOptimizer(ctx=ctx, seed=3)
    assert (m.cfg.seq_len, m.cfg.latent_dim, m.cfg.num_layers, m.cfg.num_heads) == (60, 256, 4, 4)
    gen = torch.Generator().manual_seed(21)
    c0 = _motion_counts()
    for k in range(8):
        lat = torch.randn(256, generator=gen).to(dev)
        gys = (torch.randn(60, 63, generator=gen).to(dev), torch.randn(60, 21, 6, generator=gen).to(dev))
        x1, x2 = lat.clone().requires_grad_(True), lat.clone().requires_grad_(True)
        got = m.decode_6d(x1)
        want = m._decode_6d(x2)
        for a, b in zip(got, want):
            assert torch.equal(a.detach(), b.detach()), (k, float((a - b).abs().max()))
        (g1,), (g2,) = torch.autograd.grad(got, x1, gys), torch.autograd.grad(want, x2, gys)
        assert torch.equal(g1, g2), (k, float((g1 - g2).abs().max()))
        c = {key: v - c0[key] for key, v in _motion_counts().items()}
        assert c == {"motion_graph_eager": min(k + 1, 2), "motion_graph_capture": int(k >= 2),
                     "motion_graph_replay": max(k - 2, 0)}, (k, c)
    c1 = _motion_counts()
    with torch.no_grad():
        assert torch.equal(m.decode(lat), m._decode_6d(lat)[0])
    assert _motion_counts() == c1


def test_motion_step_matches_the_reference(dev):
    """The motion cell's checked steps at the published widths on the card
    (after the driver's throwaway steps warm up and capture the decoder's
    graphs, every checked step replays them), against the plain float32
    reference (benchmark/reference/motion.py), within the cell's limits."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.harness import registry

    wl = registry.workload("motion-optimizer.adam")
    d = registry.driver(wl["driver"])(registry.config(wl["config"]), wl, 2**31 + 41, dev, {})
    d.setup()
    c0 = _motion_counts()
    d.first_steps()
    c = {key: v - c0[key] for key, v in _motion_counts().items()}
    assert c == {"motion_graph_eager": 2, "motion_graph_capture": 1,
                 "motion_graph_replay": int(wl["traffic"]["checked_steps"])}, c
    d.release()
    checks = d.check()
    assert all(v["value"] <= v["limit"] for v in checks.values()), checks
