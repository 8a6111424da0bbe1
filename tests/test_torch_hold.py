"""The float64 references that hold a kernel pair against its plain version
(avatarclip_torch/ops/hold.py), on the CPU at a small width: chunked
evaluation equals one pass, a dense copy computes what weight norm does, and
the relu near-tie resolution explains a flipped near-tie unit exactly (to
1e-12 relative) while it leaves an error away from a near-tie in place."""

import pytest
import torch

from avatarclip_torch.fields import networks as nets
from avatarclip_torch.ops import fused_color as fc
from avatarclip_torch.ops import fused_sdf as fs
from avatarclip_torch.ops import hold


def _colour(mode: str):
    g = torch.Generator().manual_seed(0)
    net = nets.ColorNetwork(nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6, d_feature=16,
                                             d_hidden=32, n_layers=2, extra_color=True), g).double()
    P = 50
    ins = [torch.randn(P, 3, generator=g, dtype=torch.float64) for _ in range(3)]
    ins.append(torch.randn(P, 16, generator=g, dtype=torch.float64))
    cot = 0.5 + torch.rand(P, 6, generator=g, dtype=torch.float64)
    return net, ins, cot


def test_chunked_grads_equal_one_pass():
    g = torch.Generator().manual_seed(1)
    sdf = nets.SDFNetwork(nets.SDFConfig(d_out=17, d_hidden=64, n_layers=3, skip_in=(3,)), g).double()
    pts = 0.5 * torch.randn(37, 3, generator=g, dtype=torch.float64)
    cots = [torch.randn(37, k, generator=g, dtype=torch.float64) for k in (1, 16, 3)]
    o1, g1 = hold.net_grads(fs.sdf_with_gradient_plain, sdf, [pts], cots)
    o2, g2 = hold.net_grads(fs.sdf_with_gradient_plain, sdf, [pts], cots, chunk=10)
    assert len(g1) == len(list(sdf.parameters())) + 1
    assert max(hold.rel_errors(o2, o1) + hold.rel_errors(g2, g1)) <= 1e-12
    o3 = hold.net_outputs(fs.sdf_with_gradient_plain, sdf, [pts], chunk=10)
    assert max(hold.rel_errors(o3, o1)) <= 1e-12


def test_dense_copy_matches_weight_norm():
    net, ins, cot = _colour("no_view_dir")
    dense = hold.dense_copy(net)
    assert not dense.cfg.weight_norm and all("w" in n or "b" in n for n, _ in dense.named_parameters())
    (a,), ga = hold.net_grads(fc.color_apply_plain, net, ins, [cot])
    (b,), gb = hold.net_grads(fc.color_apply_plain, dense, ins, [cot])
    assert float((a - b).abs().max()) <= 1e-12
    # the input cotangents do not depend on how the weights are parametrised
    assert max(hold.rel_errors(gb[-4:], ga[-4:])) <= 1e-12
    # view directions are not read in no_view_dir: zeros, not None
    assert float(gb[-2].abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["idr", "no_view_dir"])
def test_resolve_relu_ties_explains_a_flipped_unit(mode):
    net, ins, cot = _colour(mode)
    # put unit 5 of the second relu layer of point 7 on a near-tie
    with torch.no_grad():
        _, zs, mags = hold._colour_forward(net, [t[7:8] for t in ins])
        net.layers[1].b[5] -= zs[1][0, 5] - 1e-9 * mags[1][0, 5]
    _, g = hold.net_grads(fc.color_apply_plain, net, ins, [cot])
    ref = g[-4:]
    flips = [torch.zeros(ins[0].shape[0], 32, dtype=torch.bool) for _ in range(2)]
    flips[1][7, 5] = True
    xs = [t.clone().requires_grad_(True) for t in ins]
    out, _, _ = hold._colour_forward(net, xs, flips)
    got = [torch.zeros_like(x) if d is None else d
           for x, d in zip(xs, torch.autograd.grad((out * cot).sum(), xs, allow_unused=True))]
    # a flipped near-tie unit moves that point's input cotangents
    assert max(hold.rel_errors(got, ref)) > 1e-3
    resolved, rep = hold.resolve_relu_ties(net, ins, cot, got, ref, chunk=16)
    assert max(hold.rel_errors(got, resolved)) <= 1e-12
    assert rep["near_tie_points"] >= 1 and rep["taken_the_other_way"] == 1
    assert rep["worst_point_units_flipped"] == 1
    # an error away from a near-tie stays visible
    got[0] = got[0].clone()
    got[0][20] += 0.01 * ref[0].abs().max()
    resolved, _ = hold.resolve_relu_ties(net, ins, cot, got, ref)
    assert hold.rel_errors(got, resolved)[0] >= 0.009


def _fields(dtype: str = "float32"):
    g = torch.Generator().manual_seed(2)
    s_cfg = nets.SDFConfig(d_out=17, d_hidden=32, n_layers=3, skip_in=(3,), multires=2,
                           weight_norm=False, dtype=dtype)
    c_cfg = nets.ColorConfig(d_feature=16, d_hidden=32, n_layers=1, extra_color=True,
                             weight_norm=False, dtype=dtype)
    return nets.NeuSFields(s_cfg, c_cfg, 0.3, g), g


def test_ray_grads_chunked_equal_one_pass():
    """The chunked per-ray reference (the eikonal mean weighted by each
    chunk's points in the relaxed sphere) sums to one pass's outputs and
    gradients."""
    from avatarclip_torch.ops import fused_neus as fn

    fields, g = _fields()
    fields = fields.double()
    R, S = 11, 8
    rays_o = torch.tensor([0.0, 0.1, 1.6], dtype=torch.float64).expand(R, 3).clone()
    rays_d = torch.nn.functional.normalize(0.3 * torch.randn(R, 3, generator=g, dtype=torch.float64)
                                           - rays_o, dim=-1)
    mid = torch.sort(0.8 + 1.6 * torch.rand(R, S, generator=g, dtype=torch.float64), -1)[0]
    dists = torch.full((R, S), 0.2, dtype=torch.float64)
    probes = [0.5 + torch.rand(R, k, generator=g, dtype=torch.float64) for k in (6, 3, 1)]
    probes.append(torch.tensor(0.7, dtype=torch.float64))
    ins = [rays_o, rays_d, mid, dists]
    o1, g1 = hold.ray_grads(fn.point_eval_ray_plain, fields, ins, probes)
    o2, g2 = hold.ray_grads(fn.point_eval_ray_plain, fields, ins, probes, chunk=4)
    assert len(g1) == len(list(fields.parameters())) + 4
    assert 0.0 < float(o1[3]) and float(g1[-2].abs().max()) > 0.0
    assert max(hold.rel_errors(o2, o1) + hold.rel_errors(g2, g1)) <= 1e-12


def test_per_ray_hold_catches_one_wrong_ray():
    """Noise at the plain version's level passes the worst-ray hold; the same
    with one ray's values off by 30% fails it, while the relative RMS over
    the 12,544 rays barely moves."""
    g = torch.Generator().manual_seed(3)
    ref = torch.rand(12544, 6, generator=g, dtype=torch.float64)
    plain = ref * (1 + 4e-3 * torch.randn(ref.shape, generator=g, dtype=torch.float64))
    got = ref * (1 + 4e-3 * torch.randn(ref.shape, generator=g, dtype=torch.float64))
    assert hold.per_ray_within(got, plain, ref)[2]
    bad = got.clone()
    bad[777] *= 1.3
    ek, ep, ok = hold.per_ray_within(bad, plain, ref)
    assert not ok and ek > 0.25 > 4 * ep
    assert hold.bf16_within(bad, plain, ref)[2]  # the RMS alone would pass it


def test_f32_copy_computes_the_f32_function():
    """An f32 copy of bf16 nets: the copy's configs say float32, the
    original's are untouched, and its plain pass is the f32 nets' pass."""
    from avatarclip_torch.ops import fused_neus as fn

    f16, _ = _fields("bfloat16")
    f32, _ = _fields("float32")
    copy32 = hold.f32_copy(f16)
    assert copy32.sdf.cfg.dtype == "float32" and copy32.color.cfg.dtype == "float32"
    assert f16.sdf.cfg.dtype == "bfloat16" and nets.operand_bf16(f16.color.cfg)
    pts = 0.5 * torch.randn(40, 3, generator=torch.Generator().manual_seed(4))
    dirs = torch.nn.functional.normalize(torch.randn(40, 3), dim=-1)
    with torch.no_grad():
        a = torch.cat(fn._fields_plain(copy32.sdf, copy32.color, pts, dirs), -1)
        b = torch.cat(fn._fields_plain(f32.sdf, f32.color, pts, dirs), -1)
        c = torch.cat(fn._fields_plain(f16.sdf, f16.color, pts, dirs), -1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((c - b).abs().max()) > 1e-5  # the bf16 nets round their operands
