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
