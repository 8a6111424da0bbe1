"""The port's standalone SDF pair (B6, ops/fused_sdf.py) against the JAX
package's (avatarclip_tpu/ops/fused_sdf.py).

``sdf_with_gradient_plain`` (the kernel pair's plain version, which the CPU
runs) against JAX's ``sdf_with_gradient_fused``, whose Pallas kernels run in
interpret mode with f32 dot operands, at 128 wide, 3 layers and 200 points
(ragged against the 256-point Pallas block): sdf, feature and gradient to
1e-4, and the VJP with cotangents on all three into every parameter (g, v,
b) and the points to 1e-3, each relative to the largest magnitude of what it
is held against (the two sum in different orders). Also: the kernel family
and the kernels' weight layout, the renderer's gate on the CPU, and that the
CUDA entry raises on a CPU tensor."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_sdf as jfs
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.ops import fused_sdf as tfs
from avatarclip_torch.utils.convert import params_from_jax

OUT_TOL, GRAD_TOL = 1e-4, 1e-3
KW = dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6)


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-6)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


@pytest.fixture(scope="module")
def nets():
    cfg = jnets.SDFConfig(**KW)
    params = jnets.sdf_init(jax.random.PRNGKey(3), cfg)
    # perturb the geometric init so every layer and the PE columns matter
    leaves, tree = jax.tree_util.tree_flatten(params)
    g = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.05 * g.normal(size=x.shape).astype(np.float32) for x in leaves])
    sdf = params_from_jax(tree_flatten_paths(params), tnets.SDFNetwork(tnets.SDFConfig(**KW)))
    pts = (0.6 * g.normal(size=(200, 3))).astype(np.float32)
    cots = [g.normal(size=s).astype(np.float32) for s in ((200, 1), (200, 128), (200, 3))]
    return cfg, params, sdf, pts, cots


def test_plain_matches_pallas_pair(nets, monkeypatch):
    cfg, params, sdf, pts, cots = nets
    monkeypatch.setattr(jfs, "_OPERAND_DTYPE", jnp.float32)

    def jloss(p, x):
        outs = jfs.sdf_with_gradient_fused(p, cfg, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    touts = tfs.sdf_with_gradient_plain(sdf, x)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots)).backward()
    for nm, a, b in zip(("sdf", "feature", "gradient"), touts, jouts):
        _close(a.detach(), b, OUT_TOL, nm)
    named = dict(sdf.named_parameters())
    flat = tree_flatten_paths(jgp)
    assert len(flat) == len(named) == 3 * 4
    for path, gj in flat.items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    _close(x.grad, jgx, GRAD_TOL, "points")


@pytest.mark.parametrize("kw,takes", [
    (KW, True),
    (dict(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6), True),
    (dict(d_hidden=100, n_layers=4, skip_in=(4,)), False),
    (dict(d_hidden=256, n_layers=4, skip_in=(2,)), False),
    (dict(d_hidden=256, multires=0), False),
])
def test_spec_family_matches_jax(kw, takes):
    spec = tfs.spec_from_config(tnets.SDFConfig(**kw))
    assert (spec is not None) == takes == (jfs.spec_from_config(jnets.SDFConfig(**kw)) is not None)
    if takes:
        d = spec.dims()
        assert (d.E, d.H, d.NH, d.SW, d.F) == (39, kw["d_hidden"], kw["n_layers"] - 1,
                                              kw["d_hidden"] - 39, kw["d_out"] - 1)


def test_dense_weights_are_the_module_layers(nets):
    """The flat buffer the kernels read: layer by layer (W (out, in), b),
    weight norm resolved, differentiable back to g and v."""
    _, _, sdf, _, _ = nets
    ws = tfs.dense_weights(sdf)
    assert len(ws) == 2 * len(sdf.layers)
    for i, layer in enumerate(sdf.layers):
        torch.testing.assert_close(ws[2 * i], layer.g * layer.v / layer.v.norm(dim=1, keepdim=True))
        assert ws[2 * i + 1] is layer.b or torch.equal(ws[2 * i + 1], layer.b)
    sum(w.sum() for w in ws).backward()
    assert all(p.grad is not None for p in sdf.parameters())
    sdf.zero_grad(set_to_none=True)


def test_gate_takes_the_plain_module_on_the_cpu():
    sdf = tnets.SDFNetwork(tnets.SDFConfig(), torch.Generator().manual_seed(0))
    pts = torch.randn(70, 3, generator=torch.Generator().manual_seed(1))
    got = tnets.sdf_with_gradient(sdf, pts)
    want = sdf.sdf_with_gradient(pts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    n0 = dict(tfs.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfs.sdf_with_gradient_fused(sdf, pts)
    assert tfs.LAUNCHES == n0
