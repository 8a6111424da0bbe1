"""B8 on the CPU: the port's sdf-only forward (ops/fused_sdf.py) and its
brute-force z-buffer (ops/raster_zbuffer.py) against the JAX package.

``sdf_only_plain`` (the sdf-only kernel's plain version) against JAX's
``_dense_sdf_only`` and its Pallas ``_sdf_only_core`` in interpret mode (both
with f32 dot operands) and against ``sdf_apply(sdf_only=True)``, at 128 wide
on 200 points, to 1e-5 of the largest magnitude; its VJP (the sdf-only
Function's backward) into every parameter and the points to 1e-5. The
``_SWEEP_KERNEL`` hook on a CPU tensor takes the plain module, and the
renderer's sweeps and ``validate_mesh``'s grid query go through
``networks.sdf_value``. ``zbuffer_select_plain`` against JAX's brute-force
``zbuffer_select(interpret=True)``: face ids equal but for near-ties."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_sdf as jfs
from avatarclip_tpu.ops import raster_zbuffer as jrz
from avatarclip_tpu.render import raster as jraster
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.ops import fused_sdf as tfs
from avatarclip_torch.ops import raster_zbuffer as trz
from avatarclip_torch.render import raster as traster
from avatarclip_torch.utils import trace
from avatarclip_torch.utils.convert import params_from_jax
from test_torch_raster import _assert_same_winners, _pose

TOL = 1e-5
KW = dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6)


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


@pytest.fixture(scope="module")
def nets():
    cfg = jnets.SDFConfig(**KW)
    params = jnets.sdf_init(jax.random.PRNGKey(5), cfg)
    leaves, tree = jax.tree_util.tree_flatten(params)
    g = np.random.default_rng(1)
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.05 * g.normal(size=x.shape).astype(np.float32) for x in leaves])
    sdf = params_from_jax(tree_flatten_paths(params), tnets.SDFNetwork(tnets.SDFConfig(**KW)))
    pts = (0.6 * g.normal(size=(200, 3))).astype(np.float32)
    return cfg, params, sdf, pts


@pytest.mark.parametrize("ref", ["dense_sdf_only", "pallas_interpret", "sdf_apply"])
def test_sdf_only_plain_matches_jax(nets, monkeypatch, ref):
    cfg, params, sdf, pts = nets
    monkeypatch.setattr(jfs, "_OPERAND_DTYPE", jnp.float32)
    spec = jfs.spec_from_config(cfg)
    if ref == "dense_sdf_only":
        want = jfs._dense_sdf_only(jfs.dense_weights(params, spec), jnp.asarray(pts), spec)
    elif ref == "pallas_interpret":  # the TPU kernel itself, on a block-aligned copy
        pad = (-len(pts)) % jfs._sdf_only_block()
        xp = jnp.concatenate([jnp.asarray(pts), jnp.zeros((pad, 3), jnp.float32)])
        want = jfs._sdf_only_core(jfs.dense_weights(params, spec), xp, spec)[:len(pts)]
    else:
        want = jnets.sdf_apply(params, cfg, jnp.asarray(pts), sdf_only=True)[:, :1]
    got = tfs.sdf_only_plain(sdf, torch.from_numpy(pts))
    assert got.shape == (200, 1)
    _close(got.detach(), want, TOL, ref)


def test_sdf_only_vjp_matches_jax(nets, monkeypatch):
    """The sdf-only Function's backward is autograd of sdf_only_plain: its
    VJP into g, v, b of every layer and the points, against JAX's VJP of
    sdf_apply(sdf_only=True); and the Function itself (its launch replaced
    by the plain forward, the kernel having no CPU mode) hands the same
    gradients to every parameter and the points."""
    cfg, params, sdf, pts = nets
    cot = np.random.default_rng(2).normal(size=(200, 1)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jnets.sdf_apply(p, cfg, x, sdf_only=True)[:, :1] * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    (tfs.sdf_only_plain(sdf, x) * torch.from_numpy(cot)).sum().backward()
    named = dict(sdf.named_parameters())
    for path, gj in tree_flatten_paths(jgp).items():
        got = named[path.replace("/", ".")].grad
        _close(np.zeros(gj.shape) if got is None else got, gj, TOL, path)
    _close(x.grad, jgx, TOL, "points")
    want = {n: p.grad.clone() for n, p in named.items()}
    sdf.zero_grad(set_to_none=True)
    monkeypatch.setattr(tfs, "sdf_only_fwd", lambda spec, flat, p: tfs.sdf_only_plain(sdf, p).detach())
    x2 = torch.from_numpy(pts).requires_grad_(True)
    out = tfs.SDFOnlyFunction.apply(tfs.spec_from_config(sdf.cfg), sdf, x2, *sdf.parameters())
    (out * torch.from_numpy(cot)).sum().backward()
    for n, p in named.items():
        torch.testing.assert_close(p.grad, want[n], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(x2.grad, x.grad, rtol=1e-6, atol=1e-7)
    sdf.zero_grad(set_to_none=True)


def test_sweep_hook_on_a_cpu_tensor_is_the_module(nets, monkeypatch):
    _, _, sdf, pts = nets
    x = torch.from_numpy(pts)
    n0 = trace.launches()
    assert tnets._SWEEP_KERNEL is False  # the JAX package's default
    for hook in (False, True):
        monkeypatch.setattr(tnets, "_SWEEP_KERNEL", hook)
        torch.testing.assert_close(tnets.sdf_value(sdf, x), sdf.sdf(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tfs.sdf_value_fused(sdf, x)
    assert trace.launches() == n0


def test_sdf_only_queries_go_through_sdf_value(tmp_path, monkeypatch):
    """The renderer's up-sample sweeps (1 + up_sample_steps - 1 calls a
    render) and validate_mesh's grid (one call a chunk, before the colour
    bake's renders and their sweeps) query networks.sdf_value."""
    from avatarclip_torch.pipelines import synthetic
    from avatarclip_torch.render import neus

    calls = []
    real = tnets.sdf_value
    monkeypatch.setattr(tnets, "sdf_value", lambda sdf, p: calls.append(p.shape[0]) or real(sdf, p))
    f = tnets.NeuSFields(tnets.SDFConfig(d_out=17, d_hidden=16, n_layers=2, multires=2),
                         tnets.ColorConfig(d_feature=16, d_hidden=16, n_layers=1), 0.3,
                         torch.Generator().manual_seed(0))
    ro = torch.tensor([[0.0, 0.0, 2.0]]).expand(5, 3)
    rd = torch.nn.functional.normalize(torch.tensor([[0.05, 0.0, -1.0]]).expand(5, 3), dim=-1)
    neus.render(f, neus.NeuSConfig(n_samples=8, n_importance=12, up_sample_steps=3), ro, rd,
                torch.ones(5, 1), 3 * torch.ones(5, 1), per_ray=True)
    assert calls == [5 * 8, 5 * 4, 5 * 4]
    calls.clear()
    r = synthetic.make_runner(str(tmp_path), "tiny", device="cpu")
    r.validate_mesh(resolution=16)
    assert calls[0] == 16 ** 3 and len(calls) > 1


@pytest.mark.parametrize("H,W", [(50, 70), (40, 33)])
def test_zbuffer_select_plain_matches_pallas_interpret(H, W):
    g = np.random.default_rng(H * W)
    v = g.normal(0.0, 0.4, (300, 3)).astype(np.float32)
    v[:10, 2] += 3.0  # some vertices behind the camera
    f = g.integers(0, 300, (1100, 3)).astype(np.int32)  # a ragged second face block
    proj = jraster.project_vertices(jnp.asarray(v), jnp.asarray(_pose()), H, W, 60.0)
    coef, valid, _ = jraster._face_coefficients(proj, jnp.asarray(f))
    py, px = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    pix = np.stack([px.ravel(), py.ravel(), np.ones(H * W, np.float32)], -1)
    want = np.asarray(jrz.zbuffer_select(jnp.asarray(pix), coef, valid, interpret=True))
    tproj = traster.project_vertices(torch.from_numpy(v), torch.from_numpy(_pose()), H, W, 60.0)
    tcoef, tvalid, _ = traster._face_coefficients(tproj, torch.from_numpy(f).long())
    n0 = trace.launches()
    got = trz.zbuffer_select(tcoef, tvalid, H, W).numpy()  # a CPU tensor: the plain version
    assert trace.launches() == n0
    assert (want >= 0).sum() > 500
    assert _assert_same_winners(got, want, coef, W) <= 5
