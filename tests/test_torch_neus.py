"""Parity of the port's NeuS renderer and the megakernel's plain version with
the JAX package.

* ``point_eval_ray_plain`` vs ``point_eval_fused_ray`` (the Pallas per-ray
  kernel pair, interpret mode, f32 operands, one-device mesh) at 128 wide:
  outputs to 1e-4 and every gradient to 1e-3, relative to the largest
  magnitude (the summation order differs).
* ``render_core(per_ray=True)`` and ``render`` vs the JAX XLA path with
  perturb = 0, same tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_neus as jfn
from avatarclip_tpu.ops import fused_sdf
from avatarclip_tpu.render import neus as jneus
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.ops import fused_neus as tfn
from avatarclip_torch.render import neus as tneus
from avatarclip_torch.utils.convert import params_from_jax

OUT_TOL, GRAD_TOL = 1e-4, 1e-3


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


def _setup(width, seed=0, R=4, S=16):
    if width == 128:
        skw = dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6)
        ckw = dict(d_feature=128, d_hidden=128, n_layers=1, extra_color=True)
    else:
        skw = dict(d_out=33, d_hidden=32, n_layers=2, skip_in=(2,), multires=2)
        ckw = dict(d_feature=32, d_hidden=32, n_layers=2, extra_color=True)
    jcfgs = jneus.NetConfigs(sdf=jnets.SDFConfig(**skw), color=jnets.ColorConfig(**ckw))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"sdf": jnets.sdf_init(k1, jcfgs.sdf), "color": jnets.color_init(k2, jcfgs.color),
              "variance": jnets.variance_init(0.3)}
    fields = params_from_jax(tree_flatten_paths(params), tnets.NeuSFields(
        tnets.SDFConfig(**skw), tnets.ColorConfig(**ckw), 0.3))
    g = np.random.default_rng(seed + 5)
    rays_o = (np.array([[0.0, 0.0, -2.2]]) + 0.1 * g.normal(size=(R, 3))).astype(np.float32)
    rays_d = np.array([[0.0, 0.0, 1.0]]) + 0.05 * g.normal(size=(R, 3))
    rays_d = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32)
    z = (np.linspace(1.2, 3.2, S)[None] + 0.01 * g.uniform(size=(R, S))).astype(np.float32)
    return jcfgs, params, fields, rays_o, rays_d, z


@pytest.fixture
def one_device_f32(monkeypatch):
    """The Pallas kernels on one CPU device with f32 dot operands."""
    from jax.sharding import Mesh

    from avatarclip_tpu.parallel import mesh as pmesh

    monkeypatch.setattr(fused_sdf, "_OPERAND_DTYPE", jnp.float32)
    pmesh.set_default_mesh(Mesh(np.array(jax.devices()[:1]), ("data",)))
    yield
    pmesh.set_default_mesh(None)


def test_plain_matches_pallas_per_ray_kernel(one_device_f32):
    jcfgs, params, fields, ro, rd, z = _setup(128)
    R, S = z.shape
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 2.0 / S, np.float32)], -1)
    mid = z + dists * 0.5
    g = np.random.default_rng(9)
    probes = [g.normal(size=s).astype(np.float32) for s in ((R, 6), (R, 3), (R, 1))] + [1.7]
    cos_r = 0.3

    def jloss(p, inv_s, ro_, rd_, mz, dt):
        col, nw, ws, ge = jfn.point_eval_fused_ray(p["sdf"], jcfgs.sdf, p["color"], jcfgs.color,
                                                   ro_, rd_, mz, dt, inv_s, cos_r)
        loss = (col * probes[0]).sum() + (nw * probes[1]).sum() + (ws * probes[2]).sum() + ge * probes[3]
        return loss, (col, nw, ws, ge)

    inv_s = jnp.exp(jnp.asarray(0.3) * 10.0)
    args = [jnp.asarray(a) for a in (ro, rd, mid, dists)]
    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
        {"sdf": params["sdf"], "color": params["color"]}, inv_s, *args)

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (ro, rd, mid, dists)]
    tinv = torch.tensor(float(inv_s), requires_grad=True)
    touts = tfn.point_eval_ray_plain(fields.sdf, fields.color, *ins, tinv, cos_r)
    touts = (*touts[:3], tfn.eik_ratio(touts[3]))
    loss = sum((o * torch.from_numpy(p)).sum() for o, p in zip(touts[:3], probes[:3]))
    loss = loss + touts[3] * probes[3]
    loss.backward()
    for nm, a, b in zip(("colorW", "normals_w", "weight_sum", "gradient_error"), touts, jouts):
        _close(a.detach(), b, OUT_TOL, nm)
    flat = tree_flatten_paths(jgrads[0])
    named = dict(fields.named_parameters())
    for path, gj in flat.items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    _close(tinv.grad, jgrads[1], GRAD_TOL, "inv_s")
    for nm, t, gj in zip(("rays_o", "rays_d", "mid_z", "dists"), ins, jgrads[2:]):
        _close(t.grad, gj, GRAD_TOL, nm)


def _cfg(extra=True):
    return dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0, extra_color=extra)


@pytest.mark.parametrize("width", [32, 128])
def test_render_core_per_ray_matches_xla_path(width):
    jcfgs, params, fields, ro, rd, z = _setup(width, seed=1)
    R, S = z.shape
    core = jax.jit(lambda p, *a: jneus.render_core(p, jneus.NeuSConfig(**_cfg()), jcfgs, *a,
                                                   sample_dist=0.25, cos_anneal_ratio=0.3))
    jout = core(params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z))
    tneus._FORCE_MEGA = True
    try:
        tout = tneus.render_core(fields, tneus.NeuSConfig(**_cfg()), torch.from_numpy(ro),
                                 torch.from_numpy(rd), torch.from_numpy(z), 0.25,
                                 cos_anneal_ratio=0.3, per_ray=True)
    finally:
        tneus._FORCE_MEGA = None
    assert tout["weights"] is None and tout["sdf"] is None
    w = np.asarray(jout["weights"])
    _close(tout["color"].detach(), jout["color"], OUT_TOL, "color")
    _close(tout["extra_color"].detach(), jout["extra_color"], OUT_TOL, "extra")
    _close(tout["weight_sum"].detach()[:, 0], w.sum(-1), OUT_TOL, "weight_sum")
    _close(tout["normals_weighted"].detach(),
           (np.asarray(jout["gradients"]) * w[..., None]).sum(1), OUT_TOL, "normals")
    _close(tout["gradient_error"].detach(), jout["gradient_error"], OUT_TOL, "eikonal")
    # the plain per-sample path keeps the full contract
    tfull = tneus.render_core(fields, tneus.NeuSConfig(**_cfg()), torch.from_numpy(ro),
                              torch.from_numpy(rd), torch.from_numpy(z), 0.25,
                              cos_anneal_ratio=0.3)
    for k in ("sdf", "gradients", "weights", "cdf", "inside_sphere"):
        _close(tfull[k].detach(), jout[k], OUT_TOL, k)


def test_render_hierarchical_matches_jax():
    jcfgs, params, fields, ro, rd, _ = _setup(32, seed=2, R=6)
    near, far = np.full((6, 1), 1.2, np.float32), np.full((6, 1), 3.2, np.float32)
    render = jax.jit(lambda p, *a: jneus.render(p, jneus.NeuSConfig(**_cfg()), jcfgs, *a,
                                                cos_anneal_ratio=0.5))
    jout = render(params, *(jnp.asarray(a) for a in (ro, rd, near, far)))
    tout = tneus.render(fields, tneus.NeuSConfig(**_cfg()),
                        *(torch.from_numpy(a) for a in (ro, rd, near, far)), cos_anneal_ratio=0.5)
    for k in ("mid_z_vals", "color_fine", "extra_color_fine", "weight_sum", "weights"):
        _close(tout[k].detach(), jout[k], OUT_TOL, k)
