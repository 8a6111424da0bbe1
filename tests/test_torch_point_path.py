"""Parity of the validation path's kernels' plain versions with the JAX package.

* ``point_eval_plain`` vs ``point_eval_fused`` (the Pallas point-level kernel
  pair, interpret mode, f32 operands, one-device mesh) at 128 wide, and at a
  narrow width (32, which the Pallas kernels do not take) vs the JAX
  package's XLA composition of the same maths; every output but ``inside``
  carries a cotangent.
* ``composite_plain`` vs ``composite_fused`` (interpret) at rgb width 3 and
  6 with a ray count that is not a multiple of the TPU's 64-ray block.
* ``render_core(per_ray=False)`` with ``_FORCE_MEGA`` on both sides: every
  key, ``normals_weighted`` included.

Tolerances, relative to each tensor's largest magnitude: outputs 1e-4,
gradients 1e-3 (the summation order differs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_composite as jfc
from avatarclip_tpu.ops import fused_neus as jfn
from avatarclip_tpu.render import neus as jneus
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.ops import fused_composite as tfc
from avatarclip_torch.ops import fused_neus as tfn
from avatarclip_torch.render import neus as tneus
from test_torch_neus import _cfg, _close, _setup, one_device_f32  # noqa: F401  (fixture)

OUT_TOL, GRAD_TOL = 1e-4, 1e-3


def _xla_point_eval(sdf_p, sdf_cfg, col_p, col_cfg, ro, rd, mid, dists, inv_s, r):
    """The point-level maths from the JAX package's XLA pieces (networks +
    the kernel's own alpha chain and eikonal terms)."""
    R, S = mid.shape
    pts = (ro[:, None, :] + rd[:, None, :] * mid[..., None]).reshape(-1, 3)
    dirs = jnp.broadcast_to(rd[:, None, :], (R, S, 3)).reshape(-1, 3)
    sdf, feat, g = jnets.sdf_with_gradient(sdf_p, sdf_cfg, pts)
    rgb = jnets.color_eval(col_p, col_cfg, pts, g, dirs, feat)
    alpha, cdf = jfn._alpha_chain(sdf, g, dirs, dists.reshape(-1, 1), inv_s, r)
    r2 = jnp.sum(pts * pts, -1, keepdims=True)
    num, den = jfn._eik_terms(g, (r2 < 1.44).astype(jnp.float32))
    inside = (r2 < 1.0).astype(jnp.float32)[:, 0]
    return sdf, g, rgb, alpha[:, 0], cdf[:, 0], inside, num[0, 0] / (den[0, 0] + 1e-5)


@pytest.mark.parametrize("width", [32, 128])
def test_point_plain_matches_jax_point_kernel(one_device_f32, width):
    jcfgs, params, fields, ro, rd, z = _setup(width, seed=3, R=5, S=16)
    R, S = z.shape
    P = R * S
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 2.0 / S, np.float32)], -1)
    mid = z + dists * 0.5
    g = np.random.default_rng(11)
    probes = [g.normal(size=s).astype(np.float32) for s in ((P, 1), (P, 3), (P, 6), (P,), (P,))]
    probes.append(1.3)
    cos_r = 0.3
    jax_fn = jfn.point_eval_fused if width == 128 else _xla_point_eval

    def jloss(p, inv_s, ro_, rd_, mz, dt):
        outs = jax_fn(p["sdf"], jcfgs.sdf, p["color"], jcfgs.color, ro_, rd_, mz, dt, inv_s, cos_r)
        loss = sum((o * pr).sum() for o, pr in zip(outs[:5], probes[:5])) + outs[6] * probes[5]
        return loss, outs

    inv_s = jnp.exp(jnp.asarray(0.3) * 10.0)
    args = [jnp.asarray(a) for a in (ro, rd, mid, dists)]
    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
        {"sdf": params["sdf"], "color": params["color"]}, inv_s, *args)

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (ro, rd, mid, dists)]
    tinv = torch.tensor(float(inv_s), requires_grad=True)
    touts = tfn.point_eval_plain(fields.sdf, fields.color, *ins, tinv, cos_r)
    touts = (*touts[:6], tfn.eik_ratio(touts[6]))
    loss = sum((o * torch.from_numpy(p)).sum() for o, p in zip(touts[:5], probes[:5]))
    (loss + touts[6] * probes[5]).backward()
    for nm, a, b in zip(("sdf", "grad", "rgb", "alpha", "cdf", "inside", "gradient_error"),
                        touts, jouts):
        _close(a.detach().reshape(np.shape(b)), b, OUT_TOL, nm)
    named = dict(fields.named_parameters())
    for path, gj in tree_flatten_paths(jgrads[0]).items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    _close(tinv.grad, jgrads[1], GRAD_TOL, "inv_s")
    for nm, t, gj in zip(("rays_o", "rays_d", "mid_z", "dists"), ins, jgrads[2:]):
        _close(t.grad, gj, GRAD_TOL, nm)


@pytest.mark.parametrize("W", [3, 6])
def test_composite_plain_matches_jax_composite_kernel(W):
    g = np.random.default_rng(W)
    R, S = 70, 24
    alpha = (0.4 * g.uniform(size=(R, S))).astype(np.float32)
    alpha[0, 5] = 1.0
    rgb = g.uniform(size=(R, S, W)).astype(np.float32)
    grad = g.normal(size=(R, S, 3)).astype(np.float32)
    cots = [g.normal(size=(R, S)).astype(np.float32)] + [
        g.normal(size=(R, 3)).astype(np.float32) for _ in range(3)]

    def jloss(a, c, n):
        outs = jfc.composite_fused(a, c, n)
        return sum((o * k).sum() for o, k in zip(outs, cots)), outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(alpha), jnp.asarray(rgb), jnp.asarray(grad))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (alpha, rgb, grad)]
    touts = tfc.composite(*ins)
    sum((o * torch.from_numpy(k)).sum() for o, k in zip(touts, cots)).backward()
    for nm, a, b in zip(("weights", "color", "extra", "normals_w"), touts, jouts):
        _close(a.detach(), b, OUT_TOL, nm)
    for nm, t, gj in zip(("alpha", "rgb", "grad"), ins, jgrads):
        _close(t.grad, gj, GRAD_TOL, nm)


@pytest.mark.parametrize("width", [32, 128])
def test_render_core_point_path_matches_jax(one_device_f32, width, monkeypatch):
    jcfgs, params, fields, ro, rd, z = _setup(width, seed=4, R=5, S=16)
    monkeypatch.setattr(jneus, "_FORCE_MEGA", True)
    monkeypatch.setattr(tneus, "_FORCE_MEGA", True)
    bg = np.full((5, 3), 0.25, np.float32)
    jout = jneus.render_core(params, jneus.NeuSConfig(**_cfg()), jcfgs, jnp.asarray(ro),
                             jnp.asarray(rd), jnp.asarray(z), sample_dist=0.25,
                             background_rgb=jnp.asarray(bg), cos_anneal_ratio=0.3)
    with torch.no_grad():
        tout = tneus.render_core(fields, tneus.NeuSConfig(**_cfg()), torch.from_numpy(ro),
                                 torch.from_numpy(rd), torch.from_numpy(z), 0.25,
                                 background_rgb=torch.from_numpy(bg), cos_anneal_ratio=0.3)
    tout = {k: v.detach() for k, v in tout.items() if v is not None}
    w = np.asarray(jout["weights"])
    want_nw = jout.get("normals_weighted")
    if want_nw is None:  # the narrow net takes JAX's XLA path: the same sum
        want_nw = (np.asarray(jout["gradients"]) * w[..., None]).sum(1)
    _close(tout["normals_weighted"], want_nw, OUT_TOL, "normals_weighted")
    for k in ("color", "extra_color", "sdf", "dists", "gradients", "s_val", "mid_z_vals",
              "weights", "cdf", "gradient_error", "inside_sphere"):
        _close(tout[k], np.asarray(jout[k]).reshape(tuple(tout[k].shape)), OUT_TOL, k)
