"""The port's plain modules at ``cfg.dtype = "bfloat16"`` (every conf's
operand type) against the JAX package's XLA path at the same dtype: the
port's ``SDFNetwork`` against ``fields/networks.sdf_apply`` and its
``ColorNetwork`` against ``color_apply``, parameters moved by
``params_from_jax``, on 20,000 seeded points, at the confs' 4×256 SDF
(geometric init) with the 2×256 colour net and its extra head, and at 3×128
(uniform init).

Both sides round each dot's operands to bf16, sum in f32 and keep the hidden
activations in bf16; they differ only where an f32 sum taken in another order
lands on the other side of a bf16 rounding boundary and an activation flips
by one ulp. Tolerances, as relative RMS (the norm of the difference over the
norm of JAX's tensor):

* outputs (sdf, feature, the sdf-only value, rgb with the extra head):
  FWD_TOL = 2e-3 (measured: 4.5e-4 on the 4×256 sdf and feature, 8.4e-5 at
  3×128, 1.6e-6 on rgb);
* the VJP of a seeded cotangent into the inputs and every parameter:
  GRAD_TOL = 2e-2 and, per tensor, no farther from JAX's bf16 VJP than JAX's
  bf16 VJP lies from its own f32 VJP. The hidden layers' weight gradients
  differ by up to 8.7e-3 at 4×256 (the inputs' by 7.4e-4): each is a sum
  over 20,000 points of terms of random sign, so the ulp flips of the
  activations and of the bf16 cotangents do not cancel as the sum does, and
  each side lies 0.3–8% from its f32 gradient (the rounding of the mode
  itself); the port lies nearer to JAX's bf16 gradient than that at every
  tensor. JAX's side runs jitted, as its training step runs it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.utils.convert import params_from_jax

FWD_TOL, GRAD_TOL = 2e-3, 2e-2
P = 20_000
SDF_KW = {
    "4x256": dict(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6,
                  geometric_init=True),
    "3x128": dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6,
                  geometric_init=False),
}
COL_KW = {
    "4x256": dict(d_feature=256, d_hidden=256, n_layers=2, extra_color=True),
    "3x128": dict(d_feature=128, d_hidden=128, n_layers=3, extra_color=True),
}


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)


def _hold_grads(port_grads: dict, jax_bf16: dict, jax_f32: dict):
    """Each parameter's (and input's) gradient: within GRAD_TOL of JAX's bf16
    VJP, and no farther from it than JAX's bf16 VJP is from its f32 one (with
    a floor of 1e-5 where the two coincide, as for a head's bias)."""
    assert port_grads.keys() == jax_bf16.keys()
    for name, gj in jax_bf16.items():
        err = _rel_rms(port_grads[name], gj)
        own = _rel_rms(gj, jax_f32[name])
        assert err <= GRAD_TOL and err <= max(own, 1e-5), (name, err, own)


def _vjp(fn, params, args, cot):
    """fn's outputs and its VJP of ``cot`` into (params, *args), jitted (op
    by op, JAX's bf16 VJP takes seconds to dispatch)."""
    def run(p, xs, c):
        out, vjp = jax.vjp(fn, p, *xs)
        return out, vjp(c)

    return jax.jit(run)(params, list(map(jnp.asarray, args)), jnp.asarray(cot))


@pytest.mark.parametrize("size", sorted(SDF_KW))
def test_sdf_network_matches_sdf_apply_at_bf16(size):
    kw = SDF_KW[size]
    params = jax.jit(jnets.sdf_init, static_argnums=1)(jax.random.PRNGKey(0), jnets.SDFConfig(**kw))
    net = params_from_jax(tree_flatten_paths({"sdf": params}),
                          tnets.SDFNetwork(tnets.SDFConfig(dtype="bfloat16", **kw)),
                          prefix="sdf/")
    g = np.random.default_rng(1)
    pts = (0.6 * g.normal(size=(P, 3))).astype(np.float32)
    cot = g.normal(size=(P, kw["d_out"])).astype(np.float32)
    grads = {}
    for dt in ("bfloat16", "float32"):
        cfg = jnets.SDFConfig(dtype=dt, **kw)
        out, (gp, gx) = _vjp(lambda p, x: jnets.sdf_apply(p, cfg, x), params, [pts], cot)
        grads[dt] = {**tree_flatten_paths(gp), "points": gx}
        if dt == "bfloat16":
            jout = np.asarray(out)
            jonly = np.asarray(jax.jit(lambda p, x: jnets.sdf_apply(p, cfg, x, sdf_only=True))(
                params, jnp.asarray(pts)))

    x = torch.from_numpy(pts).requires_grad_(True)
    tout = net(x)
    (tout * torch.from_numpy(cot)).sum().backward()
    tout = tout.detach().numpy()
    assert tout.dtype == np.float32
    for name, a, b in (("sdf", tout[:, :1], jout[:, :1]), ("feature", tout[:, 1:], jout[:, 1:]),
                       ("sdf_only", net.sdf(torch.from_numpy(pts)).detach(), jonly[:, :1])):
        assert _rel_rms(a, b) <= FWD_TOL, (name, _rel_rms(a, b))
    port = {k.replace(".", "/"): p.grad for k, p in net.named_parameters()}
    _hold_grads({**port, "points": x.grad}, grads["bfloat16"], grads["float32"])


@pytest.mark.parametrize("size", sorted(COL_KW))
def test_color_network_matches_color_apply_at_bf16(size):
    kw = COL_KW[size]
    params = jax.jit(jnets.color_init, static_argnums=1)(jax.random.PRNGKey(2),
                                                         jnets.ColorConfig(**kw))
    net = params_from_jax(tree_flatten_paths({"color": params}),
                          tnets.ColorNetwork(tnets.ColorConfig(dtype="bfloat16", **kw)),
                          prefix="color/")
    g = np.random.default_rng(3)
    nrm = g.normal(size=(P, 3))
    ins = [g.uniform(-1, 1, (P, 3)), nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
           g.normal(size=(P, 3)), g.normal(size=(P, kw["d_feature"]))]
    ins = [a.astype(np.float32) for a in ins]
    cot = g.normal(size=(P, 6)).astype(np.float32)
    names = ("points", "normals", "view_dirs", "features")
    grads = {}
    for dt in ("bfloat16", "float32"):
        cfg = jnets.ColorConfig(dtype=dt, **kw)
        out, (gp, *gin) = _vjp(lambda p, *xs: jnets.color_apply(p, cfg, *xs), params, ins, cot)
        grads[dt] = {**tree_flatten_paths(gp), **dict(zip(names, gin))}
        if dt == "bfloat16":
            jout = np.asarray(out)

    xs = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    tout = net(*xs)
    (tout * torch.from_numpy(cot)).sum().backward()
    assert tout.shape == (P, 6)
    assert _rel_rms(tout.detach(), jout) <= FWD_TOL, _rel_rms(tout.detach(), jout)
    port = {k.replace(".", "/"): p.grad for k, p in net.named_parameters()}
    # no_view_dir reads no view direction: its gradient is zero on both sides
    assert xs[2].grad is None and not np.asarray(grads["bfloat16"]["view_dirs"]).any()
    port.update((n, x.grad) for n, x in zip(names, xs) if x.grad is not None)
    grads = {dt: {k: v for k, v in gs.items() if k != "view_dirs"} for dt, gs in grads.items()}
    _hold_grads(port, grads["bfloat16"], grads["float32"])
