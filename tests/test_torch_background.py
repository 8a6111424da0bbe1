"""The port's NeRF++ background path (fields.networks.NeRFNetwork,
render.neus.render_core_outside and ``render`` with ``n_outside > 0``)
against the JAX package, on the CPU.

* ``NeRFNetwork`` vs ``nerf_apply`` (with a skip that fires and with the
  confs' D 4 / skips [4], which never fires): alpha and rgb to 1e-4;
* ``render_core_outside`` vs JAX: alpha, sampled colour and weights to 1e-4;
* ``render`` with n_outside = 4 on the nets of
  tests/test_parity_extras.py's background test, no jitter, with and without
  the extra colour head: every key of the output to 1e-4, and the gradients
  of a loss on colour, extra colour, weight sum and the eikonal term into
  the sdf, colour, variance and NeRF parameters to 1e-3, each relative to
  the largest magnitude of what it is held against;
* the jitter order (inner samples first, then the outside ones, from the one
  generator), the megakernel gate closed by a background, and the error
  without a NeRF.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.render import neus as jneus
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.render import neus as tneus
from avatarclip_torch.utils.convert import params_from_jax

OUT_TOL, GRAD_TOL = 1e-4, 1e-3
SDF_KW = dict(d_out=17, d_hidden=16, n_layers=2, skip_in=(5,), multires=2)
NERF_KW = dict(D=2, W=16, d_in=4, multires=2, multires_view=2, skips=(5,), use_viewdirs=True)


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-6)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


def _nerf_pair(kw, seed=0):
    params = jnets.nerf_init(jax.random.PRNGKey(seed), jnets.NeRFConfig(**kw))
    net = tnets.NeRFNetwork(tnets.NeRFConfig(**kw))
    params_from_jax(tree_flatten_paths(params), net)
    return params, net


@pytest.mark.parametrize("kw", [
    dict(D=4, W=32, multires=10, multires_view=4, skips=(1,)),
    dict(D=4, W=32, multires=10, multires_view=4, skips=(4,)),
])
def test_nerf_network_matches_jax(kw):
    params, net = _nerf_pair(kw)
    g = np.random.default_rng(1)
    pts = g.normal(size=(50, 4)).astype(np.float32)
    views = g.normal(size=(50, 3)).astype(np.float32)
    ja, jr = jnets.nerf_apply(params, jnets.NeRFConfig(**kw), jnp.asarray(pts), jnp.asarray(views))
    with torch.no_grad():
        ta, tr = net(torch.from_numpy(pts), torch.from_numpy(views))
    _close(ta, ja, OUT_TOL, "alpha")
    _close(tr, jr, OUT_TOL, "rgb")


def _fields(extra: bool, seed: int = 0):
    col_kw = dict(d_feature=16, d_hidden=16, n_layers=1, extra_color=extra)
    cfgs = jneus.NetConfigs(sdf=jnets.SDFConfig(**SDF_KW), color=jnets.ColorConfig(**col_kw),
                            nerf=jnets.NeRFConfig(**NERF_KW))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"sdf": jnets.sdf_init(k1, cfgs.sdf), "color": jnets.color_init(k2, cfgs.color),
              "variance": jnets.variance_init(0.3), "nerf": jnets.nerf_init(k3, cfgs.nerf)}
    fields = tnets.NeuSFields(tnets.SDFConfig(**SDF_KW), tnets.ColorConfig(**col_kw), 0.3,
                              nerf_cfg=tnets.NeRFConfig(**NERF_KW))
    params_from_jax(tree_flatten_paths(params), fields)
    return cfgs, params, fields


def _rays(R=8):
    ro = np.tile(np.array([[0.0, 0.0, 2.0]], np.float32), (R, 1))
    t = np.linspace(-0.3, 0.3, R)
    rd = np.stack([t, 0.1 * t, -np.ones(R)], -1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd, np.full((R, 1), 1.0, np.float32), np.full((R, 1), 3.0, np.float32)


def test_render_core_outside_matches_jax():
    cfgs, params, fields = _fields(False)
    ro, rd, _, _ = _rays(5)
    g = np.random.default_rng(2)
    z = np.sort(g.uniform(1.2, 6.0, (5, 12)), -1).astype(np.float32)
    jout = jneus.render_core_outside(params, cfgs, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), 0.25)
    with torch.no_grad():
        tout = tneus.render_core_outside(fields, torch.from_numpy(ro), torch.from_numpy(rd),
                                         torch.from_numpy(z), 0.25)
    for k in ("alpha", "sampled_color", "weights"):
        _close(tout[k], jout[k], OUT_TOL, k)


@pytest.mark.parametrize("extra", [False, True])
def test_render_with_background_matches_jax(extra):
    cfgs, params, fields = _fields(extra, seed=1)
    ncfg = dict(n_samples=8, n_importance=8, up_sample_steps=2, n_outside=4, perturb=1.0,
                extra_color=extra)
    rays = _rays()
    g = np.random.default_rng(3)
    probes = [g.normal(size=(8, 3)).astype(np.float32) for _ in range(2)]
    probes += [g.normal(size=(8, 1)).astype(np.float32), np.float32(0.7)]

    def loss_of(out, xp):
        loss = (out["color_fine"] * xp(probes[0])).sum() + (out["weight_sum"] * xp(probes[2])).sum()
        loss = loss + out["gradient_error"] * float(probes[3])
        if extra:
            loss = loss + (out["extra_color_fine"] * xp(probes[1])).sum()
        return loss

    def jrun(p):
        out = jneus.render(p, jneus.NeuSConfig(**ncfg), cfgs, *(jnp.asarray(a) for a in rays),
                           rng=None, cos_anneal_ratio=0.4)
        return loss_of(out, jnp.asarray), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jrun, has_aux=True))(params)
    tout = tneus.render(fields, tneus.NeuSConfig(**ncfg), *(torch.from_numpy(a) for a in rays),
                        cos_anneal_ratio=0.4, per_ray=True)
    loss_of(tout, torch.from_numpy).backward()
    assert tout["weights"].shape == (8, 8 + 8 + 4)
    for k, v in jout.items():
        if v is None:
            assert tout[k] is None, k
        else:
            _close(tout[k].detach(), v, OUT_TOL, k)
    named = dict(fields.named_parameters())
    flat = tree_flatten_paths(jgrads)
    assert {p.split("/")[0] for p in flat} == {"sdf", "color", "variance", "nerf"}
    assert len(flat) == len(named)
    for path, gj in flat.items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)


def test_jitter_draws_inner_then_outside():
    _, _, fields = _fields(False)
    ncfg = tneus.NeuSConfig(n_samples=8, n_importance=0, n_outside=4, perturb=1.0)
    rays = [torch.from_numpy(a) for a in _rays(6)]
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        out = tneus.render(fields, ncfg, *rays, generator=gen)
    ref = torch.Generator().manual_seed(11)
    t_in, t_out = torch.rand((6, 1), generator=ref), torch.rand((6, 4), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    assert torch.isfinite(out["color_fine"]).all() and out["weights"].shape == (6, 12)
    # the inner samples carry the first draw
    near, far = rays[2], rays[3]
    z = near + (far - near) * torch.linspace(0.0, 1.0, 8)[None] + (t_in - 0.5) * 2.0 / 8
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((6, 1), 2.0 / 8)], -1)
    torch.testing.assert_close(out["mid_z_vals"], z + dists * 0.5)
    assert t_out.shape == (6, 4)


def test_background_closes_the_megakernel_gate(monkeypatch):
    _, _, fields = _fields(False)
    ro = torch.zeros(3, 3)
    monkeypatch.setattr(tneus, "_FORCE_MEGA", True)
    assert tneus._use_mega(fields, ro, 16, torch.zeros(3, 20)) is False


def test_outside_samples_need_a_nerf():
    fields = tnets.NeuSFields(tnets.SDFConfig(**SDF_KW), tnets.ColorConfig(d_feature=16, d_hidden=16),
                              0.3)
    assert fields.nerf is None
    with pytest.raises(ValueError, match="NeRF"):
        tneus.render(fields, tneus.NeuSConfig(n_samples=8, n_importance=0, n_outside=4),
                     *(torch.from_numpy(a) for a in _rays(2)))
