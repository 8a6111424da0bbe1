"""Parity of the port's neural fields (avatarclip_torch/fields) with the JAX
networks, parameters converted from JAX by params_from_jax: SDF values,
features and spatial gradient, the colour net with the extra head, the
variance net. Tolerance 1e-5 (f32)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.fields.embedder import positional_encoding
from avatarclip_torch.utils.convert import params_from_jax

TOL = 1e-5
SDF_KW = dict(d_out=33, d_hidden=32, n_layers=3, skip_in=(3,), multires=4)
COL_KW = dict(d_feature=32, d_hidden=32, n_layers=2, extra_color=True)


def _pts(n=64, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_sdf_value_feature_gradient(weight_norm):
    jcfg = jnets.SDFConfig(weight_norm=weight_norm, **SDF_KW)
    params = jnets.sdf_init(jax.random.PRNGKey(0), jcfg)
    net = params_from_jax(tree_flatten_paths({"sdf": params}),
                          tnets.SDFNetwork(tnets.SDFConfig(weight_norm=weight_norm, **SDF_KW)),
                          prefix="sdf/")
    x = _pts()
    js, jf, jg = jax.jit(lambda p, y: jnets._sdf_with_gradient_xla(p, jcfg, y))(
        params, jnp.asarray(x))
    ts, tf, tg = net.sdf_with_gradient(torch.from_numpy(x))
    for a, b in ((ts, js), (tf, jf), (tg, jg)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(net.sdf(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax.jit(lambda p, y: jnets.sdf_value(p, jcfg, y))(
                                   params, jnp.asarray(x))),
                               atol=TOL, rtol=TOL)


def test_color_net_with_extra_head():
    jcfg = jnets.ColorConfig(**COL_KW)
    params = jnets.color_init(jax.random.PRNGKey(1), jcfg)
    net = params_from_jax(tree_flatten_paths({"color": params}),
                          tnets.ColorNetwork(tnets.ColorConfig(**COL_KW)), prefix="color/")
    g = np.random.default_rng(3)
    pts, nrm, dirs = (g.normal(0, 1, (50, 3)).astype(np.float32) for _ in range(3))
    feat = g.normal(0, 1, (50, 32)).astype(np.float32)
    want = jnets.color_apply(params, jcfg, *(jnp.asarray(a) for a in (pts, nrm, dirs, feat)))
    got = net(*(torch.from_numpy(a) for a in (pts, nrm, dirs, feat)))
    assert got.shape == (50, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_variance_and_embedder():
    var = tnets.VarianceNetwork(0.3)
    np.testing.assert_allclose(float(var.inv_s().detach()),
                               float(jnets.variance_inv_s(jnets.variance_init(0.3))), rtol=TOL)
    from avatarclip_tpu.fields.embedder import positional_encoding as jpe

    x = _pts(10)
    np.testing.assert_allclose(positional_encoding(torch.from_numpy(x), 6).numpy(),
                               np.asarray(jpe(jnp.asarray(x), 6)), atol=TOL)
