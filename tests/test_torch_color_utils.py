"""The port's colour-space utilities (render/color.py) against the JAX
package's: ``rgb2hsv`` on random colours and on exact ties (each channel the
minimum in turn, and grey), to 1e-4 of the largest magnitude, and
``differentiable_histogram`` on (n, c, H, W) and (H, W) inputs, values to
1e-4 and the gradient of a weighted sum of the bins to 1e-3, each relative
to the largest magnitude of what it is held against."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.render import color as jcolor
from avatarclip_torch.render import color as tcolor

OUT_TOL, GRAD_TOL = 1e-4, 1e-3


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-6), (name, np.abs(a - b).max())


def test_rgb2hsv_matches_jax():
    g = np.random.default_rng(0)
    rgb = g.uniform(0, 1, (64, 3)).astype(np.float32)
    ties = np.array([[0.2, 0.5, 0.9], [0.9, 0.2, 0.5], [0.5, 0.9, 0.2], [0.4, 0.4, 0.4],
                     [0.3, 0.3, 0.8], [0.0, 0.0, 0.0]], np.float32)
    rgb = np.concatenate([rgb, ties])
    _close(tcolor.rgb2hsv(torch.from_numpy(rgb)), jcolor.rgb2hsv(jnp.asarray(rgb)), OUT_TOL)


@pytest.mark.parametrize("shape,bins", [((2, 3, 8, 8), 16), ((10, 12), 9)])
def test_differentiable_histogram_matches_jax(shape, bins):
    g = np.random.default_rng(1)
    x = g.uniform(-1, 2, shape).astype(np.float32)
    w = g.normal(size=(2 if len(shape) == 4 else 1, 3 if len(shape) == 4 else 1, bins)).astype(np.float32)
    jh, jg = jax.value_and_grad(lambda a: jnp.sum(jcolor.differentiable_histogram(a, bins) * w))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    th = tcolor.differentiable_histogram(t, bins)
    (th * torch.from_numpy(w)).sum().backward()
    _close(th.detach(), jcolor.differentiable_histogram(jnp.asarray(x), bins), OUT_TOL, "hist")
    _close((th.detach() * torch.from_numpy(w)).sum(), jh, OUT_TOL, "weighted")
    _close(t.grad, jg, GRAD_TOL, "grad")
