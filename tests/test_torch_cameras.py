"""Parity of the port's cameras (avatarclip_torch/render/cameras.py) with the
JAX package: exact everywhere (ray origins, near/far, the host camera
stream, dilation, the silhouette ray selection with JAX's ``shift`` passed
in) but the ray directions, which differ by one f32 ulp."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.render import cameras as jcam
from avatarclip_torch.render import cameras as tcam


def _pose():
    return jcam._lookat_np(np.array([0.3, 0.5, 2.0], np.float32), np.zeros(3, np.float32),
                           np.array([0.0, 1.0, 0.0], np.float32))


def test_pixel_grid_rays_and_near_far():
    pose = _pose()
    jo, jd = jcam.pixel_grid_rays(jnp.asarray(pose), 24, 20, 30.0, sensor_h=48, sensor_w=40)
    to, td = tcam.pixel_grid_rays(torch.from_numpy(pose), 24, 20, 30.0, sensor_h=48, sensor_w=40)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # the direction's rotation sums in another order: one f32 ulp
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-7)
    jn, jf = jcam.near_far_from_sphere(jo.reshape(-1, 3), jd.reshape(-1, 3))
    tn, tf = tcam.near_far_from_sphere(torch.tensor(np.asarray(jo).reshape(-1, 3)),
                                       torch.tensor(np.asarray(jd).reshape(-1, 3)))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("face_iter", [False, True])
def test_training_camera_stream(face_iter):
    a = jcam.sample_training_camera(np.random.default_rng([0, 5]), face_iter, 0.7)
    b = tcam.sample_training_camera(np.random.default_rng([0, 5]), face_iter, 0.7)
    np.testing.assert_array_equal(a["pose"], b["pose"])
    for k in ("theta", "phi", "is_front", "face_iter", "distance"):
        assert a[k] == b[k], k


def test_dilate_and_select_silhouette_rays():
    g = np.random.default_rng(4)
    H, W = 40, 48
    mask = np.zeros((H, W), bool)
    mask[10:25, 12:30] = True
    mask |= g.uniform(size=(H, W)) > 0.97
    key = jax.random.PRNGKey(7)
    j_idx, j_dil, j_sel = jcam.select_silhouette_rays(key, jnp.asarray(mask), 512, 3)
    shift = int(jax.random.randint(key, (), 0, H * W))
    t_idx, t_dil, t_sel = tcam.select_silhouette_rays(torch.from_numpy(mask), 512, 3, shift)
    np.testing.assert_array_equal(t_dil.numpy(), np.asarray(j_dil))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
