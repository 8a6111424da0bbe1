"""The port's IDR loader (avatarclip_torch/pipelines/idr_dataset.py) against
the JAX package's on the synthetic scene of tests/test_parity_extras.py
(three cameras around the origin, projection matrices in OpenCV's
convention, random images and full masks): the decomposition (K and the
pose) to 1e-5, the images and masks exactly, ``gen_rays_at`` at levels 1, 2
and 3 and ``near_far_from_sphere`` (unclipped) to 1e-5, the object box; the
random rays drawn from a ``torch.Generator`` by shape and range: colours
are the stored pixels, directions unit, origins the camera centre."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu import config as config_mod
from avatarclip_tpu.pipelines import idr_dataset as jidr
from avatarclip_torch.pipelines import idr_dataset as tidr
from avatarclip_torch.utils.png import write_png

TOL = 1e-5


@pytest.fixture(scope="module")
def idr_scene(tmp_path_factory):
    """The scene of tests/test_parity_extras.py:56-101, with a non-identity
    scale matrix on camera 1 and the masks as grey PNGs."""
    d = tmp_path_factory.mktemp("idr")
    os.makedirs(d / "image")
    os.makedirs(d / "mask")
    H = W = 32
    rs = np.random.RandomState(0)
    cams = {}
    n = 3
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([2 * np.sin(a), 0.3, 2 * np.cos(a)], np.float32)
        z = eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rcv = np.stack([x, -y, -z], axis=0)  # world -> camera, +z forward
        t = -Rcv @ eye
        K = np.array([[35.0, 0, W / 2], [0, 35.0, H / 2], [0, 0, 1]], np.float32)
        world_mat = np.eye(4, dtype=np.float32)
        world_mat[:3, :4] = K @ np.concatenate([Rcv, t[:, None]], axis=1)
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    cams["scale_mat_1"] = np.diag([1.1, 1.1, 1.1, 1.0]).astype(np.float32)
    np.savez(d / "cameras_sphere.npz", **cams)
    for i in range(n):
        write_png(str(d / "image" / f"{i:03d}.png"), (rs.rand(H, W, 3) * 255).astype(np.uint8))
        mask = np.zeros((H, W), np.uint8)
        mask[4:28, 6:26] = 255
        write_png(str(d / "mask" / f"{i:03d}.png"), mask)
    return str(d)


@pytest.fixture(scope="module")
def both(idr_scene):
    conf = config_mod.parse_string(f"data_dir = {idr_scene}")
    return jidr.IDRDataset(conf), tidr.IDRDataset(conf)


def test_load_K_Rt_from_P_matches_jax(both):
    jd, td = both
    for i in range(jd.n_images):
        P = (np.load(os.path.join(td.data_dir, "cameras_sphere.npz"))[f"world_mat_{i}"]
             @ td.scale_mats_np[i])[:3, :4]
        for a, b in zip(tidr.load_K_Rt_from_P(P), jidr.load_K_Rt_from_P(P)):
            np.testing.assert_allclose(a, b, atol=TOL)
    np.testing.assert_allclose(td.intrinsics_all.numpy(), np.asarray(jd.intrinsics_all), atol=TOL)
    np.testing.assert_allclose(td.intrinsics_all_inv.numpy(), np.asarray(jd.intrinsics_all_inv),
                               atol=TOL)
    np.testing.assert_allclose(td.poses.numpy(), np.asarray(jd.poses), atol=TOL)
    assert abs(td.focal - jd.focal) <= TOL


def test_images_masks_and_box_match_jax(both):
    jd, td = both
    assert (td.n_images, td.H, td.W, td.image_pixels) == (jd.n_images, jd.H, jd.W, jd.image_pixels)
    np.testing.assert_array_equal(td.images.numpy(), np.asarray(jd.images))
    np.testing.assert_array_equal(td.masks.numpy(), np.asarray(jd.masks))
    assert td.masks.shape == (3, 32, 32) and float(td.masks.max()) == 255 / 256
    np.testing.assert_allclose(td.object_bbox_min, jd.object_bbox_min, atol=TOL)
    np.testing.assert_allclose(td.object_bbox_max, jd.object_bbox_max, atol=TOL)


@pytest.mark.parametrize("idx,level", [(0, 1), (1, 2), (2, 3)])
def test_gen_rays_at_and_near_far_match_jax(both, idx, level):
    jd, td = both
    jo, jdir = jd.gen_rays_at(idx, level)
    to, tdir = td.gen_rays_at(idx, level)
    assert tuple(to.shape) == tuple(jo.shape) == (32 // level, 32 // level, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir), atol=TOL)
    tn, tf = td.near_far_from_sphere(to.reshape(-1, 3), tdir.reshape(-1, 3))
    jn, jf = jd.near_far_from_sphere(jnp.asarray(jo).reshape(-1, 3), jnp.asarray(jdir).reshape(-1, 3))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=TOL)


def test_random_rays_shapes_and_ranges(both):
    _, td = both
    g = torch.Generator().manual_seed(0)
    ro, rd, c, m = td.gen_random_rays_at(g, 1, 257)
    assert ro.shape == rd.shape == c.shape == (257, 3) and m.shape == (257, 1)
    np.testing.assert_allclose(rd.norm(dim=-1).numpy(), 1.0, atol=TOL)
    np.testing.assert_allclose(ro.numpy(), np.broadcast_to(td.poses[1, :3, 3].numpy(), (257, 3)))
    # every colour is a stored pixel of image 1 and every mask value one of its mask's
    pix = td.images[1].reshape(-1, 3)
    assert all(bool((pix == ci).all(-1).any()) for ci in c)
    assert set(np.unique(m.numpy())) <= {0.0, 255 / 256}
    near, far = td.near_far_from_sphere(ro, rd)
    assert bool((far > near).all())
    # the same generator state draws the same rays
    again = td.gen_random_rays_at(torch.Generator().manual_seed(0), 1, 257)
    assert all(torch.equal(a, b) for a, b in zip((ro, rd, c, m), again))
    # each draw is the ray gen_rays_at gives through that pixel
    g = torch.Generator().manual_seed(0)
    px = torch.randint(0, td.W, (257,), generator=g)
    py = torch.randint(0, td.H, (257,), generator=g)
    _, dense = td.gen_rays_at(1, 1)
    np.testing.assert_allclose(rd.numpy(), dense[py, px].numpy(), atol=TOL)
