"""The port's validation modes vs the JAX Runner's at ``scale="tiny"``.

Both Runners hold the same parameters (the JAX tree through
``params_from_jax``) and draw from numpy's global RNG seeded alike (the
camera of ``validate_image(idx=-1)``, the cast-light direction).
``validate_image``, ``validate_mesh(resolution=24)`` and
``render_geometry_cast_light`` must write PNGs that agree to one 8-bit level
and meshes with the same vertex and triangle counts (vertices to 1e-4).
"""

import os

import numpy as np
import pytest

from avatarclip_tpu import config as config_mod
from avatarclip_tpu.pipelines import appearance as japp
from avatarclip_tpu.pipelines import synthetic as jsyn
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.pipelines import appearance as tapp
from avatarclip_torch.utils.convert import params_from_jax
from avatarclip_torch.utils.png import read_png


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_val")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=4, res=64)

    def conf(name):
        return config_mod.parse_string(jsyn.make_conf_text(str(tmp / name), data, "tiny"))

    jr = japp.Runner(None, mode="none", conf=conf("jax"))
    tr = tapp.Runner(None, mode="none", conf=conf("torch"), device="cpu")
    params_from_jax(tree_flatten_paths(jr.params), tr.fields)
    return jr, tr, tmp


def _png_close(a_path, b_path):
    a, b = read_png(a_path).astype(int), read_png(b_path).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1, (a_path, np.abs(a - b).max())
    return a


def _read_ply(path):
    with open(path, "rb") as f:
        header = []
        while not header or header[-1] != "end_header":
            header.append(f.readline().decode().strip())
        nv = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
        nf = int(next(h for h in header if h.startswith("element face")).split()[-1])
        rec = np.frombuffer(f.read(nv * 15), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    return rec["xyz"], rec["rgb"], nf


def test_validate_image_matches_jax(runners):
    jr, tr, tmp = runners
    np.random.seed(5)
    jr.validate_image()
    np.random.seed(5)
    tr.validate_image()
    names = os.listdir(tmp / "jax" / "validations_fine")
    assert names == os.listdir(tmp / "torch" / "validations_fine") and len(names) == 1
    for sub in ("validations_fine", "validations_extra_fine", "normals"):
        img = _png_close(tmp / "jax" / sub / names[0], tmp / "torch" / sub / names[0])
        assert img.std() > 0


def test_validate_mesh_matches_jax(runners):
    jr, tr, tmp = runners
    jv, jt, jrgb = jr.validate_mesh(resolution=24)
    tv, tt, trgb = tr.validate_mesh(resolution=24)
    assert tt.shape == jt.shape and tv.shape == jv.shape and tt.shape[0] > 0
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    # the baked vertex colours (6-axis rays, depth-consistency pick), in the
    # returned floats and in the PLYs, to one 8-bit level
    assert trgb.shape == jrgb.shape == tv.shape
    assert np.abs(np.asarray(trgb) - np.asarray(jrgb)).max() <= 1 / 255
    xyz, rgb, nf = _read_ply(tmp / "torch" / "meshes" / "00000000.ply")
    _, jrgb8, _ = _read_ply(tmp / "jax" / "meshes" / "00000000.ply")
    assert nf == tt.shape[0] and xyz.shape == tv.shape
    np.testing.assert_array_equal(xyz, tv.astype(np.float32))
    assert np.abs(rgb.astype(int) - jrgb8.astype(int)).max() <= 1 and rgb.std() > 0


def test_cast_light_matches_jax(runners):
    jr, tr, tmp = runners
    np.random.seed(7)
    jr.render_geometry_cast_light()
    np.random.seed(7)
    tr.render_geometry_cast_light()
    name = "cast_light_texture_head_black.png"
    img = _png_close(tmp / "jax" / name, tmp / "torch" / name)
    assert img.shape == (128, 128, 3) and img.std() > 0
