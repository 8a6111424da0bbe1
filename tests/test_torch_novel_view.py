"""The port's view interpolation (``Runner.render_novel_image`` and
``interpolate_view``) against the JAX Runner's at ``scale="tiny"``.

Both Runners hold the same parameters (the JAX tree through
``params_from_jax``). ``render_novel_image`` must build the same camera
(Slerp of the two stored rotations, the centres linearly; the pose handed to
``gen_rays_pose`` to 1e-5) and the same 8-bit image to one level, at three
ratios; ``interpolate_view`` must write a 120-frame MP4 (60 renders at
resolution level 4 and their reversal) whose first and last frames agree."""

import os

import numpy as np
import pytest

from avatarclip_tpu import config as config_mod
from avatarclip_tpu.pipelines import appearance as japp
from avatarclip_tpu.pipelines import synthetic as jsyn
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.pipelines import appearance as tapp
from avatarclip_torch.utils.convert import params_from_jax
from avatarclip_torch.utils.mp4 import read_mp4_frames


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_novel")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=4, res=64)

    def conf(name):
        return config_mod.parse_string(jsyn.make_conf_text(str(tmp / name), data, "tiny"))

    jr = japp.Runner(None, mode="none", conf=conf("jax"))
    tr = tapp.Runner(None, mode="none", conf=conf("torch"), device="cpu")
    params_from_jax(tree_flatten_paths(jr.params), tr.fields)
    return jr, tr, tmp


def _capture_pose(runner, monkeypatch):
    seen = []
    orig = runner.dataset.gen_rays_pose

    def spy(pose, level):
        seen.append(np.asarray(pose))
        return orig(pose, level)

    monkeypatch.setattr(runner.dataset, "gen_rays_pose", spy)
    return seen


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.85])
def test_render_novel_image_matches_jax(runners, monkeypatch, ratio):
    jr, tr, _ = runners
    jposes, tposes = _capture_pose(jr, monkeypatch), _capture_pose(tr, monkeypatch)
    jimg = jr.render_novel_image(0, 2, ratio, 2)
    timg = tr.render_novel_image(0, 2, ratio, 2)
    np.testing.assert_allclose(tposes[0], jposes[0], atol=1e-5)
    assert timg.shape == jimg.shape == (32, 32, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 1


def test_interpolate_view_writes_the_round_trip(runners):
    _, tr, tmp = runners
    path = tr.interpolate_view(0, 1)
    assert path == os.path.join(str(tmp / "torch"), "render", "00000000_0_1.mp4")
    frames = read_mp4_frames(path)
    assert len(frames) == 120
    assert frames[0] == frames[-1] and frames[59] == frames[60]
