"""The port's CLIP-score eval (avatarclip_torch/pipelines/eval_clip.py)
against the JAX package's ``clip_score`` at ``scale="tiny"``, as
tests/test_appearance.py calls it (4 views at resolution level 4, the face
and back prompts on): both sides hold the same fields and the same tiny CLIP
weights (``params_from_jax``). Every rendered view (the lattice and the face
camera, inside the unit sphere, so its near bound is clipped) to 1e-4
absolute, the face rays' near / far to 1e-5, the cosines (per view, mean,
face, back) to 1e-4; two calls give equal reports. Then the
``eval_clip_score`` script on a tiny run's checkpoint: the JSON line has
JAX's report keys and ``iter_step``, and the Runner in ``mode="eval"``
builds no CLIP and writes no recording.
"""

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu import config as config_mod
from avatarclip_tpu.pipelines import appearance as japp
from avatarclip_tpu.pipelines import eval_clip as jeval
from avatarclip_tpu.pipelines import synthetic as jsyn
from avatarclip_tpu.render import cameras as jcam
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.clip import model as tclip
from avatarclip_torch.pipelines import appearance as tapp
from avatarclip_torch.pipelines import eval_clip as teval
from avatarclip_torch.pipelines import synthetic as tsyn
from avatarclip_torch.render import cameras as tcam
from avatarclip_torch.scripts import eval_clip_score
from avatarclip_torch.utils.convert import params_from_jax

IMG_TOL = 1e-4
COS_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny tensors' many small ops thrash when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_clip")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=4, res=64)
    conf_text = jsyn.make_conf_text(str(tmp / "exp"), data, "tiny")
    jr = japp.Runner(None, mode="none", conf=config_mod.parse_string(conf_text))
    tr = tapp.Runner(None, mode="none", conf=config_mod.parse_string(conf_text), device="cpu")
    params_from_jax(tree_flatten_paths(jr.params), tr.fields)
    jr.init_clip()
    clip_params = params_from_jax(tree_flatten_paths(jr._clip[0]))
    tr.init_clip()  # the port's own prompt encoding, then JAX's weights
    from avatarclip_tpu.clipjax import tokenizer

    toks = tokenizer.tokenize([tr.conf.get_string(k) for k in
                               ("clip.prompt", "clip.face_prompt", "clip.back_prompt")])
    texts = tclip.encode_text(clip_params, tclip.TINY, torch.from_numpy(toks))
    tr._clip, tr._encoded_texts = (clip_params, tclip.TINY), texts
    return jr, tr


def _lattice_poses(n_views, distance, head_height):
    """(eye, at) of the lattice and the face camera, as clip_score places them."""
    out = [(jcam._sphere_coord_np(2.0 * np.pi * i / n_views, 0.0, distance), np.zeros(3))
           for i in range(n_views)]
    at_f = np.array([0.0, head_height, 0.3], np.float32)
    return out + [(jcam._sphere_coord_np(0.0, 0.0, 0.4) + at_f, at_f)]


def test_rendered_views_match_jax(runners):
    jr, tr = runners
    for eye, at in _lattice_poses(4, 1.5, jr.tc.head_height):
        jpose = jcam.lookat(jnp.asarray(eye, jnp.float32), jnp.asarray(at, jnp.float32),
                            jnp.array([0.0, 1.0, 0.0]))
        tpose = teval._pose(eye, at, tr.device)
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), atol=1e-6)
        want = jeval._render_view(jr, jpose, 4, True)
        got = teval._render_view(tr, tpose, 4, True)
        assert got.shape == want.shape == (16, 16, 3)
        np.testing.assert_allclose(got, want, atol=IMG_TOL)


def test_face_camera_rays_take_the_clipped_near_bound(runners):
    """The face camera sits 0.4 from the head, inside the unit sphere: the
    validation chunk's near / far for its rays match JAX's, and near is
    clipped to 0 (mid - 1 < 0) for every ray."""
    jr, tr = runners
    eye, at = _lattice_poses(4, 1.5, jr.tc.head_height)[-1]
    assert np.linalg.norm(eye) < 1.0
    jpose = jcam.lookat(jnp.asarray(eye, jnp.float32), jnp.asarray(at, jnp.float32),
                        jnp.array([0.0, 1.0, 0.0]))
    jo, jd = jr.dataset.gen_rays_pose(jpose, 4)
    to, td = tr.dataset.gen_rays_pose(teval._pose(eye, at, tr.device), 4)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    jn, jf = jcam.near_far_from_sphere(jo.reshape(-1, 3), jd.reshape(-1, 3))
    tn, tf = tcam.near_far_from_sphere(to.reshape(-1, 3), td.reshape(-1, 3))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    assert float(tn.max()) == 0.0 and bool((tf > 0.5).all())


def test_clip_score_matches_jax(runners, tmp_path):
    jr, tr = runners
    want = jeval.clip_score(jr, n_views=4, resolution_level=4)
    got = teval.clip_score(tr, n_views=4, resolution_level=4, save_dir=str(tmp_path))
    again = teval.clip_score(tr, n_views=4, resolution_level=4)
    assert again == got  # a deterministic lattice: equal reports
    g, w = got.to_json(), want.to_json()
    assert sorted(g) == sorted(w)
    for k in ("prompt", "azimuths", "pretrained_clip", "n_views", "distance", "image_source"):
        assert g[k] == w[k], k
    assert g["pretrained_clip"] is False and g["image_source"] == "extra_color"
    np.testing.assert_allclose(g["cosines"], w["cosines"], atol=COS_TOL)
    for k in ("mean_cosine", "face_cosine", "back_cosine"):
        assert g[k] is not None and abs(g[k] - w[k]) <= COS_TOL, (k, g[k], w[k])
    assert np.isclose(got.mean_cosine, np.mean(got.cosines))
    json.dumps(g)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([f"eval_az{a:03d}_it00000000.png" for a in (0, 90, 180, 270)]
                           + ["eval_face_it00000000.png"])


def test_eval_clip_score_script_on_a_checkpoint(tmp_path, capsys):
    data = tsyn.write_synthetic_views(str(tmp_path / "views"), n_views=4, res=32)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(tsyn.make_conf_text(str(tmp_path / "exp"), data, "tiny"))
    tapp.main(["--mode", "train_clip", "--conf", str(conf_path), "--device", "cpu",
               "--set", "train.end_iter=2", "--set", "train.save_freq=2"])
    capsys.readouterr()
    out = tmp_path / "scores.jsonl"
    argv = ["--conf", str(conf_path), "--device", "cpu", "--n_views", "2", "--res_level", "4",
            "--out", str(out)]
    d = eval_clip_score.main(argv + ["--save_images"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(d))
    want_keys = {f.name for f in dataclasses.fields(jeval.ClipScoreReport)} | {"iter_step"}
    assert set(line) == want_keys
    assert line["iter_step"] == 2 and len(line["cosines"]) == 2
    assert json.loads(out.read_text().splitlines()[0]) == line
    assert sorted(os.listdir(tmp_path / "exp" / "clip_eval")) == [
        "eval_az000_it00000002.png", "eval_az180_it00000002.png", "eval_face_it00000002.png"]
    # --ckpt names the checkpoint: the same report
    d2 = eval_clip_score.main(argv + ["--ckpt", str(tmp_path / "exp" / "checkpoints" / "ckpt_000002")])
    assert d2 == d
    assert len(out.read_text().splitlines()) == 2


def test_runner_in_eval_mode_builds_no_clip(tmp_path):
    """``mode="eval"`` (the eval scripts' Runner): no CLIP until the eval
    asks for it, no optimizer state, no recording directory."""
    data = tsyn.write_synthetic_views(str(tmp_path / "views"), n_views=2, res=32)
    conf = config_mod.parse_string(tsyn.make_conf_text(str(tmp_path / "exp"), data, "tiny"))
    r = tapp.Runner(None, mode="eval", conf=conf, device="cpu")
    assert r._clip is None and r._template is None
    assert not r.optimizer.state
    assert not os.path.exists(tmp_path / "exp" / "recording")
