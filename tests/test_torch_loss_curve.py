"""The same-seed loss curve of the port against the JAX package: 20
train_clip steps and then 20 photometric steps from the same parameters at
``scale="tiny"`` (f32) with perturb = 0, each side with its own Adam state
and LR schedule (warm-up shortened to 5 steps over 40, so the parameters
move by the schedule's full rate rather than the first steps of a 500-step
warm-up). The port gets each JAX step's draws (the background, light and
silhouette-shift draws of train_clip, the view and pixels of the
photometric step); the cameras come from both Runners' own numpy stream.
The JAX GT render runs the Pallas z-buffer in interpret mode (exact-f32
winners, as the port).

Held: the loss and every metric at every step, and every parameter after
the 40 steps, against a tolerance that grows with the step count: step n's
loss within 2e-5 * (1 + n) relative (f32 rounding, ~1e-6 a step, compounded
by the updates it feeds), the final parameters within 1e-4 of each
tensor's largest magnitude."""

import functools

import numpy as np
import jax
import pytest
import torch

from avatarclip_tpu import config as config_mod
from avatarclip_tpu.clipjax import tokenizer
from avatarclip_tpu.pipelines import appearance as japp
from avatarclip_tpu.pipelines import synthetic as jsyn
from avatarclip_tpu.render import raster as jraster
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.clip import model as tclip
from avatarclip_torch.pipelines import appearance as tapp
from avatarclip_torch.render import raster as traster
from avatarclip_torch.utils.convert import params_from_jax

N_CLIP = N_PHOTO = 20
LOSS_TOL = 2e-5  # relative, per step of the curve: step n is held to LOSS_TOL * (1 + n)
PARAM_TOL = 1e-4  # relative to each tensor's largest magnitude, after the 40 steps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny tensors' many small ops thrash when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip_draws(key, S):
    """The JAX train_clip step's draws from its key (appearance.py:575-635)."""
    ks = jax.random.split(key, 10)
    k1, k2, k3 = jax.random.split(ks[4], 3)
    return {
        "shift": int(jax.random.randint(ks[2], (), 0, S * S)),
        "choice": int(jax.random.randint(ks[3], (), 0, 4)),
        "noise": torch.from_numpy(np.array(jax.random.normal(k1, (S, S, 1)))),
        "chess_n": int(jax.random.randint(k2, (), 10, 20)),
        "chess_sigma": float(jax.random.uniform(k3, (), minval=0.1, maxval=2.0)),
        "light_dtheta": float(jax.random.uniform(ks[5], (), minval=-np.pi / 4, maxval=np.pi / 4)),
        "light_dphi": float(jax.random.uniform(ks[6], (), minval=-np.pi / 4, maxval=np.pi / 4)),
        "ambience": float(jax.random.uniform(ks[7], (), minval=0.0, maxval=0.2)),
    }


def _photo_draws(key, jr):
    """The JAX photometric step's draws from its key."""
    k1, k2, _ = jax.random.split(key, 3)
    kx, ky = jax.random.split(k2)
    B, ds = jr.tc.batch_size, jr.dataset
    return {
        "img_idx": int(jax.random.randint(k1, (), 0, ds.n_images)),
        "px": torch.from_numpy(np.array(jax.random.randint(kx, (B,), 0, ds.W))).long(),
        "py": torch.from_numpy(np.array(jax.random.randint(ky, (B,), 0, ds.H))).long(),
    }


def _conf(tmp, data_dir):
    conf = config_mod.parse_string(jsyn.make_conf_text(str(tmp / "exp"), data_dir, "tiny"))
    conf.put("model.neus_renderer.perturb", 0.0)
    conf.put("train.warm_up_end", 5)
    conf.put("train.end_iter", N_CLIP + N_PHOTO)
    return conf


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("curve")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=4, res=64)
    jr = japp.Runner(None, mode="none", conf=_conf(tmp, data))
    tr = tapp.Runner(None, mode="none", conf=_conf(tmp, data), device="cpu")
    params_from_jax(tree_flatten_paths(jr.params), tr.fields)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jraster, "render_mesh",
                   functools.partial(jraster.render_mesh, use_kernel=True, interpret=True))
        jr.init_clip()
        jr.init_smpl()
        tr.init_smpl()
        # both render the JAX template (a 1e-7 vertex difference could flip a
        # raster near-tie), with the same CLIP weights
        v = torch.from_numpy(np.array(jr._template[0]))
        tr._template = (v, tr._template[1])
        tr._template_normals = traster.vertex_normals(v, tr._template[1])
        tr._template_face_normals = tr._template_normals[tr._template[1]]
        clip_params = params_from_jax(tree_flatten_paths(jr._clip[0]))
        toks = tokenizer.tokenize([tr.conf.get_string(k) for k in
                                   ("clip.prompt", "clip.face_prompt", "clip.back_prompt")])
        tr._clip = (clip_params, tclip.TINY)
        tr._encoded_texts = tclip.encode_text(clip_params, tclip.TINY, torch.from_numpy(toks))

        init = {k: np.array(v) for k, v in tree_flatten_paths(jr.params).items()}
        S = jr.tc.sil_res
        step = jr._make_clip_step_at(S)
        key = jax.random.PRNGKey(11)
        jm_all, tm_all = [], []
        for it in range(N_CLIP):
            key, k = jax.random.split(key)
            cam, _ = jr.sample_iteration_camera(it, (S,))
            cam_args = {c: cam[c] for c in ("pose", "theta", "phi", "is_front")}
            cam_args["face_iter"] = np.bool_(cam["face_iter"])
            jr.params, jr.opt_state, jm = step(jr.params, jr.opt_state, k, it, jr._clip_const,
                                               cam_args)
            tcam, tS = tr.sample_iteration_camera(it, (S,))
            assert tS == S and tcam["face_iter"] == cam["face_iter"]
            loss, tm = tr.clip_loss(S, tcam, _clip_draws(k, S), it)
            tr._update(loss)
            jm_all.append({m: float(x) for m, x in jm.items()})
            tm_all.append({m: float(x) for m, x in tm.items()})

    pstep = jr._make_photometric_step()
    for it in range(N_CLIP, N_CLIP + N_PHOTO):
        key, k = jax.random.split(key)
        jr.params, jr.opt_state, jm = pstep(jr.params, jr.opt_state, k, it)
        loss, tm = tr.photometric_loss(_photo_draws(k, jr), it)
        tr._update(loss)
        jm_all.append({m: float(x) for m, x in jm.items()})
        tm_all.append({m: float(x) for m, x in tm.items()})
    return jr, tr, jm_all, tm_all, init


def test_loss_curve_matches_jax_at_every_step(curves):
    _, tr, jm_all, tm_all, _ = curves
    assert len(jm_all) == N_CLIP + N_PHOTO and tr.update_count == N_CLIP + N_PHOTO
    worst = []
    for n, (jm, tm) in enumerate(zip(jm_all, tm_all)):
        assert sorted(jm) == sorted(tm), n
        for m, want in jm.items():
            err = abs(tm[m] - want) / max(abs(want), 1e-6)
            assert err <= LOSS_TOL * (1 + n), (n, m, tm[m], want, err)
        worst.append(abs(tm["loss"] - jm["loss"]) / abs(jm["loss"]))
    # the parameters moved: the curve is not one point repeated
    assert len({round(x["loss"], 4) for x in jm_all}) > 30
    print("worst relative loss error by step:", ["%.1e" % w for w in worst])


def test_final_parameters_match_jax(curves):
    jr, tr, _, _, init = curves
    ours = dict(tr.fields.named_parameters())
    flat = tree_flatten_paths(jr.params)
    assert len(flat) == len(ours)
    for path, want in flat.items():
        want = np.asarray(want, np.float64)
        got = ours[path.replace("/", ".")].detach().double().numpy()
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() <= PARAM_TOL * scale, (path, np.abs(got - want).max(), scale)
    moved = max(float(np.abs(np.asarray(flat[k]) - a).max()) for k, a in init.items())
    assert moved > 1e-3  # Adam moved them by its rate over the steps
