"""Parity of the port's AppearanceGen Runner with the JAX Runner at
``scale="tiny"`` with perturb = 0: one train_clip step of the whole slice
(GT raster, silhouette rays, NeuS render, relighting, background, scatter,
CLIP, losses and every parameter gradient), the photometric step, Adam with
the LR schedule across warm-up, and the CLI.

The JAX steps run with the draws of their own PRNG keys; the port gets the
same draws as its explicit draw dict. The JAX gradients are captured through
an optax transform that returns them as its state. The JAX GT render runs
the Pallas z-buffer in interpret mode (exact-f32 winners, as the port).
Tolerances: 1e-4 relative on the loss and metrics, 1e-3 relative (to each
tensor's largest magnitude) on gradients; the optimizer to 1e-6.
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
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
from avatarclip_torch.utils.convert import params_from_jax


def _conf(tmp, data_dir):
    conf = config_mod.parse_string(jsyn.make_conf_text(str(tmp / "exp"), data_dir, "tiny"))
    conf.put("model.neus_renderer.perturb", 0.0)
    return conf


def _capture():
    """An optax 'optimizer' whose state after update is the gradient tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_app")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=4, res=64)
    jr = japp.Runner(None, mode="none", conf=_conf(tmp, data))
    jr.optimizer = _capture()
    jr.opt_state = jr.optimizer.init(jr.params)
    tr = tapp.Runner(None, mode="none", conf=_conf(tmp, data), device="cpu")
    params_from_jax(tree_flatten_paths(jr.params), tr.fields)
    return jr, tr


def _close(a, b, tol, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


def _grads(tr):
    return {n: p.grad for n, p in tr.fields.named_parameters()}


def _compare_grads(tr, jgrads):
    tg = _grads(tr)
    flat = tree_flatten_paths(jgrads)
    assert len(flat) == len(tg)
    for path, g in flat.items():
        _close(tg[path.replace("/", ".")], g, 1e-3, path)


def _clip_draws(key, S):
    """The JAX train_clip step's draws from its key (appearance.py:575-635)."""
    ks = jax.random.split(key, 10)
    k1, k2, k3 = jax.random.split(ks[4], 3)
    return {
        "shift": int(jax.random.randint(ks[2], (), 0, S * S)),
        "choice": int(jax.random.randint(ks[3], (), 0, 4)),
        "noise": torch.from_numpy(np.asarray(jax.random.normal(k1, (S, S, 1)))),
        "chess_n": int(jax.random.randint(k2, (), 10, 20)),
        "chess_sigma": float(jax.random.uniform(k3, (), minval=0.1, maxval=2.0)),
        "light_dtheta": float(jax.random.uniform(ks[5], (), minval=-np.pi / 4, maxval=np.pi / 4)),
        "light_dphi": float(jax.random.uniform(ks[6], (), minval=-np.pi / 4, maxval=np.pi / 4)),
        "ambience": float(jax.random.uniform(ks[7], (), minval=0.0, maxval=0.2)),
    }


@pytest.mark.parametrize("it,choice", [(0, 2), (1, 1)])  # face camera + checkerboard; body + noise
def test_train_clip_step_matches_jax(runners, monkeypatch, it, choice):
    jr, tr = runners
    monkeypatch.setattr(jraster, "render_mesh",
                        functools.partial(jraster.render_mesh, use_kernel=True, interpret=True))
    if jr._clip is None:
        jr.init_clip()
        jr.init_smpl()
        tr.init_smpl()
        jv, tv = np.asarray(jr._template[0]), tr._template[0].numpy()
        np.testing.assert_allclose(tv, jv, atol=1e-5)
        np.testing.assert_array_equal(tr._template[1].numpy(), np.asarray(jr._template[1]))
        # the step under test renders the JAX template itself (a 1e-7 vertex
        # difference could flip a raster near-tie)
        v = torch.from_numpy(jv.copy())
        tr._template = (v, tr._template[1])
        from avatarclip_torch.render import raster as traster

        tr._template_normals = traster.vertex_normals(v, tr._template[1])
        tr._template_face_normals = tr._template_normals[tr._template[1]]
        clip_params = params_from_jax(tree_flatten_paths(jr._clip[0]))
        toks = tokenizer.tokenize([tr.conf.get_string(k) for k in
                                   ("clip.prompt", "clip.face_prompt", "clip.back_prompt")])
        texts = tclip.encode_text(clip_params, tclip.TINY, torch.from_numpy(toks))
        np.testing.assert_allclose(texts.numpy(), np.asarray(jr._encoded_texts), atol=1e-4)
        tr._clip, tr._encoded_texts = (clip_params, tclip.TINY), texts
    S = jr.tc.sil_res
    key = next(jax.random.PRNGKey(i) for i in range(100)
               if int(jax.random.randint(jax.random.split(jax.random.PRNGKey(i), 10)[3],
                                         (), 0, 4)) == choice)
    cam, _ = jr.sample_iteration_camera(it, (S,))
    cam_args = {k: cam[k] for k in ("pose", "theta", "phi", "is_front")}
    cam_args["face_iter"] = np.bool_(cam["face_iter"])
    step = jr._make_clip_step_at(S)
    _, jgrads, jmetrics = step(jr.params, jr.opt_state, key, it, jr._clip_const, cam_args)

    tcam, tS = tr.sample_iteration_camera(it, (S,))
    assert tS == S and cam["face_iter"] == tcam["face_iter"]
    tr.fields.zero_grad(set_to_none=True)
    loss, tmetrics = tr.clip_loss(S, tcam, _clip_draws(key, S), it)
    loss.backward()
    for k, v in jmetrics.items():
        _close(tmetrics[k], v, 1e-4, k)
    _compare_grads(tr, jgrads)


def test_photometric_step_matches_jax(runners):
    jr, tr = runners
    key = jax.random.PRNGKey(3)
    step = jr._make_photometric_step()
    _, jgrads, jmetrics = step(jr.params, jr.opt_state, key, 0)
    k1, k2, _ = jax.random.split(key, 3)
    kx, ky = jax.random.split(k2)
    B, ds = jr.tc.batch_size, jr.dataset
    draws = {
        "img_idx": int(jax.random.randint(k1, (), 0, ds.n_images)),
        "px": torch.from_numpy(np.asarray(jax.random.randint(kx, (B,), 0, ds.W))).long(),
        "py": torch.from_numpy(np.asarray(jax.random.randint(ky, (B,), 0, ds.H))).long(),
    }
    np.testing.assert_array_equal(tr.dataset.images.numpy(), np.asarray(ds.images))
    tr.fields.zero_grad(set_to_none=True)
    loss, tmetrics = tr.photometric_loss(draws, 0)
    loss.backward()
    for k, v in jmetrics.items():
        _close(tmetrics[k], v, 1e-4, k)
    _compare_grads(tr, jgrads)


def test_adam_and_lr_schedule_across_warmup():
    tc = japp.TrainConfig(learning_rate=5e-3, warm_up_end=2.0, end_iter=10)
    g = np.random.default_rng(0)
    p0 = g.normal(size=(5, 4)).astype(np.float32)
    grads = [g.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    opt = optax.adam(japp.make_lr_schedule(tc), eps=1e-8)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tparam = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([tparam], lr=0.0, eps=1e-8)
    sched = tapp.make_lr_schedule(tapp.TrainConfig(learning_rate=5e-3, warm_up_end=2.0,
                                                   end_iter=10))
    for n, gr in enumerate(grads):
        upd, state = opt.update(jnp.asarray(gr), state, jp)
        jp = optax.apply_updates(jp, upd)
        tparam.grad = torch.from_numpy(gr)
        for group in topt.param_groups:
            group["lr"] = sched(n)
        topt.step()
        np.testing.assert_allclose(tparam.detach().numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(sched(n), float(japp.make_lr_schedule(tc)(n)), rtol=1e-6)


def test_cli_train_clip_writes_logs_and_checkpoint(tmp_path):
    from avatarclip_torch.pipelines import synthetic

    data = synthetic.write_synthetic_views(str(tmp_path / "views"), n_views=4, res=64)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(synthetic.make_conf_text(str(tmp_path / "exp"), data, "tiny"))
    base = ["--mode", "train_clip", "--conf", str(conf_path), "--set", "train.save_freq=2",
            "--device", "cpu", "--gpu", "0"]
    r = tapp.main(base + ["--set", "train.end_iter=2"])
    assert r.iter_step == 2 and len(r.step_seconds) == 2
    recs = [json.loads(x) for x in (tmp_path / "exp" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in recs] == [1, 2]
    assert all(np.isfinite(v) for x in recs for v in x.values())
    assert (tmp_path / "exp" / "checkpoints" / "ckpt_000002").exists()
    r2 = tapp.main(base + ["--set", "train.end_iter=3", "--is_continue"])
    assert r2.iter_step == 3 and r2.update_count == 3
    assert os.path.exists(tmp_path / "exp" / "recording" / "config.conf")


def test_runner_and_cli_use_cuda_unless_asked_for_the_cpu(tmp_path):
    """The card is the default; without one, asking for it (the default)
    raises instead of running on the CPU."""
    import torch

    from avatarclip_torch.pipelines import synthetic

    data = synthetic.write_synthetic_views(str(tmp_path / "views"), n_views=2, res=32)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(synthetic.make_conf_text(str(tmp_path / "exp"), data, "tiny"))
    conf = config_mod.parse_file(str(conf_path))
    assert tapp.Runner(None, mode="none", conf=conf, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert tapp.Runner(None, mode="none", conf=conf).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.Runner(None, mode="none", conf=conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.main(["--mode", "train", "--conf", str(conf_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.main(["--mode", "train", "--conf", str(conf_path), "--gpu", "1"])


def test_cli_gpu_selects_the_card(tmp_path, monkeypatch):
    """``--gpu N`` names the card ``cuda:N``; ``--device cpu`` ignores it."""
    seen = []

    class Stop(Exception):
        pass

    def fake_runner(*args, device=None, **kw):
        seen.append(str(device))
        raise Stop

    monkeypatch.setattr(tapp, "Runner", fake_runner)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(jsyn.make_conf_text(str(tmp_path / "exp"), str(tmp_path), "tiny"))
    for argv in (["--gpu", "3"], [], ["--gpu", "2", "--device", "cpu"]):
        with pytest.raises(Stop):
            tapp.main(["--mode", "train", "--conf", str(conf_path)] + argv)
    assert seen == ["cuda:3", "cuda:0", "cpu"]


@pytest.mark.parametrize("git_works", [True, False])
def test_file_backup_records_git_revision(tmp_path, monkeypatch, git_works):
    """recording/ holds the conf and, when git answers, git_revision.txt
    (as the JAX Runner's file_backup); nothing of the revision when git
    fails."""
    import subprocess

    calls = []

    def fake_run(argv, **kw):
        calls.append(argv)
        if not git_works:
            raise subprocess.CalledProcessError(128, argv)
        return subprocess.CompletedProcess(argv, 0, stdout="0123abcd\n", stderr="")

    monkeypatch.setattr(tapp.subprocess, "run", fake_run)
    conf_path = tmp_path / "a.conf"
    conf_path.write_text("general { }\n")
    runner = tapp.Runner.__new__(tapp.Runner)
    runner.base_exp_dir, runner.conf_path = str(tmp_path / "exp"), str(conf_path)
    runner.file_backup()
    rec = tmp_path / "exp" / "recording"
    assert (rec / "config.conf").read_text() == "general { }\n"
    assert calls and calls[0][:2] == ["git", "rev-parse"]
    if git_works:
        assert (rec / "git_revision.txt").read_text() == "0123abcd\n"
    else:
        assert not (rec / "git_revision.txt").exists()

