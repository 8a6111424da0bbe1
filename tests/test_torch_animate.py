"""Parity of the port's AvatarAnimate (avatarclip_torch/pipelines/animate.py,
body/vposer.py, pipelines/motion_vae.py) with the JAX package on the CPU.

The JAX parameters (tiny CLIP, VPoser, motion VAE, RealNVP, codebook) carry
across through utils/convert.params_from_jax, and both packages pose one
coarse 576-face body (the procedural humanoid as an SMPL npz), so each pair
computes the same function:

* VPoser encode / decode to 1e-5; the motion VAE encode / decode to 1e-4;
* one PoseOptimizer and one VPoserOptimizer step at 64^2 with the same
  elevations, and one MotionOptimizer step with the same frame offset,
  held to JAX run under x64: JAX's own f32 VJP of the soft render's
  rgb = num / (den + 1) forms den**-2, which underflows at the saturated
  depth weights (den ~ e^60 per face) and drops the depth softmax's
  denominator, and under x64 the JAX package's weakly typed constants carry
  that division into f64. The port's step in float64: the loss to 1e-5,
  the gradient to 1e-3 relative norm, the updated variable to 1e-5; its
  step in float32: the loss to 1e-5 and the gradient to 2e-2 relative norm
  (the f32 rounding of the gradient itself: the port in f32 against the port
  in f64 differs by 2e-3 for PoseOptimizer, more through VPoser's
  rotation conversions);
* codebook retrieval, RealNVP decoding and MotionInterpolation to 1e-5;
* the CLI writes the candidates with ``--device cpu`` and raises without
  a card otherwise; the JPEG and MP4 writers read back through PIL and cv2.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from avatarclip_tpu import assets as jassets
from avatarclip_tpu.body import smpl as jsmpl
from avatarclip_tpu.body import vposer as jvposer
from avatarclip_tpu.pipelines import animate as janim
from avatarclip_tpu.pipelines import motion_vae as jvae
from avatarclip_torch.body import vposer as tvposer
from avatarclip_torch.pipelines import animate as tanim
from avatarclip_torch.pipelines import motion_vae as tvae
from avatarclip_torch.utils.convert import params_from_jax
from avatarclip_torch.utils.pytree import tree_flatten_paths

TEXT = "a rendered 3d man is jumping"


def carry(tree):
    """A JAX parameter tree -> the port's tree of float32 tensors."""
    return params_from_jax(tree_flatten_paths(tree))


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    v, f = jassets._procedural_humanoid(n_seg=6, n_ring=8)
    m = jsmpl.approximate_model_from_mesh(v, f)
    path = str(tmp_path_factory.mktemp("body") / "coarse_smpl.npz")
    np.savez(path, v_template=np.asarray(m.v_template), shapedirs=np.asarray(m.shapedirs),
             posedirs=np.asarray(m.posedirs), J_regressor=np.asarray(m.J_regressor),
             weights=np.asarray(m.lbs_weights), f=np.asarray(f))
    jctx = janim.AnimateContext(smpl_path=path, clip_size="tiny", render_res=64)
    tctx = tanim.AnimateContext(smpl_path=path, clip_size="tiny", render_res=64, device="cpu")
    tctx.clip_params = carry(jctx.clip_params)
    tctx.vposer = carry(jctx.vposer)
    return jctx, tctx


def test_text_feature_and_pose_feature_match(ctxs):
    jctx, tctx = ctxs
    jtf = np.asarray(jctx.get_text_feature(TEXT))
    np.testing.assert_allclose(tctx.get_text_feature(TEXT).numpy(), jtf, atol=1e-5)
    pose = np.random.RandomState(0).randn(2, 69).astype(np.float32) * 0.3
    elevs = np.array([0.1, -0.2, 0.0, 0.3, -0.1], np.float32)
    want = np.asarray(jctx._pose_feature_fn[False](jnp.asarray(pose), jnp.asarray(elevs),
                                                    jnp.asarray(janim_angles())))
    got = tctx.get_pose_feature(torch.from_numpy(pose), torch.from_numpy(elevs)).numpy()
    # JAX's CPU hard render keys its z-buffer on a quantised inverse depth
    # and may pick another of two near-tied faces: a few pixels' shading
    # differs, which CLIP carries to ~1e-3 of the embedding
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())


def janim_angles():
    return np.array(tanim.ANGLES, np.float32)


def test_vposer_matches_jax():
    params = jvposer.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    for bn in ("enc_bn", "enc_bn2"):  # non-trivial running statistics
        d = params[bn]["mean"].shape[0]
        params[bn]["mean"] = jnp.asarray(rng.randn(d).astype(np.float32) * 0.1)
        params[bn]["var"] = jnp.asarray(rng.uniform(0.5, 2.0, d).astype(np.float32))
    tparams = carry(params)
    z = rng.randn(4, 32).astype(np.float32)
    # within 1e-5 of the largest magnitude (angles up to ~4 rad; the
    # matrix -> quaternion -> axis-angle conversion rounds differently)
    want = np.array(jvposer.decode(params, jnp.asarray(z)))
    got = tvposer.decode(tparams, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    mu, logvar = jvposer.encode(params, jnp.asarray(want))
    tmu, tlogvar = tvposer.encode(tparams, torch.from_numpy(want))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=1e-5 * np.abs(np.asarray(mu)).max())
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar),
                               atol=1e-5 * np.abs(np.asarray(logvar)).max())


def test_motion_vae_matches_jax():
    cfg = jvae.MotionVAEConfig()  # the full width: 60 frames, latent 256, 4 layers, 4 heads
    params = jvae.init_params(jax.random.PRNGKey(3), cfg)
    tcfg = tvae.MotionVAEConfig()
    tparams = carry(params)
    lat = np.random.RandomState(2).randn(2, cfg.latent_dim).astype(np.float32)
    want = np.array(jax.jit(jvae.decode, static_argnums=1)(params, cfg, jnp.asarray(lat)))
    got = tvae.decode(tparams, tcfg, torch.from_numpy(lat)).numpy()
    assert got.shape == (2, 60, 55, 6)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(tvae.encode(tparams, tcfg, torch.from_numpy(want)).numpy(),
                               np.asarray(jax.jit(jvae.encode, static_argnums=1)(params, cfg, jnp.asarray(want))),
                               atol=1e-4)


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_double(v) for v in tree]
    return tree.double()


def _port_step(gen, step, x0, *args):
    """(loss, gradient, updated variable) of one port step from x0, in
    float32 and in float64 (every parameter, the body and the default
    dtype), as numpy."""
    ctx, out = gen.ctx, []
    saved = (ctx.clip_params, ctx.vposer, ctx.smpl, getattr(gen, "vae", None))
    for dt in (torch.float32, torch.float64):
        if dt == torch.float64:
            s = ctx.smpl
            ctx.clip_params, ctx.vposer = _double(ctx.clip_params), _double(ctx.vposer)
            ctx.smpl = dataclasses.replace(
                s, v_template=s.v_template.double(), shapedirs=s.shapedirs.double(),
                posedirs=s.posedirs.double(), J_regressor=s.J_regressor.double(),
                lbs_weights=s.lbs_weights.double())
            if saved[3] is not None:
                gen.vae = _double(gen.vae)
        torch.set_default_dtype(dt)
        try:
            x = torch.tensor(x0, dtype=dt, requires_grad=True)  # a copy: Adam updates in place
            opt = torch.optim.Adam([x], lr=0.01, betas=(0.9, 0.999), eps=1e-8)
            conv = [a.to(dt) if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
            loss = step(x, opt, *conv)
            out.append((float(loss), x.grad.numpy().copy(), x.detach().numpy().copy()))
        finally:
            torch.set_default_dtype(torch.float32)
    ctx.clip_params, ctx.vposer, ctx.smpl = saved[:3]
    if saved[3] is not None:
        gen.vae = saved[3]
    return out


def _hold(out, jloss, g64, want_var, f32_grad_tol):
    (l32, g32, _), (l64, g, var) = out
    n = np.linalg.norm
    assert abs(l64 - jloss) <= 1e-5 and abs(l32 - jloss) <= 1e-5
    assert n(g - g64) <= 1e-3 * n(g64)
    np.testing.assert_allclose(var, want_var, atol=1e-5)
    assert n(g32 - g64) <= f32_grad_tol * n(g64)


@pytest.fixture(scope="module")
def jax_pose_loss(ctxs):
    """JAX's PoseOptimizer loss of a (1, 63) pose with explicit elevations,
    and its gradient, jitted once for both pose-step tests (under x64)."""
    jctx, _ = ctxs
    jtf = jctx.get_text_feature(TEXT)
    jctx._pose_feature_fn  # noqa: B018 (builds pose_feature_raw)

    def loss_fn(pose, elevs):
        pf = jctx.pose_feature_raw(jctx.clip_params, pose, elevs, jnp.asarray(janim_angles()), soft=True)[0]
        return 1.0 - janim.clip_model.cosine_similarity(pf, jtf)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("cls", ["PoseOptimizer", "VPoserOptimizer"])
def test_pose_optimizer_step_matches_jax(ctxs, jax_pose_loss, cls):
    jctx, tctx = ctxs
    jgen = getattr(janim, cls)(ctx=jctx, topk=1, num_iteration=1)
    tgen = getattr(tanim, cls)(ctx=tctx, topk=1, num_iteration=1)
    var0 = np.random.RandomState(3).randn(tgen.dim).astype(np.float32) * 0.5
    elevs = np.array(jax.random.normal(jax.random.PRNGKey(5), (5,)) * 0.3)  # the JAX step's draw
    with jax.enable_x64(True):
        pose, decode_vjp = jax.vjp(jgen._decode, jnp.asarray(var0))
        jloss, g_pose = jax_pose_loss(pose, jnp.asarray(elevs))
        (g64,) = decode_vjp(g_pose)
    g64 = np.asarray(g64, np.float64)
    opt = optax.adam(0.01)
    upd, _ = opt.update(jnp.asarray(g64, jnp.float32), opt.init(jnp.asarray(var0)))
    tf = tctx.get_text_feature(TEXT)
    out = _port_step(tgen, lambda x, o, e: tgen.step(x, o, tf.to(x.dtype), {"elevs": e}), var0,
                     torch.from_numpy(elevs))
    _hold(out, float(jloss), g64, var0 + np.asarray(upd), 2e-2)


def test_motion_optimizer_step_matches_jax(ctxs):
    jctx, tctx = ctxs
    kw = dict(num_frame=12, latent_dim=32, num_layers=1, num_heads=2, num_iteration=1,
              clip_num_part=6, recon_coef=(1.0, 0.8))
    jgen = janim.MotionOptimizer(ctx=jctx, **kw)
    tgen = tanim.MotionOptimizer(ctx=tctx, **kw)
    tgen.vae = carry(jgen.vae)
    rng = np.random.RandomState(4)
    lat0 = rng.randn(32).astype(np.float32)
    poses = (rng.randn(2, 69) * 0.2).astype(np.float32)
    st = 3
    jtf = jctx.get_text_feature(TEXT)
    opt = optax.adam(0.01)
    key = jax.random.PRNGKey(0)  # unused by the JAX step's loss
    with jax.enable_x64(True):
        jloss, g64 = jax.value_and_grad(lambda lat: jgen._step(
            lat, opt.init(lat), jnp.asarray(poses[:, :63]), jtf, jnp.asarray(st), key)[2])(jnp.asarray(lat0))
    g64 = np.asarray(g64, np.float64)
    upd, _ = opt.update(jnp.asarray(g64, jnp.float32), opt.init(jnp.asarray(lat0)))
    tf = tctx.get_text_feature(TEXT)
    out = _port_step(tgen, lambda x, o, p: tgen.step(x, o, p, tf.to(x.dtype), {"st_idx": st}), lat0,
                     torch.from_numpy(poses[:, :63]))
    _hold(out, float(jloss), g64, lat0 + np.asarray(upd), 2e-2)


def test_codebook_retrieval_matches_jax(ctxs):
    jctx, tctx = ctxs
    jgen = janim.VPoserCodebook(ctx=jctx, topk=5, pre_topk=8)
    tgen = tanim.VPoserCodebook(ctx=tctx, topk=5, pre_topk=8)
    tgen.codebook = torch.from_numpy(np.asarray(jgen.codebook))
    tgen.codebook_embedding = torch.from_numpy(np.asarray(jgen.codebook_embedding))
    want = np.asarray(jgen.get_topk_poses(TEXT))
    got = tgen.get_topk_poses(TEXT).numpy()
    assert got.shape == want.shape and got.shape[-1] == 69
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_realnvp_matches_jax(ctxs):
    jctx, tctx = ctxs
    jgen = janim.VPoserRealNVP(ctx=jctx, topk=1, num_sample=2, num_batch=1)
    tgen = tanim.VPoserRealNVP(ctx=tctx, topk=1, num_sample=2, num_batch=1)
    tgen.params = carry(jgen.params)
    rng = np.random.RandomState(6)
    z = rng.randn(3, 32).astype(np.float32)
    feats = rng.randn(3, jctx.clip_cfg.embed_dim).astype(np.float32)
    want = np.asarray(jgen.nvp_decode(jnp.asarray(z), jnp.asarray(feats)))
    got = tgen.nvp_decode(torch.from_numpy(z), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    z2, logdet = tgen.nvp_encode(got, torch.from_numpy(feats))
    _, jlogdet = jgen.nvp_encode(jnp.asarray(want), jnp.asarray(feats))
    np.testing.assert_allclose(z2.numpy(), z, atol=1e-4)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(jlogdet), atol=1e-5)
    poses = tgen.get_topk_poses(TEXT)  # the sampler end to end: one batch of 2
    assert poses.shape == (1, 69) and torch.isfinite(poses).all()


def test_motion_interpolation_matches_jax(ctxs):
    jctx, tctx = ctxs
    poses = (np.random.RandomState(7).randn(5, 69) * 0.2).astype(np.float32)
    kw = dict(num_frame=13, anchor_position=(0, 3, 6, 9, 12))
    want = np.asarray(janim.MotionInterpolation(ctx=jctx, **kw).get_motion(TEXT, jnp.asarray(poses)))
    got = tanim.MotionInterpolation(ctx=tctx, **kw).get_motion(TEXT, torch.from_numpy(poses)).numpy()
    assert got.shape == (13, 69)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())  # as VPoser's decode


def _conf(tmp_path, exp):
    p = tmp_path / "pose.conf"
    p.write_text(f"""
general {{
    base_exp_dir = {exp}
    mode = pose
    text = {TEXT}
    clip_model = tiny
    render_res = 64
    viz_res = 64
}}
pose_generator {{
    type = PoseOptimizer
    topk = 1
    num_iteration = 1
}}
""")
    return str(p)


def test_cli_pose_mode_writes_candidates(tmp_path):
    from PIL import Image

    exp = tmp_path / "exp"
    out = tanim.main(["--conf", _conf(tmp_path, exp), "--device", "cpu"])
    pose = np.load(exp / "candidate_0.npy")
    assert pose.shape == (69,) and np.isfinite(pose).all()
    img = np.asarray(Image.open(exp / "candidate_0.jpg"))
    assert img.shape == (64, 64, 3)
    assert (img[..., 0] < 250).mean() > 0.01  # the body covers some pixels
    assert len(out["pose_generator"].timing["step_s"]) == 1


def test_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tanim.main(["--conf", _conf(tmp_path, tmp_path / "exp")])


def _smooth_image(H, W, seed):
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([x / W * 200 + 20, y / H * 150 + 50, (x + y) / (H + W) * 255], -1)
    img[H // 4:H // 2, W // 3:W // 2] = (240, 30, 60)  # a flat patch with hard edges
    return np.clip(img + np.random.RandomState(seed).normal(0, 2, img.shape), 0, 255).astype(np.uint8)


# 8-bit tolerance of the writers at quality 90: mean |error| <= 3 and
# max |error| <= 40 (ringing at hard edges)
def _close_8bit(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return d.mean() <= 3.0 and d.max() <= 40


def test_jpeg_writer_reads_back_through_pil(tmp_path):
    from PIL import Image

    from avatarclip_torch.utils import jpeg

    for H, W in ((64, 64), (37, 91)):  # and a size that is no multiple of 8
        img = _smooth_image(H, W, H)
        path = str(tmp_path / f"{H}.jpg")
        jpeg.write_jpeg(path, img)
        with open(path, "rb") as f:
            assert jpeg.jpeg_markers(f.read()) == [0xFFD8, 0xFFE0, 0xFFDB, 0xFFC0, 0xFFC4, 0xFFDA, 0xFFD9]
        assert _close_8bit(np.asarray(Image.open(path).convert("RGB")), img)


def test_mp4_writer_reads_back_through_cv2(tmp_path):
    import cv2

    from avatarclip_torch.utils import mp4

    frames = [_smooth_image(48, 64, i) for i in range(12)]
    path = str(tmp_path / "m.mp4")
    mp4.write_mp4(path, frames, fps=30)
    assert len(mp4.read_mp4_frames(path)) == 12
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FPS) == 30
    got = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        got.append(img[..., ::-1])
    cap.release()
    assert len(got) == 12
    assert all(_close_8bit(g, f) for g, f in zip(got, frames))


def test_visualize_render_motion_writes_all_frames(ctxs, tmp_path):
    from avatarclip_torch.pipelines import visualize
    from avatarclip_torch.utils import mp4

    _, tctx = ctxs
    motion = torch.from_numpy((np.random.RandomState(8).randn(4, 69) * 0.2).astype(np.float32))
    path = str(tmp_path / "motion.mp4")
    visualize.render_motion(motion, path, ctx=tctx, res=48, fps=30)
    assert len(mp4.read_mp4_frames(path)) == 4
    assert os.path.getsize(path) > 1000


def test_load_smpl_uv_matches_jax(tmp_path, monkeypatch):
    """The SURREAL-textured asset (smpl_uv.obj with its PNG beside it) loads
    to the JAX package's (face_uvs, texture): the port reads the PNG with
    its own reader."""
    from avatarclip_tpu import assets as ja
    from avatarclip_torch import assets as ta
    from avatarclip_torch.utils.png import write_png

    rng = np.random.RandomState(9)
    vt = rng.uniform(0, 1, (6, 2))
    lines = [f"v {x} {y} {z}" for x, y, z in rng.randn(4, 3)] + [f"vt {u} {w}" for u, w in vt]
    lines += ["f 1/1 2/2 3/3", "f 1/4 3/5 4/6"]
    (tmp_path / "smpl_uv.obj").write_text("\n".join(lines) + "\n")
    write_png(str(tmp_path / "smpl_texture.png"), rng.randint(0, 256, (8, 12, 3)).astype(np.uint8))
    monkeypatch.setenv("AVATARCLIP_TPU_DATA", str(tmp_path))
    ja.load_smpl_uv.cache_clear()
    ta.load_smpl_uv.cache_clear()
    try:
        want, got = ja.load_smpl_uv(), ta.load_smpl_uv()
    finally:  # the lru caches outlive the monkeypatched path
        ja.load_smpl_uv.cache_clear()
        ta.load_smpl_uv.cache_clear()
    assert got[0].shape == (2, 3, 2) and got[1].shape == (8, 12, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

