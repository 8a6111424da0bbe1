"""Parity of the port's ShapeGen (avatarclip_torch/pipelines/shape.py) with the
JAX package on the CPU.

Both packages read one body with SMPL's 6,890 vertices (the procedural
humanoid at 40 segments x 28 ring vertices plus one triangle,
``synthetic.smpl_size_body``) as ``zero_beta_smpl.obj`` under
``$AVATARCLIP_TPU_DATA``, the same VAE and codebook ``.npz`` files, and the
JAX tiny CLIP's parameters carried across by ``utils/convert.params_from_jax``
(the no-asset fallbacks draw from ``jax.random`` on one side and
``torch.Generator`` on the other, so they are not compared):

* ``parse_prompt`` equal; ``vae_decode`` / ``vae_encode`` on a hidden-64
  random VAE and on the fallback VAE to 1e-5; the fallback's parameters to
  1e-5; the ``.npz`` and ``.pth`` loaders;
* ``shape_gen`` with the tiny CLIP at render_res 64: the same codebook argmax
  and the vertices to 1e-5, JAX's hard render run with its kernel's
  semantics (Pallas z-buffer in interpret mode; its CPU scan keys winners on
  a quantised depth);
* the ``render`` CLI (``render_coarse_shape`` at 32^2) against JAX's, also
  with kernel semantics, on the procedural humanoid's body model passed as
  ``--smpl_model_folder``: the poses in ``transforms_train.json`` to 1e-6, every
  one of the 108 pre-mirrored PNGs with the same coverage and within one
  8-bit level but at a few near-tie pixels, face ids on a spread of views
  equal but for near-ties (|d iz| <= 1e-6 |iz|) and rgb within 1e-3; the
  views read back through the port's dataset with eyes at distance 2.2;
* the ``gen`` CLI writes the OBJ named after the prompt; without a card the
  default device raises.
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu import assets as jassets
from avatarclip_tpu.body import smpl as jsmpl
from avatarclip_tpu.clipjax import model as jclip
from avatarclip_tpu.pipelines import shape as jshape
from avatarclip_tpu.render import cameras as jcam
from avatarclip_tpu.render import raster as jraster
from avatarclip_torch import assets as tassets
from avatarclip_torch import config as tconfig
from avatarclip_torch.pipelines import dataset as tdataset
from avatarclip_torch.pipelines import shape as tshape
from avatarclip_torch.pipelines import synthetic
from avatarclip_torch.render import raster as traster
from avatarclip_torch.utils.convert import params_from_jax
from avatarclip_torch.utils.png import read_png
from avatarclip_torch.utils.pytree import tree_flatten_paths
from test_torch_raster import _assert_same_winners

TOL = 1e-5
POSE_TOL = 1e-6
RGB_TOL = 1e-3
EMBED = 64  # the codebook's CLIP width (the tiny CLIP takes it)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the plain z-buffer's many small ops thrash when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_caches():
    for m in (jassets, tassets):
        m.load_smpl.cache_clear()
        m.load_smpl_uv.cache_clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The 6,890-vertex body under $AVATARCLIP_TPU_DATA (for this module
    only), a hidden-64 random VAE and a 256-entry codebook as .npz."""
    data = tmp_path_factory.mktemp("shape_data")
    v, f = synthetic.smpl_size_body()
    assert v.shape == (tshape.N_VERTS, 3) and f.shape == (13441, 3)
    assert np.array_equal(np.unique(f), np.arange(tshape.N_VERTS))  # every vertex referenced
    synthetic.write_template_obj(str(data), v, f)
    g = np.random.default_rng(0)
    d_in, hid = tshape.N_VERTS * 3, 64

    def dense(o, i, scale):
        return {"w": (scale * g.uniform(-1, 1, (o, i)) / np.sqrt(i)).astype(np.float32),
                "b": (scale * g.uniform(-1, 1, o) / np.sqrt(i)).astype(np.float32)}

    vae = {"enc1": dense(hid, d_in, 1.0), "enc2": dense(2 * tshape.LATENT_DIM, hid, 1.0),
           "dec1": dense(hid, tshape.LATENT_DIM, 1.0), "dec2": dense(d_in, hid, 0.05)}
    other = tmp_path_factory.mktemp("shape_weights")
    vae_path = str(other / "shape_vae.npz")
    np.savez(vae_path, **tree_flatten_paths(vae))
    cb_path = str(other / "shape_codebook.npz")
    np.savez(cb_path, codebook=g.normal(size=(256, tshape.LATENT_DIM)).astype(np.float32),
             codebook_embedding=g.normal(size=(256, EMBED)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVATARCLIP_TPU_DATA", str(data))
        _clear_caches()
        yield {"data": str(data), "vae": vae_path, "codebook": cb_path, "vae_tree": vae}
    _clear_caches()


def _kernel_semantics(monkeypatch):
    """JAX's hard render with its Pallas kernel's winner rule (interpret
    mode) instead of the CPU scan's quantised depth key."""
    monkeypatch.setattr(jraster, "render_mesh",
                        functools.partial(jraster.render_mesh, use_kernel=True, interpret=True))


@pytest.mark.parametrize("prompt", ["a man", "a strong man:2:0.5", "a man:0.5", "head:torso:3:-1", ""])
def test_parse_prompt_matches_jax(prompt):
    assert tshape.parse_prompt(prompt) == jshape.parse_prompt(prompt)


@pytest.mark.parametrize("which", ["random_hidden64", "fallback"])
def test_vae_matches_jax(files, which):
    if which == "fallback":
        jp, tp = jshape.vae_fallback_from_smpl(), tshape.vae_fallback_from_smpl()
        for path, want in tree_flatten_paths(jp).items():
            np.testing.assert_allclose(np.asarray(tree_flatten_paths(tp)[path]), want, atol=TOL)
    else:
        jp, jloaded = jshape.load_vae(files["vae"])
        tp, tloaded = tshape.load_vae(files["vae"])
        assert jloaded and tloaded
    vt = np.array(jassets.load_smpl().v_template)
    np.testing.assert_array_equal(tassets.load_smpl().v_template.numpy(), vt)
    g = np.random.default_rng(1)
    z = g.normal(size=(3, tshape.LATENT_DIM)).astype(np.float32)
    off = g.normal(0, 0.01, (3, tshape.N_VERTS * 3)).astype(np.float32)
    want = np.asarray(jshape.vae_decode(jp, jnp.asarray(vt), jnp.asarray(z)))
    got = tshape.vae_decode(tp, torch.from_numpy(vt), torch.from_numpy(z)).numpy()
    assert got.shape == (3, tshape.N_VERTS, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    for a, b in zip(tshape.vae_encode(tp, torch.from_numpy(off)),
                    jshape.vae_encode(jp, jnp.asarray(off))):
        assert a.shape == (3, tshape.LATENT_DIM)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_vae_and_codebook_loaders(files, tmp_path):
    """The .pth layouts of the reference (a state dict; a single-entry
    {latents: embeddings} dict) load as the .npz do; vae_init draws the
    checkpoint's shapes from a seeded generator."""
    tree = files["vae_tree"]
    sd = {f"{k}.{'weight' if p == 'w' else 'bias'}": torch.from_numpy(v)
          for k, d in tree.items() for p, v in d.items()}
    torch.save(sd, tmp_path / "model_VAE_16.pth")
    got, loaded = tshape.load_vae(str(tmp_path / "model_VAE_16.pth"))
    assert loaded
    for path, want in tree_flatten_paths(tree).items():
        np.testing.assert_array_equal(np.asarray(tree_flatten_paths(got)[path]), want)
    cb, emb = tshape.load_codebook(files["codebook"])
    jcb, jemb = jshape.load_codebook(files["codebook"])
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    torch.save({cb: emb}, tmp_path / "codebook.pth")
    cb2, emb2 = tshape.load_codebook(str(tmp_path / "codebook.pth"))
    assert torch.equal(cb2, cb) and torch.equal(emb2, emb)
    init = tshape.vae_init(torch.Generator().manual_seed(0), hidden=8)
    assert {k: tuple(v["w"].shape) for k, v in init.items()} == {
        "enc1": (8, tshape.N_VERTS * 3), "enc2": (32, 8), "dec1": (8, 16), "dec2": (tshape.N_VERTS * 3, 8)}
    again = tshape.vae_init(torch.Generator().manual_seed(0), hidden=8)
    assert torch.equal(init["dec2"]["w"], again["dec2"]["w"])


def _argmax(v, files):
    """The codebook entry whose decode is ``v``."""
    vae, _ = tshape.load_vae(files["vae"])
    cb, _ = tshape.load_codebook(files["codebook"])
    dec = tshape.vae_decode(vae, tassets.load_smpl().v_template, cb).numpy()
    return int(np.abs(dec - v[None]).reshape(len(dec), -1).max(1).argmin())


def test_shape_gen_matches_jax(files, monkeypatch):
    _kernel_semantics(monkeypatch)
    kw = dict(vae_path=files["vae"], codebook_path=files["codebook"], clip_size="tiny", render_res=64)
    jv, jf, jz = jshape.shape_gen("a person", "a strong man", **kw)
    ccfg = jclip.CLIPConfig(image_size=64, patch_size=16, vision_width=64, vision_layers=2,
                            vision_heads=2, embed_dim=EMBED, context_length=77, vocab_size=49408,
                            text_width=64, text_layers=2, text_heads=2)
    cparams = params_from_jax(tree_flatten_paths(jclip.init_params(jax.random.PRNGKey(42), ccfg)))
    tv, tf, tz = tshape.shape_gen("a person", "a strong man", device="cpu", clip_params=cparams, **kw)
    assert tf == [list(map(int, f)) for f in jf]
    np.testing.assert_allclose(tz, jz, atol=TOL, rtol=TOL)
    assert _argmax(tv, files) == _argmax(jv, files)
    np.testing.assert_allclose(tv, jv, atol=TOL, rtol=TOL)
    assert np.abs(tv - tz).max() > 1e-3  # the retrieved body is not the neutral one


@pytest.fixture(scope="module")
def gen_obj(files, tmp_path_factory):
    """The gen CLI's OBJ (tiny CLIP, the files' VAE and codebook), with
    shape_gen's neutral render cut from 256^2 to 64^2 for the CPU."""
    out = tmp_path_factory.mktemp("shape_gen")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tshape, "shape_gen", functools.partial(tshape.shape_gen, render_res=64))
        return tshape.main(["gen", "--device", "cpu", "--clip_size", "tiny",
                            "--AE_path_fname", files["vae"], "--codebook_fname", files["codebook"],
                            "--target_txt", "a tall person", "--output_folder", str(out / "coarse")])["obj"]


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """The render CLI (108 views, render_coarse_shape cut from 256^2 to
    32^2 for the CPU) and JAX's render_coarse_shape with kernel semantics,
    both on the procedural humanoid's body model (2,400 vertices, 4,608
    faces, given as an npz: render_coarse_shape does not need SMPL's vertex
    count, and the plain z-buffer's CPU time grows with the faces) shaped by
    seeded offsets."""
    out = tmp_path_factory.mktemp("shape_render")
    v, f = jassets._procedural_humanoid()
    m = jsmpl.approximate_model_from_mesh(v, f)
    body = str(out / "body.npz")
    np.savez(body, v_template=np.asarray(m.v_template), shapedirs=np.asarray(m.shapedirs),
             posedirs=np.asarray(m.posedirs), J_regressor=np.asarray(m.J_regressor),
             weights=np.asarray(m.lbs_weights), f=np.asarray(f))
    v_shaped = (np.asarray(m.v_template) + np.random.default_rng(3).normal(0, 2e-3, v.shape)).astype(np.float32)
    obj = str(out / "coarse.obj")
    tshape.mesh_io.write_obj(obj, v_shaped, f)
    port = str(out / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tshape, "render_coarse_shape", functools.partial(tshape.render_coarse_shape, res=32))
        tshape.main(["render", "--device", "cpu", "--coarse_shape_obj", obj, "--smpl_model_folder", body,
                     "--output_folder", port])
    jax_dir = str(out / "jax")
    with pytest.MonkeyPatch.context() as mp:
        _kernel_semantics(mp)
        v_read = tshape.mesh_io.read_obj(obj)[0]
        n = jshape.render_coarse_shape(jassets.load_stand_pose(), v_read[None], jax_dir, smpl_path=body, res=32)
    assert n == 108
    return obj, port, jax_dir, v_read, body


def test_gen_cli_writes_the_prompt_named_obj(files, gen_obj):
    assert os.listdir(os.path.dirname(gen_obj)) == ["a_tall_person.obj"]
    v, f, _, _ = tshape.mesh_io.read_obj(gen_obj)
    assert v.shape == (tshape.N_VERTS, 3) and len(f) == 13441
    vae, _ = tshape.load_vae(files["vae"])
    cb, _ = tshape.load_codebook(files["codebook"])
    best = tshape.vae_decode(vae, tassets.load_smpl().v_template, cb[_argmax(v, files)][None])[0]
    np.testing.assert_allclose(v, best.numpy(), atol=1e-6)  # a codebook entry's body


def test_render_cli_matches_jax(renders):
    _, port, jax_dir, _, _ = renders
    with open(os.path.join(port, "transforms_train.json")) as fp:
        got = json.load(fp)
    with open(os.path.join(jax_dir, "transforms_train.json")) as fp:
        want = json.load(fp)
    assert got["camera_angle_x"] == want["camera_angle_x"]
    assert [f["file_path"] for f in got["frames"]] == [f["file_path"] for f in want["frames"]]
    np.testing.assert_allclose([f["transform_matrix"] for f in got["frames"]],
                               [f["transform_matrix"] for f in want["frames"]], atol=POSE_TOL)
    off_by_more, covered = 0, 0
    for fr in want["frames"]:
        a = read_png(os.path.join(port, fr["file_path"] + ".png")).astype(int)
        b = read_png(os.path.join(jax_dir, fr["file_path"] + ".png")).astype(int)
        assert a.shape == b.shape == (32, 32, 3)
        np.testing.assert_array_equal(a.any(-1), b.any(-1), err_msg=fr["file_path"])
        covered += int(b.any(-1).sum())
        n = int((np.abs(a - b).max(-1) > 1).sum())  # near-tie winners shade another face
        assert n <= 3, (fr["file_path"], n)
        off_by_more += n
    assert covered > 108 * 50 and off_by_more <= 20


def test_render_views_face_ids_match_jax(renders):
    """A spread of the 108 views rendered directly:
    face ids equal but for near-ties, rgb to 1e-3."""
    _, _, _, v_shaped, body = renders
    model = jassets.load_smpl(body)
    rest = jassets.load_stand_pose()
    from avatarclip_tpu.body import rotations as jrot

    rot = jrot.rodrigues(jnp.asarray(rest).reshape(-1, 3)).reshape(1, 24, 3, 3)
    verts, _ = model.forward(v_shaped=jnp.asarray(v_shaped)[None], body_pose=rot[:, 1:],
                             global_orient=rot[:, :1], pose2rot=False)
    vw = np.asarray(verts[0]) @ jcam.BODY_TO_WORLD.T
    f = np.asarray(model.faces, np.int32)
    focal = jcam.focal_from_fov(32, np.deg2rad(60.0))
    jn = jraster.vertex_normals(jnp.asarray(vw), jnp.asarray(f))

    @jax.jit
    def render(p):
        proj = jraster.project_vertices(jnp.asarray(vw), p, 32, 32, focal)
        out = jraster.render_mesh(jnp.asarray(vw), jnp.asarray(f), p, 32, 32, focal, normals=jn,
                                  use_kernel=True, interpret=True)
        return out, jraster._face_coefficients(proj, jnp.asarray(f))[0]

    tv, tf = torch.from_numpy(vw), torch.from_numpy(f).long()
    tn = traster.vertex_normals(tv, tf)
    ties = 0
    for angle, elev in ((60, -40), (200, 0), (320, 40)):
        pose = tshape._eye_pose(float(angle), float(np.deg2rad(elev)), 2.2)
        want, coef = render(jnp.asarray(pose.numpy()))
        got = traster.render_mesh(tv, tf, pose, 32, 32, focal, normals=tn)
        g, w = got["face_id"].numpy().ravel(), np.asarray(want["face_id"]).ravel()
        assert (w >= 0).sum() > 40
        ties += _assert_same_winners(g, w, coef, 32)
        same = (g == w).reshape(32, 32)
        np.testing.assert_allclose(got["rgb"].numpy()[same], np.asarray(want["rgb"])[same], atol=RGB_TOL)
    assert ties <= 10


def test_rendered_views_read_back_through_the_dataset(renders):
    _, port, _, _, _ = renders
    ds = tdataset.SMPLViewDataset(tconfig.parse_string(f"data_dir = {port}"))
    assert ds.n_images == 108 and ds.H == ds.W == 32
    np.testing.assert_allclose(ds.poses[:, :3, 3].norm(dim=-1).numpy(), 2.2, atol=1e-4)
    # the loader undoes the pre-mirroring: the image is the render itself
    fr = json.load(open(os.path.join(port, "transforms_train.json")))["frames"][7]
    png = read_png(os.path.join(port, fr["file_path"] + ".png"))
    np.testing.assert_array_equal((ds.images[7].numpy() * 255).round().astype(np.uint8), png[:, ::-1])
    assert ds.masks.sum() > 108 * 50


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card behaviour")
def test_shape_cli_defaults_to_cuda(files, renders, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        tshape.main(["gen", "--clip_size", "tiny", "--output_folder", str(tmp_path / "g")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tshape.main(["render", "--coarse_shape_obj", renders[0], "--output_folder",
                     str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "g") and not os.path.exists(tmp_path / "r")
