"""Parity of the port's export stage (avatarclip_torch/export: mesh_io,
meshops, drive, rigged; body/lbs.inv_lbs) with the JAX package on the CPU.

Both packages read the same files and pose the same body (the procedural
humanoid that ``assets.load_smpl()`` gives without the SMPL asset):

* mesh_io: ``read_ply`` of JAX-written binary and ASCII files equal to JAX's
  reader, the ``.pc2`` and OBJ writers byte for byte;
* meshops (the port's own build of the mesh_ops source): the island,
  clustering and nearest-vertex results equal to JAX's exactly;
* ``inv_lbs``, ``retarget_mesh``, ``animate_mesh`` and ``generate_animation``
  to 1e-5 (f32 LBS; the 3x3 inverse in f32 on both sides);
* the rigged GLB: the JSON equal to JAX's but ``asset.generator``, its
  float entries (accessor bounds, joint offsets) and the binary buffer's
  float accessors to 1e-6, the integer accessors exactly; the FBX ASCII
  line by line, numbers to 1e-5, but the line naming the writer's package;
* the CLIs with ``--device cpu``; without a card the default device raises.
"""

import os
import re
import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu import assets as jassets
from avatarclip_tpu.body import lbs as jlbs
from avatarclip_tpu.body import rotations as jrot
from avatarclip_tpu.export import drive as jdrive
from avatarclip_tpu.export import mesh_io as jio
from avatarclip_tpu.export import meshops as jmeshops
from avatarclip_tpu.export import rigged as jrigged
from avatarclip_tpu.render.cameras import BODY_TO_WORLD
from avatarclip_torch import assets as tassets
from avatarclip_torch.body import lbs as tlbs
from avatarclip_torch.export import drive as tdrive
from avatarclip_torch.export import mesh_io as tio
from avatarclip_torch.export import meshops as tmeshops
from avatarclip_torch.export import rigged as trigged

TOL = 1e-5
BUF_TOL = 1e-6
FBX_TOL = 1e-5


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    """A stand-in extracted avatar: the stand-posed body with a little
    seeded noise, in the renderer's world frame, as a coloured PLY; and a
    5-frame motion .npy."""
    d = tmp_path_factory.mktemp("avatar")
    model = jassets.load_smpl()
    rest = jrot.rodrigues(jnp.asarray(jassets.load_stand_pose()).reshape(-1, 3)).reshape(1, 24, 3, 3)
    posed, _ = model.forward(body_pose=rest[:, 1:], global_orient=rest[:, :1], pose2rot=False)
    g = np.random.default_rng(0)
    v = np.asarray(posed[0]) + g.normal(0, 2e-3, posed.shape[1:]).astype(np.float32)
    colors = g.integers(0, 256, (len(v), 3)).astype(np.uint8)
    ply = str(d / "avatar.ply")
    jio.write_ply(ply, v @ BODY_TO_WORLD.T, np.asarray(model.faces), vertex_colors=colors)
    motion = (0.3 * g.normal(size=(5, 69))).astype(np.float32)
    npy = str(d / "motion.npy")
    np.save(npy, motion)
    return ply, npy, np.asarray(rest)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colored", [True, False])
def test_read_ply_matches_jax(tmp_path, binary, colored):
    g = np.random.default_rng(int(binary) * 2 + int(colored))
    v = g.normal(size=(40, 3)).astype(np.float32)
    f = g.integers(0, 40, (30, 3)).astype(np.int32)
    c = g.integers(0, 256, (40, 3)).astype(np.uint8) if colored else None
    path = str(tmp_path / "m.ply")
    jio.write_ply(path, v, f, vertex_colors=c, binary=binary)
    want, got = jio.read_ply(path), tio.read_ply(path)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], f)


def test_pc2_and_obj_bytes_match_jax(tmp_path):
    g = np.random.default_rng(3)
    frames = g.normal(size=(7, 11, 3)).astype(np.float32)
    jio.write_pc2(str(tmp_path / "ja.pc2"), frames, fps=60.0)
    tio.write_pc2(str(tmp_path / "ta.pc2"), frames, fps=60.0)
    raw = (tmp_path / "ta.pc2").read_bytes()
    assert raw == (tmp_path / "ja.pc2").read_bytes()
    assert struct.unpack("<12siiffi", raw[:32])[1:] == (1, 11, 0.0, 1.0, 7)
    v = g.normal(size=(9, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4], [5, 6, 8]]
    vt = g.uniform(size=(12, 2)).astype(np.float32)
    ft = [[0, 1, 2], [3, 4, 5], [6, 7, 11]]
    for kw in ({}, {"Vt": vt, "Ft": ft}):
        jio.write_obj(str(tmp_path / "j.obj"), v, faces, **kw)
        tio.write_obj(str(tmp_path / "t.obj"), v, faces, **kw)
        assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
        got = tio.read_obj(str(tmp_path / "t.obj"))
        np.testing.assert_allclose(got[0], v, atol=1e-6)
        assert got[1] == faces


def test_meshops_match_jax():
    g = np.random.default_rng(4)
    v = g.normal(size=(600, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[500:] += 5.0  # a second island
    f = np.concatenate([g.integers(0, 500, (900, 3)), g.integers(500, 600, (60, 3))]).astype(np.int32)
    c = g.integers(0, 256, (600, 3)).astype(np.uint8)
    for jfn, tfn, args in ((jmeshops.largest_component, tmeshops.largest_component, (v, f, c)),
                           (jmeshops.cluster_simplify, tmeshops.cluster_simplify, (v, f, 0.3, c)),
                           (jmeshops.cluster_simplify, tmeshops.cluster_simplify, (v, f))):
        want, got = jfn(*args), tfn(*args)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert len(tmeshops.largest_component(v, f, c)[0]) <= 500  # the small island went
    q = g.normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmeshops.nearest_neighbors(v, q), jmeshops.nearest_neighbors(v, q))


def test_inv_lbs_matches_jax(avatar):
    _, _, rest = avatar
    model = jassets.load_smpl()
    g = np.random.default_rng(5)
    V = 200
    verts = g.normal(0, 0.4, (2, V, 3)).astype(np.float32)
    w = g.uniform(size=(V, 24)).astype(np.float32) ** 4
    w /= w.sum(1, keepdims=True)
    pose = (0.4 * g.normal(size=(2, 24, 3))).astype(np.float32)
    offs = g.normal(0, 0.01, (2, V, 3)).astype(np.float32)
    vs = np.asarray(model.v_template)[None].repeat(2, 0)
    for p, p2r in ((pose, True), (np.concatenate([rest, rest]), False)):
        for o in (offs, None):
            want = jlbs.inv_lbs(jnp.asarray(verts), jnp.asarray(w), jnp.asarray(vs), jnp.asarray(p),
                                None if o is None else jnp.asarray(o), model.J_regressor,
                                model.parents, pose2rot=p2r)
            tm = tassets.load_smpl()
            got = tlbs.inv_lbs(torch.from_numpy(verts), torch.from_numpy(w), torch.from_numpy(vs),
                               torch.from_numpy(p), None if o is None else torch.from_numpy(o),
                               tm.J_regressor, tm.parents, pose2rot=p2r)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_retarget_and_animate_match_jax(avatar):
    ply, npy, rest = avatar
    verts = jio.read_ply(ply)[0] @ jdrive.WORLD_TO_BODY.T
    jtpose, jw = jdrive.retarget_mesh(verts, jassets.load_smpl(), jnp.asarray(rest))
    timing = {}
    ttpose, tw = tdrive.retarget_mesh(verts, tassets.load_smpl(), rest, device="cpu", timing=timing)
    assert set(timing) == {"nearest_neighbors_s", "inv_lbs_s"}
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(ttpose, jtpose, atol=TOL, rtol=TOL)
    rots = jdrive.read_motion_npy(npy)
    np.testing.assert_allclose(tdrive.read_motion_npy(npy), rots, atol=TOL)
    want = jdrive.animate_mesh(jtpose, jw, jassets.load_smpl(), rots, batch=2)
    got = tdrive.animate_mesh(jtpose, np.array(jw), tassets.load_smpl(), rots, batch=2, device="cpu")
    assert got.shape == (5, len(verts), 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # re-posing the rest-pose mesh at the pose it was sculpted in gives it back
    back = tdrive.animate_mesh(ttpose, tw, tassets.load_smpl(), rest, device="cpu")[0]
    np.testing.assert_allclose(back, verts, atol=1e-4)


def test_generate_animation_and_drive_cli_match_jax(avatar, tmp_path):
    ply, npy, _ = avatar
    jf, jfaces, jcol = jdrive.generate_animation(ply, npy, str(tmp_path / "j.pc2"))
    out = str(tmp_path / "t.pc2")
    timing = tdrive.main(["--mesh", ply, "--motion", npy, "--out", out, "--device", "cpu",
                          "--cleaned_ply", str(tmp_path / "clean.ply")])
    assert timing["frames"] == 5 and timing["vertices"] == len(jf[0])
    raw, jraw = open(out, "rb").read(), open(tmp_path / "j.pc2", "rb").read()
    assert raw[:32] == jraw[:32] and len(raw) == len(jraw)
    frames = np.frombuffer(raw[32:], "<f4").reshape(jf.shape)
    np.testing.assert_allclose(frames, jf, atol=TOL, rtol=TOL)
    tf, tfaces, tcol = tdrive.generate_animation(ply, npy, str(tmp_path / "t2.pc2"), device="cpu")
    np.testing.assert_array_equal(tfaces, jfaces)
    np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_allclose(tf, jf, atol=TOL, rtol=TOL)
    assert np.abs(tf[0] - tf[-1]).max() > 1e-2  # the frames move


def _assert_json_close(a, b, path="$"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _assert_json_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_close(x, y, f"{path}[{i}]")
    elif isinstance(b, float):
        assert abs(a - b) <= BUF_TOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


_COMPONENT = {5126: np.float32, 5125: np.uint32, 5123: np.uint16}


def _accessors(js, bin_data):
    out = []
    for acc in js["accessors"]:
        bv = js["bufferViews"][acc["bufferView"]]
        out.append(np.frombuffer(bin_data[bv["byteOffset"]:bv["byteOffset"] + bv["byteLength"]],
                                 _COMPONENT[acc["componentType"]]))
    return out


@pytest.mark.parametrize("motion", [True, False])
def test_glb_matches_jax(avatar, tmp_path, motion):
    ply, npy, _ = avatar
    kw = {"motion_npy": npy} if motion else {"blendshape_stub": True}
    jrigged.export_rigged(ply, str(tmp_path / "j.glb"), **kw)
    timing = {}
    trigged.export_rigged(ply, str(tmp_path / "t.glb"), device="cpu", timing=timing, **kw)
    assert {"read_cleanup_simplify_s", "retarget_s", "write_s"} <= set(timing)
    jjs, jbin = jrigged.read_glb(str(tmp_path / "j.glb"))
    tjs, tbin = trigged.read_glb(str(tmp_path / "t.glb"))
    assert (jjs["asset"].pop("generator"), tjs["asset"].pop("generator")) == ("avatarclip_tpu",
                                                                              "avatarclip_torch")
    _assert_json_close(tjs, jjs)
    assert len(tbin) == len(jbin)
    for acc, a, b in zip(jjs["accessors"], _accessors(tjs, tbin), _accessors(jjs, jbin)):
        if acc["componentType"] == 5126:
            np.testing.assert_allclose(a, b, atol=BUF_TOL, rtol=BUF_TOL)
        else:
            np.testing.assert_array_equal(a, b)
    if motion:
        anim = tjs["animations"][0]
        assert len(anim["channels"]) == 24
        assert tjs["accessors"][anim["samplers"][0]["input"]]["count"] == 5


_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def test_fbx_and_rigged_cli_match_jax(avatar, tmp_path):
    ply, _, _ = avatar
    jrigged.export_rigged(ply, str(tmp_path / "j.fbx"), blendshape_stub=True)
    trigged.main(["--ply", ply, "--out", str(tmp_path / "t.fbx"), "--blendshape_stub", "--device", "cpu"])
    jl = (tmp_path / "j.fbx").read_text().splitlines()
    tl = (tmp_path / "t.fbx").read_text().splitlines()
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        if b.startswith("; generated by"):
            assert (a, b) == ("; generated by avatarclip_torch", "; generated by avatarclip_tpu")
            continue
        assert _NUM.sub("#", a) == _NUM.sub("#", b), i
        x = np.array(_NUM.findall(a), np.float64)
        y = np.array(_NUM.findall(b), np.float64)
        np.testing.assert_allclose(x, y, atol=FBX_TOL, rtol=0, err_msg=f"line {i}")
    with pytest.raises(ValueError, match=".glb or .fbx"):
        trigged.export_rigged(ply, str(tmp_path / "t.obj"), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card behaviour")
def test_export_clis_default_to_cuda(avatar, tmp_path):
    ply, npy, _ = avatar
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrive.main(["--mesh", ply, "--motion", npy, "--out", str(tmp_path / "a.pc2")])
    with pytest.raises(RuntimeError, match="CUDA"):
        trigged.main(["--ply", ply, "--out", str(tmp_path / "a.glb")])
    assert not os.path.exists(tmp_path / "a.pc2") and not os.path.exists(tmp_path / "a.glb")
