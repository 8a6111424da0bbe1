"""Parity of the port's body model (avatarclip_torch/body) with the JAX package:
rotations (also against scipy), LBS and the SMPL forward on the procedural
humanoid. Tolerance 1e-5 (f32). The SMPL forward's default arguments are
made where the model lives."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from avatarclip_tpu import assets as jassets
from avatarclip_tpu.body import rotations as jrot
from avatarclip_torch import assets as tassets
from avatarclip_torch.body import rotations as trot

TOL = 1e-5


def _inputs(name, rng):
    if name in ("rodrigues", "axis_angle_to_quaternion"):
        return rng.normal(0, 1.0, (16, 3)).astype(np.float32)
    if name in ("quaternion_to_matrix", "quaternion_to_axis_angle"):
        q = rng.normal(0, 1.0, (16, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)
    if name == "rotation_6d_to_matrix":
        return rng.normal(0, 1.0, (16, 6)).astype(np.float32)
    return Rotation.from_rotvec(rng.normal(0, 1.0, (16, 3))).as_matrix().astype(np.float32)


@pytest.mark.parametrize("name", [
    "rodrigues", "matrix_to_quaternion", "quaternion_to_matrix", "quaternion_to_axis_angle",
    "axis_angle_to_quaternion", "matrix_to_axis_angle", "rotation_6d_to_matrix",
    "matrix_to_rotation_6d",
])
def test_rotations_match_jax(name):
    x = _inputs(name, np.random.default_rng(0))
    want = np.asarray(getattr(jrot, name)(jnp.asarray(x)))
    got = getattr(trot, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rodrigues_matches_scipy():
    rv = np.random.default_rng(1).normal(0, 1.0, (32, 3)).astype(np.float32)
    got = trot.rodrigues(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(got, Rotation.from_rotvec(rv).as_matrix(), atol=TOL)


@pytest.mark.parametrize("pose2rot", [True, False])
def test_smpl_forward_on_procedural_humanoid(pose2rot):
    jm, tm = jassets.load_smpl(), tassets.load_smpl()
    assert jm.approximate and tm.approximate
    np.testing.assert_array_equal(np.asarray(jm.faces), tm.faces)
    np.testing.assert_allclose(tm.lbs_weights.numpy(), np.asarray(jm.lbs_weights), atol=TOL)
    pose = np.random.default_rng(2).normal(0, 0.3, (2, 24, 3)).astype(np.float32)
    betas = np.zeros((2, 10), np.float32)
    if pose2rot:
        jp, tp = jnp.asarray(pose), torch.from_numpy(pose)
    else:
        jp = jrot.rodrigues(jnp.asarray(pose))
        tp = trot.rodrigues(torch.from_numpy(pose))
    jv, jj = jm.forward(betas=jnp.asarray(betas), body_pose=jp[:, 1:],
                        global_orient=jp[:, :1], pose2rot=pose2rot)
    tv, tj = tm.forward(betas=torch.from_numpy(betas), body_pose=tp[:, 1:],
                        global_orient=tp[:, :1], pose2rot=pose2rot)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=TOL)


@pytest.mark.parametrize("pose2rot", [True, False])
@pytest.mark.parametrize("given", ["none", "body_pose"])
def test_smpl_forward_defaults_follow_the_model_device(pose2rot, given):
    """forward() builds its default betas, pose and orientation on the
    model's device: a model moved to ``meta`` (standing in for the card)
    runs, and on the CPU the defaults equal JAX's."""
    tm = tassets.load_smpl()
    kw = {}
    if given == "body_pose":
        kw["body_pose"] = torch.zeros((1, 23, 3) if pose2rot else (1, 23, 3, 3))
        if not pose2rot:
            kw["body_pose"][..., [0, 1, 2], [0, 1, 2]] = 1.0
    verts, joints = tm.to("meta").forward(
        **{k: v.to("meta") for k, v in kw.items()}, pose2rot=pose2rot)
    assert verts.device.type == joints.device.type == "meta"
    assert verts.shape == (1, tm.v_template.shape[0], 3) and joints.shape == (1, 24, 3)
    jv, jj = jassets.load_smpl().forward(
        **{k: jnp.asarray(v.numpy()) for k, v in kw.items()}, pose2rot=pose2rot)
    tv, tj = tm.forward(**kw, pose2rot=pose2rot)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=TOL)
