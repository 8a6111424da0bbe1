"""Linear blend skinning (twin of avatarclip_tpu/body/lbs.py): SMPL
conventions, ``parents`` a static int array with parents[0] == -1, poses as
axis-angle (N, J, 3) or matrices (N, J, 3, 3)."""

from __future__ import annotations

import numpy as np
import torch

from .rotations import rodrigues


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    return torch.einsum("jv,...vc->...jc", J_regressor, vertices)


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...b,vcb->...vc", betas, shape_dirs)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Forward kinematics -> (posed joints (N, J, 3), rest-relative skinning
    transforms A (N, J, 4, 4))."""
    parents = np.asarray(parents)
    N, J = joints.shape[:2]
    rel = joints - torch.cat([torch.zeros_like(joints[:, :1]),
                              joints[:, np.maximum(parents[1:], 0)]], 1)

    def make_tf(R, t):
        top = torch.cat([R, t[..., None]], -1)
        bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device).expand(N, 1, 4)
        return torch.cat([top, bot], -2)

    tfs = [make_tf(rot_mats[:, 0], rel[:, 0])]
    for j in range(1, J):
        tfs.append(tfs[parents[j]] @ make_tf(rot_mats[:, j], rel[:, j]))
    transforms = torch.stack(tfs, 1)
    posed_joints = transforms[..., :3, 3]
    rot_j = torch.einsum("njab,njb->nja", transforms[..., :3, :3], joints)
    correction = torch.zeros_like(transforms)
    correction[..., :3, 3] = rot_j
    return posed_joints, transforms - correction


def lbs(v_shaped, pose, posedirs, J_regressor, parents, lbs_weights, pose2rot: bool = True):
    """Pose shaped vertices: pose-corrective offsets + skinning -> (verts
    (N, V, 3), joints (N, J, 3))."""
    N, J = pose.shape[0], J_regressor.shape[0]
    joints = vertices2joints(J_regressor, v_shaped)
    rot_mats = rodrigues(pose.reshape(N, J, 3)) if pose2rot else pose.reshape(N, J, 3, 3)
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(N, -1)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(N, -1, 3)
    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)
    T = torch.einsum("vj,njab->nvab", lbs_weights, A)
    verts = torch.einsum("nvab,nvb->nva", T[..., :3, :3], v_posed) + T[..., :3, 3]
    return verts, posed_joints


def inv_lbs(verts_posed, weights, v_shaped_template, pose, posedirs_offsets, J_regressor,
            parents, pose2rot: bool = True):
    """Un-pose vertices back to the rest pose (drive.py:242-253, Avatar2FBX
    ply_utils.py:91-102): the joints of ``v_shaped_template`` (N, Vt, 3), the
    per-vertex blended transform of ``weights`` (V, J) at ``pose``, its 3x3
    block inverted in f32 (a convex combination of rotations is not a
    rotation), then the pose blend offsets (N, V, 3) subtracted if given."""
    N, J = pose.shape[0], J_regressor.shape[0]
    joints = vertices2joints(J_regressor, v_shaped_template)
    rot_mats = rodrigues(pose.reshape(N, J, 3)) if pose2rot else pose.reshape(N, J, 3, 3)
    _, A = batch_rigid_transform(rot_mats, joints, parents)
    T = torch.einsum("vj,njab->nvab", weights, A)
    M_inv = torch.linalg.inv(T[..., :3, :3])
    unposed = torch.einsum("nvab,nvb->nva", M_inv, verts_posed - T[..., :3, 3])
    if posedirs_offsets is not None:
        unposed = unposed - posedirs_offsets
    return unposed
