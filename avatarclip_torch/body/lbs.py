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
