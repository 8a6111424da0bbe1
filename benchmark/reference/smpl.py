"""SMPL's linear blend skinning in plain float32 (Loper et al. 2015):
Rodrigues' rotations of the axis-angle pose, the pose-corrective offsets,
forward kinematics down the kinematic tree and the weighted joint
transforms applied to the shaped template."""

from __future__ import annotations

import numpy as np
import torch


def rodrigues(rv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3); the angle is |v + eps| as in SMPL."""
    shape = rv.shape[:-1]
    rv = rv.reshape(-1, 3)
    angle = (rv + eps).norm(dim=-1, keepdim=True)
    k = rv / angle
    z = torch.zeros_like(k[:, 0])
    K = torch.stack([z, -k[:, 2], k[:, 1], k[:, 2], z, -k[:, 0], -k[:, 1], k[:, 0], z], -1).reshape(-1, 3, 3)
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    rot = torch.eye(3, dtype=rv.dtype, device=rv.device) + s * K + (1.0 - c) * (K @ K)
    return rot.reshape(*shape, 3, 3)


def skin(model: dict, pose: torch.Tensor, betas: torch.Tensor | None = None) -> torch.Tensor:
    """model: v_template (V, 3), shapedirs (V, 3, B), posedirs (9 (J - 1),
    3 V), J_regressor (J, V), weights (V, J), parents (J,); pose (N, J, 3)
    axis-angle, the global orientation first -> vertices (N, V, 3)."""
    N, J = pose.shape[0], pose.shape[1]
    v = model["v_template"][None].expand(N, -1, -1)
    if betas is not None:
        v = v + torch.einsum("nb,vcb->nvc", betas, model["shapedirs"])
    joints = torch.einsum("jv,nvc->njc", model["J_regressor"], v)
    rot = rodrigues(pose)
    feat = (rot[:, 1:] - torch.eye(3, device=pose.device)).reshape(N, -1)
    v = v + (feat @ model["posedirs"]).reshape(N, -1, 3)
    parents = np.asarray(model["parents"])
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=pose.device).expand(N, 1, 4)
    local = [torch.cat([torch.cat([rot[:, j], rel[:, j, :, None]], -1), bottom], -2) for j in range(J)]
    world = [local[0]]
    for j in range(1, J):
        world.append(world[parents[j]] @ local[j])
    A = torch.stack(world, 1)
    rest = torch.einsum("njab,njb->nja", A[..., :3, :3], joints)
    A = torch.cat([A[..., :3, :3], (A[..., :3, 3] - rest)[..., None]], -1)  # (N, J, 3, 4)
    T = torch.einsum("vj,njab->nvab", model["weights"], A)
    return torch.einsum("nvab,nvb->nva", T[..., :3], v) + T[..., 3]
