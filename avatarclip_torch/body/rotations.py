"""Rotation conversions (twin of avatarclip_tpu/body/rotations.py): axis-angle,
real-first quaternions, matrices and the 6d representation (first two rows),
batched over leading dimensions."""

from __future__ import annotations

import torch


def rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3); the angle is
    |v + eps| as in SMPL's batch_rodrigues."""
    batch_shape = rot_vecs.shape[:-1]
    rv = rot_vecs.reshape(-1, 3)
    angle = (rv + epsilon).norm(dim=-1, keepdim=True)
    rot_dir = rv / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], -1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rv.dtype, device=rv.device)
    rot = ident + sin * K + (1.0 - cos) * (K @ K)
    return rot.reshape(*batch_shape, 3, 3)


batch_rodrigues = rodrigues


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return rodrigues(axis_angle)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(-1, keepdim=True)
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) real-first, pytorch3d's stable branch choice."""
    batch_shape = matrix.shape[:-2]
    m = matrix.reshape(-1, 9)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22,
    ], -1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[:, 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[:, 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[:, 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[:, 3] ** 2], -1),
    ], -2)
    cand = quat_by_rijk / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(-1)
    quat = cand[torch.arange(cand.shape[0], device=cand.device), best]
    return quat.reshape(*batch_shape, 4)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    q = quaternions / quaternions.norm(dim=-1, keepdim=True)
    r, i, j, k = q.unbind(-1)
    o = torch.stack([
        1 - 2 * (j * j + k * k), 2 * (i * j - k * r), 2 * (i * k + j * r),
        2 * (i * j + k * r), 1 - 2 * (i * i + k * k), 2 * (j * k - i * r),
        2 * (i * k - j * r), 2 * (j * k + i * r), 1 - 2 * (i * i + j * j),
    ], -1)
    return o.reshape(*quaternions.shape[:-1], 3, 3)


def _sin_half_over_angle(angles, half_angles):
    small = angles.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    return torch.where(small, 0.5 - (angles * angles) / 48.0, torch.sin(half_angles) / safe)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    norms = _safe_norm(quaternions[..., 1:])
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    return quaternions[..., 1:] / _sin_half_over_angle(angles, half_angles)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = _safe_norm(axis_angle)
    half_angles = angles * 0.5
    s = _sin_half_over_angle(angles, half_angles)
    return torch.cat([torch.cos(half_angles), axis_angle * s], -1)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6d -> matrix by Gram-Schmidt on the two stored rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]

    def normalize(v):
        return v * torch.rsqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-12))

    b1 = normalize(a1)
    b2 = normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)
