"""Hard mesh rasterizer: projection, face coefficients, z-buffer, shading.

Twin of avatarclip_tpu/render/raster.py (`project_vertices`,
`_face_coefficients`, `rasterize`, `_winner_outputs`, `vertex_normals`,
`render_mesh`). The winner of every pixel comes from the tiled z-buffer
(ops/raster_zbuffer.py): exact f32 inverse depth, ties to the higher face id,
on every device — the JAX package's CPU scan with its quantised key is not
ported. All K=3 screen-space dots are plain f32 (the entry points disable
TF32): thin faces decide inside/outside on values near zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import raster_zbuffer
from ..ops.raster_zbuffer import lin3

# faces below this doubled screen area (px^2) are gated invalid: invisible to
# pixel-centre sampling, and their coefficients would lose boundedness
_MIN_AREA2 = 1e-3


class Projected(NamedTuple):
    sx: torch.Tensor  # (V,) screen x (pixels)
    sy: torch.Tensor  # (V,) screen y
    inv_z: torch.Tensor  # (V,) 1 / depth (0 behind the camera)
    in_front: torch.Tensor  # (V,) bool


def project_vertices(vertices: torch.Tensor, pose: torch.Tensor, H: int, W: int,
                     focal: float) -> Projected:
    """World -> pixel projection with the ray generator's pinhole model."""
    R, t = pose[:3, :3], pose[:3, 3]
    v_cam = (vertices - t) @ R  # R^T (v - t), K=3 in f32
    depth = -v_cam[:, 2]
    in_front = depth > 1e-6
    safe = torch.where(in_front, depth, torch.ones_like(depth))
    inv_z = torch.where(in_front, 1.0 / safe, torch.zeros_like(depth))
    sx = W * 0.5 + focal * v_cam[:, 0] * inv_z
    sy = H * 0.5 - focal * v_cam[:, 1] * inv_z
    return Projected(sx, sy, inv_z, in_front)


def _face_coefficients(proj: Projected, faces: torch.Tensor):
    """(coef (F, 3, 4), valid (F,)): per face the oriented barycentric edge
    functions and the screen-linear inverse depth, each [cx, cy, c1] in the
    pixel (px, py, 1)."""
    A = torch.stack([proj.sx[faces[:, 0]], proj.sy[faces[:, 0]]], -1)
    B = torch.stack([proj.sx[faces[:, 1]], proj.sy[faces[:, 1]]], -1)
    C = torch.stack([proj.sx[faces[:, 2]], proj.sy[faces[:, 2]]], -1)

    def edge(P0, P1):
        dx = P1[:, 0] - P0[:, 0]
        dy = P1[:, 1] - P0[:, 1]
        return torch.stack([-dy, dx, dy * P0[:, 0] - dx * P0[:, 1]], -1)

    e_bc, e_ca, e_ab = edge(B, C), edge(C, A), edge(A, B)
    area2 = e_ab[:, 0] * C[:, 0] + e_ab[:, 1] * C[:, 1] + e_ab[:, 2]
    orient = torch.sign(area2)
    orient = torch.where(orient == 0, torch.ones_like(orient), orient)
    inv_area = orient / area2.abs().clamp_min(_MIN_AREA2)
    bary_a = e_bc * inv_area[:, None]
    bary_b = e_ca * inv_area[:, None]
    bary_c = e_ab * inv_area[:, None]
    iz = (
        bary_a * proj.inv_z[faces[:, 0], None]
        + bary_b * proj.inv_z[faces[:, 1], None]
        + bary_c * proj.inv_z[faces[:, 2], None]
    )
    coef = torch.stack([bary_a, bary_b, bary_c, iz], dim=-1)  # (F, 3, 4)
    valid = (
        proj.in_front[faces[:, 0]] & proj.in_front[faces[:, 1]] & proj.in_front[faces[:, 2]]
        & (area2.abs() > _MIN_AREA2)
    )
    return coef, valid


def _pixel_coords(H: int, W: int, device):
    py, px = torch.meshgrid(
        torch.arange(H, device=device, dtype=torch.float32),
        torch.arange(W, device=device, dtype=torch.float32), indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def _winner_outputs(px, py, coef, best_face):
    """Barycentrics and exact inverse depth of each pixel's winning face."""
    hit = best_face >= 0
    fid = torch.where(hit, best_face, torch.zeros_like(best_face)).long()
    c = coef[fid]  # (P, 3, 4)
    bary = lin3(px[:, None], py[:, None], c[:, 0, :3], c[:, 1, :3], c[:, 2, :3])
    bary = bary.clamp(0.0, 1.0)
    bary = bary / bary.sum(-1, keepdim=True).clamp_min(1e-12)
    iz = lin3(px, py, c[:, 0, 3], c[:, 1, 3], c[:, 2, 3])
    return best_face, bary, torch.where(hit, iz, torch.zeros_like(iz))


def rasterize(proj: Projected, faces: torch.Tensor, H: int, W: int):
    """Hard z-buffer pass -> (face_id (P,) int32 [-1 = background], bary
    (P, 3), inv_z (P,))."""
    coef, valid = _face_coefficients(proj, faces)
    best = raster_zbuffer.zbuffer_select_tiled(
        coef, valid, proj.sx[faces], proj.sy[faces], H, W
    )
    px, py = _pixel_coords(H, W, coef.device)
    return _winner_outputs(px, py, coef, best)


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted smooth vertex normals."""
    fv = vertices[faces]  # (F, 3, 3)
    fn = torch.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
    n = torch.zeros_like(vertices)
    for i in range(3):
        n.index_add_(0, faces[:, i], fn)
    return n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def render_mesh(vertices: torch.Tensor, faces: torch.Tensor, pose: torch.Tensor,
                H: int, W: int, focal: float, ambient: float = 0.5,
                diffuse: float = 0.5, background: float = 0.0,
                normals: torch.Tensor | None = None,
                face_normals: torch.Tensor | None = None):
    """White, two-sided-lambert shaded hard render (the GT template render of
    train_clip) -> dict(rgb (H, W, 3), mask (H, W), depth (H, W),
    face_id (H, W)). Pass ``normals`` / ``face_normals`` precomputed for a
    static mesh."""
    faces = faces.long()
    proj = project_vertices(vertices, pose, H, W, focal)
    if face_normals is None:
        if normals is None:
            normals = vertex_normals(vertices, faces)
        face_normals = normals[faces]  # (F, 3, 3)
    face_id, bary, inv_z = rasterize(proj, faces, H, W)
    hit = face_id >= 0
    fid = torch.where(hit, face_id, torch.zeros_like(face_id)).long()
    n_pix = (bary[:, :, None] * face_normals[fid]).sum(1)
    n_pix = n_pix / n_pix.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    light = torch.tensor([0.0, 1.0, 0.0], device=vertices.device)
    lambert = (n_pix * light).sum(-1).abs()
    shade = ambient + diffuse * lambert
    c_pix = bary.sum(-1, keepdim=True).expand(-1, 3)  # white template
    rgb = (c_pix * shade[:, None]).clamp(0.0, 1.0)
    rgb = torch.where(hit[:, None], rgb, torch.full_like(rgb, background))
    depth = torch.where(hit, 1.0 / inv_z.clamp_min(1e-12), torch.zeros_like(inv_z))
    return {
        "rgb": rgb.reshape(H, W, 3),
        "mask": hit.reshape(H, W),
        "depth": depth.reshape(H, W),
        "face_id": face_id.reshape(H, W),
    }
