"""Hard mesh rasterizer: projection, face coefficients, z-buffer, shading.

Twin of avatarclip_tpu/render/raster.py (`project_vertices`,
`_face_coefficients`, `rasterize`, `_winner_outputs`, `_sample_texture`,
`vertex_normals`, `render_mesh`, `soft_render_mesh`). The winner of every
pixel comes from the tiled z-buffer (ops/raster_zbuffer.py): exact f32
inverse depth, ties to the higher face id, on every device — the JAX
package's CPU scan with its quantised key is not ported. The soft render
aggregates through ops/fused_soft.py on every device (its plain version on
the CPU, as the JAX CPU scan ``_soft_core`` computes it). All K=3
screen-space dots are plain f32 (the entry points disable TF32): thin faces
decide inside/outside on values near zero. Projection and face coefficients
take an optional leading batch of views.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import fused_soft, raster_zbuffer
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
    """World -> pixel projection with the ray generator's pinhole model;
    vertices (..., V, 3) and pose (..., 4, 4) share their leading dims."""
    R, t = pose[..., :3, :3], pose[..., :3, 3]
    v_cam = (vertices - t[..., None, :]) @ R  # R^T (v - t), K=3 in f32
    depth = -v_cam[..., 2]
    in_front = depth > 1e-6
    safe = torch.where(in_front, depth, torch.ones_like(depth))
    inv_z = torch.where(in_front, 1.0 / safe, torch.zeros_like(depth))
    sx = W * 0.5 + focal * v_cam[..., 0] * inv_z
    sy = H * 0.5 - focal * v_cam[..., 1] * inv_z
    return Projected(sx, sy, inv_z, in_front)


def _face_coefficients(proj: Projected, faces: torch.Tensor):
    """(coef (..., F, 3, 4), valid (..., F), edge_inv_len (..., F, 3)): per
    face the oriented barycentric edge functions and the screen-linear
    inverse depth, each [cx, cy, c1] in the pixel (px, py, 1), and the
    scales that turn each barycentric into a pixel distance to its edge."""
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    A = torch.stack([proj.sx[..., i0], proj.sy[..., i0]], -1)
    B = torch.stack([proj.sx[..., i1], proj.sy[..., i1]], -1)
    C = torch.stack([proj.sx[..., i2], proj.sy[..., i2]], -1)

    def edge(P0, P1):
        dx = P1[..., 0] - P0[..., 0]
        dy = P1[..., 1] - P0[..., 1]
        return torch.stack([-dy, dx, dy * P0[..., 0] - dx * P0[..., 1]], -1), torch.stack([dx, dy], -1)

    (e_bc, d_bc), (e_ca, d_ca), (e_ab, d_ab) = edge(B, C), edge(C, A), edge(A, B)
    area2 = e_ab[..., 0] * C[..., 0] + e_ab[..., 1] * C[..., 1] + e_ab[..., 2]
    orient = torch.sign(area2)
    orient = torch.where(orient == 0, torch.ones_like(orient), orient)
    inv_area = orient / area2.abs().clamp_min(_MIN_AREA2)
    bary_a = e_bc * inv_area[..., None]
    bary_b = e_ca * inv_area[..., None]
    bary_c = e_ab * inv_area[..., None]
    iz = (
        bary_a * proj.inv_z[..., i0, None]
        + bary_b * proj.inv_z[..., i1, None]
        + bary_c * proj.inv_z[..., i2, None]
    )
    coef = torch.stack([bary_a, bary_b, bary_c, iz], dim=-1)  # (..., F, 3, 4)
    valid = (
        proj.in_front[..., i0] & proj.in_front[..., i1] & proj.in_front[..., i2]
        & (area2.abs() > _MIN_AREA2)
    )

    def safe_len(d):
        # the eps keeps the gradient finite at the zero-length edges of
        # degenerate (padding) faces
        return torch.sqrt((d * d).sum(-1) + 1e-12)

    edge_len = torch.stack([safe_len(d_bc), safe_len(d_ca), safe_len(d_ab)], -1)
    edge_inv_len = area2.abs()[..., None] / edge_len.clamp_min(1e-12)
    return coef, valid, edge_inv_len


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
    coef, valid, _ = _face_coefficients(proj, faces)
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


def _sample_texture(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (P, 2) uv in [0, 1] (v up) from an (Ht, Wt, 3) image."""
    Ht, Wt = texture.shape[0], texture.shape[1]
    x = uv[:, 0].clamp(0.0, 1.0) * (Wt - 1)
    y = (1.0 - uv[:, 1].clamp(0.0, 1.0)) * (Ht - 1)
    x0 = x.floor().long().clamp(0, Wt - 2)
    y0 = y.floor().long().clamp(0, Ht - 2)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return (texture[y0, x0] * (1 - fx) * (1 - fy) + texture[y0, x0 + 1] * fx * (1 - fy)
            + texture[y0 + 1, x0] * (1 - fx) * fy + texture[y0 + 1, x0 + 1] * fx * fy)


def _unit_light(light_dir, device) -> torch.Tensor:
    light = torch.tensor([0.0, 1.0, 0.0], device=device) if light_dir is None else \
        torch.as_tensor(light_dir, dtype=torch.float32, device=device)
    return light / light.norm()


def render_mesh(vertices: torch.Tensor, faces: torch.Tensor, pose: torch.Tensor,
                H: int, W: int, focal: float, vertex_colors: torch.Tensor | None = None,
                light_dir=None, ambient: float = 0.5, diffuse: float = 0.5,
                background: float = 0.0, face_uvs: torch.Tensor | None = None,
                texture: torch.Tensor | None = None, normals: torch.Tensor | None = None,
                face_normals: torch.Tensor | None = None):
    """Two-sided-lambert shaded hard render -> dict(rgb (H, W, 3), mask
    (H, W), depth (H, W), face_id (H, W)). White unless ``vertex_colors``
    (V, 3) or ``face_uvs`` (F, 3, 2) with a ``texture`` (Ht, Wt, 3) are
    given; ``light_dir`` defaults to +y. Pass ``normals`` / ``face_normals``
    precomputed for a static mesh (the GT template render of train_clip)."""
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
    lambert = (n_pix * _unit_light(light_dir, vertices.device)).sum(-1).abs()
    shade = ambient + diffuse * lambert
    if face_uvs is not None and texture is not None:
        uv = (bary[:, :, None] * face_uvs[fid]).sum(1)  # (P, 2)
        c_pix = _sample_texture(texture, uv)
    elif vertex_colors is None:
        c_pix = bary.sum(-1, keepdim=True).expand(-1, 3)  # white
    else:
        c_pix = (bary[:, :, None] * vertex_colors[faces][fid]).sum(1)
    rgb = (c_pix * shade[:, None]).clamp(0.0, 1.0)
    rgb = torch.where(hit[:, None], rgb, torch.full_like(rgb, background))
    depth = torch.where(hit, 1.0 / inv_z.clamp_min(1e-12), torch.zeros_like(inv_z))
    return {
        "rgb": rgb.reshape(H, W, 3),
        "mask": hit.reshape(H, W),
        "depth": depth.reshape(H, W),
        "face_id": face_id.reshape(H, W),
    }


def soft_face_inputs(vertices: torch.Tensor, faces: torch.Tensor, pose: torch.Tensor, H: int,
                     W: int, focal: float) -> dict:
    """The per-face inputs of the soft aggregation for a batch of views
    (vertices (B, V, 3), pose (B, 4, 4)): coef, valid, edge_inv_len, iz_face,
    colors_face (white, flat two-sided lambert shading under +y light) and
    the corners' face_sx / face_sy."""
    faces = faces.long()
    proj = project_vertices(vertices, pose, H, W, focal)
    coef, valid, edge_inv_len = _face_coefficients(proj, faces)
    fv = vertices[:, faces]  # (B, F, 3, 3)
    fn = torch.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0], dim=-1)
    fn = fn / torch.sqrt((fn * fn).sum(-1, keepdim=True) + 1e-12)
    shade = 0.5 + 0.5 * fn[..., 1].abs()  # ambient + diffuse * |n . y|
    return {
        "coef": coef, "valid": valid, "edge_inv_len": edge_inv_len,
        "iz_face": (proj.inv_z[:, faces[:, 0]] + proj.inv_z[:, faces[:, 1]]
                    + proj.inv_z[:, faces[:, 2]]) / 3.0,
        "colors_face": shade[..., None].expand(*shade.shape, 3).clamp(0.0, 1.0),
        "face_sx": proj.sx[:, faces], "face_sy": proj.sy[:, faces],
    }


def soft_render_mesh(vertices: torch.Tensor, faces: torch.Tensor, pose: torch.Tensor,
                     H: int, W: int, focal: float, sigma: float = 1.0, gamma: float = 0.005,
                     background: float = 0.0):
    """Differentiable SoftRas-style render of a white body -> dict(rgb (..., H,
    W, 3), silhouette (..., H, W)). ``vertices`` (V, 3) with ``pose`` (4, 4),
    or a batch of views (B, V, 3) with (B, 4, 4): one kernel launch each way
    serves the whole batch. Gradients reach the vertices through the
    edge-distance sigmoids and the depth softmax; ``sigma`` is in pixels,
    ``gamma`` tempers the depth blending."""
    single = vertices.dim() == 2
    if single:
        vertices, pose = vertices[None], pose[None]
    fi = soft_face_inputs(vertices, faces, pose, H, W, focal)
    sil_prod, num, den = fused_soft.soft_aggregate(
        fi["coef"], fi["valid"], fi["edge_inv_len"], fi["iz_face"], fi["colors_face"], H, W,
        sigma, gamma, fi["face_sx"], fi["face_sy"])
    eps = 1e-20
    w_bg = 1.0  # exp(0 / gamma): the background sits at inverse depth 0
    rgb = (num + w_bg * background) / (den[..., None] + w_bg + eps)
    out = {"rgb": rgb.reshape(-1, H, W, 3), "silhouette": (1.0 - sil_prod).reshape(-1, H, W)}
    return {k: v[0] for k, v in out.items()} if single else out
