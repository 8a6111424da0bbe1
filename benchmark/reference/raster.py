"""Mesh rasterization in plain float32: the pinhole projection of the
NeuS cameras (looking down -z, y up on screen), each face's barycentric
edge functions and screen-linear inverse depth, the brute-force z-buffer
(every pixel centre against every face: inside where the three
barycentrics are >= 0, the nearest by inverse depth, ties to the higher
face id), two-sided Lambert shading of a white body under a +y light
(ambient 0.5, diffuse 0.5, smooth vertex normals), and SoftRas's
aggregation (Liu et al. 2019) with the signed pixel distance to the nearest
edge, sigmoid coverage, the silhouette product and the depth-weighted colour
with a background of weight 1."""

from __future__ import annotations

import torch
import torch.nn.functional as F

MIN_AREA2 = 1e-3  # faces below this doubled screen area (px^2) are not drawn


def project(vertices, pose, H: int, W: int, focal: float):
    """(sx, sy, inv_z, in_front), each (..., V)."""
    R, t = pose[..., :3, :3], pose[..., :3, 3]
    v_cam = (vertices - t[..., None, :]) @ R
    depth = -v_cam[..., 2]
    in_front = depth > 1e-6
    inv_z = torch.where(in_front, 1.0 / torch.where(in_front, depth, torch.ones_like(depth)),
                        torch.zeros_like(depth))
    return (W * 0.5 + focal * v_cam[..., 0] * inv_z, H * 0.5 - focal * v_cam[..., 1] * inv_z,
            inv_z, in_front)


def face_coefficients(sx, sy, inv_z, in_front, faces):
    """(coef (..., F, 3, 4): [cx, cy, c1] of barycentrics a, b, c and of the
    inverse depth, per face; valid (..., F); edge scale (..., F, 3) turning
    each barycentric into a pixel distance to its edge)."""
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    A = torch.stack([sx[..., i0], sy[..., i0]], -1)
    B = torch.stack([sx[..., i1], sy[..., i1]], -1)
    C = torch.stack([sx[..., i2], sy[..., i2]], -1)

    def edge(P0, P1):
        dx, dy = P1[..., 0] - P0[..., 0], P1[..., 1] - P0[..., 1]
        return torch.stack([-dy, dx, dy * P0[..., 0] - dx * P0[..., 1]], -1), torch.stack([dx, dy], -1)

    (e_bc, d_bc), (e_ca, d_ca), (e_ab, d_ab) = edge(B, C), edge(C, A), edge(A, B)
    area2 = e_ab[..., 0] * C[..., 0] + e_ab[..., 1] * C[..., 1] + e_ab[..., 2]
    orient = torch.sign(area2)
    orient = torch.where(orient == 0, torch.ones_like(orient), orient)
    inv_area = orient / area2.abs().clamp_min(MIN_AREA2)
    ba, bb, bc = e_bc * inv_area[..., None], e_ca * inv_area[..., None], e_ab * inv_area[..., None]
    iz = ba * inv_z[..., i0, None] + bb * inv_z[..., i1, None] + bc * inv_z[..., i2, None]
    coef = torch.stack([ba, bb, bc, iz], -1)
    valid = in_front[..., i0] & in_front[..., i1] & in_front[..., i2] & (area2.abs() > MIN_AREA2)
    length = lambda d: torch.sqrt((d * d).sum(-1) + 1e-12)
    edge_len = torch.stack([length(d_bc), length(d_ca), length(d_ab)], -1)
    return coef, valid, area2.abs()[..., None] / edge_len.clamp_min(1e-12)


def pixel_centres(H: int, W: int, device):
    py, px = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def lin3(px, py, c0, c1, c2):
    return (px * c0 + py * c1) + c2


def zbuffer(coef, valid, H: int, W: int, chunk: int = 512) -> torch.Tensor:
    """(H*W,) face id of each pixel's nearest covering face, -1 for none."""
    dev = coef.device
    px, py = pixel_centres(H, W, dev)
    px, py = px[:, None], py[:, None]
    best_iz = torch.full((H * W,), -1.0, device=dev)
    best = torch.full((H * W,), -1, dtype=torch.long, device=dev)
    for f0 in range(0, coef.shape[0], chunk):
        c = coef[f0:f0 + chunk]
        b0, b1, b2, iz = (lin3(px, py, c[None, :, 0, k], c[None, :, 1, k], c[None, :, 2, k])
                          for k in range(4))
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (iz > 0) & valid[None, f0:f0 + chunk]
        iz_in = torch.where(inside, iz, torch.full_like(iz, -1.0))
        top = iz_in.max(1).values
        ids = torch.arange(f0, f0 + c.shape[0], device=dev)
        cand = torch.where((iz_in == top[:, None]) & inside, ids[None], -1).max(1).values
        take = (top > best_iz) | ((top == best_iz) & (cand > best))
        best_iz = torch.where(take, top, best_iz)
        best = torch.where(take, cand, best)
    return best


def vertex_normals(vertices, faces):
    fv = vertices[faces]
    fn = torch.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
    n = torch.zeros_like(vertices)
    for i in range(3):
        n.index_add_(0, faces[:, i], fn)
    return n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def render_hard(vertices, faces, pose, H: int, W: int, focal: float, normals):
    """(rgb (H, W, 3), hit (H, W)): the shaded white body, black elsewhere."""
    sx, sy, inv_z, front = project(vertices, pose, H, W, focal)
    coef, valid, _ = face_coefficients(sx, sy, inv_z, front, faces)
    best = zbuffer(coef, valid, H, W)
    hit = best >= 0
    fid = best.clamp_min(0)
    px, py = pixel_centres(H, W, vertices.device)
    c = coef[fid]
    bary = lin3(px[:, None], py[:, None], c[:, 0, :3], c[:, 1, :3], c[:, 2, :3]).clamp(0.0, 1.0)
    bary = bary / bary.sum(-1, keepdim=True).clamp_min(1e-12)
    n = (bary[:, :, None] * normals[faces][fid]).sum(1)
    n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    shade = 0.5 + 0.5 * n[:, 1].abs()
    rgb = (bary.sum(-1, keepdim=True).expand(-1, 3) * shade[:, None]).clamp(0.0, 1.0)
    rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
    return rgb.reshape(H, W, 3), hit.reshape(H, W)


def dilate(mask, k: int):
    """Binary dilation by a (2k + 1)^2 square."""
    return F.max_pool2d(mask.float()[None, None], 2 * k + 1, stride=1, padding=k)[0, 0] > 0.5


def soft_render(vertices, faces, pose, H: int, W: int, focal: float, sigma: float,
                gamma: float = 0.005, chunk: int = 256):
    """SoftRas of a white body, a batch of views (B, V, 3) with (B, 4, 4):
    rgb (B, H, W, 3). A face's colour is its flat two-sided Lambert shade;
    each pixel's coverage of it sigmoid(d / sigma) with d the signed
    distance to its nearest edge (positive inside), its depth weight
    exp(clip(inv_z / gamma, -60, 60)) at the mean of its corners' inverse
    depths; rgb = sum_f w c / (sum_f w + 1). Faces in chunks, each
    recomputed in the backward."""
    B = vertices.shape[0]
    sx, sy, inv_z, front = project(vertices, pose, H, W, focal)
    coef, valid, scale = face_coefficients(sx, sy, inv_z, front, faces)
    fv = vertices[:, faces]
    fn = torch.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0], dim=-1)
    fn = fn / torch.sqrt((fn * fn).sum(-1, keepdim=True) + 1e-12)
    col = (0.5 + 0.5 * fn[..., 1].abs()).clamp(0.0, 1.0)
    iz_face = (inv_z[:, faces[:, 0]] + inv_z[:, faces[:, 1]] + inv_z[:, faces[:, 2]]) / 3.0
    ezf = torch.exp(torch.clamp(iz_face / gamma, -60.0, 60.0))
    cs = coef[..., :3].transpose(-1, -2) * scale[..., None]  # (B, F, edge, [cx, cy, c1])
    vm = valid.float()
    px, py = pixel_centres(H, W, vertices.device)
    px, py = px[None, :, None], py[None, :, None]

    def part(cs_c, ezf_c, col_c, vm_c):
        d = torch.stack([lin3(px, py, cs_c[:, None, :, e, 0], cs_c[:, None, :, e, 1],
                              cs_c[:, None, :, e, 2]) for e in range(3)], -1).amin(-1)
        w = torch.sigmoid(d / sigma) * (vm_c * ezf_c)[:, None, :]
        return (w * col_c[:, None, :]).sum(-1), w.sum(-1)

    num = den = 0.0
    for f0 in range(0, faces.shape[0], chunk):
        s = slice(f0, f0 + chunk)
        a = (cs[:, s], ezf[:, s], col[:, s], vm[:, s])
        n, d = (torch.utils.checkpoint.checkpoint(part, *a, use_reentrant=False)
                if torch.is_grad_enabled() else part(*a))
        num, den = num + n, den + d
    rgb = num / (den + 1.0 + 1e-20)
    return rgb.reshape(B, H, W, 1).expand(B, H, W, 3)
