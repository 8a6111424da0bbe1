"""NeuS's hierarchical volume rendering in plain float32 (NeuS,
renderer.py): stratified samples between the unit sphere's near and far,
``up_sample_steps`` importance refinements at inv_s = 64 * 2^i, then the
logistic-CDF alpha with cos annealing, the transmittance, the composite,
the weighted normals and the eikonal term over the points within radius
1.2. Per ray only, as a training step reads it."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import nets
from .precision import F32, Precision


def sample_pdf(bins, weights, n_samples: int):
    """Deterministic inverse-CDF samples at the bin midpoints."""
    R = bins.shape[0]
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, device=bins.device)
    u = u.expand(R, n_samples).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def up_sample(rays_o, rays_d, z, sdf, n_new: int, inv_s: float):
    r2 = (rays_o * rays_o).sum(-1, keepdim=True) + (
        2.0 * (rays_o * rays_d).sum(-1, keepdim=True) + (rays_d * rays_d).sum(-1, keepdim=True) * z) * z
    inside = (r2[:, :-1] < 1.0) | (r2[:, 1:] < 1.0)
    mid_sdf = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    cos = torch.minimum(torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1), cos)
    cos = cos.clamp(-1e3, 0.0) * inside
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid_sdf - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1)[:, :-1]
    return sample_pdf(z, alpha * trans, n_new)


def sample_depths(params, sdf_cfg, ncfg, rays_o, rays_d, near, far, t_in, prec: Precision = F32):
    """The (R, n_samples + n_importance) sorted sample depths."""
    ns = int(ncfg["n_samples"])
    z = near + (far - near) * torch.linspace(0.0, 1.0, ns, device=rays_o.device)[None]
    if t_in is not None:
        z = z + (t_in - 0.5) * 2.0 / ns
    steps = int(ncfg["up_sample_steps"])
    n_new = int(ncfg["n_importance"]) // steps if steps else 0
    with torch.no_grad():
        def sdf_at(zs):
            pts = rays_o[:, None] + rays_d[:, None] * zs[..., None]
            return nets.sdf_forward(params, sdf_cfg, pts.reshape(-1, 3), prec,
                                    sdf_only=True).reshape(zs.shape)

        sdf = sdf_at(z)
        for i in range(steps):
            new_z = up_sample(rays_o, rays_d, z, sdf, n_new, 64.0 * 2**i)
            z_all = torch.cat([z, new_z], -1)
            z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
            if i + 1 < steps:
                sdf = torch.cat([sdf, sdf_at(new_z)], -1).gather(1, order)
            z = z_sorted
    return z


def _core(params, sdf_cfg, col_cfg, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal, prec):
    R, S = mid_z.shape
    pts = (rays_o[:, None] + rays_d[:, None] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None].expand(R, S, 3).reshape(-1, 3)
    sdf, feat, g = nets.sdf_with_gradient(params, sdf_cfg, pts, prec)
    rgb = nets.color_forward(params, col_cfg, pts, g, feat, prec)
    tc = (dirs * g).sum(-1).reshape(R, S)
    r = cos_anneal
    iter_cos = -(torch.relu(-tc * 0.5 + 0.5) * (1.0 - r) + torch.relu(-tc) * r)
    s = sdf.reshape(R, S)
    prev_cdf = torch.sigmoid((s - iter_cos * dists * 0.5) * inv_s)
    next_cdf = torch.sigmoid((s + iter_cos * dists * 0.5) * inv_s)
    alpha = ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1)[:, :-1]
    w = (alpha * trans)[..., None]
    col_w = (w * rgb.reshape(R, S, -1)).sum(1)
    normals_w = (w * g.reshape(R, S, 3)).sum(1)
    ws = w.sum(1)
    relax = ((pts * pts).sum(-1) < 1.44).float()
    ge = (torch.sqrt((g * g).sum(-1) + 1e-12) - 1.0) ** 2
    return col_w, normals_w, ws, (relax * ge).sum(), relax.sum()


def render(params, sdf_cfg, col_cfg, ncfg, rays_o, rays_d, near, far, t_in,
           background_rgb=None, cos_anneal: float = 1.0, prec: Precision = F32,
           chunk: int = 4096) -> dict:
    """Per-ray outputs: color (R, 3), extra_color (R, 3) or None, weight_sum
    (R, 1), normals_weighted (R, 3), gradient_error (the eikonal loss).
    The points' pass runs in chunks of rays, each recomputed in the
    backward (torch.utils.checkpoint), so that the double backward of the
    eikonal term fits at a training step's size."""
    z = sample_depths(params, sdf_cfg, ncfg, rays_o, rays_d, near, far, t_in, prec)
    sample_dist = 2.0 / int(ncfg["n_samples"])
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], sample_dist)], -1)
    mid_z = z + dists * 0.5
    s_inv = nets.inv_s(params)
    outs = []
    for a in range(0, rays_o.shape[0], chunk):
        sl = slice(a, a + chunk)
        args = (rays_o[sl], rays_d[sl], mid_z[sl], dists[sl], s_inv, cos_anneal, prec)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_core, params, sdf_cfg, col_cfg, *args, use_reentrant=False))
        else:
            outs.append(_core(params, sdf_cfg, col_cfg, *args))
    col_w = torch.cat([o[0] for o in outs])
    normals_w = torch.cat([o[1] for o in outs])
    ws = torch.cat([o[2] for o in outs])
    num = sum(o[3] for o in outs)
    den = sum(o[4] for o in outs)
    color = col_w[:, :3]
    extra = col_w[:, 3:6] if col_w.shape[1] == 6 else None
    if background_rgb is not None:
        if extra is not None:
            extra = extra + background_rgb * (1.0 - ws)
        else:
            color = color + background_rgb * (1.0 - ws)
    return {"color": color, "extra_color": extra, "weight_sum": ws, "normals_weighted": normals_w,
            "gradient_error": num / (den + 1e-5)}
