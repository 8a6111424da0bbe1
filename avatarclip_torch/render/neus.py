"""NeuS volume renderer (twin of avatarclip_tpu/render/neus.py).

`sample_pdf`, `up_sample`, `cat_z_vals`, `render_core_outside`,
`render_core` and `render`, with the same formulas (logistic-CDF alpha, cos
annealing, eikonal weighting, the NeRF++ background blend).
``torch.searchsorted`` / ``torch.sort`` / ``torch.gather`` stand in for the
JAX package's rank merges and one-hot gathers. With the kernel gate open,
`render_core` runs the per-ray megakernel pair (ops/fused_neus.py) with
``per_ray=True`` and returns per-ray quantities only, or with
``per_ray=False`` the point-level pair followed by the compositing pair
(ops/fused_composite.py) and returns every per-sample key plus
``normals_weighted``. With the gate closed, which a background always closes,
it is the per-sample path: the SDF and the colour net through
``fields.networks.sdf_with_gradient`` / ``color_eval``, which run the B6 / B7
kernel pairs on the card at >= 256 wide and the plain modules otherwise.

With ``n_outside > 0`` (the fields then need a NeRF) the background is
evaluated at the sorted union of the inner and the outside samples, as in
the reference and the JAX package: ``background_alpha[:, :S]`` blends with
the inner samples by index in that union, its last ``dists`` is
``sample_dist``, the compositing runs over all S + n_outside samples, and
with ``extra_color`` only the main colour is blended (the extra colour
composites over ``weights[:, :S]``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..fields import networks as nets
from ..ops import fused_composite, fused_neus

# test hook: None = gate on device / config; True / False forces the
# megakernel path on / off (on a CPU tensor it runs the kernels' plain versions)
_FORCE_MEGA: bool | None = None
# narrower nets stay on the plain path (as in the JAX package)
_MIN_KERNEL_WIDTH = 128


@dataclasses.dataclass(frozen=True)
class NeuSConfig:
    n_samples: int = 32
    n_importance: int = 32
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0
    extra_color: bool = False


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Deterministic inverse-CDF sampling at bin midpoints (renderer.py:39-69)."""
    R = bins.shape[0]
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)  # (R, B)
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, device=bins.device)
    u = u.expand(R, n_samples).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_g0, cdf_g1 = cdf.gather(1, below), cdf.gather(1, above)
    bins_g0, bins_g1 = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int, inv_s: float):
    """One importance-sampling refinement step (renderer.py:133-177)."""
    o2 = (rays_o * rays_o).sum(-1, keepdim=True)
    od = (rays_o * rays_d).sum(-1, keepdim=True)
    d2 = (rays_d * rays_d).sum(-1, keepdim=True)
    r2 = o2 + (2.0 * od + d2 * z_vals) * z_vals
    inside_sphere = (r2[:, :-1] < 1.0) | (r2[:, 1:] < 1.0)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], -1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = cos_val.clamp(-1e3, 0.0) * inside_sphere
    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1
    )[:, :-1]
    return sample_pdf(z_vals, alpha * trans, n_importance)


def cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z_vals, sdf, last: bool):
    """Merge new sorted samples into the sorted ray samples
    (renderer.py:179-193); equal values keep the old sample first."""
    z_all = torch.cat([z_vals, new_z_vals], -1)
    z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
    if last:
        return z_sorted, sdf
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., None]
    new_sdf = sdf_fn(pts.reshape(-1, 3)).reshape(new_z_vals.shape)
    return z_sorted, torch.cat([sdf, new_sdf], -1).gather(1, order)


def render_core_outside(fields: nets.NeuSFields, rays_o, rays_d, z_vals, sample_dist: float):
    """NeRF++ inverted-sphere background (renderer.py:95-131): alpha,
    sampled colour and weights at the (R, S) samples ``z_vals``."""
    R, S = z_vals.shape
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], sample_dist)], -1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
    dis_to_center = pts.norm(dim=-1, keepdim=True).clamp(1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], -1)
    dirs = rays_d[:, None, :].expand(R, S, 3)
    density, color = fields.nerf(pts4.reshape(-1, 4), dirs.reshape(-1, 3))
    alpha = 1.0 - torch.exp(-F.softplus(density.reshape(R, S)) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1
    )[:, :-1]
    return {"alpha": alpha, "sampled_color": torch.sigmoid(color).reshape(R, S, 3),
            "weights": alpha * trans}


def _use_mega(fields: nets.NeuSFields, rays_o, S: int, background_alpha=None) -> bool:
    """The JAX package's gate (render/neus.py:331-353): no background, both
    nets ask for kernels, d_hidden >= 128, a CUDA tensor, and a spec the
    kernels take."""
    if background_alpha is not None:
        return False
    if _FORCE_MEGA is not None:
        use = _FORCE_MEGA
    else:
        s, c = fields.sdf.cfg, fields.color.cfg
        use = (s.use_pallas and c.use_pallas and s.d_hidden >= _MIN_KERNEL_WIDTH
               and rays_o.is_cuda)
    return use and fused_neus.spec_from_configs(fields.sdf.cfg, fields.color.cfg, S) is not None


def render_core(fields: nets.NeuSFields, cfg: NeuSConfig, rays_o, rays_d, z_vals,
                sample_dist: float, background_alpha=None, background_sampled_color=None,
                background_rgb=None, cos_anneal_ratio: float = 0.0, per_ray: bool = False):
    """Core SDF -> alpha -> composite pass (renderer.py:195-300).

    ``per_ray=True`` (training steps) takes the per-ray megakernel path when
    the gate is open: the dict then carries per-ray quantities only (the
    per-sample keys are None) plus ``normals_weighted``. With the gate open
    and ``per_ray=False`` (validation renders) the point-level pair and the
    compositing pair carry the pass; the dict has every key plus
    ``normals_weighted``. A background (``background_alpha``, (R, S +
    n_outside)) closes the gate."""
    R, S = z_vals.shape
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], sample_dist)], -1)
    mid_z = z_vals + dists * 0.5
    inv_s = fields.variance.inv_s().clamp(1e-6, 1e6)

    use_mega = _use_mega(fields, rays_o, S, background_alpha)
    if use_mega and not per_ray:
        return _render_core_points(fields, cfg, rays_o, rays_d, mid_z, dists, inv_s,
                                   cos_anneal_ratio, background_rgb, R, S)
    if use_mega:
        col_w, normals_w, weight_sum, gradient_error = fused_neus.point_eval_ray(
            fields.sdf, fields.color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal_ratio
        )
        color = col_w[:, :3]
        extra_color = col_w[:, 3:6] if cfg.extra_color else None
        if background_rgb is not None:
            if cfg.extra_color:
                extra_color = extra_color + background_rgb * (1.0 - weight_sum)
            else:
                color = color + background_rgb * (1.0 - weight_sum)
        return {
            "color": color, "extra_color": extra_color, "sdf": None, "dists": dists,
            "gradients": None, "s_val": 1.0 / inv_s, "mid_z_vals": mid_z, "weights": None,
            "weight_sum": weight_sum, "cdf": None, "gradient_error": gradient_error,
            "inside_sphere": None, "normals_weighted": normals_w,
        }

    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    sdf, feature, gradients = nets.sdf_with_gradient(fields.sdf, pts)
    raw_color = nets.color_eval(fields.color, pts, gradients, dirs, feature)
    if cfg.extra_color:
        raw_color = raw_color.reshape(R, S, 6)
        sampled_color, extra_sampled_color = raw_color[..., :3], raw_color[..., 3:]
    else:
        sampled_color, extra_sampled_color = raw_color.reshape(R, S, 3), None

    true_cos = (dirs * gradients).sum(-1, keepdim=True)
    r = cos_anneal_ratio
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - r) + torch.relu(-true_cos) * r)
    est_next_sdf = sdf + iter_cos * dists.reshape(-1, 1) * 0.5
    est_prev_sdf = sdf - iter_cos * dists.reshape(-1, 1) * 0.5
    prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
    next_cdf = torch.sigmoid(est_next_sdf * inv_s)
    p, c = prev_cdf - next_cdf, prev_cdf
    alpha = ((p + 1e-5) / (c + 1e-5)).reshape(R, S).clamp(0.0, 1.0)

    pts_norm = pts.norm(dim=-1).reshape(R, S)
    inside_sphere = (pts_norm < 1.0).float().detach()
    relax_inside_sphere = (pts_norm < 1.2).float().detach()

    if background_alpha is not None:
        alpha = alpha * inside_sphere + background_alpha[:, :S] * (1.0 - inside_sphere)
        alpha = torch.cat([alpha, background_alpha[:, S:]], -1)
        sampled_color = (sampled_color * inside_sphere[..., None]
                         + background_sampled_color[:, :S] * (1.0 - inside_sphere)[..., None])
        sampled_color = torch.cat([sampled_color, background_sampled_color[:, S:]], 1)

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1
    )[:, :-1]
    weights = alpha * trans
    weights_sum = weights.sum(-1, keepdim=True)
    color = (sampled_color * weights[..., None]).sum(1)
    extra_color = (
        (extra_sampled_color * weights[:, :S, None]).sum(1) if cfg.extra_color else None
    )
    if background_rgb is not None:
        if cfg.extra_color:
            extra_color = extra_color + background_rgb * (1.0 - weights_sum)
        else:
            color = color + background_rgb * (1.0 - weights_sum)

    gradients = gradients.reshape(R, S, 3)
    gradient_error = (gradients.norm(dim=-1) - 1.0) ** 2
    gradient_error = (relax_inside_sphere * gradient_error).sum() / (
        relax_inside_sphere.sum() + 1e-5
    )
    return {
        "color": color, "extra_color": extra_color, "sdf": sdf, "dists": dists,
        "gradients": gradients, "s_val": 1.0 / inv_s, "mid_z_vals": mid_z,
        "weights": weights, "cdf": c.reshape(R, S), "gradient_error": gradient_error,
        "inside_sphere": inside_sphere,
    }


def _render_core_points(fields, cfg, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal_ratio,
                        background_rgb, R: int, S: int):
    """render_core's kernel path for ``per_ray=False`` (the JAX package's
    `_render_core_fused`): the point-level pair, then the compositing pair."""
    sdf, gradients, raw_color, alpha_f, cdf_f, inside_f, gradient_error = fused_neus.point_eval(
        fields.sdf, fields.color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal_ratio
    )
    gradients = gradients.reshape(R, S, 3)
    weights, color, extra_color, normals_w = fused_composite.composite(
        alpha_f.reshape(R, S), raw_color.reshape(R, S, raw_color.shape[-1]), gradients
    )
    if not cfg.extra_color:
        extra_color = None
    if background_rgb is not None:
        weights_sum = weights.sum(-1, keepdim=True)
        if cfg.extra_color:
            extra_color = extra_color + background_rgb * (1.0 - weights_sum)
        else:
            color = color + background_rgb * (1.0 - weights_sum)
    return {
        "color": color, "extra_color": extra_color, "sdf": sdf, "dists": dists,
        "gradients": gradients, "s_val": 1.0 / inv_s, "mid_z_vals": mid_z, "weights": weights,
        "cdf": cdf_f.reshape(R, S), "gradient_error": gradient_error,
        "inside_sphere": inside_f.reshape(R, S).detach(), "normals_weighted": normals_w,
    }


def render(fields: nets.NeuSFields, cfg: NeuSConfig, rays_o, rays_d, near, far,
           generator: torch.Generator | None = None, background_rgb=None,
           cos_anneal_ratio: float = 0.0, perturb_overwrite: int = -1,
           per_ray: bool = False):
    """Full hierarchical render (renderer.py:302-397). The stratified jitter
    is drawn from ``generator`` (on the CPU) when perturb > 0, the outside
    samples' after the inner samples'; without a generator there is no
    jitter. ``n_outside > 0`` needs a NeRF in the fields."""
    R = rays_o.shape[0]
    dev = rays_o.device
    n_out = cfg.n_outside
    if n_out > 0 and fields.nerf is None:
        raise ValueError("n_outside > 0 renders the NeRF++ background: the fields need a NeRF "
                         "(NeuSFields(..., nerf_cfg=...))")
    sample_dist = 2.0 / cfg.n_samples
    z_vals = torch.linspace(0.0, 1.0, cfg.n_samples, device=dev)
    z_vals = near + (far - near) * z_vals[None, :]
    z_out = None
    if n_out > 0:
        z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n_out + 1.0), n_out, device=dev)
    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if perturb > 0 and generator is not None:
        t_rand = torch.rand((R, 1), generator=generator).to(dev) - 0.5
        z_vals = z_vals + t_rand * 2.0 / cfg.n_samples
        if n_out > 0:
            mids = 0.5 * (z_out[1:] + z_out[:-1])
            upper = torch.cat([mids, z_out[-1:]])
            lower = torch.cat([z_out[:1], mids])
            t_rand = torch.rand((R, n_out), generator=generator).to(dev)
            z_out = lower[None, :] + (upper - lower)[None, :] * t_rand
    if n_out > 0:
        z_out = far / torch.flip(z_out, dims=[-1]) + 1.0 / cfg.n_samples

    if cfg.n_importance > 0:
        with torch.no_grad():
            sdf_fn = fields.sdf.sdf
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            sdf = sdf_fn(pts.reshape(-1, 3)).reshape(R, cfg.n_samples)
            zi = z_vals
            for i in range(cfg.up_sample_steps):
                new_z = up_sample(rays_o, rays_d, zi, sdf,
                                  cfg.n_importance // cfg.up_sample_steps, 64 * 2**i)
                zi, sdf = cat_z_vals(sdf_fn, rays_o, rays_d, zi, new_z, sdf,
                                     last=(i + 1 == cfg.up_sample_steps))
        z_vals = zi.detach()

    background_alpha = background_sampled_color = None
    if n_out > 0:
        z_feed = torch.sort(torch.cat([z_vals, z_out.expand(R, n_out)], -1), dim=-1).values
        ret_out = render_core_outside(fields, rays_o, rays_d, z_feed, sample_dist)
        background_alpha = ret_out["alpha"]
        background_sampled_color = ret_out["sampled_color"]

    ret = render_core(fields, cfg, rays_o, rays_d, z_vals, sample_dist,
                      background_alpha=background_alpha,
                      background_sampled_color=background_sampled_color,
                      background_rgb=background_rgb, cos_anneal_ratio=cos_anneal_ratio,
                      per_ray=per_ray)
    weights = ret["weights"]
    if weights is None:
        weight_sum, weight_max = ret["weight_sum"], None
    else:
        weight_sum = weights.sum(-1, keepdim=True)
        weight_max = weights.max(-1, keepdim=True).values
    out = {
        "color_fine": ret["color"],
        "extra_color_fine": ret["extra_color"],
        "s_val": ret["s_val"].reshape(1, 1).expand(R, 1),
        "cdf_fine": ret["cdf"],
        "weight_sum": weight_sum,
        "weight_max": weight_max,
        "gradients": ret["gradients"],
        "weights": weights,
        "mid_z_vals": ret["mid_z_vals"],
        "gradient_error": ret["gradient_error"],
        "inside_sphere": ret["inside_sphere"],
    }
    if ret.get("normals_weighted") is not None:
        out["normals_weighted"] = ret["normals_weighted"]
    return out
