"""The NeuS megakernel pairs: CUDA forward/backward, plain versions, autograd.

Two pairs, twins of avatarclip_tpu/ops/fused_neus.py:

* per ray (B1): `point_eval_fused_ray` (the entry), `_fused_core_ray` (the
  custom VJP), Pallas `_fwd_kernel_ray` / `_bwd_kernel_ray`. Per ray of
  (R, S) samples it evaluates the SDF MLP with its analytic spatial
  gradient, the colour MLP, the cos-annealed alpha and the in-ray
  compositing, and returns only per-ray quantities
  ``(colorW (R, 3|6), normals_w (R, 3), weight_sum (R, 1), gradient_error)``;
  the training steps use it.
* per point (B3): `point_eval_fused`, `_fused_core`, Pallas `_fwd_kernel` /
  `_bwd_kernel`. The same network pass without the compositing, returning
  every per-point quantity ``(sdf (P, 1), grad (P, 3), rgb (P, 3|6),
  alpha (P,), cdf (P,), inside (P,), gradient_error)`` with P = R * S; the
  validation and extraction renders use it, followed by the compositing
  kernel (ops/fused_composite.py).

On a CUDA tensor :func:`point_eval_ray` / :func:`point_eval` run
``csrc/fused_neus_ray.cu`` / ``csrc/fused_neus_point.cu`` through
:class:`NeuSRayFunction` / :class:`NeuSPointFunction` (the backward is the
second kernel; no fallback); on a CPU tensor they run the plain versions,
whose backward is autograd through the plain graph (create_graph=True for
the spatial gradient). The kernels compute in f32 throughout.

Weight norm is resolved to dense (out, in) weights in plain torch before the
Function (:func:`dense_weights`), so autograd carries the kernel's dense
weight gradients on to ``v``, ``g`` and ``b``. The TPU-only devices of the
Pallas version (128-lane padding, the -1e3 bias sentinel, the U/V relayout
matrices, the |o| = 10 ray padding) have no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from ..fields.networks import ColorNetwork, SDFNetwork

# kernel launches, counted by the wrappers (reset by callers that measure)
LAUNCHES = {"neus_ray_fwd": 0, "neus_ray_bwd": 0, "neus_point_fwd": 0, "neus_point_bwd": 0}
MAX_SAMPLES = 64  # one ray is one GEMM row block of the kernel


class Dims(ctypes.Structure):
    """Mirror of ``neus::Dims`` in csrc/neus_mlp.cuh (passed by value)."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("S", "L", "E", "H", "NH", "SW", "F", "HC", "NHC", "CW", "W", "squeeze")]
    _fields_ += [("scale", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class NeuSRaySpec:
    samples: int
    multires: int
    d_hidden: int
    n_hidden: int  # SDF hidden linears before the skip-producing layer
    feat_dim: int
    c_hidden: int
    c_layers: int  # colour relu linears
    extra_color: bool
    squeeze_out: bool
    scale: float

    @property
    def d_embed(self) -> int:
        return 3 * (1 + 2 * self.multires)

    @property
    def rgb_width(self) -> int:
        return 6 if self.extra_color else 3

    def dims(self) -> Dims:
        E = self.d_embed
        return Dims(self.samples, self.multires, E, self.d_hidden, self.n_hidden,
                    self.d_hidden - E, self.feat_dim, self.c_hidden, self.c_layers,
                    6 + self.feat_dim, self.rgb_width, int(self.squeeze_out),
                    float(self.scale))


def spec_from_configs(sdf_cfg, color_cfg, samples: int) -> NeuSRaySpec | None:
    """The network family the kernel takes (every repo conf): d_in 3, PE,
    one skip concat right before the head, no_view_dir colour net with a
    3-wide head; at most MAX_SAMPLES samples per ray. None otherwise."""
    s, c = sdf_cfg, color_cfg
    E = 3 * (1 + 2 * s.multires)
    if s.d_in != 3 or s.multires < 1 or tuple(s.skip_in) != (s.n_layers,):
        return None
    if s.n_layers < 2 or s.n_layers - 1 > 8 or s.d_hidden <= E:
        return None
    if c.mode != "no_view_dir" or c.d_in != 6 or c.multires_view != 0 or c.d_out != 3:
        return None
    if not 1 <= c.n_layers <= 8 or c.d_feature != s.d_out - 1:
        return None
    if not 1 <= samples <= MAX_SAMPLES:
        return None
    return NeuSRaySpec(
        samples=samples, multires=s.multires, d_hidden=s.d_hidden,
        n_hidden=s.n_layers - 1, feat_dim=s.d_out - 1, c_hidden=c.d_hidden,
        c_layers=c.n_layers, extra_color=c.extra_color, squeeze_out=c.squeeze_out,
        scale=s.scale,
    )


def dense_weights(sdf: SDFNetwork, color: ColorNetwork) -> list[torch.Tensor]:
    """Kernel weight list (differentiable, weight norm resolved): SDF layers
    then colour layers as (W (out, in), b), the colour head stacking the main
    and extra heads. This order is the flat layout of csrc/neus_mlp.cuh."""
    out = []
    for layer in sdf.layers:
        out += [layer.dense(), layer.b]
    for layer in color.layers[:-1]:
        out += [layer.dense(), layer.b]
    head = color.layers[-1]
    if color.extra is not None:
        out += [torch.cat([head.dense(), color.extra.dense()]), torch.cat([head.b, color.extra.b])]
    else:
        out += [head.dense(), head.b]
    return [t.float() for t in out]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _alpha(sdf, tc, dists, inv_s, r):
    """Cos-annealed logistic-CDF alpha and prev-CDF (renderer.py:221-248)."""
    iter_cos = -(torch.relu(-tc * 0.5 + 0.5) * (1.0 - r) + torch.relu(-tc) * r)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return alpha, prev_cdf


def point_eval_ray_plain(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d,
                         mid_z, dists, inv_s, cos_anneal):
    """Plain PyTorch version of the kernel pair (same maths), computed in the
    inputs' dtype (f32 like the kernel; f64 gives a reference)."""
    R, S = mid_z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    s, feat, g = sdf.sdf_with_gradient(pts, dtype=mid_z.dtype)
    rgb = color(pts, g, dirs, feat, dtype=mid_z.dtype)  # (P, 3|6)
    tc = (dirs * g).sum(-1).reshape(R, S)
    alpha, _ = _alpha(s.reshape(R, S), tc, dists, inv_s, cos_anneal)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1
    )[:, :-1]
    w = (alpha * trans)[..., None]  # (R, S, 1)
    col_w = (w * rgb.reshape(R, S, -1)).sum(1)
    normals_w = (w * g.reshape(R, S, 3)).sum(1)
    weight_sum = w.sum(1)
    relax = ((pts * pts).sum(-1) < 1.44).float()
    ge = (torch.sqrt((g * g).sum(-1) + 1e-12) - 1.0) ** 2
    gradient_error = (relax * ge).sum() / (relax.sum() + 1e-5)
    return col_w, normals_w, weight_sum, gradient_error


def point_eval_plain(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d, mid_z, dists,
                     inv_s, cos_anneal):
    """Plain PyTorch version of the point-level kernel pair (same maths), in
    the inputs' dtype. Returns (sdf (P, 1), grad (P, 3), rgb (P, 3|6),
    alpha (P,), cdf (P,), inside (P,), gradient_error)."""
    R, S = mid_z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    s, feat, g = sdf.sdf_with_gradient(pts, dtype=mid_z.dtype)
    rgb = color(pts, g, dirs, feat, dtype=mid_z.dtype)
    tc = (dirs * g).sum(-1)
    alpha, cdf = _alpha(s[:, 0], tc, dists.reshape(-1), inv_s, cos_anneal)
    r2 = (pts * pts).sum(-1).detach()
    inside = (r2 < 1.0).to(mid_z.dtype)
    relax = (r2 < 1.44).to(mid_z.dtype)
    ge = (torch.sqrt((g * g).sum(-1) + 1e-12) - 1.0) ** 2
    gradient_error = (relax * ge).sum() / (relax.sum() + 1e-5)
    return s, g, rgb, alpha, cdf, inside, gradient_error


# ---------------------------------------------------------------------------
# CUDA kernel pair
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("fused_neus_ray", "fused_neus_ray.cu")
    if not getattr(lib, "_typed", False):
        P, I, F_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.neus_weight_count.argtypes = [Dims]
        lib.neus_weight_count.restype = L_
        lib.neus_workspace_floats.argtypes = [Dims, I]
        lib.neus_workspace_floats.restype = L_
        lib.neus_ray_fwd.argtypes = [Dims] + [P] * 6 + [F_, I] + [P] * 8 + [L_, I, P]
        lib.neus_ray_fwd.restype = I
        lib.neus_ray_bwd.argtypes = [Dims] + [P] * 6 + [F_, I] + [P] * 13 + [L_, I, P]
        lib.neus_ray_bwd.restype = I
        lib._typed = True
    return lib


def _n_cta(device, R: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(R, 2 * sms))


def _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s):
    R, S = mid_z.shape
    want = {"rays_o": (R, 3), "rays_d": (R, 3), "dists": (R, S), "inv_s": ()}
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d), ("dists", dists), ("inv_s", inv_s)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    for t in (flat, rays_o, rays_d, mid_z, dists, inv_s):
        if not t.is_cuda or t.device != mid_z.device:
            raise ValueError("all inputs of the NeuS kernel must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the NeuS kernel takes contiguous float32 tensors")
    if S != spec.samples:
        raise ValueError(f"{S} samples per ray, spec says {spec.samples}")


def neus_ray_fwd(spec: NeuSRaySpec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal):
    """Launch the forward kernel. Returns (colorW, normals_w, wsum (R, 1),
    sdf (R*S,), grad (R*S, 3), eik (2,) = [num, den])."""
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    lib = _lib()
    d = spec.dims()
    if flat.numel() != lib.neus_weight_count(d):
        raise ValueError("flat weight buffer does not match the network dims")
    R, S = mid_z.shape
    dev = mid_z.device
    n_cta = _n_cta(dev, R)
    stride = int(lib.neus_workspace_floats(d, 0))
    ws = torch.empty(n_cta * stride, device=dev)
    eik_part = torch.empty(n_cta * 2, device=dev)
    col_w = torch.empty(R, spec.rgb_width, device=dev)
    normals_w = torch.empty(R, 3, device=dev)
    wsum = torch.empty(R, 1, device=dev)
    sdf_res = torch.empty(R * S, device=dev)
    g_res = torch.empty(R * S, 3, device=dev)
    eik = torch.empty(2, device=dev)
    p = _build.ptr
    err = lib.neus_ray_fwd(
        d, p(flat), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s), float(cos_anneal), R,
        p(col_w), p(normals_w), p(wsum), p(sdf_res), p(g_res), p(eik), p(eik_part), p(ws),
        stride, n_cta, _build.stream_ptr(dev),
    )
    _build.check(err, "neus_ray_fwd launch")
    _build.count(LAUNCHES, "neus_ray_fwd")
    return col_w, normals_w, wsum, sdf_res, g_res, eik


def neus_ray_bwd(spec: NeuSRaySpec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal,
                 sdf_res, g_res, c_col, c_nw, c_ws, c_eik):
    """Launch the backward kernel (+ its partial-sum pass). Returns (d_o, d_d,
    d_z, d_t, d_flat, d_inv_s)."""
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    lib = _lib()
    d = spec.dims()
    R, S = mid_z.shape
    W = spec.rgb_width
    _build.check_f32(mid_z.device, (("c_col", c_col, (R, W)), ("c_nw", c_nw, (R, 3)),
                              ("c_ws", c_ws, (R, 1)), ("c_eik", c_eik, (2,)),
                              ("sdf_res", sdf_res, (R * S,)), ("g_res", g_res, (R * S, 3))))
    dev = mid_z.device
    n_w = int(lib.neus_weight_count(d))
    n_cta = _n_cta(dev, R)
    stride = int(lib.neus_workspace_floats(d, 1))
    ws = torch.empty(n_cta * stride, device=dev)
    gpart = torch.empty(n_cta * (n_w + 1), device=dev)
    d_o = torch.empty(R, 3, device=dev)
    d_d = torch.empty(R, 3, device=dev)
    d_z = torch.empty(R, S, device=dev)
    d_t = torch.empty(R, S, device=dev)
    d_w = torch.empty(n_w + 1, device=dev)
    p = _build.ptr
    err = lib.neus_ray_bwd(
        d, p(flat), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s), float(cos_anneal), R,
        p(sdf_res), p(g_res), p(c_col), p(c_nw), p(c_ws), p(c_eik),
        p(d_o), p(d_d), p(d_z), p(d_t), p(d_w), p(gpart), p(ws), stride, n_cta,
        _build.stream_ptr(dev),
    )
    _build.check(err, "neus_ray_bwd launch")
    _build.count(LAUNCHES, "neus_ray_bwd")
    return d_o, d_d, d_z, d_t, d_w[:n_w], d_w[n_w].reshape(())


class NeuSRayFunction(torch.autograd.Function):
    """(rays, mid_z, dists, inv_s, *dense weights) -> (colorW, normals_w,
    weight_sum, eik (2,)); forward and backward are the CUDA kernels."""

    @staticmethod
    def forward(ctx, spec, cos_anneal, rays_o, rays_d, mid_z, dists, inv_s, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        col_w, normals_w, wsum, sdf_res, g_res, eik = neus_ray_fwd(
            spec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal
        )
        ctx.save_for_backward(flat, rays_o, rays_d, mid_z, dists, inv_s, sdf_res, g_res)
        ctx.spec, ctx.cos_anneal = spec, cos_anneal
        ctx.shapes = [w.shape for w in weights]
        return col_w, normals_w, wsum, eik

    @staticmethod
    def backward(ctx, c_col, c_nw, c_ws, c_eik):
        flat, rays_o, rays_d, mid_z, dists, inv_s, sdf_res, g_res = ctx.saved_tensors
        R = mid_z.shape[0]
        dev = mid_z.device

        def cot(t, shape):
            return torch.zeros(shape, device=dev) if t is None else t.float().contiguous()

        d_o, d_d, d_z, d_t, d_flat, d_inv_s = neus_ray_bwd(
            ctx.spec, flat, rays_o, rays_d, mid_z, dists, inv_s, ctx.cos_anneal,
            sdf_res, g_res,
            cot(c_col, (R, ctx.spec.rgb_width)), cot(c_nw, (R, 3)), cot(c_ws, (R, 1)),
            cot(c_eik, (2,)),
        )
        grads, off = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            grads.append(d_flat[off:off + n].reshape(shape))
            off += n
        return (None, None, d_o, d_d, d_z, d_t, d_inv_s, *grads)


def point_eval_ray(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d, mid_z, dists,
                   inv_s, cos_anneal):
    """Per-ray NeuS evaluation: (colorW (R, 3|6), normals_w (R, 3),
    weight_sum (R, 1), gradient_error scalar). CPU tensors take the plain
    version; CUDA tensors take the kernel pair, or raise."""
    if not mid_z.is_cuda:
        return point_eval_ray_plain(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)
    R, S = mid_z.shape
    spec = spec_from_configs(sdf.cfg, color.cfg, S)
    if spec is None:
        raise ValueError("network configuration not supported by the NeuS kernel")
    c = lambda t: t.float().contiguous()
    col_w, normals_w, wsum, eik = NeuSRayFunction.apply(
        spec, float(cos_anneal), c(rays_o), c(rays_d), c(mid_z), c(dists), c(inv_s.reshape(())),
        *dense_weights(sdf, color),
    )
    return col_w, normals_w, wsum, eik[0] / (eik[1] + 1e-5)


# ---------------------------------------------------------------------------
# CUDA point-level pair (B3)
# ---------------------------------------------------------------------------


def _point_lib():
    lib = _build.load("fused_neus_point", "fused_neus_point.cu")
    if not getattr(lib, "_typed", False):
        P, I, F_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.neus_point_weight_count.argtypes = [Dims]
        lib.neus_point_weight_count.restype = L_
        lib.neus_point_workspace_floats.argtypes = [Dims, I]
        lib.neus_point_workspace_floats.restype = L_
        lib.neus_point_fwd.argtypes = [Dims] + [P] * 6 + [F_, I] + [P] * 9 + [L_, I, P]
        lib.neus_point_fwd.restype = I
        lib.neus_point_bwd.argtypes = [Dims] + [P] * 6 + [F_, I] + [P] * 15 + [L_, I, P]
        lib.neus_point_bwd.restype = I
        lib._typed = True
    return lib


def neus_point_fwd(spec: NeuSRaySpec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal):
    """Launch the point-level forward kernel. Returns (sdf (P,), alpha (P,),
    cdf (P,), grad (P, 3), inside (P,), rgb (P, W), eik (2,) = [num, den])."""
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    lib = _point_lib()
    d = spec.dims()
    if flat.numel() != lib.neus_point_weight_count(d):
        raise ValueError("flat weight buffer does not match the network dims")
    R, S = mid_z.shape
    dev = mid_z.device
    n_cta = _n_cta(dev, R)
    stride = int(lib.neus_point_workspace_floats(d, 0))
    ws = torch.empty(n_cta * stride, device=dev)
    eik_part = torch.empty(n_cta * 2, device=dev)
    sdf_o, alpha, cdf, inside = (torch.empty(R * S, device=dev) for _ in range(4))
    grad = torch.empty(R * S, 3, device=dev)
    rgb = torch.empty(R * S, spec.rgb_width, device=dev)
    eik = torch.empty(2, device=dev)
    p = _build.ptr
    err = lib.neus_point_fwd(
        d, p(flat), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s), float(cos_anneal), R,
        p(sdf_o), p(alpha), p(cdf), p(grad), p(inside), p(rgb), p(eik), p(eik_part), p(ws),
        stride, n_cta, _build.stream_ptr(dev),
    )
    _build.check(err, "neus_point_fwd launch")
    _build.count(LAUNCHES, "neus_point_fwd")
    return sdf_o, alpha, cdf, grad, inside, rgb, eik


def neus_point_bwd(spec: NeuSRaySpec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal,
                   sdf_res, g_res, c_sdf, c_alpha, c_cdf, c_grad, c_rgb, c_eik):
    """Launch the point-level backward kernel (+ its partial-sum pass).
    Returns (d_o, d_d, d_z, d_t, d_flat, d_inv_s)."""
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    lib = _point_lib()
    d = spec.dims()
    R, S = mid_z.shape
    P = R * S
    _build.check_f32(mid_z.device, (("sdf_res", sdf_res, (P,)), ("g_res", g_res, (P, 3)),
                              ("c_sdf", c_sdf, (P,)), ("c_alpha", c_alpha, (P,)),
                              ("c_cdf", c_cdf, (P,)), ("c_grad", c_grad, (P, 3)),
                              ("c_rgb", c_rgb, (P, spec.rgb_width)), ("c_eik", c_eik, (2,))))
    dev = mid_z.device
    n_w = int(lib.neus_point_weight_count(d))
    n_cta = _n_cta(dev, R)
    stride = int(lib.neus_point_workspace_floats(d, 1))
    ws = torch.empty(n_cta * stride, device=dev)
    gpart = torch.empty(n_cta * (n_w + 1), device=dev)
    d_o = torch.empty(R, 3, device=dev)
    d_d = torch.empty(R, 3, device=dev)
    d_z = torch.empty(R, S, device=dev)
    d_t = torch.empty(R, S, device=dev)
    d_w = torch.empty(n_w + 1, device=dev)
    p = _build.ptr
    err = lib.neus_point_bwd(
        d, p(flat), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s), float(cos_anneal), R,
        p(sdf_res), p(g_res), p(c_sdf), p(c_alpha), p(c_cdf), p(c_grad), p(c_rgb), p(c_eik),
        p(d_o), p(d_d), p(d_z), p(d_t), p(d_w), p(gpart), p(ws), stride, n_cta,
        _build.stream_ptr(dev),
    )
    _build.check(err, "neus_point_bwd launch")
    _build.count(LAUNCHES, "neus_point_bwd")
    return d_o, d_d, d_z, d_t, d_w[:n_w], d_w[n_w].reshape(())


class NeuSPointFunction(torch.autograd.Function):
    """(spec, cos_anneal, keep, rays, mid_z, dists, inv_s, *dense weights) ->
    (sdf (P, 1), grad, rgb, alpha, cdf, inside, eik (2,)); forward and
    backward are the CUDA kernels. ``inside`` is not differentiable.
    Residuals are kept only when ``keep`` (the caller's grad mode), so the
    validation renders under no_grad hold none."""

    @staticmethod
    def forward(ctx, spec, cos_anneal, keep, rays_o, rays_d, mid_z, dists, inv_s, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        sdf_o, alpha, cdf, grad, inside, rgb, eik = neus_point_fwd(
            spec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal
        )
        ctx.mark_non_differentiable(inside)
        if keep and any(ctx.needs_input_grad):
            ctx.save_for_backward(flat, rays_o, rays_d, mid_z, dists, inv_s, sdf_o, grad)
            ctx.spec, ctx.cos_anneal = spec, cos_anneal
            ctx.shapes = [w.shape for w in weights]
        return sdf_o.reshape(-1, 1), grad, rgb, alpha, cdf, inside, eik

    @staticmethod
    def backward(ctx, c_sdf, c_grad, c_rgb, c_alpha, c_cdf, c_inside, c_eik):
        flat, rays_o, rays_d, mid_z, dists, inv_s, sdf_o, grad = ctx.saved_tensors
        P = mid_z.numel()
        dev = mid_z.device

        def cot(t, shape):
            return torch.zeros(shape, device=dev) if t is None else t.float().reshape(shape).contiguous()

        d_o, d_d, d_z, d_t, d_flat, d_inv_s = neus_point_bwd(
            ctx.spec, flat, rays_o, rays_d, mid_z, dists, inv_s, ctx.cos_anneal, sdf_o, grad,
            cot(c_sdf, (P,)), cot(c_alpha, (P,)), cot(c_cdf, (P,)), cot(c_grad, (P, 3)),
            cot(c_rgb, (P, ctx.spec.rgb_width)), cot(c_eik, (2,)),
        )
        grads, off = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            grads.append(d_flat[off:off + n].reshape(shape))
            off += n
        return (None, None, None, d_o, d_d, d_z, d_t, d_inv_s, *grads)


def point_eval(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d, mid_z, dists, inv_s,
               cos_anneal):
    """Per-point NeuS evaluation: (sdf (P, 1), grad (P, 3), rgb (P, 3|6),
    alpha (P,), cdf (P,), inside (P,), gradient_error scalar). CPU tensors
    take the plain version; CUDA tensors take the kernel pair, or raise."""
    if not mid_z.is_cuda:
        return point_eval_plain(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)
    R, S = mid_z.shape
    spec = spec_from_configs(sdf.cfg, color.cfg, S)
    if spec is None:
        raise ValueError("network configuration not supported by the NeuS kernel")
    c = lambda t: t.float().contiguous()
    sdf_o, grad, rgb, alpha, cdf, inside, eik = NeuSPointFunction.apply(
        spec, float(cos_anneal), torch.is_grad_enabled(), c(rays_o), c(rays_d), c(mid_z), c(dists), c(inv_s.reshape(())),
        *dense_weights(sdf, color),
    )
    return sdf_o, grad, rgb, alpha, cdf, inside, eik[0] / (eik[1] + 1e-5)
