"""Neural fields: SDF, rendering (colour), variance and NeRF background
networks as nn.Modules.

Torch twin of avatarclip_tpu/fields/networks.py. Parameter names mirror the
JAX pytree (``layers.{i}.{g,v,b}``, ``extra.{g,v,b}``, ``variance``,
``pts.{i}.{w,b}`` / ``view`` / ``feature`` / ``alpha`` / ``rgb`` of the
NeRF) so that :func:`avatarclip_torch.utils.convert.params_from_jax` maps
one onto the other by path. Weights keep the (out, in) layout of the JAX
tree and of ``torch.nn.Linear``; weight norm is w = g * v / |v| per output
row.

Fidelity notes (as in the JAX package): geometric init of the SDF MLP,
softplus(beta=100) activations, the skip concat scaled by 1/sqrt(2), and the
``extra_color`` head off the last hidden activation. The NeRF++ background
net always runs its view branch (``use_viewdirs`` is not read), concatenates
``[pts, h]`` after layer ``i in skips`` and has no weight norm.

:func:`sdf_with_gradient` and :func:`color_eval` are the renderer's entry
points, with the JAX package's gate ("TPU backend" read as "CUDA tensor"):
on a CUDA tensor with ``use_pallas`` and ``d_hidden >= 256`` and a spec the
kernel takes they run the CUDA pairs of ops/fused_sdf.py and
ops/fused_color.py, otherwise the plain modules. :func:`sdf_value` serves
the sdf-only queries (the up-sample sweeps, the marching-cubes grid): the
plain module unless the ``_SWEEP_KERNEL`` hook is on (it is off, as in the
JAX package), and then the sdf-only kernel on a CUDA tensor with
``use_pallas`` and a spec it takes, at any width (the JAX hook has no width
gate).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .embedder import embed_dim, positional_encoding


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def operand_bf16(cfg) -> bool:
    """The NeuS kernels' operand mode of a net (ops/fused_neus.py): its
    ``cfg.dtype`` "bfloat16" (every conf's default) gives bf16 dot operands
    with f32 sums, "float32" f32 throughout."""
    return cfg.dtype == "bfloat16"


def _operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A dot operand as the kernels take it: rounded to bf16 in bf16 mode,
    then computed with in x's own dtype."""
    return x.to(torch.bfloat16).to(x.dtype) if bf16 else x


def _kernel_linear(x, w, b, bf16: bool):
    """x @ w^T + b at the kernels' rounding points: both dot operands rounded
    in bf16 mode, the sum and the bias in x's dtype."""
    return _operand(x, bf16) @ _operand(w.to(x.dtype), bf16).t() + b.to(x.dtype)


class WNLinear(nn.Module):
    """Linear layer with optional weight normalisation; (out, in) layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, weight_norm: bool = True):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.g = nn.Parameter(w.norm(dim=1, keepdim=True))
            self.v = nn.Parameter(w.clone())
        else:
            self.w = nn.Parameter(w.clone())
        self.b = nn.Parameter(b.clone())

    def dense(self) -> torch.Tensor:
        """The effective (out, in) weight; weight norm resolved in f32."""
        if self.weight_norm:
            return self.g * self.v / self.v.norm(dim=1, keepdim=True)
        return self.w

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                rows: int | None = None) -> torch.Tensor:
        """x @ W^T + b; with dtype bfloat16 the operands are rounded to bf16
        and the products summed in f32."""
        w, b = self.dense(), self.b
        if rows is not None:
            w, b = w[:rows], b[:rows]
        if dtype == torch.bfloat16:
            # operands rounded to the compute dtype, products summed in f32
            # (the JAX package's preferred_element_type=f32 contract)
            return x.to(dtype).float() @ w.to(dtype).float().t() + b
        return x @ w.t() + b


def softplus100(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(100.0 * x) * 0.01


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 4
    skip_in: Sequence[int] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False
    dtype: str = "float32"
    # on the card: the hand-written CUDA kernels (the megakernel in
    # render_core, B6 in the per-sample branch) instead of the plain module
    use_pallas: bool = True

    @property
    def dims(self) -> list[int]:
        d0 = embed_dim(self.multires, self.d_in) if self.multires > 0 else self.d_in
        return [d0] + [self.d_hidden] * self.n_layers + [self.d_out]


class SDFNetwork(nn.Module):
    def __init__(self, cfg: SDFConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dims = cfg.dims
        n = len(dims)
        layers = []
        for l in range(n - 1):
            out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
            in_dim = dims[l]
            normal = lambda *s: torch.randn(*s, generator=generator)
            if cfg.geometric_init:
                if l == n - 2:
                    mean = np.sqrt(np.pi) / np.sqrt(in_dim)
                    if cfg.inside_outside:
                        mean = -mean
                    w = mean + 1e-4 * normal(out_dim, in_dim)
                    b = torch.full((out_dim,), cfg.bias if cfg.inside_outside else -cfg.bias)
                elif cfg.multires > 0 and l == 0:
                    w = torch.zeros(out_dim, in_dim)
                    w[:, :3] = normal(out_dim, 3) * (np.sqrt(2.0) / np.sqrt(out_dim))
                    b = torch.zeros(out_dim)
                elif cfg.multires > 0 and l in cfg.skip_in:
                    w = normal(out_dim, in_dim) * (np.sqrt(2.0) / np.sqrt(out_dim))
                    w[:, -(dims[0] - 3):] = 0.0
                    b = torch.zeros(out_dim)
                else:
                    w = normal(out_dim, in_dim) * (np.sqrt(2.0) / np.sqrt(out_dim))
                    b = torch.zeros(out_dim)
            else:
                bound = 1.0 / np.sqrt(in_dim)
                w = (torch.rand(out_dim, in_dim, generator=generator) * 2 - 1) * bound
                b = (torch.rand(out_dim, generator=generator) * 2 - 1) * bound
            layers.append(WNLinear(w.float(), b.float(), cfg.weight_norm))
        self.layers = nn.ModuleList(layers)

    def forward(self, pts: torch.Tensor, sdf_only: bool = False,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """(P, 3) -> (P, d_out) = [sdf, geometry feature]; ``sdf_only``
        evaluates only the first output row of the last layer."""
        cfg = self.cfg
        dt = _torch_dtype(cfg.dtype) if dtype is None else dtype
        inputs = pts * cfg.scale
        if cfg.multires > 0:
            inputs = positional_encoding(inputs, cfg.multires)
        x = inputs
        n = len(cfg.dims)
        for l, layer in enumerate(self.layers):
            if l in cfg.skip_in:
                x = torch.cat([x, inputs.to(x.dtype)], dim=-1) / np.sqrt(2.0)
            rows = 1 if (sdf_only and l == n - 2) else None
            x = layer(x, dt, rows)
            if l < n - 2:
                x = softplus100(x.to(dt))
        x = x.to(pts.dtype)
        return torch.cat([x[..., :1] / cfg.scale, x[..., 1:]], dim=-1)

    def sdf(self, pts: torch.Tensor) -> torch.Tensor:
        return self.forward(pts, sdf_only=True)[..., :1]

    def sdf_with_gradient(self, pts: torch.Tensor, dtype: torch.dtype | None = None):
        """(sdf (P,1), feature (P,F), gradient (P,3)); the spatial gradient is
        taken with create_graph=True so the eikonal term differentiates it."""
        with torch.enable_grad():
            x = pts if pts.requires_grad else pts.detach().requires_grad_(True)
            out = self.forward(x, dtype=dtype)
            (grad,) = torch.autograd.grad(
                out[..., 0].sum(), x, create_graph=True
            )
        return out[..., :1], out[..., 1:], grad


def kernel_sdf_forward(sdf: SDFNetwork, pts: torch.Tensor, sdf_only: bool = False,
                       round_sdf_row: bool = False) -> torch.Tensor:
    """(P, 3) -> (P, d_out) = [sdf, feature] (or (P, 1) with ``sdf_only``) as
    the NeuS kernels compute it, in pts' dtype, at the net's operand mode
    (:func:`operand_bf16`): in f32 mode the module's forward; in bf16 mode each matmul's
    operands are rounded to bf16 (the JAX kernels' ``_dot``); activations,
    biases and the head's sdf row stay in pts' dtype, the sdf row unless
    ``round_sdf_row`` (the JAX sdf+gradient kernel rounds it, the megakernels
    and the sdf-only kernel sum it in f32). The head reads [a, e] with its
    weights scaled by 1/sqrt(2), as the kernels fold the skip's scale. For the
    kernel family only: the skip concat right before the head."""
    bf16 = operand_bf16(sdf.cfg)
    if not bf16:  # f32: the module's own maths, the tight oracle as it always was
        out = sdf.forward(pts, sdf_only=sdf_only, dtype=pts.dtype)
        return out[..., :1] if sdf_only else out
    cfg = sdf.cfg
    e = positional_encoding(pts * cfg.scale, cfg.multires)
    x = e
    for layer in sdf.layers[:-1]:
        x = softplus100(_kernel_linear(x, layer.dense(), layer.b, bf16))
    head = sdf.layers[-1]
    u = torch.cat([x, e], dim=-1)
    w = head.dense().to(pts.dtype) / np.sqrt(2.0)
    b = head.b.to(pts.dtype)
    s = _kernel_linear(u, w[:1], b[:1], bf16 and round_sdf_row)
    if sdf_only:
        return s / cfg.scale
    feat = _kernel_linear(u, w[1:], b[1:], bf16)
    return torch.cat([s / cfg.scale, feat], dim=-1)


def kernel_sdf_with_gradient(sdf: SDFNetwork, pts: torch.Tensor, round_sdf_row: bool = False):
    """(sdf (P, 1), feature (P, F), gradient (P, 3)) of
    :func:`kernel_sdf_forward`, the gradient by autograd with
    create_graph=True. Autograd rounds a cotangent after each reverse dot
    where the kernels round it before."""
    with torch.enable_grad():
        x = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        out = kernel_sdf_forward(sdf, x, round_sdf_row=round_sdf_row)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), x, create_graph=True)
    return out[..., :1], out[..., 1:], grad


# ---------------------------------------------------------------------------
# Rendering (colour) network
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColorConfig:
    d_feature: int = 256
    mode: str = "no_view_dir"  # idr | no_view_dir | no_normal
    d_in: int = 6
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 2
    weight_norm: bool = True
    multires_view: int = 0
    squeeze_out: bool = True
    extra_color: bool = False
    dtype: str = "float32"
    use_pallas: bool = True

    @property
    def dims(self) -> list[int]:
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0:
            d0 += embed_dim(self.multires_view, 3) - 3
        return [d0] + [self.d_hidden] * self.n_layers + [self.d_out]


class ColorNetwork(nn.Module):
    def __init__(self, cfg: ColorConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dims = cfg.dims

        def uniform_linear(d_out, d_in):
            bound = 1.0 / np.sqrt(d_in)
            w = (torch.rand(d_out, d_in, generator=generator) * 2 - 1) * bound
            b = (torch.rand(d_out, generator=generator) * 2 - 1) * bound
            return WNLinear(w, b, cfg.weight_norm)

        self.layers = nn.ModuleList(
            uniform_linear(dims[l + 1], dims[l]) for l in range(len(dims) - 1)
        )
        self.extra = uniform_linear(cfg.d_out, dims[-2]) if cfg.extra_color else None

    def forward(self, points, normals, view_dirs, features,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """-> (P, d_out), or (P, 2*d_out) [main, extra] with extra_color."""
        cfg = self.cfg
        dt = _torch_dtype(cfg.dtype) if dtype is None else dtype
        if cfg.multires_view > 0:
            view_dirs = positional_encoding(view_dirs, cfg.multires_view)
        if cfg.mode == "idr":
            x = torch.cat([points, view_dirs, normals, features], dim=-1)
        elif cfg.mode == "no_view_dir":
            x = torch.cat([points, normals, features], dim=-1)
        elif cfg.mode == "no_normal":
            x = torch.cat([points, view_dirs, features], dim=-1)
        else:
            raise ValueError(f"unknown color mode {cfg.mode}")
        n = len(cfg.dims)
        extra_x = None
        for l, layer in enumerate(self.layers):
            x = layer(x, dt)
            if l < n - 2:
                x = torch.relu(x.to(dt))
            if cfg.extra_color and l == n - 3:
                extra_x = self.extra(x, dt).to(points.dtype)
        x = x.to(points.dtype)
        if cfg.extra_color:
            x = torch.cat([x, extra_x], dim=-1)
        if cfg.squeeze_out:
            x = torch.sigmoid(x)
        return x


def kernel_color_forward(color: ColorNetwork, points, normals, view_dirs,
                         features) -> torch.Tensor:
    """The colour net as the NeuS kernels compute it, in the points' dtype, at
    the net's operand mode: each matmul's operands rounded to bf16 in bf16
    mode, relu activations, biases and the sigmoid in the points' dtype. ->
    (P, d_out), or (P, 2 * d_out) [main, extra] with extra_color."""
    bf16 = operand_bf16(color.cfg)
    if not bf16:  # f32: the module's own maths
        return color(points, normals, view_dirs, features, dtype=points.dtype)
    cfg = color.cfg
    if cfg.multires_view > 0:
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    parts = {"idr": (points, view_dirs, normals, features),
             "no_view_dir": (points, normals, features),
             "no_normal": (points, view_dirs, features)}[cfg.mode]
    x = torch.cat(parts, dim=-1)
    for layer in color.layers[:-1]:
        x = torch.relu(_kernel_linear(x, layer.dense(), layer.b, bf16))
    head = color.layers[-1]
    out = _kernel_linear(x, head.dense(), head.b, bf16)
    if cfg.extra_color:
        out = torch.cat([out, _kernel_linear(x, color.extra.dense(), color.extra.b, bf16)], -1)
    return torch.sigmoid(out) if cfg.squeeze_out else out


# ---------------------------------------------------------------------------
# Single-parameter variance network
# ---------------------------------------------------------------------------


class VarianceNetwork(nn.Module):
    def __init__(self, init_val: float):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val)))

    def inv_s(self) -> torch.Tensor:
        """inv_s = exp(10 * variance)."""
        return torch.exp(self.variance * 10.0)


# ---------------------------------------------------------------------------
# NeRF++ background network (inverted-sphere background, n_outside > 0)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skips: Sequence[int] = (4,)
    use_viewdirs: bool = True
    output_ch: int = 4


class NeRFNetwork(nn.Module):
    """Twin of the JAX package's ``nerf_init`` / ``nerf_apply``: D relu
    linears over the encoded (x/r, 1/r) points, an alpha head, a feature
    linear, one relu linear over [feature, encoded view], an rgb head."""

    def __init__(self, cfg: NeRFConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        in_ch = embed_dim(cfg.multires, cfg.d_in)
        in_ch_view = embed_dim(cfg.multires_view, cfg.d_in_view)

        def dense(d_out, d_in):
            bound = 1.0 / np.sqrt(d_in)
            w = (torch.rand(d_out, d_in, generator=generator) * 2 - 1) * bound
            b = (torch.rand(d_out, generator=generator) * 2 - 1) * bound
            return WNLinear(w, b, weight_norm=False)

        self.pts = nn.ModuleList(
            [dense(cfg.W, in_ch)]
            + [dense(cfg.W, cfg.W + in_ch if i in cfg.skips else cfg.W) for i in range(cfg.D - 1)]
        )
        self.view = dense(cfg.W // 2, in_ch_view + cfg.W)
        self.feature = dense(cfg.W, cfg.W)
        self.alpha = dense(1, cfg.W)
        self.rgb = dense(3, cfg.W // 2)

    def forward(self, pts: torch.Tensor, views: torch.Tensor):
        """(P, 4) points [x / r, 1 / r] and (P, 3) directions -> raw
        (density (P, 1), rgb (P, 3))."""
        cfg = self.cfg
        pts = positional_encoding(pts, cfg.multires)
        views = positional_encoding(views, cfg.multires_view)
        h = pts
        for i, layer in enumerate(self.pts):
            h = torch.relu(layer(h))
            if i in cfg.skips:
                h = torch.cat([pts, h], dim=-1)
        alpha = self.alpha(h)
        feature = self.feature(h)
        h = torch.relu(self.view(torch.cat([feature, views], dim=-1)))
        return alpha, self.rgb(h)


class NeuSFields(nn.Module):
    """The trained networks of one avatar; state-dict paths mirror the JAX
    params tree (``sdf/...``, ``color/...``, ``variance/variance`` and, with
    a NeRF++ background, ``nerf/...``)."""

    def __init__(self, sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                 variance_init: float, generator: torch.Generator | None = None,
                 nerf_cfg: NeRFConfig | None = None):
        super().__init__()
        self.sdf = SDFNetwork(sdf_cfg, generator)
        self.color = ColorNetwork(color_cfg, generator)
        self.variance = VarianceNetwork(variance_init)
        self.nerf = NeRFNetwork(nerf_cfg, generator) if nerf_cfg is not None else None


# ---------------------------------------------------------------------------
# the renderer's entry points, with the kernel gate
# ---------------------------------------------------------------------------

_KERNEL_WIDTH = 256  # narrower nets stay on the plain modules (as in the JAX package)


# the JAX package's importance-sweep hook (avatarclip_tpu/fields/
# networks.py:179-198): when True, sdf_value takes the sdf-only kernel
_SWEEP_KERNEL = False


def sdf_value(sdf: SDFNetwork, pts: torch.Tensor) -> torch.Tensor:
    """sdf (P, 1) of (P, 3) points: the sdf-only kernel (ops/fused_sdf.py)
    when the hook is on and the gate is open, else the plain module (twin of
    the JAX package's ``sdf_value``).

    Precision: the hook keeps the operand type, as the JAX hook does: the
    kernel rounds its dot operands to ``cfg.dtype`` (bf16 at the confs'
    default ``train.compute_dtype``) and sums in f32. The plain module also
    rounds its activations to bf16 (the JAX XLA path's rounding points), so
    at bf16 the two ways still differ by bf16 rounding (chip_smoke.py's path
    h prints the gap on the marching-cubes grid); at f32 they agree to
    rounding."""
    cfg = sdf.cfg
    if _SWEEP_KERNEL and cfg.use_pallas and pts.is_cuda:
        from ..ops import fused_sdf

        if fused_sdf.spec_from_config(cfg) is not None:
            return fused_sdf.sdf_value_fused(sdf, pts)
    return sdf.sdf(pts)


def sdf_with_gradient(sdf: SDFNetwork, pts: torch.Tensor):
    """(sdf (P, 1), feature (P, F), gradient (P, 3)): the B6 kernel pair on a
    CUDA tensor when the gate is open, else the plain module (twin of the JAX
    package's ``sdf_with_gradient``)."""
    cfg = sdf.cfg
    if cfg.use_pallas and pts.is_cuda and cfg.d_hidden >= _KERNEL_WIDTH:
        from ..ops import fused_sdf

        if fused_sdf.spec_from_config(cfg) is not None:
            return fused_sdf.sdf_with_gradient_fused(sdf, pts)
    return sdf.sdf_with_gradient(pts)


def color_eval(color: ColorNetwork, points, normals, view_dirs, features) -> torch.Tensor:
    """The colour net's output (P, 3 | 6): the B7 kernel pair on a CUDA
    tensor when the gate is open, else the plain module (twin of the JAX
    package's ``color_eval``)."""
    cfg = color.cfg
    if cfg.use_pallas and points.is_cuda and cfg.d_hidden >= _KERNEL_WIDTH:
        from ..ops import fused_color

        if fused_color.spec_from_config(cfg) is not None:
            return fused_color.color_apply_fused(color, points, normals, view_dirs, features)
    return color(points, normals, view_dirs, features)
