"""The colour (rendering) MLP pair (B7): CUDA forward/backward, plain version,
autograd.

Twin of avatarclip_tpu/ops/fused_color.py: `color_apply_fused` (the entry),
`_fused_core` (the custom VJP), Pallas `_fwd_kernel` / `_bwd_kernel`. Per
point: the colour net over separate inputs (points, normals, view
directions (P, 3) and the geometry feature (P, F)), returning the sigmoid of
its head, (P, 3) or (P, 6) with the extra head; the backward returns the
cotangents of all four inputs and every dense weight gradient
(csrc/fused_color.cu). The renderer's per-sample branch reaches it through
``fields.networks.color_eval`` when the megakernel is declined (the NeRF++
background is on).

:func:`color_apply_fused` takes CUDA tensors and launches the kernel pair
through :class:`ColorFunction`, or raises; on the CPU only the gate in
fields/networks.py picks the plain module (:func:`color_apply_plain`, in the
input's dtype). The kernels and the plain version take the net's operand mode
(``fields.networks.operand_bf16``): bf16 dot operands with f32 sums at the
confs' bf16, f32 throughout at f32. :func:`dense_weights` resolves
weight norm in plain torch and cuts the first layer into per-input slices
(a zero slice for the input a mode does not read), so the concatenated
input is never built; the head stacks the main and extra heads.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .fused_neus import Dims, n_cta_for, split_flat
from .fused_sdf import BLOCK, LANE
from ..fields.networks import ColorNetwork, kernel_color_forward, operand_bf16

LAUNCHES = {"color_fwd": 0, "color_bwd": 0}
MAX_LAYERS = 8  # neus_mlp.cuh's MAXNHC
# first-layer input columns (points, normals, view dirs, feature) per mode,
# in the order of the colour net's concatenation
_COLUMNS = {"idr": (0, 6, 3, 9), "no_view_dir": (0, 3, None, 6), "no_normal": (0, None, 3, 6)}


@dataclasses.dataclass(frozen=True)
class FusedColorSpec:
    mode: str  # idr | no_view_dir | no_normal
    d_hidden: int
    n_hidden: int  # relu hidden linears (cfg.n_layers)
    d_feature: int
    extra_color: bool
    squeeze_out: bool
    bf16: bool = False  # the operand mode (fields.networks.operand_bf16)

    @property
    def rgb_width(self) -> int:
        return 6 if self.extra_color else 3

    @property
    def n_vectors(self) -> int:
        """The (P, 3) inputs the mode reads (points always; normals, view
        directions or both)."""
        return sum(c is not None for c in _COLUMNS[self.mode][:3])

    def dims(self) -> Dims:
        """neus::Dims fields the colour kernels read: F, HC, NHC, W, squeeze."""
        return Dims(BLOCK, 0, 0, 0, 0, 0, self.d_feature, self.d_hidden, self.n_hidden, 0,
                    self.rgb_width, int(self.squeeze_out), 1.0, int(self.bf16))


def spec_from_config(cfg) -> FusedColorSpec | None:
    """ColorConfig -> FusedColorSpec, or None outside the family the kernels
    take (the JAX package's: modes idr / no_view_dir / no_normal with their
    d_in, multires_view 0, d_out 3, d_hidden a multiple of 128; and 1 to 8
    relu linears)."""
    if cfg.mode not in _COLUMNS or cfg.multires_view != 0 or cfg.d_out != 3:
        return None
    if cfg.d_hidden % LANE != 0 or not 1 <= cfg.n_layers <= MAX_LAYERS:
        return None
    if cfg.d_in != (9 if cfg.mode == "idr" else 6):
        return None
    return FusedColorSpec(mode=cfg.mode, d_hidden=cfg.d_hidden, n_hidden=cfg.n_layers,
                          d_feature=cfg.d_feature, extra_color=cfg.extra_color,
                          squeeze_out=cfg.squeeze_out, bf16=operand_bf16(cfg))


def dense_weights(color: ColorNetwork, spec: FusedColorSpec) -> list[torch.Tensor]:
    """Kernel weight list (differentiable, weight norm resolved in f32): the
    first layer as wx, wn, wv (H, 3), wf (H, F) and b0; each further relu
    linear as (W, b); the head (W (3 | 6, H), b) with the extra head under
    the main one. The flat layout of csrc/fused_color.cu."""
    w0 = color.layers[0].dense()
    H, F = spec.d_hidden, spec.d_feature
    cx, cn, cv, cf = _COLUMNS[spec.mode]

    def cols(c, k):
        return w0[:, c:c + k] if c is not None else w0.new_zeros(H, k)

    out = [cols(cx, 3), cols(cn, 3), cols(cv, 3), cols(cf, F), color.layers[0].b]
    for layer in color.layers[1:-1]:
        out += [layer.dense(), layer.b]
    head = color.layers[-1]
    if color.extra is not None:
        out += [torch.cat([head.dense(), color.extra.dense()]), torch.cat([head.b, color.extra.b])]
    else:
        out += [head.dense(), head.b]
    return [t.float().contiguous() for t in out]


def color_apply_plain(color: ColorNetwork, points, normals, view_dirs, features):
    """Plain PyTorch version of the kernel pair: the net at the kernel's
    rounding points (the net's operand mode) in the inputs' dtype (f64 gives
    a reference)."""
    return kernel_color_forward(color, points, normals, view_dirs, features)


def flops_per_point(spec: FusedColorSpec) -> tuple[float, float]:
    """(forward, backward) GEMM FLOPs per point of the kernels (the form of
    the JAX package's ``kernel_flops_per_point``, at the kernels' unpadded
    widths, over the inputs the mode reads: the kernels also run the zero
    first-layer slice of an input a mode leaves out, which the function does
    not need). The backward recomputes the forward."""
    H, F, nh, W = spec.d_hidden, spec.d_feature, spec.n_hidden, spec.rgb_width
    V = 3 * spec.n_vectors
    stack = V * H + F * H + (nh - 1) * H * H + H * W
    bwd = (stack + H * W + W * H + (nh - 1) * 2 * H * H + V * H + F * H + H * V + H * F)
    return 2.0 * stack, 2.0 * bwd


# ---------------------------------------------------------------------------
# CUDA kernel pair
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("fused_color", "fused_color.cu")
    if not getattr(lib, "_typed", False):
        P, I, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.colour_weight_count.argtypes = [Dims]
        lib.colour_weight_count.restype = L_
        lib.colour_workspace_floats.argtypes = [Dims, I]
        lib.colour_workspace_floats.restype = L_
        lib.colour_fwd.argtypes = [Dims, P, P, P, P, P, I, P, P, L_, I, P]
        lib.colour_fwd.restype = I
        lib.colour_bwd.argtypes = [Dims, P, P, P, P, P, I, P, P, P, P, P, P, P, P, L_, I, P]
        lib.colour_bwd.restype = I
        lib._typed = True
    return lib


def _check(spec: FusedColorSpec, lib, flat, x, n, v, f):
    P = x.shape[0]
    if not x.is_cuda or flat.device != x.device:
        raise ValueError("the colour kernel takes inputs and weights on one CUDA device")
    _build.check_f32(x.device, (("points", x, (P, 3)), ("normals", n, (P, 3)),
                                ("view_dirs", v, (P, 3)), ("features", f, (P, spec.d_feature)),
                                ("flat", flat, (flat.numel(),))))
    if flat.numel() != lib.colour_weight_count(spec.dims()):
        raise ValueError("flat weight buffer does not match the network dims")
    if P >= 2**31:
        raise ValueError("the colour kernel takes fewer than 2^31 points")


def color_fwd(spec: FusedColorSpec, flat, x, n, v, f):
    """Launch the forward kernel. Returns (P, 3 | 6) after the sigmoid."""
    lib = _lib()
    _check(spec, lib, flat, x, n, v, f)
    d, dev, P = spec.dims(), x.device, x.shape[0]
    n_cta = n_cta_for(dev, -(-P // BLOCK))
    stride = int(lib.colour_workspace_floats(d, 0))
    ws = torch.empty(n_cta * stride, device=dev)
    out = torch.empty(P, spec.rgb_width, device=dev)
    p = _build.ptr
    err = lib.colour_fwd(d, p(flat), p(x), p(n), p(v), p(f), P, p(out), p(ws), stride, n_cta,
                         _build.stream_ptr(dev))
    _build.check(err, "colour_fwd launch")
    _build.count(LAUNCHES, "color_fwd")
    return out


def color_bwd(spec: FusedColorSpec, flat, x, n, v, f, c_out):
    """Launch the backward kernel (+ its partial-sum pass). Returns
    (dx, dn, dv (P, 3), df (P, F), d_flat)."""
    lib = _lib()
    _check(spec, lib, flat, x, n, v, f)
    d, dev, P = spec.dims(), x.device, x.shape[0]
    _build.check_f32(dev, (("c_out", c_out, (P, spec.rgb_width)),))
    n_w = flat.numel()
    n_cta = n_cta_for(dev, -(-P // BLOCK))
    stride = int(lib.colour_workspace_floats(d, 1))
    ws = torch.empty(n_cta * stride, device=dev)
    gpart = torch.empty(n_cta * n_w, device=dev)
    dx, dn, dv = (torch.empty(P, 3, device=dev) for _ in range(3))
    df = torch.empty(P, spec.d_feature, device=dev)
    d_w = torch.empty(n_w, device=dev)
    p = _build.ptr
    err = lib.colour_bwd(d, p(flat), p(x), p(n), p(v), p(f), P, p(c_out), p(dx), p(dn), p(dv),
                         p(df), p(d_w), p(gpart), p(ws), stride, n_cta, _build.stream_ptr(dev))
    _build.check(err, "colour_bwd launch")
    _build.count(LAUNCHES, "color_bwd")
    return dx, dn, dv, df, d_w


class ColorFunction(torch.autograd.Function):
    """(spec, points, normals, view_dirs, features, *dense weights) ->
    (P, 3 | 6); forward and backward are the CUDA kernels."""

    @staticmethod
    def forward(ctx, spec, x, n, v, f, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        out = color_fwd(spec, flat, x, n, v, f)
        ctx.save_for_backward(flat, x, n, v, f)
        ctx.spec = spec
        ctx.shapes = [w.shape for w in weights]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, c_out):
        flat, x, n, v, f = ctx.saved_tensors
        dx, dn, dv, df, d_flat = color_bwd(ctx.spec, flat, x, n, v, f, c_out.float().contiguous())
        return (None, dx, dn, dv, df, *split_flat(d_flat, ctx.shapes))


def color_apply_fused(color: ColorNetwork, points, normals, view_dirs, features):
    """The colour net's output (P, 3 | 6) by the kernel pair. Takes CUDA
    tensors and raises on any other: on the CPU the gate
    (fields.networks.color_eval) picks the plain module."""
    if not points.is_cuda:
        raise ValueError("color_apply_fused takes CUDA tensors (the kernels have no CPU mode)")
    spec = spec_from_config(color.cfg)
    if spec is None:
        raise ValueError("network configuration not supported by the colour kernel")
    c = lambda t: t.float().contiguous()
    return ColorFunction.apply(spec, c(points), c(normals), c(view_dirs), c(features),
                               *dense_weights(color, spec))
