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
through :class:`ColorFunction` (in the bf16 mode csrc/fused_neus_ray_tc.cu's
``colour_tc_fwd`` and ``colour_tc_bwd`` on the tensor cores, their weights
packed once for both; in f32 csrc/fused_color.cu's pair), or raises; on
the CPU only the gate in
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
from ..utils import trace
from . import fused_neus
from .fused_neus import Dims, n_cta_for, split_flat
from .fused_sdf import BLOCK, LANE
from ..fields.networks import ColorNetwork, kernel_color_forward, operand_bf16

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

    @property
    def d_in(self) -> int:
        """The first layer's input width: the vectors the mode reads, then
        the feature."""
        return 3 * self.n_vectors + self.d_feature

    def dims(self) -> Dims:
        """neus::Dims of the colour net alone (H = 0): F, HC, NHC, W,
        squeeze, and CW = d_in, which the tensor-core backward reads."""
        return Dims(BLOCK, 0, 0, 0, 0, 0, self.d_feature, self.d_hidden, self.n_hidden, self.d_in,
                    self.rgb_width, int(self.squeeze_out), 1.0, int(self.bf16))


def slice_shapes(spec: FusedColorSpec) -> list[torch.Size]:
    """The shapes of :func:`dense_weights`' list (the flat layout of
    csrc/fused_color.cu)."""
    H, F, W = spec.d_hidden, spec.d_feature, spec.rgb_width
    shapes = [(H, 3)] * 3 + [(H, F), (H,)] + [(H, H), (H,)] * (spec.n_hidden - 1) + [(W, H), (W,)]
    return [torch.Size(t) for t in shapes]


def tc_weights(spec: FusedColorSpec, weights) -> list[torch.Tensor]:
    """The tensor-core backward's weight list from :func:`dense_weights`'
    (slice layout): the first layer's slices of the inputs the mode reads
    joined, in their columns' order, into one (H, d_in) matrix; the rest as
    it is. Its flat form is weight_offsets' colour layout
    (csrc/neus_mlp.cuh)."""
    cols = [(c, w) for c, w in zip(_COLUMNS[spec.mode], weights[:3]) if c is not None]
    w0 = torch.cat([w for _, w in sorted(cols, key=lambda cw: cw[0])] + [weights[3]], 1)
    return [w0, *weights[4:]]


def slices_from_tc(spec: FusedColorSpec, d_tc: torch.Tensor) -> torch.Tensor:
    """A flat gradient in :func:`tc_weights`' layout back in the slice
    layout: the first layer's columns cut into the per-input slices, a zero
    slice for an input the mode does not read."""
    H, F = spec.d_hidden, spec.d_feature
    d0 = d_tc[:H * spec.d_in].reshape(H, spec.d_in)
    vec = [d0[:, c:c + 3] if c is not None else d0.new_zeros(H, 3) for c in _COLUMNS[spec.mode][:3]]
    return torch.cat([t.reshape(-1) for t in vec + [d0[:, -F:]]] + [d_tc[H * spec.d_in:]])


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
        lib.colour_workspace_floats.argtypes = [Dims, I]
        lib.colour_workspace_floats.restype = L_
        lib.colour_fwd.argtypes = [Dims, P, P, P, P, P, I, P, P, L_, I, P]
        lib.colour_fwd.restype = I
        lib.colour_bwd.argtypes = [Dims, P, P, P, P, P, I, P, P, P, P, P, P, P, P, L_, I, P]
        lib.colour_bwd.restype = I
        lib._typed = True
    return lib


def _check(spec: FusedColorSpec, flat, x, n, v, f):
    P = x.shape[0]
    if not x.is_cuda or flat.device != x.device:
        raise ValueError("the colour kernel takes inputs and weights on one CUDA device")
    _build.check_f32(x.device, (("points", x, (P, 3)), ("normals", n, (P, 3)),
                                ("view_dirs", v, (P, 3)), ("features", f, (P, spec.d_feature)),
                                ("flat", flat, (flat.numel(),))))
    if flat.numel() != sum(s.numel() for s in slice_shapes(spec)):
        raise ValueError("flat weight buffer does not match the network dims")
    if P >= 2**31:
        raise ValueError("the colour kernel takes fewer than 2^31 points")


def tc_pack(spec: FusedColorSpec, flat) -> tuple[torch.Tensor, torch.Tensor, fused_neus.Pack]:
    """The tensor-core kernels' weights from the flat slice-layout buffer
    (flat_tc, the (H, d_in) first layer joined in :func:`tc_weights`'
    layout; pk, its packed bf16 fragments; pack, their offsets): made once a
    step by :class:`ColorFunction` for both kernels."""
    weights = tc_weights(spec, split_flat(flat, slice_shapes(spec)))
    pk, pack = fused_neus.pack_colour_tc(weights)
    return torch.cat([w.reshape(-1) for w in weights]), pk, pack


def color_fwd(spec: FusedColorSpec, flat, x, n, v, f, packed=None):
    """Launch the forward kernel: in the bf16 mode the tensor-core one
    (``packed``: :func:`tc_pack`'s, made here when not given), in f32
    fused_color.cu's. Returns (P, 3 | 6) after the sigmoid."""
    lib = fused_neus._tc_lib() if spec.bf16 else _lib()
    _check(spec, flat, x, n, v, f)
    if spec.bf16:
        return _color_tc_fwd(spec, lib, packed if packed is not None else tc_pack(spec, flat),
                             x, n, v, f)
    d, dev, P = spec.dims(), x.device, x.shape[0]
    n_cta = n_cta_for(dev, -(-P // BLOCK))
    stride = int(lib.colour_workspace_floats(d, 0))
    ws = torch.empty(n_cta * stride, device=dev)
    out = torch.empty(P, spec.rgb_width, device=dev)
    p = _build.ptr
    err = lib.colour_fwd(d, p(flat), p(x), p(n), p(v), p(f), P, p(out), p(ws), stride, n_cta,
                         _build.stream_ptr(dev))
    _build.check(err, "colour_fwd launch")
    trace.count("color_fwd")
    return out


def color_bwd(spec: FusedColorSpec, flat, x, n, v, f, c_out, packed=None):
    """Launch the backward kernel (+ its partial-sum pass): in the bf16 mode
    the tensor-core one (``packed`` as for :func:`color_fwd`), in f32
    fused_color.cu's. Returns (dx, dn, dv (P, 3), df (P, F), d_flat)."""
    lib = fused_neus._tc_lib() if spec.bf16 else _lib()
    _check(spec, flat, x, n, v, f)
    d, dev, P = spec.dims(), x.device, x.shape[0]
    _build.check_f32(dev, (("c_out", c_out, (P, spec.rgb_width)),))
    if spec.bf16:
        return _color_tc_bwd(spec, lib, packed if packed is not None else tc_pack(spec, flat),
                             x, n, v, f, c_out)
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
    trace.count("color_bwd")
    return dx, dn, dv, df, d_w


def _tc_weights_checked(spec, lib, packed, what):
    if spec.d_hidden > 256 or spec.d_feature > 256:
        raise ValueError(f"the tensor-core colour {what} takes nets at most 256 wide")
    flat_tc, pk, pack = packed
    if flat_tc.numel() != lib.neus_tc_weight_count(spec.dims()):
        raise ValueError("flat weight buffer does not match the network dims")
    fused_neus.check_packed(pk, flat_tc.device)
    return flat_tc, pk, pack


def _color_tc_fwd(spec, lib, packed, x, n, v, f):
    """color_fwd's tensor-core kernel: persistent CTAs (one an SM) over
    64-point tiles, the feature streamed in by bulk copies (16-byte aligned
    rows: an unaligned feature is copied first)."""
    flat_tc, pk, pack = _tc_weights_checked(spec, lib, packed, "forward")
    if spec.d_feature % 4:
        raise ValueError("the tensor-core colour forward takes a feature width that is a multiple of 4")
    d, dev, P = spec.dims(), x.device, x.shape[0]
    if f.data_ptr() % 16:
        f = f.clone()
    out = torch.empty(P, spec.rgb_width, device=dev)
    p = _build.ptr
    cx, cn, cv = (-1 if c is None else c for c in _COLUMNS[spec.mode][:3])
    err = lib.colour_tc_fwd(d, pack, p(flat_tc), p(pk), p(x), p(n), p(v), p(f), P, cx, cn, cv,
                            p(out), fused_neus.n_cta_tc(dev, -(-P // BLOCK)),
                            _build.stream_ptr(dev))
    _build.check(err, "colour_tc_fwd launch")
    trace.count("color_fwd")
    return out


def _color_tc_bwd(spec, lib, packed, x, n, v, f, c_out):
    """color_bwd's tensor-core kernel: the weights packed from the colour
    layers alone (first layer joined over the mode's columns), the points in
    chunks of 64-point tiles (fused_neus.tc_bwd_chunking), each chunk's
    weight-gradient operands logged in bf16 and formed by the weight-gradient
    GEMM over the points; the first layer's gradient cut back into its
    slices."""
    flat_tc, pk, pack = _tc_weights_checked(spec, lib, packed, "backward")
    d, dev, P = spec.dims(), x.device, x.shape[0]
    n_w = flat_tc.numel()
    n_cta, chunk, n_split = fused_neus.tc_bwd_chunking(dev, lib, d, -(-P // BLOCK))
    gpart = torch.zeros((n_cta + n_split) * n_w, device=dev)
    log = torch.empty(chunk * BLOCK * int(lib.neus_tc_log_row(d)), dtype=torch.bfloat16, device=dev)
    cols = _COLUMNS[spec.mode][:3]  # points, normals, view directions
    # an input the mode does not read gets a zero cotangent, which the kernel leaves as it is
    dx, dn, dv = (torch.empty(P, 3, device=dev) if c is not None else torch.zeros(P, 3, device=dev)
                  for c in cols)
    df = torch.empty(P, spec.d_feature, device=dev)
    d_tc = torch.empty(n_w, device=dev)
    p = _build.ptr
    cx, cn, cv = (-1 if c is None else c for c in cols)
    err = lib.colour_tc_bwd(d, pack, p(flat_tc), p(pk), p(x), p(n), p(v), p(f), P, cx, cn, cv,
                            p(c_out), p(dx), p(dn), p(dv), p(df), p(d_tc), p(gpart), n_cta, p(log),
                            chunk, n_split, _build.stream_ptr(dev))
    _build.check(err, "colour_tc_bwd launch")
    trace.count("color_bwd")
    return dx, dn, dv, df, slices_from_tc(spec, d_tc)


class ColorFunction(torch.autograd.Function):
    """(spec, points, normals, view_dirs, features, *dense weights) ->
    (P, 3 | 6); forward and backward are the CUDA kernels (the backward on
    the tensor cores in the bf16 mode)."""

    @staticmethod
    def forward(ctx, spec, x, n, v, f, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        # the bf16 mode's packed weights, made once for both kernels
        ctx.packed = tc_pack(spec, flat) if spec.bf16 else None
        out = color_fwd(spec, flat, x, n, v, f, ctx.packed)
        ctx.save_for_backward(flat, x, n, v, f)
        ctx.spec = spec
        ctx.shapes = [w.shape for w in weights]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, c_out):
        flat, x, n, v, f = ctx.saved_tensors
        dx, dn, dv, df, d_flat = color_bwd(ctx.spec, flat, x, n, v, f, c_out.float().contiguous(),
                                           ctx.packed)
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
