"""The standalone SDF kernels: the sdf+gradient pair (B6) and the sdf-only
forward (B8's #12), with their plain versions and autograd Functions.

Twin of avatarclip_tpu/ops/fused_sdf.py: `sdf_with_gradient_fused` (the
entry), `_fused_core` (the custom VJP), Pallas `_fwd_kernel` /
`_bwd_kernel`. Per point of (P, 3): the SDF MLP with its analytic spatial
gradient, returning ``(sdf (P, 1), feature (P, F), gradient (P, 3))``; the
backward takes cotangents on all three and returns d(points) and every dense
weight gradient (forward-over-reverse, csrc/fused_sdf.cu). The renderer's
per-sample branch reaches it through ``fields.networks.sdf_with_gradient``
when the megakernel is declined (the NeRF++ background is on).

:func:`sdf_with_gradient_fused` takes a CUDA tensor and launches the kernel
pair through :class:`SDFFunction` (on the tensor cores in the bf16 operand
mode: csrc/fused_neus_ray_tc.cu's ``sdf_tc_fwd`` and ``sdf_tc_bwd``, whose
weights ``fused_neus.pack_tc`` packs from the SDF layers alone, once a step;
csrc/fused_sdf.cu's pair in the f32 mode), or raises; on the
CPU only the gate in fields/networks.py picks :func:`sdf_with_gradient_plain`, autograd through
the plain module's maths with ``create_graph=True`` in the input's dtype.
The kernels and their plain versions take the net's operand mode
(``fields.networks.operand_bf16``, ops/fused_neus.py): bf16 dot operands
with f32 sums at the confs' bf16, f32 throughout at f32. Weight norm is resolved to dense (out, in) weights
in plain torch before the Function (:func:`dense_weights`), so autograd
carries the kernel's dense weight gradients on to ``g``, ``v`` and ``b``.
The Function's backward is itself not differentiable: the eikonal term's
second derivative is the backward kernel's tangent path, not a double
backward.

The sdf-only forward (twin of `sdf_value_fused` / `_sdf_only_core`, Pallas
`_sdf_only_kernel`) returns sdf (P, 1) alone, for the sdf-only queries behind
``fields.networks.sdf_value``'s ``_SWEEP_KERNEL`` hook: on the tensor cores in
the bf16 mode (csrc/fused_neus_ray_tc.cu's ``sdf_only_tc_fwd``, the stack's
matrices packed per call by ``fused_neus.pack_sdf_only_tc``), csrc/fused_sdf.cu's
kernel in f32. Its Function's forward is the kernel and its backward autograd
of :func:`sdf_only_plain`, as the JAX package's ``_sdf_only_bwd``
differentiates its plain ``_dense_sdf_only``: there is no backward kernel.
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
from ..fields.networks import (SDFNetwork, kernel_sdf_forward, kernel_sdf_with_gradient,
                               operand_bf16)

BLOCK = 64  # points per CTA iteration (neus_mlp.cuh's MAXS)
LANE = 128  # the JAX family's width granule, kept so both packages take one family
MAX_HIDDEN = 8  # neus_mlp.cuh's MAXNH


@dataclasses.dataclass(frozen=True)
class FusedSDFSpec:
    multires: int
    d_hidden: int
    n_hidden: int  # hidden linears before the skip-producing layer
    feat_dim: int  # d_out - 1
    scale: float
    bf16: bool = False  # the operand mode (fields.networks.operand_bf16)

    @property
    def d_embed(self) -> int:
        return 3 * (1 + 2 * self.multires)

    def dims(self) -> Dims:
        """neus::Dims of the SDF half alone: no colour layers; CW = 6 + F is
        the slot layout in which the backward reads the feature cotangent."""
        E = self.d_embed
        return Dims(BLOCK, self.multires, E, self.d_hidden, self.n_hidden, self.d_hidden - E,
                    self.feat_dim, 0, 0, 6 + self.feat_dim, 0, 0, float(self.scale),
                    int(self.bf16))


def spec_from_config(cfg) -> FusedSDFSpec | None:
    """SDFConfig -> FusedSDFSpec, or None outside the family the kernels take
    (the JAX package's: d_in 3, positional encoding, d_hidden a multiple of
    128 wider than the embedding, one skip concat right before the head; and
    1 to 8 hidden linears before the skip-producing layer)."""
    if cfg.d_in != 3 or cfg.multires < 1 or cfg.d_hidden % LANE != 0:
        return None
    if tuple(cfg.skip_in) != (cfg.n_layers,) or not 2 <= cfg.n_layers <= MAX_HIDDEN + 1:
        return None
    if cfg.d_hidden <= 3 * (1 + 2 * cfg.multires):
        return None
    return FusedSDFSpec(multires=cfg.multires, d_hidden=cfg.d_hidden, n_hidden=cfg.n_layers - 1,
                        feat_dim=cfg.d_out - 1, scale=cfg.scale, bf16=operand_bf16(cfg))


def dense_weights(sdf: SDFNetwork) -> list[torch.Tensor]:
    """Kernel weight list (differentiable, weight norm resolved in f32):
    every layer as (W (out, in), b), the flat layout of csrc/neus_mlp.cuh's
    SDF part."""
    out = []
    for layer in sdf.layers:
        out += [layer.dense(), layer.b]
    return [t.float() for t in out]


def sdf_with_gradient_plain(sdf: SDFNetwork, pts: torch.Tensor):
    """Plain PyTorch version of the kernel pair: the net's forward at the
    kernel's rounding points (the net's operand mode) and its spatial
    gradient by autograd (create_graph=True), computed in the input's dtype
    (f64 gives a reference); in bf16 mode the head's sdf row is rounded too,
    as the JAX pair's ``_dot`` rounds it."""
    return kernel_sdf_with_gradient(sdf, pts, round_sdf_row=True)


def sdf_only_plain(sdf: SDFNetwork, pts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sdf-only kernel: the stack at the net's
    operand mode and the head's sdf row alone (summed unrounded, as the JAX
    kernel's row form), in the input's dtype -> (P, 1)."""
    return kernel_sdf_forward(sdf, pts, sdf_only=True)


def sdf_only_flops_per_point(spec: FusedSDFSpec) -> float:
    """GEMM FLOPs per point of the sdf-only forward: the stack and the
    head's sdf row."""
    E, H, NH = spec.d_embed, spec.d_hidden, spec.n_hidden
    return float(2 * E * H + (NH - 1) * 2 * H * H + 2 * H * (H - E) + 2 * H)


def flops_per_point(spec: FusedSDFSpec) -> tuple[float, float]:
    """(forward, backward) GEMM FLOPs per point of the kernels, from the
    network dims. Forward: the stack and the gradient's reverse sweep.
    Backward: the primal stack again, the tangent stack, the head and the
    reverse passes over primal and tangent (the elementwise work is not
    counted)."""
    E, H, NH, F1 = spec.d_embed, spec.d_hidden, spec.n_hidden, spec.feat_dim + 1
    SW = H - E
    stack = 2 * E * H + (NH - 1) * 2 * H * H + 2 * H * SW
    fwd = stack + 2 * H * F1 + 2 * SW * H + (NH - 1) * 2 * H * H + 2 * H * E
    bwd = (stack + 2 * H * F1) + stack + 4 * F1 * H + 8 * SW * H + 8 * H * E + (NH - 1) * 8 * H * H
    return float(fwd), float(bwd)


# ---------------------------------------------------------------------------
# CUDA kernel pair
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("fused_sdf", "fused_sdf.cu")
    if not getattr(lib, "_typed", False):
        P, I, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sdf_weight_count.argtypes = [Dims]
        lib.sdf_weight_count.restype = L_
        lib.sdf_workspace_floats.argtypes = [Dims, I]
        lib.sdf_workspace_floats.restype = L_
        lib.sdf_fwd.argtypes = [Dims, P, P, I, P, P, P, P, L_, I, P]
        lib.sdf_fwd.restype = I
        lib.sdf_bwd.argtypes = [Dims, P, P, I, P, P, P, P, P, P, P, L_, I, P]
        lib.sdf_bwd.restype = I
        lib.sdf_only_fwd.argtypes = [Dims, P, P, I, P, P, L_, I, P]
        lib.sdf_only_fwd.restype = I
        lib._typed = True
    return lib


def _check(spec: FusedSDFSpec, lib, flat, pts, tc: bool = False):
    """The flat weights against the library's own weight count (the
    tensor-core one when ``tc``), then the inputs: f32, contiguous, on one
    CUDA device."""
    count = lib.neus_tc_weight_count if tc else lib.sdf_weight_count
    if flat.numel() != count(spec.dims()):
        raise ValueError("flat weight buffer does not match the network dims")
    if not pts.is_cuda or flat.device != pts.device:
        raise ValueError("the SDF kernel takes points and weights on one CUDA device")
    _build.check_f32(pts.device, (("pts", pts, (pts.shape[0], 3)), ("flat", flat, (flat.numel(),))))
    if pts.shape[0] >= 2**31:
        raise ValueError("the SDF kernel takes fewer than 2^31 points")


def sdf_fwd(spec: FusedSDFSpec, flat, pts, packed=None):
    """Launch the forward kernel: in the bf16 mode the tensor-core one
    (``packed`` = fused_neus.pack_tc's (pk, pack) of the SDF layers, packed
    from ``flat`` when None), in f32 fused_sdf.cu's. Returns (sdf (P, 1),
    feature (P, F), gradient (P, 3))."""
    lib = fused_neus._tc_lib() if spec.bf16 else _lib()
    _check(spec, lib, flat, pts, tc=spec.bf16)
    d, dev, P = spec.dims(), pts.device, pts.shape[0]
    sdf = torch.empty(P, 1, device=dev)
    feat = torch.empty(P, spec.feat_dim, device=dev)
    grad = torch.empty(P, 3, device=dev)
    p = _build.ptr
    if spec.bf16:
        pk, pack = fused_neus.pack_flat(spec, flat) if packed is None else packed
        fused_neus.check_packed(pk, dev)
        n_cta = fused_neus.n_cta_tc(dev, -(-P // BLOCK))
        stride = int(lib.neus_tc_scratch_bytes(d, 0))
        scr = torch.empty(n_cta * stride, dtype=torch.uint8, device=dev)
        err = lib.sdf_tc_fwd(d, pack, p(flat), p(pk), p(pts), P, p(sdf), p(feat), p(grad), p(scr),
                             stride, n_cta, _build.stream_ptr(dev))
    else:
        n_cta = n_cta_for(dev, -(-P // BLOCK))
        stride = int(lib.sdf_workspace_floats(d, 0))
        ws = torch.empty(n_cta * stride, device=dev)
        err = lib.sdf_fwd(d, p(flat), p(pts), P, p(sdf), p(feat), p(grad), p(ws), stride, n_cta,
                          _build.stream_ptr(dev))
    _build.check(err, "sdf_fwd launch")
    trace.count("sdf_fwd")
    return sdf, feat, grad


def sdf_only_fwd(spec: FusedSDFSpec, flat, pts, packed=None):
    """Launch the sdf-only kernel: in the bf16 mode the tensor-core one
    (``packed`` = fused_neus.pack_sdf_only_tc's (pk, pack), packed from
    ``flat`` when None), in f32 fused_sdf.cu's. Returns sdf (P, 1)."""
    lib = fused_neus._tc_lib() if spec.bf16 else _lib()
    _check(spec, lib, flat, pts, tc=spec.bf16)
    d, dev, P = spec.dims(), pts.device, pts.shape[0]
    sdf = torch.empty(P, 1, device=dev)
    if P == 0:
        return sdf
    p = _build.ptr
    if spec.bf16:
        if packed is None:
            packed = fused_neus.pack_sdf_only_tc(spec, split_flat(flat, fused_neus.flat_shapes(d)))
        pk, pack = packed
        fused_neus.check_packed(pk, dev)
        n_cta = fused_neus.n_cta_tc(dev, -(-P // BLOCK))
        stride = int(lib.neus_tc_scratch_bytes(d, 0))
        scr = torch.empty(n_cta * stride, dtype=torch.uint8, device=dev)
        err = lib.sdf_only_tc_fwd(d, pack, p(flat), p(pk), p(pts), P, p(sdf), p(scr), stride, n_cta,
                                  _build.stream_ptr(dev))
    else:
        n_cta = n_cta_for(dev, -(-P // BLOCK))
        stride = int(lib.sdf_workspace_floats(d, 0))
        ws = torch.empty(n_cta * stride, device=dev)
        err = lib.sdf_only_fwd(d, p(flat), p(pts), P, p(sdf), p(ws), stride, n_cta,
                               _build.stream_ptr(dev))
    _build.check(err, "sdf_only_fwd launch")
    trace.count("sdf_only_fwd")
    return sdf


def sdf_bwd(spec: FusedSDFSpec, flat, pts, c_sdf, c_feat, c_grad, packed=None):
    """Launch the backward kernel (+ its partial-sum pass): in the bf16 mode
    the tensor-core one (``packed`` = fused_neus.pack_tc's (pk, pack) of the
    SDF layers, packed from ``flat`` when None), in f32 fused_sdf.cu's.
    Returns (d_pts (P, 3), d_flat)."""
    lib = fused_neus._tc_lib() if spec.bf16 else _lib()
    _check(spec, lib, flat, pts, tc=spec.bf16)
    d, dev, P = spec.dims(), pts.device, pts.shape[0]
    _build.check_f32(dev, (("c_sdf", c_sdf, (P, 1)), ("c_feat", c_feat, (P, spec.feat_dim)),
                           ("c_grad", c_grad, (P, 3))))
    if spec.bf16:
        return _sdf_tc_bwd(spec, lib, flat, pts, c_sdf, c_feat, c_grad, packed)
    n_w = flat.numel()
    n_cta = n_cta_for(dev, -(-P // BLOCK))
    stride = int(lib.sdf_workspace_floats(d, 1))
    ws = torch.empty(n_cta * stride, device=dev)
    gpart = torch.empty(n_cta * n_w, device=dev)
    d_pts = torch.empty(P, 3, device=dev)
    d_w = torch.empty(n_w, device=dev)
    p = _build.ptr
    err = lib.sdf_bwd(d, p(flat), p(pts), P, p(c_sdf), p(c_feat), p(c_grad), p(d_pts), p(d_w),
                      p(gpart), p(ws), stride, n_cta, _build.stream_ptr(dev))
    _build.check(err, "sdf_bwd launch")
    trace.count("sdf_bwd")
    return d_pts, d_w


def _sdf_tc_bwd(spec, lib, flat, pts, c_sdf, c_feat, c_grad, packed):
    """sdf_bwd's tensor-core kernel: the points in chunks of 64-point tiles
    (fused_neus.tc_bwd_chunking), each chunk's weight-gradient operands
    logged in bf16 and formed by the weight-gradient GEMM over the points."""
    d, dev, P = spec.dims(), pts.device, pts.shape[0]
    pk, pack = fused_neus.pack_flat(spec, flat) if packed is None else packed
    fused_neus.check_packed(pk, dev)
    n_w = flat.numel()
    d_pts = torch.empty(P, 3, device=dev)
    d_w = torch.empty(n_w, device=dev)
    n_cta, chunk, n_split = fused_neus.tc_bwd_chunking(dev, lib, d, -(-P // BLOCK))
    stride = int(lib.neus_tc_scratch_bytes(d, 1))
    scr = torch.empty(n_cta * stride, dtype=torch.uint8, device=dev)
    gpart = torch.zeros((n_cta + 2 * n_split) * n_w, device=dev)
    log = torch.empty(chunk * BLOCK * int(lib.neus_tc_log_row(d)), dtype=torch.bfloat16, device=dev)
    p = _build.ptr
    err = lib.sdf_tc_bwd(d, pack, p(flat), p(pk), p(pts), P, p(c_sdf), p(c_feat), p(c_grad),
                         p(d_pts), p(d_w), p(gpart), p(scr), stride, n_cta, p(log), chunk, n_split,
                         _build.stream_ptr(dev))
    _build.check(err, "sdf_tc_bwd launch")
    trace.count("sdf_bwd")
    return d_pts, d_w


class SDFFunction(torch.autograd.Function):
    """(spec, pts, *dense weights) -> (sdf, feature, gradient); forward and
    backward are the CUDA kernels (on the tensor cores in the bf16 mode, the
    weights packed once in the forward for both), and the backward is not
    differentiated again."""

    @staticmethod
    def forward(ctx, spec, pts, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        if spec.bf16:
            pk, ctx.pack = fused_neus.pack_tc(spec, weights)
            packed = (pk, ctx.pack)
        else:
            pk, packed = flat.new_empty(0), None
        sdf, feat, grad = sdf_fwd(spec, flat, pts, packed)
        ctx.save_for_backward(flat, pk, pts)
        ctx.spec = spec
        ctx.shapes = [w.shape for w in weights]
        return sdf, feat, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, c_sdf, c_feat, c_grad):
        flat, pk, pts = ctx.saved_tensors
        P, dev = pts.shape[0], pts.device

        def cot(t, shape):
            return torch.zeros(shape, device=dev) if t is None else t.float().contiguous()

        d_pts, d_flat = sdf_bwd(ctx.spec, flat, pts, cot(c_sdf, (P, 1)),
                                cot(c_feat, (P, ctx.spec.feat_dim)), cot(c_grad, (P, 3)),
                                packed=(pk, ctx.pack) if ctx.spec.bf16 else None)
        return (None, d_pts, *split_flat(d_flat, ctx.shapes))


def sdf_with_gradient_fused(sdf: SDFNetwork, pts: torch.Tensor):
    """(sdf (P, 1), feature (P, F), gradient (P, 3)) by the kernel pair.
    Takes a CUDA tensor and raises on any other: on the CPU the gate
    (fields.networks.sdf_with_gradient) picks the plain module."""
    if not pts.is_cuda:
        raise ValueError("sdf_with_gradient_fused takes CUDA tensors (the kernels have no CPU mode)")
    spec = spec_from_config(sdf.cfg)
    if spec is None:
        raise ValueError("network configuration not supported by the SDF kernel")
    return SDFFunction.apply(spec, pts.float().contiguous(), *dense_weights(sdf))


class SDFOnlyFunction(torch.autograd.Function):
    """(spec, net, pts, *net parameters) -> sdf (P, 1): the forward is the
    sdf-only kernel (in the bf16 mode its weights packed here, from this
    call's parameters: nothing is cached across calls); the backward
    differentiates :func:`sdf_only_plain` (f32) with respect to the points
    and the net's parameters."""

    @staticmethod
    def forward(ctx, spec, sdf, pts, *params):
        weights = [w.detach() for w in dense_weights(sdf)]
        flat = torch.cat([w.reshape(-1) for w in weights])
        ctx.sdf = sdf
        ctx.save_for_backward(pts)
        if spec.bf16:
            return sdf_only_fwd(spec, flat, pts, fused_neus.pack_sdf_only_tc(spec, weights))
        return sdf_only_fwd(spec, flat, pts)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_sdf):
        (pts,) = ctx.saved_tensors
        params = list(ctx.sdf.parameters())
        with torch.enable_grad():
            x = pts.detach().requires_grad_(True)
            grads = torch.autograd.grad(sdf_only_plain(ctx.sdf, x), [x, *params], c_sdf,
                                        allow_unused=True)
        return (None, None, *grads)


def sdf_value_fused(sdf: SDFNetwork, pts: torch.Tensor) -> torch.Tensor:
    """sdf (P, 1) by the sdf-only kernel. Takes a CUDA tensor and raises on
    any other: on the CPU the hook (fields.networks.sdf_value) picks the
    plain module."""
    if not pts.is_cuda:
        raise ValueError("sdf_value_fused takes CUDA tensors (the kernel has no CPU mode)")
    spec = spec_from_config(sdf.cfg)
    if spec is None:
        raise ValueError("network configuration not supported by the sdf-only kernel")
    return SDFOnlyFunction.apply(spec, sdf, pts.float().contiguous(), *sdf.parameters())
