"""Per-ray NeuS compositing pair: CUDA forward/backward, plain version, autograd.

Twin of avatarclip_tpu/ops/fused_composite.py: `composite_fused` (the entry),
`_fused` (the custom VJP) and the Pallas kernels `_fwd_kernel` /
`_bwd_kernel`. Per ray of S samples:

    trans_k = prod_{j<k} (1 - alpha_j + 1e-7),  w = alpha * trans
    color = sum_k w_k rgb_k[:3]   extra = sum_k w_k rgb_k[3:6] (zeros at W 3)
    normals_w = sum_k w_k grad_k  (un-normalised)

On a CUDA tensor :func:`composite` runs ``csrc/fused_composite.cu`` through
:class:`CompositeFunction` (the backward is the second kernel; no fallback);
on a CPU tensor it runs :func:`composite_plain`, differentiated by autograd.
The kernels take S <= 64 samples (one warp per ray) and any ray count: the
TPU version's padding to 64-ray blocks has no counterpart. Both kernels
stage each CTA's RAYS_PER_CTA rays through shared memory by 16-byte copies,
and the backward writes its d rgb and d grad spans back by 16-byte stores;
:func:`cta_span`, :func:`stage_plan` and :func:`unstage_plan` are the Python
twins of their index maps (tests/test_torch_composite_stage.py,
tests/test_torch_backward_plans.py).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches, counted by the wrappers (reset by callers that measure)
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0}
MAX_SAMPLES = 64


def composite_plain(alpha, rgb, grad):
    """alpha (R, S), rgb (R, S, 3|6), grad (R, S, 3) -> (weights (R, S),
    color (R, 3), extra (R, 3), normals_w (R, 3)), in the inputs' dtype."""
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], -1), -1
    )[:, :-1]
    weights = alpha * trans
    color = (rgb[..., :3] * weights[..., None]).sum(1)
    if rgb.shape[-1] == 6:
        extra = (rgb[..., 3:6] * weights[..., None]).sum(1)
    else:
        extra = torch.zeros_like(color)
    normals_w = (grad * weights[..., None]).sum(1)
    return weights, color, extra, normals_w


RAYS_PER_CTA = 4  # csrc/fused_composite.cu's RAYS: either pass's rays a CTA, one a warp


def cta_span(cta: int, R: int, S: int, width: int) -> tuple[int, int]:
    """(first float, floats) of CTA ``cta``'s rows of an (R, S, width) input
    or output of either pass: its rays' rows, one contiguous span."""
    r0 = cta * RAYS_PER_CTA
    return r0 * S * width, min(RAYS_PER_CTA, R - r0) * S * width


def stage_plan(m: int, n: int) -> list[tuple[int, int, int]]:
    """Twin of fused_composite.cu's ``stage``: the copies that bring a span
    of n floats, whose first lies m floats (0..3) past a 16-byte boundary,
    into a shared buffer with float j at m + j, as (first float of the span,
    first buffer float, floats): single floats up to the first boundary,
    4-float (16-byte) copies, then the last < 4 floats one at a time."""
    head = min((4 - m) % 4, n)
    n4 = (n - head) // 4
    tail0 = head + 4 * n4
    return ([(j, m + j, 1) for j in range(head)] + [(head + 4 * i, m + head + 4 * i, 4)
                                                   for i in range(n4)]
            + [(j, m + j, 1) for j in range(tail0, n)])


def unstage_plan(m_src: int, m_dst: int, n: int) -> list[tuple[int, int, int]]:
    """Twin of fused_composite.cu's ``unstage``: the stores that write a span
    of n floats, held in a shared buffer with float j at m_src + j, to a
    destination whose first float lies m_dst floats (0..3) past a 16-byte
    boundary, as (first float of the span, first buffer float, floats):
    single floats up to the destination's first boundary, 4-float (16-byte)
    stores, then the last < 4 floats one at a time."""
    return [(j, m_src + j, k) for j, _, k in stage_plan(m_dst, n)]


def _lib():
    lib = _build.load("fused_composite", "fused_composite.cu")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.composite_fwd.argtypes = [I, I, I] + [P] * 8
        lib.composite_fwd.restype = I
        lib.composite_bwd.argtypes = [I, I, I] + [P] * 11
        lib.composite_bwd.restype = I
        lib._typed = True
    return lib


def _check(alpha, rgb, grad):
    R, S = alpha.shape
    W = rgb.shape[-1]
    if tuple(rgb.shape) != (R, S, W) or W not in (3, 6) or tuple(grad.shape) != (R, S, 3):
        raise ValueError(f"composite: shapes {tuple(alpha.shape)}, {tuple(rgb.shape)}, "
                         f"{tuple(grad.shape)} are not (R, S), (R, S, 3|6), (R, S, 3)")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"composite kernel takes 1..{MAX_SAMPLES} samples per ray, got {S}")
    for t in (alpha, rgb, grad):
        if not t.is_cuda or t.device != alpha.device:
            raise ValueError("all inputs of the compositing kernel must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the compositing kernel takes contiguous float32 tensors")
    return R, S, W


def composite_fwd(alpha, rgb, grad):
    """Launch the forward kernel: (weights (R, S), color, extra, normals_w (R, 3))."""
    R, S, W = _check(alpha, rgb, grad)
    dev = alpha.device
    w = torch.empty(R, S, device=dev)
    color, extra, normals = (torch.empty(R, 3, device=dev) for _ in range(3))
    p = _build.ptr
    err = _lib().composite_fwd(R, S, W, p(alpha), p(rgb), p(grad), p(w), p(color), p(extra),
                               p(normals), _build.stream_ptr(dev))
    _build.check(err, "composite_fwd launch")
    _build.count(LAUNCHES, "composite_fwd")
    return w, color, extra, normals


def composite_bwd(alpha, rgb, grad, c_w, c_color, c_extra, c_normals):
    """Launch the backward kernel: (d_alpha (R, S), d_rgb (R, S, W), d_grad (R, S, 3))."""
    R, S, W = _check(alpha, rgb, grad)
    _build.check_f32(alpha.device, (("c_w", c_w, (R, S)), ("c_color", c_color, (R, 3)),
                              ("c_extra", c_extra, (R, 3)), ("c_normals", c_normals, (R, 3))))
    dev = alpha.device
    d_alpha = torch.empty(R, S, device=dev)
    d_rgb = torch.empty(R, S, W, device=dev)
    d_grad = torch.empty(R, S, 3, device=dev)
    p = _build.ptr
    err = _lib().composite_bwd(R, S, W, p(alpha), p(rgb), p(grad), p(c_w), p(c_color),
                               p(c_extra), p(c_normals), p(d_alpha), p(d_rgb), p(d_grad),
                               _build.stream_ptr(dev))
    _build.check(err, "composite_bwd launch")
    _build.count(LAUNCHES, "composite_bwd")
    return d_alpha, d_rgb, d_grad


class CompositeFunction(torch.autograd.Function):
    """(keep, alpha, rgb, grad) -> (weights, color, extra, normals_w); forward
    and backward are the CUDA kernels. The inputs are kept for the backward
    only when ``keep`` (the caller's grad mode: forward itself always runs
    under no_grad, and ``needs_input_grad`` ignores the mode)."""

    @staticmethod
    def forward(ctx, keep, alpha, rgb, grad):
        if keep and any(ctx.needs_input_grad):
            ctx.save_for_backward(alpha, rgb, grad)
        return composite_fwd(alpha, rgb, grad)

    @staticmethod
    def backward(ctx, c_w, c_color, c_extra, c_normals):
        alpha, rgb, grad = ctx.saved_tensors
        R, S = alpha.shape

        def cot(t, shape):
            return torch.zeros(shape, device=alpha.device) if t is None else t.float().contiguous()

        return (None, *composite_bwd(alpha, rgb, grad, cot(c_w, (R, S)), cot(c_color, (R, 3)),
                                     cot(c_extra, (R, 3)), cot(c_normals, (R, 3))))


def composite(alpha, rgb, grad):
    """alpha (R, S), rgb (R, S, 3|6), grad (R, S, 3) -> (weights (R, S),
    color (R, 3), extra (R, 3), normals_w (R, 3)). CPU tensors take the plain
    version; CUDA tensors take the kernel pair, or raise."""
    if not alpha.is_cuda:
        return composite_plain(alpha, rgb, grad)
    c = lambda t: t.float().contiguous()
    return CompositeFunction.apply(torch.is_grad_enabled(), c(alpha), c(rgb), c(grad))
