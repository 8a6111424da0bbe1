"""The NeuS megakernel pairs: CUDA forward/backward, plain versions, autograd.

Two pairs, twins of avatarclip_tpu/ops/fused_neus.py:

* per ray (B1): `point_eval_fused_ray` (the entry), `_fused_core_ray` (the
  custom VJP), Pallas `_fwd_kernel_ray` / `_bwd_kernel_ray`. Per ray of
  (R, S) samples it evaluates the SDF MLP with its analytic spatial
  gradient, the colour MLP, the cos-annealed alpha and the in-ray
  compositing, and returns only per-ray quantities
  ``(colorW (R, 3|6), normals_w (R, 3), weight_sum (R, 1), eik)``;
  the training steps use it.
* per point (B3): `point_eval_fused`, `_fused_core`, Pallas `_fwd_kernel` /
  `_bwd_kernel`. The same network pass without the compositing, returning
  every per-point quantity ``(sdf (P, 1), grad (P, 3), rgb (P, 3|6),
  alpha (P,), cdf (P,), inside (P,), eik)`` with P = R * S; the
  validation and extraction renders use it, followed by the compositing
  kernel (ops/fused_composite.py).

Both return the eikonal loss as its partial sums ``eik = [num, den]``
(the JAX entries' ``eik`` before their ratio), which a sharded render sums
over the ranks; :func:`eik_ratio` turns them into the loss, as render_core
does.

Operand mode: the nets' ``cfg.dtype`` picks it (fields.networks.operand_bf16,
carried as ``spec.bf16`` and ``Dims::bf16``), where the JAX package fixes
``fused_sdf._OPERAND_DTYPE`` globally:

* ``"bfloat16"``, every conf's default: both operands of every dot
  (forward, reverse, tangent, weight gradient) rounded to bf16, f32 sums;
  biases, activations, the head's sdf row, the alpha chain and the
  compositing in f32 (the JAX kernels' ``_dot`` / ``_dotT`` / ``_dotB``);
* ``"float32"`` (the tiny and small scales, the CPU tests): f32 throughout,
  the tight oracle.

On a CUDA tensor :func:`point_eval_ray` runs, through
:class:`NeuSRayFunction`, the tensor-core pair ``csrc/fused_neus_ray_tc.cu``
in the bf16 mode and ``csrc/fused_neus_ray.cu`` in the f32 mode;
:func:`point_eval` runs, through :class:`NeuSPointFunction`, the
tensor-core pair of ``csrc/fused_neus_ray_tc.cu`` in the bf16 mode (its
backward B1's backward body seeded by the per-point cotangents) and
``csrc/fused_neus_point.cu``'s pair in the f32 mode. The backward is the
second kernel; nothing falls back. On a CPU
tensor they run the plain versions at the kernels' rounding points, whose
backward is autograd through the plain graph (create_graph=True for the
spatial gradient).

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
from ..utils import trace
from ..fields.networks import (ColorNetwork, SDFNetwork, kernel_color_forward,
                               kernel_sdf_with_gradient, operand_bf16)

MAX_SAMPLES = 64  # one ray is one GEMM row block of the kernel


class Dims(ctypes.Structure):
    """Mirror of ``neus::Dims`` in csrc/neus_mlp.cuh (passed by value)."""

    _fields_ = [(n, ctypes.c_int) for n in
                ("S", "L", "E", "H", "NH", "SW", "F", "HC", "NHC", "CW", "W", "squeeze")]
    _fields_ += [("scale", ctypes.c_float), ("bf16", ctypes.c_int)]


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
    bf16: bool = False  # the operand mode (fields.networks.operand_bf16)

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
                    float(self.scale), int(self.bf16))


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
        scale=s.scale, bf16=operand_bf16(s),
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


def _fields_plain(sdf, color, pts, dirs):
    """(sdf, grad, rgb) of the kernels' network pass at their rounding points
    (the nets' operand mode) in pts' dtype."""
    s, feat, g = kernel_sdf_with_gradient(sdf, pts)
    return s, g, kernel_color_forward(color, pts, g, dirs, feat)


def eik_ratio(eik: torch.Tensor) -> torch.Tensor:
    """The eikonal loss from its partial sums [num, den] (JAX's
    ``eik[0, 0] / (eik[0, 1] + 1e-5)``)."""
    return eik[0] / (eik[1] + 1e-5)


def eikonal(relax, ge):
    """The eikonal loss as its partial sums [num, den] (2,): the squared
    gradient-norm errors ``ge`` summed over the points where ``relax`` is 1,
    and their count. A sharded render sums them over the ranks; the loss is
    their :func:`eik_ratio`."""
    num = (relax * ge).sum()
    return torch.stack([num, relax.sum().to(num.dtype)])


def point_eval_ray_plain(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d,
                         mid_z, dists, inv_s, cos_anneal):
    """Plain PyTorch version of the kernel pair (same maths, the kernels'
    rounding points at the nets' operand mode), computed in the inputs' dtype
    (f64 on an f32 copy of the nets, ops/hold.f32_reference, gives a
    reference)."""
    R, S = mid_z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    s, g, rgb = _fields_plain(sdf, color, pts, dirs)  # rgb (P, 3|6)
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
    return col_w, normals_w, weight_sum, eikonal(relax, ge)


def point_eval_plain(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d, mid_z, dists,
                     inv_s, cos_anneal):
    """Plain PyTorch version of the point-level kernel pair (same maths, the
    operand mode as :func:`point_eval_ray_plain`), in the inputs' dtype.
    Returns (sdf (P, 1), grad (P, 3), rgb (P, 3|6), alpha (P,), cdf (P,),
    inside (P,), eik [num, den])."""
    R, S = mid_z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
    s, g, rgb = _fields_plain(sdf, color, pts, dirs)
    tc = (dirs * g).sum(-1)
    alpha, cdf = _alpha(s[:, 0], tc, dists.reshape(-1), inv_s, cos_anneal)
    r2 = (pts * pts).sum(-1).detach()
    inside = (r2 < 1.0).to(mid_z.dtype)
    relax = (r2 < 1.44).to(mid_z.dtype)
    ge = (torch.sqrt((g * g).sum(-1) + 1e-12) - 1.0) ** 2
    return s, g, rgb, alpha, cdf, inside, eikonal(relax, ge)


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


def n_cta_for(device, R: int) -> int:
    """CTAs for R row blocks: two per SM, at most one per block."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(R, 2 * sms))


def split_flat(d_flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """The flat weight gradient cut back into the weights' shapes."""
    out, off = [], 0
    for shape in shapes:
        n = shape.numel()
        out.append(d_flat[off:off + n].reshape(shape))
        off += n
    return out


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
    n_cta = n_cta_for(dev, R)
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
    trace.count("neus_ray_fwd")
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
    n_cta = n_cta_for(dev, R)
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
    trace.count("neus_ray_bwd")
    return d_o, d_d, d_z, d_t, d_w[:n_w], d_w[n_w].reshape(())


# ---------------------------------------------------------------------------
# CUDA per-ray pair on the tensor cores (the bf16 operand mode)
# ---------------------------------------------------------------------------

MAX_NH = 8  # neus_mlp.cuh's MAXNH (= MAXNHC)
# packed matrix slots of csrc/neus_tc.cuh (Pack::off)
_FS, _FHEAD, _RS, _RHEAD = 0, MAX_NH + 1, MAX_NH + 2, 2 * MAX_NH + 3
_FC, _RC, _NMAT = 2 * MAX_NH + 4, 3 * MAX_NH + 5, 4 * MAX_NH + 6


class Pack(ctypes.Structure):
    """Mirror of ``neus::tc::Pack``: each packed matrix's offset in uint2
    fragments (4 bf16)."""

    _fields_ = [("off", ctypes.c_longlong * _NMAT)]


def pack_b(b: torch.Tensor) -> torch.Tensor:
    """A product's (K, N) right operand as mma.m16n8k16 B-fragments in bf16,
    zero-padded to (16 KT, 8 NT), k-step major: fragment (kt, nt) of lane
    4 g + t holds B[16 kt + 2t + {0, 1, 8, 9}][8 nt + g] (csrc/neus_tc.cuh)."""
    K, N = b.shape
    KT, NT = -(-K // 16), -(-N // 8)
    p = b.new_zeros(KT * 16, NT * 8)
    p[:K, :N] = b
    # k = 16 kt + 8 kh + 2 t + kk, n = 8 nt + g -> (kt, nt, g, t, kh, kk)
    p = p.reshape(KT, 2, 4, 2, NT, 8).permute(0, 4, 5, 2, 1, 3)
    return p.reshape(-1).to(torch.bfloat16)


def unpack_b(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of :func:`pack_b` (f32, unpadded)."""
    KT, NT = -(-K // 16), -(-N // 8)
    p = packed.float().reshape(KT, NT, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2)
    return p.reshape(KT * 16, NT * 8)[:K, :N]


def pack_tc(spec, weights) -> tuple[torch.Tensor, Pack]:
    """The tensor-core kernels' packed bf16 weights from a dense weight list
    as (W, b): :func:`dense_weights`' (SDF layers, then colour layers) for a
    :class:`NeuSRaySpec`, or fused_sdf.dense_weights' (the SDF layers alone,
    B6's flat buffer) for a ``FusedSDFSpec``. Each matrix in its forward
    form (W^T) and its reverse form (W); the head's feature rows scaled by
    1/sqrt(2), the skip concat's scale (the JAX kernels' pre-scaled ``wf_a``
    / ``wf_e``). The head's sdf row and every bias stay in the flat f32
    buffer; without a colour net its slots stay empty."""
    NH = spec.n_hidden
    mats = weights[0::2]
    sdf_w, col_w = mats[:NH + 2], mats[NH + 2:]
    feat = sdf_w[NH + 1][1:] / 2.0 ** 0.5
    slots = {_FHEAD: feat.t(), _RHEAD: feat}
    for i in range(NH + 1):
        slots[_FS + i], slots[_RS + i] = sdf_w[i].t(), sdf_w[i]
    return _pack(slots | _colour_slots(col_w))


def pack_sdf_only_tc(spec, weights) -> tuple[torch.Tensor, Pack]:
    """#12's packed bf16 weights, from fused_sdf.dense_weights' list: the
    SDF stack's matrices that the sdf-only kernel multiplies, the hidden
    layers and the skip-producing layer, in their forward form (W^T) alone.
    The head's sdf row and every bias stay in the flat f32 buffer; the
    head's feature rows, the reverse forms and the colour slots are not
    packed."""
    mats = weights[0::2]
    return _pack({_FS + i: mats[i].t() for i in range(spec.n_hidden + 1)})


def pack_colour_tc(weights) -> tuple[torch.Tensor, Pack]:
    """B7's packed bf16 weights: the colour layers alone, from a dense
    weight list as (W, b) whose first layer is one (HC, CW) matrix over the
    mode's input columns (fused_color.tc_weights), each matrix in its
    forward and reverse forms; the SDF slots stay empty."""
    return _pack(_colour_slots(weights[0::2]))


def _colour_slots(mats) -> dict:
    slots = {}
    for l, w in enumerate(mats):
        slots[_FC + l], slots[_RC + l] = w.t(), w
    return slots


def _pack(slots) -> tuple[torch.Tensor, Pack]:
    parts, pack, off = [], Pack(), 0
    for slot in sorted(slots):
        part = pack_b(slots[slot].detach().float())
        pack.off[slot] = off // 4
        parts.append(part)
        off += part.numel()
    return torch.cat(parts), pack


def flat_shapes(d: Dims) -> list[torch.Size]:
    """The (W, b) shapes of the flat weight layout (csrc/neus_mlp.cuh's
    weight_offsets): the SDF layers, then the colour layers when d has any."""
    shapes = []
    for l in range(d.NH + 2):
        n_out = d.H if l < d.NH else (d.SW if l == d.NH else 1 + d.F)
        shapes += [(n_out, d.E if l == 0 else d.H), (n_out,)]
    for l in range(d.NHC + 1) if d.NHC else ():
        n_out = d.HC if l < d.NHC else d.W
        shapes += [(n_out, d.CW if l == 0 else d.HC), (n_out,)]
    return [torch.Size(t) for t in shapes]


def pack_flat(spec, flat) -> tuple[torch.Tensor, Pack]:
    """:func:`pack_tc` of a flat f32 weight buffer."""
    return pack_tc(spec, split_flat(flat, flat_shapes(spec.dims())))


def check_packed(pk, device):
    if pk.dtype != torch.bfloat16 or pk.device != device or not pk.is_contiguous():
        raise ValueError("the packed weights must be a contiguous bf16 tensor on the card")


def _tc_lib():
    return type_tc(_build.load("fused_neus_ray_tc", "fused_neus_ray_tc.cu"))


def type_tc(lib):
    """Set the ctypes signatures of a build of fused_neus_ray_tc.cu."""
    if not getattr(lib, "_typed", False):
        P, I, F_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        for fn in (lib.neus_tc_smem_bytes, lib.neus_tc_scratch_bytes):
            fn.argtypes = [Dims, I]
            fn.restype = L_
        lib.neus_tc_weight_count.argtypes = [Dims]
        lib.neus_tc_weight_count.restype = L_
        lib.neus_ray_tc_fwd.argtypes = [Dims, Pack] + [P] * 7 + [F_, I] + [P] * 8 + [L_, I, P]
        lib.neus_ray_tc_fwd.restype = I
        lib.neus_ray_tc_bwd.argtypes = [Dims, Pack] + [P] * 7 + [F_, I] + [P] * 13 + [L_, I, P, I, I, P]
        lib.neus_ray_tc_bwd.restype = I
        lib.neus_point_tc_bwd.argtypes = [Dims, Pack] + [P] * 7 + [F_, I] + [P] * 15 + [L_, I, P, I, I, P]
        lib.neus_point_tc_bwd.restype = I
        lib.neus_point_tc_fwd.argtypes = [Dims, Pack] + [P] * 7 + [F_, I] + [P] * 9 + [L_, I, P]
        lib.neus_point_tc_fwd.restype = I
        lib.sdf_tc_bwd.argtypes = [Dims, Pack, P, P, P, I] + [P] * 7 + [L_, I, P, I, I, P]
        lib.sdf_tc_bwd.restype = I
        lib.sdf_tc_fwd.argtypes = [Dims, Pack, P, P, P, I, P, P, P, P, L_, I, P]
        lib.sdf_tc_fwd.restype = I
        lib.colour_tc_bwd.argtypes = [Dims, Pack] + [P] * 6 + [I] * 4 + [P] * 7 + [I, P, I, I, P]
        lib.colour_tc_bwd.restype = I
        lib.colour_tc_fwd.argtypes = [Dims, Pack] + [P] * 6 + [I] * 4 + [P, I, P]
        lib.colour_tc_fwd.restype = I
        lib.sdf_only_tc_fwd.argtypes = [Dims, Pack, P, P, P, I, P, P, L_, I, P]
        lib.sdf_only_tc_fwd.restype = I
        lib.neus_tc_log_row.argtypes = [Dims]
        lib.neus_tc_log_row.restype = L_
        lib.neus_tc_wgrad_tiles.argtypes = [Dims]
        lib.neus_tc_wgrad_tiles.restype = I
        lib._typed = True
    return lib


def n_cta_tc(device, R: int) -> int:
    """Persistent CTAs of the tensor-core pair: one per SM (its shared
    memory holds one), at most one per ray."""
    return max(1, min(R, torch.cuda.get_device_properties(device).multi_processor_count))


RAYS_PER_CTA_CHUNK = 8  # the backward's chunk: this many rays a CTA (its log: ~0.7 MB a ray at 256 wide)


def tc_bwd_plan(sms: int, tiles: int, R: int) -> tuple[int, int, int]:
    """(CTAs, tiles a chunk, point splits of the weight-gradient pass) of a
    tensor-core backward over R tiles of 64 rows (B1's and B3's rays, B6's
    and B7's blocks of points) on a card of ``sms`` SMs, whose
    weight-gradient pass has ``tiles`` output tiles: a persistent CTA an SM
    (at most one a tile), RAYS_PER_CTA_CHUNK tiles a CTA a chunk, and the
    pass's CTAs (tiles x splits) about two waves."""
    n_cta = max(1, min(R, sms))
    chunk = min(R, n_cta * RAYS_PER_CTA_CHUNK)
    return n_cta, chunk, max(1, min(chunk, 2 * sms // tiles))


def tc_bwd_chunking(device, lib, d, R: int) -> tuple[int, int, int]:
    """:func:`tc_bwd_plan` on ``device`` for the network dims ``d``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return tc_bwd_plan(sms, int(lib.neus_tc_wgrad_tiles(d)), R)


def tc_bwd_buffers(lib, d: Dims, device, R: int) -> dict:
    """The chunked tensor-core backward's launch plan and buffers over R rays
    (B1's and B3's): CTAs, rays a chunk, point splits (tc_bwd_chunking), the
    per-CTA scratch and its stride, the zeroed partial rows and the chunk's
    bf16 weight-gradient log."""
    n_w = int(lib.neus_tc_weight_count(d))
    n_cta, chunk, n_split = tc_bwd_chunking(device, lib, d, R)
    stride = int(lib.neus_tc_scratch_bytes(d, 1))
    return {"n_w": n_w, "n_cta": n_cta, "chunk": chunk, "n_split": n_split, "stride": stride,
            "scr": torch.empty(n_cta * stride, dtype=torch.uint8, device=device),
            "gpart": torch.zeros((n_cta + 2 * n_split) * (n_w + 1), device=device),
            "log": torch.empty(chunk * MAX_SAMPLES * int(lib.neus_tc_log_row(d)),
                               dtype=torch.bfloat16, device=device)}


def neus_ray_tc_fwd(spec: NeuSRaySpec, flat, pk, pack, rays_o, rays_d, mid_z, dists, inv_s,
                    cos_anneal):
    """Launch the tensor-core forward kernel (bf16 operand mode). Returns
    what :func:`neus_ray_fwd` returns."""
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    lib = _tc_lib()
    d = spec.dims()
    if flat.numel() != lib.neus_tc_weight_count(d):
        raise ValueError("flat weight buffer does not match the network dims")
    check_packed(pk, mid_z.device)
    R, S = mid_z.shape
    dev = mid_z.device
    n_cta = n_cta_tc(dev, R)
    stride = int(lib.neus_tc_scratch_bytes(d, 0))
    scr = torch.empty(n_cta * stride, dtype=torch.uint8, device=dev)
    eik_part = torch.empty(n_cta * 2, device=dev)
    col_w = torch.empty(R, spec.rgb_width, device=dev)
    normals_w = torch.empty(R, 3, device=dev)
    wsum = torch.empty(R, 1, device=dev)
    sdf_res = torch.empty(R * S, device=dev)
    g_res = torch.empty(R * S, 3, device=dev)
    eik = torch.empty(2, device=dev)
    p = _build.ptr
    err = lib.neus_ray_tc_fwd(
        d, pack, p(flat), p(pk), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s),
        float(cos_anneal), R, p(col_w), p(normals_w), p(wsum), p(sdf_res), p(g_res), p(eik),
        p(eik_part), p(scr), stride, n_cta, _build.stream_ptr(dev),
    )
    _build.check(err, "neus_ray_tc_fwd launch")
    trace.count("neus_ray_fwd")
    return col_w, normals_w, wsum, sdf_res, g_res, eik


def neus_ray_tc_bwd(spec: NeuSRaySpec, flat, pk, pack, rays_o, rays_d, mid_z, dists, inv_s,
                    cos_anneal, sdf_res, g_res, c_col, c_nw, c_ws, c_eik):
    """Launch the tensor-core backward kernel (+ its partial-sum pass).
    Returns what :func:`neus_ray_bwd` returns."""
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    lib = _tc_lib()
    d = spec.dims()
    R, S = mid_z.shape
    W = spec.rgb_width
    _build.check_f32(mid_z.device, (("c_col", c_col, (R, W)), ("c_nw", c_nw, (R, 3)),
                                    ("c_ws", c_ws, (R, 1)), ("c_eik", c_eik, (2,)),
                                    ("sdf_res", sdf_res, (R * S,)), ("g_res", g_res, (R * S, 3))))
    check_packed(pk, mid_z.device)
    dev = mid_z.device
    b = tc_bwd_buffers(lib, d, dev, R)
    n_w = b["n_w"]
    d_o = torch.empty(R, 3, device=dev)
    d_d = torch.empty(R, 3, device=dev)
    d_z = torch.empty(R, S, device=dev)
    d_t = torch.empty(R, S, device=dev)
    d_w = torch.empty(n_w + 1, device=dev)
    p = _build.ptr
    err = lib.neus_ray_tc_bwd(
        d, pack, p(flat), p(pk), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s),
        float(cos_anneal), R, p(sdf_res), p(g_res), p(c_col), p(c_nw), p(c_ws), p(c_eik),
        p(d_o), p(d_d), p(d_z), p(d_t), p(d_w), p(b["gpart"]), p(b["scr"]), b["stride"],
        b["n_cta"], p(b["log"]), b["chunk"], b["n_split"], _build.stream_ptr(dev),
    )
    _build.check(err, "neus_ray_tc_bwd launch")
    trace.count("neus_ray_bwd")
    return d_o, d_d, d_z, d_t, d_w[:n_w], d_w[n_w].reshape(())


class NeuSRayFunction(torch.autograd.Function):
    """(rays, mid_z, dists, inv_s, *dense weights) -> (colorW, normals_w,
    weight_sum, eik (2,)); forward and backward are the CUDA kernels: the
    tensor-core pair in the bf16 operand mode, fused_neus_ray.cu's in f32."""

    @staticmethod
    def forward(ctx, spec, cos_anneal, rays_o, rays_d, mid_z, dists, inv_s, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        args = (rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)
        if spec.bf16:
            pk, pack = pack_tc(spec, weights)
            outs = neus_ray_tc_fwd(spec, flat, pk, pack, *args)
            ctx.pack = pack
        else:
            pk = flat.new_empty(0)
            outs = neus_ray_fwd(spec, flat, *args)
        col_w, normals_w, wsum, sdf_res, g_res, eik = outs
        ctx.save_for_backward(flat, pk, rays_o, rays_d, mid_z, dists, inv_s, sdf_res, g_res)
        ctx.spec, ctx.cos_anneal = spec, cos_anneal
        ctx.shapes = [w.shape for w in weights]
        return col_w, normals_w, wsum, eik

    @staticmethod
    def backward(ctx, c_col, c_nw, c_ws, c_eik):
        with trace.span("backward.neus_core"):
            flat, pk, rays_o, rays_d, mid_z, dists, inv_s, sdf_res, g_res = ctx.saved_tensors
            R = mid_z.shape[0]
            dev = mid_z.device

            def cot(t, shape):
                return torch.zeros(shape, device=dev) if t is None else t.float().contiguous()

            args = (rays_o, rays_d, mid_z, dists, inv_s, ctx.cos_anneal, sdf_res, g_res,
                    cot(c_col, (R, ctx.spec.rgb_width)), cot(c_nw, (R, 3)), cot(c_ws, (R, 1)),
                    cot(c_eik, (2,)))
            if ctx.spec.bf16:
                outs = neus_ray_tc_bwd(ctx.spec, flat, pk, ctx.pack, *args)
            else:
                outs = neus_ray_bwd(ctx.spec, flat, *args)
            d_o, d_d, d_z, d_t, d_flat, d_inv_s = outs
            return (None, None, d_o, d_d, d_z, d_t, d_inv_s, *split_flat(d_flat, ctx.shapes))


def point_eval_ray(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d, mid_z, dists,
                   inv_s, cos_anneal):
    """Per-ray NeuS evaluation: (colorW (R, 3|6), normals_w (R, 3),
    weight_sum (R, 1), eik [num, den], the eikonal loss's partial sums,
    :func:`eik_ratio`). CPU tensors take the plain version; CUDA tensors
    take the kernel pair, or raise."""
    if not mid_z.is_cuda:
        return point_eval_ray_plain(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)
    R, S = mid_z.shape
    spec = spec_from_configs(sdf.cfg, color.cfg, S)
    if spec is None:
        raise ValueError("network configuration not supported by the NeuS kernel")
    c = lambda t: t.float().contiguous()
    return NeuSRayFunction.apply(
        spec, float(cos_anneal), c(rays_o), c(rays_d), c(mid_z), c(dists), c(inv_s.reshape(())),
        *dense_weights(sdf, color),
    )


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


def neus_point_fwd(spec: NeuSRaySpec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal,
                   packed=None):
    """Launch the point-level forward kernel: in the bf16 mode the
    tensor-core one (fused_neus_ray_tc.cu; ``packed`` = :func:`pack_tc`'s
    (pk, pack), packed from ``flat`` when None), in f32 fused_neus_point.cu's.
    Returns (sdf (P,), alpha (P,), cdf (P,), grad (P, 3), inside (P,),
    rgb (P, W), eik (2,) = [num, den])."""
    lib = _tc_lib() if spec.bf16 else _point_lib()
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    d = spec.dims()
    count = lib.neus_tc_weight_count(d) if spec.bf16 else lib.neus_point_weight_count(d)
    if flat.numel() != count:
        raise ValueError("flat weight buffer does not match the network dims")
    R, S = mid_z.shape
    dev = mid_z.device
    sdf_o, alpha, cdf, inside = (torch.empty(R * S, device=dev) for _ in range(4))
    grad = torch.empty(R * S, 3, device=dev)
    rgb = torch.empty(R * S, spec.rgb_width, device=dev)
    eik = torch.empty(2, device=dev)
    p = _build.ptr
    if spec.bf16:
        pk, pack = pack_flat(spec, flat) if packed is None else packed
        check_packed(pk, dev)
        n_cta = n_cta_tc(dev, R)
        stride = int(lib.neus_tc_scratch_bytes(d, 0))
        scr = torch.empty(n_cta * stride, dtype=torch.uint8, device=dev)
        eik_part = torch.empty(n_cta * 2, device=dev)
        err = lib.neus_point_tc_fwd(
            d, pack, p(flat), p(pk), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s),
            float(cos_anneal), R, p(sdf_o), p(alpha), p(cdf), p(grad), p(inside), p(rgb), p(eik),
            p(eik_part), p(scr), stride, n_cta, _build.stream_ptr(dev),
        )
    else:
        n_cta = n_cta_for(dev, R)
        stride = int(lib.neus_point_workspace_floats(d, 0))
        ws = torch.empty(n_cta * stride, device=dev)
        eik_part = torch.empty(n_cta * 2, device=dev)
        err = lib.neus_point_fwd(
            d, p(flat), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s), float(cos_anneal), R,
            p(sdf_o), p(alpha), p(cdf), p(grad), p(inside), p(rgb), p(eik), p(eik_part), p(ws),
            stride, n_cta, _build.stream_ptr(dev),
        )
    _build.check(err, "neus_point_fwd launch")
    trace.count("neus_point_fwd")
    return sdf_o, alpha, cdf, grad, inside, rgb, eik


def neus_point_bwd(spec: NeuSRaySpec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal,
                   sdf_res, g_res, c_sdf, c_alpha, c_cdf, c_grad, c_rgb, c_eik, packed=None):
    """Launch the point-level backward: in the bf16 mode the tensor-core
    kernel of fused_neus_ray_tc.cu (rays in chunks, its weight gradients a
    GEMM over the chunk's log; ``packed`` as :func:`neus_point_fwd`'s), in
    f32 fused_neus_point.cu's CUDA-core kernel; each with its partial-sum
    pass. Returns (d_o, d_d, d_z, d_t, d_flat, d_inv_s)."""
    lib = _tc_lib() if spec.bf16 else _point_lib()
    _check_inputs(spec, flat, rays_o, rays_d, mid_z, dists, inv_s)
    d = spec.dims()
    R, S = mid_z.shape
    P = R * S
    _build.check_f32(mid_z.device, (("sdf_res", sdf_res, (P,)), ("g_res", g_res, (P, 3)),
                              ("c_sdf", c_sdf, (P,)), ("c_alpha", c_alpha, (P,)),
                              ("c_cdf", c_cdf, (P,)), ("c_grad", c_grad, (P, 3)),
                              ("c_rgb", c_rgb, (P, spec.rgb_width)), ("c_eik", c_eik, (2,))))
    dev = mid_z.device
    d_o = torch.empty(R, 3, device=dev)
    d_d = torch.empty(R, 3, device=dev)
    d_z = torch.empty(R, S, device=dev)
    d_t = torch.empty(R, S, device=dev)
    p = _build.ptr
    head = (p(flat), p(rays_o), p(rays_d), p(mid_z), p(dists), p(inv_s), float(cos_anneal), R,
            p(sdf_res), p(g_res), p(c_sdf), p(c_alpha), p(c_cdf), p(c_grad), p(c_rgb), p(c_eik),
            p(d_o), p(d_d), p(d_z), p(d_t))
    if spec.bf16:
        pk, pack = pack_flat(spec, flat) if packed is None else packed
        check_packed(pk, dev)
        b = tc_bwd_buffers(lib, d, dev, R)
        n_w = b["n_w"]
        d_w = torch.empty(n_w + 1, device=dev)
        err = lib.neus_point_tc_bwd(
            d, pack, head[0], p(pk), *head[1:], p(d_w), p(b["gpart"]), p(b["scr"]), b["stride"],
            b["n_cta"], p(b["log"]), b["chunk"], b["n_split"], _build.stream_ptr(dev),
        )
    else:
        n_w = int(lib.neus_point_weight_count(d))
        n_cta = n_cta_for(dev, R)
        stride = int(lib.neus_point_workspace_floats(d, 1))
        ws = torch.empty(n_cta * stride, device=dev)
        gpart = torch.empty(n_cta * (n_w + 1), device=dev)
        d_w = torch.empty(n_w + 1, device=dev)
        err = lib.neus_point_bwd(d, *head, p(d_w), p(gpart), p(ws), stride, n_cta,
                                 _build.stream_ptr(dev))
    _build.check(err, "neus_point_bwd launch")
    trace.count("neus_point_bwd")
    return d_o, d_d, d_z, d_t, d_w[:n_w], d_w[n_w].reshape(())


class NeuSPointFunction(torch.autograd.Function):
    """(spec, cos_anneal, keep, rays, mid_z, dists, inv_s, *dense weights) ->
    (sdf (P, 1), grad, rgb, alpha, cdf, inside, eik (2,)); forward and
    backward are the CUDA kernels: the tensor-core pair in the bf16 operand
    mode (the weights packed once for both), fused_neus_point.cu's in f32.
    ``inside`` is not differentiable. Residuals are kept only when ``keep``
    (the caller's grad mode), so the validation renders under no_grad hold
    none."""

    @staticmethod
    def forward(ctx, spec, cos_anneal, keep, rays_o, rays_d, mid_z, dists, inv_s, *weights):
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        packed = pack_tc(spec, weights) if spec.bf16 else None
        sdf_o, alpha, cdf, grad, inside, rgb, eik = neus_point_fwd(
            spec, flat, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal, packed
        )
        ctx.mark_non_differentiable(inside)
        if keep and any(ctx.needs_input_grad):
            pk = flat.new_empty(0) if packed is None else packed[0]
            ctx.save_for_backward(flat, pk, rays_o, rays_d, mid_z, dists, inv_s, sdf_o, grad)
            ctx.spec, ctx.cos_anneal = spec, cos_anneal
            ctx.pack = None if packed is None else packed[1]
            ctx.shapes = [w.shape for w in weights]
        return sdf_o.reshape(-1, 1), grad, rgb, alpha, cdf, inside, eik

    @staticmethod
    def backward(ctx, c_sdf, c_grad, c_rgb, c_alpha, c_cdf, c_inside, c_eik):
        flat, pk, rays_o, rays_d, mid_z, dists, inv_s, sdf_o, grad = ctx.saved_tensors
        P = mid_z.numel()
        dev = mid_z.device

        def cot(t, shape):
            return torch.zeros(shape, device=dev) if t is None else t.float().reshape(shape).contiguous()

        d_o, d_d, d_z, d_t, d_flat, d_inv_s = neus_point_bwd(
            ctx.spec, flat, rays_o, rays_d, mid_z, dists, inv_s, ctx.cos_anneal, sdf_o, grad,
            cot(c_sdf, (P,)), cot(c_alpha, (P,)), cot(c_cdf, (P,)), cot(c_grad, (P, 3)),
            cot(c_rgb, (P, ctx.spec.rgb_width)), cot(c_eik, (2,)),
            None if ctx.pack is None else (pk, ctx.pack),
        )
        return (None, None, None, d_o, d_d, d_z, d_t, d_inv_s, *split_flat(d_flat, ctx.shapes))


def point_eval(sdf: SDFNetwork, color: ColorNetwork, rays_o, rays_d, mid_z, dists, inv_s,
               cos_anneal):
    """Per-point NeuS evaluation: (sdf (P, 1), grad (P, 3), rgb (P, 3|6),
    alpha (P,), cdf (P,), inside (P,), eik [num, den], the eikonal loss's
    partial sums, :func:`eik_ratio`). CPU tensors take the plain version;
    CUDA tensors take the kernel pair, or raise."""
    if not mid_z.is_cuda:
        return point_eval_plain(sdf, color, rays_o, rays_d, mid_z, dists, inv_s, cos_anneal)
    R, S = mid_z.shape
    spec = spec_from_configs(sdf.cfg, color.cfg, S)
    if spec is None:
        raise ValueError("network configuration not supported by the NeuS kernel")
    c = lambda t: t.float().contiguous()
    return NeuSPointFunction.apply(
        spec, float(cos_anneal), torch.is_grad_enabled(), c(rays_o), c(rays_d), c(mid_z), c(dists), c(inv_s.reshape(())),
        *dense_weights(sdf, color),
    )
