"""SoftRas aggregation over (pixel, face) pairs: CUDA kernel pair, plain version, culling table.

Twin of avatarclip_tpu/ops/fused_soft.py: `soft_aggregate` (the entry: face
padding, the stable tile sort, scale folding, ``ezf``, ``vmask``),
`_overlap_table_halfplane` (the culling table) and the `_build` custom VJP
around the Pallas kernels `_fwd_kernel` / `_bwd_kernel`. Per view and pixel
p, over the faces f of the view:

    v_e = (px * cs_e[0] + py * cs_e[1]) + cs_e[2]     (e = 0, 1, 2)
    d = min_e v_e,  x = d / sigma
    sil_log = sum_f -softplus(x) * vmask
    w = sigmoid(x) * vmask * ezf,  num = sum_f w * colf,  den = sum_f w

with ``cs_e`` the barycentric edge coefficients scaled to pixel distances and
``ezf = exp(clip(iz_face / gamma, -60, 60))``. The caller forms
silhouette = 1 - exp(sil_log) and rgb = (num + bg) / (den + 1 + eps).

The per-face operands travel packed as (B, Fp, 16) float32 rows
[cs0 (3), cs1 (3), cs2 (3), ezf, colf (3), vmask, 0, 0] (:func:`pack_faces`),
so one 64-byte row is all a kernel reads per face and the backward returns
its gradient in the same layout (the vmask and padding columns get 0). The
packing, the exp of ``sil_log`` and every O(F) transform around it are
plain autograd outside :class:`SoftAggregateFunction`.

On a CUDA tensor :func:`aggregate` runs ``csrc/fused_soft.cu`` (forward and
backward kernels, each followed by a small kernel that sums its K partials
in a fixed order; no fallback). The kernels evaluate a face only on the
8 x 8 pixel patches that :func:`patch_keep` keeps, its Python twin. On a
CPU tensor it runs
:func:`aggregate_plain`, which evaluates every pair in face chunks under
``torch.utils.checkpoint`` so that its backward keeps O(B x P x chunk)
memory, as the JAX CPU path's checkpointed scan does. The Pallas pixel tile
permutation is a BlockSpec layout and has no counterpart: the kernels
compute pixel coordinates from their block index and write row-major.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import _build

TILE_H = 32
TILE_W = 32
FBLOCK = 512  # faces per block of the culling table
NF = 16  # floats per packed face row
# the kernels' work split (csrc/fused_soft.cu): a warp's 8 x 8 pixel patch;
# forward CTAs of 32 x 16 pixels over interleaved ranges of 256-face
# stages, backward CTAs of 128 faces over interleaved ranges of the tiles
PATCH = 8
FWD_CELL_W, FWD_CELL_H = 32, 16
STAGE = 256
GROUP = 128
CTAS_PER_SM = 64  # the splits aim at this many CTAs an SM, at 2 views as at 5
# Cull only (tile, face-block) pairs whose sigmoid is exactly zero in f32:
# beyond d < -104 sigma the sigmoid underflows. A margin that is merely
# "negligible" is not sound: the depth weights saturate at e^60 beside the
# background's weight of 1 (avatarclip_tpu/ops/fused_soft.py:64-73).
_MARGIN_LOGITS = 104.0
PLAIN_CHUNK = 256  # faces per checkpointed chunk of the plain version

# kernel launches, counted by the wrappers (reset by callers that measure);
# each pass is followed by the kernel that sums its partials
LAUNCHES = {"soft_fwd": 0, "soft_bwd": 0, "soft_fwd_reduce": 0, "soft_bwd_reduce": 0}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def grid_dims(H: int, W: int) -> tuple[int, int]:
    """(n_ty, n_tx) screen tiles of an H x W image."""
    return _round_up(H, TILE_H) // TILE_H, _round_up(W, TILE_W) // TILE_W


def overlap_table_halfplane(valid: torch.Tensor, cs: torch.Tensor, H: int, W: int,
                            margin: float) -> torch.Tensor:
    """Culling table (B, n_tiles, n_fb) int32: > 0 iff some valid face of
    block j can reach screen tile i, by the exact half-plane test on the
    scaled edge distances. Each v_e is affine in the pixel, so its maximum
    over a tile rectangle is a x_c + b y_c + c + |a| hw + |b| hh; a tile can
    meet the face's influence region {min_e v_e >= -margin} only if every
    edge's maximum is >= -margin (a necessary condition, so the table is
    sound), with 1 px of float slack. ``valid`` (B, Fp) bool, ``cs``
    (B, Fp, 3 edges, 3 coefficients), Fp a multiple of FBLOCK."""
    B, Fp = valid.shape
    n_ty, n_tx = grid_dims(H, W)
    n_tiles, n_fb = n_ty * n_tx, Fp // FBLOCK
    t = torch.arange(n_tiles, device=cs.device, dtype=torch.float32)
    ty = torch.div(t, n_tx, rounding_mode="floor")
    tx = torch.remainder(t, n_tx)
    xc = (tx * TILE_W + (TILE_W - 1) / 2.0)[None, :, None]
    yc = (ty * TILE_H + (TILE_H - 1) / 2.0)[None, :, None]
    hw, hh = (TILE_W - 1) / 2.0, (TILE_H - 1) / 2.0
    thresh = -(margin + 1.0)
    keep = valid[:, None, :]
    for e in range(3):
        a, b, c = cs[..., e, 0], cs[..., e, 1], cs[..., e, 2]
        mx = xc * a[:, None, :] + yc * b[:, None, :] + (c + a.abs() * hw + b.abs() * hh)[:, None, :]
        keep = keep & (mx >= thresh)
    return keep.reshape(B, n_tiles, n_fb, FBLOCK).any(-1).to(torch.int32)


def cull_threshold(inv_sigma: float) -> float:
    """The patch test's bound on an edge's maximum, -(104 sigma + 1 px) as
    the table's, rounded to float32 as the kernels take it."""
    return ctypes.c_float(-(_MARGIN_LOGITS / inv_sigma + 1.0)).value


def patch_keep(faces: torch.Tensor, tab: torch.Tensor, H: int, W: int,
               inv_sigma: float) -> torch.Tensor:
    """The (8 x 8 pixel patch, face) pairs the kernels evaluate: (B, n_py,
    n_px, Fp) bool, patch (i, j) holding pixels [8j, 8j + 8) x [8i, 8i + 8).
    A valid face is kept on a patch when the table keeps its block on the
    patch's tile and every edge's maximum over the patch, in float32 and in
    the kernels' order, is at least :func:`cull_threshold`. The table's test
    on a finer rectangle, so it keeps every pair with x > -104: below that
    the sigmoid underflows and each term of the pair is exactly 0."""
    B, Fp, _ = faces.shape
    n_py, n_px = -(-H // PATCH), -(-W // PATCH)
    dev = faces.device
    h = (PATCH - 1) / 2.0
    xc = (torch.arange(n_px, device=dev, dtype=torch.float32) * PATCH + h)[None, None, :, None]
    yc = (torch.arange(n_py, device=dev, dtype=torch.float32) * PATCH + h)[None, :, None, None]
    thresh = cull_threshold(inv_sigma)
    f = faces.float()
    keep = (f[..., 13] != 0)[:, None, None, :]
    for e in range(3):
        a, b, c = (f[:, None, None, :, 3 * e + i] for i in range(3))
        keep = keep & (xc * a + yc * b + (c + a.abs() * h + b.abs() * h) >= thresh)
    n_tx = grid_dims(H, W)[1]
    per = TILE_H // PATCH
    tile = ((torch.arange(n_py, device=dev) // per)[:, None] * n_tx
            + (torch.arange(n_px, device=dev) // per)[None, :])
    blocks = tab[:, tile] != 0  # (B, n_py, n_px, n_fb)
    return keep & blocks.repeat_interleave(FBLOCK, -1)


def pack_faces(cs: torch.Tensor, ezf: torch.Tensor, colf: torch.Tensor,
               vmask: torch.Tensor) -> torch.Tensor:
    """(B, Fp, 3, 3), (B, Fp), (B, Fp, 3), (B, Fp) -> (B, Fp, NF) rows."""
    B, Fp = ezf.shape
    return torch.cat([cs.reshape(B, Fp, 9), ezf[..., None], colf, vmask[..., None],
                      ezf.new_zeros(B, Fp, 2)], -1)


def _pixel_coords(H: int, W: int, device, dtype):
    py, px = torch.meshgrid(torch.arange(H, device=device, dtype=dtype),
                            torch.arange(W, device=device, dtype=dtype), indexing="ij")
    return px.reshape(1, -1, 1), py.reshape(1, -1, 1)


def _plain_chunk(fc, px, py, inv_sigma):
    """One face chunk (B, C, NF) against every pixel -> (sil_log (B, P),
    num (B, P, 3), den (B, P)); the edge distances in the kernel's order."""
    v = [(px * fc[:, None, :, 3 * e] + py * fc[:, None, :, 3 * e + 1]) + fc[:, None, :, 3 * e + 2]
         for e in range(3)]
    # amin's gradient splits ties equally, as the kernel and XLA's reduce-min do
    d = torch.stack(v, -1).amin(-1)  # (B, P, C)
    x = d * inv_sigma
    vmask = fc[:, None, :, 13]
    w = torch.sigmoid(x) * vmask * fc[:, None, :, 9]
    sil = (-F.softplus(x) * vmask).sum(-1)
    return sil, torch.bmm(w, fc[..., 10:13]), w.sum(-1)


def aggregate_plain(faces: torch.Tensor, H: int, W: int, inv_sigma: float):
    """The plain version of the kernel pair: every (pixel, face) pair, faces
    in chunks, each chunk checkpointed when autograd records. ``faces``
    (B, Fp, NF) -> (sil_log (B, H*W), num (B, H*W, 3), den (B, H*W)) in the
    input's dtype."""
    B, Fp, _ = faces.shape
    px, py = _pixel_coords(H, W, faces.device, faces.dtype)
    sil = faces.new_zeros(B, H * W)
    num = faces.new_zeros(B, H * W, 3)
    den = faces.new_zeros(B, H * W)
    record = torch.is_grad_enabled() and faces.requires_grad
    # faces past the last valid one (the padding, sorted last) add exact
    # zeros; one chunk at least keeps the outputs on the autograd graph
    live = (faces[..., 13] != 0).any(0).nonzero()
    n_live = int(live.max()) + 1 if live.numel() else 1
    for f0 in range(0, n_live, PLAIN_CHUNK):
        fc = faces[:, f0:f0 + PLAIN_CHUNK]
        if record:
            s, n, d = checkpoint(_plain_chunk, fc, px, py, inv_sigma, use_reentrant=False)
        else:
            s, n, d = _plain_chunk(fc, px, py, inv_sigma)
        sil, num, den = sil + s, num + n, den + d
    return sil, num, den


def _lib():
    lib = _build.load("fused_soft", "fused_soft.cu")
    if not getattr(lib, "_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.soft_fwd.argtypes = [P] * 3 + [I] * 5 + [Fl, Fl, P]
        lib.soft_fwd_reduce.argtypes = [P] * 4 + [I] * 3 + [P]
        lib.soft_bwd.argtypes = [P] * 6 + [I] * 5 + [Fl, Fl, P]
        lib.soft_bwd_reduce.argtypes = [P] * 2 + [I] * 2 + [P]
        for fn in (lib.soft_fwd, lib.soft_fwd_reduce, lib.soft_bwd, lib.soft_bwd_reduce):
            fn.restype = I
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _n_sm(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fwd_splits(B: int, H: int, W: int, Fp: int, n_sm: int) -> int:
    """K, the forward's interleaved ranges of face stages: ~CTAS_PER_SM
    CTAs an SM over the B views' 32 x 16 cells."""
    cells = B * -(-H // FWD_CELL_H) * -(-W // FWD_CELL_W)
    return max(1, min(Fp // STAGE, -(-CTAS_PER_SM * n_sm // cells)))


def bwd_splits(B: int, H: int, W: int, Fp: int, n_sm: int) -> int:
    """K, the backward's interleaved ranges of screen tiles: ~CTAS_PER_SM
    CTAs an SM over the B views' 128-face groups."""
    n_ty, n_tx = grid_dims(H, W)
    return max(1, min(n_ty * n_tx, -(-CTAS_PER_SM * n_sm // (B * Fp // GROUP))))


def _check(faces, tab, H, W):
    if faces.dim() != 3 or faces.shape[-1] != NF or faces.shape[1] % FBLOCK:
        raise ValueError(f"faces must be (B, Fp, {NF}) with Fp a multiple of {FBLOCK}, "
                         f"got {tuple(faces.shape)}")
    B, Fp, _ = faces.shape
    n_ty, n_tx = grid_dims(H, W)
    if not faces.is_cuda or faces.dtype != torch.float32 or not faces.is_contiguous():
        raise ValueError("the soft aggregation kernels take a contiguous float32 CUDA tensor")
    if (tuple(tab.shape) != (B, n_ty * n_tx, Fp // FBLOCK) or tab.dtype != torch.int32
            or tab.device != faces.device or not tab.is_contiguous()):
        raise ValueError("tab must be the contiguous int32 (B, n_tiles, n_fb) table on the faces' device")
    return B, Fp


def soft_fwd(faces, tab, H: int, W: int, inv_sigma: float):
    """Launch the forward kernel and the sum of its partials: (sil_log (B,
    H*W), num (B, H*W, 3), den (B, H*W))."""
    B, Fp = _check(faces, tab, H, W)
    dev = faces.device
    P = H * W
    K = fwd_splits(B, H, W, Fp, _n_sm(dev))
    part = torch.empty(K, B, 5, P, device=dev)
    sil = torch.empty(B, P, device=dev)
    num = torch.empty(B, P, 3, device=dev)
    den = torch.empty(B, P, device=dev)
    p, lib, st = _build.ptr, _lib(), _build.stream_ptr(dev)
    err = lib.soft_fwd(p(faces), p(tab), p(part), B, H, W, Fp // FBLOCK, K, inv_sigma,
                       cull_threshold(inv_sigma), st)
    _build.check(err, "soft_fwd launch")
    _build.count(LAUNCHES, "soft_fwd")
    err = lib.soft_fwd_reduce(p(part), p(sil), p(num), p(den), B, P, K, st)
    _build.check(err, "soft_fwd_reduce launch")
    _build.count(LAUNCHES, "soft_fwd_reduce")
    return sil, num, den


def soft_bwd(faces, tab, dsil, dnum, dden, H: int, W: int, inv_sigma: float):
    """Launch the backward kernel and the sum of its partials: d faces (B,
    Fp, NF), 0 in the vmask and padding columns."""
    B, Fp = _check(faces, tab, H, W)
    dev = faces.device
    P = H * W
    _build.check_f32(dev, (("dsil", dsil, (B, P)), ("dnum", dnum, (B, P, 3)), ("dden", dden, (B, P))))
    K = bwd_splits(B, H, W, Fp, _n_sm(dev))
    part = torch.empty(K, B, Fp, 13, device=dev)
    dfaces = torch.empty_like(faces)
    p, lib, st = _build.ptr, _lib(), _build.stream_ptr(dev)
    err = lib.soft_bwd(p(faces), p(tab), p(dsil), p(dnum), p(dden), p(part), B, H, W,
                       Fp // FBLOCK, K, inv_sigma, cull_threshold(inv_sigma), st)
    _build.check(err, "soft_bwd launch")
    _build.count(LAUNCHES, "soft_bwd")
    err = lib.soft_bwd_reduce(p(part), p(dfaces), B * Fp, K, st)
    _build.check(err, "soft_bwd_reduce launch")
    _build.count(LAUNCHES, "soft_bwd_reduce")
    return dfaces


class SoftAggregateFunction(torch.autograd.Function):
    """(keep, faces, tab, H, W, inv_sigma) -> (sil_log, num, den); forward and
    backward are the CUDA kernels, the backward recomputes every pair term
    (no residual beyond the inputs). The inputs are kept only when ``keep``
    (the caller's grad mode)."""

    @staticmethod
    def forward(ctx, keep, faces, tab, H, W, inv_sigma):
        if keep and ctx.needs_input_grad[1]:
            ctx.save_for_backward(faces, tab)
        ctx.dims = (H, W, inv_sigma)
        return soft_fwd(faces, tab, H, W, inv_sigma)

    @staticmethod
    def backward(ctx, dsil, dnum, dden):
        faces, tab = ctx.saved_tensors
        H, W, inv_sigma = ctx.dims
        c = lambda t: t.float().contiguous()
        return (None, soft_bwd(faces, tab, c(dsil), c(dnum), c(dden), H, W, inv_sigma),
                None, None, None, None)


def aggregate(faces: torch.Tensor, tab: torch.Tensor, H: int, W: int, inv_sigma: float):
    """The aggregation of packed faces (B, Fp, NF): CPU tensors take the plain
    version (the table only skips exact zeros, so it needs none); CUDA
    tensors take the kernel pair, or raise."""
    if not faces.is_cuda:
        return aggregate_plain(faces, H, W, inv_sigma)
    return SoftAggregateFunction.apply(torch.is_grad_enabled(), faces.float().contiguous(),
                                       tab.contiguous(), H, W, float(inv_sigma))


def prepare(coef, valid, edge_inv_len, iz_face, colors_face, H, W, sigma, gamma, face_sx,
            face_sy):
    """Batched inputs (leading B) -> (packed faces (B, Fp, NF), table
    (B, n_tiles, n_fb)): face padding to FBLOCK, the stable tile sort by the
    clamped centroid's screen tile (invalid and padding faces last), scale
    folding and the depth weights, all differentiable w.r.t. the float inputs."""
    B, F = coef.shape[:2]
    f_pad = _round_up(F, FBLOCK) - F
    if f_pad:
        z = lambda t, *s: t.new_zeros(B, f_pad, *s)
        coef = torch.cat([coef, z(coef, 3, 4)], 1)
        valid = torch.cat([valid, z(valid)], 1)
        edge_inv_len = torch.cat([edge_inv_len, z(edge_inv_len, 3)], 1)
        iz_face = torch.cat([iz_face, z(iz_face)], 1)
        colors_face = torch.cat([colors_face, z(colors_face, 3)], 1)
    n_ty, n_tx = grid_dims(H, W)
    cx = face_sx.mean(-1).clamp(0.0, n_tx * TILE_W - 1.0)
    cy = face_sy.mean(-1).clamp(0.0, n_ty * TILE_H - 1.0)
    if f_pad:
        cx = torch.cat([cx, cx.new_full((B, f_pad), float("inf"))], 1)
        cy = torch.cat([cy, cy.new_full((B, f_pad), float("inf"))], 1)
    key = (torch.div(cy, TILE_H, rounding_mode="floor") * n_tx
           + torch.div(cx, TILE_W, rounding_mode="floor"))
    key = torch.where(valid, key, torch.full_like(key, 1e9)).detach()
    order = torch.argsort(key, dim=1, stable=True)
    take = lambda t: torch.gather(t, 1, order.reshape(B, -1, *[1] * (t.dim() - 2))
                                  .expand(-1, -1, *t.shape[2:]))
    coef, valid, edge_inv_len = take(coef), take(valid), take(edge_inv_len)
    iz_face, colors_face = take(iz_face), take(colors_face)
    # cs[b, f, e, c] = coef[b, f, c, e] * scale[b, f, e]: pixel coefficient c
    # of the scaled distance to edge e (the iz channel is not used here)
    cs = coef[..., :3].transpose(-1, -2) * edge_inv_len[..., None]
    tab = overlap_table_halfplane(valid, cs.detach(), H, W, margin=_MARGIN_LOGITS * float(sigma))
    ezf = torch.exp(torch.clamp(iz_face / gamma, -60.0, 60.0))
    return pack_faces(cs, ezf, colors_face, valid.to(cs.dtype)), tab


def soft_aggregate(coef, valid, edge_inv_len, iz_face, colors_face, H: int, W: int,
                   sigma: float, gamma: float, face_sx, face_sy):
    """Fused soft aggregation -> (sil_prod (B, H*W), num (B, H*W, 3), den (B, H*W)).

    coef (B, F, 3, 4) from raster._face_coefficients, valid (B, F) bool,
    edge_inv_len (B, F, 3), iz_face (B, F), colors_face (B, F, 3), face_sx /
    face_sy (B, F, 3) screen corners (the tile-sort key). sil_prod = prod_f
    (1 - prob_f); differentiable w.r.t. coef, edge_inv_len, iz_face and
    colors_face. One forward and one backward launch serve all B views."""
    faces, tab = prepare(coef, valid, edge_inv_len, iz_face, colors_face, H, W, sigma, gamma,
                         face_sx, face_sy)
    sil_log, num, den = aggregate(faces, tab, H, W, 1.0 / float(sigma))
    return torch.exp(sil_log), num, den
