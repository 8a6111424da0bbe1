"""Operations of SoftRas's aggregation (the soft raster's kernel pair) on
the (pixel, face) pairs an input needs: the live pairs, where the scaled
signed distance x = min_e d_e / sigma exceeds -104 (beyond it the
sigmoid and softplus are exactly 0 in float32, so the pair adds nothing).

Per pair, float32 operations with an FMA counted as 2: every evaluated
pair costs 16 (three edge distances, two mins, the scale, the test); a
live pair adds 15 in the forward (exp's argument, 1 + e, e / (1 + e), the
select, softplus's max and sum, the product of the (1 + e), w, num's 3
FMAs and den) and 34 in the backward, with 2 special-function operations
(exp, reciprocal) each way."""

from __future__ import annotations

import torch

from . import peaks

OPS_PAIR = 16
FWD_OPS_LIVE, BWD_OPS_LIVE = 15, 34
SFU_LIVE = 2
X_DEAD = -104.0


def live_pairs(cs: torch.Tensor, valid: torch.Tensor, H: int, W: int, sigma: float,
               chunk: int = 2048) -> float:
    """Live (pixel, face) pairs of a batch of views: ``cs`` (B, F, 3
    edges, [cx, cy, c1]) the edge functions scaled to pixel distances,
    ``valid`` (B, F). Each edge's condition cx px + (cy py + c1) > -104
    sigma bounds px on a pixel row, so a (face, row) pair's live pixels are
    an interval, counted in float64."""
    dev = cs.device
    T = X_DEAD * sigma
    py = torch.arange(H, device=dev, dtype=torch.float64)[None, None, :]
    live = 0.0
    for f0 in range(0, cs.shape[1], chunk):
        c = cs[:, f0:f0 + chunk].double()
        lo = torch.zeros(c.shape[0], c.shape[1], H, dtype=torch.float64, device=dev)
        hi = torch.full_like(lo, W - 1.0)
        ok = valid[:, f0:f0 + chunk, None].expand_as(lo).clone()
        for e in range(3):
            a = c[:, :, e, 0, None]
            k = c[:, :, e, 1, None] * py + c[:, :, e, 2, None]
            x = (T - k) / torch.where(a == 0, torch.ones_like(a), a)
            lo = torch.where(a > 0, torch.maximum(lo, torch.floor(x) + 1.0), lo)
            hi = torch.where(a < 0, torch.minimum(hi, torch.ceil(x) - 1.0), hi)
            ok = ok & ((a != 0) | (k > T))
        live += float(torch.where(ok, (hi - lo + 1.0).clamp_min(0.0), torch.zeros_like(lo)).sum())
    return live


def bound(ops: float, sfu: float, nbytes: float, clock_hz: float) -> dict:
    """max(float32 operations / 67 TFLOP/s, special functions / (132 SMs x
    16 a clock x the SM clock), bytes / 3.35 TB/s), in ms."""
    t = {"operations": ops / peaks.PEAK_F32 * 1e3,
         "special functions": sfu / (peaks.N_SM * peaks.SFU_PER_SM_CLOCK * clock_hz) * 1e3,
         "bytes": nbytes / peaks.HBM * 1e3}
    by = max(t, key=t.get)
    return {"bound_ms": t[by], "bound_resource": by, "ops": ops, "sfu_ops": sfu, "bytes": nbytes}


def pair_bounds(live: float, views: int, faces_padded: int, pixels: int, table_entries: int,
                clock_hz: float) -> tuple[dict, dict]:
    """(forward, backward) bounds of one aggregation: each packed face row
    (64 bytes) read once, the culling table read once, 20 bytes a pixel
    written forward (and read back); the backward also writes a face row's
    gradient."""
    face_b, pix_b, tab_b = views * faces_padded * 64, views * pixels * 20, table_entries * 4
    f = bound(live * (OPS_PAIR + FWD_OPS_LIVE), live * SFU_LIVE, face_b + tab_b + pix_b, clock_hz)
    b = bound(live * (OPS_PAIR + BWD_OPS_LIVE), live * SFU_LIVE, 2 * face_b + tab_b + pix_b, clock_hz)
    return f, b
