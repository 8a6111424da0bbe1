"""GEMM FLOPs and bytes of NeuS's per-ray pass (the forward and the
backward of the SDF and colour MLPs over a ray's samples, with the
eikonal term), from the network's widths.

Widths: E the encoding (3 (1 + 2 multires)), H the SDF's hidden width, NH
its hidden linears before the skip-producing one (n_layers - 1), SW the
skip-producing layer's width (H - E), F1 the head's outputs (1 +
feature), CW the colour net's input (6 + feature), HC its hidden width,
NHC its relu linears, W its outputs (6 with the extra head)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Dims:
    E: int
    H: int
    NH: int
    SW: int
    F1: int
    CW: int
    HC: int
    NHC: int
    W: int


def dims(sdf_cfg: dict, col_cfg: dict) -> Dims:
    E = 3 * (1 + 2 * int(sdf_cfg["multires"]))
    H = int(sdf_cfg["d_hidden"])
    feat = int(sdf_cfg["d_out"]) - 1
    return Dims(E=E, H=H, NH=int(sdf_cfg["n_layers"]) - 1, SW=H - E, F1=1 + feat, CW=6 + feat,
                HC=int(col_cfg["d_hidden"]), NHC=int(col_cfg["n_layers"]),
                W=6 if col_cfg.get("extra_color") else 3)


def gemm_flops(d: Dims) -> tuple[float, float]:
    """(forward, backward) GEMM FLOPs per point as the fused kernel pair
    computes them: the forward is the SDF stack, the spatial gradient's
    reverse sweep and the colour MLP; the backward recomputes the SDF and
    colour stacks, then the colour reverse and the forward-over-reverse
    SDF pass (elementwise work, ~1-2% more, not counted)."""
    E, H, NH, SW, F1, CW, HC, NHC, W = (d.E, d.H, d.NH, d.SW, d.F1, d.CW, d.HC, d.NHC, d.W)
    sdf_fwd = 2 * E * H + (NH - 1) * 2 * H * H + 2 * H * SW + 2 * H * F1
    sweep = 2 * SW * H + (NH - 1) * 2 * H * H + 2 * H * E
    col_fwd = 2 * CW * HC + (NHC - 1) * 2 * HC * HC + 2 * HC * W
    col_rev = 4 * HC * W + (NHC - 1) * 4 * HC * HC + 4 * HC * CW
    sdf_rev = (2 * E * H + (NH - 1) * 2 * H * H + 2 * H * SW
               + 4 * F1 * H + 8 * SW * H + 8 * H * E + (NH - 1) * 8 * H * H)
    return float(sdf_fwd + sweep + col_fwd), float(sdf_fwd + col_fwd + col_rev + sdf_rev)


def model_flops(d: Dims) -> float:
    """A training step's model FLOPs per point, without recompute: the
    forward, and the backward less its recomputed SDF and colour stacks."""
    E, H, NH, SW, F1, CW, HC, NHC, W = (d.E, d.H, d.NH, d.SW, d.F1, d.CW, d.HC, d.NHC, d.W)
    fwd, bwd = gemm_flops(d)
    sdf_fwd = 2 * E * H + (NH - 1) * 2 * H * H + 2 * H * SW + 2 * H * F1
    col_fwd = 2 * CW * HC + (NHC - 1) * 2 * HC * HC + 2 * HC * W
    return fwd + bwd - sdf_fwd - col_fwd


def sdf_only_flops(d: Dims) -> float:
    """FLOPs per point of an sdf-only query (the up-sample sweeps): the
    stack and the head's sdf row."""
    return float(2 * d.E * d.H + (d.NH - 1) * 2 * d.H * d.H + 2 * d.H * d.SW + 2 * d.H)


def n_weights(d: Dims) -> int:
    sdf = (d.E * d.H + d.H) + (d.NH - 1) * (d.H * d.H + d.H) + (d.H * d.SW + d.SW) + (d.H * d.F1 + d.F1)
    col = (d.CW * d.HC + d.HC) + (d.NHC - 1) * (d.HC * d.HC + d.HC) + (d.HC * d.W + d.W)
    return sdf + col


def pass_bytes(d: Dims, rays: int, samples: int) -> tuple[float, float]:
    """(forward, backward) bytes of the per-ray pair: each input read once,
    each output written once (float32)."""
    R, P, Wd, nw = rays, rays * samples, d.W, n_weights(d)
    fwd = 4 * (nw + 6 * R + 2 * P + (Wd + 4) * R + 4 * P + 2)
    bwd = 4 * (nw + 6 * R + 2 * P + 4 * P + (Wd + 4) * R + 2 + 6 * R + 2 * P + nw + 1)
    return float(fwd), float(bwd)
