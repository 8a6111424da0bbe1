"""NVIDIA H100 SXM's published peaks (dense, no sparsity, at its 700 W
limit)."""

PEAK_BF16 = 989e12  # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
HBM = 3.35e12  # bytes/s
N_SM = 132
SFU_PER_SM_CLOCK = 16  # special-function results per SM per clock

PEAK_BY_DTYPE = {"bfloat16": PEAK_BF16, "float32": PEAK_F32}


def bound(flops: float, nbytes: float, peak: float = PEAK_F32) -> dict:
    """The least time the card could take (ms): max(FLOPs / peak, bytes /
    HBM rate), and which of the two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def bound_tc(flops: float, nbytes: float) -> dict:
    """bound() for GEMMs on the bf16 tensor cores, with the float32
    CUDA-core bound beside it."""
    out = bound(flops, nbytes, PEAK_BF16)
    out["bound_ms_f32"] = max(flops / PEAK_F32 * 1e3, nbytes / HBM * 1e3)
    return out
