"""Dot-operand rounding of the reference's matrix products.

``Precision(None)`` is the reference itself: float32 operands and sums.
The other modes round both operands of every matrix product before a
float32 product, as a lower-precision program would: ``tf32`` keeps 10
mantissa bits (round to nearest even), ``fp8`` is e4m3 with a per-tensor
scale that maps the operand's largest magnitude to 448. They serve the
controls, which must read as not correct: TF32 for the pose cell's float32,
fp8 for the sculpting cell's bf16 operands.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    keep = 13  # float32 has 23 mantissa bits, TF32 10
    half = 1 << (keep - 1)
    lsb = (bits >> keep) & 1
    bits = (bits + (half - 1) + lsb) & ~((1 << keep) - 1)
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


_ROUND = {"tf32": round_tf32, "fp8": round_fp8}


@dataclasses.dataclass(frozen=True)
class Precision:
    mode: str | None = None  # None: float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b with both operands rounded to the mode (gradients pass
        through the rounding unchanged)."""
        if self.mode is None:
            return a @ b
        r = _ROUND[self.mode]
        a = a + (r(a) - a).detach()
        b = b + (r(b) - b).detach()
        return a @ b

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        """x @ w^T + b, w in the (out, in) layout."""
        y = self.mm(x, w.t())
        return y if b is None else y + b


F32 = Precision()


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the reference's own products (restored afterwards)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
