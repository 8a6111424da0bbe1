"""B4's forward kernel (csrc/fused_composite.cu) stages each CTA's rays
through shared memory; its index map on the CPU, through the Python twins
``fused_composite.cta_span`` and ``stage_plan`` (the kernel itself runs
only on the card: tests/test_torch_cuda.py):

* every float of a span is copied exactly once, to buffer float m + j, the
  16-byte copies aligned at the source and in the buffer, within the
  buffer's RAYS x 64 x width + 4 floats;
* over a whole problem (ragged ray counts, S below 64 and odd, W 6 and 3,
  inputs that start at any float of a 16-byte word), the forward's reads
  (warp w, lane l: samples l and l + 32 below S, every channel, at buffer
  float m + (w S + k) W + c) take each (ray, sample, channel) exactly once,
  and find its value there.
"""

import numpy as np
import pytest

from avatarclip_torch.ops import fused_composite as fc

RAYS, MAXS = fc.RAYS_PER_CTA, fc.MAX_SAMPLES


@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_stage_plan_copies_every_float_once(m):
    for n in list(range(0, 70)) + [RAYS * MAXS * w for w in (1, 3, 6)]:
        hits = np.zeros(n, np.int64)
        dst = np.full(n + 8, -1, np.int64)
        for j0, b0, k in fc.stage_plan(m, n):
            assert k in (1, 4)
            if k == 4:  # a 16-byte copy: aligned in the source and in the buffer
                assert (m + j0) % 4 == 0 and b0 % 4 == 0
            hits[j0:j0 + k] += 1
            dst[b0:b0 + k] = np.arange(j0, j0 + k)
        assert (hits == 1).all(), (m, n)
        assert (dst[m:m + n] == np.arange(n)).all()
        assert max((b0 + k for _, b0, k in fc.stage_plan(m, n)), default=0) <= n + 4


def _staged(src: np.ndarray, mis: int, first: int, n: int) -> np.ndarray:
    """A CTA's shared buffer after stage(): the span src[first, first + n)
    of an array that starts ``mis`` floats past a 16-byte boundary."""
    m = (mis + first) % 4
    buf = np.full(n + 4, np.nan)
    for j0, b0, k in fc.stage_plan(m, n):
        buf[b0:b0 + k] = src[first + j0:first + j0 + k]
    return buf, m


@pytest.mark.parametrize("R,S,W", [(37, 64, 6), (19, 37, 3), (8, 1, 6), (9, 63, 6), (17, 33, 3)])
@pytest.mark.parametrize("mis", [(0, 0, 0), (1, 2, 3), (3, 1, 2)])
def test_forward_reads_each_sample_channel_once(R, S, W, mis):
    arrays = {"alpha": 1, "rgb": W, "grad": 3}
    srcs = {nm: np.arange(R * S * w, dtype=np.float64) for nm, w in arrays.items()}
    reads = {nm: np.zeros(R * S * w, np.int64) for nm, w in arrays.items()}
    for cta in range(-(-R // RAYS)):
        nr = min(RAYS, R - cta * RAYS)
        for (nm, w), ms in zip(arrays.items(), mis):
            first, n = fc.cta_span(cta, R, S, w)
            assert n == nr * S * w
            buf, m = _staged(srcs[nm], ms, first, n)
            for warp in range(nr):
                ray = cta * RAYS + warp
                for lane in range(32):
                    for k in (lane, lane + 32):
                        if k >= S:
                            continue
                        for c in range(w):
                            want = (ray * S + k) * w + c
                            assert buf[m + (warp * S + k) * w + c] == want
                            reads[nm][want] += 1
    for nm, r in reads.items():
        assert (r == 1).all(), nm
