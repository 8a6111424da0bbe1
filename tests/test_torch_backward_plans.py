"""The launch plans of #5 and #7, the point-level NeuS backward and the
compositing backward, on the CPU through their Python twins (the kernels
run only on the card: tests/test_torch_cuda.py and chip_smoke.py).

#5 in the bf16 mode (csrc/fused_neus_ray_tc.cu, ``neus_point_tc_bwd``):
* ``neus_point_bwd`` takes the tensor-core library in bf16 and the CUDA-core
  one in f32, checked by replacing the library getters (no build);
* its plan (``fused_neus.tc_bwd_plan``, B1's): a CTA an SM, at most
  RAYS_PER_CTA_CHUNK rays a CTA a chunk, the weight-gradient pass's splits
  at least a ray each and about two waves of CTAs.

#7 (csrc/fused_composite.cu, ``composite_bwd``): over whole problems (ragged
ray counts, S below 64 and odd, W 6 and 3, inputs and outputs at any float
of a 16-byte word), the staged reads (``cta_span``, ``stage_plan``) take
each (ray, sample, channel) of alpha, cw, rgb and grad once; each lane's
d rgb and d grad rows, written over the rows it read, reach their place in
the output through ``unstage_plan``, every output float written once, the
16-byte stores aligned in the output.
"""

import numpy as np
import pytest
import torch

from avatarclip_torch.fields import networks as nets
from avatarclip_torch.ops import fused_composite as fc
from avatarclip_torch.ops import fused_neus as fn

RAYS, MAXS = fc.RAYS_PER_CTA, fc.MAX_SAMPLES


class _Picked(Exception):
    pass


def _picker(name):
    def lib():
        raise _Picked(name)
    return lib


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "CUDA cores")])
def test_point_backward_takes_the_tensor_cores_in_bf16(monkeypatch, dtype, want):
    monkeypatch.setattr(fn, "_tc_lib", _picker("tensor cores"))
    monkeypatch.setattr(fn, "_point_lib", _picker("CUDA cores"))
    fields = nets.NeuSFields(
        nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), dtype=dtype),
        nets.ColorConfig(d_feature=128, d_hidden=128, n_layers=1, extra_color=True, dtype=dtype),
        0.3, torch.Generator().manual_seed(0))
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 8)
    flat = torch.cat([w.detach().reshape(-1) for w in fn.dense_weights(fields.sdf, fields.color)])
    rays = torch.zeros(4, 3)
    with pytest.raises(_Picked, match=want):
        fn.neus_point_bwd(spec, flat, rays, rays, torch.zeros(4, 8), torch.zeros(4, 8),
                          torch.ones(()), 0.4, *[None] * 8)


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("tiles", [1, 9, 40, 300])
def test_point_backward_plan_covers_the_rays(sms, tiles):
    for R in (1, 5, 131, 132, 1055, 1056, 2048, 16347, 16384):
        n_cta, chunk, n_split = fn.tc_bwd_plan(sms, tiles, R)
        assert 1 <= n_cta <= min(sms, R)
        assert 1 <= chunk <= n_cta * fn.RAYS_PER_CTA_CHUNK and chunk <= R
        assert 1 <= n_split <= chunk  # every split of a chunk's points has a ray
        assert tiles * n_split <= max(2 * sms, tiles)  # about two waves, at least one


@pytest.mark.parametrize("md", [0, 1, 2, 3])
@pytest.mark.parametrize("m_src", [0, 1, 2, 3])
def test_unstage_plan_writes_every_float_once(m_src, md):
    for n in list(range(0, 70)) + [RAYS * MAXS * w for w in (1, 3, 6)]:
        hits = np.zeros(n, np.int64)
        for j0, b0, k in fc.unstage_plan(m_src, md, n):
            assert k in (1, 4)
            if k == 4:  # a 16-byte store: aligned in the output
                assert (md + j0) % 4 == 0
            assert b0 == m_src + j0  # read from where the buffer holds float j0
            hits[j0:j0 + k] += 1
        assert (hits == 1).all(), (m_src, md, n)


@pytest.mark.parametrize("R,S,W", [(37, 64, 6), (19, 37, 3), (8, 1, 6), (9, 63, 6), (17, 33, 3)])
@pytest.mark.parametrize("mis", [(0, 0, 0, 0, 0, 0), (1, 2, 3, 1, 3, 2), (3, 1, 2, 2, 1, 3)])
def test_backward_stages_and_writes_each_sample_channel_once(R, S, W, mis):
    """Reads of alpha, cw, rgb, grad (staged) and writes of d rgb, d grad
    (in place in the rgb / grad buffers, then unstaged), CTA by CTA, warp w
    lane l holding samples l and l + 32 below S."""
    ins = {"alpha": 1, "cw": 1, "rgb": W, "grad": 3}
    outs = {"rgb": W, "grad": 3}
    srcs = {nm: np.arange(R * S * w, dtype=np.float64) for nm, w in ins.items()}
    reads = {nm: np.zeros(R * S * w, np.int64) for nm, w in ins.items()}
    dst = {nm: np.full(R * S * w, np.nan) for nm, w in outs.items()}
    writes = {nm: np.zeros(R * S * w, np.int64) for nm, w in outs.items()}
    m_in = dict(zip(ins, mis[:4]))
    m_out = dict(zip(outs, mis[4:]))
    for cta in range(-(-R // RAYS)):
        nr = min(RAYS, R - cta * RAYS)
        bufs = {}
        for nm, w in ins.items():
            first, n = fc.cta_span(cta, R, S, w)
            assert n == nr * S * w
            m = (m_in[nm] + first) % 4
            buf = np.full(n + 4, np.nan)
            assert n + 4 <= RAYS * MAXS * w + 4  # the kernel's buffer
            for j0, b0, k in fc.stage_plan(m, n):
                buf[b0:b0 + k] = srcs[nm][first + j0:first + j0 + k]
            bufs[nm] = (buf, m, first, n)
        for warp in range(nr):
            ray = cta * RAYS + warp
            for lane in range(32):
                for k in (lane, lane + 32):
                    if k >= S:
                        continue
                    for nm, w in ins.items():
                        buf, m, _, _ = bufs[nm]
                        for c in range(w):
                            i = m + (warp * S + k) * w + c
                            want = (ray * S + k) * w + c
                            assert buf[i] == want, (nm, ray, k, c)
                            reads[nm][want] += 1
                    for nm, w in outs.items():  # d rgb / d grad over the lane's own rows
                        buf, m, _, _ = bufs[nm]
                        for c in range(w):
                            buf[m + (warp * S + k) * w + c] = -1.0 - ((ray * S + k) * w + c)
        for nm, w in outs.items():
            buf, m, first, n = bufs[nm]
            md = (m_out[nm] + first) % 4
            for j0, b0, k in fc.unstage_plan(m, md, n):
                if k == 4:
                    assert (md + j0) % 4 == 0
                dst[nm][first + j0:first + j0 + k] = buf[b0:b0 + k]
                writes[nm][first + j0:first + j0 + k] += 1
    for nm in ins:
        assert (reads[nm] == 1).all(), nm
    for nm in outs:
        assert (writes[nm] == 1).all(), nm
        assert (dst[nm] == -1.0 - np.arange(dst[nm].size)).all(), nm
