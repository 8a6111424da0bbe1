"""The tensor-core kernels of B3's forward and B6's backward, on the CPU
(the kernels themselves run only on the card: tests/test_torch_cuda.py):

* the packed bf16 weight layout of the SDF layers alone, which B6's
  tensor-core backward reads (``fused_neus.pack_tc`` on B6's flat buffer):
  every SDF matrix in its forward (W^T) and reverse (W) forms at its
  offset, exact against the dense weights, and no colour slot;
* the flat layout's shapes (``fused_neus.flat_shapes``) and packing from a
  flat buffer (``fused_neus.pack_flat``), as the wrappers pack when they are
  not handed a pack;
* the packs' placement for the kernels' bulk copies: every matrix of
  ``pack_tc``, ``pack_sdf_only_tc`` and ``pack_colour_tc`` starts 128-byte
  aligned, the matrices follow one another without gaps, and each chunk a
  warpgroup's producer copies into its ring (TC_KS k-steps of its slice of
  a pass, ``fused_neus.chunk_span``) is one aligned, contiguous run holding
  exactly those k-steps of the slice's columns;
* the mode dispatch of ``fused_neus.neus_point_fwd`` and
  ``fused_sdf.sdf_bwd``: the tensor-core library in the bf16 operand mode,
  the CUDA-core one in f32, checked without a launch (the library getters
  are replaced by ones that name themselves and stop).
"""

import dataclasses

import pytest
import torch

from avatarclip_torch.fields import networks as nets
from avatarclip_torch.ops import fused_color as fc
from avatarclip_torch.ops import fused_neus as fn
from avatarclip_torch.ops import fused_sdf as fs

WIDTHS = {
    256: (dict(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6),
          dict(d_feature=256, d_hidden=256, n_layers=2, extra_color=True)),
    128: (dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6),
          dict(d_feature=128, d_hidden=128, n_layers=1, extra_color=True)),
}


def _fields(width: int, dtype: str = "bfloat16"):
    skw, ckw = WIDTHS[width]
    return nets.NeuSFields(nets.SDFConfig(**skw, dtype=dtype), nets.ColorConfig(**ckw, dtype=dtype),
                           0.3, torch.Generator().manual_seed(width))


def _packed_matrices(kind: str, width: int):
    """(pack, Pack, {slot: (K, N) matrix}) of B1's pair, #12 or B7 (the
    colour net in no_view_dir, with its 262- or 134-wide first layer)."""
    fields = _fields(width)
    if kind == "colour":
        spec = fc.spec_from_config(fields.color.cfg)
        tcw = fc.tc_weights(spec, [w.detach() for w in fc.dense_weights(fields.color, spec)])
        pk, pack = fn.pack_colour_tc(tcw)
        mats = tcw[0::2]
        return pk, pack, {s: m for l, w in enumerate(mats) for s, m in ((fn._FC + l, w.t()), (fn._RC + l, w))}
    if kind == "sdf_only":
        sdf = fields.sdf
        spec = fs.spec_from_config(sdf.cfg)
        weights = fs.dense_weights(sdf)
        pk, pack = fn.pack_sdf_only_tc(spec, weights)
        return pk, pack, {fn._FS + i: w.detach().t() for i, w in enumerate(weights[0:2 * (spec.n_hidden + 1):2])}
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
    weights = [w.detach() for w in fn.dense_weights(fields.sdf, fields.color)]
    pk, pack = fn.pack_tc(spec, weights)
    NH, mats = spec.n_hidden, weights[0::2]
    head = mats[NH + 1][1:] / 2.0 ** 0.5
    want = {fn._FHEAD: head.t(), fn._RHEAD: head}
    for i in range(NH + 1):
        want[fn._FS + i], want[fn._RS + i] = mats[i].t(), mats[i]
    for l, w in enumerate(mats[NH + 2:]):
        want[fn._FC + l], want[fn._RC + l] = w.t(), w
    return pk, pack, want


@pytest.mark.parametrize("width", [256, 128])
@pytest.mark.parametrize("kind", ["pair", "sdf_only", "colour"])
def test_pack_stages_are_aligned_contiguous_runs(kind, width):
    """Every packed matrix starts on 128 bytes (a bulk copy's and a wgmma
    descriptor's alignment, given a 128-byte-aligned pack, which
    fused_neus.check_packed requires), the matrices tile the pack without a
    gap, and each chunk a warpgroup's producer copies, TC_KS k-steps from kt
    of warpgroup w's slice of pass p (chunk_span: one bulk copy into a slot
    of its ring), starts on 128 bytes and holds those k-steps of the slice's
    columns and nothing else, core matrix by core matrix."""
    pk, pack, mats = _packed_matrices(kind, width)
    end = 0
    for slot in sorted(mats, key=lambda s: pack.off[s]):
        K, N = mats[slot].shape
        base = pack.off[slot] * 4  # bf16 elements
        assert base * 2 % 128 == 0 and base == end
        KT, NT = -(-K // 16), -(-N // 8)
        end = base + KT * 16 * NT * 8
        padded = torch.zeros(KT * 16, NT * 8)
        padded[:K, :N] = mats[slot].bfloat16().float()
        for p in range(-(-NT // fn.TC_PASS)):
            for w in range(fn.TC_PASS // fn.TC_SLICE):
                n0 = p * fn.TC_PASS + w * fn.TC_SLICE
                if n0 >= NT:
                    continue
                nw = min(fn.TC_SLICE, NT - n0)
                for kt in range(0, KT, fn.TC_KS):
                    nk = min(fn.TC_KS, KT - kt)
                    off, size = fn.chunk_span(K, N, p, w, kt)
                    assert (base + off) * 2 % 128 == 0 and size == nk * nw * 128
                    run = pk[base + off:base + off + size].float().reshape(nk, nw, 2, 8, 8)
                    cols = padded[16 * kt:16 * (kt + nk), 8 * n0:8 * (n0 + nw)]
                    torch.testing.assert_close(run.permute(0, 2, 4, 1, 3).reshape(16 * nk, 8 * nw), cols,
                                               rtol=0, atol=0)
    assert end == pk.numel()
    if kind == "pair" and width == 256:  # the colour input's reverse is 262 wide: two passes
        assert mats[fn._RC + 0].shape[1] == 262


@pytest.mark.parametrize("width", [256, 128])
def test_pack_tc_holds_every_matrix_of_the_sdf_layers(width):
    """B6's pack: each SDF matrix in its forward and reverse forms at its
    offset, the head's feature rows scaled by 1/sqrt(2), exact; the colour
    slots empty and the buffer only as long as the SDF matrices."""
    sdf = _fields(width).sdf
    spec = fs.spec_from_config(sdf.cfg)
    weights = fs.dense_weights(sdf)
    pk, pack = fn.pack_tc(spec, weights)
    NH = spec.n_hidden
    mats = [w.detach() for w in weights[0::2]]
    assert len(mats) == NH + 2
    head = mats[NH + 1][1:] / 2.0 ** 0.5
    want = {fn._FHEAD: head.t(), fn._RHEAD: head}
    for i in range(NH + 1):
        want[fn._FS + i], want[fn._RS + i] = mats[i].t(), mats[i]
    total = 0
    for slot, b in want.items():
        K, N = b.shape
        n = -(-K // 16) * 16 * -(-N // 8) * 8
        off = pack.off[slot] * 4
        torch.testing.assert_close(fn.unpack_b(pk[off:off + n], K, N), b.bfloat16().float(),
                                   rtol=0, atol=0)
        total += n
    assert pk.numel() == total and pk.dtype == torch.bfloat16
    assert all(pack.off[fn._FC + l] == 0 and pack.off[fn._RC + l] == 0 for l in range(fn.MAX_NH + 1))


@pytest.mark.parametrize("width", [256, 128])
def test_flat_shapes_and_pack_flat_match_the_dense_weights(width):
    """flat_shapes gives the dense weight list's shapes for both kernel
    families (SDF and colour layers; the SDF layers alone), and pack_flat
    of the flat buffer is pack_tc of the list."""
    fields = _fields(width)
    for spec, weights in (
            (fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64),
             fn.dense_weights(fields.sdf, fields.color)),
            (fs.spec_from_config(fields.sdf.cfg), fs.dense_weights(fields.sdf))):
        assert fn.flat_shapes(spec.dims()) == [w.shape for w in weights]
        flat = torch.cat([w.detach().reshape(-1) for w in weights])
        pk, pack = fn.pack_tc(spec, weights)
        pk2, pack2 = fn.pack_flat(spec, flat)
        assert torch.equal(pk, pk2) and list(pack.off) == list(pack2.off)


class _Picked(Exception):
    pass


def _picker(name):
    def lib():
        raise _Picked(name)
    return lib


@pytest.fixture
def pick_libs(monkeypatch):
    """Library getters that stop with their own name: which library a
    wrapper takes, without a build or a launch."""
    monkeypatch.setattr(fn, "_tc_lib", _picker("tensor cores"))
    monkeypatch.setattr(fn, "_point_lib", _picker("B3 CUDA cores"))
    monkeypatch.setattr(fs, "_lib", _picker("B6 CUDA cores"))


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B3 CUDA cores")])
def test_point_forward_takes_the_tensor_cores_in_bf16(pick_libs, dtype, want):
    fields = _fields(128, dtype)
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 8)
    assert spec.bf16 is (dtype == "bfloat16")
    flat = torch.cat([w.detach().reshape(-1) for w in fn.dense_weights(fields.sdf, fields.color)])
    rays = torch.zeros(4, 3)
    with pytest.raises(_Picked, match=want):
        fn.neus_point_fwd(spec, flat, rays, rays, torch.zeros(4, 8), torch.zeros(4, 8),
                          torch.ones(()), 0.4)
    # the backward takes the forward's library: the tensor cores in bf16
    with pytest.raises(_Picked, match=want):
        fn.neus_point_bwd(spec, flat, rays, rays, torch.zeros(4, 8), torch.zeros(4, 8),
                          torch.ones(()), 0.4, *[None] * 8)


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B6 CUDA cores")])
def test_sdf_backward_takes_the_tensor_cores_in_bf16(pick_libs, dtype, want):
    sdf = _fields(128, dtype).sdf
    spec = fs.spec_from_config(sdf.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fs.dense_weights(sdf)])
    pts = torch.zeros(5, 3)
    with pytest.raises(_Picked, match=want):
        fs.sdf_bwd(spec, flat, pts, torch.zeros(5, 1), torch.zeros(5, 128), torch.zeros(5, 3))
    # the forward too takes the tensor cores in bf16 and the CUDA cores in f32
    with pytest.raises(_Picked, match=want):
        fs.sdf_fwd(spec, flat, pts)
    # the operand mode is the spec's: the same net read at f32
    with pytest.raises(_Picked, match="B6 CUDA cores"):
        fs.sdf_bwd(dataclasses.replace(spec, bf16=False), flat, pts, None, None, None)


def test_wrappers_raise_without_a_card():
    """No fallback: the tensor-core wrappers take CUDA tensors only (the
    entries' CPU route is the plain version, chosen by the caller)."""
    fields = _fields(128)
    spec = fn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 8)
    flat = torch.cat([w.detach().reshape(-1) for w in fn.dense_weights(fields.sdf, fields.color)])
    rays = torch.zeros(4, 3)
    with pytest.raises((ValueError, RuntimeError)):
        fn.neus_point_fwd(spec, flat, rays, rays, torch.zeros(4, 8), torch.zeros(4, 8),
                          torch.ones(()), 0.4)
    sdf = fields.sdf
    with pytest.raises(ValueError, match="CUDA"):
        fs.sdf_with_gradient_fused(sdf, torch.zeros(5, 3))
