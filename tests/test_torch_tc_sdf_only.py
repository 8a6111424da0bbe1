"""#12, the sdf-only forward, on the tensor cores in the bf16 operand mode,
on the CPU (the kernel itself runs only on the card: tests/test_torch_cuda.py
and chip_smoke.py):

* its packed bf16 weights (``fused_neus.pack_sdf_only_tc``): every SDF
  matrix the sdf-only stack multiplies (the hidden layers and the
  skip-producing layer) in its forward form W^T at its offset, exact, and
  nothing else: no head, no reverse form, no colour slot;
* the mode dispatch of ``fused_sdf.sdf_only_fwd``: the tensor-core library
  in the bf16 mode, checked against its own weight count, fused_sdf.cu's in
  f32 (the library getters replaced by ones that name themselves or
  record, no build);
* ``SDFOnlyFunction`` hands the kernel this call's weights: the flat f32
  buffer and, in the bf16 mode, their pack, packed anew on every call (a
  parameter changed in place is in the next call's pack), none in f32.
"""

import pytest
import torch

from avatarclip_torch.fields import networks as nets
from avatarclip_torch.ops import fused_neus as fn
from avatarclip_torch.ops import fused_sdf as fs

WIDTHS = {256: dict(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6),
          128: dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6)}


def _sdf(width: int, dtype: str = "bfloat16") -> nets.SDFNetwork:
    return nets.SDFNetwork(nets.SDFConfig(**WIDTHS[width], dtype=dtype),
                           torch.Generator().manual_seed(width))


def _flat(weights):
    return torch.cat([w.detach().reshape(-1) for w in weights])


@pytest.mark.parametrize("width", [256, 128])
def test_pack_sdf_only_tc_holds_every_matrix_the_stack_reads(width):
    sdf = _sdf(width)
    spec = fs.spec_from_config(sdf.cfg)
    weights = fs.dense_weights(sdf)
    pk, pack = fn.pack_sdf_only_tc(spec, weights)
    mats = [w.detach() for w in weights[0::2]]
    total = 0
    for i in range(spec.n_hidden + 1):
        b = mats[i].t()
        K, N = b.shape
        n = -(-K // 16) * 16 * -(-N // 8) * 8
        off = pack.off[fn._FS + i] * 4
        torch.testing.assert_close(fn.unpack_b(pk[off:off + n], K, N), b.bfloat16().float(),
                                   rtol=0, atol=0)
        total += n
    assert pk.numel() == total and pk.dtype == torch.bfloat16
    others = [s for s in range(fn._NMAT) if not fn._FS <= s <= fn._FS + spec.n_hidden]
    assert all(pack.off[s] == 0 for s in others)
    # the wrapper's own pack of a flat buffer is the same
    shapes = fn.flat_shapes(spec.dims())
    pk2, pack2 = fn.pack_sdf_only_tc(spec, fs.split_flat(_flat(weights), shapes))
    assert torch.equal(pk, pk2) and list(pack.off) == list(pack2.off)


class _Picked(Exception):
    pass


def _picker(name):
    def lib():
        raise _Picked(name)
    return lib


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B8 CUDA cores")])
def test_sdf_only_forward_takes_the_tensor_cores_in_bf16(monkeypatch, dtype, want):
    monkeypatch.setattr(fn, "_tc_lib", _picker("tensor cores"))
    monkeypatch.setattr(fs, "_lib", _picker("B8 CUDA cores"))
    sdf = _sdf(128, dtype)
    spec = fs.spec_from_config(sdf.cfg)
    assert spec.bf16 is (dtype == "bfloat16")
    with pytest.raises(_Picked, match=want):
        fs.sdf_only_fwd(spec, _flat(fs.dense_weights(sdf)), torch.zeros(5, 3))


class _CountingLib:
    """A library that answers one weight-count query and records which."""

    def __init__(self, count):
        self.count, self.asked = count, []

    def neus_tc_weight_count(self, d):
        self.asked.append(("tensor cores", d.H, d.NH, d.SW, d.F))
        return self.count

    def sdf_weight_count(self, d):
        self.asked.append(("B8 CUDA cores", d.H, d.NH, d.SW, d.F))
        return self.count


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B8 CUDA cores")])
def test_sdf_only_forward_checks_its_librarys_weight_count(monkeypatch, dtype, want):
    """The flat buffer is checked against the chosen library's own weight
    count (the tensor-core one's in bf16), then the device: on the CPU the
    wrapper raises (no fallback)."""
    sdf = _sdf(256, dtype)
    spec = fs.spec_from_config(sdf.cfg)
    flat = _flat(fs.dense_weights(sdf))
    lib = _CountingLib(flat.numel())
    monkeypatch.setattr(fn, "_tc_lib", lambda: lib)
    monkeypatch.setattr(fs, "_lib", lambda: lib)
    with pytest.raises(ValueError, match="CUDA"):
        fs.sdf_only_fwd(spec, flat, torch.zeros(5, 3))
    d = spec.dims()
    assert lib.asked == [(want, d.H, d.NH, d.SW, d.F)]
    lib.count += 1  # a buffer of another net's size is refused first
    with pytest.raises(ValueError, match="does not match"):
        fs.sdf_only_fwd(spec, flat, torch.zeros(5, 3))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sdf_only_function_packs_each_calls_weights(monkeypatch, dtype):
    calls = []
    monkeypatch.setattr(fs, "sdf_only_fwd", lambda spec, flat, pts, packed=None: (
        calls.append((flat.clone(), packed)), torch.zeros(pts.shape[0], 1))[1])
    sdf = _sdf(128, dtype)
    spec = fs.spec_from_config(sdf.cfg)
    pts = torch.zeros(7, 3)
    for step in range(2):
        fs.SDFOnlyFunction.apply(spec, sdf, pts, *sdf.parameters())
        weights = fs.dense_weights(sdf)
        flat, packed = calls[-1]
        assert torch.equal(flat, _flat(weights))
        if dtype == "float32":
            assert packed is None
        else:
            pk, pack = fn.pack_sdf_only_tc(spec, weights)
            assert torch.equal(packed[0], pk) and list(packed[1].off) == list(pack.off)
        with torch.no_grad():  # an optimizer step in place: the next call packs the new weights
            sdf.layers[1].v.add_(0.25)
    assert not torch.equal(calls[0][0], calls[1][0])
    if dtype == "bfloat16":
        assert not torch.equal(calls[0][1][0], calls[1][1][0])


def test_sdf_value_fused_raises_without_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        fs.sdf_value_fused(_sdf(128), torch.zeros(5, 3))
