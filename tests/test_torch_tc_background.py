"""The tensor-core kernels of the background step in the bf16 operand mode,
B6's forward and B7's pair, on the CPU (the kernels themselves run only
on the card: tests/test_torch_cuda.py):

* B7's packed bf16 weights of the colour layers alone
  (``fused_neus.pack_colour_tc`` of ``fused_color.tc_weights``): every
  colour matrix in its forward (W^T) and reverse (W) forms at its offset,
  exact against the colour net's layers and ``fused_color.dense_weights``,
  in each mode, and no SDF slot;
* the first layer's gradient cut back from the joined (H, d_in) matrix into
  ``dense_weights``' per-input slices (``fused_color.slices_from_tc``), a
  zero slice for an input the mode does not read: on an index pattern, and
  on autograd's gradients of the two layouts;
* the mode dispatch of ``fused_sdf.sdf_fwd``, ``fused_color.color_fwd`` and
  ``fused_color.color_bwd``: the tensor-core library in the bf16 operand
  mode, the CUDA-core one in f32 (checked without a launch: the library
  getters are replaced by ones that name themselves and stop), and the
  wrappers raising without a card;
* ``fused_color.tc_pack``, the colour weights packed once for both
  tensor-core kernels.
"""

import dataclasses

import pytest
import torch

from avatarclip_torch.fields import networks as nets
from avatarclip_torch.ops import fused_color as fc
from avatarclip_torch.ops import fused_neus as fn
from avatarclip_torch.ops import fused_sdf as fs

MODES = ("idr", "no_view_dir", "no_normal")
WIDTHS = {256: dict(d_feature=256, d_hidden=256, n_layers=2, extra_color=True),
          128: dict(d_feature=128, d_hidden=128, n_layers=1, extra_color=False)}


def _colour(mode: str, width: int, dtype: str = "bfloat16") -> nets.ColorNetwork:
    cfg = nets.ColorConfig(mode=mode, d_in=9 if mode == "idr" else 6, dtype=dtype, **WIDTHS[width])
    return nets.ColorNetwork(cfg, torch.Generator().manual_seed(width + len(mode)))


def _colour_spec(mode: str, width: int, dtype: str = "bfloat16"):
    net = _colour(mode, width, dtype)
    spec = fc.spec_from_config(net.cfg)
    return net, spec, [w.detach() for w in fc.dense_weights(net, spec)]


@pytest.mark.parametrize("width", [256, 128])
@pytest.mark.parametrize("mode", MODES)
def test_pack_colour_tc_holds_every_matrix_of_the_colour_layers(mode, width):
    """B7's pack: the first layer as the colour net's own (H, d_in) weight
    (its columns in the concatenation's order), the relu layers and the
    stacked head, each in its forward and reverse forms at its offset,
    exact; the SDF slots empty and the buffer only as long as the colour
    matrices."""
    net, spec, weights = _colour_spec(mode, width)
    tcw = fc.tc_weights(spec, weights)
    pk, pack = fn.pack_colour_tc(tcw)
    head = net.layers[-1].dense()
    if net.extra is not None:
        head = torch.cat([head, net.extra.dense()])
    mats = [net.layers[0].dense()] + [layer.dense() for layer in net.layers[1:-1]] + [head]
    assert len(mats) == spec.n_hidden + 1 and mats[0].shape == (spec.d_hidden, spec.d_in)
    want = {}
    for l, w in enumerate(m.detach() for m in mats):
        want[fn._FC + l], want[fn._RC + l] = w.t(), w
    total = 0
    for slot, b in want.items():
        K, N = b.shape
        n = -(-K // 16) * 16 * -(-N // 8) * 8
        off = pack.off[slot] * 4
        torch.testing.assert_close(fn.unpack_b(pk[off:off + n], K, N), b.bfloat16().float(),
                                   rtol=0, atol=0)
        total += n
    assert pk.numel() == total and pk.dtype == torch.bfloat16
    assert all(pack.off[s] == 0 for s in range(fn._FC))
    # the joined first layer holds dense_weights' slices at the mode's columns
    cx, cn, cv, cf = fc._COLUMNS[mode]
    for c, w in zip((cx, cn, cv), weights[:3]):
        if c is None:
            assert not w.any()
        else:
            assert torch.equal(tcw[0][:, c:c + 3], w)
    assert torch.equal(tcw[0][:, cf:], weights[3])
    assert [t.shape for t in tcw[1:]] == [t.shape for t in weights[4:]]


@pytest.mark.parametrize("mode", MODES)
def test_slices_from_tc_cuts_the_first_layer_back_into_its_slices(mode):
    """An index pattern in the joined layout lands at the slice layout's
    places, zeros in the slice of an input the mode does not read; the
    joined flat weights of dense_weights come back as they were."""
    _, spec, weights = _colour_spec(mode, 128)
    assert fc.slice_shapes(spec) == [w.shape for w in weights]
    H, Din = spec.d_hidden, spec.d_in
    tcw = fc.tc_weights(spec, weights)
    n_tc = sum(w.numel() for w in tcw)
    idx = torch.arange(1, n_tc + 1, dtype=torch.float32)
    out = fn.split_flat(fc.slices_from_tc(spec, idx), fc.slice_shapes(spec))
    joined = idx[:H * Din].reshape(H, Din)
    for c, got in zip(fc._COLUMNS[mode][:3], out[:3]):
        assert torch.equal(got, joined[:, c:c + 3] if c is not None else torch.zeros(H, 3))
    assert torch.equal(out[3], joined[:, Din - spec.d_feature:])
    assert torch.equal(torch.cat([t.reshape(-1) for t in out[4:]]), idx[H * Din:])
    flat = torch.cat([w.reshape(-1) for w in weights])
    flat_tc = torch.cat([w.reshape(-1) for w in tcw])
    assert torch.equal(fc.slices_from_tc(spec, flat_tc), flat)


def _slice_layout_forward(spec, weights, x, n, v, f):
    """The colour net in dense_weights' slice layout, f64 (the fused_color.cu
    form: the first layer summed over the slices of the inputs the mode
    reads)."""
    h = f @ weights[3].t() + weights[4]
    for c, t, w in zip(fc._COLUMNS[spec.mode][:3], (x, n, v), weights[:3]):
        if c is not None:
            h = h + t @ w.t()
    h = torch.relu(h)
    rest = weights[5:]
    for w, b in zip(rest[0:-2:2], rest[1:-2:2]):
        h = torch.relu(h @ w.t() + b)
    return torch.sigmoid(h @ rest[-2].t() + rest[-1])


def _joined_layout_forward(spec, weights, x, n, v, f):
    """The same net in tc_weights' joined layout (the tensor-core kernel's)."""
    vecs = {"idr": [x, v, n], "no_view_dir": [x, n], "no_normal": [x, v]}[spec.mode]
    h = torch.cat(vecs + [f], 1)
    for w, b in zip(weights[0:-2:2], weights[1:-2:2]):
        h = torch.relu(h @ w.t() + b)
    return torch.sigmoid(h @ weights[-2].t() + weights[-1])


@pytest.mark.parametrize("mode", MODES)
def test_joined_gradient_cut_back_is_the_slice_gradient(mode):
    """Autograd's weight gradients of the joined layout, cut back by
    slices_from_tc, are those of the slice layout (the input a mode does not
    read: a zero gradient), in f64 to rounding."""
    _, spec, weights = _colour_spec(mode, 128)
    g = torch.Generator().manual_seed(3)
    P, F = 37, spec.d_feature
    ins = [torch.randn(P, k, generator=g, dtype=torch.float64) for k in (3, 3, 3, F)]
    cot = torch.rand(P, spec.rgb_width, generator=g, dtype=torch.float64)
    ws = [w.double().requires_grad_(True) for w in weights]
    (_slice_layout_forward(spec, ws, *ins) * cot).sum().backward()
    want = torch.cat([(w.grad if w.grad is not None else torch.zeros_like(w)).reshape(-1) for w in ws])
    tcw = [w.double().requires_grad_(True) for w in fc.tc_weights(spec, weights)]
    out = _joined_layout_forward(spec, tcw, *ins)
    torch.testing.assert_close(out, _slice_layout_forward(spec, [w.double() for w in weights], *ins))
    (out * cot).sum().backward()
    got = fc.slices_from_tc(spec, torch.cat([w.grad.reshape(-1) for w in tcw]))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


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
    monkeypatch.setattr(fs, "_lib", _picker("B6 CUDA cores"))
    monkeypatch.setattr(fc, "_lib", _picker("B7 CUDA cores"))


def _sdf(dtype: str):
    cfg = nets.SDFConfig(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), dtype=dtype)
    return nets.SDFNetwork(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B6 CUDA cores")])
def test_sdf_forward_takes_the_tensor_cores_in_bf16(pick_libs, dtype, want):
    sdf = _sdf(dtype)
    spec = fs.spec_from_config(sdf.cfg)
    assert spec.bf16 is (dtype == "bfloat16")
    flat = torch.cat([w.detach().reshape(-1) for w in fs.dense_weights(sdf)])
    with pytest.raises(_Picked, match=want):
        fs.sdf_fwd(spec, flat, torch.zeros(5, 3))
    # the operand mode is the spec's: the same net read at f32
    with pytest.raises(_Picked, match="B6 CUDA cores"):
        fs.sdf_fwd(dataclasses.replace(spec, bf16=False), flat, torch.zeros(5, 3))


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B7 CUDA cores")])
@pytest.mark.parametrize("mode", MODES)
def test_colour_backward_takes_the_tensor_cores_in_bf16(pick_libs, mode, dtype, want):
    _, spec, weights = _colour_spec(mode, 128, dtype)
    assert spec.bf16 is (dtype == "bfloat16")
    flat = torch.cat([w.reshape(-1) for w in weights])
    x = torch.zeros(5, 3)
    ins = (x, x, x, torch.zeros(5, spec.d_feature))
    with pytest.raises(_Picked, match=want):
        fc.color_bwd(spec, flat, *ins, torch.zeros(5, spec.rgb_width))


@pytest.mark.parametrize("dtype,want", [("bfloat16", "tensor cores"), ("float32", "B7 CUDA cores")])
@pytest.mark.parametrize("mode", MODES)
def test_colour_forward_takes_the_tensor_cores_in_bf16(pick_libs, mode, dtype, want):
    _, spec, weights = _colour_spec(mode, 128, dtype)
    flat = torch.cat([w.reshape(-1) for w in weights])
    x = torch.zeros(5, 3)
    ins = (x, x, x, torch.zeros(5, spec.d_feature))
    with pytest.raises(_Picked, match=want):
        fc.color_fwd(spec, flat, *ins)
    # with the weights packed once (ColorFunction's pack for both kernels)
    if spec.bf16:
        with pytest.raises(_Picked, match=want):
            fc.color_fwd(spec, flat, *ins, fc.tc_pack(spec, flat))
    # the operand mode is the spec's: the same net read at f32
    with pytest.raises(_Picked, match="B7 CUDA cores"):
        fc.color_fwd(dataclasses.replace(spec, bf16=False), flat, *ins)


@pytest.mark.parametrize("mode", MODES)
def test_tc_pack_is_the_packing_of_the_joined_weights(mode):
    """fc.tc_pack, made once a step by ColorFunction for both tensor-core
    kernels: the joined flat buffer of tc_weights and pack_colour_tc of it,
    the same bits as packing them apart."""
    _, spec, weights = _colour_spec(mode, 128)
    flat = torch.cat([w.reshape(-1) for w in weights])
    flat_tc, pk, pack = fc.tc_pack(spec, flat)
    tcw = fc.tc_weights(spec, weights)
    assert torch.equal(flat_tc, torch.cat([w.reshape(-1) for w in tcw]))
    pk2, pack2 = fn.pack_colour_tc(tcw)
    assert torch.equal(pk, pk2) and list(pack.off) == list(pack2.off)


def test_wrappers_raise_without_a_card():
    """No fallback: without a card the bf16 wrappers raise (the library
    does not build, or the CPU tensors are refused), and the entries refuse
    CPU tensors (their CPU route is the plain version, chosen by the
    caller)."""
    sdf = _sdf("bfloat16")
    spec = fs.spec_from_config(sdf.cfg)
    flat = torch.cat([w.detach().reshape(-1) for w in fs.dense_weights(sdf)])
    with pytest.raises((ValueError, RuntimeError)):
        fs.sdf_fwd(spec, flat, torch.zeros(5, 3))
    with pytest.raises(ValueError, match="CUDA"):
        fs.sdf_with_gradient_fused(sdf, torch.zeros(5, 3))
    net, spec, weights = _colour_spec("no_view_dir", 128)
    flat = torch.cat([w.reshape(-1) for w in weights])
    x = torch.zeros(5, 3)
    with pytest.raises((ValueError, RuntimeError)):
        fc.color_bwd(spec, flat, x, x, x, torch.zeros(5, 128), torch.zeros(5, 3))
    with pytest.raises((ValueError, RuntimeError)):
        fc.color_fwd(spec, flat, x, x, x, torch.zeros(5, 128))
    with pytest.raises(ValueError, match="CUDA"):
        fc.color_apply_fused(net, x, x, x, torch.zeros(5, 128))
