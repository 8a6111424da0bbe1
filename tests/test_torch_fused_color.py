"""The port's colour MLP pair (B7, ops/fused_color.py) against the JAX
package's (avatarclip_tpu/ops/fused_color.py).

``color_apply_plain`` (the kernel pair's plain version, which the CPU runs)
against JAX's ``color_apply_fused``, whose Pallas kernels run in interpret
mode with f32 dot operands, at 128 wide, 2 layers and 200 points (ragged
against the 256-point Pallas block), in ``no_view_dir`` with the extra head
and in ``idr`` without it: the output to 1e-4 and the VJP into every
parameter (g, v, b) and all four inputs to 1e-3, each relative to the
largest magnitude of what it is held against. Also: the kernel family, the
kernels' weight layout (the per-input first-layer slices and the stacked
head, evaluated as the kernels evaluate them), the gate on the CPU, and
that the CUDA entry raises on a CPU tensor."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_color as jfc
from avatarclip_tpu.ops import fused_sdf as jfs
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.ops import fused_color as tfc
from avatarclip_torch.utils.convert import params_from_jax

OUT_TOL, GRAD_TOL = 1e-4, 1e-3
MODES = {"no_view_dir": dict(mode="no_view_dir", d_in=6, extra_color=True),
         "idr": dict(mode="idr", d_in=9, extra_color=False)}


def _close(a, b, tol, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-6)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max(), scale)


def _setup(mode, P=200):
    kw = dict(d_feature=128, d_hidden=128, n_layers=2, **MODES[mode])
    cfg = jnets.ColorConfig(**kw)
    params = jnets.color_init(jax.random.PRNGKey(4), cfg)
    color = params_from_jax(tree_flatten_paths(params), tnets.ColorNetwork(tnets.ColorConfig(**kw)))
    g = np.random.default_rng(1)
    n = g.normal(size=(P, 3))
    ins = [g.uniform(-1, 1, (P, 3)), n / np.linalg.norm(n, axis=-1, keepdims=True),
           g.normal(size=(P, 3)), g.normal(size=(P, 128))]
    ins = [a.astype(np.float32) for a in ins]
    cot = g.normal(size=(P, 6 if kw["extra_color"] else 3)).astype(np.float32)
    return cfg, params, color, ins, cot


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_pallas_pair(mode, monkeypatch):
    cfg, params, color, ins, cot = _setup(mode)
    monkeypatch.setattr(jfs, "_OPERAND_DTYPE", jnp.float32)

    def jloss(p, *xs):
        out = jfc.color_apply_fused(p, cfg, *xs)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        params, *(jnp.asarray(a) for a in ins))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    out = tfc.color_apply_plain(color, *xs)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout, OUT_TOL, "rgb")
    named = dict(color.named_parameters())
    flat = tree_flatten_paths(jgrads[0])
    assert len(flat) == len(named)
    for path, gj in flat.items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    for nm, x, gj in zip(("points", "normals", "view_dirs", "features"), xs, jgrads[1:]):
        if x.grad is None:  # an input the mode does not read: JAX's cotangent is 0
            assert not np.asarray(gj).any(), nm
            continue
        _close(x.grad, gj, GRAD_TOL, nm)


def _kernel_arithmetic(ws, spec, x, n, v, f):
    """What csrc/fused_color.cu computes from the flat weights: the first
    layer from per-input slices, relu linears, the stacked head, sigmoid."""
    a = torch.relu(f @ ws[3].t() + ws[4] + x @ ws[0].t() + n @ ws[1].t() + v @ ws[2].t())
    for i in range(spec.n_hidden - 1):
        a = torch.relu(a @ ws[5 + 2 * i].t() + ws[6 + 2 * i])
    h = a @ ws[-2].t() + ws[-1]
    return torch.sigmoid(h) if spec.squeeze_out else h


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_weight_layout_reproduces_the_module(mode):
    _, _, color, ins, _ = _setup(mode, P=50)
    spec = tfc.spec_from_config(color.cfg)
    ws = tfc.dense_weights(color, spec)
    assert [tuple(w.shape) for w in ws[:5]] == [(128, 3)] * 3 + [(128, 128), (128,)]
    assert tuple(ws[-2].shape) == (spec.rgb_width, 128)
    xs = [torch.from_numpy(a) for a in ins]
    with torch.no_grad():
        torch.testing.assert_close(_kernel_arithmetic(ws, spec, *xs),
                                   tfc.color_apply_plain(color, *xs), rtol=1e-5, atol=1e-6)
    # the slice of the input this mode does not read is a zero constant
    unused = {"no_view_dir": 2, "idr": None}[mode]
    if unused is not None:
        assert not ws[unused].requires_grad and float(ws[unused].abs().max()) == 0.0


@pytest.mark.parametrize("kw,takes", [
    (dict(mode="no_view_dir", d_in=6), True),
    (dict(mode="idr", d_in=9, extra_color=True), True),
    (dict(mode="no_normal", d_in=6), True),
    (dict(mode="idr", d_in=6), False),
    (dict(mode="no_view_dir", d_in=6, multires_view=4), False),
    (dict(mode="no_view_dir", d_in=6, d_hidden=96), False),
])
def test_spec_family_matches_jax(kw, takes):
    t = tfc.spec_from_config(tnets.ColorConfig(**kw))
    assert (t is not None) == takes == (jfc.spec_from_config(jnets.ColorConfig(**kw)) is not None)


def test_gate_takes_the_plain_module_on_the_cpu():
    color = tnets.ColorNetwork(tnets.ColorConfig(extra_color=True), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(40, k, generator=g) for k in (3, 3, 3, 256)]
    torch.testing.assert_close(tnets.color_eval(color, *xs), color(*xs), rtol=0, atol=0)
    n0 = dict(tfc.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfc.color_apply_fused(color, *xs)
    assert tfc.LAUNCHES == n0
