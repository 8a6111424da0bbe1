"""The NeuS kernels' bf16 operand mode on the CPU: each kernel's plain
version, at the net's ``cfg.dtype = "bfloat16"``, against the JAX kernel at
its default operand type (``fused_sdf._OPERAND_DTYPE = bf16``, not patched):
Pallas in interpret mode on one CPU device.

* B1: ``point_eval_ray_plain`` vs ``point_eval_fused_ray`` (outputs, every
  parameter gradient, inv_s and the ray inputs), and its forward nearer the
  JAX kernel at bf16 operands than at f32 ones (the mode takes effect);
* B3: ``point_eval_plain`` vs ``point_eval_fused``;
* B6: ``sdf_with_gradient_plain`` vs ``sdf_with_gradient_fused``;
* B7: ``color_apply_plain`` vs ``color_apply_fused``;
* #12: ``sdf_only_plain`` vs the Pallas sdf-only kernel (``_sdf_only_core``;
  ``sdf_value_fused`` itself is shadowed by the module's later definition
  and reaches B6's kernel);
* the packed, padded bf16 weight layout of the tensor-core pair and the
  ``cfg.dtype`` -> operand-mode choice.

Tolerances, relative to each tensor's largest magnitude: outputs to
OUT_TOL = 1e-3, since both sides round the same operands at the same points
and differ only where an f32 sum taken in another order lands on the other
side of a bf16 rounding boundary (about 1e-4 seen); gradients to GRAD_TOL =
2e-2, since autograd rounds each reverse product's cotangent after the dot
where the JAX kernels round it before (one bf16 rounding, 2^-9 relative, a
reverse layer, over up to six layers, and weight norm's projection of the
dense gradient magnifies it; about 1e-2 seen, about what bf16 operands move
the JAX kernel's own gradients from its f32 ones). The outputs that carry the
analytic spatial gradient (B1's normals_w, B3's grad, B6's gradient) come out
of the reverse sweep and take GRAD_TOL too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_color as jfc
from avatarclip_tpu.ops import fused_neus as jfn
from avatarclip_tpu.ops import fused_sdf as jfs
from avatarclip_tpu.render import neus as jneus
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.ops import fused_color as tfc
from avatarclip_torch.ops import fused_neus as tfn
from avatarclip_torch.ops import fused_sdf as tfs
from avatarclip_torch.ops import hold as thold
from avatarclip_torch.utils.convert import params_from_jax

OUT_TOL, GRAD_TOL = 1e-3, 2e-2
SKW = dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(3,), multires=6)
CKW = dict(d_feature=128, d_hidden=128, n_layers=1, extra_color=True)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _close(a, b, tol, name=""):
    err = _rel(a, b)
    assert err <= tol, (name, err)


@pytest.fixture
def one_device():
    """The Pallas kernels on one CPU device at their default (bf16) operands."""
    from jax.sharding import Mesh

    from avatarclip_tpu.parallel import mesh as pmesh

    assert jfs._OPERAND_DTYPE == jnp.bfloat16
    pmesh.set_default_mesh(Mesh(np.array(jax.devices()[:1]), ("data",)))
    yield
    pmesh.set_default_mesh(None)


def _neus_setup(seed=0, R=4, S=16):
    jcfgs = jneus.NetConfigs(sdf=jnets.SDFConfig(**SKW), color=jnets.ColorConfig(**CKW))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"sdf": jnets.sdf_init(k1, jcfgs.sdf), "color": jnets.color_init(k2, jcfgs.color),
              "variance": jnets.variance_init(0.3)}
    fields = params_from_jax(tree_flatten_paths(params), tnets.NeuSFields(
        tnets.SDFConfig(**SKW, dtype="bfloat16"), tnets.ColorConfig(**CKW, dtype="bfloat16"), 0.3))
    g = np.random.default_rng(seed + 5)
    rays_o = (np.array([[0.0, 0.0, -2.2]]) + 0.1 * g.normal(size=(R, 3))).astype(np.float32)
    rays_d = np.array([[0.0, 0.0, 1.0]]) + 0.05 * g.normal(size=(R, 3))
    rays_d = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32)
    z = (np.linspace(1.2, 3.2, S)[None] + 0.01 * g.uniform(size=(R, S))).astype(np.float32)
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 2.0 / S, np.float32)], -1)
    return jcfgs, params, fields, [rays_o, rays_d, z + dists * 0.5, dists]


SWEPT = ("normals_w", "grad", "gradient")  # outputs of the spatial gradient's reverse sweep


def _out_tol(name):
    return GRAD_TOL if name in SWEPT else OUT_TOL


def _hold_neus(jax_fn, plain_fn, n_out, probes, seed, names):
    """A NeuS pair's plain version against its JAX kernel, both at bf16
    operands: outputs, parameter / inv_s / ray-input gradients of
    sum(probe * out). Returns the JAX outputs at bf16 and the port's."""
    jcfgs, params, fields, arrays = _neus_setup(seed)
    cos_r = 0.3

    def jloss(p, inv_s, *xs):
        outs = jax_fn(p["sdf"], jcfgs.sdf, p["color"], jcfgs.color, *xs, inv_s, cos_r)
        used = [outs[i] for i in n_out]
        return sum((o * pr).sum() for o, pr in zip(used, probes)), used

    inv_s = jnp.exp(jnp.asarray(0.3) * 10.0)
    (_, jouts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
        {"sdf": params["sdf"], "color": params["color"]}, inv_s, *map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tinv = torch.tensor(float(inv_s), requires_grad=True)
    touts = list(plain_fn(fields.sdf, fields.color, *ins, tinv, cos_r))
    touts[-1] = tfn.eik_ratio(touts[-1])  # the eikonal partial sums as JAX's loss
    touts = [touts[i] for i in n_out]
    sum((o * torch.as_tensor(p)).sum() for o, p in zip(touts, probes)).backward()
    for nm, a, b in zip(names, touts, jouts):
        _close(a.detach().reshape(np.shape(b)), b, _out_tol(nm), nm)
    named = dict(fields.named_parameters())
    flat = tree_flatten_paths(jgrads[0])
    assert len(flat) == len(named) - 1  # all but the variance, which inv_s stands for
    for path, gj in flat.items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    _close(tinv.grad, jgrads[1], GRAD_TOL, "inv_s")
    for nm, t, gj in zip(("rays_o", "rays_d", "mid_z", "dists"), ins, jgrads[2:]):
        _close(t.grad, gj, GRAD_TOL, nm)
    return jouts, [t.detach() for t in touts]


def test_b1_plain_matches_pallas_per_ray_kernel_at_bf16(one_device, monkeypatch):
    g = np.random.default_rng(9)
    R = 4
    probes = [g.normal(size=s).astype(np.float32) for s in ((R, 6), (R, 3), (R, 1))] + [1.7]
    j16, port = _hold_neus(jfn.point_eval_fused_ray, tfn.point_eval_ray_plain, (0, 1, 2, 3), probes,
                           0, ("colorW", "normals_w", "weight_sum", "gradient_error"))
    # the mode takes effect: the forward sits nearer JAX at bf16 operands
    # than JAX at f32 operands does (a port computing in f32 would not)
    monkeypatch.setattr(jfs, "_OPERAND_DTYPE", jnp.float32)
    jcfgs, params, _, arrays = _neus_setup(0)
    j32 = jfn.point_eval_fused_ray(params["sdf"], jcfgs.sdf, params["color"], jcfgs.color,
                                   *map(jnp.asarray, arrays), jnp.exp(jnp.asarray(3.0)), 0.3)
    cat = lambda ts: np.concatenate([np.asarray(t, np.float64).reshape(-1) for t in ts])
    assert np.linalg.norm(cat(port) - cat(j16)) < 0.5 * np.linalg.norm(cat(j32) - cat(j16))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_b1_scalars_at_bf16_scatter_as_the_jax_kernel_does(one_device, seed):
    """B1's single numbers at bf16 operands, the inv_s gradient and the
    eikonal term (16 rays x 32 samples, loss sum(out^2)): each one draw of
    the rounding, widely spread against the f32 function in float64 (the
    readings behind ops/hold.BF16_SCALAR_FLOOR; printed under -s). The
    plain version draws as the JAX kernel does: each within twice the
    other's relative error plus that floor."""
    jcfgs, params, fields, arrays = _neus_setup(seed, R=16, S=32)
    cos_r = 0.3
    inv_s = jnp.exp(jnp.asarray(0.3) * 10.0)

    def jloss(p, inv, *xs):
        outs = jfn.point_eval_fused_ray(p["sdf"], jcfgs.sdf, p["color"], jcfgs.color, *xs, inv, cos_r)
        return sum(((o * o).sum() if o.ndim else o) for o in outs[:4]), outs[3]

    (_, jge), (jg,) = jax.value_and_grad(jloss, argnums=(1,), has_aux=True)(
        {"sdf": params["sdf"], "color": params["color"]}, inv_s, *map(jnp.asarray, arrays))

    def port(flds, dt):
        ins = [torch.from_numpy(a).to(dt) for a in arrays]
        inv = torch.tensor(float(inv_s), dtype=dt, requires_grad=True)
        outs = tfn.point_eval_ray_plain(flds.sdf, flds.color, *ins, inv, cos_r)
        outs = (*outs[:3], tfn.eik_ratio(outs[3]))
        loss = sum(((o * o).sum() if o.dim() else o) for o in outs[:4])
        (g,) = torch.autograd.grad(loss, [inv])
        return float(outs[3].detach()), float(g)

    pge, pg = port(fields, torch.float32)
    rge, rg = port(thold.f32_copy(fields).double(), torch.float64)
    floor = thold.BF16_SCALAR_FLOOR
    for name, j, p, r in (("inv_s gradient", float(jg), pg, rg), ("eikonal", float(jge), pge, rge)):
        ej, ep = abs(j - r) / abs(r), abs(p - r) / abs(r)
        print(f"seed {seed} {name}: relative error JAX {ej:.2e}, plain {ep:.2e}")
        assert ep <= 2 * ej + floor and ej <= 2 * ep + floor, (name, ej, ep)


def test_b3_plain_matches_pallas_point_kernel_at_bf16(one_device):
    g = np.random.default_rng(11)
    P = 4 * 16
    probes = [g.normal(size=s).astype(np.float32) for s in ((P, 1), (P, 3), (P, 6), (P,), (P,))]
    probes.append(np.float32(1.3))
    _hold_neus(jfn.point_eval_fused, tfn.point_eval_plain, (0, 1, 2, 3, 4, 6), probes, 3,
               ("sdf", "grad", "rgb", "alpha", "cdf", "gradient_error"))


@pytest.fixture(scope="module")
def sdf_nets():
    cfg = jnets.SDFConfig(**SKW)
    params = jnets.sdf_init(jax.random.PRNGKey(3), cfg)
    leaves, tree = jax.tree_util.tree_flatten(params)
    g = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(
        tree, [x + 0.05 * g.normal(size=x.shape).astype(np.float32) for x in leaves])
    sdf = params_from_jax(tree_flatten_paths(params),
                          tnets.SDFNetwork(tnets.SDFConfig(**SKW, dtype="bfloat16")))
    pts = (0.6 * g.normal(size=(200, 3))).astype(np.float32)
    cots = [g.normal(size=s).astype(np.float32) for s in ((200, 1), (200, 128), (200, 3))]
    return cfg, params, sdf, pts, cots


def test_b6_plain_matches_pallas_sdf_pair_at_bf16(sdf_nets):
    cfg, params, sdf, pts, cots = sdf_nets

    def jloss(p, x):
        outs = jfs.sdf_with_gradient_fused(p, cfg, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    touts = tfs.sdf_with_gradient_plain(sdf, x)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots)).backward()
    for nm, a, b in zip(("sdf", "feature", "gradient"), touts, jouts):
        _close(a.detach(), b, _out_tol(nm), nm)
    named = dict(sdf.named_parameters())
    for path, gj in tree_flatten_paths(jgp).items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    _close(x.grad, jgx, GRAD_TOL, "points")


@pytest.mark.parametrize("mode", ["no_view_dir", "idr"])
def test_b7_plain_matches_pallas_colour_pair_at_bf16(mode):
    kw = dict(d_feature=128, d_hidden=128, n_layers=2, mode=mode,
              d_in=9 if mode == "idr" else 6, extra_color=mode == "no_view_dir")
    cfg = jnets.ColorConfig(**kw)
    params = jnets.color_init(jax.random.PRNGKey(4), cfg)
    color = params_from_jax(tree_flatten_paths(params),
                            tnets.ColorNetwork(tnets.ColorConfig(**kw, dtype="bfloat16")))
    g = np.random.default_rng(1)
    P = 200
    n = g.normal(size=(P, 3))
    ins = [g.uniform(-1, 1, (P, 3)), n / np.linalg.norm(n, axis=-1, keepdims=True),
           g.normal(size=(P, 3)), g.normal(size=(P, 128))]
    ins = [a.astype(np.float32) for a in ins]
    cot = g.normal(size=(P, 6 if kw["extra_color"] else 3)).astype(np.float32)

    def jloss(p, *xs):
        out = jfc.color_apply_fused(p, cfg, *xs)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        params, *map(jnp.asarray, ins))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    out = tfc.color_apply_plain(color, *xs)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout, OUT_TOL, "rgb")
    named = dict(color.named_parameters())
    for path, gj in tree_flatten_paths(jgrads[0]).items():
        _close(named[path.replace("/", ".")].grad, gj, GRAD_TOL, path)
    for nm, x, gj in zip(("points", "normals", "view_dirs", "features"), xs, jgrads[1:]):
        if x.grad is None:  # an input the mode does not read
            assert not np.asarray(gj).any(), nm
            continue
        _close(x.grad, gj, GRAD_TOL, nm)


def test_sdf_only_plain_matches_pallas_kernel_at_bf16(sdf_nets):
    cfg, params, sdf, pts, _ = sdf_nets
    spec = jfs.spec_from_config(cfg)
    pad = (-len(pts)) % jfs._sdf_only_block()
    xp = jnp.concatenate([jnp.asarray(pts), jnp.zeros((pad, 3), jnp.float32)])
    want = jfs._sdf_only_core(jfs.dense_weights(params, spec), xp, spec)[:len(pts)]
    got = tfs.sdf_only_plain(sdf, torch.from_numpy(pts))
    _close(got.detach(), want, OUT_TOL, "sdf")
    # its VJP (the sdf-only Function's backward) against JAX's custom VJP
    cot = np.random.default_rng(2).normal(size=(len(pts), 1)).astype(np.float32)
    cotp = jnp.concatenate([jnp.asarray(cot), jnp.zeros((pad, 1), jnp.float32)])
    jg = jax.grad(lambda w, x: jnp.sum(jfs._sdf_only_core(w, x, spec) * cotp), argnums=1)(
        jfs.dense_weights(params, spec), xp)[:len(pts)]
    x = torch.from_numpy(pts).requires_grad_(True)
    (tfs.sdf_only_plain(sdf, x) * torch.from_numpy(cot)).sum().backward()
    _close(x.grad, jg, GRAD_TOL, "points")


@pytest.mark.parametrize("K,N", [(39, 256), (256, 217), (217, 256), (262, 256), (256, 6),
                                 (256, 39), (89, 128), (134, 128)])
def test_packed_weight_layout(K, N):
    """pack_b: wgmma's K-major shared-memory layout without swizzle,
    zero-padded to 16 x 8 tiles, in passes of TC_PASS n-tiles cut into
    warpgroup slices of TC_SLICE: within the slice that starts at n-tile
    n0 (nw wide), n-tile n0 + j of k-step kt has its core matrix kh (k 0-7
    or 8-15) at (n0 KT + kt nw + j) 128 + 64 kh, holding B[16 kt + 8 kh +
    kk][8 n + g] at row g, column kk: 128 bytes a core matrix."""
    b = torch.randn(K, N, generator=torch.Generator().manual_seed(K * N))
    packed = tfn.pack_b(b)
    KT, NT = -(-K // 16), -(-N // 8)
    assert packed.dtype == torch.bfloat16 and packed.numel() == KT * 16 * NT * 8
    torch.testing.assert_close(tfn.unpack_b(packed, K, N), b.bfloat16().float(), rtol=0, atol=0)
    padded = torch.zeros(KT * 16, NT * 8)
    padded[:K, :N] = b.bfloat16().float()
    for kt, n, kh in ((0, 0, 0), (KT - 1, NT - 1, 1), (KT // 2, NT // 3, 1)):
        n0 = n // tfn.TC_SLICE * tfn.TC_SLICE
        nw = min(tfn.TC_SLICE, NT - n0, tfn.TC_PASS - n0 % tfn.TC_PASS)
        at = (n0 * KT + kt * nw + n - n0) * 128 + kh * 64
        core = packed[at:at + 64].float().reshape(8, 8)
        want = padded[16 * kt + 8 * kh:16 * kt + 8 * kh + 8, 8 * n:8 * n + 8].t()
        torch.testing.assert_close(core, want, rtol=0, atol=0)


@pytest.mark.parametrize("width", [256, 128])
def test_pack_tc_holds_every_matrix_of_the_pair(width):
    """pack_tc: each SDF and colour matrix in its forward (W^T) and reverse
    (W) forms at its offset, the head's feature rows scaled by 1/sqrt(2)."""
    if width == 256:
        skw = dict(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6)
        ckw = dict(d_feature=256, d_hidden=256, n_layers=2, extra_color=True)
    else:
        skw, ckw = SKW, CKW
    fields = tnets.NeuSFields(tnets.SDFConfig(**skw, dtype="bfloat16"),
                              tnets.ColorConfig(**ckw, dtype="bfloat16"), 0.3,
                              torch.Generator().manual_seed(0))
    spec = tfn.spec_from_configs(fields.sdf.cfg, fields.color.cfg, 64)
    weights = tfn.dense_weights(fields.sdf, fields.color)
    pk, pack = tfn.pack_tc(spec, weights)
    NH, NHC = spec.n_hidden, spec.c_layers
    mats = [w.detach() for w in weights[0::2]]
    head = mats[NH + 1][1:] / 2.0 ** 0.5
    want = {tfn._FHEAD: head.t(), tfn._RHEAD: head}
    for i in range(NH + 1):
        want[tfn._FS + i], want[tfn._RS + i] = mats[i].t(), mats[i]
    for l in range(NHC + 1):
        want[tfn._FC + l], want[tfn._RC + l] = mats[NH + 2 + l].t(), mats[NH + 2 + l]
    assert len(want) == 6 + 2 * (NH + NHC)
    for slot, b in want.items():
        K, N = b.shape
        n = -(-K // 16) * 16 * -(-N // 8) * 8
        off = pack.off[slot] * 4
        torch.testing.assert_close(tfn.unpack_b(pk[off:off + n], K, N), b.bfloat16().float(),
                                   rtol=0, atol=0)
    # the colour head stacks the main and extra heads: 6 output columns
    assert want[tfn._FC + NHC].shape == (ckw["d_hidden"], 6)


def test_operand_mode_follows_cfg_dtype():
    """bfloat16 (every conf's default) -> bf16 operands; float32 -> f32; the
    kernels' specs and Dims carry it."""
    for dtype, bf16 in (("bfloat16", True), ("float32", False)):
        s_cfg = tnets.SDFConfig(**SKW, dtype=dtype)
        c_cfg = tnets.ColorConfig(**CKW, dtype=dtype)
        assert tnets.operand_bf16(s_cfg) is bf16 and tnets.operand_bf16(c_cfg) is bf16
        spec = tfn.spec_from_configs(s_cfg, c_cfg, 64)
        assert spec.bf16 is bf16 and spec.dims().bf16 == int(bf16)
        assert tfs.spec_from_config(s_cfg).dims().bf16 == int(bf16)
        assert tfc.spec_from_config(c_cfg).dims().bf16 == int(bf16)


def test_plain_versions_round_only_in_bf16_mode():
    """At f32 the plain versions are the module's f32 maths; at bf16 they
    round the dot operands (and so differ at bf16 level), while an f32 copy
    of the bf16 net (ops/hold.f32_copy, the reference of the card's bf16
    holds) gives back the f32 function."""
    g = torch.Generator().manual_seed(1)
    sdf16 = tnets.SDFNetwork(tnets.SDFConfig(**SKW, dtype="bfloat16"), g)
    sdf32 = tnets.SDFNetwork(tnets.SDFConfig(**SKW))
    sdf32.load_state_dict(sdf16.state_dict())
    pts = 0.6 * torch.randn(300, 3, generator=g)
    with torch.no_grad():
        ref = sdf32(pts)
        f32 = torch.cat(tfs.sdf_with_gradient_plain(sdf32, pts)[:2], -1)
        off = torch.cat(tfs.sdf_with_gradient_plain(thold.f32_copy(sdf16), pts)[:2], -1)
        b16 = torch.cat(tfs.sdf_with_gradient_plain(sdf16, pts)[:2], -1)
    torch.testing.assert_close(f32, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(off, ref, rtol=1e-5, atol=1e-5)
    assert 1e-4 < _rel(b16, ref) < 2e-2
