"""Data-parallel training in the port (avatarclip_torch/parallel/) against
one rank and against the JAX package, on 2 gloo ranks spawned on the CPU
with one intra-op thread each.

* ``pad_to_multiple`` equals JAX's ``parallel/mesh.pad_to_multiple`` for
  mesh sizes 1, 2, 4 and granules 1, 8 (JAX given an object with ``.size``).
* The gather's backward (this rank's slice of the cotangent), the psum and
  the replicated term give the 1-rank gradient of a loss every rank
  computes: to 1e-6 of its largest magnitude (f32 sums in another order).
* ``neus.render(mesh=)`` at 13 rays (padded to 16 on 2 ranks), with
  jitter, up-sampling and a per-ray background, on its plain, per-ray and
  point-level paths, against one rank: outputs to 1e-6 of each tensor's
  largest magnitude (each ray's numbers are the same), gradients at JAX's
  tolerance (rtol 1e-4, atol 1e-5: the sums split over the ranks).
* The dry run's checks at JAX's tolerances (avatarclip_torch/parallel/
  dryrun.py: one train_clip and one photometric step at ``scale="tiny"``,
  gradients before Adam rtol 1e-4 atol 1e-5, parameters after it rtol 1e-4
  atol 1e-5, metrics rtol 1e-3 atol 1e-5; the ranks' parameters equal to
  the bit), and its kernel-path check's gradients (4x256 / 2x256, R = 16, 8
  samples, per_ray False and True) at N = 2 against N = 1 (rtol 1e-4, atol
  1e-5) and against ``jax.grad`` of JAX's ``make_loss`` on one CPU device
  (JAX's kernels in interpret mode with f32 operands, as
  tests/test_torch_point_path.py runs them) to 1e-3 of each gradient's
  largest magnitude (the frameworks sum in other orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.ops import fused_sdf
from avatarclip_tpu.parallel import mesh as jmesh
from avatarclip_tpu.render import neus as jneus
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.fields import networks as tnets
from avatarclip_torch.parallel import dryrun
from avatarclip_torch.parallel import mesh as pmesh
from avatarclip_torch.utils.convert import params_from_jax

JAX_GRAD_TOL = 1e-3  # relative to each gradient's largest magnitude
RANKS = 2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _ranks(fn, **kw):
    return dryrun.run_ranks(RANKS, fn, kw, device="cpu", backend="gloo", threads=1)


class _Size:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("granule", [1, 8])
def test_pad_to_multiple_matches_jax(size, granule):
    for n in range(0, 130):
        assert pmesh.pad_to_multiple(n, _Size(size), granule) == jmesh.pad_to_multiple(
            n, _Size(size), granule)


PATHS = ("plain", "ray", "point")


@pytest.fixture(scope="module")
def small():
    """The gather check and the sharded renders (13 rays) on 2 ranks, in one
    spawn, and on one rank."""
    g = np.random.default_rng(0)
    kw = {"x": g.normal(size=(12, 5)).astype(np.float32),
          "w": (0.3 * g.normal(size=(5, 4))).astype(np.float32), "n_rays": 13, "paths": PATHS}
    return _ranks(workers.small_checks, **kw), workers.small_checks(pmesh.single("cpu"), **kw)


def test_gather_backward_gives_the_one_rank_gradient(small):
    got, want = [r["gather"] for r in small[0]], small[1]["gather"]
    for r in got:
        assert _rel(r["full"], want["full"]) <= 1e-6
        assert abs(r["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert _rel(r["grad"], want["grad"]) <= 1e-6
    assert torch.equal(got[0]["grad"], got[1]["grad"])


@pytest.mark.parametrize("path", PATHS)
def test_sharded_render_pads_and_matches_one_rank(small, path):
    got, want = [r["render"][path] for r in small[0]], small[1]["render"][path]
    for r in got:
        for k, v in want["outs"].items():
            assert r["outs"][k].shape == v.shape, k
            assert _rel(r["outs"][k], v) <= 1e-6, k
        for a, b in zip(r["grads"], want["grads"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=dryrun.GRAD_RTOL,
                                       atol=dryrun.GRAD_ATOL)
    for a, b in zip(got[0]["grads"], got[1]["grads"]):
        assert torch.equal(a, b)


def _jax_problem():
    """JAX's kernel-path check's params and the port's fields made from them."""
    sdf_cfg = jnets.SDFConfig(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6)
    col_cfg = jnets.ColorConfig(d_feature=256, d_hidden=256, n_layers=2, mode="no_view_dir",
                                extra_color=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"sdf": jnets.sdf_init(k1, sdf_cfg), "color": jnets.color_init(k2, col_cfg),
              "variance": jnets.variance_init(0.3)}
    t_sdf, t_col, _ = dryrun.kernel_path_problem("float32")
    fields = params_from_jax(tree_flatten_paths(params), tnets.NeuSFields(t_sdf, t_col, 0.3))
    return (sdf_cfg, col_cfg), params, (t_sdf, t_col, fields.state_dict(), 16, 8)


def _jax_grads(jcfgs, params, monkeypatch):
    """jax.grad of JAX's make_loss (parallel/dryrun.py:217-230) for per_ray
    False and True on one CPU device, the kernels in interpret mode with f32
    operands."""
    sdf_cfg, col_cfg = jcfgs
    cfgs = jneus.NetConfigs(sdf=sdf_cfg, color=col_cfg)
    ncfg = jneus.NeuSConfig(n_samples=8, n_importance=0, up_sample_steps=0, perturb=0.0,
                            extra_color=True)
    R = 16
    rays_o = jnp.tile(jnp.array([[0.0, 0.0, -2.0]]), (R, 1))
    t = jnp.linspace(-0.2, 0.2, R)
    rays_d = jnp.stack([t, jnp.zeros(R), jnp.ones(R)], axis=-1)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    z_vals = jnp.linspace(1.0, 3.0, ncfg.n_samples)[None, :].repeat(R, 0)

    def make_loss(per_ray):
        def loss(p):
            out = jneus.render_core(p, ncfg, cfgs, rays_o, rays_d, z_vals,
                                    sample_dist=2.0 / ncfg.n_samples, cos_anneal_ratio=0.5,
                                    per_ray=per_ray)
            return jnp.sum(out["color"]) + jnp.sum(out["extra_color"]) + out["gradient_error"]

        return loss

    monkeypatch.setattr(fused_sdf, "_OPERAND_DTYPE", jnp.float32)
    monkeypatch.setattr(jneus, "_FORCE_MEGA", True)
    jmesh.set_default_mesh(Mesh(np.array(jax.devices()[:1]), ("data",)))
    try:
        return {pr: tree_flatten_paths(jax.jit(jax.grad(make_loss(pr)))(params))
                for pr in (False, True)}
    finally:
        jmesh.set_default_mesh(None)


@pytest.fixture(scope="module")
def dry():
    """The dry run's rank results at N = 2 and at N = 1 (tiny train steps and
    the kernel path on JAX's nets), and JAX's kernel-path gradients."""
    jcfgs, params, problem = _jax_problem()
    res_n = _ranks(dryrun._rank_checks, scale="tiny", res=64, problems=[problem])
    one = pmesh.single("cpu")
    res_1 = {"train": dryrun.train_steps(one, "tiny"),
             "kernel": dryrun.kernel_path_grads(one, [problem])}
    with pytest.MonkeyPatch.context() as mp:
        jgrads = _jax_grads(jcfgs, params, mp)
    names = [n for n, _ in tnets.NeuSFields(problem[0], problem[1], 0.3).named_parameters()]
    return {"n": res_n, "1": res_1, "problem": problem, "jax": jgrads, "names": names}


@pytest.mark.parametrize("key,rtol,atol", [
    ("grads_clip", dryrun.GRAD_RTOL, dryrun.GRAD_ATOL),
    ("grads_photo", dryrun.GRAD_RTOL, dryrun.GRAD_ATOL),
    ("params_clip", dryrun.PARAM_RTOL, dryrun.PARAM_ATOL),
    ("params", dryrun.PARAM_RTOL, dryrun.PARAM_ATOL)])
def test_train_steps_two_ranks_match_one(dry, key, rtol, atol):
    got, want = dry["n"][0]["train"][key], dry["1"]["train"][key]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    if key.startswith("grads"):  # the step moved something
        assert any(float(b.abs().max()) > 0 for b in want)


def test_train_metrics_and_replicas(dry):
    trains = [r["train"] for r in dry["n"]]
    want = dry["1"]["train"]["metrics"]
    for k, v in trains[0]["metrics"].items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(v, want[k], rtol=dryrun.METRIC_RTOL, atol=dryrun.METRIC_ATOL)
    for key in ("params_clip", "params"):
        for a, b in zip(trains[0][key], trains[1][key]):
            assert torch.equal(a, b)
    # the report's own checks pass on the same results
    dryrun.check_train(dry["n"], dry["1"]["train"])


@pytest.mark.parametrize("per_ray", [False, True])
def test_kernel_path_two_ranks_match_one(dry, per_ray):
    got = [r["kernel"][0][per_ray]["grads"] for r in dry["n"]]
    want = dry["1"]["kernel"][0][per_ray]["grads"]
    for a, b in zip(got[0], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=dryrun.GRAD_RTOL,
                                   atol=dryrun.GRAD_ATOL)
    for a, b in zip(got[0], got[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_ray", [False, True])
def test_kernel_path_matches_jax_grad(dry, per_ray):
    got = dict(zip(dry["names"], dry["n"][0]["kernel"][0][per_ray]["grads"]))
    jg = dry["jax"][per_ray]
    assert len(jg) == len(got)
    for path, g in jg.items():
        name = "variance.variance" if path == "variance" else path.replace("/", ".")
        assert _rel(got[name], g) <= JAX_GRAD_TOL, (path, _rel(got[name], g))
