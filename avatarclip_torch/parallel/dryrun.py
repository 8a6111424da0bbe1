"""1-vs-N dry run of data-parallel training (twin of avatarclip_tpu/parallel/dryrun.py).

    python -m avatarclip_torch.parallel.dryrun N [--device cuda|cpu] [--backend nccl|gloo]
        [--scale tiny|small|full] [--res PX] [--rays R] [--samples S]
        [--dtypes float32 [bfloat16]]

spawns N ranks (processes on this host, joined by torch.distributed over
localhost: NCCL with a card a rank, gloo on the CPU or for ranks sharing a
card; the default device is the card) and runs in each of them, and at N = 1
in this process, from the same seeded parameters, optimizer state and
generators:

  (a) one ``train_clip`` step, then one photometric step, of
      ``synthetic.make_runner(scale)`` (JAX's dryrun.py:137-164), then
      ``--timed-steps`` more train_clip steps for their times;
  (b) the kernel-path check (JAX's ``_kernel_path_1_vs_n``,
      dryrun.py:177-250): the parameters' gradient of sum(color) +
      sum(extra_color) + gradient_error through ``render_core(per_ray=False)``
      and ``per_ray=True`` under ``neus._FORCE_MEGA = True`` at 4x256 / 2x256
      with the extra head, R rays of S samples (JAX's 16 x 8 by default), in
      each operand mode of ``--dtypes``. On the card the first is the
      point-level pair (B3) and the compositing pair (B4), forward and
      backward; the second B1's pair.

Checks (any failure raises): every metric finite; the ranks' parameters
and gradients equal to the bit; N against 1: (a)'s summed gradients before
each Adam update within JAX's gradient tolerance (rtol 1e-4, atol 1e-5,
elementwise), its parameters after the updates within JAX's (rtol 1e-4,
atol 1e-5) and its metrics within JAX's (rtol 1e-3, atol 1e-5). (b) in f32:
N against 1 at JAX's rtol 1e-4 with the atol 1e-5 of max(1, each
gradient's largest magnitude), and N and 1 each within F64_TOL (1e-3) of
each gradient's largest magnitude of the f32 function in float64; in bf16,
N and 1 each held by ``ops/hold.bf16_within`` against the f32 function in
float64 beside the plain bf16 version (the weight-gradient sums split
differently over the ranks; neither is the other's oracle).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import mesh as pmesh
from ..utils import trace

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # JAX's dryrun.py:248
F64_TOL = 1e-3  # f32 kernel gradients against f64: of each gradient's largest magnitude
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5  # JAX's dryrun.py:164
METRIC_RTOL, METRIC_ATOL = 1e-3, 1e-5  # JAX's dryrun.py:163
RANKS_TIMEOUT_S = 900.0  # run_ranks stops every rank after this long


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, fn, kwargs, device, backend, threads, out_dir):
    """One rank: join the group, run ``fn(mesh, **kwargs)`` with the launch
    counts from 0, save its result (and this rank's launches) for the
    parent; a failure saves its traceback and exits non-zero."""
    mesh = None
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = pmesh.init(n, rank, device, backend, init_method=f"tcp://127.0.0.1:{port}")
        trace.reset_counters()
        res = fn(mesh, **kwargs)
        res["launches"] = trace.launches()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if mesh is not None:
            pmesh.close(mesh)


def run_ranks(n: int, fn, kwargs: dict, device=None, backend: str | None = None,
              threads: int | None = None) -> list[dict]:
    """Run ``fn(mesh, **kwargs)`` (a module-level function; its result a
    dict of picklable values, CPU tensors) on n spawned ranks; their
    results in rank order, each with its rank's kernel launch counts. A
    rank that fails, or the time limit, stops every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main, args=(r, n, port, fn, kwargs, device, backend,
                                                      threads, out_dir)) for r in range(n)]
        for p in procs:
            p.start()
        t0 = time.monotonic()
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad or time.monotonic() - t0 > RANKS_TIMEOUT_S:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errs.append(f"rank {r}:\n{f.read()[-4000:]}")
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if errs:
            raise RuntimeError(f"{n} ranks of {getattr(fn, '__name__', fn)} failed "
                               f"({time.monotonic() - t0:.1f} s):\n" + "\n".join(errs))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


# ---------------------------------------------------------------------------
# (a): the train steps
# ---------------------------------------------------------------------------


def _grads(params) -> list[torch.Tensor]:
    return [p.grad.detach().cpu().clone() for p in params]


def _params(params) -> list[torch.Tensor]:
    return [p.detach().cpu().clone() for p in params]


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_steps(mesh: pmesh.DataMesh, scale: str = "tiny", res: int = 64,
                timed_steps: int = 2) -> dict:
    """One train_clip step (iteration 0) and one photometric step (iteration
    1) of ``synthetic.make_runner(scale)`` on ``mesh``: the metrics, the
    summed gradients before each Adam update, the parameters after each,
    the train_clip step's rays; then ``timed_steps`` more train_clip steps'
    synchronised seconds."""
    from ..pipelines import synthetic

    with tempfile.TemporaryDirectory() as d:
        runner = synthetic.make_runner(d, scale, res=res, mesh=mesh)
        runner.init_clip()
        runner.init_smpl()
        params = list(runner.fields.parameters())
        cam, S = runner.sample_iteration_camera(0)
        t0 = _sync(mesh.device)
        loss, m_clip = runner.clip_loss(S, cam, runner.draw_clip(S), 0)
        runner._backward(loss)
        g_clip = _grads(params)
        runner._step()
        t1 = _sync(mesh.device)
        p_clip = _params(params)
        loss, m_photo = runner.photometric_loss(runner.draw_photometric(), 1)
        runner._backward(loss)
        g_photo = _grads(params)
        runner._step()
        t2 = _sync(mesh.device)
        seconds = []
        for it in range(2, 2 + timed_steps):
            cam_i, S_i = runner.sample_iteration_camera(it)
            t = _sync(mesh.device)
            runner._clip_update(S_i, cam_i, it)
            seconds.append(_sync(mesh.device) - t)
        metrics = {k: float(v) for k, v in m_clip.items()}
        metrics.update({f"photo_{k}": float(v) for k, v in m_photo.items()})
        rays = min(runner.tc.max_ray_num, S * S) if runner.tc.use_silhouettes else S * S
        return {"metrics": metrics, "grads_clip": g_clip, "grads_photo": g_photo,
                "params_clip": p_clip, "params": _params(params),
                "names": [n for n, _ in runner.fields.named_parameters()],
                "sil_res": S, "rays": min((rays + 7) // 8 * 8, S * S),
                "batch": runner.tc.batch_size, "first_seconds": (t1 - t0, t2 - t1),
                "step_seconds": seconds}


# ---------------------------------------------------------------------------
# (b): the kernel path
# ---------------------------------------------------------------------------


def kernel_path_problem(dtype: str = "float32", seed: int = 0):
    """JAX's check's nets (4x256 SDF, 2x256 colour net with the extra head,
    variance 0.3) from a seeded init at operand mode ``dtype``: (sdf config,
    colour config, CPU state dict)."""
    from ..fields import networks as nets

    sdf_cfg = nets.SDFConfig(d_out=257, d_hidden=256, n_layers=4, skip_in=(4,), multires=6,
                             dtype=dtype)
    col_cfg = nets.ColorConfig(d_feature=256, d_hidden=256, n_layers=2, mode="no_view_dir",
                               extra_color=True, dtype=dtype)
    fields = nets.NeuSFields(sdf_cfg, col_cfg, 0.3, torch.Generator().manual_seed(seed))
    return sdf_cfg, col_cfg, {k: v.clone() for k, v in fields.state_dict().items()}


def kernel_path_rays(n_rays: int, n_samples: int, device):
    """JAX's check's rays: from (0, 0, -2) in a fan of x slopes in [-0.2,
    0.2] towards +z, samples evenly over z in [1, 3]: (rays_o, rays_d, z_vals)."""
    t = torch.linspace(-0.2, 0.2, n_rays)
    rays_o = torch.tensor([[0.0, 0.0, -2.0]]).repeat(n_rays, 1)
    rays_d = torch.stack([t, torch.zeros(n_rays), torch.ones(n_rays)], -1)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    z_vals = torch.linspace(1.0, 3.0, n_samples)[None].repeat(n_rays, 1)
    return rays_o.to(device), rays_d.to(device), z_vals.to(device)


def _kernel_fields(sdf_cfg, col_cfg, state, device):
    from ..fields import networks as nets

    fields = nets.NeuSFields(sdf_cfg, col_cfg, 0.3)
    fields.load_state_dict(state)
    return fields.to(device)


def kernel_path_grads(mesh: pmesh.DataMesh, problems) -> list[dict]:
    """For each problem (sdf config, colour config, state, rays, samples):
    the gradients (summed over the ranks; in ``fields.parameters()``' order)
    of sum(color) + sum(extra_color) + gradient_error through
    ``render_core`` with per_ray False and True under ``neus._FORCE_MEGA``,
    the loss, and each gradient's synchronised seconds."""
    from ..render import neus

    out = []
    prev = neus._FORCE_MEGA
    neus._FORCE_MEGA = True
    try:
        for sdf_cfg, col_cfg, state, n_rays, n_samples in problems:
            fields = _kernel_fields(sdf_cfg, col_cfg, state, mesh.device)
            params = list(fields.parameters())
            ro, rd, z = kernel_path_rays(n_rays, n_samples, mesh.device)
            ncfg = neus.NeuSConfig(n_samples=n_samples, n_importance=0, up_sample_steps=0,
                                   perturb=0.0, extra_color=True)
            res = {"dtype": sdf_cfg.dtype, "rays": n_rays, "samples": n_samples}
            for per_ray in (False, True):
                t0 = _sync(mesh.device)
                r = neus.render_core(fields, ncfg, ro, rd, z, sample_dist=2.0 / n_samples,
                                     cos_anneal_ratio=0.5, per_ray=per_ray, mesh=mesh)
                loss = r["color"].sum() + r["extra_color"].sum() + r["gradient_error"]
                fields.zero_grad(set_to_none=True)
                loss.backward()
                pmesh.all_reduce_grads(params, mesh)
                res[per_ray] = {"grads": _grads(params), "loss": float(loss.detach()),
                                "seconds": _sync(mesh.device) - t0}
            out.append(res)
    finally:
        neus._FORCE_MEGA = prev
    return out


def point_path_ray(point_fn, composite_fn):
    """render_core's ``per_ray=False`` kernel path (``point_fn``, then
    ``composite_fn``) as a function of fused_neus.point_eval_ray's contract:
    (colorW (R, 6), normals_w, weight_sum, eik [num, den])."""

    def fn(sdf, color, rays_o, rays_d, mid, dists, inv_s, cos_anneal):
        R, S = mid.shape
        _, g, rgb, alpha, _, _, ge = point_fn(sdf, color, rays_o, rays_d, mid, dists, inv_s,
                                              cos_anneal)
        w, col, extra, nw = composite_fn(alpha.reshape(R, S), rgb.reshape(R, S, -1),
                                         g.reshape(R, S, 3))
        return torch.cat([col, extra], -1), nw, w.sum(-1, keepdim=True), ge

    return fn


def kernel_path_references(problem, device, chunk: int = 1024) -> dict:
    """Of one problem's loss, per per_ray mode: the parameters' gradients of
    the plain version at the nets' operand mode and of the f32 function in
    float64 (ops/hold.f32_copy), each ``chunk`` rays at a time
    (ops/hold.ray_grads)."""
    from ..ops import fused_composite, fused_neus, hold

    sdf_cfg, col_cfg, state, n_rays, n_samples = problem
    fields = _kernel_fields(sdf_cfg, col_cfg, state, device)
    ro, rd, z = kernel_path_rays(n_rays, n_samples, device)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 2.0 / n_samples)], -1)
    inputs = [ro, rd, z + dists * 0.5, dists]
    probes = [torch.ones(n_rays, 6, device=device), torch.zeros(n_rays, 3, device=device),
              torch.zeros(n_rays, 1, device=device), torch.ones((), device=device)]
    ref64 = hold.f32_copy(fields).double()
    out = {}
    for per_ray in (False, True):
        fn = (fused_neus.point_eval_ray_plain if per_ray else
              point_path_ray(fused_neus.point_eval_plain, fused_composite.composite_plain))
        n_par = len(list(fields.parameters()))
        plain = hold.ray_grads(fn, fields, inputs, probes, 0.5, chunk)[1][:n_par]
        ref = hold.ray_grads(fn, ref64, [t.double() for t in inputs],
                             [p.double() for p in probes], 0.5, chunk)[1][:n_par]
        out[per_ray] = {"plain": [t.detach().cpu() for t in plain],
                        "ref": [t.detach().cpu() for t in ref]}
    return out


def _rank_checks(mesh: pmesh.DataMesh, scale: str | None, res: int, problems,
                 timed_steps: int = 2) -> dict:
    """A rank's share of the dry run: (a) when ``scale`` is given, then (b)."""
    out = {"train": train_steps(mesh, scale, res, timed_steps) if scale else None}
    out["kernel"] = kernel_path_grads(mesh, problems)
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _close(tag, names, got, want, rtol, atol, scaled: bool = False) -> float:
    """Elementwise |got - want| <= atol + rtol |want| for each pair (JAX's
    np.testing.assert_allclose; with ``scaled`` the atol is of max(1, the
    tensor's largest |want|)); the largest absolute difference."""
    worst = 0.0
    for nm, a, b in zip(names, got, want):
        a, b = a.double(), b.double()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag} {nm}: not finite")
        err = (a - b).abs()
        tol = atol * max(1.0, float(b.abs().max())) if scaled else atol
        if not bool((err <= tol + rtol * b.abs()).all()):
            raise AssertionError(f"{tag} {nm}: 1-vs-N divergence, max abs err "
                                 f"{float(err.max()):.3e} (rtol={rtol}, atol={atol})")
        worst = max(worst, float(err.max()))
    return worst


def _same_bits(tag, names, ranks) -> None:
    for r, other in enumerate(ranks[1:], 1):
        for nm, a, b in zip(names, ranks[0], other):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag} {nm}: rank {r}'s replica differs from rank 0's")


def check_train(res_n: list[dict], res_1: dict) -> dict:
    """(a)'s checks; a summary of the worst differences."""
    trains = [r["train"] for r in res_n]
    names = trains[0]["names"]
    for key in ("params_clip", "params"):
        _same_bits(f"train {key}", names, [t[key] for t in trains])
    tn = trains[0]
    for k, v in tn["metrics"].items():
        if not np.isfinite(v):
            raise AssertionError(f"metric {k} is not finite at N = {len(res_n)}")
    _close("metrics", list(tn["metrics"]), [torch.tensor(v) for v in tn["metrics"].values()],
           [torch.tensor(res_1["metrics"][k]) for k in tn["metrics"]], METRIC_RTOL, METRIC_ATOL)
    out = {"rays": tn["rays"], "sil_res": tn["sil_res"], "batch": tn["batch"]}
    for key in ("grads_clip", "grads_photo"):
        out[key] = _close(key, names, tn[key], res_1[key], GRAD_RTOL, GRAD_ATOL)
    for key in ("params_clip", "params"):
        out[key] = _close(key, names, tn[key], res_1[key], PARAM_RTOL, PARAM_ATOL)
    out["metrics"] = {k: (v, res_1["metrics"][k]) for k, v in tn["metrics"].items()}
    out["step_seconds"] = {"N": [t["step_seconds"] for t in trains], "1": res_1["step_seconds"]}
    out["first_seconds"] = {"N": [t["first_seconds"] for t in trains],
                            "1": res_1["first_seconds"]}
    return out


def check_kernel_path(res_n: list[dict], res_1: list[dict], problems, device) -> list[dict]:
    """(b)'s checks, per problem and per_ray mode; the worst differences.
    bf16: N and 1 each by hold.bf16_within. f32: N and 1 each within
    F64_TOL of the f32 function in f64, and N against 1 at JAX's rtol with
    its atol of max(1, each gradient's largest magnitude): over 4,096 x 64
    points the weight-normed gradients reach ~2e4 and sum in another order
    at N, and an element that cancels to ~1 differs by more than an absolute
    1e-5 (5.3e-5 measured, the tensors 3e-7 apart in relative RMS, each
    within 1e-6 of f64)."""
    from ..ops import hold

    rows = []
    for i, problem in enumerate(problems):
        kn = [r["kernel"][i] for r in res_n]
        k1 = res_1[i]
        refs = kernel_path_references(problem, device)
        names = [f"p{j}" for j in range(len(k1[False]["grads"]))]
        for per_ray in (False, True):
            tag = f"kernel path {kn[0]['dtype']} {problem[3]} x {problem[4]} per_ray={per_ray}"
            _same_bits(tag, names, [k[per_ray]["grads"] for k in kn])
            got_n, got_1 = kn[0][per_ray]["grads"], k1[per_ray]["grads"]
            row = {"dtype": kn[0]["dtype"], "per_ray": per_ray, "rays": problem[3],
                   "samples": problem[4], "seconds_N": [k[per_ray]["seconds"] for k in kn],
                   "seconds_1": k1[per_ray]["seconds"],
                   "rel_N_vs_1": max(hold.rel_rms(a, b) for a, b in zip(got_n, got_1))}
            plain, ref = refs[per_ray]["plain"], refs[per_ray]["ref"]
            if kn[0]["dtype"] == "float32":
                row["max_abs_N_vs_1"] = _close(tag, names, got_n, got_1, GRAD_RTOL, GRAD_ATOL,
                                               scaled=True)
                for label, got in (("N", got_n), ("1", got_1)):
                    rel = max(float((a.double() - r.double()).abs().max())
                              / max(float(r.abs().max()), 1e-30) for a, r in zip(got, ref))
                    if not rel <= F64_TOL:
                        raise AssertionError(f"{tag} at {label}: {rel:.3e} from f64 > {F64_TOL}")
                    row[f"rel_f64_{label}"] = rel
            else:
                worst = 0.0
                for label, got in (("N", got_n), ("1", got_1)):
                    for nm, a, p, r in zip(names, got, plain, ref):
                        ek, ep, ok = hold.bf16_within(a, p, r)
                        if not ok:
                            raise AssertionError(f"{tag} at {label} d {nm}: rel RMS {ek:.3e} > "
                                                 f"2 x plain bf16 {ep:.3e} + floor")
                        worst = max(worst, ek / max(ep, 1e-30))
                row["bf16_worst_ratio"] = worst
            rows.append(row)
    return rows


def run(n: int, device=None, backend: str | None = None, scale: str | None = "tiny",
        res: int = 64, rays: int = 16, samples: int = 8, dtypes=("float32",),
        threads: int | None = None, timed_steps: int = 2) -> dict:
    """The dry run: (a) (when ``scale``) and (b) on n spawned ranks and at
    N = 1 in this process, held as the module docstring says. Returns the
    report: the ranks' and the reference's launches, the worst differences
    and the times."""
    dev = pmesh.single(device).device
    problems = [kernel_path_problem(dt) + (rays, samples) for dt in dtypes]
    res_n = run_ranks(n, _rank_checks, {"scale": scale, "res": res, "problems": problems,
                                        "timed_steps": timed_steps}, device, backend, threads)
    before = trace.launches()
    one = pmesh.single(dev)
    res_1 = {"train": train_steps(one, scale, res, timed_steps) if scale else None,
             "kernel": kernel_path_grads(one, problems)}
    after = trace.launches()
    report = {"ranks": n, "backend": backend, "device": str(dev),
              "launches_ranks": [r["launches"] for r in res_n],
              "launches_1": {k: after[k] - before[k] for k in after}}
    report["launches_ranks_sum"] = {k: sum(r[k] for r in report["launches_ranks"])
                                    for k in report["launches_1"]}
    if scale:
        report["train"] = check_train(res_n, res_1["train"])
    report["kernel"] = check_kernel_path(res_n, res_1["kernel"], problems, dev)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="nccl on the card (a card a rank), gloo on the CPU or to share cards")
    ap.add_argument("--scale", default="tiny", choices=("tiny", "small", "full", "none"))
    ap.add_argument("--res", type=int, default=64, help="the synthetic views' pixels")
    ap.add_argument("--rays", type=int, default=16)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--dtypes", nargs="+", default=["float32"], choices=("float32", "bfloat16"))
    ap.add_argument("--threads", type=int, default=None, help="intra-op threads a rank")
    ap.add_argument("--timed-steps", type=int, default=2,
                    help="train_clip steps timed after the checked ones")
    a = ap.parse_args(argv)
    report = run(a.n, a.device, a.backend, None if a.scale == "none" else a.scale, a.res,
                 a.rays, a.samples, tuple(a.dtypes), a.threads, a.timed_steps)
    train = report.get("train")
    if train:
        med = lambda xs: float(np.median(xs)) if len(xs) else float("nan")
        print(f"(a) {a.scale}: train_clip ({train['rays']} rays at {train['sil_res']}^2) and "
              f"photometric ({train['batch']} rays) steps at N = {a.n} and 1: replicas equal; "
              f"max abs diff grads {train['grads_clip']:.3e} / {train['grads_photo']:.3e}, "
              f"params {train['params']:.3e}; {a.timed_steps} more train_clip steps, median s: "
              f"N {[round(med(x), 4) for x in train['step_seconds']['N']]}, "
              f"1 {med(train['step_seconds']['1']):.4f}")
    for row in report["kernel"]:
        extra = (f"max abs diff {row['max_abs_N_vs_1']:.3e}, from f64 {row['rel_f64_N']:.2e} "
                 f"(N) / {row['rel_f64_1']:.2e} (1) of the largest"
                 if "max_abs_N_vs_1" in row else
                 f"bf16 holds, worst {row['bf16_worst_ratio']:.2f}x the plain version's")
        print(f"(b) {row['dtype']} {row['rays']} x {row['samples']} per_ray={row['per_ray']}: "
              f"rel RMS N vs 1 {row['rel_N_vs_1']:.3e}; {extra}; gradient s N "
              f"{[round(x, 4) for x in row['seconds_N']]}, 1 {row['seconds_1']:.4f}")
    print(f"kernel launches on the ranks: "
          f"{ {k: v for k, v in report['launches_ranks_sum'].items() if v} }")
    print(f"dryrun_multichip({a.n}): OK on {report['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
