"""Rank functions of tests/test_torch_parallel.py, in a module of their own
so that the spawned ranks import neither JAX nor the test module: each
runs on a DataMesh (one rank in the test's process, or N gloo ranks through
``avatarclip_torch.parallel.dryrun.run_ranks``) and returns CPU tensors."""

from __future__ import annotations

import numpy as np
import torch

from avatarclip_torch.parallel import mesh as pmesh


def gather_loss_grad(mesh, x: np.ndarray, w: np.ndarray) -> dict:
    """A loss that every rank computes the same way from the gathered rows
    of tanh(x_shard w), a psum of their column sums and a function of w
    alone; w's gradient summed over the ranks."""
    wt = torch.tensor(w, requires_grad=True)
    y = torch.tanh(pmesh.shard(torch.tensor(x), mesh) @ wt)
    full = pmesh.gather(y, mesh)
    col = pmesh.sum_over_ranks(y.sum(0), mesh)
    loss = (full ** 2).sum() * full.mean() + (col ** 3).sum() + pmesh.replicated(wt.norm(), mesh) ** 2
    loss.backward()
    pmesh.all_reduce_grads([wt], mesh)
    return {"loss": float(loss.detach()), "grad": wt.grad.clone(), "full": full.detach()}


def tiny_fields(seed: int = 0):
    from avatarclip_torch.fields import networks as nets

    return nets.NeuSFields(nets.SDFConfig(d_out=17, d_hidden=16, n_layers=2, skip_in=(2,),
                                          multires=2),
                           nets.ColorConfig(d_feature=16, d_hidden=16, n_layers=2, extra_color=True),
                           0.3, torch.Generator().manual_seed(seed))


def sharded_render(mesh, n_rays: int, path: str, seed: int = 0) -> dict:
    """``neus.render`` of n_rays rays (a count that pads on 2 ranks) with
    jitter, up-sampling, a per-ray background and the tiny nets, split over
    the mesh, on the render's ``path``: "plain" (the per-sample branch),
    "ray" (the per-ray megakernel's plain version) or "point" (the
    point-level pair's and the compositing's plain versions). Its outputs
    and the parameters' gradients of a loss of the per-ray outputs and the
    eikonal term (and, with per-sample outputs, the weighted gradients),
    summed over the ranks."""
    from avatarclip_torch.render import cameras, neus

    per_ray = path == "ray"
    neus._FORCE_MEGA = None if path == "plain" else True
    fields = tiny_fields(seed)
    g = np.random.default_rng(seed)
    rays_o = torch.tensor(np.array([[0.0, 0.0, -2.2]]) + 0.1 * g.normal(size=(n_rays, 3)),
                          dtype=torch.float32)
    rays_d = torch.tensor(np.array([[0.0, 0.0, 1.0]]) + 0.2 * g.normal(size=(n_rays, 3)),
                          dtype=torch.float32)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    bg = torch.tensor(g.uniform(size=(n_rays, 1)), dtype=torch.float32)
    near, far = cameras.near_far_from_sphere(rays_o, rays_d)
    cfg = neus.NeuSConfig(n_samples=8, n_importance=8, up_sample_steps=2, perturb=1.0,
                          extra_color=True)
    out = neus.render(fields, cfg, rays_o, rays_d, near, far,
                      generator=torch.Generator().manual_seed(seed + 1), background_rgb=bg,
                      cos_anneal_ratio=0.3, per_ray=per_ray, mesh=mesh)
    neus._FORCE_MEGA = None
    keys = ["color_fine", "extra_color_fine", "weight_sum", "s_val"]
    if not per_ray:
        keys += ["weights", "gradients", "mid_z_vals", "cdf_fine", "inside_sphere"]
    loss = out["gradient_error"] + sum((out[k] * (i + 1.0)).sum() for i, k in enumerate(keys[:4]))
    if not per_ray:
        loss = loss + (out["gradients"] * out["weights"][..., None]).sum()
    loss.backward()
    pmesh.all_reduce_grads(fields.parameters(), mesh)
    return {"outs": {k: out[k].detach().clone() for k in keys + ["gradient_error"]},
            "grads": [p.grad.clone() for p in fields.parameters()]}


def small_checks(mesh, x: np.ndarray, w: np.ndarray, n_rays: int, paths) -> dict:
    """gather_loss_grad, then sharded_render on each path: one spawn for
    the small checks."""
    return {"gather": gather_loss_grad(mesh, x, w),
            "render": {p: sharded_render(mesh, n_rays, p) for p in paths}}
