"""The pose cell's driver: AvatarAnimate's PoseOptimizer.

Set-up makes the inputs from the seed (the body as an SMPL file, CLIP's
weights on the card, the text's token ids), builds the program's
AnimateContext and PoseOptimizer on them (the optimizer's generator seeded
from the seed) and the text feature. The checked steps, the warm-up and
the window run the body of ``get_pose``'s loop: ``step`` on the pose with
``draw_step``'s elevations, then ``_clock``; a fresh pose (``draw_init``)
and Adam start every ``num_iteration`` steps, as ``get_pose`` starts them.

The check's leaves are the pose's 21 joints, 3 angles each, so that a
gradient given to the wrong joint moves a leaf's norm.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
import time

import torch

from benchmark.counts import peaks, soft, vit
from benchmark.harness import compare, inputs
from benchmark.reference import cameras, pose, raster, smpl
from benchmark.reference.precision import F32, Precision, no_tf32


JOINTS = 21


def joints(v: torch.Tensor) -> dict:
    """The 63-d pose (or its gradient) as one leaf a joint."""
    return {f"pose.{j:02d}": x for j, x in enumerate(v.reshape(JOINTS, 3))}


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, parts: dict):
        self.cfg, self.wl, self.seed, self.dev, self.parts = cfg, wl, seed, torch.device(device), parts
        self.tr = wl["traffic"]
        self.pg = cfg["pose_generator"]
        self.window_losses: list = []
        self.n = 0  # steps taken
        self.probe = None

    def _part(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + t - t0
        return t

    def setup(self) -> None:
        t = time.perf_counter()
        from avatarclip_torch.clip import model as clip_model
        from avatarclip_torch.pipelines import animate

        t = self._part("import program", t)
        cfg, dev = self.cfg, self.dev
        self.seeds = dict(zip(("weights", "draws"), inputs.sub_seeds(self.seed, 2)))
        self.tmp = tmp = tempfile.mkdtemp(prefix="bench_pose_")
        model = inputs.body_model(*self.tr["body_segments"])
        body_path = inputs.write_body(model, os.path.join(tmp, "smpl_body.npz"))
        self.body = inputs.body_tensors(model, dev)
        t = self._part("body", t)
        gen = torch.Generator(device=dev).manual_seed(self.seeds["weights"])
        self.clip_params = inputs.clip_weights(cfg["clip"], gen, dev)
        self.tokens = inputs.tokens([cfg["general"]["text"]], dev)
        t = self._part("weights", t)
        ctx = animate.AnimateContext(smpl_path=body_path, clip_size="tiny",
                                     render_res=int(self.pg["render_res"]), device=dev)
        ctx.clip_cfg = clip_model.CLIPConfig(**{k: cfg["clip"][k] for k in (
            "image_size", "patch_size", "vision_width", "vision_layers", "vision_heads", "embed_dim",
            "context_length", "vocab_size", "text_width", "text_layers", "text_heads", "compute_dtype")})
        ctx.clip_params = self.clip_params
        self.gen = animate.PoseOptimizer(ctx=ctx, seed=self.seeds["draws"], optim_name=self.pg["optim_name"],
                                         optim_cfg={"lr": float(self.pg["lr"])},
                                         num_iteration=int(self.pg["num_iteration"]), topk=int(self.pg["topk"]))
        with torch.no_grad():
            self.text = clip_model.encode_text(self.clip_params, ctx.clip_cfg, self.tokens)[0]
        self._part("program", t)

    def _step(self) -> torch.Tensor:
        """One step of get_pose's loop; a fresh pose and Adam every
        num_iteration steps."""
        g = self.gen
        if self.n % g.num_iteration == 0:
            self.var = g.draw_init().to(self.dev).requires_grad_(True)
            self.opt = g.make_optimizer(self.var)
            self.var0 = self.var.detach().clone()
        if self.probe is None and self.window_started:
            self.probe = (self.var.detach().clone(), g.gen.get_state())
        t0 = time.perf_counter()
        loss = g.step(self.var, self.opt, self.text, g.draw_step())
        g.losses.append(loss)
        g._clock(t0)
        self.n += 1
        return loss

    window_started = False

    def first_steps(self) -> None:
        t = time.perf_counter()
        losses, grad = [], None
        for k in range(int(self.tr["checked_steps"])):
            losses.append(self._step())
            if k == 0:
                grad = compare.norms(joints(compare.adam_first_grad(
                    self.opt.state[self.var].get("exp_avg", torch.zeros_like(self.var)))))
        change = compare.norms(joints(self.var.detach() - self.var0))
        self.prog = {"losses": [float(x) for x in losses], "grad": grad, "change": change}
        self._part("first steps", t)

    def warmup(self) -> None:
        t = time.perf_counter()
        self._step()
        self.window_started = True
        self._part("warm-up", t)

    def step(self) -> None:
        self.window_losses.append(self._step())

    def step_labels(self) -> list[str]:
        """Each window step: the first of a fresh pose, or a later one."""
        first = self.n - len(self.window_losses)
        return ["fresh pose" if (first + i) % self.gen.num_iteration == 0 else "step"
                for i in range(len(self.window_losses))]

    def window_done(self) -> int:
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def context(self, trace) -> dict:
        """Per-step counts: CLIP's forward and input gradient on the views,
        SMPL's skinning, and the soft raster's operations on the live
        (pixel, face) pairs of the window's first step; B5's bound a step."""
        views = len(self.pg["azimuths"])
        res = int(self.pg["render_res"])
        out = {"peak_flops": peaks.PEAK_BY_DTYPE[self.cfg["clip"]["compute_dtype"]]}
        V, J = self.body["v_template"].shape[0], 24
        smpl_flops = 2.0 * V * J * 12 + 2.0 * V * 12
        clip_flops = vit.image_train_flops(self.cfg["clip"]) * views
        if trace is None or self.probe is None:
            out["model_flops_step"] = clip_flops + smpl_flops
            return out
        var, state = self.probe
        g = torch.Generator()
        g.set_state(state)
        elevs = (torch.randn(views, generator=g) * float(self.pg["elevation_std"])).to(self.dev)
        with torch.no_grad(), no_tf32():
            full = torch.cat([torch.tensor([math.pi / 2, 0, 0], device=self.dev), var,
                              torch.zeros(6, device=self.dev)]).reshape(1, 24, 3)
            v = smpl.skin(self.body, full)[0] @ torch.tensor(cameras.BODY_TO_WORLD, device=self.dev).t()
            poses = cameras.view_poses(elevs, torch.tensor(self.pg["azimuths"], device=self.dev))
            focal = cameras.focal_from_fov(res, math.radians(60.0))
            sx, sy, iz, front = raster.project(v[None].expand(views, -1, -1), poses, res, res, focal)
            faces = self.body["faces"].long()
            coef, valid, scale = raster.face_coefficients(sx, sy, iz, front, faces)
            cs = coef[..., :3].transpose(-1, -2) * scale[..., None]
            live = soft.live_pairs(cs, valid, res, res, float(self.pg["sigma"]))
        F = faces.shape[0]
        Fp = (F + 511) // 512 * 512
        tiles = ((res + 31) // 32) ** 2
        f_b, b_b = soft.pair_bounds(live, views, Fp, res * res, views * tiles * (Fp // 512), sm_clock_hz())
        out.update(model_flops_step=clip_flops + smpl_flops + f_b["ops"] + b_b["ops"], live_pairs=live,
                   soft_bound_ms_step=f_b["bound_ms"] + b_b["bound_ms"])
        return out

    def release(self) -> None:
        """Free the program's state and the set-up's files."""
        self.gen = self.var = self.opt = None
        self.window_losses = []
        shutil.rmtree(self.tmp, ignore_errors=True)

    def reference(self, prec: Precision = F32) -> dict:
        with no_tf32():
            run = pose.PoseRun(self.cfg, self.body, self.clip_params, self.tokens,
                               torch.Generator().manual_seed(self.seeds["draws"]), self.dev, prec)
            v0 = run.var.detach().clone()
            losses, grad = [], None
            for k in range(int(self.tr["checked_steps"])):
                loss, g = run.step()
                losses.append(loss)
                if k == 0:
                    grad = compare.norms(joints(g["pose"]))
            change = compare.norms(joints(run.var.detach() - v0))
        return {"losses": losses, "grad": grad, "change": change}

    def readings(self, prec: Precision = F32) -> dict:
        return compare.readings(self.prog, self.reference(prec))

    def check(self) -> dict:
        r = self.readings()
        print(f"[bench] losses {self.prog['losses']}; worst gradient leaf {r['grad_leaf']}, "
              f"worst change leaf {r['change_leaf']}; left out of the change: {r['left_out']}", flush=True)
        return compare.checks(r, self.wl["limits"])


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi), the special functions'
    rate."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6
