"""The motion cell's driver: AvatarAnimate's MotionOptimizer.

Set-up makes the inputs from the seed (the body as an SMPL file, CLIP's and
the motion decoder's weights on the card, the candidate poses, the text's
token ids), builds the program's AnimateContext and MotionOptimizer on
them (the optimizer's generator seeded from the seed) and the text
feature. The checked steps, the warm-up and the window run the body of
``get_motion``'s loop: ``step`` on the latent with ``draw_step``'s frame
offset, then ``_clock``; a fresh latent (``draw_init``) and Adam start
every ``num_iteration`` steps, as ``get_motion`` starts them. It uses only
the optimizer's constructor, ``vae``, ``draw_init``, ``draw_step``,
``step``, ``_clock`` and ``losses``.

The checked steps run where the window runs: ``GRAPH_WARMUP`` throwaway
steps on a scratch latent come first, with the draws' generator put back
after them, so that a program which replays its decoder and CLIP's tower
from CUDA graphs (the graphs' own warm-up and capture) replays them in
every checked step; the counters must show it.

The check's leaves are the latent's 16 slices of 16 dimensions, so that a
gradient given to the wrong part of the latent moves a leaf's norm.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import torch

from benchmark.counts import motion_vae, peaks, soft, vit
from benchmark.drivers.pose_adam import sm_clock_hz
from benchmark.harness import compare, inputs, motion
from benchmark.reference import cameras, raster, smpl
from benchmark.reference import motion as ref_motion
from benchmark.reference.precision import F32, Precision, no_tf32

LEAVES = 16
GRAPH_WARMUP = 3  # a graphed key's eager calls (2) and its capture, before the checked steps
GRAPHED = ("motion_graph", "clip_graph")  # the counters' prefixes of the step's graphed functions


def slices(v: torch.Tensor) -> dict:
    """The latent (or its gradient) as LEAVES leaves."""
    return {f"latent.{i:02d}": x for i, x in enumerate(v.reshape(LEAVES, -1))}


def graph_counts() -> dict:
    """{prefix: (captures, replays)} of the program's graph counters."""
    from avatarclip_torch.utils import trace

    c = trace.counters()
    return {p: (c.get(p + "_capture", 0), c.get(p + "_replay", 0)) for p in GRAPHED}


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, parts: dict):
        self.cfg, self.wl, self.seed, self.dev, self.parts = cfg, wl, seed, torch.device(device), parts
        self.tr = wl["traffic"]
        self.mg = cfg["motion_generator"]
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
        cfg, mg, dev = self.cfg, self.mg, self.dev
        self.seeds = dict(zip(("weights", "draws", "poses"), inputs.sub_seeds(self.seed, 3)))
        self.tmp = tmp = tempfile.mkdtemp(prefix="bench_motion_")
        model = inputs.body_model(*self.tr["body_segments"])
        body_path = inputs.write_body(model, os.path.join(tmp, "smpl_body.npz"))
        self.body = inputs.body_tensors(model, dev)
        t = self._part("body", t)
        gen = torch.Generator(device=dev).manual_seed(self.seeds["weights"])
        self.clip_params = inputs.clip_weights(cfg["clip"], gen, dev)
        self.decoder = motion.decoder_weights(mg, gen, dev)
        self.poses63 = motion.candidate_poses(int(mg["candidates"]), float(self.tr["candidate_std"]),
                                              torch.Generator().manual_seed(self.seeds["poses"]), dev)
        self.tokens = inputs.tokens([cfg["general"]["text"]], dev)
        t = self._part("weights", t)
        ctx = animate.AnimateContext(smpl_path=body_path, clip_size="tiny",
                                     render_res=int(mg["render_res"]), device=dev)
        ctx.clip_cfg = clip_model.CLIPConfig(**{k: cfg["clip"][k] for k in (
            "image_size", "patch_size", "vision_width", "vision_layers", "vision_heads", "embed_dim",
            "context_length", "vocab_size", "text_width", "text_layers", "text_heads", "compute_dtype")})
        ctx.clip_params = self.clip_params
        self.gen = animate.MotionOptimizer(
            ctx=ctx, seed=self.seeds["draws"], num_frame=int(mg["num_frame"]), latent_dim=int(mg["latent_dim"]),
            num_layers=int(mg["num_layers"]), num_heads=int(mg["num_heads"]), optim_name=mg["optim_name"],
            optim_cfg={"lr": float(mg["lr"])}, num_iteration=int(mg["num_iteration"]),
            recon_coef=tuple(mg["recon_coef"]), clip_coef=float(mg["clip_coef"]),
            delta_coef=float(mg["delta_coef"]), clip_num_part=int(mg["clip_num_part"]))
        self.gen.vae = {**self.gen.vae, **self.decoder}  # the program's positional encoding kept
        with torch.no_grad():
            self.text = clip_model.encode_text(self.clip_params, ctx.clip_cfg, self.tokens)[0]
        self._part("program", t)

    def _step(self) -> torch.Tensor:
        """One step of get_motion's loop; a fresh latent and Adam every
        num_iteration steps."""
        g = self.gen
        if self.n % g.num_iteration == 0:
            self.latent = g.draw_init().to(self.dev).requires_grad_(True)
            self.opt = torch.optim.Adam([self.latent], lr=float(self.mg["lr"]), betas=(0.9, 0.999), eps=1e-8)
            self.lat0 = self.latent.detach().clone()
        if self.probe is None and self.window_started:
            self.probe = (self.latent.detach().clone(), g.gen.get_state())
        t0 = time.perf_counter()
        loss = g.step(self.latent, self.opt, self.poses63, self.text, g.draw_step())
        g.losses.append(loss)
        g._clock(t0)
        self.n += 1
        return loss

    window_started = False

    def first_steps(self) -> None:
        t = time.perf_counter()
        g = self.gen
        state = g.gen.get_state()
        scratch = g.draw_init().to(self.dev).requires_grad_(True)
        opt = torch.optim.Adam([scratch], lr=float(self.mg["lr"]), betas=(0.9, 0.999), eps=1e-8)
        for _ in range(GRAPH_WARMUP):
            g.step(scratch, opt, self.poses63, self.text, g.draw_step())
        g.gen.set_state(state)
        t = self._part("graph warm-up", t)
        before, checked = graph_counts(), int(self.tr["checked_steps"])
        losses, grad = [], None
        for k in range(checked):
            losses.append(self._step())
            if k == 0:
                grad = compare.norms(slices(compare.adam_first_grad(
                    self.opt.state[self.latent].get("exp_avg", torch.zeros_like(self.latent)))))
        change = compare.norms(slices(self.latent.detach() - self.lat0))
        self.prog = {"losses": [float(x) for x in losses], "grad": grad, "change": change}
        for p, (captures, replays) in graph_counts().items():
            if captures and replays - before[p][1] != checked:
                raise RuntimeError(f"{p}: {replays - before[p][1]} of the {checked} checked steps replayed")
        self._part("first steps", t)

    def warmup(self) -> None:
        t = time.perf_counter()
        self._step()
        self.window_started = True
        self._part("warm-up", t)

    def step(self) -> None:
        self.window_losses.append(self._step())

    def step_labels(self) -> list[str]:
        """Each window step: the first of a fresh latent, or a later one."""
        first = self.n - len(self.window_losses)
        return ["fresh latent" if (first + i) % self.gen.num_iteration == 0 else "step"
                for i in range(len(self.window_losses))]

    def window_done(self) -> int:
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def context(self, trace) -> dict:
        """Per-step counts: the decoder's forward and latent gradient, CLIP's
        forward and input gradient on the scored frames, SMPL's skinning of
        them, and the soft raster's operations on the live (pixel, face)
        pairs of the window's first step; B5's bound a step."""
        mg = self.mg
        T, P = int(mg["num_frame"]), int(mg["clip_num_part"])
        frames, res = -(-T // P), int(mg["render_res"])
        out = {"peak_flops": peaks.PEAK_BY_DTYPE[self.cfg["clip"]["compute_dtype"]]}
        V, J = self.body["v_template"].shape[0], 24
        smpl_flops = (2.0 * V * J * 12 + 2.0 * V * 12) * frames
        dense = motion_vae.decoder_train_flops(mg) + vit.image_train_flops(self.cfg["clip"]) * frames + smpl_flops
        if trace is None or self.probe is None:
            out["model_flops_step"] = dense
            return out
        latent, state = self.probe
        g = torch.Generator()
        g.set_state(state)
        st_idx = int(torch.randint(0, P, (), generator=g))
        with torch.no_grad(), no_tf32():
            poses = ref_motion.motion_poses(ref_motion.decode(self.decoder, latent, mg))
            raw = st_idx + P * torch.arange(frames, device=self.dev)
            part = poses[raw.clamp(0, T - 1)]
            orient = torch.tensor([math.pi / 2, 0.0, 0.0], device=self.dev).expand(frames, 3)
            full = torch.cat([orient, part, torch.zeros(frames, 6, device=self.dev)], -1).reshape(frames, 24, 3)
            v = smpl.skin(self.body, full) @ torch.tensor(cameras.BODY_TO_WORLD, device=self.dev).t()
            view = cameras.view_poses(torch.tensor([float(mg["elevation"])], device=self.dev),
                                      torch.tensor([float(mg["azimuth"])], device=self.dev))
            focal = cameras.focal_from_fov(res, math.radians(60.0))
            sx, sy, iz, front = raster.project(v, view.expand(frames, 4, 4), res, res, focal)
            faces = self.body["faces"].long()
            coef, valid, scale = raster.face_coefficients(sx, sy, iz, front, faces)
            cs = coef[..., :3].transpose(-1, -2) * scale[..., None]
            live = soft.live_pairs(cs, valid, res, res, float(mg["sigma"]))
        F = faces.shape[0]
        Fp = (F + 511) // 512 * 512
        tiles = ((res + 31) // 32) ** 2
        f_b, b_b = soft.pair_bounds(live, frames, Fp, res * res, frames * tiles * (Fp // 512), sm_clock_hz())
        out.update(model_flops_step=dense + f_b["ops"] + b_b["ops"], live_pairs=live,
                   soft_bound_ms_step=f_b["bound_ms"] + b_b["bound_ms"])
        return out

    def release(self) -> None:
        """Free the program's state and the set-up's files."""
        self.gen = self.latent = self.opt = None
        self.window_losses = []
        shutil.rmtree(self.tmp, ignore_errors=True)

    def reference(self, prec: Precision = F32) -> dict:
        with no_tf32():
            run = ref_motion.MotionRun(self.cfg, self.body, self.clip_params, self.tokens, self.decoder,
                                       self.poses63, torch.Generator().manual_seed(self.seeds["draws"]),
                                       self.dev, prec)
            v0 = run.latent.detach().clone()
            losses, grad = [], None
            for k in range(int(self.tr["checked_steps"])):
                loss, g = run.step()
                losses.append(loss)
                if k == 0:
                    grad = compare.norms(slices(g["latent"]))
            change = compare.norms(slices(run.latent.detach() - v0))
        return {"losses": losses, "grad": grad, "change": change}

    def readings(self, prec: Precision = F32) -> dict:
        return compare.readings(self.prog, self.reference(prec))

    def check(self) -> dict:
        r = self.readings()
        print(f"[bench] losses {self.prog['losses']}; worst gradient leaf {r['grad_leaf']}, "
              f"worst change leaf {r['change_leaf']}; left out of the change: {r['left_out']}", flush=True)
        return compare.checks(r, self.wl["limits"])
