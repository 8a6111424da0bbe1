"""The sculpting cell's driver: AppearanceGen's ``train_clip`` loop.

Set-up makes the inputs from the seed (the body, the view set, the fitted
SDF as the conf's pretrain, the colour net, CLIP's weights on the card,
the prompts' token ids), builds the program's Runner from a conf of the
configuration's values, hands it the CLIP weights and text features, the
step's random stream and the camera seed, poses the body and calibrates
the silhouette buckets. The checked steps, the warm-up and the window all
run the body of ``Runner.train_clip``'s loop: the step's camera and bucket
(``sample_iteration_camera``) then ``_timed(_clip_update)``; the loop's
logging, checkpoints and validations (``_post_iter``) are left out.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from benchmark.counts import neus as neus_counts
from benchmark.counts import peaks, vit
from benchmark.harness import compare, inputs
from benchmark.reference import sculpt
from benchmark.reference.precision import F32, Precision, no_tf32


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, parts: dict):
        self.cfg, self.wl, self.seed, self.dev, self.parts = cfg, wl, seed, torch.device(device), parts
        self.tr = wl["traffic"]
        self.window_losses: list = []
        self.labels: list[str] = []
        self.runner = None

    def _part(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + t - t0
        return t

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        t = time.perf_counter()
        from avatarclip_torch.clip import model as clip_model
        from avatarclip_torch.pipelines import appearance

        t = self._part("import program", t)
        cfg, dev = self.cfg, self.dev
        self.seeds = dict(zip(("weights", "camera", "draws", "fit"), inputs.sub_seeds(self.seed)))
        self.tmp = tmp = tempfile.mkdtemp(prefix="bench_train_clip_")
        model = inputs.body_model(*self.tr["body_segments"])
        body_path = inputs.write_body(model, os.path.join(tmp, "smpl_body.npz"))
        self.body = inputs.body_tensors(model, dev)
        t = self._part("body", t)
        ds = cfg["dataset"]
        views, self.focal = inputs.write_views(os.path.join(tmp, "views"), ds["n_views"], ds["resolution"],
                                               ds["fov_degrees"])
        self.sensor = int(ds["resolution"])
        t = self._part("views", t)
        gen = torch.Generator(device=dev).manual_seed(self.seeds["weights"])
        weights = inputs.neus_weights(cfg["model"], gen, dev)
        self.clip_params = inputs.clip_weights(cfg["clip"], gen, dev)
        self.tokens = inputs.tokens([cfg["clip"]["prompt"], cfg["clip"]["face_prompt"],
                                     cfg["clip"]["back_prompt"]], dev)
        t = self._part("weights", t)
        tmpl = sculpt.template(self.body, dev)
        fit = self.tr["pretrain_fit"]
        weights = inputs.fit_sdf(weights, cfg["model"]["sdf_network"], tmpl["v"], tmpl["n"], fit["steps"],
                                 fit["batch"], torch.Generator(device=dev).manual_seed(self.seeds["fit"]))
        self.w0 = {k: v.detach().clone() for k, v in weights.items()}
        pretrain = os.path.join(tmp, "pretrain.pth")
        torch.save(inputs.reference_pth(weights), pretrain)
        t = self._part("pretrain fit", t)
        c = inputs.flatten({k: v for k, v in cfg.items() if k in ("train", "model")})
        c.update({"general.base_exp_dir": os.path.join(tmp, "exp"), "general.smpl_model_path": body_path,
                  "dataset.data_dir": views, "train.pretrain": pretrain, "train.seed": self.seeds["camera"],
                  "clip.prompt": cfg["clip"]["prompt"], "clip.face_prompt": cfg["clip"]["face_prompt"],
                  "clip.back_prompt": cfg["clip"]["back_prompt"]})
        r = appearance.Runner(None, mode="train_clip", conf=inputs.conf(c), device=dev)
        r.gen = torch.Generator().manual_seed(self.seeds["draws"])
        ccfg = clip_model.CLIPConfig(**{k: cfg["clip"][k] for k in (
            "image_size", "patch_size", "vision_width", "vision_layers", "vision_heads", "embed_dim",
            "context_length", "vocab_size", "text_width", "text_layers", "text_heads")},
            compute_dtype=cfg["train"]["compute_dtype"])
        with torch.no_grad():
            r._encoded_texts = clip_model.encode_text(self.clip_params, ccfg, self.tokens)
        r._clip, r._clip_pretrained = (self.clip_params, ccfg), False
        t = self._part("runner", t)
        r.init_smpl()
        r._calibrate_sil_coverage()
        self.buckets = tuple(sorted(cfg["train"]["sil_buckets"]))
        self._part("coverage calibration", t)
        self.runner = r

    def _step(self, S=None):
        """One step of the loop body; ``S`` forces the bucket (warm-up)."""
        r = self.runner
        cam, s = r.sample_iteration_camera(r.iter_step, self.buckets)
        S = s if S is None else S
        self.labels.append(f"{S}^2 {'face' if cam['face_iter'] else 'body'}")
        r.step_sil_res.append(S)
        m = r._timed(lambda: r._clip_update(S, cam, r.iter_step))
        r.iter_step += 1
        return m

    def first_steps(self) -> None:
        """The checked steps from the inputs: each step's loss, the first
        gradient (from Adam's first moment) and the change after them."""
        t = time.perf_counter()
        r = self.runner
        losses, grad = [], None
        for k in range(int(self.tr["checked_steps"])):
            losses.append(self._step()["loss"])
            if k == 0:
                grad = compare.norms({n: compare.adam_first_grad(r.optimizer.state[p].get("exp_avg", torch.zeros_like(p)))
                                      for n, p in r.fields.named_parameters()})
        change = compare.norms({n: p.detach() - self.w0[n] for n, p in r.fields.named_parameters()})
        self.prog = {"losses": [float(x) for x in losses], "grad": grad, "change": change}
        self._part("first steps", t)

    def warmup(self) -> None:
        """A step at every silhouette bucket the checked steps did not use."""
        t = time.perf_counter()
        for b in self.buckets:
            if b not in self.runner.step_sil_res:
                self._step(b)
        self._part("warm-up", t)

    # -- the window ---------------------------------------------------------------

    def step(self) -> None:
        if not self.window_losses:
            self.labels = []
        self.window_losses.append(self._step()["loss"])

    def step_labels(self) -> list[str]:
        """Each window step's bucket and camera."""
        return self.labels

    def window_done(self) -> int:
        """Steps of the window whose loss is not finite."""
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def context(self, trace) -> dict:
        """Per-step counts for the readers: model FLOPs (NeuS's points
        forward and backward without recompute, the up-sample sweeps, CLIP's
        forward and input gradient on the step's 2 images), the peak of the
        configuration's compute type, and B1's bound a step."""
        m, tc = self.cfg["model"], self.cfg["train"]
        d = neus_counts.dims(m["sdf_network"], m["rendering_network"])
        ncfg = m["neus_renderer"]
        rays = int(tc["max_ray_num"])
        S = int(ncfg["n_samples"]) + int(ncfg["n_importance"])
        swept = int(ncfg["n_samples"]) + (int(ncfg["up_sample_steps"]) - 1) * (
            int(ncfg["n_importance"]) // int(ncfg["up_sample_steps"]))
        flops = (neus_counts.model_flops(d) * rays * S + neus_counts.sdf_only_flops(d) * rays * swept
                 + vit.image_train_flops(self.cfg["clip"]) * 2)
        fwd_f, bwd_f = neus_counts.gemm_flops(d)
        fwd_b, bwd_b = neus_counts.pass_bytes(d, rays, S)
        b1 = (peaks.bound_tc(fwd_f * rays * S, fwd_b)["bound_ms"]
              + peaks.bound_tc(bwd_f * rays * S, bwd_b)["bound_ms"])
        return {"model_flops_step": flops, "peak_flops": peaks.PEAK_BY_DTYPE[tc["compute_dtype"]],
                "neus_ray_bound_ms_step": b1}

    # -- the check -------------------------------------------------------------------

    def release(self) -> None:
        """Free the program's state and the set-up's files."""
        self.runner = None
        self.window_losses = []
        shutil.rmtree(self.tmp, ignore_errors=True)

    def reference(self, prec: Precision = F32) -> dict:
        """The reference's readings of the checked steps at ``prec``."""
        with no_tf32():
            ref = sculpt.Sculpt(self.cfg, self.w0, self.body, self.clip_params, self.tokens,
                                self.seeds["camera"], torch.Generator().manual_seed(self.seeds["draws"]),
                                self.focal, self.sensor, prec)
            losses, grad = [], None
            for it in range(int(self.tr["checked_steps"])):
                loss, g = ref.step(it)
                losses.append(loss)
                if it == 0:
                    grad = compare.norms(g)
            change = compare.norms({k: ref.params[k].detach() - self.w0[k] for k in ref.params})
        return {"losses": losses, "grad": grad, "change": change}

    def readings(self, prec: Precision = F32) -> dict:
        return compare.readings(self.prog, self.reference(prec))

    def check(self) -> dict:
        r = self.readings()
        print(f"[bench] losses {self.prog['losses']}; worst gradient leaf {r['grad_leaf']}, "
              f"worst change leaf {r['change_leaf']}; left out of the change: {r['left_out']}", flush=True)
        return compare.checks(r, self.wl["limits"])

