"""CLIP-score evaluation of a sculpted avatar (twin of
avatarclip_tpu/pipelines/eval_clip.py).

Render N full-body views of the checkpointed avatar (an azimuth lattice at
elevation 0 and camera distance ``distance``, the centre of train_clip's
U(1, 2) training distribution; reference AvatarGen/AppearanceGen/models/
utils.py:29-41) plus the face camera when the conf asks for the face prompt,
CLIP-encode them in one batch and report the per-view and mean cosine
against the conf's prompt: the quantity train_clip maximises per iteration
(AvatarGen/AppearanceGen/main.py:499-534). Each view is a validation render
(``Runner.render_rays_chunked``, white background), so on the card it runs
the point-level NeuS forward and the compositing forward.

With real converted weights (``clip_vit_b32.npz`` and the BPE vocabulary)
the mean cosine is the CLIP score; with the seeded random-init stand-in the
encoder is still a fixed scoring function. ``pretrained_clip`` in the report
says which.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..clip import model as clip_model
from ..render import cameras
from ..utils.png import write_png


@dataclasses.dataclass(frozen=True)
class ClipScoreReport:
    prompt: str
    cosines: tuple  # per body view, vs the main prompt
    azimuths: tuple  # radians, matching cosines
    mean_cosine: float
    face_cosine: float | None  # face camera vs face_prompt (if enabled)
    back_cosine: float | None  # the rear-most view vs back_prompt (if enabled)
    pretrained_clip: bool
    n_views: int
    distance: float
    image_source: str  # "extra_color" | "color"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["cosines"] = [float(c) for c in self.cosines]
        d["azimuths"] = [float(a) for a in self.azimuths]
        return d


def _render_view(runner, pose: torch.Tensor, resolution_level, use_extra: bool) -> np.ndarray:
    """(H, W, 3) in [0, 1] on the host: the view from ``pose`` on white."""
    rays_o, rays_d = runner.dataset.gen_rays_pose(pose, resolution_level)
    H, W = rays_o.shape[0], rays_o.shape[1]
    out = runner.render_rays_chunked(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                                     background_rgb=torch.ones(1, 3, device=runner.device),
                                     keys=["color_fine", "extra_color_fine"])
    img = (out["extra_color_fine"] if use_extra and out["extra_color_fine"] is not None
           else out["color_fine"])
    return np.clip(img.reshape(H, W, 3), 0.0, 1.0)


def _pose(eye: np.ndarray, at: np.ndarray, device) -> torch.Tensor:
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return cameras.lookat(as_t(eye), as_t(at), as_t([0.0, 1.0, 0.0]))


def clip_score(runner, n_views: int = 8, distance: float = 1.5, resolution_level: float = 1,
               save_dir: str | None = None) -> ClipScoreReport:
    """Render ``n_views`` azimuths and (with ``use_face_prompt``) the face
    camera, and score them with the runner's CLIP against the conf's
    prompts. The lattice is deterministic, so successive checkpoints of a
    run are scored on the same cameras."""
    if runner._clip is None:
        runner.init_clip()
    clip_params, clip_cfg = runner._clip
    texts = runner._encoded_texts  # [main, face, back]
    use_extra = bool(runner.extra_color)
    dev = runner.device

    azimuths = [2.0 * np.pi * i / n_views for i in range(n_views)]
    imgs = [_render_view(runner, _pose(cameras.sphere_coord_np(theta, 0.0, distance), np.zeros(3),
                                       dev), resolution_level, use_extra)
            for theta in azimuths]
    face_img = None
    if runner.tc.use_face_prompt:
        # 0.4 in front of the head: inside the unit sphere, so the rays take
        # the clipped near bound
        at_f = np.array([0.0, runner.tc.head_height, 0.3], np.float32)
        eye = cameras.sphere_coord_np(0.0, 0.0, 0.4) + at_f
        face_img = _render_view(runner, _pose(eye, at_f, dev), resolution_level, use_extra)

    # one batched CLIP encode for every rendered view
    batch = imgs + ([face_img] if face_img is not None else [])
    with torch.no_grad():
        x = torch.from_numpy(np.stack(batch).astype(np.float32)).to(dev)
        x = clip_model.resize_to_clip(x, clip_cfg.image_size)
        emb = clip_model.encode_image(clip_params, clip_cfg, clip_model.normalize_image(x)).float()
        emb = emb / emb.norm(dim=-1, keepdim=True)
        tnorm = texts.float() / texts.float().norm(dim=-1, keepdim=True)
        cos = (emb @ tnorm.t()).cpu().numpy().astype(np.float64)  # (views, 3 prompts)
    cos_main = cos[: len(imgs), 0]
    face_cos = float(cos[len(imgs), 1]) if face_img is not None else None
    back_cos = None
    if runner.tc.use_back_prompt:
        # the rear-most lattice view (azimuth closest to pi) vs back_prompt
        back_idx = int(np.argmin([abs(((a - np.pi) + np.pi) % (2 * np.pi) - np.pi)
                                  for a in azimuths]))
        back_cos = float(cos[back_idx, 2])

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        for a, im in zip(azimuths, imgs):
            write_png(os.path.join(save_dir, f"eval_az{int(round(np.degrees(a))):03d}_"
                                             f"it{runner.iter_step:08d}.png"),
                      (im * 255).astype(np.uint8))
        if face_img is not None:
            write_png(os.path.join(save_dir, f"eval_face_it{runner.iter_step:08d}.png"),
                      (face_img * 255).astype(np.uint8))

    return ClipScoreReport(
        prompt=runner.conf.get_string("clip.prompt"),
        cosines=tuple(float(c) for c in cos_main),
        azimuths=tuple(float(a) for a in azimuths),
        mean_cosine=float(cos_main.mean()),
        face_cosine=face_cos,
        back_cosine=back_cos,
        pretrained_clip=bool(getattr(runner, "_clip_pretrained", False)),
        n_views=n_views,
        distance=distance,
        image_source="extra_color" if use_extra else "color",
    )
