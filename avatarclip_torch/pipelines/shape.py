"""ShapeGen: CLIP-guided coarse body retrieval and the 108-view NeuS-init render.

Twin of avatarclip_tpu/pipelines/shape.py (reference: AvatarGen/ShapeGen/
main.py, render.py):

  * :func:`shape_gen` decodes the 16-d linear shape VAE, scores the
    (latent -> CLIP image embedding) codebook against the normalised text
    delta (target - neutral), takes the argmax and returns the coarse body
    (main.py:93-123);
  * :func:`render_coarse_shape` poses the coarse mesh by LBS and renders the
    108 NeuS-init views (18 azimuths x 6 elevations, distance 2.2, 256^2, fov
    60) with the hard rasterizer (B2 on the card) and writes them as PNGs,
    pre-mirrored, with ``transforms_train.json`` (render.py:32-139).

Everything runs on ``device``: the card unless the caller asks for the CPU.
Without the trained assets the fallbacks draw from seeded
``torch.Generator``s (the codebook from seed 21, the tiny CLIP from seed 42),
not the JAX package's ``jax.random`` bits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import assets
from ..body import rotations
from ..clip import model as clip_model
from ..clip import tokenizer as clip_tokenizer
from ..export import mesh_io
from ..render import cameras, raster
from ..utils import device as device_mod
from ..utils.convert import params_from_jax
from ..utils.png import write_png

N_VERTS = 6890
LATENT_DIM = 16
HIDDEN = 8192


# ---------------------------------------------------------------------------
# linear shape VAE (ShapeGen/main.py:22-68); params {enc1, enc2, dec1, dec2}
# each {"w" (out, in), "b" (out,)}
# ---------------------------------------------------------------------------


def vae_init(generator: torch.Generator, hidden: int = HIDDEN) -> dict:
    """Uniform(+-1/sqrt(in)) init of the VAE's four linears."""

    def dense(dout, din):
        bound = 1.0 / np.sqrt(din)
        return {"w": (torch.rand(dout, din, generator=generator) * 2 - 1) * bound,
                "b": (torch.rand(dout, generator=generator) * 2 - 1) * bound}

    d_in = N_VERTS * 3
    return {"enc1": dense(hidden, d_in), "enc2": dense(2 * LATENT_DIM, hidden),
            "dec1": dense(hidden, LATENT_DIM), "dec2": dense(d_in, hidden)}


def vae_decode(params: dict, v_template: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
    """(N, 16) -> (N, 6890, 3): the linear decoder's offsets added to the
    template (main.py:66-67)."""
    x = latent @ params["dec1"]["w"].t() + params["dec1"]["b"]
    x = x @ params["dec2"]["w"].t() + params["dec2"]["b"]
    return x.reshape(-1, N_VERTS, 3) + v_template.reshape(1, N_VERTS, 3)


def vae_encode(params: dict, verts_offset: torch.Tensor):
    """(N, 20670) -> (mu, logvar), each (N, 16)."""
    x = verts_offset @ params["enc1"]["w"].t() + params["enc1"]["b"]
    x = (x @ params["enc2"]["w"].t() + params["enc2"]["b"]).reshape(-1, 2, LATENT_DIM)
    return x[:, 0], x[:, 1]


def load_vae(path: str | None = None) -> tuple[dict, bool]:
    """(params, loaded): an ``.npz`` (the flat-path layout of utils/pytree)
    or the reference's ``model_VAE_16.pth``, else the weights-free fallback."""
    p = path or assets.find("model_VAE_16.pth") or assets.find("shape_vae.npz")
    if p and p.endswith(".npz"):
        with np.load(p) as data:
            return params_from_jax(dict(data)), True
    if p and p.endswith(".pth"):
        sd = torch.load(p, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return {k: {"w": sd[f"{k}.weight"].float(), "b": sd[f"{k}.bias"].float()}
                for k in ("enc1", "enc2", "dec1", "dec2")}, True
    return vae_fallback_from_smpl(), False


def vae_fallback_from_smpl(smpl_path: str | None = None) -> dict:
    """The weights-free stand-in whose decoder realises the body model's beta
    basis exactly (hidden 16: dec1 = I, dec2 = the (V*3, B) basis zero-padded
    to 16 columns, biases 0; the encoder its pseudo-inverse), as the JAX
    package's: every latent decodes to a valid body."""
    smpl = assets.load_smpl(smpl_path)
    basis = smpl.shapedirs.numpy().astype(np.float32).reshape(N_VERTS * 3, -1)
    nb = min(basis.shape[1], LATENT_DIM)
    dec2 = np.zeros((N_VERTS * 3, LATENT_DIM), np.float32)
    dec2[:, :nb] = basis[:, :nb]
    enc1 = np.zeros((2 * LATENT_DIM, N_VERTS * 3), np.float32)
    enc1[:nb] = np.linalg.pinv(basis[:, :nb]).astype(np.float32)
    z = lambda *s: torch.zeros(s)
    return {"enc1": {"w": torch.from_numpy(enc1), "b": z(2 * LATENT_DIM)},
            "enc2": {"w": torch.eye(2 * LATENT_DIM), "b": z(2 * LATENT_DIM)},
            "dec1": {"w": torch.eye(LATENT_DIM), "b": z(LATENT_DIM)},
            "dec2": {"w": torch.from_numpy(dec2), "b": z(N_VERTS * 3)}}


def load_codebook(path: str | None = None):
    """(codebook (N, 16), CLIP image embeddings (N, 512)): an ``.npz`` with
    ``codebook`` / ``codebook_embedding`` or the reference's single-entry
    torch dict {latents: embeddings} (main.py:86-91), else a seeded random
    codebook of 256 entries."""
    p = path or assets.find("codebook.pth") or assets.find("shape_codebook.npz")
    if p and p.endswith(".npz"):
        with np.load(p) as d:
            return (torch.from_numpy(np.array(d["codebook"], np.float32)),
                    torch.from_numpy(np.array(d["codebook_embedding"], np.float32)))
    if p and p.endswith(".pth"):
        d = torch.load(p, map_location="cpu", weights_only=False)
        k = next(iter(d))
        return torch.as_tensor(k).float(), torch.as_tensor(d[k]).float()
    g = torch.Generator().manual_seed(21)
    return torch.randn(256, LATENT_DIM, generator=g), torch.randn(256, 512, generator=g)


def parse_prompt(prompt: str):
    """'text:weight:stop' -> (text, weight, stop) (main.py:70-73)."""
    vals = prompt.rsplit(":", 2)
    vals = vals + ["", "1", "-inf"][len(vals):]
    return vals[0], float(vals[1]), float(vals[2])


# ---------------------------------------------------------------------------
# retrieval (ShapeGen/main.py:93-123)
# ---------------------------------------------------------------------------


def shape_gen(neutral_txt: str, target_txt: str, smpl_path: str | None = None,
              vae_path: str | None = None, codebook_path: str | None = None,
              clip_size: str = "vit_b32", render_res: int = 256, device=None,
              clip_params: dict | None = None):
    """-> (v (6890, 3), faces, zero-latent body (6890, 3)), numpy. The CLIP
    is ViT-B/32 (its weights if on disk, else a seeded init) or with
    ``clip_size="tiny"`` the small stand-in with the codebook's embedding
    width; ``clip_params`` overrides its weights."""
    dev = device_mod.resolve(device, "ShapeGen")
    smpl = assets.load_smpl(smpl_path)
    vae, _ = load_vae(vae_path)
    vae = clip_model.tree_to(vae, dev)
    codebook, clip_codebook = (t.to(dev) for t in load_codebook(codebook_path))
    if clip_size == "tiny":
        ccfg = dataclasses.replace(clip_model.TINY, embed_dim=clip_codebook.shape[-1])
        cparams = clip_model.init_params(ccfg, torch.Generator().manual_seed(42))
    else:
        ccfg = clip_model.VIT_B32
        cparams, _ = clip_model.load_pretrained()
    cparams = clip_model.tree_to(cparams if clip_params is None else clip_params, dev)
    v_template = smpl.v_template.to(dev)

    with torch.no_grad():
        toks = clip_tokenizer.tokenize([parse_prompt(neutral_txt)[0], parse_prompt(target_txt)[0]])
        text_emb = clip_model.encode_text(cparams, ccfg, torch.as_tensor(toks, device=dev))
        delta = text_emb[1] - text_emb[0]
        # the neutral (zero-latent) body's image embedding: one view at
        # azimuth 150, distance 2 (ShapeGen/utils.py:9-35)
        v0 = vae_decode(vae, v_template, torch.zeros(1, LATENT_DIM, device=dev))
        img = _render_view(v0[0], smpl.faces, azim_deg=150.0, res=render_res)
        clip_in = clip_model.resize_to_clip(img[None], ccfg.image_size)
        neutral_img_emb = clip_model.encode_image(cparams, ccfg, clip_model.normalize_image(clip_in))[0]
        # cosine of (codebook emb - neutral image emb) against the text delta
        # (main.py:117-119)
        a = clip_codebook - neutral_img_emb
        a = a / a.norm(dim=1, keepdim=True)
        best = int(torch.argmax(a @ (delta / delta.norm())))
        v = vae_decode(vae, v_template, codebook[best].reshape(1, LATENT_DIM))
    return v[0].cpu().numpy(), [list(f) for f in np.asarray(smpl.faces)], v0[0].cpu().numpy()


def _render_view(verts: torch.Tensor, faces, azim_deg: float, res: int, dist: float = 2.0,
                 elev: float = 0.0) -> torch.Tensor:
    """The neural_renderer camera (get_points_from_angles) and the hard
    rasterizer, with the SURREAL UV texture where the asset exists
    (ShapeGen/utils.py:6-7) -> (res, res, 3)."""
    dev = verts.device
    v_world = verts @ torch.from_numpy(cameras.BODY_TO_WORLD).to(dev).t()
    pose = _eye_pose(azim_deg, elev, dist).to(dev)
    kw = {}
    uvtex = assets.load_smpl_uv()
    if uvtex is not None:
        kw = dict(face_uvs=torch.from_numpy(uvtex[0]).to(dev), texture=torch.from_numpy(uvtex[1]).to(dev))
    focal = cameras.focal_from_fov(res, np.deg2rad(60.0))
    faces = torch.from_numpy(np.asarray(faces, np.int64)).to(dev)
    return raster.render_mesh(v_world, faces, pose, res, res, focal, **kw)["rgb"]


def _eye_pose(azim_deg: float, elev_rad: float, dist: float) -> torch.Tensor:
    """Camera-to-world pose at ``dist`` from the origin, looking at it."""
    a = np.deg2rad(azim_deg)
    eye = dist * torch.tensor([np.cos(elev_rad) * np.sin(a), np.sin(elev_rad),
                               -np.cos(elev_rad) * np.cos(a)], dtype=torch.float32)
    return cameras.lookat(eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))


# ---------------------------------------------------------------------------
# 108-view NeuS-init renderer (ShapeGen/render.py:32-139)
# ---------------------------------------------------------------------------


def render_coarse_shape(pose_aa: np.ndarray, v_shaped: np.ndarray, output_dir: str,
                        smpl_path: str | None = None, res: int = 256, dist: float = 2.2,
                        device=None) -> int:
    """Pose ``v_shaped`` (1, 6890, 3) with ``pose_aa`` (1, 24, 3) and write
    the 108 views under ``output_dir``; the number of views."""
    dev = device_mod.resolve(device, "ShapeGen")
    smpl = assets.load_smpl(smpl_path).to(dev)
    pose_rot = rotations.rodrigues(torch.as_tensor(np.asarray(pose_aa, np.float32)).reshape(-1, 3))
    pose_rot = pose_rot.reshape(1, 24, 3, 3).to(dev)
    with torch.no_grad():
        verts, _ = smpl.forward(v_shaped=torch.as_tensor(np.asarray(v_shaped, np.float32), device=dev),
                                body_pose=pose_rot[:, 1:], global_orient=pose_rot[:, :1],
                                pose2rot=False)
        v_world = verts[0] @ torch.from_numpy(cameras.BODY_TO_WORLD).to(dev).t()
        faces = torch.from_numpy(np.asarray(smpl.faces, np.int64)).to(dev)
        normals = raster.vertex_normals(v_world, faces)
    focal = cameras.focal_from_fov(res, np.deg2rad(60.0))
    os.makedirs(os.path.join(output_dir, "img"), exist_ok=True)
    frames = []
    i = 0
    for angle in range(0, 360, 20):
        for elevation in range(-60, 60, 20):
            pose = _eye_pose(float(angle), float(np.deg2rad(elevation)), dist)
            with torch.no_grad():
                img = raster.render_mesh(v_world, faces, pose.to(dev), res, res, focal,
                                         normals=normals)["rgb"].cpu().numpy()
            # the dataset loader mirrors horizontally on read (dataset.py:226);
            # pre-mirror so the round trip is the identity
            write_png(os.path.join(output_dir, "img", f"{i:04d}.png"),
                      (np.clip(img[:, ::-1], 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": f"img/{i:04d}", "transform_matrix": pose.numpy().tolist()})
            i += 1
    with open(os.path.join(output_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": float(np.deg2rad(60.0)), "frames": frames}, f)
    return i


# ---------------------------------------------------------------------------
# CLI (ShapeGen/main.py:125-149, render.py:141-172)
# ---------------------------------------------------------------------------


def main(argv=None) -> dict:
    """``gen`` writes the coarse OBJ (named after the target prompt),
    ``render`` the 108 views; returns what it wrote and its seconds."""
    import argparse

    parser = argparse.ArgumentParser(description="ShapeGen (PyTorch)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen", help="coarse shape retrieval")
    g.add_argument("--smpl_model_folder", type=str, default=None)
    g.add_argument("--AE_path_fname", type=str, default=None)
    g.add_argument("--codebook_fname", type=str, default=None)
    g.add_argument("--neutral_txt", type=str, default="a 3d rendering of a person in unreal engine")
    g.add_argument("--target_txt", type=str, default="a 3d rendering of a strong man in unreal engine")
    g.add_argument("--output_folder", type=str, default="./output/coarse_shape")
    g.add_argument("--clip_size", type=str, choices=["vit_b32", "tiny"], default="vit_b32")
    r = sub.add_parser("render", help="108-view NeuS-init renderer")
    r.add_argument("--smpl_model_folder", type=str, default=None)
    r.add_argument("--coarse_shape_obj", type=str, required=True)
    r.add_argument("--pose_type", type=str, choices=["stand_pose", "t_pose"], default="stand_pose")
    r.add_argument("--output_folder", type=str, default="./output/render")
    for p in (g, r):
        p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    if args.cmd == "gen":
        v, f, _ = shape_gen(args.neutral_txt, args.target_txt, smpl_path=args.smpl_model_folder,
                            vae_path=args.AE_path_fname, codebook_path=args.codebook_fname,
                            clip_size=args.clip_size, device=args.device)
        os.makedirs(args.output_folder, exist_ok=True)
        out = os.path.join(args.output_folder, "_".join(args.target_txt.split(" ")) + ".obj")
        mesh_io.write_obj(out, v, f)
        print(f"Results saved in {out} ({time.perf_counter() - t0:.3f} s)")
        return {"obj": out, "seconds": time.perf_counter() - t0}
    pose = assets.load_stand_pose() if args.pose_type == "stand_pose" else assets.t_pose()
    v_shaped, _, _, _ = mesh_io.read_obj(args.coarse_shape_obj)
    n = render_coarse_shape(pose, v_shaped.reshape(1, -1, 3), args.output_folder,
                            smpl_path=args.smpl_model_folder, device=args.device)
    print(f"{n} renderings written to: {args.output_folder} ({time.perf_counter() - t0:.3f} s)")
    return {"views": n, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
