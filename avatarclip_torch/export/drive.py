"""Animate an extracted avatar: mesh -> ``.pc2`` point-cache animation.

Twin of avatarclip_tpu/export/drive.py (reference:
AvatarGen/AppearanceGen/drive.py:308-376): read the extracted PLY, keep the
largest island, transfer SMPL blend weights by nearest vertex, un-pose to
the rest pose by inverse LBS, re-pose every motion frame and write a
``.pc2``. The posing and the per-frame skinning run batched on ``device``
(16 frames a batch; the card unless the caller asks for the CPU); the file
IO, the island search and the nearest-vertex search are host work. Each
phase's seconds go into ``timing`` when a dict is passed.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from .. import assets
from ..body import lbs as lbs_mod
from ..body import rotations
from ..body.smpl import SMPLModel
from ..utils import device as device_mod
from . import mesh_io, meshops

# The extracted NeuS mesh lives in the renderer's world frame; rotate back to
# the SMPL body frame before skinning (drive.py:314-320 applies the inverse
# of the render rotation).
WORLD_TO_BODY = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], dtype=np.float32)


def _rot_mats(poses: np.ndarray) -> np.ndarray:
    """(T, 72) axis-angle -> (T, 24, 3, 3) rotation matrices."""
    return rotations.rodrigues(torch.from_numpy(poses).reshape(-1, 3)).reshape(-1, 24, 3, 3).numpy()


def read_pose_seq(folder: str) -> np.ndarray:
    """A folder of per-frame ``smpl_param.pkl`` dirs (drive.py:267-280) ->
    (T, 24, 3, 3) rotation matrices."""
    poses = []
    for d in sorted(d for d in os.listdir(folder) if d.startswith("000")):
        with open(os.path.join(folder, d, "smpl_param.pkl"), "rb") as f:
            poses.append(np.asarray(pickle.load(f)["pose"], np.float32).reshape(-1)[:72])
    return _rot_mats(np.stack(poses))


def read_motion_npy(path: str) -> np.ndarray:
    """Motion .npy (T, >= 72), or AvatarAnimate's (T, 69) body poses, ->
    (T, 24, 3, 3) rotation matrices with the root pinned to the upright
    global orient (drive.py read_pose_my:282-293)."""
    poses = np.load(path)
    if poses.shape[-1] < 72:
        pad = np.zeros((poses.shape[0], 72 - poses.shape[-1] - 3), np.float32)
        poses = np.concatenate([np.zeros((poses.shape[0], 3), np.float32), poses, pad], axis=-1)
    poses = poses[:, :72].astype(np.float32).copy()
    poses[:, :3] = 0
    poses[:, 0] = np.pi / 2
    return _rot_mats(poses)


def retarget_mesh(mesh_verts: np.ndarray, smpl: SMPLModel, rest_pose_rot, beta=None,
                  device=None, timing: dict | None = None):
    """-> (rest-pose vertices (V, 3) on the host, blend weights (V, 24) on
    ``device``): nearest-template-vertex weight transfer and inverse LBS from
    the pose the mesh was sculpted in, ``rest_pose_rot`` (1, 24, 3, 3)
    (drive.py:235-253)."""
    dev = device_mod.resolve(device, "drive")
    timing = {} if timing is None else timing
    model = smpl.to(dev)
    rest = torch.as_tensor(np.array(rest_pose_rot, np.float32), device=dev)
    beta = torch.zeros(1, smpl.num_betas, device=dev) if beta is None else beta.to(dev)
    v_shaped = model.shape(beta)
    template_posed, _ = model.forward(v_shaped=v_shaped, body_pose=rest[:, 1:],
                                      global_orient=rest[:, :1], pose2rot=False)
    t0 = time.perf_counter()
    nearest = meshops.nearest_neighbors(template_posed[0].cpu().numpy(), mesh_verts)
    timing["nearest_neighbors_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    weights = model.lbs_weights[torch.from_numpy(nearest).long().to(dev)]
    verts = torch.from_numpy(np.ascontiguousarray(mesh_verts, np.float32)).to(dev)
    tpose = lbs_mod.inv_lbs(verts[None], weights, v_shaped, rest, None, model.J_regressor,
                            model.parents, pose2rot=False)[0].cpu().numpy()
    timing["inv_lbs_s"] = time.perf_counter() - t0
    return tpose, weights


def animate_mesh(tpose_verts: np.ndarray, weights, smpl: SMPLModel, pose_rots: np.ndarray,
                 beta=None, batch: int = 16, device=None) -> np.ndarray:
    """Skin the rest-pose mesh through a motion -> (T, V, 3) on the host;
    ``batch`` frames at a time on ``device``."""
    dev = device_mod.resolve(device, "drive")
    model = smpl.to(dev)
    beta = torch.zeros(1, smpl.num_betas, device=dev) if beta is None else beta.to(dev)
    joints = lbs_mod.vertices2joints(model.J_regressor, model.shape(beta))  # (1, J, 3)
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(tpose_verts, np.float32)).to(dev)
    rots = torch.as_tensor(np.array(pose_rots, np.float32))
    out = np.empty((rots.shape[0], v.shape[0], 3), np.float32)
    for s in range(0, rots.shape[0], batch):
        r = rots[s:s + batch].to(dev)
        _, A = lbs_mod.batch_rigid_transform(r, joints.expand(r.shape[0], -1, -1), model.parents)
        T = torch.einsum("vj,njab->nvab", w, A)
        frames = torch.einsum("nvab,vb->nva", T[..., :3, :3], v) + T[..., :3, 3]
        out[s:s + r.shape[0]] = frames.cpu().numpy()
    return out


def generate_animation(mesh_ply: str, motion_npy: str, out_pc2: str, smpl_path: str | None = None,
                       cleaned_ply: str | None = None, fps: float = 60.0, device=None,
                       timing: dict | None = None):
    """PLY -> cleanup -> retarget -> skin -> .pc2 (drive.py:308-376) ->
    (frames (T, V, 3), faces, colours)."""
    dev = device_mod.resolve(device, "drive")
    timing = {} if timing is None else timing
    t0 = time.perf_counter()
    verts, faces, colors = mesh_io.read_ply(mesh_ply)
    timing["mesh_vertices"] = len(verts)
    verts, faces, colors = meshops.largest_component(verts @ WORLD_TO_BODY.T, faces, colors)
    if cleaned_ply:
        mesh_io.write_ply(cleaned_ply, verts, faces, vertex_colors=colors)
    timing["read_cleanup_s"] = time.perf_counter() - t0
    timing["vertices"] = len(verts)
    smpl = assets.load_smpl(smpl_path)
    rest_rot = _rot_mats(assets.load_stand_pose().reshape(1, 72))
    t0 = time.perf_counter()
    tpose, weights = retarget_mesh(verts, smpl, rest_rot, device=dev, timing=timing)
    device_mod.sync(dev)
    timing["retarget_s"] = time.perf_counter() - t0
    pose_rots = read_motion_npy(motion_npy)
    t0 = time.perf_counter()
    frames = animate_mesh(tpose, weights, smpl, pose_rots, device=dev)
    timing["skin_s"] = time.perf_counter() - t0
    timing["frames"] = len(frames)
    t0 = time.perf_counter()
    mesh_io.write_pc2(out_pc2, frames, fps=fps)
    timing["write_pc2_s"] = time.perf_counter() - t0
    return frames, faces, colors


def main(argv=None) -> dict:
    """The CLI; returns the phase seconds and counts it prints."""
    import argparse

    parser = argparse.ArgumentParser(description="Animate an extracted avatar (drive.py equivalent)")
    parser.add_argument("--mesh", type=str, required=True, help="extracted PLY")
    parser.add_argument("--motion", type=str, required=True, help="motion .npy")
    parser.add_argument("--out", type=str, required=True, help="output .pc2")
    parser.add_argument("--cleaned_ply", type=str, default=None)
    parser.add_argument("--smpl_model_folder", type=str, default=None)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    timing: dict = {}
    generate_animation(args.mesh, args.motion, args.out, smpl_path=args.smpl_model_folder,
                       cleaned_ply=args.cleaned_ply, device=args.device, timing=timing)
    print("[drive] " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                 for k, v in timing.items()))
    return timing


if __name__ == "__main__":
    main()
