"""Asset discovery for the port (its own copy of the asset helpers of
avatarclip_tpu/assets.py).

Every asset is looked up by name in ``$AVATARCLIP_TPU_DATA``, then ``./data``
and the working directory. ``load_smpl`` has the JAX package's fallback
chain: a real SMPL npz / pkl, else an approximate model around the zero-beta
template OBJ, else around the procedural humanoid.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np

from .body import smpl


@functools.lru_cache(maxsize=4)
def load_smpl(path_or_dir: str | None = None) -> smpl.SMPLModel:
    """Best available SMPL model: real npz / pkl, else the approximate model
    around the zero-beta template OBJ, else around the procedural humanoid
    (the fallback chain of avatarclip_tpu.assets.load_smpl)."""
    candidates: list[str] = []
    if path_or_dir:
        if os.path.isdir(path_or_dir):
            for fname in ("SMPL_NEUTRAL.npz", "smpl.npz", "SMPL_NEUTRAL.pkl",
                          "basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl",
                          "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl",
                          os.path.join("smpl", "SMPL_NEUTRAL.pkl")):
                candidates.append(os.path.join(path_or_dir, fname))
        else:
            candidates.append(path_or_dir)
    for d in search_dirs():
        candidates += [os.path.join(d, "SMPL_NEUTRAL.npz"), os.path.join(d, "smpl.npz"),
                       os.path.join(d, "SMPL_NEUTRAL.pkl"),
                       os.path.join(d, "smpl", "SMPL_NEUTRAL.pkl")]
    for c in candidates:
        if os.path.exists(c):
            if c.endswith(".npz"):
                return smpl.load_smpl_npz(c)
            try:
                return smpl.load_smpl_pkl(c)
            except (pickle.UnpicklingError, KeyError, ValueError, AttributeError, EOFError):
                continue
    obj = find("zero_beta_smpl.obj")
    if obj is not None:
        from .export.mesh_io import read_obj

        v, f, _, _ = read_obj(obj)
        return smpl.approximate_model_from_mesh(v, np.asarray(f, np.int32))
    v, f = _procedural_humanoid()
    return smpl.approximate_model_from_mesh(v, f)


def search_dirs() -> list[str]:
    dirs = []
    env = os.environ.get("AVATARCLIP_TPU_DATA")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.getcwd(), "data"))
    dirs.append(os.getcwd())
    return dirs


def find(name: str, explicit: str | None = None) -> str | None:
    """Locate an asset file or directory by name; a path or None."""
    if explicit:
        return explicit if os.path.exists(explicit) else None
    for d in search_dirs():
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


@functools.lru_cache(maxsize=1)
def load_smpl_uv():
    """(face_uvs (F, 3, 2), texture (H, W, 3) f32 in [0, 1]) of the
    SURREAL-textured ``smpl_uv.obj`` (reference: ShapeGen/utils.py:6-7) and
    the PNG beside it (smpl_texture.png, texture.png or smpl_uv.png), else
    None."""
    obj = find("smpl_uv.obj")
    if obj is None:
        return None
    from .export.mesh_io import read_obj
    from .utils.png import read_png

    _, _, Vt, Ft = read_obj(obj)
    if Vt is None or Ft is None:
        return None
    base = os.path.dirname(obj)
    for cand in ("smpl_texture.png", "texture.png", "smpl_uv.png"):
        p = os.path.join(base, cand)
        if os.path.exists(p):
            tex = read_png(p)
            face_uvs = np.asarray(Vt)[np.asarray(Ft)]
            return face_uvs.astype(np.float32), tex[..., :3].astype(np.float32) / 255.0
    return None


def load_stand_pose() -> np.ndarray:
    """The 72-dof stand pose of NeuS-init and appearance sculpting
    (reference: AvatarGen/ShapeGen/output/stand_pose.npy), else the t-pose."""
    p = find("stand_pose.npy")
    if p is not None:
        return np.load(p).reshape(1, 24, 3).astype(np.float32)
    return t_pose()


def t_pose() -> np.ndarray:
    pose = np.zeros((1, 24, 3), dtype=np.float32)
    pose[:, 0, 0] = np.pi / 2
    return pose


def _procedural_humanoid(n_seg: int = 24, n_ring: int = 16):
    """A capsule-person mesh (head, torso, limbs), used only when no body
    asset exists at all."""
    verts: list[np.ndarray] = []
    faces: list[list[int]] = []

    def add_capsule(p0, p1, radius):
        base = len(verts)
        p0, p1 = np.asarray(p0, np.float32), np.asarray(p1, np.float32)
        axis = p1 - p0
        length = np.linalg.norm(axis)
        axis = axis / (length + 1e-9)
        up = np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        x = np.cross(axis, up)
        x /= np.linalg.norm(x)
        y = np.cross(axis, x)
        for i in range(n_seg + 1):
            c = p0 + axis * (i / n_seg * length)
            for j in range(n_ring):
                a = 2 * np.pi * j / n_ring
                verts.append(c + radius * (np.cos(a) * x + np.sin(a) * y))
        for i in range(n_seg):
            for j in range(n_ring):
                a = base + i * n_ring + j
                b = base + i * n_ring + (j + 1) % n_ring
                c2 = base + (i + 1) * n_ring + j
                d = base + (i + 1) * n_ring + (j + 1) % n_ring
                faces.append([a, b, d])
                faces.append([a, d, c2])

    add_capsule([0, -0.3, 0], [0, 0.25, 0], 0.13)  # torso
    add_capsule([0, 0.28, 0], [0, 0.48, 0], 0.09)  # head
    add_capsule([0.08, -0.3, 0], [0.1, -0.85, 0], 0.06)  # left leg
    add_capsule([-0.08, -0.3, 0], [-0.1, -0.85, 0], 0.06)  # right leg
    add_capsule([0.14, 0.2, 0], [0.5, 0.2, 0], 0.045)  # left arm
    add_capsule([-0.14, 0.2, 0], [-0.5, 0.2, 0], 0.045)  # right arm
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
