"""SMPL body model as torch tensors (twin of avatarclip_tpu/body/smpl.py).

Loads canonical ``.npz`` archives, official ``.pkl`` files (tolerating the
chumpy objects inside without chumpy) or, without the licensed asset, builds
the procedural approximate model around any body mesh (zero blendshapes,
distance-based joint regressor and skinning weights), with the fallback
chain of the JAX package's ``assets.load_smpl`` (avatarclip_torch.assets).
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from . import lbs as _lbs

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)
NUM_JOINTS = 24


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, B)
    posedirs: torch.Tensor  # (9*(J-1), V*3)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray  # (J,)
    faces: np.ndarray  # (F, 3) int32
    approximate: bool = False

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def to(self, device) -> "SMPLModel":
        """The model with its tensors on ``device``."""
        return dataclasses.replace(
            self, v_template=self.v_template.to(device), shapedirs=self.shapedirs.to(device),
            posedirs=self.posedirs.to(device), J_regressor=self.J_regressor.to(device),
            lbs_weights=self.lbs_weights.to(device))

    def shape(self, betas: torch.Tensor) -> torch.Tensor:
        """betas (N, B) -> shaped rest vertices (N, V, 3)."""
        return self.v_template[None] + _lbs.blend_shapes(betas, self.shapedirs)

    def forward(self, betas=None, body_pose=None, global_orient=None, v_shaped=None,
                pose2rot: bool = True):
        """-> (vertices (N, V, 3), joints (N, J, 3)); ``v_shaped`` bypasses
        the beta blendshapes (posing a coarse-shape template mesh)."""
        if v_shaped is None:
            if betas is None:
                betas = torch.zeros(1, self.num_betas, dtype=self.v_template.dtype,
                                    device=self.v_template.device)
            v_shaped = self.v_template[None] + _lbs.blend_shapes(betas, self.shapedirs)
        N = v_shaped.shape[0]
        # The defaults live where the model does (a model moved by .to(dev)).
        like = dict(dtype=v_shaped.dtype, device=v_shaped.device)
        eye = torch.eye(3, **like)
        if pose2rot:
            body_pose = torch.zeros(N, NUM_JOINTS - 1, 3, **like) if body_pose is None else body_pose
            global_orient = torch.zeros(N, 3, **like) if global_orient is None else global_orient
            full = torch.cat([global_orient.reshape(N, 1, 3), body_pose.reshape(N, -1, 3)], 1)
        else:
            body_pose = eye.expand(N, NUM_JOINTS - 1, 3, 3) if body_pose is None else body_pose
            global_orient = eye.expand(N, 1, 3, 3) if global_orient is None else global_orient
            full = torch.cat([global_orient.reshape(N, 1, 3, 3),
                              body_pose.reshape(N, -1, 3, 3)], 1)
        return _lbs.lbs(v_shaped, full, self.posedirs, self.J_regressor, self.parents,
                        self.lbs_weights, pose2rot=pose2rot)


class _ChumpyShim:
    """Stands in for chumpy objects inside official SMPL pickles."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    def __array__(self, dtype=None, copy=None):
        for key in ("x", "a", "r", "v"):
            v = self.__dict__.get(key)
            if isinstance(v, np.ndarray):
                return v.astype(dtype) if dtype else v
            if isinstance(v, _ChumpyShim):
                return np.asarray(v, dtype=dtype)
        raise ValueError("cannot extract array from chumpy object")


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShim
        if module.startswith("scipy.sparse"):
            import scipy.sparse as sp

            return getattr(sp, name, _ChumpyShim)
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray(), dtype=np.float64)
    return np.asarray(x)


def _from_dict(d: dict) -> SMPLModel:
    f32 = lambda k: torch.from_numpy(_to_np(d[k]).astype(np.float32))
    posedirs = _to_np(d["posedirs"]).astype(np.float32)
    if posedirs.ndim == 3:  # (V, 3, 207) -> (207, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = d.get("kintree_table")
    if parents is not None:
        parents = _to_np(parents)[0].astype(np.int64)
        parents[0] = -1
        parents = parents.astype(np.int32)
    else:
        parents = SMPL_PARENTS
    return SMPLModel(
        v_template=f32("v_template"),
        shapedirs=f32("shapedirs")[..., :10],
        posedirs=torch.from_numpy(np.ascontiguousarray(posedirs)),
        J_regressor=f32("J_regressor"),
        lbs_weights=f32("weights" if "weights" in d else "lbs_weights"),
        parents=np.asarray(parents),
        faces=_to_np(d["f"] if "f" in d else d["faces"]).astype(np.int32),
    )


def load_smpl_pkl(path: str) -> SMPLModel:
    with open(path, "rb") as f:
        data = _TolerantUnpickler(f, encoding="latin1").load()
    return _from_dict({k: data[k] for k in data})


def convert_pkl_to_npz(pkl_path: str, npz_path: str) -> None:
    """One-time conversion of an official SMPL pkl to a clean npz archive
    (the keys and arrays the JAX package's converter writes)."""
    m = load_smpl_pkl(pkl_path)
    np.savez_compressed(
        npz_path,
        v_template=m.v_template.numpy(),
        shapedirs=m.shapedirs.numpy(),
        posedirs=m.posedirs.numpy(),
        J_regressor=m.J_regressor.numpy(),
        weights=m.lbs_weights.numpy(),
        kintree_table=np.stack([m.parents, np.arange(len(m.parents))]),
        f=m.faces,
    )


def load_smpl_npz(path: str) -> SMPLModel:
    with np.load(path, allow_pickle=True) as data:
        return _from_dict({k: data[k] for k in data.files})


_CANONICAL_JOINTS = np.array([
    [0.000, 0.570, 0.00], [0.065, 0.540, 0.00], [-0.065, 0.540, 0.00], [0.000, 0.640, 0.00],
    [0.075, 0.320, 0.00], [-0.075, 0.320, 0.00], [0.000, 0.700, 0.00], [0.080, 0.080, 0.00],
    [-0.080, 0.080, 0.00], [0.000, 0.760, 0.00], [0.090, 0.020, 0.06], [-0.090, 0.020, 0.06],
    [0.000, 0.860, 0.00], [0.045, 0.820, 0.00], [-0.045, 0.820, 0.00], [0.000, 0.920, 0.00],
    [0.105, 0.830, 0.00], [-0.105, 0.830, 0.00], [0.260, 0.830, 0.00], [-0.260, 0.830, 0.00],
    [0.410, 0.830, 0.00], [-0.410, 0.830, 0.00], [0.470, 0.830, 0.00], [-0.470, 0.830, 0.00],
], dtype=np.float32)


def approximate_model_from_mesh(v_template: np.ndarray, faces: np.ndarray,
                                num_betas: int = 10) -> SMPLModel:
    """Approximate articulated model around a body mesh: canonical joints
    scaled to the mesh bounds, k-nearest-vertex joint regressor, skinning
    weights falling off with distance to the two nearest bones (top 4)."""
    v = np.asarray(v_template, dtype=np.float32)
    ymin, ymax = float(v[:, 1].min()), float(v[:, 1].max())
    height = ymax - ymin
    joints = _CANONICAL_JOINTS.copy()
    joints[:, 1] = ymin + joints[:, 1] * height
    joints[:, 0] = float(v[:, 0].mean()) + joints[:, 0] * height
    joints[:, 2] = float(v[:, 2].mean()) + joints[:, 2] * height * 0.5
    V, J, k = v.shape[0], NUM_JOINTS, 24
    d_jv = np.linalg.norm(v[None, :, :] - joints[:, None, :], axis=-1)
    J_regressor = np.zeros((J, V), dtype=np.float32)
    nearest = np.argsort(d_jv, axis=1)[:, :k]
    for j in range(J):
        J_regressor[j, nearest[j]] = 1.0 / k
    seg_d = np.full((V, J), np.inf, dtype=np.float32)
    for j in range(1, J):
        p, q = joints[SMPL_PARENTS[j]], joints[j]
        pq = q - p
        t = np.clip(((v - p) @ pq) / (float(pq @ pq) + 1e-9), 0.0, 1.0)
        d = np.linalg.norm(v - (p[None] + t[:, None] * pq[None]), axis=-1)
        seg_d[:, j] = np.minimum(seg_d[:, j], d)
        seg_d[:, SMPL_PARENTS[j]] = np.minimum(seg_d[:, SMPL_PARENTS[j]], d)
    sigma = 0.06 * height
    w = np.exp(-(seg_d**2) / (2 * sigma**2))
    order = np.argsort(-w, axis=1)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, order[:, :4], 1.0, axis=1)
    w = w * mask
    w = w / (w.sum(axis=1, keepdims=True) + 1e-9)
    return SMPLModel(
        v_template=torch.from_numpy(v),
        shapedirs=torch.zeros(V, 3, num_betas),
        posedirs=torch.zeros(9 * (J - 1), V * 3),
        J_regressor=torch.from_numpy(J_regressor),
        lbs_weights=torch.from_numpy(w.astype(np.float32)),
        parents=SMPL_PARENTS,
        faces=np.asarray(faces, dtype=np.int32),
        approximate=True,
    )
