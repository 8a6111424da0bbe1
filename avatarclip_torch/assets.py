"""Asset discovery for the port (twin of avatarclip_tpu/assets.py).

The numpy helpers of the JAX package's assets module import no JAX and are
used as they are; ``load_smpl`` is the port's own, with the same fallback
chain (real SMPL npz / pkl, else an approximate model around the zero-beta
template OBJ, else around the procedural humanoid).
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np

from avatarclip_tpu.assets import (  # noqa: F401  (re-exported)
    _procedural_humanoid,
    find,
    load_stand_pose,
    search_dirs,
    t_pose,
)

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
        from avatarclip_tpu.export.mesh_io import read_obj

        v, f, _, _ = read_obj(obj)
        return smpl.approximate_model_from_mesh(v, np.asarray(f, np.int32))
    v, f = _procedural_humanoid()
    return smpl.approximate_model_from_mesh(v, f)
