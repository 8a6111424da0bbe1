"""Parameters from the JAX package into the port's modules.

The JAX parameter pytree, flattened to numpy arrays by
``tree_flatten_paths`` (utils/pytree.py; keys like
``sdf/layers/0/g``), maps onto the port by path: the networks' state-dict
keys are the same paths with ``.`` for ``/`` and the same (out, in) weight
layout, so no transposes are needed; a NeRF++ background's ``nerf/pts/{i}/w``,
``nerf/view/b``, ... land on ``NeuSFields.nerf`` the same way. The trees of plain functions keep
their nesting as dicts and lists of tensors: CLIP (clip/model.py), VPoser
(body/vposer.py), the motion VAE (pipelines/motion_vae.py), the RealNVP
blocks and masks and the codebook (pipelines/animate.py); the JAX pytree
itself converts with ``params_from_jax(tree_flatten_paths(tree))``.
:func:`params_to_jax` is the inverse for a module: the flat dict that, saved
with ``np.savez``, the JAX package's ``load_pytree_npz`` reads back as its
parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .pytree import tree_unflatten_paths


def params_from_jax(flat: dict, module: nn.Module | None = None, prefix: str = ""):
    """Fill ``module`` from a flattened JAX tree (keys under ``prefix``,
    e.g. ``"sdf/"``) and return it; with no module, return the nested tree
    as float32 tensors (the CLIP parameters)."""
    sub = {k[len(prefix):]: np.asarray(v) for k, v in flat.items() if k.startswith(prefix)}
    if module is None:
        return _to_torch(tree_unflatten_paths(sub))
    state = {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32)) for k, v in sub.items()}
    module.load_state_dict(state, strict=True)
    return module


def params_to_jax(module: nn.Module, prefix: str = "") -> dict:
    """The module's state as a flattened JAX tree: ``prefix`` + the state
    key with ``/`` for ``.``, float32 numpy (the inverse of
    :func:`params_from_jax` with the same prefix)."""
    return {prefix + k.replace(".", "/"): v.detach().cpu().numpy().astype(np.float32)
            for k, v in module.state_dict().items()}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))
