"""The motion cell's inputs made from the seed (the motion decoder's weights
and the candidate poses) and its own fault for the controls of
``correct`` (harness/faults.py holds the faults the cells share)."""

from __future__ import annotations

import contextlib

import torch

IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)  # the first two rows of the identity rotation
OUTPUT_SCALE = 0.25  # the output layer's spread around the identity, in 6d units


def decoder_weights(mg: dict, gen: torch.Generator, device) -> dict:
    """The decoder's tree (reference/motion.py's layout, which is the
    program's) from one normal sample on the device: linear weights
    N(0, 1 / fan_in), biases 0, layer norms (1, 0); the output layer
    N(0, OUTPUT_SCALE^2 / fan_in) with the identity rotation's 6d as every
    joint's bias, so that the decoded poses stay near rest, as a trained
    decoder's do."""
    d, ff, L, J = int(mg["latent_dim"]), int(mg["ff_size"]), int(mg["num_layers"]), int(mg["n_joints"])
    shapes = []
    for _ in range(L):
        shapes += [(3 * d, d), (d, d), (3 * d, d), (d, d), (ff, d), (d, ff)]
    shapes.append((6 * J, d))
    flat = torch.randn(sum(a * b for a, b in shapes), generator=gen, device=device)
    mats, k = [], 0
    for a, b in shapes:
        mats.append(flat[k:k + a * b].reshape(a, b) * b ** -0.5)
        k += a * b
    zeros = lambda n: torch.zeros(n, device=device)
    ln = lambda: {"scale": torch.ones(d, device=device), "bias": zeros(d)}
    mha = lambda w_in, w_out: {"in_w": w_in, "in_b": zeros(3 * d), "out_w": w_out, "out_b": zeros(d)}
    layers = []
    for i in range(L):
        m = mats[6 * i:6 * i + 6]
        layers.append({"self_attn": mha(m[0], m[1]), "ln1": ln(), "cross_attn": mha(m[2], m[3]), "ln2": ln(),
                       "fc1": {"w": m[4], "b": zeros(ff)}, "fc2": {"w": m[5], "b": zeros(d)}, "ln3": ln()})
    bias = torch.tensor(IDENTITY_6D, device=device).repeat(J)
    return {"dec_layers": layers, "dec_final": {"w": mats[-1] * OUTPUT_SCALE, "b": bias}}


def candidate_poses(n: int, std: float, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 63) body poses, every angle ~ N(0, std^2)."""
    return (torch.randn(n, 63, generator=gen) * std).to(device)


@contextlib.contextmanager
def half_frames():
    """Half of the step's CLIP frames left out: the first half rendered and
    encoded, each frame scored with the embedding of one of them."""
    from avatarclip_torch.pipelines import animate

    feature = animate.AnimateContext.pose_feature

    def half(self, pose, elevs, angles, soft):
        n = pose.shape[0]
        k = max(n // 2, 1)
        pf = feature(self, pose[:k], elevs, angles, soft)
        return pf[torch.arange(n, device=pf.device) * k // n]

    animate.AnimateContext.pose_feature = half
    try:
        yield
    finally:
        animate.AnimateContext.pose_feature = feature


FAULTS = {"half_frames": half_frames}
