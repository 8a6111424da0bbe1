"""VPoser v2, the 32-d human pose prior VAE (twin of avatarclip_tpu/body/vposer.py).

The reference loads the pretrained VPoser from ``human_body_prior``
(reference: AvatarAnimate/models/pose_generation.py:42-47). Architecture:

  encoder: BN(63) -> Linear(63,512) -> LeakyReLU -> BN(512) -> [Dropout]
           -> Linear(512,512) -> Linear(512,512) -> (mu 32, logvar 32)
  decoder: Linear(32,512) -> LeakyReLU -> [Dropout] -> Linear(512,512)
           -> LeakyReLU -> Linear(512, 21*6) -> rot6d -> matrices -> axis-angle

Parameters are the JAX package's nested dict (``enc_bn``, ``enc1``, ...) of
tensors, so a JAX pytree carries across (utils/convert.params_from_jax).
Without the snapshot a seeded random init keeps the pipelines runnable.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import rotations

NUM_JOINTS = 21
LATENT_DIM = 32
HIDDEN = 512


def _dense(g: torch.Generator, dout: int, din: int) -> dict:
    bound = 1.0 / np.sqrt(din)
    return {"w": (torch.rand(dout, din, generator=g) * 2 - 1) * bound,
            "b": (torch.rand(dout, generator=g) * 2 - 1) * bound}


def _bn_init(d: int) -> dict:
    return {"scale": torch.ones(d), "bias": torch.zeros(d), "mean": torch.zeros(d),
            "var": torch.ones(d)}


def init_params(generator: torch.Generator) -> dict:
    d_in = NUM_JOINTS * 3
    return {
        "enc_bn": _bn_init(d_in),
        "enc1": _dense(generator, HIDDEN, d_in),
        "enc_bn2": _bn_init(HIDDEN),
        "enc2a": _dense(generator, HIDDEN, HIDDEN),
        "enc2b": _dense(generator, HIDDEN, HIDDEN),
        "mu": _dense(generator, LATENT_DIM, HIDDEN),
        "logvar": _dense(generator, LATENT_DIM, HIDDEN),
        "dec1": _dense(generator, HIDDEN, LATENT_DIM),
        "dec2": _dense(generator, HIDDEN, HIDDEN),
        "out": _dense(generator, NUM_JOINTS * 6, HIDDEN),
    }


def _apply(p, x):
    return x @ p["w"].t() + p["b"]


def _bn(p, x):
    return (x - p["mean"]) / torch.sqrt(p["var"] + 1e-5) * p["scale"] + p["bias"]


def encode(params: dict, pose_body: torch.Tensor):
    """(N, 63) axis-angle body pose -> (mu (N, 32), logvar (N, 32)); the
    layer order of human_body_prior's VPoser v2 encoder_net, with its two
    consecutive linears."""
    x = _bn(params["enc_bn"], pose_body)
    x = F.leaky_relu(_apply(params["enc1"], x), 0.01)
    x = _bn(params["enc_bn2"], x)
    x = _apply(params["enc2b"], _apply(params["enc2a"], x))
    return _apply(params["mu"], x), _apply(params["logvar"], x)


def decode(params: dict, z: torch.Tensor) -> torch.Tensor:
    """(N, 32) latent -> (N, 63) axis-angle body pose (eval mode: no dropout)."""
    x = F.leaky_relu(_apply(params["dec1"], z), 0.01)
    x = F.leaky_relu(_apply(params["dec2"], x), 0.01)
    d6 = _apply(params["out"], x).reshape(-1, NUM_JOINTS, 6)
    aa = rotations.matrix_to_axis_angle(rotations.rotation_6d_to_matrix(d6))
    return aa.reshape(z.shape[0], NUM_JOINTS * 3)


def convert_torch_ckpt(path: str) -> dict:
    """Map an official VPoser v2 snapshot onto the parameter tree."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.replace("vp_model.", ""): torch.as_tensor(v).float() for k, v in sd.items()}

    def dense(prefix):
        return {"w": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}

    def bn(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"],
                "mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}

    # encoder_net = [BatchFlatten(0), BatchNorm1d(1), Linear(2), LeakyReLU(3),
    #                BatchNorm1d(4), Dropout(5), Linear(6), Linear(7),
    #                NormalDistDecoder(8).{mu,logvar}]
    # decoder_net = [Linear(0), LeakyReLU(1), Dropout(2), Linear(3),
    #                LeakyReLU(4), Linear(5), ContinousRotReprDecoder(6)]
    return {
        "enc_bn": bn("encoder_net.1"), "enc1": dense("encoder_net.2"),
        "enc_bn2": bn("encoder_net.4"), "enc2a": dense("encoder_net.6"),
        "enc2b": dense("encoder_net.7"), "mu": dense("encoder_net.8.mu"),
        "logvar": dense("encoder_net.8.logvar"), "dec1": dense("decoder_net.0"),
        "dec2": dense("decoder_net.3"), "out": dense("decoder_net.5"),
    }


def load_pretrained(path: str | None = None):
    """(params, pretrained): a converted npz (the JAX pytree) or the official
    snapshot when found, else the seeded random init."""
    from .. import assets
    from ..utils.convert import params_from_jax

    p = path or assets.find("vposer.npz")
    if p and p.endswith(".npz"):
        with np.load(p) as data:
            return params_from_jax(dict(data)), True
    ck = path or assets.find("vposer_v02.ckpt")
    if ck:
        return convert_torch_ckpt(ck), True
    return init_params(torch.Generator().manual_seed(7)), False
