"""ACTOR-style motion VAE: transformer encoder / decoder (twin of
avatarclip_tpu/pipelines/motion_vae.py).

The reference's pretrained motion VAE (AvatarAnimate/models/
motion_generation.py:140-246): 55 joints x 6d rotations per frame, 60-frame
sequences, latent 256, 4 heads, post-LN blocks with the semantics of
torch.nn.TransformerEncoder/DecoderLayer, so the published checkpoint maps
weight for weight. Parameters are the JAX package's nested dict of tensors;
the matrix products are plain ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MotionVAEConfig:
    seq_len: int = 60
    n_joints: int = 55
    latent_dim: int = 256
    num_heads: int = 4
    ff_size: int = 1024
    num_layers: int = 4

    @property
    def input_feats(self) -> int:
        return self.n_joints * 6


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model), the reference's positional encoding."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def _dense(g, dout, din):
    bound = 1.0 / np.sqrt(din)
    return {"w": (torch.rand(dout, din, generator=g) * 2 - 1) * bound,
            "b": (torch.rand(dout, generator=g) * 2 - 1) * bound}


def _apply(p, x):
    return x @ p["w"].t() + p["b"]


def _ln(p, x):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _init_ln(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _init_mha(g, d):
    s = d ** -0.5
    return {"in_w": torch.randn(3 * d, d, generator=g) * s, "in_b": torch.zeros(3 * d),
            "out_w": torch.randn(d, d, generator=g) * s, "out_b": torch.zeros(d)}


def _mha(p, q_in, kv_in, n_heads):
    d = q_in.shape[-1]
    hd = d // n_heads
    wq, wk, wv = p["in_w"].chunk(3, 0)
    bq, bk, bv = p["in_b"].chunk(3, 0)
    q, k, v = q_in @ wq.t() + bq, kv_in @ wk.t() + bk, kv_in @ wv.t() + bv

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads, hd).transpose(-3, -2)

    q, k, v = heads(q), heads(k), heads(v)
    att = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(hd), dim=-1)
    out = (att @ v).transpose(-3, -2).reshape(q_in.shape)
    return out @ p["out_w"].t() + p["out_b"]


def _enc_layer(p, x, n_heads):
    x = _ln(p["ln1"], x + _mha(p["attn"], x, x, n_heads))  # post-LN
    ff = _apply(p["fc2"], F.gelu(_apply(p["fc1"], x)))
    return _ln(p["ln2"], x + ff)


def _dec_layer(p, tgt, memory, n_heads):
    tgt = _ln(p["ln1"], tgt + _mha(p["self_attn"], tgt, tgt, n_heads))
    tgt = _ln(p["ln2"], tgt + _mha(p["cross_attn"], tgt, memory, n_heads))
    ff = _apply(p["fc2"], F.gelu(_apply(p["fc1"], tgt)))
    return _ln(p["ln3"], tgt + ff)


def init_params(generator: torch.Generator, cfg: MotionVAEConfig) -> dict:
    g, d = generator, cfg.latent_dim

    def enc_layer():
        return {"attn": _init_mha(g, d), "ln1": _init_ln(d), "fc1": _dense(g, cfg.ff_size, d),
                "fc2": _dense(g, d, cfg.ff_size), "ln2": _init_ln(d)}

    def dec_layer():
        return {"self_attn": _init_mha(g, d), "ln1": _init_ln(d), "cross_attn": _init_mha(g, d),
                "ln2": _init_ln(d), "fc1": _dense(g, cfg.ff_size, d),
                "fc2": _dense(g, d, cfg.ff_size), "ln3": _init_ln(d)}

    return {
        "skel_embed": _dense(g, d, cfg.input_feats),
        "query": torch.randn(1, d, generator=g),
        "enc_layers": [enc_layer() for _ in range(cfg.num_layers)],
        "enc_final": _dense(g, d, d),
        "dec_layers": [dec_layer() for _ in range(cfg.num_layers)],
        "dec_final": _dense(g, cfg.input_feats, d),
        "pe": torch.from_numpy(sinusoidal_pe(5000, d)),
    }


def encode(params: dict, cfg: MotionVAEConfig, motion: torch.Tensor) -> torch.Tensor:
    """(B, T, 55, 6) -> (B, latent): query-token pooled transformer encoding."""
    B, T = motion.shape[:2]
    x = _apply(params["skel_embed"], motion.reshape(B, T, -1))
    query = params["query"].expand(B, 1, cfg.latent_dim)
    x = torch.cat([query, x], 1) + params["pe"][: T + 1][None]
    for lp in params["enc_layers"]:
        x = _enc_layer(lp, x, cfg.num_heads)
    return _apply(params["enc_final"], x[:, 0])


def decode(params: dict, cfg: MotionVAEConfig, latent: torch.Tensor) -> torch.Tensor:
    """(B, latent) -> (B, T, 55, 6)."""
    B, T = latent.shape[0], cfg.seq_len
    x = params["pe"][:T][None].expand(B, T, cfg.latent_dim)
    memory = latent[:, None, :]
    for lp in params["dec_layers"]:
        x = _dec_layer(lp, x, memory, cfg.num_heads)
    return _apply(params["dec_final"], x).reshape(B, T, cfg.n_joints, 6)


def convert_torch_ckpt(path: str, cfg: MotionVAEConfig) -> dict:
    """Map the reference motion_vae.pth (ACTOR layout) onto the parameter tree."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: torch.as_tensor(v).float() for k, v in data.get("state_dict", data).items()}

    def dense(prefix):
        return {"w": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def mha(prefix):
        return {"in_w": sd[prefix + ".in_proj_weight"], "in_b": sd[prefix + ".in_proj_bias"],
                "out_w": sd[prefix + ".out_proj.weight"], "out_b": sd[prefix + ".out_proj.bias"]}

    enc_layers, dec_layers = [], []
    for i in range(cfg.num_layers):
        e = f"encoder.seqTransEncoder.layers.{i}"
        enc_layers.append({"attn": mha(e + ".self_attn"), "ln1": ln(e + ".norm1"),
                           "fc1": dense(e + ".linear1"), "fc2": dense(e + ".linear2"),
                           "ln2": ln(e + ".norm2")})
        d = f"decoder.seqTransDecoder.layers.{i}"
        dec_layers.append({"self_attn": mha(d + ".self_attn"), "ln1": ln(d + ".norm1"),
                           "cross_attn": mha(d + ".multihead_attn"), "ln2": ln(d + ".norm2"),
                           "fc1": dense(d + ".linear1"), "fc2": dense(d + ".linear2"),
                           "ln3": ln(d + ".norm3")})
    return {
        "skel_embed": dense("encoder.skelEmbedding"), "query": sd["encoder.query"],
        "enc_layers": enc_layers, "enc_final": dense("encoder.final"),
        "dec_layers": dec_layers, "dec_final": dense("decoder.final"),
        "pe": torch.from_numpy(sinusoidal_pe(5000, cfg.latent_dim)),
    }
