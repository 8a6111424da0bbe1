"""Convert pretrained CLIP PyTorch checkpoints to the npz that
``clip/model.load_npz`` reads (twin of avatarclip_tpu/clipjax/convert.py,
numpy and torch only; the two write the same arrays under the same keys).

Two source layouts:

  * OpenAI ``clip`` state dicts (what the reference loads with
    ``clip.load('ViT-B/32')``): keys like ``visual.transformer.resblocks.0...``
  * HuggingFace ``CLIPModel`` state dicts: keys like
    ``vision_model.encoder.layers.0...``

The tree is the one ``clip/model.py`` computes with (``visual``, ``text``,
``logit_scale``), stored flattened with ``a/b/0/c`` path keys.
"""

from __future__ import annotations

import numpy as np

from ..utils.pytree import tree_flatten_paths
from .model import VIT_B32, CLIPConfig


def save_npz(params, path: str) -> None:
    np.savez_compressed(path, **tree_flatten_paths(params))


def _to_numpy(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _block(g, names: dict) -> dict:
    """One residual block from the getter ``g`` and the layout's names."""
    return {
        "ln_1": {"scale": g(names["ln_1"] + ".weight"), "bias": g(names["ln_1"] + ".bias")},
        "attn": {"in_w": names["in_w"](g), "in_b": names["in_b"](g),
                 "out_w": g(names["out"] + ".weight"), "out_b": g(names["out"] + ".bias")},
        "ln_2": {"scale": g(names["ln_2"] + ".weight"), "bias": g(names["ln_2"] + ".bias")},
        "mlp": {"fc_w": g(names["fc"] + ".weight"), "fc_b": g(names["fc"] + ".bias"),
                "proj_w": g(names["proj"] + ".weight"), "proj_b": g(names["proj"] + ".bias")},
    }


_OPENAI_BLOCK = {
    "ln_1": "ln_1", "ln_2": "ln_2", "out": "attn.out_proj", "fc": "mlp.c_fc", "proj": "mlp.c_proj",
    "in_w": lambda g: g("attn.in_proj_weight"), "in_b": lambda g: g("attn.in_proj_bias"),
}
_HF_BLOCK = {
    "ln_1": "layer_norm1", "ln_2": "layer_norm2", "out": "self_attn.out_proj", "fc": "mlp.fc1",
    "proj": "mlp.fc2",
    "in_w": lambda g: np.concatenate([g(f"self_attn.{x}_proj.weight") for x in "qkv"], axis=0),
    "in_b": lambda g: np.concatenate([g(f"self_attn.{x}_proj.bias") for x in "qkv"], axis=0),
}


def _blocks(sd: dict, prefix: str, n: int, names: dict) -> list:
    return [_block(lambda k, p=f"{prefix}{i}.": sd[p + k], names) for i in range(n)]


def _patch_w(conv: np.ndarray) -> np.ndarray:
    """conv1 weight (width, 3, P, P) -> (P * P * 3, width), the patchify's order."""
    return conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])


def from_openai_state_dict(sd: dict, cfg: CLIPConfig = VIT_B32) -> dict:
    """OpenAI clip ViT state dict (tensors or arrays) -> the parameter tree."""
    sd = _to_numpy(sd)
    ln = lambda k: {"scale": sd[k + ".weight"], "bias": sd[k + ".bias"]}
    return {
        "visual": {
            "patch_w": _patch_w(sd["visual.conv1.weight"]),
            "class_embedding": sd["visual.class_embedding"],
            "pos_embed": sd["visual.positional_embedding"],
            "ln_pre": ln("visual.ln_pre"),
            "blocks": _blocks(sd, "visual.transformer.resblocks.", cfg.vision_layers, _OPENAI_BLOCK),
            "ln_post": ln("visual.ln_post"),
            "proj": sd["visual.proj"],
        },
        "text": {
            "token_embedding": sd["token_embedding.weight"],
            "pos_embed": sd["positional_embedding"],
            "blocks": _blocks(sd, "transformer.resblocks.", cfg.text_layers, _OPENAI_BLOCK),
            "ln_final": ln("ln_final"),
            "text_projection": sd["text_projection"],
        },
        "logit_scale": np.asarray(sd["logit_scale"], np.float32),
    }


def from_hf_state_dict(sd: dict, cfg: CLIPConfig = VIT_B32) -> dict:
    """HuggingFace CLIPModel state dict -> the parameter tree."""
    sd = _to_numpy(sd)
    ln = lambda k: {"scale": sd[k + ".weight"], "bias": sd[k + ".bias"]}
    return {
        "visual": {
            "patch_w": _patch_w(sd["vision_model.embeddings.patch_embedding.weight"]),
            "class_embedding": sd["vision_model.embeddings.class_embedding"],
            "pos_embed": sd["vision_model.embeddings.position_embedding.weight"],
            "ln_pre": ln("vision_model.pre_layrnorm"),
            "blocks": _blocks(sd, "vision_model.encoder.layers.", cfg.vision_layers, _HF_BLOCK),
            "ln_post": ln("vision_model.post_layernorm"),
            "proj": sd["visual_projection.weight"].T,
        },
        "text": {
            "token_embedding": sd["text_model.embeddings.token_embedding.weight"],
            "pos_embed": sd["text_model.embeddings.position_embedding.weight"],
            "blocks": _blocks(sd, "text_model.encoder.layers.", cfg.text_layers, _HF_BLOCK),
            "ln_final": ln("text_model.final_layer_norm"),
            "text_projection": sd["text_projection.weight"].T,
        },
        "logit_scale": np.asarray(sd["logit_scale"], np.float32),
    }


def convert_checkpoint(src_path: str, dst_npz: str) -> None:
    """Detect the layout of the checkpoint at ``src_path``, convert it and
    write ``dst_npz``."""
    import torch

    obj = torch.load(src_path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        sd = obj
    keys = set(sd.keys())
    if any(k.startswith("visual.conv1") for k in keys):
        params = from_openai_state_dict(sd)
    elif any(k.startswith("vision_model.") for k in keys):
        params = from_hf_state_dict(sd)
    else:
        raise ValueError("unrecognized CLIP checkpoint layout")
    save_npz(params, dst_npz)
