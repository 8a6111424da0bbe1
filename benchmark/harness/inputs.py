"""Everything a cell's run takes as input, made from the seed: sub-seeds,
the stand-in body (a capsule humanoid at SMPL's 13,776 faces with an
approximate SMPL model around it), the synthetic view set, token ids, and
weights made on the device in a few large calls. Both the program and the
reference are handed these."""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import struct
import zlib

import numpy as np
import torch

SOT, EOT, CONTEXT = 49406, 49407, 77
SMPL_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
                         19, 20, 21], np.int32)


def sub_seeds(seed: int, n: int = 4) -> list[int]:
    """n independent 31-bit seeds derived from the run's seed."""
    return [int(s) & 0x7FFFFFFF for s in np.random.SeedSequence(int(seed)).generate_state(n)]


# -- the body ------------------------------------------------------------------


def humanoid(n_seg: int = 41, n_ring: int = 28) -> tuple[np.ndarray, np.ndarray]:
    """A capsule person (torso, head, legs, arms): 6 n_seg n_ring 2 faces."""
    verts, faces = [], []

    def capsule(p0, p1, radius):
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
                faces.extend([[a, b, d], [a, d, c2]])

    capsule([0, -0.3, 0], [0, 0.25, 0], 0.13)
    capsule([0, 0.28, 0], [0, 0.48, 0], 0.09)
    capsule([0.08, -0.3, 0], [0.1, -0.85, 0], 0.06)
    capsule([-0.08, -0.3, 0], [-0.1, -0.85, 0], 0.06)
    capsule([0.14, 0.2, 0], [0.5, 0.2, 0], 0.045)
    capsule([-0.14, 0.2, 0], [-0.5, 0.2, 0], 0.045)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


_JOINTS = np.array([
    [0.000, 0.570, 0.00], [0.065, 0.540, 0.00], [-0.065, 0.540, 0.00], [0.000, 0.640, 0.00],
    [0.075, 0.320, 0.00], [-0.075, 0.320, 0.00], [0.000, 0.700, 0.00], [0.080, 0.080, 0.00],
    [-0.080, 0.080, 0.00], [0.000, 0.760, 0.00], [0.090, 0.020, 0.06], [-0.090, 0.020, 0.06],
    [0.000, 0.860, 0.00], [0.045, 0.820, 0.00], [-0.045, 0.820, 0.00], [0.000, 0.920, 0.00],
    [0.105, 0.830, 0.00], [-0.105, 0.830, 0.00], [0.260, 0.830, 0.00], [-0.260, 0.830, 0.00],
    [0.410, 0.830, 0.00], [-0.410, 0.830, 0.00], [0.470, 0.830, 0.00], [-0.470, 0.830, 0.00],
], np.float32)


def body_model(n_seg: int = 41, n_ring: int = 28) -> dict:
    """An SMPL-layout model around the humanoid (numpy): 24 joints at
    canonical height fractions, each regressed as the mean of its 24
    nearest vertices, skinning weights falling off with the distance to the
    nearest bones (4 kept), no blend shapes."""
    v, f = humanoid(n_seg, n_ring)
    ymin, height = float(v[:, 1].min()), float(v[:, 1].max() - v[:, 1].min())
    j = _JOINTS.copy()
    j[:, 1] = ymin + j[:, 1] * height
    j[:, 0] = float(v[:, 0].mean()) + j[:, 0] * height
    j[:, 2] = float(v[:, 2].mean()) + j[:, 2] * height * 0.5
    V, J = len(v), 24
    near = np.argsort(np.linalg.norm(v[None] - j[:, None], axis=-1), axis=1)[:, :24]
    reg = np.zeros((J, V), np.float32)
    for k in range(J):
        reg[k, near[k]] = 1.0 / 24
    seg = np.full((V, J), np.inf, np.float32)
    for k in range(1, J):
        p, q = j[SMPL_PARENTS[k]], j[k]
        t = np.clip(((v - p) @ (q - p)) / (float((q - p) @ (q - p)) + 1e-9), 0.0, 1.0)
        d = np.linalg.norm(v - (p[None] + t[:, None] * (q - p)[None]), axis=-1)
        seg[:, k] = np.minimum(seg[:, k], d)
        seg[:, SMPL_PARENTS[k]] = np.minimum(seg[:, SMPL_PARENTS[k]], d)
    w = np.exp(-(seg ** 2) / (2 * (0.06 * height) ** 2))
    keep = np.zeros_like(w)
    np.put_along_axis(keep, np.argsort(-w, axis=1)[:, :4], 1.0, axis=1)
    w = w * keep
    w = (w / (w.sum(1, keepdims=True) + 1e-9)).astype(np.float32)
    return {"v_template": v, "shapedirs": np.zeros((V, 3, 10), np.float32),
            "posedirs": np.zeros((9 * (J - 1), V * 3), np.float32), "J_regressor": reg,
            "weights": w, "parents": SMPL_PARENTS.copy(), "faces": f}


def write_body(model: dict, path: str) -> str:
    """The model as an SMPL npz (v_template, shapedirs, posedirs,
    J_regressor, weights, kintree_table, f), compressed: its blend shapes
    are zeros."""
    np.savez_compressed(path, v_template=model["v_template"], shapedirs=model["shapedirs"],
             posedirs=model["posedirs"], J_regressor=model["J_regressor"], weights=model["weights"],
             kintree_table=np.stack([model["parents"], np.arange(24, dtype=np.int32)]),
             f=model["faces"])
    return path


def body_tensors(model: dict, device) -> dict:
    out = {k: torch.as_tensor(v, device=device) for k, v in model.items() if k != "parents"}
    out["parents"] = model["parents"]
    return out


# -- the view set ----------------------------------------------------------------


def _png(path: str, img: np.ndarray) -> None:
    H, W, _ = img.shape
    chunk = lambda t, d: struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(H))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_views(out_dir: str, n_views: int, res: int, fov_deg: float) -> tuple[str, float]:
    """An orbit of cameras at distance 2 with a disc silhouette each, in
    the Blender layout (transforms_train.json and img/*.png); returns the
    directory and the focal length in pixels."""
    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    yy, xx = np.mgrid[0:res, 0:res]
    img = np.zeros((res, res, 3), np.uint8)
    img[(yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (res / 4) ** 2] = 255
    frames = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = np.array([2.0 * np.sin(a), 0.0, 2.0 * np.cos(a)], np.float32)
        z = eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x = x / np.linalg.norm(x)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(z, x), z, eye
        _png(os.path.join(out_dir, "img", f"{i:04d}.png"), img)
        frames.append({"file_path": f"img/{i:04d}", "transform_matrix": m.tolist()})
    fov = math.radians(fov_deg)
    with open(os.path.join(out_dir, "transforms_train.json"), "w") as fh:
        json.dump({"camera_angle_x": fov, "frames": frames}, fh)
    return out_dir, 0.5 * res / float(np.tan(0.5 * fov))


# -- token ids ---------------------------------------------------------------------


def tokens(texts: list[str], device) -> torch.Tensor:
    """(N, 77) ids framed by start and end of text: each lower-cased word or
    punctuation mark hashed into the vocabulary (a stand-in for CLIP's BPE,
    whose merges file is not in the repository)."""
    out = np.zeros((len(texts), CONTEXT), np.int64)
    for i, t in enumerate(texts):
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", re.sub(r"\s+", " ", t).strip().lower())
        ids = [1000 + int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little") % (SOT - 2000)
               for w in words]
        ids = [SOT] + ids[:CONTEXT - 2] + [EOT]
        out[i, :len(ids)] = ids
    return torch.as_tensor(out, device=device)


# -- weights ----------------------------------------------------------------------------


def _split(flat: torch.Tensor, shapes: list[tuple[int, ...]]) -> list[torch.Tensor]:
    out, a = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[a:a + n].reshape(s))
        a += n
    return out


def clip_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """CLIP's tree with every weight drawn from one normal sample on the
    device: linear weights scaled by width^-1/2, embeddings by 0.02, the
    positions by 0.01; layer norms (1, 0) and biases 0."""
    vw, tw, E = int(cfg["vision_width"]), int(cfg["text_width"]), int(cfg["embed_dim"])
    P, T = int(cfg["patch_size"]), (int(cfg["image_size"]) // int(cfg["patch_size"])) ** 2 + 1
    specs = []  # (path, shape, scale)

    def blocks(prefix, w, n):
        for i in range(n):
            for name, shape in (("attn.in_w", (3 * w, w)), ("attn.out_w", (w, w)),
                                ("mlp.fc_w", (4 * w, w)), ("mlp.proj_w", (w, 4 * w))):
                specs.append((f"{prefix}.{i}.{name}", shape, w ** -0.5))

    specs += [("visual.patch_w", (3 * P * P, vw), 0.02), ("visual.class_embedding", (vw,), 0.02),
              ("visual.pos_embed", (T, vw), 0.01), ("visual.proj", (vw, E), vw ** -0.5)]
    blocks("visual.blocks", vw, int(cfg["vision_layers"]))
    specs += [("text.token_embedding", (int(cfg["vocab_size"]), tw), 0.02),
              ("text.pos_embed", (int(cfg["context_length"]), tw), 0.01),
              ("text.text_projection", (tw, E), tw ** -0.5)]
    blocks("text.blocks", tw, int(cfg["text_layers"]))
    total = sum(int(np.prod(s)) for _, s, _ in specs)
    flat = torch.randn(total, generator=gen, device=device)
    drawn = {p: t * sc for (p, _, sc), t in zip(specs, _split(flat, [s for _, s, _ in specs]))}
    ln = lambda w: {"scale": torch.ones(w, device=device), "bias": torch.zeros(w, device=device)}

    def tower(prefix, w, n):
        return [{"ln_1": ln(w), "ln_2": ln(w),
                 "attn": {"in_w": drawn[f"{prefix}.{i}.attn.in_w"], "in_b": torch.zeros(3 * w, device=device),
                          "out_w": drawn[f"{prefix}.{i}.attn.out_w"], "out_b": torch.zeros(w, device=device)},
                 "mlp": {"fc_w": drawn[f"{prefix}.{i}.mlp.fc_w"], "fc_b": torch.zeros(4 * w, device=device),
                         "proj_w": drawn[f"{prefix}.{i}.mlp.proj_w"], "proj_b": torch.zeros(w, device=device)}}
                for i in range(n)]

    return {"visual": {"patch_w": drawn["visual.patch_w"], "class_embedding": drawn["visual.class_embedding"],
                       "pos_embed": drawn["visual.pos_embed"], "ln_pre": ln(vw),
                       "blocks": tower("visual.blocks", vw, int(cfg["vision_layers"])), "ln_post": ln(vw),
                       "proj": drawn["visual.proj"]},
            "text": {"token_embedding": drawn["text.token_embedding"], "pos_embed": drawn["text.pos_embed"],
                     "blocks": tower("text.blocks", tw, int(cfg["text_layers"])), "ln_final": ln(tw),
                     "text_projection": drawn["text.text_projection"]},
            "logit_scale": torch.tensor(math.log(1 / 0.07), device=device)}


def neus_weights(model_cfg: dict, gen: torch.Generator, device) -> dict:
    """NeuS's initial fields, weight-normed, in the checkpoint's paths: the
    SDF net's geometric init (a sphere of radius ``bias``; the encoding's
    columns of the first layer and the skip's zero), the colour net's
    uniform(+-1/sqrt(in)) init, the variance at ``init_val``."""
    s, c = model_cfg["sdf_network"], model_cfg["rendering_network"]
    E = 3 * (1 + 2 * int(s["multires"]))
    dims = [E] + [int(s["d_hidden"])] * int(s["n_layers"]) + [int(s["d_out"])]
    skips = tuple(s["skip_in"])
    out = {}

    def put(prefix, w, b):
        g = w.norm(dim=1, keepdim=True)
        out[prefix + ".g"], out[prefix + ".v"], out[prefix + ".b"] = g, w, b

    n = len(dims) - 1
    for l in range(n):
        d_out = dims[l + 1] - E if (l + 1) in skips else dims[l + 1]
        d_in = dims[l]
        if l == n - 1:
            w = math.sqrt(math.pi) / math.sqrt(d_in) + 1e-4 * torch.randn(d_out, d_in, generator=gen, device=device)
            b = torch.full((d_out,), -float(s["bias"]), device=device)
        else:
            w = torch.randn(d_out, d_in, generator=gen, device=device) * math.sqrt(2.0 / d_out)
            if l == 0:
                w[:, 3:] = 0.0
            elif l in skips:
                w[:, -(E - 3):] = 0.0
            b = torch.zeros(d_out, device=device)
        put(f"sdf.layers.{l}", w, b)
    cd = [6 + int(c["d_feature"])] + [int(c["d_hidden"])] * int(c["n_layers"]) + [int(c["d_out"])]

    def uniform(d_out, d_in):
        bound = 1.0 / math.sqrt(d_in)
        return ((torch.rand(d_out, d_in, generator=gen, device=device) * 2 - 1) * bound,
                (torch.rand(d_out, generator=gen, device=device) * 2 - 1) * bound)

    for l in range(len(cd) - 1):
        put(f"color.layers.{l}", *uniform(cd[l + 1], cd[l]))
    if c.get("extra_color"):
        put("color.extra", *uniform(int(c["d_out"]), cd[-2]))
    out["variance.variance"] = torch.tensor(float(model_cfg["variance_network"]["init_val"]), device=device)
    return out


def fit_sdf(weights: dict, sdf_cfg: dict, verts: torch.Tensor, normals: torch.Tensor, steps: int,
            batch: int, gen: torch.Generator) -> dict:
    """The SDF net fitted to a body (a stand-in for the pretrained
    template net of AvatarCLIP's confs): Adam at 1e-3 on the L1 error to
    the distance to the nearest vertex, signed by its normal, at half
    uniform points in [-1, 1]^3 and half within ~2 cm of the vertices.
    Plain float32; returns the weights with the SDF leaves replaced."""
    from ..reference import nets

    dev = verts.device
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items() if k.startswith("sdf.")}
    opt = torch.optim.Adam(leaves.values(), lr=1e-3)
    half = batch // 2
    for _ in range(steps):
        near = verts[torch.randint(verts.shape[0], (half,), generator=gen, device=dev)]
        pts = torch.cat([torch.rand(half, 3, generator=gen, device=dev) * 2 - 1,
                         near + 0.02 * torch.randn(half, 3, generator=gen, device=dev)])
        with torch.no_grad():
            dist, idx = torch.cdist(pts, verts).min(1)
            side = ((pts - verts[idx]) * normals[idx]).sum(-1)
            target = torch.where(side < 0, -dist, dist)
        loss = (nets.sdf_forward(leaves, sdf_cfg, pts, sdf_only=True)[:, 0] - target).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    out = dict(weights)
    out.update({k: v.detach() for k, v in leaves.items()})
    return out


def reference_pth(weights: dict) -> dict:
    """The weights in the layout of a NeuS checkpoint (lin{i}.weight_g,
    weight_v, bias; extra_lin.*; the variance), on the CPU."""
    def net(prefix, extra):
        sd, i = {}, 0
        while f"{prefix}.layers.{i}.b" in weights:
            for k, src in (("g", "weight_g"), ("v", "weight_v"), ("b", "bias")):
                sd[f"lin{i}.{src}"] = weights[f"{prefix}.layers.{i}.{k}"].detach().cpu()
            i += 1
        if extra and f"{prefix}.extra.b" in weights:
            for k, src in (("g", "weight_g"), ("v", "weight_v"), ("b", "bias")):
                sd[f"extra_lin.{src}"] = weights[f"{prefix}.extra.{k}"].detach().cpu()
        return sd

    return {"sdf_network_fine": net("sdf", False), "color_network_fine": net("color", True),
            "variance_network_fine": {"variance": weights["variance.variance"].detach().cpu()}}


def conf(sections: dict):
    """The program's Conf holding ``sections`` ({dotted key: value})."""
    from avatarclip_torch import config as config_mod

    c = config_mod.parse_string("")
    for k, v in sections.items():
        c.put(k, v)
    return c


def flatten(tree: dict, prefix: str = "") -> dict:
    """{"a": {"b": 1}} -> {"a.b": 1}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out
