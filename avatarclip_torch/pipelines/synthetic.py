"""Synthetic views, confs and a fitted stand-in pretrain for smoke runs
(twin of avatarclip_tpu/pipelines/synthetic.py, whose ``make_conf_text`` is
copied here unchanged in what it writes)."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.png import write_png


def write_synthetic_views(out_dir: str, n_views: int = 8, res: int = 64) -> str:
    """Circle silhouettes from an orbit of cameras, Blender layout."""
    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    frames = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = np.array([2.0 * np.sin(a), 0.0, 2.0 * np.cos(a)], np.float32)
        z = eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
        img = np.zeros((res, res, 3), np.uint8)
        yy, xx = np.mgrid[0:res, 0:res]
        img[(yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (res / 4) ** 2] = 255
        write_png(os.path.join(out_dir, "img", f"{i:04d}.png"), img)
        frames.append({"file_path": f"img/{i:04d}", "transform_matrix": m.tolist()})
    with open(os.path.join(out_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": float(np.deg2rad(60.0)), "frames": frames}, f)
    return out_dir


def smpl_size_body() -> tuple[np.ndarray, np.ndarray]:
    """A body mesh with SMPL's 6,890 vertices, all referenced, for ShapeGen's
    fixed-size VAE: the procedural humanoid at 40 segments x 28 ring
    vertices a capsule (6 x 41 x 28 = 6,888 vertices, 13,440 faces) and one
    small triangle on the top of the head that adds two vertices (13,441
    faces)."""
    from ..assets import _procedural_humanoid

    v, f = _procedural_humanoid(n_seg=40, n_ring=28)
    top = int(np.argmax(v[:, 1]))
    extra = v[top] + np.array([[0.01, 0.004, 0.0], [-0.01, 0.004, 0.0]], np.float32)
    n = len(v)
    return (np.concatenate([v, extra]).astype(np.float32),
            np.concatenate([f, [[top, n, n + 1]]]).astype(np.int32))


def humanoid_views(dev, n_views: int = 5, res: int = 224, seed: int = 0, elev_std: float = 0.3,
                   n_seg: int = 41, n_ring: int = 28):
    """The pose optimizer's views of the procedural body (at the default
    n_seg / n_ring, 13,776 faces: SMPL's count), posed as
    AnimateContext._pose_vertices poses it at the zero body pose, at the
    azimuths 120, 150, ... 240 (the first n_views) and elevations ~ N(0,
    elev_std): (vertices (n_views, V, 3), faces, poses (n_views, 4, 4), focal)."""
    from ..assets import _procedural_humanoid
    from ..body import smpl
    from ..render import cameras
    from . import animate

    v, f = _procedural_humanoid(n_seg=n_seg, n_ring=n_ring)
    model = smpl.approximate_model_from_mesh(v, f)
    go = torch.tensor([[np.pi / 2, 0.0, 0.0]])
    verts, _ = model.forward(body_pose=torch.zeros(1, 23, 3), global_orient=go)
    verts = (verts[0] @ torch.from_numpy(cameras.BODY_TO_WORLD).t()).to(dev)
    elevs = torch.randn(n_views, generator=torch.Generator().manual_seed(seed)) * elev_std
    azims = torch.tensor([120.0, 150.0, 180.0, 210.0, 240.0])[:n_views]
    poses = animate.view_poses(elevs.to(dev), azims.to(dev))
    focal = cameras.focal_from_fov(res, np.deg2rad(60.0))
    return verts.expand(n_views, -1, -1).contiguous(), torch.from_numpy(f).to(dev), poses, focal


def smpl_size_body_view(dev):
    """ShapeGen's 13,441-face body (SMPL's 6,890 vertices) and its 256^2
    camera: (vertices, faces, pose, focal)."""
    from ..render import cameras
    from . import shape

    v, f = smpl_size_body()
    return (torch.as_tensor(v @ cameras.BODY_TO_WORLD.T, device=dev), torch.as_tensor(f, device=dev).long(),
            shape._eye_pose(0.0, float(np.deg2rad(-20.0)), 2.2).to(dev),
            cameras.focal_from_fov(256, np.deg2rad(60.0)))


def zbuffer_scenes(runner, dev) -> dict:
    """The hard z-buffer's renders on the paths, by name, each (vertices,
    faces, pose, res, focal): the train_clip GT render (``runner``'s SMPL
    template, after ``init_smpl``, at 256^2), an animate scoring view (the
    13,776-face body at 224^2, azimuth 180), visualize's 512^2 picture of
    that body and a ShapeGen render (the 13,441-face body at 256^2)."""
    from . import visualize

    template_v, faces = runner._template
    cam, _ = runner.sample_iteration_camera(1, (256,))
    body_v, body_f, poses, focal = humanoid_views(dev, elev_std=0.0)
    vis_pose, vis_focal = visualize.camera(dev, 512)
    sv, sf, s_pose, s_focal = smpl_size_body_view(dev)
    return {"template 256^2": (template_v, faces, torch.as_tensor(cam["pose"], device=dev), 256,
                               runner.dataset.focal),
            "13,776-face body 224^2": (body_v[0], body_f, poses[2], 224, focal),
            "13,776-face body 512^2": (body_v[0], body_f, vis_pose, 512, vis_focal),
            "13,441-face body 256^2": (sv, sf, s_pose, 256, s_focal)}


def write_template_obj(data_dir: str, v: np.ndarray, f: np.ndarray) -> str:
    """Write a body as the zero-beta template OBJ, where both packages'
    ``assets.load_smpl`` look for it (under ``$AVATARCLIP_TPU_DATA``)."""
    path = os.path.join(data_dir, "zero_beta_smpl.obj")
    with open(path, "w") as fh:
        fh.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v)
        fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)
    return path


def make_conf_text(
    exp_dir: str,
    data_dir: str,
    scale: str = "tiny",  # tiny | small | full
    end_iter: int = 10,
    prompt: str = "a 3D rendering of a test person in unreal engine",
) -> str:
    if scale == "full":
        sdf = dict(d_out=257, d_hidden=256, n_layers=4, skip=4, multires=6,
                   use_pallas=True)
        color = dict(d_feature=256, d_hidden=256, n_layers=2)
        samples = dict(n_samples=32, n_importance=32, steps=4)
        max_ray = 112 * 112
        clip_model = "vit_b32"
        batch = 512
        # GT template renders at 256^2 (main.py:376) and the adaptive
        # silhouette-resolution ladder (dataset.py:252-275)
        extra = (
            "gt_render_res = 256\n"
            "    sil_buckets = [112, 134, 160, 192, 230, 256]"
        )
    elif scale == "small":
        sdf = dict(d_out=129, d_hidden=128, n_layers=3, skip=3, multires=6,
                   use_pallas=True)
        color = dict(d_feature=128, d_hidden=128, n_layers=1)
        samples = dict(n_samples=32, n_importance=32, steps=4)
        max_ray = 7000
        clip_model = "vit_b32"
        batch = 512
        extra = ""
    else:
        sdf = dict(d_out=17, d_hidden=16, n_layers=2, skip=5, multires=2)
        color = dict(d_feature=16, d_hidden=16, n_layers=2)
        samples = dict(n_samples=8, n_importance=8, steps=2)
        max_ray = 256
        clip_model = "tiny"
        batch = 64
        extra = "silhouette_res = 32\n    gt_render_res = 64\n    compute_dtype = float32"
    return f"""
general {{
    base_exp_dir = {exp_dir}
}}
dataset {{
    data_dir = {data_dir}
}}
train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = {end_iter}
    batch_size = {batch}
    max_ray_num = {max_ray}
    validate_resolution_level = 4
    warm_up_end = 500
    anneal_end = 0
    use_white_bkgd = False
    save_freq = 100000
    val_freq = 100000
    val_mesh_freq = 100000
    report_freq = 100
    igr_weight = 0.1
    mask_weight = 1.0
    clip_weight = 1.0
    add_no_texture = True
    texture_cast_light = True
    use_face_prompt = True
    use_back_prompt = True
    use_silhouettes = True
    head_height = 0.7
    seed = 0
    {extra}
}}
clip {{
    model = {clip_model}
    prompt = {prompt}
    face_prompt = a 3D rendering of the face of a test person in unreal engine
    back_prompt = a 3D rendering of the back of a test person in unreal engine
}}
model {{
    sdf_network {{
        d_out = {sdf['d_out']}
        d_in = 3
        d_hidden = {sdf['d_hidden']}
        n_layers = {sdf['n_layers']}
        skip_in = [{sdf['skip']}]
        multires = {sdf['multires']}
        use_pallas = {sdf.get('use_pallas', False)}
        bias = 0.5
        scale = 1.0
        geometric_init = True
        weight_norm = True
    }}
    variance_network {{
        init_val = 0.3
    }}
    rendering_network {{
        d_feature = {color['d_feature']}
        mode = no_view_dir
        d_in = 6
        d_out = 3
        d_hidden = {color['d_hidden']}
        n_layers = {color['n_layers']}
        weight_norm = True
        multires_view = 0
        squeeze_out = True
        extra_color = True
    }}
    neus_renderer {{
        n_samples = {samples['n_samples']}
        n_importance = {samples['n_importance']}
        n_outside = 0
        up_sample_steps = {samples['steps']}
        perturb = 1.0
        extra_color = True
    }}
}}
"""


def template_sdf(verts, normals, pts):
    """Signed distance of ``pts`` to a mesh, taken at its nearest vertex:
    |p - v|, negative where p lies behind v's (outward) normal."""
    out = []
    for a in range(0, pts.shape[0], 8192):
        p = pts[a:a + 8192]
        dist, idx = torch.cdist(p, verts).min(1)
        side = ((p - verts[idx]) * normals[idx]).sum(-1)
        out.append(torch.where(side < 0, -dist, dist))
    return torch.cat(out)


def fit_template_pretrain(runner, path: str, steps: int = 500, batch: int = 16384) -> float:
    """Fit ``runner``'s SDF net to its posed template body (``init_smpl``
    first), a stand-in for the confs' ``train.pretrain`` (a NeuS pretrained
    on the template, which the repo does not ship), and write the fields to
    ``path`` for ``train.pretrain``. An untrained net's surface is a mesh of
    wrinkles many times denser than a trained avatar's; the fitted one has
    an avatar's surface. L1 on half uniform points in [-1, 1]^3, half within
    ~2 cm of the template's vertices; returns the last step's loss."""
    verts, _ = runner._template
    normals = runner._template_normals
    dev = verts.device
    g = torch.Generator().manual_seed(0)
    sdf = runner.fields.sdf
    opt = torch.optim.Adam(sdf.parameters(), lr=1e-3)
    half = batch // 2
    for _ in range(steps):
        near = verts[torch.randint(verts.shape[0], (half,), generator=g).to(dev)]
        pts = torch.cat([(torch.rand(half, 3, generator=g) * 2 - 1).to(dev),
                         near + 0.02 * torch.randn(half, 3, generator=g).to(dev)])
        loss = (sdf.sdf(pts)[:, 0] - template_sdf(verts, normals, pts)).abs().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    from .appearance import save_reference_pth

    save_reference_pth(path, runner.fields)
    return float(loss.detach())


def make_runner(tmp_dir: str, scale: str = "tiny", res: int = 64, n_views: int = 4,
                device=None, mesh=None):
    """Self-contained Runner at the requested scale, on ``device`` (the card
    unless the caller asks for the CPU), or on the data group ``mesh``
    (parallel/mesh.py) and its device."""
    from .. import config as config_mod
    from .appearance import Runner

    data_dir = write_synthetic_views(os.path.join(tmp_dir, "views"), n_views=n_views, res=res)
    conf = config_mod.parse_string(
        make_conf_text(os.path.join(tmp_dir, "exp"), data_dir, scale)
    )
    return Runner(None, mode="none", conf=conf, device=device, mesh=mesh)
