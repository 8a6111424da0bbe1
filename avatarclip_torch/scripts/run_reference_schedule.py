"""Run the reference's schedules end to end through the port (twin of
scripts/run_reference_schedule.py: the same confs, flags, stages and
``schedule_log.jsonl`` rows, plus ``--device``).

Stages (chainable; each appends its wall seconds and metrics to
<exp_root>/schedule_log.jsonl):

  shape     ShapeGen retrieval and its own 108-view render (the
            self-generated-data route, reference ShapeGen/main.py +
            render.py:109-139): <exp_root>/shape/coarse.obj and
            <exp_root>/shape/render/, which pretrain and sculpt read through
            --data_dir / --template_obj.
  pretrain  the photometric NeuS fit at the astrongman base-model schedule
            (256-wide nets, batch 5120, reference
            confs/base_models/astrongman.conf) on the 108-view render,
            written as full_pretrain.npz in the JAX package's pytree layout
            (params/sdf/...); --pretrain_iters bounds it.
  sculpt    the flagship train_clip run at the ironman conf (sil_buckets
            ladder, face / back prompts, background augmentation,
            gt_render_res 256) from the pretrain (reference
            main.py:346-347), with a CLIP score of 8 views (and the face
            camera) before and after.
  extract   --mode validate_mesh: the --mcube_resolution extraction with the
            6-axis vertex colour baking, and the cast-light render
            (main.py:850-919, :634-739).
  export    the extracted avatar driven by a motion -> .pc2, and the rigged
            GLB (reference drive.py and Avatar2FBX).
  pose      the four pose strategies at reference defaults
            (AvatarAnimate/models/pose_generation.py).
  motion    both motion generators at reference defaults
            (motion_generation.py:306-358).

Usage:
  python -m avatarclip_torch.scripts.run_reference_schedule --stage pretrain --pretrain_iters 300000
  python -m avatarclip_torch.scripts.run_reference_schedule --stage sculpt
  python -m avatarclip_torch.scripts.run_reference_schedule --stage extract
  python -m avatarclip_torch.scripts.run_reference_schedule --stage export

The experiment root defaults to exp/reference_schedule_torch, so the two
packages' chains do not collide; rows are written there only.
"""

from __future__ import annotations

import argparse
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXP_ROOT = os.path.join(REPO, "exp", "reference_schedule_torch")

PRETRAIN_CONF = """
general {{
    base_exp_dir = {exp}/pretrain
}}
dataset {{
    data_dir = {data_dir}
}}
train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = {iters}
    batch_size = 5120
    validate_resolution_level = 1
    warm_up_end = 5000
    anneal_end = 0
    use_white_bkgd = False
    save_freq = 10000
    val_freq = {val_freq}
    val_mesh_freq = {val_mesh_freq}
    report_freq = 500
    igr_weight = 0.1
    mask_weight = 0.5
    seed = 0
}}
model {{
    sdf_network {{
        d_out = 257
        d_in = 3
        d_hidden = 256
        n_layers = 4
        skip_in = [4]
        multires = 6
        use_pallas = True
        bias = 0.5
        scale = 1.0
        geometric_init = True
        weight_norm = True
    }}
    variance_network {{
        init_val = 0.3
    }}
    rendering_network {{
        d_feature = 256
        mode = no_view_dir
        d_in = 6
        d_out = 3
        d_hidden = 256
        n_layers = 2
        weight_norm = True
        multires_view = 0
        squeeze_out = True
        extra_color = True
    }}
    neus_renderer {{
        n_samples = 32
        n_importance = 32
        n_outside = 0
        up_sample_steps = 4
        perturb = 1.0
        extra_color = True
    }}
}}
"""

SCULPT_CONF = """
general {{
    base_exp_dir = {exp}/sculpt
    pose_type = {pose_type}
}}
dataset {{
    data_dir = {data_dir}
{template_obj_line}
}}
train {{
    learning_rate = 5e-4
    learning_rate_alpha = 0.05
    end_iter = 100000
    batch_size = 512
    max_ray_num = 12544
    validate_resolution_level = 1
    warm_up_end = 500
    anneal_end = 0
    use_white_bkgd = False
    save_freq = 1000
    val_freq = 100
    val_mesh_freq = 500
    report_freq = 100
    igr_weight = 0.1
    mask_weight = 0.5
    clip_weight = 1.0
    pretrain = {pretrain}
    add_no_texture = True
    texture_cast_light = True
    use_face_prompt = True
    use_back_prompt = True
    use_silhouettes = True
    use_bg_aug = True
    gt_render_res = 256
    sil_buckets = [112, 134, 160, 192, 230, 256]
    head_height = 0.65
    seed = 0
}}
clip {{
    prompt = a 3D rendering of the Iron Man in unreal engine
    face_prompt = a 3D rendering of the face of Iron Man in unreal engine
    back_prompt = a 3D rendering of the back of Iron Man in unreal engine
}}
model {{
    sdf_network {{
        d_out = 257
        d_in = 3
        d_hidden = 256
        n_layers = 4
        skip_in = [4]
        multires = 6
        use_pallas = True
        bias = 0.5
        scale = 1.0
        geometric_init = True
        weight_norm = True
    }}
    variance_network {{
        init_val = 0.3
    }}
    rendering_network {{
        d_feature = 256
        mode = no_view_dir
        d_in = 6
        d_out = 3
        d_hidden = 256
        n_layers = 2
        weight_norm = True
        multires_view = 0
        squeeze_out = True
        extra_color = True
    }}
    neus_renderer {{
        n_samples = 32
        n_importance = 32
        n_outside = 0
        up_sample_steps = 4
        perturb = 1.0
        extra_color = True
    }}
}}
"""


def log_stage(exp, stage, record):
    """Append one row to ``exp/schedule_log.jsonl`` and print it."""
    os.makedirs(exp, exist_ok=True)
    record = {"stage": stage, "time": time.strftime("%Y-%m-%d %H:%M:%S"), **record}
    with open(os.path.join(exp, "schedule_log.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
    print(json.dumps(record))


def make_runner(conf_text, mode, is_continue=False, device=None):
    """A Runner on the conf text, resumed from the latest checkpoint under
    its base_exp_dir when ``is_continue``."""
    from .. import config as config_mod
    from ..pipelines import appearance

    conf = config_mod.parse_string(conf_text)
    r = appearance.Runner(None, mode=mode, conf=conf, device=device)
    if is_continue:
        latest = appearance.latest_checkpoint(conf.get_string("general.base_exp_dir"), 10**9)
        if latest:
            r.load_checkpoint(latest)
    return r


def _sculpt_conf(args, pretrain):
    tmpl = f"    template_obj = {args.template_obj}" if args.template_obj else ""
    return SCULPT_CONF.format(exp=EXP_ROOT, pretrain=pretrain,
                              data_dir=args.sculpt_data_dir or args.data_dir,
                              pose_type=args.pose_type, template_obj_line=tmpl)


def stage_shape(args):
    """ShapeGen retrieval and the own 108-view render (the self-generated
    route): {exp}/shape/coarse.obj and {exp}/shape/render/ (108 PNGs and
    transforms_train.json), for --data_dir / --template_obj."""
    import numpy as np

    from .. import assets
    from ..export import mesh_io
    from ..pipelines import shape as shape_mod

    out = os.path.join(EXP_ROOT, "shape")
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    v, f, _ = shape_mod.shape_gen("a 3d rendering of a person in unreal engine", args.shape_text,
                                  device=args.device)
    obj_path = os.path.join(out, "coarse.obj")
    mesh_io.write_obj(obj_path, v, f)
    t_gen = time.time() - t0

    t1 = time.time()
    pose = assets.load_stand_pose() if args.pose_type == "stand_pose" else assets.t_pose()
    render_dir = os.path.join(out, "render")
    n = shape_mod.render_coarse_shape(np.asarray(pose).reshape(1, 24, 3),
                                      np.asarray(v).reshape(1, -1, 3), render_dir, device=args.device)
    log_stage(EXP_ROOT, "shape", {
        "target_txt": args.shape_text,
        "coarse_obj": obj_path,
        "n_views": n,
        "render_dir": render_dir,
        "pose_type": args.pose_type,
        "wall_clock_gen_s": round(t_gen, 1),
        "wall_clock_render_s": round(time.time() - t1, 1),
    })


def stage_pretrain(args):
    import numpy as np

    from ..utils.convert import params_to_jax

    t0 = time.time()
    conf = PRETRAIN_CONF.format(exp=EXP_ROOT, iters=args.pretrain_iters, data_dir=args.data_dir,
                                val_freq=args.val_freq, val_mesh_freq=args.val_freq * 2)
    runner = make_runner(conf, "train", is_continue=True, device=args.device)
    runner.train()
    dt = time.time() - t0
    # the nets alone, for the sculpt stage's train.pretrain, in the JAX
    # package's pytree layout (params/sdf/layers/0/g, ...): the file the
    # reference ships as zero_beta_stand_pose.pth
    pretrain_path = os.path.join(EXP_ROOT, "pretrain", "full_pretrain.npz")
    os.makedirs(os.path.dirname(pretrain_path), exist_ok=True)
    np.savez_compressed(pretrain_path, **params_to_jax(runner.fields, prefix="params/"))
    log_stage(EXP_ROOT, "pretrain", {"iters": runner.iter_step, "wall_clock_s": round(dt, 1),
                                     "pretrain_npz": pretrain_path})


def stage_sculpt(args):
    from ..pipelines import eval_clip

    t0 = time.time()
    pretrain = os.path.join(EXP_ROOT, "pretrain", "full_pretrain.npz")
    if not os.path.exists(pretrain):
        raise SystemExit("run --stage pretrain first")
    runner = make_runner(_sculpt_conf(args, pretrain), "train_clip", is_continue=args.is_continue,
                         device=args.device)
    save_dir = os.path.join(EXP_ROOT, "sculpt", "clip_eval")
    # the CLIP score before sculpting: the same lattice scored again after
    # the run shows whether the CLIP term moved the model toward the prompt
    if runner.iter_step == 0:
        rep0 = eval_clip.clip_score(runner, n_views=8, save_dir=save_dir)
        log_stage(EXP_ROOT, "sculpt_eval_before", rep0.to_json())
    runner.train_clip()
    log_stage(EXP_ROOT, "sculpt", {"iters": runner.iter_step,
                                   "wall_clock_s": round(time.time() - t0, 1), "pretrain": pretrain})
    rep = eval_clip.clip_score(runner, n_views=8, save_dir=save_dir)
    log_stage(EXP_ROOT, "sculpt_eval_after", rep.to_json())


def stage_extract(args):
    t0 = time.time()
    runner = make_runner(_sculpt_conf(args, "none"), "validate_mesh", is_continue=True,
                         device=args.device)
    if runner.iter_step <= 0:
        raise SystemExit("no sculpt checkpoint found")
    v, t, _ = runner.validate_mesh(world_space=True, resolution=args.mcube_resolution, threshold=0.0)
    t_mesh = time.time() - t0
    t1 = time.time()
    runner.render_geometry_cast_light()
    log_stage(EXP_ROOT, "extract", {
        "resolution": args.mcube_resolution,
        "n_vertices": int(len(v)), "n_faces": int(len(t)),
        "bake_axes": 6,
        "wall_clock_mesh_and_bake_s": round(t_mesh, 1),
        "wall_clock_cast_light_s": round(time.time() - t1, 1),
        "iter_step": runner.iter_step,
    })


def stage_export(args):
    import numpy as np

    from .. import assets
    from ..export import drive as drive_mod
    from ..export import rigged as rigged_mod

    t0 = time.time()
    mesh_dir = os.path.join(EXP_ROOT, "sculpt", "meshes")
    meshes = sorted(f for f in os.listdir(mesh_dir) if f.endswith(".ply")) if os.path.isdir(mesh_dir) else []
    if not meshes:
        raise SystemExit("run --stage extract first")
    ply = os.path.join(mesh_dir, meshes[-1])

    # a deterministic test motion: the stand pose to raised arms over 60
    # frames (the shape of the animate pipeline's MotionInterpolation)
    stand = np.asarray(assets.load_stand_pose(), np.float32).reshape(-1)[:72]
    target = stand.copy()
    target[16 * 3:16 * 3 + 3] = [0.0, 0.0, -1.2]  # raise the left shoulder
    target[17 * 3:17 * 3 + 3] = [0.0, 0.0, 1.2]  # raise the right shoulder
    w = np.linspace(0.0, 1.0, 60, dtype=np.float32)[:, None]
    motion = stand[None] * (1 - w) + target[None] * w
    motion_path = os.path.join(EXP_ROOT, "export", "motion.npy")
    os.makedirs(os.path.dirname(motion_path), exist_ok=True)
    np.save(motion_path, motion)

    pc2 = os.path.join(EXP_ROOT, "export", "avatar.pc2")
    drive_mod.main(["--mesh", ply, "--motion", motion_path, "--out", pc2,
                    "--cleaned_ply", os.path.join(EXP_ROOT, "export", "cleaned.ply"),
                    "--device", args.device])
    t_drive = time.time() - t0
    t1 = time.time()
    glb = os.path.join(EXP_ROOT, "export", "avatar.glb")
    rigged_mod.main(["--ply", ply, "--out", glb, "--motion", motion_path, "--device", args.device])
    log_stage(EXP_ROOT, "export", {
        "ply": ply,
        "pc2_bytes": os.path.getsize(pc2),
        "glb_bytes": os.path.getsize(glb),
        "wall_clock_drive_s": round(t_drive, 1),
        "wall_clock_rig_s": round(time.time() - t1, 1),
    })


def _host(x):
    """``x`` as a numpy array on the host (a device tensor waits for the card)."""
    import numpy as np

    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _timing_fields(gen, row, rerun) -> None:
    """The first step (with any build) apart from the steady rate; a
    one-shot generator is run again warm instead."""
    timing = getattr(gen, "timing", {})
    if timing.get("steady_steps"):
        row["first_step_s"] = round(timing["first_step_s"], 2)
        row["steady_steps_per_sec"] = round(timing["steady_steps"] / timing["steady_s"], 2)
    elif rerun is not None:
        t1 = time.time()
        rerun()
        row["warm_wall_clock_s"] = round(time.time() - t1, 2)


def stage_pose(args):
    """The four pose strategies at reference defaults: PoseOptimizer /
    VPoserOptimizer at 500 Adam steps x 5 restarts (pose_generation.py:102-173),
    VPoserRealNVP at 50 batches x 10 samples (:176-285), VPoserCodebook top-40
    retrieval (:288-329); candidates and JPEGs under <exp>/animate/pose/<strategy>/."""
    import numpy as np

    from ..pipelines import animate, visualize

    ctx = animate.AnimateContext(device=args.device)
    outroot = os.path.join(EXP_ROOT, "animate", "pose")
    # fastest first, so a run cut by its time limit keeps the finished rows
    strategies = {
        "vposer_codebook": ({"type": "VPoserCodebook"}, 1),
        "vposer_realnvp": ({"type": "VPoserRealNVP"}, 50),  # scoring batches
        "pose_optimizer": ({"type": "PoseOptimizer"}, 500 * 5),
        "vposer_optimizer": ({"type": "VPoserOptimizer"}, 500 * 5),
    }
    if args.strategy:
        strategies = {k: v for k, v in strategies.items() if k in args.strategy}
    for name, (conf, n_steps) in strategies.items():
        gen = animate.build_pose_generator(dict(conf), ctx=ctx)
        t0 = time.time()
        poses = gen.get_topk_poses(args.text)
        poses_np = _host(poses)
        dt = time.time() - t0
        d = os.path.join(outroot, name)
        os.makedirs(d, exist_ok=True)
        for i in range(poses_np.shape[0]):
            np.save(os.path.join(d, f"candidate_{i}.npy"), poses_np[i])
            visualize.render_pose(poses[i], os.path.join(d, f"candidate_{i}.jpg"), ctx=ctx)
        tf = ctx.get_text_feature(args.text)
        row = {
            "text": args.text,
            "n_candidates": int(poses_np.shape[0]),
            "wall_clock_s": round(dt, 1),
            "opt_steps": n_steps,
            "steps_per_sec": round(n_steps / dt, 2),
            "clip_scores": [round(float(ctx.calculate_pose_score(tf, poses[i])), 4)
                            for i in range(poses_np.shape[0])],
            "out_dir": d,
        }
        _timing_fields(gen, row, (lambda: _host(gen.get_topk_poses(args.text)))
                       if name == "vposer_codebook" else None)
        log_stage(EXP_ROOT, f"pose_{name}", row)


def stage_motion(args):
    """Both motion generators at reference defaults: MotionInterpolation's
    VPoser-latent anchor walk (motion_generation.py:100-137) and
    MotionOptimizer's 5000 Adam steps on the motion VAE's latent
    (:306-358), from the pose stage's codebook candidates."""
    import numpy as np

    from ..pipelines import animate, visualize

    ctx = animate.AnimateContext(device=args.device)
    cand_dir = os.path.join(EXP_ROOT, "animate", "pose", "vposer_codebook")
    if os.path.isdir(cand_dir):
        # numeric order: candidate_10 after candidate_2 (MotionOptimizer's
        # rank-weighted reconstruction depends on it)
        cand_files = sorted((f for f in os.listdir(cand_dir)
                             if f.startswith("candidate_") and f.endswith(".npy")),
                            key=lambda f: int(f.split("_")[1].split(".")[0]))
        poses = np.stack([np.load(os.path.join(cand_dir, f)) for f in cand_files])
    else:
        gen = animate.build_pose_generator({"type": "VPoserCodebook"}, ctx=ctx)
        poses = _host(gen.get_topk_poses(args.text))
    outroot = os.path.join(EXP_ROOT, "animate", "motion")
    strategies = {
        "interpolation": ({"type": "MotionInterpolation"}, 1),
        "motion_optimizer": ({"type": "MotionOptimizer"}, 5000),
    }
    if args.strategy:
        strategies = {k: v for k, v in strategies.items() if k in args.strategy}
    for name, (conf, n_steps) in strategies.items():
        gen = animate.build_motion_generator(dict(conf), ctx=ctx)
        t0 = time.time()
        motion = gen.get_motion(args.text, poses)
        motion_np = _host(motion)
        dt = time.time() - t0
        d = os.path.join(outroot, name)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "motion.npy"), motion_np)
        mp4 = os.path.join(d, "motion.mp4")
        t1 = time.time()
        visualize.render_motion(motion, mp4, ctx=ctx)
        row = {
            "text": args.text,
            "n_frames": int(motion_np.shape[0]),
            "wall_clock_s": round(dt, 1),
            "opt_steps": n_steps,
            "steps_per_sec": round(n_steps / dt, 2),
            "wall_clock_mp4_s": round(time.time() - t1, 1),
            "mp4_bytes": os.path.getsize(mp4) if os.path.exists(mp4) else 0,
            "out_dir": d,
        }
        _timing_fields(gen, row, (lambda: _host(gen.get_motion(args.text, poses)))
                       if name == "interpolation" else None)
        log_stage(EXP_ROOT, f"motion_{name}", row)


STAGES = {
    "shape": stage_shape,
    "pretrain": stage_pretrain,
    "sculpt": stage_sculpt,
    "extract": stage_extract,
    "export": stage_export,
    "pose": stage_pose,
    "motion": stage_motion,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", required=True, choices=list(STAGES))
    p.add_argument("--exp_root", default=None,
                   help="override the experiment root (default exp/reference_schedule_torch; use "
                        "e.g. exp/reference_schedule_torch_own for the self-generated-data route "
                        "so the two chains do not collide)")
    p.add_argument("--data_dir", default="zero_beta_standpose_render",
                   help="pretrain dataset (a shape-stage render_dir for the self-generated route)")
    p.add_argument("--sculpt_data_dir", default="zero_beta_tpose_render",
                   help="sculpt-stage dataset (only consulted for camera intrinsics / the "
                        "template pose frame); pass '' to reuse --data_dir")
    p.add_argument("--template_obj", default=None,
                   help="coarse-shape OBJ for the sculpt SMPL template (reference "
                        "confs/astrongman/*.conf dataset.template_obj)")
    p.add_argument("--pose_type", default="stand_pose", choices=["stand_pose", "t_pose"])
    p.add_argument("--shape_text", default="a 3d rendering of a strong man in unreal engine",
                   help="ShapeGen target text (reference README.md:202)")
    p.add_argument("--pretrain_iters", type=int, default=300000)
    p.add_argument("--val_freq", type=int, default=25000,
                   help="validation cadence of the pretrain stage (the reference's val_freq=250 "
                        "would spend most of the run validating; the training is unchanged)")
    p.add_argument("--mcube_resolution", type=int, default=512)
    p.add_argument("--is_continue", action="store_true")
    p.add_argument("--text", default="a rendered 3d man is arguing",
                   help="action text for the pose / motion stages (the reference "
                        "pose_ablation/argue.conf prompt)")
    p.add_argument("--strategy", nargs="*", default=None,
                   help="subset of pose / motion strategies to run")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    # long runs: SIGUSR2 dumps every thread's stack, so a hung stage can be
    # diagnosed without killing it
    import faulthandler
    import signal

    faulthandler.enable()
    faulthandler.register(signal.SIGUSR2, all_threads=True)

    if args.exp_root:
        global EXP_ROOT
        EXP_ROOT = os.path.abspath(args.exp_root)
    STAGES[args.stage](args)


if __name__ == "__main__":
    main()
