"""The port's user-stage scripts (avatarclip_torch/scripts/), as
tests/test_scripts.py holds the JAX package's:

  * eval_photometric: the GT is sampled on the ray lattice (a linspace over
    the full sensor), not by a stride: exact at level 1 for a renderer that
    is the GT, and at a fractional lattice the lattice comparison beats the
    [::2] stride's; ``evaluate``'s rows against JAX's ``evaluate`` on the same
    tiny fields (PSNR to 1e-3 dB before rounding, IoU equal); the CLI on a
    tiny checkpoint;
  * run_reference_schedule: stage sequencing, conf routing (data_dir,
    template_obj, pose_type, device), the pretrain handoff (the npz in JAX's
    pytree layout) and the schedule_log.jsonl rows, with stub runners and
    generators so the scripts' own logic is tested, not the training loop;
  * ``Runner.profile_trace`` and capture_trace: the Chrome trace parses and
    holds ``n_iters`` steps, and the Runner's fields are left as they were.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from avatarclip_torch import config as config_mod
from avatarclip_torch.pipelines import appearance as tapp
from avatarclip_torch.pipelines import dataset as dataset_mod
from avatarclip_torch.pipelines import synthetic as tsyn
from avatarclip_torch.scripts import capture_trace, eval_photometric
from avatarclip_torch.scripts import run_reference_schedule
from avatarclip_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny tensors' many small ops thrash when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# eval_photometric: the GT sampled on the ray lattice
# ---------------------------------------------------------------------------


def _gradient_dataset(tmp_path, res=33, n_views=2):
    """Blender-style views whose images are a linear gradient in pixel
    coordinates: bilinear sampling of them is exact everywhere."""
    d = tmp_path / "views"
    (d / "img").mkdir(parents=True)
    frames = []
    for i in range(n_views):
        a = 2 * np.pi * i / max(n_views, 1)
        eye = np.array([2.0 * np.sin(a), 0.0, 2.0 * np.cos(a)], np.float32)
        z = eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
        yy, xx = np.mgrid[0:res, 0:res].astype(np.float64)
        img = np.stack([xx / (res - 1), yy / (res - 1), np.full_like(xx, 0.5)], -1)
        write_png(str(d / "img" / f"{i:04d}.png"), np.round(img * 255).astype(np.uint8))
        frames.append({"file_path": f"img/{i:04d}", "transform_matrix": m.tolist()})
    with open(d / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": float(np.deg2rad(60.0)), "frames": frames}, f)
    return str(d)


def _bilinear(img, py, px):
    H, W = img.shape[:2]
    px = np.clip(px, 0.0, W - 1.0)
    py = np.clip(py, 0.0, H - 1.0)
    x0 = np.clip(np.floor(px).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(py).astype(int), 0, H - 2)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def _perfect_runner(ds):
    """A runner whose 'render' maps each ray back to continuous pixel
    coordinates and samples the stored image there: the render is the GT at
    exactly the lattice positions the rays cover."""

    def render_rays_chunked(rays_o, rays_d, background_rgb=None, keys=None):
        rays_o, rays_d = np.asarray(rays_o), np.asarray(rays_d)
        poses = ds.poses.numpy()
        idx = int(np.argmin(np.linalg.norm(poses[:, :3, 3] - rays_o[0], axis=1)))
        R, img = poses[idx, :3, :3], ds.images[idx].numpy()
        d_cam = rays_d @ R  # R^T d, rays as rows
        s = -1.0 / d_cam[:, 2]
        px = ds.W * 0.5 + ds.focal * d_cam[:, 0] * s
        py = ds.H * 0.5 - ds.focal * d_cam[:, 1] * s
        return {"color_fine": _bilinear(img, py, px), "weight_sum": np.ones(rays_o.shape[0])}

    return types.SimpleNamespace(dataset=ds, iter_step=7, render_rays_chunked=render_rays_chunked)


@pytest.fixture(scope="module")
def grad_ds(tmp_path_factory):
    d = _gradient_dataset(tmp_path_factory.mktemp("grad"))
    return dataset_mod.SMPLViewDataset(config_mod.parse_string("dataset { data_dir = %s }" % d)["dataset"])


def test_eval_photometric_exact_at_level_1(grad_ds):
    rep = eval_photometric.evaluate(_perfect_runner(grad_ds), views=[0, 1], res_level=1)
    # the integer lattice is the sensor grid: the perfect render is the GT
    assert rep["mean_psnr_db"] > 50.0
    assert rep["mean_mask_iou"] == 1.0
    assert rep["iter_step"] == 7


def test_eval_photometric_lattice_beats_stride(grad_ds):
    """At res 33, level 2 (16 rays over the full sensor) the lattice
    comparison stays within the GT's 0.5 px rounding, while a [::2] stride
    reads a top-left crop, up to 2 px off, and scores visibly worse."""
    runner = _perfect_runner(grad_ds)
    rep = eval_photometric.evaluate(runner, views=[0], res_level=2)
    assert rep["mean_psnr_db"] > 35.0
    rays_o, rays_d = grad_ds.gen_rays_at(0, 2)
    H, W = rays_o.shape[0], rays_o.shape[1]
    out = runner.render_rays_chunked(rays_o.reshape(-1, 3).numpy(), rays_d.reshape(-1, 3).numpy())
    img = out["color_fine"].reshape(H, W, 3)
    gt_stride = grad_ds.images[0].numpy()[::2, ::2][:H, :W]
    psnr_stride = -10.0 * np.log10(float(np.mean((img - gt_stride) ** 2)))
    assert rep["mean_psnr_db"] > psnr_stride + 3.0


@pytest.mark.parametrize("level", [1, 2])
def test_eval_photometric_matches_jax(tmp_path_factory, monkeypatch, level):
    """The same tiny fields in both packages (``params_from_jax``) on the
    synthetic circle views: every row's PSNR to 1e-3 dB and IoU equal,
    compared before the scripts round them (``round`` is the identity in
    both modules for this comparison), then rounded as the scripts print."""
    from avatarclip_tpu import config as jconfig
    from avatarclip_tpu.pipelines import appearance as japp
    from avatarclip_tpu.pipelines import synthetic as jsyn
    from avatarclip_tpu.utils.pytree import tree_flatten_paths
    from avatarclip_torch.utils.convert import params_from_jax

    tmp = tmp_path_factory.mktemp("photo")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=3, res=32)
    conf_text = jsyn.make_conf_text(str(tmp / "exp"), data, "tiny")
    jr = japp.Runner(None, mode="eval", conf=jconfig.parse_string(conf_text))
    tr = tapp.Runner(None, mode="eval", conf=config_mod.parse_string(conf_text), device="cpu")
    params_from_jax(tree_flatten_paths(jr.params), tr.fields)
    jep = _load_jax_script("eval_photometric")
    rounded = eval_photometric.evaluate(tr, [0, 1, 2], level)
    assert rounded == jep.evaluate(jr, [0, 1, 2], level)
    for mod in (jep, eval_photometric):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x, raising=False)
    got, want = eval_photometric.evaluate(tr, [0, 1, 2], level), jep.evaluate(jr, [0, 1, 2], level)
    assert [r["view"] for r in got["views"]] == [0, 1, 2]
    for g, w in zip(got["views"], want["views"]):
        assert np.isfinite(g["psnr_db"]) and abs(g["psnr_db"] - w["psnr_db"]) <= 1e-3, (g, w)
        assert g["mask_iou"] == w["mask_iou"] and 0.0 < g["mask_iou"] < 1.0, (g, w)


def test_eval_photometric_cli_on_a_checkpoint(tmp_path, capsys):
    data = tsyn.write_synthetic_views(str(tmp_path / "views"), n_views=4, res=32)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(tsyn.make_conf_text(str(tmp_path / "exp"), data, "tiny"))
    argv = ["--exp", str(tmp_path / "exp"), "--conf", str(conf_path), "--views", "0", "2",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_photometric.main(argv)
    tapp.main(["--mode", "train", "--conf", str(conf_path), "--device", "cpu",
               "--set", "train.end_iter=2", "--set", "train.save_freq=2"])
    capsys.readouterr()
    rep = eval_photometric.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    assert rep["iter_step"] == 2 and [r["view"] for r in rep["views"]] == [0, 2]
    assert all(np.isfinite(r["psnr_db"]) and 0.0 <= r["mask_iou"] <= 1.0 for r in rep["views"])


# ---------------------------------------------------------------------------
# run_reference_schedule: stage sequencing with stub runners
# ---------------------------------------------------------------------------


class _StubRunner:
    calls: list = []

    def __init__(self, conf, mode, device):
        self.conf, self.mode, self.device = conf, mode, device
        self.iter_step = 0
        self.fields = torch.nn.Module()
        self.fields.w = torch.nn.Parameter(torch.arange(2.0))

    def train(self):
        _StubRunner.calls.append("train")
        self.iter_step = 11

    def train_clip(self):
        _StubRunner.calls.append("train_clip")
        self.iter_step = 22

    def validate_mesh(self, world_space, resolution, threshold):
        _StubRunner.calls.append(f"validate_mesh:{resolution}:{world_space}")
        return np.zeros((4, 3)), np.zeros((2, 3), np.int32), np.zeros((4, 3))

    def render_geometry_cast_light(self):
        _StubRunner.calls.append("cast_light")


@pytest.fixture()
def sched(tmp_path, monkeypatch):
    rrs = run_reference_schedule
    monkeypatch.setattr(rrs, "EXP_ROOT", str(tmp_path / "exp"))
    _StubRunner.calls = []
    made = []

    def fake_make_runner(conf_text, mode, is_continue=False, device=None):
        r = _StubRunner(config_mod.parse_string(conf_text), mode, device)
        if is_continue and mode != "train":
            r.iter_step = 22
        made.append(r)
        return r

    monkeypatch.setattr(rrs, "make_runner", fake_make_runner)
    from avatarclip_torch.pipelines import eval_clip

    monkeypatch.setattr(eval_clip, "clip_score", lambda runner, n_views, save_dir: types.SimpleNamespace(
        to_json=lambda: {"mean_cosine": 0.1, "n_views": n_views}))
    return rrs, made


def _args(**over):
    defaults = dict(pretrain_iters=5, val_freq=100, mcube_resolution=32, is_continue=False,
                    data_dir="own_render", sculpt_data_dir="zero_beta_tpose_render",
                    template_obj=None, pose_type="stand_pose", text="t", strategy=None,
                    shape_text="s", exp_root=None, device="cpu")
    defaults.update(over)
    return types.SimpleNamespace(**defaults)


def _log(rrs):
    with open(os.path.join(rrs.EXP_ROOT, "schedule_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_schedule_pretrain_sculpt_extract_sequencing(sched):
    rrs, made = sched
    args = _args()
    rrs.stage_pretrain(args)
    assert _StubRunner.calls == ["train"]
    pretrain = os.path.join(rrs.EXP_ROOT, "pretrain", "full_pretrain.npz")
    with np.load(pretrain) as data:  # the nets in JAX's pytree layout
        assert data.files == ["params/w"]
        np.testing.assert_array_equal(data["params/w"], [0.0, 1.0])
    # conf routing: pretrain read --data_dir, every Runner took --device
    assert made[0].conf.get_string("dataset.data_dir") == "own_render"
    assert made[0].conf.get_int("train.end_iter") == 5 and made[0].mode == "train"

    rrs.stage_sculpt(args)
    assert _StubRunner.calls[-1] == "train_clip"
    rrs.stage_extract(args)
    assert _StubRunner.calls[-2].startswith("validate_mesh:32:True")
    assert _StubRunner.calls[-1] == "cast_light"
    assert [r.device for r in made] == ["cpu"] * 3
    assert made[1].conf.get_string("train.pretrain") == pretrain
    assert made[2].conf.get_string("train.pretrain", None) is None  # the conf's "none"

    log = _log(rrs)
    assert [r["stage"] for r in log] == ["pretrain", "sculpt_eval_before", "sculpt",
                                         "sculpt_eval_after", "extract"]
    assert log[0]["iters"] == 11
    assert log[1]["n_views"] == 8
    assert log[2]["pretrain"] == pretrain
    assert log[4]["n_vertices"] == 4


def test_schedule_sculpt_needs_the_pretrain_and_extract_a_checkpoint(sched, monkeypatch):
    rrs, made = sched
    with pytest.raises(SystemExit, match="pretrain first"):
        rrs.stage_sculpt(_args())
    monkeypatch.setattr(rrs, "make_runner", lambda *a, **k: _StubRunner(None, "validate_mesh", "cpu"))
    with pytest.raises(SystemExit, match="no sculpt checkpoint"):
        rrs.stage_extract(_args())
    with pytest.raises(SystemExit, match="extract first"):
        rrs.stage_export(_args())


def test_schedule_sculpt_conf_routing(sched):
    rrs, _ = sched
    conf = config_mod.parse_string(rrs._sculpt_conf(
        _args(template_obj="/x/coarse.obj", pose_type="t_pose", sculpt_data_dir=""), "/p.npz"))
    assert conf.get_string("dataset.template_obj") == "/x/coarse.obj"
    assert conf.get_string("general.pose_type") == "t_pose"
    # an empty --sculpt_data_dir falls back to --data_dir (the self-generated route)
    assert conf.get_string("dataset.data_dir") == "own_render"
    assert conf.get_string("train.pretrain") == "/p.npz"
    conf2 = config_mod.parse_string(rrs._sculpt_conf(_args(), "/p.npz"))
    assert conf2.get_string("dataset.template_obj", None) is None
    assert conf2.get_string("dataset.data_dir") == "zero_beta_tpose_render"
    assert conf2.get_string("general.base_exp_dir") == os.path.join(rrs.EXP_ROOT, "sculpt")


def test_schedule_confs_and_flags_are_the_jax_schedules(capsys):
    """The conf texts and the flags are the JAX script's, but for --device;
    the experiment root is the port's own."""
    import re

    rrs, jrrs = run_reference_schedule, _load_jax_script("run_reference_schedule")
    assert rrs.PRETRAIN_CONF == jrrs.PRETRAIN_CONF and rrs.SCULPT_CONF == jrrs.SCULPT_CONF
    assert rrs.EXP_ROOT == os.path.join(REPO, "exp", "reference_schedule_torch")
    flags = []
    for mod in (rrs, jrrs):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
        flags.append(set(re.findall(r"(--[a-z_]+)", capsys.readouterr().out)))
    assert flags[0] == flags[1] | {"--device"}
    assert {"--stage", "--exp_root", "--pretrain_iters", "--template_obj"} <= flags[1]


def test_schedule_shape_and_export_routing(sched, monkeypatch):
    """The shape stage writes coarse.obj and the render under the root; the
    export stage drives the newest extracted mesh through the drive and
    rigged CLIs on --device."""
    rrs, _ = sched
    from avatarclip_torch.export import drive, rigged
    from avatarclip_torch.pipelines import shape

    seen = {}

    def fake_gen(neutral, target, device=None):
        seen["gen"] = (target, device)
        return np.zeros((3, 3), np.float32), [[0, 1, 2]], None

    monkeypatch.setattr(shape, "shape_gen", fake_gen)

    def fake_render(pose, v, out, device=None):
        seen["render"] = (pose.shape, v.shape, out, device)
        return 108

    monkeypatch.setattr(shape, "render_coarse_shape", fake_render)
    rrs.stage_shape(_args(shape_text="a strong man"))
    assert seen["gen"] == ("a strong man", "cpu")
    assert seen["render"] == ((1, 24, 3), (1, 3, 3), os.path.join(rrs.EXP_ROOT, "shape", "render"), "cpu")
    assert os.path.exists(os.path.join(rrs.EXP_ROOT, "shape", "coarse.obj"))

    meshes = os.path.join(rrs.EXP_ROOT, "sculpt", "meshes")
    os.makedirs(meshes)
    for it in (8, 16):
        open(os.path.join(meshes, f"{it:08d}.ply"), "w").close()

    def fake_drive(argv):
        seen["drive"] = argv
        open(argv[argv.index("--out") + 1], "wb").write(b"pc2")

    def fake_rigged(argv):
        seen["rigged"] = argv
        open(argv[argv.index("--out") + 1], "wb").write(b"glb!")

    monkeypatch.setattr(drive, "main", fake_drive)
    monkeypatch.setattr(rigged, "main", fake_rigged)
    rrs.stage_export(_args())
    for k in ("drive", "rigged"):
        assert seen[k][seen[k].index("--device") + 1] == "cpu"
        assert seen[k][1].endswith("00000016.ply")
    motion = np.load(os.path.join(rrs.EXP_ROOT, "export", "motion.npy"))
    assert motion.shape == (60, 72)
    log = _log(rrs)
    assert [r["stage"] for r in log] == ["shape", "export"]
    assert log[0]["n_views"] == 108 and (log[1]["pc2_bytes"], log[1]["glb_bytes"]) == (3, 4)


def test_schedule_pose_motion_sequencing(sched, monkeypatch):
    rrs, _ = sched
    from avatarclip_torch.pipelines import animate, visualize

    class StubGen:
        def __init__(self, n):
            self.n = n

        def get_topk_poses(self, text):
            return torch.zeros(self.n, 69)

        def get_motion(self, text, poses):
            return torch.zeros(60, 69)

    class StubCtx:
        def get_text_feature(self, text):
            return torch.ones(8)

        def calculate_pose_score(self, tf, pose):
            return 0.5

    devices = []
    monkeypatch.setattr(animate, "AnimateContext", lambda *a, **k: devices.append(k["device"]) or StubCtx())
    monkeypatch.setattr(animate, "build_pose_generator", lambda conf, ctx: StubGen(5))
    monkeypatch.setattr(animate, "build_motion_generator", lambda conf, ctx: StubGen(5))
    monkeypatch.setattr(visualize, "render_pose", lambda *a, **k: None)
    monkeypatch.setattr(visualize, "render_motion", lambda *a, **k: None)

    rrs.stage_pose(_args(strategy=["vposer_codebook"]))
    d = os.path.join(rrs.EXP_ROOT, "animate", "pose", "vposer_codebook")
    assert len([f for f in os.listdir(d) if f.endswith(".npy")]) == 5
    rrs.stage_motion(_args(strategy=["interpolation"]))
    assert os.path.exists(os.path.join(rrs.EXP_ROOT, "animate", "motion", "interpolation", "motion.npy"))
    assert devices == ["cpu", "cpu"]
    log = _log(rrs)
    stages = [r["stage"] for r in log]
    assert stages == ["pose_vposer_codebook", "motion_interpolation"]
    row = log[0]
    assert row["n_candidates"] == 5 and row["clip_scores"] == [0.5] * 5
    assert "warm_wall_clock_s" in row and "warm_wall_clock_s" in log[1]
    assert log[1]["n_frames"] == 60


# ---------------------------------------------------------------------------
# Runner.profile_trace and capture_trace
# ---------------------------------------------------------------------------


def _trace_steps(out_dir) -> int:
    with open(os.path.join(out_dir, "trace.json")) as f:
        trace = json.load(f)
    return sum(1 for e in trace["traceEvents"] if e.get("name") == "loop.step")


def test_profile_trace_writes_n_steps_and_leaves_the_fields(tmp_path):
    r = tsyn.make_runner(str(tmp_path), "tiny", device="cpu")
    before = {k: v.clone() for k, v in r.fields.state_dict().items()}
    out = r.profile_trace(str(tmp_path / "trace"), n_iters=3)
    assert out == str(tmp_path / "trace")
    assert _trace_steps(out) == 3
    assert r.update_count == 0 and r.iter_step == 0 and not r.optimizer.state
    for k, v in r.fields.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_capture_trace_script(tmp_path, monkeypatch, capsys):
    made = []
    real = tsyn.make_runner

    def tiny_runner(d, scale="tiny", res=64, n_views=4, device=None):
        made.append((scale, res, n_views, device))
        return real(d, "tiny", res=32, n_views=n_views, device=device)

    monkeypatch.setattr(tsyn, "make_runner", tiny_runner)
    out = capture_trace.main(["2", "--out", str(tmp_path / "t"), "--device", "cpu"])
    assert made == [("full", 256, 4, "cpu")]
    assert capsys.readouterr().out.strip().splitlines()[-1] == out == str(tmp_path / "t")
    assert _trace_steps(out) == 2


@pytest.mark.parametrize("script", ["eval_clip_score", "eval_photometric", "capture_trace",
                                    "run_reference_schedule"])
def test_scripts_use_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch, script):
    """Each script runs on the card by default and, without one, raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        return
    from avatarclip_torch.scripts import eval_clip_score

    data = tsyn.write_synthetic_views(str(tmp_path / "views"), n_views=2, res=32)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(tsyn.make_conf_text(str(tmp_path / "exp"), data, "tiny"))
    argv = {
        "eval_clip_score": ["--conf", str(conf_path)],
        "eval_photometric": ["--exp", str(tmp_path / "exp"), "--conf", str(conf_path)],
        "capture_trace": ["1", "--out", str(tmp_path / "trace")],
        "run_reference_schedule": ["--stage", "pretrain", "--exp_root", str(tmp_path / "root"),
                                   "--data_dir", data, "--pretrain_iters", "1"],
    }[script]
    main = {"eval_clip_score": eval_clip_score.main, "eval_photometric": eval_photometric.main,
            "capture_trace": capture_trace.main, "run_reference_schedule": run_reference_schedule.main}
    # --exp_root sets the module's root: restore it after the test
    monkeypatch.setattr(run_reference_schedule, "EXP_ROOT", run_reference_schedule.EXP_ROOT)
    with pytest.raises(RuntimeError, match="CUDA"):
        main[script](argv)
