"""The port never imports JAX nor the JAX package (nor optax, orbax, imageio
or cv2): statically, no import statement of ``avatarclip_torch`` or
``chip_smoke.py`` reaches ``avatarclip_tpu``; and in a fresh interpreter,
import every avatarclip_torch module, run one tiny train_clip step, one
photometric step, ``validate_image``, ``validate_mesh``, one PoseOptimizer
step, one MotionOptimizer step, ``visualize.render_pose`` and one
background (NeRF++, n_outside > 0) render step, and check sys.modules. The kernel modules import and build nothing without nvcc."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_import_statement_reaches_the_jax_package():
    files = sorted(glob.glob(os.path.join(ROOT, "avatarclip_torch", "**", "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            if any(n.split(".")[0] in ("avatarclip_tpu", "jax", "jaxlib") for n in names):
                bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not bad, bad


def test_port_imports_no_jax_and_runs_a_step(tmp_path):
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {ROOT!r})
        import avatarclip_torch
        mods = [m.name for m in pkgutil.walk_packages(avatarclip_torch.__path__, "avatarclip_torch.")]
        for m in mods:
            importlib.import_module(m)
        from avatarclip_torch.ops import _build
        assert not _build._loaded and not _build.build_seconds, "a kernel was built at import"
        from avatarclip_torch.pipelines import synthetic
        r = synthetic.make_runner({str(tmp_path)!r}, "tiny", device="cpu")
        r.conf.put("train.end_iter", 1)
        from avatarclip_torch.pipelines import appearance
        r.tc = appearance.train_config_from_conf(r.conf)
        r.train_clip()
        loss, _ = r.photometric_loss(r.draw_photometric(), 0)
        loss.backward()
        r.validate_image(idx=1)
        v, t, _ = r.validate_mesh(resolution=16)
        assert t.shape[0] > 0
        import torch
        from avatarclip_torch.pipelines import animate, visualize
        ctx = animate.AnimateContext(clip_size="tiny", render_res=32, device="cpu")
        tf = ctx.get_text_feature("a man")
        g = animate.PoseOptimizer(ctx=ctx, topk=1, num_iteration=1)
        var = g.draw_init().requires_grad_(True)
        assert torch.isfinite(g.step(var, g.make_optimizer(var), tf, g.draw_step()))
        m = animate.MotionOptimizer(ctx=ctx, num_frame=12, latent_dim=32, num_layers=1, num_heads=2,
                                    num_iteration=1, clip_num_part=6)
        lat = m.draw_init().requires_grad_(True)
        opt = torch.optim.Adam([lat], lr=0.01)
        assert torch.isfinite(m.step(lat, opt, torch.zeros(2, 63), tf, m.draw_step()))
        visualize.render_pose(torch.zeros(69), {str(tmp_path / "pose.jpg")!r}, ctx=ctx, res=32)
        from avatarclip_torch.fields import networks as nets
        from avatarclip_torch.render import neus
        f = nets.NeuSFields(nets.SDFConfig(d_out=17, d_hidden=16, n_layers=2, multires=2),
                            nets.ColorConfig(d_feature=16, d_hidden=16, n_layers=1), 0.3,
                            nerf_cfg=nets.NeRFConfig(D=2, W=16, multires=2, multires_view=2))
        ro = torch.tensor([[0.0, 0.0, 2.0]]).expand(4, 3)
        rd = torch.nn.functional.normalize(torch.tensor([[0.05, 0.0, -1.0]]).expand(4, 3), dim=-1)
        out = neus.render(f, neus.NeuSConfig(n_samples=8, n_importance=8, up_sample_steps=2,
                                             n_outside=4), ro, rd, torch.ones(4, 1), 3 * torch.ones(4, 1),
                          generator=torch.Generator().manual_seed(0), per_ray=True)
        (out["color_fine"].sum() + out["gradient_error"]).backward()
        assert f.nerf.pts[0].w.grad is not None
        banned = ("jax", "jaxlib", "optax", "orbax", "imageio", "cv2", "avatarclip_tpu")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
        assert not bad, bad
        print("modules", len(mods))
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PATH"] = "/usr/bin:/bin"  # no nvcc on the path
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "modules" in out.stdout
