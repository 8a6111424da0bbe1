"""The port never imports JAX (nor optax, orbax, imageio or cv2): in a fresh
interpreter, import every avatarclip_torch module, run one tiny train_clip
step and one photometric step, and check sys.modules. The kernel modules
import and build nothing without nvcc."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        r = synthetic.make_runner({str(tmp_path)!r}, "tiny")
        r.conf.put("train.end_iter", 1)
        from avatarclip_torch.pipelines import appearance
        r.tc = appearance.train_config_from_conf(r.conf)
        r.train_clip()
        loss, _ = r.photometric_loss(r.draw_photometric(), 0)
        loss.backward()
        banned = ("jax", "jaxlib", "optax", "orbax", "imageio", "cv2")
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
