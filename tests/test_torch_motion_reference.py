"""avatarclip_torch's MotionOptimizer against the motion cell's plain float32
reference (benchmark/reference/motion.py), on the CPU at a small size
(benchmark/tests/tiny_motion.py: 12 frames, latent 32, 2 layers of 2
heads, 16^2 renders, tiny CLIP, a 576-face body) on seeded weights: the
decoder and the rotation chain piece by piece, then three Adam steps of
the whole loss and with the CLIP or the delta term off, so that each term
is held on its own: every step's loss, every step's latent gradient and
the latent after the three steps."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import motion, registry  # noqa: E402
from benchmark.reference import motion as ref  # noqa: E402
from benchmark.tests import tiny_motion  # noqa: E402

STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(cfg, seed):
    """The motion driver set up on the CPU: the program's MotionOptimizer
    on the cell's inputs made from ``seed``."""
    d = registry.driver("motion_adam")(cfg, tiny_motion.motion()[1], seed, "cpu", {})
    d.setup()
    return d


def test_decoder_and_rotations_match_the_reference():
    """ACTOR's decoder (the 6d rotations of every frame and joint) and the
    6d -> matrix -> quaternion -> axis-angle chain to the body's 63 angles;
    the 6d of those angles back through the matrix."""
    from avatarclip_torch.body import rotations
    from avatarclip_torch.pipelines import motion_vae

    cfg, _ = tiny_motion.motion()
    mg = cfg["motion_generator"]
    w = motion.decoder_weights(mg, torch.Generator().manual_seed(5), "cpu")
    vcfg = motion_vae.MotionVAEConfig(seq_len=mg["num_frame"], latent_dim=mg["latent_dim"],
                                      num_heads=mg["num_heads"], ff_size=mg["ff_size"],
                                      num_layers=mg["num_layers"])
    params = {**w, "pe": torch.from_numpy(motion_vae.sinusoidal_pe(100, mg["latent_dim"]))}
    lat = torch.randn(mg["latent_dim"], generator=torch.Generator().manual_seed(6))
    got6 = motion_vae.decode(params, vcfg, lat[None])[0]
    want6 = ref.decode(w, lat, mg)
    assert got6.shape == want6.shape == (12, 55, 6)
    torch.testing.assert_close(got6, want6, rtol=1e-5, atol=1e-5)
    aa = rotations.quaternion_to_axis_angle(rotations.matrix_to_quaternion(
        rotations.rotation_6d_to_matrix(want6.reshape(-1, 6)))).reshape(12, -1)[:, 3:66]
    want = ref.motion_poses(want6)
    torch.testing.assert_close(aa, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        rotations.matrix_to_rotation_6d(rotations.axis_angle_to_matrix(want.reshape(12, 21, 3))),
        ref.matrix_to_rotation_6d(ref.axis_angle_to_matrix(want.reshape(12, 21, 3))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("terms", [{}, {"clip_coef": 0.0}, {"delta_coef": 0.0}],
                         ids=["all_terms", "no_clip", "no_delta"])
def test_motion_steps_match_the_reference(terms):
    cfg, wl = tiny_motion.motion(**terms)
    seed = 2**31 + 19
    d = _program(cfg, seed)
    g = d.gen
    latent = g.draw_init().requires_grad_(True)
    opt = torch.optim.Adam([latent], lr=cfg["motion_generator"]["lr"], betas=(0.9, 0.999), eps=1e-8)
    got = []
    for _ in range(STEPS):
        loss = g.step(latent, opt, d.poses63, d.text, g.draw_step())
        got.append((float(loss), latent.grad.clone()))
    run = ref.MotionRun(cfg, d.body, d.clip_params, d.tokens, d.decoder, d.poses63,
                        torch.Generator().manual_seed(d.seeds["draws"]), "cpu")
    for k, (loss, grad) in enumerate(got):
        want_loss, want_g = run.step()
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), (k, loss, want_loss)
        assert float((grad - want_g["latent"]).norm()) <= 1e-5 * float(want_g["latent"].norm()), k
    torch.testing.assert_close(latent.detach(), run.latent.detach(), rtol=0, atol=1e-6)
    d.release()
