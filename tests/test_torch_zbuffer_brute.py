"""#15, the brute-force z-buffer (csrc/raster_zbuffer.cu's
``zbuffer_brute_kernel``), through its Python twins on the CPU:

* the work split: ``raster_zbuffer.brute_plan``'s pixel tiles and face
  slices cover every (pixel, face) pair exactly once (no culling: every
  face meets every tile), at the port's shapes and at face counts around
  one staged block, and its constants are the kernel source's;
* the merge: the plain version run slice by slice over the plan's face
  slices and merged as the kernel merges (the largest (iz bits << 32 | id)
  key) equals the unsplit plain version and the JAX package's brute-force
  kernel (``zbuffer_select(..., interpret=True)``) bit for bit, on seeded
  scenes with exact duplicates in other slices (ties to the higher id), an
  exact -0.0 edge value on covered pixels and NaN coefficients;
* the fold of the flags: ``raster_zbuffer.fold_valid``'s NaN sentinel, with
  every face then counted valid, gives the masked winners.
The scenes are tests/torch_zbuffer_scenes.py's (numpy from a seed)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_zbuffer_scenes as zs

from avatarclip_tpu.ops import raster_zbuffer as jrz
from avatarclip_tpu.render import raster as jraster
from avatarclip_torch.ops import raster_zbuffer as trz

H100_SMS = 132
SHAPES = [(256, 256), (512, 512), (224, 224), (200, 232)]
H, W, N_FACES = 40, 56, 300  # the merge tests' screen and soup


@pytest.mark.parametrize("F", [0, 1, 511, 512, 513, 13441])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_brute_plan_covers_every_pair_once(shape, F):
    """The tiles partition the pixels, the slices partition [0, F) in
    increasing order, and the CTAs are one a (tile, slice): each (pixel,
    face) pair lies in exactly one CTA's work. At ShapeGen's 13,441 faces
    the grid is two full waves of 8 CTAs on each of the H100's SMs, or
    nearly (at least 15 CTAs an SM, at most BRUTE_CTAS)."""
    h, w = shape
    tiles, slices, ctas = trz.brute_plan(h, w, F)
    count = torch.zeros(h, w, dtype=torch.int32)
    for y0, y1, x0, x1 in tiles:
        assert 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w
        assert y1 - y0 <= trz.BRUTE_TILE and x1 - x0 <= trz.BRUTE_TILE
        count[y0:y1, x0:x1] += 1
    assert bool((count == 1).all())
    assert slices[0][0] == 0 and slices[-1][1] == F
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(f1 - f0 >= min(F, trz.BRUTE_FBLOCK) for f0, f1 in slices)
    assert ctas == len(tiles) * len(slices)
    if F >= 13441:
        assert 15 * H100_SMS <= ctas <= trz.BRUTE_CTAS


@pytest.mark.parametrize("split", [1, 2, 7])
def test_brute_plan_takes_a_forced_split(split):
    """The C entry's split seam: K slices whatever the face count, empty
    ones included when K exceeds it."""
    _, slices, ctas = trz.brute_plan(50, 70, 5, split)
    assert len(slices) == split and ctas == 6 * split
    assert sum(f1 - f0 for f0, f1 in slices) == 5


def test_brute_constants_are_the_kernels():
    """BRUTE_TILE, BRUTE_FBLOCK and BRUTE_CTAS are the .cu's BR_TILE,
    BR_FBLOCK and BR_CTAS (evaluated from its constexpr lines)."""
    src = (Path(trz.__file__).parent.parent / "csrc" / "raster_zbuffer.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (BR_\w+) = ([^;]+);", src):
        consts[name] = eval(expr, {}, dict(consts))
    assert (consts["BR_TILE"], consts["BR_FBLOCK"], consts["BR_CTAS"]) == (
        trz.BRUTE_TILE, trz.BRUTE_FBLOCK, trz.BRUTE_CTAS)
    assert consts["BR_TX"] * consts["BR_PX"] == consts["BR_TILE"]


def _scene(name):
    coef, valid, _, _ = zs.scene(name, H, W, n_faces=N_FACES)
    return coef, valid, torch.from_numpy(coef), torch.from_numpy(valid)


@pytest.mark.parametrize("name", zs.NAMES)
def test_split_merge_is_the_plain_and_the_jax_winners(name):
    """Slice by slice over the entry's plan (a slice a 64 faces here: 4 to
    9 slices) and over a forced 3, merged by the key: the unsplit plain version's winners and
    JAX's, exactly. JAX's kernel takes no empty face list: the empty scene
    is held to the plain version (every pixel -1) alone."""
    coef, valid, c, v = _scene(name)
    want = trz.zbuffer_select_plain(c, v, H, W)
    assert len(trz.brute_plan(H, W, c.shape[0])[1]) == max(1, c.shape[0] // trz.BRUTE_FBLOCK)
    for split in (0, 3):
        assert torch.equal(zs.split_plain(trz, c, v, H, W, split), want)
    if name == "empty" or name == "all invalid":
        assert bool((want == -1).all())
        if name == "empty":
            return
    else:
        assert int((want >= 0).sum()) > 1000
    got = jrz.zbuffer_select(jraster._pixel_matrix(H, W), jnp.asarray(coef), jnp.asarray(valid),
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want.numpy())
    ids = want.reshape(H, W)
    if name == "ties":  # every winner is the later of its two copies
        assert bool((ids[ids >= 0] >= N_FACES).all())
    if name == "negzero":  # covered by -0.0 edge values alone
        assert ids[0, 0] == N_FACES + 1 and bool((ids[0, 1:] == N_FACES).all())
    if name == "nan":  # the invalid cover masked; the degenerate faces where inside
        assert not bool((ids == N_FACES).any())
        assert bool((ids[:6, 1:] == N_FACES + 3).all()) and not bool((ids[:, 0] == N_FACES + 3).any())


@pytest.mark.parametrize("name", zs.NAMES)
def test_fold_valid_gives_the_masked_winners(name):
    _, _, c, v = _scene(name)
    folded = trz.fold_valid(c, v)
    assert torch.equal(folded[v].view(torch.int32), c[v].view(torch.int32))
    assert bool(folded[~v, 2, 0].isnan().all())
    got = trz.zbuffer_select_plain(folded, torch.ones_like(v), H, W)
    assert torch.equal(got, trz.zbuffer_select_plain(c, v, H, W))
