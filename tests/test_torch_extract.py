"""The port's mesh extraction vs the JAX package's on an analytic SDF.

The grid is dyadic (spacing 1/32 or 1/64 from -1) and the field a quadratic
with power-of-two coefficients, so every grid value is exact in f32 in both
frameworks whatever the order of operations: the dense and the hierarchical
field passes must agree bit for bit, and marching cubes (the port's g++ build
of its own copy of the C++ source) must give identical vertices and triangles.
"""

import numpy as np
import pytest
import torch

from avatarclip_tpu.export import marching_cubes as jmc
from avatarclip_torch.export import marching_cubes as tmc


def _field(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return x * x + y * y * 2.0 + z * z * 0.5 - 0.25 + 0.5 * x * y


@pytest.mark.parametrize("hierarchical,res,step", [(False, 64, 1 / 32), (True, 128, 1 / 64)])
def test_extraction_matches_jax(hierarchical, res, step):
    bmin, bmax = [-1.0] * 3, [-1.0 + (res - 1) * step] * 3
    ju = jmc.extract_fields(bmin, bmax, res, _field, chunk=4096, hierarchical=hierarchical)
    tu = tmc.extract_fields(bmin, bmax, res, _field, chunk=4096, hierarchical=hierarchical,
                            device="cpu")
    np.testing.assert_array_equal(tu, ju)
    jv, jt = jmc.extract_geometry(bmin, bmax, res, 0.0, _field, hierarchical=hierarchical)
    tv, tt = tmc.extract_geometry(bmin, bmax, res, 0.0, _field, hierarchical=hierarchical,
                                  device="cpu")
    assert tt.shape[0] > 1000
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    if hierarchical:  # tiles were skipped, and the mesh is the dense pass's
        dense = tmc.extract_fields(bmin, bmax, res, _field, chunk=4096, hierarchical=False,
                                   device="cpu")
        assert (dense != tu).any()
        dv, dt = tmc.marching_cubes(dense)
        hv, ht = tmc.marching_cubes(tu)
        np.testing.assert_array_equal(ht, dt)
        np.testing.assert_array_equal(hv, dv)


def test_extract_fields_queries_tensors_on_the_device():
    seen = []

    def query(p):
        seen.append((p.device.type, p.dtype, p.shape[0]))
        return torch.linalg.norm(p, dim=-1) - 0.5

    u = tmc.extract_fields([-1] * 3, [1] * 3, 20, query, chunk=1000, device="cpu")
    assert u.shape == (20, 20, 20) and u.dtype == np.float32
    assert [s[2] for s in seen] == [1000] * 8 and seen[0][:2] == ("cpu", torch.float32)
