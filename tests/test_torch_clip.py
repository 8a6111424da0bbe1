"""Parity of the port's CLIP (avatarclip_torch/clip) with
avatarclip_tpu/clipjax at the ``tiny`` config: image and text encoders with
parameters converted from JAX, the antialiased bilinear resize on a
downsample and an upsample, normalisation and cosine. Tolerance 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu.clipjax import model as jclip
from avatarclip_tpu.clipjax import tokenizer
from avatarclip_tpu.utils.pytree import tree_flatten_paths
from avatarclip_torch.clip import model as tclip
from avatarclip_torch.utils.convert import params_from_jax

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg = jclip.CLIPConfig(image_size=64, patch_size=16, vision_width=64, vision_layers=2,
                           vision_heads=2, embed_dim=32, context_length=77, vocab_size=49408,
                           text_width=64, text_layers=2, text_heads=2)
    params = jclip.init_params(jax.random.PRNGKey(42), cfg)
    return cfg, params, params_from_jax(tree_flatten_paths(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoders_match_jax(tiny, dtype):
    import dataclasses

    jcfg, jparams, tparams = tiny
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    tcfg = dataclasses.replace(tclip.TINY, compute_dtype=dtype)
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jclip.encode_image(jparams, jcfg, jclip.normalize_image(jnp.asarray(imgs)))
    got = tclip.encode_image(tparams, tcfg, tclip.normalize_image(torch.from_numpy(imgs)))
    tol = TOL if dtype == "float32" else 2e-2  # bf16 rounding of the patch embedding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    toks = tokenizer.tokenize(["a test person", "the back of a test person"])
    want_t = jclip.encode_text(jparams, jcfg, jnp.asarray(toks))
    got_t = tclip.encode_text(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        float(tclip.cosine_similarity(got[0], got_t[1])),
        float(jclip.cosine_similarity(want[0], want_t[1])), atol=tol,
    )


@pytest.mark.parametrize("src", [100, 32])  # downsample (antialiased) and upsample
def test_resize_matches_jax_image_resize(src):
    img = np.random.default_rng(src).uniform(0, 1, (1, src, src, 3)).astype(np.float32)
    want = jclip.resize_to_clip(jnp.asarray(img), 64)
    got = tclip.resize_to_clip(torch.from_numpy(img), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    gt = np.random.default_rng(1).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(gt), (32, 32, 3), "bilinear")
    got = tclip.resize_image(torch.from_numpy(gt)[None], 32, 32)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
