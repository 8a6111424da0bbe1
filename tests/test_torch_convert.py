"""The port's converters and parameter writer against the JAX package's:

  * the CLIP checkpoint converter (avatarclip_torch/clip/convert.py against
    avatarclip_tpu/clipjax/convert.py) on one seeded state dict, built here
    with OpenAI's and with HuggingFace's key names at a narrow width: the two
    npz files equal, array by array (bit for bit), through
    ``convert_checkpoint`` (ViT-B/32's 12 + 12 layers) and the layout
    functions at the tiny CLIP's depth; the port's ``load_npz`` reads the
    result as the tree its ``init_params`` makes;
  * ``body/smpl.convert_pkl_to_npz`` on a pickled synthetic SMPL model (dense
    and scipy-sparse J_regressor): the npz files equal;
  * ``utils/convert.params_to_jax``, the writer of the reference schedule's
    ``full_pretrain.npz``: JAX's ``load_pytree_npz`` reads it and its
    ``sdf_apply`` / ``color_apply`` / ``variance_inv_s`` on it give the port's
    outputs to 1e-5; the round trip back through ``params_from_jax`` is
    exact, and a Runner whose conf names the file as ``train.pretrain``
    starts from exactly those fields.
"""

import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avatarclip_tpu import config as config_mod
from avatarclip_tpu.body import smpl as jsmpl
from avatarclip_tpu.clipjax import convert as jconvert
from avatarclip_tpu.clipjax import model as jclip
from avatarclip_tpu.fields import networks as jnets
from avatarclip_tpu.pipelines import appearance as japp
from avatarclip_tpu.pipelines import synthetic as jsyn
from avatarclip_tpu.utils.pytree import load_pytree_npz
from avatarclip_torch.body import smpl as tsmpl
from avatarclip_torch.clip import convert as tconvert
from avatarclip_torch.clip import model as tclip
from avatarclip_torch.pipelines import appearance as tapp
from avatarclip_torch.utils.convert import params_from_jax, params_to_jax
from avatarclip_torch.utils.pytree import tree_flatten_paths

NARROW = dict(image_size=16, patch_size=8, vision_width=8, vision_heads=2, embed_dim=4,
              context_length=5, vocab_size=11, text_width=8, text_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny tensors' many small ops thrash when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_keys(w: int, hf: bool) -> dict:
    """One block's (key -> shape) in the layout's names."""
    if hf:
        out = {f"self_attn.{x}_proj.{t}": (w, w) if t == "weight" else (w,)
               for x in ("q", "k", "v", "out") for t in ("weight", "bias")}
        ln, fc = ("layer_norm1", "layer_norm2"), ("mlp.fc1", "mlp.fc2")
    else:
        out = {"attn.in_proj_weight": (3 * w, w), "attn.in_proj_bias": (3 * w,),
               "attn.out_proj.weight": (w, w), "attn.out_proj.bias": (w,)}
        ln, fc = ("ln_1", "ln_2"), ("mlp.c_fc", "mlp.c_proj")
    for n in ln:
        out[f"{n}.weight"], out[f"{n}.bias"] = (w,), (w,)
    out[f"{fc[0]}.weight"], out[f"{fc[0]}.bias"] = (4 * w, w), (4 * w,)
    out[f"{fc[1]}.weight"], out[f"{fc[1]}.bias"] = (w, 4 * w), (w,)
    return out


def _state_dict(layout: str, n_vision: int, n_text: int, seed: int = 0) -> dict:
    """A seeded CLIP state dict in OpenAI's or HuggingFace's key names."""
    c = NARROW
    vw, tw, P = c["vision_width"], c["text_width"], c["patch_size"]
    T = (c["image_size"] // P) ** 2 + 1
    hf = layout == "hf"
    if hf:
        shapes = {
            "vision_model.embeddings.patch_embedding.weight": (vw, 3, P, P),
            "vision_model.embeddings.class_embedding": (vw,),
            "vision_model.embeddings.position_embedding.weight": (T, vw),
            "vision_model.pre_layrnorm.weight": (vw,), "vision_model.pre_layrnorm.bias": (vw,),
            "vision_model.post_layernorm.weight": (vw,), "vision_model.post_layernorm.bias": (vw,),
            "visual_projection.weight": (c["embed_dim"], vw),
            "text_model.embeddings.token_embedding.weight": (c["vocab_size"], tw),
            "text_model.embeddings.position_embedding.weight": (c["context_length"], tw),
            "text_model.final_layer_norm.weight": (tw,), "text_model.final_layer_norm.bias": (tw,),
            "text_projection.weight": (c["embed_dim"], tw),
        }
        vis, txt = "vision_model.encoder.layers.", "text_model.encoder.layers."
    else:
        shapes = {
            "visual.conv1.weight": (vw, 3, P, P), "visual.class_embedding": (vw,),
            "visual.positional_embedding": (T, vw),
            "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,),
            "visual.ln_post.weight": (vw,), "visual.ln_post.bias": (vw,),
            "visual.proj": (vw, c["embed_dim"]),
            "token_embedding.weight": (c["vocab_size"], tw),
            "positional_embedding": (c["context_length"], tw),
            "ln_final.weight": (tw,), "ln_final.bias": (tw,),
            "text_projection": (tw, c["embed_dim"]),
        }
        vis, txt = "visual.transformer.resblocks.", "transformer.resblocks."
    shapes["logit_scale"] = ()
    for prefix, n, w in ((vis, n_vision, vw), (txt, n_text, tw)):
        for i in range(n):
            shapes.update({f"{prefix}{i}.{k}": s for k, s in _block_keys(w, hf).items()})
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) for k, s in shapes.items()}


def _assert_npz_equal(a: str, b: str) -> None:
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_convert_checkpoint_writes_the_jax_converters_npz(tmp_path, layout):
    """``convert_checkpoint`` (ViT-B/32's depth: 12 + 12 layers) on a torch
    file of the state dict, and on a file holding it under ``state_dict``."""
    sd = _state_dict(layout, 12, 12)
    for i, obj in enumerate((sd, {"state_dict": sd})):
        src = str(tmp_path / f"ckpt{i}.pt")
        torch.save(obj, src)
        jconvert.convert_checkpoint(src, str(tmp_path / f"jax{i}.npz"))
        tconvert.convert_checkpoint(src, str(tmp_path / f"torch{i}.npz"))
        _assert_npz_equal(str(tmp_path / f"jax{i}.npz"), str(tmp_path / f"torch{i}.npz"))


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_layout_converters_match_jax_and_load_as_the_ports_tree(tmp_path, layout):
    """The layout functions at the tiny CLIP's depth (2 + 2 layers): the
    same arrays as JAX's, and ``clip/model.load_npz`` gives the tree that
    ``init_params`` makes at that config (same paths and shapes)."""
    sd = _state_dict(layout, 2, 2, seed=1)
    jcfg = jclip.CLIPConfig(vision_layers=2, text_layers=2, **NARROW)
    tcfg = tclip.CLIPConfig(vision_layers=2, text_layers=2, **NARROW)
    fn = {"openai": "from_openai_state_dict", "hf": "from_hf_state_dict"}[layout]
    jconvert.save_npz(getattr(jconvert, fn)(sd, jcfg), str(tmp_path / "jax.npz"))
    tconvert.save_npz(getattr(tconvert, fn)(sd, tcfg), str(tmp_path / "torch.npz"))
    _assert_npz_equal(str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz"))
    loaded = tree_flatten_paths(tclip.load_npz(str(tmp_path / "torch.npz")))
    init = tree_flatten_paths(tclip.init_params(tcfg, torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in loaded.items()} == {k: tuple(v.shape) for k, v in init.items()}


def test_convert_checkpoint_rejects_an_unknown_layout(tmp_path):
    torch.save({"foo.weight": torch.zeros(2)}, str(tmp_path / "x.pt"))
    with pytest.raises(ValueError, match="unrecognized"):
        tconvert.convert_checkpoint(str(tmp_path / "x.pt"), str(tmp_path / "x.npz"))


@pytest.mark.parametrize("sparse", [False, True])
def test_convert_pkl_to_npz_matches_jax(tmp_path, sparse):
    """A pickled SMPL-layout model (posedirs (V, 3, 207), a kintree table,
    SMPL's 10 + extra betas) converts to the same npz in both packages."""
    import scipy.sparse

    g = np.random.default_rng(2)
    V, J = 40, 24
    jreg = g.uniform(0, 1, (J, V))
    model = {
        "v_template": g.normal(size=(V, 3)),
        "shapedirs": g.normal(size=(V, 3, 12)),
        "posedirs": g.normal(size=(V, 3, 9 * (J - 1))),
        "J_regressor": scipy.sparse.csc_matrix(jreg) if sparse else jreg,
        "weights": g.uniform(0, 1, (V, J)),
        "kintree_table": np.stack([np.r_[np.int64(4294967295), tsmpl.SMPL_PARENTS[1:].astype(np.int64)],
                                   np.arange(J)]),
        "f": g.integers(0, V, (30, 3)).astype(np.uint32),
    }
    pkl = str(tmp_path / "model.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(model, f, protocol=2)
    jsmpl.convert_pkl_to_npz(pkl, str(tmp_path / "jax.npz"))
    tsmpl.convert_pkl_to_npz(pkl, str(tmp_path / "torch.npz"))
    _assert_npz_equal(str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz"))
    m = tsmpl.load_smpl_npz(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(m.parents, tsmpl.SMPL_PARENTS)
    assert m.shapedirs.shape == (V, 3, 10) and m.posedirs.shape == (9 * (J - 1), 3 * V)


@pytest.fixture(scope="module")
def tiny_conf(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("writer")
    data = jsyn.write_synthetic_views(str(tmp / "views"), n_views=2, res=32)
    return tmp, jsyn.make_conf_text(str(tmp / "exp"), data, "tiny")


def _perturbed_runner(conf_text):
    """A tiny port Runner whose every parameter is moved off its init."""
    tr = tapp.Runner(None, mode="none", conf=config_mod.parse_string(conf_text), device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in tr.fields.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return tr


def test_params_to_jax_is_read_back_by_jax(tiny_conf):
    tmp, conf_text = tiny_conf
    tr = _perturbed_runner(conf_text)
    path = str(tmp / "full_pretrain.npz")
    np.savez_compressed(path, **params_to_jax(tr.fields, prefix="params/"))
    tree = load_pytree_npz(path)["params"]
    _, cfgs = japp.build_network_configs(config_mod.parse_string(conf_text))

    g = np.random.default_rng(4)
    pts = g.uniform(-1, 1, (96, 3)).astype(np.float32)
    want = np.asarray(jnets.sdf_apply(tree["sdf"], cfgs.sdf, jnp.asarray(pts)))
    got = tr.fields.sdf(torch.from_numpy(pts)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    nrm, dirs = (g.normal(size=(96, 3)).astype(np.float32) for _ in range(2))
    feat = want[:, 1:].copy()
    want_c = np.asarray(jnets.color_apply(tree["color"], cfgs.color,
                                          *(jnp.asarray(a) for a in (pts, nrm, dirs, feat))))
    got_c = tr.fields.color(*(torch.from_numpy(a) for a in (pts, nrm, dirs, feat))).detach().numpy()
    np.testing.assert_allclose(got_c, want_c, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tr.fields.variance.inv_s().detach()),
                               float(jnets.variance_inv_s(tree["variance"])), rtol=1e-5)

    back = tapp.Runner(None, mode="none", conf=config_mod.parse_string(conf_text), device="cpu")
    with np.load(path) as data:
        params_from_jax(dict(data), back.fields, prefix="params/")
    for (n, a), (_, b) in zip(tr.fields.state_dict().items(), back.fields.state_dict().items()):
        assert torch.equal(a, b), n


def test_runner_starts_from_the_written_pretrain(tiny_conf):
    """The sculpt conf's ``train.pretrain`` reads the writer's npz: the key
    paths are the ones ``params_from_jax(prefix="params/")`` takes, the
    variance included."""
    tmp, conf_text = tiny_conf
    tr = _perturbed_runner(conf_text)
    path = str(tmp / "pretrain_for_runner.npz")
    np.savez_compressed(path, **params_to_jax(tr.fields, prefix="params/"))
    conf = config_mod.parse_string(conf_text)
    conf.put("train.pretrain", path)
    r = tapp.Runner(None, mode="none", conf=conf, device="cpu")
    sd = r.fields.state_dict()
    assert "variance.variance" in sd
    for n, a in tr.fields.state_dict().items():
        assert torch.equal(sd[n], a), n
    # and so does the JAX Runner
    jr = japp.Runner(None, mode="none", conf=config_mod.parse_string(
        jsyn.make_conf_text(str(tmp / "exp_j"), conf.get_string("dataset.data_dir"), "tiny")))
    jr_conf = jr.conf
    jr_conf.put("train.pretrain", path)
    jr2 = japp.Runner(None, mode="none", conf=jr_conf)
    flat = {k: np.asarray(v) for k, v in tree_flatten_paths(jr2.params).items()}
    assert sorted(flat) == sorted(k.replace(".", "/") for k in sd)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, sd[k.replace("/", ".")].numpy(), err_msg=k)
