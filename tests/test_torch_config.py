"""The port's own copies of the HOCON parser and the CLIP tokenizer vs the JAX
package's: every conf under ``confs/`` parses to the same dict, and the
prompts of ``confs/examples`` tokenize to the same ids."""

import glob
import os

import numpy as np

from avatarclip_tpu import config as jconfig
from avatarclip_tpu.clipjax import tokenizer as jtok
from avatarclip_torch import config as tconfig
from avatarclip_torch.clip import tokenizer as ttok

CONFS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "confs")


def test_every_conf_parses_as_in_jax():
    paths = sorted(glob.glob(os.path.join(CONFS, "**", "*.conf"), recursive=True))
    assert len(paths) > 100
    for p in paths:
        assert tconfig.parse_file(p, case="smpl").as_dict() == \
            jconfig.parse_file(p, case="smpl").as_dict(), p


def test_example_prompts_tokenize_as_in_jax():
    prompts = []
    for p in sorted(glob.glob(os.path.join(CONFS, "examples", "*.conf"))):
        conf = jconfig.parse_file(p)
        prompts += [conf.get_string(k) for k in ("clip.prompt", "clip.face_prompt",
                                                 "clip.back_prompt") if k in conf]
    assert len(prompts) >= 10
    np.testing.assert_array_equal(ttok.tokenize(prompts), jtok.tokenize(prompts))
    assert type(ttok.default_tokenizer()).__name__ == type(jtok.default_tokenizer()).__name__

