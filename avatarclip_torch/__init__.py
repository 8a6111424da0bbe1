"""avatarclip_torch: the PyTorch + CUDA (NVIDIA Hopper) port of avatarclip_tpu.

The JAX package :mod:`avatarclip_tpu` stays the reference; every module here
is the torch twin of the module of the same name there, held against it by a
``tests/test_torch_*.py`` parity test. It runs AppearanceGen's photometric
``train`` and CLIP-guided ``train_clip`` steps and their validations
(:mod:`avatarclip_torch.pipelines.appearance`) and AvatarAnimate's pose and
motion generators (:mod:`avatarclip_torch.pipelines.animate`), with the NeuS
kernel pairs, the compositing pair, the tiled z-buffer and the soft
rasterizer's aggregation pair as hand-written CUDA kernels (``csrc/``, built
at first use by :mod:`avatarclip_torch.ops._build`).
"""

__version__ = "0.1.0"
