"""image_captioning_ml_project_tpu_torch — the PyTorch/CUDA port of
:mod:`image_captioning_ml_project_tpu` for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference: every module here mirrors
its counterpart's name and public layouts (NHWC images, flat ``[Bk, S, H]``
decode caches, per-image ``[B, P, H]`` prefix K/V, ``[Bk, L]`` beam
ancestry), and the tests hold the two against each other on the CPU.

This package imports ``torch`` and never ``jax``, nor the JAX package: it
carries its own copies of the JAX package's pure-Python host code it needs
(:mod:`.config`, :mod:`.data.tokenizer`, the image half of
:mod:`.data.coco`), which the tests hold equal to their originals.

The slice ported so far is the caption-serving main path: CLIP ViT vision
tower -> image prefix -> GPT-2 ``init_cache`` -> beam search, served by
:mod:`.inference.server`. Its two hand-written GPU kernels are
:mod:`.ops.beam_decode_attention` (CUDA C++, ``csrc/``) and
:mod:`.ops.lse` (Triton).
"""

__version__ = "0.1.0"
