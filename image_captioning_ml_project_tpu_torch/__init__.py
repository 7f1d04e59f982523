"""image_captioning_ml_project_tpu_torch — the PyTorch/CUDA port of
:mod:`image_captioning_ml_project_tpu` for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference: every module here mirrors
its counterpart's name and public layouts (NHWC images, flat ``[Bk, S, H]``
decode caches, per-image ``[B, P, H]`` prefix K/V, ``[Bk, L]`` beam
ancestry), and the tests hold the two against each other on the CPU.

This package imports ``torch`` and never ``jax``, nor the JAX package: it
carries its own copies of the JAX package's pure-Python host code it needs
(:mod:`.config`, :mod:`.data.tokenizer`, :mod:`.data.coco`,
:mod:`.data.synthetic`, :mod:`.evaluate.metrics`, :mod:`.utils.logging`),
which the tests hold equal to their originals.

The port serves three families (CLIP + GPT-2, ViT + Transformer decoder,
ResNet + LSTM) through every decoding strategy and
:mod:`.inference.server`, and trains them with cross-entropy
(:mod:`.train.trainer`), with checkpoints in torch's own format that the
server loads and reloads. Each kernel of the JAX package has a
hand-written CUDA C++ counterpart under ``csrc/``, bound with ctypes by a
wrapper in :mod:`.ops`; the training step reaches none of them (they have
no backward), its validation and the server do.
"""

__version__ = "0.1.0"
