"""Configuration: nested dataclasses and string enums with a JSON round trip.

A copy of ``image_captioning_ml_project_tpu.config``: the same fields, the
same defaults and the same JSON form, so a config saved by either package
loads in the other (``tests/test_torch_params.py`` holds the two equal).
The port carries its own copy because it never imports the JAX package.
Fields of parts not yet ported (training, the mesh, the other encoders and
decoders) are kept for that round trip; the port reads only what its slice
runs. Enums are string-valued, so a member equals its value and the same
member of the JAX package's enum.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields, is_dataclass
from enum import Enum
from typing import Any, Dict


class EncoderType(str, Enum):
    RESNET = "resnet"
    VIT = "vit"
    SWIN = "swin"
    CONVNEXT = "convnext"
    EFFICIENTNET = "efficientnet"
    CLIP = "clip"
    OBJECT_REGION = "object_region"


class DecoderType(str, Enum):
    LSTM = "lstm"
    TRANSFORMER = "transformer"
    GPT2 = "gpt2"
    T5 = "t5"
    BART = "bart"


class AttentionType(str, Enum):
    SOFT = "soft"
    MULTI_HEAD = "multi_head"
    ADAPTIVE = "adaptive"
    AOA = "aoa"
    OBJECT = "object"


@dataclass
class EncoderConfig:
    encoder_type: EncoderType = EncoderType.VIT
    pretrained_model_name: str = "google/vit-base-patch16-224"
    freeze: bool = False
    feature_dim: int = 768
    use_object_features: bool = False
    image_size: int = 224
    patch_size: int = 16  # ViT/CLIP patch size
    hidden_size: int = 768  # backbone width before the projection
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    resnet_depths: tuple = (3, 4, 6, 3)
    resnet_hidden_sizes: tuple = (256, 512, 1024, 2048)
    resnet_embedding_size: int = 64
    resnet_layer_type: str = "bottleneck"
    swin_window_size: int = 7
    swin_embed_dim: int = 128
    swin_depths: tuple = (2, 2, 18, 2)
    swin_num_heads: tuple = (4, 8, 16, 32)
    max_objects: int = 36
    region_feature_dim: int = 2048
    remat: bool = False
    fused_qkv: bool = False


@dataclass
class DecoderConfig:
    decoder_type: DecoderType = DecoderType.GPT2
    pretrained_model_name: str = "gpt2"
    hidden_dim: int = 768
    num_layers: int = 6
    num_heads: int = 8
    dropout: float = 0.1
    max_length: int = 50
    prefix_length: int = 10  # GPT-2 image-prefix tokens
    gpt2_n_positions: int = 1024
    decode_kernel: str = "auto"


@dataclass
class AttentionConfig:
    attention_type: AttentionType = AttentionType.MULTI_HEAD
    num_heads: int = 8
    temperature: float = 1.0
    use_geometric: bool = False
    hidden_dim: int = 768
    use_pallas: bool = False


@dataclass
class TrainingConfig:
    batch_size: int = 64
    num_epochs: int = 15
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    lr_scheduler: str = "cosine"
    warmup_steps: int = 2000
    use_rl: bool = True
    rl_start_epoch: int = 10
    rl_reward: str = "cider"
    rl_weight: float = 1.0
    rl_on_device_reward: bool = True
    use_amp: bool = True
    adam_mu_dtype: str = "float32"
    use_curriculum: bool = False
    curriculum_strategy: str = "caption_length"
    curriculum_pacing: str = "linear"
    use_contrastive_loss: bool = False
    use_itm_loss: bool = False
    use_obj_cls_loss: bool = False
    attention_reg_weight: float = 0.0
    grad_clip_norm: float = 0.0
    contrastive_weight: float = 0.1
    itm_weight: float = 0.1
    contrastive_temperature: float = 0.07


@dataclass
class InferenceConfig:
    decoding_strategy: str = "beam"  # greedy | beam | nucleus
    beam_size: int = 5
    top_p: float = 0.9
    temperature: float = 1.0
    min_length: int = 5
    max_length: int = 20
    length_penalty: float = 0.8
    num_beam_groups: int = 1
    diversity_penalty: float = 0.5
    use_clip_reranking: bool = False
    num_candidates: int = 5


@dataclass
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass
class ModelConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    projection_dim: int = 768
    use_q_former: bool = False
    q_former_num_queries: int = 32
    vocab_size: int = 50257
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    q_former_num_layers: int = 2
    q_former_num_heads: int = 8
    dtype: str = "bfloat16"  # weight and compute dtype when serving


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data_root: str = "data"
    train_json: str = "annotations/captions_train2014.json"
    val_json: str = "annotations/captions_val2014.json"
    train_image_dir: str = "train2014"
    val_image_dir: str = "val2014"
    features_dir: str = "features"
    image_size: int = 224
    output_dir: str = "outputs"
    checkpoint_dir: str = "checkpoints"
    log_every: int = 100
    save_every: int = 1
    save_every_steps: int = 0
    step_ckpt_max_overhead: float = 0.0
    device: str = "tpu"
    num_workers: int = 4
    seed: int = 42
    device_resize: bool = False
    native_loader: bool = False
    native_threads: int = 0
    native_draft: bool = False
    fold_normalize: bool = False


def get_default_config() -> Config:
    return Config()


_ENUM_FIELDS = {
    "encoder_type": EncoderType,
    "decoder_type": DecoderType,
    "attention_type": AttentionType,
}
_TUPLE_FIELDS = {"resnet_depths", "resnet_hidden_sizes", "swin_depths",
                 "swin_num_heads"}


def _serialize(obj: Any) -> Any:
    if is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _serialize(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def config_to_dict(config: Any) -> Dict[str, Any]:
    """A (possibly nested) config dataclass as plain JSON types."""
    return _serialize(config)


def save_config(config: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(config_to_dict(config), f, indent=2)


def _build_dataclass(cls, data: Dict[str, Any]):
    """Rebuild a dataclass from a plain dict, coercing enums, tuples and
    nested dataclasses; unknown keys are ignored."""
    kwargs = {}
    cls_fields = {f.name: f for f in fields(cls)}
    for name, value in data.items():
        if name not in cls_fields:
            continue
        if name in _ENUM_FIELDS:
            kwargs[name] = _ENUM_FIELDS[name](value)
        elif name in _TUPLE_FIELDS and isinstance(value, list):
            kwargs[name] = tuple(value)
        elif isinstance(value, dict) and cls_fields[name].type in _NESTED:
            kwargs[name] = _build_dataclass(_NESTED[cls_fields[name].type],
                                            value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


# field annotations are strings under ``from __future__ import annotations``
_NESTED = {c.__name__: c for c in (EncoderConfig, DecoderConfig,
                                   AttentionConfig, TrainingConfig,
                                   InferenceConfig, MeshConfig, ModelConfig)}


def config_from_dict(data: Dict[str, Any]) -> Config:
    return _build_dataclass(Config, data)


def load_config(path: str) -> Config:
    with open(path) as f:
        return config_from_dict(json.load(f))
