"""Three-part JSON config system (model / runtime / engine).

The same schema as `magi_tpu.core.config`, so every `example/*/*.json`
loads unchanged into the same field values.  `params_dtype` decodes to a
torch dtype ("torch.bfloat16" and "bfloat16" spellings both accepted) and
is written back torch-style.  Engine fields that name TPU mesh knobs are
kept so the files round-trip; this port runs them on one device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List

import torch

_DTYPE_DECODE = {
    "torch.bfloat16": torch.bfloat16,
    "torch.float16": torch.float16,
    "torch.float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}

_DTYPE_ENCODE = {
    torch.bfloat16: "torch.bfloat16",
    torch.float16: "torch.float16",
    torch.float32: "torch.float32",
}


@dataclasses.dataclass
class ModelConfig:
    """DiT architecture parameters."""

    model_name: str

    # Transformer
    num_layers: int = None
    hidden_size: int = None
    ffn_hidden_size: int = None
    num_attention_heads: int = None
    num_query_groups: int = 1  # GQA kv-head groups
    kv_channels: int = None  # per-head dim
    layernorm_epsilon: float = 1e-6
    apply_layernorm_1p: bool = False  # zero-centered gamma
    x_rescale_factor: float = 1.0
    half_channel_vae: bool = False
    params_dtype: Any = None  # torch dtype

    # Embedding
    patch_size: int = 2
    t_patch_size: int = 1
    in_channels: int = 4
    out_channels: int = 4
    cond_hidden_ratio: float = 0.25
    caption_channels: int = 4096
    caption_max_length: int = 800
    xattn_cond_hidden_ratio: float = 1.0
    cond_gating_ratio: float = 1.0
    gated_linear_unit: bool = False

    @property
    def cond_hidden_size(self) -> int:
        return int(self.hidden_size * self.cond_hidden_ratio)

    @property
    def xattn_cond_hidden_size(self) -> int:
        return int(self.hidden_size * self.xattn_cond_hidden_ratio)

    @property
    def gate_hidden_size(self) -> int:
        return int(self.hidden_size * self.cond_gating_ratio)


@dataclasses.dataclass
class RuntimeConfig:
    """Generation-time settings."""

    cfg_number: int = None
    cfg_t_range: List[float] = dataclasses.field(default_factory=lambda: [0, 0.0217, 0.1000, 0.3, 0.999])
    prev_chunk_scales: List[float] = dataclasses.field(default_factory=lambda: [1.5, 1.5, 1.5, 1.5, 1.5])
    text_scales: List[float] = dataclasses.field(default_factory=lambda: [7.5, 7.5, 7.5, 7.5, 7.5])

    noise2clean_kvrange: List[int] = dataclasses.field(default_factory=list)
    clean_chunk_kvrange: int = -1
    clean_t: float = 1.0

    # Video settings
    seed: int = 1234
    num_frames: int = 128
    video_size_h: int = None
    video_size_w: int = None
    num_steps: int = 64
    window_size: int = 4
    fps: int = 24
    chunk_width: int = 6

    # Checkpoints
    t5_pretrained: str = None
    t5_device: str = "auto"
    vae_pretrained: str = None
    scale_factor: float = 0.18215
    temporal_downsample_factor: int = 4
    load: str = None


@dataclasses.dataclass
class EngineConfig:
    """Execution strategy.  Parallelism, quantization, distill and offload
    fields are read from the file; this slice of the port runs the bf16
    single-device path and refuses the others in `MagiPipeline`."""

    distributed_backend: str = "nccl"
    distributed_timeout_minutes: int = 10
    pp_size: int = 1
    cp_size: int = 1
    cp_strategy: str = "none"  # {none, cp_ulysses, cp_shuffle_overlap}
    ulysses_overlap_degree: int = 1

    # Quantization
    fp8_quant: bool = False
    quant_bits: int = 8
    attn_int8: bool = False

    # Distillation
    distill_nearly_clean_chunk_threshold: float = 0.3
    shortcut_mode: str = "8,16,16"
    distill: bool = False

    # Optimization
    kv_offload: bool = False
    # accepted and ignored, as in the JAX package ("jit subsumes this"): on
    # the card the port always captures its steps and VAE forwards in CUDA
    # graphs, its counterpart of jit (`core.graphs`), and only the
    # constructor argument `capture=False` (samplers, pipeline, VAE) runs
    # eagerly
    enable_cuda_graph: bool = False

    # Extensions of the JAX package (absent fields default)
    tp_size: int = 1
    dp_size: int = 1
    high_precision_matmul: bool = False
    pack_uncond: bool = False

    @property
    def world_size(self) -> int:
        return self.pp_size * self.cp_size * self.tp_size * self.dp_size


@dataclasses.dataclass
class MagiConfig:
    model_config: ModelConfig
    runtime_config: RuntimeConfig
    engine_config: EngineConfig

    @classmethod
    def _check_missing_fields(cls, config_dict: dict, required_fields) -> None:
        missing = set(required_fields) - set(config_dict.keys())
        if missing:
            raise ValueError(f"Missing fields in the configuration file: {', '.join(sorted(missing))}")

    @classmethod
    def _create_nested_config(cls, config_dict: dict, name: str, config_cls, required: List[str]):
        nested = dict(config_dict.get(name, {}))
        cls._check_missing_fields(nested, required)
        known = {f.name for f in dataclasses.fields(config_cls)}
        unknown = set(nested.keys()) - known
        if unknown:
            raise ValueError(f"Unknown fields in {name}: {', '.join(sorted(unknown))}")
        return config_cls(**nested)

    # Every field of the upstream dataclasses must be present in the JSON;
    # extension fields are optional so upstream configs load unchanged.
    _REFERENCE_MODEL_FIELDS = [
        "model_name", "num_layers", "hidden_size", "ffn_hidden_size",
        "num_attention_heads", "num_query_groups", "kv_channels",
        "layernorm_epsilon", "apply_layernorm_1p", "x_rescale_factor",
        "half_channel_vae", "params_dtype", "patch_size", "t_patch_size",
        "in_channels", "out_channels", "cond_hidden_ratio", "caption_channels",
        "caption_max_length", "xattn_cond_hidden_ratio", "cond_gating_ratio",
        "gated_linear_unit",
    ]
    _REFERENCE_RUNTIME_FIELDS = [
        "cfg_number", "cfg_t_range", "prev_chunk_scales", "text_scales",
        "noise2clean_kvrange", "clean_chunk_kvrange", "clean_t", "seed",
        "num_frames", "video_size_h", "video_size_w", "num_steps",
        "window_size", "fps", "chunk_width", "t5_pretrained", "t5_device",
        "vae_pretrained", "scale_factor", "temporal_downsample_factor", "load",
    ]
    _REFERENCE_ENGINE_FIELDS = [
        "distributed_backend", "distributed_timeout_minutes", "pp_size",
        "cp_size", "cp_strategy", "ulysses_overlap_degree", "fp8_quant",
        "distill_nearly_clean_chunk_threshold", "shortcut_mode", "distill",
        "kv_offload", "enable_cuda_graph",
    ]

    @classmethod
    def _create_config_from_dict(cls, config_dict: dict) -> "MagiConfig":
        cls._check_missing_fields(config_dict, ["model_config", "runtime_config", "engine_config"])
        model_config = cls._create_nested_config(config_dict, "model_config", ModelConfig, cls._REFERENCE_MODEL_FIELDS)
        runtime_config = cls._create_nested_config(
            config_dict, "runtime_config", RuntimeConfig, cls._REFERENCE_RUNTIME_FIELDS
        )
        engine_config = cls._create_nested_config(
            config_dict, "engine_config", EngineConfig, cls._REFERENCE_ENGINE_FIELDS
        )
        return cls(model_config=model_config, runtime_config=runtime_config, engine_config=engine_config)

    @classmethod
    def from_dict(cls, config_dict: dict) -> "MagiConfig":
        config_dict = json.loads(json.dumps(config_dict))  # deep copy
        mc = config_dict.get("model_config", {})
        if "params_dtype" in mc and isinstance(mc["params_dtype"], str):
            mc["params_dtype"] = _DTYPE_DECODE[mc["params_dtype"]]
        config = cls._create_config_from_dict(config_dict)
        config.post_validation()
        return config

    @classmethod
    def from_json(cls, json_path: str) -> "MagiConfig":
        with open(json_path, "r") as f:
            config_dict = json.load(f)
        return cls.from_dict(config_dict)

    def post_validation(self) -> None:
        # distill/quant models run single-branch cfg; base runs 3-branch
        if self.engine_config.fp8_quant or self.engine_config.distill:
            if self.runtime_config.cfg_number != 1:
                raise ValueError("Please set `cfg_number: 1` in config.json for distill or quant model")
        elif self.runtime_config.cfg_number != 3:
            raise ValueError("Please set `cfg_number: 3` in config.json for base model")
        if self.engine_config.cp_strategy not in ("none", "cp_ulysses", "cp_shuffle_overlap"):
            raise ValueError(f"unknown cp_strategy {self.engine_config.cp_strategy!r}")

    def to_json(self, json_path: str) -> None:
        config_dict = {
            "model_config": dataclasses.asdict(self.model_config),
            "runtime_config": dataclasses.asdict(self.runtime_config),
            "engine_config": dataclasses.asdict(self.engine_config),
        }
        dt = config_dict["model_config"]["params_dtype"]
        if dt is not None and not isinstance(dt, str):
            config_dict["model_config"]["params_dtype"] = _DTYPE_ENCODE.get(dt, str(dt))
        dirname = os.path.dirname(json_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(config_dict, f, indent=4)
