"""MAGI in PyTorch and CUDA: the port of `magi_tpu` (JAX/Pallas) to one
NVIDIA Hopper GPU.

Same module layout and function names as `magi_tpu`, so each function's
counterpart is easy to find.  Dense work is plain PyTorch; each Pallas
kernel on the ported path is a hand-written CUDA kernel under `csrc/`,
built at first use (`ops/_lib.py`).  This package never imports `jax` or
`magi_tpu`.

  core/        config, logging, timing, seeding
  ops/         CUDA kernel wrappers + their plain PyTorch versions
  models/      DiT and ViT-VAE (encoder and decoder)
  sampling/    ARDF schedules, kv ranges, the denoising walk
  checkpoint/  parameter trees carried over from the JAX package
  pipeline/    prompt/video processing, MagiPipeline, CLI
"""

__version__ = "0.1.0"

from magi_tpu_torch.core.config import EngineConfig, MagiConfig, ModelConfig, RuntimeConfig

__all__ = ["MagiConfig", "ModelConfig", "RuntimeConfig", "EngineConfig", "__version__"]
