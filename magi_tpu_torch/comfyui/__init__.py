"""ComfyUI node pack of the PyTorch/CUDA port (the counterpart of
`magi_tpu.comfyui`): the special tokens' path set as the JAX pack sets it,
then the nodes."""

import os

os.environ.setdefault(
    "SPECIAL_TOKEN_PATH",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "example", "assets", "special_tokens.npz"),
)

from magi_tpu_torch.comfyui.comfy_nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS  # noqa: E402

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
