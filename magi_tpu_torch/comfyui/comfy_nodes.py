"""ComfyUI custom nodes of the PyTorch/CUDA port: the JAX pack's six nodes
(`magi_tpu.comfyui.comfy_nodes`) with the same inputs, outputs and
mappings, under a category of their own.

Node classes follow the ComfyUI protocol (plain classes with INPUT_TYPES /
RETURN_TYPES / FUNCTION): no comfy import at module load, so the file
works standalone.  `MagiProcess` runs the whole pipeline in this process on
the card; a later call of an equal config replays the step graphs the
first one captured (the DiT tree stays resident, `pipeline.get_dit`)."""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


class MagiPromptLoader:
    """Load a text prompt."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"prompt": ("STRING", {"multiline": True, "default": "a video of"})}}

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("prompt",)
    FUNCTION = "load"
    CATEGORY = "MAGI (PyTorch/CUDA)"

    def load(self, prompt):
        return (prompt,)


class MagiTextEncoder:
    """Standalone T5 encoding, staged onto the card for the encode.
    `tokenizer` (a class attribute) stands in for the `transformers`
    tokenizer of `t5_pretrained` where that package is missing."""

    tokenizer = None

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "prompt": ("STRING", {"forceInput": True}),
                "t5_pretrained": ("STRING", {"default": "./downloads/t5_pretrained"}),
            }
        }

    RETURN_TYPES = ("MAGI_EMBEDS",)
    FUNCTION = "encode"
    CATEGORY = "MAGI (PyTorch/CUDA)"

    def encode(self, prompt, t5_pretrained):
        from magi_tpu_torch.models.t5.model import T5Embedder

        embedder = T5Embedder(cache_dir=t5_pretrained, model_max_length=800, device="auto", tokenizer=self.tokenizer)
        embs, mask = embedder.get_text_embeddings([prompt])
        return ({"caption_embs": embs.float().numpy(), "emb_masks": mask.numpy().astype(np.int32)},)


class MagiImageLoader:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image_path": ("STRING", {"default": ""})}}

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("image_path",)
    FUNCTION = "load"
    CATEGORY = "MAGI (PyTorch/CUDA)"

    def load(self, image_path):
        assert os.path.exists(image_path), f"image not found: {image_path}"
        return (image_path,)


class MagiVideoLoader:
    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"video_path": ("STRING", {"default": ""})}}

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("video_path",)
    FUNCTION = "load"
    CATEGORY = "MAGI (PyTorch/CUDA)"

    def load(self, video_path):
        assert os.path.exists(video_path), f"video not found: {video_path}"
        return (video_path,)


class MagiProcess:
    """The whole pipeline in this process, on the card, with the config's
    runtime values overridden by the node's inputs; returns the path
    written (`<path>.npz` where no video encoder is installed)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "prompt": ("STRING", {"forceInput": True}),
                "config_file": ("STRING", {"default": "example/4.5B/4.5B_base_config.json"}),
                "mode": (["t2v", "i2v", "v2v"],),
                "seed": ("INT", {"default": 1234}),
                "video_size_h": ("INT", {"default": 720}),
                "video_size_w": ("INT", {"default": 720}),
                "num_frames": ("INT", {"default": 96}),
                "num_steps": ("INT", {"default": 64}),
                "fps": ("INT", {"default": 24}),
            },
            "optional": {
                "image_path": ("STRING", {"default": ""}),
                "video_path": ("STRING", {"default": ""}),
            },
        }

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("video_path",)
    FUNCTION = "process"
    CATEGORY = "MAGI (PyTorch/CUDA)"

    def process(self, prompt, config_file, mode, seed, video_size_h, video_size_w,
                num_frames, num_steps, fps, image_path="", video_path=""):
        # override the JSON config like the reference node does
        with open(config_file) as f:
            cfg = json.load(f)
        cfg["runtime_config"].update(
            seed=seed, video_size_h=video_size_h, video_size_w=video_size_w,
            num_frames=num_frames, num_steps=num_steps, fps=fps,
        )
        tmp_cfg = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
        json.dump(cfg, tmp_cfg)
        tmp_cfg.close()

        from magi_tpu_torch.pipeline import pipeline

        out = os.path.join(tempfile.gettempdir(), f"magi_comfy_{seed}.mp4")
        try:
            pipe = pipeline.MagiPipeline(tmp_cfg.name)
        finally:
            os.remove(tmp_cfg.name)
        if mode == "t2v":
            stats = pipe.run_text_to_video(prompt, out)
        elif mode == "i2v":
            stats = pipe.run_image_to_video(prompt, image_path, out)
        else:
            stats = pipe.run_video_to_video(prompt, video_path, out)
        return ((stats or {}).get("path", out),)


class MagiSaveVideo:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "video_path": ("STRING", {"forceInput": True}),
                "output_path": ("STRING", {"default": "output.mp4"}),
            }
        }

    RETURN_TYPES = ("STRING",)
    FUNCTION = "save"
    CATEGORY = "MAGI (PyTorch/CUDA)"
    OUTPUT_NODE = True

    def save(self, video_path, output_path):
        import shutil

        shutil.copyfile(video_path, output_path)
        return (output_path,)


NODE_CLASS_MAPPINGS = {
    "MagiPromptLoader": MagiPromptLoader,
    "MagiTextEncoder": MagiTextEncoder,
    "MagiImageLoader": MagiImageLoader,
    "MagiVideoLoader": MagiVideoLoader,
    "MagiProcess": MagiProcess,
    "MagiSaveVideo": MagiSaveVideo,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "MagiPromptLoader": "MAGI Prompt Loader",
    "MagiTextEncoder": "MAGI Text Encoder (T5)",
    "MagiImageLoader": "MAGI Image Loader",
    "MagiVideoLoader": "MAGI Video Loader",
    "MagiProcess": "MAGI Video Generator",
    "MagiSaveVideo": "MAGI Save Video",
}
