"""ViT-VAE loading from the released diffusers-format checkpoint (the port
of `magi_tpu.checkpoint.vae_loader`): a directory with `config.json`
(`_class_name: ViTVAE` and its `ddconfig`) and the weights, in
`*.safetensors` files whose names hold "diffusion" or "model", else in
`*.bin` files (`torch.load(weights_only=True)`)."""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from magi_tpu_torch.checkpoint.safetensors_io import load_file
from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE


def _read_weights(path: str) -> Dict[str, torch.Tensor]:
    st = [f for f in os.listdir(path) if f.endswith(".safetensors") and ("diffusion" in f or "model" in f)]
    state: Dict[str, torch.Tensor] = {}
    if st:
        for fn in sorted(st):
            state.update(load_file(os.path.join(path, fn)))
        return state
    bins = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if not bins:
        raise FileNotFoundError(f"no VAE weights under {path}")
    for fn in bins:
        state.update(torch.load(os.path.join(path, fn), map_location="cpu", weights_only=True))
    return state


def convert_vae_state(state: Dict[str, torch.Tensor], cfg: VaeConfig, dtype=torch.bfloat16, device="cpu") -> dict:
    """torch key names -> the port's tree (the JAX package's: linear weights
    [in, out] and the blocks stacked [depth, ...]) in `dtype` on `device`,
    each leaf cast through f32 as it is placed."""
    device = torch.device(device)

    def g(name: str) -> torch.Tensor:
        return state[name].to(device=device, dtype=torch.float32, copy=True)

    def stacked(fmt: str, n: int, transpose: bool = True) -> torch.Tensor:
        out = None
        for i in range(n):
            m = g(fmt.format(i))
            if transpose:
                m = m.t()
            if out is None:
                out = torch.empty((n,) + tuple(m.shape), dtype=dtype, device=device)
            out[i].copy_(m)
        return out

    def stacked_lin(fmt: str, n: int, bias: bool = True) -> dict:
        p = {"weight": stacked(fmt + ".weight", n)}
        if bias and (fmt + ".bias").format(0) in state:
            p["bias"] = stacked(fmt + ".bias", n, transpose=False)
        return p

    def stacked_norm(fmt: str, n: int) -> dict:
        return {"weight": stacked(fmt + ".weight", n, False), "bias": stacked(fmt + ".bias", n, False)}

    def plain(name: str) -> torch.Tensor:
        return g(name).to(dtype)

    def lin(name: str, bias: bool = True) -> dict:
        p = {"weight": g(name + ".weight").t().contiguous().to(dtype)}
        if bias and name + ".bias" in state:
            p["bias"] = plain(name + ".bias")
        return p

    def norm(name: str) -> dict:
        return {"weight": plain(name + ".weight"), "bias": plain(name + ".bias")}

    def tower(prefix: str, is_encoder: bool) -> dict:
        n = cfg.depth
        t = {
            "pos_embed": plain(prefix + "pos_embed"),
            "blocks": {
                "attn": {
                    "qkv": stacked_lin(prefix + "blocks.{}.attn.qkv", n, bias=cfg.qkv_bias),
                    "proj": stacked_lin(prefix + "blocks.{}.attn.proj", n),
                },
                "norm2": stacked_norm(prefix + "blocks.{}.norm2", n),
                "mlp": {"fc1": stacked_lin(prefix + "blocks.{}.mlp.fc1", n),
                        "fc2": stacked_lin(prefix + "blocks.{}.mlp.fc2", n)},
            },
            "norm": norm(prefix + "norm"),
        }
        if not cfg.ln_in_attn:
            t["blocks"]["norm1"] = stacked_norm(prefix + "blocks.{}.norm1", n)
        if cfg.with_cls_token:
            t["cls_token"] = plain(prefix + "cls_token")
        if is_encoder:
            t["patch_embed"] = {"proj": {"weight": plain(prefix + "patch_embed.proj.weight"),
                                         "bias": plain(prefix + "patch_embed.proj.bias")}}
            t["last_layer"] = lin(prefix + "last_layer")
        else:
            t["proj_in"] = lin(prefix + "proj_in")
            if cfg.use_final_proj:
                t["final_proj"] = lin(prefix + "final_proj")
                t["final_norm"] = norm(prefix + "final_norm")
            t["last_layer"] = {"weight": plain(prefix + "last_layer.weight"), "bias": plain(prefix + "last_layer.bias")}
        return t

    return {"encoder": tower("encoder.", True), "decoder": tower("decoder.", False)}


def load_vae(path: str, dtype=torch.bfloat16, device="cpu") -> ViTVAE:
    """The released ViT-VAE under `path`, its weights in `dtype` on `device`."""
    config_path = os.path.join(path, "config.json")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Can't find a model config file at {config_path}.")
    with open(config_path) as f:
        cd = json.load(f)
    if cd.get("_class_name") != "ViTVAE":
        raise ValueError(f"{config_path} describes a {cd.get('_class_name')}, not a ViTVAE")
    cfg = VaeConfig.from_ddconfig(cd["ddconfig"])
    return ViTVAE(cfg, convert_vae_state(_read_weights(path), cfg, dtype, device))
