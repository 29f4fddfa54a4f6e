"""The benchmark's weights and inputs, drawn from the run's seed on the device.

Every leaf of the DiT and of the VAE decoder is drawn by its own generator,
seeded from (seed, leaf name, layer), so the harness can hand the program a
whole stacked leaf while the plain reference draws one layer of it again,
bit for bit, long after the program's tree is gone.  The tree's layout is
MAGI-1's (the checkpoint's names and shapes, the layers stacked on a leading
axis).  Nothing here imports the program.

Values: linear weights uniform with std 0.02 in the parameter dtype (the
random-weight mode of the program draws the same law); zero-centred norm
gammas 0.1 * N(0, 1) and plain ones 1 + 0.1 * N(0, 1); biases 0.02 * N(0, 1);
the fp32 embedders N(0, 0.02); a smooth-quant linear's `act_smooth` uniform
in [0.5, 2], 1 on the first and last layer, as the released fp8 checkpoints
load.  Norms and biases are drawn rather than left at identity so that a
kernel that drops one of them shows in the comparison.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

BOUND = 0.02 * 3.0**0.5  # uniform(-b, b) has std 0.02


def sub_seed(seed: int, *names) -> int:
    """A 63-bit generator seed from the run's seed and names (strings or ints)."""
    words = [int(seed) % 2**64]
    for n in names:
        words.append(zlib.crc32(n.encode()) if isinstance(n, str) else int(n))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *names) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *names))
    return g


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A leaf of the tree: its path, per-layer shape (for a stacked leaf) or
    shape, dtype, law ("lin", "normal", "gamma0", "gamma1", "bias",
    "smooth", "bands") and whether it is stacked over the layers."""

    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    law: str
    stacked: bool = True


def _dtype(name: str) -> torch.dtype:
    return {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32, "torch.float16": torch.float16}[name]


def dit_leaves(mc: dict, smooth: Tuple[str, ...] = ()) -> Iterator[Leaf]:
    """The DiT's leaves (`mc` the config's model_config dict); `smooth` names
    the linears (paths under blocks/) that carry an `act_smooth`."""
    D, hd, hq, hk = mc["hidden_size"], mc["kv_channels"], mc["num_attention_heads"], mc["num_query_groups"]
    ch = int(D * mc["cond_hidden_ratio"])
    xh = int(D * mc["xattn_cond_hidden_ratio"])
    gh = int(D * mc["cond_gating_ratio"])
    ffn = mc["ffn_hidden_size"]
    fc1 = 2 * ffn if mc["gated_linear_unit"] else ffn
    dt = _dtype(mc["params_dtype"])
    f32 = torch.float32
    one_p = mc["apply_layernorm_1p"]
    gamma = "gamma0" if one_p else "gamma1"

    def norm(path, n, dtype, plain=False):
        yield Leaf(path + "/weight", (n,), dtype, "gamma1" if plain else gamma)
        yield Leaf(path + "/bias", (n,), dtype, "bias")

    def lin(path, i, o):
        yield Leaf(path + "/weight", (i, o), dt, "lin")
        if path.split("/", 1)[1] in smooth:
            yield Leaf(path + "/act_smooth", (i,), f32, "smooth")

    a = "blocks/self_attention/"
    yield from lin("blocks/ada_modulate_layer/proj/0", ch, 2 * gh)
    yield Leaf("blocks/ada_modulate_layer/proj/0/bias", (2 * gh,), dt, "bias")
    yield from norm(a + "linear_qkv/layer_norm", D, dt, plain=True)
    yield from lin(a + "linear_qkv/q", D, hq * hd)
    yield from lin(a + "linear_qkv/qx", D, hq * hd)
    yield from lin(a + "linear_qkv/k", D, hk * hd)
    yield from lin(a + "linear_qkv/v", D, hk * hd)
    yield from norm(a + "q_layernorm", hd, f32)
    yield from norm(a + "k_layernorm", hd, f32)
    yield from norm(a + "q_layernorm_xattn", hd, dt)
    yield from norm(a + "k_layernorm_xattn", hd, dt)
    yield from lin(a + "linear_kv_xattn", xh, 2 * hk * hd)
    yield from lin(a + "linear_proj", 2 * hq * hd, D)
    yield from norm("blocks/self_attn_post_norm", D, f32)
    yield from norm("blocks/mlp/layer_norm", D, dt, plain=True)
    yield from lin("blocks/mlp/linear_fc1", D, fc1)
    yield from lin("blocks/mlp/linear_fc2", ffn, D)
    yield from norm("blocks/mlp_post_norm", D, f32)
    in_feat = mc["in_channels"] * mc["t_patch_size"] * mc["patch_size"] ** 2
    out_feat = mc["patch_size"] ** 2 * mc["t_patch_size"] * mc["out_channels"]
    yield Leaf("x_embedder/weight", (in_feat, D), f32, "lin", stacked=False)
    yield Leaf("rope/bands", (hd // 8,), f32, "bands", stacked=False)
    yield Leaf("final_layernorm/weight", (D,), f32, gamma, stacked=False)
    yield Leaf("final_layernorm/bias", (D,), f32, "bias", stacked=False)
    cc = mc["caption_channels"]
    for path, shape in (("t_embedder/mlp/0", (256, ch)), ("t_embedder/mlp/2", (ch, ch)),
                        ("y_embedder/y_proj_xattn/0", (cc, xh)), ("y_embedder/y_proj_adaln/0", (cc, ch))):
        yield Leaf(path + "/weight", shape, f32, "normal", stacked=False)
        yield Leaf(path + "/bias", shape[1:], f32, "bias", stacked=False)
    yield Leaf("y_embedder/null_caption_embedding", (mc["caption_max_length"], cc), f32, "normal", stacked=False)
    yield Leaf("final_linear/linear/weight", (D, out_feat), f32, "normal", stacked=False)


def draw(leaf: Leaf, seed: int, device, layer: Optional[int] = None, num_layers: int = 0) -> torch.Tensor:
    """One leaf (of layer `layer` for a stacked leaf) drawn from its own
    generator.  An `act_smooth` of the first or last of `num_layers` layers is 1."""
    if leaf.law == "bands":
        exp = torch.arange(0, leaf.shape[0], dtype=torch.float32, device=device) / leaf.shape[0]
        return 1.0 / (10000.0**exp)
    if leaf.law == "smooth" and layer in (0, num_layers - 1):
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    g = generator(seed, device, leaf.path, 0 if layer is None else layer + 1)
    out = torch.empty(leaf.shape, dtype=leaf.dtype if leaf.law == "lin" else torch.float32, device=device)
    if leaf.law == "lin":
        return out.uniform_(-BOUND, BOUND, generator=g)
    if leaf.law == "smooth":
        return out.uniform_(0.5, 2.0, generator=g).to(leaf.dtype)
    out.normal_(generator=g)
    scale = {"normal": 0.02, "bias": 0.02, "gamma0": 0.1, "gamma1": 0.1}[leaf.law]
    out = out * scale + (1.0 if leaf.law == "gamma1" else 0.0)
    return out.to(leaf.dtype)


def draw_stacked(leaf: Leaf, seed: int, device, num_layers: int) -> torch.Tensor:
    """A stacked leaf [num_layers, *shape], layer by layer as `draw` gives them."""
    out = torch.empty((num_layers,) + leaf.shape, dtype=leaf.dtype, device=device)
    for i in range(num_layers):
        out[i] = draw(leaf, seed, device, i, num_layers)
    return out


def layer_tree(leaves, seed: int, device, layer: int, num_layers: int) -> Dict[str, torch.Tensor]:
    """Layer `layer` of every stacked leaf, by path under blocks/."""
    return {lf.path.split("/", 1)[1]: draw(lf, seed, device, layer, num_layers) for lf in leaves if lf.stacked}


def top_tree(leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf that is not stacked, by path."""
    return {lf.path: draw(lf, seed, device) for lf in leaves if not lf.stacked}


def vae_leaves(vc: dict) -> Iterator[Leaf]:
    """The ViT-VAE decoder's leaves (`vc` the config's vae dict; the blocks
    stacked over `depth`), in bf16 as the program serves it."""
    D = vc["embed_dim"]
    mlp = int(D * vc.get("mlp_ratio", 4.0))
    up = D // (vc["patch_size"] ** 2 * vc["patch_length"])
    n_patches = (vc["video_length"] // vc["patch_length"]) * (vc["video_size"] // vc["patch_size"]) ** 2
    bf = torch.bfloat16
    d = "vae/decoder/"
    yield Leaf(d + "proj_in/weight", (vc["z_chans"], D), bf, "normal", stacked=False)
    yield Leaf(d + "proj_in/bias", (D,), bf, "bias", stacked=False)
    yield Leaf(d + "cls_token", (1, 1, D), bf, "normal", stacked=False)
    yield Leaf(d + "pos_embed", (1, n_patches + 1, D), bf, "normal", stacked=False)
    for path, i, o in (("attn/qkv", D, 3 * D), ("attn/proj", D, D), ("mlp/fc1", D, mlp), ("mlp/fc2", mlp, D)):
        yield Leaf(f"{d}blocks/{path}/weight", (i, o), bf, "normal")
        if path != "attn/qkv":
            yield Leaf(f"{d}blocks/{path}/bias", (o,), bf, "bias")
    for n in ("norm1", "norm2"):
        yield Leaf(f"{d}blocks/{n}/weight", (D,), bf, "gamma1")
        yield Leaf(f"{d}blocks/{n}/bias", (D,), bf, "bias")
    yield Leaf(d + "norm/weight", (D,), bf, "gamma1", stacked=False)
    yield Leaf(d + "norm/bias", (D,), bf, "bias", stacked=False)
    yield Leaf(d + "last_layer/weight", (3, up, 3, 3, 3), bf, "normal", stacked=False)
    yield Leaf(d + "last_layer/bias", (3,), bf, "bias", stacked=False)


def caption(seed: int, length: int, channels: int, tokens: int) -> Tuple[np.ndarray, np.ndarray]:
    """Caption embeddings [1, length, channels] f32 at T5-XXL's width and the
    mask [1, length] of their first `tokens` valid tokens, on the host (the
    pipeline takes them as numpy)."""
    rng = np.random.default_rng(sub_seed(seed, "caption"))
    embs = rng.standard_normal((1, length, channels), dtype=np.float32)
    mask = np.zeros((1, length), np.int32)
    mask[0, :tokens] = 1
    return embs, mask


def noise(seed: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """The walk's initial latent noise, f32 on the device."""
    return torch.randn(shape, generator=generator(seed, device, "noise"), device=device, dtype=torch.float32)
