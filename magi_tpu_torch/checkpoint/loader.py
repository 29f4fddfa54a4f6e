"""DiT checkpoint loading (the port of `magi_tpu.checkpoint.loader`):
sharded safetensors (plain or `.zst`) -> the port's parameter tree.

* `shard_paths` resolves the variant subdirectory
  (`inference_weight[.fp8][.distill]`) and its shards; `load_state_dict`
  reads every shard: with the native runtime (`runtime_native.read_files`:
  threaded reads, zstd in C++) when it builds, as the JAX package's loader
  does, else mapped (`checkpoint.safetensors_io`: the tensors stay on
  disk, in their stored dtypes, until a leaf is read).  MAGI_DISABLE_NATIVE=1
  picks the mapped route.  `last_read` says which route the last load
  took, its bytes and seconds.
* `_dequant_fp8` inverts the released fp8 checkpoints' execution math to
  the effective weights, leaf by leaf and on the target device when each
  is read, and emits the smooth-quant factor `act_smooth`.
* `convert_dit_state` builds the tree of `init_dit_params` (linear weights
  [in, out], stacked on a leading layer axis), one layer of one leaf at a
  time, cast to the parameter dtype as it goes: the whole state is never
  held in f32, on the host or on the card.
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import torch

from magi_tpu_torch import runtime_native
from magi_tpu_torch.checkpoint.safetensors_io import load_buffer, load_file
from magi_tpu_torch.core.config import MagiConfig
from magi_tpu_torch.core.logger import print_rank_0
from magi_tpu_torch.core.utils import resolve_device
from magi_tpu_torch.ops.quant import TreeSink

_AUX = (".weight_scale", ".smooth_scale", ".input_scale")
last_read: dict = {}  # the last load_state_dict's route ("native" or "python"), shard bytes and read seconds


def shard_paths(load_dir: str, fp8_quant: bool = False, distill: bool = False) -> List[str]:
    """The shard files of the variant subdirectory
    (`inference_weight[.fp8][.distill]`), listed by
    `model.safetensors.index.json` or else by the directory."""
    subdir = "inference_weight" + (".fp8" if fp8_quant else "") + (".distill" if distill else "")
    weight_dir = os.path.join(load_dir, subdir)
    if not os.path.isdir(weight_dir):
        raise FileNotFoundError(f"weight dir not found: {weight_dir}")
    index_path = os.path.join(weight_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shard_files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shard_files = sorted(f for f in os.listdir(weight_dir) if f.endswith((".safetensors", ".safetensors.zst")))
    if not shard_files:
        raise FileNotFoundError(f"no safetensors shards under {weight_dir}")
    return [os.path.join(weight_dir, s) for s in shard_files]


def load_state_dict(load_dir: str, fp8_quant: bool = False, distill: bool = False) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of every shard of `shard_paths`: read by the
    native runtime when it is available, else mapped by the Python
    reader."""
    paths = shard_paths(load_dir, fp8_quant, distill)
    native = runtime_native.available()
    state: Dict[str, torch.Tensor] = {}
    t0 = time.perf_counter()
    if native:
        for path, raw in zip(paths, runtime_native.read_arrays(paths)):
            state.update(load_buffer(raw, path))
    else:
        with ThreadPoolExecutor(max_workers=min(8, len(paths))) as ex:
            for shard in ex.map(load_file, paths):
                state.update(shard)
    last_read.update(route="native" if native else "python", seconds=time.perf_counter() - t0,
                     bytes=sum(t.numel() * t.element_size() for t in state.values()))
    print_rank_0(f"loaded {len(state)} tensors from {os.path.dirname(paths[0])} ({last_read['route']} reader)")
    return state


def _scalar(t: torch.Tensor, device) -> torch.Tensor:
    return t.reshape(-1)[0].to(device=device, dtype=torch.float32)


class _Fp8Dequant(Mapping):
    """A checkpoint's state with each fp8 weight read as its effective f32
    weight and each smooth-quant linear's `act_smooth` added, both
    computed on `device` when read; the scale entries are gone."""

    def __init__(self, state: Mapping, device):
        self._state = state
        self._device = torch.device(device)
        bases = {k[: -len(".weight_scale")] for k in state if k.endswith(".weight_scale")}
        bases = {b for b in bases if b + ".weight" in state}
        self._weights = {b + ".weight": b for b in bases}
        self._smooth = {b + ".act_smooth": b for b in bases if b + ".smooth_scale" in state}
        dropped = {b + aux for b in bases for aux in _AUX}
        self._keys = [k for k in state if k not in dropped] + sorted(self._smooth)
        self._keyset = set(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self):
        return iter(self._keys)

    def __contains__(self, key) -> bool:
        return key in self._keyset

    def _input_scale(self, base: str):
        inp = self._state.get(base + ".input_scale")
        return _scalar(inp, self._device) if inp is not None else 1.0

    def __getitem__(self, key: str) -> torch.Tensor:
        dev, st = self._device, self._state
        if key in self._weights:
            base = self._weights[key]
            w = st[key].to(dev)
            # stored [1, out, in] (PerTensor and PerChannel classes alike)
            wf = (w.reshape(w.shape[-2:]) if w.dim() == 3 else w).float()
            wf = wf * _scalar(st[base + ".weight_scale"], dev)
            smooth = st.get(base + ".smooth_scale")
            if smooth is not None:
                wf = wf * self._input_scale(base)
                wf = wf / smooth.to(dev).float().reshape(-1)[None, :]
            return wf
        if key in self._smooth:
            base = self._smooth[key]
            return st[base + ".smooth_scale"].to(dev).float().reshape(-1) / self._input_scale(base)
        if key not in self:
            raise KeyError(key)
        return st[key]


def _dequant_fp8(state: Mapping, device="cpu") -> Mapping:
    """The effective weights of a released fp8 checkpoint (the JAX
    package's `_dequant_fp8`, the same f32 operations in the same order),
    computed leaf by leaf on `device` as they are read.  The two linear
    classes store different things:

    * PerTensor (q/qx/k/v): the forward is ``[e4m3(x / input_scale) @
      Wq^T] * input_scale * weight_scale``; input_scale cancels, so the
      effective weight is ``Wq * weight_scale``.
    * PerChannel, smooth-quant (proj, kv_xattn, fc1, fc2): the forward is
      ``[e4m3(x / smooth_scale) @ Wq^T] * input_scale * weight_scale``; the
      stored Wq is smooth-folded, so the effective weight is ``Wq *
      weight_scale * input_scale / smooth_scale[in]``, and ``act_smooth =
      smooth_scale / input_scale`` is the pure smoothing factor the int8
      path folds back into the weight (`ops.quant`) and divides the
      activation by (`models.dit.model._linears_shared`).
    """
    return _Fp8Dequant(state, device)


def _tp8_perm(two_d: int) -> torch.Tensor:
    if two_d % 16:
        raise ValueError(f"linear_proj's input dim ({two_d}) must be a multiple of 16")
    return torch.arange(two_d).reshape(8, 2, two_d // 16).transpose(0, 1).reshape(-1)


def _fold_tp8_interleave(arr: torch.Tensor) -> torch.Tensor:
    """linear_proj's input rows with the reference's runtime TP8-legacy
    head interleave folded in (the concat(core, xattn) columns permuted
    as reshape(S, 2, 8, 2D/16) -> transpose(0, 2, 1, 3)): `arr[..., perm,
    :]` of an [..., in, out] weight, once at load instead of a relayout
    per forward."""
    return arr[..., _tp8_perm(arr.shape[-2]).to(arr.device), :]


def convert_dit_state(state: Mapping, config: MagiConfig, device="cpu", sink=None) -> dict:
    """torch key names -> the port's tree on `device`, the layout of
    `init_dit_params`: linear weights transposed to [in, out] and stacked
    [L, in, out] in the parameter dtype, the Conv3d patch embed flattened
    to a matmul, linear_proj's input rows (and its `act_smooth`) folded by
    `_fold_tp8_interleave`; `act_smooth` stacked per smooth-quant linear,
    1 on the layers that carry none (the bf16 edge layers).  Each leaf goes
    to `sink` as it is built, as in `init_dit_params` (an `ops.quant.
    TreeSink` that keeps it whole by default), and the sink's tree comes
    back."""
    mc = config.model_config
    L, dtype = mc.num_layers, mc.params_dtype
    device = torch.device(device)
    sink = TreeSink() if sink is None else sink
    put = sink.leaf

    def g(name: str) -> torch.Tensor:
        return state[name].to(device=device, dtype=torch.float32, copy=True)

    def lin_T(name: str) -> torch.Tensor:
        return g(name).t().contiguous()

    def stacked(fmt: str, transpose: bool, dt, fold: bool = False) -> torch.Tensor:
        out = None
        for i in range(L):
            m = g(fmt.format(i))
            if transpose:
                m = m.t()
            if fold:
                m = _fold_tp8_interleave(m)
            if out is None:
                out = torch.empty((L,) + tuple(m.shape), dtype=dt, device=device)
            out[i].copy_(m)
        return out

    def stacked_smooth(fmt: str, fold: bool = False):
        present = [i for i in range(L) if fmt.format(i) in state]
        if not present:
            return None
        rows = {i: g(fmt.format(i)).reshape(-1) for i in present}
        dim = rows[present[0]].shape[0]
        arr = torch.stack([rows.get(i, torch.ones(dim, device=device)) for i in range(L)])
        # the smooth vector indexes the linear's input rows: permuted as they are
        return _fold_tp8_interleave(arr[..., None])[..., 0] if fold else arr

    def norm(path: str, fmt: str, dt=torch.float32) -> None:
        put(path + "/weight", stacked(fmt + ".weight", False, dt))
        put(path + "/bias", stacked(fmt + ".bias", False, dt))

    def lin(path: str, fmt: str, fold: bool = False, smooth: str = "") -> None:
        # smooth-quant factors (fp8 checkpoints only), on the four PerChannel linears
        sm = stacked_smooth(smooth, fold) if smooth else None
        sink.linear(path, stacked(fmt, True, dtype, fold=fold), sm)

    def lin_b(path: str, name: str) -> None:
        put(path + "/weight", lin_T(name + ".weight"))
        put(path + "/bias", g(name + ".bias"))

    blk = "videodit_blocks.layers.{}."
    att = blk + "self_attention."
    a = "blocks/self_attention/"
    lin("blocks/ada_modulate_layer/proj/0", blk + "ada_modulate_layer.proj.0.weight")
    put("blocks/ada_modulate_layer/proj/0/bias", stacked(blk + "ada_modulate_layer.proj.0.bias", False, dtype))
    norm(a + "linear_qkv/layer_norm", att + "linear_qkv.layer_norm", dtype)
    for n in ("q", "qx", "k", "v"):
        lin(a + f"linear_qkv/{n}", att + f"linear_qkv.{n}.weight")
    # fp32 islands
    norm(a + "q_layernorm", att + "q_layernorm")
    norm(a + "k_layernorm", att + "k_layernorm")
    norm(a + "q_layernorm_xattn", att + "q_layernorm_xattn", dtype)
    norm(a + "k_layernorm_xattn", att + "k_layernorm_xattn", dtype)
    lin(a + "linear_kv_xattn", att + "linear_kv_xattn.weight", smooth=att + "linear_kv_xattn.act_smooth")
    lin(a + "linear_proj", att + "linear_proj.weight", fold=True, smooth=att + "linear_proj.act_smooth")
    norm("blocks/self_attn_post_norm", blk + "self_attn_post_norm")
    norm("blocks/mlp/layer_norm", blk + "mlp.layer_norm", dtype)
    lin("blocks/mlp/linear_fc1", blk + "mlp.linear_fc1.weight", smooth=blk + "mlp.linear_fc1.act_smooth")
    lin("blocks/mlp/linear_fc2", blk + "mlp.linear_fc2.weight", smooth=blk + "mlp.linear_fc2.act_smooth")
    norm("blocks/mlp_post_norm", blk + "mlp_post_norm")

    xw = g("x_embedder.weight")  # [D, C, tp, p, p]
    put("x_embedder/weight", xw.reshape(xw.shape[0], -1).t().contiguous())
    put("rope/bands", g("rope.bands"))
    lin_b("t_embedder/mlp/0", "t_embedder.mlp.0")
    lin_b("t_embedder/mlp/2", "t_embedder.mlp.2")
    lin_b("y_embedder/y_proj_xattn/0", "y_embedder.y_proj_xattn.0")
    lin_b("y_embedder/y_proj_adaln/0", "y_embedder.y_proj_adaln.0")
    put("y_embedder/null_caption_embedding", g("y_embedder.null_caption_embedding"))
    put("final_layernorm/weight", g("videodit_blocks.final_layernorm.weight"))
    put("final_layernorm/bias", g("videodit_blocks.final_layernorm.bias"))
    put("final_linear/linear/weight", lin_T("final_linear.linear.weight"))
    return sink.tree()


def load_dit_params(config: MagiConfig, device=None, sink=None) -> dict:
    """`runtime_config.load` -> the DiT tree on `device` (CUDA unless the
    CPU is asked for; fp8 checkpoints, `engine_config.fp8_quant`,
    dequantized leaf by leaf there), built through `sink`
    (`convert_dit_state`)."""
    device = resolve_device(device)
    ec = config.engine_config
    state = load_state_dict(config.runtime_config.load, ec.fp8_quant, ec.distill)
    if ec.fp8_quant:
        state = _dequant_fp8(state, device)
    return convert_dit_state(state, config, device, sink)
