"""The rank mesh and its sharding rules (the port of
`magi_tpu.parallel.mesh`), on `torch.distributed`.

The JAX package drives every device from one process and lets XLA emit the
collectives from sharding constraints.  The port runs one process per rank,
launched by torchrun (`python -m torch.distributed.run --nproc_per_node N
-m magi_tpu_torch.pipeline.entry ...`), and calls its collectives
explicitly (`parallel.comm`).  Each rank runs the whole walk: replicated
values (noise, schedule, captions, conditions) are drawn from the same seed
on every rank, and each rank keeps its own shard of the tokens, heads,
weights and KV cache, in the JAX package's layout:

* ranks map to (dp, pp, cp, tp) in enumeration order; over several nodes
  the node boundary is laid onto dp first, then pp (`build_mesh`);
* between attentions the packed token axis is split over SEQ_AXES = (cp,
  pp): rank (cp_i, pp_i) holds token shard s = cp_i * pp + pp_i, padded at
  the end to a multiple of the shard count (`token_shard`);
* attention runs head-sharded over HEAD_AXES = (cp, pp, tp): the rank's
  head shard is s * tp + tp_i, its KV cache that shard of the kv heads
  (`kv_cache_spec`), kv heads replicated first when the head shards
  outnumber them (`kv_replication`).  The seq <-> head reshard is Ulysses'
  all-to-all (`models.dit.model._Ulysses`);
* tp shards the big linears Megatron-style (`leaf_spec`, `shard_leaf`: the
  counterpart of the JAX package's `dit_param_specs`): q, qx, k,
  v, linear_kv_xattn and fc1 by output column, linear_proj and fc2 by input
  row; pp shards the stacked layers (layer-FSDP: each rank keeps 1/pp of
  them, and `pp_gather_layer` broadcasts one layer at a time from its owner
  while the previous one computes);
* dp replicates the model: a dp group runs its share of the requests.

The port's shard rule is the JAX package's with three differences, each
because a rank's heads must be whole on it: linear_proj's input rows are
[core heads | cross-attention heads], so a tp rank takes its block of each
half (the JAX package's contiguous split would give tp rank 0 every core
head); a gated fc1's output columns are [gate | up], split the same way so
that SwiGLU runs on the rank's columns; and a row-parallel linear's
`act_smooth` splits with its input rows (the JAX package replicates it and
divides before its shard_map).

`constraint`, `replicated` and `shard_map_mesh` have no counterpart: they
place values for XLA's partitioner, and the port's explicit collectives
take their place.  `kv_cache_spec`, `shard_kv_cache` and `pp_num_shards`
keep the JAX package's names: the model reads `pp_num_shards`, and
`shard_kv_cache` cuts a full cache along `kv_cache_spec`'s head dim (the
samplers allocate the rank's shard directly, `kv_cache_shape`).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from magi_tpu_torch.core.logger import print_per_process
from magi_tpu_torch.core.utils import nest, tree_leaves
from magi_tpu_torch.ops.quant import TreeSink, k_major

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_CP = "cp"
AXIS_TP = "tp"
AXES = (AXIS_DP, AXIS_PP, AXIS_CP, AXIS_TP)

# the packed token axis shards over cp AND pp between attentions; attention
# shards heads over cp x pp x tp (Ulysses); cp is the major one of each
SEQ_AXES = (AXIS_CP, AXIS_PP)
HEAD_AXES = (AXIS_CP, AXIS_PP, AXIS_TP)

# which process groups a mesh makes: name -> the axes its members differ in
GROUP_AXES = {
    "seq": SEQ_AXES,
    "head": HEAD_AXES,  # the model-parallel replica (every rank of one dp index)
    "tp": (AXIS_TP,),
    "pp": (AXIS_PP,),
    "dp": (AXIS_DP,),
    # the replica again, for the tile-parallel VAE: a decode on a worker
    # thread (interleaved requests) must not share a group with the walk
    "tile": HEAD_AXES,
}


@dataclass(eq=False)
class Group:
    """Ranks that run one collective: `ranks` in group-rank order (sorted, as
    torch.distributed orders them), `pg` its process group (None for a
    group of one rank)."""

    ranks: Tuple[int, ...]
    pg: Optional[object]
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(eq=False)
class Mesh:
    """The rank layout: `ranks[dp, pp, cp, tp]` is the global rank at those
    coordinates; `rank` is this process's (None when the mesh only serves
    its rules, as in `build_mesh`); `groups` the process groups of this
    rank (`initialize_mesh`)."""

    ranks: np.ndarray
    rank: Optional[int] = None
    backend: str = ""
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: Dict[str, Group] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of `rank` (this process's by default)."""
        r = self.rank if rank is None else rank
        idx = np.argwhere(self.ranks == r)
        if len(idx) != 1:
            raise ValueError(f"rank {r} is not in the mesh")
        return dict(zip(AXES, (int(i) for i in idx[0])))

    def seq_index(self, rank: Optional[int] = None) -> int:
        """The token shard of `rank`: cp_idx * pp + pp_idx."""
        c = self.coords(rank)
        return c[AXIS_CP] * self.shape[AXIS_PP] + c[AXIS_PP]

    def head_index(self, rank: Optional[int] = None) -> int:
        """The head shard of `rank`: its token shard * tp + tp_idx."""
        return self.seq_index(rank) * self.shape[AXIS_TP] + self.coords(rank)[AXIS_TP]

    def group(self, name: str) -> Group:
        return self.groups[name]


_MESH: Optional[Mesh] = None


def _node_split(shape, nodes: int):
    """(nodes on each axis, ranks on each axis within a node): the node count
    laid onto dp first, then pp, cp and tp only as a last resort (the JAX
    package's `build_mesh` over several hosts)."""
    dcn = [1, 1, 1, 1]
    rem = nodes
    for i in range(4):
        g = math.gcd(shape[i], rem)
        dcn[i] = g
        rem //= g
        if rem == 1:
            break
    if rem != 1:
        raise ValueError(f"cannot lay {nodes} nodes over mesh {tuple(shape)}; make dp*pp a multiple of the node count")
    return tuple(dcn), tuple(s // d for s, d in zip(shape, dcn))


def build_mesh(dp: int = 1, pp: int = 1, cp: int = 1, tp: int = 1, nodes: int = 1) -> Mesh:
    """The rank layout of a (dp, pp, cp, tp) mesh.  On one node, ranks in
    enumeration order.  Over `nodes` nodes of equal rank counts (torchrun's
    order: node n holds ranks n * per_node .. (n + 1) * per_node - 1), the
    node boundary lies on dp first, then pp (`_node_split`), keeping cp and
    tp, the all-to-all- and all-reduce-heavy axes, inside a node: the
    coordinate on each axis is node coordinate * per-node extent + local
    coordinate, as `jax.experimental.mesh_utils.create_hybrid_device_mesh`
    arranges devices."""
    shape = (dp, pp, cp, tp)
    if nodes == 1:
        return Mesh(np.arange(dp * pp * cp * tp).reshape(shape))
    dcn, per = _node_split(shape, nodes)
    ranks = np.empty(shape, dtype=np.int64)
    per_node = int(np.prod(per))
    for g in np.ndindex(*shape):
        node = np.ravel_multi_index(tuple(i // p for i, p in zip(g, per)), dcn)
        local = np.ravel_multi_index(tuple(i % p for i, p in zip(g, per)), per)
        ranks[g] = node * per_node + local
    return Mesh(ranks)


def launcher_world() -> Tuple[int, int, int]:
    """(world size, rank, local rank) as torchrun sets them (1, 0, 0 without it)."""
    return (int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0")),
            int(os.environ.get("LOCAL_RANK", "0")))


def rank_device(device: torch.device) -> torch.device:
    """The card of this rank: cuda:(LOCAL_RANK % device count); on one card
    every rank takes cuda:0.  Other devices are returned as they are."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", launcher_world()[2] % torch.cuda.device_count())


def maybe_init_multihost(config=None) -> None:
    """`init_process_group` from torchrun's environment (the JAX package's
    `jax.distributed.initialize` hook): the backend is the config's
    `engine_config.distributed_backend` (gloo for several ranks on one
    card: NCCL refuses two ranks on one device), its timeout
    `distributed_timeout_minutes`.  The config's world_size must equal the
    launcher's WORLD_SIZE."""
    import torch.distributed as dist

    world, _, _ = launcher_world()
    want = world if config is None else config.engine_config.world_size
    if want != world:
        raise ValueError(
            f"the config's world_size (dp*pp*cp*tp = {want}) differs from the launcher's WORLD_SIZE ({world}): "
            f"launch it with python -m torch.distributed.run --nproc_per_node {want} -m magi_tpu_torch.pipeline.entry"
        )
    if world == 1 or dist.is_initialized():
        return
    ec = None if config is None else config.engine_config
    backend = "gloo" if ec is None else ec.distributed_backend
    minutes = 10 if ec is None else ec.distributed_timeout_minutes
    dist.init_process_group(backend=backend, timeout=timedelta(minutes=minutes))


def _nodes(world: int) -> int:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return max(1, world // max(local, 1))


def initialize_mesh(config=None, *, dp: int = 1, pp: int = 1, cp: int = 1, tp: int = 1,
                    device: Optional[torch.device] = None) -> Mesh:
    """Join the process group (`maybe_init_multihost`), lay out the mesh of
    the config's (or the given) sizes and make this rank's process groups;
    the mesh becomes the process's (`get_mesh`).  Every rank must call it,
    with the same sizes.  `device` is the rank's device (its collectives'
    tensors live there)."""
    import torch.distributed as dist

    global _MESH
    if config is not None:
        ec = config.engine_config
        dp, pp, cp, tp = ec.dp_size, ec.pp_size, ec.cp_size, ec.tp_size
    maybe_init_multihost(config)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * pp * cp * tp != world:
        raise ValueError(f"mesh dp={dp} pp={pp} cp={cp} tp={tp} needs {dp * pp * cp * tp} ranks, the world has {world}")
    mesh = build_mesh(dp, pp, cp, tp, nodes=_nodes(world))
    mesh.rank = dist.get_rank() if dist.is_initialized() else 0
    mesh.backend = dist.get_backend() if dist.is_initialized() else ""
    mesh.device = device if device is not None else torch.device("cpu")
    for name, axes in GROUP_AXES.items():
        keep = [i for i, a in enumerate(AXES) if a not in axes]
        moving = [i for i, a in enumerate(AXES) if a in axes]
        arr = mesh.ranks.transpose(keep + moving).reshape(-1, int(np.prod([mesh.ranks.shape[i] for i in moving])))
        for members in arr:
            ranks = tuple(sorted(int(r) for r in members))
            # every rank makes every group, in the same order
            pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if mesh.rank in ranks:
                mesh.groups[name] = Group(ranks, pg, mesh.backend, mesh.device)
    _MESH = mesh
    print_per_process(f"mesh dp={dp} pp={pp} cp={cp} tp={tp} ({mesh.backend or 'one process'}): "
                      f"coordinates {mesh.coords()}, device {mesh.device}")
    return mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def destroy_mesh() -> None:
    """Forget the mesh; the process group stays (torchrun's process leaves it
    at exit)."""
    set_mesh(None)


def mesh_is_trivial(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.size == 1


def model_parallel_trivial(mesh: Optional[Mesh] = None) -> bool:
    """True when pp, cp and tp are all 1: a dp-only mesh is trivial, each dp
    group running a single-device program."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return True
    return all(mesh.shape[a] == 1 for a in (AXIS_PP, AXIS_CP, AXIS_TP))


def seq_shards(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape[AXIS_CP] * mesh.shape[AXIS_PP]


def head_shards(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return mesh.shape[AXIS_CP] * mesh.shape[AXIS_PP] * mesh.shape[AXIS_TP]


def pp_num_shards() -> int:
    mesh = get_mesh()
    return 1 if mesh is None else mesh.shape[AXIS_PP]


def kv_replication(hq: int, hk: int, mesh: Optional[Mesh] = None) -> int:
    """The GQA kv-head replication of head-sharded attention: when the head
    shards n outnumber the kv heads, each kv head is repeated n / hk times
    (contiguously), so shard i holds q heads [i hq/n, (i+1) hq/n) and
    replica i of their kv head."""
    mesh = mesh if mesh is not None else get_mesh()
    n = head_shards(mesh)
    if mesh_is_trivial(mesh) or n <= hk:
        return 1
    if n % hk or hq % n:
        raise ValueError(f"head-sharding {n} ways with GQA replication needs n % kv_heads({hk}) == 0 and "
                         f"q_heads({hq}) % n == 0")
    return n // hk


@dataclass(frozen=True)
class TokenShard:
    """A rank's rows of the packed token axis: `S` real tokens padded to
    `n * rows` (the pad rows lie in no segment's kv range and are dropped),
    this rank's rows [start, start + rows)."""

    S: int
    n: int
    index: int

    @property
    def rows(self) -> int:
        return -(-self.S // self.n)

    @property
    def padded(self) -> int:
        return self.rows * self.n

    @property
    def start(self) -> int:
        return self.index * self.rows


def token_shard(S: int, mesh: Optional[Mesh] = None) -> TokenShard:
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return TokenShard(S, 1, 0)
    return TokenShard(S, seq_shards(mesh), mesh.seq_index())


# ---------------------------------------------------------------------------
# the shard rule of the DiT tree
# ---------------------------------------------------------------------------

_COL = ("linear_qkv/q/", "linear_qkv/qx/", "linear_qkv/k/", "linear_qkv/v/", "linear_kv_xattn/", "mlp/linear_fc1/")
_ROW = ("linear_proj/", "mlp/linear_fc2/")
_WEIGHTS = ("weight", "weight_q", "weight_q4")
_K_MAJOR = ("weight_q", "weight_q4")
TP_HALVES = "tp/2"  # a dim of two halves, each split over tp: the rank takes its block of each


def leaf_spec(path: str, ndim: int, gated: bool = False) -> tuple:
    """The sharding of the leaf at `path` ("blocks/mlp/linear_fc1/weight"),
    one entry per dim: "pp" (stacked layers), "tp", TP_HALVES or None: the
    JAX package's `dit_param_specs`, with the port's three differences (see
    the module's docstring).  `gated`: the model's MLP is gated (fc1's
    output is [gate | up])."""
    lead = (AXIS_PP,) if path.startswith("blocks/") else ()
    mat_nd = ndim - len(lead)
    name = path.rsplit("/", 1)[-1]
    col = any(c in path for c in _COL)
    row = any(r in path for r in _ROW)
    col_axis = TP_HALVES if gated and "mlp/linear_fc1/" in path else AXIS_TP
    row_axis = TP_HALVES if "linear_proj/" in path else AXIS_TP
    if mat_nd == 2 and name in _WEIGHTS and col:
        return lead + (None, col_axis)
    if mat_nd == 2 and name in _WEIGHTS and row:
        return lead + (row_axis, None)
    if mat_nd == 1 and col and name == "weight_scale":
        return lead + (col_axis,)
    if mat_nd == 1 and row and name == "act_smooth":
        return lead + (row_axis,)
    return lead + (None,) * mat_nd


def _is_gated(params: dict) -> bool:
    mlp = params["blocks"]["mlp"]
    fc1, fc2 = mlp["linear_fc1"], mlp["linear_fc2"]
    out1 = fc1["weight_scale" if "weight_scale" in fc1 else "weight"].shape[-1]
    in2 = (fc2["weight_q4"].shape[-2] * 2 if "weight_q4" in fc2 else
           fc2["weight_q" if "weight_q" in fc2 else "weight"].shape[-2])
    return out1 == 2 * in2


def _block(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"a dim of {n} does not split {parts} ways")
    w = n // parts
    return slice(i * w, (i + 1) * w)


def shard_leaf(path: str, leaf: torch.Tensor, mesh: Mesh, coords: Optional[Dict[str, int]] = None,
               gated: bool = False) -> torch.Tensor:
    """The rank's slice of the full leaf at `path` (coordinates `coords`,
    this rank's by default), as a tensor of its own (no view of `leaf`
    survives); int8 and packed int4 weights stay k-major, the layout the
    card's GEMMs take."""
    coords = mesh.coords() if coords is None else coords
    spec = leaf_spec(path, leaf.dim(), gated)
    if all(axis is None or mesh.shape[AXIS_TP if axis == TP_HALVES else axis] == 1 for axis in spec):
        return leaf
    out = leaf
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = out.shape[d]
        if axis == TP_HALVES:
            half = n // 2
            b = _block(half, mesh.shape[AXIS_TP], coords[AXIS_TP])
            out = torch.cat([out.narrow(d, b.start, b.stop - b.start), out.narrow(d, half + b.start, b.stop - b.start)],
                            dim=d)
        else:
            b = _block(n, mesh.shape[axis], coords[axis])
            out = out.narrow(d, b.start, b.stop - b.start)
    if path.rsplit("/", 1)[-1] in _K_MAJOR and out.dim() >= 2:
        return k_major(out)
    return out.clone(memory_format=torch.contiguous_format)


def shard_dit_params(params: dict, mesh: Optional[Mesh] = None, coords: Optional[Dict[str, int]] = None) -> dict:
    """The rank's shards of a full DiT tree (each a tensor of its own)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh_is_trivial(mesh):
        return params
    gated = _is_gated(params)

    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict) else
                shard_leaf(f"{prefix}{k}", v, mesh, coords, gated) for k, v in tree.items()}

    return walk(params, "")


class ShardSink(TreeSink):
    """A `TreeSink` that keeps one rank's shards (`shard_leaf`), so that no
    more than one full leaf is alive: each quantizable linear is quantized
    whole (its per-channel scales need every input row) and then sliced."""

    def __init__(self, mesh: Mesh, gated: bool, quant_bits: int = 0, keep_edge: bool = True,
                 coords: Optional[Dict[str, int]] = None):
        super().__init__(quant_bits, keep_edge)
        self.mesh, self.gated = mesh, gated
        self.coords = mesh.coords() if coords is None else coords

    def _put(self, path: str, full: torch.Tensor) -> None:
        self.flat[path] = shard_leaf(path, full, self.mesh, self.coords, self.gated)


def kv_cache_spec() -> tuple:
    """The KV cache [L, 2, hk*rep, tokens, hd]: kv heads over cp x pp x tp
    (the attention's head shards, so the cache enters the kernel with no
    traffic), the layer dim whole on every rank."""
    return (None, None, HEAD_AXES, None, None)


def shard_kv_cache(cache, mesh: Optional[Mesh] = None, rank: Optional[int] = None):
    """The head shard of `rank` (this process's by default) of a full KV
    cache (the tensor, or the int8 {kv, scale} dict, whose scale leaf
    shards the same way), along `kv_cache_spec`'s head dim."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh_is_trivial(mesh):
        return cache
    dim = kv_cache_spec().index(HEAD_AXES)
    b = lambda h: _block(h, head_shards(mesh), mesh.head_index(rank))

    def one(x):
        return x.narrow(dim, b(x.shape[dim]).start, x.shape[dim] // head_shards(mesh)).clone()

    return {kk: one(v) for kk, v in cache.items()} if isinstance(cache, dict) else one(cache)


def pp_layer_owner(layer: int, num_layers: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(pp index of the rank holding `layer`, its index in that rank's stack)."""
    mesh = mesh if mesh is not None else get_mesh()
    per = num_layers // mesh.shape[AXIS_PP]
    return layer // per, layer % per


_SLOT_ALIGN = 256  # bytes: each leaf of a layer slot starts on this boundary (TMA takes 16)


def pp_gather_layer(blocks: dict, idx: int, num_layers: int, mesh: Optional[Mesh] = None, edge: bool = False,
                    run=None):
    """Layer `idx` of the pp-sharded stack (each leaf [L/pp, ...] on a rank),
    broadcast from its owner over the pp group (the per-layer gather of
    layer-FSDP).  Returns a `comm.Pending` whose `wait()` gives the layer's
    tree: the broadcasts are issued now (asynchronously; under NCCL from a
    side stream, so they do not queue behind the compute already issued on
    the current one) and the caller waits when it needs the layer, so the
    gather of layer i+1 overlaps layer i.  Integer leaves travel as they
    are (a broadcast needs no float round trip).  `edge`: the layer runs on
    the bf16 weights of `blocks_edge`, which every rank holds (layers 0 and
    L-1 of a quantized tree), so the leaves of its quantized linears are
    not broadcast and come back as None.

    The owner sends views of its stack.  The others receive into `run`'s
    slot of the layer's parity (`core.graphs`: two buffers, each sized for
    a whole layer, every leaf at a fixed offset in it), so a captured
    step's graphs read each layer at a fixed address.  The caller issues
    the gather of layer idx after the pieces of layer idx - 2, the last
    readers of its slot, and before those of layer idx - 1: the broadcast
    first waits for the work queued on the current stream
    (`comm.broadcast_many`), so it never overwrites the slot under its last
    reader and still overlaps layer idx - 1.  While `run` captures nothing
    is broadcast."""
    from magi_tpu_torch.core.graphs import PLAIN
    from magi_tpu_torch.parallel import comm

    run = PLAIN if run is None else run
    mesh = mesh if mesh is not None else get_mesh()
    if num_layers % mesh.shape[AXIS_PP]:
        raise ValueError(f"num_layers {num_layers} must divide pp={mesh.shape[AXIS_PP]}")
    owner_pp, li = pp_layer_owner(idx, num_layers, mesh)
    coords = mesh.coords()
    src = int(mesh.ranks[coords[AXIS_DP], owner_pp, coords[AXIS_CP], coords[AXIS_TP]])
    mine = coords[AXIS_PP] == owner_pp
    flat = dict(tree_leaves(blocks))
    skipped = [p for p in flat if edge and any(p.rpartition("/")[0] + "/" + w in flat for w in _K_MAJOR)]
    layout = []  # per leaf: (the layer's view on the owner (a k-major weight's memory order), transposed, offset)
    offset = 0
    for p, leaf in flat.items():
        one = leaf[li]
        kmaj = one.dim() >= 2 and not one.is_contiguous() and one.transpose(-1, -2).is_contiguous()
        if p not in skipped:
            layout.append((p, one.transpose(-1, -2) if kmaj else one, kmaj, offset))
        offset += -(-one.numel() * one.element_size() // _SLOT_ALIGN) * _SLOT_ALIGN
    device = next(iter(flat.values())).device
    if mine:
        tensors = [v.contiguous() for _, v, _, _ in layout]
    else:
        buf = run.slot(("pp_layer", idx % 2), (offset,), torch.uint8, device)
        tensors = [buf[o:o + v.numel() * v.element_size()].view(v.dtype).view(v.shape) for _, v, _, o in layout]
    if run.copies_live:
        pending = comm.broadcast_many(tensors, src, mesh.group("pp"))
    else:
        pending = comm.Pending(lambda: tensors)

    def finish():
        got = pending.wait()
        return nest([(p, None) for p in skipped] + [(path, buf.transpose(-1, -2) if transposed else buf)
                                                    for (path, _, transposed, _), buf in zip(layout, got)])

    return comm.Pending(finish)
