"""The port's multi-rank parallelism (`magi_tpu_torch.parallel`) against the
JAX package's mesh (`magi_tpu.parallel`), on the CPU.

* The shard rule: on pp2 x cp2 x tp2, every leaf's slice at each rank's
  coordinates equals the shard JAX's `dit_param_specs` puts on the device
  at those coordinates (f32, bf16, int8, int4, smooth-folded int8 and
  gated int8 trees),
  except where the port's rule differs on purpose (linear_proj's rows, a
  gated fc1's columns, a row-parallel linear's act_smooth: each a block of
  each half, or split with the rows), which are held against that rule
  written out here; the sink that draws (or loads from an fp8
  checkpoint) a tree leaf by leaf gives the slices of the full tree.  The rank layout equals `build_mesh`'s, over
  several nodes too (the JAX package's own node-aware layout on stand-in
  devices, and its node split mocked as `tests/test_parallel.py` does);
  `kv_replication`, `head_shards`, `seq_shards` and the rank's cache shape
  equal JAX's on several meshes.
* One gloo world of 4 ranks (`tests/torch_dist.py`) runs, while the JAX
  references compute here: fp32 3-CFG walks on cp2 x tp2 and pp2 x cp2
  (a shard straddles a segment boundary) against JAX's single-device walk;
  a pp2 x cp2 walk of 4 q / 2 kv heads (kv replication 2) over 18-token
  chunks (a token count the 4 shards do not divide) with `kv_offload`
  under the default kv ranges (ignored: no host mode); the distill int8
  walk with int8 attention and the smooth-folded int8 walk on cp2 x tp2
  against the JAX package's walk on a cp2 x tp2 mesh of 4 CPU devices; two
  requests on dp2 x cp2 against JAX's DpBatchedSampler; `pp_gather_layer`
  (every layer exact, f32, int8 and k-major int8); `pmap_tile_batch` of 3
  tiles over a replica of 2 ranks and the tiled VAE encode and decode.
  The same world walks cp2 x tp2, pp2 x cp2, the int8 pp2 x tp2 and dp2 x
  cp2 through `core.graphs.StandIn`, the CPU stand-in of captured steps
  (each piece's function replayed on the arguments it was recorded with,
  as a CUDA graph replays the addresses it baked): twice, bit-equal to
  the same rank's eager walk, the second capturing nothing (it takes the
  first's workspace), both against the JAX walks above; and on cp2 x tp2
  with the all-to-all handing its pieces a new buffer at each call instead
  of its slot, where the strict stand-in raises, naming the piece, and the
  loose one's chunks differ from the eager walk's.
* The CLI entry under torchrun, a gloo world of 2 on the CPU, writes one
  video, on rank 0; the service's engine command runs under torchrun
  exactly when the config's world_size is above 1.

Tolerances: fp32 walks 2e-4 absolute and relative, as the JAX package's
own sharded walks are held to their single-device walk
(`tests/test_parallel.py`; the sums run in another order on shards); int8
walks 2e-2, the JAX package's for its sharded int8 walks (a value on an
int8 rounding edge can flip when f32 partial sums come out in another
order), and the relative L2 of every chunk under 5e-3 (seen: 1.1e-3; the
port's and the JAX package's single-device walks of this tree differ by
up to 7.8e-4, and the JAX package's mesh walk from its own single-device
walk by up to 6.8e-4)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from magi_tpu.models.dit.model import init_dit_params as jax_init
from magi_tpu.models.dit.model import kv_cache_shape as jax_kv_cache_shape
from magi_tpu.ops.quant import quantize_params_int4, quantize_params_int8
from magi_tpu.parallel import mesh as JM
from magi_tpu.sampling.batched import DpBatchedSampler as JaxBatched
from magi_tpu.sampling.transport import ArdfSampler as JaxSampler
from magi_tpu.sampling.transport import InferenceInput as JaxInput
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax
from magi_tpu_torch.core.utils import tree_leaves
from magi_tpu_torch.models.dit.model import init_dit_params, kv_cache_shape
from magi_tpu_torch.parallel import mesh as M
from magi_tpu_torch.sampling.transport import InferenceInput
from tests.test_torch_dit import torch_config
from tests.tiny import tiny_config
from tests.torch_dist import REPO, start_world
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WALK_TOL = dict(atol=2e-4, rtol=2e-4)
INT8_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True)
def _clean_meshes():
    yield
    JM.destroy_mesh()
    M.destroy_mesh()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the shard rule, the layout and the head arithmetic
# ---------------------------------------------------------------------------


def _with_smooth(params, seed=5):
    """act_smooth on the four smooth-quant linears, 1 on the edge layers (as
    an fp8 checkpoint loads)."""
    rng = np.random.default_rng(seed)
    L = params["blocks"]["mlp"]["linear_fc1"]["weight"].shape[0]
    b = params["blocks"]
    for node in (b["self_attention"]["linear_proj"], b["self_attention"]["linear_kv_xattn"], b["mlp"]["linear_fc1"],
                 b["mlp"]["linear_fc2"]):
        sm = rng.uniform(0.5, 2.0, size=(L, node["weight"].shape[1])).astype(np.float32)
        sm[0] = sm[-1] = 1.0
        node["act_smooth"] = jnp.asarray(sm)
    return params


SHARD_MODEL = {"num_attention_heads": 8, "num_query_groups": 4, "hidden_size": 128, "kv_channels": 16,
               "num_layers": 4}
TREES = {
    "f32": ({}, lambda p: p),
    "bf16": ({"params_dtype": jnp.bfloat16}, lambda p: p),
    "int8": ({}, quantize_params_int8),
    "int4": ({}, quantize_params_int4),
    "smooth_int8": ({}, lambda p: quantize_params_int8(_with_smooth(p))),
    "gated_int8": ({"gated_linear_unit": True}, quantize_params_int8),
}


def _own_rule(path, a, spec, coords, shape):
    """The port's differing rule written out: pp blocks of layers, then the
    rank's tp block of each half of a TP_HALVES dim, or its tp block."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = a.shape[d]
        if axis == M.TP_HALVES:
            w = n // 2 // shape["tp"]
            t = coords["tp"]
            a = np.concatenate([np.take(a, range(t * w, (t + 1) * w), axis=d),
                                np.take(a, range(n // 2 + t * w, n // 2 + (t + 1) * w), axis=d)], axis=d)
        else:
            w = n // shape[axis]
            a = np.take(a, range(coords[axis] * w, (coords[axis] + 1) * w), axis=d)
    return a


@pytest.mark.parametrize("tree", sorted(TREES))
def test_shard_rule_matches_jax(tree, eight_devices):
    model, make = TREES[tree]
    cfg = tiny_config(model={**SHARD_MODEL, **model})
    jparams = make(jax_init(jax.random.PRNGKey(0), cfg))
    tparams = dit_params_from_jax(_np(jparams))
    jmesh = JM.build_mesh(pp=2, cp=2, tp=2, devices=eight_devices)
    tmesh = M.build_mesh(pp=2, cp=2, tp=2)
    gated = bool(model.get("gated_linear_unit"))
    jspecs = JM.dit_param_specs(jparams)
    flat_t = dict(tree_leaves(tparams))
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat_s = {"/".join(str(getattr(k, "key", k)) for k in path): s for path, s in
              jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert set(flat_t) == set(flat_j)
    own = 0
    for path, tleaf in flat_t.items():
        spec = M.leaf_spec(path, tleaf.dim(), gated)
        differs = M.TP_HALVES in spec or (path.endswith("act_smooth") and "tp" in spec)
        arr = jax.device_put(flat_j[path], NamedSharding(jmesh, flat_s[path]))
        for shard in arr.addressable_shards:
            idx = np.argwhere(jmesh.devices == shard.device)[0]
            coords = dict(zip(M.AXES, (int(i) for i in idx)))
            got = M.shard_leaf(path, tleaf, tmesh, coords, gated)
            want = (_own_rule(path, np.asarray(flat_j[path], np.float32), spec, coords, tmesh.shape) if differs
                    else np.asarray(shard.data, np.float32))
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"{path} at {coords}")
            if path.endswith(("weight_q", "weight_q4")):
                assert got.transpose(-1, -2).is_contiguous(), path  # k-major, as the card's GEMMs take it
        own += differs
    # linear_proj's rows (stack and edge layers), + row-parallel act_smooth, + a gated fc1's columns
    assert own == {"f32": 1, "bf16": 1, "int8": 3, "int4": 3, "smooth_int8": 5, "gated_int8": 7}[tree]


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_sink_builds_the_slices_of_the_full_tree(bits):
    """init_dit_params through a ShardSink (leaf by leaf, each quantized whole
    and then sliced) gives the slices of the full tree from the same seed,
    quantized as the whole tree is."""
    from magi_tpu_torch.ops.quant import quantize_params_int4 as q4
    from magi_tpu_torch.ops.quant import quantize_params_int8 as q8

    cfg = torch_config(tiny_config(model={**SHARD_MODEL, "gated_linear_unit": True}))
    full = init_dit_params(cfg, "cpu", torch.Generator().manual_seed(3))
    full = {0: lambda p: p, 8: q8, 4: q4}[bits](full)
    mesh = M.build_mesh(pp=2, cp=2, tp=2)
    for coords in ({"dp": 0, "pp": 1, "cp": 0, "tp": 1}, {"dp": 0, "pp": 0, "cp": 1, "tp": 0}):
        sink = M.ShardSink(mesh, gated=True, quant_bits=bits, coords=coords)
        local = init_dit_params(cfg, "cpu", torch.Generator().manual_seed(3), sink=sink)
        want = M.shard_dit_params(full, mesh, coords)
        fl, fw = dict(tree_leaves(local)), dict(tree_leaves(want))
        assert set(fl) == set(fw)
        for k in fw:
            assert torch.equal(fl[k], fw[k]), k


def test_loader_sink_keeps_the_slices_of_the_loaded_tree(tmp_path):
    """An fp8 checkpoint loaded through a ShardSink (each leaf dequantized,
    smooth-folded and quantized whole, then sliced) gives the slices of the
    whole loaded and quantized tree, act_smooth included."""
    from magi_tpu_torch.checkpoint import loader as TL
    from magi_tpu_torch.ops.quant import quantize_params_int8 as q8
    from tests.test_torch_checkpoint import write_fp8_pair

    cfg = tiny_config(model={"num_layers": 4}, runtime={"cfg_number": 1}, engine={"fp8_quant": True})
    _, tdir, _ = write_fp8_pair(tmp_path, cfg)
    tcfg = torch_config(cfg)
    tcfg.runtime_config.load = str(tdir)
    full = q8(TL.load_dit_params(tcfg, "cpu"))
    assert "act_smooth" in full["blocks"]["mlp"]["linear_fc2"]
    mesh = M.build_mesh(pp=2, cp=2, tp=2)
    for coords in ({"dp": 0, "pp": 1, "cp": 0, "tp": 1}, {"dp": 0, "pp": 0, "cp": 1, "tp": 0}):
        local = TL.load_dit_params(tcfg, "cpu", sink=M.ShardSink(mesh, gated=False, quant_bits=8, coords=coords))
        fl, fw = dict(tree_leaves(local)), dict(tree_leaves(M.shard_dit_params(full, mesh, coords)))
        assert set(fl) == set(fw)
        for k in fw:
            assert torch.equal(fl[k], fw[k]), k


def test_rank_layout_matches_build_mesh(monkeypatch, sixteen_devices):
    ids = np.vectorize(lambda d: d.id)
    for shape in [(1, 2, 2, 2), (2, 1, 2, 2), (2, 2, 2, 2), (1, 1, 4, 4)]:
        j = JM.build_mesh(*shape, devices=sixteen_devices)
        np.testing.assert_array_equal(M.build_mesh(*shape).ranks, ids(j.devices) - sixteen_devices[0].id)

    # several nodes: the JAX package's hybrid layout on stand-in devices
    # (node = process), then its node split as tests/test_parallel.py mocks it
    from jax.experimental import mesh_utils

    class Dev:
        def __init__(self, i, per):
            self.id, self.process_index, self.slice_index = i, i // per, i // per
            self.platform = self.device_kind = "cpu"

    for shape, nodes in [((2, 2, 2, 2), 4), ((1, 2, 2, 2), 2), ((2, 2, 2, 2), 2), ((4, 1, 2, 1), 2),
                         ((1, 1, 2, 2), 2)]:
        n = int(np.prod(shape))
        dcn, per = M._node_split(shape, nodes)
        devs = [Dev(i, n // nodes) for i in range(n)]
        j = mesh_utils.create_hybrid_device_mesh(per, dcn, devices=devs, process_is_granule=True)
        np.testing.assert_array_equal(M.build_mesh(*shape, nodes=nodes).ranks, ids(j))

    calls = {}

    def fake_hybrid(per_host, dcn_mesh_shape):
        calls["per_host"], calls["dcn"] = tuple(per_host), tuple(dcn_mesh_shape)
        need = int(np.prod(per_host)) * int(np.prod(dcn_mesh_shape))
        return np.asarray(jax.devices()[:need]).reshape(tuple(d * p for d, p in zip(dcn_mesh_shape, per_host)))

    monkeypatch.setattr(mesh_utils, "create_hybrid_device_mesh", fake_hybrid)
    for shape, nodes in [((2, 2, 2, 2), 4), ((1, 1, 2, 2), 2), ((1, 2, 2, 2), 2)]:
        monkeypatch.setattr(jax, "process_count", lambda: nodes)
        JM.build_mesh(*shape)
        assert M._node_split(shape, nodes) == (calls["dcn"], calls["per_host"])
    with pytest.raises(ValueError, match="cannot lay 3 nodes"):
        M.build_mesh(2, 2, 2, 2, nodes=3)


@pytest.mark.parametrize("shape,heads", [((1, 1, 2, 2), (8, 4)), ((1, 2, 2, 2), (8, 8)), ((1, 1, 4, 4), (16, 8)),
                                         ((2, 1, 4, 1), (8, 2)), ((1, 1, 8, 1), (48, 8)), ((1, 2, 1, 1), (4, 2))])
def test_head_arithmetic_and_cache_shape_match_jax(shape, heads, sixteen_devices):
    hq, hk = heads
    jmesh = JM.build_mesh(*shape, devices=sixteen_devices)
    tmesh = M.build_mesh(*shape)
    assert M.kv_replication(hq, hk, tmesh) == JM.kv_replication(hq, hk, jmesh)
    assert M.head_shards(tmesh) == JM.head_shards(jmesh) and M.seq_shards(tmesh) == JM.seq_shards(jmesh)
    cfg = tiny_config(model={"num_attention_heads": hq, "num_query_groups": hk, "hidden_size": 16 * hq})
    JM.set_mesh(jmesh)
    M.set_mesh(tmesh)
    want = NamedSharding(jmesh, JM.kv_cache_spec()).shard_shape(jax_kv_cache_shape(cfg, 1024))
    assert kv_cache_shape(torch_config(cfg), 1024) == want
    # a full cache cut to each rank's shard, as JAX places it on that rank's device
    full = np.random.default_rng(0).normal(size=jax_kv_cache_shape(cfg, 4)).astype(np.float32)
    arr = jax.device_put(full, NamedSharding(jmesh, JM.kv_cache_spec()))
    for shard in arr.addressable_shards:
        rank = int(tmesh.ranks[tuple(np.argwhere(jmesh.devices == shard.device)[0])])
        np.testing.assert_array_equal(M.shard_kv_cache(torch.from_numpy(full), tmesh, rank).numpy(),
                                      np.asarray(shard.data))


def test_world_size_must_match_the_launcher(monkeypatch):
    cfg = torch_config(tiny_config(engine={"cp_size": 2}))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node 2"):
        M.maybe_init_multihost(cfg)


def test_service_engine_runs_under_torchrun_past_one_rank(tmp_path):
    from magi_tpu_torch.serve.generator import _entry_cmd

    with open(os.path.join(REPO, "example", "24B", "24B_distill_config.json")) as f:
        d = json.load(f)
    path = tmp_path / "c.json"
    for sizes, world in [(dict(cp_size=8), 8), (dict(cp_size=2, tp_size=2, dp_size=2), 8), (dict(cp_size=1), 1)]:
        d["engine_config"].update(dict(dict(cp_size=1, tp_size=1, dp_size=1, pp_size=1), **sizes))
        path.write_text(json.dumps(d))
        cmd = _entry_cmd(str(path), "t2v")
        tail = ["-m", "magi_tpu_torch.pipeline.entry", "--config_file", str(path), "--mode", "t2v"]
        if world > 1:
            assert cmd == [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                           str(world)] + tail
        else:
            assert cmd == [sys.executable] + tail


# ---------------------------------------------------------------------------
# one gloo world of 4 ranks: walks, dp, the layer gather, tile parallelism
# ---------------------------------------------------------------------------

H = W = 8


def _inputs(cfg, chunk_num, hw=H, seed=0, null_seed=None):
    """The same request for both packages (its null caption from `null_seed`,
    by default `seed`: a batch's requests share the model's)."""
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(seed)
    L = mc.caption_max_length
    cap = rng.normal(size=(chunk_num, L, mc.caption_channels)).astype(np.float32)
    null = np.random.default_rng(seed if null_seed is None else null_seed).normal(
        size=(L + 1, mc.caption_channels)).astype(np.float32)[1:]
    lens = np.array([L // 2, 3, L, 7][:chunk_num], np.int32)
    latent = (mc.in_channels, chunk_num * rc.chunk_width, hw, hw)
    jinp = JaxInput(caption_embs=jnp.asarray(cap), caption_lens=lens, null_emb=jnp.asarray(null), null_len=8,
                    latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True)
    tinp = InferenceInput(caption_embs=torch.from_numpy(cap), caption_lens=lens, null_emb=torch.from_numpy(null),
                          null_len=8, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunk_num, has_text=True)
    return jinp, tinp


def _jax_walk(cfg, params, jinp, mesh_devices=None):
    if mesh_devices is not None:
        mesh = JM.initialize_mesh(cfg, devices=mesh_devices)
        params = JM.shard_dit_params(params, mesh)
    s = JaxSampler(cfg, params, jinp, jax.random.PRNGKey(7))
    noise = np.array(s.xs)
    if mesh_devices is not None:
        s.cache = JM.shard_kv_cache(s.cache)
    out = [np.asarray(c) for _, c in s.walk()]
    JM.destroy_mesh()
    return noise, out


# A: 8 q / 4 kv heads, 3 chunks, window 3 (forwards of 1-3 segments of 32
# tokens: on cp2 x tp2 a 48-row shard straddles a segment boundary)
CFG_A = dict(model={"num_attention_heads": 8, "num_query_groups": 4, "hidden_size": 128, "kv_channels": 16},
             runtime={"window_size": 3, "num_steps": 6})
# B: 4 q / 2 kv heads on 4 head shards (replication 2), 18-token chunks
# (the 4 token shards of 1-2 segments need padding), kv_offload under the
# default kv ranges
CFG_B = dict(model={"num_attention_heads": 4, "num_query_groups": 2}, runtime={"num_steps": 4})
# C: the distill int8 walk, int8 attention, 4 layers (bf16-edge first and
# last), the ride-along chunk making 3 segments of 32 tokens
CFG_C = dict(model={"num_attention_heads": 8, "num_query_groups": 4, "hidden_size": 128, "kv_channels": 16,
                    "num_layers": 4},
             runtime={"cfg_number": 1, "num_steps": 4, "noise2clean_kvrange": [2, 1], "clean_chunk_kvrange": 1},
             engine={"distill": True, "fp8_quant": True})


def _cfg(spec, **engine):
    return tiny_config(model=dict(spec.get("model", {})), runtime=dict(spec.get("runtime", {})),
                       engine={**spec.get("engine", {}), **engine})


def _port_cfg(cfg, **engine):
    tc = torch_config(cfg)
    return dataclasses.replace(tc, engine_config=dataclasses.replace(tc.engine_config, **engine))


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory, sixteen_devices):
    """The 4-rank world's results (one dict a rank) and the JAX references."""
    cases, refs = {}, {}

    # A: fp32 3-CFG walks on cp2 x tp2 and pp2 x cp2
    cfg_a = _cfg(CFG_A)
    params_a = jax_init(jax.random.PRNGKey(0), cfg_a)
    tparams_a = dit_params_from_jax(_np(params_a))
    jinp_a, tinp_a = _inputs(cfg_a, 3)
    noise_a = np.array(JaxSampler(cfg_a, params_a, jinp_a, jax.random.PRNGKey(7)).xs)
    for name, mesh in (("cp2_tp2", dict(cp=2, tp=2)), ("pp2_cp2", dict(pp=2, cp=2))):
        cases[name] = dict(kind="walk", mesh=mesh, params=tparams_a, inp=tinp_a, noise=torch.from_numpy(noise_a),
                           config=_port_cfg(cfg_a, **{f"{k}_size": v for k, v in mesh.items()}))

    # B: replication, padding, kv_offload ignored
    cfg_b = _cfg(CFG_B)
    params_b = jax_init(jax.random.PRNGKey(1), cfg_b)
    jinp_b, tinp_b = _inputs(cfg_b, 2, hw=6, seed=1)
    noise_b = np.array(JaxSampler(cfg_b, params_b, jinp_b, jax.random.PRNGKey(7)).xs)
    cases["rep2_padded"] = dict(kind="walk", mesh=dict(pp=2, cp=2), params=dit_params_from_jax(_np(params_b)),
                                inp=tinp_b, noise=torch.from_numpy(noise_b),
                                config=_port_cfg(cfg_b, pp_size=2, cp_size=2, kv_offload=True))

    # C: int8 and smooth-folded int8 on cp2 x tp2
    cfg_c = _cfg(CFG_C)
    base_c = jax_init(jax.random.PRNGKey(2), cfg_c)
    trees_c = {"int8": quantize_params_int8(base_c), "smooth_int8": quantize_params_int8(_with_smooth(base_c))}
    jinp_c, tinp_c = _inputs(cfg_c, 3, seed=2)
    noise_c = np.array(JaxSampler(cfg_c, trees_c["int8"], jinp_c, jax.random.PRNGKey(7)).xs)
    for name, tree in trees_c.items():
        cases[name] = dict(kind="walk", mesh=dict(cp=2, tp=2), params=dit_params_from_jax(_np(tree)), inp=tinp_c,
                           noise=torch.from_numpy(noise_c),
                           config=_port_cfg(cfg_c, cp_size=2, tp_size=2, attn_int8=True))

    # int8 on pp2 x tp2: layer-FSDP, its edge layers on blocks_edge (their
    # quantized leaves not broadcast), the row-parallel int8 linears
    cases["pp2_tp2_int8"] = dict(kind="walk", mesh=dict(pp=2, tp=2), params=cases["int8"]["params"], inp=tinp_c,
                                 noise=torch.from_numpy(noise_c),
                                 config=_port_cfg(cfg_c, pp_size=2, tp_size=2, attn_int8=True))

    # dp2 x cp2: two requests, each dp group one
    jinps_d = [_inputs(cfg_a, 3, seed=s, null_seed=3)[0] for s in (3, 4)]
    tinps_d = [_inputs(cfg_a, 3, seed=s, null_seed=3)[1] for s in (3, 4)]
    jb = JaxBatched(cfg_a, params_a, jinps_d, [jax.random.PRNGKey(11), jax.random.PRNGKey(12)])
    cases["dp2_cp2"] = dict(kind="dp_walk", mesh=dict(dp=2, cp=2), params=tparams_a, inps=tinps_d,
                            noises=[torch.from_numpy(np.array(jb.xs[i])) for i in range(2)],
                            config=_port_cfg(cfg_a, dp_size=2, cp_size=2))
    cases["pp_gather"] = dict(kind="pp_gather", mesh=dict(pp=2, cp=2))
    cases["tile"] = dict(kind="tile", mesh=dict(dp=2, cp=2),
                         video=np.random.default_rng(0).normal(size=(1, 3, 24, 32, 32)).astype(np.float32))
    # the captured steps' stand-in on four of the walks above
    for name in GRAPH_WALKS:
        c = {k: v for k, v in cases[name].items() if k != "kind"}
        cases[name + "_graphs"] = dict(c, kind="graph_walk", walk=cases[name]["kind"], trap=name == "cp2_tp2")

    world = start_world(4, cases, tmp_path_factory.mktemp("gloo_world"))
    # the references, while the ranks run
    refs["A"] = _jax_walk(cfg_a, params_a, jinp_a)[1]
    refs["B"] = _jax_walk(cfg_b, params_b, jinp_b)[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTN_INT8", "1")
        jcfg_c = _cfg(CFG_C, cp_size=2, tp_size=2)
        for name, tree in trees_c.items():
            refs[name] = _jax_walk(jcfg_c, tree, jinp_c, mesh_devices=sixteen_devices[:4])[1]
    dp_ref = [[], []]
    for _, chunks in jb.walk():
        for r in range(2):
            dp_ref[r].append(np.asarray(chunks[r]))
    refs["dp"] = dp_ref
    return world.results(), refs


# the walks of the world that also walk through the captured steps' stand-in
GRAPH_WALKS = ("cp2_tp2", "pp2_cp2", "pp2_tp2_int8", "dp2_cp2")


def test_gloo_world_matches_jax(gloo_world):
    res, refs = gloo_world
    dp_ref = refs["dp"]

    for name in ("cp2_tp2", "pp2_cp2"):
        for rank in res:
            got = rank[name]["chunks"]
            assert len(got) == len(refs["A"]) == 3
            for g, w in zip(got, refs["A"]):
                np.testing.assert_allclose(g.numpy(), w, **WALK_TOL)
    # the rank's cache is its head shard: 4 kv heads over 4 shards
    assert {r["cp2_tp2"]["cache_shape"][2] for r in res} == {1}
    assert sorted(r["cp2_tp2"]["head"] for r in res) == [0, 1, 2, 3]

    for rank in res:
        b = rank["rep2_padded"]
        assert not b["host_mode"] and b["cache_shape"][2] == 1  # 2 kv heads x 2 replicas over 4 shards
        for g, w in zip(b["chunks"], refs["B"]):
            np.testing.assert_allclose(g.numpy(), w, **WALK_TOL)
        assert len(b["chunks"]) == len(refs["B"]) == 2

    # pp2 x tp2 against JAX's cp2 x tp2 int8 walk: the same function, the
    # tokens split over pp instead of cp
    for name, ref in [(n, n) for n in ("int8", "smooth_int8")] + [("pp2_tp2_int8", "int8")]:
        for rank in res:
            got = rank[name]["chunks"]
            assert len(got) == len(refs[ref]) == 3
            for g, w in zip(got, refs[ref]):
                np.testing.assert_allclose(g.numpy(), w, **INT8_TOL)
                assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) < 5e-3

    # dp: ranks 0, 1 (dp 0) walked request 0, ranks 2, 3 request 1
    for r, rank in enumerate(res):
        (i, chunks), = rank["dp2_cp2"].items()
        assert i == r // 2
        for g, w in zip(chunks, dp_ref[i]):
            np.testing.assert_allclose(g.numpy(), w, **WALK_TOL)
        assert len(chunks) == len(dp_ref[i]) == 3

    for rank in res:
        assert rank["pp_gather"] == [True] * 6
        t = rank["tile"]
        assert t["pmap_equal"] and t["seen"][0] == 2  # 3 tiles padded to 4, 2 a rank
        assert t["z_err"] < 1e-5 and t["y_err"] < 1e-5


def test_gloo_world_replays_mesh_steps(gloo_world):
    """The stand-in's captured walks equal the eager ones bit for bit and
    the JAX walks within the tolerances above; a second walk captures
    nothing; a collective handing its pieces new buffers is caught."""
    res, refs = gloo_world

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    wants = {"cp2_tp2": (refs["A"], WALK_TOL), "pp2_cp2": (refs["A"], WALK_TOL),
             "pp2_tp2_int8": (refs["int8"], INT8_TOL), "dp2_cp2": (None, WALK_TOL)}
    for r, rank in enumerate(res):
        for name in GRAPH_WALKS:
            got = rank[name + "_graphs"]
            want, tol = wants[name]
            if name == "dp2_cp2":  # rank r walked request r // 2
                want = refs["dp"][r // 2]
                got = dict(got, **{k: got[k][r // 2] for k in ("eager", "captured", "again")})
            assert got["captured_pieces"] > 0 and got["again_pieces"] == 0, (name, r)
            assert same(got["captured"], got["eager"]) and same(got["again"], got["eager"]), (name, r)
            assert len(got["eager"]) == len(want) == 3
            for g, w in zip(got["captured"], want):
                np.testing.assert_allclose(g.numpy(), w, **tol)
                if tol is INT8_TOL:
                    assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) < 5e-3
        trap = rank["cp2_tp2_graphs"]
        assert "piece attn was handed other arguments" in trap["trap_error"]
        assert not same(trap["trap_chunks"], trap["eager"])


# ---------------------------------------------------------------------------
# the CLI entry under torchrun
# ---------------------------------------------------------------------------


def test_entry_under_torchrun_writes_one_video_on_rank_0(tmp_path):
    with open(os.path.join(REPO, "example", "4.5B", "4.5B_base_config.json")) as f:
        d = json.load(f)
    d["model_config"].update(num_layers=2, hidden_size=64, ffn_hidden_size=128, num_attention_heads=4,
                             num_query_groups=2, kv_channels=16, params_dtype="float32", caption_channels=32,
                             caption_max_length=32, in_channels=16, out_channels=16)
    d["runtime_config"].update(num_frames=48, video_size_h=64, video_size_w=64, num_steps=4, window_size=2,
                               noise2clean_kvrange=[2, 1])
    d["engine_config"].update(cp_size=2, distributed_backend="gloo")
    cfg = tmp_path / "tiny_cp2.json"
    cfg.write_text(json.dumps(d))
    out_dir = tmp_path / "out"
    env = dict(os.environ, SKIP_LOAD_MODEL="1", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                        "-m", "magi_tpu_torch.pipeline.entry", "--config_file", str(cfg), "--mode", "t2v",
                        "--prompt", "a red cube", "--output_path", str(out_dir / "out.mp4"), "--device", "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    written = os.listdir(out_dir)
    assert len(written) == 1 and written[0].startswith("out.mp4"), written
    # only rank 0 logs
    assert p.stdout.count("frames -> ") == 1
