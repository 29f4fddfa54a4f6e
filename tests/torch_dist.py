"""A gloo world of the port's ranks on the CPU, for the parallel tests.

`start_world(n, cases, tmp_path)` writes the cases to a file and starts n
processes of `python tests/torch_dist.py <file>` with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each
joins a gloo process group, runs every case in order on one intra-op
thread and saves what it returns.  `World.results()` waits for the ranks
and gives their results, one dict a rank; a rank that fails fails the test
with its output.  The ranks import torch and the port only, so a test
computes its JAX references in its own process while they run.

Case kinds (each a dict with "kind" and its inputs): "walk" (an
ArdfSampler walk of the given full tree, sharded on the given mesh),
"dp_walk" (each dp group's share of a DpBatchedSampler batch), "pp_gather"
(every layer of a pp-sharded stack of f32, int8 and k-major int8 leaves),
"tile" (`pmap_tile_batch` and the tiled VAE decode against their
unsharded results), "card_walk" (a tiny config drawn on cuda:0 and walked
eagerly, captured and captured again; the ranks share the card) and
"graph_walk" (a "walk" or "dp_walk" case walked
eagerly, then twice through the CPU stand-in of captured steps,
`core.graphs.StandIn`; with "trap", a third time with the all-to-all
handing its pieces a new buffer at each call instead of its slot, once
strict and once not)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class World:
    def __init__(self, procs, path):
        self.procs, self.path = procs, path

    def results(self, timeout: float = 600):
        outs = []
        for r, p in enumerate(self.procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise
            outs.append(out)
        failed = [(r, o) for r, (p, o) in enumerate(zip(self.procs, outs)) if p.returncode != 0]
        if failed:
            r, o = failed[0]
            raise AssertionError(f"rank {r} of the gloo world failed:\n{o[-6000:]}")
        return [torch.load(f"{self.path}.rank{r}", weights_only=False) for r in range(len(self.procs))]


def start_world(n: int, cases: dict, tmp_path) -> World:
    path = str(tmp_path / "cases.pt")
    torch.save(cases, path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        # run as a file: an installed package named `tests` would shadow this directory
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), path], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return World(procs, path)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _mesh(sizes: dict, device=None):
    from magi_tpu_torch.parallel import mesh as M

    return M.initialize_mesh(**{k: sizes.get(k, 1) for k in ("dp", "pp", "cp", "tp")}, device=device)


def _walk(c, params=None, capture=True):
    from magi_tpu_torch.parallel import mesh as M
    from magi_tpu_torch.sampling.transport import ArdfSampler

    mesh = _mesh(c["mesh"]) if params is None else M.get_mesh()
    params = M.shard_dit_params(c["params"], mesh) if params is None else params
    s = ArdfSampler(c["config"], params, c["inp"], noise=c["noise"], device="cpu", capture=capture)
    chunks = [ch.clone() for _, ch in s.walk()]
    leaf = s.cache["kv"] if isinstance(s.cache, dict) else s.cache
    return {"chunks": chunks, "cache_shape": tuple(leaf.shape), "host_mode": s.host_mode,
            "head": mesh.head_index(), "seq": mesh.seq_index()}


def _dp_walk(c, params=None, capture=True):
    from magi_tpu_torch.parallel import mesh as M
    from magi_tpu_torch.sampling.batched import DpBatchedSampler, _maybe_dp_shard

    mesh = _mesh(c["mesh"]) if params is None else M.get_mesh()
    params = M.shard_dit_params(c["params"], mesh) if params is None else params
    share = _maybe_dp_shard(len(c["inps"]))
    s = DpBatchedSampler(c["config"], params, [c["inps"][i] for i in share], noises=[c["noises"][i] for i in share],
                         device="cpu", capture=capture)
    out = {i: [] for i in share}
    for _, chunks in s.walk():
        for j, i in enumerate(share):
            out[i].append(chunks[j].clone())
    return out


def _pp_gather(c):
    from magi_tpu_torch.core.utils import tree_leaves
    from magi_tpu_torch.ops.quant import k_major
    from magi_tpu_torch.parallel import mesh as M

    mesh = _mesh(c["mesh"])
    L = 4
    full = {
        "w": torch.arange(L * 8 * 8, dtype=torch.float32).reshape(L, 8, 8),
        "q": ((torch.arange(L * 8) % 127) - 63).to(torch.int8).reshape(L, 8),
        "wq": k_major(((torch.arange(L * 16 * 32) % 255) - 127).to(torch.int8).reshape(L, 16, 32)),
        "lin": {"weight_q": k_major(((torch.arange(L * 16 * 8) % 255) - 127).to(torch.int8).reshape(L, 16, 8)),
                "weight_scale": torch.arange(L * 8, dtype=torch.float32).reshape(L, 8)},
    }
    per = L // mesh.shape["pp"]
    p = mesh.coords()["pp"]

    def mine(v):
        return k_major(v[p * per:(p + 1) * per]) if v.dim() == 3 and v.dtype == torch.int8 else \
            v[p * per:(p + 1) * per].clone()

    local = {k: {kk: mine(vv) for kk, vv in v.items()} if isinstance(v, dict) else mine(v) for k, v in full.items()}
    flat = dict(tree_leaves(full))
    ok = []
    for i in range(L):
        got = dict(tree_leaves(M.pp_gather_layer(local, i, L, mesh).wait()))
        ok.append(all(got[k].dtype == v.dtype and torch.equal(got[k], v[i]) for k, v in flat.items())
                  and got["wq"].transpose(0, 1).is_contiguous() and got["lin/weight_q"].transpose(0, 1).is_contiguous())
    # an edge layer of a tree with blocks_edge: its quantized linear's leaves stay home, as None
    for i in (0, L - 1):
        got = dict(tree_leaves(M.pp_gather_layer(local, i, L, mesh, edge=True).wait()))
        ok.append(got["lin/weight_q"] is None and got["lin/weight_scale"] is None
                  and all(torch.equal(got[k], flat[k][i]) for k in ("w", "q", "wq")))
    return ok


def _tile(c):
    from magi_tpu_torch.models.vae.model import VaeConfig, ViTVAE, init_vae_params
    from magi_tpu_torch.parallel import mesh as M
    from magi_tpu_torch.parallel.tile import pmap_tile_batch
    from magi_tpu_torch.pipeline.video_process import tiled_decode, tiled_encode

    seen = []

    def fn(b):
        seen.append(b.shape[0])
        return b * 2 + 1

    batch = torch.arange(3 * 6, dtype=torch.float32).reshape(3, 6)
    cfg = VaeConfig(video_size=32, video_length=8, patch_size=8, patch_length=4, embed_dim=64, depth=1, num_heads=4,
                    qkv_bias=True, use_final_proj=True)
    vae = ViTVAE(cfg, init_vae_params(cfg, seed=0, device="cpu"))
    x = torch.from_numpy(c["video"])
    M.destroy_mesh()
    z_ref = tiled_encode(vae, x, tile_frames=8)
    y_ref = tiled_decode(vae, z_ref, tile_frames=8)
    _mesh(c["mesh"])
    out = pmap_tile_batch(fn, batch)
    z = tiled_encode(vae, x, tile_frames=8)
    y = tiled_decode(vae, z, tile_frames=8)
    return {"pmap_equal": torch.equal(out, batch * 2 + 1), "seen": seen,
            "z_err": float((z - z_ref).abs().max()), "y_err": float((y - y_ref).abs().max())}


def _graph_walk(c):
    """The case walked eagerly, then captured through the stand-in twice
    (the second walk takes the first's workspace: no capture), each walk's
    chunks and the pieces it captured; with "trap", the all-to-all's
    fresh-buffer walks: the strict stand-in's error, and the loose one's
    chunks."""
    from magi_tpu_torch.core import graphs as G
    from magi_tpu_torch.parallel import comm
    from magi_tpu_torch.parallel import mesh as M

    walk = {"walk": _walk, "dp_walk": _dp_walk}[c["walk"]]
    mesh = _mesh(c["mesh"])
    params = M.shard_dit_params(c["params"], mesh)

    def chunks(out):
        return out["chunks"] if c["walk"] == "walk" else out

    out = {"eager": chunks(walk(c, params, capture=False))}
    G.CPU_STAND_IN = True
    try:
        for name in ("captured", "again"):
            before = G.captures("walk")
            out[name] = chunks(walk(c, params))
            out[name + "_pieces"] = G.captures("walk") - before
        if c.get("trap"):
            G.release_workspaces()
            plain = comm.all_to_all
            comm.all_to_all = lambda x, group, ins, outs, out=None: plain(x, group, ins, outs)
            try:
                try:
                    walk(c, params)
                    out["trap_error"] = None
                except RuntimeError as e:
                    out["trap_error"] = str(e)
                G.release_workspaces()
                G.StandIn.strict = False
                out["trap_chunks"] = chunks(walk(c, params))
            finally:
                comm.all_to_all = plain
                G.StandIn.strict = True
    finally:
        G.CPU_STAND_IN = False
        G.release_workspaces()
    return out


def _card_walk(c):
    """The config `c["config"]` (a dict) drawn from seed 0 on cuda:0 as the
    rank's shards (`quant_bits` 0 or 8) and walked eagerly, captured and
    captured again: each walk's chunks (on the CPU), its launches of every
    kernel and the step graphs it captured."""
    from magi_tpu_torch.core import graphs as G
    from magi_tpu_torch.core.config import MagiConfig
    from magi_tpu_torch.models.dit.model import init_dit_params
    from magi_tpu_torch.parallel import mesh as M
    from magi_tpu_torch.sampling.transport import ArdfSampler, InferenceInput

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = _mesh(c["mesh"], dev)
    cfg = MagiConfig.from_dict(c["config"])
    mc = cfg.model_config
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_dit_params(cfg, dev, g, sink=M.ShardSink(mesh, mc.gated_linear_unit, c.get("quant_bits", 0)))
    L, n = mc.caption_max_length, 3
    inp = InferenceInput(caption_embs=torch.randn((n, L, mc.caption_channels), generator=g, device=dev),
                         caption_lens=[9, 20, 5], null_emb=torch.randn((L, mc.caption_channels), generator=g,
                                                                       device=dev),
                         null_len=5, latent_size=(mc.in_channels, 2 * n, 16, 16), num_steps=8, chunk_num=n,
                         has_text=True)
    noise = torch.randn(inp.latent_size, generator=g, device=dev)
    out = {}
    for name, capture in (("eager", False), ("captured", True), ("again", True)):
        launches, graphs = G.launch_counts(), G.captures("walk")
        chunks = [ch.cpu() for _, ch in ArdfSampler(cfg, params, inp, noise=noise, device=dev,
                                                    capture=capture).walk()]
        torch.cuda.synchronize()
        out[name] = dict(chunks=chunks, launches=[a - b for a, b in zip(G.launch_counts(), launches)],
                         graphs=G.captures("walk") - graphs)
    G.release_workspaces()
    return out


KINDS = {"walk": _walk, "dp_walk": _dp_walk, "pp_gather": _pp_gather, "tile": _tile, "graph_walk": _graph_walk,
         "card_walk": _card_walk}


def main(path: str) -> int:
    import torch.distributed as dist

    from magi_tpu_torch.parallel import mesh as M

    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    cases = torch.load(path, weights_only=False)
    out = {}
    for name, c in cases.items():
        out[name] = KINDS[c["kind"]](c)
        M.destroy_mesh()
    torch.save(out, f"{path}.rank{dist.get_rank()}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
