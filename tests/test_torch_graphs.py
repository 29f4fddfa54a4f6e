"""The port's counterpart of the JAX package's jitted steps, on the CPU:
the config key of a captured step (`_config_key`), the step variants a
walk builds against the JAX package's compiled ones, replay semantics
(a step callable built at a variant's first step, run again on refilled
`StepInputs`, is bit-equal to a fresh eager step: no host value of a step
is baked into it) and the in-place roll of the sliding cache window.

On the CPU nothing is captured: a walk builds one step callable per
variant and calls it at every step of that variant, as the card replays
its CUDA graph; `capture=False` builds a fresh step each time (the eager
yardstick).  `tests/test_torch_cuda.py` holds the captured walks on the
card against the eager ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_tpu.models.dit.model import init_dit_params
from magi_tpu.sampling.batched import DpBatchedSampler as JaxBatched
from magi_tpu.sampling.transport import ArdfSampler as JaxSampler
from magi_tpu.sampling.transport import InferenceInput as JaxInput
from magi_tpu_torch.checkpoint.from_jax import dit_params_from_jax
from magi_tpu_torch.sampling import transport as T
from magi_tpu_torch.sampling.batched import DpBatchedSampler
from tests.test_torch_dit import torch_config
from tests.tiny import tiny_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

H = W = 8

# (config overrides, chunks, prefix latent frames, requests)
WALKS = {
    "base": ({}, 3, 0, 1),
    "packed": ({"engine": {"pack_uncond": True}}, 3, 0, 1),
    # single-branch: the nearly-clean ride-along chunk on some steps
    "distill": ({"runtime": {"cfg_number": 1}, "engine": {"distill": True}}, 3, 0, 1),
    "i2v_prefix": ({}, 3, 1, 1),
    # a prefix over a chunk and a half: the warm-up forward and pasted frames
    "v2v_prefix": ({"runtime": {"noise2clean_kvrange": [2, 1], "clean_chunk_kvrange": 1}}, 4, 3, 1),
    "lockstep": ({}, 3, 0, 2),
}


def _setup(case):
    overrides, chunks, prefix_frames, R = WALKS[case]
    cfg = tiny_config(**overrides)
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(3)
    L = mc.caption_max_length
    latent = (mc.in_channels, chunks * rc.chunk_width, H, W)
    reqs = []
    for r in range(R):
        reqs.append(dict(cap=rng.normal(size=(chunks, L, mc.caption_channels)).astype(np.float32),
                         lens=np.array([5 + r, L // 2, 3, 9][:chunks], np.int32),
                         noise=rng.normal(size=latent).astype(np.float32),
                         prefix=rng.normal(size=(mc.in_channels, prefix_frames, H, W)).astype(np.float32)
                         if prefix_frames else None))
    null = rng.normal(size=(L, mc.caption_channels)).astype(np.float32)
    return cfg, latent, chunks, reqs, null


def _jax_variants(case) -> list:
    """The JAX package's step variants of the walk from its host-only plan
    (no compile): its jitted steps' static arguments, after the prefix
    warm-up's when the prefix covers a chunk."""
    cfg, latent, chunks, reqs, null = _setup(case)
    rc, ec = cfg.runtime_config, cfg.engine_config
    inps = [JaxInput(caption_embs=jnp.asarray(q["cap"]), caption_lens=q["lens"], null_emb=jnp.asarray(null),
                     null_len=6, latent_size=latent, num_steps=rc.num_steps, chunk_num=chunks, has_text=True,
                     prefix_video=None if q["prefix"] is None else jnp.asarray(q["prefix"])) for q in reqs]
    keys = [jax.random.PRNGKey(r) for r in range(len(inps))]
    s = JaxBatched(cfg, None, inps, keys) if len(inps) > 1 else JaxSampler(cfg, None, inps[0], keys[0])
    out = [("warmup", s.chunk_offset)] if s.chunk_offset > 0 else []
    for step in range(s.total_forward_steps()):
        p = s._plan(step)
        if rc.cfg_number == 3:
            v = ("cfg3", p["n_den"], p["extra"], p["use_prefix"], bool(ec.pack_uncond))
        else:
            v = ("cfg1", p["n_den"], p["extra"], p["use_prefix"], p["distill_nearly"])
        if v not in out:
            out.append(v)
    return out


def _port_sampler(case, capture=True):
    cfg, latent, chunks, reqs, null = _setup(case)
    params = dit_params_from_jax(jax.tree.map(np.asarray, init_dit_params(jax.random.PRNGKey(0), cfg)))
    inps = [T.InferenceInput(caption_embs=torch.from_numpy(q["cap"]), caption_lens=q["lens"],
                             null_emb=torch.from_numpy(null), null_len=6, latent_size=latent,
                             num_steps=cfg.runtime_config.num_steps, chunk_num=chunks, has_text=True,
                             prefix_video=None if q["prefix"] is None else torch.from_numpy(q["prefix"]))
            for q in reqs]
    noises = [torch.from_numpy(q["noise"]) for q in reqs]
    if len(inps) > 1:
        return DpBatchedSampler(torch_config(cfg), params, inps, noises=noises, device="cpu", capture=capture)
    return T.ArdfSampler(torch_config(cfg), params, inps[0], noise=noises[0], device="cpu", capture=capture)


@pytest.mark.parametrize("name,default", T.STEP_ENV)
def test_config_key_follows_content_and_step_env(name, default, monkeypatch):
    """Equal-content configs share a key; another config, or flipping any
    environment variable a step reads, gives another (no stale graph is
    replayed)."""
    monkeypatch.delenv(name, raising=False)
    a, b = torch_config(tiny_config()), torch_config(tiny_config())
    unset = T._config_key(a)
    assert a is not b and T._config_key(b) == unset
    assert T._config_key(torch_config(tiny_config(engine={"pack_uncond": True}))) != unset
    monkeypatch.setenv(name, default)
    assert T._config_key(a) == unset
    monkeypatch.setenv(name, "sage" if default == "qk8" else "1" if default == "0" else "0")
    assert T._config_key(a) == T._config_key(b) != unset


@pytest.mark.parametrize("case", sorted(WALKS))
def test_step_variants_match_the_jax_compiled_ones(case):
    """The walk builds one step per variant the JAX package compiles, and
    `warm_step_variants` builds them all before the first step."""
    s = _port_sampler(case)
    want = _jax_variants(case)
    assert s.step_variants() == want
    assert s.warm_step_variants() == len(want) and len(s._steps) == len(want)
    if case == "distill":
        assert {v[4] for v in want} == {True, False}  # steps with and without the ride-along
    if case == "v2v_prefix":
        assert want[0] == ("warmup", 1)
    assert T.ArdfSampler.warm_step_variants(_port_sampler(case, capture=False)) == 0


@pytest.mark.parametrize("case", sorted(WALKS))
def test_step_callables_replay_refilled_inputs(case):
    """A step callable built at its variant's first step and called again
    for later steps of the variant (its `StepInputs` refilled) leaves the
    latents and the cache bit-equal to fresh eager steps, step by step."""
    a, b = _port_sampler(case), _port_sampler(case, capture=False)
    a.prepare()
    b.prepare()
    seen = {}
    for step in range(a.total_forward_steps()):
        v = a._variant(a._plan(step))
        built = dict(a._steps)
        ea, eb = a.do_step(step), b.do_step(step)
        if v in seen:
            # the callable of the variant's first step ran again, not a new one
            assert dict(a._steps) == built
        seen.setdefault(v, step)
        assert torch.equal(a.xs, b.xs), f"step {step} ({v}): latents differ"
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a.cache), _leaves(b.cache))), f"step {step}: cache"
        assert (ea is None) == (eb is None) and (ea is None or torch.equal(ea[1], eb[1]))
    assert len(a._steps) == len(a.step_variants()) < a.total_forward_steps()
    assert not b._steps


def _leaves(cache):
    return list(cache.values()) if isinstance(cache, dict) else [cache]


@pytest.mark.parametrize("shape,axis,shift", [((2, 2, 3, 12, 4), 3, 5), ((2, 2, 3, 12, 4), 3, 3),
                                              ((2, 2, 3, 12), 3, 7), ((2, 2, 2, 3, 10, 4), 4, 4),
                                              ((1, 1, 1, 9, 2), 3, 4)])
def test_roll_in_place_keeps_storage_and_matches_torch_roll(shape, axis, shift):
    """The sliding window's roll moves the tokens within the cache's own
    storage (captured steps keep their pointers), with torch.roll's values."""
    t = torch.randn(shape)
    want = torch.roll(t, -shift, dims=axis)
    ptr = t.data_ptr()
    assert T._roll_left(t, shift, axis) is t and t.data_ptr() == ptr
    assert torch.equal(t, want)


def test_sliding_window_walk_rolls_in_place():
    """A walk whose cache window slides keeps one cache storage."""
    cfg = tiny_config(runtime={"noise2clean_kvrange": [1, 1], "clean_chunk_kvrange": 1},
                      engine={"kv_offload": True})
    mc, rc = cfg.model_config, cfg.runtime_config
    rng = np.random.default_rng(0)
    L, n = mc.caption_max_length, 5
    params = dit_params_from_jax(jax.tree.map(np.asarray, init_dit_params(jax.random.PRNGKey(0), cfg)))
    inp = T.InferenceInput(caption_embs=torch.from_numpy(rng.normal(size=(n, L, mc.caption_channels)).astype(
        np.float32)), caption_lens=np.full(n, 7, np.int32), null_emb=torch.zeros(L, mc.caption_channels), null_len=4,
        latent_size=(mc.in_channels, n * rc.chunk_width, H, W), num_steps=rc.num_steps, chunk_num=n, has_text=True)
    s = T.ArdfSampler(torch_config(cfg), params, inp, noise=torch.zeros(inp.latent_size), device="cpu")
    ptr = s.cache.data_ptr()
    assert len(list(s.walk())) == n
    assert s.cache_base > 0 and s.cache.data_ptr() == ptr


def test_step_inputs_stage_one_copy():
    """`StepInputs.stage` fills the fields' leading entries (y_lens a row
    per request) and leaves the rest as they were."""
    si = T.StepInputs(4, 2, torch.device("cpu"))
    si.stage(sp=3, cache_sp=1, kv_start=[1, 2], kv_end=np.array([5, 6, 7]), y_lens=np.array([[1, 2], [3, 4]]),
             tvec=[0.5], pcs=0.7)
    assert int(si.sp) == 3 and int(si.cache_sp) == 1
    assert si.kv_start.tolist() == [1, 2, 0, 0] and si.kv_end.tolist() == [5, 6, 7, 0]
    assert si.y_lens.tolist() == [[1, 2, 0, 0], [3, 4, 0, 0]]
    assert si.tvec[0].item() == 0.5 and si.pcs.item() == np.float32(0.7)
    si.stage(kv_start=[9])
    assert si.kv_start.tolist() == [9, 2, 0, 0] and int(si.sp) == 3


# ---------------------------------------------------------------------------
# workspaces: a walk's buffers and step callables, kept for the next walk
# ---------------------------------------------------------------------------

from magi_tpu_torch.core import graphs as G  # noqa: E402

WS_WALKS = {
    "base": ({}, 3, 0, 1),
    "distill": ({"runtime": {"cfg_number": 1}, "engine": {"distill": True}}, 3, 0, 1),
    "v2v_prefix": ({"runtime": {"noise2clean_kvrange": [2, 1], "clean_chunk_kvrange": 1}}, 4, 3, 1),
    "streamed": ({"engine": {"kv_offload": True}}, 3, 0, 1),
    "lockstep": ({}, 3, 0, 2),
}


@pytest.fixture()
def empty_pool():
    G.release_workspaces()
    yield
    G.release_workspaces()


def _ws_setup(case):
    overrides, chunks, prefix_frames, R = WS_WALKS[case]
    cfg = tiny_config(**overrides)
    params = dit_params_from_jax(jax.tree.map(np.asarray, init_dit_params(jax.random.PRNGKey(0), cfg)))
    return torch_config(cfg), params, chunks, prefix_frames, R


def _ws_sampler(setup, seed, R=None):
    """A sampler of the walk `setup` on request(s) drawn from `seed`."""
    tcfg, params, chunks, prefix_frames, R0 = setup
    R = R0 if R is None else R
    mc, rc = tcfg.model_config, tcfg.runtime_config
    rng = np.random.default_rng(seed)
    L = mc.caption_max_length
    latent = (mc.in_channels, chunks * rc.chunk_width, H, W)
    null = torch.from_numpy(np.random.default_rng(0).normal(size=(L, mc.caption_channels)).astype(np.float32))
    inps, noises = [], []
    for r in range(R):
        pv = rng.normal(size=(mc.in_channels, prefix_frames, H, W)).astype(np.float32) if prefix_frames else None
        inps.append(T.InferenceInput(
            caption_embs=torch.from_numpy(rng.normal(size=(chunks, L, mc.caption_channels)).astype(np.float32)),
            caption_lens=np.array([5 + r, L // 2, 3, 9][:chunks], np.int32), null_emb=null, null_len=6,
            latent_size=latent, num_steps=rc.num_steps, chunk_num=chunks, has_text=bool(r % 2 == 0),
            prefix_video=None if pv is None else torch.from_numpy(pv)))
        noises.append(torch.from_numpy(rng.normal(size=latent).astype(np.float32)))
    if R > 1:
        return DpBatchedSampler(tcfg, params, inps, noises=noises, device="cpu")
    return T.ArdfSampler(tcfg, params, inps[0], noise=noises[0], device="cpu")


def _chunks(sampler):
    return [c.clone() for _, c in sampler.walk()]


@pytest.mark.parametrize("case", sorted(WS_WALKS))
def test_adopted_workspace_walks_equal_fresh_walks(case, empty_pool):
    """A second sampler of an equal key takes the first one's workspace
    (its buffers and step callables: nothing built), and its walk equals a
    walk on a fresh workspace, bit for bit; so does a third walk of the
    first request after another request's (nothing carries over)."""
    setup = _ws_setup(case)
    a = _ws_sampler(setup, 1)
    built = dict(a._steps)
    first = _chunks(a)
    assert built == {} and len(a._steps) == len(a.step_variants()) and G.WORKSPACES.idle(a._ws.key) == 1
    b = _ws_sampler(setup, 2)
    assert b._ws is a._ws and b.xs is a.xs and G.WORKSPACES.idle() == 0
    steps = dict(b._steps)
    second = _chunks(b)
    assert b._steps == steps  # the callables of the first walk ran, no new one
    c = _ws_sampler(setup, 1)
    assert c._ws is a._ws
    again = _chunks(c)
    G.release_workspaces()
    fresh = _ws_sampler(setup, 2)
    assert fresh._ws is not a._ws and not fresh._steps
    fresh_second = _chunks(fresh)
    assert len(first) == len(again) == len(second) > 0
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert all(torch.equal(x, y) for x, y in zip(second, fresh_second))
    assert not all(torch.equal(x, y) for x, y in zip(first, second))


def test_concurrent_samplers_get_different_workspaces(empty_pool):
    """Samplers alive at once never share a workspace; `walk_many` walks
    each request on its own and leaves both workspaces for the next
    round, which takes them and walks equally."""
    setup = _ws_setup("base")
    a, b = _ws_sampler(setup, 1), _ws_sampler(setup, 2)
    assert a._ws is not b._ws and a._ws.key == b._ws.key and a.xs.data_ptr() != b.xs.data_ptr()
    rounds = []
    for _ in range(2):
        outs = [[], []]
        for r, _, chunk in T.walk_many([a, b]):
            outs[r].append(chunk)
        rounds.append((outs, {id(a._ws), id(b._ws)}))
        assert G.WORKSPACES.idle(a._ws.key) == 2
        a, b = _ws_sampler(setup, 1), _ws_sampler(setup, 2)
    assert rounds[0][1] == rounds[1][1] == {id(a._ws), id(b._ws)}
    for r in range(2):
        assert all(torch.equal(x, y) for x, y in zip(rounds[0][0][r], rounds[1][0][r]))


def test_workspace_keys_and_release(empty_pool):
    """A sampler gives its workspace back when its walk ends or when it is
    collected; another key, another parameter tree or another request
    count takes a workspace of its own; a new key frees the idle
    workspaces of the others; `release_workspaces()` empties the pool, and
    a workspace leased before it is not taken back after."""
    import gc

    setup = _ws_setup("base")
    a = _ws_sampler(setup, 1)
    key = a._ws.key
    assert G.WORKSPACES.idle() == 0
    del a
    gc.collect()
    assert G.WORKSPACES.idle(key) == 1  # given back by its finalizer
    other_tree = (setup[0], dit_params_from_jax(jax.tree.map(np.asarray, init_dit_params(
        jax.random.PRNGKey(0), tiny_config()))),) + setup[2:]
    b = _ws_sampler(other_tree, 1)
    assert b._ws.key != key and G.WORKSPACES.idle(key) == 0  # the new key freed the other key's idle one
    _chunks(b)
    c = _ws_sampler(setup, 1, R=2)
    assert c._ws.key[2] == 2 and G.WORKSPACES.idle() == 0
    _chunks(c)
    assert G.WORKSPACES.idle(c._ws.key) == 1
    d = _ws_sampler(setup, 1, R=2)
    assert d._ws is c._ws
    G.release_workspaces()
    assert G.WORKSPACES.idle() == 0
    _chunks(d)  # its walk ends after the release: the workspace is not taken back
    assert G.WORKSPACES.idle() == 0 and _ws_sampler(setup, 1, R=2)._ws is not c._ws


def test_walk_warms_every_variant_before_capturing_any(monkeypatch, empty_pool):
    """A variant's first graph in the process runs its step once eagerly,
    then is captured.  `warm_step_variants` runs every variant's warm-up,
    hands the allocator's cached blocks back once (`release_cached`), then
    captures every variant: the captures reuse the memory the warm-ups
    freed, where warming and capturing each in turn held a warm-up's
    memory beside the captures' pool (the released 24B base step at
    576x1024 ran out of memory capturing after its warm-up fit).  Through
    the CPU stand-in: the JAX package's variants in that order, and the
    walk bit-equal to the eager one."""
    monkeypatch.setattr(G, "CPU_STAND_IN", True)
    # the resident step's piece is handed the host's cache slot, which only
    # the streamed step's copies read: the loose stand-in replays it
    monkeypatch.setattr(G.StandIn, "strict", False)
    monkeypatch.setattr(G, "_warmed", set())
    log = []
    real_warm, real_capture = G.StepGraph._warm, G.StepGraph._capture

    def warm(self, args):
        out = real_warm(self, args)
        if out[1]:
            log.append(("warm", self.name))
        return out

    def capture(self, *args):
        log.append(("capture", self.name))
        return real_capture(self, *args)

    monkeypatch.setattr(G.StepGraph, "_warm", warm)
    monkeypatch.setattr(G.StepGraph, "_capture", capture)
    monkeypatch.setattr(G, "release_cached", lambda device: log.append(("release", str(device))))
    a, b = _port_sampler("distill"), _port_sampler("distill", capture=False)
    n = a.warm_step_variants()
    assert n == len(_jax_variants("distill"))
    names = [name for _, name in log[:n]]
    assert log == [("warm", x) for x in names] + [("release", "cpu")] + [("capture", x) for x in names]
    got, want = [c for _, c in a.walk()], [c for _, c in b.walk()]
    assert len(got) == len(want) == 3 and all(torch.equal(x, y) for x, y in zip(got, want))
    assert len(log) == 2 * n + 1  # the walk captured nothing more
