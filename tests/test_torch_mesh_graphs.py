"""Captured steps on a model-parallel mesh, on the CPU.

A step on a cp, tp or pp mesh runs in pieces cut at every collective
(`models.dit.model`'s mesh path): each collective runs between two
pieces, never inside one, and writes into a slot the next piece reads at
a fixed address.  The card captures each piece in a CUDA graph; here
`core.graphs.StandIn` stands in for the capture: it records each piece's
function and arguments, and a replay calls the function on the recorded
arguments, as a graph reads the addresses it baked.

* A collective inside a piece raises, eager or recorded.
* The stand-in itself: a piece handed a new buffer at each call computes
  on the recorded one, and the strict stand-in raises there; a slot is
  the same buffer at every replay.

The mesh walks through the stand-in (cp2 x tp2, pp2 x cp2, the int8
pp2 x tp2 and dp2 x cp2, bit-equal to the eager walks, and the trap of a
collective handing its pieces a new buffer) run in the gloo world of
`tests/test_torch_parallel.py`, beside the JAX walks they are held to."""

import pytest
import torch

from magi_tpu.parallel import mesh as JM
from magi_tpu_torch.core import graphs as G
from magi_tpu_torch.parallel import comm
from magi_tpu_torch.parallel import mesh as M
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _clean():
    yield
    G.CPU_STAND_IN = False
    G.release_workspaces()
    JM.destroy_mesh()
    M.destroy_mesh()


def _group(n=2):
    return M.Group(tuple(range(n)), None, "gloo", torch.device("cpu"))


@pytest.mark.parametrize("op", ["all_to_all", "all_gather", "all_reduce", "broadcast"])
def test_collective_inside_a_piece_raises(op):
    """Every collective refuses to run inside a piece (eager `PLAIN` and a
    recording `StandIn` alike), before it touches its group."""
    x = torch.ones(4)
    calls = {"all_to_all": lambda: comm.all_to_all(x, _group(), [2, 2], [2, 2]),
             "all_gather": lambda: comm.all_gather(x, _group()),
             "all_reduce": lambda: comm.all_reduce(x, _group(), "max"),
             "broadcast": lambda: comm.broadcast_many([x], 0, _group())}
    with pytest.raises(RuntimeError, match=f"comm.{op} inside a piece"):
        G.PLAIN.piece("p", calls[op])
    assert not G.in_piece()
    step = G.StandIn("a step", lambda run: run.piece("p", calls[op]), torch.device("cpu"),
                     G.Arena(torch.device("cpu")), warm_key=("collective inside", op))
    with pytest.raises(RuntimeError, match=f"comm.{op} inside a piece"):
        step()
    # between pieces it runs (a group of one rank moves nothing)
    assert comm.all_reduce(x, _group(1)) is x


@pytest.mark.parametrize("fresh,strict", [(False, True), (True, True), (True, False)])
def test_stand_in_replays_what_it_recorded(fresh, strict):
    """A slot is the same buffer at every replay, and a piece reads it
    there; a buffer made anew at each call is not what a replay reads: the
    strict stand-in raises, the loose one computes on the recorded one."""
    dev = torch.device("cpu")
    state = {"v": 1.0}

    def body(run):
        x = torch.full((3,), state["v"]) if fresh else run.slot("in", (3,), torch.float32, dev)
        if not fresh:
            x.fill_(state["v"])  # what a collective writes between pieces
        return run.piece("double", lambda t: t * 2, x)

    G.StandIn.strict = strict
    try:
        step = G.StandIn("a step", body, dev, G.Arena(dev), warm_key=("stand-in", fresh, strict))
        assert torch.equal(step(), torch.full((3,), 2.0))  # the warm-up's eager result
        state["v"] = 5.0
        if not fresh:
            assert torch.equal(step(), torch.full((3,), 10.0))
            assert step.graphs == 1
            assert step._slots[0].data_ptr() == step.arena.slot("in", (3,), torch.float32).data_ptr()
        elif strict:
            with pytest.raises(RuntimeError, match="piece double was handed other arguments"):
                step()
        else:
            assert torch.equal(step(), torch.full((3,), 2.0))  # the stale buffer's value
    finally:
        G.StandIn.strict = True
