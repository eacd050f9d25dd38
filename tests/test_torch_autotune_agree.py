"""One launch plan a key across the ranks of a process group, where the
caller asks for it (``kernels/autotune.py``, ``agreeing``): gloo ranks
under a faked card, each with its own memo and persistent file seeded to
answer apart, hold rank 0's plan for every key asked for inside the
block afterwards, whether rank 0 had it in its memo, swept it, or rank 1
had it in its file; only rank 0 sweeps; the digests of the agreed keys
are equal; a key asked for after the block takes no collective; a rank
asking for another key than rank 0 raises; a rank outside the block's
group (an elastic run's rank left out of its mesh) takes its own plans
while the group agrees, and nobody waits.  The reference has no process
group: nothing to hold it against.
"""

import json

import pytest

import _torch_autotune_agree_worker as agree
import _torch_dist_worker as worker
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels import autotune

TIMEOUT_S = 120


def _run(tmp_path, case, n=2):
    prefix = str(tmp_path / "rank")
    procs = worker.launch_ranks(
        n, ["tests/_torch_autotune_agree_worker.py", prefix, case])
    try:
        for p in procs:
            assert p.wait(timeout=TIMEOUT_S) == 0
    finally:
        for p in procs:
            p.kill()
    return [json.loads(open(f"{prefix}{r}.json").read()) for r in range(n)]


def _rank_0s(name):
    d, dims, pm = agree.KEYS[name]
    return autotune._plan_to_json(
        agree._pick(d, dims, pm, 0) if name == "seeded"
        else autotune.candidates(d, *dims, permute=pm)[-1])


def test_every_rank_takes_rank_0s_plan(tmp_path):
    r0, r1 = _run(tmp_path, "agree")
    assert "error" not in r0 and "error" not in r1
    assert r0["plans"] == r1["plans"]
    # what rank 0 resolved: its seeded memo entry and its (stubbed) sweeps
    for name in agree.KEYS:
        assert r1["plans"][name] == _rank_0s(name), name
    # rank 1's seeded memo entry and its file entry were not used
    d, dims, pm = agree.KEYS["filed"]
    assert r1["plans"]["filed"] != autotune._plan_to_json(
        agree._pick(d, dims, pm, 0))
    assert r0["swept"] == ["cascade_bwd", "fwd"]
    assert r0["digest"] == r1["digest"]
    # rank 1 swept only after the block, alone, with no collective
    assert r1["swept"] == ["cascade"] and "alone" not in r0


def test_a_rank_asking_for_another_key_raises(tmp_path):
    r0, r1 = _run(tmp_path, "apart")
    assert "error" not in r0
    assert "asks for" in r1["error"] and "agreeing()" in r1["error"]


def test_a_rank_outside_the_group_takes_its_own_plans(tmp_path):
    r0, r1, r2 = _run(tmp_path, "outside", n=3)
    assert not any("error" in r for r in (r0, r1, r2))
    assert r0["plans"] == r1["plans"]
    assert r1["plans"] == {name: _rank_0s(name) for name in agree.KEYS}
    assert r0["digest"] == r1["digest"]
    # rank 2 kept its own seeded plan and swept its own key, alone
    d, dims, pm = agree.KEYS["seeded"]
    assert r2["plans"]["seeded"] == autotune._plan_to_json(
        agree._pick(d, dims, pm, 2))
    assert r2["swept"] == ["cascade"] and r1["swept"] == []


@pytest.mark.parametrize("world", [None, 1])
def test_no_group_or_one_rank_takes_no_collective(monkeypatch, world):
    """Outside a block, without a group, or in a group of one, no
    broadcast is attempted."""
    monkeypatch.setattr(autotune.dist, "is_initialized",
                        lambda: world is not None)
    monkeypatch.setattr(autotune.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(autotune.dist, "get_backend", lambda: "gloo")
    assert autotune._agreeing() is None
    with autotune.agreeing():
        assert autotune._agreeing() is None
    if world is not None:
        monkeypatch.setattr(autotune.dist, "get_world_size", lambda: 2)
        assert autotune._agreeing() is None
        with autotune.agreeing():
            assert autotune._agreeing() == (0, 1)
