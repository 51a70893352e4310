"""The port's rollout data plane against the JAX package's ``rollout/``.

Every case of ``tests/test_rollout_buffer.py`` runs here through both
packages (``pkg`` = "jax" or "port"): the buffer's FIFO order, watermarks,
backpressure and close, staleness eviction, drop accounting and
``state_dict`` round trip; version tags and their bounds, the turn-aware
bounds; the admission policy's modes and histogram; the service's
production, error, pause and stop. Then the same inputs through both
packages side by side, results equal: seeded random operation sequences
over the buffer (stats and queue after every operation), version tags,
round/trajectory conversions, admission over random groups, the telemetry
snapshots those produce, ``RetryPolicy``'s delays, and the rollout sidecar
of ``checkpoint.py`` (written by one package, read by the other's loader).
Last, the port's adapter ring (``rollout/adapter_ring.py``): holds, swaps,
the self-drafter's previous adapter and the blocking push.
"""

import pickle
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distrl_llm_tpu import checkpoint as jcheckpoint
from distrl_llm_tpu import rollout as jrollout
from distrl_llm_tpu import telemetry as jtelemetry
from distrl_llm_tpu.distributed.resilience import RetryPolicy as JRetryPolicy
from distrl_llm_tpu.rollout.buffer import BufferClosed as JBufferClosed
from distrl_llm_tpu_torch import checkpoint as tcheckpoint
from distrl_llm_tpu_torch import rollout as trollout
from distrl_llm_tpu_torch import telemetry as ttelemetry
from distrl_llm_tpu_torch.distributed.resilience import RetryPolicy as TRetryPolicy
from distrl_llm_tpu_torch.engine.engine import LoraMailbox
from distrl_llm_tpu_torch.ops import launch_count
from distrl_llm_tpu_torch.ops import sampling as tsampling
from distrl_llm_tpu_torch.rollout.adapter_ring import AdapterRing
from distrl_llm_tpu_torch.rollout.buffer import BufferClosed as TBufferClosed

PKGS = {
    "jax": SimpleNamespace(r=jrollout, telemetry=jtelemetry, BufferClosed=JBufferClosed),
    "port": SimpleNamespace(r=trollout, telemetry=ttelemetry, BufferClosed=TBufferClosed),
}


@pytest.fixture(autouse=True)
def clean_telemetry():
    for t in (jtelemetry, ttelemetry):
        t.reset()
    jtelemetry.configure(enabled=False)
    yield
    for t in (jtelemetry, ttelemetry):
        t.reset()
    jtelemetry.configure(enabled=False)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def traj(r, i: int, version: int = 0, n: int = 2, t: int = 4):
    return r.Trajectory(
        problem=f"p{i}", solution=f"s{i}", answers=[f"a{j}" for j in range(n)],
        token_lengths=[t] * n, tokens=np.full((n, t), i, np.int32),
        lengths=np.full((n,), t, np.int32),
        behavior_logps=np.full((n, t), -1.0, np.float32),
        version_tags=np.full((n, t), version, np.int32),
        produced_version=version, batch_index=i)


# ------------------------------------------------------------------ buffer

def test_fifo_order(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    for i in range(5):
        buf.put(traj(pkg.r, i))
    assert [g.batch_index for g in buf.get_batch(5)] == [0, 1, 2, 3, 4]
    assert buf.total_put == 5 and buf.total_got == 5


def test_get_partial_after_close(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    buf.put(traj(pkg.r, 0))
    buf.close()
    assert [g.batch_index for g in buf.get_batch(4)] == [0]
    assert buf.get_batch(4) == []
    with pytest.raises(pkg.BufferClosed):
        buf.put(traj(pkg.r, 1))


def test_get_blocks_until_k_available(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    buf.put(traj(pkg.r, 0))
    got: list = []
    th = threading.Thread(target=lambda: got.extend(buf.get_batch(2)))
    th.start()
    time.sleep(0.05)
    assert not got
    buf.put(traj(pkg.r, 1))
    th.join(timeout=5)
    assert [g.batch_index for g in got] == [0, 1]


def test_timeout_returns_partial(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    buf.put(traj(pkg.r, 0))
    assert len(buf.get_batch(3, timeout=0.05)) == 1


@pytest.mark.parametrize("kw", [dict(capacity=0), dict(capacity=4, high_watermark=5),
                                dict(capacity=4, high_watermark=2, low_watermark=3)])
def test_invalid_construction(pkg, kw):
    with pytest.raises(ValueError):
        pkg.r.TrajectoryBuffer(**kw)


def test_put_blocks_at_high_until_low(pkg):
    buf = pkg.r.TrajectoryBuffer(4, high_watermark=4, low_watermark=2)
    for i in range(4):
        buf.put(traj(pkg.r, i))
    state = {"done": False}

    def produce():
        buf.put(traj(pkg.r, 4))
        state["done"] = True

    th = threading.Thread(target=produce)
    th.start()
    time.sleep(0.05)
    assert not state["done"] and buf.backpressure_waits == 1
    buf.get_batch(1)  # occupancy 3: hysteresis holds to low = 2
    time.sleep(0.05)
    assert not state["done"]
    buf.get_batch(1)
    th.join(timeout=5)
    assert state["done"] and len(buf) == 3


def test_nonblocking_put_drops_oldest_at_capacity(pkg):
    buf = pkg.r.TrajectoryBuffer(3)
    for i in range(3):
        buf.put(traj(pkg.r, i))
    buf.put(traj(pkg.r, 3), block=False)
    assert buf.dropped_capacity == 1
    assert [g.batch_index for g in buf.get_batch(3)] == [1, 2, 3]


def test_nonblocking_put_respects_low_high_watermark(pkg):
    buf = pkg.r.TrajectoryBuffer(10, high_watermark=4, low_watermark=2)
    for i in range(4):
        buf.put(traj(pkg.r, i), block=False)
    buf.put(traj(pkg.r, 4), block=False)
    assert len(buf) == 4 and buf.dropped_capacity == 1
    assert [g.batch_index for g in buf.get_batch(4)] == [1, 2, 3, 4]


def test_close_wakes_blocked_producer(pkg):
    buf = pkg.r.TrajectoryBuffer(2)
    buf.put(traj(pkg.r, 0))
    buf.put(traj(pkg.r, 1))
    err: list = []

    def produce():
        try:
            buf.put(traj(pkg.r, 2))
        except pkg.BufferClosed as e:
            err.append(e)

    th = threading.Thread(target=produce)
    th.start()
    time.sleep(0.05)
    buf.close()
    th.join(timeout=5)
    assert err


def test_occupancy_gauge_tracks_mutations(pkg):
    buf = pkg.r.TrajectoryBuffer(4)
    buf.put(traj(pkg.r, 0))
    assert pkg.telemetry.metrics_snapshot()["rollout/buffer_occupancy"] == 1.0
    buf.put(traj(pkg.r, 1))
    buf.get_batch(2)
    assert pkg.telemetry.metrics_snapshot()["rollout/buffer_occupancy"] == 0.0


def test_set_watermarks_regates_and_validates(pkg):
    buf = pkg.r.TrajectoryBuffer(6)
    for i in range(3):
        buf.put(traj(pkg.r, i))
    buf.set_watermarks(3)  # shrink below occupancy: gated now
    assert buf.stats()["high_watermark"] == 3 and buf.stats()["low_watermark"] == 1
    buf.put(traj(pkg.r, 3), block=False)  # gated: evicts to stay within 3
    assert len(buf) == 3 and buf.dropped_capacity == 1
    for kw in (dict(high=7), dict(high=3, low=4)):
        with pytest.raises(ValueError):
            buf.set_watermarks(**kw)


def test_evicts_only_beyond_bound_keeps_order(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    for i, v in enumerate([0, 1, 2, 3]):
        buf.put(traj(pkg.r, i, version=v))
    assert buf.evict_stale(learner_version=4, max_staleness=2) == 2
    assert buf.dropped_stale == 2
    assert [g.produced_version for g in buf.get_batch(2)] == [2, 3]


def test_eviction_opens_backpressure_gate(pkg):
    buf = pkg.r.TrajectoryBuffer(3, high_watermark=3, low_watermark=1)
    for i in range(3):
        buf.put(traj(pkg.r, i, version=0))
    state = {"done": False}

    def produce():
        buf.put(traj(pkg.r, 3, version=5))
        state["done"] = True

    th = threading.Thread(target=produce)
    th.start()
    time.sleep(0.05)
    assert not state["done"]
    buf.evict_stale(learner_version=5, max_staleness=2)
    th.join(timeout=5)
    assert state["done"]


def test_counter_telemetry(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    buf.put(traj(pkg.r, 0, version=0))
    buf.evict_stale(learner_version=9, max_staleness=1)
    assert pkg.telemetry.metrics_snapshot()["rollout/dropped_stale"] == 1.0


def test_nothing_vanishes_silently(pkg):
    buf = pkg.r.TrajectoryBuffer(6, high_watermark=6, low_watermark=3)
    rng = np.random.default_rng(0)
    put = 0
    for round_ in range(20):
        for _ in range(int(rng.integers(1, 4))):
            buf.put(traj(pkg.r, put, version=put), block=False)
            put += 1
        if round_ % 3 == 0:
            buf.evict_stale(put, max_staleness=2)
        buf.get_batch(int(rng.integers(1, 3)), timeout=0.01)
    s = buf.stats()
    assert s["total_put"] == put == (s["total_got"] + s["dropped_stale"]
                                     + s["dropped_capacity"] + s["occupancy"])


def test_state_dict_roundtrip(pkg):
    buf = pkg.r.TrajectoryBuffer(8)
    for i in range(3):
        buf.put(traj(pkg.r, i, version=i))
    buf.get_batch(1)
    buf2 = pkg.r.TrajectoryBuffer(8)
    buf2.load_state(buf.state_dict())
    assert len(buf2) == 2 and buf2.total_put == 3 and buf2.total_got == 1
    got = buf2.get_batch(2)
    assert [g.batch_index for g in got] == [1, 2]
    np.testing.assert_array_equal(got[0].tokens, traj(pkg.r, 1).tokens)
    buf2.close()
    with pytest.raises(pkg.BufferClosed):
        buf2.load_state(buf.state_dict())


# ------------------------------------------------------------ version tags

def test_tags_follow_swap_semantics(pkg):
    tags = pkg.r.version_tags_for_round(2, 8, 3, [(0, 4), (4, 6)])
    np.testing.assert_array_equal(tags[0], [3, 4, 4, 4, 4, 6, 6, 6])
    assert tags.shape == (2, 8)


def _tagged(r, tags, lengths):
    t = traj(r, 0, version=5)
    t.version_tags = np.asarray(tags, np.int32)
    t.lengths = np.asarray(lengths, np.int32)
    return t


def test_version_bounds_respect_lengths(pkg):
    assert _tagged(pkg.r, [[5, 5, 3, 3], [5, 5, 5, 5]], [2, 4]).min_version == 5
    assert _tagged(pkg.r, [[5, 5, 3, 3], [5, 5, 5, 5]], [3, 4]).min_version == 3
    assert _tagged(pkg.r, [[5, 5, 9, 9], [5, 5, 5, 5]], [2, 4]).max_version == 5
    assert _tagged(pkg.r, [[5, 5, 9, 9], [5, 5, 5, 5]], [3, 4]).max_version == 9


def test_version_bounds_computed_once(pkg):
    t = _tagged(pkg.r, [[5, 5, 3, 3]], [4])
    assert (t.min_version, t.max_version) == (3, 5)
    t.version_tags = np.zeros((1, 4), np.int32)  # a contract violation: not re-read
    assert t.min_version == 3


def _cand():
    return {
        "answers": [["x", "y"], ["u", "v"]],
        "problem": [["p0", "p0"], ["p1", "p1"]],
        "solution": [["s0", "s0"], ["s1", "s1"]],
        "token_lengths": [[3, 2], [1, 4]],
        "answer_tokens": [np.ones((2, 4), np.int32), 2 * np.ones((2, 4), np.int32)],
        "behavior_logps": [np.zeros((2, 4), np.float32)] * 2,
        "gen_lengths": [np.asarray([3, 2]), np.asarray([1, 4])],
    }


def test_round_trip_through_candidates(pkg):
    cand = _cand()
    trajs = pkg.r.round_to_trajectories(cand, base_version=7, swap_events=[(1, 8)],
                                        episode=2, batch_index=5)
    assert len(trajs) == 2 and trajs[0].episode == 2 and trajs[0].batch_index == 5
    np.testing.assert_array_equal(trajs[0].version_tags[0], [7, 7, 8, 8])
    back = pkg.r.trajectories_to_candidates(trajs, group_weights=[1.0, 0.5])
    assert back["answers"] == cand["answers"] and back["problem"] == cand["problem"]
    assert back["group_weights"] == [1.0, 0.5]
    np.testing.assert_array_equal(back["version_tags"][1], trajs[1].version_tags)


def _turny(r, tags, loss_mask, lengths, version=0):
    t = traj(r, 0, version=version)
    t.version_tags = np.asarray(tags, np.int32)
    t.loss_mask = np.asarray(loss_mask, np.int32)
    t.lengths = np.asarray(lengths, np.int32)
    return t


def test_env_tokens_excluded_from_bounds(pkg):
    t = traj(pkg.r, 0)
    t.version_tags = np.asarray([[5, 5, 1, 1]], np.int32)
    t.lengths = np.asarray([4], np.int32)
    assert t.min_version == 1
    t2 = _turny(pkg.r, [[5, 5, 1, 1]], [[1, 1, 0, 0]], [4])
    assert (t2.min_version, t2.max_version) == (5, 5)
    t3 = _turny(pkg.r, [[5, 5, 5, 5]], [[0, 0, 0, 0]], [4], version=7)
    assert (t3.min_version, t3.max_version) == (7, 7)


def test_turn_aware_admission(pkg):
    pol = pkg.r.StalenessPolicy(2, mode="drop")
    fake_fresh = _turny(pkg.r, [[0, 0, 9, 9], [0, 0, 9, 9]], [[1, 1, 0, 0], [1, 1, 0, 0]],
                        [4, 4])
    kept, _ = pol.admit([fake_fresh], learner_version=9)
    assert kept == [] and pol.dropped == 1
    stale_obs = _turny(pkg.r, [[0, 0, 9, 9], [0, 0, 9, 9]], [[0, 0, 1, 1], [0, 0, 1, 1]],
                       [4, 4], version=9)
    kept, _ = pkg.r.StalenessPolicy(2, mode="drop").admit([stale_obs], learner_version=9)
    assert kept == [stale_obs]
    down = _turny(pkg.r, [[0, 0, 9, 9]], [[0, 0, 1, 1]], [4], version=9)
    _, weights = pkg.r.StalenessPolicy(1, mode="downweight", downweight=0.5).admit(
        [down], learner_version=9)
    assert weights == [1.0]


def test_round_trip_carries_env_fields(pkg):
    cand = {**{k: v[:1] for k, v in _cand().items()},
            "loss_mask": [np.asarray([[1, 0, 1, 0], [1, 1, 0, 0]])],
            "rewards": [np.asarray([[0.1, 1.0], [0.0, 0.0]])],
            "turns": [[[{"turn": 0}], [{"turn": 0}]]], "env_name": "verifier"}
    trajs = pkg.r.round_to_trajectories(cand, base_version=3)
    assert trajs[0].meta["env_name"] == "verifier"
    back = pkg.r.trajectories_to_candidates(trajs)
    np.testing.assert_array_equal(back["loss_mask"][0], cand["loss_mask"][0])
    np.testing.assert_array_equal(back["rewards"][0], cand["rewards"][0])
    assert back["turns"] == cand["turns"] and back["env_name"] == "verifier"
    legacy = pkg.r.trajectories_to_candidates([traj(pkg.r, 0), traj(pkg.r, 1)])
    assert not {"loss_mask", "rewards", "turns", "env_name"} & set(legacy)


# ----------------------------------------------------------------- policy

def test_drop_mode(pkg):
    pol = pkg.r.StalenessPolicy(2, mode="drop")
    kept, weights = pol.admit([traj(pkg.r, i, version=v) for i, v in enumerate([5, 3, 1])],
                              learner_version=5)
    assert [g.produced_version for g in kept] == [5, 3] and weights == [1.0, 1.0]
    assert pol.dropped == 1 and pol.admitted == 2
    assert pkg.telemetry.metrics_snapshot()["rollout/dropped_stale"] == 1.0


def test_downweight_mode(pkg):
    pol = pkg.r.StalenessPolicy(1, mode="downweight", downweight=0.5)
    kept, weights = pol.admit([traj(pkg.r, i, version=v) for i, v in enumerate([5, 4, 2])],
                              learner_version=5)
    assert len(kept) == 3 and weights == [1.0, 1.0, 0.25] and pol.dropped == 0


def test_mixed_version_groups_admit_and_survive_eviction(pkg):
    pol = pkg.r.StalenessPolicy(2, mode="drop")
    mixed = traj(pkg.r, 0, version=0)
    mixed.version_tags = np.asarray([[0, 0, 5, 5], [0, 0, 5, 5]], np.int32)
    kept, weights = pol.admit([mixed, traj(pkg.r, 1, version=0)], learner_version=5)
    assert kept == [mixed] and weights == [1.0] and pol.dropped == 1
    assert pkg.telemetry.metrics_snapshot()["rollout/staleness_max"] == 5.0
    buf = pkg.r.TrajectoryBuffer(8)
    mixed2 = traj(pkg.r, 0, version=0)
    mixed2.version_tags = np.asarray([[0, 5, 5, 5], [0, 5, 5, 5]], np.int32)
    buf.put(mixed2)
    buf.put(traj(pkg.r, 1, version=0))
    assert buf.evict_stale(learner_version=5, max_staleness=2) == 1
    assert buf.get_batch(1) == [mixed2]


def test_staleness_histogram(pkg):
    pkg.r.StalenessPolicy(3).admit([traj(pkg.r, 0, version=3), traj(pkg.r, 1, version=2)],
                                   learner_version=4)
    snap = pkg.telemetry.metrics_snapshot()
    assert snap["rollout/staleness_count"] == 2 and snap["rollout/staleness_max"] == 2.0


@pytest.mark.parametrize("args,kw", [((-1,), {}), ((1,), dict(mode="discard")),
                                     ((1,), dict(downweight=0.0)),
                                     ((1,), dict(downweight=1.5))])
def test_policy_validation(pkg, args, kw):
    with pytest.raises(ValueError):
        pkg.r.StalenessPolicy(*args, **kw)


# ---------------------------------------------------------------- service

def _batches(n):
    for i in range(n):
        yield 0, i, {"problem": [f"p{i}"], "solution": [f"s{i}"]}


def test_service_produces_all_then_closes(pkg):
    buf = pkg.r.TrajectoryBuffer(16)
    service = pkg.r.RolloutService(lambda e, bi, b: [traj(pkg.r, bi)], buf,
                                   _batches(5)).start()
    got = []
    while batch := buf.get_batch(2):
        got.extend(batch)
    assert [g.batch_index for g in got] == [0, 1, 2, 3, 4]
    for _ in range(100):
        if service.done:
            break
        time.sleep(0.01)
    assert service.done and service.error is None and service.cursor == (0, 5)
    service.raise_if_failed()


def test_service_error_closes_buffer_and_reraises(pkg):
    buf = pkg.r.TrajectoryBuffer(4)

    def boom(e, bi, b):
        raise RuntimeError("engine died")

    service = pkg.r.RolloutService(boom, buf, _batches(3)).start()
    assert buf.get_batch(2, timeout=5) == []
    with pytest.raises(RuntimeError, match="engine died"):
        service.raise_if_failed()


def test_service_restart_budget(pkg):
    """A produce round that fails retries in place within the budget (each
    retry counted), and the run goes on; past the budget it fails."""
    buf = pkg.r.TrajectoryBuffer(8)
    fails = {"left": 2}

    def flaky(e, bi, b):
        if bi == 1 and fails["left"]:
            fails["left"] -= 1
            raise OSError("transient")
        return [traj(pkg.r, bi)]

    service = pkg.r.RolloutService(flaky, buf, _batches(3), max_restarts=2,
                                   retry_policy=pkg.retry(base_s=0.0, seed=0)).start()
    got = []
    while batch := buf.get_batch(1):
        got.extend(batch)
    assert [g.batch_index for g in got] == [0, 1, 2] and service.restarts_used == 2
    assert pkg.telemetry.metrics_snapshot()["rollout/producer_restarts"] == 2.0
    service.raise_if_failed()
    fails["left"] = 3
    buf2 = pkg.r.TrajectoryBuffer(8)
    dead = pkg.r.RolloutService(flaky, buf2, _batches(3), max_restarts=2,
                                retry_policy=pkg.retry(base_s=0.0, seed=0)).start()
    assert [g.batch_index for g in buf2.get_batch(8, timeout=5)] == [0]
    with pytest.raises(OSError, match="transient"):
        dead.raise_if_failed()


def test_service_pause_excludes_producer(pkg):
    buf = pkg.r.TrajectoryBuffer(64)
    in_produce, release = threading.Event(), threading.Event()
    produced = []

    def produce(e, bi, b):
        in_produce.set()
        release.wait(timeout=10)
        produced.append(bi)
        return [traj(pkg.r, bi)]

    service = pkg.r.RolloutService(produce, buf, _batches(4)).start()
    assert in_produce.wait(timeout=5)
    state = {"paused": False}

    def do_pause():
        service.pause()
        state["paused"] = True

    th = threading.Thread(target=do_pause)
    th.start()
    time.sleep(0.05)
    assert not state["paused"]  # blocked on the round in flight
    release.set()
    th.join(timeout=5)
    assert state["paused"]
    n = len(produced)
    time.sleep(0.15)
    assert len(produced) == n  # no round starts while paused
    service.resume()
    while buf.get_batch(1, timeout=1.0) and not service.done:
        pass
    service.stop()


def test_service_stop_while_backpressured(pkg):
    buf = pkg.r.TrajectoryBuffer(1)
    service = pkg.r.RolloutService(lambda e, bi, b: [traj(pkg.r, bi)], buf,
                                   _batches(10)).start()
    time.sleep(0.1)
    service.stop()
    for _ in range(40):
        if service.done:
            break
        time.sleep(0.05)
    assert service.done
    service.raise_if_failed()


PKGS["jax"].retry = JRetryPolicy
PKGS["port"].retry = TRetryPolicy


# ----------------------------------------------- the packages side by side

def _traj_fields(t):
    return (t.problem, t.solution, t.answers, t.token_lengths, t.produced_version,
            t.episode, t.batch_index, t.meta,
            *(None if x is None else (x.dtype.str, x.tolist())
              for x in (t.tokens, t.lengths, t.behavior_logps, t.version_tags, t.loss_mask,
                        t.rewards)))


@pytest.mark.parametrize("seed", range(4))
def test_buffer_op_sequences_match_jax(seed):
    """One seeded sequence of puts (blocking within the gate, or not),
    gets, evictions and watermark changes through both buffers: the same
    stats, queue and telemetry after every operation."""
    rng = np.random.default_rng(seed)
    bufs = [p.r.TrajectoryBuffer(8, high_watermark=6, low_watermark=2)
            for p in (PKGS["jax"], PKGS["port"])]
    made = 0
    for _ in range(60):
        op = rng.choice(["put", "put_nb", "get", "evict", "marks"])
        outs = []
        for p, buf in zip((PKGS["jax"], PKGS["port"]), bufs):
            st = np.random.default_rng(made + 7 * seed)
            if op in ("put", "put_nb"):
                t = traj(p.r, made, version=int(st.integers(0, 6)))
                block = op == "put" and not buf._gated and len(buf) < buf.high_watermark - 1
                buf.put(t, block=block)
            elif op == "get":
                outs.append([g.batch_index for g in buf.get_batch(int(st.integers(1, 4)),
                                                                 timeout=0.0)])
            elif op == "evict":
                outs.append(buf.evict_stale(int(st.integers(3, 9)), int(st.integers(0, 3))))
            else:
                hi = int(st.integers(2, 9))
                buf.set_watermarks(hi, max(1, hi // 3))
        if op in ("put", "put_nb"):
            made += 1
        assert outs[:1] == outs[1:]
        assert bufs[0].stats() == bufs[1].stats()
        assert [_traj_fields(t) for t in bufs[0].state_dict()["trajectories"]] == \
            [_traj_fields(t) for t in bufs[1].state_dict()["trajectories"]]
    assert jtelemetry.metrics_snapshot() == ttelemetry.metrics_snapshot()


@pytest.mark.parametrize("seed", range(3))
def test_tags_conversions_and_admission_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, t = 3, 10
    for _ in range(6):
        events = sorted({(int(s), int(v)) for s, v in
                         zip(rng.integers(0, t + 2, 3), rng.integers(1, 9, 3))})
        base = int(rng.integers(0, 5))
        np.testing.assert_array_equal(
            jrollout.version_tags_for_round(n, t, base, events),
            trollout.version_tags_for_round(n, t, base, events))
    groups = int(rng.integers(1, 5))
    cand = {
        "answers": [[f"a{g}{j}" for j in range(n)] for g in range(groups)],
        "problem": [[f"p{g}"] * n for g in range(groups)],
        "solution": [[f"s{g}"] * n for g in range(groups)],
        "token_lengths": [[int(x) for x in rng.integers(1, t, n)] for _ in range(groups)],
        "answer_tokens": [rng.integers(0, 50, (n, t)).astype(np.int32) for _ in range(groups)],
        "behavior_logps": [-rng.random((n, t)).astype(np.float32) for _ in range(groups)],
        "gen_lengths": [rng.integers(0, t + 1, n).astype(np.int32) for _ in range(groups)],
    }
    kw = dict(base_version=2, swap_events=[(1, 3), (5, 4)], episode=1, batch_index=3)
    jt = jrollout.round_to_trajectories(cand, **kw)
    tt = trollout.round_to_trajectories(cand, **kw)
    assert [_traj_fields(x) for x in jt] == [_traj_fields(x) for x in tt]
    weights = [float(w) for w in rng.random(groups)]
    jb = jrollout.trajectories_to_candidates(jt, weights)
    tb = trollout.trajectories_to_candidates(tt, weights)
    assert pickle.dumps(sorted(jb)) == pickle.dumps(sorted(tb))
    for k in jb:
        assert str(jb[k]) == str(tb[k]), k
    for mode in ("drop", "downweight"):
        k, learner = int(rng.integers(0, 3)), int(rng.integers(3, 8))
        jp = jrollout.StalenessPolicy(k, mode=mode, downweight=0.5)
        tp = trollout.StalenessPolicy(k, mode=mode, downweight=0.5)
        jk, jw = jp.admit(jt, learner)
        tk, tw = tp.admit(tt, learner)
        assert [x.problem for x in jk] == [x.problem for x in tk] and jw == tw
        assert (jp.dropped, jp.admitted) == (tp.dropped, tp.admitted)
    assert jtelemetry.metrics_snapshot() == ttelemetry.metrics_snapshot()


@pytest.mark.parametrize("kw", [{}, dict(base_s=0.25, seed=3407), dict(jitter=0.0),
                                dict(base_s=0.1, multiplier=3.0, max_backoff_s=1.0, seed=7)])
def test_retry_policy_delays_match_jax(kw):
    j, t = JRetryPolicy(**kw), TRetryPolicy(**kw)
    assert [j.backoff(a) for a in range(8)] == [t.backoff(a) for a in range(8)]
    for bad in (dict(base_s=-1.0), dict(max_backoff_s=-0.5)):
        with pytest.raises(ValueError):
            JRetryPolicy(**bad)
        with pytest.raises(ValueError):
            TRetryPolicy(**bad)


def test_rollout_sidecar_matches_jax(tmp_path):
    """The sidecar's path, pruning, round trip and corrupt-file handling
    equal the JAX package's; a port-written sidecar of plain payloads loads
    through the JAX loader and back."""
    state = {"cursor": (1, 2), "policy_dropped": 3, "policy_admitted": 4,
             "buffer": {"total_put": 5, "trajectories": []}}
    for mod, d in ((jcheckpoint, tmp_path / "jax"), (tcheckpoint, tmp_path / "port")):
        for step in range(1, 6):
            mod.save_rollout_state(str(d), step, {**state, "step": step})
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"rollout_state_{s}.pkl" for s in (3, 4, 5)]
    assert tcheckpoint.rollout_state_path(str(tmp_path), 3) == \
        jcheckpoint.rollout_state_path(str(tmp_path), 3)
    assert jcheckpoint.load_rollout_state(str(tmp_path / "port"), 5) == \
        tcheckpoint.load_rollout_state(str(tmp_path / "jax"), 5) == {**state, "step": 5}
    with open(tcheckpoint.rollout_state_path(str(tmp_path / "port"), 4), "wb") as f:
        f.write(b"not a pickle")
    assert tcheckpoint.load_rollout_state(str(tmp_path / "port"), 4) is None
    assert tcheckpoint.load_rollout_state(str(tmp_path / "port"), 99) is None


def test_telemetry_registry_matches_jax():
    for t in (jtelemetry, ttelemetry):
        t.counter_add("c")
        t.counter_add("c", 2.0)
        t.gauge_set("g", 3.0)
        for v in (4.0, 1.0, 9.0, 2.0):
            t.hist_observe("h", v)
        t.hist_observe("h", 5.0, count=3)
        t.hist_observe("h", 7.0, count=0)
    assert jtelemetry.metrics_snapshot() == ttelemetry.metrics_snapshot()
    assert jtelemetry.metrics_snapshot() == ttelemetry.metrics_snapshot() == {}
    with ttelemetry.span("rollout/produce") as sp:
        pass
    assert isinstance(sp, torch.profiler.record_function) and sp.name == "rollout/produce"


# -------------------------------------------------------- the adapter ring

def _tree(value: float):
    return {"layers": {"wq": {"a": torch.full((2, 3), value), "b": torch.full((3, 2), value)}}}


def _val(d) -> float:
    return float(d["layers"]["wq"]["a"][0, 0])


def test_adapter_ring_publishes_copies_at_fixed_addresses():
    ring = AdapterRing(2, "cpu")
    src = _tree(1.0)
    d0 = ring.push(src, 0)
    src["layers"]["wq"]["a"].fill_(5.0)  # the learner's in-place update
    assert _val(d0) == 1.0  # the pushed copy holds
    d1 = ring.push(_tree(2.0), 1)
    d2 = ring.push(_tree(3.0), 2)
    assert d2 is not d0 and d2["layers"]["wq"]["a"].data_ptr() == \
        d0["layers"]["wq"]["a"].data_ptr()
    assert d1["layers"]["wq"]["a"].data_ptr() != d0["layers"]["wq"]["a"].data_ptr()
    got, v, hold = ring.acquire()
    assert (got, v) == (d2, 2)
    ring.release_round(hold)
    assert ring.holds() == [0, 0] and ring.pushes == 3
    with pytest.raises(ValueError):
        AdapterRing(1, "cpu")
    with pytest.raises(RuntimeError, match="no adapter"):
        AdapterRing(2, "cpu").acquire()


def test_adapter_ring_push_waits_for_the_round_to_let_go():
    """A round holds its entry adapter; an in-flight push takes the other
    buffer; the next push must wait until the round's swap drops the first
    (the mailbox's hook), and never writes a buffer a round reads."""
    ring, box = AdapterRing(2, "cpu"), LoraMailbox()
    box.lora_swap_hook = ring.swap_hook
    ring.push(_tree(0.0), 0)
    entry, v, hold = ring.acquire()
    cell = [entry]
    box.push_lora(ring.push(_tree(1.0), 1), version=1)
    done = threading.Event()

    def third_push():
        box.push_lora(ring.push(_tree(2.0), 2), version=2)
        done.set()

    th = threading.Thread(target=third_push)
    th.start()
    time.sleep(0.1)
    assert not done.is_set() and _val(cell[0]) == 0.0  # no free buffer yet
    box._take_pending_lora(cell, 4)  # the round swaps to v1, dropping v0's buffer
    th.join(timeout=5)
    assert done.is_set() and _val(cell[0]) == 1.0 and ring.push_waits >= 1
    box._take_pending_lora(cell, 8)
    assert _val(cell[0]) == 2.0 and box.last_swap_steps == [4, 8]
    assert box.last_swap_versions == [1, 2]
    ring.release_round(hold)
    assert ring.holds() == [0, 0]


def test_adapter_ring_keeps_the_self_drafters_previous_adapter():
    """With ``_track_prev_lora`` the superseded adapter stays held (the
    drafter reads it) and the one falling out of "previous" is let go: three
    buffers, and a push never writes the current or the previous one."""
    ring, box = AdapterRing(3, "cpu"), LoraMailbox()
    box._track_prev_lora = True
    box.lora_swap_hook = ring.swap_hook
    ring.push(_tree(0.0), 0)
    entry, _, hold = ring.acquire()
    cell = [entry]
    for v in range(1, 5):
        box.push_lora(ring.push(_tree(float(v)), v), version=v)
        box._take_pending_lora(cell, 4 * v)
        assert _val(cell[0]) == float(v) and _val(box._prev_lora) == float(v - 1)
        assert sorted(ring.holds()) == [0, 1, 1]
    ring.release_round(hold)
    assert sorted(ring.holds()) == [0, 0, 1]  # the previous adapter stays resident
    entry, v, hold = ring.acquire()
    assert v == 4 and _val(entry) == 4.0
    ring.release_round(hold)


def test_adapter_ring_holds_follow_the_round_across_threads():
    """The round acquires and releases on one thread while its swaps are
    consumed on another (the hang detector's watchdog decodes the round on a
    thread of its own): the holds follow the round, not the thread, and a
    second round may not acquire while one is in flight."""
    ring, box = AdapterRing(2, "cpu"), LoraMailbox()
    box.lora_swap_hook = ring.swap_hook
    ring.push(_tree(0.0), 0)
    for r in range(1, 4):
        entry, _, hold = ring.acquire()
        with pytest.raises(RuntimeError, match="in flight"):
            ring.acquire()
        cell = [entry]
        box.push_lora(ring.push(_tree(float(r)), r), version=r)
        th = threading.Thread(target=box._take_pending_lora, args=(cell, 4))
        th.start()
        th.join(timeout=5)
        assert _val(cell[0]) == float(r) and sorted(ring.holds()) == [0, 1]
        ring.release_round(hold)
        assert ring.holds() == [0, 0]
    _, _, hold = ring.acquire()  # a swap to an adapter the ring never published
    box.push_lora(_tree(9.0), version=9)
    box._take_pending_lora(cell, 4)
    assert ring.holds() == [0, 0]
    ring.release_round(hold)
    assert ring.holds() == [0, 0]


# ------------------------------------------------- shared state under threads

def test_launch_counts_and_registry_lose_no_update_across_threads():
    """More threads than cores add launches and registry series with a short
    switch interval: no addition is lost, each thread's tally is its own,
    and a thread that captures keeps its launches out of the counts."""
    threads, each = 16, 2000
    before = tsampling.fused_sample_launches
    tallies, captured = {}, {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            c0 = launch_count.thread_counts()
            if i == 0:
                with launch_count.diverted() as sink:
                    for _ in range(each):
                        launch_count.add(tsampling.__name__, "fused_sample_launches")
                captured[i] = sink[(tsampling.__name__, "fused_sample_launches")]
            else:
                for _ in range(each):
                    launch_count.add(tsampling.__name__, "fused_sample_launches")
                    ttelemetry.counter_add("stress/c")
                    ttelemetry.hist_observe("stress/h", 1.0)
            tallies[i] = launch_count.thread_counts() - c0

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    key = (tsampling.__name__, "fused_sample_launches")
    assert tsampling.fused_sample_launches - before == (threads - 1) * each
    assert captured[0] == each and not tallies[0]
    assert all(tallies[i][key] == each for i in range(1, threads))
    snap = ttelemetry.metrics_snapshot()
    assert snap["stress/c"] == (threads - 1) * each
    assert snap["stress/h_count"] == (threads - 1) * each
    tsampling.fused_sample_launches = before
