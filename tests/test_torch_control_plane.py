"""The port's control plane (``distributed/control_plane.py`` on the copied
``native/csrc/control_plane.cc``) with real worker processes on the CPU
(``python -m distrl_llm_tpu_torch.distributed.worker_main``), mirroring the
JAX package's ``tests/test_control_plane.py`` and the live part of
``tests/test_resilience.py``: dispatch and collect (the rewards equal the
JAX package's ``reward_function``), health pings, deadlines, resubmission
after a SIGKILL, bounded retry of transient errors, fatal errors, poison
quarantine and ``allow_partial``, rejoin after a restart on the same port,
proactive quarantine, the SIGTERM drain, ``add_worker`` / ``retire_worker``,
driver-side fault injection; and one case each way across the packages: the
port's ``DriverClient`` against a JAX worker and the JAX one against a port
worker, over the same frames.

The helpers here (``spawn``, ``tiny_checkpoint``, ``serve_args``) also start
the model-serving workers of ``tests/test_torch_weight_bus.py``,
``test_torch_remote_engine.py`` and ``test_torch_remote_trainer.py``.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distrl_llm_tpu.distributed.control_plane import DriverClient as JDriverClient
from distrl_llm_tpu.rewards import reward_function as jreward_function
from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.distributed import resilience
from distrl_llm_tpu_torch.distributed.control_plane import DriverClient, WorkerDeadError
from distrl_llm_tpu_torch.distributed.resilience import (
    FaultInjector, RetryPolicy, ShardFailedError, WorkerError,
)
from distrl_llm_tpu_torch.native.build import native_available
from distrl_llm_tpu_torch.rewards import reward_function

pytestmark = [pytest.mark.distributed,
              pytest.mark.skipif(not native_available(), reason="g++ not available")]

ROOT = Path(__file__).resolve().parents[1]
PORT_WORKER = "distrl_llm_tpu_torch.distributed.worker_main"
JAX_WORKER = "distrl_llm_tpu.distributed.worker_main"
_PROCS: list[subprocess.Popen] = []


def spawn(*args, module: str = PORT_WORKER, port: int = 0, env: dict | None = None,
          reap: bool = True):
    """A worker process on the CPU (one intra-op thread): (process, port);
    killed after the test unless ``reap`` is False (a module's workers)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", str(port), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=str(ROOT),
        env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT), **(env or {})})
    if reap:
        _PROCS.append(proc)
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), line
    return proc, int(line.split()[1])


def kill(proc) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=10)


@pytest.fixture(autouse=True)
def _reap_and_reset():
    telemetry.reset()
    resilience.install(None)
    yield
    resilience.install(None)
    while _PROCS:
        kill(_PROCS.pop())


def tiny_tokenizer(path: Path) -> Path:
    """A byte-level BPE ``tokenizer.json`` in ``path`` for TINY's 256 ids:
    bytes 1-255 at their own ids and ``<|endoftext|>`` at 0, so that the
    worker reads EOS 0 and pad 0 from it (a dispatch then names the EOS ids
    its driver stops on)."""
    import json

    printable = [*range(ord("!"), ord("~") + 1), *range(ord("\u00a1"), ord("\u00ac") + 1),
                 *range(ord("\u00ae"), ord("\u00ff") + 1)]
    rest = iter(range(256, 512))
    char = {b: chr(b) if b in printable else chr(next(rest)) for b in range(256)}
    tj = {"version": "1.0", "normalizer": None, "post_processor": None,
          "added_tokens": [{"id": 0, "content": "<|endoftext|>", "single_word": False,
                            "lstrip": False, "rstrip": False, "normalized": False,
                            "special": True}],
          "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                            "trim_offsets": False, "use_regex": False},
          "decoder": {"type": "ByteLevel"},
          "model": {"type": "BPE", "vocab": {char[b]: b for b in range(1, 256)},
                    "merges": []}}
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    return path


def tiny_checkpoint(path: Path, *, vocab_size: int | None = None, seed: int = 7) -> Path:
    """TINY's (or a TINY of ``vocab_size``) f32 weights from the JAX
    package's ``init_params(PRNGKey(seed))``, carried into the port's
    ``Decoder`` and written by ``save_hf_checkpoint``, with
    ``tiny_tokenizer`` beside them."""
    import jax

    from distrl_llm_tpu.models import TINY, init_params
    from distrl_llm_tpu_torch.models.configs import ModelConfig
    from distrl_llm_tpu_torch.models.convert import params_from_numpy
    from distrl_llm_tpu_torch.models.loading import save_hf_checkpoint

    jcfg = TINY if vocab_size is None else dataclasses.replace(TINY, vocab_size=vocab_size)
    tree = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(seed), jcfg))
    save_hf_checkpoint(params_from_numpy(tree, ModelConfig(**dataclasses.asdict(jcfg)),
                                         device="cpu"), str(path))
    return tiny_tokenizer(path)


def serve_args(ckpt: Path, *, prompt: int, new: int, rank: int = 4, alpha: float = 8.0,
               extra=()) -> list:
    """worker_main flags serving ``ckpt`` on the CPU in f32."""
    return ["--serve-model", ckpt, "--device", "cpu", "--dtype", "float32",
            "--max-prompt-tokens", prompt, "--max-new-tokens", new, "--lora-rank", rank,
            "--lora-alpha", alpha, *extra]


def detach(driver) -> None:
    """Stop a driver's rejoin loop and close its connections without
    MSG_SHUTDOWN (which would stop the module's shared workers)."""
    driver._stop_rejoin.set()
    if driver._rejoin_thread is not None:
        driver._rejoin_thread.join(timeout=5)
    for w in driver._workers:
        if w.conn is not None:
            w.conn.close()
            w.conn = None


@pytest.fixture(scope="module")
def two_workers():
    procs, addrs = [], []
    for _ in range(2):
        p, port = spawn(reap=False)
        procs.append(p)
        addrs.append(("127.0.0.1", port))
    yield procs, addrs
    for p in procs:
        kill(p)


BATCH = {
    "answers": [["<answer>4</answer>", "wrong"],
                ["<think>t</think>\n<answer>9</answer>", "<answer>8</answer>"],
                ["<reasoning>\nx\n</reasoning>\n<answer>\n12\n</answer>\n", ""]],
    "solution": [["4", "4"], ["9", "9"], ["12", "12"]],
}


def _shards():
    return [("rollout_rewards", {"answers": [a], "solution": [s]})
            for a, s in zip(BATCH["answers"], BATCH["solution"])]


def _want_rewards():
    return [jreward_function(a, s) for a, s in zip(BATCH["answers"], BATCH["solution"])]


def test_dispatch_collect_rewards_match_jax(two_workers):
    _, addrs = two_workers
    driver = DriverClient(addrs, rejoin=False)
    try:
        got = driver.dispatch_objects(_shards(), timeout_ms=30_000)
        assert len(got) == 3
        for g, want, (a, s) in zip(got, _want_rewards(), zip(BATCH["answers"], BATCH["solution"])):
            np.testing.assert_array_equal(g[0], want)
            np.testing.assert_array_equal(g[0], reward_function(a, s))
        assert driver.dispatch_objects([("echo", i) for i in range(5)], 30_000) == list(range(5))
        meta = driver.last_dispatch_meta
        assert {m["worker"] for m in meta} == {f"{h}:{p}" for h, p in addrs}
        assert driver.ping_all() == [True, True]
        assert [s["healthy"] for s in driver.worker_states()] == [True, True]
        assert driver.addresses == addrs
    finally:
        detach(driver)


def test_fatal_worker_error_propagates(two_workers):
    _, addrs = two_workers
    driver = DriverClient(addrs, rejoin=False)
    with pytest.raises(WorkerError) as e:
        driver.dispatch_objects([("nope", None)], 30_000)
    assert not e.value.transient and "unknown op" in e.value.traceback_text
    assert driver.num_healthy == 2  # a program error is not a death
    detach(driver)


def test_transient_errors_retry_on_the_same_worker(two_workers):
    _, addrs = two_workers
    driver = DriverClient(addrs[:1], rejoin=False,
                          retry_policy=RetryPolicy(base_s=0.01, max_call_retries=2))
    assert driver.dispatch_objects([("flaky", {"key": "r1", "fails": 2})], 30_000) == [
        ("ok", "r1", 3)]
    assert telemetry.metrics_snapshot()["cp/retries"] == 2.0
    detach(driver)


def test_resubmission_after_sigkill():
    procs, addrs = zip(*[spawn() for _ in range(2)])
    addrs = [("127.0.0.1", p) for p in addrs]
    driver = DriverClient(addrs, rejoin=False)
    try:
        assert driver.dispatch_objects([("echo", 0), ("echo", 1)], 30_000) == [0, 1]
        kill(procs[0])
        assert driver.dispatch_objects([("echo", i) for i in range(4)], 30_000) == [0, 1, 2, 3]
        assert driver.num_healthy == 1
        assert telemetry.metrics_snapshot()["cp/resubmits"] >= 1
        kill(procs[1])
        with pytest.raises(WorkerDeadError, match="no healthy workers"):
            driver.dispatch_objects([("echo", 9)], 30_000)
    finally:
        driver.shutdown(timeout_ms=500)


def test_deadline_marks_the_worker_dead_and_moves_its_shard():
    """A shard past its deadline marks its worker unhealthy and goes to the
    other worker; past the deadline there too, no healthy worker remains."""
    procs, ports = zip(*[spawn() for _ in range(2)])
    driver = DriverClient([("127.0.0.1", p) for p in ports], rejoin=False)
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerDeadError, match="no healthy workers"):
            driver.dispatch_objects([("sleep", 3.0)], timeout_ms=500)
        assert time.monotonic() - t0 < 2.5  # two deadlines, not two sleeps
        assert driver.num_healthy == 0
    finally:
        driver.shutdown(timeout_ms=200)


def test_poison_shard_quarantine_and_allow_partial():
    procs, ports = zip(*[spawn() for _ in range(2)])
    addrs = [("127.0.0.1", p) for p in ports]
    policy = RetryPolicy(base_s=0.0, max_call_retries=0)
    driver = DriverClient(addrs, rejoin=False, retry_policy=policy, poison_threshold=2)
    try:
        shards = [("echo", "a"), ("flaky", {"key": "poison", "fails": 100}), ("echo", "b")]
        with pytest.raises(ShardFailedError) as e:
            driver.dispatch_objects(shards, 30_000)
        assert e.value.shard_index == 1 and len(e.value.workers) == 2
        got = driver.dispatch_objects(
            [("echo", "a"), ("flaky", {"key": "poison2", "fails": 100}), ("echo", "b")],
            30_000, allow_partial=True)
        assert got == ["a", None, "b"]  # aligned with the shards
        assert driver.num_healthy == 2  # transient errors are no deaths
        assert telemetry.metrics_snapshot()["cp/poison_shards"] == 2.0
    finally:
        driver.shutdown(timeout_ms=500)


def test_rejoin_after_a_restart_on_the_same_port():
    proc, port = spawn()
    driver = DriverClient([("127.0.0.1", port)], rejoin=True, rejoin_poll_s=0.05,
                          retry_policy=RetryPolicy(base_s=0.05, max_backoff_s=0.2))
    try:
        assert driver.dispatch_objects([("echo", 1)], 10_000) == [1]
        kill(proc)
        assert driver.ping_all(timeout_ms=2000) == [False] and driver.num_healthy == 0
        spawn(port=port)
        deadline = time.monotonic() + 30
        while driver.num_healthy < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert driver.num_healthy == 1 and driver.rejoin_epoch >= 1
        assert driver.dispatch_objects([("echo", 2)], 10_000) == [2]
        snap = telemetry.metrics_snapshot()
        assert snap["cp/reconnects"] >= 1 and snap["cp/healthy_workers"] == 1.0
    finally:
        driver.shutdown(timeout_ms=500)


def test_proactive_quarantine_probes_and_readmits(two_workers):
    _, addrs = two_workers
    driver = DriverClient(addrs, rejoin=True, rejoin_poll_s=0.05,
                          retry_policy=RetryPolicy(base_s=0.05, max_backoff_s=0.2))
    a, b = (f"{h}:{p}" for h, p in addrs)
    assert driver.quarantine_worker(a) and driver.num_healthy == 1
    assert not driver.quarantine_worker(b)  # would leave none healthy
    assert not driver.quarantine_worker(a)  # already unhealthy
    deadline = time.monotonic() + 30
    while driver.num_healthy < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert driver.num_healthy == 2 and driver.rejoin_epoch >= 1
    assert telemetry.metrics_snapshot()["cp/quarantines"] == 1.0
    detach(driver)
    nodrive = DriverClient(addrs[:1], rejoin=False)
    assert not nodrive.quarantine_worker(a)  # no rejoin loop: refused
    detach(nodrive)


def test_sigterm_drains_the_dispatch_in_flight():
    proc, port = spawn()
    driver = DriverClient([("127.0.0.1", port)], rejoin=False)
    res: dict = {}

    def call():
        try:
            res["v"] = driver.dispatch_objects([("sleep", 1.5)], timeout_ms=30_000)
        except BaseException as e:  # noqa: BLE001 — asserted below
            res["e"] = e

    th = threading.Thread(target=call)
    th.start()
    time.sleep(0.4)  # the dispatch is inside the handler
    proc.send_signal(signal.SIGTERM)
    th.join(timeout=30)
    assert not th.is_alive() and res.get("v") == ["slept"], res
    assert proc.wait(timeout=15) == 0
    out = proc.stdout.read().splitlines()
    assert out[-1] == "DRAINED" and out[0].startswith("LAUNCHES ")  # no model: zero launches
    driver.shutdown(timeout_ms=200)


def test_add_and_retire_workers(two_workers):
    procs, addrs = two_workers
    third, port = spawn()
    driver = DriverClient(addrs, rejoin=True, rejoin_poll_s=0.05)
    try:
        assert driver.add_worker(f"127.0.0.1:{port}")
        assert not driver.add_worker(("127.0.0.1", port))  # already a member
        assert driver.num_healthy == 3 and driver.membership_epoch == 1
        got = driver.dispatch_objects([("echo", i) for i in range(6)], 30_000)
        assert got == list(range(6))
        assert f"127.0.0.1:{port}" in {m["worker"] for m in driver.last_dispatch_meta}
        assert driver.retire_worker(("127.0.0.1", port), drain=True)
        assert not driver.retire_worker(("127.0.0.1", port))
        assert third.wait(timeout=15) == 0  # drained by MSG_SHUTDOWN
        time.sleep(0.3)  # the rejoin loop must never re-dial a retired worker
        assert driver.num_healthy == 2
        assert [s["retired"] for s in driver.worker_states()] == [False, False, True]
        assert driver.dispatch_objects([("echo", 7)], 30_000) == [7]
        assert telemetry.metrics_snapshot()["cp/retires"] == 1.0
    finally:
        detach(driver)


def test_driver_side_injected_close_resubmits(two_workers):
    _, addrs = two_workers
    injector = FaultInjector("send:1=close")
    resilience.install(injector)  # wraps the connections made from now on
    driver = DriverClient(addrs, rejoin=False)
    try:
        assert driver.dispatch_objects([("echo", 1), ("echo", 2)], 30_000) == [1, 2]
        assert injector.events == [("send", 1, "close")] and driver.num_healthy == 1
        assert telemetry.metrics_snapshot()["cp/resubmits"] == 1.0
    finally:
        resilience.install(None)
        detach(driver)


def test_port_driver_and_jax_worker_speak_one_wire():
    _, port = spawn(module=JAX_WORKER)
    driver = DriverClient([("127.0.0.1", port)], rejoin=False)
    assert driver.dispatch_objects([("echo", {"x": [1, 2]})], 60_000) == [{"x": [1, 2]}]
    got = driver.dispatch_objects(_shards(), 60_000)
    for g, want in zip(got, _want_rewards()):
        np.testing.assert_array_equal(g[0], want)
    assert driver.ping_all() == [True]
    driver.shutdown()


def test_jax_driver_and_port_worker_speak_one_wire():
    proc, port = spawn()
    driver = JDriverClient([("127.0.0.1", port)], rejoin=False)
    assert driver.dispatch_objects([("echo", (1, "a"))], 60_000) == [(1, "a")]
    got = driver.dispatch_objects(_shards(), 60_000)
    for g, want in zip(got, _want_rewards()):
        np.testing.assert_array_equal(g[0], want)
    assert driver.ping_all() == [True]
    driver.shutdown()
    assert proc.wait(timeout=15) == 0  # MSG_SHUTDOWN from the JAX driver stops it
