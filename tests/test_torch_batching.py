"""The port's continuous-batching engine (``repro_torch.serving.batching``)
against the JAX reference's semantics.

Formation is a pure function of (queue contents, clock): the port's
``RequestQueue`` and the reference's replay the same scripts of pushes
and formation calls under one fake clock, and must form the same
``FormedBatch`` sequence (model, uids, reason), through the ``full``,
``deadline`` and ``drain`` reasons, bulk aging and interactive
preemption, in hand-written and seeded random scripts.

The engine tests port ``tests/test_serving_queue.py``'s (per-batch routing
waits on ROADMAP A13b): a deadline launch without a drain waiter, LRU
evict → rebuild bit-exact, four concurrent submitters, close drains,
validation.  They run on the CPU (``device="cpu"``), where the ``cuda``
backend's wrappers take the kernels' plain versions, and every logit is
held bit-equal (int8 paths have no tolerance) to the program run directly
or to the ``ref`` backend."""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.serving import batching as jbatching
from repro_torch import obs as tobs
from repro_torch.core import convcore as tconvcore
from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.core.scheduler import MultiCoreScheduler, SchedulerConfig
from repro_torch.serving import batching as tbatching
from repro_torch.serving.batching import (ContinuousBatchingEngine,
                                          ProgramCache, RequestQueue,
                                          ServeRequest)
from repro_torch.serving.engine import ConvNetEngine

MS = 1_000_000                           # ns per ms


class FakeClock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _port_registry():
    snapshot = dict(tconvcore.BACKENDS)
    yield
    tconvcore.BACKENDS.clear()
    tconvcore.BACKENDS.update(snapshot)


# -- formation parity with the reference -------------------------------------

def _replay(pkg, obs_pkg, script, deadline_ms=5.0, aging_ms=50.0):
    """Run ``script`` on ``pkg``'s RequestQueue → [(model, uids, reason)]
    per formation call (None where nothing formed)."""
    clk = FakeClock()
    q = pkg.RequestQueue(obs_pkg.MetricsRegistry(), deadline_ms=deadline_ms,
                         bulk_aging_ms=aging_ms, clock=clk)
    out = []
    for ev in script:
        clk.t = ev[1]
        if ev[0] == "push":
            q.push_many([pkg.ServeRequest(
                uid=uid, model=model, image=np.zeros((2, 2, 1), np.float32),
                priority=prio, enqueue_ns=clk.t,
                deadline_ns=clk.t + int(deadline_ms * MS), future=Future())
                for uid, model, prio in ev[2]])
        else:
            fb = q.form(ev[2], drain=ev[3])
            out.append(None if fb is None else
                       (fb.model, [r.uid for r in fb.requests], fb.reason))
    return out


SCRIPTS = {
    "full_deadline_drain": [
        ("push", 0, [(0, "a", "interactive"), (1, "b", "interactive")]),
        ("form", 1 * MS, 2, False),                 # nothing due
        ("push", 2 * MS, [(2, "b", "interactive")]),
        ("form", 2 * MS, 2, False),                 # b full
        ("form", 5 * MS, 2, False),                 # a's deadline
        ("push", 6 * MS, [(3, "a", "bulk")]),
        ("form", 6 * MS, 2, True),                  # drain
        ("form", 7 * MS, 2, True),                  # empty
    ],
    "preemption_and_aging": [
        ("push", 0, [(0, "m", "bulk"), (1, "m", "bulk")]),
        ("push", 1 * MS, [(2, "m", "interactive"), (3, "m", "interactive")]),
        ("form", 1 * MS, 2, True),                  # interactive first
        ("push", 60 * MS, [(4, "m", "interactive"), (5, "m", "interactive")]),
        ("form", 60 * MS, 2, True),                 # aged bulk leads
        ("form", 60 * MS, 2, True),
        ("push", 70 * MS, [(6, "m", "bulk")]),
        ("push", 80 * MS, [(7, "m", "interactive")]),
        ("form", 80 * MS, 4, True),
    ],
    "full_model_wins_over_drain": [
        ("push", 0, [(0, "a", "interactive"), (1, "b", "interactive"),
                     (2, "b", "interactive")]),
        ("form", 0, 2, True),
        ("form", 0, 2, True),
    ],
}


def _random_script(seed, n=60):
    rng = np.random.default_rng(seed)
    script, t, uid = [], 0, 0
    for _ in range(n):
        t += int(rng.integers(0, 4 * MS))
        if rng.random() < 0.55:
            reqs = []
            for _ in range(int(rng.integers(1, 5))):
                reqs.append((uid, str(rng.choice(["a", "b", "c"])),
                             str(rng.choice(["interactive", "bulk"]))))
                uid += 1
            script.append(("push", t, reqs))
        else:
            script.append(("form", t, int(rng.integers(1, 5)),
                           bool(rng.random() < 0.3)))
    return script


@pytest.mark.parametrize("name", sorted(SCRIPTS) + ["random0", "random1",
                                                    "random2"])
def test_formation_equals_the_reference(name):
    script = SCRIPTS.get(name) or _random_script(int(name[-1]))
    want = _replay(jbatching, jobs, script)
    got = _replay(tbatching, tobs, script)
    assert got == want
    reasons = {f[2] for f in got if f}
    if name in SCRIPTS:
        assert reasons <= {"full", "deadline", "drain"} and reasons


def test_queue_depth_gauge_and_validation():
    clk = FakeClock()
    reg = tobs.MetricsRegistry()
    q = RequestQueue(reg, deadline_ms=5.0, clock=clk)
    q.push_many([ServeRequest(i, "m", np.zeros((2, 2, 1), np.float32),
                              "interactive", 0, 5 * MS, Future())
                 for i in range(3)])
    assert reg.gauge("queue.depth").value == 3
    q.form(2, drain=True)
    assert reg.gauge("queue.depth").value == 1
    assert reg.gauge("queue.depth.peak").value == 3
    with pytest.raises(ValueError, match="unknown priority"):
        q.push_many([ServeRequest(9, "m", None, "nope", 0, 0, Future())])
    assert len(q) == 1                       # a refused push adds nothing
    with pytest.raises(ValueError, match="deadline_ms"):
        RequestQueue(tobs.MetricsRegistry(), deadline_ms=0.0, clock=clk)


def test_program_cache_lru_eviction_and_counters():
    reg = tobs.MetricsRegistry()
    cache = ProgramCache(2, reg)
    built = []

    def mk(k):
        return lambda: built.append(k) or f"prog-{k}"

    assert cache.get("a", mk("a")) == "prog-a"
    assert cache.get("b", mk("b")) == "prog-b"
    assert cache.get("a", mk("a")) == "prog-a"       # hit refreshes a
    assert cache.get("c", mk("c")) == "prog-c"       # evicts b
    assert cache.keys() == ["a", "c"] and "b" not in cache
    assert cache.get("b", mk("b")) == "prog-b"
    assert built == ["a", "b", "c", "b"]
    assert (reg.counter("cache.hits").value, reg.counter("cache.misses")
            .value, reg.counter("cache.evictions").value) == (1, 4, 2)
    with pytest.raises(ValueError):
        ProgramCache(0, tobs.MetricsRegistry())


# -- the engine ---------------------------------------------------------------

_QNETS = {}


def _qnet(shape=(12, 12, 1), net="lenet"):
    if (net, shape) not in _QNETS:
        rng = np.random.default_rng(0)
        plan = getattr(network, net)(input_shape=shape)
        params = plan.init_params(rng, device="cpu")
        x = torch.from_numpy(rng.normal(size=(2, *shape)).astype(np.float32))
        _QNETS[net, shape] = network.quantize_network(plan, params, x)
    return _QNETS[net, shape]


def _engine(**kw):
    kw.setdefault("device", "cpu")
    return ContinuousBatchingEngine(**kw)


def test_deadline_launch_without_drain_waiter():
    eng = _engine(batch=8, deadline_ms=25.0)
    try:
        eng.add_model(_qnet())
        logits = eng.submit_async(np.zeros((12, 12, 1), np.float32)).result(
            timeout=120)
        assert logits.shape == (10,) and logits.dtype == np.float32
        counts = eng.formation_counts()
        assert counts["deadline"] == 1 and counts["full"] == 0
        assert eng.stats == {"requests": 1, "batches": 1, "padded": 7}
        assert eng.metrics.histogram("queue_wait_us").summary()["count"] == 1
    finally:
        eng.close()


def test_lru_evict_rebuild_bit_exact():
    """capacity 1: adding b evicts a's program; a's next batch rebuilds
    it (counted) and its logits equal a fresh engine's."""
    qa, qb = _qnet((12, 12, 1)), _qnet((10, 10, 1))
    rng = np.random.default_rng(7)
    imgs = rng.normal(size=(3, 12, 12, 1)).astype(np.float32)
    eng = _engine(batch=2, cache_capacity=1)
    try:
        eng.add_model(qa, name="a")
        eng.add_model(qb, name="b")
        assert eng.cache_stats()["evictions"] == 1
        got = eng.submit(imgs, model="a")
        stats = eng.cache_stats()
        assert stats["misses"] == 3 and stats["evictions"] == 2
        assert stats["size"] == 1 and stats["capacity"] == 1
        out_b = eng.submit(rng.normal(size=(1, 10, 10, 1)).astype(
            np.float32))                           # admission by shape
        assert out_b.shape == (1, 10)
    finally:
        eng.close()
    fresh = _engine(batch=2)
    try:
        fresh.add_model(qa, name="a")
        want = fresh.submit(imgs, model="a")
    finally:
        fresh.close()
    np.testing.assert_array_equal(got, want)


def test_concurrent_submitters_consistent():
    """Four threads share one engine; each gets exactly its own logits,
    bit-equal to the program run on each image alone."""
    qnet = _qnet()
    prog = network.make_int8_program(qnet, ConvCoreConfig(int8=True))
    eng = _engine(batch=4, deadline_ms=50.0)
    n_threads, per = 4, 6
    rng = np.random.default_rng(3)
    images = [rng.normal(size=(per, 12, 12, 1)).astype(np.float32)
              for _ in range(n_threads)]
    results, errors = [None] * n_threads, []

    def work(t):
        try:
            results[t] = eng.submit(images[t],
                                    priority=("interactive", "bulk")[t % 2])
        except BaseException as e:             # pragma: no cover
            errors.append((t, e))

    try:
        eng.add_model(qnet)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        for t in range(n_threads):
            assert results[t].shape == (per, 10)
            for i in range(per):
                want = prog(torch.from_numpy(images[t][i][None]))[0]
                np.testing.assert_array_equal(results[t][i], want.numpy())
        s = eng.stats
        assert s["requests"] == n_threads * per
        assert s["batches"] <= n_threads * per
        assert eng.latency_percentiles()["count"] == n_threads * per
    finally:
        eng.close()


def test_stress_many_submitters_short_switch_interval():
    """More submitter threads than cores, with the interpreter switching
    threads every few microseconds: no request is lost, duplicated or
    cross-wired, and the counters add up."""
    import os
    import sys
    qnet = _qnet()
    prog = network.make_int8_program(qnet, ConvCoreConfig(int8=True))
    n_threads, per = 2 * (os.cpu_count() or 4), 3
    rng = np.random.default_rng(11)
    images = rng.normal(size=(n_threads, per, 12, 12, 1)).astype(np.float32)
    want = prog(torch.from_numpy(images.reshape(-1, 12, 12, 1))).numpy()
    results, errors = [None] * n_threads, []
    eng = _engine(batch=4, deadline_ms=2.0)
    interval = sys.getswitchinterval()

    def work(t):
        try:
            futs = eng.submit_async(images[t])
            results[t] = np.stack([f.result(timeout=120) for f in futs])
        except BaseException as e:             # pragma: no cover
            errors.append((t, e))

    try:
        eng.add_model(qnet)
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
        eng.close()
    assert not any(th.is_alive() for th in threads) and not errors
    np.testing.assert_array_equal(np.stack(results).reshape(want.shape), want)
    s = eng.stats
    assert s["requests"] == n_threads * per
    assert 4 * s["batches"] - s["padded"] == n_threads * per
    assert sum(eng.formation_counts().values()) == s["batches"]
    assert eng.latency_percentiles()["count"] == n_threads * per


def test_engine_validation_and_admission_errors():
    eng = _engine(batch=2)
    try:
        with pytest.raises(ValueError, match="no models"):
            eng.submit_async(np.zeros((12, 12, 1), np.float32))
        eng.add_model(_qnet(), name="m")
        with pytest.raises(ValueError, match="already registered"):
            eng.add_model(_qnet(), name="m")
        with pytest.raises(ValueError, match="unknown model"):
            eng.submit_async(np.zeros((12, 12, 1), np.float32), model="nope")
        with pytest.raises(ValueError, match="input shape"):
            eng.submit_async(np.zeros((9, 9, 1), np.float32), model="m")
        with pytest.raises(ValueError, match="unknown priority"):
            eng.submit_async(np.zeros((12, 12, 1), np.float32),
                             priority="urgent")
        assert eng.models() == ["m"]
        assert eng.submit(np.zeros((0, 12, 12, 1), np.float32)).shape == \
            (0, 10)
    finally:
        eng.close()
    with pytest.raises(ValueError):
        _engine(batch=0)
    with pytest.raises(ValueError):
        _engine(max_inflight=0)


@pytest.mark.parametrize("kw,item", [
    (dict(calib=object()), "A7/A11"), (dict(drift_band=(0.5, 2.0)), "A7/A11"),
    (dict(route=True), "A13b")])
def test_parameters_not_ported_raise_naming_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _engine(**kw)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ConvNetEngine(_qnet(), device="cpu", **kw)


def test_tuned_plans_raise_naming_their_item():
    eng = _engine()
    with pytest.raises(NotImplementedError, match="ROADMAP A13b"):
        eng.add_model(_qnet(), tune=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A13b"):
        ConvNetEngine(_qnet(), device="cpu", tune=object())


def test_close_drains_queued_work():
    eng = _engine(batch=4, deadline_ms=10_000.0)
    eng.add_model(_qnet())
    futs = eng.submit_async(np.zeros((2, 12, 12, 1), np.float32))
    eng.close()                                # must not strand the futures
    for f in futs:
        assert f.result(timeout=60).shape == (10,)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit_async(np.zeros((12, 12, 1), np.float32))


@pytest.mark.parametrize("mode,cores", [("batch", 3), ("kout", 4),
                                        ("spatial", 4)])
def test_engine_serves_every_scheduler_mode_bit_exact(mode, cores):
    """unet_small (per-pixel logits, transposed convs) through the engine
    under each mode, batch 4 with a ragged 3-core split, equals the plain
    backend's program; one engine serves two models."""
    qu, ql = _qnet((16, 16, 4), "unet_small"), _qnet()
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(6, 16, 16, 4)).astype(np.float32)
    limgs = rng.normal(size=(3, 12, 12, 1)).astype(np.float32)
    want = network.make_int8_program(qu, ConvCoreConfig(
        int8=True, backend="ref"))(torch.from_numpy(imgs)).numpy()
    lwant = network.make_int8_program(ql, ConvCoreConfig(
        int8=True, backend="ref"))(torch.from_numpy(limgs)).numpy()
    backend, n_cores = "cuda", cores
    if mode != "batch":
        sb = MultiCoreScheduler(SchedulerConfig(cores, mode)).shard_backend(
            "cuda")
        tconvcore.register_backend(sb)
        backend, n_cores = sb.name, 1
    eng = _engine(batch=4, n_cores=n_cores, backend=backend)
    try:
        eng.add_model(qu)
        eng.add_model(ql)
        futs = eng.submit_async(imgs, priority="bulk")
        got_l = eng.submit(limgs)
        got = np.stack([f.result(timeout=120) for f in futs])
        assert got.shape == (6, 16, 16, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_l, lwant)
        assert eng.stats["requests"] == 9
    finally:
        eng.close()


def test_facade_keeps_the_synchronous_contract_and_adds_async():
    qnet = _qnet()
    rng = np.random.default_rng(9)
    imgs = rng.normal(size=(5, 12, 12, 1)).astype(np.float32)
    eng = ConvNetEngine(qnet, batch=2, device="cpu", deadline_ms=1.0)
    try:
        got = eng.submit(imgs)
        futs = eng.submit_async(imgs[:3])
        one = eng.submit_async(imgs[4]).result(timeout=60)
        np.testing.assert_array_equal(
            np.stack([f.result(timeout=60) for f in futs]), got[:3])
        np.testing.assert_array_equal(one, got[4])
        assert eng.stats["requests"] == 9
        pct = eng.latency_percentiles()
        assert pct["count"] == 9 and 0 < pct["p50"] <= pct["p99"]
        assert eng.metrics is eng.engine.metrics
        assert eng.layer_profile is None and eng.drift_events == ()
    finally:
        eng.close()
