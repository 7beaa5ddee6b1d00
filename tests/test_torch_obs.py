"""The port's telemetry (``repro_torch.obs``) against the contracts of the
reference's ``tests/test_obs.py``: disabled by default with a shared no-op
span, nesting and exception tagging, the Chrome trace export, threads
nesting apart, the metrics registry, histogram percentiles (held to
numpy within the bucket bound, and equal to the reference's histogram on
the same samples), the per-layer profile's layer set against the plan's
topology (``lenet`` and ``unet_small``), with and without a calibration
table, each node's predicted time equal to the reference's under no
table, a synthetic one and the repo's two fitted ones, layer spans, the
drift detector, and the engine's first-batch profile with obs on and
nothing with it off."""

import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs.metrics import Histogram as JHistogram
from repro_torch import obs
from repro_torch.core import network
from repro_torch.core.calibration import CalibrationTable
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.obs.metrics import Histogram, MetricsRegistry, default_buckets
from repro_torch.obs.profile import (DEFAULT_DRIFT_BAND, DriftDetector,
                                     LayerProfile, profile_network)
from repro_torch.obs.trace import NOOP_SPAN, Tracer
from repro_torch.serving.engine import ConvNetEngine


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _obs_clean():
    """Disabled-by-default in, disabled-and-empty out."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def test_disabled_by_default_span_is_shared_noop():
    assert not obs.enabled()
    s1, s2 = obs.span("anything", key="val"), obs.span("else")
    assert s1 is NOOP_SPAN and s2 is NOOP_SPAN
    with s1:
        with s2:
            pass
    obs.instant("mark", x=1)
    assert len(obs.tracer) == 0
    assert obs.dump(".") is None


def test_span_nesting_and_exceptions():
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    evs = {e["name"]: e for e in obs.tracer.events()}
    assert evs["inner"]["args"]["parent"] == "outer"
    assert evs["inner"]["ts"] >= evs["outer"]["ts"]
    assert (evs["inner"]["ts"] + evs["inner"]["dur"]
            <= evs["outer"]["ts"] + evs["outer"]["dur"] + 1e-6)
    with pytest.raises(ValueError):
        with obs.span("a"):
            with obs.span("boom"):
                raise ValueError("expected")
    evs = {e["name"]: e for e in obs.tracer.events()}
    assert evs["boom"]["args"]["error"] == "ValueError"
    assert evs["a"]["args"]["error"] == "ValueError"
    with obs.span("after"):
        pass
    after = [e for e in obs.tracer.events() if e["name"] == "after"][0]
    assert "parent" not in after.get("args", {})
    obs.disable()
    n = len(obs.tracer)
    with obs.span("off"):
        pass
    assert len(obs.tracer) == n


def test_chrome_trace_export_and_dump(tmp_path):
    obs.enable()
    with obs.span("compile", network="lenet"):
        with obs.span("layer:conv1", psums=123):
            pass
    obs.instant("drift", layer="conv1")
    obs.metrics.counter("c").inc()
    paths = obs.dump(str(tmp_path), prefix="t")
    doc = json.load(open(paths["trace"]))
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert len(doc["traceEvents"]) == 3
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "i") and ev["ts"] >= 0
        assert {"name", "pid", "tid"} <= set(ev)
    lines = [json.loads(ln) for ln in open(paths["metrics"])]
    assert any(d["name"] == "c" and d["value"] == 1 for d in lines)


def test_tracer_threads_nest_independently():
    tr = Tracer()

    def worker(tag):
        with tr.span(f"outer:{tag}"):
            with tr.span(f"inner:{tag}"):
                pass

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    evs = tr.events()
    assert len(evs) == 8
    for e in evs:
        if e["name"].startswith("inner:"):
            assert e["args"]["parent"] == f"outer:{e['name'].split(':')[1]}"


def test_registry_contract_and_jsonl(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("req")
    c.inc()
    c.inc(5)
    g = reg.gauge("fill")
    g.set(0.75)
    assert (c.value, g.value) == (6, 0.75)
    assert reg.counter("req") is c
    with pytest.raises(TypeError):
        reg.gauge("req")
    reg.histogram("lat").observe(10.0)
    lines = [json.loads(ln) for ln in
             open(reg.export_jsonl(str(tmp_path / "m.jsonl")))]
    assert [d["name"] for d in lines] == ["fill", "lat", "req"]   # sorted
    reg.reset()
    assert c.value == 0 and g.value is None and reg.get("req") is c


def test_histogram_percentiles_vs_numpy_and_the_reference():
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=5.0, sigma=1.5, size=5000)
    h, jh = Histogram("lat_us"), JHistogram("lat_us")
    h.observe_many(samples)
    jh.observe_many(samples)
    assert h.count == len(samples)
    for p in (50, 90, 99):
        exact = float(np.percentile(samples, p))
        # the fixed-bucket estimate is within the bucket ratio (~12% at
        # 20 buckets a decade), tested with headroom
        assert abs(h.percentile(p) - exact) / exact < 0.15
        assert h.percentile(p) == jh.percentile(p)
    assert h.summary() == jh.summary()
    empty = Histogram("h")
    assert empty.percentile(50) == 0.0
    big = Histogram("big", bounds=[1.0, 2.0])
    big.observe(1e9)
    assert big.percentile(99) == pytest.approx(1e9)
    with pytest.raises(ValueError):
        Histogram("bad", bounds=[2.0, 1.0])
    b = default_buckets()
    assert b[0] == pytest.approx(1.0) and b[-1] >= 1e8


def _qnet(net, shape):
    rng = np.random.default_rng(0)
    plan = getattr(network, net)(input_shape=shape)
    params = plan.init_params(rng, device="cpu")
    x = torch.from_numpy(rng.normal(size=(2, *shape)).astype(np.float32))
    return network.quantize_network(plan, params, x), x


@pytest.mark.parametrize("net,shape", [("lenet", (12, 12, 1)),
                                       ("unet_small", (16, 16, 4))])
def test_profile_layer_set_matches_plan_topology(net, shape):
    qnet, x = _qnet(net, shape)
    obs.enable()
    prof = profile_network(qnet, x, warmup=0)
    plan = qnet.plan
    assert prof.layer_names == plan.node_names()
    assert not prof.calibrated and prof.batch == 2
    for i, r in enumerate(prof.records):
        assert r.index == i and r.wall_us > 0
        assert r.kind == plan.layers[i].kind
    convs = [r for r in prof.records if r.kind in ("conv", "conv_transpose")]
    assert convs and all(r.predicted_us > 0 and r.gops > 0 for r in convs)
    assert ("conv_transpose" in {r.kind for r in convs}) == (
        net == "unet_small")
    names = {e["name"] for e in obs.tracer.events()}
    assert "profile" in names
    assert {f"layer:{n}" for n in prof.layer_names} <= names
    h = obs.metrics.get(f"profile.layer_us.{plan.name}")
    assert h is not None and h.count == len(prof.records)
    # under a table the same layer set, priced on the table's clock
    table = CalibrationTable(compute_factor=2.0, clock_hz=1e9,
                             per_call_overhead_cycles=100.0)
    cal = profile_network(qnet, x, warmup=0, calib=table)
    assert cal.calibrated and cal.layer_names == prof.layer_names
    assert all(r.calibrated for r in cal.records)
    assert [r.predicted_us is None for r in cal.records] == \
        [r.predicted_us is None for r in prof.records]


@pytest.mark.parametrize("table", [None, "synthetic", "CALIBRATION.json",
                                   "CALIBRATION_h100.json"])
@pytest.mark.parametrize("net,shape", [("lenet", (12, 12, 1)),
                                       ("unet_small", (16, 16, 4)),
                                       ("vgg_imagenet", (224, 224, 4))])
def test_profile_prediction_equals_reference(net, shape, table):
    """Each node's predicted µs (planned convs through
    ``pipeline_estimate``, GEMMs on calibrated compute cycles plus the
    per-call overhead, on the table's clock) equals the reference's."""
    from repro.core import banking as jbanking
    from repro.core import calibration as jcal
    from repro.core import perfmodel as jperf
    from repro.obs.profile import _predicted_us as jpredicted
    from repro_torch.core import perfmodel as tperf
    from repro_torch.obs.profile import _predicted_us as tpredicted
    if table is None:
        jt = tt = None
    elif table == "synthetic":
        kw = dict(compute_factor=3.0, dma_bytes_per_cycle=2.0,
                  pipeline_overhead_cycles=7.0, per_call_overhead_cycles=9.0,
                  clock_hz=2e9)
        jt, tt = jcal.CalibrationTable(**kw), CalibrationTable(**kw)
    else:
        path = str(ROOT / table)
        jt, tt = jcal.CalibrationTable.load(path), CalibrationTable.load(path)
    plan = getattr(network, net)(input_shape=shape)
    psums = dict(plan.psum_table())
    names = plan.node_names()
    plans = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
    n_priced = 0
    for i, sp in enumerate(plan.layers):
        tp = plans[i]
        jp = None if tp is None else jbanking.TilePlan(
            **dataclasses.asdict(tp))
        got = tpredicted(psums[names[i]], tp, tt, tperf.IPCoreConfig())
        want = jpredicted(sp.kind, psums[names[i]], jp, jt,
                          jperf.IPCoreConfig())
        assert got == want, names[i]
        n_priced += got is not None
    assert n_priced > 0


def test_drift_detector_band_floor_and_events():
    rec = LayerProfile(index=0, name="c1", kind="conv", wall_us=100.0,
                       psums=1000, batch=1, gops=0.01, predicted_us=110.0,
                       pipelined=False, calibrated=False)
    assert DriftDetector().check([rec]) == []        # ratio ~0.9
    fast = LayerProfile(index=1, name="c2", kind="conv", wall_us=10.0,
                        psums=1000, batch=1, gops=0.1, predicted_us=110.0,
                        pipelined=False, calibrated=False)
    assert len(DriftDetector().check([fast])) == 1   # ratio ~0.09
    assert DriftDetector(min_wall_us=50.0).check([fast]) == []
    free = LayerProfile(index=2, name="pool", kind="pool", wall_us=5.0,
                        psums=0, batch=1, gops=0.0, predicted_us=None,
                        pipelined=None, calibrated=False)
    assert DriftDetector().check([free]) == []
    with pytest.raises(ValueError):
        DriftDetector(band=(2.0, 0.5))
    # a band no measured layer can sit in flags every priced layer
    qnet, x = _qnet("lenet", (12, 12, 1))
    before = obs.metrics.counter("obs.drift.events").value
    prof = profile_network(qnet, x, warmup=0,
                           drift=DriftDetector(band=(1e-30, 2e-30)))
    priced = [r for r in prof.records if r.predicted_us]
    assert len(prof.drift) == len(priced) > 0
    assert all(ev.band == (1e-30, 2e-30) for ev in prof.drift)
    assert obs.metrics.counter("obs.drift.events").value - before == \
        len(priced)
    assert DEFAULT_DRIFT_BAND == (0.5, 2.0)


def test_engine_obs_off_records_nothing_and_on_profiles_first_batch():
    qnet, _ = _qnet("lenet", (12, 12, 1))
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, 12, 12, 1)).astype(np.float32)
    eng = ConvNetEngine(qnet, batch=2, device="cpu")
    try:
        eng.submit(imgs)
        assert eng.stats == {"requests": 3, "batches": 2, "padded": 1}
        pct = eng.latency_percentiles()
        assert pct["count"] == 3 and 0 < pct["p50"] <= pct["p99"]
        assert len(obs.tracer) == 0 and eng.layer_profile is None
    finally:
        eng.close()
    obs.enable()
    eng = ConvNetEngine(qnet, batch=2, device="cpu")
    try:
        eng.submit(imgs[:2])
        assert eng.layer_profile.layer_names == qnet.plan.node_names()
        assert eng.drift_events == ()
        names = [e["name"] for e in obs.tracer.events()]
        assert "engine.compile" in names and "engine.batch" in names
        assert "sched.run" in names
        obs.disable()
        n = len(obs.tracer)
        eng.submit(imgs[:2])
        assert len(obs.tracer) == n
    finally:
        eng.close()
