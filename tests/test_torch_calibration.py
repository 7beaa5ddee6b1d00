"""The port's calibration layer and calibrated cost model against the JAX
reference, on the same numpy inputs.

* ``CalibrationTable`` JSON goes both ways: the port reads a table the
  reference wrote and the other way round, the repo's ``CALIBRATION.json``
  (the reference's CPU interpret-mode fit) and ``CALIBRATION_h100.json``
  (the port's fit on the card) included.
* ``fit_calibration`` on seeded synthetic samples recovers the ground
  truth, rejects noisy samples, keeps the 16-cycle default without
  pipelined samples, and gives the reference's coefficients and
  diagnostics within 1e-9 relative.
* ``sample_from_plan``, ``pipeline_estimate``, ``calibrated_cycles``,
  ``network_report`` and ``train_report`` equal the reference's on the
  zoo under no table, ``CALIBRATION.json`` and a synthetic table; the §5.2
  anchors stay exact with no table; a fitted overhead flips the crossover.
* ``h100_conv_roofline`` is sane; the sweep's grid is the reference's
  (``benchmarks/calibrate.py``) and its timing statistics are
  ``bench_util.Timing``'s.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import banking as jbanking
from repro.core import calibration as jcal
from repro.core import network as jnet
from repro.core import perfmodel as jperf
from repro_torch.core import banking as tbanking
from repro_torch.core import calibration as tcal
from repro_torch.core import calibration_sweep as sweep
from repro_torch.core import network as tnet
from repro_torch.core import perfmodel as tperf
from repro_torch.core.convcore import ConvCore, ConvCoreConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))            # benchmarks/ (the reference sweep)

ZOO = ("lenet", "vgg_small", "vgg_imagenet", "large_map", "resnet_small",
       "mobilenet_small", "mobilenet_v2ish", "resnet_bottleneck",
       "dilated_context", "unet_small")
SYNTH = dict(compute_factor=2.0, dma_bytes_per_cycle=4.0,
             pipeline_overhead_cycles=32.0, per_call_overhead_cycles=500.0)
TABLES = ("none", "CALIBRATION.json", "synthetic")


def tables(name):
    """(reference table, port table) of one ``TABLES`` entry."""
    if name == "none":
        return None, None
    if name == "synthetic":
        return jcal.CalibrationTable(**SYNTH), tcal.CalibrationTable(**SYNTH)
    path = str(ROOT / name)
    return jcal.CalibrationTable.load(path), tcal.CalibrationTable.load(path)


def fields(p):
    return None if p is None else dataclasses.asdict(p)


# -- the table ---------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_table_json_round_trip_both_ways(writer, tmp_path):
    kw = dict(compute_factor=3.89, dma_bytes_per_cycle=2.5,
              pipeline_overhead_cycles=40.0, per_call_overhead_cycles=7.0,
              clock_hz=1e9, fit={"n_fit": 12, "terms_fit": ["a", "b"]},
              provenance={"mode": "test"})
    src, dst = ((jcal, tcal) if writer == "reference" else (tcal, jcal))
    t = src.CalibrationTable(**kw)
    path = tmp_path / "calib.json"
    t.save(str(path))
    back = dst.CalibrationTable.load(str(path))
    assert back.to_dict() == t.to_dict()
    assert dst.CalibrationTable.from_json(t.to_json()).to_dict() == \
        t.to_dict()
    assert src.CalibrationTable.from_json(back.to_json()) == t
    assert dst.load_table(str(path)).to_dict() == t.to_dict()
    assert dst.load_table(str(tmp_path / "missing.json")) is None
    assert dst.load_table(None) is None and dst.load_table("") is None


@pytest.mark.parametrize("name", ["CALIBRATION.json",
                                  "CALIBRATION_h100.json"])
def test_repo_tables_read_in_both_packages(name):
    path = str(ROOT / name)
    j, t = jcal.CalibrationTable.load(path), tcal.CalibrationTable.load(path)
    assert t.to_dict() == j.to_dict() == json.loads(Path(path).read_text())
    for args in ((10_000, 5_000, 4, True), (123, 0, 1, False)):
        assert t.predicted_cycles(*args) == j.predicted_cycles(*args)
        assert t.predicted_us(*args) == j.predicted_us(*args)
    if name == "CALIBRATION_h100.json":
        prov = t.provenance
        assert prov["mode"] == "native" and "H100" in prov["card"]
        assert prov["card"].rstrip().endswith("W")   # the power limit
        assert prov["smoke"] is False
        assert len(prov["grid"]["shapes"]) == len(sweep.SHAPES)
        assert t.fit["n_samples"] == len(sweep.grid())
        assert set(t.fit["terms_fit"]) <= set(tcal.TERMS)


def test_table_defaults_are_analytic():
    t = tcal.CalibrationTable()
    assert t.compute_factor == 1.0 and t.dma_bytes_per_cycle is None
    assert t.pipeline_overhead_cycles == tperf.PIPELINE_OVERHEAD_CYCLES
    assert t.to_dict() == jcal.CalibrationTable().to_dict()
    assert tcal.NOISE_IQR_FRACTION == jcal.NOISE_IQR_FRACTION
    assert tperf.pipeline_overhead_cycles(None) == 16
    assert tperf.pipeline_overhead_cycles(
        tcal.CalibrationTable(pipeline_overhead_cycles=64.0)) == 64.0


# -- the fit -----------------------------------------------------------------

TRUTH = dict(cf=3.89, bpc=2.5, ov=40.0, call=900.0)
CASES = [  # (compute_cycles, dma_bytes, n_slabs, pipelined)
    (2_000_000, 1_000_000, 8, True), (1_500_000, 4_000_000, 16, True),
    (500_000, 8_000_000, 32, True), (3_000_000, 200_000, 4, True),
    (800_000, 2_500_000, 64, True), (50_000, 100_000, 128, True),
    (20_000, 50_000, 256, True), (1_000_000, 1_000_000, 1, False),
    (2_500_000, 500_000, 1, False), (100_000, 6_000_000, 1, False),
]


def synthetic(pkg, call=0.0, noise_sd=0.002, seed=0, cases=CASES):
    """Seeded samples of the ground-truth model, as ``pkg``'s
    ``CalibrationSample``s (measured at the default 112 MHz clock)."""
    clock = 112e6
    rng = np.random.default_rng(seed)
    out = []
    for i, (cc, db, ns, pl) in enumerate(cases):
        cyc = (TRUTH["cf"] * cc + db / TRUTH["bpc"]
               + (TRUTH["ov"] * ns if pl else 0) + call)
        us = cyc / clock * 1e6 * (1.0 + rng.normal(0, noise_sd))
        out.append(pkg.CalibrationSample(
            name=f"s{i}", compute_cycles=cc, dma_bytes=db, n_slabs=ns,
            pipelined=pl, measured_us=us, iqr_us=us * 0.001))
    return out


def test_fit_recovers_ground_truth():
    table = tcal.fit_calibration(synthetic(tcal, call=TRUTH["call"]),
                                 provenance={"mode": "synthetic"})
    assert abs(table.compute_factor - TRUTH["cf"]) < 0.05
    assert abs(table.dma_bytes_per_cycle - TRUTH["bpc"]) < 0.1
    assert abs(table.pipeline_overhead_cycles - TRUTH["ov"]) < 8
    assert abs(table.per_call_overhead_cycles - TRUTH["call"]) < 300
    assert table.fit["n_rejected_noisy"] == 0
    assert table.fit["mean_abs_error_pct"] < 2.0
    assert table.provenance == {"mode": "synthetic"}


def test_fit_rejects_noisy_samples():
    wild = tcal.CalibrationSample(
        name="wild", compute_cycles=1_000_000, dma_bytes=1_000_000,
        n_slabs=4, pipelined=True, measured_us=1e6, iqr_us=9e5)
    assert wild.noisy
    table = tcal.fit_calibration(synthetic(tcal) + [wild])
    assert table.fit["n_rejected_noisy"] == 1
    assert table.fit["n_fit"] == len(CASES)
    assert abs(table.compute_factor - TRUTH["cf"]) < 0.05
    with pytest.raises(ValueError, match="no usable samples"):
        tcal.fit_calibration([wild])
    assert tcal.fit_calibration([wild], reject_noisy=False).fit[
        "n_fit"] == 1


def test_fit_without_pipelined_samples_keeps_default_overhead():
    table = tcal.fit_calibration([s for s in synthetic(tcal)
                                  if not s.pipelined])
    assert table.pipeline_overhead_cycles == tperf.PIPELINE_OVERHEAD_CYCLES
    assert "pipeline_overhead_cycles" not in table.fit["terms_fit"]


def test_fit_takes_factors_far_below_one():
    """The card's microseconds are a few model cycles at 112 MHz: the fit
    must find a tiny compute factor and a large per-call overhead."""
    rng = np.random.default_rng(3)
    samples = []
    for i in range(20):
        cc = int(rng.integers(10_000, 50_000_000))
        db = int(rng.integers(1_000, 20_000_000))
        cyc = 1e-4 * cc + db / 5000.0 + 1500.0
        us = cyc / 112e6 * 1e6
        samples.append(tcal.CalibrationSample(f"s{i}", cc, db, 1, False, us))
    t = tcal.fit_calibration(samples)
    assert t.compute_factor == pytest.approx(1e-4, rel=1e-3)
    assert t.dma_bytes_per_cycle == pytest.approx(5000.0, rel=1e-3)
    assert t.per_call_overhead_cycles == pytest.approx(1500.0, rel=1e-3)
    assert t.predicted_us(1_000_000, 0) == pytest.approx(
        (100.0 + 1500.0) / 112, rel=1e-3)


def _rel_equal(a, b, rel=1e-9):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_rel_equal(x, y, rel)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)
    return a == b


@pytest.mark.parametrize("case", ["clean", "call", "noisy", "seq_only",
                                  "random", "h100_scale"])
def test_fit_equals_reference(case):
    def samples(pkg):
        if case == "clean":
            return synthetic(pkg)
        if case == "call":
            return synthetic(pkg, call=TRUTH["call"], noise_sd=0.05, seed=4)
        if case == "noisy":
            return synthetic(pkg) + [pkg.CalibrationSample(
                "wild", 10, 10, 2, True, measured_us=5.0, iqr_us=4.0)]
        if case == "seq_only":
            return [s for s in synthetic(pkg) if not s.pipelined]
        rng = np.random.default_rng(8)
        scale = 1e-5 if case == "h100_scale" else 1.0
        return [pkg.CalibrationSample(
            f"r{i}", int(rng.integers(0, 10**8)), int(rng.integers(0, 10**7)),
            int(rng.integers(1, 300)), bool(rng.random() < 0.5),
            float(rng.uniform(1, 1e5) * scale),
            float(rng.uniform(0, 1e4) * scale)) for i in range(40)]
    j = jcal.fit_calibration(samples(jcal), provenance={"p": 1})
    t = tcal.fit_calibration(samples(tcal), provenance={"p": 1})
    jd, td = j.to_dict(), t.to_dict()
    assert td.keys() == jd.keys() and td["fit"].keys() == jd["fit"].keys()
    for key in ("compute_factor", "dma_bytes_per_cycle",
                "pipeline_overhead_cycles", "per_call_overhead_cycles",
                "clock_hz"):
        assert _rel_equal(td[key], jd[key]), (key, td[key], jd[key])
    for key, v in jd["fit"].items():
        assert _rel_equal(td["fit"][key], v), (key, td["fit"][key], v)
    assert td["provenance"] == jd["provenance"]


# -- the calibrated model ----------------------------------------------------

def _conv_layers(net):
    """(plan, psums) of every conv node of ``net`` under the port's
    greedy Hopper plans, and the reference plan built from the same
    fields."""
    plan = getattr(tnet, net)()
    psums = dict(plan.psum_table())
    names = plan.node_names()
    for i, tp in enumerate(plan.tile_plans()):
        if tp is not None:
            yield tp, jbanking.TilePlan(**dataclasses.asdict(tp)), \
                psums[names[i]]


@pytest.mark.parametrize("net", ZOO)
def test_sample_from_plan_terms_equal_reference(net):
    for tp, jp, psums in _conv_layers(net):
        t = tcal.sample_from_plan("l", tp, psums, 12.5, 0.5, shape=[1])
        j = jcal.sample_from_plan("l", jp, psums, 12.5, 0.5, shape=[1])
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.compute_cycles == tperf.cycles(psums)
        assert t.dma_bytes == tperf.tile_traffic(tp)["total_bytes"]
        assert t.n_slabs == tperf.pipeline_slabs(tp)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("net", ZOO)
def test_calibrated_model_equals_reference(net, table):
    jt, tt = tables(table)
    for tp, jp, psums in _conv_layers(net):
        for cfg in (tperf.IPCoreConfig(), tperf.IPCoreConfig(ip_cores=20)):
            jcfg = jperf.IPCoreConfig(**dataclasses.asdict(cfg))
            assert tperf.pipeline_estimate(tp, psums, cfg, tt) == \
                jperf.pipeline_estimate(jp, psums, jcfg, jt)
            assert tperf.calibrated_cycles(psums, cfg, tt) == \
                jperf.calibrated_cycles(psums, jcfg, jt)
            assert tperf.dma_cycles(psums, cfg, tt) == \
                jperf.dma_cycles(psums, jcfg, jt)
    assert tperf.pipeline_overhead_cycles(tt) == \
        jperf.pipeline_overhead_cycles(jt)
    tplan, jplan = getattr(tnet, net)(), getattr(jnet, net)()
    plans = tplan.tile_plans()
    jplans = [None if p is None else jbanking.TilePlan(
        **dataclasses.asdict(p)) for p in plans]
    for tiles, jtiles in ((None, None), (plans, jplans)):
        assert tplan.perf_report(tile_plans=tiles, calib=tt) == \
            jplan.perf_report(tile_plans=jtiles, calib=jt)
        assert tplan.train_report(tile_plans=tiles, calib=tt) == \
            jplan.train_report(tile_plans=jtiles, calib=jt)
    # the planner under the table: the port's greedy descent, the
    # reference's crossover verdict at one budget
    got = tplan.tile_plans(smem_budget=tbanking.SMEM_BYTES, calib=tt)
    want = jplan.tile_plans(vmem_budget=tbanking.SMEM_BYTES, calib=jt)
    assert [fields(p) for p in got] == [fields(p) for p in want]


def test_no_table_is_bit_exact_and_anchors_hold():
    nums = tperf.paper_reference_numbers()
    assert nums["psums"] == 3_154_176
    assert nums["gops_1core"] == 0.224
    assert round(nums["gops_20cores"], 2) == 4.48
    assert nums == jperf.paper_reference_numbers()
    plan = tbanking.plan_tiles(28, 28, 8, 16, in_bytes=1)
    psums = tperf.psum_count(28, 28, 8, 16)
    assert tperf.pipeline_estimate(plan, psums) == \
        tperf.pipeline_estimate(plan, psums, calib=None)
    assert tperf.calibrated_cycles(psums) == tperf.cycles(psums)
    net = tnet.lenet()
    tps = net.tile_plans()
    assert tps == net.tile_plans(calib=None)
    assert net.perf_report(tile_plans=tps) == \
        net.perf_report(tile_plans=tps, calib=None)
    assert net.train_report(tile_plans=tps) == \
        net.train_report(tile_plans=tps, calib=None)


def test_crossover_verdict_flips_with_fitted_overhead():
    plan16 = tbanking.plan_tiles(6, 6, 8, 8, in_bytes=1, kernel="auto")
    assert plan16.pipelined
    plan64 = tbanking.plan_tiles(
        6, 6, 8, 8, in_bytes=1, kernel="auto",
        calib=tcal.CalibrationTable(pipeline_overhead_cycles=64.0))
    assert not plan64.pipelined
    # the per-call overhead is the same for both variants: no flip
    plan_call = tbanking.plan_tiles(
        6, 6, 8, 8, in_bytes=1, kernel="auto",
        calib=tcal.CalibrationTable(per_call_overhead_cycles=1e6))
    assert plan_call.pipelined


@pytest.mark.parametrize("calib", [None, tcal.CalibrationTable(**SYNTH)])
def test_convcore_config_threads_calib(calib):
    plan = tnet.lenet()
    cfg = ConvCoreConfig(int8=True, calib=calib)
    assert tnet.program_tile_plans(plan, cfg) == plan.tile_plans(calib=calib)
    flip = tcal.CalibrationTable(pipeline_overhead_cycles=1e9)
    got = tnet.program_tile_plans(plan, ConvCoreConfig(int8=True, calib=flip))
    assert not any(p.pipelined for p in got if p is not None)
    assert any(p.pipelined for p in plan.tile_plans() if p is not None)
    core = ConvCore(ConvCoreConfig(int8=True, calib=flip))
    assert not core.plan((1, 6, 6, 8), (3, 3, 8, 8)).pipelined


def test_h100_roofline_sane():
    r = tperf.h100_conv_roofline(224, 224, 8, 8)
    assert r["seconds"] > 0
    assert r["t_memory"] > r["t_compute"]     # the §5.2 layer: bytes bound
    assert r["gops_paper"] > 0.224 * 1000     # and far past the FPGA
    assert r["t_memory"] == pytest.approx(r["bytes"] / 3.35e12)
    fat = tperf.h100_conv_roofline(56, 56, 256, 256)
    assert fat["t_compute"] > fat["t_memory"]
    f32 = tperf.h100_conv_roofline(56, 56, 256, 256, in_bytes=4,
                                   peak_ops=tperf.F32_OPS_PER_S)
    assert f32["seconds"] > fat["seconds"] * 20
    assert (tperf.HBM_BYTES_PER_S, tperf.INT8_OPS_PER_S,
            tperf.BF16_OPS_PER_S, tperf.F32_OPS_PER_S) == (
        3.35e12, 1979e12, 989e12, 67e12)


# -- the sweep on the CPU: its grid and its statistics -----------------------

def test_sweep_grid_is_the_reference_grid():
    from benchmarks import calibrate as ref
    assert sweep.SHAPES == ref._SHAPES
    assert sweep.BANKS == ref._BANKS
    assert sweep.EPILOGUES == ref._EPILOGUES
    assert sweep.SMOKE_SHAPES == ref._SMOKE_SHAPES
    assert sweep.SMOKE_EPILOGUES == ref._SMOKE_EPILOGUES
    assert sweep.TRANSPOSE_STRIDE == ref._TRANSPOSE_STRIDE
    for smoke, n_grid in ((False, 128), (True, 24)):
        pts = sweep.grid(smoke)
        assert len(pts) == n_grid + 12
        for p in pts[:n_grid]:
            h, w, c, k, kh = p.meta["shape"]
            budget = sweep.TILED_BUDGET if p.label.startswith("tiledmap") \
                else None
            if p.op == "transpose":
                from repro.kernels.conv2d_ws_trans import \
                    transpose_eq_conv_geometry
                ph, pw, pad = transpose_eq_conv_geometry(
                    h, w, kh, kh, 2, p.kw["padding"], 1)
                psums = jperf.conv_transpose_psum_count(
                    h, w, c, k, kh, kh, stride=2, padding=p.kw["padding"])
            else:
                ph, pw, pad = h, w, p.kw["padding"]
                psums = jperf.psum_count(h, w, c, k, kh, kh, padding=pad,
                                         groups=p.meta["groups"],
                                         dilation=p.kw["dilation"])
            want = jbanking.plan_tiles(
                ph, pw, c, k, kh, kh, padding=pad, groups=p.meta["groups"],
                dilation=p.kw["dilation"], pool=p.kw["pool"], in_bytes=1,
                out_bytes=1 if p.out_scale is not None else 4,
                cin_banks=p.plan.cin_banks, kout_banks=p.plan.kout_banks,
                vmem_budget=budget,
                kernel="pipelined" if p.label.endswith("pipe")
                else "sequential")
            want = dataclasses.replace(want, budget=p.plan.budget)
            assert fields(p.plan) == fields(want), p.label
            assert p.psums == psums and p.batch == 1


def test_sweep_main_path_points_and_their_terms():
    pts = [p for p in sweep.grid(True) if p.label.startswith("vgg_imagenet")]
    plan = tnet.vgg_imagenet()
    want = [p for p in tnet.program_tile_plans(plan, ConvCoreConfig(
        int8=True, kernel="sequential")) if p is not None]
    assert len(pts) == 12 and [p.plan for p in pts[::2]] == want
    assert all(p.plan.pipelined for p in pts[1::2])
    for p in pts:
        assert p.batch == sweep.MAIN_BATCH == p.x_shape[0] == 8
        assert p.x_shape[1:3] in ((224, 224), (112, 112), (56, 56),
                                  (28, 28), (14, 14))
        s = sweep._sample(p, 100.0, 5.0, {"conv_path": "tc"})
        one = tcal.sample_from_plan("x", p.plan, p.psums, 100.0)
        assert s.compute_cycles == tperf.cycles(8 * p.psums)
        assert (s.dma_bytes, s.n_slabs) == (8 * one.dma_bytes,
                                            8 * one.n_slabs)
        assert s.pipelined == p.plan.pipelined


def test_sweep_launch_plans_follow_the_path_rule():
    paths = {}
    for p in sweep.grid(False):
        geom = sweep.launch_geometry(p)
        lp = sweep.launch_plan(geom)
        paths.setdefault(p.label.split("/")[0], set()).add(lp["conv_path"])
        if lp["conv_path"] == "tc":
            assert lp["bn"] in (32, 64) and 1 <= lp["slots"] <= lp["stages"]
            assert lp["stages"] == 1 or geom["pipelined"]
        elif lp["conv_path"] == "dw":
            assert lp["slots"] == 1 + geom["pipelined"]
            assert lp["kc"] % 4 == 0 and lp["rh"] * lp["rw"] * lp["kc"] == \
                256 * 4 * 4
        elif lp["conv_path"] == "nk":
            assert lp["slots"] in (1, 2) and lp["gr"] in (1, 2, 4, 8)
            assert lp["rh"] * lp["rw"] * lp["gr"] <= 256 * 4
        else:
            assert {"th", "tw", "kb"} <= set(lp)
    assert paths.pop("depthwise") == {"dw"}
    assert all(v == {"tc"} for v in paths.values()), paths


@pytest.mark.parametrize("samples", [
    [4.0, 1.0, 3.0, 2.0], [5.0, 1.0, 3.0, 2.0, 4.0], [7.0],
    list(np.random.default_rng(2).uniform(1, 100, 30)),
    list(np.random.default_rng(3).uniform(1, 100, 11))])
def test_median_iqr_is_bench_util_timing(samples):
    from benchmarks.bench_util import Timing
    t = Timing(samples)
    assert sweep.median_iqr(samples) == (t.median_us, t.iqr_us)
    with pytest.raises(ValueError):
        sweep.median_iqr([])


def test_sweep_needs_the_card_and_keeps_off_the_reference_table(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sweep.sweep(smoke=True)
    with pytest.raises(ValueError, match="reference's table"):
        sweep.run(str(tmp_path / "CALIBRATION.json"), smoke=True)
    assert not (tmp_path / "CALIBRATION.json").exists()
    assert os.path.exists(ROOT / "CALIBRATION.json")
