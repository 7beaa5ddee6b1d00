"""The port's plan autotuner (``repro_torch.core.autotune``) against the
JAX reference's.

* ``autotune_network``, ``schedule_cycles`` and ``route_batch`` equal the
  reference's field by field (every layer's tuned and greedy plan and
  cycles, the scheduler mode, cores and totals, the route of each formed
  size) on every zoo net, under no table, the repo's ``CALIBRATION.json``
  and ``CALIBRATION_h100.json``, with the same budget passed to both.
* The reference's three properties (``tests/test_autotune_property.py``)
  hold for the port: the tuned plan fits shared memory and respects group
  alignment, is never worse than the greedy plan, and is deterministic
  given a table.  The port legalises bank counts that do not divide the
  layer before planning, so it passes the case where the reference's
  ``plan_tiles`` asserts (h = w = 6, c = k = 1, a 1×1 SAME conv under the
  default 4×4 banks).
* Tuned plans change where tiles fall, never what is computed: the tuned
  program's logits equal the greedy program's and the reference's on
  ``lenet``, ``mobilenet_small`` and ``dilated_context`` (``device="cpu"``).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro.core import autotune as jtune
from repro.core import calibration as jcal
from repro.core import network as jnet
from repro.core.convcore import ConvCoreConfig as JConfig
from repro_torch.core import autotune as ttune
from repro_torch.core import banking as tbanking
from repro_torch.core import calibration as tcal
from repro_torch.core import network as tnet
from repro_torch.core import scheduler as tsched
from repro_torch.core.convcore import ConvCoreConfig
from test_torch_program import carry, jax_quantize

ROOT = Path(__file__).resolve().parents[1]
ZOO = ("lenet", "vgg_small", "vgg_imagenet", "large_map", "resnet_small",
       "mobilenet_small", "mobilenet_v2ish", "resnet_bottleneck",
       "dilated_context", "unet_small")
TABLES = ("none", "CALIBRATION.json", "CALIBRATION_h100.json")
BUDGET = tbanking.SMEM_BYTES
SYNTH = dict(compute_factor=2.0, dma_bytes_per_cycle=4.0,
             pipeline_overhead_cycles=32.0)


def tables(name):
    if name == "none":
        return None, None
    path = str(ROOT / name)
    return jcal.CalibrationTable.load(path), tcal.CalibrationTable.load(path)


def fields(p):
    return None if p is None else dataclasses.asdict(p)


def layer_fields(lt):
    d = {f.name: getattr(lt, f.name) for f in dataclasses.fields(lt)}
    d["plan"], d["greedy_plan"] = fields(lt.plan), fields(lt.greedy_plan)
    return d


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("net", ZOO)
def test_autotune_network_equals_reference(net, table):
    jt, tt = tables(table)
    want = jtune.autotune_network(getattr(jnet, net)(), vmem_budget=BUDGET,
                                  calib=jt)
    got = ttune.autotune_network(getattr(tnet, net)(), smem_budget=BUDGET,
                                 calib=tt)
    assert [layer_fields(lt) for lt in got.layers] == \
        [layer_fields(lt) for lt in want.layers]
    for f in ("network", "scheduler_mode", "n_cores", "cycles",
              "greedy_cycles", "schedule_cycles_", "calibrated"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.layers_differ, got.speedup, got.layer_rows()) == \
        (want.layers_differ, want.speedup, want.layer_rows())
    for mode in ttune.SCHEDULER_MODES:
        for cores in (1, 3, 4, 20):
            assert ttune.schedule_cycles(got.layers, mode, cores,
                                         calib=tt) == \
                jtune.schedule_cycles(want.layers, mode, cores, calib=jt)
    for batch in (1, 2, 5, 8):
        for cores in (1, 4, 8):
            assert ttune.route_batch(got.layers, batch, cores, calib=tt) == \
                jtune.route_batch(want.layers, batch, cores, calib=jt)


@pytest.mark.parametrize("kw", [
    dict(h=28, w=28, c=8, k=16),
    dict(h=64, w=64, c=16, k=16, smem_budget=96 * 1024),
    dict(h=32, w=32, c=32, k=32, groups=32, pool=True, cin_banks=1,
         kout_banks=32),
    dict(h=16, w=16, c=16, k=32, kh=1, kw=1, stride=2, padding="SAME"),
    dict(h=20, w=20, c=8, k=8, dilation=2, padding="SAME",
         cin_banks=8, kout_banks=8),
    dict(h=9, w=9, c=4, k=8, psums=1234, in_bytes=4, out_bytes=4)])
@pytest.mark.parametrize("table", ["none", "synthetic"])
def test_autotune_layer_equals_reference(kw, table):
    jt, tt = ((None, None) if table == "none" else
              (jcal.CalibrationTable(**SYNTH), tcal.CalibrationTable(**SYNTH)))
    jkw = dict(kw)
    if "smem_budget" in jkw:
        jkw["vmem_budget"] = jkw.pop("smem_budget")
    else:
        jkw["vmem_budget"] = BUDGET
    got = ttune.autotune_layer(**kw, calib=tt)
    want = jtune.autotune_layer(**jkw, calib=jt)
    assert layer_fields(got) == layer_fields(want)
    assert ttune.plan_cost(got.plan, got.psums, calib=tt) == got.cycles
    h_out = got.plan.out_h
    assert ttune.candidate_states(h_out, got.plan.out_w, 4, 4, 1, False) == \
        jtune.candidate_states(h_out, got.plan.out_w, 4, 4, 1, False)


def test_greedy_plan_in_candidate_space():
    greedy = tbanking.plan_tiles(64, 64, 16, 16, in_bytes=1,
                                 smem_budget=96 * 1024)
    assert greedy.tiled
    states = ttune.candidate_states(greedy.out_h, greedy.out_w, 16, 16, 1,
                                    False)
    assert (greedy.h_tile, greedy.w_tile, greedy.cin_banks,
            greedy.kout_banks) in states


def test_network_tune_plan_contract():
    plan = tnet.mobilenet_v2ish()
    calib = tcal.CalibrationTable(**SYNTH)
    tune = ttune.autotune_network(plan, calib=calib)
    assert len(tune.tile_plans) == len(plan.layers)
    assert tune.cycles <= tune.greedy_cycles and tune.calibrated
    rows = tune.layer_rows()
    assert sum(r["plan_source"] == "autotuned" for r in rows) == \
        tune.layers_differ
    cfg = tune.scheduler_config()
    assert cfg == tsched.SchedulerConfig.for_tune(tune)
    assert tsched.MultiCoreScheduler.from_tune(tune).config == cfg
    assert tune.schedule_cycles_ == ttune.schedule_cycles(
        tune.layers, tune.scheduler_mode, tune.n_cores, calib=calib)
    assert [lt.greedy_plan for lt in tune.layers] == tune.greedy_tile_plans
    # every zoo net: tuned ≤ greedy, and the search moves some layer
    differ = 0
    for net in ZOO:
        t = ttune.autotune_network(getattr(tnet, net)())
        assert t.cycles <= t.greedy_cycles, net
        differ += t.layers_differ
    assert differ > 0


def test_route_batch_flips_with_formed_size():
    tune = ttune.autotune_network(tnet.lenet(input_shape=(12, 12, 1)))
    mode1, cores1, cyc1 = ttune.route_batch(tune.layers, 1, 8)
    mode8, cores8, cyc8 = ttune.route_batch(tune.layers, 8, 8)
    assert mode1 in ("kout", "spatial") and cores1 == 8
    assert mode8 == "batch" and cores8 == 8
    assert cyc1 <= ttune.schedule_cycles(tune.layers, "batch", 1)
    assert cyc8 <= 8 * ttune.schedule_cycles(tune.layers, "batch", 8)
    with pytest.raises(ValueError):
        ttune.route_batch(tune.layers, 0, 8)
    with pytest.raises(ValueError):
        ttune.route_batch(tune.layers, 1, 0)


# -- the reference's properties, on the port ----------------------------------

_CALIB = tcal.CalibrationTable(**SYNTH)
# the reference's plan_tiles asserts here: 4×4 banks on c = k = 1
_SMALLEST = dict(h=6, w=6, c=1, k=1, kh=1, stride=1, padding="SAME",
                 groups=1, pool=False)


@st.composite
def _layer_shapes(draw):
    groups = draw(st.sampled_from([1, 1, 1, 2, 4]))
    cgrp = draw(st.sampled_from([1, 2, 4, 8]))
    kg = draw(st.sampled_from([1, 2, 4, 8]))
    h = draw(st.integers(6, 40))
    w = draw(st.integers(6, 40))
    kh = draw(st.sampled_from([1, 3]))
    pool = draw(st.booleans())
    stride = draw(st.sampled_from([1, 2]))
    return dict(h=h, w=w, c=cgrp * groups, k=kg * groups, kh=kh,
                stride=stride, padding="SAME", groups=groups,
                pool=pool and kh == 3 and stride == 1)


@settings(max_examples=30, deadline=None)
@given(shape=_layer_shapes(),
       budget=st.sampled_from([64 * 1024, 512 * 1024, BUDGET]))
@example(shape=_SMALLEST, budget=BUDGET)
def test_autotuned_plan_fits_and_respects_groups(shape, budget):
    lt = ttune.autotune_layer(**shape, smem_budget=budget, calib=_CALIB)
    tp = lt.plan
    assert tp.fits_smem or not lt.greedy_plan.fits_smem
    g = shape["groups"]
    assert (shape["c"] // g) % tp.cin_banks == 0
    assert shape["k"] % tp.kout_banks == 0
    assert tp.kout_banks % g == 0 or tp.kout_banks <= g


@settings(max_examples=30, deadline=None)
@given(shape=_layer_shapes())
@example(shape=_SMALLEST)
def test_autotuned_never_worse_than_greedy(shape):
    for calib in (None, _CALIB):
        lt = ttune.autotune_layer(**shape, calib=calib)
        assert lt.cycles <= lt.greedy_cycles
        assert ttune.plan_cost(lt.plan, lt.psums, calib=calib) == lt.cycles


@settings(max_examples=15, deadline=None)
@given(shape=_layer_shapes())
@example(shape=_SMALLEST)
def test_autotune_deterministic_given_table(shape):
    assert ttune.autotune_layer(**shape, calib=_CALIB) == \
        ttune.autotune_layer(**shape, calib=_CALIB)


def test_illegal_banks_are_legalised_where_the_reference_asserts():
    with pytest.raises(AssertionError, match="banking invariant"):
        jtune.autotune_layer(**_SMALLEST, calib=None)
    lt = ttune.autotune_layer(**_SMALLEST)
    assert (lt.greedy_plan.cin_banks, lt.greedy_plan.kout_banks) == (1, 1)
    # legal counts stay: the verdict equals the reference's there
    assert layer_fields(ttune.autotune_layer(**dict(_SMALLEST, c=4, k=4))) \
        == layer_fields(jtune.autotune_layer(**dict(_SMALLEST, c=4, k=4),
                                             vmem_budget=BUDGET))


# -- tuned plans execute bit-exact ---------------------------------------------

@pytest.mark.parametrize("net,kw", [
    ("lenet", dict(input_shape=(12, 12, 1))),
    ("mobilenet_small", {}),
    ("dilated_context", {})])
def test_tuned_plans_execute_bit_exact(net, kw):
    rng = np.random.default_rng(5)
    jp, tp = getattr(jnet, net)(**kw), getattr(tnet, net)(**kw)
    params = jp.init_params(rng)
    x = rng.normal(size=(2, *jp.input_shape)).astype(np.float32)
    jq = jax_quantize(jp, params, jnp.asarray(x))
    want = np.asarray(jnet.make_int8_program(
        jq, JConfig(backend="ref", int8=True))(jnp.asarray(x)))
    tq = carry(jq, tp)
    cfg = ConvCoreConfig(int8=True)
    greedy = tnet.program_tile_plans(tp, cfg)
    for calib in (None, _CALIB, tcal.CalibrationTable.load(
            str(ROOT / "CALIBRATION_h100.json"))):
        tune = ttune.autotune_network(tp, calib=calib)
        assert tune.network == tp.name
        if calib is _CALIB:
            assert tune.tile_plans != greedy     # the search moved a layer
        tuned = tnet.make_int8_program(tq, cfg, tile_plans=tune.tile_plans)
        np.testing.assert_array_equal(
            tuned(torch.from_numpy(x)).numpy(), want)
    base = tnet.make_int8_program(tq, cfg, tile_plans=greedy)
    np.testing.assert_array_equal(base(torch.from_numpy(x)).numpy(), want)
