"""The port's trainer against the JAX reference on the CPU.

* The QAT straight-through estimators: forward within 1e-6 of the
  reference's, backward exactly the identity, and the weight grid the one
  ``quantize_network`` lowers to.
* ``adamw_update`` and the schedules within 1e-6 of the reference's on the
  same inputs; ``torch.optim.AdamW`` is another update.
* ``synthetic_digits`` / ``synthetic_segmentation`` give the reference's
  arrays for the same seed.
* ``fit`` on ``lenet`` (12×12×1, 25 steps) follows the reference's loss
  history within 1e-3 and learns (last loss under half the first).
* The port's QAT round trip on the CPU (train, ``quantize_network``,
  ``make_int8_program``) holds the reference's bar: float accuracy ≥ 0.9,
  int8 within 0.02 of it.
* ``train_report`` / ``network_report`` equal the reference's, with and
  without a calibration table.
* Entry points refuse to pick the CPU themselves.

One train step from a carried-across state, on five zoo plans, is in
``test_torch_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import perfmodel as jperf
from repro.core import quantize as jq
from repro.core import training as jtr
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.core import network as tnet
from repro_torch.core import perfmodel as tperf
from repro_torch.core import quantize as tq
from repro_torch.core import training as ttr
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched

RNG = np.random.default_rng(5)


# ---------------------------------------------------------------------------
# straight-through estimators
# ---------------------------------------------------------------------------


def test_fake_quantize_forward_and_identity_backward():
    x = (RNG.normal(size=(257,)) * 3).astype(np.float32)
    x[:3] = [0.125, -0.375, 20.0]                  # a tie, another, a clip
    want = np.asarray(jq.fake_quantize(jnp.asarray(x), jnp.float32(0.25)))
    t = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quantize(t, 0.25)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    probe = torch.arange(257, dtype=torch.float32)
    (g,) = torch.autograd.grad(got, t, probe)
    assert torch.equal(g, probe)


@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_weight_is_the_deployment_grid(per_channel):
    w = RNG.normal(size=(3, 3, 4, 8)).astype(np.float32)
    want = np.asarray(jq.fake_quant_weight(jnp.asarray(w), per_channel))
    t = torch.from_numpy(w).requires_grad_()
    got = tq.fake_quant_weight(t, per_channel)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    wq = tq.quantize_symmetric(torch.from_numpy(w),
                               axis=(0, 1, 2) if per_channel else None)
    np.testing.assert_allclose(got.detach().numpy(),
                               (wq.values.float() * wq.scale).numpy(),
                               rtol=1e-5, atol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), t)
    assert torch.equal(g, torch.ones_like(t))


def test_fake_quant_act_equals_reference():
    x = RNG.normal(size=(4, 5, 5, 3)).astype(np.float32)
    want = np.asarray(jq.fake_quant_act(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quant_act(t)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), t)
    assert torch.equal(g, torch.ones_like(t))


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["warmup_cosine", "constant"])
def test_schedules_equal_reference(name):
    for step in (0, 1, 19, 20, 21, 200, 399, 400, 1000):
        kw = dict(peak_lr=3e-3, warmup_steps=20, total_steps=400)
        want = float(jsched.SCHEDULES[name](jnp.int32(step), **kw))
        got = tsched.SCHEDULES[name](torch.tensor(step, dtype=torch.int32),
                                     **kw)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want)), step


def _tree(rng, scale=1.0):
    return [{"w": (rng.normal(size=(3, 3, 2, 4)) * scale).astype(np.float32),
             "b": (rng.normal(size=(4,)) * scale).astype(np.float32)},
            None,
            {"w": (rng.normal(size=(16, 5)) * scale).astype(np.float32),
             "b": (rng.normal(size=(5,)) * scale).astype(np.float32)}]


def _to_t(tree):
    return tadamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("step,clip", [(0, 1.0), (7, 1.0), (25, 0.0),
                                       (300, 1e3)])
def test_adamw_update_equals_reference(step, clip):
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, 0.3)
    m, v = _tree(rng, 0.01), jax.tree.map(np.abs, _tree(rng, 0.01))
    hp = dict(peak_lr=3e-3, warmup_steps=20, total_steps=400,
              weight_decay=1e-4, grad_clip_norm=clip)
    jp, jst, jm = jadamw.adamw_update(
        params, grads, {"m": m, "v": v}, jnp.int32(step),
        jadamw.AdamWConfig(**hp))
    tp, tst, tm = tadamw.adamw_update(
        _to_t(params), _to_t(grads), {"m": _to_t(m), "v": _to_t(v)},
        torch.tensor(step, dtype=torch.int32), tadamw.AdamWConfig(**hp))
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves((jp, jst["m"], jst["v"])),
                    tadamw.tree_leaves((tp, tst["m"], tst["v"]))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    # torch.optim.AdamW applies the decay before the moment step
    p0 = torch.from_numpy(params[0]["w"].copy()).requires_grad_()
    opt = torch.optim.AdamW([p0], lr=float(tm["lr"]), betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=1e-4)
    p0.grad = torch.from_numpy(grads[0]["w"].copy())
    opt.step()
    assert not torch.equal(p0.detach(), tp[0]["w"])


# ---------------------------------------------------------------------------
# data, fit, the QAT round trip
# ---------------------------------------------------------------------------


def test_synthetic_data_equals_reference():
    for fn, kw in (("synthetic_digits", {}),
                   ("synthetic_digits", dict(input_shape=(13, 11, 4),
                                             classes=7)),
                   ("synthetic_segmentation", {}),
                   ("synthetic_segmentation", dict(input_shape=(18, 14, 3),
                                                   classes=5))):
        jx, jy = getattr(jtr, fn)(np.random.default_rng(9), 24, **kw)
        tx, ty = getattr(ttr, fn)(np.random.default_rng(9), 24, device="cpu",
                                  **kw)
        assert tx.dtype == torch.float32 and ty.dtype == torch.int32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_fit_lenet_follows_reference_and_learns():
    jplan = jnet.lenet(input_shape=(12, 12, 1))
    tplan = tnet.lenet(input_shape=(12, 12, 1))
    x, y = ttr.synthetic_digits(np.random.default_rng(1), 256, device="cpu")
    _, jh = jtr.fit(jplan, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                    steps=25, batch=32, seed=2)
    state, th = ttr.fit(tplan, x, y, steps=25, batch=32, seed=2,
                        device="cpu")
    assert int(state.step) == 25 and state.step.dtype == torch.int32
    for a, b in zip(jh, th):
        assert abs(a["loss"] - b["loss"]) <= 1e-3, (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-3 * max(
            1.0, a["grad_norm"])
    assert th[-1]["loss"] < th[0]["loss"] * 0.5
    assert all(np.isfinite(h["grad_norm"]) for h in th)


@pytest.mark.parametrize("per_channel", [False, True])
def test_lenet_qat_roundtrip_on_the_cpu_within_2pct(per_channel):
    plan = tnet.lenet(input_shape=(12, 12, 1))
    rng = np.random.default_rng(7)
    x, y = ttr.synthetic_digits(rng, 384, device="cpu")
    xe, ye = ttr.synthetic_digits(rng, 192, device="cpu")
    cfg = ttr.TrainConfig(qat=True, per_channel=per_channel)
    state, _ = ttr.fit(plan, x, y, steps=50, batch=32, cfg=cfg, seed=8,
                       device="cpu")
    float_acc = float(ttr.accuracy(
        ttr.float_forward(plan, state.params, xe), ye))
    assert float_acc >= 0.9, float_acc
    assert float(ttr.make_eval_step(plan)(state.params, xe, ye)[1]) == \
        float_acc
    qnet = tnet.quantize_network(plan, state.params, x[:128],
                                 per_channel=per_channel)
    program = tnet.make_int8_program(qnet, ConvCoreConfig(int8=True))
    int8_acc = float(ttr.accuracy(program(xe), ye))
    assert abs(float_acc - int8_acc) <= 0.02, (float_acc, int8_acc)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    plan = tnet.lenet(input_shape=(12, 12, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_train_state(plan, np.random.default_rng(0))
    x, y = ttr.synthetic_digits(np.random.default_rng(0), 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.fit(plan, x, y, steps=1, batch=4)


# ---------------------------------------------------------------------------
# the §5.2 cycle model of a training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", ["lenet", "vgg_imagenet", "unet_small",
                                  "mobilenet_small"])
def test_reports_equal_reference(make):
    jplan, tplan = getattr(jnet, make)(), getattr(tnet, make)()
    for tiled in (False, True):
        # the port plans tiles for a Hopper block, the reference for
        # VMEM: both models price the port's plans
        tt = tplan.tile_plans() if tiled else None
        assert tplan.perf_report(tile_plans=tt) == \
            jplan.perf_report(tile_plans=tt)
        assert tplan.train_report(tile_plans=tt) == \
            jplan.train_report(tile_plans=tt)
    assert tperf.pipeline_overhead_cycles() == jperf.pipeline_overhead_cycles()
    assert tperf.calibrated_cycles(12345) == jperf.calibrated_cycles(12345)
    rep = tplan.train_report()
    assert rep["psums"] == 3 * rep["forward"]["psums"]
    nums = tperf.paper_reference_numbers()
    assert (nums["psums"], round(nums["gops_1core"], 3),
            round(nums["gops_20cores"], 2)) == (3_154_176, 0.224, 4.48)


def test_reports_under_a_table_equal_reference():
    from repro.core.calibration import CalibrationTable as JTable
    from repro_torch.core.calibration import CalibrationTable as TTable
    kw = dict(compute_factor=0.5, dma_bytes_per_cycle=3.0,
              pipeline_overhead_cycles=20.0, per_call_overhead_cycles=40.0)
    jplan, tplan = jnet.lenet(), tnet.lenet()
    tt = tplan.tile_plans()
    assert tplan.train_report(tile_plans=tt, calib=TTable(**kw)) == \
        jplan.train_report(tile_plans=tt, calib=JTable(**kw))
    assert tplan.train_report(tile_plans=tt, calib=TTable(**kw)) != \
        tplan.train_report(tile_plans=tt)
    assert tperf.calibrated_cycles(10, calib=TTable(**kw)) == \
        jperf.calibrated_cycles(10, calib=JTable(**kw))
