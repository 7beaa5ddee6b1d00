"""The port's trainer, checkpointer and training launcher on the CPU,
mirroring the reference's ``tests/test_trainer_fault.py`` and
``tests/test_checkpoint.py``, and held to the JAX package where the two
meet: the straggler monitor's events on one dt sequence, checkpoints
written by either package restored by the other, and a 4-step
``Trainer`` run on the reduced llama3.2-3b from the reference's state
(loss, lr and gradient norm per step within rtol = atol = 1e-4)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_pipeline as jmake_pipeline
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import train_step as jts
from repro.train.trainer import StragglerMonitor as JStragglerMonitor
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import obs
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.launch import train as train_launcher
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import (StragglerMonitor, Trainer,
                                       TrainerConfig)
from test_torch_lm_train_step import configs, port_state, states

TOL = dict(rtol=1e-4, atol=1e-4)
HP = dict(peak_lr=1e-3, warmup_steps=2)


def _trainer(tmp_path, fail_at=(), total=12, state=None, every=4):
    _, cfg = configs(compute_dtype="bfloat16")
    step_fn = make_train_step(cfg, AdamWConfig(**HP, total_steps=total))
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4, seed=0))
    tc = TrainerConfig(total_steps=total, checkpoint_every=every,
                       checkpoint_dir=str(tmp_path), log_every=0,
                       fail_at_steps=tuple(fail_at), async_checkpoint=False)
    return Trainer(tc, step_fn, pipe,
                   port_state(cfg) if state is None else state)


def test_loss_decreases(tmp_path):
    hist = _trainer(tmp_path / "a").run()
    losses = [h["loss"] for h in hist]
    assert len(losses) == 12 and losses[-1] < losses[0], losses


def test_resume_equals_uninterrupted(tmp_path):
    clean = _trainer(tmp_path / "clean").run()
    faulty = _trainer(tmp_path / "faulty", fail_at=(6, 9))
    hist = faulty.run()
    assert faulty.restarts == 2
    # steps 4-5 and 8 ran twice: before the failure and after the restore
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 8,
                                         9, 10, 11]
    want = {h["step"]: h["loss"] for h in clean}
    for h in hist:
        assert h["loss"] == want[h["step"]], h["step"]


def test_failure_at_step_zero_recovers_from_the_first_checkpoint(tmp_path):
    tr = _trainer(tmp_path / "x", fail_at=(0,), total=4)
    hist = tr.run()
    assert tr.restarts == 1 and len(hist) == 4
    assert tr.ckpt.latest_step() == 4


def test_step_span_and_histogram(tmp_path):
    obs.reset()
    obs.enable()
    try:
        hist = _trainer(tmp_path, total=2).run()
        spans = [e for e in obs.tracer.events() if e["name"] ==
                 "trainer.step"]
        assert [e["args"]["step"] for e in spans] == [0, 1]
        assert obs.metrics.histogram("trainer.step_us").count == 2
        assert len(hist) == 2
    finally:
        obs.disable()
        obs.reset()


def test_straggler_events_equal_the_reference():
    dts = [0.1, 0.11, 0.09, 0.1, 0.5, 0.1, 0.12, 0.45, 0.1, 2.0, 0.3, 0.1,
           0.1, 0.9]
    for factor, warmup in ((2.0, 2), (3.0, 5), (1.5, 0)):
        got, want = StragglerMonitor(factor, warmup), JStragglerMonitor(
            factor, warmup)
        flags = [(got.observe(s, dt), want.observe(s, dt))
                 for s, dt in enumerate(dts)]
        assert all(a == b for a, b in flags)
        assert got.events == want.events and got.ema == want.ema
    assert any(a for a, _ in flags)


def test_trajectory_equals_the_reference(tmp_path):
    """Four ``Trainer`` steps of the reduced llama3.2-3b in f32 from the
    reference's state on the same pipeline."""
    jcfg, cfg = configs()
    jstate, state = states(jcfg)
    pipe_kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                   seed=3)
    tc = dict(total_steps=4, checkpoint_every=2, log_every=0,
              async_checkpoint=False)
    want = JTrainer(JTrainerConfig(**tc, checkpoint_dir=str(tmp_path / "j")),
                    jax.jit(jts.make_train_step(
                        jcfg, JAdamWConfig(**HP, total_steps=4))),
                    jmake_pipeline(JDataConfig(**pipe_kw)), jstate).run()
    got = Trainer(TrainerConfig(**tc, checkpoint_dir=str(tmp_path / "t")),
                  make_train_step(cfg, AdamWConfig(**HP, total_steps=4)),
                  make_pipeline(DataConfig(**pipe_kw)), state).run()
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1,
                                                                    2, 3]
    for g, w in zip(got, want):
        for k in ("loss", "lr", "grad_norm", "total_loss"):
            np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=k)


# -- the checkpointer --------------------------------------------------------


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 16), generator=gen),
                       "b": torch.arange(16, dtype=torch.float32)},
            "opt": {"m": {"w": torch.zeros((8, 16)), "b": torch.zeros(16)}},
            "step": torch.tensor(3, dtype=torch.int32)}


def _leaves(tree):
    return [np.asarray(t) for t in jax.tree.leaves(tree)]


def test_roundtrip_bitwise(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(3, state, extra={"cursor": 3})
    like = jax.tree.map(torch.empty_like, state)
    restored, extra = ck.restore(like)
    assert extra == {"cursor": 3}
    assert restored["step"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert torch.equal(a, b)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        man = json.load(f)
    assert man["keys"] == ["opt/m/b", "opt/m/w", "params/b", "params/w",
                           "step"]
    assert man["dtypes"]["step"] == "int32" and man["process_count"] == 1
    assert sorted(os.listdir(tmp_path / "step_00000003")) == [
        "manifest.json", "shard_0.npz"]


def test_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]


def test_async_save_snapshots_before_an_in_place_change(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    want = state["params"]["w"].clone()
    ck.save(7, state, blocking=False)
    state["params"]["w"].add_(1.0)          # the next step, in place
    ck.wait()
    assert ck.latest_step() == 7
    restored, _ = ck.restore(jax.tree.map(torch.empty_like, state))
    assert torch.equal(restored["params"]["w"], want)


def test_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="params/w"):
        ck.restore(bad)


def test_bf16_leaf_and_shardings_are_refused(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    state["params"]["w"] = state["params"]["w"].bfloat16()
    with pytest.raises(TypeError, match="params/w"):
        ck.save(1, state)
    ck.save(2, _state())
    # shardings= is the elastic restore now (placements onto a mesh are
    # held in test_torch_distributed); a None sharding restores the leaf
    # as it is, as the reference's does
    got, _ = ck.restore(jax.tree.map(torch.zeros_like, _state()),
                        shardings={"params": {"w": None, "b": None}})
    for a, b in zip(_leaves(got), _leaves(_state())):
        np.testing.assert_array_equal(a, b)


def test_checkpoints_restore_across_the_packages(tmp_path):
    """A reference checkpoint of the reduced llama3.2-3b train state
    restores into the port's tree, and a port checkpoint into the
    reference's, bit for bit; the manifests list the same keys."""
    jcfg, _ = configs()
    jstate, state = states(jcfg)
    JCheckpointer(str(tmp_path / "j")).save(5, jstate, extra={"c": 5})
    got, extra = Checkpointer(str(tmp_path / "j")).restore(
        jax.tree.map(torch.zeros_like, state))
    assert extra == {"c": 5}
    for a, b in zip(_leaves(got), _leaves(jstate)):
        np.testing.assert_array_equal(a, b)

    Checkpointer(str(tmp_path / "t")).save(6, state, extra={"c": 6})
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)
    back, extra = JCheckpointer(str(tmp_path / "t")).restore(like)
    assert extra == {"c": 6}
    for a, b in zip(_leaves(back), _leaves(jstate)):
        np.testing.assert_array_equal(a, b)
    mans = [json.load(open(tmp_path / d / f"step_0000000{s}" /
                           "manifest.json"))
            for d, s in (("j", 5), ("t", 6))]
    for k in ("keys", "shapes", "dtypes", "process_count"):
        assert mans[0][k] == mans[1][k], k


# -- the launcher ------------------------------------------------------------


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    hist = train_launcher.main(["--arch", "llama3.2-3b", "--device", "cpu",
                                "--steps", "12", "--batch", "4", "--seq",
                                "32", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == list(range(12))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "step      0 loss" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest_step() == 12
    again = train_launcher.main(["--arch", "llama3.2-3b", "--device", "cpu",
                                 "--steps", "12", "--resume", "--ckpt-dir",
                                 str(tmp_path)])
    assert again == []                  # resumed at the end: nothing to do
