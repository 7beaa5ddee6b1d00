"""The port's LM train step against the JAX reference on the CPU.

Both packages step from the reference's ``materialize``d state (params
from key 0, m and v from key 1) carried across with
``convert.lm_params_to_torch``, on one ``SyntheticLM`` batch.  The JAX
side runs under one ``jax.jit`` per config (Pallas in interpret mode
under ``gemm_backend="pallas_ws"``): the body of its ``make_train_step``,
whose gradients are compared too, or with microbatches the step itself.
In f32 the loss, the metrics, every gradient and every updated param, m
and v agree within rtol = atol = 1e-4 (the two sum in another order).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jbase
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_pipeline as jmake_pipeline
from repro.layers import common as jcommon
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.layers import common
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

TOL = dict(rtol=1e-4, atol=1e-4)
HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
SEQ, BATCH = 16, 4


def configs(arch="llama3p2_3b", **kw):
    kw.setdefault("compute_dtype", "float32")
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)),
                              **kw)
    return jcfg, cfg


def states(jcfg):
    """The reference's initial train state, and the same as tensors."""
    sspecs = jts.init_state_specs(jcfg)
    jstate = {"params": jcommon.materialize(sspecs["params"],
                                            jax.random.PRNGKey(0)),
              "opt": jcommon.materialize(sspecs["opt"],
                                         jax.random.PRNGKey(1)),
              "step": jnp.zeros((), jnp.int32)}
    return jstate, to_torch(jstate)


def to_torch(jstate):
    return {"params": convert.lm_params_to_torch(
                jax.tree.map(np.asarray, jstate["params"]), device="cpu"),
            "opt": convert.lm_params_to_torch(
                jax.tree.map(np.asarray, jstate["opt"]), device="cpu"),
            "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}


def port_state(cfg, seed=0):
    """A train state drawn by the port from ``seed``: params from one
    generator, m and v zero, step 0."""
    specs = ts.init_state_specs(cfg)
    gen = torch.Generator().manual_seed(seed)
    return {"params": common.materialize(specs["params"], gen, device="cpu"),
            "opt": common.materialize(specs["opt"], gen, device="cpu"),
            "step": torch.zeros((), dtype=torch.int32)}


def batch_for(cfg, seed=0, batch=BATCH, extra=None):
    """A ``SyntheticLM`` batch as numpy, plus ``extra`` ({name: (P,
    dim)}: seeded normal inputs such as a VLM's patches)."""
    b = jmake_pipeline(JDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=batch, seed=seed)).batch_at(0)
    rng = np.random.default_rng(seed)
    for name, (n, dim) in (extra or {}).items():
        b[name] = rng.normal(size=(batch, n, dim)).astype(np.float32)
    return b


def reference_step(jcfg, jstate, batch, accum_steps=1):
    """(grads, new state, metrics) of the reference under one jit.  With
    one microbatch it runs the body of its ``make_train_step`` (its
    ``_loss_fn`` under ``jax.value_and_grad``, then ``adamw_update``) to
    return the gradients too; with more it runs ``make_train_step``
    itself and returns no gradients."""
    hp = JAdamWConfig(**HP)

    @jax.jit
    def run(state, b):
        if accum_steps > 1:
            return (None, *jts.make_train_step(
                jcfg, hp, accum_steps=accum_steps)(state, b))
        (total, (loss, aux)), grads = jax.value_and_grad(
            jts._loss_fn, has_aux=True)(state["params"], b, jcfg)
        params, opt, om = jadamw_update(state["params"], grads, state["opt"],
                                        state["step"], hp)
        return grads, {"params": params, "opt": opt,
                       "step": state["step"] + 1}, {
            "loss": loss, "aux_loss": aux, "total_loss": total, **om}

    return jax.tree.map(np.asarray, run(
        jstate, jax.tree.map(jnp.asarray, batch)))


def port_step(cfg, state, batch, accum_steps=1):
    """(grads, new state, metrics) of the port; the state is updated in
    place, so the grads (of the whole batch) are taken first."""
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, _, _, g = ts._grads(state["params"], tb, cfg)
    grads = ts._unflatten(state["params"], g)
    new, metrics = ts.make_train_step(cfg, adamw.AdamWConfig(**HP),
                                      accum_steps=accum_steps)(state, tb)
    return grads, new, metrics


def leaves(tree):
    return [np.asarray(t.detach()) if isinstance(t, torch.Tensor) else t
            for t in jax.tree.leaves(tree)]


def close(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def check_step(jcfg, cfg, batch, accum_steps=1):
    """One step of both: the metrics, the gradients (with one
    microbatch) and the updated params, m, v and step."""
    jstate, state = states(jcfg)
    jgrads, jnew, jm = reference_step(jcfg, jstate, batch, accum_steps)
    grads, new, m = port_step(cfg, state, batch, accum_steps)
    for k in ("loss", "aux_loss", "total_loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    if jgrads is not None:
        close(grads, jgrads)
    close(new["params"], jnew["params"])
    close(new["opt"], jnew["opt"])
    assert int(new["step"]) == int(jnew["step"]) == 1
    return m


# ---------------------------------------------------------------------------


def test_cross_entropy_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = ts.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    every = np.full_like(labels, -1)        # all ignored: 0, not NaN
    assert float(ts.cross_entropy(torch.as_tensor(logits),
                                  torch.as_tensor(every))) == 0.0


@pytest.mark.parametrize("backend", ["xla", "pallas_ws"])
def test_one_step_equals_the_reference(backend):
    jcfg, cfg = configs(gemm_backend=backend)
    check_step(jcfg, cfg, batch_for(cfg))


def test_accumulated_step_equals_the_reference():
    """accum_steps=2 against the reference's accum_steps=2 (its scan over
    the microbatches), batch 8."""
    jcfg, cfg = configs()
    check_step(jcfg, cfg, batch_for(cfg, seed=2, batch=8), accum_steps=2)


def test_remat_policies_change_no_value():
    """The gradients and the updated state are equal under every remat
    policy; ``"minimal"`` saved the dots and recomputed the rest."""
    outs = {}
    batch = {k: torch.as_tensor(v)
             for k, v in batch_for(configs()[1]).items()}
    for policy in ("none", "minimal", "full", "save_block_outputs"):
        _, cfg = configs(remat_policy=policy)
        state = port_state(cfg)
        g = ts._grads(state["params"], batch, cfg)[3]
        new, m = ts.make_train_step(cfg, adamw.AdamWConfig(**HP))(state,
                                                                  batch)
        outs[policy] = (g, adamw.tree_leaves(new), m["loss"])
    for policy, (g, new, loss) in outs.items():
        for a, b in zip(g + new + [loss], outs["none"][0] + outs["none"][1]
                        + [outs["none"][2]]):
            assert torch.equal(a, b), policy


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run: ``bmm`` split into batch 1 (an
    einsum without batch dimensions) and batched."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket.__name__
        if func is torch.ops.aten.bmm.default:
            key = "dot" if args[0].shape[0] == 1 else "batched_dot"
        self.counts[key] += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_what_its_policy_does_not_save():
    """The forward ops that run again in the backward of a 2-layer model:
    none under ``none``; under ``minimal`` the attention's batched dots
    but no batch-free dot (saved); under ``full`` the batch-free dots too;
    under ``save_block_outputs`` fewer ``alias`` ops than under ``full``
    (the named block outputs come from storage)."""
    _, cfg0 = configs()
    batch = {k: torch.as_tensor(v) for k, v in batch_for(cfg0).items()}
    counts = {}
    for policy in ("none", "minimal", "full", "save_block_outputs"):
        _, cfg = configs(remat_policy=policy, num_layers=2)
        params = common.materialize(lm.param_specs(cfg),
                                    torch.Generator().manual_seed(0),
                                    device="cpu")
        live = common.tree_map(lambda t: t.requires_grad_(), params)
        total = ts._loss_fn(live, batch, cfg)[0]
        with _CountOps() as mode:
            total.backward()
        counts[policy] = mode.counts
    none, minimal, full, named = (counts[p] for p in (
        "none", "minimal", "full", "save_block_outputs"))
    assert none["alias"] == 0
    assert minimal["dot"] == none["dot"] < full["dot"]
    assert minimal["batched_dot"] > none["batched_dot"]
    assert 0 < named["alias"] < full["alias"]


def test_in_place_update_equals_adamw_update():
    """``adamw_update_`` is ``torch.equal`` to ``adamw_update`` on every
    param, m and v, with the clip on and off, and writes into the state's
    own tensors; a leaf wider than ``UPDATE_ROWS`` goes in blocks."""
    _, cfg = configs(num_layers=3)
    specs = ts.init_state_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    params = common.materialize(specs["params"], gen, device="cpu")
    grads = common.materialize(specs["params"], gen, device="cpu")
    opt = {"m": common.materialize(specs["params"], gen, device="cpu"),
           "v": common.tree_map(torch.square, common.materialize(
               specs["params"], gen, device="cpu"))}
    step = torch.tensor(3, dtype=torch.int32)
    for clip in (1.0, 0.0):
        hp = adamw.AdamWConfig(grad_clip_norm=clip, warmup_steps=2)
        want_p, want_opt, want_m = adamw.adamw_update(params, grads, opt,
                                                      step, hp)
        p2, g2, o2 = (common.tree_map(torch.clone, t)
                      for t in (params, grads, opt))
        ptrs = [t.data_ptr() for t in adamw.tree_leaves((p2, o2))]
        old_rows = adamw.UPDATE_ROWS
        adamw.UPDATE_ROWS = 1000      # blocks of a few rows, not one leaf
        try:
            got_m = adamw.adamw_update_(p2, g2, o2, step, hp)
        finally:
            adamw.UPDATE_ROWS = old_rows
        assert [t.data_ptr() for t in adamw.tree_leaves((p2, o2))] == ptrs
        for a, b in zip(adamw.tree_leaves((p2, o2)),
                        adamw.tree_leaves((want_p, want_opt))):
            assert torch.equal(a, b)
        assert torch.equal(got_m["lr"], want_m["lr"])
        assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])


def test_in_place_update_equals_the_reference():
    """``adamw_update_`` against the reference's ``adamw_update`` on the
    same params, grads and moments, within 1e-6."""
    jcfg, cfg = configs()
    specs = jts.init_state_specs(jcfg)
    jp = jcommon.materialize(specs["params"], jax.random.PRNGKey(0))
    jg = jcommon.materialize(specs["params"], jax.random.PRNGKey(5))
    jopt = jcommon.materialize(specs["opt"], jax.random.PRNGKey(1))
    step = 4
    want = jax.tree.map(np.asarray, jax.jit(jadamw_update, static_argnums=4)(
        jp, jg, jopt, jnp.asarray(step, jnp.int32),
        JAdamWConfig(warmup_steps=2)))
    p, g, opt = (convert.lm_params_to_torch(jax.tree.map(np.asarray, t),
                                            device="cpu")
                 for t in (jp, jg, jopt))
    m = adamw.adamw_update_(p, g, opt, torch.tensor(step, dtype=torch.int32),
                            adamw.AdamWConfig(warmup_steps=2))
    for a, b in zip(leaves((p, opt, m)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["llama3p2_3b", "deepseek_moe_16b",
                                  "seamless_m4t_medium"])
def test_init_state_specs_match_the_reference(arch):
    jcfg, cfg = configs(arch)

    def flat(tree, is_leaf):
        return [(s.shape, s.axes, s.dtype, s.init, s.scale, s.fan_in_axes)
                for s in jax.tree.leaves(tree, is_leaf=is_leaf)]
    got, want = ts.init_state_specs(cfg), jts.init_state_specs(jcfg)
    for part in ("params", "opt"):
        assert flat(got[part], common.is_spec) == flat(want[part],
                                                       jcommon.is_spec)
    assert {s.dtype for s in jax.tree.leaves(
        got["opt"], is_leaf=common.is_spec)} == {"float32"}


def test_eval_step_equals_the_reference_and_records_nothing():
    jcfg, cfg = configs()
    jstate, state = states(jcfg)
    batch = batch_for(cfg)
    want = jts.make_eval_step(jcfg)(jstate["params"],
                                    jax.tree.map(jnp.asarray, batch))
    got = ts.make_eval_step(cfg)(state["params"],
                                 {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               **TOL)
    assert not got["loss"].requires_grad
