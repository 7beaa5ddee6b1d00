"""The port's distribution on ``torch.distributed`` against the reference,
on gloo ranks on the CPU.

One spawn of 8 ranks (a (2, 4) ``(data, model)`` mesh; a (4, 2) one for
the elastic restore) runs every multi-rank scenario
(``torch_dist_checks.cpu_scenarios``), so process start-up is paid once:

* the sharded train step of the reduced ``llama3_8b`` (``fsdp=True``,
  batch 4 × 32) under ``xla`` and ``pallas_ws`` (``matmul_ws_plain`` on
  the CPU) against the port's unsharded step and against the reference's
  unsharded ``jax.jit`` step, from the reference's state: the loss within
  the reference test's 2e-4, every gradient within ``GRAD_REL`` relative
  L2, params, m and v within 1e-4 by ``hold_step``'s near-zero rule;
* the sharded decode step (``mode="decode"``, ``cache_seq`` over
  ``model``) for 2 steps against the unsharded one;
* ``matmul_ws`` with a bias on a K-sharded product: the bias added once;
* ``compressed_psum`` over both mesh dims against the reference's
  ``psum`` / ``pmax`` math in numpy, bit for bit;
* ``pipeline_apply`` over 4 stages, forward and gradient, against the
  sequential stack and against the reference's ``pipeline_apply`` on a
  4-device fake mesh;
* a checkpoint of the (2, 4) FSDP state restored onto (4, 2) and onto one
  rank, bit for bit.

The reference cannot run its own sharded steps here (jax 0.9 fails on
the vocab-sharded embedding gather; ``tests/test_sharding.py``), so the
sharded steps are held to the unsharded ones, as its test holds its own.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_checks as dc
from repro.configs import base as jbase
from repro.core.quantize import EFState as JEFState
from repro.distributed import compression as jcomp
from repro.distributed.pipeline import bubble_fraction as jbubble
from repro.layers import common as jcommon
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.core.quantize import EFState
from repro_torch.distributed import compression
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.launch import mesh as tmesh
from repro_torch.layers.common import tree_map
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
BATCH, SEQ = 4, 32
# f32 gradients of the sharded step against the unsharded one: each of
# the step's contractions sums its terms in another order on each rank and
# across them, each within ``test_torch_cuda.GRAD_REL_L2`` = 5e-5 relative
# L2 of the exact product; a gradient leaf adds a few of them.  A skipped
# or doubled reduction moves a leaf by O(1)
GRAD_REL = 2e-4


def _jstate():
    jcfg = jbase.reduce_config(jbase.get_config("llama3_8b"))
    sspecs = jts.init_state_specs(jcfg)
    return jcfg, {"params": jcommon.materialize(sspecs["params"],
                                                jax.random.PRNGKey(0)),
                  "opt": jcommon.materialize(sspecs["opt"],
                                             jax.random.PRNGKey(1)),
                  "step": jnp.zeros((), jnp.int32)}


def _to_torch(jstate):
    return {"params": convert.lm_params_to_torch(
                jax.tree.map(np.asarray, jstate["params"]), device="cpu"),
            "opt": convert.lm_params_to_torch(
                jax.tree.map(np.asarray, jstate["opt"]), device="cpu"),
            "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario's readings from one spawn of 8 gloo ranks."""
    jcfg, jstate = _jstate()
    batch = dc.draw_batch(jcfg.vocab_size, BATCH, SEQ, 1, "cpu")
    ckpt = tmp_path_factory.mktemp("ckpt")
    out, backend = dc.spawn_ranks(dc.cpu_scenarios, WORLD, str(ckpt),
                                  _to_torch(jstate), batch, device="cpu",
                                  timeout_s=300)
    assert backend == "gloo"
    return {"out": out, "jcfg": jcfg, "jstate": jstate, "batch": batch,
            "ckpt": str(ckpt)}


def _reference_step(jcfg, jstate, batch):
    """(metrics, grads, state) of the reference's unsharded step body under
    one jit, as whole CPU tensors in the port's leaf order."""
    hp = JAdamWConfig(**dc.STEP_HP)

    @jax.jit
    def run(state, b):
        (total, (loss, aux)), grads = jax.value_and_grad(
            jts._loss_fn, has_aux=True)(state["params"], b, jcfg)
        params, opt, om = jadamw_update(state["params"], grads, state["opt"],
                                        state["step"], hp)
        return grads, params, opt, {"loss": loss, "aux_loss": aux,
                                    "total_loss": total, **om}

    grads, params, opt, m = run(jstate, {k: jnp.asarray(v.numpy()) for k, v
                                         in batch.items()})
    leaves = lambda t: [torch.from_numpy(np.array(x))  # noqa: E731
                        for x in jax.tree.leaves(t)]
    return ({k: float(v) for k, v in m.items()}, leaves(grads),
            {"params": leaves(params), "m": leaves(opt["m"]),
             "v": leaves(opt["v"])})


@pytest.mark.parametrize("backend", ["xla", "pallas_ws"])
def test_sharded_train_step_matches_unsharded(world, backend):
    got = world["out"][f"train_{backend}"]
    cfg = dc.reduced_cfg(backend)
    state = _to_torch(world["jstate"])
    plain = dc.plain_step(state, world["batch"], cfg,
                          AdamWConfig(**dc.STEP_HP))
    r = dc.hold_step(got, plain, grad_rel=GRAD_REL)
    jcfg = dataclasses.replace(world["jcfg"], gemm_backend=backend)
    ref = _reference_step(jcfg, world["jstate"], world["batch"])
    print(backend, "vs port", r, "vs JAX",
          dc.hold_step(got, ref, grad_rel=GRAD_REL))
    assert got[0]["lr"] == ref[0]["lr"]


def test_sharded_step_under_minimal_remat(world):
    """The selective ``"minimal"`` checkpoint on the sharded step: its
    policy sees and saves as many dots as on one device (the local
    ``aten.mm`` of the shards), ``matmul_ws`` is recomputed as often (its
    kernel calls match), and the step matches the unsharded one."""
    got, counts = world["out"]["remat"]
    cfg = dataclasses.replace(dc.reduced_cfg("pallas_ws"),
                              remat_policy="minimal")
    want, want_counts = dc.remat_readings(lambda: dc.plain_step(
        _to_torch(world["jstate"]), world["batch"], cfg,
        AdamWConfig(**dc.STEP_HP)))
    assert counts == want_counts and counts["saved"] > 0
    # the gradients and the step: forward, recompute, dx and dw of the
    # MLP's three GEMMs, twice (the step's gradients taken alone, then
    # the step)
    assert counts["matmul_ws"] == 2 * 4 * 3 * cfg.num_layers
    dc.hold_step(got, want, grad_rel=GRAD_REL)


@pytest.mark.parametrize("backend", ["xla", "pallas_ws"])
def test_sharded_decode_matches_unsharded(world, backend):
    logits, cache = world["out"][f"decode_{backend}"]
    cfg = dc.reduced_cfg(backend)
    params = dc.draw_state(cfg, 2, "cpu")[0]["params"]
    c0, tokens, pos = dc.prefilled_cache(params, cfg, BATCH, SEQ, 12)
    want, want_cache = dc.plain_decode(params, c0, cfg, tokens, pos, 2)
    for a, w in zip(logits, want):
        assert a.shape == (BATCH, cfg.vocab_size)
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    for a, w in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def test_sharded_moe_serving_matches_unsharded(world):
    """The reduced deepseek_moe_16b served on the (2, 4) mesh, each rank
    routing its batch rows to its 2 of the 8 experts and the partial
    outputs summed over ``model``: the prefill's logits and two decode
    steps equal the unsharded ones (up to the order of that sum); its
    FSDP train step, the experts' and the router's gradients partial sums
    on local shards, holds to the unsharded step (``GRAD_REL``)."""
    from repro_torch.models import lm
    cfg = dc.reduced_cfg("xla", "deepseek_moe_16b")
    params = dc.draw_state(cfg, 2, "cpu")[0]["params"]
    with torch.no_grad():
        want, _ = lm.prefill(params, {"tokens": dc.moe_prompt(cfg, 4, 16)},
                             cfg)
    torch.testing.assert_close(world["out"]["moe_prefill"], want,
                               rtol=1e-5, atol=1e-5)
    logits, cache = world["out"]["moe_decode"]
    c0, tokens, pos = dc.prefilled_cache(params, cfg, BATCH, SEQ, 12)
    want, want_cache = dc.plain_decode(params, c0, cfg, tokens, pos, 2)
    for a, w in zip(logits, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    for a, w in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    state = dc.draw_state(cfg, 2, "cpu")[0]
    want = dc.plain_step(state, dc.moe_batch(world["batch"]), cfg,
                         AdamWConfig(**dc.STEP_HP))
    got = world["out"]["moe_train"]
    print("moe train", dc.hold_step(got, want, grad_rel=GRAD_REL))
    assert abs(got[0]["aux_loss"] - want[0]["aux_loss"]) <= 1e-6


def test_matmul_ws_bias_added_once_under_split_k(world):
    y, gx, gw, gb, x, w, b = world["out"]["bias_once"]
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    want = xr @ wr + br
    torch.sum(want * want).backward()
    torch.testing.assert_close(y, want.detach(), rtol=1e-5, atol=1e-5)
    # a bias added once per rank would be 8 b off
    assert float((y - (x @ w + 8 * b)).abs().max()) > 1.0
    for a, r in ((gx, xr.grad), (gw, wr.grad), (gb, br.grad)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_compressed_psum_equals_the_reference_math(world, axis):
    x, y, peers = world["out"]["psum"][axis]
    assert len(peers) == {"data": 2, "model": 4}[axis]
    np.testing.assert_array_equal(y.numpy(),
                                  dc.compressed_psum_want(peers))


def test_pipeline_matches_sequential(world):
    y, grads = world["out"]["pipeline"]
    params, x = dc.pipeline_inputs(4, 16, 32, 5, "cpu")
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = dc.sequential(p, x)
    torch.sum(torch.square(want)).backward()
    torch.testing.assert_close(y, want.detach(), rtol=2e-5, atol=2e-5)
    for g, k in zip(grads, sorted(p)):
        torch.testing.assert_close(g, p[k].grad, rtol=1e-4, atol=1e-4)


def test_pipeline_matches_the_reference(world, tmp_path):
    """The reference's ``pipeline_apply`` on a 4-device fake mesh (in a
    subprocess, so the flag never leaks), on the same inputs."""
    y, grads = world["out"]["pipeline"]
    params, x = dc.pipeline_inputs(4, 16, 32, 5, "cpu")
    np.savez(tmp_path / "in.npz", x=x.numpy(),
             **{k: v.numpy() for k, v in params.items()})
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline import pipeline_apply
        from repro.distributed.sharding import use_mesh
        d = np.load({str(tmp_path / "in.npz")!r})
        params = {{"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}}
        x = jnp.asarray(d["x"])
        mesh = jax.make_mesh((4,), ("stage",), devices=jax.devices()[:4])
        f = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
        loss = lambda p: jnp.sum(jnp.square(pipeline_apply(
            f, p, x, mesh=mesh, axis="stage", n_micro=8)))
        with use_mesh(mesh):
            y = pipeline_apply(f, params, x, mesh=mesh, axis="stage",
                               n_micro=8)
            g = jax.grad(loss)(params)
        np.savez({str(tmp_path / "out.npz")!r}, y=np.asarray(y),
                 gw=np.asarray(g["w"]), gb=np.asarray(g["b"]))
    """)
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=2e-5, atol=2e-5)
    gb, gw = grads           # the leaves in sorted key order: b, w
    np.testing.assert_allclose(gw.numpy(), ref["gw"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), ref["gb"], rtol=1e-4, atol=1e-4)


def test_checkpoint_restores_across_meshes(world):
    """Saved from the (2, 4) FSDP state after a step: restored onto (4, 2)
    in the ranks, and here onto one rank with no process group."""
    back, saved = world["out"]["ckpt"]
    for a, b in zip(tree_leaves(back), tree_leaves(saved)):
        assert torch.equal(a, b)
    target = tree_map(torch.zeros_like, saved)
    got, extra = Checkpointer(world["ckpt"]).restore(target)
    assert extra == {"from": "sharded"}
    for a, b in zip(tree_leaves(got), tree_leaves(saved)):
        assert torch.equal(a, b)


def test_compress_grads_bit_equal_to_the_reference():
    """Five steps of a carried ``EFState`` over a gradient tree: the
    decompressed gradients and the residuals bit-equal to the
    reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 24), "b": {"c": (7,), "d": (3, 5, 2)}}
    grads = [jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32)
                          * 10.0 ** rng.integers(-3, 2), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(5)]
    jef = jcomp.init_ef_state(jax.tree.map(jnp.asarray, grads[0]))
    tef = compression.init_ef_state(tree_map(torch.from_numpy, grads[0]))
    for g in grads:
        jout, jef = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jef)
        tout, tef = compression.compress_grads(tree_map(torch.from_numpy,
                                                        g), tef)
        for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jres = [np.asarray(s.residual) for s in jax.tree.leaves(
            jef, is_leaf=lambda x: isinstance(x, JEFState))]
        tres = [s.residual.numpy() for s in compression._ef_leaves(tef)]
        assert all(isinstance(s, EFState) for s in compression._ef_leaves(
            tef))
        for a, b in zip(tres, jres):
            np.testing.assert_array_equal(a, b)
    # no state: a plain int8 round trip
    tout, _ = compression.compress_grads(tree_map(torch.from_numpy,
                                                  grads[0]), None)
    jout, _ = jcomp.compress_grads(jax.tree.map(jnp.asarray, grads[0]),
                                   None)
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bubble_fraction_and_mesh_refusals():
    for s, m in ((1, 8), (4, 4), (4, 28), (16, 3)):
        assert bubble_fraction(s, m) == jbubble(s, m)
    assert tmesh.backend_for("cpu", 8) == "gloo"
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_debug_mesh(2, 4, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_production_mesh(device="cpu")
