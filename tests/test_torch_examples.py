"""The ConvCore fields the first port dropped (``wrap8``, ``auto_bank``),
``NetworkPlan.grouped_layer_count``, and the port's counterparts of
``examples/`` (``repro_torch.examples``) on the CPU, against the JAX
reference on the same numpy inputs.

The examples run at their smallest sizes: ``conv_acceleration`` whole
(its QAT is 50 steps of a 12×12 LeNet), ``quickstart`` through its own
functions at a few steps, ``serve_batched`` and ``train_llama_tiny``
through ``main`` with small flags.  The figures that depend on no budget
or device (psums, cycles, GOPS, the reports) equal the reference's."""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import convcore as jconvcore
from repro.core import network as jnet
from repro.core import perfmodel as jperf
from repro.kernels import ref as jref
from repro_torch.core import banking as tbanking
from repro_torch.core import convcore as tconvcore
from repro_torch.core import network as tnet
from repro_torch.core.scheduler import (KoutShardedBackend,
                                        SpatialShardedBackend)
from repro_torch.examples import (conv_acceleration, quickstart,
                                  serve_batched, train_llama_tiny)

ROOT = Path(__file__).resolve().parents[1]
ZOO = ("lenet", "vgg_small", "vgg_imagenet", "large_map", "resnet_small",
       "mobilenet_small", "mobilenet_v2ish", "resnet_bottleneck",
       "dilated_context", "unet_small")
EXAMPLES = (conv_acceleration, quickstart, serve_batched, train_llama_tiny)


def _int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module (not a
    package: loaded from its path)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- wrap8 -------------------------------------------------------------------


@pytest.mark.parametrize("backend", ("cuda", "ref"))
@pytest.mark.parametrize("with_bias", (False, True))
def test_wrap8_epilogue_backend_parity(backend, with_bias):
    """ReLU and pool on the int32 accumulator, then the 8-bit wrap: each
    port backend bit-equal to the reference's ``ConvCore(wrap8=True)``."""
    rng = np.random.default_rng(17)
    x, w = _int8(rng, (1, 12, 12, 4)), _int8(rng, (3, 3, 4, 4))
    b = rng.integers(-5000, 5000, 4).astype(np.int32) if with_bias else None
    want = jconvcore.ConvCore(jconvcore.ConvCoreConfig(
        backend="ref", int8=True, wrap8=True)).apply_layer(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        relu=True, pool=True)
    got = tconvcore.ConvCore(tconvcore.ConvCoreConfig(
        backend=backend, int8=True, wrap8=True)).apply_layer(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), relu=True, pool=True)
    assert got.dtype == torch.int8 and want.dtype == jnp.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrap is real: the int32 accumulator leaves the int8 range
    acc = jref.conv2d_ref_int8(jnp.asarray(x), jnp.asarray(w))
    assert int(jnp.max(jnp.abs(acc))) > 127


@pytest.mark.parametrize("backend", ("cuda", "ref"))
def test_wrap8_with_out_scale_raises(backend):
    rng = np.random.default_rng(3)
    x, w = _int8(rng, (1, 8, 8, 4)), _int8(rng, (3, 3, 4, 4))
    core = tconvcore.ConvCore(tconvcore.ConvCoreConfig(
        backend=backend, int8=True, wrap8=True))
    with pytest.raises(ValueError, match="mutually exclusive"):
        core.apply_layer(torch.from_numpy(x), torch.from_numpy(w),
                         out_scale=torch.tensor(0.01))


@pytest.mark.parametrize("shard", (KoutShardedBackend,
                                   SpatialShardedBackend))
def test_wrap8_reaches_the_sharded_inner_backend(shard):
    """The scheduler's sharded backends pass ``wrap8`` on to each core's
    conv: the wrapped int8 result equals the unsharded one."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_int8(rng, (1, 12, 12, 8)))
    w = torch.from_numpy(_int8(rng, (3, 3, 8, 8)))
    inner = tconvcore.get_backend("cuda")
    want = inner.conv(x, w, relu=True, pool=True, wrap8=True)
    got = shard(inner, 2).conv(x, w, relu=True, pool=True, wrap8=True)
    assert got.dtype == torch.int8
    assert torch.equal(got, want)


# -- auto_bank ---------------------------------------------------------------

AUTO_BANK_LAYERS = (                       # (x, w, stride, padding, pool,
    ((1, 224, 224, 8), (3, 3, 8, 8), 1, "VALID", False, 1, True),  # groups,
    ((1, 224, 224, 8), (3, 3, 8, 8), 1, "VALID", True, 1, False),  # int8)
    ((2, 30, 30, 16), (3, 3, 1, 16), 2, "SAME", False, 16, True),
    ((2, 20, 20, 8), (3, 3, 4, 4), 1, "SAME", True, 2, False),
)


@pytest.mark.parametrize("layer", AUTO_BANK_LAYERS)
def test_auto_bank_false_plans_the_whole_map_as_the_reference(layer):
    """``auto_bank=False``: the whole map as one tile, field for field the
    reference's ``vmem_budget=None`` plan (each records its own default
    budget), and the conv equal to the fitted plan's and to the
    reference's."""
    xs, ws, stride, pad, pool, groups, int8 = layer
    kw = dict(stride=stride, padding=pad, pool=pool, groups=groups)
    want = jconvcore.ConvCore(jconvcore.ConvCoreConfig(
        int8=int8, auto_bank=False)).plan(xs, ws, **kw)
    got = tconvcore.ConvCore(tconvcore.ConvCoreConfig(
        int8=int8, auto_bank=False)).plan(xs, ws, **kw)
    assert (got.n_h_tiles, got.n_w_tiles) == (1, 1)
    assert _fields(got) == _fields(dataclasses.replace(
        want, budget=tbanking.SMEM_BYTES))
    fitted = tconvcore.ConvCore(tconvcore.ConvCoreConfig(int8=int8)).plan(
        xs, ws, **kw)
    if xs[1] == 224:
        assert not got.fits_smem and fitted.fits_smem
    rng = np.random.default_rng(9)
    if int8:
        x, w = _int8(rng, xs), _int8(rng, ws)
    else:
        x = rng.normal(size=xs).astype(np.float32)
        w = rng.normal(size=ws).astype(np.float32)
    conv = dict(stride=stride, padding=pad, pool=pool, groups=groups,
                relu=True)
    outs = [tconvcore.ConvCore(tconvcore.ConvCoreConfig(
        int8=int8, auto_bank=auto)).apply_layer(
        torch.from_numpy(x), torch.from_numpy(w), **conv)
        for auto in (False, True)]
    assert torch.equal(outs[0], outs[1])
    jout = jconvcore.ConvCore(jconvcore.ConvCoreConfig(
        backend="ref", int8=int8, auto_bank=False)).apply_layer(
        jnp.asarray(x), jnp.asarray(w), **conv)
    if int8:
        np.testing.assert_array_equal(outs[0].numpy(), np.asarray(jout))
    else:
        np.testing.assert_allclose(outs[0].numpy(), np.asarray(jout),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("net", ("lenet", "mobilenet_small", "unet_small"))
def test_auto_bank_false_program_plans_match_reference(net):
    want = jnet.program_tile_plans(getattr(jnet, net)(),
                                   jconvcore.ConvCoreConfig(auto_bank=False))
    got = tnet.program_tile_plans(getattr(tnet, net)(),
                                  tconvcore.ConvCoreConfig(auto_bank=False))
    assert [p and _fields(p) for p in got] == [
        p and _fields(dataclasses.replace(p, budget=tbanking.SMEM_BYTES))
        for p in want]


# -- grouped_layer_count -----------------------------------------------------


@pytest.mark.parametrize("net", ZOO)
def test_grouped_layer_count_matches_reference(net):
    assert getattr(tnet, net)().grouped_layer_count() == \
        getattr(jnet, net)().grouped_layer_count()


# -- the examples ------------------------------------------------------------


@pytest.mark.parametrize("example", EXAMPLES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in EXAMPLES])
def test_example_without_a_device_needs_the_card(example):
    """Without ``--device`` an example runs on the card, and raises where
    there is none: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def test_conv_acceleration_on_cpu_matches_reference_figures():
    fig = conv_acceleration.main(["--device", "cpu"])
    paper = fig["paper"]
    n = jperf.psum_count(224, 224, 8, 8)
    assert paper["psums"] == n == 3_154_176
    assert paper["seconds_1core"] == jperf.seconds(n)
    assert paper["gops_paper_1core"] == jperf.gops_paper(n)
    assert paper["gops_macs_1core"] == jperf.gops_macs(n)
    c20 = jperf.IPCoreConfig(ip_cores=20)
    assert paper["seconds_20core"] == jperf.seconds(n, c20)
    assert round(paper["gops_paper_1core"], 3) == 0.224
    assert round(paper["gops_paper_20core"], 2) == 4.48
    assert paper["float_out_shape"] == (1, 222, 222, 8)

    # the int8 datapath's error: the reference's on the same inputs
    wl = jconvcore.paper_workload()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=wl["x"]), jnp.float32) * 0.5
    w = jnp.asarray(rng.normal(size=wl["w"]), jnp.float32) * 0.1
    b = jnp.asarray(rng.normal(size=wl["bias"]), jnp.float32) * 0.1
    got = jconvcore.ConvCore(jconvcore.ConvCoreConfig(
        backend="ref")).apply_quantized_layer(x, w, b)
    want = jref.conv2d_ref(x, w, b)
    rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    assert abs(paper["int8_rel_err"] - rel) < 1e-5

    h = fig["h100"]
    assert h["card_us"] is None and h["bound_by"] == "memory"

    lenet = fig["lenet"]
    assert lenet["multicore_max_abs"] == 0.0
    assert lenet["report"] == jnet.lenet().perf_report()
    res = fig["resnet"]
    assert res["lone_equal"] and (res["batches"], res["padded"]) == (2, 2)
    assert res["requests"] == 7
    assert res["model_seconds"] == jnet.resnet_small().perf_report()[
        "seconds"]
    mb = fig["mobilenet"]
    assert mb["grouped_layers"] == jnet.mobilenet_small() \
        .grouped_layer_count() == 3
    for net in ("lenet", "resnet", "mobilenet"):
        assert 0.0 < fig[net]["int8_rel_err"] < 0.05, net
    assert all(p.fits_smem for p in fig["large_map"]["tile_plans"])

    qat = fig["qat"]
    assert qat["steps"] == 50 and qat["loss_last"] < qat["loss_first"]
    assert qat["int8_acc"] >= qat["float_acc"] - 0.02
    assert qat["train_report"] == jnet.lenet(
        input_shape=(12, 12, 1)).train_report()


def test_quickstart_functions_at_a_few_steps():
    dev = torch.device("cpu")
    cfg, state, pipe = quickstart.build(dev)
    want = jbase.reduce_config(jbase.get_config("llama3-8b"))
    assert (cfg.name, cfg.num_layers, cfg.d_model, cfg.vocab_size) == (
        want.name, want.num_layers, want.d_model, want.vocab_size)
    state, losses = quickstart.train(cfg, state, pipe, steps=4)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert int(state["step"]) == 4
    toks = quickstart.generate(cfg, state["params"], pipe, dev, new_tokens=3)
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)


@pytest.mark.parametrize("w8", (False, True))
def test_serve_batched_serves_every_request(w8):
    fig = serve_batched.main(["--device", "cpu", "--requests", "4",
                              "--max-new", "3"] + (["--w8"] if w8 else []))
    assert fig["requests"] == 4 and fig["tokens"] == 12
    assert all(len(o) == 3 for o in fig["outputs"].values())


def test_serve_batched_w8_refuses_non_dense_families(capsys):
    with pytest.raises(SystemExit):
        serve_batched.main(["--arch", "rwkv6-1.6b", "--w8", "--device",
                            "cpu"])
    assert "no w8 path" in capsys.readouterr().err


def test_train_llama_tiny_resumes_from_its_checkpoint(tmp_path):
    """A failure injected at step 11 restores the step-10 checkpoint
    (``checkpoint_every = max(steps // 5, 10)``) and replays from it."""
    fig = train_llama_tiny.main(["--device", "cpu", "--steps", "12",
                                 "--fail-at", "11", "--ckpt-dir",
                                 str(tmp_path)])
    assert fig["restarts"] == 1
    assert fig["history_steps"] == list(range(11)) + [10, 11]
    assert fig["loss_last"] < fig["loss_first"]


def test_train_llama_tiny_presets_match_reference():
    ref = _reference_example("train_llama_tiny")
    for preset in ("tiny", "100m"):
        got, want = (train_llama_tiny.build_config(preset),
                     ref.build_config(preset))
        common = {f.name for f in dataclasses.fields(got)} & {
            f.name for f in dataclasses.fields(want)}
        assert {k: getattr(got, k) for k in common if k != "moe"} == \
            {k: getattr(want, k) for k in common if k != "moe"}, preset
        assert train_llama_tiny.param_count(got) == jbase.param_count(want)
