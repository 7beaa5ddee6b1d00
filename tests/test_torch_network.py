"""The port's planner, cycle model, graph walks, quantizer and ConvCore
against the JAX reference (``repro_torch.core`` vs ``repro.core``).

Tile plans are field-equal given the same budget, the §5.2 anchors are
exact, and the port's own ``quantize_network`` reproduces the reference's
int8 weights and input scale bit for bit; every other scale comes out of a
float calibration forward whose last bits differ between XLA and PyTorch,
so it is held to rtol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banking as jbanking
from repro.core import convcore as jconvcore
from repro.core import network as jnet
from repro.core import perfmodel as jperf
from repro_torch.core import banking as tbanking
from repro_torch.core import convcore as tconvcore
from repro_torch.core import network as tnet
from repro_torch.core import perfmodel as tperf

ZOO = ("lenet", "vgg_small", "vgg_imagenet", "large_map", "resnet_small",
       "mobilenet_small", "mobilenet_v2ish", "resnet_bottleneck",
       "dilated_context", "unet_small")


def _fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def _torch_params(params):
    return [None if p is None else
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
            for p in params]


@pytest.mark.parametrize("net", ZOO)
def test_graph_walks_and_tile_plans_match_reference(net):
    jp, tp = getattr(jnet, net)(), getattr(tnet, net)()
    assert tp.node_names() == jp.node_names()
    assert tp.activation_shapes() == jp.activation_shapes()
    assert tp.param_shapes() == jp.param_shapes()
    assert tp.psum_table() == jp.psum_table()
    assert tp.conv_geometries() == jp.conv_geometries()
    for budget in (jbanking.VMEM_BYTES, tbanking.SMEM_BYTES, None):
        for kernel in ("auto", "sequential", "pipelined"):
            want = jp.tile_plans(vmem_budget=budget, kernel=kernel)
            got = tp.tile_plans(smem_budget=budget, kernel=kernel)
            if budget is None:     # unfitted plans carry each default budget
                want = [p and dataclasses.replace(
                    p, budget=tbanking.SMEM_BYTES) for p in want]
            assert [None if p is None else _fields(p) for p in got] == \
                [None if p is None else _fields(p) for p in want], \
                (budget, kernel)


def test_default_plans_pick_the_pipelined_kernel():
    """Under the Hopper budget and ``kernel="auto"`` every conv of the
    main-path nets runs on ``conv2d_ws_pipe``; ``vgg_imagenet``'s early
    layers tile."""
    cfg = tconvcore.ConvCoreConfig(int8=True)
    for net in ("lenet", "vgg_imagenet", "vgg_small", "resnet_small",
                "mobilenet_small"):
        plans = [p for p in tnet.program_tile_plans(getattr(tnet, net)(), cfg)
                 if p is not None]
        assert plans and all(p.pipelined for p in plans), net
    vgg = [p for p in tnet.program_tile_plans(tnet.vgg_imagenet(), cfg)
           if p is not None]
    assert [p.n_tiles for p in vgg] == [16, 16, 8, 4, 2, 1]
    assert all(p.fits_smem for p in vgg)


def test_unet_transposed_conv_is_not_ported_yet():
    """Transposed convs are ported: ``unet_small``'s walks give the
    reference's shapes (16×16 → 4×4 → back up to 16×16 per-pixel logits),
    and each transposed layer is planned on its stride-1 lowering."""
    jp, tp = jnet.unet_small(), tnet.unet_small()
    assert tp.activation_shapes() == jp.activation_shapes()
    assert tp.activation_shapes()[-1] == (16, 16, 3)
    names = tp.node_names()
    plans = dict(zip(names, tp.tile_plans()))
    assert plans["up1"] is not None and plans["up2"] is not None
    assert [sp.kind for sp in tp.layers].count("conv_transpose") == 2


def test_paper_anchors_exact():
    got = tperf.paper_reference_numbers()
    assert got == jperf.paper_reference_numbers()
    assert got["psums"] == 3_154_176
    assert round(got["gops_1core"], 3) == 0.224
    assert round(got["gops_20cores"], 2) == 4.48
    assert tconvcore.paper_workload() == jconvcore.paper_workload()


def test_cycle_model_matches_reference():
    for net in ZOO:
        for jp, tp in zip(getattr(jnet, net)().tile_plans(),
                          getattr(tnet, net)().tile_plans(
                              smem_budget=jbanking.VMEM_BYTES)):
            if jp is None:
                continue
            for psums in (0, 1, 12345, 3_154_176):
                assert tperf.pipeline_estimate(tp, psums) == \
                    jperf.pipeline_estimate(jp, psums)
            assert tperf.tile_traffic(tp) == jperf.tile_traffic(jp)
    for n in (1, 15, 16, 17, 10 ** 6):
        assert tperf.cycles(n) == jperf.cycles(n)
        assert tperf.gops_macs(n) == jperf.gops_macs(n)


def test_init_params_draw_like_reference():
    jp = jnet.resnet_small().init_params(np.random.default_rng(7))
    tp = tnet.resnet_small().init_params(np.random.default_rng(7),
                                         device="cpu")
    for a, b in zip(jp, tp):
        assert (a is None) == (b is None)
        if a is not None:
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


@pytest.mark.parametrize("net", ["lenet", "resnet_small", "unet_small"])
def test_float_oracle_matches_reference(net):
    rng = np.random.default_rng(8)
    jp, tp = getattr(jnet, net)(), getattr(tnet, net)()
    params = jp.init_params(rng)
    x = rng.normal(size=(2, *jp.input_shape)).astype(np.float32)
    want = np.asarray(jp.apply_ref(params, jnp.asarray(x)))
    got = tp.apply_ref(_torch_params(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("net,per_channel", [
    ("lenet", False), ("resnet_small", False), ("mobilenet_small", True),
    ("unet_small", True)])
def test_quantize_network_field_by_field(net, per_channel):
    rng = np.random.default_rng(9)
    jp, tp = getattr(jnet, net)(), getattr(tnet, net)()
    params = jp.init_params(rng)
    x = rng.normal(size=(4, *jp.input_shape)).astype(np.float32)
    jq = jnet.quantize_network(jp, params, jnp.asarray(x),
                               per_channel=per_channel)
    tq = tnet.quantize_network(tp, _torch_params(params),
                               torch.from_numpy(x), per_channel=per_channel)
    assert tq.per_channel == jq.per_channel
    np.testing.assert_array_equal(tq.in_scale.numpy(),
                                  np.asarray(jq.in_scale))
    for a, b in zip(jq.weights, tq.weights):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    close = dict(rtol=1e-6, atol=0)
    for a, b in zip(jq.requants, tq.requants):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **close)
    np.testing.assert_allclose(tq.out_dequant.numpy(),
                               np.asarray(jq.out_dequant), **close)
    for a, b in zip(jq.biases, tq.biases):
        if a is not None:                  # round(b / scale): ±1 at most
            assert np.abs(b.numpy().astype(np.int64)
                          - np.asarray(a).astype(np.int64)).max() <= 1
    assert len(tq.merge_scales) == len(jq.merge_scales)
    for a, b in zip(jq.merge_scales, tq.merge_scales):
        assert (a is None) == (b is None)
        for sa, sb in zip(a or (), b or ()):
            np.testing.assert_allclose(sb.numpy(), np.asarray(sa), **close)


def test_convcore_paper_layer_bit_equal():
    """The §5.2 layer (224×224×8 ⊛ 3×3×8) through the int8 ``ConvCore``,
    kernels' plain versions on the CPU, against the reference core."""
    rng = np.random.default_rng(10)
    shp = tconvcore.paper_workload()
    x = rng.integers(-128, 128, size=shp["x"]).astype(np.int8)
    w = rng.integers(-128, 128, size=shp["w"]).astype(np.int8)
    b = rng.integers(-2000, 2000, size=shp["bias"]).astype(np.int32)
    want = jconvcore.ConvCore(jconvcore.ConvCoreConfig(
        int8=True, backend="ref")).apply_layer(
            *map(jnp.asarray, (x, w, b)), relu=True)
    core = tconvcore.ConvCore(tconvcore.ConvCoreConfig(int8=True))
    got = core.apply_layer(*(torch.from_numpy(a) for a in (x, w, b)),
                           relu=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plan = core.plan(shp["x"], shp["w"])
    assert plan.fits_smem and plan.pipelined
    with pytest.raises(TypeError, match="int8 operands"):
        core.apply_layer(torch.zeros(shp["x"]), torch.from_numpy(w))


def test_convcore_quantized_layer_matches_reference():
    """Float in / float out through the int8 core: the same symmetric
    quantization, int32 accumulation and dequantize as the reference."""
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 12, 12, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 16)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    kw = dict(stride=1, padding="SAME", relu=True, pool=True)
    want = jconvcore.ConvCore(jconvcore.ConvCoreConfig(
        backend="ref")).apply_quantized_layer(
            *map(jnp.asarray, (x, w, b)), **kw)
    got = tconvcore.ConvCore().apply_quantized_layer(
        *(torch.from_numpy(a) for a in (x, w, b)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
