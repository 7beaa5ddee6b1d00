"""The conv kernels as ``torch.library`` ops: ``repro_torch::conv2d_ws`` and
``repro_torch::conv2d_ws_pipe``.

A dispatch mode sees one op where a conv kernel runs, so that
``roofline.counts.CostCounter`` counts a conv program on the card and on
fake CUDA tensors alike: the fake kernel gives the plain version's shape
and dtype on every path's geometry (tc, simt, dw, nk), the FLOP
formula ``2·N·OH·OW·K·(C/groups)·KH·KW`` lands in the operands' dtype
(int8 or float32) and equals the reference's ``tpu_conv_roofline`` on
VALID layers, and the zoo's int8 programs trace on fake CUDA tensors
without reaching a launch.  The op's CPU result is held to the JAX
reference, one case a path.  Fake CUDA tensors are made here from meta
tensors (``FakeTensor(mode, meta, cuda)``): no card is needed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.core.perfmodel import tpu_conv_roofline
from repro.kernels import ops as jops
from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.core.perfmodel import F32_OPS_PER_S, h100_conv_roofline
from repro_torch.kernels import conv2d_ws as tconv
from repro_torch.kernels import matmul_ws as tmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.conv2d_ws import (conv2d_ws, conv2d_ws_plain,
                                           conv_flops, conv_path, setup_conv)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.roofline import counts
from repro_torch.roofline.analysis import H100, terms
from test_torch_cuda import (CASES, DW_CASES, TC_CASES, as_torch,
                             case_inputs, legal_banks, tc_case_inputs)

KERNELS = {"conv2d_ws": conv2d_ws, "conv2d_ws_pipe": conv2d_ws_pipe}
TABLES = {"cases": CASES, "tc": TC_CASES, "dw": DW_CASES}
GEOMETRIES = [(t, n) for t, table in TABLES.items() for n in sorted(table)]
CUDA = torch.device("cuda", 0)


def _inputs(table, name, f32):
    """A case's x, w, b, scale, kwargs (banks legal for the wrappers)."""
    if table == "tc":
        x, w, b, s, kw = tc_case_inputs(name)
        if f32:
            x, w = x.astype(np.float32) / 64, w.astype(np.float32) / 64
            b, s = b.astype(np.float32) / 100, None
        return x, w, b, s, kw
    return legal_banks(*case_inputs(name, f32=f32, table=TABLES[table]))


def _fake_cuda(mode, t):
    """A fake CUDA tensor of ``t``'s shape and dtype (None stays None)."""
    return None if t is None else FakeTensor(mode, t.to("meta"), CUDA)


@pytest.fixture
def no_launch(monkeypatch):
    """Make any launch, library build or CUDA start-up raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached the card's path")
    monkeypatch.setattr(tconv, "launch_conv", refuse)
    monkeypatch.setattr(tmm, "_launch", refuse)
    monkeypatch.setattr(tconv._build, "load", refuse)
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)


def _on_path(table, name, f32):
    x, w, b, s, kw = _inputs(table, name, f32)
    geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
    return conv_path(setup_conv(x.shape, w.shape, pool=kw.get("pool", False),
                                requant=s is not None, int_path=not f32,
                                **geo))


def test_geometries_reach_every_path():
    """The parametrised geometries below cover the four paths the rule
    hands their shapes (no geometry of the tables reaches the scalar
    kernel since the nk path)."""
    paths = {_on_path(t, n, f32) for t, n in GEOMETRIES
             for f32 in (False, True)}
    assert paths == {"tc", "simt", "dw", "nk"}


@pytest.mark.parametrize("f32", [False, True], ids=["int8", "f32"])
@pytest.mark.parametrize("table,name", GEOMETRIES)
def test_fake_output_has_the_plain_shape_and_dtype(no_launch, table, name,
                                                   f32):
    """Each op on fake CUDA tensors gives the plain result's shape and
    dtype, and counts what ``conv2d_ws`` counts on CPU tensors: the FLOP
    formula in the operands' dtype (both ops on CPU tensors:
    ``test_count_equals_the_reference_roofline``)."""
    x, w, b, s, kw = _inputs(table, name, f32)
    tx, tw, tb, ts = as_torch(x, w, b, s)
    want, real = counts.analyze(conv2d_ws, tx, tw, tb, ts, **kw)
    assert torch.equal(want, conv2d_ws_plain(tx, tw, tb, ts, **kw))
    assert real.op_counts == {"repro_torch.conv2d_ws": 1}
    kh, kwd, cg, k = w.shape
    oh, ow = ref.conv_out_shape(x.shape[1], x.shape[2], kh, kwd,
                                kw.get("stride", 1), kw.get("padding",
                                                            "VALID"),
                                kw.get("dilation", 1))
    assert dict(real.flops_by_dtype) == {
        "float32" if f32 else "int8":
            2 * x.shape[0] * oh * ow * k * cg * kh * kwd}
    mode = FakeTensorMode()
    fx, fw, fb, fs = (_fake_cuda(mode, t) for t in (tx, tw, tb, ts))
    for name_, fn in KERNELS.items():
        with mode, counts.CostCounter() as fake:
            got = fn(fx, fw, fb, fs, **kw)
        assert isinstance(got, FakeTensor) and got.device == CUDA
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        assert fake.costs.op_counts == {f"repro_torch.{name_}": 1}
        fake.costs.op_counts = real.op_counts
        assert fake.costs.as_dict() == real.as_dict()


# VALID layers: (H, W, C, K, KH, KW)
ROOFLINE_GRID = [(h, w, c, k, kk, kk)
                 for h, w in ((7, 9), (16, 16))
                 for c, k in ((1, 8), (8, 16), (12, 4))
                 for kk in (1, 3, 5)]


@pytest.mark.parametrize("f32", [False, True], ids=["int8", "f32"])
def test_count_equals_the_reference_roofline(no_launch, f32):
    """On every VALID layer of the grid each op counts the reference's
    ``tpu_conv_roofline`` FLOPs (and the port's ``h100_conv_roofline``'s)
    in the operands' dtype, on CPU and fake CUDA tensors alike, and
    ``terms`` prices the count on the H100."""
    rng = np.random.default_rng(7)
    dt = np.float32 if f32 else np.int8
    mode = FakeTensorMode()
    for h, w_, c, k, kh, kw in ROOFLINE_GRID:
        x = torch.from_numpy(rng.integers(-9, 9, (1, h, w_, c)).astype(dt))
        w = torch.from_numpy(rng.integers(-9, 9, (kh, kw, c, k)).astype(dt))
        want = tpu_conv_roofline(h, w_, c, k, kh, kw)["flops"]
        assert want == h100_conv_roofline(
            h, w_, c, k, kh, kw, in_bytes=4 if f32 else 1,
            peak_ops=F32_OPS_PER_S if f32 else H100["peak_flops"]["int8"]
        )["flops"]
        geo = dict(cin_banks=1, kout_banks=1)
        fx, fw = _fake_cuda(mode, x), _fake_cuda(mode, w)
        for fn in KERNELS.values():
            _, real = counts.analyze(fn, x, w, **geo)
            with mode, counts.CostCounter() as fake:
                fn(fx, fw, **geo)
            for c_ in (real, fake.costs):
                assert dict(c_.flops_by_dtype) == {
                    "float32" if f32 else "int8": want}
                t = terms(c_, H100)
                peak = H100["peak_flops"]["float32" if f32 else "int8"]
                assert t["compute"] == pytest.approx(want / peak)
                assert t["memory"] > 0
            assert fake.costs.as_dict() == real.as_dict()


def test_transposed_conv_counts_the_zero_inserted_conv(no_launch):
    """A transposed conv counts what its host lowering launches: the
    stride-1 conv of the zero-inserted map."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-9, 9, (2, 6, 5, 8)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-9, 9, (3, 3, 8, 4)).astype(np.int8))
    _, c = counts.analyze(ops.conv2d_transpose, x, w, stride=2,
                          padding="SAME")
    # SAME at stride 2: a 12 × 10 output from the 11 × 9 zero-inserted
    # map padded to 14 × 12
    assert c.op_counts == {"repro_torch.conv2d_ws": 1}
    assert c.flops == 2 * 2 * 12 * 10 * 4 * 8 * 3 * 3
    assert conv_flops((2, 11, 9, 8), (3, 3, 8, 4), None, None, None, 1,
                      [1, 2, 1, 2], 1, 1) == c.flops


def _fake_program(qnet, mode):
    """``make_int8_program`` of ``qnet`` with every tensor of it a fake CUDA
    tensor."""
    def fake(v):
        if isinstance(v, torch.Tensor):
            return _fake_cuda(mode, v)
        if isinstance(v, tuple):
            return tuple(fake(e) for e in v)
        return v
    fq = dataclasses.replace(qnet, **{
        f.name: fake(getattr(qnet, f.name))
        for f in dataclasses.fields(qnet) if f.name != "plan"})
    return network.make_int8_program(fq, ConvCoreConfig(int8=True))


def _qnet(plan):
    rng = np.random.default_rng(0)
    params = plan.init_params(rng, device="cpu")
    calib = torch.from_numpy(rng.normal(
        size=(1, *plan.input_shape)).astype(np.float32))
    return network.quantize_network(plan, params, calib)


def _layer_flops(plan, batch):
    """The conv layers' FLOP formula summed from the plan's geometry."""
    acts, total = plan.activation_shapes(), 0
    for i, (sp, shp) in enumerate(zip(plan.layers, plan.param_shapes())):
        if sp.kind != "conv":
            continue
        ins = plan.resolved_inputs()[i][0]
        h, w_, _ = plan.input_shape if ins < 0 else acts[ins]
        kh, kw, cg, k = shp["w"]
        oh, ow = ref.conv_out_shape(h, w_, kh, kw, sp.stride, sp.padding,
                                    sp.dilation)
        total += 2 * batch * oh * ow * k * cg * kh * kw
    return total


@pytest.mark.parametrize("net,batch", [("lenet", 2), ("vgg_imagenet", 8)])
def test_int8_program_traces_on_fake_cuda_tensors(no_launch, net, batch):
    """The int8 program's forward runs on fake CUDA tensors (``vgg_imagenet``
    at 224, batch 8) with one conv op a conv layer and one ``matmul_ws``
    op a dense layer, the conv FLOPs in the int8 bucket; ``lenet``'s
    count equals its count on CPU tensors, and its fake logits have the
    real ones' shape and dtype."""
    plan = getattr(network, net)()
    qnet = _qnet(plan)
    mode = FakeTensorMode()
    program = _fake_program(qnet, mode)
    x = torch.zeros((batch, *plan.input_shape))
    fx = _fake_cuda(mode, x)
    with mode, counts.CostCounter() as cc:
        logits = program(fx)
    fake = cc.costs
    n_conv = sum(sp.kind == "conv" for sp in plan.layers)
    n_dense = sum(sp.kind == "dense" for sp in plan.layers)
    assert logits.device == CUDA and logits.dtype == torch.float32
    assert sum(v for k, v in fake.op_counts.items()
               if k.startswith("repro_torch.conv2d_ws")) == n_conv
    assert fake.op_counts.get("repro_torch.matmul_ws", 0) == n_dense
    assert set(fake.op_counts) <= {"repro_torch.conv2d_ws",
                                   "repro_torch.conv2d_ws_pipe",
                                   "repro_torch.matmul_ws"}
    dense = sum(2 * batch * shp["w"][0] * shp["w"][1]
                for sp, shp in zip(plan.layers, plan.param_shapes())
                if sp.kind == "dense")
    assert dict(fake.flops_by_dtype) == {
        "int8": _layer_flops(plan, batch) + dense}
    assert max(terms(fake, H100).values()) > 0
    if net == "lenet":
        real_logits, real = counts.analyze(
            network.make_int8_program(qnet, ConvCoreConfig(int8=True)), x)
        assert real.as_dict() == fake.as_dict()
        assert (logits.shape, logits.dtype) == (real_logits.shape,
                                                real_logits.dtype)


def test_cuda_call_that_autograd_records_raises():
    """On fake CUDA tensors that require grad, a direct conv call raises
    (the op has no backward), and runs under no-grad; on the CPU a
    recorded call runs the plain version, which autograd
    differentiates."""
    mode = FakeTensorMode()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 8)).astype(np.float32))
    fx, fw = _fake_cuda(mode, x), _fake_cuda(mode, w)
    with mode:
        fx, fw = fx.requires_grad_(), fw.requires_grad_()
        for fn in KERNELS.values():
            with pytest.raises(RuntimeError, match="has no backward"):
                fn(fx, fw, cin_banks=1, kout_banks=1)
            with torch.no_grad():
                assert fn(fx, fw, cin_banks=1, kout_banks=1).shape == (
                    1, 6, 6, 8)
    for fn in KERNELS.values():
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        with counts.CostCounter() as cc:
            y = fn(tx, tw, cin_banks=1, kout_banks=1)
        assert not any(k.startswith("repro_torch") for k in
                       cc.costs.op_counts)
        y.sum().backward()
        assert tx.grad is not None and tw.grad is not None


def test_other_devices_raise():
    x = torch.zeros((1, 6, 6, 4), dtype=torch.int8, device="meta")
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int8, device="meta")
    for fn in KERNELS.values():
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(x, w, cin_banks=1, kout_banks=1)


def test_ops_exist_with_fake_kernels_and_one_formula():
    from torch.utils.flop_counter import flop_registry
    for name in KERNELS:
        packet = getattr(torch.ops.repro_torch, name)
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            packet.default.name(), "CPU")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            packet.default.name(), "CUDA")
        assert packet in flop_registry


# one case a path, the op's CPU result against the JAX reference's conv:
# (table, name, f32, the path it takes on the card)
PARITY = [("tc", "c4_k32", False, "tc"),
          ("cases", "stride2_valid_int32", True, "simt"),
          ("cases", "depthwise_stride2", False, "dw"),
          ("cases", "groups2", False, "nk")]


@pytest.mark.parametrize("table,name,f32,path", PARITY)
def test_op_cpu_result_matches_the_reference(table, name, f32, path):
    """Each op's CPU result (through the op: the counter sees it) against
    the reference's ``ops.conv2d`` (Pallas in interpret mode): int8
    bit-equal, f32 within 1e-4."""
    assert _on_path(table, name, f32) == path
    x, w, b, s, kw = _inputs(table, name, f32)
    tx, tw, tb, ts = as_torch(x, w, b, s)
    for pipelined, (op_name, fn) in zip((False, True), KERNELS.items()):
        want = np.asarray(jops.conv2d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            out_scale=None if s is None else jnp.asarray(s),
            pipelined=pipelined, **kw))
        got, c = counts.analyze(fn, tx, tw, tb, ts, **kw)
        assert c.op_counts == {f"repro_torch.{op_name}": 1}
        assert got.numpy().dtype == want.dtype
        if f32:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
