"""The int8 tensor-core conv path's host side against the JAX reference, on
the CPU.

The tensor-core kernels (``csrc/conv2d_ws.cu``, ``csrc/conv2d_ws_pipe.cu``)
run only on the card.  What surrounds them is host code the CPU reaches:
the path rule (``conv_path``), the launch plan (``tc_plan``: pool-aligned
128-pixel rectangles across images, N-tiles inside one group, K-chunks in
(tap, channel) order padded to 32), the K-major weight packing and the
A-operand address arithmetic (``tc_windows``).  ``conv2d_ws_tc_emulate``
replays that plan block by block in plain PyTorch, with int32 accumulators
that start at the bias, and is held bit-equal here to the JAX package:
whole-map JAX ``conv2d_ws`` (Pallas in interpret mode) or, for the §5.2
layer, ``repro.kernels.ref.conv2d_epilogue_ref``.  Tiled JAX ``conv2d_ws``
is never the reference: it does not run under the installed jax.  The same
geometries run on the card in ``test_torch_cuda.py``."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig, paper_workload
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import (SMEM_BYTES, SMS, TC_BM, TC_FIELDS,
                                           blocks_per_sm, conv2d_ws,
                                           conv2d_ws_tc_emulate, conv_path,
                                           pack_weights, setup_conv, tc_plan,
                                           tc_windows)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from test_torch_cuda import TC_CASES, as_torch, tc_case_inputs

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def zoo_convs(net, batch, **plan_kw):
    """{label: (x shape, w shape, conv kwargs)} of every conv of a zoo
    network, with the bank counts ``ops.conv2d`` legalizes to."""
    plan = getattr(network, net)(**plan_kw)
    acts, ins = plan.activation_shapes(), plan.resolved_inputs()
    pshapes, geoms = plan.param_shapes(), plan.conv_geometries()
    out = {}
    for i, sp in enumerate(plan.layers):
        if sp.kind != "conv":
            continue
        src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        ws = pshapes[i]["w"]
        groups = geoms[i][1]
        cin, kout = ref.grouped_banks(src[2], ws[3], groups)
        out[f"{net}:{plan.node_names()[i]}"] = ((batch, *src), ws, dict(
            stride=sp.stride, padding=sp.padding, groups=groups,
            cin_banks=cin, kout_banks=kout, relu=sp.relu, pool=sp.pool,
            dilation=sp.dilation))
    return out


# (x shape, w shape, conv kwargs), each with a per-channel requant scale
LAYERS = {
    **zoo_convs("lenet", 2),
    **zoo_convs("vgg_imagenet", 2, input_shape=(32, 32, 4)),
    **zoo_convs("resnet_small", 2),
    **zoo_convs("mobilenet_small", 2),
    "stride2_dilation2_explicit": ((2, 23, 21, 16), (3, 3, 16, 24), dict(
        stride=2, dilation=2, padding=((2, 1), (1, 3)), relu=True)),
    "resnet_small_b2c1_groups2": ((2, 32, 32, 16), (3, 3, 8, 32), dict(
        stride=2, padding="SAME", groups=2, kout_banks=2, relu=True)),
    "per_channel_requant_pool": ((2, 14, 14, 64), (3, 3, 64, 64), dict(
        padding="SAME", relu=True, pool=True)),
}


def layer_inputs(name):
    xs, ws, kw = LAYERS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.integers(-128, 128, size=xs).astype(np.int8)
    w = rng.integers(-128, 128, size=ws).astype(np.int8)
    b = rng.integers(-4000, 4000, size=(ws[3],)).astype(np.int32)
    s = (rng.random(ws[3]) * 0.004 + 1e-4).astype(np.float32)
    return x, w, b, s, dict(kw)


def geom(x_shape, w_shape, kw, requant):
    geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
    return setup_conv(tuple(x_shape), tuple(w_shape),
                      pool=kw.get("pool", False), requant=requant, **geo)


def jax_conv(x, w, b, s, kw):
    """Whole-map JAX ``conv2d_ws`` (Pallas, interpret mode on the CPU)."""
    return np.asarray(jops.conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        out_scale=None if s is None else jnp.asarray(s), **kw))


def check_emulation(x, w, b, s, kw, want):
    g = geom(x.shape, w.shape, kw, s is not None)
    assert conv_path(g) == "tc"
    tx, tw, tb, ts = as_torch(x, w, b, s)
    for pipelined in (False, True):
        got = conv2d_ws_tc_emulate(tx, tw, tb, ts, pipelined=pipelined, **kw)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_tc_emulation_bit_equal_to_jax_conv(name):
    x, w, b, s, kw = layer_inputs(name)
    if w.shape[3] // kw.get("groups", 1) < 8:    # depthwise: the dw path
        assert conv_path(geom(x.shape, w.shape, kw, True)) == "dw"
        return
    check_emulation(x, w, b, s, kw, jax_conv(x, w, b, s, kw))


@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_tc_edge_cases_bit_equal_to_jax_conv(name):
    x, w, b, s, kw = tc_case_inputs(name)
    check_emulation(x, w, b, s, kw, jax_conv(x, w, b, s, kw))


def test_paper_layer_int32_bit_equal_to_jax_oracle():
    shp = paper_workload()
    rng = np.random.default_rng(52)
    x = rng.integers(-128, 128, size=shp["x"]).astype(np.int8)
    w = rng.integers(-128, 128, size=shp["w"]).astype(np.int8)
    b = rng.integers(-4000, 4000, size=shp["bias"]).astype(np.int32)
    want = np.asarray(jref.conv2d_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    assert want.dtype == np.int32
    check_emulation(x, w, b, None, {}, want)


@pytest.mark.parametrize("dtype,c,k,groups,expect", [
    (torch.int8, 4, 32, 1, "tc"),
    (torch.int8, 1, 8, 1, "tc"),            # lenet conv0, K/g = 8
    (torch.int8, 8, 7, 1, "nk"),            # K/g = 7
    (torch.int8, 32, 32, 4, "tc"),          # K/g = 8
    (torch.int8, 32, 32, 8, "nk"),          # K/g = 4
    (torch.int8, 32, 32, 32, "dw"),         # depthwise
    (torch.float32, 32, 64, 1, "simt"),     # f32 runs the FFMA GEMM
])
def test_path_rule(dtype, c, k, groups, expect):
    g = setup_conv((2, 12, 12, c), (3, 3, c // groups, k), padding="SAME",
                   groups=groups, cin_banks=1, kout_banks=groups,
                   int_path=dtype == torch.int8)
    assert conv_path(g) == expect
    assert (tc_plan(g) is None) == (expect != "tc")


def test_tc_params_record_matches_cuda_struct():
    """The host packs ``TcParams`` by field order; the C struct in
    csrc/conv_common.cuh must list the same fields in the same order."""
    src = (CSRC / "conv_common.cuh").read_text()
    body = re.search(r"struct TcParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl.startswith("int "):
            names += [n.strip() for n in decl[4:].rstrip(";").split(",")]
    assert tuple(names) == TC_FIELDS
    assert re.search(rf"kTcBM = {TC_BM};", src)


ALL_TC = {**{k: v[:3] for k, v in TC_CASES.items()}, **LAYERS}


@pytest.mark.parametrize("name", sorted(ALL_TC))
def test_tc_plan_invariants(name):
    xs, ws, kw = ALL_TC[name]
    g = geom(xs, ws, kw, True)
    seq = tc_plan(g, kw.get("relu", False), False)
    if seq is None:
        return
    pipe = tc_plan(g, kw.get("relu", False), True)
    assert seq._replace(stages=0, slots=0, smem=0) == \
        pipe._replace(stages=0, slots=0, smem=0)
    assert seq.rh * seq.rw == TC_BM
    if seq.pool:
        assert seq.rh % 2 == 0 and seq.rw % 2 == 0
    assert seq.bn in (32, 64) and seq.n_nt * seq.bn >= seq.kgrp
    assert seq.n_slices * seq.cs == seq.cgrp
    assert seq.ksp % 32 == 0 and seq.ksp >= seq.taps * seq.cs
    assert seq.kpad % 32 == 0 and seq.kpad >= seq.taps * seq.cgrp
    assert seq.ps >= seq.cs and seq.ws % 32 == 16
    assert seq.stages == seq.slots == 1 and seq.smem <= SMEM_BYTES
    assert 1 <= pipe.stages <= 4 and pipe.slots == min(pipe.stages,
                                                       pipe.n_slices)
    # the ring keeps conv2d_ws's blocks per SM, one slot where two cost one
    held = blocks_per_sm(seq.bn, seq.smem)
    assert blocks_per_sm(pipe.bn, pipe.smem) == held
    if pipe.stages == 1:
        assert pipe.smem == seq.smem
        assert blocks_per_sm(seq.bn, seq.smem - seq.slot_bytes
                             + 2 * seq.slot_bytes) < held
    rows, table = tc_windows(seq)
    assert int(rows.max() + table.max()) < seq.win_h * seq.win_w * seq.ps
    if seq.word:
        # one 32-bit load feeds four K columns: aligned, inside one tap
        t = table.reshape(-1, 4)
        pad = t[:, 0] < 0
        assert bool((t[pad] < 0).all())
        assert bool((t[~pad] == t[~pad, :1] + torch.arange(4)).all())
        assert bool((t[~pad, 0] % 4 == 0).all()) and seq.ps % 4 == 0


# geometries at the edge of a block's shared memory: a 7×7 stride-2 layer
# whose second ring slot would halve the SM's blocks, and an 11×11 stride-4
# layer whose one K-chunk does not fit a block
SMEM_EDGES = {
    "c64_7x7_stride2": ((2, 56, 56, 64), (7, 7, 64, 32),
                        dict(stride=2, padding="SAME", relu=True)),
    "c64_11x11_stride4": ((1, 227, 227, 64), (11, 11, 64, 64),
                          dict(stride=4, relu=True)),
}


@pytest.mark.parametrize("name", sorted({**ALL_TC, **SMEM_EDGES}))
def test_tc_plans_none_together(name):
    """Both wrappers follow ``conv_path``: their tensor-core plans are None
    together, so ``conv2d_ws_pipe`` never takes the scalar kernel (or
    overflows shared memory) on a layer ``conv2d_ws`` runs on the tensor
    cores."""
    xs, ws, kw = {**ALL_TC, **SMEM_EDGES}[name]
    for requant in (False, True):
        g = geom(xs, ws, kw, requant)
        for relu in (False, True):
            plans = [tc_plan(g, relu, pipelined) for pipelined in (False,
                                                                   True)]
            assert [p is None for p in plans] == [conv_path(g) != "tc"] * 2
            assert all(p is None or p.smem <= SMEM_BYTES for p in plans)
    if name in SMEM_EDGES:
        pipe = tc_plan(geom(xs, ws, kw, True), True, True)
        assert (pipe is None) == (name == "c64_11x11_stride4")
        assert pipe is None or (pipe.stages == pipe.slots == 1
                                and pipe.n_slices == 2)


def test_vgg_imagenet_blocks_fill_the_card():
    """At 224×224 and batch 8 every conv of the served network takes the
    tensor-core path with about one block per SM or more."""
    plan = network.vgg_imagenet()
    tps = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
    for name, (xs, ws, kw) in zoo_convs("vgg_imagenet", 8).items():
        assert any(tp is not None for tp in tps)
        p = tc_plan(geom(xs, ws, kw, True), kw["relu"], True)
        blocks = p.n * p.n_ry * p.n_rx * (p.k // p.kgrp) * p.n_nt
        assert blocks >= SMS - 4, (name, blocks)


def test_pack_weights_layout_and_cache():
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.integers(-128, 128, size=(3, 3, 6, 16)).astype(
        np.int8))
    p = pack_weights(w)
    assert p.shape == (16, 64) and p.dtype == torch.int8
    for k in (0, 7, 15):
        for dy, dx, c in ((0, 0, 0), (1, 2, 5), (2, 1, 3)):
            assert p[k, (dy * 3 + dx) * 6 + c] == w[dy, dx, c, k]
    assert not p[:, 54:].any()                  # zero K padding
    assert pack_weights(w) is p                 # cached per tensor ...
    w[0, 0, 0, 0] += 1                          # ... and its version
    q = pack_weights(w)
    assert q is not p and q[0, 0] == w[0, 0, 0, 0]


def test_cpu_wrappers_launch_nothing():
    x, w, b, s, kw = tc_case_inputs("c4_k32")
    before = [(f.launches, f.tc_launches) for f in (conv2d_ws,
                                                    conv2d_ws_pipe)]
    for fn in (conv2d_ws, conv2d_ws_pipe):
        fn(*as_torch(x, w, b, s), **kw)
    assert [(f.launches, f.tc_launches)
            for f in (conv2d_ws, conv2d_ws_pipe)] == before
