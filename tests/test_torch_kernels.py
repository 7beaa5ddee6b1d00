"""The port's three kernel modules against the JAX reference.

On the CPU each wrapper (``conv2d_ws``, ``conv2d_ws_pipe``, ``matmul_ws``,
and the ``ops`` entries over them) runs its plain PyTorch version; those
are held against JAX ``ops.conv2d(..., pipelined=False/True)`` and
``ops.matmul_ws`` with Pallas in interpret mode.  Tiled plans are held
against the JAX pipelined kernel only: the reference's tiled ``conv2d_ws``
does not run under the installed jax.  The int path is bit-equal, f32
agrees within rtol = atol = 1e-4.

The same cases run on the card in ``test_torch_cuda.py``."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.kernels import ops
from repro_torch.kernels.conv2d_ws import (_GEOM_FIELDS, SMEM_BYTES,
                                           conv2d_ws, setup_conv,
                                           smem_bytes)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.matmul_ws import matmul_ws
from test_torch_cuda import (CASES, as_torch, case_inputs, is_tiled,
                             legal_banks)

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _jax_conv(x, w, b, s, kw, pipelined, wrap8=False):
    return np.asarray(jops.conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        out_scale=None if s is None else jnp.asarray(s), wrap8=wrap8,
        pipelined=pipelined, **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_conv_plain_bit_equal_to_reference(name):
    x, w, b, s, kw = legal_banks(*case_inputs(name))
    kernels = (True,) if is_tiled(kw) else (False, True)
    tx, tw, tb, ts = as_torch(x, w, b, s)
    before = (conv2d_ws.launches, conv2d_ws_pipe.launches)
    for pipelined in kernels:
        want = _jax_conv(x, w, b, s, kw, pipelined)
        got = ops.conv2d(tx, tw, tb, out_scale=ts, pipelined=pipelined, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype
    # the wrappers proper take the plain version for CPU tensors
    for fn in (conv2d_ws, conv2d_ws_pipe):
        got = fn(tx, tw, tb, ts, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (conv2d_ws.launches, conv2d_ws_pipe.launches) == before


@pytest.mark.parametrize("name", ["same_relu_pool_requant", "groups2",
                                  "tiled_pool_requant",
                                  "tiled_stride2_dilated"])
def test_f32_conv_plain_matches_reference(name):
    x, w, b, _, kw = case_inputs(name, f32=True)
    pipelined = is_tiled(kw)
    want = _jax_conv(x, w, b, None, kw, pipelined)
    got = ops.conv2d(*as_torch(x, w, b), pipelined=pipelined, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wrap8_bit_equal_to_reference():
    x, w, b, _, kw = case_inputs("stride2_valid_int32")
    want = _jax_conv(x, w, b, None, kw, False, wrap8=True)
    got = ops.conv2d(*as_torch(x, w, b), wrap8=True, **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ops.conv2d(*as_torch(x, w, b), wrap8=True, out_scale=0.5, **kw)


@pytest.mark.parametrize("m,k,n", [(3, 70, 33), (8, 256, 40)])
def test_matmul_plain_matches_reference(m, k, n):
    rng = np.random.default_rng(m * k * n)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    b = rng.integers(-1000, 1000, size=(n,)).astype(np.int32)
    want = np.asarray(jops.matmul_ws(*map(jnp.asarray, (x, w, b))))
    got = ops.matmul_ws(*as_torch(x, w, b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    xf, wf, bf = x / np.float32(9), w / np.float32(7), b / np.float32(50)
    want = np.asarray(jops.matmul_ws(*map(jnp.asarray, (xf, wf, bf))))
    got = ops.matmul_ws(*as_torch(xf, wf, bf))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert matmul_ws.launches == 0


def test_wrappers_refuse_bad_operands():
    x8 = torch.zeros((1, 6, 6, 4), dtype=torch.int8)
    w8 = torch.zeros((3, 3, 4, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="one type"):
        conv2d_ws(x8, w8.float())
    with pytest.raises(ValueError, match="banking invariant"):
        conv2d_ws_pipe(x8, w8, cin_banks=3)
    with pytest.raises(ValueError, match="pool-aligned"):
        conv2d_ws(x8, w8, padding="SAME", pool=True, h_tile=3)
    with pytest.raises(ValueError, match="C/groups"):
        conv2d_ws(x8, w8, groups=2, kout_banks=2)
    with pytest.raises(ValueError, match=r"\[M,K\] @ \[K,N\]"):
        matmul_ws(torch.zeros((2, 3), dtype=torch.int8),
                  torch.zeros((4, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv2d_ws(x8.to("meta"), w8.to("meta"))


def test_conv_params_record_matches_cuda_struct():
    """The Python side packs ``ConvParams`` by field order; the C struct
    in csrc/conv_common.cuh must list the same fields in the same order."""
    src = (CSRC / "conv_common.cuh").read_text()
    body = re.search(r"struct ConvParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl.startswith("int "):
            names += [n.strip() for n in decl[4:].rstrip(";").split(",")]
    py = [f if f != "dilation" else "dil" for f in _GEOM_FIELDS]
    assert names == py + ["relu", "pool", "xvec", "wvec"]


NETS = {"lenet": {}, "vgg_imagenet": {}, "vgg_small": {},
        "resnet_small": {}, "mobilenet_small": {}, "large_map": {}}


@pytest.mark.parametrize("net", sorted(NETS))
def test_hopper_plans_fit_one_block(net):
    """Every conv of the zoo, under its default Hopper plan, needs no more
    shared memory per block than a Hopper block may use, for both
    kernels."""
    plan = getattr(network, net)()
    acts = plan.activation_shapes()
    ins = plan.resolved_inputs()
    geoms = plan.conv_geometries()
    pw = plan.param_shapes()
    tps = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
    for i, tp in enumerate(tps):
        if tp is None:
            continue
        src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        sp = plan.layers[i]
        g = setup_conv((8, *src), pw[i]["w"], stride=sp.stride,
                       padding=sp.padding, groups=geoms[i][1],
                       cin_banks=tp.cin_banks, kout_banks=tp.kout_banks,
                       h_tile=tp.h_tile, w_tile=tp.w_tile, pool=sp.pool,
                       requant=True, dilation=sp.dilation)
        assert (g.n_th, g.n_tw) == (tp.n_h_tiles, tp.n_w_tiles)
        assert tp.working_set_bytes <= SMEM_BYTES, (net, i, tp)
        assert smem_bytes(g, 1) <= smem_bytes(g, 2) <= SMEM_BYTES
