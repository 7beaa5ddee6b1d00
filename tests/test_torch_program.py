"""End to end: the port's int8 program against the JAX program.

The reference quantizes each net (under one ``jax.jit``: eager
calibration compiles every op on its own and takes most of the test's
time), its ``QuantizedNetwork`` is carried across through
``repro_torch.convert`` (plain numpy), and both
``make_int8_program``s run on the same images: the reference through the
Pallas backend in interpret mode, the port through its kernel backend,
whose wrappers take the plain versions on CPU tensors.  The logits must be
bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core.convcore import ConvCoreConfig as JConfig
from repro_torch import convert
from repro_torch.core import network as tnet
from repro_torch.core.convcore import ConvCoreConfig

NETS = {
    "lenet": {},
    "vgg_imagenet": dict(input_shape=(32, 32, 4), classes=16),
    "vgg_small": {},
}


def _np(v):
    return None if v is None else np.asarray(v)


def jax_quantize(jp, params, x):
    """The reference ``quantize_network`` of ``jp``, traced as one program."""
    array_fields = [f.name for f in dataclasses.fields(jnet.QuantizedNetwork)
                    if f.name not in ("plan", "per_channel")]

    def arrays(params, x):
        q = jnet.quantize_network(jp, params, x)
        return {name: getattr(q, name) for name in array_fields}

    return jnet.QuantizedNetwork(jp, **jax.jit(arrays)(params, x))


def carry(jq, plan):
    """A reference ``QuantizedNetwork`` as the port's, on the CPU."""
    return convert.quantized_network(
        plan, weights=[_np(w) for w in jq.weights],
        biases=[_np(b) for b in jq.biases],
        requants=[_np(r) for r in jq.requants],
        in_scale=_np(jq.in_scale), out_dequant=_np(jq.out_dequant),
        merge_scales=[None if m is None else [_np(s) for s in m]
                      for m in jq.merge_scales],
        per_channel=jq.per_channel, device="cpu")


def check_logits_bit_equal(net, **kw):
    """Both programs on one carried-across qnet, for each kernel choice of
    the port and for its plain backend."""
    rng = np.random.default_rng(12)
    jp = getattr(jnet, net)(**kw)
    tp = getattr(tnet, net)(**kw)
    params = jp.init_params(rng)
    x = rng.normal(size=(2, *jp.input_shape)).astype(np.float32)
    jq = jax_quantize(jp, params, jnp.asarray(x))
    want = np.asarray(jnet.make_int8_program(
        jq, JConfig(backend="pallas", int8=True))(jnp.asarray(x)))
    tq = carry(jq, tp)
    for kernel in ("auto", "sequential"):
        got = tnet.make_int8_program(
            tq, ConvCoreConfig(int8=True, kernel=kernel))(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    ref = tnet.make_int8_program(tq, ConvCoreConfig(int8=True,
                                                    backend="ref"))
    np.testing.assert_array_equal(ref(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("net", sorted(NETS))
def test_int8_logits_bit_equal_to_reference(net):
    check_logits_bit_equal(net, **NETS[net])


def test_own_quantization_runs_close_to_float():
    """The port's own calibration end to end: the kernel and ref backends
    agree bit for bit, and the int8 logits track the float oracle."""
    rng = np.random.default_rng(13)
    plan = tnet.lenet()
    params = plan.init_params(rng, device="cpu")
    x = torch.from_numpy(rng.normal(size=(4, *plan.input_shape))
                         .astype(np.float32))
    qnet = tnet.quantize_network(plan, params, x)
    got = tnet.make_int8_program(qnet, ConvCoreConfig(int8=True))(x)
    ref = tnet.make_int8_program(qnet, ConvCoreConfig(int8=True,
                                                      backend="ref"))(x)
    assert torch.equal(got, ref)
    want = plan.apply_ref(params, x)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel < 0.1, rel


def test_program_rejects_bad_overrides():
    plan = tnet.lenet()
    rng = np.random.default_rng(14)
    qnet = tnet.quantize_network(
        plan, plan.init_params(rng, device="cpu"),
        torch.zeros((1, *plan.input_shape)) + 0.5)
    with pytest.raises(ValueError, match="one entry per node"):
        tnet.make_int8_program(qnet, tile_plans=[None])
    with pytest.raises(ValueError, match="unknown backend"):
        tnet.make_int8_program(qnet, ConvCoreConfig(backend="pallas"))
