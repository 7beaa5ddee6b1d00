"""The port's multi-core scheduler against the JAX reference.

One reference-quantized qnet per net is carried across
(``test_torch_program.carry``), and the same images go through the JAX
``MultiCoreScheduler`` (its ``ref`` backend, sharded) and the port's, in
each of the batch, kout and spatial modes at 1–4 virtual cores, on
``lenet``, ``unet_small`` and ``mobilenet_small``.  The port runs its
sharded ``cuda`` backend (on CPU tensors the kernels' plain versions) and
its sharded ``ref`` backend.  Every int8 path is exact, so the logits are
bit-equal, to each other and to the unsharded JAX program; where the
reference's kout sharding refuses a grouped layer (a core slice that cuts
through a group), the port raises the same ``ValueError``.  Three images
make every batch-mode run at 2 and 4 cores ragged.

A sharded or transposed program derives its weight shards, flipped
kernels and packed weights once: across repeated batches ``pack_weights``
packs each layer's shard once."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convcore as jconvcore
from repro.core import network as jnet
from repro.core import scheduler as jsched
from repro.core.convcore import ConvCoreConfig as JConfig
from repro_torch.core import convcore as tconvcore
from repro_torch.core import network as tnet
from repro_torch.core import scheduler as tsched
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.kernels import conv2d_ws as tconv
from test_torch_program import carry, jax_quantize

NETS = ("lenet", "unet_small", "mobilenet_small")
_QNETS = {}


@pytest.fixture(autouse=True)
def _port_registry():
    """The port's backend registry is process-global: restore it after
    each test (the shared conftest snapshots only the reference's)."""
    snapshot = dict(tconvcore.BACKENDS)
    yield
    tconvcore.BACKENDS.clear()
    tconvcore.BACKENDS.update(snapshot)


def _nets(net):
    """(JAX qnet, port qnet, images) for ``net``, quantized once."""
    if net not in _QNETS:
        rng = np.random.default_rng(21)
        jp, tp = getattr(jnet, net)(), getattr(tnet, net)()
        params = jp.init_params(rng)
        x = rng.normal(size=(3, *jp.input_shape)).astype(np.float32)
        jq = jax_quantize(jp, params, jnp.asarray(x))
        _QNETS[net] = (jq, carry(jq, tp), x)
    return _QNETS[net]


def _jax_run(jq, x, mode, cores):
    sched = jsched.MultiCoreScheduler(jsched.SchedulerConfig(cores, mode))
    backend = "ref"
    if mode != "batch":
        sb = sched.shard_backend("ref")
        jconvcore.register_backend(sb)
        backend = sb.name
    program = jnet.make_int8_program(jq, JConfig(backend=backend, int8=True))
    return np.asarray(sched.run(program, jnp.asarray(x)))


def _port_run(tq, x, mode, cores, inner):
    sched = tsched.MultiCoreScheduler(tsched.SchedulerConfig(cores, mode))
    backend = inner
    if mode != "batch":
        sb = sched.shard_backend(inner)
        tconvcore.register_backend(sb)
        backend = sb.name
    program = tnet.make_int8_program(
        tq, ConvCoreConfig(backend=backend, int8=True))
    return sched.run(program, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mode", ["batch", "kout", "spatial"])
def test_scheduler_bit_equal_to_reference(net, mode):
    jq, tq, x = _nets(net)
    unsharded = np.asarray(jnet.make_int8_program(
        jq, JConfig(backend="ref", int8=True))(jnp.asarray(x)))
    for cores in (1, 2, 3, 4):
        try:
            want = _jax_run(jq, x, mode, cores)
        except ValueError as e:          # the reference refuses the split
            assert "cannot split" in str(e)
            for inner in ("cuda", "ref"):
                with pytest.raises(ValueError, match="cannot split"):
                    _port_run(tq, x, mode, cores, inner)
            continue
        np.testing.assert_array_equal(want, unsharded)
        for inner in ("cuda", "ref"):
            got = _port_run(tq, x, mode, cores, inner)
            np.testing.assert_array_equal(got, want, err_msg=(
                f"{net} {mode} cores={cores} inner={inner}"))


def test_grouped_kout_refusal_is_the_references():
    """mobilenet_small's depthwise layers (8 groups of 1 kernel) cannot be
    cut into 3 core slices: both packages raise."""
    jq, tq, x = _nets("mobilenet_small")
    with pytest.raises(ValueError, match="cannot split K=8"):
        _jax_run(jq, x, "kout", 3)
    with pytest.raises(ValueError, match="cannot split K=8"):
        _port_run(tq, x, "kout", 3, "cuda")


def test_scheduler_config_and_validation():
    class Tune:
        n_cores, scheduler_mode = 4, "spatial"

    assert tsched.SchedulerConfig.for_tune(Tune()) == \
        tsched.SchedulerConfig(4, "spatial")
    sched = tsched.MultiCoreScheduler.from_tune(Tune())
    sb = sched.shard_backend("cuda")
    assert isinstance(sb, tsched.SpatialShardedBackend)
    assert sb.name == "cuda@spatial4"
    kb = tsched.MultiCoreScheduler(
        tsched.SchedulerConfig(2, "kout")).shard_backend("ref")
    assert isinstance(kb, tsched.KoutShardedBackend) and kb.name == "ref@kout2"
    with pytest.raises(ValueError, match="scheduler mode"):
        tsched.MultiCoreScheduler(tsched.SchedulerConfig(2, "rows"))
    with pytest.raises(ValueError, match="n_cores"):
        tsched.MultiCoreScheduler(tsched.SchedulerConfig(0, "batch"))
    tconvcore.register_backend(kb)
    assert tconvcore.get_backend("ref@kout2") is kb
    tconvcore.unregister_backend("ref@kout2")
    tconvcore.unregister_backend("ref@kout2")     # absent: no-op
    with pytest.raises(ValueError, match="unknown backend"):
        tconvcore.get_backend("ref@kout2")


@pytest.mark.parametrize("mode,net", [("kout", "unet_small"),
                                      ("spatial", "unet_small"),
                                      ("kout", "lenet")])
def test_weights_are_packed_once_across_batches(monkeypatch, mode, net):
    """A sharded program, transposed convs included, packs each layer's
    (shard's) weights once however many batches it runs: the spy stands
    in for the card's launch, which packs the weights it is handed."""
    _, tq, x = _nets(net)
    # weights of its own, which no earlier test has packed
    tq = dataclasses.replace(tq, weights=tuple(
        None if w is None else w.clone() for w in tq.weights))
    packs = []
    pack = tconv._pack
    monkeypatch.setattr(tconv, "_pack",
                        lambda w: packs.append(w.shape) or pack(w))
    run_conv = tconv.run_conv

    def spy(lib_name, pipelined, plain, x_, w, *args, **kw):
        if w.dtype == torch.int8:
            tconv.pack_weights(w)
        return run_conv(lib_name, pipelined, plain, x_, w, *args, **kw)

    monkeypatch.setattr(tconv, "run_conv", spy)
    from repro_torch.kernels import conv2d_ws_pipe as tpipe
    monkeypatch.setattr(tpipe, "run_conv", spy)
    sched = tsched.MultiCoreScheduler(tsched.SchedulerConfig(2, mode))
    sb = sched.shard_backend("cuda")
    tconvcore.register_backend(sb)
    program = tnet.make_int8_program(
        tq, ConvCoreConfig(backend=sb.name, int8=True))
    first = program(torch.from_numpy(x))
    once = len(packs)
    # a kout layer packs one slice a core (the head's K = 3 runs on one
    # core: 2 does not divide it); a spatial layer packs its weights once
    assert once == sum(
        sb._shards(shp["w"][3]) if mode == "kout" else 1
        for sp, shp in zip(tq.plan.layers, tq.plan.param_shapes())
        if sp.kind in ("conv", "conv_transpose")), packs
    for _ in range(3):
        assert torch.equal(program(torch.from_numpy(x)), first)
    assert len(packs) == once
