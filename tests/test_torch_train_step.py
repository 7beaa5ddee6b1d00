"""One training step of the port against the JAX reference on the CPU.

The reference's ``TrainState`` is carried across as numpy
(``convert.train_state_to_torch``), so both packages step from the same
parameters and AdamW moments on the same batch.  On ``lenet`` (12×12×1),
``resnet_small`` (skip adds), a two-branch concat plan, ``mobilenet_small``
(grouped and depthwise convs) and ``unet_small`` (transposed convs,
per-pixel loss), each in float and in QAT, the loss, every gradient and
every updated parameter agree within rtol = atol = 1e-4.  The JAX side is
the reference's own loss under ``jax.value_and_grad`` (Pallas in interpret
mode, whole-map tiles) and its ``adamw_update``, which together are its
``make_train_step``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import training as jtr
from repro.optim.adamw import adamw_update
from repro_torch.convert import train_state_to_torch
from repro_torch.core import network as tnet
from repro_torch.core import training as ttr
from repro_torch.optim.adamw import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)


def _concat_net(net):
    return net.NetworkPlan(
        name="concat_net", input_shape=(8, 8, 4),
        layers=(
            net.conv(4, relu=True, name="a", input="input"),
            net.conv(4, relu=True, name="b", input="input"),
            net.concat("a", "b", name="m"),
            net.global_pool(),
            net.dense(4),
        ))


PLANS = {
    "lenet": lambda net: net.lenet(input_shape=(12, 12, 1)),
    "resnet_small": lambda net: net.resnet_small(input_shape=(16, 16, 4),
                                                 classes=4),
    "concat_net": _concat_net,
    "mobilenet_small": lambda net: net.mobilenet_small(),
    "unet_small": lambda net: net.unet_small(),
}


@pytest.mark.parametrize("qat", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_step_equals_reference(name, qat):
    jplan, tplan = PLANS[name](jnet), PLANS[name](tnet)
    rng = np.random.default_rng(3)
    classes = jplan.activation_shapes()[-1][-1]
    if name == "unet_small":
        x, y = jtr.synthetic_segmentation(rng, 8, classes=classes)
    else:
        x, y = jtr.synthetic_digits(rng, 8, input_shape=jplan.input_shape,
                                    classes=classes)
    state = jtr.init_train_state(jplan, rng)
    cfg = jtr.TrainConfig(qat=qat, per_channel=True)

    def loss_fn(params):
        logits = jtr.float_forward(jplan, params, x, qat=qat,
                                   per_channel=True)
        return jtr.softmax_cross_entropy(logits, y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    params, opt, metrics = adamw_update(state.params, grads, state.opt_state,
                                        state.step, cfg.adamw)

    tstate = train_state_to_torch(jax.tree.map(np.asarray, state),
                                  device="cpu")
    tx, ty = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    tcfg = ttr.TrainConfig(qat=qat, per_channel=True)
    tloss, _, tgrads = ttr.loss_and_grads(tplan, tcfg, tstate.params, tx, ty)
    new, tmetrics = ttr.make_train_step(tplan, tcfg)(tstate, tx, ty)

    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
    np.testing.assert_allclose(float(tmetrics["loss"]), float(loss), **TOL)
    np.testing.assert_allclose(float(tmetrics["grad_norm"]),
                               float(metrics["grad_norm"]), **TOL)
    assert int(new.step) == 1
    for want, got in ((grads, tgrads), (params, new.params),
                      (opt["m"], new.opt_state["m"]),
                      (opt["v"], new.opt_state["v"])):
        jl, tl = jax.tree.leaves(want), tree_leaves(got)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
