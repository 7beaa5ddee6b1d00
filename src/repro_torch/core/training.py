"""Training: the float shadow of a ``NetworkPlan``, trained through the
weight-stationary kernels, with quantization-aware training that drops
into the int8 deployment (counterpart of ``repro.core.training``).

The int8 weights the paper's IP core runs come from here: a float shadow
of the deployed network is trained with straight-through fake
quantization of its weights and activations, then lowered by
``quantize_network`` → ``make_int8_program``.

* ``float_forward`` runs any plan's DAG (skip adds, concats, transposed
  convs, grouped convs) with its convs and dense GEMMs on ``ops.conv2d`` /
  ``ops.conv2d_transpose`` / ``ops.matmul_ws``, whose autograd Functions
  run the backward on the same kernels (``conv2d_ws`` for the input
  gradients, ``matmul_ws`` for the weight-gradient taps and the head);
* QAT places a straight-through fake quantizer at every int8 grid point of
  the deployed program: the network input, every non-final parametric
  output after its fused epilogue, every merge node;
* ``make_train_step`` is forward → autograd → ``adamw_update``; ``fit``
  the minibatch loop over it, with the reference's numpy sampling, spans
  and metrics.

PyTorch runs eagerly: the step is a plain function (no compile step), on
the caller's thread and current stream.  ``init_train_state``, ``fit`` and
the synthetic data run on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import banking
from repro_torch.core.network import PARAM_KINDS, NetworkPlan
from repro_torch.core.quantize import fake_quant_act, fake_quant_weight
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, tree_leaves,
                                     tree_map)


@dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of one training run.  ``qat`` turns on the
    straight-through fake quantization; ``per_channel`` must match the
    ``quantize_network(per_channel=...)`` that lowers the trained weights,
    so training and deployment see the same weight grids."""
    adamw: AdamWConfig = field(default_factory=lambda: AdamWConfig(
        peak_lr=3e-3, warmup_steps=20, total_steps=400, weight_decay=1e-4,
        grad_clip_norm=1.0))
    qat: bool = False
    per_channel: bool = False


class TrainState(NamedTuple):
    params: List[Optional[dict]]       # plan.init_params layout
    opt_state: Dict[str, List]         # AdamW m / v mirroring params
    step: torch.Tensor                 # int32 scalar on the params' device


def init_train_state(plan: NetworkPlan, rng: np.random.Generator,
                     device: DeviceLike = None) -> TrainState:
    """He-initialized float parameters (the reference's draws from
    ``rng``) and zeroed AdamW moments, on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    params = plan.init_params(rng, device=dev)
    zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
    return TrainState(params=params, opt_state={"m": zeros(), "v": zeros()},
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _relu(h: torch.Tensor) -> torch.Tensor:
    """ReLU whose gradient at exactly 0 is ½, as ``jnp.maximum(h, 0)``'s
    is (``torch.relu`` gives 0 there).  QAT makes exact zeros common: a
    merge adds two grid values, often both 0."""
    return torch.maximum(h, h.new_zeros(()))


def float_forward(plan: NetworkPlan, params: Sequence[Optional[dict]],
                  x: torch.Tensor, *, qat: bool = False,
                  per_channel: bool = False) -> torch.Tensor:
    """Differentiable forward of the plan's float shadow on the kernels.

    Node semantics are ``NetworkPlan.forward_activations``'; convs and
    dense GEMMs run ``ops.conv2d`` / ``ops.conv2d_transpose`` /
    ``ops.matmul_ws`` with the banks ``banking.grouped_banks`` gives and
    whole-map tiles.  In QAT mode the input, each non-final parametric
    output (after its fused ReLU / pool, where the deployed requantize
    sits) and each merge node pass a straight-through fake quantizer; the
    final parametric layer's output stays float, like the deployed
    program's dequantized logits."""
    ins = plan.resolved_inputs()
    geoms = plan.conv_geometries()
    last_param = max((i for i, sp in enumerate(plan.layers)
                      if sp.kind in PARAM_KINDS), default=-1)
    x0 = fake_quant_act(x) if qat else x
    acts: List[torch.Tensor] = []
    for i, sp in enumerate(plan.layers):
        p = params[i]
        src = [x0 if j < 0 else acts[j] for j in ins[i]]
        h = src[0]
        if sp.kind in ("conv", "conv_transpose"):
            k_, g_ = geoms[i]
            w = fake_quant_weight(p["w"], per_channel) if qat else p["w"]
            cb_n, kb_n = banking.grouped_banks(h.shape[-1], k_, g_)
            op = (ops.conv2d_transpose if sp.kind == "conv_transpose"
                  else ops.conv2d)
            h = op(h, w, p["b"], stride=sp.stride, padding=sp.padding,
                   groups=g_, dilation=sp.dilation, cin_banks=cb_n,
                   kout_banks=kb_n, relu=sp.relu, pool=sp.pool)
            if qat and i != last_param:
                h = fake_quant_act(h)
        elif sp.kind == "pool":
            h = ref.maxpool_first_ref(h, sp.size)
        elif sp.kind == "avgpool":
            h = ref.avgpool2d_ref(h, sp.size)
        elif sp.kind == "globalpool":
            h = ref.global_avgpool_ref(h)
        elif sp.kind == "flatten":
            h = h.reshape(h.shape[0], -1)
        elif sp.kind == "dense":
            w = fake_quant_weight(p["w"], per_channel) if qat else p["w"]
            h = ops.matmul_ws(h, w, p["b"])
            if sp.relu:
                h = _relu(h)
            if qat and i != last_param:
                h = fake_quant_act(h)
        elif sp.kind == "add":
            h = src[0] + src[1]
            if sp.relu:
                h = _relu(h)
            if qat:                       # the merge node's shared grid
                h = fake_quant_act(h)
        elif sp.kind == "concat":
            h = torch.cat(src, dim=-1)
            if qat:
                h = fake_quant_act(h)
        else:
            raise ValueError(f"unknown layer kind {sp.kind!r}")
        acts.append(h)
    return acts[-1]


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer labels over the last (class) axis, in
    f32; [N, classes] with [N] labels, or per-pixel [N, H, W, classes] with
    [N, H, W] label maps (every pixel one term of the mean)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.take_along_dim(
        logp, labels[..., None].to(torch.int64), dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of correct argmax predictions over the last axis."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


def loss_and_grads(plan: NetworkPlan, cfg: TrainConfig, params, x, y):
    """The float shadow's loss and accuracy on (x, y) and the gradient of
    the loss for every parameter (autograd through the kernels'
    Functions) → (loss, accuracy, grads in the params' structure)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        logits = float_forward(plan, leaves, x, qat=cfg.qat,
                               per_channel=cfg.per_channel)
        loss = softmax_cross_entropy(logits, y)
        flat = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(flat)
    grads = tree_map(lambda _: next(it), leaves)
    with torch.no_grad():
        return loss.detach(), accuracy(logits, y), grads


def make_train_step(plan: NetworkPlan, cfg: TrainConfig = TrainConfig()):
    """One training step: the float-shadow forward (QAT-aware), autograd
    through the kernels' Functions, then ``adamw_update``.

    Returns ``step(state, x, y) -> (state, metrics)`` with metrics {loss,
    accuracy, lr, grad_norm} as 0-d tensors on the state's device."""

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        loss, acc, grads = loss_and_grads(plan, cfg, state.params, x, y)
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(
                state.params, grads, state.opt_state, state.step, cfg.adamw)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        return new_state, {"loss": loss, "accuracy": acc, **metrics}

    return step


def make_eval_step(plan: NetworkPlan, cfg: TrainConfig = TrainConfig()):
    """(loss, accuracy) of the float shadow, QAT-aware (eval sees the
    fake-quantized forward training optimizes), without autograd."""

    def evaluate(params, x, y):
        with torch.no_grad():
            logits = float_forward(plan, params, x, qat=cfg.qat,
                                   per_channel=cfg.per_channel)
            return softmax_cross_entropy(logits, y), accuracy(logits, y)

    return evaluate


def fit(plan: NetworkPlan, x, y, *, steps: int, batch: int = 32,
        cfg: TrainConfig = TrainConfig(), seed: int = 0,
        state: Optional[TrainState] = None, device: DeviceLike = None
        ) -> Tuple[TrainState, List[dict]]:
    """Minibatch training (uniform sampling with replacement, the
    reference's numpy draws from ``seed``) → (final state, per-step
    metrics as floats).  Runs where ``state`` lives, or on ``device``
    (default: the card) for a fresh state."""
    rng = np.random.default_rng(seed)
    if state is None:
        state = init_train_state(plan, rng, device=device)
    dev = state.step.device
    step_fn = make_train_step(plan, cfg)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    history: List[dict] = []
    n = x.shape[0]
    # per-step wall time into the shared histogram type, images/s as a
    # gauge (always on); spans only when obs is enabled
    step_us = obs.metrics.histogram(f"train.step_us.{plan.name}")
    ips = obs.metrics.gauge(f"train.images_per_s.{plan.name}")
    with obs.span("train.fit", network=plan.name, steps=steps, batch=batch,
                  qat=cfg.qat):
        for i in range(steps):
            idx = torch.from_numpy(rng.integers(0, n, size=batch)).to(dev)
            with obs.span("train.step", step=i):
                t0 = time.perf_counter()
                state, metrics = step_fn(state, x[idx], y[idx])
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
            step_us.observe(dt * 1e6)
            if dt > 0:
                ips.set(batch / dt)
            history.append(metrics)
    return state, history


def _arrays(x: np.ndarray, y: np.ndarray, device: DeviceLike
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(y.astype(np.int32)).to(dev))


def synthetic_digits(rng: np.random.Generator, n: int,
                     input_shape: Tuple[int, int, int] = (12, 12, 1),
                     classes: int = 10, noise: float = 0.35,
                     template_seed: int = 0, device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's synthetic "digits" set, array for array: one
    low-frequency template per class (a coarse pattern drawn from
    ``template_seed``, upsampled 3×) plus per-sample noise from ``rng``
    → (x [n, H, W, C] f32, y [n] int32) on ``device``.  Only the drawn
    classes' templates are upsampled, which changes no value."""
    h, w, c = input_shape
    trng = np.random.default_rng(template_seed)
    base = trng.normal(size=(classes, max(1, -(-h // 3)),
                             max(1, -(-w // 3)), c))
    y = rng.integers(0, classes, size=n)
    up = np.repeat(np.repeat(base[y], 3, axis=1), 3, axis=2)[:, :h, :w]
    x = up + noise * rng.normal(size=(n, h, w, c))
    return _arrays(x, y, device)


def synthetic_segmentation(rng: np.random.Generator, n: int,
                           input_shape: Tuple[int, int, int] = (16, 16, 4),
                           classes: int = 3, noise: float = 0.3,
                           template_seed: int = 0, device: DeviceLike = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's synthetic dense-prediction set, array for array:
    per-pixel class maps (coarse blobs from ``rng`` upsampled 4×) rendered
    through one channel signature per class (from ``template_seed``) plus
    noise → (x [n, H, W, C] f32, y [n, H, W] int32) on ``device``."""
    h, w, c = input_shape
    trng = np.random.default_rng(template_seed)
    sig = trng.normal(size=(classes, c))
    coarse = rng.integers(0, classes,
                          size=(n, max(1, -(-h // 4)), max(1, -(-w // 4))))
    y = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    x = sig[y] + noise * rng.normal(size=(n, h, w, c))
    return _arrays(x, y, device)
