"""Synchronous image serving over a compiled int8 program (counterpart of
the ``submit`` contract of ``repro.serving.engine.ConvNetEngine``).

``submit(images)`` splits the R requests into batches of ``batch``,
zero-pads the last partial batch onto the program's fixed
[batch, H, W, C] shape, runs each batch on the engine's device and returns
the logits [R, classes] in request order; ``stats`` counts requests,
batches and padded lanes.  The reference's async queue, continuous
batching and program cache are not ported yet (ROADMAP A9/A10).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.core.network import QuantizedNetwork, make_int8_program
from repro_torch.device import DeviceLike, resolve_device


class ConvNetEngine:
    """Image classification server for one quantized network.

    ``device`` defaults to the GPU (raising when there is none); the qnet
    is copied there once, and the program runs under ``core_config``
    (default: the int8 datapath on the hand-written kernels, each layer
    on the kernel its tile plan picks)."""

    def __init__(self, qnet: QuantizedNetwork, *, batch: int = 8,
                 core_config: Optional[ConvCoreConfig] = None,
                 device: DeviceLike = None):
        if batch < 1:
            raise ValueError(f"batch must be ≥ 1, got {batch}")
        self.device = resolve_device(device)
        self.qnet = qnet.to(self.device)
        self.batch = batch
        self.input_shape = qnet.plan.input_shape
        self.program = make_int8_program(
            self.qnet, core_config or ConvCoreConfig(int8=True))
        self._stats = {"requests": 0, "batches": 0, "padded": 0}

    @property
    def stats(self) -> Dict[str, int]:
        """Counters: requests served, batches run, zero-padded lanes."""
        return dict(self._stats)

    def submit(self, images) -> np.ndarray:
        """images: [R, H, W, C] array (or a list of [H, W, C]) → logits
        [R, classes] as float32 numpy, in request order."""
        x = torch.as_tensor(np.asarray(images, dtype=np.float32))
        if x.dim() != 4 or tuple(x.shape[1:]) != tuple(self.input_shape):
            raise ValueError(f"expected images of shape [R, "
                             f"{', '.join(map(str, self.input_shape))}], "
                             f"got {tuple(x.shape)}")
        outs = []
        for start in range(0, x.shape[0], self.batch):
            chunk = x[start:start + self.batch]
            pad = self.batch - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (pad, *chunk.shape[1:]))])
            logits = self.program(chunk.to(self.device))
            outs.append(logits[:self.batch - pad])
            self._stats["batches"] += 1
            self._stats["padded"] += pad
        self._stats["requests"] += x.shape[0]
        if not outs:
            return np.zeros((0, 0), np.float32)
        return torch.cat(outs).cpu().numpy()
