"""Batched serving engines (counterpart of ``repro.serving.engine``).

LM path (``ServingEngine``): a fixed pool of slots runs lockstep decode
steps; requests are admitted into free slots between steps with a batch-1
prefill whose KV cache is scattered into the pool at the slot index, and a
slot frees as soon as its request ends (EOS, ``max_new_tokens`` or the end
of the cache).  The pool cache is updated in place.

Conv-net path (``ConvNetEngine``): synchronous image serving over a
compiled int8 program.  ``submit(images)`` splits the R requests into
batches of ``batch``, zero-pads the last partial batch onto the program's
fixed [batch, H, W, C] shape, runs each batch on the engine's device and
returns the logits [R, classes] in request order; ``stats`` counts
requests, batches and padded lanes.  The reference's async queue, continuous
batching and program cache are not ported yet (ROADMAP A9/A10).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.core.network import QuantizedNetwork, make_int8_program
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers.common import torch_dtype, tree_map
from repro_torch.models import lm
from repro_torch.serving.serve_step import greedy_sample

PyTree = Any


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray             # [S_prompt] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """LM server over ``slots`` lockstep decode lanes of a ``max_seq``
    cache.  ``params`` is the model's tree (as ``lm.param_specs``); it is
    moved to ``device`` (default: the GPU) and its matmul weights are cast
    to the compute dtype once (``lm.compute_params``)."""

    def __init__(self, cfg: ArchConfig, params: PyTree, *, slots: int = 4,
                 max_seq: int = 256, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = lm.compute_params(tree_map(
            lambda t: t.to(self.device), params), cfg)
        self.slots = slots
        self.max_seq = max_seq
        self.cache = tree_map(
            lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                  device=self.device),
            lm.cache_specs(cfg, slots, max_seq))
        self.pos = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.last_token = np.zeros((slots,), np.int32)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    @torch.no_grad()
    def admit(self, req: Request) -> bool:
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                 device=self.device)[None]
        logits, cache1 = lm.prefill(self.params, {"tokens": prompt},
                                    self.cfg, cache_len=self.max_seq)
        tree_map(lambda pool, one: _scatter_slot(pool, one, slot),
                 self.cache, cache1)
        tok = int(greedy_sample(logits)[0])
        req.output.append(tok)
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_token[slot] = tok
        return True

    @torch.no_grad()
    def step(self) -> List[Request]:
        """One lockstep decode step over the whole pool.  Returns the
        requests that finished on this step (their slots are freed)."""
        finished: List[Request] = []
        if all(r is None for r in self.active):
            return finished
        tokens = torch.as_tensor(self.last_token, dtype=torch.long,
                                 device=self.device)
        pos = torch.as_tensor(self.pos, dtype=torch.long, device=self.device)
        logits, self.cache = lm.decode_step(self.params, self.cfg,
                                            token=tokens, pos=pos,
                                            cache=self.cache)
        nxt = greedy_sample(logits).cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[i] += 1
            tok = int(nxt[i])
            req.output.append(tok)
            self.last_token[i] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.output) >= req.max_new_tokens \
                    or self.pos[i] >= self.max_seq - 1:
                req.done = True
                self.active[i] = None
                finished.append(req)
        return finished

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests`` to the end; returns them in finishing order."""
        pending = deque(requests)
        done: List[Request] = []
        while pending or any(r is not None for r in self.active):
            while pending and self._free_slots():
                if not self.admit(pending[0]):
                    break
                pending.popleft()
            done.extend(self.step())
        return done


def _scatter_slot(pool: torch.Tensor, one: torch.Tensor, slot: int):
    """Write a batch-1 cache leaf into the pool cache at ``slot``, in
    place.

    The batch axis is the first axis where the request leaf has size 1 and
    the pool leaf doesn't (cache leaves are [B,...] or stacked [G,B,...]).
    Sequence axes may be shorter on the request side; fresh prompts align
    at offset 0 with the pool's ring indexing."""
    batch_axis = None
    for i in range(pool.dim()):
        if one.shape[i] == 1 and pool.shape[i] != 1:
            batch_axis = i
            break
    if batch_axis is None:
        return pool                      # replicated / batch-free leaf
    dst = tuple(slice(slot, slot + 1) if ax == batch_axis
                else slice(0, min(pool.shape[ax], one.shape[ax]))
                for ax in range(pool.dim()))
    src = tuple(slice(0, 1) if ax == batch_axis
                else slice(0, min(pool.shape[ax], one.shape[ax]))
                for ax in range(pool.dim()))
    pool[dst] = one[src].to(pool.dtype)
    return pool


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
