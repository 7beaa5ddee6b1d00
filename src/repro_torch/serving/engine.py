"""Batched serving engines (counterpart of ``repro.serving.engine``).

LM path (``ServingEngine``): a fixed pool of slots runs lockstep decode
steps; requests are admitted into free slots between steps with a batch-1
prefill whose KV cache is scattered into the pool at the slot index, and a
slot frees as soon as its request ends (EOS, ``max_new_tokens`` or the end
of the cache).  The pool cache is updated in place.

Conv-net path (``ConvNetEngine``): a single-model facade over
``serving/batching.py``'s :class:`ContinuousBatchingEngine`.  Requests land
in an async priority queue; batches form when full, at the deadline or
when a synchronous caller drains; up to ``max_inflight`` batches are in
flight on the engine's CUDA stream; partial batches zero-pad onto the one
fixed [batch, H, W, C] program, batch-sharded over ``n_cores`` virtual IP
cores (``core/scheduler.py``).  ``submit`` keeps the synchronous contract
(logits in request order); ``submit_async`` returns the futures.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.core.network import QuantizedNetwork
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
    to the compute dtype once (``lm.compute_params``).

    Requests are token prompts, as in the reference: a VLM is served from
    tokens alone (no patch prefix).  An encoder-decoder is refused: the
    reference's engine prefills tokens only, and its encoder then fails
    on the missing frames, so there is no served path to hold it to."""

    def __init__(self, cfg: ArchConfig, params: PyTree, *, slots: int = 4,
                 max_seq: int = 256, device: DeviceLike = None):
        if cfg.kind == "encdec":
            raise NotImplementedError(
                f"{cfg.name}: ServingEngine prefills token prompts only, "
                f"and an encoder-decoder needs its source frames (the "
                f"reference's engine fails there too); run lm.prefill and "
                f"lm.decode_step with frames")
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
    """Image serving for one quantized network: the single-model facade
    of :class:`ContinuousBatchingEngine` (use that directly to serve
    several).

    ``device`` defaults to the GPU (raising when there is none); the
    qnet is copied there once.  ``core_config`` (default: the int8
    datapath on the hand-written kernels, each layer on the kernel its
    tile plan picks) sets the program's kernel choice and banks, and its
    backend unless ``backend`` names one.  ``tune`` (a
    ``NetworkTunePlan`` of this network) supplies the tuned tile plans and
    scheduler verdict; ``calib`` (a ``CalibrationTable``) prices the
    planner, the routes and the profile; ``drift_band`` bounds the drift
    check's measured/predicted ratio; ``route=True`` routes each formed
    batch through the scheduler mode the model predicts fastest for its
    size (see ``ContinuousBatchingEngine``)."""

    def __init__(self, qnet: QuantizedNetwork, *, batch: int = 8,
                 n_cores: int = 1, backend: Optional[str] = None,
                 tune=None, calib=None, drift_band=None,
                 deadline_ms: float = 5.0, bulk_aging_ms: float = 50.0,
                 max_inflight: int = 2, route: bool = False,
                 core_config: Optional[ConvCoreConfig] = None,
                 device: DeviceLike = None):
        from repro_torch.serving.batching import ContinuousBatchingEngine
        core_config = core_config or ConvCoreConfig(int8=True)
        self.batch = batch
        self.input_shape = qnet.plan.input_shape
        self.engine = ContinuousBatchingEngine(
            batch=batch, n_cores=n_cores,
            backend=backend or core_config.backend, deadline_ms=deadline_ms,
            bulk_aging_ms=bulk_aging_ms, cache_capacity=4,
            max_inflight=max_inflight, calib=calib, drift_band=drift_band,
            route=route, device=device, core_config=core_config)
        self.device = self.engine.device
        self.model = self.engine.add_model(qnet, tune=tune)
        self.qnet = self.engine._models[self.model].qnet

    @property
    def metrics(self):
        return self.engine.metrics

    @property
    def stats(self) -> Dict[str, int]:
        """Counters: requests served, batches run, zero-padded lanes."""
        return self.engine.stats

    @property
    def layer_profile(self):
        return self.engine.layer_profile

    @property
    def drift_events(self):
        return self.engine.drift_events

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p90/p99 (+count/mean) of per-request enqueue → result
        latency in µs (queue wait included)."""
        return self.engine.latency_percentiles()

    def _images(self, images) -> np.ndarray:
        """[R, H, W, C] (or one [H, W, C]) as float32, shape-checked."""
        x = np.asarray(images, dtype=np.float32)
        shape = x.shape[1:] if x.ndim == 4 else x.shape
        if x.ndim not in (3, 4) or tuple(shape) != tuple(self.input_shape):
            raise ValueError(f"expected images of shape [R, "
                             f"{', '.join(map(str, self.input_shape))}], "
                             f"got {tuple(x.shape)}")
        return x

    def submit(self, images, *, priority: str = "interactive") -> np.ndarray:
        """images: [R, H, W, C] array (or a list of [H, W, C]) → logits
        [R, classes] as float32 numpy, in request order."""
        return self.engine.submit(self._images(images), model=self.model,
                                  priority=priority)

    def submit_async(self, images, *, priority: str = "interactive"):
        """Async admission: one Future per image (see
        ``ContinuousBatchingEngine.submit_async``)."""
        return self.engine.submit_async(self._images(images),
                                        model=self.model, priority=priority)

    def close(self) -> None:
        self.engine.close()
