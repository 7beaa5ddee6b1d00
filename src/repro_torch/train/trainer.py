"""The training loop (counterpart of ``repro.train.trainer``):

* checkpoint/restart — periodic async checkpoints; on an (injected or
  real) step failure the trainer restores the latest checkpoint, rewinds
  the data cursor (the pipeline is seekable) and continues: the resumed
  loss trajectory is bit-identical to an uninterrupted run (tested);
* straggler monitor — a per-step wall-time EMA; steps slower than
  ``k × EMA`` fire the configured action (log, or checkpoint) and are
  counted.

Each step is timed on the host's monotonic clock around the train step
and the read of its metrics (which waits for the device), under the
``trainer.step`` span, into the ``trainer.step_us`` histogram of
``repro_torch.obs``.  ``to_device`` defaults to putting the numpy batch
on the device of the state's ``step``.  ``state_shardings`` (a tree of
``distributed.sharding.NamedSharding``s, for a sharded state) goes to
``Checkpointer.restore``, so a restart places the restored state on the
mesh again.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint.checkpoint import Checkpointer

PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    # straggler detection
    straggler_factor: float = 3.0
    straggler_warmup: int = 5
    straggler_action: str = "log"      # log | checkpoint
    # failure injection (testing fault tolerance)
    fail_at_steps: tuple = ()
    max_restarts: int = 10


class StragglerMonitor:
    def __init__(self, factor: float, warmup: int):
        self.factor = factor
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.events: List[Dict] = []
        self._n = 0

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (self._n > self.warmup
                        and dt > self.factor * self.ema)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        # EMA updated with clipped dt so one outlier doesn't poison the basis
        self.ema = 0.9 * self.ema + 0.1 * min(dt, 2 * self.ema)
        return is_straggler


class InjectedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 pipeline, init_state: PyTree,
                 state_shardings: Optional[PyTree] = None,
                 to_device: Optional[Callable] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.pipeline = pipeline
        self.state = init_state
        self.state_shardings = state_shardings
        self.to_device = to_device or self._to_state_device
        self.ckpt = Checkpointer(cfg.checkpoint_dir,
                                 keep=cfg.keep_checkpoints)
        self.monitor = StragglerMonitor(cfg.straggler_factor,
                                        cfg.straggler_warmup)
        self.history: List[Dict] = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def _to_state_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        dev = self.state["step"].device
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def _current_step(self) -> int:
        return int(self.state["step"])

    def _maybe_fail(self, step: int, already_failed: set):
        if step in self.cfg.fail_at_steps and step not in already_failed:
            already_failed.add(step)
            raise InjectedFailure(f"injected failure at step {step}")

    def _restore_latest(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            raise RuntimeError("failure before first checkpoint — "
                               "cannot recover")
        self.state, extra = self.ckpt.restore(
            self.state, step=latest, shardings=self.state_shardings)
        return latest

    # ------------------------------------------------------------------
    def run(self) -> List[Dict]:
        cfg = self.cfg
        failed: set = set()
        # step 0 checkpoint so any early failure is recoverable
        self.ckpt.save(self._current_step(), self.state, blocking=True)
        while self._current_step() < cfg.total_steps:
            step = self._current_step()
            try:
                self._maybe_fail(step, failed)
                batch = self.to_device(self.pipeline.batch_at(step))
                # perf_counter, not time.time(): the wall clock is not
                # monotonic
                with obs.span("trainer.step", step=step):
                    t0 = time.perf_counter()
                    self.state, metrics = self.train_step(self.state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                obs.metrics.histogram("trainer.step_us").observe(dt * 1e6)
                if self.monitor.observe(step, dt):
                    metrics["straggler"] = 1.0
                    if cfg.straggler_action == "checkpoint":
                        self.ckpt.save(self._current_step(), self.state,
                                       blocking=False)
                metrics.update({"step": step, "dt": dt})
                self.history.append(metrics)
                if cfg.log_every and step % cfg.log_every == 0:
                    print(f"step {step:6d} loss {metrics.get('loss', 0):.4f} "
                          f"({dt*1e3:.0f} ms)")
                nxt = self._current_step()
                if nxt % cfg.checkpoint_every == 0:
                    self.ckpt.save(nxt, self.state,
                                   blocking=not cfg.async_checkpoint)
            except InjectedFailure as e:
                self.restarts += 1
                if self.restarts > cfg.max_restarts:
                    raise
                self.ckpt.wait()
                restored = self._restore_latest()
                print(f"[trainer] {e}; restored step {restored}, resuming")
        self.ckpt.wait()
        self.ckpt.save(self._current_step(), self.state, blocking=True)
        return self.history
