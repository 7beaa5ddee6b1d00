"""Deterministic, seekable data pipeline (counterpart of
``repro.data.pipeline``, numpy only: its batches are array-equal to the
reference's).

Fault-tolerance contract: the pipeline state is a single integer cursor
(the global step); ``batch_at(step)`` is a pure function, so restoring a
checkpoint and replaying from its step yields bit-identical batches —
tested in tests/test_torch_trainer.py.

Sources:
* SyntheticLM  — counting-friendly synthetic token streams with a learnable
  structure (a fixed Markov-ish mixing so training loss actually drops);
* TextFile     — byte-level tokenization of a local file, packed into
  fixed-length sequences.

Per-host sharding: each process materializes only its slice
(process_index/process_count), so the pipeline scales to multi-host pods.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"        # synthetic | textfile
    path: Optional[str] = None     # for textfile


class SyntheticLM:
    """Deterministic synthetic LM data with learnable structure: token t+1
    depends on token t through a fixed permutation + noise, so models fit it
    quickly (loss decreases) yet batches are a pure function of step."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        assert cfg.global_batch % process_count == 0
        self.local_batch = cfg.global_batch // process_count
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        ss = np.random.SeedSequence(
            entropy=c.seed,
            spawn_key=(step, self.process_index))
        rng = np.random.default_rng(ss)
        first = rng.integers(0, c.vocab_size, size=(self.local_batch, 1))
        noise = rng.random((self.local_batch, c.seq_len)) < 0.1
        toks = np.empty((self.local_batch, c.seq_len + 1), np.int64)
        toks[:, :1] = first
        for t in range(1, c.seq_len + 1):
            nxt = self.perm[toks[:, t - 1]]
            rnd = rng.integers(0, c.vocab_size, size=self.local_batch)
            toks[:, t] = np.where(noise[:, t - 1], rnd, nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class TextFile:
    """Byte-level LM over a local file, deterministic packing by step."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        assert cfg.path is not None
        self.cfg = cfg
        with open(cfg.path, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        if len(data) < cfg.seq_len + 1:
            reps = (cfg.seq_len + 1) // max(len(data), 1) + 1
            data = np.tile(data, reps)
        self.data = data.astype(np.int32) % cfg.vocab_size
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        n = len(self.data) - c.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=c.seed,
                                   spawn_key=(step, self.process_index)))
        starts = rng.integers(0, n, size=self.local_batch)
        toks = np.stack([self.data[s:s + c.seq_len + 1] for s in starts])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_pipeline(cfg: DataConfig, process_index: int = 0,
                  process_count: int = 1):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg, process_index, process_count)
    if cfg.kind == "textfile":
        return TextFile(cfg, process_index, process_count)
    raise ValueError(cfg.kind)


def fingerprint(batch: Dict[str, np.ndarray]) -> str:
    """Stable digest of a batch (used by resume-equality tests)."""
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()[:16]
