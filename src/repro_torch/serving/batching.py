"""Continuous batching for conv-net serving: async request queue,
deadline-driven batch formation, multi-model LRU program cache
(counterpart of ``repro.serving.batching``).

The paper's full-board mode (§5.2: ~20 replicated IP cores, 4.48 GOPS) is
a serving configuration: the fabric earns its throughput only if the host
keeps its lanes full.  Three pieces:

* :class:`RequestQueue` — thread-safe admission into two priority lanes
  (``interactive`` / ``bulk``).  A batch launches when some model has a
  full batch (``full``), when the oldest queued request reaches its
  deadline (``deadline``), or when a synchronous caller is waiting
  (``drain``).  Bulk requests older than ``bulk_aging_ms`` merge into the
  interactive ordering by enqueue time, so they cannot starve.
  Formation is a pure function of (queue contents, clock); the clock is
  injectable.
* :class:`ProgramCache` — a bounded LRU of built ``(model, backend)``
  programs with hit / miss / eviction counters and a ``cache.size``
  gauge.
* :class:`ContinuousBatchingEngine` — the serving loop.  ``submit_async``
  returns a :class:`concurrent.futures.Future` per request; one worker
  thread forms batches, pads them onto the fixed ``[batch,H,W,C]``
  program shape and dispatches them through ``MultiCoreScheduler``.  A
  model added with ``tune=`` (a ``core.autotune.NetworkTunePlan``) runs
  the tuned tile plans under the tuned scheduler verdict; with
  ``route=True`` each formed batch is routed through the scheduler mode
  the calibrated model predicts fastest for its size
  (``autotune.route_batch``): a deadline-launched single image takes the
  kout / spatial modes, a full batch batch sharding.

Where the reference keeps up to ``max_inflight`` batches unmaterialized
through JAX's async dispatch, the port runs every batch on one CUDA
stream of its own: the padded batch is staged in a pinned host buffer
and uploaded with ``non_blocking=True``, the logits come back
``non_blocking`` into a pinned output buffer, and a ``torch.cuda.Event``
recorded after them marks the batch done.  Retiring a batch waits on its
event (where the reference calls ``np.asarray``), copies the logits out
and only then frees the staging slot for reuse.  ``_dispatch`` sets the
stream and device itself, so it launches nothing on another thread's
stream.  On the CPU (``device="cpu"``) a batch runs to its end in
``_dispatch``.

Telemetry (the engine's own ``MetricsRegistry``): ``queue.depth`` /
``queue.depth.peak`` gauges; ``queue_wait_us``, ``batch_device_us``
(dispatch → retired, an upper bound on the batch's device time when
batches queue behind ``max_inflight``) and enqueue → result
``request_latency_us`` histograms; ``batch_formed.{full,deadline,drain}``
and ``cache.{hits,misses,evictions}`` counters; ``batch_fill``; and
``route.<mode>`` counters when routing is live.  With obs enabled the
first batch is profiled layer by layer; under ``calib=`` its prediction
is the calibrated model's and a drift check (band ``drift_band``) flags
the layers the table no longer describes (``drift_events``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device

PRIORITIES = ("interactive", "bulk")
FORMATION_REASONS = ("full", "deadline", "drain")

# a synchronous caller waiting on its own requests fails loudly, not
# forever, if the worker dies
SUBMIT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class ServeRequest:
    """One admitted single-image request (engine-internal)."""
    uid: int
    model: str
    image: np.ndarray                    # [H, W, C] float32
    priority: str
    enqueue_ns: int
    deadline_ns: int
    future: Future


@dataclasses.dataclass
class FormedBatch:
    """A launched batch: which model, which requests, and why it left the
    queue (``full`` / ``deadline`` / ``drain``)."""
    model: str
    requests: List[ServeRequest]
    reason: str


class RequestQueue:
    """Two-lane priority queue with deadline-driven batch formation.

    ``push_many`` is thread-safe and atomic: a caller's requests become
    visible to the batch former all at once.  ``form`` decides, for one
    clock reading, whether a batch launches and why:

    * ``full`` — some model has at least ``batch`` queued requests; the
      winner owns the oldest request in formation order (interactive and
      aged bulk by enqueue time, then fresh bulk);
    * ``deadline`` — the oldest queued request (either lane) is past its
      deadline; its model launches with whatever it has;
    * ``drain`` — a synchronous caller is waiting; a partial batch
      launches rather than idling until the deadline."""

    def __init__(self, registry: obs.MetricsRegistry, *,
                 deadline_ms: float = 5.0, bulk_aging_ms: float = 50.0,
                 clock: Callable[[], int] = time.perf_counter_ns):
        if deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        self.cond = threading.Condition()
        self.deadline_ns = int(deadline_ms * 1e6)
        self.aging_ns = int(bulk_aging_ms * 1e6)
        self.clock = clock
        self._lanes: Dict[str, deque] = {p: deque() for p in PRIORITIES}
        self._depth = registry.gauge("queue.depth")
        self._peak = registry.gauge("queue.depth.peak")
        self._depth.set(0)
        self._peak.set(0)

    # -- admission -----------------------------------------------------------

    def push_many(self, reqs: Sequence[ServeRequest]) -> None:
        with self.cond:
            for r in reqs:
                if r.priority not in self._lanes:
                    raise ValueError(f"unknown priority {r.priority!r}; "
                                     f"have {PRIORITIES}")
            for r in reqs:
                self._lanes[r.priority].append(r)
            d = self._len_locked()
            self._depth.set(d)
            if d > (self._peak.value or 0):
                self._peak.set(d)
            self.cond.notify_all()

    def _len_locked(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def __len__(self) -> int:
        with self.cond:
            return self._len_locked()

    # -- formation -----------------------------------------------------------

    def next_deadline_ns(self) -> Optional[int]:
        """Earliest queued deadline (caller holds ``cond``)."""
        heads = [q[0].deadline_ns for q in self._lanes.values() if q]
        return min(heads) if heads else None

    def form(self, batch: int, *, drain: bool = False,
             now_ns: Optional[int] = None) -> Optional[FormedBatch]:
        with self.cond:
            return self.form_locked(batch, drain=drain, now_ns=now_ns)

    def form_locked(self, batch: int, *, drain: bool = False,
                    now_ns: Optional[int] = None) -> Optional[FormedBatch]:
        """The formation decision for one clock reading (hold ``cond``)."""
        now = self.clock() if now_ns is None else now_ns
        inter, bulk = self._lanes["interactive"], self._lanes["bulk"]
        if not inter and not bulk:
            return None
        promoted = [r for r in bulk if now - r.enqueue_ns >= self.aging_ns]
        fresh = [r for r in bulk if now - r.enqueue_ns < self.aging_ns]
        # interactive + aged bulk by original enqueue time, then fresh bulk
        urgent = sorted([*inter, *promoted], key=lambda r: r.enqueue_ns)
        ordered = urgent + fresh
        counts: Dict[str, int] = {}
        for r in ordered:
            counts[r.model] = counts.get(r.model, 0) + 1
        model = reason = None
        for r in ordered:                    # oldest full model wins
            if counts[r.model] >= batch:
                model, reason = r.model, "full"
                break
        if reason is None:
            oldest = min((q[0] for q in self._lanes.values() if q),
                         key=lambda r: r.enqueue_ns)
            if now >= oldest.deadline_ns:
                model, reason = oldest.model, "deadline"
            elif drain:
                model, reason = ordered[0].model, "drain"
            else:
                return None
        take = [r for r in ordered if r.model == model][:batch]
        taken = set(id(r) for r in take)
        for lane in self._lanes.values():
            kept = [r for r in lane if id(r) not in taken]
            lane.clear()
            lane.extend(kept)
        self._depth.set(self._len_locked())
        return FormedBatch(model=model, requests=take, reason=reason)


class ProgramCache:
    """Bounded LRU of built programs keyed by ``(model, backend)``.

    ``get`` is get-or-build: a hit refreshes recency, a miss runs
    ``build()`` and evicts the least recently used entries past
    ``capacity``."""

    def __init__(self, capacity: int, registry: obs.MetricsRegistry):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._hits = registry.counter("cache.hits")
        self._misses = registry.counter("cache.misses")
        self._evictions = registry.counter("cache.evictions")
        self._size = registry.gauge("cache.size")
        self._size.set(0)

    def get(self, key, build: Callable[[], Any]):
        with self._lock:
            if key in self._entries:
                self._hits.inc()
                self._entries.move_to_end(key)
                return self._entries[key]
            self._misses.inc()
            value = build()
            self._entries[key] = value
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions.inc()
            self._size.set(len(self._entries))
            return value

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[Any]:
        with self._lock:
            return list(self._entries)


@dataclasses.dataclass
class _Model:
    """One registered network: quantized weights (on the engine's
    device), admission shape, output shape, tune plan, the static backend
    and scheduler, and (when routing) the per-formed-size route table."""
    name: str
    qnet: Any
    input_shape: Tuple[int, int, int]
    out_shape: Tuple[int, ...]
    tune: Any
    backend_name: str
    sched: Any
    routes: Dict[int, Tuple[str, Any, str]] = \
        dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Slot:
    """Pinned host staging for one in-flight batch of one model: the
    padded input, the logits, and the event that marks both copies
    done (None on the CPU)."""
    key: tuple
    inp: torch.Tensor
    out: torch.Tensor
    event: Optional[torch.cuda.Event]


@dataclasses.dataclass
class _InFlight:
    slot: _Slot
    batch: FormedBatch
    t0: int
    # the batch's device input and logits, referenced until it retires so
    # that their memory outlives the copies queued behind them whatever
    # stream later allocations come from
    keep: tuple


class ContinuousBatchingEngine:
    """Multi-model continuous-batching engine over int8 ``NetworkPlan``
    programs, on the GPU unless ``device`` says otherwise.

    ``add_model`` registers a quantized network (admission keyed by its
    input shape), copies it to the engine's device and builds its program
    into the LRU cache.  ``submit_async`` enqueues single-image requests
    and returns futures; ``submit`` enqueues, drains and stacks.  One
    worker thread forms batches, dispatches them through the scheduler and
    keeps up to ``max_inflight`` of them in flight on its stream while the
    next one forms.

    ``backend`` names a registered backend: ``"cuda"`` (the kernels),
    ``"ref"`` (the plain versions), or a sharded backend registered from
    ``MultiCoreScheduler.shard_backend`` (kout / spatial modes); with
    ``n_cores > 1`` the formed batches are batch-sharded.  ``core_config``
    (the port's) is the ``ConvCoreConfig`` the programs build under
    (kernel choice, banks, shared-memory budget); its backend is replaced
    by ``backend``, and its ``calib`` by the engine's where one is given.

    ``calib`` (a ``core.calibration.CalibrationTable``) prices the
    planner's kernel choice, the routes and the profile; ``drift_band``
    is the drift check's band.  ``route=True`` with a model's ``tune``
    plan routes each formed batch through the mode
    ``autotune.route_batch`` predicts fastest for its size on
    ``n_cores`` cores (the tune plan's cores where ``n_cores`` is 1); the
    routed kout / spatial programs build on first use of each formed
    size and are cache entries of their own."""

    def __init__(self, *, batch: int = 8, n_cores: int = 1,
                 backend: str = "cuda", deadline_ms: float = 5.0,
                 bulk_aging_ms: float = 50.0, cache_capacity: int = 4,
                 max_inflight: int = 2, calib=None, drift_band=None,
                 route: bool = False,
                 clock: Callable[[], int] = time.perf_counter_ns,
                 device: DeviceLike = None, core_config=None):
        from repro_torch.core.convcore import ConvCoreConfig
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        self.device = resolve_device(device)
        self.batch = batch
        self.n_cores = n_cores
        self.backend = backend
        self.calib = calib
        self.route = route
        self.clock = clock
        self.core_config = core_config or ConvCoreConfig(int8=True)
        if calib is not None:
            self.core_config = dataclasses.replace(self.core_config,
                                                   calib=calib)
        self.metrics = obs.MetricsRegistry()
        self.queue = RequestQueue(self.metrics, deadline_ms=deadline_ms,
                                  bulk_aging_ms=bulk_aging_ms, clock=clock)
        self.cache = ProgramCache(cache_capacity, self.metrics)
        self._requests = self.metrics.counter("requests")
        self._batches = self.metrics.counter("batches")
        self._padded = self.metrics.counter("padded")
        self._formed = {r: self.metrics.counter(f"batch_formed.{r}")
                        for r in FORMATION_REASONS}
        self._latency = self.metrics.histogram("request_latency_us")
        self._queue_wait = self.metrics.histogram("queue_wait_us")
        self._device_us = self.metrics.histogram("batch_device_us")
        self._fill = self.metrics.histogram(
            "batch_fill", bounds=[i / 16 for i in range(1, 17)])
        self._models: Dict[str, _Model] = {}
        self._inflight: deque = deque()
        self._free_slots: Dict[tuple, List[_Slot]] = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._uid_lock = threading.Lock()
        self._uid = 0
        self._drain_waiters = 0
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._stopping = False
        self.max_inflight = max_inflight
        self.layer_profile = None          # first obs'd batch, any model
        self.drift_events: tuple = ()
        self._drift_band = drift_band

    # -- model registry ------------------------------------------------------

    def add_model(self, qnet, *, name: Optional[str] = None,
                  tune=None) -> str:
        """Register a quantized network, copy it to the engine's device and
        build its program (a cache miss, an ``engine.compile`` span).
        ``tune`` (a ``NetworkTunePlan`` of the same network) supplies the
        program's tile plans and the scheduler verdict.  Returns the model
        name used for admission."""
        from repro_torch.core.scheduler import (MultiCoreScheduler,
                                                SchedulerConfig)
        name = name or qnet.plan.name
        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        if tune is not None and tune.network != qnet.plan.name:
            raise ValueError(
                f"tune plan is for network {tune.network!r}, "
                f"engine serves {qnet.plan.name!r}")
        if tune is not None:
            sched = MultiCoreScheduler.from_tune(tune)
            backend_name = self._shard_backend_name(sched)
        else:
            sched = MultiCoreScheduler(SchedulerConfig(n_cores=self.n_cores))
            backend_name = self.backend
        entry = _Model(
            name=name, qnet=qnet.to(self.device),
            input_shape=tuple(qnet.plan.input_shape),
            out_shape=tuple(qnet.plan.activation_shapes()[-1]),
            tune=tune, backend_name=backend_name, sched=sched)
        self._models[name] = entry
        self._compiled(entry, entry.backend_name)
        return name

    def _shard_backend_name(self, sched) -> str:
        """kout / spatial verdicts put the cores inside the program as a
        registered sharded backend; batch verdicts shard around it."""
        from repro_torch.core.convcore import register_backend
        if sched.config.mode in ("kout", "spatial"):
            sb = sched.shard_backend(self.backend)
            register_backend(sb)
            return sb.name
        return self.backend

    def models(self) -> List[str]:
        return sorted(self._models)

    def _resolve(self, model: Optional[str],
                 shape: Tuple[int, ...]) -> _Model:
        """Admission: by name (shape-checked) or, with ``model=None``, by
        a unique input-shape match across the registered models."""
        if not self._models:
            raise ValueError("no models registered (add_model first)")
        if model is not None:
            entry = self._models.get(model)
            if entry is None:
                raise ValueError(f"unknown model {model!r}; "
                                 f"have {self.models()}")
            if tuple(shape) != entry.input_shape:
                raise ValueError(
                    f"model {model!r} wants input shape "
                    f"{entry.input_shape}, got {tuple(shape)}")
            return entry
        matches = [e for e in self._models.values()
                   if e.input_shape == tuple(shape)]
        if len(matches) != 1:
            raise ValueError(
                f"input shape {tuple(shape)} matches "
                f"{[e.name for e in matches] or 'no'} models — pass "
                f"model= (have {self.models()})")
        return matches[0]

    # -- program building ----------------------------------------------------

    def _compiled(self, entry: _Model, backend_name: str):
        """(program, tile_plans, core_config) of one (model, backend)
        point, through the LRU cache."""
        from repro_torch.core.network import (make_int8_program,
                                              program_tile_plans)

        def build():
            cfg = dataclasses.replace(self.core_config, backend=backend_name,
                                      int8=True)
            with obs.span("engine.compile", network=entry.qnet.plan.name,
                          model=entry.name, backend=backend_name,
                          batch=self.batch):
                if entry.tune is not None:
                    tile_plans = entry.tune.tile_plans
                else:
                    tile_plans = program_tile_plans(entry.qnet.plan, cfg)
                program = make_int8_program(entry.qnet, cfg,
                                            tile_plans=tile_plans)
            return program, tile_plans, cfg

        return self.cache.get((entry.name, backend_name), build)

    # -- admission / submission ----------------------------------------------

    def _next_uids(self, n: int) -> range:
        with self._uid_lock:
            lo = self._uid
            self._uid += n
        return range(lo, lo + n)

    def submit_async(self, images, *, model: Optional[str] = None,
                     priority: str = "interactive"):
        """Enqueue requests; returns one Future per image (a bare Future
        for one [H,W,C] image, a list for a [R,H,W,C] stack).  Each future
        resolves to that request's float32 logits."""
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}; "
                             f"have {PRIORITIES}")
        imgs = np.asarray(images, np.float32)
        single = imgs.ndim == 3
        if single:
            imgs = imgs[None]
        entry = self._resolve(model, imgs.shape[1:])
        now = self.clock()
        reqs = [ServeRequest(uid=u, model=entry.name, image=imgs[i],
                             priority=priority, enqueue_ns=now,
                             deadline_ns=now + self.queue.deadline_ns,
                             future=Future())
                for i, u in enumerate(self._next_uids(imgs.shape[0]))]
        self._requests.inc(len(reqs))
        self._ensure_worker()
        self.queue.push_many(reqs)
        futures = [r.future for r in reqs]
        return futures[0] if single else futures

    def submit(self, images, *, model: Optional[str] = None,
               priority: str = "interactive") -> np.ndarray:
        """Enqueue, drain, stack: [R,H,W,C] (or one [H,W,C]) → [R, ...]
        logits in request order.  While a synchronous caller waits, the
        queue drains: partial batches launch at once."""
        imgs = np.asarray(images, np.float32)
        if imgs.ndim == 3:
            imgs = imgs[None]
        if imgs.shape[0] == 0:
            entry = self._resolve(model, imgs.shape[1:]) \
                if model or self._models else None
            shape = entry.out_shape if entry is not None else (0,)
            return np.zeros((0, *shape), np.float32)
        with self.queue.cond:
            self._drain_waiters += 1
        try:
            futures = self.submit_async(imgs, model=model,
                                        priority=priority)
            out = [f.result(timeout=SUBMIT_TIMEOUT_S) for f in futures]
        finally:
            with self.queue.cond:
                self._drain_waiters -= 1
        return np.stack(out)

    # -- the serving loop ----------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._stopping:
                raise RuntimeError("engine is closed")
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._serve_loop, daemon=True,
                    name="conv-serve-worker")
                self._worker.start()

    def _serve_loop(self) -> None:
        while True:
            fb = None
            retire_idle = False
            with self.queue.cond:
                while not self._stopping:
                    fb = self.queue.form_locked(
                        self.batch, drain=self._drain_waiters > 0)
                    if fb is not None:
                        break
                    if self._inflight:
                        retire_idle = True    # use idle time to retire
                        break
                    nxt = self.queue.next_deadline_ns()
                    timeout = None if nxt is None else \
                        max((nxt - self.clock()) / 1e9, 0.0)
                    self.queue.cond.wait(timeout=timeout)
                if self._stopping and fb is None and not retire_idle:
                    break
            try:
                if fb is not None:
                    self._dispatch(fb)
                    while len(self._inflight) > self.max_inflight:
                        self._retire_one()
                elif self._inflight:
                    self._retire_one()
            except BaseException as e:        # never strand submitters
                if fb is not None:
                    _fail(fb, e)
        # stop: drain whatever is queued, then retire everything
        while True:
            fb = self.queue.form(self.batch, drain=True)
            if fb is None:
                break
            try:
                self._dispatch(fb)
            except BaseException as e:
                _fail(fb, e)
        while self._inflight:
            self._retire_one()

    def _take_slot(self, entry: _Model) -> _Slot:
        """A free staging slot for ``entry``'s shapes, or a new one
        (pinned on a CUDA engine).  A slot comes back to the free list only
        when its batch has retired."""
        key = (entry.input_shape, entry.out_shape)
        free = self._free_slots.setdefault(key, [])
        if free:
            return free.pop()
        pin = self.device.type == "cuda"
        return _Slot(
            key=key,
            inp=torch.empty((self.batch, *entry.input_shape),
                            dtype=torch.float32, pin_memory=pin),
            out=torch.empty((self.batch, *entry.out_shape),
                            dtype=torch.float32, pin_memory=pin),
            event=torch.cuda.Event() if pin else None)

    def _maybe_profile(self, entry: _Model, x: torch.Tensor, tile_plans,
                       cfg) -> None:
        """One-off layer-at-a-time profile of the first observed batch
        (obs enabled only), with the live drift check under a table."""
        from repro_torch.obs.profile import DriftDetector, profile_network
        drift = None
        if self.calib is not None:
            drift = DriftDetector(self._drift_band) if self._drift_band \
                else DriftDetector()
        self.layer_profile = profile_network(
            entry.qnet, x, core_config=cfg, tile_plans=tile_plans,
            calib=self.calib, drift=drift)
        self.drift_events = self.layer_profile.drift

    def _route_for(self, entry: _Model,
                   n_real: int) -> Tuple[str, Any, Optional[str]]:
        """(backend name, scheduler, routed mode) of one formed batch: the
        static verdict unless routing is on and the model carries a tune
        plan (the route table needs its per-layer costs)."""
        if not self.route or entry.tune is None:
            return entry.backend_name, entry.sched, None
        cached = entry.routes.get(n_real)
        if cached is None:
            from repro_torch.core.autotune import route_batch
            from repro_torch.core.scheduler import (MultiCoreScheduler,
                                                    SchedulerConfig)
            budget = self.n_cores if self.n_cores > 1 \
                else max(entry.tune.n_cores, 1)
            mode, cores, _ = route_batch(entry.tune.layers, n_real,
                                         budget, calib=self.calib)
            sched = MultiCoreScheduler(
                SchedulerConfig(n_cores=cores, mode=mode))
            bname = self._shard_backend_name(sched)
            cached = entry.routes[n_real] = (bname, sched, mode)
        self.metrics.counter(f"route.{cached[2]}").inc()
        return cached

    def _dispatch(self, fb: FormedBatch) -> None:
        """Stage, upload and launch one formed batch on the engine's
        stream; its logits copy back asynchronously (see the module
        note)."""
        entry = self._models[fb.model]
        n_real = len(fb.requests)
        pad = self.batch - n_real
        now = self.clock()
        for r in fb.requests:
            self._queue_wait.observe((now - r.enqueue_ns) / 1e3)
        self._formed[fb.reason].inc()
        self._fill.observe(n_real / self.batch)
        if pad:
            self._padded.inc(pad)
        backend_name, sched, routed = self._route_for(entry, n_real)
        program, tile_plans, cfg = self._compiled(entry, backend_name)
        slot = self._take_slot(entry)
        try:
            # one copy into the staging rows (torch's copy uses the host's
            # cores), zeros in the padded lanes
            torch.stack([torch.from_numpy(r.image) for r in fb.requests],
                        out=slot.inp[:n_real])
            slot.inp[n_real:] = 0.0
            run = (entry, fb, slot, program, tile_plans, cfg, sched, routed)
            if self._stream is None:
                keep = self._run(*run)
            else:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    keep = self._run(*run)
        except BaseException:
            self._free_slots[slot.key].append(slot)
            raise
        self._inflight.append(_InFlight(slot, fb, self.clock(), keep))

    def _run(self, entry, fb, slot, program, tile_plans, cfg, sched,
             routed) -> tuple:
        x = slot.inp.to(self.device, non_blocking=True)
        if obs.enabled() and self.layer_profile is None:
            self._maybe_profile(entry, x, tile_plans, cfg)
        with obs.span("engine.batch", network=entry.qnet.plan.name,
                      model=entry.name, fill=len(fb.requests) / self.batch,
                      padded=self.batch - len(fb.requests),
                      reason=fb.reason,
                      **({"routed": routed} if routed else {})):
            logits = sched.run(program, x)
        slot.out.copy_(logits, non_blocking=True)
        if slot.event is not None:
            slot.event.record(self._stream)
        return x, logits

    def _retire_one(self) -> None:
        job = self._inflight.popleft()
        slot, fb = job.slot, job.batch
        try:
            if slot.event is not None:
                slot.event.synchronize()      # blocks on this batch only
            logits = slot.out[:len(fb.requests)].numpy().copy()
        except BaseException as e:
            _fail(fb, e)
            return
        finally:
            self._free_slots[slot.key].append(slot)
        now = self.clock()
        self._device_us.observe((now - job.t0) / 1e3)
        self._batches.inc()
        for i, r in enumerate(fb.requests):
            self._latency.observe((now - r.enqueue_ns) / 1e3)
            r.future.set_result(logits[i])

    # -- stats / lifecycle ---------------------------------------------------

    @property
    def stats(self) -> Dict[str, int]:
        """The counter triple (requests / batches / padded)."""
        return {"requests": self._requests.value,
                "batches": self._batches.value,
                "padded": self._padded.value}

    def formation_counts(self) -> Dict[str, int]:
        return {r: c.value for r, c in self._formed.items()}

    def cache_stats(self) -> Dict[str, int]:
        return {"hits": self.metrics.counter("cache.hits").value,
                "misses": self.metrics.counter("cache.misses").value,
                "evictions":
                    self.metrics.counter("cache.evictions").value,
                "size": len(self.cache),
                "capacity": self.cache.capacity}

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p90/p99 (+count/mean) of enqueue → result latency in µs,
        queue wait included."""
        return self._latency.summary()

    def close(self, timeout: float = SUBMIT_TIMEOUT_S) -> None:
        """Stop the worker after draining queued work (idempotent)."""
        with self._worker_lock:
            worker = self._worker
            self._stopping = True
        with self.queue.cond:
            self.queue.cond.notify_all()
        if worker is not None and worker.is_alive():
            worker.join(timeout=timeout)

    def __enter__(self) -> "ContinuousBatchingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fail(fb: FormedBatch, e: BaseException) -> None:
    for r in fb.requests:
        if not r.future.done():
            r.future.set_exception(e)
