"""Production mesh construction (counterpart of ``repro.launch.mesh``) on
``torch.distributed``'s ``DeviceMesh``.

Functions, not module-level constants, so importing this module touches
no process group.  Mesh shapes:

* single-pod: (data=16, model=16)       — 256 ranks
* multi-pod:  (pod=2, data=16, model=16) — 512 ranks

The "pod" axis carries data parallelism across pods; "model" carries
TP/EP inside a pod.  The specs of these meshes need no ranks:
``distributed.sharding`` computes them on an ``AbstractMesh``.

A mesh spans the ranks of the default process group, which the caller
starts (``torchrun``, or ``init_process_group`` with its address, world
size and rank; ``init_world`` does the latter with the backend the layout
calls for).  The mesh's device type is the card unless the caller asks
for ``"cpu"``.  The backend: NCCL where each rank has a card of its own;
gloo on the CPU and where ranks share one card (NCCL refuses two ranks on
one device).  gloo carries only some collectives on CUDA tensors;
``tools/collectives_probe.py`` says which.  No rank's tensors are moved
off its card to suit a backend.
"""

from __future__ import annotations

import datetime
import logging
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)


def backend_for(device: DeviceLike, world: int) -> str:
    """The process group backend of ``world`` ranks on ``device``'s type:
    "nccl" where each rank gets a card of its own, else "gloo"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: DeviceLike = None) -> torch.device:
    """The device rank ``rank`` runs on: its own card where there are
    enough (``rank % count``), all ranks on card 0 otherwise, the CPU on
    request."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_world(rank: int, world: int, init_method: str, *,
               device: DeviceLike = None, timeout_s: float = 600.0) -> str:
    """Start the default process group for ``rank`` of ``world`` at
    ``init_method`` (e.g. ``tcp://localhost:<port>``) on the backend
    ``backend_for`` names, logged, and pin the rank's card.  Returns the
    backend."""
    dev = rank_device(rank, device)
    backend = backend_for(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shared = (dev.type == "cuda"
              and torch.cuda.device_count() < world)
    log.info("rank %d/%d: backend %s on %s%s", rank, world, backend, dev,
             " (ranks share the card)" if shared else "")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device: DeviceLike):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world} — start them with "
            "torchrun, or call init_process_group (launch.mesh.init_world) "
            "with the world size, in every rank, before building the mesh")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(data: int = 2, model: int = 4,
                    device: DeviceLike = None):
    """Small mesh for sharding tests (8 ranks by default)."""
    return _mesh((data, model), ("data", "model"), device)
