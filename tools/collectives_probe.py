"""Which ``torch.distributed`` collectives a backend carries on CUDA tensors
when several ranks share one card.

NCCL refuses two ranks on one device, so ranks that share a card run gloo,
and gloo's coverage of CUDA tensors differs by collective.  ``probe`` runs
each collective (and the DTensor redistributes built on them) once on
tensors on the rank's card, checks its value against what the collective
must give, and returns {name: "ok" | the error}; ``main`` spawns the ranks
and prints one JSON line of the results and the wall time of each.

    python3 tools/collectives_probe.py [--world 4] [--backend gloo]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the collectives, in the order they are probed
COLLECTIVES = ("barrier", "all_reduce_sum", "all_reduce_max",
               "all_reduce_int32", "broadcast", "all_gather_into_tensor",
               "all_gather", "reduce_scatter_tensor", "all_to_all_single",
               "send_recv", "batch_isend_irecv",
               "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
               "dtensor_partial_to_shard", "all_gather_into_tensor_small",
               "funcol_all_gather", "funcol_all_gather_small",
               "dtensor_shard_to_replicate_large", "all_to_all_single_uneven",
               "ppermute")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one(name: str, rank: int, world: int, dev) -> None:
    """Run collective ``name`` on ``dev`` and raise unless it gives the
    value it must."""
    n = 1 << 16
    x = torch.full((n,), float(rank + 1), device=dev)
    if name == "barrier":
        dist.barrier()
        want = x
    elif name == "all_reduce_sum":
        dist.all_reduce(x)
        want = torch.full_like(x, world * (world + 1) / 2)
    elif name == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        want = torch.full_like(x, float(world))
    elif name == "all_reduce_int32":
        x = x.to(torch.int32)
        dist.all_reduce(x)
        want = torch.full_like(x, world * (world + 1) // 2)
    elif name == "broadcast":
        dist.broadcast(x, src=0)
        want = torch.ones_like(x)
    elif name == "all_gather_into_tensor":
        out = torch.empty(world * n, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, torch.arange(1, world + 1, device=dev,
                                    dtype=torch.float32).repeat_interleave(n)
    elif name == "all_gather_into_tensor_small":
        x = x[:8].contiguous()
        out = torch.empty(world * 8, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, torch.arange(1, world + 1, device=dev,
                                    dtype=torch.float32).repeat_interleave(8)
    elif name in ("funcol_all_gather", "funcol_all_gather_small"):
        import torch.distributed._functional_collectives as funcol
        if name.endswith("small"):
            x, n = x[:8].contiguous(), 8
        x = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        x = funcol.wait_tensor(x) if hasattr(funcol, "wait_tensor") else x
        want = torch.arange(1, world + 1, device=dev,
                            dtype=torch.float32).repeat_interleave(n)
    elif name == "all_to_all_single_uneven":
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        out = torch.empty_like(x)
        dist.all_to_all_single(
            out, x, output_split_sizes=[n if r == prv else 0
                                        for r in range(world)],
            input_split_sizes=[n if r == nxt else 0 for r in range(world)])
        x, want = out, torch.full_like(x, float(prv + 1))
    elif name == "ppermute":
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "src"))
        from repro_torch.distributed.pipeline import _ring_exchange
        prv = (rank - 1) % world
        x, want = _ring_exchange(x, dist.group.WORLD, 1), torch.full_like(
            x, float(prv + 1))
    elif name == "all_gather":
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        x, want = torch.stack(outs), torch.arange(
            1, world + 1, device=dev, dtype=torch.float32)[:, None].expand(
                world, n)
    elif name == "reduce_scatter_tensor":
        src = torch.full((world * n,), float(rank + 1), device=dev)
        dist.reduce_scatter_tensor(x, src)
        want = torch.full_like(x, world * (world + 1) / 2)
    elif name == "all_to_all_single":
        src = torch.arange(world, device=dev, dtype=torch.float32).add(
            10 * rank).repeat_interleave(n // world)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        x, want = out, (torch.arange(world, device=dev) * 10 + rank).to(
            torch.float32).repeat_interleave(n // world)
    elif name in ("send_recv", "batch_isend_irecv"):
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        out = torch.empty_like(x)
        if name == "send_recv":
            if rank % 2 == 0:
                dist.send(x, nxt)
                dist.recv(out, prv)
            else:
                dist.recv(out, prv)
                dist.send(x, nxt)
        else:
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, nxt),
                    dist.P2POp(dist.irecv, out, prv)]):
                w.wait()
        x, want = out, torch.full_like(x, float(prv + 1))
    else:
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = _mesh(world, dev)
        full = torch.arange(world * 8, device=dev, dtype=torch.float32)
        if name == "dtensor_shard_to_replicate_large":
            full = torch.arange(world * n, device=dev, dtype=torch.float32)
            d = DTensor.from_local(full.chunk(world)[rank], mesh, [Shard(0)],
                                   run_check=False)
            x, want = d.redistribute(mesh, [Replicate()]).to_local(), full
        elif name == "dtensor_shard_to_replicate":
            d = DTensor.from_local(full.chunk(world)[rank], mesh, [Shard(0)],
                                   run_check=False)
            x, want = d.redistribute(mesh, [Replicate()]).to_local(), full
        elif name == "dtensor_partial_to_replicate":
            d = DTensor.from_local(full * (rank + 1), mesh, [Partial()],
                                   run_check=False)
            x = d.redistribute(mesh, [Replicate()]).to_local()
            want = full * (world * (world + 1) / 2)
        else:
            d = DTensor.from_local(full * (rank + 1), mesh, [Partial()],
                                   run_check=False)
            x = d.redistribute(mesh, [Shard(0)]).to_local()
            want = (full * (world * (world + 1) / 2)).chunk(world)[rank]
    if x.device != want.device or not torch.equal(x, want):
        raise AssertionError(f"{name}: wrong value on rank {rank}")


_MESH = {}


def _mesh(world, dev):
    if "m" not in _MESH:
        from torch.distributed.device_mesh import init_device_mesh
        _MESH["m"] = init_device_mesh(dev.type, (world,),
                                      mesh_dim_names=("x",))
    return _MESH["m"]


def _worker(rank, world, backend, port, device_type, name, queue):
    dev = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # a collective one rank refuses must not hang the others: gloo raises
    # once the group's timeout passes
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    t0 = time.perf_counter()
    try:
        _one(name, rank, world, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        queue.put((rank, "", (time.perf_counter() - t0) * 1e3))
    except Exception as e:  # noqa: BLE001 - the probe records any refusal
        queue.put((rank, f"{type(e).__name__}: {str(e)[:200]}",
                   (time.perf_counter() - t0) * 1e3))
    finally:
        dist.destroy_process_group()


def probe_one(name: str, world: int = 4, backend: str = "gloo",
              device_type: str = "cuda", timeout_s: float = 120.0) -> dict:
    """Collective ``name`` in ``world`` fresh ranks sharing card 0 →
    {"ok", "error", "ms"}: ok where every rank got the right value and
    exited cleanly.  Fresh processes each time: gloo aborts a process
    (``std::terminate``) on some CUDA tensors rather than raise, and the
    abort must not take the other probes with it."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, backend, port,
                                               device_type, name, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    res = []
    while not queue.empty():
        res.append(queue.get())
    errors = [e for _, e, _ in res if e]
    if any(c != 0 for c in codes) and not errors:
        errors = [f"ranks exited with codes {codes} (a gloo abort or a "
                  f"hang past {timeout_s:.0f} s)"]
    return {"ok": not errors and len(res) == world and not any(codes),
            "error": errors[0] if errors else "",
            "exit_codes": codes,
            "ms": max((ms for *_, ms in res), default=float("nan"))}


def run(world: int = 4, backend: str = "gloo", device_type: str = "cuda",
        names=COLLECTIVES) -> dict:
    """{collective: probe_one's result} for each of ``names``."""
    return {n: probe_one(n, world, backend, device_type) for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--only", nargs="*", default=None,
                    help="probe these collectives alone")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = run(args.world, args.backend, args.device,
              args.only or COLLECTIVES)
    for name, r in res.items():
        print(f"{name:32s} {'ok ' if r['ok'] else 'NO '} {r['ms']:9.1f} ms "
              f"{r['error']}")
    print(json.dumps({"world": args.world, "backend": args.backend,
                      "device": args.device, "torch": torch.__version__,
                      "results": res}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
