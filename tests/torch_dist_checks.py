"""Multi-rank checks of the port's distribution, shared by
``test_torch_distributed.py`` (gloo ranks on the CPU) and ``chip_smoke.py``
(ranks on the card).  No JAX here: the JAX side of the CPU test lives in
the test file.

``spawn_ranks`` starts ``world`` processes, each with its process group up
(``launch.mesh.init_world``), runs ``fn(rank, world, *args)`` in each and
returns rank 0's result; a rank that fails (an exception, an abort, a hang
past the timeout) fails the call.  ``hold_step`` holds one train step
against another: loss, gradients by relative L2, params / m / v by the
near-zero-gradient rule of ``test_torch_cuda.lm_train_step_card_vs_cpu``.
"""

from __future__ import annotations

import dataclasses
import io
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

# the CPU tests' AdamW hyperparameters (``test_torch_cuda.LM_STEP_HP``):
# step 0 runs at lr = 5e-4, so a skipped or wrong update moves a param past
# the 1e-4 tolerance
STEP_HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
# how far two gradients of a param may move its step-0 update before the
# param is held to 2·lr (``test_torch_cuda.NEAR_ZERO_MOVE``)
NEAR_ZERO_MOVE = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, fn, args, queue):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world
    try:
        backend = init_world(rank, world, f"tcp://localhost:{port}",
                             device=device, timeout_s=300)
        out = fn(rank, world, *args)
        blob = None
        if rank == 0:
            # bytes, not tensors: torch's queue would hand over shared
            # memory that this process takes with it when it exits
            buf = io.BytesIO()
            torch.save(out, buf)
            blob = buf.getvalue()
        queue.put((rank, None, blob, backend))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, traceback.format_exc(), None, None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, device="cpu",
                timeout_s: float = 600.0):
    """``fn(rank, world, *args)`` in ``world`` spawned ranks → (rank 0's
    result, the process group backend).  ``fn`` must be importable (a
    module-level function)."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world:
            if not queue.empty():
                rank, err, out, backend = queue.get()
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                got[rank] = (out if out is None else torch.load(
                    io.BytesIO(out), weights_only=False), backend)
                continue
            dead = [p.exitcode for p in procs
                    if p.exitcode not in (None, 0)]
            if dead or time.monotonic() > deadline:
                time.sleep(1.0)        # a last report may be in flight
                if not queue.empty():
                    continue
                raise RuntimeError(f"ranks exited with {dead} or passed "
                                   f"{timeout_s:.0f} s without reporting")
            time.sleep(0.05)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    return got[0]


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖₂ / ‖want‖₂ in float64 (0 where both are zero)."""
    d = float((got.double() - want.double()).norm())
    n = float(want.double().norm())
    return d / n if n else d


def hold_step(got, want, *, grad_rel: float, hp: dict = STEP_HP,
              tol: float = 1e-4, loss_tol: float = 2e-4):
    """One train step ``got`` = (metrics, grads, state) against ``want``:
    the loss within ``loss_tol``; every gradient within ``grad_rel``
    relative L2; params, m and v within ``tol`` (relative and absolute),
    a param whose two gradients may move its step-0 AdamW update by more
    than ``NEAR_ZERO_MOVE`` (or of opposite signs) within 2·lr more.
    ``state`` = {"params", "m", "v": [leaves]} → the worst readings."""
    (gm, gg, gs), (wm, wg, ws) = got, want
    if abs(gm["loss"] - wm["loss"]) > loss_tol:
        raise AssertionError(f"loss {gm['loss']} vs {wm['loss']}")
    rels = [rel_l2(a, b) for a, b in zip(gg, wg)]
    if max(rels) > grad_rel:
        raise AssertionError(f"gradient leaf {int(np.argmax(rels))}: rel "
                             f"L2 {max(rels)} past {grad_rel}")
    lr, eps = wm["lr"], 1e-8
    clip = min(1.0, 1.0 / wm["grad_norm"])
    near, worst = 0, 0.0
    for name in ("params", "m", "v"):
        for i, (a, w) in enumerate(zip(gs[name], ws[name])):
            a, w = a.double(), w.double()
            t = tol + tol * w.abs()
            loose = torch.zeros_like(w, dtype=torch.bool)
            if name == "params":
                ga, gw = gg[i].double() * clip, wg[i].double() * clip
                move = lr * eps * (ga - gw).abs() / (
                    (ga.abs() + eps) * (gw.abs() + eps))
                loose = (torch.sign(ga) != torch.sign(gw)) | (
                    move > NEAR_ZERO_MOVE)
                near += int(loose.sum())
                t = torch.where(loose, t + 2 * lr, t)
            err = (a - w).abs()
            if not bool((err <= t).all()):
                raise AssertionError(f"{name} leaf {i}: {float(err.max())}")
            worst = max(worst, float(torch.where(loose, 0.0, err).max()))
    return {"loss": abs(gm["loss"] - wm["loss"]), "grad_rel": max(rels),
            "state": worst, "near_zero": near}


def f32_reading(x, w, bias, got, control=True):
    """One f32 GEMM of a step, ``got`` = x @ w (+ bias), against its
    float64 product: every element within ``f32_sum_bound``, the whole
    within ``GRAD_REL_L2`` and, with ``control``, the product of
    TF32-rounded operands outside it (``test_torch_cuda.check_grad``) →
    (got's relative L2, torch.matmul's on the same operands, the TF32
    control's, or None without ``control``).  A bf16 step's backward
    GEMMs take bf16 values, which TF32 holds exactly: no control there."""
    from test_torch_cuda import (GRAD_REL_L2, check_grad, f32_sum_bound,
                                 tf32_round)
    (m, k), n = x.shape, w.shape[1]
    name = f"[{m},{k}]@[{k},{n}]"
    xd, wd = x.double(), w.double()
    want, s, lib = xd @ wd, xd.abs() @ wd.abs(), x @ w
    if bias is not None:
        want, s, lib = want + bias.double(), s + bias.double().abs(), \
            lib + bias
    if not control:
        err = (got.double() - want).abs()
        rel = rel_l2(got, want)
        if bool((err > f32_sum_bound(k, s)).any()) or rel > GRAD_REL_L2:
            raise AssertionError(f"{name}: max err {float(err.max())}, rel "
                                 f"L2 {rel} past f32_sum_bound or "
                                 f"{GRAD_REL_L2}")
        return rel, rel_l2(lib, want), None
    ctl = tf32_round(x).double() @ tf32_round(w).double()
    if bias is not None:
        ctl = ctl + bias.double()
    _, rel, ctl_rel = check_grad(name, got, want, s, k, ctl)
    return rel, rel_l2(lib, want), ctl_rel


def read_f32_calls(worst: dict):
    """A stand-in for ``ops._matmul_kernel`` that runs the kernel and reads
    each f32 call by ``f32_reading`` outside the dispatch modes of the
    remat's selective checkpoint (which would save the readings' own
    GEMMs) into ``worst``: "calls" counted, "ws" and "lib" the largest
    readings, "ctl" the smallest control."""
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.kernels.matmul_ws import matmul_ws
    worst.update(calls=0, ws=0.0, lib=0.0, ctl=float("inf"))

    def read(x, w, bias=None):
        got = matmul_ws(x, w, bias)
        if x.dtype == torch.float32:
            with _disable_current_modes():
                ws, lib, ctl = f32_reading(x, w, bias, got)
            worst.update(calls=worst["calls"] + 1, ws=max(worst["ws"], ws),
                         lib=max(worst["lib"], lib),
                         ctl=min(worst["ctl"], ctl))
        return got
    return read


# ---------------------------------------------------------------------------
# scenarios, each run in every rank
# ---------------------------------------------------------------------------


def _full(t, cpu=True):
    from torch.distributed.tensor import DTensor
    t = (t.full_tensor() if isinstance(t, DTensor) else t).detach()
    return t.cpu() if cpu else t


def step_outputs(metrics, grads, state, cpu=True):
    """(metrics as floats, gradient leaves, {"params", "m", "v": leaves})
    as whole tensors, on the CPU unless ``cpu`` is False."""
    from repro_torch.optim.adamw import tree_leaves
    return ({k: float(_full(v)) for k, v in metrics.items()},
            [_full(g, cpu) for g in grads],
            {k: [_full(t, cpu) for t in tree_leaves(v)] for k, v in (
                ("params", state["params"]), ("m", state["opt"]["m"]),
                ("v", state["opt"]["v"]))})


def captured_step(step_fn, state, batch):
    """``step_fn(state, batch)`` with the gradients that reach the update
    captured (accumulated and scaled, before the clip) → (step_outputs on
    the state's device, the new state).  For steps with microbatches,
    whose gradients ``_grads`` alone would not give."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import train_step as ts
    got = {}
    orig = ts.adamw_update_

    def capture(params, grads, opt, step, hp):
        got["grads"] = [_full(g, cpu=False).clone()
                        for g in tree_leaves(grads)]
        return orig(params, grads, opt, step, hp)
    ts.adamw_update_ = capture
    try:
        new, metrics = step_fn(state, batch)
    finally:
        ts.adamw_update_ = orig
    return step_outputs(metrics, got["grads"], new, cpu=False), new


def full_shardings(plan, specs):
    """``plan``'s NamedShardings of a train state of ``specs``."""
    from repro_torch.layers.common import ParamSpec
    return plan.param_shardings({
        "params": specs["params"], "opt": specs["opt"],
        "step": ParamSpec((), (), dtype="int32", init="zeros")})


def outputs_equal(a, b) -> list:
    """The leaves (named) where two step_outputs differ bit for bit."""
    (am, ag, as_), (bm, bg, bs) = a, b
    bad = [k for k in am if am[k] != bm[k]]
    bad += [f"grad {i}" for i, (x, y) in enumerate(zip(ag, bg))
            if not torch.equal(x, y)]
    for name in ("params", "m", "v"):
        bad += [f"{name} {i}" for i, (x, y) in enumerate(
            zip(as_[name], bs[name])) if not torch.equal(x, y)]
    return bad


def sharded_step(state, batch, cfg, hp, plan, specs):
    """The gradients and one train step of ``state`` (plain tensors, the
    same on every rank) placed on ``plan`` → (step_outputs, the placed
    state after the step)."""
    from repro_torch.distributed.sharding import device_put, use_mesh
    from repro_torch.layers.common import activate_rules
    from repro_torch.train import train_step as ts
    with use_mesh(plan.mesh):
        sd = device_put(state, full_shardings(plan, specs))
        with activate_rules(plan.acts):
            grads = ts._grads(sd["params"], ts._constrain_batch(batch),
                              cfg)[3]
        new, metrics = ts.make_train_step(cfg, hp, act_rules=plan.acts)(
            sd, batch)
        return step_outputs(metrics, grads, new), new


def plain_step(state, batch, cfg, hp):
    """The same on one device → step_outputs."""
    from repro_torch.train import train_step as ts
    grads = ts._grads(state["params"], batch, cfg)[3]
    new, metrics = ts.make_train_step(cfg, hp)(state, batch)
    return step_outputs(metrics, grads, new)


def draw_state(cfg, seed, device):
    """A train state drawn from ``seed`` on ``device``: the same on every
    rank."""
    from repro_torch.layers.common import materialize
    from repro_torch.train import train_step as ts
    specs = ts.init_state_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {"params": materialize(specs["params"], gen, device=device),
             "opt": materialize(specs["opt"], gen, device=device),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state, specs


def draw_batch(vocab, batch, seq, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return {k: torch.randint(0, vocab, (batch, seq), generator=gen).to(
        device) for k in ("tokens", "labels")}


def sharded_decode(params, cache, cfg, plan, pspecs, cspecs, tokens, pos,
                   steps: int):
    """``steps`` decode steps of ``params`` / ``cache`` (plain, the same on
    every rank) placed on ``plan`` (mode "decode") → the logits of each
    step and the cache after them, whole on CPU."""
    from repro_torch.distributed.sharding import device_put, use_mesh
    from repro_torch.layers.common import tree_map
    from repro_torch.serving.serve_step import make_decode_step
    out = []
    with use_mesh(plan.mesh), torch.no_grad():
        pd = device_put(params, plan.param_shardings(pspecs))
        cd = device_put(cache, plan.cache_shardings(cspecs))
        step = make_decode_step(cfg, act_rules=plan.acts)
        for i in range(steps):
            logits, cd = step(pd, cd, tokens + i, pos + i)
            out.append(_full(logits))
    return out, tree_map(_full, cd)


def plain_decode(params, cache, cfg, tokens, pos, steps: int):
    from repro_torch.layers.common import tree_map
    from repro_torch.serving.serve_step import make_decode_step
    step = make_decode_step(cfg)
    out = []
    with torch.no_grad():
        for i in range(steps):
            logits, cache = step(params, cache, tokens + i, pos + i)
            out.append(logits.detach().cpu())
    return out, tree_map(lambda t: t.detach().cpu(), cache)


def compressed_psum_check(rank, mesh, axis, shape, seed, device):
    """``compressed_psum`` of a per-rank f32 tensor over mesh dim ``axis``
    → (this rank's input, the result, every rank's input of the dim's
    group), all on the CPU."""
    import torch.distributed as dist

    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.sharding import use_mesh
    gen = torch.Generator(device="cpu").manual_seed(seed + rank)
    x = torch.randn(shape, generator=gen).to(device)
    with use_mesh(mesh):
        y = compressed_psum(x, axis)
    group = mesh.get_group(axis)
    peers = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(peers, x, group=group)
    return x.cpu(), y.cpu(), [p.cpu() for p in peers]


def compressed_psum_want(inputs):
    """The reference's ``psum`` / ``pmax`` math in numpy: each input on
    its own int8 grid (round half to even), the int8 values summed in
    int32, times the largest scale."""
    acc, scale = 0, np.float32(0)
    for x in inputs:
        x = x.numpy().astype(np.float32)
        s = np.float32(max(np.float32(np.abs(x).max()), np.float32(1e-12))
                       / np.float32(127.0))
        q = np.clip(np.round(x / s), -128, 127).astype(np.int8)
        acc = acc + q.astype(np.int32)
        scale = max(scale, s)
    return acc.astype(np.float32) * np.float32(scale)


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _square_sum(y):
    return torch.sum(torch.square(y))


def pipeline_check(mesh, axis, params, x, n_micro, fn=stage_fn,
                   loss=_square_sum):
    """``pipeline_apply`` of ``fn`` over mesh dim ``axis`` (params, a tree
    with a leading stage axis, the same on every rank, placed one stage a
    rank) → (y, the gradient of ``loss(y)`` for every stage's params,
    gathered), on the CPU."""
    import torch.distributed as dist

    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import P, NamedSharding, place
    from repro_torch.layers.common import tree_map
    from repro_torch.optim.adamw import tree_leaves
    on_axis = NamedSharding(mesh, P(axis))
    p = tree_map(lambda v: place(v.detach(), on_axis).requires_grad_(),
                 params)
    y = pipeline_apply(fn, p, x, mesh=mesh, axis=axis, n_micro=n_micro)
    loss(y).backward()
    group = mesh.get_group(axis)
    grads = []
    for v in tree_leaves(p):
        mine = v.grad.to_local()[0].contiguous()
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        grads.append(torch.stack(parts).cpu())
    return y.detach().cpu(), grads


def sequential(params, x, fn=stage_fn):
    from repro_torch.layers.common import tree_map
    from repro_torch.optim.adamw import tree_leaves
    h = x
    for s in range(tree_leaves(params)[0].shape[0]):
        h = fn(tree_map(lambda v: v[s], params), h)
    return h


def pipeline_inputs(n_stages, d, batch, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = {"w": torch.randn((n_stages, d, d), generator=gen) * 0.3,
              "b": torch.randn((n_stages, d), generator=gen) * 0.1}
    x = torch.randn((batch, d), generator=gen)
    return ({k: v.to(device) for k, v in params.items()}, x.to(device))


def bias_once_check(mesh, m, k, n, seed, device):
    """``ops.matmul_ws`` with a bias on a K-sharded product (x sharded on
    its columns and w on its rows over every mesh dim): the result and
    the gradients of x, w and the bias, whole on the CPU."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x, w, b = (torch.randn(s, generator=gen).to(device)
               for s in ((m, k), (k, n), (n,)))
    nd = mesh.ndim
    xd = distribute_tensor(x, mesh, [Shard(1)] * nd, src_data_rank=None)
    wd = distribute_tensor(w, mesh, [Shard(0)] * nd, src_data_rank=None)
    bd = distribute_tensor(b, mesh, [Replicate()] * nd, src_data_rank=None)
    for t in (xd, wd, bd):
        t.requires_grad_()
    y = ops.matmul_ws(xd, wd, bd)
    torch.sum(y * y).backward()
    return tuple(_full(t) for t in (y, xd.grad, wd.grad, bd.grad)) + (
        x.cpu(), w.cpu(), b.cpu())


def checkpoint_roundtrip(state_sharded, plan_to, specs, directory):
    """Save a sharded state, restore it onto ``plan_to``'s mesh → the
    restored state's whole values and the saved ones (CPU)."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.layers.common import tree_map
    ck = Checkpointer(directory)
    ck.save(1, state_sharded, extra={"from": "sharded"})
    target = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                            device=_local_device(t)),
                      state_sharded)
    back, extra = ck.restore(target,
                             shardings=full_shardings(plan_to, specs))
    assert extra == {"from": "sharded"}
    return tree_map(_full, back), tree_map(_full, state_sharded)


def _local_device(t):
    from torch.distributed.tensor import DTensor
    return t.to_local().device if isinstance(t, DTensor) else t.device


# ---------------------------------------------------------------------------
# the CPU test's ranks: one spawn runs every scenario
# ---------------------------------------------------------------------------


def remat_readings(run):
    """``run()`` with the ``"minimal"`` remat policy's saves and the
    ``matmul_ws`` kernel's calls counted → (its result, {"saved": dots
    the policy saved, "matmul_ws": kernel calls})."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    n = {"saved": 0, "matmul_ws": 0}
    policy, kernel = lm._POLICIES["minimal"], kops._matmul_kernel

    def counted_policy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            n["saved"] += 1
        return out

    def counted_kernel(*args, **kwargs):
        n["matmul_ws"] += 1
        return kernel(*args, **kwargs)
    lm._POLICIES["minimal"] = counted_policy
    kops._matmul_kernel = counted_kernel
    try:
        return run(), n
    finally:
        lm._POLICIES["minimal"] = policy
        kops._matmul_kernel = kernel


def reduced_cfg(backend: str, arch: str = "llama3_8b"):
    from repro_torch.configs.base import get_config, reduce_config
    return dataclasses.replace(reduce_config(get_config(arch)),
                               gemm_backend=backend)


def cpu_scenarios(rank, world, ckpt_dir, state, batch):
    """Every scenario of ``test_torch_distributed`` on a (2, 4) gloo mesh
    of CPU ranks, the train steps from ``state`` on ``batch`` → rank 0's
    readings (whole CPU tensors)."""
    from repro_torch.distributed.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.layers.common import tree_map
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_state_specs
    mesh = make_debug_mesh(2, 4, device="cpu")
    hp = AdamWConfig(**STEP_HP)
    out = {}
    for backend in ("xla", "pallas_ws"):
        cfg = reduced_cfg(backend)
        specs = init_state_specs(cfg)
        plan = ShardingPlan(mesh=mesh, fsdp=True, mode="train")
        out[f"train_{backend}"], sd = sharded_step(
            tree_map(torch.clone, state), batch, cfg, hp, plan, specs)
        if backend == "xla":
            plan42 = ShardingPlan(mesh=make_debug_mesh(4, 2, device="cpu"),
                                  fsdp=True, mode="train")
            out["ckpt"] = checkpoint_roundtrip(sd, plan42, specs, ckpt_dir)
        del sd
    cfg = dataclasses.replace(reduced_cfg("pallas_ws"),
                              remat_policy="minimal")
    plan = ShardingPlan(mesh=mesh, fsdp=True, mode="train")
    out["remat"] = remat_readings(lambda: sharded_step(
        tree_map(torch.clone, state), batch, cfg, hp, plan,
        init_state_specs(cfg))[0])
    for backend, fsdp in (("xla", False), ("pallas_ws", True)):
        cfg = reduced_cfg(backend)
        params = draw_state(cfg, 2, "cpu")[0]["params"]
        pspecs = lm.param_specs(cfg)
        cache, tokens, pos = prefilled_cache(params, cfg, 4, 32, 12)
        plan = ShardingPlan(mesh=mesh, fsdp=fsdp, mode="decode")
        out[f"decode_{backend}"] = sharded_decode(
            params, tree_map(torch.clone, cache), cfg, plan, pspecs,
            lm.cache_specs(cfg, 4, 32), tokens, pos, 2)
    out.update(moe_checks(mesh, state, batch, hp))
    out["bias_once"] = bias_once_check(mesh, 16, 32, 24, 3, "cpu")
    out["psum"] = {axis: compressed_psum_check(rank, mesh, axis, (64, 48),
                                               4, "cpu")
                   for axis in ("data", "model")}
    params, x = pipeline_inputs(4, 16, 32, 5, "cpu")
    out["pipeline"] = pipeline_check(mesh, "model", params, x, 8)
    return out


def moe_prompt(cfg, batch, prompt):
    gen = torch.Generator(device="cpu").manual_seed(9)
    return torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen)


def moe_checks(mesh, state, batch, hp):
    """The reduced deepseek_moe_16b's sharded serving on ``mesh`` (each
    rank routing its batch rows to the experts it holds): the prefill's
    logits and 2 decode steps → {"moe_prefill", "moe_decode"}; and the
    sharded train step refused ("moe_train": the error's text)."""
    from repro_torch.distributed.sharding import (ShardingPlan, device_put,
                                                  use_mesh)
    from repro_torch.layers.common import tree_map
    from repro_torch.models import lm
    from repro_torch.serving.serve_step import make_prefill_step
    from repro_torch.train.train_step import init_state_specs
    cfg = reduced_cfg("xla", "deepseek_moe_16b")
    moe_state = draw_state(cfg, 2, "cpu")[0]
    params, pspecs = moe_state["params"], lm.param_specs(cfg)
    out = {}
    plan = ShardingPlan(mesh=mesh, fsdp=False, mode="prefill")
    toks = moe_prompt(cfg, 4, 16)
    with use_mesh(mesh), torch.no_grad():
        pd = device_put(params, plan.param_shardings(pspecs))
        tb = device_put({"tokens": toks}, plan.input_shardings(
            {"tokens": toks}))
        logits, _ = make_prefill_step(cfg, act_rules=plan.acts)(pd, tb)
        out["moe_prefill"] = _full(logits)
    cache, tokens, pos = prefilled_cache(params, cfg, 4, 32, 12)
    out["moe_decode"] = sharded_decode(
        params, tree_map(torch.clone, cache), cfg,
        ShardingPlan(mesh=mesh, fsdp=False, mode="decode"), pspecs,
        lm.cache_specs(cfg, 4, 32), tokens, pos, 2)
    try:
        sharded_step(moe_state, {k: v[:, :16] for k, v in batch.items()},
                     cfg, hp, ShardingPlan(mesh=mesh, fsdp=True,
                                           mode="train"),
                     init_state_specs(cfg))
        out["moe_train"] = ""
    except NotImplementedError as e:
        out["moe_train"] = str(e)
    return out


def prefilled_cache(params, cfg, batch, cache_len, prompt):
    """A decode cache of ``batch`` slots × ``cache_len`` positions after a
    ``prompt``-token prefill (seeded tokens) → (cache, the next tokens,
    their positions)."""
    from repro_torch.models import lm
    gen = torch.Generator(device="cpu").manual_seed(7)
    dev = params["final_norm"]["scale"].device
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=gen).to(dev)
    with torch.no_grad():
        _, cache = lm.prefill(params, {"tokens": toks}, cfg,
                              cache_len=cache_len)
    return cache, toks[:, -1], torch.full((batch,), prompt, device=dev)


# ---------------------------------------------------------------------------
# chip_smoke phase 11(b): ranks on the card
# ---------------------------------------------------------------------------

# the (b) checks and the collectives each needs beyond those its own run
# exercises: DTensor's all-gather (Shard → Replicate, functional
# collectives) for the sharded steps
CARD_CHECKS = {"compressed_psum": (), "pipeline_apply": (),
               "sharded_train_step": ("dtensor_shard_to_replicate",),
               "sharded_decode_step": ("dtensor_shard_to_replicate",)}


def card_scenarios(rank, world, allowed, arch, seed, device=None,
                   reduced=False):
    """Phase 11(b)'s checks on ``world`` = 4 ranks on the card (or on
    ``device``; ``reduced`` shrinks the model, for a rehearsal on the
    CPU), those named in ``allowed`` → rank 0's readings."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh, rank_device
    dev = rank_device(rank, device)
    out = {}
    if "compressed_psum" in allowed:
        # one full-width gradient leaf of llama3.2-3b's MLP, each rank its
        # own, summed over a 4-rank mesh dim
        mesh = make_debug_mesh(world, 1, device=dev)
        shape = (64, 128) if reduced else (3072, 8192)
        x, y, peers = compressed_psum_check(rank, mesh, "data", shape, seed,
                                            dev)
        if rank == 0:
            want = compressed_psum_want(peers)
            out["compressed_psum"] = {
                "equal": bool(np.array_equal(y.numpy(), want)),
                "shape": tuple(y.shape), "max": float(np.abs(want).max())}
        del x, y, peers
    if "pipeline_apply" in allowed:
        out["pipeline_apply"] = card_pipeline(rank, world, arch, seed, dev,
                                              reduced=reduced)
    if "sharded_train_step" in allowed:
        out["sharded_train_step"] = card_train(rank, arch, seed, dev,
                                               reduced)
    if "sharded_decode_step" in allowed:
        out["sharded_decode_step"] = card_decode(rank, arch, seed, dev,
                                                 reduced)
    dist.barrier()
    return out


def _card_cfg(arch, reduced, **kw):
    from repro_torch.configs.base import get_config, reduce_config
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg)
    return dataclasses.replace(cfg, num_layers=2, gemm_backend="pallas_ws",
                               **kw)


def card_train(rank, arch, seed, dev, reduced=False, seq=2048):
    """One train step of 2 full-width ``arch`` layers (f32 compute, remat
    ``"minimal"``, ``pallas_ws``; TF32 off) on a (data=2, model=2) FSDP
    mesh against rank 0's unsharded step from the same state, batch 2 ×
    ``seq``, at lr 5e-4 (``STEP_HP``).  Every f32 ``matmul_ws`` call of
    both is read (``read_f32_calls``); as chip_smoke's phase 10(b), the
    gradients are held within 2 × (the step's 4 × 3 × 2 MLP calls) × the
    worst reading of any rank, ``matmul_ws``'s or torch.matmul's, which
    must sit under the TF32 control's; the loss within the reference
    test's 2e-4, params, m and v by ``hold_step`` (1e-4, the near-zero
    rule).  In bf16 the K-split products round their partial sums once
    more than the whole ones, a difference no such bound can hold →
    readings."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import (ShardingPlan, device_put,
                                                  use_mesh)
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.layers.common import tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _card_cfg(arch, reduced, compute_dtype="float32",
                    remat_policy="minimal", attn_impl="chunked")
    seq = 32 if reduced else seq
    hp = AdamWConfig(**STEP_HP)
    state, specs = draw_state(cfg, seed, dev)
    batch = draw_batch(cfg.vocab_size, 2, seq, seed, dev)
    plan = ShardingPlan(mesh=make_debug_mesh(2, 2, device=dev), fsdp=True,
                        mode="train")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (
        lambda d: None)
    kernel, worst = kops._matmul_kernel, {}
    kops._matmul_kernel = read_f32_calls(worst)
    try:
        plain = (plain_step(tree_map(torch.clone, state), batch, cfg, hp)
                 if rank == 0 else None)
        got = sharded_step(tree_map(torch.clone, state), batch, cfg, hp,
                           plan, specs)[0]
    finally:
        kops._matmul_kernel = kernel
    # each step helper runs the gradients, then the step: 2 × 4 × 3 × L
    # calls a helper
    n_calls = 4 * 3 * cfg.num_layers
    if worst["calls"] != 2 * n_calls * (2 if rank == 0 else 1):
        raise AssertionError(f"rank {rank}: {worst['calls']} f32 matmul_ws "
                             f"calls read")
    reads = torch.tensor([worst["ws"], worst["lib"], -worst["ctl"]],
                         dtype=torch.float64, device=dev)
    dist.all_reduce(reads, op=dist.ReduceOp.MAX)
    ws, lib, ctl = float(reads[0]), float(reads[1]), -float(reads[2])
    # the step alone, timed
    with use_mesh(plan.mesh):
        placed = device_put(state, full_shardings(plan, specs))
        step = ts.make_train_step(cfg, hp, act_rules=plan.acts)
        sync(dev)
        t0 = time.perf_counter()
        float(step(placed, batch)[1]["loss"])
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
    if rank != 0:
        return None
    bound = 2 * n_calls * max(ws, lib)
    if not bound < ctl:
        raise AssertionError(f"the gradient bound {bound} would pass a TF32 "
                             f"GEMM ({ctl})")
    held = hold_step(got, plain, grad_rel=bound)
    return {**held, "bound": bound, "ms": ms, "per_call": max(ws, lib),
            "ctl": ctl, "calls": n_calls}


def card_decode(rank, arch, seed, dev, reduced=False, slots=4,
                cache_len=4096, prompt=3000):
    """Two ``mode="decode"`` steps of 2 full-width ``arch`` layers (bf16,
    ``pallas_ws``) on a (data=2, model=2) mesh after a ``prompt``-token
    prefill, against rank 0's unsharded decode: logits within one bf16
    ulp a layer (2 · 2^-7 relative L2, phase 6's bound) → readings."""
    from repro_torch.distributed.sharding import ShardingPlan
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.layers.common import materialize, tree_map
    from repro_torch.models import lm
    cfg = _card_cfg(arch, reduced)
    if reduced:
        cache_len, prompt = 64, 24
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.compute_params(materialize(lm.param_specs(cfg), gen,
                                           device=dev), cfg)
    cache, tok, pos = prefilled_cache(
        params, dataclasses.replace(cfg, attn_impl="dense"), slots,
        cache_len, prompt)
    plan = ShardingPlan(mesh=make_debug_mesh(2, 2, device=dev), fsdp=False,
                        mode="decode")
    got = sharded_decode(params, tree_map(torch.clone, cache), cfg, plan,
                         lm.param_specs(cfg),
                         lm.cache_specs(cfg, slots, cache_len), tok, pos, 2)
    if rank != 0:
        return None
    want = plain_decode(params, cache, cfg, tok, pos, 2)
    bound = cfg.num_layers * 2.0 ** -7
    rel = max(rel_l2(a, b) for a, b in zip(got[0], want[0]))
    if rel > bound:
        raise AssertionError(f"sharded decode: logits rel L2 {rel}")
    return {"rel": rel, "bound": bound}


def card_pipeline(rank, world, arch, seed, dev, n_micro=8, seq=512,
                  reduced=False):
    """``pipeline_apply`` over ``world`` stages of one full-width ``arch``
    attention block each (f32, ``xla``), ``n_micro`` microbatches of one
    ``seq``-token row, forward and backward, against the sequential
    stack run microbatch by microbatch on rank 0 → readings."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.layers.common import materialize, stack_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.blocks import apply_block_seq, block_specs
    cfg = get_config(arch)
    if reduced:
        cfg, seq = reduce_config(cfg), 32
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              gemm_backend="xla", attn_impl="chunked",
                              remat_policy="none")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = materialize(stack_specs(block_specs(cfg, "attn"), world), gen,
                         device=dev)
    x = torch.randn((n_micro, seq, cfg.d_model), generator=gen, device=dev)
    r = torch.randn((n_micro, seq, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(seq, device=dev).expand(1, seq)

    def block(p, h):
        return apply_block_seq(p, h, cfg, "attn", positions=pos)[0]

    def loss(y):
        return torch.sum(y * r)
    mesh = make_debug_mesh(world, 1, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (
        lambda d: None)
    sync(dev)
    t0 = time.perf_counter()
    y, grads = pipeline_check(mesh, "data", params, x, n_micro, fn=block,
                              loss=loss)
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    if rank != 0:
        dist.barrier()
        return None
    from repro_torch.layers.common import tree_map
    from repro_torch.optim.adamw import tree_leaves
    p = tree_map(lambda v: v.detach().clone().requires_grad_(), params)
    ys = torch.stack([sequential(p, x[m:m + 1], fn=block)[0]
                      for m in range(n_micro)])
    loss(ys).backward()
    rel = [rel_l2(g, v.grad.cpu()) for g, v in zip(grads, tree_leaves(p))]
    dist.barrier()
    return {"forward_equal": bool(torch.equal(y, ys.detach().cpu())),
            "forward_max_err": float((y - ys.detach().cpu()).abs().max()),
            "grad_rel": max(rel), "leaves": len(rel), "ms": ms}


def card_matmul_local(rank, world, cases):
    """``ops.matmul_ws`` on DTensors whose local shards are halves of
    llama3.2-3b's MLP GEMMs, ``world`` = 2 ranks on the card: N split
    (w sharded on its columns, x replicated) and K split (x on its
    columns, w on its rows: a ``Partial`` sum), made with ``from_local``
    so that no collective runs.  Each rank's local output against
    ``matmul_ws_plain`` on its local operands (bf16 within
    ``bf16_gemm_bound``, f32 within ``f32_sum_bound``) and the form it
    launched → rank 0's readings [(case, form, max err)]."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul_ws import (matmul_ws, matmul_ws_plain,
                                               mm_path)
    from repro_torch.launch.mesh import make_debug_mesh, rank_device
    from test_torch_cuda import bf16_gemm_bound, f32_sum_bound
    dev = rank_device(rank)
    mesh = make_debug_mesh(world, 1, device=dev)
    r = Replicate()
    out = []
    for split, m, k, n, dname in cases:
        dt = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(m + k + n + rank)
        kl = k // world if split == "K" else k
        nl = n // world if split == "N" else n
        x = torch.randn((m, kl), generator=gen, device=dev).to(dt)
        w = (torch.randn((kl, nl), generator=gen, device=dev)
             / k ** 0.5).to(dt)
        xp, wp, yp = ((r, r), (Shard(1), r), (Shard(1), r)) if split == \
            "N" else ((Shard(1), r), (Shard(0), r), (Partial(), r))
        xd = DTensor.from_local(x, mesh, xp, run_check=False)
        wd = DTensor.from_local(w, mesh, wp, run_check=False)
        path = mm_path(m, kl, nl, dt)
        before = matmul_ws.path_launches[path]
        y = ops.matmul_ws(xd, wd)
        torch.cuda.synchronize(dev)
        if tuple(y.placements) != yp or tuple(y.shape) != (m, n) or \
                matmul_ws.path_launches[path] != before + 1:
            raise AssertionError(f"{split} [{m},{k}]@[{k},{n}]: "
                                 f"{y.placements} {tuple(y.shape)}")
        got, want = y.to_local(), matmul_ws_plain(x, w)
        err = (got.float() - want.float()).abs()
        if dt == torch.bfloat16:
            bound = bf16_gemm_bound(x, w, None, got, want)
        else:
            bound = f32_sum_bound(kl, x.abs() @ w.abs())
        if not bool((err <= bound).all()):
            raise AssertionError(f"{split} [{m},{k}]@[{k},{n}] {dname} "
                                 f"{path}: {float(err.max())}")
        out.append(((split, m, k, n, dname), path, float(err.max())))
    return out
