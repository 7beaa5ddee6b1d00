"""The narrow-output conv path's host side against the JAX reference, on the
CPU.

The nk kernels (``csrc/conv2d_ws.cu``, ``csrc/conv2d_ws_pipe.cu``: a
direct conv that sums a group's input channels, for several input
channels a group and under 8 outputs, int8 and f32) run only on the card.
What surrounds them is host code the CPU reaches: the path rule
(``conv_path``), the launch plan (``nk_plan``: a rectangle of one image ×
a run of groups, a 4-pixel strip of one group a thread with all its
outputs, chunks of the group's channels, padded row pitches), the record
the kernel reads (``NkParams``) and the window copy width
(``nk_params``).  ``conv2d_ws_nk_emulate`` replays the kernels' order of
sums (bias, then chunk by chunk, tap by tap, channels ascending, each f32
FFMA rounded once as ``fma_f32`` rounds it) in plain PyTorch and is held
here to the JAX package: int8 bit-exact and f32 within rtol = atol = 1e-4
of ``repro.kernels.ref.conv2d_epilogue_ref`` traced under one ``jax.jit``
a case, and int8 bit-exact to whole-map JAX ``conv2d_ws`` (Pallas in
interpret mode; tiled JAX ``conv2d_ws`` does not run under the installed
jax).  Its f32 bits are the same for both wrappers and any caller tiles
and banks.  The segmentation nets' int8 programs and QAT forward convs at
224 reach the nk path for their heads and the scalar kernel nowhere.  The
same geometries run on the card in ``test_torch_cuda.py``."""

import functools
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.kernels import conv2d_ws as cw
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import (NK_FIELDS, NK_KP, NK_SP, SMEM_BYTES,
                                           SMS, THREADS, NkPlan, conv2d_ws,
                                           conv2d_ws_nk_emulate, conv_path,
                                           dw_plan, fma_f32, nk_params,
                                           nk_plan, nk_read_ways, nk_thread,
                                           nk_write_ways, setup_conv,
                                           simt_plan, tc_plan)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.conv2d_ws_trans import transpose_eq_conv_geometry
from test_torch_cuda import (CASES, NK_CASES, as_torch, case_inputs,
                             legal_banks, tc_case_inputs)

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _int8_case(name):
    """(x, w, b, scale, kwargs) in int8 of a ``NK_CASES`` or ``CASES``
    entry, banks legal."""
    table = NK_CASES if name in NK_CASES else CASES
    return legal_banks(*case_inputs(name, table=table))


def _f32_case(name):
    """The same entry in f32: x and w over 64, the bias over 128, so that
    every product and every sum is exact in f32 and any order of sums
    gives the same bits → (x, w, b, kwargs)."""
    x, w, b, _, kw = _int8_case(name)
    return (np.asarray(x, np.float32) / 64, np.asarray(w, np.float32) / 64,
            np.asarray(b, np.float32) / 128, kw)


NK = sorted(NK_CASES) + ["groups2"]


def _geom(x_shape, w_shape, kw, requant=False, int_path=True):
    geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
    return setup_conv(tuple(x_shape), tuple(w_shape),
                      pool=kw.get("pool", False), requant=requant,
                      int_path=int_path, **geo)


def _frozen(v):
    return tuple(map(_frozen, v)) if isinstance(v, (list, tuple)) else v


@functools.lru_cache(maxsize=None)
def _jax_epilogue(kw_items):
    """``conv2d_epilogue_ref`` with the case's static arguments, under one
    ``jax.jit``."""
    kw = dict(kw_items)
    geo = {k: kw[k] for k in ("stride", "padding", "relu", "pool", "groups",
                              "dilation") if k in kw}
    return jax.jit(functools.partial(jref.conv2d_epilogue_ref, **geo))


def test_nk_cases_cover_the_plan():
    """The emulated cases reach what ``NK_CASES`` names: every output
    width the kernels are built for, runs of 1, 2, 4 and 8 groups, a
    group count the run does not divide, several chunks, the int8 window
    gathered byte by byte and copied by words, stride 2, dilation 2 with
    asymmetric padding, the pool, the heads' 1×1 kernels, a run shorter
    than the group count asks for (a wide f32 window) and a pipe whose
    ring holds one slot of several chunks (a wider one)."""
    plans = {n: nk_plan(_geom(_int8_case(n)[0].shape, _int8_case(n)[1].shape,
                              _int8_case(n)[4])) for n in NK}
    assert {p.kp for p in plans.values()} == set(NK_KP)
    assert {p.gr for p in plans.values()} == {1, 2, 4, 8}
    assert any(p.n_gr > 1 for p in plans.values())
    assert any(p.n_chunks > 1 for p in plans.values())
    assert any(p.kgrp < p.kp for p in plans.values())
    assert any(p.stride == 2 for p in plans.values())
    assert any(p.dil == 2 and p.pt != p.pl for p in plans.values())
    assert any(p.pool for p in plans.values())
    assert any(p.kh == p.kw == 1 for p in plans.values())
    f32 = {n: _geom(_int8_case(n)[0].shape, _int8_case(n)[1].shape,
                    _int8_case(n)[4], int_path=False) for n in NK}
    assert nk_plan(f32["g8_dilation14"]).gr < plans["g8_dilation14"].gr == 8
    one = nk_plan(f32["dilation42_one_slot"], pipelined=True)
    assert one.slots == 1 < one.n_chunks
    assert 2 * one.slot_bytes > SMEM_BYTES >= one.slot_bytes
    x = torch.zeros(1, dtype=torch.int8)
    vecs = {list(nk_params(p, x))[-1] for p in plans.values()}
    assert 0 in vecs and 4 in vecs


@pytest.mark.parametrize("name", NK)
def test_nk_emulation_matches_jax(name):
    """int8 (int32 out and requantized) bit-equal to the JAX oracle, f32
    (f32 out and requantized at per-channel scales) within 1e-4, for both
    wrappers' plans."""
    x, w, b, s, kw = _int8_case(name)
    assert conv_path(_geom(x.shape, w.shape, kw)) == "nk"
    fn = _jax_epilogue(tuple(sorted((k, _frozen(v)) for k, v in kw.items())))
    if s is None:
        s = np.full((w.shape[3],), 0.003, np.float32)
    tx, tw, tb, ts = as_torch(x, w, b, s)
    for scale, t_s in ((None, None), (s, ts)):
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             out_scale=None if scale is None
                             else jnp.asarray(scale)))
        for pipelined in (False, True):
            got = conv2d_ws_nk_emulate(tx, tw, tb, t_s, pipelined=pipelined,
                                       **kw)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
    fx, fw, fb, _ = _f32_case(name)
    want = np.asarray(fn(jnp.asarray(fx), jnp.asarray(fw), jnp.asarray(fb)))
    # f32 → int8 at per-channel scales that spread each channel over the grid
    scale = (100.0 / np.maximum(np.abs(want).reshape(-1, want.shape[-1])
                                .max(0), 1e-3)).astype(np.float32)
    want8 = np.asarray(fn(jnp.asarray(fx), jnp.asarray(fw), jnp.asarray(fb),
                          out_scale=jnp.asarray(scale)))
    tx, tw, tb, ts = as_torch(fx, fw, fb, scale)
    for pipelined in (False, True):
        got = conv2d_ws_nk_emulate(tx, tw, tb, pipelined=pipelined, **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        got8 = conv2d_ws_nk_emulate(tx, tw, tb, ts, pipelined=pipelined,
                                    **kw)
        assert got8.dtype == torch.int8
        np.testing.assert_allclose(got8.numpy(), want8, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", NK)
def test_nk_emulation_bit_equal_to_whole_map_jax_conv(name):
    """int8 against whole-map JAX ``conv2d_ws`` (Pallas, interpret mode):
    the caller's tiles are dropped on the JAX side only."""
    x, w, b, s, kw = _int8_case(name)
    whole = {k: v for k, v in kw.items() if k not in ("h_tile", "w_tile")}
    want = np.asarray(jops.conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        out_scale=None if s is None else jnp.asarray(s), **whole))
    got = conv2d_ws_nk_emulate(*as_torch(x, w, b, s), **kw)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_scale_matches_jax():
    """A Python float requantize scale (filled on the device at launch)
    gives the JAX oracle's int8 bits."""
    x, w, b, _, kw = _int8_case("unet_head")
    fn = _jax_epilogue(tuple(sorted((k, _frozen(v)) for k, v in kw.items())))
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         out_scale=0.0047))
    got = conv2d_ws_nk_emulate(*as_torch(x, w, b), 0.0047, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NK)
def test_f32_bits_do_not_depend_on_the_wrapper_or_the_tiles(name):
    """At f32 operands whose sums round (not the exact ones above), the
    emulation gives the same bits for ``conv2d_ws`` and
    ``conv2d_ws_pipe``, whole-map and under two other caller tile and bank
    choices: their plans differ in ``slots`` and ``smem`` only."""
    x, w, _, _, kw = _int8_case(name)
    rng = np.random.default_rng(3)
    tx = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    tw = torch.from_numpy((rng.normal(size=w.shape) / 3).astype(np.float32))
    tb = torch.from_numpy(rng.normal(size=w.shape[3:]).astype(np.float32))
    pool = kw.get("pool", False)
    groups = kw.get("groups", 1)
    base = {k: v for k, v in kw.items()
            if k not in ("h_tile", "w_tile", "cin_banks", "kout_banks")}
    cgrp, k = w.shape[2], w.shape[3]
    choices = [dict(cin_banks=1, kout_banks=groups),
               dict(h_tile=2, w_tile=4, cin_banks=1, kout_banks=groups),
               dict(h_tile=4 if pool else 3, w_tile=6, cin_banks=max(
                   d for d in (2, 1) if cgrp % d == 0), kout_banks=k)]
    outs, plans = [], set()
    for other in choices:
        kwo = dict(base, **other)
        g = _geom(x.shape, w.shape, kwo, int_path=False)
        for pipelined in (False, True):
            plans.add(nk_plan(g, kw.get("relu", False), pipelined)._replace(
                slots=0, smem=0))
            outs.append(conv2d_ws_nk_emulate(tx, tw, tb, pipelined=pipelined,
                                             **kwo))
    assert len(plans) == 1
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_fma_f32_rounds_once():
    """``fma_f32`` is ``fmaf``: one rounding of the exact sum, where the
    float64 sum of the exact product would round twice (1 + 2^-23 plus
    2^-24 - 2^-60 lies under the midpoint 1 + 1.5·2^-23, to which
    float64 rounds), and on random operands against exact fractions."""
    a = torch.tensor([1 + 2 ** -23], dtype=torch.float32)
    x = torch.tensor([1 + 2 ** -18], dtype=torch.float32)
    w = torch.tensor([2 ** -24 * (1 - 2 ** -18)], dtype=torch.float32)
    assert fma_f32(a, x, w).item() == 1 + 2 ** -23
    assert (a.double() + x.double() * w.double()).float().item() != \
        1 + 2 ** -23
    g = torch.Generator().manual_seed(1)
    a, x, w = (torch.randn(400, generator=g) for _ in range(3))
    got = fma_f32(a, x, w)
    for i in range(400):
        exact = Fraction(a[i].item()) + Fraction(x[i].item()) * Fraction(
            w[i].item())
        r = np.float32(got[i].item())
        below, above = (np.nextafter(r, np.float32(-np.inf)),
                        np.nextafter(r, np.float32(np.inf)))
        err = abs(Fraction(float(r)) - exact)
        assert err <= abs(Fraction(float(below)) - exact)
        assert err <= abs(Fraction(float(above)) - exact)


@pytest.mark.parametrize("int_path", [True, False])
@pytest.mark.parametrize("c,kout,groups", [
    (8, 3, 1),          # unet_small's head
    (16, 3, 1),         # dilated_context's head
    (8, 8, 2),          # groups2: C/g = 4, K/g = 4
    (6, 3, 1),          # C/g = 6
    (32, 12, 4),        # C/g = 8, K/g = 3
    (2, 7, 1),          # C/g = 2, K/g = 7
    (64, 64, 16),       # C/g = 4, K/g = 4, 16 groups: runs of 8
    (256, 4, 1),        # C/g = 256: chunks
    (32, 32, 32),       # depthwise: dw
    (4, 28, 4),         # C/g = 1, K/g = 7: dw
    (8, 8, 1),          # K/g = 8: the implicit GEMM
    (32, 64, 4),        # K/g = 16: the implicit GEMM
])
def test_path_rule(int_path, c, kout, groups):
    """``conv_path`` gives "nk" exactly for C/g > 1 and K/g < 8, in int8
    and f32, and the nk plans of both wrappers fit a block's shared
    memory."""
    g = setup_conv((2, 12, 12, c), (3, 3, c // groups, kout),
                   padding="SAME", groups=groups, cin_banks=1,
                   kout_banks=groups, int_path=int_path)
    narrow = c // groups > 1 and kout // groups < 8
    assert (conv_path(g) == "nk") == narrow
    assert (nk_plan(g) is None) == (not narrow)
    if narrow:
        assert tc_plan(g) is None and simt_plan(g) is None
        assert dw_plan(g) is None
        for pipelined in (False, True):
            p = nk_plan(g, True, pipelined)
            assert p.smem <= SMEM_BYTES and 2 * p.slot_bytes <= SMEM_BYTES
    else:
        assert conv_path(g) == ("dw" if c // groups == 1
                                else "tc" if int_path else "simt")


def _check_plan(p: NkPlan, g, one_slot=False):
    """The invariants of one nk plan of geometry ``g``; ``one_slot``: a
    window so wide that two slots of it fit no block."""
    assert p.kp in NK_KP and p.kgrp <= p.kp
    assert p.kp == min(v for v in NK_KP if v >= p.kgrp)
    assert p.gr in (1, 2, 4, 8) and p.rk == p.gr * p.kgrp
    assert p.cgrp > 1 and p.kgrp < 8 and p.groups * p.cgrp == p.c
    # the threads that own a strip: a power of two dividing the block's
    active = p.gr * p.rh * (p.rw // NK_SP)
    assert p.rw % NK_SP == 0 and THREADS % active == 0
    assert p.rw & (p.rw - 1) == 0 and p.rh & (p.rh - 1) == 0
    # every output covered once: rectangles and runs of groups
    assert (p.n_ry - 1) * p.rh < p.oh <= p.n_ry * p.rh
    assert (p.n_rx - 1) * p.rw < p.ow <= p.n_rx * p.rw
    assert (p.n_gr - 1) * p.gr < p.groups <= p.n_gr * p.gr
    assert p.n_rect == p.n * p.n_ry * p.n_rx * p.n_gr
    # every channel in one chunk
    assert (p.n_chunks - 1) * p.cs < p.cgrp <= p.n_chunks * p.cs
    assert p.cps >= p.cs and p.pps == p.gr * p.cps
    if g.int_path:          # whole 4-, 8- or 16-byte window vectors
        assert p.cps in (4, 8) or (p.cps % 16 == 0 and p.cps - p.cs < 16)
    else:
        assert p.cps == -(-p.cs // 4) * 4
    if p.pool:
        assert p.rh % 2 == 0 and p.rw % 2 == 0
        assert (p.oh, p.ow) == (2 * p.poh, 2 * p.pow_)
    # the window, its rows, the weights and the tile
    es = 1 if g.int_path else 4
    assert p.win_h == (p.rh - 1) * p.stride + (p.kh - 1) * p.dil + 1
    assert p.win_w == (p.rw - 1) * p.stride + (p.kw - 1) * p.dil + 1
    vb = min(p.cps * es, 16)        # a lane's window vector, bytes
    assert p.pitch >= p.win_w * p.pps and (p.pitch * es) % vb == 0
    assert p.wgs >= p.kh * p.kw * p.cps * p.kp and (p.wgs // 4) % 2 == 1
    assert p.win_bytes % 16 == 0 and p.win_bytes >= p.win_h * p.pitch * es
    assert p.slot_bytes % 16 == 0
    assert p.slot_bytes >= p.win_bytes + p.gr * p.wgs * es
    assert p.tpitch >= p.rw * p.rk
    assert p.smem == max(p.slots * p.slot_bytes,
                         -(-p.rh * p.tpitch * 4 // 16) * 16) <= SMEM_BYTES
    # two slots fit, save where the pipe's ring was cut to one
    assert 2 * p.slot_bytes <= SMEM_BYTES or one_slot
    # the window copy width divides the chunk and every offset it starts at
    x = torch.zeros((p.n, p.h, p.w, p.c),
                    dtype=torch.int8 if g.int_path else torch.float32)
    rec = list(nk_params(p, x))
    assert rec[:-1] == list(p) and len(rec) == len(NK_FIELDS)
    xvec = rec[-1]
    assert xvec in (0, 4, 8, 16) and (xvec or g.int_path)
    for v in (p.cs, p.cgrp, p.c, p.cps, p.pps, p.pitch):
        assert xvec == 0 or (v * es) % xvec == 0


@pytest.mark.parametrize("name", NK)
def test_nk_plan_invariants(name):
    x, w, _, _, kw = _int8_case(name)
    for int_path in (True, False):
        g = _geom(x.shape, w.shape, kw, int_path=int_path)
        seq = nk_plan(g, kw.get("relu", False), False)
        pipe = nk_plan(g, kw.get("relu", False), True)
        assert seq._replace(slots=0, smem=0) == pipe._replace(slots=0,
                                                              smem=0)
        one_slot = name == "dilation42_one_slot" and not int_path
        assert (seq.slots, pipe.slots) == (1, 1 if one_slot
                                           else min(2, seq.n_chunks))
        for p in (seq, pipe):
            _check_plan(p, g, one_slot)


@pytest.mark.parametrize("int_path", [True, False])
@pytest.mark.parametrize("xs,ws,kw", [
    ((8, 56, 56, 64), (3, 3, 64, 4), dict(padding="SAME", dilation=16)),
    ((8, 112, 112, 256), (7, 7, 256, 2), dict(stride=2, padding="SAME")),
    ((2, 224, 224, 6), (11, 11, 6, 3), dict(stride=4)),
    ((4, 64, 64, 512), (3, 3, 512, 7), dict(padding="SAME", dilation=24,
                                            pool=True)),
    ((8, 56, 56, 32), (3, 3, 4, 8), dict(padding="SAME", dilation=14,
                                         groups=8)),
], ids=["dilation16", "7x7_c256_stride2", "11x11_stride4",
        "c512_dilation24_pool", "g8_c4_dilation14"])
def test_wide_windows_take_nk(int_path, xs, ws, kw):
    """Layers whose windows are wide still take the nk path for both
    wrappers: the plan chunks the channels (where a group has more than
    4), shortens the run of groups (8 groups of 4 f32 channels at
    dilation 14, whose 4-pixel strip over the 8 groups needs 2 × 118.8 KB,
    run 2 a block), then leaves threads without a strip, and stays within
    every invariant."""
    geo = {k: v for k, v in kw.items() if k != "pool"}
    groups = kw.get("groups", 1)
    g = setup_conv(xs, ws, cin_banks=1, kout_banks=groups,
                   pool=kw.get("pool", False), int_path=int_path, **geo)
    assert conv_path(g) == "nk"
    for pipelined in (False, True):
        p = nk_plan(g, True, pipelined)
        _check_plan(p, g)
        assert p.slots == (min(2, p.n_chunks) if pipelined else 1)
    if g.cgrp > 4:
        assert nk_plan(g).n_chunks > 1
    if groups == 8:
        assert nk_plan(g).gr == (8 if int_path else 2)


def test_nk_plan_refuses_what_no_block_holds():
    """A window no rectangle of 4 pixels holds once, even for a chunk of 4
    channels, has no nk plan for either wrapper: the layer goes to the
    scalar kernel, whose tiles overflow too, so its launch raises and
    says why."""
    for int_path in (True, False):
        g = setup_conv((1, 600, 600, 8), (9, 9, 8, 3), dilation=70,
                       cin_banks=1, kout_banks=1, int_path=int_path)
        assert nk_plan(g) is None and nk_plan(g, pipelined=True) is None
        assert conv_path(g) == "scalar"
        for slots in (1, 2):
            with pytest.raises(ValueError, match="no tile of this layer"):
                cw.scalar_tiles(g, slots)


def _zoo_launches(net):
    """(label, ConvGeom, plan) of every conv launch of ``net``'s int8
    program and of its QAT forward (f32) at 224×224×4, batch 8, both
    wrappers: the transposed convs' stride-1 lowering, each through
    ``_launch_setup`` as a launch sets up."""
    plan = getattr(network, net)(input_shape=(224, 224, 4))
    acts, ins = plan.activation_shapes(), plan.resolved_inputs()
    shapes, geoms = plan.param_shapes(), plan.conv_geometries()
    tps = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
    out = []
    for i, sp in enumerate(plan.layers):
        if sp.kind not in ("conv", "conv_transpose"):
            continue
        h, w, c = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        kh, kw, cg, k = shapes[i]["w"]
        groups = geoms[i][1]
        cb, kb = ref.grouped_banks(c, k, groups)
        if sp.kind == "conv":
            xs, stride, pad, dil = (8, h, w, c), sp.stride, sp.padding, \
                sp.dilation
        else:
            eh, ew, pad = transpose_eq_conv_geometry(h, w, kh, kw,
                                                     sp.stride, sp.padding)
            xs, stride, dil = (8, eh, ew, c), 1, 1
        last = i == max(j for j, s_ in enumerate(plan.layers)
                        if s_.kind == "conv")
        for int_path in (True, False):
            geo = (("stride", stride), ("padding", _frozen(pad)),
                   ("groups", groups), ("dilation", dil), ("cin_banks", cb),
                   ("kout_banks", kb))
            if int_path and tps[i] is not None:
                geo += (("h_tile", tps[i].h_tile), ("w_tile", tps[i].w_tile))
            for pipelined in (False, True):
                g, p = cw._launch_setup(
                    xs, (kh, kw, cg, k), int_path, int_path and not last,
                    sp.relu, sp.pool, pipelined, geo)
                out.append((f"{net}.{i} {'int8' if int_path else 'f32'}",
                            g, p))
    return out


@pytest.mark.parametrize("net", ["unet_small", "dilated_context"])
def test_zoo_heads_take_nk_and_nothing_reaches_the_scalar_kernel(net):
    """At 224×224, batch 8, every conv of the segmentation nets' int8
    programs and QAT forwards has a plan (none reaches the scalar
    kernel); the 3-class head's is an nk plan in int8 and f32, two slots
    of it under half an SM, at least two blocks an SM, and its window
    reads and tile writes each one shared-memory wavefront."""
    launches = _zoo_launches(net)
    assert all(p is not None for _, _, p in launches), [
        lb for lb, _, p in launches if p is None]
    heads = [(lb, g, p) for lb, g, p in launches if isinstance(p, NkPlan)]
    assert len(heads) == 4                      # int8 and f32, two wrappers
    for label, g, p in heads:
        assert (p.kh, p.kw, p.kgrp, p.groups) == (1, 1, 3, 1), label
        # two slots under half an SM: one chunk in int8; in f32
        # dilated_context's 16 channels take two chunks of 8
        assert 2 * p.slot_bytes <= cw.NK_HALF_SM, label
        assert p.n_chunks == (1 if g.int_path else p.cgrp // 8), label
        assert p.n_rect >= 2 * SMS, (label, p.n_rect)
        active = p.gr * p.rh * (p.rw // NK_SP)
        assert nk_read_ways(g.int_path, p.gr, p.rh, p.stride, p.pitch,
                            p.pps, p.cps, active) == 1
        assert nk_write_ways(p.gr, p.rh, p.kgrp, p.tpitch, active) == 1


def test_nk_thread_layout():
    """Groups fastest, then rectangle rows, then strip columns."""
    assert [nk_thread(t, 1, 32) for t in (0, 31, 32, 255)] == [
        (0, 0, 0), (0, 31, 0), (0, 0, 1), (0, 31, 7)]
    assert [nk_thread(t, 2, 16) for t in (0, 1, 2, 33)] == [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 0, 1)]


def test_nk_params_record_matches_cuda_struct():
    """The host packs ``NkParams`` by field order; the C struct in
    csrc/conv_common.cuh must list the same fields in the same order."""
    src = (CSRC / "conv_common.cuh").read_text()
    body = re.search(r"struct NkParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl.startswith("int "):
            names += [n.strip() for n in decl[4:].rstrip(";").split(",")]
    assert tuple(names) == NK_FIELDS
    assert re.search(rf"kNkSP = {NK_SP};", src)
    assert all(f"case {kp}: return LAUNCH" in src for kp in NK_KP)
    for lib in ("conv2d_ws", "conv2d_ws_pipe"):
        assert f"int {lib}_nk_launch(" in (CSRC / f"{lib}.cu").read_text()


def test_nk_emulation_refuses_other_paths():
    x, w, b, s, kw = tc_case_inputs("c4_k32")
    with pytest.raises(ValueError, match="tc path"):
        conv2d_ws_nk_emulate(*as_torch(x, w, b, s), **kw)
    x, w, b, s, kw = legal_banks(*case_inputs("depthwise_stride2"))
    with pytest.raises(ValueError, match="dw path"):
        conv2d_ws_nk_emulate(*as_torch(x, w, b, s), **kw)
    x, w, _, _, kw = _int8_case("unet_head")
    with pytest.raises(TypeError, match="int8 or float32"):
        conv2d_ws_nk_emulate(torch.from_numpy(x),
                             torch.from_numpy(w).float(), **kw)


def test_cpu_wrappers_count_no_nk_launch():
    x, w, b, s, kw = _int8_case("g4_c8_k3")
    counts = [(f.launches, f.nk_launches, f.scalar_launches)
              for f in (conv2d_ws, conv2d_ws_pipe)]
    for fn in (conv2d_ws, conv2d_ws_pipe):
        got = fn(*as_torch(x, w, b, s), **kw)
        assert torch.equal(got, ref.conv2d_epilogue_ref(
            *as_torch(x, w, b), **{k: v for k, v in kw.items()
                                   if k not in ("cin_banks", "kout_banks")},
            out_scale=torch.tensor(s)))
    assert [(f.launches, f.nk_launches, f.scalar_launches)
            for f in (conv2d_ws, conv2d_ws_pipe)] == counts
