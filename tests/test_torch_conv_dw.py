"""The depthwise conv path's host side against the JAX reference, on the CPU.

The dw kernels (``csrc/conv2d_ws.cu``, ``csrc/conv2d_ws_pipe.cu``: a
channel-vectorised direct conv for one input channel a group and under 8
outputs, int8 and f32) run only on the card.  What surrounds them is host
code the CPU reaches: the path rule (``conv_path``), the launch plan
(``dw_plan``: a rectangle of one image × a run of output channels
contiguous in NHWC, 4 channels × a 4-pixel strip a thread, padded row
pitches), the record the kernel reads (``DwParams``) and the copy widths
(``dw_params``).  ``conv2d_ws_dw_emulate`` replays the kernels' order of
sums (bias, then the taps in (dy, dx) order) in plain PyTorch and is held
here to the JAX package: int8 bit-exact and f32 within rtol = atol = 1e-4
of ``repro.kernels.ref.conv2d_epilogue_ref`` traced under one ``jax.jit``
a case, and int8 bit-exact to whole-map JAX ``conv2d_ws`` (Pallas in
interpret mode; tiled JAX ``conv2d_ws`` does not run under the installed
jax).  The same geometries run on the card in ``test_torch_cuda.py``."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import base
from repro_torch.kernels import conv2d_ws as cw
from repro_torch.kernels import ops, ref
from repro_torch.kernels.conv2d_ws import (DW_FIELDS, DW_SP, DW_V, SMEM_BYTES,
                                           SMS, THREADS, conv2d_ws,
                                           conv2d_ws_dw_emulate, conv_path,
                                           dw_params, dw_plan, dw_read_ways,
                                           dw_thread, dw_write_ways,
                                           setup_conv, simt_plan, tc_plan)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from test_torch_conv_tc import LAYERS, layer_inputs
from test_torch_cuda import (CASES, DW_CASES, TC_CASES, as_torch, case_inputs,
                             legal_banks, tc_case_inputs)

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _narrow_one_channel(w_shape, kw):
    return w_shape[2] == 1 and w_shape[3] // kw.get("groups", 1) < 8


def _int8_case(name):
    """(x, w, b, scale, kwargs) in int8 of a ``CASES``, ``DW_CASES``,
    ``TC_CASES`` or zoo ``LAYERS`` entry, banks legal."""
    if name in LAYERS:
        return legal_banks(*layer_inputs(name))
    if name in TC_CASES:
        return tc_case_inputs(name)
    table = CASES if name in CASES else DW_CASES
    return legal_banks(*case_inputs(name, table=table))


def _f32_case(name):
    """The same entry in f32, scaled as ``case_inputs(f32=True)`` scales
    (products and their sums exact in f32) → (x, w, b, kwargs)."""
    x, w, b, _, kw = _int8_case(name)
    return (np.asarray(x, np.float32) / 64, np.asarray(w, np.float32) / 64,
            np.asarray(b, np.float32) / 100, kw)


ALL = sorted({*CASES, *TC_CASES, *LAYERS, *DW_CASES})
DW = [n for n in ALL if _narrow_one_channel(_int8_case(n)[1].shape,
                                            _int8_case(n)[4])]


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


def test_dw_cases_cover_the_plan():
    """The emulated cases reach what ``DW_CASES`` names: the depthwise
    layers of ``CASES`` and of ``mobilenet_small``, a one-channel map with
    6 outputs, channel multipliers 2 and 4, dilation 2 with explicit
    asymmetric padding, the pool with per-channel requantization, K off
    the 4-channel vector, several channel runs, stride 2, both strip
    variants (3 wide in registers; 4 wide, stride 2 and dilation 2 tap by
    tap), and in f32 a run
    narrowed and a block with threads past its strips."""
    assert {"depthwise_stride2", "tiled_depthwise", "c1_k6",
            "mobilenet_small:d1", "mobilenet_small:d2",
            "mobilenet_small:d3"} <= set(DW)
    plans = [dw_plan(_geom(_int8_case(n)[0].shape, _int8_case(n)[1].shape,
                           _int8_case(n)[4])) for n in DW]
    assert {p.mult for p in plans} >= {1, 2, 4, 6}
    assert any(p.c == 1 and p.k == 6 for p in plans)
    assert any(p.dil == 2 and p.pt != p.pl for p in plans)
    assert any(p.pool for p in plans) and any(p.stride == 2 for p in plans)
    assert any(p.k % 4 for p in plans) and any(p.n_kc > 1 for p in plans)
    f32 = [dw_plan(_geom(_int8_case(n)[0].shape, _int8_case(n)[1].shape,
                         _int8_case(n)[4], int_path=False)) for n in DW]
    assert any(p.rh * (p.rw // DW_SP) * p.cv < THREADS for p in f32)
    assert any(p.kc < 128 and p.k % 128 == 0 for p in f32)
    assert any(p.stride == p.dil == 1 and p.kw == 3 for p in plans)
    assert any(p.stride == p.dil == 1 and p.kw == 4 for p in plans)
    assert any(p.stride > 1 or p.dil > 1 for p in plans)


@pytest.mark.parametrize("name", DW)
def test_dw_emulation_matches_jax(name):
    """int8 (int32 out and requantized) bit-equal to the JAX oracle, f32
    (f32 out and requantized) within 1e-4, for both wrappers' plans."""
    x, w, b, s, kw = _int8_case(name)
    assert conv_path(_geom(x.shape, w.shape, kw)) == "dw"
    fn = _jax_epilogue(tuple(sorted((k, _frozen(v)) for k, v in kw.items())))
    if s is None:
        s = np.full((w.shape[3],), 0.003, np.float32)
    tx, tw, tb, ts = as_torch(x, w, b, s)
    for scale, t_s in ((None, None), (s, ts)):
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             out_scale=None if scale is None
                             else jnp.asarray(scale)))
        for pipelined in (False, True):
            got = conv2d_ws_dw_emulate(tx, tw, tb, t_s, pipelined=pipelined,
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
        got = conv2d_ws_dw_emulate(tx, tw, tb, pipelined=pipelined, **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        got8 = conv2d_ws_dw_emulate(tx, tw, tb, ts, pipelined=pipelined,
                                    **kw)
        assert got8.dtype == torch.int8
        np.testing.assert_allclose(got8.numpy(), want8, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", DW)
def test_dw_emulation_bit_equal_to_whole_map_jax_conv(name):
    """int8 against whole-map JAX ``conv2d_ws`` (Pallas, interpret mode):
    the caller's tiles are dropped on the JAX side only."""
    x, w, b, s, kw = _int8_case(name)
    whole = {k: v for k, v in kw.items() if k not in ("h_tile", "w_tile")}
    want = np.asarray(jops.conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        out_scale=None if s is None else jnp.asarray(s), **whole))
    got = conv2d_ws_dw_emulate(*as_torch(x, w, b, s), **kw)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("int_path", [True, False])
@pytest.mark.parametrize("c,kout,groups,expect", [
    (32, 32, 32, "dw"),         # depthwise, K/g = 1
    (16, 32, 16, "dw"),         # channel multiplier 2
    (4, 28, 4, "dw"),           # K/g = 7
    (1, 6, 1, "dw"),            # one-channel map, 6 outputs
    (4, 32, 4, None),           # K/g = 8: the implicit GEMM
    (1, 8, 1, None),            # lenet conv0: the implicit GEMM
    (32, 32, 8, "nk"),          # C/g = 4, K/g = 4
    (8, 7, 1, "nk"),            # C/g = 8, K/g = 7
])
def test_path_rule(int_path, c, kout, groups, expect):
    g = setup_conv((2, 12, 12, c), (3, 3, c // groups, kout),
                   padding="SAME", groups=groups, cin_banks=1,
                   kout_banks=groups, int_path=int_path)
    expect = expect or ("tc" if int_path else "simt")
    assert conv_path(g) == expect
    assert (dw_plan(g) is None) == (expect != "dw")
    if expect == "dw":
        assert tc_plan(g) is None and simt_plan(g) is None


def _runs(g):
    """The channel runs a dw plan may take, in the order it tries them:
    least padding of K, then widest."""
    return sorted((kc for kc in (4, 8, 16, 32, 64, 128)
                   if kc <= (64 if g.int_path else 128)),
                  key=lambda kc: (-(-g.k // kc) * kc, -kc))


def _no_full_block(g, kc):
    """No rectangle of 256 / (kc / 4) strips at run ``kc`` fits two
    windows in shared memory."""
    pool = cw._pooled(g)
    oh, ow = (2 * g.poh, 2 * g.pow_) if pool else (g.poh, g.pow_)
    return cw._dw_rect(g, pool, oh, ow, kc, THREADS // (kc // DW_V)) is None


def _check_plan(p, g):
    """The invariants of one dw plan of geometry ``g``."""
    assert p.cv * DW_V == p.kc and p.kc in (4, 8, 16, 32, 64, 128)
    assert p.kc <= (64 if g.int_path else 128)
    # the threads that own a strip: all of the block's, unless no run's
    # window of that many strips fits twice in shared memory
    active = p.rh * (p.rw // DW_SP) * p.cv
    assert p.rw % DW_SP == 0 and THREADS % active == 0
    if active < THREADS:
        assert all(_no_full_block(g, kc) for kc in _runs(g))
    # the run: the first, by padding of K then width, whose window fits
    assert all(_no_full_block(g, kc) or active < THREADS
               for kc in _runs(g)[:_runs(g).index(p.kc)])
    # every output covered once: rectangles and channel runs
    assert (p.n_ry - 1) * p.rh < p.oh <= p.n_ry * p.rh
    assert (p.n_rx - 1) * p.rw < p.ow <= p.n_rx * p.rw
    assert (p.n_kc - 1) * p.kc < p.k <= p.n_kc * p.kc
    assert p.n_rect == p.n * p.n_ry * p.n_rx * p.n_kc
    assert p.mult * p.c == p.k
    if p.pool:
        assert p.rh % 2 == 0 and p.rw % 2 == 0
        assert (p.oh, p.ow) == (2 * p.poh, 2 * p.pow_)
    # the window of a rectangle, its row pitch and the tile's
    es = 1 if g.int_path else 4
    assert p.win_h == (p.rh - 1) * p.stride + (p.kh - 1) * p.dil + 1
    assert p.win_w == (p.rw - 1) * p.stride + (p.kw - 1) * p.dil + 1
    assert p.pitch >= p.win_w * p.kc and (p.pitch - p.win_w * p.kc) % 4 == 0
    assert p.tpitch >= p.rw * p.kc and p.tpitch % 4 == 0
    assert p.win_bytes % 16 == 0 and p.win_bytes >= p.win_h * p.pitch * es
    w_bytes = -(-p.kh * p.kw * p.kc * es // 16) * 16
    assert p.slot_bytes % 16 == 0
    assert p.slot_bytes >= max(p.win_bytes + w_bytes, p.rh * p.tpitch * 4)
    assert p.smem == p.slots * p.slot_bytes <= SMEM_BYTES
    assert 2 * p.slot_bytes <= SMEM_BYTES
    # the copy widths divide the run and every offset it starts at
    x = torch.zeros((p.n, p.h, p.w, p.c),
                    dtype=torch.int8 if g.int_path else torch.float32)
    w = torch.zeros((p.kh, p.kw, 1, p.k), dtype=x.dtype)
    out = torch.zeros((p.n, p.poh, p.pow_, p.k), dtype=torch.int32)
    rec = list(dw_params(p, x, w, out))
    xvec, wvec, ovec = rec[-3:]
    assert rec[:-3] == list(p) and len(rec) == len(DW_FIELDS)
    if p.mult > 1:
        assert xvec == 0
    if not g.int_path:      # f32 copies 4 bytes at least: one element
        assert wvec and (xvec or p.mult > 1)
    for vec, row in ((xvec, p.c * es), (wvec, p.k * es)):
        assert vec in (0, 4, 8, 16)
        if vec:
            assert (p.kc * es) % vec == 0 and row % vec == 0
    if xvec:
        assert (p.pitch * es) % xvec == 0
    assert ovec == (4 if p.k % 4 == 0 else 1)


@pytest.mark.parametrize("name", ALL)
def test_dw_plan_invariants(name):
    x, w, _, _, kw = _int8_case(name)
    for int_path in (True, False):
        g = _geom(x.shape, w.shape, kw, int_path=int_path)
        seq = dw_plan(g, kw.get("relu", False), False)
        if not _narrow_one_channel(w.shape, kw):
            assert seq is None and conv_path(g) != "dw"
            continue
        pipe = dw_plan(g, kw.get("relu", False), True)
        assert seq._replace(slots=0, smem=0) == pipe._replace(slots=0,
                                                              smem=0)
        assert (seq.slots, pipe.slots) == (1, 2)
        for p in (seq, pipe):
            _check_plan(p, g)
        # the same plan for any tiles and banks the caller asks for
        geo = {k: v for k, v in kw.items()
               if k not in ("h_tile", "w_tile", "cin_banks", "kout_banks")}
        groups = kw.get("groups", 1)
        for tiles in ((0, 0), (2, 2), (4, 6)):
            for cin, kout in ((1, groups), (1, w.shape[3])):
                try:
                    other = _geom(x.shape, w.shape, dict(
                        geo, h_tile=tiles[0], w_tile=tiles[1],
                        cin_banks=cin, kout_banks=kout), int_path=int_path)
                except ValueError:      # a banking this layer cannot take
                    continue
                for pipelined in (False, True):
                    assert dw_plan(other, kw.get("relu", False),
                                   pipelined) == (pipe if pipelined else seq)


def _main_path_geometries():
    """The dw launches of the main paths: ``mobilenet_small``'s three
    depthwise layers at 224 and batch 8 in int8 (as served) and f32, and
    ``ops.conv1d_depthwise`` at recurrentgemma-9b's width, 4096 positions
    → {label: ConvGeom}."""
    out = {}
    for label, (hw, c, stride) in {"d1": (224, 8, 1), "d2": (224, 16, 2),
                                   "d3": (112, 32, 1)}.items():
        for int_path in (True, False):
            out[f"mobilenet_small {label} "
                f"{'int8' if int_path else 'f32'}"] = setup_conv(
                (8, hw, hw, c), (3, 3, 1, c), stride=stride, padding="SAME",
                groups=c, cin_banks=1, kout_banks=c, requant=int_path,
                int_path=int_path)
    width = base.get_config("recurrentgemma_9b").rnn_width
    out["conv1d 4096"] = setup_conv(
        (1, 1, 4096, width), (1, 4, 1, width), padding=((0, 0), (3, 0)),
        groups=width, cin_banks=1, kout_banks=width, int_path=False)
    return out


@pytest.mark.parametrize("label", sorted(_main_path_geometries()))
def test_main_path_dw_plans_fill_the_card_without_bank_conflicts(label):
    """Each main-path dw launch brings at least two blocks an SM, and a
    warp's window reads and tile writes each take one shared-memory
    wavefront (conflict-free), for both wrappers."""
    g = _main_path_geometries()[label]
    assert conv_path(g) == "dw"
    for pipelined in (False, True):
        p = dw_plan(g, True, pipelined)
        _check_plan(p, g)
        assert p.n_rect >= 2 * SMS, (label, p.n_rect)
        assert dw_read_ways(g.int_path, p.cv, p.rh, p.stride, p.kc,
                            p.pitch) == 1
        assert dw_write_ways(p.cv, p.rh, p.kc, p.tpitch) == 1


@pytest.mark.parametrize("int_path", [True, False])
@pytest.mark.parametrize("xs,ws,kw", [
    ((8, 56, 56, 256), (3, 3, 1, 256), dict(padding="SAME", dilation=8)),
    ((8, 112, 112, 256), (7, 7, 1, 256), dict(stride=2, padding="SAME")),
    ((8, 112, 112, 96), (5, 5, 1, 96), dict(stride=3, padding="SAME")),
    ((8, 224, 224, 1), (11, 11, 1, 6), dict(stride=4)),
    ((4, 64, 64, 512), (3, 3, 1, 1024), dict(padding="SAME", dilation=16,
                                             pool=True)),
], ids=["3x3_dilation8", "7x7_stride2", "5x5_stride3", "c1_11x11_stride4",
        "mult2_dilation16_pool"])
def test_wide_windows_take_dw(int_path, xs, ws, kw):
    """Layers whose window at the widest run overflows shared memory still
    take the dw path, for both wrappers: the plan narrows the run, then
    leaves threads without a strip, and stays within every invariant."""
    geo = {k: v for k, v in kw.items() if k != "pool"}
    g = setup_conv(xs, ws, groups=xs[3], cin_banks=1, kout_banks=xs[3],
                   pool=kw.get("pool", False), int_path=int_path, **geo)
    assert conv_path(g) == "dw"
    for pipelined in (False, True):
        p = dw_plan(g, True, pipelined)
        _check_plan(p, g)
        assert p.slots == 1 + pipelined


def test_conv1d_plan_is_one_row_of_strips():
    """recurrentgemma-9b's conv, [1, 4096, 4096] f32 with K = 4: runs of
    128 channels (a warp reads 512 contiguous bytes of a pixel), a
    rectangle of one row of 32 pixels, 4096 blocks."""
    p = dw_plan(_main_path_geometries()["conv1d 4096"])
    assert (p.kc, p.cv, p.rh, p.rw, p.n_kc, p.n_rect) == (128, 32, 1, 32, 32,
                                                          4096)
    assert [dw_thread(t, p.cv, p.rh) for t in (0, 31, 32, 255)] == [
        (0, 0, 0), (31, 0, 0), (0, 0, 1), (31, 0, 7)]


def test_dw_params_record_matches_cuda_struct():
    """The host packs ``DwParams`` by field order; the C struct in
    csrc/conv_common.cuh must list the same fields in the same order."""
    src = (CSRC / "conv_common.cuh").read_text()
    body = re.search(r"struct DwParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl.startswith("int "):
            names += [n.strip() for n in decl[4:].rstrip(";").split(",")]
    assert tuple(names) == DW_FIELDS
    assert re.search(rf"kDwV = {DW_V};", src)
    assert re.search(rf"kDwSP = {DW_SP};", src)
    for lib in ("conv2d_ws", "conv2d_ws_pipe"):
        assert f"int {lib}_dw_launch(" in (CSRC / f"{lib}.cu").read_text()


def test_conv1d_depthwise_through_the_emulation_matches_jax(monkeypatch):
    """``ops.conv1d_depthwise`` at [2, 64, 48], K = 4, with the CPU
    wrapper's plain version swapped for the dw emulation: one call, on the
    dw plan, within 1e-4 of ``repro.kernels.ops.conv1d_depthwise``
    (Pallas, interpret mode)."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 64, 48)).astype(np.float32)
    w = (rng.normal(size=(4, 48)) / 2).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    calls = []

    def emulated(*args, **kw):
        calls.append(kw)
        return conv2d_ws_dw_emulate(*args, **kw)

    monkeypatch.setattr(cw, "conv2d_ws_plain", emulated)
    got = ops.conv1d_depthwise(*map(torch.from_numpy, (x, w, b)))
    assert len(calls) == 1 and calls[0]["groups"] == 48
    want = np.asarray(jops.conv1d_depthwise(*map(jnp.asarray, (x, w, b))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_dw_emulation_refuses_other_paths():
    x, w, b, s, kw = tc_case_inputs("c4_k32")
    with pytest.raises(ValueError, match="tc path"):
        conv2d_ws_dw_emulate(*as_torch(x, w, b, s), **kw)
    x, w, b, s, kw = legal_banks(*case_inputs("groups2"))
    with pytest.raises(ValueError, match="nk path"):
        conv2d_ws_dw_emulate(*as_torch(x, w, b, s), **kw)
    g = setup_conv((2, 12, 12, 32), (3, 3, 4, 32), padding="SAME", groups=8,
                   cin_banks=1, kout_banks=8)
    assert conv_path(g) == "nk" and dw_plan(g) is None
    x, w, _, _, kw = _int8_case("c1_k6")
    with pytest.raises(TypeError, match="int8 or float32"):
        conv2d_ws_dw_emulate(torch.from_numpy(x),
                             torch.from_numpy(w).float(), **kw)


def test_cpu_wrappers_count_no_dw_launch():
    x, w, b, s, kw = _int8_case("depthwise_stride2")
    counts = [(f.launches, f.dw_launches) for f in (conv2d_ws,
                                                    conv2d_ws_pipe)]
    for fn in (conv2d_ws, conv2d_ws_pipe):
        got = fn(*as_torch(x, w, b, s), **kw)
        assert torch.equal(got, ref.conv2d_epilogue_ref(
            *as_torch(x, w, b), **{k: v for k, v in kw.items()
                                   if k not in ("cin_banks", "kout_banks")},
            out_scale=torch.tensor(s)))
    assert [(f.launches, f.dw_launches)
            for f in (conv2d_ws, conv2d_ws_pipe)] == counts
