"""The f32 simt conv path's host side against the JAX reference, on the CPU.

The simt kernels (``csrc/conv2d_ws.cu``, ``csrc/conv2d_ws_pipe.cu``: an
implicit GEMM on register-tiled FFMA, f32 operands with K/groups ≥ 8) run
only on the card.  What surrounds them is host code the CPU reaches: the
path rule (``conv_path``), the launch plan (``simt_plan``: pool-aligned
rectangles of one image sized by the N-tile, K-chunks of ``cs`` channels ×
every tap, a K split where the tiles are few, the ring depth), the record
the kernel reads (``SimtParams``) and the window address arithmetic
(``simt_windows``).  ``conv2d_ws_simt_emulate`` replays the plan's order of
sums in plain PyTorch (bias first, K-chunks in order, a split's partials in
slice order) and is held here within rtol = atol = 1e-4 of the JAX
package's ``repro.kernels.ref.conv2d_epilogue_ref`` (f32 → f32 and f32 →
int8), traced under one ``jax.jit`` per case.  The same geometries run on
the card in ``test_torch_cuda.py``."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import (SIMT_FIELDS, SMEM_BYTES, SMS,
                                           THREADS, conv2d_ws,
                                           conv2d_ws_simt_emulate, conv_path,
                                           setup_conv, simt_blocks_per_sm,
                                           simt_plan, simt_windows, tc_plan)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.conv2d_ws_trans import transpose_eq_conv_geometry
from test_torch_conv_tc import LAYERS, layer_inputs
from test_torch_cuda import (CASES, TC_CASES, as_torch, f32_case,
                             legal_banks, tc_case_inputs)
from test_torch_grad import _zoo_f32_geometries

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _f32(x, w, b):
    """Int8 operands as f32, scaled as ``f32_case`` scales them: products
    and their sums exact in f32."""
    return (np.asarray(x, np.float32) / 64, np.asarray(w, np.float32) / 64,
            np.asarray(b, np.float32) / 100)


# a layer whose tiles fill the card without a K split (two chunks): the
# small cases above all split K
WIDE = {"wide_two_chunks_pool": ((4, 192, 192, 16), (3, 3, 16, 32), dict(
    padding="SAME", relu=True, pool=True))}


def _case(name):
    """(x, w, b, kwargs) in f32 of a ``CASES``, ``TC_CASES``, zoo
    ``LAYERS`` or ``WIDE`` entry."""
    if name in WIDE:
        xs, ws, kw = WIDE[name]
        rng = np.random.default_rng(sum(map(ord, name)))
        return (*_f32(rng.integers(-128, 128, xs),
                      rng.integers(-128, 128, ws),
                      rng.integers(-4000, 4000, ws[3:])), dict(kw))
    if name in LAYERS:
        x, w, b, _, kw = legal_banks(*layer_inputs(name))
        return (*_f32(x, w, b), kw)
    return f32_case(name)


ALL = sorted({*CASES, *TC_CASES, *LAYERS, *WIDE})


def _geom(x_shape, w_shape, kw, requant=False):
    geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
    return setup_conv(tuple(x_shape), tuple(w_shape),
                      pool=kw.get("pool", False), requant=requant,
                      int_path=False, **geo)


def _kgrp(w_shape, kw):
    return w_shape[3] // kw.get("groups", 1)


SIMT = [n for n in ALL if _kgrp(_case(n)[1].shape, _case(n)[3]) >= 8]


@functools.lru_cache(maxsize=None)
def _jax_epilogue(kw_items):
    """``conv2d_epilogue_ref`` with the case's static arguments, under one
    ``jax.jit``."""
    kw = dict(kw_items)
    geo = {k: kw[k] for k in ("stride", "padding", "relu", "pool", "groups",
                              "dilation") if k in kw}
    return jax.jit(functools.partial(jref.conv2d_epilogue_ref, **geo))


def _frozen(v):
    return tuple(map(_frozen, v)) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("name", SIMT)
def test_simt_emulation_matches_jax(name):
    x, w, b, kw = _case(name)
    assert conv_path(_geom(x.shape, w.shape, kw)) == "simt"
    fn = _jax_epilogue(tuple(sorted((k, _frozen(v)) for k, v in kw.items())))
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # f32 → int8 at per-channel scales that spread each channel over the grid
    scale = (100.0 / np.maximum(np.abs(want).reshape(-1, want.shape[-1])
                                .max(0), 1e-3)).astype(np.float32)
    want8 = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          out_scale=jnp.asarray(scale)))
    tx, tw, tb, ts = as_torch(x, w, b, scale)
    for pipelined in (False, True):
        got = conv2d_ws_simt_emulate(tx, tw, tb, pipelined=pipelined, **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        got8 = conv2d_ws_simt_emulate(tx, tw, tb, ts, pipelined=pipelined,
                                      **kw)
        assert got8.dtype == torch.int8
        np.testing.assert_allclose(got8.numpy(), want8, rtol=1e-4,
                                   atol=1e-4)


def test_simt_cases_cover_the_plan():
    """The emulated cases reach every N-tile width, a K split, several
    chunks, stride 2, dilation 2, groups and the pool."""
    plans = {n: simt_plan(_geom(_case(n)[0].shape, _case(n)[1].shape,
                                _case(n)[3]), _case(n)[3].get("relu", False))
             for n in SIMT}
    assert {p.bn for p in plans.values()} == {32, 64, 128}
    assert any(p.split > 1 for p in plans.values())
    assert any(p.split == 1 and p.n_chunks > 1 for p in plans.values())
    assert any(p.stride == 2 for p in plans.values())
    assert any(p.dil == 2 for p in plans.values())
    assert any(p.pool for p in plans.values())
    assert any(p.c // p.cgrp > 1 for p in plans.values())


@pytest.mark.parametrize("name", ALL)
def test_simt_plan_invariants(name):
    x, w, _, kw = _case(name)
    g = _geom(x.shape, w.shape, kw)
    seq = simt_plan(g, kw.get("relu", False), False)
    if _kgrp(w.shape, kw) < 8:      # one input channel a group: dw
        assert seq is None
        assert conv_path(g) == ("dw" if w.shape[2] == 1 else "nk")
        return
    pipe = simt_plan(g, kw.get("relu", False), True)
    assert seq._replace(stages=0, slots=0, smem=0) == \
        pipe._replace(stages=0, slots=0, smem=0)
    # every output covered once: rectangles, N-tiles and K slices
    bm = seq.rh * seq.rw
    assert bm * seq.bn == THREADS * 8 * 8 and seq.bn in (32, 64, 128)
    assert (seq.n_ry - 1) * seq.rh < seq.oh <= seq.n_ry * seq.rh
    assert (seq.n_rx - 1) * seq.rw < seq.ow <= seq.n_rx * seq.rw
    assert (seq.n_nt - 1) * seq.bn < seq.kgrp <= seq.n_nt * seq.bn
    assert seq.n_chunks * seq.cs == seq.cgrp
    assert (seq.split - 1) * seq.kcs < seq.n_chunks <= seq.split * seq.kcs
    if seq.pool:
        assert seq.rh % 2 == 0 and seq.rw % 2 == 0
        assert (seq.oh, seq.ow) == (2 * seq.poh, 2 * seq.pow_)
    # a warp's pixels of one load lie in one rectangle row
    assert seq.rw >= 32 // (seq.bn // 8)
    assert seq.ps % 2 == 1 and seq.ps >= seq.cs
    assert seq.win_floats % 4 == 0 and seq.win_floats >= \
        seq.win_h * seq.win_w * seq.ps
    assert seq.slot_floats == seq.win_floats + seq.taps * seq.cs * seq.bn
    bases, offs = simt_windows(seq)
    assert int(bases.max() + offs.max()) + seq.cs <= \
        seq.win_h * seq.win_w * seq.ps
    # shared memory, and the ring keeps conv2d_ws's blocks per SM
    assert seq.stages == seq.slots == 1 and seq.smem <= SMEM_BYTES
    assert 1 <= pipe.stages <= 4 and pipe.slots == min(pipe.stages, pipe.kcs)
    assert pipe.smem <= SMEM_BYTES
    assert simt_blocks_per_sm(pipe.smem) == simt_blocks_per_sm(seq.smem)
    # the same plan for any tiles and banks the caller asks for
    geo = {k: v for k, v in kw.items()
           if k not in ("h_tile", "w_tile", "cin_banks", "kout_banks")}
    for tiles in ((0, 0), (2, 2), (4, 6)):
        for cin, kout in ((1, kw.get("groups", 1)),
                          (kw.get("cin_banks", 4), kw.get("kout_banks", 4))):
            try:
                other = _geom(x.shape, w.shape, dict(
                    geo, h_tile=tiles[0], w_tile=tiles[1],
                    cin_banks=cin, kout_banks=kout))
            except ValueError:          # a banking this layer cannot take
                continue
            for pipelined in (False, True):
                assert simt_plan(other, kw.get("relu", False),
                                 pipelined) == (pipe if pipelined else seq)


@pytest.mark.parametrize("name", SIMT)
def test_simt_window_reads_are_conflict_free(name):
    """Each load of a warp reads one float a pixel of the window slab: its
    distinct pixels sit on distinct shared-memory banks (odd ``ps``, the
    pixels consecutive in one row), at stride 1 and 2 and under
    dilation (the tap offset is the same for the whole warp)."""
    x, w, _, kw = _case(name)
    p = simt_plan(_geom(x.shape, w.shape, kw))
    bases, _ = simt_windows(p)
    ct = p.bn // 8
    rt = THREADS // ct
    for warp in range(THREADS // 32):
        ty = torch.arange(32 * warp, 32 * warp + 32) // ct
        for i in range(8):
            words = bases[ty + rt * i].unique()
            assert len((words % 32).unique()) == len(words), (warp, i)


def test_simt_conflict_free_cases_reach_stride_and_dilation():
    plans = [simt_plan(_geom(_case(n)[0].shape, _case(n)[1].shape,
                             _case(n)[3])) for n in SIMT]
    assert {(p.stride, p.dil) for p in plans} >= {(1, 1), (2, 1), (1, 2),
                                                  (2, 2)}


def test_vgg_imagenet_and_unet_small_f32_convs_take_simt_and_fill_the_card():
    """At 224×224 and batch 8 every f32 conv of a ``vgg_imagenet`` and a
    ``unet_small`` training step, forward and input gradient (the
    transposed convs' stride-1 lowering), takes the simt path where its
    groups are 8 or more outputs wide (all but ``unet_small``'s 3-class
    head, which takes the nk path); each
    ``vgg_imagenet`` conv brings at least one block an SM, splitting K
    only where its tiles alone are fewer, and no K split's partial buffer
    appears at the 224×224 maps (M = 401,408)."""
    # the network input takes no gradient: layer 0's dx is never launched
    geoms = [(lb, g) for lb, g in _zoo_f32_geometries()
             if not lb.endswith(".0 dx")]
    vgg = [(lb, g) for lb, g in geoms if lb.startswith("vgg_imagenet")]
    assert len(vgg) == 11                   # six forward, five dx
    for label, g in geoms:
        wide = g.k // (g.c // g.cgrp) >= 8     # unet_small's 3-class head
        assert conv_path(g) == ("simt" if wide else "nk"), label
        assert tc_plan(g) is None
    assert all(conv_path(g) == "simt" for _, g in vgg)
    for label, g in vgg:
        p = simt_plan(g)
        tiles = p.n * p.n_ry * p.n_rx * (p.k // p.kgrp) * p.n_nt
        assert tiles * p.split >= SMS, (label, tiles, p.split)
        assert (p.split > 1) == (tiles < SMS), label
        if p.n * p.oh * p.ow >= 401_408:
            assert p.split == 1, label


@pytest.mark.parametrize("kout,groups,expect", [
    (7, 1, "nk"),               # K/g = 7
    (8, 1, "simt"),             # K/g = 8
    (64, 1, "simt"),
    (32, 4, "simt"),            # K/g = 8
    (32, 8, "nk"),              # K/g = 4
    (32, 32, "dw"),             # depthwise
])
def test_path_rule_f32(kout, groups, expect):
    g = setup_conv((2, 12, 12, 32), (3, 3, 32 // groups, kout),
                   padding="SAME", groups=groups, cin_banks=1,
                   kout_banks=groups, int_path=False)
    assert conv_path(g) == expect
    assert tc_plan(g) is None
    assert (simt_plan(g) is None) == (expect != "simt")


def test_simt_params_record_matches_cuda_struct():
    """The host packs ``SimtParams`` by field order; the C struct in
    csrc/conv_common.cuh must list the same fields in the same order."""
    src = (CSRC / "conv_common.cuh").read_text()
    body = re.search(r"struct SimtParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl.startswith("int "):
            names += [n.strip() for n in decl[4:].rstrip(";").split(",")]
    assert tuple(names) == SIMT_FIELDS
    assert re.search(r"kSimtTM = 8, kSimtTN = 8;", src)
    assert re.search(r"kSimtTilePad = 4;", src)


def test_simt_emulation_refuses_other_paths():
    x, w, b, s, kw = tc_case_inputs("c4_k32")
    with pytest.raises(TypeError, match="float32"):
        conv2d_ws_simt_emulate(*as_torch(x, w, b, s), **kw)
    x, w, b, kw = _case("depthwise_stride2")
    with pytest.raises(ValueError, match="dw path"):
        conv2d_ws_simt_emulate(*as_torch(x, w, b), **kw)


def test_cpu_wrappers_count_no_simt_launch():
    x, w, b, kw = _case("c4_k32")
    before = [(f.launches, f.simt_launches) for f in (conv2d_ws,
                                                      conv2d_ws_pipe)]
    for fn in (conv2d_ws, conv2d_ws_pipe):
        got = fn(*as_torch(x, w, b), **kw)
        torch.testing.assert_close(
            got, ref.conv2d_epilogue_ref(*as_torch(x, w, b), **kw),
            rtol=1e-4, atol=1e-4)
    assert [(f.launches, f.simt_launches)
            for f in (conv2d_ws, conv2d_ws_pipe)] == before
