"""The dry run (``launch.dryrun.count_cell``) builds every (architecture ×
shape) cell: each of the ten architectures at its reduced size, under
each of the four shapes that applies to it (the production shapes' kinds
and names at a reduced batch and length), on the (2, 4) fake mesh of
``test_torch_dryrun``, with the production cells' plans (FSDP and the
sequence-sharded residual stream for training, the decode plan's
``cache_seq`` over ``model``).  Each cell's step runs once under the
counter and counts FLOPs, traffic and argument bytes above zero; a
sharded train cell also counts collectives.  This is the CPU guard of
``python -m repro_torch.launch.dryrun --all``.
"""

import pytest

from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ShapeConfig,
                                      get_config, shape_applicable)
from repro_torch.launch import dryrun
from test_torch_dryrun import _reduced, mesh  # noqa: F401 - the fixture

# the production shapes at a reduced batch and length (the names kept:
# ``shape_applicable`` reads ``long_500k``'s); the prefill is longer than
# the reduced sliding window (64), so the hybrid's ring cache wraps, as
# at 32k positions
REDUCED_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 256, 1, "decode"),
}
CELLS = [(arch, shape) for arch in ARCH_NAMES for shape in SHAPES
         if shape_applicable(get_config(arch), SHAPES[shape])[0]]


def test_the_cells_are_the_production_ones():
    """64 runnable cells over two meshes and 16 skipped, as the
    reference's ``iter_cells`` counts them; the reduced shapes keep each
    production shape's kind."""
    cells = list(dryrun.iter_cells())
    assert len(cells) == 80
    assert sum(ok for *_, ok, _ in cells) == 64 == 2 * len(CELLS)
    assert {s: REDUCED_SHAPES[s].kind for s in SHAPES} == {
        s: v.kind for s, v in SHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_cell_is_built_and_counted(mesh, arch, shape):  # noqa: F811
    costs, out_bytes, peak, _, cell, cfg, shp, _, plan = dryrun.count_cell(
        arch, REDUCED_SHAPES[shape], "single", device="cpu", mesh=mesh,
        overrides=_reduced(arch))
    assert plan.mode == shp.kind == SHAPES[shape].kind
    assert costs.flops > 0 and costs.traffic > 0
    assert cell.argument_bytes > 0 and peak >= cell.argument_bytes
    if shp.kind == "train":
        assert plan.fsdp and costs.coll_wire > 0
