"""Every LM family beyond the dense decoders sharded on gloo ranks on the
CPU, held to its own unsharded steps.

One spawn of 8 ranks (a (2, 4) ``(data, model)`` mesh) runs
``torch_dist_checks.family_scenarios`` for each family at its reduced
size: recurrentgemma-9b, rwkv6-1.6b (16-wide heads, so that ``model``
splits its 4 heads), deepseek-moe-16b and qwen3-moe-30b-a3b (8 experts,
2 a rank), internvl2-26b (8 patches before 16 tokens) and
seamless-m4t-medium (16 frames).  Each family's plan is the dry run's:
FSDP for training, the residual stream sequence-sharded where every
block attends.  Held:

* the prefill's logits (batch 4 × 16) and cache within 1e-5 (the
  hybrid's 12-position window wraps its ring cache);
* two decode steps after a 12-token prefill into a 32-position cache:
  the logits within 1e-5, every cache leaf within 1e-5;
* one train step on ``xla`` and on ``pallas_ws`` (``matmul_ws_plain`` on
  the CPU): the loss within the reference test's 2e-4, the aux loss
  within 1e-6, every gradient within ``GRAD_REL`` relative L2 and
  params, m and v within 1e-4 by ``hold_step``'s near-zero rule;
* an MoE family's layer under router jitter (0.1, ``train=True``): each
  rank's rows of the unsharded draw, so the output and the aux loss
  equal the unsharded layer's within 1e-5.

The reference's own sharded steps fail under jax 0.9 (its vocab-sharded
embedding gather; ``tests/test_sharding.py``), so the sharded port is
held to its unsharded self, as the reference's test holds its own
sharded step; each family's unsharded step is held to the reference in
``test_torch_lm_train_families.py``, ``test_torch_moe.py``,
``test_torch_rwkv.py`` and ``test_torch_encdec_vlm.py``.
"""

import pytest
import torch

import torch_dist_checks as dc
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

WORLD = 8
# as test_torch_distributed.GRAD_REL: each contraction sums its terms in
# another order on each rank and across them; a skipped or doubled
# reduction moves a leaf by O(1)
GRAD_REL = 2e-4


@pytest.fixture(scope="module")
def world():
    """Every family's readings from one spawn of 8 gloo ranks."""
    out, backend = dc.spawn_ranks(dc.family_scenarios, WORLD, dc.FAMILIES,
                                  device="cpu", timeout_s=600)
    assert backend == "gloo"
    return out


def _got(world, arch, check):
    got = world[arch][check]
    if isinstance(got, str):
        pytest.fail(f"{arch} {check} raised on the ranks:\n{got}")
    return got


def _params(arch):
    cfg = dc.family_cfg(arch)
    return cfg, dc.draw_state(cfg, 2, "cpu")[0]


@pytest.mark.parametrize("arch", dc.FAMILIES)
def test_sharded_prefill_matches_unsharded(world, arch):
    got, cache = _got(world, arch, "prefill")
    cfg, state = _params(arch)
    batch = dc.family_batch(cfg, dc.FAMILY_BATCH, dc.FAMILY_SEQ, 9,
                            labels=False)
    with torch.no_grad():
        want, want_cache = lm.prefill(state["params"], batch, cfg)
    assert got.shape == (dc.FAMILY_BATCH, cfg.vocab_size)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got_leaves, want_leaves = tree_leaves(cache), tree_leaves(want_cache)
    assert len(got_leaves) == len(want_leaves)
    for a, w in zip(got_leaves, want_leaves):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", dc.FAMILIES)
def test_sharded_decode_matches_unsharded(world, arch):
    logits, cache = _got(world, arch, "decode")
    cfg, state = _params(arch)
    c0, tokens, pos = dc.family_cache(state["params"], cfg)
    want, want_cache = dc.plain_decode(state["params"], c0, cfg, tokens,
                                       pos, 2)
    assert len(logits) == 2
    for a, w in zip(logits, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    got_leaves, want_leaves = tree_leaves(cache), tree_leaves(want_cache)
    assert len(got_leaves) == len(want_leaves)
    for a, w in zip(got_leaves, want_leaves):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas_ws"])
@pytest.mark.parametrize("arch", dc.FAMILIES)
def test_sharded_train_step_matches_unsharded(world, arch, backend):
    got = _got(world, arch, f"train_{backend}")
    cfg = dc.family_cfg(arch, backend)
    state = dc.draw_state(cfg, 2, "cpu")[0]
    batch = dc.family_batch(cfg, dc.FAMILY_BATCH, dc.FAMILY_SEQ, 11)
    want = dc.plain_step(state, batch, cfg, AdamWConfig(**dc.STEP_HP))
    print(arch, backend, dc.hold_step(got, want, grad_rel=GRAD_REL))
    assert abs(got[0]["aux_loss"] - want[0]["aux_loss"]) <= 1e-6
    if cfg.moe is not None:
        assert want[0]["aux_loss"] > 0


@pytest.mark.parametrize("arch", [a for a in dc.FAMILIES if "moe" in a])
def test_sharded_moe_jitter_draws_the_unsharded_noise(world, arch):
    y, aux = _got(world, arch, "jitter")
    cfg, state = _params(arch)
    x = dc.jitter_input(cfg)
    want_y, want_aux = dc.moe_jitter(state["params"], cfg, x)
    plain_y, _ = dc.moe_jitter(state["params"], cfg, x, jitter=0.0)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=1e-6)
    # the jitter moves some token's routing
    assert not torch.allclose(want_y, plain_y, rtol=1e-5, atol=1e-5)
