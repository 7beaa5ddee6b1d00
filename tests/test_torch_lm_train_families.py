"""One train step of the other LM families against the JAX reference on
the CPU: the reduced recurrentgemma-9b (RG-LRU + local attention),
rwkv6-1.6b (attention-free), deepseek-moe-16b (its aux loss in the total),
internvl2-26b (8 patches before the tokens; the loss on the text only)
and seamless-m4t-medium (16 frames through the encoder).  Each in f32
from the reference's materialized state: the loss, the metrics, every
gradient and every updated param, m and v within rtol = atol = 1e-4
(``test_torch_lm_train_step.check_step``)."""

import pytest

from test_torch_lm_train_step import batch_for, check_step, configs

FAMILIES = {
    "recurrentgemma_9b": None,
    "rwkv6_1p6b": None,
    "deepseek_moe_16b": None,
    "internvl2_26b": ("patches", 8),
    "seamless_m4t_medium": ("frames", 16),
}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_one_step_equals_the_reference(arch):
    jcfg, cfg = configs(arch)
    extra = FAMILIES[arch]
    batch = batch_for(cfg, extra=None if extra is None else {
        extra[0]: (extra[1], cfg.frontend_dim)})
    m = check_step(jcfg, cfg, batch)
    if cfg.moe is not None:
        assert float(m["aux_loss"]) > 0.0
        assert float(m["total_loss"]) > float(m["loss"])
