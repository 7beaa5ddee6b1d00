"""End to end on the graph nets: the port's int8 program against the JAX
program for the residual (``resnet_small``, ``resnet_bottleneck``),
depthwise-separable (``mobilenet_small``) and inverted-residual
(``mobilenet_v2ish``) zoo nets, through shared-grid int8 adds and grouped
convs.  The check is ``test_torch_program.check_logits_bit_equal``; the
nets sit in their own file so the slow Pallas interpret runs spread over
test workers."""

import pytest

from test_torch_program import check_logits_bit_equal


@pytest.mark.parametrize("net", ["mobilenet_small", "resnet_small",
                                 "mobilenet_v2ish", "resnet_bottleneck"])
def test_int8_logits_bit_equal_to_reference(net):
    check_logits_bit_equal(net)
