"""The port's synchronous ``ConvNetEngine`` and its device resolution."""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.device import resolve_device
from repro_torch.serving.engine import ConvNetEngine


def _lenet_qnet(seed=0):
    rng = np.random.default_rng(seed)
    plan = network.lenet()
    params = plan.init_params(rng, device="cpu")
    calib = torch.from_numpy(rng.normal(size=(8, *plan.input_shape))
                             .astype(np.float32))
    return network.quantize_network(plan, params, calib), rng


def test_engine_serves_in_request_order_and_pads_the_last_batch():
    qnet, rng = _lenet_qnet()
    images = rng.normal(size=(11, *qnet.plan.input_shape)).astype(np.float32)
    engine = ConvNetEngine(qnet, batch=4, device="cpu")
    got = engine.submit(images)
    want = network.make_int8_program(qnet, ConvCoreConfig(int8=True))(
        torch.from_numpy(images)).numpy()
    assert got.shape == (11, 10) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert engine.stats == {"requests": 11, "batches": 3, "padded": 1}
    # a list of [H, W, C] images is one request each
    one = engine.submit([images[5], images[2]])
    np.testing.assert_array_equal(one, want[[5, 2]])
    assert engine.stats == {"requests": 13, "batches": 4, "padded": 3}


def test_engine_rejects_wrong_shapes():
    qnet, _ = _lenet_qnet()
    engine = ConvNetEngine(qnet, batch=2, device="cpu")
    with pytest.raises(ValueError, match="expected images of shape"):
        engine.submit(np.zeros((3, 28, 28, 3), np.float32))
    with pytest.raises(ValueError, match="batch must be"):
        ConvNetEngine(qnet, batch=0, device="cpu")


def test_default_device_is_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    qnet, _ = _lenet_qnet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConvNetEngine(qnet)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network.lenet().init_params(np.random.default_rng(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_convert_carries_float_params():
    plan = network.lenet()
    params = plan.init_params(np.random.default_rng(1), device="cpu")
    arrays = [None if p is None else {k: v.numpy() for k, v in p.items()}
              for p in params]
    back = convert.params_to_torch(arrays, device="cpu")
    for a, b in zip(params, back):
        assert (a is None) == (b is None)
        if a is not None:
            assert all(torch.equal(a[k], b[k]) for k in ("w", "b"))
    with pytest.raises(ValueError, match="one entry per node"):
        convert.quantized_network(plan, weights=[None], biases=[None],
                                  requants=[None], in_scale=1.0,
                                  out_dequant=1.0, device="cpu")
