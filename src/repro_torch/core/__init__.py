"""Core of the port: quantization (with the QAT estimators), the §5.2
cycle model and its calibration (``calibration``; ``calibration_sweep``
fits a table from the card's kernel times), the tile planner and the
autotuner (``autotune``), ConvCore, the int8 network compiler, the
multi-core scheduler and the trainer (``training``: the float shadow of a
``NetworkPlan`` trained through the kernels' autograd Functions)."""

from repro_torch.core import training

__all__ = ["training"]
