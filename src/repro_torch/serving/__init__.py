"""Serving: the LM ``ServingEngine`` (with ``serve_step``), the int8
conv-net ``ContinuousBatchingEngine`` (``batching``) and its single-model
facade ``ConvNetEngine``."""
