"""Serving: the LM ``ServingEngine`` (with ``serve_step``) and the
int8 conv-net ``ConvNetEngine``."""
