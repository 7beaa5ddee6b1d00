"""LM layers (counterpart of ``repro.layers``): specs, norms, RoPE,
embeddings, the gated MLP and attention, as plain functions over dicts of
tensors."""
