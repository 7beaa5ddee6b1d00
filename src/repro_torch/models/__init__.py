"""LM assembly (counterpart of ``repro.models``): ``blocks`` and ``lm``."""
