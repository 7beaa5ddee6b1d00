"""The LM train step and trainer (counterpart of ``repro.train``)."""
