"""Architecture configurations (counterpart of ``repro.configs``); see
``base`` for ``ArchConfig``, ``get_config`` and ``reduce_config``."""
