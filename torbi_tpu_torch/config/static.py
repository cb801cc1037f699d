"""Configuration values derived from the constants.

Counterpart of ``torbi_tpu/config/static.py``, whose values depend on
constants an override file may replace. The file path and the CLI derive
none: the JAX package's one derived value, ``PARTITION_DIR``, serves the
evaluation harness, which is not ported yet (``ROADMAP.md``, A9).
"""
