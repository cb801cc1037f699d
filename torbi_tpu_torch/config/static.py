"""Configuration values derived from the constants.

Counterpart of ``torbi_tpu/config/static.py``: values that depend on
constants an override file may replace. The JAX package derives them when
it is imported, after its ``--config`` files; this package applies
``--config`` when an entry point parses its arguments, so ``derive`` runs
at import and again after every ``configure``.
"""


def derive():
    """Set the derived values on the package from its current constants"""
    import torbi_tpu_torch

    # Partition JSONs ship inside the package assets
    torbi_tpu_torch.PARTITION_DIR = torbi_tpu_torch.ASSETS_DIR / 'partitions'
