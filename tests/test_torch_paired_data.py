"""The port's PairedDataModule against the JAX package's (cases in
``torch_began_cyclegan_cases.py``)."""

from torch_began_cyclegan_cases import (  # noqa: F401
    built,
    stepped,
    test_paired_datamodule_matches_jax,
)
