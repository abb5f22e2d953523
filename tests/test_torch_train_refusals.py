"""The port's train entry point refuses what is not ported (cases in
``torch_train_cases.py``)."""

from torch_train_cases import (  # noqa: F401
    jax_setup,
    jitted,
    test_refused_flags_raise_not_implemented,
)
