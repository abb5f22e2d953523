"""The flags the port's train entry point once refused (``--strategy fsdp|tp|pp``, a
pipeline config) now run or raise the JAX trainer's checks (cases in
``torch_train_cases.py``)."""

from torch_train_cases import (  # noqa: F401
    jax_setup,
    jitted,
    test_refused_flags_raise_not_implemented,
)
