"""The port's consistency model against the JAX package's: the boundary coefficients, the
samplers, three train steps and the error messages (cases in
``torch_consistency_cases.py``)."""

from torch_consistency_cases import (  # noqa: F401
    models,
    test_boundary_and_coeffs_match_jax,
    test_errors_are_jax_messages,
    test_sampler_chains_match_jax,
    test_three_train_steps_match_jax,
)
