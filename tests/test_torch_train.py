"""The port's DDPM train step against the JAX package's: prepare_batch and p_losses,
grad_step, and apply_grad_step across the EMA's boundaries (cases in
``torch_train_cases.py``)."""

from torch_train_cases import (  # noqa: F401
    jax_setup,
    jitted,
    test_apply_grad_step_matches_jax_across_ema_boundaries,
    test_grad_step_matches_jax_grad,
    test_prepare_batch_and_p_losses_match_jax,
)
