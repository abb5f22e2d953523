"""The port's DAE against the JAX package's (cases in ``torch_autoencoders_cases.py``)."""

from torch_autoencoders_cases import (  # noqa: F401
    dae,
    test_dae_eval_denoise_sample_match_jax,
    test_dae_loads_a_jax_train_state,
    test_dae_noise_and_errors_as_jax,
    test_dae_salt_and_pepper_matches_jax,
    test_dae_train_steps_match_jax,
    unet,
)
