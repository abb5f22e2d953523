"""The port's VQ-VAE (plain and EMA codebook) against the JAX package's: three train steps,
eval, reconstruct and decode, a train state from an .npz, and the train entry point
(cases in ``torch_vqvae_cases.py``)."""

from torch_split import parametrize
from torch_vqvae_cases import (  # noqa: F401
    batch,
    jax_models,
    test_cpu_train_main_then_resume_and_generate,
    test_eval_reconstruct_and_decode_match_jax,
    test_three_train_steps_match_jax,
    test_train_state_npz_loads_and_next_step_matches_jax,
)

SUBSETS = {
    'test_eval_reconstruct_and_decode_match_jax': {'name': ['vqvae', 'vqvae_ema']},
    'test_three_train_steps_match_jax': {'name': ['vqvae', 'vqvae_ema']},
    'test_train_state_npz_loads_and_next_step_matches_jax': {'name': ['vqvae_ema']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
