"""The port's VQGAN (plain and EMA codebook) against the JAX package's: three train steps,
eval, reconstruct and decode, a train state from an .npz, and the perceptual weight
(cases in ``torch_vqvae_cases.py``)."""

from torch_split import parametrize
from torch_vqvae_cases import (  # noqa: F401
    batch,
    jax_models,
    test_eval_reconstruct_and_decode_match_jax,
    test_three_train_steps_match_jax,
    test_train_state_npz_loads_and_next_step_matches_jax,
    test_vqgan_perceptual_weight_not_ported,
)

SUBSETS = {
    'test_eval_reconstruct_and_decode_match_jax': {'name': ['vqgan']},
    'test_three_train_steps_match_jax': {'name': ['vqgan', 'vqgan_ema']},
    'test_train_state_npz_loads_and_next_step_matches_jax': {'name': ['vqgan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
