"""The port's SGAN against the JAX package's (cases in ``torch_gan_cond_cases.py``)."""

from torch_split import parametrize
from torch_gan_cond_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_eval_step_matches_jax,
    test_networks_forward_match_jax,
    test_sampling_and_classify_match_jax,
    test_three_train_steps_match_jax,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['sgan']},
    'test_eval_step_matches_jax': {'name': ['sgan']},
    'test_networks_forward_match_jax': {'name': ['sgan']},
    'test_sampling_and_classify_match_jax': {'name': ['sgan']},
    'test_three_train_steps_match_jax': {'name': ['sgan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
