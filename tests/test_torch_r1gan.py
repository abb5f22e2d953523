"""The port's R1GAN against the JAX package's (cases in ``torch_wgan_cases.py``)."""

from torch_split import parametrize
from torch_wgan_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_eval_step_matches_jax,
    test_penalty_alone_matches_jax,
    test_three_train_steps_match_jax,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['r1gan']},
    'test_eval_step_matches_jax': {'name': ['r1gan']},
    'test_penalty_alone_matches_jax': {'name': ['r1gan']},
    'test_three_train_steps_match_jax': {'name': ['r1gan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
