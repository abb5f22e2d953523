"""The port's LSGAN against the JAX package's (cases in ``torch_wgan_cases.py``)."""

from torch_split import parametrize
from torch_wgan_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_eval_step_matches_jax,
    test_three_train_steps_match_jax,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['lsgan']},
    'test_eval_step_matches_jax': {'name': ['lsgan']},
    'test_three_train_steps_match_jax': {'name': ['lsgan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
