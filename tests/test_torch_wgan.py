"""The port's WGAN-GP against the JAX package's: its penalty, steps, eval, checkpoint, the
critic interleave and the train entry point (cases in ``torch_wgan_cases.py``)."""

from torch_split import parametrize
from torch_wgan_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_cpu_train_main_then_resume_and_generate,
    test_eval_step_matches_jax,
    test_penalty_alone_matches_jax,
    test_three_train_steps_match_jax,
    test_wgan_interleave_and_statistics,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['wgan_gp']},
    'test_eval_step_matches_jax': {'name': ['wgan_gp']},
    'test_penalty_alone_matches_jax': {'name': ['wgan_gp']},
    'test_three_train_steps_match_jax': {'name': ['wgan_gp']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
