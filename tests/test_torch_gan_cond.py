"""The port's CGAN against the JAX package's, and its train entry point with labels (cases
in ``torch_gan_cond_cases.py``)."""

from torch_split import parametrize
from torch_gan_cond_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_cpu_train_main_then_resume_and_generate_labels,
    test_eval_step_matches_jax,
    test_networks_forward_match_jax,
    test_sampling_and_classify_match_jax,
    test_three_train_steps_match_jax,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['cgan']},
    'test_eval_step_matches_jax': {'name': ['cgan']},
    'test_networks_forward_match_jax': {'name': ['cgan']},
    'test_sampling_and_classify_match_jax': {'name': ['cgan']},
    'test_three_train_steps_match_jax': {'name': ['cgan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
