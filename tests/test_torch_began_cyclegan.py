"""The port's BEGAN against the JAX package's (cases in ``torch_began_cyclegan_cases.py``)."""

from torch_split import parametrize
from torch_began_cyclegan_cases import (  # noqa: F401
    built,
    stepped,
    test_began_k_t_is_clipped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_eval_step_matches_jax,
    test_networks_forward_match_jax,
    test_three_train_steps_match_jax,
    test_train_state_npz_loads_as_the_tree,
)

SUBSETS = {
    'test_eval_step_matches_jax': {'name': ['began']},
    'test_networks_forward_match_jax': {'name': ['began']},
    'test_three_train_steps_match_jax': {'name': ['began']},
    'test_train_state_npz_loads_as_the_tree': {'name': ['began']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
