"""The port's WGAN with weight clipping against the JAX package's, and its RMSprop (cases
in ``torch_wgan_cases.py``)."""

from torch_split import parametrize
from torch_wgan_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_eval_step_matches_jax,
    test_make_rmsprop_matches_optax,
    test_rmsprop_state_npz_loads_as_the_tree,
    test_three_train_steps_match_jax,
    test_weight_clipping_bounds_every_d_weight,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['wgan_cp']},
    'test_eval_step_matches_jax': {'name': ['wgan_cp']},
    'test_three_train_steps_match_jax': {'name': ['wgan_cp']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
