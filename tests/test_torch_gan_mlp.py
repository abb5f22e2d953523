"""The port's MLP GAN against the JAX package's: networks, three train steps (both losses),
eval and sample, a train state from an .npz (cases in ``torch_gan_cases.py``)."""

from torch_split import parametrize
from torch_gan_cases import (  # noqa: F401
    jax_models,
    test_eval_step_and_sample_match_jax,
    test_networks_forward_match_jax,
    test_three_train_steps_match_jax,
    test_train_state_npz_loads_and_next_step_matches_jax,
)

SUBSETS = {
    'test_eval_step_and_sample_match_jax': {'name': ['gan']},
    'test_networks_forward_match_jax': {'name': ['gan']},
    'test_three_train_steps_match_jax': {'name': ['gan', 'gan_min_max']},
    'test_train_state_npz_loads_and_next_step_matches_jax': {'name': ['gan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
