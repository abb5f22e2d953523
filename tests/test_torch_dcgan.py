"""The port's DCGAN against the JAX package's: networks (32 and 28 px), three train steps,
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
    'test_eval_step_and_sample_match_jax': {'name': ['dcgan']},
    'test_networks_forward_match_jax': {'name': ['dcgan', 'dcgan28']},
    'test_three_train_steps_match_jax': {'name': ['dcgan']},
    'test_train_state_npz_loads_and_next_step_matches_jax': {'name': ['dcgan28']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
