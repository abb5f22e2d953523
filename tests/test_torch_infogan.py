"""The port's InfoGAN against the JAX package's: networks, steps, eval, sampling, its Q
phase and a train state from an .npz (cases in ``torch_gan_cond_cases.py``)."""

from torch_split import parametrize
from torch_gan_cond_cases import (  # noqa: F401
    built,
    stepped,
    test_eval_step_matches_jax,
    test_infogan_q_phase_matches_jax,
    test_infogan_train_state_npz_loads_as_the_tree,
    test_networks_forward_match_jax,
    test_sampling_and_classify_match_jax,
    test_three_train_steps_match_jax,
)

SUBSETS = {
    'test_eval_step_matches_jax': {'name': ['infogan']},
    'test_networks_forward_match_jax': {'name': ['infogan']},
    'test_sampling_and_classify_match_jax': {'name': ['infogan']},
    'test_three_train_steps_match_jax': {'name': ['infogan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
