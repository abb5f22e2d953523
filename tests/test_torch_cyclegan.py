"""The port's CycleGAN against the JAX package's, translation and the train entry point
(cases in ``torch_began_cyclegan_cases.py``)."""

from torch_split import parametrize
from torch_began_cyclegan_cases import (  # noqa: F401
    built,
    stepped,
    test_cpu_train_main_then_resume_and_translate,
    test_cyclegan_translate_matches_jax,
    test_eval_step_matches_jax,
    test_networks_forward_match_jax,
    test_three_train_steps_match_jax,
    test_train_state_npz_loads_as_the_tree,
)

SUBSETS = {
    'test_eval_step_matches_jax': {'name': ['cyclegan']},
    'test_networks_forward_match_jax': {'name': ['cyclegan']},
    'test_three_train_steps_match_jax': {'name': ['cyclegan']},
    'test_train_state_npz_loads_as_the_tree': {'name': ['cyclegan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
