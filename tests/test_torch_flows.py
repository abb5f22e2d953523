"""The port's Glow against the JAX package's: train steps, forward, eval and sample, its
inverse, its log-det against the Jacobian and its squeeze (cases in
``torch_flows_cases.py``)."""

from torch_split import parametrize
from torch_flows_cases import (  # noqa: F401
    glow,
    nice,
    test_flow_forward_eval_sample_match_jax,
    test_flow_inverse_of_forward,
    test_flow_train_steps_match_jax,
    test_glow_log_det_is_the_jacobians,
    test_glow_squeeze_and_errors_as_jax,
)

SUBSETS = {
    'test_flow_forward_eval_sample_match_jax': {'case': ['glow']},
    'test_flow_inverse_of_forward': {'case': ['glow']},
    'test_flow_train_steps_match_jax': {'case': ['glow']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
