"""The port's NICE against the JAX package's: train steps, forward, eval and sample, and
its inverse (cases in ``torch_flows_cases.py``)."""

from torch_split import parametrize
from torch_flows_cases import (  # noqa: F401
    glow,
    nice,
    test_flow_forward_eval_sample_match_jax,
    test_flow_inverse_of_forward,
    test_flow_train_steps_match_jax,
)

SUBSETS = {
    'test_flow_forward_eval_sample_match_jax': {'case': ['nice']},
    'test_flow_inverse_of_forward': {'case': ['nice']},
    'test_flow_train_steps_match_jax': {'case': ['nice']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
