"""The port's serving export of the VAE, the DAE, VQ-VAE and VQGAN against their live
samplers and the JAX package's artifacts, and the draw plans of the new distributions
(cases in ``torch_serving_samplers_cases.py``)."""

from torch_serving_samplers_cases import (  # noqa: F401
    test_sampler_artifact_matches_live_and_jax,
    test_sampler_draw_plans,
)
from torch_split import parametrize

SUBSETS = {"test_sampler_artifact_matches_live_and_jax": {
    "family": ["vae", "dae", "vqvae", "vqgan"]}}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
