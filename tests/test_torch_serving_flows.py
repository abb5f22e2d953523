"""The port's serving export of NICE, Glow, PixelCNN (its raster loop as one scan) and
InfoGAN (its code-transition grid) against their live samplers and the JAX package's
artifacts (cases in ``torch_serving_samplers_cases.py``)."""

from torch_serving_samplers_cases import (  # noqa: F401
    test_sampler_artifact_matches_live_and_jax,
)
from torch_split import parametrize

SUBSETS = {"test_sampler_artifact_matches_live_and_jax": {
    "family": ["nice", "glow", "pixelcnn", "infogan"]}}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
