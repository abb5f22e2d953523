"""The port's DDIM, DPM++ and ancestral samplers against the JAX package's, class-cond
variant (cases in ``torch_diffusion_cases.py``)."""

import pytest

from torch_diffusion_cases import (  # noqa: F401
    build_models,
    test_ancestral_sampling_matches_jax,
    test_sample_dispatch_and_guidance_checks,
    test_strided_samplers_match_jax,
)


@pytest.fixture(scope="module", params=["class_cond"])
def models(request):
    return build_models(request.param)
