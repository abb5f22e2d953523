"""The port's UNet against the JAX UNet: the unconditional and self-conditioned variants
(cases in ``torch_unet_cases.py``)."""

import pytest

from torch_unet_cases import (  # noqa: F401
    build_case,
    test_flax_names_cover_tree_exactly,
    test_unet_bf16_matches_jax_bf16,
    test_unet_matches_jax,
)


@pytest.fixture(scope="module", params=['self_cond', 'uncond'])
def case(request):
    return build_case(request.param)
