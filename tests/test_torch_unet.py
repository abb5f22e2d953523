"""The port's UNet against the JAX UNet: the class-conditional variant, the label check and
the flash path (cases in ``torch_unet_cases.py``)."""

import pytest

from torch_unet_cases import (  # noqa: F401
    build_case,
    test_conditional_unet_requires_labels,
    test_flash_attention_path_matches_einsum_path_on_cpu,
    test_flax_names_cover_tree_exactly,
    test_unet_bf16_matches_jax_bf16,
    test_unet_matches_jax,
)


@pytest.fixture(scope="module", params=['class_cond'])
def case(request):
    return build_case(request.param)
