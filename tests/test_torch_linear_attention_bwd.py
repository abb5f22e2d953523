"""The port's linear-attention gradient against the JAX package's at 16 channels, the
head-scale-disparity input and bf16 (cases in ``torch_linear_attention_bwd_cases.py``)."""

import pytest

from torch_linear_attention_bwd_cases import (  # noqa: F401
    test_bwd_plain_bf16_matches_jax_pallas,
    test_bwd_plain_head_scale_disparity,
    test_bwd_plain_matches_jax_pallas_and_xla,
)


@pytest.fixture(params=[16])
def c(request):
    return request.param
