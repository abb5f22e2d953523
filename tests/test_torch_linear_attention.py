"""The port's linear-attention forward against the JAX package's at 16 channels and on
the head-scale-disparity input (cases in ``torch_linear_attention_cases.py``)."""

import pytest

from torch_linear_attention_cases import (  # noqa: F401
    test_plain_head_scale_disparity,
    test_plain_matches_jax_xla_and_pallas,
)


@pytest.fixture(params=[16])
def c(request):
    return request.param
