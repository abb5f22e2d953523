"""The port's linear-attention gradient against the JAX package's at 64 channels, and
autograd through the plain forward (cases in ``torch_linear_attention_bwd_cases.py``)."""

import pytest

from torch_linear_attention_bwd_cases import (  # noqa: F401
    test_autograd_through_plain_matches_bwd_plain,
    test_bwd_plain_matches_jax_pallas_and_xla,
)


@pytest.fixture(params=[64])
def c(request):
    return request.param
