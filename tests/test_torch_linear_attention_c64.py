"""The port's linear-attention forward against the JAX package's at 64 channels, and its
device dispatch (cases in ``torch_linear_attention_cases.py``)."""

import pytest

from torch_linear_attention_cases import (  # noqa: F401
    test_dispatch_rejects_other_devices,
    test_plain_matches_jax_xla_and_pallas,
)


@pytest.fixture(params=[64])
def c(request):
    return request.param
