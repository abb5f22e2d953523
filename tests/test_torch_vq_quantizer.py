"""The port's vector quantizers (plain and EMA) and transposed convs against flax (cases in
``torch_vq_cases.py``)."""

from torch_split import parametrize
from torch_vq_cases import (  # noqa: F401
    quantizer_inputs,
    test_conv_layers_match_flax,
    test_vector_quantizer_ema_matches_flax,
    test_vector_quantizer_matches_flax,
)

SUBSETS = {
    'test_conv_layers_match_flax': {'kind,kernel,stride,size': [('transpose', 4, 2, 8), ('transpose', 4, 2, 5), ('transpose', 3, 2, 6)]},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
