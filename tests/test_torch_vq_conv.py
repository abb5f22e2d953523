"""The port's convs at strides 1 and 2 against flax's (cases in ``torch_vq_cases.py``)."""

from torch_split import parametrize
from torch_vq_cases import (  # noqa: F401
    quantizer_inputs,
    test_conv_layers_match_flax,
)

SUBSETS = {
    'test_conv_layers_match_flax': {'kind,kernel,stride,size': [('conv', 4, 2, 16), ('conv', 4, 2, 9), ('conv', 4, 1, 8), ('conv', 4, 1, 5), ('conv', 3, 1, 7)]},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
