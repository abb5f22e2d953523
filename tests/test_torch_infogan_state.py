"""The port's InfoGAN statistics moves and its checkpoint round trip (cases in
``torch_gan_cond_cases.py``)."""

from torch_split import parametrize
from torch_gan_cond_cases import (  # noqa: F401
    built,
    stepped,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_infogan_moves_statistics_twice_in_g_and_four_times_in_d,
)

SUBSETS = {
    'test_checkpoint_round_trip_continues_bit_for_bit': {'name': ['infogan']},
}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
