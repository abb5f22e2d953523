"""Parametrization for the port's test files that share one cases module.

A cases module (``torch_*_cases.py``, not collected) holds the tests of one subject; the
test files import them, so that each file holds few tests and pytest-xdist's file queue
(largest files first) runs it after the JAX package's long files of few tests. A file
takes its own subset of a test's parameter values from ``SUBSETS``, {test name:
{argnames: values}}, through ``pytest_generate_tests``.
"""


def parametrize(metafunc, subsets):
    for argnames, values in subsets.get(metafunc.function.__name__, {}).items():
        metafunc.parametrize(argnames, values)
