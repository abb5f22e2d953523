"""The port's packed-qkv attention in bf16, its qkv offsets, its CPU dispatch and its
argument errors (cases in ``torch_attention_qkv_cases.py``)."""

from torch_attention_qkv_cases import (  # noqa: F401
    test_argument_errors,
    test_cpu_dispatch_takes_the_plain_version_and_launches_nothing,
    test_forward_plain_bf16_matches_jax_einsum_bf16,
    test_qkv_offsets_equal_jax,
)
