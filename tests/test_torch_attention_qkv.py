"""The port's packed-qkv attention forward against the JAX package's Pallas kernel and
einsum path (cases in ``torch_attention_qkv_cases.py``)."""

from torch_attention_qkv_cases import (  # noqa: F401
    test_forward_plain_matches_jax_pallas_and_einsum,
)
