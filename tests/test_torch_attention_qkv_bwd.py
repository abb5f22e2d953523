"""The port's packed-qkv attention backward and autograd path against the JAX package's
Pallas kernel and VJP (cases in ``torch_attention_qkv_cases.py``)."""

from torch_attention_qkv_cases import (  # noqa: F401
    test_backward_plain_and_autograd_match_jax_pallas_and_vjp,
)
