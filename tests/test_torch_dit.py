"""The port's DiT against the JAX package's: its init, positions, f32 and bf16 forwards and
its options (cases in ``torch_dit_cases.py``)."""

from torch_dit_cases import (  # noqa: F401
    flax_params,
    jax_ddpm,
    test_bf16_forward_matches_jax_bf16,
    test_f32_forward_matches_jax,
    test_output_is_exactly_zero_at_init,
    test_posemb_equals_jax,
    test_raised_options,
)
