"""The port's DDPM(network="dit") against the JAX package's: a guided DDIM-3 chain and
three train steps (cases in ``torch_dit_cases.py``)."""

from torch_dit_cases import (  # noqa: F401
    flax_params,
    jax_ddpm,
    test_cfg_ddim3_chain_matches_jax,
    test_three_train_steps_match_jax,
)
