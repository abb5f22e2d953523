"""The port's DDPM training against the JAX package's: three train steps, a train state
from an .npz, the data and the gradient accumulation (cases in
``torch_train_cases.py``)."""

from torch_train_cases import (  # noqa: F401
    jax_setup,
    jitted,
    test_grad_accum_auto_picks_by_merged_batch_size,
    test_grad_accum_scan_matches_concat,
    test_load_flax_train_state_from_npz,
    test_synthetic_dataset_and_datamodule_match_jax,
    test_three_train_steps_match_jax,
)
