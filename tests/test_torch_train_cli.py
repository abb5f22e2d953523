"""The port's train entry point on the CPU: train and resume, SIGTERM, and prepare_batch's
kernel backend on a CPU batch (cases in ``torch_train_cases.py``)."""

from torch_train_cases import (  # noqa: F401
    jax_setup,
    jitted,
    test_cpu_train_main_then_resume,
    test_prepare_batch_pallas_backend_matches_default_on_cpu,
    test_sigterm_saves_first_and_skips_validation,
)
