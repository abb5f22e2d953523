"""The port's GAN layers and plumbing against the JAX package's: BatchNorm, the
constructor's checks, the checkpoint and the train entry point (cases in
``torch_gan_cases.py``)."""

from torch_gan_cases import (  # noqa: F401
    jax_models,
    test_batchnorm_matches_flax,
    test_calculate_metrics_and_bad_loss_type_raise,
    test_checkpoint_round_trip_continues_bit_for_bit,
    test_cpu_train_main_then_resume_and_generate,
)
