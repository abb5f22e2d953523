"""The port's UNet autoencoder against the JAX package's (cases in
``torch_autoencoders_cases.py``)."""

from torch_autoencoders_cases import (  # noqa: F401
    dae,
    test_unet_ae_eval_and_reconstruct_match_jax,
    test_unet_ae_refusals_as_jax,
    test_unet_ae_train_steps_match_jax,
    unet,
)
