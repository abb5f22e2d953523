"""The port's LatentDiffusion, LatentEDM and LatentFlowMatching against the JAX package's:
the latent-space hooks, a train step each, the checkpoint and the autoencoder's spec
errors (cases in ``torch_latent_diffusion_cases.py``)."""

from torch_latent_diffusion_cases import (  # noqa: F401
    ae_config,
    batch,
    models,
    test_autoencoder_spec_errors_are_jax_messages,
    test_checkpoint_holds_the_autoencoder,
    test_hooks_and_val_latent_std_match_jax,
    test_train_step_matches_jax,
)
