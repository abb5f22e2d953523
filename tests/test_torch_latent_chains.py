"""The port's LatentEDM and LatentFlowMatching sampler chains against the JAX package's
(cases in ``torch_latent_diffusion_cases.py``)."""

from torch_latent_diffusion_cases import (  # noqa: F401
    ae_config,
    batch,
    models,
    test_sampler_chain_matches_jax,
)
