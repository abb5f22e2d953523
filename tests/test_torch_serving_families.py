"""The port's serving export of FlowMatching, EDM, the DiT, ConsistencyModel,
LatentDiffusion and CGAN (cases in ``torch_serving_cases.py``)."""

from torch_serving_cases import (  # noqa: F401
    test_conditional_labels_baked,
    test_latent_diffusion_export_bakes_frozen_ae,
    test_new_family_export_roundtrip,
)
