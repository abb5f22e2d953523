"""The port's serving export of DDPM: the artifact against the live sampler and against
the JAX package's artifact, the ancestral chain as one scan, and the refusals (cases in
``torch_serving_cases.py``)."""

from torch_serving_cases import (  # noqa: F401
    ddpm_artifact,
    ddpm_pair,
    test_ancestral_chain_scans_over_every_step,
    test_artifact_refused_on_another_device,
    test_dpmpp_sampler_bakes_into_artifact,
    test_labels_rejected_without_sample_classes,
    test_roundtrip_matches_live_sample,
    test_sha256_mismatch_detected,
)
