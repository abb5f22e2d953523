"""The port's serving export of every registry name, an artifact of the first draw-plan
format, and the export CLI on Glow (cases in ``torch_serving_samplers_cases.py``)."""

from torch_serving_samplers_cases import (  # noqa: F401
    test_every_registry_name_exports,
    test_export_cli_glow_round_trip,
    test_normal_plan_artifact_loads_and_runs,
)
from torch_split import parametrize

SUBSETS = {"test_every_registry_name_exports": {"names": [
    ("DDPM", "FlowMatching", "EDM", "ConsistencyModel", "LatentDiffusion",
     "LatentFlowMatching", "LatentEDM"),
    ("VAE", "DAE", "NICE", "Glow", "VQVAE", "VQGAN", "InfoGAN", "PixelCNN", "UNet",
     "GAN", "DCGAN", "LSGAN", "WGAN", "R1GAN", "ACGAN", "SGAN", "CGAN", "BEGAN",
     "CycleGAN"),
]}}


def pytest_generate_tests(metafunc):
    parametrize(metafunc, SUBSETS)
