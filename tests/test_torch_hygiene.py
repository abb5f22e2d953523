"""The port and chip_smoke.py import nothing of JAX or of the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "lightning_generative_models_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lightning_generative_models_tpu")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_has_modules():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    for module in ("models/diffusion/edm.py", "models/diffusion/consistency.py",
                   "models/diffusion/latent_diffusion.py", "models/vae/vae.py",
                   "metrics/lpips.py", "models/autoencoder/dae.py",
                   "models/autoencoder/unet.py", "models/autoregressive/pixelcnn.py",
                   "models/flow/nice.py", "models/flow/glow.py", "metrics/inception.py",
                   "metrics/generative.py", "metrics/verify.py", "models/modules/moe.py"):
        assert PORT / module in FILES, module
