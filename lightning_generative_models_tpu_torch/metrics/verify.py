"""FID parity check of the port: ``python -m lightning_generative_models_tpu_torch.metrics.verify``.

Counterpart of ``lightning_generative_models_tpu/metrics/verify.py``, on the card by
default (``--device cpu`` to run it on the CPU). Two stages:

1. Always (offline): a torchvision-layout InceptionV3 reference (``tests/
   torch_inception_ref.py``, loaded by path, with He-initialised convs) computes FID over
   a fixed pair of synthetic image sets through torchmetrics' ingestion
   (``F.interpolate``, bilinear, ``align_corners=False``); its ``state_dict`` goes through
   ``load_torch_weights`` into the port's extractor, which computes the same FID. The
   two must agree: that checks the network, the loader, the ingestion and the formula.
2. With a weights file: if ``pt_inception-2015-12-05.pth`` (pytorch-fid's, the
   checkpoint torchmetrics uses) is at one of ``weight_search_paths``, it is loaded and
   a real FID is computed. Otherwise this prints which file to drop where. Nothing is
   downloaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lightning_generative_models_tpu_torch.metrics.generative import (
    FrechetInceptionDistance,
    frechet_distance,
)
from lightning_generative_models_tpu_torch.metrics.inception import (
    InceptionFeatureExtractor,
    find_pretrained_weights,
    load_torch_weights,
    weight_search_paths,
)
from lightning_generative_models_tpu_torch.ops.common import resolve_device

REFERENCE = Path(__file__).resolve().parents[2] / "tests" / "torch_inception_ref.py"


def _fixed_image_sets(n: int = 64, size: int = 32, seed: int = 123):
    """Two clearly different distributions, so the FID is far from zero: smooth
    bilinear-upsampled 4x4 noise against hard black-and-white noise (uint8 NHWC)."""
    rs = np.random.RandomState(seed)
    small = rs.rand(n, 4, 4, 3)
    idx = np.linspace(0, 3, size)
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, 3)
    a = small[:, lo][:, :, lo]
    b = small[:, hi][:, :, lo]
    c = small[:, lo][:, :, hi]
    d = small[:, hi][:, :, hi]
    wy = (idx - lo)[None, :, None, None]
    wx = (idx - lo)[None, None, :, None]
    real = a * (1 - wy) * (1 - wx) + b * wy * (1 - wx) + c * (1 - wy) * wx + d * wy * wx
    real = (real * 255).astype(np.uint8)
    fake = (rs.rand(n, size, size, 3) > 0.5).astype(np.uint8) * 255
    return real, fake


def reference_net(path: Path = REFERENCE, seed: int = 0) -> torch.nn.Module:
    """The torchvision-layout reference InceptionV3 with He-initialised convs (torch's
    default init shrinks the signal ~0.58x a layer: every image would map to one
    feature vector and both FIDs would be 0)."""
    spec = importlib.util.spec_from_file_location("torch_inception_ref", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    torch.manual_seed(seed)
    net = module.TorchInceptionV3().eval()
    for mod in net.modules():
        if isinstance(mod, torch.nn.Conv2d):
            torch.nn.init.kaiming_normal_(mod.weight, mode="fan_in", nonlinearity="relu")
    return net


@torch.no_grad()
def reference_fid(net: torch.nn.Module, real_u8: np.ndarray, fake_u8: np.ndarray,
                  device: torch.device) -> float:
    """FID through the reference net with torchmetrics' ingestion and formula."""
    def feats(images_u8):
        x = torch.tensor(images_u8.transpose(0, 3, 1, 2)).to(device).float() / 255.0
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
        return net(x * 2.0 - 1.0)[0].cpu().numpy()

    fr, ff = feats(real_u8), feats(fake_u8)
    return frechet_distance(fr.mean(0), np.cov(fr, rowvar=False),
                            ff.mean(0), np.cov(ff, rowvar=False))


def _fid(extractor, real_u8: np.ndarray, fake_u8: np.ndarray) -> float:
    fid = FrechetInceptionDistance(extractor)
    fid.update(real_u8, real=True)
    fid.update(fake_u8, real=False)
    return fid.compute()


def verify_loader_path(device: str | torch.device = "cuda", tol: float = 0.5) -> float:
    """Stage 1: the reference pipeline's FID against the port's, through the loader."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = reference_net()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "inception.pt"
        torch.save(net.state_dict(), path)
        port_net = load_torch_weights(path)
    real, fake = _fixed_image_sets()
    fid_ref = reference_fid(net.to(device), real, fake, device)
    fid_port = _fid(InceptionFeatureExtractor(port_net, device=device), real, fake)
    delta = abs(fid_ref - fid_port)
    tol = max(tol, 0.01 * abs(fid_ref))
    print(f"[stage 1] reference-pipeline FID = {fid_ref:.6f}")
    print(f"[stage 1] port-pipeline FID      = {fid_port:.6f}  (|delta| = {delta:.6f})")
    if delta > tol:
        raise SystemExit(f"FID pipelines disagree by {delta:.4f} (> {tol}); loader or "
                         "ingestion drift — run tests/test_torch_inception.py.")
    print("[stage 1] PASS: architecture + loader + ingestion + formula agree.")
    return fid_port


def verify_pretrained(device: str | torch.device = "cuda") -> int:
    """Stage 2: a real FID with the pytorch-fid checkpoint, if one is on the machine."""
    ckpt = find_pretrained_weights()
    if ckpt is None:
        print("[stage 2] no pretrained checkpoint found. For absolute (reference-"
              "comparable) FID, fetch on a machine with network access:")
        print("  https://github.com/mseitzer/pytorch-fid/releases/download/"
              "fid_weights/pt_inception-2015-12-05.pth")
        print("and drop it at one of:")
        for p in weight_search_paths():
            print(f"  {p}")
        return 1
    extractor = InceptionFeatureExtractor(device=device)
    assert extractor.pretrained
    real, fake = _fixed_image_sets()
    print(f"[stage 2] pretrained FID on the fixed set = {_fid(extractor, real, fake):.4f}")
    print(f"[stage 2] PASS: absolute FID is live (weights: {ckpt}).")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("FID parity check of the port")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    verify_loader_path(args.device)
    return verify_pretrained(args.device)


if __name__ == "__main__":
    sys.exit(main())
