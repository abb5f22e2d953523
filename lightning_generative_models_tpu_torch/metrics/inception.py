"""InceptionV3, the FID/KID/IS feature extractor, as an NCHW PyTorch module.

Counterpart of ``lightning_generative_models_tpu/metrics/inception.py``: ``BasicConv``
(conv without bias, BatchNorm with eps 1e-3 on its running statistics, ReLU), the mixed
blocks ``InceptionA``-``E``, the 2048-d global average pool and the 1008-way head. The
layout is torchvision's, as the JAX package's is: the pools of the A, C and E blocks are
3x3 averages that count the padding, and the last E block average-pools too (pytorch-fid's
``FIDInception*`` blocks do not count the padding, and its last E block max-pools: a known
difference of both packages from pytorch-fid). The modules carry torchvision's names
(``Conv2d_1a_3x3``, ``Mixed_5b``, ``branch1x1``, ``conv``, ``bn``, ``fc``), so a
torchvision or pytorch-fid ``state_dict`` loads directly (``load_torch_weights``).

Ingestion follows torchmetrics: uint8 -> f32 / 255, a 1-channel image repeated to 3,
bilinear resize to 299x299 (``align_corners=False``, no antialiasing), then x 2 - 1.

Weights: a local pytorch-fid / torchvision file found by ``find_pretrained_weights``
(nothing is downloaded), else a deterministic He-scaled random init drawn from a
``torch.Generator``: relative tracking only, not comparable to published numbers, and
not the JAX package's draw, so the offline FIDs of the two packages differ.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import normal_
from lightning_generative_models_tpu_torch.ops.common import resolve_device

logger = logging.getLogger(__name__)

FEATURE_DIM = 2048
NUM_LOGITS = 1008  # TF-slim's class count (pytorch-fid's head)
INPUT_SIZE = 299


class BasicConv(nn.Module):
    def __init__(self, in_c: int, out_c: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_c, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        x = F.batch_norm(x, self.bn.running_mean, self.bn.running_var, self.bn.weight,
                         self.bn.bias, training=False, eps=self.bn.eps)
        return F.relu(x)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, in_c: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_c, 64, 1)
        self.branch5x5_1 = BasicConv(in_c, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_c, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_c, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_c, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_c, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b2, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_c: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_c, 192, 1)
        self.branch7x7_1 = BasicConv(in_c, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_c, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_c, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b3 = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            b3 = conv(b3)
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_c, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_c, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch3x3_2(self.branch3x3_1(x))
        b2 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b1, b2, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_c, 320, 1)
        self.branch3x3_1 = BasicConv(in_c, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_c, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_c, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2 = self.branch3x3_1(x)
        b2 = torch.cat([self.branch3x3_2a(b2), self.branch3x3_2b(b2)], 1)
        b3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3 = torch.cat([self.branch3x3dbl_3a(b3), self.branch3x3dbl_3b(b3)], 1)
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionV3(nn.Module):
    """x: f32 [B, 3, H, W] in [-1, 1] (H, W >= 75) -> (features [B, 2048], logits
    [B, 1008])."""

    MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
             "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(FEATURE_DIM, NUM_LOGITS)

    def forward(self, x: torch.Tensor):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in self.MIXED:
            x = getattr(self, name)(x)
        features = x.mean(dim=(2, 3))
        return features, self.fc(features)


@torch.no_grad()
def he_scaled_random_init(net: InceptionV3, generator: Optional[torch.Generator] = None):
    """Deterministic random weights: each conv kernel from N(0, 2 / fan-in) (flax's
    fan-in variance scaled by sqrt(2), as the JAX package scales its init: without it the
    features collapse over the ~94 ReLU layers and every FID approaches 0), the
    BatchNorms at scale 1, bias 0, mean 0, var 1, the head from N(0, 1 / fan-in) with a
    zero bias. Drawn on the CPU ``generator`` (seed 0 when omitted)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for mod in net.modules():
        if isinstance(mod, nn.Conv2d):
            normal_(mod.weight, (2.0 / mod.weight[0].numel()) ** 0.5, generator)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    normal_(net.fc.weight, net.fc.weight.shape[1] ** -0.5, generator)
    net.fc.bias.zero_()
    return net


def weight_search_paths() -> List[Path]:
    """Where a local pytorch-fid / torchvision InceptionV3 ``state_dict`` is looked for,
    in order: ``$LGM_TPU_INCEPTION_WEIGHTS``, ``<repo>/weights/pt_inception-2015-12-05.pth``,
    ``~/.cache/lgm_tpu/pt_inception-2015-12-05.pth``."""
    paths = []
    env = os.environ.get("LGM_TPU_INCEPTION_WEIGHTS")
    if env:
        paths.append(Path(env))
    repo_root = Path(__file__).resolve().parents[2]
    paths += [
        repo_root / "weights" / "pt_inception-2015-12-05.pth",
        Path.home() / ".cache" / "lgm_tpu" / "pt_inception-2015-12-05.pth",
    ]
    return paths


def find_pretrained_weights() -> Optional[Path]:
    """The first existing file of ``weight_search_paths``, or None. With
    ``LGM_TPU_INCEPTION_SHA256`` set (at least 8 hex characters), the file's sha256 must
    start with it."""
    expected = os.environ.get("LGM_TPU_INCEPTION_SHA256", "").lower()
    if expected and len(expected) < 8:
        raise ValueError(
            "LGM_TPU_INCEPTION_SHA256 must be at least 8 hex chars "
            f"(torch.hub pins use >=8); got {len(expected)} — a too-short "
            "prefix matches almost anything and defeats the pin.")
    for p in weight_search_paths():
        if p.exists():
            if expected:
                digest = hashlib.sha256(p.read_bytes()).hexdigest()
                if not digest.startswith(expected):
                    raise ValueError(
                        f"InceptionV3 weights at {p} have sha256 {digest}, which does not "
                        f"match LGM_TPU_INCEPTION_SHA256={expected}. Re-download the file "
                        "(docs/FID.md).")
            return p
    return None


@torch.no_grad()
def load_torch_weights(path, net: Optional[InceptionV3] = None) -> InceptionV3:
    """A torchvision / pytorch-fid InceptionV3 ``state_dict`` (``torch.save``) into
    ``net`` (a new ``InceptionV3`` when omitted): the aux classifier dropped, the ``fc``
    head optional (kept as it is when absent), BatchNorm's ``num_batches_tracked``
    optional; any other missing or left-over key, or a shape that does not fit, raises."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # A file holding a whole nn.Module: full unpickling, the last resort.
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith("AuxLogits")}
    net = InceptionV3() if net is None else net
    target = net.state_dict()
    optional = {k for k in target
                if k.endswith("num_batches_tracked") or k.startswith("fc.")}
    missing = sorted(k for k in target if k not in sd and k not in optional)
    if "fc.weight" in sd or "fc.bias" in sd:
        missing += [k for k in ("fc.weight", "fc.bias") if k not in sd]
    extra = sorted(set(sd) - set(target))
    if missing or extra:
        raise KeyError(f"InceptionV3 state_dict does not fit: missing {missing}, "
                       f"left over {extra}")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"shape mismatch {key}: {tuple(value.shape)} -> "
                             f"{tuple(target[key].shape)}")
        target[key].copy_(value)
    return net


def ingest(images_u8, device: torch.device) -> torch.Tensor:
    """uint8 NHWC images (numpy or tensor) -> the network's f32 NCHW input in [-1, 1]
    at 299x299, on ``device``."""
    x = images_u8 if torch.is_tensor(images_u8) else torch.from_numpy(np.asarray(images_u8))
    x = x.to(device).float() / 255.0
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    x = x.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                      align_corners=False, antialias=False)
    return x * 2.0 - 1.0


class InceptionFeatureExtractor:
    """uint8 NHWC images -> (features [B, 2048], logits [B, 1008]) as numpy, the network
    on ``device`` (the card by default) under ``torch.no_grad``.

    Weights, in order: ``net`` as given; a file found by ``find_pretrained_weights``;
    the He-scaled random init from ``seed`` (relative tracking only, with a warning).
    ``pretrained`` says whether real weights were loaded."""

    def __init__(self, net: Optional[InceptionV3] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.pretrained = net is not None
        if net is None:
            ckpt = find_pretrained_weights()
            if ckpt is not None:
                logger.info("Loading InceptionV3 weights from %s", ckpt)
                net = load_torch_weights(ckpt)
                self.pretrained = True
        if net is None:
            logger.warning(
                "InceptionV3 weights unavailable (offline environment): using "
                "deterministic He-scaled random init. FID/KID/IS values are "
                "self-consistent but NOT comparable to published numbers. "
                "Drop pt_inception-2015-12-05.pth at one of %s or set "
                "LGM_TPU_INCEPTION_WEIGHTS (see docs/FID.md).",
                [str(p) for p in weight_search_paths()])
            net = he_scaled_random_init(InceptionV3(), torch.Generator().manual_seed(seed))
        self.net = net.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, images_u8):
        feats, logits = self.net(ingest(images_u8, self.device))
        return feats.cpu().numpy(), logits.cpu().numpy()
