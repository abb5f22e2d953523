"""LPIPS perceptual distance (VGG16 backbone): VQGAN's perceptual loss term.

Counterpart of ``lightning_generative_models_tpu/metrics/lpips.py`` (Zhang et al. 2018,
arXiv:1801.03924): the VGG16 trunk on NHWC input with the five LPIPS taps (relu1_2,
relu2_2, relu3_3, relu4_3, relu5_3), and ``lpips_distance``: the input in [-1, 1] shifted
and scaled by the ImageNet constants, each tap unit-normalised over its channels (eps added
to the norm, not inside the sqrt), squared differences weighted by the non-negative lin
heads, averaged over space and summed over the taps.

Weights: ``LPIPS`` takes a local torch state_dict found by ``find_pretrained_weights``
(``LGM_TPU_LPIPS_WEIGHTS``, then ``weights/lpips_vgg.pth`` in the repo, then
``~/.cache/lgm_tpu/lpips_vgg.pth``; sha256-pinnable by ``LGM_TPU_LPIPS_SHA256``): either a
full ``lpips.LPIPS(net='vgg')`` dump or a torchvision ``vgg16`` one (lin heads then 1/C).
Nothing is downloaded. Without a file the trunk is a He-scaled random init drawn from a
``torch.Generator``: distances are then self-consistent for relative use, not comparable
to published LPIPS numbers.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
from pathlib import Path
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lightning_generative_models_tpu_torch.models.modules.layers import Conv, init_params

logger = logging.getLogger(__name__)

# VGG16 feature blocks: (channels, conv count); a tap after each block's last ReLU.
VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
TAP_CHANNELS = tuple(c for c, _ in VGG_CFG)

# lpips.ScalingLayer constants (input in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 convolutional trunk (3x3 "SAME" convs Conv_0 .. Conv_12, 2x2 max pools
    between the blocks) on NHWC input, returning the five tap activations."""

    def __init__(self):
        super().__init__()
        in_ch, i = 3, 0
        for feats, n_convs in VGG_CFG:
            for _ in range(n_convs):
                self.add_module(f"Conv_{i}", Conv(in_ch, feats, 3))
                in_ch, i = feats, i + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps, i = [], 0
        for block, (_, n_convs) in enumerate(VGG_CFG):
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
            taps.append(x)
            if block < len(VGG_CFG) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


class LPIPSNet(nn.Module):
    """The trunk (``vgg``) and the five lin heads (``lins``), frozen: the flax tree
    ``{"vgg": ..., "lins": (w0, .., w4)}`` of the JAX package's LPIPS variables."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.full((c,), 1.0 / c)) for c in TAP_CHANNELS])
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lpips_distance(self, x, y)


_SCALING: dict = {}


def _scaling(device: torch.device) -> tuple:
    """The input scaling's shift and scale on ``device``, made once a device: a copy to
    the card at every call would stop a CUDA graph from holding the step."""
    if device not in _SCALING:
        _SCALING[device] = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                                 for v in (_SHIFT, _SCALE))
    return _SCALING[device]


def lpips_distance(net: LPIPSNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example LPIPS distance [b] between ``x`` and ``y``, [b, h, w, c] in [-1, 1]
    (grayscale is broadcast to RGB). Differentiable in x and y."""
    shift, scale = _scaling(x.device)

    def prep(img):
        if img.shape[-1] == 1:
            img = img.repeat(1, 1, 1, 3)
        return (img - shift) / scale

    total = 0.0
    for fx, fy, w in zip(net.vgg(prep(x)), net.vgg(prep(y)), net.lins):
        nx = fx / (torch.linalg.vector_norm(fx, dim=-1, keepdim=True) + 1e-10)
        ny = fy / (torch.linalg.vector_norm(fy, dim=-1, keepdim=True) + 1e-10)
        weighted = torch.sum((nx - ny) ** 2 * F.relu(w), dim=-1)  # [b, h, w]
        total = total + torch.mean(weighted, dim=(1, 2))
    return total


@torch.no_grad()
def he_scaled_random_(net: LPIPSNet, generator: torch.Generator) -> LPIPSNet:
    """The random fallback: the trunk's init (N(0, 1 / fan-in) kernels, zero biases)
    from ``generator``, kernels times sqrt(2) (He scaling, or the deep taps collapse
    toward constants through the ReLUs), lin heads 1/C."""
    init_params(net.vgg, generator)
    for name, p in net.vgg.named_parameters():
        if name.endswith("weight"):
            p.mul_(2.0**0.5)
    for w, c in zip(net.lins, TAP_CHANNELS):
        w.fill_(1.0 / c)
    return net


def weight_search_paths() -> List[Path]:
    paths = []
    env = os.environ.get("LGM_TPU_LPIPS_WEIGHTS")
    if env:
        paths.append(Path(env))
    repo_root = Path(__file__).resolve().parents[2]
    return paths + [repo_root / "weights" / "lpips_vgg.pth",
                    Path.home() / ".cache" / "lgm_tpu" / "lpips_vgg.pth"]


def find_pretrained_weights() -> Optional[Path]:
    """The first existing weights file of ``weight_search_paths``, checked against
    ``LGM_TPU_LPIPS_SHA256`` (a prefix of at least 8 hex digits) when that is set."""
    expected = os.environ.get("LGM_TPU_LPIPS_SHA256", "").lower()
    if expected and len(expected) < 8:
        raise ValueError(
            "LGM_TPU_LPIPS_SHA256 must be at least 8 hex chars (torch.hub "
            f"pins use >=8); got {len(expected)} — a too-short prefix "
            "matches almost anything and defeats the pin."
        )
    for p in weight_search_paths():
        if p.exists():
            if expected:
                digest = hashlib.sha256(p.read_bytes()).hexdigest()
                if not digest.startswith(expected):
                    raise ValueError(
                        f"LPIPS weights at {p} have sha256 {digest}, which "
                        f"does not match LGM_TPU_LPIPS_SHA256={expected}. "
                        "Re-download the file (docs/FID.md, LPIPS section)."
                    )
            return p
    return None


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


@torch.no_grad()
def load_torch_lpips(path: str | Path, net: Optional[LPIPSNet] = None) -> LPIPSNet:
    """A torch state_dict into ``net`` (a new ``LPIPSNet`` when None): a full
    ``lpips.LPIPS(net='vgg')`` dump (``net.slice*`` convs, ``lin{i}.model.1.weight``
    heads) or a torchvision ``vgg16`` one (``features.*`` convs; heads 1/C). The 13 convs
    fill Conv_0 .. Conv_12 in natural key order; their OIHW kernels are the port's
    layout already."""
    net = LPIPSNet() if net is None else net
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        logger.warning(
            "%s is not a plain state_dict; falling back to "
            "weights_only=False torch.load (executes pickle code — only "
            "use weight files you trust, ideally sha256-pinned via "
            "LGM_TPU_LPIPS_SHA256).", path,
        )
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    conv_keys = sorted(
        (k for k in sd if (k.startswith("net.slice") or k.startswith("features."))
         and k.endswith(".weight") and sd[k].dim() == 4),
        key=_natural_key,
    )
    if len(conv_keys) < 13:
        raise ValueError(
            f"{path} holds {len(conv_keys)} conv weights; a VGG16 trunk "
            "needs 13 (is this a lin-only lpips checkpoint? It must be "
            "merged with a torchvision vgg16 state_dict — docs/FID.md)."
        )
    for i, wk in enumerate(conv_keys[:13]):
        conv = getattr(net.vgg, f"Conv_{i}")
        conv.weight.copy_(sd[wk].float())
        bk = wk[: -len("weight")] + "bias"
        if bk in sd:
            conv.bias.copy_(sd[bk].float())
    for i, (w, c) in enumerate(zip(net.lins, TAP_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        w.copy_(sd[key].float().reshape(-1) if key in sd else torch.full((c,), 1.0 / c))
    return net


class LPIPS:
    """LPIPS with its weights resolved: explicit ``net`` > a state_dict that
    ``find_pretrained_weights`` finds > the He-scaled random init from
    ``torch.Generator().manual_seed(seed)`` (with a warning). ``net`` lives on
    ``device``."""

    def __init__(self, net: Optional[LPIPSNet] = None, seed: int = 0,
                 device: str | torch.device = "cpu"):
        self.pretrained = net is not None
        if net is None:
            ckpt = find_pretrained_weights()
            if ckpt is not None:
                logger.info("Loading LPIPS/VGG16 weights from %s", ckpt)
                net = load_torch_lpips(ckpt)
                self.pretrained = True
        if net is None:
            logger.warning(
                "LPIPS/VGG16 weights unavailable (offline environment): "
                "using deterministic He-scaled random init. Perceptual "
                "distances are self-consistent but NOT comparable to "
                "published LPIPS values. Drop lpips_vgg.pth at one of %s or "
                "set LGM_TPU_LPIPS_WEIGHTS (docs/FID.md, LPIPS section).",
                [str(p) for p in weight_search_paths()],
            )
            net = he_scaled_random_(LPIPSNet(), torch.Generator().manual_seed(seed))
        self.net = net.to(device)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lpips_distance(self.net, x, y)
