"""Generative metrics: FID, KID and the Inception Score.

Counterpart of ``lightning_generative_models_tpu/metrics/generative.py``: ``update`` with
uint8 NHWC batches, ``compute``, ``reset``; the Frechet distance in the symmetric
``sqrtm(S1^1/2 S2 S1^1/2)`` eigen form (PSD-stable, f64 numpy, no scipy); KID as the mean
and spread of the unbiased polynomial-kernel MMD^2 over ``subsets`` subsets, whose rows
come from ``np.random.RandomState(seed)`` in the JAX package's order, so both pick the
same rows; IS from the softmax of the logits over ``splits`` chunks.

The feature extractor is any callable from uint8 NHWC images to (features, logits) as
numpy arrays; the default is ``metrics.inception.InceptionFeatureExtractor`` on the card.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib


def matrix_sqrt_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root by eigendecomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrtm(S1 S2)) by the symmetric form."""
    diff = mu1 - mu2
    s1_half = matrix_sqrt_psd(sigma1)
    covmean = matrix_sqrt_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def to_uint8(images01):
    """[0, 1] images (a tensor, on any device, or an array) -> uint8 by truncation,
    ``clip(x * 255, 0, 255)`` then a cast: the reference's ``add(1).mul(127.5).byte()``
    on [-1, 1]."""
    if torch.is_tensor(images01):
        return torch.clamp(images01.float() * 255.0, 0, 255).to(torch.uint8)
    return np.clip(np.asarray(images01, np.float32) * 255.0, 0, 255).astype(np.uint8)


def over_data_ranks(extract: Callable, device) -> Callable:
    """``extract`` with its features and logits gathered over the ambient mesh's data
    ranks (``parallel/mesh.py``), in rank order: each rank runs InceptionV3 on its rows,
    and every rank's metrics see the global batch's, as one device's do."""
    if mesh_lib.data_size() == 1:
        return extract

    def gathered(images_u8):
        return tuple(mesh_lib.to_host(torch.as_tensor(np.asarray(a), device=device))
                     for a in extract(images_u8))

    return gathered


def _default_extractor() -> Callable:
    from lightning_generative_models_tpu_torch.metrics.inception import (
        InceptionFeatureExtractor,
    )

    return InceptionFeatureExtractor()


class _FeatureMetric:
    def __init__(self, feature_extractor: Optional[Callable] = None):
        self.extract = feature_extractor or _default_extractor()
        self.reset()

    def reset(self) -> None:
        self._real: List[np.ndarray] = []
        self._fake: List[np.ndarray] = []

    def update(self, images_u8, real: bool) -> None:
        feats, _ = self.extract(images_u8)
        (self._real if real else self._fake).append(np.asarray(feats))


class FrechetInceptionDistance(_FeatureMetric):
    def compute(self) -> float:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        return frechet_distance(real.mean(0), np.cov(real, rowvar=False),
                                fake.mean(0), np.cov(fake, rowvar=False))


def polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                      gamma: Optional[float] = None, coef: float = 1.0) -> np.ndarray:
    gamma = gamma if gamma is not None else 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef) ** degree


def _mmd2(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased squared MMD with the polynomial kernel (torchmetrics' KID)."""
    m = x.shape[0]
    k_xx = polynomial_kernel(x, x)
    k_yy = polynomial_kernel(y, y)
    k_xy = polynomial_kernel(x, y)
    term_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    term_yy = (k_yy.sum() - np.trace(k_yy)) / (m * (m - 1))
    return float(term_xx + term_yy - 2 * k_xy.mean())


class KernelInceptionDistance(_FeatureMetric):
    def __init__(self, feature_extractor: Optional[Callable] = None, subset_size: int = 100,
                 subsets: int = 10, seed: int = 0):
        self.subset_size = subset_size
        self.subsets = subsets
        self.seed = seed
        super().__init__(feature_extractor)

    def compute(self) -> Tuple[float, float]:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        size = min(self.subset_size, len(real), len(fake))
        rs = np.random.RandomState(self.seed)
        values = []
        for _ in range(self.subsets):
            ri = rs.choice(len(real), size, replace=False)
            fi = rs.choice(len(fake), size, replace=False)
            values.append(_mmd2(real[ri], fake[fi]))
        return float(np.mean(values)), float(np.std(values))


class InceptionScore:
    def __init__(self, feature_extractor: Optional[Callable] = None, splits: int = 10):
        self.extract = feature_extractor or _default_extractor()
        self.splits = splits
        self.reset()

    def reset(self) -> None:
        self._probs: List[np.ndarray] = []

    def update(self, images_u8) -> None:
        _, logits = self.extract(images_u8)
        logits = np.asarray(logits)
        exp = np.exp(logits - logits.max(axis=1, keepdims=True))
        self._probs.append(exp / exp.sum(axis=1, keepdims=True))

    def compute(self) -> Tuple[float, float]:
        probs = np.concatenate(self._probs)
        scores = []
        for chunk in np.array_split(probs, self.splits):
            marginal = chunk.mean(axis=0, keepdims=True)
            kl = chunk * (np.log(chunk + 1e-10) - np.log(marginal + 1e-10))
            scores.append(np.exp(kl.sum(axis=1).mean()))
        return float(np.mean(scores)), float(np.std(scores))
