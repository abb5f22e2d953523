"""The port's FID, KID and IS against the JAX package's classes, on the same features.

Both sides take a stand-in extractor that hands back fixed numpy features and logits
(the metric maths alone; the network is ``test_torch_inception.py``'s). The statistics
are f64 numpy on both sides: every value agrees within 1e-9 relative.
"""

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.metrics import generative as JG
from lightning_generative_models_tpu_torch.metrics import generative as TG

torch.set_num_threads(1)

RTOL = 1e-9


class TableExtractor:
    """Looks each image's (features, logits) up by the value of its first pixel."""

    def __init__(self, feats, logits):
        self.feats, self.logits = feats, logits

    def __call__(self, images_u8):
        idx = np.asarray(images_u8)[:, 0, 0, 0].astype(int)
        return self.feats[idx], self.logits[idx]


def _sets(seed=0, n=96, d=24):
    rs = np.random.RandomState(seed)
    real = rs.randn(n, d).astype(np.float32)
    fake = (rs.randn(n, d) * 1.3 + 0.4).astype(np.float32)
    feats = np.concatenate([real, fake])
    logits = (rs.randn(2 * n, 10) * 3).astype(np.float32)
    images = np.zeros((2 * n, 4, 4, 3), np.uint8)
    images[:, 0, 0, 0] = np.arange(2 * n)
    return TableExtractor(feats, logits), images[:n], images[n:]


def test_frechet_distance_and_fid_match_jax():
    rs = np.random.RandomState(3)
    a = rs.randn(16, 16)
    psd = a @ a.T
    np.testing.assert_allclose(TG.matrix_sqrt_psd(psd), JG.matrix_sqrt_psd(psd), rtol=RTOL)
    np.testing.assert_allclose(TG.matrix_sqrt_psd(psd) @ TG.matrix_sqrt_psd(psd), psd,
                               rtol=1e-8, atol=1e-8)
    extractor, real, fake = _sets()
    values = []
    for module in (TG, JG):
        fid = module.FrechetInceptionDistance(extractor)
        for start in range(0, len(real), 32):  # batched updates
            fid.update(real[start:start + 32], real=True)
            fid.update(fake[start:start + 32], real=False)
        values.append(fid.compute())
        fid.reset()
        fid.update(real, real=True)
        fid.update(real, real=False)
        assert abs(fid.compute()) < 1e-6  # one set against itself
    assert values[0] > 1.0
    np.testing.assert_allclose(values[0], values[1], rtol=RTOL)


@pytest.mark.parametrize("subset_size,subsets,seed", [(100, 10, 0), (40, 4, 7)])
def test_kid_matches_jax(subset_size, subsets, seed):
    """The same RandomState rows a subset (100 > n: every row, as in JAX), the same
    unbiased MMD^2 mean and spread."""
    extractor, real, fake = _sets(seed=1)
    out = []
    for module in (TG, JG):
        kid = module.KernelInceptionDistance(extractor, subset_size=subset_size,
                                             subsets=subsets, seed=seed)
        kid.update(real, real=True)
        kid.update(fake, real=False)
        out.append(kid.compute())
    assert out[0][0] > 0
    np.testing.assert_allclose(out[0], out[1], rtol=RTOL)


def test_inception_score_matches_jax():
    extractor, real, fake = _sets(seed=2)
    out = []
    for module in (TG, JG):
        score = module.InceptionScore(extractor, splits=3)
        score.update(real)
        score.update(fake)
        out.append(score.compute())
        score.reset()
        assert score._probs == []
    assert 1.0 < out[0][0] < 10.0
    np.testing.assert_allclose(out[0], out[1], rtol=RTOL)


def test_to_uint8_truncates_as_the_reference():
    """[0, 1] -> uint8 by ``clip(x * 255)`` and a truncating cast, on tensors and
    arrays alike: JAX's trainer quantisation (the reference's ``add(1).mul(127.5).byte()``)."""
    x = np.random.RandomState(4).uniform(-0.1, 1.1, (5, 6, 6, 3)).astype(np.float32)
    x[0, 0, 0] = [0.999, 1.0 / 255 - 1e-7, 254.9 / 255]
    ref = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    assert np.array_equal(TG.to_uint8(x), ref)
    got = TG.to_uint8(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)
    assert list(ref[0, 0, 0]) == [254, 0, 254]
