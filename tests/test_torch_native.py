"""The port's native loader (``data/native.py`` over ``csrc/host_preprocess.cpp``) against
the JAX package's (``data/native.py`` over ``native/preprocess.cpp``), on the CPU: the
same source built with the same flags, so bit for bit."""

import numpy as np
import pytest

from lightning_generative_models_tpu.data import datamodule as jax_dm
from lightning_generative_models_tpu.data import native as jax_native
from lightning_generative_models_tpu_torch.data import datamodule as port_dm
from lightning_generative_models_tpu_torch.data import native

SHAPES = {
    "integer_factor": ((4, 64, 64, 3), 16),
    "crop_only_non_square": ((3, 40, 56, 1), 40),
    "non_integer": ((5, 218, 178, 3), 64),
}


def _images(shape):
    return np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_center_crop_resize_equals_jax_bit_for_bit(case):
    shape, size = SHAPES[case]
    images = _images(shape)
    out = native.center_crop_resize_batch(images, size)
    assert out.shape == (shape[0], size, size, shape[3]) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jax_native.center_crop_resize_batch(images, size))


def test_prep_images_equals_jax():
    """The DataModule's one-time staging: the native library where a real resize is
    needed (min(H, W) != size), the numpy path otherwise, as the JAX DataModule."""
    for shape, size in [*SHAPES.values(), ((2, 32, 32, 3), 32), ((2, 36, 32, 3), 32)]:
        images = _images(shape)
        np.testing.assert_array_equal(port_dm._prep_images(images, size),
                                      jax_dm._prep_images(images, size))


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """No quiet numpy fallback: a source that does not compile raises, with g++'s
    message."""
    broken = tmp_path / "host_preprocess.cpp"
    broken.write_text("extern \"C\" void center_crop_resize_batch( { }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for host_preprocess.cpp"):
        native.center_crop_resize_batch(_images((1, 8, 8, 3)), 4)
    assert not list((tmp_path / "build").glob("*.so"))
