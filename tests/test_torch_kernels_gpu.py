"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one. The file imports neither JAX
nor the JAX package, so on a machine with a card and without JAX it runs as
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu_torch.ops import linear_attention as TLA

pytestmark = pytest.mark.gpu


def _la_args(b, n, c, dtype, heads=4, dim_head=32, m=4, seed=0):
    rs = np.random.RandomState(seed)
    hd = heads * dim_head
    args = [
        rs.randn(b, n, c), rs.randn(c) * 0.1 + 1.0, rs.randn(c, 3 * hd) * c**-0.5,
        rs.randn(2, heads, dim_head, m), rs.randn(hd, c) * hd**-0.5,
        rs.randn(c) * 0.1, rs.randn(c) * 0.1 + 1.0,
    ]
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in args]
    args[0] = args[0].to(dtype)
    return args


# bf16: the kernel keeps q, k, v and y in f32 where the plain version rounds them to
# bf16, a few bf16 ulps (2^-8) apart on outputs of magnitude up to ~10.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,c", [(1024, 64), (256, 64), (256, 128), (64, 128), (64, 256)])
def test_linear_attention_kernel_matches_plain(n, c, residual, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _la_args(8, n, c, dtype)
    before = TLA.linear_attention.launches
    with torch.inference_mode():
        out = TLA.linear_attention(*args, 4, 32, dtype, residual).float()
        ref = TLA.linear_attention_plain(*args, 4, 32, dtype, residual).float()
    assert TLA.linear_attention.launches == before + 1
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


def test_linear_attention_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    args = _la_args(2, 48, 64, torch.float32)  # n not a multiple of 32
    with torch.inference_mode(), pytest.raises(ValueError, match="multiple of"):
        TLA.linear_attention(*args, 4, 32, torch.float32)
    args = _la_args(2, 64, 64, torch.float32)
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        TLA.linear_attention(*args, 4, 32, torch.float32)
