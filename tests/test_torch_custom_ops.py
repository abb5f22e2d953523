"""Kernels #1-#7 as ``torch.library`` custom ops (``lgm_torch::``), on the CPU: each op's
schema, fake, autograd and CPU (plain) registrations through ``torch.library.opcheck``, and
a scan body that calls the linear-attention op through ``torch.export``, ``save`` and
``load``."""

import torch
from torch._higher_order_ops import scan

from lightning_generative_models_tpu_torch.ops import attention, linear_attention  # noqa: F401
from lightning_generative_models_tpu_torch.ops import preprocess, vq  # noqa: F401

torch.set_num_threads(1)

OPS = ("linear_attention", "linear_attention_bwd", "attention_qkv", "attention_qkv_bwd",
       "flash_attention", "flash_attention_bwd", "nearest_codes", "normalize_flip")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _la_inputs(g, b=2, n=16, c=64, m=4):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale
    x = r(b, n, c)
    params = [1 + r(c, scale=0.1), r(c, 384, scale=0.05), r(2, 4, 32, m),
              r(128, c, scale=0.05), r(c, scale=0.1), 1 + r(c, scale=0.1)]
    return x, params


def _opcheck(op, args):
    result = torch.library.opcheck(getattr(torch.ops.lgm_torch, op).default, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def test_ops_are_registered_with_fakes():
    """Eight entries in one namespace; each fake gives the output's shape and dtype on the
    meta device, without data."""
    for op in OPS:
        assert hasattr(torch.ops.lgm_torch, op), op
    x, params = _la_inputs(_gen())
    meta = [t.to("meta") for t in (x, *params)]
    out = torch.ops.lgm_torch.linear_attention(*meta, 4, 32, torch.bfloat16, False)
    assert out.device.type == "meta" and out.shape == x.shape and out.dtype == torch.bfloat16
    flat = torch.ops.lgm_torch.nearest_codes(torch.empty(10, 8, device="meta"),
                                             torch.empty(4, 8, device="meta"))
    assert flat.shape == (10,) and flat.dtype == torch.int32


def test_opcheck_linear_attention():
    x, params = _la_inputs(_gen(1))
    _opcheck("linear_attention", (x.requires_grad_(), *[p.requires_grad_() for p in params],
                                  4, 32, torch.float32, True))
    dout = torch.randn(x.shape, generator=_gen(2))
    _opcheck("linear_attention_bwd", (x.detach(), *[p.detach() for p in params], dout,
                                      4, 32, torch.float32, False))


def test_opcheck_attention_qkv():
    g = _gen(3)
    for layout in ("s3hd", "h3d"):
        qkv = torch.randn(2, 16, 3 * 2 * 8, generator=g)
        _opcheck("attention_qkv", (qkv.clone().requires_grad_(), 2, layout))
        _opcheck("attention_qkv_bwd", (qkv, torch.randn(2, 16, 16, generator=g), 2, layout))


def test_opcheck_flash_attention_and_its_backward_route():
    """On the DiT's strided [b, h, n, d] views of a packed qkv, as the kernels read them."""
    g = _gen(4)
    packed = torch.randn(2, 32, 3, 2, 8, generator=g).requires_grad_()
    q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
    _opcheck("flash_attention", (q, k, v))
    _opcheck("flash_attention_bwd", (q.detach(), k.detach(), v.detach(),
                                     torch.randn(2, 2, 32, 8, generator=g)))


def test_opcheck_nearest_codes_and_normalize_flip():
    g = _gen(5)
    _opcheck("nearest_codes", (torch.randn(40, 8, generator=g), torch.randn(16, 8, generator=g)))
    images = torch.randint(0, 256, (3, 4, 5, 3), dtype=torch.uint8, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        _opcheck("normalize_flip", (images, torch.tensor([True, False, True]), dtype))


class _ScanBlock(torch.nn.Module):
    """A scan of 4 steps whose body applies the linear-attention op to the carry."""

    def __init__(self, params):
        super().__init__()
        self.params = torch.nn.ParameterList(
            [torch.nn.Parameter(p, requires_grad=False) for p in params])

    def forward(self, x, scales):
        def body(carry, s):
            out = torch.ops.lgm_torch.linear_attention(carry, *self.params, 4, 32,
                                                       torch.float32, True)
            return out * s, out.sum()

        return scan(body, x, scales)


def test_scan_body_with_the_op_exports_and_reloads(tmp_path):
    x, params = _la_inputs(_gen(6))
    module = _ScanBlock(params)
    scales = torch.tensor([1.0, 0.5, 2.0, 1.0])
    program = torch.export.export(module, (x, scales))
    assert any("lgm_torch.linear_attention" in str(n.target)
               for sub in program.graph_module.modules() if isinstance(sub, torch.fx.GraphModule)
               for n in sub.graph.nodes)
    torch.export.save(program, tmp_path / "scan.pt2")
    loaded = torch.export.load(tmp_path / "scan.pt2")
    with torch.inference_mode():
        eager = module(x, scales)
        out = loaded.module()(x, scales)
    for a, b in zip(out, eager):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
