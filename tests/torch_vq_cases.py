"""Cases of the port's VQ search, quantizers and VQ conv layers against the JAX package, on
the CPU, imported by ``test_torch_vq.py`` (the search), ``test_torch_vq_quantizer.py``
(the quantizers, the transposed convs) and ``test_torch_vq_conv.py`` (the convs).

The search (``ops/vq.py``) is held to interpret-mode ``nearest_codes_pallas`` and to
``nearest_code_indices`` by distances, not only indices: the versions sum the f32 dot
in different orders (and ``nearest_code_indices`` keeps ||z||^2), so near-tied codes
can flip. The quantizers, ``Conv`` at strides 1 and 2 and ``ConvTranspose`` are held to
flax with the same weights and inputs, in f32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.modules import vector_quantizer as jax_vq
from lightning_generative_models_tpu.ops import vq as jax_vq_ops
from lightning_generative_models_tpu_torch.models.modules import vector_quantizer as port_vq
from lightning_generative_models_tpu_torch.models.modules.layers import Conv, ConvTranspose
from lightning_generative_models_tpu_torch.ops import vq as port_vq_ops
from lightning_generative_models_tpu_torch.weights import flatten_tree, load_flax_params

torch.set_num_threads(1)

TIE_TOL = 1e-5  # a chosen code's distance within TIE_TOL * (1 + |d_min|) of the minimum
AGREE = 0.999   # least share of rows on which two versions pick the same index


def _inputs(n, k, d, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, d).astype(np.float32), rs.randn(k, d).astype(np.float32)


def _check_near_ties(flat, codebook, idx):
    """Each row's chosen code is a true nearest one, up to f32 rounding of the sums."""
    dist = ((flat[:, None, :].astype(np.float64) - codebook[None].astype(np.float64)) ** 2
            ).sum(-1)
    d_min = dist.min(axis=1)
    chosen = dist[np.arange(len(idx)), np.asarray(idx)]
    assert np.all(chosen <= d_min + TIE_TOL * (1.0 + np.abs(d_min)))


def _pallas_interpret(flat, codebook):
    jax_vq_ops._INTERPRET = True
    try:
        return np.asarray(jax_vq_ops.nearest_codes_pallas(jnp.asarray(flat),
                                                          jnp.asarray(codebook)))
    finally:
        jax_vq_ops._INTERPRET = False


@pytest.mark.parametrize("n,k,d", [(1000, 512, 64), (1024, 128, 8), (37, 16, 8)])
def test_nearest_codes_plain_matches_pallas_and_xla(n, k, d):
    flat, codebook = _inputs(n, k, d)
    ours = port_vq_ops.nearest_codes(torch.tensor(flat), torch.tensor(codebook))
    assert ours.dtype == torch.int32 and tuple(ours.shape) == (n,)
    ours = ours.numpy()
    pallas = _pallas_interpret(flat, codebook)
    xla = np.asarray(jax_vq.nearest_code_indices(jnp.asarray(flat), jnp.asarray(codebook)))
    for idx in (ours, pallas, xla):
        _check_near_ties(flat, codebook, idx)
    assert np.mean(ours == pallas) >= AGREE
    assert np.mean(ours == xla) >= AGREE


def test_nearest_codes_first_index_on_duplicated_codebook():
    flat, base = _inputs(1024, 64, 8, seed=1)
    for codebook, first in ((np.concatenate([base, base]), lambda i: i < 64),
                            (np.repeat(base, 2, axis=0), lambda i: i % 2 == 0)):
        ours = port_vq_ops.nearest_codes_plain(torch.tensor(flat), torch.tensor(codebook))
        pallas = _pallas_interpret(flat, codebook)
        xla = np.asarray(jax_vq.nearest_code_indices(jnp.asarray(flat),
                                                     jnp.asarray(codebook)))
        for idx in (ours.numpy(), pallas, xla):
            assert np.all(first(np.asarray(idx)))


def test_nearest_codes_casts_to_f32_and_refuses_bad_shapes():
    flat, codebook = _inputs(64, 16, 8, seed=2)
    f64 = port_vq_ops.nearest_codes(torch.tensor(flat, dtype=torch.float64),
                                    torch.tensor(codebook, dtype=torch.float64))
    f32 = port_vq_ops.nearest_codes(torch.tensor(flat), torch.tensor(codebook))
    assert torch.equal(f64, f32)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        port_vq_ops.nearest_codes(torch.zeros(4, 8), torch.zeros(16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        port_vq_ops.nearest_codes_cuda(torch.zeros(4, 8), torch.zeros(16, 8))


# -- quantizers ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantizer_inputs():
    rs = np.random.RandomState(3)
    latents = rs.randn(2, 4, 4, 8).astype(np.float32) * 0.5
    weight = rs.randn(2, 4, 4, 8).astype(np.float32)  # a linear readout of quantized
    return latents, weight


def _jax_objective(vq, variables, weight, mutable):
    def f(latents, params):
        v = {**variables, "params": params} if "params" in variables else variables
        if mutable:
            (q, loss, ppl), _ = vq.apply(v, latents, train=True, mutable=["codebook"])
        else:
            q, loss, ppl = vq.apply(v, latents, train=False)
        return jnp.sum(q * weight) + 3.0 * loss, (q, loss, ppl)

    return f


def test_vector_quantizer_matches_flax(quantizer_inputs):
    latents, weight = quantizer_inputs
    vq = jax_vq.VectorQuantizer(num_embeddings=16, embedding_dim=8, commitment_cost=0.25)
    variables = vq.init(jax.random.PRNGKey(0), jnp.asarray(latents), train=False)
    # A codebook near the latents, so the codes in use are many.
    params = {"embedding": jnp.asarray(latents.reshape(-1, 8)[::2][:16] * 0.9)}
    f = _jax_objective(vq, {**variables, "params": params}, jnp.asarray(weight), False)
    (obj, (q, loss, ppl)), (g_lat, g_params) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(latents), params)

    port = port_vq.VectorQuantizer(16, 8, 0.25)
    load_flax_params(port, flatten_tree(jax.device_get(params)))
    lat = torch.tensor(latents, requires_grad=True)
    pq, ploss, pppl = port(lat)
    (torch.sum(pq * torch.tensor(weight)) + 3.0 * ploss).backward()
    for a, b in ((pq, q), (ploss, loss), (pppl, ppl), (lat.grad, g_lat),
                 (port.embedding.grad, g_params["embedding"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    assert float(pppl) > 2.0


def test_vector_quantizer_ema_matches_flax(quantizer_inputs):
    """Outputs, loss, perplexity and the latents' gradient in training mode, and the
    three codebook buffers after one and after three training-mode calls; eval mode
    leaves them as they are."""
    latents, weight = quantizer_inputs
    vq = jax_vq.VectorQuantizerEMA(num_embeddings=16, embedding_dim=8, decay=0.9)
    variables = vq.init(jax.random.PRNGKey(1), jnp.asarray(latents), train=False)
    codebook = dict(variables["codebook"])
    codebook["embedding"] = jnp.asarray(latents.reshape(-1, 8)[1::2][:16] * 0.8)
    codebook["ema_embedding"] = codebook["embedding"] + 0.01
    codebook["ema_cluster_size"] = jnp.linspace(0.0, 2.0, 16)
    variables = {"codebook": codebook}

    port = port_vq.VectorQuantizerEMA(16, 8, decay=0.9)
    load_flax_params(port, flatten_tree(jax.device_get(codebook)), buffers=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.eval()
    with torch.no_grad():
        port(torch.tensor(latents))
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k])

    port.train()
    for call in range(3):
        lat_j = jnp.asarray(latents + 0.1 * call)
        f = jax.value_and_grad(_jax_objective(vq, variables, jnp.asarray(weight), True),
                               has_aux=True)
        (_, (q, loss, ppl)), g_lat = f(lat_j, None)
        _, updated = vq.apply(variables, lat_j, train=True, mutable=["codebook"])
        variables = {"codebook": updated["codebook"]}

        lat = torch.tensor(np.asarray(lat_j), requires_grad=True)
        pq, ploss, pppl = port(lat)
        (torch.sum(pq * torch.tensor(weight)) + 3.0 * ploss).backward()
        for a, b in ((pq, q), (ploss, loss), (pppl, ppl), (lat.grad, g_lat)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
        if call in (0, 2):
            for name, value in updated["codebook"].items():
                np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(value),
                                           atol=1e-5, rtol=1e-5)


# -- conv layers ----------------------------------------------------------------------


def test_conv_layers_match_flax(kind, kernel, stride, size):
    rs = np.random.RandomState(size + kernel)
    x = rs.randn(2, size, size, 5).astype(np.float32)
    cls = fnn.Conv if kind == "conv" else fnn.ConvTranspose
    layer = cls(6, (kernel, kernel), strides=(stride, stride), padding="SAME")
    params = layer.init(jax.random.PRNGKey(size), jnp.asarray(x))["params"]
    params = {**params, "bias": jnp.asarray(rs.randn(6).astype(np.float32))}
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))

    port_cls = Conv if kind == "conv" else ConvTranspose
    port = load_flax_params(port_cls(5, 6, kernel, stride=stride),
                            flatten_tree(jax.device_get(params)))
    with torch.no_grad():
        out = port(torch.tensor(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
