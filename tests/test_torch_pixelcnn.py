"""The port's PixelCNN against the JAX package, on the CPU.

8 x 8 x 3 images, hidden 8, two gated blocks, 4 levels, so that the logits' channel order
``c * num_levels + l`` and every masked tap are exercised. Both sides hold the port's
weights (``torch_flax_params``, biases drawn off zero); JAX's reference is one compiled
program (``torch_adam_model_check``): two train steps, eval, the logits, and a sample whose
pixel picks are ``jax.random.categorical(fold_in(rng, idx), logits)``, the Gumbel-max pick
argmax(logits + ``jax.random.gumbel(fold_in(rng, idx), logits.shape)``): those draws go to
the port's ``sample``. Tolerances: logits atol 1e-5, metrics rtol 1e-5, gradients 1e-4
and updates 1e-3 of their norms; the sampled images equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.autoregressive import pixelcnn as JPIX
from lightning_generative_models_tpu_torch.models.autoregressive import pixelcnn as TPIX
from lightning_generative_models_tpu_torch.registry import resolve_model_class
from torch_adam_model_check import (
    as_torch,
    check_npz_loads,
    check_two_steps,
    off_zero,
    reference,
)

torch.set_num_threads(1)

B, S, C, L = 4, 8, 3, 4
ARGS = dict(img_channels=C, img_size=S, hidden_dim=8, num_layers=2, num_levels=L, lr=1e-3)
RNG = jax.random.PRNGKey(5)


def _refs(jmodel):
    def refs(state, batch, rng):
        params = {"params": state.params["model"]}
        n = 3
        gumbel = jax.vmap(lambda i: jax.random.gumbel(jax.random.fold_in(rng, i), (n, C, L)))(
            jnp.arange(S * S))
        logits = jax.random.normal(rng, (5, 7, L))
        return {"eval": jmodel.eval_step(state, batch, rng),
                "logits": jmodel.net.apply(params, batch["image"].astype(jnp.float32) / 255.0),
                "sample": jmodel.sample(state, rng, n), "gumbel": gumbel,
                "categorical": jax.random.categorical(rng, logits),
                "gumbel_max": jnp.argmax(logits + jax.random.gumbel(rng, logits.shape), -1)}
    return refs


@pytest.fixture(scope="module")
def pixelcnn():
    port = TPIX.PixelCNN(**ARGS, device="cpu")
    off_zero(port.net, 4)
    jmodel = JPIX.PixelCNN(**ARGS)
    batch = {"image": np.random.RandomState(4).randint(0, 256, (B, S, S, C)).astype(np.uint8),
             "label": np.zeros(B, np.int32)}
    out = reference(jmodel, port, batch, RNG, lambda rng, step: {}, _refs(jmodel))
    return port, batch, as_torch(out), out


def test_causal_mask_is_jax_golden():
    for k, kind in ((7, "A"), (7, "B"), (3, "A"), (5, "B")):
        np.testing.assert_array_equal(TPIX.causal_mask(k, k, kind).numpy(),
                                      np.asarray(JPIX.causal_mask(k, k, kind)))
    assert TPIX.causal_mask(3, 3, "A").tolist() == [[1, 1, 1], [1, 0, 0], [0, 0, 0]]
    assert TPIX.causal_mask(3, 3, "B").tolist() == [[1, 1, 1], [1, 1, 0], [0, 0, 0]]


def test_pixelcnn_is_causal():
    """The gradient of pixel (i, j)'s logits with respect to the input at (i, j) and every
    later pixel in raster order is exactly 0; some earlier pixel reaches them."""
    model = TPIX.PixelCNN(**ARGS, device="cpu")
    off_zero(model.net, 6)
    x = torch.rand(1, S, S, C, requires_grad=True)
    for i, j in ((0, 0), (3, 4), (7, 7), (5, 0)):
        (g,) = torch.autograd.grad(model.net(x)[0, i, j].sum(), x)
        order = torch.arange(S * S).reshape(S, S)
        later = order >= i * S + j
        assert torch.all(g[0][later] == 0), (i, j)
        assert (i, j) == (0, 0) or torch.any(g[0][~later] != 0), (i, j)


def test_pixelcnn_forward_and_eval_match_jax(pixelcnn):
    """The logits (channel c * L + l) and eval's loss and bits/dim on the weights after
    one step, carried in from the JAX state."""
    _, batch, out, raw = pixelcnn
    model = TPIX.PixelCNN(**ARGS, device="cpu")
    model.load_flax_weights(jax.device_get(raw["state"]))
    with torch.no_grad():
        logits = model.net(torch.tensor(batch["image"]).float() / 255.0)
    assert logits.shape == (B, S, S, C, L)
    np.testing.assert_allclose(logits.numpy(), out["refs"]["logits"].numpy(), atol=1e-5)
    metrics = model.eval_step(batch)
    assert set(metrics) == {"val_loss", "val_bits_per_dim"}
    for key, value in out["refs"]["eval"].items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5)


def test_pixelcnn_train_steps_match_jax(pixelcnn):
    """Two steps: metrics, gradients, updates; the masked taps' gradients are exactly 0
    and Adam leaves them as they were."""
    port, batch, out, _ = pixelcnn
    masked = [(m.weight, m.mask == 0) for m in port.net.modules()
              if isinstance(m, TPIX.MaskedConv)]
    before = [w.detach()[:, :, mask].clone() for w, mask in masked]
    check_two_steps(port, batch, out, lambda o, step: {})
    grads, _ = port.grad_step(batch)
    by_param = dict(zip([id(p) for p in port.net.parameters()], grads))
    for (w, mask), b in zip(masked, before):
        assert torch.all(by_param[id(w)][:, :, mask] == 0)
        assert torch.equal(w.detach()[:, :, mask], b)


def test_pixelcnn_sample_matches_jax(pixelcnn, tmp_path):
    """JAX's sample and the port's on JAX's Gumbel draws, from the JAX state after one
    step (carried in by an .npz): the same images. JAX's categorical is the Gumbel-max
    pick on ``jax.random.gumbel`` of the same key."""
    _, _, out, raw = pixelcnn
    refs = out["refs"]
    assert torch.equal(refs["categorical"], refs["gumbel_max"])
    model = check_npz_loads(lambda: TPIX.PixelCNN(**ARGS, device="cpu"), raw["state"], tmp_path)
    images = model.sample(None, 3, gumbel=refs["gumbel"])
    assert images.shape == (3, S, S, C)
    np.testing.assert_array_equal(images.numpy(), refs["sample"].numpy())
    drawn = model.sample(torch.Generator().manual_seed(0), 2)
    assert ((drawn * L - 0.5) % 1 == 0).all() and resolve_model_class("pixelcnn") is TPIX.PixelCNN
