"""Cases of the port's NICE and Glow against the JAX package's, on the CPU, imported by
``test_torch_flows.py`` (Glow) and ``test_torch_flows_nice.py`` (NICE).

NICE on 4 x 4 x 3 images (dim 48: the NHWC flatten matters at C > 1), hidden 16, four
couplings of two hidden layers; Glow on 8 x 8 x 3, two levels of two steps, coupling width
8 (``tests/test_glow.py``'s sizes, with three channels so that the squeeze's channel order
matters). At init NICE's scale, Glow's actnorms and its couplings' last convs are zeros,
and then almost every gradient is exactly 0: the checks draw every zero leaf off zero
(``off_zero``). Both sides hold the port's weights; each model's JAX reference is one
compiled program (``torch_adam_model_check``): two train steps on JAX's uniform draws of
``fold_in(rng, step)``, z and log-det, eval, the log-likelihood and a sample on JAX's
normal draw. Tolerances: z, log-det and log-likelihood within 1e-5 of 1 + |ref|, metrics
rtol 1e-5, gradients 1e-4 and updates 1e-3 of their norms, samples atol 1e-5;
``inverse(forward(x))`` within 1e-5 and Glow's log-det against the log|det| of the
autograd Jacobian within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.flow import glow as JGLOW
from lightning_generative_models_tpu.models.flow import nice as JNICE
from lightning_generative_models_tpu_torch.models.flow import glow as TGLOW
from lightning_generative_models_tpu_torch.models.flow import nice as TNICE
from lightning_generative_models_tpu_torch.registry import resolve_model_class
from torch_adam_model_check import (
    as_torch,
    check_npz_loads,
    check_two_steps,
    off_zero,
    reference,
)

torch.set_num_threads(1)

B = 4
NICE_ARGS = dict(img_channels=3, img_size=4, hidden_dim=16, num_coupling_layers=4,
                 num_hidden_layers=2, lr=1e-3)
GLOW_ARGS = dict(img_channels=3, img_size=8, levels=2, depth=2, width=8, lr=1e-3,
                 sample_temperature=0.7)
RNG = jax.random.PRNGKey(3)


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.max(np.abs(out - ref) / (1 + np.abs(ref))) <= tol


def _case(jcls, tcls, args, seed, prepare, dim):
    port = tcls(**args, device="cpu")
    off_zero(port.net, seed)
    jmodel = jcls(**args)
    s, c = args["img_size"], args["img_channels"]
    batch = {"image": np.random.RandomState(seed).randint(0, 256, (B, s, s, c)).astype(np.uint8),
             "label": np.zeros(B, np.int32)}

    def draws(rng, step):
        return {"uniform": jax.random.uniform(jax.random.fold_in(rng, step), (B, s, s, c))}

    def refs(state, batch, rng):
        params = {"params": state.params["model"]}
        x = prepare(jmodel, batch["image"])
        z, log_det = jmodel.net.apply(params, x)
        return {"x": x, "z": z, "log_det": log_det, "eval": jmodel.eval_step(state, batch, rng),
                "log_likelihood": jmodel.log_likelihood(state, batch),
                "sample": jmodel.sample(state, rng, 3),
                "sample_z": jax.random.normal(rng, (3, dim))}

    out = reference(jmodel, port, batch, RNG, draws, refs)
    return port, batch, as_torch(out), out


@pytest.fixture(scope="module")
def nice():
    return _case(JNICE.NICE, TNICE.NICE, NICE_ARGS, 1, lambda m, u8: m._flatten(u8), 48)


@pytest.fixture(scope="module")
def glow():
    return _case(JGLOW.Glow, TGLOW.Glow, GLOW_ARGS, 2, lambda m, u8: m._prepare(u8), 192)


def _model(case):
    return (TNICE.NICE(**NICE_ARGS, device="cpu") if case == "nice"
            else TGLOW.Glow(**GLOW_ARGS, device="cpu"))


def test_flow_train_steps_match_jax(case, request):
    """Two steps dequantised by JAX's uniform draws: metrics, gradients, updates."""
    port, batch, out, _ = request.getfixturevalue(case)
    check_two_steps(port, batch, out, lambda o, step: o["draws"][step])


def test_flow_forward_eval_sample_match_jax(case, request, tmp_path):
    """On the JAX state after one step, carried in by an .npz: the prepared input
    (NHWC flatten for NICE), z and log-det, eval, the log-likelihood and a sample."""
    _, batch, out, raw = request.getfixturevalue(case)
    model = check_npz_loads(lambda: _model(case), raw["state"], tmp_path)
    refs = out["refs"]
    images = torch.tensor(batch["image"])
    x = model._flatten(images) if case == "nice" else model._prepare(images)
    np.testing.assert_array_equal(x.numpy(), refs["x"].numpy())
    with torch.no_grad():
        z, log_det = model.net(x)
    _close(z, refs["z"])
    _close(log_det * torch.ones(B), refs["log_det"] * torch.ones(B))
    metrics = model.eval_step(batch)
    for key, value in refs["eval"].items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5)
    _close(model.log_likelihood(batch), refs["log_likelihood"])
    np.testing.assert_allclose(model.sample(None, 3, z=refs["sample_z"]).numpy(),
                               refs["sample"].numpy(), atol=1e-5)


def test_flow_inverse_of_forward(case):
    model = _model(case)
    off_zero(model.net, 9)
    s, c = model.img_size, model.img_channels
    x = torch.rand(3, s, s, c, generator=torch.Generator().manual_seed(0)) - 0.5
    x = x.reshape(3, -1) if case == "nice" else x
    with torch.no_grad():
        z, _ = model.net(x)
        assert z.shape == (3, s * s * c)
        np.testing.assert_allclose(model.net.inverse(z).numpy(), x.numpy(), atol=1e-5)


@pytest.mark.parametrize("levels", [1, 2])
def test_glow_log_det_is_the_jacobians(levels):
    """log|det J| of the whole flow, per example, against slogdet of its autograd Jacobian,
    at one level and at two (a split between them)."""
    model = TGLOW.Glow(**{**GLOW_ARGS, "levels": levels}, device="cpu")
    off_zero(model.net, 11)
    with torch.no_grad():  # the 1x1 convs off orthogonal
        for m in model.net.modules():
            if isinstance(m, TGLOW.Inv1x1Conv):
                m.w.mul_(1.3).add_(0.05 * torch.randn(m.w.shape,
                                                      generator=torch.Generator().manual_seed(1)))
    x = torch.rand(2, 8, 8, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    net = model.net.double()
    _, log_det = net(x)
    for i in range(2):
        jac = torch.autograd.functional.jacobian(lambda v: net(v.reshape(1, 8, 8, 3))[0][0],
                                                 x[i].reshape(-1))
        np.testing.assert_allclose(float(log_det[i].detach()), float(torch.linalg.slogdet(jac)[1]),
                                   atol=1e-4)


def test_glow_squeeze_and_errors_as_jax():
    """squeeze2x2 in JAX's channel order and its inverse; the divisibility ValueError with
    JAX's text; the registry resolves both names."""
    x = np.random.RandomState(0).randn(2, 4, 6, 3).astype(np.float32)
    y = TGLOW.squeeze2x2(torch.tensor(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(JGLOW.squeeze2x2(jnp.asarray(x))))
    np.testing.assert_array_equal(TGLOW.unsqueeze2x2(y).numpy(), x)
    for cls, kw in ((TGLOW.Glow, {"device": "cpu"}), (JGLOW.Glow, {})):
        with pytest.raises(ValueError, match=r"img_size=28 must be divisible by 2\^levels=8"):
            cls(img_size=28, levels=3, **kw)
    assert resolve_model_class("glow") is TGLOW.Glow
    assert resolve_model_class("NICE") is TNICE.NICE
