"""The port's interpolation against the JAX package's, on the CPU: each process's
``interpolate``, ``DDPM.interpolate`` (the EMA weights, null labels for a conditional
model, self-conditioning) and ``generate --interpolate``.

The draws are JAX's own, rebuilt from its key schedule and handed to the port:
GaussianDiffusion ``split(rng, 3)`` (the two noises, then ``fold_in(loop_rng, i)`` for
chain step i), RectifiedFlow and the consistency process ``split(rng)``, EDM
``split(rng, 3)`` with the churn noise of every step from ``split`` of the third key step
by step. ``lam`` is a per-sample [B, 1, 1, 1] blend, as ``generate --interpolate`` passes
it. The processes run the same closed-form network on both sides (``_net``: what they
compute around it is what is held), the model level a tiny f32 UNet (dim 16, dim_mults
(1, 2), 16 px) with the same weights, drawn by the port (``torch_flax_params``). Images
agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import consistency as JCT
from lightning_generative_models_tpu.models.diffusion import ddpm as JDDPM
from lightning_generative_models_tpu.models.diffusion import edm as JEDM
from lightning_generative_models_tpu.models.diffusion import flow_matching as JFM
from lightning_generative_models_tpu.models.diffusion import gaussian_diffusion as JGD
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch.models.diffusion import consistency as TCT
from lightning_generative_models_tpu_torch.models.diffusion import ddpm as TDDPM
from lightning_generative_models_tpu_torch.models.diffusion import edm as TEDM
from lightning_generative_models_tpu_torch.models.diffusion import flow_matching as TFM
from lightning_generative_models_tpu_torch.models.diffusion import gaussian_diffusion as TGD
from torch_flax_params import state_from_port

torch.set_num_threads(1)

TOL = 1e-5
B = 3
SHAPE = (B, 8, 8, 3)
# name: (JAX process, port process, constructor arguments, t)
PROCESSES = {
    "gaussian": (JGD.GaussianDiffusion, TGD.GaussianDiffusion,
                 dict(timesteps=12, self_condition=True), None),
    "flow": (JFM.RectifiedFlow, TFM.RectifiedFlow, dict(sampling_steps=5, solver="heun"), None),
    "edm": (JEDM.EDMProcess, TEDM.EDMProcess, dict(sampling_steps=4, s_churn=10.0), 0.7),
    "consistency": (JCT.ConsistencyProcess, TCT.ConsistencyProcess, dict(), 0.5),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _net(xp):
    """A closed-form stand-in for the network, in JAX (``jnp``) or the port (``torch``)."""
    def apply(x, t, x_self_cond=None):
        sc = 0.0 if x_self_cond is None else 0.1 * x_self_cond
        return xp.tanh(0.5 * x) + 1e-3 * t.reshape(-1, 1, 1, 1) + sc
    return apply


def _endpoints(shape):
    rs = np.random.RandomState(0)
    x1, x2 = (rs.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    lam = np.linspace(0, 1, shape[0], dtype=np.float32).reshape(-1, 1, 1, 1)
    return x1, x2, lam


def _draws(kind, rng, shape):
    """The port's explicit draws equal to what JAX's ``interpolate`` draws from ``rng``."""
    if kind == "gaussian":
        n1, n2, loop_rng = jax.random.split(rng, 3)
        return {"noise1": _t(jax.random.normal(n1, shape)),
                "noise2": _t(jax.random.normal(n2, shape)),
                "noise_fn": lambda i, s: _t(jax.random.normal(jax.random.fold_in(loop_rng, i),
                                                               s))}
    if kind == "edm":
        n1, n2, key = jax.random.split(rng, 3)
        churn = []

        def noise_fn(i, s):
            nonlocal key
            while len(churn) <= i:
                key, sub = jax.random.split(key)
                churn.append(_t(jax.random.normal(sub, s)))
            return churn[i]

        return {"noise1": _t(jax.random.normal(n1, shape)),
                "noise2": _t(jax.random.normal(n2, shape)), "noise_fn": noise_fn}
    n1, n2 = jax.random.split(rng)
    return {"noise1": _t(jax.random.normal(n1, shape)),
            "noise2": _t(jax.random.normal(n2, shape))}


@pytest.mark.parametrize("kind", sorted(PROCESSES))
def test_process_interpolate_matches_jax(kind):
    """Each process's interpolate on JAX's draws: images in [0, 1] within ``TOL``; the
    ends of the blend differ; a time outside (0, 1] is refused as JAX refuses it."""
    jcls, tcls, kw, t = PROCESSES[kind]
    jproc, tproc = jcls(img_size=8, **kw), tcls(img_size=8, **kw, device="cpu")
    x1, x2, lam = _endpoints(SHAPE)
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(jproc.interpolate(_net(jnp), jnp.asarray(x1), jnp.asarray(x2), rng, t=t,
                                       lam=jnp.asarray(lam)))
    out = tproc.interpolate(_net(torch), torch.from_numpy(x1), torch.from_numpy(x2), None,
                            t=t, lam=torch.from_numpy(lam), **_draws(kind, rng, SHAPE)).numpy()
    assert out.shape == SHAPE and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    assert not np.allclose(out[0], out[-1])
    if kind != "gaussian":
        with pytest.raises(ValueError) as jax_err:
            jproc.interpolate(_net(jnp), jnp.asarray(x1), jnp.asarray(x2), rng, t=1.5)
        with pytest.raises(ValueError) as port_err:
            tproc.interpolate(_net(torch), torch.from_numpy(x1), torch.from_numpy(x2), t=1.5)
        assert str(port_err.value) == str(jax_err.value)


def test_model_interpolate_matches_jax():
    """``DDPM.interpolate`` of a class-conditional, self-conditioned tiny DDPM (the EMA
    UNet on null labels, T 10, t 6) against JAX's ``DDPM.interpolate``, its draws JAX's."""
    args = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, diffusion_timesteps=10,
                num_classes=3, self_condition=True)
    port = TDDPM.DDPM(**args, device="cpu")
    port.init_params(torch.Generator().manual_seed(5))
    jmodel = JDDPM.DDPM(**args)
    state = state_from_port(jmodel, port)
    shape = (B, 16, 16, 3)
    x1, x2, lam = _endpoints(shape)
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(lambda s, a, b, r, l: jmodel.interpolate(s, a, b, r, t=6, lam=l))(
        state, jnp.asarray(x1), jnp.asarray(x2), rng, jnp.asarray(lam)))
    out = port.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), None, t=6,
                           lam=torch.from_numpy(lam), **_draws("gaussian", rng, shape)).numpy()
    assert out.shape == shape and 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_generate_interpolate_writes_grid(tmp_path):
    """``generate --interpolate 4``: a [4, 16, 16, 3] blend in [0, 1] and its one-row PNG;
    another ``--interpolate_t`` blends otherwise; a GAN exits with JAX's message."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "configs" / "diffusion" / "ddpm_cifar10.json").read_text())
    config["model"]["args"].update(img_size=16, dim=16, dim_mults=[1, 2], use_bf16=False,
                                   diffusion_timesteps=6)
    config["dataset"]["img_size"] = 16
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    out = tmp_path / "out"
    argv = ["--config_path", str(path), "--device", "cpu", "--out", str(out), "--seed", "1"]
    images = generate.main(argv + ["--interpolate", "4"])
    assert images.shape == (4, 16, 16, 3) and np.isfinite(images).all()
    assert 0.0 <= images.min() and images.max() <= 1.0
    assert (out / "interpolation_seed_step0.png").read_bytes().startswith(b"\x89PNG")
    again = generate.main(argv + ["--interpolate", "4", "--interpolate_t", "3"])
    assert not np.allclose(again, images)
    with pytest.raises(SystemExit, match="DCGAN does not support interpolate"):
        generate.main(["--config_path", str(root / "configs" / "gan" / "dcgan_cifar10.json"),
                       "--device", "cpu", "--out", str(out), "--interpolate", "4"])
