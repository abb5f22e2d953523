"""The port's Adam with bf16 moments (``--mu_dtype`` / ``--nu_dtype bfloat16``) against
optax's, on the CPU.

The JAX package builds ``optax.chain(add_decayed_weights, scale_by_adam(mu_dtype),
scale(-lr))`` under ``with_nu_dtype`` and runs it under ``jit``; the port's ``Adam``
rounds where that program rounds (``train/state.py``). Three steps from the same weights
and gradients: the moments stored in bf16 equal optax's bit for bit, those in f32 agree
within 1e-6 of 1 + |ref|, and the weights within 1e-7 (optax's program fuses a multiply-add
that the port rounds twice, an f32 ulp apart).
A checkpoint keeps the moments' dtypes; loading it where the moments are of another dtype
raises, through the train entry point too.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightning_generative_models_tpu.train import state as jstate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.train.state import (
    Adam,
    make_adam,
    set_default_mu_dtype,
    set_default_nu_dtype,
)

torch.set_num_threads(1)

SHAPES = [(7, 5, 3), (13,)]
WEIGHT_TOL = 1e-7
MOMENT_TOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def dtypes():
    """Resets the process-wide moment dtypes after a test (both packages')."""
    yield
    jstate.set_default_mu_dtype(None)
    jstate.set_default_nu_dtype(None)
    set_default_mu_dtype(None)
    set_default_nu_dtype(None)


@pytest.mark.parametrize("mu,nu,b2,wd", [("bfloat16", "bfloat16", 0.99, 0.0),
                                         ("bfloat16", None, 0.999, 1e-2),
                                         (None, "bfloat16", 0.999, 0.0),
                                         (None, None, 0.99, 1e-2)])
def test_adam_moments_match_optax(dtypes, mu, nu, b2, wd):
    jstate.set_default_mu_dtype(jnp.bfloat16 if mu else None)
    jstate.set_default_nu_dtype(jnp.bfloat16 if nu else None)
    set_default_mu_dtype(mu)
    set_default_nu_dtype(nu)
    rng = np.random.default_rng(14)
    weights = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    tx = jstate.make_adam(1e-3, 0.9, b2, weight_decay=wd)
    jparams = [jnp.asarray(w) for w in weights]
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    params = [torch.tensor(w, requires_grad=True) for w in weights]
    opt = make_adam(params, 1e-3, 0.9, b2, weight_decay=wd)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) * 1e-2 for s in SHAPES]
        updates, opt_state = update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    assert int(adam.count) == 3
    for i, p in enumerate(params):
        state = opt.state[p]
        assert float(state["step"]) == 3.0
        for key, ref, want in (("exp_avg", adam.mu[i], mu), ("exp_avg_sq", adam.nu[i], nu)):
            assert state[key].dtype == (torch.bfloat16 if want else torch.float32)
            assert ref.dtype == (jnp.bfloat16 if want else jnp.float32)
            if want:  # bf16: bit for bit
                np.testing.assert_array_equal(state[key].float().numpy(),
                                              np.asarray(ref, np.float32), err_msg=key)
            else:  # f32: within MOMENT_TOL of 1 + |ref| (the fused multiply-add)
                np.testing.assert_allclose(state[key].numpy(), np.asarray(ref),
                                           rtol=MOMENT_TOL, atol=MOMENT_TOL, err_msg=key)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[i]),
                                   atol=WEIGHT_TOL, rtol=0)


def test_bf16_checkpoint_keeps_dtype_and_refuses_another(tmp_path, dtypes, monkeypatch):
    """A bf16-moment run's checkpoint holds bf16 moments; a resume with the same flags
    keeps them and steps on; a resume with float32 moments raises with the flag's name."""
    config = json.loads((ROOT / "configs" / "diffusion" / "ddpm_cifar10.json").read_text())
    config["model"]["args"].update(img_size=16, dim=16, dim_mults=[1, 2], use_bf16=False,
                                   diffusion_timesteps=10, sampling_timesteps=2)
    config["dataset"].update(img_size=16, batch_size=4, synthetic_size=40)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    argv = ["--config_path", str(path), "--device", "cpu", "--experiment_name", "run",
            "--mu_dtype", "bfloat16", "--nu_dtype", "bfloat16"]
    port_train.main(argv + ["--max_steps", "2"])
    ckpt = tmp_path / "experiments" / "DDPM" / "run" / "checkpoints" / "last"
    state = torch.load(ckpt, map_location="cpu", weights_only=True)["optimizer"]["state"]
    assert {s[k].dtype for s in state.values() for k in ("exp_avg", "exp_avg_sq")} == \
        {torch.bfloat16}
    model = port_train.main(argv + ["--max_steps", "4", "--resume"])
    assert model.step == 4
    assert {s["exp_avg"].dtype for s in model.optimizer.state.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="--mu_dtype"):
        port_train.main(argv[:-4] + ["--max_steps", "6", "--resume"])
    fresh = Adam([torch.zeros(3, requires_grad=True)], 1e-3, mu_dtype="bfloat16",
                 nu_dtype="bfloat16")
    with pytest.raises(ValueError, match="--nu_dtype"):
        fresh.load_state_dict({"state": {0: {"step": torch.tensor(1.0),
                                             "exp_avg": torch.zeros(3, dtype=torch.bfloat16),
                                             "exp_avg_sq": torch.zeros(3)}},
                               "param_groups": fresh.state_dict()["param_groups"]})
