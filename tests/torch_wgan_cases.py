"""Cases of the port's WGAN (gp and clip), LSGAN and R1GAN against the JAX package, on the
CPU, imported by ``test_torch_wgan.py`` (WGAN-GP), ``test_torch_wgan_clip.py``,
``test_torch_lsgan.py`` and ``test_torch_r1gan.py``.
on the CPU.

Each model is built once, in f32 at batch 8, from its config under configs/gan/ on the
DCGAN nets' 28-px branch (G 256 -> 128, D 64 -> 128): ``wgan_gp.json`` and
``wgan_cp.json`` with n_critic 2 (three steps are D, D, G), ``lsgan.json`` (latent 100,
not its 1024: that Dense alone would be 12.8M weights) and ``r1gan.json`` at 28 px with
one channel. The port draws the weights and hands them to
JAX; each JAX step's flip, z and alpha are drawn as the JAX step draws them and handed to
the port (``torch_gan_check`` says what a step's check compares). The references of the
other tests (eval_step, the penalties) are computed in the step's program, on JAX's state
three steps in.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gan_check as gc
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.train.state import make_rmsprop

torch.set_num_threads(1)

B = gc.B
CONFIGS = {
    "wgan_gp": gc.config("wgan_gp.json", n_critic=2),
    "wgan_cp": gc.config("wgan_cp.json", n_critic=2),
    "lsgan": gc.config("lsgan.json", img_size=28, img_channels=1, latent_dim=100,
                       use_bf16=False),
    "r1gan": gc.config("r1gan.json", img_size=28, img_channels=1),
}


# JAX's generator calls in a step -> the port's: the GAN base and WGAN's branches run G
# on the same z twice (the fake batch, then inside G's gradient), the port once.
CALLS = (0, 0)


def _batch(name):
    return gc.labelled_batch(CONFIGS[name]["args"])


# The penalties' inputs: an image batch and another to interpolate with.
_RS = np.random.RandomState(5)
PENALTY_INPUTS = {k: _RS.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
                  for k in ("x", "x_hat")}
PENALTY_KEY = jax.random.PRNGKey(9)


@pytest.fixture(scope="module")
def built():
    """name -> (JAX model, TrainState)."""
    return {name: gc.build(cfg) for name, cfg in CONFIGS.items()}


def _refs(jmodel, state, batch, rng, inputs):
    """eval_step and the z it draws; WGAN-GP's penalty (and its alpha) and R1's, on D's
    running statistics."""
    out = {"eval": jmodel.eval_step(state, batch, rng),
           "eval_z": jmodel.sample_z(jax.random.fold_in(rng, 1), B)}
    d = (state.params["D"], state.mutable["D"])
    if getattr(jmodel, "constraint_method", None) == "gp":
        out["penalty"] = jmodel._gradient_penalty(*d, inputs["x"], inputs["x_hat"], PENALTY_KEY)
        out["alpha"] = jax.random.uniform(PENALTY_KEY, (B, 1, 1, 1), jnp.float32)
    elif hasattr(jmodel, "_r1"):
        out["penalty"] = jmodel._r1(*d, inputs["x"])
    return out


@pytest.fixture(scope="module")
def stepped(built):
    """name -> (JAX's state after the three steps that the port is held to, run once;
    ``_refs`` on it)."""
    states = {}

    def get(name):
        if name not in states:
            states[name] = gc.run_steps(built[name], CONFIGS[name], _batch(name), _draws,
                                        CALLS, refs=_refs, inputs=PENALTY_INPUTS)
        return states[name]

    return get


@functools.partial(jax.jit, static_argnums=(1, 2))
def _draw(step, latent_dim, wgan):
    """The flip, z (and WGAN's alpha) that the JAX step at ``step`` draws."""
    rng_aug, rng_z, rng_gp = jax.random.split(jax.random.fold_in(gc.RNG, step), 3)
    flip = jax.random.bernoulli(rng_aug, 0.5, (B, 1, 1, 1))
    z = jax.random.normal(rng_z, (B, latent_dim))
    alpha = jax.random.uniform(rng_gp, (B, 1, 1, 1), jnp.float32) if wgan else None
    return flip, z, alpha


def _draws(jmodel, step):
    flip, z, alpha = _draw(step, jmodel.latent_dim, hasattr(jmodel, "n_critic"))
    out = {"flip": torch.tensor(np.asarray(flip).reshape(-1)), "z": torch.tensor(np.asarray(z))}
    if alpha is not None:
        out["alpha"] = torch.tensor(np.asarray(alpha))
    return out


def test_make_rmsprop_matches_optax():
    """Five updates of two tensors, one with gradients shrinking to 1e-4, the other's at
    1e-3 (0.01 g^2 near eps): within 1e-6 of optax.rmsprop (eps inside the square root),
    where torch's RMSprop (eps outside) moves the second by ~1e-3 more."""
    rs = np.random.RandomState(3)
    params = [rs.randn(5, 4).astype(np.float32), rs.randn(7).astype(np.float32)]
    grads = [[rs.randn(5, 4).astype(np.float32) * 10.0 ** -k,
              rs.randn(7).astype(np.float32) * 1e-3] for k in range(5)]
    opt = optax.rmsprop(learning_rate=1e-3, decay=0.99, eps=1e-8)

    @jax.jit
    def updates(jparams, jgrads):  # the five updates in one program
        state, out = opt.init(jparams), []
        for g in jgrads:
            step, state = opt.update(g, state, jparams)
            jparams = optax.apply_updates(jparams, step)
            out.append(jparams)
        return out

    refs = updates(params, grads)
    ours = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    theirs = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    optimizers = (make_rmsprop(ours, 1e-3),
                  torch.optim.RMSprop(theirs, lr=1e-3, alpha=0.99, eps=1e-8))
    for g, jparams in zip(grads, refs):
        for tensors, optimizer in zip((ours, theirs), optimizers):
            for p, x in zip(tensors, g):
                p.grad = torch.tensor(x)
            optimizer.step()
        for p, ref in zip(ours, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)
    assert float(np.abs(theirs[1].detach().numpy() - np.asarray(jparams[1])).max()) > 1e-3


def test_penalty_alone_matches_jax(stepped, name):
    """The gradient penalty (WGAN) and the R1 penalty on D's running statistics three steps
    in, D in eval mode inside the penalty: 1e-5 of 1 + |ref|."""
    state, refs = stepped(name)
    model = gc.port_model(CONFIGS[name], state)
    x, x_hat = (torch.tensor(PENALTY_INPUTS[k]) for k in ("x", "x_hat"))
    model.D.train()
    if name == "wgan_gp":
        out = model.gradient_penalty(x, x_hat, torch.tensor(np.asarray(refs["alpha"])))
    else:
        out = model._r1(x)
    assert model.D.training  # the mode is restored
    gc.check_close(out.detach(), refs["penalty"], 1e-5)
    assert float(refs["penalty"]) > 0


def test_three_train_steps_match_jax(stepped, name):
    """Three steps (WGAN: D, D, G), each from JAX's state: the metrics, each weight's
    gradient and update, G's and D's running statistics. WGAN's G statistics stay put on
    the D steps and move once on the G step; the penalties' eval-mode D passes read D's
    statistics as the two train passes left them, and differentiate through them."""
    assert int(stepped(name)[0].step) == 3


def test_wgan_interleave_and_statistics():
    """Steps 0 and 1 update D only (G's weights and statistics as they were, D's
    statistics moved), step 2 updates G only (D's weights as they were, both nets'
    statistics moved): the step counter picks the branch on the host."""
    model = gc.port_model(CONFIGS["wgan_gp"])
    batch = _batch("wgan_gp")
    for step in range(3):
        before = {k: {n: t.clone() for n, t in net.state_dict().items()}
                  for k, net in model.nets().items()}
        d_step = model.is_d_step()
        metrics = model.train_step(batch, torch.Generator().manual_seed(step))
        after = {k: net.state_dict() for k, net in model.nets().items()}
        assert d_step == (step < 2)
        for net, moved in (("G", not d_step), ("D", True)):
            for n, t in before[net].items():
                changed = not torch.equal(after[net][n], t)
                if n.endswith((".mean", ".var")):
                    assert changed == moved, (net, n)
                elif net == ("D" if not d_step else "G"):
                    assert not changed, (net, n)
        zero = "train_g_loss" if d_step else "train_d_loss"
        assert float(metrics[zero]) == 0.0 and len(metrics) == 5


def test_weight_clipping_bounds_every_d_weight(built):
    """After a clip D step every D weight (BatchNorm's scale and bias too) lies in
    [-clip_value, clip_value] and some sit on the bounds; the buffers are not clipped."""
    model = gc.port_model(CONFIGS["wgan_cp"], built["wgan_cp"][1])
    c = model.clip_value
    model.train_step(_batch("wgan_cp"), torch.Generator().manual_seed(0))
    weights = torch.cat([p.detach().reshape(-1) for p in model.D.parameters()])
    assert float(weights.abs().max()) <= c
    assert int((weights.abs() == c).sum()) > 0
    assert float(torch.cat([b.reshape(-1) for b in model.D.buffers()]).abs().max()) > c


def test_eval_step_matches_jax(stepped, name):
    """eval_step on the running statistics (three steps in), with no penalty: the metrics
    within 1e-5."""
    state, refs = stepped(name)
    model = gc.port_model(CONFIGS[name], state)
    z = torch.tensor(np.asarray(refs["eval_z"]))
    gc.check_metrics(model.eval_step(_batch(name), z=z), refs["eval"])


def test_rmsprop_state_npz_loads_as_the_tree(stepped, tmp_path):
    """A WGAN-clip TrainState three steps in (both RMSprops' nu), flattened to an .npz,
    loads through load_flax_train_state into the same state as the tree, from which the
    three-step test's steps match JAX's."""
    model = gc.check_npz_loads(CONFIGS["wgan_cp"], stepped("wgan_cp")[0], tmp_path)
    assert model.is_d_step() and all("nu" in s for s in model.optimizers["D"].state.values())


def test_checkpoint_round_trip_continues_bit_for_bit(tmp_path, name):
    flat = gc.checkpoint_round_trip(CONFIGS[name], _batch(name), tmp_path)
    kind = "nu" if name == "wgan_cp" else "exp_avg"
    assert any(kind in k for k in flat) and any(k.endswith(".mean") for k in flat)


def test_cpu_train_main_then_resume_and_generate(tmp_path, monkeypatch):
    """train on wgan_gp.json at 28 px with 4 steps an epoch (n_critic 5: D steps and one G
    step), then a --resume; the logged losses are finite, val_g_loss picks 'best', and
    generate writes a grid from the checkpoint's config."""
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = tmp_path / "wgan_tiny.json"
    config.write_text(json.dumps({
        "model": gc.config("wgan_gp.json"),
        "dataset": {"name": "MNIST", "img_size": 28, "img_channels": 1, "batch_size": 8,
                    "synthetic_size": 40, "data_dir": str(tmp_path)},
    }))
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1", "--sample_every_n_steps", "0"]
    assert port_train.main(argv + ["--max_steps", "4"]).step == 4
    assert port_train.main(argv + ["--max_steps", "6", "--resume"]).step == 6
    run_dir = tmp_path / "experiments" / "WGAN" / "run"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "train_d_loss" in r]
    assert [r["step"] for r in train] == [0, 3, 5]
    assert train[-1]["train_g_loss"] != 0.0  # step 5 is the G step
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k.startswith("val_"))
    meta = json.loads((run_dir / "checkpoints" / "checkpoint_meta_last.json").read_text())
    assert meta["step"] == 6 and meta["monitor"] == "val_g_loss"
    images = generate.main(["--config_path", str(config), "--num_samples", "4", "--device",
                            "cpu", "--out", str(tmp_path / "generated")])
    assert images.shape == (4, 28, 28, 1) and 0.0 <= images.min() <= images.max() <= 1.0
