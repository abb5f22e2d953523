"""Cases of the port's DDPM training (the train step, the trainer and the train entry point)
against the JAX package's, on the CPU, imported by ``test_torch_train.py``,
``test_torch_train_state.py``, ``test_torch_train_cli.py`` and
``test_torch_train_refusals.py``.

A tiny DDPM (UNet dim 16, dim_mults (1, 2), 16 px, f32) starts from one JAX
``TrainState`` (the weights drawn by the port, ``torch_flax_params``), loaded into the
port with ``load_flax_train_state``. The random draws
of a JAX step (flip, t, noise from ``fold_in(rng, step)``, then ``split`` 3 and 5)
are made with JAX's own key schedule and handed to the port, so both sides see the
same batch, flips, timesteps and noise. Everything is f32, so the two differ only in
the order of f32 sums.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.data import datamodule as jax_dm
from lightning_generative_models_tpu.data import datasets as jax_ds
from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu.ops.preprocess import prepare_batch as jax_prepare
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.data import datamodule as port_dm
from lightning_generative_models_tpu_torch.data import datasets as port_ds
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.ops.preprocess import prepare_batch
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.train.trainer import Trainer
from lightning_generative_models_tpu_torch.weights import load_flax_train_state
from torch_flax_params import as_port, state_from_port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODEL_ARGS = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, lr=1e-3)
B = 4


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX model, a TrainState and a uint8 batch."""
    model = JaxDDPM(**MODEL_ARGS)
    state = state_from_port(model, DDPM(**MODEL_ARGS, device="cpu"))
    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
             "label": np.zeros(B, np.int32)}
    return model, state, batch


@pytest.fixture(scope="module")
def jitted(jax_setup):
    """The JAX model's grad_step and apply_grad_step, jitted once for the module: its
    train_step is apply_grad_step(grad_step(...)), so the step tests share two compiles."""
    model = jax_setup[0]
    return jax.jit(model.grad_step), jax.jit(model.apply_grad_step)


def _draws(rng, step, shape):
    """A JAX step's random draws, made as ``grad_step`` and ``p_losses`` make them."""
    rng = jax.random.fold_in(rng, step)
    aug_rng, loss_rng, _ = jax.random.split(rng, 3)
    flip = jax.random.bernoulli(aug_rng, 0.5, (shape[0], 1, 1, 1))
    t_rng, noise_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jax.random.randint(t_rng, (shape[0],), 0, 1000)
    noise = jax.random.normal(noise_rng, shape)
    return {"flip": torch.tensor(np.asarray(flip).reshape(-1)),
            "t": torch.tensor(np.asarray(t).astype(np.int64)),
            "noise": torch.tensor(np.asarray(noise))}, loss_rng


def _port_model(state):
    ddpm = DDPM(**MODEL_ARGS, device="cpu")
    load_flax_train_state(ddpm, jax.device_get(state))
    return ddpm


def _rel_to_max(port, ref):
    return float((port - ref).abs().max() / (1.0 + ref.abs().max()))


def test_prepare_batch_and_p_losses_match_jax(jax_setup, jitted):
    """The flipped batch bit for bit, q_sample, and p_losses on JAX's draws: JAX's loss is
    its grad_step's on the same key (prepare_batch, then p_losses), the module's one
    compiled grad_step."""
    model, state, batch = jax_setup
    rng = jax.random.PRNGKey(7)
    draws, _ = _draws(rng, int(state.step), (B, 16, 16, 3))
    jflip = jnp.asarray(draws["flip"].numpy()).reshape(-1, 1, 1, 1)
    x01 = np.asarray(jax_prepare({"image": jnp.asarray(batch["image"])}, None)["image"])
    x01 = np.where(np.asarray(jflip), x01[:, :, ::-1], x01)
    port_x01 = prepare_batch({"image": torch.from_numpy(batch["image"])}, train=True,
                             flip=draws["flip"])["image"]
    np.testing.assert_array_equal(port_x01.numpy(), x01)

    ddpm = _port_model(state)
    t, noise = draws["t"], draws["noise"]
    xq = ddpm.diffusion.q_sample(ddpm.diffusion.normalize(port_x01), t, noise)
    jq = model.diffusion.q_sample(model.diffusion.normalize(jnp.asarray(x01)),
                                  jnp.asarray(t.numpy()), jnp.asarray(noise.numpy()))
    np.testing.assert_allclose(xq.numpy(), np.asarray(jq), atol=1e-6, rtol=1e-6)

    with torch.no_grad():
        loss = ddpm.diffusion.p_losses(ddpm._apply_fn(ddpm.unet), port_x01, t=t, noise=noise)
    _, jmetrics = jitted[0](state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    np.testing.assert_allclose(float(loss), float(jmetrics["loss"]), rtol=1e-5)


def test_grad_step_matches_jax_grad(jax_setup, jitted):
    """Loss and every parameter gradient, relative to the tensor's largest magnitude:
    a gradient is a sum over the batch and the pixels, so 1e-4 of its scale."""
    model, state, batch = jax_setup
    rng = jax.random.PRNGKey(3)
    draws, _ = _draws(rng, int(state.step), (B, 16, 16, 3))
    jgrads, jmetrics = jitted[0](
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    ddpm = _port_model(state)
    grads, metrics = ddpm.grad_step(batch, **draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for g, jg in zip(grads, as_port(ddpm.unet, jgrads)):
        assert _rel_to_max(g, jg) <= 1e-4


@pytest.mark.parametrize("step", [99, 100, 109, 110])
def test_apply_grad_step_matches_jax_across_ema_boundaries(jax_setup, jitted, step):
    """From a mid-run state (moments and EMA different from the weights) at step
    ``step``: the EMA copies at step 100, keeps at 101 and 111, decays at 110. The
    same grads go to both sides; weights, both Adam moments and the EMA match."""
    model, state, _ = jax_setup
    params = state.params["model"]
    grads = jax.tree_util.tree_map(
        lambda p: jnp.sin(jnp.arange(p.size, dtype=jnp.float32).reshape(p.shape)) * 1e-2,
        params)
    adam = state.opt_state["model"][0]._replace(
        count=jnp.asarray(step, jnp.int32),
        mu=jax.tree_util.tree_map(lambda g: g * 0.3, grads),
        nu=jax.tree_util.tree_map(lambda g: g * g * 0.5 + 1e-6, grads))
    state = state.replace(
        step=jnp.asarray(step, jnp.int32),
        opt_state={"model": (adam, *state.opt_state["model"][1:])},
        ema_params=jax.tree_util.tree_map(lambda p: p * 0.9 + 0.01, params))
    ddpm = _port_model(state)
    assert ddpm.step == step

    new_state, _ = jitted[1](state, grads, {"loss": jnp.float32(0.0)})
    ddpm.apply_grad_step(as_port(ddpm.unet, grads), {"loss": torch.tensor(0.0)})
    assert ddpm.step == int(new_state.step) == step + 1

    new_adam = new_state.opt_state["model"][0]
    checks = [
        (list(ddpm.unet.parameters()), new_state.params["model"]),
        (list(ddpm.ema_unet.parameters()), new_state.ema_params),
        ([ddpm.optimizer.state[p]["exp_avg"] for p in ddpm.unet.parameters()], new_adam.mu),
        ([ddpm.optimizer.state[p]["exp_avg_sq"] for p in ddpm.unet.parameters()],
         new_adam.nu),
    ]
    for port, ref in checks:
        for a, b in zip(port, as_port(ddpm.unet, ref)):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-6, rtol=1e-5)


def test_three_train_steps_match_jax(jax_setup, jitted):
    """Three full steps from the same state and draws. The per-step loss agrees within
    rtol 1e-4. Each step's update is compared as a whole,
    ||d_port - d_jax|| / ||d_jax|| <= 1e-3: Adam's first steps move every weight by
    about lr * sign(g), so a gradient element near zero, whose sign the order of f32
    sums can flip, moves its weight by up to 2 lr on one side only; element-wise
    bounds would test that noise, the update's norm does not."""
    _, state, batch = jax_setup
    rng = jax.random.PRNGKey(11)
    ddpm = _port_model(state)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_step, apply_grad_step = jitted
    for _ in range(3):
        before = [p.detach().clone() for p in ddpm.unet.parameters()]
        jbefore = as_port(ddpm.unet, state.params["model"])
        draws, _ = _draws(rng, int(state.step), (B, 16, 16, 3))
        state, jmetrics = apply_grad_step(state, *grad_step(state, jbatch, rng))
        metrics = ddpm.train_step(batch, **draws)
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(jmetrics["train_loss"]), rtol=1e-4)
        d_port = torch.cat([(p.detach() - b).reshape(-1)
                            for p, b in zip(ddpm.unet.parameters(), before)])
        d_jax = torch.cat([(a - b).reshape(-1) for a, b in
                           zip(as_port(ddpm.unet, state.params["model"]), jbefore)])
        assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-3
    assert ddpm.step == int(state.step) == 3


def test_load_flax_train_state_from_npz(jax_setup, tmp_path):
    """The README's route: flatten ``jax.device_get(state)`` with JAX's key paths into
    an ``.npz``; loading it fills the port as loading the tree itself does."""
    _, state, _ = jax_setup

    def name(k):
        return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))

    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    np.savez(tmp_path / "state.npz", **{"/".join(name(k) for k in path): np.asarray(v)
                                        for path, v in leaves})
    from_tree, from_npz = _port_model(state), DDPM(**MODEL_ARGS, device="cpu")
    load_flax_train_state(from_npz, tmp_path / "state.npz")
    assert from_npz.step == from_tree.step
    for a, b in zip(from_npz.state_dict()["unet"].values(),
                    from_tree.state_dict()["unet"].values()):
        assert torch.equal(a, b)
    for p_npz, p_tree in zip(from_npz.unet.parameters(), from_tree.unet.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(from_npz.optimizer.state[p_npz][key],
                               from_tree.optimizer.state[p_tree][key])


def test_synthetic_dataset_and_datamodule_match_jax():
    for train in (True, False):
        ours = port_ds.synthetic_dataset("CIFAR10", train, num_samples=64)
        theirs = jax_ds.synthetic_dataset("CIFAR10", train, num_samples=64)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    # 32 px: the main path's size, where neither side resizes (the JAX package resizes
    # through its native library, which the port's numpy path does not reproduce).
    kw = dict(name="CIFAR10", img_size=32, img_channels=3, batch_size=16,
              synthetic_size=96, data_dir="/nonexistent")
    ours, theirs = port_dm.DataModule(**kw), jax_dm.DataModule(**kw)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch()
    for split in ("train", "val", "test"):
        for epoch in (0, 3):
            a_it = (ours.train_batches(epoch) if split == "train"
                    else getattr(ours, f"{split}_batches")())
            b_it = (theirs.train_batches(epoch) if split == "train"
                    else getattr(theirs, f"{split}_batches")())
            pairs = list(zip(a_it, b_it))
            assert pairs
            for a, b in pairs:
                for key in ("image", "label"):
                    np.testing.assert_array_equal(a[key], b[key])


def test_grad_accum_scan_matches_concat(tmp_path):
    """Two micro-batches: summed micro-batch gradients (scan) and one step on the
    merged batch (concat) take the same step, from the same draws. The steps are
    compared as in test_three_train_steps_match_jax: Adam's first step is about
    lr * sign(g), so a near-zero gradient element whose sign the sum order flips
    moves one weight by 2 lr; the update's norm is what must agree."""
    rs = np.random.RandomState(5)
    micro = [{"image": torch.tensor(rs.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)),
              "label": torch.zeros(2, dtype=torch.long)} for _ in range(2)]
    draws = [{"flip": torch.tensor([True, False]), "t": torch.tensor([5 + i, 700]),
              "noise": torch.tensor(rs.randn(2, 16, 16, 3).astype(np.float32))}
             for i in range(2)]
    merged_draws = {k: torch.cat([d[k] for d in draws]) for k in draws[0]}
    merged = {k: torch.cat([m[k] for m in micro]) for k in micro[0]}
    dm = port_dm.DataModule("CIFAR10", 16, 3, batch_size=2)
    params = []
    start = [p.detach().clone() for p in DDPM(**MODEL_ARGS, device="cpu").unet.parameters()]
    for mode in ("concat", "scan"):
        model = DDPM(**MODEL_ARGS, device="cpu")
        calls = iter(draws)
        grad_step = model.grad_step
        model.grad_step = (
            (lambda batch, gen, f=grad_step: f(batch, **merged_draws)) if mode == "concat"
            else (lambda batch, gen, f=grad_step: f(batch, **next(calls))))
        trainer = Trainer(model, dm, tmp_path / mode, accumulate_grad_batches=2,
                          grad_accum_mode=mode)
        assert trainer.grad_accum_mode == mode
        trainer._train_step(merged if mode == "concat" else micro)
        trainer.logger.finish()
        params.append(torch.cat([(p.detach() - p0).reshape(-1)
                                 for p, p0 in zip(model.unet.parameters(), start)]))
    d_concat, d_scan = params
    assert float((d_scan - d_concat).norm() / d_concat.norm()) <= 1e-3


def test_grad_accum_auto_picks_by_merged_batch_size(tmp_path):
    model = DDPM(**MODEL_ARGS, device="cpu")
    small = port_dm.DataModule("CIFAR10", 16, 3, batch_size=8)
    huge = port_dm.DataModule("CIFAR10", 16, 3, batch_size=2**16)  # 2 x 192 MB merged
    for dm, path, mode in ((small, "a", "concat"), (huge, "b", "scan")):
        trainer = Trainer(model, dm, tmp_path / path, accumulate_grad_batches=2)
        trainer.logger.finish()
        assert trainer.grad_accum_mode == mode


def _tiny_config(tmp_path):
    config = {
        "model": {"name": "DDPM", "args": {
            "img_size": 16, "img_channels": 3, "dim": 16, "dim_mults": [1, 2],
            "diffusion_timesteps": 100, "sampling_timesteps": 2, "use_bf16": False,
            "lr": 1e-3}},
        "dataset": {"name": "CIFAR10", "img_size": 16, "img_channels": 3,
                    "batch_size": 8, "synthetic_size": 160, "data_dir": str(tmp_path)},
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    return path


def test_cpu_train_main_then_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    argv = ["--config_path", str(_tiny_config(tmp_path)), "--device", "cpu",
            "--experiment_name", "run", "--check_val_every_n_epoch", "1"]
    port_train.main(argv + ["--max_steps", "20"])
    run = tmp_path / "experiments" / "DDPM" / "run"
    ckpt = run / "checkpoints"
    last = json.loads((ckpt / "checkpoint_meta_last.json").read_text())
    best = json.loads((ckpt / "checkpoint_meta_best.json").read_text())
    assert last["step"] == 20 and best["step"] <= 20 and (ckpt / "best").exists()
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "train_loss" in r]
    assert train[0]["step"] == 0 and all(np.isfinite(r["train_loss"]) for r in train)
    assert all(r["images_per_sec"] > 0 for r in train)
    assert any("val_loss" in r for r in records)
    assert list((run / "samples").glob("random_generation_*.png"))

    model = port_train.main(argv + ["--max_steps", "25", "--resume"])
    assert model.step == 25
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    # Logged: the first step of a run and the last; the resumed run starts at 20.
    resumed = [r["step"] for r in records if "train_loss" in r][len(train):]
    assert resumed == [24]
    assert json.loads((ckpt / "checkpoint_meta_last.json").read_text())["step"] == 25

    # --ckpt_path starts another run from a given checkpoint, here 'best'.
    best = json.loads((ckpt / "checkpoint_meta_best.json").read_text())
    other = port_train.main(argv[:-4] + ["--experiment_name", "other", "--max_steps",
                                         str(best["step"] + 2), "--ckpt_path",
                                         str(ckpt / "best")])
    assert other.step == best["step"] + 2


def test_sigterm_saves_first_and_skips_validation(tmp_path, monkeypatch):
    """SIGTERM mid-epoch: the trainer stops after the step, saves 'last' with the
    current epoch (so the epoch is retried) and neither validates nor samples."""
    import os
    import signal

    model = DDPM(**MODEL_ARGS, device="cpu")
    dm = port_dm.DataModule("CIFAR10", 16, 3, batch_size=4, synthetic_size=64,
                            data_dir=str(tmp_path))
    trainer = Trainer(model, dm, tmp_path / "run", max_steps=50,
                      check_val_every_n_epoch=1)
    step = model.train_step

    def train_step(batch, generator):
        if model.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(batch, generator)

    model.train_step = train_step
    trainer.fit()
    trainer.logger.finish()
    meta = json.loads((tmp_path / "run" / "checkpoints" / "checkpoint_meta_last.json")
                      .read_text())
    assert (meta["step"], meta["epoch"]) == (3, 0)
    records = [json.loads(line) for line in
               (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert not any("val_loss" in r for r in records)
    assert not list((tmp_path / "run" / "samples").glob("*.png"))


@pytest.mark.parametrize("flags", [
    ["--strategy", "fsdp"], ["--strategy", "tp"], ["--strategy", "pp"],
    ["--eval", "test", "--strategy", "fsdp"],
    ["--config_path", str(ROOT / "configs" / "diffusion" / "dit_cifar10_pp.json")],
])
def test_refused_flags_raise_not_implemented(tmp_path, monkeypatch, flags):
    """The flags the port once refused run as the root ``train.py``'s: ``fsdp`` trains two
    steps and evaluates the test split in one process (a mesh of one rank); ``tp`` and
    ``pp`` on a UNet, and ``dit_cifar10_pp.json``'s 4 stages on a 1-way stage axis, raise
    the JAX trainer's ``ValueError``s."""
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    argv = ["--config_path", str(_tiny_config(tmp_path)), "--device", "cpu"] + flags
    if flags[-1].endswith("dit_cifar10_pp.json"):
        with pytest.raises(ValueError, match="pipeline_stages=4 does not match the 1-way"):
            port_train.main(argv + ["--strategy", "pp"])
    elif flags[-1] in ("tp", "pp"):
        with pytest.raises(ValueError, match=f"strategy='{flags[-1]}' supports the DiT"):
            port_train.main(argv)
    elif "--eval" in flags:
        metrics = port_train.main(argv)
        assert np.isfinite(metrics["test_loss"])
    else:
        model = port_train.main(argv + ["--max_steps", "2"])
        assert model.step == 2


def test_prepare_batch_pallas_backend_matches_default_on_cpu():
    """On a CPU batch ``backend="pallas"`` takes ``fused_normalize_flip``'s plain version
    (f32 math, one rounding), which in f32 equals the default path bit for bit, flips
    where asked and scales without flipping at eval time; an unknown backend raises."""
    from lightning_generative_models_tpu_torch.ops.preprocess import fused_normalize_flip

    image = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (3, 4, 5, 3))
                             .astype(np.uint8))
    flip = torch.tensor([True, False, True])
    for train in (True, False):
        fused = prepare_batch({"image": image}, train=train, flip=flip, backend="pallas")
        xla = prepare_batch({"image": image}, train=train, flip=flip)
        assert torch.equal(fused["image"], xla["image"])
    bf16 = prepare_batch({"image": image}, train=True, flip=flip, backend="pallas",
                         dtype=torch.bfloat16)["image"]
    assert torch.equal(bf16, fused_normalize_flip(image, flip, torch.bfloat16))
    scaled = image.float() * (1.0 / 255.0)
    assert torch.equal(bf16, scaled.flip(2).where(flip.reshape(-1, 1, 1, 1), scaled)
                       .to(torch.bfloat16))
    with pytest.raises(ValueError, match="unknown backend"):
        prepare_batch({"image": image}, backend="triton")
