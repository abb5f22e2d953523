"""The port's VQ-VAE (plain and EMA codebook) and VQGAN against the JAX package, on the CPU.

Each JAX model is built once, at a tiny width (hidden 32, residual hiddens 8,
embedding 8, 16 codes, 32 px, batch 4, f32), and its ``TrainState`` is loaded into the
port with ``load_flax_train_state``. A JAX step draws its flip from
``fold_in(rng, step)``; the same mask is handed to the port, so both sides see the
same images. The two then differ only in the order of f32 sums: each step's update is
compared by its norm (see ``test_torch_train.py``: Adam's first steps move a weight by
about lr * sign(g), and a near-zero gradient's sign is sum-order noise).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.registry import load_model as jax_load_model
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.weights import (
    _TRANSFORMS,
    flatten_tree,
    flax_paths,
    load_flax_train_state,
)

torch.set_num_threads(1)

B = 4
ARGS = {"img_channels": 3, "img_size": 32, "embedding_dim": 8, "num_embeddings": 16,
        "hidden_dim": 32, "num_residual_layers": 1, "num_residual_hiddens": 8,
        "commitment_cost": 0.25, "lr": 1e-3, "b1": 0.9, "weight_decay": 1e-5,
        "loss_weights": {"recon_loss": 1.0, "vq_loss": 1.0}}
CONFIGS = {
    "vqvae": {"name": "VQVAE", "args": {**ARGS, "use_ema": False}},
    "vqvae_ema": {"name": "VQVAE", "args": {**ARGS, "use_ema": True, "decay": 0.9}},
    "vqgan": {"name": "VQGAN", "args": {**ARGS, "use_ema": False, "disc_start": 1}},
    "vqgan_ema": {"name": "VQGAN", "args": {**ARGS, "use_ema": True, "decay": 0.9,
                                            "disc_start": 1}},
}
RNG = jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    return {"image": rs.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
            "label": np.zeros(B, np.int32)}


@pytest.fixture(scope="module")
def jax_models():
    """name -> (JAX model, its initial TrainState, its jitted train step), built once.
    A VQ-VAE's state is its VQGAN's without the discriminator (the same tree, for one
    init compile less)."""
    out = {}
    for gan in ("vqgan", "vqgan_ema"):
        model = jax_load_model(CONFIGS[gan])
        state = jax.jit(model.init_state)(jax.random.PRNGKey(1))
        out[gan] = (model, state, jax.jit(model.train_step))
        vae = jax_load_model(CONFIGS[gan.replace("vqgan", "vqvae")])
        vae_state = state.replace(
            params={k: v for k, v in state.params.items() if k != "disc"},
            opt_state={"model": state.opt_state["model"]})
        out[gan.replace("vqgan", "vqvae")] = (vae, vae_state, jax.jit(vae.train_step))
    return out


def _flip(step):
    """The JAX step's flip mask, [B] bool."""
    mask = jax.random.bernoulli(jax.random.fold_in(RNG, step), 0.5, (B, 1, 1, 1))
    return torch.tensor(np.asarray(mask).reshape(-1))


def _port(name, state):
    model = load_model(CONFIGS[name], device="cpu")
    load_flax_train_state(model, jax.device_get(state))
    return model


def _pairs(model, state):
    """(kind, tree prefix, port tensor, JAX value in the port's layout) for every weight
    and codebook buffer."""
    flat = flatten_tree(jax.device_get(state))
    layout = model.flax_layout()
    out = []
    for kind, buffers in (("params", False), ("buffers", True)):
        for prefix, module in layout[kind].items():
            for path, (t, tr) in flax_paths(module, buffers).items():
                ref = _TRANSFORMS[tr](np.asarray(flat[f"{prefix}/{path}"], np.float32))
                out.append((kind, prefix, t.detach().clone(), torch.tensor(ref)))
    return out


def _check_step(before, after, metrics, jmetrics):
    """Every metric; each module's update by its norm (a masked discriminator's update
    is exactly 0 on both sides); the EMA codebook's buffers element by element."""
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    updates = {}
    for (kind, prefix, p0, j0), (_, _, p1, j1) in zip(before, after):
        if kind == "buffers":
            np.testing.assert_allclose(p1.numpy(), j1.numpy(), atol=1e-5, rtol=1e-5)
            continue
        d_port, d_jax = updates.setdefault(prefix, ([], []))
        d_port.append((p1 - p0).reshape(-1))
        d_jax.append((j1 - j0).reshape(-1))
    for prefix, (d_port, d_jax) in updates.items():
        d_port, d_jax = torch.cat(d_port), torch.cat(d_jax)
        if float(d_jax.norm()) == 0.0:
            assert float(d_port.norm()) == 0.0, prefix
        else:
            assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-3, prefix


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_train_steps_match_jax(jax_models, batch, name):
    """Loss, every metric, each step's update and the EMA codebook; the VQGANs step
    once before disc_start (d_loss 0, the adversarial term masked) and twice after.
    Each VQGAN step starts from JAX's state: the discriminator's first Adam steps move
    each of its 2.7M weights by about lr * sign(g), so a weight whose gradient is near
    0 moves by sum-order noise, and the next step's logits, gradient norms and adaptive
    weight carry it (1e-2 relative after two steps)."""
    jmodel, state, train_step = jax_models[name]
    model = _port(name, state)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        if name.startswith("vqgan"):
            load_flax_train_state(model, jax.device_get(state))
        before = _pairs(model, state)
        step = int(state.step)
        state, jmetrics = train_step(state, jbatch, RNG)
        metrics = model.train_step(batch, flip=_flip(step))
        _check_step(before, _pairs(model, state), metrics, jmetrics)
        if name.startswith("vqgan"):
            assert (float(metrics["train_d_loss"]) == 0.0) == (step == 0)
    assert model.step == int(state.step) == 3


@pytest.mark.parametrize("name", ["vqvae", "vqvae_ema", "vqgan"])
def test_eval_reconstruct_and_decode_match_jax(jax_models, batch, name):
    jmodel, state, train_step = jax_models[name]
    state, _ = train_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, RNG)
    model = _port(name, state)
    jmetrics = jmodel.eval_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, RNG)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    metrics = model.eval_step(batch)
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5, err_msg=key)
    for k, v in model.net.state_dict().items():  # eval moves no codebook
        assert torch.equal(v, before[k])

    # Images in [0, 1] from f32 conv stacks summed in another order: 5e-5.
    ref = np.asarray(jmodel.reconstruct(state, {"image": jnp.asarray(batch["image"])}))
    np.testing.assert_allclose(model.reconstruct(batch).numpy(), ref, atol=5e-5)

    idx = np.random.RandomState(1).randint(0, 16, (3, 4, 4))
    codebook = jmodel._codebook(state)
    jdec = jmodel.to_image_space(jmodel.decoder.apply(
        {"params": state.params["decoder"]}, codebook[jnp.asarray(idx)]))
    np.testing.assert_allclose(model.decode_codes(torch.tensor(idx)).numpy(),
                               np.asarray(jdec), atol=5e-5)
    images = model.sample(torch.Generator().manual_seed(0), 5)
    assert images.shape == (5, 32, 32, 3)
    assert 0.0 <= float(images.min()) <= float(images.max()) <= 1.0
    np.testing.assert_allclose(model.codebook_table(), np.asarray(codebook), atol=0)


@pytest.mark.parametrize("name", ["vqvae_ema", "vqgan"])
def test_train_state_npz_loads_and_next_step_matches_jax(jax_models, batch, tmp_path, name):
    """A JAX TrainState one step in (Adam moments and the EMA codebook moved), flattened
    to an .npz with JAX's key paths as the README says, loads through
    load_flax_train_state, and the next step matches JAX's."""
    jmodel, state, train_step = jax_models[name]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, _ = train_step(state, jbatch, RNG)

    def key_name(k):
        return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))

    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    np.savez(tmp_path / "state.npz", **{"/".join(key_name(k) for k in path): np.asarray(v)
                                        for path, v in leaves})
    model = load_model(CONFIGS[name], device="cpu")
    load_flax_train_state(model, tmp_path / "state.npz")
    assert model.step == 1

    # generate --weights reads the same file: the loaded model's random-code grid.
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"model": CONFIGS[name], "dataset": {}}))
    images = generate.main(["--config_path", str(config), "--num_samples", "4", "--device",
                            "cpu", "--weights", str(tmp_path / "state.npz"), "--out",
                            str(tmp_path / "out")])
    np.testing.assert_array_equal(
        images, model.sample(torch.Generator().manual_seed(0), 4).numpy())
    before = _pairs(model, state)
    state, jmetrics = train_step(state, jbatch, RNG)
    metrics = model.train_step(batch, flip=_flip(1))
    _check_step(before, _pairs(model, state), metrics, jmetrics)


def test_vqgan_perceptual_weight_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model({"name": "VQGAN", "args": {**ARGS, "perceptual_weight": 0.1}},
                   device="cpu")


def _tiny_config(tmp_path):
    path = tmp_path / "vqvae_tiny.json"
    path.write_text(json.dumps({
        "model": CONFIGS["vqvae_ema"],
        "dataset": {"name": "CIFAR10", "img_size": 32, "img_channels": 3, "batch_size": 8,
                    "synthetic_size": 40, "data_dir": str(tmp_path)},
    }))
    return path


def test_cpu_train_main_then_resume_and_generate(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = _tiny_config(tmp_path)
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1", "--precision", "bf16"]
    model = port_train.main(argv + ["--max_steps", "3"])
    assert model.step == 3
    run = tmp_path / "experiments" / "VQVAE" / "run"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_loss" in r] == [0, 2]
    assert any("val_perplexity" in r for r in records)
    table = json.loads(next(run.glob("codebook_*.json")).read_text())
    assert len(table["rows"]) == 16 and len(table["columns"]) == 8
    assert list((run / "samples").glob("random_generation_*.png"))
    for which in ("last", "best"):
        assert (run / "checkpoints" / f"checkpoint_meta_{which}.json").exists()

    resumed = port_train.main(argv + ["--max_steps", "5", "--resume"])
    assert resumed.step == 5
    meta = json.loads((run / "checkpoints" / "checkpoint_meta_last.json").read_text())
    assert meta["step"] == 5

    out = tmp_path / "generated"
    images = generate.main(["--config_path", str(config), "--num_samples", "4",
                            "--device", "cpu", "--out", str(out)])
    assert images.shape == (4, 32, 32, 3) and (out / "grid.png").exists()
    for flags in (["--sampler", "ddim"], ["--sampling_steps", "3"], ["--label", "1"]):
        with pytest.raises(SystemExit):
            generate.main(["--config_path", str(config), "--device", "cpu"] + flags)
