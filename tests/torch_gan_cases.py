"""Cases of the port's GAN and DCGAN against the JAX package's, on the CPU, imported by
``test_torch_gan.py``, ``test_torch_gan_mlp.py`` and ``test_torch_dcgan.py``.

Each JAX model is built once, in f32, at batch 8, from its config under configs/gan/: the
MLP GAN of ``gan.json`` (28 px, one channel), DCGAN at its full widths at 32 px
(``dcgan_cifar10.json``: G 1024 -> 128, D 64 -> 512) and at 28 px (``dcgan_mnist.json``).
The weights are drawn by the port (``torch_flax_params``) and handed to JAX as its
``TrainState``. A JAX step draws its flip and z from ``fold_in(rng, step)`` split three
ways; the same flip and z are handed to the port, so both sides see the same inputs and
differ only in the order of f32 sums. Each step's gradients (from the two Adams' first
moments) and updates are compared weight by weight by their norms, the updates without
the few elements whose gradient is within that f32 noise of 0 (Adam's first steps move
a weight by about lr * sign(g): ROADMAP.md, Queue 3); the batch statistics element by
element.
"""

import functools
import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.registry import load_model as jax_load_model
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.models.gan.gan import MLPGenerator
from lightning_generative_models_tpu_torch.models.modules.layers import BatchNorm
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.weights import (
    _TRANSFORMS,
    _adam_path,
    flatten_tree,
    flax_paths,
    load_flax_train_state,
)
from torch_flax_params import state_from_port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B = 8


def _config(path, **args):
    """The model section of a config under configs/gan/, its args updated by ``args``."""
    model = json.loads((ROOT / "configs" / "gan" / path).read_text())["model"]
    return {"name": model["name"], "args": {**model["args"], **args}}


# The configs' own hyperparameters, in f32.
CONFIGS = {
    "gan": _config("gan.json"),
    "gan_min_max": _config("gan.json", loss_type="min-max"),
    "dcgan": _config("dcgan_cifar10.json", use_bf16=False),
    "dcgan28": _config("dcgan_mnist.json", use_bf16=False),
}
RNG = jax.random.PRNGKey(7)


def _batch(name):
    args = CONFIGS[name]["args"]
    shape = (B, args["img_size"], args["img_size"], args["img_channels"])
    return {"image": np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8),
            "label": np.zeros(B, np.int32)}


@pytest.fixture(scope="module")
def jax_models():
    """name -> (JAX model, the port model, the TrainState with the port's weights, the
    jitted train step), built once for the module."""
    out = {}
    for name, config in CONFIGS.items():
        jmodel = jax_load_model(config)
        model = load_model(config, device="cpu")
        out[name] = (jmodel, model, state_from_port(jmodel, model), jax.jit(jmodel.train_step))
    return out


@functools.partial(jax.jit, static_argnums=1)
def _draw_arrays(step, latent_dim):
    rng_aug, rng_z, _ = jax.random.split(jax.random.fold_in(RNG, step), 3)
    return (jax.random.bernoulli(rng_aug, 0.5, (B, 1, 1, 1)),
            jax.random.normal(rng_z, (B, latent_dim)))


def _draws(jmodel, step):
    """A JAX train step's flip [B] and z, drawn as ``GAN.train_step`` draws them."""
    flip, z = _draw_arrays(step, jmodel.latent_dim)
    return torch.tensor(np.asarray(flip).reshape(-1)), torch.tensor(np.asarray(z))


def _port(name, state):
    model = load_model(CONFIGS[name], device="cpu")
    load_flax_train_state(model, jax.device_get(state))
    return model


def _pairs(model, state):
    """(kind, flax path, port tensor, JAX value in the port's layout) for every weight and
    every batch statistic."""
    flat = flatten_tree(jax.device_get(state))
    out = []
    layout = model.flax_layout()
    for kind, buffers in (("params", False), ("buffers", True)):
        for prefix, module in layout[kind].items():
            for path, (t, tr) in flax_paths(module, buffers).items():
                ref = _TRANSFORMS[tr](np.asarray(flat[f"{prefix}/{path}"], np.float32))
                out.append((kind, f"{prefix}/{path}", t.detach().clone(), torch.tensor(ref)))
    return out


def _zero_grad_bias(model, path):
    """A bias of the MLP generator's Dense_0-2, each right before a BatchNorm over [B, F]:
    the batch mean cancels it, so its gradient is exactly 0 and both frameworks return f32
    noise there, which Adam turns into moves of +-lr with a random sign. (DCGAN's seed bias
    is per position and channel, and BatchNorm_0 cancels only its mean over positions.)"""
    return isinstance(model.G, MLPGenerator) and path.startswith("params/G/Dense_") \
        and path.endswith("/bias") and "Dense_3" not in path


def _jax_moments(state):
    """{flax path of a weight: JAX's Adam first moment of it, in the port's layout}."""
    flat = flatten_tree(jax.device_get(state))
    out = {}
    for net in ("G", "D"):
        adam = _adam_path(flat, f"opt_state/{net}")
        for key, value in flat.items():
            if key.startswith(f"{adam}/mu/"):
                out[f"params/{net}/{key[len(adam) + 4:]}"] = value
    return out


def _port_moments(model):
    """{flax path of a weight: the port's Adam first moment of it (0 before its first
    step)}, in the port's layout."""
    out = {}
    for net in ("G", "D"):
        state = model.optimizers[net].state
        for path, (p, _) in flax_paths(getattr(model, net)).items():
            m = state.get(p, {}).get("exp_avg")
            out[f"params/{net}/{path}"] = torch.zeros(p.shape) if m is None else m.clone()
    return out


def _check_step(model, state0, state1, before, moments0, metrics, jmetrics):
    """Every metric; the batch statistics element by element; each weight's gradient
    (weight decay included, from the two Adams' first moments: g = (m1 - b1 m0) / (1 - b1))
    and its update by their norms, the update leaving out the elements where either side's
    new first moment m1 is smaller than their difference (a gradient within f32 noise of
    0, or of cancelling the moment it adds to): Adam moves those by up to +-lr with the
    sign and size of that noise. They are at most 1% of the weights."""
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    b1 = model.betas[0]
    jm0, jm1, pm1 = _jax_moments(state0), _jax_moments(state1), _port_moments(model)
    left_out, elements = 0, 0
    for (kind, path, p0, j0), (_, _, p1, j1) in zip(before, _pairs(model, state1)):
        if kind == "buffers":
            np.testing.assert_allclose(p1.numpy(), j1.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=path)
            continue
        if _zero_grad_bias(model, path):
            continue
        tr = flax_paths_transform(model, path)
        m_jax, m0_jax = (torch.tensor(_TRANSFORMS[tr](jm[path])) for jm in (jm1, jm0))
        g_jax = (m_jax - b1 * m0_jax) / (1 - b1)
        g_port = (pm1[path] - b1 * moments0[path]) / (1 - b1)
        assert float((g_port - g_jax).norm()) <= 1e-3 * float(g_jax.norm()), path
        keep = (pm1[path] - m_jax).abs() < torch.minimum(m_jax.abs(), pm1[path].abs())
        left_out += int((~keep).sum())
        elements += keep.numel()
        d_jax = (j1 - j0) * keep
        assert float(((p1 - p0) * keep - d_jax).norm()) <= 1e-3 * float(d_jax.norm()), path
    assert left_out <= 1e-2 * elements


def flax_paths_transform(model, path):
    """The transform of the weight at flax ``path`` (from the flax layout to the port's)."""
    net, rest = path.split("/", 2)[1:]
    return flax_paths(getattr(model, net))[rest][1]


@pytest.mark.parametrize("case", ["nhwc", "features", "nhwc_bf16"])
def test_batchnorm_matches_flax(case):
    """Train mode three times (the output and the running mean and biased variance after
    each), then eval mode on the running statistics; statistics in f32 on a bf16 input."""
    shape = (4, 3, 5, 6) if case.startswith("nhwc") else (8, 6)
    rs = np.random.RandomState(1)
    xs = [rs.randn(*shape).astype(np.float32) * 2.0 + 0.5 for _ in range(4)]
    dtype = jnp.bfloat16 if case.endswith("bf16") else jnp.float32
    bn = BatchNorm(6, scale_std=0.02)
    bn.reset_parameters(torch.Generator().manual_seed(0))
    flax_bn = fnn.BatchNorm(dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(rs.randn(6).astype(np.float32))},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    bn.bias.data.copy_(torch.tensor(np.asarray(variables["params"]["bias"])))

    def port_in(x):
        return torch.tensor(np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)

    bn.train()
    for x in xs[:3]:
        ref, updated = flax_bn.apply(variables, jnp.asarray(x, dtype), use_running_average=False,
                                     mutable=["batch_stats"])
        variables = {**variables, **updated}
        out = bn(port_in(x))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
        for key in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, key).numpy(),
                                       np.asarray(variables["batch_stats"][key]),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
    bn.eval()
    ref = flax_bn.apply(variables, jnp.asarray(xs[3], dtype), use_running_average=True)
    np.testing.assert_allclose(bn(port_in(xs[3])).detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=1e-6)


def test_networks_forward_match_jax(jax_models, name):
    """G and D in train mode (the batch statistics they move too) and in eval mode, f32."""
    jmodel, model, state, _ = jax_models[name]
    rs = np.random.RandomState(2)
    z = rs.randn(B, jmodel.latent_dim).astype(np.float32)
    x = rs.uniform(-1, 1, (B, *jmodel.image_shape())).astype(np.float32)

    @jax.jit
    def references(state, inputs):
        """Both nets in train mode (with the statistics they move) and in eval mode."""
        out = {}
        for key, inp in inputs.items():
            jnet = getattr(jmodel, key)
            variables = {"params": state.params[key], **state.mutable[key]}
            if state.mutable[key]:
                out[key, True] = jnet.apply(variables, inp, train=True,
                                            mutable=("batch_stats",))
            else:
                out[key, True] = jnet.apply(variables, inp, train=True), {}
            out[key, False] = jnet.apply(variables, inp, train=False), {}
        return out

    refs = jax.device_get(references(state, {"G": jnp.asarray(z), "D": jnp.asarray(x)}))
    for net, inp in ((model.G, z), (model.D, x)):
        key = "G" if net is model.G else "D"
        before = {k: v.clone() for k, v in net.state_dict().items()}
        for train in (True, False):
            ref, updated = refs[key, train]
            net.train(train)
            out = net(torch.tensor(inp)).detach().numpy()
            ref = np.asarray(ref)
            assert out.shape == ref.shape
            assert np.max(np.abs(out - ref) / (1 + np.abs(ref))) <= 1e-5, (key, train)
            if train:
                stats = flatten_tree(jax.device_get(updated))
                for path, (t, _) in flax_paths(net, buffers=True).items():
                    np.testing.assert_allclose(t.numpy(), stats[f"batch_stats/{path}"],
                                               atol=1e-6, rtol=1e-6, err_msg=path)
            net.load_state_dict(before)


def test_three_train_steps_match_jax(jax_models, name):
    """Every metric, each weight's gradient and update, G's and D's batch statistics after
    each of three steps (G's move once a step, D's three times). Each step starts from
    JAX's state (weights, batch statistics, both Adams): Adam's first steps move each
    weight by about lr * sign(g), the few whose gradient is within f32 noise of 0 by +-lr
    at random, and the next steps' gradients carry that (1e-2 relative after two steps of
    the min-max GAN, a few 1e-2 after one of DCGAN's 14M weights)."""
    jmodel, _, state, train_step = jax_models[name]
    model = load_model(CONFIGS[name], device="cpu")
    batch = _batch(name)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for step in range(3):
        load_flax_train_state(model, jax.device_get(state))
        before, moments = _pairs(model, state), _port_moments(model)
        state1, jmetrics = train_step(state, jbatch, RNG)
        flip, z = _draws(jmodel, step)
        metrics = model.train_step(batch, flip=flip, z=z)
        _check_step(model, state, state1, before, moments, metrics, jmetrics)
        state = state1
    assert model.step == int(state.step) == 3


def test_eval_step_and_sample_match_jax(jax_models, name):
    """One step in (moved batch statistics), eval_step and sample with G and D on their
    running statistics; eval moves none of them."""
    jmodel, _, state, train_step = jax_models[name]
    batch = _batch(name)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, _ = train_step(state, jbatch, RNG)
    model = _port(name, state)
    before = {k: v.clone() for k, v in {**model.G.state_dict(), **model.D.state_dict()}.items()}

    rng = jax.random.PRNGKey(11)

    @jax.jit
    def references(state, batch):
        """eval_step and its z, sample and its z: one program."""
        return {"eval": jmodel.eval_step(state, batch, RNG),
                "z_eval": jmodel.sample_z(jax.random.fold_in(RNG, 1), B),
                "sample": jmodel.sample(state, rng, 5), "z": jmodel.sample_z(rng, 5)}

    refs = jax.device_get(references(state, jbatch))
    jmetrics = refs["eval"]
    metrics = model.eval_step(batch, z=torch.tensor(refs["z_eval"]))
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)

    ref = refs["sample"]
    images = model.sample(None, 5, z=torch.tensor(refs["z"]))
    assert images.shape == ref.shape
    np.testing.assert_allclose(images.numpy(), ref, atol=1e-5)
    after = {**model.G.state_dict(), **model.D.state_dict()}
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_train_state_npz_loads_and_next_step_matches_jax(jax_models, tmp_path, name):
    """A JAX TrainState one step in (both Adams' moments and counts, both nets' batch
    statistics), flattened to an .npz with JAX's key paths, loads through
    load_flax_train_state; the next step matches JAX's, and generate --weights samples
    from the same file."""
    jmodel, _, state, train_step = jax_models[name]
    batch = _batch(name)
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

    config = tmp_path / "config.json"
    config.write_text(json.dumps({"model": CONFIGS[name], "dataset": {}}))
    images = generate.main(["--config_path", str(config), "--num_samples", "4", "--device",
                            "cpu", "--weights", str(tmp_path / "state.npz"), "--out",
                            str(tmp_path / "out")])
    np.testing.assert_array_equal(
        images, model.sample(torch.Generator().manual_seed(0), 4).numpy())

    before, moments = _pairs(model, state), _port_moments(model)
    state1, jmetrics = train_step(state, jbatch, RNG)
    flip, z = _draws(jmodel, 1)
    metrics = model.train_step(batch, flip=flip, z=z)
    _check_step(model, state, state1, before, moments, metrics, jmetrics)


def test_calculate_metrics_and_bad_loss_type_raise():
    """``calculate_metrics`` and ``metrics`` are kept as the JAX models keep them (the
    trainer's validation reads them: ``test_torch_metrics_cli.py``); a bad loss type
    raises."""
    for name in ("GAN", "WGAN", "InfoGAN"):
        config = {"name": name, "args": {"img_size": 16, "calculate_metrics": True,
                                         "metrics": ["fid", "is"]}}
        model, jmodel = load_model(config, device="cpu"), jax_load_model(config)
        assert (model.calculate_metrics, model.metrics) == (True, ["fid", "is"])
        assert (model.calculate_metrics, model.metrics) == (jmodel.calculate_metrics,
                                                            jmodel.metrics)
    assert load_model({"name": "GAN", "args": {"img_size": 8}}, device="cpu").metrics == []
    with pytest.raises(ValueError, match="loss_type"):
        load_model({"name": "DCGAN", "args": {"loss_type": "hinge"}}, device="cpu")


def test_checkpoint_round_trip_continues_bit_for_bit(tmp_path):
    """A DCGAN two steps in, saved by the trainer's CheckpointManager and restored into a
    fresh model, then both take two more steps on the same batches and draws: the same
    weights, batch statistics and Adam states bit for bit."""
    batch = _batch("dcgan28")
    model = load_model(CONFIGS["dcgan28"], device="cpu")
    for step in range(2):
        model.train_step(batch, torch.Generator().manual_seed(step))
    manager = CheckpointManager(tmp_path / "checkpoints", monitor=model.monitor)
    manager.save_last(model, model.step, 0)
    restored = load_model(CONFIGS["dcgan28"], device="cpu")
    assert manager.restore(restored) == (2, 0) and restored.step == 2
    for step in range(2, 4):
        for m in (model, restored):
            m.train_step(batch, torch.Generator().manual_seed(step))
    flat = [flatten_tree(m.state_dict()) for m in (model, restored)]
    assert flat[0].keys() == flat[1].keys()
    assert any(k.endswith(".mean") for k in flat[0]) and any("exp_avg" in k for k in flat[0])
    for key in flat[0]:
        np.testing.assert_array_equal(flat[0][key], flat[1][key], err_msg=key)


def test_cpu_train_main_then_resume_and_generate(tmp_path, monkeypatch):
    """train on a tiny GAN config (4 steps an epoch), then a --resume; the metrics carry
    val_g_loss, which picks 'best'; generate writes a grid and refuses the diffusion
    models' flags."""
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = tmp_path / "gan_tiny.json"
    config.write_text(json.dumps({
        "model": CONFIGS["gan"],
        "dataset": {"name": "MNIST", "img_size": 28, "img_channels": 1, "batch_size": 8,
                    "synthetic_size": 40, "data_dir": str(tmp_path)},
    }))
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1", "--sample_every_n_steps", "0"]
    assert port_train.main(argv + ["--max_steps", "4"]).step == 4
    assert port_train.main(argv + ["--max_steps", "6", "--resume"]).step == 6
    run_dir = tmp_path / "experiments" / "GAN" / "run"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_g_loss" in r] == [0, 3, 5]
    assert all(np.isfinite(r["val_g_loss"]) for r in records if "val_g_loss" in r)
    meta = json.loads((run_dir / "checkpoints" / "checkpoint_meta_best.json").read_text())
    assert meta["monitor"] == "val_g_loss"
    assert json.loads((run_dir / "checkpoints" / "checkpoint_meta_last.json")
                      .read_text())["step"] == 6

    out = tmp_path / "generated"
    images = generate.main(["--config_path", str(config), "--num_samples", "4",
                            "--device", "cpu", "--out", str(out)])
    assert images.shape == (4, 28, 28, 1) and (out / "grid.png").exists()
    assert 0.0 <= images.min() <= images.max() <= 1.0
    for flags in (["--sampler", "ddim"], ["--label", "1"]):
        with pytest.raises(SystemExit):
            generate.main(["--config_path", str(config), "--device", "cpu"] + flags)
