"""Cases of the port's BEGAN and CycleGAN against the JAX package, on the CPU, imported by
``test_torch_began_cyclegan.py`` (BEGAN), ``test_torch_cyclegan.py`` and
``test_torch_paired_data.py``.

BEGAN from ``began.json`` at 16 px with hidden 16 (batch 8); CycleGAN from ``cyclegan.json``
at 32 px with one residual block (batch 2), as ``tests/test_configs_e2e.py`` sizes it. The
port draws the weights and hands them to JAX; each JAX step's flips and z are handed to the
port (``torch_gan_check`` says what a step's check compares).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

import torch_gan_check as gc
from lightning_generative_models_tpu.data.datamodule import (
    PairedDataModule as JaxPairedDataModule,
)
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.data.datamodule import PairedDataModule
from lightning_generative_models_tpu_torch.train import cli

torch.set_num_threads(1)

CONFIGS = {
    "began": gc.config("began.json", img_size=16, hidden_dim=16),
    "cyclegan": gc.config("cyclegan.json", img_size=32, num_residual_blocks=1),
}
BATCH = {"began": 8, "cyclegan": 2}
# JAX's generator calls in a step -> the port's (torch_gan_check): BEGAN runs G on z for
# the fake batch and again inside G's gradient, the port once; CycleGAN's six generator
# calls (fakes, cycles, identities) are the port's six, in the same order.
CALLS = {"began": (0, 0), "cyclegan": tuple(range(6))}
GENERATORS = {"began": ("G",), "cyclegan": ("G_AB", "G_BA")}
# Every CycleGAN conv bias that an InstanceNorm follows: the per-channel mean over the map
# cancels it, so its gradient is exactly 0 and both frameworks return f32 noise there.
_NORMED = ["Conv_0", "Conv_1", "Conv_2", "ConvTranspose_0", "ConvTranspose_1",
           "ResnetGenBlock_0/Conv_0", "ResnetGenBlock_0/Conv_1"]
# CycleGAN: JAX's step takes the port's LeakyReLU slopes, and every weight is held element
# by element (torch_gan_check).
NOISE = {"began": {}, "cyclegan": {"replay_leaky": True}}
SKIP = {"began": (), "cyclegan": tuple(
    [f"params/G/{g}/{conv}/bias" for g in ("AB", "BA") for conv in _NORMED]
    + [f"params/D/{d}/Conv_{i}/bias" for d in ("A", "B") for i in (1, 2, 3)])}


def _batch(name):
    n = BATCH[name]
    if name == "began":
        return {"image": gc.uint8_images(16, 3, n)}
    return {"image_A": gc.uint8_images(32, 3, n, seed=1),
            "image_B": gc.uint8_images(32, 3, n, seed=2)}


@pytest.fixture(scope="module")
def built():
    """name -> (JAX model, TrainState)."""
    return {name: gc.build(cfg) for name, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def stepped(built):
    """name -> (JAX's state after the three steps that the port is held to, run once;
    ``_refs`` on it)."""
    states = {}

    def get(name):
        if name not in states:
            states[name] = gc.run_steps(
                built[name], CONFIGS[name], _batch(name), _draws_for(name), CALLS[name],
                skip=SKIP[name], generators=GENERATORS[name], refs=functools.partial(_refs, name),
                inputs=_inputs(name, built[name][0]), **NOISE[name])
        return states[name]

    return get


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _draw(step, name, n, latent_dim):
    rng_a, rng_b = jax.random.split(jax.random.fold_in(gc.RNG, step))
    flip_a = jax.random.bernoulli(rng_a, 0.5, (n, 1, 1, 1)).reshape(-1)
    if name == "began":
        return {"flip": flip_a, "z": jax.random.normal(rng_b, (n, latent_dim))}
    return {"flip_a": flip_a, "flip_b": jax.random.bernoulli(rng_b, 0.5, (n, 1, 1, 1)).reshape(-1)}


def _draws_for(name):
    def draws(jmodel, step):
        out = _draw(step, name, BATCH[name], getattr(jmodel, "latent_dim", 0))
        return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}

    return draws


def _inputs(name, jmodel):
    """The forward test's inputs (BEGAN: "G" a z and "D" an image batch; CycleGAN: "D/A"
    and "D/B" the same image batch) and CycleGAN's [0, 1] images to translate."""
    rs = np.random.RandomState(2)
    image = rs.uniform(-1, 1, (BATCH[name], *jmodel.image_shape())).astype(np.float32)
    if name == "began":
        return {"G": rs.randn(BATCH[name], jmodel.latent_dim).astype(np.float32), "D": image}
    return {"D/A": image, "D/B": image, "translate": np.random.RandomState(4).uniform(
        0, 1, (3, 32, 32, 3)).astype(np.float32)}


def _nets(name, model):
    """The nets of the forward test by key: the port model's, or the JAX model's."""
    if name == "began":
        return {"G": model.G, "D": model.D}
    return {"D/A": model.D_A, "D/B": model.D_B}


def _refs(name, jmodel, state, batch, rng, inputs):
    """On JAX's state three steps in: the nets' forwards, eval_step (BEGAN: and its z),
    CycleGAN's translate both ways."""
    out = {"eval": jmodel.eval_step(state, batch, rng), "forwards": {}}
    for key, net in _nets(name, jmodel).items():
        params = state.params[key.split("/")[0]]
        params = params[key.split("/")[1]] if "/" in key else params
        out["forwards"][key] = net.apply({"params": params}, inputs[key])
    if name == "began":
        out["eval_z"] = jax.random.normal(jax.random.fold_in(rng, 1),
                                          (BATCH[name], jmodel.latent_dim))
    else:
        out["translate"] = {d: jmodel.translate(state, inputs["translate"], d)
                            for d in ("AB", "BA")}
    return out


def test_networks_forward_match_jax(built, stepped, name):
    """Three steps in, BEGAN's generator on z and each discriminator: within 1e-5 of
    1 + |ref| (CycleGAN's InstanceNorm: flax's GroupNorm(group_size=1), eps 1e-6; its
    generators in the translate test)."""
    state, refs = stepped(name)
    inputs = _inputs(name, built[name][0])
    for key, net in _nets(name, gc.port_model(CONFIGS[name], state)).items():
        gc.check_close(net(torch.tensor(inputs[key])).detach(), refs["forwards"][key], 1e-5,
                       key)


def test_three_train_steps_match_jax(stepped, name):
    """Three steps, each from JAX's state: the metrics, each weight's gradient and update,
    BEGAN's k_t (from 0, clipped to [0, 1]); CycleGAN steps G first through the old D, then
    D on G's detached fakes."""
    assert int(stepped(name)[0].step) == 3


def test_began_k_t_is_clipped():
    """k_t starts at 0 and moves by lambda_k (gamma L(x) - L(G(z))) into [0, 1]: with
    gamma 10 and lambda_k 100 the first step's move is far above 1 and stops there."""
    cfg = {**CONFIGS["began"], "args": {**CONFIGS["began"]["args"], "lambda_k": 100.0,
                                        "gamma": 10.0}}
    model = gc.port_model(cfg)
    assert float(model.k_t) == 0.0
    metrics = model.train_step(_batch("began"), torch.Generator().manual_seed(0))
    assert float(metrics["train_k_t"]) == float(model.k_t) == 1.0


def test_eval_step_matches_jax(stepped, name):
    """eval_step three steps in: the metrics within 1e-5."""
    state, refs = stepped(name)
    model = gc.port_model(CONFIGS[name], state)
    kwargs = {"z": torch.tensor(np.asarray(refs["eval_z"]))} if name == "began" else {}
    gc.check_metrics(model.eval_step(_batch(name), **kwargs), refs["eval"])


def test_cyclegan_translate_matches_jax(built, stepped):
    """CycleGAN's translate both ways on [0, 1] images three steps in, within 1e-5 (its
    generators element-wise), and its sample raises, as JAX's does."""
    state, refs = stepped("cyclegan")
    model = gc.port_model(CONFIGS["cyclegan"], state)
    images = torch.tensor(_inputs("cyclegan", built["cyclegan"][0])["translate"])
    for direction, ref in refs["translate"].items():
        out = model.translate(images, direction)
        gc.check_close(out, ref, 1e-5, direction)
        assert 0.0 <= float(out.min()) <= float(out.max()) <= 1.0
    with pytest.raises(NotImplementedError, match="translate"):
        model.sample(None, 4)


def test_train_state_npz_loads_as_the_tree(stepped, name, tmp_path):
    """A TrainState three steps in (BEGAN's k_t; CycleGAN's {AB, BA} and {A, B} trees and
    their Adams), flattened to an .npz, loads through load_flax_train_state into the same
    state as the tree, from which the three-step test's steps match JAX's."""
    gc.check_npz_loads(CONFIGS[name], stepped(name)[0], tmp_path)


def test_checkpoint_round_trip_continues_bit_for_bit(tmp_path):
    """BEGAN's checkpoint carries k_t (CycleGAN's goes through the same
    ``AdversarialModel.state_dict`` as every GAN's, and its CPU run below resumes)."""
    flat = gc.checkpoint_round_trip(CONFIGS["began"], _batch("began"), tmp_path)
    assert "k_t" in flat


def test_paired_datamodule_matches_jax(tmp_path):
    """The synthetic two-domain split (CIFAR-10's lower and upper label halves), and the
    trainA / trainB folders when both are there: the same train and val batches as the JAX
    package's PairedDataModule, epoch by epoch. The images are at the module's size (the
    synthetic CIFAR-10 at 32 px): a resize takes the JAX package's native C++ loader, which
    the port does not port (its numpy and PIL path can land one level apart)."""
    pil = pytest.importorskip("PIL.Image")
    root = tmp_path / "h2z"
    rs = np.random.RandomState(0)
    for domain in ("trainA", "trainB"):
        (root / domain).mkdir(parents=True)
        for i in range(7):
            pil.fromarray(rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(
                root / domain / f"{i}.png")
    for kwargs in ({"name": "none", "synthetic_size": 64, "img_size": 32},
                   {"name": "h2z", "train_val_split": 0.6, "img_size": 16}):
        args = dict(img_channels=3, batch_size=2, data_dir=str(tmp_path), **kwargs)
        ours, ref = PairedDataModule(**args), JaxPairedDataModule(**args)
        ours.setup()
        ref.setup()
        assert ours.is_synthetic == ref.is_synthetic == (kwargs["name"] == "none")
        assert ours.steps_per_epoch("train") == ref.steps_per_epoch("train")
        assert ours.steps_per_epoch("val") == ref.steps_per_epoch("val")
        for got, want in ((ours.train_batches(1), ref.train_batches(1)),
                          (ours.val_batches(), ref.val_batches())):
            got, want = list(got), list(want)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.keys() == b.keys() == {"image_A", "image_B"}
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])


def test_cpu_train_main_then_resume_and_translate(tmp_path, monkeypatch):
    """train CycleGAN (the paired data module, picked by the model's name) with 4 steps an
    epoch, then a --resume: finite losses and no random-generation grid (its sample
    raises, which the trainer skips); generate raises as the JAX generate.py does."""
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = tmp_path / "cyclegan_tiny.json"
    config.write_text(json.dumps({
        "model": CONFIGS["cyclegan"],
        "dataset": {"name": "horse2zebra", "img_size": 32, "img_channels": 3,
                    "batch_size": 2, "synthetic_size": 40, "train_val_split": 0.8,
                    "data_dir": str(tmp_path)},
    }))
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1", "--sample_every_n_steps", "1"]
    model = port_train.main(argv + ["--max_steps", "2"])
    assert model.step == 2
    assert port_train.main(argv + ["--max_steps", "3", "--resume"]).step == 3
    run_dir = tmp_path / "experiments" / "CycleGAN" / "run"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert any("val_g_loss" in r for r in records)
    assert all(np.isfinite(v) for r in records for k, v in r.items()
               if k.startswith(("train_", "val_")))
    assert not (run_dir / "samples").exists() or not list((run_dir / "samples").glob("*.png"))
    images = torch.rand(2, 32, 32, 3)
    out = model.translate(images, "AB")
    assert out.shape == (2, 32, 32, 3) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="translate"):
        generate.main(["--config_path", str(config), "--num_samples", "4", "--device", "cpu",
                       "--out", str(tmp_path / "generated")])
