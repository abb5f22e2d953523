"""Cases of the port's CGAN, ACGAN, SGAN and InfoGAN against the JAX package, on the CPU,
imported by ``test_torch_gan_cond.py`` (CGAN), ``test_torch_acgan.py``,
``test_torch_sgan.py``, ``test_torch_infogan.py`` and ``test_torch_infogan_state.py``.

Each model is built once at batch 8 from its config under configs/gan/ on the 28-px branch:
``cgan.json``, ``acgan.json`` and ``sgan.json`` as they are, ``infogan.json`` at 28 px with
one channel. ACGAN, SGAN and InfoGAN build DCGAN's ``ConvGenerator`` with its bf16 convs;
the parity checks run it in f32 on both sides (``torch_gan_check.f32_generator``), and one
test holds the bf16 generator to JAX's. Each JAX step's draws (flip, z, ACGAN's
gen_labels, InfoGAN's codes, CGAN's three dropout masks, captured from flax's ``Dropout``)
are handed to the port (``torch_gan_check`` says what a step's check compares).
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gan_check as gc
from lightning_generative_models_tpu.models.gan.infogan import gaussian_nll as jax_gaussian_nll
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.models.modules.layers import BatchNorm
from lightning_generative_models_tpu_torch.train import cli
from torch_flax_params import as_port

torch.set_num_threads(1)

B = gc.B
CONFIGS = {
    "cgan": gc.config("cgan.json"),
    "acgan": gc.config("acgan.json"),
    "sgan": gc.config("sgan.json"),
    "infogan": gc.config("infogan.json", img_size=28, img_channels=1),
}
F32_G = {"acgan", "sgan", "infogan"}
# InfoGAN's Q head: Dense_1 feeds a BatchNorm over [B, 128], which cancels its bias.
SKIP = {"infogan": ("params/D/Dense_1/bias",)}
# JAX's generator calls in a step -> the port's (torch_gan_check): the fake batch and G's
# gradient run G on the same z, the port once; InfoGAN's Q phase runs the stepped G again
# (JAX's call 2: on updated weights).
CALLS = {"infogan": (0, 0, 1)}
UPDATED = {"infogan": (2,)}


def _batch(name):
    return gc.labelled_batch(CONFIGS[name]["args"])


@pytest.fixture(scope="module")
def built():
    """name -> (JAX model, TrainState)."""
    return {name: gc.build(cfg, f32_g=name in F32_G) for name, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def stepped(built):
    """name -> (JAX's state after the three steps that the port is held to, run once;
    ``_refs`` on it)."""
    states = {}

    def get(name):
        if name not in states:
            jmodel, state = built[name]
            states[name] = gc.run_steps(
                built[name], CONFIGS[name], _batch(name), _draws_for(name, state),
                CALLS.get(name, (0, 0)), skip=SKIP.get(name, ()), f32_g=name in F32_G,
                updated=UPDATED.get(name, ()), refs=functools.partial(_refs, name),
                inputs=_net_inputs(name, jmodel))
        return states[name]

    return get


def _dropout_masks(jmodel, params_d, x, labels, rngs):
    """The keep-masks of flax's Dropout in CGAN's D under each of ``rngs``."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            masks.append(out != 0)
        return out

    with fnn.intercept_methods(interceptor):
        for rng in rngs:
            jmodel._discriminate_cond(params_d, x, labels, rng, True)
    return masks


@functools.lru_cache(maxsize=None)
def _draw_fn(name, jmodel):
    """A jitted function of (step, D's params, batch) -> the JAX step's draws."""

    def draw(step, params_d, image, labels):
        rng = jax.random.fold_in(gc.RNG, step)
        if name == "cgan":
            rng_aug, rng_z, *drops = jax.random.split(rng, 5)
        elif name == "acgan":
            rng_aug, rng_z, rng_c = jax.random.split(rng, 3)
        else:
            rng_aug, rng_z = jax.random.split(rng)
        out = {"flip": jax.random.bernoulli(rng_aug, 0.5, (B, 1, 1, 1)).reshape(-1)}
        if name == "infogan":
            out["codes"] = jmodel.generate_codes(rng_z, B)
            return out
        out["z"] = jmodel.sample_z(rng_z, B)
        if name == "acgan":
            out["gen_labels"] = jax.random.randint(rng_c, (B,), 0, jmodel.num_classes)
        if name == "cgan":
            x = image.astype(jnp.float32) / 127.5 - 1.0  # any input: the masks are the rng's
            out["keep"] = _dropout_masks(jmodel, params_d, x, labels, drops)
        return out

    return jax.jit(draw)


def _draws_for(name, state):
    batch = _batch(name)

    def draws(jmodel, step):
        out = _draw_fn(name, jmodel)(step, state.params["D"], batch["image"], batch["label"])
        return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), out)

    return draws


def _net_inputs(name, jmodel):
    """{"G": G's input, "D": D's input} at batch B: the generator's concatenated code and
    the image (CGAN's D: with its label planes); "z_bf16": ACGAN's bf16 generator's."""
    rs = np.random.RandomState(2)
    width = jmodel.latent_dim + {
        "cgan": getattr(jmodel, "num_classes", 0), "acgan": getattr(jmodel, "num_classes", 0),
        "sgan": 0, "infogan": getattr(jmodel, "categorical_code_dim", 0)
        + getattr(jmodel, "continuous_code_dim", 0)}[name]
    channels = jmodel.img_channels + (jmodel.num_classes if name == "cgan" else 0)
    return {"G": rs.randn(B, width).astype(np.float32),
            "D": rs.uniform(-1, 1, (B, jmodel.img_size, jmodel.img_size, channels)).astype(
                np.float32),
            "z_bf16": np.random.RandomState(4).randn(B, width).astype(np.float32)}


LABELS = (3, 1, 4, 1, 5)
SAMPLE_KEY = jax.random.PRNGKey(11)
Q_KEY = jax.random.PRNGKey(5)


def _forward_cases(name):
    """(net, train mode) of the forward test: CGAN's D in eval mode only (its dropout draws
    are the train step's)."""
    return [(key, train) for key in ("G", "D") for train in (True, False)
            if not (train and name == "cgan" and key == "D")]


def _refs(name, jmodel, state, batch, rng, inputs):
    """On JAX's state three steps in: the nets' forwards (train mode: with the statistics
    they move), eval_step and its draws, sampling (CGAN, ACGAN: sample_classes on LABELS,
    sample and their z; SGAN: classify; InfoGAN: sample on the structured codes, and the Q
    phase's codes), ACGAN's bf16 generator."""
    out = {"eval": jmodel.eval_step(state, batch, rng), "forwards": {}}
    eval_rng = jax.random.fold_in(rng, 1)
    if name == "infogan":
        out["eval_codes"] = jmodel.generate_codes(eval_rng, B)
    else:
        out["eval_z"] = jmodel.sample_z(eval_rng, B)
    nets = {"G": jmodel.G, "D": jmodel.D}
    for key, train in _forward_cases(name):
        variables = {"params": state.params[key], **state.mutable[key]}
        if train and state.mutable[key]:
            out["forwards"][f"{key}{train}"] = nets[key].apply(
                variables, inputs[key], train=True, mutable=("batch_stats",))
        else:
            out["forwards"][f"{key}{train}"] = (
                nets[key].apply(variables, inputs[key], train=train), {})
    if name in ("cgan", "acgan"):
        out["sample_classes"] = jmodel.sample_classes(state, SAMPLE_KEY, jnp.asarray(LABELS))
        out["sample"] = jmodel.sample(state, SAMPLE_KEY, 12)
        out["z5"], out["z12"] = (jmodel.sample_z(SAMPLE_KEY, n) for n in (5, 12))
    elif name == "sgan":
        out["classify"] = jmodel.classify(state, batch)
    else:
        out["sample"] = jmodel.sample(state, SAMPLE_KEY, 20)
        out["codes"] = jmodel.generate_codes(SAMPLE_KEY, 20, structured=True)
        out["q_codes"] = jmodel.generate_codes(Q_KEY, B)
    if name == "acgan":
        variables = {"params": state.params["G"], **state.mutable["G"]}
        g16 = jmodel.G.clone(dtype=jnp.bfloat16)
        out["bf16"] = {True: g16.apply(variables, inputs["z_bf16"], train=True,
                                       mutable=("batch_stats",))[0],
                       False: g16.apply(variables, inputs["z_bf16"], train=False)}
    return out


def test_networks_forward_match_jax(built, stepped, name):
    """G and D three steps in, in train mode (with the running statistics they move) and
    in eval mode: every output within 1e-5 of 1 + |ref| (CGAN's D in eval mode only)."""
    state, refs = stepped(name)
    inputs = _net_inputs(name, built[name][0])
    model = gc.port_model(CONFIGS[name], state, f32_g=name in F32_G)
    for key, train in _forward_cases(name):
        net = getattr(model, key)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        ref, updated = refs["forwards"][f"{key}{train}"]
        net.train(train)
        out = net(torch.tensor(inputs[key]))
        ref = ref if isinstance(ref, tuple) else (ref,)
        out = out if isinstance(out, tuple) else (out,)
        for o, r in zip(out, ref):
            gc.check_close(o.detach(), r, 1e-5, (key, train))
        if updated:
            stats = gc.flatten_tree(jax.device_get(updated))
            for path, (t, _) in gc.flax_paths(net, buffers=True).items():
                np.testing.assert_allclose(t.numpy(), stats[f"batch_stats/{path}"],
                                           atol=1e-6, rtol=1e-6, err_msg=path)
        net.load_state_dict(before)


def test_bf16_generator_matches_jax(built, stepped):
    """ACGAN's generator as its config builds it (bf16 convs, f32 BatchNorm) against JAX's
    bf16 generator on the same weights, in train and eval mode: within 2e-2 of 1 + |ref|
    (the two round the bf16 products' f32 sums apart)."""
    state, refs = stepped("acgan")
    model = gc.port_model(CONFIGS["acgan"], state)  # bf16 convs, as configured
    z = torch.tensor(_net_inputs("acgan", built["acgan"][0])["z_bf16"])
    for train in (True, False):
        model.G.train(train)
        gc.check_close(model.G(z).detach(), refs["bf16"][train], 2e-2, train)


def test_three_train_steps_match_jax(stepped, name):
    """Three steps, each from JAX's state: the metrics, each weight's gradient and update
    (InfoGAN: from all three Adams, "Q" over G and D), the running statistics (InfoGAN's
    G moved twice a step, D four times)."""
    assert int(stepped(name)[0].step) == 3


def test_infogan_moves_statistics_twice_in_g_and_four_times_in_d():
    """Count the train-mode BatchNorm passes that move statistics in one InfoGAN step."""
    model = gc.port_model(CONFIGS["infogan"])
    counts = {"G": 0, "D": 0}
    for key, net in model.nets().items():
        norm = next(m for m in net.modules() if isinstance(m, BatchNorm))
        norm.register_forward_hook(
            lambda mod, args, out, key=key: counts.__setitem__(
                key, counts[key] + (mod.training and mod.move_stats)))
    model.train_step(_batch("infogan"), torch.Generator().manual_seed(0))
    assert counts == {"G": 2, "D": 4}


def test_eval_step_matches_jax(stepped, name):
    """eval_step three steps in: the metrics within 1e-5."""
    state, refs = stepped(name)
    model = gc.port_model(CONFIGS[name], state, f32_g=name in F32_G)
    if name == "infogan":
        draws = {"codes": tuple(torch.tensor(np.asarray(c)) for c in refs["eval_codes"])}
    else:
        draws = {"z": torch.tensor(np.asarray(refs["eval_z"]))}
    gc.check_metrics(model.eval_step(_batch(name), **draws), refs["eval"])


def test_sampling_and_classify_match_jax(stepped, name):
    """Three steps in. CGAN and ACGAN: sample_classes on given labels, sample (labels
    cycling), and the per-class validation grid's shape; SGAN: classify; InfoGAN: sample on
    the structured codes. Nothing moves the running statistics."""
    state, refs = stepped(name)
    model = gc.port_model(CONFIGS[name], state, f32_g=name in F32_G)
    before = {k: v.clone() for net in model.nets().values() for k, v in net.state_dict().items()}
    if name in ("cgan", "acgan"):
        z5, z12 = (torch.tensor(np.asarray(refs[k])) for k in ("z5", "z12"))
        gc.check_close(model.sample_classes(None, torch.tensor(LABELS), z=z5),
                       refs["sample_classes"], 1e-5)
        gc.check_close(model.sample(None, 12, z=z12), refs["sample"], 1e-5)
        grids = model.validation_grids(torch.Generator().manual_seed(0))
        assert grids["per_class_generation"].shape == (80, 28, 28, 1)
    elif name == "sgan":
        np.testing.assert_array_equal(model.classify(_batch(name)).numpy(),
                                      np.asarray(refs["classify"]))
    else:
        codes = tuple(torch.tensor(np.asarray(c)) for c in refs["codes"])
        gc.check_close(model.sample(None, 20, codes=codes), refs["sample"], 1e-5)
        assert model.validation_grids(torch.Generator())["code_transition"].shape[0] == 80
    after = {k: v for net in model.nets().values() for k, v in net.state_dict().items()}
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_infogan_q_phase_matches_jax(built, stepped):
    """The Q phase alone (JAX's state three steps in): G and D in train mode on the codes,
    MI = lambda_cat CE + lambda_cont NLL (log 2 pi dropped) within 1e-5, its gradient into
    D's and G's weights within 1e-3 of their norms (JAX on the port's fake batch, as in
    torch_gan_check, and on its ReLU and LeakyReLU branches: three steps in, a LeakyReLU
    input of D within f32 noise of 0 moves G's gradient by 2.5e-3 otherwise), the running
    statistics each pass moves within 1e-5."""
    jmodel = built["infogan"][0]
    state, refs = stepped("infogan")
    codes = refs["q_codes"]

    def mi(joint, mutable, fake, branches):
        branches = list(branches)
        with gc.replayed_branches(lambda leaky: branches.pop(0)):
            x_hat, g_mut = jmodel._generate_coded(joint["G"], mutable["G"], *codes, True)
            x_hat = x_hat + jax.lax.stop_gradient(fake - x_hat)
            (_, cat_logits, mu, logvar), d_mut = jmodel._discriminate_full(
                joint["D"], mutable["D"], x_hat, True)
        assert not branches
        ce = optax.softmax_cross_entropy(cat_logits, codes[1]).mean()
        nll = jax_gaussian_nll(codes[2], mu, logvar)
        return jmodel.lambda_cat * ce + jmodel.lambda_cont * nll, (g_mut, d_mut)

    model = gc.port_model(CONFIGS["infogan"], state, f32_g=True)
    model.G.train()
    model.D.train()
    z, cat, cont = (torch.tensor(np.asarray(c)) for c in codes)
    branches = []
    with gc.recorded_branches(lambda mask, leaky: branches.append(mask)):
        fake = model.G(torch.cat([z, cat, cont], dim=1))
        loss, _, _ = model._mi(fake, cat, cont)
    (ref, (g_mut, d_mut)), grads = jax.jit(jax.value_and_grad(mi, has_aux=True))(
        state.params, state.mutable, fake.detach().numpy(), tuple(branches))
    gc.check_close(loss.detach(), ref, 1e-5)
    for key, net in model.nets().items():
        names = [f"params/{key}/{path}" for path in gc.flax_paths(net)]
        port = torch.autograd.grad(loss, list(net.parameters()), retain_graph=True,
                                   allow_unused=True)
        for name, out, want in zip(names, port, as_port(net, grads[key])):
            if name in SKIP["infogan"]:
                continue
            out = torch.zeros_like(want) if out is None else out  # the logit head
            assert float((out - want).norm()) <= 1e-3 * float(want.norm()), name
        stats = gc.flatten_tree(jax.device_get((g_mut if key == "G" else d_mut)))
        for path, (t, _) in gc.flax_paths(net, buffers=True).items():
            np.testing.assert_allclose(t.numpy(), stats[f"batch_stats/{path}"], atol=1e-5,
                                       rtol=1e-5, err_msg=path)


def test_infogan_train_state_npz_loads_as_the_tree(stepped, tmp_path):
    """An InfoGAN TrainState three steps in (the three Adams, "Q" over G and D together),
    flattened to an .npz, loads through load_flax_train_state into the same state as the
    tree, from which the three-step test's steps match JAX's."""
    model = gc.check_npz_loads(CONFIGS["infogan"], stepped("infogan")[0], tmp_path,
                               f32_g=True)
    assert len(model.optimizers["Q"].state) == len(list(model.G.parameters())) + len(
        list(model.D.parameters()))


def test_checkpoint_round_trip_continues_bit_for_bit(tmp_path, name):
    flat = gc.checkpoint_round_trip(CONFIGS[name], _batch(name), tmp_path)
    assert any("exp_avg" in k for k in flat)
    if name == "infogan":
        assert any(k.startswith("optimizer_Q") for k in flat)


def test_cpu_train_main_then_resume_and_generate_labels(tmp_path, monkeypatch):
    """train CGAN on cgan.json with 4 steps an epoch, then a --resume: finite losses, the
    per-class grid written at each validation; generate --label 3 reaches sample_classes,
    and --guidance_scale is refused."""
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = tmp_path / "cgan_tiny.json"
    config.write_text(json.dumps({
        "model": CONFIGS["cgan"],
        "dataset": {"name": "MNIST", "img_size": 28, "img_channels": 1, "batch_size": 8,
                    "synthetic_size": 40, "data_dir": str(tmp_path)},
    }))
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1", "--sample_every_n_steps", "0"]
    assert port_train.main(argv + ["--max_steps", "4"]).step == 4
    assert port_train.main(argv + ["--max_steps", "6", "--resume"]).step == 6
    run_dir = tmp_path / "experiments" / "CGAN" / "run"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(v) for r in records for k, v in r.items()
               if k.startswith(("train_", "val_")))
    assert len(list((run_dir / "samples").glob("per_class_generation_*.png"))) == 2
    base = ["--config_path", str(config), "--num_samples", "4", "--device", "cpu", "--out",
            str(tmp_path / "generated")]
    images = generate.main(base + ["--label", "3"])
    assert images.shape == (4, 28, 28, 1) and 0.0 <= images.min() <= images.max() <= 1.0
    with pytest.raises(SystemExit):
        generate.main(base + ["--label", "3", "--guidance_scale", "2"])
