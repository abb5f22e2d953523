"""The port's VAE, LPIPS and VQGAN with its perceptual term against the JAX package,
on the CPU.

The VAE (16 px, one channel, latent 20, f32) and the LPIPS trunk hold the same weights on
both sides, drawn by the port (``torch_flax_params``). A JAX VAE step draws its flip and
the reparameterisation's eps from ``split(fold_in(rng, step))``; both go to the port.
The VQGAN (``perceptual_weight`` 1, as ``configs/vae/vqgan_lpips.json``; 32 px, hidden
32, as ``test_torch_vqvae.py``'s) starts from one JAX state whose LPIPS variables are the
port's He-scaled draw. Tolerances: losses within rtol 1e-4 (1e-5 for
the eval metrics), each step's update by its norm within 1e-3 (``test_torch_train.py``),
LPIPS distances within rtol 1e-4 (thirteen f32 convs summed in another order); the
torch reference of ``torch_lpips_ref.py``, on the converter's weights, within 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.metrics import lpips as jax_lpips
from lightning_generative_models_tpu.models.vae import vae as JVAE
from lightning_generative_models_tpu.models.vae import vqgan as JVQGAN
from lightning_generative_models_tpu_torch import registry
from lightning_generative_models_tpu_torch.metrics import lpips as port_lpips
from lightning_generative_models_tpu_torch.models.vae import vae as TVAE
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.weights import load_flax_train_state
from torch_flax_params import as_port, flax_tree, state_from_port
from torch_lpips_ref import TorchLPIPS

torch.set_num_threads(1)

B = 4
VAE_ARGS = dict(img_channels=1, img_size=16, latent_dim=20, lr=1e-3)


@pytest.fixture(scope="module")
def vaes():
    port = TVAE.VAE(**VAE_ARGS, device="cpu")
    jmodel = JVAE.VAE(**VAE_ARGS)
    return jmodel, state_from_port(jmodel, port), port


def _vae_draws(rng, step):
    aug_rng, z_rng = jax.random.split(jax.random.fold_in(rng, step))
    flip = jax.random.bernoulli(aug_rng, 0.5, (B, 1, 1, 1))
    return {"flip": torch.tensor(np.asarray(flip).reshape(-1)),
            "eps": torch.tensor(np.asarray(jax.random.normal(z_rng, (B, 20))))}


def _update_norm_error(d_port, d_jax):
    return float((d_port - d_jax).norm() / d_jax.norm())


def test_vae_three_train_steps_match_jax(vaes):
    """Three steps (Adam with weight decay): every metric within rtol 1e-4 and each
    step's update by its norm within 1e-3."""
    jmodel, state, _ = vaes
    model = TVAE.VAE(**VAE_ARGS, device="cpu")
    load_flax_train_state(model, jax.device_get(state))
    batch = {"image": np.random.RandomState(3).randint(0, 256, (B, 16, 16, 1)).astype(np.uint8),
             "label": np.arange(B, dtype=np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    train_step = jax.jit(jmodel.train_step)
    params = list(model.net.parameters())
    for _ in range(3):
        before = torch.cat([p.detach().reshape(-1).clone() for p in params])
        jbefore = torch.cat([t.reshape(-1) for t in as_port(model.net, state.params)])
        draws = _vae_draws(rng, int(state.step))
        state, jmetrics = train_step(state, jbatch, rng)
        metrics = model.train_step(batch, **draws)
        assert set(metrics) == set(jmetrics)
        for key, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-4)
        d_port = torch.cat([p.detach().reshape(-1) for p in params]) - before
        d_jax = torch.cat([t.reshape(-1) for t in as_port(model.net, state.params)]) - jbefore
        assert _update_norm_error(d_port, d_jax) <= 1e-3
    assert model.step == int(state.step) == 3

    rng = jax.random.PRNGKey(4)
    jeval = jmodel.eval_step(state, jbatch, rng)
    eps = torch.tensor(np.asarray(jax.random.normal(rng, (B, 20))))
    for key, value in model.eval_step(batch, eps=eps).items():
        np.testing.assert_allclose(float(value), float(jeval[key]), rtol=1e-5)
    np.testing.assert_allclose(model.reconstruct(batch, eps=eps).numpy(),
                               np.asarray(jmodel.reconstruct(state, jbatch, rng)), atol=1e-5)
    np.testing.assert_allclose(model.encode_for_logging(batch),
                               jmodel.encode_for_logging(state, jbatch), atol=1e-5)
    z = jax.random.normal(rng, (5, 20))
    np.testing.assert_allclose(model.sample(None, 5, z=torch.tensor(np.asarray(z))).numpy(),
                               np.asarray(jmodel.sample(state, rng, 5)), atol=1e-5)
    assert registry.resolve_model_class("vae") is TVAE.VAE


def _lpips_pair():
    """The port's He-scaled LPIPS and the same variables as a flax tree."""
    net = port_lpips.he_scaled_random_(port_lpips.LPIPSNet(), torch.Generator().manual_seed(3))
    shapes = jax.eval_shape(jax_lpips.VGG16Features().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    variables = {"vgg": flax_tree(net.vgg, shapes),
                 "lins": tuple(w.detach().numpy().copy() for w in net.lins)}
    return net, variables


def test_lpips_distance_matches_jax():
    net, variables = _lpips_pair()
    rs = np.random.RandomState(0)
    x, y = (rs.rand(2, 24, 24, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        d = port_lpips.lpips_distance(net, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(jax.jit(jax_lpips.lpips_distance)(variables, x, y))
    assert d.shape == (2,) and (d > 1e-4).all()
    np.testing.assert_allclose(d, ref, rtol=1e-4)
    gray = rs.rand(2, 16, 16, 1).astype(np.float32) * 2 - 1
    with torch.no_grad():
        dg = port_lpips.lpips_distance(net, torch.from_numpy(gray), torch.from_numpy(-gray))
    np.testing.assert_allclose(dg.numpy(), np.asarray(jax.jit(jax_lpips.lpips_distance)(
        variables, gray, -gray)), rtol=1e-4)


def test_lpips_loader_reads_a_torch_state_dict_and_checks_the_pin(tmp_path, monkeypatch):
    """An lpips-layout state_dict (``torch_lpips_ref.py``) through the loader: the port's
    distance is the torch reference's; a lin-only file and a wrong sha256 pin raise with
    JAX's messages."""
    torch.manual_seed(0)
    ref = TorchLPIPS()
    path = tmp_path / "lpips_vgg.pth"
    torch.save(ref.state_dict(), str(path))
    net = port_lpips.load_torch_lpips(path)
    rs = np.random.RandomState(1)
    x, y = (rs.rand(2, 24, 24, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        ours = port_lpips.lpips_distance(net, torch.from_numpy(x), torch.from_numpy(y))
    theirs = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                 torch.from_numpy(y.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-5, rtol=1e-5)

    monkeypatch.setenv("LGM_TPU_LPIPS_WEIGHTS", str(path))
    assert port_lpips.find_pretrained_weights() == path
    assert port_lpips.LPIPS().pretrained
    for pin in ("abc", "0" * 16):
        monkeypatch.setenv("LGM_TPU_LPIPS_SHA256", pin)
        with pytest.raises(ValueError) as jax_err:
            jax_lpips.find_pretrained_weights()
        with pytest.raises(ValueError) as port_err:
            port_lpips.find_pretrained_weights()
        assert str(port_err.value) == str(jax_err.value)
    lin_only = tmp_path / "lin.pth"
    torch.save({k: v for k, v in ref.state_dict().items() if k.startswith("lin")}, lin_only)
    with pytest.raises(ValueError, match="holds 0 conv weights"):
        port_lpips.load_torch_lpips(lin_only)


VQGAN = {"name": "VQGAN", "args": {
    "img_channels": 3, "img_size": 32, "embedding_dim": 8, "num_embeddings": 16,
    "hidden_dim": 32, "num_residual_layers": 1, "num_residual_hiddens": 8, "use_ema": False,
    "lr": 1e-3, "disc_start": 1, "perceptual_weight": 1.0}}


def test_vqgan_perceptual_steps_match_jax(monkeypatch):
    """Two steps, before and after disc_start: every metric (perceptual_loss among them)
    and each module's update by its norm; the LPIPS weights do not move."""
    port = load_model(VQGAN, device="cpu")
    # JAX's VQGAN takes the port's LPIPS draw in place of its own.
    shapes = jax.eval_shape(jax_lpips.VGG16Features().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    variables = {"vgg": flax_tree(port.lpips.vgg, shapes),
                 "lins": tuple(w.detach().numpy().copy() for w in port.lpips.lins)}
    monkeypatch.setattr(jax_lpips, "LPIPS", lambda: types.SimpleNamespace(variables=variables))
    jmodel = JVQGAN.VQGAN(**VQGAN["args"])
    state = state_from_port(jmodel, port)
    batch = {"image": np.random.RandomState(5).randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
             "label": np.zeros(B, np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)
    train_step = jax.jit(jmodel.train_step)
    lpips_before = [p.clone() for p in port.lpips.parameters()]
    for step in range(2):
        load_flax_train_state(port, jax.device_get(state))
        flip = jax.random.bernoulli(jax.random.fold_in(rng, step), 0.5, (B, 1, 1, 1))
        modules = {"encoder": port.encoder, "decoder": port.decoder, "vq": port.vq,
                   "disc": port.disc}
        before = {name: [p.detach().clone() for p in m.parameters()]
                  for name, m in modules.items()}
        jbefore = jax.device_get(state.params)
        state, jmetrics = train_step(state, jbatch, rng)
        metrics = port.train_step(batch, flip=torch.tensor(np.asarray(flip).reshape(-1)))
        assert "train_perceptual_loss" in metrics and set(metrics) == set(jmetrics)
        for key, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-4,
                                       atol=1e-7, err_msg=key)
        for name, module in modules.items():
            d_port = torch.cat([(p.detach() - b).reshape(-1)
                                for p, b in zip(module.parameters(), before[name])])
            d_jax = torch.cat([(a - b).reshape(-1) for a, b in zip(
                as_port(module, state.params[name]), as_port(module, jbefore[name]))])
            if float(d_jax.norm()) == 0.0:
                assert float(d_port.norm()) == 0.0, name
            else:
                assert _update_norm_error(d_port, d_jax) <= 1e-3, name
    assert all(torch.equal(a, b) for a, b in zip(port.lpips.parameters(), lpips_before))
    jeval = jax.jit(jmodel.eval_step)(state, jbatch, rng)
    load_flax_train_state(port, jax.device_get(state))
    for key, value in port.eval_step(batch).items():
        np.testing.assert_allclose(float(value), float(jeval[key]), rtol=1e-5, err_msg=key)


def test_vae_cpu_train_resume_then_generate(tmp_path, monkeypatch):
    """The trainer runs the VAE (validation with the latent table, last/best, resume) and
    generate decodes random latents."""
    import json

    from lightning_generative_models_tpu_torch import generate
    from lightning_generative_models_tpu_torch import train as port_train
    from lightning_generative_models_tpu_torch.train import cli

    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    config = tmp_path / "vae_tiny.json"
    config.write_text(json.dumps({
        "model": {"name": "VAE", "args": VAE_ARGS},
        "dataset": {"name": "MNIST", "img_size": 16, "img_channels": 1, "batch_size": 4,
                    "synthetic_size": 16, "data_dir": str(tmp_path)}}))
    argv = ["--config_path", str(config), "--device", "cpu", "--experiment_name", "run",
            "--check_val_every_n_epoch", "1"]
    assert port_train.main(argv + ["--max_steps", "2"]).step == 2
    run = tmp_path / "experiments" / "VAE" / "run"
    table = json.loads(next(run.glob("latent_space_*.json")).read_text())
    assert table["columns"][-1] == "label" and len(table["columns"]) == 21 and table["rows"]
    assert (run / "checkpoints" / "best").exists()
    assert port_train.main(argv + ["--max_steps", "3", "--resume"]).step == 3
    images = generate.main(["--config_path", str(config), "--num_samples", "2", "--device",
                            "cpu", "--out", str(tmp_path / "out")])
    assert images.shape == (2, 16, 16, 1) and np.isfinite(images).all()
