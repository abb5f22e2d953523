"""The port's ``unroll_steps`` and ``profile_steps`` on the CPU, where a dispatch runs
its k steps in a loop (a CUDA graph of them on the card, ``chip_smoke.py`` [45]-[47]).

As the JAX package's ``test_ddpm_trainer_unroll_gated_matches_plain`` and
``test_unroll_steps_matches_single_dispatch`` hold its unrolled dispatch: the unrolled
trainer ends with the plain trainer's weights, EMA weights and Adam state (bit for bit
here: the same steps on the same draws), ``global_step`` advances by k, every cadence is
crossed, and the branch tuples a graph is captured for are JAX's EMA flags. A WGAN's
unrolled dispatch keeps the D/G alternation. The train entry point takes
``--unroll_steps`` and ``--profile_steps``, and writes one trace.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.data.datamodule import DataModule
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.gan.wgan import WGAN
from lightning_generative_models_tpu_torch.train import cli
from lightning_generative_models_tpu_torch.train.graphs import state_tensors, unroll_key
from lightning_generative_models_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DDPM_ARGS = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, lr=1e-3,
                 diffusion_timesteps=20, sampling_timesteps=2, ema_update_every=2,
                 ema_update_after_step=3)


def _dm(**kw):
    args = dict(name="CIFAR10", img_size=16, img_channels=3, batch_size=4, synthetic_size=48)
    return DataModule(**{**args, **kw})


def _fit(tmp_path, sub, model, dm, **kw):
    trainer = Trainer(model, dm, tmp_path / sub, check_val_every_n_epoch=99,
                      sample_every_n_steps=0, log_every_n_steps=1, num_sample_images=4, **kw)
    trainer.fit()
    return trainer


def _state(model):
    return {n: t.detach().clone() for n, t in state_tensors(model).items()}


def test_ddpm_unroll_matches_plain(tmp_path):
    """unroll_steps=2 through the EMA's hard copy and its gated decays: the plain trainer's
    weights, EMA weights and Adam state, bit for bit; the branch tuples are JAX's flags."""
    plain = _fit(tmp_path, "plain", DDPM(**DDPM_ARGS, device="cpu"), _dm(), max_steps=6)
    unrolled = _fit(tmp_path, "unroll", DDPM(**DDPM_ARGS, device="cpu"), _dm(), max_steps=6,
                    unroll_steps=2)
    assert plain.global_step == unrolled.global_step == unrolled.model.step == 6
    a, b = _state(plain.model), _state(unrolled.model)
    assert a.keys() == b.keys() and any("ema_unet" in n for n in a)
    assert any("exp_avg" in n for n in a)
    for name in a:
        assert torch.equal(a[name], b[name]), name

    jmodel = JaxDDPM(**DDPM_ARGS)
    model = unrolled.model
    for step in range(12):
        model.step = step
        flags = tuple(jmodel.ema_step_needed(step + 1 + i) for i in range(2))
        assert tuple(d != 1.0 for d in unroll_key(model, 2)) == flags


def test_unroll_cadence_and_global_step(tmp_path):
    """max_steps 7 at unroll 2: global_step 8, the logs at the dispatches that cross
    log_every_n_steps 3 (and the first and the last), the sample grids where 4 is
    crossed, images_per_sec over 2 batches, the checkpoint at step 8."""
    trainer = Trainer(DDPM(**DDPM_ARGS, device="cpu"), _dm(), tmp_path, max_steps=7,
                      unroll_steps=2, log_every_n_steps=3, sample_every_n_steps=4,
                      check_val_every_n_epoch=99, num_sample_images=4)
    logged = []
    trainer._log_samples = lambda: logged.append(trainer.global_step)
    trainer.fit()
    assert trainer.global_step == 8 and trainer.model.step == 8
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    train = [r for r in records if "train_loss" in r]
    assert [r["step"] for r in train] == [0, 2, 4, 6]
    assert all(np.isfinite(r["train_loss"]) and r["images_per_sec"] > 0 for r in train)
    assert logged == [4, 8, 8]  # the grids at 4 and 8, then the validation's
    meta = json.loads((tmp_path / "checkpoints" / "checkpoint_meta_last.json").read_text())
    assert meta["step"] == 8
    with pytest.raises(ValueError, match="incompatible with scan"):
        Trainer(DDPM(**DDPM_ARGS, device="cpu"), _dm(), tmp_path / "scan", unroll_steps=2,
                accumulate_grad_batches=2, grad_accum_mode="scan")


def test_gan_unrolled_dispatch(tmp_path):
    """WGAN-GP critic cycles of 2 D steps and 1 G step at unroll 2 (dispatches D D, G D):
    the plain trainer's G, D, batch statistics and both Adams bit for bit; the branch
    tuples are the D/G alternation."""
    args = dict(img_size=16, img_channels=3, latent_dim=16, n_critic=2, lr=1e-3,
                constraint_method="gp", device="cpu")
    plain = _fit(tmp_path, "plain", WGAN(**args), _dm(), max_steps=4)
    ref = _state(plain.model)
    unrolled = _fit(tmp_path, "unroll", WGAN(**args), _dm(), max_steps=4, unroll_steps=2)
    got = _state(unrolled.model)
    assert unrolled.model.step == 4 and got.keys() == ref.keys()
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    model = plain.model
    model.step = 0
    assert unroll_key(model, 2) == (True, True)
    model.step = 2
    assert unroll_key(model, 2) == (False, True)


def test_profile_steps_writes_one_trace(tmp_path, monkeypatch):
    """The train entry point with --unroll_steps 2 --profile_steps 2:4: one chrome trace
    under the run's profile/ (the dispatches from step 2 to the first past 4), the run at
    step 6."""
    config = json.loads((ROOT / "configs" / "diffusion" / "ddpm_cifar10.json").read_text())
    config["model"]["args"].update({**DDPM_ARGS, "dim_mults": [1, 2]})
    config["dataset"].update(img_size=16, batch_size=4, synthetic_size=80)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", tmp_path / "experiments")
    model = port_train.main(["--config_path", str(path), "--device", "cpu", "--max_steps",
                             "6", "--experiment_name", "run", "--unroll_steps", "2",
                             "--profile_steps", "2:4"])
    assert model.step == 6
    traces = list((tmp_path / "experiments" / "DDPM" / "run" / "profile").glob("*.json"))
    assert [t.name for t in traces] == ["trace_steps_2_4.json"]
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
