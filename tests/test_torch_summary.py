"""The port's model summaries (``utils/summary.py``) against the JAX package's, on the CPU.

``param_table`` prints the rows JAX's ``param_table(state.params)`` prints for the same
tiny DDPM (flax paths, flax shapes, dtype, count, in flax's order), text for text.
``module_table`` runs a CPU copy of a module on example inputs: output shapes, parameter
counts and, on the CPU, forward FLOPs; the trainer logs both at fit start when INFO is
logged, and a summary that fails warns without stopping the fit.
"""

import logging

import pytest
import torch

from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu.utils.summary import param_table as jax_param_table
from lightning_generative_models_tpu_torch.data.datamodule import DataModule
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.gan.dcgan import DCGAN
from lightning_generative_models_tpu_torch.train.trainer import Trainer
from lightning_generative_models_tpu_torch.utils import summary
from torch_flax_params import state_from_port

torch.set_num_threads(1)

ARGS = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, num_classes=10,
            diffusion_timesteps=10, sampling_timesteps=2)


def test_param_table_matches_jax():
    port = DDPM(**ARGS, device="cpu")
    state = state_from_port(JaxDDPM(**ARGS), port)
    assert summary.param_table(port) == jax_param_table(state.params)
    rows = summary.param_rows(port)
    assert rows[0][0].startswith("model/") and all(r[2] == "float32" for r in rows)
    assert sum(r[3] for r in rows) == sum(p.numel() for p in port.unet.parameters())


def test_module_table_and_trainer_summary(tmp_path, caplog):
    model = DDPM(**ARGS, device="cpu")
    (module, args, kwargs), = model.summary_spec().values()
    rows = summary.module_rows(module, args, compute_flops=True, **kwargs)
    top = next(r for r in rows if r["layer"] == "UNet")
    assert top["output"] == "(1, 16, 16, 3)" and top["params"] == sum(
        p.numel() for p in model.unet.parameters())
    assert top["flops"] > 0 and sum(r["flops"] for r in rows if "." not in r["layer"]
                                    and r["layer"] != "UNet") <= top["flops"]
    assert "flops" not in summary.module_table(module, args, compute_flops=False, **kwargs)
    gan = DCGAN(img_size=32, img_channels=3, device="cpu")
    tables = {name: summary.module_table(m, a, **kw) for name, (m, a, kw) in
              gan.summary_spec().items()}
    assert set(tables) == {"G", "D"} and "(1, 32, 32, 3)" in tables["G"]

    dm = DataModule(name="CIFAR10", img_size=16, img_channels=3, batch_size=4,
                    synthetic_size=40)
    with caplog.at_level(logging.INFO):
        Trainer(model, dm, tmp_path / "run", max_steps=1, check_val_every_n_epoch=99).fit()
    text = caplog.text
    assert "parameter table" in text and "unet summary" in text and "model/" in text
    model.summary_spec = lambda: {"bad": (torch.nn.Linear(2, 2), (torch.zeros(1, 3),), {})}
    with caplog.at_level(logging.INFO):
        trainer = Trainer(model, dm, tmp_path / "bad", max_steps=1, check_val_every_n_epoch=99)
        trainer.fit()
    assert "model summary failed" in caplog.text and trainer.global_step == 1
