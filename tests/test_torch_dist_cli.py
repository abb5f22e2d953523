"""The port's entry points on 2 gloo ranks on the CPU, as ``torchrun`` launches them:
``train --strategy ddp`` logs the one process's metrics once, rank 0 writes one
``metrics.jsonl`` and one checkpoint, which resumes on one process; ``generate`` samples
sharded over the ranks what one process samples. Cases in ``torch_dist_cases.py``."""

import json

import numpy as np
import pytest
import torch

import torch_dist_cases as case
from lightning_generative_models_tpu_torch import generate
from lightning_generative_models_tpu_torch import train as port_train
from lightning_generative_models_tpu_torch.train import cli
from torch_train_cases import _tiny_config

torch.set_num_threads(1)


def _argvs(tmp_path, name):
    config = str(_tiny_config(tmp_path))
    train = ["--config_path", config, "--device", "cpu", "--strategy", "ddp",
             "--experiment_name", name, "--max_steps", "3", "--check_val_every_n_epoch", "1"]
    gen = ["--config_path", config, "--device", "cpu", "--num_samples", "4",
           "--sampling_steps", "2", "--sampler", "ddim", "--out", str(tmp_path / name)]
    return train, gen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(experiments dir, rank 0's samples, one process's samples); the one-process run
    is ``one`` and the 2-rank run ``two``."""
    tmp = tmp_path_factory.mktemp("dist_cli")
    experiments = tmp / "experiments"
    cli.EXPERIMENT_DIR = experiments
    train, gen = _argvs(tmp, "one")
    port_train.main(train)
    one = generate.main(gen)
    train, gen = _argvs(tmp, "two")
    ranks = case.run_ranks(case.cli_train_and_generate, 2, tmp, train, gen, str(experiments))
    return tmp, experiments, one, ranks


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_two_ranks_train_writes_once_equals_one_process_and_resumes(runs, monkeypatch):
    """The 2-rank run's logged records are the one-process run's (train losses and the
    validation loss within 1e-5 relative), written once; its checkpoint resumes on one
    process and trains on to step 4."""
    tmp, experiments, _, _ = runs
    one, two = (_records(experiments / "DDPM" / n) for n in ("one", "two"))
    assert [sorted(r) for r in two] == [sorted(r) for r in one]
    for a, b in zip(one, two):
        for k in ("train_loss", "val_loss"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    meta = json.loads((experiments / "DDPM" / "two" / "checkpoints" /
                       "checkpoint_meta_last.json").read_text())
    assert meta["step"] == 3
    monkeypatch.setattr(cli, "EXPERIMENT_DIR", experiments)
    train, _ = _argvs(tmp, "two")
    model = port_train.main(train[:-4] + ["--max_steps", "4", "--resume"] + train[-2:])
    assert model.step == 4


def test_two_ranks_generate_equals_one_process(runs):
    """Each rank's gathered samples equal one process's within 1e-5; rank 0 wrote the
    grid."""
    tmp, _, one, ranks = runs
    for images in ranks:
        np.testing.assert_allclose(images, one, atol=1e-5)
    assert (tmp / "two" / "grid.png").exists()
