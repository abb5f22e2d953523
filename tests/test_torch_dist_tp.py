"""Tensor, sequence and expert parallelism of the port's DiT over gloo ranks on the CPU:
at dp1 x tp2 (2 ranks) and dp2 x tp2 (4 ranks) a step of ``tp``, ``tp`` with
``seq_parallel`` and of DiT-MoE under ``tp`` (the experts split over the model ranks)
equals one device's step; the JAX trainer's checks raise its texts. Cases in
``torch_dist_cases.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dist_cases as case
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)
NAMES = tuple(case.TP_VARIANTS)


@pytest.fixture(scope="module")
def one_device():
    return case.tp_steps(NAMES, 1)


def _check(ranks, one):
    for got in ranks:
        for name in NAMES:
            ref, rec = one[name], got[name]
            for k, v in ref["metrics"].items():
                np.testing.assert_allclose(rec["metrics"][k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {k}")
            assert case.adam_gap(ref, rec) <= 1e-3, name
            assert case.ema_gap(ref, rec) <= 1e-3, name


@pytest.mark.parametrize("world", [2, 4], ids=["dp1xtp2", "dp2xtp2"])
def test_tp_sp_ep_steps_equal_one_device(tmp_path, one_device, world):
    """Each variant's loss within 1e-5 relative, its update and the EMA's move by their
    norms within 1e-3 (``adam_gap``), on every rank; a whole flax tree loads into the
    tensor-parallel model exactly."""
    tree = case.flax_flat(case.build("DDPM", case.TP_VARIANTS["tp"], perturb=True).unet)
    ranks = case.run_ranks(case.tp_steps, world, tmp_path, NAMES, 2, tree)
    _check(ranks, one_device)
    assert all(got["loaded_max_diff"] == 0.0 for got in ranks)


def test_tp_checks_raise_jax_texts():
    """``validate_tp``: JAX's texts for the s3hd layout, heads, tokens and experts that the
    model axis does not divide, a UNet, a mesh with no model axis; ``validate_pp`` for a
    stage count that is not the axis's."""
    def mesh(tp, axes=("data", "model")):
        return SimpleNamespace(axis_names=axes, size=lambda axis: tp)

    dit = dict(case.DIT)
    for args, tp, text in [
        ({**dit, "qkv_layout": "s3hd"}, 2, "requires qkv_layout='h3d'"),
        ({**dit, "num_heads": 2, "dim": 32}, 4, "DiT heads=2 not divisible by the 4-way"),
        ({**dit, "seq_parallel": True, "img_size": 6}, 2, "seq_parallel: 9 tokens"),
        ({**case.DIT_MOE, "num_experts": 3, "num_heads": 4}, 2,
         "MoE num_experts=3 not divisible by the 2-way"),
    ]:
        with pytest.raises(ValueError, match=text.replace("(", r"\(")):
            mesh_lib.validate_tp(DDPM(**args, device="cpu"), mesh(tp))
    with pytest.raises(ValueError, match="supports the DiT backbone only"):
        mesh_lib.validate_tp(DDPM(**{k: v for k, v in case.DDPM_UNET.items()},
                                  device="cpu"), mesh(2))
    with pytest.raises(ValueError, match="needs a mesh with a 'model' axis"):
        mesh_lib.validate_tp(DDPM(**dit, device="cpu"), mesh(2, ("data",)))
    with pytest.raises(ValueError, match="pipeline_stages=2 does not match the 4-way"):
        mesh_lib.validate_pp(DDPM(**case.DIT_PP, device="cpu"), mesh(4, ("data", "stage")))
