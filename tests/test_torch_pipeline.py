"""The port's GPipe DiT (``models/diffusion/pipeline.py``) on the CPU: on one process it
equals the JAX package's pipeline DiT with the same stage-stacked weights (carried by
``weights.py``) at (stages, microbatches) (2, 2), (2, 4), (4, 4) and where the batch
degrades the microbatch count to its gcd; ``pp`` over 2 gloo ranks equals one process's
step and samples; MoE under the pipeline raises JAX's text."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as case
from lightning_generative_models_tpu.models.diffusion import dit as JD
from lightning_generative_models_tpu_torch.models.diffusion import dit as TD
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.weights import flax_paths, load_flax_params
from torch_flax_params import _INVERSE, init_shapes

torch.set_num_threads(1)
NET = dict(hidden=32, depth=4, heads=4, patch_size=2, channels=3, num_classes=3)


def _stacked_tree(net, stages: int) -> dict:
    """The port pipeline DiT's weights (moved off zero) as JAX's tree: each stage's
    block leaves stacked on a leading [S] axis under ``pipeline/stages/block_j``."""
    rs = np.random.RandomState(0)
    flat = {path: np.array(_INVERSE[tr](p.detach().numpy()), order="C")
            + rs.randn(*p.shape).astype(np.float32).reshape(
                _INVERSE[tr](p.detach().numpy()).shape) * 0.1
            for path, (p, tr) in flax_paths(net).items()}
    tree = {}
    for path, value in flat.items():
        head, sep, tail = path.partition("pipeline/stages/")
        if sep:
            s, rest = tail.split("/", 1)
            key = f"pipeline/stages/{rest}"
            tree.setdefault(key, [None] * stages)[int(s)] = value
        else:
            tree[path] = value
    nested = {}
    for path, value in tree.items():
        node = nested
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.stack(value) if isinstance(value, list) else value
    return nested


@pytest.mark.parametrize("stages,micro,batch", [(2, 2, 4), (2, 4, 4), (4, 4, 4), (2, 4, 3)],
                         ids=["S2M2", "S2M4", "S4M4", "gcd_b3"])
def test_pipeline_dit_matches_jax_stacked(stages, micro, batch):
    """The forward within atol 1e-5 of JAX's (einsum attention on both sides), the
    port's weights loaded from JAX's stacked tree; b 3 with M 4 runs one microbatch."""
    kw = dict(NET, pipeline_stages=stages, pipeline_microbatches=micro)
    net = init_params(TD.DiT(**kw), torch.Generator().manual_seed(0))
    jnet = JD.DiT(**kw)
    x = np.random.RandomState(1).randn(batch, 8, 8, 3).astype(np.float32)
    t = (np.arange(batch) * 31 % 100).astype(np.int32)
    labels = (np.arange(batch) % 4).astype(np.int32)
    shapes = init_shapes(jnet, jnp.asarray(x), jnp.asarray(t), labels=jnp.asarray(labels))
    tree = _stacked_tree(net, stages)
    got_shapes = jax.tree_util.tree_map(np.shape, tree)
    assert got_shapes == jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    want = np.asarray(jnet.apply({"params": tree}, jnp.asarray(x), jnp.asarray(t),
                                 labels=jnp.asarray(labels)))
    load_flax_params(net, tree)
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t).long(),
                  labels=torch.from_numpy(labels).long()).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_pp_two_ranks_equal_one_process(tmp_path):
    """``pp`` on 2 ranks (one stage each: activations sent between them, the output
    broadcast) against the one-process schedule: the loss within 1e-5 relative, the
    update and the EMA's move by their norms within 1e-3, samples within 1e-5; each rank
    holds its own stage's weights and EMA weights and none of the other stage's; the
    trainer would run ``--unroll_steps`` as an eager loop there (the stages' send/recv),
    as one CUDA graph on one process."""
    batch = case.batch_for(case.DIT_PP)
    one = case.pp_step_and_sample(batch, "ddp")
    stage = one["held"][0]
    assert stage > 0 and one["held"] == [stage] * 4 and one["unroll_in_graph"]
    for rank, rec in enumerate(case.run_ranks(case.pp_step_and_sample, 2, tmp_path, batch)):
        assert rec["held"] == [stage * (s == rank) for s in (0, 1)] * 2
        assert not rec["unroll_in_graph"]
        np.testing.assert_allclose(rec["metrics"]["train_loss"],
                                   one["metrics"]["train_loss"], rtol=1e-5)
        assert case.adam_gap(one, rec) <= 1e-3
        assert case.ema_gap(one, rec) <= 1e-3
        np.testing.assert_allclose(rec["samples"].numpy(), one["samples"].numpy(), atol=1e-5)


def test_pipeline_with_moe_raises_jax_text():
    for kw in ({"num_experts": 2}, {"seq_parallel": True}, {"flash_attn": True}):
        with pytest.raises(ValueError, match="pipeline_stages is incompatible with "
                           "num_experts, seq_parallel and flash_attn"):
            TD.DiT(**NET, pipeline_stages=2, **kw)
    with pytest.raises(ValueError, match="depth 4 not divisible by pipeline_stages=3"):
        TD.DiT(**NET, pipeline_stages=3)
