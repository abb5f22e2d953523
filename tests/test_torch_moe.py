"""The port's MoE MLP and DiT-MoE DDPM against the JAX package's, on the CPU, in f32.

``MoEMlp`` (Switch top-1 routing, GShard one-hot dispatch, capacity dropping) runs on
the same weights as flax's: outputs within 1e-5, the load-balancing loss within 1e-6,
gradients within 1e-4 of their norms, with tokens dropped at a capacity factor below 1
(asserted: their outputs are exactly zero on both sides). A tiny class-conditional
DiT-MoE DDPM (depth 2, h3d, four experts on the last block, 16 tokens, capacity 4 a row)
takes two train steps against JAX's compiled step (``torch_adam_model_check``): metrics
rtol 1e-5, gradients 1e-4 and updates 1e-3 of their norms. Top-1 routing flips when a
token's two best router probabilities lie within f32 noise: each test reports the
smallest top-2 margin of its inputs and requires it to be far above that noise, so
that the comparison is of the same routing.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_generative_models_tpu.models.diffusion import dit as JD
from lightning_generative_models_tpu.models.diffusion.ddpm import DDPM as JaxDDPM
from lightning_generative_models_tpu.models.modules.moe import MoEMlp as JaxMoE
from lightning_generative_models_tpu_torch.models.diffusion import dit as TD
from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
from lightning_generative_models_tpu_torch.models.modules.layers import init_params
from lightning_generative_models_tpu_torch.models.modules.moe import MoEMlp
from lightning_generative_models_tpu_torch.weights import flatten_tree, load_flax_train_state
from torch_adam_model_check import check_two_steps, reference
from torch_flax_params import as_port, flax_tree, init_shapes, k_bias_mask

torch.set_num_threads(1)

D, F_DIM, E = 16, 32, 4
MARGIN = 1e-5  # f32 noise in a router probability is ~1e-7
ARGS = dict(img_size=8, img_channels=3, network="dit", dim=32, depth=2, num_heads=2,
            patch_size=2, qkv_layout="h3d", num_experts=E, moe_every=2,
            capacity_factor=1.0, moe_aux_weight=0.5, num_classes=3, cond_drop_prob=0.5,
            use_bf16=False, lr=1e-3, diffusion_timesteps=100, sampling_timesteps=3)


def _top2_margin(probs) -> float:
    top = torch.topk(torch.as_tensor(np.asarray(probs.detach())), 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def _moe_pair(capacity_factor, seed=0):
    port = init_params(MoEMlp(D, F_DIM, E, capacity_factor), torch.Generator().manual_seed(seed))
    with torch.no_grad():  # the router's zero bias and the experts' biases off zero
        for p in (port.router.bias, port.bi, port.bo):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 1)))
    jmod = JaxMoE(hidden=D, mlp_dim=F_DIM, num_experts=E, capacity_factor=capacity_factor)
    x = np.random.RandomState(seed).randn(3, 16, D).astype(np.float32)
    params = flax_tree(port, init_shapes(jmod, jnp.asarray(x)))
    return port, jmod, params, x


def test_moe_mlp_matches_flax_with_drops():
    port, jmod, params, x = _moe_pair(capacity_factor=0.5)
    w = np.random.RandomState(5).randn(3, 16, D).astype(np.float32)

    def jloss(params, x):
        out, col = jmod.apply({"params": params}, x, mutable=["intermediates"])
        aux = col["intermediates"]["moe_aux"][0]
        return jnp.sum(out * w) + 0.5 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out, aux = port(xt)
    loss = (out * torch.from_numpy(w)).sum() + 0.5 * aux
    grads = torch.autograd.grad(loss, [xt, *port.parameters()])

    with torch.no_grad():
        probs, choice = port.route(torch.from_numpy(x))
    dispatch = port.dispatch(probs, choice)[0]
    dropped = dispatch.sum(dim=(2, 3)) == 0
    cap = math.ceil(16 * 0.5 / E)
    assert dispatch.shape == (3, 16, E, cap)
    assert 0 < int(dropped.sum()) < 48, int(dropped.sum())  # the capacity drops tokens
    assert torch.equal(out.detach()[dropped], torch.zeros_like(out[dropped]))
    assert np.all(np.asarray(jout)[dropped.numpy()] == 0.0)
    assert _top2_margin(probs) > MARGIN, _top2_margin(probs)

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-6, rtol=0)
    refs = [torch.from_numpy(np.array(jgx))] + as_port(port, jgp)
    for g, ref in zip(grads, refs):
        assert float((g - ref).norm()) <= 1e-4 * float(ref.norm()), \
            (float((g - ref).norm()), float(ref.norm()))


def test_moe_routing_ties_capacity_and_aux_before_drops():
    """The first maximum wins a tie (``jnp.argmax``); each expert takes ``ceil(n *
    capacity_factor / e)`` tokens a row, the first in token order; the aux loss counts
    every routed token, dropped or not."""
    moe = MoEMlp(D, F_DIM, E, capacity_factor=0.5)
    probs = torch.full((1, 6, E), 0.1)
    probs[0, :, 2] = 0.35
    probs[0, :, 3] = 0.35  # ties between experts 2 and 3
    probs[0, 5] = torch.tensor([0.7, 0.1, 0.1, 0.1])
    choice = probs.argmax(-1)
    assert choice.tolist() == [[2, 2, 2, 2, 2, 0]]
    assert int(jnp.argmax(jnp.asarray(probs.numpy()), -1)[0, 0]) == 2
    dispatch, combine, aux = moe.dispatch(probs, choice)
    assert moe.capacity(6) == 1 and dispatch.shape == (1, 6, E, 1)
    assert dispatch[0, :, 2, 0].tolist() == [1, 0, 0, 0, 0, 0]  # the first token only
    assert dispatch[0, 5, 0, 0] == 1
    assert torch.allclose(combine[0, 0, 2, 0], torch.tensor(0.35))
    f = torch.tensor([1 / 6, 0, 5 / 6, 0])
    assert torch.allclose(aux, E * (f * probs.mean(dim=(0, 1))).sum())


def test_dit_moe_blocks_names_and_refusals():
    """Block i is MoE when (depth - 1 - i) % moe_every == 0; the parameter paths and
    shapes are flax's (``block_i/moe/{router,wi,bi,wo,bo}``); the UNet refuses experts and
    the pipeline stages refuse them with JAX's text."""
    net = TD.DiT(hidden=32, depth=5, heads=2, num_experts=3, moe_every=2, num_classes=3)
    assert [b.moe is not None for b in net.blocks] == [True, False, True, False, True]
    init_params(net, torch.Generator().manual_seed(0))
    shapes = init_shapes(JD.DiT(hidden=32, depth=5, heads=2, num_experts=3, moe_every=2,
                                num_classes=3), jnp.zeros((1, 8, 8, 3)),
                         jnp.zeros((1,), jnp.int32), labels=jnp.zeros((1,), jnp.int32))
    tree = flatten_tree(flax_tree(net, shapes))
    assert tree["block_4/moe/wi"].shape == (3, 32, 128)
    assert "block_3/fc1/kernel" in tree and "block_3/moe/wi" not in tree
    x, t = torch.zeros(2, 8, 8, 3), torch.zeros(2, dtype=torch.long)
    out, aux = net(x, t, labels=torch.zeros(2, dtype=torch.long), return_aux=True)
    assert out.shape == (2, 8, 8, 3) and aux.ndim == 0 and float(aux.detach()) > 0
    with pytest.raises(ValueError, match="DiT backbone only"):
        DDPM(img_size=8, dim=16, dim_mults=(1, 2), num_experts=2, device="cpu")
    with pytest.raises(ValueError, match="pipeline_stages is incompatible with num_experts"):
        TD.DiT(hidden=32, depth=2, heads=2, num_experts=2, pipeline_stages=2)


def _draws(model, shape):
    def draws(rng, step):
        rng = jax.random.fold_in(rng, step)
        aug_rng, loss_rng, drop_rng = jax.random.split(rng, 3)
        t_rng, noise_rng, _, _, _ = jax.random.split(loss_rng, 5)
        return {"flip": jax.random.bernoulli(aug_rng, 0.5, (shape[0], 1, 1, 1)).reshape(-1),
                "drop": jax.random.bernoulli(drop_rng, model.cond_drop_prob, (shape[0],)),
                "t": jax.random.randint(t_rng, (shape[0],), 0,
                                        model.diffusion.num_timesteps),
                "noise": jax.random.normal(noise_rng, shape)}
    return draws


def _port_ddpm():
    ddpm = DDPM(**ARGS, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():  # adaLN-Zero's zeros off zero: the branches open
        for p in ddpm.unet.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    ddpm.copy_params_to_ema()
    return ddpm


@pytest.fixture(scope="module")
def moe_run():
    """JAX's two compiled steps from the port's (perturbed) weights."""
    jmodel, port = JaxDDPM(**ARGS), _port_ddpm()
    rs = np.random.RandomState(4)
    batch = {"image": rs.randint(0, 256, (4, 8, 8, 3)).astype(np.uint8),
             "label": np.array([0, 1, 2, 1], np.int32)}
    out = reference(jmodel, port, batch, jax.random.PRNGKey(11), _draws(jmodel, (4, 8, 8, 3)))
    return jmodel, port, batch, out


def test_dit_moe_train_steps_match_jax(moe_run):
    _, port, batch, out = moe_run
    moe = port.unet.block_1.moe
    seen = []
    route = moe.route

    def recording_route(x):
        probs, choice = route(x)
        seen.append(probs.detach())
        return probs, choice

    moe.route = recording_route

    def port_draws(out, step):
        d = {k: torch.tensor(np.asarray(v)) for k, v in out["draws"][step].items()}
        d["t"] = d["t"].long()
        return d

    check_two_steps(port, batch, out, port_draws, net=port.unet,
                    exact_zero=k_bias_mask(port.unet, "h3d", heads=2))
    assert set(out["metrics"][0]) == {"train_loss", "train_moe_aux"}
    assert all(float(m["train_moe_aux"]) > 0 for m in out["metrics"])
    margin = min(_top2_margin(p) for p in seen)
    assert margin > MARGIN, margin
    cap = moe.capacity(16)
    assert any(int((p.argmax(-1)[..., None] == torch.arange(E)).sum(1).max()) > cap
               for p in seen)  # some expert overflows its capacity in a row


def test_dit_moe_train_state_loads_from_jax(moe_run, tmp_path):
    """JAX's state after one step, as an ``.npz``, fills a fresh port DDPM: the MoE
    leaves, their Adam moments and count, the EMA weights and the step."""
    _, _, _, out = moe_run
    state = out["state"]
    np.savez(tmp_path / "state.npz", **flatten_tree(jax.device_get(state)))
    ddpm = DDPM(**ARGS, device="cpu")
    load_flax_train_state(ddpm, tmp_path / "state.npz")
    assert ddpm.step == 1
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state["model"], is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    named = dict(ddpm.unet.named_parameters())
    for (name, p), ref, mu, nu in zip(named.items(), as_port(ddpm.unet, state.params["model"]),
                                      as_port(ddpm.unet, adam.mu), as_port(ddpm.unet, adam.nu)):
        np.testing.assert_array_equal(p.detach().numpy(), ref.numpy(), err_msg=name)
        st = ddpm.optimizer.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu.numpy(), err_msg=name)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu.numpy(), err_msg=name)
    assert any(".moe.wi" in n for n in named)
    for p, ref in zip(ddpm.ema_unet.parameters(), as_port(ddpm.unet, state.ema_params)):
        np.testing.assert_array_equal(p.detach().numpy(), ref.numpy())
