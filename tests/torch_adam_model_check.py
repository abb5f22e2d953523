"""Parity checks of the port's one-net Adam models (DAE, the UNet autoencoder, PixelCNN,
NICE, Glow) against the JAX package's, on the CPU, with one compiled JAX program a model.

``reference`` jits one program over the JAX state made from the port's weights
(``torch_flax_params.state_from_port``): JAX's ``grad_step`` and ``apply_grad_step``, the
draws the step took (``draws(rng, step)`` recomputes them as JAX's step does) and
``refs(state, batch, rng)`` on the state it starts from. The program runs twice, from
step 0 and from step 1 (one compile, the gradient traced once); the references are the
second run's, on the state after one step. ``check_two_steps`` runs the port's two steps
on those draws and holds every metric within rtol 1e-5, each step's gradients each by its
norm within 1e-4 of the reference's, and each step's update by its norm within 1e-3
(Adam's first steps move a weight by about lr whatever its gradient's size, so f32 noise
in a small gradient moves it by up to 2 lr). ``check_npz_loads`` carries a JAX state into
a fresh port model through an ``.npz``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lightning_generative_models_tpu_torch.weights import flatten_tree, load_flax_train_state
from torch_flax_params import as_port, state_from_port

GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
METRIC_RTOL = 1e-5


def off_zero(net: torch.nn.Module, seed: int, std: float = 0.05) -> None:
    """Every parameter that starts at exactly 0 (biases, ActNorm, NICE's scale, Glow's
    zero-initialised coupling convs) drawn from N(0, std^2) instead: at init their
    gradients, and most others', are exactly 0, and a check there tests almost nothing."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            if not p.detach().any():
                p.copy_(torch.randn(p.shape, generator=gen) * std)


def reference(jmodel, port, batch: dict, rng, draws, refs=lambda state, batch, rng: {}):
    """The program's outputs of its two runs (the module doc): per step ``grads``,
    ``metrics``, ``params`` and ``draws``; ``state`` after one step, ``refs`` on it."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def program(state, batch, rng):
        grads, metrics = jmodel.grad_step(state, batch, rng)
        new_state, metrics = jmodel.apply_grad_step(state, grads, metrics)
        return {"grads": grads, "metrics": metrics, "state": new_state,
                "draws": draws(rng, state.step), "refs": refs(state, batch, rng)}

    program = jax.jit(program)
    runs = [program(state_from_port(jmodel, port), jbatch, rng)]
    runs.append(program(runs[0]["state"], jbatch, rng))
    runs = jax.device_get(runs)
    out = {key: [r[key] for r in runs] for key in ("grads", "metrics", "draws")}
    out["params"] = [r["state"].params["model"] for r in runs]
    return {**out, "state": runs[0]["state"], "refs": runs[1]["refs"]}


def as_torch(tree):
    """A JAX output tree (dicts, lists) with every array as a torch tensor."""
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def check_two_steps(port, batch: dict, out: dict, port_draws, net=None,
                    exact_zero=None) -> None:
    """The port's two steps from the reference's starting weights, on ``port_draws(out,
    step)`` (keyword draws of the port's ``grad_step``), against ``out``. ``net`` is the
    module the step trains (``port.net`` by default); ``exact_zero`` masks the elements,
    in the order of its parameters, whose gradient is 0 in exact arithmetic and f32 noise
    on both sides: Adam moves them by +-lr at random, so the update norms leave them out."""
    net = port.net if net is None else net
    params = list(net.parameters())
    before = torch.cat([p.detach().reshape(-1) for p in params])
    jbefore = before
    keep = slice(None) if exact_zero is None else ~exact_zero
    for step in range(2):
        grads, metrics = port.grad_step(batch, **port_draws(out, step))
        for g, ref in zip(grads, as_port(net, out["grads"][step])):
            assert float((g - ref).norm()) <= GRAD_TOL * float(ref.norm()), \
                (step, float((g - ref).norm()), float(ref.norm()))
        metrics = port.apply_grad_step(grads, metrics)
        jmetrics = out["metrics"][step]
        assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
        for key, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=METRIC_RTOL,
                                       err_msg=key)
        after = torch.cat([p.detach().reshape(-1) for p in params])
        jafter = torch.cat([t.reshape(-1) for t in as_port(net, out["params"][step])])
        d_port, d_jax = (after - before)[keep], (jafter - jbefore)[keep]
        assert float((d_port - d_jax).norm()) <= UPDATE_TOL * float(d_jax.norm()), step
        before, jbefore = after, jafter
    assert port.step == 2


def check_npz_loads(make_port, state, tmp_path):
    """The JAX ``state``, flattened into an ``.npz`` with its key paths, fills a fresh port
    model: every weight and Adam moment as the tree holds it, and the step."""
    flat = flatten_tree(jax.device_get(state))
    np.savez(tmp_path / "state.npz", **flat)
    model = make_port()
    load_flax_train_state(model, tmp_path / "state.npz")
    assert model.step == int(flat["step"])
    for p, ref in zip(model.net.parameters(), as_port(model.net, state.params["model"])):
        np.testing.assert_array_equal(p.detach().numpy(), ref.numpy())
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state["model"], is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    for p, mu, nu in zip(model.net.parameters(), as_port(model.net, adam.mu),
                         as_port(model.net, adam.nu)):
        st = model.optimizer.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu.numpy())
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu.numpy())
        assert float(st["step"]) == float(adam.count)
    return model
