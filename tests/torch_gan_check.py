"""Shared pieces of the GAN family's parity tests (``test_torch_wgan.py``,
``test_torch_gan_cond.py``, ``test_torch_began_cyclegan.py``).

Each model is built from its config under configs/gan/ at the tests' small sizes; the
port draws the weights and hands them to JAX as its ``TrainState``
(``torch_flax_params.state_from_port``). A train step's check (``check_step``) starts the
port from JAX's state and compares, after one step on the same batch and draws:

- every metric (1e-4 relative);
- every running statistic and carried tensor (BEGAN's k_t) element by element (1e-5);
- each weight's gradient, recovered from each optimizer's moments (Adam's first moment:
  g = (m1 - b1 m0) / (1 - b1), weight decay included; RMSprop's nu gives |g|), by the norm
  of the difference (1e-3 of the reference's norm);
- each weight's update by the same norm. Adam's first step moves a weight by
  lr g / (|g| + eps): about lr sign(g) whatever |g|, and by lr eps dg / (|g| + eps)^2 more
  for a gradient dg apart. So where f32 noise can flip a gradient's sign (either side's new
  first moment smaller than their difference) or where the two gradients' difference moves
  the first step by more than 1e-3 lr (|g| near eps), Adam's update is left out. They are
  at most 1% of the weights. RMSprop's first step moves a weight by
  lr g / sqrt(0.01 g^2 + eps), in proportion to g where |g| is small: nothing is left out.

``skip`` names the weights whose gradient is exactly zero (a Dense bias right before a
BatchNorm over [B, F]: the batch mean cancels it), where both frameworks return f32 noise.

Fakes: the two frameworks' generators compute a fake batch apart by f32 noise (~1e-6), and
a LeakyReLU input of D within that noise of 0 takes the other slope on the other side. In
R1GAN's third step a Conv_0 output of 7e-9 does, and JAX's own G gradient moves by 1.4e-3
between JAX's fake batch and the port's (InfoGAN's second step: 1e-2), where on the same
fake batch the two agree to 3e-6. So the JAX step the port is held to runs on the port's
fake batches (``jax_step_on_fakes``): each generator call's value is the port's, its
gradient JAX's own, and each call's distance from JAX's own output is held to FAKE_TOL
(UPDATED_FAKE_TOL on weights the step has updated). ``calls`` maps JAX's generator calls, in
trace order, to the port's, in call order (the GAN base: JAX runs G twice on the same z
where the port runs it once).

The generators' own ReLUs and LeakyReLUs see the same: in ACGAN's first step one ReLU input
of G, behind a BatchNorm, is 5.6e-7, the two frameworks put it on the two sides of 0, and
G's gradient moves by 7e-3. So inside each generator call JAX takes the port's branches,
call by call (``flax.linen.relu`` and ``leaky_relu`` patched while it traces,
``replayed_branches``), and G's weights are held as D's are.

CycleGAN's discriminators are that sensitive too (LeakyReLU behind InstanceNorm, at batch
2: JAX's own G gradient moves by up to 1.1e-2 when every weight moves by 1e-7 of itself).
Its step calls LeakyReLU in the same order in both frameworks, so there (``replay_leaky``)
JAX also takes the port's slopes outside the generators.
"""

import contextlib
import functools
import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from lightning_generative_models_tpu.registry import load_model as jax_load_model
from lightning_generative_models_tpu_torch.registry import load_model
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.weights import (
    _TRANSFORMS,
    _adam_path,
    flatten_tree,
    flax_paths,
    load_flax_train_state,
)
from torch_flax_params import state_from_port

ROOT = Path(__file__).resolve().parents[1]
B = 8
RNG = jax.random.PRNGKey(7)
# max |port's fake - JAX's| / (1 + |JAX's|) of a generator call on the weights the step
# started from; of one on weights that the step has already updated (InfoGAN's Q phase):
# Adam's first step moves each weight by about lr sign(g), so the weights whose gradient's
# sign is f32 noise (those check_step leaves out) stand 2 lr apart (2e-5 at step 0, 1e-6 to
# 3e-6 after).
FAKE_TOL, UPDATED_FAKE_TOL = 1e-5, 1e-4
_STEPS_ON_FAKES = {}


def config(path, **args):
    """The model section of a config under configs/gan/, its args updated by ``args``."""
    model = json.loads((ROOT / "configs" / "gan" / path).read_text())["model"]
    return {"name": model["name"], "args": {**model["args"], **args}}


def uint8_images(size, channels, n=B, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, channels)).astype(
        np.uint8)


def labelled_batch(args, n=B, seed=0):
    """A uint8 image batch at the config's size with labels 0..9 in a seeded order."""
    labels = np.random.RandomState(seed + 1).permutation(np.arange(n) % 10).astype(np.int32)
    return {"image": uint8_images(args["img_size"], args["img_channels"], n, seed),
            "label": labels}


def _f32(net):
    for m in net.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32


def build(cfg, f32_g=False):
    """(JAX model, the TrainState with the weights of a port model). ``f32_g``: G's convs
    in f32 on both sides (ACGAN, SGAN and InfoGAN build DCGAN's ``ConvGenerator`` with its
    bf16 default)."""
    jmodel = jax_load_model(cfg)
    if f32_g:
        jmodel.G = jmodel.G.clone(dtype=jnp.float32)
    return jmodel, state_from_port(jmodel, port_model(cfg, f32_g=f32_g))


def port_model(cfg, state=None, f32_g=False):
    """A fresh port model (f32 G when asked), filled from a JAX ``state`` when given."""
    model = load_model(cfg, device="cpu")
    if f32_g:
        _f32(model.G)
    if state is not None:
        load_flax_train_state(model, jax.device_get(state))
    return model


def flat_state(state):
    return flatten_tree(jax.device_get(state))


def _optimizer_entries(model, flat=None):
    """(kind, optimizer-state prefix, optimizer, weight, the key of its moment in the JAX
    state ``flat`` (None without one), its transform) for every weight that each
    optimizer of the layout covers."""
    layout = model.flax_layout()
    out = []
    for kind in ("adam", "rmsprop"):
        for prefix, (opt, modules) in layout.get(kind, {}).items():
            root = None
            if flat is not None and kind == "adam":
                root = f"{_adam_path(flat, prefix)}/mu"
            elif flat is not None:
                root = {k[:k.index("/nu/")] for k in flat
                        if k.startswith(prefix + "/") and "/nu/" in k}.pop() + "/nu"
            for sub, module in modules.items():
                for path, (p, tr) in flax_paths(module).items():
                    key = None if root is None else "/".join(x for x in (root, sub, path) if x)
                    out.append((kind, prefix, opt, p, key, tr))
    return out


def snapshot(model, flat=None):
    """{"weights"/"stats"/"moments": {...}} of the port model, or of the JAX state ``flat``
    in the port's layout: each weight (by flax path), each running statistic and carried
    tensor, and each optimizer's first moment (Adam) or nu (RMSprop) of each weight."""
    layout = model.flax_layout()
    out = {"weights": {}, "stats": {}, "moments": {}}

    def ref(path, tr):
        return torch.tensor(np.array(_TRANSFORMS[tr](np.asarray(flat[path], np.float32))))

    for kind, buffers in (("params", False), ("buffers", True)):
        for prefix, module in layout.get(kind, {}).items():
            for path, (t, tr) in flax_paths(module, buffers).items():
                key = f"{prefix}/{path}"
                value = t.detach().clone() if flat is None else ref(key, tr)
                out["weights" if kind == "params" else "stats"][key] = value
    for path, t in layout.get("tensors", {}).items():
        out["stats"][path] = (t.detach().clone() if flat is None
                              else torch.tensor(np.asarray(flat[path], np.float32)))
    for kind, prefix, opt, p, key, tr in _optimizer_entries(model, flat):
        if flat is None:
            m = opt.state.get(p, {}).get("exp_avg" if kind == "adam" else "nu")
            value = torch.zeros(p.shape) if m is None else m.detach().clone()
        else:
            value = ref(key, tr)
        out["moments"][(prefix, id(p))] = value
    return out


def _param_paths(model):
    return {id(p): f"{prefix}/{path}" for prefix, module in model.flax_layout()["params"].items()
            for path, (p, _) in flax_paths(module).items()}


def _close(out, ref) -> bool:
    """The difference's norm within 1e-3 of the reference's."""
    return float((out - ref).norm()) <= 1e-3 * float(ref.norm())


def check_step(model, j0, j1, metrics, jmetrics, before, skip=()):
    """One step of the port (from ``before``, its snapshot after loading JAX's state)
    against JAX's (from snapshot ``j0`` of its state to ``j1``), as the module doc says."""
    assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    after = snapshot(model)
    for key, ref in j1["stats"].items():
        np.testing.assert_allclose(after["stats"][key].numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    paths = _param_paths(model)
    keep = {}
    for kind, prefix, opt, p, _, _ in _optimizer_entries(model):
        path = paths[id(p)]
        if path in skip:
            continue
        k = (prefix, id(p))
        if kind == "adam":
            b1, eps = opt.param_groups[0]["betas"][0], opt.param_groups[0]["eps"]
            g_port = (after["moments"][k] - b1 * before["moments"][k]) / (1 - b1)
            g_jax = (j1["moments"][k] - b1 * j0["moments"][k]) / (1 - b1)
            m_port, m_jax = after["moments"][k], j1["moments"][k]
            kept = (m_port - m_jax).abs() < torch.minimum(m_port.abs(), m_jax.abs())
            small = torch.minimum(g_port.abs(), g_jax.abs())
            kept &= eps * (g_port - g_jax).abs() <= 1e-3 * (small + eps) ** 2
            kept |= g_port == g_jax  # among them an optimizer that did not step
        else:
            d = opt.param_groups[0]["decay"]
            g_port = ((after["moments"][k] - d * before["moments"][k]) / (1 - d)).clamp(0).sqrt()
            g_jax = ((j1["moments"][k] - d * j0["moments"][k]) / (1 - d)).clamp(0).sqrt()
            kept = torch.ones_like(g_jax, dtype=torch.bool)
        assert _close(g_port, g_jax), (
            "gradient", path, prefix, float((g_port - g_jax).norm()), float(g_jax.norm()))
        keep[path] = keep.get(path, True) & kept
    left_out = elements = 0
    for path, p0 in before["weights"].items():
        if path in skip:
            continue
        kept = keep.get(path, torch.ones_like(p0, dtype=torch.bool))
        left_out += int((~kept).sum())
        elements += kept.numel()
        d_jax = (j1["weights"][path] - j0["weights"][path]) * kept
        d_port = (after["weights"][path] - p0) * kept
        assert _close(d_port, d_jax), (
            "update", path, float((d_port - d_jax).norm()), float(d_jax.norm()))
    assert left_out <= 1e-2 * elements, (left_out, elements)


def jax_step_on_fakes(jmodel, calls, generator_types, refs=None):
    """JAX's ``train_step(state, batch, rng, fakes, branches, slopes, inputs)`` on the
    port's fake batches and branches (module doc), followed in the same program by
    ``refs(jmodel, state, batch, rng, inputs)`` on the state it returns (else None). Its
    k-th top-level call of a generator (a module of ``generator_types``) takes at its i-th
    ReLU or LeakyReLU the port's branches ``branches[calls[k]][i]`` (the slope 1 where True,
    its own elsewhere), and its value is replaced by ``fakes[calls[k]]``, its gradient its
    own: x + stop_gradient(fake - x). With ``slopes`` (a tuple of bool masks, else None) its
    i-th LeakyReLU call outside the generators takes ``slopes[i]`` the same way. Returns the
    jitted program and a dict that each run of it fills with {trace index of a generator
    call that ran: max |fake - x| / (1 + |x|)} (a debug callback: a value under jax.grad
    cannot be returned)."""
    errors = {}

    def step(state, batch, rng, fakes, branches, slopes, inputs):
        trace = {"calls": 0, "outside": 0, "masks": None}

        def take(leaky):
            if trace["masks"] is not None:
                return trace["masks"].pop(0)
            if leaky and slopes is not None:
                trace["outside"] += 1
                return slopes[trace["outside"] - 1]
            return None

        def interceptor(next_fun, args, kwargs, context):
            if not (context.method_name == "__call__"
                    and isinstance(context.module, generator_types)
                    and not isinstance(context.module.parent, fnn.Module)):
                return next_fun(*args, **kwargs)
            i, k = trace["calls"], calls[trace["calls"]]
            trace["calls"] += 1
            trace["masks"] = list(branches[k])
            out = next_fun(*args, **kwargs)
            assert not trace["masks"], ("branches left", k, len(trace["masks"]))
            trace["masks"] = None
            jax.debug.callback(functools.partial(errors.__setitem__, i),
                               jnp.max(jnp.abs(fakes[k] - out) / (1 + jnp.abs(out))))
            return out + jax.lax.stop_gradient(fakes[k] - out)

        with replayed_branches(take), fnn.intercept_methods(interceptor):
            state, metrics = jmodel.train_step(state, batch, rng)
        assert trace["calls"] == len(calls), (trace["calls"], calls)
        assert slopes is None or trace["outside"] == len(slopes), (trace["outside"], len(slopes))
        return state, metrics, None if refs is None else refs(jmodel, state, batch, rng, inputs)

    return jax.jit(step), errors


@contextlib.contextmanager
def replayed_branches(take):
    """flax.linen's relu and leaky_relu, while JAX traces, take the branch ``take(leaky)``
    gives for each call in turn (the slope 1 where True, their own elsewhere), or are
    themselves where it gives None."""
    relu, leaky_relu = fnn.relu, fnn.leaky_relu

    def replayed_relu(x):
        mask = take(False)
        return relu(x) if mask is None else jnp.where(mask, x, 0.0)

    def replayed_leaky_relu(x, negative_slope=0.01):
        mask = take(True)
        return (leaky_relu(x, negative_slope) if mask is None
                else jnp.where(mask, x, negative_slope * x))

    fnn.relu, fnn.leaky_relu = replayed_relu, replayed_leaky_relu
    try:
        yield
    finally:
        fnn.relu, fnn.leaky_relu = relu, leaky_relu


@contextlib.contextmanager
def recorded_branches(record):
    """The port's ReLU and LeakyReLU calls hand ``record(mask, leaky)`` the branch each
    input takes (> 0), as a JAX array, in call order."""
    F = torch.nn.functional
    relu, leaky_relu = F.relu, F.leaky_relu

    def recorded_relu(x, inplace=False):
        record(jnp.asarray((x > 0).detach().numpy()), False)
        return relu(x, inplace)

    def recorded_leaky_relu(x, negative_slope=0.01, inplace=False):
        record(jnp.asarray((x > 0).detach().numpy()), True)
        return leaky_relu(x, negative_slope, inplace)

    F.relu, F.leaky_relu = recorded_relu, recorded_leaky_relu
    try:
        yield
    finally:
        F.relu, F.leaky_relu = relu, leaky_relu


def port_step_with_fakes(model, nets, batch, record_slopes=False, **draws):
    """The port's ``train_step``; the output of every call of ``nets``, in order; the
    branch that each ReLU or LeakyReLU input inside each such call took (> 0), in order;
    and (``record_slopes``) the same of every LeakyReLU call outside them (else None)."""
    fakes, branches, slopes, inside = [], [], [], []

    def record(mask, leaky):
        if inside:
            inside[-1].append(mask)
        elif leaky and record_slopes:
            slopes.append(mask)

    def pre(module, args):
        inside.append([])

    def post(module, args, out):
        fakes.append(jnp.asarray(out.detach().float().numpy()))
        branches.append(tuple(inside.pop()))

    handles = [h for net in nets for h in (net.register_forward_pre_hook(pre),
                                           net.register_forward_hook(post))]
    try:
        with recorded_branches(record):
            metrics = model.train_step(batch, **draws)
    finally:
        for h in handles:
            h.remove()
    return metrics, tuple(fakes), tuple(branches), tuple(slopes) if record_slopes else None


def run_steps(build_out, cfg, batch, draws, calls, steps=3, skip=(), f32_g=False,
              generators=("G",), replay_leaky=False, updated=(), refs=None, inputs=None):
    """``steps`` train steps of the port against JAX's on the port's fakes and branches
    (module doc), each from JAX's state: ``draws(jmodel, step)`` gives the port's keyword
    draws for the JAX step at ``step``; ``generators`` names the nets whose calls make
    fakes; ``replay_leaky``: JAX also takes the port's LeakyReLU branches outside them;
    ``updated``: JAX's generator calls (trace indices) on weights the step has updated.
    ``refs`` and ``inputs``: as jax_step_on_fakes (the references that the model's other
    tests hold the port to, in the step's program: one compile a model). Returns the last
    JAX state and what ``refs`` gave on it."""
    jmodel, state = build_out
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = (id(jmodel), calls, generators)
    if key not in _STEPS_ON_FAKES:  # one compile per model and module
        _STEPS_ON_FAKES[key] = jax_step_on_fakes(
            jmodel, calls, tuple({type(getattr(jmodel, g)) for g in generators}), refs)
    train_step, errors = _STEPS_ON_FAKES[key]
    model = port_model(cfg, f32_g=f32_g)
    start = int(state.step)
    j0 = snapshot(model, flat_state(state))
    for step in range(start, start + steps):
        load_flax_train_state(model, jax.device_get(state))
        before = snapshot(model)
        metrics, fakes, branches, slopes = port_step_with_fakes(
            model, [getattr(model, g) for g in generators], batch, replay_leaky,
            **draws(jmodel, step))
        errors.clear()
        state, jmetrics, out = train_step(state, jbatch, RNG, fakes, branches, slopes, inputs)
        jax.effects_barrier()
        # The fakes JAX runs on are its own generator's outputs to f32 noise.
        assert errors and all(err <= (UPDATED_FAKE_TOL if i in updated else FAKE_TOL)
                              for i, err in errors.items()), ("fakes", step, errors)
        j1 = snapshot(model, flat_state(state))
        check_step(model, j0, j1, metrics, jmetrics, before, skip)
        j0 = j1
    assert model.step == int(state.step) == start + steps
    return state, out


def check_npz_loads(cfg, state, tmp_path, f32_g=False):
    """``state`` flattened to an .npz with JAX's key paths loads through
    load_flax_train_state into the same weights, statistics, carried tensors, optimizer
    states and step as the tree itself; returns that model."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    np.savez(tmp_path / "state.npz", **{"/".join(_key_name(k) for k in p): np.asarray(v)
                                        for p, v in leaves})
    from_npz = port_model(cfg, f32_g=f32_g)
    load_flax_train_state(from_npz, tmp_path / "state.npz")
    from_tree = port_model(cfg, state, f32_g=f32_g)
    assert from_npz.step == from_tree.step == int(state.step)
    flat = [flatten_tree(m.state_dict()) for m in (from_npz, from_tree)]
    assert flat[0].keys() == flat[1].keys()
    for key in flat[0]:
        np.testing.assert_array_equal(flat[0][key], flat[1][key], err_msg=key)
    return from_npz


def _key_name(k):
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def check_close(out, ref, tol, what=""):
    """max |out - ref| / (1 + |ref|) <= tol."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = float(np.max(np.abs(out - ref) / (1 + np.abs(ref))))
    assert err <= tol, (what, err)


def check_metrics(metrics, jmetrics, rtol=1e-5):
    assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=rtol, atol=1e-6,
                                   err_msg=key)


def checkpoint_round_trip(cfg, batch, tmp_path):
    """Two steps, a save through the trainer's CheckpointManager, a restore into a fresh
    model; then both take two more steps on the same batch and generator seeds: every
    weight, statistic, carried tensor and optimizer state equal bit for bit. Returns the
    flattened state."""
    model = load_model(cfg, device="cpu")
    for step in range(2):
        model.train_step(batch, torch.Generator().manual_seed(step))
    manager = CheckpointManager(tmp_path / "checkpoints", monitor=model.monitor)
    manager.save_last(model, model.step, 0)
    restored = load_model(cfg, device="cpu")
    assert manager.restore(restored) == (2, 0) and restored.step == 2
    for step in range(2, 4):
        for m in (model, restored):
            m.train_step(batch, torch.Generator().manual_seed(step))
    flat = [flatten_tree(m.state_dict()) for m in (model, restored)]
    assert flat[0].keys() == flat[1].keys()
    for key in flat[0]:
        np.testing.assert_array_equal(flat[0][key], flat[1][key], err_msg=key)
    return flat[0]
