"""Shared cases of the port's scale-out tests (``test_torch_dist_*.py``,
``test_torch_pipeline.py``): a gloo group of spawned ranks on the CPU, and one train step
of a model recorded so that N ranks can be held against one process.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes (the ``spawn``
start method, one thread each) that join a gloo group through a ``file://`` rendezvous
under ``tmp_path`` (no TCP port, so xdist workers never collide) with a 60 s timeout,
run ``fn(*args)`` and hand its result back; a rank that fails or outlives the limit fails
the test. The functions the ranks run live here: this module imports nothing of JAX, so
a rank starts with torch and the port alone.

``step_record`` takes ``steps`` train steps of a model under a strategy (the trainer's
placement: the rank's rows of the global batch, the global batch's draws) and returns the
data ranks' mean metrics and the whole state after (``gathered``) next to the state
before, so that an update is compared by its norm (Adam's first step moves a weight by
about ±lr whatever its gradient's size: ``adam_gap`` leaves out the elements whose first
moment is within the two sides' difference of 0, as the GAN tests do).
"""

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib
from lightning_generative_models_tpu_torch.registry import load_model

TIMEOUT_S = 60
B = 4  # the global batch

# The EMA decays every step by 0.9, so that its move (0.1 of the update) stands well
# above the f32 resolution of the EMA weights themselves.
DDPM_UNET = dict(img_size=16, dim=16, dim_mults=(1, 2), use_bf16=False, lr=1e-3,
                 diffusion_timesteps=100, ema_update_after_step=0, ema_update_every=1,
                 ema_decay=0.9)
DIT = dict(img_size=8, network="dit", dim=32, depth=2, num_heads=4, patch_size=2,
           qkv_layout="h3d", num_classes=3, use_bf16=False, lr=1e-3,
           diffusion_timesteps=100, sampling_timesteps=3, cond_drop_prob=0.5,
           ema_update_after_step=0, ema_update_every=1, ema_decay=0.9)
DIT_MOE = {**DIT, "num_experts": 4, "moe_every": 2, "capacity_factor": 1.0,
           "moe_aux_weight": 0.5}
DIT_PP = {**DIT, "depth": 4, "qkv_layout": "s3hd", "pipeline_stages": 2,
          "pipeline_microbatches": 2}
DCGAN = dict(img_size=28, img_channels=1, use_bf16=False)
MNIST_COND = dict(img_size=28, img_channels=1, num_classes=10)  # CGAN, SGAN
INFOGAN = dict(img_size=28, img_channels=1, categorical_code_dim=2, continuous_code_dim=2)
VQVAE_EMA = dict(img_channels=3, img_size=16, embedding_dim=4, num_embeddings=16,
                 hidden_dim=8, num_residual_layers=1, num_residual_hiddens=4, use_ema=True)


def batch_for(args: dict, seed: int = 0, n: int = B) -> dict:
    rs = np.random.RandomState(seed)
    size, ch = args["img_size"], args.get("img_channels", 3)
    return {"image": rs.randint(0, 256, (n, size, size, ch)).astype(np.uint8),
            "label": (np.arange(n) % 3).astype(np.int32)}


# -- the ranks -----------------------------------------------------------------------
def _entry(fn, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        import datetime

        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args):
    """[fn(*args) on rank r for r in range(world)] over a spawned gloo group."""
    out_dir = tmp_path / f"ranks_{fn.__name__}_{world}"
    out_dir.mkdir(parents=True)
    init = f"file://{out_dir / 'rendezvous'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=3 * TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = [f.read_text() for f in sorted(out_dir.glob("rank*.err"))]
    assert not errors and all(p.exitcode == 0 for p in procs), \
        ([p.exitcode for p in procs], errors)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- one step, recorded ------------------------------------------------------------------
def _flat_state(model) -> dict:
    """The model's whole state, as one device holds it: {"param/<module>.<name>",
    "mu/<module>.<name>" (Adam's first moment), "buffer/<module>.<name>": tensor}."""
    out = {}
    with mesh_lib.gathered(model):
        moments = {}
        for opt in mesh_lib._optimizers(model):
            for p, state in opt.state.items():
                if "exp_avg" in state:
                    moments[p] = state["exp_avg"]
        for mname, module in mesh_lib._modules(model).items():
            for name, p in module.named_parameters():
                out[f"param/{mname}.{name}"] = p.detach().clone()
                if p in moments:
                    out[f"mu/{mname}.{name}"] = moments[p].detach().float().clone()
            for name, b in module.named_buffers():
                if b.is_floating_point():
                    out[f"buffer/{mname}.{name}"] = b.detach().clone()
    return out


def build(name: str, args: dict, perturb: bool = False):
    """The model, drawn from seed 0; ``perturb`` opens a DiT's zero-initialised branches
    (every weight moved by N(0, 0.1^2), the EMA copied)."""
    model = load_model({"name": name, "args": args}, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    if perturb:
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in model.unet.parameters():
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
        model.copy_params_to_ema()
    return model


def step_record(name: str, args: dict, batch: dict, seed: int = 5, steps: int = 1,
                strategy: str = "ddp", tp_size: int = 0, pp_size: int = 0,
                perturb: bool = False, model=None, draws=None, save_to=None):
    """``steps`` train steps under ``strategy`` (one process: no group, the whole batch)
    -> {"metrics", "before", "after"}; ``draws`` (global arrays) replace the generator's;
    ``save_to`` writes a checkpoint after, as the trainer does."""
    model = model if model is not None else build(name, args, perturb)
    mesh = mesh_lib.strategy_mesh(strategy, tp_size, pp_size)
    if strategy == "tp":
        mesh_lib.validate_tp(model, mesh)
    elif strategy == "pp":
        mesh_lib.validate_pp(model, mesh)
    mesh_lib.set_mesh(None)
    before = _flat_state(model)
    mesh_lib.shard_model(model, strategy, mesh)
    local = mesh_lib.local_rows(batch)
    rows = local["image"].shape[0]
    for i in range(steps):
        with mesh_lib.global_draws(rows):
            if draws is None:
                metrics = model.train_step(local, torch.Generator().manual_seed(seed + i))
            else:
                metrics = model.train_step(local, **{
                    k: torch.tensor(mesh_lib.process_local_slice(np.asarray(v)))
                    for k, v in draws.items()})
    metrics = {k: float(mesh_lib.data_mean(torch.as_tensor(v))) for k, v in metrics.items()}
    if save_to is not None:
        from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager

        CheckpointManager(save_to).save_last(model, model.step, 0)
    after = _flat_state(model)
    mesh_lib.set_mesh(None)
    return {"metrics": metrics, "before": before, "after": after}


def _keep(ref: dict, got: dict, name: str) -> torch.Tensor:
    """False where the first moment of weight ``name`` on either side lies within the
    sides' difference of 0: there Adam's first moves are ±lr with a random sign."""
    mu_r = ref["after"][f"mu/{name}"].reshape(-1)
    mu_g = got["after"][f"mu/{name}"].reshape(-1)
    gap = (mu_r - mu_g).abs()
    return (mu_r.abs() > gap) & (mu_g.abs() > gap)


def _gap(ref: dict, got: dict, pairs) -> float:
    d_ref, d_got, keep = [], [], []
    for key, name in pairs:
        keep.append(_keep(ref, got, name))
        d_ref.append((ref["after"][key] - ref["before"][key]).reshape(-1))
        d_got.append((got["after"][key] - got["before"][key]).reshape(-1))
    d_ref, d_got, keep = torch.cat(d_ref), torch.cat(d_got), torch.cat(keep)
    assert float(keep.float().mean()) >= 0.99, float(keep.float().mean())
    return float((d_got - d_ref)[keep].norm() / d_ref[keep].norm())


def adam_gap(ref: dict, got: dict) -> float:
    """||d_got - d_ref|| / ||d_ref|| of the optimizers' weight updates (d = after -
    before), leaving out the elements whose first moment on either side lies within the
    sides' difference of 0 (at most 1% of them)."""
    return _gap(ref, got, [(f"param/{k[3:]}", k[3:]) for k in ref["after"]
                           if k.startswith("mu/")])


def ema_gap(ref: dict, got: dict) -> float:
    """The same of the EMA weights' moves (``ema_unet``, masked by ``unet``'s moments)."""
    return _gap(ref, got, [(k, "unet." + k[len("param/ema_unet."):]) for k in ref["after"]
                           if k.startswith("param/ema_unet.")])


def buffer_gap(ref: dict, got: dict) -> float:
    """The largest element gap of the buffers (BatchNorm statistics, a codebook)."""
    return max(float((got["after"][k] - v).abs().max()) for k, v in ref["after"].items()
               if k.startswith("buffer/"))


# -- what the ranks run ------------------------------------------------------------------
def ddpm_from_state(flat, batch, draws):
    """One step of the tiny UNet DDPM from a flattened JAX state: with the port's
    generator draws, then with ``draws`` (JAX's, global)."""
    from lightning_generative_models_tpu_torch.models.diffusion.ddpm import DDPM
    from lightning_generative_models_tpu_torch.weights import load_flax_train_state

    out = []
    for d in (None, draws):
        model = DDPM(**DDPM_UNET, device="cpu")
        load_flax_train_state(model, flat)
        out.append(step_record("DDPM", DDPM_UNET, batch, model=model, draws=d))
    return out


def coupled_steps(cases):
    """One step of each (name, args, perturb) on its seeded batch, then samples drawn
    sharded over the data ranks (``sample_rows``): InfoGAN's code-transition grid of 2
    and of 4 rows (a rank's one row must not widen the grid's shared ends) and the
    DiT-MoE's DDIM-3 sample of 2 (its aux loss reduced in inference too)."""
    steps = [step_record(name, args, batch_for(args), perturb=perturb)
             for name, args, perturb in cases]
    mesh_lib.set_mesh(mesh_lib.create_mesh())
    info = build("InfoGAN", INFOGAN)
    samples = {f"InfoGAN/{n}": mesh_lib.sample_rows(
        lambda rows: info.sample(torch.Generator().manual_seed(2), rows), n) for n in (2, 4)}
    moe = build("DDPM", DIT_MOE, perturb=True)
    samples["DiT-MoE/2"] = mesh_lib.sample_rows(
        lambda rows: moe.sample(torch.Generator().manual_seed(2), rows), 2)
    mesh_lib.set_mesh(None)
    return {"steps": steps, "samples": samples}


def fsdp_step_and_save(batch, ckpt_dir):
    """One fsdp step of the tiny UNet DDPM (leaves of 1,024 elements and more sharded),
    its checkpoint, and the elements this rank holds after it: of the UNet's weights
    (against the whole count, and the count with every sharded leaf cut to 1/N), of the
    EMA weights and of Adam's first moments; and the count of sharded leaves."""
    from torch.nn.utils import parametrize

    mesh_lib.FSDP_MIN_SIZE = 1024
    model = build("DDPM", DDPM_UNET)
    n = dist.get_world_size()
    whole = [p.numel() for p in model.unet.parameters()]
    rec = {"whole": sum(whole), "expected_held": sum(
        p.numel() // n if mesh_lib.fsdp_dim(p, n) is not None else p.numel()
        for p in model.unet.parameters())}
    rec.update(step_record("DDPM", DDPM_UNET, batch, strategy="fsdp", model=model,
                           save_to=ckpt_dir))
    rec["held"] = sum(p.numel() for p in model.unet.parameters())
    rec["held_ema"] = sum(p.numel() for p in model.ema_unet.parameters())
    rec["held_moments"] = sum(s["exp_avg"].numel() for s in model.optimizer.state.values())
    rec["sharded"] = sum(parametrize.is_parametrized(m) for m in model.unet.modules())
    return rec


TP_VARIANTS = {"tp": DIT, "tp_sp": {**DIT, "seq_parallel": True}, "ep": DIT_MOE}


def flax_flat(module) -> dict:
    """{flax path: array} of a port module's weights (the inverse of ``weights.py``'s
    Dense transform; the DiT has no other)."""
    from lightning_generative_models_tpu_torch.weights import flax_paths

    return {path: (p.detach().numpy().T if tr == "dense" else p.detach().numpy()).copy()
            for path, (p, tr) in flax_paths(module).items()}


def tp_steps(names, tp_size, tree=None):
    """One ``tp`` step of each DiT variant in ``names`` (``TP_VARIANTS``), from the same
    perturbed weights; with ``tree`` (a flat flax tree of the "tp" variant's DiT), also the
    largest gap between it and a tensor-parallel model it was loaded into (whole for the
    load, inside ``gathered``)."""
    out = {name: step_record("DDPM", TP_VARIANTS[name], batch_for(TP_VARIANTS[name]),
                             strategy="tp", tp_size=tp_size, perturb=True)
           for name in names}
    if tree is not None:
        from lightning_generative_models_tpu_torch.weights import load_flax_params

        model = build("DDPM", TP_VARIANTS["tp"])
        mesh_lib.shard_model(model, "tp", mesh_lib.strategy_mesh("tp", tp_size))
        with mesh_lib.gathered(model):
            load_flax_params(model.unet, tree)
        with mesh_lib.gathered(model):
            got = flax_flat(model.unet)
        out["loaded_max_diff"] = max(float(np.abs(got[k] - v).max()) for k, v in tree.items())
        mesh_lib.set_mesh(None)
    return out


def pp_step_and_sample(batch, strategy="pp"):
    """One step of the pipeline DiT (``pp`` over the ranks; on one process the local
    schedule), the elements each stage holds on this rank (weights, then EMA weights),
    whether ``--unroll_steps`` under ``pp`` over every rank would capture the steps in a
    CUDA graph, then a guided DDIM-3 sample of 4 from the EMA weights (the samples equal
    on every stage rank)."""
    model = build("DDPM", DIT_PP, perturb=True)
    rec = step_record("DDPM", DIT_PP, batch, strategy=strategy, model=model)
    rec["held"] = [sum(p.numel() for p in stage.parameters())
                   for net in (model.unet, model.ema_unet) for stage in net.pipeline.stages]
    from lightning_generative_models_tpu_torch.train.trainer import unroll_in_graph

    rec["unroll_in_graph"] = unroll_in_graph("pp", mesh_lib.strategy_mesh("pp"))
    mesh_lib.set_mesh(mesh_lib.strategy_mesh(strategy))
    rec["samples"] = model.sample(torch.Generator().manual_seed(1), 4)
    return rec


def cli_train_and_generate(train_argv, generate_argv, experiments):
    """The train CLI, then the generate CLI, as ``torchrun`` would run them on a rank;
    returns generate's samples."""
    from pathlib import Path

    from lightning_generative_models_tpu_torch import generate
    from lightning_generative_models_tpu_torch.train import cli

    cli.EXPERIMENT_DIR = Path(experiments)
    cli.main(train_argv)
    return generate.main(generate_argv)
