"""Trainer: the fit loop, on one device or over torch.distributed ranks.

Counterpart of ``lightning_generative_models_tpu/train/trainer.py`` with the fit
loop's semantics kept: max epochs / max steps, ``check_val_every_n_epoch``,
``log_every_n_steps`` and ``sample_every_n_steps`` (a cadence is crossed, not hit
exactly), gradient accumulation by concatenated micro-batches or by summed
micro-batch gradients (``auto`` picks as the JAX trainer does), the SIGTERM path that
saves first and skips validation, the epoch-boundary ``last`` save, ``best`` by the
model's monitored metric, ``resume`` and ``ckpt_path``, validation, the sample grid
(conditional models) the per-class grid from the EMA weights, the latent table (VAE)
and the codebook table (VQ models), and ``images_per_sec`` in the logged metrics.
Validation and the test split (``test``, keys prefixed ``test_``) share ``_eval_over``:
the mean eval metrics and, for a model with ``calculate_metrics``, the FID/KID/IS it
names (``metrics``), real batches against fakes sampled per batch and quantised to
uint8 by truncation, as the reference quantises them.

``unroll_steps`` k > 1 runs k optimisation steps a dispatch on k stacked batches, with
the JAX trainer's semantics: ``global_step`` advances by k, ``images_per_sec`` counts k
batches, every cadence (logging, the sample grid, ``max_steps``) is crossed, the logged
metrics are the last step's, and scan grad-accum is refused. On the CPU a dispatch runs
its k steps in a loop; on CUDA it is one CUDA graph of the k steps (``train/graphs.py``),
and a step that cannot be captured raises (there is no eager fallback).
``profile_steps`` (start, stop) opens one ``torch.profiler`` window a run (CPU and CUDA
activities) from the first dispatch at or past ``start`` to the first past ``stop``, and
writes its chrome trace under ``experiment_dir/profile/``. ``debug_nans`` raises
``FloatingPointError`` where the JAX trainer under ``jax_debug_nans`` raises: on a NaN in
what a computation of the run returns (each dispatch's metrics and the model's state
after it, read after a CUDA graph's replay and never inside the capture; each evaluation
batch's metrics; each sample grid; FID/KID/IS's fakes and InceptionV3 outputs; the
latent table), naming the phase and the step; off, it reads nothing back. At fit start the trainer logs
the parameter counts, the parameter table and the per-layer tables of the model's
``summary_spec`` (``utils/summary.py``); a summary that fails warns and training goes on.

Randomness: where the JAX trainer folds the step into its run key, each step here
draws from a generator seeded by (seed, stream, step), so a resumed run draws what
the uninterrupted run would have drawn, and an unrolled dispatch what its k single steps
would have drawn; each evaluation batch's fakes come from their own generator.

Strategies (JAX ``trainer.py``; ``parallel/mesh.py``): ``data_parallel``/``ddp``/``auto``
average the gradients over the data ranks, ``fsdp`` also shards the large weights, the
EMA weights and Adam's moments over them (ZeRO-3), ``tp`` is Megatron tensor parallelism
of a DiT over a (data, model) mesh (``tp_size`` ranks on ``model``, 0: all), ``pp`` the
GPipe pipeline of a DiT over a (data, stage) mesh (``pp_size``, 0: all;
``pipeline_stages == pp_size``), with the JAX trainer's checks and texts. Every rank reads the identical seeded global batch and keeps
its data rank's rows; a step draws the global batch's draws and keeps its rows
(``global_draws``), so a step on N ranks is one device's on the global batch. The
logged metrics and the evaluation means are means over the data ranks; the sample grid
and FID's fakes are sampled sharded over them and gathered. Rank 0 writes the logs,
images and checkpoints (whole tensors: a sharded run resumes on one device and the
reverse). ``unroll_steps`` on the card captures the steps' NCCL collectives in the CUDA
graph; under ``pp`` over more than one stage rank, whose stages send and receive, it runs
the k steps as an eager loop, decided by strategy before the run and logged
(``unroll_in_graph``).
"""

from __future__ import annotations

import logging
import signal
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from lightning_generative_models_tpu_torch.data.pipeline import prefetch_to_device
from lightning_generative_models_tpu_torch.experiment.logger import ExperimentLogger
from lightning_generative_models_tpu_torch.metrics import inception
from lightning_generative_models_tpu_torch.metrics.generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    over_data_ranks,
    to_uint8,
)
from lightning_generative_models_tpu_torch.models.base import GenerativeModel
from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.train.graphs import StepGraphs
from lightning_generative_models_tpu_torch.utils import summary
from lightning_generative_models_tpu_torch.utils.grid import make_grid
from lightning_generative_models_tpu_torch.utils.seed import seed_everything

logger = logging.getLogger(__name__)

STRATEGIES = ("data_parallel", "ddp", "auto", "fsdp", "tp", "pp")

# Seed streams of the run's generators.
_TRAIN, _VAL, _SAMPLE, _GRIDS, _FAKES = 0, 1, 2, 3, 4


def unroll_in_graph(strategy: str, mesh: mesh_lib.Mesh) -> bool:
    """Whether ``--unroll_steps`` runs its k steps on the card as one CUDA graph, decided
    by strategy before the run: every strategy's collectives are NCCL all-reduces,
    all-gathers and reduce-scatters, which a graph captures, except ``pp`` over more than
    one stage rank, whose stages send and receive activations; there the k steps are an
    eager loop."""
    return not (strategy == "pp" and mesh.size(mesh_lib.STAGE_AXIS) > 1)


class Trainer:
    def __init__(
        self,
        model: Any,
        datamodule: Any,
        experiment_dir: str | Path,
        exp_logger: Optional[ExperimentLogger] = None,
        max_epochs: int = -1,
        max_steps: int = -1,
        check_val_every_n_epoch: int = 5,
        accumulate_grad_batches: int = 1,
        log_every_n_steps: int = 50,
        sample_every_n_steps: int = 1000,
        num_sample_images: int = 64,
        seed: int = 10,
        grad_accum_mode: str = "auto",
        strategy: str = "data_parallel",
        unroll_steps: int = 1,
        profile_steps: Optional[Tuple[int, int]] = None,
        debug_nans: bool = False,
        tp_size: int = 0,
        pp_size: int = 0,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(
                "strategy must be data_parallel|ddp|auto|fsdp|tp|pp, "
                f"got {strategy!r}"
            )
        self.model = model
        self.datamodule = datamodule
        self.experiment_dir = Path(experiment_dir)
        self.strategy = strategy
        self.mesh = mesh_lib.strategy_mesh(strategy, tp_size, pp_size)
        if strategy == "tp":
            mesh_lib.validate_tp(model, self.mesh)
        elif strategy == "pp":
            mesh_lib.validate_pp(model, self.mesh)
        elif getattr(getattr(model, "unet", None), "seq_parallel", False):
            logger.warning(
                "model config sets seq_parallel=true but strategy=%r — "
                "sequence parallelism only takes effect under --strategy tp",
                strategy,
            )
        self.main = mesh_lib.is_main_process()
        if self.main:
            self.logger = exp_logger or ExperimentLogger(self.experiment_dir)
        else:  # rank 0 writes
            self.logger = _NullLogger()
        self.device = model.device
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.accumulate_grad_batches = accumulate_grad_batches
        self.log_every_n_steps = log_every_n_steps
        self.sample_every_n_steps = sample_every_n_steps
        self.num_sample_images = num_sample_images
        self.seed = seed
        if accumulate_grad_batches > 1 and not getattr(model, "supports_grad_accum", True):
            logger.warning(
                "%s uses manual multi-optimizer updates; accumulate_grad_batches "
                "is ignored.", type(model).__name__,
            )
            self.accumulate_grad_batches = 1
        self.grad_accum_mode = self._resolve_accum_mode(grad_accum_mode)
        self.unroll_steps = max(int(unroll_steps), 1)
        if self.grad_accum_mode == "scan" and self.unroll_steps > 1:
            raise ValueError("unroll_steps>1 is incompatible with scan grad-accum")
        self._graphs: Optional[StepGraphs] = None
        if self.unroll_steps > 1 and self.device.type == "cuda":
            if unroll_in_graph(strategy, self.mesh):
                self._graphs = StepGraphs(model, self.unroll_steps, model.train_step,
                                          self.device)
            else:
                logger.info("unroll_steps %d under pp over %d stage ranks: an eager loop "
                            "of %d steps a dispatch (no CUDA graph holds the stages' "
                            "send/recv)", self.unroll_steps,
                            self.mesh.size(mesh_lib.STAGE_AXIS), self.unroll_steps)
        self.profile_steps = profile_steps
        self.debug_nans = debug_nans
        self._profiler: Optional[torch.profiler.profile] = None
        self._profiled = False
        self.ckpt = CheckpointManager(self.experiment_dir / "checkpoints",
                                      monitor=model.monitor)
        self.global_step = 0
        self.epoch = 0
        self._last_saved_step: Optional[int] = None
        self._should_stop = False
        self._interrupted = False

    # -- public ------------------------------------------------------------------
    def fit(self, ckpt_path: Optional[str] = None, resume: bool = False) -> Any:
        seed_everything(self.seed)
        mesh_lib.set_mesh(None)  # whole weights until shard_model
        self.model.init_params(torch.Generator().manual_seed(self.seed))
        start_epoch = 0
        self.global_step = 0
        if resume and self.ckpt.has_checkpoint("last"):
            self.global_step, start_epoch = self.ckpt.restore(self.model)
            logger.info("Resumed from step %d (epoch %d)", self.global_step, start_epoch)
        elif ckpt_path is not None:
            mgr = CheckpointManager(Path(ckpt_path).parent, monitor=self.model.monitor)
            self.global_step, start_epoch = mgr.restore(self.model, Path(ckpt_path).name)
        self._log_model_summary()
        mesh_lib.shard_model(self.model, self.strategy, self.mesh)

        prev_handler = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, self._handle_sigterm)
        try:
            self._fit_loop(start_epoch)
        finally:
            self._stop_profile()
            signal.signal(signal.SIGTERM, prev_handler)
            # Interrupt or crash: save with the current epoch, so it is retried.
            if self._last_saved_step != self.global_step:
                self.ckpt.save_last(self.model, self.global_step, self.epoch)
        return self.model

    # -- internals -------------------------------------------------------------------
    def _seed(self, stream: int, index: int = 0) -> int:
        return int(np.random.SeedSequence([self.seed, stream, index]).generate_state(1)[0])

    def _rows(self, batch: Any) -> int:
        """This rank's rows of a batch (a stacked one's second axis)."""
        first = next(iter((batch[0] if isinstance(batch, list) else batch).values()))
        return first.shape[1] if self.unroll_steps > 1 else first.shape[0]

    def _generator(self, stream: int, index: int = 0) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self._seed(stream, index))

    def _log_model_summary(self) -> None:
        """Per-module parameter counts, then the parameter table and the per-layer tables
        of the model's ``summary_spec`` (JAX ``trainer.py:_log_model_summary``), when INFO
        is logged (the tables run the model once); a table that fails is a warning, never
        a stop."""
        if not logger.isEnabledFor(logging.INFO):
            return
        logger.info("%s parameters: %s", type(self.model).__name__, ", ".join(
            f"{name} {n:,}" for name, n in self.model.param_counts().items()))
        try:
            logger.info("parameter table:\n%s", summary.param_table(self.model))
            spec = getattr(self.model, "summary_spec", lambda: {})()
            for name, (module, args, kwargs) in spec.items():
                logger.info("%s summary:\n%s", name, summary.module_table(
                    module, args, compute_flops=self.device.type == "cpu", **kwargs))
        except Exception as e:  # summaries must never stop training
            logger.warning("model summary failed: %s", e)

    def _check_nans(self, phase: str, *trees) -> None:
        """``debug_nans``: ``FloatingPointError`` when a floating tensor or array among
        ``trees``' leaves holds a NaN (one host read); nothing when the flag is off."""
        if not self.debug_nans:
            return
        found, flags = False, {}
        for leaf in pytree.tree_leaves(trees):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                flags.setdefault(leaf.device, []).append(torch.isnan(leaf).any())
            elif isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
                found = found or bool(np.isnan(leaf).any())
        if found or any(bool(torch.stack(f).any()) for f in flags.values()):
            raise FloatingPointError(f"--debug_nans: NaN in the {phase} at step "
                                     f"{self.global_step}")

    def _resolve_accum_mode(self, mode: str) -> str:
        if mode not in ("auto", "concat", "scan"):
            raise ValueError(f"grad_accum_mode must be auto|concat|scan, got {mode}")
        if self.accumulate_grad_batches <= 1:
            return "concat"
        has_grad_step = type(self.model).grad_step is not GenerativeModel.grad_step
        if mode == "scan":
            if not has_grad_step:
                raise ValueError(
                    f"{type(self.model).__name__} does not implement grad_step; "
                    "scan grad-accum requires the grad_step/apply_grad_step protocol "
                    "(use concat)."
                )
            return "scan"
        if mode == "auto" and has_grad_step:
            # Summed micro-batch gradients only when the merged batch's images alone
            # reach 256 MB; otherwise one step on the merged batch is the same math.
            merged_bytes = (self.accumulate_grad_batches * self.datamodule.batch_size
                            * int(np.prod(self.model.image_shape())) * 4)
            if merged_bytes >= 256 * 1024**2:
                return "scan"
        return "concat"

    def _handle_sigterm(self, signum, frame):  # pragma: no cover - signal path
        logger.warning("SIGTERM received; will checkpoint and stop.")
        self._should_stop = True
        self._interrupted = True

    def _max_epochs(self) -> int:
        if self.max_epochs and self.max_epochs > 0:
            return self.max_epochs
        if self.max_steps and self.max_steps > 0:
            steps = self.datamodule.steps_per_epoch("train")
            eff = max(steps // self.accumulate_grad_batches, 1)
            return int(np.ceil(self.max_steps / eff))
        logger.warning("Neither max_epochs nor max_steps set: training runs for 1000 "
                       "epochs or until SIGTERM.")
        return 1000

    def _train_batches(self, epoch: int) -> Iterator[Any]:
        """Batches on the device, this rank's rows of each: one per step, a list of k
        micro-batches per step in scan mode, or the k micro-batches merged into one (on the
        host, before the rows are cut) in concat mode."""
        host = self.datamodule.train_batches(epoch)
        k = self.accumulate_grad_batches
        if k > 1 and self.grad_accum_mode != "scan":
            host = ({key: np.concatenate([b[key] for b in group]) for key in group[0]}
                    for group in _group(host, k))
        it = prefetch_to_device(map(mesh_lib.local_rows, host), self.device)
        if k > 1 and self.grad_accum_mode == "scan":
            return _group(it, k)
        if self.unroll_steps > 1:
            # [k, B, ...] stacks of k steps' batches (JAX ``_stack_batches``).
            return ({key: torch.stack([b[key] for b in group]) for key in group[0]}
                    for group in _group(it, self.unroll_steps))
        return it

    def _dispatch(self, batch: Any) -> Dict[str, torch.Tensor]:
        """One dispatch: a step, or ``unroll_steps`` steps on a stacked batch (a CUDA
        graph on the card, a loop on the CPU); the last step's metrics."""
        with mesh_lib.global_draws(self._rows(batch)):
            if self.unroll_steps <= 1:
                return self._train_step(batch)
            seeds = [self._seed(_TRAIN, self.global_step + i)
                     for i in range(self.unroll_steps)]
            if self._graphs is not None:
                return self._graphs(batch, seeds)
            metrics = None
            for i, seed in enumerate(seeds):
                generator = torch.Generator(device=self.device).manual_seed(seed)
                metrics = self.model.train_step({key: v[i] for key, v in batch.items()},
                                                generator)
            return metrics

    def _start_profile(self) -> None:
        if self.profile_steps and self._profiler is None and not self._profiled \
                and self.global_step >= self.profile_steps[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()

    def _stop_profile(self) -> None:
        """Close the window and write its trace (one a run)."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = self.experiment_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        start, stop = self.profile_steps
        self._profiler.export_chrome_trace(str(out / f"trace_steps_{start}_{stop}.json"))
        self._profiler, self._profiled = None, True

    def _train_step(self, batch: Any) -> Dict[str, torch.Tensor]:
        generator = self._generator(_TRAIN, self.global_step)
        if not isinstance(batch, list):
            return self.model.train_step(batch, generator)
        # Fixed-memory accumulation: the mean of the micro-batches' gradients and
        # metrics, then one optimizer step.
        k = len(batch)
        grads, metrics = self.model.grad_step(batch[0], generator)
        for micro in batch[1:]:
            g, m = self.model.grad_step(micro, generator)
            torch._foreach_add_(grads, g)
            metrics = {key: metrics[key] + m[key] for key in metrics}
        torch._foreach_div_(grads, float(k))
        return self.model.apply_grad_step(grads, {key: v / k for key, v in metrics.items()})

    def _fit_loop(self, start_epoch: int) -> None:
        self.epoch = start_epoch - 1
        # A dispatch takes unroll_steps batches of accumulate_grad_batches micro-batches.
        images_per_step = (self.datamodule.batch_size * self.accumulate_grad_batches
                           * self.unroll_steps)

        def crossed(n: int, prev: int, cur: int) -> bool:
            return n > 0 and prev // n != cur // n

        for epoch in range(start_epoch, self._max_epochs()):
            self.epoch = epoch
            for batch in self._train_batches(epoch):
                self._start_profile()
                t0 = time.perf_counter()
                metrics = self._dispatch(batch)
                prev_step = self.global_step
                self.global_step += self.unroll_steps
                self._check_nans("train step", metrics, self.model.state_dict())
                is_last = self.max_steps > 0 and self.global_step >= self.max_steps
                if crossed(self.log_every_n_steps, prev_step, self.global_step) \
                        or prev_step == 0 or is_last:
                    # Reading the metrics waits for the step: only on logging steps.
                    metrics = {k: float(mesh_lib.data_mean(torch.as_tensor(v)))
                               for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    metrics["images_per_sec"] = images_per_step / max(dt, 1e-9)
                    metrics["epoch"] = epoch
                    self.logger.log_metrics(metrics, prev_step)
                if self._profiler is not None and self.global_step > self.profile_steps[1]:
                    self._stop_profile()
                if crossed(self.sample_every_n_steps, prev_step, self.global_step):
                    self._log_samples()
                if is_last:
                    self._should_stop = True
                if self._should_stop:
                    break
            if self._should_stop:
                break
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = self._validate()
                self.ckpt.maybe_save_best(self.model, self.global_step, epoch, val_metrics)
                # Resume starts at the next epoch.
                self.ckpt.save_last(self.model, self.global_step, epoch + 1)
                self._last_saved_step = self.global_step

        if self._interrupted:
            # Preemption: save first, skip validation and sampling.
            self.ckpt.save_last(self.model, self.global_step, self.epoch)
            self._last_saved_step = self.global_step
            return
        val_metrics = self._validate()
        # A --max_steps run usually stops mid-epoch: it still gets a 'best'.
        self.ckpt.maybe_save_best(self.model, self.global_step, self.epoch, val_metrics)
        if not self._should_stop:
            self.ckpt.save_last(self.model, self.global_step, self.epoch + 1)
            self._last_saved_step = self.global_step

    def test(self, which: str = "last") -> Dict[str, float]:
        """Evaluate the held-out test split with checkpoint ``which`` ("last" or
        "best"; freshly initialised weights, with a warning, when there is none), as
        validation evaluates; the keys are prefixed ``test_`` and logged."""
        seed_everything(self.seed)
        mesh_lib.set_mesh(None)
        self.model.init_params(torch.Generator().manual_seed(self.seed))
        if self.ckpt.has_checkpoint(which):
            self.global_step, _ = self.ckpt.restore(self.model, which)
        else:
            logger.warning("No '%s' checkpoint under %s; testing freshly initialized "
                           "weights.", which, self.ckpt.directory)
        mesh_lib.shard_model(self.model, self.strategy, self.mesh)
        means = self._eval_over(self.datamodule.test_batches(), "test")
        renamed = {(k.replace("val_", "test_", 1) if k.startswith("val_") else f"test_{k}"): v
                   for k, v in means.items()}
        if renamed:
            self.logger.log_metrics(renamed, self.global_step)
        return renamed

    def _eval_over(self, batches: Iterator[Any], split: str = "validation"
                   ) -> Dict[str, float]:
        """Mean per-batch eval metrics, and the generative metrics the model asks for,
        over a batch iterator (validation and the test split)."""
        sums: Dict[str, float] = {}
        count = 0
        gen_metrics = self._generative_metrics()
        for batch in prefetch_to_device(map(mesh_lib.local_rows, batches), self.device):
            with mesh_lib.global_draws(next(iter(batch.values())).shape[0]):
                metrics = self.model.eval_step(batch, self._generator(_VAL, count))
                self._check_nans(f"{split} batch {count}", metrics)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                if gen_metrics:
                    # A generator per batch: fakes drawn from one generator state would
                    # repeat one batch, and FID's covariance would be over its copies.
                    self._update_generative_metrics(
                        batch, self._generator(_FAKES, count), gen_metrics)
            count += 1
        if count == 0:
            return {}
        # The means over the data ranks: the global batches' means.
        means = dict(zip(sums, (mesh_lib.data_mean(torch.tensor(list(sums.values()),
                                                                dtype=torch.float64,
                                                                device=self.device))
                                / count).tolist()))
        if gen_metrics:
            means.update(self._compute_generative_metrics(gen_metrics))
        return means

    def _generative_metrics(self) -> Dict[str, Any]:
        if not getattr(self.model, "calculate_metrics", False):
            return {}
        if not hasattr(self, "_gen_metric_objs"):
            wanted = getattr(self.model, "metrics", None) or []
            extractor = over_data_ranks(inception.InceptionFeatureExtractor(
                device=self.device), self.device)
            if self.debug_nans:
                extractor = self._checked(extractor, "InceptionV3 features")
            objs: Dict[str, Any] = {}
            if "fid" in wanted:
                objs["fid"] = FrechetInceptionDistance(extractor)
            if "kid" in wanted:
                objs["kid"] = KernelInceptionDistance(extractor, subset_size=100)
            if "is" in wanted:
                objs["is"] = InceptionScore(extractor)
            self._gen_metric_objs = objs
        return self._gen_metric_objs

    def _update_generative_metrics(self, batch: Dict, generator: torch.Generator,
                                   objs: Dict[str, Any]) -> None:
        real_u8 = batch["image"]
        fakes = self.model.sample(generator, real_u8.shape[0])
        self._check_nans("generative metrics' fakes", fakes)
        fake_u8 = to_uint8(fakes)
        for name in ("fid", "kid"):
            if name in objs:
                objs[name].update(real_u8, real=True)
                objs[name].update(fake_u8, real=False)
        if "is" in objs:
            objs["is"].update(fake_u8)

    @staticmethod
    def _compute_generative_metrics(objs: Dict[str, Any]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if "fid" in objs:
            out["fid_score"] = objs["fid"].compute()
        if "kid" in objs:
            out["mean_kid_score"], out["std_kid_score"] = objs["kid"].compute()
        if "is" in objs:
            out["mean_inception_score"], out["std_inception_score"] = objs["is"].compute()
        for metric in objs.values():
            metric.reset()
        return out

    def _validate(self) -> Dict[str, float]:
        means = self._eval_over(self.datamodule.val_batches())
        if not means:
            return {}
        self.logger.log_metrics(means, self.global_step)
        self._log_samples()
        for name, images in self.model.validation_grids(self._generator(_GRIDS)).items():
            self._check_nans(f"{name} grid", images)
            grid = make_grid(images.float().cpu().numpy(), nrow=8)
            self.logger.log_image(name, grid, self.global_step)
        self._log_tables()
        return means

    def _log_tables(self) -> None:
        """At every validation: the latent means of the first validation batch's 256
        first images with their labels (a VAE), the codebook (a VQ model)."""
        if hasattr(self.model, "encode_for_logging"):
            batch = next(iter(self.datamodule.val_batches()))
            latents = self.model.encode_for_logging(batch)
            self._check_nans("latent table", latents)
            cols = [f"z{i}" for i in range(latents.shape[1])] + ["label"]
            rows = [list(map(float, z)) + [int(label)]
                    for z, label in zip(latents[:256], np.asarray(batch["label"])[:256])]
            self.logger.log_table("latent_space", cols, rows, self.global_step)
        if hasattr(self.model, "codebook_table"):
            codebook = self.model.codebook_table()
            cols = [f"d{i}" for i in range(codebook.shape[1])]
            self.logger.log_table("codebook", cols, codebook.tolist(), self.global_step)

    def _log_samples(self) -> None:
        try:
            images = mesh_lib.sample_rows(
                lambda n: self.model.sample(self._generator(_SAMPLE), n),
                self.num_sample_images)
        except NotImplementedError:  # a model with no random generation (CycleGAN)
            return
        self._check_nans("sample grid", images)
        grid = make_grid(images.float().cpu().numpy())
        self.logger.log_image("random_generation", grid, self.global_step)


    def _checked(self, fn, phase: str):
        """``fn`` with its outputs checked by ``_check_nans``."""
        def checked(*args):
            out = fn(*args)
            self._check_nans(phase, out)
            return out
        return checked


class _NullLogger:
    """The logger of a rank other than 0: writes nothing."""

    def log_metrics(self, *args, **kwargs) -> None:
        pass

    log_image = log_table = finish = log_metrics


def _group(iterator: Iterator[Any], k: int) -> Iterator[List[Any]]:
    """Groups of k consecutive items; a short last group is dropped."""
    buf: List[Any] = []
    for item in iterator:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []
