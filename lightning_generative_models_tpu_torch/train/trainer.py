"""Trainer: the fit loop on one device.

Counterpart of ``lightning_generative_models_tpu/train/trainer.py`` with the fit
loop's semantics kept: max epochs / max steps, ``check_val_every_n_epoch``,
``log_every_n_steps`` and ``sample_every_n_steps`` (a cadence is crossed, not hit
exactly), gradient accumulation by concatenated micro-batches or by summed
micro-batch gradients (``auto`` picks as the JAX trainer does), the SIGTERM path that
saves first and skips validation, the epoch-boundary ``last`` save, ``best`` by the
model's monitored metric, ``resume`` and ``ckpt_path``, validation, the sample grid
(conditional models) the per-class grid from the EMA weights, the codebook table
(VQ models), and ``images_per_sec`` in the logged metrics.

Randomness: where the JAX trainer folds the step into its run key, each step here
draws from a generator seeded by (seed, stream, step), so a resumed run draws what
the uninterrupted run would have drawn. Not ported: meshes and the fsdp/tp/pp
strategies, unrolled steps, profiler windows, the test split and the generative
metrics (FID/KID/IS); see ROADMAP.md.
"""

from __future__ import annotations

import logging
import signal
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from lightning_generative_models_tpu_torch.data.pipeline import prefetch_to_device
from lightning_generative_models_tpu_torch.experiment.logger import ExperimentLogger
from lightning_generative_models_tpu_torch.models.base import GenerativeModel
from lightning_generative_models_tpu_torch.train.checkpoint import CheckpointManager
from lightning_generative_models_tpu_torch.utils.grid import make_grid
from lightning_generative_models_tpu_torch.utils.seed import seed_everything

logger = logging.getLogger(__name__)

STRATEGIES = ("data_parallel", "ddp", "auto")
NOT_PORTED_STRATEGIES = ("fsdp", "tp", "pp")

# Seed streams of the run's generators.
_TRAIN, _VAL, _SAMPLE, _GRIDS = 0, 1, 2, 3


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
    ):
        if strategy in NOT_PORTED_STRATEGIES:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported to the PyTorch package (it trains "
                "on one device); see ROADMAP.md, Queue 1 #11"
            )
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be data_parallel|ddp|auto, got {strategy!r}")
        self.model = model
        self.datamodule = datamodule
        self.experiment_dir = Path(experiment_dir)
        self.logger = exp_logger or ExperimentLogger(self.experiment_dir)
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
        self.model.init_params(torch.Generator().manual_seed(self.seed))
        start_epoch = 0
        self.global_step = 0
        if resume and self.ckpt.has_checkpoint("last"):
            self.global_step, start_epoch = self.ckpt.restore(self.model)
            logger.info("Resumed from step %d (epoch %d)", self.global_step, start_epoch)
        elif ckpt_path is not None:
            mgr = CheckpointManager(Path(ckpt_path).parent, monitor=self.model.monitor)
            self.global_step, start_epoch = mgr.restore(self.model, Path(ckpt_path).name)
        logger.info("%s parameters: %s", type(self.model).__name__, ", ".join(
            f"{name} {n:,}" for name, n in self.model.param_counts().items()))

        prev_handler = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, self._handle_sigterm)
        try:
            self._fit_loop(start_epoch)
        finally:
            signal.signal(signal.SIGTERM, prev_handler)
            # Interrupt or crash: save with the current epoch, so it is retried.
            if self._last_saved_step != self.global_step:
                self.ckpt.save_last(self.model, self.global_step, self.epoch)
        return self.model

    # -- internals -------------------------------------------------------------------
    def _generator(self, stream: int, index: int = 0) -> torch.Generator:
        seed = np.random.SeedSequence([self.seed, stream, index]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

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
        """Batches on the device: one per step, a list of k micro-batches per step in
        scan mode, or the k micro-batches merged into one in concat mode."""
        it = prefetch_to_device(self.datamodule.train_batches(epoch), self.device)
        k = self.accumulate_grad_batches
        if k <= 1:
            return it
        grouped = _group(it, k)
        if self.grad_accum_mode == "scan":
            return grouped
        return ({key: torch.cat([b[key] for b in group]) for key in group[0]}
                for group in grouped)

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
        images_per_step = self.datamodule.batch_size * self.accumulate_grad_batches

        def crossed(n: int, prev: int, cur: int) -> bool:
            return n > 0 and prev // n != cur // n

        for epoch in range(start_epoch, self._max_epochs()):
            self.epoch = epoch
            for batch in self._train_batches(epoch):
                t0 = time.perf_counter()
                metrics = self._train_step(batch)
                prev_step = self.global_step
                self.global_step += 1
                is_last = self.max_steps > 0 and self.global_step >= self.max_steps
                if crossed(self.log_every_n_steps, prev_step, self.global_step) \
                        or prev_step == 0 or is_last:
                    # Reading the metrics waits for the step: only on logging steps.
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    metrics["images_per_sec"] = images_per_step / max(dt, 1e-9)
                    metrics["epoch"] = epoch
                    self.logger.log_metrics(metrics, prev_step)
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

    def _validate(self) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        count = 0
        for batch in prefetch_to_device(self.datamodule.val_batches(), self.device):
            metrics = self.model.eval_step(batch, self._generator(_VAL, count))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            return {}
        means = {k: v / count for k, v in sums.items()}
        self.logger.log_metrics(means, self.global_step)
        self._log_samples()
        for name, images in self.model.validation_grids(self._generator(_GRIDS)).items():
            grid = make_grid(images.float().cpu().numpy(), nrow=8)
            self.logger.log_image(name, grid, self.global_step)
        self._log_tables()
        return means

    def _log_tables(self) -> None:
        """The codebook table of the VQ models, at every validation."""
        if not hasattr(self.model, "codebook_table"):
            return
        codebook = self.model.codebook_table()
        cols = [f"d{i}" for i in range(codebook.shape[1])]
        self.logger.log_table("codebook", cols, codebook.tolist(), self.global_step)

    def _log_samples(self) -> None:
        try:
            images = self.model.sample(self._generator(_SAMPLE), self.num_sample_images)
        except NotImplementedError:  # a model with no random generation (CycleGAN)
            return
        grid = make_grid(images.float().cpu().numpy())
        self.logger.log_image("random_generation", grid, self.global_step)


def _group(iterator: Iterator[Any], k: int) -> Iterator[List[Any]]:
    """Groups of k consecutive items; a short last group is dropped."""
    buf: List[Any] = []
    for item in iterator:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []
