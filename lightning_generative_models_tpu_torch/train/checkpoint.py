"""Checkpointing: atomic save/restore of the model's state, 'last' and 'best'.

Counterpart of ``lightning_generative_models_tpu/train/checkpoint.py`` with the same
directory layout (``<dir>/last``, ``<dir>/best``) and the same per-checkpoint
``checkpoint_meta_{last,best}.json`` (step, epoch, monitor, best value), without
orbax: a checkpoint is ``torch.save`` of the model's ``state_dict()`` (weights, EMA
weights, optimizer state, step) written to a temporary file and moved into place
with ``os.replace``, so an interrupted save never leaves half a checkpoint. Restore
reads it back with ``torch.load(..., weights_only=True)``. The JAX package's
migration of pre-round-2 orbax layouts has nothing to migrate here.

Over torch.distributed ranks every rank saves together: the model's state is made
whole on every rank (``parallel/mesh.py:gathered``: tensor-parallel and ``fsdp`` shards
and their moments all-gathered, pipeline stages broadcast from their ranks), rank 0
writes it in the format above, and the others wait at a barrier. A restore reads the whole state on
every rank before the trainer lays it out, so a sharded run's checkpoint resumes on one
device, and a single device's under any strategy, as JAX's layout-independent restore.
"""

from __future__ import annotations

import json
import logging
import math
import os
from pathlib import Path
from typing import Any, Tuple

import torch

from lightning_generative_models_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)


class CheckpointManager:
    def __init__(self, directory: str | Path, monitor: str = "val_loss"):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.best_value = math.inf
        meta = self._read_meta("best") or self._read_meta("last")
        if meta:
            value = meta.get("best_value")  # null: no best yet
            self.best_value = math.inf if value is None else float(value)

    def _meta_path(self, which: str) -> Path:
        return self.directory / f"checkpoint_meta_{which}.json"

    def _read_meta(self, which: str) -> dict | None:
        path = self._meta_path(which)
        if not path.exists():
            return None
        with open(path) as f:
            return json.load(f)

    def _write_meta(self, which: str, step: int, epoch: int) -> None:
        meta = {
            "step": int(step),
            "epoch": int(epoch),
            "monitor": self.monitor,
            "best_value": float(self.best_value) if math.isfinite(self.best_value) else None,
        }
        tmp = self._meta_path(which).with_suffix(".json.tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self._meta_path(which))

    def _save(self, which: str, model: Any, step: int, epoch: int) -> None:
        path = self.directory / which
        tmp = path.with_name(f"{which}.tmp")
        with mesh_lib.gathered(model):
            if mesh_lib.is_main_process():
                torch.save(model.state_dict(), tmp)
                os.replace(tmp, path)
                self._write_meta(which, step, epoch)
        mesh_lib.barrier()

    def save_last(self, model: Any, step: int, epoch: int) -> None:
        self._save("last", model, step, epoch)

    def maybe_save_best(self, model: Any, step: int, epoch: int, metrics: dict) -> bool:
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        if value < self.best_value:
            self.best_value = value
            self._save("best", model, step, epoch)
            logger.info("New best %s=%.6f at step %d", self.monitor, value, step)
            return True
        return False

    def restore(self, model: Any, which: str = "last") -> Tuple[int, int]:
        """Load checkpoint ``which`` into ``model`` in place; returns (step, epoch)."""
        path = self.directory / which
        if not path.exists():
            raise FileNotFoundError(f"No checkpoint at {path}")
        # On the CPU first: the optimizer moves its moments to the parameters' device
        # and keeps Adam's step counts on the host, as a fresh optimizer does.
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        meta = self._read_meta(which) or {}
        return meta.get("step", 0), meta.get("epoch", 0)

    def has_checkpoint(self, which: str = "last") -> bool:
        return (self.directory / which).exists()
