"""Experiment logging: metrics.jsonl and sample PNGs, mirrored to W&B when asked.

Counterpart of ``lightning_generative_models_tpu/experiment/logger.py``: the same
``metrics.jsonl`` records (``step``, ``time`` since the logger started, then the
metrics), ``samples/<name>_<step>.png`` grids and ``<name>_<step>.json`` tables. The JAX package writes PNGs through
PIL and falls back to ``.npy`` without it; ``_write_png`` here writes the PNG with the
standard library alone, so the file is a PNG everywhere.
"""

from __future__ import annotations

import json
import logging
import struct
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


class ExperimentLogger:
    def __init__(
        self,
        experiment_dir: str | Path,
        project: str = "lightning-generative-models-tpu",
        name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = False,
        resume: bool = False,
        run_id: Optional[str] = None,
    ):
        self.experiment_dir = Path(experiment_dir)
        self.experiment_dir.mkdir(parents=True, exist_ok=True)
        self.samples_dir = self.experiment_dir / "samples"
        self.samples_dir.mkdir(exist_ok=True)
        self._metrics_file = open(self.experiment_dir / "metrics.jsonl", "a")
        self._t0 = time.time()

        self._wandb = None
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415 - optional

                self._wandb = wandb.init(
                    project=project, name=name, dir=str(self.experiment_dir),
                    config=config, resume="must" if resume else None,
                    id=run_id if resume else None,
                )
            except Exception as e:  # wandb missing or no network
                logger.warning("wandb unavailable (%s); logging locally only", e)

        if config is not None:
            with open(self.experiment_dir / "config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            record[k] = v if isinstance(v, str) else float(v)
        self._metrics_file.write(json.dumps(record) + "\n")
        self._metrics_file.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"}, step=step)

    def log_image(self, name: str, image: np.ndarray, step: int) -> None:
        """Save a uint8 HWC image grid as ``samples/<name>_<step>.png``."""
        _write_png(self.samples_dir / f"{name}_{step:08d}.png", image)
        if self._wandb is not None:
            import wandb  # noqa: PLC0415

            self._wandb.log({name: wandb.Image(np.asarray(image))}, step=step)

    def log_table(self, name: str, columns: list, rows: list, step: int) -> None:
        """Save a table as ``<name>_<step>.json`` ({"columns", "rows"}), as the JAX
        logger does (the codebook table of the VQ models)."""
        path = self.experiment_dir / f"{name}_{step:08d}.json"
        with open(path, "w") as f:
            json.dump({"columns": columns, "rows": rows}, f, default=str)
        if self._wandb is not None:
            import wandb  # noqa: PLC0415

            self._wandb.log({name: wandb.Table(columns=columns, data=rows)}, step=step)

    def finish(self) -> None:
        self._metrics_file.close()
        if self._wandb is not None:
            self._wandb.finish()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path: Path, image: np.ndarray) -> None:
    """Write a uint8 [H, W], [H, W, 1] or [H, W, 3] image as an 8-bit PNG."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[-1] != 3):
        raise ValueError(
            f"_write_png takes uint8 [H, W] or [H, W, 3], got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    color_type = 0 if image.ndim == 2 else 2  # greyscale or RGB
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = b"".join(b"\x00" + row.tobytes() for row in rows)  # filter 0 on every row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw)))
        f.write(_chunk(b"IEND", b""))
