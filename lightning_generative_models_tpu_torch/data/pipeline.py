"""Device feeding: batches copied to the card ahead of use.

Counterpart of ``lightning_generative_models_tpu/data/pipeline.py``. A background
thread takes each host batch (uint8 numpy), pins it and copies it to the device with
``non_blocking=True`` on a side stream, ``size`` batches ahead of the training loop.
Each batch carries an event recorded after its copies; before handing the batch out,
the consumer's stream waits for that event and the tensors are marked as used on it
(``record_stream``), so the copy is ordered before every use and the memory is not
reused while the consumer's kernels still read it. On the CPU the batches are only
converted to tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _to_tensor(value: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(value))


def prefetch_to_device(
    iterator: Iterator[Dict[str, np.ndarray]],
    device: str | torch.device,
    size: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``iterator`` as tensors on ``device``, copied ``size``
    batches ahead on a side stream (see the module doc)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: _to_tensor(v).to(device) for k, v in batch.items()}
        return

    stream = torch.cuda.Stream(device)
    ready: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            with torch.cuda.stream(stream):
                for batch in iterator:
                    out = {k: _to_tensor(v).pin_memory().to(device, non_blocking=True)
                           for k, v in batch.items()}
                    copied = torch.cuda.Event()
                    copied.record(stream)
                    if not put((out, copied)):
                        return
            put(_DONE)
        except BaseException as exc:  # handed to the consumer, which re-raises it
            put(_Failure(exc))

    thread = threading.Thread(target=worker, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = ready.get()
            if item is _DONE:
                return
            if isinstance(item, _Failure):
                raise item.exc
            out, copied = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(copied)
            for tensor in out.values():
                tensor.record_stream(consumer)
            yield out
    finally:
        stop.set()
        thread.join(timeout=10.0)
