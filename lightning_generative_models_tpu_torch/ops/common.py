"""Device resolution shared by the package's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for "cuda" or "cpu". Raises on "cuda" when no GPU is present:
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def launch_counters() -> dict:
    """{name: wrapper} of every CUDA kernel wrapper that counts its launches in its
    ``launches`` attribute (kernels #1-#7)."""
    from lightning_generative_models_tpu_torch.ops import attention, linear_attention, preprocess, vq

    return {
        "linear_attention": linear_attention.linear_attention,
        "linear_attention_bwd": linear_attention.linear_attention_bwd,
        "fused_attention_qkv": attention.fused_attention_qkv,
        "fused_attention_qkv_bwd": attention.fused_attention_qkv_bwd,
        "flash_attention": attention.flash_attention,
        "flash_attention_bwd": attention.flash_attention_bwd_cuda,
        "nearest_codes": vq.nearest_codes,
        "fused_normalize_flip": preprocess.fused_normalize_flip,
    }


def launch_counts() -> dict:
    """{name: launches so far} of ``launch_counters``."""
    return {name: fn.launches for name, fn in launch_counters().items()}
