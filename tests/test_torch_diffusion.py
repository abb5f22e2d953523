"""The port's diffusion schedules and the DiT/UNet option checks against the JAX
package's; the samplers of each variant are in ``test_torch_diffusion_<variant>.py``,
their cases in ``torch_diffusion_cases.py``."""

from torch_diffusion_cases import (  # noqa: F401
    test_ddpm_rejects_unported_and_dit_only_options,
    test_schedule_buffers_equal_jax,
)
