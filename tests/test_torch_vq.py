"""The port's VQ codebook search against the JAX package's interpret-mode Pallas kernel and
XLA path (cases in ``torch_vq_cases.py``)."""

from torch_vq_cases import (  # noqa: F401
    quantizer_inputs,
    test_nearest_codes_casts_to_f32_and_refuses_bad_shapes,
    test_nearest_codes_first_index_on_duplicated_codebook,
    test_nearest_codes_plain_matches_pallas_and_xla,
)
