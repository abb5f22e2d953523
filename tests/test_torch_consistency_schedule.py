"""The port's consistency curriculum and index logits, and its conditional eval step,
against the JAX package's (cases in ``torch_consistency_cases.py``)."""

from torch_consistency_cases import (  # noqa: F401
    models,
    test_conditional_eval_step_doubles_the_labels,
    test_curriculum_and_index_logits_match_jax_at_every_stage,
)
