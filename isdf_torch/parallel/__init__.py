"""Scenario-parallel batch engine (counterpart of ``isdf_tpu/parallel``)."""

from isdf_torch.parallel.batch import (  # noqa: F401
    ScenarioBatch, batched_cost_and_grad, batched_solve,
    batched_solve_audited, batched_solve_chunked, make_random_batch,
)
