"""Serving: the route scorer (``LMServer``) behind the paper's batch policy.

The orchestration around it (scheduler, replica groups, cache, capacity,
tracing) is ROADMAP.md queue 1, item 8."""
from repro_torch.serve.engine import (Completion, LMServer,  # noqa: F401
                                      PreparedBatch, Request,
                                      form_batch_groups)
