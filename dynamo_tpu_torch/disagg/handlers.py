"""The worker's ``generate`` handler, the port's copy of
``dynamo_tpu/disagg/handlers.py``'s ``DecodeWorkerHandler`` in the
aggregated role: one engine prefills and decodes every request it is
routed.

The JAX handler can also send long prompts to a prefill fleet, pull the KV
of a migrated or onboarded prompt from a peer, and resolve multimodal
references through an encoder. The port has none of these yet:

- a request carrying a ``restore`` (migration) or ``onboard`` plan is
  served by recomputing its prompt locally, which is the JAX handler's own
  outcome when no peer can be pulled from ("recomputed"); KV pulls wait
  for ROADMAP A8;
- a request the engine cannot serve (multimodal input:
  ``engine.refusal``) is rejected as an invalid request, a terminal error
  the frontend answers with a 400 instead of migrating it to a worker that
  would refuse it again; so is a guided constraint that no token sequence
  over the vocabulary can satisfy.
"""

from __future__ import annotations

import logging

from dynamo_tpu_torch.engine.engine import refusal
from dynamo_tpu_torch.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import InvalidRequestError

logger = logging.getLogger("dynamo_torch.disagg")


class DecodeWorkerHandler:
    """Serves the aggregated component's ``generate`` endpoint."""

    def __init__(self, engine):
        self.engine = engine

    async def generate(self, request: dict, ctx):
        req = PreprocessedRequest.from_wire(request)
        why = refusal(req)
        if why is not None:
            raise InvalidRequestError(
                f"the torch worker cannot serve this request yet: it "
                f"needs {why}")
        if req.restore is not None or req.onboard is not None:
            logger.info("%s plan: no KV pull in the torch worker (ROADMAP "
                        "A8); recomputing %d prompt tokens",
                        "migration" if req.restore is not None
                        else "onboard", len(req.token_ids))
        async for out in self.engine.generate(req, ctx):
            yield out.to_wire()
