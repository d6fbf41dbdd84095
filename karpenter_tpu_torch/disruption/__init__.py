"""The disruption controllers (the JAX package's ``disruption/``).

- ``controller``: ``Controller.reconcile()``, one action per pass over the
  methods in priority order, with the two-phase validation TTL;
- ``methods``: ``Expiration``, ``Drift`` and ``Emptiness``;
- ``consolidation``: ``EmptyNodeConsolidation``, ``MultiNodeConsolidation``
  and ``SingleNodeConsolidation``, screened through ``batch``;
- ``batch``: ``UnionScorer`` over the ``runs_screen`` kernel,
  ``build_scorer`` and the per-pass ``ScreenSession``;
- ``screen_delta``: the residual screen's planning;
- ``orchestration``: the command ``Queue`` with its rollback;
- ``helpers``: candidates, budgets, ``simulate_scheduling`` and the price
  filters;
- ``types`` and ``pdblimits``: candidates, commands and the PDB gate.
"""

from karpenter_tpu_torch.disruption.types import (  # noqa: E402
    DECISION_DELETE,
    DECISION_NONE,
    DECISION_REPLACE,
    Candidate,
    Command,
)

__all__ = ["Candidate", "Command", "DECISION_DELETE", "DECISION_NONE", "DECISION_REPLACE"]
