"""Observability hooks of the ported layers: solve-cycle tracing (trace.py),
the fleet SLO engine (slo.py) and the flight recorder (flight.py)."""

from karpenter_tpu_torch.obs import flight, slo, trace  # noqa: F401
