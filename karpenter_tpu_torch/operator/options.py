"""Operator configuration.

Port of the JAX package's ``operator/options.py`` (reference
pkg/operator/options/options.go:47-150): a flat Options struct populated
flags-first with environment-variable fallback, carried to every decision
point (the reference threads it through context; we pass the object
explicitly).

Where the port differs: ``solver_backend`` is ``"torch"`` (the default: the
hand-written kernels on ``solver_device``) or ``"oracle"``, and any other
value raises; ``solver_device`` (env ``SOLVER_DEVICE``) is ``"cuda"`` unless
the caller asks for ``"cpu"``. The bucket prewarm (``prewarm_max_pods``,
``prewarm_screen_candidates``, solver/warmup.py) means what it means in the
JAX package, on the solver's device. The JAX package's fields that nothing reads (the apiserver client's QPS and
burst, leader election, the memory limit fraction) are left out.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional


SOLVER_BACKENDS = ("torch", "oracle")


def _env_name(flag: str) -> str:
    return flag.upper().replace("-", "_")


@dataclass
class Options:
    # service ports (options.go:49-55); Operator.start() serves /metrics on
    # metrics_port and /healthz on health_probe_port
    metrics_port: int = 8000
    health_probe_port: int = 8081
    # batching window (options.go:95-96)
    batch_max_duration_s: float = 10.0
    batch_idle_duration_s: float = 1.0
    # profiling (operator.go:164-180); a torch.profiler trace of the host
    # and the card here
    enable_profiling: bool = False
    # admission webhooks, default-disabled like the reference (options.go:84)
    disable_webhook: bool = True
    # feature gates (options.go:97,123-137)
    feature_gates: Dict[str, bool] = field(default_factory=lambda: {"Drift": True})
    log_level: str = "info"
    # solver backend for the scheduling cores: "torch" or "oracle"
    solver_backend: str = "torch"
    # the torch backend's device: "cuda" (the kernels), or "cpu" (their
    # plain PyTorch versions) when the caller asks for it
    solver_device: str = "cuda"
    # build and load the kernels at startup, then warm the solver's
    # buckets, on a thread of its own that holds /readyz at 503 until it
    # ends (torch backend on CUDA only; solver/warmup.py)
    prewarm_solver: bool = True
    # largest pod batch to warm solver buckets for (0 = only the small
    # standard buckets); solver/warmup.py walks the bucket ladder up to it
    prewarm_max_pods: int = 0
    # candidate-subset counts to warm the consolidation screen for
    # (solver/warmup.py prewarm_screen); 0 disables
    prewarm_screen_candidates: int = 0

    def __post_init__(self):
        if self.solver_backend not in SOLVER_BACKENDS:
            raise ValueError(
                f"solver_backend {self.solver_backend!r} is not one of {', '.join(SOLVER_BACKENDS)}"
            )

    def drift_enabled(self) -> bool:
        return self.feature_gates.get("Drift", True)

    @classmethod
    def parse(cls, argv: Optional[List[str]] = None,
              env: Optional[Dict[str, str]] = None) -> "Options":
        """Flags win over env vars over defaults (options.go:82-121).
        argv=None reads sys.argv[1:], the standard argparse contract."""
        import sys

        if argv is None:
            argv = sys.argv[1:]
        env = dict(os.environ if env is None else env)
        defaults = cls()
        parser = argparse.ArgumentParser(prog="karpenter-tpu", add_help=False)
        for f in fields(cls):
            if f.name == "feature_gates":
                continue
            flag = "--" + f.name.replace("_", "-")
            env_val = env.get(_env_name(f.name))
            default = getattr(defaults, f.name)
            if env_val is not None:
                if f.type == "bool" or isinstance(default, bool):
                    default = env_val.lower() in ("1", "true", "yes")
                elif isinstance(default, int):
                    default = int(env_val)
                elif isinstance(default, float):
                    default = float(env_val)
                else:
                    default = env_val
            if isinstance(default, bool):
                # BooleanOptionalAction: bare '--enable-profiling' works like a
                # conventional CLI boolean and '--no-enable-profiling' negates
                # (ADVICE r1: type=lambda made the bare flag an argparse error)
                parser.add_argument(flag, dest=f.name, default=default,
                                    action=argparse.BooleanOptionalAction)
            else:
                parser.add_argument(flag, dest=f.name, default=default,
                                    type=type(default))
        parser.add_argument("--feature-gates", dest="feature_gates",
                            default=env.get("FEATURE_GATES", ""))
        ns = parser.parse_args(argv)
        opts = cls(**{f.name: getattr(ns, f.name) for f in fields(cls)
                      if f.name != "feature_gates"})
        gates = dict(defaults.feature_gates)
        raw = ns.feature_gates
        if raw:
            for pair in raw.split(","):
                name, _, value = pair.partition("=")
                gates[name.strip()] = value.strip().lower() in ("1", "true", "yes")
        opts.feature_gates = gates
        return opts
