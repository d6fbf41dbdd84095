"""The system's operational entry points over the port, each the
counterpart of the JAX system's tool of the same name under ``tools/``:
``load_harness`` (the open-loop serve driver), ``chaos_sweep`` (the fault
matrix and its isolation, restart, device-loss and soak rows), and the
``explain``, ``trace_report`` and ``flight_report`` renderers of the port's
dumps. Each runs as ``python -m karpenter_tpu_torch.tools.<name>`` and
solves on the card unless given ``--device cpu``."""
