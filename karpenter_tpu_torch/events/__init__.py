from karpenter_tpu_torch.events.recorder import Event, Recorder, object_event  # noqa: F401
