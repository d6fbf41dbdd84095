from karpenter_tpu_torch.kube.client import (  # noqa: F401
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExists,
    Conflict,
    KubeClient,
    NotFound,
)
