from karpenter_tpu_torch.cloudprovider.types import (  # noqa: F401
    CloudProvider,
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
    order_by_price,
)
