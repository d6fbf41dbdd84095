from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode

__all__ = ["Cluster", "StateNode"]
