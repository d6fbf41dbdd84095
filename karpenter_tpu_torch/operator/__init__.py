from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options

__all__ = ["Operator", "Options"]
