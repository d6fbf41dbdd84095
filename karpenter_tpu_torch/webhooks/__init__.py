from karpenter_tpu_torch.webhooks.webhooks import register_webhooks

__all__ = ["register_webhooks"]
