"""Provisioning trigger controller + singleton loop.

Equivalent of reference pkg/controllers/provisioning/controller.go: a watch on
Pods fires the batcher whenever a provisionable pod appears; the singleton
loop waits out the batch window and runs one Provisioner.reconcile
(singleton.go:81, provisioner.go:106-137). Where the port differs: a pass
that raises a device fault sets the trigger again (``provision``).
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.objects import Pod
from karpenter_tpu_torch.kube.client import DELETED, KubeClient
from karpenter_tpu_torch.provisioning.batcher import Batcher
from karpenter_tpu_torch.provisioning.provisioner import Provisioner
from karpenter_tpu_torch.solver.supervisor import device_fault
from karpenter_tpu_torch.utils import pod as podutil


def watch_pods(kube: KubeClient, batcher: Batcher) -> None:
    """Register the pod-watch trigger (provisioning/controller.go:58-67)."""

    def on_pod(event: str, pod: Pod):
        if event == DELETED:
            return
        if podutil.is_provisionable(pod):
            batcher.trigger()

    kube.watch(Pod, on_pod, replay=True)


class ProvisioningLoop:
    """The singleton reconciler: wait for a batch, then run one pass."""

    def __init__(self, provisioner: Provisioner, batcher: Batcher):
        self.provisioner = provisioner
        self.batcher = batcher

    def run_once(self):
        """Returns the ProvisioningPass, or None when no batch formed."""
        if not self.batcher.wait():
            return None
        return provision(self.provisioner, self.batcher)


def provision(provisioner: Provisioner, batcher: Batcher):
    """One Provisioner.reconcile. A device fault (the port's kernels or the
    CUDA runtime, which the supervisor raises instead of failing over) sets
    the trigger again before it propagates, so the pods of the failed pass
    get another one."""
    try:
        return provisioner.reconcile()
    except Exception as exc:
        if device_fault(exc):
            batcher.trigger()
        raise
