"""Admission webhooks.

Equivalent of reference pkg/webhooks/webhooks.go:57-150: validation admission
for the framework's own API types, default-disabled the same way
(--disable-webhook, operator/options/options.go:84). Where the reference runs
a knative webhook server in front of the apiserver, this framework registers
validators directly on the in-memory kube store's admission seam
(KubeClient.admit) — same contract, no TLS plumbing.

The reference's second webhook — CRD conversion between v1alpha5 and v1beta1
(webhooks.go:57-99) — is deliberately not built: this framework has exactly
one API version, so there is nothing to convert to or from. If a second API
version is ever introduced, add a conversion hook on the same admission seam
(a `kube.convert(FromType, ToType, fn)` registration) rather than a
standalone server.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.validation import validate_nodeclaim, validate_nodepool
from karpenter_tpu_torch.kube.client import KubeClient


def register_webhooks(kube: KubeClient) -> None:
    kube.admit(NodePool, validate_nodepool)
    kube.admit(NodeClaim, validate_nodeclaim)
