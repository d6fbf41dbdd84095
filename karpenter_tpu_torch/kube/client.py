"""In-memory kube-apiserver equivalent.

The reference runs its controllers against a real apiserver booted by envtest
(reference pkg/test/environment.go:80-134) and, in production, against the
cluster's apiserver through controller-runtime's cached client. This module is
the rebuild's single stand-in for both: a typed, versioned object store with
apiserver semantics —

  - create/get/list/update/delete over the dataclasses in apis/objects.py
  - optimistic concurrency via resource_version (update with a stale version
    raises Conflict, like a 409)
  - finalizer-aware deletion: delete() on an object with finalizers sets
    deletion_timestamp and waits; the object disappears when the last
    finalizer is removed (exactly the lifecycle the termination controllers
    depend on, reference pkg/controllers/nodeclaim/termination/controller.go)
  - watch callbacks (ADDED/MODIFIED/DELETED) — the informer layer
    (state/informer.py) pumps these into the Cluster state cache the way
    controller-runtime watch streams do

Objects are deep-copied across the boundary in both directions, so controllers
never share mutable state through the store — the property that makes the
reference's "all durable state lives in the apiserver" design honest
(SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import copy
import threading
import time as _time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class KubeError(Exception):
    pass


class NotFound(KubeError):
    pass


class AlreadyExists(KubeError):
    pass


class Conflict(KubeError):
    """Stale resource_version on update (HTTP 409)."""


class Invalid(KubeError):
    """Rejected by an admission webhook (HTTP 422)."""


WatchHandler = Callable[[str, object], None]


def _key(obj) -> Tuple[str, str]:
    return (obj.metadata.namespace, obj.metadata.name)


class KubeClient:
    def __init__(self, clock=None):
        self._lock = threading.RLock()
        # kind (python type) -> {(namespace, name): obj}
        self._store: Dict[Type, Dict[Tuple[str, str], object]] = {}
        self._watchers: Dict[Type, List[WatchHandler]] = {}
        # kind -> admission validators called on create/update; a validator
        # returns a list of error strings (empty = admitted)
        self._admission: Dict[Type, List[Callable[[object], list]]] = {}
        self._rv = 0
        self._clock = clock

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else _time.time()

    # -- plumbing -------------------------------------------------------------

    def _coll(self, kind: Type) -> Dict[Tuple[str, str], object]:
        return self._store.setdefault(kind, {})

    def _emit(self, kind: Type, event: str, obj):
        for handler in self._watchers.get(kind, []):
            handler(event, copy.deepcopy(obj))

    def admit(self, kind: Type, validator: Callable[[object], list]) -> None:
        """Register an admission validator for a kind (the webhook seam)."""
        with self._lock:
            self._admission.setdefault(kind, []).append(validator)

    def _check_admission(self, obj) -> None:
        for validator in self._admission.get(type(obj), []):
            errors = validator(obj)
            if errors:
                raise Invalid(
                    f"{type(obj).__name__} {obj.metadata.name}: " + "; ".join(errors)
                )

    def watch(self, kind: Type, handler: WatchHandler, replay: bool = True):
        """Register a watch callback. With replay=True the handler immediately
        receives ADDED for every existing object (a LIST+WATCH)."""
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            if replay:
                # snapshot: the handler may create/delete objects of this kind
                for obj in list(self._coll(kind).values()):
                    handler(ADDED, copy.deepcopy(obj))

    # -- CRUD -----------------------------------------------------------------

    def create(self, obj):
        with self._lock:
            coll = self._coll(type(obj))
            k = _key(obj)
            if k in coll:
                raise AlreadyExists(f"{type(obj).__name__} {k} already exists")
            stored = copy.deepcopy(obj)
            # validators see the store's copy: a mutating validator can never
            # leak changes back into the caller's object
            self._check_admission(stored)
            self._rv += 1
            stored.metadata.resource_version = self._rv
            stored.metadata.generation = 1
            if stored.metadata.creation_timestamp is None:
                stored.metadata.creation_timestamp = self._now()
                obj.metadata.creation_timestamp = stored.metadata.creation_timestamp
            coll[k] = stored
            obj.metadata.resource_version = stored.metadata.resource_version
            obj.metadata.generation = stored.metadata.generation
            self._emit(type(obj), ADDED, stored)
            return copy.deepcopy(stored)

    def get(self, kind: Type, name: str, namespace: str = "default"):
        with self._lock:
            obj = self._coll(kind).get((namespace, name))
            if obj is None:
                raise NotFound(f"{kind.__name__} {namespace}/{name} not found")
            return copy.deepcopy(obj)

    def get_opt(self, kind: Type, name: str, namespace: str = "default"):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(
        self,
        kind: Type,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        predicate: Optional[Callable[[object], bool]] = None,
    ) -> List[object]:
        with self._lock:
            out = []
            for (ns, _), obj in self._coll(kind).items():
                if namespace is not None and ns != namespace:
                    continue
                if label_selector is not None and any(
                    obj.metadata.labels.get(k) != v for k, v in label_selector.items()
                ):
                    continue
                if predicate is not None and not predicate(obj):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def update(self, obj, check_version: bool = True):
        """Full-object update. Removing the last finalizer from a deleting
        object finalizes the delete."""
        with self._lock:
            coll = self._coll(type(obj))
            k = _key(obj)
            stored = coll.get(k)
            if stored is None:
                raise NotFound(f"{type(obj).__name__} {k} not found")
            if check_version and obj.metadata.resource_version != stored.metadata.resource_version:
                raise Conflict(
                    f"{type(obj).__name__} {k}: version {obj.metadata.resource_version} "
                    f"!= {stored.metadata.resource_version}"
                )
            new = copy.deepcopy(obj)
            self._check_admission(new)
            # deletion_timestamp is apiserver-owned: preserve the stored value
            new.metadata.deletion_timestamp = stored.metadata.deletion_timestamp
            self._rv += 1
            new.metadata.resource_version = self._rv
            new.metadata.generation = stored.metadata.generation + 1
            if new.metadata.deletion_timestamp is not None and not new.metadata.finalizers:
                del coll[k]
                self._emit(type(obj), DELETED, new)
            else:
                coll[k] = new
                self._emit(type(obj), MODIFIED, new)
            obj.metadata.resource_version = new.metadata.resource_version
            obj.metadata.generation = new.metadata.generation
            return copy.deepcopy(new)

    def patch(self, obj, mutate: Callable[[object], None]):
        """Read-modify-write against the stored copy (a merge patch: immune to
        the caller holding a stale version)."""
        with self._lock:
            stored = self.get(type(obj), obj.metadata.name, obj.metadata.namespace)
            mutate(stored)
            return self.update(stored)

    def delete(self, obj_or_kind, name: str = None, namespace: str = "default"):
        """With finalizers present: mark deletion_timestamp (MODIFIED event).
        Without: remove immediately (DELETED event). Idempotent-ish: NotFound
        raises, matching client-go."""
        with self._lock:
            if name is None:
                kind, name, namespace = (
                    type(obj_or_kind),
                    obj_or_kind.metadata.name,
                    obj_or_kind.metadata.namespace,
                )
            else:
                kind = obj_or_kind
            coll = self._coll(kind)
            k = (namespace, name)
            stored = coll.get(k)
            if stored is None:
                raise NotFound(f"{kind.__name__} {k} not found")
            if stored.metadata.finalizers:
                if stored.metadata.deletion_timestamp is None:
                    stored.metadata.deletion_timestamp = self._now()
                    self._rv += 1
                    stored.metadata.resource_version = self._rv
                    self._emit(kind, MODIFIED, stored)
            else:
                del coll[k]
                # a delete is a write: the DELETED event carries a fresh
                # resource_version, as the apiserver's etcd revision would
                self._rv += 1
                stored.metadata.resource_version = self._rv
                self._emit(kind, DELETED, stored)

    def delete_opt(self, obj_or_kind, name: str = None, namespace: str = "default"):
        try:
            self.delete(obj_or_kind, name, namespace)
        except NotFound:
            pass

    # -- conveniences used by controllers ------------------------------------

    def kinds(self) -> Iterable[Type]:
        with self._lock:
            return list(self._store)

    def __len__(self):
        with self._lock:
            return sum(len(c) for c in self._store.values())
