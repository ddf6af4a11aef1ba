"""Locality labels, the port's copy of the part of
``dynamo_tpu/router/topology.py`` a decode worker needs to prefer a near
prefill instance when a queue claim times out.

Workers publish where they sit (host / slice / pod, from
``DYN_TOPO_HOST`` / ``DYN_TOPO_SLICE`` / ``DYN_TOPO_POD``) under ``"topo"``
in their ``Instance.metadata``. A (source, destination) pair folds into a
link class, nearest first: the same host, the same slice, the same pod, or
none of these (or unknown).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional

#: link classes, nearest first
LINK_CLASSES = ("host", "slice", "pod", "none")

#: metadata key carrying labels inside Instance.metadata
TOPO_METADATA_KEY = "topo"


@dataclass(frozen=True)
class TopologyLabels:
    """Where a worker sits. Any field may be None (unpublished)."""

    host: Optional[str] = None
    slice_id: Optional[str] = None
    pod: Optional[str] = None

    def __bool__(self) -> bool:
        return any((self.host, self.slice_id, self.pod))

    def to_metadata(self) -> dict:
        return {k: v for k, v in (("host", self.host),
                                  ("slice", self.slice_id),
                                  ("pod", self.pod)) if v}

    @staticmethod
    def from_metadata(meta: Optional[dict]) -> "TopologyLabels":
        """Labels from an Instance.metadata dict (missing or foreign →
        empty)."""
        t = (meta or {}).get(TOPO_METADATA_KEY)
        if not isinstance(t, dict):
            return TopologyLabels()
        return TopologyLabels(host=t.get("host") or None,
                              slice_id=t.get("slice") or None,
                              pod=t.get("pod") or None)

    @staticmethod
    def from_env(env=None) -> "TopologyLabels":
        """DYN_TOPO_HOST / DYN_TOPO_SLICE / DYN_TOPO_POD; empty when none
        is set. Slice or pod without a host name takes the hostname."""
        env = os.environ if env is None else env
        host = env.get("DYN_TOPO_HOST") or None
        sl = env.get("DYN_TOPO_SLICE") or None
        pod = env.get("DYN_TOPO_POD") or None
        if not (host or sl or pod):
            return TopologyLabels()
        return TopologyLabels(host=host or socket.gethostname(),
                              slice_id=sl, pod=pod)


def link_class(a: TopologyLabels, b: TopologyLabels) -> str:
    """Fold two label sets into a link class; unknown locality on either
    side is ``none``."""
    if not a or not b:
        return "none"
    if a.host and a.host == b.host:
        return "host"
    if a.slice_id and a.slice_id == b.slice_id:
        return "slice"
    if a.pod and a.pod == b.pod:
        return "pod"
    return "none"
