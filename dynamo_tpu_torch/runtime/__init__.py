"""Distributed runtime of the torch port: control plane, component model,
streaming data plane, on the JAX package's wire (``dynamo_tpu/runtime``),
so torch and JAX processes serve in one fleet.
"""

from dynamo_tpu_torch.runtime.component import (
    Client, Component, Endpoint, Instance, Namespace,
)
from dynamo_tpu_torch.runtime.context import Context, StreamError
from dynamo_tpu_torch.runtime.control_plane import (
    ControlPlane,
    ControlPlaneServer,
    LocalControlPlane,
    NoRespondersError,
    RemoteControlPlane,
)
from dynamo_tpu_torch.runtime.runtime import DistributedRuntime

__all__ = [
    "ControlPlane",
    "LocalControlPlane",
    "RemoteControlPlane",
    "ControlPlaneServer",
    "NoRespondersError",
    "DistributedRuntime",
    "Namespace",
    "Component",
    "Endpoint",
    "Client",
    "Instance",
    "Context",
    "StreamError",
]
