"""Network frontend for the serving layer: evolution over the wire.

The in-process :class:`~deap_tpu_torch.serve.service.EvolutionService`
multiplexes tenants that live in the same interpreter; this package is the
edge in front of it — a stdlib HTTP frontend, a binary JSON+tensor wire format, and a thin remote
client mirroring the in-process ``Session`` API:

* :mod:`~deap_tpu_torch.serve.net.protocol` — the frame codec (one JSON header +
  contiguous raw little-endian tensor payloads; bit-exact round trips for
  every genome/fitness dtype, byte-identical to the JAX package's) and
  the HTTP error mapping;
* :mod:`~deap_tpu_torch.serve.net.server` — :class:`NetServer`: session
  create/ask/tell/step/evaluate/close over HTTP, a streaming
  ``/v1/metrics`` endpoint, and the ``/v1/admin`` drain/restore/rebucket
  surface that cross-instance failover rides on;
* :mod:`~deap_tpu_torch.serve.net.client` — :class:`RemoteService` /
  :class:`RemoteSession`: the future-based ask/tell/step/evaluate API of
  the in-process session, backed by a pipelined HTTP worker; trajectories
  are **bitwise identical** to serving the same session in-process
  (held by ``tests/test_torch_serve_net.py``).

Kept out of ``deap_tpu_torch.serve``'s import path on purpose: importing the
service layer must not cost an HTTP stack, so ``from deap_tpu_torch.serve.net
import NetServer, RemoteService`` is the entry point.
"""

from .protocol import (encode_frame, decode_frame,  # noqa: F401
                       decode_frame_with_trace, remote_exception,
                       status_of, CONTENT_TYPE, MAGIC)
from .server import NetServer  # noqa: F401
from .client import RemoteService, RemoteSession  # noqa: F401

__all__ = [
    "NetServer", "RemoteService", "RemoteSession",
    "encode_frame", "decode_frame", "decode_frame_with_trace",
    "remote_exception", "status_of", "CONTENT_TYPE", "MAGIC",
]
