"""Shared HTTP plumbing of the fleet's two DTF1 frontends.

:class:`~deap_tpu_torch.serve.net.server.NetServer`'s handler and the
fleet router's speak the same keep-alive HTTP/1.1 dialect — explicit Content-Length framing,
byte-counted request/response metrics, typed JSON error envelopes, and
the drain-unread-body rule that keeps an error reply from poisoning the
next request on the connection; this module is the single copy both
inherit.

Subclasses implement :meth:`_route` (the verb dispatch) and
:meth:`_handler_metrics` (which :class:`~deap_tpu_torch.serve.metrics.
ServeMetrics` instance the byte counters land on), and may override
``log_prefix`` / :meth:`_log_conf` for their request-log identity.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

from ...observability.sinks import emit_text
from . import protocol

__all__ = ["FleetHTTPServer", "FrameHTTPHandler"]


class FleetHTTPServer(ThreadingHTTPServer):
    """Both frontends' HTTP server class.  The stdlib default listen
    backlog (5) drops connections with ECONNRESET the moment a fleet
    loadgen points a few dozen clients at one frontend; the backlog must
    cover at least the largest client pool a bench drives."""

    daemon_threads = True
    request_queue_size = 128


class FrameHTTPHandler(BaseHTTPRequestHandler):
    """Keep-alive DTF1/JSON request handler base (see module docstring).

    The stdlib handler instantiates per connection and calls one
    ``do_<VERB>`` per request; all three verbs funnel into the
    subclass's ``_route(method)``."""

    protocol_version = "HTTP/1.1"
    #: bound by the owning server to its context object (NetServer /
    #: RouterServer) via a closure subclass
    server_ctx = None
    #: request-log tag (``[serve.net]`` / ``[router]``)
    log_prefix = "serve"

    # -- identity hooks ------------------------------------------------------

    def _handler_metrics(self):
        """The ServeMetrics the byte/request counters land on (``None``
        before the server context is bound — counting is skipped)."""
        raise NotImplementedError

    def _log_conf(self) -> Tuple[bool, Sequence]:
        """(verbose, sinks) for the request log."""
        return False, ()

    def log_message(self, fmt, *args):  # stdlib default prints to stderr
        verbose, sinks = self._log_conf()
        if verbose:
            emit_text(f"[{self.log_prefix}] {self.address_string()} "
                      f"{fmt % args}", sinks)

    # -- request body --------------------------------------------------------

    def _read_raw_body(self) -> bytes:
        """Read the request body (Content-Length framing), count it, and
        mark it consumed for :meth:`_drain_body`."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        data = self.rfile.read(length) if length else b""
        self._body_consumed = True
        metrics = self._handler_metrics()
        if metrics is not None:
            metrics.inc("net_bytes_in", len(data))
        return data

    def _drain_body(self) -> None:
        """Consume an unread request body before replying on an error
        path — leftover body bytes would be parsed as the NEXT request
        line on this keep-alive connection, poisoning every subsequent
        exchange."""
        if getattr(self, "_body_consumed", False):
            return
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length:
            self.rfile.read(length)
        self._body_consumed = True

    # -- responses -----------------------------------------------------------

    def _send(self, payload: bytes, status: int = 200,
              content_type: str = protocol.CONTENT_TYPE) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)
        metrics = self._handler_metrics()
        if metrics is not None:
            metrics.inc("net_bytes_out", len(payload))

    def _send_json(self, obj, status: int = 200) -> None:
        self._send(json.dumps(obj).encode("utf-8"), status=status,
                   content_type="application/json")

    def _send_error_envelope(self, exc: BaseException,
                             location: Optional[str] = None) -> None:
        """The shared error tail: drain any unread body, then reply with
        the typed JSON envelope at the exception's mapped HTTP status
        (optionally carrying a failover redirect ``location``)."""
        self._drain_body()
        self._send(protocol.error_payload(exc, location=location),
                   status=protocol.status_of(exc),
                   content_type="application/json")

    # -- verbs ---------------------------------------------------------------

    def _route(self, method: str) -> None:
        raise NotImplementedError

    def do_GET(self):  # noqa: N802 (stdlib API)
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")

    def do_DELETE(self):  # noqa: N802
        self._route("DELETE")
