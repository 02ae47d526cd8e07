""":class:`NetServer` — the HTTP frontend of one
:class:`~deap_tpu_torch.serve.service.EvolutionService` instance.

Pure stdlib (``http.server.ThreadingHTTPServer``): one handler thread per
connection blocks on the service's futures — socket waits and Condition
waits only, never ``time.sleep``.  Handler threads never touch the
device: decoded genomes stay host tensors until the service's dispatch
worker places them, and results come back as CPU tensors.  Toolboxes cannot travel over a wire, so the
server owns a **toolbox registry**: clients name a registered toolbox at
session create, and the name is remembered per session so a drain
snapshot can be restored on any instance holding the same registry.

Surface (all frames — see :mod:`~deap_tpu_torch.serve.net.protocol` — unless
noted)::

    GET    /v1/healthz                      liveness + drain state (JSON)
    GET    /v1/toolboxes                    registry names (JSON)
    POST   /v1/sessions                     create (key/genome/weights/...)
    GET    /v1/sessions/{name}              current population + phase
    DELETE /v1/sessions/{name}              close
    POST   /v1/sessions/{name}/step         {"n": k} -> k per-gen results
    POST   /v1/sessions/{name}/ask          -> offspring genome rows
    POST   /v1/sessions/{name}/tell         {"values": tensor}
    POST   /v1/sessions/{name}/evaluate     {"genome": tensor} -> values
    GET    /v1/metrics                      one MetricRecord (JSON); add
                                            ?stream=1&max=K&timeout=S for
                                            chunked ND-JSON tailing
    GET    /v1/profile                      per-program measured profiles
                                            (JSON): build time + min-of-k
                                            execute walls
    POST   /v1/admin/drain                  failover step 1: quiesce +
                                            snapshot every live session
    POST   /v1/admin/restore                failover step 2: adopt a
                                            drained snapshot
    POST   /v1/admin/rebucket               adaptive bucket-grid refit
    POST   /v1/admin/redirect               failover step 3: record where
                                            drained sessions now live (a
                                            typed redirect for stale
                                            clients; {"session": name}
                                            scopes it to one session)

Cross-instance failover is drain → ship the frame → restore: the snapshot
carries each session's toolbox *name*, bucket rows and raw PRNG key, so
the restoring instance continues every trajectory **bitwise** when its
policy/registry match.  The frames are the JAX package's byte for byte,
and keys travel as raw ``uint32`` words (2 for threefry, 4 for rbg), so a
JAX ``RemoteService`` drives this server and a JAX instance's drained
sessions restore here (``tests/test_torch_serve_net.py``).

Not ported yet (queue 1 item 11b (ii) of ROADMAP.md): the autoscaler's
live migration (``/v1/admin/migrate``), the cross-instance cache fabric
(``/v1/admin/cache/export|import``) and the fault-injecting wire.  The
fleet router (:mod:`deap_tpu_torch.serve.router`) fronts this server
and sets its redirects.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional, Sequence
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
import torch

from ... import sanitize
from ...base import Population, Fitness
from ...observability import fleettrace
from ...observability.sinks import emit_text
from ..dispatcher import ServiceDraining, SessionUnknown
from ..metrics import prometheus_text
from . import protocol
from .httpcommon import FleetHTTPServer, FrameHTTPHandler

__all__ = ["NetServer"]


class NetServer:
    """Serve an :class:`~deap_tpu_torch.serve.service.EvolutionService` over
    HTTP (see module docstring).

    Parameters
    ----------
    service:
        The (already constructed) in-process service instance.
    toolboxes:
        Name → toolbox registry clients may open sessions against.
    host / port:
        Bind address; ``port=0`` picks a free port (read it back from
        :attr:`address` / :attr:`url`).
    result_timeout:
        Server-side cap on waiting for one request's device futures.
    sinks / verbose:
        Request-log routing (library output goes through the
        observability sink layer, never bare prints).
    """

    #: lock-guarded shared state: the
    #: session→toolbox name map is written by concurrent HTTP handler
    #: threads (create/close/restore), and the failover redirect targets
    #: by the admin endpoint — writes only under ``self._lock``
    _GUARDED_BY = {"_lock": ("_session_toolbox", "_redirect",
                             "_session_redirects")}

    def __init__(self, service, toolboxes: Dict[str, Any], *,
                 host: str = "127.0.0.1", port: int = 0,
                 result_timeout: float = 600.0, sinks: Sequence = (),
                 compress_min_bytes: int = 4096, verbose: bool = False,
                 ssl_context=None):
        self.service = service
        self.toolboxes = dict(toolboxes)
        self.result_timeout = float(result_timeout)
        self.sinks = list(sinks)
        #: raw tensor-payload size below which a response is never
        #: compressed even for a zlib-advertising peer (deflating a tiny
        #: ask result costs more CPU than the bytes it saves)
        self.compress_min_bytes = int(compress_min_bytes)
        self.verbose = bool(verbose)
        self._session_toolbox: Dict[str, str] = {}
        #: where this instance's sessions went after a drain (set by
        #: POST /v1/admin/redirect, typically by the fleet router once
        #: restore succeeded elsewhere): attached to ServiceDraining /
        #: SessionUnknown error envelopes so direct clients follow the
        #: failover transparently
        self._redirect: Optional[str] = None
        #: per-session redirects (one session moved; its neighbors keep
        #: serving here, so the instance-wide target must stay unset)
        self._session_redirects: Dict[str, str] = {}
        self._lock = sanitize.lock()
        net = self

        class Handler(_Handler):
            server_ctx = net

        self._httpd = FleetHTTPServer((host, port), Handler)
        #: TLS termination: an ``ssl.SSLContext`` wraps the listening
        #: socket (every accepted connection handshakes before HTTP) and
        #: flips :attr:`url` to https, the scheme peers must speak
        self._ssl_context = ssl_context
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "NetServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="deap-tpu-serve-http", daemon=True)
            self._thread.start()
            if self.verbose:
                emit_text(f"[serve.net] listening on {self.url}", self.sinks)
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "NetServer":
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def address(self) -> tuple:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        scheme = "https" if self._ssl_context is not None else "http"
        return f"{scheme}://{host}:{port}"

    # -- session helpers -----------------------------------------------------

    def _session(self, name: str):
        s = self.service.sessions().get(name)
        if s is None:
            raise SessionUnknown(f"no live session named {name!r}")
        return s

    def _result(self, future):
        return future.result(timeout=self.result_timeout)

    # -- route bodies (called from the handler; return encodable objects) ----

    def h_healthz(self) -> dict:
        return {"status": "draining" if self.service.draining else "ok",
                "sessions": len(self.service.sessions()),
                "draining": bool(self.service.draining)}

    def h_create(self, body: dict) -> dict:
        tb_name = body["toolbox"]
        toolbox = self.toolboxes.get(tb_name)
        if toolbox is None:
            raise SessionUnknown(f"no registered toolbox named {tb_name!r}")
        genome = _as_host(body["genome"])
        n = _rows_of(genome)
        weights = tuple(float(w) for w in body["weights"])
        if body.get("values") is not None:
            fitness = Fitness(
                values=torch.as_tensor(np.asarray(body["values"],
                                                  np.float32)),
                valid=torch.as_tensor(np.asarray(body["valid"], bool)),
                weights=weights)
        else:
            fitness = Fitness.empty(n, weights, device="cpu")
        pop = Population(genome=genome, fitness=fitness)
        session = self.service.open_session(
            np.asarray(body["key"]), pop, toolbox,
            cxpb=float(body.get("cxpb", 0.5)),
            mutpb=float(body.get("mutpb", 0.2)),
            name=body.get("name"),
            evaluate_initial=bool(body.get("evaluate_initial", True)),
            priority=int(body.get("priority", 1)),
            timeout=self.result_timeout)
        with self._lock:
            self._session_toolbox[session.name] = tb_name
            # a re-created name supersedes any redirect leftover: the
            # session lives HERE now, a stale redirect would bounce it
            self._session_redirects.pop(session.name, None)
        return {"name": session.name, "gen": session.gen,
                "pop": session.pop_size, "rows": session.bucket.rows,
                "sharded": session.sharded}

    def h_get_session(self, name: str) -> dict:
        s = self._session(name)
        if s.closed and self.redirect_for(name) is not None:
            # drained here and live elsewhere: the state this instance
            # still holds is stale, so a read redirects as a step would
            # (the JAX package's server answers the stale state)
            raise ServiceDraining(f"session {name!r} was drained from "
                                  "this instance")
        p = s.population()          # CPU tensors, read by the worker
        return {"name": s.name, "gen": s.gen, "phase": s.phase,
                "pop": s.pop_size, "rows": s.bucket.rows,
                "sharded": s.sharded, "weights": s.bucket.weights,
                "genome": p.genome, "values": p.fitness.values,
                "valid": p.fitness.valid}

    def h_close_session(self, name: str) -> dict:
        self._session(name).close()
        with self._lock:
            self._session_toolbox.pop(name, None)
        return {"closed": name}

    def h_step(self, name: str, body: dict) -> dict:
        s = self._session(name)
        futures = s.step(int(body.get("n", 1)),
                         deadline=body.get("deadline"))
        results = []
        for f in futures:
            try:
                results.append({"ok": self._result(f)})
            except Exception as e:  # noqa: BLE001 — per-gen error travels
                results.append({"error": type(e).__name__,
                                "message": str(e)})
        return {"results": results, "gen": s.gen}

    def h_ask(self, name: str, body: dict) -> dict:
        s = self._session(name)
        off = self._result(s.ask(deadline=body.get("deadline")))
        return {"offspring": off, "gen": s.gen}

    def h_tell(self, name: str, body: dict) -> dict:
        s = self._session(name)
        out = self._result(s.tell(body["values"],
                                  deadline=body.get("deadline")))
        return {"ok": out}

    def h_evaluate(self, name: str, body: dict) -> dict:
        s = self._session(name)
        values = self._result(s.evaluate(_as_host(body["genome"]),
                                         deadline=body.get("deadline")))
        return {"values": values}

    def h_drain(self, body: dict) -> dict:
        snaps = self.service.drain(timeout=body.get("timeout", 60.0))
        # resolve toolbox names AFTER the drain: the session set is frozen
        # now, so a create that raced the drain gate is either in the
        # snapshot (and resolvable below) or was rejected — never admitted
        # yet unnamed
        with self._lock:
            names = dict(self._session_toolbox)
        # sessions opened OUTSIDE this frontend (in-process, or restored
        # from a disk checkpoint) have no recorded registry name —
        # reverse-map their toolbox object so the snapshot stays
        # restorable on any instance holding the same registry
        rev = {id(tb): tn for tn, tb in self.toolboxes.items()}
        for name, sess in self.service.sessions().items():
            if name not in names:
                tn = rev.get(id(sess.toolbox))
                if tn is not None:
                    names[name] = tn
        for name, snap in snaps.items():
            snap["toolbox"] = names.get(name)
        if self.verbose:
            emit_text(f"[serve.net] drained {len(snaps)} sessions",
                      self.sinks)
        return {"sessions": snaps}

    def h_restore(self, body: dict) -> dict:
        snaps = body["sessions"]
        toolboxes: Dict[str, Any] = {}
        skipped: Dict[str, str] = {}
        for name, snap in snaps.items():
            tb_name = snap.get("toolbox")
            toolbox = self.toolboxes.get(tb_name)
            if toolbox is None:
                # one orphan (session drained with a toolbox this
                # registry doesn't hold) must not block the restorable
                # majority's failover — skip it and say so
                skipped[name] = (f"toolbox {tb_name!r} not in this "
                                 "instance's registry")
                continue
            toolboxes[name] = toolbox
        if snaps and not toolboxes:
            raise SessionUnknown(
                "no session in the snapshot names a toolbox in this "
                f"instance's registry (skipped: {skipped})")
        restored = self.service.adopt_sessions(
            {n: snaps[n] for n in toolboxes}, toolboxes)
        with self._lock:
            for name in restored:
                self._session_toolbox[name] = snaps[name].get("toolbox")
                self._session_redirects.pop(name, None)
        if self.verbose:
            emit_text(f"[serve.net] restored {sorted(restored)} "
                      f"skipped {sorted(skipped)}", self.sinks)
        return {"restored": sorted(restored), "skipped": skipped}

    def h_profile(self) -> dict:
        """``GET /v1/profile`` — the profiler's per-program table (see
        :class:`~deap_tpu_torch.observability.profiling.ProgramProfiler`):
        build times and min-of-k measured execute walls, keyed by
        readable program identity (the JAX package's XLA cost fields are
        absent)."""
        prof = self.service.profiler
        return {"enabled": bool(prof.enabled),
                "programs": prof.profiles()}

    def h_rebucket(self, body: dict) -> dict:
        sizes = body.get("sizes")
        return self.service.rebucket(
            max_buckets=int(body.get("max_buckets", 8)),
            warm=tuple(body.get("warm", ("step",))),
            sizes=None if sizes is None else [int(r) for r in sizes])

    def h_redirect(self, body: dict) -> dict:
        """Failover step 3 (optional): record where the drained sessions
        now live, so clients still pointed HERE get a typed redirect in
        the error envelope instead of a dead end.  ``{"url": null}``
        clears it.  With ``"session"`` in the body the redirect applies
        to that ONE session; it shadows the instance-wide target for
        that session's paths."""
        url = body.get("url")
        session = body.get("session")
        with self._lock:
            if session is None:
                self._redirect = None if url is None else str(url)
            elif url is None:
                self._session_redirects.pop(str(session), None)
            else:
                self._session_redirects[str(session)] = str(url)
        return {"location": url, "session": session}

    @property
    def redirect_location(self) -> Optional[str]:
        with self._lock:
            return self._redirect

    def redirect_for(self, session: Optional[str]) -> Optional[str]:
        """The redirect a stale client of ``session`` should follow: the
        session's own target when one is recorded, else the
        instance-wide drain target."""
        with self._lock:
            if session is not None:
                url = self._session_redirects.get(session)
                if url is not None:
                    return url
            return self._redirect


def _as_host(tree):
    """Decoded wire genome (numpy arrays — bfloat16 as tensors — in plain
    containers) → CPU tensors, container structure preserved (tuple and
    dict genomes allowed).  The service places them on its device."""
    from ..service import _as_tensor_tree
    return _as_tensor_tree(tree, copy=False)


def _rows_of(genome) -> int:
    from ...base import _leaves
    return _leaves(genome)[0].shape[0]


class _Handler(FrameHTTPHandler):
    """Routes one connection's requests into the :class:`NetServer`
    context.  Keep-alive HTTP/1.1 with explicit Content-Length (chunked
    only on the metrics stream); the wire plumbing — body read, byte
    counters, error envelopes, keep-alive drain — lives in
    :class:`~deap_tpu_torch.serve.net.httpcommon.FrameHTTPHandler`, shared
    with the router's handler."""

    server_ctx: NetServer = None  # bound by NetServer
    log_prefix = "serve.net"

    # -- plumbing ------------------------------------------------------------

    def _handler_metrics(self):
        net = self.server_ctx
        return net.service.metrics if net is not None else None

    def _log_conf(self):
        net = self.server_ctx
        if net is None:
            return False, ()
        return net.verbose, net.sinks

    def _body(self) -> Any:
        net = self.server_ctx
        tracer = net.service.tracer if net is not None else None
        t0 = tracer.clock() if tracer is not None else 0.0
        data = self._read_raw_body()
        if not data:
            return {}
        if data[:4] == protocol.MAGIC:
            obj, meta = protocol.decode_frame_with_meta(data)
            trace_in = meta["trace"]
            # deadline-budget propagation: the frame header carries the
            # client's REMAINING budget (decremented at each upstream
            # hop); the effective deadline is the tighter of that and
            # whatever the body itself asks for, so a stale body field
            # can never extend a budget the hops already spent
            if meta["deadline"] is not None and isinstance(obj, dict):
                d = obj.get("deadline")
                obj["deadline"] = (meta["deadline"] if d is None
                                   else min(float(d), meta["deadline"]))
            # payload-compression negotiation: remember what the PEER
            # can inflate (response-side), and account an inbound
            # compressed frame's savings
            self._accept = tuple(dict.fromkeys(
                tuple(getattr(self, "_accept", ())) + tuple(meta["accept"])))
            if meta["compressed"]:
                net.service.metrics.inc("net_frames_compressed")
                net.service.metrics.inc(
                    "net_bytes_saved",
                    max(0, meta["payload_bytes"]
                        - meta["wire_payload_bytes"]))
        else:
            obj, trace_in = json.loads(data.decode("utf-8")), None
        if tracer is not None and trace_in is not None:
            # adopt the sender's context: this request's server-side span
            # (a child of the client hop), the wire-decode phase under
            # it, and the thread-local handoff service._submit picks its
            # per-request children from
            ctx = tracer.adopt(trace_in)
            if ctx is not None:
                self._trace_ctx = ctx
                self._trace_t0 = t0
                tracer.phase("wire_decode", ctx, t0, tracer.clock(),
                             attrs={"bytes": len(data)})
                fleettrace.set_current(ctx)
        return obj

    def _encode_response(self, obj: Any) -> bytes:
        """Encode a response frame, compressing the tensor payload when
        the request advertised a codec this build holds and the payload
        clears the server's size floor; savings feed ``net_bytes_saved``."""
        net = self.server_ctx
        codec = next((c for c in getattr(self, "_accept", ())
                      if c in protocol.WIRE_CODECS), None)
        payload, stats = protocol.encode_frame_ex(
            obj, compress=codec,
            min_compress_bytes=net.compress_min_bytes)
        saved = stats["payload_bytes"] - stats["wire_payload_bytes"]
        if saved > 0:
            net.service.metrics.inc("net_frames_compressed")
            net.service.metrics.inc("net_bytes_saved", saved)
        return payload

    def _send_obj(self, obj: Any, status: int = 200) -> None:
        tracer = self.server_ctx.service.tracer
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None and tracer.enabled:
            t0 = tracer.clock()
            payload = self._encode_response(obj)
            self._send(payload, status=status)
            tracer.phase("response_encode", ctx, t0, tracer.clock(),
                         attrs={"bytes": len(payload)})
        else:
            self._send(self._encode_response(obj), status=status)

    def _send_error_obj(self, exc: BaseException) -> None:
        net = self.server_ctx
        net.service.metrics.inc("net_errors")
        # a drained instance that knows its replacement attaches the
        # typed redirect (draining rejections AND post-drain lookup
        # misses — the two shapes a stale client sees after failover);
        # a session's OWN redirect wins over the instance-wide one
        location = (net.redirect_for(getattr(self, "_session_name", None))
                    if isinstance(exc, (ServiceDraining, SessionUnknown))
                    else None)
        self._send_error_envelope(exc, location=location)
        if protocol.status_of(exc) == 500:
            # 500 = an UNMAPPED exception — a service bug, not a protocol
            # outcome (draining/deadline envelopes stay quiet) — dump the
            # flight recorder for the postmortem (rate-limited inside
            # dump(), so an error storm costs one dump per window)
            net.service.tracer.dump(f"error:{type(exc).__name__}",
                                    net.sinks)

    def _route(self, method: str) -> None:
        net = self.server_ctx
        net.service.metrics.inc("net_requests")
        self._body_consumed = False
        self._trace_ctx = None
        self._trace_t0 = 0.0
        self._session_name = None
        # per-request negotiation state: a keep-alive connection serves
        # many requests, and a stale accept list would compress a reply
        # for a peer that did not advertise on THIS request.  The HTTP
        # header channel covers bodyless GETs (the full-population read
        # is the response most worth compressing); a frame body's
        # __accept__ list unions in via _body()
        hdr = self.headers.get(protocol.ACCEPT_HEADER, "")
        self._accept = tuple(c.strip() for c in hdr.split(",")
                             if c.strip())
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if parts[:1] != ["v1"]:
                raise SessionUnknown(f"unknown path {url.path!r}")
            rest = parts[1:]
            if method == "GET" and rest == ["healthz"]:
                return self._send_json(net.h_healthz())
            if method == "GET" and rest == ["toolboxes"]:
                return self._send_json(
                    {"toolboxes": sorted(net.toolboxes)})
            if method == "GET" and rest == ["metrics"]:
                return self._metrics(parse_qs(url.query))
            if method == "GET" and rest == ["trace"]:
                return self._trace_tail(parse_qs(url.query))
            if method == "GET" and rest == ["profile"]:
                return self._send_json(net.h_profile())
            if rest[:1] == ["sessions"]:
                if method == "POST" and len(rest) == 1:
                    return self._send_obj(net.h_create(self._body()))
                # names arrive percent-encoded (clients quote arbitrary
                # session names into the path)
                if len(rest) == 2:
                    self._session_name = unquote(rest[1])
                    if method == "GET":
                        return self._send_obj(
                            net.h_get_session(self._session_name))
                    if method == "DELETE":
                        return self._send_obj(
                            net.h_close_session(self._session_name))
                if method == "POST" and len(rest) == 3:
                    name, op = unquote(rest[1]), rest[2]
                    self._session_name = name
                    fn = {"step": net.h_step, "ask": net.h_ask,
                          "tell": net.h_tell,
                          "evaluate": net.h_evaluate}.get(op)
                    if fn is not None:
                        return self._send_obj(fn(name, self._body()))
            if method == "POST" and rest[:1] == ["admin"] and len(rest) == 2:
                fn = {"drain": net.h_drain, "restore": net.h_restore,
                      "rebucket": net.h_rebucket,
                      "redirect": net.h_redirect}.get(rest[1])
                if fn is not None:
                    return self._send_obj(fn(self._body()))
            raise SessionUnknown(f"unknown path {url.path!r}")
        except BrokenPipeError:
            raise
        except Exception as e:  # noqa: BLE001 — typed over the wire
            try:
                self._send_error_obj(e)
            except BrokenPipeError:
                pass
        finally:
            # close the request span and clear the thread-local handoff —
            # this handler thread serves many keep-alive requests, and a
            # stale context would misparent the NEXT request's spans
            ctx = getattr(self, "_trace_ctx", None)
            if ctx is not None:
                fleettrace.set_current(None)
                tracer = net.service.tracer
                tracer.record(f"http.{method} {url.path}", ctx,
                              self._trace_t0, tracer.clock())

    # -- metrics stream ------------------------------------------------------

    def _trace_tail(self, query: Dict[str, list]) -> None:
        """``GET /v1/trace`` — tail the service's span ring (the live
        window of the flight recorder): optional ``max`` span count and
        ``trace_id`` filter.  Plain JSON, curl-able beside /v1/metrics."""
        tracer = self.server_ctx.service.tracer
        n = int(query.get("max", ["256"])[0])
        trace_id = query.get("trace_id", [None])[0]
        self._send_json({"enabled": bool(tracer.enabled),
                         "dropped": tracer.dropped,
                         "spans": tracer.recent(n, trace_id=trace_id)})

    def _metrics(self, query: Dict[str, list]) -> None:
        net = self.server_ctx
        svc = net.service
        if query.get("format", [""])[0] == "prometheus":
            return self._send(
                prometheus_text(svc.stats()).encode("utf-8"),
                content_type="text/plain; version=0.0.4; charset=utf-8")
        if query.get("stream", ["0"])[0] not in ("1", "true"):
            return self._send_json(json.loads(svc.stats().to_json()))
        svc.metrics.inc("net_streams")
        max_records = int(query.get("max", ["10"])[0])
        timeout = float(query.get("timeout", ["30"])[0])
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(line: str) -> None:
            data = (line + "\n").encode("utf-8")
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            svc.metrics.inc("net_bytes_out", len(data))

        seen = -1
        per_wait = min(timeout, 1.0)
        deadline = timeout
        waited = 0.0
        emitted = 0
        try:
            while emitted < max_records:
                # Condition-based tail of service activity (no polling
                # sleep): emit a record whenever the batch counter moves,
                # give up after `timeout` quiet seconds
                now = svc.wait_for_activity(seen, timeout=per_wait)
                if now == seen:
                    waited += per_wait
                    if waited >= deadline:
                        break
                    continue
                waited = 0.0
                seen = now
                # per-batch records skip the per-program profile table
                # (per-scrape rebuild work the stream's consumers never
                # read); the one-shot GET stays the full view
                chunk(svc.stats(programs=False).to_json())
                emitted += 1
            self.wfile.write(b"0\r\n\r\n")
        except BrokenPipeError:
            pass
