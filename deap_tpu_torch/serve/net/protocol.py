"""Wire format of the serving frontend: JSON control + raw tensor framing.

Every request/response body is one **frame**::

    MAGIC(4) | header_len:u32le | header JSON (utf-8) | tensor payloads...

The header is an arbitrary JSON document in which tensors appear as
``{"__tensor__": i}`` placeholders; slot ``i`` of the header's
``"__tensors__"`` manifest records ``(dtype, shape)`` and the payloads
follow the header back-to-back in slot order as raw little-endian
contiguous bytes.  Encoding is bit-exact for every array dtype the
framework serves (float32/16, bfloat16 as its raw 16-bit pattern, ints,
bools) — fitness and genomes survive a round trip bitwise, which the
failover drill depends on.  Tensors may be numpy arrays or torch tensors
(any device: copied to the host); a frame of the same object is
byte-identical to the JAX package's, so either side of the wire may be
either package.  Decoded tensors come back as numpy arrays, except
bfloat16 (the ``"bfloat16"`` token), which comes back as a CPU
``torch.bfloat16`` tensor — numpy has no bfloat16 without
``ml_dtypes``, which the port does not need.  Python tuples are tagged (``"__tuple__"``)
so objective ``weights`` come back hashable, and ``bytes`` values ride as
base64 (``"__bytes__"``).

No pickle anywhere on the wire: a frame can describe only JSON scalars,
containers and typed arrays, so a malicious peer can at worst send wrong
numbers, not code.

**Payload compression** (negotiated, optional): a sender may zlib the
concatenated tensor payload section — at pop=10⁶/dim=100 a single tell
is ~400 MB raw — marking the frame header with ``"__zip__": "zlib"``;
the decoder inflates before slicing, so arrays round-trip **bit-exact**
(zlib is lossless — NaN payloads and signed zeros included, pinned by
test).  Negotiation rides the header too: a request that advertises
``"__accept__": ["zlib"]`` invites the responder to compress its reply;
a peer that never advertises never receives a compressed frame, and a
legacy decoder that ignores both keys still decodes every UNcompressed
frame identically.  The router forwards frames verbatim (payload bytes
untouched), so end-to-end compression survives the extra hop.

Error mapping: service-layer exceptions travel as
``{"error": <class name>, "message": ...}`` JSON with a matching HTTP
status (:data:`ERROR_STATUS`); :func:`remote_exception` rebuilds the
typed exception on the client so ``RemoteSession`` raises exactly what
the in-process ``Session`` would — a CUDA kernel that fails to build or
launch included (:class:`~deap_tpu_torch.kernels.build.KernelBuildError`,
:class:`~deap_tpu_torch.kernels.KernelLaunchError`, status 500):
nothing falls back to a plain version.  A draining instance that knows where
its sessions went may add ``"location"`` to the envelope — the typed
redirect the client follows transparently on failover.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dispatcher import (ServeError, ServiceClosed, ServiceOverloaded,
                          DeadlineExceeded, RequestCancelled,
                          ServiceDraining, SessionUnknown,
                          TenantQuotaExceeded, CircuitOpen, ServiceBrownout)
from ..buckets import BucketOverflow
from ...kernels import KernelLaunchError
from ...kernels.build import KernelBuildError

__all__ = ["MAGIC", "BF16", "CONTENT_TYPE", "ACCEPT_HEADER", "encode_frame",
           "encode_frame_ex", "decode_frame", "decode_frame_with_trace",
           "decode_frame_with_meta", "rewrite_trace", "rewrite_header",
           "status_of", "error_payload", "remote_exception", "ERROR_STATUS",
           "ProtocolError", "WIRE_CODECS"]


class ProtocolError(ServeError, ValueError):
    """A frame that violates the DTF1 wire format: bad magic, truncated
    header, or a tensor manifest whose declared byte lengths exceed the
    remaining body.  Subclasses :class:`ValueError` so pre-existing
    ``except ValueError`` edges still catch it, and :class:`ServeError`
    so it travels the typed error envelope (status 400) instead of
    crashing the handler with a struct unpack error."""

#: payload codecs this build can negotiate (name -> (deflate, inflate))
WIRE_CODECS = {"zlib": (zlib.compress, zlib.decompress)}


def _inflate_zlib_bounded(data: bytes, max_bytes: int) -> bytes:
    """Inflate at most ``max_bytes`` (+1 sentinel byte) of output — the
    decompression-bomb guard: a frame's payload may never expand past
    what its own tensor manifest accounts for, so a few-MB frame cannot
    allocate gigabytes before the manifest size check runs."""
    d = zlib.decompressobj()
    out = d.decompress(data, max_bytes + 1)
    if len(out) > max_bytes:
        raise ValueError(
            f"compressed payload inflates past the {max_bytes} bytes its "
            "tensor manifest declares (rejecting decompression bomb)")
    return out


#: decode-side inflate per codec, bounded by the manifest's declared
#: byte total (the compress side stays the plain function in
#: :data:`WIRE_CODECS`)
_INFLATE_BOUNDED = {"zlib": _inflate_zlib_bounded}

#: HTTP request header carrying the sender's acceptable payload codecs —
#: the negotiation channel for BODYLESS requests (a GET of a session's
#: full population is exactly the response most worth compressing, and
#: has no frame to advertise in).  Comma-separated codec names; the
#: frame-header ``__accept__`` list and this header are unioned.
ACCEPT_HEADER = "X-DTF-Accept"

MAGIC = b"DTF1"
CONTENT_TYPE = "application/x-deap-frame"

_HEAD = struct.Struct("<I")


#: wire token of bfloat16 (``ml_dtypes``' dtype name, the JAX package's)
BF16 = "bfloat16"


class _Bf16Bits:
    """A bfloat16 tensor's payload on the way out: its raw 16-bit
    pattern (``bits``, uint16) under the ``"bfloat16"`` token."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    @property
    def shape(self):
        return self.bits.shape


def _to_array(x):
    """A tensor leaf as a host array: torch tensors are copied to the host
    (bfloat16 as its bit pattern), anything else with ``__array__`` goes
    through numpy; ascontiguousarray so tobytes() is the row-major bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16Bits(np.ascontiguousarray(
                t.view(torch.int16).numpy().view(np.uint16)))
        return np.ascontiguousarray(t.numpy())
    return np.ascontiguousarray(np.asarray(x))


def _pack(obj: Any, tensors: List[np.ndarray]) -> Any:
    if isinstance(obj, dict):
        bad = [k for k in obj if not isinstance(k, str)]
        if bad:
            # silently stringifying keys would rewrite a pytree genome's
            # structure server-side; fail at the edge instead
            raise TypeError(
                f"wire frames require str dict keys, got {bad[:3]!r}")
        return {k: _pack(v, tensors) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {"__tuple__": [_pack(v, tensors) for v in obj]}
    if isinstance(obj, list):
        return [_pack(v, tensors) for v in obj]
    if isinstance(obj, bytes):
        return {"__bytes__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    if isinstance(obj, (np.bool_, np.integer, np.floating)):
        return obj.item()
    if (isinstance(obj, torch.Tensor) or hasattr(obj, "__array__")
            or isinstance(obj, np.ndarray)):
        a = _to_array(obj)
        if isinstance(a, _Bf16Bits):
            tensors.append(a)
            return {"__tensor__": len(tensors) - 1}
        if a.dtype == object:
            raise TypeError("object arrays are not wire-encodable")
        tensors.append(a)
        return {"__tensor__": len(tensors) - 1}
    raise TypeError(f"cannot wire-encode {type(obj).__name__}")


def _unpack(obj: Any, tensors: List[np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if "__tensor__" in obj and len(obj) == 1:
            return tensors[obj["__tensor__"]]
        if "__tuple__" in obj and len(obj) == 1:
            return tuple(_unpack(v, tensors) for v in obj["__tuple__"])
        if "__bytes__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__bytes__"])
        return {k: _unpack(v, tensors) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, tensors) for v in obj]
    return obj


def _dtype_token(a) -> str:
    """Wire name of an array's dtype: the byte-order-explicit ``str``
    form for native numpy dtypes, the registered NAME for extension
    dtypes (bfloat16, float8_*, ... — their ``str`` is an opaque void
    like ``<V2`` that would not round-trip)."""
    if isinstance(a, _Bf16Bits):
        return BF16
    dt = a.dtype
    if dt.kind == "V":
        return dt.name
    return dt.str


def _dtype_of(token: str) -> np.dtype:
    """The numpy dtype a token's payload is read as: a native dtype, or
    for ``"bfloat16"`` its 16-bit pattern (``uint16``), rebuilt into a
    ``torch.bfloat16`` tensor after the read."""
    if token and token[0] in "<>|=":
        return np.dtype(token).newbyteorder("<")
    if token == BF16:
        return np.dtype("<u2")
    raise ValueError(f"unknown wire dtype {token!r}")


def encode_frame_ex(obj: Any, trace: Any = None, *,
                    deadline: Optional[float] = None,
                    compress: Optional[str] = None,
                    accept: Tuple[str, ...] = (),
                    min_compress_bytes: int = 4096
                    ) -> Tuple[bytes, Dict[str, int]]:
    """Encode a frame and report its payload accounting.

    Returns ``(frame_bytes, stats)`` with ``stats["payload_bytes"]`` the
    raw tensor-payload size and ``stats["wire_payload_bytes"]`` what
    actually hit the wire — their difference feeds the server's
    ``net_bytes_saved`` counter.  ``compress`` names a
    :data:`WIRE_CODECS` codec to deflate the payload section with
    (applied only when the raw payload reaches ``min_compress_bytes`` —
    deflating a 100-byte ask header costs more than it saves); ``accept``
    advertises the codecs THIS peer can inflate, inviting the responder
    to compress its reply.  ``deadline`` (optional, seconds) is the
    sender's REMAINING deadline budget, stored in the header under
    ``"__deadline__"`` — every forwarding hop subtracts its own dwell
    time (:func:`rewrite_header`) so the terminal dispatcher sees the
    true budget left, not the budget the client started with."""
    tensors: List[np.ndarray] = []
    body = _pack(obj, tensors)
    header = {"body": body,
              "__tensors__": [{"dtype": _dtype_token(a),
                               "shape": list(a.shape)}
                              for a in tensors]}
    if trace is not None:
        header["__trace__"] = trace
    if deadline is not None:
        header["__deadline__"] = float(deadline)
    if accept:
        header["__accept__"] = [c for c in accept if c in WIRE_CODECS]
    payload_parts = []
    for a in tensors:
        if isinstance(a, _Bf16Bits):
            payload_parts.append(
                a.bits.astype(np.dtype("<u2"), copy=False).tobytes())
        elif a.dtype.kind == "V":
            # extension dtypes (bfloat16 & friends) carry their raw bits;
            # single-byte-lane or little-endian hosts only — every
            # supported platform (x86/ARM hosts) is little-endian
            payload_parts.append(a.tobytes())
        else:
            # canonical little-endian payload, whatever the host order
            payload_parts.append(
                a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())
    payload = b"".join(payload_parts)
    raw_bytes = len(payload)
    if (compress is not None and compress in WIRE_CODECS
            and raw_bytes >= int(min_compress_bytes)):
        deflated = WIRE_CODECS[compress][0](payload)
        if len(deflated) < raw_bytes:   # incompressible data ships raw
            header["__zip__"] = compress
            payload = deflated
    hdr = json.dumps(header, allow_nan=True).encode("utf-8")
    frame = b"".join([MAGIC, _HEAD.pack(len(hdr)), hdr, payload])
    return frame, {"payload_bytes": raw_bytes,
                   "wire_payload_bytes": len(payload)}


def encode_frame(obj: Any, trace: Any = None, *,
                 deadline: Optional[float] = None,
                 compress: Optional[str] = None,
                 accept: Tuple[str, ...] = (),
                 min_compress_bytes: int = 4096) -> bytes:
    """Encode a JSON-plus-arrays object tree into one wire frame.

    ``trace`` (optional) is a small JSON-safe dict — the
    :meth:`~deap_tpu_torch.observability.fleettrace.TraceContext.wire` form —
    stored in the frame HEADER under ``"__trace__"``, beside the tensor
    manifest: request tracing is header metadata, invisible to the body
    the decoder hands back (a peer that ignores it decodes identically).
    ``deadline`` is the remaining deadline budget in seconds
    (``"__deadline__"`` header — see :func:`encode_frame_ex`);
    ``compress``/``accept`` are the payload-compression negotiation
    (see :func:`encode_frame_ex`, which also reports bytes saved)."""
    return encode_frame_ex(obj, trace, deadline=deadline, compress=compress,
                           accept=accept,
                           min_compress_bytes=min_compress_bytes)[0]


def _split_header(data: bytes) -> Tuple[dict, int]:
    """Parse and validate the frame prefix; returns ``(header dict,
    payload offset)``."""
    if len(data) < 8 or data[:4] != MAGIC:
        raise ProtocolError("not a deap-tpu wire frame (bad magic)")
    (hlen,) = _HEAD.unpack_from(data, 4)
    hdr_end = 8 + hlen
    if len(data) < hdr_end:
        raise ProtocolError(
            f"truncated frame header: header declares {hlen} bytes, "
            f"{len(data) - 8} present")
    try:
        header = json.loads(data[8:hdr_end].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        # a corrupted-on-the-wire header must surface as the typed
        # protocol error, not a bare json traceback in the handler
        raise ProtocolError(f"undecodable frame header: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError("frame header is not a JSON object")
    return header, hdr_end


def decode_frame(data: bytes) -> Any:
    """Decode :func:`encode_frame` output back into the object tree
    (arrays come back as numpy — bfloat16 as a CPU tensor —, bitwise
    equal to what was encoded)."""
    return decode_frame_with_meta(data)[0]


def decode_frame_with_trace(data: bytes):
    """Like :func:`decode_frame`, additionally returning the frame
    header's ``"__trace__"`` dict (``None`` when the sender attached no
    trace context) — what the server handler adopts request spans
    from."""
    obj, meta = decode_frame_with_meta(data)
    return obj, meta["trace"]


def decode_frame_with_meta(data: bytes) -> Tuple[Any, Dict[str, Any]]:
    """Full decode: ``(object tree, meta)`` where ``meta`` carries the
    header's negotiation state — ``trace`` (adopted by the server
    handler), ``accept`` (codecs the sender can inflate, so the responder
    knows whether it may compress its reply), ``compressed`` (codec name
    or ``None``), and the ``payload_bytes``/``wire_payload_bytes`` pair
    the byte-savings counters are computed from."""
    header, off = _split_header(data)
    codec = header.get("__zip__")
    wire_payload = len(data) - off
    # manifest first: its declared byte total bounds the inflate below
    specs: List[tuple] = []
    declared = 0
    for spec in header.get("__tensors__", ()):
        dt = _dtype_of(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if nbytes < 0:
            raise ValueError("negative tensor extent in manifest")
        specs.append((dt, shape, nbytes, spec["dtype"] == BF16))
        declared += nbytes
    if codec is None and declared > wire_payload:
        # reject BEFORE touching any tensor bytes: the manifest promises
        # more payload than the body carries (a frame cut mid-flight),
        # and trusting it would hand np.frombuffer an out-of-bounds read
        raise ProtocolError(
            f"truncated frame: tensor manifest declares {declared} "
            f"payload bytes but only {wire_payload} remain in the body")
    if codec is not None:
        if codec not in WIRE_CODECS:
            raise ValueError(f"unknown payload codec {codec!r}")
        payload = _INFLATE_BOUNDED[codec](data[off:], declared)
        off = 0
    else:
        payload = data
    start = off
    tensors: List[np.ndarray] = []
    for dt, shape, nbytes, bf16 in specs:
        if off + nbytes > len(payload):
            raise ProtocolError(
                f"truncated tensor payload: slot needs {nbytes} bytes, "
                f"{len(payload) - off} remain")
        a = np.frombuffer(payload, dtype=dt, count=nbytes // dt.itemsize,
                          offset=off)
        a = a.reshape(shape).astype(dt.newbyteorder("="), copy=True)
        if bf16:
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        tensors.append(a)
        off += nbytes
    if off != len(payload):
        raise ValueError(f"{len(payload) - off} trailing bytes after "
                         "tensors")
    trace = header.get("__trace__")
    accept = tuple(c for c in header.get("__accept__", ())
                   if isinstance(c, str))
    deadline = header.get("__deadline__")
    return _unpack(header["body"], tensors), {
        "trace": trace if isinstance(trace, dict) else None,
        "accept": accept,
        "compressed": codec,
        "deadline": (float(deadline)
                     if isinstance(deadline, (int, float))
                     and not isinstance(deadline, bool) else None),
        "payload_bytes": off - start,
        "wire_payload_bytes": wire_payload,
    }


#: sentinel distinguishing "leave this header key alone" from an
#: explicit ``None`` (which strips the key) in :func:`rewrite_header`
_KEEP = object()


def rewrite_header(data: bytes, *, trace: Any = _KEEP,
                   deadline: Any = _KEEP) -> bytes:
    """Rewrite a frame's metadata header keys IN PLACE of the old ones,
    leaving the tensor payload bytes untouched — how the router edits
    its hop into a possibly-huge (possibly-compressed) frame without
    ever decoding the tensors.  ``trace`` replaces ``"__trace__"`` and
    ``deadline`` (seconds of remaining budget) replaces
    ``"__deadline__"``; passing ``None`` strips the key, omitting the
    argument keeps whatever the frame carried.  One re-serialize covers
    every edited key, so the trace hop and the deadline decrement cost a
    single header rewrite at the router."""
    header, off = _split_header(data)
    for key, value in (("__trace__", trace), ("__deadline__", deadline)):
        if value is _KEEP:
            continue
        if value is None:
            header.pop(key, None)
        elif key == "__deadline__":
            header[key] = float(value)
        else:
            header[key] = value
    hdr = json.dumps(header, allow_nan=True).encode("utf-8")
    return b"".join([MAGIC, _HEAD.pack(len(hdr)), hdr, data[off:]])


def rewrite_trace(data: bytes, trace: Any) -> bytes:
    """Replace (or insert/remove) a frame's ``"__trace__"`` header,
    payload untouched (:func:`rewrite_header` with only ``trace``).
    ``trace=None`` strips the header."""
    return rewrite_header(data, trace=trace)


# ---------------------------------------------------------------------------
# error mapping
# ---------------------------------------------------------------------------

#: service exception class -> HTTP status (client rebuilds by class name)
ERROR_STATUS: Dict[type, int] = {
    SessionUnknown: 404,
    BucketOverflow: 413,
    TenantQuotaExceeded: 429,
    ServiceBrownout: 429,
    ServiceOverloaded: 429,
    RequestCancelled: 409,
    DeadlineExceeded: 504,
    CircuitOpen: 503,
    ServiceDraining: 503,
    ServiceClosed: 503,
    ProtocolError: 400,
    KernelBuildError: 500,
    KernelLaunchError: 500,
    ServeError: 409,
    ValueError: 400,
    KeyError: 400,
    TypeError: 400,
}

_BY_NAME = {cls.__name__: cls for cls in ERROR_STATUS}


def status_of(exc: BaseException) -> int:
    for cls, status in ERROR_STATUS.items():
        if isinstance(exc, cls):
            return status
    return 500


def error_payload(exc: BaseException,
                  location: Optional[str] = None) -> bytes:
    """The JSON error envelope.  ``location`` (optional) is the typed
    redirect a drained instance attaches once it knows where its
    sessions were restored — :class:`RemoteService` re-targets and
    retries transparently (safe: the erroring instance rejected the
    request before executing it)."""
    doc = {"error": type(exc).__name__, "message": str(exc)}
    if location:
        doc["location"] = str(location)
    return json.dumps(doc).encode("utf-8")


def remote_exception(name: str, message: str) -> BaseException:
    """Rebuild the typed service exception a peer reported; unknown
    classes degrade to :class:`ServeError` with the name prefixed."""
    cls = _BY_NAME.get(name)
    if cls is None:
        return ServeError(f"{name}: {message}")
    return cls(message)
