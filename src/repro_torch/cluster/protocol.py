"""Length-prefixed message protocol of the multi-process cluster runtime.

One frame = a 4-byte big-endian payload length followed by a UTF-8 JSON
object with a ``"type"`` key.  JSON keeps every message inspectable with
``tcpdump``/``strace`` and the framing trivial to reimplement (the point of
a coordinator/worker split is that the two sides share nothing but this
file); 4-byte frames cap a message at 4 GiB, far above anything the control
plane sends (payload *specs* travel, payload *data* never does).

Message types (see docs/architecture.md for the full field table):

=============  ==================  ==========================================
type           direction           meaning
=============  ==================  ==========================================
REGISTER       worker -> coord     join the fleet (carries pid)
WELCOME        coord  -> worker    assigned worker_id + heartbeat interval
HEARTBEAT      worker -> coord     liveness beacon (+ currently-busy job)
DISPATCH       coord  -> worker    run one batch payload (job, attempt,
                                   payload spec, absolute deadline)
RESULT         worker -> coord     batch finished / cancel acknowledged
CANCEL         coord  -> worker    stop one (job, attempt) if still running
RECONFIGURE    coord  -> worker    new generation adopted (drain-then-swap)
CHAOS          coord  -> worker    chaos harness: multiplicative slowdown
SHUTDOWN       coord  -> worker    exit cleanly
=============  ==================  ==========================================

All senders use :func:`send_message`; receivers feed raw bytes into a
:class:`FrameDecoder` (incremental — TCP fragments frames arbitrarily).
"""

from __future__ import annotations

import collections
import json
import socket
import struct
from typing import Iterator, Optional

__all__ = [
    "REGISTER",
    "WELCOME",
    "HEARTBEAT",
    "DISPATCH",
    "RESULT",
    "CANCEL",
    "RECONFIGURE",
    "CHAOS",
    "SHUTDOWN",
    "MESSAGE_TYPES",
    "encode_message",
    "send_message",
    "FrameDecoder",
    "recv_message",
]

REGISTER = "REGISTER"
WELCOME = "WELCOME"
HEARTBEAT = "HEARTBEAT"
DISPATCH = "DISPATCH"
RESULT = "RESULT"
CANCEL = "CANCEL"
RECONFIGURE = "RECONFIGURE"
CHAOS = "CHAOS"
SHUTDOWN = "SHUTDOWN"

MESSAGE_TYPES = frozenset(
    {
        REGISTER,
        WELCOME,
        HEARTBEAT,
        DISPATCH,
        RESULT,
        CANCEL,
        RECONFIGURE,
        CHAOS,
        SHUTDOWN,
    }
)

_HEADER = struct.Struct("!I")  # 4-byte big-endian payload length
MAX_FRAME = 1 << 24  # 16 MiB: far above any control message; catches garbage


def encode_message(msg: dict) -> bytes:
    """One wire frame for ``msg`` (must carry a known ``"type"``)."""
    mtype = msg.get("type")
    if mtype not in MESSAGE_TYPES:
        raise ValueError(f"unknown message type {mtype!r}")
    payload = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise ValueError(f"message of {len(payload)} bytes exceeds MAX_FRAME")
    return _HEADER.pack(len(payload)) + payload


def send_message(sock: socket.socket, msg: dict) -> None:
    """Frame and send one message (callers serialize concurrent senders)."""
    sock.sendall(encode_message(msg))


class FrameDecoder:
    """Incremental frame decoder: feed raw socket bytes, iterate messages.

    TCP is a byte stream — one ``recv`` may hold half a frame or five; the
    decoder buffers across :meth:`feed` calls and yields each complete
    message exactly once.  Frames are decoded EAGERLY into a pending queue,
    so a caller that abandons the iterator early (e.g. a take-one
    ``recv_message``) loses nothing: the leftover messages are yielded by
    the next :meth:`feed` call, even one fed no new bytes.

    >>> dec = FrameDecoder()
    >>> data = encode_message({"type": HEARTBEAT, "worker_id": 3})
    >>> [m["worker_id"] for m in dec.feed(data[:5])]
    []
    >>> [m["worker_id"] for m in dec.feed(data[5:])]
    [3]
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self._pending: collections.deque = collections.deque()

    @property
    def pending(self) -> int:
        """Decoded-but-unconsumed messages (abandoned-iterator leftovers)."""
        return len(self._pending)

    def feed(self, data: bytes) -> Iterator[dict]:
        self._buf.extend(data)
        while True:
            if len(self._buf) < _HEADER.size:
                break
            (length,) = _HEADER.unpack_from(self._buf)
            if length > MAX_FRAME:
                raise ValueError(
                    f"frame of {length} bytes exceeds MAX_FRAME — "
                    "corrupt stream or a non-protocol peer"
                )
            end = _HEADER.size + length
            if len(self._buf) < end:
                break
            payload = bytes(self._buf[_HEADER.size : end])
            del self._buf[:end]
            msg = json.loads(payload.decode("utf-8"))
            if not isinstance(msg, dict) or msg.get("type") not in MESSAGE_TYPES:
                raise ValueError(f"malformed message: {payload[:128]!r}")
            self._pending.append(msg)
        while self._pending:
            yield self._pending.popleft()


def recv_message(
    sock: socket.socket, decoder: Optional[FrameDecoder] = None
) -> Optional[dict]:
    """Blocking receive of ONE message (None on clean EOF).

    Convenience for sequential read loops and tests; the coordinator's
    selector loop feeds its per-connection decoders directly.  Extra frames
    pulled in by the same ``recv`` stay pending inside ``decoder`` — pass a
    persistent decoder (not the default throwaway) if the stream continues.
    """
    dec = decoder if decoder is not None else FrameDecoder()
    while True:
        data = sock.recv(65536)
        if not data:
            return None
        for msg in dec.feed(data):
            return msg
