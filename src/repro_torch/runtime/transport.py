"""Wire transport for cross-host serving, as ``repro.runtime.transport``.

One versioned binary codec, three carriers:

* **Framing codec** — ``encode_frame(kind, obj)`` / ``decode_frame(buf)``:
  a self-delimiting frame (magic ``TKWV``, version, body length, CRC-32)
  around a tagged recursive value encoding of what the serving layer ships
  — request/response envelopes (plain dicts of scalars, strings and
  lists) and the KV-migration payload trees.  The frames are the
  reference's, byte for byte: either package decodes the other's.

  Arrays go as a dtype string, a shape and the raw C-order bytes.
  ``encode_frame`` takes numpy arrays, written with ``dtype.str`` as the
  reference writes them, and torch tensors, copied to the host and
  written with the numpy dtype string of their dtype; ``torch.bfloat16``
  is written as ``"bfloat16"``, the name the reference's numpy (with
  ml_dtypes, which JAX loads) decodes as a bfloat16 array.  Every decoded
  array is a CPU ``torch.Tensor``: bfloat16 has no numpy dtype without
  ml_dtypes, so ``"bfloat16"``, and the ``'<V2'``/``'|V2'`` that the
  reference writes for an ml_dtypes bfloat16 array, decode to
  ``torch.bfloat16``.  Truncated, corrupted, version-skewed or
  hostile-length frames raise ``TransportError`` instead of mis-importing.

* **LoopbackTransport** — the deterministic in-memory wire of the
  virtual-clock cluster (``ClusterConfig.wire="loopback"``): every transfer
  is a real encode→decode round trip with frame/byte accounting, no
  sockets and no wall time.

* **Socket transport** — the same codec over TCP:
  ``read_frame_async``/``write_frame_async`` for asyncio streams,
  ``SocketChannel`` as the blocking client.  ``EngineHost`` serves one
  ``Engine`` behind a small command protocol (submit / step / adopt /
  abort / quiesce / …), and ``RemoteEngine`` is the client-side proxy that
  plugs into ``runtime/cluster.py``'s ``Replica`` unchanged.  ``python -m
  repro_torch.runtime.transport`` hosts one replica per process, on CUDA
  unless its spec says ``"device": "cpu"``.  A dead peer surfaces as
  ``ReplicaGone``, which the cluster treats as a missed heartbeat.
"""
from __future__ import annotations

import asyncio
import os
import socket
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.engine import Engine, Handoff
from repro_torch.runtime.requests import Request, State, reset_for_requeue

MAGIC = b"TKWV"
WIRE_VERSION = 1
_HEADER = struct.Struct("!4sHI")     # magic, version, body length
_CRC = struct.Struct("!I")           # crc32 over the body
_U32 = struct.Struct("!I")
_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")
_U8 = struct.Struct("!B")

# one frame tops out well under this; a corrupted length field must not
# make a reader try to allocate gigabytes
MAX_FRAME_BODY = 1 << 30

BF16 = "bfloat16"
# what the reference writes for an ml_dtypes bfloat16 array (dtype.str)
_BF16_NAMES = (BF16, "<V2", "|V2")


class TransportError(RuntimeError):
    """Malformed wire data: truncated, corrupted, or version-skewed."""


class ReplicaGone(TransportError):
    """The peer vanished mid-conversation (socket EOF/reset) — the
    cluster's dead-replica detector treats this as a missed heartbeat."""


# --------------------------------------------------------------------------
# tagged value encoding
# --------------------------------------------------------------------------

def _array_wire(obj) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype string, shape, C-order bytes) of a numpy array or a tensor."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        try:
            arr = t.numpy()
        except TypeError:
            raise TypeError(f"cannot encode tensor dtype {t.dtype} for the "
                            f"wire") from None
    else:
        # NOT ascontiguousarray: that promotes 0-d arrays to 1-d, which
        # would silently change the decoded shape
        arr = np.asarray(obj, order="C")
    return arr.dtype.str, arr.shape, arr.tobytes()


def _enc_value(obj, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, (int, np.integer)):
        out.append(b"I" + _I64.pack(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(b"D" + _F64.pack(float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"S" + _U32.pack(len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b"B" + _U32.pack(len(obj)) + bytes(obj))
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        name, shape, raw = _array_wire(obj)
        dt = name.encode("ascii")
        out.append(b"A" + _U8.pack(len(dt)) + dt + _U8.pack(len(shape)))
        for dim in shape:
            out.append(_U32.pack(dim))
        out.append(_U32.pack(len(raw)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(b"L" + _U32.pack(len(obj)))
        for item in obj:
            _enc_value(item, out)
    elif isinstance(obj, dict):
        out.append(b"M" + _U32.pack(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"wire dict keys must be str, got {k!r}")
            raw = k.encode("utf-8")
            out.append(_U32.pack(len(raw)) + raw)
            _enc_value(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__!r} for the wire")


def _take(buf: bytes, off: int, n: int) -> Tuple[bytes, int]:
    if off + n > len(buf):
        raise TransportError(
            f"truncated frame body: need {n} bytes at offset {off}, "
            f"have {len(buf) - off}")
    return buf[off:off + n], off + n


def _wire_dtype(name: str) -> Tuple[np.dtype, bool]:
    """The numpy dtype whose bytes a wire dtype string names, and whether
    they are bfloat16 (carried as int16 bits)."""
    if name in _BF16_NAMES:
        return np.dtype(np.int16), True
    try:
        dtype = np.dtype(name)
    except (TypeError, ValueError) as e:
        raise TransportError(f"bad array dtype on the wire: {e}")
    if dtype.kind not in "biufc":
        raise TransportError(f"array dtype {name!r} has no tensor type")
    return dtype, False


def _dec_array(dt: bytes, shape: List[int], raw: bytes, dtype: np.dtype,
               bf16: bool) -> torch.Tensor:
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    arr = arr.astype(dtype.newbyteorder("="), copy=True)
    try:
        t = torch.from_numpy(arr)
    except TypeError as e:
        raise TransportError(f"array dtype {dt!r} has no tensor type: {e}")
    return t.view(torch.bfloat16) if bf16 else t


def _dec_value(buf: bytes, off: int):
    tag, off = _take(buf, off, 1)
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"I":
        raw, off = _take(buf, off, 8)
        return _I64.unpack(raw)[0], off
    if tag == b"D":
        raw, off = _take(buf, off, 8)
        return _F64.unpack(raw)[0], off
    if tag == b"S":
        raw, off = _take(buf, off, 4)
        raw, off = _take(buf, off, _U32.unpack(raw)[0])
        return raw.decode("utf-8"), off
    if tag == b"B":
        raw, off = _take(buf, off, 4)
        raw, off = _take(buf, off, _U32.unpack(raw)[0])
        return raw, off
    if tag == b"A":
        raw, off = _take(buf, off, 1)
        dt, off = _take(buf, off, _U8.unpack(raw)[0])
        try:
            name = dt.decode("ascii")
        except UnicodeDecodeError as e:
            raise TransportError(f"bad array dtype on the wire: {e}")
        dtype, bf16 = _wire_dtype(name)
        raw, off = _take(buf, off, 1)
        ndim = _U8.unpack(raw)[0]
        shape = []
        for _ in range(ndim):
            raw, off = _take(buf, off, 4)
            shape.append(_U32.unpack(raw)[0])
        raw, off = _take(buf, off, 4)
        nbytes = _U32.unpack(raw)[0]
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes != want:
            raise TransportError(
                f"array payload length {nbytes} != shape/dtype size {want}")
        raw, off = _take(buf, off, nbytes)
        return _dec_array(dt, shape, raw, dtype, bf16), off
    if tag == b"L":
        raw, off = _take(buf, off, 4)
        n = _U32.unpack(raw)[0]
        items = []
        for _ in range(n):
            item, off = _dec_value(buf, off)
            items.append(item)
        return items, off
    if tag == b"M":
        raw, off = _take(buf, off, 4)
        n = _U32.unpack(raw)[0]
        d = {}
        for _ in range(n):
            raw, off = _take(buf, off, 4)
            raw, off = _take(buf, off, _U32.unpack(raw)[0])
            key = raw.decode("utf-8")
            d[key], off = _dec_value(buf, off)
        return d, off
    raise TransportError(f"unknown value tag {tag!r} at offset {off - 1}")


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------

def encode_frame(kind: str, obj) -> bytes:
    """One self-delimiting frame: header (magic, version, body length) +
    body (kind + tagged value) + CRC-32 of the body."""
    kraw = kind.encode("utf-8")
    if len(kraw) > 255:
        raise ValueError(f"frame kind too long: {kind!r}")
    parts: List[bytes] = [_U8.pack(len(kraw)), kraw]
    _enc_value(obj, parts)
    body = b"".join(parts)
    return (_HEADER.pack(MAGIC, WIRE_VERSION, len(body)) + body
            + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF))


def decode_frame(buf: bytes) -> Tuple[str, object]:
    """Inverse of ``encode_frame``; raises ``TransportError`` on any
    truncation, corruption, version skew, or trailing garbage."""
    if len(buf) < _HEADER.size + _CRC.size:
        raise TransportError(f"truncated frame: {len(buf)} bytes")
    magic, version, body_len = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise TransportError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise TransportError(
            f"wire version {version} != {WIRE_VERSION} (no negotiation: "
            f"both ends must run the same codec)")
    if body_len > MAX_FRAME_BODY:
        raise TransportError(f"frame body length {body_len} exceeds cap")
    if len(buf) != _HEADER.size + body_len + _CRC.size:
        raise TransportError(
            f"frame length mismatch: header says {body_len} body bytes, "
            f"buffer has {len(buf) - _HEADER.size - _CRC.size}")
    body = buf[_HEADER.size:_HEADER.size + body_len]
    (crc,) = _CRC.unpack_from(buf, _HEADER.size + body_len)
    if crc != (zlib.crc32(body) & 0xFFFFFFFF):
        raise TransportError("frame CRC mismatch (corrupted body)")
    raw, off = _take(body, 0, 1)
    kraw, off = _take(body, off, _U8.unpack(raw)[0])
    obj, off = _dec_value(body, off)
    if off != len(body):
        raise TransportError(f"{len(body) - off} trailing bytes after the "
                             f"frame value")
    return kraw.decode("utf-8"), obj


# --------------------------------------------------------------------------
# request / handoff envelopes
# --------------------------------------------------------------------------

# everything except engine-local placement (``slot``); step counters ride
# along so latency accounting survives a migration
_REQ_SCALARS = ("rid", "max_new_tokens", "prefill_pos", "arrival_step",
                "first_token_step", "done_step", "preemptions",
                "prompt_hit_tokens", "migrations", "requeues",
                "arrival_time", "deadline", "admit_time",
                "first_token_time", "finish_time")


def request_to_wire(req: Request) -> dict:
    d = {k: getattr(req, k) for k in _REQ_SCALARS}
    d["prompt"] = [int(t) for t in req.prompt]
    d["output"] = [int(t) for t in req.output]
    d["state"] = req.state.value
    d["resumed"] = bool(req.resumed)
    d["handoff_after_prefill"] = bool(req.handoff_after_prefill)
    d["finish_reason"] = req.finish_reason
    return d


def request_from_wire(d: dict) -> Request:
    req = Request(rid=int(d["rid"]), prompt=list(d["prompt"]),
                  max_new_tokens=int(d["max_new_tokens"]))
    req.state = State(d["state"])
    req.output = list(d["output"])
    req.resumed = bool(d["resumed"])
    req.handoff_after_prefill = bool(d["handoff_after_prefill"])
    req.finish_reason = d["finish_reason"]
    for k in _REQ_SCALARS:
        if k != "rid":
            setattr(req, k, d[k])
    return req


def handoff_to_wire(h: Handoff) -> dict:
    return {"req": request_to_wire(h.req), "n_tokens": int(h.n_tokens),
            "payload": h.payload}


def handoff_from_wire(d: dict, req: Optional[Request] = None) -> Handoff:
    """Rebuild a ``Handoff``; pass ``req`` to keep an existing Request
    object's identity (the loopback twin tracks requests by object, only
    the payload bytes need to cross the codec)."""
    return Handoff(req=req if req is not None else
                   request_from_wire(d["req"]),
                   n_tokens=int(d["n_tokens"]), payload=d["payload"])


class LoopbackTransport:
    """Deterministic in-memory wire: every ``transfer`` is a full
    encode→decode round trip through the frame codec (the same bytes a
    socket would carry) with frame/byte accounting and zero wall time."""

    def __init__(self):
        self.frames = 0
        self.bytes = 0

    def transfer(self, kind: str, obj) -> Tuple[object, int]:
        frame = encode_frame(kind, obj)
        self.frames += 1
        self.bytes += len(frame)
        got_kind, got = decode_frame(frame)
        if got_kind != kind:
            raise TransportError(f"loopback kind skew: sent {kind!r}, "
                                 f"decoded {got_kind!r}")
        return got, len(frame)


# --------------------------------------------------------------------------
# socket framing (asyncio server side, blocking client side — one codec)
# --------------------------------------------------------------------------

async def read_frame_async(reader: asyncio.StreamReader
                           ) -> Tuple[str, object]:
    try:
        hdr = await reader.readexactly(_HEADER.size)
        _, _, body_len = _HEADER.unpack(hdr)
        if body_len > MAX_FRAME_BODY:
            raise TransportError(f"frame body length {body_len} exceeds cap")
        rest = await reader.readexactly(body_len + _CRC.size)
    except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
        raise ReplicaGone(f"peer closed mid-frame: {e}")
    return decode_frame(hdr + rest)


async def write_frame_async(writer: asyncio.StreamWriter, kind: str,
                            obj) -> int:
    frame = encode_frame(kind, obj)
    try:
        writer.write(frame)
        await writer.drain()
    except (ConnectionError, OSError) as e:
        raise ReplicaGone(f"peer closed mid-write: {e}")
    return len(frame)


class SocketChannel:
    """Blocking request/response client over one TCP connection, sharing
    the frame codec with the asyncio host side."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
        except OSError as e:
            raise ReplicaGone(f"connect {host}:{port} failed: {e}")
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sent_frames = 0
        self.sent_bytes = 0

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            try:
                chunk = self.sock.recv(min(n, 1 << 20))
            except OSError as e:
                raise ReplicaGone(f"recv failed: {e}")
            if not chunk:
                raise ReplicaGone("peer closed mid-frame")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def send(self, kind: str, obj) -> int:
        frame = encode_frame(kind, obj)
        try:
            self.sock.sendall(frame)
        except OSError as e:
            raise ReplicaGone(f"send failed: {e}")
        self.sent_frames += 1
        self.sent_bytes += len(frame)
        return len(frame)

    def recv(self) -> Tuple[str, object]:
        hdr = self._recv_exact(_HEADER.size)
        _, _, body_len = _HEADER.unpack(hdr)
        if body_len > MAX_FRAME_BODY:
            raise TransportError(f"frame body length {body_len} exceeds cap")
        rest = self._recv_exact(body_len + _CRC.size)
        return decode_frame(hdr + rest)

    def request(self, kind: str, obj) -> object:
        """One RPC: send a command frame, wait for its ``re:`` reply."""
        self.send(kind, obj)
        rkind, reply = self.recv()
        if rkind == "error":
            raise TransportError(f"host error for {kind!r}: {reply}")
        if rkind != f"re:{kind}":
            raise TransportError(f"reply kind skew: sent {kind!r}, "
                                 f"got {rkind!r}")
        return reply

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# EngineHost: one Engine served behind the command protocol
# --------------------------------------------------------------------------

class EngineHost:
    """Asyncio socket server wrapping ONE engine replica.  Commands are
    synchronous at the engine (steps are atomic); the host handles one
    frame at a time per connection, so the frontend's RPC order IS the
    engine's event order, and the virtual-clock twin's determinism carries
    over to real sockets.

    ``die_after`` arms a fault-injection kill switch: the process exits
    hard (``os._exit``) after N more engine steps, BEFORE replying — the
    frontend observes the death as ``ReplicaGone`` on that very RPC, the
    way a crashed machine would present."""

    def __init__(self, engine: Engine, name: str = "host"):
        self.engine = engine
        self.name = name
        self._reqs: Dict[int, Request] = {}
        self._emitted: Dict[int, int] = {}
        self._reported_done: set = set()
        self._die_after: Optional[int] = None
        self._steps = 0

    # ---- command handlers (sync) --------------------------------------
    def handle(self, kind: str, body) -> dict:
        fn = getattr(self, f"_cmd_{kind}", None)
        if fn is None:
            raise TransportError(f"unknown command {kind!r}")
        return fn(body or {})

    def _cmd_hello(self, body) -> dict:
        eng = self.engine
        return {"name": self.name, "paged": bool(eng.paged),
                "block_size": int(eng.scfg.block_size),
                "max_batch": int(eng.scfg.max_batch),
                "max_len": int(eng.scfg.max_len)}

    def _track(self, req: Request) -> None:
        self._reqs[req.rid] = req
        self._emitted[req.rid] = len(req.output)

    def _cmd_submit(self, body) -> dict:
        req = request_from_wire(body["req"])
        self.engine.add_request(req)
        self._track(req)
        return {"ok": True}

    def _cmd_adopt(self, body) -> dict:
        req = request_from_wire(body["req"])
        ok = self.engine.adopt_request(req, int(body["n_tokens"]),
                                       body["payload"])
        if ok:
            self._track(req)
        return {"ok": bool(ok)}

    def _cmd_abort(self, body) -> dict:
        req = self._reqs.get(int(body["rid"]))
        if req is None:
            return {"ok": False}
        ok = self.engine.abort(req, body.get("reason", "cancelled"))
        self._reported_done.add(req.rid)
        return {"ok": bool(ok)}

    def _cmd_step(self, body) -> dict:
        eng = self.engine
        before = eng.stats.forward_tokens
        progressed = eng.step()
        if progressed:
            self._steps += 1
            if self._die_after is not None and self._steps >= self._die_after:
                # crash BEFORE replying: the frontend sees ReplicaGone on
                # this RPC — the real-socket twin of kill_replica()
                os._exit(17)
        emitted = {}
        finished = []
        for rid, req in self._reqs.items():
            seen = self._emitted[rid]
            if len(req.output) > seen:
                emitted[str(rid)] = [int(t) for t in req.output[seen:]]
                self._emitted[rid] = len(req.output)
            if req.state == State.DONE and rid not in self._reported_done:
                self._reported_done.add(rid)
                finished.append({"rid": rid,
                                 "finish_reason": req.finish_reason})
        handoffs = []
        for h in eng.take_handoffs():
            handoffs.append(handoff_to_wire(h))
            self._reqs.pop(h.req.rid, None)
            self._emitted.pop(h.req.rid, None)
        st = eng.stats
        return {"progressed": bool(progressed),
                "d_tokens": int(st.forward_tokens - before),
                "emitted": emitted, "finished": finished,
                "handoffs": handoffs,
                "counters": {"steps": st.steps, "forwards": st.forwards,
                             "weave_forwards": st.weave_forwards,
                             "forward_tokens": st.forward_tokens,
                             "completed": st.completed,
                             "cancelled": st.cancelled}}

    def _cmd_prefix_hits(self, body) -> dict:
        mgr = self.engine.block_mgr
        if mgr is None or not mgr.prefix_caching:
            return {"hits": 0}
        return {"hits": len(mgr.prefix.match(list(body["hashes"])))}

    def _cmd_quiesce(self, body) -> dict:
        mgr = self.engine.block_mgr
        if mgr is None:
            return {"tables": [], "leaked": []}
        leaked = [b for b in range(mgr.alloc.num_blocks) if mgr.alloc.ref[b]]
        return {"tables": sorted(mgr.tables), "leaked": leaked}

    def _cmd_die_after(self, body) -> dict:
        self._die_after = self._steps + int(body["steps"])
        return {"ok": True}

    def _cmd_shutdown(self, body) -> dict:
        return {"ok": True, "_shutdown": True}

    # ---- asyncio server ------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    kind, body = await read_frame_async(reader)
                except ReplicaGone:
                    break
                try:
                    reply = self.handle(kind, body)
                except (TransportError, ValueError, KeyError) as e:
                    await write_frame_async(writer, "error", str(e))
                    continue
                await write_frame_async(writer, f"re:{kind}", reply)
                if reply.get("_shutdown"):
                    asyncio.get_running_loop().call_soon(
                        self._server.close)
                    break
        finally:
            try:
                writer.close()
            except OSError:
                pass

    async def serve(self, host: str = "127.0.0.1", port: int = 0,
                    on_ready=None) -> None:
        self._server = await asyncio.start_server(self._handle_conn,
                                                  host, port)
        bound = self._server.sockets[0].getsockname()
        if on_ready is not None:
            on_ready(bound[0], bound[1])
        try:
            async with self._server:
                await self._server.serve_forever()
        except asyncio.CancelledError:
            pass


# --------------------------------------------------------------------------
# RemoteEngine: the frontend-side proxy a Replica drives like an Engine
# --------------------------------------------------------------------------

class _RemoteSched:
    """Client-side mirror of the remote scheduler: ``waiting`` holds every
    request the remote engine currently owns (the frontend keeps the
    authoritative Request objects), ``finished`` the terminal ones —
    exactly the surface ``Replica``/``ClusterServer`` read."""

    def __init__(self):
        self.waiting: List[Request] = []
        self.active: List[Optional[Request]] = []
        self.finished: List[Request] = []


class _RemoteStats:
    """Counters mirrored from the host's step replies (read-only view,
    same attribute names as ``EngineStats``)."""

    def __init__(self):
        self.steps = 0
        self.forwards = 0
        self.weave_forwards = 0
        self.forward_tokens = 0
        self.completed = 0
        self.cancelled = 0

    @property
    def weave_rate(self) -> float:
        return self.weave_forwards / self.forwards if self.forwards else 0.0

    @property
    def tokens_per_forward(self) -> float:
        return self.forward_tokens / self.forwards if self.forwards else 0.0


class RemoteEngine:
    """Engine proxy over a ``SocketChannel``: the subset of the ``Engine``
    surface that ``Replica`` and ``ClusterServer`` touch (add_request /
    step / take_handoffs / adopt_request / abort / sched / stats / paged /
    obs), so a remote replica is just ``Replica(name, RemoteEngine(host,
    port))``.

    Any socket failure marks the proxy dead and raises ``ReplicaGone``;
    the cluster's failure handling requeues this replica's requests from
    the client-side mirrors (``evacuate``, no RPC: the machine is gone)."""

    block_mgr = None        # pool lives host-side; prefix hits go via RPC
    obs = None
    obs_track = "remote"

    def __init__(self, host: str, port: int, name: str = "remote",
                 timeout: float = 120.0):
        self.chan = SocketChannel(host, port, timeout=timeout)
        self.name = name
        self.dead = False
        self.sched = _RemoteSched()
        self.stats = _RemoteStats()
        self._handoffs: List[Handoff] = []
        hello = self._rpc("hello", {})
        self.paged = bool(hello["paged"])
        self.remote_name = hello["name"]
        self.block_size = int(hello["block_size"])

    def _rpc(self, kind: str, body) -> dict:
        if self.dead:
            raise ReplicaGone(f"replica {self.name!r} is dead")
        try:
            return self.chan.request(kind, body)
        except ReplicaGone:
            self.dead = True
            raise

    def _mirror(self, rid: int) -> Optional[Request]:
        for r in self.sched.waiting:
            if r.rid == rid:
                return r
        return None

    # ---- Engine surface ------------------------------------------------
    def add_request(self, req: Request) -> None:
        self._rpc("submit", {"req": request_to_wire(req)})
        self.sched.waiting.append(req)

    def adopt_request(self, req: Request, n_tokens: int, payload) -> bool:
        ok = self._rpc("adopt", {"req": request_to_wire(req),
                                 "n_tokens": int(n_tokens),
                                 "payload": payload})["ok"]
        if ok:
            req.handoff_after_prefill = False
            req.migrations += 1
            self.sched.waiting.append(req)
        return bool(ok)

    def abort(self, req: Request, reason: str = "cancelled") -> bool:
        ok = self._rpc("abort", {"rid": int(req.rid), "reason": reason})
        self.sched.waiting = [r for r in self.sched.waiting if r is not req]
        req.state = State.DONE
        req.finish_reason = reason
        return bool(ok["ok"])

    def step(self) -> bool:
        reply = self._rpc("step", {})
        for rid_s, toks in reply["emitted"].items():
            req = self._mirror(int(rid_s))
            if req is not None:
                req.output.extend(int(t) for t in toks)
                if req.state == State.WAITING:
                    req.state = State.DECODE
        for h in reply["handoffs"]:
            wire_req = request_from_wire(h["req"])
            req = self._mirror(wire_req.rid)
            if req is None:
                req = wire_req
            else:
                # the host parked it: sync generation state onto the
                # frontend's authoritative object, drop local ownership
                req.output = wire_req.output
                req.state = wire_req.state
                req.prefill_pos = wire_req.prefill_pos
                self.sched.waiting = [r for r in self.sched.waiting
                                      if r is not req]
            self._handoffs.append(Handoff(req=req,
                                          n_tokens=int(h["n_tokens"]),
                                          payload=h["payload"]))
        for fin in reply["finished"]:
            req = self._mirror(int(fin["rid"]))
            if req is not None:
                req.state = State.DONE
                req.finish_reason = fin["finish_reason"]
                self.sched.waiting = [r for r in self.sched.waiting
                                      if r is not req]
                if req.finish_reason == "stop":
                    self.sched.finished.append(req)
        c = reply["counters"]
        st = self.stats
        st.steps, st.forwards = c["steps"], c["forwards"]
        st.weave_forwards = c["weave_forwards"]
        st.forward_tokens = c["forward_tokens"]
        st.completed, st.cancelled = c["completed"], c["cancelled"]
        return bool(reply["progressed"])

    def take_handoffs(self) -> List[Handoff]:
        out, self._handoffs = self._handoffs, []
        return out

    def prefix_hit_blocks(self, hashes) -> int:
        return int(self._rpc("prefix_hits",
                             {"hashes": [int(h) for h in hashes]})["hits"])

    def install_overlap_policy(self, policy) -> None:
        # remote hosts load their plan from their own spec at launch; the
        # frontend cannot ship a live policy object over the wire
        raise ValueError("install_overlap_policy is not supported on "
                         "RemoteEngine — pass plan_path in the host spec")

    def evacuate(self) -> List[Request]:
        """Dead-replica recovery (no RPC — the peer is gone): hand every
        live mirrored request back, reset for re-admission elsewhere."""
        self.dead = True
        out = [reset_for_requeue(r) for r in self.sched.waiting
               if r.state != State.DONE]
        self.sched.waiting = []
        self._handoffs = []
        return out

    def check_quiescent(self) -> None:
        if self.dead:
            return
        rep = self._rpc("quiesce", {})
        assert not rep["tables"], (self.name, rep["tables"])
        assert not rep["leaked"], (self.name, rep["leaked"])

    def die_after(self, steps: int) -> None:
        """Arm the host's fault-injection kill switch (tests)."""
        self._rpc("die_after", {"steps": int(steps)})

    def close(self) -> None:
        if not self.dead:
            try:
                self.chan.send("shutdown", {})
            except ReplicaGone:
                pass
        self.chan.close()


# --------------------------------------------------------------------------
# worker process entry (multi-process launch mode)
# --------------------------------------------------------------------------

DEFAULT_SPEC = {
    "model": {"name": "tiny", "family": "dense", "num_layers": 2,
              "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
              "head_dim": 16, "d_ff": 128, "vocab_size": 128,
              "dtype": "float32"},
    "parallel": {"tokenweave": True, "comm_mode": "fused", "remat": False,
                 "split_unit": 16, "tokenweave_min_tokens": 32},
    "scheduler": {"max_batch": 4, "chunk_tokens": 48, "max_len": 96,
                  "prefill_bucket": 16, "paged": True, "block_size": 8},
    "seed": 0,
}


def build_engine_from_spec(spec: Optional[dict] = None) -> Engine:
    """Build a single-host engine from a JSON-able spec (section-wise
    merged over ``DEFAULT_SPEC``), shared by ``__main__`` here and the HTTP
    API server (runtime/http_api.py).  The weights come from the port's
    ``api.init`` with seed 0 and the engine's draws from ``spec["seed"]``;
    the engine runs on ``spec["device"]``, CUDA unless it says ``"cpu"``,
    and raises with no CUDA device and no ``"device"``."""
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.device import resolve_device
    from repro_torch.models.build import build_model
    from repro_torch.runtime.scheduler import SchedulerConfig

    spec = spec or {}
    device = resolve_device(spec.get("device"))
    merged = {sec: {**DEFAULT_SPEC[sec], **spec.get(sec, {})}
              for sec in ("model", "parallel", "scheduler")}
    cfg = ModelConfig(**merged["model"])
    pcfg = ParallelConfig(**merged["parallel"])
    api = build_model(cfg, pcfg, tp=1)
    params = api.init(0, device=device)
    return Engine(api, params, SchedulerConfig(**merged["scheduler"]),
                  seed=int(spec.get("seed", DEFAULT_SPEC["seed"])),
                  device=device)


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.runtime.transport --port 0 [--spec JSON]`` —
    host one engine replica on a socket.  Prints ``LISTENING <host>
    <port>`` once bound (the launch harness parses it)."""
    import argparse
    import json

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--name", default="host")
    p.add_argument("--spec", default="{}",
                   help="JSON engine spec merged over DEFAULT_SPEC")
    args = p.parse_args(argv)

    engine = build_engine_from_spec(json.loads(args.spec))
    host = EngineHost(engine, name=args.name)

    def ready(h, prt):
        print(f"LISTENING {h} {prt}", flush=True)

    asyncio.run(host.serve(args.host, args.port, on_ready=ready))


if __name__ == "__main__":
    main()
