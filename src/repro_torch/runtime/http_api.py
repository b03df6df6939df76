"""OpenAI-style streaming API over ``OnlineServer``, as
``repro.runtime.http_api``.

A stdlib-only asyncio frontend that turns the deterministic serving loop
into a live network service:

* ``POST /v1/completions`` — submit a prompt; ``"stream": true`` answers
  with server-sent events (one ``data:`` line per token as the engine
  commits it, terminated by ``data: [DONE]``), otherwise a single JSON
  body once the request finishes.
* ``GET /v1/stream`` — the same token feed over a minimal RFC6455
  websocket (one JSON text frame per token event).
* ``GET /v1/health`` / ``GET /v1/stats`` — liveness and the counters the
  end-to-end tests poll (completed / cancelled / block-pool quiescence).

Token events ride the ``on_token`` callbacks ``OnlineServer.pump``
already fires: the pump task interleaves single engine steps with the
event loop, so streaming writes happen between steps and every
connection sees tokens in commit order.  A client disconnect (EOF on the
connection) cancels its request through ``OnlineServer.cancel`` →
``Engine.abort``, releasing the slot and paged blocks.

Everything engine-side stays virtual-time deterministic: wall time only
decides WHEN the pump runs, never what any step computes, so streamed
tokens are identical to the offline engine on the same prompts.
``python -m repro_torch.runtime.http_api`` serves on CUDA unless its spec
says ``"device": "cpu"``.
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import itertools
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.requests import Request, State
from repro_torch.runtime.server import OnlineServer, ServerConfig

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def ws_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked (server->client) websocket frame, FIN set."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + n.to_bytes(2, "big")
    else:
        head += bytes([127]) + n.to_bytes(8, "big")
    return head + payload


async def ws_read(reader: asyncio.StreamReader) -> Tuple[int, bytes]:
    """Read one frame; client->server frames are masked per RFC6455."""
    head = await reader.readexactly(2)
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    n = head[1] & 0x7F
    if n == 126:
        n = int.from_bytes(await reader.readexactly(2), "big")
    elif n == 127:
        n = int.from_bytes(await reader.readexactly(8), "big")
    mask = await reader.readexactly(4) if masked else b""
    payload = await reader.readexactly(n)
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class ApiServer:
    """One engine, one event loop: HTTP/websocket handlers and the pump
    task share the loop thread, so no locking guards the engine — handler
    code runs only between pump iterations (engine steps are atomic).

    ``step_delay`` (wall seconds slept after each engine step) paces the
    pump so tests can connect, observe partial streams, and disconnect
    mid-generation deterministically-enough; 0 serves at full speed."""

    def __init__(self, engine, cfg: Optional[ServerConfig] = None,
                 step_delay: float = 0.0):
        self.engine = engine
        self.srv = OnlineServer(engine, cfg)
        self.step_delay = step_delay
        self._rids = itertools.count()
        self._live: Dict[int, asyncio.Queue] = {}   # rid -> event queue
        self._server: Optional[asyncio.base_events.Server] = None

    # ------------------------------------------------------------------
    # pump task: the serving loop, one step per loop visit
    # ------------------------------------------------------------------
    def _on_token(self, rid: int):
        def cb(req: Request, tok: int, t: float) -> None:
            q = self._live.get(rid)
            if q is not None:
                q.put_nowait(("token", int(tok), float(t)))
        return cb

    def _notify_done(self) -> None:
        for rid in list(self._live):
            req = self.srv._by_rid.get(rid)
            if req is not None and req.state == State.DONE:
                self._live[rid].put_nowait(
                    ("done", req.finish_reason or "stop", self.srv.clock))
                del self._live[rid]

    async def _pump_loop(self) -> None:
        while True:
            stepped = self.srv.pump(max_steps=1)
            self._notify_done()
            # yield to connection handlers; idle-poll a little slower
            await asyncio.sleep(self.step_delay if stepped
                                else max(self.step_delay, 0.002))

    # ------------------------------------------------------------------
    # request admission / teardown (handlers call these between pumps)
    # ------------------------------------------------------------------
    def _submit(self, body: dict) -> Tuple[Request, asyncio.Queue]:
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of ints")
        max_new = int(body.get("max_new_tokens", 16))
        req = Request(rid=next(self._rids), prompt=list(prompt),
                      max_new_tokens=max_new,
                      arrival_time=self.srv.clock)
        if body.get("deadline") is not None:
            req.deadline = float(body["deadline"])
        q: asyncio.Queue = asyncio.Queue()
        self.srv.submit(req, on_token=self._on_token(req.rid))
        self._live[req.rid] = q
        return req, q

    def _disconnect(self, req: Request) -> None:
        """Client went away mid-stream: abort the request (releasing its
        slot and paged blocks) unless it already finished."""
        self._live.pop(req.rid, None)
        if req.state != State.DONE:
            self.srv.cancel(req.rid)

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    async def _read_request(self, reader) -> Optional[Tuple[str, str, dict,
                                                            bytes]]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode("ascii").split(None, 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, val = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = val.strip()
        body = b""
        n = int(headers.get("content-length", 0) or 0)
        if n:
            body = await reader.readexactly(n)
        return method, path, headers, body

    @staticmethod
    def _http(status: str, ctype: str, payload: bytes,
              extra: str = "") -> bytes:
        return (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n{extra}"
                f"Connection: close\r\n\r\n").encode("ascii") + payload

    def _json(self, obj, status: str = "200 OK") -> bytes:
        return self._http(status, "application/json",
                          json.dumps(obj).encode("utf-8"))

    def _stats(self) -> dict:
        eng = self.engine
        mgr = eng.block_mgr
        leaked = ([b for b in range(mgr.alloc.num_blocks) if mgr.alloc.ref[b]]
                  if mgr is not None else [])
        return {"clock": self.srv.clock,
                "submitted": len(self.srv.requests),
                "completed": len(self.srv.completed),
                "aborted": len(self.srv.aborted),
                "cancelled": int(eng.stats.cancelled),
                "live_streams": len(self._live),
                "tables": (len(mgr.tables) if mgr is not None else 0),
                "leaked_blocks": len(leaked)}

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------
    async def _stream_events(self, reader, writer, req: Request,
                             q: asyncio.Queue, send) -> None:
        """Drain the request's event queue through ``send`` (SSE or
        websocket framing), racing against connection EOF; EOF or a write
        failure cancels the request."""
        eof = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                get = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {get, eof}, return_when=asyncio.FIRST_COMPLETED)
                if eof in done:
                    get.cancel()
                    self._disconnect(req)
                    return
                ev = get.result()
                try:
                    await send(ev)
                except (ConnectionError, OSError):
                    self._disconnect(req)
                    return
                if ev[0] == "done":
                    return
        finally:
            if not eof.done():
                eof.cancel()

    async def _handle_completions(self, reader, writer, body: bytes) -> None:
        try:
            obj = json.loads(body.decode("utf-8"))
            req, q = self._submit(obj)
        except (ValueError, KeyError) as e:
            writer.write(self._json({"error": str(e)}, "400 Bad Request"))
            await writer.drain()
            return
        if not obj.get("stream"):
            # block until the pump finishes the request, then answer once
            while True:
                ev = await q.get()
                if ev[0] == "done":
                    break
            writer.write(self._json(
                {"rid": req.rid, "tokens": list(req.output),
                 "finish_reason": req.finish_reason,
                 "ttft": req.ttft, "e2e": req.e2e_latency}))
            await writer.drain()
            return
        writer.write(("HTTP/1.1 200 OK\r\n"
                      "Content-Type: text/event-stream\r\n"
                      "Cache-Control: no-cache\r\n"
                      "Connection: close\r\n\r\n").encode("ascii"))
        await writer.drain()

        async def send(ev):
            if ev[0] == "token":
                data = json.dumps({"rid": req.rid, "token": ev[1],
                                   "t": ev[2]})
            else:
                data = json.dumps({"rid": req.rid, "done": True,
                                   "finish_reason": ev[1]})
            writer.write(f"data: {data}\n\n".encode("utf-8"))
            if ev[0] == "done":
                writer.write(b"data: [DONE]\n\n")
            await writer.drain()

        await self._stream_events(reader, writer, req, q, send)

    async def _handle_websocket(self, reader, writer,
                                headers: Dict[str, str]) -> None:
        key = headers.get("sec-websocket-key", "")
        writer.write((f"HTTP/1.1 101 Switching Protocols\r\n"
                      f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Accept: {_ws_accept(key)}\r\n\r\n"
                      ).encode("ascii"))
        await writer.drain()
        try:
            opcode, payload = await ws_read(reader)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return
        if opcode != 0x1:          # expect one text frame with the request
            writer.write(ws_frame(0x8, b""))
            await writer.drain()
            return
        try:
            req, q = self._submit(json.loads(payload.decode("utf-8")))
        except (ValueError, KeyError) as e:
            writer.write(ws_frame(
                0x1, json.dumps({"error": str(e)}).encode("utf-8")))
            writer.write(ws_frame(0x8, b""))
            await writer.drain()
            return

        async def send(ev):
            if ev[0] == "token":
                data = {"rid": req.rid, "token": ev[1], "t": ev[2]}
            else:
                data = {"rid": req.rid, "done": True,
                        "finish_reason": ev[1]}
            writer.write(ws_frame(0x1, json.dumps(data).encode("utf-8")))
            if ev[0] == "done":
                writer.write(ws_frame(0x8, b""))
            await writer.drain()

        await self._stream_events(reader, writer, req, q, send)

    async def _handle_conn(self, reader, writer) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, headers, body = parsed
            if (method, path) == ("POST", "/v1/completions"):
                await self._handle_completions(reader, writer, body)
            elif (method, path) == ("GET", "/v1/stream") and \
                    "websocket" in headers.get("upgrade", "").lower():
                await self._handle_websocket(reader, writer, headers)
            elif (method, path) == ("GET", "/v1/health"):
                writer.write(self._json({"ok": True,
                                         "clock": self.srv.clock}))
                await writer.drain()
            elif (method, path) == ("GET", "/v1/stats"):
                writer.write(self._json(self._stats()))
                await writer.drain()
            else:
                writer.write(self._json({"error": f"no route "
                                         f"{method} {path}"},
                                        "404 Not Found"))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    # ------------------------------------------------------------------
    async def serve(self, host: str = "127.0.0.1", port: int = 0,
                    on_ready=None) -> None:
        pump = asyncio.ensure_future(self._pump_loop())
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
        finally:
            pump.cancel()


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.runtime.http_api --port 0 [--spec JSON]`` —
    serve one engine over the streaming API.  Prints ``LISTENING <host>
    <port>`` once bound (the e2e test harness parses it)."""
    import argparse

    from repro_torch.runtime.transport import build_engine_from_spec

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--spec", default="{}",
                   help="JSON engine spec merged over transport.DEFAULT_SPEC")
    p.add_argument("--step-delay", type=float, default=0.0,
                   help="wall seconds slept after each engine step (lets "
                        "tests observe and interrupt partial streams)")
    args = p.parse_args(argv)

    api = ApiServer(build_engine_from_spec(json.loads(args.spec)),
                    step_delay=args.step_delay)

    def ready(h, prt):
        print(f"LISTENING {h} {prt}", flush=True)

    asyncio.run(api.serve(args.host, args.port, on_ready=ready))


if __name__ == "__main__":
    main()
