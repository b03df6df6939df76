"""The PyTorch port's serving processes on the CPU: the streaming HTTP API
(``python -m repro_torch.runtime.http_api``) and a socket replica
(``python -m repro_torch.runtime.transport``), each spawned with
``--spec '{"device": "cpu"}'`` (with no device they go to CUDA).

* HTTP (the end-to-end tests of tests/test_server.py): health, an SSE
  stream, a non-streamed completion and a websocket stream give the
  tokens of the port's offline engine built from the same spec; a bad
  request is refused; a client that walks away mid-stream cancels its
  request and the pool sweeps clean.
* Sockets (tests/test_cluster.py's socket cluster): a remote replica
  beside a local one, the remote hard-killed (``die_after``) a few steps
  in: its requests are requeued onto the local replica and every output
  equals a single engine's; and a disaggregated pair, a remote prefill
  replica whose KV handoffs cross the socket to a local decode replica.

The servers run with ``src`` as their working directory and no
PYTHONPATH, so the repository's ``sitecustomize`` (which loads JAX) stays
out of them.  Every spawned process has a timeout and is killed in a
``finally``.
"""
import base64
import http.client
import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.runtime import cluster as TCL
from repro_torch.runtime import transport as TTR
from repro_torch.runtime.requests import Request

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU = {"device": "cpu"}
TIMEOUT = 60


def _spawn(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0", "--spec",
         json.dumps(CPU), *args], cwd=SRC, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], TIMEOUT)
        line = proc.stdout.readline() if ready else ""
        if not line.startswith("LISTENING"):
            proc.kill()
            raise AssertionError((line, proc.stderr.read()[-2000:]))
    except BaseException:
        _stop(proc)
        raise
    _, host, port = line.split()
    return proc, host, int(port)


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=TIMEOUT)
    proc.stdout.close()
    proc.stderr.close()


def _offline(prompts, outs, spec=CPU):
    eng = TTR.build_engine_from_spec(spec)
    for i, (p, n) in enumerate(zip(prompts, outs)):
        eng.add_request(Request(rid=i, prompt=list(p), max_new_tokens=n))
    return {r.rid: list(r.output) for r in eng.run()}


# --------------------------------------------------------------------------
# HTTP / SSE / websocket client helpers (tests/test_server.py's)
# --------------------------------------------------------------------------

def _http_json(host, port, method, path, body=None):
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    try:
        payload = json.dumps(body) if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"}
                     if payload else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode("utf-8"))
    finally:
        conn.close()


def _open_stream(host, port, body):
    """POST a streaming completion over a raw socket; return (sock, file)
    positioned after the response headers."""
    payload = json.dumps(body).encode("utf-8")
    s = socket.create_connection((host, port), timeout=TIMEOUT)
    s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(payload)}\r\n\r\n").encode("ascii")
              + payload)
    f = s.makefile("rb")
    status = f.readline()
    assert b"200" in status, status
    while f.readline() not in (b"\r\n", b"\n", b""):
        pass
    return s, f


def _sse_events(f):
    while True:
        line = f.readline()
        if not line:
            return
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data == b"[DONE]":
            return
        yield json.loads(data.decode("utf-8"))


def _read_ws_frame(f):
    head = f.read(2)
    assert len(head) == 2
    opcode = head[0] & 0x0F
    n = head[1] & 0x7F
    if n == 126:
        n = int.from_bytes(f.read(2), "big")
    elif n == 127:
        n = int.from_bytes(f.read(8), "big")
    return opcode, f.read(n)


def _ws_collect(host, port, body):
    """Minimal RFC6455 client: upgrade, one masked text frame, then the
    server's frames until the done event or the close frame."""
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    s = socket.create_connection((host, port), timeout=TIMEOUT)
    try:
        s.sendall((f"GET /v1/stream HTTP/1.1\r\nHost: t\r\n"
                   f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n"
                   f"Sec-WebSocket-Version: 13\r\n\r\n").encode("ascii"))
        f = s.makefile("rb")
        assert b"101" in f.readline()
        while f.readline() not in (b"\r\n", b"\n", b""):
            pass
        payload = json.dumps(body).encode("utf-8")
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + masked)
        toks = []
        while True:
            opcode, data = _read_ws_frame(f)
            if opcode == 0x8:
                break
            ev = json.loads(data.decode("utf-8"))
            if "token" in ev:
                toks.append(ev["token"])
            if ev.get("done"):
                break
        f.close()
        return toks
    finally:
        s.close()


def test_http_api_streams_the_offline_tokens_and_sweeps_on_disconnect():
    rng = np.random.RandomState(17)
    prompts = [[int(t) for t in rng.randint(0, 128, size=rng.randint(8, 24))]
               for _ in range(3)]
    outs = [6, 4, 8]
    ref = _offline(prompts, outs)

    proc, host, port = _spawn("repro_torch.runtime.http_api",
                              "--step-delay", "0.02")
    try:
        status, health = _http_json(host, port, "GET", "/v1/health")
        assert status == 200 and health["ok"]

        # rid 0: SSE, one event per token, in order
        s, f = _open_stream(host, port, {"prompt": prompts[0],
                                         "max_new_tokens": outs[0],
                                         "stream": True})
        events = list(_sse_events(f))
        f.close()
        s.close()
        assert [e["token"] for e in events if "token" in e] == ref[0]
        assert events[-1].get("done") and events[-1]["finish_reason"]

        # rid 1: one JSON body after completion
        status, body = _http_json(host, port, "POST", "/v1/completions",
                                  {"prompt": prompts[1],
                                   "max_new_tokens": outs[1]})
        assert status == 200 and body["tokens"] == ref[1]

        # rid 2: websocket, one text frame per token event
        assert _ws_collect(host, port, {"prompt": prompts[2],
                                        "max_new_tokens": outs[2]}) == ref[2]

        status, err = _http_json(host, port, "POST", "/v1/completions",
                                 {"prompt": "not a token list"})
        assert status == 400 and "prompt" in err["error"]
        _, stats = _http_json(host, port, "GET", "/v1/stats")
        assert stats["completed"] == 3 and stats["live_streams"] == 0
        assert stats["tables"] == 0 and stats["leaked_blocks"] == 0

        # walk away after 2 of 64 tokens: EOF -> cancel -> abort
        s, f = _open_stream(host, port, {"prompt": prompts[0],
                                         "max_new_tokens": 64,
                                         "stream": True})
        seen = 0
        for ev in _sse_events(f):
            seen += "token" in ev
            if seen >= 2:
                break
        s.shutdown(socket.SHUT_RDWR)   # makefile's duplicate keeps it open
        f.close()
        s.close()
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            _, stats = _http_json(host, port, "GET", "/v1/stats")
            if stats["cancelled"] >= 1 and stats["live_streams"] == 0:
                break
            time.sleep(0.05)
        assert stats["cancelled"] == 1 and stats["live_streams"] == 0
        assert stats["tables"] == 0 and stats["leaked_blocks"] == 0
        assert stats["completed"] == 3
    finally:
        _stop(proc)


# --------------------------------------------------------------------------
# socket replicas
# --------------------------------------------------------------------------

def _trace(n=6, seed=3, out=4, rate=0.5):
    from repro_torch.runtime.requests import poisson_arrivals
    rng = np.random.RandomState(seed)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.randint(
        0, 128, size=rng.randint(10, 30))], max_new_tokens=out)
        for i in range(n)]
    return poisson_arrivals(reqs, rate=rate, seed=seed)


@pytest.mark.parametrize("mode", ["kill", "disagg"])
def test_socket_replica_beside_a_local_one(mode):
    """``kill``: the remote replica dies after 4 steps (``os._exit(17)``
    before its reply); the frontend sees ``ReplicaGone``, detects, and
    requeues onto the local replica.  ``disagg``: the remote replica
    prefills, the local one decodes from the KV the socket carried."""
    trace = _trace()
    ref = _offline([r.prompt for r in trace],
                   [r.max_new_tokens for r in trace])
    proc, host, port = _spawn("repro_torch.runtime.transport",
                              "--name", "w0")
    remote = None
    try:
        remote = TTR.RemoteEngine(host, port, name="w0", timeout=TIMEOUT)
        roles = ("prefill", "decode") if mode == "disagg" else \
            ("mixed", "mixed")
        reps = [TCL.Replica("r0", remote, role=roles[0]),
                TCL.Replica("r1", TTR.build_engine_from_spec(CPU),
                            role=roles[1])]
        cs = TCL.ClusterServer(reps, TCL.ClusterConfig(router="round_robin"))
        for r in trace:
            cs.submit(r)
        if mode == "kill":
            remote.die_after(4)
        done = cs.run()
        assert {r.rid: r.output for r in done} == ref
        cs.check_quiescent()        # the local pool, and the remote's by RPC
        if mode == "kill":
            assert cs.stats.replica_deaths == 1 and cs.stats.requeued >= 1
            assert any(r.requeues == 1 for r in done)
            assert not reps[0].alive and reps[1].alive
            assert proc.wait(timeout=TIMEOUT) == 17
        else:
            assert cs.summary()["migrations"] == len(trace)
            assert all(r.migrations == 1 for r in done)
            st = reps[1].engine.block_mgr.stats
            assert st.migrations_in == len(trace)
    finally:
        if remote is not None:
            remote.close()
        _stop(proc)


@pytest.mark.parametrize("module", ["repro_torch.runtime.http_api",
                                    "repro_torch.runtime.transport"])
def test_server_mains_without_a_device_need_cuda(module):
    """With no ``"device"`` in the spec the servers build on CUDA; with no
    CUDA device (hidden here too) they exit with the reason, never
    serving on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", module, "--port", "0"],
                          cwd=SRC, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode != 0 and "LISTENING" not in proc.stdout
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
