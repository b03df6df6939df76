"""The PyTorch port's wire codec (``repro_torch.runtime.transport``)
against the JAX reference's, on the CPU.

The cases of tests/test_transport.py run against the port's codec: the
dtype × shape grid plus bf16 tensors, scalars and containers, payload
trees in both forms, every truncation, every single-byte corruption,
trailing garbage, version skew, bad magic, hostile lengths, the request
and handoff envelopes, the loopback transport's accounting, the socket
channel (asyncio host side, blocking client) and a connect to nowhere.
Every array the port decodes is a CPU ``torch.Tensor``.

Across packages: for the same value the port writes the reference's
frame, byte for byte (numpy arrays, and tensors of a numpy dtype); a port
bf16 frame decodes in the reference to an ml_dtypes bfloat16 array with
the same bytes; a reference frame of an ml_dtypes bfloat16 array (its
dtype written ``'<V2'``) decodes in the port to a bf16 tensor with the
same bytes.
"""
import itertools
import struct
import threading
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime import transport as JTR

from repro_torch.runtime import transport as TTR
from repro_torch.runtime.engine import Handoff
from repro_torch.runtime.requests import Request, State

_DTYPES = ("float32", "float16", "float64", "int8", "int32", "int64",
           "uint8", "bool")
_SHAPES = ((), (1,), (3,), (2, 5), (2, 3, 4, 2), (4, 0, 2))


def _np_bytes(x):
    """(dtype name, shape, raw bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), \
                x.contiguous().view(torch.int16).numpy().tobytes()
        x = x.contiguous().numpy()
    if x.dtype.str in ("<V2", "|V2") or x.dtype == ml_dtypes.bfloat16:
        return "bfloat16", x.shape, np.ascontiguousarray(x).tobytes()
    return x.dtype.name, x.shape, np.ascontiguousarray(x).tobytes()


def _assert_same(got, want):
    """Structural equality; a decoded tensor holds the bytes, dtype and
    shape of the array or tensor that was sent."""
    if isinstance(want, (np.ndarray, torch.Tensor)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert _np_bytes(got) == _np_bytes(want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for x, y in zip(got, want):
            _assert_same(x, y)
    else:
        assert got == want and type(got) is type(want), (got, want)


def _arr(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == "bool":
        flat = rng.rand(n) > 0.5
    elif np.issubdtype(np.dtype(dtype), np.floating):
        flat = rng.randn(n)
    else:
        info = np.iinfo(dtype)
        flat = rng.randint(info.min, info.max, size=n, dtype=dtype)
    return flat.astype(dtype).reshape(shape)


# --------------------------------------------------------------------------
# round trips, and the reference's bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape",
                         list(itertools.product(_DTYPES, _SHAPES)))
def test_array_roundtrip_bit_identical(dtype, shape):
    arr = _arr(dtype, shape, seed=sum(map(ord, dtype)) + len(shape))
    frame = TTR.encode_frame("blob", arr)
    assert frame == JTR.encode_frame("blob", arr)
    # the same values as a tensor: the same frame
    assert TTR.encode_frame("blob", torch.from_numpy(arr.copy())) == frame
    kind, got = TTR.decode_frame(frame)
    assert kind == "blob"
    _assert_same(got, arr)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5), (4, 0, 2)])
def test_bf16_tensor_roundtrip_and_reference_decode(shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(
        len(shape))).to(torch.bfloat16)
    frame = TTR.encode_frame("kv", {"k": x})
    got = TTR.decode_frame(frame)[1]["k"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)
    # the reference (numpy with ml_dtypes) reads "bfloat16" as bf16
    ref = JTR.decode_frame(frame)[1]["k"]
    assert ref.dtype == ml_dtypes.bfloat16 and ref.shape == shape
    assert ref.tobytes() == _np_bytes(x)[2]


def test_reference_v2_bf16_frame_decodes_to_bf16():
    """The reference writes an ml_dtypes bfloat16 array's dtype as '<V2'
    (``dtype.str``), which its own decoder cannot make a jnp array of;
    the port reads it, and '|V2', as bfloat16."""
    a = np.random.RandomState(0).randn(2, 3, 4).astype(ml_dtypes.bfloat16)
    frame = JTR.encode_frame("kv", {"k": a})
    assert b"<V2" in frame
    assert TTR.encode_frame("kv", {"k": a}) == frame   # numpy: same bytes
    got = TTR.decode_frame(frame)[1]["k"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == a.shape
    assert _np_bytes(got)[2] == a.tobytes()
    body = frame[10:-4].replace(b"<V2", b"|V2")      # header 10, CRC 4
    frame2 = (frame[:10] + body
              + struct.pack("!I", zlib.crc32(body) & 0xFFFFFFFF))
    _assert_same(TTR.decode_frame(frame2)[1]["k"], got)


def test_other_byte_orders_and_dtypes_without_tensor():
    big = np.arange(6, dtype=">f4").reshape(2, 3)
    got = TTR.decode_frame(JTR.encode_frame("x", big))[1]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), big)
    with pytest.raises(TTR.TransportError, match="no tensor type"):
        TTR.decode_frame(JTR.encode_frame("x", np.array(["ab", "c"])))
    with pytest.raises(TypeError, match="cannot encode"):
        TTR.encode_frame("x", torch.zeros(2, dtype=torch.float8_e4m3fn))


def test_scalar_and_container_roundtrip():
    obj = {"none": None, "t": True, "f": False, "i": -17, "big": 1 << 40,
           "d": 3.25, "s": "héllo", "b": b"\x00\xffraw", "empty": [],
           "nested": {"xs": [1, 2.5, "three", None, {"deep": [True]}]}}
    frame = TTR.encode_frame("env", obj)
    assert frame == JTR.encode_frame("env", obj)
    kind, got = TTR.decode_frame(frame)
    assert kind == "env"
    _assert_same(got, obj)


def test_noncontiguous_array_and_tensor_roundtrip():
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    view = base[::2, 1::2]                       # strided, non-contiguous
    frame = TTR.encode_frame("x", view)
    assert frame == JTR.encode_frame("x", view)
    _assert_same(TTR.decode_frame(frame)[1], np.ascontiguousarray(view))
    tview = torch.from_numpy(base)[::2, 1::2]
    assert TTR.encode_frame("x", tview) == frame


def test_stacked_and_per_layer_payload_trees_roundtrip():
    rng = np.random.RandomState(0)
    stacked = {"k": rng.randn(2, 3, 8, 2, 16).astype(np.float32),
               "pos": rng.randint(0, 96, size=(2, 3, 8)).astype(np.int32),
               "v": rng.randn(2, 3, 8, 2, 16).astype(np.float32)}
    per_layer = {f"layer_{i}":
                 {"k": rng.randn(3, 8, 2, 16).astype(np.float16),
                  "pos": rng.randint(0, 96, size=(3, 8)).astype(np.int32),
                  "v": rng.randn(3, 8, 2, 16).astype(np.float16)}
                 for i in range(2)}
    for payload in (stacked, per_layer):
        frame = TTR.encode_frame("handoff", payload)
        assert frame == JTR.encode_frame("handoff", payload)
        _assert_same(TTR.decode_frame(frame)[1], payload)
        # the decoded tensors go out again as the same frame
        assert TTR.encode_frame("handoff",
                                TTR.decode_frame(frame)[1]) == frame


def test_unencodable_values_raise():
    with pytest.raises(TypeError, match="cannot encode"):
        TTR.encode_frame("x", object())
    with pytest.raises(TypeError, match="keys must be str"):
        TTR.encode_frame("x", {1: "int key"})
    with pytest.raises(ValueError, match="kind too long"):
        TTR.encode_frame("k" * 256, None)


# --------------------------------------------------------------------------
# malformed frames must raise, never mis-decode
# --------------------------------------------------------------------------

def _sample_frame():
    return TTR.encode_frame("env", {"xs": [1, 2, 3], "arr":
                                    np.arange(6, dtype=np.int32),
                                    "bf": torch.ones(3, dtype=torch.bfloat16)})


def test_every_truncation_raises():
    frame = _sample_frame()
    for n in range(len(frame)):
        with pytest.raises(TTR.TransportError):
            TTR.decode_frame(frame[:n])


def test_every_single_byte_corruption_raises():
    frame = bytearray(_sample_frame())
    for i in range(len(frame)):
        bad = bytearray(frame)
        bad[i] ^= 0xFF
        with pytest.raises(TTR.TransportError):
            TTR.decode_frame(bytes(bad))


def test_trailing_garbage_raises():
    with pytest.raises(TTR.TransportError, match="length mismatch"):
        TTR.decode_frame(_sample_frame() + b"x")


def test_version_skew_raises():
    frame = bytearray(_sample_frame())
    struct.pack_into("!H", frame, 4, TTR.WIRE_VERSION + 1)
    with pytest.raises(TTR.TransportError, match="wire version"):
        TTR.decode_frame(bytes(frame))


def test_bad_magic_raises():
    frame = bytearray(_sample_frame())
    frame[:4] = b"NOPE"
    with pytest.raises(TTR.TransportError, match="magic"):
        TTR.decode_frame(bytes(frame))
    assert bytes(_sample_frame()[:4]) == TTR.MAGIC == JTR.MAGIC
    assert TTR.WIRE_VERSION == JTR.WIRE_VERSION


def test_hostile_length_fields_never_overallocate():
    frame = TTR.encode_frame("s", "abc")
    idx = frame.index(b"S") + 1                  # the string length u32
    bad = frame[:idx] + b"\x7f\xff\xff\xff" + frame[idx + 4:]
    with pytest.raises(TTR.TransportError):
        TTR.decode_frame(bad)
    # a body length over the cap, before any allocation
    big = bytearray(frame)
    struct.pack_into("!I", big, 6, TTR.MAX_FRAME_BODY + 1)
    with pytest.raises(TTR.TransportError, match="exceeds cap"):
        TTR.decode_frame(bytes(big))


def _random_value(rng, depth=0):
    """tests/test_transport.py's seeded generator over the codec's value
    space, with bf16 tensors among the arrays."""
    kinds = ["none", "bool", "int", "float", "str", "bytes", "arr", "bf16"]
    if depth < 3:
        kinds += ["list", "dict", "list", "dict"]
    kind = kinds[rng.randint(len(kinds))]
    if kind == "none":
        return None
    if kind == "bool":
        return bool(rng.randint(2))
    if kind == "int":
        return int(rng.randint(-(1 << 62), 1 << 62, dtype=np.int64))
    if kind == "float":
        return float(rng.randn() * 10.0 ** rng.randint(-10, 10))
    if kind == "str":
        return "".join(chr(rng.randint(1, 0x300))
                       for _ in range(rng.randint(0, 20)))
    if kind == "bytes":
        return rng.bytes(rng.randint(0, 32))
    shape = tuple(rng.randint(0, 5) for _ in range(rng.randint(0, 4)))
    if kind == "bf16":
        return torch.from_numpy(np.asarray(rng.randn(*shape))).to(
            torch.bfloat16)
    if kind == "arr":
        return _arr(_DTYPES[rng.randint(len(_DTYPES))], shape,
                    seed=rng.randint(1000))
    if kind == "list":
        return [_random_value(rng, depth + 1)
                for _ in range(rng.randint(0, 5))]
    return {f"k{i}": _random_value(rng, depth + 1)
            for i in range(rng.randint(0, 5))}


def _has_tensor(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, dict):
        return any(map(_has_tensor, obj.values()))
    return isinstance(obj, list) and any(map(_has_tensor, obj))


@pytest.mark.parametrize("seed", range(30))
def test_roundtrip_property(seed):
    """Nested values round-trip; frames equal the reference's where
    the value holds no tensor, and decode in the reference to the same
    bytes where it does."""
    rng = np.random.RandomState(seed)
    for _ in range(5):
        obj = _random_value(rng)
        frame = TTR.encode_frame(f"kind{seed}", obj)
        if not _has_tensor(obj):
            assert frame == JTR.encode_frame(f"kind{seed}", obj)
        kind, got = TTR.decode_frame(frame)
        assert kind == f"kind{seed}"
        _assert_same(got, obj)
        jkind, jgot = JTR.decode_frame(frame)
        assert jkind == kind
        _assert_same(TTR.decode_frame(JTR.encode_frame(kind, jgot))[1], obj)


# --------------------------------------------------------------------------
# request / handoff envelopes and the loopback
# --------------------------------------------------------------------------

def _request():
    req = Request(rid=42, prompt=[1, 2, 3], max_new_tokens=8)
    req.state = State.DECODE
    req.output = [9, 8]
    req.prefill_pos = 3
    req.resumed = True
    req.preemptions = 2
    req.prompt_hit_tokens = 1
    req.handoff_after_prefill = True
    req.migrations = 1
    req.requeues = 3
    req.arrival_time = 1.5
    req.deadline = 99.0
    req.admit_time = 2.0
    req.first_token_time = 4.5
    req.finish_reason = ""
    return req


def test_request_envelope_roundtrips_every_field_as_the_reference():
    from repro.runtime.requests import Request as JRequest
    from repro.runtime.requests import State as JState
    req = _request()
    wire = TTR.request_to_wire(req)
    jreq = JRequest(rid=42, prompt=[1, 2, 3], max_new_tokens=8)
    for f in TTR._REQ_SCALARS + ("output", "resumed",
                                 "handoff_after_prefill", "finish_reason"):
        setattr(jreq, f, getattr(req, f))
    jreq.state = JState.DECODE
    assert TTR.encode_frame("req", wire) == \
        JTR.encode_frame("req", JTR.request_to_wire(jreq))
    got = TTR.request_from_wire(TTR.decode_frame(
        TTR.encode_frame("req", wire))[1])
    for f in ("rid", "prompt", "max_new_tokens", "state", "output",
              "prefill_pos", "resumed", "preemptions", "prompt_hit_tokens",
              "handoff_after_prefill", "migrations", "requeues",
              "arrival_time", "deadline", "admit_time", "first_token_time",
              "finish_time", "finish_reason"):
        assert getattr(got, f) == getattr(req, f), f
    assert got.slot is None                      # placement never ships


def test_handoff_envelope_preserves_identity_and_payload():
    req = Request(rid=7, prompt=[5, 6], max_new_tokens=4)
    payload = {"k": torch.randn(2, 1, 8, 2, 16).to(torch.bfloat16)}
    h = Handoff(req=req, n_tokens=3, payload=payload)
    wire = TTR.decode_frame(TTR.encode_frame(
        "handoff", TTR.handoff_to_wire(h)))[1]
    got = TTR.handoff_from_wire(wire, req=req)
    assert got.req is req                        # loopback keeps identity
    assert got.n_tokens == 3
    _assert_same(got.payload, payload)
    fresh = TTR.handoff_from_wire(wire)          # socket path rebuilds
    assert fresh.req is not req and fresh.req.rid == 7


def test_loopback_transport_accounting():
    lo = TTR.LoopbackTransport()
    obj = {"xs": np.arange(10, dtype=np.int64)}
    got, nbytes = lo.transfer("submit", obj)
    _assert_same(got, obj)
    assert nbytes == len(JTR.encode_frame("submit", obj))
    lo.transfer("submit", obj)
    assert lo.frames == 2 and lo.bytes == 2 * nbytes


def test_default_spec_is_the_reference_spec():
    assert TTR.DEFAULT_SPEC == JTR.DEFAULT_SPEC
    _assert_same(TTR.decode_frame(TTR.encode_frame(
        "spec", TTR.DEFAULT_SPEC))[1], TTR.DEFAULT_SPEC)


# --------------------------------------------------------------------------
# socket framing: asyncio host side + blocking client, one codec
# --------------------------------------------------------------------------

def test_socket_channel_roundtrip_and_error_frames():
    import asyncio

    ready = threading.Event()
    addr = {}

    async def _serve():
        async def handle(reader, writer):
            while True:
                try:
                    kind, obj = await TTR.read_frame_async(reader)
                except TTR.ReplicaGone:
                    break
                if kind == "boom":
                    await TTR.write_frame_async(writer, "error", "kaboom")
                    continue
                await TTR.write_frame_async(writer, f"re:{kind}", obj)
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        addr["port"] = server.sockets[0].getsockname()[1]
        addr["loop"], addr["server"] = asyncio.get_running_loop(), server
        ready.set()
        async with server:
            try:
                await server.serve_forever()
            except asyncio.CancelledError:
                pass

    t = threading.Thread(target=lambda: asyncio.run(_serve()), daemon=True)
    t.start()
    assert ready.wait(10)
    chan = TTR.SocketChannel("127.0.0.1", addr["port"], timeout=10)
    try:
        payload = {"arr": np.random.RandomState(3).randn(4, 7)
                   .astype(np.float32), "meta": {"rid": 1, "ok": True},
                   "bf": torch.arange(6, dtype=torch.bfloat16)}
        _assert_same(chan.request("echo", payload), payload)
        with pytest.raises(TTR.TransportError, match="kaboom"):
            chan.request("boom", {})
        got2 = chan.request("echo", [1, "after", None])   # still usable
        _assert_same(got2, [1, "after", None])
        assert chan.sent_frames == 3
    finally:
        chan.close()
        addr["loop"].call_soon_threadsafe(addr["server"].close)
        t.join(10)
    assert not t.is_alive()


def test_connect_to_nowhere_raises_replica_gone():
    with pytest.raises(TTR.ReplicaGone):
        TTR.SocketChannel("127.0.0.1", 1, timeout=0.5)
