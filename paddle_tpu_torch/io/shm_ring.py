"""ctypes bindings and batch codec for the native shared-memory ring —
port of paddle_tpu/io/shm_ring.py.

The C++ side (`native/shm_ring.cc`, the port's own copy of the JAX
package's) is the transport: an MPSC ring in POSIX shared memory. This
module compiles it with g++ on first use into
`build/paddle_tpu_torch/libshm_ring-<hash>.so` beside the CUDA kernels'
libraries (`<hash>` covers the source and the flags, so an edited source
is rebuilt), loads it with ctypes (a plain C ABI), and layers a compact
binary codec for the trees the DataLoader's collate functions produce
(numpy arrays, scalars, str/bytes, list/tuple/dict, pickled fallback).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pickle
import struct
import subprocess
import uuid

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "shm_ring.cc")
_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


def _library_path() -> str:
    from .._build import BUILD_DIR
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libshm_ring-{h.hexdigest()[:16]}.so")

_lib = None
_lib_error = None


def _build_lib():
    """Compile the .so if missing; advisory-locked against races."""
    so = _library_path()
    os.makedirs(os.path.dirname(so), exist_ok=True)
    lock_path = so + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):
                return so
            tmp = so + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", *_FLAGS, _SRC, "-o", tmp, "-lpthread", "-lrt"],
                check=True, capture_output=True, text=True)
            os.replace(tmp, so)
            return so
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        so = _build_lib()
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # stale binary from another arch/glibc — force one rebuild
            os.remove(so)
            lib = ctypes.CDLL(_build_lib())
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_uint32]
        lib.ring_attach.restype = ctypes.c_void_p
        lib.ring_attach.argtypes = [ctypes.c_char_p]
        lib.ring_slot_bytes.restype = ctypes.c_uint64
        lib.ring_slot_bytes.argtypes = [ctypes.c_void_p]
        lib.ring_n_slots.restype = ctypes.c_uint32
        lib.ring_n_slots.argtypes = [ctypes.c_void_p]
        lib.ring_producer_acquire.restype = ctypes.c_int
        lib.ring_producer_acquire.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ring_payload.restype = ctypes.c_void_p
        lib.ring_payload.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.ring_producer_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                             ctypes.c_uint64]
        lib.ring_consumer_wait.restype = ctypes.c_int
        lib.ring_consumer_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ring_consumer_release.argtypes = [ctypes.c_void_p]
        lib.ring_stop.argtypes = [ctypes.c_void_p]
        lib.ring_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
    # ptlint: disable=EXC001 — the error is PRESERVED on _lib_error for
    # native_available() diagnostics; any build/dlopen failure (no
    # compiler, no /dev/shm) degrades to the python transport
    except Exception as e:  # no compiler / no /dev/shm → python fallback
        _lib_error = e
    return _lib


def native_available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# Batch codec: pytree -> bytes. Arrays are raw-copied; decode reconstructs
# them with zero-copy np.frombuffer views over the assembled message buffer.
# ---------------------------------------------------------------------------

_T_ARR, _T_LIST, _T_TUPLE, _T_DICT, _T_STR, _T_BYTES = 1, 2, 3, 4, 5, 6
_T_INT, _T_FLOAT, _T_NONE, _T_BOOL, _T_PICKLE = 7, 8, 9, 10, 11


def encode(obj, out: bytearray) -> None:
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.fields is not None:
            # raw-bytes transport can't carry PyObject pointers or field
            # names — fall through to pickle for these
            b = pickle.dumps(obj)
            out += struct.pack("<BI", _T_PICKLE, len(b))
            out += b
            return
        a = np.ascontiguousarray(obj)
        dt = a.dtype.str.encode()
        # (np scalars — np.generic — are handled below via pickle so their
        # exact type survives, matching the queue transport)
        out += struct.pack("<BB", _T_ARR, len(dt))
        out += dt
        out += struct.pack("<B", a.ndim)
        out += struct.pack(f"<{a.ndim}q", *a.shape)
        # pad so raw array data is 8-byte aligned in the message buffer
        pad = (-len(out) - 8) % 8
        out += struct.pack("<Q", a.nbytes | (pad << 56))
        out += b"\x00" * pad
        out += a.tobytes()
    elif isinstance(obj, np.generic):
        b = pickle.dumps(obj)
        out += struct.pack("<BI", _T_PICKLE, len(b))
        out += b
    elif isinstance(obj, bool):
        out += struct.pack("<B?", _T_BOOL, obj)
    elif isinstance(obj, int):
        out += struct.pack("<Bq", _T_INT, obj)
    elif isinstance(obj, float):
        out += struct.pack("<Bd", _T_FLOAT, obj)
    elif obj is None:
        out += struct.pack("<B", _T_NONE)
    elif isinstance(obj, str):
        b = obj.encode()
        out += struct.pack("<BI", _T_STR, len(b))
        out += b
    elif isinstance(obj, bytes):
        out += struct.pack("<BI", _T_BYTES, len(obj))
        out += obj
    elif isinstance(obj, (list, tuple)):
        out += struct.pack("<BI", _T_LIST if isinstance(obj, list) else _T_TUPLE,
                           len(obj))
        for v in obj:
            encode(v, out)
    elif isinstance(obj, dict):
        out += struct.pack("<BI", _T_DICT, len(obj))
        for k, v in obj.items():
            encode(k, out)
            encode(v, out)
    else:
        b = pickle.dumps(obj)
        out += struct.pack("<BI", _T_PICKLE, len(b))
        out += b


def _decode(buf: memoryview, off: int):
    tag = buf[off]
    off += 1
    if tag == _T_ARR:
        dlen = buf[off]
        off += 1
        dt = np.dtype(bytes(buf[off:off + dlen]).decode())
        off += dlen
        ndim = buf[off]
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        packed, = struct.unpack_from("<Q", buf, off)
        off += 8
        nbytes, pad = packed & ((1 << 56) - 1), packed >> 56
        off += pad
        a = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                          offset=off).reshape(shape)
        return a, off + nbytes
    if tag == _T_BOOL:
        return bool(buf[off]), off + 1
    if tag == _T_INT:
        v, = struct.unpack_from("<q", buf, off)
        return v, off + 8
    if tag == _T_FLOAT:
        v, = struct.unpack_from("<d", buf, off)
        return v, off + 8
    if tag == _T_NONE:
        return None, off
    if tag in (_T_STR, _T_BYTES, _T_PICKLE):
        n, = struct.unpack_from("<I", buf, off)
        off += 4
        raw = bytes(buf[off:off + n])
        off += n
        if tag == _T_STR:
            return raw.decode(), off
        if tag == _T_BYTES:
            return raw, off
        return pickle.loads(raw), off
    if tag in (_T_LIST, _T_TUPLE):
        n, = struct.unpack_from("<I", buf, off)
        off += 4
        items = []
        for _ in range(n):
            v, off = _decode(buf, off)
            items.append(v)
        return (items if tag == _T_LIST else tuple(items)), off
    if tag == _T_DICT:
        n, = struct.unpack_from("<I", buf, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _decode(buf, off)
            v, off = _decode(buf, off)
            d[k] = v
        return d, off
    raise ValueError(f"shm_ring codec: bad tag {tag}")


def decode(buf) -> object:
    value, _ = _decode(memoryview(buf), 0)
    return value


# ---------------------------------------------------------------------------
# Ring wrapper with message chunking.
# Chunk payload header: <Q msg_id, I chunk_idx, I n_chunks> then data.
# ---------------------------------------------------------------------------

_CHUNK_HDR = struct.Struct("<QII")


class ShmRing:
    """One shared ring: producers call send(); the single consumer, recv()."""

    def __init__(self, name: str | None = None, slot_bytes: int = 1 << 20,
                 n_slots: int = 16, _attach: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                f"native shm_ring unavailable: {_lib_error!r}")
        self._lib = lib
        self.name = name or \
            f"/ptpt_ring_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        if _attach:
            self._h = lib.ring_attach(self.name.encode())
        else:
            self._h = lib.ring_create(self.name.encode(), slot_bytes, n_slots)
        if not self._h:
            raise RuntimeError(
                f"shm_ring: {'attach' if _attach else 'create'} failed "
                f"for {self.name}")
        self.slot_bytes = lib.ring_slot_bytes(self._h)
        self.n_slots = lib.ring_n_slots(self._h)
        self._read_ticket = 0
        self._partial: dict[int, list] = {}
        self._closed = False

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        return cls(name=name, _attach=True)

    # -- producer side ------------------------------------------------------
    def send_bytes(self, msg_id: int, data, timeout_ms: int = -1):
        """Chunk `data` (bytes-like) into the ring; RuntimeError if stopped.

        A writable buffer (bytearray) is memmoved into shared memory with no
        intermediate copies; read-only bytes incur one copy per chunk.
        """
        cap = self.slot_bytes - _CHUNK_HDR.size
        n_chunks = max(1, -(-len(data) // cap))
        mv = memoryview(data)
        ticket = ctypes.c_uint64()
        for idx in range(n_chunks):
            chunk = mv[idx * cap:(idx + 1) * cap]
            rc = self._lib.ring_producer_acquire(
                self._h, ctypes.byref(ticket), timeout_ms)
            if rc == -2:
                raise RuntimeError("shm_ring stopped")
            if rc != 0:
                raise TimeoutError("shm_ring producer timeout")
            dst = self._lib.ring_payload(self._h, ticket.value)
            hdr = _CHUNK_HDR.pack(msg_id, idx, n_chunks)
            ctypes.memmove(dst, hdr, len(hdr))
            if len(chunk):
                if chunk.readonly:
                    src = bytes(chunk)
                else:
                    src = (ctypes.c_char * len(chunk)).from_buffer(chunk)
                ctypes.memmove(dst + len(hdr), src, len(chunk))
            self._lib.ring_producer_commit(self._h, ticket.value,
                                           len(hdr) + len(chunk))

    def send(self, msg_id: int, obj, timeout_ms: int = -1):
        buf = bytearray()
        encode(obj, buf)
        self.send_bytes(msg_id, buf, timeout_ms)

    # -- consumer side ------------------------------------------------------
    def recv_bytes(self, timeout_ms: int = -1):
        """Next complete message → (msg_id, bytearray); None on timeout.

        Single-chunk messages (the common case) take exactly one copy:
        slot payload → result bytearray.
        """
        nbytes = ctypes.c_uint64()
        while True:
            rc = self._lib.ring_consumer_wait(
                self._h, self._read_ticket, ctypes.byref(nbytes), timeout_ms)
            if rc != 0:
                return None
            src = self._lib.ring_payload(self._h, self._read_ticket)
            msg_id, idx, n_chunks = _CHUNK_HDR.unpack(
                ctypes.string_at(src, _CHUNK_HDR.size))
            body_len = nbytes.value - _CHUNK_HDR.size
            body = bytearray(body_len)
            if body_len:
                ctypes.memmove((ctypes.c_char * body_len).from_buffer(body),
                               src + _CHUNK_HDR.size, body_len)
            self._read_ticket += 1
            self._lib.ring_consumer_release(self._h)
            if n_chunks == 1:
                return msg_id, body
            parts = self._partial.setdefault(msg_id, [])
            parts.append(body)
            if len(parts) == n_chunks:
                del self._partial[msg_id]
                return msg_id, bytearray(b"".join(parts))

    def recv(self, timeout_ms: int = -1):
        got = self.recv_bytes(timeout_ms)
        if got is None:
            return None
        msg_id, buf = got
        return msg_id, decode(buf)

    # -- lifecycle ----------------------------------------------------------
    def stop(self):
        if not self._closed:
            self._lib.ring_stop(self._h)

    def close(self, unlink: bool = False):
        if not self._closed:
            self._closed = True
            self._lib.ring_close(self._h, 1 if unlink else 0)

    def __del__(self):
        try:
            self.close()
        # ptlint: disable=EXC001 — __del__ must never raise (interpreter
        # teardown: modules/attrs may already be gone)
        except Exception:
            pass
