"""Socket server + client: the out-of-process serving surface.

The reference is an embedded library: Vearch's Go partition server links
it via cgo (go/gamma/gamma.go) and every call crosses a flatbuffers
boundary.  Here the engine lives in the process that owns the GPU, so the
language-neutral contract is the wire format (gamma_tpu/idl/wire.py)
carried over a socket with a minimal frame protocol:

    request : u8 opcode | u32 payload_len | payload bytes
    response: i32 status | u32 payload_len | payload bytes

Any language that can speak this framing + the wire format can drive the
engine (the role the Go SDK plays for the reference).  `GammaClient` is
the in-repo client; `serve()` is a threaded server over TCP or a unix
socket.
"""

from __future__ import annotations

import os
import socket
import socketserver
import struct
import threading
from typing import Any, Dict, Optional, Tuple

from gamma_tpu import c_api
from gamma_tpu.idl import wire
from gamma_tpu.utils.log import get_logger

OP_INIT = 1
OP_CLOSE = 2
OP_CREATE_TABLE = 3
OP_ADD_OR_UPDATE_DOCS = 4
OP_DELETE_DOC = 5
OP_SEARCH = 6
OP_GET_DOC = 7
OP_BUILD_INDEX = 8
OP_FLUSH = 9
OP_STATUS = 10
OP_DUMP = 11
OP_LOAD = 12
OP_DEL_BY_QUERY = 13

_HDR = struct.Struct("<BI")
_RSP = struct.Struct("<iI")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class _Handler(socketserver.BaseRequestHandler):
    """One engine handle per connection (created on OP_INIT)."""

    def handle(self) -> None:
        handle: Optional[int] = None
        sock = self.request
        try:
            while True:
                try:
                    hdr = _recv_exact(sock, _HDR.size)
                except ConnectionError:
                    break
                op, plen = _HDR.unpack(hdr)
                payload = _recv_exact(sock, plen) if plen else b""
                status, out = 0, b""
                try:
                    if op == OP_INIT:
                        if handle is not None:
                            c_api.Close(handle)     # no handle leaks
                        handle = c_api.Init(payload)
                    elif handle is None:
                        status = -2          # not initialized
                    elif op == OP_CLOSE:
                        status = c_api.Close(handle)
                        handle = None
                    elif op == OP_CREATE_TABLE:
                        status = c_api.CreateTable(handle, payload)
                    elif op == OP_ADD_OR_UPDATE_DOCS:
                        out = c_api.AddOrUpdateDocs(handle, payload)
                    elif op == OP_DELETE_DOC:
                        status = c_api.DeleteDoc(handle, payload)
                    elif op == OP_SEARCH:
                        out = c_api.Search(handle, payload)
                    elif op == OP_GET_DOC:
                        got = c_api.GetDocByID(handle, payload)
                        if got is None:
                            status = -1
                        else:
                            out = got
                    elif op == OP_BUILD_INDEX:
                        status = c_api.BuildIndex(handle)
                    elif op == OP_FLUSH:
                        status = c_api.Flush(handle)
                    elif op == OP_STATUS:
                        out = c_api.GetEngineStatus(handle)
                    elif op == OP_DUMP:
                        status = c_api.Dump(handle)
                    elif op == OP_LOAD:
                        status = c_api.Load(handle)
                    elif op == OP_DEL_BY_QUERY:
                        status = c_api.DelDocByQuery(handle, payload)
                    else:
                        status = -3          # unknown opcode
                except Exception:            # noqa: BLE001
                    status = -4              # engine error
                    get_logger().exception("server op=%d failed", op)
                sock.sendall(_RSP.pack(status, len(out)) + out)
        finally:
            if handle is not None:
                c_api.Close(handle)


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True


def serve(address, background: bool = True):
    """Start serving.  `address` is ("host", port) for TCP or a string
    path for a unix socket.  Returns the server object; call its
    .stop() to shut down and release the listener (for unix sockets the
    path is unlinked so the address can be reused)."""
    if isinstance(address, str):
        if os.path.exists(address):       # stale socket from a prior run
            os.unlink(address)
        srv = _UnixServer(address, _Handler)
    else:
        srv = _TCPServer(tuple(address), _Handler)

    def stop():
        srv.shutdown()
        srv.server_close()
        if isinstance(address, str) and os.path.exists(address):
            os.unlink(address)

    srv.stop = stop
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
    else:
        srv.serve_forever()
    return srv


class ServerError(RuntimeError):
    """Raised when the server returns a nonzero status."""

    def __init__(self, op: int, status: int):
        super().__init__(f"server returned status {status} for op {op}")
        self.op = op
        self.status = status


class GammaClient:
    """Typed client over the frame protocol (the Go SDK analog)."""

    def __init__(self, address):
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(address)
        else:
            self._sock = socket.create_connection(tuple(address))
        # one in-flight call per connection (the router's fan-out pool
        # may hit the same client from several threads)
        self._lock = threading.Lock()

    def _call(self, op: int, payload: bytes = b"") -> Tuple[int, bytes]:
        with self._lock:
            self._sock.sendall(_HDR.pack(op, len(payload)) + payload)
            status, plen = _RSP.unpack(_recv_exact(self._sock, _RSP.size))
            out = _recv_exact(self._sock, plen) if plen else b""
        return status, out

    def _call_payload(self, op: int, payload: bytes = b"") -> bytes:
        """For calls whose success response carries a payload: raise on
        any nonzero status instead of handing an empty buffer to the
        wire parser."""
        status, out = self._call(op, payload)
        if status != 0:
            raise ServerError(op, status)
        return out

    # ---- typed API ----

    def init(self, config) -> int:
        return self._call(OP_INIT, wire.pack_config(config))[0]

    def create_table(self, info) -> int:
        return self._call(OP_CREATE_TABLE, wire.pack_table(info))[0]

    def add_or_update_docs(self, docs):
        out = self._call_payload(OP_ADD_OR_UPDATE_DOCS,
                                 wire.pack_docs(docs))
        return wire.unpack_batch_result(out)

    def delete(self, key: str) -> int:
        return self._call(OP_DELETE_DOC, str(key).encode())[0]

    def search(self, request):
        out = self._call_payload(OP_SEARCH, wire.pack_request(request))
        return wire.unpack_response(out)

    def get_doc(self, key: str):
        status, out = self._call(OP_GET_DOC, str(key).encode())
        return None if status != 0 else wire.unpack_doc(out)

    def build_index(self) -> int:
        return self._call(OP_BUILD_INDEX)[0]

    def flush(self) -> int:
        return self._call(OP_FLUSH)[0]

    def status(self):
        return wire.unpack_status(self._call_payload(OP_STATUS))

    def dump(self) -> int:
        return self._call(OP_DUMP)[0]

    def load(self) -> int:
        return self._call(OP_LOAD)[0]

    def del_doc_by_query(self, request) -> int:
        return self._call(OP_DEL_BY_QUERY, wire.pack_request(request))[0]

    def close(self) -> None:
        try:
            self._call(OP_CLOSE)
        finally:
            self._sock.close()


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve the gamma-tpu engine over the frame protocol")
    ap.add_argument("--listen", default="127.0.0.1:7070",
                    help="host:port for TCP, or a filesystem path for a "
                         "unix socket")
    args = ap.parse_args()
    addr = args.listen
    if ":" in addr and not addr.startswith("/"):
        host, _, port = addr.rpartition(":")
        address = (host, int(port))
    else:
        address = addr
    get_logger().info("serving on %s", addr)
    serve(address, background=False)


if __name__ == "__main__":
    _main()
