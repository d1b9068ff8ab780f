"""HTTP ingress: the proxy actor routing HTTP requests to deployment
handles (the port's copy of ray_tpu/serve/http_proxy.py).

Analog of Ray's python/ray/serve/_private/http_proxy.py (HTTPProxyActor
:387, HTTPProxy :218; uvicorn/starlette there, aiohttp in ray_tpu).  The
port serves HTTP/1.1 with the standard library only, on
``asyncio.start_server`` in the actor's background loop: keep-alive,
``Content-Length`` request bodies (a chunked one is refused with a
501), ``Expect: 100-continue``, query strings, and chunked responses
for SSE, with limits on the request line, the headers and the body.

Routes (ray_tpu's): ``GET /-/healthz``, ``POST /-/echo``, ``POST
/-/stream/{deployment}`` and ``POST /-/disagg/{preset}`` (SSE token
streams, ``serve/frontdoor/sse.py``), and any method on ``/{deployment}``
and ``/{deployment}/{tail}``, whose JSON body (else the body as text,
else the query string) goes to ``handle.remote(payload)``.  The request
path stays ON the event loop (``DeploymentHandle.try_remote`` + owned-
object readiness callbacks); the blocking executor is a fallback for
backpressured submits and cross-node result pulls only.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle

MAX_LINE = 8 * 1024             # request line and each header line
MAX_HEADERS = 100
MAX_BODY = 64 * 1024 * 1024

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error", 501: "Not Implemented"}


class HTTPError(Exception):
    """A request the server refuses before routing it; the connection
    closes after the reply."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Request:
    """One parsed HTTP/1.1 request."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 body: bytes, keep_alive: bool,
                 writer: asyncio.StreamWriter):
        self.method = method
        self.path = path
        self.query = query
        self.body = body
        self.keep_alive = keep_alive
        self.match_info: Dict[str, str] = {}
        self._writer = writer

    def json(self):
        """The body as JSON (``json.JSONDecodeError`` when it is not)."""
        return json.loads(self.body.decode("utf-8", errors="replace"))

    def stream_response(self, headers: Dict[str, str]) -> "StreamResponse":
        return StreamResponse(self, headers)


class Response:
    """A whole reply: JSON, or ``text/plain``."""

    def __init__(self, body: bytes, content_type: str, status: int = 200):
        self.body = body
        self.content_type = content_type
        self.status = status

    @classmethod
    def json(cls, data, status: int = 200) -> "Response":
        """``TypeError`` when ``data`` is not JSON-serialisable."""
        return cls(json.dumps(data).encode(),
                   "application/json; charset=utf-8", status)

    @classmethod
    def text(cls, text: str, status: int = 200) -> "Response":
        return cls(text.encode(), "text/plain; charset=utf-8", status)

    async def send(self, writer: asyncio.StreamWriter,
                   keep_alive: bool) -> None:
        writer.write(_head(self.status, {
            "Content-Type": self.content_type,
            "Content-Length": str(len(self.body))}, keep_alive)
            + self.body)
        await writer.drain()


class StreamResponse:
    """A chunked reply written event by event (``serve/frontdoor/sse.py``
    drives it as ray_tpu drives aiohttp's ``StreamResponse``)."""

    def __init__(self, request: Request, headers: Dict[str, str]):
        self._request = request
        self._writer = request._writer
        self._headers = dict(headers, **{"Transfer-Encoding": "chunked"})
        self.finished = False

    async def prepare(self) -> None:
        self._writer.write(_head(200, self._headers,
                                 self._request.keep_alive))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        """One chunk, flushed: a closed client raises here, as a
        ``ConnectionError``."""
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()
        self.finished = True


def _head(status: int, headers: Dict[str, str], keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    lines.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError:
        raise HTTPError(431, "request line or header too long")
    return line.rstrip(b"\r\n")


async def read_request(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> Optional[Request]:
    """The next request on the connection, or None at a clean EOF."""
    line = b""
    while not line:                 # tolerate blank lines between requests
        try:
            line = await _read_line(reader)
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise HTTPError(400, "truncated request line")
            return None
    try:
        method, target, version = line.decode("latin-1").split(" ")
    except ValueError:
        raise HTTPError(400, "bad request line")
    if not version.startswith("HTTP/1."):
        raise HTTPError(400, f"unsupported protocol {version!r}")
    headers: Dict[str, str] = {}
    while True:
        hl = await _read_line(reader)
        if not hl:
            break
        if len(headers) >= MAX_HEADERS:
            raise HTTPError(431, "too many headers")
        name, sep, value = hl.decode("latin-1").partition(":")
        if not sep:
            raise HTTPError(400, "bad header line")
        headers[name.strip().lower()] = value.strip()
    conn = headers.get("connection", "").lower()
    keep_alive = ("close" not in conn if version == "HTTP/1.1"
                  else "keep-alive" in conn)
    if headers.get("expect", "").lower() == "100-continue" \
            and "transfer-encoding" not in headers:
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if "transfer-encoding" in headers:
        raise HTTPError(501, "send the body with a Content-Length")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise HTTPError(400, "bad Content-Length")
    if length < 0:
        raise HTTPError(400, "bad Content-Length")
    if length > MAX_BODY:
        raise HTTPError(413, "request body too large")
    body = await reader.readexactly(length) if length else b""
    parts = urlsplit(target)
    query: Dict[str, str] = {}
    for k, v in parse_qsl(parts.query, keep_blank_values=True):
        query.setdefault(k, v)      # a repeated key: its first value
    return Request(method.upper(), unquote(parts.path) or "/", query,
                   body, keep_alive, writer)


def route(method: str, path: str) -> Tuple[Optional[str], Dict[str, str]]:
    """ray_tpu's routing table: (handler name, match info), or (None,
    {}) for no route.  A fixed route whose method differs falls through
    to the deployment routes, as aiohttp's resolver does."""
    segs = path.split("/")[1:]
    fixed = {("GET", "/-/healthz"): "healthz",
             ("POST", "/-/echo"): "echo"}
    if (method, path) in fixed:
        return fixed[(method, path)], {}
    if method == "POST" and len(segs) == 3 and segs[0] == "-" and segs[2]:
        if segs[1] == "stream":
            return "stream", {"deployment": segs[2]}
        if segs[1] == "disagg":
            return "disagg", {"preset": segs[2]}
    if segs and segs[0]:
        info = {"deployment": segs[0]}
        if len(segs) == 1:
            return "handle", info
        info["tail"] = "/".join(segs[1:])
        return "handle", info
    return None, {}


class HTTPProxyActor:
    """Threaded actor: the HTTP server runs on a background event loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self._handles: Dict[str, DeploymentHandle] = {}
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def ready(self) -> bool:
        self._ready.wait(timeout=15)
        if self._error is not None:
            raise self._error
        return self._ready.is_set()

    def address(self) -> Tuple[str, int]:
        """Where the server listens (the port the OS chose for port 0)."""
        self.ready()
        return self.host, self.port

    def _get_handle(self, deployment: str) -> DeploymentHandle:
        if deployment not in self._handles:
            self._handles[deployment] = DeploymentHandle(deployment)
        return self._handles[deployment]

    def _serve(self):
        try:
            asyncio.run(self._main())
        except BaseException as e:  # noqa: BLE001 - ready() re-raises
            self._error = e
            self._ready.set()

    async def _main(self):
        import time as _time

        from ray_tpu_torch.runtime.core_worker import get_global_worker
        from ray_tpu_torch.serve.frontdoor import sse as fd_sse
        from ray_tpu_torch.serve.handle import DisaggHandle, _aget
        from ray_tpu_torch.util.tracing import tracing_helper as trh

        # per-request closures touch only locals: worker/handle lookups,
        # monotonic, and the json codec are bound once (the proxy's whole
        # budget is fractions of a millisecond per request)
        worker = get_global_worker()
        get_handle = self._get_handle
        monotonic = _time.monotonic
        add_ready = worker.add_ready_callback
        ray_get = ray_tpu_torch.get
        GetTimeout = ray_tpu_torch.exceptions.GetTimeoutError
        ingress_root = trh.serve_ingress_root
        install_ctx = trh.install
        uninstall_ctx = trh.uninstall
        finish_request = trh.finish_request
        stream_sse = fd_sse.stream_sse
        # disagg routers are long-lived (they cache routing tables and
        # the prefix-affinity index); one per preset, bound outside the
        # handlers like the deployment handles
        disagg_handles: Dict[str, DisaggHandle] = {}

        def get_disagg(preset: str) -> DisaggHandle:
            h = disagg_handles.get(preset)
            if h is None:
                h = disagg_handles[preset] = DisaggHandle(
                    f"llm-{preset}-prefill", f"llm-{preset}-decode")
            return h

        async def handle(request: Request) -> Response:
            deployment = request.match_info["deployment"]
            if request.body:
                try:
                    payload = request.json()
                except json.JSONDecodeError:
                    payload = request.body.decode(errors="replace")
            else:
                payload = dict(request.query)
            loop = asyncio.get_running_loop()

            # request trace root (docs/observability.md): every HTTP
            # request gets a root context (SLO accounting classifies all
            # of them; span recording follows the deterministic
            # sampler).  Installed on THIS coroutine's context only —
            # concurrent requests interleave with their own identities.
            root = ingress_root(f"http:{deployment}", route=deployment)
            if root is not None:
                install_ctx(root.ctx())
            t_req = monotonic()

            # Fast path stays ON the event loop end to end: non-blocking
            # submit (try_remote), readiness via an owned-object ready
            # callback, and an immediate local get once ready.  Executor
            # hops happen only under backpressure (blocking admission)
            # or when a large result needs a cross-node pull — the two
            # cases that would otherwise stall every other request.
            try:
                deadline = monotonic() + 60.0
                h = get_handle(deployment)
                ref = h.try_remote(payload)
                if ref is None:        # cold table / backpressure
                    # bind_ctx: the executor thread must carry this
                    # request's context, or the handle would open a
                    # second root for the same request
                    ref = await loop.run_in_executor(
                        None, trh.bind_ctx(
                            root.ctx() if root is not None else None,
                            h.remote, payload))
                fut = loop.create_future()

                def _on_ready():
                    loop.call_soon_threadsafe(_set_ready, fut)

                add_ready(ref, _on_ready)
                # manual timeout (call_later + cancel) instead of
                # asyncio.wait_for: wait_for wraps the await in a Task —
                # measurable per-request overhead at these rates.  The
                # timer spends the REMAINING request budget (a blocked
                # executor submit already consumed part of the 60 s)
                timer = loop.call_later(
                    max(0.1, deadline - monotonic()), _fail_timeout, fut)
                try:
                    await fut
                finally:
                    timer.cancel()
                try:
                    # ready + inline/local result: returns without waiting
                    result = ray_get(ref, timeout=0.05)
                except GetTimeout:
                    # store-resident result needing a pull: off the loop
                    remaining = max(0.1, deadline - monotonic())
                    result = await loop.run_in_executor(
                        None, lambda: ray_get(ref, timeout=remaining))
            except Exception as e:  # noqa: BLE001 - surfaced as HTTP 500
                finish_request(root, pool="http", route=deployment,
                               status=trh.ERROR,
                               ttft_s=monotonic() - t_req,
                               error_type=type(e).__name__,
                               dossier_id=getattr(e, "dossier_id", None))
                return _error(e)
            # non-streaming HTTP: the whole request latency IS its TTFT
            finish_request(root, pool="http", route=deployment,
                           ttft_s=monotonic() - t_req)
            try:
                return Response.json(result)
            except TypeError:
                return Response.text(str(result))

        def _set_ready(fut):
            if not fut.done():
                fut.set_result(None)

        def _fail_timeout(fut):
            if not fut.done():
                fut.set_exception(TimeoutError("request timed out"))

        async def stream_colocated(request: Request):
            """SSE token streaming from a colocated LLM deployment
            (docs/serve_frontdoor.md): POST /-/stream/{deployment} with
            an LLM request body; the replica's ``stream`` method is
            driven via the streaming handle path and each yielded item
            is framed as an SSE event the moment its ref resolves."""
            deployment = request.match_info["deployment"]
            try:
                payload = request.json()
            except json.JSONDecodeError:
                return _bad_sse_body()
            root = ingress_root(f"sse:{deployment}", route=deployment)
            token = install_ctx(root.ctx()) if root is not None else None
            try:
                loop = asyncio.get_running_loop()
                h = get_handle(deployment)
                try:
                    # routing may block (capacity wait, cold-table
                    # controller RPC): off the loop, ctx re-bound
                    gen = await loop.run_in_executor(
                        None, trh.bind_ctx(
                            root.ctx() if root is not None else None,
                            lambda: h.stream.remote_streaming(payload)))
                except Exception as e:  # noqa: BLE001 - HTTP 500 below
                    finish_request(root, pool="sse", route=deployment,
                                   status=trh.ERROR,
                                   error_type=type(e).__name__)
                    return _error(e)

                async def items():
                    async for ref in gen:
                        yield await _aget(worker, ref, timeout=60.0)

                return await stream_sse(request, items(),
                                        route=deployment, pool="sse",
                                        root=root)
            finally:
                if token is not None:
                    uninstall_ctx(token)

        async def stream_disagg(request: Request):
            """SSE token streaming through the disaggregated router
            (docs/serve_frontdoor.md): POST /-/disagg/{preset} streams
            DisaggHandle.stream — first token from the prefill pool
            (prefix-affinity routed), decode tokens after the handoff,
            ``{"retry": n}`` death-recovery markers as SSE retry
            events.  The ingress root opened HERE is the request's
            trace root (DisaggHandle joins it instead of opening its
            own) so the SLO verdict carries client-observed latency."""
            preset = request.match_info["preset"]
            try:
                payload = request.json()
            except json.JSONDecodeError:
                return _bad_sse_body()
            route_name = f"llm-{preset}-decode"
            root = ingress_root(f"sse:disagg:{preset}", route=route_name)
            token = install_ctx(root.ctx()) if root is not None else None
            try:
                dh = get_disagg(preset)
                return await stream_sse(request, dh.stream(payload),
                                        route=route_name, pool="disagg",
                                        root=root)
            finally:
                if token is not None:
                    uninstall_ctx(token)

        async def healthz(_request):
            return Response.text("ok")

        async def echo(request):
            """Transport+JSON floor probe: everything the proxy does per
            request EXCEPT the serve hop."""
            try:
                payload = request.json()
            except json.JSONDecodeError:
                payload = None
            return Response.json(payload)

        handlers = {"healthz": healthz, "echo": echo,
                    "stream": stream_colocated, "disagg": stream_disagg,
                    "handle": handle}

        async def connection(reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
            try:
                while True:
                    try:
                        request = await read_request(reader, writer)
                    except HTTPError as e:
                        await Response.text(str(e), e.status).send(
                            writer, keep_alive=False)
                        return
                    if request is None:
                        return
                    name, request.match_info = route(request.method,
                                                     request.path)
                    if name is None:
                        resp = Response.text("404: Not Found", 404)
                    else:
                        resp = await handlers[name](request)
                    if isinstance(resp, Response):
                        await resp.send(writer, request.keep_alive)
                    elif not resp.finished:
                        return      # a stream cut short: close
                    if not request.keep_alive:
                        return
            except (ConnectionError, asyncio.IncompleteReadError):
                pass                # the client went away
            finally:
                writer.close()

        server = await asyncio.start_server(connection, self.host,
                                            self.port, limit=MAX_LINE)
        self.port = server.sockets[0].getsockname()[1]
        self._ready.set()
        async with server:
            await server.serve_forever()


def _error(e: BaseException) -> Response:
    return Response.json({"error": type(e).__name__, "message": str(e)},
                         status=500)


def _bad_sse_body() -> Response:
    return Response.json({"error": "BadRequest",
                          "message": "SSE streaming needs a JSON body"},
                         status=400)
