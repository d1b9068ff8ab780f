"""The port's HTTP front door (ray_tpu_torch/serve/http_proxy.py, on the
standard library, and serve/frontdoor/sse.py) held against ray_tpu's on
the CPU.

- SSE framing: ``SSE_HEADERS``, ``format_event`` and ``classify`` byte
  for byte.
- Routes: the requests of ``tests/test_serve.py::test_http_proxy`` and
  its neighbours (JSON, query string, text body, a tail path, another
  method, health, echo, a 404, a non-JSON SSE body, a deployment that
  raises) against ray_tpu's aiohttp proxy.  ray_tpu's proxy runs in this
  process with its handle, runtime get and readiness callback standing
  in for a cluster (its handlers, routes and responses are its own);
  the port's runs on a port cluster with real deployments.
- SSE tokens from ``llm-tiny``, colocated and disaggregated 1 + 1, equal
  the tokens the handles stream (``tests/test_torch_serve.py`` holds
  those against ray_tpu's); a client that hangs up mid-stream leaves the
  replica with no busy slot and the proxy serving.
"""

import os

# the conftest scales ray_tpu's liveness timeouts for a loaded box; the
# port reads its own prefix, so hand it the same scale
os.environ.setdefault("RAY_TPU_TORCH_TIMEOUT_SCALE",
                      os.environ.get("RAY_TPU_TIMEOUT_SCALE", "1.0"))

import asyncio  # noqa: E402
import http.client  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.serve.frontdoor import sse as jax_sse  # noqa: E402
from ray_tpu_torch import cloudpickle, serve  # noqa: E402
from ray_tpu_torch.serve.api import PROXY_NAME  # noqa: E402
from ray_tpu_torch.serve.config import HTTPOptions  # noqa: E402
from ray_tpu_torch.serve.controller import SERVE_NAMESPACE  # noqa: E402
from ray_tpu_torch.serve.frontdoor import sse  # noqa: E402
from ray_tpu_torch.serve.handle import DeploymentHandle  # noqa: E402
from ray_tpu_torch.serve.deployment import Deployment  # noqa: E402
from ray_tpu_torch.serve.llm import (LLMServer, build_app,  # noqa: E402
                                     disagg_handle)

# the replica class below travels to the replicas by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 120 * float(os.environ["RAY_TPU_TORCH_TIMEOUT_SCALE"])
ENGINE = dict(num_slots=4, block_size=4, page_size=8, device="cpu")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [50, 60] * 4 + [61],
           list(range(20, 32))]
NEW = 8


# ------------------------------------------------------------ framing
@pytest.mark.parametrize("item", [
    {"token": 17}, {"retry": 1, "reason": "replica died"},
    {"finish_reason": "length", "num_tokens": 8, "latency_s": 0.25},
    {"error": "ValueError", "message": "x\ny"}, {"token": 3, "x": None}])
def test_sse_framing_matches_ray_tpu(item):
    assert sse.SSE_HEADERS == jax_sse.SSE_HEADERS
    assert sse.classify(item) == jax_sse.classify(item)
    for event in (None, "done", "error", sse.classify(item)):
        assert sse.format_event(item, event) == jax_sse.format_event(
            item, event)
    assert sse.format_event({"t": object}) == jax_sse.format_event(
        {"t": object})


# ------------------------------------------------------------- routes
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# (method, path, body bytes or None, headers)
ROUTES = [
    ("POST", "/hello", b'{"a": 1}', {"Content-Type": "application/json"}),
    ("GET", "/hello?x=1&y=two&x=3", None, {}),
    ("POST", "/hello", b"plain text", {"Content-Type": "text/plain"}),
    ("POST", "/hello/deep/tail", b"[1, 2.5, null]", {}),
    ("PUT", "/hello", b'"s"', {}),
    ("GET", "/-/healthz", None, {}),
    ("POST", "/-/echo", b'{"e": [1, {"f": 2}]}', {}),
    ("POST", "/-/echo", b"not json", {}),
    ("GET", "/", None, {}),
    ("POST", "/-/stream/hello", b"not json", {}),
    ("POST", "/-/disagg/tiny", b"{oops", {}),
    ("POST", "/boom", b'{"a": 1}', {}),
]


def _ask(port, reqs):
    """Each request on one keep-alive connection: (status, content type
    without its charset, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    out = []
    try:
        for method, path, body, headers in reqs:
            conn.request(method, path, body=body, headers=headers)
            r = conn.getresponse()
            data = r.read()
            ctype = (r.getheader("Content-Type") or "").split(";")[0]
            out.append((r.status, ctype,
                        json.loads(data) if ctype == "application/json"
                        else data.decode()))
    finally:
        conn.close()
    return out


class _Ref:
    def __init__(self, deployment, payload):
        self.deployment, self.payload = deployment, payload


class _Handle:
    """ray_tpu's DeploymentHandle, for deployments ``hello`` (returns
    ``{"got": payload}``) and ``boom`` (raises)."""

    def __init__(self, deployment):
        self.deployment = deployment

    def try_remote(self, payload):
        return _Ref(self.deployment, payload)

    remote = try_remote


class _Worker:
    def add_ready_callback(self, ref, callback):
        callback()


def _get(ref, timeout=None):
    if ref.deployment == "boom":
        raise ValueError("bad input")
    return {"got": ref.payload}


@pytest.fixture(scope="module")
def jax_routes():
    """ray_tpu's aiohttp proxy in this process (its server thread stays
    up, idle, until the process exits: ray_tpu's proxy has no stop)."""
    import ray_tpu
    import ray_tpu.runtime.core_worker as jax_cw
    import ray_tpu.serve.http_proxy as jax_proxy
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_cw, "get_global_worker", lambda: _Worker())
    mp.setattr(ray_tpu, "get", _get)
    mp.setattr(jax_proxy, "DeploymentHandle", _Handle)
    try:
        port = _free_port()
        proxy = jax_proxy.HTTPProxyActor("127.0.0.1", port)
        assert proxy.ready()
        return _ask(port, ROUTES)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)

    @serve.deployment
    def hello(payload):
        return {"got": payload}

    @serve.deployment
    def boom(payload):
        raise ValueError("bad input")

    serve.run(hello.bind(), http_options=HTTPOptions(port=0))
    serve.run(boom.bind())
    proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=SERVE_NAMESPACE)
    _, port = ray_tpu_torch.get(proxy.address.remote(), timeout=TIMEOUT)
    yield port
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_routes_match_ray_tpu(cluster, jax_routes):
    got = _ask(cluster, ROUTES)
    for req, ours, theirs in zip(ROUTES, got, jax_routes, strict=True):
        if req[1] == "/boom":
            # the runtime's error type wraps the deployment's
            assert ours[:2] == theirs[:2] == (500, "application/json")
            assert ours[2].keys() == theirs[2].keys() == {"error",
                                                          "message"}
            assert "bad input" in ours[2]["message"]
        else:
            assert ours == theirs, req
    assert got[0] == (200, "application/json", {"got": {"a": 1}})
    assert got[1][2] == {"got": {"x": "1", "y": "two"}}


def test_serve_start_http_reuses_the_proxy_and_bad_requests_close(cluster):
    serve.start(http=True)          # the proxy is up: nothing new starts
    assert _ask(cluster, ROUTES[5:6]) == [(200, "text/plain", "ok")]
    with socket.create_connection(("127.0.0.1", cluster)) as s:
        s.sendall(b"POST /hello HTTP/1.1\r\nContent-Length: x\r\n\r\n")
        assert s.recv(4096).startswith(b"HTTP/1.1 400 Bad Request")
        assert s.recv(4096) == b""          # and the server closed
    with socket.create_connection(("127.0.0.1", cluster)) as s:
        s.sendall(b"POST /hello HTTP/1.1\r\nTransfer-Encoding: chunked"
                  b"\r\n\r\n3\r\n{}\n\r\n0\r\n\r\n")
        assert s.recv(4096).startswith(b"HTTP/1.1 501 Not Implemented")
    # a body announced with Expect: 100-continue, sent in two pieces
    with socket.create_connection(("127.0.0.1", cluster)) as s:
        s.sendall(b"POST /hello HTTP/1.1\r\nContent-Length: 8\r\n"
                  b"Expect: 100-continue\r\nConnection: close\r\n\r\n")
        assert s.recv(4096) == b"HTTP/1.1 100 Continue\r\n\r\n"
        s.sendall(b'{"b"')
        time.sleep(0.05)
        s.sendall(b": 2}")
        reply = b""
        while chunk := s.recv(4096):
            reply += chunk
    assert reply.startswith(b"HTTP/1.1 200 OK")
    assert reply.endswith(b'{"got": {"b": 2}}')


# ------------------------------------------------------------------ SSE
def _events(raw: bytes):
    """(event name or None, data) per SSE frame."""
    out = []
    for frame in raw.decode().split("\n\n"):
        if not frame:
            continue
        name, data = None, None
        for line in frame.split("\n"):
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        out.append((name, data))
    return out


def _sse(port, path, request):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=json.dumps(request))
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type") == "text/event-stream"
        assert r.getheader("Transfer-Encoding") == "chunked"
        events = _events(r.read())
    finally:
        conn.close()
    toks = [d["token"] for name, d in events if name is None]
    (done,) = [d for name, d in events if name == "done"]
    assert done["num_tokens"] == len(toks) and not [
        n for n, _ in events if n not in (None, "done")]
    return toks, done


def _requests(new=NEW):
    return [{"prompt": p, "max_new_tokens": new, "temperature": 0.0}
            for p in PROMPTS]


class _LoadServer(LLMServer):
    """LLMServer with one read-only method: the engine's slot counts."""

    def load(self):
        return self.engine.load_snapshot()


@pytest.fixture(scope="module")
def llm(cluster):
    app = build_app("tiny", paged=True, warmup_prompt_lens=[3], **ENGINE)
    dep = app.deployment
    serve.run(Deployment(_LoadServer, dep.name, dep.config).bind(
        *app.init_args, **app.init_kwargs))
    serve.run(build_app("tiny", disaggregated=True, prefill_replicas=1,
                        num_replicas=1, **ENGINE))
    return cluster


def test_sse_tokens_equal_the_handles(llm):
    handle = DeploymentHandle("llm-tiny")
    for req in _requests():
        items = [ray_tpu_torch.get(r, timeout=TIMEOUT)
                 for r in handle.stream.remote_streaming(req)]
        toks, done = _sse(llm, "/-/stream/llm-tiny", req)
        assert toks == [x["token"] for x in items[:-1]]
        assert done["finish_reason"] == items[-1]["finish_reason"]
        assert done["num_tokens"] == NEW


def test_sse_disaggregated_tokens_equal_disagg_handle(llm):
    dh = disagg_handle("tiny")

    async def one(req):
        return [x["token"] async for x in dh.stream(req) if "token" in x]

    async def main():
        return await asyncio.gather(*[one(r) for r in _requests()])
    want = asyncio.run(asyncio.wait_for(main(), TIMEOUT))
    for req, w in zip(_requests(), want, strict=True):
        toks, done = _sse(llm, "/-/disagg/tiny", req)
        assert toks == w and done["num_tokens"] == NEW


def test_client_disconnect_mid_stream_frees_the_slot(llm):
    """The client reads two tokens of a long stream and hangs up: the
    replica's busy slots return to 0 (the engine decodes the request to
    its end, as ray_tpu's does) and the proxy keeps serving."""
    handle = DeploymentHandle("llm-tiny")
    body = json.dumps({"prompt": [5, 6, 7], "max_new_tokens": 100,
                       "temperature": 0.0}).encode()
    with socket.create_connection(("127.0.0.1", llm)) as s:
        s.sendall(b"POST /-/stream/llm-tiny HTTP/1.1\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while got.count(b"data: ") < 2:
            got += s.recv(4096)
    assert got.startswith(b"HTTP/1.1 200 OK")
    busy, deadline = None, time.monotonic() + 60
    while busy != 0 and time.monotonic() < deadline:
        busy = ray_tpu_torch.get(handle.load.remote(),
                                 timeout=TIMEOUT)["busy_slots"]
        time.sleep(0.1)
    assert busy == 0
    toks, _ = _sse(llm, "/-/stream/llm-tiny", _requests(2)[0])
    assert len(toks) == 2
