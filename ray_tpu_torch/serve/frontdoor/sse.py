"""Server-sent-events streaming bridge (the port's copy of
ray_tpu/serve/frontdoor/sse.py; docs/serve_frontdoor.md).

Turns the serve layer's token async-generators (``DisaggHandle.stream``,
a colocated replica's streaming path) into an HTTP ``text/event-stream``
response.  Framing rules:

- ``{"token": id}`` items ship as default (unnamed) SSE messages — the
  high-rate payload stays one ``data:`` line per token;
- ``{"retry": n, ...}`` mid-stream recovery markers (a replica died
  under the stream and the router re-drove it) ship as ``event: retry``
  so a client can surface "reconnecting" without parsing payloads;
- the final summary dict ships as ``event: done``;
- a server-side failure ships as ``event: error`` and ends the stream.

The response is the port's own (``serve/http_proxy.py``: HTTP/1.1 over
``asyncio`` streams, ``Transfer-Encoding: chunked``), where ray_tpu
writes an aiohttp ``StreamResponse``.  Backpressure is per-connection:
every event is written as one chunk and the writer is drained, which
suspends the coroutine while the socket's buffer is over its high-water
mark — a slow client stalls only its own generator.  A client that
hangs up shows at a write or drain as a ``ConnectionError``.

The bridge also owns the ingress side of SLO accounting: it clocks
CLIENT-OBSERVED first-token and inter-token latency and closes the
request's ingress trace root with the verdict — these roots are what
the controller's re-roling policy reads per route
(``trace_stats()["slo_by_route"]``).

No torch, no aiohttp: the standard library only.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, AsyncIterator, Dict, Optional

from ray_tpu_torch.util.tracing import tracing_helper as trh

SSE_HEADERS = {
    "Content-Type": "text/event-stream",
    "Cache-Control": "no-cache",
    # proxies (nginx) buffer unnamed content types; SSE must flush
    "X-Accel-Buffering": "no",
}


def format_event(data: Any, event: Optional[str] = None) -> bytes:
    """One SSE frame: optional ``event:`` name + one JSON ``data:``
    line.  Compact separators — the token path ships thousands of
    these per stream."""
    payload = json.dumps(data, separators=(",", ":"), default=str)
    head = f"event: {event}\n" if event else ""
    return f"{head}data: {payload}\n\n".encode()


def classify(item: Dict[str, Any]) -> Optional[str]:
    """SSE event name for one stream item (None = default message)."""
    if "token" in item:
        return None
    if "retry" in item:
        return "retry"
    return "done"


async def stream_sse(request, agen: AsyncIterator[Dict[str, Any]], *,
                     route: str, pool: str = "sse", root=None):
    """Bridge ``agen`` onto an SSE response for ``request``.

    ``root`` is the proxy's ingress trace root (or None when tracing is
    off): closed here with client-observed TTFT/TPOT and the outcome —
    OK on a drained stream, CANCELLED when the client hung up (socket
    reset / task cancellation; not a service failure, excluded from
    both SLO counters), ERROR when the generator raised.  ``request``
    is the proxy's; its ``stream_response`` starts the chunked reply."""
    resp = request.stream_response(dict(SSE_HEADERS))
    await resp.prepare()
    t0 = time.perf_counter()
    first = last = None
    ntok = 0
    failure: Optional[BaseException] = None
    try:
        async for item in agen:
            ev = classify(item)
            if ev is None:
                now = time.perf_counter()
                if first is None:
                    first = now
                last = now
                ntok += 1
            await resp.write(format_event(item, ev))
        await resp.write_eof()
    except (ConnectionError, asyncio.CancelledError) as e:
        failure = e                      # client walked away mid-stream
    except Exception as e:  # noqa: BLE001 - surfaced as an SSE error event
        failure = e
        try:
            await resp.write(format_event(
                {"error": type(e).__name__, "message": str(e)}, "error"))
            await resp.write_eof()
        except (ConnectionError, asyncio.CancelledError):
            pass
    finally:
        aclose = getattr(agen, "aclose", None)
        if aclose is not None:
            try:
                await aclose()
            except Exception:
                pass
        if root is not None:
            if failure is None:
                status = trh.OK
            elif isinstance(failure, (ConnectionError,
                                      asyncio.CancelledError)):
                status = trh.CANCELLED
            else:
                status = trh.ERROR
            tpot_s = None
            if ntok > 1 and first is not None:
                tpot_s = (last - first) / (ntok - 1)
            trh.finish_request(
                root, pool=pool, route=route, status=status,
                ttft_s=(first - t0) if first is not None else None,
                tpot_s=tpot_s, num_tokens=ntok,
                error_type=(type(failure).__name__
                            if failure is not None else None),
                dossier_id=getattr(failure, "dossier_id", None))
        if isinstance(failure, asyncio.CancelledError):
            raise failure
    return resp
