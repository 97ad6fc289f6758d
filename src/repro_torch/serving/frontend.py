"""Async streaming front end of the serving engine (the JAX package's
``serving/frontend.py``).

An asyncio layer over :class:`~repro_torch.serving.engine.ServingEngine`
using only stdlib primitives (``asyncio`` streams for HTTP, a
``threading.Thread`` for the engine).  Three layers:

  * **Engine thread** — the blocking decode loop
    (``ServingEngine.run_online``) runs on a thread of its own, bound to the
    engine's CUDA device before its first launch; the kernels are built on
    the caller's thread before it starts (a build failure raises there).
    The asyncio side never touches engine state: submissions and cancels
    ride the engine's thread-safe mailbox (``submit_threadsafe`` /
    ``cancel_threadsafe``), drained at the engine's overlap point.
  * **Event bridge** — each request carries its own ``sink`` callback,
    attached before the engine can see the request.  The sink fires on the
    engine thread and hands every
    :class:`~repro_torch.serving.engine.RequestEvent` to the event loop
    with ``loop.call_soon_threadsafe`` into a per-request
    ``asyncio.Queue``; ``generate()`` is an async iterator over that queue.
  * **HTTP** — a small HTTP/1.1 server (``asyncio.start_server``):
    ``POST /generate`` streams newline-delimited JSON events
    (``Connection: close`` ends the body), ``GET /stats`` returns an
    engine-stats snapshot, ``GET /metrics`` the Prometheus text,
    ``GET /debug/requests`` and ``GET /debug/pool`` JSON views.  A dropped
    client connection cancels its request; pages and prefix holds are
    released mid-decode.

In-process use (no sockets)::

    front = AsyncFrontend(engine)
    async with front:                      # starts the engine thread
        async for ev in front.generate(prompt, gen_len=16, slo=slo):
            ...                            # ev.kind: token/done/...

Socket use: ``await front.start(serve_http=True)``, then point
``stream_request()`` at ``front.port``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
from typing import AsyncIterator, Dict, Optional

import numpy as np
import torch

from repro_torch.serving.engine import RequestEvent, ServingEngine
from repro_torch.serving.slo import SLO
from repro_torch.serving.telemetry import Histogram

_TERMINAL = ("done", "shed", "canceled", "aborted")


class AsyncFrontend:
    """Bridges asyncio clients onto a ServingEngine thread."""

    def __init__(self, engine: ServingEngine, *, host: str = "127.0.0.1",
                 port: int = 0, max_steps: int = 256,
                 idle_wait: float = 0.005, max_body: int = 1 << 20):
        self.engine = engine
        self.host = host
        self.port = port              # 0 = ephemeral; set after start()
        self.max_steps = max_steps
        self.idle_wait = idle_wait
        self.max_body = max_body      # request bodies past this → 413
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self.error: Optional[BaseException] = None   # engine thread's

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    async def start(self, serve_http: bool = False) -> "AsyncFrontend":
        assert self._thread is None, "frontend already started"
        self._loop = asyncio.get_running_loop()
        self._stop.clear()
        self.error = None
        device = self.engine.device
        index = None
        if device.type == "cuda":
            from repro_torch.kernels import _lib
            _lib.load()      # build here: a failure raises to the caller
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
        self._thread = threading.Thread(
            target=self._engine_loop, args=(index,),
            name="serving-engine", daemon=True)
        self._thread.start()
        if serve_http:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        return self

    def _engine_loop(self, cuda_index: Optional[int]) -> None:
        """The engine thread: bind the card (the current device is per
        thread), then serve until stopped.  An exception ends the thread
        and is kept in ``error``; ``stop()`` raises it."""
        try:
            if cuda_index is not None:
                torch.cuda.set_device(cuda_index)
            self.engine.run_online(stop=self._stop,
                                   max_steps=self.max_steps,
                                   idle_wait=self.idle_wait)
        except BaseException as e:          # reported by stop()
            self.error = e
            raise

    async def stop(self, timeout: Optional[float] = None) -> None:
        """Close the HTTP server and stop the engine thread (aborting the
        requests in flight); ``timeout`` bounds the wait for the thread."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self._stop.set()
        if self._thread is not None:
            # run_online wakes on its idle mailbox timeout
            thread = self._thread
            await asyncio.get_running_loop().run_in_executor(
                None, thread.join, timeout)
            if thread.is_alive():
                raise TimeoutError(
                    f"the serving engine thread did not stop within "
                    f"{timeout} s")
            self._thread = None
        if self.error is not None:
            raise RuntimeError("the serving engine thread failed") \
                from self.error

    async def __aenter__(self) -> "AsyncFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ------------------------------------------------------------------
    # Streaming generate
    # ------------------------------------------------------------------

    async def generate(self, prompt, gen_len: int, *,
                       priority: int = 0, slo: Optional[SLO] = None,
                       row_len: Optional[int] = None,
                       ) -> AsyncIterator[RequestEvent]:
        """Submit one request and yield its events ("token" batches,
        then exactly one terminal "done"/"shed"/"canceled").  Closing
        the iterator early (client gone) cancels the request on the
        engine."""
        assert self._loop is not None, "call start() first"
        q: asyncio.Queue = asyncio.Queue()
        loop = self._loop

        def sink(ev: RequestEvent) -> None:   # fires on engine thread
            loop.call_soon_threadsafe(q.put_nowait, ev)

        uid = self.engine.submit_threadsafe(
            np.asarray(prompt, np.int32), gen_len, priority=priority,
            slo=slo, row_len=row_len, stream=True, sink=sink)
        try:
            while True:
                ev = await q.get()
                yield ev
                if ev.kind in _TERMINAL:
                    return
        finally:
            # reached on early generator close / task cancellation too
            self.engine.cancel_threadsafe(uid)

    def stats_snapshot(self) -> Dict:
        """JSON-safe engine stats copy (reads race the engine thread
        benignly: ints and histogram appends under the GIL).  Scalar
        counters pass through; latency histograms surface as their
        counts, with percentiles merged on top."""
        s = self.engine.stats
        pct = s.percentiles()
        out: Dict = {}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            if isinstance(v, (bool, int, float)):
                out[f.name] = v
            elif isinstance(v, Histogram):
                out[f"{f.name}_count"] = len(v)
        out.update(pct)
        out["queued"] = len(self.engine.queue)
        out["running"] = len(self.engine._running)
        return out

    # ------------------------------------------------------------------
    # Minimal HTTP/1.1 layer (stdlib streams only)
    # ------------------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            request_line = (await reader.readline()).decode("latin1")
            if not request_line:
                return
            try:
                method, path, _ = request_line.split(None, 2)
            except ValueError:
                writer.write(_error_response(400, "malformed request line"))
                await writer.drain()
                return
            headers = {}
            while True:
                line = (await reader.readline()).decode("latin1").strip()
                if not line:
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            try:
                n = int(headers.get("content-length", 0) or 0)
            except ValueError:
                writer.write(_error_response(400, "bad Content-Length"))
                await writer.drain()
                return
            if n < 0 or n > self.max_body:
                # reject BEFORE reading: an oversized body never gets
                # buffered, it just costs the client its connection
                writer.write(_error_response(
                    413, f"body exceeds {self.max_body} bytes"))
                await writer.drain()
                return
            if n:
                body = await reader.readexactly(n)
            if method == "POST" and path == "/generate":
                await self._route_generate(writer, body)
            elif method == "GET" and path == "/stats":
                payload = json.dumps(self.stats_snapshot()).encode()
                writer.write(_response_head("application/json")
                             + payload)
                await writer.drain()
            elif method == "GET" and path == "/metrics":
                # Prometheus text exposition; the registry collector
                # reads live engine state under the GIL, the same benign
                # race as /stats
                payload = self.engine.render_metrics().encode()
                writer.write(_response_head(
                    "text/plain; version=0.0.4; charset=utf-8")
                    + payload)
                await writer.drain()
            elif method == "GET" and path == "/debug/requests":
                payload = json.dumps(
                    self.engine.request_states()).encode()
                writer.write(_response_head("application/json")
                             + payload)
                await writer.drain()
            elif method == "GET" and path == "/debug/pool":
                # pool/tier occupancy, fragmentation, per-signature bytes
                payload = json.dumps(
                    self.engine.pool_debug_state()).encode()
                writer.write(_response_head("application/json")
                             + payload)
                await writer.drain()
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Connection: close\r\n\r\n")
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, ValueError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _route_generate(self, writer: asyncio.StreamWriter,
                              body: bytes) -> None:
        # validate EVERYTHING before the 200 head goes out — a bad
        # request must get a clean 4xx, never a half-written stream
        try:
            req = json.loads(body.decode())
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            prompt = req["prompt"]
            if (not isinstance(prompt, list)
                    or not all(isinstance(t, int)
                               and not isinstance(t, bool)
                               for t in prompt)):
                raise ValueError("prompt must be a list of ints")
            gen_len = req["gen_len"]
            if (isinstance(gen_len, bool) or not isinstance(gen_len, int)
                    or gen_len <= 0):
                raise ValueError("gen_len must be a positive int")
            priority = int(req.get("priority", 0))
            row_len = req.get("row_len")
            if row_len is not None:
                row_len = int(row_len)
            slo = None
            if req.get("slo"):
                slo = SLO(
                    ttft=float(req["slo"].get("ttft", float("inf"))),
                    deadline=float(req["slo"].get("deadline",
                                                  float("inf"))))
        except (ValueError, KeyError, TypeError, AttributeError,
                UnicodeDecodeError) as e:
            writer.write(_error_response(400, f"bad request: {e}"))
            await writer.drain()
            return
        writer.write(_response_head("application/x-ndjson"))
        await writer.drain()
        agen = self.generate(prompt, gen_len, priority=priority,
                             slo=slo, row_len=row_len)
        try:
            # a dropped connection raises from drain(); the explicit
            # aclose() below (not GC) then cancels the request on the
            # engine
            async for ev in agen:
                writer.write(json.dumps(_event_json(ev)).encode()
                             + b"\n")
                await writer.drain()
        finally:
            await agen.aclose()


def _response_head(ctype: str) -> bytes:
    return (f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
            f"Connection: close\r\n\r\n").encode()


def _error_response(status: int, msg: str) -> bytes:
    reason = {400: "Bad Request",
              413: "Payload Too Large"}.get(status, "Error")
    body = json.dumps({"error": msg}).encode()
    return (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


def _event_json(ev: RequestEvent) -> Dict:
    return {"kind": ev.kind, "uid": ev.uid, "step": ev.step,
            "ts": ev.ts, "positions": list(ev.positions),
            "tokens": list(ev.tokens)}


# ----------------------------------------------------------------------
# Client helpers (launch/serve.py --client)
# ----------------------------------------------------------------------

async def stream_request(host: str, port: int, prompt, gen_len: int, *,
                         priority: int = 0,
                         slo: Optional[Dict] = None) -> AsyncIterator[Dict]:
    """Stream one request against a running front-end over HTTP; yields
    decoded ndjson event dicts."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps({
        "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
        "gen_len": gen_len, "priority": priority, "slo": slo,
    }).encode()
    writer.write((f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()
    try:
        # skip response headers
        while True:
            line = await reader.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
        while True:
            line = await reader.readline()
            if not line:
                return
            line = line.strip()
            if line:
                yield json.loads(line.decode())
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


async def _fetch(host: str, port: int, path: str) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Connection: close\r\n\r\n").encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = raw.partition(b"\r\n\r\n")
    return body


async def fetch_stats(host: str, port: int) -> Dict:
    return json.loads((await _fetch(host, port, "/stats")).decode())


async def fetch_metrics(host: str, port: int) -> str:
    """Raw Prometheus text from ``GET /metrics``."""
    return (await _fetch(host, port, "/metrics")).decode()


async def fetch_debug_requests(host: str, port: int) -> Dict:
    return json.loads(
        (await _fetch(host, port, "/debug/requests")).decode())


async def fetch_debug_pool(host: str, port: int) -> Dict:
    """Decoded JSON from ``GET /debug/pool``."""
    return json.loads(
        (await _fetch(host, port, "/debug/pool")).decode())
