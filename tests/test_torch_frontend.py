"""The port's asyncio streaming front end (``serving/frontend.py``) over the
port's engine on the CPU: the six scenarios of the JAX
``tests/test_frontend.py``.

In-process streaming and the HTTP round trip on 127.0.0.1 (port 0) give
streams whose tokens equal what the port's engine decodes offline
(``run``) for the same prompts; a client that disconnects (generator
closed, or socket dropped after its first token) cancels its request and
the pool drains to the index's pages; malformed requests get JAX's 4xx
answers and never reach the engine; ``submit_threadsafe`` validates on the
calling thread; canceling a queued uid before the engine drains it emits
"canceled".  A seventh test (the JAX ``tests/test_telemetry.py`` live
endpoints) fetches ``/metrics`` and the debug views mid-stream.  Every
wait has its own timeout, so a hang fails the test.
"""
import asyncio

import numpy as np
import pytest
import torch

from _torch_parity import port_cfg, port_params
from repro_torch.core.strategy import SPACache
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.frontend import (AsyncFrontend, fetch_stats,
                                          stream_request)
from repro_torch.serving.slo import SLO, SLOPolicy

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
WAIT = 60.0        # seconds any one scenario may take


@pytest.fixture(scope="module")
def model(tiny_cfg, tiny_params):
    cfg = port_cfg(tiny_cfg)
    return cfg, port_params(tiny_params, cfg)


def _engine(model, max_batch=2):
    cfg, params = model
    return ServingEngine(
        cfg, params, max_batch=max_batch, canvas_len=CANVAS,
        strategy=SPACache(rank=16, schedule="uniform", rho_peak=0.3,
                          refresh_interval=1),
        pool_pages=max_batch * (CANVAS // PAGE) + 1, page_size=PAGE,
        prefix_cache=True, slo_policy=SLOPolicy(), device="cpu")


def _offline(model, prompts, gen_len):
    """What the port's engine decodes for ``prompts`` served offline."""
    eng = _engine(model)
    for p in prompts:
        eng.submit(p, gen_len)
    eng.run()
    return {tuple(int(t) for t in r.prompt): r.output for r in eng.done}


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, WAIT))


async def _stop(front):
    await front.stop(timeout=WAIT / 2)


def test_frontend_streams_tokens_in_process(model):
    """generate() yields per-token events as decode progresses, ending in
    one "done" whose reassembled stream equals the offline output."""
    eng = _engine(model)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model[0].vocab_size - 1, 4)
               .astype(np.int32) for _ in range(3)]

    async def client(front, prompt):
        stream, kinds = {}, []
        async for ev in front.generate(prompt, 6, slo=SLO(ttft=60.0)):
            kinds.append(ev.kind)
            if ev.kind == "token":
                for pos, tok in zip(ev.positions, ev.tokens):
                    assert pos not in stream      # no duplicates
                    stream[pos] = tok
        return kinds, stream

    async def main():
        front = AsyncFrontend(eng, max_steps=2048)
        await front.start()
        try:
            return await asyncio.gather(*(client(front, p)
                                          for p in prompts))
        finally:
            await _stop(front)

    results = _run(main())
    want = _offline(model, prompts, 6)
    assert len(eng.done) == 3
    for (kinds, stream), prompt in zip(results, prompts):
        assert kinds[-1] == "done" and kinds.count("done") == 1
        assert len(kinds) > 2                     # streamed, not batched
        got = np.asarray([stream[i] for i in sorted(stream)])
        np.testing.assert_array_equal(
            got, want[tuple(int(t) for t in prompt)])
    assert eng.pool.used == eng.prefix.held_pages
    assert eng.stats.slo_met == 3


def test_frontend_http_roundtrip(model):
    """POST /generate streams ndjson over a localhost socket; GET /stats
    reports the TTFT / TPOT percentiles."""
    eng = _engine(model)
    prompt = np.random.default_rng(1).integers(
        0, model[0].vocab_size - 1, 4).astype(np.int32)

    async def main():
        front = AsyncFrontend(eng, max_steps=2048)
        await front.start(serve_http=True)
        try:
            events = [ev async for ev in stream_request(
                front.host, front.port, prompt, 6,
                slo={"ttft": 60.0, "deadline": 240.0})]
            stats = await fetch_stats(front.host, front.port)
        finally:
            await _stop(front)
        return events, stats

    events, stats = _run(main())
    assert events[-1]["kind"] == "done"
    stream = {pos: tok for ev in events if ev["kind"] == "token"
              for pos, tok in zip(ev["positions"], ev["tokens"])}
    assert sorted(stream) == list(range(6))
    got = np.asarray([stream[i] for i in range(6)])
    np.testing.assert_array_equal(got, eng.done[0].output)
    np.testing.assert_array_equal(
        got, _offline(model, [prompt], 6)[tuple(int(t) for t in prompt)])
    assert stats["requests_done"] == 1
    for key in ("ttft_p50", "ttft_p95", "tpot_p50", "tpot_p95"):
        assert key in stats
    assert stats["ttft_p50"] > 0.0


def test_frontend_disconnect_cancels_request(model):
    """A client that hangs up mid-stream (HTTP) or closes its generator
    (in-process) cancels its request; pages and prefix holds are
    released."""
    eng = _engine(model)
    rng = np.random.default_rng(2)
    pr = [rng.integers(0, model[0].vocab_size - 1, 4).astype(np.int32)
          for _ in range(2)]

    async def main():
        front = AsyncFrontend(eng, max_steps=2048)
        await front.start(serve_http=True)
        try:
            agen = front.generate(pr[0], 10)
            async for ev in agen:
                if ev.kind == "token":
                    break
            await agen.aclose()
            hgen = stream_request(front.host, front.port, pr[1], 10)
            async for ev in hgen:
                if ev["kind"] == "token":
                    break
            await hgen.aclose()
            while eng.stats.requests_canceled < 2:   # until both land
                await asyncio.sleep(0.05)
        finally:
            await _stop(front)

    _run(main())
    assert eng.stats.requests_canceled == 2
    assert eng.stats.requests_done == 0
    assert all(r.canceled and r.output is None for r in eng.done)
    assert eng.pool.used == eng.prefix.held_pages
    eng.drop_prefix_cache()
    assert eng.pool.used == 0


async def _raw(host, port, payload: bytes) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, BrokenPipeError):
        pass
    return raw


def test_frontend_rejects_malformed_requests(model):
    """Hostile bytes get clean 4xx responses (never a half-written stream
    or an engine-thread exception), and the server keeps serving."""
    eng = _engine(model)
    prompt = np.random.default_rng(4).integers(
        0, model[0].vocab_size - 1, 4).astype(np.int32)

    def post(body: bytes, clen=None) -> bytes:
        clen = len(body) if clen is None else clen
        return (f"POST /generate HTTP/1.1\r\nHost: x\r\n"
                f"Content-Length: {clen}\r\n\r\n").encode() + body

    cases = [
        (b"\r\n", b"400"),                              # no request line
        (post(b"{not json}"), b"400"),
        (post(b"[1, 2, 3]"), b"400"),                   # not an object
        (post(b'{"prompt": "abc", "gen_len": 4}'), b"400"),
        (post(b'{"prompt": [1, true], "gen_len": 4}'), b"400"),
        (post(b'{"prompt": [1, 2], "gen_len": 0}'), b"400"),
        (post(b'{"prompt": [1, 2]}'), b"400"),          # missing gen_len
        (post(b"x", clen=4096), b"413"),                # body > max_body
        ((b"POST /generate HTTP/1.1\r\nHost: x\r\n"
          b"Content-Length: nope\r\n\r\n"), b"400"),
        (b"GET /nowhere HTTP/1.1\r\n\r\n", b"404"),
    ]

    async def main():
        front = AsyncFrontend(eng, max_steps=2048, max_body=1024)
        await front.start(serve_http=True)
        try:
            results = []
            for payload, code in cases:
                raw = await _raw(front.host, front.port, payload)
                results.append((raw.split(b"\r\n", 1)[0], code))
            events = [ev async for ev in stream_request(
                front.host, front.port, prompt, 6)]
        finally:
            await _stop(front)
        return results, events

    results, events = _run(main())
    for status_line, code in results:
        assert code in status_line, (status_line, code)
    assert events[-1]["kind"] == "done"
    assert eng.stats.requests_done == 1   # junk never reached the engine


def test_submit_threadsafe_validates_on_caller(model):
    """Invalid submissions raise on the calling thread; nothing reaches
    the engine's queue."""
    eng = _engine(model)
    good = np.asarray([1, 2], np.int32)
    with pytest.raises(ValueError):
        eng.submit_threadsafe(good, 0)                  # gen_len <= 0
    with pytest.raises(ValueError):
        eng.submit_threadsafe(good, True)               # bool is not int
    with pytest.raises(ValueError):
        eng.submit_threadsafe(good, CANVAS + 1)         # over canvas
    with pytest.raises(ValueError):
        eng.submit_threadsafe(np.asarray([[1], [2]], np.int32), 4)
    with pytest.raises(ValueError):
        eng.submit_threadsafe(np.asarray([1.5, 2.0]), 4)
    eng._drain_mailbox()
    assert not eng.queue


def test_submit_threadsafe_and_cancel_queued(model):
    """Mailbox intake from a foreign thread; canceling the queued uid
    before the engine drains it aborts cleanly with a "canceled" event."""
    import threading
    eng = _engine(model)
    events, uids = [], []
    prompt = np.random.default_rng(3).integers(
        0, model[0].vocab_size - 1, 4).astype(np.int32)

    def remote():
        uid = eng.submit_threadsafe(prompt, 6, stream=True,
                                    sink=events.append)
        eng.cancel_threadsafe(uid)
        uids.append(uid)

    t = threading.Thread(target=remote)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive() and uids == [0]
    eng._drain_mailbox()
    assert eng.stats.requests_canceled == 1
    assert [ev.kind for ev in events] == ["canceled"]
    assert not eng.queue and eng.done[0].canceled


def test_live_metrics_and_debug_endpoints(model):
    """``/metrics``, ``/debug/requests`` and ``/debug/pool`` fetched while
    a request streams: Prometheus text and JSON, with the live request."""
    import re

    from repro_torch.serving.frontend import (fetch_debug_pool,
                                              fetch_debug_requests,
                                              fetch_metrics)
    from repro_torch.serving.telemetry import Telemetry
    cfg, params = model
    eng = ServingEngine(cfg, params, max_batch=2, canvas_len=CANVAS,
                        strategy=SPACache(rank=16, schedule="uniform",
                                          rho_peak=0.3, refresh_interval=1),
                        pool_pages=13, page_size=PAGE, prefix_cache=True,
                        telemetry=Telemetry.enabled(dynamics_every=1),
                        device="cpu")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size - 1, 6).astype(np.int32)

    async def main():
        front = AsyncFrontend(eng, max_steps=2048)
        await front.start(serve_http=True)
        try:
            mid = None
            async for ev in stream_request(front.host, front.port, prompt,
                                           6):
                if ev["kind"] == "token" and mid is None:
                    mid = (await fetch_metrics(front.host, front.port),
                           await fetch_debug_requests(front.host,
                                                      front.port),
                           await fetch_debug_pool(front.host, front.port))
            end = await fetch_metrics(front.host, front.port)
        finally:
            await _stop(front)
        return mid, end

    (mid_text, mid_reqs, mid_pool), end_text = _run(main())
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$")
    for text in (mid_text, end_text):
        assert text.endswith("\n")
        for line in text.rstrip("\n").split("\n"):
            if not line.startswith("# "):
                assert sample.match(line), line
                float(line.rsplit(" ", 1)[1])
        assert 'spa_engine_ttft_seconds_bucket{le="+Inf"}' in text
    assert set(mid_reqs) == {"queued", "running", "done"}
    assert [r["uid"] for r in mid_reqs["running"]] == [0]
    assert mid_pool["paged"] and mid_pool["pool"]["used"] > 0
    m = re.search(r"^spa_engine_requests_done_total (\d+)$", end_text, re.M)
    assert m and int(m.group(1)) == 1
