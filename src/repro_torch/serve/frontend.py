"""Streaming HTTP serving front-end (stdlib asyncio, no dependencies).

Ported from ``repro.serve.frontend``. The asyncio EDGE and the threaded
RUNTIME are bridged per request by one ``asyncio.Queue``: the scheduler's
streaming hooks (``Request.on_token`` / ``on_finish``) run on a worker
thread UNDER the scheduler lock, so each hook is an O(1)
``loop.call_soon_threadsafe`` handoff into the queue, and the edge
coroutine drains it into server-sent events. Tokens carry their index — an
evicted request replays deterministically from index 0 on its re-run, and
the edge dedupes by index, so the client stream is exactly-once even across
evictions.

Routes (HTTP/1.1, one request per connection):

* ``POST /v1/generate`` — body ``{"prompt": [ints] | "text",
  "max_new_tokens": N, "slo": "interactive"|"batch"}``; a string prompt is
  byte-encoded mod vocab (the repro has no tokenizer).  Streams SSE:
  ``start`` (request id), ``token`` (index + id) per token, ``done``
  (final state, counts, cancel latency).
* ``DELETE /v1/requests/<id>`` — explicit mid-flight cancellation.
* ``GET /healthz`` — queue depth, active set, pool pressure, drain state.

Cancellation end-to-end: client disconnect (the edge watches the reader
for EOF while streaming) or DELETE marks ``Request.cancelled``; the
scheduler finalizes at the next safe point and pages release through the
refcount/era path — see the reference's docs/frontend.md for the safety
argument (why a mid-step cancel can never free a page under a live era
reservation).

Backpressure: admission is refused with ``429 Retry-After`` when the
scheduler queue is deeper than ``max_pending`` (default ``4 * max_batch``)
or when the pool is pressured (free blocks below ``min_free_blocks``
while a queue already exists — queued work will consume them first).
During a rolling drain new work gets ``503``.

``python -m repro_torch.serve.frontend --selftest`` boots a reduced-config
server end-to-end (stream one request, disconnect-cancel a second,
DELETE-cancel a third, drain, assert ``unreclaimed == 0``) on the CUDA
device; ``--device cpu`` runs it on the CPU instead.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import Dict, Optional, Tuple

from .runtime import ServeRuntime

__all__ = ["Frontend"]

#: seconds a 429 asks the client to back off before resubmitting
RETRY_AFTER_S = 1

#: hard ceiling on one streamed response (safety net: a wedged worker
#: fleet must not leak edge coroutines forever)
STREAM_TIMEOUT_S = 300.0


def _sse(event: str, data: dict) -> bytes:
    return f"event: {event}\ndata: {json.dumps(data)}\n\n".encode()


def _resp(status: str, body: dict,
          extra: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    payload = (json.dumps(body) + "\n").encode()
    head = [f"HTTP/1.1 {status}",
            "Content-Type: application/json",
            f"Content-Length: {len(payload)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in extra]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + payload


_SSE_HEAD = (b"HTTP/1.1 200 OK\r\n"
             b"Content-Type: text/event-stream\r\n"
             b"Cache-Control: no-store\r\n"
             b"Connection: close\r\n\r\n")


class Frontend:
    """Asyncio edge over a persistent ``ServeRuntime``.

    ``start()`` boots the runtime's worker fleet and binds the listener;
    ``shutdown()`` runs the rolling drain (close admission, finish or
    deadline-cancel in-flight work, reclaim everything) and returns the
    runtime stats — ``unreclaimed`` MUST be 0 there.
    """

    def __init__(self, runtime: ServeRuntime, *, host: str = "127.0.0.1",
                 port: int = 8000, max_pending: Optional[int] = None,
                 min_free_blocks: Optional[int] = None):
        self.runtime = runtime
        self.engine = runtime.engine
        self.host = host
        self.port = port
        # admission thresholds — the reference's docs/frontend.md
        # §Backpressure
        self.max_pending = (4 * self.engine.max_batch
                            if max_pending is None else max_pending)
        self.min_free_blocks = (max(1, self.engine.pool.n_blocks // 16)
                                if min_free_blocks is None
                                else min_free_blocks)
        self.requests: Dict[int, object] = {}  # rid -> live Request
        self._server: Optional[asyncio.base_events.Server] = None

    # --------------------------------------------------------------- lifecycle
    async def start(self) -> int:
        """Boot workers + listener; returns the bound port (for port=0)."""
        if not self.runtime.running:
            self.runtime.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, deadline_s: Optional[float] = None) -> dict:
        """Rolling drain: stop accepting, drain/cancel per the deadline,
        reclaim, and return the runtime stats (``unreclaimed`` == 0)."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # the drain blocks on worker joins — keep the loop responsive so
        # in-flight SSE handlers can finish streaming during it
        return await asyncio.to_thread(self.runtime.drain, deadline_s)

    # ------------------------------------------------------------- HTTP layer
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                    ConnectionError):
                return
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, path, _ = lines[0].split(" ", 2)
            except ValueError:
                writer.write(_resp("400 Bad Request",
                                   {"error": "malformed request line"}))
                return
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            body = b""
            clen = int(headers.get("content-length", 0) or 0)
            if clen:
                body = await reader.readexactly(clen)

            if method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, body)
            elif method == "DELETE" and path.startswith("/v1/requests/"):
                self._cancel_route(writer, path)
            elif method == "GET" and path == "/healthz":
                writer.write(_resp("200 OK", self._health()))
            else:
                writer.write(_resp("404 Not Found", {"error": "no route",
                                                     "path": path}))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away mid-response: nothing left to tell it
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _health(self) -> dict:
        sched = self.engine.sched
        health = {"pending": sched.pending(),
                  "active": len(sched.active),
                  "free_blocks": self.engine.pool.free_blocks,
                  "n_blocks": self.engine.pool.n_blocks,
                  "draining": self.runtime.draining,
                  "live_streams": len(self.requests),
                  # crash tolerance: liveness per worker slot, respawn and
                  # crash counters — a monitor alerting on alive=false or
                  # a rising n_respawns sees degradation before an outage
                  "workers": self.runtime.worker_status(),
                  "n_respawns": self.runtime.n_respawns,
                  "worker_crashes": len(self.runtime.crashed_tids)}
        if self.engine.faults is not None:
            health["faults"] = self.engine.faults.stats()
        return health

    def _cancel_route(self, writer: asyncio.StreamWriter, path: str) -> None:
        try:
            rid = int(path.rsplit("/", 1)[1])
        except ValueError:
            writer.write(_resp("400 Bad Request", {"error": "bad id"}))
            return
        req = self.requests.get(rid)
        if req is None:
            writer.write(_resp("404 Not Found", {"error": "unknown request",
                                                 "id": rid}))
            return
        # False = already finished/cancelled — report it; idempotent either way
        writer.write(_resp("200 OK",
                           {"id": rid, "cancelled": self.runtime.cancel(req)}))

    # ---------------------------------------------------------- streaming path
    def _admission_error(self) -> Optional[bytes]:
        if self.runtime.draining:
            return _resp("503 Service Unavailable",
                         {"error": "draining: not accepting new requests"})
        sched = self.engine.sched
        pending = sched.pending()
        if pending >= self.max_pending:
            return _resp("429 Too Many Requests",
                         {"error": "queue full", "pending": pending,
                          "max_pending": self.max_pending},
                         extra=(("Retry-After", str(RETRY_AFTER_S)),))
        # pool pressure: below the free-block floor, queued work will
        # consume what's left before a new request could run — shed at the
        # edge instead of stacking another eviction-ladder victim
        if pending > 0 \
                and self.engine.pool.free_blocks < self.min_free_blocks:
            return _resp("429 Too Many Requests",
                         {"error": "pool pressure",
                          "free_blocks": self.engine.pool.free_blocks,
                          "min_free_blocks": self.min_free_blocks},
                         extra=(("Retry-After", str(RETRY_AFTER_S)),))
        return None

    def _parse_generate(self, body: bytes) -> Tuple[list, int, str]:
        spec = json.loads(body.decode())
        prompt = spec["prompt"]
        if isinstance(prompt, str):  # no tokenizer in the repro: bytes mod V
            vocab = self.engine.cfg.vocab_size
            prompt = [b % vocab for b in prompt.encode()]
        if not (isinstance(prompt, list) and prompt
                and all(isinstance(t, int) for t in prompt)):
            raise ValueError("prompt must be a non-empty token list or str")
        max_new = int(spec.get("max_new_tokens", 16))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        slo = spec.get("slo", "interactive")
        return prompt, max_new, slo

    async def _generate(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, body: bytes) -> None:
        err = self._admission_error()
        if err is not None:
            writer.write(err)
            return
        try:
            prompt, max_new, slo = self._parse_generate(body)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            writer.write(_resp("400 Bad Request", {"error": str(e)}))
            return

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        # both hooks run on a WORKER thread under the scheduler lock:
        # strictly O(1) handoffs, all state captured at call time
        def on_token(req, index, tok):
            try:
                loop.call_soon_threadsafe(q.put_nowait,
                                          ("token", index, tok))
            except RuntimeError:
                pass  # loop gone (shutdown race): stream is dead anyway

        def on_finish(req):
            fin = ("finish", req.state, len(req.generated),
                   req.cancel_latency)
            try:
                loop.call_soon_threadsafe(q.put_nowait, fin)
            except RuntimeError:
                pass

        try:
            req = self.runtime.submit(prompt, max_new, slo=slo,
                                      on_token=on_token, on_finish=on_finish)
        except RuntimeError as e:  # drain began between the check and here
            writer.write(_resp("503 Service Unavailable", {"error": str(e)}))
            return
        self.requests[req.rid] = req

        writer.write(_SSE_HEAD)
        writer.write(_sse("start", {"id": req.rid,
                                    "prompt_tokens": len(prompt),
                                    "max_new_tokens": max_new, "slo": slo}))
        try:
            await writer.drain()
        except ConnectionError:
            self.runtime.cancel(req)

        # EOF on the read side = client disconnect (the SSE client sends
        # nothing after its request): first-class cancellation signal
        eof = asyncio.ensure_future(reader.read(1))
        next_index = 0  # dedupe across eviction replays
        deadline = loop.time() + STREAM_TIMEOUT_S
        finished = False
        try:
            while not finished:
                get = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {get, eof}, timeout=max(0.0, deadline - loop.time()),
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:  # stream timeout: treat as an edge cancel
                    get.cancel()
                    self.runtime.cancel(req)
                    break
                if eof in done and get not in done:
                    get.cancel()
                    self.runtime.cancel(req)
                    # keep draining until on_finish confirms finalization
                    # (pages released); nothing more is written to the wire
                    while True:
                        try:
                            item = await asyncio.wait_for(q.get(), 30.0)
                        except asyncio.TimeoutError:
                            break
                        if item[0] == "finish":
                            break
                    break
                item = get.result()
                if item[0] == "token":
                    _, index, tok = item
                    if index < next_index:
                        continue  # eviction replay: already delivered
                    next_index = index + 1
                    writer.write(_sse("token", {"index": index, "token": tok}))
                    try:
                        await writer.drain()
                    except ConnectionError:
                        self.runtime.cancel(req)
                else:
                    _, state, n_tokens, cancel_latency = item
                    finished = True
                    # graceful degradation: a request failed by the engine
                    # (non-finite sampled output) terminates its stream
                    # with an `error` frame — the batch, and every other
                    # stream, carries on
                    writer.write(_sse(
                        "error" if state == "failed" else "done", {
                            "id": req.rid, "state": state,
                            "n_tokens": n_tokens,
                            "cancel_latency_ms":
                                None if cancel_latency is None
                                else round(1e3 * cancel_latency, 3)}))
                    try:
                        await writer.drain()
                    except ConnectionError:
                        pass
        finally:
            eof.cancel()
            self.requests.pop(req.rid, None)


# ---------------------------------------------------------------- entrypoint
def _build_runtime(args) -> ServeRuntime:
    """The reduced-config engine and its runtime, on ``args.device`` (CUDA
    unless the caller names another); seeded random weights."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from .engine import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    fault_spec = getattr(args, "fault_spec", None)
    engine = ServeEngine(cfg, params, n_blocks=args.n_blocks,
                         block_size=args.block_size,
                         max_batch=args.max_batch, scheme=args.scheme,
                         n_shards=args.shards, chunk_size=args.chunk_size,
                         # respawns burn fresh tids: leave real headroom
                         # whenever faults are armed
                         max_threads=max(16 if fault_spec else 8,
                                         args.workers + 2),
                         max_inflight=max(4, args.workers),
                         era_freq=2, cleanup_freq=2, device=dev)
    if fault_spec:
        from .faults import FaultInjector, FaultSpec
        engine.set_fault_injector(FaultInjector(FaultSpec.parse(fault_spec)))
    return ServeRuntime(engine, n_workers=args.workers,
                        max_steps_per_worker=1_000_000)


async def _read_sse(reader, *, until_tokens: Optional[int] = None):
    """Minimal SSE client: yields (event, data) until `done` or EOF; with
    ``until_tokens`` set, returns after that many token events."""
    events = []
    event = None
    n_tokens = 0
    while True:
        line = await reader.readline()
        if not line:
            return events
        line = line.decode().strip()
        if line.startswith("event:"):
            event = line.split(":", 1)[1].strip()
        elif line.startswith("data:"):
            data = json.loads(line.split(":", 1)[1])
            events.append((event, data))
            if event == "token":
                n_tokens += 1
                if until_tokens is not None and n_tokens >= until_tokens:
                    return events
            if event in ("done", "error"):
                return events


async def _post_generate(port: int, spec: dict):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(spec).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\n"
                  f"Host: localhost\r\nContent-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = (await reader.readline()).decode()
    while (await reader.readline()).strip():  # skip headers
        pass
    return status, reader, writer


async def _http_json(port: int, method: str, path: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: l\r\n\r\n".encode())
    await writer.drain()
    status = (await reader.readline()).decode()
    body = b""
    in_body = False
    while True:
        line = await reader.readline()
        if not line:
            break
        if in_body:
            body += line
        elif not line.strip():
            in_body = True
    writer.close()
    return status, (json.loads(body) if body else None)


async def _selftest(frontend: Frontend) -> int:
    """Server smoke: stream one request to completion, disconnect-cancel
    a second mid-stream, DELETE-cancel a third, drain, unreclaimed==0."""
    port = await frontend.start()
    print(f"selftest: listening on {port}")

    # 1. one request streamed to completion
    status, reader, writer = await _post_generate(
        port, {"prompt": [3 * i % 97 for i in range(1, 7)],
               "max_new_tokens": 8})
    assert "200" in status, status
    events = await _read_sse(reader)
    writer.close()
    toks = [d for e, d in events if e == "token"]
    done = [d for e, d in events if e == "done"]
    assert len(toks) == 8 and [t["index"] for t in toks] == list(range(8)), \
        f"bad stream: {events}"
    assert done and done[0]["state"] == "done", events
    print(f"selftest: request {done[0]['id']} streamed 8 tokens, done")

    # 2. disconnect-cancel mid-stream (the Ctrl-C path)
    status, reader, writer = await _post_generate(
        port, {"prompt": [5 * i % 97 for i in range(1, 9)],
               "max_new_tokens": 64})
    assert "200" in status, status
    events = await _read_sse(reader, until_tokens=2)
    assert sum(1 for e, _ in events if e == "token") == 2, events
    writer.close()  # abrupt disconnect: the edge must cancel the request
    print("selftest: request 2 disconnected after 2 tokens")

    # 3. explicit DELETE-cancel mid-stream
    status, reader, writer = await _post_generate(
        port, {"prompt": "hello era-safe cancellation",
               "max_new_tokens": 64})
    assert "200" in status, status
    events = await _read_sse(reader, until_tokens=1)
    rid = next(d["id"] for e, d in events if e == "start")
    status, body = await _http_json(port, "DELETE", f"/v1/requests/{rid}")
    assert "200" in status and body["cancelled"], (status, body)
    tail = await _read_sse(reader)
    writer.close()
    done = [d for e, d in tail if e == "done"]
    assert done and done[0]["state"] == "cancelled", tail
    assert done[0]["cancel_latency_ms"] is not None, tail
    print(f"selftest: request {rid} DELETE-cancelled "
          f"(latency {done[0]['cancel_latency_ms']} ms)")

    # 4. wait for quiescence, then rolling drain
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30.0:
        _, health = await _http_json(port, "GET", "/healthz")
        if health["pending"] == 0 and health["active"] == 0:
            break
        await asyncio.sleep(0.05)
    stats = await frontend.shutdown(deadline_s=10.0)
    assert stats["unreclaimed"] == 0, f"leak at drain: {stats}"
    assert stats["cancelled"] >= 2, stats
    print(f"selftest: drained clean — unreclaimed=0, "
          f"completed={stats['completed']} cancelled={stats['cancelled']} "
          f"cancelled_blocks={stats['cancelled_blocks']}")
    print("selftest: PASS")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--scheme", default="WFE",
                    choices=("WFE", "Crystalline", "HE", "EBR", "2GEIBR"))
    ap.add_argument("--n-blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--fault-spec", default=None,
                    help="arm deterministic fault injection, e.g. "
                         "'seed=0,crash_rate=0.01,max_crashes=3' "
                         "(see serve/faults.py FaultSpec.parse)")
    ap.add_argument("--selftest", action="store_true",
                    help="boot on an ephemeral port, run the end-to-end "
                         "stream/cancel/drain smoke, exit 0 on PASS")
    args = ap.parse_args(argv)
    runtime = _build_runtime(args)
    if args.selftest:
        args.port = 0
        frontend = Frontend(runtime, host="127.0.0.1", port=0)
        return asyncio.run(_selftest(frontend))

    async def _serve():
        frontend = Frontend(runtime, host=args.host, port=args.port)
        port = await frontend.start()
        print(f"serving on http://{args.host}:{port} "
              f"(scheme={args.scheme}, {args.workers} workers; "
              f"POST /v1/generate streams SSE, Ctrl-C drains)")
        try:
            await frontend.serve_forever()
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        finally:
            stats = await frontend.shutdown(deadline_s=10.0)
            print(f"drained: unreclaimed={stats['unreclaimed']} "
                  f"completed={stats['completed']} "
                  f"cancelled={stats['cancelled']}")
    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
