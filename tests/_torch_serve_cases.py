"""Programs that run on either runtime's streaming and serve layers, for
tests/test_torch_stream.py, tests/test_torch_serve.py and
tests/test_torch_serve_llm.py.

Each program takes the package name (``"ray_tpu"`` or ``"ray_tpu_torch"``),
imports that package inside, and returns plain values the tests compare.
This module imports neither package at the top, so the tests pickle it by
value and a port worker never imports jax. Every HTTP proxy binds port 0."""

import asyncio
import importlib
import json
import os
import socket
import time


def _rt(pkg):
    return importlib.import_module(pkg)


def _serve(pkg):
    return importlib.import_module(pkg + ".serve")


def _http0(pkg):
    return _serve(pkg).HTTPOptions(port=0)


# ---- streaming generator tasks ----------------------------------------------


def gen_squares(n):
    for i in range(n):
        yield i * i


def gen_slow(n, delay_s):
    for i in range(n):
        yield i
        time.sleep(delay_s)


def gen_boom():
    yield 1
    yield 2
    raise RuntimeError("boom at 3")


def gen_arrays(n, shape):
    import numpy as np

    for i in range(n):
        yield np.full(shape, i, dtype=np.float32)


def gen_counter(path, n):
    for i in range(n):
        with open(path, "a") as f:
            f.write(f"{i}\n")
        yield i


def gen_tensors(n):
    import torch

    g = torch.Generator().manual_seed(7)
    for i in range(n):
        yield torch.randn(64, 32, generator=g) * (i + 1)


def stream_items(pkg):
    """100 items in order, and the first of a slow stream before its
    producer ends."""
    rt = _rt(pkg)
    squares = rt.remote(num_returns="streaming")(gen_squares)
    items = [rt.get(r) for r in squares.remote(100)]
    slow = rt.remote(num_returns="streaming")(gen_slow)
    t0 = time.monotonic()
    stream = slow.remote(5, 0.2)
    first = rt.get(next(iter(stream)))
    early = time.monotonic() - t0 < 0.9
    rest = [rt.get(r) for r in stream]
    return {"items": items, "first": first, "early": early, "rest": rest}


def stream_error(pkg):
    """Items before a mid-stream raise arrive; the raise arrives as the
    next item's error."""
    rt = _rt(pkg)
    refs = list(rt.remote(num_returns="streaming")(gen_boom).remote())
    out = [rt.get(refs[0]), rt.get(refs[1])]
    try:
        rt.get(refs[2])
    except Exception as e:  # noqa: BLE001 — the compared outcome
        out.append(("raised", "boom at 3" in str(e)))
    return {"n_refs": len(refs), "out": out}


def stream_close_releases_producer(pkg, path):
    """A 4-item buffer bounds the producer while the consumer stalls;
    close() stops it, and the worker takes the next task."""
    rt = _rt(pkg)
    f = rt.remote(num_returns="streaming")(gen_counter)
    stream = f.options(num_returns="streaming",
                       _stream_max_buffer=4).remote(path, 1000)
    it = iter(stream)
    firsts = [rt.get(next(it)) for _ in range(3)]
    time.sleep(1.0)
    with open(path) as fh:
        stalled = sum(1 for _ in fh)
    stream.close()
    del it, stream
    time.sleep(1.0)
    with open(path) as fh:
        after = sum(1 for _ in fh)
    time.sleep(0.5)
    with open(path) as fh:
        later = sum(1 for _ in fh)
    pong = rt.get(rt.remote(lambda: "pong").remote(), timeout=60)
    return {"firsts": firsts, "bounded": stalled <= 3 + 4 + 2,
            "stopped": later == after < 1000, "pong": pong}


def stream_plasma_items(pkg):
    """512 KiB items (above the inline limit) stream through the store."""
    rt = _rt(pkg)
    f = rt.remote(num_returns="streaming")(gen_arrays)
    vals = [rt.get(r) for r in f.remote(4, (512, 256))]
    return [(float(v[0, 0]), v.shape, str(v.dtype)) for v in vals]


def stream_tensors(pkg):
    """Torch CPU tensors yielded by a task, bit for bit (the port's wire
    format moves tensors out of band; JAX's pickles them)."""
    rt = _rt(pkg)
    f = rt.remote(num_returns="streaming")(gen_tensors)
    return [rt.get(r).numpy().tobytes() for r in f.remote(3)]


def _backend(pkg):
    return _rt(pkg).global_worker()._require_backend()


class _ListPump:
    """A push source that hands over its items in one take."""

    def __init__(self, items):
        self.items = list(items)

    async def take(self, n):
        out, self.items = self.items, []
        return (out, True)

    def close(self):
        pass


def stream_inline_threshold(pkg):
    """Frames above ``RT_STREAM_INLINE_MAX`` travel as plasma references
    (``o``), smaller ones inline (``v``), at the default limit and at a
    1 KiB one; each decodes to its exact payload."""
    import numpy as np

    stream = importlib.import_module(pkg + ".cluster.stream")
    backend = _backend(pkg)
    big = np.arange(200 * 1024, dtype=np.uint8)
    mid = bytes(range(256)) * 8
    out = {}
    prev = os.environ.get("RT_STREAM_INLINE_MAX")
    try:
        for label, limit in (("default", None), ("1k", "1024")):
            if limit is None:
                os.environ.pop("RT_STREAM_INLINE_MAX", None)
            else:
                os.environ["RT_STREAM_INLINE_MAX"] = limit
            sid = f"thr-{label}"
            stream.register_source(sid, _ListPump([b"small", big, mid, 7]))
            ch = backend.io.run(stream.subscribe(backend, backend.address,
                                                 sid))
            wire = []
            deadline = time.time() + 10
            while len(wire) < 4 and time.time() < deadline:
                wire.extend(ch.take_available())
                time.sleep(0.02)
            decoded = [backend.io.run(stream.take_decoded_wire(backend, w))[0]
                       for w in wire]
            out[label] = {
                "kinds": [w[0] for w in wire],
                "exact": (decoded[0] == b"small"
                          and np.array_equal(decoded[1], big)
                          and decoded[2] == mid and decoded[3] == 7)}
    finally:
        if prev is None:
            os.environ.pop("RT_STREAM_INLINE_MAX", None)
        else:
            os.environ["RT_STREAM_INLINE_MAX"] = prev
    return out


def stream_credit_window(pkg):
    """An unconsumed channel parks its producer at the credit window;
    consuming drains the stream exactly and deregisters the source."""
    stream = importlib.import_module(pkg + ".cluster.stream")
    backend = _backend(pkg)

    class CountingPump:
        def __init__(self, total):
            self.taken = 0
            self.total = total

        async def take(self, n):
            k = min(n, self.total - self.taken)
            out = list(range(self.taken, self.taken + k))
            self.taken += k
            return (out, self.taken >= self.total)

        def close(self):
            pass

    pump = CountingPump(2000)
    stream.register_source("bp-test", pump)
    ch = backend.io.run(stream.subscribe(backend, backend.address,
                                         "bp-test", window=8))
    time.sleep(0.5)
    parked = pump.taken
    got = []
    while True:
        item, done = backend.io.run(stream.take_decoded(backend, ch))
        if done:
            break
        got.append(item)
    deadline = time.time() + 5
    while time.time() < deadline and "bp-test" in stream._sources:
        time.sleep(0.05)
    return {"parked_within_window": parked <= 8,
            "exact": got == list(range(2000)),
            "deregistered": "bp-test" not in stream._sources}


# ---- serve: streamed responses ------------------------------------------------


class Streamer:
    async def __call__(self, n: int):
        async def gen():
            for i in range(n):
                yield i

        return gen()

    async def slow(self, n: int, delay_s: float = 0.02):
        async def gen():
            for i in range(n):
                await asyncio.sleep(delay_s)
                yield i

        return gen()

    def sync_gen(self, n: int):
        return (i * 10 for i in range(n))

    async def boom(self, n: int):
        async def gen():
            for i in range(n):
                yield i
            raise ValueError("stream exploded")

        return gen()


def _deploy_streamer(pkg, name):
    serve = _serve(pkg)
    serve.run(serve.deployment(Streamer).bind(), name=name,
              route_prefix=None)
    return serve.get_deployment_handle("Streamer", name)


def _drain_ongoing(pkg, actor):
    rt = _rt(pkg)
    deadline = time.time() + 10
    while time.time() < deadline:
        if rt.get(actor.ongoing_count.remote()) == 0:
            return 0
        time.sleep(0.1)
    return rt.get(actor.ongoing_count.remote())


def serve_push_pull(pkg):
    """Push streams token-exact over two RPCs whatever their length,
    concurrent streams isolated, a sync generator on the same transport,
    async iteration, and ``RT_STREAM_PULL=1`` on the pull path."""
    h = _deploy_streamer(pkg, "st-pp")
    out = {}
    for n in (5, 200):
        gen = h.remote(n).result()
        out[n] = (list(gen), gen._transport, gen._rpcs)
    gens = [h.remote(40).result() for _ in range(4)]
    out["concurrent"] = [list(g) for g in gens]
    gen = h.options(method_name="sync_gen").remote(30).result()
    out["sync"] = (list(gen), gen._transport)

    async def drive():
        g = await h.remote(64)
        return [t async for t in g], g._transport, g._rpcs

    out["async"] = asyncio.run(drive())
    os.environ["RT_STREAM_PULL"] = "1"
    try:
        gen = h.remote(50).result()
        out["pull"] = (list(gen), gen._transport, gen._rpcs)
    finally:
        del os.environ["RT_STREAM_PULL"]
    _serve(pkg).delete("st-pp")
    return out


def serve_stream_error_and_cancel(pkg):
    """A stream raising mid-push delivers its items then the error; a
    cancelled stream frees its channel; both slots drain to zero."""
    rt = _rt(pkg)
    h = _deploy_streamer(pkg, "st-ec")
    gen = h.options(method_name="boom").remote(7).result()
    got, err = [], None
    try:
        for t in gen:
            got.append(t)
    except Exception as e:  # noqa: BLE001 — the compared outcome
        err = "stream exploded" in str(e)
    drained_err = _drain_ongoing(pkg, gen._actor)
    gen = h.options(method_name="slow").remote(100_000, 0.005).result()
    it = iter(gen)
    head = [next(it) for _ in range(5)]
    backend = rt.global_worker()._require_backend()
    ch = gen._channel
    gen.cancel()
    client = backend._pool._clients.get(
        backend._actor_conns[gen._actor._actor_id.hex()].address)
    freed = (gen._channel is None and client is not None
             and ch.id not in client._channels)
    drained_cancel = _drain_ongoing(pkg, gen._actor)
    _serve(pkg).delete("st-ec")
    return {"got": got, "err": err, "drained_err": drained_err,
            "head": head, "freed": freed, "drained_cancel": drained_cancel}


def serve_fallback_resume(pkg):
    """A push channel broken mid-stream (chaos ``rpc.drop`` on
    ``stream_push``) resumes through ``resume_pull`` token-exact."""
    chaos = importlib.import_module(pkg + ".util.chaos")
    h = _deploy_streamer(pkg, "st-fb")
    warm = list(h.remote(3).result())
    chaos.arm('{"seed": 1, "faults": [{"site": "rpc.drop", '
              '"target": "stream_push", "at": 12, "max_fires": 1}]}')
    try:
        gen = h.options(method_name="slow").remote(60, 0.01).result()
        toks = list(gen)
        out = {"warm": warm, "toks": toks, "transport": gen._transport,
               "resumed": gen._rpcs >= 3}
    finally:
        chaos.disarm()
    _serve(pkg).delete("st-fb")
    return out


def serve_stream_metrics(pkg):
    """The stream series advance on the producer (frames, bytes) and the
    consumer (RPCs per request)."""
    rt = _rt(pkg)
    metrics = importlib.import_module(pkg + ".util.metrics")
    h = _deploy_streamer(pkg, "st-m")
    gen = h.remote(80).result()
    n = len(list(gen))
    rt.get(gen._actor.flush_metrics.remote())
    metrics.flush_now()
    text = metrics.metrics_text()

    def value(name, tag):
        return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith(name) and tag in ln)

    _serve(pkg).delete("st-m")
    return {"n": n,
            "frames": value("rt_stream_frames_total", 'transport="push"') > 0,
            "bytes": value("rt_stream_bytes_total", 'transport="push"') > 0,
            "rpcs": value("rt_stream_rpcs_per_request_count",
                          'transport="push"') > 0}


# ---- serve: handles, batching, HTTP, ASGI, multiplexing, gRPC ----------------


class Adder:
    def __init__(self, k):
        self.k = k

    def __call__(self, x):
        return x + self.k

    def mul(self, a, b):
        return a * b


class Composer:
    def __init__(self, left, right):
        self.left = left
        self.right = right

    async def __call__(self, x):
        a = await self.left.remote(x)
        b = await self.right.remote(x)
        return {"left": a, "right": b, "sum": a + b}


def serve_handles_and_composition(pkg):
    serve = _serve(pkg)
    h = serve.run(serve.deployment(Adder).bind(10), name="add",
                  route_prefix=None)
    direct = [h.remote(i).result(timeout=30) for i in range(4)]
    mul = h.options(method_name="mul").remote(6, 7).result(timeout=30)
    dep = serve.deployment(Adder)
    app = serve.deployment(Composer).bind(dep.options(name="L").bind(1),
                                          dep.options(name="R").bind(100))
    c = serve.run(app, name="comp", route_prefix=None)
    composed = [c.remote(i).result(timeout=30) for i in (0, 5)]
    via = serve.get_app_handle("comp").remote(2).result(timeout=30)
    serve.delete("add")
    serve.delete("comp")
    return {"direct": direct, "mul": mul, "composed": composed, "via": via}


class Batched:
    def __init__(self, serve_pkg):
        serve = importlib.import_module(serve_pkg)
        self.batch_sizes = []
        self.predict = serve.batch(max_batch_size=8,
                                   batch_wait_timeout_s=0.2)(self._predict)

    async def _predict(self, xs):
        self.batch_sizes.append(len(xs))
        return [x * 2 for x in xs]

    async def __call__(self, x):
        if x == "sizes":
            return self.batch_sizes
        return await self.predict(x)


def serve_batching(pkg):
    serve = _serve(pkg)
    h = serve.run(serve.deployment(max_ongoing_requests=32)(Batched).bind(
        pkg + ".serve"), name="batched", route_prefix=None)
    rs = [h.remote(i) for i in range(8)]
    results = [r.result(timeout=30) for r in rs]
    sizes = h.remote("sizes").result(timeout=30)
    serve.delete("batched")
    return {"results": results, "total": sum(sizes), "fused": max(sizes) > 1,
            "within_max": max(sizes) <= 8}


def streamed(r):
    """A streamed response as what is fixed about it: its status, type,
    chunked framing and whole body, and whether it came in more than one
    chunk (where the proxy cuts chunks depends on timing)."""
    return {"status": r["status"], "content_type": r["content_type"],
            "chunked": r["chunked"], "body": b"".join(r["chunks"]),
            "several_chunks": len(r["chunks"]) > 1}


def http_raw(port, method, path, body=b"", headers=None):
    """One HTTP/1.1 request on a fresh connection; the status, the
    content type, whether the body was chunked, and the chunk sequence
    (the whole body as one element when it was not chunked)."""
    hdrs = {"Host": f"127.0.0.1:{port}", "Connection": "close",
            "Content-Length": str(len(body))}
    hdrs.update(headers or {})
    req = (f"{method} {path} HTTP/1.1\r\n"
           + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
           + "\r\n").encode() + body
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(req)
        data = b""
        while True:
            got = s.recv(65536)
            if not got:
                break
            data += got
    head, _, rest = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    h = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        h[k.strip().lower()] = v.strip()
    chunked = h.get("transfer-encoding", "").lower() == "chunked"
    if chunked:
        chunks = []
        while rest:
            size_line, _, rest = rest.partition(b"\r\n")
            size = int(size_line.split(b";")[0], 16)
            if size == 0:
                break
            chunks.append(rest[:size])
            rest = rest[size + 2:]
    else:
        chunks = [rest]
    return {"status": status,
            "content_type": h.get("content-type", "").split(";")[0],
            "chunked": chunked, "chunks": chunks,
            "request_id": bool(h.get("x-rt-request-id"))}


class Api:
    async def __call__(self, request):
        if request.path == "/sum":
            return {"sum": sum(request.json()["xs"])}
        if request.path == "/text":
            return "plain words"
        if request.path == "/fail":
            raise RuntimeError("api exploded")
        return 404, f"nothing at {request.path}"


class TokenStream:
    def __call__(self, req):
        n = int(req.query.get("n", 4))
        for i in range(n):
            yield f"t{i} "
            time.sleep(0.05)


def serve_http(pkg):
    """Status, body, content type and request-id header of each route,
    the chunk sequence of a streamed body, and the proxy's own routes."""
    serve = _serve(pkg)
    serve.run(serve.deployment(Api).bind(), name="api", route_prefix="/api",
              http_options=_http0(pkg))
    serve.run(serve.deployment(TokenStream).bind(), name="tok",
              route_prefix="/tok", http_options=_http0(pkg))
    port = serve.http_port()
    out = {}
    for key, method, path, body in (
            ("sum", "POST", "/api/sum", json.dumps({"xs": [1, 2, 3]})),
            ("text", "GET", "/api/text", ""),
            ("missing", "GET", "/api/nope", ""),
            ("unrouted", "GET", "/unrouted", ""),
            ("healthz", "GET", "/-/healthz", ""),
            ("stream", "GET", "/tok?n=5", "")):
        r = http_raw(port, method, path, body.encode(),
                     {"Content-Type": "application/json"} if body else None)
        out[key] = streamed(r) if key == "stream" else r
    fail = http_raw(port, "GET", "/api/fail")
    out["fail"] = {"status": fail["status"],
                   "content_type": fail["content_type"],
                   "mentions": b"api exploded" in b"".join(fail["chunks"])}
    serve.delete("api")
    serve.delete("tok")
    return out


def mini_asgi_app():
    """An ASGI3 app: a path parameter with a header, a JSON echo of a
    POST, a streamed body, an error and a 404."""
    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        path = scope["path"]

        async def respond(status, body, extra=()):
            await send({"type": "http.response.start", "status": status,
                        "headers": [(b"content-type", b"application/json"),
                                    *extra]})
            await send({"type": "http.response.body", "body": body})

        if path.startswith("/items/"):
            item = path.split("/")[2]
            await respond(200, json.dumps({"id": int(item)}).encode(),
                          extra=((b"x-item", item.encode()),))
        elif path == "/echo":
            body = b""
            while True:
                msg = await receive()
                body += msg.get("body", b"")
                if not msg.get("more_body"):
                    break
            await respond(200, json.dumps(
                {"echo": json.loads(body or b"null"),
                 "method": scope["method"],
                 "q": scope["query_string"].decode()}).encode())
        elif path == "/stream":
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            for i in range(4):
                await send({"type": "http.response.body",
                            "body": f"tok{i};".encode(), "more_body": True})
                await asyncio.sleep(0.01)
            await send({"type": "http.response.body", "body": b"done"})
        elif path == "/fail":
            raise RuntimeError("app exploded")
        else:
            await respond(404, b'{"detail":"nope"}')

    return app


def ws_asgi_app():
    """A WebSocket ASGI app: echoes text uppercased, sums binary bytes,
    closes on 'bye'; rejects /denied before accepting."""
    async def app(scope, receive, send):
        if scope["type"] != "websocket":
            await send({"type": "http.response.start", "status": 404,
                        "headers": []})
            await send({"type": "http.response.body", "body": b""})
            return
        await receive()  # websocket.connect
        if scope["path"] == "/denied":
            await send({"type": "websocket.close", "code": 4403})
            return
        await send({"type": "websocket.accept"})
        await send({"type": "websocket.send",
                    "text": f"hello:{scope['path']}"})
        while True:
            msg = await receive()
            if msg["type"] == "websocket.disconnect":
                return
            if msg.get("bytes") is not None:
                await send({"type": "websocket.send",
                            "bytes": bytes([sum(msg["bytes"]) % 256])})
            elif msg.get("text") == "bye":
                await send({"type": "websocket.send", "text": "BYE"})
                await send({"type": "websocket.close", "code": 1000})
                return
            else:
                await send({"type": "websocket.send",
                            "text": msg["text"].upper()})

    return app


def serve_asgi(pkg):
    """The ASGI bridge: HTTP routes of an ASGI3 app, its streamed body,
    an app error, and a WebSocket echo with binary frames, an
    app-initiated close and a rejection before accept."""
    import aiohttp

    serve = _serve(pkg)
    serve.run(serve.deployment(serve.asgi_app(mini_asgi_app)).bind(),
              name="asgi", route_prefix="/a", http_options=_http0(pkg))
    serve.run(serve.deployment(serve.asgi_app(ws_asgi_app)).bind(),
              name="ws", route_prefix="/ws", http_options=_http0(pkg))
    port = serve.http_port()
    out = {}
    for key, method, path, body in (
            ("item", "GET", "/a/items/5", b""),
            ("echo", "POST", "/a/echo?x=1", b'{"k": [1, 2]}'),
            ("stream", "GET", "/a/stream", b""),
            ("missing", "GET", "/a/nowhere", b"")):
        r = http_raw(port, method, path, body)
        out[key] = streamed(r) if key == "stream" else r
    fail = http_raw(port, "GET", "/a/fail")
    out["fail"] = fail["status"]

    async def ws():
        seen = []
        async with aiohttp.ClientSession() as sess:
            async with sess.ws_connect(
                    f"http://127.0.0.1:{port}/ws/room") as w:
                seen.append((await w.receive()).data)
                await w.send_str("abc")
                seen.append((await w.receive()).data)
                await w.send_bytes(bytes([200, 100]))
                seen.append(bytes((await w.receive()).data))
                await w.send_str("bye")
                seen.append((await w.receive()).data)
                closing = await w.receive()
                seen.append(("close", int(closing.type),
                             w.close_code))
            try:
                await sess.ws_connect(f"http://127.0.0.1:{port}/ws/denied")
                seen.append("accepted")
            except aiohttp.WSServerHandshakeError as e:
                seen.append(("denied", e.status))
        return seen

    out["ws"] = asyncio.run(ws())
    serve.delete("asgi")
    serve.delete("ws")
    return out


def mux_model_class(pkg):
    """A deployment class whose model loader is ``@serve.multiplexed``
    with room for two models a replica, from ``pkg``'s serve."""
    serve = _serve(pkg)

    class MuxModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "n": len(self.loads)}

        def __call__(self, _req=None):
            if _req == "loads":
                return self.loads
            model = self.get_model(serve.get_multiplexed_model_id())
            return {"served_by": model["id"], "load_no": model["n"]}

    return MuxModel


def serve_multiplexed(pkg):
    """Model-id routing and the per-replica LRU of two models: a hit
    keeps its load, a third model evicts the least recent."""
    serve = _serve(pkg)
    h = serve.run(serve.deployment(num_replicas=1, max_ongoing_requests=8)(
        mux_model_class(pkg)).bind(), name="mux", route_prefix=None)
    seq = []
    for mid in ("m1", "m1", "m2", "m3", "m1", "m3"):
        seq.append(h.options(multiplexed_model_id=mid).remote()
                   .result(timeout=60))
    loads = h.remote("loads").result(timeout=60)
    serve.delete("mux")
    return {"seq": seq, "loads": loads}


def schema_app(k=1):
    """The target of the schema test's ``import_path``; builds its
    Application from whichever package's serve ``SCHEMA_PKG`` names."""
    serve = _serve(os.environ["SCHEMA_PKG"])
    return serve.deployment(Adder).bind(k)


def serve_schema(pkg):
    """A declarative config: an app factory with args, a deployment override,
    one app deployed through ``deploy_config``."""
    schema = importlib.import_module(pkg + ".serve.schema")
    serve = _serve(pkg)
    os.environ["SCHEMA_PKG"] = pkg
    try:
        names = schema.deploy_config({
            "applications": [{
                "name": "sch", "route_prefix": None,
                "import_path": "_torch_serve_cases:schema_app",
                "args": {"k": 5},
                "deployments": [{"name": "Adder", "num_replicas": 2}]}],
            "http_options": {"port": 0}})
    finally:
        del os.environ["SCHEMA_PKG"]
    h = serve.get_app_handle("sch")
    got = [h.remote(i).result(timeout=30) for i in range(3)]
    n = serve.status()["sch"]["deployments"]["Adder"]["replicas"]
    serve.delete("sch")
    return {"names": names, "got": got, "replicas": n}


def serve_grpc(pkg):
    """gRPC ingress: unary calls routed to a deployment and one of its
    methods; an unknown app raises ``grpc.RpcError``."""
    import grpc

    serve = _serve(pkg)
    gp = importlib.import_module(pkg + ".serve.grpc_proxy")
    serve.run(serve.deployment(num_replicas=2)(Adder).bind(0), name="calc",
              route_prefix=None)
    port = serve.start_grpc()
    addr = f"127.0.0.1:{port}"
    out = {"call": gp.grpc_request(addr, "calc", 2),
           "method": gp.grpc_request(addr, "calc", 4, 5, method="mul")}
    try:
        gp.grpc_request(addr, "nope", 1)
        out["unknown"] = None
    except grpc.RpcError as e:
        out["unknown"] = str(e.code())
    serve.delete("calc")
    return out


def _shape(obj, depth=0):
    """The key structure of a nested status dict (values dropped; keys
    of per-app and per-replica maps kept only where they are names the
    program chose)."""
    if isinstance(obj, dict) and depth < 6:
        return {k: _shape(v, depth + 1) for k, v in sorted(obj.items())}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_shape(obj[0], depth + 1)]
    return type(obj).__name__


def serve_status_and_metrics(pkg):
    """The keys of ``status()`` and ``detailed_status()`` after traffic,
    and the names and tag keys of the replicas' serve series, read back
    through the cluster's metrics."""
    rt = _rt(pkg)
    serve = _serve(pkg)
    metrics = importlib.import_module(pkg + ".util.metrics")
    h = serve.run(serve.deployment(Adder).bind(1), name="obs",
                  route_prefix="/obs", http_options=_http0(pkg))
    for i in range(5):
        h.remote(i).result(timeout=30)
    http_raw(serve.http_port(), "POST", "/obs", b"3",
             {"Content-Type": "application/json"})
    st = serve.status()
    det = serve.detailed_status()
    dep = det["applications"]["obs"]["deployments"]["Adder"]
    for _, actor in h._router.replicas:
        rt.get(actor.flush_metrics.remote())
    metrics.flush_now()
    text = metrics.metrics_text()
    series = set()
    for ln in text.splitlines():
        # the replicas' series, flushed just above (other processes push
        # on their own clocks)
        if (ln.startswith("#") or 'deployment="Adder"' not in ln
                or not ln.startswith(("rt_serve_execute",
                                      "rt_serve_queue_wait"))):
            continue
        name, _, rest = ln.partition("{")
        tags = tuple(sorted(kv.split("=")[0] for kv in
                            rest.split("}")[0].split(",") if kv))
        series.add((name.split(" ")[0], tags))
    serve.delete("obs")
    return {"status": _shape(st["obs"]), "detailed": _shape(
        {k: v for k, v in det.items() if k != "applications"}),
        "deployment": _shape(dep), "series": sorted(series)}


# ---- pure units: the autoscaler and the router --------------------------------


def autoscale_decisions(pkg, series):
    """The autoscaler's target for a series of windowed stats: each step
    records an ongoing-count sample and sets the window's queue depth,
    p99 and qps, then asks for the target (no delays, no cluster)."""
    cfgmod = importlib.import_module(pkg + ".serve.config")
    ctl = importlib.import_module(pkg + ".serve.controller")
    out = []
    for ac in ({}, {"target_queue_depth": 2.0},
               {"target_qps_per_replica": 20.0}, {"max_p99_s": 0.5}):
        cfg = cfgmod.DeploymentConfig(
            autoscaling_config=cfgmod.AutoscalingConfig(
                min_replicas=1, max_replicas=8, target_ongoing_requests=2.0,
                upscale_delay_s=0.0, downscale_delay_s=0.0,
                look_back_period_s=5.0, **ac))
        cfg.validate()
        s = ctl._DeploymentState("app", "d", cfg, None, (), {})
        now = 1000.0
        for ongoing, stats in series:
            now += 1.0
            s.metrics.append((now, ongoing))
            s.win_stats = dict(stats)
            s.replicas = {f"r{i}": object()
                          for i in range(out[-1][0] if out and
                                         out[-1][0] else 1)}
            target = s.target_replicas(now)
            out.append((target, s.last_trigger.get("signal")))
    return out


def router_picks(pkg, seed, prompts):
    """``_RouterState.pick`` under a seeded ``random``: four replicas with
    loads and KV residency, a pick and (every other time) a completion
    per prompt, with and without a model id."""
    import random

    H = importlib.import_module(pkg + ".serve.handle")
    PH = importlib.import_module(pkg + ".util.prefix_hash")
    r = H._RouterState("app", "dep")
    r.replicas = [(rid, object()) for rid in ("a", "b", "c", "d")]
    r.counts = {"a": 0, "b": 2, "c": 1, "d": 0}
    warm = PH.prompt_digests(prompts[0])
    r.kv_digests = {"a": frozenset(warm), "c": frozenset(warm[-1:])}
    if hasattr(r, "model_ids"):
        r.model_ids = {"b": {"m1"}, "d": {"m2"}}
    random.seed(seed)
    picks = []
    for i, prompt in enumerate(prompts * 4):
        model = ("m1", None, "m2")[i % 3]
        rid, _ = r.pick(model, PH.prompt_digests(prompt))
        picks.append(rid)
        if i % 2:
            r.complete(rid)
    return {"picks": picks, "counts": dict(sorted(r.counts.items())),
            "slack": H._AFFINITY_SLACK}


# ---- the LLM apps ---------------------------------------------------------------


def fp32_llm_class(pkg):
    """A subclass of the package's ContinuousLLM whose replica first puts the
    ``debug`` preset in float32 into its own process's PRESETS and, on
    the port, loads the weights it is given (JAX's, as numpy) through the
    engine's ``load_params``."""
    llm = importlib.import_module(pkg + ".serve.llm")
    base = llm.ContinuousLLM

    class Fp32(base):
        def __init__(self, *args, np_params=None, **kwargs):
            import dataclasses

            llama = importlib.import_module(pkg + ".models.llama")
            if pkg == "ray_tpu":
                import jax.numpy as jnp

                dtype = jnp.float32
            else:
                import torch

                dtype = torch.float32
            llama.PRESETS["debug"] = dataclasses.replace(
                llama.PRESETS["debug"], compute_dtype=dtype)
            super().__init__(*args, **kwargs)
            if np_params is not None:
                conv = importlib.import_module(pkg + ".models.convert")
                params = conv.params_from_jax(np_params, self.cfg,
                                              device=self.device)
                self.params = params
                if hasattr(self, "engine"):
                    self.engine.load_params(params)

    Fp32.__name__ = Fp32.__qualname__ = "ContinuousLLM"
    return Fp32


def with_body(app, body, **extra):
    """``app`` (an app function's Application) with its deployment class swapped
    for ``body``; its name, config and arguments kept, ``extra`` keyword
    arguments added."""
    dep = app._deployment
    return type(dep)(body, dep.name, dep._config).bind(
        *app._args, **app._kwargs, **extra)


def served_tokens(pkg, app, prompts, n_new, route):
    """Greedy tokens of each prompt through the handle (push, then pull)
    and through HTTP (one token a line), with the request-id header."""
    serve = _serve(pkg)
    serve.run(app, name="llm", route_prefix=route, http_options=_http0(pkg))
    h = serve.get_app_handle("llm")
    out = {"push": [], "pull": [], "http": [], "transport": []}
    for p in prompts:
        gen = h.remote({"tokens": p, "max_new_tokens": n_new}).result(
            timeout=120)
        out["push"].append([int(t) for t in gen])
        out["transport"].append(gen._transport)
    os.environ["RT_STREAM_PULL"] = "1"
    try:
        for p in prompts:
            gen = h.remote({"tokens": p, "max_new_tokens": n_new}).result(
                timeout=120)
            out["pull"].append([int(t) for t in gen])
            out["transport"].append(gen._transport)
    finally:
        del os.environ["RT_STREAM_PULL"]
    port = serve.http_port()
    for p in prompts:
        r = http_raw(port, "POST", route,
                     json.dumps({"tokens": p,
                                 "max_new_tokens": n_new}).encode(),
                     {"Content-Type": "application/json"})
        body = b"".join(r["chunks"]).decode()
        out["http"].append({"status": r["status"], "chunked": r["chunked"],
                            "content_type": r["content_type"],
                            "tokens": [int(t) for t in body.split()]})
    return out


def obs_catalog(pkg):
    """Every series ``serve.obs`` defines: its kind, name, description,
    tag keys and histogram buckets."""
    obs = importlib.import_module(pkg + ".serve.obs")
    out = []
    for fn in sorted(n for n in dir(obs) if not n.startswith("_")):
        f = getattr(obs, fn)
        if not callable(f) or getattr(f, "__module__", "") != obs.__name__:
            continue
        try:
            m = f()
        except TypeError:
            continue  # takes arguments: not a series factory
        if not hasattr(m, "tag_keys"):
            continue
        out.append((fn, type(m).__name__, m.name, m.description,
                    tuple(m.tag_keys), tuple(getattr(m, "boundaries", ()))))
    return out


def kv_affinity(pkg, prefix, tails, name="llm"):
    """On app ``name``'s two replicas with prefix caches: requests sharing
    a prefix go out until the router has heard (on a reply) which replica
    holds it; then each further request sharing it must be a prefix-cache
    hit, as the router sends it to the replica that holds it."""
    rt = _rt(pkg)
    serve = _serve(pkg)
    PH = importlib.import_module(pkg + ".util.prefix_hash")
    h = serve.get_app_handle(name)
    mine = set(PH.prompt_digests(prefix + tails[0]))

    def holders():
        return sum(1 for d in h._router.kv_digests.values() if mine & d)

    def ask(tail):
        list(h.remote({"tokens": prefix + tail, "max_new_tokens": 2})
             .result(timeout=120))

    def hits():
        # read from the engines themselves: a request's lookup is done by
        # the time its stream ends (the controller's stats lag)
        return sum(rt.get(a.stats_window.remote())["engine"]["kv"]["hits"]
                   for _, a in h._router.replicas)

    warmups = 0
    while not holders() and warmups < 8:
        ask(tails[0])
        warmups += 1
    h0 = hits()
    for t in tails[1:]:
        ask(t)
    gained = hits() - h0
    warm = holders()
    return {"residency_heard": warmups < 8, "hits_gained": gained,
            "warm_replicas": warm}
