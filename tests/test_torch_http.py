"""The port's HTTP front door held to the reference's conformance suite
(``tests/test_serve_http.py`` is the checklist), and the wire format held
both ways between the packages.

Two tiers, as in the reference:

* **Stub conformance** (no engine): the front door over the stub scheduler
  (``tests/torch_serving_stub.py``: the reference's ``serving_stub.py`` on
  the port's classes) — SSE framing, heartbeats under silence, the
  terminal event, backpressure 429 + ``Retry-After`` before admission, the
  tenant rate-limit 429, disconnect mid-stream reclaiming the slot and its
  blocks within one segment, graceful drain, 503 while draining, protocol
  errors, ``/healthz`` and ``/v1/stats``.  Each of the twelve runs three
  ways: the port's server with the port's client, the port's server with
  the reference's client (``repro.serve.http``'s helpers, which
  ``tools/serve_client.py`` uses), and the reference's server with the
  port's client.
* **Real engine** (``http`` marker): the port's reduced engine on its plain
  versions behind the port's front door — for one fixed arrival order the
  HTTP path gives the offline scheduler's tokens (with either package's
  client, and with a tenant policy and the trace on), and the chaos suites
  run underneath concurrent clients with survivors unchanged and every
  block back.  The launcher's ``--smoke`` runs too.

Servers bind to port 0; clients run under plain ``asyncio.run``.
"""
from __future__ import annotations

import asyncio
import types

import numpy as np
import pytest
import torch

import repro.serve.http as jax_http
import repro.serve.policy as jax_policy
import repro_torch.serve.http as port_http
import repro_torch.serve.policy as port_policy
import serving_stub as jax_stub
import torch_serving_stub as port_stub
from repro_torch.launch import http_serve
from repro_torch.models.registry import get_arch
from repro_torch.serve.chaos import ChaosConfig
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler
from torch_scheduler_pair import QUANT

HOST = "127.0.0.1"
SERVERS = {"port": (port_http, port_stub, port_policy), "jax": (jax_http, jax_stub, jax_policy)}
CLIENTS = {"port": port_http, "jax": jax_http}
WIRES = [("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.fixture(params=WIRES, ids=[f"{s}_server-{c}_client" for s, c in WIRES])
def w(request):
    """The server side's front door, stub and policy, the client side's
    helpers."""
    server, client = request.param
    http, stub, policy = SERVERS[server]
    c = CLIENTS[client]
    return types.SimpleNamespace(
        FrontDoor=http.FrontDoor, HttpConfig=http.HttpConfig, Stub=stub.StubScheduler,
        drain_offline=stub.drain_offline, SubmitRequest=stub.SubmitRequest,
        TenantPolicy=policy.TenantPolicy, TenantSpec=policy.TenantSpec,
        generate=c.generate, open_generate=c.open_generate,
        read_sse_event=c.read_sse_event, http_get=c.http_get)


def _run(coro):
    return asyncio.run(coro)


async def _with_fd(fd_cls, sched, cfg, fn):
    """start → fn(front_door) → graceful stop, whatever fn does."""
    fd = fd_cls(sched, cfg)
    await fd.start()
    try:
        return await fn(fd)
    finally:
        await fd.stop()


def _gen_payload(prompt, max_new, **kw):
    return {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new, **kw}


stub_token = port_stub.stub_token


# ------------------------------------------------------------ SSE framing


def test_sse_framing_and_terminal_event(w):
    async def fn(fd):
        return await w.generate(HOST, fd.port, _gen_payload([5, 9], 6))

    out = _run(_with_fd(w.FrontDoor, w.Stub(), w.HttpConfig(), fn))
    assert out["status"] == 200
    toks = [e["data"]["token"] for e in out["events"] if e.get("event") == "token"]
    assert toks == [stub_token([5, 9], i) for i in range(6)]
    ids = [e["id"] for e in out["events"] if "id" in e]
    assert ids == list(range(len(ids)))
    done = out["events"][-1]
    assert done["event"] == "done" and done["id"] == 6
    body = done["data"]
    assert body["finish_reason"] == "length" and body["state"] == "finished"
    assert body["usage"] == {"prompt_tokens": 2, "completion_tokens": 6}
    assert body["tokens"] == toks


def test_eos_finish_reason_stop(w):
    prompt = [11, 4]
    eos = stub_token(prompt, 2)

    async def fn(fd):
        return await w.generate(HOST, fd.port, _gen_payload(prompt, 10))

    out = _run(_with_fd(w.FrontDoor, w.Stub(eos_id=eos), w.HttpConfig(), fn))
    body = out["body"]
    assert body["finish_reason"] == "stop" and body["tokens"][-1] == eos
    assert body["usage"]["completion_tokens"] == 3


def test_non_streaming_single_json_response(w):
    async def fn(fd):
        return await w.generate(HOST, fd.port, _gen_payload([3, 4], 3, stream=False))

    out = _run(_with_fd(w.FrontDoor, w.Stub(), w.HttpConfig(), fn))
    assert out["status"] == 200 and out["events"] == []
    assert out["body"]["tokens"] == [stub_token([3, 4], i) for i in range(3)]
    assert out["body"]["finish_reason"] == "length"


def test_heartbeats_under_silence(w):
    sched = w.Stub(steps_per_segment=1, segment_delay_s=0.3)

    async def fn(fd):
        return await w.generate(HOST, fd.port, _gen_payload([2, 2], 2))

    out = _run(_with_fd(w.FrontDoor, sched, w.HttpConfig(heartbeat_s=0.05), fn))
    kinds = [e.get("event") for e in out["events"]]
    assert kinds.count("heartbeat") >= 1, kinds
    assert out["body"]["finish_reason"] == "length"


def test_ordering_equivalence_stub(w):
    """Fixed arrival order ⇒ the HTTP path's outputs equal the offline
    drain's, request by request."""
    def mk():
        return w.Stub(n_slots=2, steps_per_segment=3)

    subs = [w.SubmitRequest(prompt=[7 + i, 3 * i + 1], max_new_tokens=4 + i)
            for i in range(6)]
    offline = w.drain_offline(mk(), subs)

    async def fn(fd):
        conns = [await w.open_generate(HOST, fd.port, _gen_payload(s.prompt, s.max_new_tokens))
                 for s in subs]
        return await _collect_streams(w, conns)

    outs = _run(_with_fd(w.FrontDoor, mk(), w.HttpConfig(), fn))
    assert [(b["streamed"], b["tokens"]) for b in outs] == [(t, t) for t in offline]


# ----------------------------------------------------------- backpressure


def test_backpressure_429_before_admission(w):
    sched = w.Stub(n_slots=1, steps_per_segment=8, segment_delay_s=0.15)

    async def fn(fd):
        return await asyncio.gather(*[
            w.generate(HOST, fd.port, _gen_payload([10 + i, 1], 4)) for i in range(8)])

    outs = _run(_with_fd(w.FrontDoor, sched, w.HttpConfig(max_pending=2), fn))
    rejected = [o for o in outs if o["status"] == 429]
    accepted = [o for o in outs if o["status"] == 200]
    assert rejected and accepted, [o["status"] for o in outs]
    for o in rejected:
        assert int(o["headers"]["retry-after"]) >= 1
        assert o["events"] == [] and o["body"]["error"] == "overloaded"
        assert o["body"]["retry_after_s"] > 0
    for o in accepted:
        assert o["body"]["finish_reason"] == "length"
    assert sched._next_rid == len(accepted) == sched.stats["retired"]


def test_rate_limit_429_with_retry_after(w):
    policy = w.TenantPolicy(tenants={"a": w.TenantSpec(rate=0.5, burst=1)})
    sched = w.Stub(policy=policy)

    async def fn(fd):
        return [await w.generate(HOST, fd.port, _gen_payload([5, 5], 2, tenant="a"))
                for _ in range(2)]

    first, second = _run(_with_fd(w.FrontDoor, sched, w.HttpConfig(), fn))
    assert first["status"] == 200 and second["status"] == 429
    assert "rate limit" in second["body"]["error"]
    assert second["body"]["retry_after_s"] > 0
    assert int(second["headers"]["retry-after"]) >= 1
    assert policy.rate_rejections["a"] == 1


# ------------------------------------------------- disconnect propagation


def test_disconnect_mid_stream_reclaims_blocks_within_one_segment(w):
    sched = w.Stub(n_slots=2, steps_per_segment=1, segment_delay_s=0.05)

    async def fn(fd):
        reader, writer, status, _h = await w.open_generate(HOST, fd.port,
                                                           _gen_payload([9, 9], 60))
        assert status == 200
        for _ in range(2):
            ev = await w.read_sse_event(reader)
            assert ev["event"] in ("token", "heartbeat")
        seg_at_disconnect = sched.stats["segments"]
        writer.close()
        deadline = asyncio.get_running_loop().time() + 10.0
        while sched.stats["cancelled"] < 1:
            assert asyncio.get_running_loop().time() < deadline, sched.stats
            await asyncio.sleep(0.01)
        return seg_at_disconnect

    seg0 = _run(_with_fd(w.FrontDoor, sched, w.HttpConfig(heartbeat_s=0.5), fn))
    assert sched.stats["blocks_reclaimed_cancel"] > 0
    assert sched.allocator.n_free == sched.allocator.capacity
    assert sched.last_cancel_segment - seg0 <= 2, (sched.last_cancel_segment, seg0)


# ------------------------------------------------------- lifecycle + errors


def test_graceful_drain_completes_inflight_stream(w):
    sched = w.Stub(steps_per_segment=1, segment_delay_s=0.05)

    async def main():
        fd = w.FrontDoor(sched, w.HttpConfig())
        await fd.start()
        task = asyncio.ensure_future(w.generate(HOST, fd.port, _gen_payload([8, 8], 10)))
        while sched.stats["admitted"] < 1:
            await asyncio.sleep(0.005)
        await fd.stop()
        out = await task
        assert out["body"]["finish_reason"] == "length"
        assert len(out["body"]["tokens"]) == 10
        assert not fd.worker.is_alive()

    _run(main())


def test_draining_returns_503(w):
    async def fn(fd):
        fd.draining = True
        return await w.generate(HOST, fd.port, _gen_payload([1, 1], 2))

    assert _run(_with_fd(w.FrontDoor, w.Stub(), w.HttpConfig(), fn))["status"] == 503


async def _raw_post(port, body: bytes) -> int:
    reader, writer = await asyncio.open_connection(HOST, port)
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode() + body)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    writer.close()
    return int(head.split(b" ", 2)[1])


def test_protocol_errors(w):
    async def fn(fd):
        return {
            "bad_json": await _raw_post(fd.port, b"{not json"),
            "no_prompt": await w.generate(HOST, fd.port, {"max_new_tokens": 4}),
            "bad_type": await w.generate(HOST, fd.port, {"prompt": ["x"], "max_new_tokens": 4}),
            "bad_budget": await w.generate(HOST, fd.port, _gen_payload([1, 2], 0)),
            "get_generate": await w.http_get(HOST, fd.port, "/v1/generate"),
            "unknown": await w.http_get(HOST, fd.port, "/nope"),
            "too_big": await w.generate(HOST, fd.port, _gen_payload(list(range(200)), 4)),
        }

    out = _run(_with_fd(w.FrontDoor, w.Stub(), w.HttpConfig(max_body_bytes=256), fn))
    assert out["bad_json"] == 400
    assert [out[k]["status"] for k in ("no_prompt", "bad_type", "bad_budget", "get_generate",
                                       "unknown", "too_big")] == [400, 400, 400, 405, 404, 413]


def test_health_and_stats_endpoints(w):
    policy = w.TenantPolicy(tenants={"a": w.TenantSpec(weight=2.0)})
    sched = w.Stub(policy=policy)

    async def fn(fd):
        await w.generate(HOST, fd.port, _gen_payload([5, 9], 4, tenant="a"))
        return (await w.http_get(HOST, fd.port, "/healthz"),
                await w.http_get(HOST, fd.port, "/v1/stats"))

    health, stats = _run(_with_fd(w.FrontDoor, sched, w.HttpConfig(), fn))
    assert health["status"] == 200 and health["body"]["status"] == "ok"
    body = stats["body"]
    assert body["front_door"]["accepted"] == 1
    assert body["scheduler"]["tenant_tokens"]["a"] == 4
    assert body["tenants"]["a"]["served_tokens"] == 4
    assert body["tenants"]["a"]["weight"] == 2.0


async def _collect_streams(w, conns):
    """Read every open SSE stream to its terminal event; returns the done
    payloads, each with the tokens streamed before it (``streamed``)."""
    outs = []
    for reader, writer, status, _h in conns:
        assert status == 200
        toks = []
        while True:
            ev = await w.read_sse_event(reader)
            assert ev is not None, "stream ended without a terminal event"
            if ev.get("event") == "token":
                toks.append(ev["data"]["token"])
            elif ev.get("event") in ("done", "error"):
                break
        assert ev["event"] == "done", ev
        outs.append({**ev["data"], "streamed": toks})
        writer.close()
    return outs


# ======================================================== real engine


@pytest.fixture(scope="module")
def engines():
    """The port's reduced engines on the CPU (int8 weights, random from a
    seed): a paged one with the invariants checked every segment, and the
    dense ``generate`` oracle."""
    arch = get_arch("tinyllama-1.1b", reduced=True)
    params = arch.init_params(torch.Generator().manual_seed(0), "cpu")

    def mk(layout, **kw):
        sc = ServeConfig(max_len=64, kv_layout=layout, block_len=8, debug_invariants=True,
                         **QUANT, **kw)
        return ServeEngine(arch, params, sc, device="cpu")

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield {"paged": mk("paged"), "traced": mk("paged", trace=True), "oracle": mk("dense")}
    finally:
        torch.set_num_threads(threads)


def _prompt(seed, length):
    return np.random.RandomState(seed).randint(0, 256, length).astype(np.int32)


def _oracle(engines, prompts, news):
    eng = engines["oracle"]
    return [eng.generate(torch.from_numpy(p)[None].long(), n)[0].tolist()
            for p, n in zip(prompts, news)]


@pytest.mark.http
@pytest.mark.parametrize("client", ["port", "jax"])
def test_http_matches_offline_scheduler(engines, client):
    """For one fixed arrival order the HTTP path's greedy tokens equal the
    offline scheduler's drain (and ``generate``'s), read by either
    package's client."""
    lens, news = [6, 9, 5, 8, 7], [12, 8, 14, 10, 9]
    prompts = [_prompt(40 + i, n) for i, n in enumerate(lens)]
    want = _oracle(engines, prompts, news)

    def mk_sched():
        return ContinuousScheduler(engines["paged"], n_slots=2, segment_len=4, n_blocks=24)

    offline_sched = mk_sched()
    handles = [offline_sched.submit(p, n) for p, n in zip(prompts, news)]
    offline_sched.run()
    offline = [list(h.tokens) for h in handles]
    assert offline == want
    c = CLIENTS[client]

    async def fn(fd):
        conns = [await c.open_generate(HOST, fd.port, _gen_payload(p, n))
                 for p, n in zip(prompts, news)]
        return await _collect_streams(c, conns)

    outs = _run(_with_fd(port_http.FrontDoor, mk_sched(), port_http.HttpConfig(), fn))
    for body, off in zip(outs, offline):
        assert body["finish_reason"] == "length"
        assert body["tokens"] == body["streamed"] == off


@pytest.mark.http
def test_http_tenants_and_trace_match_offline_scheduler(engines):
    """A tenant policy (acme:3, hobby:1) and the trace on: through HTTP each
    request's tokens and each tenant's admissions and tokens are the
    offline scheduler's with the same policy (which slot serves whom
    depends on when the worker wakes, so slots are not compared);
    ``/v1/stats`` carries the per-tenant counters and the priced
    per-tenant report, ``/healthz`` the queue depths."""
    lens, news = [6, 9, 5, 8, 7, 4], [12, 8, 14, 10, 9, 6]
    prompts = [_prompt(60 + i, n) for i, n in enumerate(lens)]
    tenants = ["acme", "hobby", "acme", "hobby", "acme", "hobby"]

    def mk_sched():
        policy = port_policy.TenantPolicy(tenants={"acme": port_policy.TenantSpec(weight=3.0),
                                                   "hobby": port_policy.TenantSpec()})
        return ContinuousScheduler(engines["traced"], n_slots=2, segment_len=4, n_blocks=24,
                                   policy=policy)

    offline_sched = mk_sched()
    handles = [offline_sched.submit(p, n, tenant=t) for p, n, t in zip(prompts, news, tenants)]
    offline_sched.run()
    order = sorted(handles, key=lambda h: (h.first_token_t, h.rid))

    async def fn(fd):
        conns = [await port_http.open_generate(HOST, fd.port, _gen_payload(p, n, tenant=t))
                 for p, n, t in zip(prompts, news, tenants)]
        outs = await _collect_streams(port_http, conns)
        return (outs, await port_http.http_get(HOST, fd.port, "/v1/stats"),
                await port_http.http_get(HOST, fd.port, "/healthz"))

    sched = mk_sched()
    outs, stats, health = _run(_with_fd(port_http.FrontDoor, sched, port_http.HttpConfig(), fn))
    assert [b["tokens"] for b in outs] == [h.tokens for h in handles]
    assert sched.stats["tenant_tokens"] == offline_sched.stats["tenant_tokens"]
    assert sched.policy.snapshot() == offline_sched.policy.snapshot()
    # acme's weight 3 serves its first two requests in one DRR visit
    assert [h.tenant for h in order][:2] == ["acme", "acme"]
    body = stats["body"]
    assert body["tenants"]["acme"]["admitted"] == 3 and body["tenants"]["hobby"]["admitted"] == 3
    pricing = body["tenant_pricing"]
    assert set(pricing) == {"acme", "hobby"}
    assert all(r["j_per_token"] > 0 and r["tok_s"] > 0 for r in pricing.values())
    assert health["body"] == {"status": "ok", "queued": 0, "running": 0, "pending": 0,
                              "retired": len(prompts)}


@pytest.mark.http
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_under_concurrent_http_clients(engines, seed):
    """Injected cancels, exhaustions and slot failures under concurrent
    clients leave the survivors' tokens and states unchanged, with every
    block back in the pool."""
    rng = np.random.RandomState(seed)
    n_req = 8
    lens = [int(rng.randint(3, 12)) for _ in range(n_req)]
    news = [int(rng.randint(2, 20)) for _ in range(n_req)]
    prompts = [_prompt(900 + 10 * seed + i, n) for i, n in enumerate(lens)]
    want = _oracle(engines, prompts, news)
    sched = ContinuousScheduler(
        engines["paged"], n_slots=3, segment_len=4, n_blocks=10, overcommit=2.0,
        chaos=ChaosConfig(seed=seed, exhaust_prob=0.15, cancel_prob=0.15,
                          slot_fail_prob=0.15))

    async def fn(fd):
        conns = [await port_http.open_generate(HOST, fd.port, _gen_payload(p, n))
                 for p, n in zip(prompts, news)]
        return await _collect_streams(port_http, conns)

    outs = _run(_with_fd(port_http.FrontDoor, sched, port_http.HttpConfig(), fn))
    n_done = 0
    for body, want_toks in zip(outs, want):
        if body["finish_reason"] == "length":
            n_done += 1
            assert body["tokens"] == want_toks, (seed, body["rid"])
        else:
            assert body["finish_reason"] == "cancelled", (seed, body)
            assert body["tokens"] == want_toks[:len(body["tokens"])], (seed, body)
    assert n_done == n_req - sched.stats["cancelled"]
    assert sched.stats["cancelled"] == sched.stats["chaos_cancels"]
    assert sched.allocator.n_free == sched.allocator.capacity


async def _malformed_client(port: int, flavor: int) -> None:
    reader, writer = await asyncio.open_connection(HOST, port)
    try:
        if flavor == 0:
            writer.write(b"\x00\xffGARBAGE\r\n\r\n")
        elif flavor == 1:
            body = b"{not json"
            writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                          f"Content-Length: {len(body)}\r\n"
                          f"Connection: close\r\n\r\n").encode() + body)
        else:
            writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: 500\r\nConnection: close\r\n\r\nshort")
        await writer.drain()
        if flavor != 2:
            await asyncio.wait_for(reader.read(256), 5.0)
    except (ConnectionResetError, BrokenPipeError, asyncio.TimeoutError):
        pass
    finally:
        writer.close()


async def _disconnect_client(port: int, payload: dict) -> None:
    reader, writer, status, _h = await port_http.open_generate(HOST, port, payload)
    assert status == 200
    assert await port_http.read_sse_event(reader) is not None
    writer.close()


async def _reading_client(port: int, payload: dict, slow_s: float = 0.0) -> dict:
    reader, writer, status, _h = await port_http.open_generate(HOST, port, payload)
    assert status == 200
    toks = []
    try:
        while True:
            if slow_s:
                await asyncio.sleep(slow_s)
            ev = await port_http.read_sse_event(reader)
            assert ev is not None, "stream ended without a terminal event"
            if ev.get("event") == "token":
                toks.append(ev["data"]["token"])
            elif ev.get("event") in ("done", "error"):
                assert ev["event"] == "done", ev
                assert toks == ev["data"]["tokens"]
                return ev["data"]
    finally:
        writer.close()


@pytest.mark.http
def test_http_chaos_clients_never_wedge_server(engines):
    """Slow readers, mid-stream disconnects and malformed frames against the
    real engine: every well-behaved client gets its full stream, every
    disconnect is reclaimed, and ``/healthz`` still answers."""
    import random as pyrandom

    chaos = ChaosConfig(seed=3, http_slow_reader_prob=0.4, http_slow_reader_s=0.02,
                        http_disconnect_prob=0.3, http_malformed_prob=0.5)
    assert chaos.http_enabled and not chaos.enabled
    rng = pyrandom.Random(chaos.seed)
    n_req = 8
    np_rng = np.random.RandomState(chaos.seed)
    lens = [int(np_rng.randint(3, 12)) for _ in range(n_req)]
    news = [int(np_rng.randint(8, 20)) for _ in range(n_req)]
    prompts = [_prompt(950 + i, n) for i, n in enumerate(lens)]
    want = _oracle(engines, prompts, news)
    roles = []
    for _ in range(n_req):
        if rng.random() < chaos.http_disconnect_prob:
            roles.append("disconnect")
        elif rng.random() < chaos.http_slow_reader_prob:
            roles.append("slow")
        else:
            roles.append("ok")
    n_malformed = sum(rng.random() < chaos.http_malformed_prob for _ in range(6))
    assert {"disconnect", "slow", "ok"} <= set(roles) and n_malformed >= 1
    sched = ContinuousScheduler(engines["paged"], n_slots=3, segment_len=4, n_blocks=24)

    async def fn(fd):
        tasks, readers = [], []
        for i, (p, n, role) in enumerate(zip(prompts, news, roles)):
            if role == "disconnect":
                tasks.append(_disconnect_client(fd.port, _gen_payload(p, 40)))
            else:
                t = asyncio.ensure_future(_reading_client(
                    fd.port, _gen_payload(p, n),
                    chaos.http_slow_reader_s if role == "slow" else 0.0))
                readers.append((i, t))
                tasks.append(t)
        for k in range(n_malformed):
            tasks.append(_malformed_client(fd.port, k % 3))
        await asyncio.wait_for(asyncio.gather(*tasks, return_exceptions=True), 120.0)
        return ({i: t.result() for i, t in readers},
                await port_http.http_get(HOST, fd.port, "/healthz"))

    bodies, health = _run(_with_fd(port_http.FrontDoor, sched,
                                   port_http.HttpConfig(heartbeat_s=0.5), fn))
    assert health["status"] == 200
    for i, body in bodies.items():
        assert body["finish_reason"] == "length" and body["tokens"] == want[i], i
    assert sched.stats["cancelled"] == roles.count("disconnect")
    assert sched.allocator.n_free == sched.allocator.capacity
    assert not sched.has_work()


@pytest.mark.http
def test_launcher_smoke_cpu():
    """``launch/http_serve.py --smoke``: six seeded clients over two tenants
    with the trace on, every stream clean, exit 0."""
    with pytest.raises(SystemExit) as e:
        http_serve.main(["--reduced", "--device", "cpu", "--kv-layout", "paged", "--port",
                         "0", "--tenant", "acme:3", "--tenant", "hobby:1", "--trace",
                         "--smoke", "6", "--prompt-len", "16", "--new-tokens", "12"])
    assert e.value.code == 0


def test_worker_death_fails_requests_fast():
    """A scheduler that raises kills the worker: the in-flight stream ends
    in an ``error`` event, and a later request fails at once instead of
    waiting on an inbox nothing drains."""
    class Broken(port_stub.StubScheduler):
        def run_segment(self):
            raise RuntimeError("segment failed")

    async def fn(fd):
        first = await port_http.generate(HOST, fd.port, _gen_payload([1, 2], 3))
        t0 = asyncio.get_running_loop().time()
        try:
            await asyncio.wait_for(port_http.generate(HOST, fd.port, _gen_payload([3, 4], 3)),
                                   10.0)
            second = "answered"
        except (asyncio.IncompleteReadError, ConnectionError):
            second = "closed"
        return first, second, asyncio.get_running_loop().time() - t0

    first, second, waited = _run(_with_fd(port_http.FrontDoor, Broken(),
                                          port_http.HttpConfig(), fn))
    assert first["events"][-1]["event"] == "error" and "segment failed" in first["body"]["error"]
    assert second == "closed" and waited < 5.0


def test_launcher_refusals():
    """Without a card the launcher exits rather than fall back; flag
    combinations the scheduler cannot serve are refused at parse time."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            http_serve.build_front_door(http_serve.parse_args(["--reduced"]))
    for argv in (["--overcommit", "2"], ["--preempt-mode", "swap"],
                 ["--prefill-token-budget", "8"], ["--weight-quant-sparsity", "0.5"]):
        with pytest.raises(SystemExit):
            http_serve.parse_args(["--reduced", "--device", "cpu", *argv])
