"""The port's OpenAI-compatible HTTP server, client and load generator.

The reference suite's ten cases (``tests/test_server.py``: SSE order and
timestamps, the direct-engine stream, client latencies, the non-streaming
body, 400s, ``/v1/models`` and ``/metrics``, concurrent streams,
``encode_prompt``, the steady-state energy ledger, the open loop) run
against the port's server and client on the reference's tiny model, its
parameters bridged from the JAX ``model.init``.  Then the wire protocol
across packages: the reference's aiohttp client against the port's server
and the port's client against the reference's server; an engine that
fails mid-step; ``bench_serve --check`` in both modes; and
``serve --http-port`` stopped as Ctrl-C stops it.
"""

import asyncio
import json
import math
import socket
import time
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as jax_model  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.energy import PowerMonitor, SyntheticReader  # noqa: E402
from repro_torch.launch import bench_serve  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import client, wire  # noqa: E402
from repro_torch.serving.client import fetch_metrics, stream_completion  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.loadgen import (LoadSpec, attribute_energy,  # noqa: E402
                                         prewarm_engine, run_load)
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.server import encode_prompt, start_http_server  # noqa: E402

pytestmark = pytest.mark.server

ARCH = "tinyllama-1.1b"
TINY = dict(name="srv", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
            vocab_size=128, dtype="float32", param_dtype="float32")
ENGINE = dict(max_batch=2, max_len=64)


@pytest.fixture(scope="module")
def tiny():
    """The reference suite's tiny model (2 layers, d = 32) and its
    parameters bridged into the port."""
    jcfg = JaxModelConfig(**TINY).validate()
    params, _ = jax_model.init(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(ModelConfig(**TINY).validate(),
                            jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def server(tiny):
    """One port server over a prewarmed engine, shared across tests."""
    _, _, model = tiny
    engine = ServingEngine(model, **ENGINE, device="cpu")
    prewarm_engine(engine, prompt_len=8, concurrency=2, vocab_size=model.cfg.vocab_size)
    handle = start_http_server(engine, model_name=model.cfg.name)
    yield handle, model
    handle.close()


@pytest.fixture(scope="module")
def ref_server(tiny):
    """The reference's server over the JAX engine on the same parameters."""
    from repro.serving.loadgen import prewarm_engine as jax_prewarm
    from repro.serving.server import start_http_server as jax_start

    pytest.importorskip("aiohttp")
    jcfg, params, _ = tiny
    engine = JaxServingEngine(jcfg, params, **ENGINE)
    jax_prewarm(engine, prompt_len=8, concurrency=2, vocab_size=jcfg.vocab_size)
    handle = jax_start(engine, model_name=jcfg.name)
    yield handle
    handle.close()


async def _post(url, payload):
    """(status, headers, body) of one POST /v1/completions, read whole."""
    reader, writer, status, headers = await client._request(url, "POST", "/v1/completions",
                                                            payload)
    try:
        return status, headers, await client._read_all(reader, headers)
    finally:
        await client._closed(writer)


async def _post_raw(url, body: bytes):
    """(status, JSON body) of a POST whose body is ``body`` as given."""
    host, port = url.split("//")[1].split(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(b"POST /v1/completions HTTP/1.1\r\nContent-Length: %d\r\n"
                     b"Connection: close\r\n\r\n%s" % (len(body), body))
        await writer.drain()
        start, headers = await wire.read_head(reader)
        return int(start.split(" ")[1]), json.loads(await client._read_all(reader, headers))
    finally:
        await client._closed(writer)


async def _collect_sse(url, payload):
    """Raw SSE chunk stream with per-chunk arrival timestamps."""
    events = []
    reader, writer, status, headers = await client._request(url, "POST", "/v1/completions",
                                                            payload)
    try:
        assert status == 200
        assert headers["content-type"].startswith("text/event-stream")
        async for data in client.sse_data(wire.body_blocks(reader, headers, until_eof=True)):
            if data == "[DONE]":
                events.append((time.perf_counter(), "[DONE]"))
                break
            events.append((time.perf_counter(), json.loads(data)))
    finally:
        await client._closed(writer)
    return events


def test_stream_order_and_timestamps(server):
    handle, _ = server
    send = time.perf_counter()
    events = asyncio.run(_collect_sse(handle.url, {
        "prompt": [1, 2, 3, 4, 5], "max_tokens": 6, "stream": True}))
    # the terminal sentinel, exactly once, last
    assert [e for _, e in events].count("[DONE]") == 1
    assert events[-1][1] == "[DONE]"
    chunks = [e for _, e in events[:-1]]
    token_chunks = [c for c in chunks if c["choices"][0]["finish_reason"] is None]
    final = chunks[-1]
    # token chunks are contiguous and in order; the final chunk closes
    streamed = []
    for c in token_chunks:
        assert c["elana"]["first_index"] == len(streamed)
        streamed.extend(c["elana"]["tokens"])
    assert len(streamed) == 6
    assert final["choices"][0]["finish_reason"] == "length"
    assert final["usage"] == {"prompt_tokens": 5, "completion_tokens": 6, "total_tokens": 11}
    # the engine's stamps ride the final chunk and order correctly against
    # the client's own clock (one monotonic clock)
    ext = final["elana"]
    assert send < ext["engine_submit_s"] <= ext["engine_first_token_s"]
    assert ext["engine_first_token_s"] <= ext["engine_finish_s"]
    assert ext["engine_first_token_s"] <= events[0][0]
    # arrivals are monotonic and every emit stamp precedes its arrival
    arrivals = [t for t, _ in events[:-1]]
    assert arrivals == sorted(arrivals)
    for arrival, c in events[:-1]:
        if c["choices"][0]["finish_reason"] is None:
            assert c["elana"]["emit_s"] <= arrival


def test_stream_matches_direct_engine(server, tiny):
    """Greedy decoding through HTTP equals the port's engine driven
    directly and the JAX engine's direct stream on the same parameters."""
    handle, model = server
    jcfg, params, _ = tiny
    prompt = [7, 11, 13, 17, 19, 23, 29, 31]
    rec = asyncio.run(stream_completion(handle.url, prompt, max_tokens=8))
    assert not rec.error
    direct = ServingEngine(model, **ENGINE, device="cpu")
    direct.submit(np.asarray(prompt, np.int32), SamplingParams(max_new_tokens=8))
    ref = JaxServingEngine(jcfg, params, **ENGINE)
    ref.submit(np.asarray(prompt, np.int32), JaxSamplingParams(max_new_tokens=8))
    assert rec.tokens == list(direct.run()[0].output_tokens)
    assert rec.tokens == list(ref.run()[0].output_tokens)


def test_client_record_latency_ordering(server):
    handle, _ = server
    rec = asyncio.run(stream_completion(handle.url, [3, 1, 4, 1, 5], max_tokens=5))
    assert not rec.error
    assert rec.finish_reason == "length"
    assert len(rec.tokens) == 5
    assert rec.send_time < rec.first_chunk_time <= rec.last_chunk_time
    # the client's latencies bound the engine's from above
    assert rec.client_ttft_s >= rec.engine_ttft_s > 0.0
    assert rec.client_ttlt_s >= rec.client_ttft_s
    assert rec.usage["completion_tokens"] == 5


def test_non_streaming_completion(server):
    handle, _ = server
    status, headers, body = asyncio.run(_post(handle.url, {"prompt": [1, 2, 3],
                                                           "max_tokens": 4}))
    assert status == 200 and headers["content-type"].startswith("application/json")
    body = json.loads(body)
    assert body["object"] == "text_completion"
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 4
    assert len(body["elana"]["tokens"]) == 4


def test_bad_requests_rejected(server):
    handle, _ = server

    async def go():
        out = []
        for payload in ({"prompt": [], "max_tokens": 4}, {"prompt": [999999], "max_tokens": 4},
                        {"prompt": [1, 2], "max_tokens": 0}):
            status, _, body = await _post(handle.url, payload)
            out.append((status, json.loads(body)))
        out.append(await _post_raw(handle.url, b"{not json"))
        out.append(await _post_raw(handle.url, b"[1, 2]"))
        return out

    for status, body in asyncio.run(go()):
        assert status == 400
        assert body["error"]["message"]


def test_models_and_metrics_endpoints(server):
    handle, model = server

    async def go():
        await stream_completion(handle.url, [2, 4, 6], max_tokens=3)
        reader, writer, status, headers = await client._request(handle.url, "GET",
                                                                "/v1/models")
        models = json.loads(await client._read_all(reader, headers))
        await client._closed(writer)
        return status, models, await fetch_metrics(handle.url)

    status, models, metrics = asyncio.run(go())
    assert status == 200
    assert [m["id"] for m in models["data"]] == [model.cfg.name]
    # the engine's ledger and the server's counters in one scrape
    assert metrics["requests"] >= 1
    for key in ("ttft_ms", "tpot_ms", "ttlt_ms", "tokens_per_sec", "server_requests_received",
                "server_chunks_streamed", "server_in_flight", "server_uptime_s"):
        assert key in metrics, key
    assert metrics["server_requests_received"] >= 1
    assert metrics["server_chunks_streamed"] >= 3


def test_concurrent_streams_complete(server):
    handle, _ = server

    async def go():
        return await asyncio.gather(*[
            stream_completion(handle.url, [i + 1, i + 2, i + 3], max_tokens=4)
            for i in range(4)])

    recs = asyncio.run(go())
    assert all(not r.error for r in recs)
    assert all(len(r.tokens) == 4 for r in recs)
    assert all(r.client_ttft_s >= r.engine_ttft_s for r in recs)


def test_front_stamps_split_the_ttft_delta(server):
    """The server's (engine submit, queued, first hook) stamps sit between
    the client's send and first chunk, so the four parts of the
    client-minus-engine TTFT are each >= 0 and add up to it."""
    handle, _ = server
    rec = asyncio.run(stream_completion(handle.url, [9, 8, 7], max_tokens=3))
    assert not rec.error
    stamps = {s[0]: s for s in handle.server.front_stamps}
    submit, queued, hook = stamps[rec.engine["engine_submit_s"]]
    first_token = rec.engine["engine_first_token_s"]
    parts = (queued - rec.send_time, submit - queued, hook - first_token,
             rec.first_chunk_time - hook)
    assert all(p >= 0 for p in parts)
    assert sum(parts) == pytest.approx(rec.client_ttft_s - rec.engine_ttft_s, abs=1e-9)


@pytest.mark.parametrize("kind", ["proc", "model", "synthetic"])
def test_cli_power_readers(kind):
    """Both CLIs' ``--power-reader`` choices come from one factory; the
    synthetic waveform is the caller's (serve's flat 42 W, bench_serve's
    varying one)."""
    from repro_torch.core import energy

    reader = energy.make_reader(kind)
    watts = reader.read_watts()
    assert len(watts) == 1 and watts[0] > 0
    if kind == "synthetic":
        assert watts[0] == 42.0
        assert energy.make_reader(kind, bench_serve._synthetic_watts).read_watts()[0] != 42.0
    assert isinstance(energy.make_monitor(kind).reader, type(reader))
    with pytest.raises(ValueError, match="unknown power reader"):
        energy.make_reader("tpu")


def test_encode_prompt():
    from repro.serving.server import encode_prompt as jax_encode_prompt

    for prompt in ([1, 2, 3], "AB", "héllo"):
        assert encode_prompt(prompt, 128).tolist() == jax_encode_prompt(prompt, 128).tolist()
    assert encode_prompt("AB", 128).tolist() == [65, 66]
    with pytest.raises(ValueError):
        encode_prompt([128], 128)
    with pytest.raises(ValueError):
        encode_prompt([], 128)


def test_loadgen_steady_state_energy_ledger(server):
    """Over a steady-state window with the warm-up left out, client and
    engine latencies agree within tolerance and the per-request
    ``joules_between`` windows sum to the monitor's total exactly."""
    handle, model = server
    mon = PowerMonitor(SyntheticReader(lambda t: 40.0 + 10.0 * math.sin(t * 7.0)),
                       interval_s=0.02)
    handle.server.engine.attach_monitor(mon)
    spec = LoadSpec(mode="closed", concurrency=2, warmup_s=0.4, duration_s=1.2,
                    prompt_len=8, max_new=6, vocab_size=model.cfg.vocab_size)
    res = run_load(handle.url, spec, monitor=mon)
    s = res.summary
    assert s["steady_requests"] >= 2
    assert s["errors"] == 0
    # exactness: the tiles reproduce the total
    assert s["joules_attributed"] == pytest.approx(s["joules_total"], rel=1e-9, abs=1e-9)
    assert sum(r.joules for r in res.records) == pytest.approx(s["joules_total"], rel=1e-9)
    # tiling again after the fact agrees (the attribution is deterministic)
    assert attribute_energy(res.records, mon) == pytest.approx(s["joules_total"], rel=1e-9)
    # the client's and the engine's views of the same requests agree
    assert -1.0 <= s["ttft_client_minus_engine_ms"] <= 250.0
    assert abs(s["tpot_client_minus_engine_ms"]) <= 50.0
    # the protocol's sample-rate floor is checkable from the summary
    assert s["power_samples_per_sec"] >= 0.5 / 0.02
    assert s["power_reads_dropped"] == 0
    assert all(r.engine for r in res.records)


def test_loadgen_open_loop(server):
    handle, model = server
    spec = LoadSpec(mode="open", qps=6.0, warmup_s=0.3, duration_s=1.0, prompt_len=8,
                    max_new=4, vocab_size=model.cfg.vocab_size)
    res = run_load(handle.url, spec)
    s = res.summary
    assert s["steady_requests"] >= 1
    assert s["errors"] == 0
    # open loop: arrivals follow the schedule, so the achieved rate stays
    # near the target whatever the completions do
    assert 0.5 <= s["achieved_qps"] <= 12.0


def test_reference_client_against_port_server(server, ref_server):
    """The reference's aiohttp client reads the port's server as it reads
    its own: the same tokens, finish reason and usage, the same final
    ``elana`` keys, and every ``/metrics`` key the reference serves."""
    aiohttp = pytest.importorskip("aiohttp")
    from repro.serving.client import fetch_metrics as jax_fetch_metrics
    from repro.serving.client import stream_completion as jax_stream_completion

    handle, _ = server

    async def go(url):
        async with aiohttp.ClientSession() as s:
            recs = [await jax_stream_completion(s, url, [5, 9, 2, 7], max_tokens=5),
                    await jax_stream_completion(s, url, "hi", max_tokens=3, eos_token=-1)]
            return recs, await jax_fetch_metrics(s, url)

    ours, ours_metrics = asyncio.run(go(handle.url))
    ref, ref_metrics = asyncio.run(go(ref_server.url))
    for a, b in zip(ours, ref):
        assert not a.error and not b.error
        assert a.tokens == b.tokens and len(a.tokens) > 0
        assert a.finish_reason == b.finish_reason == "length"
        assert a.usage == b.usage
        assert set(a.engine) == set(b.engine)
        assert a.client_ttft_s >= a.engine_ttft_s > 0.0
    assert set(ref_metrics) <= set(ours_metrics)


def test_port_client_against_reference_server(server, ref_server):
    handle, _ = server

    async def go(url):
        return await asyncio.gather(stream_completion(url, [5, 9, 2, 7], max_tokens=5),
                                    stream_completion(url, [1, 1, 2, 3, 5, 8], max_tokens=4))

    ours, ref = asyncio.run(go(handle.url)), asyncio.run(go(ref_server.url))
    for a, b in zip(ours, ref):
        assert not a.error and not b.error
        assert a.tokens == b.tokens and a.usage == b.usage
        assert a.finish_reason == b.finish_reason == "length"
        assert set(a.engine) == set(b.engine)
        assert b.client_ttft_s >= b.engine_ttft_s > 0.0
    assert asyncio.run(fetch_metrics(ref_server.url))["requests"] >= 2


def test_engine_failure_ends_streams_and_close_reraises(tiny):
    """A step that raises ends the open stream without ``[DONE]``, refuses
    later requests with a 500, and ``summary()`` and ``close()`` re-raise
    it."""
    _, _, model = tiny
    engine = ServingEngine(model, **ENGINE, device="cpu")
    step, steps = engine.step, []

    def failing_step():
        steps.append(1)
        if len(steps) > 3:
            raise RuntimeError("injected step failure")
        return step()

    engine.step = failing_step
    handle = start_http_server(engine)
    try:
        rec = asyncio.run(stream_completion(handle.url, [1, 2, 3], max_tokens=20,
                                            timeout_s=30.0))
        assert rec.error and 0 < len(rec.tokens) < 20 and not rec.finish_reason
        late = asyncio.run(stream_completion(handle.url, [4, 5], max_tokens=2, timeout_s=30.0))
        assert late.error.startswith("HTTP 500") and "injected step failure" in late.error
        with pytest.raises(RuntimeError, match="injected step failure"):
            handle.server.summary()
    finally:
        with pytest.raises(RuntimeError, match="injected step failure"):
            handle.close()
    assert not handle._thread.is_alive() and not handle.server._thread.is_alive()


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_bench_serve_check_passes(capsys, mode):
    assert bench_serve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--power-reader", "synthetic",
        "--check", "--mode", mode, "--concurrency", "2", "--qps", "6", "--max-batch", "2",
        "--max-len", "64", "--prompt-len", "8", "--max-new", "4", "--warmup-s", "0.3",
        "--duration-s", "1.2", "--power-interval", "0.05"]) == 0
    out = capsys.readouterr().out
    summary, _ = json.JSONDecoder().raw_decode(out[out.index("{"):])
    assert summary["steady_requests"] >= 1 and summary["errors"] == 0
    assert summary["joules_attributed"] == pytest.approx(summary["joules_total"], rel=1e-9)
    assert "## Client-side steady state" in out and "## Engine-side" in out
    assert "# --check passed" in out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_http_port_prints_summary_on_ctrl_c(capsys, monkeypatch):
    port = _free_port()
    recs = []

    def sleep(_):  # one request, then Ctrl-C
        recs.append(asyncio.run(stream_completion(f"http://127.0.0.1:{port}", [1, 2, 3],
                                                  max_tokens=3)))
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_cli, "time", types.SimpleNamespace(sleep=sleep))
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--max-len", "64",
                           "--power-reader", "synthetic", "--http-port", str(port)]) == 0
    assert len(recs) == 1 and not recs[0].error and len(recs[0].tokens) == 3
    out = capsys.readouterr().out
    first, rest = out.split("\n", 1)
    name = get_config(ARCH, smoke=True).name
    assert first == (f"# serving {name} at http://127.0.0.1:{port} (POST /v1/completions; "
                     f"Ctrl-C to stop)")
    summary, end = json.JSONDecoder().raw_decode(rest)
    assert summary["requests"] == 1 and summary["output_tokens"] == 3
    assert summary["server_requests_received"] == 1 and summary["joules_total"] > 0
    assert "## Latency percentiles" in rest[end:]
