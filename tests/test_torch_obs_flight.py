"""Port parity for request flights, gauge time series and their exporters:
trlx_tpu_torch.obs.{flight,timeseries,export} against trlx_tpu.obs's.

Checked: a ``FlightRecorder`` fed the same event stream with explicit
timestamps gives identical flight snapshots, phases, ``obs/flight/*``
gauges, percentiles and Chrome-trace events (streams: the phase state
machine, a preemption replay, a re-route and adoption, many tenants and
classes, ring eviction); export/adopt continues one flight; the disabled
recorder is a no-op; the seeded ``drop_terminal`` regression drops terminal
events in both. The same requests through the JAX and the port
``ServingEngine`` with flights on give identical per-uid event sequences
(one-token decode, speculative decoding with chunked prefill, int8 KV),
each flight's engine phases sum to ``Request.latency_s`` within 1e-9 s, and
greedy output with flights on equals output with them off. The scheduler's
export/adopt seam and the online collector journal as the JAX ones do. A
``SeriesStore`` and both exporters under an injected clock write files
byte-identical to the JAX package's. The ``Observability`` runtime wires
flights, series and exporters, and off leaves the recorder disabled.

Every test resets both packages' recorders and clears their ``obs/``
gauges: they are process-global, and the JAX test files sharing a worker
read the JAX ones.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
from trlx_tpu.models.transformer import TransformerLM as JaxLM
from trlx_tpu.obs import export as jax_export
from trlx_tpu.obs import flight as jax_flight
from trlx_tpu.obs import timeseries as jax_timeseries
from trlx_tpu.obs.flight import FlightRecorder as JaxRecorder
from trlx_tpu.serving import GenerationClient as JaxClient
from trlx_tpu.serving import ServingEngine as JaxEngine
from trlx_tpu.serving.allocator import PagedBlockAllocator as JaxAllocator
from trlx_tpu.serving.scheduler import InflightScheduler as JaxScheduler
from trlx_tpu.utils import metrics as jax_metrics
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.obs import export, flight, timeseries
from trlx_tpu_torch.obs.flight import ENGINE_PHASES, TERMINAL_EVENTS, FlightRecorder
from trlx_tpu_torch.serving import GenerationClient, InflightScheduler, PagedBlockAllocator, ServingEngine
from trlx_tpu_torch.utils import metrics

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)
PROMPTS = [[5, 9, 11], [2, 30, 7, 1, 3, 22, 4, 8, 15, 16, 23, 31], [1, 2, 3, 4, 5, 6, 7], [33, 12],
           [9, 9, 9, 9, 9], [4, 4, 6, 4, 4, 6, 4, 4, 6]]
#: phase sum vs Request.latency_s: both sides are differences of the same
#: scheduler clock readings, so only float addition separates them
LATENCY_TOL_S = 1e-9


@pytest.fixture(autouse=True)
def _clean_recorders():
    for rec in (flight, jax_flight):
        rec.reset()
    yield
    for rec, reg in ((flight, metrics.gauges), (jax_flight, jax_metrics.gauges)):
        rec.configure(enabled=False)
        rec.reset()
        reg.clear(prefix="obs/")


# ------------------------------------------------------------ event streams

#: (uid, event, t, meta) streams; each covers one part of the state machine
STREAMS = {
    "state_machine": [
        (7, "submit", 0.0, dict(tenant_id="pro", slo_class=1)), (7, "admit", 1.0, {}),
        (7, "prefill_chunk", 1.5, {}), (7, "decode_round", 2.0, {}), (7, "preempt", 3.0, {}),
        (7, "admit", 4.0, {}), (7, "decode_round", 5.0, {}), (7, "finish", 6.0, dict(reason="length")),
        (7, "reward_dispatch", 7.0, {}), (7, "reward_done", 9.0, {}), (7, "store", 10.0, {}),
    ],
    "reroute_adopt": [
        (1, "submit", 0.0, dict(tenant_id="a", slo_class=0, seat=0)), (2, "submit", 0.1, dict(seat=0)),
        (1, "admit", 0.5, {}), (1, "decode_round", 0.75, {}), (1, "re_route", 1.0, dict(seat=0)),
        (2, "re_route", 1.0, dict(seat=0)), (1, "adopt", 1.25, dict(seat=1)), (2, "adopt", 1.25, dict(seat=1)),
        (2, "admit", 1.5, {}), (1, "admit", 1.5, {}), (1, "decode_round", 2.0, {}),
        (2, "decode_round", 2.0, {}), (1, "spec_accept", 2.25, dict(accepted=3)),
        (1, "finish", 3.0, dict(reason="eos")), (2, "shed", 3.5, dict(reason="shed")),
        (2, "finish", 3.75, {}),  # a second terminal: counted, never re-timed
    ],
    "tenants": [
        (uid, ev, uid * 0.5 + dt, dict(tenant_id=f"t{uid % 3}", slo_class=uid % 2) if ev == "submit" else
         (dict(reason="deadline") if ev == "expire" else {}))
        for uid in range(12)
        for ev, dt in (("submit", 0.0), ("admit", 0.25 + 0.01 * uid), ("decode_round", 0.5 + 0.03 * uid),
                       ("finish" if uid % 4 else "expire", 0.9 + 0.05 * uid), ("store", 1.0 + 0.07 * uid))
    ],
    "mid_flight_start": [
        (5, "decode_round", 0.0, {}), (5, "decode_round", 0.5, {}), (5, "finish", 1.0, {}),
        (6, "admit", 0.2, dict(tenant_id="late")), (6, "finish", 0.7, dict(reason="eos")),
    ],
}


def _feed(rec, stream):
    for uid, event, t, meta in stream:
        rec.record(uid, event, t=t, **meta)


def _flights(rec, uids):
    out = {}
    for uid in uids:
        fl = rec.get(uid)
        if fl is not None:
            out[uid] = (fl.to_snapshot(), fl.terminal_events, fl.terminal_reason, fl.t_terminal, fl.closed)
    return out


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_flight_recorder_matches_jax(stream):
    port, ref = FlightRecorder(enabled=True), JaxRecorder(enabled=True)
    _feed(port, STREAMS[stream])
    _feed(ref, STREAMS[stream])
    uids = sorted({e[0] for e in STREAMS[stream]})
    assert _flights(port, uids) == _flights(ref, uids)
    assert [fl.uid for fl in port.completed()] == [fl.uid for fl in ref.completed()]
    assert port.active_count() == ref.active_count()
    assert port.phase_percentiles((0.5, 0.95, 0.99)) == ref.phase_percentiles((0.5, 0.95, 0.99))
    assert port.trace_events(epoch=-1.0) == ref.trace_events(epoch=-1.0)
    port.export_gauges()
    ref.export_gauges()
    got = metrics.gauges.snapshot("obs/flight/")
    assert got and got == jax_metrics.gauges.snapshot("obs/flight/")
    for fl in port.completed():
        if fl.t_terminal is not None and fl.counts.get("submit"):
            assert abs(fl.engine_phase_sum() - fl.engine_wall_s) <= LATENCY_TOL_S


def test_flight_ring_eviction_matches_jax():
    port, ref = FlightRecorder(enabled=True, ring=2, reservoir=1), JaxRecorder(enabled=True, ring=2, reservoir=1)
    for rec in (port, ref):
        for uid in range(5):
            rec.record(uid, "submit", t=float(uid))
            rec.record(uid, "finish", t=uid + 0.5)
    assert [fl.uid for fl in port.completed()] == [fl.uid for fl in ref.completed()] == [3, 4]
    assert port.get(0) is None and port.get(2) is None and port.get(4) is not None
    port.configure(enabled=True, ring=3)
    port.record(9, "submit", t=9.0)
    port.record(9, "finish", t=9.5)
    assert [fl.uid for fl in port.completed()] == [3, 4, 9]


def test_flight_export_adopt_continues_one_flight_as_jax():
    snaps = {}
    for rec in (FlightRecorder(enabled=True), JaxRecorder(enabled=True)):
        rec.record(3, "submit", t=0.0, tenant_id="t", slo_class=1)
        rec.record(3, "admit", t=2.0)
        snaps[type(rec).__module__] = rec.export_flights([3, 99])
    assert snaps["trlx_tpu_torch.obs.flight"] == snaps["trlx_tpu.obs.flight"]
    adopted = []
    for cls in (FlightRecorder, JaxRecorder):
        rec = cls(enabled=True)
        rec.adopt_flights(snaps["trlx_tpu.obs.flight"], t=5.0, seat=1)
        rec.record(3, "decode_round", t=6.0)
        rec.record(3, "finish", t=7.0, reason="eos")
        fl = rec.get(3)
        adopted.append(fl.to_snapshot())
        assert fl.counts["adopt"] == 1 and fl.seats == [1] and fl.terminal_events == 1
        assert fl.engine_wall_s == 7.0 and fl.engine_phase_sum() == 7.0
    assert adopted[0] == adopted[1]


def test_flight_disabled_is_a_no_op():
    rec = FlightRecorder(enabled=False)
    rec.record(1, "submit", t=0.0, tenant_id="a", slo_class=1)
    rec.record(1, "finish", t=1.0)
    rec.adopt_flights({1: {}}, t=2.0)
    assert rec.get(1) is None and rec.completed() == []
    assert rec.export_flights([1]) == {}
    rec.export_gauges()
    assert metrics.gauges.snapshot("obs/flight/") == {}


def test_flight_seed_regression_drops_terminals_as_jax(monkeypatch):
    monkeypatch.setenv("TRLX_FLIGHT_SEED_REGRESSION", "drop_terminal")
    for rec in (FlightRecorder(enabled=True), JaxRecorder(enabled=True)):
        rec.record(1, "submit", t=0.0)
        rec.record(1, "finish", t=1.0)
        assert rec.get(1).terminal_events == 0 and rec.completed() == []
    monkeypatch.setenv("TRLX_FLIGHT_SEED_REGRESSION", "bogus")
    with pytest.raises(ValueError, match="TRLX_FLIGHT_SEED_REGRESSION"):
        FlightRecorder(enabled=True).record(1, "finish", t=1.0)


# --------------------------------------------------------- serving engines


@pytest.fixture(scope="module")
def shared_weights():
    jcfg = JAX_PRESETS["gpt2"].replace(**TINY, compute_dtype=jnp.float32)
    params = JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    )["params"]
    return jcfg, jax.tree.map(np.asarray, params)


_OPEN_ENGINES = []


@pytest.fixture(autouse=True)
def _close_engines():
    yield
    while _OPEN_ENGINES:
        _OPEN_ENGINES.pop().close()


def _engines(shared_weights, quant=False, **knobs):
    jcfg, params = shared_weights
    tcfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32, kv_cache_quant=quant)
    kw = dict(num_slots=3, max_seq_len=32, block_size=4, eos_token_id=None, pad_token_id=0,
              gen_kwargs=dict(do_sample=False), seed=0, **knobs)
    jeng = JaxEngine(JaxLM(jcfg.replace(kv_cache_quant=quant)), params, **kw)
    teng = ServingEngine(TransformerLM(tcfg), params_from_jax(params, tcfg), device="cpu", **kw)
    _OPEN_ENGINES.extend((jeng, teng))
    return jeng, teng


def _journal(monkeypatch, rec):
    """Record every (uid, event) the sites journal, in order."""
    events = []
    record = rec.record

    def journal(uid, event, t=None, **meta):
        events.append((uid, event))
        return record(uid, event, t=t, **meta)

    monkeypatch.setattr(rec, "record", journal)
    return events


def _per_uid(events):
    out = {}
    for uid, event in events:
        out.setdefault(uid, []).append(event)
    return out


@pytest.mark.parametrize("mode", ["one_token", "spec_chunked", "int8"])
def test_engine_flight_events_match_jax(shared_weights, monkeypatch, mode):
    knobs = {"one_token": {}, "spec_chunked": dict(spec_k=3, prefill_chunk=4), "int8": {}}[mode]
    jeng, teng = _engines(shared_weights, quant=mode == "int8", **knobs)
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    flight.configure(enabled=True)
    jax_flight.configure(enabled=True)
    port_events, jax_events = _journal(monkeypatch, flight), _journal(monkeypatch, jax_flight)
    done = {}
    run = teng.run

    def recorded_run(uids=None):
        out = run(uids)
        done.update(out)
        return out

    monkeypatch.setattr(teng, "run", recorded_run)
    tout = GenerationClient(teng).generate_batch(prompts, 6)
    jout = JaxClient(jeng).generate_batch(prompts, 6)
    np.testing.assert_array_equal(tout[0], jout[0])
    assert port_events and _per_uid(port_events) == _per_uid(jax_events)
    if mode == "spec_chunked":
        assert any("prefill_chunk" in evs for evs in _per_uid(port_events).values())
    assert set(done) == set(_per_uid(port_events))
    for uid, req in done.items():
        fl = flight.get(uid)
        assert sum(fl.counts.get(e, 0) for e in TERMINAL_EVENTS) == 1
        assert fl.counts["store"] == 1 and fl.closed
        assert fl.engine_wall_s == req.latency_s
        assert abs(sum(fl.phases[p] for p in ENGINE_PHASES) - req.latency_s) <= LATENCY_TOL_S
    assert teng.allocator.blocks_in_use == 0


def test_engine_output_with_flights_on_equals_off(shared_weights):
    prompts = [np.asarray(p, np.int32) for p in PROMPTS]
    _, off = _engines(shared_weights, spec_k=3, prefill_chunk=4)
    _, on = _engines(shared_weights, spec_k=3, prefill_chunk=4)
    out_off = GenerationClient(off).generate_batch(prompts, 6)
    flight.configure(enabled=True)
    out_on = GenerationClient(on).generate_batch(prompts, 6)
    for a, b in zip(out_on[:2], out_off[:2]):
        np.testing.assert_array_equal(a, b)
    counts = lambda eng: {k: v for k, v in eng.summary().items() if not k.endswith("_s")}  # noqa: E731
    assert counts(on) == counts(off)
    assert len(flight.completed()) == len(PROMPTS)


def test_scheduler_export_adopt_carries_flights_as_jax():
    clock = {"t": 10.0}
    snapshots = []
    for rec, sched_cls, alloc_cls in ((flight, InflightScheduler, PagedBlockAllocator),
                                      (jax_flight, JaxScheduler, JaxAllocator)):
        rec.configure(enabled=True)
        clock["t"] = 10.0

        def tick():
            clock["t"] += 0.25
            return clock["t"]

        old = sched_cls(2, alloc_cls(num_blocks=16, block_size=4), clock=tick)
        uids = [old.submit([1, 2, 3], 4), old.submit([4, 5], 4), old.submit([6], 4)]
        old.admissions()
        old.on_token(0, 9)
        state = old.export_state()
        assert set(state["flights"]) == set(uids)
        new = sched_cls(2, alloc_cls(num_blocks=16, block_size=4), clock=tick)
        new.adopt_state(state)
        new.admissions()
        snapshots.append({uid: rec.get(uid).to_snapshot() for uid in uids})
        assert all(rec.get(uid).counts["adopt"] == 1 for uid in uids)
    assert snapshots[0] == snapshots[1]
    flight.configure(enabled=False)
    sched = InflightScheduler(1, PagedBlockAllocator(num_blocks=8, block_size=4))
    sched.submit([1], 2)
    assert sched.export_state()["flights"] == {}


def test_collector_journals_store_as_jax():
    from trlx_tpu.online.buffer import OnlineExperienceBuffer as JaxBuffer
    from trlx_tpu.online.collector import PreferenceCollector as JaxCollector
    from trlx_tpu.serving.scheduler import Request as JaxRequest
    from trlx_tpu_torch.online.buffer import OnlineExperienceBuffer
    from trlx_tpu_torch.online.collector import PreferenceCollector
    from trlx_tpu_torch.serving.scheduler import Request

    counts = []
    for rec, collector_cls, buffer_cls, req_cls in ((flight, PreferenceCollector, OnlineExperienceBuffer, Request),
                                                    (jax_flight, JaxCollector, JaxBuffer, JaxRequest)):
        rec.configure(enabled=True)
        collector = collector_cls(buffer_cls(), group_size=2, reward_fn=lambda prompt, outs: [1.0] * len(outs))
        for uid in (4, 5, 4):
            rec.record(uid, "submit", t=0.0)
            rec.record(uid, "finish", t=1.0, reason="length")
            req = req_cls(uid=uid, prompt=[1, 2], max_new_tokens=2, generated=[3, 4], finish_reason="length")
            collector.observe(req)
        counts.append({uid: rec.get(uid).counts.get("store", 0) for uid in (4, 5)})
    assert counts[0] == counts[1] == {4: 1, 5: 1}  # the duplicate harvest journals nothing


# ------------------------------------------------------ series and exporters


def _fill(store, registry):
    registry.set("obs/flight/completed", 3.0)
    registry.set('odd"key\\with\nnewline', -0.125)
    registry.set("serving/blocks_in_use", 0.0)
    for i in range(5):
        store.append("direct/a", i * 0.5 + 0.1, t=i * 0.25)
        registry.set("throughput/mfu", 0.01 * i + 1e-17)
        store.sample()
    store.sample("serving/", t=99.0)


@pytest.mark.parametrize("capacity", [1, 3, 512])
def test_series_store_and_exporters_byte_identical_to_jax(tmp_path, capacity):
    ticks = {"port": iter(np.arange(100.0, 200.0, 0.5)), "jax": iter(np.arange(100.0, 200.0, 0.5))}
    port_reg, jax_reg = metrics.GaugeRegistry(), jax_metrics.GaugeRegistry()
    port = timeseries.SeriesStore(capacity, registry=port_reg, clock=lambda: float(next(ticks["port"])))
    ref = jax_timeseries.SeriesStore(capacity, registry=jax_reg, clock=lambda: float(next(ticks["jax"])))
    _fill(port, port_reg)
    _fill(ref, jax_reg)
    assert port.keys() == ref.keys() and port.sample_rounds == ref.sample_rounds
    for key in port.keys():
        assert port.series(key) == ref.series(key)
        assert port.stats(key, window=2) == ref.stats(key, window=2)
        for fn in ("mean", "min", "max", "last", "sum"):
            assert port.reduce(key, fn) == ref.reduce(key, fn)
    for name, write in (("series.jsonl", lambda m, s, p: m.write_jsonl_series(s, p)),
                        ("metrics.prom", lambda m, s, p: m.write_prometheus(p, values=s.registry.snapshot()))):
        a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
        write(export, port, a)
        write(jax_export, ref, b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert export.read_jsonl_series(str(tmp_path / "port_series.jsonl")) == \
        jax_export.read_jsonl_series(str(tmp_path / "jax_series.jsonl"))
    assert export.read_prometheus(str(tmp_path / "port_metrics.prom")) == port_reg.snapshot()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{w}_{n}" for w in ("port", "jax") for n in ("series.jsonl", "metrics.prom"))  # no temp file left
    with pytest.raises(ValueError, match="capacity"):
        timeseries.SeriesStore(capacity=0)
    with pytest.raises(ValueError, match="unknown reduction"):
        port.reduce("direct/a", "median")


def test_prometheus_reader_rejects_a_torn_line(tmp_path):
    path = tmp_path / "bad.prom"
    path.write_text('trlx_gauge{key="a"} 1.0\nnot a sample\n')
    with pytest.raises(ValueError, match="unparseable"):
        export.read_prometheus(str(path))


# ----------------------------------------------------------------- runtime


def test_observability_runtime_wires_flights_series_and_exporters(tmp_path):
    from trlx_tpu_torch.data.configs import ObservabilityConfig
    from trlx_tpu_torch.obs import Observability

    cfg = ObservabilityConfig(
        enabled=True, trace_path=str(tmp_path / "trace.json"), trace_device=False, mfu=False,
        memory_interval=0, flight=True, series_capacity=16,
        series_path="series.jsonl", prom_path="metrics.prom",
    )
    obs = Observability(cfg, logging_dir=str(tmp_path), device="cpu")
    assert flight.enabled
    flight.record(1, "submit", t=0.0, tenant_id="a", slo_class=0)
    flight.record(1, "finish", t=1.0)
    metrics.gauges.set("obs/test/y", 3.0)
    stats = obs.step_stats(tokens=10, samples=1)
    assert stats["obs/test/y"] == 3.0 and stats["obs/flight/completed"] == 1.0
    assert stats["obs/flight/class/0/queue_wait_p50"] == 1.0
    assert obs.series.sample_rounds == 1
    obs.close()
    assert not flight.enabled
    assert export.read_jsonl_series(str(tmp_path / "series.jsonl"))["obs/test/y"][-1][1] == 3.0
    assert export.read_prometheus(str(tmp_path / "metrics.prom"))["obs/flight/completed"] == 1.0
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    lane = [ev for ev in events if ev.get("cat") == "flight"]
    assert lane and sum(ev["ph"] == "b" for ev in lane) == sum(ev["ph"] == "e" for ev in lane)


def test_observability_off_leaves_flights_disabled():
    from trlx_tpu_torch.data.configs import ObservabilityConfig
    from trlx_tpu_torch.obs import Observability

    flight.configure(enabled=False)
    obs = Observability(ObservabilityConfig(enabled=False), device="cpu")
    assert not flight.enabled and obs.series is None
    assert obs.step_stats(tokens=1, samples=1) == {}
    obs.close()
