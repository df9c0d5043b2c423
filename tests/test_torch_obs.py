"""Port parity for the observability runtime: trlx_tpu_torch.obs against
trlx_tpu.obs on the same inputs (numpy draws from a seed).

Checked: ``nearest_rank`` and ``GaugeRegistry.hist_snapshot`` equal; the
throughput accountant's stats dicts equal (with and without a configured
peak); the peak table holds NVIDIA parts only; ``param_count`` of the
port's full and hydra policies equals the JAX trainer's ``param_count``;
``batch_token_count`` equal on PPO, SFT and ILQL batches (numpy and torch);
``device_memory_stats`` on the CPU has the JAX CPU backend's keys, and on a
CUDA device reads the caching allocator (faked here) and never the host
RSS; the ``Observability`` facade inert when off and, under one injected
clock, equal to the JAX one when on. Then the trainer: a 3-step CPU PPO run
in both packages with observability on gives the same obs stat keys and
``throughput/total_tokens`` per step and a ``trace.json`` with the same span
names, the port's ``losses/*`` are ``==`` with it off, ``profile_dir``
writes a ``torch.profiler`` trace and closes it when ``learn()`` raises
mid-window, and the watchdog's escalation restarts a wedged producer before
the supervisor's ``wedge_timeout_s``.

Every test leaves both packages' tracer, flight recorder, watchdog and
``obs/`` / ``time/`` gauges as it found them: they are process-global, and
the JAX test files sharing a worker read the JAX ones.
"""

import glob
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

import jax

from trlx_tpu.obs import flight as jax_flight
from trlx_tpu.obs import memory as jax_memory
from trlx_tpu.obs import runtime as jax_runtime
from trlx_tpu.obs import throughput as jax_throughput
from trlx_tpu.obs import tracer as jax_tracer
from trlx_tpu.obs import watchdog as jax_watchdog
from trlx_tpu.utils import metrics as jax_metrics
from trlx_tpu_torch.obs import flight, memory, runtime, throughput, tracer, watchdog
from trlx_tpu_torch.utils import metrics

pytestmark = pytest.mark.torch_port

ALPHABET = "abcdefgh "
PROMPTS = ["ab", "cd ef", "gh", "a b c", "hhh", "bad cafe", "e", "fg ab"]
OBS_PREFIXES = ("time/", "throughput/", "mem/", "obs/")


@pytest.fixture(autouse=True)
def _clean_obs_state():
    yield
    for trc, rec, wd, reg in ((tracer, flight, watchdog, metrics.gauges),
                              (jax_tracer, jax_flight, jax_watchdog, jax_metrics.gauges)):
        trc.configure(enabled=False)
        trc.reset()
        rec.configure(enabled=False)
        rec.reset()
        wd.install(None)
        for prefix in ("obs/", "time/", "resilience/", "rollout/"):
            reg.clear(prefix=prefix)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("n", [1, 2, 3, 10, 101])
def test_nearest_rank_matches_jax(n):
    xs = sorted(np.random.default_rng(n).normal(size=n).tolist())
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert metrics.nearest_rank(xs, q) == jax_metrics.nearest_rank(xs, q)
    assert metrics.nearest_rank([], 0.5) == jax_metrics.nearest_rank([], 0.5) == 0.0


@pytest.mark.parametrize("n", [1, 7, 600])
def test_hist_snapshot_matches_jax(n):
    rng = np.random.default_rng(n)
    port, ref = metrics.GaugeRegistry(hist_window=512), jax_metrics.GaugeRegistry(hist_window=512)
    for name in ("time/step", "time/step_other", "serving/latency"):
        for v in rng.exponential(size=n).tolist():
            port.observe(name, v)
            ref.observe(name, v)
    for prefix in ("", "time/step", "serving/", "missing/"):
        assert port.hist_snapshot(prefix) == ref.hist_snapshot(prefix)
    assert port.hist_snapshot("time/")["time/step_p95"] == ref.hist_stats("time/step")["p95"]


# ------------------------------------------------------------- throughput


@pytest.mark.parametrize("backward", [True, False])
@pytest.mark.parametrize("shape", [(0, 0, 0), (12, 768, 257), (2, 32, 16)])
def test_transformer_flops_per_token_matches_jax(backward, shape):
    n = 124_439_808
    assert throughput.transformer_flops_per_token(n, *shape, backward=backward) == \
        jax_throughput.transformer_flops_per_token(n, *shape, backward=backward)


@pytest.mark.parametrize("peak", [None, 1.0, 989.4])
def test_throughput_step_stats_match_jax(peak):
    kw = dict(n_params=124_439_808, num_devices=1, peak_device_tflops=peak, num_layers=12, hidden_size=768)
    port, ref = throughput.ThroughputAccountant(**kw), jax_throughput.ThroughputAccountant(**kw)
    rng = np.random.default_rng(3)
    for _ in range(4):
        tokens, samples, dt = int(rng.integers(1, 9000)), int(rng.integers(1, 64)), float(rng.uniform(0.01, 5))
        for backward in (True, False):
            a = port.step_stats(tokens, samples, dt, seq_len=257, backward=backward)
            b = ref.step_stats(tokens, samples, dt, seq_len=257, backward=backward)
            assert a == b
            assert ("throughput/mfu" in a) == (peak is not None)
    with pytest.raises(ValueError, match="n_params"):
        throughput.ThroughputAccountant(-1)


def test_peak_table_holds_nvidia_parts_only():
    table = throughput.PEAK_TFLOPS_BY_DEVICE_KIND
    assert table and not any("tpu" in k for k in table)
    assert not set(table) & set(jax_throughput.PEAK_TFLOPS_BY_DEVICE_KIND)
    assert throughput.detect_peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    for kind in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", "", "TPU v5p", "TPU v4"):
        assert throughput.detect_peak_tflops(kind) is None, kind
    assert jax_throughput.detect_peak_tflops("TPU v4") is not None  # the reference's own table


def _config_dict(tmp_path, **train_over):
    d = dict(
        method=dict(
            name="PPOConfig", num_rollouts=8, chunk_size=4, ppo_epochs=1, init_kl_coef=0.05,
            target=6.0, horizon=1000, gen_kwargs=dict(max_new_tokens=5, do_sample=False),
        ),
        train=dict(
            seq_length=16, epochs=2, total_steps=3, batch_size=4, minibatch_size=2,
            checkpoint_interval=100, eval_interval=100, checkpoint_dir=str(tmp_path / "ckpts"),
            pipeline="PromptPipeline", trainer="PPOTrainer", tracker=None, seed=2, save_best=False,
        ),
        model=dict(
            model_path="gpt2", num_layers_unfrozen=-1,
            model_overrides=dict(
                vocab_size=len(ALPHABET) + 3, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64, attention_impl="flash",
            ),
        ),
        tokenizer=dict(tokenizer_path=f"char://{ALPHABET}"),
        optimizer=dict(name="adamw", kwargs=dict(lr=3e-3, betas=(0.9, 0.95), weight_decay=1e-4,
                                                  max_grad_norm=1.0)),
        scheduler=dict(name="cosine_annealing", kwargs=dict(T_max=4, eta_min=1e-4)),
        mesh=dict(data=1, fsdp=1, model=1, compute_dtype="float32"),
    )
    d["train"].update(train_over)
    return d


def reward_fn(samples, **kw):
    return [float(s.count("a")) + 0.25 * s.count(" ") for s in samples]


@pytest.fixture
def single_device_mesh(monkeypatch):
    """Pin JAX trainer meshes to the first of conftest's 8 virtual CPU devices."""
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(
        mesh_lib, "mesh_from_config",
        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]),
    )


def _attach(trainer, pipeline_cls, cfg):
    max_prompt = cfg.train.seq_length - cfg.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(pipeline_cls(PROMPTS, max_prompt, trainer.tokenizer))
    trainer.add_eval_pipeline(pipeline_cls(PROMPTS[:4], max_prompt, trainer.tokenizer))


def _port_trainer(d, **overrides):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.utils.loading import get_trainer

    cfg = TRLConfig.update(TRLConfig.from_dict(d), overrides)
    trainer = get_trainer(cfg.train.trainer)(config=cfg, reward_fn=reward_fn, device="cpu")
    _attach(trainer, PromptPipeline, cfg)
    return trainer


def _jax_trainer(d, **overrides):
    import trlx_tpu.methods  # noqa: F401  (registers PPOConfig)
    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu.utils.loading import get_trainer

    cfg = TRLConfig.update(TRLConfig.from_dict(d), overrides)
    trainer = get_trainer(cfg.train.trainer)(config=cfg, reward_fn=reward_fn)
    _attach(trainer, PromptPipeline, cfg)
    return trainer


@pytest.mark.parametrize("hydra", [False, True], ids=["full", "hydra"])
def test_param_count_matches_jax(tmp_path, single_device_mesh, hydra):
    over = {"model.num_layers_unfrozen": 1, "method.num_value_layers_unfrozen": 1} if hydra else {}
    jt = _jax_trainer(_config_dict(tmp_path / "jax"), **over)
    pt = _port_trainer(_config_dict(tmp_path / "port"), **over)
    n = throughput.param_count(pt.model)
    assert n == jax_throughput.param_count(jt.params) > 0
    assert throughput.param_count(pt.model.state_dict()) >= n  # a state_dict also counts buffers
    for t in (jt, pt):
        t.obs.close()


def test_param_count_of_mappings_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": {"c": np.zeros(7), "d": np.ones((2, 2, 2))}}
    torch_tree = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(7), "d": np.ones((2, 2, 2))}}
    assert throughput.param_count(tree) == throughput.param_count(torch_tree) == jax_throughput.param_count(tree) == 27
    module = torch.nn.Linear(4, 3)
    assert throughput.param_count(module) == 15 == jax_throughput.param_count(
        {k: v.detach().numpy() for k, v in module.state_dict().items()})


# ------------------------------------------------------------ token count


def _ppo_batches():
    from trlx_tpu.data.ppo_types import PPORLBatch as JaxBatch
    from trlx_tpu_torch.data.ppo_types import PPORLBatch

    rng = np.random.default_rng(1)
    B, P, R = 4, 6, 5
    fields = dict(
        query_tensors=rng.integers(0, 9, (B, P)).astype(np.int32),
        response_tensors=rng.integers(0, 9, (B, R)).astype(np.int32),
        logprobs=rng.normal(size=(B, R)).astype(np.float32), values=rng.normal(size=(B, R)).astype(np.float32),
        rewards=rng.normal(size=(B, R)).astype(np.float32),
        attention_mask=(rng.random((B, P)) > 0.3).astype(np.int32),
        response_mask=(rng.random((B, R)) > 0.2).astype(np.int32),
    )
    torch_fields = {k: torch.from_numpy(v) for k, v in fields.items()}
    return JaxBatch(**fields), PPORLBatch(**fields), PPORLBatch(**torch_fields)


def _batch_cases():
    from trlx_tpu.data.ilql_types import ILQLBatch as JaxILQL
    from trlx_tpu_torch.data.ilql_types import ILQLBatch

    rng = np.random.default_rng(2)
    jppo, pppo, tppo = _ppo_batches()
    mask = (rng.random((3, 9)) > 0.25).astype(np.int32)
    ids = rng.integers(0, 30, (3, 9)).astype(np.int32)
    sft = {"input_ids": ids, "attention_mask": mask, "labels": ids}
    ilql = dict(input_ids=ids, attention_mask=mask, rewards=np.zeros((3, 2), np.float32),
                states_ixs=np.zeros((3, 3), np.int32), actions_ixs=np.zeros((3, 2), np.int32),
                dones=np.zeros((3, 3), np.int32))
    return {
        "ppo": (jppo, pppo),
        "ppo-torch": (jppo, tppo),
        "sft": (sft, sft),
        "sft-torch": (sft, {k: torch.from_numpy(v) for k, v in sft.items()}),
        "ilql": (JaxILQL(**ilql), ILQLBatch(**ilql)),
        "input_ids-2d": ({"input_ids": ids}, {"input_ids": torch.from_numpy(ids)}),
        "input_ids-list": ({"input_ids": [[1, 2], [3]]}, {"input_ids": [[1, 2], [3]]}),
        "empty": ({}, {}),
    }


@pytest.mark.parametrize("case", ["ppo", "ppo-torch", "sft", "sft-torch", "ilql", "input_ids-2d",
                                  "input_ids-list", "empty"])
def test_batch_token_count_matches_jax(case):
    jax_batch, port_batch = _batch_cases()[case]
    got = runtime.batch_token_count(port_batch)
    assert got == jax_runtime.batch_token_count(jax_batch)
    assert all(isinstance(x, int) for x in got)


# ----------------------------------------------------------------- memory


def test_device_memory_stats_on_the_cpu_has_the_jax_cpu_keys():
    ref = jax_memory.device_memory_stats()
    assert set(ref) == {"mem/host_rss_gb"}  # the JAX CPU backend has no allocator stats
    assert set(memory.device_memory_stats("cpu")) == set(ref)
    assert set(memory.device_memory_stats(torch.device("cpu"), prefix="x/")) == {"x/host_rss_gb"}
    assert memory.host_rss_bytes() > 0


def test_device_memory_stats_reads_the_cuda_allocator(monkeypatch):
    gib = 1024 ** 3
    stats = {"allocated_bytes.all.current": 3 * gib, "allocated_bytes.all.peak": 5 * gib,
             "reserved_bytes.all.current": 6 * gib}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(total_memory=80 * gib))
    monkeypatch.setattr(memory, "host_rss_bytes", lambda: pytest.fail("the host RSS was read for a CUDA device"))
    got = memory.device_memory_stats(torch.device("cuda", 0))
    assert got == {"mem/bytes_in_use_max_gb": 3.0, "mem/peak_bytes_in_use_max_gb": 5.0,
                   "mem/bytes_limit_gb": 80.0, "mem/utilization": 3 / 80}
    stats.clear()
    with pytest.raises(RuntimeError, match="no statistics"):
        memory.device_memory_stats(torch.device("cuda", 0))


# ---------------------------------------------------------------- runtime


def _obs_cfg(port: bool, **over):
    if port:
        from trlx_tpu_torch.data.configs import ObservabilityConfig
    else:
        from trlx_tpu.data.configs import ObservabilityConfig
    return ObservabilityConfig(**over)


def test_observability_disabled_is_inert():
    before = threading.active_count()
    obs = runtime.Observability(_obs_cfg(True, enabled=False, watchdog_timeout_s=5.0), device="cpu")
    with obs.span("learn"):
        pass
    obs.beat()
    obs.configure_model(torch.nn.Linear(2, 2))
    assert obs.step_stats(100, 4, 16) == {}
    assert obs.watchdog is None and obs.accountant is None and obs.series is None
    assert not tracer.enabled and not flight.enabled
    assert tracer.drain_step_times() == {}
    assert threading.active_count() == before
    obs.close()


def test_observability_step_stats_match_jax(tmp_path, monkeypatch):
    """Both facades under one injected clock: span keys, ``time/step`` and its
    percentiles, throughput and MFU equal; memory keys equal (the host RSS
    on both sides)."""
    clock = {"t": 100.0}
    fake_time = types.SimpleNamespace(monotonic=lambda: clock["t"])
    monkeypatch.setattr(runtime, "time", fake_time)
    monkeypatch.setattr(jax_runtime, "time", fake_time)
    for reg in (metrics.gauges, jax_metrics.gauges):
        reg.clear(prefix="time/")
    kw = dict(enabled=True, trace_path="trace.json", trace_device=False, peak_device_tflops=2.0,
              watchdog_timeout_s=30.0)
    port = runtime.Observability(_obs_cfg(True, **kw), logging_dir=str(tmp_path / "port"), device="cpu")
    try:
        port.configure_model({"w": torch.zeros(10, 10)}, types.SimpleNamespace(num_layers=2, hidden_size=10))
        port_steps = []
        for dt, tokens in ((0.0, 64), (0.5, 64), (0.25, 100)):
            clock["t"] += dt
            with port.span("learn"):
                pass
            port.beat()
            port_steps.append(port.step_stats(tokens, 4, 16))
        assert port.watchdog is not None and port.watchdog.running
    finally:
        port.close()
    clock["t"] = 100.0
    ref = jax_runtime.Observability(_obs_cfg(False, **kw), logging_dir=str(tmp_path / "jax"))
    try:
        ref.configure_model({"w": np.zeros((10, 10))}, types.SimpleNamespace(num_layers=2, hidden_size=10))
        ref_steps = []
        for dt, tokens in ((0.0, 64), (0.5, 64), (0.25, 100)):
            clock["t"] += dt
            with ref.span("learn"):
                pass
            ref.beat()
            ref_steps.append(ref.step_stats(tokens, 4, 16))
    finally:
        ref.close()
    for a, b in zip(port_steps, ref_steps):
        assert set(a) == set(b)
        same = [k for k in a if k.startswith(("throughput/", "time/step")) or k.endswith("_n")]
        # the JAX facade divides by the peak of every device of its mesh
        # (conftest's 8 virtual CPUs), the port by its one device's
        b = {**b, "throughput/mfu": b["throughput/mfu"] * jax.device_count()} if "throughput/mfu" in b else b
        assert {k: a[k] for k in same} == {k: b[k] for k in same}
    assert "throughput/mfu" in port_steps[1] and "throughput/mfu" not in port_steps[0]
    assert port.watchdog is None
    for side in ("port", "jax"):
        with open(tmp_path / side / "trace.json") as f:
            names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
        assert names == {"learn"}


def test_observability_without_a_known_peak_omits_mfu(caplog):
    obs = runtime.Observability(_obs_cfg(True, enabled=True, trace_device=False), device="cpu")
    try:
        obs.configure_model(torch.nn.Linear(3, 3))
        assert obs.accountant.peak_device_tflops is None
        obs.step_stats(10, 1)
        stats = obs.step_stats(10, 1)
        assert "throughput/model_tflops_per_sec" in stats and "throughput/mfu" not in stats
    finally:
        obs.close()
    assert runtime.device_kind("cpu") == "cpu"


# ---------------------------------------------------------------- trainer


def _record_obs(trainer):
    """Capture each step's obs stats and raw train_step stats."""
    rec = {"obs": [], "steps": []}
    step_stats, train_step = trainer.obs.step_stats, trainer.train_step

    def obs_step_stats(*a, **kw):
        out = step_stats(*a, **kw)
        rec["obs"].append(dict(out))
        return out

    def recorded_train_step(batch):
        out = train_step(batch)
        rec["steps"].append(dict(out))
        return out

    trainer.obs.step_stats, trainer.train_step = obs_step_stats, recorded_train_step
    return rec


def _obs_overrides(**over):
    return {"train.observability": dict(enabled=True, trace_path="trace.json", peak_device_tflops=1.0,
                                        watchdog_timeout_s=120.0, series_path="series.jsonl",
                                        prom_path="metrics.prom", **over)}


def _trace_names(logs_dir):
    with open(os.path.join(logs_dir, "trace.json")) as f:
        return {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}


def test_ppo_obs_stats_and_trace_match_jax(tmp_path, single_device_mesh):
    for reg in (metrics.gauges, jax_metrics.gauges):
        reg.clear(prefix="obs/")
        reg.clear(prefix="time/")
    jt = _jax_trainer(_config_dict(tmp_path / "jax"), **_obs_overrides())
    jrec = _record_obs(jt)
    jt.learn()
    pt = _port_trainer(_config_dict(tmp_path / "port"), **_obs_overrides())
    prec = _record_obs(pt)
    pt.learn()

    assert len(prec["obs"]) == len(jrec["obs"]) == 3
    for i, (a, b) in enumerate(zip(prec["obs"], jrec["obs"])):
        pa = {k for k in a if k.startswith(OBS_PREFIXES)}
        pb = {k for k in b if k.startswith(OBS_PREFIXES)}
        assert pa == pb, f"step {i + 1}: {sorted(pa ^ pb)}"
        if i:
            assert a["throughput/total_tokens"] == b["throughput/total_tokens"]
    assert {"time/span/learn", "time/span/generate", "time/span/score", "time/span/reward"} <= set(prec["obs"][2])
    assert "mem/host_rss_gb" in prec["obs"][0]
    assert pt.obs.accountant.n_params == throughput.param_count(pt.model)
    assert pt.obs.watchdog is None and not tracer.enabled  # closed by learn()
    port_logs, jax_logs = tmp_path / "port" / "ckpts" / "logs", tmp_path / "jax" / "ckpts" / "logs"
    assert _trace_names(port_logs) == _trace_names(jax_logs) >= {"generate", "learn", "score", "reward"}
    from trlx_tpu_torch.obs import read_jsonl_series, read_prometheus

    assert read_jsonl_series(str(port_logs / "series.jsonl"))
    assert "obs/flight/completed" in read_prometheus(str(port_logs / "metrics.prom"))


def test_obs_on_leaves_the_losses_unchanged(tmp_path):
    off = _port_trainer(_config_dict(tmp_path / "off"))
    off_rec = _record_obs(off)
    off.learn()
    on = _port_trainer(_config_dict(tmp_path / "on"), **_obs_overrides(), **{
        "train.profile_dir": str(tmp_path / "prof"), "train.profile_start_step": 1, "train.profile_end_step": 3})
    on_rec = _record_obs(on)
    on.learn()
    assert off_rec["obs"] == []  # off: the loop never asks for obs stats
    assert len(on_rec["steps"]) == len(off_rec["steps"]) == 3
    for a, b in zip(on_rec["steps"], off_rec["steps"]):
        losses = {k: v for k, v in b.items() if k.startswith("losses/")}
        assert losses and {k: a[k] for k in losses} == losses
    for a, b in zip(on.model.state_dict().values(), off.model.state_dict().values()):
        assert torch.equal(a, b)
    [trace] = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "learn" for e in events)  # the span's record_function range


def test_profile_dir_closes_the_window_when_learn_raises(tmp_path):
    trainer = _port_trainer(_config_dict(tmp_path), **{
        "train.profile_dir": str(tmp_path / "prof"), "train.profile_start_step": 1, "train.profile_end_step": 3})
    step = trainer.train_step

    def failing_step(batch):
        if trainer.iter_count == 1:  # inside the window [1, 3)
            assert torch.autograd._profiler_enabled()
            raise RuntimeError("injected failure mid-window")
        return step(batch)

    trainer.train_step = failing_step
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer.learn()
    assert not torch.autograd._profiler_enabled()
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_watchdog_escalation_restarts_a_wedged_producer(tmp_path, monkeypatch):
    """``producer-wedge:1`` under the supervisor with the obs watchdog at 2 s
    and the supervisor's own timer at 24 s: the one restart is the
    watchdog's escalation, the drain ledger balances, no producer is left."""
    from trlx_tpu_torch.resilience import chaos
    from trlx_tpu_torch.rollout import ProducerSupervisor

    reasons = []
    restart = ProducerSupervisor._restart

    def recorded_restart(self, reason, cause=None):
        reasons.append((reason, self.wedge_timeout_s))
        return restart(self, reason, cause)

    monkeypatch.setattr(ProducerSupervisor, "_restart", recorded_restart)
    monkeypatch.setenv("TRLX_CHAOS", "producer-wedge:1")
    try:
        trainer = _port_trainer(_config_dict(tmp_path, total_steps=2), **{
            "train.observability": dict(enabled=True, watchdog_timeout_s=2.0),
            "train.self_healing": dict(enabled=True, wedge_timeout_s=24.0, restart_backoff_base_s=0.01),
            "train.async_rollouts": dict(enabled=True, max_staleness=2, publish_interval=1)})
        trainer.learn()
    finally:
        chaos.configure(None)
    assert reasons == [("watchdog escalation: stale producer heartbeat", 24.0)]
    ledger = trainer.rollout_engine_summary
    assert ledger["producer_restarts"] == 1
    assert ledger["produced"] == ledger["consumed"] + ledger["dropped_stale"] + ledger["leftover"] + \
        ledger["dropped_shutdown"]
    assert not [t for t in threading.enumerate() if t.name == "rollout-producer" and t.is_alive()]
    assert trainer.iter_count == 2
