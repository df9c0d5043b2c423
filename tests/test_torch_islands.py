"""Port parity for generation islands and the chunked broadcast:
trlx_tpu_torch's ``rollout.broadcast`` (``layer_chunks``,
``ChunkedParameterPublisher``), ``serving.island.GenerationIsland``,
``obs.islands.IslandLedger`` and ``parallel.mesh.carve_islands`` against
trlx_tpu's, case by case as tests/test_islands.py runs them
(``test_island_meshes_are_disjoint`` builds a JAX ``Mesh`` and stays with
the scale-out slice). Compared: the chunk names, their order and each
chunk's bytes against the JAX publisher on the same tiny gpt2 (the port
publishes ``state_dict``s, grouped by the first dotted key component), bit
identity with the monolithic publisher, no torn version under concurrent
reads, the mid-broadcast crash, the blocking gate, ``carve_islands`` on a
device list, the ledger's numbers on the same intervals, one prefix flush
per swapped version on the tiny engine (tokens equal to the JAX engine's),
the supervised re-attach, the idle-bubble proof (and its inversion under
``TRLX_ISLAND_SEED_REGRESSION=blocking_broadcast``), and the trainer
wiring (``train.islands`` with async rollouts and the engine, and LoRA PPO under
it against the JAX trainer). An island
over a ``FleetRouter`` raises in both packages.

Timing thresholds are the JAX file's (host clock, seconds). Each test
closes what it builds and disarms both packages' chaos.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import trlx_tpu.rollout as jrollout
from trlx_tpu.obs.islands import IslandLedger as JaxLedger
from trlx_tpu.parallel.mesh import carve_islands as jax_carve
from trlx_tpu.resilience.chaos import chaos as jax_chaos
from trlx_tpu.serving import GenerationIsland as JaxIsland
from trlx_tpu.utils.metrics import gauges as jax_gauges
from trlx_tpu_torch.models.convert import params_from_jax
from trlx_tpu_torch.models.presets import PRESETS
from trlx_tpu_torch.models.transformer import TransformerLM
from trlx_tpu_torch.obs.islands import IslandLedger
from trlx_tpu_torch.parallel.mesh import IslandPlacement, carve_islands
from trlx_tpu_torch.resilience.chaos import ChaosInjectedError, chaos
from trlx_tpu_torch.rollout import ChunkedParameterPublisher, ParameterPublisher, layer_chunks
from trlx_tpu_torch.serving import GenerationIsland, ServingEngine, ServingSupervisor
from trlx_tpu_torch.utils.metrics import gauges

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)


def _clear_gauges():
    for registry in (jax_gauges, gauges):
        for prefix in ("serving/", "rollout/broadcast/"):
            registry.clear(prefix=prefix)


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    """Disarm both packages' chaos; each test starts from empty ``serving/``
    and ``rollout/broadcast/`` gauge namespaces in both (process-global)
    registries, which other test files on the same worker may have left
    set, and leaves them empty."""
    monkeypatch.delenv("TRLX_ISLAND_SEED_REGRESSION", raising=False)
    _clear_gauges()
    yield
    chaos.configure(None)
    jax_chaos.configure(None)
    _clear_gauges()


def _tree(fill: float, layers: int = 4) -> dict:
    """The JAX file's tree as a ``state_dict``: ``wte``, ``h_<i>.w``,
    ``h_<i>.b``, ``ln_f``, every element ``fill``."""
    out = {"wte": torch.full((8, 4), fill)}
    for i in range(layers):
        out[f"h_{i}.w"] = torch.full((4, 4), fill)
        out[f"h_{i}.b"] = torch.full((4,), fill)
    out["ln_f"] = torch.full((4,), fill)
    return out


def _jax_tree(fill: float, layers: int = 4) -> dict:
    out = {"wte": np.full((8, 4), fill, np.float32)}
    for i in range(layers):
        out[f"h_{i}"] = {"w": np.full((4, 4), fill, np.float32), "b": np.full((4,), fill, np.float32)}
    out["ln_f"] = np.full((4,), fill, np.float32)
    return out


def _same_state(a, b) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def weights():
    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM

    jcfg = JAX_PRESETS["gpt2"].replace(**TINY, compute_dtype=jnp.float32)
    init = JaxLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, init)
    tcfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32)
    trunk = TransformerLM(tcfg)
    trunk.load_state_dict(params_from_jax(params, tcfg))
    return jcfg, params, tcfg, trunk.state_dict(), init


# ------------------------------------------------------------ chunk splitting


def test_layer_chunks_grouping_and_names_as_jax():
    tree, jtree = _tree(1.0), _jax_tree(1.0)
    for k in (1, 2, 4):
        got, want = layer_chunks(tree, chunk_layers=k), jrollout.layer_chunks(jtree, chunk_layers=k)
        assert [n for n, _ in got] == [n for n, _ in want]
        rebuilt = {}
        for _, sub in got:
            rebuilt.update(sub)
        assert _same_state(rebuilt, tree)  # reassembly by key is exact, in order
    assert [n for n, _ in layer_chunks(tree, 1)] == ["wte", "h_0", "h_1", "h_2", "h_3", "ln_f"]
    assert [n for n, _ in layer_chunks(tree, 4)] == ["wte..h_2", "h_3..ln_f"]
    assert layer_chunks(torch.ones(3))[0][0] == "all" == jrollout.layer_chunks(np.ones(3))[0][0]
    assert layer_chunks([torch.ones(3)], chunk_layers=2)[0][0] == "all"


@pytest.mark.parametrize("chunk_layers", [1, 2, 4])
def test_model_chunk_manifest_matches_the_jax_publisher(weights, chunk_layers):
    """The tiny gpt2 trunk published by both packages (the port's
    ``state_dict``, JAX's params tree as ``init`` returns it, in module
    order: a ``jax.tree.map`` would sort its keys): the same chunk names in
    the same order, each of the same bytes (f32)."""
    _, _, _, state, params = weights
    jpub, tpub = jrollout.ChunkedParameterPublisher(chunk_layers=chunk_layers), ChunkedParameterPublisher(
        chunk_layers=chunk_layers)
    assert jpub.publish(params) == tpub.publish(state) == 0
    want, got = jpub.manifest(), tpub.manifest()
    assert (got.version, got.chunk_names, got.chunk_bytes) == (want.version, want.chunk_names, want.chunk_bytes)
    assert got.chunk_names[0].startswith("embed_tokens") and got.chunk_names[-1].endswith("ln_f")
    assert got.total_bytes == sum(v.numel() * v.element_size() for v in state.values())
    jpub.close()
    tpub.close()


# ------------------------------------------------------- parity + atomicity


def test_chunked_publish_bit_identical_to_monolithic():
    tree = _tree(3.25)
    mono, chunked = ParameterPublisher(), ChunkedParameterPublisher(chunk_layers=2)
    assert mono.publish(tree) == chunked.publish(tree) == 0
    _, snap_m = mono.latest()
    _, snap_c = chunked.latest()
    assert _same_state(snap_m, snap_c) and _same_state(snap_c, tree)
    assert all(snap_c[k].data_ptr() != tree[k].data_ptr() for k in tree)  # copies, not the live tensors
    m = chunked.manifest()
    assert m.version == 0 and m.num_chunks == len(layer_chunks(tree, 2))
    assert m.total_bytes == sum(v.numel() * v.element_size() for v in tree.values())
    chunked.close()


def test_latest_raises_before_first_commit_as_jax():
    for pub in (ChunkedParameterPublisher(), jrollout.ChunkedParameterPublisher()):
        with pytest.raises(RuntimeError, match="before first commit"):
            pub.latest()
        assert pub.poll_update(-1) is None
        assert pub.version == -1 and pub.manifest() is None


def test_no_torn_version_under_concurrent_reads():
    """Readers hammering latest()/poll_update() while the publisher streams
    chunks only ever see snapshots whose every element is the version's
    fill value."""
    pub = ChunkedParameterPublisher(chunk_layers=1, chunk_pause_s=0.002)
    pub.publish(_tree(0.0))
    stop = threading.Event()
    torn = []

    def reader():
        last = -1
        while not stop.is_set():
            version, snap = pub.latest()
            vals = {float(v.reshape(-1)[0]) for v in snap.values()}
            if vals != {float(version)}:
                torn.append((version, vals))
            upd = pub.poll_update(last)
            if upd is not None:
                last = upd[0]

    threads = [threading.Thread(target=reader, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for v in range(1, 6):
        pub.publish(_tree(float(v)))
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert not torn, f"torn versions observed: {torn[:3]}"
    assert pub.version == 5
    pub.close()


def test_midbroadcast_crash_burns_version_and_recovers_as_jax():
    """A publish dying mid-broadcast keeps the previous version committed,
    burns its version number and counts the abort, in both packages."""

    def scenario(pub, chaos_obj, tree, same, err):
        v0 = pub.publish(tree(1.0))
        chaos_obj.configure("broadcast-chunk:1")
        try:
            with pytest.raises(err, match="broadcast-chunk"):
                pub.publish(tree(2.0))
        finally:
            chaos_obj.configure("")
        version, snap = pub.latest()
        kept = same(snap, tree(1.0))
        aborted = pub.stats()["aborted"]
        v2 = pub.publish(tree(3.0))
        out = (v0, version, kept, aborted, v2, same(pub.latest()[1], tree(3.0)))
        pub.close()
        return out

    def jax_same(a, b):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        return len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))

    from trlx_tpu.resilience.chaos import ChaosInjectedError as JaxChaosError

    want = scenario(jrollout.ChunkedParameterPublisher(chunk_layers=1), jax_chaos, _jax_tree, jax_same, JaxChaosError)
    got = scenario(ChunkedParameterPublisher(chunk_layers=1), chaos, _tree, _same_state, ChaosInjectedError)
    assert got == want == (0, 0, True, 1, 2, True)


def test_seed_regression_env_validation_as_jax(monkeypatch):
    monkeypatch.setenv("TRLX_ISLAND_SEED_REGRESSION", "typo_mode")
    for cls in (ChunkedParameterPublisher, jrollout.ChunkedParameterPublisher):
        with pytest.raises(ValueError, match="TRLX_ISLAND_SEED_REGRESSION"):
            cls()
    monkeypatch.setenv("TRLX_ISLAND_SEED_REGRESSION", "blocking_broadcast")
    assert ChunkedParameterPublisher()._blocking is True


def test_blocking_broadcast_holds_round_gate(monkeypatch):
    """Normal mode releases the round gate between chunks (a mid-broadcast
    acquire waits microseconds); ``blocking_broadcast`` holds it for the
    whole broadcast."""
    gate = threading.Lock()

    def gate_wait_mid_broadcast(pub) -> float:
        t = threading.Thread(target=lambda: pub.publish(_tree(1.0, layers=8)), daemon=True)
        t.start()
        time.sleep(0.01)
        t0 = time.monotonic()
        gate.acquire()
        waited = time.monotonic() - t0
        gate.release()
        t.join(timeout=5)
        assert not t.is_alive()
        return waited

    normal = ChunkedParameterPublisher(round_gate=gate, chunk_pause_s=0.005)
    assert gate_wait_mid_broadcast(normal) < 0.015, "normal mode must release the gate between chunks"
    monkeypatch.setenv("TRLX_ISLAND_SEED_REGRESSION", "blocking_broadcast")
    blocking = ChunkedParameterPublisher(round_gate=gate, chunk_pause_s=0.005)
    assert gate_wait_mid_broadcast(blocking) > 0.015, "blocking_broadcast must hold the gate for the broadcast"


# ------------------------------------------------------------- mesh carving


def test_carve_islands_placement_as_jax(monkeypatch):
    devices = list(range(8))
    for gen in (1, 2, 7):
        assert tuple(carve_islands(gen, devices=devices)) == tuple(jax_carve(gen, devices=devices))
    p = carve_islands(2, devices=devices)
    assert p.gen == (6, 7) and p.learn == tuple(range(6)) and not p.shared
    p1 = carve_islands(1, devices=[0])
    assert p1.shared and p1.gen == p1.learn == (0,)
    for bad in (0, 8):
        for carve in (carve_islands, jax_carve):
            with pytest.raises(ValueError):
                carve(bad, devices=devices)
    # the default device list is every CUDA device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    p4 = carve_islands(1)
    assert isinstance(p4, IslandPlacement) and p4.gen == (torch.device("cuda", 3),)
    assert p4.learn == tuple(torch.device("cuda", i) for i in range(3))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="at least one device"):
        carve_islands(1)


# ------------------------------------------------------------ island ledger


def test_island_ledger_merges_and_windows_as_jax():
    def scenario(led):
        out = [led.idle_fraction(until=1.0)]
        led.open_window(10.0)
        led.note_busy(10.0, 10.4)
        led.note_busy(10.4002, 10.6)  # within the merge epsilon: bridged
        led.note_busy(10.8, 11.0)  # a genuine 0.2 s stall before it
        out += [led.busy_s(until=11.0), led.idle_fraction(until=11.0), led.snapshot(until=11.0)]
        led.open_window(20.0)
        led.note_busy(19.0, 20.5)
        out.append(led.busy_s(until=21.0))
        return out

    got, want = scenario(IslandLedger("gen")), scenario(JaxLedger("gen"))
    assert got == want
    assert got[0] == 0.0 and got[1] == pytest.approx(0.8, abs=1e-6)
    assert got[2] == pytest.approx(0.2, abs=1e-3) and got[3]["gen_wall_s"] == pytest.approx(1.0)
    assert got[4] == pytest.approx(0.5, abs=1e-6)


# -------------------------------------------- engine round-boundary swapping


def _engines(weights, **kw):
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.serving import ServingEngine as JaxEngine

    jcfg, params, tcfg, state, _ = weights
    common = dict(num_slots=3, max_seq_len=32, block_size=4, eos_token_id=None, pad_token_id=0,
                  gen_kwargs=dict(do_sample=False), seed=0, **kw)
    return (JaxEngine(JaxLM(jcfg), params, **common),
            ServingEngine(TransformerLM(tcfg), state, device="cpu", **common))


def test_engine_swaps_at_round_boundary_one_flush_per_version_as_jax(weights):
    """With an island attached each committed broadcast is installed once,
    at a round boundary, with one prefix-cache flush per version; the tokens
    across the swaps equal the JAX engine's."""
    _, params, _, state, _ = weights
    out = []
    for (eng, island_cls, pub_cls, snap), g in zip(
            ((_engines(weights)[0], JaxIsland, jrollout.ChunkedParameterPublisher, params),
             (_engines(weights)[1], GenerationIsland, ChunkedParameterPublisher, state)), (jax_gauges, gauges)):
        island = island_cls(eng)
        pub = pub_cls(chunk_layers=2)
        island.bind_publisher(pub)
        island.open_window()
        flushes = []
        real_flush = eng.allocator.flush_prefix_cache
        eng.allocator.flush_prefix_cache = lambda real_flush=real_flush: (flushes.append(1), real_flush())[1]
        facts = [eng.serving_version]
        pub.publish(snap)
        uid = eng.submit([5, 9, 11], 4)
        done = eng.run([uid])
        facts += [list(done[uid].generated), eng.serving_version, len(flushes)]
        pub.publish(snap)
        uid2 = eng.submit([2, 3], 4)
        facts += [list(eng.run([uid2])[uid2].generated), eng.serving_version, len(flushes)]
        s = island.summary()
        facts += [s["swaps"], s["serving_version"], s["published_version"], island.gen_ledger.busy_s() > 0.0]
        island.close()
        eng.close()
        facts += [g.snapshot("serving/island/"), g.snapshot("rollout/broadcast/")]
        out.append(facts)
    want, got = out
    assert got == want
    assert got[0] == -1 and got[2:4] == [0, 1] and got[5:7] == [1, 2]
    assert got[7:11] == [2.0, 1.0, 1.0, True] and got[11] == {} == got[12]


def test_supervised_restart_reattaches_island_as_jax(weights):
    """A supervised restart re-attaches the island: the successor's first
    round fresh-installs the newest committed version."""
    from trlx_tpu.serving.supervisor import ServingSupervisor as JaxSupervisor

    _, params, _, state, _ = weights
    out = []
    for k, (sup_cls, island_cls, pub_cls, snap, chaos_obj) in enumerate((
            (JaxSupervisor, JaxIsland, jrollout.ChunkedParameterPublisher, params, jax_chaos),
            (ServingSupervisor, GenerationIsland, ChunkedParameterPublisher, state, chaos))):
        engines = []

        def factory(k=k, engines=engines):
            engine = _engines(weights)[k]
            engines.append(engine)
            return engine

        sup = sup_cls(factory, max_restarts=2, backoff_base_s=0.0, wedge_timeout_s=None)
        island = island_cls(sup)
        pub = pub_cls()
        island.bind_publisher(pub)
        pub.publish(snap)
        uid = sup.submit([5, 9, 11], 4)
        facts = [list(sup.run([uid])[uid].generated), sup.serving_version]
        chaos_obj.configure("serving-decode:1")
        try:
            uid2 = sup.submit([2, 3], 4)
            done = sup.run([uid2])
        finally:
            chaos_obj.configure("")
        facts += [list(done[uid2].generated), sup.restarts, len(engines), engines[-1]._island is island,
                  sup.serving_version]
        sup.close()
        for eng in engines:
            eng.close()
        island.close()
        out.append(facts)
    want, got = out
    assert got == want
    assert got[1] == 0 and got[3:] == [1, 2, True, 0] and len(got[2]) == 4


def test_island_over_a_fleet_router_raises_as_jax(weights, tmp_path):
    """A fleet has no ``attach_island``: an island over a router raises in
    both packages (islands over a fleet are not a feature of either)."""
    import trlx_tpu.fleet as jfleet
    import trlx_tpu_torch.fleet as tfleet

    for k, (fleet, island_cls) in enumerate(((jfleet, JaxIsland), (tfleet, GenerationIsland))):
        router = fleet.FleetRouter(lambda seat, k=k: _engines(weights)[k], 1, wedge_timeout_s=None,
                                   diagnostics_dir=str(tmp_path))
        try:
            with pytest.raises(AttributeError, match="attach_island"):
                island_cls(router)
        finally:
            router.close()


# --------------------------------------------------------- idle-bubble proof


class _FakeEngine:
    serving_version = -1

    def attach_island(self, island):
        self._island = island


@pytest.mark.parametrize("mode", ["chunked", "blocking_broadcast"])
def test_island_idle_bubble_proof(monkeypatch, mode):
    """The measured claim (host clock): with chunk installs at round
    boundaries the generation island's idle-bubble fraction stays under 0.1
    and the broadcast hides under decode; under ``blocking_broadcast`` the
    publisher squats on the gate and the same check fails."""
    if mode == "blocking_broadcast":
        monkeypatch.setenv("TRLX_ISLAND_SEED_REGRESSION", mode)
    island = GenerationIsland(_FakeEngine())
    pub = ChunkedParameterPublisher(chunk_layers=1, chunk_pause_s=0.005, round_gate=island.round_gate)
    island.bind_publisher(pub)
    stop = threading.Event()

    def decode_loop():
        # every round touches the gate, as ServingEngine.step does, then
        # ~2 ms of "device work"
        while not stop.is_set():
            island.round_gate.acquire()
            island.round_gate.release()
            t0 = time.monotonic()
            time.sleep(0.002)
            island.note_round(t0, time.monotonic())

    t = threading.Thread(target=decode_loop, daemon=True)
    t.start()
    time.sleep(0.05)
    island.open_window()
    deadline = time.monotonic() + 0.6
    version = 0
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        version = pub.publish(_tree(float(version + 1), layers=6))
        island.note_learn(t0, time.monotonic())
        time.sleep(0.03)
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    s = island.summary()
    island.close()
    held = s["gen_idle_frac"] < 0.1 and s["broadcast_hidden_frac"] > 0.5
    assert s["swaps"] == 0.0 and s["published_version"] == float(version)
    if mode == "chunked":
        assert held, f"broadcasts are not hiding under decode: {s}"
    else:
        assert not held, f"the blocking broadcast went unnoticed: {s}"


# ------------------------------------------------------------ trainer wiring


def test_islands_config_off_by_default_as_jax():
    from trlx_tpu.data.configs import IslandConfig as JaxIslandConfig
    from trlx_tpu_torch.data.configs import IslandConfig, TRLConfig

    assert IslandConfig().enabled is False and vars(IslandConfig()) == vars(JaxIslandConfig())
    config = TRLConfig.from_dict({
        "train": {"seq_length": 8, "epochs": 1, "total_steps": 1, "batch_size": 2, "checkpoint_interval": 1,
                  "eval_interval": 1, "pipeline": "PromptPipeline", "trainer": "PPOTrainer",
                  "islands": {"enabled": True, "gen_devices": 2, "chunk_layers": 4, "chunk_pause_s": 0.001}},
        "method": {"name": "PPOConfig", "num_rollouts": 2, "chunk_size": 2, "ppo_epochs": 1, "init_kl_coef": 0.01,
                   "target": None, "gen_kwargs": {"max_new_tokens": 2}},
        "model": {"model_path": "gpt2"}, "tokenizer": {"tokenizer_path": "char://ab"},
        "optimizer": {"name": "adamw", "kwargs": {"lr": 1e-3}},
        "scheduler": {"name": "cosine_annealing", "kwargs": {"T_max": 10}},
    })
    icfg = config.train.islands
    assert icfg.enabled and icfg.gen_devices == 2 and icfg.chunk_layers == 4 and icfg.chunk_pause_s == 0.001


def _islands_trainer(tmp_path, monkeypatch, islands=None, serving=None):
    """The tiny port PPO trainer with the async engine resolved and its
    producer thread suppressed: enough to inspect what _start_async_engine
    wired up."""
    from tests.test_torch_trainer_serving import PROMPTS, _config_dict, reward_fn
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.rollout.engine import AsyncRolloutEngine
    from trlx_tpu_torch.utils.loading import get_trainer

    d = _config_dict(tmp_path, serving)
    d["train"]["async_rollouts"] = dict(enabled=True, max_staleness=4)
    if islands is not None:
        d["train"]["islands"] = islands
    monkeypatch.setattr(AsyncRolloutEngine, "start", lambda self: None)
    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 12, trainer.tokenizer))
    trainer._resolve_serving()
    trainer._async_cfg = trainer._resolve_async_config()
    assert trainer._async_cfg is not None
    trainer._start_async_engine()
    return trainer


SERVING = dict(enabled=True, num_slots=3, block_size=4)


def test_trainer_islands_off_is_monolithic(tmp_path, monkeypatch):
    trainer = _islands_trainer(tmp_path, monkeypatch, serving=SERVING)
    assert type(trainer._engine.publisher) is ParameterPublisher
    assert trainer._island is None and trainer._serving_engine._island is None
    trainer.on_learn_end()


def test_trainer_islands_requires_serving(tmp_path, monkeypatch):
    trainer = _islands_trainer(tmp_path, monkeypatch, islands=dict(enabled=True))
    assert trainer._serving_client is None
    assert type(trainer._engine.publisher) is ParameterPublisher and trainer._island is None
    trainer.on_learn_end()


def test_trainer_islands_requires_async_rollouts(tmp_path, monkeypatch):
    """``train.islands`` without ``train.async_rollouts`` warns as the
    reference does and runs the synchronous experience phase: no island,
    the engine serves with none attached."""
    from tests.test_torch_trainer_serving import PROMPTS, _config_dict, reward_fn
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.pipeline import PromptPipeline
    from trlx_tpu_torch.trainer import ppo_trainer
    from trlx_tpu_torch.utils.loading import get_trainer

    d = _config_dict(tmp_path, SERVING)
    d["train"]["islands"] = dict(enabled=True)
    warned = []
    monkeypatch.setattr(ppo_trainer.logger, "warning", lambda msg, *a, **kw: warned.append(msg))
    trainer = get_trainer("PPOTrainer")(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, 12, trainer.tokenizer))
    trainer.prepare_learning()
    assert any("train.islands requires train.async_rollouts" in str(m) for m in warned)
    assert trainer._async_cfg is None and trainer._island is None
    assert trainer._serving_engine._island is None and trainer._serving_engine.serving_version == -1
    assert len(trainer.store.history) == d["method"]["num_rollouts"]
    trainer.on_learn_end()


def test_lora_ppo_under_islands_matches_jax(tmp_path, monkeypatch):
    """LoRA PPO with ``train.islands`` (async rollouts through the serving
    engine as the generation island, the chunked publisher) in both
    packages from the same weights: the first store and two learner steps
    agree within the trainer-parity limits, and each package's island
    leaves its gauges empty."""
    from tests.test_torch_peft_trainers import _elements_close, _stats_close, async_lora_ppo_runs
    from trlx_tpu.parallel import mesh as mesh_lib

    real = mesh_lib.make_mesh
    monkeypatch.setattr(mesh_lib, "mesh_from_config",
                        lambda cfg, devices=None: real(data=1, fsdp=1, model=1, devices=jax.devices()[:1]))
    train = dict(async_rollouts=dict(enabled=True, max_staleness=1), serving=dict(SERVING),
                 islands=dict(enabled=True, chunk_layers=2))
    ((je, js), (pe, ps)), pt = async_lora_ppo_runs(tmp_path, train)
    assert pt._island is None  # closed by on_learn_end
    _elements_close(je, pe)
    _stats_close(js, ps, ("losses", "values", "returns", "policy", "ratio", "learning_rate_group_0"))
    for registry in (jax_gauges, gauges):
        assert registry.snapshot("serving/island/") == {} and registry.snapshot("rollout/broadcast/") == {}


def test_trainer_islands_wiring(tmp_path, monkeypatch):
    """islands + serving: the chunked publisher shares the island's gate,
    the engine is attached, the seed version committed with the policy's
    full state chunked by its top-level modules; ``_serving_generate``
    installs nothing behind the engine (it swaps v0 at a round boundary and
    serves the policy's trunk), and ``on_learn_end`` clears every island and
    broadcast gauge."""
    trainer = _islands_trainer(tmp_path, monkeypatch, islands=dict(enabled=True, chunk_layers=2), serving=SERVING)
    island = trainer._island
    pub = trainer._engine.publisher
    assert island is not None and type(pub) is ChunkedParameterPublisher
    assert pub._gate is island.round_gate and pub.chunk_layers == 2
    assert trainer._serving_engine._island is island
    assert pub.version == 0 and pub.manifest().num_chunks >= 1
    top = list(dict.fromkeys(k.split(".", 1)[0] for k in trainer.model.state_dict()))
    assert pub.manifest().chunk_names == tuple(
        n for n, _ in layer_chunks({k: None for k in top}, 2))
    ref_before = trainer._serving_param_ref
    seqs, mask, P = trainer._serving_generate([np.asarray([3, 4], np.int32)])
    assert trainer._serving_param_ref is ref_before
    assert seqs.shape[0] == 1 and mask.shape[0] == 1 and P >= 2
    assert trainer._serving_engine.serving_version == 0 and trainer._serving_client.policy_version == 0
    assert _same_state(trainer._serving_engine.trunk.state_dict(), trainer.model.transformer.state_dict())
    trainer.on_learn_end()
    assert trainer._island is None
    assert gauges.snapshot("serving/island/") == {} and gauges.snapshot("rollout/broadcast/") == {}
