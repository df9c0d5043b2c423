"""The census (``python -m trlx_tpu_torch.analysis.census``): every
registered hot entrypoint, measured on the CPU at the tiny seeded
configuration, stays within the committed ``name@cpu`` budget; each seeded
regression (an f32 upcast, an extra ``.item()``, unbucketed scoring
lengths) makes the gate exit non-zero; and the recorder counts what it says
it counts on small steps of its own."""

import ctypes
import json
import os
import threading

import numpy as np
import pytest
import torch

from trlx_tpu_torch.analysis.census import budget as budget_mod
from trlx_tpu_torch.analysis.census import cli, seeds
from trlx_tpu_torch.analysis.census.entrypoints import Entry, load_all
from trlx_tpu_torch.analysis.census.measure import Census, measure

pytestmark = pytest.mark.torch_port

ENTRIES = ("decode_step", "paged_decode_step", "spec_verify_step", "serving_prefill", "serving_pack_step",
           "serving_chunk_step", "stream_score_bucket", "ppo_train_step", "grpo_train_step", "ilql_train_step")


@pytest.fixture(autouse=True)
def _no_seed(monkeypatch):
    monkeypatch.delenv(seeds.ENV_VAR, raising=False)


def test_the_registry_holds_the_reference_entries_and_the_engine_programs():
    registry = load_all()
    # the one-device entries; the two data=2 x fsdp=2 learner steps run on their mesh only
    assert tuple(n for n, ep in registry.items() if ep.mesh is None) == ENTRIES
    assert [n for n, ep in registry.items() if ep.mesh is not None] == ["ppo_train_step_overlap",
                                                                        "ppo_train_step_unsharded_opt"]
    committed = budget_mod.load()
    for name in ENTRIES:
        assert f"{name}@cpu" in committed and f"{name}@cuda" in committed, name
        assert committed[f"{name}@cpu"]["steady_new_shapes"] == 0


def test_the_cpu_census_is_within_the_committed_budget():
    measured = cli.run_census("cpu")
    assert sorted(measured) == sorted(f"{n}@cpu" for n in ENTRIES)
    assert budget_mod.compare(measured, budget_mod.load()) == []
    # the designed host round-trips, each named in its registration
    rt = {k.split("@")[0]: m["round_trips"] for k, m in measured.items()}
    assert rt["decode_step"] == 2 + (6 - 1) + 2  # ids and mask up, one early-exit read a token, two fetches
    assert rt["paged_decode_step"] == rt["serving_prefill"] == 0
    assert rt["ppo_train_step"] == rt["grpo_train_step"] == 8 + 1  # the batch's fields up, the stats down


@pytest.mark.parametrize("seed, entry, field", [
    ("f32_upcast", "decode_step", "heavy_f32"),
    ("extra_item", "decode_step", "round_trips"),
    ("shape_churn", "stream_score_bucket", "steady state dispatched"),
])
def test_each_seeded_regression_fails_the_gate(seed, entry, field, monkeypatch, capsys):
    monkeypatch.setenv(seeds.ENV_VAR, seed)
    assert cli.main(["--device", "cpu", "--entries", entry]) == 1
    out = capsys.readouterr().out
    assert f"VIOLATION {entry}@cpu" in out and field in out


def test_write_budget_refuses_under_a_seed(tmp_path, monkeypatch):
    monkeypatch.setenv(seeds.ENV_VAR, "extra_item")
    with pytest.raises(RuntimeError, match="refusing"):
        budget_mod.write(tmp_path / "b.json", {"x@cpu": {"ops": 1}})
    monkeypatch.setenv(seeds.ENV_VAR, "no_such_seed")
    with pytest.raises(ValueError, match="unknown"):
        seeds.active()


def test_budget_compare_exact_counts_pinned_shapes_and_memory_band(tmp_path):
    base = {"e@cuda": {"ops": 10, "round_trips": 2, "warmup_shapes": 5, "launches": 7, "syncs": 2,
                       "peak_bytes": 1000, "steady_new_shapes": 0}}
    path = tmp_path / "b.json"
    budget_mod.write(path, base)
    committed = budget_mod.load(path)
    ok = dict(base["e@cuda"], peak_bytes=1090)
    assert budget_mod.compare({"e@cuda": ok}, committed) == []
    for change, needle in ((dict(ops=11), "ops 10 -> 11"), (dict(peak_bytes=1200), "peak_bytes"),
                           (dict(peak_bytes=850), "peak_bytes"), (dict(steady_new_shapes=1), "steady state"),
                           (dict(syncs=3), "synchronizing"), (dict(launches=[7, 8]), "differs")):
        violations = budget_mod.compare({"e@cuda": dict(ok, **change)}, committed)
        assert any(needle in v for v in violations), (change, violations)
    assert "no committed budget entry" in budget_mod.compare({"f@cuda": ok}, committed)[0]
    assert json.loads(path.read_text())["_tolerances"]["memory_pct"] == 10.0


def test_the_recorder_counts_round_trips_heavy_f32_and_shapes():
    """Host data (from numpy, or with no device) is not a device read; a
    read of device data, a blocking copy of host data to the device and a
    boolean mask are; an f32 matmul in a bf16 step is counted; a new length
    in steady state is a new shape."""
    dev = torch.device("cpu")
    host = torch.from_numpy(np.arange(4, dtype=np.float32))
    w = torch.ones(4, 4, dtype=torch.bfloat16)

    def step(k):
        x = torch.ones(4 + (k == 2), dtype=torch.bfloat16, device=dev)  # device data (a factory)
        float(host.sum())  # host data: no round-trip
        y = host.to(dev)  # a blocking copy to the device: 1
        x[:4].float().sum().item()  # a device read: 1
        torch.tensor([1.0, 2.0], device=dev)  # host data to the device: 1
        y[y > 1]  # a boolean mask: 1
        torch.mm(y[None, :], y[:, None])  # f32 matmul: heavy
        (x[:4] @ w).cpu()  # bf16 matmul, then a fetch: 1

    census = Census(dev)
    with census:
        step(0)
    assert census.step.round_trips == 5 and census.step.heavy_f32 == 1
    m = measure(Entry(step=step, warmup=(0,), steady=(1,)), dev)
    assert m["round_trips"] == 5 and m["steady_new_shapes"] == 0
    m = measure(Entry(step=step, warmup=(0,), steady=(1, 2)), dev)
    assert m["steady_new_shapes"] > 0


def test_the_static_registrations_match_the_runtime_registry():
    """TX002 reads each registration's roots and readback from the AST: the
    literals it reads are the ones registered at import, and every root
    resolves to a def in the port."""
    from trlx_tpu_torch.analysis.callgraph import Project
    from trlx_tpu_torch.analysis.core import iter_py_files, load_context

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "trlx_tpu_torch")
    contexts = [load_context(f, os.path.relpath(f, root)) for f in iter_py_files([pkg])]
    static = {e.name: e for e in Project(contexts).hot_entries()}
    registry = load_all()
    assert sorted(static) == sorted(registry)
    for name, ep in registry.items():
        assert static[name].roots == ep.roots and static[name].readback == ep.readback, name
        assert not static[name].unresolved, (name, static[name].unresolved)


class _CallbackData(ctypes.Structure):
    """The leading fields of CUPTI's CUpti_CallbackData."""

    _fields_ = [("callback_site", ctypes.c_int), ("function_name", ctypes.c_char_p)]


class _FakeCupti:
    """CUPTI's subscription calls, answering ``result`` to cuptiSubscribe and
    keeping the callback it was given."""

    def __init__(self, result=0):
        self.result, self.callback, self.domains = result, None, []

        def subscribe(handle, callback, userdata):
            self.callback = callback
            return self.result

        def enable_domain(enable, handle, domain):
            self.domains.append(domain)
            return 0

        def result_string(result, out):
            ctypes.cast(out, ctypes.POINTER(ctypes.c_char_p))[0] = b"CUPTI_ERROR_MULTIPLE_SUBSCRIBERS_NOT_SUPPORTED"
            return 0

        self.cuptiSubscribe, self.cuptiEnableDomain, self.cuptiGetResultString = subscribe, enable_domain, result_string


_NAMES = {}  # CUPTI's function names are static strings: these live as long


def _call(lib, domain, cbid, name, site=0):
    data = _CallbackData(site, _NAMES.setdefault(name, name.encode()))
    lib.census_callback(None, domain, cbid, ctypes.addressof(data))


def test_the_api_counter_counts_each_launch_once_at_entry_from_every_thread(monkeypatch):
    """CUPTI's callback, driven by hand as a step calls it: a runtime launch
    and the driver launch inside it are one launch, a library's own driver
    launch is one more; entries count, exits do not; suffixed names are
    classified under their base names; a call from another thread counts;
    a call outside the block does not; the domains enabled are the
    driver's and the runtime's."""
    from trlx_tpu_torch.analysis.census import api_counter

    fake = _FakeCupti()
    monkeypatch.setattr(api_counter, "_state", {})
    monkeypatch.setattr(api_counter, "_load_cupti", lambda: fake)
    lib = api_counter._subscribed()
    assert fake.domains == [1, 2]
    assert fake.callback.value == ctypes.cast(lib.census_callback, ctypes.c_void_p).value
    _call(lib, 1, 307, "cuLaunchKernel")  # before the block
    with api_counter.counting() as calls:
        for _ in range(3):  # a runtime launch, the driver's inside it, and their exits
            _call(lib, 2, 211, "cudaLaunchKernel")
            _call(lib, 1, 307, "cuLaunchKernel")
            _call(lib, 1, 307, "cuLaunchKernel", site=1)
            _call(lib, 2, 211, "cudaLaunchKernel", site=1)
        _call(lib, 2, 320, "cudaLaunchKernel_ptsz")
        _call(lib, 1, 442, "cuLaunchKernel_ptsz")
        t = threading.Thread(target=lambda: _call(lib, 1, 652, "cuLaunchKernelEx_ptsz"))  # cuBLAS's own
        t.start()
        t.join()
        _call(lib, 2, 131, "cudaStreamSynchronize")
        _call(lib, 1, 128, "cuStreamSynchronize")
        _call(lib, 2, 41, "cudaMemcpyAsync")
        _call(lib, 1, 279, "cuMemcpyDtoHAsync_v2")
        _call(lib, 2, 200, "cudaGetDevice")
        _call(lib, 2, 311, "cudaGraphLaunch")
        _call(lib, 1, 514, "cuGraphLaunch")
        _call(lib, 3, 1, "a resource callback")  # not an API domain
    assert calls["launches"] == 5 and calls["runtime_launches"] == 4
    assert calls["launch_apis"] == {"cuLaunchKernel": 4, "cuLaunchKernelEx": 1}
    assert calls["syncs"] == 1 and calls["memcpys"] == 1 and calls["graph_launches"] == 1
    with api_counter.counting() as calls:
        pass
    assert calls["launches"] == calls["syncs"] == 0


def test_the_api_counter_raises_when_cupti_has_another_subscriber(monkeypatch):
    from trlx_tpu_torch.analysis.census import api_counter

    monkeypatch.setattr(api_counter, "_state", {})
    monkeypatch.setattr(api_counter, "_load_cupti", lambda: _FakeCupti(result=39))
    with pytest.raises(RuntimeError, match="cuptiSubscribe failed: CUPTI error 39 .*MULTIPLE_SUBSCRIBERS"):
        with api_counter.counting():
            pass
    assert api_counter._state == {}


def test_budget_compare_flags_graph_launches_and_unequal_syncs_between_steps():
    got = {"ops": 1, "round_trips": 1, "syncs": [1, 2], "launches": 3, "graph_launches": 1}
    violations = budget_mod.compare({"e@cuda": got}, {"e@cuda": {"ops": 1}})
    assert any("syncs differs" in v for v in violations)
    assert any("CUDA-graph" in v for v in violations)
