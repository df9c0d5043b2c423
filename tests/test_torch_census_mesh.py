"""The census on a mesh (``python -m trlx_tpu_torch.analysis.census --mesh
--device cpu``), held against the JAX package's IR audit of the same
entries.

One rank group per mesh shape runs every mesh entry at the tiny size, then
the two mesh seeds, in the same ranks (``cli.run_mesh_census``):
``ppo_train_step_overlap`` and ``ppo_train_step_unsharded_opt`` on
``data=2 x fsdp=2`` (4 ranks), and ``decode_step``, ``ppo_train_step``,
``grpo_train_step``, ``ilql_train_step`` on the reference's audit mesh
``data=2 x fsdp=2 x model=2`` (8 ranks, keys ``name@cpu:mesh``). The ranks
must count alike (``ranks.merge`` raises otherwise), the census must be
within the committed budget, and each seed must fail the gate on the key it
moves.

The overlap entry's collectives are held to the reference's committed
audit (``graftcheck-ir-budget.json``, ``ppo_train_step_overlap@small``,
which ``tests/test_learner_overlap.py`` holds the JAX package to): every
key of the port's is one of the reference's, with ``reduce-scatter:fsdp``
and ``all-gather:fsdp`` and without ``all-reduce:fsdp``. The counts are
not compared: the reference counts the ops of the compiled program, whose
microbatch scan body holds each collective once, where the port counts the
calls one step makes, once per microbatch; and its audit model (hidden 64,
4 heads, vocab 256, max_grad_norm 1.0) is not the census's tiny trainer.
The port's own count and bytes of ``reduce-scatter:fsdp`` are derived here
from ``make_overlap_specs`` and the step's code instead.
"""

import json
import os
from pathlib import Path

import pytest
import torch

from trlx_tpu_torch.analysis.census import budget as budget_mod
from trlx_tpu_torch.analysis.census import cli, ranks, seeds
from trlx_tpu_torch.analysis.census.entrypoints import DEFAULT_AUDIT_MESH, ON_AUDIT_MESH, REFERENCE_AUDITED, load_all

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
DATA2_FSDP2 = {"data": 2, "fsdp": 2, "pipe": 1, "model": 1}
KEYS = ["ppo_train_step_overlap@cpu", "ppo_train_step_unsharded_opt@cpu"] + [f"{n}@cpu:mesh" for n in ON_AUDIT_MESH]
SEEDED = [("ppo_train_step_overlap", "allreduce_under_fsdp"), ("ppo_train_step", "allgather")]


@pytest.fixture(scope="module")
def census():
    """``(measurements, {seed: measurements})`` of one run of every rank group."""
    held = os.environ.pop(seeds.ENV_VAR, None)
    try:
        return cli.run_mesh_census("cpu", seeded=SEEDED)
    finally:
        if held is not None:
            os.environ[seeds.ENV_VAR] = held


@pytest.fixture(autouse=True)
def _no_seed(monkeypatch):
    monkeypatch.delenv(seeds.ENV_VAR, raising=False)


def test_the_registry_records_the_references_meshes():
    from trlx_tpu.analysis.ir import entrypoints as ref

    assert DEFAULT_AUDIT_MESH == ref.DEFAULT_AUDIT_MESH
    audited = ref.load_all()
    assert sorted(REFERENCE_AUDITED) == sorted(n for n, ep in audited.items()
                                              if ep.mesh_shape == ref.DEFAULT_AUDIT_MESH)
    assert set(ON_AUDIT_MESH) <= set(REFERENCE_AUDITED)
    registry = load_all()
    for name in ("ppo_train_step_overlap", "ppo_train_step_unsharded_opt"):
        assert registry[name].mesh == audited[name].mesh_shape == DATA2_FSDP2


def test_the_mesh_census_is_within_the_committed_budget(census):
    measured, _ = census
    assert sorted(measured) == sorted(KEYS)
    assert budget_mod.compare(measured, budget_mod.load()) == []
    for key, m in measured.items():
        assert m["mesh"] == (DATA2_FSDP2 if "@cpu:" not in key else DEFAULT_AUDIT_MESH)
        assert m["collectives"] and m["staged"] == {"calls": 0, "bytes": 0}  # gloo on host tensors stages nothing
    assert "state_bytes" not in measured["decode_step@cpu:mesh"]


@pytest.mark.parametrize("entry, seed, needles", [
    ("ppo_train_step_overlap", "allreduce_under_fsdp",
     ("NEW collective all-reduce:fsdp", "collective reduce-scatter:fsdp x28 no longer issued")),
    ("ppo_train_step", "allgather", ("NEW collective all-gather:data+fsdp",)),
])
def test_each_mesh_seed_fails_the_gate_on_the_key_it_moves(census, entry, seed, needles, monkeypatch, capsys,
                                                           tmp_path):
    measured = census[1][seed]
    key = next(iter(measured))
    assert key.split("@")[0] == entry
    violations = budget_mod.compare(measured, budget_mod.load())
    for needle in needles:
        assert any(needle in v for v in violations), (needle, violations)
    # the CLI's exit code on that measurement, made in the seeded ranks above
    monkeypatch.setenv(seeds.ENV_VAR, seed)
    monkeypatch.setattr(cli, "run_mesh_census", lambda *args, **kwargs: (measured, {}))
    assert cli.main(["--mesh", "--device", "cpu", "--entries", entry]) == 1
    assert f"VIOLATION {key}" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="refusing"):
        budget_mod.write(tmp_path / "budget.json", measured)


def test_the_overlap_keys_are_the_references(census):
    reference = json.loads((ROOT / "graftcheck-ir-budget.json").read_text())["ppo_train_step_overlap@small"]
    assert reference["mesh"] == DATA2_FSDP2
    committed = budget_mod.load()["ppo_train_step_overlap@cpu"]["collectives"]
    for got in (census[0]["ppo_train_step_overlap@cpu"]["collectives"], committed):
        assert set(got) <= set(reference["collectives"]), sorted(set(got) - set(reference["collectives"]))
        assert "reduce-scatter:fsdp" in got and "all-gather:fsdp" in got
        assert "all-reduce:fsdp" not in got
    # the comparator all-reduces the whole gradient over the batch ranks instead
    comparator = census[0]["ppo_train_step_unsharded_opt@cpu"]["collectives"]
    assert "reduce-scatter:fsdp" not in comparator and "all-reduce:data+fsdp" in comparator


@pytest.fixture(scope="module")
def overlap_leaves():
    """``(trained leaf names, their shapes and bytes, the fsdp-split ones,
    microbatches a step)`` of the census's tiny PPO trainer, by the rules
    the overlapped step shards with."""
    from trlx_tpu_torch.analysis.census import fixtures
    from trlx_tpu_torch.parallel.fsdp import make_overlap_specs
    from trlx_tpu_torch.parallel.mesh import make_mesh

    tr = fixtures.trainer("ppo", torch.device("cpu"), "tiny", {})
    named = dict(tr.model.named_parameters())
    names = [n for n in named if tr.trainable_path_predicate(n)]
    specs = make_overlap_specs({n: tuple(named[n].shape) for n in names},
                               make_mesh(**DATA2_FSDP2, world_size=4, rank=0, build_groups=False))
    nbytes = {n: named[n].numel() * named[n].element_size() for n in names}
    split = [n for n in names if specs.shard_dims[n] >= 0]
    return names, nbytes, split, tr.num_mb


def test_the_overlap_gradient_reduce_scatter_is_its_derivation(census, overlap_leaves):
    """``make_overlapped_grad_accum_step`` reduce-scatters each fsdp-split
    trained leaf's gradient once a microbatch (its post-accumulate hook),
    into this rank's shard, and gathers each such leaf whole once a
    microbatch (the prefetcher)."""
    names, nbytes, split, num_mb = overlap_leaves
    colls = census[0]["ppo_train_step_overlap@cpu"]["collectives"]
    fsdp = DATA2_FSDP2["fsdp"]
    assert split and num_mb == 2
    assert colls["reduce-scatter:fsdp"] == {"count": num_mb * len(split),
                                            "bytes": num_mb * sum(nbytes[n] // fsdp for n in split)}
    assert colls["all-gather:fsdp"] == {"count": num_mb * len(split), "bytes": num_mb * sum(nbytes[n] for n in split)}


def test_the_overlap_state_bytes_is_its_formula_and_below_the_comparators(census, overlap_leaves):
    """AdamW's two moments at each trained leaf's master (this rank's fsdp
    shard, or the whole leaf) and its f32 step count, against the same
    state over whole leaves on every rank (the reference's IR006 relation,
    ``tests/test_learner_overlap.py:346``)."""
    names, nbytes, split, _ = overlap_leaves
    overlap = census[0]["ppo_train_step_overlap@cpu"]["state_bytes"]
    comparator = census[0]["ppo_train_step_unsharded_opt@cpu"]["state_bytes"]
    fsdp = DATA2_FSDP2["fsdp"]
    assert overlap == sum(2 * (nbytes[n] // fsdp if n in split else nbytes[n]) + 4 for n in names)
    assert comparator == sum(2 * nbytes[n] + 4 for n in names)
    assert overlap < comparator
    committed = budget_mod.load()
    assert committed["ppo_train_step_overlap@cpu"]["state_bytes"] < \
        committed["ppo_train_step_unsharded_opt@cpu"]["state_bytes"]


def test_ranks_that_count_apart_raise():
    same = {"ops": 3, "collectives": {"all-reduce:data": {"count": 1, "bytes": 4}}, "seconds": 1.0}
    apart = dict(same, collectives={"all-reduce:data": {"count": 2, "bytes": 8}}, seconds=2.0)
    merged = ranks.merge([{"e@cpu": same}, {"e@cpu": dict(same, seconds=3.0)}], DATA2_FSDP2)
    assert merged["e@cpu"]["mesh"] == DATA2_FSDP2 and merged["e@cpu"]["seconds"] == 3.0
    with pytest.raises(ranks.RanksDiffer, match="collectives"):
        ranks.merge([{"e@cpu": same}, {"e@cpu": apart}], DATA2_FSDP2)
    peaks = ranks.merge([{"e@cuda": dict(same, peak_bytes=10)}, {"e@cuda": dict(same, peak_bytes=12)}], DATA2_FSDP2)
    assert peaks["e@cuda"]["peak_bytes"] == [10, 12]


def test_budget_compares_collectives_state_and_peaks_per_rank(tmp_path):
    entry = {"mesh": DATA2_FSDP2, "ops": 5, "collectives": {"all-gather:fsdp": {"count": 4, "bytes": 1000},
                                                            "reduce-scatter:fsdp": {"count": 4, "bytes": 500}},
             "staged": {"calls": 8, "bytes": 3000}, "state_bytes": 640, "peak_bytes": [1000, 1000, 1000, 1000],
             "steady_new_shapes": 0}
    path = tmp_path / "b.json"
    budget_mod.write(path, {"e@cuda": entry})
    committed = budget_mod.load(path)
    assert committed["e@cuda"]["mesh"] == DATA2_FSDP2
    ok = json.loads(json.dumps(entry))
    ok["collectives"]["all-gather:fsdp"]["bytes"] = 1090
    ok["peak_bytes"][3] = 1080
    assert budget_mod.compare({"e@cuda": ok}, committed) == []

    def changed(**over):
        got = json.loads(json.dumps(entry))
        got.update(over)
        return budget_mod.compare({"e@cuda": got}, committed)

    ag = {"count": 4, "bytes": 1000}
    rs = {"count": 4, "bytes": 500}
    cases = [
        (dict(collectives={"all-gather:fsdp": ag, "reduce-scatter:fsdp": rs,
                           "all-reduce:fsdp": {"count": 1, "bytes": 8}}), "NEW collective all-reduce:fsdp"),
        (dict(collectives={"all-gather:fsdp": ag}), "reduce-scatter:fsdp x4 no longer issued"),
        (dict(collectives={"all-gather:fsdp": dict(ag, count=5), "reduce-scatter:fsdp": rs}), "count 4 -> 5"),
        (dict(collectives={"all-gather:fsdp": dict(ag, bytes=1200), "reduce-scatter:fsdp": rs}), "bytes 1000 -> 1200"),
        (dict(staged={"calls": 9, "bytes": 3000}), "staged"),
        (dict(state_bytes=641), "state_bytes 640 -> 641"),
        (dict(peak_bytes=[1000, 1000, 1200, 1000]), "peak_bytes on rank 2"),
        (dict(peak_bytes=[1000, 1000]), "another rank count"),
        (dict(mesh=DEFAULT_AUDIT_MESH), "mesh"),
        (dict(collectives=[{}, {}]), "collectives differs between steady steps"),
    ]
    for over, needle in cases:
        violations = changed(**over)
        assert any(needle in v for v in violations), (over, violations)


def test_staged_copies_reported_from_another_thread_count_as_round_trips():
    """The census's modes see the thread that entered it; a staged
    collective on another thread (a CUDA backward's hooks run on the
    autograd engine's device thread) reports its copies, which count."""
    import threading

    from trlx_tpu_torch.analysis.census.measure import Census
    from trlx_tpu_torch.parallel import collectives as coll

    census = Census("cpu")
    with census:
        coll._transfers(2)  # this thread's copies: the modes count them where they happen
        worker = threading.Thread(target=coll._transfers, args=(3,))
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive() and census.step.round_trips == 3
    with census:
        pass
    assert census.step.round_trips == 0 and not coll._TRANSFER_LISTENERS


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def test_a_rank_dies_with_its_launcher():
    """A rank asks to be killed with its launcher, so a launcher killed
    outright (no ``finally`` runs) leaves no rank holding the card."""
    import signal
    import subprocess
    import sys
    import time

    rank = ("from trlx_tpu_torch.analysis.census import ranks; ranks._die_with_launcher(); "
            "import time; time.sleep(120)")
    launcher = (f"import os, subprocess, sys, time; env = dict(os.environ, TRLX_CENSUS_LAUNCHER=str(os.getpid())); "
                f"p = subprocess.Popen([sys.executable, '-c', {rank!r}], env=env); print(p.pid, flush=True); "
                f"time.sleep(120)")
    proc = subprocess.Popen([sys.executable, "-c", launcher], stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))
    child = int(proc.stdout.readline())
    try:
        time.sleep(1.0)  # the rank has made its request
        assert not _gone(child)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        deadline = time.monotonic() + 30
        while not _gone(child) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(child)
    finally:
        if not _gone(child):
            os.kill(child, signal.SIGKILL)
        if proc.poll() is None:
            proc.kill()
        proc.wait()
