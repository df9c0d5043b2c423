"""The port's thread and concurrency rules (TH001-TH002, CC001-CC005) are
the reference's rule for rule: with no baseline, ``trlx_tpu_torch.analysis``
and ``trlx_tpu.analysis`` report the same (path, line, rule, message) over
both packages. The seeded scheduler race fails the port's gate, and the one
race the port's code had beyond the reference's suppressed ones — a weight
swap landing during a supervised restart — is fixed."""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


def _findings(run, path):
    return sorted((f.path, f.lineno, f.rule, f.message) for f in run([path], select=["TH", "CC"]))


@pytest.mark.parametrize("package", ["trlx_tpu", "trlx_tpu_torch"])
def test_th_and_cc_findings_equal_the_reference(package, monkeypatch):
    from trlx_tpu.analysis.core import run as jax_run
    from trlx_tpu_torch.analysis.core import run as port_run

    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("TRLX_CONC_SEED_REGRESSION", raising=False)
    want, got = _findings(jax_run, package), _findings(port_run, package)
    assert got == want
    assert got, "both packages carry suppressed or baselined findings: an empty report means nothing ran"


def test_the_seeded_scheduler_race_fails_the_gate(monkeypatch, capsys):
    from trlx_tpu_torch.analysis.cli import main

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("TRLX_CONC_SEED_REGRESSION", "scheduler_race")
    assert main(["trlx_tpu_torch/serving/scheduler.py", "--select", "CC"]) == 1
    out = capsys.readouterr().out
    assert "CC001 InflightScheduler.finished" in out
    monkeypatch.delenv("TRLX_CONC_SEED_REGRESSION")
    assert main(["trlx_tpu_torch/serving/scheduler.py", "--select", "CC"]) == 0


TINY = dict(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2, max_position_embeddings=64)


def test_a_weight_swap_during_a_restart_reaches_the_successor(tmp_path):
    """``ServingSupervisor.set_params`` from another thread (the learner)
    while a restart rebuilds the engine used to reach only the dead engine:
    the successor came up with the weights of the snapshot the restart took
    (CC004 at the swap). Now the swap re-validates under the lock and the
    successor serves the newest weights."""
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.resilience.chaos import chaos
    from trlx_tpu_torch.serving import ServingEngine, ServingSupervisor

    cfg = PRESETS["gpt2"].replace(**TINY, compute_dtype=torch.float32)
    state0 = TransformerLM(cfg).init_params(0).state_dict()
    state1 = TransformerLM(cfg).init_params(1).state_dict()
    engines = []
    sup = None

    def factory():
        if engines:  # a restart: the learner publishes while the successor is built
            t = threading.Thread(target=sup.set_params, args=(state1,))
            t.start()
            t.join()
        eng = ServingEngine(TransformerLM(cfg), state0, device="cpu", num_slots=2, max_seq_len=32, block_size=4,
                            eos_token_id=None, gen_kwargs=dict(do_sample=False))
        engines.append(eng)
        return eng

    sup = ServingSupervisor(factory, max_restarts=2, backoff_base_s=0.0, wedge_timeout_s=None,
                            diagnostics_dir=str(tmp_path))
    try:
        uids = [sup.submit(np.arange(1, 6).tolist(), 4)]
        chaos.configure("serving-decode:1")
        sup.run(uids)
        chaos.configure(None)
        assert sup.restarts == 1 and sup.engine is engines[-1]
        for key, value in sup.engine.trunk.state_dict().items():
            assert torch.equal(value, state1[key]), key
    finally:
        chaos.configure(None)
        for eng in engines:
            eng.close()
        sup.close()
