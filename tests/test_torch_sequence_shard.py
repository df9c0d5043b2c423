"""The sequence dimension (Megatron-SP, ``mesh.sequence_shard``): the port's
PPO and SFT trainers on ``model=2`` and ``data=2 x model=2`` gloo ranks
against the JAX package's on a mesh of the same shape, within the
trainer-parity limits of :mod:`tests.test_torch_scale_out`, with the
sequence path shown to have run (``collectives.sequence_counts()``
scatters > 0 on every rank); and the reference's silent fall-through
copied: a model forward whose ``T`` does not divide the ``model`` axis, or
whose batch is kept whole over the batch ranks, shards nothing, exactly
where the JAX ``constrain_seq`` applies no constraint, with logits equal
to the JAX model's either way.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import _drive, compare, jax_trainer

pytestmark = pytest.mark.torch_port

KINDS = ("ppo", "sft")


def sp_fixture(mesh, n):
    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("sequence_shard")
        jts, jobs = {}, []
        for kind in KINDS:
            jts[kind], init = jax_trainer(kind, dict(mesh, sequence_shard=True), n, tmp / f"jax_{kind}")
            jobs.append(("tests.test_torch_scale_out:port_train",
                         dict(kind=kind, mesh=dict(mesh, sequence_shard=True), init=init,
                              ckpt_dir=str(tmp / f"port_{kind}"))))
        handle = run_ranks(n, jobs, tmp / "ranks", wait=False)
        yield jts, handle
        handle.kill()

    return runs


def check(runs, kind):
    from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline

    jts, handle = runs
    assert jts[kind].model_config.sequence_sharding
    jrec = _drive(jts[kind], kind, JaxPipeline)
    ranks = [r[KINDS.index(kind)] for r in handle.results()]
    compare(kind, jrec, jts[kind], ranks)
    for r in ranks:  # the sequence path ran on every rank
        assert r["seq_counts"]["scatters"] > 0


model2 = sp_fixture(dict(model=2), 2)
data2_model2 = sp_fixture(dict(data=2, model=2), 4)


@pytest.mark.parametrize("kind", KINDS)
def test_trainers_match_jax_on_model2(model2, kind):
    check(model2, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_trainers_match_jax_on_data2_model2(data2_model2, kind):
    check(data2_model2, kind)


DIMS = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=64)
#: (name, T, rows, kept whole over the batch ranks)
FALL = [("even", 16, 4, False), ("odd", 15, 4, False), ("whole_batch", 16, 3, True)]


def _inputs(T, rows):
    rng = np.random.default_rng(T + rows)
    ids = rng.integers(1, DIMS["vocab_size"], (rows, T)).astype(np.int32)
    mask = np.ones((rows, T), np.int32)
    mask[0, :5] = 0
    return ids, mask


def fall_job(state):
    """A rank's sequence-sharded forward at each of :data:`FALL`: its rows'
    logits and the scatters it counted."""
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import make_mesh, put_batch
    from trlx_tpu_torch.parallel.sharding import apply_mesh, replicated_batch

    m = make_mesh(data=2, model=2)
    model = TransformerLM(PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, sequence_sharding=True))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    apply_mesh(model, m)
    out = {}
    for name, T, rows, whole in FALL:
        ids, mask = (put_batch(m, x) for x in _inputs(T, rows))
        coll.reset_counts()
        with torch.no_grad(), replicated_batch(whole):
            logits = model(torch.from_numpy(ids), torch.from_numpy(mask))[0]
        out[name] = dict(logits=logits.numpy(), scatters=coll.sequence_counts()["scatters"], rank=m.rank)
    return out


def test_sequence_shard_falls_through_where_jax_does(tmp_path):
    import jax
    import jax.numpy as jnp

    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.parallel import sharding as jax_sharding
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from trlx_tpu_torch.models.convert import params_from_jax
    from trlx_tpu_torch.models.presets import PRESETS

    cfg = JAX_PRESETS["gpt2"].replace(**DIMS, compute_dtype=jnp.float32, sequence_sharding=True)
    ids, mask = _inputs(16, 4)
    params = jax.device_get(JaxLM(cfg).init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"])
    state = {k: v.numpy() for k, v in params_from_jax(params, PRESETS["gpt2"].replace(**DIMS)).items()}
    handle = run_ranks(4, [("tests.test_torch_sequence_shard:fall_job", dict(state=state))], tmp_path / "ranks",
                       wait=False)
    want = {}
    try:
        mesh = jax_make_mesh(data=2, fsdp=1, model=2, devices=jax.devices()[:4])
        real = jax_sharding.constrain_seq
        for name, T, rows, _ in FALL:
            applied = []

            def counting(x, seq_dim=1):
                y = real(x, seq_dim)
                applied.append(y is not x)
                return y

            ids, mask = _inputs(T, rows)
            with pytest.MonkeyPatch.context() as mp, mesh:
                from trlx_tpu.models import transformer as jax_transformer

                mp.setattr(jax_transformer, "constrain_seq", counting)
                logits = jax.jit(lambda p, i, mk: JaxLM(cfg).apply({"params": p}, i, mk)[0])(
                    params, jnp.asarray(ids), jnp.asarray(mask))
            assert applied, name
            want[name] = (any(applied), np.asarray(logits))
    finally:
        ranks = [r[0] for r in handle.results()]
    assert want["even"][0] and not want["odd"][0] and not want["whole_batch"][0]
    for name, T, rows, _ in FALL:
        for r in ranks:
            got = r[name]
            assert (got["scatters"] > 0) == want[name][0], name
            shard = got["rank"] // 2  # the rank's data coordinate
            sl = slice(0, rows) if rows % 2 else slice(shard * rows // 2, (shard + 1) * rows // 2)
            np.testing.assert_allclose(got["logits"], want[name][1][sl], rtol=1e-5, atol=1e-5, err_msg=name)
