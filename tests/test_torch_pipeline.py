"""The pipe axis: the port's GPipe ``pipeline_apply`` on N gloo ranks against
the JAX ``pipeline_apply`` on a mesh of the same shape (the first N of the
conftest's virtual CPU devices) and against the one-stage stacked port
(the ports of ``tests/test_pipeline_parallel.py``).

Checked, at a tiny width (4 layers, hidden 32, f32): the forward's logits
on ``pipe=2``, ``data=2 x pipe=2`` and ``pipe=2 x model=2`` within 1e-5;
the gradients of every leaf on ``pipe=2`` and ``data=2 x pipe=2`` within
1e-5 (the replicated loss hands the trunk one cotangent, and gpt2's tied
embedding counts its head once); the microbatch warning's text; cached
greedy decode stage by stage on ``pipe=2 x model=2``, its tokens identical
to the listed one-stage model's; and the refusals (partial freezing, a
stage count the layers or the mesh do not match, ring under stages).
"""

import logging

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks

pytestmark = pytest.mark.torch_port

DIMS = dict(vocab_size=32, hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
            max_position_embeddings=64)
B, T = 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"pipe2": dict(pipe=2), "data2_pipe2": dict(data=2, pipe=2), "pipe2_model2": dict(pipe=2, model=2)}


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, DIMS["vocab_size"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[:, :3] = 0  # left padding
    mask[1, :7] = 0
    return ids, mask


def port_config(stages=1, microbatches=2, **over):
    from trlx_tpu_torch.models.presets import PRESETS

    over.setdefault("scan_layers", stages == 1)
    return PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, pipeline_stages=stages,
                                   pipeline_microbatches=microbatches, **over)


def _loss(logits, mask, count):
    return torch.sum((logits * torch.as_tensor(mask)[..., None]) ** 2) / count


def pp_job(mesh, state, grads=False, decode=False, microbatches=2):
    """A rank's pipelined forward (and backward, decode) of the stacked
    model from the whole parameters ``state``: this rank's rows, logits and
    local gradients, with its coordinates."""
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.ops.generation import generate
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import make_mesh, put_batch
    from trlx_tpu_torch.parallel.sharding import apply_mesh

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logging.getLogger("trlx_tpu_torch").addHandler(handler)
    try:
        m = make_mesh(**mesh)
        model = TransformerLM(port_config(m.shape["pipe"], microbatches))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        apply_mesh(model, m)
        ids, mask = _inputs()
        ids_l, mask_l = put_batch(m, ids), put_batch(m, mask)
        out = {"coords": dict(m.coords)}
        logits = model(torch.from_numpy(ids_l), torch.from_numpy(mask_l))[0]
        out["logits"] = logits.detach().numpy()
        if grads:
            _loss(logits, mask_l, B * T * DIMS["vocab_size"]).backward()
            out["grads"] = {n: coll.all_reduce(p.grad, m.batch_group).numpy() for n, p in model.named_parameters()}
        if decode:
            with torch.no_grad():
                res = generate(lambda i, mk, pos, c: _step(model, i, mk, pos, c), model.init_cache,
                               torch.from_numpy(ids_l), torch.from_numpy(mask_l), None, 6, do_sample=False,
                               sync_group=m.world_group)
            out["tokens"] = res["sequences"].numpy()
        out["staged"] = coll.staged()
    finally:
        logging.getLogger("trlx_tpu_torch").removeHandler(handler)
    out["log"] = records
    return out


def _step(model, ids, mask, positions, cache):
    logits, hidden, _, cache = model(ids, mask, positions, cache, last_only=True)
    return logits, hidden, cache


def _assemble(ranks, key, mesh):
    """The global batch of a per-rank output: the rows of each (data, fsdp)
    shard, from the rank at pipe 0, model 0."""
    parts = {}
    for r in ranks:
        c = r["coords"]
        if c["pipe"] == 0 and c["model"] == 0:
            parts[c["data"] * mesh.get("fsdp", 1) + c["fsdp"]] = r[key]
    return np.concatenate([parts[i] for i in sorted(parts)])


def _jax_setup():
    import jax
    import jax.numpy as jnp

    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.parallel.pipeline import stack_layer_params

    cfg = JAX_PRESETS["gpt2"].replace(**DIMS, compute_dtype=jnp.float32)
    ids, mask = _inputs()
    params = JaxLM(cfg).init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]), jnp.asarray(mask[:1]))["params"]
    return cfg, jax.device_get(params), stack_layer_params(jax.device_get(params), cfg.num_layers)


def _jax_on_mesh(cfg, p_stack, mesh, grads=False):
    import jax
    import jax.numpy as jnp

    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from trlx_tpu.parallel.mesh import put_batch as jax_put_batch
    from trlx_tpu.parallel.sharding import make_param_shardings

    sizes = {**dict(data=1, fsdp=1, model=1, pipe=1), **mesh}
    n = int(np.prod(list(sizes.values())))
    jm = jax_make_mesh(devices=jax.devices()[:n], **sizes)
    m_pp = JaxLM(cfg.replace(pipeline_stages=sizes["pipe"], pipeline_microbatches=2))
    shard = make_param_shardings({"transformer": p_stack}, jm)["transformer"]
    p_dev = jax.tree.map(jax.device_put, p_stack, shard)
    ids, mask = _inputs()
    batch = jax_put_batch(jm, {"ids": ids, "mask": mask})
    with jm:
        logits = jax.jit(lambda p, i, mk: m_pp.apply({"params": p}, i, mk)[0])(p_dev, batch["ids"], batch["mask"])
        g = None
        if grads:
            def loss(p):
                lg = m_pp.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))[0]
                return jnp.mean((lg * jnp.asarray(mask)[..., None]) ** 2)

            g = jax.device_get(jax.jit(jax.grad(loss))(p_dev))
    return np.asarray(logits), g


def _port_state(cfg, p_stack):
    from trlx_tpu_torch.models.convert import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(p_stack, port_config()).items()}


def _one_stage(state, grads=False):
    """The one-stage stacked port: logits and gradients."""
    from trlx_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(port_config())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    ids, mask = _inputs()
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    out = {"logits": logits.detach().numpy()}
    if grads:
        _loss(logits, mask, B * T * DIMS["vocab_size"]).backward()
        out["grads"] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return out


def _full_grads(ranks, mesh):
    """Whole gradients from the ranks: stacked leaves concatenated over the
    stages (rank order), the others equal on every stage."""
    stages = mesh["pipe"]
    by_stage = {}
    for r in ranks:
        by_stage.setdefault(r["coords"]["pipe"], r["grads"])
    out = {}
    for name in by_stage[0]:
        if name.startswith("layers_scan."):
            out[name] = np.concatenate([by_stage[s][name] for s in range(stages)])
        else:
            for s in range(stages):
                np.testing.assert_array_equal(by_stage[s][name], by_stage[0][name], err_msg=name)
            out[name] = by_stage[0][name]
    return out


@pytest.fixture(scope="module")
def setup():
    cfg, p_list, p_stack = _jax_setup()
    state = _port_state(cfg, p_stack)
    return cfg, p_stack, state


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pipeline_apply_matches_jax_and_one_stage(setup, tmp_path, mesh_name):
    """Forward on the mesh (and on pipe=2 and data=2 x pipe=2, the
    gradients; on pipe=2 x model=2, cached greedy decode) against the JAX
    pipelined model on the same mesh and the one-stage stacked port."""
    from trlx_tpu_torch.models.convert import _flatten

    cfg, p_stack, state = setup
    mesh = MESHES[mesh_name]
    n = int(np.prod(list(mesh.values())))
    grads = "model" not in mesh
    decode = "model" in mesh
    handle = run_ranks(n, [("tests.test_torch_pipeline:pp_job", dict(mesh=mesh, state=state, grads=grads,
                                                                      decode=decode))],
                       tmp_path / "ranks", wait=False)
    try:
        jlogits, jgrads = _jax_on_mesh(cfg, p_stack, mesh, grads)
        one = _one_stage(state, grads)
    finally:
        ranks = [r[0] for r in handle.results()]
    got = _assemble(ranks, "logits", mesh)
    np.testing.assert_allclose(got, jlogits, **TOL)
    np.testing.assert_allclose(got, one["logits"], **TOL)
    for r in ranks:  # every stage of a data shard holds the final activation's logits
        rows = _assemble([x for x in ranks if x["coords"]["data"] == r["coords"]["data"]], "logits", {})
        np.testing.assert_array_equal(r["logits"], rows)
    if grads:
        full = _full_grads(ranks, mesh)
        want = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
        assert set(full) == set(want) == set(one["grads"])
        for name in full:
            np.testing.assert_allclose(full[name], want[name], err_msg=name, **TOL)
            np.testing.assert_allclose(full[name], one["grads"][name], err_msg=name, **TOL)
        # the point-to-point traffic ran on the CPU's host tensors: nothing staged
        assert all(r["staged"]["calls"] == 0 for r in ranks)
    if decode:
        from trlx_tpu_torch.ops.generation import generate
        from trlx_tpu_torch.models.transformer import TransformerLM
        from trlx_tpu_torch.parallel.pipeline import unstack_layer_params

        listed = TransformerLM(port_config(scan_layers=False))
        listed.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                                unstack_layer_params({k: torch.from_numpy(v) for k, v in state.items()},
                                                     DIMS["num_layers"]).items()})
        ids, mask = _inputs()
        with torch.no_grad():
            res = generate(lambda i, mk, pos, c: _step(listed, i, mk, pos, c), listed.init_cache,
                           torch.from_numpy(ids), torch.from_numpy(mask), None, 6, do_sample=False)
        for r in ranks:
            np.testing.assert_array_equal(r["tokens"], res["sequences"].numpy())


def test_microbatch_warning_matches_jax(setup, tmp_path):
    """A batch that does not divide into ``pipeline_microbatches`` runs
    fewer microbatches and warns with the JAX package's text; the result
    does not change."""
    import jax
    import jax.numpy as jnp

    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from trlx_tpu.parallel.sharding import make_param_shardings

    cfg, p_stack, state = setup
    handle = run_ranks(2, [("tests.test_torch_pipeline:pp_job", dict(mesh=dict(pipe=2), state=state,
                                                                      microbatches=3))],
                       tmp_path / "ranks", wait=False)
    try:
        jm = jax_make_mesh(data=1, fsdp=1, model=1, pipe=2, devices=jax.devices()[:2])
        m_pp = JaxLM(cfg.replace(pipeline_stages=2, pipeline_microbatches=3))
        p_dev = jax.tree.map(jax.device_put, p_stack, make_param_shardings({"transformer": p_stack}, jm)["transformer"])
        ids, mask = _inputs()
        want = []

        class Keep(logging.Handler):
            def emit(self, record):
                if "pipeline_microbatches" in record.getMessage():
                    want.append(record.getMessage())

        handler = Keep()
        logging.getLogger("trlx_tpu").addHandler(handler)
        try:
            with jm:
                jax.jit(lambda p, i, mk: m_pp.apply({"params": p}, i, mk)[0])(p_dev, jnp.asarray(ids),
                                                                               jnp.asarray(mask))
        finally:
            logging.getLogger("trlx_tpu").removeHandler(handler)
        one = _one_stage(state)
    finally:
        ranks = [r[0] for r in handle.results()]
    assert want and "running 2 microbatches" in want[0]
    # the library logs on process 0
    assert [m for m in ranks[0]["log"] if "pipeline_microbatches" in m] == want[:1]
    for r in ranks:
        np.testing.assert_allclose(r["logits"], one["logits"], **TOL)


def test_refusals_match_jax(tmp_path):
    """Partial freezing under ``mesh.pipe > 1`` (the JAX trainer's message),
    a stage count the layers do not divide, ring under stages, and a trunk
    whose ``pipeline_stages`` is not the mesh's pipe size."""
    import jax
    import jax.numpy as jnp

    from tests.test_pipeline_parallel import _trl_config
    from trlx_tpu.methods.sft import SFTConfig
    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.utils.loading import get_trainer as jax_get_trainer
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.transformer import TransformerLM, set_pipeline
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.utils.loading import get_trainer

    config = _trl_config(tmp_path, "SFTTrainer", SFTConfig())
    config.model.num_layers_unfrozen = 1
    with pytest.raises(ValueError) as jerr:
        jax_get_trainer("SFTTrainer")(config=config)
    d = config.to_dict()
    d["method"] = dict(name="SFTConfig")
    with pytest.raises(ValueError) as err:
        get_trainer("SFTTrainer")(config=TRLConfig.from_dict(d), device="cpu")
    assert str(err.value) == str(jerr.value) and "num_layers_unfrozen" in str(err.value)

    jcfg = JAX_PRESETS["gpt2"].replace(**DIMS)
    for over in (dict(pipeline_stages=3), dict(pipeline_stages=2, attention_impl="ring")):
        with pytest.raises(ValueError) as jerr:
            JaxLM(jcfg.replace(**over)).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))
        with pytest.raises(ValueError) as err:
            TransformerLM(port_config().replace(**over))
        assert str(err.value) == str(jerr.value)
    mesh = make_mesh(pipe=2, world_size=2, rank=0, build_groups=False)
    for over, msg in ((dict(scan_layers=True, pipeline_stages=1), "does not match the mesh's pipe axis size 2"),
                      (dict(scan_layers=False, pipeline_stages=4), "does not match the mesh's pipe axis size 2")):
        with pytest.raises(ValueError, match=msg):
            set_pipeline(TransformerLM(port_config().replace(**over)), mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_stacked_shards_match_addressable_shards(setup, mesh_name):
    """``shard_state`` of a stacked tree (a ``layers_scan`` leaf keeps its
    stage's layers, the others whole over ``pipe``) equals each JAX array's
    ``addressable_shards`` block at the same mesh coordinates, and
    ``gather_state`` gives the whole tree back."""
    import jax

    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu.parallel import sharding as jax_sharding
    from trlx_tpu_torch.models.convert import _flatten, gather_state, shard_state
    from trlx_tpu_torch.parallel.mesh import make_mesh

    _, p_stack, state = setup
    sizes = MESHES[mesh_name]
    jm = jax_mesh.make_deviceless_mesh(**sizes)
    placed = jax_sharding.shard_params({"transformer": p_stack}, jm)["transformer"]
    jleaves = _flatten(placed)
    full = {k: torch.from_numpy(v) for k, v in state.items()}
    m = make_mesh(world_size=jm.size, rank=0, build_groups=False, **sizes)
    blocks = [shard_state(full, m, rank) for rank in range(jm.size)]
    back = gather_state(blocks, m, {k: v.shape for k, v in full.items()})
    assert set(back) == set(full) and all(torch.equal(back[k], full[k]) for k in full)
    split = 0
    for rank in range(jm.size):
        coords = make_mesh(world_size=jm.size, rank=rank, build_groups=False, **sizes).coords
        dev = jm.devices[tuple(coords[a] for a in ("data", "fsdp", "pipe", "model"))]
        for name, block in blocks[rank].items():
            shard = next(s for s in jleaves[name].addressable_shards if s.device == dev)
            np.testing.assert_array_equal(block.numpy(), np.asarray(shard.data), err_msg=name)
            split += name.startswith("layers_scan.") and block.shape[0] == DIMS["num_layers"] // sizes["pipe"]
    assert split > 0
