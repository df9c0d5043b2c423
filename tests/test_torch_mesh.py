"""The port's mesh against the JAX package's: ``make_mesh`` sizes, ``-1``
inference and errors; the rows ``put_batch`` leaves each rank against the
JAX array's shard indices on the same mesh coordinates; every parameter's
placement against ``make_param_specs`` / ``make_state_shardings`` (gpt2, a
GQA llama, the hydra value branch, the ILQL heads) on ``fsdp=2``,
``model=2`` and ``fsdp=2 x model=2``, with the dims ``_clip_spec`` drops;
``shard_state`` / ``gather_state`` against the JAX arrays'
``addressable_shards``; and the errors a mesh raises (a world-size
mismatch, an unreachable coordinator).

:func:`run_ranks` is the multi-rank harness the scale-out tests share: N
gloo processes on 127.0.0.1, each running a list of jobs
(``module:function`` with keyword arguments) and pickling the results;
every child is killed in a ``finally``.
"""

import importlib
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = f"import sys; sys.path.insert(0, {REPO!r}); from tests.test_torch_mesh import child_main; child_main()"

MESHES = {"fsdp2": dict(fsdp=2), "model2": dict(model=2), "fsdp2_model2": dict(fsdp=2, model=2)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroup:
    """``n`` gloo ranks running ``jobs``; :meth:`results` waits for them and
    :meth:`kill` stops any still running."""

    def __init__(self, n: int, jobs, tmp_path, timeout: float):
        self.n, self.tmp, self.timeout, self.procs = n, tmp_path, timeout, []
        tmp_path.mkdir(parents=True, exist_ok=True)
        spec = tmp_path / "jobs.pkl"
        with open(spec, "wb") as f:
            pickle.dump(jobs, f)
        port = free_port()
        try:
            for rank in range(n):
                env = dict(os.environ, PYTHONPATH=REPO, TRLX_NUM_PROCESSES=str(n),
                           TRLX_COORDINATOR=f"127.0.0.1:{port}", TRLX_PROCESS_ID=str(rank),
                           TRLX_DIST_TIMEOUT_S="240", OMP_NUM_THREADS="1")
                with open(tmp_path / f"rank{rank}.log", "w") as out:
                    self.procs.append(subprocess.Popen([sys.executable, "-c", CHILD, str(spec), str(tmp_path)],
                                                       env=env, stdout=out, stderr=subprocess.STDOUT))
        except BaseException:
            self.kill()
            raise

    def results(self):
        """``results[rank][job]`` once every rank has exited 0."""
        try:
            for rank, p in enumerate(self.procs):
                rc = p.wait(timeout=self.timeout)
                log = (self.tmp / f"rank{rank}.log").read_text()
                assert rc == 0, f"rank {rank} exited {rc}:\n{log[-4000:]}"
        finally:
            self.kill()
        out = []
        for rank in range(self.n):
            with open(self.tmp / f"result{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    def kill(self):
        for p in self.procs:  # never leak a rank into later tests
            if p.poll() is None:
                p.kill()
                p.wait()


def run_ranks(n: int, jobs, tmp_path, timeout: float = 300.0, wait: bool = True):
    """Run ``jobs`` ([(``"module:function"``, kwargs), ...]) in order on
    each of ``n`` gloo ranks: ``results[rank][job]``, or with ``wait=False``
    the running :class:`RankGroup`."""
    group = RankGroup(n, jobs, tmp_path, timeout)
    return group.results() if wait else group


def child_main():
    """A rank's body: every job in turn, the results pickled."""
    from trlx_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    spec, out = sys.argv[1], sys.argv[2]
    mesh_lib.initialize_distributed(device="cpu")
    with open(spec, "rb") as f:
        jobs = pickle.load(f)
    results = []
    for target, kwargs in jobs:
        module, fn = target.split(":")
        results.append(getattr(importlib.import_module(module), fn)(**kwargs))
    with open(os.path.join(out, f"result{mesh_lib.process_index()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    if dist.is_initialized():  # every rank done before any tears its connections down
        dist.barrier()
        dist.destroy_process_group()


# -- make_mesh -------------------------------------------------------------------

MESH_CASES = [
    (8, dict(data=-1)), (8, dict(data=2, fsdp=2, model=2)), (8, dict(data=-1, fsdp=2)),
    (4, dict(data=1, fsdp=-1)), (4, dict(data=2, model=-1)), (2, dict(data=1, model=2)),
    (8, dict(data=3)), (6, dict(data=-1, fsdp=4)), (4, dict(data=-1, fsdp=-1)), (4, dict(data=2, fsdp=1)),
]


@pytest.mark.parametrize("n,sizes", MESH_CASES, ids=[f"{n}-{s}" for n, s in MESH_CASES])
def test_make_mesh_matches_jax(n, sizes):
    import jax

    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu_torch.parallel.mesh import make_mesh

    devices = jax.devices()[:n]
    try:
        want = dict(jax_mesh.make_mesh(devices=devices, **sizes).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(world_size=n, rank=0, build_groups=False, **sizes)
        assert str(got.value) == str(e)
        return
    got = make_mesh(world_size=n, rank=0, build_groups=False, **sizes)
    assert got.shape == want and got.size == n
    # the rank layout is the deviceless mesh's flat order
    shape = [want[a] for a in ("data", "fsdp", "pipe", "model")]
    devs = jax_mesh.make_deviceless_mesh(*shape).devices
    for rank in range(n):
        m = make_mesh(world_size=n, rank=rank, build_groups=False, **sizes)
        assert devs[tuple(m.coords[a] for a in ("data", "fsdp", "pipe", "model"))].id == jax.devices()[rank].id


@pytest.mark.parametrize("sizes", [dict(data=2, fsdp=2, model=2), dict(data=4, fsdp=2), dict(data=1, fsdp=2, model=4)])
@pytest.mark.parametrize("rows", [8, 16, 6])
def test_put_batch_rows_match_jax_shards(sizes, rows):
    import jax

    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu_torch.parallel.mesh import make_mesh, put_batch

    jm = jax_mesh.make_deviceless_mesh(**sizes)
    x = np.arange(rows * 3).reshape(rows, 3)
    arr = jax_mesh.put_batch(jm, x)
    by_device = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    for rank in range(8):
        m = make_mesh(world_size=8, rank=rank, build_groups=False, **sizes)
        dev = jm.devices[tuple(m.coords[a] for a in ("data", "fsdp", "pipe", "model"))]
        np.testing.assert_array_equal(put_batch(m, x), by_device[dev.id])
        np.testing.assert_array_equal(put_batch(m, {"x": x})["x"], by_device[dev.id])


# -- parameter and state placement ----------------------------------------------

DIMS = dict(vocab_size=13, hidden_size=32, num_layers=2, max_position_embeddings=64)


def _model_pair(kind):
    """(JAX params tree, port state_dict) of one model kind at a tiny width."""
    import jax
    import jax.numpy as jnp

    from trlx_tpu.models import policy as jax_policy
    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu_torch.models.convert import policy_params_from_jax
    from trlx_tpu_torch.models.presets import PRESETS

    preset, over = ("llama", dict(num_heads=4, num_kv_heads=2, intermediate_size=48)) if kind == "llama_gqa" else (
        "gpt2", dict(num_heads=2, intermediate_size=64))
    jcfg = JAX_PRESETS[preset].replace(**DIMS, **over, compute_dtype=jnp.float32)
    tcfg = PRESETS[preset].replace(**DIMS, **over, compute_dtype=torch.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    if kind == "ilql":
        jm = jax_policy.CausalLMWithILQLHeads(jcfg, two_qs=True)
        params = jm.init(jax.random.PRNGKey(0), ids, ids)["params"]
    elif kind == "hydra":
        jm = jax_policy.CausalLMWithValueHead(jcfg, num_value_layers=1)
        params = jm.init(jax.random.PRNGKey(0), ids, ids)["params"]
    elif kind == "llama_gqa":
        jm = jax_policy.CausalLMWithValueHead(jcfg)
        params = jm.init(jax.random.PRNGKey(0), ids, ids)["params"]
    else:
        jm = JaxLM(jcfg)
        params = {"transformer": jm.init(jax.random.PRNGKey(0), ids, ids)["params"]}
    params = jax.tree.map(np.asarray, params)
    if kind == "gpt2":
        from trlx_tpu_torch.models.convert import params_from_jax

        state = {f"transformer.{k}": v for k, v in params_from_jax(params["transformer"], tcfg).items()}
    else:
        state = policy_params_from_jax(params, tcfg)
    return params, state


def _jax_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        out.update(_jax_paths(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("kind", ["gpt2", "llama_gqa", "hydra", "ilql"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_state_specs_match_jax(kind, mesh_name):
    import jax
    import optax

    from trlx_tpu.ops.quantized_adam import adamw_8bit
    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu.parallel import sharding as jax_sharding
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.parallel.sharding import (
        default_lm_rules,
        flax_path,
        make_param_specs,
        make_state_shardings,
        spec_for_path,
    )

    sizes = MESHES[mesh_name]
    jm = jax_mesh.make_deviceless_mesh(**sizes)
    params, state = _model_pair(kind)
    want = {p: tuple(s) for p, s in _jax_paths(jax_sharding.make_param_specs(params, jm)).items()}
    m = make_mesh(world_size=jm.size, rank=0, build_groups=False, **sizes)
    got = {flax_path(n): tuple(s) for n, s in make_param_specs(state, m).items()}
    assert set(got) == set(want)
    for path in want:
        assert _same(got[path], want[path]), path
    # the odd vocab (13) keeps the embedding whole over model: a dim the clip drops
    raw = {flax_path(n): tuple(spec_for_path(flax_path(n), default_lm_rules())) for n in state}
    if "model" in sizes:
        assert any(not _same(raw[p], got[p]) for p in got)
    for tx, keys in ((optax.adamw(1e-3), ("mu", "nu")), (adamw_8bit(1e-3), ("m_q", "m_scale", "v_q", "v_scale"))):
        from jax.tree_util import tree_flatten_with_path

        jstate = jax.eval_shape(tx.init, params)
        shard = jax_sharding.make_state_shardings(jstate, jm)
        flat, _ = tree_flatten_with_path(jstate)
        specs = [s.spec for s in jax.tree.leaves(shard, is_leaf=lambda x: hasattr(x, "spec"))]
        port_state = {}
        expect = {}
        for (path, leaf), spec in zip(flat, specs):
            p = jax_sharding._path_str(path)
            for key in keys:
                if f"/{key}/" in f"/{p}/":
                    port_key = _port_state_path(p, key)
                    port_state[port_key] = tuple(leaf.shape)
                    expect[port_key] = tuple(spec)
        assert port_state, kind
        got_state = make_state_shardings(port_state, m)
        for key, spec in expect.items():
            assert _same(got_state[key], spec), key


#: the port's names of optax's AdamW moments
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def _port_state_path(path: str, key: str) -> str:
    """A JAX optimizer-state path holding ``key`` as the port's state path:
    ``0/mu/<param>`` -> ``exp_avg/<param>``, ``moments/<param>/m_q`` ->
    ``<param>/m_q``."""
    if key in _MOMENTS:
        return f"{_MOMENTS[key]}/{path.split(f'{key}/', 1)[1]}"
    return f"{path.split('moments/', 1)[1].rsplit('/', 1)[0]}/{key}"


def _same(a, b) -> bool:
    """Equal placements (trailing Nones place nothing)."""
    w = max(len(a), len(b))
    return tuple(a) + (None,) * (w - len(a)) == tuple(b) + (None,) * (w - len(b))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_gather_round_trip_matches_addressable_shards(mesh_name):
    import jax

    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu.parallel import sharding as jax_sharding
    from trlx_tpu_torch.models.convert import gather_state, shard_state
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.parallel.sharding import flax_path

    sizes = MESHES[mesh_name]
    jm = jax_mesh.make_deviceless_mesh(**sizes)
    params, state = _model_pair("hydra")
    placed = jax_sharding.shard_params(params, jm)
    jleaves = _jax_paths(placed)
    m = make_mesh(world_size=jm.size, rank=0, build_groups=False, **sizes)
    blocks = [shard_state(state, m, rank) for rank in range(jm.size)]
    back = gather_state(blocks, m, {k: v.shape for k, v in state.items()})
    assert set(back) == set(state)
    for name in state:
        assert torch.equal(back[name], state[name]), name
    split = 0
    for rank in range(jm.size):
        coords = make_mesh(world_size=jm.size, rank=rank, build_groups=False, **sizes).coords
        dev = jm.devices[tuple(coords[a] for a in ("data", "fsdp", "pipe", "model"))]
        for name, block in blocks[rank].items():
            arr = jleaves[flax_path(name)]
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(block.numpy(), np.asarray(shard.data), err_msg=name)
            split += block.numel() < state[name].numel()
    assert split > 0


def test_mesh_of_the_wrong_size_raises():
    from trlx_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="does not match device count 2"):
        make_mesh(data=4, world_size=2, rank=0, build_groups=False)
    with pytest.raises(ValueError, match="At most one mesh axis may be -1"):
        make_mesh(data=-1, fsdp=-1, world_size=2, rank=0, build_groups=False)


def test_unreachable_coordinator_raises_naming_it(tmp_path):
    """A rank whose coordinator never answers fails with the address in the
    message, after ``TRLX_DIST_TIMEOUT_S``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, TRLX_NUM_PROCESSES="2", TRLX_COORDINATOR=f"127.0.0.1:{port}",
               TRLX_PROCESS_ID="1", TRLX_DIST_TIMEOUT_S="3")
    code = ("from trlx_tpu_torch.parallel.mesh import initialize_distributed; "
            "initialize_distributed(device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert f"coordinator 127.0.0.1:{port}" in p.stderr and "could not join" in p.stderr


def test_overlap_specs_match_jax():
    """``make_overlap_specs`` against the JAX function on the overlap
    tests' MLP rules: parameter specs, fsdp shard dims, and the moments'
    and 8-bit blocks' specs (blocks over fsdp exactly when their parameter
    is)."""
    import optax
    from jax.sharding import PartitionSpec as P
    from jax.tree_util import tree_flatten_with_path

    from trlx_tpu.ops.quantized_adam import adamw_8bit
    from trlx_tpu.parallel import fsdp as jax_fsdp
    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu.parallel.sharding import _path_str
    from trlx_tpu_torch.parallel.fsdp import make_overlap_specs
    from trlx_tpu_torch.parallel.mesh import make_mesh
    from trlx_tpu_torch.parallel.sharding import PartitionSpec

    params = {"dense": {"kernel": np.zeros((16, 8), np.float32), "bias": np.zeros((8,), np.float32)},
              "out": {"kernel": np.zeros((8, 4), np.float32)}}
    jrules = [(r".*dense/kernel$", P("fsdp", None)), (r".*out/kernel$", P(None, "fsdp")), (r".*", P())]
    prules = [(r".*dense/kernel$", PartitionSpec("fsdp", None)), (r".*out/kernel$", PartitionSpec(None, "fsdp")),
              (r".*", PartitionSpec())]
    jm = jax_mesh.make_deviceless_mesh(data=2, fsdp=2)
    m = make_mesh(data=2, fsdp=2, world_size=4, rank=0, build_groups=False)
    flat = {"dense.kernel": (16, 8), "dense.bias": (8,), "out.kernel": (8, 4)}
    for tx, keys in ((optax.adamw(1e-2), ("mu", "nu")), (adamw_8bit(1e-2), ("m_q", "m_scale", "v_q", "v_scale"))):
        want = jax_fsdp.make_overlap_specs(params, tx, jm, jrules)
        got = make_overlap_specs(flat, m, tuple(_MOMENTS.get(k, k) for k in keys), prules)
        for name in flat:
            path = name.split(".")
            assert _same(got.param_specs[name], want.param_specs[path[0]][path[1]]), name
            assert got.shard_dims[name] == want.shard_dims[path[0]][path[1]], name
        leaves, _ = tree_flatten_with_path(want.state_specs, is_leaf=lambda x: isinstance(x, P))
        compared = 0
        for path, spec in leaves:
            p = _path_str(path)
            for key in keys:
                if f"/{key}/" in f"/{p}/":
                    port_path = _port_state_path(p, key)
                    assert _same(got.state_specs[port_path], spec), port_path
                    compared += 1
        assert compared == 3 * len(keys)


def test_axis_groups_are_shared_by_copies():
    """A deep copy of a tensor-parallel module (the bf16 rollout copy)
    keeps its layers' process groups."""
    import copy

    from trlx_tpu_torch.parallel.mesh import AxisGroup

    g = AxisGroup(object(), 2, 1, ("model",))
    assert copy.deepcopy({"g": g})["g"] is g


# -- island meshes ---------------------------------------------------------------

ISLANDS = [(4, 1, dict(data=-1)), (4, 2, dict(data=1, fsdp=2)), (8, 2, dict(data=3, fsdp=2)),
           (8, 4, dict(fsdp=2, model=2)), (1, 1, dict(data=1))]


@pytest.mark.parametrize("n,gen,axes", ISLANDS, ids=[f"{n}-{g}-{a}" for n, g, a in ISLANDS])
def test_island_meshes_match_jax(n, gen, axes):
    """The generation and learner meshes over a carve: their rank sets are
    the JAX meshes' device ids, with the same axis sizes, disjoint unless
    the carve is shared (one device)."""
    import jax

    from trlx_tpu.parallel import mesh as jax_mesh
    from trlx_tpu_torch.parallel.mesh import MESH_AXES, carve_islands, island_meshes

    jg, jl = jax_mesh.island_meshes(jax_mesh.carve_islands(gen, jax.devices()[:n]), **axes)
    placement = carve_islands(gen, list(range(n)))
    for rank in range(n):
        g, learn = island_meshes(placement, rank=rank, build_groups=False, **axes)
        for mine, want in ((g, jg), (learn, jl)):
            assert mine.ranks == tuple(int(d.id) for d in want.devices.flatten())
            assert mine.shape == dict(want.shape)
            assert mine.member == (rank in mine.ranks)
            if mine.member:
                pos = mine.ranks.index(rank)
                coords = tuple(int(c) for c in np.argwhere(want.devices == jax.devices()[rank])[0])
                assert tuple(mine.coords[a] for a in MESH_AXES) == coords and mine.rank == pos
        assert placement.shared or not set(g.ranks) & set(learn.ranks)


def island_sums():
    """A rank's all-reduce of its rank over each island's whole mesh (a job)."""
    import torch

    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import carve_islands, island_meshes, process_count, process_index

    g, learn = island_meshes(carve_islands(2, list(range(process_count()))), data=1, fsdp=2)
    me = torch.tensor([float(process_index())])
    mesh = g if g.member else learn
    return {"gen": g.member, "sum": float(coll.all_reduce(me, mesh.world_group)[0]),
            "fsdp_index": mesh.group("fsdp").index, "data": float(coll.all_reduce(me, mesh.group("data"))[0])}


def test_island_meshes_groups_hold_their_own_ranks(tmp_path):
    """On 4 gloo ranks, carve 2 for generation: each island's groups sum
    over its own ranks only (learner 0 + 1, generation 2 + 3)."""
    ranks = [r[0] for r in run_ranks(4, [("tests.test_torch_mesh:island_sums", {})], tmp_path, timeout=120)]
    assert [r["gen"] for r in ranks] == [False, False, True, True]
    assert [r["sum"] for r in ranks] == [1.0, 1.0, 5.0, 5.0]
    assert [r["fsdp_index"] for r in ranks[:2]] == [0, 1]
    assert [r["data"] for r in ranks] == [0.0, 1.0, 5.0, 5.0]
