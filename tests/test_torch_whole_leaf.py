"""The whole-leaf optimizers over leaves held as blocks
(:class:`trlx_tpu_torch.parallel.fsdp.WholeLeafOptimizer`) against the
same optimizer over the whole leaves on one process, fed the same whole
gradients: 8-bit AdamW (its blocks of the flattened leaf moved between
the fsdp shards and each rank's range of blocks) and Adafactor (its means
and sums of squares completed over the ranks), on 4 gloo ranks as
``fsdp=4``, ``fsdp=2 x model=2`` and ``data=2 x fsdp=2``. The leaves take
the default rules' layouts: sharded on dim 0 and on dim 1, flat sizes that
are not a multiple of 256, block counts that do and do not split over
``fsdp``, ranges that start inside a row, and one whose ranges are its
shards. The gradients are the only input, so the 8-bit parameters and
codes are held equal, and Adafactor (sums in another order) within 1e-6
relative. Both are also held against the JAX package's optimizers (its
8-bit module, ``optax.adafactor``) on the same inputs: 8-bit codes within
1 of the JAX module's, parameters within 1e-6."""

import numpy as np
import pytest

from tests.test_torch_mesh import run_ranks

pytestmark = pytest.mark.torch_port

#: name -> whole shape (names the default rules place)
LEAVES = {
    "transformer.embed_tokens.embedding": (12, 32),
    "transformer.embed_positions.embedding": (40, 32),
    "transformer.layers_0.attn.q_proj.kernel": (40, 48),
    "transformer.layers_0.attn.q_proj.bias": (48,),
    "transformer.layers_0.attn.o_proj.kernel": (24, 40),
    "transformer.layers_0.mlp.up_proj.kernel": (32, 128),
    "transformer.layers_0.mlp.down_proj.kernel": (72, 40),
    "transformer.ln_f.scale": (32,),
}
MESHES = {"fsdp4": dict(fsdp=4), "fsdp2_model2": dict(fsdp=2, model=2), "data2_fsdp2": dict(data=2, fsdp=2)}
OPTIMIZERS = {"adamw_8bit_bnb": dict(learning_rate=1e-2, weight_decay=0.01),
              "adafactor": dict(learning_rate=1e-2, min_dim_size_to_factor=16)}
STEPS = 3


def _tree(params):
    """A module holding ``{dotted name: tensor}`` as parameters of those names."""
    import torch

    root = torch.nn.Module()
    for name, value in params.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, torch.nn.Module())
            node = getattr(node, part)
        node.register_parameter(leaf, torch.nn.Parameter(value.clone()))
    return root


def run(opt, mesh):
    """One rank: the whole-leaf optimizer over this rank's blocks and the
    plain one over the whole leaves, ``STEPS`` steps of the same seeded
    whole gradients; the gathered parameters and state of both, and the
    round trip of the state through the checkpoint layout."""
    import torch

    from trlx_tpu_torch.parallel.fsdp import ShardedParams, WholeLeafOptimizer, split_axes
    from trlx_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from trlx_tpu_torch.parallel.sharding import make_param_specs, shard_tensor
    from trlx_tpu_torch.utils import get_optimizer_class

    m = make_mesh(**mesh)
    gen = torch.Generator().manual_seed(0)
    whole = {n: torch.randn(s, generator=gen) for n, s in LEAVES.items()}
    specs = make_param_specs(whole, m)
    module = _tree({n: shard_tensor(v, specs[n], m, [MODEL_AXIS]) for n, v in whole.items()})
    shards = ShardedParams({"": module}, specs, m)
    leaves = list(shards.leaves)
    for leaf in leaves:
        leaf.master.requires_grad_(True)
    cls = get_optimizer_class(opt)
    wl = WholeLeafOptimizer(cls, leaves, shards, opt != "adafactor", **OPTIMIZERS[opt])
    ref_params = [torch.nn.Parameter(whole[leaf.name].clone()) for leaf in leaves]
    ref = cls(ref_params, **OPTIMIZERS[opt])
    steps = []
    for _ in range(STEPS):
        grads = {n: torch.randn(s, generator=gen) for n, s in LEAVES.items()}
        steps.append({n: g.numpy() for n, g in grads.items()})
        for leaf, p in zip(leaves, ref_params):
            leaf.master.grad = shards.local_block(leaf, grads[leaf.name]).clone()
            p.grad = grads[leaf.name].clone()
        wl.step()
        ref.step()
    state, round_trip = {}, True
    for i, (leaf, proxy) in enumerate(zip(leaves, wl.proxies)):
        st = wl.optimizer.state[proxy]
        state[leaf.name] = {k: wl.gather_state(i, k, v) for k, v in st.items() if torch.is_tensor(v) and v.dim()}
        for k, v in state[leaf.name].items():
            round_trip &= torch.equal(wl.scatter_state(i, k, v), st[k])
    return {
        "params": {leaf.name: shards.full_tensor(leaf, leaf.master.data).numpy() for leaf in leaves},
        "state": {n: {k: v.numpy() for k, v in st.items()} for n, st in state.items()},
        "want_params": {leaf.name: p.detach().numpy() for leaf, p in zip(leaves, ref_params)},
        "want_state": {leaf.name: {k: v.numpy() for k, v in ref.state[p].items() if torch.is_tensor(v) and v.dim()}
                       for leaf, p in zip(leaves, ref_params)},
        "split": {leaf.name: split_axes(leaf) for leaf in leaves},
        "exchanged": [leaf.name for leaf, flat in zip(leaves, getattr(wl, "flat", [])) if flat is not None],
        "aligned": [leaf.name for leaf, flat in zip(leaves, getattr(wl, "flat", [])) if flat is not None
                    and flat.aligned],
        "round_trip": round_trip,
        "inputs": {"init": {n: v.numpy() for n, v in whole.items()}, "grads": steps},
    }


def jax_reference(opt, inputs):
    """The JAX package's optimizer over the whole leaves from the same
    inputs: its parameters and (8-bit) moments by name."""
    import jax.numpy as jnp
    import optax

    from trlx_tpu.ops.quantized_adam import adamw_8bit

    kw = dict(OPTIMIZERS[opt])
    lr = kw.pop("learning_rate")
    tx = adamw_8bit(lr, **kw) if opt == "adamw_8bit_bnb" else optax.adafactor(lr, **kw)
    params = {n: jnp.asarray(v) for n, v in inputs["init"].items()}
    state = tx.init(params)
    for grads in inputs["grads"]:
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
    moments = state["moments"] if opt == "adamw_8bit_bnb" else {}
    return {n: np.asarray(v) for n, v in params.items()}, {n: {k: np.asarray(x) for k, x in m.items()}
                                                          for n, m in moments.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jobs = [("tests.test_torch_whole_leaf:run", dict(opt=opt, mesh=mesh))
            for opt in OPTIMIZERS for mesh in MESHES.values()]
    return run_ranks(4, jobs, tmp_path_factory.mktemp("whole_leaf"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_whole_leaf_step_equals_the_unsharded_step(results, opt, mesh):
    j = list(OPTIMIZERS).index(opt) * len(MESHES) + list(MESHES).index(mesh)
    jax_params, jax_moments = jax_reference(opt, results[0][j]["inputs"])
    for rank in results:
        r = rank[j]
        for name, want in jax_params.items():
            np.testing.assert_allclose(r["params"][name], want, rtol=0, atol=1e-6, err_msg=f"{name} vs JAX")
            for code in ("m_q", "v_q") if opt == "adamw_8bit_bnb" else ():
                diff = np.abs(r["state"][name][code].astype(np.int32) - jax_moments[name][code].astype(np.int32))
                assert diff.max() <= 1, (name, code, int(diff.max()))
        assert r["round_trip"]
        assert any(r["split"].values())
        for name, want in r["want_params"].items():
            if opt == "adafactor":
                np.testing.assert_allclose(r["params"][name], want, rtol=1e-6, atol=1e-7, err_msg=name)
            else:
                np.testing.assert_array_equal(r["params"][name], want, err_msg=name)
            assert set(r["state"][name]) == set(r["want_state"][name]), name
            for k, v in r["want_state"][name].items():
                if opt == "adafactor":
                    np.testing.assert_allclose(r["state"][name][k], v, rtol=1e-6, atol=1e-30, err_msg=f"{name} {k}")
                else:
                    np.testing.assert_array_equal(r["state"][name][k], v, err_msg=f"{name} {k}")
        if opt == "adamw_8bit_bnb" and mesh != "fsdp2_model2":
            # the exchange ran: dim-0 and dim-1 shards whose ranges cross rows, and one whose ranges are its shards
            assert {"transformer.layers_0.attn.o_proj.kernel", "transformer.layers_0.mlp.down_proj.kernel",
                    "transformer.layers_0.attn.q_proj.kernel"} <= set(r["exchanged"]), r["exchanged"]
            assert "transformer.layers_0.mlp.up_proj.kernel" in r["aligned"]
