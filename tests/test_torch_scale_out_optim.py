"""Scale-out parity for the optimizers whose update reads the whole leaf:
``adamw_8bit_bnb`` (blocks of 256 elements of the flattened leaf, the
block dim over ``fsdp``) and ``adafactor`` (factored by the whole leaf's
shape; its row / column means and its clipping and parameter-scale RMS
over the whole leaf) in the default step, on ``fsdp=2`` and ``model=2``
(2 gloo ranks; Adafactor in
:mod:`tests.test_torch_scale_out_optim_adafactor`), against optax under
the JAX trainer on meshes of the same shape: SFT at the scale-out tests'
tiny width, with the checks of
:mod:`tests.test_torch_scale_out`. The tiny gpt2 has leaves sharded on
dim 1 (``o_proj`` and ``down_proj`` kernels over ``fsdp``) and leaves
whose flat size is not a multiple of 256 (the 12 x 32 embedding, the
biases); Adafactor factors at ``min_dim_size_to_factor=16`` so that its
factored path runs at this width. The key-projection biases are held as
noise leaves (their gradient is zero in exact arithmetic: softmax cancels
a shift shared by a query's scores). ``m``'s 8-bit codes are within 1 of
the JAX module's, and at most 0.1% of the codes differ (the one-device
test's limit is 1 a step, and so is :mod:`tests.test_torch_whole_leaf`'s
on the same gradient; here the gradients are summed in another order, a
code one off after the first step enters the second step's
requantization through ``b2 v``, and a block's log range is set by its
smallest moment, whose gradient may be rounding), ``m``'s scales within
1e-5, ``v``'s log-space pair within a quarter of one code's step, and
each rank's state bytes are its share of the whole-leaf layout; since a
code one off moves its step's update by up to a few percent, 8-bit
parameters are held to 1e-5 plus :data:`CODE_STEP` of two steps' rate.
"""

import math

import numpy as np
import pytest

from tests.test_torch_mesh import run_ranks
from tests.test_torch_scale_out import _drive, compare, jax_trainer

pytestmark = pytest.mark.torch_port

OPTIMIZERS = {
    "adamw_8bit_bnb": {"optimizer.name": "adamw_8bit_bnb"},
    "adafactor": {"optimizer.name": "adafactor",
                  "optimizer.kwargs": dict(lr=3e-3, min_dim_size_to_factor=16, max_grad_norm=1.0)},
}
MESHES = {"fsdp2": dict(fsdp=2), "model2": dict(model=2)}
#: the share of a step's update that one code of an 8-bit moment can move
#: (a log-space v code spans ``log range / 254``, an m code ``absmax / 127``)
CODE_STEP = 0.05


def probe(trainer):
    """This rank's optimizer state: whole-leaf 8-bit blocks gathered, and
    its bytes."""
    from trlx_tpu_torch.utils.optim import state_bytes

    wl = trainer.whole_leaf
    names = {id(leaf.master): leaf.name for leaf in trainer.shards.leaves}
    state = {}
    for i, (leaf, proxy) in enumerate(zip(wl.leaves, wl.proxies)):
        st = wl.optimizer.state[proxy]
        state[names[id(leaf.master)]] = {k: wl.gather_state(i, k, v).numpy() for k, v in st.items()
                                         if k in ("m_q", "m_scale", "v_q", "v_scale")}
    return {"state": state, "bytes": state_bytes(wl.optimizer), "block_sharded": list(wl.block_sharded)}


def optimizer_fixture(opt):
    """A module fixture for one optimizer: its JAX trainers on both shapes
    here, the port's runs on one rank group meanwhile."""

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPipeline

        tmp = tmp_path_factory.mktemp(f"optim_{opt}")
        jts, jobs = {}, []
        for shape, mesh in MESHES.items():
            jts[shape], init = jax_trainer("sft", mesh, 2, tmp / f"jax_{shape}", OPTIMIZERS[opt])
            jobs.append(("tests.test_torch_scale_out:port_train",
                         dict(kind="sft", mesh=mesh, init=init, ckpt_dir=str(tmp / f"port_{shape}"),
                              patch=OPTIMIZERS[opt], probe="tests.test_torch_scale_out_optim:probe")))
        handle = run_ranks(2, jobs, tmp / "ranks", wait=False)
        try:
            jrecs = {shape: _drive(jt, "sft", JaxPipeline) for shape, jt in jts.items()}
            results = handle.results()
        finally:
            handle.kill()
        yield jts, jrecs, results

    return runs


def _jax_moments(jt):
    """``{port name: {m_q, m_scale, v_q, v_scale}}`` of the JAX 8-bit state."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jt.opt_state)[0]:
        keys = [getattr(k, "key", None) for k in path]
        if "moments" in keys and keys[-1] in ("m_q", "m_scale", "v_q", "v_scale"):
            name = ".".join(keys[keys.index("moments") + 1:-1])
            out.setdefault(name, {})[keys[-1]] = np.asarray(jax.device_get(leaf))
    return out


def check_shape(runs, opt, shape):
    jts, jrecs, results = runs
    ranks = [r[list(MESHES).index(shape)] for r in results]
    jt = jts[shape]
    slack = None
    if opt == "adamw_8bit_bnb":
        # a moment code one off (the limit below) moves that step's update by a few percent
        lr = jt.config.optimizer.kwargs["lr"]
        slack = {n: np.full(v.shape, CODE_STEP * lr * 2, np.float32) for n, v in ranks[0]["params"].items()}
    # a key bias shifts all of a query's scores alike: softmax cancels it, its gradient is rounding
    noise = {n for n in ranks[0]["params"] if n.endswith("attn.k_proj.bias")}
    compare("sft", jrecs[shape], jt, ranks, noise=noise, slack=slack)
    params = ranks[0]["params"]
    assert any(n.endswith("o_proj.kernel") for n in params)
    assert any(v.size % 256 for v in params.values())
    if opt != "adamw_8bit_bnb":
        return
    want = _jax_moments(jt)
    off = [0, 0]  # codes that differ, codes compared
    worst = {"m_q": (0,), "v_q": (0,)}
    for r in ranks:
        assert set(r["probe"]["state"]) == set(want)
        for name, st in r["probe"]["state"].items():
            if name in noise:  # codes of rounding noise
                continue
            for code in ("m_q", "v_q"):
                diff = np.abs(st[code].astype(np.int32) - want[name][code].astype(np.int32))
                off[0] += int((diff > 0).sum())
                off[1] += diff.size
                if int(diff.max()) > worst[code][0]:
                    worst[code] = (int(diff.max()), name)
            np.testing.assert_allclose(st["m_scale"], want[name]["m_scale"], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{shape} {name} m_scale")
            # (log min, log range) of v: the block's smallest gradient sets log min, and its
            # rounding moves it; held within a quarter of one code's step (log range / 254)
            vs, wv = st["v_scale"], want[name]["v_scale"]
            bound = 1e-5 * np.abs(wv) + 0.25 * wv[:, 1:] / 254
            assert np.all(np.abs(vs - wv) <= bound), (shape, name, "v_scale")
    # a code one off after step 1 enters step 2's requantization through b2 v (and a block's
    # log range is set by its smallest moment): the limit is on the share of codes that differ
    assert off[0] <= 1e-3 * off[1], off
    # m's codes are linear in the block's absmax: a gradient that is rounding stays within a code of 0
    # (v's are log-space: such a gradient's code follows its rounding; the share above bounds them, and
    # tests.test_torch_whole_leaf holds every code within 1 of the JAX module's on the same gradient)
    assert worst["m_q"][0] <= 1, worst
    # each rank holds its blocks: 524 bytes a block, and the 4-byte count
    nb = {n: math.ceil(v.size / 256) for n, v in params.items()}
    f = MESHES[shape].get("fsdp", 1)
    own = sum(nb[n] // f if nb[n] % f == 0 else nb[n] for n in nb)
    for r in ranks:
        assert r["probe"]["bytes"] == own * 524 + 4
    if f > 1:
        assert any(ranks[0]["probe"]["block_sharded"])


adamw_8bit = optimizer_fixture("adamw_8bit_bnb")


@pytest.mark.parametrize("shape", list(MESHES))
def test_adamw_8bit_matches_optax_on_a_mesh(adamw_8bit, shape):
    check_shape(adamw_8bit, "adamw_8bit_bnb", shape)
