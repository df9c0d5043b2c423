"""Ring attention: the port's ``ring_attention`` on 2 and 4 gloo ranks against
the JAX ``ring_attention`` on a ``model`` mesh of the same size (the first
N of the conftest's virtual CPU devices) and against full attention on one
rank (the ports of ``tests/test_ring_attention.py``).

Checked: the forward, causal and not, with left padding crossing shard
boundaries and with GQA keys (fewer heads than queries), within 1e-5; the
gradients of q, k and v under a non-uniform cotangent within 1e-5; a
``TransformerLM`` with ``attention_impl="ring"`` on ``data=2 x model=2``
(tensor parallelism, heads moved to sequence shards and back) against the
JAX model on the same mesh: logits and every leaf's gradient block; the
ring counted (rotations > 0); and the saved tensors a rank keeps for the
backward at n=4 under half of those at n=1 for the same global shapes.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import run_ranks

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)
#: (name, causal, padded, q heads, kv heads)
CASES = [("causal", True, False, 2, 2), ("full", False, False, 2, 2), ("padded", True, True, 2, 2),
         ("gqa_padded", True, True, 4, 2)]
B, S, D = 2, 32, 8


def _case_inputs(case):
    name, causal, padded, H, Hkv = case
    rng = np.random.default_rng(CASES.index(case))
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    if padded:
        valid[0, :11] = 0  # crosses shard boundaries at n = 2 and 4
    w = (np.arange(B * H * S * D, dtype=np.float32).reshape(B, H, S, D) / (B * H * S * D))
    return q, k, v, valid, w


def _weigh(out, w):
    """A non-uniform cotangent: d/dout = w + 2 out."""
    return torch.sum(out * torch.as_tensor(w)) + torch.sum(out ** 2)


def ring_job():
    """A rank's ring over its sequence shard for every case: the output and
    the q/k/v gradients (its shard), the rotations counted, and the bytes
    it saved for the backward."""
    from trlx_tpu_torch.ops.ring_attention import ring_attention
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(data=1, model=-1)
    g = m.group("model")
    n, i = g.size, g.index
    rows = slice(i * S // n, (i + 1) * S // n)
    out = {"index": i, "cases": {}}
    coll.reset_counts()
    for case in CASES:
        q, k, v, valid, w = _case_inputs(case)
        qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(x[:, :, rows])).requires_grad_() for x in (q, k, v))
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            o = ring_attention(qt, kt, vt, g, case[1], kv_valid=torch.from_numpy(valid[:, rows]))
        _weigh(o, w[:, :, rows]).backward()
        out["cases"][case[0]] = dict(out=o.detach().numpy(), dq=qt.grad.numpy(), dk=kt.grad.numpy(),
                                     dv=vt.grad.numpy(), saved=saved[0])
    out["counts"] = coll.sequence_counts()
    return out


def _jax_ring(case, n):
    """The JAX ring on a model=n mesh: output and q/k/v gradients."""
    import jax
    import jax.numpy as jnp

    from trlx_tpu.ops.ring_attention import ring_attention as jax_ring
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh

    q, k, v, valid, w = _case_inputs(case)
    mesh = jax_make_mesh(data=1, fsdp=1, model=n, devices=jax.devices()[:n])

    def loss(q, k, v):
        o = jax_ring(q, k, v, mesh, "model", case[1], kv_valid=jnp.asarray(valid))
        return jnp.sum(o * w) + jnp.sum(o ** 2), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _full(case):
    """Full attention on one rank (plain PyTorch, GQA keys repeated, zero
    output where a query sees no valid key): the output and the q/k/v
    gradients."""
    q, k, v, valid, w = _case_inputs(case)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    kr, vr = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    s = qt @ kr.transpose(-1, -2) / np.sqrt(D)
    mask = torch.from_numpy(valid).bool()[:, None, None, :]
    if case[1]:
        mask = mask & torch.ones(S, S, dtype=torch.bool).tril()
    o = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), -1) @ vr
    # a query that sees no valid key gives zeros (the ring's and the flash kernel's convention)
    o = o * mask.any(-1, keepdim=True)
    _weigh(o, w).backward()
    return o.detach().numpy(), [qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()]


def _gather(ranks, case, key):
    parts = sorted((r["index"], r["cases"][case][key]) for r in ranks)
    return np.concatenate([p for _, p in parts], axis=2)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_and_full_attention(tmp_path, n):
    """Forward and gradients on n ranks against the JAX ring on n devices
    and full attention; at n=4 a rank saves under half the bytes one rank
    saves for the same global shapes."""
    handle = run_ranks(n, [("tests.test_torch_ring_attention:ring_job", {})], tmp_path / "ranks", wait=False)
    try:
        want = {case[0]: (_jax_ring(case, n), _full(case)) for case in CASES}
        if n == 4:
            from trlx_tpu_torch.ops.ring_attention import ring_attention

            q, k, v, valid, _ = _case_inputs(CASES[0])
            saved = [0]

            def pack(t):
                saved[0] += t.numel() * t.element_size()
                return t

            qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                ring_attention(qt, kt, vt, None, True, kv_valid=torch.from_numpy(valid))
    finally:
        ranks = [r[0] for r in handle.results()]
    for case in CASES:
        (jo, jg), (fo, fg) = want[case[0]]
        got = _gather(ranks, case[0], "out")
        np.testing.assert_allclose(got, jo, err_msg=f"{case[0]} out vs JAX", **TOL)
        np.testing.assert_allclose(got, fo, err_msg=f"{case[0]} out vs full", **TOL)
        for key, j, f in zip(("dq", "dk", "dv"), jg, fg):
            g = _gather(ranks, case[0], key)
            np.testing.assert_allclose(g, j, err_msg=f"{case[0]} {key} vs JAX", **TOL)
            np.testing.assert_allclose(g, f, err_msg=f"{case[0]} {key} vs full", **TOL)
    for r in ranks:
        # forward n - 1 rotations, backward n, per case
        assert r["counts"]["rotations"] == len(CASES) * (2 * n - 1)
    if n == 4:
        per_rank = max(r["cases"]["causal"]["saved"] for r in ranks)
        assert 0 < per_rank < saved[0] / 2, (per_rank, saved[0])


DIMS = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=64)
MB, MT = 4, 32


def _model_inputs():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, DIMS["vocab_size"], (MB, MT)).astype(np.int32)
    mask = np.ones((MB, MT), np.int32)
    mask[0, :7] = 0
    mask[3, :19] = 0
    return ids, mask


def model_job(state):
    """A rank's ring-attention TransformerLM on data=2 x model=2: its rows'
    logits, every leaf's gradient block (summed over the batch ranks), the
    ring rotations."""
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.models.transformer import TransformerLM
    from trlx_tpu_torch.parallel import collectives as coll
    from trlx_tpu_torch.parallel.mesh import make_mesh, put_batch
    from trlx_tpu_torch.parallel.sharding import apply_mesh

    m = make_mesh(data=2, model=2)
    model = TransformerLM(PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32, attention_impl="ring"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    apply_mesh(model, m)
    ids, mask = (put_batch(m, x) for x in _model_inputs())
    coll.reset_counts()
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    (logits ** 2 * torch.from_numpy(mask)[..., None]).sum().div(MB * MT).backward()
    grads = {n: coll.all_reduce(p.grad, m.batch_group).numpy() for n, p in model.named_parameters()}
    return dict(rank=m.rank, logits=logits.detach().numpy(), grads=grads, counts=coll.sequence_counts())


def test_ring_transformer_matches_jax_on_data2_model2(tmp_path):
    import jax
    import jax.numpy as jnp

    from trlx_tpu.models.presets import PRESETS as JAX_PRESETS
    from trlx_tpu.models.transformer import TransformerLM as JaxLM
    from trlx_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from trlx_tpu_torch.models.convert import _flatten, params_from_jax, shard_state
    from trlx_tpu_torch.models.presets import PRESETS
    from trlx_tpu_torch.parallel.mesh import make_mesh

    cfg = JAX_PRESETS["gpt2"].replace(**DIMS, compute_dtype=jnp.float32)
    ids, mask = _model_inputs()
    params = jax.device_get(JaxLM(cfg).init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"])
    pcfg = PRESETS["gpt2"].replace(**DIMS, compute_dtype=torch.float32)
    state = {k: v.numpy() for k, v in params_from_jax(params, pcfg).items()}
    handle = run_ranks(4, [("tests.test_torch_ring_attention:model_job", dict(state=state))], tmp_path / "ranks",
                       wait=False)
    try:
        mesh = jax_make_mesh(data=2, fsdp=1, model=2, devices=jax.devices()[:4])
        ring = JaxLM(cfg.replace(attention_impl="ring"))

        def loss(p):
            lg = ring.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))[0]
            return jnp.sum(lg ** 2 * jnp.asarray(mask)[..., None]) / (MB * MT), lg

        with mesh:
            (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        jgrads = {k: torch.from_numpy(np.asarray(v)) for k, v in _flatten(jax.device_get(jgrads)).items()}
    finally:
        ranks = [r[0] for r in handle.results()]
    m = make_mesh(data=2, model=2, world_size=4, rank=0, build_groups=False)
    rows = {0: slice(0, 2), 1: slice(0, 2), 2: slice(2, 4), 3: slice(2, 4)}
    for r in ranks:
        assert r["counts"]["rotations"] > 0
        np.testing.assert_allclose(r["logits"], np.asarray(jlogits)[rows[r["rank"]]], **TOL)
        want = shard_state(jgrads, m, r["rank"])
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, want[name].numpy(), err_msg=name, **TOL)
