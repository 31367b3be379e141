"""apex_tpu_torch.transformer.context_parallel and the cp branch of the
port's ParallelAttention against apex_tpu's, at cp 4.

One gloo world of 4 ranks runs every cp case; JAX runs the same inputs
under ``shard_map`` over 4 virtual devices (the sequence split on the
``"cp"`` axis), with weights initialised in JAX and carried over as
numpy:

- ``ring_attention`` causal and not, fp32, each rank's output block and
  its q / k / v gradients (of ``sum(out * ct)``), and in bf16 at s 1024
  (128 tokens a rank) against JAX's bf16 ring and dense fp32 attention;
- ``ParallelAttention(apply_rope=True)`` at tp 1 x cp 4 (RoPE offset by
  the rank's block), against JAX's cp run and the unsplit JAX module;
- a 2-layer RoPE ``TransformerLanguageModel`` at cp 4: the hidden states
  and each rank's gradients (its tokens' share, as JAX leaves them);
- learned positions: ``Embedding``'s default position ids are the local
  ``0 .. s / cp - 1`` (JAX's default, so the cp run equals JAX's cp run
  and not the unsplit model); passing the global ids gives the unsplit
  model's states;
- the three raises under cp (a mask, segment ids, attention dropout).

Tolerances: fp32 ``rtol 5e-4, atol 5e-5`` (JAX's for the ring stack);
bf16 ``rtol 0.1, atol 0.05``.  This module imports JAX only inside its
fixtures and tests, so the spawned ranks stay JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer.testing.distributed import run_world

CP = 4
TOL = dict(rtol=5e-4, atol=5e-5)
BF16_TOL = dict(rtol=0.1, atol=0.05)
RING = (2, 4, 64, 16)            # b, h, s, d: 16 tokens a rank
LONG = (1, 2, 1024, 32)          # the bf16 case: 256 tokens a rank
LM = dict(num_layers=2, hidden_size=16, num_attention_heads=4, vocab_size=64,
          max_sequence_length=32)
S_LM, B_LM = 32, 2


def _blocks(a, axis, r):
    n = a.shape[axis] // CP
    return np.take(a, np.arange(r * n, (r + 1) * n), axis=axis)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _inputs():
    import jax
    import jax.numpy as jnp

    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        ParallelAttention,
        TransformerLanguageModel,
    )

    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = {"q": f(*RING), "k": f(*RING), "v": f(*RING), "ct": f(*RING),
           "lq": f(*LONG), "lk": f(*LONG), "lv": f(*LONG),
           "x": f(32, 2, 16), "ids": rng.integers(
               0, LM["vocab_size"], (B_LM, S_LM)).astype(np.int32),
           "lm_ct": f(S_LM, B_LM, LM["hidden_size"])}
    inp["attn"] = _np_tree(ParallelAttention(
        hidden_size=16, num_attention_heads=4, apply_rope=True).init(
            jax.random.PRNGKey(0), jnp.asarray(inp["x"]))["params"])
    for name, rope in (("rope_lm", True), ("pos_lm", False)):
        inp[name] = _np_tree(TransformerLanguageModel(
            **LM, apply_rope=rope).init(jax.random.PRNGKey(1),
                                        jnp.asarray(inp["ids"]))["params"])
    return inp


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _ring_rank(inp, r, group, causal, keys=("q", "k", "v"), dtype=None):
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    qkv = [torch.tensor(_blocks(inp[k], 2, r)) for k in keys]
    if dtype is not None:
        qkv = [t.to(dtype) for t in qkv]
    qkv = [t.requires_grad_() for t in qkv]
    out = ring_attention(*qkv, axis_name=group, causal=causal)
    res = {"out": out.detach().float().numpy().copy()}
    if dtype is None:
        (out * torch.tensor(_blocks(inp["ct"], 2, r))).sum().backward()
        res.update({f"d{k}": t.grad.numpy().copy() for k, t in zip(keys, qkv)})
    return res


def _attention(params, group):
    from apex_tpu_torch.transformer.testing import (
        standalone_transformer_lm as tlm,
    )

    attn = tlm.ParallelAttention(16, 4, apply_rope=True,
                                 context_parallel_axis=group, device="cpu")
    state = {f"{m}.{'weight' if leaf == 'kernel' else leaf}":
             torch.tensor(a.T if leaf == "kernel" else a)
             for m in ("query_key_value", "dense")
             for leaf, a in params[m].items()}
    attn.load_state_dict(state)
    return attn


def _lm(params, rope, group):
    from apex_tpu_torch.models.convert import transformer_lm_params_from_jax
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    m = TransformerLanguageModel(**LM, apply_rope=rope,
                                 context_parallel_axis=group, device="cpu")
    m.load_state_dict(transformer_lm_params_from_jax(params, LM["num_layers"],
                                                     apply_rope=rope))
    return m


def _raises(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return "no raise"


def _cp_world(rank, world, inp):
    import torch.distributed as dist

    group = dist.group.WORLD
    out = {}
    out["ring_causal"] = _ring_rank(inp, rank, group, True)
    out["ring_full"] = _ring_rank(inp, rank, group, False)
    out["ring_bf16"] = _ring_rank(inp, rank, group, True, ("lq", "lk", "lv"),
                                  torch.bfloat16)
    attn = _attention(inp["attn"], group)
    x = torch.tensor(_blocks(inp["x"], 0, rank))
    out["attention"] = attn(x).detach().numpy().copy()
    # the raises
    out["raise_mask"] = _raises(lambda: attn(x, torch.ones(2, 1, 8, 8,
                                                           dtype=torch.bool)))
    out["raise_segments"] = _raises(
        lambda: attn(x, segment_ids=torch.zeros(2, 8, dtype=torch.int32)))
    attn.attention_dropout = 0.1
    out["raise_dropout"] = _raises(
        lambda: attn(x, deterministic=False,
                     dropout_generator=torch.Generator().manual_seed(0)))
    # the 2-layer RoPE stack: states and this rank's gradients
    ids = torch.tensor(_blocks(inp["ids"], 1, rank)).long()
    lm = _lm(inp["rope_lm"], True, group)
    y = lm(ids)
    (y * torch.tensor(_blocks(inp["lm_ct"], 0, rank))).sum().backward()
    out["rope_lm"] = y.detach().numpy().copy()
    out["rope_lm_grads"] = {n: p.grad.numpy().copy()
                            for n, p in lm.named_parameters()}
    # learned positions: the local default, then the global ids
    lm = _lm(inp["pos_lm"], False, group)
    s_local = ids.shape[1]
    with torch.no_grad():
        out["pos_default"] = lm(ids).numpy().copy()
        pos = torch.arange(rank * s_local, (rank + 1) * s_local)[None, :]
        out["pos_global"] = lm(ids, pos).numpy().copy()
    return out


@pytest.fixture(scope="module")
def cp_world():
    inp = _inputs()
    return inp, run_world(_cp_world, CP, args=(inp,), timeout=150)


# ---------------------------------------------------------------------------
# JAX's runs
# ---------------------------------------------------------------------------


def _cp_map(fn, in_specs, out_specs, mesh_shape=(CP,), names=("cp",)):
    import jax
    from jax.sharding import Mesh

    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = Mesh(np.array(jax.devices()[:CP]).reshape(mesh_shape), names)
    return mesh, jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                                   out_specs=out_specs, **NO_REP_CHECK))


def _jax_ring(q, k, v, ct, causal):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer.context_parallel import ring_attention

    def fn(q, k, v, ct):
        def loss(q, k, v):
            out = ring_attention(q, k, v, axis_name="cp", causal=causal)
            return jnp.sum(out.astype(jnp.float32) * ct), out

        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
        return (out, *g)

    spec = P(None, None, "cp")
    mesh, f = _cp_map(fn, (spec,) * 4, (spec,) * 4)
    with mesh:
        return [np.asarray(a, np.float32) for a in f(q, k, v, ct)]


def _gathered(ranks, key, axis):
    return np.concatenate([ranks[r][key] for r in range(CP)], axis=axis)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax(cp_world, causal):
    inp, ranks = cp_world
    name = "ring_causal" if causal else "ring_full"
    want = _jax_ring(inp["q"], inp["k"], inp["v"], inp["ct"], causal)
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        got = np.concatenate([ranks[r][name][key] for r in range(CP)], axis=2)
        np.testing.assert_allclose(got, w, **TOL, err_msg=key)


def test_ring_attention_bf16_long_sequence(cp_world):
    import jax.numpy as jnp

    from apex_tpu.ops.flash_attention import mha_reference

    inp, ranks = cp_world
    q, k, v = (jnp.asarray(inp[n], jnp.bfloat16) for n in ("lq", "lk", "lv"))
    want = _jax_ring(q, k, v, jnp.zeros(LONG, jnp.float32), True)[0]
    got = np.concatenate([ranks[r]["ring_bf16"]["out"] for r in range(CP)],
                         axis=2)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    dense = np.asarray(mha_reference(*(jnp.asarray(np.asarray(
        t, np.float32)) for t in (q, k, v)), causal=True))
    np.testing.assert_allclose(got, dense, **BF16_TOL)


def test_parallel_attention_with_cp_matches_jax(cp_world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        ParallelAttention,
    )

    inp, ranks = cp_world
    x, params = jnp.asarray(inp["x"]), {"params": inp["attn"]}
    attn = ParallelAttention(hidden_size=16, num_attention_heads=4,
                             apply_rope=True, context_parallel_axis="cp")
    mesh, f = _cp_map(lambda p, x: attn.apply(p, x), (P(), P("cp")), P("cp"),
                      (1, CP), ("tp", "cp"))
    with mesh:
        want = np.asarray(f(params, x))
    dense = np.asarray(ParallelAttention(
        hidden_size=16, num_attention_heads=4, apply_rope=True).apply(
            params, x))
    got = _gathered(ranks, "attention", 0)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense, **TOL)


def test_rope_stack_with_cp_matches_jax(cp_world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )
    from apex_tpu_torch.models.convert import transformer_lm_params_from_jax

    inp, ranks = cp_world
    lm = TransformerLanguageModel(**LM, apply_rope=True,
                                  context_parallel_axis="cp")

    def fn(p, ids, ct):
        def loss(p):
            y = lm.apply({"params": p}, ids)
            return jnp.sum(y * ct), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(p)
        return y, jax.tree.map(lambda a: a[None], g)

    mesh, f = _cp_map(fn, (P(), P(None, "cp"), P("cp")), (P("cp"), P("cp")),
                      (1, CP), ("tp", "cp"))
    with mesh:
        y, g = f(inp["rope_lm"], jnp.asarray(inp["ids"]),
                 jnp.asarray(inp["lm_ct"]))
    np.testing.assert_allclose(_gathered(ranks, "rope_lm", 0), np.asarray(y),
                               **TOL)
    g = _np_tree(g)
    for r in range(CP):
        want = transformer_lm_params_from_jax(
            jax.tree.map(lambda a: a[r], g), LM["num_layers"], apply_rope=True)
        for name, got in ranks[r]["rope_lm_grads"].items():
            scale = float(want[name].abs().max())
            np.testing.assert_allclose(got, want[name].numpy(), rtol=5e-4,
                                       atol=5e-5 + 5e-5 * scale,
                                       err_msg=f"rank {r} {name}")


def test_learned_positions_default_to_local_ids_under_cp(cp_world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    inp, ranks = cp_world
    params, ids = {"params": inp["pos_lm"]}, jnp.asarray(inp["ids"])
    lm = TransformerLanguageModel(**LM, context_parallel_axis="cp")
    mesh, f = _cp_map(lambda p, ids: lm.apply(p, ids), (P(), P(None, "cp")),
                      P("cp"), (1, CP), ("tp", "cp"))
    with mesh:
        want_local = np.asarray(f(params, ids))
    dense = np.asarray(TransformerLanguageModel(**LM).apply(params, ids))
    got = _gathered(ranks, "pos_default", 0)
    np.testing.assert_allclose(got, want_local, **TOL)
    assert np.abs(got - dense).max() > 1e-2      # not the global positions
    np.testing.assert_allclose(_gathered(ranks, "pos_global", 0), dense, **TOL)


@pytest.mark.parametrize("what", ["mask", "segments", "dropout"])
def test_cp_raises(cp_world, what):
    _, ranks = cp_world
    want = {"mask": "causal masking only", "segments": "causal masking only",
            "dropout": "ring-consistent RNG"}[what]
    for r in range(CP):
        assert want in ranks[r][f"raise_{what}"]


def test_context_parallel_axis_string_raises():
    from apex_tpu_torch.transformer.context_parallel import ring_attention
    from apex_tpu_torch.transformer.testing import (
        standalone_transformer_lm as tlm,
    )

    with pytest.raises(ValueError, match="ProcessGroup"):
        tlm.ParallelAttention(16, 4, context_parallel_axis="cp", device="cpu")
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="ProcessGroup"):
        ring_attention(q, q, q, axis_name="cp")


def test_ring_attention_one_rank_is_dense_attention():
    """``axis_name=None``: one block, the triangle, no rotation."""
    import jax.numpy as jnp

    from apex_tpu.ops.flash_attention import mha_reference
    from apex_tpu_torch.transformer.context_parallel import (
        ring_attention,
        ring_self_attention,
    )

    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((2, 3, 16, 3, 8)).astype(np.float32)
    for causal in (True, False):
        want = np.asarray(mha_reference(
            *(jnp.asarray(qkv[..., i, :]) for i in range(3)), causal=causal))
        got = ring_self_attention(torch.tensor(qkv), axis_name=None,
                                  causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        t = torch.tensor(qkv)
        assert torch.equal(got, ring_attention(
            t[..., 0, :], t[..., 1, :], t[..., 2, :], axis_name=None,
            causal=causal))
