"""apex_tpu_torch.transformer.moe and the MoE language model against
apex_tpu's, on weights initialised in JAX and carried over as numpy.

- no world: ``top1_dispatch`` where capacity binds (bit for bit), the
  one-rank ``ExpertParallelMLP``'s output, load-balancing loss and the
  gradients of ``x``, ``router``, ``w_in`` and ``w_out``, a 2-layer MoE
  ``TransformerLanguageModel`` (output, one loss a layer, every gradient,
  through ``transformer_lm_params_from_jax``), and the O2 router: bf16
  weights, the product ``x @ router`` still fp32 (the router cast up).
- one gloo world of 4: expert parallelism at ep 2 (two groups of 2) and
  ep 4 at capacity factor 4.0, and at ep 4 with 1.25, where each rank's
  queues overflow, against JAX's ``shard_map`` runs on 2 and 4 virtual
  devices: each rank's output and its gradients of ``x``, ``router`` (its
  own tokens' share, as JAX leaves it), ``w_in`` and ``w_out``; the
  router's gradient after ``allreduce_expert_replicated_grads``, the sum
  of the shares on every rank; and a group of one rank equal to
  ``axis_name=None`` bit for bit.

Tolerances: fp32 ``rtol 1e-4, atol 1e-5`` (JAX's own for this module);
the O2 outputs at bf16's ``rtol 0.1, atol 0.05``.  This module imports
JAX only inside its fixtures and tests, so the spawned ranks stay
JAX-free.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.transformer.testing.distributed import run_world

E, H, FFN, T = 4, 8, 16, 16          # experts, hidden, ffn, tokens a rank
TOL = dict(rtol=1e-4, atol=1e-5)
EP_CASES = {"ep2": (2, 4.0), "ep4": (4, 4.0), "ep4_bind": (4, 1.25)}
LM = dict(num_layers=2, hidden_size=16, num_attention_heads=4, vocab_size=64,
          max_sequence_length=16)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _jax_mlp(cf, axis_name=None, **kw):
    from apex_tpu.transformer.moe import ExpertParallelMLP

    return ExpertParallelMLP(num_experts=E, hidden_size=H, ffn_hidden_size=FFN,
                             capacity_factor=cf, axis_name=axis_name, **kw)


def _ep_case(seed, ep, cf):
    """Inputs of one ep case and JAX's initial weights (the one-rank
    module's, which the ranks slice)."""
    import jax

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ep * T, H)).astype(np.float32)
    ct = rng.standard_normal((ep * T, H)).astype(np.float32)
    params = _np_tree(_jax_mlp(cf).init(jax.random.PRNGKey(seed), x))["params"]
    return dict(x=x, ct=ct, cf=cf, **params)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _port_mlp(case, group, r, ep):
    from apex_tpu_torch.transformer.moe import ExpertParallelMLP

    m = ExpertParallelMLP(E, H, FFN, case["cf"], group, device="cpu")
    le = E // ep
    with torch.no_grad():
        m.router.copy_(torch.tensor(case["router"]))
        m.w_in.copy_(torch.tensor(case["w_in"][r * le:(r + 1) * le]))
        m.w_out.copy_(torch.tensor(case["w_out"][r * le:(r + 1) * le]))
    return m


def _run_mlp(m, case, rows):
    x = torch.tensor(case["x"][rows]).requires_grad_()
    out, aux = m(x)
    ((out * torch.tensor(case["ct"][rows])).sum() + aux).backward()
    return dict(out=out.detach().numpy().copy(), aux=float(aux.detach()),
                dx=x.grad.numpy().copy(),
                **{n: getattr(m, n).grad.numpy().copy()
                   for n in ("router", "w_in", "w_out")},
                dropped=int(m.last_dropped),
                tokens_per_expert=m.last_tokens_per_expert.numpy().copy())


def _moe_world(rank, world, cases):
    import torch.distributed as dist

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    singles = [dist.new_group([r]) for r in range(world)]
    out = {}
    for name, (ep, _) in EP_CASES.items():
        group = dist.group.WORLD if ep == world else pairs[rank // 2]
        r = dist.get_rank(group)
        out[name] = _run_mlp(_port_mlp(cases[name], group, r, ep), cases[name],
                             slice(r * T, (r + 1) * T))
    # the repair: the tagged router's gradient summed over the ep group
    from apex_tpu_torch.transformer.tensor_parallel import (
        allreduce_expert_replicated_grads,
    )

    m = _port_mlp(cases["ep4"], dist.group.WORLD, rank, world)
    _run_mlp(m, cases["ep4"], slice(rank * T, (rank + 1) * T))
    allreduce_expert_replicated_grads(m, dist.group.WORLD)
    out["ep4_repaired"] = dict(
        router=m.router.grad.numpy().copy(),
        tagged=sorted(n for n, p in m.named_parameters()
                      if getattr(p, "expert_replicated", False)))
    # a group of one rank against no group, on this rank's tokens
    case = cases["ep4_bind"]
    rows = slice(rank * T, (rank + 1) * T)
    one = _run_mlp(_port_mlp(case, singles[rank], 0, 1), case, rows)
    none = _run_mlp(_port_mlp(case, None, 0, 1), case, rows)
    out["ep1_equal"] = all(np.array_equal(one[k], none[k]) for k in one)
    # a seeded init: the router the same on every rank, the experts each
    # rank's own
    from apex_tpu_torch.transformer.moe import ExpertParallelMLP

    m = ExpertParallelMLP(E, H, FFN, axis_name=dist.group.WORLD, device="cpu",
                          generator=torch.Generator().manual_seed(9))
    out["init"] = {n: p.detach().numpy().copy()
                   for n, p in m.named_parameters()}
    return out


@pytest.fixture(scope="module")
def ep_world():
    cases = {name: _ep_case(i, ep, cf)
             for i, (name, (ep, cf)) in enumerate(EP_CASES.items())}
    return cases, run_world(_moe_world, 4, args=(cases,), timeout=150)


def _jax_ep(case, ep):
    """JAX's ep run of ``case``: each device's output and the gradients
    of its token rows and its weights (stacked on a leading rank axis)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    mlp = _jax_mlp(case["cf"], axis_name="ep")
    le = E // ep
    full = {k: jnp.asarray(case[k]) for k in ("router", "w_in", "w_out")}

    def fn(x, ct, full):
        r = jax.lax.axis_index("ep")
        mine = {"router": full["router"],
                **{k: jax.lax.dynamic_slice_in_dim(full[k], r * le, le, 0)
                   for k in ("w_in", "w_out")}}

        def loss(p, x):
            out, aux = mlp.apply({"params": p}, x)
            return jnp.sum(out * ct) + aux, (out, aux)

        (_, (out, aux)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(mine, x)
        return (out, gx, aux[None], gp["router"][None], gp["w_in"][None],
                gp["w_out"][None])

    with mesh:
        res = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("ep"), P("ep"), P()),
                                out_specs=(P("ep"),) * 6, **NO_REP_CHECK))(
            jnp.asarray(case["x"]), jnp.asarray(case["ct"]), full)
    return dict(zip(("out", "dx", "aux", "router", "w_in", "w_out"),
                    (np.asarray(v) for v in res)))


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_parallel_matches_jax(ep_world, name):
    cases, ranks = ep_world
    ep, cf = EP_CASES[name]
    want = _jax_ep(cases[name], ep)
    le = E // ep
    for r in range(ep):
        got = ranks[r][name]
        rows = slice(r * T, (r + 1) * T)
        np.testing.assert_allclose(got["out"], want["out"][rows], **TOL)
        np.testing.assert_allclose(got["dx"], want["dx"][rows], **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"][r], **TOL)
        for k in ("router", "w_in", "w_out"):
            np.testing.assert_allclose(got[k], want[k][r], **TOL, err_msg=k)
        assert got["w_in"].shape == (le, H, FFN)
    dropped = [ranks[r][name]["dropped"] for r in range(ep)]
    if cf == 1.25:
        # 5 slots an expert a rank: the per-rank queues overflow
        assert sum(dropped) > 0, dropped
    else:
        assert dropped == [0] * ep


def test_expert_parallel_ep4_bound_capacity_differs_from_one_rank(ep_world):
    """Where capacity binds, ep 4 cuts each rank's queues: its drops
    differ from the one-rank module's single queue (JAX's design note)."""
    cases, ranks = ep_world
    case = cases["ep4_bind"]
    local = _port_mlp(case, None, 0, 1)
    _run_mlp(local, case, slice(None))
    assert int(local.last_dropped) != sum(ranks[r]["ep4_bind"]["dropped"]
                                          for r in range(4))


def test_router_grad_is_each_ranks_share_at_ep4(ep_world):
    """The router is replicated over the ep group and its gradient on a
    rank is that rank's tokens' share, in JAX as in the port (a trainer
    all-reduces it; ROADMAP Queue C): at cf 4.0 (no drops) the four shares
    sum to the one-rank module's gradients over each rank's tokens, and no
    rank holds that sum."""
    cases, ranks = ep_world
    case = cases["ep4"]
    whole = np.zeros_like(case["router"])
    for r in range(4):
        whole += _run_mlp(_port_mlp(case, None, 0, 1), case,
                          slice(r * T, (r + 1) * T))["router"]
    shares = [ranks[r]["ep4"]["router"] for r in range(4)]
    np.testing.assert_allclose(sum(shares), whole, **TOL)
    for share in shares:
        assert np.abs(share - whole).max() > 1e-3


def test_router_grad_repair_gives_every_rank_the_sum_at_ep4(ep_world):
    """``allreduce_expert_replicated_grads`` over the ep group of 4: the
    router (the one tagged parameter) holds on every rank the sum of the
    four shares of the test above, bit for bit the same on each rank;
    with nothing tagged it calls no collective (here, outside any
    world, one would raise)."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        allreduce_expert_replicated_grads,
    )

    _, ranks = ep_world
    shares = [ranks[r]["ep4"]["router"] for r in range(4)]
    repaired = [ranks[r]["ep4_repaired"] for r in range(4)]
    for r in range(4):
        assert repaired[r]["tagged"] == ["router"]
        np.testing.assert_allclose(repaired[r]["router"], sum(shares), **TOL)
        np.testing.assert_array_equal(repaired[r]["router"],
                                      repaired[0]["router"])
    lin = torch.nn.Linear(2, 2)
    lin(torch.ones(1, 2)).sum().backward()
    allreduce_expert_replicated_grads(lin, None)


def test_ep_group_of_one_equals_no_group_bit_for_bit(ep_world):
    _, ranks = ep_world
    assert all(ranks[r]["ep1_equal"] for r in range(4))


def test_seeded_init_shares_the_router_and_splits_the_experts(ep_world):
    _, ranks = ep_world
    inits = [ranks[r]["init"] for r in range(4)]
    for r in range(1, 4):
        np.testing.assert_array_equal(inits[r]["router"], inits[0]["router"])
        assert not np.array_equal(inits[r]["w_in"], inits[0]["w_in"])
    assert inits[0]["w_in"].shape == (1, H, FFN)


def test_axis_name_string_raises():
    from apex_tpu_torch.transformer.moe import ExpertParallelMLP

    with pytest.raises(ValueError, match="ProcessGroup"):
        ExpertParallelMLP(E, H, FFN, axis_name="ep", device="cpu")


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def test_top1_dispatch_matches_jax_where_capacity_binds():
    import jax.numpy as jnp

    from apex_tpu.transformer.moe import top1_dispatch as jax_dispatch
    from apex_tpu_torch.transformer.moe import top1_dispatch

    rng = np.random.default_rng(3)
    logits = np.concatenate([
        np.array([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0], [0.0, 2.0]]),
        rng.standard_normal((4, 2))]).astype(np.float32)
    for cap in (1, 2, 3):
        want = [np.asarray(v) for v in jax_dispatch(jnp.asarray(logits), cap)]
        got = [v.numpy() for v in top1_dispatch(torch.tensor(logits), cap)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    d = top1_dispatch(torch.tensor(logits), 2)[0].numpy()
    # tokens 0 and 1 fill expert 0's two slots; token 2 is dropped
    assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1 and d[2].sum() == 0
    assert d[3, 1, 0] == 1


def test_local_mlp_forward_aux_and_grads_match_jax():
    import jax
    import jax.numpy as jnp

    case = _ep_case(7, 2, 2.0)           # 32 tokens on one rank
    mlp = _jax_mlp(2.0)
    p = {k: jnp.asarray(case[k]) for k in ("router", "w_in", "w_out")}
    x, ct = jnp.asarray(case["x"]), jnp.asarray(case["ct"])

    def loss(p, x):
        out, aux = mlp.apply({"params": p}, x)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, x)
    got = _run_mlp(_port_mlp(case, None, 0, 1), case, slice(None))
    np.testing.assert_allclose(got["out"], np.asarray(out), **TOL)
    np.testing.assert_allclose(got["aux"], float(aux), **TOL)
    np.testing.assert_allclose(got["dx"], np.asarray(gx), **TOL)
    for k in ("router", "w_in", "w_out"):
        np.testing.assert_allclose(got[k], np.asarray(gp[k]), **TOL,
                                   err_msg=k)
    assert np.abs(got["router"]).max() > 0          # the router learns
    assert got["tokens_per_expert"].sum() == 32


def _lm_inputs():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, LM["vocab_size"], (2, 16)).astype(np.int32)
    ct = rng.standard_normal((16, 2, LM["hidden_size"])).astype(np.float32)
    return ids, ct


def test_moe_language_model_matches_jax():
    """A 2-layer MoE TransformerLanguageModel: the hidden states, one
    load-balancing loss a layer, and every gradient of ``sum(y * ct) +
    sum(aux)``, on JAX's weights through transformer_lm_params_from_jax."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel as JaxLM,
    )
    from apex_tpu_torch.models.convert import transformer_lm_params_from_jax
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    ids, ct = _lm_inputs()
    jm = JaxLM(**LM, moe_num_experts=E)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]

    def loss(p):
        y, col = jm.apply({"params": p}, jnp.asarray(ids),
                          mutable=["moe_losses"])
        auxes = jax.tree.leaves(col["moe_losses"])
        return jnp.sum(y * ct) + sum(auxes), (y, auxes)

    (_, (y, auxes)), g = jax.value_and_grad(loss, has_aux=True)(params)
    model = TransformerLanguageModel(**LM, moe_num_experts=E, device="cpu")
    model.load_state_dict(transformer_lm_params_from_jax(
        _np_tree(params), LM["num_layers"], moe=True))
    out = model(torch.from_numpy(ids).long())
    losses = model.moe_losses()
    assert len(losses) == len(auxes) == 2
    ((out * torch.from_numpy(ct)).sum() + sum(losses)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose([float(a.detach()) for a in losses],
                               [float(a) for a in auxes], **TOL)
    want = transformer_lm_params_from_jax(_np_tree(g), LM["num_layers"],
                                          moe=True)
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5 + 1e-5 * scale,
                                   err_msg=name)
    assert float(model.transformer.layers[0].mlp.experts.w_in.grad.abs()
                 .max()) > 0


def test_moe_with_sequence_parallelism_raises():
    from apex_tpu_torch.transformer.testing import (
        standalone_transformer_lm as tlm,
    )

    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        tlm.ParallelTransformerLayer(16, 4, sequence_parallel_enabled=True,
                                     moe_num_experts=E, device="cpu")


def test_o2_router_product_stays_fp32():
    """Under O2 the router is bf16 (JAX's policy casts it by name, the
    port's ``o2_cast`` by rank); ``x @ router`` still runs in fp32, the
    router cast up: the routing equals the fp32 product's on the bf16
    values, and the output is JAX's within bf16's tolerance."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.amp.policy import get_policy
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.transformer.moe import top1_dispatch

    case = _ep_case(5, 2, 4.0)
    p32 = {k: jnp.asarray(case[k]) for k in ("router", "w_in", "w_out")}
    p16 = get_policy("O2").cast_params(p32)
    assert p16["router"].dtype == jnp.bfloat16
    x16 = jnp.asarray(case["x"], jnp.bfloat16)
    out, aux = _jax_mlp(4.0).apply({"params": p16}, x16)
    m = o2_cast(_port_mlp(case, None, 0, 1))
    assert m.router.dtype == torch.bfloat16 and m.w_in.dtype == torch.bfloat16
    x = torch.tensor(np.asarray(x16.astype(jnp.float32))).to(torch.bfloat16)
    got, got_aux = m(x)
    assert got.dtype == torch.bfloat16
    # the routing and its loss come from the fp32 product: JAX's to fp32
    # rounding; the product with the input cast down lands elsewhere
    np.testing.assert_allclose(float(got_aux.detach()), float(aux), rtol=1e-5)
    cap = m.capacity(x.shape[0])
    up = top1_dispatch(x.float() @ m.router.float(), cap)[2]
    down = top1_dispatch((x @ m.router).float(), cap)[2]
    assert float(up.detach()) == float(got_aux.detach())
    assert abs(float(down.detach()) - float(aux)) > 1e-5 * float(aux)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               rtol=0.1, atol=0.05)


def test_lm_params_from_jax_slices_experts_by_ep_rank():
    """``transformer_lm_params_from_jax(ep=, ep_rank=)``: each rank's
    ``w_in`` / ``w_out`` are its ``e / ep`` experts in order (the slice
    JAX's ep test cuts with ``dynamic_slice_in_dim``), everything else
    whole; a split that does not divide raises."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel as JaxLM,
    )
    from apex_tpu_torch.models.convert import transformer_lm_params_from_jax

    ids, _ = _lm_inputs()
    params = _np_tree(JaxLM(**LM, moe_num_experts=E).init(
        jax.random.PRNGKey(2), jnp.asarray(ids))["params"])
    whole = transformer_lm_params_from_jax(params, 2, moe=True)
    for ep in (2, 4):
        le = E // ep
        for r in range(ep):
            part = transformer_lm_params_from_jax(params, 2, moe=True,
                                                  ep_rank=r, ep=ep)
            assert set(part) == set(whole)
            for name, t in part.items():
                want = (whole[name][r * le:(r + 1) * le]
                        if name.endswith(("experts.w_in", "experts.w_out"))
                        else whole[name])
                assert torch.equal(t, want), name
    assert tuple(whole["transformer.layers.1.mlp.experts.w_in"].shape) == (
        E, LM["hidden_size"], 4 * LM["hidden_size"])
    with pytest.raises(ValueError, match="do not split"):
        transformer_lm_params_from_jax(params, 2, moe=True, ep=3)
