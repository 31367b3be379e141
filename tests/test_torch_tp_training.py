"""Tensor-parallel training: the port's models and trainer in gloo worlds of
spawned ranks against the JAX package's ``shard_map`` runs.

- **dp 2 x tp 2** (world 4): three steps of the port's ``train_step``
  (tp region, dp gradient average, ``FusedAdam``) against the 2-D
  ``train_step`` of ``examples/llama/pretrain.py:126-136`` under
  ``shard_map`` over ``Mesh(("dp", "tp"))`` of four virtual CPU devices,
  with that file's ``param_specs`` / ``opt_specs`` and the Pallas kernels
  in interpret mode, from one JAX init.  The losses at 1e-5; each rank's
  parameter shard and both moments against JAX's trees sliced by its tp
  rank, by the per-element scheme of
  ``tests/test_torch_llama.py::test_three_step_trajectory_matches_jax``.
  The same world runs ``llama_pretrain.main(["--tp", "2", ...])``.
- **GPT at tp 2** (the repaired stack: heads / tp, the vocab-parallel
  loss) and **Llama and GPT under sequence parallelism at tp 2** (world
  2): the mean loss and every rank's gradient of every parameter against
  JAX's, rank by rank, at the tolerances of ``tests/test_torch_gpt.py``:
  loss 1e-5, each gradient within ``1e-4 max|g| + 1e-4 |g|``.
- Under sequence parallelism the reference leaves some gradients of
  replicated parameters as per-rank partial sums (the Llama RMSNorm
  scales, the GPT row-parallel biases); the port computes what JAX
  computes, and a test shows the partial sums against the whole model.

This module imports JAX only in its fixtures and tests, so the spawned
ranks stay JAX-free.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    gpt_params_from_jax,
    llama_params_from_jax,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.testing import GPTModel
from apex_tpu_torch.transformer.testing.distributed import run_world

ROOT = Path(__file__).resolve().parent.parent
# GQA with one kv head a rank at tp 2; head dim 64 so that JAX runs its
# Pallas flash kernels (interpret mode) in the trajectory
CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
SP_CFG = dict(CFG, num_hidden_layers=1)
GCFG = dict(num_layers=1, hidden_size=128, num_attention_heads=2,
            vocab_size=256, max_sequence_length=64)
B, S = 4, 64
LR, STEPS = 1e-3, 3


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)


def _np_grads(model):
    return {n: p.grad.detach().numpy().copy()
            for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _dp_tp_world(rank, world, tree, ids):
    """dp 2 x tp 2: three steps of train_step from the JAX init, then the
    driver's own run."""
    from apex_tpu_torch.examples import llama_pretrain

    cfg = LlamaConfig(**CFG)
    tps.initialize_model_parallel(2)
    group, dp_group = (tps.get_tensor_model_parallel_group(),
                       tps.get_data_parallel_group())
    tp_rank = tps.get_tensor_model_parallel_rank()
    with ttp.tensor_parallel_region(group):
        model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(tree, cfg, tp_rank=tp_rank,
                                                tp_size=2))
    opt = FusedAdam(model.parameters(), lr=LR)
    x = ttp.broadcast_data(["ids"], {"ids": ttp.tp_replicated_rows(
        torch.from_numpy(ids))}, torch.int64)["ids"]
    with ttp.tensor_parallel_region(group):
        losses = [float(llama_pretrain.train_step(model, opt, x,
                                                  dp_group=dp_group))
                  for _ in range(STEPS)]
    out = dict(losses=losses, tp_rank=tp_rank,
               dp_rank=tps.get_data_parallel_rank(), rows=x.numpy(),
               params={n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
               exp_avg={n: opt.state[p]["exp_avg"].numpy().copy()
                        for n, p in model.named_parameters()},
               exp_avg_sq={n: opt.state[p]["exp_avg_sq"].numpy().copy()
                           for n, p in model.named_parameters()})
    tps.destroy_model_parallel()
    argv = ["--device", "cpu", "--tp", "2", "--layers", "2", "--steps", "3",
            "--seq", "32", "--batch", "4", "--vocab", "128"]
    out["driver"] = llama_pretrain.main(argv)
    out["driver_o2"] = llama_pretrain.main(argv + ["--o2", "--lr", "1e-2"])
    out["driver_amp"] = llama_pretrain.main(argv + ["--amp", "--lr", "1e-3"])
    return out


def _loss_and_grads(model, ids, labels):
    model.zero_grad(set_to_none=True)
    loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels)).mean()
    loss.backward()
    return float(loss.detach()), _np_grads(model)


def _tp2_world(rank, world, gpt_tree, llama_tree):
    """GPT at tp 2 without and with sequence parallelism, Llama with it:
    each rank's loss and gradients; and the same at world 1 in a
    tp-1-sized model of the whole weights, for the partial-sum test."""
    group = tps.serving_group(2)
    gids, glabels = _batch(11, GCFG["vocab_size"])
    lids, llabels = _batch(12, CFG["vocab_size"])
    out = {}
    state = gpt_params_from_jax(gpt_tree, GCFG["num_layers"], tp_rank=rank,
                                tp_size=2)
    for sp in (False, True):
        with ttp.tensor_parallel_region(group):
            gpt = GPTModel(**GCFG, sequence_parallel_enabled=sp, device="cpu")
            gpt.load_state_dict(state)
            out[f"gpt_sp{int(sp)}"] = _loss_and_grads(gpt, gids, glabels)
    # the repair: the tagged gradients summed over the group
    ttp.allreduce_sequence_parallel_grads(gpt, group)
    out["gpt_sp1_repaired"] = _np_grads(gpt)
    cfg = LlamaConfig(**SP_CFG)
    with ttp.tensor_parallel_region(group):
        llama = LlamaForCausalLM(cfg, device="cpu",
                                 sequence_parallel_enabled=True)
        llama.load_state_dict(llama_params_from_jax(
            llama_tree, cfg, tp_rank=rank, tp_size=2))
        out["llama_sp1"] = _loss_and_grads(llama, lids, llabels)
    ttp.allreduce_sequence_parallel_grads(llama, group)
    out["llama_sp1_repaired"] = _np_grads(llama)
    out["tagged"] = sorted(
        [f"llama.{n}" for n, p in llama.named_parameters()
         if getattr(p, "sequence_parallel", False)]
        + [f"gpt.{n}" for n, p in gpt.named_parameters()
           if getattr(p, "sequence_parallel", False)])
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _pretrain_module():
    """``examples/llama/pretrain.py`` (for its ``param_specs`` and
    ``opt_specs``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_llama_pretrain", ROOT / "examples" / "llama" / "pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from apex_tpu.models import LlamaConfig as JCfg
    from apex_tpu.models import LlamaForCausalLM as JLlama
    from apex_tpu.transformer.testing import GPTModel as JGPT

    class NS:
        pass

    ns = NS()
    ns.jax, ns.jnp = jax, jnp
    ns.llama = JLlama(JCfg(**CFG))
    ns.llama_params = ns.llama.init(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 4), jnp.int32))
    ns.llama_tree = jax.tree.map(np.asarray, ns.llama_params)
    ns.sp_llama = JLlama(JCfg(**SP_CFG), sequence_parallel_enabled=True)
    ns.sp_llama_params = JLlama(JCfg(**SP_CFG)).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 4), jnp.int32))
    ns.sp_llama_tree = jax.tree.map(np.asarray, ns.sp_llama_params)
    ns.gpt_params = JGPT(**GCFG).init(jax.random.PRNGKey(5),
                                      jnp.zeros((1, 8), jnp.int32))
    ns.gpt_tree = jax.tree.map(np.asarray, ns.gpt_params)
    ns.JGPT = JGPT
    return ns


def _gpt_specs(params):
    """The JAX GPT's tp layout as partition specs (flax ``[in, out]``)."""
    from jax.sharding import PartitionSpec as P
    import jax

    def spec(path, leaf):
        del leaf
        name = "/".join(str(p.key) for p in path if hasattr(p, "key"))
        if "word_embeddings" in name:
            return P("tp", None)
        if "query_key_value" in name or "dense_h_to_4h" in name:
            return P(None, "tp") if name.endswith("kernel") else P("tp")
        if name.endswith(("dense/kernel", "dense_4h_to_h/kernel")):
            return P("tp", None)
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


def _jax_rank_grads(jx, model, params, pspecs, ids, labels):
    """Mean loss and each tp rank's local gradients of ``model`` at tp 2
    under ``shard_map`` (the gradients stacked on a leading rank axis, so
    a replicated parameter's per-rank values show)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    jax, jnp = jx.jax, jx.jnp
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))

    def run(p, i, l):
        loss, g = jax.value_and_grad(
            lambda q: model.apply(q, i, labels=l).mean())(p)
        return loss, jax.tree.map(lambda a: a[None], g)

    gspecs = jax.tree.map(lambda _: P("tp"), params)
    loss, grads = jax.jit(shard_map(
        run, mesh=mesh, in_specs=(pspecs, P(), P()),
        out_specs=(P(), gspecs), **NO_REP_CHECK))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(labels, jnp.int32))
    grads = jax.tree.map(np.asarray, grads)
    return float(loss), [jax.tree.map(lambda a: a[r], grads) for r in (0, 1)]


def _assert_grads(ours, ref, what):
    assert set(ours) == set(ref), what
    for name, g in ours.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max() + 1e-30,
                                   err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def dp_tp(jx):
    ids, _ = _batch(7, CFG["vocab_size"])
    return ids, run_world(_dp_tp_world, 4, args=(jx.llama_tree, ids),
                          timeout=150)


@pytest.fixture(scope="module")
def tp2(jx):
    return run_world(_tp2_world, 2, args=(jx.gpt_tree, jx.sp_llama_tree),
                     timeout=150)


@pytest.fixture(scope="module")
def jax_trajectory(jx, dp_tp):
    """The JAX 2-D step, three times from the same init, over a 2 x 2
    mesh: the losses, the first step's (dp-averaged) gradients, the
    parameters and FusedAdam's moments after the steps."""
    from jax.sharding import Mesh, PartitionSpec as P

    from apex_tpu.optimizers import FusedAdam as JFusedAdam
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    jax, jnp = jx.jax, jx.jnp
    ids, _ = dp_tp
    pre = _pretrain_module()
    model, params = jx.llama, jx.llama_params
    opt = JFusedAdam(lr=LR)
    state = opt.init(params)
    pspecs = pre.param_specs(params)
    ospecs = pre.opt_specs(pspecs)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))

    def train_step(params, opt_state, ids):
        labels = jnp.roll(ids, -1, axis=1)
        loss, grads = jax.value_and_grad(
            lambda p: model.apply(p, ids, labels=labels).mean())(params)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "dp"), grads)
        loss = jax.lax.pmean(loss, "dp")
        new_params, new_state = opt.step(grads, params, opt_state)
        return new_params, new_state, loss, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_KERNELS", "interpret")
        step = jax.jit(shard_map(
            train_step, mesh=mesh, in_specs=(pspecs, ospecs, P("dp")),
            out_specs=(pspecs, ospecs, P(), pspecs), **NO_REP_CHECK))
        x = jnp.asarray(ids, jnp.int32)
        losses, g1 = [], None
        for _ in range(STEPS):
            params, state, loss, grads = step(params, state, x)
            g1 = grads if g1 is None else g1
            losses.append(float(loss))
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(losses=losses, g1=tree(g1), params=tree(params),
                m=tree(state[0].exp_avg), v=tree(state[0].exp_avg_sq))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_dp2_tp2_three_steps_match_jax_shard_map(dp_tp, jax_trajectory):
    """Losses at 1e-5; each element of each rank's parameter shard within
    1e-6 + 3 lr ng / (|g1| + ng), ng = 1e-4 max|g1| (the gradient
    tolerance, carried through Adam's g / |g|), and the moments at the
    scheme of the one-card trajectory test."""
    ids, ranks = dp_tp
    ref = jax_trajectory
    cfg = LlamaConfig(**CFG)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], atol=1e-5,
                                   rtol=0)
        assert r["losses"][-1] < r["losses"][0]
        dp_rows = ids[2 * r["dp_rank"]:2 * r["dp_rank"] + 2]
        np.testing.assert_array_equal(r["rows"], dp_rows)
        conv = lambda t: llama_params_from_jax(  # noqa: E731
            t, cfg, tp_rank=r["tp_rank"], tp_size=2)
        ref_p, ref_m, ref_v, g1 = (conv(ref[k]) for k in
                                   ("params", "m", "v", "g1"))
        assert set(r["params"]) == set(ref_p)
        for name, p in r["params"].items():
            g = np.abs(g1[name].numpy())
            ng = 1e-4 * g.max()
            tol = 1e-6 + STEPS * LR * ng / (g + ng + 1e-30)
            assert (np.abs(p - ref_p[name].numpy()) <= tol).all(), name
            np.testing.assert_allclose(r["exp_avg"][name], ref_m[name].numpy(),
                                       rtol=1e-4, atol=1e-4 * g.max(),
                                       err_msg=name)
            np.testing.assert_allclose(r["exp_avg_sq"][name],
                                       ref_v[name].numpy(), rtol=1e-3,
                                       atol=1e-4 * g.max() ** 2, err_msg=name)


def test_dp_replicas_hold_equal_shards(dp_tp):
    """The two dp replicas of each tp rank end bit for bit alike."""
    _, ranks = dp_tp
    for a, b in ((0, 2), (1, 3)):
        for name, p in ranks[a]["params"].items():
            np.testing.assert_array_equal(p, ranks[b]["params"][name])


def test_pretrain_driver_tp2_in_a_world_loss_falls(dp_tp):
    """``llama_pretrain.main(["--tp", "2", ...])`` on each rank of a
    world of 4 (dp 2): fp32, ``--o2`` and ``--amp`` (fp16 under
    ``GradScaler``) each train with a finite, falling loss (main raises
    otherwise) that every rank reports alike."""
    _, ranks = dp_tp
    for key in ("driver", "driver_o2", "driver_amp"):
        vals = [r[key] for r in ranks]
        assert all(np.isfinite(vals)) and len(set(vals)) == 1, (key, vals)


def test_gpt_tp2_loss_and_every_grad_match_jax(jx, tp2):
    """The repaired GPT at tp 2 (heads / tp a rank, the vocab-parallel
    loss over the rank's vocab shard): the mean loss and each rank's
    gradient of each of its parameters against JAX's under shard_map."""
    ids, labels = _batch(11, GCFG["vocab_size"])
    model = jx.JGPT(**GCFG)
    loss, grads = _jax_rank_grads(jx, model, jx.gpt_params,
                                  _gpt_specs(jx.gpt_params), ids, labels)
    for r in (0, 1):
        ours_loss, ours = tp2[r]["gpt_sp0"]
        assert abs(ours_loss - loss) < 1e-5
        _assert_grads(ours, gpt_params_from_jax(grads[r], GCFG["num_layers"]),
                      f"GPT tp 2 rank {r}")


def test_gpt_sp_tp2_loss_and_every_grad_match_jax(jx, tp2):
    """GPT under sequence parallelism at tp 2 against JAX's, rank by
    rank (the embedding scattered, each column linear gathering and each
    row linear reduce-scattering the sequence, the LayerNorms' gradients
    summed over the group)."""
    ids, labels = _batch(11, GCFG["vocab_size"])
    model = jx.JGPT(**GCFG, sequence_parallel_enabled=True)
    loss, grads = _jax_rank_grads(jx, model, jx.gpt_params,
                                  _gpt_specs(jx.gpt_params), ids, labels)
    for r in (0, 1):
        ours_loss, ours = tp2[r]["gpt_sp1"]
        assert abs(ours_loss - loss) < 1e-5
        _assert_grads(ours, gpt_params_from_jax(grads[r], GCFG["num_layers"]),
                      f"GPT SP rank {r}")
    # same loss as without sequence parallelism
    assert abs(tp2[0]["gpt_sp1"][0] - tp2[0]["gpt_sp0"][0]) < 1e-5


def test_llama_sp_tp2_loss_and_every_grad_match_jax(jx, tp2):
    """Llama under sequence parallelism at tp 2 against JAX's, rank by
    rank, every gradient, the RMSNorm scales' included."""
    pre = _pretrain_module()
    ids, labels = _batch(12, CFG["vocab_size"])
    cfg = LlamaConfig(**SP_CFG)
    loss, grads = _jax_rank_grads(jx, jx.sp_llama, jx.sp_llama_params,
                                  pre.param_specs(jx.sp_llama_params), ids,
                                  labels)
    for r in (0, 1):
        ours_loss, ours = tp2[r]["llama_sp1"]
        assert abs(ours_loss - loss) < 1e-5
        _assert_grads(ours, llama_params_from_jax(grads[r], cfg),
                      f"Llama SP rank {r}")


def test_sp_replicated_grads_partial_in_the_reference(jx, tp2):
    """Under sequence parallelism some replicated parameters' gradients
    come out as each rank's partial sum, in JAX and so in the port (held
    equal above): the Llama RMSNorm scales (``FusedRMSNorm`` has no tp
    reduction) and the GPT row-parallel biases (added after the
    reduce-scatter).  Their sum over the ranks is the whole model's
    gradient at world 1, and no rank holds it alone; the GPT LayerNorm
    parameters, passed through ``copy_to_tensor_model_parallel_region``,
    hold it on every rank.  The port tags exactly those parameters
    ``sequence_parallel``, and after its
    ``allreduce_sequence_parallel_grads`` every rank holds the world-1
    gradient of each (a deliberate difference from JAX), the rest
    untouched."""
    cfg = LlamaConfig(**SP_CFG)
    whole = LlamaForCausalLM(cfg, device="cpu")
    whole.load_state_dict(llama_params_from_jax(jx.sp_llama_tree, cfg))
    _, full = _loss_and_grads(whole, *_batch(12, CFG["vocab_size"]))
    norms = [n for n in full if n.endswith("layernorm.scale")
             or n == "norm.scale"]
    assert len(norms) == 3
    for n in norms:
        parts = [tp2[r]["llama_sp1"][1][n] for r in (0, 1)]
        np.testing.assert_allclose(parts[0] + parts[1], full[n], rtol=1e-4,
                                   atol=1e-4 * np.abs(full[n]).max())
        assert not np.allclose(parts[0], full[n], rtol=1e-2, atol=0), n

    gpt = GPTModel(**GCFG, device="cpu")
    gpt.load_state_dict(gpt_params_from_jax(jx.gpt_tree, GCFG["num_layers"]))
    _, gfull = _loss_and_grads(gpt, *_batch(11, GCFG["vocab_size"]))
    row_bias = [n for n in gfull if n.endswith(("dense.bias",
                                                "dense_4h_to_h.bias"))]
    assert len(row_bias) == 2
    for n in row_bias:
        parts = [tp2[r]["gpt_sp1"][1][n] for r in (0, 1)]
        np.testing.assert_allclose(parts[0] + parts[1], gfull[n], rtol=1e-4,
                                   atol=1e-4 * np.abs(gfull[n]).max())
        assert not np.allclose(parts[0], gfull[n], rtol=1e-2, atol=0), n
    for n in [n for n in gfull if "layernorm" in n]:
        for r in (0, 1):
            np.testing.assert_allclose(
                tp2[r]["gpt_sp1"][1][n], gfull[n], rtol=1e-4,
                atol=1e-4 * np.abs(gfull[n]).max(), err_msg=n)

    # the port's repair: every rank holds the world-1 gradient
    assert tp2[0]["tagged"] == tp2[1]["tagged"] == sorted(
        [f"llama.{n}" for n in norms] + [f"gpt.{n}" for n in row_bias])
    for key, names, ref in (("llama_sp1", norms, full),
                            ("gpt_sp1", row_bias, gfull)):
        for r in (0, 1):
            fixed = tp2[r][f"{key}_repaired"]
            for n in names:
                np.testing.assert_allclose(
                    fixed[n], ref[n], rtol=1e-4,
                    atol=1e-4 * np.abs(ref[n]).max(), err_msg=f"{key} {n}")
            for n, g in tp2[r][key][1].items():
                if n not in names:
                    np.testing.assert_array_equal(fixed[n], g, err_msg=n)


def test_gpt_converter_slices_each_rank():
    """``gpt_params_from_jax(tp_rank=, tp_size=)``: column weights and
    biases on ``[out]``, row weights on ``[in]``, the embedding on its
    rows; the two ranks' slices put back together give the whole."""
    rng = np.random.default_rng(0)
    h, v, f = 8, 16, 32
    layer = {
        "input_layernorm": {"scale": rng.random(h), "bias": rng.random(h)},
        "post_attention_layernorm": {"scale": rng.random(h),
                                     "bias": rng.random(h)},
        "self_attention": {
            "query_key_value": {"kernel": rng.random((h, 3 * h)),
                                "bias": rng.random(3 * h)},
            "dense": {"kernel": rng.random((h, h)), "bias": rng.random(h)}},
        "mlp": {"dense_h_to_4h": {"kernel": rng.random((h, f)),
                                  "bias": rng.random(f)},
                "dense_4h_to_h": {"kernel": rng.random((f, h)),
                                  "bias": rng.random(h)}}}
    tree = {"language_model": {
        "embedding": {"word_embeddings": {"embedding": rng.random((v, h))},
                      "position_embeddings": rng.random((4, h))},
        "transformer": {"layer_0": layer, "final_layernorm": {
            "scale": rng.random(h), "bias": rng.random(h)}}}}
    whole = gpt_params_from_jax(tree, 1)
    parts = [gpt_params_from_jax(tree, 1, tp_rank=r, tp_size=2)
             for r in (0, 1)]
    dims = {}
    for name, t in whole.items():
        a, b = parts[0][name], parts[1][name]
        if a.shape == t.shape:
            assert torch.equal(a, t) and torch.equal(b, t), name
            continue
        dim = next(d for d in range(t.dim()) if a.shape[d] != t.shape[d])
        dims[name.split("layers.0.")[-1]] = dim
        assert torch.equal(torch.cat([a, b], dim), t), name
    assert dims == {
        "language_model.embedding.word_embeddings.weight": 0,
        "self_attention.query_key_value.weight": 0,
        "self_attention.query_key_value.bias": 0,
        "self_attention.dense.weight": 1,
        "mlp.dense_h_to_4h.weight": 0, "mlp.dense_h_to_4h.bias": 0,
        "mlp.dense_4h_to_h.weight": 1}
