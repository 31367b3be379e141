"""Shared pieces of the Megatron GPT driver tests
(``tests/test_torch_megatron_gpt.py``): the flags, the rank function the
gloo world runs, and the JAX driver's runs it is held to.  Importing this
module imports no JAX: the spawned ranks import it to find their
function.
"""

import importlib.util
from pathlib import Path

import numpy as np
import torch

from apex_tpu_torch.examples import megatron_gpt_pretrain as mgp
from apex_tpu_torch.models.convert import (
    gpt_pipeline_params_from_jax,
    shard_gpt_state_dict,
)
from apex_tpu_torch.transformer.testing.commons import GPTPipeConfig

REPO = Path(__file__).resolve().parent.parent
LAYERS, HIDDEN, HEADS, SEQ, VOCAB, MB, ITERS = 2, 64, 4, 32, 128, 2, 3
# the JAX driver's flags; n_micro = global batch / (MB * dp) = 2
FLAGS = ["--num-layers", str(LAYERS), "--hidden-size", str(HIDDEN),
         "--num-attention-heads", str(HEADS), "--seq-length", str(SEQ),
         "--max-position-embeddings", str(SEQ), "--vocab-size", str(VOCAB),
         "--micro-batch-size", str(MB), "--lr", "1e-3",
         "--train-iters", str(ITERS)]


def flags(dp, pp, tp):
    return FLAGS + ["--global-batch-size", str(MB * dp * 2),
                    "--pipeline-model-parallel-size", str(pp),
                    "--tensor-model-parallel-size", str(tp)]


def cfg_of(pp):
    return GPTPipeConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                         num_attention_heads=HEADS,
                         layers_per_stage=LAYERS // pp,
                         max_sequence_length=SEQ)


def coords(rank, dp, pp, tp):
    """(p, d, t) of a global rank (``parallel_state.rank_grid``'s order)."""
    return rank // (dp * tp), rank // tp % dp, rank % tp


def coords_to_rank(p, d, t, dp, tp):
    return p * dp * tp + d * tp + t


def whole_tree(trees):
    """One JAX tree of the whole model from JAX's pp-rank trees ``{p: tree}``
    (dp 0, tp 0): the embedding of stage 0, each stage's layers in order,
    the head of the last."""
    pp = len(trees)
    layers = {}
    for p in range(pp):
        block = trees[p]["block"]["params"]
        n = len(block)
        layers.update({f"layer_{p * n + i}": block[f"layer_{i}"]
                       for i in range(n)})
    return {"embed": trees[0]["embed"], "block": {"params": layers},
            "head": trees[pp - 1]["head"]}


def to_np(named):
    return {k: v.detach().float().numpy().copy() for k, v in named}


def run(argv, state):
    """``megatron_gpt_pretrain.main`` from ``state``: the losses, the
    parameters after (a list, one a chunk, under a virtual pipeline), and
    each iteration's copy of the word embeddings this rank holds (None on
    a rank without one)."""
    losses, tied = [], []

    def record(it, loss, model):
        losses.append(loss)
        chunks = model if isinstance(model, list) else [model]
        if it == 0:
            record.grads = [{n: q.grad.detach().float().numpy().copy()
                             for n, q in c.named_parameters()}
                            for c in chunks]
        holders = [m for c in chunks for m in (c.first, c.last)
                   if m is not None]
        tied.append(holders[0].word_embeddings.weight.detach().float().numpy()
                    .copy()
                    if holders else None)
        record.model = model

    last = mgp.main(argv, init_state=state, on_iteration=record)
    assert last == losses[-1]
    model = record.model
    if isinstance(model, list):
        params = [to_np(c.named_parameters()) for c in model]
    else:
        params = to_np(model.named_parameters())
    grads = record.grads if isinstance(model, list) else record.grads[0]
    first = model[0] if isinstance(model, list) else model
    return dict(losses=losses, tied=tied, params=params, grads=grads,
                names=sorted(n for n, _ in first.named_parameters()),
                dtypes={n: q.dtype for n, q in first.named_parameters()})


# 4 layers, one a virtual stage: 2 chunks a rank at pp 2
VPP_LAYERS = 4


def vpp_flags(dp, pp, tp):
    argv = flags(dp, pp, tp)
    argv[argv.index("--num-layers") + 1] = str(VPP_LAYERS)
    return argv + ["--num-layers-per-virtual-pipeline-stage", "1"]


def world4(rank, world, states_dp2, states_tp2):
    """A rank of the gloo world of 4: dp 2 x pp 2, then pp 2 x tp 2 (with
    sequence parallelism), each from JAX's weights; then pp 2 x tp 2 with
    2 virtual chunks a rank from the seeded init."""
    dev = ["--device", "cpu"]
    return dict(dp2=run(dev + flags(2, 2, 1), states_dp2[rank]),
                tp2=run(dev + flags(1, 2, 2), states_tp2[rank]),
                vpp=run(dev + vpp_flags(1, 2, 2), None))


def chunk_of(whole, stage, stages):
    """Global stage ``stage``'s one-layer chunk of a one-stage numpy
    ``state_dict`` (the seeded init's names)."""
    out = {k.replace(f"stage.layers.{stage}.", "stage.layers.0."): v
           for k, v in whole.items()
           if k.startswith(f"stage.layers.{stage}.")}
    if stage == 0:
        out.update({k: v for k, v in whole.items() if k.startswith("first.")})
    if stage == stages - 1:
        out.update({k: v for k, v in whole.items()
                    if k.startswith("last.")})
        out["last.word_embeddings.weight"] = whole[
            "first.word_embeddings.weight"]
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def load_jax_driver():
    """The repo's ``examples/gpt/pretrain.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_gpt_pretrain_example", REPO / "examples" / "gpt" / "pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorder:
    """``jax`` for the JAX driver, recording every jitted call's output."""

    def __init__(self, real):
        self._real, self.outputs = real, []

    def __getattr__(self, name):
        return getattr(self._real, name)

    def jit(self, fn, **kw):
        compiled = self._real.jit(fn, **kw)

        def call(*a, **k):
            out = compiled(*a, **k)
            self.outputs.append(out)
            return out
        return call


def _per_device(tree):
    """``{device id: numpy tree}``: each device's own buffer of every leaf
    (the driver's ``out_specs=P()`` without the replication check leaves
    per-device values)."""
    import jax

    leaves, treedef = jax.tree.flatten(tree)
    by_dev = [{s.device.id: np.asarray(s.data) for s in l.addressable_shards}
              for l in leaves]
    return {i: jax.tree.unflatten(treedef, [b[i] for b in by_dev])
            for i in by_dev[0]}


def jax_main(monkeypatch, dp, pp, tp, extra=()):
    """The JAX driver's ``main`` on ``dp * pp * tp`` virtual devices, with
    the flags ``extra`` added: its returned loss, each iteration's loss,
    and the initial and final parameters by ``(p, d, t)``."""
    import jax

    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing import destroy_global_vars

    mod = load_jax_driver()
    rec = _Recorder(jax)
    monkeypatch.setattr(mod, "jax", rec)
    monkeypatch.setenv("WORLD_SIZE", str(dp * pp * tp))
    try:
        final = mod.main(flags(dp, pp, tp) + list(extra))
        ids = np.vectorize(lambda d: d.id)(jps.get_mesh().devices)
    finally:
        destroy_global_vars()
        jps.destroy_model_parallel()
    init, steps = rec.outputs[0], rec.outputs[1:]
    by = {}
    for key, tree in (("params0", init[0]), ("params", steps[-1][0])):
        dev = _per_device(tree)
        by[key] = {(p, d, t): dev[int(ids[d, p, t])] for d in range(dp)
                   for p in range(pp) for t in range(tp)}
    return dict(final=final, losses=[float(s[2]) for s in steps], **by)


def port_states(jx, dp, pp, tp, *, slice_tp=None):
    """Each port rank's ``state_dict`` from a JAX run's initial weights,
    by global rank; with ``slice_tp``, JAX's tp-1 weights sliced for a tp
    world of that size."""
    cfg, out = cfg_of(pp), {}
    for rank in range(dp * pp * tp):
        p, d, t = coords(rank, dp, pp, tp)
        if slice_tp is None:
            out[rank] = gpt_pipeline_params_from_jax(
                jx["params0"][(p, d, t)], cfg, pp_rank=p, pp_size=pp)
        else:
            whole = gpt_pipeline_params_from_jax(
                jx["params0"][(p, d, 0)], cfg, pp_rank=p, pp_size=pp)
            out[rank] = shard_gpt_state_dict(whole, t, slice_tp)
    return out


def port_named(tree, pp_rank, pp_size, pp_layers=None):
    """A JAX rank's tree as the port stage's numpy ``state_dict``."""
    cfg = cfg_of(pp_size if pp_layers is None else pp_layers)
    return {k: v.float().numpy() for k, v in gpt_pipeline_params_from_jax(
        tree, cfg, pp_rank=pp_rank, pp_size=pp_size).items()}


# the key bias's true gradient is zero (a softmax row is invariant to one
# constant added to all its scores), so Adam steps it on fp32 rounding
# noise, in JAX as in the port: at most about lr a step either way
KEY_BIAS_TOL = 2 * ITERS * 1e-3


def assert_params(got, ref, what, tp=None, t=0):
    """Every parameter within 1e-4 of its largest magnitude, the key
    biases within ``KEY_BIAS_TOL`` (JAX's parameters sliced to tp rank
    ``t`` of ``tp`` where given)."""
    if tp is not None:
        ref = {k: v.numpy() for k, v in shard_gpt_state_dict(
            {k: torch.from_numpy(v) for k, v in ref.items()}, t, tp).items()}
    assert set(got) == set(ref), (what, sorted(set(got) ^ set(ref)))
    for name, r in ref.items():
        g = got[name]
        if name.endswith("query_key_value.bias"):
            # [heads, 3, head_dim]: each head's q, k and v adjacent
            g, r = g.reshape(-1, 3, HIDDEN // HEADS), r.reshape(
                -1, 3, HIDDEN // HEADS)
            np.testing.assert_allclose(g[:, 1], r[:, 1], rtol=0,
                                       atol=KEY_BIAS_TOL,
                                       err_msg=f"{what}: {name} (k)")
            g, r = g[:, ::2], r[:, ::2]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"{what}: {name}")


def assert_params_by_grads(got, ref, grads, what, tp, t):
    """Every parameter within ``1e-5 + 2 ITERS lr ng / (|g| + ng)``, ``ng =
    1e-4 max|g| + 1e-6`` the largest gradient of the model, ``g`` the
    reference's first gradient (``chip_smoke.py``'s ``SMALL_CARD_TOL``):
    Adam divides each gradient by its own size, so an element whose
    gradient is within its noise may step by up to lr either way on each
    side.  The reference's parameters and gradients are sliced to tp rank
    ``t`` of ``tp``."""
    def shard(d):
        return {k: v.numpy() for k, v in shard_gpt_state_dict(
            {k: torch.from_numpy(v) for k, v in d.items()}, t, tp).items()}

    ref, grads = shard(ref), shard(grads)
    assert set(got) == set(ref), (what, sorted(set(got) ^ set(ref)))
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    for name, r in ref.items():
        g = np.abs(grads[name])
        ng = 1e-4 * g.max() + floor
        tol = 1e-5 + 2 * ITERS * 1e-3 * ng / (g + ng)
        assert (np.abs(got[name] - r) <= tol).all(), (
            what, name, float(np.abs(got[name] - r).max()))


def assert_params_bf16(got, ref, grads, dtypes, what):
    """The ``--bf16`` run's parameters against JAX's: every element within
    ``ITERS ulp + 2 ITERS lr ng / (|g| + ng)``, ``ulp`` the spacing of the
    parameter's own dtype at the larger of the two values, ``ng = 2**-7
    max|g| + 1e-6`` the model's largest gradient, ``g`` the port's first
    gradient: each of the ``ITERS`` stores may round the other way (one
    ulp each), and bf16 gradients on each side are within one bf16 ulp
    (2**-8) of the tensor's largest, so that an element whose gradient is
    within that noise may step by up to lr either way on each side.  The
    key biases (true gradient zero) within ``KEY_BIAS_TOL``."""
    assert set(got) == set(ref), (what, sorted(set(got) ^ set(ref)))
    floor = 1e-6 * max(np.abs(g).max() for g in grads.values())
    d = HIDDEN // HEADS
    for name, r in ref.items():
        g, p, gr = got[name], r.astype(np.float32), np.abs(grads[name])
        if name.endswith("query_key_value.bias"):
            # [heads, 3, head_dim]: each head's q, k and v adjacent
            g, p, gr = (a.reshape(-1, 3, d) for a in (g, p, gr))
            np.testing.assert_allclose(g[:, 1], p[:, 1], rtol=0,
                                       atol=KEY_BIAS_TOL,
                                       err_msg=f"{what}: {name} (k)")
            g, p, gr = g[:, ::2], p[:, ::2], gr[:, ::2]
        mantissa = {torch.float32: 23, torch.bfloat16: 7}[dtypes[name]]
        big = np.maximum(np.maximum(np.abs(g), np.abs(p)), 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(big)) - mantissa)
        ng = 2 ** -7 * gr.max() + floor
        tol = ITERS * ulp + 2 * ITERS * 1e-3 * ng / (gr + ng)
        assert (np.abs(g - p) <= tol).all(), (
            what, name, float((np.abs(g - p) / tol).max()))
