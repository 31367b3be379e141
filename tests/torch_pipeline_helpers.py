"""Shared pieces of the Llama pipeline tests
(``tests/test_torch_pipeline_llama.py``, ``tests/test_torch_pipeline_sp.py``):
the configuration, the rank functions the gloo worlds run, and the JAX
runs they are held to.  Importing this module imports no JAX: the spawned
ranks import it to find their function.
"""

import functools

import numpy as np
import torch

from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaPipeConfig,
    llama_pipeline_params_from_jax,
    make_llama_3d_train_step,
)
from apex_tpu_torch.models.convert import shard_state_dict
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer import parallel_state as tps
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_pipelining_1f1b,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    average_losses_across_data_parallel_group,
)

# GQA with one kv head a rank at tp 2; two layers a stage at pp 2
CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=32)
S, MB, N_MICRO, LR, STEPS, PP = 32, 2, 4, 1e-4, 3, 2


def pcfg(sp=False):
    return LlamaPipeConfig(config=LlamaConfig(**CFG),
                           layers_per_stage=CFG["num_hidden_layers"] // PP,
                           sequence_parallel_enabled=sp)


def batches_of(dp, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (N_MICRO, MB * dp, S))
    return {"ids": ids, "labels": np.roll(ids, -1, axis=-1)}


def rows(batches, d):
    return {k: torch.from_numpy(v[:, d * MB:(d + 1) * MB])
            for k, v in batches.items()}


def to_np(tensors):
    return {k: v.detach().numpy().copy() for k, v in tensors}


def run_steps(cfg, state, batches, **kw):
    """Three 3-d steps from ``state``: the losses, the first step's
    gradients, the parameters after."""
    init_fn, train_step = make_llama_3d_train_step(
        cfg, functools.partial(FusedAdam, lr=LR),
        forward_backward_pipelining_1f1b, device="cpu", **kw)
    spec, opt = init_fn(state=state)
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(float(train_step(spec, opt, batches)))
        if grads is None:
            grads = to_np((n, p.grad) for n, p in spec.named_parameters())
    return dict(losses=losses, grads=grads,
                params=to_np(spec.named_parameters()))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def pp2_world(rank, world, trees, batches):
    """dp 1 x pp 2: three steps from JAX's stage weights, then the
    driver."""
    from apex_tpu_torch.examples import llama_pretrain

    tps.initialize_model_parallel(1, PP)
    p = tps.get_pipeline_model_parallel_rank()
    state = llama_pipeline_params_from_jax(trees[p], pcfg(), pp_rank=p,
                                           pp_size=PP)
    out = run_steps(pcfg(), state, rows(batches, 0))
    tps.destroy_model_parallel()
    argv = ["--device", "cpu", "--pp", "2", "--layers", "2", "--steps", "3",
            "--seq", "32", "--vocab", "128", "--micro-batch", "2"]
    out["driver"] = llama_pretrain.main(argv)
    out["driver_amp"] = llama_pretrain.main(argv + ["--amp"])
    return out


def dp2_world(rank, world, trees, batches_dp2):
    """dp 2 x pp 2 x tp 1: three steps from JAX's stage weights, and the
    loss average over dp."""
    tps.initialize_model_parallel(1, PP)
    p, d = (tps.get_pipeline_model_parallel_rank(),
            tps.get_data_parallel_rank())
    state = llama_pipeline_params_from_jax(trees[p], pcfg(), pp_rank=p,
                                           pp_size=PP)
    out = run_steps(pcfg(), state, rows(batches_dp2, d))
    out["dp_rank"] = d
    out["loss_avg"] = average_losses_across_data_parallel_group(
        [torch.tensor(float(rank)), torch.tensor(1.0)]).tolist()
    return out


def sp_world(rank, world, trees, batches):
    """pp 2 x tp 2 under sequence parallelism: the first step's raw and
    repaired gradients, three steps; then the overflow step."""
    out = {}
    tps.initialize_model_parallel(2, PP)
    p, t = (tps.get_pipeline_model_parallel_rank(),
            tps.get_tensor_model_parallel_rank())
    tp_group = tps.get_tensor_model_parallel_group()
    state = shard_state_dict(llama_pipeline_params_from_jax(
        trees[p], pcfg(), pp_rank=p, pp_size=PP), t, 2)
    mb = rows(batches, 0)
    init_fn, _ = make_llama_3d_train_step(
        pcfg(sp=True), functools.partial(FusedAdam, lr=LR),
        forward_backward_pipelining_1f1b, device="cpu")
    spec, _ = init_fn(state=state)
    with ttp.tensor_parallel_region(tp_group):
        forward_backward_pipelining_1f1b(
            spec, mb, tensor_shape=(S // 2, MB, CFG["hidden_size"]),
            dtype=torch.float32)
    raw = to_np((n, q.grad) for n, q in spec.named_parameters())
    tagged = sorted(n for n, q in spec.named_parameters()
                    if getattr(q, "sequence_parallel", False))
    ttp.allreduce_sequence_parallel_grads(spec.parameters(), tp_group)
    reduced = to_np((n, q.grad) for n, q in spec.named_parameters())
    out["sp"] = dict(run_steps(pcfg(sp=True), state, mb), raw=raw,
                     reduced=reduced, tagged=tagged, pp_rank=p, tp_rank=t)
    # ---- an inf on stage 0 only, under GradScaler -----------------------
    def poisoned(spec, batches, **kw):
        res = forward_backward_pipelining_1f1b(spec, batches, **kw)
        if tps.get_pipeline_model_parallel_rank() == 0 and poison[0]:
            next(iter(spec.parameters())).grad.view(-1)[0] = float("inf")
        return res

    poison = [True]
    scaler = GradScaler()
    init_fn, train_step = make_llama_3d_train_step(
        pcfg(sp=True), functools.partial(FusedAdam, lr=LR,
                                          master_weights=True),
        poisoned, device="cpu", grad_scaler=scaler)
    spec, opt = init_fn(state=state)
    before = to_np(spec.named_parameters())
    sstate = scaler.init("cpu")
    _, found, sstate = train_step(spec, opt, mb, sstate)
    skipped = to_np(spec.named_parameters())
    poison[0] = False
    _, found2, sstate2 = train_step(spec, opt, mb, sstate)
    out["overflow"] = dict(
        found=bool(found), found_clean=bool(found2),
        scales=[float(scaler.init("cpu").scale), float(sstate.scale),
                float(sstate2.scale)],
        kept_bits=all(np.array_equal(before[n], skipped[n]) for n in before),
        moved_after=any(not np.array_equal(before[n], q.detach().numpy())
                        for n, q in spec.named_parameters()))
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def per_device(tree):
    """``{device id: numpy tree}``: each device's own buffer of every leaf
    (under ``out_specs=P()`` without the replication check the devices'
    buffers differ, and ``np.asarray`` reads device 0's)."""
    import jax

    leaves, treedef = jax.tree.flatten(tree)
    ids = sorted(s.device.id for s in leaves[0].addressable_shards)
    by_dev = []
    for leaf in leaves:
        shards = {s.device.id: np.asarray(s.data) for s in
                  leaf.addressable_shards}
        by_dev.append(shards)
    return {i: jax.tree.unflatten(treedef, [b[i] for b in by_dev])
            for i in ids}


def jax_3d(devices, tp, pp, batches, params=None, steps=STEPS, sp=False,
           grads=True):
    """JAX's ``main_3d`` over ``devices``: the init (unless ``params``, a
    ``{device id: tree}`` of weights), the first step's gradients (the
    schedule's raw ones, and those with embed / head psum'd over pp, all
    pmean'd over dp; unless not ``grads``) and
    ``steps`` steps of ``make_llama_3d_train_step``; every tree per
    device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.models import LlamaConfig as JCfg
    from apex_tpu.models import LlamaPipeConfig as JPipe
    from apex_tpu.models import build_llama_pipeline
    from apex_tpu.models import make_llama_3d_train_step as jstep
    from apex_tpu.optimizers import FusedAdam as JAdam
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_1f1b as j1f1b,
    )
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = jps.initialize_model_parallel(tp, pp, devices=devices)
    pcfg = JPipe(config=JCfg(**CFG), layers_per_stage=CFG[
        "num_hidden_layers"] // pp, sequence_parallel_enabled=sp)
    opt = JAdam(lr=LR)
    init_fn, train_step = jstep(pcfg, opt, j1f1b)
    spec = build_llama_pipeline(pcfg)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batches.items()}
    bspecs = {"ids": P(None, "dp"), "labels": P(None, "dp")}
    out = {}
    try:
        with mesh:
            if params is None:
                params, state = jax.jit(shard_map(
                    functools.partial(init_fn, jax.random.PRNGKey(0)),
                    mesh=mesh, in_specs=(bspecs,), out_specs=P(),
                    **NO_REP_CHECK))(jb)
            else:
                # per-device weights: stacked on (pp, tp), each device
                # taking its own
                order = np.vectorize(lambda d: d.id)(mesh.devices)[0]
                stacked = jax.tree.map(
                    lambda *ls: np.stack(ls).reshape(
                        order.shape + ls[0].shape),
                    *[params[i] for i in order.ravel()])
                pspec = jax.tree.map(lambda _: P("pp", "tp"), stacked)
                params = jax.jit(shard_map(
                    lambda t: jax.tree.map(lambda l: l[0, 0], t), mesh=mesh,
                    in_specs=(pspec,), out_specs=P(), **NO_REP_CHECK))(stacked)
                state = jax.jit(shard_map(opt.init, mesh=mesh,
                                          in_specs=(P(),), out_specs=P(),
                                          **NO_REP_CHECK))(params)
            out["params0"] = per_device(params)

            def grads_fn(params, batches):
                _, g = j1f1b(spec, params, batches)
                g = jax.tree.map(lambda a: jax.lax.pmean(a, "dp"), g)
                summed = {k: jax.tree.map(lambda a: jax.lax.psum(a, "pp"),
                                          g[k]) for k in ("embed", "head")}
                return g, dict(g, **summed)

            if grads:
                raw, g1 = jax.jit(shard_map(
                    grads_fn, mesh=mesh, in_specs=(P(), bspecs),
                    out_specs=(P(), P()), **NO_REP_CHECK))(params, jb)
                out["raw"], out["g1"] = per_device(raw), per_device(g1)
            step = jax.jit(shard_map(
                train_step, mesh=mesh, in_specs=(P(), P(), bspecs),
                out_specs=(P(), P(), P()), **NO_REP_CHECK))
            losses = []
            for _ in range(steps):
                params, state, loss = step(params, state, jb)
                losses.append(float(loss))
            out["losses"], out["params"] = losses, per_device(params)
    finally:
        jps.destroy_model_parallel()
    return out


def slice_flax(tree, t, tp):
    """Shard ``t`` of ``tp`` of one JAX stage tree (flax ``[in, out]``
    kernels): q/k/v/gate/up on their output columns, o/down on their
    input rows, the embedding and the head on their vocab rows."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        name = "/".join(path)
        dim = None
        if "embed_tokens" in name or name.endswith("lm_head"):
            dim = 0
        elif any(k in name for k in ("q_proj", "k_proj", "v_proj",
                                     "gate_proj", "up_proj")):
            dim = 1
        elif "o_proj" in name or "down_proj" in name:
            dim = 0
        if dim is None:
            return node
        n = node.shape[dim] // tp
        return np.take(node, np.arange(t * n, (t + 1) * n), axis=dim)

    return walk(tree, ())



def stage_of(tree, p):
    """Stage ``p``'s port ``state_dict`` (numpy) of a JAX stage tree."""
    return {k: v.numpy() for k, v in llama_pipeline_params_from_jax(
        tree, pcfg(), pp_rank=p, pp_size=PP).items()}


def tp_shard(state, t, tp=2):
    """``shard_state_dict`` of a numpy ``state_dict``."""
    whole = {k: torch.from_numpy(v) for k, v in state.items()}
    return {k: v.numpy() for k, v in shard_state_dict(whole, t, tp).items()}


def assert_params(got, ref, what):
    """Every parameter within 1e-4 of its largest magnitude."""
    assert set(got) == set(ref), what
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"{what}: {name}")


def assert_grads(got, ref, what):
    """Every gradient within ``1e-4 max|g| + 1e-4 |g|``."""
    assert set(got) == set(ref), what
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max() + 1e-30,
                                   err_msg=f"{what}: {name}")


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# pp 1 in fp16: forward_backward_no_pipelining's fp32 sums
# ---------------------------------------------------------------------------

AMP_LR = 1e-4


def pcfg1():
    """The configuration on one stage (pp 1)."""
    return LlamaPipeConfig(config=LlamaConfig(**CFG),
                           layers_per_stage=CFG["num_hidden_layers"])


def pp1_fp16_world(rank, world, tree, batches, scale):
    """dp = pp = tp = 1: the 3-d step over ``get_forward_backward_func(
    None, 1)`` (``no_pipelining``) in fp16 O2 (``o2_cast``: the matrices
    fp16, the norm scales fp32) under ``GradScaler(init_scale=scale)``
    with ``FusedAdam(master_weights=True)``: the schedule's sums and
    found_inf alone, then one step's found_inf, scaler state and
    masters."""
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_forward_backward_func,
    )

    tps.initialize_model_parallel(1, 1)
    state = llama_pipeline_params_from_jax(tree, pcfg1(), pp_rank=0,
                                           pp_size=1)
    scaler = GradScaler(init_scale=scale)
    schedule = get_forward_backward_func(None, 1)
    init_fn, train_step = make_llama_3d_train_step(
        pcfg1(), functools.partial(FusedAdam, lr=AMP_LR,
                                   master_weights=True),
        schedule, device="cpu",
        cast=functools.partial(o2_cast, dtype=torch.float16),
        grad_scaler=scaler)
    spec, opt = init_fn(state=state)
    sstate = scaler.init("cpu")
    mb = rows(batches, 0)
    _, sums, found_alone = schedule(spec, mb, grad_scaler=scaler,
                                    scaler_state=sstate, with_found_inf=True)
    out = dict(sums={k: v.numpy().copy() for k, v in sums.items()},
               sum_dtypes={k: str(v.dtype) for k, v in sums.items()},
               grad_dtypes={n: str(p.grad.dtype)
                            for n, p in spec.named_parameters()},
               grad_nonfinite=sum(int((~torch.isfinite(p.grad)).sum())
                                  for p in spec.parameters()),
               found_alone=bool(found_alone),
               params0=to_np(spec.named_parameters()))
    loss, found, sstate = train_step(spec, opt, mb, sstate)
    out.update(loss=float(loss), found=bool(found),
               scaler=[float(t) for t in sstate],
               masters={n: opt.state[p]["master_param"].numpy().copy()
                        for n, p in spec.named_parameters()},
               params=to_np(spec.named_parameters()))
    return out


def jax_pp1_fp16(devices, batches, scales):
    """JAX's pp-1 fp16 step on one device: the weights of the seeded init
    (O2: the matrices fp16), then for the first of ``scales`` at which
    ``forward_backward_no_pipelining`` over the spec's mean loss finds no
    overflow while some fp32 sum passes 65504: its sums, found_inf, the
    scale, and ``FusedAdam(master_weights=True).step`` from the unscaled
    sums (the masters after, the scaler state after)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.amp.scaler import LossScaler as JScaler
    from apex_tpu.models import LlamaConfig as JCfg
    from apex_tpu.models import LlamaPipeConfig as JPipe
    from apex_tpu.models import build_llama_pipeline
    from apex_tpu.models.llama_pipeline import init_llama_pipeline_params
    from apex_tpu.optimizers import FusedAdam as JAdam
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_no_pipelining as jnopipe,
    )
    from apex_tpu.utils.compat import NO_REP_CHECK, shard_map

    mesh = jps.initialize_model_parallel(1, 1, devices=devices[:1])
    pcfg = JPipe(config=JCfg(**CFG),
                 layers_per_stage=CFG["num_hidden_layers"])
    spec = build_llama_pipeline(pcfg)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batches.items()}
    bspecs = {"ids": P(None, "dp"), "labels": P(None, "dp")}
    opt = JAdam(lr=AMP_LR, master_weights=True)

    def loss_fn(p, mb):
        return spec.last_fn(p, spec.stage_fn(p, spec.first_fn(p, mb)),
                            mb) / N_MICRO

    def cast(p):
        return jax.tree.map(
            lambda l: l.astype(jnp.float16) if l.ndim >= 2 else l, p)

    out = {}
    try:
        with mesh:
            params = jax.jit(shard_map(
                lambda b: cast(init_llama_pipeline_params(
                    pcfg, jax.random.PRNGKey(0), b["ids"][0])),
                mesh=mesh, in_specs=(bspecs,), out_specs=P(),
                **NO_REP_CHECK))(jb)
            out["params0"] = jax.tree.map(np.asarray, params)

            def sums_fn(params, scale, batches):
                scaler = JScaler()
                sstate = scaler.init()._replace(scale=scale)
                return jnopipe(loss_fn, params, batches,
                               grad_scaler=scaler, scaler_state=sstate,
                               with_found_inf=True)[1:]

            sums_step = jax.jit(shard_map(
                sums_fn, mesh=mesh, in_specs=(P(), P(), bspecs),
                out_specs=(P(), P()), **NO_REP_CHECK))
            for scale in scales:
                sums, found = sums_step(params, jnp.float32(scale), jb)
                peak = max(float(jnp.abs(l).max())
                           for l in jax.tree.leaves(sums))
                if not bool(found) and peak > 65504.0:
                    break
            else:
                raise AssertionError("no scale gives finite sums past the "
                                     "fp16 range")

            def step_fn(params, scale, sums):
                scaler = JScaler(init_scale=scale)
                sstate = scaler.init()
                grads, found = scaler.unscale(sums, sstate)
                new_p, new_s = opt.step(grads, params, opt.init(params),
                                        found_inf=found)
                return (new_s[1].master_params, found,
                        tuple(scaler.update(sstate, found)))

            masters, found2, sstate = jax.jit(
                step_fn, static_argnums=1)(params, scale, sums)
            out.update(scale=scale, sums=jax.tree.map(np.asarray, sums),
                       found=bool(found), found_step=bool(found2),
                       masters=jax.tree.map(np.asarray, masters),
                       scaler=[float(t) for t in sstate], peak=peak)
    finally:
        jps.destroy_model_parallel()
    return out


def stage1_of(tree):
    """The pp-1 port ``state_dict`` (numpy) of a JAX tree."""
    return {k: v.float().numpy() for k, v in llama_pipeline_params_from_jax(
        tree, pcfg1(), pp_rank=0, pp_size=1).items()}
