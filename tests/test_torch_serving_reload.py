"""The port's weight lifecycle against the JAX package's: the engine's
``swap_params``, the scheduler's ``swap_weights``, ``load_serving_params``,
``WeightWatcher``, ``HotReloader`` (reload, refusal, rollback, prefetch,
retry), the degraded start, prefix-cache invalidation and shadow A/B.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4
heads over 2 kv heads, vocab 128, fp32) carried to the port by
``models/convert.py``; each weight version is the JAX tree plus a
constant, carried over the same way.  The JAX package's
``tests/test_serving_reload.py`` case by case, without its two tensor-
parallel cases (``tp=`` comes later), and with the port's own witnesses
where JAX counts compiles: the KV cache's storage is not moved by a
swap, and a model call runs the norm modules ``2L + 1`` times before and
after it.  Where JAX and the port serve the same run on a ``VirtualClock``
(the mid-stream swap, the reload lifecycle, the shadow mirror), the
streams, the mirrored rids, the reload events and the ``apex_serving_*``
metric snapshot equal JAX's (wall-clock fields and refusal texts aside).
A swap on one engine leaves another engine over the same module serving
bit for bit.
"""

import os
import threading
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import _logging as jlog
from apex_tpu import obs as jobs
from apex_tpu import resilience as jrz
from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.resilience import fault_injection as jfi
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import obs as tobs
from apex_tpu_torch import resilience as rz
from apex_tpu_torch import serving as sv
from apex_tpu_torch.amp.policy import O2
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.obs import bridge as obs_bridge
from apex_tpu_torch.obs import request_trace as rt
from apex_tpu_torch.resilience import checkpoint as _ckpt
from apex_tpu_torch.resilience import fault_injection as tfi
from apex_tpu_torch.serving.prefix_cache import PrefixCache

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MAX = 96


@pytest.fixture(scope="module")
def jax_model():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return jmodel, params


def _mutated(tree, delta):
    return jax.tree.map(
        lambda l: l + delta if jnp.issubdtype(l.dtype, jnp.floating)
        else l, tree)


@pytest.fixture(scope="module")
def versions(jax_model):
    """``fn(delta) -> state_dict``: the JAX weights plus ``delta``,
    carried to the port, in the model's own key order."""
    _, params = jax_model
    order = list(LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
                 .state_dict())
    memo = {}

    def sd(delta=0.0):
        if delta not in memo:
            conv = llama_params_from_jax(
                jax.tree.map(np.asarray, _mutated(params, delta)),
                LlamaConfig(**CFG))
            memo[delta] = OrderedDict((k, conv[k]) for k in order)
        return OrderedDict(memo[delta])
    return sd


@pytest.fixture(scope="module")
def params(versions):
    return versions(0.0)


@pytest.fixture(scope="module")
def params_v2(versions):
    """A genuinely different weight version (greedy argmaxes move)."""
    return versions(0.05)


def _model(state):
    m = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    m.load_state_dict(state)
    return m


def _engine(state, *, paged=False, slots=4, model=None, quant=None):
    return sv.DecodeEngine(
        model if model is not None else _model(state), device="cpu",
        slots=slots, max_len=MAX, prefill_len=16, quant=quant,
        paged=sv.PagedCacheConfig(block_size=16, num_blocks=64)
        if paged else None)


def _prompt(seed=0, n=10):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, CFG["vocab_size"], n)]


def _sd_equal(a, b):
    assert list(a) == list(b)
    return all(torch.equal(a[k], b[k]) for k in a)


def _save_versions(root, versions, *steps):
    """Commit train-state checkpoints {params: params + step/1000}."""
    for s in steps:
        rz.save_checkpoint(str(root), s, {"params": versions(s / 1000.0)})


def _like(params):
    return {"params": params}


class _EventTap:
    def __init__(self, logging_mod=tlog):
        self.mod, self.events = logging_mod, []

    def __enter__(self):
        self._sink = lambda e: self.events.append(dict(e))
        self.mod.add_event_sink(self._sink)
        return self

    def __exit__(self, *exc):
        self.mod.remove_event_sink(self._sink)

    def of(self, kind):
        return [e for e in self.events if e.get("event") == kind]


def _workload(psv=sv, n=6, burst=3, seed=0, max_new=8):
    return psv.make_workload(
        psv.zero_overlap_prompts(n, length=8, vocab=CFG["vocab_size"],
                                 seed=seed),
        psv.burst_arrivals(n, burst=burst, period_s=0.5),
        max_new_tokens=max_new)


def _sched(engine, clk=None, **kw):
    return sv.ContinuousBatchingScheduler(
        engine, max_queue=16, clock=clk or sv.VirtualClock(), **kw)


def _decode(eng, first, n):
    toks = np.zeros((eng.slots,), np.int64)
    act = np.zeros((eng.slots,), bool)
    act[0] = True
    out, logits = [], []
    for _ in range(n):
        toks[0] = out[-1] if out else first
        lg = eng.decode(toks, act)[0]
        logits.append(lg.clone())
        out.append(int(torch.argmax(lg)))
    return out, logits


# ---------------------------------------------------------------------------
# engine-level swap
# ---------------------------------------------------------------------------


class TestEngineSwap:
    def test_post_swap_tokens_bit_identical_to_fresh_engine_same_state(
            self, params, params_v2):
        """Decode on the old weights, swap, decode more: the post-swap
        logits equal, bit for bit, a fresh engine booted on the new
        weights and fed the captured state."""
        eng = _engine(params, slots=2)
        logits = eng.prefill(0, _prompt(seed=1))
        stream, _ = _decode(eng, int(torch.argmax(logits)), 4)
        k, v, length = eng.capture_slot(0)
        old = eng.swap_params(params_v2)
        assert eng.weights_version == 1
        assert _sd_equal(old, params)            # displaced buffer intact
        post, post_logits = _decode(eng, stream[-1], 6)
        fresh = _engine(params_v2, slots=2)
        fresh.restore_prefix(0, (k, v), length)
        ref, ref_logits = _decode(fresh, stream[-1], 6)
        assert post == ref
        for a, b in zip(post_logits, ref_logits):
            assert torch.equal(a, b)

    def test_swap_witnesses_cache_storage_and_norm_calls(self, params,
                                                         params_v2):
        """What stands in for JAX's zero-new-compiles: the KV cache's
        storage is where it was, and each model call runs the norm
        modules 2L + 1 times before and after the swap."""
        eng = _engine(params, slots=2)
        calls = []
        for m in eng.model.modules():
            if isinstance(m, FusedRMSNorm):
                m.register_forward_hook(lambda *a: calls.append(1))
        cache = eng.cache
        ptrs = (cache.k.data_ptr(), cache.v.data_ptr(),
                cache.lengths.data_ptr())
        eng.prefill(0, _prompt(seed=2))
        _decode(eng, 3, 1)
        per_call = 2 * CFG["num_hidden_layers"] + 1
        assert len(calls) == 2 * per_call
        eng.swap_params(params_v2)
        _decode(eng, 3, 1)
        eng.prefill(1, _prompt(seed=3))
        assert len(calls) == 4 * per_call
        assert (cache.k.data_ptr(), cache.v.data_ptr(),
                cache.lengths.data_ptr()) == ptrs
        assert eng.cache is cache

    def test_swap_rejects_mismatched_candidate(self, params):
        eng = _engine(params, slots=2)
        wrong_shape = {k: torch.zeros(tuple(v.shape) + (1,), dtype=v.dtype)
                       for k, v in params.items()}
        with pytest.raises(ValueError):
            eng.swap_params(wrong_shape)
        wrong_dtype = {k: v.half() for k, v in params.items()}
        with pytest.raises(ValueError):
            eng.swap_params(wrong_dtype)
        with pytest.raises(ValueError):
            eng.swap_params({"nope": torch.ones(1)})
        assert eng.weights_version == 0          # nothing swapped

    def test_swap_on_one_engine_leaves_another_on_the_module(
            self, params, params_v2):
        """Two engines over one module (a shadow pair, fleet replicas):
        swapping A rebinds A's tensors only.  B serves its old logits bit
        for bit, the module's own parameters are the same objects with
        the same bytes, and swapping A back restores A bit for bit."""
        model = _model(params)
        own = {k: (v, v.detach().clone())
               for k, v in model.state_dict(keep_vars=True).items()}
        a = _engine(None, model=model, slots=2)
        b = _engine(None, model=model, slots=2)
        prompt = _prompt(seed=4)

        def probe(e):
            out = e.prefill(0, prompt).clone()
            e.reset()
            return out

        a0, b0 = probe(a), probe(b)
        old = a.swap_params(params_v2)
        assert all(a.params[k] is params_v2[k] for k in params_v2)  # no copy
        a1, b1 = probe(a), probe(b)
        assert not torch.equal(a0, a1)
        assert torch.equal(b0, b1)
        assert torch.equal(a1, probe(_engine(params_v2, slots=2)))
        for k, (obj, data) in own.items():
            assert model.state_dict(keep_vars=True)[k] is obj
            assert torch.equal(obj, data)
        a.swap_params(old)
        assert torch.equal(probe(a), a0) and torch.equal(probe(b), b0)

    def test_int8_engine_quantizes_a_float_candidate_as_boot_did(
            self, params, params_v2):
        q = sv.QuantConfig(weights=True, kv=False)
        eng = _engine(params, slots=2, quant=q)
        boot = eng.params
        old = eng.swap_params(params_v2)
        assert _sd_equal(old, boot)
        assert _sd_equal(eng.params, _engine(params_v2, slots=2,
                                             quant=q).params)
        eng.swap_params(old)                     # a quantized buffer, as is
        assert all(eng.params[k] is old[k] for k in old)

    def test_policy_cast_equals_cast_params_on_the_module(self, params,
                                                          tmp_path):
        rz.save_checkpoint(str(tmp_path), 1, {"params": params})
        got, _ = sv.load_serving_params(str(tmp_path), _like(params),
                                        params_key="params", policy=O2())
        ref = O2().cast_params(_model(params)).state_dict()
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k],
                                                                ref[k]), k
        assert ref["norm.scale"].dtype == torch.float32
        assert ref["layers.0.mlp.up_proj.weight"].dtype == torch.bfloat16

    def test_shardings_raise_until_tensor_parallel(self, params, tmp_path):
        """``shardings=`` restores a tp rank's slice: rank 1 of 2 gets
        its block of every sharded weight (whole norms), and a
        ``HotReloader`` takes the same slices."""
        rz.save_checkpoint(str(tmp_path), 1, {"params": params})
        whole = _like(params)["params"]
        sh = sv.tp_param_shardings(whole, 1, 2)
        like = {"params": {k: (t if sh[k] is None else sh[k].take(t))
                           for k, t in whole.items()}}
        got, step = sv.load_serving_params(str(tmp_path), like,
                                           params_key="params", shardings=sh)
        assert step == 1
        ref = _model(params).state_dict()
        for k, t in got.items():
            want = ref[k] if sh[k] is None else sh[k].take(ref[k])
            assert torch.equal(t, want), k
        assert sh["layers.0.self_attn.q_proj.weight"].dim == 0
        assert sh["layers.0.mlp.down_proj.weight"].dim == 1
        assert sh["norm.scale"] is None
        rel = sv.HotReloader(_sched(_engine(params, slots=2)), str(tmp_path),
                             like=like, params_key="params", shardings=sh)
        assert rel.shardings is sh

    def test_quantize_restores_the_int8_layout(self, params, tmp_path):
        rz.save_checkpoint(str(tmp_path), 1, {"params": params})
        got, _ = sv.load_serving_params(str(tmp_path), _like(params),
                                        params_key="params", quantize=True)
        ref = sv.quantize_params(_model(params)).state_dict()
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


# ---------------------------------------------------------------------------
# WeightWatcher: the three committed-step sources
# ---------------------------------------------------------------------------


class TestWeightWatcher:
    def test_root_walk_source_and_monotonic_poll(self, versions, tmp_path):
        w = sv.WeightWatcher(str(tmp_path))
        assert w.poll() is None                  # empty root: nothing
        _save_versions(tmp_path, versions, 3, 7)
        assert w.poll() == 7                     # newest committed
        w.mark(7)
        assert w.poll() is None                  # nothing newer
        _save_versions(tmp_path, versions, 9)
        assert w.poll() == 9
        assert w.poll() == 9                     # re-offered until marked
        assert w.polls == 5

    def test_checkpointer_source(self, params, tmp_path):
        ac = rz.AsyncCheckpointer(rz.CheckpointManager(str(tmp_path)))
        w = sv.WeightWatcher(str(tmp_path), checkpointer=ac)
        assert w.poll() is None                  # nothing committed yet
        ac.save(12, {"params": params}).result()
        assert ac.committed_step == 12
        assert w.poll() == 12
        w.mark(12)
        assert w.poll() is None

    def test_heartbeat_source(self, versions, tmp_path):
        hb = str(tmp_path / "heartbeat")
        root = str(tmp_path / "ckpts")
        _save_versions(root, versions, 5)
        w = sv.WeightWatcher(root, heartbeat_path=hb)
        assert w.poll() is None                  # no heartbeat yet: no-op
        ckpt_path = os.path.join(root, _ckpt._step_dirname(5))
        rz.write_heartbeat(hb, 5, ckpt_path=ckpt_path)
        assert w.poll() == 5
        rz.write_heartbeat(hb, 6)                # no ckpt_path yet
        assert sv.WeightWatcher(root, heartbeat_path=hb).poll() is None
        # a heartbeat the JAX supervisor wrote is read the same way
        jrz.write_heartbeat(hb, 5, ckpt_path=ckpt_path)
        assert sv.WeightWatcher(root, heartbeat_path=hb).poll() == 5

    def test_one_source_only(self, tmp_path):
        ac = rz.AsyncCheckpointer(rz.CheckpointManager(str(tmp_path)))
        with pytest.raises(ValueError):
            sv.WeightWatcher(str(tmp_path), heartbeat_path="x",
                             checkpointer=ac)

    def test_walk_skips_live_writer_steps(self, versions, tmp_path):
        _save_versions(tmp_path, versions, 1, 4)
        w = sv.WeightWatcher(str(tmp_path))
        with _ckpt._live_writer(str(tmp_path), 4):
            assert _ckpt.in_flight_steps(str(tmp_path)) == {4}
            assert w.poll() == 1                 # 4 is mid-commit
            assert rz.latest_valid_step(str(tmp_path)) == 1
        assert w.poll() == 4                     # committed now


class TestWatcherWriterRace:
    def test_concurrent_resave_never_crashes_or_selects_partial(
            self, params, tmp_path):
        root = str(tmp_path)
        mgr = rz.CheckpointManager(root, keep=8)
        mgr.save(1, {"params": params})
        mgr.save(5, {"params": params})
        stop = threading.Event()
        writer_err = []

        def writer():
            try:
                while not stop.is_set():
                    mgr.save(5, {"params": params})   # aside-swap path
            except BaseException as e:               # pragma: no cover
                writer_err.append(e)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            w = sv.WeightWatcher(root)
            for _ in range(150):
                assert rz.latest_valid_step(root) in (1, 5)
                assert w.committed_step() in (1, 5)
        finally:
            stop.set()
            t.join(30.0)
        assert not writer_err

    def test_writer_crash_leaves_watcher_blind_to_partial(
            self, versions, params, tmp_path):
        root = str(tmp_path)
        _save_versions(tmp_path, versions, 2)
        crash = tfi.CrashCheckpointWriter(after_records=1)
        ac = rz.AsyncCheckpointer(rz.CheckpointManager(root),
                                  progress_hook=crash)
        fut = ac.save(6, {"params": params})
        fut.join()
        assert isinstance(fut.error, rz.SimulatedWriterCrash)
        w = sv.WeightWatcher(root)
        assert w.poll() == 2                     # 6 never committed
        assert rz.latest_valid_step(root) == 2
        _, step = sv.load_serving_params(root, _like(params),
                                         params_key="params")
        assert step == 2
        ac2 = rz.AsyncCheckpointer(rz.CheckpointManager(root))
        ac2.save(6, {"params": params}).result()  # retry commits
        assert w.poll() == 6


# ---------------------------------------------------------------------------
# HotReloader: validate gate, refusal, rollback
# ---------------------------------------------------------------------------


def _booted(versions, params, tmp_path, *steps, boot=None, **kw):
    _save_versions(tmp_path, versions, *steps)
    state, step = sv.load_serving_params(
        str(tmp_path), _like(params), params_key="params",
        step=boot if boot is not None else steps[0])
    eng = _engine(state, slots=2)
    rl = sv.HotReloader(_sched(eng), str(tmp_path), like=_like(params),
                        params_key="params", current_step=step, **kw)
    return eng, rl, state


class TestHotReloader:
    def test_reload_swaps_and_events_carry_phases(self, versions, params,
                                                  tmp_path):
        eng, rl, _ = _booted(versions, params, tmp_path, 100, 200)
        assert rl.scheduler.weights_step == 100  # seeded at boot
        with _EventTap() as tap:
            out = rl.maybe_reload()
        assert out.ok and out.step == 200 and out.from_step == 100
        assert rl.current_step == 200 and rl.previous_step == 100
        assert eng.weights_version == 1 and rl.scheduler.weights_step == 200
        assert _sd_equal(eng.params, versions(0.2))
        (loaded,) = tap.of("serving_weights_loaded")
        assert loaded["step"] == 200 and loaded["bytes"] > 0
        assert loaded["duration_s"] >= 0 and loaded["format_version"] == 1
        (swapped,) = tap.of("serving_weights_swapped")
        assert swapped["step"] == 200 and swapped["from_step"] == 100
        assert swapped["rollback"] is False
        for phase in ("restore_s", "validate_s", "swap_s"):
            assert swapped[phase] >= 0
        assert rl.maybe_reload() is None         # steady state: no-op
        assert rl.stats["reloads"] == 1

    def test_corrupt_candidate_refused_old_weights_bit_exact(
            self, versions, params, tmp_path):
        eng, rl, _ = _booted(versions, params, tmp_path, 100)
        before = {k: v.clone() for k, v in eng.params.items()}
        probe = _prompt(seed=5)
        logits = eng.prefill(0, probe).clone()
        eng.reset()
        _save_versions(tmp_path, versions, 200)
        tfi.corrupt_checkpoint(
            os.path.join(str(tmp_path), _ckpt._step_dirname(200)))
        with _EventTap() as tap:
            out = rl.reload(step=200)
        assert not out.ok and out.reason
        assert rl.current_step == 100 and not rl.can_rollback
        assert eng.weights_version == 0
        assert _sd_equal(eng.params, before)
        assert torch.equal(eng.prefill(0, probe), logits)
        eng.reset()
        (failed,) = tap.of("serving_reload_failed")
        assert failed["step"] == 200 and failed["serving_step"] == 100

        _save_versions(tmp_path, versions, 300)
        d = os.path.join(str(tmp_path), _ckpt._step_dirname(300))
        with open(os.path.join(d, "data.bin"), "r+b") as f:
            f.truncate(os.path.getsize(os.path.join(d, "data.bin")) - 1)
        assert not rl.reload(step=300).ok
        assert _sd_equal(eng.params, before)
        assert rl.stats["refusals"] == 2
        assert rl.watcher.poll() == 300          # re-offered until repaired
        rz.save_checkpoint(str(tmp_path), 300, {"params": versions(0.3)})
        out = rl.maybe_reload()
        assert out.ok and out.step == 300 and rl.current_step == 300

    def test_spec_mismatch_refused_not_raised(self, versions, params,
                                              tmp_path):
        wrong = {k: torch.zeros(tuple(v.shape) + (1,), dtype=v.dtype)
                 for k, v in params.items()}
        rz.save_checkpoint(str(tmp_path / "wrong"), 200, {"params": wrong})
        eng, _, _ = _booted(versions, params, tmp_path, 100)
        rl = sv.HotReloader(_sched(eng), str(tmp_path / "wrong"),
                            like=_like(wrong), params_key="params")
        out = rl.reload(step=200)
        assert not out.ok and "leaf" in out.reason
        assert eng.weights_version == 0

    def test_rollback_bit_exact_and_toggles(self, versions, params,
                                            tmp_path):
        eng, rl, boot = _booted(versions, params, tmp_path, 100, 200)
        original = {k: v.clone() for k, v in boot.items()}
        served = eng.params
        with pytest.raises(RuntimeError):
            rl.rollback()                        # nothing to roll back to
        assert rl.reload(step=200).ok
        with _EventTap() as tap:
            rb = rl.rollback()
        assert rb.ok and rb.rollback and rb.step == 100
        assert rl.current_step == 100 and rl.previous_step == 200
        assert _sd_equal(eng.params, original)   # bit-exact
        assert all(eng.params[k] is served[k] for k in served)  # the buffer
        (ev,) = tap.of("serving_weights_swapped")
        assert ev["rollback"] is True and ev["step"] == 100
        assert "restore_s" not in ev and "validate_s" not in ev
        rb2 = rl.rollback()                      # toggles back forward
        assert rb2.ok and rb2.step == 200
        assert eng.weights_version == 3

    def test_rollback_discards_staged_prefetch(self, versions, params,
                                               tmp_path):
        eng, rl, boot = _booted(versions, params, tmp_path, 100, 200, 300)
        original = {k: v.clone() for k, v in boot.items()}
        assert rl.reload(step=200).ok
        assert rl.prefetch(step=300) == 300
        assert rl.staged_step == 300
        rb = rl.rollback()
        assert rb.ok and rb.rollback and rb.step == 100
        assert rl.staged_step is None
        assert rl.stats["discarded_stages"] == 1
        assert _sd_equal(eng.params, original)

    def test_retry_policy_wraps_transient_io_only(self, versions, params,
                                                  tmp_path):
        _save_versions(tmp_path, versions, 100, 200)
        tfi.corrupt_checkpoint(
            os.path.join(str(tmp_path), _ckpt._step_dirname(200)), seed=1)
        eng, rl, _ = _booted(versions, params, tmp_path, 100,
                             retry=rz.RetryPolicy(max_attempts=3))
        with _EventTap() as tap:
            out = rl.reload(step=200)
        assert not out.ok
        assert tap.of("retry_attempt") == []     # no retries burned

    def test_transient_restore_error_is_retried(self, versions, params,
                                                tmp_path, monkeypatch):
        eng, rl, _ = _booted(versions, params, tmp_path, 100, 200,
                             retry=rz.RetryPolicy(max_attempts=3,
                                                  base_delay_s=0.0))
        from apex_tpu_torch.serving import reload as rl_mod

        real = rl_mod.load_serving_params
        fails = [1]

        def flaky(*a, **k):
            if fails:
                fails.pop()
                raise OSError("UNAVAILABLE: storage blip")
            return real(*a, **k)

        monkeypatch.setattr(rl_mod, "load_serving_params", flaky)
        with _EventTap() as tap:
            out = rl.reload(step=200)
        assert out.ok
        assert [e["what"] for e in tap.of("retry_attempt")] == \
            ["serving_reload"]
        assert len(tap.of("retry_recovered")) == 1


class TestPrefetch:
    def test_prefetch_stages_and_reload_consumes_without_reading_disk(
            self, versions, params, tmp_path):
        eng, rl, _ = _booted(versions, params, tmp_path, 100, 200)
        assert rl.staged_step is None
        assert rl.prefetch() == 200
        assert rl.staged_step == 200 and rl.stats["prefetches"] == 1
        assert rl.prefetch(step=200) == 200      # idempotent
        assert rl.stats["prefetches"] == 1
        tfi.corrupt_checkpoint(
            os.path.join(str(tmp_path), _ckpt._step_dirname(200)), seed=3)
        with _EventTap() as tap:
            out = rl.reload(step=200)
        assert out.ok and out.step == 200 and rl.staged_step is None
        assert _sd_equal(eng.params, versions(0.2))
        (ev,) = tap.of("serving_weights_swapped")
        assert ev["prefetched"] is True
        assert ev["restore_s"] > 0 and out.restore_s > 0

    def test_stale_stage_discarded_on_mismatched_target(
            self, versions, params, tmp_path):
        eng, rl, _ = _booted(versions, params, tmp_path, 100, 200, 300)
        assert rl.prefetch(step=200) == 200
        with _EventTap() as tap:
            out = rl.reload(step=300)
        assert out.ok and out.step == 300 and rl.staged_step is None
        assert _sd_equal(eng.params, versions(0.3))
        (ev,) = tap.of("serving_weights_swapped")
        assert ev["prefetched"] is False

    def test_prefetch_failure_is_none_not_a_refusal(
            self, versions, params, tmp_path):
        eng, rl, _ = _booted(versions, params, tmp_path, 100, 200)
        tfi.corrupt_checkpoint(
            os.path.join(str(tmp_path), _ckpt._step_dirname(200)), seed=4)
        with _EventTap() as tap:
            assert rl.prefetch(step=200) is None
        assert rl.staged_step is None and rl.stats["prefetches"] == 0
        assert rl.stats["refusals"] == 0
        assert tap.of("serving_reload_failed") == []
        assert not rl.reload(step=200).ok
        assert rl.stats["refusals"] == 1

    def test_prefetch_no_committed_step_is_none(self, versions, params,
                                                tmp_path):
        eng, _, _ = _booted(versions, params, tmp_path, 100)
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        rl = sv.HotReloader(_sched(eng), empty, like=_like(params),
                            params_key="params", current_step=100)
        assert rl.prefetch() is None and rl.staged_step is None


# ---------------------------------------------------------------------------
# the acceptance run: reload mid-stream under bursty open-loop load
# ---------------------------------------------------------------------------


def _run_workload_with_swap(boot, new, *, swap_step, paged=False,
                            prefix=False):
    eng = _engine(boot, paged=paged)
    kw = {}
    if prefix:
        kw["prefix_caching"] = sv.PrefixCacheConfig(block_size=16,
                                                    max_tokens=2048)
    sched = _sched(eng, **kw)
    swapped = []

    def hook(step, scheduler):
        if step == swap_step:
            swapped.append(sched.swap_weights(new))

    out = sv.LoadGenerator(sched, _workload(), step_time_s=0.05,
                           step_hook=hook).run()
    assert out.rejected == []
    return out, eng, swapped


def _jax_run_with_swap(jax_model, new_delta, *, swap_step):
    jmodel, params = jax_model
    eng = jsv.DecodeEngine(jmodel, params, slots=4, max_len=MAX,
                           prefill_len=16)
    sched = jsv.ContinuousBatchingScheduler(eng, max_queue=16,
                                            clock=jsv.VirtualClock())
    new = _mutated(params, new_delta)

    def hook(step, scheduler):
        if step == swap_step:
            sched.swap_weights(new)

    return jsv.LoadGenerator(sched, _workload(jsv), step_time_s=0.05,
                             step_hook=hook).run()


class TestAcceptanceRun:
    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_mid_stream_swap_zero_dropped_streams(self, params, params_v2,
                                                  paged):
        out, eng, swapped = _run_workload_with_swap(
            params, params_v2, swap_step=2, paged=paged)
        assert len(swapped) == 1 and eng.weights_version == 1
        assert len(out.results) == 6             # ZERO dropped streams
        for r in out.results.values():
            assert r.finish_reason in ("eos", "length") and r.tokens
        out2, _, _ = _run_workload_with_swap(params, params_v2,
                                             swap_step=2, paged=paged)
        assert {k: v.tokens for k, v in out.results.items()} == \
               {k: v.tokens for k, v in out2.results.items()}

    def test_paged_and_dense_streams_identical_across_swap(self, params,
                                                           params_v2):
        dense, _, _ = _run_workload_with_swap(params, params_v2,
                                              swap_step=2)
        paged, _, _ = _run_workload_with_swap(params, params_v2,
                                              swap_step=2, paged=True)
        assert {k: v.tokens for k, v in dense.results.items()} == \
               {k: v.tokens for k, v in paged.results.items()}

    def test_mid_stream_swap_streams_equal_jax(self, jax_model, params,
                                               params_v2):
        """The same workload, the same swap at the same step: the port's
        streams, finish reasons and latencies are JAX's."""
        out, _, _ = _run_workload_with_swap(params, params_v2, swap_step=2)
        ref = _jax_run_with_swap(jax_model, 0.05, swap_step=2)
        assert set(out.results) == set(ref.results)
        for rid, r in out.results.items():
            j = ref.results[rid]
            assert (r.tokens, r.finish_reason, r.ttft_s, r.total_s) == \
                (list(j.tokens), j.finish_reason, j.ttft_s, j.total_s), rid

    def test_swap_actually_changes_streams(self, params, params_v2):
        swapped, _, _ = _run_workload_with_swap(params, params_v2,
                                                swap_step=1)
        plain = sv.LoadGenerator(_sched(_engine(params)), _workload(),
                                 step_time_s=0.05).run()
        assert {k: v.tokens for k, v in swapped.results.items()} != \
               {k: v.tokens for k, v in plain.results.items()}

    def test_async_publisher_racing_live_drain(self, versions, params,
                                               tmp_path):
        root = str(tmp_path)
        _save_versions(tmp_path, versions, 100)
        boot, _ = sv.load_serving_params(root, _like(params),
                                         params_key="params")
        eng = _engine(boot)
        sched = _sched(eng)
        ac = rz.AsyncCheckpointer(rz.CheckpointManager(root, keep=8))
        rl = sv.HotReloader(
            sched, root, like=_like(params), params_key="params",
            watcher=sv.WeightWatcher(root, checkpointer=ac),
            current_step=100)

        def hook(step, scheduler):
            if step == 1:                        # training publishes...
                ac.save(200, {"params": versions(0.2)})
            rl.maybe_reload()                    # ...serving polls

        out = sv.LoadGenerator(sched, _workload(), step_time_s=0.05,
                               step_hook=hook).run()
        ac.wait()
        final = rl.maybe_reload()                # commit may land late
        assert rl.current_step == 200
        assert final is None or final.ok
        assert len(out.results) == 6
        for r in out.results.values():
            assert r.finish_reason in ("eos", "length")

    def test_reload_storm_under_overload(self, versions, params, tmp_path):
        root = str(tmp_path)
        _save_versions(tmp_path, versions, 100, 200, 300)
        boot, _ = sv.load_serving_params(root, _like(params),
                                         params_key="params", step=100)
        eng = _engine(boot, slots=2)
        sched = sv.ContinuousBatchingScheduler(eng, max_queue=3,
                                               clock=sv.VirtualClock())
        rl = sv.HotReloader(sched, root, like=_like(params),
                            params_key="params", current_step=100)
        storm = tfi.ReloadStorm(range(0, 30, 2), reloader=rl, force=True)
        wl = sv.make_workload(
            sv.zero_overlap_prompts(10, length=8, vocab=CFG["vocab_size"]),
            sv.burst_arrivals(10, burst=5, period_s=0.1), max_new_tokens=6)
        out = sv.LoadGenerator(sched, wl, step_time_s=0.05,
                               step_hook=sv.chain_hooks(None, storm)).run()
        assert len(storm.outcomes) >= 3
        oks = [o for o in storm.outcomes if o is not None and o.ok]
        assert len(oks) >= 1
        assert eng.weights_version == len(oks)
        for r in out.results.values():
            assert r.finish_reason in ("eos", "length")
        assert len(out.results) + len(out.rejected) == 10
        assert sched.queue_depth == 0 and sched.active_count == 0
        sched.close()


class TestDegradedStart:
    def test_boot_falls_back_then_hot_reload_picks_up_repair(
            self, versions, params, tmp_path):
        root = str(tmp_path)
        _save_versions(tmp_path, versions, 1, 2)
        tfi.corrupt_checkpoint(os.path.join(root, _ckpt._step_dirname(2)))
        with _EventTap() as tap:
            boot, step = sv.load_serving_params(root, _like(params),
                                                params_key="params")
        assert step == 1                         # degraded: newest is bad
        assert len(tap.of("checkpoint_rejected")) >= 1
        (loaded,) = tap.of("serving_weights_loaded")
        assert loaded["step"] == 1
        eng = _engine(boot, slots=2)
        rl = sv.HotReloader(_sched(eng), root, like=_like(params),
                            params_key="params", current_step=step)
        assert rl.watcher.poll() == 2            # still offered
        assert not rl.reload(step=2).ok          # still corrupt: refused
        rz.save_checkpoint(root, 2, {"params": versions(0.002)})
        out = rl.maybe_reload()                  # repaired: picked up
        assert out.ok and out.step == 2 and rl.current_step == 2


# ---------------------------------------------------------------------------
# prefix-cache version invalidation
# ---------------------------------------------------------------------------


def _kv_region(seed, n):
    hd = CFG["hidden_size"] // CFG["num_attention_heads"]
    g = torch.Generator().manual_seed(seed)
    shape = (CFG["num_hidden_layers"], n, CFG["num_key_value_heads"], hd)
    return torch.randn(shape, generator=g), torch.randn(shape, generator=g)


class TestPrefixCacheInvalidation:
    def test_bump_version_invalidates_match_and_reclaims(self):
        pc = PrefixCache(block_size=4, max_tokens=64)
        a = pc.put(PrefixCache.ROOT, [1, 2, 3, 4], *_kv_region(0, 4))
        pc.put(a.chain, [5, 6, 7, 8], *_kv_region(1, 4))
        probe = [1, 2, 3, 4, 5, 6, 7, 8, 9]
        assert pc.match(probe)[0] == 8
        assert pc.bump_version() == 1 and pc.version == 1
        assert pc.match(probe)[0] == 0           # stale: unmatchable
        assert pc.stale_entries == 0 and pc.stats()["version"] == 1

    def test_stale_pinned_entry_survives_then_drains(self):
        pc = PrefixCache(block_size=4, max_tokens=64)
        a = pc.put(PrefixCache.ROOT, [1, 2, 3, 4], *_kv_region(0, 4))
        pc.acquire([a])                          # a live pre-swap stream
        pc.bump_version()
        assert pc.stale_entries == 1
        assert pc.match([1, 2, 3, 4, 5])[0] == 0
        pc.release([a])
        pc.bump_version()
        assert pc.stale_entries == 0

    def test_scheduler_swap_bumps_version_and_recaches(self, params,
                                                       params_v2):
        shared = sv.shared_prefix_prompts(4, shared_len=32, suffix_len=4,
                                          vocab=CFG["vocab_size"])
        sched = _sched(_engine(params), prefix_caching=sv.PrefixCacheConfig(
            block_size=16, max_tokens=2048))
        for i in range(2):
            sched.submit(sv.Request(f"a{i}", shared[i], max_new_tokens=4))
            sched.run()
        stats = sched.prefix_cache.stats()
        assert stats["hits"] >= 1
        v0 = stats["version"]
        sched.swap_weights(params_v2)
        assert sched.prefix_cache.stats()["version"] == v0 + 1
        for i in range(2, 4):
            sched.submit(sv.Request(f"a{i}", shared[i], max_new_tokens=4))
            sched.run()
        assert sched.prefix_cache.stats()["hits"] >= 2
        cs = _sched(_engine(params_v2, slots=2))
        cs.submit(sv.Request("a3", shared[3], max_new_tokens=4))
        assert sched.results["a3"].tokens == cs.run()["a3"].tokens

    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_stream_admitted_before_a_swap_never_offers_blocks(
            self, params, params_v2, paged):
        """The hybrid-block rule: a stream mid-prefill at the swap caches
        its remaining prompt rows under the new weights over pre-swap
        context, so it offers nothing; the next same-prompt admission
        misses and caches clean new-weights blocks."""
        prompt = _prompt(seed=7, n=64)
        sched = sv.ContinuousBatchingScheduler(
            _engine(params, paged=paged, slots=2), max_queue=4,
            prefill_budget=16, clock=sv.VirtualClock(),
            prefix_caching=sv.PrefixCacheConfig(block_size=16,
                                                max_tokens=2048))
        sched.submit(sv.Request("pre", prompt, max_new_tokens=2))
        sched.step()                              # one 16-token chunk
        assert sched.prefix_cache.stats()["inserted"] == 1
        sched.swap_weights(params_v2)
        sched.run()
        st = sched.prefix_cache.stats()
        # the three blocks prefilled after the swap were never offered;
        # the pre-swap block is stale (pinned through the swap)
        assert st["inserted"] == 1 and st["stale_entries"] == 1
        sched.submit(sv.Request("post", prompt, max_new_tokens=2))
        with _EventTap() as tap:
            sched.run()
        assert tap.of("serving_prefix_miss") and not tap.of(
            "serving_prefix_hit")
        assert sched.prefix_cache.stats()["inserted"] == 5
        cs = _sched(_engine(params_v2, slots=2))
        cs.submit(sv.Request("post", prompt, max_new_tokens=2))
        assert sched.results["post"].tokens == cs.run()["post"].tokens
        sched.close()


# ---------------------------------------------------------------------------
# shadow / A-B serving
# ---------------------------------------------------------------------------


class TestShadowAB:
    def test_assign_arm_deterministic_fraction_and_jaxs(self):
        got = [sv.assign_arm(f"r{i}", fraction=0.25, seed=7)
               for i in range(400)]
        assert got == [jsv.assign_arm(f"r{i}", fraction=0.25, seed=7)
                       for i in range(400)]
        assert 0.15 < sum(got) / len(got) < 0.35
        assert got != [sv.assign_arm(f"r{i}", fraction=0.25, seed=8)
                       for i in range(400)]
        assert not any(sv.assign_arm(f"r{i}", fraction=0.0)
                       for i in range(50))
        assert all(sv.assign_arm(f"r{i}", fraction=1.0) for i in range(50))
        with pytest.raises(ValueError):
            sv.assign_arm("r", fraction=1.5)

    def _ab(self, primary_params, shadow_params, fraction=0.5, seed=0,
            model=None):
        clk = sv.VirtualClock()
        primary = _sched(_engine(primary_params, model=model), clk)
        shadow = _sched(_engine(shadow_params, model=model), clk)
        return sv.ShadowABScheduler(primary, shadow,
                                    sv.ABConfig(fraction=fraction, seed=seed))

    def test_identical_weights_arms_emit_identical_streams(self, params):
        ab = self._ab(params, params)
        out = sv.LoadGenerator(ab, _workload(), step_time_s=0.05).run()
        assert ab.mirrored_rids and ab.mirror_shed == 0
        for rid in ab.mirrored_rids:
            assert out.results[rid].tokens == \
                ab.shadow.results["shadow:" + rid].tokens

    def test_seed_deterministic_mirror_and_arm_reports_reconcile(
            self, jax_model, params, params_v2):
        runs = []
        for _ in range(2):
            model = _model(params)
            ab = self._ab(None, None, fraction=0.5, seed=3, model=model)
            ab.shadow.swap_weights(params_v2, step=300)   # one shared module
            rec = rt.RequestTraceRecorder(clock=ab.clock).install()
            try:
                out = sv.LoadGenerator(ab, _workload(),
                                       step_time_s=0.05).run()
            finally:
                rec.uninstall()
            runs.append((ab, rec, out))
        (ab1, rec1, out1), (ab2, _, _) = runs
        assert ab1.mirrored_rids == ab2.mirrored_rids
        # the JAX facade mirrors the same rids for the same workload
        jmodel, jparams = jax_model
        clk = jsv.VirtualClock()
        jab = jsv.ShadowABScheduler(*[
            jsv.ContinuousBatchingScheduler(
                jsv.DecodeEngine(jmodel, p, slots=4, max_len=MAX,
                                 prefill_len=16), max_queue=16, clock=clk)
            for p in (jparams, _mutated(jparams, 0.05))],
            jsv.ABConfig(fraction=0.5, seed=3))
        jout = jsv.LoadGenerator(jab, _workload(jsv), step_time_s=0.05).run()
        assert jab.mirrored_rids == ab1.mirrored_rids
        for rid, r in out1.results.items():
            assert r.tokens == list(jout.results[rid].tokens), rid
        for rid in ab1.mirrored_rids:
            assert ab1.shadow.results["shadow:" + rid].tokens == \
                list(jab.shadow.results["shadow:" + rid].tokens)
        n_mirror = len(ab1.mirrored_rids)
        assert 0 < n_mirror < 6
        arms = ab1.arm_records(rec1.records())
        assert len(arms["candidate"]) == len(arms["incumbent"]) == n_mirror
        assert sorted(r.rid for r in arms["incumbent"]) == \
            sorted(ab1.mirrored_rids)
        reports = ab1.arm_reports(rec1.records(), deadlines=out1.deadlines,
                                  arrivals=out1.arrivals,
                                  duration_s=out1.duration_s)
        for arm in ("incumbent", "candidate"):
            assert reports[arm].completed == reports[arm].offered == n_mirror
        assert [rid for rid in ab1.mirrored_rids
                if out1.results[rid].tokens
                != ab1.shadow.results["shadow:" + rid].tokens]

    def test_users_only_see_incumbent_and_shadow_shed_is_silent(
            self, params, params_v2):
        clk = sv.VirtualClock()
        primary = _sched(_engine(params), clk)
        shadow = sv.ContinuousBatchingScheduler(
            _engine(params_v2, slots=2), max_queue=1, clock=clk)
        ab = sv.ShadowABScheduler(primary, shadow,
                                  sv.ABConfig(fraction=1.0, seed=0))
        wl = _workload(n=6, burst=6)
        out = sv.LoadGenerator(ab, wl, step_time_s=0.05).run()
        assert out.rejected == [] and len(out.results) == 6
        assert ab.mirror_shed > 0
        assert set(out.results) == {r.rid for r in wl.requests}
        assert not any(r.startswith("shadow:") for r in out.results)

    def test_facade_rejects_mismatched_construction(self, params):
        clk = sv.VirtualClock()
        a = _sched(_engine(params), clk)
        b = _sched(_engine(params), sv.VirtualClock())
        with pytest.raises(ValueError):
            sv.ShadowABScheduler(a, b, sv.ABConfig())
        with pytest.raises(ValueError):
            sv.ShadowABScheduler(a, a, sv.ABConfig())
        with pytest.raises(ValueError):
            sv.ABConfig(fraction=2.0)
        with pytest.raises(ValueError):
            sv.ABConfig(mirror_prefix="")


# ---------------------------------------------------------------------------
# observability, default-off identity, and the events against JAX's
# ---------------------------------------------------------------------------


#: fields that read a wall clock or a package's own texts and paths
_UNCOMPARED = ("time", "duration_s", "reason", "path", "offsets")


def _reload_lifecycle(pkg, root, like, *, jax_model=None):
    """The reload run both packages serve: boot on 100, a workload on a
    virtual clock with a reload of 200 at step 1, a refused (corrupt)
    300 at step 3 and a rollback at step 5."""
    psv, prz, log, obs = pkg
    obs.metrics.reset()
    events = []
    log.add_event_sink(events.append)
    try:
        boot, step = psv.load_serving_params(root, like, params_key="params",
                                             step=100)
        if jax_model is not None:
            eng = jsv.DecodeEngine(jax_model[0], boot, slots=4, max_len=MAX,
                                   prefill_len=16)
        else:
            eng = _engine(boot)
        clk = psv.VirtualClock()
        sched = psv.ContinuousBatchingScheduler(eng, max_queue=16, clock=clk)
        rl = psv.HotReloader(sched, root, like=like, params_key="params",
                             current_step=step, clock=clk)
        outcomes = []

        def hook(i, scheduler):
            if i == 1:
                outcomes.append(rl.reload(step=200))
            elif i == 3:
                outcomes.append(rl.reload(step=300))
            elif i == 5:
                outcomes.append(rl.rollback())

        out = psv.LoadGenerator(sched, _workload(psv), step_time_s=0.05,
                                step_hook=hook).run()
    finally:
        log.remove_event_sink(events.append)
    snap = {k: v for k, v in obs.snapshot().items()
            if k.startswith("apex_serving_") or k == "apex_events_total"}
    return out, outcomes, events, snap


def test_reload_events_and_metrics_equal_jax(jax_model, versions, params,
                                             tmp_path):
    _, jparams = jax_model
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    for s in (100, 200, 300):
        jrz.save_checkpoint(jroot, s, {"params": _mutated(jparams, s / 1e3)})
    _save_versions(troot, versions, 100, 200, 300)
    jfi.FaultInjector(jfi.FaultPlan(seed=0)).corrupt_checkpoint(
        os.path.join(jroot, _ckpt._step_dirname(300)))
    tfi.corrupt_checkpoint(os.path.join(troot, _ckpt._step_dirname(300)))
    jout, jouts, jev, jsnap = _reload_lifecycle(
        (jsv, jrz, jlog, jobs), jroot, {"params": jparams},
        jax_model=jax_model)
    tout, touts, tev, tsnap = _reload_lifecycle(
        (sv, rz, tlog, tobs), troot, _like(params))
    assert [(o.ok, o.step, o.from_step, o.version, o.rollback)
            for o in touts] == [(o.ok, o.step, o.from_step, o.version,
                                 o.rollback) for o in jouts]
    assert [o.ok for o in touts] == [True, False, True]
    for rid, r in tout.results.items():
        assert r.tokens == list(jout.results[rid].tokens), rid

    def scrub(events):
        return [{k: v for k, v in e.items() if k not in _UNCOMPARED}
                for e in events]

    assert scrub(tev) == scrub(jev)
    kinds = {e["event"] for e in tev}
    assert {"serving_weights_loaded", "serving_weights_swapped",
            "serving_reload_failed", "checkpoint_rejected"} <= kinds
    finished = [e for e in tev if e["event"] == "serving_request_finished"]
    assert {e["weights_step"] for e in finished} <= {100, 200}
    # the reload-phase histogram's buckets hold wall times: its counts
    # are compared, every other series whole
    hist = "apex_serving_reload_duration_seconds"
    assert [(s["labels"], s["count"]) for s in tsnap.pop(hist)["series"]] \
        == [(s["labels"], s["count"]) for s in jsnap.pop(hist)["series"]]
    jsnap.pop("apex_serving_decode_compiles", None)
    tsnap.pop("apex_serving_decode_compiles", None)
    assert tsnap == jsnap


class TestObservability:
    def test_loaded_and_swapped_events_feed_metrics(self, versions, params,
                                                    tmp_path):
        _save_versions(tmp_path, versions, 100, 200)
        restore0 = obs_bridge.SERVING_RELOAD_DURATION.count(phase="restore")
        boot, _ = sv.load_serving_params(str(tmp_path), _like(params),
                                         params_key="params", step=100)
        assert obs_bridge.SERVING_WEIGHTS_STEP.value() == 100
        assert obs_bridge.SERVING_RELOAD_DURATION.count(
            phase="restore") == restore0 + 1
        rl = sv.HotReloader(_sched(_engine(boot, slots=2)), str(tmp_path),
                            like=_like(params), params_key="params",
                            current_step=100)
        val0 = obs_bridge.SERVING_RELOAD_DURATION.count(phase="validate")
        swap0 = obs_bridge.SERVING_RELOAD_DURATION.count(phase="swap")
        assert rl.reload(step=200).ok
        assert obs_bridge.SERVING_WEIGHTS_STEP.value() == 200
        assert obs_bridge.SERVING_RELOAD_DURATION.count(
            phase="validate") == val0 + 1
        assert obs_bridge.SERVING_RELOAD_DURATION.count(
            phase="swap") == swap0 + 1
        rl.rollback()
        assert obs_bridge.SERVING_WEIGHTS_STEP.value() == 100
        assert obs_bridge.SERVING_RELOAD_DURATION.count(
            phase="validate") == val0 + 1
        assert obs_bridge.SERVING_RELOAD_DURATION.count(
            phase="swap") == swap0 + 2

    def test_default_off_byte_identity(self, params):
        step0 = obs_bridge.SERVING_WEIGHTS_STEP.value()
        hist0 = sum(obs_bridge.SERVING_RELOAD_DURATION.count(phase=p)
                    for p in ("restore", "validate", "swap"))

        def run():
            eng = _engine(params)
            with _EventTap() as tap:
                out = sv.LoadGenerator(_sched(eng), _workload(),
                                       step_time_s=0.05).run()
            return eng, tap.events, out

        eng1, ev1, out1 = run()
        _, ev2, out2 = run()
        assert eng1.weights_version == 0
        for kind in ("serving_weights_loaded", "serving_weights_swapped",
                     "serving_reload_failed"):
            assert [e for e in ev1 if e.get("event") == kind] == []

        def scrub(events):
            drop = ("time", "duration_s", "dispatch_s", "restore_s")
            return [{k: v for k, v in e.items() if k not in drop}
                    for e in events]

        assert scrub(ev1) == scrub(ev2)
        assert {k: v.tokens for k, v in out1.results.items()} == \
               {k: v.tokens for k, v in out2.results.items()}
        assert obs_bridge.SERVING_WEIGHTS_STEP.value() == step0
        assert sum(obs_bridge.SERVING_RELOAD_DURATION.count(phase=p)
                   for p in ("restore", "validate", "swap")) == hist0
