"""The port's serving stack on the observability layer, against JAX's.

The model is a small JAX ``LlamaForCausalLM`` (2 layers, hidden 64, 4
heads over 2 kv heads, vocab 128, fp32) carried to the port by
``models/convert.py``.  Both schedulers serve the same workloads on a
``VirtualClock`` (a fixed step a scheduler step, so every decision and
every latency is a function of the workload alone):

- **Event-stream parity.** A bursty open-loop run with chunked prompts,
  prefix caching and speculation, then the chaos run of the JAX control
  plane tests (priorities, tenants, deadlines, slow steps and a cancel
  storm) under a policy and under FIFO.  Every event equals JAX's field
  for field apart from ``time``.  The one difference is the verify
  ordering fix: a verify that finishes its request emits
  ``serving_spec_verify`` before the ``serving_request_finished`` it
  causes, where JAX emits the finish first; the JAX stream is put in the
  port's order before comparing, and the number of moved events is
  asserted.  Where a stream parts from JAX's, that rid's later events
  would be left out; no stream parts here, and the test asserts it.  The
  ``apex_serving_*`` and ``apex_events_total`` snapshots equal JAX's
  apart from ``apex_serving_decode_compiles``, which the port never sets
  (nothing compiles; ``apex_serving_tp_size`` is never set on either
  side without tensor parallelism).
- **Reconciliation** (the JAX ``TestReconciliation`` cases): the
  recorder's records against the scheduler's results and the raw events,
  the speculation annotations included, which the JAX reference fails.
- **Default-off identity** (both JAX files' cases), and token streams
  equal with the telemetry on and off.
- **Chaos** (the JAX ``TestChaosFaults`` and ``TestChaosAcceptance``,
  without the compile-count case: the port compiles nothing).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu import _logging as jlog
from apex_tpu import obs as jobs
from apex_tpu import serving as jsv
from apex_tpu.models import LlamaConfig as JaxLlamaConfig
from apex_tpu.models import LlamaForCausalLM as JaxLlama
from apex_tpu.resilience import fault_injection as jfi
from apex_tpu_torch import _logging as tlog
from apex_tpu_torch import obs as tobs
from apex_tpu_torch import serving as sv
from apex_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_params_from_jax,
)
from apex_tpu_torch.obs import request_trace as rt
from apex_tpu_torch.obs import slo as oslo
from apex_tpu_torch.obs.request_trace import PHASE_SUM_TOLERANCE_S
from apex_tpu_torch.resilience import fault_injection as tfi

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MAX = 96
PREFILL = 16
#: the unset gauge: the port compiles nothing
UNSET = ("apex_serving_decode_compiles",)

JAX = dict(logging=jlog, obs=jobs, sv=jsv, fi=jfi)
PORT = dict(logging=tlog, obs=tobs, sv=sv, fi=tfi)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(JaxLlamaConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tmodel.config))
    return jmodel, params, tmodel


def _engine(pkg, models, *, slots, prefill_len, paged=False):
    jmodel, params, tmodel = models
    psv = pkg["sv"]
    kw = dict(slots=slots, max_len=MAX, prefill_len=prefill_len,
              paged=psv.PagedCacheConfig(block_size=16) if paged else None)
    if pkg is JAX:
        return jsv.DecodeEngine(jmodel, params, **kw)
    return sv.DecodeEngine(tmodel, device="cpu", **kw)


def _prompt(seed, n=8):
    return [int(x) for x in np.random.default_rng(seed).integers(0, 128, n)]


def _serving_metric_state(obs):
    """The serving slice of a package's default registry snapshot."""
    return {name: entry for name, entry in obs.snapshot().items()
            if name.startswith("apex_serving_")
            or name == "apex_events_total"}


def _observed(pkg, run):
    """``run(events)`` under a zeroed registry with a capture sink;
    returns (its result, the events, the serving metric snapshot)."""
    events = []
    pkg["logging"].add_event_sink(events.append)
    pkg["obs"].metrics.reset()
    try:
        out = run(events)
    finally:
        pkg["logging"].remove_event_sink(events.append)
    return out, events, _serving_metric_state(pkg["obs"])


# ---------------------------------------------------------------------------
# the parity runs (shared by every test below that reads them)
# ---------------------------------------------------------------------------

def _drained_run(pkg, models, *, paged=False):
    """The JAX reconciliation run: 8 requests sharing a 32-token prefix
    (two cache blocks) with unique 4-token tails, chunked at 16, in two
    bursts of 4 so the second queues; prefix caching and speculation
    (``max_draft`` 2) on, 4 slots; dense, or paged in blocks of 16."""
    psv = pkg["sv"]
    eng = _engine(pkg, models, slots=4, prefill_len=PREFILL, paged=paged)
    clk = psv.VirtualClock()
    sched = psv.ContinuousBatchingScheduler(
        eng, log_interval=4, clock=clk,
        speculation=psv.SpeculationConfig(max_draft=2),
        prefix_caching=psv.PrefixCacheConfig(max_tokens=1 << 14))
    prompts = psv.shared_prefix_prompts(8, shared_len=32, suffix_len=4,
                                        vocab=128, seed=5)
    wl = psv.make_workload(
        prompts, psv.burst_arrivals(8, burst=4, period_s=0.5),
        max_new_tokens=6, deadline_s=64.0, seed=5)
    rec = pkg["obs"].RequestTraceRecorder(clock=clk)

    def run(events):
        rec.install()
        try:
            return psv.LoadGenerator(sched, wl, step_time_s=0.25).run()
        finally:
            rec.uninstall()

    out, events, snap = _observed(pkg, run)
    sched.close()
    return dict(sched=sched, out=out, events=events, rec=rec, snap=snap)


class Chaos:
    """The JAX chaos acceptance workload: two bursts of 5, the second
    carrying two priority-5 ``paid`` requests that land while both slots
    decode priority-0 ``batch`` streams; deadlines 4 s from arrival; slow
    steps 3 and 9 (1.0 virtual s each)."""

    N = 10
    PRIORITIES = (0, 0, 0, 0, 0, 5, 0, 5, 0, 0)
    TENANTS = ("batch",) * 5 + ("paid", "batch", "paid", "batch", "batch")
    HI = (5, 7)

    @classmethod
    def workload(cls, psv):
        prompts = [_prompt(100 + i) for i in range(cls.N)]
        return psv.make_workload(
            prompts, psv.burst_arrivals(cls.N, burst=5, period_s=2.0),
            max_new_tokens=6, deadline_s=4.0, priorities=cls.PRIORITIES,
            tenants=cls.TENANTS, rid_prefix="cx")

    @classmethod
    def drive(cls, pkg, eng, policy, *, storm=False):
        psv, fi = pkg["sv"], pkg["fi"]
        eng.reset()
        clk = psv.VirtualClock()
        sched = psv.ContinuousBatchingScheduler(
            eng, max_queue=16, policy=policy, clock=clk, log_interval=8)
        hooks = [fi.SlowDecodeStep([3, 9], 1.0, clock=clk)]
        if storm:
            hooks.append(fi.CancelStorm([12], count=1, seed=1))
        rec = pkg["obs"].RequestTraceRecorder(clock=clk)

        def run(events):
            rec.install()
            try:
                return psv.LoadGenerator(
                    sched, cls.workload(psv), step_time_s=0.25,
                    step_hook=psv.chain_hooks(*hooks)).run()
            finally:
                rec.uninstall()

        out, events, snap = _observed(pkg, run)
        return dict(sched=sched, out=out, events=events, rec=rec, snap=snap,
                    hooks=hooks)


@pytest.fixture(scope="module")
def drained(models):
    return {"jax": _drained_run(JAX, models),
            "port": _drained_run(PORT, models)}


@pytest.fixture(scope="module")
def drained_paged(models):
    return {"jax": _drained_run(JAX, models, paged=True),
            "port": _drained_run(PORT, models, paged=True)}


@pytest.fixture(scope="module")
def chaos_engines(models):
    return {"jax": _engine(JAX, models, slots=2, prefill_len=32),
            "port": _engine(PORT, models, slots=2, prefill_len=32)}


@pytest.fixture(scope="module")
def chaos(chaos_engines):
    """FIFO and policy chaos runs, both packages; the policy run also
    takes a one-request cancel storm at step 12."""
    runs = {}
    for side, pkg in (("jax", JAX), ("port", PORT)):
        eng = chaos_engines[side]
        runs[side] = {
            "fifo": Chaos.drive(pkg, eng, None),
            "policy": Chaos.drive(
                pkg, eng,
                pkg["sv"].SchedulingPolicy(tenant_weights={"paid": 3.0}),
                storm=True)}
    return runs


def _reordered(events):
    """JAX's stream in the port's order: each ``serving_spec_verify``
    that JAX emitted right after the ``serving_request_finished`` it
    caused moves before it.  Returns (stream, moved count)."""
    out = list(events)
    moved = 0
    for i in range(1, len(out)):
        e, prev = out[i], out[i - 1]
        if (e["event"] == "serving_spec_verify"
                and prev["event"] == "serving_request_finished"
                and prev["rid"] == e["rid"]):
            out[i - 1], out[i] = e, prev
            moved += 1
    return out, moved


def _strip(events):
    return [{k: v for k, v in e.items() if k != "time"} for e in events]


def _parted(jout, tout):
    return sorted(rid for rid, res in tout.results.items()
                  if res.tokens != jout.results[rid].tokens)


def _assert_stream_parity(jrun, trun, *, moved):
    assert _parted(jrun["out"], trun["out"]) == []   # no stream parts
    jstream, n = _reordered(jrun["events"])
    assert n == moved
    assert _strip(trun["events"]) == _strip(jstream)
    jsnap = {k: v for k, v in jrun["snap"].items() if k not in UNSET}
    tsnap = dict(trun["snap"])
    for name in UNSET:
        assert not tsnap.pop(name)["series"], name
    assert tsnap == jsnap


# ---------------------------------------------------------------------------
# event-stream and metric parity
# ---------------------------------------------------------------------------

class TestEventParity:
    @pytest.mark.parametrize("form", ["dense", "paged"])
    def test_drained_run_events_and_metrics_equal_jax(self, form, request):
        runs = request.getfixturevalue(
            "drained" if form == "dense" else "drained_paged")
        jrun, trun = runs["jax"], runs["port"]
        kinds = {e["event"] for e in trun["events"]}
        assert {"serving_prefix_hit", "serving_prefix_miss",
                "serving_spec_verify", "serving_prefill_chunk",
                "serving_step", "loadgen_started",
                "loadgen_finished"} <= kinds
        if form == "paged":
            assert "serving_block_alias" in kinds
            assert "apex_serving_block_pool_utilization" in trun["snap"]
        _, moved = _reordered(jrun["events"])
        assert moved >= 1                  # the ordering fix is exercised
        _assert_stream_parity(jrun, trun, moved=moved)

    @pytest.mark.parametrize("form", ["fifo", "policy"])
    def test_chaos_run_events_and_metrics_equal_jax(self, chaos, form):
        jrun, trun = chaos["jax"][form], chaos["port"][form]
        kinds = {e["event"] for e in trun["events"]}
        assert "fault_injected" in kinds
        if form == "policy":
            assert {"serving_request_preempted", "serving_request_resumed",
                    "serving_request_shed",
                    "serving_request_cancelled"} <= kinds
        _assert_stream_parity(jrun, trun, moved=0)
        assert (trun["sched"].control_stats
                == {k: getattr(jrun["sched"], f"_{k}_total")
                    for k in ("preempted", "resumed", "cancelled", "shed")})

    def test_named_scheduler_events_and_metrics_equal_jax(self,
                                                          chaos_engines):
        """``name=`` stamps ``replica`` on every event and dual-writes the
        per-step gauges and replica-scoped instruments, as in JAX."""
        runs = {}
        for side, pkg in (("jax", JAX), ("port", PORT)):
            psv, eng = pkg["sv"], chaos_engines[side]
            eng.reset()
            sched = psv.ContinuousBatchingScheduler(
                eng, clock=psv.VirtualClock(), name="r0", log_interval=4,
                policy=psv.SchedulingPolicy())
            wl = psv.make_workload([_prompt(i) for i in range(4)],
                                   (0.0, 0.0, 0.5, 0.5), max_new_tokens=4,
                                   priorities=[0, 0, 5, 0],
                                   deadline_s=8.0)

            def run(events):
                return psv.LoadGenerator(sched, wl, step_time_s=0.25).run()

            out, events, snap = _observed(pkg, run)
            runs[side] = dict(out=out, events=events, snap=snap)
        trun = runs["port"]
        assert all(e.get("replica") == "r0" for e in trun["events"]
                   if e["event"].startswith("serving_"))
        ttft = trun["snap"]["apex_serving_ttft_seconds"]["series"]
        assert [s["labels"] for s in ttft] == [{}, {"replica": "r0"}]
        assert ttft[0]["count"] == ttft[1]["count"] == 4
        _assert_stream_parity(runs["jax"], trun, moved=0)

    def test_events_total_counts_every_emitted_kind(self, drained, chaos):
        for trun in [drained["port"], chaos["port"]["policy"]]:
            counts = {}
            for e in trun["events"]:
                counts[e["event"]] = counts.get(e["event"], 0) + 1
            series = trun["snap"]["apex_events_total"]["series"]
            assert {s["labels"]["event"]: s["value"]
                    for s in series} == counts

    def test_reference_recorder_drops_what_the_port_keeps(self, drained):
        """The cause of the JAX reconciliation failure, pinned: the JAX
        recorder loses exactly the verifies emitted after their finish;
        the port's records count every one."""
        jrun, trun = drained["jax"], drained["port"]
        _, moved = _reordered(jrun["events"])
        jspec = sum(r.spec.get("dispatches", 0)
                    for r in jrun["rec"].records())
        tspec = sum(r.spec.get("dispatches", 0)
                    for r in trun["rec"].records())
        assert tspec == trun["sched"].spec_stats["dispatches"]
        assert jspec == tspec - moved


class TestOrdering:
    def test_verify_event_precedes_the_finish_it_causes(self, drained):
        events = drained["port"]["events"]
        finished_at = {e["rid"]: i for i, e in enumerate(events)
                       if e["event"] == "serving_request_finished"}
        caused = 0
        for i, e in enumerate(events):
            if e["event"] != "serving_spec_verify":
                continue
            assert i < finished_at[e["rid"]]
            caused += finished_at[e["rid"]] == i + 1
        assert caused >= 1


class TestEngineEvents:
    def test_quant_events_equal_jax(self, models):
        """``serving_quant_enabled`` at an int8 engine's construction, dense
        and paged, and ``evaluate_quant``'s ``serving_quant_eval``, with
        the JAX payloads; then the bridge's quant metrics."""
        rng = np.random.default_rng(3)
        ref, got = rng.integers(0, 128, 20).tolist(), rng.integers(0, 128,
                                                                   20).tolist()
        logits = rng.standard_normal((2, 20, 128)).astype(np.float32)
        streams = {}
        for side, pkg in (("jax", JAX), ("port", PORT)):
            psv, events = pkg["sv"], []
            pkg["logging"].add_event_sink(events.append)
            pkg["obs"].metrics.reset()
            try:
                for paged in (False, True):
                    kw = dict(slots=1, max_len=MAX, prefill_len=PREFILL,
                              quant=psv.QuantConfig(),
                              paged=(psv.PagedCacheConfig(block_size=16)
                                     if paged else None))
                    if side == "jax":
                        jsv.DecodeEngine(models[0], models[1], **kw)
                    else:
                        sv.DecodeEngine(models[2], device="cpu", **kw)
                psv.evaluate_quant(ref, got, ref_logits=logits[0],
                                   quant_logits=logits[1],
                                   bytes_per_token=1234.0,
                                   fp_bytes_per_token=4321.0)
            finally:
                pkg["logging"].remove_event_sink(events.append)
            streams[side] = (_strip(events),
                             {k: v for k, v in pkg["obs"].snapshot().items()
                              if k.startswith("apex_serving_quant")})
        assert [e["event"] for e in streams["port"][0]] == [
            "serving_quant_enabled", "serving_quant_enabled",
            "serving_quant_eval"]
        assert streams["port"] == streams["jax"]

    def test_block_cow_event_counts_the_copies(self, models):
        """A fork's first decode copies the shared tail block once: one
        ``serving_block_cow`` with ``blocks`` 1, as ``cow_copies``
        counts, and the bridge's copy-on-write counter."""
        eng = sv.DecodeEngine(models[2], device="cpu", slots=2, max_len=MAX,
                              prefill_len=PREFILL,
                              paged=sv.PagedCacheConfig(block_size=16))
        events = []
        tlog.add_event_sink(events.append)
        before = tobs.bridge.SERVING_BLOCK_COW.value()
        try:
            eng.prefill(0, _prompt(4, 40))
            eng.fork_slot(0, 1)
            for _ in range(3):
                eng.decode(np.array([1, 2]), [True, True])
        finally:
            tlog.remove_event_sink(events.append)
        cow = [e for e in events if e["event"] == "serving_block_cow"]
        assert [e["blocks"] for e in cow] == [1] == [eng.cow_copies]
        assert tobs.bridge.SERVING_BLOCK_COW.value() == before + 1


# ---------------------------------------------------------------------------
# reconciliation: the recorder against the scheduler and the event stream
# ---------------------------------------------------------------------------

class TestReconciliation:
    @pytest.fixture
    def run(self, drained):
        r = drained["port"]
        return r["sched"], r["out"], r["rec"], r["events"]

    def test_every_request_one_complete_record(self, run):
        sched, out, rec, _ = run
        records = rec.records()
        assert out.completed == out.offered == 8
        assert {r.rid for r in records} == set(out.results)
        assert len(records) == 8 and not rec.open_records()
        for record in records:
            assert record.complete
            res = out.results[record.rid]
            assert record.new_tokens == len(res.tokens)
            assert record.prompt_tokens == 36
            assert record.finish_reason == res.finish_reason
            assert record.slot is not None

    def test_phase_durations_sum_to_total(self, run):
        _, out, rec, _ = run
        for record in rec.records():
            total = (record.queue_wait_s + record.prefill_s
                     + record.decode_s)
            assert abs(total - record.total_s) <= PHASE_SUM_TOLERANCE_S
            res = out.results[record.rid]
            assert record.ttft_s == pytest.approx(res.ttft_s, abs=1e-6)
            assert record.total_s == pytest.approx(res.total_s, abs=1e-6)
            assert record.scheduler_ttft_s == res.ttft_s
        assert any(r.queue_wait_s > 0 for r in rec.records())

    def test_chunks_cover_the_uncached_prompt(self, run):
        _, _, rec, _ = run
        for record in rec.records():
            saved = (record.prefix or {}).get("saved_tokens") or 0
            assert (sum(c["chunk_tokens"] for c in record.chunks)
                    + saved == record.prompt_tokens)
            offs = [c["offset_tokens"] for c in record.chunks]
            assert offs == sorted(offs)
            if record.chunks:
                assert record.chunks[0]["offset_tokens"] == saved

    def test_prefix_annotations_match_event_stream(self, run):
        sched, _, rec, events = run
        hits = {e["rid"]: e for e in events
                if e["event"] == "serving_prefix_hit"}
        misses = {e["rid"] for e in events
                  if e["event"] == "serving_prefix_miss"}
        assert hits and misses
        for record in rec.records():
            if record.rid in hits:
                assert record.prefix["hit"] is True
                assert (record.prefix["saved_tokens"]
                        == hits[record.rid]["saved_tokens"])
            elif record.rid in misses:
                assert record.prefix == {"hit": False}
        stats = sched.stats()
        assert (stats["prefix_hits"], stats["prefix_misses"]) == (
            len(hits), len(misses))
        assert stats["prefix_saved_tokens"] == sum(
            e["saved_tokens"] for e in hits.values())

    def test_spec_annotations_match_event_stream(self, run):
        """The case the JAX reference fails (its recorder drops a verify
        emitted after its request's finish); the port's order keeps it."""
        sched, _, rec, events = run
        keys = ("dispatches", "drafted", "accepted", "emitted")
        per_rid = {}
        for e in events:
            if e["event"] == "serving_spec_verify":
                st = per_rid.setdefault(e["rid"], dict.fromkeys(keys, 0))
                st["dispatches"] += 1
                for f in keys[1:]:
                    st[f] += e[f]
        for record in rec.records():
            got = {k: record.spec.get(k, 0) for k in keys}
            assert got == per_rid.get(record.rid, dict.fromkeys(keys, 0))
        records = rec.records()
        for key in keys:
            assert (sum(r.spec.get(key, 0) for r in records)
                    == sched.spec_stats[key])

    def test_chrome_trace_one_track_per_request(self, run, tmp_path):
        _, _, rec, _ = run
        payload = rec.export(str(tmp_path / "req.trace.json"))
        loaded = json.loads((tmp_path / "req.trace.json").read_text())
        assert loaded == payload
        events = loaded["traceEvents"]
        names = {e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e["name"] == "thread_name"}
        assert names == {r.rid for r in rec.records()}
        by_tid = {}
        for e in events:
            if e.get("ph") == "X":
                by_tid.setdefault(e["tid"], []).append(e)
        assert len(by_tid) == 8
        for slices in by_tid.values():
            by_name = {e["name"]: e for e in slices}
            req = by_name["request"]
            for e in slices:
                assert e["ts"] >= req["ts"] - 1e-6
                assert e["ts"] + e["dur"] <= req["ts"] + req["dur"] + 1e-6
            assert {"queued", "prefill", "decode"} <= set(by_name)

    def test_jsonl_export_round_trips(self, run, tmp_path):
        _, _, rec, _ = run
        path = tmp_path / "req.jsonl"
        n = rec.export_jsonl(str(path))
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        assert n == len(rows) == 8
        for row, record in zip(rows, rec.records()):
            assert row["rid"] == record.rid
            assert row["total_s"] == record.total_s

    def test_slo_report_over_the_run(self, run):
        _, out, rec, _ = run
        report = oslo.build_report(rec.records(), offered=out.offered,
                                   deadlines=out.deadlines,
                                   arrivals=out.arrivals,
                                   duration_s=out.duration_s)
        assert report.completed == 8 and report.incomplete == 0
        assert report.goodput == out.goodput == 1.0
        ttft = sorted(r.ttft_s for r in rec.records())
        assert report.ttft["p50"] == ttft[math.ceil(0.5 * 8) - 1]
        assert report.ttft["p99"] == ttft[-1]
        d = report.to_dict()
        assert d["goodput"] == 1.0 and d["ttft_s"]["n"] == 8

    def test_histograms_crosscheck_the_exact_samples(self, drained):
        trun = drained["port"]
        rec = trun["rec"]
        ttft = [r.ttft_s for r in rec.records()]
        hist = tobs.Histogram("apex_unit_ttft_seconds")
        for v in ttft:
            hist.observe(v)
        assert oslo.crosscheck_quantiles(ttft, hist)["aligned"]
        series = trun["snap"]["apex_serving_ttft_seconds"]["series"]
        assert series[0]["count"] == len(ttft)
        assert series[0]["sum"] == pytest.approx(sum(ttft))


# ---------------------------------------------------------------------------
# default-off identity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _engine_mod(models):
    return _engine(PORT, models, slots=4, prefill_len=PREFILL)


@pytest.fixture
def engine(_engine_mod):
    _engine_mod.reset()
    return _engine_mod


@pytest.fixture(scope="module")
def _eng1_mod(models):
    return _engine(PORT, models, slots=1, prefill_len=32)


@pytest.fixture(scope="module")
def isolated_tokens(_eng1_mod):
    """``fn(request) -> tokens``: the request served alone by a FIFO
    scheduler on a single-slot engine."""
    eng = _eng1_mod
    memo = {}

    def run(request):
        key = (tuple(request.prompt), request.max_new_tokens,
               request.eos_id, request.temperature, request.top_k,
               request.seed)
        if key not in memo:
            eng.reset()
            sched = sv.ContinuousBatchingScheduler(eng, max_queue=4)
            sched.submit(sv.Request("ref", request.prompt,
                                    max_new_tokens=request.max_new_tokens,
                                    eos_id=request.eos_id,
                                    temperature=request.temperature,
                                    top_k=request.top_k, seed=request.seed))
            memo[key] = sched.run()["ref"].tokens
        return memo[key]

    return run


def _sched(engine, clock, **kw):
    return sv.ContinuousBatchingScheduler(engine, log_interval=10 ** 9,
                                          clock=clock, **kw)


class TestDefaultOffIdentity:
    def test_no_recorder_no_new_events_same_metrics(self, engine):
        """Recorder on against off: the event stream (kinds and rids, in
        order) and the serving metrics are equal; the recorder only
        reads."""
        def one_run(install_recorder):
            engine.reset()
            clk = sv.VirtualClock()
            sched = _sched(engine, clk)
            prompts = sv.zero_overlap_prompts(5, length=6, vocab=128, seed=9)
            wl = sv.make_workload(
                prompts, sv.burst_arrivals(5, burst=2, period_s=1.0),
                max_new_tokens=3, seed=9)
            seen = []
            tlog.add_event_sink(seen.append)
            rec = (rt.RequestTraceRecorder(clock=clk).install()
                   if install_recorder else None)
            tobs.metrics.reset()
            try:
                sv.LoadGenerator(sched, wl, step_time_s=0.25).run()
            finally:
                if rec is not None:
                    rec.uninstall()
                tlog.remove_event_sink(seen.append)
            return ([(e["event"], e.get("rid")) for e in seen],
                    _serving_metric_state(tobs))

        stream_off, metrics_off = one_run(False)
        stream_on, metrics_on = one_run(True)
        assert stream_on == stream_off
        assert metrics_on == metrics_off

    def test_queue_wait_histogram_fed(self, engine):
        before = tobs.bridge.SERVING_QUEUE_WAIT.count()
        sched = _sched(engine, sv.VirtualClock())
        wl = sv.make_workload([[1, 2, 3]], (0.0,), max_new_tokens=1)
        sv.LoadGenerator(sched, wl, step_time_s=0.25).run()
        assert tobs.bridge.SERVING_QUEUE_WAIT.count() == before + 1

    def test_goodput_gauge_only_with_deadlines(self, engine):
        tobs.bridge.SERVING_GOODPUT.set(-1.0)        # sentinel
        wl = sv.make_workload([[1, 2, 3]], (0.0,), max_new_tokens=1)
        sv.LoadGenerator(_sched(engine, sv.VirtualClock()), wl,
                         step_time_s=0.25).run()
        assert tobs.bridge.SERVING_GOODPUT.value() == -1.0
        engine.reset()
        wl = sv.make_workload([[1, 2, 3]], (0.0,), max_new_tokens=1,
                              deadline_s=10.0)
        out = sv.LoadGenerator(_sched(engine, sv.VirtualClock()), wl,
                               step_time_s=0.25).run()
        assert out.goodput == 1.0
        assert tobs.bridge.SERVING_GOODPUT.value() == 1.0

    def test_policy_annotations_inert_without_policy(self, engine):
        """The same workload with control-plane annotations (priorities,
        deadlines, tenants) and without, through policy-less schedulers:
        equal event streams (kind, rid, payload keys), serving metrics
        (the deadline run's goodput gauge aside) and tokens, and no
        control-plane event."""
        def one_run(annotated):
            engine.reset()
            sched = sv.ContinuousBatchingScheduler(engine, max_queue=8,
                                                   clock=sv.VirtualClock())
            prompts = [_prompt(i) for i in range(5)]
            wl = sv.make_workload(
                prompts, sv.burst_arrivals(5, burst=2, period_s=1.0),
                max_new_tokens=3,
                deadline_s=0.75 if annotated else None,
                priorities=[5, 0] if annotated else None,
                tenants=["paid", "free"] if annotated else None)
            seen = []
            tlog.add_event_sink(seen.append)
            tobs.metrics.reset()
            try:
                out = sv.LoadGenerator(sched, wl, step_time_s=0.25).run()
            finally:
                tlog.remove_event_sink(seen.append)
            stream = [(e["event"], e.get("rid"), tuple(sorted(e)))
                      for e in seen]
            tokens = {rid: r.tokens for rid, r in out.results.items()}
            return stream, _serving_metric_state(tobs), tokens

        s_plain, m_plain, t_plain = one_run(annotated=False)
        s_annot, m_annot, t_annot = one_run(annotated=True)
        assert s_annot == s_plain
        assert t_annot == t_plain
        m_annot.pop("apex_serving_goodput_ratio", None)
        m_plain.pop("apex_serving_goodput_ratio", None)
        assert m_annot == m_plain
        control = {"serving_request_preempted", "serving_request_resumed",
                   "serving_request_cancelled", "serving_request_shed"}
        assert not control & {k for k, _, _ in s_annot}

    def test_token_streams_equal_with_telemetry_off(self, engine):
        """Everything installed (bridge, recorder, span recorder, a
        capture sink) against the bridge uninstalled and nothing else:
        equal results, field for field, on a virtual clock."""
        def one_run(telemetry):
            engine.reset()
            clk = sv.VirtualClock()
            sched = sv.ContinuousBatchingScheduler(
                engine, clock=clk,
                speculation=sv.SpeculationConfig(max_draft=2),
                prefix_caching=sv.PrefixCacheConfig(),
                policy=sv.SchedulingPolicy())
            prompts = sv.shared_prefix_prompts(6, shared_len=16,
                                               suffix_len=5, vocab=128,
                                               seed=3)
            wl = sv.make_workload(prompts,
                                  sv.poisson_arrivals(6, 4.0, seed=3),
                                  max_new_tokens=6, seed=3)
            seen = []
            if telemetry:
                rec = rt.RequestTraceRecorder(clock=clk).install()
                tobs.install_recorder(tobs.TraceRecorder())
                tlog.add_event_sink(seen.append)
            else:
                tobs.bridge.uninstall()
            try:
                out = sv.LoadGenerator(sched, wl, step_time_s=0.25).run()
            finally:
                if telemetry:
                    rec.uninstall()
                    tobs.uninstall_recorder()
                    tlog.remove_event_sink(seen.append)
                else:
                    tobs.bridge.install()
            sched.close()
            return out.results, out.steps, len(seen)

        on, on_steps, n_events = one_run(True)
        off, off_steps, _ = one_run(False)
        assert tobs.bridge.installed()
        assert n_events > 0
        assert on_steps == off_steps
        assert on == off


# ---------------------------------------------------------------------------
# chaos fault units
# ---------------------------------------------------------------------------

class TestChaosFaults:
    def test_slow_decode_step_inflates_virtual_clock(self):
        clk = sv.VirtualClock()
        fault = tfi.SlowDecodeStep([1, 3], 0.5, clock=clk)
        for step in range(5):
            fault(step)
        assert clk() == 1.0
        with pytest.raises(ValueError, match="extra_s"):
            tfi.SlowDecodeStep([0], 0.0, clock=clk)
        with pytest.raises(ValueError, match="advanceable"):
            tfi.SlowDecodeStep([0], 0.5, clock=lambda: 0.0)

    def test_stall_stream_cancels_after_n_tokens(self, engine,
                                                 isolated_tokens):
        sched = sv.ContinuousBatchingScheduler(engine, max_queue=8,
                                               clock=sv.VirtualClock())
        keep = sv.Request("keep", _prompt(1), max_new_tokens=8)
        wl = sv.OpenLoopWorkload(
            requests=(keep, sv.Request("stall", _prompt(2),
                                       max_new_tokens=8)),
            arrivals=(0.0, 0.0), deadlines=(None, None))
        fault = tfi.StallStream(["stall"], after_tokens=3)
        events = []
        tlog.add_event_sink(events.append)
        try:
            out = sv.LoadGenerator(sched, wl, step_time_s=0.25,
                                   step_hook=fault).run()
        finally:
            tlog.remove_event_sink(events.append)
        assert fault.stalled == ["stall"]
        res = out.results["stall"]
        assert res.finish_reason == "cancelled"
        assert 3 <= len(res.tokens) < 8
        assert out.results["keep"].tokens == isolated_tokens(keep)
        (fault_event,) = [e for e in events if e["event"] == "fault_injected"]
        assert fault_event["fault"] == "stall_stream"
        assert fault_event["rid"] == "stall"

    def test_cancel_storm_deterministic_and_isolated(self, engine,
                                                     isolated_tokens):
        def run_storm():
            engine.reset()
            sched = sv.ContinuousBatchingScheduler(
                engine, max_queue=16, clock=sv.VirtualClock())
            prompts = [_prompt(i) for i in range(6)]
            wl = sv.make_workload(prompts, (0.0,) * 6, max_new_tokens=6,
                                  rid_prefix="s")
            storm = tfi.CancelStorm([2], count=2, seed=3)
            out = sv.LoadGenerator(sched, wl, step_time_s=0.25,
                                   step_hook=storm).run()
            return storm.cancelled, out

        hit1, out1 = run_storm()
        hit2, out2 = run_storm()
        assert hit1 == hit2 and len(hit1) == 2
        for rid in out1.results:
            assert out1.results[rid].tokens == out2.results[rid].tokens
        survivors = [r for r in out1.results.values()
                     if r.finish_reason in sv.SERVED_REASONS]
        assert survivors
        for res in survivors:
            ref = isolated_tokens(sv.Request(
                res.rid, _prompt(int(res.rid[1:])), max_new_tokens=6))
            assert res.tokens == ref

    def test_faults_choose_as_jax_faults_choose(self):
        """The storm's draws and the stall's trigger are the JAX ones."""
        class Fake:
            queued_rids = ["q1", "q0"]
            active_rids = ["a2", "a0", "a1"]

        for step in range(4):
            ours = tfi.CancelStorm([step], count=2, seed=7)
            ref = jfi.CancelStorm([step], count=2, seed=7)
            cancelled = {"t": [], "j": []}
            for fault, key in ((ours, "t"), (ref, "j")):
                fake = Fake()
                fake.cancel = cancelled[key].append
                fault(step, fake)
            assert cancelled["t"] == cancelled["j"]
            assert ours.cancelled == ref.cancelled


# ---------------------------------------------------------------------------
# the chaos acceptance run: policy against FIFO
# ---------------------------------------------------------------------------

class TestChaosAcceptance:
    @pytest.fixture
    def runs(self, chaos):
        return chaos["port"]["fifo"], chaos["port"]["policy"]

    def test_chaos_exercised_the_control_plane(self, runs):
        fifo, pol = runs
        stats = pol["sched"].control_stats
        assert stats["preempted"] >= 2, stats
        assert stats["resumed"] == stats["preempted"]
        assert stats["shed"] >= 1, stats
        assert stats["cancelled"] == len(pol["hooks"][1].cancelled) == 1
        assert fifo["sched"].control_stats == {
            "preempted": 0, "resumed": 0, "cancelled": 0, "shed": 0}

    def test_survivors_bit_identical_to_unperturbed_runs(
            self, runs, isolated_tokens):
        by_rid = {r.rid: r for r in Chaos.workload(sv).requests}
        checked = resumed = 0
        for run in runs:
            for rid, res in run["out"].results.items():
                if res.finish_reason not in sv.SERVED_REASONS:
                    continue
                assert res.tokens == isolated_tokens(by_rid[rid]), rid
                checked += 1
                resumed += res.finish_reason == "preempted-resumed"
        assert checked >= Chaos.N
        assert resumed >= 1

    def test_policy_beats_fifo_on_hp_p99_ttft_and_goodput(self, runs):
        fifo, pol = runs
        hi_rids = {f"cx{i}" for i in Chaos.HI}

        def report(run):
            out = run["out"]
            return oslo.build_report(
                run["rec"].records(), offered=out.offered,
                deadlines=out.deadlines, arrivals=out.arrivals,
                duration_s=out.duration_s)

        def hp_p99(run):
            samples = [r.ttft_s for r in run["rec"].records()
                       if r.rid in hi_rids and r.complete]
            assert len(samples) == len(hi_rids)
            return oslo.percentile(samples, 0.99)

        assert hp_p99(pol) < hp_p99(fifo)
        assert report(pol).goodput > report(fifo).goodput
        assert pol["out"].goodput > fifo["out"].goodput
        pre = [r for r in pol["rec"].records() if r.preemptions]
        assert pre and all(p["t_resumed"] is not None
                           for r in pre for p in r.preempts
                           if r.finish_reason == "preempted-resumed")

    def test_counters_reconcile_with_the_scheduler(self, runs):
        for run in runs:
            snap, stats = run["snap"], run["sched"].control_stats
            for kind in ("preempted", "cancelled", "shed"):
                series = snap[f"apex_serving_{kind}_total"]["series"]
                assert (series[0]["value"] if series else 0) == stats[kind]
