"""Serving for the Llama family on one card (counterpart of
``apex_tpu.serving``, its single-chip path): :class:`DecodeEngine` over a
dense (:mod:`~apex_tpu_torch.serving.kv_cache`) or paged
(:mod:`~apex_tpu_torch.serving.paged_kv_cache`) KV cache, fp or int8
(:mod:`~apex_tpu_torch.serving.quant`), and
:class:`ContinuousBatchingScheduler` on top, with cross-request prefix
caching (:mod:`~apex_tpu_torch.serving.prefix_cache`), speculative
decoding (:mod:`~apex_tpu_torch.serving.draft`), the control plane
(:mod:`~apex_tpu_torch.serving.policy`) and an open-loop load generator
(:mod:`~apex_tpu_torch.serving.loadgen`).  The weight lifecycle sits on
top: :func:`load_serving_params` (:mod:`.weights`) boots from the newest
valid checkpoint, :class:`HotReloader` (:mod:`.reload`) swaps a newer
committed one in at a step boundary and rolls it back,
:class:`ShadowABScheduler` mirrors traffic to a candidate arm,
:class:`FleetRouter` (:mod:`.fleet`) serves N replicas with health checks
and failover, and :class:`RollingReloadController` (:mod:`.rollout`)
upgrades a fleet replica by replica behind a canary.

The engine, scheduler and load generator emit the JAX package's
``serving_*`` and ``loadgen_*`` events through
:func:`~apex_tpu_torch._logging.emit_event`; :mod:`apex_tpu_torch.obs`
turns them into metrics (``prometheus_text()``), per-request records
(:class:`~apex_tpu_torch.obs.RequestTraceRecorder`) and p50/p95/p99
TTFT / TPOT / queue-wait and goodput reports
(:func:`~apex_tpu_torch.obs.build_report`).  The serving faults a load
run can inject through ``step_hook=`` are in
:mod:`apex_tpu_torch.resilience.fault_injection`."""

from apex_tpu_torch.serving.draft import SpeculationConfig, adapt_k, propose
from apex_tpu_torch.serving.engine import (
    DecodeEngine,
    ShardSlice,
    TPConfig,
    default_draft_buckets,
    default_prefill_buckets,
    token_seed,
    tp_param_shardings,
)
from apex_tpu_torch.serving.fleet import FleetConfig, FleetRouter, ReplicaState
from apex_tpu_torch.serving.kv_cache import (
    KVCache,
    QuantKVCache,
    append_token,
    init_cache,
    init_quant_cache,
    prefill_into_slot,
    read_slot_region,
    release_slot,
    valid_token_mask,
    value_dtype,
    write_slot_region,
)
from apex_tpu_torch.serving.loadgen import (
    LoadGenerator,
    LoadgenResult,
    OpenLoopWorkload,
    VirtualClock,
    burst_arrivals,
    chain_hooks,
    make_workload,
    mixed_length_prompts,
    poisson_arrivals,
    shared_prefix_prompts,
    uniform_arrivals,
    zero_overlap_prompts,
)
from apex_tpu_torch.serving.paged_kv_cache import (
    BlockPoolExhausted,
    PagedCacheConfig,
    PagedCacheManager,
    PagedKVCache,
    QuantPagedKVCache,
    blocks_per_slot,
    bytes_per_block,
    init_paged_cache,
    init_quant_paged_cache,
)
from apex_tpu_torch.serving.policy import SchedulingPolicy, WeightedRoundRobin
from apex_tpu_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig
from apex_tpu_torch.serving.quant import (
    QTensor,
    QuantConfig,
    QuantLinear,
    dequant_params,
    evaluate_quant,
    is_quantized,
    kv_bytes_per_token,
    max_logit_error,
    param_bytes,
    quantize_params,
    quantized_allreduce,
    serving_param_spec,
    stream_agreement,
)
from apex_tpu_torch.serving.reload import (
    ABConfig,
    HotReloader,
    ReloadOutcome,
    ShadowABScheduler,
    WeightWatcher,
    assign_arm,
)
from apex_tpu_torch.serving.rollout import (
    CanaryGate,
    CanaryVerdict,
    RollingReloadController,
    RolloutConfig,
)
from apex_tpu_torch.serving.scheduler import (
    SERVED_REASONS,
    ContinuousBatchingScheduler,
    QueueFull,
    Request,
    RequestPhase,
    RequestResult,
    SchedulerStalled,
    StreamExport,
)
from apex_tpu_torch.serving.weights import load_serving_params

__all__ = ["DecodeEngine", "default_draft_buckets", "default_prefill_buckets",
           "token_seed", "KVCache", "QuantKVCache", "init_cache",
           "init_quant_cache", "value_dtype", "BlockPoolExhausted",
           "PagedCacheConfig", "PagedCacheManager", "PagedKVCache",
           "QuantPagedKVCache", "blocks_per_slot", "bytes_per_block",
           "init_paged_cache", "init_quant_paged_cache", "PrefixCache",
           "PrefixCacheConfig", "QTensor", "QuantConfig", "QuantLinear",
           "dequant_params", "evaluate_quant", "is_quantized",
           "kv_bytes_per_token", "max_logit_error", "param_bytes",
           "quantize_params", "stream_agreement", "SpeculationConfig",
           "adapt_k", "propose", "ContinuousBatchingScheduler", "QueueFull",
           "Request", "RequestPhase", "RequestResult", "SchedulerStalled",
           "StreamExport", "SchedulingPolicy", "WeightedRoundRobin",
           "SERVED_REASONS", "LoadGenerator", "LoadgenResult",
           "OpenLoopWorkload", "VirtualClock", "burst_arrivals",
           "chain_hooks", "make_workload", "mixed_length_prompts",
           "poisson_arrivals", "shared_prefix_prompts", "uniform_arrivals",
           "zero_overlap_prompts", "FleetConfig", "FleetRouter",
           "ReplicaState", "ABConfig", "HotReloader", "ReloadOutcome",
           "ShadowABScheduler", "WeightWatcher", "assign_arm", "CanaryGate",
           "CanaryVerdict", "RollingReloadController", "RolloutConfig",
           "load_serving_params", "TPConfig", "ShardSlice",
           "tp_param_shardings", "quantized_allreduce", "serving_param_spec",
           "append_token", "prefill_into_slot", "read_slot_region",
           "release_slot", "valid_token_mask", "write_slot_region"]
