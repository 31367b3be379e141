#!/usr/bin/env python3
"""Drive apex_tpu_torch on one CUDA card: build, check, serve, measure.

    python3 chip_smoke.py
    python3 chip_smoke.py --only moe,cp   # phases of ``ALONE`` alone

Needs one NVIDIA card (Hopper, sm_90a) and ``nvcc``; imports nothing of
JAX or of ``apex_tpu``.  Four phases, each printed as it ends; any failure
ends the run with a non-zero exit and no result line:

1. **Device and build**: the card, its capability and power limit; every
   CUDA kernel of the package built from ``apex_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all started together); TF32 off for
   matrix products and convolutions.
2. **Kernels against their plain versions**: each kernel's wrapper on
   tensors on the card, over the variants the CPU tests cover, the
   kernel's other code paths, and the main path's shapes; each result
   against the plain PyTorch version on the same inputs, at the stated
   tolerance (a softmax row above the kernel's maximum must raise).  Then
   the kernel, the plain version and the library call (``F.rms_norm``, and
   ``F.layer_norm`` at GPT-2-large's, OpenFold's, BERT-large's and
   ViT-L/16's LayerNorm shapes, the last two with fp32 weights and their
   eps;
   ``F.scaled_dot_product_attention``; ``F.linear`` + ``F.cross_entropy``;
   ``torch.softmax`` and ``aten._softmax_backward_data``; none for LAMB;
   ``torch._fused_adamw_`` and ``torch._fused_adagrad_`` over one flat
   tensor for the packed Adam and Adagrad (when this PyTorch has a CUDA
   kernel for it); SDPA with the pair bias and mask fill as one float mask
   for the pair-bias kernels) timed at the main path's shapes, on the device
   (calls captured in a CUDA graph, or eager between CUDA events where a
   call moves GBs) and as the host issues them, beside the least time the
   card could take (bytes over 3.35 TB/s, or operations over the bf16 or
   fp32 peak, and for the pair-bias kernels their exponentials over the
   SFU rate: the largest).  The pair-bias kernels and the materialized
   route are also timed at the two routing shapes, N_res 256 and 1024.
   The flash forward and backward are also checked at GPT-2-large's
   flagship shape (and with the layers' dropout), BERT-large's (padding
   segment ids, not causal), GPT-1.3B's, GPT-2-medium's (the MoE
   stack's), and for the same bits on a
   repeated call at the main
   shape, and timed at both models' shapes with each kernel's TFLOP/s and
   the host side of a call.  The head forward is also checked at
   GPT-2-large's head shape (V 50257) and for the same bits on a repeated
   call, and timed at both head shapes with its TFLOP/s beside the library
   call's and cuBLAS ``torch.matmul`` on the logits product (a yardstick
   the port never calls).  The bf16/fp16 flash forward, dq, dk/dv, head
   forward and pair-bias forward kernels' SASS must hold ``HGMMA`` and
   ``UTMALDG`` and no ``HMMA``, and the flash, head and pair-bias forwards'
   libraries no ``HMMA`` at all (``cuobjdump``), with ptxas's registers and
   spills reported (the norm forward's beside them).
   The head backward is also checked at GPT-2-large's head shape, in fp16
   at the main shape, off every tile edge and for the same bits on a
   repeated call, and timed at both models' head shapes with the dH call
   split into its two kernels (``torch.profiler``) and each product's
   TFLOP/s beside cuBLAS ``torch.matmul`` on the same product (a
   yardstick the port never calls).
   The packed Adam and Adagrad kernels are checked over p fp32/bf16/fp16,
   g fp32/bf16, both modes, weight decay, ``noop`` 0 and 1 (1 must leave
   every buffer's bits) and n = 1 to past one grid stride, and checked and
   timed at Llama-1B's packed fp32 masters (1.123 B elements), before any
   model is built.
   The multi-tensor kernels (``mt_l2norm``, ``mt_scale``, ``mt_adam``,
   ``mt_lamb``; ``csrc/multi_tensor.cu``) are checked over tensor counts 1,
   3, 6 and 200 (400 chunks), sizes 1, 7, one chunk, one chunk + 1 and
   sizes not multiples of 8, an unaligned list, g/p in fp32/bf16/fp16 and
   m/v in fp32/bf16, both Adam modes, the three SWA modes with
   ``n_averaged`` 0 and 2, LAMB with and without NVLAMB, weight decay, the
   clip and a device lr, the master copy-back, ``noop`` 1 (every bit
   kept), an inf for the flags, and the same bits on a repeated
   ``mt_l2norm`` and ``mt_lamb``; then timed at the main paths' real
   parameter lists (Llama-1B bf16 and its fp16 masters form, GPT-2-large's
   unpacked LAMB, OpenFold's four blocks) beside the bytes bound, the
   plain version, the plain version captured in one CUDA graph, and the
   library's list call (``torch._fused_adamw_``,
   ``torch._amp_foreach_non_finite_check_and_unscale_``,
   ``torch._foreach_norm``), each also held against its plain version on a
   sub-list of its real list.  ``mt_lamb`` and ``mt_adam`` are also held
   on the lists of the other paths that step them (BERT-large, GPT-1.3B,
   the MoE GPT-2-medium; ViT-L/16, the mLSTM, the DCGAN's two with fp16
   masters), and ``mt_scale``'s overflow check on the DCGAN's and
   ResNet-50's O1-O3 gradients (``check_multi_tensor_model_lists``).
3. **End to end**, the paths below, each with the launch counts set to 0 just
   before it and read just after:

   - *serving*: a small fp32 Llama served on the card against the same
     weights served on the CPU (the port's plain path), dense and in each
     of the forms below (paged, int8 dense and paged, prefix-cached dense
     and paged, speculative dense and paged, under a scheduling policy
     dense and paged: streams equal, first-token logits within 1e-4, the
     speculation and control-plane counts equal, int8 weights bit for
     bit, int8 KV within one quantization step); then the
     ``llama-1b`` card at full width and depth, bf16, weights from a
     seeded ``torch.Generator`` on the card, behind ``DecodeEngine(slots=8,
     max_len=2048, prefill_len=512)`` and the FIFO scheduler: 12 greedy
     requests, prompts of 64-1024 tokens, 32 new tokens each.  In every
     serving run the norm kernel's launches must equal ``(2L+1)`` times the
     model calls (prefill chunks plus decode steps), and no other kernel
     runs.  One request rerun alone must give the same stream.  Then the
     same requests paged (``PagedCacheConfig(block_size=16)``): with the
     default pool the dense run's chunks, streams and chunk logits bit for
     bit, the pool empty after; with 8 x 64 + 1 blocks all finished within
     the pool and the longest request equal to its dense replay alone.
     Then 12 requests sharing a 1024-token prefix (tails of 64-512) with
     and without ``prefix_caching=PrefixCacheConfig(max_tokens=16384)``,
     paged (hits alias the donor's blocks) and dense (restored rows equal
     the captured ones): 11 hits, 1 miss, 11 x 1024 saved tokens,
     first-token logits within the bf16 tolerance of the alone checks and
     streams equal up to the first near tie.  Then speculation
     (``SpeculationConfig(max_draft=8)``) against plain decode, dense and
     paged, over 12 quoted-context requests (a 128-384-token passage twice,
     64 new tokens) and the 12 random ones: streams equal up to the first
     near tie, verifies counted as model calls in the launch gate, and
     ``verify_draft`` fed a plain stream's true and corrupted
     continuations (8 and 3 accepted, up to a near tie).  Then the control
     plane: an open-loop workload on a virtual clock (16 batch requests,
     then 8 priority-5 paid ones and 4 whose deadline expires in the
     queue) under ``SchedulingPolicy`` and FIFO, dense and paged: >= 1
     preempted, all resumed, the 4 shed, served streams equal to FIFO's up
     to the first near tie, the same decisions dense and paged, the paid
     p99 TTFT lower under the policy; ``close()`` frees a caching
     scheduler's pool blocks for its successor.  Then failover: 8 streams
     exported mid-decode from one dense engine and adopted by another over
     the same model, with their captured rows and requeued, streams equal
     to the uninterrupted run's up to the first near tie.  Then the
     observability layer (``phase3-serving-obs-*`` lines): the control
     plane's policy run again with a request recorder, a span recorder and
     a capture sink installed (decisions, streams and logits bit for bit
     the first run's, the same norm launches), its records, metrics,
     Perfetto export and Prometheus text reconciled with the scheduler
     and the load generator, the dense quoted speculation run's records
     against its verify events, the chaos acceptance run (slow steps, a
     stalled stream, a cancel storm; FIFO against the policy), a
     real-clock Poisson run's TTFT / TPOT / queue-wait percentiles, the
     telemetry's cost, and ``start_torch_profiler`` around three decode
     steps (the trace names the norm kernel; as many device-to-host copies
     with the telemetry on as off).  Then the weight lifecycle, on
     ``llama-1b``'s width at 4 of its 22 layers (``LIFECYCLE_LAYERS``), its
     checkpoints (0.62 GB each, at most three) in a temporary directory
     under the checkout, removed however the run ends:
     ``phase3-serving-reload`` (save and restore walls, the restore split
     into read + CRC and host-to-device; the 12 requests served while an
     ``AsyncCheckpointer`` publishes a perturbed step 200 and a
     ``HotReloader`` swaps it in at a step boundary: nothing dropped,
     ``weights_step`` 200 after, the requests admitted after the swap
     held to a fresh engine on step 200, paged = dense bit for bit across
     the swap, a one-byte-corrupt step 300 refused with the probe's logits
     bit for bit, rollback bit for bit, a prefix-cache miss after the
     version bump, a crashed writer's step never selected, the cache's
     storage unmoved, the swap's host wall and the peak memory);
     ``phase3-serving-shadow`` (``ShadowABScheduler`` at fraction 0.5:
     users' streams = the incumbent alone bit for bit, the mirrored rids
     = ``assign_arm``'s = a CPU dry run's, both arm reports);
     ``phase3-serving-fleet`` (three replicas over the shared module, 24
     requests, ``KillReplica`` and ``WedgeReplica``: the virtual numbers
     = a CPU dry run's on a 2-layer model, every stream held to the
     single-engine run); ``phase3-serving-rollout`` (a gated rolling
     reload promoted, a ``RegressingWeights`` candidate halted by the
     canary gate and rolled back, ``CorruptCandidateMidRollout`` refused,
     ``KillCanary``; verdicts and virtual numbers = the CPU's, every swap
     on an empty engine).  After the evaluation path,
     the int8 copy of the model (``QuantConfig(weights=True, kv=True)``),
     the bf16 model freed: the 12 requests served, bytes and peak memory,
     and the longest request fed the bf16 stream: max |logit error| < 0.5
     and agreement >= 0.9 where the bf16 top-2 margin exceeds 0.1.
     Before it, ``phase3-serving-tp``: tensor-parallel serving at world 1
     under an NCCL group (a ``file://`` rendezvous in a temporary
     directory, destroyed at the end): the 12 requests through
     ``DecodeEngine(tp=TPConfig(1))``, dense and paged, equal the
     ``tp=None`` dense run's streams and chunk logits bit for bit (an
     all-reduce and an all-gather of one rank are exact), under the
     norm-launch gate; the decode step's p50 with all 8 slots active under
     tp 1 against ``tp=None`` (in turns) and the collectives a step; the
     longest request fed the bf16 stream under ``QuantConfig(weights=True,
     kv=True, allreduce=True)`` (max |logit error| < 0.5, agreement
     printed); the evaluation forward at b 4, s 2048 inside the tp region
     equal to the plain one bit for bit, with its exact launches; then
     v2 checkpoints (of llama-1b at ``CUT_LAYERS`` layers): the weights
     saved on a tp-4 grid from this one process and validated, restored whole (equal to a v1 restore bit for
     bit) and served by the tp engine, rank 2-of-4's block restored alone
     (bytes read against a quarter of the sharded weights' bytes), and a
     ``CorruptShardFile``-damaged newer step passed over by the
     newest-valid walk.
   - *evaluation*: a small fp32 Llama at head dim 64, uncached logits and
     ``labels=`` loss on the card against the CPU; then the same
     ``llama-1b`` model's ``model(ids, labels=labels)`` at b 4, s 2048
     under ``inference_mode``: exactly 45 norm, 22 flash attention and 1
     LM-head launches a forward, a finite loss that agrees with
     ``F.cross_entropy`` over ``model(ids)``'s logits, the flash path
     against the cached path on one 512-token prompt, and wall, tokens/s,
     peak memory and a profile of one forward.
   - *training*: a small fp32 Llama's loss, gradients and 3 FusedAdam
     steps on the card against the CPU, and 3 steps of each of
     ``FusedSGD``, ``FusedNovoGrad``, ``FusedMixedPrecisionLamb`` and
     ``clip_grad_norm_`` + ``FusedSGD`` with their multi-tensor launches
     exact; then ``llama-1b`` (O2, bf16 moments) 1 + 6 steps at b 4, s 2048
     with exact launches a step (``mt_adam`` 1).
   - *tensor-parallel training* (``phase3-train-tp``): the same
     ``llama-1b`` step through ``examples/llama_pretrain.py``'s
     ``build_model`` / ``train_step`` under an NCCL group of world 1
     (``--tp 1``: a ``file://`` rendezvous in a temporary directory,
     destroyed at the end): a second ``tp=None`` run of 1 + 3 steps held
     against the training phase's (are two runs bit for bit?), then the
     tp-1 run (the model built in the tp region from its slice of the
     seeded init, the batch through ``tp_replicated_rows`` and
     ``broadcast_data``, the gradients and loss averaged over the dp
     group) held to the ``tp=None`` losses and every parameter bit for
     bit, or within the two ``tp=None`` runs' spread; each step's
     launches equal the ``tp=None`` step's; the mappings' collectives a
     step counted; step wall p50 against ``tp=None``, idle share, peak
     memory and the host time of the collectives and autograd applies
     from one profiled step.  Then fp16 amp O2 under ``GradScaler`` in
     the region, 1 + 4 steps, an inf written at step 2: that step keeps
     every parameter, master and moment bit for bit and halves the scale,
     with the dp average, the overflow all-reduce, the update and the
     scaler's update under ``set_sync_debug_mode("error")``.
   - *pipeline-parallel training* (``phase3-train-pp``): the same
     ``llama-1b`` model and batch (4 microbatches of 1 x 2048, row by
     row) through ``models.llama_pipeline.make_llama_3d_train_step``
     (``o2_cast`` on the stage, ``FusedAdam(state_dtype=bf16)``) at dp 1
     x pp 1 x tp 1 under an NCCL group of world 1, 1 + 3 steps with the
     1F1B schedule called directly, again, and with
     ``get_forward_backward_func(None, 1)`` (``no_pipelining``): exact
     launches a step (the 1F1B forward tick and its backward tick's
     recompute each run the stage: 2 x 45 x 4 norm forwards), no
     point-to-point call, the two 1F1B runs bit for bit, ``no_pipelining``
     within ``PP_LOSS_TOL`` (its warm-up loss within
     ``PP_WARMUP_LOSS_TOL``) while ``no_pipelining`` with microbatch 0's
     gradient dropped is not, the warm-up loss within
     ``PP_HEAD_LOSS_TOL`` of ``LlamaForCausalLM``'s (the training
     phase's) while the same head's product in bf16 is not, peak memory at 2 and 4 microbatches within
     ``PP_PEAK_TOL``; the ``torch.distributed`` calls, mapping
     collectives and walls of each step (beside the 2-d ``tp=None``
     step's, in this call), idle share and the top host rows of one
     profiled step; then fp16 amp under ``GradScaler``, 1 + 2 steps, an
     inf written after the schedule at the last, which runs whole under
     ``set_sync_debug_mode("error")``: every parameter, master and
     moment keeps its bits and the scale halves.
   - *ZeRO* (``phase3-train-zero``): ``llama-1b`` with every parameter
     bf16, b 4 x s 2048, 1 + 3 steps of ``DistributedFusedAdam(lr=1e-3,
     state_dtype=bf16, store_param_remainders=True)`` over an NCCL group
     of world 1, beside ``FusedAdam`` (fp32 masters, bf16 moments) from
     the same weights in the same call: launches a step as in training
     with no ``mt_adam`` under ZeRO, one reduce-scatter and one
     all-gather a step and no all-reduce, the fp32 masters after the
     warm-up step within ``ZERO_MASTER_TOL`` of FusedAdam's, the losses
     within ``ZERO_LOSS_TOL``, the bf16 split and merge bit for bit (over
     random words and over the state), a ``found_inf`` step that keeps
     every parameter and the whole state; step walls, peak memory.
   - *ResNet-50* (``phase3-resnet-reference``, ``phase3-train-resnet50``):
     ``resnet10_ish`` at 32^2 x 8 in fp32, 3 steps card against CPU from
     one init (``RESNET_SMALL_*_TOL``); then ``imagenet_main.
     run_training`` of ResNet-50 (b 128 x 224^2, NHWC memory) over DDP
     and SyncBatchNorm under an NCCL group of world 1, 1 + 8 steps in
     bf16 O2 and in fp16 O2 with the dynamic scaler: a loss that ends
     below where it began, ``mt_scale`` 1 a step in fp16 and no launch in
     bf16, 108 all-reduces a step (53 batch norms forward and backward, 2
     DDP buckets); images/s, step wall, MFU from the port's count of the
     convolutions' and the head's FLOPs, peak memory; one profiled bf16
     step (idle share, device time by kind); an inf written into one fp16
     gradient keeps every parameter, master and momentum bit for bit and
     halves the scale; and 3 bf16 steps with DDP + SyncBatchNorm against
     3 without either (local batch norm in the same Welford form), with
     cuDNN's deterministic algorithms: bit for bit.
   - *LARC* (``phase3-larc``): ``LARC(FusedSGD)`` over ResNet-50's
     parameter list and one step's gradients, card against CPU within
     ``LARC_TOL``, 2 ``mt_l2norm`` launches on the card.
   - *amp*: a small fp32 Llama under ``amp.initialize(..., "O2",
     half_dtype=torch.float16)`` and the dynamic scaler, 4 steps card
     against CPU (loss, ``found_inf``, scaler state at every step; masters,
     moments, parameters after), step 0 overflowing on its own and step 2
     by a written inf; then ``llama-1b`` at full width and depth in fp16
     O2, b 4, s 2048, 1 + 6 steps in three optimizer forms:
     ``FusedAdam(master_weights=True)``, ``FusedAdagrad(packed=True,
     master_weights=True)`` (the packed Adagrad kernel) and
     ``packed_adam_update`` over the masters packed once (the packed Adam
     kernel, ``noop_flag=found_inf``).  Each: exact launches a step (45/22/1
     forward, 45/22/22/1/1 backward, ``mt_scale`` 1 for the overflow check,
     ``mt_adam`` 1 in the first form and 1 packed update in the last two), the
     unscale, optimizer step and scaler update under
     ``set_sync_debug_mode("error")``, an inf written at one step which
     must keep every parameter, master, state tensor and the step counter
     bit for bit, halve the scale and leave ``unskipped``; a loss that ends
     lower than it began; step wall, issue time, real overflows, idle
     share, peak memory.
   - *GPT training*: a small fp32 GPT in both attention cores, loss,
     gradients and 3 packed FusedLAMB steps on the card against the CPU;
     then GPT-2-large (``bench.py``'s ``large`` card, O2, b 8, s 1024) 1 +
     6 steps in two forms with exact launches a step: the kernel path
     (materialized attention through the fused softmax, packed LAMB:
     73/73 norm, 36/36 softmax, 1/1/1 head, 1 LAMB phase 1, 2 ``mt_l2norm``
     and 1 ``mt_lamb``) and the flagship (flash attention, unpacked LAMB
     with bf16 moments: 73/73 norm, 36/36/36 flash, 1/1/1 head, 1
     ``mt_l2norm``, 1 ``mt_lamb``); a loss that falls every step,
     step wall, tokens/s, MFU, idle share, peak memory and a profile.
   - *BERT and ViT* (``phase3-bert-reference``, ``phase3-vit-reference``,
     ``phase3-train-bert-large``, ``phase3-train-vit-l16``): a small fp32
     BERT (flash with padding segment ids, and the fused softmax with the
     4-d mask) and a small fp32 ViT, loss, every gradient and 3 steps of
     their optimizers on the card against the CPU; then BERT-large
     (``tools/model_bench.py``'s card through ``examples/bert_pretrain.py``:
     24 x 1024, b 16 x s 512, 15% masked, lengths in [0.9 s, s], O2,
     ``FusedLAMB`` bf16 moments, over DDP at NCCL world 1) 1 + 8 steps with
     50/50 norm, 24/24/24 flash, 1 ``mt_l2norm`` and 1 ``mt_lamb`` a step,
     and ViT-L/16 (b 64 x 224^2 x 3 bf16, 1000 classes, ``FusedAdam(3e-4,
     wd 0.05)``) 1 + 4 steps with 49/49 norm and 1 ``mt_adam``: a last loss
     below the warm-up's, step wall, MFU, peak memory.
   - *activation recompute* (``phase3-train-gpt-1.3b``,
     ``phase3-train-gpt-policies``, ``phase3-train-llama-remat``):
     ``bench.py``'s ``1.3b`` card (24 x 2048, b 8 x s 1024, O2, bf16 LAMB
     moments) with whole-layer recompute beside the same model without: at
     the same weights the loss and every gradient bit for bit and the
     recompute's extra launches exactly 48 norm and 24 flash forwards; then
     1 + 4 steps of each (step p50, MFU, peak; the recompute's peak below);
     the three named policies at 4 layers of that width, each bit for bit
     with its extra launches (8 norm + 4 flash, or 8 norm for
     ``"except_activations"``); Llama at 4 layers of ``llama-1b`` with
     ``activations_checkpoint``, bit for bit, 8 norm + 4 flash extra.
   - *dropout* (``phase3-dropout``): 4 layers at GPT-2-large's width with
     hidden and attention dropout 0.1: ``deterministic=True`` equal to the
     stack without dropout bit for bit; the flash forward, dq and dk/dv
     called with the rate and each layer's seed; the dropped shares of the
     attention's probabilities and of the hidden activations within 6
     binomial deviations of 0.1; whole-layer recompute under dropout bit
     for bit.
   - *expert, context and spatial parallelism* (``phase3-moe-reference``,
     ``phase3-ring-reference``, ``phase3-train-moe``, ``phase3-train-cp``,
     ``phase3-halo``), each group an NCCL group of 1: a small fp32 MoE
     language model and the ring attention on the card against the CPU;
     GPT-2-medium's widths with every MLP 8 top-1 experts (O2,
     ``FusedLAMB`` with fp32 masters) equal bit for bit to no group, 1 + 4
     steps with exact launches, and 4 more with no group; the same widths
     with RoPE at s 8192 through the ring, against the flash path's loss
     and gradients, 1 + 4 steps; ``SpatialBottleneck`` against
     ``Bottleneck`` at ResNet-50's stride-1 blocks.  Each training phase
     also reports its threads' CPU time and a host yardstick.
   - *the Megatron GPT driver* (``phase3-megatron-reference``,
     ``phase3-megatron-gpt``): ``examples/megatron_gpt_pretrain.py``'s
     ``main`` at 2 layers on the card (NCCL) and on the CPU (gloo) from one
     init, within ``SMALL_CARD_TOL``; then at GPT-2-large's widths (36 x
     1280, s 1024, V 50304, micro-batch 4, global 8: 2 microbatches
     under ``no_pipelining``, bf16, ``FusedAdam``) 1 + 4 iterations with
     146/146 norm, 72/72/72 flash and 1 ``mt_adam`` launches each, a
     falling loss, iteration p50, MFU, peak, and one traced iteration.
   - *amp O1* (``phase3-amp-o1``): ``amp.functional``'s rules on CUDA
     tensors against the CPU's (dtypes equal, values within two half
     ulps), and ``examples/simple.py --opt-level O1 --half fp16``
     converging under the dynamic scaler.
   - *supervised* (``phase3-supervised``, ``supervised_train``): the
     ``no_pipelining`` fp16 witness (fp32 sums of 80000, no overflow),
     ``fused_dense`` / ``mlp`` card against CPU and timed at
     GPT-2-large's MLP; then llama-1b fp16 O2 through ``resilience``'s
     guarded step: an unsupervised reference of 12 steps with one
     planted inf (its leaves' CRC32 kept), the faulted run under
     ``TrainingSupervisor`` (the inf skipped and named, a corrupt batch
     skipped, a flaky fetch retried, two slow steps escalating to a
     validated emergency checkpoint under ``build/`` and
     ``TrainingAborted``), and a restart from that checkpoint that must
     end bit for bit (CRC32 of every leaf) on the reference;
     ``replica_hashes`` on the card against the CPU's; the launches of
     every step exact.
   - *the contrib zoo* (``phase3-contrib-*``, ``phase3-sparsity``):
     ``SelfMultiheadAttn`` (norm-add, bias) and ``EncdecMultiheadAttn``
     (sq 256 against sk 320) at BERT-large's widths, bf16, keys padded,
     forward and backward with flash forward, dq and dk/dv once each,
     the fast route against the default one; the masked softmax on
     ``[256, 512, 512]`` (binary and additive masks, softmax forward and
     backward once each); flash dropout's bits against the plain
     forward; ``fmha_varlen`` over 32 packed sequences against the
     plain versions and per-sequence calls, both timed beside the work
     ratio; the flash and
     softmax kernels timed at these shapes beside SDPA and the library
     softmax; card against CPU at small sizes.  The losses: smoothed
     cross-entropy on ``[8192, 32000]`` against ``F.cross_entropy`` (no
     fp32 ``[N, V]`` saved), the focal loss at RetinaNet's level 3
     against fp64, the RNN-T joint and loss at MLPerf's widths against
     float64 on two sequences.  The norms: GroupNorm at Stable
     Diffusion's UNet shapes against ``F.group_norm``, the NHWC and group
     batch norms at ResNet-50's first stage (NCCL world 1), the four
     convolution forms in bf16 and fp32, ``index_mul_2d``.  ASP on
     BERT-large: masks on the card equal to the CPU's, 3 LAMB steps
     keeping 2 of every 4, the permutation search timed on the host.
   - *RNN* (``phase3-rnn``): every cell type of ``apex_tpu_torch.RNN``,
     one-way and bidirectional, 2 layers, card against CPU (output,
     finals, every gradient within ``RNN_SMALL_TOL``); then a byte-level
     language model at Radford et al. 2017's widths (a 64-wide byte
     embedding, ``mLSTM(64, 4096)``, a 4096 -> 256 head; 256 bytes x 128,
     fp32) trained 1 + 4 steps under ``FusedAdam``: exactly 1 ``mt_adam``
     a step, a falling loss, step p50 with its forward / backward /
     update split on CUDA events, idle share, peak; and one sequence
     run in two halves through the returned hidden state against it whole.
   - *DCGAN* (``phase3-dcgan``): ``examples/dcgan_main_amp.py``'s
     ``train`` at JAX's sizes on the card and on the CPU (O0 and fp16
     O2, 4 steps); then at the DCGAN paper's widths (32 x 32 x 3, nz
     100, ngf = ndf = 64, batch 128) 20 fp16 O2 steps with three scalers:
     2 ``mt_adam`` and 3 ``mt_scale`` launches a step, finite losses and
     scales, step p50, idle share, peak; an inf written into loss 1's
     gradients keeps every discriminator bit, steps the generator and
     halves scaler 1 alone.
   - *convergence* (``phase3-convergence``):
     ``examples/imagenet_run_convergence.py``'s cross product at
     ResNet-50's width (224^2, batch 128, 1000 classes, bf16 half, 12
     steps, lr 0.05): O0 and O1-O3 x 4 loss scales, every combination
     within rtol 0.15 / atol 0.25 of O0 and falling; ``mt_scale`` once a
     step where a scale is set, nothing else; each run's wall, step p50,
     peak, and an O0 and an O2 step profiled.
   - *openfold*: a small fp32 MSA-row attention block with pair bias at
     N_res 1024 (routed to the pair-bias kernels): loss, every gradient
     (z's through the bias) and 3 ``FusedAdamSWA`` steps on the card
     against the CPU; then four such blocks at OpenFold's Evoformer widths
     (c_m 256, c_z 128, 8 heads of 32, N_seq 128, N_res 1024, bf16, 10%
     of the MSA masked) trained 1 + 6 steps under ``FusedAdamSWA``:
     exactly 4/4/4/4 pair-bias forward, dq, dk/dv and dbias, 8/8 norm
     and 1 ``mt_adam`` launches a step, a loss that falls every step, step wall, idle
     share, device time by kind, peak memory; and one block at the
     training crop (N_res 256), which routes to the materialized path:
     no pair-bias launch.
4. **Kernels line**: one JSON object with each kernel's launches on its
   main path (and on every path), error against its plain version, and
   times.

The card's name and power limit (``nvidia-smi``) are printed on the line
before the last; the last line is ``{"ok": true, "device": {...}}``.  A
fuller report goes to ``build/chip_smoke.json``.  With ``--only`` the
build and the named phases run, their report goes to
``build/chip_smoke_only.json``, and neither line is printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 rate outside tensor cores
# exp2 results a second: 16 a clock on each of the 132 SMs (the CUDA
# programming guide's throughput table, compute capability 9.0) at the
# H100 SXM's 1.98 GHz boost clock
MUFU_EXP_PER_S = 132 * 16 * 1.98e9
ROOT = os.path.dirname(os.path.abspath(__file__))


_T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One phase's line, with ``t_s``: the seconds since the script began
    (where the run's time goes)."""
    fields["t_s"] = round(time.perf_counter() - _T0, 1)
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call when the host issues calls back to back:
    CUDA events around ``iters`` calls after a warm-up.  Where the host
    issues launches slower than the card runs them, this is the host's
    rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so host overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: the norm kernel against its plain version
# ---------------------------------------------------------------------------

_MANTISSA_BITS = {"float32": 23, "bfloat16": 7, "float16": 10}


def _ulp(x, dtype_name: str):
    """One ulp of ``dtype_name`` at each |x| (subnormal spacing below)."""
    import torch

    # below the dtype's smallest normal the spacing stays that of tiny
    tiny = torch.finfo(getattr(torch, dtype_name)).tiny
    mag = x.float().abs().clamp_min(tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - _MANTISSA_BITS[dtype_name])


def _ulp_err(actual, expected, dtype_name: str) -> float:
    """Largest |actual - expected| in units of its tolerance: one ulp of
    the output dtype at the larger magnitude (subnormals included) or
    1e-5, the larger; for fp32, 1e-5 + 1e-5 |expected|."""
    import torch

    a, e = actual.float(), expected.float()
    diff = (a - e).abs()
    if dtype_name == "float32":
        return float((diff / (1e-5 + 1e-5 * e.abs())).max())
    ulp = _ulp(torch.maximum(a.abs(), e.abs()), dtype_name)
    # near zero, LayerNorm's x - mean cancels: there the two sides' fp32
    # means (summed in another order) differ by ~1e-7, which is many ulps
    # of a tiny y, so the bound is one ulp or 1e-5 absolute, the larger
    return float((diff / ulp.clamp_min(1e-5)).max())


def check_layer_norm(device) -> float:
    """Every variant on the card against the plain version; returns the
    largest absolute error of ``y`` over the main path's cases."""
    import torch
    from apex_tpu_torch.ops import layer_norm as ln

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    g = torch.Generator(device=device).manual_seed(1)
    cases = []
    for rms in (False, True):
        for xdt in dtypes:
            for has_w, has_b, wdt in ((False, False, None),
                                      (True, False, "float32"),
                                      (True, False, "bfloat16"),
                                      (True, True, "float32"),
                                      (True, True, "bfloat16"),
                                      (True, True, "float16")):
                # lane-aligned and ragged rows, an unaligned h, a row too
                # long for the registers, and an input that starts off a
                # 16-byte boundary (the scalar path)
                for n, h, offset in ((3, 128, 0), (16, 256, 0), (3, 200, 0),
                                     (16, 200, 0), (5, 5000, 0), (7, 256, 1)):
                    cases.append((rms, xdt, has_w, has_b, wdt, n, h, offset,
                                  False))
    for rms in (False, True):
        for xdt, wdt in (("bfloat16", "bfloat16"), ("float32", "float32"),
                         ("bfloat16", "float32")):
            # a decode step over 8 slots, a prefill chunk, one pipeline
            # microbatch (1 x 2048), an eval forward
            for n in (8, 512, 2048, 8192):
                cases.append((rms, xdt, True, False, wdt, n, 2048, 0, True))
    # the LayerNorms of the other paths, bf16 with a bf16 weight and bias:
    # OpenFold's pair (z, h 128) and MSA (m, h 256) rows, several to a warp,
    # and GPT-2-large's h 1280
    for n, h in NORM_LN_SHAPES.values():
        cases.append((False, "bfloat16", True, True, "bfloat16", n, h, 0, False))
    cases = [c + (1e-5,) for c in cases]
    # BERT-large's, ViT-L/16's and GPT-1.3B's LayerNorms under O2: bf16
    # rows, fp32 weight and bias, each model's eps
    for n, h, eps in NORM_LN_O2_SHAPES.values():
        cases.append((False, "bfloat16", True, True, "float32", n, h, 0, False,
                      eps))
    worst_ulp, main_abs = 0.0, 0.0
    with torch.no_grad():
        for rms, xdt, has_w, has_b, wdt, n, h, offset, main, eps in cases:
            buf = torch.randn(n * h + offset, generator=g, device=device) * 2 + 0.5
            x = buf.to(dtypes[xdt])[offset:].view(n, h)
            w = ((1 + 0.1 * torch.randn(h, generator=g, device=device))
                 .to(dtypes[wdt]) if has_w else None)
            b = ((0.1 * torch.randn(h, generator=g, device=device))
                 .to(dtypes[wdt]) if has_b else None)
            y, mean, rstd = ln.layer_norm_fwd(x, w, b, eps, rms)
            torch.cuda.synchronize()
            ry, rmean, rrstd = ln._plain_forward(x, w, b, eps, rms)
            ulp = _ulp_err(y, ry, xdt)
            stats = max(_ulp_err(mean, rmean, "float32"),
                        _ulp_err(rstd, rrstd, "float32"))
            case = dict(rms=rms, x=xdt, w=wdt if has_w else None,
                        bias=has_b, n=n, h=h, offset=offset, eps=eps)
            if ulp > 1.0 or stats > 1.0:
                raise AssertionError(
                    f"layer_norm_fwd disagrees with its plain version: "
                    f"{case}: y off by {ulp:.3f} ulp, stats by {stats:.3f} "
                    f"x (1e-5 + 1e-5 |ref|)")
            worst_ulp = max(worst_ulp, ulp)
            if main:
                main_abs = max(main_abs, float((y.float() - ry.float()).abs().max()))
    log("phase2-check", kernel="layer_norm_fwd", cases=len(cases),
        worst_y_ulp=worst_ulp, main_path_max_abs_err=main_abs,
        tolerance="y within max(1 ulp of its dtype, 1e-5) (fp32: 1e-5 + "
                  "1e-5|ref|); mean/rstd within 1e-5 + 1e-5|ref|")
    return main_abs


# the LayerNorm shapes (n, h) of the GPT and OpenFold paths: GPT-2-large's
# b 8 x s 1024 at h 1280; OpenFold's MSA rows m (N_seq 128 x N_res 1024, c_m
# 256) and pair rows z (N_res^2, c_z 128)
NORM_LN_SHAPES = {"gpt2_large": (8192, 1280), "openfold_m": (131072, 256),
                  "openfold_z": (1048576, 128)}
# (n, h, eps) of the O2 models' LayerNorms (bf16 rows, fp32 weight and
# bias): BERT-large's b 16 x s 512 (the transformer's eps 1e-5),
# ViT-L/16's b 64 x 197 tokens (eps 1e-12), GPT-1.3B's b 8 x s 1024
# (bench.py:93-98, eps 1e-5), GPT-2-large's O2 flagship (b 8 x s 1024) and
# the Megatron driver's GPT-2-large under --bf16 (micro-batch 4 x s 1024)
NORM_LN_O2_SHAPES = {"bert_large": (8192, 1024, 1e-5),
                     "vit_l16": (12608, 1024, 1e-12),
                     "gpt_1p3b": (8192, 2048, 1e-5),
                     "gpt2_large_o2": (8192, 1280, 1e-5),
                     "megatron_gpt2_large": (4096, 1280, 1e-5)}


def time_layer_norm(device):
    """Kernel, plain version and the library call at the main paths'
    shapes: RMSNorm with ``F.rms_norm`` (bf16 input, bf16 weight, h =
    2048) at n = 8 (a decode step over 8 slots), n = 512 (a full prefill
    chunk) and n = 8192 (the evaluation forward, b 4 x s 2048); LayerNorm
    with ``F.layer_norm`` (bf16 input, bf16 weight and bias) at
    ``NORM_LN_SHAPES``."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln

    rows = []
    g = torch.Generator(device=device).manual_seed(2)
    bf16, fp32 = torch.bfloat16, torch.float32
    shapes = [(None, n, 2048, True, 1e-5, bf16) for n in (8, 512, 8192)] + [
        (name, n, h, False, 1e-5, bf16)
        for name, (n, h) in NORM_LN_SHAPES.items()] + [
        (name, n, h, False, eps, fp32)
        for name, (n, h, eps) in NORM_LN_O2_SHAPES.items()]
    with torch.no_grad():
        for name, n, h, rms, eps, wdt in shapes:
            x = torch.randn(n, h, generator=g, device=device).to(torch.bfloat16)
            w = (1 + 0.1 * torch.randn(h, generator=g, device=device)).to(wdt)
            b = None if rms else (0.1 * torch.randn(h, generator=g, device=device)).to(
                wdt)
            # F.layer_norm takes a weight and bias of x's dtype only
            wl = w.to(x.dtype)
            bl = None if b is None else b.to(x.dtype)
            calls = {
                "kernel": lambda: ln.layer_norm_fwd(x, w, b, eps, rms),
                "plain": lambda: ln._plain_forward(x, w, b, eps, rms),
                "library": (lambda: F.rms_norm(x, (h,), wl, eps)) if rms else
                           (lambda: F.layer_norm(x, (h,), wl, bl, eps))}
            # device times in turns (kernel, plain, library, kernel), then
            # the host-bound back-to-back times
            dev = {k: device_ms(fn) for k, fn in calls.items()}
            kernel_again = device_ms(calls["kernel"])
            host = {k: time_ms(fn) for k, fn in calls.items()}
            # each input read once, each output written once: x, w (and
            # b); y, mean, rstd.  About 6 fp32 operations per element.
            nbytes = (2 * n * h + wdt.itemsize * h * (1 if rms else 2)
                      + 2 * n * h + 2 * 4 * n)
            ops = 6 * n * h
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops = ops / FP32_OPS_PER_S * 1e3
            rows.append(dict(
                n=n, h=h, norm="rms" if rms else "layer_norm", path=name,
                eps=eps, weight=str(wdt).replace("torch.", ""),
                grid=ln.fwd_grid(n, h, torch.bfloat16, torch.cuda.get_device_properties(
                    device).multi_processor_count),
                library_call="F.rms_norm" if rms else "F.layer_norm",
                ms=min(dev["kernel"], kernel_again),
                ms_runs=[dev["kernel"], kernel_again],
                plain_ms=dev["plain"], library_ms=dev["library"],
                host_bound_ms=host,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                bytes=nbytes))
    log("phase2-time", kernel="layer_norm_fwd", rows=rows,
        timing="ms/plain_ms/library_ms: device time, 100 calls in one CUDA "
               "graph between CUDA events; host_bound_ms: 200 eager calls "
               "back to back after 20 warm-up calls; L2-warm")
    return rows


# ---------------------------------------------------------------------------
# phase 2: the flash attention and LM-head kernels against their plain versions
# ---------------------------------------------------------------------------

_DTYPES = ("float32", "bfloat16", "float16")
# the main path's shapes: llama-1b, b 4, s 2048 (8,192 tokens)
FLASH_MAIN = dict(b=4, h=32, hk=8, s=2048, d=64)
# the pipeline phase's: one microbatch of 1 x 2048 at llama-1b
FLASH_PP = dict(FLASH_MAIN, b=1)
# GPT-2-large's flagship attention (bench.py:81-84): b 8, 20 heads of 64,
# s 1024, no GQA
FLASH_GPT = dict(b=8, h=20, hk=20, s=1024, d=64)
# BERT-large (tools/model_bench.py:175-233): b 16, 16 heads of 64, s 512,
# not causal, padding segment ids; GPT-1.3B (bench.py:93-98): b 8, 32
# heads of 64, s 1024
FLASH_BERT = dict(b=16, h=16, hk=16, s=512, d=64)
FLASH_GPT13 = dict(b=8, h=32, hk=32, s=1024, d=64)
# GPT-2-medium's (bench.py:86-89), the MoE stack's: b 8, 16 heads of 64,
# s 1024, causal
FLASH_GPT2M = dict(b=8, h=16, hk=16, s=1024, d=64)
# the model shapes of the later slices, forward and backward: BERT's
# padding, GPT-1.3B's, GPT-2-large's with the layers' attention dropout
# and the MoE stack's
FLASH_SLICE_CASES = (
    dict(FLASH_BERT, dtype="bfloat16", causal=False, sq=512, sk=512,
         seg="padding"),
    dict(FLASH_GPT13, dtype="bfloat16", causal=True, sq=1024, sk=1024),
    dict(FLASH_GPT2M, dtype="bfloat16", causal=True, sq=1024, sk=1024),
    dict(FLASH_GPT, dtype="bfloat16", causal=True, sq=1024, sk=1024,
         rate=0.1, seed=2 ** 31 - 2))
HEAD_MAIN = dict(t=8192, hid=2048, vocab=32000)
# GPT-2-large's head at b 8, s 1024 (bench.py:81-84): vocab 50257, Vp 50304
HEAD_GPT = dict(t=8192, hid=1280, vocab=50257)
# GPT-1.3B's head at b 8, s 1024 (bench.py:93-98): hid 2048, V 50304
HEAD_GPT13 = dict(t=8192, hid=2048, vocab=50304)
# GPT-2-medium's tied head, the MoE and cp stacks' (b 8 x s 1024 and b 1 x
# s 8192): hid 1024, V 50304
HEAD_GPT2M = dict(t=8192, hid=1024, vocab=50304)


def _tol_ratio(actual, expected, tol) -> float:
    """Largest |actual - expected| / tol over the finite entries of
    ``expected`` (``tol`` a number or a tensor like ``expected``); inf if a
    NaN appears or the infinite entries differ."""
    import torch

    a, e = actual.float(), expected.float()
    if torch.isnan(a).any() or torch.isnan(e).any():
        return float("inf")
    inf = torch.isinf(e)
    if not torch.equal(inf, torch.isinf(a)) or not torch.equal(a[inf], e[inf]):
        return float("inf")
    fin = ~inf
    if not fin.any():
        return 0.0
    if isinstance(tol, torch.Tensor):
        tol = tol.float()[fin]
    return float(((a[fin] - e[fin]).abs() / tol).max())


def _flash_inputs(case, g, device):
    import torch

    dt = getattr(torch, case["dtype"])
    b, h, hk, sq, sk, d = (case[k] for k in ("b", "h", "hk", "sq", "sk", "d"))

    def rand(heads, s):
        # the model's layout: [s, b, heads, d] viewed as [b, heads, s, d]
        x = torch.randn(s, b, heads, d, generator=g, device=device)
        return x.to(dt).permute(1, 2, 0, 3)

    q, k = rand(h, sq), rand(hk, sk)
    if case.get("probe"):
        # v = identity (sk == d): o reads the dropped probabilities back
        v = torch.eye(sk, d, device=device).to(dt).expand(b, hk, sk, d)
        v = v.contiguous()
    else:
        v = rand(hk, sk)
    seg = None
    if case.get("seg") == "dead":
        # queries of segment 9 see no key: o = 0, lse = +inf there
        qs = torch.ones(b, sq, dtype=torch.int32, device=device)
        qs[:, : sq // 4] = 9
        ks = torch.ones(b, sk, dtype=torch.int32, device=device)
        ks[:, sk // 2:] = 2
        seg = (qs, ks)
    elif case.get("seg") == "packed":
        seg = ((torch.arange(sq, device=device) >= sq // 3).int().expand(b, sq),
               (torch.arange(sk, device=device) >= sk // 3).int().expand(b, sk))
        seg = tuple(t.contiguous() for t in seg)
    elif case.get("seg") == "padding":
        # BERT's mask as segment ids: kept tokens 1, the pad tail 0, each
        # row's length in [0.9 s, s]
        lens = torch.randint(int(sq * 0.9), sq + 1, (b,), generator=g,
                             device=device)
        keep = (torch.arange(sq, device=device)[None, :] < lens[:, None]).int()
        seg = (keep, keep)
    return q, k, v, seg


def _flash_o_tol(q, k, v, ro, case, seg):
    """Per-element bound of the forward's ``o`` against the plain ``ro``
    on the same inputs (``case``: dtype, causal, sk, and dropout's rate and
    seed if any; ``seg`` None or a (q, kv) segment-id pair)."""
    import torch
    from apex_tpu_torch.ops import flash_attention as fa

    if case["dtype"] == "float32":
        return 1e-5 + 1e-5 * ro.float().abs()
    # the kernel rounds each (kept, rescaled) p to the operand dtype before
    # p v: at most half an epsilon of it, so the error is within half an
    # epsilon of sum_j p_ij |v_j| (the plain version on |v|, in fp32, with
    # the same keep bits); below the normal range the rounding is absolute
    # (fp16's subnormal half-spacing, fp32's flush for bf16); and each side
    # rounds o once: two ulp of the output
    rate, seed = case.get("rate", 0.0), case.get("seed")
    dt = getattr(torch, case["dtype"])
    half_eps = 2.0 ** -(_MANTISSA_BITS[case["dtype"]] + 1)
    floor = max(torch.finfo(dt).tiny * half_eps,
                torch.finfo(torch.float32).tiny)
    pv_abs, _ = fa._plain_forward(
        q.float(), k.float(), v.float().abs(), causal=case["causal"],
        q_segment_ids=None if seg is None else seg[0],
        kv_segment_ids=None if seg is None else seg[1],
        dropout_rate=rate, dropout_seed=seed)
    vmax = float(v.float().abs().max())
    return (half_eps * pv_abs + floor * case["sk"] * vmax / (1.0 - rate)
            + 2 * _ulp(ro, case["dtype"]))


def check_flash_attention(device) -> dict:
    """The flash forward kernel on the card against its plain version over
    dtypes, head dims, causal and not, sq = sk / sq < sk / sq > sk with
    ragged lengths, GQA, segment ids with fully-masked rows, dropout, the
    main path's shape, the pipeline microbatch's (b 1) and GPT-2-large's
    flagship shape, and a repeated call at the main shape equal bit for
    bit; returns the main shape's errors."""
    import torch
    from apex_tpu_torch.ops import flash_attention as fa

    cases = []
    for dt in _DTYPES:
        for d in (32, 64, 128):
            base = dict(dtype=dt, d=d, b=2, h=4, hk=2)
            for causal in (False, True):
                for sq, sk in ((128, 128), (100, 260), (260, 100)):
                    cases.append(dict(base, causal=causal, sq=sq, sk=sk))
            cases.append(dict(base, causal=True, sq=96, sk=96, seg="dead"))
            cases.append(dict(base, causal=False, sq=130, sk=70, seg="packed"))
            # dropout with v = identity: the keep mask must match bit for bit
            for causal, seed in ((False, 1234), (True, -7)):
                cases.append(dict(base, causal=causal, sq=100, sk=d, probe=True,
                                  rate=0.1, seed=seed))
    cases.append(dict(dtype="float32", d=64, b=2, h=4, hk=2, causal=True,
                      sq=100, sk=260, seg="packed", rate=0.1, seed=99))
    cases.append(dict(FLASH_MAIN, dtype="bfloat16", causal=True,
                      sq=FLASH_MAIN["s"], sk=FLASH_MAIN["s"], main=True))
    cases.append(dict(FLASH_PP, dtype="bfloat16", causal=True,
                      sq=FLASH_PP["s"], sk=FLASH_PP["s"]))
    cases.append(dict(FLASH_GPT, dtype="bfloat16", causal=True,
                      sq=FLASH_GPT["s"], sk=FLASH_GPT["s"]))
    cases.extend(FLASH_SLICE_CASES)
    g = torch.Generator(device=device).manual_seed(11)
    worst_o = worst_lse = 0.0
    main = {}
    repeat_equal = None
    with torch.inference_mode():
        for case in cases:
            q, k, v, seg = _flash_inputs(case, g, device)
            rate, seed = case.get("rate", 0.0), case.get("seed")
            o, lse = fa.flash_attention_fwd(q, k, v, causal=case["causal"],
                                            segment_ids=seg, dropout_rate=rate,
                                            dropout_seed=seed)
            torch.cuda.synchronize()
            ro, rlse = fa._plain_forward(
                q, k, v, causal=case["causal"],
                q_segment_ids=None if seg is None else seg[0],
                kv_segment_ids=None if seg is None else seg[1],
                dropout_rate=rate, dropout_seed=seed)
            o_tol = _flash_o_tol(q, k, v, ro, case, seg)
            r_o = _tol_ratio(o, ro, o_tol)
            r_lse = _tol_ratio(lse, rlse, 1e-5 + 1e-5 * rlse.abs())
            pattern_ok = (not case.get("probe")
                          or torch.equal(o == 0, ro == 0))
            name = {k: case[k] for k in case if k not in ("b", "h", "hk")}
            if r_o > 1.0 or r_lse > 1.0 or not pattern_ok:
                raise AssertionError(
                    f"flash_attention_fwd disagrees with its plain version: "
                    f"{name}: o at {r_o:.3f} x tol, lse at {r_lse:.3f} x "
                    f"tol, dropout keep pattern equal: {pattern_ok}")
            worst_o, worst_lse = max(worst_o, r_o), max(worst_lse, r_lse)
            if case.get("main"):
                main = dict(
                    o_max_abs_err=float((o.float() - ro.float()).abs().max()),
                    lse_max_abs_err=float((lse - rlse).abs().max()),
                    o_tol_ratio=r_o, lse_tol_ratio=r_lse)
                # each row is one warpgroup's, summed in one order
                o2, lse2 = fa.flash_attention_fwd(q, k, v, causal=case["causal"])
                repeat_equal = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
                if not repeat_equal:
                    raise AssertionError("flash_attention_fwd: a repeated call "
                                         "at the main shape differs")
                del o2, lse2
            del o, lse, ro, rlse
    out = dict(kernel="flash_attention_fwd", cases=len(cases),
               worst_o_tol_ratio=worst_o, worst_lse_tol_ratio=worst_lse,
               main_shape=main, main_repeat_bit_equal=repeat_equal,
               tolerance="fp32 o within 1e-5 + 1e-5|ref|; bf16/fp16 o_ij "
                         "within eps/2 * sum_j p_ij |v_j| (the kernel rounds p "
                         "to the operand dtype) + the dtype's least p spacing "
                         "* sk * max|v| / (1 - rate) + 2 ulp(ref); lse within "
                         "1e-5 + 1e-5|ref|, +inf rows equal; dropout with v = "
                         "identity: o == 0 exactly where the plain version's is; "
                         "a repeated call at the main shape equal bit for bit")
    log("phase2-check", **out)
    return out


def check_lm_head(device) -> dict:
    """The fused LM-head kernel on the card against its plain version over
    dtypes, token counts and vocabularies off the 128 and 256 tiles, hidden
    sizes, labels -100, vocab - 1 and vocab, the main path's shape,
    GPT-2-large's head shape (V 50257: 175 pad columns in the last vocab
    tile), GPT-1.3B's (V 50304, h 2048), GPT-2-medium's (V 50304, h 1024:
    the MoE and cp stacks'), and a repeated call at the main shape equal
    bit for bit."""
    import torch
    from apex_tpu_torch.ops import fused_lm_head as lh

    cases = [dict(dtype=dt, t=t, vocab=vocab, hid=hid)
             for dt in _DTYPES
             for t, vocab, hid in ((1, 1000, 64), (300, 1000, 136),
                                   (257, 32000, 256), (128, 256, 2048))]
    cases.append(dict(HEAD_MAIN, dtype="bfloat16", main=True, model_init=True))
    cases.append(dict(HEAD_GPT, dtype="bfloat16", model_init=True))
    cases.append(dict(HEAD_GPT13, dtype="bfloat16", model_init=True))
    cases.append(dict(HEAD_GPT2M, dtype="bfloat16", model_init=True))
    g = torch.Generator(device=device).manual_seed(12)
    worst, main = 0.0, {}
    with torch.inference_mode():
        for case in cases:
            dt = getattr(torch, case["dtype"])
            t, vocab, hid = case["t"], case["vocab"], case["hid"]
            h = torch.randn(t, hid, generator=g, device=device).to(dt)
            # the model's head init (0.02) at the models' shapes, unit
            # logits else
            std = 0.02 if case.get("model_init") else hid ** -0.5
            e = (torch.randn(vocab, hid, generator=g, device=device) * std).to(dt)
            lab = torch.randint(0, vocab, (t,), generator=g, device=device)
            lab[::7] = -100
            lab[3::11] = vocab
            lab[5::13] = vocab - 1
            loss, lse = lh.fused_lm_head_fwd(h, e, lab)
            torch.cuda.synchronize()
            rloss, rlse = lh._plain_forward(h, e, lab)
            # fp32 sums of up to 2048 products and 32000 exponentials,
            # taken in another order on the two sides
            r = max(_tol_ratio(loss, rloss, 1e-4 + 1e-5 * rloss.abs()),
                    _tol_ratio(lse, rlse, 1e-4 + 1e-5 * rlse.abs()))
            out_of_range = (lab < 0) | (lab >= vocab)
            ignored_is_lse = torch.equal(loss[out_of_range], lse[out_of_range])
            if r > 1.0 or not ignored_is_lse:
                raise AssertionError(
                    f"fused_lm_head_fwd disagrees with its plain version: "
                    f"{case}: {r:.3f} x tol, out-of-range labels give lse: "
                    f"{ignored_is_lse}")
            worst = max(worst, r)
            if case.get("main"):
                main = dict(
                    loss_max_abs_err=float((loss - rloss).abs().max()),
                    lse_max_abs_err=float((lse - rlse).abs().max()),
                    tol_ratio=r)
                # each tile's partials and each token's merge in one order
                loss2, lse2 = lh.fused_lm_head_fwd(h, e, lab)
                main["repeat_bitwise"] = bool(torch.equal(loss, loss2)
                                              and torch.equal(lse, lse2))
                if not main["repeat_bitwise"]:
                    raise AssertionError("fused_lm_head_fwd: two calls on the "
                                         "same inputs gave different bits")
            del h, e, loss, lse, rloss, rlse
    out = dict(kernel="fused_lm_head_fwd", cases=len(cases),
               worst_tol_ratio=worst, main_shape=main,
               tolerance="loss and lse within 1e-4 + 1e-5|ref|; an "
                         "out-of-range label's loss equals its lse exactly; "
                         "a repeated call at the main shape equal bit for bit")
    log("phase2-check", **out)
    return out


def _timed(calls: dict, graph_iters: int, big: tuple = ()) -> dict:
    """Device ms of each call: a CUDA graph of ``graph_iters`` calls, in
    turns (each name, then the first again), except the ``big`` ones,
    timed eagerly between CUDA events (their temporaries are GBs)."""
    out = {k: (time_ms(fn, iters=3, warmup=1) if k in big
               else device_ms(fn, iters=graph_iters))
           for k, fn in calls.items()}
    first = next(iter(calls))
    out[first + "_again"] = device_ms(calls[first], iters=graph_iters)
    return out


def _host_side_ms(fn, calls: int = 20) -> float:
    """The host side of one call: the wall of ``calls`` calls issued back
    to back, before the card ends them (the launch queue, far deeper than
    ``calls`` launches, never makes the host wait)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return out


def _time_flash_fwd_shape(shape: dict, seed: int, device) -> dict:
    """Kernel, plain version and SDPA at one shape (causal, bf16, in the
    model's layout), with each one's TFLOP/s and the host side of a
    call."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa

    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(s, b, n, d, generator=g, device=device)
               .to(torch.bfloat16).permute(1, 2, 0, 3) for n in (h, hk, hk))
    with torch.inference_mode():
        calls = {
            "kernel": lambda: fa.flash_attention_fwd(q, k, v, causal=True),
            "plain": lambda: fa._plain_forward(q, k, v, causal=True),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=hk != h)}
        dev = _timed(calls, 20, big=("plain",))
        host = time_ms(calls["kernel"], iters=20, warmup=3)
        host_side = _host_side_ms(calls["kernel"])
    # the causal pairs each product needs, two products of 2 d operations
    pairs = s * (s + 1) // 2
    flops = 2 * 2 * b * h * pairs * d
    nbytes = 2 * (b * h * s * d * 2 + 2 * b * hk * s * d) + 4 * b * h * s
    row = _row(dev, host, flops, nbytes, 989e12)
    row.update(shape=dict(shape, causal=True, dtype="bfloat16"), flops=flops,
               bytes=nbytes, tflops=flops / row["ms"] / 1e9,
               library_tflops=flops / dev["library"] / 1e9,
               call_host_side_ms=host_side,
               library_call="F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa)")
    return row


def time_flash_attention(device) -> dict:
    """Kernel, plain version and SDPA at the main path's shape (causal,
    bf16, [4, 32, 2048, 64] over 8 kv heads) and at GPT-2-large's flagship
    shape ([8, 20, 1024, 64]), in the model's layout; returns the main
    shape's row with the GPT shape's under ``"gpt2_large"``."""
    row = _time_flash_fwd_shape(FLASH_MAIN, 13, device)
    log("phase2-time", kernel="flash_attention_fwd", at="llama_1b", **row)
    gpt = _time_flash_fwd_shape(FLASH_GPT, 15, device)
    log("phase2-time", kernel="flash_attention_fwd", at="gpt2_large", **gpt)
    row["gpt2_large"] = gpt
    return row


def _time_head_fwd_shape(shape: dict, seed: int, device) -> dict:
    """Kernel, plain version and F.linear + F.cross_entropy at one head
    shape (bf16, the model's head init), with each one's TFLOP/s on the
    logits product, the host side of a call, and cuBLAS ``torch.matmul``
    on the same product (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import fused_lm_head as lh

    t, hid, vocab = shape["t"], shape["hid"], shape["vocab"]
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(t, hid, generator=g, device=device).to(torch.bfloat16)
    e = (torch.randn(vocab, hid, generator=g, device=device) * 0.02
         ).to(torch.bfloat16)
    lab = torch.randint(0, vocab, (t,), generator=g, device=device)
    with torch.inference_mode():
        calls = {
            "kernel": lambda: lh.fused_lm_head_fwd(h, e, lab),
            "plain": lambda: lh._plain_forward(h, e, lab),
            "library": lambda: F.cross_entropy(F.linear(h, e), lab,
                                               reduction="none")}
        dev = _timed(calls, 20, big=("plain",))
        host = time_ms(calls["kernel"], iters=20, warmup=3)
        host_side = _host_side_ms(calls["kernel"])
        # cuBLAS on E zero-padded to Vp rows, as the head backward's
        # yardstick: an odd leading dimension (V 50257) reads ~7 x slower
        ep = torch.zeros(lh.padded_vocab(vocab), hid, dtype=e.dtype, device=device)
        ep[:vocab] = e
        cublas = device_ms(lambda: torch.matmul(h, ep.t()), iters=20)
    flops = 2 * t * vocab * hid
    nbytes = 2 * (t * hid + vocab * hid) + 8 * t + 2 * 4 * t
    row = _row(dev, host, flops, nbytes, 989e12)
    row.update(shape=dict(shape, dtype="bfloat16"), flops=flops, bytes=nbytes,
               tflops=flops / row["ms"] / 1e9,
               library_tflops=flops / dev["library"] / 1e9,
               cublas_matmul_ms=cublas, cublas_tflops=flops / cublas / 1e9,
               call_host_side_ms=host_side,
               workspace_bytes=3 * 4 * t * lh.vocab_tiles(vocab),
               library_call="F.cross_entropy(F.linear(h, e), reduction='none')",
               cublas_call="torch.matmul(h, ep.t()) with E zero-padded to Vp = "
                           "V rounded up to 64 rows, bf16 logits [T, Vp] (CUDA "
                           "graph of 20); a yardstick, never called by the port")
    return row


def time_lm_head(device) -> dict:
    """Kernel, plain version and F.linear + F.cross_entropy at the main
    path's shape (T 8192, h 2048, vocab 32000) and at GPT-2-large's head
    (T 8192, h 1280, vocab 50257), bf16; returns the main shape's row with
    the GPT shape's under ``"gpt2_large"``."""
    row = _time_head_fwd_shape(HEAD_MAIN, 14, device)
    log("phase2-time", kernel="fused_lm_head_fwd", at="llama_1b", **row)
    gpt = _time_head_fwd_shape(HEAD_GPT, 16, device)
    log("phase2-time", kernel="fused_lm_head_fwd", at="gpt2_large", **gpt)
    row["gpt2_large"] = gpt
    return row


def _bound(flops: float, nbytes: float, peak_flops: float,
           exps: float = 0.0) -> dict:
    """The least time for a piece of work: the largest of its bytes over
    the memory rate, its products over ``peak_flops`` and its
    exponentials over the SFU rate, with the term that sets it."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "products": flops / peak_flops * 1e3,
             "exponentials": exps / MUFU_EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term)


def _row(dev: dict, host_ms: float, flops: float, nbytes: float,
         peak_flops: float, exps: float = 0.0, timing: str = None) -> dict:
    """A kernel's times beside its bound (:func:`_bound` of its products,
    bytes and exponentials ``exps``)."""
    return dict(ms=min(dev["kernel"], dev["kernel_again"]),
                ms_runs=[dev["kernel"], dev["kernel_again"]],
                plain_ms=dev["plain"], library_ms=dev["library"],
                host_issued_ms=host_ms,
                **_bound(flops, nbytes, peak_flops, exps),
                timing=timing or
                "ms/library_ms: device time, 20 calls in one CUDA "
                "graph between CUDA events; plain_ms: 3 eager calls "
                "between CUDA events (GBs of temporaries); "
                "host_issued_ms: 20 eager calls back to back; L2-warm")


# ---------------------------------------------------------------------------
# phase 2: the backward kernels against their plain versions
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24          # fp32 unit roundoff
EPS_SUM = 2.0 ** -16      # relative error allowed for an fp32 sum or exp


def _half_eps(dtype_name: str) -> float:
    """The rounding of a product's operand to ``dtype_name``: half an
    epsilon (0 for fp32, which the kernels do not round)."""
    if dtype_name == "float32":
        return 0.0
    return 2.0 ** -(_MANTISSA_BITS[dtype_name] + 1)


def _sub_floor(dtype_name: str) -> float:
    """The absolute rounding error below ``dtype_name``'s normal range:
    half its least subnormal spacing (fp32's least normal for bf16, whose
    kernels flush to zero there)."""
    import torch

    if dtype_name == "float32":
        return 0.0
    dt = getattr(torch, dtype_name)
    return max(torch.finfo(dt).tiny * _half_eps(dtype_name),
               torch.finfo(torch.float32).tiny)


def _norm_bwd_tol(dy, saved, mean, rstd, w, b, rms, mem_eff):
    """Per-element bounds of ``(dx, dw, db)``: both sides compute in fp32
    and sum in another order.  dx: the row sums c1, c2 (h terms) within
    2 sqrt(h) u32 of their terms' absolute sums, four roundings of the
    elementwise step, then 1 ulp of the output; dw, db: the column sums
    (n terms, each within 4 u32) within (2 sqrt(n) + 4) u32 of the sums of
    |terms|, then 1 ulp of their dtype."""
    s32, dy32 = saved.float(), dy.float()
    if mem_eff:
        xhat = s32
        if w is not None:
            xhat = (xhat - (b.float() if b is not None else 0.0)) / w.float()
    elif rms:
        xhat = s32 * rstd[:, None]
    else:
        xhat = (s32 - mean[:, None]) * rstd[:, None]
    n, h = dy.shape
    wdy = dy32 * w.float() if w is not None else dy32
    c1 = wdy.abs().sum(-1, keepdim=True) / h
    c2 = (wdy * xhat).abs().sum(-1, keepdim=True) / h
    dx_err = U32 * rstd[:, None] * (4 * (wdy.abs() + c1 + xhat.abs() * c2)
                                    + 2 * h ** 0.5 * (c1 + xhat.abs() * c2))
    k = (2 * n ** 0.5 + 4) * U32
    dw_err = k * (dy32 * xhat).abs().sum(0) if w is not None else None
    db_err = k * dy32.abs().sum(0) if b is not None else None
    return dx_err, dw_err, db_err


def _ulp_tol(err, ref, actual, dtype_name: str):
    """``err`` plus one ulp of ``dtype_name`` at the larger of |ref| and
    |actual| (the two sides may round one value to neighbours)."""
    import torch

    return err + _ulp(torch.maximum(ref.float().abs(), actual.float().abs()),
                      dtype_name)


# the norm backward at the paths' shapes: (name, n, h, rms, weight dtype,
# bias dtype, launches a step on its path) -- Llama-1B's RMSNorm (b 4 x s
# 2048, O2: the scale fp32), GPT-2-large's LayerNorm (O2 keeps its weight
# and bias fp32) and OpenFold's (NORM_LN_SHAPES, bf16 weight and bias); x bf16
NORM_BWD_SHAPES = (("llama_1b", 8192, 2048, True, "float32", None, 45),
                   ("gpt2_large", *NORM_LN_SHAPES["gpt2_large"], False, "float32",
                    "float32", 73),
                   ("openfold_m", *NORM_LN_SHAPES["openfold_m"], False, "bfloat16",
                    "bfloat16", 4),
                   ("openfold_z", *NORM_LN_SHAPES["openfold_z"], False, "bfloat16",
                    "bfloat16", 4),
                   # O2 BERT-large (24 layers x 2, the final and the LM
                   # head's), ViT-L/16 and GPT-1.3B (24 x 2 and the final)
                   ("bert_large", *NORM_LN_O2_SHAPES["bert_large"][:2], False,
                    "float32", "float32", 50),
                   ("vit_l16", *NORM_LN_O2_SHAPES["vit_l16"][:2], False,
                    "float32", "float32", 49),
                   ("gpt_1p3b", *NORM_LN_O2_SHAPES["gpt_1p3b"][:2], False,
                    "float32", "float32", 49))


def check_layer_norm_bwd(device) -> dict:
    """The norm backward kernel on the card against its plain version over
    LN/RMS, dtypes, affine variants (none, weight, weight and bias, in
    weight dtypes independent of x), ``memory_efficient``, ragged and
    unaligned shapes, a row longer than the register form takes and an
    input off a 16-byte boundary (the streaming form); the register form's
    edges: 8-, 16- and 32-lane groups at n not a multiple of a block's rows,
    rows split over 2, 4 and 8 warps (h 1280, 2048, 8192), the last h the
    register form takes and the first past it (bf16 and fp32), n below the
    rows in flight and n = 1; the paths' shapes (``NORM_BWD_SHAPES``), the
    Llama-1B one (n 8192, h 2048, x bf16, scale fp32) the main, and the
    pipeline microbatch's (n 2048) at those dtypes; and the same
    bits over 50 launches at the Llama-1B and OpenFold z shapes.  Returns
    the main shape's errors."""
    import torch
    from apex_tpu_torch.ops import layer_norm as ln

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    affines = ((False, False, None), (True, False, "float32"),
               (True, False, "bfloat16"), (True, True, "float32"),
               (True, True, "bfloat16"), (True, True, "float16"))
    # (rms, x, weight?, bias?, weight dtype, memory_efficient, n, h, offset,
    # main?)
    cases = []
    for rms in (False, True):
        for xdt in dtypes:
            for has_w, has_b, wdt in affines:
                for mem_eff in (False, True):
                    for n, h, offset in ((3, 128, 0), (16, 256, 0), (3, 200, 0),
                                         (16, 200, 0), (5, 5000, 0), (7, 256, 1),
                                         (600, 256, 0), (1000, 128, 0), (1, 128, 0)):
                        cases.append((rms, xdt, has_w, has_b, wdt, mem_eff, n, h,
                                      offset, False))
    # the register form's edges, LayerNorm with a weight and bias (every
    # weight dtype) and RMSNorm with a weight: 16 lanes (h 128, 256 in 16
    # bits, 1 and 2 vectors a thread; fp32 h 128), 8 (h 64 and 32 in 16
    # bits, fp32 h 32), 32 in one warp (16-bit h 512, fp32 h 256), several
    # blocks' worth of rows at n not a multiple of a block's 16 rows; rows
    # over 2 warps (h 1280, 3 vectors; h 2048), 4 (fp32 2048) and 8 (bf16
    # 8192, fp32 4096: the last h the register form takes) and the first h
    # past it (8256, 4128: the streaming form); n 1 and n below a block's
    # rows
    for rms, has_b in ((False, True), (True, False)):
        for xdt in ("bfloat16", "float32", "float16"):
            for wdt in ("float32", "bfloat16", "float16"):
                for n, h in ((5000, 128), (1001, 256), (999, 512), (77, 64),
                             (1003, 32), (333, 1280), (100, 2048), (1, 2048),
                             (3, 1280)):
                    cases.append((rms, xdt, True, has_b, wdt, False, n, h, 0, False))
            for n, h in (((5, 8192), (2, 8256), (1, 8192)) if xdt != "float32"
                         else ((5, 4096), (2, 4128), (1, 4096))):
                cases.append((rms, xdt, True, has_b, "float32", False, n, h, 0, False))
                cases.append((rms, xdt, True, has_b, "float32", True, n, h, 0, False))
    for name, n, h, rms, wdt, bdt, _ in NORM_BWD_SHAPES:
        cases.append((rms, "bfloat16", True, bdt is not None, wdt, False, n, h, 0,
                      name == "llama_1b"))
    for xdt, wdt in (("bfloat16", "bfloat16"), ("float32", "float32")):
        for n in (512, 8192):
            cases.append((True, xdt, True, False, wdt, False, n, 2048, 0, False))
    # one pipeline microbatch (1 x 2048) at Llama-1B: x bf16, scale fp32
    cases.append((True, "bfloat16", True, False, "float32", False, 2048, 2048,
                  0, False))
    g = torch.Generator(device=device).manual_seed(21)
    worst = {"dx": 0.0, "dw": 0.0, "db": 0.0}
    forms = {}
    main = {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.no_grad():
        for rms, xdt, has_w, has_b, wdt, mem_eff, n, h, offset, is_main in cases:
            buf = torch.randn(n * h + offset, generator=g, device=device) * 2 + 0.5
            x = buf.to(dtypes[xdt])[offset:].view(n, h)
            w = ((1 + 0.1 * torch.randn(h, generator=g, device=device))
                 .to(dtypes[wdt]) if has_w else None)
            b = ((0.1 * torch.randn(h, generator=g, device=device))
                 .to(dtypes[wdt]) if has_b else None)
            y, mean, rstd = ln._plain_forward(x, w, b, 1e-5, rms)
            dy = torch.randn(n, h, generator=g, device=device).to(dtypes[xdt])
            saved = y if mem_eff else x
            if offset:
                # the saved tensor off 16 bytes as well: the scalar path
                sbuf = torch.empty(n * h + offset, dtype=saved.dtype,
                                   device=device)
                sbuf[offset:] = saved.reshape(-1)
                saved = sbuf[offset:].view(n, h)
            dx, dw, db = ln.layer_norm_bwd(dy, saved, mean, rstd, w, b, rms,
                                           mem_eff)
            torch.cuda.synchronize()
            rdx, rdw, rdb = ln._plain_backward(dy, saved, mean, rstd, w, b,
                                               rms, mem_eff)
            ex, ew, eb = _norm_bwd_tol(dy, saved, mean, rstd, w, b, rms,
                                       mem_eff)
            r = {"dx": _tol_ratio(dx, rdx, _ulp_tol(ex, rdx, dx, xdt))}
            if has_w:
                r["dw"] = _tol_ratio(dw, rdw, _ulp_tol(ew, rdw, dw, wdt))
                if dw.dtype != w.dtype:
                    r["dw"] = float("inf")
            if has_b:
                r["db"] = _tol_ratio(db, rdb, _ulp_tol(eb, rdb, db, wdt))
            grid = ln.bwd_grid(n, h, dtypes[xdt], has_w, has_b, mem_eff,
                               offset == 0, sms)
            case = dict(rms=rms, x=xdt, w=wdt if has_w else None, bias=has_b,
                        memory_efficient=mem_eff, n=n, h=h, offset=offset,
                        grid=grid)
            if max(r.values()) > 1.0:
                raise AssertionError(
                    f"layer_norm_bwd disagrees with its plain version: {case}: "
                    f"{r} x tolerance")
            for k, v in r.items():
                worst[k] = max(worst[k], v)
            form = ("register, %d lanes x %d warps, %d vectors" % grid[:3]
                    if grid[2] else "streaming")
            forms[form] = forms.get(form, 0) + 1
            if is_main:
                main = dict(dx_max_abs_err=float((dx.float() - rdx.float()).abs().max()),
                            dw_max_abs_err=float((dw.float() - rdw.float()).abs().max()),
                            tol_ratio=r, grid=grid)
    repeats = {}
    for name, n, h, rms, wdt, bdt, _ in NORM_BWD_SHAPES:
        if name not in ("llama_1b", "openfold_z"):
            continue
        x = torch.randn(n, h, generator=g, device=device).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=device)).to(dtypes[wdt])
        b = None if bdt is None else (0.1 * torch.randn(
            h, generator=g, device=device)).to(dtypes[bdt])
        dy = torch.randn(n, h, generator=g, device=device).to(torch.bfloat16)
        with torch.no_grad():
            _, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-5, rms)
            first = ln.layer_norm_bwd(dy, x, mean, rstd, w, b, rms, False)
            same = 0
            for _ in range(50):
                again = ln.layer_norm_bwd(dy, x, mean, rstd, w, b, rms, False)
                same += all(torch.equal(a, c) for a, c in zip(first, again)
                            if a is not None)
        if same != 50:
            raise AssertionError(f"layer_norm_bwd at {name}: {50 - same} of 50 "
                                 f"repeated launches gave other bits")
        repeats[name] = same
    out = dict(kernel="layer_norm_bwd", cases=len(cases), forms=forms,
               worst_tol_ratio=worst, main_shape=main,
               same_bits_of_50_launches=repeats,
               tolerance="fp32 on both sides, summed in another order: dx "
                         "within u32 rstd (4 (|w dy| + c1 + |xhat| c2) + "
                         "2 sqrt(h) (c1 + |xhat| c2)) + 1 ulp (c1, c2 the "
                         "row means of |w dy| and |w dy xhat|); dw, db within "
                         "(2 sqrt(n) + 4) u32 sum|dy xhat| (sum|dy|) + 1 ulp "
                         "of their dtype; u32 = 2^-24")
    log("phase2-check", **out)
    return out


def _flash_bwd_tol(q, k, v, lse, do, delta, dq_ref, dk_ref, dv_ref, case,
                   scale, qseg, kseg):
    """Per-element bounds of ``(dq, dk, dv)``.  The kernels round ds and
    p_kept to the operand dtype before their products (half an epsilon u
    of each operand: u (|ds| |k|) and the like, on the plain version's
    values), the dtype's least subnormal spacing bounds what that rounding
    loses below the normal range, and every fp32 quantity (s, p through
    2^x, dp, delta and the sums of the products) is within EPS_SUM of its
    terms' absolute sums; then 2 ulp of the output.  Computed one batch
    element at a time, in fp32."""
    import torch
    from apex_tpu_torch.ops import flash_attention as fa

    dt = case["dtype"]
    u, floor = _half_eps(dt), _sub_floor(dt)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    rep = h // hk
    rate = case.get("rate", 0.0)
    ks = 1.0 / (1.0 - rate)
    tq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    tk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    tv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for bi in range(b):
        q1 = q[bi:bi + 1].float()
        k1 = k[bi:bi + 1].float().repeat_interleave(rep, 1)
        v1 = v[bi:bi + 1].float().repeat_interleave(rep, 1)
        do1 = do[bi:bi + 1].float()
        s = torch.matmul(q1, k1.transpose(-1, -2)) * scale
        valid = fa._valid(q.device, sq, sk, case["causal"],
                          None if qseg is None else qseg[bi:bi + 1],
                          None if kseg is None else kseg[bi:bi + 1])
        if valid is not None:
            s = torch.where(valid, s, fa._NEG_INF)
        p = torch.exp(s - lse[bi:bi + 1, ..., None])
        del s
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        keep = None
        if rate > 0.0:
            keep = fa._keep(q.device, b, h, sq, sk, case["seed"],
                            rate)[bi:bi + 1]
        dp = torch.matmul(do1, v1.transpose(-1, -2))
        dpk = dp if keep is None else torch.where(keep, dp * ks, 0.0)
        pk = p if keep is None else torch.where(keep, p * ks, 0.0)
        dpa = torch.matmul(do1.abs(), v1.abs().transpose(-1, -2))
        if keep is not None:
            dpa = torch.where(keep, dpa * ks, 0.0)
        dl = delta[bi:bi + 1, ..., None]
        ds = p * (dpk - dl)
        # p within EPS_SUM (1 + scale |q||k|) relative; dp and delta within
        # EPS_SUM of their absolute sums: the error scale of ds
        pe = 1 + torch.matmul(q1.abs(), k1.abs().transpose(-1, -2)) * scale
        a = p * (pe * (dpk.abs() + dl.abs()) + dpa + dl.abs())
        pe = pk.abs() * pe
        del dpk, dp, dpa
        ka, qa, doa = k1.abs(), q1.abs(), do1.abs()
        nq = float(qa.max()) if qa.numel() else 0.0
        nk = float(ka.max()) if ka.numel() else 0.0
        nd = float(doa.max()) if doa.numel() else 0.0
        tq[bi:bi + 1] = scale * (u * torch.matmul(ds.abs(), ka)
                                 + EPS_SUM * torch.matmul(a, ka)
                                 + floor * sk * nk)
        dk_t = scale * (u * torch.matmul(ds.abs().transpose(-1, -2), qa)
                        + EPS_SUM * torch.matmul(a.transpose(-1, -2), qa)
                        + floor * sq * nq)
        dv_t = (u * torch.matmul(pk.abs().transpose(-1, -2), doa)
                + EPS_SUM * torch.matmul(pe.transpose(-1, -2), doa)
                + floor * sq * nd)
        tk[bi:bi + 1] = dk_t.view(1, hk, rep, sk, d).sum(2)
        tv[bi:bi + 1] = dv_t.view(1, hk, rep, sk, d).sum(2)
        del p, pk, pe, ds, a, dk_t, dv_t
    return (tq + 2 * _ulp(dq_ref, dt), tk + 2 * _ulp(dk_ref, dt),
            tv + 2 * _ulp(dv_ref, dt))


def check_flash_attention_bwd(device) -> dict:
    """The dq and dk/dv kernels on the card against the plain backward on
    the same (q, k, v, o, lse, do), over the forward check's variants
    (dtypes, head dims, causal and not, sq = sk / sq < sk / sq > sk with
    ragged lengths, GQA, segment ids with fully-masked rows, dropout), the
    main path's shape, the pipeline microbatch's (b 1) and GPT-2-large's
    flagship shape, with q, k, v and do
    in the model's layout, and a repeated call at the main shape equal bit
    for bit; returns the main shape's errors."""
    import torch
    from apex_tpu_torch.ops import flash_attention as fa

    cases = []
    for dt in _DTYPES:
        for d in (32, 64, 128):
            base = dict(dtype=dt, d=d, b=2, h=4, hk=2)
            for causal in (False, True):
                for sq, sk in ((128, 128), (100, 260), (260, 100)):
                    cases.append(dict(base, causal=causal, sq=sq, sk=sk))
            cases.append(dict(base, causal=True, sq=96, sk=96, seg="dead"))
            cases.append(dict(base, causal=False, sq=130, sk=70, seg="packed"))
            for causal, seed in ((False, 1234), (True, -7)):
                cases.append(dict(base, causal=causal, sq=100, sk=150,
                                  rate=0.1, seed=seed))
    cases.append(dict(dtype="float32", d=64, b=2, h=4, hk=2, causal=True,
                      sq=100, sk=260, seg="packed", rate=0.1, seed=99))
    cases.append(dict(FLASH_MAIN, dtype="bfloat16", causal=True,
                      sq=FLASH_MAIN["s"], sk=FLASH_MAIN["s"], main=True))
    cases.append(dict(FLASH_PP, dtype="bfloat16", causal=True,
                      sq=FLASH_PP["s"], sk=FLASH_PP["s"]))
    cases.append(dict(FLASH_GPT, dtype="bfloat16", causal=True,
                      sq=FLASH_GPT["s"], sk=FLASH_GPT["s"]))
    cases.extend(FLASH_SLICE_CASES)
    g = torch.Generator(device=device).manual_seed(22)
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    main = {}
    repeat_equal = None
    with torch.no_grad():
        for case in cases:
            q, k, v, seg = _flash_inputs(case, g, device)
            rate, seed = case.get("rate", 0.0), case.get("seed")
            scale = 1.0 / case["d"] ** 0.5
            o, lse = fa.flash_attention_fwd(q, k, v, causal=case["causal"],
                                            segment_ids=seg, dropout_rate=rate,
                                            dropout_seed=seed)
            # do in the model's layout, like o
            do = torch.randn(o.permute(2, 0, 1, 3).shape, generator=g,
                             device=device).to(q.dtype).permute(1, 2, 0, 3)
            dq, dk, dv = fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal=case["causal"], segment_ids=seg,
                dropout_rate=rate, dropout_seed=seed)
            torch.cuda.synchronize()
            if dq.stride() != q.stride() or dk.stride() != k.stride() \
                    or dv.stride() != v.stride():
                raise AssertionError(f"flash backward strides: {case}")
            qseg, kseg = (None, None) if seg is None else seg
            ref = fa._plain_backward(q, k, v, o, lse, do, causal=case["causal"],
                                     q_segment_ids=qseg, kv_segment_ids=kseg,
                                     dropout_rate=rate, dropout_seed=seed)
            delta = (do.float() * o.float()).sum(-1)
            tols = _flash_bwd_tol(q, k, v, lse, do, delta, *ref, case, scale,
                                  qseg, kseg)
            r = {n: _tol_ratio(a, e, t) for n, a, e, t in
                 zip(("dq", "dk", "dv"), (dq, dk, dv), ref, tols)}
            name = {kk: case[kk] for kk in case if kk not in ("b", "h", "hk")}
            if max(r.values()) > 1.0:
                raise AssertionError(
                    f"flash attention backward disagrees with its plain "
                    f"version: {name}: {r} x tolerance")
            for n, x in r.items():
                worst[n] = max(worst[n], x)
            if case.get("main"):
                main = {f"{n}_max_abs_err": float((a.float() - e.float()).abs().max())
                        for n, a, e in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
                main["tol_ratio"] = r
                # each output tile is one block's, summed in one order
                again = fa.flash_attention_bwd(
                    q, k, v, o, lse, do, causal=case["causal"],
                    segment_ids=seg, dropout_rate=rate, dropout_seed=seed)
                repeat_equal = all(torch.equal(a, b) for a, b in
                                   zip((dq, dk, dv), again))
                if not repeat_equal:
                    raise AssertionError("flash attention backward: a repeated "
                                         "call at the main shape differs")
                del again
            del q, k, v, o, lse, do, dq, dk, dv, ref, tols
    out = dict(kernel="flash_attention_dq + flash_attention_dkv",
               cases=len(cases), worst_tol_ratio=worst, main_shape=main,
               main_repeat_bit_equal=repeat_equal,
               tolerance="dq within scale (u |ds| |k| + 2^-16 A |k| + "
                         "floor sk max|k|), dk likewise with q, dv within "
                         "u |p_kept|^T |do| + 2^-16 P^T |do| + floor sq "
                         "max|do|, "
                         "each + 2 ulp: u half an epsilon of the dtype "
                         "(0 for fp32; the kernels round ds and p_kept), A = "
                         "p ((1 + scale |q||k|) (|dp_kept| + |delta|) + "
                         "|do||v| + |delta|) and P = |p_kept| (1 + scale "
                         "|q||k|) the error scales of ds and p_kept, floor "
                         "the dtype's half least subnormal spacing; GQA "
                         "bounds summed over the group; a repeated call at "
                         "the main shape equal bit for bit")
    log("phase2-check", **out)
    return out


AMP_LOSS_SCALE = 2.0 ** 15   # the fp16 amp paths' loss scale after warm-up
MAX_MEDIAN_TOL_SHARE = 1 / 3  # a head-backward tolerance's median over |ref|'s


def _head_bwd_tol(h, e, labels, lse, gvec, dh_ref, de_ref, dt):
    """Per-element bounds of ``(dh, de)``: the kernels round dlog to the
    operand dtype (u |dlog| |E|, u |dlog|^T |H|, and the dtype's subnormal
    floor for each dlog below twice its least normal); the recomputed
    logits and lse are within EPS_SUM of |H||E|^T and its row max, which
    moves p by that much relative (E = p |g| (|H||E|^T + rowmax)); the fp32
    sums of the products within EPS_SUM; then 2 ulp."""
    import torch

    u, floor = _half_eps(dt), _sub_floor(dt)
    h32, e32 = h.float(), e.float()
    logits = torch.matmul(h32, e32.t())
    p = torch.exp(logits - lse[:, None])
    del logits
    cols = torch.arange(e.shape[0], device=h.device)
    dlog = (p - (labels.long()[:, None] == cols[None, :]).float()) * gvec[:, None]
    habs, eabs = h32.abs(), e32.abs()
    l1 = torch.matmul(habs, eabs.t())
    err = p * gvec.abs()[:, None] * (l1 + l1.amax(-1, keepdim=True))
    del l1, p
    dl = dlog.abs()
    del dlog
    dh_t = u * torch.matmul(dl, eabs) + EPS_SUM * torch.matmul(err + dl, eabs)
    de_t = (u * torch.matmul(dl.t(), habs)
            + EPS_SUM * torch.matmul((err + dl).t(), habs))
    if floor:
        # the kernel's dlog may lie a rounding below the reference's
        sub = (dl < 2 * torch.finfo(getattr(torch, dt)).tiny).float()
        dh_t += floor * torch.matmul(sub, eabs)
        de_t += floor * torch.matmul(sub.t(), habs)
    return dh_t + 2 * _ulp(dh_ref, dt), de_t + 2 * _ulp(de_ref, dt)


def check_lm_head_bwd(device) -> dict:
    """The dH and dE kernels on the card against the plain backward on the
    same (H, E, labels, lse, g) over the forward check's dtypes, token
    counts and vocabularies off the tile, hidden sizes, labels -100 and
    vocab, with a non-uniform g; the main path's shape in bf16 and fp16,
    GPT-2-large's, GPT-1.3B's and GPT-2-medium's head shapes, T, V and h
    off every tile edge of the wgmma
    products (T 129, V 50257, h 1288), and two calls on the same inputs,
    which must give dH and dE bit for bit.  fp16 cases take the fp16 amp
    path's cotangent (times its loss scale), and every case's tolerance
    must have a median well under |ref|'s, so that zeros would fail."""
    import torch
    from apex_tpu_torch.ops import fused_lm_head as lh

    cases = [dict(dtype=dt, t=t, vocab=vocab, hid=hid)
             for dt in _DTYPES
             for t, vocab, hid in ((1, 1000, 64), (300, 1000, 136),
                                   (257, 32000, 256), (128, 256, 2048))]
    cases.append(dict(HEAD_MAIN, dtype="bfloat16", main=True, model_init=True))
    cases.append(dict(HEAD_MAIN, dtype="float16", model_init=True))
    cases.append(dict(HEAD_GPT, dtype="bfloat16", model_init=True))
    cases.append(dict(HEAD_GPT13, dtype="bfloat16", model_init=True))
    cases.append(dict(HEAD_GPT2M, dtype="bfloat16", model_init=True))
    cases += [dict(dtype=dt, t=129, vocab=50257, hid=1288)
              for dt in ("bfloat16", "float16")]
    g = torch.Generator(device=device).manual_seed(23)
    worst = {"dh": 0.0, "de": 0.0}
    worst_med = {dt: {"dh": 0.0, "de": 0.0} for dt in _DTYPES}
    main = {}
    with torch.no_grad():
        for case in cases:
            dt = getattr(torch, case["dtype"])
            t, vocab, hid = case["t"], case["vocab"], case["hid"]
            h = torch.randn(t, hid, generator=g, device=device).to(dt)
            std = 0.02 if case.get("model_init") else hid ** -0.5
            e = (torch.randn(vocab, hid, generator=g, device=device) * std).to(dt)
            lab = torch.randint(0, vocab, (t,), generator=g, device=device)
            lab[::7] = -100
            lab[3::11] = vocab
            lab[5::13] = vocab - 1
            # a non-uniform upstream cotangent, of both signs; in fp16 times
            # the amp path's loss scale, as its fp16 O2 head gets it
            gvec = torch.randn(t, generator=g, device=device) / t
            if case["dtype"] == "float16":
                gvec *= AMP_LOSS_SCALE
            _, lse = lh.fused_lm_head_fwd(h, e, lab)
            dh, de = lh.fused_lm_head_bwd(h, e, lab, lse, gvec)
            torch.cuda.synchronize()
            rdh, rde = lh._plain_backward(h, e, lab, lse, gvec)
            tdh, tde = _head_bwd_tol(h, e, lab, lse, gvec, rdh.float(),
                                     rde.float(), case["dtype"])
            r = {"dh": _tol_ratio(dh, rdh, tdh), "de": _tol_ratio(de, rde, tde)}
            if max(r.values()) > 1.0:
                raise AssertionError(
                    f"fused LM-head backward disagrees with its plain version: "
                    f"{case}: {r} x tolerance")
            # a tolerance near the values would pass zeros or a misread type
            med = {n: float(tol.median() / ref.float().abs().median())
                   for n, tol, ref in (("dh", tdh, rdh), ("de", tde, rde))}
            if max(med.values()) > MAX_MEDIAN_TOL_SHARE:
                raise AssertionError(
                    f"fused LM-head backward: the tolerance's median is not "
                    f"under {MAX_MEDIAN_TOL_SHARE} of the values' in {case}: "
                    f"{med}")
            for n, x in r.items():
                worst[n] = max(worst[n], x)
                worst_med[case["dtype"]][n] = max(worst_med[case["dtype"]][n],
                                                  med[n])
            if case.get("main"):
                main = dict(dh_max_abs_err=float((dh.float() - rdh.float()).abs().max()),
                            de_max_abs_err=float((de.float() - rde.float()).abs().max()),
                            tol_ratio=r)
                dh2, de2 = lh.fused_lm_head_bwd(h, e, lab, lse, gvec)
                main["repeat_bitwise"] = bool(torch.equal(dh, dh2)
                                              and torch.equal(de, de2))
                if not main["repeat_bitwise"]:
                    raise AssertionError(
                        "fused LM-head backward: two calls on the same inputs "
                        "gave different bits")
                del dh2, de2
            del h, e, dh, de, rdh, rde, tdh, tde
    out = dict(kernel="fused_lm_head_dh + fused_lm_head_de", cases=len(cases),
               worst_tol_ratio=worst, worst_median_tol_share=worst_med,
               main_shape=main,
               tolerance="dH within u |dlog| |E| + 2^-16 (err + |dlog|) |E| + "
                         "floor [|dlog| < 2 tiny] |E|, dE likewise with H, "
                         "each + 2 ulp: u half an epsilon of the dtype (0 for "
                         "fp32; the kernels round dlog), err = p |g| "
                         "(|H||E|^T + its row max) the recomputed logits' and "
                         "lse's error scale, floor the dtype's half least "
                         "subnormal spacing below its least normal tiny; g "
                         "randn / T, times the loss scale 2^15 in fp16; the "
                         "tolerance's median under "
                         f"{MAX_MEDIAN_TOL_SHARE} of |ref|'s in every case; "
                         "a repeated call equal bit for bit")
    log("phase2-check", **out)
    return out


def _fwd_bwd_minus_fwd(fwd, grads_of, device_iters: int = 10) -> float:
    """Device ms of a library call's backward: forward + backward minus
    forward, each a CUDA graph of ``device_iters`` calls."""
    import torch

    def both():
        out = fwd()
        torch.autograd.grad(out, grads_of[0], grads_of[1])

    return device_ms(both, iters=device_iters) - device_ms(fwd, iters=device_iters)


def time_layer_norm_bwd(device) -> dict:
    """The backward kernel, the plain version and the library call's
    backward (``F.rms_norm`` / ``F.layer_norm``, forward + backward minus
    forward) at the paths' shapes (``NORM_BWD_SHAPES``), each beside its
    bytes bound and its launches a step, with the call's time split into
    its row and column passes (``torch.profiler``); the Llama-1B row first
    (the main path's), the others under ``shapes``."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import layer_norm as ln

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device=device).manual_seed(24)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for name, n, h, rms, wdt, bdt, per_step in NORM_BWD_SHAPES:
        x = torch.randn(n, h, generator=g, device=device).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=device)).to(dtypes[wdt])
        b = None if bdt is None else (0.1 * torch.randn(
            h, generator=g, device=device)).to(dtypes[bdt])
        dy = torch.randn(n, h, generator=g, device=device).to(torch.bfloat16)
        with torch.no_grad():
            _, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-5, rms)
        calls = {
            "kernel": lambda: ln.layer_norm_bwd(dy, x, mean, rstd, w, b, rms,
                                                False),
            "plain": lambda: ln._plain_backward(dy, x, mean, rstd, w, b, rms,
                                                False)}
        with torch.no_grad():
            dev = _timed(calls, 50, big=("plain",) if n * h > 2 ** 26 else ())
            host = time_ms(calls["kernel"], iters=100, warmup=10)
            # the row pass and the column pass, each kernel's own device time
            split = {("rows" if "ln_bwd_rows" in k else "cols" if "ln_bwd_cols" in k
                      else k): v for k, v in _kernel_device_ms(calls["kernel"], 10).items()}
        xr = x.detach().requires_grad_()
        wr = w.detach().requires_grad_()
        if rms:
            dev["library"] = _fwd_bwd_minus_fwd(
                lambda: F.rms_norm(xr, (h,), wr, 1e-5), ((xr, wr), dy))
        else:
            # F.layer_norm takes a weight and bias of x's dtype only
            wr = w.to(x.dtype).requires_grad_()
            br = b.to(x.dtype).requires_grad_()
            dev["library"] = _fwd_bwd_minus_fwd(
                lambda: F.layer_norm(xr, (h,), wr, br, 1e-5), ((xr, wr, br), dy))
        del xr, wr
        # each input read once, each output written once: dy, x, rstd (and
        # mean for LayerNorm), the weight; dx, dw (and db).  About 12 fp32
        # operations an element.
        wsize, bsize = dtypes[wdt].itemsize, 0 if bdt is None else dtypes[bdt].itemsize
        nbytes = 2 * n * h * 3 + 4 * n * (1 if rms else 2) + h * (2 * wsize + bsize)
        flops = 12 * n * h
        row = _row(dev, host, flops, nbytes, FP32_OPS_PER_S,
                   timing="ms: device time, 50 calls in one CUDA graph between "
                          "CUDA events, twice in turns with the plain version; "
                          "plain_ms: the same, or 3 eager calls between CUDA "
                          "events past 2^26 elements; library_ms: forward + "
                          "backward minus forward, CUDA graphs of 10; "
                          "host_issued_ms: 100 eager calls; L2-warm")
        row.update(path=name, launches_per_step=per_step, split_ms=split,
                   shape=dict(n=n, h=h, x="bfloat16", weight=wdt, bias=bdt, rms=rms),
                   grid=ln.bwd_grid(n, h, torch.bfloat16, True, bdt is not None,
                                    False, True, sms),
                   bytes=nbytes, flops=flops, bound_share=row["bound_ms"] / row["ms"],
                   library_call=("F.rms_norm" if rms else "F.layer_norm, its "
                                 "weight and bias cast to x's dtype,")
                   + " forward + backward minus forward (CUDA graphs of 10)")
        rows.append(row)
        del x, dy, mean, rstd, calls
    log("phase2-time", kernel="layer_norm_bwd", rows=rows)
    main = dict(rows[0])
    main["shapes"] = rows[1:]
    return main


def _time_flash_bwd_shape(shape: dict, seed: int, device) -> dict:
    """dq and dk/dv each, the plain backward and SDPA's backward at one
    shape (causal, bf16, in the model's layout); returns ``{"dq": row,
    "dkv": row}``, each row with its TFLOP/s and host-side times."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa

    b, h, hk, s, d = (shape[k] for k in ("b", "h", "hk", "s", "d"))
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(s, b, n, d, generator=g, device=device)
                   .to(torch.bfloat16).permute(1, 2, 0, 3) for n in (h, hk, hk, h))
    scale = 1.0 / d ** 0.5
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        call = fa._BwdLaunch(q, k, v, o, lse, do, None, None, True, scale,
                             0.0, None)
        call.launch(fa.FLASH_ATTENTION_DQ)          # delta for dk/dv
        plain = lambda: fa._plain_backward(q, k, v, o, lse, do, causal=True)
        dev_plain = time_ms(plain, iters=3, warmup=1)
        rows = {}
        for name, kern in (("dq", fa.FLASH_ATTENTION_DQ),
                           ("dkv", fa.FLASH_ATTENTION_DKV)):
            fn = lambda kern=kern: call.launch(kern)
            rows[name] = dict(kernel=device_ms(fn, iters=20),
                              kernel_again=None,
                              host=time_ms(fn, iters=20, warmup=3))
        for name, kern in (("dq", fa.FLASH_ATTENTION_DQ),
                           ("dkv", fa.FLASH_ATTENTION_DKV)):
            rows[name]["kernel_again"] = device_ms(
                lambda kern=kern: call.launch(kern), iters=20)
        host_side = {what + "_ms": _host_side_ms(fn) for what, fn in (
            ("call", lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal=True)),
            ("dq_launch", lambda: call.launch(fa.FLASH_ATTENTION_DQ)),
            ("dkv_launch", lambda: call.launch(fa.FLASH_ATTENTION_DKV)))}
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    library = _fwd_bwd_minus_fwd(
        lambda: F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                               enable_gqa=hk != h),
        ((qr, kr, vr), do))
    pairs = s * (s + 1) // 2
    prod = 2 * b * h * pairs * d              # one causal product
    out = {}
    for name, nprod, nbytes in (
            # q, k, v, o, do, lse read; dq, delta written
            ("dq", 3, 2 * (3 * b * h * s * d + 2 * b * hk * s * d)
             + 4 * 2 * b * h * s),
            # q, k, v, do, lse, delta read; dk, dv written
            ("dkv", 4, 2 * (2 * b * h * s * d + 4 * b * hk * s * d)
             + 4 * 2 * b * h * s)):
        r = rows[name]
        dev = dict(kernel=r["kernel"], kernel_again=r["kernel_again"],
                   plain=dev_plain, library=library)
        row = _row(dev, r["host"], nprod * prod, nbytes, 989e12)
        row.update(shape=dict(shape, causal=True, dtype="bfloat16"),
                   flops=nprod * prod, bytes=nbytes,
                   tflops=nprod * prod / row["ms"] / 1e9,
                   host_side=host_side,
                   plain_and_library_compute="dq, dk and dv together",
                   library_call="F.scaled_dot_product_attention(is_causal, "
                                "enable_gqa) forward + backward minus forward "
                                "(CUDA graphs of 10)")
        out[name] = row
    out["sum_ms"] = out["dq"]["ms"] + out["dkv"]["ms"]
    out["library_tflops"] = 5 * prod / library / 1e9
    return out


def time_flash_attention_bwd(device) -> dict:
    """dq and dk/dv at the main path's shape (causal, bf16, [4, 32, 2048,
    64] over 8 kv heads) and at GPT-2-large's flagship shape ([8, 20, 1024,
    64]), in the model's layout, with SDPA's backward beside each; returns
    the main shape's ``{"dq": row, "dkv": row}`` with the GPT shape's under
    ``"gpt2_large"``."""
    out = _time_flash_bwd_shape(FLASH_MAIN, 25, device)
    out["gpt2_large"] = _time_flash_bwd_shape(FLASH_GPT, 26, device)
    for shape, rows in (("llama_1b", out), ("gpt2_large", out["gpt2_large"])):
        for name in ("dq", "dkv"):
            log("phase2-time", kernel=f"flash_attention_{name}", at=shape,
                **rows[name])
    return out


# the sources whose 16-bit kernels run on wgmma fed by TMA, and nothing on
# mma.sync: the flash forward and backward, the head forward and the
# pair-bias forward and backward; the norm forward's and backward's ptxas
# registers are logged beside them (no products: no instruction gate; the
# backward's register form must not spill)
WGMMA_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                 "fused_lm_head_fwd.cu", "pair_bias_attention_fwd.cu",
                 "pair_bias_attention_bwd.cu")
PTXAS_SOURCES = WGMMA_SOURCES + ("layer_norm_fwd.cu", "layer_norm_bwd.cu")
WGMMA_KERNELS = (("flash_fwd_wgmma", (32, 64, 128)), ("flash_dq_wgmma", (32, 64, 128)),
                 ("flash_dkv_wgmma", (32, 64, 128)), ("lm_head_fwd_wgmma", (None,)),
                 ("pair_bias_fwd_wgmma", (32, 64, 128)),
                 ("pair_bias_dq_wgmma", (32, 64, 128)),
                 ("pair_bias_dkv_wgmma", (32, 64, 128)),
                 ("pair_bias_dbias_wgmma", (32, 64, 128)))
# the libraries that hold no HMMA (mma.sync) at all
NO_HMMA_SOURCES = ("flash_attention_fwd.cu", "fused_lm_head_fwd.cu",
                   "pair_bias_attention_fwd.cu", "pair_bias_attention_bwd.cu")


def start_ptxas():
    """Start ``nvcc -Xptxas -v`` on each of ``PTXAS_SOURCES`` (into
    ``build/``, beside the libraries' build, one process each);
    :func:`wgmma_registers` reads them."""
    from apex_tpu_torch.ops import _build

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    jobs = []
    for source in PTXAS_SOURCES:
        out = os.path.join(ROOT, "build", f"ptxas_{source[:-3]}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
               str(_build.CSRC / source)]
        log_file = open(out + ".log", "w+")
        jobs.append((subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT,
                                      text=True), log_file))
    return jobs


def _kernel_name(mangled: str):
    """``(kernel, dtype, d)`` of a mangled kernel name of ``PTXAS_SOURCES``
    (d None for the head forward's logits product; for the norm forward's
    register path, its vectors a lane), or None."""
    import re

    m = re.search(r"(flash_(?:fwd|dq|dkv)_(?:wgmma|f32)"
                  r"|pair_bias_(?:fwd|dq|dkv|dbias)_(?:wgmma|f32))", mangled)
    m_ln = re.search(r"ln_fwd_rowsI(f|13__nv_bfloat16|6__half)", mangled)
    m_lnb = re.search(r"ln_bwd_rowsI(f|13__nv_bfloat16|6__half)Lb([01])ELi(\d+)E", mangled)
    dtypes = {"f": "float32", "13__nv_bfloat16": "bfloat16", "6__half": "float16"}
    if m_lnb:
        # ln_bwd_rows<TX, HAS_B, NV>
        return ("ln_bwd_rows", dtypes[m_lnb.group(1)],
                f"nv{m_lnb.group(3)}" + ("+bias" if m_lnb.group(2) == "1" else ""))
    if m:
        d = re.search(r"Li(32|64|128)E", mangled)
        if not d:
            return None
        kernel, d = m.group(1), int(d.group(1))
    elif m_ln:
        # ln_fwd_rows<TX, TW, NV>: x's dtype comes first in the name
        nv = re.search(r"Li(\d+)E", mangled)
        if not nv:
            return None
        return "ln_fwd_rows", dtypes[m_ln.group(1)], f"nv{nv.group(1)}"
    elif "wgmma_gemm" in mangled and "PartialsStore" in mangled:
        kernel, d = "lm_head_fwd_wgmma", None
    elif "lm_head_f32" in mangled:
        kernel, d = "lm_head_f32", None
    else:
        return None
    dtype = ("bfloat16" if "__nv_bfloat16" in mangled
             else "float16" if "__half" in mangled else "float32")
    return kernel, dtype, d


def wgmma_registers(jobs) -> dict:
    """Registers and spills of each kernel of ``WGMMA_SOURCES`` (ptxas,
    from :func:`start_ptxas`) and its ``HGMMA`` / ``UTMALDG`` / ``HMMA``
    instruction counts (``cuobjdump -sass`` of the built libraries).  Fails
    unless every bf16 and fp16 flash forward, dq, dk/dv and head-forward
    kernel runs on wgmma fed by TMA, and unless no kernel of the flash
    forward's or the head forward's library holds an ``HMMA`` (mma.sync)."""
    import re
    from apex_tpu_torch.ops import _build

    kernels = {}
    for proc, log_file in jobs:
        proc.wait()
        log_file.seek(0)
        log_text = log_file.read()
        log_file.close()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log_text}")
        cur = None
        for line in log_text.splitlines():
            if "serialized" in line:
                # ptxas's C7512 note: the function's wgmma run one at a time
                m = re.search(r"function '([^']+)'", line)
                name = m and _kernel_name(m.group(1))
                if name:
                    kernels.setdefault(name, {})["wgmma_serialized"] = True
                continue
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = _kernel_name(m.group(1))
                if cur is not None:
                    kernels.setdefault(cur, {})
                continue
            if cur is None:
                continue
            # (the largest over the kernels one key stands for)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                for key, val in (("spill_stores", m.group(1)), ("spill_loads", m.group(2))):
                    kernels[cur][key] = max(kernels[cur].get(key, 0), int(val))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[cur]["registers"] = max(kernels[cur].get("registers", 0),
                                                int(m.group(1)))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    library_hmma = {}
    for source in WGMMA_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(_build._target(source))],
                              check=True, capture_output=True, text=True).stdout
        library_hmma[source] = sass.count("HMMA")
        for chunk in sass.split("Function : ")[1:]:
            name = _kernel_name(chunk.split("\n", 1)[0])
            if name is None:
                continue
            kernels.setdefault(name, {}).update(
                hgmma=chunk.count("HGMMA"), utmaldg=chunk.count("UTMALDG"),
                hmma=chunk.count("HMMA"))
    rows = {"/".join([k, dt] + ([d if isinstance(d, str) else f"d{d}"] if d else [])): v
            for (k, dt, d), v in sorted(kernels.items(), key=str)}
    for kern, dims in WGMMA_KERNELS:
        for dt in ("bfloat16", "float16"):
            for d in dims:
                key = "/".join([kern, dt] + ([f"d{d}"] if d else []))
                r = rows.get(key, {})
                if not (r.get("hgmma") and r.get("utmaldg")) or r.get("hmma"):
                    raise AssertionError(
                        f"{key}: expected HGMMA and UTMALDG and no HMMA in its "
                        f"SASS, got {r}")
    ln_bwd = {k: v for k, v in rows.items() if k.startswith("ln_bwd_rows/")}
    if len(ln_bwd) != 3 * 2 * 4 or any(
            v.get("spill_stores") or v.get("spill_loads") for v in ln_bwd.values()):
        raise AssertionError(f"the norm backward's register form: expected its 24 "
                             f"kernels without spills, got {ln_bwd}")
    for source in NO_HMMA_SOURCES:
        if library_hmma[source]:
            raise AssertionError(f"{source}: {library_hmma[source]} HMMA "
                                 f"(mma.sync) instructions in its library")
    out = dict(kernels=rows, library_hmma=library_hmma,
               registers_note="ptxas's registers a thread and spill bytes; the "
               "16-bit flash backward kernels run 288 threads (two consumer "
               "warpgroups, one producer warp), the flash forward 256 (two "
               "warpgroups; two blocks an SM at d <= 64, at most 128 "
               "registers), the head forward 384 (a producer and two "
               "consumer warpgroups, setmaxnreg 40/232), the pair-bias "
               "forward 256 (two warpgroups; two blocks an SM at d <= 32, at "
               "most 128 registers), the pair-bias dq, dk/dv and dbias 288 "
               "(two consumer warpgroups, one producer warp); ln_fwd_rows/<x dtype>/nv<N>: the norm "
               "forward's register path, N 16-byte vectors a lane (the "
               "largest over its three weight dtypes); ln_bwd_rows/<x dtype>/"
               "nv<N>[+bias]: the norm backward's register form (256 threads, "
               "2-3 blocks an SM), no spill allowed; "
               "wgmma_serialized: ptxas's C7512 note that the function's wgmma "
               "run one at a time")
    log("phase2-wgmma-registers", **out)
    return out


def _traced_kernels(fn, reps: int = 1):
    """``fn`` called ``reps`` times under ``torch.profiler``: the traced
    wall ms a call, and the device-side kernel rows with time of their own
    (not the operators' rows, which carry their kernels' time too, nor
    user annotations such as the optimizer's step, which span kernels on
    the device timeline: either would count them twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / reps
    return traced_ms, _kernel_rows(prof)


def _kernel_rows(prof) -> list:
    """A finished ``torch.profiler`` run's device-side kernel rows with time
    of their own (see ``_traced_kernels``)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def _kernel_device_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each CUDA kernel that ``fn`` launches, traced
    (``_traced_kernels``) over ``calls`` calls after one untraced call."""
    fn()
    _, kernels = _traced_kernels(fn, calls)
    return {e.key: e.self_device_time_total / 1e3 / calls for e in kernels}


def _time_head_bwd_shape(shape: dict, seed: int, device) -> dict:
    """dH and dE at one head shape (bf16, a uniform g as the mean gives):
    each C call's device time, the dH call split into its two kernels (the
    logits with dlog, then the dH product) by the profiler, each product's
    TFLOP/s, cuBLAS ``torch.matmul`` on the same three products (a
    yardstick the port never calls), the plain backward and F.linear +
    F.cross_entropy's backward; returns ``{"dh": row, "de": row}``."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import fused_lm_head as lh

    t, hid, vocab = shape["t"], shape["hid"], shape["vocab"]
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(t, hid, generator=g, device=device).to(torch.bfloat16)
    e = (torch.randn(vocab, hid, generator=g, device=device) * 0.02
         ).to(torch.bfloat16)
    lab = torch.randint(0, vocab, (t,), generator=g, device=device)
    gvec = torch.full((t,), 1.0 / t, device=device)
    with torch.no_grad():
        _, lse = lh.fused_lm_head_fwd(h, e, lab)
        call = lh._BwdLaunch(h, e, lab, lse, gvec)
        call.launch(lh.FUSED_LM_HEAD_DH)            # dlog for dE
        dev_plain = time_ms(lambda: lh._plain_backward(h, e, lab, lse, gvec),
                            iters=3, warmup=1)
        rows = {}
        for name, kern in (("dh", lh.FUSED_LM_HEAD_DH),
                           ("de", lh.FUSED_LM_HEAD_DE)):
            fn = lambda kern=kern: call.launch(kern)
            rows[name] = dict(kernel=device_ms(fn, iters=10),
                              host=time_ms(fn, iters=10, warmup=2))
        for name, kern in (("dh", lh.FUSED_LM_HEAD_DH),
                           ("de", lh.FUSED_LM_HEAD_DE)):
            rows[name]["kernel_again"] = device_ms(
                lambda kern=kern: call.launch(kern), iters=10)
        split = _kernel_device_ms(lambda: call.launch(lh.FUSED_LM_HEAD_DH))
        part_ms = {"logits_dlog": sum(v for k, v in split.items() if "DlogStore" in k),
                   "dh_product": sum(v for k, v in split.items() if "TileStore" in k)}
        # cuBLAS on the operands the kernels work on: E padded to Vp rows,
        # so the logits have the Vp pitch of dlog, and dlog in full
        ep = torch.zeros(call.vp, hid, dtype=e.dtype, device=device)
        ep[:vocab] = e
        cublas = {"logits": device_ms(lambda: torch.matmul(h, ep.t()), iters=10),
                  "dh": device_ms(lambda: torch.matmul(call.dlog, ep), iters=10),
                  "de": device_ms(lambda: torch.matmul(call.dlog.t(), h), iters=10)}
    hr, er = h.detach().requires_grad_(), e.detach().requires_grad_()
    library = _fwd_bwd_minus_fwd(
        lambda: F.cross_entropy(F.linear(hr, er), lab, reduction="none"),
        ((hr, er), gvec), device_iters=5)
    prod = 2 * t * vocab * hid
    dlog_bytes = 2 * t * lh.padded_vocab(vocab)
    de_ms = min(rows["de"]["kernel"], rows["de"]["kernel_again"])
    tflops = {k: prod / ms / 1e9 if ms else "not measured" for k, ms in (
        ("logits", part_ms["logits_dlog"]), ("dh", part_ms["dh_product"]),
        ("de", de_ms))}
    # each part's bound: its product, or its bytes (H, E, labels, lse and g
    # read and dlog written; dlog and E read and dH written)
    part_bound = {
        "logits_dlog": max(prod / 989e12, (2 * (t * hid + vocab * hid) + 12 * t
                                           + dlog_bytes) / HBM_BYTES_PER_S) * 1e3,
        "dh_product": max(prod / 989e12, (dlog_bytes + 2 * (vocab * hid + t * hid))
                          / HBM_BYTES_PER_S) * 1e3}
    out = {}
    for name, nprod, nbytes in (
            # the logits recompute and dlog E; H, E, labels, lse, g read,
            # dlog written and read, dH written
            ("dh", 2, 2 * (2 * t * hid + vocab * hid) + 12 * t + 2 * dlog_bytes),
            # dlog^T H: dlog and H read, dE written
            ("de", 1, dlog_bytes + 2 * (t * hid + vocab * hid))):
        r = rows[name]
        dev = dict(kernel=r["kernel"], kernel_again=r["kernel_again"],
                   plain=dev_plain, library=library)
        row = _row(dev, r["host"], nprod * prod, nbytes, 989e12)
        row.update(shape=dict(shape, dtype="bfloat16"), flops=nprod * prod,
                   bytes=nbytes, plain_and_library_compute="dH and dE together",
                   library_call="F.linear + F.cross_entropy forward + "
                                "backward minus forward (CUDA graphs of 5)")
        if name == "dh":
            row.update(split_ms=part_ms, split_bound_ms=part_bound,
                       tflops={k: tflops[k] for k in ("logits", "dh")},
                       cublas_matmul_ms={k: cublas[k] for k in ("logits", "dh")},
                       split_timing="torch.profiler, 5 calls of the dH call")
        else:
            row.update(tflops={"de": tflops["de"]},
                       cublas_matmul_ms={"de": cublas["de"]})
        row["cublas_call"] = ("torch.matmul on the same product over the "
                              "kernels' Vp = vocab rounded up to 64, bf16 out "
                              "(logits H Ep^T, dlog Ep, dlog^T H with E "
                              "zero-padded to Ep [Vp, h]; CUDA graphs of 10); "
                              "a yardstick, never called by the port")
        out[name] = row
    return out


def time_lm_head_bwd(device) -> dict:
    """dH and dE at the main path's shape (T 8192, h 2048, V 32000) and at
    GPT-2-large's head (T 8192, h 1280, V 50257), each as
    ``_time_head_bwd_shape`` gives it; returns ``{"dh": row, "de": row}``
    at the main shape with ``"gpt2_large"`` beside them."""
    out = _time_head_bwd_shape(HEAD_MAIN, 26, device)
    for name in ("dh", "de"):
        log("phase2-time", kernel=f"fused_lm_head_{name}", **out[name])
    out["gpt2_large"] = _time_head_bwd_shape(HEAD_GPT, 27, device)
    for name in ("dh", "de"):
        log("phase2-time", kernel=f"fused_lm_head_{name}",
            **out["gpt2_large"][name])
    return out


# ---------------------------------------------------------------------------
# phase 2: the fused softmax and packed LAMB kernels against their plain
# versions
# ---------------------------------------------------------------------------

# GPT-2-large's attention scores: b 8, 20 heads, s 1024, head dim 64
# (bench.py:81-84), bf16 under O2, causal, no explicit mask
SOFTMAX_MAIN = dict(b=8, h=20, sq=1024, sk=1024)
SOFTMAX_SCALE = 1.0 / 64 ** 0.5
def gpt2_large_numel() -> tuple:
    """``(parameters, packed length)`` of GPT-2-large (``bench.py``'s
    ``large`` card): the tied embedding, the position table, 36 layers (two
    LayerNorms, QKV, dense and the 4h MLP, with biases) and the final
    LayerNorm; packed to 1024."""
    from apex_tpu_torch.examples.gpt_pretrain import LARGE

    L, h = LARGE["layers"], LARGE["hidden"]
    per_layer = 4 * h + (3 * h * h + 3 * h) + (h * h + h) + \
        (4 * h * h + 4 * h) + (4 * h * h + h)
    n = LARGE["vocab"] * h + LARGE["seq"] * h + L * per_layer + 2 * h
    return n, -(-n // 1024) * 1024


def _softmax_case_inputs(case, g, device):
    import torch

    dt = getattr(torch, case["dtype"])
    b, h, sq, sk = (case[k] for k in ("b", "h", "sq", "sk"))
    off = case.get("offset", 0)
    # an offset of one element puts x off its 16-byte boundary (the
    # kernel's scalar path); the model's scores are contiguous
    x = ((torch.randn(b * h * sq * sk + off, generator=g, device=device) * 3)
         .to(dt)[off:].view(b, h, sq, sk))
    if case.get("low"):
        # every scaled score far below the fill: y past the causal edge is
        # not 0, and the backward must read the whole row
        x = (x.float() - 15000).to(dt)
    mask = None
    if case.get("mask"):
        mask = torch.rand(b, 1, sq, sk, generator=g, device=device) < 0.3
        mask[:, :, ::5] = True                     # fully masked rows
        if case["mask"] == "broadcast":
            mask = mask[:1]
    return x, mask


def _softmax_bwd_tol(y, dy, scale):
    """Per-element bound of dx: the row's fp32 inner product within
    EPS_SUM of its terms' absolute sum, the elementwise step's roundings,
    then one ulp of the output (and fp32's least normal near zero)."""
    y32, dy32 = y.float(), dy.float()
    s_abs = (y32 * dy32).abs().sum(-1, keepdim=True)
    dot = (y32 * dy32).sum(-1, keepdim=True)
    err = scale * y32.abs() * (EPS_SUM * s_abs + 2.0 ** -20 * (dy32.abs() + dot.abs()))
    return err + 1e-30


def check_softmax(device) -> dict:
    """The softmax forward and backward kernels on the card against their
    plain versions over dtypes, no mask / causal / a mask with fully
    masked rows / both, sq = sk, sq < sk, sq > sk (the causal zero rows),
    an odd sk, rows longer than the registers (the looping variant, up to
    the maximum of 16384), a broadcast mask, an input off its 16-byte
    boundary, sk = 1, causal scores far below the fill (the backward reads
    past the edge), and the main path's shape; a row above the maximum
    must raise.  Returns the main shape's errors."""
    import torch
    from apex_tpu_torch.ops import softmax as sm

    cases = []
    for dt in _DTYPES:
        for causal, mask in ((False, None), (True, None), (False, "rows"),
                             (True, "rows")):
            for b, h, sq, sk in ((2, 3, 128, 128), (2, 2, 100, 260),
                                 (2, 2, 260, 100), (1, 2, 33, 77),
                                 (1, 2, 7, 1001), (1, 2, 16, 3000),
                                 (1, 1, 4, sm.MAX_SK)):
                cases.append(dict(dtype=dt, causal=causal, mask=mask, b=b,
                                  h=h, sq=sq, sk=sk))
        cases.append(dict(dtype=dt, causal=False, mask="broadcast", b=2, h=2,
                          sq=64, sk=200))
        cases.append(dict(dtype=dt, causal=True, mask=None, b=2, h=2, sq=64,
                          sk=128, offset=1))
        cases.append(dict(dtype=dt, causal=True, mask=None, b=1, h=2, sq=8,
                          sk=1))
        for sq, sk in ((64, 200), (16, 3000)):
            cases.append(dict(dtype=dt, causal=True, mask=None, b=1, h=2,
                              sq=sq, sk=sk, low=True))
    cases.append(dict(SOFTMAX_MAIN, dtype="bfloat16", causal=True, mask=None,
                      main=True))
    g = torch.Generator(device=device).manual_seed(31)
    worst_y = worst_dx = 0.0
    main = {}
    with torch.no_grad():
        for case in cases:
            x, mask = _softmax_case_inputs(case, g, device)
            scale = SOFTMAX_SCALE if case.get("main") else 0.7
            y = sm.softmax_fwd(x, scale, mask, case["causal"])
            torch.cuda.synchronize()
            ry = sm._plain_forward(x, scale, mask, case["causal"])
            # exp and the row sum in fp32 on both sides, in another order
            y_tol = EPS_SUM * ry.float().abs() + 1e-30
            if case["dtype"] != "float32":
                y_tol = _ulp_tol(y_tol, ry, y, case["dtype"])
            r_y = _tol_ratio(y, ry, y_tol)
            dead = ry.float().sum(-1) == 0
            zeros_ok = bool((y[dead] == 0).all())
            dy = torch.randn(x.shape, generator=g, device=device).to(x.dtype)
            dx = sm.softmax_bwd(y, dy, scale, case["causal"])
            torch.cuda.synchronize()
            rdx = sm._plain_backward(y, dy, scale)
            dx_tol = _softmax_bwd_tol(y, dy, scale)
            if case["dtype"] != "float32":
                dx_tol = _ulp_tol(dx_tol, rdx, dx, case["dtype"])
            r_dx = _tol_ratio(dx, rdx, dx_tol)
            name = {k: case[k] for k in case if k not in ("b", "h")}
            if r_y > 1.0 or r_dx > 1.0 or not zeros_ok:
                raise AssertionError(
                    f"scaled softmax disagrees with its plain version: "
                    f"{name}: y at {r_y:.3f} x tol, dx at {r_dx:.3f} x tol, "
                    f"rows with no valid key all zero: {zeros_ok}")
            worst_y, worst_dx = max(worst_y, r_y), max(worst_dx, r_dx)
            if case.get("main"):
                main = dict(y_max_abs_err=float((y.float() - ry.float()).abs().max()),
                            dx_max_abs_err=float((dx.float() - rdx.float()).abs().max()),
                            y_tol_ratio=r_y, dx_tol_ratio=r_dx)
            del x, y, ry, dy, dx, rdx
        too_long = torch.zeros(1, 1, 1, sm.MAX_SK + 1, device=device)
        try:
            sm.softmax_fwd(too_long, 1.0, None, False)
            raised = False
        except ValueError:
            raised = True
        if not raised:
            raise AssertionError(f"softmax_fwd took sk = {sm.MAX_SK + 1}, "
                                 f"above its stated maximum")
    out = dict(kernel="scaled_softmax_fwd/bwd", cases=len(cases),
               worst_y_tol_ratio=worst_y, worst_dx_tol_ratio=worst_dx,
               main_shape=main, raises_above_max_sk=raised,
               tolerance="y within 2^-16|ref| (+ 1 ulp of bf16/fp16); rows "
                         "with no valid key exactly 0; dx within scale|y| "
                         "(2^-16 sum_j|y_j dy_j| + 2^-20 (|dy| + |y.dy|)) "
                         "(+ 1 ulp of bf16/fp16)")
    log("phase2-check", **out)
    return out


def time_softmax(device) -> dict:
    """Forward and backward kernels, plain versions and library calls at
    the main path's shape (x bf16 [8, 20, 1024, 1024], causal, scale 1/8):
    ``torch.softmax`` of a pre-masked input and
    ``aten._softmax_backward_data``.  Returns ``{"fwd": row, "bwd": row}``."""
    import torch
    from apex_tpu_torch.ops import softmax as sm

    b, h, sq, sk = (SOFTMAX_MAIN[k] for k in ("b", "h", "sq", "sk"))
    scale = SOFTMAX_SCALE
    g = torch.Generator(device=device).manual_seed(32)
    x = (torch.randn(b, h, sq, sk, generator=g, device=device) * 3).to(torch.bfloat16)
    dy = torch.randn(b, h, sq, sk, generator=g, device=device).to(torch.bfloat16)
    tri = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)
    x_masked = torch.where(tri, x.float() * scale, -10000.0).to(torch.bfloat16)
    elems = b * h * sq * sk
    # the causal triangle's elements: all the forward needs to read of x,
    # and all the backward needs of y and dy where y is 0 past the edge
    # (the backward reads one y past each row's edge to see that)
    valid = b * h * int(tri.sum())
    probes = b * h * int((tri.sum(-1) < sk).sum())
    out = {}
    with torch.inference_mode():
        y = sm.softmax_fwd(x, scale, None, True)
        if bool(torch.where(tri, 0, y).any()):
            raise AssertionError("y is not 0 past the causal edge at the main "
                                 "shape: the backward's bound reads all of it")
        for name, calls, nbytes, flops in (
                ("fwd", {"kernel": lambda: sm.softmax_fwd(x, scale, None, True),
                         "plain": lambda: sm._plain_forward(x, scale, None, True),
                         "library": lambda: torch.softmax(x_masked, -1)},
                 2 * valid + 2 * elems, 8 * elems),
                ("bwd", {"kernel": lambda: sm.softmax_bwd(y, dy, scale, True),
                         "plain": lambda: sm._plain_backward(y, dy, scale),
                         "library": lambda: torch.ops.aten._softmax_backward_data(
                             dy, y, -1, torch.bfloat16)},
                 2 * 2 * valid + 2 * probes + 2 * elems, 5 * valid)):
            dev = _timed(calls, 20, big=("plain",))
            host = time_ms(calls["kernel"], iters=20, warmup=3)
            row = _row(dev, host, flops, nbytes, FP32_OPS_PER_S)
            row.update(shape=dict(SOFTMAX_MAIN, causal=True, dtype="bfloat16"),
                       bytes=nbytes, flops=flops,
                       library_call=("torch.softmax of the pre-masked scores"
                                     if name == "fwd" else
                                     "aten._softmax_backward_data"),
                       bytes_note=("x's causal triangle read, y written"
                                   if name == "fwd" else
                                   "y's and dy's causal triangles and one y a "
                                   "row read, dx written"))
            log("phase2-time", kernel=f"scaled_softmax_{name}", **row)
            out[name] = row
    return out


def check_lamb_phase1(device) -> dict:
    """The LAMB phase-1 kernel on the card against its plain version over
    gradient and parameter dtypes, both ``adam_w_mode``s, an n that is a
    multiple of the vector width, one that is not (the tail), buffers off
    their 16-byte boundary (the scalar path), a clip factor from a device
    tensor, and the main path's length (GPT-2-large, fp32).  Returns the
    main case's errors."""
    import torch
    from apex_tpu_torch.ops import packed_update as pu

    _, main_n = gpt2_large_numel()
    cases = [dict(g=gd, p=pd, adam_w=aw, n=n, offset=off)
             for gd, pd in (("float32", "float32"), ("bfloat16", "bfloat16"),
                            ("float16", "float32"), ("bfloat16", "float32"))
             for aw in (True, False)
             for n, off in ((1024 * 37, 0), (1000003, 0), (4099, 1))]
    cases.append(dict(g="float32", p="float32", adam_w=True, n=main_n,
                      offset=0, main=True))
    gen = torch.Generator(device=device).manual_seed(33)
    clip = torch.tensor(1.7, device=device)
    worst, main = 0.0, {}
    with torch.no_grad():
        for case in cases:
            n, off = case["n"], case["offset"]

            def buf(scale, dtype=torch.float32, positive=False):
                t = torch.randn(n + off, generator=gen, device=device) * scale
                return (t.abs() if positive else t).to(dtype)

            g = buf(0.1, getattr(torch, case["g"]))[off:]
            p = buf(1.0, getattr(torch, case["p"]))[off:]
            m_buf, v_buf = buf(0.01), buf(1e-3, positive=True)
            m, v = m_buf[off:], v_buf[off:]
            s = pu.lamb_scalars(0.9, 0.1, 0.999, 1e-6, 0.01, 0.19, 0.002,
                                clip, device)
            rm, rv, ru = pu._plain_phase1(g, p, m, v, s, case["adam_w"])
            mk_buf, vk_buf = m_buf.clone(), v_buf.clone()
            mk, vk = mk_buf[off:], vk_buf[off:]
            u = pu.lamb_phase1(g, p, mk, vk, s, case["adam_w"])
            torch.cuda.synchronize()
            # a few fp32 roundings apart (contracted multiply-adds)
            wp = 0.01 * p.float().abs()
            tol_m = 2.0 ** -21 * (0.9 * m.abs() + 0.1 * (g.float().abs() / 1.7
                                                         + wp)) + 1e-30
            tol_v = 2.0 ** -21 * (0.999 * v + 0.001 * (g.float().abs() / 1.7
                                                       + wp) ** 2) + 1e-30
            # u carries m's and v's errors through (m / bc1) / (sqrt(v /
            # bc2) + eps), the latter halved by the root
            tol_u = ((tol_m / 0.19) / (torch.sqrt(rv / 0.002) + 1e-6)
                     + 0.5 * ru.abs() * tol_v / (rv + 1e-30)
                     + 2.0 ** -19 * (ru.abs() + wp) + 1e-30)
            r = max(_tol_ratio(mk, rm, tol_m), _tol_ratio(vk, rv, tol_v),
                    _tol_ratio(u, ru, tol_u))
            if r > 1.0:
                raise AssertionError(f"lamb_phase1 disagrees with its plain "
                                     f"version: {case}: {r:.3f} x tol")
            worst = max(worst, r)
            if case.get("main"):
                main = dict(m_max_abs_err=float((mk - rm).abs().max()),
                            v_max_abs_err=float((vk - rv).abs().max()),
                            u_max_abs_err=float((u - ru).abs().max()),
                            tol_ratio=r)
            del g, p, m_buf, v_buf, m, v, rm, rv, ru, mk_buf, vk_buf, mk, vk, u
            torch.cuda.empty_cache()
    out = dict(kernel="lamb_phase1", cases=len(cases), worst_tol_ratio=worst,
               main_shape=main,
               tolerance="m within 2^-21 (b1|m| + b3(|g|/clip + wd|p|)); v "
                         "within 2^-21 (b2 v + (1-b2)(|g|/clip + wd|p|)^2); "
                         "u within m's and v's bounds carried through the "
                         "update, plus 2^-19 (|u| + wd|p|)")
    log("phase2-check", **out)
    return out


def time_lamb_phase1(device) -> dict:
    """The phase-1 kernel and its plain version over GPT-2-large's packed
    fp32 buffers (g, p, m, v of the padded length), eagerly between CUDA
    events (each call moves GBs).  No single PyTorch call computes the
    function, so there is no library time."""
    import torch
    from apex_tpu_torch.ops import packed_update as pu

    _, n = gpt2_large_numel()
    gen = torch.Generator(device=device).manual_seed(34)
    g = torch.randn(n, generator=gen, device=device) * 0.1
    p = torch.randn(n, generator=gen, device=device)
    m = torch.randn(n, generator=gen, device=device) * 0.01
    v = (torch.randn(n, generator=gen, device=device) * 1e-3).abs_()
    s = pu.lamb_scalars(0.9, 0.1, 0.999, 1e-6, 0.01, 0.19, 0.002,
                        torch.tensor(1.7, device=device), device)
    with torch.no_grad():
        kernel = lambda: pu.lamb_phase1(g, p, m, v, s, True)
        dev = dict(kernel=time_ms(kernel, iters=10, warmup=2),
                   plain=time_ms(lambda: pu._plain_phase1(g, p, m, v, s, True),
                                 iters=3, warmup=1),
                   library=None)
        dev["kernel_again"] = time_ms(kernel, iters=10, warmup=1)
        host = dev["kernel"]
    nbytes = 28 * n          # g, p, m, v read; m, v, u written; all fp32
    flops = 15 * n
    row = _row(dev, host, flops, nbytes, FP32_OPS_PER_S)
    row.update(shape=dict(n=n, dtype="float32", model="gpt2-large"),
               bytes=nbytes, flops=flops,
               timing="ms: 10 eager calls between CUDA events (each moves "
                      "21.7 GB; launch overhead is negligible); plain_ms: 3",
               library_call=None,
               library_note="no single PyTorch call computes LAMB's moments "
                            "and raw update")
    log("phase2-time", kernel="lamb_phase1", **row)
    del g, p, m, v
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 2: the packed Adam and Adagrad kernels against their plain versions
# ---------------------------------------------------------------------------

# the step scalars of the checks and timings: step 2 of Adam at betas
# (0.9, 0.999) gives bias corrections 0.19 and ~0.002
ADAM_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, bc1=0.19,
                  bc2=0.002)
ADAGRAD_HYPER = dict(lr=1e-2, eps=1e-10)


def llama_1b_numel() -> int:
    """Parameters of the ``llama-1b`` card (``bench.py:103-108``): the
    embedding and the separate head, 22 layers (q, k, v, o over 8 kv heads
    of 64, the SwiGLU MLP, two RMSNorm scales) and the final norm: 1.123 B,
    a multiple of 1024, so its packed length is the same."""
    from apex_tpu_torch.models import LlamaConfig

    c = LlamaConfig.llama_1b()
    h, kv = c.hidden_size, c.kv_heads * (c.hidden_size // c.num_attention_heads)
    per_layer = 2 * h * h + 2 * h * kv + 3 * h * c.intermediate_size + 2 * h
    return 2 * c.vocab_size * h + c.num_hidden_layers * per_layer + h


def _adam_tols(g, p, m, v, rp, rm, rv, wd, p_dtype):
    """Per-element tolerances of the packed Adam kernel against its plain
    version: the kernel contracts multiply-adds, so each fp32 result sits
    a few roundings from the plain one, and an error in m or v carries
    through the update (v's halved by the root)."""
    import torch

    h = ADAM_HYPER
    g32, p32 = g.float(), p.float()
    ga = g32.abs() + wd * p32.abs()
    tol_m = 2.0 ** -21 * (h["beta1"] * m.abs() + (1 - h["beta1"]) * ga) + 1e-30
    tol_v = 2.0 ** -21 * (h["beta2"] * v + (1 - h["beta2"]) * ga * ga) + 1e-30
    denom = torch.sqrt(rv / h["bc2"]) + h["eps"]
    u = (rm / h["bc1"]) / denom
    tol_u = (tol_m / h["bc1"] / denom + 0.5 * u.abs() * tol_v / (rv + 1e-30)
             + 2.0 ** -19 * (u.abs() + wd * p32.abs()))
    tol_p = h["lr"] * tol_u + 2.0 ** -21 * rp.float().abs() + 1e-30
    if p_dtype != "float32":
        # a few fp32 roundings apart can put p on either side of a rounding
        # boundary of its own dtype
        tol_p = tol_p + _ulp(rp, p_dtype)
    return tol_p, tol_m, tol_v


def _adagrad_tols(g, p, h_old, rp, rh, wd, p_dtype):
    """Per-element tolerances of the packed Adagrad kernel against its
    plain version (contracted multiply-adds; h's error halved by the
    root in the update)."""
    import torch

    hy = ADAGRAD_HYPER
    ga = g.float().abs() + wd * p.float().abs()
    tol_h = 2.0 ** -21 * (h_old + ga * ga) + 1e-30
    u = ga / (torch.sqrt(rh) + hy["eps"])
    tol_u = (u * (0.5 * tol_h / (rh + 1e-30) + 2.0 ** -20)
             + 2.0 ** -20 * wd * p.float().abs())
    tol_p = hy["lr"] * tol_u + 2.0 ** -21 * rp.float().abs() + 1e-30
    if p_dtype != "float32":
        tol_p = tol_p + _ulp(rp, p_dtype)
    return tol_p, tol_h


def _packed_inputs(n, off, g_dtype, p_dtype, gen, device, kind):
    """g, p and the fp32 state (m and v, or h) of one case, each ``off``
    elements past its allocation's start (off 1: not 16-byte aligned)."""
    import torch

    def buf(scale, dtype=torch.float32, positive=False):
        t = torch.randn(n + off, generator=gen, device=device) * scale
        return (t.abs() if positive else t).to(dtype)[off:]

    x = dict(g=buf(0.1, getattr(torch, g_dtype)),
             p=buf(1.0, getattr(torch, p_dtype)))
    if kind == "adam":
        x.update(m=buf(0.01), v=buf(1e-3, positive=True))
    else:
        x.update(h=buf(1e-2, positive=True))
    return x


def _run_packed(kind, x, adam_w, wd, noop, device):
    """The kernel on copies of the case's buffers (the flag and a bias
    correction as device tensors); returns the updated copies, in the
    order of the plain version's outputs."""
    import torch
    from apex_tpu_torch.ops import packed_update as pu

    flag = torch.tensor(bool(noop), device=device)
    if kind == "adam":
        h = ADAM_HYPER
        p, m, v = x["p"].clone(), x["m"].clone(), x["v"].clone()
        return pu.packed_adam_update(
            x["g"], p, m, v, lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
            eps=h["eps"], weight_decay=wd, bias_correction1=h["bc1"],
            bias_correction2=torch.tensor(h["bc2"], device=device),
            noop_flag=flag, adam_w_mode=adam_w)
    h = ADAGRAD_HYPER
    p, hh = x["p"].clone(), x["h"].clone()
    return pu.packed_adagrad_update(x["g"], p, hh, lr=h["lr"], eps=h["eps"],
                                    weight_decay=wd, adagrad_w_mode=adam_w,
                                    noop_flag=flag)


def _plain_packed(kind, x, adam_w, wd, device, sl=slice(None)):
    """The plain version on the case's buffers (or a slice of them)."""
    from apex_tpu_torch.ops import packed_update as pu

    if kind == "adam":
        h = ADAM_HYPER
        s = pu.adam_scalars(h["lr"], h["beta1"], h["beta2"], h["eps"], wd,
                            h["bc1"], h["bc2"], 0.0, device)
        return pu._plain_adam(x["g"][sl], x["p"][sl], x["m"][sl], x["v"][sl],
                              s, adam_w)
    h = ADAGRAD_HYPER
    s = pu.adagrad_scalars(h["lr"], h["eps"], wd, 0.0, device)
    return pu._plain_adagrad(x["g"][sl], x["p"][sl], x["h"][sl], s, adam_w)


def _packed_ratio(kind, x, got, ref, wd, p_dtype, sl=slice(None)) -> float:
    if kind == "adam":
        tols = _adam_tols(x["g"][sl], x["p"][sl], x["m"][sl], x["v"][sl],
                          *ref, wd, p_dtype)
    else:
        tols = _adagrad_tols(x["g"][sl], x["p"][sl], x["h"][sl], *ref, wd,
                             p_dtype)
    return max(_tol_ratio(o[sl], r, t) for o, r, t in zip(got, ref, tols))


def check_packed_updates(device) -> dict:
    """The packed Adam and Adagrad kernels on the card against their plain
    versions over p fp32/bf16/fp16, g fp32/bf16, both modes, weight decay 0
    and 0.01, noop 0 and 1 (a set flag must leave every buffer's bits as
    they were), n = 1, 1000, 1024 and 2,000,003 (odd, past one grid
    stride), two unaligned cases (the scalar path, fp16 g); then the main
    path's length, Llama-1B's packed fp32 masters (1.123 B elements),
    compared in slices of 2^26.  Returns each kernel's cases and main
    errors."""
    import torch

    gen = torch.Generator(device=device).manual_seed(35)
    out = {}
    with torch.no_grad():
        for kind in ("adam", "adagrad"):
            names = ("p", "m", "v") if kind == "adam" else ("p", "h")
            cases = [dict(g=gd, p=pd, adam_w=aw, wd=wd, noop=noop, n=n, off=0)
                     for gd in ("float32", "bfloat16")
                     for pd in ("float32", "bfloat16", "float16")
                     for aw in (True, False) for wd in (0.0, 0.01)
                     for noop in (0, 1) for n in (1, 1000, 1024, 2_000_003)]
            cases += [dict(g="float16", p="float32", adam_w=True, wd=0.01,
                           noop=0, n=4099, off=1),
                      dict(g="bfloat16", p="float16", adam_w=False, wd=0.01,
                           noop=1, n=4099, off=1)]
            worst = 0.0
            for case in cases:
                x = _packed_inputs(case["n"], case["off"], case["g"],
                                   case["p"], gen, device, kind)
                got = _run_packed(kind, x, case["adam_w"], case["wd"],
                                  case["noop"], device)
                torch.cuda.synchronize()
                if case["noop"]:
                    if not all(torch.equal(a, x[k]) for a, k in zip(got, names)):
                        raise AssertionError(f"packed_{kind} with noop 1 "
                                             f"changed a buffer: {case}")
                    continue
                ref = _plain_packed(kind, x, case["adam_w"], case["wd"], device)
                r = _packed_ratio(kind, x, got, ref, case["wd"], case["p"])
                if r > 1.0:
                    raise AssertionError(f"packed_{kind} disagrees with its "
                                         f"plain version: {case}: {r:.3f} x "
                                         f"tol")
                worst = max(worst, r)
            # the main path: Llama-1B's fp32 masters, AdamW / L2 Adagrad
            n = llama_1b_numel()
            x = _packed_inputs(n, 0, "float32", "float32", gen, device, kind)
            got = _run_packed(kind, x, True, 0.0, 0, device)
            torch.cuda.synchronize()
            errs = {k: 0.0 for k in names}
            main_worst, step = 0.0, 1 << 26
            for a in range(0, n, step):
                sl = slice(a, min(a + step, n))
                ref = _plain_packed(kind, x, True, 0.0, device, sl)
                main_worst = max(main_worst, _packed_ratio(
                    kind, x, got, ref, 0.0, "float32", sl))
                for k, o, r in zip(names, got, ref):
                    errs[k] = max(errs[k], float((o[sl] - r).abs().max()))
                del ref
            if main_worst > 1.0:
                raise AssertionError(f"packed_{kind} at Llama-1B's length "
                                     f"disagrees: {main_worst:.3f} x tol")
            del x, got
            torch.cuda.empty_cache()
            out[kind] = dict(
                kernel=f"packed_{kind}", cases=len(cases) + 1,
                worst_tol_ratio=max(worst, main_worst),
                main_shape=dict(n=n, dtype="float32", tol_ratio=main_worst,
                                **{f"{k}_max_abs_err": e
                                   for k, e in errs.items()}),
                tolerance="fp32 results a few roundings apart (contracted "
                          "multiply-adds): each moment within 2^-21 of its "
                          "terms' magnitudes; the update within those "
                          "carried through, plus 2^-19 of itself; p within "
                          "lr times that plus 2^-21 |p|, plus one ulp of "
                          "its dtype for bf16/fp16; noop 1: every buffer's "
                          "bits unchanged")
            log("phase2-check", **out[kind])
    return out


def time_packed_updates(device) -> dict:
    """The packed Adam and Adagrad kernels at Llama-1B's packed fp32
    masters (1.123 B elements; four 4.5 GB buffers), eagerly between CUDA
    events (each call moves 22-31 GB), beside their bytes bounds (28 and 20
    bytes an element), their plain versions and the library calls:
    ``torch._fused_adamw_`` over the one flat tensor (the same function
    with its arithmetic regrouped); ``torch._fused_adagrad_`` where this
    PyTorch has a CUDA kernel for it, else none."""
    import torch
    from apex_tpu_torch.ops import packed_update as pu

    n = llama_1b_numel()
    gen = torch.Generator(device=device).manual_seed(36)
    g = torch.randn(n, generator=gen, device=device) * 0.1
    p = torch.randn(n, generator=gen, device=device)
    out = {}
    with torch.no_grad():
        for kind in ("adam", "adagrad"):
            step = torch.tensor(2.0, device=device)
            if kind == "adam":
                h = ADAM_HYPER
                m = torch.randn(n, generator=gen, device=device) * 0.01
                v = (torch.randn(n, generator=gen, device=device) * 1e-3).abs_()
                s = pu.adam_scalars(h["lr"], h["beta1"], h["beta2"], h["eps"],
                                    0.0, h["bc1"], h["bc2"], 0.0, device)
                kernel = lambda: pu._kernel_adam(g, p, m, v, s, True)
                plain = lambda: pu._plain_adam(g, p, m, v, s, True)
                lib_op = "aten::_fused_adamw_"
                library = lambda: torch._fused_adamw_(
                    [p], [g], [m], [v], [], [step], lr=h["lr"],
                    beta1=h["beta1"], beta2=h["beta2"], weight_decay=0.0,
                    eps=h["eps"], amsgrad=False, maximize=False)
                nbytes, flops = 28 * n, 16 * n
            else:
                h = ADAGRAD_HYPER
                hh = (torch.randn(n, generator=gen, device=device) * 1e-2).abs_()
                s = pu.adagrad_scalars(h["lr"], h["eps"], 0.0, 0.0, device)
                kernel = lambda: pu._kernel_adagrad(g, p, hh, s, False)
                plain = lambda: pu._plain_adagrad(g, p, hh, s, False)
                lib_op = "aten::_fused_adagrad_"
                library = lambda: torch._fused_adagrad_(
                    [p], [g], [hh], [step], lr=h["lr"], lr_decay=0.0,
                    weight_decay=0.0, eps=h["eps"], maximize=False)
                nbytes, flops = 20 * n, 7 * n
            # whether this PyTorch registers a CUDA kernel for the library
            # op (torch's fused Adagrad has been CPU-only)
            has_lib = torch._C._dispatch_has_kernel_for_dispatch_key(
                lib_op, "CUDA")
            dev = dict(kernel=time_ms(kernel, iters=10, warmup=2),
                       plain=time_ms(plain, iters=3, warmup=1),
                       library=(time_ms(library, iters=10, warmup=2)
                                if has_lib else None))
            dev["kernel_again"] = time_ms(kernel, iters=10, warmup=1)
            row = _row(dev, dev["kernel"], flops, nbytes, FP32_OPS_PER_S)
            row.update(shape=dict(n=n, dtype="float32", model="llama-1b"),
                       bytes=nbytes, flops=flops,
                       timing=f"ms/library_ms: 10 eager calls between CUDA "
                              f"events (each moves {nbytes / 1e9:.1f} GB; "
                              f"launch overhead is negligible); plain_ms: 3",
                       library_call=(f"torch.{lib_op.split('::')[1]} over the "
                                     f"one flat tensor" if has_lib else None),
                       library_note=None if has_lib else
                       f"none: this PyTorch ({torch.__version__}) has no CUDA "
                       f"kernel for {lib_op} (CPU only)")
            log("phase2-time", kernel=f"packed_{kind}", **row)
            out[kind] = row
            del kernel, plain, library, s
            if kind == "adam":
                del m, v
            else:
                del hh
            torch.cuda.empty_cache()
    del g, p
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2: the multi-tensor kernels against their plain versions
# ---------------------------------------------------------------------------

MT_CHUNK = 1 << 16
# mt_lamb's threads a block (csrc/multi_tensor.cu kLambThreads): a thread's
# run of a span, in its norms' tolerance
MT_LAMB_THREADS = 512
MT_SIZE_LISTS = {
    "one": (4099,),
    "three": (1, 7, MT_CHUNK + 1),
    "six": (1, 7, MT_CHUNK, MT_CHUNK + 1, 4099, 3 * MT_CHUNK - 5),
    # 200 tensors and 400 chunks: past one table of Apex's (110 tensors,
    # 320 chunks a launch)
    "many": (1, 7, 4099, MT_CHUNK + 1, 4 * MT_CHUNK + 5) * 40,
}
# mt_lamb's grouped walk: one tensor past the 32 MB budget (bf16 g, p, m,
# v: 8 bytes an element) among 80 small ones, a group of its own
MT_LAMB_BIG = (1, 4099) * 20 + (5_000_003,) + (7, MT_CHUNK + 1) * 20
MT_ADAM_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)
MT_LAMB_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6)


def _mt_tensors(sizes, dtype, gen, device, scale=1.0, positive=False, off=0):
    """One list of tensors of ``sizes`` in ``dtype`` (name or dtype), each
    ``off`` elements past its allocation's start (off 1: not 16-byte
    aligned, the kernels' one-element path)."""
    import torch

    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = []
    for n in sizes:
        t = torch.randn(n + off, generator=gen, device=device) * scale
        out.append((t.abs() if positive else t).to(dt)[off:])
    return out


def _mt_norm_rel(n: int, chunk: int = MT_CHUNK, parts=None,
                 threads: int = 512) -> float:
    """Relative tolerance of a sum of ``n`` squares taken by a walker
    kernel over pieces of at most ``chunk`` elements (a thread's run of 8
    terms for every ``threads`` x 8 elements of its piece, the block's tree
    of about 32 levels of warps and lanes, the tensor's ``parts`` partials
    in turn, one a chunk where not given) against torch.sum's cascade
    (about 2 log2 n levels): each level one fp32 rounding."""
    terms = 8 * -(-min(chunk, max(n, 1)) // (threads * 8))
    parts = max(1, -(-n // chunk)) if parts is None else parts
    return U32 * (terms + 32 + parts + 2 * math.log2(n + 1))


def _mt_chunk(sizes) -> int:
    """The chunk the walker's table takes for a list of ``sizes`` on this
    card (``ops/multi_tensor.py`` ``choose_chunk``)."""
    from apex_tpu_torch.ops import multi_tensor as mt

    return mt.choose_chunk(sizes, mt.resident_blocks())


def _mt_lamb_norm_rels(lists, n_ratio=None) -> list:
    """Per tensor of mt_lamb's lists (g, p, m, v), the relative tolerance
    of its two norms' sums (``_mt_norm_rel`` over its group's spans: a
    thread's run of one span, the tensor's span partials in turn; a narrow
    group's tensor by one block whole), or None for a tensor past
    ``n_ratio`` (ratio 1, no norm taken)."""
    from apex_tpu_torch.ops import multi_tensor as mt

    sizes = [t.numel() for t in lists[0]]
    plan = mt.lamb_list_plan(lists, mt.LAMB_BUDGET)[0]
    out = []
    for gi, (t0, t1) in enumerate(plan.groups):
        narrow = plan.padded[gi] <= mt.LAMB_NARROW     # one block, one part
        S = plan.span[gi]
        for t in range(t0, t1):
            off, n = int(plan.offsets[t]), sizes[t]
            parts = (off + n - 1) // S - off // S + 1 if n else 1
            out.append(_mt_norm_rel(n, max(n, 1), 1, MT_LAMB_THREADS)
                       if narrow else
                       _mt_norm_rel(n, S, parts, MT_LAMB_THREADS))
    n_ratio = len(sizes) if n_ratio is None else n_ratio
    return [r if t < n_ratio else None for t, r in enumerate(out)]


def mt_lamb_floor_ms(lists, budget, writes) -> float:
    """The least DRAM time of mt_lamb's grouped walk over ``lists`` (g, p,
    m, v; ``writes`` the lists it stores): each group's stage-1 reads,
    stage 2's reads again less what L2 keeps of them (at most ``budget``
    bytes a group), and the writes once, at 3.35 TB/s.  Its 14-byte-an-
    element roofline (one pass) stays the kernels line's bound."""
    from apex_tpu_torch.ops import multi_tensor as mt

    sizes = [t.numel() for t in lists[0]]
    read = [sum(lst[t].element_size() for lst in lists[:4]) * sizes[t]
            for t in range(len(sizes))]
    write = [sum(lst[t].element_size() for lst in writes) * sizes[t]
             for t in range(len(sizes))]
    plan = mt.lamb_list_plan(lists, budget)[0]
    total = 0
    for t0, t1 in plan.groups:
        r = sum(read[t0:t1])
        total += 2 * r + sum(write[t0:t1]) - min(r, budget)
    return total / HBM_BYTES_PER_S * 1e3


def _mt_adam_tols(g, p, m, v, ref, case, inv, bc1, bc2):
    """Per-element tolerances of mt_adam against its plain version, from
    what each side rounds: nvcc contracts multiply-adds, so each fp32
    moment sits within a few roundings of its terms (the decayed moment's
    one, the gradient term's three with the gradient's own scale and L2
    roundings, squared into v) on each side;
    the update carries the moments' errors (v's halved by the root) plus
    a few roundings of its own; p within lr times that plus 2^-21 of
    itself; every value stored in 16 bits may land on the other side of a
    rounding boundary (one ulp of its dtype)."""
    import torch

    h = MT_ADAM_HYPER
    b1, b2, lr, eps, wd = h["beta1"], h["beta2"], h["lr"], h["eps"], case["wd"]
    mode = case["mode"]
    ga = g.float().abs() * inv + wd * p.float().abs()
    m32, v32 = m.float(), v.float()
    # each side: b1 m, (1 - b1) g and their sum one rounding each, g's own
    # two (the scale, the L2 decay) carried in, and into v squared; twice
    tol_m = 2.0 ** -22 * b1 * m32.abs() + 2.0 ** -21 * (1 - b1) * ga + 1e-30
    tol_v = 2.0 ** -22 * b2 * v32 + 2.0 ** -20 * (1 - b2) * ga * ga + 1e-30
    rm, rv = ref["m"].float(), ref["v"].float()
    if mode == "pytorch":
        denom = (torch.sqrt(rv) / math.sqrt(bc2) + eps) * bc1
    else:
        denom = (torch.sqrt(rv / bc2) + eps) * bc1
    u = rm / denom
    tol_u = (tol_m / denom + 0.5 * u.abs() * tol_v / (rv + 1e-30)
             + 2.0 ** -21 * (u.abs() + wd * p.float().abs()))
    rp = ref["p"].float()
    tol_p = lr * tol_u + 2.0 ** -21 * (rp.abs() + lr * u.abs()) + 1e-30
    tols = {"m": tol_m, "v": tol_v}
    for k in ("m", "v"):
        if ref[k].dtype != torch.float32:
            tols[k] = tols[k] + _ulp(ref[k], str(ref[k].dtype)[6:])
    tols["p"] = tol_p + (_ulp(rp, str(ref["p"].dtype)[6:])
                         if ref["p"].dtype != torch.float32 else 0.0)
    if "copy" in ref:
        tols["copy"] = tol_p + (_ulp(ref["copy"], str(ref["copy"].dtype)[6:])
                                if ref["copy"].dtype != torch.float32 else 0.0)
    if "swa" in ref:
        w = case["swa_weight"]
        tols["swa"] = (tol_p if case["n_averaged"] == 0 else
                       w * tol_p + 2.0 ** -22 * (ref["swa"].abs() + rp.abs()))
    return tols


def _mt_lamb_tols(g, p, m, v, ref, case, inv, clip, bc1, bc2, norm_rel):
    """Per-element tolerances of mt_lamb against its plain version: the
    scaled and clipped gradient within three fp32 roundings (the kernel
    multiplies by a reciprocal of clip where the plain version divides:
    inside the moments' gradient terms below); the moments and the update
    (its products by 1/bc1 and 1/bc2 each three roundings from a quotient)
    a few roundings apart as in ``_mt_adam_tols``
    (plus one ulp of a 16-bit moment); the trust ratio carries both norms'
    summation order (``norm_rel``, from ``_mt_lamb_norm_rels``; None: the
    tensor takes ratio 1) and the update's error summed over the tensor; p
    within lr ratio times the update's error plus 2^-22 of its terms, plus
    one ulp where it is stored in 16 bits."""
    import torch

    h = MT_LAMB_HYPER
    b1, b2, b3, lr, eps = (h[k] for k in ("beta1", "beta2", "beta3", "lr",
                                          "eps"))
    wd = case["wd"]
    g32 = g.float() * inv / clip
    p32 = p.float()
    ga = g32.abs() + (0.0 if case["adam_w"] else wd * p32.abs())
    tol_m = 2.0 ** -22 * b1 * m.float().abs() + 2.0 ** -21 * b3 * ga + 1e-30
    tol_v = (2.0 ** -22 * b2 * v.float() + 2.0 ** -20 * (1 - b2) * ga * ga
             + 1e-30)
    rm, rv = ref["m"].float(), ref["v"].float()
    d = torch.sqrt(rv / bc2) + eps
    u = (rm / bc1) / d + (wd * p32 if case["adam_w"] else 0.0)
    tol_u = (tol_m / bc1 / d + 0.5 * (rm / bc1 / d).abs() * tol_v / (rv + 1e-30)
             + 2.0 ** -22 * (u.abs() + wd * p32.abs()))
    ratio, rel = 1.0, 0.0
    if case["use_ratio"] and norm_rel is not None:
        pn, un = float(torch.linalg.vector_norm(p32)), float(
            torch.linalg.vector_norm(u))
        if pn > 0 and un > 0:
            ratio = pn / un
            rel = (norm_rel + float(torch.linalg.vector_norm(tol_u)) / un
                   + 2.0 ** -22)
    rp = ref["p"].float()
    tol_p = (lr * ratio * (tol_u + u.abs() * rel)
             + 2.0 ** -22 * (rp.abs() + lr * ratio * u.abs()) + 1e-30)
    tols = {"m": tol_m, "v": tol_v}
    for k in ("m", "v"):
        if ref[k].dtype != torch.float32:
            tols[k] = tols[k] + _ulp(ref[k], str(ref[k].dtype)[6:])
    half = lambda t: _ulp(t, str(t.dtype)[6:]) if t.dtype != torch.float32 else 0.0
    tols["p"] = tol_p + half(ref["p"])
    if "copy" in ref:
        tols["copy"] = tol_p + half(ref["copy"])
    return tols


def _mt_ratio(got: dict, ref: dict, tols: list) -> float:
    """The worst |got - ref| / tol over every list and tensor."""
    worst = 0.0
    for key in ref[0]:
        for gt, rt, tt in zip(got, ref, tols):
            worst = max(worst, _tol_ratio(gt[key], rt[key], tt[key]))
    return worst


def _mt_state(sizes, dt, gen, device, off=0):
    """g, p, m, v lists of one case: g ~ 0.5 x 64 (a loss-scaled gradient),
    p ~ 1, m ~ 0.01, v ~ |1e-3| (v > 0)."""
    g = _mt_tensors(sizes, dt["g"], gen, device, 32.0, off=off)
    p = _mt_tensors(sizes, dt["p"], gen, device, 1.0, off=off)
    m = _mt_tensors(sizes, dt["mv"], gen, device, 0.01, off=off)
    v = _mt_tensors(sizes, dt["mv"], gen, device, 1e-3, positive=True, off=off)
    return g, p, m, v


def _mt_run_adam(fn, g, p, m, v, scalars, copy_dtype=None, swa=None):
    """The kernel or plain version on copies of the case's tensors;
    returns one dict a tensor of the outputs."""
    import torch

    tp, tm, tv = ([t.clone() for t in lst] for lst in (p, m, v))
    copy = (None if copy_dtype is None else
            [t.to(copy_dtype) for t in p])
    ts = None if swa is None else [t.clone() for t in swa]
    fn(g, tp, tm, tv, copy, ts, **scalars)
    torch.cuda.synchronize()
    out = [dict(p=a, m=b, v=c) for a, b, c in zip(tp, tm, tv)]
    for i, o in enumerate(out):
        if copy is not None:
            o["copy"] = copy[i]
        if ts is not None:
            o["swa"] = ts[i]
    return out


def check_multi_tensor(device) -> dict:
    """The four multi-tensor kernels on the card against their plain
    versions (``ops/multi_tensor.py``), over tensor counts 1, 3, 6 and 200
    (400 chunks: past one table of Apex's), sizes 1, 7, one chunk, one
    chunk + 1 and sizes not multiples of 8, one unaligned list (the
    one-element path); g in fp32/bf16/fp16, p in fp32/bf16/fp16, m and v
    in fp32/bf16; both Adam modes with and without weight decay, the three
    SWA modes with ``n_averaged`` 0 and 2, LAMB with and without NVLAMB,
    weight decay and the clip, with a master copy-back; ``noop`` 1 keeps
    every bit; an inf in one tensor sets the scale and norm flags; the
    same bits on a repeated ``mt_l2norm`` and ``mt_lamb``.  Tolerances per
    element from what each side rounds (``_mt_adam_tols``,
    ``_mt_lamb_tols``, ``_mt_norm_rel``); ``mt_scale`` bit for bit."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=device).manual_seed(71)
    dts = ("float32", "bfloat16", "float16")
    out = {}
    with torch.no_grad():
        # -- mt_l2norm -------------------------------------------------------
        worst, cases = 0.0, 0
        for count, sizes in MT_SIZE_LISTS.items():
            for dt in dts:
                for inv in (None, 2.0 ** -6):
                    for off in ((0, 1) if count == "six" else (0,)):
                        xs = _mt_tensors(sizes, dt, gen, device, 8.0, off=off)
                        inv_t = mt.device_scalar(inv, device)
                        got = mt._kernel_l2norm(xs, inv_t)
                        again = mt._kernel_l2norm(xs, inv_t)
                        ref = mt._plain_l2norm(xs, inv_t)
                        torch.cuda.synchronize()
                        if not (torch.equal(got.total, again.total) and
                                torch.equal(got.per_tensor, again.per_tensor)):
                            raise AssertionError(f"mt_l2norm: not the same bits "
                                                 f"twice ({count}, {dt})")
                        chunk = _mt_chunk(sizes)
                        rel = torch.tensor([_mt_norm_rel(n, chunk) / 2 + U32
                                            for n in sizes], device=device)
                        r = _tol_ratio(got.per_tensor, ref.per_tensor,
                                       rel * ref.per_tensor + 1e-30)
                        r = max(r, _tol_ratio(got.total, ref.total, (
                            max(_mt_norm_rel(n, chunk) for n in sizes)
                            + U32 * (len(sizes) + 32)) / 2 * ref.total + 1e-30))
                        if r > 1.0 or int(got.flag) or int(ref.flag):
                            raise AssertionError(f"mt_l2norm ({count}, {dt}, "
                                                 f"inv {inv}, off {off}): {r:.3f}"
                                                 f" x tol, flags {int(got.flag)}"
                                                 f" / {int(ref.flag)}")
                        worst, cases = max(worst, r), cases + 1
        xs = _mt_tensors(MT_SIZE_LISTS["six"], "bfloat16", gen, device)
        xs[4][100] = float("inf")
        if int(mt._kernel_l2norm(xs, None).flag) != 1:
            raise AssertionError("mt_l2norm: an inf did not set the flag")
        out["mt_l2norm"] = dict(cases=cases + 1, worst_tol_ratio=worst,
                                tolerance="each norm within (its sum's rounding "
                                "levels x 2^-24) / 2 + 2^-24 relative; the same "
                                "bits on a second call; the flag on an inf")
        log("phase2-check", kernel="mt_l2norm", **out["mt_l2norm"])

        # -- mt_scale --------------------------------------------------------
        cases = 0
        for count, sizes in MT_SIZE_LISTS.items():
            for din, dout in (("float32", "float32"), ("bfloat16", "bfloat16"),
                              ("float16", "float32"), ("float32", "bfloat16"),
                              ("float16", "float16")):
                for s in (0.3, torch.tensor(2.0 ** -10, device=device)):
                    xs = _mt_tensors(sizes, din, gen, device, 4.0)
                    if cases % 3 == 0:
                        xs[len(xs) // 2].view(-1)[0] = float("inf")
                    want = [torch.empty_like(x, dtype=getattr(torch, dout))
                            for x in xs]
                    got = [torch.empty_like(w) for w in want]
                    flag = mt._kernel_scale(xs, got, s, True)
                    ref_flag = mt._plain_scale(xs, want, s, True)
                    only = mt._kernel_scale(xs, None, 1.0, True)
                    inplace = [x.clone() for x in xs]
                    mt._kernel_scale(inplace, inplace, s, False)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    if din == dout:
                        same = same and all(torch.equal(a, b)
                                            for a, b in zip(inplace, want))
                    if not same or bool(flag) != bool(ref_flag) or \
                            bool(only) != bool(ref_flag):
                        raise AssertionError(f"mt_scale ({count}, {din} -> "
                                             f"{dout}, {s}): outputs equal "
                                             f"{same}, flags {bool(flag)} / "
                                             f"{bool(only)} / {bool(ref_flag)}")
                    cases += 1
        out["mt_scale"] = dict(cases=cases, worst_tol_ratio=0.0,
                               tolerance="bit for bit (one fp32 product, "
                               "rounded to the output's dtype, on both sides); "
                               "the flag as the plain version's, with and "
                               "without an output, on an inf in one tensor")
        log("phase2-check", kernel="mt_scale", **out["mt_scale"])

        # -- mt_adam ---------------------------------------------------------
        worst, cases = 0.0, 0
        inv_v, bc1_v, bc2_v = 1.0 / 64, 0.19, 0.002
        scal = lambda **kw: dict(
            lr=MT_ADAM_HYPER["lr"], beta1=MT_ADAM_HYPER["beta1"],
            beta2=MT_ADAM_HYPER["beta2"], eps=MT_ADAM_HYPER["eps"],
            inv_scale=torch.tensor(inv_v, device=device),
            bc1=torch.tensor(bc1_v, device=device),
            bc2=torch.tensor(bc2_v, device=device), noop=None, step=None,
            n_averaged=None, swa_weight=0.0, swa_start_step=0, **kw)
        adam_cases = [dict(mode=mode, wd=wd, g=gd, p=pd, mv=sd, count="six",
                           off=0, copy=None)
                      for mode in ("l2", "adamw") for wd in (0.0, 0.01)
                      for gd in dts for pd in dts
                      for sd in ("float32", "bfloat16")]
        adam_cases += [dict(mode="adamw", wd=0.01, g="float16", p="float32",
                            mv="float32", count=c, off=0, copy="float16")
                       for c in ("one", "three", "many")]
        adam_cases += [dict(mode="l2", wd=0.01, g="bfloat16", p="float32",
                            mv="bfloat16", count="six", off=1,
                            copy="bfloat16")]
        for case in adam_cases:
            sizes = MT_SIZE_LISTS[case["count"]]
            g, p, m, v = _mt_state(sizes, case, gen, device, case["off"])
            kw = scal(mode=mt.ADAMW if case["mode"] == "adamw" else mt.ADAM_L2,
                      weight_decay=case["wd"])
            copy_dt = case["copy"] and getattr(torch, case["copy"])
            got = _mt_run_adam(mt._kernel_adam, g, p, m, v, kw, copy_dt)
            ref = _mt_run_adam(mt._plain_adam, g, p, m, v, kw, copy_dt)
            tols = [_mt_adam_tols(*x, r, case, inv_v, bc1_v, bc2_v)
                    for x, r in zip(zip(g, p, m, v), ref)]
            r = _mt_ratio(got, ref, tols)
            if r > 1.0:
                raise AssertionError(f"mt_adam disagrees with its plain "
                                     f"version: {case}: {r:.3f} x tol")
            worst, cases = max(worst, r), cases + 1
        for mode, mt_mode in (("apex", mt.SWA_APEX_ADAM),
                              ("apexw", mt.SWA_APEX_ADAMW),
                              ("pytorch", mt.SWA_PYTORCH_ADAM)):
            for n_avg in (0, 2):
                for gd, cd in (("bfloat16", "bfloat16"), ("float32", "float16")):
                    case = dict(mode=mode, wd=0.01, g=gd, p="float32",
                                mv="float32", n_averaged=n_avg, swa_weight=0.2)
                    sizes = MT_SIZE_LISTS["six"]
                    g, p, m, v = _mt_state(sizes, case, gen, device)
                    swa = _mt_tensors(sizes, "float32", gen, device)
                    kw = scal(mode=mt_mode, weight_decay=0.01)
                    kw.update(step=torch.tensor(3, dtype=torch.int32,
                                                device=device),
                              n_averaged=torch.tensor(n_avg, dtype=torch.int32,
                                                      device=device),
                              swa_weight=0.2, swa_start_step=1)
                    got = _mt_run_adam(mt._kernel_adam, g, p, m, v, kw,
                                       getattr(torch, cd), swa)
                    ref = _mt_run_adam(mt._plain_adam, g, p, m, v, kw,
                                       getattr(torch, cd), swa)
                    tols = [_mt_adam_tols(*x, r, case, inv_v, bc1_v, bc2_v)
                            for x, r in zip(zip(g, p, m, v), ref)]
                    r = _mt_ratio(got, ref, tols)
                    if r > 1.0:
                        raise AssertionError(f"mt_adam (SWA) disagrees with "
                                             f"its plain version: {case}: "
                                             f"{r:.3f} x tol")
                    worst, cases = max(worst, r), cases + 1
        # every mode at OpenFold's list, which the table cuts into chunks
        # smaller than 64 K (its 48 tensors give fewer chunks than blocks)
        sizes = [math.prod(s) for s, _ in mt_param_lists()["openfold"]]
        if _mt_chunk(sizes) >= MT_CHUNK:
            raise AssertionError("OpenFold's list kept 64 K chunks")
        for mode, mt_mode in (("l2", mt.ADAM_L2), ("adamw", mt.ADAMW),
                              ("apex", mt.SWA_APEX_ADAM),
                              ("apexw", mt.SWA_APEX_ADAMW),
                              ("pytorch", mt.SWA_PYTORCH_ADAM)):
            swa_mode = mt_mode >= mt.SWA_APEX_ADAM
            case = dict(mode=mode, wd=0.01, g="bfloat16", p="float32",
                        mv="float32", n_averaged=2, swa_weight=0.2)
            g, p, m, v = _mt_state(sizes, case, gen, device)
            swa = _mt_tensors(sizes, "float32", gen, device) if swa_mode else None
            kw = scal(mode=mt_mode, weight_decay=0.01)
            if swa_mode:
                kw.update(step=torch.tensor(3, dtype=torch.int32, device=device),
                          n_averaged=torch.tensor(2, dtype=torch.int32,
                                                  device=device),
                          swa_weight=0.2, swa_start_step=1)
            got = _mt_run_adam(mt._kernel_adam, g, p, m, v, kw, torch.bfloat16,
                               swa)
            ref = _mt_run_adam(mt._plain_adam, g, p, m, v, kw, torch.bfloat16,
                               swa)
            tols = [_mt_adam_tols(*x, r, case, inv_v, bc1_v, bc2_v)
                    for x, r in zip(zip(g, p, m, v), ref)]
            r = _mt_ratio(got, ref, tols)
            if r > 1.0:
                raise AssertionError(f"mt_adam at OpenFold's list disagrees "
                                     f"with its plain version: {case}: "
                                     f"{r:.3f} x tol")
            worst, cases = max(worst, r), cases + 1
        # noop 1: no bit moves
        case = dict(mode="adamw", wd=0.01, g="float16", p="float32",
                    mv="bfloat16")
        g, p, m, v = _mt_state(MT_SIZE_LISTS["six"], case, gen, device)
        kw = scal(mode=mt.ADAMW, weight_decay=0.01)
        kw["noop"] = torch.tensor(True, device=device)
        got = _mt_run_adam(mt._kernel_adam, g, p, m, v, kw, torch.float16)
        if not all(torch.equal(o["p"], a) and torch.equal(o["m"], b) and
                   torch.equal(o["v"], c) and torch.equal(o["copy"],
                                                          a.to(torch.float16))
                   for o, a, b, c in zip(got, p, m, v)):
            raise AssertionError("mt_adam with noop 1 changed a buffer")
        out["mt_adam"] = dict(
            cases=cases + 1, worst_tol_ratio=worst,
            tolerance="contracted multiply-adds: each fp32 moment within "
                      "2^-22 of its decayed term plus 2^-21 (m) or 2^-20 (v) "
                      "of its gradient term; the update within "
                      "those carried through (v's halved by the root) plus "
                      "2^-21 of itself; p within lr times that plus 2^-21 "
                      "|p|; the SWA average within its weight times p's; "
                      "one ulp more for every value stored in 16 bits; noop "
                      "1: every buffer's bits unchanged")
        log("phase2-check", kernel="mt_adam", **out["mt_adam"])

        # -- mt_lamb ---------------------------------------------------------
        worst, cases = 0.0, 0
        lamb_dts = (("bfloat16", "bfloat16", "bfloat16", None),
                    ("float32", "float32", "float32", None),
                    ("float16", "float32", "float32", "float16"),
                    ("bfloat16", "float32", "bfloat16", "bfloat16"))
        lamb_cases = [dict(wd=wd, use_ratio=bool(wd or nv), nvlamb=nv,
                           clip=clip, adam_w=aw, g=gd, p=pd, mv=sd, copy=cd,
                           count="six")
                      for wd, nv in ((0.01, False), (0.0, True), (0.0, False))
                      for clip in (1.0, 1.7) for aw in (True, False)
                      for gd, pd, sd, cd in lamb_dts]
        lamb_cases += [dict(wd=0.01, use_ratio=True, nvlamb=False, clip=1.7,
                            adam_w=True, g="bfloat16", p="float32",
                            mv="float32", copy="bfloat16", count=c)
                       for c in ("one", "three", "many")]
        # the grouped walk: a tensor past the budget among many small ones;
        # the 200-tensor list under a 256 KB budget (groups of a few
        # tensors straddled by the blocks' spans); fp32 moments with
        # n_ratio < T (the tensors past it take ratio 1)
        lamb_cases += [dict(wd=0.01, use_ratio=True, nvlamb=False, clip=1.7,
                            adam_w=True, g="bfloat16", p="bfloat16",
                            mv="bfloat16", copy=None, count="big"),
                       dict(wd=0.01, use_ratio=True, nvlamb=False, clip=1.7,
                            adam_w=False, g="bfloat16", p="float32",
                            mv="bfloat16", copy="bfloat16", count="many",
                            budget=1 << 18),
                       dict(wd=0.01, use_ratio=True, nvlamb=False, clip=1.7,
                            adam_w=True, g="float16", p="float32",
                            mv="float32", copy="float16", count="many",
                            n_ratio=150),
                       dict(wd=0.0, use_ratio=True, nvlamb=True, clip=1.0,
                            adam_w=True, g="bfloat16", p="bfloat16",
                            mv="float32", copy=None, count="big",
                            n_ratio=30)]
        budget0 = mt.LAMB_BUDGET
        for i, case in enumerate(lamb_cases):
            sizes = (MT_LAMB_BIG if case["count"] == "big" else
                     MT_SIZE_LISTS[case["count"]])
            mt.LAMB_BUDGET = case.get("budget", budget0)
            g, p, m, v = _mt_state(sizes, case, gen, device)
            h = MT_LAMB_HYPER
            kw = dict(lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
                      beta3=h["beta3"], eps=h["eps"], weight_decay=case["wd"],
                      adam_w_mode=case["adam_w"], use_ratio=case["use_ratio"],
                      inv_scale=torch.tensor(inv_v, device=device),
                      clip=(None if case["clip"] == 1.0 else
                            torch.tensor(case["clip"], device=device)),
                      bc1=torch.tensor(bc1_v, device=device),
                      bc2=torch.tensor(bc2_v, device=device), noop=None,
                      n_ratio=case.get("n_ratio"))
            if i % 4 == 0:
                # a learning rate on the device (FusedMixedPrecisionLamb)
                kw["lr"] = torch.tensor(h["lr"], device=device)
            runs = []
            for fn in (mt._kernel_lamb, mt._kernel_lamb, mt._plain_lamb):
                tp, tm, tv = ([t.clone() for t in lst] for lst in (p, m, v))
                copy = (None if case["copy"] is None else
                        [t.to(getattr(torch, case["copy"])) for t in p])
                fn(g, tp, tm, tv, copy, **kw)
                torch.cuda.synchronize()
                runs.append([dict(p=a, m=b, v=c, **({} if copy is None else
                                                    {"copy": copy[j]}))
                             for j, (a, b, c) in enumerate(zip(tp, tm, tv))])
            got, again, ref = runs
            if not all(torch.equal(a[k], b[k]) for a, b in zip(got, again)
                       for k in a):
                raise AssertionError(f"mt_lamb: not the same bits twice: "
                                     f"{case}")
            rels = _mt_lamb_norm_rels([g, p, m, v], case.get("n_ratio"))
            tols = [_mt_lamb_tols(*x, r, case, inv_v, case["clip"], bc1_v,
                                  bc2_v, rel)
                    for x, r, rel in zip(zip(g, p, m, v), ref, rels)]
            mt.LAMB_BUDGET = budget0
            r = _mt_ratio(got, ref, tols)
            if r > 1.0:
                raise AssertionError(f"mt_lamb disagrees with its plain "
                                     f"version: {case}: {r:.3f} x tol")
            worst, cases = max(worst, r), cases + 1
        # one call captured in a CUDA graph: replayed, the eager call's bits
        case = lamb_cases[-3]
        g, p, m, v = _mt_state(MT_SIZE_LISTS["many"], case, gen, device)
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                  weight_decay=0.01, adam_w_mode=True, use_ratio=True,
                  inv_scale=torch.tensor(inv_v, device=device),
                  clip=torch.tensor(1.7, device=device),
                  bc1=torch.tensor(bc1_v, device=device),
                  bc2=torch.tensor(bc2_v, device=device), noop=None)
        eager = [[t.clone() for t in lst] for lst in (p, m, v)]
        mt._kernel_lamb(g, *eager, None, **kw)
        state = [[t.clone() for t in lst] for lst in (p, m, v)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mt._kernel_lamb(g, *state, None, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            mt._kernel_lamb(g, *state, None, **kw)
        for dst, src in zip((x for lst in state for x in lst),
                            (x for lst in (p, m, v) for x in lst)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        del graph
        if not all(torch.equal(a, b) for la, lb in zip(state, eager)
                   for a, b in zip(la, lb)):
            raise AssertionError("mt_lamb replayed from a CUDA graph: not "
                                 "the eager call's bits")
        # noop 1, and the apply form (the packed LAMB's phase 2)
        case = lamb_cases[-1]
        g, p, m, v = _mt_state(MT_SIZE_LISTS["six"], case, gen, device)
        tp, tm, tv = ([t.clone() for t in lst] for lst in (p, m, v))
        copy = [t.bfloat16() for t in p]
        mt._kernel_lamb(g, tp, tm, tv, copy, lr=1e-3, beta1=0.9, beta2=0.999,
                        beta3=0.1, eps=1e-6, weight_decay=0.01,
                        adam_w_mode=True, use_ratio=True, inv_scale=None,
                        clip=None, bc1=None, bc2=None,
                        noop=torch.tensor(True, device=device))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip(tp + tm + tv + copy, p + m + v + [t.bfloat16() for t in p])):
            raise AssertionError("mt_lamb with noop 1 changed a buffer")
        ps = _mt_tensors(MT_SIZE_LISTS["six"], "float32", gen, device)
        us = _mt_tensors(MT_SIZE_LISTS["six"], "float32", gen, device, 0.01)
        n_ratio = len(ps) - 1
        norms = mt._kernel_l2norm(ps[:n_ratio] + us[:n_ratio], None).per_tensor
        got, ref = [t.clone() for t in ps], [t.clone() for t in ps]
        mt._kernel_lamb_apply(got, us, 1e-3, norms, n_ratio)
        mt._plain_lamb_apply(ref, us, 1e-3, norms, n_ratio)
        torch.cuda.synchronize()
        # the same ratio on both sides (one division of the same norms), so
        # p - step u differs only by the product's rounding (fused or not)
        steps = [1e-3 * (float(norms[i] / norms[n_ratio + i])
                         if i < n_ratio else 1.0) for i in range(len(ps))]
        apply_r = max(_tol_ratio(a, b, 2.0 ** -22 * (b.abs() + st * u.abs())
                                 + 1e-30)
                      for a, b, u, st in zip(got, ref, us, steps))
        if apply_r > 1.0:
            raise AssertionError(f"mt_lamb's apply form: {apply_r:.3f} x tol")
        out["mt_lamb"] = dict(
            cases=cases + 3, worst_tol_ratio=max(worst, apply_r),
            tolerance="the clipped gradient within 3 fp32 roundings (a "
                      "reciprocal of clip, multiplied); each fp32 moment "
                      "within 2^-22 of its decayed term plus 2^-21 (m) or "
                      "2^-20 (v) of its gradient term; the update "
                      "within those carried through plus 2^-22 of its terms; "
                      "the trust ratio within both norms' summation order "
                      "(_mt_lamb_norm_rels) and the update's summed error; p "
                      "within "
                      "lr ratio times the update's error plus 2^-22 of its "
                      "terms; one ulp more for every value stored in 16 bits; "
                      "the same bits on a second call and on a CUDA graph's "
                      "replay; noop 1: every buffer's bits unchanged",
            budget=mt.LAMB_BUDGET)
        log("phase2-check", kernel="mt_lamb", **out["mt_lamb"])
    return out


def mt_param_lists() -> dict:
    """The parameter lists the multi-tensor kernels walk on the main paths,
    ``name -> [(shape, dtype)]`` in the model's order: Llama-1B under O2
    (matrices bf16, RMSNorm scales fp32; 201 tensors), GPT-2-large under O2
    (matrices bf16, biases and LayerNorms fp32; 436 tensors) and the four
    OpenFold blocks (bf16; 48 tensors)."""
    from apex_tpu_torch.examples.gpt_pretrain import LARGE
    from apex_tpu_torch.models import LlamaConfig

    bf, f32 = "bfloat16", "float32"
    c = LlamaConfig.llama_1b()
    h, ffn = c.hidden_size, c.intermediate_size
    kv = c.num_key_value_heads * (h // c.num_attention_heads)
    llama = [((c.vocab_size, h), bf)]
    for _ in range(c.num_hidden_layers):
        llama += [((h,), f32), ((h, h), bf), ((kv, h), bf), ((kv, h), bf),
                  ((h, h), bf), ((h,), f32), ((ffn, h), bf), ((ffn, h), bf),
                  ((h, ffn), bf)]
    llama += [((h,), f32), ((c.vocab_size, h), bf)]
    h = LARGE["hidden"]
    gpt = [((LARGE["vocab"], h), bf), ((LARGE["seq"], h), bf)]
    for _ in range(LARGE["layers"]):
        gpt += [((h,), f32), ((h,), f32), ((3 * h, h), bf), ((3 * h,), f32),
                ((h, h), bf), ((h,), f32), ((h,), f32), ((h,), f32),
                ((4 * h, h), bf), ((4 * h,), f32), ((h, 4 * h), bf),
                ((h,), f32)]
    gpt += [((h,), f32), ((h,), f32)]
    o = OPENFOLD
    hd = o["heads"] * o["c_hidden"]
    block = [((o["c_m"],), bf), ((o["c_m"],), bf), ((o["c_z"],), bf),
             ((o["c_z"],), bf), ((o["heads"], o["c_z"]), bf),
             ((hd, o["c_m"]), bf), ((hd, o["c_m"]), bf), ((hd, o["c_m"]), bf),
             ((hd, o["c_m"]), bf), ((hd,), bf), ((o["c_m"], hd), bf),
             ((o["c_m"],), bf)]
    return dict(llama_1b=llama, gpt2_large=gpt,
                openfold=block * o["blocks"])


def mt_table_bytes() -> int:
    """Device bytes the multi-tensor tables hold (the cache of the last 64
    tables and those kept for captured CUDA graphs): counted in a path's
    peak beside its own tensors."""
    from apex_tpu_torch.ops import multi_tensor as mt

    tables = {id(t.words): t.words for t in
              list(mt._TABLES.values()) + mt._CAPTURED}
    return sum(w.numel() * w.element_size() for w in tables.values())


def _graph_ms(fn, replays: int = 3) -> float:
    """Device ms of one call of ``fn`` captured in a CUDA graph (its
    launches replayed without the host), between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / replays


def _mt_list_tensors(spec, gen, device, scale=1.0, positive=False, dtype=None):
    import torch

    out = []
    for shape, dt in spec:
        t = torch.randn(shape, generator=gen, device=device) * scale
        out.append((t.abs_() if positive else t).to(
            getattr(torch, dtype or dt)))
    return out


def _mt_bytes(*lists, writes=()) -> int:
    """Bytes a pass must move: every tensor of ``lists`` read once, every
    one of ``writes`` written once."""
    return sum(t.numel() * t.element_size() for lst in (*lists, *writes)
               for t in lst)


def _mt_time(kernel, plain, library, nbytes, graph_plain=True) -> dict:
    """The kernel (a CUDA graph of 20 calls, or 10 eager calls between CUDA
    events where a call moves more than 1 GB), the plain version (3 eager
    calls), the plain version captured in one CUDA graph, and the library
    call, beside the bytes bound."""
    big = nbytes > 1e9
    k = (lambda: time_ms(kernel, iters=10, warmup=2)) if big else \
        (lambda: device_ms(kernel, iters=20))
    dev = dict(kernel=k(), plain=time_ms(plain, iters=3, warmup=1))
    dev["graph_plain"] = _graph_ms(plain) if graph_plain else None
    dev["library"] = (time_ms(library, iters=10, warmup=2) if big else
                      device_ms(library, iters=20)) if library else None
    dev["kernel_again"] = k()
    row = _row(dev, _host_side_ms(kernel, calls=10), 0.0, nbytes,
               FP32_OPS_PER_S, timing=(
                   "ms/library_ms: " + ("10 eager calls between CUDA events "
                                        "(each moves GBs)" if big else
                                        "20 calls in one CUDA graph") +
                   "; plain_ms: 3 eager calls (its launches issued one by "
                   "one: the host's rate); graph_plain_ms: one plain call "
                   "captured in a CUDA graph, 3 replays"))
    row.update(graph_plain_ms=dev["graph_plain"], bytes=nbytes)
    return row


def _mt_sub(tensors, limit: int = 200_000_000) -> int:
    """How many of ``tensors``, from the first, a check holds against the
    plain version: whole tensors up to ``limit`` elements, at least one."""
    total, k = 0, 0
    for t in tensors:
        if total + t.numel() > limit and k:
            break
        total, k = total + t.numel(), k + 1
    return k


def _mt_adam_kw(mode, device, **extra) -> dict:
    """mt_adam's arguments at ``MT_ADAM_HYPER``, weight decay 0.01 and the
    bias corrections of step 2 (0.19, 0.002)."""
    import torch

    h = MT_ADAM_HYPER
    return dict(mode=mode, lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
                eps=h["eps"], weight_decay=0.01,
                inv_scale=extra.pop("inv_scale", None),
                bc1=torch.tensor(0.19, device=device),
                bc2=torch.tensor(0.002, device=device),
                noop=extra.pop("noop", None),
                step=extra.pop("step", None),
                n_averaged=extra.pop("n_averaged", None),
                swa_weight=extra.pop("swa_weight", 0.0),
                swa_start_step=0)


def _mt_adam_err(g, p, m, v, copy, swa, kw, k) -> tuple:
    """Max abs error and tolerance ratio (``_mt_adam_tols``) of mt_adam
    against its plain version over the first ``k`` tensors (copies)."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    runs = []
    for fn in (mt._kernel_adam, mt._plain_adam):
        tp, tm, tv = ([t.clone() for t in lst[:k]] for lst in (p, m, v))
        tc = None if copy is None else [t.clone() for t in copy[:k]]
        ts = None if swa is None else [t.clone() for t in swa[:k]]
        fn(g[:k], tp, tm, tv, tc, ts, **kw)
        torch.cuda.synchronize()
        runs.append([dict(p=a, m=b, v=c, **({} if tc is None else
                                            {"copy": tc[j]}),
                          **({} if ts is None else {"swa": ts[j]}))
                     for j, (a, b, c) in enumerate(zip(tp, tm, tv))])
    got, ref = runs
    case = dict(mode={mt.SWA_PYTORCH_ADAM: "pytorch"}.get(kw["mode"], "x"),
                wd=kw["weight_decay"], n_averaged=1,
                swa_weight=kw["swa_weight"])
    inv = 1.0 if kw["inv_scale"] is None else float(kw["inv_scale"])
    tols = [_mt_adam_tols(*x, r, case, inv, 0.19, 0.002)
            for x, r in zip(zip(g[:k], p[:k], m[:k], v[:k]), ref)]
    err = max(float((a[key].float() - b[key].float()).abs().max())
              for a, b in zip(got, ref) for key in a)
    return err, _mt_ratio(got, ref, tols)


def _mt_lamb_kw(device) -> dict:
    """mt_lamb's arguments as the unpacked ``FusedLAMB`` of the GPT and
    BERT paths calls it (lr 1e-3, weight decay 0.01, AdamW mode, the trust
    ratio), with a clip of 1.3 and the bias corrections of step 2."""
    import torch

    return dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                weight_decay=0.01, adam_w_mode=True, use_ratio=True,
                inv_scale=None, clip=torch.tensor(1.3, device=device),
                bc1=torch.tensor(0.19, device=device),
                bc2=torch.tensor(0.002, device=device), noop=None)


def _mt_lamb_err(g, p, m, v, kw, k, copy=None) -> tuple:
    """Max abs error and tolerance ratio (``_mt_lamb_tols``) of mt_lamb
    against its plain version over the first ``k`` tensors (copies),
    with ``kw`` from ``_mt_lamb_kw``; ``copy``, where given, the model
    parameters the pass writes from fp32 masters ``p``."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    runs = []
    for fn in (mt._kernel_lamb, mt._plain_lamb):
        tp, tm, tv = ([t.clone() for t in lst[:k]] for lst in (p, m, v))
        tc = None if copy is None else [t.clone() for t in copy[:k]]
        fn(g[:k], tp, tm, tv, tc, **kw)
        torch.cuda.synchronize()
        runs.append([dict(p=a, m=b, v=c, **({} if tc is None else
                                            {"copy": tc[j]}))
                     for j, (a, b, c) in enumerate(zip(tp, tm, tv))])
    case = dict(wd=kw["weight_decay"], use_ratio=kw["use_ratio"],
                adam_w=kw["adam_w_mode"])
    rels = _mt_lamb_norm_rels([g[:k], p[:k], m[:k], v[:k]])
    tols = [_mt_lamb_tols(*x, r, case, 1.0, float(kw["clip"]),
                          float(kw["bc1"]), float(kw["bc2"]), rel)
            for x, r, rel in zip(zip(g[:k], p[:k], m[:k], v[:k]), runs[1],
                                 rels)]
    ratio = _mt_ratio(runs[0], runs[1], tols)
    err = max(float((a[key].float() - b[key].float()).abs().max())
              for a, b in zip(*runs) for key in a)
    return err, ratio


def _o2_spec(model, layers: int) -> list:
    """``[(shape, dtype)]`` of ``model`` (built with one layer, then O2
    cast) at ``layers`` layers, in its parameter order: the parameters
    under ``layers.0.`` repeated once a layer where they stand."""
    import re

    named = [(n, (tuple(p.shape), str(p.dtype).replace("torch.", "")))
             for n, p in model.named_parameters()]
    block = [i for i, (n, _) in enumerate(named)
             if re.search(r"(^|\.)layers\.0\.", n)]
    if not block or block != list(range(block[0], block[-1] + 1)):
        raise AssertionError(f"no contiguous layers.0 block: {named}")
    spec = [s for _, s in named]
    return (spec[:block[0]] + spec[block[0]:block[-1] + 1] * layers
            + spec[block[-1] + 1:])


def _param_spec(params) -> list:
    """``[(shape, dtype)]`` of ``params`` in their order."""
    return [(tuple(p.shape), str(p.dtype).replace("torch.", ""))
            for p in params]


def mt_model_lists(device) -> dict:
    """The parameter lists the optimizers of the BERT-large, GPT-1.3B,
    MoE GPT-2-medium (mt_lamb) and ViT-L/16 (mt_adam) paths walk, each
    model built at one layer of its full width and O2 cast (``_o2_spec``),
    the mLSTM's (``RNN_CARD``: embedding, RNN, head, fp32) and the DCGAN's
    two at ``DCGAN_CARD`` (fp16 O2) as their ``FusedAdam``s walk them, and
    ResNet-50's at O1-O3 (bf16) as the cross product's overflow check
    walks its gradients: ``name -> [(shape, dtype)]``."""
    import dataclasses

    import torch
    from apex_tpu_torch import RNN
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import bert_pretrain as bp
    from apex_tpu_torch.examples import dcgan_main_amp as dc
    from apex_tpu_torch.examples import imagenet_main as im
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.models import ViTConfig, ViTForImageClassification
    from apex_tpu_torch.transformer.testing import BertModel, GPTModel
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    b, g, c = bp.LARGE, gpt_pretrain.CONFIGS["1.3b"], MOE_CARD
    vit = ViTConfig.vit_l16()
    one = {
        "bert_large": (BertModel(
            num_layers=1, hidden_size=b["hidden"],
            num_attention_heads=b["heads"], vocab_size=b["vocab"],
            max_sequence_length=b["seq"], device=device), b["layers"]),
        "gpt_1p3b": (GPTModel(
            num_layers=1, hidden_size=g["hidden"],
            num_attention_heads=g["heads"], vocab_size=g["vocab"],
            max_sequence_length=g["seq"], device=device), g["layers"]),
        "gpt2_medium_moe8": (TransformerLanguageModel(
            1, c["hidden"], c["heads"], c["vocab"], c["seq"],
            moe_num_experts=c["experts"],
            moe_capacity_factor=c["capacity_factor"], device=device),
            c["layers"]),
        "vit_l16": (ViTForImageClassification(
            dataclasses.replace(vit, num_hidden_layers=1), device=device),
            vit.num_hidden_layers)}
    lists = {name: _o2_spec(o2_cast(model), layers)
             for name, (model, layers) in one.items()}
    r = RNN_CARD
    lists["mlstm_4096"] = (
        [((r["vocab"], r["embed"]), "float32")]
        + _param_spec(RNN.mLSTM(r["embed"], r["hidden"], 1,
                                device=device).parameters())
        + [((r["vocab"], r["hidden"]), "float32"), ((r["vocab"],), "float32")])
    d = DCGAN_CARD
    tr = dc.DCGANTrainer(nz=d["nz"], ngf=d["ngf"], ndf=d["ndf"],
                         opt_level="O2", half=torch.float16, device=device)
    lists["dcgan64_d"] = _param_spec(tr.d_params)
    lists["dcgan64_g"] = _param_spec(tr.g_params)
    for level in ("O1", "O2", "O3"):
        net = get_policy(level, half_dtype=torch.bfloat16).cast_params(
            im.resnet50(CONVERGENCE_CARD["num_classes"], device=device))
        lists[f"resnet50_{level.lower()}"] = _param_spec(net.parameters())
    return lists


# how each path walks its list: the kernel, the moments' dtype, whether
# fp32 masters write the model's parameters, the gradients' dtype (None:
# the parameters'), whether the step takes its overflow flag as noop, and
# whether mt_scale's overflow check walks the gradients too
MT_MODEL_USE = {
    "bert_large": ("mt_lamb", "bfloat16", False, None, False, False),
    "gpt_1p3b": ("mt_lamb", "bfloat16", False, None, False, False),
    "gpt2_medium_moe8": ("mt_lamb", "float32", True, None, False, False),
    "vit_l16": ("mt_adam", "float32", False, None, False, False),
    "mlstm_4096": ("mt_adam", "float32", False, None, False, False),
    # the scaler's unscale hands FusedAdam fp32 gradients
    "dcgan64_d": ("mt_adam", "float32", True, "float32", True, True),
    "dcgan64_g": ("mt_adam", "float32", True, "float32", True, True),
    "resnet50_o1": (None, None, False, None, False, True),
    "resnet50_o2": (None, None, False, None, False, True),
    "resnet50_o3": (None, None, False, None, False, True),
}


def _mt_overflow_check(spec, gen, device) -> int:
    """mt_scale's overflow check alone (no output, scale 1: the amp
    scaler's ``has_overflow``) against its plain version on gradients of
    ``spec``: clean, then an inf at the first element of the first
    tensor, a NaN at the last element of the largest and an inf in the
    middle of the last, one at a time; the flags must be equal.  Returns
    the cases."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    g = _mt_list_tensors(spec, gen, device, 0.01)
    big = max(range(len(g)), key=lambda i: g[i].numel())
    places = [None, (0, 0, float("inf")), (big, -1, float("nan")),
              (len(g) - 1, g[-1].numel() // 2, float("inf"))]
    for place in places:
        saved = None
        if place is not None:
            i, j, val = place
            saved = g[i].view(-1)[j].clone()
            g[i].view(-1)[j] = val
        got = bool(mt._kernel_scale(g, None, 1.0, True))
        want = bool(mt._plain_scale(g, None, 1.0, True))
        if got != want or got != (place is not None):
            raise AssertionError(f"mt_scale's overflow check on {place}: "
                                 f"kernel {got}, plain {want}")
        if place is not None:
            g[i].view(-1)[j] = saved
    del g
    return len(places)


# the lists are held against the plain version over their first tensors
# up to this many elements: BERT-large's and ViT-L/16's whole, GPT-1.3B's
# first 72 of 292 tensors (its embeddings and nearly six layers, 390 M
# elements), the MoE stack's first 56 of 268 (its embeddings, four layers
# and the fifth's up to its w_in: nine expert tensors of 33.5 M, 376 M
# elements; the whole list is 1.76 B); only
# the tensors checked are made (for GPT-1.3B's whole list, the two runs'
# copies and the fp32 tolerances would come to some 31 GB by arithmetic)
MT_MODEL_CHECK_ELEMENTS = 400_000_000


def check_multi_tensor_model_lists(device) -> dict:
    """mt_lamb on BERT-large's and GPT-1.3B's O2 lists (bf16 moments, as
    their ``FusedLAMB(state_dtype=bf16)``) and on the MoE GPT-2-medium's
    (fp32 moments and fp32 masters, the pass writing the O2 parameters, as
    its ``FusedLAMB(master_weights=True)``), mt_adam on ViT-L/16's and the
    mLSTM's (fp32 moments) and on the DCGAN's two (fp32 gradients, moments
    and masters, the pass writing the fp16 parameters, a false overflow
    flag as noop), and mt_scale's overflow check on the DCGAN's fp16 and
    ResNet-50's O1-O3 gradients, against their plain versions, each list
    from :func:`mt_model_lists` (``MT_MODEL_USE``), at ``_mt_lamb_tols`` /
    ``_mt_adam_tols`` / equal flags."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    gen = torch.Generator(device=device).manual_seed(74)
    out = {}
    with torch.no_grad():
        for name, full in mt_model_lists(device).items():
            kernel, moments, masters, grads, noop, overflow = \
                MT_MODEL_USE[name]
            elements = sum(math.prod(shape) for shape, _ in full)
            if overflow:
                row = dict(kernel="mt_scale", list=f"{name} gradients "
                           f"(overflow check)", tensors=len(full),
                           elements=elements,
                           cases=_mt_overflow_check(full, gen, device),
                           tol_ratio=0.0, tolerance="equal flags")
                out[f"{name}_overflow_check"] = row
                log("phase2-check", **row)
            if kernel is None:
                continue
            lamb = kernel == "mt_lamb"
            k = _mt_sub([torch.empty(shape, device="meta")
                         for shape, _ in full], MT_MODEL_CHECK_ELEMENTS)
            spec = full[:k]
            p = _mt_list_tensors(spec, gen, device,
                                 dtype="float32" if masters else None)
            copy = ([t.to(getattr(torch, dt)) for t, (_, dt) in zip(p, spec)]
                    if masters else None)
            g = _mt_list_tensors(spec, gen, device, 0.01, dtype=grads)
            m = _mt_list_tensors(spec, gen, device, 1e-3, dtype=moments)
            v = _mt_list_tensors(spec, gen, device, 1e-5, positive=True,
                                 dtype=moments)
            err, ratio = (_mt_lamb_err(g, p, m, v, _mt_lamb_kw(device), k,
                                       copy=copy)
                          if lamb else
                          _mt_adam_err(g, p, m, v, copy, None, _mt_adam_kw(
                              mt.ADAMW, device, noop=torch.tensor(
                                  False, device=device) if noop else None),
                                       k))
            row = dict(kernel=kernel,
                       list=f"{name} ({moments} moments"
                            + (", fp32 masters" if masters else "")
                            + (", noop" if noop else "") + ")",
                       tensors=len(full), elements=elements,
                       checked_tensors=k,
                       checked_elements=sum(t.numel() for t in p),
                       max_abs_err=err, tol_ratio=ratio,
                       tolerance="_mt_lamb_tols" if lamb else "_mt_adam_tols")
            if ratio > 1.0:
                raise AssertionError(f"{kernel} at {name}'s list: "
                                     f"{ratio:.3f} x tol")
            out[name] = row
            log("phase2-check", **row)
            del p, g, m, v, copy
            torch.cuda.empty_cache()
    return out


def time_multi_tensor(device) -> dict:
    """The four multi-tensor kernels at the main paths' real parameter lists
    (``mt_param_lists``), each beside its bytes bound, its plain version,
    the plain version captured in a CUDA graph (the launches alone gone)
    and the library's list call as a yardstick the port never calls:

    - Llama-1B bf16 (O2, bf16 moments): ``mt_adam`` against
      ``torch._fused_adamw_`` (one call a dtype: bf16 matrices, fp32
      scales, moments in each one's dtype);
    - Llama-1B fp16 amp: ``mt_adam`` over fp32 masters with the fp16
      copy-back against ``torch._fused_adamw_`` over the masters and fp32
      copies of the gradients; ``mt_scale``'s check over the fp16
      gradients against ``torch._amp_foreach_non_finite_check_and_unscale_``
      (which also writes them back, times 1);
    - GPT-2-large (O2, bf16 moments): ``mt_l2norm`` over the gradients
      against ``torch._foreach_norm``; ``mt_lamb`` (both stages), no library
      call;
    - OpenFold's four blocks: ``mt_adam`` in its SWA mode (ApexAdamW)
      against ``torch._fused_adamw_`` over the fp32 masters and fp32 copies
      of the gradients (no average).

    Each kernel is also held against its plain version on a sub-list of
    its real list (the first tensors up to 200 M elements), and its max
    abs error reported."""
    import torch
    from apex_tpu_torch.ops import multi_tensor as mt

    lists = mt_param_lists()
    gen = torch.Generator(device=device).manual_seed(73)
    h = MT_ADAM_HYPER
    out = {}
    sub = _mt_sub
    adam_err = _mt_adam_err

    def adam_kw(mode, **extra):
        return _mt_adam_kw(mode, device, **extra)

    with torch.no_grad():
        # -- Llama-1B bf16: mt_adam, bf16 moments ----------------------------
        spec = lists["llama_1b"]
        p = _mt_list_tensors(spec, gen, device)
        g = _mt_list_tensors(spec, gen, device, 0.01)
        m = _mt_list_tensors(spec, gen, device, 1e-3, dtype="bfloat16")
        v = _mt_list_tensors(spec, gen, device, 1e-5, positive=True,
                             dtype="bfloat16")
        kw = adam_kw(mt.ADAMW)
        err, ratio = adam_err(g, p, m, v, None, None, kw, sub(p))
        if ratio > 1.0:
            raise AssertionError(f"mt_adam at Llama-1B's list: {ratio:.3f} x tol")
        groups = {}
        for i, t in enumerate(p):
            groups.setdefault(t.dtype, []).append(i)
        lib_m = [torch.zeros_like(t) for t in p]
        lib_v = [torch.zeros_like(t) for t in p]
        steps = [torch.tensor(2.0, device=device) for _ in p]

        def fused_lib(params, grads, ms, vs, st, idx_groups):
            for idx in idx_groups:
                torch._fused_adamw_([params[i] for i in idx],
                                    [grads[i] for i in idx],
                                    [ms[i] for i in idx], [vs[i] for i in idx],
                                    [], [st[i] for i in idx], lr=h["lr"],
                                    beta1=h["beta1"], beta2=h["beta2"],
                                    weight_decay=0.01, eps=h["eps"],
                                    amsgrad=False, maximize=False)

        nbytes = _mt_bytes(g, p, m, v, writes=(p, m, v))
        row = _mt_time(lambda: mt._kernel_adam(g, p, m, v, None, None, **kw),
                       lambda: mt._plain_adam(g, p, m, v, None, None, **kw),
                       lambda: fused_lib(p, g, lib_m, lib_v, steps,
                                         list(groups.values())), nbytes)
        row.update(list="llama-1b bf16 (O2, bf16 moments)", tensors=len(p),
                   elements=sum(t.numel() for t in p),
                   max_abs_err=err, tol_ratio=ratio,
                   checked_tensors=sub(p),
                   library_call="torch._fused_adamw_, one call a dtype "
                                "(its moments in the parameter's dtype)")
        out["adam_llama_bf16"] = row
        log("phase2-time", kernel="mt_adam", **row)
        del p, g, m, v, lib_m, lib_v, steps
        torch.cuda.empty_cache()

        # -- Llama-1B fp16 amp: masters, fp16 copy-back; mt_scale's check ----
        half = [(s, "float16" if dt == "bfloat16" else dt) for s, dt in spec]
        copy = _mt_list_tensors(half, gen, device)
        masters = [t.float() for t in copy]
        g = _mt_list_tensors(half, gen, device, 0.01 * 2 ** 15)
        m = _mt_list_tensors(spec, gen, device, 1e-3, dtype="float32")
        v = _mt_list_tensors(spec, gen, device, 1e-5, positive=True,
                             dtype="float32")
        inv = torch.tensor(2.0 ** -15, device=device)
        kw = adam_kw(mt.ADAMW, inv_scale=inv)
        err, ratio = adam_err(g, masters, m, v, copy, None, kw, sub(masters))
        if ratio > 1.0:
            raise AssertionError(f"mt_adam at the fp16 masters' list: "
                                 f"{ratio:.3f} x tol")
        g32 = [t.float() for t in g]
        lib_steps = [torch.tensor(2.0, device=device) for _ in masters]
        nbytes = _mt_bytes(g, masters, m, v, writes=(masters, m, v, copy))
        row = _mt_time(
            lambda: mt._kernel_adam(g, masters, m, v, copy, None, **kw),
            lambda: mt._plain_adam(g, masters, m, v, copy, None, **kw),
            lambda: torch._fused_adamw_(
                masters, g32, m, v, [], lib_steps, lr=h["lr"],
                beta1=h["beta1"], beta2=h["beta2"], weight_decay=0.01,
                eps=h["eps"], amsgrad=False, maximize=False, grad_scale=inv),
            nbytes)
        row.update(list="llama-1b fp16 amp (fp32 masters, fp16 copy-back)",
                   tensors=len(masters), elements=sum(t.numel() for t in masters),
                   max_abs_err=err, tol_ratio=ratio,
                   checked_tensors=sub(masters),
                   library_call="torch._fused_adamw_ over the masters and fp32 "
                                "copies of the gradients (grad_scale; no "
                                "copy-back)")
        out["adam_llama_fp16_masters"] = row
        log("phase2-time", kernel="mt_adam", **row)
        del masters, m, v, g32, lib_steps, copy
        torch.cuda.empty_cache()
        found = torch.zeros((), device=device)
        one = torch.ones((), device=device)
        flag_ref = mt._plain_scale(g, None, 1.0, True)
        flag = mt._kernel_scale(g, None, 1.0, True)
        if bool(flag) != bool(flag_ref):
            raise AssertionError("mt_scale's check at the fp16 list")
        row = _mt_time(
            lambda: mt._kernel_scale(g, None, 1.0, True),
            lambda: mt._plain_scale(g, None, 1.0, True),
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                g, found, one), _mt_bytes(g))
        row.update(list="llama-1b fp16 amp gradients (the overflow check)",
                   tensors=len(g), elements=sum(t.numel() for t in g),
                   max_abs_err=0.0, flag=bool(flag),
                   library_call="torch._amp_foreach_non_finite_check_and_"
                                "unscale_ (writes the gradients back, times 1)")
        out["scale_llama_fp16_check"] = row
        log("phase2-time", kernel="mt_scale", **row)
        del g, found, one
        torch.cuda.empty_cache()

        # -- GPT-2-large unpacked LAMB: mt_l2norm and mt_lamb ----------------
        spec = lists["gpt2_large"]
        p = _mt_list_tensors(spec, gen, device)
        g = _mt_list_tensors(spec, gen, device, 0.01)
        m = _mt_list_tensors(spec, gen, device, 1e-3, dtype="bfloat16")
        v = _mt_list_tensors(spec, gen, device, 1e-5, positive=True,
                             dtype="bfloat16")
        got, ref = mt._kernel_l2norm(g, None), mt._plain_l2norm(g, None)
        torch.cuda.synchronize()
        norm_err = float((got.per_tensor - ref.per_tensor).abs().max())
        norm_rel = float(((got.per_tensor - ref.per_tensor).abs()
                          / ref.per_tensor.clamp_min(1e-30)).max())
        chunk = _mt_chunk([t.numel() for t in g])
        if norm_rel > max(_mt_norm_rel(t.numel(), chunk) for t in g):
            raise AssertionError(f"mt_l2norm at GPT-2-large's list: relative "
                                 f"error {norm_rel}")
        row = _mt_time(lambda: mt._kernel_l2norm(g, None),
                       lambda: mt._plain_l2norm(g, None),
                       lambda: torch._foreach_norm(g), _mt_bytes(g))
        row.update(list="gpt2-large gradients (O2)", tensors=len(g),
                   elements=sum(t.numel() for t in g), max_abs_err=norm_err,
                   max_rel_err=norm_rel,
                   library_call="torch._foreach_norm (per-tensor norms; the "
                                "global norm not taken)")
        out["l2norm_gpt2_large"] = row
        log("phase2-time", kernel="mt_l2norm", **row)
        lkw = _mt_lamb_kw(device)
        k = sub(p)
        lamb_err, lamb_ratio = _mt_lamb_err(g, p, m, v, lkw, k)
        if lamb_ratio > 1.0:
            raise AssertionError(f"mt_lamb at GPT-2-large's list: "
                                 f"{lamb_ratio:.3f} x tol")
        row = _mt_time(lambda: mt._kernel_lamb(g, p, m, v, None, **lkw),
                       lambda: mt._plain_lamb(g, p, m, v, None, **lkw),
                       None, _mt_bytes(g, p, m, v, writes=(p, m, v)))
        plan, _, grid = mt.lamb_list_plan([g, p, m, v], mt.LAMB_BUDGET)
        floor = mt_lamb_floor_ms([g, p, m, v], mt.LAMB_BUDGET, (p, m, v))
        row.update(list="gpt2-large unpacked LAMB (O2, bf16 moments)",
                   tensors=len(p), elements=sum(t.numel() for t in p),
                   max_abs_err=lamb_err, tol_ratio=lamb_ratio,
                   checked_tensors=k, library_call=None,
                   library_note="none: no single PyTorch call computes LAMB",
                   budget=mt.LAMB_BUDGET, groups=len(plan.groups),
                   wide_groups=plan.wide,
                   grid=grid, teams=plan.teams, floor_ms=floor,
                   floor_note="DRAM floor under LAMB's per-tensor dependence: "
                              "stage 2 re-reads each group less the budget "
                              "L2 keeps; bound_ms is the one-pass roofline",
                   floor_share=floor / row["ms"])
        out["lamb_gpt2_large"] = row
        log("phase2-time", kernel="mt_lamb", **row)
        del p, g, m, v
        torch.cuda.empty_cache()

        # -- OpenFold: mt_adam's SWA mode ------------------------------------
        spec = lists["openfold"]
        copy = _mt_list_tensors(spec, gen, device)
        masters = [t.float() for t in copy]
        swa = [t.clone() for t in masters]
        g = _mt_list_tensors(spec, gen, device, 0.01)
        m = _mt_list_tensors(spec, gen, device, 1e-3, dtype="float32")
        v = _mt_list_tensors(spec, gen, device, 1e-5, positive=True,
                             dtype="float32")
        kw = adam_kw(mt.SWA_APEX_ADAMW,
                     step=torch.tensor(3, dtype=torch.int32, device=device),
                     n_averaged=torch.tensor(2, dtype=torch.int32,
                                             device=device),
                     swa_weight=0.1)
        err, ratio = adam_err(g, masters, m, v, copy, swa, kw, len(g))
        if ratio > 1.0:
            raise AssertionError(f"mt_adam (SWA) at OpenFold's list: "
                                 f"{ratio:.3f} x tol")
        g32 = [t.float() for t in g]
        lib_steps = [torch.tensor(2.0, device=device) for _ in masters]
        row = _mt_time(
            lambda: mt._kernel_adam(g, masters, m, v, copy, swa, **kw),
            lambda: mt._plain_adam(g, masters, m, v, copy, swa, **kw),
            lambda: torch._fused_adamw_(
                masters, g32, m, v, [], lib_steps, lr=h["lr"],
                beta1=h["beta1"], beta2=h["beta2"], weight_decay=0.01,
                eps=h["eps"], amsgrad=False, maximize=False),
            _mt_bytes(g, masters, m, v, swa, writes=(masters, m, v, swa, copy)))
        # the same call on 64 K chunks, the walker's only chunk before the
        # table chose one for the list
        min_chunk, mt.MIN_CHUNK = mt.MIN_CHUNK, mt.CHUNK
        mt._TABLES.clear()
        at_64k = device_ms(
            lambda: mt._kernel_adam(g, masters, m, v, copy, swa, **kw), iters=20)
        mt.MIN_CHUNK = min_chunk
        mt._TABLES.clear()
        chunk = _mt_chunk([t.numel() for t in g])
        row.update(list="openfold 4 blocks (FusedAdamSWA, ApexAdamW)",
                   chunk=chunk, chunks=sum(-(-t.numel() // chunk) for t in g),
                   resident_blocks=mt.resident_blocks(), ms_at_64k_chunks=at_64k,
                   tensors=len(g), elements=sum(t.numel() for t in g),
                   max_abs_err=err, tol_ratio=ratio,
                   library_call="torch._fused_adamw_ over the masters and fp32 "
                                "copies of the gradients (no average, no "
                                "copy-back)")
        out["adam_swa_openfold"] = row
        log("phase2-time", kernel="mt_adam", **row)
        del copy, masters, swa, g, m, v, g32, lib_steps
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: end to end
# ---------------------------------------------------------------------------


def serve(engine, requests, sv):
    sched = sv.ContinuousBatchingScheduler(engine)
    for r in requests:
        sched.submit(r)
    t0 = time.perf_counter()
    results = sched.run()
    import torch
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return results, time.perf_counter() - t0


class ChunkLog:
    """Logs an engine's prefill chunks, ``(slot, tokens)`` in call order,
    and the logits each returned (``logits``), while it is entered (the
    engine's own ``prefill_chunk`` runs as it is)."""

    def __init__(self, engine):
        self.engine, self.calls, self.logits = engine, [], []

    def __enter__(self):
        inner = self.engine.prefill_chunk

        def logged(slot, tokens):
            self.calls.append((slot, list(tokens)))
            self.logits.append(inner(slot, tokens))
            return self.logits[-1]

        self.engine.prefill_chunk = logged
        return self

    def __exit__(self, *exc):
        del self.engine.prefill_chunk

    def chunks_of(self, prompt) -> tuple:
        """``(slot, lengths)``: the slot that cached ``prompt`` and its
        chunks' lengths, in order.  The first chunk is found by its tokens,
        the rest are that slot's next chunks (a slot holds one request
        until it finishes)."""
        prompt, slot, out = list(prompt), None, []
        for s, tokens in self.calls:
            if slot is None and tokens == prompt[:len(tokens)]:
                slot = s
            if s == slot and sum(out) < len(prompt):
                if tokens != prompt[sum(out):sum(out) + len(tokens)]:
                    raise AssertionError(f"slot {s}: a chunk of another prompt")
                out.append(len(tokens))
        if sum(out) != len(prompt):
            raise AssertionError(f"the prompt's chunks not found: {out}")
        return slot, out


def serve_in_chunks(engine, request, slot: int, chunks, forced=None) -> tuple:
    """``request`` served alone on the engine, reset first: its prompt
    cached at ``slot`` in chunks of the given lengths, then decoded as the
    scheduler decodes (one step computes every slot's row, this one
    active) and sampled as it samples.  With ``forced`` (a token stream),
    each decode step is fed ``forced``'s token in place of its own.
    Returns ``(tokens, logits, x)``: the sampled tokens, each step's fp32
    logits ``[steps, vocab]`` and the final norm's output row that the
    logits were computed from (``[steps, hidden]``, fp32)."""
    import numpy as np
    import torch

    got = {}
    hook = engine.model.norm.register_forward_hook(
        lambda mod, args, out: got.__setitem__("x", out))
    r = request

    def sample(logits, index):
        return int(engine.sample(logits, [r.seed], [index], [r.temperature],
                                 [r.top_k])[0])
    try:
        engine.reset()
        pos = 0
        for n in chunks:
            logits = engine.prefill_chunk(slot, r.prompt[pos:pos + n])
            pos += n
        steps, xs = [logits], [got["x"][chunks[-1] - 1, 0].float()]
        tokens = [sample(logits[None], 0)]
        while len(tokens) < r.max_new_tokens and not (
                r.eos_id is not None and tokens[-1] == r.eos_id):
            ids = np.zeros((engine.slots,), np.int64)
            active = np.zeros((engine.slots,), bool)
            ids[slot] = tokens[-1] if forced is None else forced[len(tokens) - 1]
            active[slot] = True
            logits = engine.decode(ids, active)
            steps.append(logits[slot])
            xs.append(got["x"][0, slot].float())
            tokens.append(sample(logits[[slot]], len(tokens)))
    finally:
        hook.remove()
    return tokens, torch.stack(steps), torch.stack(xs)


def serving_alone_checks(engine, probe, batched, chunk_log, sv) -> dict:
    """That a request served alone repeats its batched run, in two checks.
    The scheduler spends one prefill budget a step over every admitted
    request (the JAX package's rule), so in the batched run the probe's
    prompt was cut into other chunks than alone; other chunks are other
    bucket shapes, whose products may round differently (on the card the
    first op whose bits differ is layer 0's MLP down projection, a cuBLAS
    product whose algorithm follows M).  Decode computes every slot's row
    whatever is active, so the batch does not enter it.

    1. Served alone in the batched run's chunks and slot
       (:func:`serve_in_chunks`): the batched greedy stream, bit for bit.
    2. Served alone in its own chunks, as the scheduler serves it alone, and
       fed the batched stream: each step's logits within tol_j = (2L + 1) u
       sqrt(sum_i x_i^2 E_ji^2) of the batched chunks', u = 2^-8 the bf16
       unit roundoff, x the final norm's output and E the head: each of the
       2L residual adds and the final norm rounds to bf16, and where the two
       runs round one of them differently, their x differ by up to u
       relative in each element, which moves logit j = x . E_j by about u
       sqrt(sum_i x_i^2 E_ji^2) (the differences' signs independent of E's),
       the 2L + 1 of them added at most linearly.  A top-2 swap needs the
       margin to move by more than the two logits' tolerances, so the fed
       run must pick the batched token wherever its or the batched run's
       top-2 margin exceeds them, and the stream the scheduler gives alone
       must equal the batched one up to the first step where it does not.
       The scheduler's alone run is held bit for bit too: to the stream
       :func:`serve_in_chunks` gives in the same chunks and slot, unforced.
    Returns what the log records."""
    import torch

    slot, chunks = chunk_log.chunks_of(probe.prompt)
    n, step = len(probe.prompt), engine.prefill_len
    own = [min(step, n - i) for i in range(0, n, step)]
    tokens, logits, x = serve_in_chunks(engine, probe, slot, chunks)
    if tokens != batched:
        raise AssertionError(f"{probe.rid} served alone in its batched chunks "
                             f"{chunks} gave another stream: {tokens} vs {batched}")
    engine.reset()
    with ChunkLog(engine) as alone_log:
        alone = serve(engine, [probe], sv)[0][probe.rid].tokens
    alone_slot, alone_chunks = alone_log.chunks_of(probe.prompt)
    if alone_chunks != own:
        raise AssertionError(f"{probe.rid} served alone in chunks {alone_chunks}, "
                             f"not its own {own}")
    replay = serve_in_chunks(engine, probe, alone_slot, own)[0]
    if alone != replay:
        raise AssertionError(f"{probe.rid} served alone by the scheduler and "
                             f"replayed in the same chunks and slot gave other "
                             f"streams: {alone} vs {replay}")
    fed, fed_logits, _ = serve_in_chunks(engine, probe, alone_slot, own, forced=tokens)
    tol = bf16_logit_tol(engine.model, x)
    ratio = float(((fed_logits - logits).abs() / tol).max())
    if ratio > 1:
        raise AssertionError(f"{probe.rid} served alone in its own chunks {own}: "
                             f"logits off the batched chunks' by {ratio} x tolerance")
    near_tie = [a or b for a, b in zip(near_ties(logits, tol),
                                       near_ties(fed_logits, tol))]
    swapped = [i for i, (a, b) in enumerate(zip(fed, tokens)) if a != b]
    if any(not near_tie[i] for i in swapped):
        raise AssertionError(f"{probe.rid} fed the batched stream picked other tokens "
                             f"at steps {swapped}, not all near ties: {near_tie}")
    first_tie = near_tie.index(True) if True in near_tie else len(tokens)
    parts = next((i for i, (a, b) in enumerate(zip(alone, batched)) if a != b),
                 None if len(alone) == len(batched) else min(len(alone), len(batched)))
    if parts is not None and parts < first_tie:
        raise AssertionError(f"{probe.rid} served alone parts from its batched "
                             f"stream at step {parts}, before the first near tie "
                             f"(step {first_tie}): {alone} vs {batched}")
    return dict(probe=probe.rid, batched_chunks=chunks, alone_chunks=own, slot=slot,
                alone_in_batched_chunks_identical=True,
                logits_tol_ratio=ratio, max_abs_logit_diff=float(
                    (fed_logits - logits).abs().max()),
                near_tie_steps=[i for i, tie in enumerate(near_tie) if tie],
                fed_token_swaps=swapped, alone_identical=alone == batched,
                alone_equals_its_chunks_replayed=True,
                alone_parts_at=parts,
                tolerance="tol_j = (2L + 1) 2^-8 sqrt(sum_i x_i^2 E_ji^2), x the "
                          "final norm's output, E the head; a near tie: the top-2 "
                          "margin within the two logits' tolerances")


def serving_requests(vocab: int) -> list:
    """The serving phase's 12 greedy requests: prompts of 64-1024 tokens
    drawn from a seeded generator, 32 new tokens each."""
    import torch
    from apex_tpu_torch import serving as sv

    rng = torch.Generator().manual_seed(4)
    lens = torch.randint(64, 1025, (12,), generator=rng).tolist()
    return [sv.Request(f"q{i}", torch.randint(0, vocab, (n,),
                                              generator=rng).tolist(),
                       max_new_tokens=32)
            for i, n in enumerate(lens)]


def prefix_requests(vocab: int, prefix_len: int = 1024, lo: int = 64,
                    hi: int = 512, n: int = 12, new_tokens: int = 32) -> list:
    """``n`` greedy requests that share one ``prefix_len``-token prefix (a
    system prompt), each with its own tail of ``lo``-``hi`` tokens."""
    import torch
    from apex_tpu_torch import serving as sv

    rng = torch.Generator().manual_seed(6)
    prefix = torch.randint(0, vocab, (prefix_len,), generator=rng).tolist()
    tails = torch.randint(lo, hi + 1, (n,), generator=rng).tolist()
    return [sv.Request(f"p{i}", prefix + torch.randint(
        0, vocab, (t,), generator=rng).tolist(), max_new_tokens=new_tokens)
            for i, t in enumerate(tails)]


def quoted_requests(vocab: int, lo: int = 128, hi: int = 384, n: int = 12,
                    new_tokens: int = 64) -> list:
    """``n`` greedy "quoted-context" requests: a seeded passage of
    ``lo``-``hi`` tokens, then the same passage again (the RAG and
    code-edit traffic prompt lookup drafts from), ``new_tokens`` new."""
    import torch
    from apex_tpu_torch import serving as sv

    rng = torch.Generator().manual_seed(7)
    lens = torch.randint(lo, hi + 1, (n,), generator=rng).tolist()
    out = []
    for i, length in enumerate(lens):
        passage = torch.randint(0, vocab, (length,), generator=rng).tolist()
        out.append(sv.Request(f"s{i}", passage + passage,
                              max_new_tokens=new_tokens))
    return out


class StreamLog:
    """Records, while entered, each request's next-token logits and the
    final norm's output row they came from, step by step: the first from
    the prefill chunk that completes its prompt, then one a decode step,
    or the rows of a speculative verify that gave emitted tokens (the
    accepted draft and the bonus token).  The engine's own calls run as
    they are; ``sched`` says which request a slot holds."""

    def __init__(self, engine, sched, requests):
        self.engine, self.sched = engine, sched
        self.prompt_len = {r.rid: len(r.prompt) for r in requests}
        self.logits, self.x = {}, {}

    def __enter__(self):
        import numpy as np

        eng, got = self.engine, {}
        self._hook = eng.model.norm.register_forward_hook(
            lambda mod, args, out: got.__setitem__("x", out))
        inner_chunk, inner_decode = eng.prefill_chunk, eng.decode
        inner_verify = eng.verify_draft

        def chunk(slot, tokens):
            offset = int(eng.lengths()[slot])
            logits = inner_chunk(slot, tokens)
            rid = self.sched.active_slots[slot]
            if offset + len(tokens) == self.prompt_len[rid]:
                self.logits[rid] = [logits]
                self.x[rid] = [got["x"][len(tokens) - 1, 0].float()]
            return logits

        def decode(tokens, active):
            logits = inner_decode(tokens, active)
            rids = self.sched.active_slots
            # a stream adopted mid-decode starts its log here
            for slot in np.flatnonzero(np.asarray(active, bool)).tolist():
                self.logits.setdefault(rids[slot], []).append(logits[slot])
                self.x.setdefault(rids[slot], []).append(
                    got["x"][0, slot].float())
            return logits

        def verify(slot, tokens):
            accepted, greedy, rows = inner_verify(slot, tokens)
            rid = self.sched.active_slots[slot]
            self.logits.setdefault(rid, []).extend(rows[:accepted + 1])
            self.x.setdefault(rid, []).extend(
                got["x"][:accepted + 1, 0].float())
            return accepted, greedy, rows

        # inside a ChunkLog, whose wrapper is an attribute of the engine
        self._saved = {k: eng.__dict__.get(k) for k in (
            "prefill_chunk", "decode", "verify_draft")}
        eng.prefill_chunk, eng.decode, eng.verify_draft = chunk, decode, verify
        return self

    def __exit__(self, *exc):
        self._hook.remove()
        for name, saved in self._saved.items():
            if saved is None:
                delattr(self.engine, name)
            else:
                setattr(self.engine, name, saved)

    def stacked(self, rid) -> tuple:
        """``(logits [steps, vocab], x [steps, hidden])`` of one request."""
        import torch

        return torch.stack(self.logits[rid]), torch.stack(self.x[rid])


def bf16_logit_tol(model, x):
    """tol_j = (2L + 1) 2^-8 sqrt(sum_i x_i^2 E_ji^2) for each row of
    ``x`` (the final norm's output), E the head: the bound
    :func:`serving_alone_checks` derives for two bf16 runs that round some
    of their 2L residual adds and their final norm differently."""
    cfg = model.config
    head = (model.embed_tokens.weight if cfg.tie_word_embeddings
            else model.lm_head)
    if hasattr(head, "dequantize"):
        head = head.dequantize()
    head = head.detach().float()
    return (2 * cfg.num_hidden_layers + 1) * 2.0 ** -8 * (
        (x ** 2) @ (head ** 2).t()).sqrt()


def near_ties(logits, tol) -> list:
    """Per step: the top-2 margin within the two logits' tolerances."""
    out = []
    for row, t in zip(logits, tol):
        top = row.topk(2)
        out.append(float(top.values[0] - top.values[1])
                   <= float(t[top.indices].sum()))
    return out


def compare_streams(model, ref, got, label) -> dict:
    """Hold the run ``got`` to the run ``ref`` (both :func:`serve_logged`
    results over the same requests): each request's first-token logits
    within :func:`bf16_logit_tol` of the reference's, and its greedy
    stream equal to the reference's up to the first step at which either
    run's top-2 margin is within tolerance (a near tie, where rounding may
    pick either token; until the streams part, both runs' logits at a step
    come from the same context).  Returns what the log records."""
    worst, parts_at, tie_at = 0.0, {}, {}
    for rid, a in sorted(ref["streams"].items()):
        b = got["streams"][rid]
        lr, xr = ref["stream_log"].stacked(rid)
        lg, _ = got["stream_log"].stacked(rid)
        tol = bf16_logit_tol(model, xr)
        ratio = float(((lg[0] - lr[0]).abs() / tol[0]).max())
        worst = max(worst, ratio)
        if ratio > 1:
            raise AssertionError(f"{label} {rid}: first-token logits off the "
                                 f"reference by {ratio} x tolerance")
        parts = next((i for i, (s, t) in enumerate(zip(a, b)) if s != t),
                     None if len(a) == len(b) else min(len(a), len(b)))
        n = len(a) if parts is None else parts + 1
        ties = [p or q for p, q in zip(near_ties(lr[:n], tol[:n]),
                                       near_ties(lg[:n], tol[:n]))]
        first_tie = ties.index(True) if True in ties else None
        if parts is not None and (first_tie is None or parts < first_tie):
            raise AssertionError(f"{label} {rid}: stream parts from the "
                                 f"reference at step {parts}, before any near "
                                 f"tie: {b} vs {a}")
        parts_at[rid], tie_at[rid] = parts, first_tie
    return dict(first_token_logits_tol_ratio_max=worst,
                parts_at={k: v for k, v in parts_at.items() if v is not None},
                streams_identical=all(v is None for v in parts_at.values()),
                first_near_tie=tie_at)


def norm_launch_gate(engine, launches, chunks, steps, label,
                     verifies: int = 0) -> int:
    """On the card: the norm forward kernel launched exactly ``(2L + 1) x
    (chunks + steps + verifies)`` times (one model call each) and no other
    kernel (the cached modes attend in plain PyTorch, the int8 projections
    dequantize in plain PyTorch, and serving takes logits).  Off the card
    nothing launches.  Returns the expected count."""
    from apex_tpu_torch.ops import layer_norm as ln

    expected = (2 * engine.model.config.num_hidden_layers + 1) * (
        chunks + steps + verifies)
    if engine.device.type == "cuda" and {
            k: n for k, n in launches.items() if n} != {
            ln.LAYER_NORM_FWD.name: expected}:
        raise AssertionError(f"{label}: launches {launches}, expected only "
                             f"{ln.LAYER_NORM_FWD.name} x {expected}")
    return expected


def serve_logged(engine, requests, sv, *, prefix=None, first=0,
                 after_first=None, label="serving", **sched_kw) -> dict:
    """Serve ``requests`` through a fresh scheduler (``prefix_caching=
    prefix`` and ``sched_kw``: ``speculation``, ``policy``), with the
    kernel counts set to 0 just before and its chunks (:class:`ChunkLog`)
    and streams (:class:`StreamLog`) logged; holds the norm-launch gate
    and checks every stream.  The first ``first`` requests are submitted
    alone and served until their prompts are cached (then
    ``after_first(sched)`` runs) before the rest come."""
    import torch
    from apex_tpu_torch.ops import _dispatch

    sched = sv.ContinuousBatchingScheduler(engine, prefix_caching=prefix,
                                           **sched_kw)
    chunks0, steps0 = engine.prefill_chunks, engine.decode_steps
    verifies0 = engine.verify_calls
    _dispatch.reset_launches()
    with ChunkLog(engine) as chunk_log, \
            StreamLog(engine, sched, requests) as stream_log:
        t0 = time.perf_counter()
        for r in requests[:first]:
            sched.submit(r)
        while sched.prefill_backlog:
            sched.step()
        if after_first is not None:
            after_first(sched)
        for r in requests[first:]:
            sched.submit(r)
        results = sched.run()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    chunks = engine.prefill_chunks - chunks0
    steps = engine.decode_steps - steps0
    verifies = engine.verify_calls - verifies0
    if sched.spec_stats["dispatches"] != verifies:
        raise AssertionError(f"{label}: {verifies} verifies, spec_stats "
                             f"{sched.spec_stats}")
    if sorted(results) != sorted(r.rid for r in requests):
        raise AssertionError(f"{label}: served {sorted(results)}")
    vocab = engine.model.config.vocab_size
    for r in requests:
        toks = results[r.rid].tokens
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < vocab for t in toks):
            raise AssertionError(f"{label} {r.rid}: bad stream {toks}")
    ttft = sorted(res.ttft_s for res in results.values())
    return dict(
        sched=sched, results=results, chunk_log=chunk_log,
        stream_log=stream_log,
        streams={k: v.tokens for k, v in results.items()},
        summary=dict(wall_s=wall, ttft_p50_s=statistics.median(ttft),
                     ttft_max_s=max(ttft), prefill_chunks=chunks,
                     decode_steps=steps, verifies=verifies,
                     scheduler_steps=sched.steps_run,
                     spec_stats=sched.spec_stats,
                     control_stats=sched.control_stats, launches=launches,
                     expected_norm_launches=norm_launch_gate(
                         engine, launches, chunks, steps, label, verifies)))


def paged_checks(model, requests, dense, sv, device, **engine_kw) -> dict:
    """Paged serving against the dense run ``dense`` (a
    :func:`serve_logged` result over the same requests).

    1. The default pool (dense-capacity parity): the chunk log, every
       stream and every chunk's logits (the first-token ones among them)
       equal the dense engine's bit for bit; the pool holds no block after
       the run.
    2. A pool of about half that (``slots x 64 + 1`` blocks of 16): every
       request finishes, the pool's high-water mark stays within it, and
       the longest request's stream equals, bit for bit, that request
       replayed alone on a dense engine in the chunks it got
       (:func:`serve_in_chunks`)."""
    import torch

    out = {}
    slots = engine_kw["slots"]
    for name, num_blocks in (("default_pool", None),
                             ("tight_pool", slots * 64 + 1)):
        engine = sv.DecodeEngine(model, paged=sv.PagedCacheConfig(
            block_size=16, num_blocks=num_blocks), device=device, **engine_kw)
        run = serve_logged(engine, requests, sv, label=f"paged {name}")
        pool = engine.block_pool
        if pool.used_blocks or pool.high_water > pool.num_blocks - 1:
            raise AssertionError(f"{name}: {pool.used_blocks} blocks used "
                                 f"after run(), high water {pool.high_water}")
        out[name] = dict(num_blocks=pool.num_blocks,
                         high_water=pool.high_water, **run["summary"],
                         streams_identical_to_dense=run["streams"] == dense[
                             "streams"])
        del engine
        if num_blocks is None:
            if run["chunk_log"].calls != dense["chunk_log"].calls:
                raise AssertionError("paged serving cut other chunks than "
                                     "dense")
            if run["streams"] != dense["streams"]:
                raise AssertionError(f"paged streams differ from dense: "
                                     f"{run['streams']} vs {dense['streams']}")
            for a, b in zip(run["chunk_log"].logits,
                            dense["chunk_log"].logits):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"paged chunk logits differ from dense by "
                        f"{float((a - b).abs().max())}")
            out[name]["chunks_and_logits_identical_to_dense"] = True
            continue
        probe = max(requests, key=lambda r: len(r.prompt))
        slot, chunks = run["chunk_log"].chunks_of(probe.prompt)
        alone = serve_in_chunks(sv.DecodeEngine(model, device=device,
                                                **engine_kw),
                                probe, slot, chunks)[0]
        if alone != run["streams"][probe.rid]:
            raise AssertionError(f"{name}: {probe.rid} replayed alone on the "
                                 f"dense engine in its chunks {chunks} gave "
                                 f"{alone}, served {run['streams'][probe.rid]}")
        out[name].update(probe=probe.rid, probe_slot=slot,
                         probe_chunks=chunks, probe_equals_dense_alone=True)
    return out


def prefix_checks(model, requests, sv, device, *, paged: bool,
                  max_tokens: int = 16384, **engine_kw) -> dict:
    """The shared-prefix workload with and without
    ``prefix_caching=PrefixCacheConfig(max_tokens)``, on a paged engine
    (hits alias the donor's blocks) or a dense one (capture by
    ``read_region``, restore by ``restore_prefix``).  The first request is
    served alone until its prompt is cached, then the rest come: every
    other request must hit, with the whole prefix saved.  Paged: each
    hit's table begins with the donor's block ids, and no block is copied
    on write.  Dense: the restored rows equal the captured ones bit for
    bit.  Both: :func:`compare_streams` against the run without prefix
    caching."""
    import torch

    kw = dict(device=device, **engine_kw)
    if paged:
        kw["paged"] = sv.PagedCacheConfig(block_size=16)
    prefix_len = len(os.path.commonprefix([r.prompt for r in requests]))
    base = serve_logged(sv.DecodeEngine(model, **kw), requests, sv, first=1,
                        label="without prefix caching")
    engine = sv.DecodeEngine(model, **kw)
    donor, checked = {}, []
    if paged:
        def after_first(sched):
            (slot,) = sched.active_slots
            donor["ids"] = engine.slot_block_ids(slot)[:prefix_len // 16]

        inner = engine.alias_prefix

        def alias(slot, block_ids, length):
            inner(slot, block_ids, length)
            checked.append(engine.slot_block_ids(slot)[:len(donor["ids"])]
                           == donor["ids"])
        engine.alias_prefix = alias
    else:
        after_first = None
        inner = engine.restore_prefix

        def restore(slot, kv, length):
            inner(slot, kv, length)
            k, v = engine.read_region(slot, 0, length)
            checked.append(torch.equal(k, kv[0][:, :length])
                           and torch.equal(v, kv[1][:, :length]))
        engine.restore_prefix = restore
    run = serve_logged(engine, requests, sv,
                       prefix=sv.PrefixCacheConfig(max_tokens=max_tokens),
                       first=1, after_first=after_first,
                       label="with prefix caching")
    # the wrapper refers to the engine: drop it, or the engine, its cache
    # and the model stay alive in a reference cycle
    del engine.__dict__["alias_prefix" if paged else "restore_prefix"]
    stats = run["sched"].stats()
    n = len(requests)
    block = run["sched"].prefix_cache.block_size
    saved = prefix_len // block * block
    if stats != dict(prefix_hits=n - 1, prefix_misses=1,
                     prefix_saved_tokens=(n - 1) * saved):
        raise AssertionError(f"prefix stats {stats}, expected {n - 1} hits, "
                             f"1 miss, {(n - 1) * saved} saved tokens")
    if len(checked) != n - 1 or not all(checked):
        raise AssertionError(f"{'aliased tables' if paged else 'restored rows'}"
                             f" not the donor's: {checked}")
    if engine.cow_copies:
        raise AssertionError(f"{engine.cow_copies} blocks copied on write")
    out = dict(
        paged=paged, requests=n, prefix_tokens=prefix_len, block_size=block,
        stats=stats, prefix_cache=run["sched"].prefix_cache.stats(),
        with_prefix=run["summary"], without_prefix=base["summary"],
        **compare_streams(model, base, run,
                          "paged prefix" if paged else "dense prefix"),
        tolerance="first-token logits within tol_j = (2L + 1) 2^-8 sqrt(sum_i "
                  "x_i^2 E_ji^2) of the run without prefix caching; streams "
                  "equal up to the first near tie")
    out["hits_aliased_not_copied" if paged else "restored_rows_identical"] = True
    return out


SPEC_MAX_DRAFT = 8
CONTROL_STEP_S = 0.25      # the control plane's virtual seconds a step


def forced_draft_check(engine, probe, sv) -> dict:
    """``verify_draft`` fed drafts whose acceptance does not rest on how
    repetitive random weights are: ``probe``'s plain greedy stream alone
    (:func:`serve_in_chunks`, its own chunks, slot 0) gives the true
    continuation.  Fed tokens 0-8 of it (pending token and an 8-token
    draft) the verify must accept all 8 or stop at a near tie; fed the
    same draft corrupted at position 3 it must accept 3.  Either way the
    slot then holds ``offset + accepted + 1`` rows, the verify rows are
    within :func:`bf16_logit_tol` of the plain run's logits at the same
    depths, and so is the next decode's row (fed the plain token)."""
    import numpy as np

    n, step = len(probe.prompt), engine.prefill_len
    own = [min(step, n - i) for i in range(0, n, step)]
    tokens, logits, x = serve_in_chunks(engine, probe, 0, own)
    tol = bf16_logit_tol(engine.model, x)
    ties = near_ties(logits, tol)
    out = {}
    for name, corrupt in (("true_continuation", None), ("corrupted_at_3", 3)):
        engine.reset()
        pos = 0
        for c in own:
            engine.prefill_chunk(0, probe.prompt[pos:pos + c])
            pos += c
        draft = list(tokens[1:SPEC_MAX_DRAFT + 1])
        if corrupt is not None:
            draft[corrupt] = (draft[corrupt] + 1) % engine.model.config.vocab_size
        offset = int(engine.lengths()[0])
        accepted, greedy, rows = engine.verify_draft(0, [tokens[0]] + draft)
        want = len(draft) if corrupt is None else corrupt
        # a row that rejects below ``want`` must sit on a near tie of the
        # plain run (row i predicts stream token i + 1)
        if accepted > want or (accepted < want and not ties[accepted + 1]):
            raise AssertionError(f"forced draft {name}: accepted {accepted}, "
                                 f"expected {want} (near ties {ties[:10]})")
        length = int(engine.lengths()[0])
        if length != offset + accepted + 1 or int(
                engine.cache.lengths[0]) != length:
            raise AssertionError(f"forced draft {name}: slot length {length}, "
                                 f"device {int(engine.cache.lengths[0])}, "
                                 f"expected {offset + accepted + 1}")
        ratio = float(((rows[:accepted + 1].float() - logits[1:accepted + 2])
                       .abs() / tol[1:accepted + 2]).max())
        ids = np.zeros((engine.slots,), np.int64)
        active = np.zeros((engine.slots,), bool)
        ids[0], active[0] = tokens[accepted + 1], True
        nxt = engine.decode(ids, active)[0]
        next_ratio = float(((nxt - logits[accepted + 2]).abs()
                            / tol[accepted + 2]).max())
        if ratio > 1 or next_ratio > 1:
            raise AssertionError(f"forced draft {name}: verify rows off the "
                                 f"plain logits by {ratio} x tolerance, the "
                                 f"next decode by {next_ratio}")
        out[name] = dict(drafted=len(draft), accepted=accepted,
                         bonus_is_plain_token=int(greedy[accepted])
                         == tokens[accepted + 1],
                         verify_rows_tol_ratio=ratio,
                         next_decode_tol_ratio=next_ratio)
    engine.reset()
    return out


def spec_checks(model, sv, device, *, paged: bool, observe=None,
                **engine_kw) -> dict:
    """Speculative decoding (``SpeculationConfig(max_draft=8)``) against
    plain decode, in one call, on a dense or a paged engine (1,025 blocks
    of 16), over two request sets: 12 quoted-context requests
    (:func:`quoted_requests`) and the 12 random-prompt ones
    (:func:`serving_requests`, incompressible: mostly the fall-back to
    plain decode).  Each speculative stream equals its plain one up to the
    first near tie (:func:`compare_streams`); the quoted set's verifies
    ran; the norm-launch gate counts verifies as model calls.  Then the
    forced-draft check (:func:`forced_draft_check`).  With ``observe`` (a
    dict), the quoted set's speculative run has a request recorder and a
    capture sink installed, and :func:`spec_reconciled` holds them to the
    scheduler; its result goes into ``observe``."""
    kw = dict(device=device, **engine_kw)
    if paged:
        kw["paged"] = sv.PagedCacheConfig(block_size=16)
    engine = sv.DecodeEngine(model, **kw)
    form = "paged" if paged else "dense"
    vocab = model.config.vocab_size
    out = dict(paged=paged, max_draft=SPEC_MAX_DRAFT,
               num_blocks=engine.block_pool.num_blocks if paged else None)
    for name, requests in (("quoted", quoted_requests(vocab)),
                           ("random", serving_requests(vocab))):
        plain = serve_logged(engine, requests, sv,
                             label=f"{form} {name} plain")
        watch = observe is not None and name == "quoted"
        with Watched(enabled=watch) as watched:
            spec = serve_logged(engine, requests, sv,
                                speculation=sv.SpeculationConfig(
                                    max_draft=SPEC_MAX_DRAFT),
                                label=f"{form} {name} speculative")
        if watch:
            observe.update(spec_reconciled(watched, spec["sched"]))
        stats = spec["sched"].spec_stats
        if name == "quoted" and not stats["dispatches"]:
            raise AssertionError(f"{form} {name}: no verify ran: {stats}")
        if paged and (engine.block_pool.used_blocks or engine.cow_copies):
            raise AssertionError(f"{form} {name}: {engine.block_pool.used_blocks}"
                                 f" blocks used after, {engine.cow_copies} "
                                 f"copies on write")
        out[name] = dict(
            requests=len(requests),
            prompt_tokens=sum(len(r.prompt) for r in requests),
            new_tokens=requests[0].max_new_tokens,
            plain=plain["summary"], speculative=spec["summary"],
            tokens_per_verify=(stats["emitted"] / stats["dispatches"]
                               if stats["dispatches"] else None),
            acceptance=(stats["accepted"] / stats["drafted"]
                        if stats["drafted"] else None),
            wall_ratio_spec_over_plain=spec["summary"]["wall_s"]
            / plain["summary"]["wall_s"],
            **compare_streams(model, plain, spec,
                              f"{form} {name} speculative"))
        log(f"phase3-serving-spec-{form}-{name}", **out[name])
    probe = quoted_requests(vocab)[0]
    out["forced_draft"] = forced_draft_check(engine, probe, sv)
    out["tolerance"] = ("streams equal to plain decode up to the first near "
                        "tie; first-token and verify logits within tol_j = "
                        "(2L + 1) 2^-8 sqrt(sum_i x_i^2 E_ji^2)")
    del engine
    return out


def control_workload(vocab: int, sv):
    """The control plane's open-loop workload (virtual seconds): at t 0,
    16 priority-0 requests of tenant ``batch``, prompts of 64-1,024
    tokens; at t 5, 8 priority-5 requests of tenant ``paid`` (prompts of
    64-512, deadline 20 s) and 4 priority-0 ``batch`` requests whose 0.5 s
    deadline runs out in the queue.  64 new tokens each, greedy, no
    ``eos_id``."""
    import torch

    rng = torch.Generator().manual_seed(9)

    def prompt(lo, hi):
        n = int(torch.randint(lo, hi + 1, (1,), generator=rng))
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    reqs, arrivals = [], []
    for i in range(16):
        reqs.append(sv.Request(f"b{i}", prompt(64, 1024), max_new_tokens=64,
                               tenant="batch"))
        arrivals.append(0.0)
    for i in range(8):
        reqs.append(sv.Request(f"p{i}", prompt(64, 512), max_new_tokens=64,
                               priority=5, tenant="paid", deadline_s=20.0))
        arrivals.append(5.0)
    for i in range(4):
        reqs.append(sv.Request(f"e{i}", prompt(64, 512), max_new_tokens=64,
                               tenant="batch", deadline_s=0.5))
        arrivals.append(5.0)
    return sv.OpenLoopWorkload(requests=tuple(reqs), arrivals=tuple(arrivals),
                               deadlines=tuple(r.deadline_s for r in reqs))


def serve_open_loop(engine, workload, sv, *, policy, label, clock=None,
                    step_hook=None) -> dict:
    """``workload`` through :class:`LoadGenerator` on a ``VirtualClock``
    (``clock``, a fresh one by default; ``CONTROL_STEP_S`` a step) over a
    fresh scheduler (``policy``), with ``step_hook`` after each step, the
    kernel counts set to 0 just before and the streams logged
    (:class:`StreamLog`); holds the norm-launch gate."""
    import torch
    from apex_tpu_torch.ops import _dispatch

    sched = sv.ContinuousBatchingScheduler(
        engine, max_queue=64, policy=policy,
        clock=sv.VirtualClock() if clock is None else clock)
    chunks0, steps0 = engine.prefill_chunks, engine.decode_steps
    _dispatch.reset_launches()
    with StreamLog(engine, sched, list(workload.requests)) as stream_log:
        t0 = time.perf_counter()
        out = sv.LoadGenerator(sched, workload, step_time_s=CONTROL_STEP_S,
                               step_hook=step_hook).run()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    chunks = engine.prefill_chunks - chunks0
    steps = engine.decode_steps - steps0
    served = {rid: r.tokens for rid, r in out.results.items()
              if r.finish_reason in sv.SERVED_REASONS}
    by_class = {}
    for cls, rids in (("paid", [r.rid for r in workload.requests
                                if r.priority == 5]),
                      ("batch", [r.rid for r in workload.requests
                                 if r.priority == 0 and r.rid in served])):
        ttft = sorted(out.results[r].ttft_s for r in rids if r in served)
        by_class[cls] = dict(served=len(ttft), ttft_p50_s=statistics.median(
            ttft) if ttft else None, ttft_p99_s=_nearest_rank(ttft, 0.99))
    return dict(
        sched=sched, out=out, stream_log=stream_log, streams=served,
        decisions={rid: (r.finish_reason, r.preemptions, len(r.tokens))
                   for rid, r in sorted(out.results.items())},
        summary=dict(wall_s=wall, virtual_s=out.duration_s,
                     scheduler_steps=out.steps, goodput=out.goodput,
                     completed=out.completed, offered=out.offered,
                     control_stats=sched.control_stats, ttft_by_class=by_class,
                     prefill_chunks=chunks, decode_steps=steps,
                     launches=launches,
                     expected_norm_launches=norm_launch_gate(
                         engine, launches, chunks, steps, label)))


def _nearest_rank(sorted_values, q):
    """The nearest-rank ``q`` quantile of a sorted list (None if empty)."""
    if not sorted_values:
        return None
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


def control_checks(model, sv, device, keep=None, **engine_kw) -> dict:
    """The control plane at full width, dense and paged (default pool):
    :func:`control_workload` under ``SchedulingPolicy(tenant_weights=
    {"paid": 3.0})`` and under FIFO (``policy=None``).  Gates: under the
    policy ``preempted >= 1``, ``resumed == preempted`` and the 4 expiring
    requests shed; every served stream, preempted ones included, equal to
    its FIFO run's up to the first near tie (:func:`compare_streams`); the
    decisions (each result's finish reason, preemptions and token count)
    equal between the dense and paged runs; the paid requests' p99 TTFT
    lower under the policy; the paged pool empty after each run.  Then on
    the paged engine the scheduler's ``close()`` (:func:`close_check`).
    With ``keep`` (a dict), the dense engine and its two runs stay in it
    (``engine``, ``fifo``, ``policy``) for :func:`obs_checks`."""
    vocab = model.config.vocab_size
    workload = control_workload(vocab, sv)
    expiring = {r.rid for r in workload.requests if r.deadline_s == 0.5}
    paid = {r.rid for r in workload.requests if r.priority == 5}
    out, runs = {}, {}
    for form in ("dense", "paged"):
        kw = dict(device=device, **engine_kw)
        if form == "paged":
            kw["paged"] = sv.PagedCacheConfig(block_size=16)
        engine = sv.DecodeEngine(model, **kw)
        for name, policy in (("fifo", None), ("policy", sv.SchedulingPolicy(
                tenant_weights={"paid": 3.0}))):
            run = serve_open_loop(engine, workload, sv, policy=policy,
                                  label=f"control {form} {name}")
            runs[form, name] = run
            if form == "paged" and engine.block_pool.used_blocks:
                raise AssertionError(f"control paged {name}: "
                                     f"{engine.block_pool.used_blocks} blocks "
                                     f"used after the run")
        stats = runs[form, "policy"]["sched"].control_stats
        shed = {rid for rid, d in runs[form, "policy"]["decisions"].items()
                if d[0] == "shed"}
        if not (stats["preempted"] >= 1 and stats["resumed"] == stats[
                "preempted"] and stats["shed"] == len(expiring)
                and shed == expiring):
            raise AssertionError(f"control {form}: {stats}, shed {sorted(shed)}")
        fifo, pol = runs[form, "fifo"], runs[form, "policy"]
        common = sorted(set(fifo["streams"]) & set(pol["streams"]))
        cmp = compare_streams(
            model, dict(streams={r: fifo["streams"][r] for r in common},
                        stream_log=fifo["stream_log"]),
            dict(streams={r: pol["streams"][r] for r in common},
                 stream_log=pol["stream_log"]), f"control {form} policy")
        p99 = {n: runs[form, n]["summary"]["ttft_by_class"]["paid"][
            "ttft_p99_s"] for n in ("fifo", "policy")}
        if not p99["policy"] < p99["fifo"]:
            raise AssertionError(f"control {form}: paid p99 TTFT {p99}")
        resumed = sorted(r for r, d in pol["decisions"].items()
                         if d[0] == "preempted-resumed")
        out[form] = dict(fifo=fifo["summary"], policy=pol["summary"],
                         preempted_resumed=resumed,
                         paid_p99_ttft_virtual_s=p99, **cmp)
        log(f"phase3-serving-control-{form}", **out[form])
        if form == "paged":
            out["close"] = close_check(engine, sv)
        elif keep is not None:
            keep.update(engine=engine, fifo=fifo, policy=pol)
        del engine
    for name in ("fifo", "policy"):
        if runs["dense", name]["decisions"] != runs["paged", name]["decisions"]:
            raise AssertionError(f"control {name}: dense and paged decided "
                                 f"differently")
    out.update(workload=dict(requests=len(workload.requests), paid=len(paid),
                             expiring=len(expiring),
                             fingerprint=workload.schedule_fingerprint(),
                             step_virtual_s=CONTROL_STEP_S),
               decisions_equal_dense_paged=True,
               tolerance="served streams equal to the FIFO run's up to the "
                         "first near tie; first-token logits within tol_j = "
                         "(2L + 1) 2^-8 sqrt(sum_i x_i^2 E_ji^2)")
    return out


def close_check(engine, sv) -> dict:
    """``close()`` on a caching scheduler over a paged engine: the cache's
    blocks go back to the pool (``used_blocks`` 0) and the reclaim hook is
    unwired; a successor caching scheduler then starts from a free pool
    (the same hits and misses as the first, the same streams)."""
    pool = engine.block_pool
    requests = prefix_requests(engine.model.config.vocab_size, n=4,
                               new_tokens=8)
    runs = []
    for _ in range(2):
        if pool.used_blocks or pool.reclaim is not None:
            raise AssertionError(f"close: {pool.used_blocks} blocks used, "
                                 f"reclaim {pool.reclaim} before a scheduler")
        run = serve_logged(engine, requests, sv, prefix=sv.PrefixCacheConfig(),
                           first=1, label="close check")
        cache = run["sched"].prefix_cache
        held = pool.used_blocks
        if not held or held != len(cache):
            raise AssertionError(f"close: {held} blocks used for "
                                 f"{len(cache)} cache entries")
        run["sched"].close()
        run["sched"].close()
        if pool.used_blocks or pool.reclaim is not None or len(cache):
            raise AssertionError(f"close: {pool.used_blocks} blocks used after "
                                 f"close(), reclaim {pool.reclaim}")
        runs.append(dict(streams=run["streams"], stats=run["sched"].stats(),
                         blocks_held_before_close=held))
    if runs[0] != runs[1]:
        raise AssertionError(f"close: the successor differs: {runs}")
    return dict(blocks_held_before_close=runs[0]["blocks_held_before_close"],
                blocks_after_close=0, successor_identical=True,
                prefix_stats=runs[0]["stats"])


def export_adopt_checks(model, requests, sv, device, **engine_kw) -> dict:
    """Failover between two dense engines over the one model object (a
    cache of their own each): ``requests`` served on the donor until each
    is decoding with 8 tokens or more, then ``export_streams`` (with
    ``capture=True``: host copies of each stream's rows, restored by the
    adopter, which decodes on; with ``capture=False``: requeued and
    computed again), ``adopt_stream`` on the other scheduler, and run to
    the end.  Every stream equals the uninterrupted run's up to the first
    near tie (:func:`compare_streams`, the logits of both engines'
    parts); the donor is closed and free."""
    import torch
    from apex_tpu_torch.ops import _dispatch

    donor_eng = sv.DecodeEngine(model, device=device, **engine_kw)
    target_eng = sv.DecodeEngine(model, device=device, **engine_kw)
    ref = serve_logged(donor_eng, requests, sv, label="export reference")
    out = dict(requests=len(requests),
               cache_bytes_per_engine=sv.kv_bytes_per_token(donor_eng.cache)
               * engine_kw["slots"] * engine_kw["max_len"])
    for capture in (True, False):
        donor_eng.reset()
        target_eng.reset()
        donor = sv.ContinuousBatchingScheduler(donor_eng)
        target = sv.ContinuousBatchingScheduler(target_eng)
        counts0 = [(e.prefill_chunks, e.decode_steps)
                   for e in (donor_eng, target_eng)]
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        with StreamLog(donor_eng, donor, requests) as dlog:
            for r in requests:
                donor.submit(r)
            while any(donor.progress_of(r.rid) < 8 for r in requests):
                donor.step()
            exports = donor.export_streams(capture=capture)
        donor.close()
        if donor.active_count or donor_eng.free_slots() != list(
                range(donor_eng.slots)):
            raise AssertionError("export left the donor busy")
        with StreamLog(target_eng, target, requests) as tlog:
            for e in exports:
                if not target.adopt_stream(e):
                    raise AssertionError(f"adopt {e.request.rid} refused")
            results = target.run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _dispatch.KERNELS}
        chunks = sum(e.prefill_chunks - c for e, (c, _) in zip(
            (donor_eng, target_eng), counts0))
        steps = sum(e.decode_steps - s for e, (_, s) in zip(
            (donor_eng, target_eng), counts0))
        merged = StreamLog(None, None, [])
        for r in requests:
            rid = r.rid
            if capture:
                merged.logits[rid] = dlog.logits[rid] + tlog.logits[rid]
                merged.x[rid] = dlog.x[rid] + tlog.x[rid]
            else:
                merged.logits[rid], merged.x[rid] = tlog.logits[rid], tlog.x[rid]
        got = dict(streams={k: v.tokens for k, v in results.items()},
                   stream_log=merged)
        name = "capture" if capture else "requeue"
        preempted = sorted({v.preemptions for v in results.values()})
        if preempted != [int(capture)] or any(
                (e.kv is not None) != capture for e in exports):
            raise AssertionError(f"export {name}: preemptions {preempted}")
        out[name] = dict(
            wall_s=wall, exported=len(exports),
            tokens_at_export=sorted(len(e.tokens) for e in exports),
            captured_bytes=sum(e.kv[0].numel() * e.kv[0].element_size() * 2
                               for e in exports if e.kv is not None),
            prefill_chunks=chunks, decode_steps=steps, launches=launches,
            expected_norm_launches=norm_launch_gate(
                donor_eng, launches, chunks, steps, f"export {name}"),
            **compare_streams(model, ref, got, f"export {name}"))
        log(f"phase3-serving-export-{name}", **out[name])
    del donor_eng, target_eng
    return out


OBS_SLOW_STEPS = (10, 30)   # chaos: scheduler steps inflated by 1.0 virtual s
OBS_STALL = ("b3", 3)       # chaos: the stalled rid, cancelled after 3 tokens
OBS_STORM = (40, 2, 0)      # chaos: the cancel storm's step, count and seed
OBS_RATE = 4.0              # real clock: Poisson arrivals a second
OBS_DEADLINE_S = 10.0       # real clock: each request's deadline from arrival
OBS_EMIT_CALLS = 10_000


class Watched:
    """While entered, the whole telemetry stack on: the default registry
    zeroed, a :class:`RequestTraceRecorder` on ``clock``, a
    :class:`TraceRecorder` with one span around the block (the bridge
    stamps every event onto it) and a capture sink (``events``); on exit
    ``snapshot`` holds the registry.  ``enabled=False`` installs nothing
    (the bridge alone, as always)."""

    def __init__(self, clock=time.monotonic, *, enabled=True,
                 span="phase3-serving-obs"):
        self.clock, self.enabled, self.span = clock, enabled, span
        self.events, self.snapshot = [], None

    def __enter__(self):
        import contextlib

        from apex_tpu_torch import _logging, obs

        self.rec = obs.RequestTraceRecorder(clock=self.clock)
        self.trace = obs.TraceRecorder()
        self._stack = contextlib.ExitStack()
        if self.enabled:
            obs.metrics.reset()
            self.rec.install()
            self._stack.callback(self.rec.uninstall)
            obs.install_recorder(self.trace)
            self._stack.callback(obs.uninstall_recorder)
            _logging.add_event_sink(self.events.append)
            self._stack.callback(_logging.remove_event_sink,
                                 self.events.append)
            self._stack.enter_context(obs.span(self.span))
        return self

    def __exit__(self, *exc):
        from apex_tpu_torch import obs

        self._stack.__exit__(*exc)
        if self.enabled:
            self.snapshot = obs.snapshot()
        return False


def spec_reconciled(watched, sched) -> dict:
    """The speculative run's records against its events and the
    scheduler: per rid, the record's verifies, drafted, accepted and
    emitted tokens equal the sum of its ``serving_spec_verify`` events,
    and the totals equal ``spec_stats``; every verify event comes before
    its request's ``serving_request_finished`` (the order the JAX
    scheduler gets wrong, losing the last verify from its records)."""
    keys = ("dispatches", "drafted", "accepted", "emitted")
    per_rid, finished_at, caused = {}, {}, 0
    for i, e in enumerate(watched.events):
        if e["event"] == "serving_request_finished":
            finished_at[e["rid"]] = i
    for i, e in enumerate(watched.events):
        if e["event"] != "serving_spec_verify":
            continue
        st = per_rid.setdefault(e["rid"], dict.fromkeys(keys, 0))
        st["dispatches"] += 1
        for k in keys[1:]:
            st[k] += e[k]
        if not i < finished_at[e["rid"]]:
            raise AssertionError(f"obs spec: {e['rid']}'s verify after its "
                                 f"finish")
        caused += finished_at[e["rid"]] == i + 1
    records = watched.rec.records()
    for r in records:
        got = {k: r.spec.get(k, 0) for k in keys}
        if got != per_rid.get(r.rid, dict.fromkeys(keys, 0)):
            raise AssertionError(f"obs spec {r.rid}: record {got}, events "
                                 f"{per_rid.get(r.rid)}")
    totals = {k: sum(r.spec.get(k, 0) for r in records) for k in keys}
    if totals != sched.spec_stats or watched.rec.open_records():
        raise AssertionError(f"obs spec: records {totals}, scheduler "
                             f"{sched.spec_stats}")
    return dict(records=len(records), totals=totals,
                verifies_that_finished_their_request=caused,
                verify_events=sum(v["dispatches"] for v in per_rid.values()))


def _serving_series_named(snapshot, text) -> list:
    """The ``apex_serving_*`` metrics with a series set that the
    Prometheus text has no sample line for (empty: all named)."""
    lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
    return [name for name, entry in snapshot.items()
            if name.startswith("apex_serving_") and entry["series"]
            and not any(ln.startswith(name) for ln in lines)]


def obs_reconciled(watched, run, sv, paid_p99) -> dict:
    """An open-loop run's telemetry against the scheduler and the load
    generator (virtual clock): one record a request, each served one
    complete with phases summing to its total and the scheduler's TTFT and
    queue wait; ``apex_events_total{event=k}`` the capture sink's count of
    ``k``; the preempted, cancelled, shed and prefix counters the
    scheduler's; ``build_report``'s goodput the load generator's and its
    paid p99 TTFT ``paid_p99``; the TTFT histogram's quantiles in the
    exact samples' buckets; the Perfetto export one track a request; and
    every ``apex_serving_*`` series set named by ``prometheus_text()``."""
    import json
    import tempfile

    from apex_tpu_torch import obs
    from apex_tpu_torch.obs import bridge
    from apex_tpu_torch.obs.request_trace import PHASE_SUM_TOLERANCE_S

    sched, lg = run["sched"], run["out"]
    rec = watched.rec
    records = {r.rid: r for r in rec.records()}
    if rec.open_records() or set(records) != set(lg.results):
        raise AssertionError(f"obs: records {sorted(records)}, open "
                             f"{len(rec.open_records())}, results "
                             f"{sorted(lg.results)}")
    for rid, res in lg.results.items():
        r = records[rid]
        served = res.finish_reason in sv.SERVED_REASONS
        if r.complete != served or r.finish_reason != res.finish_reason:
            raise AssertionError(f"obs {rid}: record {r.to_dict()}, result "
                                 f"{res.finish_reason}")
        if not served:
            continue
        phases = r.queue_wait_s + r.prefill_s + r.decode_s
        if (abs(phases - r.total_s) > PHASE_SUM_TOLERANCE_S
                or r.ttft_s != res.ttft_s or r.total_s != res.total_s
                or r.queue_wait_s != r.scheduler_queue_wait_s):
            raise AssertionError(f"obs {rid}: record {r.to_dict()}, result "
                                 f"{res}")
    counts = {}
    for e in watched.events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    events_total = {s["labels"]["event"]: s["value"] for s in
                    watched.snapshot["apex_events_total"]["series"]}
    if events_total != counts:
        raise AssertionError(f"obs: apex_events_total {events_total}, "
                             f"events {counts}")
    stats, prefix = sched.control_stats, sched.stats()
    counters = dict(preempted=bridge.SERVING_PREEMPTED.value(),
                    cancelled=bridge.SERVING_CANCELLED.value(),
                    shed=bridge.SERVING_SHED.value(),
                    prefix_hits=bridge.SERVING_PREFIX_HITS.value(),
                    prefix_misses=bridge.SERVING_PREFIX_MISSES.value())
    if counters != dict(preempted=stats["preempted"],
                        cancelled=stats["cancelled"], shed=stats["shed"],
                        prefix_hits=prefix["prefix_hits"],
                        prefix_misses=prefix["prefix_misses"]):
        raise AssertionError(f"obs: counters {counters}, scheduler {stats}, "
                             f"{prefix}")
    kw = dict(offered=lg.offered, deadlines=lg.deadlines,
              arrivals=lg.arrivals, duration_s=lg.duration_s)
    report = obs.build_report(list(records.values()), **kw)
    paid = [r for r in records.values() if r.rid.startswith("p")]
    paid_report = obs.build_report(paid)
    if report.goodput != lg.goodput or paid_report.ttft["p99"] != paid_p99:
        raise AssertionError(f"obs: goodput {report.goodput} vs "
                             f"{lg.goodput}, paid p99 {paid_report.ttft} vs "
                             f"{paid_p99}")
    ttft = [r.ttft_s for r in records.values() if r.complete]
    cross = obs.crosscheck_quantiles(ttft, bridge.SERVING_TTFT)
    if not (cross["aligned"] and all(
            q["agree"] for q in cross["quantiles"].values())):
        raise AssertionError(f"obs: TTFT histogram {cross}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "requests.trace.json")
        rec.export(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    tracks = {e["tid"] for e in trace if e.get("ph") == "X"}
    named = {e["args"]["name"] for e in trace if e.get("ph") == "M"
             and e["name"] == "thread_name"}
    if len(tracks) != len(records) or named != set(records):
        raise AssertionError(f"obs: {len(tracks)} tracks, {len(named)} names "
                             f"for {len(records)} requests")
    unnamed = _serving_series_named(watched.snapshot, obs.prometheus_text())
    if unnamed:
        raise AssertionError(f"obs: prometheus_text() lacks {unnamed}")
    return dict(records=len(records), served_complete=len(ttft),
                event_kinds=counts, counters=counters,
                goodput=report.goodput, paid_ttft_p99_s=paid_p99,
                ttft_crosscheck=cross["quantiles"], perfetto_tracks=len(tracks),
                serving_series_set=sorted(
                    n for n, e in watched.snapshot.items()
                    if n.startswith("apex_serving_") and e["series"]))


def _quantiles(report) -> dict:
    return {name: {q: getattr(report, name)[q] for q in ("p50", "p95", "p99")}
            for name in ("ttft", "tpot", "queue_wait")}


def _profiled_decode_steps(engine, sv, telemetry: bool, logdir) -> dict:
    """Three decode steps of a full batch (8 requests of 64 tokens, their
    prompts cached first) under ``start_torch_profiler(logdir)`` /
    ``stop_torch_profiler()``, with the whole telemetry stack on or the
    bridge uninstalled; returns what the written trace names: norm kernel
    launches and device-to-host copies."""
    import json

    import torch
    from apex_tpu_torch.obs import bridge
    from apex_tpu_torch.obs import trace as otrace

    engine.reset()
    sched = sv.ContinuousBatchingScheduler(engine)
    for i in range(engine.slots):
        sched.submit(sv.Request(f"pf{i}", list(range(1 + i, 65 + i)),
                                max_new_tokens=16))
    if not telemetry:
        bridge.uninstall()
    try:
        with Watched(enabled=telemetry):
            while sched.prefill_backlog:
                sched.step()
            torch.cuda.synchronize()
            started = otrace.start_torch_profiler(logdir)
            for _ in range(3):
                sched.step()
            torch.cuda.synchronize()
            stopped = otrace.stop_torch_profiler()
            sched.run()
    finally:
        bridge.install()
    files = sorted(f for f in os.listdir(logdir) if f.startswith("trace_"))
    if not (started and stopped and len(files) == 1):
        raise AssertionError(f"obs profiler: start {started}, stop {stopped}, "
                             f"files {files}")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    norm = sum("ln_fwd" in k for k in kernels)
    d2h = sum("DtoH" in e.get("name", "") for e in events
              if e.get("cat") == "gpu_memcpy")
    if not norm:
        raise AssertionError(f"obs profiler: the trace names no norm kernel "
                             f"({sorted(set(kernels))[:10]})")
    return dict(trace_file=files[0], norm_launches=norm, d2h_copies=d2h,
                kernels=len(kernels),
                trace_bytes=os.path.getsize(os.path.join(logdir, files[0])))


def obs_costs(engine, sv, inert, smi) -> dict:
    """What the telemetry costs: microseconds an ``emit_event`` with the
    log sink, the bridge and a request recorder installed (a prefill-chunk
    event on an open record, ``OBS_EMIT_CALLS`` calls) and with the
    bridge alone; events a decode step in the inert run; and the wall of
    the 12-request dense serve with everything installed against the
    bridge uninstalled and nothing else (interleaved, two of each,
    median).  Printed, not gated: walls spread between calls."""
    from apex_tpu_torch import _logging
    from apex_tpu_torch.obs import bridge

    def emit_us(recorder: bool) -> float:
        with Watched(enabled=recorder) as w:
            _logging.emit_event("serving_request_queued", rid="cost",
                                prompt_tokens=512)
            t0 = time.perf_counter()
            for _ in range(OBS_EMIT_CALLS):
                _logging.emit_event("serving_prefill_chunk", rid="cost",
                                    bucket=512, chunk_tokens=512,
                                    offset_tokens=0, duration_s=0.0125)
            dt = time.perf_counter() - t0
        if recorder and len(w.rec.open_records()[0].chunks) != OBS_EMIT_CALLS:
            raise AssertionError("obs cost: the recorder missed events")
        return dt / OBS_EMIT_CALLS * 1e6

    requests = serving_requests(engine.model.config.vocab_size)
    walls = {"on": [], "off": []}
    for on in (True, False, True, False):
        engine.reset()
        if not on:
            bridge.uninstall()
        try:
            with Watched(enabled=on):
                _, wall = serve(engine, requests, sv)
        finally:
            bridge.install()
        walls["on" if on else "off"].append(wall)
    return dict(
        emit_us_all_installed=emit_us(True), emit_us_bridge_only=emit_us(False),
        emit_calls=OBS_EMIT_CALLS,
        events_per_decode_step=inert["events"] / inert["decode_steps"],
        events_per_scheduler_step=inert["events"] / inert["scheduler_steps"],
        serve_walls_s=walls,
        wall_ratio_on_over_off=statistics.median(walls["on"])
        / statistics.median(walls["off"]), nvidia_smi=smi)


def obs_checks(model, sv, device, control, spec, smi) -> dict:
    """Phase ``phase3-serving-obs``: the observability layer at full width
    on the control plane's dense engine and runs (``control``, kept by
    :func:`control_checks`) and the dense quoted speculation run
    (``spec``, from :func:`spec_checks`):

    1. *inert*: :func:`control_workload` under the policy again, now with
       a request recorder, a span recorder and a capture sink: decisions,
       served streams and their logits equal the first run's bit for bit,
       and the same norm launches;
    2. *reconciled*: that run's telemetry (:func:`obs_reconciled`);
    3. *speculation reconciled*: ``spec`` (:func:`spec_reconciled`);
    4. *chaos*: the same workload under FIFO and the policy with two slow
       steps, a stalled stream and a cancel storm (the JAX chaos acceptance
       design): under the policy >= 1 preempted, all resumed, >= 1 shed;
       every stalled or cancelled request reclaimed; served streams equal
       the chaos-free FIFO run's up to the first near tie; the policy's
       paid p99 TTFT below FIFO's and its goodput above (``build_report``
       over the records);
    5. *real clock*: the 12 serving requests, Poisson arrivals, on
       ``time.monotonic``: the TTFT, TPOT and queue-wait percentiles and
       goodput from the records (printed);
    6. *cost* (:func:`obs_costs`, printed);
    7. *profiler*: ``start_torch_profiler`` / ``stop_torch_profiler``
       around 3 decode steps, telemetry on and off: both True, a trace
       file naming the norm kernel, and as many device-to-host copies
       with the telemetry on as off."""
    import shutil
    import tempfile

    import torch
    from apex_tpu_torch import obs
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.resilience import fault_injection as fi

    engine, first, fifo = control["engine"], control["policy"], control["fifo"]
    vocab = model.config.vocab_size
    workload = control_workload(vocab, sv)
    out = {}

    def policy():
        return sv.SchedulingPolicy(tenant_weights={"paid": 3.0})

    engine.reset()
    clock = sv.VirtualClock()
    with Watched(clock) as watched:
        run = serve_open_loop(engine, workload, sv, policy=policy(),
                              label="obs inert", clock=clock)
    if (run["decisions"] != first["decisions"]
            or run["streams"] != first["streams"]
            or run["summary"]["launches"] != first["summary"]["launches"]):
        raise AssertionError("obs inert: the run with telemetry differs from "
                             "the control run")
    for rid in run["streams"]:
        if not torch.equal(run["stream_log"].stacked(rid)[0],
                           first["stream_log"].stacked(rid)[0]):
            raise AssertionError(f"obs inert {rid}: logits differ")
    summary = run["summary"]
    out["inert"] = dict(
        decisions_equal=True, streams_bit_identical=True,
        logits_bit_identical=True, launches=summary["launches"],
        expected_norm_launches=summary["expected_norm_launches"],
        events=len(watched.events), decode_steps=summary["decode_steps"],
        scheduler_steps=summary["scheduler_steps"],
        spans=len(watched.trace.to_chrome_trace()["traceEvents"]),
        wall_s=summary["wall_s"], control_wall_s=first["summary"]["wall_s"])
    log("phase3-serving-obs-inert", **out["inert"])
    out["reconciled"] = obs_reconciled(
        watched, run, sv,
        first["summary"]["ttft_by_class"]["paid"]["ttft_p99_s"])
    log("phase3-serving-obs-reconciled", **out["reconciled"])
    out["spec"] = spec
    log("phase3-serving-obs-spec", **spec)

    chaos = {}
    for name, pol in (("fifo", None), ("policy", policy())):
        engine.reset()
        clock = sv.VirtualClock()
        stall = fi.StallStream([OBS_STALL[0]], after_tokens=OBS_STALL[1])
        storm = fi.CancelStorm([OBS_STORM[0]], count=OBS_STORM[1],
                               seed=OBS_STORM[2])
        hook = sv.chain_hooks(fi.SlowDecodeStep(OBS_SLOW_STEPS, 1.0,
                                                clock=clock), stall, storm)
        with Watched(clock) as watched:
            crun = serve_open_loop(engine, workload, sv, policy=pol,
                                   label=f"obs chaos {name}", clock=clock,
                                   step_hook=hook)
        sched, lg = crun["sched"], crun["out"]
        hit = stall.stalled + storm.cancelled
        if (not hit or sched.queue_depth or sched.active_count
                or sched.suspended_count
                or engine.free_slots() != list(range(engine.slots))
                or any(lg.results[r].finish_reason != "cancelled"
                       for r in hit)):
            raise AssertionError(f"obs chaos {name}: {hit} not reclaimed")
        records = watched.rec.records()
        report = obs.build_report(
            records, offered=lg.offered, deadlines=lg.deadlines,
            arrivals=lg.arrivals, duration_s=lg.duration_s)
        paid = sorted(r.ttft_s for r in records
                      if r.rid.startswith("p") and r.complete)
        common = sorted(set(fifo["streams"]) & set(crun["streams"]))
        cmp = compare_streams(
            model, dict(streams={r: fifo["streams"][r] for r in common},
                        stream_log=fifo["stream_log"]),
            dict(streams={r: crun["streams"][r] for r in common},
                 stream_log=crun["stream_log"]), f"obs chaos {name}")
        faults = [e for e in watched.events if e["event"] == "fault_injected"]
        chaos[name] = dict(
            summary=crun["summary"], stalled=stall.stalled,
            storm_cancelled=storm.cancelled, fault_events=len(faults),
            goodput_report=report.goodput, goodput=lg.goodput,
            paid_ttft_p99_s=_nearest_rank(paid, 0.99),
            paid_complete=len(paid), compared=len(common),
            **_quantiles(report), **cmp)
        log(f"phase3-serving-obs-chaos-{name}", **chaos[name])
    stats = chaos["policy"]["summary"]["control_stats"]
    if not (stats["preempted"] >= 1 and stats["resumed"] == stats["preempted"]
            and stats["shed"] >= 1):
        raise AssertionError(f"obs chaos policy: {stats}")
    if not (chaos["policy"]["paid_ttft_p99_s"] < chaos["fifo"]["paid_ttft_p99_s"]
            and chaos["policy"]["goodput_report"]
            > chaos["fifo"]["goodput_report"]):
        raise AssertionError(f"obs chaos: policy {chaos['policy']} against "
                             f"FIFO {chaos['fifo']}")
    out["chaos"] = chaos

    requests = serving_requests(vocab)
    wl = sv.OpenLoopWorkload(
        requests=tuple(requests),
        arrivals=sv.poisson_arrivals(len(requests), OBS_RATE, seed=11),
        deadlines=(OBS_DEADLINE_S,) * len(requests))
    engine.reset()
    sched = sv.ContinuousBatchingScheduler(engine)
    chunks0, steps0 = engine.prefill_chunks, engine.decode_steps
    _dispatch.reset_launches()
    with Watched() as watched:
        t0 = time.perf_counter()
        lg = sv.LoadGenerator(sched, wl).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    chunks = engine.prefill_chunks - chunks0
    steps = engine.decode_steps - steps0
    if lg.completed != len(requests):
        raise AssertionError(f"obs real clock: {lg.completed} completed")
    report = obs.build_report(watched.rec.records(), offered=lg.offered,
                              deadlines=lg.deadlines, arrivals=lg.arrivals,
                              duration_s=lg.duration_s)
    out["real_clock"] = dict(
        requests=len(requests), rate_per_s=OBS_RATE,
        deadline_s=OBS_DEADLINE_S, wall_s=wall, duration_s=lg.duration_s,
        goodput=report.goodput, completed=report.completed,
        **_quantiles(report), throughput_rps=report.throughput_rps,
        tokens_per_s=report.tokens_per_s, prefill_chunks=chunks,
        decode_steps=steps, scheduler_steps=lg.steps, launches=launches,
        expected_norm_launches=norm_launch_gate(
            engine, launches, chunks, steps, "obs real clock"),
        nvidia_smi=smi)
    log("phase3-serving-obs-real-clock", **out["real_clock"])

    out["cost"] = obs_costs(engine, sv, out["inert"], smi)
    log("phase3-serving-obs-cost", **out["cost"])

    tmp = tempfile.mkdtemp(prefix="obs_profile_")
    try:
        prof = {}
        for name, on in (("telemetry_on", True), ("telemetry_off", False)):
            logdir = os.path.join(tmp, name)
            os.makedirs(logdir)
            prof[name] = _profiled_decode_steps(engine, sv, on, logdir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if prof["telemetry_on"]["d2h_copies"] != prof["telemetry_off"]["d2h_copies"]:
        raise AssertionError(f"obs profiler: device-to-host copies {prof}")
    out["profiler"] = dict(
        prof, decode_steps=3,
        norm_launches_per_step=2 * model.config.num_hidden_layers + 1)
    log("phase3-serving-obs-profiler", **out["profiler"])
    return out


# ---------------------------------------------------------------------------
# the weight lifecycle at llama-1b: checkpoints, hot reload, shadow A/B, a
# fleet of replicas and rolling reloads (host layers over the serving path)
# ---------------------------------------------------------------------------

RELOAD_BOOT, RELOAD_NEW, RELOAD_BAD = 100, 200, 300   # checkpoint steps
RELOAD_PUBLISH_AT = 2      # traffic step at which step 200 is published
RELOAD_WAIT_AT = 10        # ...and from which the writer is joined
FLEET_KILL = ("r0", 6)     # fleet: KillReplica's replica and loadgen step
FLEET_WEDGE = ("r1", 14)   # fleet: WedgeReplica's replica and loadgen step


def perturbed(state, seed: int, device) -> "OrderedDict":
    """A candidate: ``state`` (a ``state_dict``) with every projection
    moved by half its init scale times seeded normal noise, in its own
    dtype; the other tensors shared by reference."""
    import torch
    from collections import OrderedDict

    gen = torch.Generator(device=device).manual_seed(seed)
    out = OrderedDict()
    for name, t in state.items():
        if name.endswith("_proj.weight"):
            noise = torch.randn(t.shape, generator=gen, device=t.device)
            t = (t.float() + noise * (0.5 / t.shape[1] ** 0.5)).to(t.dtype)
        out[name] = t
    return out


def tiny_cpu_llama(vocab: int):
    """The CPU dry run's model: the card's vocabulary and context, 2
    layers of width 64 (the fleet and rollout decisions depend on the
    requests and the virtual clock, not on the logits)."""
    import torch
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=2048)
    return LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def serve_hooked(engine, requests, sv, hook, *, label, setup=None,
                 **sched_kw) -> dict:
    """:func:`serve_logged` with ``setup(sched)`` before the first step
    and ``hook(i, sched)`` after each scheduler step ``i`` (all requests
    submitted up front): the kernel counts set to 0 just before, chunks
    and streams logged, the norm-launch gate held, every stream checked
    for length and range."""
    import torch
    from apex_tpu_torch.ops import _dispatch

    sched = sv.ContinuousBatchingScheduler(engine, **sched_kw)
    if setup is not None:
        setup(sched)
    chunks0, steps0 = engine.prefill_chunks, engine.decode_steps
    _dispatch.reset_launches()
    with ChunkLog(engine) as chunk_log, \
            StreamLog(engine, sched, requests) as stream_log:
        t0 = time.perf_counter()
        for r in requests:
            sched.submit(r)
        i = 0
        while sched.queue_depth or sched.active_count:
            sched.step()
            hook(i, sched)
            i += 1
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    chunks = engine.prefill_chunks - chunks0
    steps = engine.decode_steps - steps0
    results = sched.results
    vocab = engine.model.config.vocab_size
    for r in requests:
        toks = results[r.rid].tokens
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < vocab for t in toks):
            raise AssertionError(f"{label} {r.rid}: bad stream {toks}")
    return dict(sched=sched, results=results, chunk_log=chunk_log,
                stream_log=stream_log,
                streams={k: v.tokens for k, v in results.items()},
                summary=dict(wall_s=wall, prefill_chunks=chunks,
                             decode_steps=steps, scheduler_steps=i,
                             launches=launches,
                             expected_norm_launches=norm_launch_gate(
                                 engine, launches, chunks, steps, label)))


class Events:
    """A capture sink on the port's event stream while entered."""

    def __enter__(self):
        from apex_tpu_torch import _logging

        self.events, self._log = [], _logging
        _logging.add_event_sink(self.events.append)
        return self

    def __exit__(self, *exc):
        self._log.remove_event_sink(self.events.append)

    def of(self, kind) -> list:
        return [e for e in self.events if e["event"] == kind]


def _probe_logits(engine, prompt):
    """The probe prompt's next-token logits on a reset engine."""
    engine.reset()
    logits = engine.prefill(0, prompt).clone()
    engine.reset()
    return logits


def _cache_ptrs(engine) -> tuple:
    cache = engine.cache
    return tuple(getattr(cache, n).data_ptr() for n in (
        "k", "v", "lengths", "tables") if getattr(cache, n, None) is not None)


def reload_checks(model, requests, sv, device, root, **engine_kw) -> dict:
    """Phase ``phase3-serving-reload``: the checkpoint layer and hot reload
    at full width, under the 12-request workload.

    1. Boot: ``save_checkpoint`` of the weights at step 100, then
       ``load_serving_params`` onto the card (bit for bit the saved
       weights), the engine serving them; the save and restore walls, the
       restore split into read + CRC (a restore into CPU tensors) and
       host-to-device.
    2. Swap under traffic: while the workload runs, an
       ``AsyncCheckpointer`` publishes the step-200 candidate at step 2
       and a ``HotReloader`` polls it every step (joining the writer from
       step 10 on), swapping it in at a step boundary.  No stream is
       dropped; every ``weights_step`` after the swap is 200; the
       requests admitted after it equal a fresh engine on step 200 serving
       each alone (:func:`compare_streams`); a paged engine (1025 blocks)
       given the same swap at the same step serves the same streams bit
       for bit; the cache's storage is where it was; the norm launches are
       ``2L + 1`` a model call.
    3. A step-300 candidate with one byte of ``data.bin`` flipped is
       refused, and the probe's logits are the pre-attempt ones bit for
       bit; after a rollback they are those before the swap.
    4. The prefix cache: a swap's version bump makes the next admission of
       a cached prompt miss.
    5. A ``CrashCheckpointWriter`` kills a save: no watcher selects it.
    Returns the record and the live objects the later phases use."""
    import shutil
    import torch
    from collections import OrderedDict
    from apex_tpu_torch import resilience as rz
    from apex_tpu_torch.resilience import fault_injection as fi

    t_phase = time.perf_counter()
    boot = OrderedDict(model.state_dict())
    like = {"params": boot}
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rz.save_checkpoint(root, RELOAD_BOOT, {"params": boot})
    out["save_s"] = time.perf_counter() - t0
    # the boot restore into CPU tensors (read + CRC), then the engine's
    # swap copies them onto the card (host-to-device)
    cpu_like = {"params": OrderedDict(
        (k, torch.empty(v.shape, dtype=v.dtype)) for k, v in boot.items())}
    t0 = time.perf_counter()
    restored, step = sv.load_serving_params(root, cpu_like,
                                            params_key="params",
                                            step=RELOAD_BOOT)
    out["restore_read_crc_s"] = time.perf_counter() - t0
    out["checkpoint_bytes"] = sum(t.nbytes for t in restored.values())
    engine = sv.DecodeEngine(model, device=device, **engine_kw)
    t0 = time.perf_counter()
    engine.swap_params(restored)
    torch.cuda.synchronize()
    out["restore_h2d_s"] = time.perf_counter() - t0
    out["restore_s"] = out["restore_read_crc_s"] + out["restore_h2d_s"]
    restored = engine.params
    del cpu_like
    if step != RELOAD_BOOT or any(not torch.equal(restored[k], boot[k])
                                  for k in boot):
        raise AssertionError("the restored boot weights differ from the "
                             "saved ones")
    ptrs = _cache_ptrs(engine)
    probe = max(requests, key=lambda r: len(r.prompt)).prompt
    logits_boot = _probe_logits(engine, probe)

    cand = perturbed(boot, RELOAD_NEW, device)
    ac = rz.AsyncCheckpointer(rz.CheckpointManager(root, keep=3))
    state = {}

    def setup(sched):
        state["rl"] = sv.HotReloader(
            sched, root, like=like, params_key="params",
            watcher=sv.WeightWatcher(root, checkpointer=ac),
            current_step=RELOAD_BOOT)

    def hook(i, sched):
        rl = state["rl"]
        if i == RELOAD_PUBLISH_AT:
            state["future"] = ac.save(RELOAD_NEW, {"params": cand})
        if "swap" in state or "future" not in state:
            return
        if i >= RELOAD_WAIT_AT:
            ac.wait()
        got = rl.maybe_reload()
        if got is not None:
            if not got.ok:
                raise AssertionError(f"reload refused: {got.reason}")
            state["swap"] = (i, got)

    torch.cuda.reset_peak_memory_stats()
    with Events() as ev:
        dense = serve_hooked(engine, requests, sv, hook, setup=setup,
                             label="reload dense")
    peak = torch.cuda.max_memory_allocated()
    if "swap" not in state:
        raise AssertionError("reload: the candidate was never swapped in")
    swap_at, swap = state["swap"]
    rl, fut = state["rl"], state["future"]
    if fut.error is not None or _cache_ptrs(engine) != ptrs:
        raise AssertionError(f"reload: writer {fut.error}, cache moved")
    # every weights_step after the swap is 200
    swapped_i = next(i for i, e in enumerate(ev.events)
                     if e["event"] == "serving_weights_swapped")
    later = {e.get("weights_step") for e in ev.events[swapped_i:]
             if "weights_step" in e}
    if later != {RELOAD_NEW}:
        raise AssertionError(f"weights_step after the swap: {later}")
    admitted_after = [e["rid"] for e in ev.events[swapped_i:]
                      if e["event"] == "serving_request_admitted"]
    if not admitted_after:
        raise AssertionError("no request was admitted after the swap")
    # those requests held to a fresh engine booted on step 200, alone
    fresh = sv.DecodeEngine(model, device=device, **engine_kw)
    fresh.swap_params(engine.params)
    alone = {}
    for r in requests:
        if r.rid in admitted_after:
            one = serve_logged(fresh, [r], sv, label=f"fresh {r.rid}")
            alone.setdefault("streams", {}).update(one["streams"])
            merged = alone.setdefault("stream_log", StreamLog(None, None, []))
            merged.logits.update(one["stream_log"].logits)
            merged.x.update(one["stream_log"].x)
    after = dict(streams={k: dense["streams"][k] for k in admitted_after},
                 stream_log=dense["stream_log"])
    fresh_check = compare_streams(model, alone, after, "reload fresh")
    del fresh
    # paged: the same swap at the same step, bit for bit
    paged_eng = sv.DecodeEngine(model, device=device, paged=sv.PagedCacheConfig(
        block_size=16), **engine_kw)
    paged_eng.swap_params(restored)
    new_params = engine.params

    def paged_hook(i, sched):
        if i == swap_at:
            sched.swap_weights(new_params, step=RELOAD_NEW)

    paged = serve_hooked(paged_eng, requests, sv, paged_hook,
                         label="reload paged")
    if paged["streams"] != dense["streams"]:
        raise AssertionError("paged streams across the swap differ from "
                             "dense")
    num_blocks = paged_eng.block_pool.num_blocks
    del paged_eng
    del cand
    logits_new = _probe_logits(engine, probe)
    # a corrupt candidate: refused, the served weights untouched
    bad = perturbed(boot, RELOAD_BAD, device)
    t0 = time.perf_counter()
    rz.save_checkpoint(root, RELOAD_BAD, {"params": bad})
    save_bad_s = time.perf_counter() - t0
    fi.corrupt_checkpoint(os.path.join(root, f"step_{RELOAD_BAD:010d}"),
                          seed=0, nbytes=1)
    refused = rl.reload(step=RELOAD_BAD)
    if refused.ok or not torch.equal(_probe_logits(engine, probe),
                                     logits_new):
        raise AssertionError("the corrupt candidate changed the served "
                             "weights")
    rb = rl.rollback()
    if not (rb.ok and rb.step == RELOAD_BOOT and torch.equal(
            _probe_logits(engine, probe), logits_boot)):
        raise AssertionError("the rollback did not restore the boot logits")
    rl.rollback()                               # back on step 200
    # the prefix cache: a version bump makes the next admission miss
    sched = sv.ContinuousBatchingScheduler(
        engine, prefix_caching=sv.PrefixCacheConfig())
    p = sv.Request("pc0", probe[:512], max_new_tokens=2)
    hits = []
    for i, swap_between in enumerate((False, True)):
        for j in range(2):
            if swap_between and j == 0:
                sched.swap_weights(sched.swap_weights(engine.params,
                                                      step=RELOAD_NEW),
                                   step=RELOAD_NEW)
            sched.submit(sv.Request(f"pc{i}{j}", p.prompt, max_new_tokens=2))
            before = sched.prefix_hits
            sched.run()
            hits.append(sched.prefix_hits - before)
    sched.close()
    if hits != [0, 1, 0, 1]:
        raise AssertionError(f"prefix hits around a swap: {hits}")
    # a writer crash: no watcher ever selects the partial step
    crash = fi.CrashCheckpointWriter(after_records=3)
    ac_crash = rz.AsyncCheckpointer(rz.CheckpointManager(root, keep=3),
                                    progress_hook=crash)
    fut_crash = ac_crash.save(400, {"params": boot})
    fut_crash.join()
    partial = [n for n in os.listdir(root) if n.startswith("tmp_")]
    walk = sv.WeightWatcher(root).poll()
    if not (isinstance(fut_crash.error, rz.SimulatedWriterCrash) and partial
            and walk != 400 and sv.WeightWatcher(
                root, checkpointer=ac_crash).poll() is None):
        raise AssertionError(f"writer crash: {fut_crash.error}, {partial}, "
                             f"{walk}")
    for n in partial:
        shutil.rmtree(os.path.join(root, n))
    if _cache_ptrs(engine) != ptrs:
        raise AssertionError("a swap moved the cache")
    out.update(
        requests=len(requests), swap_at_step=swap_at,
        swap_s=swap.swap_s, swap_restore_s=swap.restore_s,
        swap_validate_s=swap.validate_s,
        async_snapshot_s=fut.snapshot_s, async_write_s=fut.write_s,
        save_corrupt_candidate_s=save_bad_s, refused=refused.reason[:200],
        dropped=len(requests) - len(dense["results"]),
        admitted_after_swap=admitted_after, fresh_engine=fresh_check,
        paged_num_blocks=num_blocks, paged_streams_identical=True,
        rollback_swap_s=rb.swap_s, prefix_hits_around_swap=hits,
        writer_crash_partial_dirs=len(partial), watcher_walk=walk,
        cache_ptrs_unchanged=True, peak_mem_bytes=peak,
        dense=dense["summary"], paged=paged["summary"],
        launches={k: dense["summary"]["launches"][k]
                  + paged["summary"]["launches"][k]
                  for k in dense["summary"]["launches"]},
        wall_s=time.perf_counter() - t_phase)
    return out, dict(engine=engine, boot=boot, new_params=new_params,
                     bad=bad)


def shadow_run(model, new_params, bad_params, sv, device, requests,
               **engine_kw) -> dict:
    """One shadow A/B run on a ``VirtualClock``: an incumbent engine on
    ``new_params``, a shadow one on ``bad_params`` (both over ``model``),
    ``ABConfig(fraction=0.5)``, the requests in bursts of 4 a second;
    then the incumbent alone on the same workload."""
    from apex_tpu_torch import obs

    def engine(params):
        e = sv.DecodeEngine(model, device=device, **engine_kw)
        e.swap_params(params)
        return e

    wl = sv.make_workload([r.prompt for r in requests],
                          sv.burst_arrivals(len(requests), burst=4,
                                            period_s=1.0),
                          max_new_tokens=requests[0].max_new_tokens,
                          rid_prefix="ab")
    from apex_tpu_torch.ops import _dispatch

    inc, shadow = engine(new_params), engine(bad_params)
    clk = sv.VirtualClock()
    ab = sv.ShadowABScheduler(
        sv.ContinuousBatchingScheduler(inc, clock=clk),
        sv.ContinuousBatchingScheduler(shadow, clock=clk),
        sv.ABConfig(fraction=0.5))
    rec = obs.RequestTraceRecorder(clock=clk).install()
    _dispatch.reset_launches()
    try:
        out = sv.LoadGenerator(ab, wl, step_time_s=0.25).run()
    finally:
        rec.uninstall()
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    chunks = inc.prefill_chunks + shadow.prefill_chunks
    steps = inc.decode_steps + shadow.decode_steps
    gate = dict(prefill_chunks=chunks, decode_steps=steps, launches=launches,
                expected_norm_launches=norm_launch_gate(
                    inc, launches, chunks, steps, "shadow"))
    del shadow
    reports = ab.arm_reports(rec.records(), deadlines=out.deadlines,
                             arrivals=out.arrivals, duration_s=out.duration_s)
    inc.reset()
    alone = sv.LoadGenerator(sv.ContinuousBatchingScheduler(
        inc, clock=sv.VirtualClock()), wl, step_time_s=0.25).run()
    return dict(ab=ab, out=out, alone=alone, reports=reports, workload=wl,
                gate=gate)


def shadow_checks(model, new_params, bad_params, sv, device, requests,
                  **engine_kw) -> dict:
    """Phase ``phase3-serving-shadow``: users' results equal the
    incumbent serving alone bit for bit, the mirrored rids are
    ``assign_arm``'s and the CPU dry run's, and both arm reports."""
    import torch

    t0 = time.perf_counter()
    card = shadow_run(model, new_params, bad_params, sv, device, requests,
                      **engine_kw)
    wall = time.perf_counter() - t0
    ab, out = card["ab"], card["out"]
    users = {k: v.tokens for k, v in out.results.items()}
    if users != {k: v.tokens for k, v in card["alone"].results.items()}:
        raise AssertionError("shadow: users' streams differ from the "
                             "incumbent alone")
    want = [r.rid for r in card["workload"].requests
            if sv.assign_arm(r.rid, fraction=0.5, seed=0)]
    tiny = tiny_cpu_llama(model.config.vocab_size)
    cpu = shadow_run(tiny, tiny.state_dict(), tiny.state_dict(), sv, "cpu",
                     requests, **engine_kw)
    if not (ab.mirrored_rids == want == cpu["ab"].mirrored_rids
            and ab.mirror_shed == 0):
        raise AssertionError(f"shadow mirror {ab.mirrored_rids}, "
                             f"assign_arm {want}, CPU "
                             f"{cpu['ab'].mirrored_rids}")
    differ = [r for r in ab.mirrored_rids if out.results[r].tokens
              != ab.shadow.results["shadow:" + r].tokens]

    def summary(rep):
        return dict(offered=rep.offered, completed=rep.completed,
                    ttft_p95_s=rep.ttft.get("p95"),
                    tpot_p95_s=rep.tpot.get("p95"), goodput=rep.goodput)

    reports = {k: summary(v) for k, v in card["reports"].items()}
    gate = card["gate"]
    del card
    torch.cuda.empty_cache()
    return dict(requests=len(requests), mirrored=ab.mirrored_rids,
                mirrored_equal_assign_arm_and_cpu=True,
                users_equal_incumbent_alone=True,
                candidate_streams_differing=len(differ),
                arm_reports=reports, **gate, wall_s=wall)


def fleet_workload(vocab: int, sv, n: int = 24, new_tokens: int = 16):
    """The fleet's 24 greedy requests: prompts of 64-512 tokens from a
    seeded generator, 16 new tokens each, 8 arriving a second."""
    import torch

    rng = torch.Generator().manual_seed(18)
    lens = torch.randint(64, 513, (n,), generator=rng).tolist()
    prompts = [torch.randint(0, vocab, (k,), generator=rng).tolist()
               for k in lens]
    return sv.make_workload(prompts, sv.uniform_arrivals(n, 8.0),
                            max_new_tokens=new_tokens, deadline_s=60.0,
                            rid_prefix="f")


def fleet_run(model, sv, device, wl, *, log_streams, **engine_kw) -> dict:
    """Three dense replicas over ``model`` (its tensors shared), on a
    ``VirtualClock`` stepped 0.25 s: the workload with ``KillReplica`` and
    ``WedgeReplica`` (:data:`FLEET_KILL`, :data:`FLEET_WEDGE`).  Returns
    the virtual numbers, and with ``log_streams`` each replica's
    :class:`StreamLog`, the router and the launch accounting."""
    import contextlib
    import torch
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.resilience import fault_injection as fi

    engines = [sv.DecodeEngine(model, device=device, **engine_kw)
               for _ in range(3)]
    clk = sv.VirtualClock()
    scheds = {f"r{i}": sv.ContinuousBatchingScheduler(
        e, clock=clk, log_interval=10 ** 9) for i, e in enumerate(engines)}
    router = sv.FleetRouter(scheds, config=sv.FleetConfig(
        suspect_after_s=0.5, dead_after_s=1.1))
    faults = [fi.KillReplica(FLEET_KILL[0], at_step=FLEET_KILL[1]),
              fi.WedgeReplica(FLEET_WEDGE[0], at_step=FLEET_WEDGE[1])]
    _dispatch.reset_launches()
    with Events() as ev, contextlib.ExitStack() as stack:
        logs = ({n: stack.enter_context(StreamLog(s.engine, s, wl.requests))
                 for n, s in scheds.items()} if log_streams else None)
        t0 = time.perf_counter()
        out = sv.LoadGenerator(router, wl, step_time_s=0.25,
                               step_hook=sv.chain_hooks(*faults)).run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not all(f.killed if hasattr(f, "killed") else f.wedged
               for f in faults):
        raise AssertionError("fleet: a fault did not fire")
    routed = {}
    for e in ev.of("serving_fleet_routed"):
        routed[e["replica"]] = routed.get(e["replica"], 0) + 1
    virtual = dict(
        routed=dict(sorted(routed.items())),
        transitions=[(e["replica"], e["state"]) for e in ev.of(
            "serving_fleet_replica_state")],
        failovers=[(e["rid"], e["mode"]) for e in ev.of(
            "serving_fleet_failover")],
        resumes=[(e["rid"], e["replica"], e["mode"]) for e in ev.of(
            "serving_fleet_resumed")],
        fleet_stats=router.fleet_stats, completed=out.completed,
        rejected=out.rejected, goodput=out.goodput, steps=out.steps,
        finish=sorted({r.finish_reason for r in out.results.values()}))
    return dict(virtual=virtual, logs=logs, router=router, out=out,
                engines=engines, wall_s=wall, events=ev,
                launches={k.name: k.launches for k in _dispatch.KERNELS})


def fleet_checks(model, sv, device, **engine_kw) -> dict:
    """Phase ``phase3-serving-fleet``: the fleet run at full width.  Its
    virtual numbers (routed per replica, transitions, failovers, resumes,
    shed, goodput) equal the CPU dry run's on a 2-layer model; every
    served stream, each evacuated one included (a captured one merged
    from its donor's and its adopter's logs), is held to the uninterrupted
    single-engine run by :func:`compare_streams`; nothing admitted is
    dropped; the norm launches are ``2L + 1`` a model call."""
    import torch

    wl = fleet_workload(model.config.vocab_size, sv)
    t0 = time.perf_counter()
    run = fleet_run(model, sv, device, wl, log_streams=True, **engine_kw)
    cpu = fleet_run(tiny_cpu_llama(model.config.vocab_size), sv, "cpu", wl,
                    log_streams=False, **engine_kw)
    if run["virtual"] != cpu["virtual"]:
        raise AssertionError(f"fleet virtual numbers {run['virtual']} differ "
                             f"from the CPU's {cpu['virtual']}")
    out = run["out"]
    if out.rejected or out.completed != len(wl.requests):
        raise AssertionError(f"fleet dropped work: {out.rejected}, "
                             f"{out.completed}")
    router, logs = run["router"], run["logs"]
    resumes = run["events"].of("serving_fleet_resumed")
    merged = StreamLog(None, None, [])
    for r in wl.requests:
        cur = router.placement_of(r.rid)
        lg, xs = list(logs[cur].logits[r.rid]), list(logs[cur].x[r.rid])
        for e in reversed([e for e in resumes if e["rid"] == r.rid]):
            if e["mode"] != "capture-resume":
                break
            donor = logs[e["from_replica"]]
            lg, xs = donor.logits[r.rid] + lg, donor.x[r.rid] + xs
        merged.logits[r.rid], merged.x[r.rid] = lg, xs
    engines, fleet_wall = run["engines"], run["wall_s"]
    chunks = sum(e.prefill_chunks for e in engines)
    steps = sum(e.decode_steps for e in engines)
    launches = run["launches"]
    expected = norm_launch_gate(engines[0], launches, chunks, steps, "fleet")
    del run, logs
    for e in engines:
        e.reset()
    del engines
    torch.cuda.empty_cache()
    ref_engine = sv.DecodeEngine(model, device=device, **engine_kw)
    ref = serve_logged(ref_engine, wl.requests, sv, label="fleet reference")
    del ref_engine
    held = compare_streams(model, ref, dict(
        streams={k: v.tokens for k, v in out.results.items()},
        stream_log=merged), "fleet")
    return dict(requests=len(wl.requests), replicas=3, kill=FLEET_KILL,
                wedge=FLEET_WEDGE, **cpu["virtual"],
                virtual_equal_cpu=True, wall_s=time.perf_counter() - t0,
                fleet_run_wall_s=fleet_wall, prefill_chunks=chunks,
                decode_steps=steps, launches=launches,
                expected_norm_launches=expected, streams=held)


def rollout_workload(vocab: int, sv, *, seed: int, n: int = 12,
                     deadline_s: float = 60.0):
    """A rollout window's traffic: 12 greedy requests of 64-256 prompt
    tokens, 8 new tokens, 8 arriving a second."""
    import torch

    rng = torch.Generator().manual_seed(seed)
    lens = torch.randint(64, 257, (n,), generator=rng).tolist()
    prompts = [torch.randint(0, vocab, (k,), generator=rng).tolist()
               for k in lens]
    return sv.make_workload(prompts, sv.uniform_arrivals(n, 8.0),
                            max_new_tokens=8, deadline_s=deadline_s,
                            rid_prefix=f"ro{seed}-")


def rollout_suite(model, boot, root, sv, device, **engine_kw) -> dict:
    """The four rollouts over three replicas of ``model`` (booted on
    ``boot``, step 100; step 200 committed under ``root``), each a
    controller over one router with a ``CanaryGate`` and waves of one:

    - ``good``: to step 200, promoted;
    - ``regressing``: ``RegressingWeights`` published at step 300 and its
      hook stalling whoever serves it: the canary fails its gate, the
      rollout halts and rolls back, every replica on 200 again;
    - ``corrupt``: to step 300 with ``CorruptCandidateMidRollout`` at
      loadgen step 6, after the canary's restore: the next wave's restore
      is refused and that replica stays on its old weights;
    - ``kill_canary``: to step 100 (the boot weights, on disk since the
      reload phase), ``KillCanary`` two window steps in: the rollout
      halts, the canary's streams replay.

    Every swap happens on an engine with no stream in its slots (no
    request's tokens come from two steps).  Returns each rollout's
    virtual numbers and walls."""
    from apex_tpu_torch import obs
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.resilience import fault_injection as fi

    vocab = model.config.vocab_size
    engines = [sv.DecodeEngine(model, device=device, **engine_kw)
               for _ in range(3)]
    _dispatch.reset_launches()
    own = engines[0].params
    swaps = []
    for e in engines:
        inner = e.swap_params

        def guarded(params, e=e, inner=inner):
            if e.free_slots() != list(range(e.slots)):
                raise AssertionError("a swap with streams in the slots")
            swaps.append(1)
            return inner(params)
        e.swap_params = guarded
    clk = sv.VirtualClock()
    router = sv.FleetRouter({f"r{i}": sv.ContinuousBatchingScheduler(
        e, clock=clk, log_interval=10 ** 9) for i, e in enumerate(engines)})
    reloaders = {n: sv.HotReloader(router.replica(n), root,
                                   like={"params": boot}, params_key="params",
                                   current_step=RELOAD_BOOT)
                 for n in router.replica_names}
    results = {}

    def rollout(name, target, gate_kw, cfg_kw, wl, faults=()):
        t0 = time.perf_counter()
        with Events() as ev, obs.recording_requests(clock=clk) as rec:
            ctl = sv.RollingReloadController(
                router, reloaders, recorder=rec, config=sv.RolloutConfig(
                    step=target, health_window_steps=1,
                    gate=sv.CanaryGate(**gate_kw), **cfg_kw))
            hooks = [f(ctl) for f in faults]
            ctl.start()
            out = sv.LoadGenerator(router, wl, step_time_s=0.25,
                                   step_hook=sv.chain_hooks(ctl, *hooks)).run()
            steps = 0
            while not ctl.done and steps < 300:
                router.step()
                clk.advance(0.25)
                ctl.advance()
                for h in hooks:
                    h(10_000 + steps, router)
                steps += 1
        if not ctl.done:
            raise AssertionError(f"rollout {name} never terminal")
        for req in wl.requests:
            res = out.results.get(req.rid)
            if req.rid not in out.rejected and (
                    res is None or res.finish_reason not in sv.SERVED_REASONS):
                raise AssertionError(f"rollout {name}: {req.rid} dropped")
        v = ctl.verdict
        results[name] = dict(
            state=ctl.state, abort=(ctl.abort_reason or "").split(": ")[0],
            upgraded=ctl.upgraded,
            verdict=None if v is None else dict(
                passed=v.passed, canary=v.canary, baseline=v.baseline),
            weights_steps=router.weights_steps, fleet_stats=router.fleet_stats,
            completed=out.completed, goodput=out.goodput,
            rolled_back=[e["names"] for e in ev.of(
                "serving_rollout_rolled_back")],
            stalls=[getattr(h, "stalls", None) for h in hooks])
        results[name + "_walls"] = dict(
            wall_s=time.perf_counter() - t0,
            restore_s=[round(e["duration_s"], 3) for e in ev.of(
                "serving_weights_loaded")],
            swap_s=dict(ctl.swap_pauses))

    gate = dict(ttft_ratio=3.0, completion_margin=0.5)
    rollout("good", RELOAD_NEW, gate, dict(canary_fraction=0.34,
                                           canary_window_steps=10),
            rollout_workload(vocab, sv, seed=1))
    resident = {n: sum(t.nbytes for k, t in router.replica(n).engine.params
                       .items() if t.data_ptr() != own[k].data_ptr())
                for n in router.replica_names}
    fi.RegressingWeights.publish(root, boot, RELOAD_BAD)
    rollout("regressing", RELOAD_BAD, {}, dict(canary_fraction=0.5,
                                               canary_window_steps=12),
            rollout_workload(vocab, sv, seed=2, deadline_s=5.0),
            faults=[lambda c: fi.RegressingWeights(c, slow_every=2)])
    rollout("corrupt", RELOAD_BAD, gate, dict(canary_fraction=0.34,
                                              canary_window_steps=10),
            rollout_workload(vocab, sv, seed=3),
            faults=[lambda c: fi.CorruptCandidateMidRollout(
                root, RELOAD_BAD, at_step=6)])
    rollout("kill_canary", RELOAD_BOOT, dict(completion_margin=0.5),
            dict(canary_fraction=0.5, canary_window_steps=10),
            rollout_workload(vocab, sv, seed=4),
            faults=[lambda c: fi.KillCanary(c, after_window_steps=2)])
    want = {"good": ("promoted", ""),
            "regressing": ("aborted", "canary_failed"),
            "corrupt": ("aborted", "reload_refused:r1"),
            "kill_canary": ("aborted", "replica_died:r0")}
    for name, (st, reason) in want.items():
        if (results[name]["state"], results[name]["abort"]) != (st, reason):
            raise AssertionError(f"rollout {name}: {results[name]}")
    if (results["good"]["weights_steps"] != {n: RELOAD_NEW for n in
                                             ("r0", "r1", "r2")}
            or results["regressing"]["weights_steps"] != {
                n: RELOAD_NEW for n in ("r0", "r1", "r2")}
            or results["corrupt"]["weights_steps"]["r1"] != RELOAD_NEW):
        raise AssertionError(f"rollout weights steps: {results}")
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    chunks = sum(e.prefill_chunks for e in engines)
    steps = sum(e.decode_steps for e in engines)
    results["launch_gate"] = dict(
        prefill_chunks=chunks, decode_steps=steps, launches=launches,
        expected_norm_launches=norm_launch_gate(
            engines[0], launches, chunks, steps, "rollout"))
    results["swaps"] = len(swaps)
    results["resident_weight_bytes_after_good"] = resident
    results["kv_bytes_per_replica"] = int(sv.kv_bytes_per_token(
        engines[0].cache) * engines[0].slots * engines[0].max_len)
    return results


def rollout_checks(model, boot, root, sv, device, **engine_kw) -> dict:
    """Phase ``phase3-serving-rollout``: :func:`rollout_suite` on the card
    and, on a 2-layer model, on the CPU; the verdicts and virtual numbers
    equal."""
    import tempfile
    import torch
    from apex_tpu_torch import resilience as rz

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = rollout_suite(model, boot, root, sv, device, **engine_kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    tiny = tiny_cpu_llama(model.config.vocab_size)
    tiny_boot = tiny.state_dict()
    with tempfile.TemporaryDirectory(dir=ROOT) as cpu_root:
        rz.save_checkpoint(cpu_root, RELOAD_BOOT, {"params": tiny_boot})
        rz.save_checkpoint(cpu_root, RELOAD_NEW, {"params": perturbed(
            tiny_boot, RELOAD_NEW, "cpu")})
        cpu = rollout_suite(tiny, tiny_boot, cpu_root, sv, "cpu", **engine_kw)
    names = ("good", "regressing", "corrupt", "kill_canary")
    for n in names:             # (as JSON: an empty arm's p95 is NaN)
        if json.dumps(card[n], sort_keys=True) != json.dumps(cpu[n],
                                                              sort_keys=True):
            raise AssertionError(f"rollout {n}: card {card[n]} vs CPU {cpu[n]}")
    return dict(**{n: card[n] for n in names},
                walls={n: card[n + "_walls"] for n in names},
                verdicts_equal_cpu=True, swaps=card["swaps"],
                **card["launch_gate"],
                resident_weight_bytes_after_good=card[
                    "resident_weight_bytes_after_good"],
                kv_bytes_per_replica=card["kv_bytes_per_replica"],
                peak_mem_bytes=peak, wall_s=wall)


def int8_reference(model, probe, sv, device, **engine_kw) -> tuple:
    """What the int8 phase compares with, taken while the bf16 model is
    alive: ``probe``'s greedy stream on the bf16 engine, cached in its own
    chunks, with each step's logits; the model's and its cache's bytes.
    Returns ``(quantize_params(model), reference)``."""
    engine = sv.DecodeEngine(model, device=device, **engine_kw)
    n, step = len(probe.prompt), engine.prefill_len
    own = [min(step, n - i) for i in range(0, n, step)]
    stream, logits, _ = serve_in_chunks(engine, probe, 0, own)
    ref = dict(stream=stream, logits=logits.float().cpu(), chunks=own,
               param_bytes=sv.param_bytes(model),
               kv_bytes_per_token=sv.kv_bytes_per_token(engine.cache))
    engine.reset()
    return sv.quantize_params(model), ref


def int8_checks(qmodel, requests, ref, sv, device, **engine_kw) -> dict:
    """``quant=QuantConfig(weights=True, kv=True)`` serves the requests
    (the norm-launch gate; peak memory with the bf16 model freed).  On the
    longest request, fed the bf16 engine's stream in the same chunks (the
    JAX tests' teacher forcing): max |logit - bf16 logit| < 0.5, the JAX
    package's bar, and the picks agree with the bf16 stream at >= 0.9 of
    the positions whose bf16 top-2 margin exceeds 0.1 (random weights put
    many positions near a tie); the agreement over every position is
    reported beside it."""
    import torch

    at_start = "not measured"
    gc.collect()                # no engine of the bf16 model left alive
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()
        if at_start >= ref["param_bytes"]:
            raise AssertionError(f"{at_start} bytes allocated before the int8 "
                                 f"engine: the bf16 model is still resident")
    engine = sv.DecodeEngine(qmodel, quant=sv.QuantConfig(weights=True,
                                                          kv=True),
                             device=device, **engine_kw)
    if engine.model is not qmodel:
        raise AssertionError("the engine quantized a quantized model again")
    run = serve_logged(engine, requests, sv, label="int8")
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else "not measured")
    probe = max(requests, key=lambda r: len(r.prompt))
    picks, logits, _ = serve_in_chunks(engine, probe, 0, ref["chunks"],
                                       forced=ref["stream"])
    ref_logits = ref["logits"]
    err = float((logits.float().cpu() - ref_logits).abs().max())
    top = ref_logits.topk(2).values
    clear = ((top[:, 0] - top[:, 1]) > 0.1).tolist()
    agree = [p == t for p, t in zip(picks, ref["stream"])]
    clear_agree = sum(a for a, c in zip(agree, clear) if c) / max(sum(clear), 1)
    if not err < 0.5:
        raise AssertionError(f"int8: max |logit error| {err} >= 0.5")
    if clear_agree < 0.9:
        raise AssertionError(f"int8: agreement {clear_agree} < 0.9 at the "
                             f"{sum(clear)} positions with a bf16 top-2 "
                             f"margin over 0.1")
    return dict(
        param_bytes_bf16=ref["param_bytes"],
        param_bytes_int8=sv.param_bytes(qmodel),
        kv_bytes_per_token_bf16=ref["kv_bytes_per_token"],
        kv_bytes_per_token_int8=sv.kv_bytes_per_token(engine.cache),
        mem_at_start_bytes=at_start, peak_mem_bytes_bf16_model_freed=peak,
        **run["summary"],
        probe=probe.rid, max_abs_logit_err=err,
        agreement_margin_over_0_1=clear_agree,
        positions_margin_over_0_1=sum(clear),
        agreement_all_positions=sv.stream_agreement(ref["stream"], picks),
        bars="max |logit error| < 0.5; agreement >= 0.9 where the bf16 "
             "top-2 margin > 0.1")


def small_serving_forms_check(device) -> dict:
    """A small fp32 Llama, the same weights on the card and on the CPU,
    served in each new form: paged (``PagedCacheConfig(block_size=16)``),
    int8 (weights and KV, dense and paged) and prefix-cached (dense and
    paged), over six requests that share a 48-token prefix (the first
    served alone until its prompt is cached, so the other five hit);
    speculative (``SpeculationConfig(max_draft=8)``, dense and paged) over
    six quoted-context requests; and under ``SchedulingPolicy()`` (dense
    and paged) over the six shared-prefix requests, the last two at
    priority 5 (they preempt).  The streams must be equal and the
    first-token logits within 1e-4, and the counts (``spec_stats``,
    ``control_stats``, verifies, decode steps, chunks) equal; the
    int8 weights equal bit for bit (one quantization of the same fp32
    weights), and each int8 KV value within one quantization step of its
    row's scale of the CPU's: card and CPU compute K and V in another
    order, and an input that lies on a rounding boundary goes to the
    neighbouring code.  Where a code differs, the logits of the int8 forms
    move with it and are reported, not held to 1e-4."""
    import torch
    from apex_tpu_torch import serving as sv
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    models = {"cpu": LlamaForCausalLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))}
    models["cuda"] = LlamaForCausalLM(cfg, device=device)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    requests = prefix_requests(cfg.vocab_size, prefix_len=48, lo=5, hi=20,
                               n=6, new_tokens=8)
    # the last two at priority 5: with both slots decoding they preempt
    ranked = requests[:4] + [dataclasses.replace(r, priority=5)
                             for r in requests[4:]]
    quoted = quoted_requests(cfg.vocab_size, lo=16, hi=40, n=6, new_tokens=8)
    paged = sv.PagedCacheConfig(block_size=16)
    int8 = sv.QuantConfig(weights=True, kv=True)
    forms = dict(paged=dict(paged=paged), int8=dict(quant=int8),
                 int8_paged=dict(quant=int8, paged=paged),
                 prefix_dense=dict(prefix=sv.PrefixCacheConfig()),
                 prefix_paged=dict(paged=paged,
                                   prefix=sv.PrefixCacheConfig()),
                 spec=dict(sched=dict(speculation=sv.SpeculationConfig(
                     max_draft=8)), requests=quoted),
                 spec_paged=dict(paged=paged, sched=dict(
                     speculation=sv.SpeculationConfig(max_draft=8)),
                     requests=quoted),
                 policy=dict(sched=dict(policy=sv.SchedulingPolicy()),
                             requests=ranked),
                 policy_paged=dict(paged=paged, sched=dict(
                     policy=sv.SchedulingPolicy()), requests=ranked))
    out = {}
    for name, form in forms.items():
        prefix = form.pop("prefix", None)
        sched_kw = form.pop("sched", {})
        reqs = form.pop("requests", requests)
        runs, engines = {}, {}
        for dev in ("cpu", "cuda"):
            engines[dev] = sv.DecodeEngine(
                models[dev], slots=2, max_len=128, prefill_len=32,
                device="cpu" if dev == "cpu" else device, **form)
            runs[dev] = serve_logged(engines[dev], reqs, sv, prefix=prefix,
                                     first=1, label=f"small {name} {dev}",
                                     **sched_kw)
        if runs["cpu"]["streams"] != runs["cuda"]["streams"]:
            raise AssertionError(f"small {name}: streams differ card/CPU: "
                                 f"{runs['cuda']['streams']} vs "
                                 f"{runs['cpu']['streams']}")
        if prefix is not None and runs["cuda"]["sched"].stats()[
                "prefix_hits"] != len(requests) - 1:
            raise AssertionError(f"small {name}: "
                                 f"{runs['cuda']['sched'].stats()}")
        counts = {dev: {k: runs[dev]["summary"][k] for k in (
            "spec_stats", "control_stats", "verifies", "decode_steps",
            "prefill_chunks")} for dev in runs}
        if counts["cpu"] != counts["cuda"]:
            raise AssertionError(f"small {name}: card {counts['cuda']}, CPU "
                                 f"{counts['cpu']}")
        if "speculation" in sched_kw and not counts["cuda"]["verifies"]:
            raise AssertionError(f"small {name}: no verify ran")
        if "policy" in sched_kw and not counts["cuda"]["control_stats"][
                "preempted"]:
            raise AssertionError(f"small {name}: nothing was preempted")
        err = max(float((runs["cuda"]["stream_log"].logits[r][0].cpu()
                         - runs["cpu"]["stream_log"].logits[r][0]).abs().max())
                  for r in runs["cpu"]["streams"])
        row = dict(first_token_logit_max_abs_err=err, streams_identical=True,
                   **counts["cuda"])
        if "quant" in form:
            row.update(int8_card_vs_cpu(*(engines[d] for d in ("cuda", "cpu"))))
        if err > 1e-4 and not row.get("kv_codes_differing"):
            raise AssertionError(f"small {name}: first-token logits on the "
                                 f"card differ from the CPU by {err} (> 1e-4)")
        out[name] = row
    out["tolerance"] = ("first-token logits 1e-4; int8 weights bit for bit; "
                        "int8 KV one quantization step of the row's scale")
    log("phase3-serving-forms-reference", **out)
    return out


def int8_card_vs_cpu(card, cpu) -> dict:
    """The int8 weights of two engines bit for bit, and their int8 KV
    caches within one quantization step: codes at most 1 apart and each
    dequantized value within its row's scale of the other's."""
    import torch
    from apex_tpu_torch import serving as sv

    for (name, a), b in zip(card.model.state_dict().items(),
                            cpu.model.state_dict().values()):
        if a.dtype == torch.int8 and not torch.equal(a.cpu(), b):
            raise AssertionError(f"int8 weight {name} differs card/CPU")
    flips = 0
    for kind in ("k", "v"):
        qa, qb = getattr(card.cache, kind).cpu(), getattr(cpu.cache, kind)
        sa = getattr(card.cache, f"{kind}_scale").cpu()
        sb = getattr(cpu.cache, f"{kind}_scale")
        if isinstance(cpu.cache, sv.PagedKVCache):
            # the sink block takes dropped rows in any order: never read
            qa, qb, sa, sb = (t[:, :-1] for t in (qa, qb, sa, sb))
        codes = (qa.int() - qb.int()).abs()
        deq = (qa.float() * sa[..., None] - qb.float() * sb[..., None]).abs()
        # one step of the larger scale, and the scales' own difference
        # over the 127 codes
        step = (torch.maximum(sa, sb) + 127 * (sa - sb).abs())[..., None]
        if int(codes.max()) > 1 or bool((deq > step).any()):
            raise AssertionError(f"int8 {kind} cache card/CPU: codes up to "
                                 f"{int(codes.max())} apart")
        flips += int((codes > 0).sum())
    return dict(int8_weights_identical=True, kv_codes_differing=flips,
                kv_within_one_step=True)


def small_reference_check(device) -> dict:
    """A small fp32 Llama, same weights on the card and on the CPU: the
    first-token logits must agree within 1e-4 and the greedy streams be
    identical."""
    import torch
    from apex_tpu_torch import serving as sv
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu_model = LlamaForCausalLM(cfg, device=device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    kw = dict(slots=2, max_len=128, prefill_len=32)
    engines = {"cpu": sv.DecodeEngine(cpu_model, device="cpu", **kw),
               "cuda": sv.DecodeEngine(gpu_model, device=device, **kw)}
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist()
               for n in (5, 17, 40, 70)]
    first, streams = {}, {}
    for name, eng in engines.items():
        first[name] = []
        for p in prompts:
            first[name].append(eng.prefill(0, p).float().cpu())
            eng.release(0)
        sched = sv.ContinuousBatchingScheduler(eng)
        for i, p in enumerate(prompts):
            sched.submit(sv.Request(f"r{i}", p, max_new_tokens=8))
        streams[name] = {r: res.tokens for r, res in sched.run().items()}
    err = max(float((a - b).abs().max())
              for a, b in zip(first["cpu"], first["cuda"]))
    if err > 1e-4:
        raise AssertionError(f"small Llama: first-token logits on the card "
                             f"differ from the CPU by {err} (> 1e-4)")
    if streams["cpu"] != streams["cuda"]:
        raise AssertionError(f"small Llama: greedy streams differ: "
                             f"{streams['cpu']} vs {streams['cuda']}")
    out = dict(first_token_logit_max_abs_err=err, streams_identical=True,
               tolerance=1e-4)
    log("phase3-reference", **out)
    return out


def build_llama_1b(device, layers=None):
    """The ``llama-1b`` card (at ``layers`` layers if given), bf16, weights
    from a seeded generator on the card; returns ``(model, init_s)``."""
    import torch
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    cfg = LlamaConfig.llama_1b()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    gen = torch.Generator(device=device).manual_seed(0)
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device=device,
                             generator=gen)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _drop_side_stream_workspaces() -> None:
    """Free what the timing phases leave allocated: cuBLAS keeps a
    workspace for every stream it ran on (each CUDA graph above was
    captured on a side stream of its own), and a path's peak memory would
    count them.  The caller warms up after this, so that its measured run
    finds the allocator and the main stream's workspace ready."""
    import torch

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def llama_1b(device, model, init_s, keep=None) -> dict:
    """Serving ``model`` at full width: the FIFO scheduler over the dense
    ``DecodeEngine`` (12 requests; the longest again alone, two checks;
    a profile), then the same requests paged (:func:`paged_checks`), then
    the shared-prefix workload with and without prefix caching, paged and
    dense (:func:`prefix_checks`), speculation dense and paged
    (:func:`spec_checks`), the control plane (:func:`control_checks`), the
    observability layer on them (:func:`obs_checks`), failover
    (:func:`export_adopt_checks`) and the weight lifecycle
    (:func:`lifecycle_checks`).  Each run launches the norm kernel only,
    ``(2L + 1) x (chunks + steps + verifies)`` times.  ``keep`` (a dict)
    receives the dense run's streams and chunk logits, which the
    tensor-parallel phase holds its runs to."""
    import torch
    from apex_tpu_torch import serving as sv

    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    kw = dict(slots=8, max_len=2048, prefill_len=512)
    engine = sv.DecodeEngine(model, device=device, **kw)
    _drop_side_stream_workspaces()
    # warm-up (cuBLAS handles, allocator): one short request, discarded
    serve(engine, [sv.Request("warm", list(range(1, 65)), max_new_tokens=2)], sv)
    engine.reset()

    requests = serving_requests(cfg.vocab_size)
    lens = [len(r.prompt) for r in requests]
    torch.cuda.reset_peak_memory_stats()
    dense = serve_logged(engine, requests, sv)
    peak = torch.cuda.max_memory_allocated()
    results, summary = dense["results"], dense["summary"]
    wall = summary["wall_s"]
    generated = sum(len(res.tokens) for res in results.values())
    decode_rates = [(len(res.tokens) - 1) / (res.total_s - res.ttft_s)
                    for res in results.values()]
    # the longest request again, alone: its batched stream (two checks)
    probe = max(requests, key=lambda r: len(r.prompt))
    alone = serving_alone_checks(engine, probe, results[probe.rid].tokens,
                                 dense["chunk_log"], sv)
    out = dict(
        config="llama-1b", layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size, params=n_params, dtype="bfloat16",
        init_s=init_s, requests=len(requests), prompt_lens=lens,
        new_tokens=32, prompt_tokens=sum(lens), wall_s=wall,
        ttft_p50_s=summary["ttft_p50_s"], ttft_max_s=summary["ttft_max_s"],
        output_tok_s=generated / wall,
        decode_tok_s_per_stream_p50=statistics.median(decode_rates),
        peak_mem_bytes=peak, prefill_chunks=summary["prefill_chunks"],
        decode_steps=summary["decode_steps"], launches=summary["launches"],
        expected_norm_launches=summary["expected_norm_launches"],
        norm_launches_per_decode_step=2 * cfg.num_hidden_layers + 1,
        served_alone=alone)
    log("phase3-llama-1b", **out)
    if keep is not None:
        keep.update(streams=dense["streams"],
                    chunk_logits=list(dense["chunk_log"].logits))
    out["profile"] = profile_steps(engine, cfg)
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["paged"] = paged_checks(model, requests, dense, sv, device, **kw)
    log("phase3-serving-paged", **out["paged"])
    shared = prefix_requests(cfg.vocab_size)
    for form, paged in (("prefix_paged", True), ("prefix_dense", False)):
        out[form] = prefix_checks(model, shared, sv, device, paged=paged, **kw)
        log(f"phase3-serving-{form.replace('_', '-')}", **out[form])
    out["paged_and_prefix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec_observed = {}
    for form, paged in (("spec_dense", False), ("spec_paged", True)):
        out[form] = spec_checks(model, sv, device, paged=paged,
                                observe=None if paged else spec_observed,
                                **kw)
    out["spec_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept = {}
    out["control"] = control_checks(model, sv, device, keep=kept, **kw)
    out["control_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["obs"] = obs_checks(model, sv, device, kept, spec_observed,
                            nvidia_smi("name,power.limit"))
    kept.clear()
    torch.cuda.empty_cache()
    out["obs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["export"] = export_adopt_checks(model, requests[:kw["slots"]], sv,
                                        device, **kw)
    out["export_s"] = time.perf_counter() - t0
    out.update(lifecycle_checks(requests, sv, device, **kw))
    return out


def _compact(record):
    """``record`` for the log: every ``launches`` dict cut to the kernels
    that launched."""
    if isinstance(record, dict):
        return {k: (_nonzero(v) if k == "launches" else _compact(v))
                for k, v in record.items()}
    return record


# the weight lifecycle's depth: ``llama-1b``'s width at 4 of its 22
# layers.  Its time is checkpoint I/O and host-bound serving steps, both
# in proportion to the layers, and its gates (streams bit for bit across
# the swaps, verdicts and virtual numbers equal to a CPU dry run's) hold
# at any depth; the other serving phases keep all 22
LIFECYCLE_LAYERS = 4
# the depth of the tp-4 checkpoints, cut from 22 to keep the whole run's
# time near where it was before the supervised phase joined it (the
# speculation and control runs keep 22: their logit tolerances scale
# with the depth, and at 4 layers the forced-draft check fails them)
CUT_LAYERS = 4


def lifecycle_checks(requests, sv, device, **kw) -> dict:
    """The weight lifecycle's four phases on ``llama-1b`` at
    ``LIFECYCLE_LAYERS`` layers (bf16, the serving model's seed), their
    checkpoints in a temporary directory under the checkout (at most three
    steps at once, 0.62 GB each), removed however the phases end."""
    import shutil
    import tempfile
    import torch

    model, init_s = build_llama_1b(device, layers=LIFECYCLE_LAYERS)
    out = {"lifecycle_layers": LIFECYCLE_LAYERS, "lifecycle_init_s": init_s}
    root = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT)
    try:
        out["reload"], live = reload_checks(model, requests, sv, device, root,
                                            **kw)
        log("phase3-serving-reload", **_compact(out["reload"]))
        out["shadow"] = shadow_checks(model, live["new_params"], live["bad"],
                                      sv, device, requests, **kw)
        log("phase3-serving-shadow", **_compact(out["shadow"]))
        boot = live["boot"]
        del live
        torch.cuda.empty_cache()
        out["fleet"] = fleet_checks(model, sv, device, **kw)
        log("phase3-serving-fleet", **_compact(out["fleet"]))
        out["rollout"] = rollout_checks(model, boot, root, sv, device, **kw)
        log("phase3-serving-rollout", **_compact(out["rollout"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    out["lifecycle_s"] = sum(out[k]["wall_s"] for k in (
        "reload", "shadow", "fleet", "rollout"))
    return out


def llama_1b_int8(device, qmodel, ref) -> dict:
    """int8 serving of the quantized ``llama-1b`` (:func:`int8_checks`),
    the bf16 model freed; ``ref`` from :func:`int8_reference`."""
    from apex_tpu_torch import serving as sv

    t0 = time.perf_counter()
    out = int8_checks(qmodel, serving_requests(qmodel.config.vocab_size),
                      ref, sv, device, slots=8, max_len=2048, prefill_len=512)
    out["phase_s"] = time.perf_counter() - t0
    log("phase3-serving-int8", **out)
    return out


def profile_steps(engine, cfg) -> dict:
    """Where a step's time goes at full occupancy: slots prefilled with
    512 tokens each, then one 512-token prefill chunk and 5 decode steps
    over all 8 slots, each timed on the host (ending in a synchronize) and
    traced with ``torch.profiler``: device busy time (the kernels' summed
    self time) against the traced wall, and the kernels that take most."""
    import torch

    rng = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
               for _ in range(engine.slots)]
    engine.reset()
    for slot in range(engine.slots - 1):
        engine.prefill(slot, prompts[slot])
    last = engine.slots - 1

    def prefill_last():                 # slot `last` cached anew
        engine.release(last)
        engine.prefill_chunk(last, prompts[last])

    def decode_all():
        engine.decode([1] * engine.slots, [True] * engine.slots)

    out = {}
    for name, step, reps in (("prefill_chunk_512", prefill_last, 1),
                             ("decode_step_8_slots", decode_all, 5)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        traced_ms, kernels = _traced_kernels(step, reps)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = dict(
            wall_ms=wall_ms, traced_wall_ms=traced_ms,
            device_busy_ms=busy_ms if kernels else "not measured",
            device_idle_share=(1 - busy_ms / traced_ms) if kernels
            else "not measured",
            top_kernels=[(e.key[:80], e.count // reps,
                          e.self_device_time_total / 1e3 / reps)
                         for e in top])
    engine.reset()
    log("phase3-profile", **out)
    return out


def small_eval_check(device) -> dict:
    """A small fp32 Llama at head dim 64 (so its attention is the flash
    kernel), with a separate head and with a tied embedding: the same
    weights on the card and on the CPU give uncached logits and the
    ``labels=`` per-token loss within 1e-4."""
    import torch
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    out = {}
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 512, (2, 100), generator=g)
    labels = torch.roll(ids, -1, dims=1)
    for tied in (False, True):
        cfg = LlamaConfig(vocab_size=512, hidden_size=128,
                          intermediate_size=256, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1,
                          max_position_embeddings=256,
                          tie_word_embeddings=tied)
        cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(7))
        gpu_model = LlamaForCausalLM(cfg, device=device)
        gpu_model.load_state_dict(cpu_model.state_dict())
        with torch.inference_mode():
            res = {}
            for name, model, dev in (("cpu", cpu_model, "cpu"),
                                     ("cuda", gpu_model, device)):
                res[name] = (model(ids.to(dev)).cpu(),
                             model(ids.to(dev), labels=labels.to(dev)).cpu())
        err = dict(logits=float((res["cpu"][0] - res["cuda"][0]).abs().max()),
                   loss=float((res["cpu"][1] - res["cuda"][1]).abs().max()))
        if max(err.values()) > 1e-4:
            raise AssertionError(f"small Llama (tied={tied}): card against "
                                 f"CPU {err} (> 1e-4)")
        out["tied" if tied else "lm_head"] = err
    out["tolerance"] = 1e-4
    log("phase3-eval-reference", **out)
    return out


def _decode_p50_ms(engine, prompts, steps: int = 24) -> float:
    """p50 wall of one decode step with every slot active: each slot
    prefilled with its prompt, then ``steps`` steps (3 more first, not
    counted), each bracketed by ``torch.cuda.synchronize``."""
    import numpy as np
    import torch

    engine.reset()
    for slot, p in enumerate(prompts):
        engine.prefill(slot, p)
    toks = np.ones((engine.slots,), np.int64)
    act = np.ones((engine.slots,), bool)
    times = []
    for i in range(steps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode(toks, act)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    engine.reset()
    return statistics.median(times)


def _decode_profile(engine, prompts, reps: int = 3) -> dict:
    """One decode step with every slot active, traced ``reps`` times with
    ``torch.profiler`` after one untraced step: the traced wall, device
    busy time (the kernels' own time), the kernels and the host operators
    that take most (self time a step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.reset()
    for slot, p in enumerate(prompts):
        engine.prefill(slot, p)

    def step():
        engine.decode([1] * engine.slots, [True] * engine.slots)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / reps
    engine.reset()
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return dict(
        traced_wall_ms=traced_ms,
        device_busy_ms=busy if kernels else "not measured",
        top_kernels=[(e.key[:70], e.count // reps,
                      e.self_device_time_total / 1e3 / reps) for e in sorted(
                          kernels, key=lambda e: -e.self_device_time_total)[:5]],
        top_host_ops=[(e.key[:70], e.count // reps,
                       e.self_cpu_time_total / 1e3 / reps) for e in sorted(
                           host, key=lambda e: -e.self_cpu_time_total)[:8]])


def tp_checks(model, qmodel, dense_ref, int8_ref, probe, sv, device, smi,
              **kw) -> dict:
    """Phase ``phase3-serving-tp``: tensor-parallel serving at world 1 over
    NCCL (see the module docstring).  ``dense_ref`` is the ``tp=None``
    dense run of :func:`llama_1b` (streams, chunk logits), ``int8_ref``
    the bf16 probe stream of :func:`int8_reference`, ``qmodel`` the int8
    model.  The group and the checkpoints' temporary directory go however
    the phase ends."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    t_phase = time.perf_counter()
    cfg = model.config
    layers = cfg.num_hidden_layers
    out = dict(nvidia_smi=smi)
    rdv = tempfile.mkdtemp(prefix="tp_rdv_")
    root = tempfile.mkdtemp(prefix="ckpt_tp_", dir=ROOT)
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        group = ps.serving_group(1)
        tp = sv.TPConfig(size=1)
        out["backend"] = str(dist.get_backend(group))
        requests = serving_requests(cfg.vocab_size)
        # ---- streams: tp 1, dense and paged, against tp=None dense ------
        for form, extra in (("dense", {}), ("paged", dict(
                paged=sv.PagedCacheConfig(block_size=16)))):
            engine = sv.DecodeEngine(model, device=device, tp=tp, **kw,
                                     **extra)
            calls0 = mappings.collective_calls()
            run = serve_logged(engine, requests, sv, label=f"tp1 {form}")
            calls = mappings.collective_calls() - calls0
            if run["streams"] != dense_ref["streams"]:
                raise AssertionError(f"tp1 {form}: streams differ from the "
                                     f"tp=None run")
            logits = run["chunk_log"].logits
            if len(logits) != len(dense_ref["chunk_logits"]) or not all(
                    torch.equal(a, b) for a, b in
                    zip(logits, dense_ref["chunk_logits"])):
                raise AssertionError(f"tp1 {form}: chunk logits differ "
                                     f"from the tp=None run")
            summ = run["summary"]
            out[form] = dict(streams_equal=True, chunk_logits_equal=True,
                             wall_s=summ["wall_s"],
                             prefill_chunks=summ["prefill_chunks"],
                             decode_steps=summ["decode_steps"],
                             launches=_nonzero(summ["launches"]),
                             expected_norm_launches=summ[
                                 "expected_norm_launches"],
                             collectives=calls)
            del engine, run
        # ---- the decode step, tp 1 against tp=None, in turns ------------
        prompts = [r.prompt[:64] for r in requests[:kw["slots"]]]
        plain = sv.DecodeEngine(model, device=device, **kw)
        tp1 = sv.DecodeEngine(model, device=device, tp=tp, **kw)
        _decode_p50_ms(plain, prompts, steps=4)          # warm-up
        _decode_p50_ms(tp1, prompts, steps=4)
        turns = {"none": [], "tp1": []}
        for name, eng in (("none", plain), ("tp1", tp1), ("tp1", tp1),
                          ("none", plain)):
            turns[name].append(_decode_p50_ms(eng, prompts))
        for slot, p in enumerate(prompts):
            tp1.prefill(slot, p)
        calls0 = mappings.collective_calls()
        tp1.decode([1] * kw["slots"], [True] * kw["slots"])
        per_step = mappings.collective_calls() - calls0
        tp1.reset()
        profiles = {"none": _decode_profile(plain, prompts),
                    "tp1": _decode_profile(tp1, prompts)}
        if per_step != 2 * layers + 1:
            raise AssertionError(f"a tp1 decode step issued {per_step} "
                                 f"collectives, expected {2 * layers + 1}")
        out["decode_step"] = dict(
            p50_ms_none=turns["none"], p50_ms_tp1=turns["tp1"],
            ratio=statistics.median(turns["tp1"])
            / statistics.median(turns["none"]),
            collectives_per_step=per_step,
            row_linear_all_reduces_per_step=2 * layers,
            logits_all_gathers_per_step=1, profiles=profiles)
        del plain, tp1
        torch.cuda.empty_cache()
        # ---- the quantized all-reduce ----------------------------------
        qeng = sv.DecodeEngine(qmodel, device=device, tp=tp,
                               quant=sv.QuantConfig(weights=True, kv=True,
                                                    allreduce=True), **kw)
        if qeng.model is not qmodel:
            raise AssertionError("the tp engine quantized the int8 model "
                                 "again")
        picks, logits, _ = serve_in_chunks(qeng, probe, 0, int8_ref["chunks"],
                                           forced=int8_ref["stream"])
        err = float((logits.float().cpu() - int8_ref["logits"]).abs().max())
        if not err < 0.5:
            raise AssertionError(f"tp1 quantized all-reduce: max |logit "
                                 f"error| {err} >= 0.5")
        out["quant_allreduce"] = dict(
            max_abs_logit_err=err, bar="max |logit error| < 0.5",
            agreement_all_positions=sv.stream_agreement(int8_ref["stream"],
                                                        picks))
        del qeng
        torch.cuda.empty_cache()
        # ---- the evaluation forward in the tp region --------------------
        b, s = 4, 2048
        g = torch.Generator().manual_seed(8)
        ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(device)
        labels = torch.roll(ids, -1, dims=1)
        expected = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                    fa.FLASH_ATTENTION_FWD.name: layers,
                    lh.FUSED_LM_HEAD_FWD.name: 1}
        with torch.inference_mode():
            plain_loss = model(ids, labels=labels)
            with mappings.tensor_parallel_region(group):
                model(ids, labels=labels)                # warm-up
                torch.cuda.synchronize()
                _dispatch.reset_launches()
                t0 = time.perf_counter()
                tp_loss = model(ids, labels=labels)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in _dispatch.KERNELS}
        if device.type == "cuda" and {
                k: n for k, n in launches.items() if n} != expected:
            raise AssertionError(f"tp1 eval forward launched {launches}, "
                                 f"expected {expected}")
        if not torch.equal(plain_loss, tp_loss):
            raise AssertionError("tp1 eval loss differs from the plain "
                                 "forward's")
        out["evaluation"] = dict(equal=True, wall_s=wall,
                                 tok_s=b * s / wall,
                                 launches=_nonzero(launches))
        del plain_loss, tp_loss, ids, labels
        # ---- v2 checkpoints, at CUT_LAYERS layers ---------------------
        ck_model, _ = build_llama_1b(device, layers=CUT_LAYERS)
        out["checkpoints"] = dict(
            tp_checkpoint_checks(ck_model, requests, sv, device, root, tp,
                                 **kw), layers=CUT_LAYERS)
        del ck_model
        torch.cuda.empty_cache()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(rdv, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-serving-tp", **out)
    return out


def tp_checkpoint_checks(model, requests, sv, device, root, tp,
                         **kw) -> dict:
    """The v2 part of ``phase3-serving-tp``: llama-1b's weights saved on a
    tp-4 grid from one process (form (a)) and as v1, both validated and
    restored whole onto the card (bit for bit equal), the v2 weights
    swapped into the tp engine (its streams unchanged), rank 2-of-4's
    block restored alone, and a corrupt newer step passed over."""
    import torch
    from apex_tpu_torch import resilience as rz
    from apex_tpu_torch.models.llama import tp_param_spec
    from apex_tpu_torch.resilience import elastic

    out = {}
    sd = model.state_dict()
    state = {"params": sd}
    specs = {"params": {k: elastic.PartitionSpec(*tp_param_spec(k))
                        for k in sd}}
    v1, v2 = os.path.join(root, "v1"), os.path.join(root, "v2")
    t0 = time.perf_counter()
    rz.save_checkpoint(v1, 1, state)
    out["v1_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = rz.save_sharded_checkpoint(v2, 1, state, mesh={"tp": 4},
                                      specs=specs)
    out["v2_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rz.validate_sharded_checkpoint(path)
    out["v2_validate_s"] = time.perf_counter() - t0
    out["bytes"] = os.path.getsize(os.path.join(path, "data.bin"))
    whole = sv.tp_param_shardings(sd, 0, 1)
    t0 = time.perf_counter()
    got2, step2 = sv.load_serving_params(v2, state, params_key="params",
                                         shardings=whole)
    torch.cuda.synchronize()
    out["v2_restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got1, _ = sv.load_serving_params(v1, state, params_key="params")
    torch.cuda.synchronize()
    out["v1_restore_s"] = time.perf_counter() - t0
    if step2 != 1 or not all(torch.equal(got2[k], got1[k]) and
                             torch.equal(got2[k], sd[k]) for k in sd):
        raise AssertionError("the v2 restore differs from the v1 restore")
    del got1
    engine = sv.DecodeEngine(model, device=device, tp=tp, **kw)
    few = requests[:2]
    before = serve(engine, few, sv)[0]
    engine.swap_params(got2)
    after = serve(engine, few, sv)[0]
    if {k: v.tokens for k, v in before.items()} != {
            k: v.tokens for k, v in after.items()}:
        raise AssertionError("the tp engine on the v2 weights serves other "
                             "streams")
    del engine, got2, before, after
    torch.cuda.empty_cache()
    # rank 2 of 4 alone
    sl = sv.tp_param_shardings(sd, 2, 4)

    def block_like(t, piece):
        if piece is None:
            return t
        shape = list(t.shape)
        start, stop = piece.bounds(shape[piece.dim])
        shape[piece.dim] = stop - start
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    like = {"params": {k: block_like(t, sl[k]) for k, t in sd.items()}}
    read0 = elastic.shard_bytes_read()
    t0 = time.perf_counter()
    blk, _ = sv.load_serving_params(v2, like, params_key="params",
                                    shardings=sl)
    torch.cuda.synchronize()
    out["block_restore_s"] = time.perf_counter() - t0
    read = elastic.shard_bytes_read() - read0
    for k, t in sd.items():
        want = t if sl[k] is None else sl[k].take(t)
        if not torch.equal(blk[k], want):
            raise AssertionError(f"rank 2-of-4 block of {k} differs")
    sharded = sum(t.numel() * t.element_size() for k, t in sd.items()
                  if sl[k] is not None)
    whole_only = sum(t.numel() * t.element_size() for k, t in sd.items()
                     if sl[k] is None)
    if read != sharded // 4 + whole_only:
        raise AssertionError(f"block restore read {read} bytes, expected "
                             f"{sharded // 4} + {whole_only}")
    out["block"] = dict(bytes_read=read, sharded_bytes=sharded,
                        read_over_sharded=read / sharded,
                        replicated_bytes=whole_only)
    del blk
    # a corrupt newer step: the walk falls back one step
    newer = rz.save_sharded_checkpoint(v2, 2, state, mesh={"tp": 4},
                                       specs=specs)
    dmg = rz.CorruptShardFile(leaf="q_proj", shard=2, seed=0)(newer)
    latest = rz.latest_valid_step(v2)
    got, step = sv.load_serving_params(v2, like, params_key="params",
                                       shardings=sl)
    if latest != 1 or step != 1:
        raise AssertionError(f"after CorruptShardFile at step 2: latest "
                             f"valid {latest}, restored {step}")
    out["fallback"] = dict(corrupted=dmg["leaf"], coords=dmg["coords"],
                           latest_valid_step=latest, restored_step=step)
    del got
    torch.cuda.empty_cache()
    return out


def llama_1b_eval(device, model) -> dict:
    """Evaluation: ``model(ids, labels=labels)`` at b 4, s 2048 (labels =
    ids rolled by one) under ``inference_mode``, with the exact launches of
    one forward; the fused loss against ``F.cross_entropy`` over the
    model's logits; the flash path against the cached path on one
    512-token prompt; wall, tokens/s, peak memory and a profile."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.serving import kv_cache as kvc

    cfg = model.config
    b, s = 4, 2048
    g = torch.Generator().manual_seed(8)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(device)
    labels = torch.roll(ids, -1, dims=1)
    layers = cfg.num_hidden_layers
    expected = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                fa.FLASH_ATTENTION_FWD.name: layers,
                lh.FUSED_LM_HEAD_FWD.name: 1}
    with torch.inference_mode():
        _drop_side_stream_workspaces()
        model(ids, labels=labels)                    # warm-up, not counted
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        loss = model(ids, labels=labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _dispatch.KERNELS}
        peak = torch.cuda.max_memory_allocated()
        if {k: n for k, n in launches.items() if n} != expected:
            raise AssertionError(f"one eval forward launched {launches}, "
                                 f"expected {expected}")
        if tuple(loss.shape) != (b, s) or loss.dtype != torch.float32 \
                or not torch.isfinite(loss).all():
            raise AssertionError(f"eval loss {loss.dtype} {tuple(loss.shape)}"
                                 f" finite={bool(torch.isfinite(loss).all())}")
        logits = model(ids)                          # [s, b, vocab] fp32
        ce = F.cross_entropy(logits.permute(1, 2, 0), labels,
                             reduction="none")
        ce_err = float((loss - ce).abs().max())
        del logits, ce
        if ce_err > 2e-3:
            raise AssertionError(f"fused loss against F.cross_entropy over "
                                 f"the logits: {ce_err} (> 2e-3)")
        # the two attention paths: flash (uncached) against the cached
        # prefill's fp32 attention, on one 512-token prompt
        prompt = ids[:1, :512]
        flash_logits = model(prompt)
        cache = kvc.init_cache(cfg, slots=1, max_len=512, dtype=torch.bfloat16,
                               device=device)
        cached_logits, _ = model(prompt, kv_cache=cache, slot=0, position=0)
        diff = (flash_logits - cached_logits).abs()
        scale = float(cached_logits.abs().max())
        paths = dict(max_abs_diff=float(diff.max()),
                     mean_abs_diff=float(diff.mean()), max_abs_logit=scale,
                     top1_agreement=float((flash_logits.argmax(-1)
                                           == cached_logits.argmax(-1))
                                          .float().mean()))
        if paths["max_abs_diff"] > 0.05 * scale:
            raise AssertionError(f"flash and cached attention paths differ: "
                                 f"{paths} (max > 0.05 x max|logit|)")
        del flash_logits, cached_logits, cache, diff
    # the least time of the forward: its products at the bf16 rate (every
    # weight but the embedding lookup, twice a token, and the causal
    # attention pairs of each layer)
    weights = sum(p.numel() for p in model.parameters()) - \
        model.embed_tokens.weight.numel()
    if cfg.tie_word_embeddings:
        weights += model.embed_tokens.weight.numel()
    hd = cfg.hidden_size // cfg.num_attention_heads
    flops = (2 * weights * b * s + layers * 4 * b * cfg.num_attention_heads
             * (s * (s + 1) // 2) * hd)
    out = dict(config="llama-1b", batch=b, seq=s, tokens=b * s,
               dtype="bfloat16", launches=launches, expected=expected,
               loss_mean=float(loss.mean()), wall_ms=wall * 1e3,
               tokens_per_s=b * s / wall, flops=flops,
               bound_ms=flops / 989e12 * 1e3, peak_mem_bytes=peak,
               allocated_before_bytes=allocated_before,
               fused_vs_cross_entropy_max_abs=ce_err,
               fused_vs_cross_entropy_tol=2e-3, flash_vs_cached=paths,
               flash_vs_cached_tol="max |diff| <= 0.05 x max|logit|")
    log("phase3-eval", **out)
    out["profile"] = profile_eval(model, ids, labels)
    return out


def profile_eval(model, ids, labels) -> dict:
    """One ``labels=`` forward timed on the host (ending in a synchronize)
    and traced with ``torch.profiler``: device busy time against the traced
    and the unprofiled wall, and the kernels that take most."""
    import torch

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(ids, labels=labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        traced_ms, kernels = _traced_kernels(lambda: model(ids, labels=labels))
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(
        wall_ms=wall_ms, traced_wall_ms=traced_ms,
        device_busy_ms=busy_ms if kernels else "not measured",
        device_idle_share_traced=(1 - busy_ms / traced_ms) if kernels
        else "not measured",
        device_idle_share_unprofiled=(1 - busy_ms / wall_ms) if kernels
        else "not measured",
        top_kernels=[(e.key[:80], e.count, e.self_device_time_total / 1e3)
                     for e in top])
    log("phase3-eval-profile", **out)
    return out


CARD_VS_CPU_STEPS = 3   # optimizer steps of the small models, card vs CPU


def _grad_tol_ratio(got: dict, ref: dict) -> float:
    """Each gradient against the reference within 1e-4 (max|g_ref| +
    |g_ref|) (fp32 sums in another order), plus 1e-6 of the largest
    gradient of the model: a gradient that is zero in exact arithmetic (a key bias
    shifts every score of a query's row alike, and the softmax drops it)
    is fp32 rounding noise on both sides (1e-8 beside gradients of 1e-2 in
    the small ViT, 7 x its own relative limit on the CPU in fp32 against
    fp64).  The worst ratio to it."""
    floor = 1e-6 * max(float(r.abs().max()) for r in ref.values())
    return max(float(((got[n] - ref[n]).abs()
                      / (1e-4 * ref[n].abs().max() + 1e-4 * ref[n].abs()
                         + floor + 1e-9)).max()) for n in ref)


def _param_tol_ratio(got: dict, ref: dict, grads: dict, lr: float,
                     steps: int) -> float:
    """Each parameter after ``steps`` steps within 1e-5 + 2 steps lr ng /
    (|g| + ng), ng = 1e-4 max|g_ref| + 1e-6 max over the model's |g_ref|
    (``_grad_tol_ratio``'s limit): Adam and LAMB divide each gradient by
    its own size, so an element whose gradient is within its noise may
    step by up to lr either way on each side."""
    ratio = 0.0
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for n in ref:
        ng = 1e-4 * grads[n].abs().max() + floor
        tol = 1e-5 + 2 * steps * lr * ng / (grads[n].abs() + ng + 1e-30)
        ratio = max(ratio, float(((got[n] - ref[n]).abs() / tol).max()))
    return ratio


def _card_vs_cpu(label: str, build, loss_of, make_opt, lr: float,
                 device) -> dict:
    """``build(dev)`` the same fp32 model on the CPU and on the card (the
    card's loaded with the CPU's weights): the loss and every gradient,
    then the losses and parameters of ``CARD_VS_CPU_STEPS`` optimizer steps
    (``make_opt(params)``), each within its stated tolerance."""
    res = {}
    cpu_model = build("cpu")
    gpu_model = build(device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("cuda", gpu_model, device)):
        loss = loss_of(model, dev)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        opt = make_opt(model.parameters())
        losses = []
        for _ in range(CARD_VS_CPU_STEPS):
            opt.zero_grad(set_to_none=True)
            step_loss = loss_of(model, dev)
            step_loss.backward()
            opt.step()
            losses.append(float(step_loss.detach()))
        params = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        res[name] = (float(loss.detach()), grads, losses, params)
    c, d = res["cpu"], res["cuda"]
    err = dict(loss=abs(c[0] - d[0]), grad_tol_ratio=_grad_tol_ratio(d[1], c[1]),
               step_losses=max(abs(a - b) for a, b in zip(c[2], d[2])),
               params_after_steps=max(float((d[3][n] - c[3][n]).abs().max())
                                      for n in c[3]),
               params_tol_ratio=_param_tol_ratio(d[3], c[3], c[1], lr,
                                                 CARD_VS_CPU_STEPS),
               params=len(c[1]), cpu_losses=c[2], card_losses=d[2])
    if (err["loss"] > 1e-5 or err["grad_tol_ratio"] > 1.0
            or err["step_losses"] > 1e-4 or err["params_tol_ratio"] > 1.0):
        raise AssertionError(f"{label}: card against CPU {err}")
    if not c[2][-1] < c[2][0]:
        raise AssertionError(f"{label}: loss did not fall {c[2]}")
    return err


def _labels_loss(ids, model, dev):
    """The mean ``labels=`` loss of ``ids`` (on ``dev``), labels the ids
    rolled by one: the language models' training loss."""
    import torch

    x = ids.to(dev)
    return model(x, labels=torch.roll(x, -1, dims=1)).mean()


SMALL_CARD_TOL = ("loss 1e-5; each gradient within 1e-4 (max|g_ref| + "
                  "|g_ref|) + 1e-6 max over the model's |g_ref| of the "
                  "CPU's (fp32, sums in another order); the "
                  "losses of 3 optimizer steps 1e-4; each parameter after "
                  "them within 1e-5 + 2 x 3 lr ng / (|g| + ng), ng = 1e-4 "
                  "max|g_ref| + 1e-6 max over the model's |g_ref|")


def small_train_check(device) -> dict:
    """A small fp32 Llama at head dim 64 (so every kernel of the training
    path runs), with a separate head and with a tied embedding: the same
    weights on the card and on the CPU give the ``labels=`` loss and every
    parameter's gradient, then the losses and parameters of 3 FusedAdam
    steps (lr 1e-3), each within its stated tolerance
    (:func:`_card_vs_cpu`)."""
    import torch
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from apex_tpu_torch.optimizers import FusedAdam

    out = {}
    ids = torch.randint(0, 512, (2, 100), generator=torch.Generator().manual_seed(9))
    for tied in (False, True):
        cfg = LlamaConfig(vocab_size=512, hidden_size=128,
                          intermediate_size=256, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1,
                          max_position_embeddings=256,
                          tie_word_embeddings=tied)

        def build(dev, cfg=cfg):
            return LlamaForCausalLM(
                cfg, device=dev, generator=torch.Generator().manual_seed(10)
                if dev == "cpu" else None)

        out["tied" if tied else "lm_head"] = _card_vs_cpu(
            f"small Llama training (tied={tied})", build,
            functools.partial(_labels_loss, ids),
            lambda ps: FusedAdam(ps, lr=1e-3), 1e-3, device)
    out["tolerance"] = SMALL_CARD_TOL
    log("phase3-train-reference", **out)
    return out


def small_optimizer_checks(device) -> dict:
    """The optimizers and the clip that this port adds, 3 steps each on a
    small fp32 Llama (2 layers, hidden 128, head dim 64), card against CPU
    from the same weights: ``FusedSGD`` (momentum, nesterov, weight decay),
    ``FusedNovoGrad``, ``FusedMixedPrecisionLamb`` (masters, the clip, the
    device lr) and ``clip_grad_norm_`` before a plain ``FusedSGD`` step.
    Each step's losses within 1e-4; each parameter within 1e-5 plus the
    first step's gradient tolerance carried through the optimizer's update
    (ng = 1e-4 max|g| an element, as ``small_train_check`` holds the
    gradients; the later steps' gradients, taken at parameters already
    apart, held to twice that); the clip's totals within the norm's share
    of it; the multi-tensor launches of every step on the card exact."""
    import torch
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
    from apex_tpu_torch.examples.llama_pretrain import train_step
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import (FusedMixedPrecisionLamb,
                                           FusedNovoGrad, FusedSGD)

    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256)
    ids = torch.randint(0, 512, (2, 100), generator=torch.Generator().manual_seed(9))
    base = LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(12))
    steps = 3

    def clip_step(model, opt, x):
        labels = torch.roll(x, -1, dims=1)
        opt.zero_grad(set_to_none=True)
        loss = model(x, labels=labels).mean()
        loss.backward()
        total = clip_grad_norm_(model.parameters(), 0.05)
        opt.step()
        return loss.detach(), total

    forms = {
        "sgd": (lambda ps: FusedSGD(ps, lr=0.05, momentum=0.9, nesterov=True,
                                    weight_decay=0.01), {}),
        "novograd": (lambda ps: FusedNovoGrad(ps, lr=1e-3, weight_decay=0.01),
                     {mt.MT_L2NORM.name: 1}),
        "mp_lamb": (lambda ps: FusedMixedPrecisionLamb(ps, lr=1e-3),
                    {mt.MT_L2NORM.name: 1, mt.MT_LAMB.name: 1}),
        "clip_grad_norm_": (lambda ps: FusedSGD(ps, lr=0.1),
                            {mt.MT_L2NORM.name: 1, mt.MT_SCALE.name: 1}),
    }
    out = {}
    for name, (make, per_step) in forms.items():
        res = {}
        for dev in ("cpu", device):
            model = LlamaForCausalLM(cfg, device=dev)
            model.load_state_dict(base.state_dict())
            x = ids.to(dev)
            # the first step's gradients, for the bound
            model(x, labels=torch.roll(x, -1, dims=1)).mean().backward()
            g1 = {n: p.grad.detach().cpu().clone()
                  for n, p in model.named_parameters()}
            opt = make(list(model.parameters()))
            losses, totals, launches = [], [], []
            for _ in range(steps):
                before = {k.name: k.launches for k in _dispatch.KERNELS}
                if name == "clip_grad_norm_":
                    loss, total = clip_step(model, opt, x)
                    totals.append(float(total))
                else:
                    loss = train_step(model, opt, x)
                losses.append(float(loss))
                launches.append({k.name: k.launches - before[k.name]
                                 for k in _dispatch.KERNELS
                                 if k.name.startswith("mt_")
                                 and k.launches != before[k.name]})
            res["cpu" if dev == "cpu" else "cuda"] = dict(
                g1=g1, losses=losses, totals=totals, launches=launches,
                params={n: p.detach().cpu().clone()
                        for n, p in model.named_parameters()})
        c, d = res["cpu"], res["cuda"]
        if any(l != per_step for l in d["launches"]):
            raise AssertionError(f"small {name}: multi-tensor launches a step "
                                 f"{d['launches']}, expected {per_step}")
        ratio = 0.0
        for n, p_ref in c["params"].items():
            g = c["g1"][n]
            ga = g.abs()
            gmax = float(ga.max())
            ng = 1e-4 * gmax + 1e-30
            dg = 1e-4 * (gmax + ga)
            if name == "sgd":
                # lr (g + mu buf), buf summing the steps' gradients
                tol = 2 * steps * 0.05 * 4 * dg
            elif name == "clip_grad_norm_":
                # lr coef g: coef <= 1, its relative error the total's
                n_all = sum(t.numel() for t in c["g1"].values())
                gm = max(float(t.abs().max()) for t in c["g1"].values())
                tot = math.sqrt(sum(float((t.double() ** 2).sum())
                                    for t in c["g1"].values()))
                rel = 1e-4 * (1 + math.sqrt(n_all) * gm / tot)
                tol = 2 * steps * 0.1 * (dg + ga * rel)
            elif name == "novograd":
                # lr m / bc1 with m a sum of g / ||g||: 20 lr a step at most
                # (bc1 = 1 - 0.95^t), g / ||g|| within dg / ||g|| plus |g|
                # ||dg|| / ||g||^2
                gn = float(torch.linalg.vector_norm(g)) + 1e-30
                dn = float(torch.linalg.vector_norm(dg))
                tol = 2 * steps * 20 * 1e-3 * (dg / gn + ga * dn / gn ** 2)
            else:
                # Adam-like u (an element's error ng / (|g| + ng)) times a
                # trust ratio of at most 2
                tol = 2 * steps * 1e-3 * 2 * ng / (ga + ng)
            tol = tol + 1e-5
            ratio = max(ratio, float(((d["params"][n] - p_ref).abs()
                                      / tol).max()))
        loss_err = max(abs(a - b) for a, b in zip(c["losses"], d["losses"]))
        total_ratio = 0.0
        if totals := c["totals"]:
            n_all = sum(t.numel() for t in c["g1"].values())
            gm = max(float(t.abs().max()) for t in c["g1"].values())
            total_ratio = max(abs(a - b) / (2e-4 * (b + math.sqrt(n_all) * gm))
                              for a, b in zip(d["totals"], totals))
        if ratio > 1.0 or loss_err > 1e-4 or total_ratio > 1.0:
            raise AssertionError(f"small {name}: card against CPU: params "
                                 f"{ratio:.3f} x tol, losses {loss_err}, "
                                 f"clip totals {total_ratio:.3f} x tol")
        out[name] = dict(params_tol_ratio=ratio, loss_err=loss_err,
                         losses_cuda=d["losses"], losses_cpu=c["losses"],
                         clip_totals_cuda=d["totals"],
                         clip_totals_tol_ratio=total_ratio,
                         mt_launches_per_step=d["launches"][0])
    out["tolerance"] = ("losses 1e-4; each parameter within 1e-5 plus its "
                        "first gradient's tolerance (1e-4 (max|g| + |g|)) "
                        "carried through the update: SGD lr (1 + mu + ...) "
                        "<= 4 lr a step; NovoGrad 20 lr / ||g|| a step; the "
                        "mixed-precision LAMB's Adam-like ng / (|g| + ng) "
                        "times lr and a trust ratio <= 2; the clipped SGD lr "
                        "times the coefficient's relative error; twice that "
                        "for the later steps; the clip totals within 2e-4 "
                        "(total + sqrt(N) max|g|)")
    log("phase3-optimizers-reference", **out)
    return out


TRAIN_STEPS = 6        # timed steps after one warm-up (bench.py's llama-1b card)
TP_TRAIN_STEPS = 3     # steps after one warm-up, tp 1 against tp=None
TP_AMP_STEPS = 4       # amp steps under GradScaler after one warm-up


def _step_flops(model, b: int, s: int) -> float:
    """bench.py's model FLOPs of one training step: 6 N per token plus the
    causal attention term 12 L h s / 2 per token, times the tokens."""
    cfg = model.config
    n = sum(p.numel() for p in model.parameters())
    per_token = 6 * n + 12 * cfg.num_hidden_layers * cfg.hidden_size * s // 2
    return float(per_token * b * s)


def _host_loop_ms() -> float:
    """Wall ms of a fixed pure-Python loop (2 M integer additions): a
    yardstick of the host CPU's speed at the moment, by which host-bound
    step walls are read across phases and calls (the card's host is
    shared, and its speed moves while a process runs)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def _thread_cpu_ms() -> dict:
    """CPU ms each thread of this process has used, by thread name (the
    calling thread as ``main``), from ``/proc/self/task``."""
    import threading

    main, tick = str(threading.get_native_id()), os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = "main" if tid == main else f.read().strip()
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue            # the thread ended meanwhile
        # utime and stime, fields 14 and 15 of stat(5)
        ms = (int(fields[11]) + int(fields[12])) * 1e3 / tick
        out[name] = out.get(name, 0.0) + ms
    return out


def _train_steps(step_fn, steps: int, per_step: dict, label: str, *,
                 every_step: bool = False, after_step=None) -> dict:
    """One warm-up call of ``step_fn`` (a training step returning its
    loss), then ``steps`` timed calls with the launches of each checked
    exactly against ``per_step``, the counts set to 0 just before them;
    finite losses, the last below the warm-up's (``bench.py``'s gate) or,
    with ``every_step``, each below the one before; the peak memory over
    the timed steps, each step's wall and the host's time (wall and CPU)
    to issue it; the CPU ms of each of the process's threads over the
    timed steps, and the host yardstick (``_host_loop_ms``) just before
    and after them.  ``after_step(i, losses)`` runs after step ``i``,
    with the warm-up's loss and those so far."""
    import torch
    from apex_tpu_torch.ops import _dispatch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0 = float(step_fn())
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    allocs0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
    host_loop = [_host_loop_ms()]
    threads0 = _thread_cpu_ms()
    step_ms, issue_ms, issue_cpu_ms, losses = [], [], [], []
    for i in range(steps):
        before = _launch_counts()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        loss = step_fn()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        issue_cpu_ms.append((time.process_time() - c0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        step = {k: v - before[k] for k, v in _launch_counts().items()}
        if _nonzero(step) != per_step:
            raise AssertionError(f"{label} step {i} launched {_nonzero(step)}, "
                                 f"expected {per_step}")
        if after_step is not None:
            after_step(i, [loss0] + losses)
    threads = {name: ms - threads0.get(name, 0.0)
               for name, ms in _thread_cpu_ms().items()}
    host_loop.append(_host_loop_ms())
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    seq = [loss0] + losses
    falling = (all(a > b for a, b in zip(seq, seq[1:])) if every_step
               else losses[-1] < loss0)
    if not all(map(math.isfinite, seq)) or not falling:
        raise AssertionError(f"{label}: loss {loss0} then {losses}: not "
                             f"finite and falling"
                             + (" every step" if every_step else ""))
    return dict(warmup_loss=loss0, losses=losses, warmup_ms=warm_ms,
                step_ms=step_ms, step_ms_median=statistics.median(step_ms),
                # the host's time to issue each step (and its CPU time
                # then): near step_ms, the step is host-bound
                step_issue_ms=issue_ms, step_issue_cpu_ms=issue_cpu_ms,
                thread_cpu_ms_timed_steps={n: ms for n, ms in sorted(
                    threads.items(), key=lambda kv: -kv[1]) if ms > 0},
                host_loop_ms=host_loop,
                device_allocs_in_timed_steps=torch.cuda.memory_stats().get(
                    "num_device_alloc", 0) - allocs0,
                allocated_before_bytes=allocated_before, peak_mem_bytes=peak,
                launches=launches, launches_per_step=per_step)


def llama_1b_train(device, keep=None) -> dict:
    """Training: the ``llama-1b`` card, fp32 init from a seeded generator
    on the card, O2 cast (2-d parameters bf16, norm scales fp32),
    ``FusedAdam(lr=1e-3, state_dtype=bf16)``, one fixed batch b 4 x s 2048
    with labels the ids rolled by one; 1 warm-up step, then 6 timed steps
    with the launches of each step checked exactly; a finite loss falling
    every step;
    step wall, tokens/s, MFU against 989 TFLOP/s, peak memory and a profile
    of one step.  ``keep`` (a dict) receives the losses of the warm-up and
    the first ``TP_TRAIN_STEPS`` steps and a host copy of every parameter
    after them, the ``tp=None`` reference of :func:`llama_1b_train_tp`."""
    import torch
    from apex_tpu_torch.examples.llama_pretrain import o2_cast, train_step
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = LlamaConfig.llama_1b()
    gen = torch.Generator(device=device).manual_seed(0)
    model = o2_cast(LlamaForCausalLM(cfg, device=device, generator=gen))
    opt = FusedAdam(model.parameters(), lr=1e-3, state_dtype=torch.bfloat16)
    b, s = 4, 2048
    ids = torch.randint(0, cfg.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(8)).to(device)
    layers = cfg.num_hidden_layers
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                fa.FLASH_ATTENTION_FWD.name: layers,
                fa.FLASH_ATTENTION_DQ.name: layers,
                fa.FLASH_ATTENTION_DKV.name: layers,
                lh.FUSED_LM_HEAD_FWD.name: 1,
                lh.FUSED_LM_HEAD_DH.name: 1,
                lh.FUSED_LM_HEAD_DE.name: 1,
                mt.MT_ADAM.name: 1}

    def keep_params(i, losses):
        if i == TP_TRAIN_STEPS - 1:
            # to the host: a device copy would take memory and allocations
            # from the steps that follow
            keep.update(losses=losses, per_step=per_step,
                        params={n: p.detach().cpu()
                                for n, p in model.named_parameters()})

    run = _train_steps(lambda: train_step(model, opt, ids), TRAIN_STEPS,
                       per_step, "llama-1b training", every_step=True,
                       after_step=None if keep is None else keep_params)
    flops = _step_flops(model, b, s)
    med = run["step_ms_median"]
    out = dict(config="llama-1b", batch=b, seq=s, tokens=b * s,
               precision="O2: 2-d parameters bf16, norm scales fp32; "
                         "FusedAdam(lr=1e-3, state_dtype=bf16)",
               params=sum(p.numel() for p in model.parameters()), **run,
               tokens_per_s=b * s / (med / 1e3), flops_per_step=flops,
               bound_ms=flops / 989e12 * 1e3,
               mfu=flops / (med / 1e3) / 989e12,
               mt_table_bytes=mt_table_bytes())
    log("phase3-train", **out)
    out["profile"] = profile_train(model, opt, ids, med)
    del model, opt
    torch.cuda.empty_cache()
    return out


def _tp_train_run(cfg, device, ids, per_step, group=None,
                  dp_group=None) -> dict:
    """1 warm-up + ``TP_TRAIN_STEPS`` steps of ``llama_pretrain.train_step``
    on the O2 model of ``llama_pretrain.build_model`` (seed 0; the shard
    inside ``group``'s region when given, with the gradients and loss
    averaged over ``dp_group``), ``FusedAdam(lr=1e-3, state_dtype=bf16)``:
    the losses, each step's wall, issue time, mappings' collectives and
    launches (checked against ``per_step``), peak memory, a host copy of
    every parameter after the steps, and the model and optimizer."""
    import contextlib

    import torch
    from apex_tpu_torch.examples.llama_pretrain import (
        build_model,
        o2_cast,
        train_step,
    )
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.tensor_parallel import (
        mappings,
        tensor_parallel_region,
    )

    t0 = time.perf_counter()
    model = o2_cast(build_model(cfg, device=device, seed=0, group=group))
    opt = FusedAdam(model.parameters(), lr=1e-3, state_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    region = (contextlib.nullcontext() if group is None
              else tensor_parallel_region(group))
    step_ms, issue_ms, losses, collectives = [], [], [], []
    launches = {k.name: 0 for k in _dispatch.KERNELS}
    with region:
        losses.append(train_step(model, opt, ids, dp_group=dp_group))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TP_TRAIN_STEPS):
            before = {k.name: k.launches for k in _dispatch.KERNELS}
            calls0 = mappings.collective_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, ids, dp_group=dp_group))
            issue_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            collectives.append(mappings.collective_calls() - calls0)
            step = {k.name: k.launches - before[k.name]
                    for k in _dispatch.KERNELS}
            launches = {k: n + step[k] for k, n in launches.items()}
            if _nonzero(step) != per_step:
                form = "tp=None" if group is None else "tp 1"
                raise AssertionError(f"{form} training step {i} launched "
                                     f"{step}, expected {per_step}")
    return dict(losses=[float(l) for l in losses], step_ms=step_ms,
                step_ms_p50=statistics.median(step_ms), step_issue_ms=issue_ms,
                collectives_per_step=collectives, init_s=init_s,
                launches=launches,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                params={n: p.detach().cpu()
                        for n, p in model.named_parameters()},
                model=model, opt=opt)


def _host_profile(step_fn, step_ms: float) -> dict:
    """One call of ``step_fn`` under ``torch.profiler``: device busy time
    and idle share against the unprofiled ``step_ms``, and the host's own
    time in the collectives (NCCL and ``c10d`` rows) and in the tp
    mappings' autograd applies, forward and backward."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    comm = re.compile(r"nccl|record_param_comms|c10d::", re.IGNORECASE)
    apply = re.compile(r"\b_(Copy|Reduce|Gather|Scatter|SPScatter|SPGather|"
                       r"SPReduceScatter)(Backward)?\b")

    def host_ms(pattern):
        hits = [e for e in host if pattern.search(e.key)]
        return (sum(e.self_cpu_time_total for e in hits) / 1e3,
                sum(e.count for e in hits))

    comm_ms, comm_n = host_ms(comm)
    apply_ms, apply_n = host_ms(apply)
    return dict(
        traced_wall_ms=traced_ms, unprofiled_step_ms=step_ms,
        device_busy_ms=busy if kernels else "not measured",
        device_idle_share_unprofiled=(1 - busy / step_ms) if kernels
        else "not measured",
        collectives_host_ms=comm_ms, collectives_host_rows=comm_n,
        mapping_applies_host_ms=apply_ms, mapping_applies_host_rows=apply_n,
        top_host_ops=[(e.key[:70], e.count, e.self_cpu_time_total / 1e3)
                      for e in sorted(host, key=lambda e:
                                      -e.self_cpu_time_total)[:10]])


def llama_1b_train_tp(device, ref: dict, smi: str) -> dict:
    """Phase ``phase3-train-tp`` (see the module docstring): ``ref`` is
    what :func:`llama_1b_train` kept (``keep=``): the ``tp=None`` losses
    of the warm-up and ``TP_TRAIN_STEPS`` steps, every parameter after
    them and the launches a step.  The NCCL group of world 1 and its
    rendezvous directory go however the phase ends."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from apex_tpu_torch.examples.llama_pretrain import train_step
    from apex_tpu_torch.models import LlamaConfig
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import (
        broadcast_data,
        tensor_parallel_region,
        tp_replicated_rows,
    )

    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama_1b()
    b, s = 4, 2048
    batch = torch.randint(0, cfg.vocab_size, (b, s),
                          generator=torch.Generator().manual_seed(8))
    per_step = ref["per_step"]
    out = dict(nvidia_smi=smi, config="llama-1b", batch=b, seq=s,
               precision="O2: 2-d parameters bf16, norm scales fp32; "
                         "FusedAdam(lr=1e-3, state_dtype=bf16)",
               steps=f"1 warm-up + {TP_TRAIN_STEPS}")
    rdv = tempfile.mkdtemp(prefix="tp_train_rdv_")
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        out["sizes"] = ps.initialize_model_parallel(1)
        group, dp_group = (ps.get_tensor_model_parallel_group(),
                           ps.get_data_parallel_group())
        out["backend"] = str(dist.get_backend(group))
        # ---- a second tp=None run against the training phase's ----------
        none = _tp_train_run(cfg, device, batch.to(device), per_step)
        del none["model"], none["opt"]
        torch.cuda.empty_cache()
        spread = {n: float((none["params"][n].float()
                            - ref["params"][n].float()).abs().max())
                  for n in ref["params"]}
        none_equal = (none["losses"] == ref["losses"] and all(
            torch.equal(none["params"][n], ref["params"][n])
            for n in ref["params"]))
        log("phase3-train-tp-determinism", tp_none_runs_bitwise_equal=none_equal,
            losses_first_run=ref["losses"], losses_second_run=none["losses"],
            max_param_spread=max(spread.values()))
        # ---- tp 1: the model's shard, the batch's dp rows ----------------
        ids = broadcast_data(["ids"], {"ids": tp_replicated_rows(batch)},
                             torch.int64, group, device=device)["ids"]
        tp1 = _tp_train_run(cfg, device, ids, per_step, group, dp_group)
        if none_equal:
            bad = [n for n in ref["params"]
                   if not torch.equal(tp1["params"][n], ref["params"][n])]
            if tp1["losses"] != ref["losses"] or bad:
                raise AssertionError(
                    f"tp 1 differs from tp=None (two tp=None runs were bit "
                    f"for bit): losses {tp1['losses']} against "
                    f"{ref['losses']}, parameters {bad[:5]}")
            held = "bit for bit"
        else:
            bad = [n for n in ref["params"]
                   if float((tp1["params"][n].float() - ref["params"][n]
                             .float()).abs().max()) > spread[n]]
            loss_spread = max(abs(a - c) for a, c in
                              zip(none["losses"], ref["losses"]))
            loss_err = max(abs(a - c) for a, c in
                           zip(tp1["losses"], ref["losses"]))
            if bad or loss_err > loss_spread:
                raise AssertionError(
                    f"tp 1 outside the two tp=None runs' spread: losses "
                    f"{loss_err} > {loss_spread}, parameters {bad[:5]}")
            held = "within the two tp=None runs' spread"
        dp_reductions = len({p.grad.dtype for p in tp1["model"].parameters()
                             if p.grad is not None}) + 1
        with tensor_parallel_region(group):
            prof = _host_profile(
                lambda: train_step(tp1["model"], tp1["opt"], ids,
                                   dp_group=dp_group), tp1["step_ms_p50"])
        out["tp1_against_none"] = held
        out["tp_none_runs_bitwise_equal"] = none_equal
        out["max_param_spread_between_none_runs"] = max(spread.values())
        out["losses"] = dict(tp_none_first=ref["losses"],
                             tp_none_second=none["losses"],
                             tp1=tp1["losses"])
        out["launches_per_step"] = per_step
        out["collectives_per_step"] = tp1["collectives_per_step"]
        out["dp_all_reduces_per_step"] = dp_reductions
        out["step_ms"] = dict(tp_none=none["step_ms"], tp1=tp1["step_ms"])
        out["step_ms_p50"] = dict(tp_none=none["step_ms_p50"],
                                  tp1=tp1["step_ms_p50"])
        out["step_p50_ratio_tp1_to_none"] = (tp1["step_ms_p50"]
                                             / none["step_ms_p50"])
        out["step_issue_ms"] = dict(tp_none=none["step_issue_ms"],
                                    tp1=tp1["step_issue_ms"])
        out["peak_mem_bytes"] = dict(tp_none=none["peak_mem_bytes"],
                                     tp1=tp1["peak_mem_bytes"])
        out["init_s"] = dict(tp_none=none["init_s"], tp1=tp1["init_s"])
        out["profile_tp1"] = prof
        out["launches"] = tp1["launches"]
        log("phase3-train-tp", **out)
        del tp1, none
        torch.cuda.empty_cache()
        # ---- fp16 amp O2 under GradScaler in the region ------------------
        amp_out = llama_1b_amp_train(device, "adam", group=group,
                                     dp_group=dp_group, steps=TP_AMP_STEPS,
                                     tag="phase3-train-tp-amp")
        out["amp"] = amp_out
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-train-tp-done", phase_s=out["phase_s"])
    return out


# ---------------------------------------------------------------------------
# phase 3: pipeline-parallel training (make_llama_3d_train_step at pp 1)
# ---------------------------------------------------------------------------

PP_STEPS = 3            # steps after one warm-up, each schedule
PP_N_MICRO = 4          # microbatches of 1 x 2048: the training phase's b 4
# 1F1B against no_pipelining: the same microbatches, gradients summed in
# bf16 (1F1B, the parameters' dtype) against fp32 (no_pipelining); the
# warm-up loss is computed before any update.  On an H100 at 700 W the
# sound runs differ by at most 1.6e-3 over steps 1-3, and no_pipelining
# with microbatch 0's gradient dropped by 0.071 at step 1 (1.13 at step 3)
PP_WARMUP_LOSS_TOL = 1e-5
PP_LOSS_TOL = 1e-2
# the pipeline's vocab-parallel loss (fp32 logits) against
# LlamaForCausalLM's fused head on the same weights and batch (b 1 calls
# against one b 4 call): 1.9e-6 there (2 ulp of the loss), and 1.1e-5
# with the head's product in bf16
PP_HEAD_LOSS_TOL = 5e-6
PP_PEAK_TOL = 0.05      # peak memory at n_micro 2 against 4, relative
PP_AMP_STEPS = 2        # amp steps after one warm-up; an inf at the last


class _DistCalls:
    """Counts the ``torch.distributed`` collectives and point-to-point
    batches issued inside the block (each is one NCCL call under an NCCL
    group), by patching the module's functions and restoring them."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "broadcast", "barrier",
             "batch_isend_irecv")

    def __enter__(self):
        import torch.distributed as dist

        self.counts = {}
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def wrap(name, fn):
            def counted(*a, **k):
                self.counts[name] = self.counts.get(name, 0) + 1
                return fn(*a, **k)
            return counted

        for n, fn in self.saved.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def _pp_run(pcfg, device, batches, schedule, per_step, *, steps=PP_STEPS):
    """``init_fn(0)`` and 1 warm-up + ``steps`` steps of
    ``make_llama_3d_train_step(pcfg, FusedAdam(lr=1e-3, state_dtype=bf16),
    schedule, cast=o2_cast)``: losses, each step's wall, issue time,
    launches (checked against ``per_step``), mappings' collectives,
    point-to-point batches and ``torch.distributed`` calls, peak memory,
    a host copy of every parameter after the steps, and what the step
    needs again (``spec``, ``opt``, ``train_step``)."""
    import functools

    import torch
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.models import make_llama_3d_train_step
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p,
    )
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    t0 = time.perf_counter()
    init_fn, train_step = make_llama_3d_train_step(
        pcfg, functools.partial(FusedAdam, lr=1e-3,
                                state_dtype=torch.bfloat16),
        schedule, device=device, cast=o2_cast)
    spec, opt = init_fn(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses = [train_step(spec, opt, batches)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, issue_ms, collectives, p2p_calls, dist_calls = [], [], [], [], []
    launches = {k.name: 0 for k in _dispatch.KERNELS}
    for i in range(steps):
        before = {k.name: k.launches for k in _dispatch.KERNELS}
        calls0, p0 = mappings.collective_calls(), p2p.p2p_calls()
        torch.cuda.synchronize()
        with _DistCalls() as dc:
            t0 = time.perf_counter()
            losses.append(train_step(spec, opt, batches))
            issue_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        collectives.append(mappings.collective_calls() - calls0)
        p2p_calls.append(p2p.p2p_calls() - p0)
        dist_calls.append(dict(dc.counts, total=dc.total))
        step = {k.name: k.launches - before[k.name] for k in _dispatch.KERNELS}
        launches = {k: n + step[k] for k, n in launches.items()}
        if _nonzero(step) != per_step:
            raise AssertionError(f"{schedule.__name__} step {i} launched "
                                 f"{step}, expected {per_step}")
    return dict(losses=[float(l) for l in losses], step_ms=step_ms,
                step_ms_p50=statistics.median(step_ms), step_issue_ms=issue_ms,
                mapping_collectives_per_step=collectives,
                p2p_calls_per_step=p2p_calls,
                dist_calls_per_step=dist_calls, init_s=init_s,
                launches=launches,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                params={n: p.detach().to("cpu", copy=True)
                        for n, p in spec.named_parameters()},
                spec=spec, opt=opt, train_step=train_step)


def _drop_first_microbatch(schedule):
    """``schedule`` with microbatch 0's gradient dropped (its loss still
    counted, by a forward-only call): the off-by-one of a wrong
    accumulation, whose losses the loss gate must refuse."""

    def dropped(spec, batches, **kw):
        n = batches["ids"].shape[0]
        first = {k: v[:1] for k, v in batches.items()}
        rest = {k: v[1:] for k, v in batches.items()}
        loss0, _ = schedule(spec, first, forward_only=True, **kw)
        loss, grads = schedule(spec, rest, **kw)
        return (loss0 + (n - 1) * loss) / n, grads

    return dropped


def _pp_head_readings(pcfg, device, batches) -> dict:
    """The mean loss of the stage on the seeded init, before any update,
    with its head two ways: as the configuration runs it
    (``parallel_lm_logits``: the final norm's output and ``lm_head`` up
    to fp32, fp32 logits) and with the same product in bf16 (both
    operands bf16, the logits rounded to bf16), the loss in fp32 both
    times: what the head gate reads of a head computed in bf16."""
    import functools

    import torch
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.models import make_llama_3d_train_step
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import (
        parallel_lm_logits,
        tensor_parallel_region,
        vocab_parallel_cross_entropy,
    )

    init_fn, _ = make_llama_3d_train_step(
        pcfg, functools.partial(FusedAdam, lr=1e-3,
                                state_dtype=torch.bfloat16),
        None, device=device, cast=o2_cast)
    spec, _ = init_fn(0)
    head = spec.last
    sums = {"fp32": 0.0, "bf16": 0.0}
    n = batches["ids"].shape[0]
    with torch.no_grad(), tensor_parallel_region(
            ps.get_tensor_model_parallel_group()):
        for i in range(n):
            mb = {k: v[i] for k, v in batches.items()}
            y = head.norm(spec.stage(spec.first(mb)))
            for key, logits in (
                    ("fp32", parallel_lm_logits(y, head.lm_head)),
                    ("bf16", torch.matmul(y.bfloat16(),
                                          head.lm_head.bfloat16().t()))):
                sums[key] += float(vocab_parallel_cross_entropy(
                    logits.float().transpose(0, 1), mb["labels"]).mean())
    del spec, head
    return {k: v / n for k, v in sums.items()}


def _pp_amp(pcfg, device, batches) -> dict:
    """fp16 amp O2 (the O2 policy's cast on the stage modules, fp32
    masters) under ``GradScaler``: 1 warm-up + ``PP_AMP_STEPS`` steps of
    the 1F1B 3-d step, an inf written into one gradient after the
    schedule at the last step, which runs under
    ``set_sync_debug_mode("error")``: every parameter, master and moment
    keeps its bits and the scale halves."""
    import functools

    import torch
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import make_llama_3d_train_step
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.amp import GradScaler
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_1f1b,
    )

    poison = [False]

    def poisoned(spec, batches, **kw):
        res = forward_backward_pipelining_1f1b(spec, batches, **kw)
        if poison[0]:
            # a fill: an indexed store of a host scalar copies it over
            next(iter(spec.parameters())).grad.view(-1)[:1].fill_(
                float("inf"))
        return res

    policy = get_policy("O2", half_dtype=torch.float16)
    scaler = GradScaler.from_scaler(policy.make_scaler())
    init_fn, train_step = make_llama_3d_train_step(
        pcfg, functools.partial(FusedAdam, lr=AMP_LR, master_weights=True),
        poisoned, device=device, cast=policy.cast_params, grad_scaler=scaler)
    spec, opt = init_fn(0)
    state = scaler.init(device)
    results, step_ms = [], []
    for i in range(PP_AMP_STEPS + 1):
        forced = i == PP_AMP_STEPS
        if forced:
            params = spec.parameters()
            snap = [p.detach().clone() for p in params] + [
                t.detach().clone() for p in params
                for t in opt.state[p].values()]
            poison[0] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if forced:
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss, found, state = train_step(spec, opt, batches, state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        results.append((loss, found, state))
    after = [p.detach() for p in params] + [
        t.detach() for p in params for t in opt.state[p].values()]
    kept = all(torch.equal(a, b) for a, b in zip(after, snap))
    del snap
    losses = [float(l) for l, _, _ in results]
    founds = [bool(f) for _, f, _ in results]
    scales = [float(s.scale) for _, _, s in results]
    halved = scales[-1] == max(scales[-2] / 2, 1.0)
    out = dict(precision="amp O2 fp16 (norm scales fp32), fp32 masters, "
                         "GradScaler from 2**16",
               losses=losses, found_inf=founds, scales=scales,
               forced_step=PP_AMP_STEPS, forced_kept_every_bit=kept,
               forced_halved_scale=halved, step_ms=step_ms,
               sync_check="set_sync_debug_mode('error') over the whole "
                          "forced step")
    log("phase3-train-pp-amp", **out)
    if not (kept and halved and founds[-1]):
        raise AssertionError(f"pp amp: the forced overflow step kept every "
                             f"bit {kept}, halved the scale {halved} "
                             f"({scales}), found {founds}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"pp amp losses {losses}")
    del spec, opt
    return out


def llama_1b_train_pp(device, ref: dict, smi: str) -> dict:
    """Phase ``phase3-train-pp`` (see the module docstring): ``ref`` is
    what :func:`llama_1b_train` kept (its warm-up loss is
    ``LlamaForCausalLM``'s on the same weights and batch).  The NCCL
    group of world 1 and its rendezvous directory go however the phase
    ends."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from apex_tpu_torch.models import LlamaConfig, LlamaPipeConfig
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_1f1b,
        get_forward_backward_func,
    )

    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama_1b()
    b, s = PP_N_MICRO, 2048
    batch = torch.randint(0, cfg.vocab_size, (b, s),
                          generator=torch.Generator().manual_seed(8))
    # microbatch i is row i of the training phase's batch
    batches = {"ids": batch[:, None].to(device),
               "labels": torch.roll(batch, -1, dims=1)[:, None].to(device)}
    layers = cfg.num_hidden_layers
    n = PP_N_MICRO
    # the 1F1B forward tick runs the stage under no_grad, and its backward
    # tick runs it again with grad before the backward
    per_1f1b = {ln.LAYER_NORM_FWD.name: 2 * (2 * layers + 1) * n,
                ln.LAYER_NORM_BWD.name: (2 * layers + 1) * n,
                fa.FLASH_ATTENTION_FWD.name: 2 * layers * n,
                fa.FLASH_ATTENTION_DQ.name: layers * n,
                fa.FLASH_ATTENTION_DKV.name: layers * n,
                mt.MT_ADAM.name: 1}
    per_none = dict(per_1f1b, **{ln.LAYER_NORM_FWD.name: (2 * layers + 1) * n,
                                 fa.FLASH_ATTENTION_FWD.name: layers * n})
    # microbatch 0 forward only, the other three forward and backward
    per_dropped = dict(per_none, **{
        k.name: per_none[k.name] * (n - 1) // n
        for k in (ln.LAYER_NORM_BWD, fa.FLASH_ATTENTION_DQ,
                  fa.FLASH_ATTENTION_DKV)})
    pcfg = LlamaPipeConfig(config=cfg, layers_per_stage=layers,
                           sequence_parallel_enabled=False)
    out = dict(nvidia_smi=smi, config="llama-1b", n_micro=n, micro_batch=1,
               seq=s, precision="O2: 2-d parameters bf16, norm scales fp32; "
                                 "FusedAdam(lr=1e-3, state_dtype=bf16)",
               steps=f"1 warm-up + {PP_STEPS}", world="dp 1 x pp 1 x tp 1")
    rdv = tempfile.mkdtemp(prefix="pp_train_rdv_")
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        out["sizes"] = ps.initialize_model_parallel(1, 1)
        out["backend"] = str(dist.get_backend(
            ps.get_pipeline_model_parallel_group()))
        none_fn = get_forward_backward_func(None, 1)
        runs = {}
        for key, fn, per in (("1f1b", forward_backward_pipelining_1f1b,
                              per_1f1b),
                             ("1f1b_again", forward_backward_pipelining_1f1b,
                              per_1f1b),
                             ("no_pipelining", none_fn, per_none),
                             ("dropped_microbatch",
                              _drop_first_microbatch(none_fn), per_dropped)):
            run = _pp_run(pcfg, device, batches, fn, per)
            if key == "1f1b":
                # one more step traced, and its torch.distributed calls
                with _DistCalls() as dc:
                    prof = _host_profile(
                        lambda: run["train_step"](run["spec"], run["opt"],
                                                  batches),
                        run["step_ms_p50"])
            if key == "1f1b_again":
                # peak memory of one more step at 2 microbatches, then 4
                for m in (2, 4):
                    half = {k: v[:m] for k, v in batches.items()}
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    run["train_step"](run["spec"], run["opt"], half)
                    torch.cuda.synchronize()
                    run[f"peak_n_micro_{m}"] = torch.cuda.max_memory_allocated()
            del run["spec"], run["opt"], run["train_step"]
            runs[key] = run
            torch.cuda.empty_cache()
        one, two, none = runs["1f1b"], runs["1f1b_again"], runs["no_pipelining"]
        # the wrong accumulation's reading: what the loss gate must refuse
        wrong = runs.pop("dropped_microbatch")
        wrong_loss_err = [abs(a - c) for a, c in zip(one["losses"],
                                                       wrong["losses"])]
        del wrong["params"]
        bitwise = one["losses"] == two["losses"] and all(
            torch.equal(one["params"][k], two["params"][k])
            for k in one["params"])
        loss_err = [abs(a - c) for a, c in zip(one["losses"],
                                                 none["losses"])]
        param_err = max(float((one["params"][k].float()
                               - none["params"][k].float()).abs().max())
                        for k in one["params"])
        head_err = abs(one["losses"][0] - ref["losses"][0])
        heads = _pp_head_readings(pcfg, device, batches)
        head_err_bf16 = abs(heads["bf16"] - ref["losses"][0])
        torch.cuda.empty_cache()
        peak2, peak4 = two["peak_n_micro_2"], two["peak_n_micro_4"]
        peak_rel = abs(peak4 - peak2) / peak4
        # the 2-d tp=None step in this call, for its wall
        ids = batch.to(device)
        plain = _tp_train_run(cfg, device, ids, ref["per_step"])
        del plain["model"], plain["opt"], plain["params"]
        torch.cuda.empty_cache()
        out.update(
            losses={k: r["losses"] for k, r in runs.items()},
            losses_llama_for_causal_lm=ref["losses"],
            runs_1f1b_bitwise_equal=bitwise,
            loss_err_1f1b_vs_no_pipelining=loss_err,
            max_param_err_1f1b_vs_no_pipelining=param_err,
            losses_dropped_microbatch=wrong["losses"],
            loss_err_1f1b_vs_dropped_microbatch=wrong_loss_err,
            warmup_loss_err_vs_llama_for_causal_lm=head_err,
            warmup_loss_head_readings=heads,
            warmup_loss_err_bf16_head_vs_llama_for_causal_lm=head_err_bf16,
            tolerances=dict(warmup_loss=PP_WARMUP_LOSS_TOL, loss=PP_LOSS_TOL,
                            head_loss=PP_HEAD_LOSS_TOL, peak=PP_PEAK_TOL),
            launches_per_step={"1f1b": per_1f1b, "no_pipelining": per_none},
            launches={k: r["launches"] for k, r in runs.items()},
            p2p_calls_per_step={k: r["p2p_calls_per_step"]
                                for k, r in runs.items()},
            mapping_collectives_per_step={
                k: r["mapping_collectives_per_step"] for k, r in runs.items()},
            dist_calls_per_step={k: r["dist_calls_per_step"]
                                 for k, r in runs.items()},
            dist_calls_profiled_step=dict(dc.counts, total=dc.total),
            step_ms={k: r["step_ms"] for k, r in runs.items()},
            step_ms_p50=dict(one_f1b=one["step_ms_p50"],
                             one_f1b_again=two["step_ms_p50"],
                             no_pipelining=none["step_ms_p50"],
                             tp_none=plain["step_ms_p50"]),
            step_p50_ratio_1f1b_to_tp_none=(one["step_ms_p50"]
                                            / plain["step_ms_p50"]),
            step_issue_ms={k: r["step_issue_ms"] for k, r in runs.items()},
            peak_mem_bytes=dict({k: r["peak_mem_bytes"]
                                 for k, r in runs.items()},
                                tp_none=plain["peak_mem_bytes"],
                                n_micro_2=peak2, n_micro_4=peak4),
            peak_rel_diff_n_micro_2_vs_4=peak_rel,
            init_s={k: r["init_s"] for k, r in runs.items()},
            profile_1f1b=prof)
        log("phase3-train-pp", **out)
        falling = all(r["losses"][-1] < r["losses"][0]
                      and all(map(math.isfinite, r["losses"]))
                      for r in runs.values())
        bad = []
        if not falling:
            bad.append("losses not finite and falling")
        if not bitwise:
            bad.append("two 1F1B runs differ")
        if loss_err[0] > PP_WARMUP_LOSS_TOL or max(loss_err) > PP_LOSS_TOL:
            bad.append(f"1F1B vs no_pipelining losses {loss_err}")
        if head_err > PP_HEAD_LOSS_TOL:
            bad.append(f"warm-up loss vs LlamaForCausalLM {head_err}")
        # each gate refuses the fault it is set against
        if max(wrong_loss_err) <= PP_LOSS_TOL:
            bad.append(f"the loss gate passes a dropped microbatch "
                       f"{wrong_loss_err}")
        if head_err_bf16 <= PP_HEAD_LOSS_TOL:
            bad.append(f"the head gate passes a bf16 head {head_err_bf16}")
        if any(c for r in runs.values() for c in r["p2p_calls_per_step"]):
            bad.append("point-to-point calls at pp 1")
        if peak_rel >= PP_PEAK_TOL:
            bad.append(f"peak memory n_micro 2 {peak2} vs 4 {peak4}")
        if bad:
            raise AssertionError("phase3-train-pp: " + "; ".join(bad))
        for r in runs.values():
            del r["params"]
        out["amp"] = _pp_amp(pcfg, device, batches)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-train-pp-done", phase_s=out["phase_s"])
    return out


def _nonzero(counts: dict) -> dict:
    """The kernels that launched, with their counts."""
    return {k: n for k, n in counts.items() if n}


def _kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its name: one of the port's kernels,
    cuBLAS, or PyTorch's own elementwise, copy and reduction kernels."""
    for key, kind in (("mt_l2norm", "multi-tensor l2norm"),
                      ("mt_scale", "multi-tensor scale"),
                      ("mt_adam", "multi-tensor Adam"),
                      ("mt_lamb", "multi-tensor LAMB"),
                      ("pair_bias_fwd", "pair-bias forward"),
                      ("pair_bias_dq", "pair-bias dq"),
                      ("pair_bias_dkv", "pair-bias dk/dv"),
                      ("pair_bias_dbias", "pair-bias dbias"),
                      ("flash_fwd", "flash forward"), ("flash_dq", "flash dq"),
                      ("flash_dkv", "flash dk/dv"), ("ln_fwd", "norm forward"),
                      ("ln_bwd", "norm backward"), ("lm_head", "head forward"),
                      ("PartialsStore", "head forward"),
                      ("DlogStore", "head logits + dlog"),
                      ("namespace)::dlog_f32", "head logits + dlog"),
                      ("TileStore", "head dH/dE products"),
                      # not cuBLAS's xmma_gemm_f32f32 kernels
                      ("namespace)::gemm_f32", "head dH/dE products"),
                      ("softmax_fwd_kernel", "softmax forward"),
                      ("softmax_bwd_kernel", "softmax backward"),
                      ("lamb_phase1_kernel", "LAMB phase 1")):
        if key in name:
            return kind
    if any(k in name for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "cuDNN"
    if "nvjet" in name or "gemm" in name or "xmma" in name or "cutlass" in name:
        return "cuBLAS"
    if "copy" in name:
        return "copies and casts"
    if "reduce" in name:
        return "reductions"
    return "elementwise"


def _step_phases(model, opt, ids, repeats: int = 3) -> dict:
    """``repeats`` more steps, each split into its phases (the forward and
    loss, the backward, the optimizer) on the host clock: ``*_ms`` ends in
    a synchronize, ``*_issue_ms`` when the host has issued the phase's
    work, ``*_cpu_ms`` is the process's CPU time while it issued.  A phase
    whose issue time is near its wall is host-bound; one whose CPU time is
    well under its issue time waited for a core (or for the device)."""
    import torch

    labels = torch.roll(ids, -1, dims=1)
    out = {}
    for _ in range(repeats):
        opt.zero_grad(set_to_none=True)
        for name, fn in (
                ("forward", lambda: model(ids, labels=labels).mean()),
                ("backward", lambda: loss.backward()),
                ("optimizer", lambda: opt.step())):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            res = fn()
            t1, c1 = time.perf_counter(), time.process_time()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if name == "forward":
                loss = res
            for key, v in ((f"{name}_ms", t2 - t0), (f"{name}_issue_ms", t1 - t0),
                           (f"{name}_cpu_ms", c1 - c0)):
                out.setdefault(key, []).append(v * 1e3)
    return out


def _profile(step_fn, step_ms: float) -> dict:
    """One call of ``step_fn`` (a training step) traced with
    ``torch.profiler``: device busy time (the kernels' summed self time)
    against the traced wall and the unprofiled median step (``step_ms``),
    device time by kind of kernel, and the kernels that take most."""
    return _device_profile(*_traced_kernels(step_fn), step_ms)


def _device_profile(traced_ms: float, kernels: list, step_ms: float) -> dict:
    """``_profile``'s reading of one traced step's kernel rows."""
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
    by_kind = {}
    for e in kernels:
        kind = _kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    return dict(
        traced_wall_ms=traced_ms, unprofiled_step_ms=step_ms,
        device_ms_by_kind=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        device_idle_share_unprofiled=(1 - busy_ms / step_ms) if kernels
        else "not measured",
        device_busy_ms=busy_ms if kernels else "not measured",
        device_idle_share_traced=(1 - busy_ms / traced_ms) if kernels
        else "not measured",
        top_kernels=[(e.key[:80], e.count, e.self_device_time_total / 1e3)
                     for e in top])


def profile_train(model, opt, ids, step_ms: float,
                  tag: str = "phase3-train-profile") -> dict:
    """One training step traced (``_profile``), and three more steps split
    into their phases on the host clock."""
    from apex_tpu_torch.examples.llama_pretrain import train_step

    out = _profile(lambda: train_step(model, opt, ids), step_ms)
    out["phases_ms"] = _step_phases(model, opt, ids)
    log(tag, **out)
    return out


def small_gpt_check(device) -> dict:
    """A small fp32 GPT (2 layers, hidden 128, 2 heads of 64, vocab 512,
    b 2 x s 128) in both attention cores, flash and the fused softmax: the
    same weights on the card and on the CPU give the ``labels=`` loss and
    every parameter's gradient (the tied embedding's included), then the
    losses and parameters of 3 ``FusedLAMB(packed=True)`` steps (lr 1e-3),
    each within its stated tolerance (:func:`_card_vs_cpu`)."""
    import torch
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.testing import GPTModel

    cfg = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
               vocab_size=512, max_sequence_length=128)
    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(35))
    out = {}
    for flash in (True, False):
        def build(dev, flash=flash):
            return GPTModel(**cfg, use_flash_attention=flash, device=dev,
                            generator=torch.Generator().manual_seed(36)
                            if dev == "cpu" else None)

        out["flash" if flash else "fused_softmax"] = _card_vs_cpu(
            f"small GPT (flash={flash})", build,
            functools.partial(_labels_loss, ids),
            lambda ps: FusedLAMB(ps, lr=1e-3, packed=True), 1e-3, device)
    out["tolerance"] = SMALL_CARD_TOL
    log("phase3-gpt-reference", **out)
    return out


def gpt2_large_train(device, form: str) -> dict:
    """GPT-2-large training (``bench.py``'s ``large`` card: 36 x 1280, 20
    heads, vocab 50304, b 8 x s 1024), fp32 init from a seeded generator on
    the card, O2 cast, ``FusedLAMB(lr=1e-3)``, one fixed batch with labels
    the ids rolled by one; 1 warm-up step, then 6 timed steps with the
    launches of each step checked exactly, in one of two forms:

    - ``"kernel"``: the materialized attention core (the fused softmax
      kernels) and the packed LAMB (the phase-1 kernel, fp32 flat moments);
    - ``"flagship"``: flash attention and the unpacked LAMB with bf16
      moments, as ``bench.py`` runs it.

    A finite loss falling every step; step wall, tokens/s, MFU against
    989 TFLOP/s, peak memory and a profile of one step."""
    import torch
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.ops import packed_update as pu
    from apex_tpu_torch.ops import softmax as sm

    c = gpt_pretrain.LARGE
    kernel_path = form == "kernel"
    model, opt = gpt_pretrain.build(c["layers"], c["hidden"], c["heads"],
                                    c["vocab"], c["seq"], flash=not kernel_path,
                                    packed_lamb=kernel_path, device=device)
    b, s, layers = c["batch"], c["seq"], c["layers"]
    ids = torch.randint(0, c["vocab"], (b, s),
                        generator=torch.Generator().manual_seed(8)).to(device)
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                lh.FUSED_LM_HEAD_FWD.name: 1,
                lh.FUSED_LM_HEAD_DH.name: 1,
                lh.FUSED_LM_HEAD_DE.name: 1}
    if kernel_path:
        # the clip norm, phase 1, then phase 2's per-leaf norms and apply
        per_step.update({sm.SCALED_SOFTMAX_FWD.name: layers,
                         sm.SCALED_SOFTMAX_BWD.name: layers,
                         pu.LAMB_PHASE1.name: 1, mt.MT_L2NORM.name: 2,
                         mt.MT_LAMB.name: 1})
    else:
        # the clip norm, then both LAMB stages in one call
        per_step.update({fa.FLASH_ATTENTION_FWD.name: layers,
                         fa.FLASH_ATTENTION_DQ.name: layers,
                         fa.FLASH_ATTENTION_DKV.name: layers,
                         mt.MT_L2NORM.name: 1, mt.MT_LAMB.name: 1})
    run = _train_steps(lambda: gpt_pretrain.train_step(model, opt, ids),
                       TRAIN_STEPS, per_step, f"GPT-2-large ({form})",
                       every_step=True)
    n = sum(p.numel() for p in model.parameters())
    if n != gpt2_large_numel()[0]:
        raise AssertionError(f"GPT-2-large has {n} parameters, the phase-2 "
                             f"LAMB buffers assumed {gpt2_large_numel()[0]}")
    # bench.py:2423's model FLOPs: 6 N a token plus the causal attention
    # term 12 L h s / 2, times the tokens
    flops = float((6 * n + 12 * layers * c["hidden"] * s // 2) * b * s)
    med = run["step_ms_median"]
    out = dict(config="gpt2-large", form=form,
               attention="materialized (fused softmax kernels)" if kernel_path
               else "flash", optimizer="FusedLAMB(lr=1e-3, packed=True), fp32 "
               "flat moments" if kernel_path else "FusedLAMB(lr=1e-3, "
               "state_dtype=bf16), unpacked",
               batch=b, seq=s, tokens=b * s,
               precision="O2: 2-d parameters bf16, biases and LayerNorm fp32",
               params=n, **run,
               tokens_per_s=b * s / (med / 1e3), flops_per_step=flops,
               bound_ms=flops / 989e12 * 1e3,
               mfu=flops / (med / 1e3) / 989e12,
               mt_table_bytes=mt_table_bytes())
    log(f"phase3-gpt-{form}", **out)
    out["profile"] = profile_train(model, opt, ids, med,
                                   tag=f"phase3-gpt-{form}-profile")
    del model, opt
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: mixed precision (amp O2, fp16, the dynamic loss scaler)
# ---------------------------------------------------------------------------

AMP_LR = 1e-3
AMP_FORCED = 2      # the timed step whose gradients get an inf written in


class AmpTrainer:
    """The amp O2 fp16 step of ``examples/simple`` on a Llama behind
    ``amp.initialize``, with one of three optimizer forms:

    - ``adam``: ``FusedAdam(master_weights=True)`` (plain PyTorch);
    - ``adagrad``: ``FusedAdagrad(packed=True, master_weights=True)``, the
      packed Adagrad kernel over the group's flat fp32 masters;
    - ``packed_adam``: the masters packed once into one flat fp32 buffer
      with flat moments, each step ``packed_adam_update(...,
      noop_flag=found_inf)`` (the packed Adam kernel, as
      ``tests/test_dense_mlp.py`` drives the JAX one), the masters then
      copied back into the parameters.

    A step: the loss's mean (fp16, O2's output cast) scaled in fp32, its
    backward, optionally an inf written into one gradient, then
    ``found_inf``, the optimizer step with ``grad_scale`` and ``found_inf``
    and the scaler's update, those three on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises).

    With ``dp_group`` (a tensor-parallel model, stepped inside its region)
    the scaler is ``transformer.amp.GradScaler`` (its overflow flag
    all-reduced over the tp group) and the gradients are averaged over
    ``dp_group`` first (``tensor_parallel.all_reduce_gradients``), both under
    the same sync check."""

    def __init__(self, model, form: str, dp_group=None):
        import torch
        from apex_tpu_torch import amp
        from apex_tpu_torch.optimizers import FusedAdagrad, FusedAdam
        from apex_tpu_torch.utils.packing import make_packed_spec, pack_pytree

        self.device = next(model.parameters()).device
        self.amped = amp.initialize(model, "O2", half_dtype=torch.float16)
        self.model, self.form = model, form
        self.params = list(model.parameters())
        self.scaler, self.state = self.amped.scaler, self.amped.scaler_state
        self.dp_group = dp_group
        if dp_group is not None:
            from apex_tpu_torch.transformer.amp import GradScaler

            self.scaler = GradScaler.from_scaler(self.scaler)
        self.opt = None
        if form == "adam":
            self.opt = FusedAdam(self.params, lr=AMP_LR, master_weights=True)
        elif form == "adagrad":
            self.opt = FusedAdagrad(self.params, lr=AMP_LR, master_weights=True,
                                    packed=True)
        elif form == "packed_adam":
            with torch.no_grad():
                self.spec = make_packed_spec(self.params)
                self.flat = pack_pytree(self.params, dtype=torch.float32).flat
            self.m = torch.zeros_like(self.flat)
            self.v = torch.zeros_like(self.flat)
            self.step_count = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        else:
            raise ValueError(f"unknown form {form!r}")

    def _packed_adam(self, found_inf, scale):
        import torch
        from apex_tpu_torch.ops.packed_update import packed_adam_update
        from apex_tpu_torch.optimizers._common import bias_corrections, commit
        from apex_tpu_torch.utils.packing import pack_pytree

        flat_g = pack_pytree([p.grad for p in self.params],
                             dtype=torch.float32).flat
        flat_g.mul_(1.0 / scale)
        nxt = self.step_count + 1
        bc1, bc2 = bias_corrections(nxt, 0.9, 0.999)
        packed_adam_update(flat_g, self.flat, self.m, self.v, lr=AMP_LR,
                           beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                           bias_correction1=bc1, bias_correction2=bc2,
                           noop_flag=found_inf)
        commit(self.step_count, nxt, found_inf)
        for p, o, n in zip(self.params, self.spec.offsets, self.spec.sizes):
            p.copy_(self.flat[o:o + n].view_as(p))

    def step(self, ids, labels, force_inf: bool = False):
        """One step; returns ``(loss, found_inf, scaler_state)``, device
        tensors (nothing is read on the host)."""
        import torch

        self.model.zero_grad(set_to_none=True)
        loss = self.amped.model(ids, labels=labels).mean()
        state = self.state
        self.scaler.scale_loss(loss, state).backward()
        if force_inf:
            self.params[0].grad.view(-1)[0] = float("inf")
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if self.dp_group is not None:
                from apex_tpu_torch.transformer.tensor_parallel import (
                    all_reduce_gradients,
                )

                all_reduce_gradients(
                    [p.grad for p in self.params if p.grad is not None],
                    self.dp_group, average=True)
            found = self.scaler.has_overflow([p.grad for p in self.params])
            with torch.no_grad():
                if self.opt is not None:
                    self.opt.step(grad_scale=state.scale, found_inf=found)
                else:
                    self._packed_adam(found, state.scale)
            self.state = self.scaler.update(state, found)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        return loss.detach(), found, self.state

    def tensors(self) -> dict:
        """Every tensor a step writes: parameters, masters, optimizer state
        and step counter."""
        out = {f"param.{i}": p for i, p in enumerate(self.params)}
        if self.opt is None:
            out.update(masters=self.flat, exp_avg=self.m, exp_avg_sq=self.v,
                       step=self.step_count)
            return out
        for i, p in enumerate(self.params):
            for k, t in self.opt.state[p].items():
                out[f"{k}.{i}"] = t
        return out

    def masters(self) -> list:
        if self.opt is None:
            return [self.flat[o:o + n].view_as(p) for p, o, n in
                    zip(self.params, self.spec.offsets, self.spec.sizes)]
        return [self.opt.state[p]["master_param"] for p in self.params]


def small_amp_check(device) -> dict:
    """A small Llama (fp32 weights, head dim 64, 2 layers) under
    ``amp.initialize(..., "O2", half_dtype=torch.float16)`` and the
    dynamic scaler, ``FusedAdam(master_weights=True)``, 4 steps on the card
    and on the CPU from the same weights: step 0 overflows on its own (the
    mean's cotangent, 2**16, is past fp16's largest value), step 2 by an
    inf written into one gradient.  Card against CPU at every step: the
    loss, ``found_inf`` and every scaler field; after the steps the masters,
    the moments and the parameters."""
    import torch
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256)
    ids = torch.randint(0, 512, (2, 100), generator=torch.Generator().manual_seed(9))
    cpu_model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(11))
    gpu_model = LlamaForCausalLM(cfg, device=device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    steps, forced = 4, 2
    res = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("cuda", gpu_model, device)):
        tr = AmpTrainer(model, "adam")
        x = ids.to(dev)
        y = torch.roll(x, -1, dims=1)
        log_, g1 = [], None
        for i in range(steps):
            scale = tr.state.scale
            loss, found, st = tr.step(x, y, force_inf=(i == forced))
            if g1 is None and not bool(found):
                # the first applied step's unscaled gradients, for the bound
                g1 = [p.grad.float().cpu() / float(scale) for p in tr.params]
            log_.append((float(loss), bool(found),
                         [t.item() for t in st]))
        res[name] = dict(log=log_, g1=g1,
                         masters=[m.detach().cpu() for m in tr.masters()],
                         m=[tr.opt.state[p]["exp_avg"].cpu() for p in tr.params],
                         v=[tr.opt.state[p]["exp_avg_sq"].cpu() for p in tr.params],
                         params=[p.detach().cpu() for p in tr.params])
    c, d = res["cpu"], res["cuda"]
    flags = [f for _, f, _ in c["log"]]
    if flags != [True, False, True, False] or \
            [f for _, f, _ in d["log"]] != flags:
        raise AssertionError(f"small amp: found_inf card {d['log']} CPU "
                             f"{c['log']}")
    loss_ratio = max(abs(a[0] - b[0]) / (2.0 ** -8 * abs(b[0]))
                     for a, b in zip(d["log"], c["log"]))
    if loss_ratio > 1.0 or [s for _, _, s in d["log"]] != \
            [s for _, _, s in c["log"]]:
        raise AssertionError(f"small amp: card {d['log']} CPU {c['log']}")
    ratio = dict(masters=0.0, m=0.0, v=0.0)
    for i, g in enumerate(c["g1"]):
        ga = g.abs()
        ng = 2.0 ** -7 * float(ga.max())
        tol = 1e-6 + 4 * AMP_LR * ng / (ga + ng)
        ratio["masters"] = max(ratio["masters"], float(
            ((d["masters"][i] - c["masters"][i]).abs() / tol).max()))
        ratio["m"] = max(ratio["m"], float(
            (d["m"][i] - c["m"][i]).abs().max()) / ng)
        ratio["v"] = max(ratio["v"], float(
            (d["v"][i] - c["v"][i]).abs().max()) / (2 * ng * float(ga.max())))
        for k in ("cpu", "cuda"):
            p = res[k]["params"][i]
            if not torch.equal(p, res[k]["masters"][i].to(p.dtype)):
                raise AssertionError(f"small amp ({k}): parameter {i} is not "
                                     f"its master cast")
    if max(ratio.values()) > 1.0:
        raise AssertionError(f"small amp: card against CPU {ratio}")
    out = dict(steps=steps, forced_step=forced, found_inf=flags,
               losses_cuda=[l for l, _, _ in d["log"]],
               losses_cpu=[l for l, _, _ in c["log"]],
               scaler_states=[s for _, _, s in d["log"]],
               loss_tol_ratio=loss_ratio, tol_ratios=ratio,
               tolerance="losses (fp16 means) within 2^-8 |loss|; found_inf "
                         "and every scaler field equal; masters within 1e-6 "
                         "+ 4 lr ng / (|g1| + ng), m within ng, v within 2 ng "
                         "max|g1|, ng = 2^-7 max|g1| (g1 the first applied "
                         "step's gradient): fp16 kernels and the CPU's plain "
                         "versions round at other places, and an element "
                         "whose gradient lies within ng of 0 may take each "
                         "side's Adam step its own way; each parameter its "
                         "master cast, on both")
    log("phase3-amp-reference", **out)
    return out


def llama_1b_amp_train(device, form: str, *, group=None, dp_group=None,
                       steps: int = TRAIN_STEPS,
                       tag: str = "phase3-amp") -> dict:
    """The ``llama-1b`` card at full width and depth in fp16 O2 under the
    dynamic scaler (``AmpTrainer``, one optimizer form), weights from a
    seeded generator on the card, one fixed batch b 4 x s 2048: 1 warm-up
    step (it overflows at 2**16 on its own), then ``steps`` timed steps
    with the launches of each checked exactly; at timed step
    ``AMP_FORCED`` an inf is written into one gradient: that step must
    leave every parameter, master, optimizer state tensor and the step
    counter bit for bit, halve the scale and leave ``unskipped``.  The
    loss after the applied steps must end below the first one.  Step
    wall, host issue, steps skipped by real overflows, peak memory (over
    the steps but the forced one, which holds a device copy of what it
    must keep) and,
    outside a tp group, a traced step.  With ``group`` (a tensor-parallel
    group, ``dp_group`` its data-parallel one) the model is
    ``llama_pretrain.build_model``'s shard, stepped inside the group's
    region under ``GradScaler`` (``AmpTrainer(dp_group=)``); the batch
    goes through ``tp_replicated_rows`` and ``broadcast_data``."""
    import contextlib

    import torch
    from apex_tpu_torch.examples.llama_pretrain import build_model
    from apex_tpu_torch.models import LlamaConfig
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.ops import packed_update as pu

    from apex_tpu_torch.transformer.tensor_parallel import (
        broadcast_data,
        tensor_parallel_region,
        tp_replicated_rows,
    )

    cfg = LlamaConfig.llama_1b()
    t0 = time.perf_counter()
    tr = AmpTrainer(build_model(cfg, device=device, seed=0, group=group),
                    form, dp_group=dp_group)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, s = 4, 2048
    ids = torch.randint(0, cfg.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(8))
    if group is None:
        ids = ids.to(device)
    else:
        ids = broadcast_data(["ids"], {"ids": tp_replicated_rows(ids)},
                             torch.int64, group, device=device)["ids"]
    labels = torch.roll(ids, -1, dims=1)

    def region():
        return (contextlib.nullcontext() if group is None
                else tensor_parallel_region(group))
    layers = cfg.num_hidden_layers
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                fa.FLASH_ATTENTION_FWD.name: layers,
                fa.FLASH_ATTENTION_DQ.name: layers,
                fa.FLASH_ATTENTION_DKV.name: layers,
                lh.FUSED_LM_HEAD_FWD.name: 1,
                lh.FUSED_LM_HEAD_DH.name: 1,
                lh.FUSED_LM_HEAD_DE.name: 1,
                # LossScaler.has_overflow: mt_scale's check
                mt.MT_SCALE.name: 1}
    if form == "adam":
        per_step[mt.MT_ADAM.name] = 1
    elif form == "adagrad":
        per_step[pu.PACKED_ADAGRAD.name] = 1
    elif form == "packed_adam":
        per_step[pu.PACKED_ADAM.name] = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with region():
        warm = tr.step(ids, labels)             # warm-up, not counted
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    step_ms, issue_ms, issue_cpu_ms, results = [], [], [], []
    peak_unforced = 0
    for i in range(steps):
        before = {k.name: k.launches for k in _dispatch.KERNELS}
        forced = i == AMP_FORCED
        if forced:
            # a device copy of every tensor the step writes (a copy to the
            # host took seconds); the peak leaves out the forced step,
            # which holds it
            peak_unforced = torch.cuda.max_memory_allocated()
            snap = {k: t.detach().clone() for k, t in tr.tensors().items()}
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        with region():
            results.append(tr.step(ids, labels, force_inf=forced))
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        issue_cpu_ms.append((time.process_time() - c0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if forced:
            changed = [k for k, t in tr.tensors().items()
                       if not torch.equal(t.detach(), snap[k])]
            del snap
            torch.cuda.reset_peak_memory_stats()
            if changed:
                raise AssertionError(f"amp {form}: the forced overflow step "
                                     f"changed {changed[:5]}")
        step = {k.name: k.launches - before[k.name] for k in _dispatch.KERNELS}
        if _nonzero(step) != per_step:
            raise AssertionError(f"amp {form} step {i} launched {step}, "
                                 f"expected {per_step}")
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    peak = max(peak_unforced, torch.cuda.max_memory_allocated())
    # read on the host only now, after the run
    loss0, found0 = float(warm[0]), bool(warm[1])
    losses = [float(l) for l, _, _ in results]
    founds = [bool(f) for _, f, _ in results]
    states = [[t.item() for t in st] for _, _, st in results]
    prev = [t.item() for t in warm[2]] if AMP_FORCED == 0 else \
        states[AMP_FORCED - 1]
    halved = states[AMP_FORCED][0] == max(prev[0] / 2, 1.0)
    if not founds[AMP_FORCED] or not halved or \
            states[AMP_FORCED][3] != prev[3]:
        raise AssertionError(f"amp {form}: forced overflow at step "
                             f"{AMP_FORCED}: found {founds}, states "
                             f"{states}, before {prev}")
    applied = [i for i, f in enumerate(founds) if not f]
    if not all(map(math.isfinite, losses)) or not losses[-1] < loss0 or \
            not applied:
        raise AssertionError(f"amp {form}: losses {loss0} then {losses}, "
                             f"found_inf {founds}: not falling")
    med = statistics.median(step_ms)
    out = dict(config="llama-1b", form=form, batch=b, seq=s, tokens=b * s,
               precision="amp O2 fp16 (norm scales fp32), fp32 masters, "
                         "dynamic loss scaler from 2**16",
               optimizer={"adam": "FusedAdam(lr=1e-3, master_weights=True)",
                          "adagrad": "FusedAdagrad(lr=1e-3, packed=True, "
                                     "master_weights=True)",
                          "packed_adam": "packed_adam_update over the masters "
                                         "packed once (lr=1e-3), noop_flag="
                                         "found_inf"}[form],
               params=sum(p.numel() for p in tr.params), init_s=init_s,
               warmup_loss=loss0, warmup_found_inf=found0, warmup_ms=warm_ms,
               losses=losses, found_inf=founds, scaler_states=states,
               scaler_fields=["scale", "growth_tracker", "hysteresis_tracker",
                              "unskipped"],
               forced_step=AMP_FORCED,
               real_overflow_steps=[i for i, f in enumerate(founds)
                                    if f and i != AMP_FORCED],
               warmup_real_overflow=found0,
               step_ms=step_ms, step_ms_median=med, step_issue_ms=issue_ms,
               step_issue_cpu_ms=issue_cpu_ms,
               tokens_per_s=b * s / (med / 1e3), peak_mem_bytes=peak,
               mt_table_bytes=mt_table_bytes(),
               launches=launches, launches_per_step=per_step)
    if group is not None:
        out["scaler"] = type(tr.scaler).__name__
        out["backend"] = str(torch.distributed.get_backend(group))
    log(f"{tag}-{form}", **out)
    if group is None:
        out["profile"] = _profile(lambda: tr.step(ids, labels), med)
        log(f"{tag}-{form}-profile", **out["profile"])
    del tr, ids, labels, warm, results
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2: the pair-bias attention kernels against their plain versions
# ---------------------------------------------------------------------------

# OpenFold's MSA row attention with pair bias at the Evoformer widths
# (openfold/config.py: c_m 256, c_z 128, 8 heads x c_hidden_msa_att 32),
# N_seq 128 (max_msa_clusters in training), N_res 1024 (the shortest
# length the JAX routing sends to the kernel), b 1, bf16, 10% of the MSA
# positions masked
OPENFOLD = dict(b=1, n_seq=128, n_res=1024, c_m=256, c_z=128, heads=8,
                c_hidden=32, blocks=4, mask_rate=0.1)
PAIR_BIAS_MAIN = dict(r=OPENFOLD["n_seq"], b=OPENFOLD["b"], h=OPENFOLD["heads"],
                      s=OPENFOLD["n_res"], d=OPENFOLD["c_hidden"])
# dbias launches at the main shape, each held to the first call's bits
PAIR_BIAS_DBIAS_REPEATS = 50


def _pair_bias_inputs(case, g, device):
    """q, k, v, do ``[r*b, h, s, d]`` (``layout="openfold"``: views of
    ``[R, s, h, d]``, the heads split from a linear's output;
    ``do_layout="odd_rows"``: do's rows ``d + 4`` values apart), bias ``[b,
    h, s, s]``, all 0.5 N(0, 1), and a kv mask with R row 1 fully masked
    (``dead``)."""
    import torch

    dt = getattr(torch, case["dtype"])
    bdt = getattr(torch, case.get("bias_dtype", case["dtype"]))
    r, b, h, s, d = (case[k] for k in ("r", "b", "h", "s", "d"))
    R = r * b

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=device) * 0.5

    def operand():
        if case.get("layout") == "openfold":
            return rand(R, s, h, d).to(dt).permute(0, 2, 1, 3)
        return rand(R, h, s, d).to(dt)

    q, k, v, do = (operand() for _ in range(4))
    if case.get("do_layout") == "odd_rows":
        # rows d + 4 values apart: off 16 bytes, no map can step over them
        do = rand(R, h, s, d + 4).to(dt)[..., :d]
    bias = rand(b, h, s, s).to(bdt)
    mask = None
    if case.get("mask", True):
        mask = torch.rand(R, s, generator=g, device=device) >= case.get(
            "mask_rate", 0.2)
        if case.get("dead", True):
            mask[1] = False
    return q, k, v, bias, mask, do


def _pair_bias_bwd_tol(q, k, v, bias, mask, lse, do, delta, refs, case,
                       scale):
    """Per-element bounds of ``(dq, dk, dv, dbias)``, as the flash
    backward's (``_flash_bwd_tol``) with the bias in the exponent: the
    kernels round ds and p to the operand dtype before dq, dk and dv (u
    |ds| |k| and the like), the dtype's least subnormal spacing bounds
    what that loses below the normal range, and every fp32 quantity (s
    with the bias, p through 2^x, dp, delta and the sums) is within
    EPS_SUM of its terms' absolute sums; dbias sums its fp32 ds over the r
    rows unrounded.  Then 2 ulp of each output's dtype.  One R row at a
    time, in fp32."""
    import torch

    dt = case["dtype"]
    u, floor = _half_eps(dt), _sub_floor(dt)
    R, h, s, d = q.shape
    b = bias.shape[0]
    tq, tk, tv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    tdb = torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
    for i in range(R):
        q1, k1, v1, do1 = (t[i].float() for t in (q, k, v, do))
        b1 = bias[i % b].float()
        sc = torch.matmul(q1, k1.transpose(-1, -2)) * scale + b1
        valid = None if mask is None else mask[i][None, None, :]
        if valid is not None:
            sc = torch.where(valid, sc, -1e30)
        p = torch.exp(sc - lse[i][..., None])
        del sc
        dp = torch.matmul(do1, v1.transpose(-1, -2))
        dpa = torch.matmul(do1.abs(), v1.abs().transpose(-1, -2))
        dl = delta[i][..., None]
        ds = p * (dp - dl)
        pe = 1 + torch.matmul(q1.abs(), k1.abs().transpose(-1, -2)) * scale \
            + b1.abs()
        a = p * (pe * (dp.abs() + dl.abs()) + dpa + dl.abs())
        pe = p * pe
        del dp, dpa
        qa, ka, doa = q1.abs(), k1.abs(), do1.abs()
        tq[i] = scale * (u * torch.matmul(ds.abs(), ka)
                         + EPS_SUM * torch.matmul(a, ka) + floor * s * float(ka.max()))
        tk[i] = scale * (u * torch.matmul(ds.abs().transpose(-1, -2), qa)
                         + EPS_SUM * torch.matmul(a.transpose(-1, -2), qa)
                         + floor * s * float(qa.max()))
        tv[i] = (u * torch.matmul(p.transpose(-1, -2), doa)
                 + EPS_SUM * torch.matmul(pe.transpose(-1, -2), doa)
                 + floor * s * float(doa.max()))
        tdb[i % b] += EPS_SUM * a
        del p, ds, a, pe
    dq_r, dk_r, dv_r, db_r = refs
    return (tq + 2 * _ulp(dq_r, dt), tk + 2 * _ulp(dk_r, dt),
            tv + 2 * _ulp(dv_r, dt),
            tdb + 2 * _ulp(db_r, case.get("bias_dtype", dt)))


def check_pair_bias(device) -> dict:
    """The four pair-bias kernels on the card against the plain forward
    and backward on the same inputs: fp32/bf16/fp16; d 8/16/32/64/128
    (zero-padded to 16/32/64/128 inside); s 128, 1000 (a ragged tile),
    1024, 2048, 16400 (bf16, d 128), and 100 and 1001 (bias rows not staged
    in shared memory); mask on and off with a fully masked R row; b 1 and 2
    (the bias tiling over rows-major R); scale 0.7 and 1; an fp32 bias
    beside 16-bit q/k/v (d 16, and d 128 at s 1000 and 1024, the latter
    also in the openfold layout with a do whose rows no map can step over);
    the openfold layout (strided views); and the main path's shape.  dbias
    must be the same bits on two calls, and at the main shape on
    PAIR_BIAS_DBIAS_REPEATS more launches; broadcast q, k, v, and a do with
    strides no map takes (rows off 16 bytes, a zero head stride, a last
    stride other than 1), must give the same bits as contiguous copies; and
    d = 136 must raise.  Returns the main shape's errors."""
    import torch
    from apex_tpu_torch.ops import pair_bias_attention as pb

    cases = []
    for dt in _DTYPES:
        # d 8, 16 and 24: the 16-bit forward's TMA boxes of 32 columns read
        # zeros past d
        for d in (8, 16, 24, 32, 64, 128):
            cases.append(dict(dtype=dt, d=d, s=128, r=3, b=2, h=2, scale=0.7))
        for s in (1000, 1024, 2048):
            cases.append(dict(dtype=dt, d=32, s=s, r=2, b=1, h=2, scale=1.0,
                              layout="openfold"))
        # bias rows that are not whole 16-byte chunks: read from global
        # memory by each lane, not staged (s 100 in 16 bits, s 1001)
        for s in (100, 1001):
            cases.append(dict(dtype=dt, d=32, s=s, r=3, b=2, h=2, scale=0.7))
        cases.append(dict(dtype=dt, d=64, s=1000, r=2, b=2, h=2, scale=0.7,
                          mask=False))
        cases.append(dict(dtype=dt, d=128, s=1000, r=2, b=2, h=1, scale=1.0))
        cases.append(dict(dtype=dt, d=16, s=1024, r=2, b=2, h=2, scale=1.0,
                          bias_dtype="bfloat16" if dt == "float32"
                          else "float32"))
        if dt != "float32":
            # the 16-bit kernels' largest rings: d 128 with an fp32 bias
            # (four bias boxes a stage), at a ragged s and a whole one; then
            # the same in the openfold layout with a do no map can read
            # (the backward copies it)
            for s in (1000, 1024):
                cases.append(dict(dtype=dt, d=128, s=s, r=2, b=2, h=1,
                                  scale=0.7, bias_dtype="float32"))
            for s in (1000, 1024):
                cases.append(dict(dtype=dt, d=128, s=s, r=2, b=2, h=2,
                                  scale=0.7, bias_dtype="float32",
                                  layout="openfold", do_layout="odd_rows"))
    # a long s at d 128: the 16-bit forward's shared memory does not grow
    # with s (a ragged last tile, bias rows staged)
    cases.append(dict(dtype="bfloat16", d=128, s=16400, r=2, b=1, h=1,
                      scale=0.7))
    cases.append(dict(PAIR_BIAS_MAIN, dtype="bfloat16", scale=1.0,
                      layout="openfold", mask_rate=OPENFOLD["mask_rate"],
                      dead=False, main=True))
    g = torch.Generator(device=device).manual_seed(51)
    worst = {"o": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0, "dbias": 0.0}
    main = {}
    with torch.no_grad():
        for case in cases:
            q, k, v, bias, mask, do = _pair_bias_inputs(case, g, device)
            scale = case["scale"]
            o, lse = pb.pair_bias_flash_attention_fwd(q, k, v, bias, mask, scale)
            grads = pb.pair_bias_flash_attention_bwd(q, k, v, bias, o, lse, do,
                                                     mask, scale)
            db_again = pb.pair_bias_flash_attention_bwd(
                q, k, v, bias, o, lse, do, mask, scale)[3]
            torch.cuda.synchronize()
            name = {kk: case[kk] for kk in case if kk not in ("r", "h")}
            if grads[0].stride() != q.stride() or grads[1].stride() != k.stride():
                raise AssertionError(f"pair-bias backward strides: {name}")
            ro, rlse = pb._plain_forward(q, k, v, bias, mask, scale)
            if case["dtype"] == "float32":
                o_tol = 1e-5 + 1e-5 * ro.float().abs()
            else:
                # the kernel rounds p to the operand dtype before p v (as
                # the flash forward's check, _flash_inputs' cases)
                pv_abs, _ = pb._plain_forward(q.float(), k.float(),
                                              v.float().abs(), bias.float(),
                                              mask, scale)
                o_tol = (_half_eps(case["dtype"]) * pv_abs
                         + _sub_floor(case["dtype"]) * case["s"]
                         * float(v.float().abs().max())
                         + 2 * _ulp(ro, case["dtype"]))
                del pv_abs
            r = {"o": _tol_ratio(o, ro, o_tol),
                 "lse": _tol_ratio(lse, rlse, 1e-5 + 1e-5 * rlse.abs())}
            o_err = float((o.float() - ro.float()).abs().max())
            del ro, rlse, o_tol
            refs = pb._plain_backward(q, k, v, bias, mask, o, lse, do, scale)
            delta = (do.float() * o.float()).sum(-1)
            tols = _pair_bias_bwd_tol(q, k, v, bias, mask, lse, do, delta,
                                      refs, case, scale)
            for n, a, e, t in zip(("dq", "dk", "dv", "dbias"), grads, refs,
                                  tols):
                r[n] = _tol_ratio(a, e, t)
            same = torch.equal(grads[3], db_again)
            if case.get("main"):
                # at the main shape, dbias again and again: a stage handed
                # back before its last reads would show as other bits
                call = pb._Launch(q, k, v, bias, mask, scale, o=o, lse=lse, do=do)
                call.launch(pb.PAIR_BIAS_DQ)
                for _ in range(PAIR_BIAS_DBIAS_REPEATS):
                    call.launch(pb.PAIR_BIAS_DBIAS)
                    same &= torch.equal(grads[3], call.dbias)
                del call
            dead_ok = mask is None or not case.get("dead", True) or (
                bool((o[1] == 0).all()) and bool(torch.isinf(lse[1]).all()))
            if max(r.values()) > 1.0 or not same or not dead_ok:
                raise AssertionError(
                    f"pair-bias attention disagrees with its plain version: "
                    f"{name}: {r} x tolerance, dbias the same bits on two "
                    f"calls: {same}, fully masked row o = 0, lse = inf: "
                    f"{dead_ok}")
            for n, x in r.items():
                worst[n] = max(worst[n], x)
            if case.get("main"):
                main = {f"{n}_max_abs_err": float((a.float() - e.float()).abs().max())
                        for n, a, e in zip(("dq", "dk", "dv", "dbias"), grads,
                                           refs)}
                main.update(o_max_abs_err=o_err, tol_ratio=r)
            del q, k, v, bias, mask, do, o, lse, grads, db_again, refs, tols
        # broadcast q, k, v (a zero head stride) are copied, for the 16-bit
        # forward's maps and for the backward's gradients (which take the
        # operands' strides): the same bits as from contiguous copies
        bq, bk, bv = (torch.randn(2, 1, 200, 32, generator=g, device=device)
                      .to(torch.bfloat16).expand(2, 4, 200, 32)
                      for _ in range(3))
        bb = torch.randn(2, 4, 200, 200, generator=g, device=device)
        bm = torch.rand(2, 200, generator=g, device=device) >= 0.2
        bdo = torch.randn(2, 4, 200, 32, generator=g, device=device).to(torch.bfloat16)
        got = pb.pair_bias_flash_attention_fwd(bq, bk, bv, bb, bm, 0.7)
        got += pb.pair_bias_flash_attention_bwd(bq, bk, bv, bb, got[0], got[1], bdo,
                                                bm, 0.7)
        cq, ck, cv = (t.contiguous() for t in (bq, bk, bv))
        want = pb.pair_bias_flash_attention_fwd(cq, ck, cv, bb, bm, 0.7)
        want += pb.pair_bias_flash_attention_bwd(cq, ck, cv, bb, want[0], want[1], bdo,
                                                 bm, 0.7)
        if not all(torch.equal(a, e) for a, e in zip(got, want)):
            raise AssertionError("pair-bias attention of broadcast q, k, v differs "
                                 "from that of their contiguous copies")
        # a do that autograd may hand over with strides no map takes (rows
        # off 16 bytes, a broadcast over the heads, a last stride other
        # than 1): copied by the wrapper, the same bits as a contiguous do
        odd_do = {
            "rows_off_16_bytes": torch.randn(2, 4, 200, 36, generator=g,
                                             device=device).to(torch.bfloat16)[..., :32],
            "broadcast_heads": torch.randn(2, 1, 200, 32, generator=g, device=device)
            .to(torch.bfloat16).expand(2, 4, 200, 32),
            "last_stride_200": torch.randn(2, 4, 32, 200, generator=g, device=device)
            .to(torch.bfloat16).transpose(-1, -2)}
        for name, sdo in odd_do.items():
            got = pb.pair_bias_flash_attention_bwd(cq, ck, cv, bb, want[0], want[1],
                                                   sdo, bm, 0.7)
            ref = pb.pair_bias_flash_attention_bwd(cq, ck, cv, bb, want[0], want[1],
                                                   sdo.contiguous(), bm, 0.7)
            if not all(torch.equal(a, e) for a, e in zip(got, ref)):
                raise AssertionError(f"pair-bias backward with a do of strides "
                                     f"{tuple(sdo.stride())} ({name}) differs from "
                                     f"that of its contiguous copy")
        del bq, bk, bv, bb, bm, bdo, cq, ck, cv, got, want, odd_do, sdo, ref
        wide = torch.zeros(2, 1, 64, 136, device=device, dtype=torch.bfloat16)
        try:
            pb.pair_bias_flash_attention_fwd(
                wide, wide, wide, torch.zeros(1, 1, 64, 64, device=device))
        except ValueError as err:
            d136 = str(err)
        else:
            raise AssertionError("pair-bias attention took head dim 136")
    torch.cuda.empty_cache()
    out = dict(kernel="pair_bias_attention_fwd + dq + dkv + dbias",
               cases=len(cases), worst_tol_ratio=worst, main_shape=main,
               dbias_bit_identical_over_two_calls=True,
               dbias_main_shape_repeats_bit_identical=PAIR_BIAS_DBIAS_REPEATS,
               d136_raises=d136,
               broadcast_qkv_same_bits_as_copies=True,
               odd_do_same_bits_as_copies=["rows_off_16_bytes",
                                           "broadcast_heads", "last_stride_200"],
               tolerance="fp32 o within 1e-5 + 1e-5|ref|; bf16/fp16 o_ij "
                         "within eps/2 sum_j p_ij |v_j| + floor s max|v| + "
                         "2 ulp(ref); lse within 1e-5 + 1e-5|ref|, +inf rows "
                         "equal; dq within scale (u |ds| |k| + 2^-16 A |k| + "
                         "floor s max|k|), dk likewise with q, dv within u "
                         "p^T |do| + 2^-16 (p E)^T |do| + floor s max|do|, "
                         "dbias within 2^-16 sum_t A_t, each + 2 ulp: u half "
                         "an epsilon of the dtype (0 for fp32), E = 1 + scale "
                         "|q||k|^T + |bias| the exponent's error scale, A = p "
                         "(E (|dp| + |delta|) + |do||v|^T + |delta|) that of "
                         "ds, floor the dtype's half least subnormal spacing")
    log("phase2-check", **out)
    return out


def time_pair_bias(device) -> dict:
    """The four kernels, the plain forward and backward, and
    ``F.scaled_dot_product_attention`` at the main path's shape (R 128, h
    8, s 1024, d 32, bf16, q/k/v in the openfold layout, 10% of the keys
    masked); returns ``{"fwd": row, "dq": row, "dkv": row, "dbias":
    row}``.  The library call takes the bias and the mask fill as one
    float ``attn_mask`` of ``[R, h, s, s]`` (bias tiled over the r rows
    plus -inf at masked keys): that tensor (2.1 GB in bf16) and, in the
    backward, its gradient of the same size are what it materializes; it
    then leaves dbias's sum over the r rows to the caller (not timed)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import pair_bias_attention as pb

    c = PAIR_BIAS_MAIN
    R, h, s, d = c["r"] * c["b"], c["h"], c["s"], c["d"]
    g = torch.Generator(device=device).manual_seed(52)
    case = dict(c, dtype="bfloat16", layout="openfold", dead=False,
                mask_rate=OPENFOLD["mask_rate"])
    q, k, v, bias, mask, do = _pair_bias_inputs(case, g, device)
    rows = {}
    with torch.no_grad():
        fwd = lambda: pb.pair_bias_flash_attention_fwd(q, k, v, bias, mask)
        o, lse = fwd()
        call = pb._Launch(q, k, v, bias, mask, 1.0, o=o, lse=lse, do=do)
        call.launch(pb.PAIR_BIAS_DQ)                 # delta for the other two
        fns = {"fwd": fwd}
        for name, kern in (("dq", pb.PAIR_BIAS_DQ), ("dkv", pb.PAIR_BIAS_DKV),
                           ("dbias", pb.PAIR_BIAS_DBIAS)):
            fns[name] = lambda kern=kern: call.launch(kern)
        for name, fn in fns.items():
            rows[name] = dict(kernel=device_ms(fn, iters=20),
                              host=time_ms(fn, iters=20, warmup=3))
        for name, fn in fns.items():
            rows[name]["kernel_again"] = device_ms(fn, iters=20)
        # bias reuse: the forward with a bias plane of its own for each MSA
        # row (b = R, 2.1 GB, each plane read by one row only) against the
        # shared plane, which all r rows read; what the shared plane saves
        # is what its reuse (in L2) buys
        own = torch.randn(R, h, s, s, generator=g, device=device).to(
            torch.bfloat16)
        reuse = dict(shared_ms=device_ms(fwd, iters=20), per_row_ms=device_ms(
            lambda: pb.pair_bias_flash_attention_fwd(q, k, v, own, mask),
            iters=20), per_row_bias_bytes=own.numel() * 2,
            shared_bias_bytes=bias.numel() * 2)
        del own
        plain_fwd = time_ms(lambda: pb._plain_forward(q, k, v, bias, mask),
                            iters=3, warmup=1)
        plain_bwd = time_ms(lambda: pb._plain_backward(q, k, v, bias, mask, o,
                                                       lse, do), iters=2,
                            warmup=1)
        torch.cuda.empty_cache()
    # the library call: one float mask [R, h, s, s], the bias tiled over
    # the rows plus -inf at the masked keys
    fill = torch.zeros(R, 1, 1, s, device=device).masked_fill(
        ~mask[:, None, None, :], float("-inf"))
    am = (bias.float().repeat(R // c["b"], 1, 1, 1) + fill).to(torch.bfloat16)
    del fill
    library = {}
    try:
        with torch.no_grad():
            library["fwd"] = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=am, scale=1.0), iters=5)
        qr, kr, vr, amr = (t.detach().requires_grad_() for t in (q, k, v, am))
        library["bwd"] = _fwd_bwd_minus_fwd(
            lambda: F.scaled_dot_product_attention(qr, kr, vr, attn_mask=amr,
                                                   scale=1.0),
            ((qr, kr, vr, amr), do), device_iters=5)
        library_error = None
        del qr, kr, vr, amr
    except RuntimeError as err:          # a yardstick only: record why
        library_error = str(err)[:300]
    del am
    torch.cuda.empty_cache()
    # what this run's data needs: every query against the valid keys
    pairs = h * s * int(mask.sum())
    prod = 2 * pairs * d                              # one product
    qkv = 2 * R * h * s * d                           # one [R, h, s, d] bf16
    stats = 4 * R * h * s                             # one fp32 [R, h, s]
    plane = 2 * c["b"] * h * s * s                    # the bias (or dbias)
    out = {}
    for name, nprod, nbytes in (
            # q, k, v, bias, mask read; o, lse written
            ("fwd", 2, 4 * qkv + plane + R * s + stats),
            # q, k, v, o, do, bias, mask, lse read; dq, delta written
            ("dq", 3, 6 * qkv + plane + R * s + 2 * stats),
            # q, k, v, do, bias, mask, lse, delta read; dk, dv written
            ("dkv", 4, 6 * qkv + plane + R * s + 2 * stats),
            # q, k, v, do, bias, mask, lse, delta read; dbias written
            ("dbias", 2, 4 * qkv + 2 * plane + R * s + 2 * stats)):
        r = rows[name]
        dev = dict(kernel=r["kernel"], kernel_again=r["kernel_again"],
                   plain=plain_fwd if name == "fwd" else plain_bwd,
                   library=library.get("fwd" if name == "fwd" else "bwd"))
        row = _row(dev, r["host"], nprod * prod, nbytes, 989e12, exps=pairs,
                   timing="ms: device time, 20 calls in one CUDA graph "
                          "between CUDA events; plain_ms: 2-3 eager calls "
                          "between CUDA events (GBs of temporaries); "
                          "library_ms: CUDA graphs of 5; host_issued_ms: 20 "
                          "eager calls back to back; L2-warm")
        row.update(shape=dict(PAIR_BIAS_MAIN, dtype="bfloat16",
                              valid_keys=int(mask.sum()), keys=R * s),
                   flops=nprod * prod, exponentials=pairs, bytes=nbytes,
                   library_error=library_error,
                   library_call="F.scaled_dot_product_attention(q, k, v, "
                                "attn_mask=[R, h, s, s] bf16 bias + mask fill"
                                + (")" if name == "fwd" else
                                   ") forward + backward minus forward (its "
                                   "dq, dk, dv and d(attn_mask))"))
        if name == "fwd":
            row["bias_reuse"] = reuse
        else:
            row["plain_and_library_compute"] = "dq, dk, dv and dbias together"
        log("phase2-time", kernel=f"pair_bias_attention_{name}", **row)
        out[name] = row
    return out


def time_openfold_routes(device) -> dict:
    """The card's own evidence on the routing gate: at ``[1, 128, 8, s,
    32]`` bf16 for s = 256 (the Evoformer training crop, which
    ``attention_core`` sends to the materialized route) and 1024 (which
    it sends to the kernels), the pair-bias kernels called directly and
    the materialized route, forward and forward + backward (q, k, v and
    the bias), each timed eagerly between CUDA events over 5 calls."""
    import torch
    from apex_tpu_torch.contrib import openfold_triton as tof
    from apex_tpu_torch.ops import pair_bias_attention as pb

    b, r, h, d = 1, OPENFOLD["n_seq"], OPENFOLD["heads"], OPENFOLD["c_hidden"]
    g = torch.Generator(device=device).manual_seed(53)
    out = {}
    for s in (256, 1024):
        q, k, v = (torch.randn(b, r, h, s, d, generator=g, device=device)
                   .to(torch.bfloat16) * 0.3 for _ in range(3))
        bias = torch.randn(b, 1, h, s, s, generator=g, device=device).to(
            torch.bfloat16)
        mask = torch.rand(b, r, 1, 1, s, generator=g, device=device) >= 0.1
        do = torch.randn(b, r, h, s, d, generator=g, device=device).to(
            torch.bfloat16)
        kv_mask = mask[:, :, 0, 0, :].transpose(0, 1).reshape(r * b, s)
        flat = lambda x: x.transpose(0, 1).reshape(r * b, h, s, d)

        def kernel(q, k, v, bias):
            o = pb.pair_bias_flash_attention(flat(q), flat(k), flat(v),
                                             bias[:, 0], kv_mask)
            return o.reshape(r, b, h, s, d).transpose(0, 1)

        def material(q, k, v, bias):
            return tof._materialized(q, k, v, mask, bias, 1e9)

        row = {}
        for route, fn in (("kernel", kernel), ("materialized", material)):
            with torch.no_grad():
                row[f"{route}_fwd_ms"] = time_ms(lambda: fn(q, k, v, bias),
                                                 iters=5, warmup=2)
            leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]

            def both():
                torch.autograd.grad(fn(*leaves), leaves, do)

            row[f"{route}_fwd_bwd_ms"] = time_ms(both, iters=5, warmup=2)
            del leaves
            torch.cuda.empty_cache()
        out[f"s{s}"] = row
        del q, k, v, bias, mask, do, kv_mask
    out["timing"] = ("eager, CUDA events around 5 calls after 2 warm-up "
                     "calls; the kernel route includes the flattening "
                     "copies attention_core makes")
    log("phase2-openfold-routes", **out)
    return out


# ---------------------------------------------------------------------------
# phase 3: the openfold path (MSA row attention with pair bias, training)
# ---------------------------------------------------------------------------


def openfold_weights(c_m, c_z, h, d, g, device, dtype):
    """One block's weights, as OpenFold's MSARowAttentionWithPairBias has
    them: the two LayerNorms, the pair-bias linear z -> h and q, k, v
    without bias, the gate and output linears with bias; random from a
    seeded generator (linears at fan_in^-1/2)."""
    import torch

    lin = lambda o, i: torch.randn(o, i, generator=g, device=device) * i ** -0.5
    vec = lambda n, sd: sd * torch.randn(n, generator=g, device=device)
    w = {"ln_m_w": 1 + vec(c_m, 0.1), "ln_m_b": vec(c_m, 0.1),
         "ln_z_w": 1 + vec(c_z, 0.1), "ln_z_b": vec(c_z, 0.1),
         "w_z": lin(h, c_z), "w_q": lin(h * d, c_m), "w_k": lin(h * d, c_m),
         "w_v": lin(h * d, c_m), "w_g": lin(h * d, c_m), "b_g": vec(h * d, 0.1),
         "w_o": lin(c_m, h * d), "b_o": vec(c_m, 0.1)}
    return {k: t.to(dtype).requires_grad_() for k, t in w.items()}


def msa_row_block(m, z, w, mask, h):
    """MSA row attention with pair bias, from the port's public API and
    ``F.linear``: m ``[b, r, s, c_m]``, z ``[b, s, s, c_z]``, mask ``[b, r,
    1, 1, s]``; returns the new m (a residual over the gated attention)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib import openfold_triton as tof

    c_m, c_z = m.shape[-1], z.shape[-1]
    d = w["w_q"].shape[0] // h
    mn = tof.LayerNormSmallShapeOptImpl.apply(m, (c_m,), w["ln_m_w"], w["ln_m_b"])
    zn = tof.LayerNormSmallShapeOptImpl.apply(z, (c_z,), w["ln_z_w"], w["ln_z_b"])
    bias = F.linear(zn, w["w_z"]).permute(0, 3, 1, 2).unsqueeze(1)
    heads = lambda x: x.view(*x.shape[:-1], h, d).transpose(-2, -3)
    q = heads(F.linear(mn, w["w_q"])) * d ** -0.5
    k, v = heads(F.linear(mn, w["w_k"])), heads(F.linear(mn, w["w_v"]))
    o = tof.attention_core(q, k, v, mask, bias).transpose(-2, -3)
    gate = torch.sigmoid(F.linear(mn, w["w_g"], w["b_g"])).view(o.shape)
    return m + F.linear((o * gate).flatten(-2), w["w_o"], w["b_o"])


def _openfold_loss(blocks, m, z, mask, target, h):
    import torch

    x = m
    for w in blocks:
        x = msa_row_block(x, z, w, mask, h)
    return torch.mean((x.float() - target) ** 2)


def small_openfold_check(device) -> dict:
    """A small fp32 block (b 1, r 2, 2 heads of 8, c_m 16, c_z 8) at N_res
    1024, so that ``attention_core`` routes it to the pair-bias kernels:
    the same weights and inputs on the card and on the CPU give the loss,
    every weight's gradient and z's (which reaches the loss only through
    the bias), then the losses and weights of 3 ``FusedAdamSWA`` steps."""
    import torch
    from apex_tpu_torch.contrib.openfold_triton import (AdamMathType,
                                                        FusedAdamSWA)
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import pair_bias_attention as pb

    b, r, s, c_m, c_z, h, d = 1, 2, 1024, 16, 8, 2, 8
    g = torch.Generator().manual_seed(54)
    m = torch.randn(b, r, s, c_m, generator=g)
    z = torch.randn(b, s, s, c_z, generator=g)
    mask = torch.rand(b, r, 1, 1, s, generator=g) >= 0.1
    target = torch.randn(b, r, s, c_m, generator=g)
    w0 = openfold_weights(c_m, c_z, h, d, g, "cpu", torch.float32)
    lr, steps = 1e-3, 3
    res = {}
    for dev in ("cpu", device):
        # fresh leaves on each side: the optimizer updates them in place
        w = {k: t.detach().clone().to(dev).requires_grad_()
             for k, t in w0.items()}
        tz = z.clone().to(dev).requires_grad_()
        args = (m.to(dev), tz, mask.to(dev), target.to(dev), h)
        _dispatch.reset_launches()
        loss = _openfold_loss([w], *args)
        loss.backward()
        launched = pb.PAIR_BIAS_DBIAS.launches
        # copies: on the CPU .cpu() is the tensor itself, and z's grad
        # keeps accumulating over the steps below
        grads = {k: t.grad.detach().cpu().clone() for k, t in w.items()}
        grads["z"] = tz.grad.detach().cpu().clone()
        opt = FusedAdamSWA(list(w.values()), lr=lr,
                           adam_math_mode=AdamMathType.ApexAdamW,
                           swa_decay_rate=0.9)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            step_loss = _openfold_loss([w], *args)
            step_loss.backward()
            opt.step()
            losses.append(float(step_loss.detach()))
        res[str(dev)] = (float(loss.detach()), grads, losses,
                         {k: t.detach().cpu() for k, t in w.items()},
                         [t.cpu() for t in opt.swa_state_dict()], launched)
    c, dd = res["cpu"], res[str(device)]
    if dd[5] != 1 or c[5] != 0:
        raise AssertionError(f"small openfold block: dbias launches card "
                             f"{dd[5]}, CPU {c[5]}: not routed to the kernels")
    # ln_z_b shifts all of a query row's scores alike: its gradient is zero
    # in exact arithmetic and rounding noise on each side, so Adam's steps
    # on it follow that noise; it is held to the noise and to 2 lr a step
    noise = 1e-5 * float(c[1]["w_z"].abs().max())
    grad_ratio, param_ratio, by_grad = 0.0, 0.0, {}
    for n in c[1]:
        if n == "ln_z_b":
            by_grad[n] = max(float(dd[1][n].abs().max()) / noise,
                             float(c[1][n].abs().max()) / noise)
            grad_ratio = max(grad_ratio, by_grad[n])
            param_ratio = max(param_ratio, float(
                (dd[3][n] - c[3][n]).abs().max()) / (2 * steps * lr))
            continue
        by_grad[n] = float(
            ((dd[1][n] - c[1][n]).abs()
             / (1e-4 * c[1][n].abs().max() + 1e-4 * c[1][n].abs() + 1e-9)).max())
        grad_ratio = max(grad_ratio, by_grad[n])
        if n == "z":
            continue
        ng = 1e-4 * c[1][n].abs().max()
        tol = 1e-5 + steps * lr * ng / (c[1][n].abs() + ng + 1e-30)
        param_ratio = max(param_ratio,
                          float(((dd[3][n] - c[3][n]).abs() / tol).max()))
    err = dict(loss=abs(c[0] - dd[0]), grad_tol_ratio=grad_ratio,
               grad_tol_ratio_by_name=by_grad,
               step_losses=max(abs(a - b_) for a, b_ in zip(c[2], dd[2])),
               params_tol_ratio=param_ratio,
               swa_max_abs_err=max(float((a - b_).abs().max())
                                   for a, b_ in zip(c[4], dd[4])),
               losses_cpu=c[2], grads=len(c[1]))
    if (err["loss"] > 1e-5 * abs(c[0]) or grad_ratio > 1.0
            or err["step_losses"] > 1e-5 * abs(c[0]) or param_ratio > 1.0):
        raise AssertionError(f"small openfold block: card against CPU {err}")
    if not c[2][-1] < c[2][0]:
        raise AssertionError(f"small openfold block: loss did not fall {c[2]}")
    err["tolerance"] = ("loss and step losses 1e-5 relative; each gradient "
                        "(z's included) within 1e-4 (max|g_ref| + |g_ref|); "
                        "each weight after 3 FusedAdamSWA (AdamW, lr 1e-3) "
                        "steps within 1e-5 + 3 lr ng / (|g| + ng), ng = 1e-4 "
                        "max|g_ref|; ln_z_b, whose gradient is zero in exact "
                        "arithmetic, within 1e-5 max|g_w_z| (gradient) and 2 "
                        "lr a step (weight)")
    log("phase3-openfold-reference", **err)
    return err


def _openfold_phases(blocks, opt, args, h, repeats: int = 3) -> dict:
    """``repeats`` more steps split into forward (and loss), backward and
    optimizer on the host clock, as ``_step_phases``."""
    import torch

    out = {}
    for _ in range(repeats):
        opt.zero_grad(set_to_none=True)
        for name, fn in (("forward", lambda: _openfold_loss(blocks, *args, h)),
                         ("backward", lambda: loss.backward()),
                         ("optimizer", lambda: opt.step())):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            res = fn()
            t1, c1 = time.perf_counter(), time.process_time()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if name == "forward":
                loss = res
            for key, v in ((f"{name}_ms", t2 - t0), (f"{name}_issue_ms", t1 - t0),
                           (f"{name}_cpu_ms", c1 - c0)):
                out.setdefault(key, []).append(v * 1e3)
    return out


def openfold_train(device) -> dict:
    """The openfold path: four MSA-row attention blocks with pair bias at
    the Evoformer widths (``OPENFOLD``), each with its own bf16 weights
    from a seeded generator on the card, all sharing z; the MSE of the
    final m against a fixed seeded target; ``backward()``;
    ``FusedAdamSWA(lr=1e-3, ApexAdamW, swa_decay_rate=0.9)`` over the
    blocks' weights.  1 warm-up step, then 6 timed steps with exact
    launches each (4 pair-bias forward, dq, dk/dv and dbias; 8 norm
    forward and backward; 1 ``mt_adam``, the optimizer's one launch over
    its 48 tensors; nothing else of the port's) and a loss that
    falls every step; step wall, host issue, peak memory and a profile.
    Then one block at the Evoformer training crop (N_res 256), which the
    JAX routing sends to the materialized path: no pair-bias launch."""
    import torch
    from apex_tpu_torch.contrib.openfold_triton import (AdamMathType,
                                                        FusedAdamSWA)
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.ops import pair_bias_attention as pb

    c = OPENFOLD
    b, r, s, h, d = c["b"], c["n_seq"], c["n_res"], c["heads"], c["c_hidden"]
    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(55)
    blocks = [openfold_weights(c["c_m"], c["c_z"], h, d, g, device, bf16)
              for _ in range(c["blocks"])]
    m = torch.randn(b, r, s, c["c_m"], generator=g, device=device).to(bf16)
    z = torch.randn(b, s, s, c["c_z"], generator=g, device=device).to(bf16)
    mask = torch.rand(b, r, 1, 1, s, generator=g, device=device) >= c["mask_rate"]
    target = torch.randn(b, r, s, c["c_m"], generator=g, device=device)
    args = (m, z, mask, target)
    params = [p for w in blocks for p in w.values()]
    opt = FusedAdamSWA(params, lr=1e-3, adam_math_mode=AdamMathType.ApexAdamW,
                       swa_decay_rate=0.9)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = _openfold_loss(blocks, *args, h)
        loss.backward()
        opt.step()
        return loss.detach()

    n = c["blocks"]
    per_step = {ln.LAYER_NORM_FWD.name: 2 * n, ln.LAYER_NORM_BWD.name: 2 * n,
                pb.PAIR_BIAS_FWD.name: n, pb.PAIR_BIAS_DQ.name: n,
                pb.PAIR_BIAS_DKV.name: n, pb.PAIR_BIAS_DBIAS.name: n,
                mt.MT_ADAM.name: 1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0 = float(step())                           # warm-up
    warm_ms = (time.perf_counter() - t0) * 1e3
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    step_ms, issue_ms, issue_cpu_ms, losses = [], [], [], []
    for i in range(TRAIN_STEPS):
        before = {k.name: k.launches for k in _dispatch.KERNELS}
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        loss = step()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        issue_cpu_ms.append((time.process_time() - c0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        launched = {k.name: k.launches - before[k.name] for k in _dispatch.KERNELS}
        if _nonzero(launched) != per_step:
            raise AssertionError(f"openfold step {i} launched {launched}, "
                                 f"expected {per_step}")
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, [loss0] + losses)) or not losses[0] < loss0 \
            or not all(a > b_ for a, b_ in zip(losses, losses[1:])):
        raise AssertionError(f"openfold loss {loss0} then {losses}: not finite "
                             f"and falling every step")
    med = statistics.median(step_ms)
    out = dict(config="openfold MSA row attention with pair bias",
               widths=dict(c), precision="bf16 weights, activations and pair "
               "bias; fp32 loss, FusedAdamSWA fp32 masters and average",
               optimizer="FusedAdamSWA(lr=1e-3, ApexAdamW, swa_decay_rate=0.9)",
               params=sum(p.numel() for p in params), tensors=len(params),
               masked_positions=int((~mask).sum()), positions=mask.numel(),
               warmup_loss=loss0, losses=losses, warmup_ms=warm_ms,
               step_ms=step_ms, step_ms_median=med, step_issue_ms=issue_ms,
               step_issue_cpu_ms=issue_cpu_ms, peak_mem_bytes=peak,
               allocated_before_bytes=allocated_before,
               mt_table_bytes=mt_table_bytes(),
               launches=launches, launches_per_step=per_step)
    log("phase3-openfold", **out)
    out["profile"] = _profile(step, med)
    out["profile"]["phases_ms"] = _openfold_phases(blocks, opt, args, h)
    log("phase3-openfold-profile", **out["profile"])

    # the Evoformer training crop: routed to the materialized path
    crop = 256
    _dispatch.reset_launches()
    wc = blocks[0]
    mc = m[:, :, :crop].contiguous()
    zc = z[:, :crop, :crop].contiguous()
    maskc = mask[..., :crop].contiguous()
    loss_c = torch.mean((msa_row_block(mc, zc, wc, maskc, h).float()
                         - target[:, :, :crop]) ** 2)
    loss_c.backward()
    torch.cuda.synchronize()
    crop_launches = _nonzero({k.name: k.launches for k in _dispatch.KERNELS})
    expected = {ln.LAYER_NORM_FWD.name: 2, ln.LAYER_NORM_BWD.name: 2}
    loss_c = float(loss_c.detach())
    if crop_launches != expected or not math.isfinite(loss_c):
        raise AssertionError(f"openfold block at N_res {crop}: launches "
                             f"{crop_launches}, expected {expected}; loss "
                             f"{loss_c}")
    out["crop_256"] = dict(launches=crop_launches, loss=loss_c,
                           route="materialized (attention_core's s >= 1024 "
                                 "gate)")
    log("phase3-openfold-crop", **out["crop_256"])
    opt.zero_grad(set_to_none=True)
    del blocks, opt, params, m, z, mask, target, args
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: data parallelism (parallel/, contrib/optimizers) at world 1
# ---------------------------------------------------------------------------

RESNET_BATCH = 128      # bench.py's resnet50 card: b 128 x 224^2 x 3
RESNET_STEPS = 8        # timed steps after one warm-up, each precision
RESNET_BITS_STEPS = 3   # steps of the DDP + SyncBN run against local BN
# resnet10_ish at 32^2 x 8, fp32 (O0, TF32 off), 3 steps card against the
# CPU from one init: the losses, and every tensor of the state after the
# steps relative to its largest value (on an H100 at 700 W: 1.2e-7 and
# 4.4e-4, the latter a small batch-norm bias three SGD steps from 0)
RESNET_SMALL_LOSS_TOL = 1e-5
RESNET_SMALL_STATE_TOL = 2e-3
# 53 batch norms: one all-reduce in each forward and each backward, and
# the DDP buckets (bf16 convolutions and head, fp32 batch norms)
RESNET_BN_LAYERS = 53
ZERO_STEPS = 3          # steps after one warm-up, ZeRO and FusedAdam
# ZeRO against FusedAdam from the same weights.  After the warm-up step
# (the same parameters, so the same gradients) their fp32 masters differ
# only by the two updates' fp32 rounding: within ZERO_MASTER_TOL of the
# largest master.  Later losses drift apart because ZeRO's bf16 parameters
# truncate the masters where FusedAdam's round them: on an H100 at 700 W
# by 3.7e-3, 2.0e-2 and 2.3e-3 over 3 steps (a step without the update
# keeps the loss 1.6 above FusedAdam's)
ZERO_MASTER_TOL = 1e-6         # on an H100 at 700 W: 6.0e-8 (one ulp)
ZERO_LOSS_TOL = 5e-2
LARC_TOL = 1e-6         # LARC(FusedSGD) card against CPU, parameters


@contextlib.contextmanager
def _nccl_world(prefix: str):
    """An NCCL group of world 1 over a ``file://`` rendezvous in a
    temporary directory; the group and the directory go however the block
    ends."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    rdv = tempfile.mkdtemp(prefix=prefix)
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)


def _launch_counts() -> dict:
    from apex_tpu_torch.ops import _dispatch

    return {k.name: k.launches for k in _dispatch.KERNELS}


def _resnet_run(device, half: str, steps: int, **kw) -> dict:
    """``imagenet_main.run_training`` of ResNet-50 at b 128 x 224^2, O2,
    with the launches and ``torch.distributed`` calls it
    made, its peak memory and its wall."""
    import torch
    from apex_tpu_torch.examples import imagenet_main as im
    from apex_tpu_torch.ops import _dispatch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    with _DistCalls() as calls:
        res = im.run_training(
            arch="resnet50", opt_level="O2", half=half,
            loss_scale="dynamic" if half == "fp16" else None,
            batch_size=RESNET_BATCH, image_size=224, num_classes=1000,
            steps=steps, lr=0.1, seed=0, verbose=False, device=device, **kw)
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = _launch_counts()
    res["dist_calls"] = dict(calls.counts)
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return res


def _resnet_overflow_check(res: dict, device) -> dict:
    """One more fp16 step of a trained run with an inf written into one
    gradient after the backward: every parameter, master, momentum buffer
    and the step counter keep their bits, and the scale halves."""
    import torch
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import imagenet_main as im

    model, opt, state = res["model"], res["optimizer"], res["scaler_state"]
    net = res["net"]
    policy = get_policy("O2", half_dtype=torch.float16)
    scaler = policy.make_scaler()
    images, labels = im._to_device(*im.synthetic_batch(
        RESNET_BATCH, 224, 1000, 0), device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_before = [{k: v.clone() for k, v in opt.state[p].items()}
                  for p in model.parameters()]
    scale0 = float(state.scale)
    opt.zero_grad(set_to_none=True)
    im.forward_backward(net, images, labels, policy, scaler, state)
    next(p for p in model.parameters()).grad.view(-1)[0].fill_(float("inf"))
    found_inf, state = im.apply_update(opt, policy, scaler, state)
    kept = all(torch.equal(before[n], p) for n, p in model.named_parameters())
    kept_state = all(torch.equal(v, opt.state[p][k])
                     for p, st in zip(model.parameters(), opt_before)
                     for k, v in st.items())
    out = dict(found_inf=bool(found_inf), params_kept=kept,
               optimizer_state_kept=kept_state, scale_before=scale0,
               scale_after=float(state.scale))
    if not (out["found_inf"] and kept and kept_state
            and out["scale_after"] == scale0 / 2):
        raise AssertionError(f"resnet50 fp16 forced overflow: {out}")
    return out


def _resnet_bits_check(device) -> dict:
    """DDP + SyncBatchNorm over the NCCL group of world 1 against the
    same run with neither (local batch norm in the Welford form the group
    path merges), ``RESNET_BITS_STEPS`` bf16 steps each with cuDNN's
    deterministic algorithms: the losses, every parameter and every
    running statistic bit for bit (at one rank the collectives move
    nothing)."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for name, distributed in (("ddp_syncbn", True), ("local", False)):
            res = _resnet_run(device, "bf16", RESNET_BITS_STEPS,
                              distributed=distributed,
                              use_fast_variance=False)
            runs[name] = dict(
                losses=res["losses"], dist_calls=res["dist_calls"],
                state={k: v.detach().cpu()
                       for k, v in res["model"].state_dict().items()})
            del res
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    a, b = runs["ddp_syncbn"], runs["local"]
    diff = [k for k in a["state"] if not torch.equal(a["state"][k],
                                                      b["state"][k])]
    out = dict(losses_ddp_syncbn=a["losses"], losses_local=b["losses"],
               dist_calls_ddp_syncbn=a["dist_calls"],
               dist_calls_local=b["dist_calls"],
               tensors=len(a["state"]), tensors_differing=diff[:10],
               bitwise_equal=a["losses"] == b["losses"] and not diff)
    if not out["bitwise_equal"]:
        raise AssertionError(f"resnet50 DDP + SyncBN at world 1 differs "
                             f"from local BN: {out}")
    return out


def resnet_small_check(device) -> dict:
    """``resnet10_ish`` at 32^2 x 8 in fp32 (O0), 3 steps of
    ``run_training`` without DDP on the card and on the CPU from one
    init (the CPU's seeded model): losses and every parameter after the
    steps within ``RESNET_SMALL_LOSS_TOL`` and
    ``RESNET_SMALL_STATE_TOL`` (each tensor relative to its largest
    value)."""
    import torch
    from apex_tpu_torch.examples import imagenet_main as im

    init = im.resnet10_ish(10, device="cpu", seed=0).state_dict()
    kw = dict(arch="resnet10", opt_level="O0", batch_size=8, image_size=32,
              num_classes=10, steps=3, lr=0.1, verbose=False,
              distributed=False, init_state=init)
    cpu = im.run_training(device="cpu", **kw)
    card = im.run_training(device=device, **kw)
    loss_err = max(abs(a - b) for a, b in zip(cpu["losses"], card["losses"]))
    cs, gs = cpu["model"].state_dict(), card["model"].state_dict()
    errs = {k: float((cs[k] - gs[k].cpu()).abs().max()
                     / max(float(cs[k].abs().max()), 1e-12))
            for k in cs if cs[k].is_floating_point()}
    worst = max(errs, key=errs.get)
    out = dict(losses_cpu=cpu["losses"], losses_card=card["losses"],
               loss_max_abs_err=loss_err, state_max_rel_err=errs[worst],
               worst_tensor=worst, loss_tol=RESNET_SMALL_LOSS_TOL,
               state_tol=RESNET_SMALL_STATE_TOL)
    if not (loss_err <= RESNET_SMALL_LOSS_TOL
            and errs[worst] <= RESNET_SMALL_STATE_TOL):
        raise AssertionError(f"resnet10_ish card vs CPU: {out}")
    log("phase3-resnet-reference", **out)
    return out


def resnet50_train(device, smi: str) -> dict:
    """Phase ``phase3-train-resnet50`` (see the module docstring)."""
    import torch
    from apex_tpu_torch.examples import imagenet_main as im
    from apex_tpu_torch.ops import multi_tensor as mt

    t_phase = time.perf_counter()
    steps = 1 + RESNET_STEPS
    out = dict(nvidia_smi=smi, config="resnet50", batch=RESNET_BATCH,
               image_size=224, steps=f"1 warm-up + {RESNET_STEPS}",
               precision="O2 (convolutions and head bf16 / fp16, batch norms "
                         "fp32, FusedSGD fp32 masters), NHWC activations")
    flops = im.conv_flops(im.ResNet(device="meta"), 224, RESNET_BATCH)
    with _nccl_world("resnet_rdv_"):
        for half in ("bf16", "fp16"):
            res = _resnet_run(device, half, steps)
            losses = res["losses"]
            want = {mt.MT_SCALE.name: steps} if half == "fp16" else {}
            calls = res["dist_calls"]
            all_reduce = calls.get("all_reduce", 0)
            step_p50 = statistics.median(res["step_ms"])
            row = dict(
                losses=losses, step_ms=res["step_ms"], step_ms_p50=step_p50,
                imgs_per_s=RESNET_BATCH / (step_p50 / 1e3),
                imgs_per_s_mean=res["imgs_per_sec"],
                flops_per_step=flops, bound_ms=flops / 989e12 * 1e3,
                mfu=flops / (step_p50 / 1e3) / 989e12,
                peak_mem_bytes=res["peak_mem_bytes"],
                real_overflows=sum(res["found_inf"]),
                final_scale=res["final_scale"], wall_s=res["wall_s"],
                dist_calls=calls, all_reduces_per_step=all_reduce / steps,
                launches=res["launches"],
                launches_per_step={k: n / steps for k, n in
                                   _nonzero(res["launches"]).items()})
            if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"resnet50 {half}: loss {losses} is not "
                                     f"finite and falling")
            if _nonzero(res["launches"]) != want:
                raise AssertionError(f"resnet50 {half}: launches "
                                     f"{_nonzero(res['launches'])}, expected "
                                     f"{want}")
            if all_reduce != steps * (2 * RESNET_BN_LAYERS + 2):
                raise AssertionError(f"resnet50 {half}: {all_reduce} "
                                     f"all-reduces in {steps} steps")
            if half == "bf16":
                model, opt = res["model"], res["optimizer"]
                images, labels = im._to_device(*im.synthetic_batch(
                    RESNET_BATCH, 224, 1000, 0), device)
                policy = im.get_policy("O2", half_dtype=torch.bfloat16)
                scaler = policy.make_scaler()
                state = res["scaler_state"]
                net = res["net"]
                row["profile"] = _profile(
                    lambda: im.train_step(net, opt, images, labels, policy,
                                          scaler, state), step_p50)
                del net, images, labels
            else:
                row["forced_overflow"] = _resnet_overflow_check(res, device)
            out[half] = row
            log(f"phase3-train-resnet50-{half}",
                **{k: v for k, v in row.items() if k != "launches"})
            del res
            torch.cuda.empty_cache()
        out["bits"] = _resnet_bits_check(device)
        log("phase3-train-resnet50-bits", **out["bits"])
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-train-resnet50-done", phase_s=out["phase_s"])
    return out


def _zero_llama(device, opt_fn, per_step, steps: int, ids,
                after_warmup=None) -> dict:
    """``llama-1b`` with every parameter bf16 (the norm scales too: the
    remainders rebuild fp32 masters from bf16 words), fp32 init from the
    seeded generator, 1 warm-up + ``steps`` of ``llama_pretrain.
    train_step`` under ``opt_fn(params)``: losses, walls, launches
    (checked against ``per_step``) and ``torch.distributed`` calls a
    step; ``after_warmup(opt)`` is called after the warm-up step."""
    import torch
    from apex_tpu_torch.examples.llama_pretrain import train_step
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from apex_tpu_torch.ops import _dispatch

    cfg = LlamaConfig.llama_1b()
    gen = torch.Generator(device=device).manual_seed(0)
    model = LlamaForCausalLM(cfg, device=device, generator=gen).to(
        torch.bfloat16)
    opt = opt_fn(model.parameters())
    torch.cuda.synchronize()
    loss0 = float(train_step(model, opt, ids))
    if after_warmup is not None:
        after_warmup(opt)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, calls = [], [], []
    for i in range(steps):
        _dispatch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _DistCalls() as dc:
            loss = train_step(model, opt, ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        calls.append(dict(dc.counts))
        if _nonzero(_launch_counts()) != per_step:
            raise AssertionError(f"zero llama-1b step {i} launched "
                                 f"{_nonzero(_launch_counts())}, expected "
                                 f"{per_step}")
    return dict(model=model, opt=opt, warmup_loss=loss0, losses=losses,
                step_ms=step_ms, step_ms_p50=statistics.median(step_ms),
                dist_calls=calls, launches=_launch_counts(),
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def llama_1b_train_zero(device, smi: str) -> dict:
    """Phase ``phase3-train-zero`` (see the module docstring)."""
    import torch
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.contrib.optimizers._zero_base import (
        _merge_bf16,
        _split_bf16,
    )
    from apex_tpu_torch.examples.llama_pretrain import _params
    from apex_tpu_torch.models import LlamaConfig
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.packing import pack_pytree

    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama_1b()
    b, s, layers = 4, 2048, cfg.num_hidden_layers
    ids = torch.randint(0, cfg.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(8)).to(device)
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                fa.FLASH_ATTENTION_FWD.name: layers,
                fa.FLASH_ATTENTION_DQ.name: layers,
                fa.FLASH_ATTENTION_DKV.name: layers,
                lh.FUSED_LM_HEAD_FWD.name: 1, lh.FUSED_LM_HEAD_DH.name: 1,
                lh.FUSED_LM_HEAD_DE.name: 1}
    out = dict(nvidia_smi=smi, config="llama-1b", batch=b, seq=s,
               steps=f"1 warm-up + {ZERO_STEPS}",
               precision="every parameter bf16; lr 1e-3, bf16 moments; "
                         "ZeRO: store_param_remainders; FusedAdam: fp32 "
                         "masters")
    # the round trip over every bit pattern's neighbourhood: random words
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 24,), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(3)
                          ).to(torch.int32).to(device)
    hi, lo = _split_bf16(words.view(torch.float32))
    out["remainder_roundtrip_random_words"] = torch.equal(
        _merge_bf16(hi, lo).view(torch.int32), words)
    masters = {}

    def zero_masters(opt):
        flat = pack_pytree(_params(opt), dtype=torch.bfloat16, pad_to=1024).flat
        masters["zero"] = _merge_bf16(flat, opt.zero_state.remainder_shard
                                      )[:sum(p.numel() for p in _params(opt))
                                        ].cpu()

    def adam_masters(opt):
        got = torch.cat([opt.state[p]["master_param"].reshape(-1)
                         for p in _params(opt)])
        want = masters.pop("zero").to(device)
        masters["max_abs_diff"] = float((got - want).abs().max())
        masters["max_abs"] = float(want.abs().max())

    with _nccl_world("zero_rdv_") as group:
        zero = _zero_llama(
            device, lambda ps: DistributedFusedAdam(
                ps, lr=1e-3, state_dtype=torch.bfloat16,
                store_param_remainders=True, process_group=group),
            per_step, ZERO_STEPS, ids, zero_masters)
        model, opt = zero.pop("model"), zero.pop("opt")
        st = opt.zero_state
        flat = pack_pytree(_params(opt), dtype=torch.bfloat16,
                           pad_to=1024).flat
        hi, lo = _split_bf16(_merge_bf16(flat, st.remainder_shard))
        out["remainder_roundtrip_state"] = (
            torch.equal(hi.view(torch.int16), flat.view(torch.int16))
            and torch.equal(lo, st.remainder_shard))
        # a skipped step: found_inf keeps the parameters and the state
        before = [p.detach().clone() for p in _params(opt)]
        state_before = [t.clone() if t is not None else None for t in st]
        labels = torch.roll(ids, -1, dims=1)
        opt.zero_grad(set_to_none=True)
        model(ids, labels=labels).mean().backward()
        opt.step(found_inf=torch.ones((), dtype=torch.bool, device=device))
        out["found_inf_kept"] = (
            all(torch.equal(a, p) for a, p in zip(before, _params(opt)))
            and all((a is None and c is None) or torch.equal(a, c)
                    for a, c in zip(state_before, opt.zero_state)))
        del model, opt, st, flat, hi, lo, before, state_before
        torch.cuda.empty_cache()
    adam = _zero_llama(
        device, lambda ps: FusedAdam(ps, lr=1e-3, state_dtype=torch.bfloat16,
                                     master_weights=True),
        dict(per_step, **{mt.MT_ADAM.name: 1}), ZERO_STEPS, ids, adam_masters)
    del adam["model"], adam["opt"]
    torch.cuda.empty_cache()
    out["zero"], out["fused_adam"] = zero, adam
    out["loss_max_abs_diff"] = max(
        abs(a - c) for a, c in zip([zero["warmup_loss"]] + zero["losses"],
                                   [adam["warmup_loss"]] + adam["losses"]))
    out["warmup_master_max_abs_diff"] = masters["max_abs_diff"]
    out["warmup_master_rel_diff"] = masters["max_abs_diff"] / masters["max_abs"]
    out["step_p50_ratio_zero_to_fused_adam"] = (zero["step_ms_p50"]
                                                / adam["step_ms_p50"])
    colls = [{k: c.get(k, 0) for k in ("reduce_scatter_tensor",
                                       "all_gather_into_tensor",
                                       "all_reduce")} for c in zero["dist_calls"]]
    out["collectives_per_step"] = colls
    out["launches"] = zero["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-train-zero", **{k: v for k, v in out.items()
                                if k != "launches"})
    if not (out["remainder_roundtrip_random_words"]
            and out["remainder_roundtrip_state"] and out["found_inf_kept"]
            and out["loss_max_abs_diff"] <= ZERO_LOSS_TOL
            and out["warmup_master_rel_diff"] <= ZERO_MASTER_TOL
            and all(c == {"reduce_scatter_tensor": 1,
                          "all_gather_into_tensor": 1, "all_reduce": 0}
                    for c in colls)
            and zero["losses"][-1] < zero["warmup_loss"]):
        raise AssertionError(f"phase3-train-zero gates: {out}")
    return out


def larc_check(device) -> dict:
    """Phase ``phase3-larc``: ``LARC(FusedSGD(lr 0.1, momentum 0.9,
    weight decay 1e-4))`` over ResNet-50's parameter list (fp32) and one
    step's gradients (b 8 x 64^2 on the CPU), on the card and on the
    CPU: ``mt_l2norm`` twice on the card, the parameters within
    ``LARC_TOL`` (relative to the largest)."""
    import torch
    from apex_tpu_torch.examples import imagenet_main as im
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import LARC

    model = im.resnet50(1000, device="cpu", seed=0)
    images, labels = im._to_device(*im.synthetic_batch(8, 64, 1000, 0),
                                   "cpu")
    im.cross_entropy(model(images), labels).backward()
    cpu = [p.detach().clone() for p in model.parameters()]
    grads = [p.grad.clone() for p in model.parameters()]
    results = {}
    for dev in ("cpu", device):
        ps = [torch.nn.Parameter(p.to(dev, copy=True)) for p in cpu]
        for p, g in zip(ps, grads):
            p.grad = g.to(dev, copy=True)
        opt = LARC(FusedSGD(ps, lr=0.1, momentum=0.9, weight_decay=1e-4))
        _dispatch.reset_launches()
        opt.step()
        results[str(dev)] = ([p.detach().cpu() for p in ps],
                             _nonzero(_launch_counts()))
    (pc, lc), (pg, lg) = results["cpu"], results[str(device)]
    err = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-12)
              for a, b in zip(pc, pg))
    moved = max(float((a - b).abs().max()) for a, b in zip(pc, cpu))
    out = dict(tensors=len(cpu), elements=sum(p.numel() for p in cpu),
               max_rel_err=err, tol=LARC_TOL, max_update=moved,
               launches_card=lg, launches_cpu=lc)
    log("phase3-larc", **out)
    if not (err <= LARC_TOL and moved > 0 and lg == {mt.MT_L2NORM.name: 2}
            and not lc):
        raise AssertionError(f"phase3-larc: {out}")
    out["launches"] = {k: lg.get(k, 0) for k in _launch_counts()}
    return out


# ---------------------------------------------------------------------------
# phase 3: BERT-large, ViT-L/16, activation recompute (GPT-1.3B, Llama) and
# the transformer layers' dropout
# ---------------------------------------------------------------------------

SLICE_STEPS = 4         # timed steps after one warm-up, each training card
# BERT-large's: its NSP term (16 random labels) swings under LAMB's first
# steps (0.68, 2.59, 0.38, 0.25, 1.59 on an H100 at 700 W) while the
# masked-LM term falls every step; by the 8th the sum is well below
BERT_STEPS = 8
POLICY_LAYERS = 4       # the named policies and Llama's recompute: depth
DROPOUT_LAYERS = 4      # the dropout stack at GPT-2-large's width: depth
DROPOUT_RATE = 0.1
# the dropout stack's width and tokens: GPT-2-large's (bench.py:81-84)
DROPOUT_SHAPE = dict(hidden=1280, heads=20, seq=1024, batch=8)


def small_bert_check(device) -> dict:
    """A small fp32 BERT (2 layers, hidden 128, 2 heads of 64, vocab 512, b
    4 x s 128, ``tools/model_bench.py``'s batch: padding, 15% masked) on
    the card and on the CPU, flash (padding segment ids) and the
    materialized core (the 4-d mask through the fused softmax): the MLM +
    NSP loss, every gradient and 3 ``FusedLAMB`` steps (lr 1e-3)."""
    import numpy as np
    import torch
    from apex_tpu_torch.examples import bert_pretrain as bp
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.testing import BertModel

    whole = bp.bench_batch(np.random.default_rng(41), 4, 128, 512)
    out = {}
    for flash in (True, False):
        def build(dev, flash=flash):
            return BertModel(num_layers=2, hidden_size=128,
                             num_attention_heads=2, vocab_size=512,
                             max_sequence_length=128,
                             use_flash_attention=flash, device=dev,
                             generator=torch.Generator().manual_seed(42)
                             if dev == "cpu" else None)

        def loss_of(model, dev):
            return bp.loss_fn(model, *bp.to_device(whole, dev))

        out["flash" if flash else "fused_softmax"] = _card_vs_cpu(
            f"small BERT (flash={flash})", build, loss_of,
            lambda ps: FusedLAMB(ps, lr=1e-3), 1e-3, device)
    out["tolerance"] = SMALL_CARD_TOL
    log("phase3-bert-reference", **out)
    return out


def small_vit_check(device) -> dict:
    """A small fp32 ViT (image 32, patch 8, 2 layers of 128, 2 heads, 10
    labels, b 8) on the card and on the CPU: the cross entropy, every
    gradient and 3 ``FusedAdam(lr 3e-4, wd 0.05)`` steps."""
    import torch
    from apex_tpu_torch.models import ViTConfig, ViTForImageClassification
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = ViTConfig(image_size=32, patch_size=8, hidden_size=128,
                    num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=256, num_labels=10)
    g = torch.Generator().manual_seed(43)
    pixels = torch.randn(8, 32, 32, 3, generator=g)
    labels = torch.randint(0, 10, (8,), generator=g)

    def build(dev):
        return ViTForImageClassification(
            cfg, device=dev, generator=torch.Generator().manual_seed(44)
            if dev == "cpu" else None)

    def loss_of(model, dev):
        logits = model(pixels.to(dev)).float()
        return torch.nn.functional.cross_entropy(logits, labels.to(dev))

    out = _card_vs_cpu("small ViT", build, loss_of,
                       lambda ps: FusedAdam(ps, lr=3e-4, weight_decay=0.05),
                       3e-4, device)
    out["tolerance"] = SMALL_CARD_TOL
    log("phase3-vit-reference", **out)
    return out


def _mfu(out: dict, flops: float, tokens: int) -> dict:
    med = out["step_ms_median"]
    out.update(flops_per_step=flops, bound_ms=flops / 989e12 * 1e3,
               mfu=flops / (med / 1e3) / 989e12,
               tokens_per_s=tokens / (med / 1e3))
    return out


def bert_large_train(device, smi: str) -> dict:
    """BERT-large pretraining (``tools/model_bench.py``'s card through
    :mod:`apex_tpu_torch.examples.bert_pretrain`: 24 x 1024, 16 heads,
    vocab 30592, b 16 x s 512, 15% masked, lengths in [0.9 s, s], the O2
    cast, ``FusedLAMB(lr 1e-3)`` with bf16 moments) over
    ``DistributedDataParallel`` in an NCCL world of 1: one warm-up step,
    then ``BERT_STEPS`` timed steps with exact launches a step."""
    import numpy as np
    import torch
    from apex_tpu_torch.examples import bert_pretrain as bp
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.parallel import DistributedDataParallel

    c = bp.LARGE
    layers = c["layers"]
    # per layer two LayerNorms and one flash attention (padding segment
    # ids, not causal); the transformer's final LayerNorm and the LM
    # head's; LAMB: the clip norm, then both stages in one call
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 2,
                ln.LAYER_NORM_BWD.name: 2 * layers + 2,
                fa.FLASH_ATTENTION_FWD.name: layers,
                fa.FLASH_ATTENTION_DQ.name: layers,
                fa.FLASH_ATTENTION_DKV.name: layers,
                mt.MT_L2NORM.name: 1, mt.MT_LAMB.name: 1}
    with _nccl_world("bert_rdv_") as group:
        model, opt = bp.build(c["layers"], c["hidden"], c["heads"], c["vocab"],
                              c["seq"], o2=True, state_dtype=torch.bfloat16,
                              device=device)
        ddp = DistributedDataParallel(model, group)
        whole = bp.bench_batch(np.random.default_rng(0), c["batch"], c["seq"],
                               c["vocab"])
        batch = ddp.shard_batch(bp.to_device(whole, device))
        n = sum(p.numel() for p in model.parameters())
        step = lambda: bp.train_step(ddp, opt, batch, group)
        out = _train_steps(step, BERT_STEPS, per_step, "BERT-large")
        out["profile"] = _profile(step, out["step_ms_median"])
    tokens = c["batch"] * c["seq"]
    # 6 N a token plus the attention's 12 L h s (not causal)
    flops = float((6 * n + 12 * layers * c["hidden"] * c["seq"]) * tokens)
    out = dict(config="bert-large", nvidia_smi=smi, params=n, **c,
               masked_tokens=int(whole[3].sum()), tokens=tokens,
               precision="O2: 2-d parameters bf16, biases and LayerNorm fp32",
               optimizer="FusedLAMB(lr=1e-3, state_dtype=bf16) over "
                         "DistributedDataParallel (NCCL world 1)", **out)
    _mfu(out, flops, tokens)
    log("phase3-train-bert-large", **out)
    del model, opt, ddp, batch
    torch.cuda.empty_cache()
    return out


def vit_l16_train(device, smi: str) -> dict:
    """ViT-L/16 training (``tools/model_bench.py``'s card: b 64 x 224^2 x 3
    bf16 pixels, 1000 classes, every parameter of two or more dims bf16,
    ``FusedAdam(lr 3e-4, wd 0.05)``, fp32 log-softmax cross entropy): one
    warm-up step, then ``SLICE_STEPS`` timed steps with exact launches."""
    import torch
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.models import ViTConfig, ViTForImageClassification
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = ViTConfig.vit_l16()
    batch = 64
    model = ViTForImageClassification(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    o2_cast(model)
    opt = FusedAdam(model.parameters(), lr=3e-4, weight_decay=0.05)
    g = torch.Generator(device=device).manual_seed(1)
    pixels = torch.randn(batch, 224, 224, 3, generator=g,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_labels, (batch,), generator=g,
                           device=device)

    def step():
        opt.zero_grad(set_to_none=True)
        logits = model(pixels).float()
        loss = torch.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    layers = cfg.num_hidden_layers
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                mt.MT_ADAM.name: 1}
    out = _train_steps(step, SLICE_STEPS, per_step, "ViT-L/16")
    out["profile"] = _profile(step, out["step_ms_median"])
    n = sum(p.numel() for p in model.parameters())
    s = cfg.num_patches + 1
    # 6 N a token plus the attention's 12 L h s (not causal); the patch
    # embedding is among N
    flops = float((6 * n + 12 * layers * cfg.hidden_size * s) * batch * s)
    out = dict(config="vit-l16", nvidia_smi=smi, params=n, batch=batch,
               tokens=batch * s, image=[224, 224, 3],
               precision="bf16 pixels, 2-d+ parameters bf16, biases and "
                         "LayerNorm fp32; the attention in fp32",
               optimizer="FusedAdam(lr=3e-4, weight_decay=0.05)", **out)
    _mfu(out, flops, batch * s)
    log("phase3-train-vit-l16", **out)
    del model, opt, pixels
    torch.cuda.empty_cache()
    return out


def _loss_and_grads(model, fn) -> tuple:
    """``fn()``'s loss, its backward, every gradient (a copy on the card)
    and the launches of the forward and the backward."""
    for p in model.parameters():
        p.grad = None
    before = _launch_counts()
    loss = fn()
    loss.backward()
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, _nonzero(launches)


def _grads_equal(a: dict, b: dict) -> dict:
    import torch

    worst = max(float((a[n].float() - b[n].float()).abs().max()) for n in a)
    equal = all(torch.equal(a[n], b[n]) for n in a)
    return dict(max_abs_diff=worst, bit_equal=equal)


def _extra(launches: dict, base: dict) -> dict:
    return {k: launches.get(k, 0) - base.get(k, 0)
            for k in set(launches) | set(base)
            if launches.get(k, 0) != base.get(k, 0)}


def gpt13b_train(device, smi: str) -> dict:
    """``bench.py``'s ``1.3b`` card (24 x 2048, 32 heads, vocab 50304, b 8 x
    s 1024, O2, ``FusedLAMB(lr 1e-3)`` with bf16 moments) through
    :mod:`apex_tpu_torch.examples.gpt_pretrain`, with whole-layer
    recompute beside the same model without it: at the initial weights
    the loss and every gradient of both, equal bit for bit, the recompute's
    extra launches exactly 48 LayerNorm forwards and 24 flash forwards;
    then ``SLICE_STEPS`` timed steps of each after a warm-up (step p50,
    MFU, peak memory), the recompute's peak below the plain step's.  Then
    the named policies at ``POLICY_LAYERS`` layers of the same width."""
    import torch
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt

    c = gpt_pretrain.CONFIGS["1.3b"]
    layers, b, s = c["layers"], c["batch"], c["seq"]
    model, opt = gpt_pretrain.build(c["layers"], c["hidden"], c["heads"],
                                    c["vocab"], c["seq"], remat=c["remat"],
                                    state_dtype=c["state_dtype"], device=device)
    stack = model.language_model.transformer
    ids = torch.randint(0, c["vocab"], (b, s),
                        generator=torch.Generator().manual_seed(13)).to(device)
    labels = torch.roll(ids, -1, dims=1)

    def fwd():
        return model(ids, labels=labels).mean()

    stack.activations_checkpoint = False
    loss_p, grads_p, launch_p = _loss_and_grads(model, fwd)
    stack.activations_checkpoint = True
    loss_r, grads_r, launch_r = _loss_and_grads(model, fwd)
    extra = _extra(launch_r, launch_p)
    want = {ln.LAYER_NORM_FWD.name: 2 * layers, fa.FLASH_ATTENTION_FWD.name: layers}
    same = _grads_equal(grads_r, grads_p)
    del grads_p, grads_r
    if extra != want or loss_r != loss_p or not same["bit_equal"]:
        raise AssertionError(f"GPT-1.3B recompute: extra launches {extra} "
                             f"(expected {want}), loss {loss_r} vs {loss_p}, "
                             f"gradients {same}")
    per_plain = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                 ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                 fa.FLASH_ATTENTION_FWD.name: layers,
                 fa.FLASH_ATTENTION_DQ.name: layers,
                 fa.FLASH_ATTENTION_DKV.name: layers,
                 lh.FUSED_LM_HEAD_FWD.name: 1, lh.FUSED_LM_HEAD_DH.name: 1,
                 lh.FUSED_LM_HEAD_DE.name: 1,
                 mt.MT_L2NORM.name: 1, mt.MT_LAMB.name: 1}
    per_remat = {k: v + want.get(k, 0) for k, v in per_plain.items()}
    n = sum(p.numel() for p in model.parameters())
    flops = float((6 * n + 12 * layers * c["hidden"] * s // 2) * b * s)
    runs = {}
    for name, remat, per_step in (("remat", True, per_remat),
                                  ("plain", False, per_plain)):
        stack.activations_checkpoint = remat
        torch.cuda.empty_cache()
        step = lambda: gpt_pretrain.train_step(model, opt, ids)
        runs[name] = _mfu(_train_steps(step, SLICE_STEPS, per_step,
                                       f"GPT-1.3B ({name})"), flops, b * s)
        runs[name]["profile"] = _profile(step, runs[name]["step_ms_median"])
    stack.activations_checkpoint = True
    if not runs["remat"]["peak_mem_bytes"] < runs["plain"]["peak_mem_bytes"]:
        raise AssertionError(f"GPT-1.3B: recompute peak "
                             f"{runs['remat']['peak_mem_bytes']} not below "
                             f"{runs['plain']['peak_mem_bytes']}")
    out = dict(config="gpt-1.3b", nvidia_smi=smi, params=n, batch=b, seq=s,
               precision="O2: 2-d parameters bf16, biases and LayerNorm fp32",
               optimizer="FusedLAMB(lr=1e-3, state_dtype=bf16), unpacked",
               recompute_check=dict(loss=loss_r, loss_plain=loss_p,
                                    extra_launches=extra,
                                    launches_remat=launch_r,
                                    launches_plain=launch_p, **same),
               remat=runs["remat"], plain=runs["plain"],
               peak_saved_bytes=runs["plain"]["peak_mem_bytes"]
               - runs["remat"]["peak_mem_bytes"],
               step_cost=runs["remat"]["step_ms_median"]
               / runs["plain"]["step_ms_median"],
               tolerance="recomputed loss and every gradient equal to the "
                         "plain step's bit for bit")
    log("phase3-train-gpt-1.3b", **{k: v for k, v in out.items()
                                    if k not in ("remat", "plain")},
        remat={k: v for k, v in runs["remat"].items() if k != "launches"},
        plain={k: v for k, v in runs["plain"].items() if k != "launches"})
    del model, opt, stack
    torch.cuda.empty_cache()
    out["policies"] = gpt_policies(device, c, smi)
    return out


def gpt_policies(device, c: dict, smi: str) -> dict:
    """The named recompute policies at ``POLICY_LAYERS`` layers of the
    GPT-1.3B card's width (flash path, O2, b 8 x s 1024): for each, one
    forward and backward at the same weights against no recompute, the
    loss and every gradient bit for bit, and the extra launches of the
    backward exactly what the policy recomputes: ``"dots"`` and
    ``"dots_no_batch"`` both LayerNorms and the flash forward of every
    layer, ``"except_activations"`` both LayerNorms and no flash."""
    import torch
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln

    L = POLICY_LAYERS
    model, _ = gpt_pretrain.build(L, c["hidden"], c["heads"], c["vocab"],
                                  c["seq"], device=device)
    stack = model.language_model.transformer
    ids = torch.randint(0, c["vocab"], (c["batch"], c["seq"]),
                        generator=torch.Generator().manual_seed(14)).to(device)
    labels = torch.roll(ids, -1, dims=1)

    def fwd():
        return model(ids, labels=labels).mean()

    loss_p, grads_p, launch_p = _loss_and_grads(model, fwd)
    want = {"dots": {ln.LAYER_NORM_FWD.name: 2 * L,
                     fa.FLASH_ATTENTION_FWD.name: L},
            "dots_no_batch": {ln.LAYER_NORM_FWD.name: 2 * L,
                              fa.FLASH_ATTENTION_FWD.name: L},
            "except_activations": {ln.LAYER_NORM_FWD.name: 2 * L}}
    out = {}
    for policy, expected in want.items():
        stack.activations_checkpoint_policy = policy
        torch.cuda.reset_peak_memory_stats()
        loss, grads, launches = _loss_and_grads(model, fwd)
        peak = torch.cuda.max_memory_allocated()
        extra = _extra(launches, launch_p)
        same = _grads_equal(grads, grads_p)
        del grads
        if extra != expected or loss != loss_p or not same["bit_equal"]:
            raise AssertionError(f"policy {policy}: extra launches {extra} "
                                 f"(expected {expected}), loss {loss} vs "
                                 f"{loss_p}, gradients {same}")
        out[policy] = dict(extra_launches=extra, peak_mem_bytes=peak, **same)
    stack.activations_checkpoint_policy = None
    stack.activations_checkpoint = False
    torch.cuda.reset_peak_memory_stats()
    _loss_and_grads(model, fwd)
    out["none_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out.update(layers=L, nvidia_smi=smi, launches_plain=launch_p,
               tolerance="loss and every gradient equal to no recompute "
                         "bit for bit")
    log("phase3-train-gpt-policies", **out)
    del model, grads_p
    torch.cuda.empty_cache()
    return out


def llama_remat_check(device, smi: str) -> dict:
    """``LlamaForCausalLM(activations_checkpoint=True)`` at ``POLICY_LAYERS``
    layers of ``llama-1b``'s width (O2, b 4 x s 2048): the loss and every
    gradient bit for bit those of the model without recompute, the extra
    launches 2 RMSNorm forwards and 1 flash forward a layer."""
    import dataclasses

    import torch
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln

    cfg = dataclasses.replace(LlamaConfig.llama_1b(),
                              num_hidden_layers=POLICY_LAYERS)
    model = o2_cast(LlamaForCausalLM(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(15)))
    ids = torch.randint(0, cfg.vocab_size, (4, 2048),
                        generator=torch.Generator().manual_seed(16)).to(device)
    labels = torch.roll(ids, -1, dims=1)

    def fwd():
        return model(ids, labels=labels).mean()

    runs = {}
    for remat in (False, True):
        model.activations_checkpoint = remat
        torch.cuda.reset_peak_memory_stats()
        runs[remat] = _loss_and_grads(model, fwd) + (
            torch.cuda.max_memory_allocated(),)
    extra = _extra(runs[True][2], runs[False][2])
    want = {ln.LAYER_NORM_FWD.name: 2 * POLICY_LAYERS,
            fa.FLASH_ATTENTION_FWD.name: POLICY_LAYERS}
    same = _grads_equal(runs[True][1], runs[False][1])
    if extra != want or runs[True][0] != runs[False][0] or not same["bit_equal"]:
        raise AssertionError(f"Llama recompute: extra launches {extra} "
                             f"(expected {want}), loss {runs[True][0]} vs "
                             f"{runs[False][0]}, gradients {same}")
    out = dict(layers=POLICY_LAYERS, nvidia_smi=smi, loss=runs[True][0],
               extra_launches=extra, launches_plain=runs[False][2],
               peak_mem_bytes_remat=runs[True][3],
               peak_mem_bytes_plain=runs[False][3], **same,
               tolerance="loss and every gradient equal to no recompute bit "
                         "for bit")
    log("phase3-train-llama-remat", **out)
    del model, runs
    torch.cuda.empty_cache()
    return out


def dropout_check(device, smi: str) -> dict:
    """A ``ParallelTransformer`` of ``DROPOUT_LAYERS`` layers at GPT-2-large's
    width (1280, 20 heads, bf16, s 1024 x b 8) with ``hidden_dropout =
    attention_dropout = 0.1``:

    - ``deterministic=False``: the flash kernels launched with the dropout
      rate forward, dq and dk/dv (each call's rate and seed recorded),
      exact launches;
    - ``deterministic=True`` equal bit for bit to the same weights without
      dropout;
    - the share of the attention's probabilities dropped (the keep bits of
      each layer's seed over its causal pairs; phase 2 holds the kernel's
      bits to them) and of the hidden activations zeroed, each within six
      standard deviations of the binomial's 0.1;
    - whole-layer recompute under dropout: the loss and every gradient
      equal bit for bit to the step without recompute from the same
      generator state (the recompute draws the same masks)."""
    import torch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.transformer.testing import standalone_transformer_lm as tlm

    h, heads, s, b = (DROPOUT_SHAPE[k] for k in ("hidden", "heads", "seq",
                                                  "batch"))
    L, rate = DROPOUT_LAYERS, DROPOUT_RATE
    gen = torch.Generator(device=device).manual_seed(17)
    kw = dict(params_dtype=torch.bfloat16, device=device)
    stack = tlm.ParallelTransformer(L, h, heads, hidden_dropout=rate,
                                    attention_dropout=rate, generator=gen,
                                    **kw)
    plain = tlm.ParallelTransformer(L, h, heads, **kw)
    plain.load_state_dict(stack.state_dict())
    x = torch.randn(s, b, h, generator=gen, device=device).to(torch.bfloat16)
    with torch.no_grad():
        det_equal = torch.equal(stack(x), plain(x))
    if not det_equal:
        raise AssertionError("dropout stack: deterministic=True differs from "
                             "the stack without dropout")
    seen = {"fwd": [], "bwd": []}
    zeros = []
    orig_fwd, orig_bwd = fa._kernel_forward, fa._BwdLaunch.__init__
    orig_drop = tlm.dropout

    def spy_fwd(q, k, v, qseg, kseg, causal, scale, dropout_rate, dropout_seed):
        seen["fwd"].append((dropout_rate, dropout_seed))
        return orig_fwd(q, k, v, qseg, kseg, causal, scale, dropout_rate,
                        dropout_seed)

    def spy_bwd(self, *a):
        seen["bwd"].append(tuple(a[-2:]))
        orig_bwd(self, *a)

    def spy_drop(t, r, g):
        y = orig_drop(t, r, g)
        zeros.append(float(((y == 0) & (t != 0)).float().sum()
                           / (t != 0).float().sum()))
        return y

    def step(remat):
        stack.activations_checkpoint = remat
        xr = x.detach().requires_grad_()
        g = torch.Generator(device=device).manual_seed(18)
        return _loss_and_grads(
            stack, lambda: stack(xr, deterministic=False,
                                 dropout_generator=g).float().square().mean())

    fa._kernel_forward, fa._BwdLaunch.__init__ = spy_fwd, spy_bwd
    tlm.dropout = spy_drop
    try:
        loss_p, grads_p, launch_p = step(False)
        seeds = [sd for r, sd in seen["fwd"]]
        fwd_calls, bwd_calls = list(seen["fwd"]), list(seen["bwd"])
        hidden_zero = list(zeros)
        loss_r, grads_r, launch_r = step(True)
    finally:
        fa._kernel_forward, fa._BwdLaunch.__init__ = orig_fwd, orig_bwd
        tlm.dropout = orig_drop
    want = {fa.FLASH_ATTENTION_FWD.name: L, fa.FLASH_ATTENTION_DQ.name: L,
            fa.FLASH_ATTENTION_DKV.name: L}
    flash_counts = {k: launch_p.get(k, 0) for k in want}
    if (flash_counts != want or len(bwd_calls) != L
            or any(r != rate for r, _ in fwd_calls + bwd_calls)
            or sorted(sd for _, sd in bwd_calls) != sorted(seeds)):
        raise AssertionError(f"dropout stack: flash launches {flash_counts}, "
                             f"forward calls {fwd_calls}, backward {bwd_calls}")
    # the dropped share of the probabilities: the keep bits of each seed
    # over the causal pairs of each (batch, head)
    pairs = s * (s + 1) // 2
    causal = (torch.arange(s, device=device)[None, :]
              <= torch.arange(s, device=device)[:, None])
    dropped = []
    for sd in seeds:
        keep = fa._keep(device, b, heads, s, s, sd, rate)
        dropped.append(float((~keep & causal).sum()) / (b * heads * pairs))
        del keep
    n_attn = b * heads * pairs
    n_hidden = s * b * h
    bound_attn = 6 * (rate * (1 - rate) / n_attn) ** 0.5
    bound_hidden = 6 * (rate * (1 - rate) / n_hidden) ** 0.5
    same = _grads_equal(grads_r, grads_p)
    extra = _extra(launch_r, launch_p)
    if (any(abs(d - rate) > bound_attn for d in dropped)
            or any(abs(z - rate) > bound_hidden for z in hidden_zero)
            or len(hidden_zero) != 2 * L
            or loss_r != loss_p or not same["bit_equal"]):
        raise AssertionError(
            f"dropout stack: attention dropped {dropped} (0.1 +- "
            f"{bound_attn}), hidden zeroed {hidden_zero} (0.1 +- "
            f"{bound_hidden}), recompute loss {loss_r} vs {loss_p}, "
            f"gradients {same}")
    out = dict(layers=L, hidden=h, heads=heads, seq=s, batch=b, rate=rate,
               nvidia_smi=smi, deterministic_bit_equal=det_equal,
               flash_calls_forward=fwd_calls, flash_calls_backward=bwd_calls,
               launches=launch_p, attention_dropped_share=dropped,
               attention_bound=bound_attn, hidden_zeroed_share=hidden_zero,
               hidden_bound=bound_hidden, recompute_extra_launches=extra,
               recompute=same,
               tolerance="dropped shares within 6 binomial standard "
                         "deviations of 0.1; deterministic=True and the "
                         "recomputed gradients bit for bit")
    log("phase3-dropout", **out)
    del stack, plain, grads_p, grads_r
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# expert, context and spatial parallelism (world 1 under NCCL)
# ---------------------------------------------------------------------------

# GPT-2-medium's widths (bench.py:86-89), every MLP 8 experts of ffn 4096 at
# capacity factor 1.25 (1280 slots of 8192 tokens an expert)
MOE_CARD = dict(layers=24, hidden=1024, heads=16, vocab=50304, seq=1024,
                batch=8, experts=8, capacity_factor=1.25)
# the smoke trainer's weight on the summed load-balancing losses (Switch's
# alpha); the package leaves the objective to its caller
MOE_AUX_COEF = 0.01
# the same widths, dense MLPs, RoPE, one sequence of 8192 tokens
CP_CARD = dict(layers=24, hidden=1024, heads=16, vocab=50304, seq=8192,
               batch=1)
# the ring's loss and gradients against the flash path's: both bf16, the
# ring's products in fp32; each gradient's relative norm of the difference
CP_LOSS_TOL = 1e-4
CP_GRAD_TOL = 5e-2
RING_SMALL_TOL = 1e-4
# ResNet-50's stride-1 bottlenecks (in, bottleneck, out, H = W), b 32, bf16
HALO_BLOCKS = ((256, 64, 256, 56), (512, 128, 512, 28), (1024, 256, 1024, 14))
HALO_BATCH = 32
HALO_TOL = 1e-2
HALO_REPEATS = 10


def _lm_card(c: dict, device, **kw):
    """``TransformerLanguageModel`` at card ``c``'s widths, fp32 init from a
    seeded generator on the card, the O2 cast, and ``FusedLAMB(lr 1e-3)``
    with fp32 moments and fp32 masters."""
    import torch
    from apex_tpu_torch.examples.llama_pretrain import o2_cast
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    model = TransformerLanguageModel(
        c["layers"], c["hidden"], c["heads"], c["vocab"], c["seq"],
        device=device, generator=torch.Generator(device=device).manual_seed(0),
        **kw)
    o2_cast(model)
    return model, FusedLAMB(model.parameters(), lr=1e-3, master_weights=True)


def _lm_loss(model, ids, aux_coef: float = 0.0):
    """The mean next-token loss through the tied embedding by
    ``fused_lm_head_loss`` (``GPTModel``'s head at tp 1), plus ``aux_coef``
    times the sum of the MoE layers' load-balancing losses."""
    import torch
    from apex_tpu_torch.ops.fused_lm_head import fused_lm_head_loss

    hidden = model(ids)
    emb = model.embedding.word_embeddings.weight
    loss = fused_lm_head_loss(hidden, emb.to(hidden.dtype),
                              torch.roll(ids, -1, dims=1).T).mean()
    if aux_coef:
        loss = loss + aux_coef * sum(model.moe_losses())
    return loss


def _lm_step(model, opt, ids, aux_coef: float = 0.0):
    def step():
        opt.zero_grad(set_to_none=True)
        loss = _lm_loss(model, ids, aux_coef)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def _lm_per_step(layers: int, flash: bool) -> dict:
    """A step's launches: two norms a layer and the final one, forward and
    backward; flash forward, dq and dk/dv a layer (not under cp); the head
    once each way; LAMB's clip norm and its one launch."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt

    per = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
           ln.LAYER_NORM_BWD.name: 2 * layers + 1,
           lh.FUSED_LM_HEAD_FWD.name: 1, lh.FUSED_LM_HEAD_DH.name: 1,
           lh.FUSED_LM_HEAD_DE.name: 1, mt.MT_L2NORM.name: 1,
           mt.MT_LAMB.name: 1}
    if flash:
        per.update({fa.FLASH_ATTENTION_FWD.name: layers,
                    fa.FLASH_ATTENTION_DQ.name: layers,
                    fa.FLASH_ATTENTION_DKV.name: layers})
    return per


def small_moe_check(device) -> dict:
    """A small fp32 MoE language model (2 layers, hidden 128, 2 heads of
    64, vocab 512, 4 experts at capacity factor 1.25, b 2 x s 128) on the
    card and on the CPU: the head loss plus ``MOE_AUX_COEF`` times the
    load-balancing losses, every gradient and 3 ``FusedLAMB`` steps."""
    import torch
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        TransformerLanguageModel,
    )

    ids = torch.randint(0, 512, (2, 128),
                        generator=torch.Generator().manual_seed(51))

    def build(dev):
        return TransformerLanguageModel(
            2, 128, 2, 512, 128, moe_num_experts=4, device=dev,
            generator=torch.Generator().manual_seed(52)
            if dev == "cpu" else None)

    def loss_of(model, dev):
        return _lm_loss(model, ids.to(dev), MOE_AUX_COEF)

    out = _card_vs_cpu("small MoE LM", build, loss_of,
                       lambda ps: FusedLAMB(ps, lr=1e-3), 1e-3, device)
    out["tolerance"] = SMALL_CARD_TOL
    log("phase3-moe-reference", **out)
    return out


def _routing(model) -> dict:
    """Layer 0's and the last layer's routing in the last forward: tokens
    each expert drew and the share dropped past capacity."""
    layers = model.transformer.layers
    out = {}
    for name, layer in (("layer_0", layers[0]),
                        (f"layer_{len(layers) - 1}", layers[-1])):
        ex = layer.mlp.experts
        counts = [int(n) for n in ex.last_tokens_per_expert]
        out[name] = dict(tokens_per_expert=counts,
                         dropped_share=int(ex.last_dropped) / sum(counts))
    return out


def moe_train(device, smi: str) -> dict:
    """``MOE_CARD``: every MLP of GPT-2-medium 8 experts (1.76 B parameters,
    0.36 B active a token), O2, ``FusedLAMB`` with fp32 state and masters,
    loss = the fused head's + ``MOE_AUX_COEF`` x the load-balancing losses,
    ``expert_parallel_axis`` an NCCL group of 1.  Gates: at the initial
    weights the loss and every gradient equal bit for bit to
    ``expert_parallel_axis=None``'s; one load-balancing loss a layer; then
    ``SLICE_STEPS`` timed steps with exact launches and a falling loss, and
    as many with no group (``no_group``: the exchanges' host cost)."""
    import torch

    c = MOE_CARD
    L, b, s = c["layers"], c["batch"], c["seq"]
    with _nccl_world("moe_rdv_") as group:
        model, opt = _lm_card(c, device, moe_num_experts=c["experts"],
                              expert_parallel_axis=group,
                              moe_capacity_factor=c["capacity_factor"])
        experts = [layer.mlp.experts for layer in model.transformer.layers]
        ids = torch.randint(0, c["vocab"], (b, s),
                            generator=torch.Generator().manual_seed(53)
                            ).to(device)
        fwd = lambda: _lm_loss(model, ids, MOE_AUX_COEF)  # noqa: E731
        loss_g, grads_g, launch_g = _loss_and_grads(model, fwd)
        auxes = [float(a.detach()) for a in model.moe_losses()]
        for ex in experts:
            ex.axis_name = None
        loss_n, grads_n, _ = _loss_and_grads(model, fwd)
        for ex in experts:
            ex.axis_name = group
        same = _grads_equal(grads_g, grads_n)
        del grads_g, grads_n
        if (loss_g != loss_n or not same["bit_equal"] or len(auxes) != L
                or not all(map(math.isfinite, auxes))):
            raise AssertionError(f"MoE: ep group of 1 loss {loss_g} vs "
                                 f"{loss_n}, gradients {same}, aux {auxes}")
        step = _lm_step(model, opt, ids, MOE_AUX_COEF)
        out = _train_steps(step, SLICE_STEPS, _lm_per_step(L, True),
                           "MoE GPT-2-medium")
        routing = _routing(model)
        # the same steps with no group: the host's cost of the exchanges
        for ex in experts:
            ex.axis_name = None
        alone = _train_steps(step, SLICE_STEPS, _lm_per_step(L, True),
                             "MoE GPT-2-medium, no ep group")
        for ex in experts:
            ex.axis_name = group
        out["no_group"] = {k: alone[k] for k in (
            "step_ms", "step_ms_median", "step_issue_ms", "step_issue_cpu_ms",
            "thread_cpu_ms_timed_steps", "host_loop_ms")}
        out["profile"] = _profile(step, out["step_ms_median"])
    n = sum(p.numel() for p in model.parameters())
    n_experts = sum(ex.w_in.numel() + ex.w_out.numel() for ex in experts)
    active = n - n_experts + n_experts // c["experts"]
    tokens = b * s
    # 6 N_active a token plus the causal attention's 12 L h s / 2
    flops = float((6 * active + 12 * L * c["hidden"] * s // 2) * tokens)
    out = dict(config="gpt2-medium-moe8", nvidia_smi=smi, params=n,
               active_params=active, **c, tokens=tokens,
               capacity=experts[0].capacity(tokens), aux_coef=MOE_AUX_COEF,
               initial_aux_losses=auxes, routing=routing,
               ep1_check=dict(loss=loss_g, launches=launch_g, **same),
               precision="O2: 2-d+ parameters bf16 (router included; its "
                         "product cast up to fp32), biases and LayerNorm "
                         "fp32",
               optimizer="FusedLAMB(lr=1e-3), fp32 moments and masters",
               tolerance="ep group of 1 = no group bit for bit", **out)
    _mfu(out, flops, tokens)
    log("phase3-train-moe", **out)
    del model, opt, experts
    torch.cuda.empty_cache()
    return out


def small_ring_check(device) -> dict:
    """``ring_attention`` over an NCCL group of 1 on the card, fp32, causal
    and not, ``[2, 4, 256, 64]``: the output and the q / k / v gradients
    against dense attention in fp64 on the CPU, within
    ``RING_SMALL_TOL`` of the largest reference value."""
    import torch
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    g = torch.Generator().manual_seed(54)
    q, k, v, ct = (torch.randn(2, 4, 256, 64, generator=g) for _ in range(4))
    out = {}
    with _nccl_world("ring_rdv_") as group:
        for causal in (True, False):
            ref_in = [t.double().requires_grad_() for t in (q, k, v)]
            sc = ref_in[0] @ ref_in[1].transpose(-1, -2) / 8.0
            if causal:
                sc = sc.masked_fill(torch.ones(256, 256, dtype=torch.bool)
                                    .triu(1), float("-inf"))
            ref = torch.softmax(sc, -1) @ ref_in[2]
            (ref * ct.double()).sum().backward()
            card = [t.to(device, copy=True).requires_grad_()
                    for t in (q, k, v)]
            got = ring_attention(*card, axis_name=group, causal=causal)
            (got * ct.to(device)).sum().backward()
            errs = {name: float((a.detach().cpu().double() - b.detach()).abs()
                                .max() / b.detach().abs().max())
                    for name, a, b in (("out", got, ref),
                                       *((f"d{n}", t.grad, r.grad) for n, t, r
                                         in zip("qkv", card, ref_in)))}
            if max(errs.values()) > RING_SMALL_TOL:
                raise AssertionError(f"ring attention (causal={causal}) card "
                                     f"against dense fp64: {errs}")
            out["causal" if causal else "full"] = errs
    out["tolerance"] = (f"max |card - fp64 dense| <= {RING_SMALL_TOL} max "
                        f"|reference|, output and each gradient")
    log("phase3-ring-reference", **out)
    return out


def _ring_ms(device, c: dict, group, repeats: int = 3) -> float:
    """One layer's ring attention forward and backward at the card's
    shapes (bf16), by CUDA events, the median of ``repeats``."""
    import torch
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    shape = (c["batch"], c["heads"], c["seq"], c["hidden"] // c["heads"])
    g = torch.Generator(device=device).manual_seed(55)
    q, k, v, do = (torch.randn(shape, generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    times = []
    for _ in range(repeats + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ring_attention(q, k, v, axis_name=group).backward(do)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def cp_train(device, smi: str) -> dict:
    """``CP_CARD``: GPT-2-medium's widths with RoPE and dense MLPs on one
    sequence of 8192 tokens, O2, ``FusedLAMB`` with fp32 state and masters,
    ``context_parallel_axis`` an NCCL group of 1 (the ring attention: its
    own block, the causal triangle, no rotation).  Gates: at the initial
    weights the loss within ``CP_LOSS_TOL`` (relative) and each gradient
    within ``CP_GRAD_TOL`` (relative norm of the difference) of the flash
    path's (``context_parallel_axis=None``); ``SLICE_STEPS`` timed steps
    with exact launches (no flash under cp) and a falling loss."""
    import torch

    c = CP_CARD
    L, b, s = c["layers"], c["batch"], c["seq"]
    with _nccl_world("cp_rdv_") as group:
        model, opt = _lm_card(c, device, apply_rope=True,
                              context_parallel_axis=group)
        attns = [layer.self_attention for layer in model.transformer.layers]
        ids = torch.randint(0, c["vocab"], (b, s),
                            generator=torch.Generator().manual_seed(56)
                            ).to(device)
        fwd = lambda: _lm_loss(model, ids)  # noqa: E731
        loss_r, grads_r, launch_r = _loss_and_grads(model, fwd)
        for a in attns:
            a.context_parallel_axis = None
        loss_f, grads_f, launch_f = _loss_and_grads(model, fwd)
        for a in attns:
            a.context_parallel_axis = group
        rel = {n: float((grads_r[n].float() - grads_f[n].float()).norm()
                        / grads_f[n].float().norm().clamp_min(1e-30))
               for n in grads_f}
        del grads_r, grads_f
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_r - loss_f) / abs(loss_f)
        if loss_rel > CP_LOSS_TOL or rel[worst] > CP_GRAD_TOL:
            raise AssertionError(f"cp: loss {loss_r} vs flash {loss_f}, "
                                 f"worst gradient {worst} at {rel[worst]}")
        step = _lm_step(model, opt, ids)
        torch.cuda.empty_cache()
        out = _train_steps(step, SLICE_STEPS, _lm_per_step(L, False),
                           "cp GPT-2-medium s 8192")
        out["profile"] = _profile(step, out["step_ms_median"])
        del opt
        torch.cuda.empty_cache()
        ring_ms = _ring_ms(device, c, group)
    busy = out["profile"]["device_busy_ms"]
    n = sum(p.numel() for p in model.parameters())
    tokens = b * s
    flops = float((6 * n + 12 * L * c["hidden"] * s // 2) * tokens)
    out = dict(config="gpt2-medium-rope-s8192-cp1", nvidia_smi=smi, params=n,
               **c, tokens=tokens,
               flash_check=dict(loss_ring=loss_r, loss_flash=loss_f,
                                loss_rel=loss_rel, worst_grad=worst,
                                worst_grad_rel=rel[worst],
                                launches_ring=launch_r,
                                launches_flash=launch_f),
               ring_fwd_bwd_ms_a_layer=ring_ms,
               ring_ms_a_step=ring_ms * L,
               ring_share_of_busy=(ring_ms * L / busy
                                   if isinstance(busy, float) else busy),
               precision="O2: 2-d parameters bf16, biases and LayerNorm "
                         "fp32; the ring's block products fp32",
               optimizer="FusedLAMB(lr=1e-3), fp32 moments and masters",
               tolerance=f"loss within {CP_LOSS_TOL} relative and each "
                         f"gradient within {CP_GRAD_TOL} (relative norm of "
                         f"the difference) of the flash path's", **out)
    _mfu(out, flops, tokens)
    log("phase3-train-cp", **out)
    del model
    torch.cuda.empty_cache()
    return out


def _fwd_bwd_ms(model, x, ct, repeats: int) -> float:
    import torch

    times = []
    for _ in range(repeats + 2):
        xr = x.detach().requires_grad_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        model(xr).backward(ct)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[2:])


def halo_check(device, smi: str) -> dict:
    """``SpatialBottleneck`` over an NCCL group of 1 beside ``Bottleneck``
    with the same weights (random frozen scales and biases), bf16, at
    ResNet-50's stride-1 blocks, b ``HALO_BATCH``: the outputs and the
    input and convolution gradients within ``HALO_TOL`` of the largest
    reference value, no gradient to the frozen pairs, no kernel of the
    port launched; fwd + bwd ms of each."""
    import torch
    from apex_tpu_torch.contrib.halo import Bottleneck, SpatialBottleneck
    from apex_tpu_torch.ops import _dispatch

    out = {"blocks": []}
    _dispatch.reset_launches()
    with _nccl_world("halo_rdv_") as group:
        for cin, cb, cout, hw in HALO_BLOCKS:
            g = torch.Generator(device=device).manual_seed(57 + hw)
            kw = dict(param_dtype=torch.bfloat16, device=device)
            plain = Bottleneck(cin, cb, cout, generator=g, **kw)
            with torch.no_grad():
                for name, p in plain.named_parameters():
                    if name.startswith("bn"):
                        p.copy_((1.0 if name.endswith("scale") else 0.0)
                                + 0.1 * torch.randn(p.shape, generator=g,
                                                    device=device))
            spatial = SpatialBottleneck(cin, cb, cout, spatial_axis=group,
                                        **kw)
            spatial.load_state_dict(plain.state_dict())
            x = torch.randn(HALO_BATCH, cin, hw, hw, generator=g,
                            device=device).to(torch.bfloat16)
            ct = torch.randn(HALO_BATCH, cout, hw, hw, generator=g,
                             device=device).to(torch.bfloat16)
            res = {}
            for name, m in (("plain", plain), ("spatial", spatial)):
                xr = x.detach().requires_grad_()
                y = m(xr)
                y.backward(ct)
                res[name] = dict(y=y.detach(), dx=xr.grad,
                                 **{n: p.grad for n, p in m.named_parameters()
                                    if n.startswith("conv")})
                frozen = [n for n, p in m.named_parameters()
                          if n.startswith("bn") and p.grad is not None]
                if frozen:
                    raise AssertionError(f"halo {name}: frozen {frozen} got "
                                         f"a gradient")
            errs = {k: float((res["spatial"][k].float() - v.float()).abs().max()
                             / v.float().abs().max())
                    for k, v in res["plain"].items()}
            if max(errs.values()) > HALO_TOL:
                raise AssertionError(f"halo block {(cin, cb, cout, hw)}: "
                                     f"spatial against plain {errs}")
            times = {}
            for turn in ("plain", "spatial", "spatial", "plain"):
                m = plain if turn == "plain" else spatial
                times.setdefault(turn, []).append(
                    _fwd_bwd_ms(m, x, ct, HALO_REPEATS))
            out["blocks"].append(dict(
                block=[cin, cb, cout], hw=hw, batch=HALO_BATCH,
                rel_errs=errs, fwd_bwd_ms=times))
            del plain, spatial, res, x, ct
            torch.cuda.empty_cache()
    out["launches"] = _launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"halo: port kernels launched "
                             f"{_nonzero(out['launches'])}")
    out.update(nvidia_smi=smi,
               tolerance=f"max |spatial - plain| <= {HALO_TOL} max |plain| "
                         f"for the output and each gradient; frozen scales "
                         f"and biases without a gradient")
    log("phase3-halo", **out)
    return out


# ---------------------------------------------------------------------------
# the Megatron GPT driver (dp x pp x tp = 1 under NCCL) and amp O1
# ---------------------------------------------------------------------------

# GPT-2-large's widths (bench.py:81-84) through the Megatron driver: b 4 a
# microbatch, global batch 8 (2 microbatches, no_pipelining at pp 1), bf16
# parameters, the default FusedAdam at lr 1e-4 (the driver's fresh random
# batches fall ~0.005 a step toward ln V there; at 1e-3 the loss rose)
MEGATRON_GPT_FLAGS = [
    "--num-layers", "36", "--hidden-size", "1280",
    "--num-attention-heads", "20", "--seq-length", "1024",
    "--max-position-embeddings", "1024", "--vocab-size", "50304",
    "--micro-batch-size", "4", "--global-batch-size", "8", "--bf16",
    "--lr", "1e-4"]
MEGATRON_STEPS = SLICE_STEPS   # timed iterations after one warm-up
# the card-against-CPU run: 2 layers of hidden 128 (2 heads of 64, so the
# flash kernels run), fp32, 2 microbatches of 2 x 128, 3 iterations
MEGATRON_SMALL_FLAGS = [
    "--num-layers", "2", "--hidden-size", "128", "--num-attention-heads",
    "2", "--seq-length", "128", "--max-position-embeddings", "128",
    "--vocab-size", "512", "--micro-batch-size", "2", "--global-batch-size",
    "4", "--lr", "1e-3", "--train-iters", str(CARD_VS_CPU_STEPS)]


def _megatron_per_step(layers: int, n_micro: int) -> dict:
    """A driver iteration's launches at pp 1: each microbatch's two norms a
    layer and the final one, forward and backward, and its flash forward,
    dq and dk/dv a layer (the head is ``parallel_lm_logits`` and the
    vocab-parallel loss, no kernel); one ``mt_adam`` over every
    parameter."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt

    return {ln.LAYER_NORM_FWD.name: (2 * layers + 1) * n_micro,
            ln.LAYER_NORM_BWD.name: (2 * layers + 1) * n_micro,
            fa.FLASH_ATTENTION_FWD.name: layers * n_micro,
            fa.FLASH_ATTENTION_DQ.name: layers * n_micro,
            fa.FLASH_ATTENTION_DKV.name: layers * n_micro,
            mt.MT_ADAM.name: 1}


def small_megatron_check(device) -> dict:
    """``megatron_gpt_pretrain.main`` at ``MEGATRON_SMALL_FLAGS`` on the CPU
    (a gloo world of 1) and on the card (NCCL), from one seeded CPU init:
    the first iteration's gradients, each iteration's loss and the
    parameters after, within ``SMALL_CARD_TOL``."""
    import torch
    from apex_tpu_torch.examples import megatron_gpt_pretrain as mgp
    from apex_tpu_torch.transformer.testing.commons import (
        GPTPipeConfig,
        init_gpt_pipeline_params,
    )

    cfg = GPTPipeConfig(vocab_size=512, hidden_size=128, num_attention_heads=2,
                        layers_per_stage=2, max_sequence_length=128)
    state = init_gpt_pipeline_params(cfg, seed=5, pp_rank=0, pp_size=1,
                                     device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        rec = dict(losses=[])

        def on_iteration(it, loss, spec, rec=rec):
            rec["losses"].append(loss)
            named = spec.named_parameters()
            if it == 0:
                rec["grads"] = {n: p.grad.detach().float().cpu().clone()
                                for n, p in named}
            rec["params"] = {n: p.detach().float().cpu().clone()
                             for n, p in spec.named_parameters()}

        mgp.main(["--device", dev] + MEGATRON_SMALL_FLAGS, init_state=state,
                 on_iteration=on_iteration)
        runs[dev] = rec
    c, d = runs["cpu"], runs["cuda"]
    err = dict(losses=max(abs(a - b) for a, b in zip(c["losses"],
                                                     d["losses"])),
               grad_tol_ratio=_grad_tol_ratio(d["grads"], c["grads"]),
               params_tol_ratio=_param_tol_ratio(
                   d["params"], c["params"], c["grads"], 1e-3,
                   CARD_VS_CPU_STEPS),
               params=len(c["params"]), cpu_losses=c["losses"],
               card_losses=d["losses"], tolerance=SMALL_CARD_TOL)
    if (err["losses"] > 1e-4 or err["grad_tol_ratio"] > 1.0
            or err["params_tol_ratio"] > 1.0):
        raise AssertionError(f"small Megatron GPT: card against CPU {err}")
    log("phase3-megatron-reference", **err)
    return err


def megatron_gpt_train(device, smi: str) -> dict:
    """The Megatron GPT driver (:mod:`apex_tpu_torch.examples.
    megatron_gpt_pretrain`) at GPT-2-large's full width in an NCCL world of
    1 (dp = pp = tp = 1, ``no_pipelining``), through its ``main``: one
    warm-up iteration, ``MEGATRON_STEPS`` timed ones with the launches of
    every iteration checked exactly (:func:`_megatron_per_step`), then one
    traced with ``torch.profiler``; the loss finite and falling (the last
    timed below the warm-up's); step p50, MFU, idle share, peak memory.
    First the same driver card against CPU at 2 layers
    (:func:`small_megatron_check`)."""
    import torch
    from apex_tpu_torch.examples import megatron_gpt_pretrain as mgp
    from apex_tpu_torch.ops import _dispatch
    from torch.profiler import ProfilerActivity, profile

    reference = small_megatron_check(device)
    torch.cuda.empty_cache()
    layers, n_micro = 36, 2
    per_step = _megatron_per_step(layers, n_micro)
    rec = dict(t=[], launches=[], losses=[])
    traced = {}

    def on_iteration(it, loss, spec):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["launches"].append(_launch_counts())
        rec["losses"].append(loss)
        if it == 0:
            torch.cuda.reset_peak_memory_stats()
            rec["params"] = sum(p.numel() for p in spec.parameters())
        if it == MEGATRON_STEPS:
            rec["peak"] = torch.cuda.max_memory_allocated()
            traced["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            traced["prof"].__enter__()
        if it == MEGATRON_STEPS + 1:
            traced["prof"].__exit__(None, None, None)

    _dispatch.reset_launches()
    t0 = time.perf_counter()
    final = mgp.main(MEGATRON_GPT_FLAGS + ["--train-iters",
                                           str(MEGATRON_STEPS + 2)],
                     on_iteration=on_iteration)
    launches = _launch_counts()
    counts = [{k: v - (rec["launches"][i - 1][k] if i else 0)
               for k, v in c.items()} for i, c in enumerate(rec["launches"])]
    bad = [i for i, c in enumerate(counts) if _nonzero(c) != per_step]
    losses = rec["losses"]
    if bad or not all(map(math.isfinite, losses)) or not (
            losses[MEGATRON_STEPS] < losses[0]) or final != losses[-1]:
        raise AssertionError(
            f"Megatron GPT-2-large: iterations {bad} launched "
            f"{[_nonzero(counts[i]) for i in bad]}, expected {per_step}; "
            f"losses {losses}")
    step_ms = [(rec["t"][i] - rec["t"][i - 1]) * 1e3
               for i in range(1, MEGATRON_STEPS + 1)]
    med = statistics.median(step_ms)
    s, tokens = 1024, 8 * 1024
    n = rec["params"]
    flops = float((6 * n + 12 * layers * 1280 * s // 2) * tokens)
    out = dict(config="gpt2-large (Megatron driver)", nvidia_smi=smi,
               flags=MEGATRON_GPT_FLAGS, params=n, tokens=tokens,
               n_micro=n_micro, schedule="forward_backward_no_pipelining",
               precision="--bf16: parameters bf16 (LayerNorm fp32), the "
                         "logits and loss fp32",
               optimizer="FusedAdam(lr=1e-4), fp32 moments, no masters",
               warmup_loss=losses[0], losses=losses[1:], step_ms=step_ms,
               step_ms_median=med, total_s=time.perf_counter() - t0,
               peak_mem_bytes=rec["peak"], launches=launches,
               launches_per_step=per_step,
               profile=_device_profile((rec["t"][-1] - rec["t"][-2]) * 1e3,
                                       _kernel_rows(traced["prof"]), med),
               reference=reference)
    _mfu(out, flops, tokens)
    log("phase3-megatron-gpt", **{k: v for k, v in out.items()
                                  if k != "launches"})
    torch.cuda.empty_cache()
    return out


# the amp.functional rules on the card: (op, positional args' dtypes,
# keyword arguments); values against the CPU's
AMP_O1_CASES = (
    ("matmul", ("float32", "float32"), {}),
    ("linear", ("float32", "float32"), {}),
    ("exp", ("bfloat16",), {}),
    ("softmax", ("float16",), {"dim": -1}),
    ("sum", ("bfloat16",), {}),
    ("linalg_norm", ("float16",), {}),
    ("add", ("float16", "bfloat16"), {}),
    ("mul", ("bfloat16", "float32"), {}),
    ("atan2", ("float16", "float16"), {}),
)


def amp_o1_check(device, smi: str) -> dict:
    """amp O1 on the card: the ``amp.functional`` rules (half, float and
    promote ops, and ``cat`` of a sequence) on CUDA tensors under the O1
    policy, each output's dtype the CPU's and its values within 1e-5
    relative where fp32 (two units in the last place in bf16 and fp16,
    2**-6 and 2**-9 relative: a half result rounded from another fp32
    sum); then ``examples/simple.py --opt-level O1 --half
    fp16`` converging under the dynamic loss scaler."""
    import torch
    from apex_tpu_torch.amp import functional as F
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import simple

    gen = torch.Generator().manual_seed(31)
    rel = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6,
           torch.float16: 2.0 ** -9}
    cases = {}
    with F.active_policy(get_policy("O1", half_dtype=torch.bfloat16)):
        for name, dtypes, kw in AMP_O1_CASES:
            args = [torch.rand(64, 64, generator=gen).add_(0.5).to(
                getattr(torch, d)) for d in dtypes]
            cpu = getattr(F, name)(*args, **kw)
            card = getattr(F, name)(*[a.to(device) for a in args], **kw)
            err = float(((card.cpu().float() - cpu.float()).abs()
                         / cpu.float().abs().clamp_min(1e-6)).max())
            cases[name] = dict(dtype=str(card.dtype).rsplit(".", 1)[-1],
                               max_rel_err=err, tol=rel[cpu.dtype])
            if card.dtype != cpu.dtype or err > rel[cpu.dtype]:
                raise AssertionError(f"amp.functional.{name} on the card: "
                                     f"{card.dtype} vs {cpu.dtype}, "
                                     f"relative error {err}")
        seq = [torch.ones(4, dtype=torch.bfloat16, device=device),
               torch.ones(4, device=device)]
        if F.cat(seq).dtype != torch.float32:
            raise AssertionError("amp.functional.cat did not promote")
    t0 = time.perf_counter()
    try:
        last = simple.main(["--opt-level", "O1", "--half", "fp16"])
    finally:
        F.set_active_policy(None)
    out = dict(nvidia_smi=smi, cases=cases, simple_o1_fp16_last_loss=last,
               simple_s=time.perf_counter() - t0,
               tolerance="dtypes the CPU's; values within 1e-5 relative in "
                         "fp32, 2**-6 in bf16, 2**-9 in fp16; simple.py "
                         "below 0.05 after 200 steps")
    log("phase3-amp-o1", **out)
    return out


# the phases that stand alone, for ``chip_smoke.py --only NAME[,NAME]``:
# each called with the card and the nvidia-smi line, in the order given,
# in one process
# ---------------------------------------------------------------------------
# phase 3: supervised fp16 training (resilience/ on the llama-1b card)
# ---------------------------------------------------------------------------

SUP_STEPS = 12          # steps of the faulted run, and of its reference
SUP_SCALE = 2.0 ** 14   # the dynamic scaler's start (no warm-up overflow)
SUP_FAULT_SEED = 11     # FaultPlan seed: the planted inf's leaf and element
SUP_INF_STEP = 2        # inject_grads plants one inf in this step's grads
SUP_CORRUPT_AT = 4      # CorruptBatch: a NaN copy ahead of clean batch 4
SUP_FLAKY_AT = 6        # FlakyIterator: fetch 6 fails twice, then succeeds
SUP_SLOW = (8, 9)       # SlowStep past the deadline: escalation at step 9
SUP_DEADLINE_X = 10.0   # the deadline: this multiple of the warm step p50
                        # (a fresh model's first steps take up to 7.3 x)
SUP_SLOW_X = 1.5        # a slow step sleeps this multiple of the deadline
SUP_SMALL_TOL = 1e-5    # fused_dense / mlp card against CPU, fp32, relative
SUP_SMALL_TOL_BF16 = 2e-2


def _sup_batch(i: int, vocab: int) -> dict:
    """Clean batch ``i`` of the stream, fixed by its index, on the host
    (where the data guard reads it): ids and labels of b 4 x s 2048 and a
    float32 token-weight mask of ones (the leaf ``CorruptBatch`` damages)."""
    import torch

    ids = torch.randint(0, vocab, (4, 2048),
                        generator=torch.Generator().manual_seed(1000 + i))
    return {"ids": ids, "labels": torch.roll(ids, -1, dims=1),
            "mask": torch.ones(4, 2048, dtype=torch.float32)}


class _SupervisedLlama:
    """The llama-1b card in fp16 O2 (``amp.initialize``, norm scales fp32)
    with ``FusedAdam(master_weights=True)`` under the dynamic scaler from
    ``SUP_SCALE``, stepped by ``resilience.make_guarded_step`` with the
    fault plan's ``inject_grads`` as its ``grad_hook``: the found_inf,
    census, optimizer and update part runs under
    ``set_sync_debug_mode("error")``, and the step ends on the host's one
    read of its metrics (``fetch_metrics``)."""

    def __init__(self, device, cfg, per_step: dict):
        import torch
        from apex_tpu_torch import amp
        from apex_tpu_torch import resilience as rz
        from apex_tpu_torch.amp import LossScaler
        from apex_tpu_torch.examples.llama_pretrain import build_model
        from apex_tpu_torch.ops import _dispatch
        from apex_tpu_torch.optimizers import FusedAdam

        self.device, self.cfg, self.per_step = device, cfg, per_step
        self.amped = amp.initialize(build_model(cfg, device=device, seed=0),
                                    "O2", half_dtype=torch.float16)
        self.model = self.amped.model
        self.params = dict(self.model.named_parameters())
        self.opt = FusedAdam(list(self.params.values()), lr=AMP_LR,
                             master_weights=True)
        self.scaler = LossScaler(init_scale=SUP_SCALE)
        self.injector = rz.FaultInjector(rz.FaultPlan(
            seed=SUP_FAULT_SEED, inf_grad_steps=(SUP_INF_STEP,)))
        self.state = {"scaler": self.scaler.init(device),
                      "guard": rz.init_guard_state(self.scaler, device),
                      "step": 0}
        self.metrics, self.step_ms, self.launch_errors = [], [], []
        self._index = 0

        def hook(grads):
            out = self.injector.inject_grads(grads, self._index)
            torch.cuda.set_sync_debug_mode("error")
            return out

        def loss_fn(model, batch):
            per_tok = model(batch["ids"], labels=batch["labels"])
            mask = batch["mask"]
            return (per_tok.float() * mask).sum() / mask.sum()

        self._dispatch = _dispatch
        self.gstep = rz.make_guarded_step(loss_fn, self.opt, self.scaler,
                                          grad_hook=hook)

    def step(self, batch: dict, index: int) -> dict:
        """One guarded step on host batch ``batch`` as step ``index``;
        returns its metrics as the host reads them."""
        import torch
        from apex_tpu_torch import resilience as rz

        before = {k.name: k.launches for k in self._dispatch.KERNELS}
        t0 = time.perf_counter()
        dev = {k: v.to(self.device, non_blocking=True)
               for k, v in batch.items()}
        self._index = index
        try:
            sstate, gstate, metrics = self.gstep(
                self.model, None, self.state["scaler"], self.state["guard"],
                dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = rz.fetch_metrics(metrics)           # the host read: step ends
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.state.update(scaler=sstate, guard=gstate, step=index + 1)
        launched = {k.name: k.launches - before[k.name]
                    for k in self._dispatch.KERNELS}
        if _nonzero(launched) != self.per_step:
            self.launch_errors.append((index, _nonzero(launched)))
        got["index"] = index
        self.metrics.append(got)
        return got

    def opt_step_tensor(self):
        return self.opt.state[next(iter(self.params.values()))]["step"]

    def tree(self) -> dict:
        """Every leaf a step writes: parameters, masters, both moments, the
        optimizer's step counter, the scaler and guard states, the step."""
        opt = {n: {k: self.opt.state[p][k] for k in
                   ("master_param", "exp_avg", "exp_avg_sq")}
               for n, p in self.params.items()}
        return {"params": self.params, "opt": opt,
                "opt_step": self.opt_step_tensor(),
                "scaler": self.state["scaler"], "guard": self.state["guard"],
                "step": self.state["step"]}

    def init_opt_state(self):
        """The optimizer's state as its first step makes it (masters, zero
        moments, one shared step counter), to restore a checkpoint into."""
        import torch

        step = torch.zeros((), dtype=torch.int32, device=self.device)
        for p in self.params.values():
            st = self.opt.state[p]
            st["step"] = step
            st["master_param"] = self.opt._master(p)
            st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)

    def load(self, tree: dict) -> None:
        """Copy a restored (host) tree into the live tensors."""
        import torch

        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(tree["params"][n])
                for k, t in tree["opt"][n].items():
                    self.opt.state[p][k].copy_(t)
            self.opt_step_tensor().copy_(tree["opt_step"])
        self.state.update(
            scaler=type(self.state["scaler"])(
                *[t.to(self.device) for t in tree["scaler"]]),
            guard=type(self.state["guard"])(
                *[t.to(self.device) for t in tree["guard"]]),
            step=int(tree["step"]))


def _cpu_like(tree):
    """A CPU template of ``tree`` (uninitialized tensors of each leaf's
    shape and dtype): what a checkpoint restores into on the host."""
    import torch
    from apex_tpu_torch.utils.serialization import tree_map_with_path

    return tree_map_with_path(
        lambda _, l: torch.empty(l.shape, dtype=l.dtype)
        if isinstance(l, torch.Tensor) else l, tree)


def _crcs_and_hashes(tree, hashes: bool = True) -> tuple:
    """``({path: crc32}, {path: u32 hash on the CPU copy}, bytes, the
    hashes' seconds)`` of every leaf, one device-to-host copy a leaf
    (without ``hashes``, no hash)."""
    import numpy as np
    import torch
    from apex_tpu_torch.resilience.consistency import _shard_hash
    from apex_tpu_torch.utils.serialization import (
        leaf_crc32,
        leaf_to_numpy,
        tree_flatten_with_path,
    )

    crcs, cpu, nbytes, hash_s = {}, {}, 0, 0.0
    for path, leaf in tree_flatten_with_path(tree):
        host = leaf_to_numpy(leaf)
        crcs[path] = leaf_crc32(host)
        nbytes += host.nbytes
        if hashes and isinstance(leaf, torch.Tensor):
            t0 = time.perf_counter()
            cpu[path] = int(_shard_hash(torch.from_numpy(
                np.ascontiguousarray(host).reshape(host.shape))))
            hash_s += time.perf_counter() - t0
    return crcs, cpu, nbytes, hash_s


def _queue_c_witness(device) -> dict:
    """``forward_backward_no_pipelining`` at fp16 on the card: two
    microbatches of ones, ``(w * mb).sum()`` under
    ``LossScaler(init_scale=40000)``: found_inf False and fp32 sums of
    80000 (each microbatch's 40000 in the half range, their sum not)."""
    import torch
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining,
    )

    w = torch.nn.Parameter(torch.ones(4, dtype=torch.float16, device=device))
    scaler = LossScaler(init_scale=40000.0)
    _, grads, found = forward_backward_no_pipelining(
        lambda m: (w * m).sum(),
        torch.ones(2, 4, dtype=torch.float16, device=device), model=[w],
        grad_scaler=scaler, scaler_state=scaler.init(device),
        with_found_inf=True)
    out = dict(found_inf=bool(found), sums=grads["0"].tolist(),
               sum_dtype=str(grads["0"].dtype), grad=w.grad.tolist(),
               grad_dtype=str(w.grad.dtype))
    if out["found_inf"] or out["sums"] != [80000.0] * 4 or \
            out["sum_dtype"] != "torch.float32":
        raise AssertionError(f"no_pipelining fp16 witness: {out}")
    return out


def _dense_checks(device) -> dict:
    """``fused_dense`` and ``mlp`` forward and backward on the card against
    the same modules on the CPU (the same weights) at a small size, fp32
    (TF32 off) within ``SUP_SMALL_TOL`` and bf16 within
    ``SUP_SMALL_TOL_BF16`` of the largest magnitude; then
    ``FusedDenseGeluDense`` timed at GPT-2-large's MLP (h 1280 -> 5120 ->
    1280, 8192 tokens, bf16), forward and forward + backward."""
    import torch
    from apex_tpu_torch.fused_dense import (
        DenseNoBias,
        FusedDense,
        FusedDenseGeluDense,
    )
    from apex_tpu_torch.mlp import MLP

    def pair(make, dtype):
        cpu = make("cpu")
        card = make(device)
        card.load_state_dict(cpu.state_dict())
        x = torch.randn(64, 96, generator=torch.Generator().manual_seed(3))
        out = []
        for mod, dev in ((cpu, "cpu"), (card, device)):
            xi = x.to(dev, dtype).detach().clone().requires_grad_(True)
            y = mod(xi)
            (y.float() ** 2).sum().backward()
            out.append([y.detach().float().cpu(), xi.grad.float().cpu()] + [
                p.grad.float().cpu() for p in mod.parameters()])
        return max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(out[1], out[0]))

    makes = {
        "FusedDense": lambda d: FusedDense(96, 128, device=d),
        "DenseNoBias": lambda d: DenseNoBias(96, 128, device=d),
        "FusedDenseGeluDense": lambda d: FusedDenseGeluDense(
            96, 256, 96, device=d),
        "MLP": lambda d: MLP([96, 256, 128, 32], device=d)}
    errs = {f"{name}_{dt}": pair(make, getattr(torch, dt))
            for name, make in makes.items()
            for dt in ("float32", "bfloat16")}
    bad = {k: v for k, v in errs.items()
           if v > (SUP_SMALL_TOL if k.endswith("float32")
                   else SUP_SMALL_TOL_BF16)}
    if bad:
        raise AssertionError(f"fused_dense / mlp card against CPU: {bad}")
    mod = FusedDenseGeluDense(1280, 5120, 1280, device=device,
                              dtype=torch.bfloat16)
    x = torch.randn(8192, 1280, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    dy = torch.randn(8192, 1280, device=device, dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            mod(x)

    def fwd_bwd():
        x.grad = None
        for p in mod.parameters():
            p.grad = None
        mod(x).backward(dy)

    flops = 2 * 2 * 8192 * 1280 * 5120
    fms, bms = time_ms(fwd, iters=20, warmup=3), time_ms(fwd_bwd, iters=10,
                                                         warmup=2)
    return dict(max_rel_err=errs, tol_fp32=SUP_SMALL_TOL,
                tol_bf16=SUP_SMALL_TOL_BF16,
                gpt2_large_mlp=dict(tokens=8192, hidden=1280, ffn=5120,
                                    dtype="bfloat16", fwd_ms=fms,
                                    fwd_tflops=flops / fms / 1e9,
                                    fwd_bwd_ms=bms,
                                    fwd_bwd_tflops=3 * flops / bms / 1e9))


def supervised_train(device, smi: str) -> dict:
    """Supervised fp16 training of ``llama-1b`` at full width and depth
    (``_SupervisedLlama``, b 4 x s 2048), through ``resilience``:

    1. an unsupervised reference: ``SUP_STEPS`` guarded steps over the
       clean stream with the planted inf at ``SUP_INF_STEP``; its step
       p50 sets the deadline; only the CRC32 of each leaf of its final
       state is kept (two 1.1 B states never sit on the card at once);
    2. the faulted run under ``TrainingSupervisor`` (a
       ``CheckpointManager`` under ``build/``, the ``StepWatchdog`` at
       ``SUP_DEADLINE_X`` x the p50, a heartbeat file) over a
       ``GuardedIterator`` of ``FlakyIterator(CorruptBatch(stream))``
       with ``SlowStep`` on ``SUP_SLOW``: the planted inf skipped with
       the census naming its one leaf and element, the corrupt copy
       skipped within the budget, the flaky fetch retried (no failure),
       the two slow steps escalating to one validated emergency
       checkpoint and ``TrainingAborted``; each fault's event once;
    3. the restart: a fresh model and optimizer restore the newest valid
       step and run to ``SUP_STEPS``: every leaf's CRC32 must equal the
       reference's, and each restarted loss its loss;
    4. ``replica_hashes`` (a world of one) over every leaf on the card
       against ``_shard_hash`` of its host copy; the ``no_pipelining``
       fp16 witness; ``fused_dense`` / ``mlp``.

    Launches are checked every step against ``llama_1b_amp_train``'s
    ``adam`` form.  Free disk under ``build/`` is checked against twice
    the state's bytes before anything is written."""
    import shutil

    import torch
    from apex_tpu_torch import resilience as rz
    from apex_tpu_torch.models import LlamaConfig
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt

    t_phase = time.perf_counter()
    witness = _queue_c_witness(device)
    dense = _dense_checks(device)
    cfg = LlamaConfig.llama_1b()
    layers = cfg.num_hidden_layers
    per_step = {ln.LAYER_NORM_FWD.name: 2 * layers + 1,
                ln.LAYER_NORM_BWD.name: 2 * layers + 1,
                fa.FLASH_ATTENTION_FWD.name: layers,
                fa.FLASH_ATTENTION_DQ.name: layers,
                fa.FLASH_ATTENTION_DKV.name: layers,
                lh.FUSED_LM_HEAD_FWD.name: 1, lh.FUSED_LM_HEAD_DH.name: 1,
                lh.FUSED_LM_HEAD_DE.name: 1,
                mt.MT_SCALE.name: 1,          # has_overflow: found_inf
                mt.MT_ADAM.name: 1}
    batches = [_sup_batch(i, cfg.vocab_size) for i in range(SUP_STEPS)]
    root = os.path.join(ROOT, "build", "supervised")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # 1. the unsupervised reference ----------------------------------------
    t0 = time.perf_counter()
    ref = _SupervisedLlama(device, cfg, per_step)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    planted = ref.injector.placements(
        {n: p for n, p in ref.params.items()})
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        ref.step(b, i)
    peak = torch.cuda.max_memory_allocated()
    ref_p50 = statistics.median(ref.step_ms[1:])
    grads = [p.grad for p in ref.params.values()]
    census_ms = device_ms(lambda: rz.nonfinite_counts(grads), iters=10)
    check_ms = device_ms(lambda: ref.scaler.has_overflow(grads), iters=10)
    del grads
    t0 = time.perf_counter()
    ref_crcs, _, state_bytes, _ = _crcs_and_hashes(ref.tree(), hashes=False)
    crc_s = time.perf_counter() - t0
    ref_losses = [m["loss"] for m in ref.metrics]
    ref_ms = list(ref.step_ms)
    ref_launch_errors = ref.launch_errors
    del ref
    torch.cuda.empty_cache()
    free = shutil.disk_usage(root).free
    if free < 2 * state_bytes:
        raise AssertionError(f"supervised: {free} bytes free under build/, "
                             f"the checkpoints need {2 * state_bytes}")

    # 2. the faulted, supervised run ---------------------------------------
    deadline = SUP_DEADLINE_X * ref_p50 / 1e3
    events = []
    rz_sink = events.append
    from apex_tpu_torch._logging import add_event_sink, remove_event_sink

    add_event_sink(rz_sink)
    run = _SupervisedLlama(device, cfg, per_step)
    saves = []

    class TimedManager(rz.CheckpointManager):
        def save(self, step, tree):
            t = time.perf_counter()
            path = super().save(step, tree)
            saves.append(dict(step=step, s=time.perf_counter() - t))
            return path

    mgr = TimedManager(os.path.join(root, "ckpt"), keep=1)
    hb = os.path.join(root, "heartbeat.json")
    stream = rz.GuardedIterator(
        rz.FlakyIterator(
            rz.CorruptBatch(iter(batches), at=(SUP_CORRUPT_AT,), mode="nan",
                            seed=SUP_FAULT_SEED),
            fail_at=(SUP_FLAKY_AT,), failures=2),
        spec=rz.spec_of(batches[0]), skip_budget=2)
    slow = rz.SlowStep(SUP_SLOW, SUP_SLOW_X * deadline)
    sup = rz.TrainingSupervisor(
        mgr, rz.SupervisorConfig(
            step_deadline_s=deadline, max_consecutive_failures=2,
            checkpoint_every=10 * SUP_STEPS, heartbeat_path=hb,
            retry=rz.RetryPolicy(max_attempts=4, base_delay_s=0.0)),
        persist_transform=lambda _: run.tree())

    def step_fn(state, batch, i):
        slow(i)
        run.step(batch, i)
        return run.state

    # the escalation's validation, timed where the supervisor calls it
    validated = []
    plain_validate = rz.supervisor.validate_checkpoint

    def timed_validate(path):
        t = time.perf_counter()
        plain_validate(path)
        validated.append(time.perf_counter() - t)

    rz.supervisor.validate_checkpoint = timed_validate
    torch.cuda.reset_peak_memory_stats()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    try:
        sup.run(step_fn, run.state, stream, num_steps=SUP_STEPS)
    except rz.TrainingAborted as e:
        aborted = e
    else:
        raise AssertionError("supervised: the slow steps did not escalate")
    finally:
        remove_event_sink(rz_sink)
        rz.supervisor.validate_checkpoint = plain_validate
    abort_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _dispatch.KERNELS}
    peak = max(peak, torch.cuda.max_memory_allocated())
    sup_metrics = list(run.metrics)
    run_ms = list(run.step_ms)
    sup_ms = [m for i, m in enumerate(run_ms)
              if sup_metrics[i]["index"] not in SUP_SLOW]
    run_launch_errors = run.launch_errors
    del run, sup
    torch.cuda.empty_cache()
    ckpt_bytes = sum(os.path.getsize(os.path.join(aborted.checkpoint_path, f))
                     for f in os.listdir(aborted.checkpoint_path))

    # 3. the restart ---------------------------------------------------------
    t0 = time.perf_counter()
    again = _SupervisedLlama(device, cfg, per_step)
    again.init_opt_state()
    restored, at = mgr.restore(like=_cpu_like(again.tree()))
    again.load(restored)
    del restored
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    rz.TrainingSupervisor(None, rz.SupervisorConfig(
        step_deadline_s=deadline * SUP_SLOW_X * 4)).run(
        lambda s, b, i: (again.step(b, i), again.state)[1], again.state,
        rz.GuardedIterator(iter(batches[at + 1:]),
                           spec=rz.spec_of(batches[0])),
        num_steps=SUP_STEPS, start_step=at + 1)
    tree = again.tree()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = rz.replica_hashes(tree)
    torch.cuda.synchronize()
    hash_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    crcs, cpu_hashes, _, cpu_hash_s = _crcs_and_hashes(tree)
    crc_hash_s = time.perf_counter() - t0
    restart_losses = [m["loss"] for m in again.metrics]
    restart_ms = list(again.step_ms)
    launch_errors = ref_launch_errors + run_launch_errors + \
        again.launch_errors
    del again, tree
    torch.cuda.empty_cache()

    # the checks -------------------------------------------------------------
    kinds = [e["event"] for e in events]
    faults = [e.get("fault") for e in events if e["event"] == "fault_injected"]
    by_index = {m["index"]: m for m in sup_metrics}
    [(_, planted_path, planted_pos, _)] = planted
    diverged = sorted(p for p in crcs if crcs[p] != ref_crcs[p])
    hash_diff = sorted(p for p in cpu_hashes
                       if int(card[p]["hashes"][0]) != cpu_hashes[p])
    beat = rz.read_heartbeat(hb)
    checks = {
        "inf_step_skipped_and_named": (
            by_index[SUP_INF_STEP]["found_inf"]
            and by_index[SUP_INF_STEP]["nonfinite"] == {planted_path: 1}),
        "corrupt_batch_skipped": (stream.skipped == 1
                                  and kinds.count("batch_skipped") == 1),
        "flaky_fetch_retried": (kinds.count("retry_attempt") == 2
                                and kinds.count("retry_recovered") == 1),
        "slow_steps_stalled": kinds.count("watchdog_stall") == 2,
        "failures_then_abort": (kinds.count("supervisor_failure") == 2
                                and kinds.count("supervisor_abort") == 1),
        "faults_each_once": sorted(faults) == sorted(
            ["corrupt_batch", "flaky_iterator", "flaky_iterator",
             "slow_step", "slow_step"]),
        "aborted_at_last_slow_step": (aborted.step == SUP_SLOW[-1]
                                      and at == SUP_SLOW[-1]),
        "one_emergency_checkpoint": ([s["step"] for s in saves] == [at]
                                     and len(validated) == 1),
        "heartbeat_names_it": (beat["step"] == at and beat["ckpt_path"]
                               == aborted.checkpoint_path),
        "steps_before_abort": sorted(by_index) == list(range(at + 1)),
        "restart_bit_identical": not diverged and len(crcs) == len(ref_crcs),
        "restart_losses_equal": restart_losses == ref_losses[at + 1:],
        "faulted_losses_equal": [by_index[i]["loss"] for i in range(at + 1)]
        == ref_losses[:at + 1],
        "card_hash_equals_cpu": not hash_diff,
        "launches_exact": not launch_errors,
    }
    wd = rz.StepWatchdog(1.0)
    t0 = time.perf_counter()
    for i in range(10000):
        wd.arm(i)
        wd.disarm()
    arm_us = (time.perf_counter() - t0) / 10000 * 1e6
    t0 = time.perf_counter()
    for i in range(20):
        rz.write_heartbeat(os.path.join(root, "probe.json"), i)
    beat_ms = (time.perf_counter() - t0) / 20 * 1e3
    out = dict(
        config="llama-1b", batch=4, seq=2048, steps=SUP_STEPS,
        precision="amp O2 fp16 (norm scales fp32), fp32 masters, dynamic "
                  f"loss scaler from {SUP_SCALE}",
        optimizer="FusedAdam(lr=1e-3, master_weights=True)",
        nvidia_smi=smi, init_s=init_s, queue_c_witness=witness,
        fused_dense_mlp=dense, planted=dict(path=planted_path,
                                            element=planted_pos,
                                            step=SUP_INF_STEP),
        unsupervised_step_ms=ref_ms, supervised_step_ms=run_ms,
        restart_step_ms=restart_ms,
        unsupervised_p50_ms=ref_p50,
        supervised_p50_ms=statistics.median(sup_ms[1:]),
        deadline_s=deadline, slow_s=SUP_SLOW_X * deadline,
        census_device_ms=census_ms, found_inf_check_device_ms=check_ms,
        watchdog_arm_disarm_us=arm_us, heartbeat_write_ms=beat_ms,
        state_bytes=state_bytes, checkpoint_bytes=ckpt_bytes,
        disk_free_bytes=free, save_s=[s["s"] for s in saves],
        abort_wall_s=abort_s, validate_s=validated, restore_s=restore_s,
        crc_s=crc_s, final_crc_and_cpu_hash_s=crc_hash_s,
        cpu_hash_s=cpu_hash_s, hash_ms=hash_ms,
        hashed_leaves=len(card), crc_leaves=len(crcs),
        peak_mem_bytes=peak,
        losses=ref_losses, found_inf=[m["found_inf"] for m in sup_metrics],
        real_overflow_steps=[m["index"] for m in sup_metrics
                             if m["found_inf"]
                             and m["index"] != SUP_INF_STEP],
        scales=[m["scale"] for m in sup_metrics],
        launches=launches, launches_per_step=per_step,
        launch_errors=launch_errors[:5],
        diverged_leaves=diverged[:10], hash_mismatches=hash_diff[:10],
        events={k: kinds.count(k) for k in sorted(set(kinds))},
        checks=checks, s=time.perf_counter() - t_phase)
    log("phase3-supervised", **out)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"supervised: failed {failed}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the contrib zoo: attention blocks, losses, norms and ASP
# ---------------------------------------------------------------------------

# BERT-large's attention (PERF.md section 4, tools/model_bench.py's
# bert-large card): e 1024, 16 heads of 64, s 512, b 16; 10-25 % of each
# sequence's keys padded
CONTRIB_ATTN = dict(embed=1024, heads=16, seq=512, batch=16, pad_lo=0.10,
                    pad_hi=0.25)
CONTRIB_ENCDEC = dict(sq=256, sk=320)
CONTRIB_DROPOUT = 0.1
# packed varlen: 32 sequences of 128-512 tokens (seeded lengths), 16 heads
FMHA_CARD = dict(seqs=32, lo=128, hi=512, heads=16, d=64)
CONTRIB_SMALL = dict(embed=128, heads=2, seq=64, sk=80, batch=2)
CONTRIB_SMALL_TOL = 1e-4     # card against CPU, fp32 (TF32 off), of max |ref|
ROUTE_TOL = 2.0 ** -6        # bf16 fast against default route, of max |ref|
ROUTE_GRAD_TOL = 2.0 ** -6   # their gradients, of max |ref|
FMHA_TOL = 2.0 ** -7         # packed against per-sequence, of max |ref|
FMHA_GRAD_TOL = 2.0 ** -6
SOFTMAX_Y_TOL = 2.0 ** -8    # bf16 probabilities against the plain version:
#                              one bf16 ulp in [1/2, 1)
SOFTMAX_DX_TOL = 2.0 ** -7   # of max |ref|
# the losses: llama-1b's vocabulary at b 4 x s 2048; RetinaNet's level-3
# head at 640^2 (80^2 anchors positions x 9 anchors, 90 classes padded to
# 96); RNN-T at the MLPerf Training rnnt.yaml widths (joint 512, V 1024)
XENT_CARD = dict(rows=8192, vocab=32000, smoothing=0.1, pad_share=0.05)
FOCAL_CARD = dict(batch=8, hw=80, anchors=9, real=90, padded=96, alpha=0.25,
                  gamma=2.0, positives=0.01)
RNNT_CARD = dict(batch=16, t_lo=150, t_hi=280, y_lo=40, y_hi=100, hidden=512,
                 vocab=1024, checked=2)
LOSS_TOL = dict(xent=1e-5, xent_grad=2.0 ** -7, focal=1e-4,
                focal_grad=2.0 ** -7, rnnt=1e-4, rnnt_grad=2.0 ** -6)
# the norms: Stable Diffusion v1.5's UNet (block_out_channels 320 / 640 /
# 1280 / 1280, norm_num_groups 32, latent 64^2) at b 8; ResNet-50's first
# stage (b 128, 56^2, 256; its 3x3 64 -> 64 convolution)
GN_SHAPES = ((64, 320), (32, 640), (16, 1280), (8, 1280))
GN_BATCH = 8
BN_CARD = dict(batch=128, hw=56, channels=256)
CONV_CARD = dict(batch=128, hw=56, cin=64, cout=64)
INDEX_MUL_CARD = dict(rows=65536, n=1048576, hidden=256)
NORM_TOL = 2.0 ** -7         # bf16 against the library or fp32, of max |ref|
INDEX_MUL_TOL = 1e-5         # fp32 against fp64 (atomics), of max |ref|
SPARSITY_STEPS = 3
# the permutation search (numpy, host): one [1024, 1024] weight's first 64
# input channels, 2 rounds a phase (~4 s on a host core; the whole weight
# would take two 8.5 GB arrays a greedy round)
PERM_CARD = dict(rows=1024, cols=64, options={"max_rounds": 2})


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _launch_gate(label: str, got: dict, want: dict) -> None:
    """The port's kernels launched in one call (``got``, every kernel's
    count): exactly ``want``'s nonzero counts."""
    if _nonzero(got) != want:
        raise AssertionError(f"{label}: launches {_nonzero(got)}, expected "
                             f"{want}")


def _failed(label: str, checks: dict) -> None:
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{label}: failed {bad}")


def _pad_mask(g, b: int, s: int, lo: float, hi: float):
    """``[b, s]`` int32, 1 on padded keys: each sequence's last
    ``lo``-``hi`` of its keys (the share drawn from ``g``)."""
    import torch

    share = lo + (hi - lo) * torch.rand(b, generator=g, device=g.device)
    lengths = s - (share * s).round().long()
    pos = torch.arange(s, device=g.device)[None, :]
    return (pos >= lengths[:, None]).to(torch.int32), lengths


def _fwd_bwd(m, args, ct, **kw):
    """``m(*args, **kw)`` and its backward of ``sum(out * ct)``: the
    output, the first argument's gradient, the parameters' gradients and
    every kernel's launches in the call (counted from 0)."""
    import torch
    from apex_tpu_torch.ops import _dispatch

    for p in m.parameters():
        p.grad = None
    x = args[0].detach().requires_grad_()
    _dispatch.reset_launches()
    out = m(x, *args[1:], **kw)
    out.backward(ct.to(out.dtype))
    launches = _launch_counts()
    torch.cuda.synchronize()
    return (out.detach(), x.grad,
            {n: p.grad.detach().clone() for n, p in m.named_parameters()},
            launches)


def small_contrib_attention_check(device) -> dict:
    """``SelfMultiheadAttn`` (norm-add, bias; both routes) and
    ``EncdecMultiheadAttn`` (sq 64 against sk 80) at e 128, 2 heads, fp32,
    card against CPU with the same weights, a padded key tail and a fully
    padded batch row: the output and every gradient within
    ``CONTRIB_SMALL_TOL`` of the largest reference value; the fast routes
    launch the flash forward, dq and dk/dv once."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn,
        SelfMultiheadAttn,
    )
    from apex_tpu_torch.ops import flash_attention as fa

    c = CONTRIB_SMALL
    e, h, s, sk, b = (c[k] for k in ("embed", "heads", "seq", "sk", "batch"))
    g = torch.Generator().manual_seed(40)
    x = torch.randn(s, b, e, generator=g)
    kv = torch.randn(sk, b, e, generator=g)
    ct = torch.randn(s, b, e, generator=g)
    pad_q = torch.zeros(b, s, dtype=torch.int32)
    pad_q[0, 48:] = 1
    pad_q[1] = 1
    pad_k = torch.zeros(b, sk, dtype=torch.int32)
    pad_k[0, 70:] = 1
    flash = {fa.FLASH_ATTENTION_FWD.name: 1, fa.FLASH_ATTENTION_DQ.name: 1,
             fa.FLASH_ATTENTION_DKV.name: 1}
    out, checks = {}, {}
    for name, cls, kw, extra, pad in (
            ("self_fast", SelfMultiheadAttn,
             dict(bias=True, include_norm_add=True), (), pad_q),
            ("self_default", SelfMultiheadAttn,
             dict(bias=True, include_norm_add=True, impl="default"), (), pad_q),
            ("encdec_fast", EncdecMultiheadAttn, dict(bias=True), (kv,),
             pad_k)):
        cpu = cls(e, h, device="cpu", generator=torch.Generator()
                  .manual_seed(41), **kw)
        card = cls(e, h, device=device, **kw)
        card.load_state_dict(cpu.state_dict())
        ref = _fwd_bwd(cpu, (x, *extra), ct, key_padding_mask=pad,
                       is_training=False)
        got = _fwd_bwd(card, tuple(t.to(device) for t in (x, *extra)),
                       ct.to(device), key_padding_mask=pad.to(device),
                       is_training=False)
        errs = dict(out=_rel(got[0].cpu(), ref[0]), dx=_rel(got[1].cpu(),
                                                           ref[1]),
                    **{n: _rel(got[2][n].cpu(), ref[2][n]) for n in ref[2]})
        want = {} if kw.get("impl") == "default" else flash
        checks[name] = max(errs.values()) <= CONTRIB_SMALL_TOL
        _launch_gate(f"small contrib {name}", got[3], want)
        out[name] = dict(rel_errs=errs, launches=_nonzero(got[3]))
    out.update(checks=checks, tolerance=f"max |card - cpu| <= "
               f"{CONTRIB_SMALL_TOL} max |cpu|, fp32, TF32 off")
    log("phase3-contrib-attention-small", **out)
    _failed("small contrib attention", checks)
    return out


def _flash_padded_rows(q, k, v, qseg, kseg, do, lengths, smi) -> dict:
    """The flash forward, dq and dk/dv at BERT-large's padded shape (not
    causal, a (q, kv) segment-id pair) beside the plain version and SDPA
    with the padding as a boolean mask; the bound counts what the data
    needs: each query against its row's unpadded keys, and k and v read
    at the unpadded keys only."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.ops import flash_attention as fa

    b, h, s, d = q.shape
    scale = 1.0 / d ** 0.5
    seg = (qseg, kseg)
    keep = (kseg == 1)[:, None, None, :]
    pairs = int(lengths.sum()) * s * h
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, segment_ids=seg)
        calls = {"kernel": lambda: fa.flash_attention_fwd(q, k, v,
                                                          segment_ids=seg),
                 "plain": lambda: fa._plain_forward(
                     q, k, v, q_segment_ids=qseg, kv_segment_ids=kseg),
                 "library": lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=keep)}
        dev = _timed(calls, 20, big=("plain",))
        host = time_ms(calls["kernel"], iters=20, warmup=3)
        call = fa._BwdLaunch(q, k, v, o, lse, do, qseg, kseg, False, scale,
                             0.0, None)
        call.launch(fa.FLASH_ATTENTION_DQ)
        bwd = {}
        for name, kern in (("dq", fa.FLASH_ATTENTION_DQ),
                           ("dkv", fa.FLASH_ATTENTION_DKV)):
            fn = lambda kern=kern: call.launch(kern)
            bwd[name] = dict(kernel=device_ms(fn, iters=20),
                             kernel_again=device_ms(fn, iters=20),
                             host=time_ms(fn, iters=20, warmup=3))
        plain_bwd = time_ms(lambda: fa._plain_backward(
            q, k, v, o, lse, do, q_segment_ids=qseg, kv_segment_ids=kseg),
            iters=3, warmup=1)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    library_bwd = _fwd_bwd_minus_fwd(
        lambda: F.scaled_dot_product_attention(qr, kr, vr, attn_mask=keep),
        ((qr, kr, vr), do))
    prod = 2 * pairs * d
    io = 2 * b * h * s * d                  # one bf16 [b, h, s, d] operand
    kv = 2 * h * d * int(lengths.sum())     # one operand's unpadded keys
    stats = 4 * b * h * s                   # one fp32 [b, h, s]
    segs = 8 * b * s                        # the two int32 segment rows
    shape = dict(b=b, h=h, sq=s, sk=s, d=d, causal=False, dtype="bfloat16",
                 segments="(q, kv) pair, keys padded", valid_pairs=pairs)
    nbytes = {
        # q, k, v (unpadded keys), segments read; o, lse written
        "fwd": 2 * io + 2 * kv + stats + segs,
        # q, o, do, k, v (unpadded keys), lse, segments read; dq, delta
        # written
        "dq": 4 * io + 2 * kv + 2 * stats + segs,
        # q, do, k, v (unpadded keys), lse, delta, segments read; dk, dv
        # written at every key
        "dkv": 4 * io + 2 * kv + 2 * stats + segs}
    rows = {"fwd": _row(dev, host, 2 * prod, nbytes["fwd"], 989e12,
                        exps=pairs)}
    rows["fwd"]["library_call"] = "F.scaled_dot_product_attention(attn_mask)"
    for name, nprod in (("dq", 3), ("dkv", 4)):
        r = bwd[name]
        rows[name] = _row(dict(kernel=r["kernel"],
                               kernel_again=r["kernel_again"],
                               plain=plain_bwd, library=library_bwd),
                          r["host"], nprod * prod, nbytes[name], 989e12,
                          exps=pairs)
        rows[name].update(
            plain_and_library_compute="dq, dk and dv together",
            library_call="F.scaled_dot_product_attention(attn_mask) forward "
                         "+ backward minus forward (CUDA graphs of 10)")
    for name, row in rows.items():
        row.update(shape=shape, nvidia_smi=smi, bytes=nbytes[name],
                   tflops=(2 if name == "fwd" else 3 if name == "dq" else 4)
                   * prod / row["ms"] / 1e9)
        log("phase3-contrib-time", kernel=f"flash_attention_{name}",
            at="bert_large_padded", **row)
    return rows


def _mask_softmax_rows(x4, mask4, dy, smi) -> dict:
    """The softmax kernels at ``fast_mask_softmax_dropout_func``'s shape
    (bf16 ``[16, 16, 512, 512]``, a broadcast ``[b, 1, 1, sk]`` pad mask,
    scale 1) beside the plain versions, ``torch.softmax`` of the
    pre-masked scores and ``aten._softmax_backward_data``."""
    import torch
    from apex_tpu_torch.ops import softmax as sm

    b, h, sq, sk = x4.shape
    elems = x4.numel()
    x_masked = torch.where(mask4, -10000.0, x4.float()).to(x4.dtype)
    rows = {}
    with torch.inference_mode():
        y = sm.softmax_fwd(x4, 1.0, mask4, False)
        for name, calls, nbytes, flops in (
                ("fwd", {"kernel": lambda: sm.softmax_fwd(x4, 1.0, mask4,
                                                          False),
                         "plain": lambda: sm._plain_forward(x4, 1.0, mask4),
                         "library": lambda: torch.softmax(x_masked, -1)},
                 4 * elems + b * sk, 8 * elems),
                ("bwd", {"kernel": lambda: sm.softmax_bwd(y, dy, 1.0),
                         "plain": lambda: sm._plain_backward(y, dy, 1.0),
                         "library": lambda: torch.ops.aten._softmax_backward_data(
                             dy, y, -1, x4.dtype)},
                 6 * elems, 5 * elems)):
            dev = _timed(calls, 20, big=("plain",))
            host = time_ms(calls["kernel"], iters=20, warmup=3)
            row = _row(dev, host, flops, nbytes, FP32_OPS_PER_S)
            row.update(shape=dict(b=b, np=h, sq=sq, sk=sk, dtype="bfloat16",
                                  mask="[b, 1, 1, sk] broadcast"),
                       bytes=nbytes, flops=flops, nvidia_smi=smi,
                       library_call=("torch.softmax of the pre-masked scores"
                                     if name == "fwd" else
                                     "aten._softmax_backward_data"))
            log("phase3-contrib-time", kernel=f"scaled_softmax_{name}",
                at="mask_softmax_dropout", **row)
            rows[name] = row
    return rows


def _fmha_plain_ratios(q, k, v, o, lse, do, grads, seg, heads: int):
    """The flash forward's ``(o, lse)`` and backward's ``grads`` (dq, dk,
    dv) against the plain versions on the same inputs (the backward's with
    the forward's ``o`` and ``lse``), in units of phases 1 and 2's
    per-element tolerances; ``heads`` heads at a time (the plain versions'
    fp32 scores of the packed problem are 5.4 GB for all 16)."""
    import torch
    from apex_tpu_torch.ops import flash_attention as fa

    sk = k.shape[2]
    case = dict(dtype="bfloat16", causal=False, sk=sk)
    pair = None if seg is None else (seg, seg)
    worst = dict(o=0.0, lse=0.0, dq=0.0, dk=0.0, dv=0.0)
    abs_err = dict(worst)
    scale = 1.0 / q.shape[-1] ** 0.5
    for h0 in range(0, q.shape[1], heads):
        hs = slice(h0, h0 + heads)
        qh, kh, vh, oh, lh, dh = (t[:, hs] for t in (q, k, v, o, lse, do))
        ro, rlse = fa._plain_forward(qh, kh, vh, q_segment_ids=seg,
                                     kv_segment_ids=seg)
        ratios = dict(o=_tol_ratio(oh, ro, _flash_o_tol(qh, kh, vh, ro, case,
                                                        pair)),
                      lse=_tol_ratio(lh, rlse, 1e-5 + 1e-5 * rlse.abs()))
        errs = dict(o=(oh.float() - ro.float()).abs().max(),
                    lse=(lh - rlse).abs().max())
        del ro, rlse
        ref = fa._plain_backward(qh, kh, vh, oh, lh, dh, q_segment_ids=seg,
                                 kv_segment_ids=seg)
        delta = (dh.float() * oh.float()).sum(-1)
        tols = _flash_bwd_tol(qh, kh, vh, lh, dh, delta, *ref, case, scale,
                              seg, seg)
        for n, got, r, t in zip(("dq", "dk", "dv"), grads, ref, tols):
            ratios[n] = _tol_ratio(got[:, hs], r, t)
            errs[n] = (got[:, hs].float() - r.float()).abs().max()
        del ref, tols, delta
        for n in worst:
            worst[n] = max(worst[n], ratios[n])
            abs_err[n] = max(abs_err[n], float(errs[n]))
    return worst, abs_err


def _fmha_check(device, smi) -> dict:
    """``fmha_varlen`` on ``FMHA_CARD["seqs"]`` packed sequences (bf16,
    forward and backward): launches 1/1/1 for the packed call; the packed
    problem's flash forward and backward, and each sequence's own flash
    calls, held to the plain versions on the same inputs at phases 1 and
    2's per-element tolerances (``_fmha_plain_ratios``); ``fmha_varlen``'s
    output and qkv gradient within the same tolerances of the plain
    versions, and within ``FMHA_TOL`` / ``FMHA_GRAD_TOL`` of the largest
    value of the per-sequence calls'; both forms timed on the device
    beside the work ratio total^2 / sum(L_i^2) (the kernels skip no block
    between segments) and the bounds of the work the data needs."""
    import torch
    from apex_tpu_torch.contrib.fmha import (
        fmha_varlen,
        segment_ids_from_cu_seqlens,
    )
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import flash_attention as fa

    c = FMHA_CARD
    gl = torch.Generator().manual_seed(44)
    lens = torch.randint(c["lo"], c["hi"] + 1, (c["seqs"],), generator=gl)
    cu = torch.cat([torch.zeros(1, dtype=torch.int64), lens.cumsum(0)])
    total = int(cu[-1])
    g = torch.Generator(device=device).manual_seed(45)
    qkv = torch.randn(total, 3, c["heads"], c["d"], generator=g,
                      device=device).to(torch.bfloat16)
    ct = torch.randn(total, c["heads"], c["d"], generator=g,
                     device=device).to(torch.bfloat16)
    cu_d = cu.to(device)
    packed = qkv.detach().requires_grad_()
    _dispatch.reset_launches()
    out = fmha_varlen(packed, cu_d)
    out.backward(ct)
    launches = _launch_counts()
    _launch_gate("fmha_varlen", launches, {
        fa.FLASH_ATTENTION_FWD.name: 1, fa.FLASH_ATTENTION_DQ.name: 1,
        fa.FLASH_ATTENTION_DKV.name: 1})
    spans = [(int(cu[i]), int(lens[i])) for i in range(c["seqs"])]
    loop = qkv.detach().requires_grad_()
    outs = []
    for a, n in spans:
        q, k, v = (loop[a:a + n, i].transpose(0, 1)[None] for i in range(3))
        outs.append(fa.flash_attention(q, k, v)[0].transpose(0, 1))
    ref = torch.cat(outs)
    ref.backward(ct)
    errs = dict(out=_rel(out.detach(), ref.detach()),
                dqkv=_rel(packed.grad, loop.grad))
    checks = dict(out=errs["out"] <= FMHA_TOL,
                  dqkv=errs["dqkv"] <= FMHA_GRAD_TOL,
                  finite=bool(torch.isfinite(out).all()))
    # the kernels against the plain versions: the packed problem (one
    # segment-id row), fmha_varlen's own output and gradient, and each
    # sequence's calls
    seg = segment_ids_from_cu_seqlens(cu_d, total)[None]
    q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
    do = ct.transpose(0, 1)[None]
    per = [tuple(qkv[a:a + n, i].transpose(0, 1)[None] for i in range(3))
           + (ct[a:a + n].transpose(0, 1)[None],) for a, n in spans]
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, segment_ids=seg)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, segment_ids=seg)
        torch.cuda.synchronize()
        packed_ratio, packed_abs = _fmha_plain_ratios(q, k, v, o, lse, do,
                                                      grads, seg, 4)
        gq = packed.grad.permute(1, 2, 0, 3)[None]   # [1, 3, h, total, d]
        varlen_ratio, _ = _fmha_plain_ratios(
            q, k, v, out.detach().transpose(0, 1)[None], lse, do,
            (gq[:, 0], gq[:, 1], gq[:, 2]), seg, 4)
        saved, seq_ratio = [], {}
        for t in per:
            so = fa.flash_attention_fwd(*t[:3])
            sg = fa.flash_attention_bwd(*t[:3], *so, t[3])
            r, _ = _fmha_plain_ratios(*t[:3], *so, t[3], sg, None, 16)
            seq_ratio = {n: max(seq_ratio.get(n, 0.0), x)
                         for n, x in r.items()}
            saved.append(so)
        del grads, gq
        # device times: the packed problem against the loop, forward and
        # backward (flash_attention_fwd / _bwd, no autograd)
        times = dict(
            packed_fwd=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, segment_ids=seg), iters=5),
            loop_fwd=device_ms(lambda: [fa.flash_attention_fwd(*t[:3])
                                        for t in per], iters=5),
            packed_bwd=device_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, segment_ids=seg), iters=5),
            loop_bwd=device_ms(lambda: [fa.flash_attention_bwd(
                *t[:3], so[0], so[1], t[3]) for t, so in zip(per, saved)],
                iters=5))
    checks.update(
        packed_vs_plain=max(packed_ratio.values()) <= 1.0,
        varlen_vs_plain=max(varlen_ratio.values()) <= 1.0,
        sequences_vs_plain=max(seq_ratio.values()) <= 1.0)
    need = int((lens * lens).sum())
    h, d = c["heads"], c["d"]
    io = 2 * total * h * d                    # one bf16 [total, h, d]
    stats, segs = 4 * h * total, 4 * total
    # what the data needs: each query against its own sequence's keys;
    # forward: q, k, v, segments read, o, lse written; backward (dq, dk and
    # dv together): q, k, v, o, do, lse, segments read, dq, dk, dv written,
    # its five products (s, dp, dv, dq, dk) and p's exponentials once
    bounds = dict(fwd=_bound(4 * h * d * need, 4 * io + stats + segs, 989e12,
                             exps=h * need),
                  bwd=_bound(10 * h * d * need, 8 * io + stats + segs,
                             989e12, exps=h * need))
    out_d = dict(sequences=c["seqs"], lengths=lens.tolist(), total=total,
                 heads=h, d=d, dtype="bfloat16", launches=launches,
                 rel_errs=errs, device_ms=times,
                 plain_tol_ratios=dict(packed=packed_ratio,
                                       fmha_varlen=varlen_ratio,
                                       sequences=seq_ratio),
                 packed_max_abs_err=packed_abs,
                 work_ratio=total * total / need,
                 packed_fwd_flops=4 * h * d * total * total,
                 needed_fwd_flops=4 * h * d * need,
                 packed_fwd_bound_ms=bounds["fwd"]["bound_ms"],
                 packed_bwd_bound_ms=bounds["bwd"]["bound_ms"],
                 bounds=bounds, nvidia_smi=smi, checks=checks,
                 tolerance=f"the packed problem's kernels, fmha_varlen's "
                           f"output and qkv gradient, and each sequence's "
                           f"kernels against the plain versions: phases 1 "
                           f"and 2's per-element tolerances (ratios <= 1); "
                           f"packed against per-sequence flash calls: output "
                           f"<= {FMHA_TOL}, qkv gradient <= {FMHA_GRAD_TOL} "
                           f"of max |ref|")
    log("phase3-contrib-fmha", **out_d)
    _failed("fmha_varlen", checks)
    return out_d


def contrib_attention(device, smi: str) -> dict:
    """The attention blocks at BERT-large's widths (``CONTRIB_ATTN``, bf16
    parameters and activations):

    - ``SelfMultiheadAttn`` (packed QKV, bias, ``include_norm_add``) on
      ``[s, b, e]`` with 10-25 % of each sequence's keys padded, forward and
      backward: flash forward, dq and dk/dv once each and nothing else;
      the fast route against the default route on the card (output within
      ``ROUTE_TOL``, input and parameter gradients within
      ``ROUTE_GRAD_TOL`` of the largest reference value);
    - ``EncdecMultiheadAttn`` at sq 256 against sk 320 (the kernels'
      non-causal sq != sk case), the same launches and route check;
    - ``fast_mask_softmax_dropout_func`` on ``[b * h, s, s]`` with a binary
      and an additive pad mask: softmax forward and backward once each,
      held to the plain versions;
    - attention dropout 0.1 on the flash route: the kernel's output
      against the plain forward with the same keep bits, and the dropped
      share within 6 binomial deviations;
    - ``fmha_varlen`` (``_fmha_check``), the small card-against-CPU check,
      and the flash and softmax kernels timed at these shapes beside SDPA
      and the library softmax."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn,
        SelfMultiheadAttn,
        fast_mask_softmax_dropout_func,
    )
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import softmax as sm

    t_phase = time.perf_counter()
    c = CONTRIB_ATTN
    e, h, s, b = (c[k] for k in ("embed", "heads", "seq", "batch"))
    d = e // h
    bf = torch.bfloat16
    flash = {fa.FLASH_ATTENTION_FWD.name: 1, fa.FLASH_ATTENTION_DQ.name: 1,
             fa.FLASH_ATTENTION_DKV.name: 1}
    out = dict(nvidia_smi=smi, shape=dict(c, dtype="bfloat16"),
               tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                         cudnn=torch.backends.cudnn.allow_tf32))
    checks = {}
    out["small"] = small_contrib_attention_check(device)
    g = torch.Generator(device=device).manual_seed(42)
    kw = dict(bias=True, include_norm_add=True, params_dtype=bf,
              device=device)
    fast = SelfMultiheadAttn(e, h, generator=g, **kw)
    default = SelfMultiheadAttn(e, h, impl="default", **kw)
    default.load_state_dict(fast.state_dict())
    x = torch.randn(s, b, e, generator=g, device=device).to(bf)
    ct = torch.randn(s, b, e, generator=g, device=device).to(bf)
    pad, lengths = _pad_mask(g, b, s, c["pad_lo"], c["pad_hi"])
    res = {}
    for name, m in (("fast", fast), ("default", default)):
        res[name] = _fwd_bwd(m, (x,), ct, key_padding_mask=pad,
                             is_training=False)
    _launch_gate("SelfMultiheadAttn fast", res["fast"][3], flash)
    _launch_gate("SelfMultiheadAttn default", res["default"][3], {})
    errs = dict(out=_rel(res["fast"][0], res["default"][0]),
                dx=_rel(res["fast"][1], res["default"][1]),
                **{n: _rel(res["fast"][2][n], res["default"][2][n])
                   for n in res["fast"][2]})
    checks["self_out"] = errs["out"] <= ROUTE_TOL
    checks["self_grads"] = max(v for k, v in errs.items()
                               if k != "out") <= ROUTE_GRAD_TOL
    checks["self_finite"] = bool(torch.isfinite(res["fast"][0]).all())
    out["self"] = dict(launches=res["fast"][3], fast_vs_default=errs,
                       padded_share=float(pad.float().mean()),
                       fwd_bwd_ms={name: _fb_ms(lambda t, m=m: m(
                           t, key_padding_mask=pad, is_training=False),
                           x.detach().requires_grad_())
                           for name, m in (("fast", fast),
                                           ("default", default))})
    del res, default

    # encoder-decoder: 256 queries against 320 keys, keys padded
    sq, sk = CONTRIB_ENCDEC["sq"], CONTRIB_ENCDEC["sk"]
    kw_ed = dict(bias=True, params_dtype=bf, device=device)
    ed = EncdecMultiheadAttn(e, h, generator=g, **kw_ed)
    ed_def = EncdecMultiheadAttn(e, h, impl="default", **kw_ed)
    ed_def.load_state_dict(ed.state_dict())
    xq = torch.randn(sq, b, e, generator=g, device=device).to(bf)
    xk = torch.randn(sk, b, e, generator=g, device=device).to(bf)
    ctq = torch.randn(sq, b, e, generator=g, device=device).to(bf)
    pad_k, _ = _pad_mask(g, b, sk, c["pad_lo"], c["pad_hi"])
    r_fast = _fwd_bwd(ed, (xq, xk), ctq, key_padding_mask=pad_k,
                      is_training=False)
    r_def = _fwd_bwd(ed_def, (xq, xk), ctq, key_padding_mask=pad_k,
                     is_training=False)
    _launch_gate("EncdecMultiheadAttn fast", r_fast[3], flash)
    ed_errs = dict(out=_rel(r_fast[0], r_def[0]), dq=_rel(r_fast[1], r_def[1]),
                   **{n: _rel(r_fast[2][n], r_def[2][n]) for n in r_fast[2]})
    checks["encdec_out"] = ed_errs["out"] <= ROUTE_TOL
    checks["encdec_grads"] = max(v for k, v in ed_errs.items()
                                 if k != "out") <= ROUTE_GRAD_TOL
    out["encdec"] = dict(sq=sq, sk=sk, launches=r_fast[3],
                         fast_vs_default=ed_errs)
    del ed, ed_def, r_fast, r_def

    # the standalone masked softmax on [b * h, s, s] scores
    scores = (torch.randn(b * h, s, s, generator=g, device=device) * 3).to(bf)
    dy = torch.randn(b * h, s, s, generator=g, device=device).to(bf)
    additive = torch.where(pad == 1, -10000.0, 0.0)
    out["mask_softmax"] = {}
    for form, mask, is_add in (("binary", pad, False),
                               ("additive", additive, True)):
        xs = scores.detach().requires_grad_()
        _dispatch.reset_launches()
        probs = fast_mask_softmax_dropout_func(False, h, xs, mask, is_add,
                                               0.0)
        probs.backward(dy)
        launches = _launch_counts()
        _launch_gate(f"mask softmax {form}", launches, {
            sm.SCALED_SOFTMAX_FWD.name: 1, sm.SCALED_SOFTMAX_BWD.name: 1})
        x4 = scores.reshape(b, h, s, s)
        if is_add:
            x4 = x4 + additive[:, None, None, :].to(bf)
        m4 = None if is_add else (pad == 1)[:, None, None, :].expand(
            b, 1, s, s)
        with torch.no_grad():
            y_ref = sm._plain_forward(x4, 1.0, m4)
            dx_ref = sm._plain_backward(probs.detach().reshape(b, h, s, s),
                                        dy.reshape(b, h, s, s), 1.0)
        y_err = float((probs.detach().reshape(b, h, s, s).float()
                       - y_ref.float()).abs().max())
        dx_err = _rel(xs.grad.reshape(b, h, s, s), dx_ref)
        checks[f"softmax_{form}"] = (y_err <= SOFTMAX_Y_TOL
                                     and dx_err <= SOFTMAX_DX_TOL)
        out["mask_softmax"][form] = dict(launches=launches,
                                         y_max_abs_err=y_err,
                                         dx_rel_err=dx_err)
    out["mask_softmax"]["rows"] = _mask_softmax_rows(
        scores.reshape(b, h, s, s), (pad == 1)[:, None, None, :],
        dy.reshape(b, h, s, s), smi)
    del scores, dy, xs, probs

    # attention dropout in the flash kernel: the kernel's output against
    # the plain forward with the same keep bits
    drop = SelfMultiheadAttn(e, h, dropout=CONTRIB_DROPOUT,
                             generator=torch.Generator(device=device)
                             .manual_seed(43), **kw)
    drop.load_state_dict(fast.state_dict())
    seen = []
    orig = fa._forward

    def spy(q, k, v, qseg, kseg, causal, scale, rate, seed):
        o, lse = orig(q, k, v, qseg, kseg, causal, scale, rate, seed)
        seen.append((q, k, v, qseg, kseg, rate, seed, o))
        return o, lse

    fa._forward = spy
    _dispatch.reset_launches()
    try:
        with torch.no_grad():
            drop(x, key_padding_mask=pad, is_training=True)
    finally:
        fa._forward = orig
    _launch_gate("SelfMultiheadAttn dropout", _launch_counts(),
                 {fa.FLASH_ATTENTION_FWD.name: 1})
    q, k, v, qseg, kseg, rate, seed, o = seen[0]
    with torch.no_grad():
        ref_o = fa._plain_forward(q, k, v, q_segment_ids=qseg,
                                  kv_segment_ids=kseg, dropout_rate=rate,
                                  dropout_seed=seed)[0]
        keep = fa._keep(device, b, h, s, s, seed, rate)
        dropped = 1.0 - float(keep.float().mean())
    n = keep.numel()
    bound = 6 * (rate * (1 - rate) / n) ** 0.5
    drop_err = _rel(o, ref_o)
    checks["dropout_bits"] = drop_err <= ROUTE_TOL and rate == CONTRIB_DROPOUT
    checks["dropout_share"] = abs(dropped - rate) <= bound
    out["dropout"] = dict(rate=rate, seed=seed, dropped_share=dropped,
                          bound=bound, kernel_vs_plain=drop_err)
    del drop, keep, ref_o, seen

    # the flash rows at the padded shape, in the model's layout
    qkv = torch.randn(s, b, 3, h, d, generator=g, device=device).to(bf)
    q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
    do = torch.randn(s, b, h, d, generator=g, device=device).to(bf).permute(
        1, 2, 0, 3)
    qseg = torch.ones(b, s, dtype=torch.int32, device=device)
    kseg = (1 - pad).to(torch.int32)
    out["flash_rows"] = _flash_padded_rows(q, k, v, qseg, kseg, do, lengths,
                                           smi)
    del qkv, q, k, v, do, fast
    out["fmha"] = _fmha_check(device, smi)
    out.update(checks=checks, s=time.perf_counter() - t_phase,
               tolerance=f"fast against default route: output <= "
                         f"{ROUTE_TOL}, gradients <= {ROUTE_GRAD_TOL} of max "
                         f"|default|; softmax y <= {SOFTMAX_Y_TOL} absolute, "
                         f"dx <= {SOFTMAX_DX_TOL} of max |plain|; dropout: "
                         f"kernel <= {ROUTE_TOL} of max |plain with the same "
                         f"bits|, dropped share within 6 binomial deviations")
    log("phase3-contrib-attention", **{k: v for k, v in out.items()
                                       if k not in ("small", "fmha")})
    _failed("contrib attention", checks)
    torch.cuda.empty_cache()
    return out


def _focal_fp64(x, cls, npos, real, alpha, gamma):
    """The sigmoid focal loss in fp64 (torchvision's formula)."""
    import torch

    x = x[..., :real].double()
    y = (cls[..., None] == torch.arange(real, device=x.device)).double()
    p = torch.sigmoid(x)
    ce = -(y * torch.nn.functional.logsigmoid(x)
           + (1 - y) * torch.nn.functional.logsigmoid(-x))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    return (a_t * (1 - p_t) ** gamma * ce).sum() / npos


def _rnnt_fp64(x, label, fl: int, yl: int, blank: int = 0):
    """One sequence's RNN-T loss and logit gradient in float64 on the
    host (the DP of the reference's ``_transducer_ref.py``, rows
    vectorized over u)."""
    import numpy as np

    x = np.asarray(x, np.float64)[:fl, :yl + 1]
    m = x.max(-1, keepdims=True)
    logp = x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))
    T, U = fl, yl + 1
    blank_lp = logp[:, :, blank]
    lab_lp = np.take_along_axis(logp[:, :yl], np.asarray(label[:yl])[None, :,
                                                                     None],
                                axis=-1)[..., 0]                 # [T, yl]
    alpha = np.full((T, U), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U):
            if t == 0 and u == 0:
                continue
            a = alpha[t - 1, u] + blank_lp[t - 1, u] if t else -np.inf
            bb = alpha[t, u - 1] + lab_lp[t, u - 1] if u else -np.inf
            alpha[t, u] = np.logaddexp(a, bb)
    beta = np.full((T, U), -np.inf)
    beta[T - 1, U - 1] = blank_lp[T - 1, U - 1]
    for t in range(T - 1, -1, -1):
        for u in range(U - 1, -1, -1):
            if t == T - 1 and u == U - 1:
                continue
            a = beta[t + 1, u] + blank_lp[t, u] if t + 1 < T else -np.inf
            bb = beta[t, u + 1] + lab_lp[t, u] if u + 1 < U else -np.inf
            beta[t, u] = np.logaddexp(a, bb)
    loss = -beta[0, 0]
    com = alpha + loss
    dlogp = np.zeros_like(logp)
    lab = np.asarray(label[:yl])
    nxt_u = np.concatenate([beta[:, 1:], np.full((T, 1), -np.inf)], 1)
    dlogp[:, np.arange(yl), lab] = -np.exp(com[:, :yl] + nxt_u[:, :yl]
                                           + lab_lp)
    nxt_t = np.concatenate([beta[1:], np.full((1, U), -np.inf)], 0)
    db = -np.exp(com + nxt_t + blank_lp)
    db[T - 1, U - 1] = -np.exp(com[T - 1, U - 1] + blank_lp[T - 1, U - 1])
    dlogp[:, :, blank] += db
    dx = dlogp - np.exp(logp) * dlogp.sum(-1, keepdims=True)
    return loss, dx


def _kernel_launches(fn) -> int:
    """The device kernels ``fn`` launches, counted under
    ``torch.profiler``."""
    fn()
    _, rows = _traced_kernels(fn)
    return int(sum(e.count for e in rows))


def contrib_losses(device, smi: str) -> dict:
    """The losses at their users' sizes:

    - ``SoftmaxCrossEntropyLoss`` on ``[8192, 32000]`` bf16 logits,
      smoothing 0.1, ~5 % of the rows at ``padding_idx``: the losses within
      ``LOSS_TOL["xent"]`` (+ the same relative) of fp32
      ``F.cross_entropy(label_smoothing, ignore_index)`` on the card, the
      gradient within ``LOSS_TOL["xent_grad"]`` of its largest value; no
      fp32 ``[N, V]`` tensor saved for the backward; both timed, with the
      peak memory over forward and backward;
    - ``focal_loss`` at RetinaNet's level-3 head for 640^2 inputs: the loss
      against fp64 on the card, its gradient, timed;
    - ``TransducerJoint`` + a linear to V + ``TransducerLoss`` at RNN-T's
      widths: forward and backward, losses finite, ``RNNT_CARD["checked"]``
      sequences' losses and logit gradients against float64 on the host,
      the device kernels a loss takes (forward + backward) counted."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib.focal_loss import focal_loss
    from apex_tpu_torch.contrib.transducer import (
        TransducerJoint,
        TransducerLoss,
    )
    from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss

    t_phase = time.perf_counter()
    out, checks = dict(nvidia_smi=smi), {}
    g = torch.Generator(device=device).manual_seed(50)

    # cross-entropy
    c = XENT_CARD
    n, vocab, smooth = c["rows"], c["vocab"], c["smoothing"]
    logits = (torch.randn(n, vocab, generator=g, device=device) * 2).to(
        torch.bfloat16)
    labels = torch.randint(1, vocab, (n,), generator=g, device=device)
    labels[torch.rand(n, generator=g, device=device) < c["pad_share"]] = 0
    w = torch.randn(n, generator=g, device=device)
    saved = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xl = logits.detach().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((tuple(t.shape), str(t.dtype))) or t,
            lambda t: t):
        loss = SoftmaxCrossEntropyLoss.apply(xl, labels, smooth, 0)
    (loss * w).sum().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    xr = logits.float().requires_grad_()
    ref = F.cross_entropy(xr, labels, label_smoothing=smooth, ignore_index=0,
                          reduction="none")
    (ref * w).sum().backward()
    loss_err = float(((loss - ref).abs() / (1.0 + ref.abs())).max()
                     .detach())
    grad_err = _rel(xl.grad, xr.grad)
    big_fp32 = [s for s in saved if s[1] == "torch.float32"
                and int(np.prod(s[0])) >= n * vocab]
    del xr, ref
    torch.cuda.empty_cache()
    xb = logits.detach().requires_grad_()

    def lib_step():
        xb.grad = None
        (F.cross_entropy(xb, labels, label_smoothing=smooth, ignore_index=0,
                         reduction="none") * w).sum().backward()

    def port_step():
        xl.grad = None
        (SoftmaxCrossEntropyLoss.apply(xl, labels, smooth, 0)
         * w).sum().backward()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lib_step()
    torch.cuda.synchronize()
    lib_peak = torch.cuda.max_memory_allocated() - base
    checks.update(xent_loss=loss_err <= LOSS_TOL["xent"],
                  xent_grad=grad_err <= LOSS_TOL["xent_grad"],
                  xent_no_fp32_nv_saved=not big_fp32,
                  xent_padding_zero=bool((loss[labels == 0] == 0).all()))
    out["xentropy"] = dict(
        rows=n, vocab=vocab, smoothing=smooth,
        padded_rows=int((labels == 0).sum()), loss_rel_err=loss_err,
        grad_rel_err=grad_err, saved_for_backward=saved,
        peak_bytes_fwd_bwd=peak, library_peak_bytes_fwd_bwd=lib_peak,
        logits_bytes=logits.numel() * 2,
        fwd_bwd_ms=time_ms(port_step, iters=5, warmup=1),
        library_fwd_bwd_ms=time_ms(lib_step, iters=5, warmup=1),
        library_call="F.cross_entropy(bf16 logits, label_smoothing, "
                     "ignore_index, reduction='none')")
    del logits, xl, xb, w
    torch.cuda.empty_cache()

    # focal loss at RetinaNet's level 3
    c = FOCAL_CARD
    b, hw, an, real, padded = (c[k] for k in ("batch", "hw", "anchors",
                                              "real", "padded"))
    logits = (torch.randn(b, hw, hw, an, padded, generator=g, device=device)
              * 2 - 4).to(torch.bfloat16)
    r = torch.rand(b, hw, hw, an, generator=g, device=device)
    cls = torch.where(r < c["positives"],
                      torch.randint(0, real, r.shape, generator=g,
                                    device=device),
                      torch.where(r < 0.9, -1, -2))
    npos = float((cls >= 0).sum())
    xf = logits.detach().requires_grad_()
    fl = focal_loss(xf, cls, npos, real, c["alpha"], c["gamma"])
    fl.backward()
    x64 = logits.detach().double().requires_grad_()
    ref = _focal_fp64(x64, cls, npos, real, c["alpha"], c["gamma"])
    ref.backward()
    f_err = abs(float(fl.detach()) - float(ref.detach())) / abs(
        float(ref.detach()))
    f_grad = _rel(xf.grad, x64.grad)
    checks.update(focal_loss=f_err <= LOSS_TOL["focal"],
                  focal_grad=f_grad <= LOSS_TOL["focal_grad"],
                  focal_padded_zero=bool((xf.grad[..., real:] == 0).all()))

    def focal_step():
        xf.grad = None
        focal_loss(xf, cls, npos, real, c["alpha"], c["gamma"]).backward()

    out["focal"] = dict(shape=list(logits.shape), real_classes=real,
                        positives=npos, loss=float(fl.detach()), rel_err=f_err,
                        grad_rel_err=f_grad,
                        fwd_bwd_ms=time_ms(focal_step, iters=5, warmup=1))
    del logits, xf, x64, r, cls
    torch.cuda.empty_cache()

    # RNN-T joint + loss
    c = RNNT_CARD
    gl = torch.Generator().manual_seed(51)
    B = c["batch"]
    f_len = torch.randint(c["t_lo"], c["t_hi"] + 1, (B,), generator=gl)
    y_len = torch.randint(c["y_lo"], c["y_hi"] + 1, (B,), generator=gl)
    T, U = int(f_len.max()), int(y_len.max()) + 1
    H, V = c["hidden"], c["vocab"]
    label = torch.randint(1, V, (B, U - 1), generator=gl)
    f = (torch.randn(B, T, H, generator=g, device=device) * 0.5).to(
        torch.bfloat16).requires_grad_()
    gp = (torch.randn(B, U, H, generator=g, device=device) * 0.5).to(
        torch.bfloat16).requires_grad_()
    proj = torch.nn.Linear(H, V, device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        proj.weight.normal_(0.0, 0.05, generator=g)
        proj.bias.zero_()
    joint, loss_fn = TransducerJoint(relu=True), TransducerLoss()
    fl_d, yl_d, lab_d = (t.to(device) for t in (f_len, y_len, label))

    def logits_of():
        return proj(joint(f, gp, fl_d, yl_d))

    xj = logits_of().detach().requires_grad_()
    losses = loss_fn(xj, lab_d, fl_d, yl_d, 0)
    losses.sum().backward()
    rn_checks = dict(finite=bool(torch.isfinite(losses).all()))
    compared = []
    for i in range(c["checked"]):
        ref_loss, ref_dx = _rnnt_fp64(
            xj[i].detach().float().cpu().numpy(), label[i].numpy(),
            int(f_len[i]), int(y_len[i]))
        fl_i, yl_i = int(f_len[i]), int(y_len[i])
        got_dx = xj.grad[i, :fl_i, :yl_i + 1].float().cpu().numpy()
        compared.append(dict(
            seq=i, f_len=fl_i, y_len=yl_i, loss=float(losses[i]),
            ref_loss=float(ref_loss),
            loss_rel_err=abs(float(losses[i]) - ref_loss) / abs(ref_loss),
            grad_rel_err=float(np.abs(got_dx - ref_dx).max()
                               / np.abs(ref_dx).max())))
    rn_checks["loss_fp64"] = all(r["loss_rel_err"] <= LOSS_TOL["rnnt"]
                                 for r in compared)
    rn_checks["grad_fp64"] = all(r["grad_rel_err"] <= LOSS_TOL["rnnt_grad"]
                                 for r in compared)
    for k, ok in rn_checks.items():
        checks[f"rnnt_{k}"] = ok

    def rnnt_loss_step():
        xj.grad = None
        loss_fn(xj, lab_d, fl_d, yl_d, 0).sum().backward()

    def rnnt_full_step():
        for p in (f, gp, *proj.parameters()):
            p.grad = None
        loss_fn(logits_of(), lab_d, fl_d, yl_d, 0).mean().backward()

    out["transducer"] = dict(
        batch=B, T=T, U=U, hidden=H, vocab=V, f_len=f_len.tolist(),
        y_len=y_len.tolist(), losses_finite=rn_checks["finite"],
        compared=compared,
        loss_fwd_bwd_ms=time_ms(rnnt_loss_step, iters=3, warmup=1),
        joint_proj_loss_fwd_bwd_ms=time_ms(rnnt_full_step, iters=3, warmup=1),
        loss_fwd_bwd_device_kernels=_kernel_launches(rnnt_loss_step),
        lattice_note="the DP loops over T: a fixed handful of launches a "
                     "row of alpha and of beta")
    del f, gp, proj, xj
    torch.cuda.empty_cache()
    out.update(checks=checks, s=time.perf_counter() - t_phase,
               tolerance=f"xentropy: |loss - ref| <= {LOSS_TOL['xent']} "
                         f"(1 + |ref|), gradient <= {LOSS_TOL['xent_grad']} "
                         f"of max |ref| (fp32 F.cross_entropy); focal: loss "
                         f"<= {LOSS_TOL['focal']} relative, gradient <= "
                         f"{LOSS_TOL['focal_grad']} of max |ref| (fp64); "
                         f"RNN-T: loss <= {LOSS_TOL['rnnt']} relative, logit "
                         f"gradient <= {LOSS_TOL['rnnt_grad']} of max |ref| "
                         f"(float64 on the host)")
    log("phase3-contrib-losses", **out)
    _failed("contrib losses", checks)
    return out


def small_contrib_norms_check(device) -> dict:
    """GroupNorm (swish), BatchNorm2d_NHWC (with z), the four convolution
    forms and ``index_mul_2d`` at small sizes, fp32, card against CPU: the
    output and every gradient within ``CONTRIB_SMALL_TOL`` of the largest
    reference value."""
    import torch
    from apex_tpu_torch.contrib import conv_bias_relu as cbr
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d

    gc = torch.Generator().manual_seed(60)
    rnd = lambda *s: torch.randn(*s, generator=gc)  # noqa: E731
    x_gn, x_bn, z_bn = rnd(2, 8, 8, 64), rnd(4, 5, 5, 16), rnd(4, 5, 5, 16)
    x_c, w_c, b_c = rnd(2, 8, 8, 8), rnd(8, 8, 3, 3), rnd(8)
    s_c, m_c = rnd(8), (rnd(2, 8, 8, 8) > 0).float()
    in1, in2 = rnd(10, 16), rnd(32, 16)
    idx = torch.randint(0, 10, (32,), generator=gc)

    def run(dev):
        res = {}
        gn = GroupNorm(32, 64, act="swish", device=dev)
        bn = BatchNorm2d_NHWC(16, fuse_relu=True, device=dev)
        with torch.no_grad():
            gn.weight.copy_(torch.linspace(0.5, 1.5, 64))
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
        cases = {
            "group_norm": (lambda x: gn(x), (x_gn,)),
            "bn_addrelu": (lambda x, z: bn(x, z), (x_bn, z_bn)),
            "conv_bias": (lambda x, w: cbr.ConvBias(x, w, b_c.to(dev), 1),
                          (x_c, w_c)),
            "conv_bias_relu": (lambda x, w: cbr.ConvBiasReLU(
                x, w, b_c.to(dev), 1), (x_c, w_c)),
            "conv_bias_mask_relu": (lambda x, w: cbr.ConvBiasMaskReLU(
                x, w, b_c.to(dev), m_c.to(dev), 1), (x_c, w_c)),
            "conv_frozen": (lambda x, w: cbr.ConvFrozenScaleBiasReLU(
                x, w, s_c.to(dev), b_c.to(dev), 1), (x_c, w_c)),
            "index_mul_2d": (lambda a, c: index_mul_2d(a, c, idx.to(dev)),
                             (in1, in2))}
        for name, (fn, args) in cases.items():
            ins = [a.detach().to(dev).requires_grad_() for a in args]
            y = fn(*ins)
            y.backward(torch.ones_like(y) * 0.5 + y.detach() * 0.1)
            res[name] = [y.detach().cpu()] + [a.grad.cpu() for a in ins]
        for n, p in list(gn.named_parameters()) + list(bn.named_parameters()):
            res[f"param_{n}_{p.numel()}"] = [p.grad.cpu()]
        return res

    cpu, card = run("cpu"), run(device)
    errs = {k: max(_rel(a, b) for a, b in zip(card[k], cpu[k])) for k in cpu}
    checks = {k: v <= CONTRIB_SMALL_TOL for k, v in errs.items()}
    out = dict(rel_errs=errs, checks=checks,
               tolerance=f"max |card - cpu| <= {CONTRIB_SMALL_TOL} max |cpu|, "
                         f"fp32, TF32 off")
    log("phase3-contrib-norms-small", **out)
    _failed("small contrib norms", checks)
    return out


def _fb_ms(fn, *ins, iters=5):
    """Eager ms of ``fn(*ins)``'s forward and backward (of its sum)."""
    def step():
        for t in ins:
            t.grad = None
        fn(*ins).float().sum().backward()

    return time_ms(step, iters=iters, warmup=1)


def contrib_norms(device, smi: str) -> dict:
    """The norms and the convolution and gather epilogues at their users'
    shapes, bf16 unless said, each forward and backward, none launching a
    kernel of the port:

    - ``GroupNorm(32, act="swish")`` at Stable Diffusion v1.5's UNet
      resolutions (``GN_SHAPES`` at b 8, channels last) against
      ``F.group_norm`` + SiLU on the same tensors (an NCHW view), within
      ``NORM_TOL`` of the largest value, both timed;
    - ``BatchNorm2d_NHWC`` (with z) and ``GroupBatchNorm2d`` at ResNet-50's
      first stage over an NCCL group of 1, against fp32 training-mode
      ``F.batch_norm``;
    - the four ``conv_bias_relu`` forms at ResNet-50's 3x3 64 -> 64 in
      bf16 and fp32 (TF32 as the card phase leaves it: off), timed;
    - ``index_mul_2d`` at ``INDEX_MUL_CARD`` in fp32 against fp64, its
      scatter-add's bits over two backward calls reported;
    - the small card-against-CPU check."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.contrib import conv_bias_relu as cbr
    from apex_tpu_torch.contrib.cudnn_gbn import (
        GroupBatchNorm2d,
        bn_group_index_groups,
    )
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d
    from apex_tpu_torch.ops import _dispatch

    t_phase = time.perf_counter()
    out = dict(nvidia_smi=smi, tf32=dict(
        matmul=torch.backends.cuda.matmul.allow_tf32,
        cudnn=torch.backends.cudnn.allow_tf32))
    checks = {}
    out["small"] = small_contrib_norms_check(device)
    _dispatch.reset_launches()
    g = torch.Generator(device=device).manual_seed(61)
    bf = torch.bfloat16

    # GroupNorm over the UNet's shapes
    out["group_norm"] = []
    for hw, ch in GN_SHAPES:
        gn = GroupNorm(32, ch, act="swish", device=device)
        with torch.no_grad():
            gn.weight.normal_(1.0, 0.1, generator=g)
            gn.bias.normal_(0.0, 0.1, generator=g)
        x = torch.randn(GN_BATCH, hw, hw, ch, generator=g, device=device).to(bf)
        lib = lambda t: F.silu(F.group_norm(  # noqa: E731
            t.permute(0, 3, 1, 2), 32, gn.weight.to(bf), gn.bias.to(bf),
            gn.eps))
        xa = x.detach().requires_grad_()
        xb = x.detach().requires_grad_()
        ya, yb = gn(xa), lib(xb).permute(0, 2, 3, 1)
        ya.float().sum().backward()
        yb.float().sum().backward()
        ref = F.silu(F.group_norm(x.float().permute(0, 3, 1, 2), 32,
                                  gn.weight, gn.bias, gn.eps)).permute(
                                      0, 2, 3, 1)
        errs = dict(out=_rel(ya, ref), library_out=_rel(yb, ref),
                    dx_vs_library=_rel(xa.grad, xb.grad))
        checks[f"group_norm_{hw}_{ch}"] = (errs["out"] <= NORM_TOL
                                           and errs["dx_vs_library"]
                                           <= 4 * NORM_TOL)
        out["group_norm"].append(dict(
            shape=[GN_BATCH, hw, hw, ch], rel_errs=errs,
            fwd_bwd_ms=_fb_ms(gn, xa), library_fwd_bwd_ms=_fb_ms(lib, xb),
            library_call="F.silu(F.group_norm(NCHW view))"))
        del gn, x, xa, xb, ya, yb, ref
    torch.cuda.empty_cache()

    # the batch norms at ResNet-50's first stage, NCCL world of 1
    c = BN_CARD
    shape = (c["batch"], c["hw"], c["hw"], c["channels"])
    x = torch.randn(*shape, generator=g, device=device).to(bf)
    z = torch.randn(*shape, generator=g, device=device).to(bf)
    ref = F.batch_norm(x.float().permute(0, 3, 1, 2), None, None,
                       training=True).permute(0, 2, 3, 1)
    out["batch_norm"] = {}
    with _nccl_world("gbn_rdv_") as group:
        nhwc = BatchNorm2d_NHWC(c["channels"], fuse_relu=True,
                                process_group=group, device=device)
        gbn = GroupBatchNorm2d(
            c["channels"], process_group=group, device=device,
            axis_index_groups=bn_group_index_groups(1, 1))
        for name, m, args, want in (
                ("bn_nhwc_addrelu", nhwc, (x, z),
                 torch.relu(ref + z.float())),
                ("group_bn", gbn, (x,), ref)):
            ins = [a.detach().requires_grad_() for a in args]
            y = m(*ins)
            y.float().sum().backward()
            err = _rel(y, want)
            checks[name] = err <= NORM_TOL and bool(
                torch.isfinite(ins[0].grad).all())
            out["batch_norm"][name] = dict(
                shape=list(shape), rel_err=err,
                fwd_bwd_ms=_fb_ms(m, *ins))
        del nhwc, gbn
    del x, z, ref
    torch.cuda.empty_cache()

    # the convolution forms at ResNet-50's 3x3, bf16 and fp32
    c = CONV_CARD
    out["conv"] = {}
    for dt in (bf, torch.float32):
        x = torch.randn(c["batch"], c["cin"], c["hw"], c["hw"], generator=g,
                        device=device).to(dt).to(
                            memory_format=torch.channels_last)
        w = (torch.randn(c["cout"], c["cin"], 3, 3, generator=g, device=device)
             * 0.05).to(dt).to(memory_format=torch.channels_last)
        bias = torch.randn(c["cout"], generator=g, device=device).to(dt)
        scale = torch.rand(c["cout"], generator=g, device=device).to(dt)
        mask = (torch.rand(c["batch"], c["cout"], c["hw"], c["hw"],
                           generator=g, device=device) > 0.1).to(dt)
        forms = {
            "ConvBias": lambda x, w: cbr.ConvBias(x, w, bias, 1),
            "ConvBiasReLU": lambda x, w: cbr.ConvBiasReLU(x, w, bias, 1),
            "ConvBiasMaskReLU": lambda x, w: cbr.ConvBiasMaskReLU(
                x, w, bias, mask, 1),
            "ConvFrozenScaleBiasReLU": lambda x, w: cbr.ConvFrozenScaleBiasReLU(
                x, w, scale, bias, 1)}
        x64 = x.double()
        y_ref = F.conv2d(x64, w.double(), padding=1)
        name_dt = str(dt).split(".")[-1]
        for name, fn in forms.items():
            xi, wi = x.detach().requires_grad_(), w.detach().requires_grad_()
            y = fn(xi, wi)
            y.float().sum().backward()
            pre = {"ConvBias": y_ref + bias.double()[:, None, None],
                   "ConvBiasReLU": torch.relu(y_ref
                                              + bias.double()[:, None, None]),
                   "ConvBiasMaskReLU": torch.relu(
                       (y_ref + bias.double()[:, None, None]) * mask.double()),
                   "ConvFrozenScaleBiasReLU": torch.relu(
                       y_ref * scale.double()[:, None, None]
                       + bias.double()[:, None, None])}[name]
            err = _rel(y, pre)
            checks[f"{name}_{name_dt}"] = err <= (
                NORM_TOL if dt == bf else 1e-5)
            out["conv"][f"{name}_{name_dt}"] = dict(
                rel_err_vs_fp64=err, fwd_bwd_ms=_fb_ms(fn, xi, wi),
                shape=[c["batch"], c["cin"], c["hw"], c["hw"], c["cout"]],
                layout="NCHW-logical, channels_last memory, OIHW weights")
        del x, w, x64, y_ref, mask
    torch.cuda.empty_cache()

    # index_mul_2d
    c = INDEX_MUL_CARD
    in1 = torch.randn(c["rows"], c["hidden"], generator=g, device=device)
    in2 = torch.randn(c["n"], c["hidden"], generator=g, device=device)
    idx = torch.randint(0, c["rows"], (c["n"],), generator=g, device=device)
    a, b2 = in1.detach().requires_grad_(), in2.detach().requires_grad_()
    y = index_mul_2d(a, b2, idx)
    y.backward(in2)
    first = a.grad.clone()
    a.grad = b2.grad = None
    index_mul_2d(a, b2, idx).backward(in2)
    ref1 = torch.zeros_like(in1, dtype=torch.float64).index_add_(
        0, idx, in2.double() * in2.double())
    err_f = _rel(y, in1[idx] * in2)
    err_b = _rel(a.grad, ref1)
    checks["index_mul_2d"] = err_f == 0.0 and err_b <= INDEX_MUL_TOL
    out["index_mul_2d"] = dict(
        **c, dtype="float32", fwd_max_rel_err=err_f, grad_in1_rel_err=err_b,
        grad_in1_bits_equal_over_two_calls=bool(torch.equal(first, a.grad)),
        fwd_bwd_ms=_fb_ms(lambda p, q: index_mul_2d(p, q, idx), a, b2))
    del in1, in2, idx, a, b2, y, first, ref1
    torch.cuda.empty_cache()
    out["launches"] = _launch_counts()
    _launch_gate("contrib norms", out["launches"], {})
    out.update(checks=checks, s=time.perf_counter() - t_phase,
               tolerance=f"bf16: <= {NORM_TOL} of max |fp32 or fp64 ref| "
                         f"(the group norm's input gradient against the "
                         f"library's <= {4 * NORM_TOL}); fp32 convolutions "
                         f"<= 1e-5 of max |fp64|; index_mul_2d forward "
                         f"exact, grad_in1 <= {INDEX_MUL_TOL} of max |fp64| "
                         f"(atomics)")
    log("phase3-contrib-norms", **{k: v for k, v in out.items()
                                   if k != "small"})
    _failed("contrib norms", checks)
    return out


def sparsity_check(device, smi: str) -> dict:
    """ASP on BERT-large (``bert_pretrain.LARGE``, O2 bf16, FusedLAMB with
    bf16 moments): ``init_model_for_pruning("m4n2_1d")`` over the
    transformer layers' linear weights, the optimizer wrapped, then
    ``compute_sparse_masks`` on the card, each mask equal to the one
    computed on the CPU copy of the same weight; ``SPARSITY_STEPS``
    fine-tuning steps, after each every masked group of 4 holding at most
    2 nonzeros and the loss finite; the permutation search on one weight's
    ``PERM_CARD`` slice, its host seconds."""
    import numpy as np
    import torch
    from apex_tpu_torch.contrib.sparsity import (
        ASP,
        accelerated_search_for_good_permutation,
        apply_permutation,
        create_mask,
        sum_after_2_to_4,
    )
    from apex_tpu_torch.examples import bert_pretrain as bp

    t_phase = time.perf_counter()
    c = bp.LARGE
    model, opt = bp.build(c["layers"], c["hidden"], c["heads"], c["vocab"],
                          c["seq"], o2=True, state_dtype=torch.bfloat16,
                          device=device)
    batch = bp.to_device(bp.bench_batch(np.random.default_rng(0), c["batch"],
                                        c["seq"], c["vocab"]), device)
    checks = {}
    ASP.reset()
    try:
        ASP.init_model_for_pruning(model, "m4n2_1d", verbosity=0,
                                   allowed_layer_names=["transformer.layers"])
        ASP.init_optimizer_for_pruning(opt)
        params = dict(model.named_parameters())
        host = {n: params[n].detach().cpu() for n in ASP.masks()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = ASP.compute_sparse_masks()
        torch.cuda.synchronize()
        mask_s = time.perf_counter() - t0
        differ = [n for n, w in host.items()
                  if not torch.equal(create_mask(w), masks[n].cpu())]
        checks["masks_equal_cpu"] = not differ
        checks["pruned_half"] = all(
            float((params[n] == 0).float().mean()) >= 0.5 for n in masks)
        losses, worst = [], []
        for _ in range(SPARSITY_STEPS):
            losses.append(float(bp.train_step(model, opt, batch)))
            worst.append(max(int((params[n].detach().reshape(-1, 4) != 0)
                                 .sum(-1).max()) for n in masks))
        checks["two_of_four"] = max(worst) <= 2
        checks["finite"] = all(np.isfinite(losses))
        checks["masked_zero"] = all(
            bool((params[n][~m] == 0).all()) for n, m in masks.items())
        shapes = sorted({tuple(params[n].shape) for n in masks})
        n_masked = sum(params[n].numel() for n in masks)
    finally:
        ASP.reset()
    name = "language_model.transformer.layers.0.self_attention.dense.weight"
    w = host[name].float().numpy()[:PERM_CARD["rows"], :PERM_CARD["cols"]]
    t0 = time.perf_counter()
    perm = accelerated_search_for_good_permutation(w, PERM_CARD["options"])
    perm_s = time.perf_counter() - t0
    before, after = sum_after_2_to_4(w), sum_after_2_to_4(
        apply_permutation(w, perm))
    checks["permutation"] = (sorted(perm.tolist()) == list(range(w.shape[1]))
                             and after >= before)
    out = dict(nvidia_smi=smi, config="bert-large", layers=c["layers"],
               masked_weights=len(host), masked_elements=n_masked,
               weight_shapes=[list(s) for s in shapes],
               compute_masks_s=mask_s, masks_differ_from_cpu=differ,
               losses=losses, max_nonzeros_per_group_of_4=worst,
               permutation_search=dict(
                   weight=name, slice=[PERM_CARD["rows"], PERM_CARD["cols"]],
                   options=PERM_CARD["options"], host_s=perm_s,
                   retained_before=before, retained_after=after,
                   note="numpy on the host; a greedy round over all 1024 "
                        "columns would allocate two [C(256, 2), 16, 1024, "
                        "4] fp32 arrays (8.5 GB each)"),
               checks=checks, s=time.perf_counter() - t_phase)
    log("phase3-sparsity", **out)
    del model, opt, batch, host
    torch.cuda.empty_cache()
    _failed("sparsity", checks)
    return out


# ---------------------------------------------------------------------------
# phase 3: apex_tpu_torch.RNN (a byte-level mLSTM), the DCGAN and the
# convergence cross product
# ---------------------------------------------------------------------------

# Radford et al. 2017 (arXiv:1704.01444): a 64-wide embedding of the 256
# byte values, one mLSTM of 4096, a 4096 -> 256 head; 256-byte
# subsequences in batches of 128, fp32 (the JAX RNN's param_dtype)
RNN_CARD = dict(vocab=256, embed=64, hidden=4096, seq=256, batch=128)
RNN_STEPS = 4           # timed steps after one warm-up
RNN_LR = 5e-4           # Adam's, as in the paper
RNN_SMALL = dict(T=8, B=4, F=16, H=32, L=2)   # the card-against-CPU cells
RNN_SMALL_TOL = 1e-5    # fp32, TF32 off: of the largest CPU value
RNN_HALVES_TOL = 1e-5   # the sequence in two halves against whole, absolute
# DCGAN (Radford, Metz and Chintala 2016, arXiv:1511.06434) at CIFAR-10's
# 32 x 32 x 3: nz 100, ngf = ndf = 64, batch 128; fp16 O2, three scalers
DCGAN_CARD = dict(nz=100, ngf=64, ndf=64, batch=128, steps=20)
DCGAN_FORCED_AT = 3     # steps before the forced overflow
DCGAN_SMALL = dict(nz=64, ngf=32, ndf=32, batch=16, steps=4)  # JAX's sizes
DCGAN_SMALL_TOL = {"O0": 1e-4, "O2": 2e-3}   # losses, relative
# the L1 cross product at ResNet-50's width (bench.py's resnet50 card):
# the harness's own lr and tolerances
CONVERGENCE_CARD = dict(arch="resnet50", image_size=224, batch_size=128,
                        num_classes=1000, steps=12, half="bf16", lr=0.05,
                        rtol=0.15, atol=0.25)


def _rnn_small_check(device) -> dict:
    """Every cell type, one-way and bidirectional, at ``RNN_SMALL``: the
    same weights (a seeded CPU init copied to the card) and input on the
    card and on the CPU; output, every final hidden tensor and every
    gradient of ``sum(output ** 2)`` within ``RNN_SMALL_TOL`` of the
    largest CPU value."""
    import torch
    from apex_tpu_torch import RNN

    c = RNN_SMALL
    worst = {}
    for kind in ("LSTM", "GRU", "ReLU", "Tanh", "mLSTM"):
        for bi in (False, True):
            x = torch.randn(c["T"], c["B"], c["F"],
                            generator=torch.Generator().manual_seed(5))
            runs = {}
            for where, dev in (("cpu", "cpu"), ("card", device)):
                model = getattr(RNN, kind)(
                    c["F"], c["H"], c["L"], bidirectional=bi, device=dev,
                    generator=torch.Generator().manual_seed(6)
                    if where == "cpu" else None)
                if where == "card":
                    model.load_state_dict(runs["cpu"]["state"])
                out, finals = model(x.to(dev))
                (out ** 2).sum().backward()
                runs[where] = dict(
                    state=model.state_dict(),
                    vals=dict(out=out.detach(),
                              **{f"final{i}_{j}": t.detach()
                                 for i, f in enumerate(finals)
                                 for j, t in enumerate(f)},
                              **{f"grad_{n}": p.grad
                                 for n, p in model.named_parameters()}))
            errs = {k: _rel(runs["card"]["vals"][k].cpu(), v)
                    for k, v in runs["cpu"]["vals"].items()}
            name = f"{kind}_{'bidirectional' if bi else 'one_way'}"
            worst[name] = max(errs.values())
            if worst[name] > RNN_SMALL_TOL:
                raise AssertionError(f"rnn {name} card against CPU: {errs}")
    return dict(shape=c, tol=RNN_SMALL_TOL, worst_rel_err=worst)


def rnn_train(device, smi: str) -> dict:
    """Phase ``phase3-rnn`` (see the module docstring)."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch import RNN
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.optimizers import FusedAdam

    t_phase = time.perf_counter()
    live = torch.cuda.memory_allocated()
    out = dict(nvidia_smi=smi, config=RNN_CARD, steps=f"1 warm-up + "
               f"{RNN_STEPS}", precision="fp32, TF32 off; FusedAdam "
               f"lr {RNN_LR}; one fixed seeded batch")
    out["small"] = _rnn_small_check(device)
    log("phase3-rnn-small", **out["small"])
    c = RNN_CARD
    V, E, H, T, B = c["vocab"], c["embed"], c["hidden"], c["seq"], c["batch"]
    gen = torch.Generator(device=device).manual_seed(28)
    rnn = RNN.mLSTM(E, H, 1, device=device, generator=gen)
    embed = torch.nn.Parameter(torch.randn(V, E, generator=gen,
                                           device=device))
    head_w = torch.nn.Parameter(torch.randn(V, H, generator=gen,
                                            device=device) * H ** -0.5)
    head_b = torch.nn.Parameter(torch.zeros(V, device=device))
    params = [embed, *rnn.parameters(), head_w, head_b]
    opt = FusedAdam(params, lr=RNN_LR)
    data = torch.randint(0, V, (T + 1, B), generator=gen, device=device)
    x, y = data[:-1], data[1:]
    events = []

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        h, _ = rnn(F.embedding(x, embed))
        loss = F.cross_entropy(F.linear(h.reshape(T * B, H), head_w, head_b),
                               y.reshape(-1))
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        events.append(ev)
        return loss.detach()

    torch.cuda.synchronize()
    warm = float(step())
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    events.clear()
    _dispatch.reset_launches()
    for i in range(RNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        _launch_gate(f"rnn step {i}", _launch_counts(),
                     {mt.MT_ADAM.name: i + 1})
    peak = torch.cuda.max_memory_allocated()
    split = [[a.elapsed_time(b) for a, b in zip(ev, ev[1:])] for ev in events]
    p50 = statistics.median(step_ms)
    # products a step: the hoisted [T*B, E] projections, the recurrent
    # h @ w_mhh and m @ w_hh a timestep, the head; backward twice that
    fwd_flops = 2 * T * B * (E * 4 * H + E * H + H * H + H * 4 * H + H * V)
    out.update(
        warmup_loss=warm, losses=losses, step_ms=step_ms, step_ms_p50=p50,
        fwd_bwd_opt_device_ms=split,
        fwd_ms_p50=statistics.median(s[0] for s in split),
        bwd_ms_p50=statistics.median(s[1] for s in split),
        opt_ms_p50=statistics.median(s[2] for s in split),
        flops_per_step=3 * fwd_flops,
        fp32_tflops=3 * fwd_flops / (p50 / 1e3) / 1e12,
        fp32_peak_share=3 * fwd_flops / (p50 / 1e3) / FP32_OPS_PER_S,
        parameters=sum(p.numel() for p in params), peak_mem_bytes=peak,
        live_at_start_bytes=live,
        launches=_launch_counts(),
        launches_per_step={mt.MT_ADAM.name: 1})
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and losses[0] < warm):
        raise AssertionError(f"rnn: loss {warm} then {losses} is not finite "
                             f"and falling")
    traced_ms, kernels = _traced_kernels(step)
    out["profile"] = _device_profile(traced_ms, kernels, p50)
    out["profile"]["device_kernels_per_step"] = int(sum(e.count
                                                        for e in kernels))
    with torch.no_grad():
        emb = F.embedding(x, embed)
        whole, _ = rnn(emb)
        a, hid = rnn(emb[:T // 2])
        b, _ = rnn(emb[T // 2:], hid)
    out["halves_max_abs_diff"] = float((torch.cat([a, b]) - whole).abs().max())
    if not out["halves_max_abs_diff"] <= RNN_HALVES_TOL:
        raise AssertionError(f"rnn: the sequence in two halves differs from "
                             f"it whole by {out['halves_max_abs_diff']}")
    del rnn, opt, params, embed, head_w, head_b, emb, whole, a, b, hid
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-rnn", **{k: v for k, v in out.items()
                         if k not in ("launches", "small")})
    return out


def _dcgan_state(trainer) -> list:
    """Every discriminator parameter, master, moment and step, as bytes."""
    import torch

    def bits(t):
        return t.detach().reshape(-1).view(torch.uint8).clone()

    return ([bits(p) for p in trainer.d_params]
            + [bits(v) for p in trainer.d_params
               for v in trainer.optD.state[p].values() if torch.is_tensor(v)])


def _dcgan_forced_overflow(device) -> dict:
    """fp16 O2 at ``DCGAN_CARD``'s widths: after ``DCGAN_FORCED_AT``
    steps, an inf written into loss 1's scaled gradients leaves every
    discriminator parameter, master, moment and its step bit for bit,
    takes the generator's step, and halves scaler 1 alone."""
    import numpy as np
    import torch
    from apex_tpu_torch.examples import dcgan_main_amp as dc

    c = DCGAN_CARD
    tr = dc.DCGANTrainer(nz=c["nz"], ngf=c["ngf"], ndf=c["ndf"],
                         opt_level="O2", half=torch.float16, device=device)
    rng = np.random.default_rng(0)
    for _ in range(DCGAN_FORCED_AT):
        tr.step(*dc.synthetic_batch(rng, c["batch"], c["nz"], device))
    before = _dcgan_state(tr)
    g_before = [p.detach().clone() for p in tr.g_params]
    scales = [float(s.scale) for s in tr.states]

    def hook(loss_id, grads):
        if loss_id == 1:
            grads[0].view(-1)[0].fill_(float("inf"))

    _, flags = tr.step(*dc.synthetic_batch(rng, c["batch"], c["nz"], device),
                       grad_hook=hook)
    after = _dcgan_state(tr)
    out = dict(
        found_inf=[bool(f) for f in flags],
        d_bits_kept=all(torch.equal(a, b) for a, b in zip(before, after)),
        g_stepped=any(not torch.equal(a, p) for a, p in zip(g_before,
                                                            tr.g_params)),
        scales_before=scales, scales_after=[float(s.scale)
                                            for s in tr.states])
    want = [scales[0], scales[1] / 2, scales[2]]
    if not (out["found_inf"] == [False, True, False] and out["d_bits_kept"]
            and out["g_stepped"] and out["scales_after"] == want):
        raise AssertionError(f"dcgan forced overflow: {out}")
    return out


def _dcgan_small_check(device) -> dict:
    """``train`` at the JAX example's sizes (``DCGAN_SMALL``) on the card
    and on the CPU from the same seeded CPU init: each step's three
    losses within ``DCGAN_SMALL_TOL`` (relative) at O0 and at fp16 O2,
    the scales equal; 2 ``mt_adam`` and 3 ``mt_scale`` launches a step."""
    import torch
    from apex_tpu_torch.examples import dcgan_main_amp as dc
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import multi_tensor as mt

    c = DCGAN_SMALL
    gen = torch.Generator().manual_seed(16)
    init = (dc.Generator(c["nz"], c["ngf"], device="cpu",
                         generator=gen).state_dict(),
            dc.Discriminator(c["ndf"], device="cpu",
                             generator=gen).state_dict())
    out = {}
    for level, half in (("O0", torch.float32), ("O2", torch.float16)):
        runs = {}
        for where, dev in (("cpu", "cpu"), ("card", device)):
            _dispatch.reset_launches()
            runs[where] = dc.train(
                steps=c["steps"], batch=c["batch"], nz=c["nz"], ngf=c["ngf"],
                ndf=c["ndf"], opt_level=level, half=half, device=dev,
                init=init, verbose=False)
            runs[where]["launches"] = _launch_counts()
        cpu, card = runs["cpu"], runs["card"]
        err = max(abs(a - b) / abs(b) for la, lb in zip(card["losses"],
                                                       cpu["losses"])
                  for a, b in zip(la, lb))
        row = dict(losses_card=card["losses"], losses_cpu=cpu["losses"],
                   max_rel_err=err, tol=DCGAN_SMALL_TOL[level],
                   scales_equal=card["scales"] == cpu["scales"])
        if not (err <= DCGAN_SMALL_TOL[level] and row["scales_equal"]):
            raise AssertionError(f"dcgan {level} card against CPU: {row}")
        _launch_gate(f"dcgan small {level}", card["launches"],
                     {mt.MT_ADAM.name: 2 * c["steps"],
                      mt.MT_SCALE.name: 3 * c["steps"]})
        out[level] = row
    return out


def dcgan_train(device, smi: str) -> dict:
    """Phase ``phase3-dcgan`` (see the module docstring)."""
    import numpy as np
    import torch
    from apex_tpu_torch.examples import dcgan_main_amp as dc
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import multi_tensor as mt

    t_phase = time.perf_counter()
    c = DCGAN_CARD
    out = dict(nvidia_smi=smi, config=c, precision="fp16 O2, three dynamic "
               "scalers, FusedAdam (lr 2e-4, betas 0.5, 0.999) fp32 masters")
    out["small"] = _dcgan_small_check(device)
    log("phase3-dcgan-small", **out["small"])
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    res = dc.train(steps=c["steps"], batch=c["batch"], nz=c["nz"],
                   ngf=c["ngf"], ndf=c["ndf"], opt_level="O2",
                   half=torch.float16, device=device, verbose=False)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    _launch_gate("dcgan", launches, {mt.MT_ADAM.name: 2 * c["steps"],
                                     mt.MT_SCALE.name: 3 * c["steps"]})
    flat = [x for step in res["losses"] + res["scales"] for x in step]
    if not all(map(math.isfinite, flat)):
        raise AssertionError(f"dcgan: losses {res['losses']} or scales "
                             f"{res['scales']} not finite")
    p50 = statistics.median(res["step_ms"][1:])
    tr = res["trainer"]
    batch = dc.synthetic_batch(np.random.default_rng(1), c["batch"],
                               c["nz"], device)
    out.update(
        losses_first=res["losses"][0], losses_last=res["losses"][-1],
        scales_last=res["scales"][-1],
        real_overflows=[sum(f[i] for f in res["found_inf"])
                        for i in range(3)],
        wall_s=wall, step_ms=res["step_ms"], step_ms_p50=p50,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        live_at_start_bytes=live, launches=launches,
        launches_per_step={mt.MT_ADAM.name: 2, mt.MT_SCALE.name: 3})
    traced_ms, kernels = _traced_kernels(lambda: tr.step(*batch))
    out["profile"] = _device_profile(traced_ms, kernels, p50)
    out["profile"]["device_kernels_per_step"] = int(sum(e.count
                                                        for e in kernels))
    del res, tr, batch
    out["forced_overflow"] = _dcgan_forced_overflow(device)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("phase3-dcgan", **{k: v for k, v in out.items()
                           if k not in ("launches", "small")})
    return out


def convergence_check(device, smi: str) -> dict:
    """Phase ``phase3-convergence`` (see the module docstring)."""
    import numpy as np
    import torch
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import imagenet_main as im
    from apex_tpu_torch.examples import imagenet_run_convergence as rc
    from apex_tpu_torch.ops import _dispatch
    from apex_tpu_torch.ops import multi_tensor as mt

    t_phase = time.perf_counter()
    live = torch.cuda.memory_allocated()
    c = CONVERGENCE_CARD
    runs, total = {}, {k: 0 for k in _launch_counts()}
    images, labels = im._to_device(*im.synthetic_batch(
        c["batch_size"], c["image_size"], c["num_classes"], 0), device)
    clock = [time.perf_counter()]

    def on_run(name, res):
        now = time.perf_counter()
        launches = _launch_counts()
        scale = name.split("/")[1]
        _launch_gate(f"convergence {name}", launches,
                     {} if scale == "none" else {mt.MT_SCALE.name: c["steps"]})
        row = dict(losses=res["losses"], wall_s=now - clock[0],
                   step_ms_p50=statistics.median(res["step_ms"]),
                   real_overflows=sum(res["found_inf"]),
                   final_scale=res["final_scale"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches=_nonzero(launches))
        if name in ("O0/none", "O2/dynamic"):
            level = name.split("/")[0]
            policy = get_policy(level, half_dtype=torch.bfloat16,
                                **({} if scale == "none"
                                   else {"loss_scale": scale}))
            scaler = policy.make_scaler()
            state = res["scaler_state"]
            row["profile"] = _profile(
                lambda: im.train_step(res["net"], res["optimizer"], images,
                                      labels, policy, scaler, state),
                row["step_ms_p50"])
        runs[name] = row
        for k, n in launches.items():
            total[k] += n
        _dispatch.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        clock[0] = time.perf_counter()

    _dispatch.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    results, failures = rc.run_cross_product(
        **c, verbose=False, device=device, on_run=on_run)
    baseline = np.array(results["O0/none"])
    for name, row in runs.items():
        trace = np.array(row["losses"])
        skips = rc.count_scaler_skips(row["losses"])
        ref = baseline[:len(baseline) - skips]
        # the harness's allclose as a ratio: 1 at its limit
        ratio = np.abs(trace[skips:] - ref) / (c["atol"] + c["rtol"]
                                               * np.abs(ref))
        row.update(skips=skips,
                   max_abs_diff_from_o0=float(np.abs(trace - baseline).max()),
                   worst_tol_ratio=float(ratio.max()),
                   status="DIVERGED" if name in failures else "OK")
    out = dict(nvidia_smi=smi, config=c, runs=runs, failures=failures,
               launches=total, live_at_start_bytes=live,
               phase_s=time.perf_counter() - t_phase)
    log("phase3-convergence", **{k: v for k, v in out.items()
                                 if k != "launches"})
    del images, labels
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"convergence: combinations diverged from O0: "
                             f"{failures}")
    return out


def convergence_determinism(device, smi: str) -> dict:
    """Whether cuDNN's algorithms are why the cross product's fp32 runs
    do not repeat: at ``CONVERGENCE_CARD``, O0 twice, O1 unscaled and O1
    at scale 1.0 (an exact unscale), first with cuDNN's defaults as the
    phase runs them, then with its deterministic algorithms
    (``cudnn.deterministic``, no ``benchmark``); each pair's largest loss
    difference and whether its traces are equal bit for bit.  Not part of
    the whole run: ``--only convergence_determinism``."""
    import torch
    from apex_tpu_torch.examples import imagenet_main as im

    c = CONVERGENCE_CARD
    common = dict(arch=c["arch"], steps=c["steps"], image_size=c["image_size"],
                  batch_size=c["batch_size"], num_classes=c["num_classes"],
                  half=c["half"], lr=c["lr"], verbose=False, device=device,
                  distributed=False)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    out = dict(nvidia_smi=smi, config=c)
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = False
        runs = {name: [float(x) for x in im.run_training(
                    opt_level=level, loss_scale=scale, **common)["losses"]]
                for name, level, scale in (("O0", "O0", None),
                                           ("O0 again", "O0", None),
                                           ("O1/none", "O1", None),
                                           ("O1/1.0", "O1", 1.0))}

        def diff(a, b):
            return max(abs(x - y) for x, y in zip(runs[a], runs[b]))

        out["deterministic" if det else "cudnn_defaults"] = row = dict(
            losses=runs, o0_repeat_max_diff=diff("O0", "O0 again"),
            o0_repeats_bitwise=runs["O0"] == runs["O0 again"],
            o1_none_vs_1_max_diff=diff("O1/none", "O1/1.0"),
            o1_none_equals_1_bitwise=runs["O1/none"] == runs["O1/1.0"])
        log("convergence-determinism", deterministic=det,
            **{k: v for k, v in row.items() if k != "losses"})
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return out


ALONE = {
    "layer_norm": lambda device, smi: dict(
        main_path_max_abs_err=check_layer_norm(device),
        rows=time_layer_norm(device)),
    "moe_reference": lambda device, smi: small_moe_check(device),
    "ring_reference": lambda device, smi: small_ring_check(device),
    "moe": lambda device, smi: moe_train(device, smi),
    "cp": lambda device, smi: cp_train(device, smi),
    "halo": lambda device, smi: halo_check(device, smi),
    "llama_train": lambda device, smi: llama_1b_train(device),
    "gpt_flagship": lambda device, smi: gpt2_large_train(device, "flagship"),
    "bert": lambda device, smi: bert_large_train(device, smi),
    "vit": lambda device, smi: vit_l16_train(device, smi),
    "gpt_1p3b": lambda device, smi: gpt13b_train(device, smi),
    "megatron_gpt": lambda device, smi: megatron_gpt_train(device, smi),
    "amp_o1": amp_o1_check,
    "supervised": supervised_train,
    "contrib_attention": contrib_attention,
    "contrib_losses": contrib_losses,
    "contrib_norms": contrib_norms,
    "sparsity": sparsity_check,
    "rnn": rnn_train,
    "dcgan": dcgan_train,
    "convergence": convergence_check,
    "convergence_determinism": convergence_determinism,
    "mt_lists": lambda device, smi: check_multi_tensor_model_lists(device),
}


def run_alone(names, device, smi) -> int:
    """The ``ALONE`` phases ``names``, each's wall beside it, their results
    in ``build/chip_smoke_only.json``; no kernels line and no result
    line (the whole run alone gives those)."""
    results = []
    for name in names:
        t0 = time.perf_counter()
        res = ALONE[name](device, smi)
        results.append(dict(phase=name, s=time.perf_counter() - t0,
                            result=res))
        log("only", name=name, s=results[-1]["s"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_only.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, phases=results), f, indent=1,
                  default=str)
    return 0


def main(argv=()) -> int:
    import torch

    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or not all(
                n in ALONE for n in argv[1].split(",")):
            print(f"usage: chip_smoke.py [--only NAME[,NAME...]] with NAME "
                  f"one of {', '.join(ALONE)}", file=sys.stderr)
            return 2
        only = argv[1].split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from apex_tpu_torch.ops import _build, _dispatch
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fused_lm_head as lh
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.ops import packed_update as pu
    from apex_tpu_torch.ops import pair_bias_attention as pb
    from apex_tpu_torch.ops import softmax as sm

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    ptxas = start_ptxas()
    libs = _build.build_all(sorted({k.source for k in _dispatch.KERNELS}))
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase1", device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        built=[os.path.relpath(p, ROOT) for p in libs], build_s=build_s,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    if only:
        return run_alone(only, device, smi)

    max_err = check_layer_norm(device)
    timings = time_layer_norm(device)
    flash_check = check_flash_attention(device)
    head_check = check_lm_head(device)
    flash_time = time_flash_attention(device)
    head_time = time_lm_head(device)
    norm_bwd_check = check_layer_norm_bwd(device)
    flash_bwd_check = check_flash_attention_bwd(device)
    head_bwd_check = check_lm_head_bwd(device)
    norm_bwd_time = time_layer_norm_bwd(device)
    flash_bwd_time = time_flash_attention_bwd(device)
    wgmma_regs = wgmma_registers(ptxas)
    head_bwd_time = time_lm_head_bwd(device)
    softmax_check = check_softmax(device)
    lamb_check = check_lamb_phase1(device)
    softmax_time = time_softmax(device)
    lamb_time = time_lamb_phase1(device)
    packed_check = check_packed_updates(device)
    packed_time = time_packed_updates(device)
    mt_check = check_multi_tensor(device)
    mt_time = time_multi_tensor(device)
    mt_model_check = check_multi_tensor_model_lists(device)
    pair_bias_check = check_pair_bias(device)
    pair_bias_time = time_pair_bias(device)
    routes_time = time_openfold_routes(device)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    reference = small_reference_check(device)
    forms_reference = small_serving_forms_check(device)
    eval_reference = small_eval_check(device)
    train_reference = small_train_check(device)
    gpt_reference = small_gpt_check(device)
    bert_reference = small_bert_check(device)
    vit_reference = small_vit_check(device)
    moe_reference = small_moe_check(device)
    ring_reference = small_ring_check(device)
    openfold_reference = small_openfold_check(device)
    amp_reference = small_amp_check(device)
    optimizer_reference = small_optimizer_checks(device)
    model, init_s = build_llama_1b(device)
    dense_ref = {}
    e2e = llama_1b(device, model, init_s, keep=dense_ref)
    evaluation = llama_1b_eval(device, model)
    from apex_tpu_torch import serving as sv
    probe = max(serving_requests(model.config.vocab_size),
                key=lambda r: len(r.prompt))
    qmodel, int8_ref = int8_reference(
        model, probe, sv, device, slots=8, max_len=2048, prefill_len=512)
    serving_tp = tp_checks(model, qmodel, dense_ref, int8_ref, probe, sv,
                           device, smi, slots=8, max_len=2048,
                           prefill_len=512)
    dense_ref.clear()
    del model
    torch.cuda.empty_cache()
    int8 = llama_1b_int8(device, qmodel, int8_ref)
    del qmodel
    torch.cuda.empty_cache()
    train_ref = {}
    training = llama_1b_train(device, keep=train_ref)
    training_tp = llama_1b_train_tp(device, train_ref, smi)
    training_pp = llama_1b_train_pp(device, train_ref, smi)
    train_ref.clear()
    torch.cuda.empty_cache()
    training_zero = llama_1b_train_zero(device, smi)
    resnet_reference = resnet_small_check(device)
    resnet = resnet50_train(device, smi)
    larc = larc_check(device)
    amp_paths = {f"amp_{form}": llama_1b_amp_train(device, form)
                 for form in ("adam", "adagrad", "packed_adam")}
    gpt_kernel = gpt2_large_train(device, "kernel")
    gpt_flagship = gpt2_large_train(device, "flagship")
    bert = bert_large_train(device, smi)
    vit = vit_l16_train(device, smi)
    gpt13 = gpt13b_train(device, smi)
    llama_remat = llama_remat_check(device, smi)
    dropout = dropout_check(device, smi)
    moe = moe_train(device, smi)
    cp = cp_train(device, smi)
    halo = halo_check(device, smi)
    megatron = megatron_gpt_train(device, smi)
    amp_o1 = amp_o1_check(device, smi)
    supervised = supervised_train(device, smi)
    contrib_attn = contrib_attention(device, smi)
    contrib_loss = contrib_losses(device, smi)
    contrib_norm = contrib_norms(device, smi)
    sparsity = sparsity_check(device, smi)
    rnn = rnn_train(device, smi)
    dcgan = dcgan_train(device, smi)
    convergence = convergence_check(device, smi)
    openfold = openfold_train(device)
    paths = dict(serving=e2e, serving_paged=e2e["paged"]["default_pool"],
                 serving_paged_tight=e2e["paged"]["tight_pool"],
                 serving_prefix_paged=e2e["prefix_paged"]["with_prefix"],
                 serving_prefix_dense=e2e["prefix_dense"]["with_prefix"],
                 **{f"serving_spec_{f}_{n}": e2e[f"spec_{f}"][n]["speculative"]
                    for f in ("dense", "paged") for n in ("quoted", "random")},
                 **{f"serving_control_{f}_{n}": e2e["control"][f][n]
                    for f in ("dense", "paged") for n in ("fifo", "policy")},
                 **{f"serving_export_{n}": e2e["export"][n]
                    for n in ("capture", "requeue")},
                 serving_obs_inert=e2e["obs"]["inert"],
                 **{f"serving_obs_chaos_{n}": e2e["obs"]["chaos"][n]["summary"]
                    for n in ("fifo", "policy")},
                 serving_obs_real_clock=e2e["obs"]["real_clock"],
                 serving_reload=e2e["reload"],
                 serving_shadow=e2e["shadow"], serving_fleet=e2e["fleet"],
                 serving_rollout=e2e["rollout"],
                 serving_int8=int8, evaluation=evaluation, training=training,
                 training_tp=training_tp, training_tp_amp=training_tp["amp"],
                 training_pp_1f1b=dict(launches=training_pp["launches"][
                     "1f1b"]),
                 training_pp_no_pipelining=dict(launches=training_pp[
                     "launches"]["no_pipelining"]),
                 training_zero=training_zero,
                 resnet50_bf16=resnet["bf16"], resnet50_fp16=resnet["fp16"],
                 larc=larc,
                 **amp_paths, gpt_kernel_path=gpt_kernel,
                 gpt_flagship=gpt_flagship, bert_large=bert, vit_l16=vit,
                 gpt_1p3b_remat=gpt13["remat"], gpt_1p3b_plain=gpt13["plain"],
                 moe=moe, cp=cp, halo=halo, megatron_gpt=megatron,
                 supervised=supervised,
                 contrib_self_attn=contrib_attn["self"],
                 contrib_encdec_attn=contrib_attn["encdec"],
                 contrib_mask_softmax_binary=contrib_attn["mask_softmax"][
                     "binary"],
                 contrib_mask_softmax_additive=contrib_attn["mask_softmax"][
                     "additive"],
                 contrib_fmha_varlen=contrib_attn["fmha"],
                 contrib_norms=contrib_norm, rnn=rnn, dcgan=dcgan,
                 convergence=convergence, openfold=openfold)

    def entry(k, err, row, main_path="training", **extra):
        return dict(name=k.name, route="cuda",
                    source=f"apex_tpu_torch/csrc/{k.source}",
                    replaces=k.replaces.split()[0],
                    launches=paths[main_path]["launches"][k.name],
                    max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row["library_ms"], main_path=main_path,
                    launches_by_path={p: r["launches"][k.name]
                                      for p, r in paths.items()}, **extra)

    def contrib_row(row):
        """A kernel's row at a contrib shape, with the launches a call."""
        return {f: row[f] for f in ("shape", "ms", "bound_ms", "bound_by",
                                    "plain_ms", "library_ms", "library_call")}

    def mt_entry(k, key, main_path, others=(), checked=()):
        row = mt_time[key]
        return entry(k, row["max_abs_err"], row, main_path=main_path,
                     checked_lists={o: mt_model_check[o] for o in checked},
                     list=row["list"], tensors=row["tensors"],
                     elements=row["elements"],
                     graph_plain_ms=row["graph_plain_ms"],
                     library_call=row["library_call"],
                     cases=mt_check[k.name]["cases"],
                     worst_tol_ratio=mt_check[k.name]["worst_tol_ratio"],
                     lists={o: {f: mt_time[o][f] for f in (
                         "list", "ms", "bound_ms", "plain_ms", "graph_plain_ms",
                         "library_ms", "library_call", "max_abs_err")}
                            for o in others})

    decode_row = next(r for r in timings if r["n"] == 8)
    nb, fb, hb = (norm_bwd_check["main_shape"], flash_bwd_check["main_shape"],
                  head_bwd_check["main_shape"])
    pbm = pair_bias_check["main_shape"]
    kernels = {"kernels": [
        entry(ln.LAYER_NORM_FWD, max_err, decode_row, shapes=timings,
              timed_shape="n = 8 (a decode step); n = 512, 8192 in shapes"),
        entry(ln.LAYER_NORM_BWD, max(nb["dx_max_abs_err"], nb["dw_max_abs_err"]),
              norm_bwd_time, shape=norm_bwd_time["shape"],
              shapes=[{k: r[k] for k in ("path", "shape", "ms", "bound_ms", "plain_ms",
                                         "library_ms", "launches_per_step")}
                      for r in norm_bwd_time["shapes"]]),
        entry(fa.FLASH_ATTENTION_FWD, flash_check["main_shape"]["o_max_abs_err"],
              flash_time, shape=flash_time["shape"], tflops=flash_time["tflops"],
              gpt2_large={k: flash_time["gpt2_large"][k] for k in (
                  "ms", "tflops", "bound_ms", "library_ms", "library_tflops")},
              contrib_bert_padded=dict(
                  contrib_row(contrib_attn["flash_rows"]["fwd"]),
                  launches_per_call=1),
              fmha_varlen={k: contrib_attn["fmha"][k] for k in (
                  "total", "device_ms", "work_ratio", "packed_fwd_bound_ms",
                  "packed_bwd_bound_ms", "plain_tol_ratios")}),
        entry(fa.FLASH_ATTENTION_DQ, fb["dq_max_abs_err"], flash_bwd_time["dq"],
              shape=flash_bwd_time["dq"]["shape"],
              tflops=flash_bwd_time["dq"]["tflops"],
              contrib_bert_padded=dict(
                  contrib_row(contrib_attn["flash_rows"]["dq"]),
                  launches_per_call=1)),
        entry(fa.FLASH_ATTENTION_DKV, max(fb["dk_max_abs_err"], fb["dv_max_abs_err"]),
              flash_bwd_time["dkv"], shape=flash_bwd_time["dkv"]["shape"],
              tflops=flash_bwd_time["dkv"]["tflops"],
              contrib_bert_padded=dict(
                  contrib_row(contrib_attn["flash_rows"]["dkv"]),
                  launches_per_call=1)),
        entry(lh.FUSED_LM_HEAD_FWD, head_check["main_shape"]["loss_max_abs_err"],
              head_time, shape=head_time["shape"], tflops=head_time["tflops"],
              cublas_matmul_ms=head_time["cublas_matmul_ms"],
              gpt2_large={k: head_time["gpt2_large"][k] for k in (
                  "ms", "tflops", "bound_ms", "library_ms", "library_tflops",
                  "cublas_matmul_ms")}),
        entry(lh.FUSED_LM_HEAD_DH, hb["dh_max_abs_err"], head_bwd_time["dh"],
              shape=head_bwd_time["dh"]["shape"],
              **{k: head_bwd_time["dh"][k] for k in (
                  "split_ms", "tflops", "cublas_matmul_ms")}),
        entry(lh.FUSED_LM_HEAD_DE, hb["de_max_abs_err"], head_bwd_time["de"],
              shape=head_bwd_time["de"]["shape"],
              **{k: head_bwd_time["de"][k] for k in ("tflops", "cublas_matmul_ms")}),
        entry(sm.SCALED_SOFTMAX_FWD, softmax_check["main_shape"]["y_max_abs_err"],
              softmax_time["fwd"], main_path="gpt_kernel_path",
              shape=softmax_time["fwd"]["shape"],
              contrib_mask_softmax=dict(
                  contrib_row(contrib_attn["mask_softmax"]["rows"]["fwd"]),
                  launches_per_call=1)),
        entry(sm.SCALED_SOFTMAX_BWD, softmax_check["main_shape"]["dx_max_abs_err"],
              softmax_time["bwd"], main_path="gpt_kernel_path",
              shape=softmax_time["bwd"]["shape"],
              contrib_mask_softmax=dict(
                  contrib_row(contrib_attn["mask_softmax"]["rows"]["bwd"]),
                  launches_per_call=1)),
        entry(pu.LAMB_PHASE1, max(lamb_check["main_shape"][k] for k in (
            "m_max_abs_err", "v_max_abs_err", "u_max_abs_err")),
              lamb_time, main_path="gpt_kernel_path", shape=lamb_time["shape"]),
        entry(pu.PACKED_ADAM, max(v for k, v in packed_check["adam"][
            "main_shape"].items() if k.endswith("_max_abs_err")),
              packed_time["adam"], main_path="amp_packed_adam",
              shape=packed_time["adam"]["shape"],
              library_call=packed_time["adam"]["library_call"]),
        entry(pu.PACKED_ADAGRAD, max(v for k, v in packed_check["adagrad"][
            "main_shape"].items() if k.endswith("_max_abs_err")),
              packed_time["adagrad"], main_path="amp_adagrad",
              shape=packed_time["adagrad"]["shape"],
              library_call=packed_time["adagrad"]["library_call"]),
        entry(pb.PAIR_BIAS_FWD, pbm["o_max_abs_err"], pair_bias_time["fwd"],
              main_path="openfold", shape=pair_bias_time["fwd"]["shape"],
              bound_term=pair_bias_time["fwd"]["bound_term"]),
        entry(pb.PAIR_BIAS_DQ, pbm["dq_max_abs_err"], pair_bias_time["dq"],
              main_path="openfold", shape=pair_bias_time["dq"]["shape"],
              bound_term=pair_bias_time["dq"]["bound_term"]),
        entry(pb.PAIR_BIAS_DKV, max(pbm["dk_max_abs_err"], pbm["dv_max_abs_err"]),
              pair_bias_time["dkv"], main_path="openfold",
              shape=pair_bias_time["dkv"]["shape"],
              bound_term=pair_bias_time["dkv"]["bound_term"]),
        entry(pb.PAIR_BIAS_DBIAS, pbm["dbias_max_abs_err"],
              pair_bias_time["dbias"], main_path="openfold",
              shape=pair_bias_time["dbias"]["shape"],
              bound_term=pair_bias_time["dbias"]["bound_term"]),
        # the multi-tensor kernels, with no pallas_call counterpart: each
        # timed at its main path's list, the others in lists
        mt_entry(mt.MT_L2NORM, "l2norm_gpt2_large", "gpt_flagship"),
        mt_entry(mt.MT_SCALE, "scale_llama_fp16_check", "amp_adam",
                 checked=tuple(f"{n}_overflow_check" for n in (
                     "dcgan64_d", "dcgan64_g", "resnet50_o1", "resnet50_o2",
                     "resnet50_o3"))),
        mt_entry(mt.MT_ADAM, "adam_llama_bf16", "training",
                 ("adam_llama_fp16_masters", "adam_swa_openfold"),
                 checked=("vit_l16", "mlstm_4096", "dcgan64_d", "dcgan64_g")),
        mt_entry(mt.MT_LAMB, "lamb_gpt2_large", "gpt_flagship",
                 checked=("bert_large", "gpt_1p3b", "gpt2_medium_moe8")),
    ]}
    if [k["name"] for k in kernels["kernels"]] != [k.name for k in _dispatch.KERNELS]:
        raise AssertionError("the kernels line does not list every kernel")
    report = dict(nvidia_smi=smi, clocks_after_timing=clocks, build_s=build_s,
                  kernel_checks=[flash_check, head_check, norm_bwd_check,
                                 flash_bwd_check, head_bwd_check,
                                 softmax_check, lamb_check, packed_check,
                                 pair_bias_check, mt_check, mt_model_check],
                  kernel_times=[flash_time, head_time, norm_bwd_time,
                                flash_bwd_time, head_bwd_time, softmax_time,
                                lamb_time, packed_time, pair_bias_time,
                                mt_time],
                  wgmma_registers=wgmma_regs,
                  openfold_routes=routes_time,
                  openfold_reference=openfold_reference,
                  amp_reference=amp_reference,
                  optimizer_reference=optimizer_reference,
                  reference=reference, forms_reference=forms_reference,
                  llama_1b_int8=int8, eval_reference=eval_reference,
                  train_reference=train_reference, gpt_reference=gpt_reference,
                  llama_1b=e2e, evaluation=evaluation, training=training,
                  serving_tp=serving_tp, training_tp=training_tp,
                  training_pp=training_pp, training_zero=training_zero,
                  resnet_reference=resnet_reference, resnet50=resnet,
                  larc=larc,
                  **{f"llama_1b_{k}": v for k, v in amp_paths.items()},
                  gpt2_large_kernel_path=gpt_kernel,
                  gpt2_large_flagship=gpt_flagship, openfold=openfold,
                  bert_reference=bert_reference, vit_reference=vit_reference,
                  bert_large=bert, vit_l16=vit, gpt_1p3b=gpt13,
                  llama_remat=llama_remat, dropout=dropout,
                  moe_reference=moe_reference, ring_reference=ring_reference,
                  moe=moe, cp=cp, halo=halo, megatron_gpt=megatron,
                  amp_o1=amp_o1, supervised=supervised,
                  contrib_attention=contrib_attn, contrib_losses=contrib_loss,
                  contrib_norms=contrib_norm, sparsity=sparsity,
                  rnn=rnn, dcgan=dcgan, convergence=convergence,
                  kernels=kernels,
                  total_s=time.perf_counter() - t_start)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
