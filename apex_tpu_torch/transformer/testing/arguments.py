"""Megatron-style argument parsing for the testing models (counterpart of
``apex_tpu/transformer/testing/arguments.py``, apex's
``transformer/testing/arguments.py``).

The argparse groups (network size, regularization, training,
initialization, learning rate, checkpointing, mixed precision,
distributed, validation, data, logging) and the pass after them: tp and
pp clamped to the world size, dp derived, the batch arithmetic checked,
the dtype picked from ``--fp16`` / ``--bf16`` — the JAX module's flags,
derivations and errors.  ``params_dtype`` is a ``torch.dtype``.  The
rank and world size are ``torch.distributed``'s when its process group
is up, else ``RANK`` / ``WORLD_SIZE`` from the environment (``0`` and
``1`` unset), as the JAX module reads them.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

__all__ = ["parse_args", "core_transformer_config_from_args"]


def parse_args(extra_args_provider=None, defaults=None, override_args=None,
               ignore_unknown_args=False, args_list=None):
    """Build the parser, parse ``args_list`` (``sys.argv`` when None),
    derive and validate; returns the namespace.  ``defaults`` fill flags
    left None, ``override_args`` replace parsed values before the
    derivations."""
    parser = argparse.ArgumentParser(description="apex_tpu_torch transformer args",
                                     allow_abbrev=False)
    for add in (_add_network_size_args, _add_regularization_args,
                _add_training_args, _add_initialization_args,
                _add_learning_rate_args, _add_checkpointing_args,
                _add_mixed_precision_args, _add_distributed_args,
                _add_validation_args, _add_data_args, _add_logging_args):
        parser = add(parser)
    if extra_args_provider is not None:
        parser = extra_args_provider(parser)

    if ignore_unknown_args:
        args, _ = parser.parse_known_args(args_list)
    else:
        args = parser.parse_args(args_list)

    if dist.is_available() and dist.is_initialized():
        args.rank, args.world_size = dist.get_rank(), dist.get_world_size()
    else:
        args.rank = int(os.getenv("RANK", "0"))
        args.world_size = int(os.getenv("WORLD_SIZE", "1"))
    for key, value in (override_args or {}).items():
        setattr(args, key, value)
    for key, value in (defaults or {}).items():
        if getattr(args, key, None) is None:
            setattr(args, key, value)

    # --- parallel-geometry derivations (arguments.py:66-99) ---------------
    args.tensor_model_parallel_size = min(args.tensor_model_parallel_size,
                                          args.world_size)
    if args.world_size % args.tensor_model_parallel_size:
        raise ValueError(
            f"world size ({args.world_size}) is not divisible by tensor "
            f"model parallel size ({args.tensor_model_parallel_size})")
    args.pipeline_model_parallel_size = min(
        args.pipeline_model_parallel_size,
        args.world_size // args.tensor_model_parallel_size)
    mp = args.tensor_model_parallel_size * args.pipeline_model_parallel_size
    if args.world_size % mp:
        raise ValueError(
            f"world size ({args.world_size}) is not divisible by tp*pp "
            f"({mp})")
    args.data_parallel_size = args.world_size // mp
    # interleaved-schedule geometry (Megatron arguments.py:101-113)
    args.virtual_pipeline_model_parallel_size = None
    if args.num_layers_per_virtual_pipeline_stage is not None:
        if args.num_layers is None:
            raise ValueError(
                "--num-layers-per-virtual-pipeline-stage needs --num-layers")
        per_pipeline = args.num_layers // args.pipeline_model_parallel_size
        if per_pipeline % args.num_layers_per_virtual_pipeline_stage:
            raise ValueError(
                f"layers per pipeline stage ({per_pipeline}) must divide by "
                "--num-layers-per-virtual-pipeline-stage "
                f"({args.num_layers_per_virtual_pipeline_stage})")
        args.virtual_pipeline_model_parallel_size = (
            per_pipeline // args.num_layers_per_virtual_pipeline_stage)

    # --- batch arithmetic (arguments.py:130-160) --------------------------
    if args.micro_batch_size is None:
        args.micro_batch_size = 1
    if args.global_batch_size is None:
        args.global_batch_size = args.micro_batch_size * args.data_parallel_size
    per_step = args.micro_batch_size * args.data_parallel_size
    if args.global_batch_size % per_step:
        raise ValueError(
            f"global batch size ({args.global_batch_size}) must be a "
            f"multiple of micro_batch_size*dp ({per_step})")

    # --- dtype policy (arguments.py:162-180) ------------------------------
    if args.fp16 and args.bf16:
        raise ValueError("--fp16 and --bf16 are mutually exclusive")
    args.params_dtype = torch.float32
    if args.fp16:
        args.params_dtype = torch.float16
    if args.bf16:
        args.params_dtype = torch.bfloat16
    if args.loss_scale is None and args.fp16:
        args.loss_scale = "dynamic"

    # --- network derivations (arguments.py:190-240) -----------------------
    for required in ("num_layers", "hidden_size", "num_attention_heads"):
        if getattr(args, required) is None:
            raise ValueError(
                f"--{required.replace('_', '-')} is required")
    if args.ffn_hidden_size is None:
        args.ffn_hidden_size = 4 * args.hidden_size
    if args.kv_channels is None:
        if args.hidden_size % args.num_attention_heads:
            raise ValueError("hidden size must divide by attention heads")
        args.kv_channels = args.hidden_size // args.num_attention_heads
    if args.seq_length is not None and args.max_position_embeddings is not None:
        if args.max_position_embeddings < args.seq_length:
            raise ValueError("max_position_embeddings must cover seq_length")
    if args.checkpoint_activations:
        args.recompute_granularity = "full"

    if args.rank == 0:
        print(f"using world size: {args.world_size}, "
              f"data-parallel-size: {args.data_parallel_size}, "
              f"tensor-model-parallel size: {args.tensor_model_parallel_size}, "
              f"pipeline-model-parallel size: "
              f"{args.pipeline_model_parallel_size}", flush=True)
    return args


def core_transformer_config_from_args(args) -> dict:
    """The kwargs the testing models consume, from parsed args."""
    return dict(
        num_layers=args.num_layers,
        hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        vocab_size=args.padded_vocab_size or args.vocab_size or 0,
        max_sequence_length=args.seq_length or args.max_position_embeddings,
        params_dtype=args.params_dtype,
    )


def _add_network_size_args(parser):
    g = parser.add_argument_group(title="network size")
    g.add_argument("--num-layers", type=int, default=None)
    g.add_argument("--hidden-size", type=int, default=None)
    g.add_argument("--ffn-hidden-size", type=int, default=None)
    g.add_argument("--num-attention-heads", type=int, default=None)
    g.add_argument("--kv-channels", type=int, default=None)
    g.add_argument("--max-position-embeddings", type=int, default=None)
    g.add_argument("--vocab-size", type=int, default=None)
    g.add_argument("--padded-vocab-size", type=int, default=None)
    g.add_argument("--make-vocab-size-divisible-by", type=int, default=128)
    g.add_argument("--layernorm-epsilon", type=float, default=1e-5)
    g.add_argument("--apply-residual-connection-post-layernorm",
                   action="store_true")
    g.add_argument("--openai-gelu", action="store_true")
    g.add_argument("--onnx-safe", action="store_true")
    return parser


def _add_regularization_args(parser):
    g = parser.add_argument_group(title="regularization")
    g.add_argument("--attention-dropout", type=float, default=0.1)
    g.add_argument("--hidden-dropout", type=float, default=0.1)
    g.add_argument("--weight-decay", type=float, default=0.01)
    g.add_argument("--clip-grad", type=float, default=1.0)
    g.add_argument("--adam-beta1", type=float, default=0.9)
    g.add_argument("--adam-beta2", type=float, default=0.999)
    g.add_argument("--adam-eps", type=float, default=1e-8)
    g.add_argument("--sgd-momentum", type=float, default=0.9)
    return parser


def _add_training_args(parser):
    g = parser.add_argument_group(title="training")
    g.add_argument("--micro-batch-size", type=int, default=None)
    g.add_argument("--global-batch-size", type=int, default=None)
    g.add_argument("--rampup-batch-size", nargs="*", default=None)
    g.add_argument("--train-iters", type=int, default=None)
    g.add_argument("--train-samples", type=int, default=None)
    g.add_argument("--log-interval", type=int, default=100)
    g.add_argument("--exit-interval", type=int, default=None)
    g.add_argument("--checkpoint-activations", action="store_true")
    g.add_argument("--recompute-granularity", type=str, default=None,
                   choices=["full", "selective", None])
    g.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "sgd", "lamb", "novograd", "adagrad"])
    g.add_argument("--use-cpu-initialization", action="store_true")
    return parser


def _add_initialization_args(parser):
    g = parser.add_argument_group(title="initialization")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--init-method-std", type=float, default=0.02)
    return parser


def _add_learning_rate_args(parser):
    g = parser.add_argument_group(title="learning rate")
    g.add_argument("--lr", type=float, default=None)
    g.add_argument("--lr-decay-style", type=str, default="linear",
                   choices=["constant", "linear", "cosine"])
    g.add_argument("--lr-decay-iters", type=int, default=None)
    g.add_argument("--lr-decay-samples", type=int, default=None)
    g.add_argument("--lr-warmup-fraction", type=float, default=None)
    g.add_argument("--lr-warmup-iters", type=int, default=0)
    g.add_argument("--min-lr", type=float, default=0.0)
    return parser


def _add_checkpointing_args(parser):
    g = parser.add_argument_group(title="checkpointing")
    g.add_argument("--save", type=str, default=None)
    g.add_argument("--save-interval", type=int, default=None)
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--no-load-optim", action="store_true")
    g.add_argument("--no-load-rng", action="store_true")
    g.add_argument("--no-save-optim", action="store_true")
    g.add_argument("--no-save-rng", action="store_true")
    return parser


def _add_mixed_precision_args(parser):
    g = parser.add_argument_group(title="mixed precision")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--loss-scale", type=float, default=None)
    g.add_argument("--initial-loss-scale", type=float, default=2 ** 32)
    g.add_argument("--min-loss-scale", type=float, default=1.0)
    g.add_argument("--loss-scale-window", type=float, default=1000)
    g.add_argument("--hysteresis", type=int, default=2)
    g.add_argument("--accumulate-allreduce-grads-in-fp32",
                   action="store_true")
    return parser


def _add_distributed_args(parser):
    g = parser.add_argument_group(title="distributed")
    g.add_argument("--tensor-model-parallel-size", type=int, default=1)
    g.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    g.add_argument("--pipeline-model-parallel-split-rank", type=int,
                   default=None)
    g.add_argument("--num-layers-per-virtual-pipeline-stage", type=int,
                   default=None)
    g.add_argument("--sequence-parallel", action="store_true")
    g.add_argument("--use-distributed-optimizer", action="store_true")
    g.add_argument("--local_rank", type=int, default=None)
    return parser


def _add_validation_args(parser):
    g = parser.add_argument_group(title="validation")
    g.add_argument("--eval-iters", type=int, default=100)
    g.add_argument("--eval-interval", type=int, default=1000)
    return parser


def _add_data_args(parser):
    g = parser.add_argument_group(title="data and dataloader")
    g.add_argument("--data-path", nargs="*", default=None)
    g.add_argument("--split", type=str, default="969, 30, 1")
    g.add_argument("--seq-length", type=int, default=None)
    g.add_argument("--encoder-seq-length", type=int, default=None)
    g.add_argument("--decoder-seq-length", type=int, default=None)
    g.add_argument("--num-workers", type=int, default=2)
    g.add_argument("--reset-position-ids", action="store_true")
    g.add_argument("--reset-attention-mask", action="store_true")
    g.add_argument("--eod-mask-loss", action="store_true")
    return parser


def _add_logging_args(parser):
    g = parser.add_argument_group(title="logging")
    g.add_argument("--log-params-norm", action="store_true")
    g.add_argument("--log-num-zeros-in-grad", action="store_true")
    g.add_argument("--tensorboard-dir", type=str, default=None)
    g.add_argument("--log-timers-to-tensorboard", action="store_true")
    g.add_argument("--timing-log-level", type=int, default=0,
                   choices=range(0, 3))
    return parser
