"""Carry Llama, GPT, BERT, ViT and ResNet weights over from a flax
parameter tree.

:func:`llama_params_from_jax` and :func:`gpt_params_from_jax` take the JAX
model's parameter tree as a nested dict of **numpy arrays**
(``jax.tree.map(np.asarray, params)`` on the JAX side; this module never
sees JAX) and return a ``state_dict`` for
:class:`~apex_tpu_torch.models.llama.LlamaForCausalLM` or
:class:`~apex_tpu_torch.transformer.testing.GPTModel`.  Every transpose is
written out.  Llama:

==========================================  ==========================================
flax leaf                                   torch key
==========================================  ==========================================
``embed_tokens/embedding`` ``[vocab, h]``   ``embed_tokens.weight`` ``[vocab, h]``
``layers_i/.../<proj>/kernel`` ``[in, out]``  ``layers.i.....<proj>.weight`` ``[out, in]``
``layers_i/<norm>/scale`` ``[h]``           ``layers.i.<norm>.scale`` ``[h]``
``norm/scale`` ``[h]``                      ``norm.scale`` ``[h]``
``lm_head`` ``[vocab, h]``                  ``lm_head`` ``[vocab, h]``
==========================================  ==========================================

GPT (``lm`` the flax ``language_model``, ``t.`` the torch
``language_model.transformer.``; the QKV columns keep their order, each
head's q, k and v adjacent, as the JAX model splits them):

==================================================  ==========================================
flax leaf                                           torch key
==================================================  ==========================================
``lm/embedding/word_embeddings/embedding`` [V, h]   ``language_model.embedding.word_embeddings.weight``
``lm/embedding/position_embeddings`` [s, h]         ``language_model.embedding.position_embeddings``
``lm/transformer/layer_i/.../kernel`` [in, out]     ``t.layers.i.....weight`` [out, in]
``lm/transformer/layer_i/.../bias``                 ``t.layers.i.....bias``
``lm/transformer/layer_i/<norm>/{scale,bias}``      ``t.layers.i.<norm>.{scale,bias}``
``lm/transformer/final_layernorm/{scale,bias}``     ``t.final_layernorm.{scale,bias}``
==================================================  ==========================================

Each raises on a leaf it does not consume and on a leaf it expects but
does not find.  With ``tp_size > 1`` each returns rank ``tp_rank``'s
slice, for the model that rank builds in its tensor-parallel region:
column weights (and their biases) split on ``[out]``, row weights on
``[in]`` (their biases whole), the vocab-parallel embedding (and the
Llama head) on its rows; everything else whole.

A leaf may be a JAX ``QTensor`` (``apex_tpu.serving.quant``: an int8
payload ``q``, fp32 ``scale`` per output channel, its reduced ``axis``),
as ``quantize_params`` leaves the projections and the LM head of a
quantized serving tree.  It becomes the two buffers of the port's
:class:`~apex_tpu_torch.serving.quant.QTensor` under the weight's key,
``<key>.q`` (the payload, transposed as the weight is) and
``<key>.scale`` (the same scales): a ``state_dict`` for the quantized
model ``quantize_params(LlamaForCausalLM(config))``, so a checkpoint
quantized in JAX serves in the port.  The leaf is recognised by its
fields; this module imports nothing of JAX.

A pipeline stage (:mod:`apex_tpu_torch.models.llama_pipeline`):
:func:`llama_pipeline_params_from_jax` takes one (pp, tp) rank's JAX tree
``{"embed", "block", "head"}`` (already that rank's tp shard) and fills
that rank's stage: ``block/layers_i/...`` as ``stage.layers.i....`` (the
kernels transposed as above), ``embed/embed_tokens/embedding`` as
``first.embed_tokens.weight`` on the first stage, ``head/norm/scale`` and
``head/lm_head`` as ``last.norm.scale`` and ``last.lm_head`` on the last
(both ``[vocab / tp, h]``).  The JAX tree holds the embedding and head on
every stage; the other stages leave them.

A GPT pipeline stage (:mod:`apex_tpu_torch.transformer.testing.commons`):
:func:`gpt_pipeline_params_from_jax` takes one (pp, tp) rank's JAX tree
``{"embed", "block", "head"}`` (``init_gpt_pipeline_params`` inside the
JAX driver's ``shard_map``: already that rank's tp shard) and fills that
rank's stage: ``block/layer_i/...`` as ``stage.layers.i....`` (as in the
GPT table), ``embed/word_embeddings/embedding`` and
``embed/position_embeddings`` as ``first.*`` on the first stage,
``head/final_layernorm/{scale,bias}`` as ``last.final_layernorm.*`` on the
last, and there, with pp > 1, the rank's ``embed`` word embeddings again
as the tied copy ``last.word_embeddings.weight``.

ResNet (:func:`resnet_params_from_jax`, the ImageNet example's model in
:mod:`apex_tpu_torch.examples.imagenet_main`; ``B_i`` the flax
``BottleneckBlock_i``, its ``Conv_j`` / ``SyncBatchNorm_j`` the torch
``conv{j+1}`` / ``bn{j+1}`` for j < 3 and ``downsample_conv`` /
``downsample_bn`` for j = 3):

==================================================  ==========================================
flax leaf                                           torch key
==================================================  ==========================================
``Conv_0/kernel`` ``[7, 7, 3, 64]`` (HWIO)          ``conv1.weight`` ``[64, 3, 7, 7]`` (OIHW)
``SyncBatchNorm_0/{scale,bias}``                    ``bn1.{weight,bias}``
batch_stats ``SyncBatchNorm_0/{mean,var}``          ``bn1.{running_mean,running_var}``
``B_i/Conv_j/kernel`` (HWIO)                        ``blocks.i.<conv>.weight`` (OIHW)
``B_i/SyncBatchNorm_j/...``                         ``blocks.i.<bn>....``
``Dense_0/kernel`` ``[in, out]``, ``/bias``         ``fc.weight`` ``[out, in]``, ``fc.bias``
==================================================  ==========================================

Each batch norm's ``num_batches_tracked`` (which flax does not keep) is 0.

BERT (:func:`bert_params_from_jax`): the language model as for GPT, the
heads' ``nn.Dense`` kernels transposed (``lm_head/Dense_0`` ->
``lm_head.dense``, ``pooler/Dense_0`` -> ``pooler.dense``, ``binary_head``)
and ``lm_head/layernorm``.  ViT (:func:`vit_params_from_jax`): the
top-level leaves as they are, each layer's linears transposed and its two
LayerNorms.

A language model (:func:`transformer_lm_params_from_jax`): the GPT map
at the tree's root (``embedding/...``, ``transformer/...``), an MoE
layer's ``mlp/experts/{router, w_in, w_out}`` to
``transformer.layers.i.mlp.experts.*`` unchanged, or rank ``ep_rank``'s
slice of the experts.  A halo bottleneck
(:func:`bottleneck_params_from_jax`): convolutions HWIO -> OIHW, the
frozen scales and biases as they are.

The contrib modules: :func:`multihead_attn_params_from_jax` (the JAX
``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` weights are ``[out, in]``
already: every leaf keeps its name and layout),
:func:`group_norm_params_from_jax` (``weight``, ``bias``),
:func:`groupbn_params_from_jax` (a batch norm's ``scale``, ``bias``,
``mean`` and ``var``, under ``SyncBatchNorm_0/`` for ``BatchNorm2d_NHWC``,
to ``weight``, ``bias``, ``running_mean`` and ``running_var``) and
:func:`conv_params_from_jax` (HWIO -> OIHW, the ``conv_bias_relu``
layout).

Optimizer and scaler state: :func:`load_jax_optimizer_state` puts the JAX
``FusedAdam`` / ``FusedLAMB`` / ``FusedAdagrad`` state (its step, each
moment tree, and the fp32 masters when it keeps them) into a port
optimizer's ``state``, by the same name map as the weights; a JAX
``LossScaler.state_dict`` loads into the port's scaler as it is
(``LossScaler.load_state_dict``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.llama import LlamaConfig

__all__ = ["llama_params_from_jax", "gpt_params_from_jax",
           "bert_params_from_jax", "vit_params_from_jax",
           "llama_pipeline_params_from_jax", "gpt_pipeline_params_from_jax",
           "shard_gpt_state_dict",
           "load_jax_optimizer_state",
           "shard_state_dict", "resnet_params_from_jax",
           "transformer_lm_params_from_jax", "bottleneck_params_from_jax",
           "dense_params_from_jax", "multihead_attn_params_from_jax",
           "group_norm_params_from_jax", "groupbn_params_from_jax",
           "conv_params_from_jax", "conv_transpose_params_from_jax",
           "rnn_params_from_jax", "dcgan_params_from_jax"]

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def _tensor(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: carry the bits over as uint16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _expected(config: LlamaConfig) -> Dict[str, tuple]:
    """flax path -> (torch key, transpose?)"""
    m = {"embed_tokens/embedding": ("embed_tokens.weight", False),
         "norm/scale": ("norm.scale", False)}
    if not config.tie_word_embeddings:
        m["lm_head"] = ("lm_head", False)
    for i in range(config.num_hidden_layers):
        src, dst = f"layers_{i}", f"layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            m[f"{src}/{norm}/scale"] = (f"{dst}.{norm}.scale", False)
        for proj in _ATTN:
            m[f"{src}/self_attn/{proj}/kernel"] = (
                f"{dst}.self_attn.{proj}.weight", True)
        for proj in _MLP:
            m[f"{src}/mlp/{proj}/kernel"] = (f"{dst}.mlp.{proj}.weight", True)
    return m


def _convert(tree: Mapping, expected: Dict[str, tuple], what: str
             ) -> Dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    extra = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if extra or missing:
        raise ValueError(f"flax {what} tree does not match: unconsumed "
                         f"{extra}, missing {missing}")
    state = {}
    for path, (key, transpose) in expected.items():
        leaf = flat[path]
        if _is_qtensor(leaf):
            # the flax kernel [in, out] reduces its input axis 0, the head
            # [vocab, h] its axis 1: either way one scale an output row of
            # the torch weight
            want = 0 if transpose else 1
            if int(leaf.axis) != want:
                raise ValueError(f"{path}: quantized over axis {leaf.axis}, "
                                 f"not the input axis {want}")
            q = np.asarray(leaf.q)
            state[f"{key}.q"] = _tensor(q.T if transpose else q)
            state[f"{key}.scale"] = _tensor(np.asarray(leaf.scale))
            continue
        arr = np.asarray(leaf)
        state[key] = _tensor(arr.T if transpose else arr)
    return state


def _is_qtensor(leaf) -> bool:
    """A JAX ``QTensor`` leaf, known by its fields."""
    return all(hasattr(leaf, f) for f in ("q", "scale", "axis", "dtype_name"))


def llama_params_from_jax(tree: Mapping, config: LlamaConfig, *,
                          tp_rank: int = 0, tp_size: int = 1
                          ) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for ``LlamaForCausalLM(config)`` from the flax
    tree (with or without its top-level ``"params"`` collection); for
    ``quantize_params(LlamaForCausalLM(config))`` when the tree holds
    ``QTensor`` leaves.  With ``tp_size > 1``, rank ``tp_rank``'s slice
    of it (:func:`shard_state_dict`), for the model that rank builds in
    its tensor-parallel region."""
    state = _convert(tree, _expected(config), f"Llama ({config})")
    if int(tp_size) == 1:
        return state
    from apex_tpu_torch.models.llama import validate_tp_divisibility

    validate_tp_divisibility(config, tp_size)
    return shard_state_dict(state, tp_rank, tp_size)


def llama_pipeline_params_from_jax(tree: Mapping, pcfg, *, pp_rank: int,
                                   pp_size: int) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for stage ``pp_rank`` of ``pp_size`` of
    ``build_llama_pipeline(pcfg)`` from one (pp, tp) rank's JAX tree (see
    the module docstring)."""
    import dataclasses

    cfg = dataclasses.replace(pcfg.config,
                              num_hidden_layers=pcfg.layers_per_stage)
    block = {path: (f"stage.{key}", t)
             for path, (key, t) in _expected(cfg).items()
             if path.startswith("layers_")}
    state = _convert(tree["block"], block, f"Llama stage block ({cfg})")
    if pp_rank == 0:
        state.update(_convert(tree["embed"], {"embed_tokens/embedding": (
            "first.embed_tokens.weight", False)}, "Llama stage embedding"))
    if pp_rank == pp_size - 1:
        state.update(_convert(tree["head"], {
            "norm/scale": ("last.norm.scale", False),
            "lm_head": ("last.lm_head", False)}, "Llama stage head"))
    return state


def shard_state_dict(state: Mapping[str, torch.Tensor], rank: int,
                     size: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of a whole Llama serving ``state_dict`` (float
    or int8) for a tp world of ``size``: each sharded entry's block along
    its split dim (:func:`~apex_tpu_torch.serving.engine.
    tp_param_shardings`) as an owned copy, every other entry as it is."""
    from apex_tpu_torch.serving.engine import tp_param_shardings

    out = {}
    for name, sl in tp_param_shardings(state, rank, size).items():
        out[name] = state[name] if sl is None else sl.take(state[name])
    return out


def _gpt_expected(num_layers: int, position_embedding: bool,
                  src: str = "language_model/", dst: str = "language_model.",
                  moe: bool = False) -> Dict[str, tuple]:
    """flax path -> (torch key, transpose?) for a GPT of ``num_layers``
    (its language model at ``src`` / ``dst``; with ``moe`` each layer's
    MLP the experts' three leaves, kept as they are)."""
    m = {f"{src}embedding/word_embeddings/embedding":
         (f"{dst}embedding.word_embeddings.weight", False)}
    if position_embedding:
        m[f"{src}embedding/position_embeddings"] = (
            f"{dst}embedding.position_embeddings", False)
    norms = ("input_layernorm", "post_attention_layernorm")
    linears = ("self_attention/query_key_value", "self_attention/dense")
    if not moe:
        linears += ("mlp/dense_h_to_4h", "mlp/dense_4h_to_h")
    for i in range(num_layers):
        s, d = f"{src}transformer/layer_{i}", f"{dst}transformer.layers.{i}"
        for norm in norms:
            for leaf in ("scale", "bias"):
                m[f"{s}/{norm}/{leaf}"] = (f"{d}.{norm}.{leaf}", False)
        for lin in linears:
            key = lin.replace("/", ".")
            m[f"{s}/{lin}/kernel"] = (f"{d}.{key}.weight", True)
            m[f"{s}/{lin}/bias"] = (f"{d}.{key}.bias", False)
        if moe:
            for leaf in _EXPERT_LEAVES:
                m[f"{s}/mlp/experts/{leaf}"] = (f"{d}.mlp.experts.{leaf}",
                                                False)
    for leaf in ("scale", "bias"):
        m[f"{src}transformer/final_layernorm/{leaf}"] = (
            f"{dst}transformer.final_layernorm.{leaf}", False)
    return m


_EXPERT_LEAVES = ("router", "w_in", "w_out")


def gpt_pipeline_params_from_jax(tree: Mapping, cfg, *, pp_rank: int,
                                 pp_size: int) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for stage ``pp_rank`` of ``pp_size`` of
    ``build_gpt_pipeline(cfg)`` from one (pp, tp) rank's JAX tree (see the
    module docstring)."""
    layers = {
        path.replace("transformer/layer_", "layer_", 1): (
            key.replace("transformer.layers.", "stage.layers.", 1), t)
        for path, (key, t) in _gpt_expected(cfg.layers_per_stage, False, "",
                                            "").items()
        if path.startswith("transformer/layer_")}
    state = _convert(tree["block"], layers,
                     f"GPT stage block ({cfg.layers_per_stage} layers)")
    words = {"word_embeddings/embedding": ("first.word_embeddings.weight",
                                           False)}
    if pp_rank == 0:
        embed = dict(words)
        if not cfg.apply_rope:
            embed["position_embeddings"] = ("first.position_embeddings",
                                            False)
        state.update(_convert(tree["embed"], embed, "GPT stage embedding"))
    if pp_rank == pp_size - 1:
        state.update(_convert(tree["head"], {
            f"final_layernorm/{leaf}": (f"last.final_layernorm.{leaf}", False)
            for leaf in ("scale", "bias")}, "GPT stage head"))
        if pp_size > 1:
            embed = tree["embed"]
            embed = embed["params"] if set(embed) == {"params"} else embed
            state["last.word_embeddings.weight"] = _tensor(np.asarray(
                embed["word_embeddings"]["embedding"]))
    return state


# the GPT linears the tensor-parallel layers shard, by module name
_GPT_COLUMN = ("query_key_value", "dense_h_to_4h")
_GPT_ROW = ("self_attention.dense", "dense_4h_to_h")


def _gpt_shard_dim(name: str):
    """The dim a GPT ``state_dict`` entry splits on under tp, or None."""
    if name.endswith("word_embeddings.weight"):
        return 0
    module, attr = name.rsplit(".", 1)
    if module.endswith(_GPT_COLUMN):
        return 0
    if module.endswith(_GPT_ROW) and attr == "weight":
        return 1
    return None


def shard_gpt_state_dict(state: Mapping[str, torch.Tensor], rank: int,
                         size: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of a whole GPT ``state_dict`` (a ``GPTModel``'s
    or a pipeline stage's) for a tp world of ``size``: QKV and
    ``dense_h_to_4h`` on their output rows (each rank whole heads: a
    head's q, k and v are adjacent), the ``dense`` and ``dense_4h_to_h``
    weights on their input columns, the word embeddings on their vocab
    rows, each an owned copy; the rest as it is."""
    size, rank = int(size), int(rank)
    if size == 1:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = _gpt_shard_dim(name)
        if dim is None:
            out[name] = t
            continue
        if t.shape[dim] % size:
            raise ValueError(f"{name}: dim {dim} of size {t.shape[dim]} "
                             f"does not split into {size} blocks")
        n = t.shape[dim] // size
        out[name] = t.narrow(dim, rank * n, n).clone()
    return out


def gpt_params_from_jax(tree: Mapping, num_layers: int,
                        apply_rope: bool = False, *, tp_rank: int = 0,
                        tp_size: int = 1) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for ``GPTModel(num_layers=num_layers,
    apply_rope=apply_rope, ...)`` from the flax tree of the JAX
    ``GPTModel`` (with or without its ``"params"`` collection).  RoPE
    models have no position table.  With ``tp_size > 1``, rank
    ``tp_rank``'s slice of it (:func:`shard_gpt_state_dict`)."""
    state = _convert(tree, _gpt_expected(num_layers, not apply_rope),
                     f"GPT ({num_layers} layers, apply_rope={apply_rope})")
    return shard_gpt_state_dict(state, tp_rank, tp_size)


def transformer_lm_params_from_jax(
        tree: Mapping, num_layers: int, apply_rope: bool = False,
        moe: bool = False, *, ep_rank: int = 0, ep: int = 1
) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for ``TransformerLanguageModel(num_layers, ...,
    apply_rope=apply_rope, moe_num_experts=...)`` (``moe`` says whether
    the experts are set) from the JAX model's flax tree.  An MoE layer's
    ``mlp/experts/{router, w_in, w_out}`` keep their layout (``[h, e]``,
    ``[e, h, ffn]``, ``[e, ffn, h]``); with ``ep > 1``, ``w_in`` and
    ``w_out`` are rank ``ep_rank``'s ``e / ep`` experts, those JAX's ep
    ``shard_map`` gives that rank (the router whole)."""
    state = _convert(tree, _gpt_expected(num_layers, not apply_rope, "", "",
                                         moe),
                     f"TransformerLanguageModel ({num_layers} layers, "
                     f"apply_rope={apply_rope}, moe={moe})")
    size, rank = int(ep), int(ep_rank)
    if size == 1:
        return state
    for name, t in state.items():
        if name.endswith(("experts.w_in", "experts.w_out")):
            if t.shape[0] % size:
                raise ValueError(f"{name}: {t.shape[0]} experts do not "
                                 f"split over ep {size}")
            n = t.shape[0] // size
            state[name] = t[rank * n:(rank + 1) * n].clone()
    return state


_BOTTLENECK_CONVS = ("conv1", "conv2", "conv3", "conv_down")


def bottleneck_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for :class:`~apex_tpu_torch.contrib.halo.
    Bottleneck` (or ``SpatialBottleneck``) from the JAX block's flax tree:
    the convolutions ``conv1``, ``conv2``, ``conv3`` and ``conv_down`` HWIO
    -> OIHW, the frozen batch norms' ``bn*_scale`` / ``bn*_bias`` as they
    are.  Raises on a leaf it cannot place."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, arr in _flatten(tree).items():
        arr = np.asarray(arr)
        if path in _BOTTLENECK_CONVS and arr.ndim == 4:
            state[path] = _tensor(arr.transpose(3, 2, 0, 1))
        elif (path.startswith("bn") and path.endswith(("_scale", "_bias"))
              and arr.ndim == 1):
            state[path] = _tensor(arr)
        else:
            raise ValueError(f"flax Bottleneck leaf {path!r} {arr.shape} "
                             f"has no torch key")
    return state


def bert_params_from_jax(tree: Mapping, num_layers: int,
                         add_binary_head: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for ``BertModel(num_layers=num_layers,
    add_binary_head=add_binary_head, ...)`` from the flax tree of the JAX
    ``BertModel``: the language model as :func:`gpt_params_from_jax` maps
    it, ``lm_head/Dense_0`` to ``lm_head.dense``, ``lm_head/layernorm`` to
    ``lm_head.layernorm``, ``pooler/Dense_0`` to ``pooler.dense`` and
    ``binary_head`` to ``binary_head`` (kernels ``[in, out]`` to weights
    ``[out, in]``)."""
    m = _gpt_expected(num_layers, True)
    dense = {"lm_head/Dense_0": "lm_head.dense"}
    if add_binary_head:
        dense.update({"pooler/Dense_0": "pooler.dense",
                      "binary_head": "binary_head"})
    for src, dst in dense.items():
        m[f"{src}/kernel"] = (f"{dst}.weight", True)
        m[f"{src}/bias"] = (f"{dst}.bias", False)
    for leaf in ("scale", "bias"):
        m[f"lm_head/layernorm/{leaf}"] = (f"lm_head.layernorm.{leaf}", False)
    return _convert(tree, m, f"BERT ({num_layers} layers)")


def vit_params_from_jax(tree: Mapping, num_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for a ``ViTForImageClassification`` of
    ``num_layers`` layers from the flax tree of the JAX one: the top-level
    leaves under their own names and layouts (``patch_kernel``
    ``[p*p*C, h]`` keeps its patch order), ``layer_i/...`` as
    ``layers.i....`` with each linear's kernel ``[in, out]`` as a weight
    ``[out, in]`` and each LayerNorm's ``scale`` / ``bias``."""
    m = {name: (name, False) for name in (
        "patch_kernel", "patch_bias", "cls_token", "position_embeddings",
        "classifier_kernel", "classifier_bias")}
    for leaf in ("scale", "bias"):
        m[f"layernorm/{leaf}"] = (f"layernorm.{leaf}", False)
    linears = ("attention/query", "attention/key", "attention/value",
               "attention/output", "intermediate", "output")
    for i in range(num_layers):
        s, d = f"layer_{i}", f"layers.{i}"
        for lin in linears:
            key = lin.replace("/", ".")
            m[f"{s}/{lin}/kernel"] = (f"{d}.{key}.weight", True)
            m[f"{s}/{lin}/bias"] = (f"{d}.{key}.bias", False)
        for norm in ("layernorm_before", "layernorm_after"):
            for leaf in ("scale", "bias"):
                m[f"{s}/{norm}/{leaf}"] = (f"{d}.{norm}.{leaf}", False)
    return _convert(tree, m, f"ViT ({num_layers} layers)")


# the fields of the JAX optimizers' inner states beside ``step`` (and
# FusedMixedPrecisionLamb's ``lr``), each the port's state key of the same
# name: Adam's and LAMB's moments, Adagrad's sum, SGD's momentum buffer,
# NovoGrad's moments (its ``exp_avg_sq`` one scalar a tensor, or the packed
# ``[num_leaves + 1]``)
_STATE_FIELDS = ("exp_avg", "exp_avg_sq", "sum_sq", "momentum_buffer")


def load_jax_optimizer_state(
        opt: torch.optim.Optimizer, named_params: Mapping[str, torch.Tensor],
        state, tree_to_torch: Optional[Callable[[Mapping],
                                                Dict[str, torch.Tensor]]] = None
) -> None:
    """Put a JAX fused optimizer's state into ``opt.state``.

    ``state`` is the JAX ``(inner, MasterState)`` pair with its arrays as
    numpy (``jax.tree.map(np.asarray, state)``): ``inner`` a named tuple
    with ``step`` and moment trees (``exp_avg``, ``exp_avg_sq``, ``sum_sq``
    or ``momentum_buffer``; NovoGrad's ``exp_avg_sq`` a tree of scalars), and
    for ``FusedMixedPrecisionLamb`` its device ``lr``, which goes to
    ``opt.set_lr``.  ``tree_to_torch`` maps one tree of the JAX parameters'
    structure to ``{torch name: tensor}`` (e.g. ``lambda t:
    llama_params_from_jax(t, config)``; by default the tree is a flat dict
    already keyed by the torch names of ``named_params``).  A moment that
    is one flat array (a packed optimizer's) goes to the state of the
    group's first parameter; the step becomes the group's one int32 tensor
    on the device, in every parameter's state; the masters, when the JAX state holds them, each
    parameter's ``master_param``.  Every tensor lands on its parameter's
    device in the dtype the JAX state has."""
    inner, masters = state
    to_torch = tree_to_torch or (lambda t: {k: _tensor(v) for k, v in t.items()})
    fields = dict(inner._asdict())
    step = int(np.asarray(fields.pop("step")))
    if "lr" in fields:
        lr = float(np.asarray(fields.pop("lr")))
        if not hasattr(opt, "set_lr"):
            raise ValueError(f"JAX optimizer state holds a device lr; "
                             f"{type(opt).__name__} has no set_lr")
        opt.set_lr(lr)
    trees = {}
    for name, value in fields.items():
        if name not in _STATE_FIELDS:
            raise ValueError(f"JAX optimizer state field {name!r} has no "
                             f"port counterpart")
        trees[name] = (to_torch(value) if isinstance(value, Mapping)
                       else _tensor(value))
    master_params = getattr(masters, "master_params", None)
    if master_params is not None:
        trees["master_param"] = to_torch(master_params)
    names = {id(p): n for n, p in named_params.items()}
    for group in opt.param_groups:
        params = group["params"]
        shared = torch.tensor(step, dtype=torch.int32, device=params[0].device)
        for i, p in enumerate(params):
            name = names[id(p)]
            st = opt.state[p]
            for key, tree in trees.items():
                if isinstance(tree, torch.Tensor):      # one flat buffer
                    if i == 0:
                        st[key] = tree.to(p.device)
                else:
                    st[key] = tree[name].to(p.device)
            st["step"] = shared


def _resnet_key(path: str) -> str:
    """The torch key of a flax ResNet path (see the module docstring)."""
    parts = path.split("/")
    names = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
             "Conv_3": "downsample_conv", "SyncBatchNorm_0": "bn1",
             "SyncBatchNorm_1": "bn2", "SyncBatchNorm_2": "bn3",
             "SyncBatchNorm_3": "downsample_bn", "Dense_0": "fc"}
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
    prefix = []
    if parts[0].startswith("BottleneckBlock_"):
        prefix = ["blocks", parts[0][len("BottleneckBlock_"):]]
        parts = parts[1:]
    if len(parts) != 2 or parts[0] not in names or parts[1] not in leaf:
        raise ValueError(f"flax ResNet leaf {path!r} has no torch key")
    if not prefix and parts[0] in ("Conv_1", "Conv_2", "Conv_3",
                                   "SyncBatchNorm_1", "SyncBatchNorm_2",
                                   "SyncBatchNorm_3"):
        raise ValueError(f"flax ResNet leaf {path!r} has no torch key")
    return ".".join(prefix + [names[parts[0]], leaf[parts[1]]])


def resnet_params_from_jax(params: Mapping,
                           batch_stats: Optional[Mapping] = None
                           ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` of :class:`~apex_tpu_torch.examples.imagenet_main.
    ResNet` from the flax ResNet's ``params`` and ``batch_stats`` (nested
    dicts of numpy arrays; a variables dict ``{"params", "batch_stats"}``
    may come alone as ``params``): convolution kernels HWIO -> OIHW, the
    dense kernel ``[in, out]`` -> ``[out, in]``, batch norm scale, bias,
    mean and var -> weight, bias, running_mean and running_var.  Raises on
    a leaf it cannot place; a leaf the model lacks shows in
    ``load_state_dict``."""
    if batch_stats is None and set(params) == {"params", "batch_stats"}:
        params, batch_stats = params["params"], params["batch_stats"]
    state = {}
    for path, arr in _flatten(params).items():
        arr = np.asarray(arr)
        key = _resnet_key(path)
        if path.endswith("kernel"):
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        state[key] = _tensor(arr)
    for path, arr in _flatten(batch_stats or {}).items():
        key = _resnet_key(path)
        state[key] = _tensor(np.asarray(arr))
        bn = key.rsplit(".", 1)[0]
        state[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return state


def dense_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for :class:`~apex_tpu_torch.fused_dense.
    FusedDense`, ``DenseNoBias``, ``FusedDenseGeluDense`` or
    :class:`~apex_tpu_torch.mlp.MLP` from the flax module's tree: each
    ``kernel<suffix>`` ``[in, out]`` becomes ``weight<suffix>`` ``[out,
    in]`` (``kernel1`` -> ``weight1``, ``kernel_0`` -> ``weight_0``) and
    each ``bias<suffix>`` keeps its name.  Raises on any other leaf."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    expected = {}
    for name in _flatten(tree):
        if name.startswith("kernel"):
            expected[name] = ("weight" + name[len("kernel"):], True)
        elif name.startswith("bias"):
            expected[name] = (name, False)
    return _convert(tree, expected, "dense")


_MHA_LEAVES = frozenset(
    ["in_proj_weight", "in_proj_bias", "in_proj_weight_q", "in_proj_bias_q",
     "in_proj_weight_kv", "in_proj_bias_kv", "out_proj_weight",
     "out_proj_bias", "lyr_nrm_gamma_weights", "lyr_nrm_beta_weights"]
    + [f"{n}_{leaf}" for n in "qkv" for leaf in ("weight", "bias")])


def multihead_attn_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for :class:`~apex_tpu_torch.contrib.
    multihead_attn.SelfMultiheadAttn` or ``EncdecMultiheadAttn`` from the
    flax module's tree: every leaf under its own name, as it is (the JAX
    weights are ``[out, in]`` already).  Raises on any other leaf."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return _convert(tree, {name: (name, False) for name in _flatten(tree)
                           if name in _MHA_LEAVES}, "multihead attention")


def group_norm_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for :class:`~apex_tpu_torch.contrib.group_norm.
    GroupNorm` from the flax ``GroupNorm``'s tree (``weight``, ``bias``)."""
    return _convert(tree, {"weight": ("weight", False),
                           "bias": ("bias", False)}, "GroupNorm")


def groupbn_params_from_jax(params: Mapping,
                            batch_stats: Optional[Mapping] = None
                            ) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for :class:`~apex_tpu_torch.contrib.groupbn.
    BatchNorm2d_NHWC` or :class:`~apex_tpu_torch.contrib.cudnn_gbn.
    GroupBatchNorm2d` from the flax module's ``params`` and
    ``batch_stats`` (a variables dict may come alone as ``params``):
    ``scale``, ``bias``, ``mean``, ``var`` (under ``SyncBatchNorm_0/`` for
    ``BatchNorm2d_NHWC``) to ``weight``, ``bias``, ``running_mean``,
    ``running_var``; ``num_batches_tracked`` 0.  Raises on any other
    leaf."""
    if batch_stats is None and set(params) == {"params", "batch_stats"}:
        params, batch_stats = params["params"], params["batch_stats"]
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    state = {}
    for path, arr in {**_flatten(params), **_flatten(batch_stats or {})
                      }.items():
        leaf = path[len("SyncBatchNorm_0/"):] if path.startswith(
            "SyncBatchNorm_0/") else path
        if leaf not in names:
            raise ValueError(f"flax batch norm leaf {path!r} has no torch key")
        state[names[leaf]] = _tensor(np.asarray(arr))
    if batch_stats is not None:
        state["num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return state


def conv_params_from_jax(kernel) -> torch.Tensor:
    """An HWIO convolution kernel (numpy) as the OIHW CPU tensor the
    port's ``conv_bias_relu`` functions take."""
    arr = np.asarray(kernel)
    if arr.ndim != 4:
        raise ValueError(f"an HWIO kernel is 4-d, got shape {arr.shape}")
    return _tensor(arr.transpose(3, 2, 0, 1))


_RNN_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh", "w_mih", "w_mhh")


def rnn_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A CPU ``state_dict`` for :class:`~apex_tpu_torch.RNN.RNNBackend`
    (any factory of ``apex_tpu_torch.RNN``) from the flax module's tree:
    ``layer{l}_dir{d}/<leaf>`` to ``layer{l}_dir{d}.<leaf>``, every leaf
    in the JAX layout (``w_ih`` ``[in, gate]``, ``w_hh`` ``[hidden,
    gate]``, ...).  Raises on any other leaf."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    expected = {}
    for path in _flatten(tree):
        layer, _, leaf = path.partition("/")
        if re.fullmatch(r"layer\d+_dir[01]", layer) and leaf in _RNN_LEAVES:
            expected[path] = (f"{layer}.{leaf}", False)
    return _convert(tree, expected, "RNN")


def _dense_hwc_out(kernel, bias, hw: int) -> tuple:
    """A flax ``Dense`` whose output features are an NHWC ``[hw, hw, C]``
    flatten, as the ``[out, in]`` weight and bias of a linear layer whose
    outputs are the NCHW ``[C, hw, hw]`` flatten."""
    k = np.asarray(kernel)
    c = k.shape[1] // (hw * hw)
    w = k.reshape(k.shape[0], hw, hw, c).transpose(3, 1, 2, 0)
    b = np.asarray(bias).reshape(hw, hw, c).transpose(2, 0, 1)
    return _tensor(w.reshape(-1, k.shape[0])), _tensor(b.reshape(-1))


def _dense_hwc_in(kernel, hw: int) -> torch.Tensor:
    """A flax ``Dense`` kernel over an NHWC ``[hw, hw, C]`` flatten, as the
    ``[out, in]`` weight of a linear layer over the NCHW flatten."""
    k = np.asarray(kernel)
    c = k.shape[0] // (hw * hw)
    w = k.reshape(hw, hw, c, k.shape[1]).transpose(3, 2, 0, 1)
    return _tensor(w.reshape(k.shape[1], -1))


def conv_transpose_params_from_jax(kernel) -> torch.Tensor:
    """A flax ``ConvTranspose`` kernel ``[kh, kw, in, out]`` (numpy) as the
    ``[in, out, kh, kw]`` weight of ``nn.ConvTranspose2d``, flipped in
    both spatial axes: flax's transposed convolution does not flip its
    kernel, PyTorch's (the gradient of a convolution) does."""
    arr = np.asarray(kernel)
    if arr.ndim != 4:
        raise ValueError(f"a [kh, kw, in, out] kernel is 4-d, got shape "
                         f"{arr.shape}")
    return _tensor(arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def dcgan_params_from_jax(g_tree: Mapping, d_tree: Mapping
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """CPU ``state_dict``s ``(generator, discriminator)`` for
    :mod:`apex_tpu_torch.examples.dcgan_main_amp` from the flax
    ``Generator``'s and ``Discriminator``'s trees (NHWC there, NCHW
    here): each ``Dense_0`` reordered between the NHWC and NCHW flattens
    of its ``4 x 4`` side, each ``ConvTranspose_i`` kernel through
    :func:`conv_transpose_params_from_jax`, each ``Conv_i`` kernel
    through :func:`conv_params_from_jax`, ``LayerNorm_i`` ``scale`` and
    ``bias`` as they are.  Raises on a leaf it does not consume."""
    g = dict(_flatten(g_tree["params"] if set(g_tree) == {"params"}
                      else g_tree))
    d = dict(_flatten(d_tree["params"] if set(d_tree) == {"params"}
                      else d_tree))

    def take(flat, path):
        if path not in flat:
            raise ValueError(f"flax DCGAN tree has no leaf {path!r}")
        return flat.pop(path)

    gs, ds = {}, {}
    gs["Dense_0.weight"], gs["Dense_0.bias"] = _dense_hwc_out(
        take(g, "Dense_0/kernel"), take(g, "Dense_0/bias"), 4)
    for i in range(3):
        gs[f"ConvTranspose_{i}.weight"] = conv_transpose_params_from_jax(
            take(g, f"ConvTranspose_{i}/kernel"))
        gs[f"ConvTranspose_{i}.bias"] = _tensor(np.asarray(
            take(g, f"ConvTranspose_{i}/bias")))
    for i in range(2):
        for leaf in ("scale", "bias"):
            gs[f"LayerNorm_{i}.{leaf}"] = _tensor(np.asarray(
                take(g, f"LayerNorm_{i}/{leaf}")))
    for i in range(3):
        ds[f"Conv_{i}.weight"] = conv_params_from_jax(take(d, f"Conv_{i}/kernel"))
        ds[f"Conv_{i}.bias"] = _tensor(np.asarray(take(d, f"Conv_{i}/bias")))
    ds["Dense_0.weight"] = _dense_hwc_in(take(d, "Dense_0/kernel"), 4)
    ds["Dense_0.bias"] = _tensor(np.asarray(take(d, "Dense_0/bias")))
    if g or d:
        raise ValueError(f"flax DCGAN trees do not match: unconsumed "
                         f"{sorted(g)} {sorted(d)}")
    return gs, ds
