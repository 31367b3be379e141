"""The amp O1 cast lists as data (counterpart of ``apex_tpu/amp/lists.py``).

apex expresses O1 by patching every listed torch function
(``apex/amp/lists/torch_overrides.py``, ``functional_overrides.py``,
``tensor_overrides.py``; the promotion engine in ``apex/amp/amp.py``).
The behaviour underneath is five rules, which this module lists and
:mod:`apex_tpu_torch.amp.functional` applies, patching nothing:

- **HALF ops** (tensor-core products): floating inputs cast to the
  policy's half dtype.
- **FLOAT ops** (transcendentals, reductions, norms, losses): floating
  inputs cast to fp32.
- **PROMOTE ops** (several-tensor math and comparisons): floating inputs
  cast to the widest among them.
- **SEQUENCE ops** (``cat`` / ``stack``): the sequence cast to its widest
  member.
- **BANNED ops**: calling one raises with what to do instead.

A name is looked up in ``torch.nn.functional``, then ``torch``, then
``torch.linalg`` (a dotted name, ``linalg.norm``, from ``torch``): the
first that has it, as the JAX module looks in ``jnp``, ``jax.nn``,
``jax.lax`` and ``jnp.linalg``.  The classifications follow the JAX
package's where both have the op (``dot`` is a HALF op there and here;
apex promotes it); the port has the reference's PyTorch ops themselves,
so most rows the JAX package marks N/A are ops here.

``REFERENCE_MAP`` records every entry of the reference's three
registries: the op of the lists above that carries its rule, or N/A with
the reason.  ``tensor_overrides``' dunders (``__add__`` ...) name the
same ops as the function registries, so each maps to its function's row.
"""

from __future__ import annotations

# tensor-core products: half under O1 (torch_overrides.FP16_FUNCS,
# functional_overrides.FP16_FUNCS and the batched _bmms)
HALF_FUNCS = [
    "matmul", "mm", "mv", "bmm", "addmm", "addmv", "addr", "addbmm",
    "baddbmm", "einsum", "tensordot", "inner", "outer", "dot", "vdot",
    "linear", "bilinear", "prelu",
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d",
    "conv_transpose3d", "conv_tbc",
]

# numerically sensitive ops: fp32 under O1 (torch_overrides.FP32_FUNCS and
# functional_overrides.FP32_FUNCS)
FLOAT_FUNCS = [
    # pointwise transcendentals
    "acos", "asin", "cosh", "sinh", "tan", "exp", "expm1", "log", "log10",
    "log2", "log1p", "reciprocal", "rsqrt", "pow", "erfinv",
    # reductions and norms
    "sum", "prod", "mean", "std", "var", "cumsum", "cumprod", "dist",
    "norm", "linalg.norm", "renorm", "logsumexp",
    # softmax, activations, normalizations, resampling
    "softmax", "log_softmax", "softmin", "softplus", "gelu", "normalize",
    "layer_norm", "group_norm", "local_response_norm", "cosine_similarity",
    "interpolate", "grid_sample",
    # losses
    "poisson_nll_loss", "cosine_embedding_loss", "cross_entropy",
    "hinge_embedding_loss", "kl_div", "l1_loss", "mse_loss",
    "margin_ranking_loss", "multilabel_margin_loss",
    "multilabel_soft_margin_loss", "multi_margin_loss", "nll_loss",
    "binary_cross_entropy_with_logits", "smooth_l1_loss", "soft_margin_loss",
    "triplet_margin_loss", "ctc_loss",
]

# several-tensor math: the widest float dtype (torch_overrides.CASTS);
# comparisons promote their operands the same way
PROMOTE_FUNCS = [
    "add", "sub", "subtract", "mul", "multiply", "div", "divide",
    "true_divide", "atan2", "arctan2", "cross", "hypot", "addcdiv",
    "addcmul",
    "eq", "ne", "ge", "gt", "le", "lt", "equal", "greater", "greater_equal",
    "less", "less_equal", "not_equal",
]

# sequences: every member the widest member's dtype
# (torch_overrides.SEQUENCE_CASTS)
SEQUENCE_FUNCS = ["cat", "concatenate", "stack", "hstack", "vstack"]

# functional_overrides.BANNED_FUNCS: name -> what to do instead
BANNED_FUNCS = {
    "binary_cross_entropy": (
        "amp does not work out-of-the-box with a sigmoid-then-BCE pair: "
        "the probabilities must already be fp32.  Fuse them: compute BCE "
        "from *logits* (binary_cross_entropy_with_logits, a FLOAT op), or "
        "register sigmoid as a float op via "
        "amp.functional.register_float_function."),
}

# ---------------------------------------------------------------------------
# Every reference registry entry: the op of the lists above that carries
# its rule, "BANNED", or "N/A: reason".
# ---------------------------------------------------------------------------
REFERENCE_MAP = {
    # --- torch_overrides.FP16_FUNCS ---
    **{n: n for n in ("conv1d", "conv2d", "conv3d", "conv_transpose1d",
                      "conv_transpose2d", "conv_transpose3d", "conv_tbc",
                      "prelu", "addmm", "addmv", "addr", "matmul", "mm",
                      "mv", "bmm", "addbmm", "baddbmm")},
    # --- torch_overrides.FP32_FUNCS ---
    **{n: n for n in ("acos", "asin", "cosh", "erfinv", "exp", "expm1",
                      "log", "log10", "log2", "reciprocal", "rsqrt", "sinh",
                      "tan", "pow", "cumprod", "cumsum", "dist", "mean",
                      "norm", "prod", "std", "sum", "var", "renorm")},
    # --- torch_overrides.CASTS ---
    **{n: n for n in ("addcdiv", "addcmul", "atan2", "cross", "add", "div",
                      "mul", "eq", "equal", "ge", "gt", "le", "lt", "ne")},
    "bilinear": "bilinear",   # a HALF op here (a product), CASTS in apex
    "dot": "dot",             # HALF here as in the JAX package, CASTS in apex
    # --- torch_overrides.SEQUENCE_CASTS ---
    "cat": "cat", "stack": "stack",
    # --- functional_overrides.FP16_FUNCS (the conv family is above) ---
    "linear": "linear",
    # --- functional_overrides.FP32_FUNCS ---
    **{n: n for n in ("interpolate", "grid_sample", "softplus", "softmin",
                      "log_softmax", "softmax", "gelu", "layer_norm",
                      "group_norm", "local_response_norm", "normalize",
                      "cosine_similarity", "poisson_nll_loss",
                      "cosine_embedding_loss", "cross_entropy",
                      "hinge_embedding_loss", "kl_div", "l1_loss", "mse_loss",
                      "margin_ranking_loss", "multilabel_margin_loss",
                      "multilabel_soft_margin_loss", "multi_margin_loss",
                      "nll_loss", "binary_cross_entropy_with_logits",
                      "smooth_l1_loss", "soft_margin_loss",
                      "triplet_margin_loss", "ctc_loss")},
    # --- functional_overrides.BANNED_FUNCS ---
    "binary_cross_entropy": "BANNED (see lists.BANNED_FUNCS)",
    # --- tensor_overrides (the dunders name their function's row) ---
    "__matmul__": "matmul",
    "__pow__": "pow", "__ipow__": "pow", "__rpow__": "pow",
    "cpu": "N/A: a Tensor method with no function of the namespace behind "
           "it; the port patches no Tensor method, and .cpu() keeps the "
           "dtype (cast the result where an fp32 host copy is wanted)",
    "__add__": "add", "__iadd__": "add", "__radd__": "add",
    "__sub__": "sub", "__isub__": "sub", "__rsub__": "sub",
    "__mul__": "mul", "__imul__": "mul", "__rmul__": "mul",
    "__div__": "div", "__idiv__": "div", "__rdiv__": "div",
    "__truediv__": "true_divide", "__itruediv__": "true_divide",
    "__rtruediv__": "true_divide",
    "__eq__": "eq", "__ne__": "ne", "__ge__": "ge", "__gt__": "gt",
    "__le__": "le", "__lt__": "lt",
}
