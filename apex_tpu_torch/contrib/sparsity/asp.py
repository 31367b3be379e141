"""ASP: automatic structured sparsity for 2:4 pruned training (counterpart
of ``apex_tpu.contrib.sparsity.asp``).

Decorate a model with per-weight masks, compute n:m masks from the
trained weights, and have the optimizer re-apply them after every
update; ``prune_trained_model`` chains the three.  JAX holds masks keyed
by pytree path and applies them functionally; here they are keyed by the
``nn.Module``'s parameter names and applied in place (``p.mul_(mask)``
under ``no_grad``), and the optimizer's ``step`` is wrapped: gradients of
pruned weights are zeroed before the step, the weights masked after it.
The singleton of class methods is JAX's.

The default eligibility gate is the tensor-core shape gate in PyTorch's
layout: float parameters of two or more dimensions with ``shape[0] % 8
== 0`` and ``shape[1] % 16 == 0`` (``out`` and ``in`` of a linear
weight, ``O`` and ``I`` of an OIHW one), masks grouped along dimension 1
(:func:`~apex_tpu_torch.contrib.sparsity.sparse_masklib.create_mask`).

``allow_permutation`` is accepted and inactive, as in JAX: run
:func:`~apex_tpu_torch.contrib.sparsity.accelerated_search_for_good_permutation`
yourself and permute the weights before computing masks.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from apex_tpu_torch.contrib.sparsity.sparse_masklib import create_mask

__all__ = ["ASP"]


class ASP:
    _model: Optional[nn.Module] = None
    _masks: Optional[Dict[str, torch.Tensor]] = None
    _pruned: Optional[Dict[str, torch.Tensor]] = None
    _calculate_mask: Optional[Callable] = None
    _pattern: Optional[str] = None
    _allow_recompute = False
    _verbosity = 0

    @classmethod
    def _params(cls, model=None):
        model = cls._model if model is None else model
        if model is None:
            raise RuntimeError("no model: pass one or call "
                               "init_model_for_pruning")
        return dict(model.named_parameters())

    @classmethod
    def init_model_for_pruning(cls, model: nn.Module,
                               mask_calculator="m4n2_1d", verbosity=3,
                               whitelist=None, allowed_layer_names=None,
                               disallowed_layer_names=(),
                               allow_recompute_mask=False,
                               custom_layer_dict=None,
                               allow_permutation=True):
        """Select prunable parameters and give each an all-ones mask.

        ``whitelist`` is a predicate ``(name, param) -> bool`` (the
        lower-cased parameter name); ``allowed_layer_names`` and
        ``disallowed_layer_names`` filter by substring.  Returns the masks
        by parameter name."""
        if cls._masks is not None:
            raise RuntimeError("ASP has been initialized already")
        del custom_layer_dict, allow_permutation  # see the module docstring
        cls._model = model
        cls._verbosity = verbosity
        cls._allow_recompute = allow_recompute_mask
        if isinstance(mask_calculator, str):
            cls._pattern = mask_calculator
            cls._calculate_mask = lambda p: create_mask(p, mask_calculator)
        else:
            cls._pattern = None
            cls._calculate_mask = mask_calculator

        def eligible(name: str, p) -> bool:
            lname = name.lower()
            if allowed_layer_names is not None and not any(
                    a in lname for a in allowed_layer_names):
                return False
            if any(d in lname for d in disallowed_layer_names):
                return False
            if whitelist is not None:
                return whitelist(lname, p)
            return (p.dim() >= 2 and p.is_floating_point()
                    and p.shape[0] % 8 == 0 and p.shape[1] % 16 == 0)

        cls._masks = {}
        for name, p in model.named_parameters():
            if eligible(name, p):
                if verbosity >= 3:
                    print(f"[ASP] sparsifying {name} shape={tuple(p.shape)} "
                          f"dtype={p.dtype}")
                cls._masks[name] = torch.ones_like(p, dtype=torch.bool)
        return cls._masks

    @classmethod
    @torch.no_grad()
    def compute_sparse_masks(cls, model: Optional[nn.Module] = None):
        """Compute masks from the current weights and prune them in place;
        with ``allow_recompute_mask`` the pruned values are kept for
        :meth:`restore_pruned`.  Returns the masks."""
        if cls._masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        params = cls._params(model)
        for name in cls._masks:
            cls._masks[name] = cls._calculate_mask(params[name])
        if cls._allow_recompute:
            cls._pruned = {name: torch.where(mask, 0, params[name])
                           for name, mask in cls._masks.items()}
        cls.apply_masks(model)
        return cls._masks

    @classmethod
    @torch.no_grad()
    def apply_masks(cls, model: Optional[nn.Module] = None):
        """``p *= mask`` on every masked parameter, in place."""
        if cls._masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        params = cls._params(model)
        for name, mask in cls._masks.items():
            params[name].mul_(mask)

    @classmethod
    @torch.no_grad()
    def restore_pruned(cls, model: Optional[nn.Module] = None):
        """Add the kept pruned values back (the ``allow_recompute_mask``
        flow)."""
        if cls._pruned is None:
            raise RuntimeError("no pruned values stored "
                               "(allow_recompute_mask=False?)")
        params = cls._params(model)
        for name, stash in cls._pruned.items():
            params[name].add_(stash)

    @classmethod
    def init_optimizer_for_pruning(cls, optimizer):
        """Wrap ``optimizer.step`` so the masks persist through updates:
        the gradients of pruned weights are zeroed before each step and
        the weights masked after it.  Returns the optimizer."""
        if cls._masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        inner = optimizer.step

        def step(*args, **kwargs):
            params = cls._params()
            with torch.no_grad():
                for name, mask in cls._masks.items():
                    grad = params[name].grad
                    if grad is not None:
                        grad.mul_(mask)
            out = inner(*args, **kwargs)
            cls.apply_masks()
            return out

        optimizer.step = step
        return optimizer

    @classmethod
    def prune_trained_model(cls, model: nn.Module, optimizer,
                            mask_calculator="m4n2_1d"):
        """The one-call recipe: init, wrap the optimizer, compute the masks
        and prune.  Returns ``(model, optimizer)``."""
        cls.init_model_for_pruning(model, mask_calculator,
                                   allow_recompute_mask=False)
        wrapped = cls.init_optimizer_for_pruning(optimizer)
        cls.compute_sparse_masks()
        return model, wrapped

    # -- introspection / checkpointing --------------------------------------

    @classmethod
    def masks(cls):
        """The ``{parameter name: bool mask}`` dict."""
        return cls._masks

    @classmethod
    def state_dict(cls):
        """Masks, pruned values and pattern, for an exact sparse resume."""
        return {"masks": cls._masks, "pruned": cls._pruned,
                "pattern": cls._pattern}

    @classmethod
    def load_state_dict(cls, d, model: Optional[nn.Module] = None):
        """Restore the singleton to a working state: masks, pruned values
        and, when the masks came from a pattern string, the mask
        calculator; ``model`` (else the one already registered) is what
        later calls act on."""
        if model is not None:
            cls._model = model
        cls._masks = d["masks"]
        cls._pruned = d.get("pruned")
        cls._pattern = d.get("pattern")
        cls._allow_recompute = cls._pruned is not None
        if cls._pattern is not None:
            pattern = cls._pattern
            cls._calculate_mask = lambda p: create_mask(p, pattern)

    @classmethod
    def reset(cls):
        """Drop all singleton state."""
        cls._model = cls._masks = cls._pruned = None
        cls._calculate_mask = cls._pattern = None
