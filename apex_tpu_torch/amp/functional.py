"""The policy-aware op namespace: the O1 cast lists made executable
(counterpart of ``apex_tpu/amp/functional.py``; apex's ``amp/amp.py``
``cached_cast`` / ``promote`` / ``sequence_promote`` wrappers).

apex patches ``torch.*`` in place under O1.  Here, as in the JAX package,
nothing in ``torch`` is touched: the ops are called through this module
(``from apex_tpu_torch.amp import functional as F; F.matmul(a, b)``) and
consult the *active policy*, installed process-wide by
``amp.initialize(opt_level="O1")`` (:func:`set_active_policy`) or for one
thread by the :func:`active_policy` context manager.  With no policy, or
a policy other than O1, every op is an exact pass-through: the torch
function called with the caller's arguments.

The rules (:mod:`apex_tpu_torch.amp.lists`):

- HALF ops: floating tensors among the arguments cast to the policy's
  ``compute_dtype``;
- FLOAT ops: floating tensors cast to fp32;
- PROMOTE ops: floating tensors cast to :func:`widest_dtype` of them
  (fp32 wins over a half; bf16 with fp16 gives fp32);
- SEQUENCE ops: the sequence (the first argument, or the first keyword
  argument that holds floating tensors) cast to its widest member;
- BANNED ops raise.

Arguments are walked as trees (tuples, lists, dicts); other values pass
as they are.  The casts are ``Tensor.to``, so autograd carries each
gradient back in its leaf's dtype.  Each op is the attribute named after
its list entry, dots as underscores (``linalg.norm`` is ``linalg_norm``).
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
from typing import Optional

import torch

from apex_tpu_torch.amp import lists as _lists

_state = threading.local()   # this thread's override (the context manager)
_default_policy = None       # the process-wide policy (amp.initialize)
_UNSET = object()
# where a name is looked up, in order (the lists' module docstring)
_NAMESPACES = (torch.nn.functional, torch, torch.linalg)


def _current():
    local = getattr(_state, "policy", _UNSET)
    return _default_policy if local is _UNSET else local


@contextlib.contextmanager
def active_policy(policy):
    """Scope ``policy`` over the ops called through this module, in this
    thread only."""
    prev = getattr(_state, "policy", _UNSET)
    _state.policy = policy
    try:
        yield
    finally:
        if prev is _UNSET:
            del _state.policy
        else:
            _state.policy = prev


def set_active_policy(policy) -> None:
    """Install ``policy`` process-wide, seen from every thread that has no
    :func:`active_policy` of its own (what ``amp.initialize`` does at
    O1); None removes it."""
    global _default_policy
    _default_policy = policy


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def _cast_tree(tree, dtype):
    if _is_float(tree):
        return tree.to(dtype)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree


def widest_dtype(*trees) -> Optional[torch.dtype]:
    """The widest dtype of the floating tensors in ``trees`` (PyTorch's
    promotion: one half stays itself, fp16 with bf16 or either with fp32
    gives fp32), or None if there are none."""
    out = None
    for leaf in _leaves(trees):
        if _is_float(leaf):
            out = leaf.dtype if out is None else torch.promote_types(
                out, leaf.dtype)
    return out


def _resolve(name: str):
    """The op ``name`` in the first namespace that has it."""
    for ns in _NAMESPACES:
        obj = ns
        for part in name.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                break
        if obj is not None and callable(obj):
            return obj
    raise AttributeError(f"no torch op named {name!r}")


def _wrap(fn, rule: str):
    """``fn`` behind the cast ``rule``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        policy = _current()
        # only O1 patches functions (apex's frontend: patch_torch_functions
        # is False at O0, O2 and O3, and O3's "no fp32 exemptions" needs it)
        if policy is None or policy.opt_level != "O1":
            return fn(*args, **kwargs)
        if rule == "half":
            args, kwargs = _cast_tree((args, kwargs), policy.compute_dtype)
        elif rule == "float":
            args, kwargs = _cast_tree((args, kwargs), torch.float32)
        elif rule == "promote":
            target = widest_dtype(args, kwargs)
            if target is not None:
                args, kwargs = _cast_tree((args, kwargs), target)
        elif rule == "sequence":
            if args:
                target = widest_dtype(args[0])
                if target is not None:
                    args = (_cast_tree(tuple(args[0]), target),) + args[1:]
            else:
                for key, value in kwargs.items():
                    target = widest_dtype(value)
                    if target is not None:
                        kwargs = {**kwargs,
                                  key: _cast_tree(tuple(value), target)}
                        break
        return fn(*args, **kwargs)

    wrapped.__amp_rule__ = rule
    return wrapped


def _banned(name: str, guidance: str):
    def banned(*args, **kwargs):
        raise RuntimeError(f"amp: {name} is banned under mixed precision.  "
                           + guidance)

    banned.__name__ = name
    banned.__amp_rule__ = "banned"
    return banned


_module = sys.modules[__name__]
_RULES = (("half", _lists.HALF_FUNCS), ("float", _lists.FLOAT_FUNCS),
          ("promote", _lists.PROMOTE_FUNCS),
          ("sequence", _lists.SEQUENCE_FUNCS))
for _rule, _names in _RULES:
    for _name in _names:
        setattr(_module, _name.replace(".", "_"),
                _wrap(_resolve(_name), _rule))
for _name, _msg in _lists.BANNED_FUNCS.items():
    setattr(_module, _name, _banned(_name, _msg))


def _register(name: str, rule: str, func=None) -> None:
    """apex's ``amp.register_*_function``: add ``name`` to ``rule``'s list
    and expose it as ``amp.functional.<name>`` (``func``, or the torch op
    of that name)."""
    target = {"half": _lists.HALF_FUNCS, "float": _lists.FLOAT_FUNCS,
              "promote": _lists.PROMOTE_FUNCS}[rule]
    if name not in target:
        target.append(name)
    setattr(_module, name.replace(".", "_"),
            _wrap(_resolve(name) if func is None else func, rule))


def register_half_function(name: str, func=None) -> None:
    _register(name, "half", func)


def register_float_function(name: str, func=None) -> None:
    _register(name, "float", func)


def register_promote_function(name: str, func=None) -> None:
    _register(name, "promote", func)


__all__ = (["active_policy", "set_active_policy", "widest_dtype",
            "register_half_function", "register_float_function",
            "register_promote_function"]
           + [n.replace(".", "_") for _, names in _RULES for n in names]
           + list(_lists.BANNED_FUNCS))
