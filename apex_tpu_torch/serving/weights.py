"""Load serving weights from a resilience checkpoint root.

The port of ``apex_tpu.serving.weights`` for whole-tree (v1)
checkpoints.  Serving restarts from whatever training last proved
durable: the newest *valid* step under the root (corrupt or truncated
candidates are skipped exactly as a training restart would skip them,
and validation is fused into the single restore pass — no separate
pre-validating read of a multi-GB payload).  Steps an in-process writer
is still committing are never selected.

Training checkpoints usually persist a whole train state (weights +
optimizer moments + step); serving needs only the weights, so
``params_key`` selects that subtree *after* the strict full-tree restore
(the restore layer's structure check stays authoritative).  ``policy``
(a :class:`~apex_tpu_torch.amp.policy.PrecisionPolicy`, e.g. ``O2()``)
then casts it for half-precision serving, norm scales pinned fp32, as
:meth:`~apex_tpu_torch.amp.policy.PrecisionPolicy.cast_params` casts a
module.  The leaves restore onto the template's devices: a ``like`` of
CUDA tensors (``model.state_dict()``) restores straight onto the card.

A root may hold whole-tree (v1) and sharded (v2,
:mod:`~apex_tpu_torch.resilience.elastic`) step directories; both
restore.  ``shardings=`` (a tp rank's
:func:`~apex_tpu_torch.serving.engine.tp_param_shardings`) restores only
the rank's slice of each sharded weight, with no whole-model copy in host
memory: from a v1 record the leaf is read (its CRC covers it whole) and
the slice kept, from a v2 checkpoint only the shard records that overlap
the slice are read.  The ``like`` template then holds the rank's shard
dict (``model.state_dict()`` of the model it built in its tensor-parallel
region), and the restored tensors land on its devices.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from apex_tpu_torch._logging import emit_event, get_logger
from apex_tpu_torch.resilience import checkpoint as _ckpt
from apex_tpu_torch.resilience.checkpoint import CheckpointError
from apex_tpu_torch.utils.serialization import tree_flatten_with_path

__all__ = ["load_serving_params"]

logger = get_logger("serving.weights")


def _restore_newest_valid(root: str, like: Any, step: Optional[int],
                          shardings: Optional[dict] = None
                          ) -> tuple[Any, int, dict, str]:
    """The newest-valid fallback walk.  Returns ``(tree, step, manifest,
    step_dir)``; raises :class:`CheckpointError` when nothing under
    ``root`` restores."""
    if step is not None:
        candidates = [step]
    else:
        # honor the live-writer registry: a step an in-process
        # AsyncCheckpointer is mid-commit on (a re-save swaps the old
        # dir aside before the new one lands) must never be selected —
        # the watcher/reloader reads whatever was last COMMITTED
        live = _ckpt.in_flight_steps(root)
        candidates = [s for s in reversed(_ckpt._list_steps(root))
                      if s not in live]
    if not candidates:
        raise CheckpointError(f"no checkpoints under {root!r}")
    errors: list[str] = []
    for got in candidates:
        step_dir = os.path.join(root, _ckpt._step_dirname(got))
        try:
            # CHEAP structural probe only; the one full CRC pass happens
            # inside the restore itself
            manifest = _ckpt._read_manifest(step_dir)
            logger.debug("serving weights from %s (format v%s)", step_dir,
                         manifest.get("format_version", 1))
            # v1 or v2: restore_checkpoint dispatches on the manifest
            tree, got = _ckpt.restore_checkpoint(root, like, step=got,
                                                 shardings=shardings)
            return tree, got, manifest, step_dir
        except CheckpointError as e:
            # newest-valid fallback walk, same contract as a training
            # restart (the restore layer already emitted
            # checkpoint_rejected for CRC-level damage)
            errors.append(str(e))
            if step is not None:
                raise
    raise CheckpointError(
        f"no valid checkpoint under {root!r}; rejected: {errors}")


def load_serving_params(root: str, like: Any, *,
                        params_key: Optional[str] = None,
                        policy: Any = None,
                        step: Optional[int] = None,
                        shardings: Any = None,
                        quantize: bool = False) -> tuple[Any, int]:
    """Restore serving weights from checkpoint ``root``.

    Args:
      root: a resilience checkpoint root (v1).
      like: template tree with the **saved** structure (the full train
        state the training loop persisted, not just the weights); each
        leaf restores onto its template leaf's device and dtype.
      params_key: top-level key selecting the weights subtree of the
        restored tree (``None`` = the whole tree is the weights).
      policy: optional :class:`~apex_tpu_torch.amp.policy.PrecisionPolicy`;
        its :meth:`cast_state_dict` is applied to the selected
        ``state_dict`` (bf16 serving with fp32 norms under ``O2()``).
      step: pin an exact step instead of the newest-valid walk.
      shardings: ``{name: ShardSlice or None}`` over the weights
        subtree (:func:`~apex_tpu_torch.serving.engine.tp_param_shardings`
        of this rank): restore only each named leaf's block.  ``like``'s
        weights subtree then holds the blocks' shapes.
      quantize: apply :func:`~apex_tpu_torch.serving.quant.
        quantize_state_dict` after the policy cast — the projections and
        the LM head become their int8 ``.q`` / ``.scale`` pairs, the
        layout of ``quantize_params(model)``, ready for a
        ``quant=QuantConfig(weights=True)`` engine.

    Returns ``(params, step)``.  Raises :class:`CheckpointError` when no
    valid checkpoint exists (or the pinned step is invalid).
    """
    t0 = time.monotonic()
    paths = None
    group = None
    if shardings is not None:
        prefix = "" if params_key is None else f"[{params_key!r}]"
        paths = {f"{prefix}[{name!r}]": sl
                 for name, sl in dict(shardings).items() if sl is not None}
        if quantize:
            from apex_tpu_torch.transformer import parallel_state

            if not parallel_state.model_parallel_is_initialized():
                raise ValueError(
                    "quantize=True with shardings= quantizes a rank's "
                    "slices, whose row-parallel scales are all-reduced "
                    "over the tp group: install the parallel state first")
            group = parallel_state.get_tensor_model_parallel_group()
    tree, got, manifest, step_dir = _restore_newest_valid(root, like, step,
                                                          paths)
    if params_key is not None:
        try:
            tree = tree[params_key]
        except (KeyError, TypeError) as e:
            raise CheckpointError(
                f"{step_dir}: restored tree has no {params_key!r} "
                f"subtree to serve from") from e
    if policy is not None:
        tree = policy.cast_state_dict(tree)
    if quantize:
        from apex_tpu_torch.serving.quant import quantize_state_dict

        tree = quantize_state_dict(tree, group=group)
    nbytes = sum(int(getattr(leaf, "nbytes", 0))
                 for _, leaf in tree_flatten_with_path(tree))
    # step + format + bytes + wall time: the reload observability
    # contract — the obs bridge sets apex_serving_weights_step and
    # observes the restore phase of
    # apex_serving_reload_duration_seconds from exactly this event
    emit_event("serving_weights_loaded", step=int(got),
               format_version=int(manifest.get("format_version", 1)),
               sharded=(manifest.get("format_version")
                        == _ckpt._SHARDED_FORMAT_VERSION),
               params_key=params_key,
               opt_level=getattr(policy, "opt_level", None),
               quantized=bool(quantize), bytes=nbytes, t0=t0)
    return tree, got
