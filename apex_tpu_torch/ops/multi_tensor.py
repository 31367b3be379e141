"""The multi-tensor kernels under the optimizers, and their plain versions.

Four kernels of ``csrc/multi_tensor.cu``, each walking a table of tensor
pointers and chunks in one launch (``csrc/multi_tensor_apply.cuh``), as
Apex's ``multi_tensor_apply`` does; the JAX package runs each as one XLA
loop over the pytree, with no Pallas kernel behind it:

- :func:`l2norm` (``mt_l2norm``): the global and per-tensor L2 norms in
  fp32, optionally of ``x * inv_scale``, and a non-finite flag; two
  launches, sums in a fixed order (the same bits on every call).  Serves
  ``multi_tensor_l2norm``, ``multi_tensor_unscale_l2norm``, ``tree_l2norm``,
  the LAMB clip norm and per-leaf norms, and ``clip_grad_norm_``.
- :func:`scale` (``mt_scale``): ``out = x * scale`` (or in place), with a
  flag set by any inf or NaN in ``x``; with no output, the overflow check
  alone (``LossScaler.has_overflow``).
- :func:`adam` (``mt_adam``): ``FusedAdam`` (L2 or decoupled decay) and
  ``FusedAdamSWA`` (its three math modes and the average), the gradient
  read in place and multiplied by a device ``inv_scale``, the master's copy
  into the half parameter fused in.
- :func:`lamb` (``mt_lamb``): ``FusedLAMB`` and ``FusedMixedPrecisionLamb``
  in one cooperative launch over a plan of groups (:func:`lamb_plan`: runs
  of tensors whose g, p, m and v fit :data:`LAMB_BUDGET`), each group in two
  stages around a grid barrier (the moments and each span's ``||p||^2``,
  ``||u||^2``; then the trust ratio and the apply, the update recomputed
  while L2 still holds the group, so no fp32 buffer the size of the model
  is kept); and :func:`lamb_apply`, the apply alone over given updates and
  norms (the packed LAMB's phase 2), one pass over the chunks.

Every step scalar that changes between steps (the bias corrections, the
inverse loss scale, the clip factor, a tensor learning rate, the step and
``n_averaged``) stays on the device, and a set ``noop`` (the loss scaler's
``found_inf``, a 0-d bool) makes the kernels return before any load: the
step is skipped with every bit kept and no host sync.

Dispatch is ``_dispatch``'s rule: tensors on CUDA go to the kernel, on the
CPU to the plain version beside it (the optimizers' per-tensor PyTorch
code, moved here).  A kernel takes fp32, bf16 and fp16 in every list but
the SWA average (fp32), each tensor's dtype its own; anything else raises.

The table (:func:`table_words`) is an int64 tensor on the device, copied
from pinned host memory on the current stream and cached by the tuple of
data pointers, sizes and dtypes: parameters, masters and moments keep
their storage, and gradients usually come back at the same addresses from
the caching allocator; on a miss the table is built again in new pinned
memory (an earlier asynchronous copy may still read the old one).  A table
built or used while a CUDA graph is captured is kept for the process's
life, since the graph reads it on every replay.  Its chunk is chosen from
the list when it is built (:func:`choose_chunk`): 65,536 elements unless
that leaves some of the card's resident blocks without a chunk, as on
OpenFold's 48 small tensors; ``mt_lamb``'s table also carries its group
plan.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._dispatch import Kernel, kernel_path, register

__all__ = ["MT_L2NORM", "MT_SCALE", "MT_ADAM", "MT_LAMB", "CHUNK",
           "MIN_CHUNK", "LAMB_BUDGET", "LAMB_NARROW", "LAMB_TEAMS", "L2Norm",
           "LambPlan",
           "ADAM_L2", "ADAMW", "SWA_APEX_ADAM", "SWA_APEX_ADAMW",
           "SWA_PYTORCH_ADAM", "adam", "choose_chunk", "device_scalar",
           "l2norm", "lamb", "lamb_apply", "lamb_blocks", "lamb_plan",
           "lamb_list_plan", "lamb_ring",
           "resident_blocks", "scale", "table_words"]

MT_L2NORM = register(Kernel(
    name="mt_l2norm", source="multi_tensor.cu", symbol="apex_mt_l2norm",
    replaces="apex_tpu/multi_tensor_apply/__init__.py:73 multi_tensor_l2norm"))
MT_SCALE = register(Kernel(
    name="mt_scale", source="multi_tensor.cu", symbol="apex_mt_scale",
    replaces="apex_tpu/multi_tensor_apply/__init__.py:49 multi_tensor_scale"))
MT_ADAM = register(Kernel(
    name="mt_adam", source="multi_tensor.cu", symbol="apex_mt_adam",
    replaces="apex_tpu/optimizers/fused_adam.py:65 _update"))
MT_LAMB = register(Kernel(
    name="mt_lamb", source="multi_tensor.cu", symbol="apex_mt_lamb",
    replaces="apex_tpu/optimizers/fused_lamb.py:134 _update"))

#: elements a chunk at most (the last chunk of a tensor holds the rest)
CHUNK = 1 << 16
#: the smallest chunk a short list is cut into
MIN_CHUNK = 1 << 11
#: mt_lamb's group budget B: the bytes of g, p, m and v a group may hold,
#: the last B of each group's stage-1 reads marked to stay in L2 for stage
#: 2 (chosen among 0-40 MB by ``tools/lamb_variants.py`` on an H100, where
#: they all read within 0.2 ms)
LAMB_BUDGET = 16 << 20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# mt_adam's modes (csrc/multi_tensor.cu AdamMode)
ADAM_L2, ADAMW, SWA_APEX_ADAM, SWA_APEX_ADAMW, SWA_PYTORCH_ADAM = range(5)

Scalar = Union[float, torch.Tensor]
Lists = Sequence[Sequence[Optional[torch.Tensor]]]


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def choose_chunk(sizes: Sequence[int], resident: int) -> int:
    """The walker's chunk for tensors of ``sizes``: :data:`CHUNK` where
    that cuts them into at least ``resident`` chunks (the card's resident
    blocks, so every block of the grid has one), else the largest power of
    two no smaller than :data:`MIN_CHUNK` that does (:data:`MIN_CHUNK` if
    none does)."""
    chunk = CHUNK
    while chunk > MIN_CHUNK and sum(_ceil(int(n), chunk)
                                    for n in sizes) < resident:
        chunk //= 2
    return chunk


def table_words(ptrs: Sequence[Sequence[int]], sizes: Sequence[int],
                codes: Sequence[Sequence[int]], chunk: int = CHUNK
                ) -> Tuple[np.ndarray, int]:
    """The walker's int64 words (``csrc/multi_tensor_apply.cuh``) for
    ``T = len(sizes)`` tensors in ``L`` lists, and the chunk count ``C``.
    ``ptrs[t][l]`` is tensor ``t``'s address in list ``l`` (0: none),
    ``codes[t][l]`` its dtype code.  Rows of ``L + 3`` words (the pointers,
    n, meta, first chunk), then one word ``(t << 32) | k`` a chunk."""
    T = len(sizes)
    L = len(ptrs[0]) if T else 0
    counts = [-(-int(n) // chunk) for n in sizes]
    first = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    C = int(first[-1])
    rows = np.zeros((T, L + 3), dtype=np.int64)
    for t in range(T):
        meta = 0
        for l in range(L):
            meta |= int(codes[t][l]) << (4 * l)
        aligned = all(p % 16 == 0 for p in ptrs[t])
        rows[t, :L] = ptrs[t]
        rows[t, L] = sizes[t]
        rows[t, L + 1] = meta | (int(aligned) << 32)
        rows[t, L + 2] = first[t]
    tensor = np.repeat(np.arange(T, dtype=np.int64), counts)
    index = np.arange(C, dtype=np.int64) - np.repeat(first[:-1], counts)
    return np.concatenate([rows.reshape(-1), (tensor << 32) | index]), C


#: a group of at most this many (padded) elements is walked by one block,
#: with no barrier among blocks
LAMB_NARROW = 4 * 512 * 8
#: the teams mt_lamb's grid is cut into, each walking its own wide groups:
#: fewer blocks a barrier and a longer span each (chosen among 1-12 by
#: ``tools/lamb_variants.py`` on an H100: 22 blocks a team)
LAMB_TEAMS = 6


class LambPlan(NamedTuple):
    """``mt_lamb``'s group plan (:func:`lamb_plan`): ``words`` as the kernel
    reads them, and their parts: each group's ``(first, end)`` tensors, its
    span ``S`` (each team block's elements) and padded elements ``E``, each
    tensor's virtual offset in its group and ``[b_lo, b_end)``, the team
    blocks whose spans reach it (a wide group's tensors); ``order``, the
    wide groups then the narrow ones, each in table order (``wide`` of
    them wide); ``team_groups``, the wide ordinals team by team (team
    ``k``'s at ``[team_first[k], team_first[k + 1])``); and ``pieces[wi,
    bt]``, the tensors ``[first, end)`` whose elements reach team block
    ``bt``'s span ``[bt S, bt S + S)`` of the ``wi``-th wide group."""

    words: np.ndarray
    groups: List[Tuple[int, int]]
    span: List[int]
    padded: List[int]
    offsets: np.ndarray
    blocks: np.ndarray
    order: List[int]
    wide: int
    teams: int
    team_first: List[int]
    team_groups: List[int]
    pieces: np.ndarray


def lamb_plan(sizes: Sequence[int], elem_bytes: Sequence[int], budget: int,
              blocks: int, teams: int = 1) -> LambPlan:
    """Cut ``T = len(sizes)`` tensors into groups for ``mt_lamb`` over
    ``blocks`` blocks: runs of consecutive tensors whose bytes
    (``sizes[t] * elem_bytes[t]``, g, p, m and v together) fit ``budget``, a
    tensor larger than ``budget`` a group of its own.  In a group the
    tensors lie end to end, each padded to 8 elements (``E`` in all).  A
    group of at most :data:`LAMB_NARROW` elements is narrow: one block
    walks it whole.  The ``blocks`` are cut into ``teams`` teams of ``Gt =
    blocks / teams``; each wide group goes to the team with the fewest
    bytes so far, and all of that team's blocks walk it, team block ``bt``
    the span ``[bt S, bt S + S)``, ``S`` a multiple of 8 (so every span
    starts 16-byte aligned in every list).  Words (int64): 4 a group (first
    | end << 32, S, E, bytes), T offsets, T block ranges (b_lo | b_end <<
    32), the order, the teams' starts (teams + 1), the wide ordinals team
    by team, then the pieces (first | end << 32), wide group by wide
    group."""
    if teams < 1 or blocks % teams:
        raise ValueError(f"lamb_plan: {blocks} blocks in {teams} teams")
    Gt = blocks // teams
    T = len(sizes)
    sizes = [int(n) for n in sizes]
    bounds, start, held = [], 0, 0
    for t in range(T):
        nb = sizes[t] * int(elem_bytes[t])
        if t > start and held + nb > budget:
            bounds.append((start, t))
            start, held = t, 0
        held += nb
    if T:
        bounds.append((start, T))
    desc = np.zeros((len(bounds), 4), dtype=np.int64)
    offsets = np.zeros(T, dtype=np.int64)
    ranges = np.zeros(T, dtype=np.int64)
    spans, padded, wide, narrow, pieces = [], [], [], [], []
    for gi, (t0, t1) in enumerate(bounds):
        n = np.asarray(sizes[t0:t1], dtype=np.int64)
        pad = -(-n // 8) * 8
        off = np.concatenate([[0], np.cumsum(pad)[:-1]]).astype(np.int64)
        E = int(pad.sum())
        S = max(8, _ceil(_ceil(E, Gt), 8) * 8)
        offsets[t0:t1] = off
        nbytes = sum(sizes[t] * int(elem_bytes[t]) for t in range(t0, t1))
        desc[gi] = (t0 | (t1 << 32), S, E, nbytes)
        spans.append(S)
        padded.append(E)
        if E <= LAMB_NARROW:
            narrow.append(gi)
            continue
        wide.append(gi)
        lo = np.minimum(E, np.arange(Gt, dtype=np.int64) * S)
        hi = np.minimum(E, lo + S)
        # the first tensor whose real elements end past lo; the first from
        # there that starts at hi or later
        first = np.searchsorted(off + n, lo, side="right")
        end = np.maximum(first, np.searchsorted(off, hi, side="left"))
        pieces.append((t0 + first) | ((t0 + end) << 32))
        b_lo = off // S
        b_end = np.where(n > 0, (off + n - 1) // S + 1, b_lo)
        ranges[t0:t1] = np.where(n > 0, b_lo | (b_end << 32), 0)
    # each wide group to the team with the fewest bytes so far
    held_by = [0] * teams
    team_of = []
    for gi in wide:
        k = held_by.index(min(held_by))
        team_of.append(k)
        held_by[k] += int(desc[gi, 3])
    team_groups = sorted(range(len(wide)), key=lambda q: (team_of[q], q))
    team_first = [sum(1 for k in team_of if k < tm) for tm in range(teams + 1)]
    piece_words = (np.stack(pieces) if pieces
                   else np.zeros((0, Gt), dtype=np.int64))
    words = np.concatenate([desc.reshape(-1), offsets, ranges,
                            np.asarray(wide + narrow + team_first + team_groups,
                                       dtype=np.int64),
                            piece_words.reshape(-1)])
    return LambPlan(words, bounds, spans, padded, offsets, ranges,
                    wide + narrow, len(wide), teams, team_first, team_groups,
                    piece_words)


_BLOCKS: Dict[str, int] = {}


def _blocks(symbol: str) -> int:
    """A resident-block count the library computes once (sm count times
    the occupancy at 512 threads)."""
    got = _BLOCKS.get(symbol)
    if got is None:
        fn = getattr(_build.library(MT_ADAM.source), symbol)
        fn.argtypes, fn.restype = [], ctypes.c_int
        got = _BLOCKS[symbol] = int(fn())
    return got


def resident_blocks() -> int:
    """The most blocks any walker kernel keeps resident on the current
    card: the chunk count a list should reach (:func:`choose_chunk`)."""
    return _blocks("apex_mt_resident_blocks")


def lamb_ring(lists: Sequence[Sequence[torch.Tensor]]) -> int:
    """``mt_lamb``'s ring of g, p, m and v (``lists[:4]``): each list's
    16-byte chunks an 8-element vector (2 where the list holds an fp32
    tensor, else 1), 2 bits a list."""
    code = 0
    for l, xs in enumerate(lists[:4]):
        code |= (2 if any(x.dtype == torch.float32 for x in xs) else 1) << (2 * l)
    return code


def lamb_list_plan(lists: Sequence[Sequence[torch.Tensor]], budget: int
                   ) -> Tuple[LambPlan, int, int]:
    """The plan ``mt_lamb`` walks for its lists (g, p, m, v first) on the
    current card under ``budget``, with its ring and grid: what the table
    carries."""
    ring = lamb_ring(lists)
    blocks = lamb_blocks(ring)
    teams = LAMB_TEAMS if blocks % LAMB_TEAMS == 0 else 1
    rows = list(zip(*lists[:4]))
    plan = lamb_plan([row[0].numel() for row in rows],
                     [sum(t.element_size() for t in row) for row in rows],
                     budget, blocks, teams)
    return plan, ring, blocks


def lamb_blocks(ring: int) -> int:
    """The grid of ``mt_lamb``'s cooperative launch on the current card
    with ``ring`` (:func:`lamb_ring`; the ring's shared memory sets the
    occupancy): the blocks its plan splits each group over."""
    key = f"apex_mt_lamb_blocks/{ring}"
    got = _BLOCKS.get(key)
    if got is None:
        fn = _build.library(MT_LAMB.source).apex_mt_lamb_blocks
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        got = _BLOCKS[key] = int(fn(ring))
        if got < 1:
            raise RuntimeError(f"mt_lamb: no resident block with ring {ring}")
    return got


class _Table(NamedTuple):
    words: torch.Tensor      # int64, on the device (then the plan's words)
    host: torch.Tensor       # the pinned source of its copy
    T: int
    L: int
    C: int
    chunk: int
    plan_at: int             # mt_lamb: the plan's first word, else -1
    groups: int              # mt_lamb: the plan's groups, else 0
    wide: int                # mt_lamb: its wide groups, else 0
    teams: int               # mt_lamb: the teams of its grid, else 1
    ring: int                # mt_lamb: its ring (lamb_ring), else 0
    blocks: int              # mt_lamb: the grid it was planned for, else 0
    budget: int              # mt_lamb: the budget it was planned for


_TABLES: "collections.OrderedDict[tuple, _Table]" = collections.OrderedDict()
_TABLES_KEPT = 64
_CAPTURED: List[_Table] = []


def _table(op: str, lists: Lists, allowed: Sequence[Sequence[torch.dtype]],
           lamb_budget: Optional[int] = None) -> Tuple[_Table, torch.device]:
    """The device table of ``lists`` (``L`` lists of ``T`` tensors, None
    where an optional list has no tensor) and their device, with
    ``mt_lamb``'s group plan for ``lamb_budget`` where one is given.  A
    table is cached under the current device, the budget and every
    tensor's address, size, dtype and contiguity, so a hit is a set of
    tensors ``_check_lists`` passed before; a miss is checked, then
    built."""
    device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, lamb_budget, len(lists), len(lists[0]),
           tuple((t.data_ptr(), t.numel(), t.dtype, t.is_contiguous())
                 if t is not None else None for xs in lists for t in xs))
    tab = _TABLES.get(key)
    if tab is None:
        _check_lists(op, lists, allowed, device)
        rows = list(zip(*lists))
        ptrs = [[t.data_ptr() if t is not None else 0 for t in row]
                for row in rows]
        codes = [[_DTYPE_CODES[t.dtype] if t is not None else 0 for t in row]
                 for row in rows]
        sizes = [next(t for t in row if t is not None).numel() for row in rows]
        chunk = choose_chunk(sizes, resident_blocks())
        words, C = table_words(ptrs, sizes, codes, chunk)
        plan_at, groups, wide, ring, blocks, teams = -1, 0, 0, 0, 0, 1
        if lamb_budget is not None:
            plan, ring, blocks = lamb_list_plan(lists, lamb_budget)
            plan_at, groups, wide = words.size, len(plan.groups), plan.wide
            teams = plan.teams
            words = np.concatenate([words, plan.words])
        host = torch.from_numpy(words).pin_memory()
        tab = _Table(host.to(device, non_blocking=True), host, len(rows),
                     len(lists), C, chunk, plan_at, groups, wide, teams,
                     ring, blocks, -1 if lamb_budget is None else lamb_budget)
        _TABLES[key] = tab
        if len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    if torch.cuda.is_current_stream_capturing():
        _CAPTURED.append(tab)
    return tab, device


def _check_lists(op: str, lists: Lists, allowed: Sequence[Sequence[torch.dtype]],
                 device: torch.device) -> None:
    """Raise on what the kernels do not take: lists of one length, every
    tensor contiguous on ``device`` (the current one), the tensors of one
    index of one size, each dtype one its list takes."""
    T = len(lists[0])
    if T < 1:
        raise ValueError(f"{op}: empty tensor lists")
    for l, (xs, ok) in enumerate(zip(lists, allowed)):
        if len(xs) != T:
            raise ValueError(f"{op}: list {l} holds {len(xs)} tensors, list 0 "
                             f"{T}")
        for t, x in enumerate(xs):
            if x is None:
                continue
            if x.device != device or not x.is_contiguous():
                raise ValueError(f"{op}: tensor {t} of list {l} must be "
                                 f"contiguous on {device}, got {x.device}")
            if x.dtype not in ok:
                raise TypeError(f"{op}: tensor {t} of list {l} is {x.dtype}; "
                                f"the kernel takes {list(ok)}")
            if x.numel() != lists[0][t].numel():
                raise ValueError(f"{op}: tensor {t} of list {l} has "
                                 f"{x.numel()} elements, of list 0 "
                                 f"{lists[0][t].numel()}")


def device_scalar(value: Optional[Scalar], device) -> Optional[torch.Tensor]:
    """``value`` as a 0-d fp32 tensor on ``device``: a number is filled in
    on the device (no copy from the host), a tensor converted there; None
    stays None."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        if value.device != torch.device(device):
            raise ValueError(f"a step scalar lies on {value.device}, the "
                             f"tensors on {device}")
        return value.reshape(()).to(torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


def _on_card(lists: Lists, *scalars: Optional[torch.Tensor]) -> bool:
    """``_dispatch``'s rule for a call over lists: the kernel where the
    first tensor lies on CUDA (the kernel's checks then hold every other
    one to that device), the plain version where all lie on the CPU;
    ``kernel_path`` raises on a mix.  Looking at one tensor, not every
    one, keeps a step's host time off the lists' length."""
    first = lists[0][0]
    if first.device.type == "cuda":
        return kernel_path(first, *scalars)
    return kernel_path(*(t for xs in lists for t in xs), *scalars)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_F32 = (torch.float32,)
_ANY = tuple(_DTYPE_CODES)


def _check_scalars(op: str, device: torch.device, **scalars) -> None:
    """Raise unless each given step scalar is one element of its dtype on
    ``device`` (``name=(tensor or None, dtype)``)."""
    for name, (t, dtype) in scalars.items():
        if t is not None and (t.device != device or t.dtype != dtype
                              or t.numel() != 1):
            raise ValueError(f"{op}: {name} must be one {dtype} element on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _symbol(kernel: Kernel, argtypes):
    fn = getattr(_build.library(kernel.source), kernel.symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HEAD = [_vp, _i, _i, _i, _i]           # table words, T, L, C, chunk


def _head(tab: _Table) -> tuple:
    return tab.words.data_ptr(), tab.T, tab.L, tab.C, tab.chunk


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# mt_l2norm
# ---------------------------------------------------------------------------


class L2Norm(NamedTuple):
    """``l2norm``'s result, fp32 on the tensors' device: the global norm
    (0-d), each tensor's norm and sum of squares (``[T]``), and the
    non-finite flag (0-d int32: 1 where the global sum of squares is not
    finite)."""

    total: torch.Tensor
    per_tensor: torch.Tensor
    flag: torch.Tensor
    per_tensor_sq: torch.Tensor


def _plain_l2norm(xs, inv_scale) -> L2Norm:
    sq = []
    for x in xs:
        x32 = x.float()
        if inv_scale is not None:
            x32 = x32 * inv_scale
        sq.append(torch.sum(x32 * x32))
    sq = torch.stack(sq)
    total = torch.sqrt(torch.sum(sq))
    return L2Norm(total, torch.sqrt(sq),
                  (~torch.isfinite(total)).to(torch.int32), sq)


def _kernel_l2norm(xs, inv_scale) -> L2Norm:
    tab, device = _table("mt_l2norm", [xs], [_ANY])
    _check_scalars("mt_l2norm", device, inv_scale=(inv_scale, torch.float32))
    partials = torch.empty(tab.C + tab.T, dtype=torch.float32, device=device)
    out = torch.empty(tab.T + 1, dtype=torch.float32, device=device)
    flag = torch.empty(1, dtype=torch.int32, device=device)
    status = _symbol(MT_L2NORM, _HEAD + [_vp] * 4 + [_vp])(
        *_head(tab), _ptr(inv_scale),
        partials.data_ptr(), out.data_ptr(), flag.data_ptr(), _stream())
    _build.check(status, "mt_l2norm")
    MT_L2NORM.launches += 1
    return L2Norm(out[0], out[1:], flag[0], partials[tab.C:])


def l2norm(xs: Sequence[torch.Tensor],
           inv_scale: Optional[Scalar] = None) -> L2Norm:
    """The L2 norms of ``xs`` (of ``x * inv_scale`` with a scale), each
    element's square summed in fp32: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    xs = list(xs)
    if not xs:
        raise ValueError("l2norm: no tensors")
    inv = device_scalar(inv_scale, xs[0].device)
    if _on_card([xs], inv):
        return _kernel_l2norm(xs, inv)
    return _plain_l2norm(xs, inv)


# ---------------------------------------------------------------------------
# mt_scale
# ---------------------------------------------------------------------------


def _plain_scale(xs, outs, scale_, check: bool) -> Optional[torch.Tensor]:
    flag = None
    if check:
        flag = torch.stack([~torch.all(torch.isfinite(x)) for x in xs]).any()
    if outs is not None:
        for x, o in zip(xs, outs):
            o.copy_(x.float() * scale_)
    return flag


def _kernel_scale(xs, outs, scale_, check: bool) -> Optional[torch.Tensor]:
    lists = [xs] if outs is None else [xs, outs]
    tab, device = _table("mt_scale", lists, [_ANY, _ANY])
    if isinstance(scale_, torch.Tensor):
        _check_scalars("mt_scale", device, scale=(scale_, torch.float32))
    flag = torch.zeros((), dtype=torch.bool, device=device) if check else None
    ptr, value = ((scale_.data_ptr(), 0.0) if isinstance(scale_, torch.Tensor)
                  else (None, float(scale_)))
    status = _symbol(MT_SCALE, _HEAD + [_vp, _f, _vp, _vp])(
        *_head(tab), ptr, value,
        _ptr(flag), _stream())
    _build.check(status, "mt_scale")
    MT_SCALE.launches += 1
    return flag


def scale(xs: Sequence[torch.Tensor],
          outs: Optional[Sequence[torch.Tensor]], scale_: Scalar,
          check: bool = True) -> Optional[torch.Tensor]:
    """``out = x * scale`` in fp32, stored in each output's dtype (``outs``
    may be ``xs``: in place), and with ``check`` a 0-d bool on the device,
    true if any ``x`` holds an inf or a NaN (before scaling).  ``outs``
    None is the check alone.  ``scale_`` is a number or a 0-d fp32 tensor
    on the tensors' device."""
    xs = list(xs)
    if not xs:
        raise ValueError("scale: no tensors")
    if outs is None and not check:
        raise ValueError("scale: no output and no check")
    outs = None if outs is None else list(outs)
    s = scale_
    if isinstance(s, torch.Tensor):
        s = device_scalar(s, xs[0].device)
    if _on_card([xs, outs or []],
                s if isinstance(s, torch.Tensor) else None):
        return _kernel_scale(xs, outs, s, check)
    return _plain_scale(xs, outs, s, check)


# ---------------------------------------------------------------------------
# mt_adam
# ---------------------------------------------------------------------------


def _commit(dst: torch.Tensor, new: torch.Tensor,
            skip: Optional[torch.Tensor]) -> None:
    """``dst = new`` in ``dst``'s dtype, or ``skip ? dst : new``."""
    if skip is None:
        dst.copy_(new)
    else:
        torch.where(skip, dst, new.to(dst.dtype), out=dst)


def _fused_adam_element(mode, p, g, m, v, lr, beta1, beta2, eps, wd, bc1, bc2):
    """``FusedAdam``'s plain update of one tensor: new fp32 ``(p, m, v)``,
    bc1 folded into the denominator (the inputs are not written; an fp32
    op on a bf16/fp16 operand widens it exactly)."""
    p32 = p.float()
    if mode == ADAM_L2 and wd:
        g = p32.mul(wd).add_(g)
    m_new = m.float().mul(beta1).add_(g, alpha=1.0 - beta1)
    v_new = v.float().mul(beta2).addcmul_(g, g, value=1.0 - beta2)
    denom = v_new.div(bc2).sqrt_().add_(eps).mul_(bc1)
    if mode == ADAMW and wd:
        p32 = p32.mul(1.0 - lr * wd)
    return p32.addcdiv(m_new, denom, value=-lr), m_new, v_new


def _swa_element(mode, p32, g, m, v, lr, beta1, beta2, eps, wd, bc1, bc2):
    """``FusedAdamSWA``'s plain Adam step of one fp32 master: the JAX
    function's expressions in its order."""
    if mode in (SWA_APEX_ADAM, SWA_PYTORCH_ADAM):
        g = g + wd * p32
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    if mode == SWA_PYTORCH_ADAM:
        denom = torch.sqrt(v_new) / torch.sqrt(bc2) + eps
        p_new = p32 - (lr / bc1) * (m_new / denom)
    else:
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if mode == SWA_APEX_ADAMW:
            update = update + wd * p32
        p_new = p32 - lr * update
    return p_new, m_new, v_new


def _plain_adam(g, p, m, v, copy, swa, *, mode, lr, beta1, beta2, eps,
                weight_decay, inv_scale, bc1, bc2, noop, step, n_averaged,
                swa_weight, swa_start_step) -> None:
    swa_mode = mode >= SWA_APEX_ADAM
    if swa_mode:
        one = torch.ones((), dtype=torch.float32, device=p[0].device)
        bc1 = one if bc1 is None else bc1
        bc2 = one if bc2 is None else bc2
        do_swa = step > swa_start_step
    else:
        bc1 = 1.0 if bc1 is None else bc1
        bc2 = 1.0 if bc2 is None else bc2
    for i in range(len(g)):
        g32 = g[i].float()
        if inv_scale is not None:
            g32 = g32 * inv_scale
        args = (mode, p[i], g32, m[i], v[i], lr, beta1, beta2, eps,
                weight_decay, bc1, bc2)
        p_new, m_new, v_new = (_swa_element if swa_mode
                               else _fused_adam_element)(*args)
        news = [(p[i], p_new), (m[i], m_new), (v[i], v_new)]
        if copy is not None and copy[i] is not None:
            news.append((copy[i], p_new))
        if swa_mode:
            avg = swa[i]
            averaged = torch.where(n_averaged == 0, p_new,
                                   avg + swa_weight * (p_new - avg))
            news.append((avg, torch.where(do_swa, averaged, avg)))
        for dst, new in news:
            _commit(dst, new, noop)


def _kernel_adam(g, p, m, v, copy, swa, *, mode, lr, beta1, beta2, eps,
                 weight_decay, inv_scale, bc1, bc2, noop, step, n_averaged,
                 swa_weight, swa_start_step) -> None:
    T = len(g)
    none = [None] * T
    lists = [g, p, m, v, none if copy is None else copy,
             none if swa is None else swa]
    tab, device = _table("mt_adam", lists,
                         [_ANY, _ANY, _ANY, _ANY, _ANY, _F32])
    _check_scalars("mt_adam", device, inv_scale=(inv_scale, torch.float32),
                   bc1=(bc1, torch.float32), bc2=(bc2, torch.float32),
                   noop=(noop, torch.bool), step=(step, torch.int32),
                   n_averaged=(n_averaged, torch.int32))
    if tab.C == 0:
        return
    status = _symbol(MT_ADAM, _HEAD + [_i] + [_f] * 9 + [_i] + [_vp] * 7)(
        *_head(tab), mode, lr, beta1,
        beta2, 1.0 - beta1, 1.0 - beta2, eps, weight_decay,
        1.0 - lr * weight_decay, swa_weight, swa_start_step, _ptr(inv_scale),
        _ptr(bc1), _ptr(bc2), _ptr(noop), _ptr(step), _ptr(n_averaged),
        _stream())
    _build.check(status, "mt_adam")
    MT_ADAM.launches += 1


@torch.no_grad()
def adam(g: Sequence[torch.Tensor], p: Sequence[torch.Tensor],
         m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], *, mode: int,
         lr: float, beta1: float, beta2: float, eps: float,
         weight_decay: float, inv_scale: Optional[torch.Tensor] = None,
         bc1: Optional[torch.Tensor] = None,
         bc2: Optional[torch.Tensor] = None,
         noop: Optional[torch.Tensor] = None,
         copy: Optional[Sequence[torch.Tensor]] = None,
         swa: Optional[Sequence[torch.Tensor]] = None,
         step: Optional[torch.Tensor] = None,
         n_averaged: Optional[torch.Tensor] = None,
         swa_weight: float = 0.0, swa_start_step: int = 0) -> None:
    """One Adam step over every tensor of the lists, in place: ``p`` (the
    parameters or their fp32 masters), ``m`` and ``v`` updated, ``copy``
    (the model parameters, when ``p`` holds masters) given the new ``p`` in
    their own dtypes, ``g`` read and multiplied by ``inv_scale``.  Modes:
    :data:`ADAM_L2` / :data:`ADAMW` (``FusedAdam``), or the SWA modes
    (``FusedAdamSWA``: ``swa`` the fp32 averages, ``step`` the int32 step
    this update makes, ``n_averaged`` the averages taken before it, both
    0-d on the device).  ``bc1``/``bc2`` are 0-d fp32 device tensors (None:
    1), ``noop`` a 0-d bool: true keeps every bit."""
    g, p, m, v = list(g), list(p), list(m), list(v)
    if not g:
        return
    kw = dict(mode=mode, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, inv_scale=inv_scale, bc1=bc1,
              bc2=bc2, noop=noop, step=step, n_averaged=n_averaged,
              swa_weight=swa_weight, swa_start_step=swa_start_step)
    if mode >= SWA_APEX_ADAM and (swa is None or step is None
                                  or n_averaged is None):
        raise ValueError("adam: the SWA modes take swa, step and n_averaged")
    if _on_card([g, p, m, v, copy or [], swa or []], inv_scale, bc1, bc2,
                noop, step, n_averaged):
        _kernel_adam(g, p, m, v, copy, swa, **kw)
    else:
        _plain_adam(g, p, m, v, copy, swa, **kw)


# ---------------------------------------------------------------------------
# mt_lamb
# ---------------------------------------------------------------------------


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def _apply_step(p32, update, step_):
    """``p32 - step * update`` (``step_`` a number or a 0-d tensor)."""
    if isinstance(step_, torch.Tensor):
        return p32.addcmul(update, step_, value=-1.0)
    return p32.add(update, alpha=-step_)


def _plain_lamb(g, p, m, v, copy, *, lr, beta1, beta2, beta3, eps,
                weight_decay, adam_w_mode, use_ratio, inv_scale, clip, bc1,
                bc2, noop, n_ratio=None) -> None:
    wd = weight_decay
    n_ratio = len(g) if n_ratio is None else n_ratio
    bc1 = 1.0 if bc1 is None else bc1
    bc2 = 1.0 if bc2 is None else bc2
    clip = 1.0 if clip is None else clip
    for i in range(len(g)):
        p32 = p[i].float()
        g32 = g[i].float()
        if inv_scale is not None:
            g32 = g32 * inv_scale
        g32 = g32 / clip
        if not adam_w_mode and wd:
            g32.add_(p32, alpha=wd)
        m_new = m[i].float().mul(beta1).add_(g32, alpha=beta3)
        v_new = v[i].float().mul(beta2).addcmul_(g32, g32, value=1.0 - beta2)
        update = torch.div(m_new, bc1).div_(v_new.div(bc2).sqrt_().add_(eps))
        if adam_w_mode and wd:
            update.add_(p32, alpha=wd)
        step_ = lr
        if use_ratio and i < n_ratio:
            p_norm, u_norm = _sqnorm(p32), _sqnorm(update)
            ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                                1.0)
            step_ = ratio * lr
        p_new = _apply_step(p32, update, step_)
        news = [(p[i], p_new), (m[i], m_new), (v[i], v_new)]
        if copy is not None and copy[i] is not None:
            news.append((copy[i], p_new))
        for dst, new in news:
            _commit(dst, new, noop)


def _kernel_lamb(g, p, m, v, copy, *, lr, beta1, beta2, beta3, eps,
                 weight_decay, adam_w_mode, use_ratio, inv_scale, clip, bc1,
                 bc2, noop, n_ratio=None) -> None:
    T = len(g)
    lists = [g, p, m, v, [None] * T if copy is None else copy]
    tab, device = _table("mt_lamb", lists, [_ANY] * 5, LAMB_BUDGET)
    lr_ptr = lr if isinstance(lr, torch.Tensor) else None
    _check_scalars("mt_lamb", device, inv_scale=(inv_scale, torch.float32),
                   clip=(clip, torch.float32), bc1=(bc1, torch.float32),
                   bc2=(bc2, torch.float32), lr=(lr_ptr, torch.float32),
                   noop=(noop, torch.bool))
    if tab.C == 0:
        return
    # partials, ratios, each wide group's two barrier counters (zeroed by
    # the launch)
    scratch = torch.empty(2 * (tab.wide * (tab.blocks // tab.teams) + T) + T
                          + 2 * max(tab.wide, 1),
                          dtype=torch.float32, device=device)
    status = _symbol(MT_LAMB, _HEAD + [_vp] + [_i] * 5 + [ctypes.c_longlong]
                     + [_f] * 7 + [_i] * 3 + [_vp] * 8)(
        *_head(tab), tab.words.data_ptr() + 8 * tab.plan_at, tab.groups,
        tab.wide, tab.teams, tab.blocks, tab.ring, tab.budget, beta1, beta3, beta2, 1.0 - beta2, eps, weight_decay,
        0.0 if lr_ptr is not None else float(lr), int(adam_w_mode),
        int(use_ratio), T if n_ratio is None else n_ratio, _ptr(inv_scale),
        _ptr(clip), _ptr(bc1), _ptr(bc2), _ptr(lr_ptr), _ptr(noop),
        scratch.data_ptr(), _stream())
    _build.check(status, "mt_lamb")
    MT_LAMB.launches += 1


@torch.no_grad()
def lamb(g: Sequence[torch.Tensor], p: Sequence[torch.Tensor],
         m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], *,
         lr: Scalar, beta1: float, beta2: float, beta3: float, eps: float,
         weight_decay: float, adam_w_mode: bool, use_ratio: bool,
         inv_scale: Optional[torch.Tensor] = None,
         clip: Optional[torch.Tensor] = None,
         bc1: Optional[torch.Tensor] = None,
         bc2: Optional[torch.Tensor] = None,
         noop: Optional[torch.Tensor] = None,
         copy: Optional[Sequence[torch.Tensor]] = None) -> None:
    """One LAMB step over every tensor of the lists, in place, with the
    unpacked ``FusedLAMB``'s arithmetic: ``g * inv_scale / clip`` (L2 decay
    into it without ``adam_w_mode``), the moments, ``u = (m / bc1) /
    (sqrt(v / bc2) + eps)`` (+ ``wd p`` with ``adam_w_mode``), then ``p -=
    lr ratio u`` with ``ratio = ||p|| / ||u||`` per tensor where
    ``use_ratio`` (1 where either norm is 0), else 1.  ``lr`` is a number
    or a 0-d fp32 device tensor; ``copy`` as in :func:`adam`; ``noop`` true
    keeps every bit."""
    g, p, m, v = list(g), list(p), list(m), list(v)
    if not g:
        return
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, beta3=beta3, eps=eps,
              weight_decay=weight_decay, adam_w_mode=adam_w_mode,
              use_ratio=use_ratio, inv_scale=inv_scale, clip=clip, bc1=bc1,
              bc2=bc2, noop=noop)
    if _on_card([g, p, m, v, copy or []], inv_scale, clip, bc1, bc2, noop,
                lr if isinstance(lr, torch.Tensor) else None):
        _kernel_lamb(g, p, m, v, copy, **kw)
    else:
        _plain_lamb(g, p, m, v, copy, **kw)


def _plain_lamb_apply(p, u, lr, norms, n_ratio) -> None:
    for i, (pv, uv) in enumerate(zip(p, u)):
        step_ = lr
        if norms is not None and i < n_ratio:
            pn, un = norms[i], norms[n_ratio + i]
            step_ = torch.where((pn > 0) & (un > 0), pn / un, 1.0) * lr
        pv.copy_(_apply_step(pv, uv, step_))


def _kernel_lamb_apply(p, u, lr, norms, n_ratio) -> None:
    tab, device = _table("mt_lamb", [p, u], [_ANY, _F32])
    if norms is not None and (norms.device != device or norms.dtype != torch.float32
                              or tuple(norms.shape) != (2 * n_ratio,)
                              or not norms.is_contiguous()):
        raise ValueError(f"mt_lamb: norms must be a contiguous fp32 "
                         f"[{2 * n_ratio}] tensor on {device}")
    if tab.C == 0:
        return
    fn = getattr(_build.library(MT_LAMB.source), "apex_mt_lamb_apply")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _HEAD + [_f, _i, _vp, _vp], ctypes.c_int
    status = fn(*_head(tab), float(lr), n_ratio, _ptr(norms), _stream())
    _build.check(status, "mt_lamb")
    MT_LAMB.launches += 1


@torch.no_grad()
def lamb_apply(p: Sequence[torch.Tensor], u: Sequence[torch.Tensor], *,
               lr: float, norms: Optional[torch.Tensor] = None,
               n_ratio: int = 0) -> None:
    """LAMB's stage 2 over given fp32 updates: ``p -= lr ratio u`` in
    place, tensor by tensor, with ``ratio = norms[t] / norms[n_ratio + t]``
    (1 where either is 0) for ``t < n_ratio`` and 1 for the rest or without
    ``norms`` (the packed LAMB's phase 2 over its leaves' views)."""
    p, u = list(p), list(u)
    if not p:
        return
    if _on_card([p, u], norms):
        _kernel_lamb_apply(p, u, lr, norms, n_ratio)
    else:
        _plain_lamb_apply(p, u, lr, norms, n_ratio)
