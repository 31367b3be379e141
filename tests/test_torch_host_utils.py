"""The port's small host modules against the JAX package's:

- the host packing pair (``utils.packing.host_{flatten,unflatten}_dense_
  tensors``, copied by ``csrc/packing.cpp`` through ctypes) against
  ``apex_tpu.utils.packing``'s and against the numpy loops written here,
  bit for bit, over dtypes, shapes, non-contiguous inputs and the empty
  list, with the JAX module's errors;
- ``utils.nvtx``'s host half (the CPU build of PyTorch has no NVTX): the
  ``range`` spans in a ``torch.profiler`` trace, the push / pop depths,
  an unmatched pop;
- ``feature_registry``: each record's kernels are the dispatch table's,
  and nothing in it switches a kernel;
- ``transformer.log_util``: the loggers under the port's root.
"""

import logging

import numpy as np
import pytest
import torch

from apex_tpu_torch.utils import packing

ARRAY_SETS = {
    "fp32": [np.arange(6, dtype=np.float32).reshape(2, 3),
             np.full((), 7, np.float32), np.ones((4, 1, 2), np.float32)],
    "bf16-bits": [np.arange(5, dtype=np.uint16), np.zeros((3, 3), np.uint16)],
    "int64-strided": [np.arange(20, dtype=np.int64).reshape(4, 5)[:, ::2],
                      np.arange(3, dtype=np.int64)],
    "fp64-one": [np.linspace(0, 1, 33)],
}


def host_flatten_plain(arrays) -> np.ndarray:
    """The numpy loop ``host_flatten_dense_tensors`` stands for."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    out = np.empty((sum(a.size for a in arrays),),
                   arrays[0].dtype if arrays else np.float32)
    at = 0
    for a in arrays:
        out[at:at + a.size] = a.ravel()
        at += a.size
    return out


def host_unflatten_plain(flat, like):
    """The numpy loop ``host_unflatten_dense_tensors`` stands for."""
    outs, at = [], 0
    for t in like:
        n = int(np.prod(np.shape(t)))
        outs.append(flat[at:at + n].reshape(np.shape(t)).copy())
        at += n
    return outs


@pytest.mark.parametrize("name", list(ARRAY_SETS))
def test_host_flatten_unflatten_match_jax_and_the_plain_loops(name):
    from apex_tpu.utils import packing as jpacking

    arrays = ARRAY_SETS[name]
    flat = packing.host_flatten_dense_tensors(arrays)
    ref = jpacking.host_flatten_dense_tensors(arrays)
    assert flat.dtype == ref.dtype and flat.shape == ref.shape
    np.testing.assert_array_equal(flat, ref)
    np.testing.assert_array_equal(flat, host_flatten_plain(arrays))
    outs = packing.host_unflatten_dense_tensors(flat, arrays)
    for out, r, p, a in zip(outs, jpacking.host_unflatten_dense_tensors(
            ref, arrays), host_unflatten_plain(flat, arrays),
            arrays):
        assert out.shape == a.shape and out.dtype == flat.dtype
        np.testing.assert_array_equal(out, r)
        np.testing.assert_array_equal(out, p)
        np.testing.assert_array_equal(out, a)


def test_host_packing_edge_cases_and_errors_match_jax():
    from apex_tpu.utils import packing as jpacking

    empty = packing.host_flatten_dense_tensors([])
    assert empty.shape == (0,) and empty.dtype == np.float32
    assert jpacking.host_flatten_dense_tensors([]).dtype == empty.dtype
    cases = [
        (packing.host_flatten_dense_tensors,
         jpacking.host_flatten_dense_tensors,
         ([np.ones(2, np.float32), np.ones(2, np.float64)],)),
        (packing.host_unflatten_dense_tensors,
         jpacking.host_unflatten_dense_tensors,
         (np.ones(3, np.float32), [np.ones(4, np.float32)])),
        (packing.host_unflatten_dense_tensors,
         jpacking.host_unflatten_dense_tensors,
         (np.ones(4, np.float32), [np.ones(4, np.float64)])),
    ]
    for port_fn, jax_fn, args in cases:
        with pytest.raises(ValueError) as got:
            port_fn(*args)
        with pytest.raises(ValueError) as want:
            jax_fn(*args)
        assert str(got.value) == str(want.value)
    # a longer flat buffer leaves its tail unread, as in JAX
    out = packing.host_unflatten_dense_tensors(np.arange(5, dtype=np.int32),
                                               [np.zeros((2, 2), np.int32)])
    np.testing.assert_array_equal(out[0], [[0, 1], [2, 3]])


def test_native_library_builds_into_build_and_reports_its_bytes():
    from apex_tpu_torch.ops._build import BUILD_DIR
    from apex_tpu_torch.utils import _native

    lib = _native.lib()
    assert lib is _native.lib()             # built and loaded once
    assert any(BUILD_DIR.glob("packing-*.so"))
    a = [np.arange(3, dtype=np.float32), np.arange(5, dtype=np.float32)]
    out = np.empty(8, np.float32)
    assert _native.flatten_into(a, out) == 32
    back = [np.empty(3, np.float32), np.empty(5, np.float32)]
    assert _native.unflatten_from(out, back) == 32
    np.testing.assert_array_equal(np.concatenate(back), out)


def test_nvtx_host_spans_and_the_push_pop_stack():
    from apex_tpu_torch.utils import nvtx

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with nvtx.range("outer"):
            assert nvtx.range_push("inner") == 1
            torch.ones(4).sum()
            assert nvtx.range_push("innermost") == 2
            assert nvtx.range_pop() == 2
            assert nvtx.range_pop() == 1
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner", "innermost"} <= names
    with pytest.raises(RuntimeError, match="without a matching"):
        nvtx.range_pop()
    # the range closes its span when its body raises
    with pytest.raises(ValueError):
        with nvtx.range("raising"):
            raise ValueError
    assert nvtx._stack == []


def test_feature_registry_records_the_dispatch_kernels():
    from apex_tpu_torch import feature_registry as fr
    from apex_tpu_torch.ops import _dispatch

    known = {k.name for k in _dispatch.KERNELS}
    feats = fr.available_features()
    assert {"flash_attention", "fused_layer_norm", "fused_lm_head",
            "multi_tensor_apply", "pair_bias_attention", "fused_rope",
            "amp"} <= set(feats)
    for name, f in feats.items():
        assert isinstance(f, fr.Feature) and f.name == name
        assert f.cuda == bool(f.kernels) and set(f.kernels) <= known, name
        assert f.plain
    # every kernel of the dispatch table belongs to some feature
    assert known == {k for f in feats.values() for k in f.kernels}
    assert not feats["fused_rope"].cuda
    assert fr.on_cuda() == torch.cuda.is_available()
    # introspection only: a copy, and no switch
    feats.clear()
    assert fr.available_features()
    assert not any(hasattr(fr, n) for n in ("pallas_enabled", "cuda_enabled",
                                            "disable"))


def test_log_util_loggers_under_the_port_root():
    from apex_tpu.transformer import log_util as jlog

    from apex_tpu_torch.transformer import log_util

    lg = log_util.get_transformer_logger("pipeline_parallel")
    assert lg.name == "apex_tpu_torch.transformer.pipeline_parallel"
    assert jlog.get_transformer_logger("pipeline_parallel").name == \
        lg.name.replace("apex_tpu_torch", "apex_tpu")
    root = logging.getLogger("apex_tpu_torch")
    before = root.level
    try:
        log_util.set_logging_level(logging.DEBUG)
        assert root.level == logging.DEBUG
        assert lg.getEffectiveLevel() == logging.DEBUG
    finally:
        root.setLevel(before)
