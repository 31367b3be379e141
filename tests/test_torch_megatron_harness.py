"""The Megatron harness of ``apex_tpu_torch.transformer.testing``
(``arguments.py``, ``global_vars.py``) against ``apex_tpu``'s:

- ``parse_args`` over a table of argument lists and world sizes: every
  derived field equal to JAX's (``params_dtype`` as the same dtype's
  name), or the same error with the same message; ``defaults``,
  ``override_args`` and ``ignore_unknown_args``;
  ``core_transformer_config_from_args``;
- the global singletons: the errors before and after initialization, a
  failed initialization leaving them unset, the microbatch counts and
  global batch sizes of a ``--rampup-batch-size`` run step by step, and
  ``destroy_global_vars``.

Outside a ``torch.distributed`` world both packages read ``RANK`` and
``WORLD_SIZE`` from the environment.
"""

import pytest
import torch

from apex_tpu_torch.transformer import testing as tt

NET = ["--num-layers", "4", "--hidden-size", "64",
       "--num-attention-heads", "4"]

CASES = {
    "minimal": (1, NET),
    "tp2-pp2-dp2": (8, NET + ["--tensor-model-parallel-size", "2",
                              "--pipeline-model-parallel-size", "2",
                              "--micro-batch-size", "2",
                              "--global-batch-size", "16"]),
    "clamped": (8, NET + ["--tensor-model-parallel-size", "16",
                          "--pipeline-model-parallel-size", "2"]),
    "tp-does-not-divide": (6, NET + ["--tensor-model-parallel-size", "4"]),
    "tp-pp-does-not-divide": (8, NET + ["--tensor-model-parallel-size", "2",
                                        "--pipeline-model-parallel-size",
                                        "3"]),
    "virtual": (4, ["--num-layers", "8", "--hidden-size", "64",
                    "--num-attention-heads", "4",
                    "--pipeline-model-parallel-size", "2",
                    "--num-layers-per-virtual-pipeline-stage", "2"]),
    "virtual-uneven": (4, ["--num-layers", "6", "--hidden-size", "64",
                           "--num-attention-heads", "4",
                           "--pipeline-model-parallel-size", "2",
                           "--num-layers-per-virtual-pipeline-stage", "2"]),
    "virtual-no-layers": (2, ["--num-layers-per-virtual-pipeline-stage",
                              "2"]),
    "batch-not-multiple": (2, NET + ["--micro-batch-size", "3",
                                     "--global-batch-size", "8"]),
    "fp16": (1, NET + ["--fp16"]),
    "bf16": (1, NET + ["--bf16", "--loss-scale", "8"]),
    "fp16-and-bf16": (1, NET + ["--fp16", "--bf16"]),
    "no-hidden": (1, ["--num-layers", "2", "--num-attention-heads", "4"]),
    "heads-do-not-divide": (1, ["--num-layers", "2", "--hidden-size", "66",
                                "--num-attention-heads", "4"]),
    "kv-channels-given": (1, ["--num-layers", "2", "--hidden-size", "66",
                              "--num-attention-heads", "4",
                              "--kv-channels", "16", "--ffn-hidden-size",
                              "100"]),
    "positions-short": (1, NET + ["--seq-length", "64",
                                  "--max-position-embeddings", "32"]),
    "checkpointing": (1, NET + ["--checkpoint-activations", "--seq-length",
                                "32", "--max-position-embeddings", "32",
                                "--vocab-size", "100", "--optimizer",
                                "lamb", "--rampup-batch-size", "2", "2",
                                "8"]),
}


def _fields(args):
    out = dict(vars(args))
    dt = out["params_dtype"]
    out["params_dtype"] = (str(dt).rsplit(".", 1)[-1]
                           if isinstance(dt, torch.dtype) else dt.__name__)
    return out


def _both(fn_port, fn_jax):
    """Each's result, or its exception."""
    res = []
    for fn in (fn_port, fn_jax):
        try:
            res.append(("ok", fn()))
        except Exception as e:      # noqa: BLE001 - compared below
            res.append(("raised", e))
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_parse_args_matches_jax(monkeypatch, name):
    from apex_tpu.transformer.testing import arguments as jargs

    world, argv = CASES[name]
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "1")     # no rank-0 banner
    (kp, port), (kj, ref) = _both(lambda: tt.parse_args(args_list=argv),
                                  lambda: jargs.parse_args(args_list=argv))
    assert kp == kj, (port, ref)
    if kp == "raised":
        assert type(port) is type(ref) and str(port) == str(ref)
        return
    assert _fields(port) == _fields(ref)
    assert isinstance(port.params_dtype, torch.dtype)
    assert tt.core_transformer_config_from_args(port) == dict(
        jargs.core_transformer_config_from_args(ref),
        params_dtype=port.params_dtype)


def test_parse_args_defaults_overrides_and_unknown(monkeypatch):
    from apex_tpu.transformer.testing import arguments as jargs

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    kw = dict(defaults={"seq_length": 16, "num_layers": 9},
              override_args={"tensor_model_parallel_size": 2},
              ignore_unknown_args=True, args_list=NET + ["--unknown", "3"])
    port, ref = tt.parse_args(**kw), jargs.parse_args(**kw)
    assert _fields(port) == _fields(ref)
    assert (port.seq_length, port.num_layers, port.data_parallel_size) == (
        16, 4, 1)
    with pytest.raises(SystemExit):
        tt.parse_args(args_list=NET + ["--unknown", "3"])


def test_rank_and_world_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    args = tt.parse_args(args_list=NET)
    assert (args.rank, args.world_size, args.data_parallel_size) == (3, 4, 4)


def test_global_vars_lifecycle_matches_jax(monkeypatch):
    from apex_tpu.transformer.testing import global_vars as jgv

    from apex_tpu_torch.transformer.pipeline_parallel._timers import Timers

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    gv = tt.global_vars
    for mod in (gv, jgv):
        mod.destroy_global_vars()
    getters = ("get_args", "get_num_microbatches",
               "get_current_global_batch_size", "get_timers")
    try:
        for name in getters:
            (_, e1), (_, e2) = _both(getattr(gv, name), getattr(jgv, name))
            assert type(e1) is type(e2) is RuntimeError
            assert str(e1) == str(e2)
        # a failed initialization leaves every singleton unset
        bad = NET + ["--fp16", "--bf16"]
        with pytest.raises(ValueError):
            gv.set_global_variables(args_list=bad, device="cpu")
        with pytest.raises(RuntimeError, match="not initialized"):
            gv.get_timers()
        argv = NET + ["--micro-batch-size", "2", "--global-batch-size", "16",
                      "--rampup-batch-size", "4", "4", "24"]
        args = gv.set_global_variables(args_list=argv, device="cpu")
        jargs = jgv.set_global_variables(args_list=argv)
        assert gv.get_args() is args and _fields(args) == _fields(jargs)
        assert isinstance(gv.get_timers(), Timers)
        assert gv.get_tensorboard_writer() is None
        (_, e1), (_, e2) = _both(
            lambda: gv.set_global_variables(args_list=argv, device="cpu"),
            lambda: jgv.set_global_variables(args_list=argv))
        assert str(e1) == str(e2) == "args is already initialized"
        # the rampup: 4 -> 16 by 4 over 24 samples, dp 2 x micro-batch 2
        seen = []
        consumed = 0
        for _ in range(8):
            got = (gv.get_num_microbatches(),
                   gv.get_current_global_batch_size())
            assert got == (jgv.get_num_microbatches(),
                           jgv.get_current_global_batch_size())
            seen.append(got)
            consumed += got[1]
            gv.update_num_microbatches(consumed, consistency_check=False)
            jgv.update_num_microbatches(consumed, consistency_check=False)
        assert seen[0] == (1, 4) and seen[-1] == (4, 16)
        assert len(set(seen)) > 2
    finally:
        gv.destroy_global_vars()
        jgv.destroy_global_vars()
    with pytest.raises(RuntimeError, match="not initialized"):
        gv.get_args()


def test_timers_default_to_the_card():
    """The singletons' timers sync CUDA unless the caller asks for the
    CPU; on a host without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.set_global_variables(args_list=NET)
    with pytest.raises(RuntimeError, match="not initialized"):
        tt.get_args()
