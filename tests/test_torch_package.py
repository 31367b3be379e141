"""apex_tpu_torch stands apart from JAX and from apex_tpu.

The port imports ``torch`` and numpy, never ``jax``, ``flax`` or a module
of ``apex_tpu`` (whose name is a prefix of the port's own, so the scan
below matches ``apex_tpu`` only when a dot or whitespace follows it).
Its entry points default to CUDA and raise, rather than run on the CPU,
on a host without a card.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|apex_tpu)(?:[.\s]|$)", re.MULTILINE)


def _port_sources():
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_importing_the_port_loads_no_jax_and_no_apex_tpu():
    code = (
        "import sys\n"
        "import apex_tpu_torch, apex_tpu_torch.serving, "
        "apex_tpu_torch.models, apex_tpu_torch.normalization, "
        "apex_tpu_torch.transformer.tensor_parallel, "
        "apex_tpu_torch.ops.layer_norm, apex_tpu_torch.ops.rope, "
        "apex_tpu_torch.ops.flash_attention, apex_tpu_torch.ops.fused_lm_head, "
        "apex_tpu_torch.optimizers, apex_tpu_torch.examples.llama_pretrain, "
        "apex_tpu_torch.ops.softmax, apex_tpu_torch.ops.packed_update, "
        "apex_tpu_torch.transformer.enums, "
        "apex_tpu_torch.transformer.functional, "
        "apex_tpu_torch.transformer.layers, "
        "apex_tpu_torch.transformer.testing, "
        "apex_tpu_torch.transformer.testing.standalone_transformer_lm, "
        "apex_tpu_torch.utils.packing, apex_tpu_torch.utils.tree_math, "
        "apex_tpu_torch.multi_tensor_apply, "
        "apex_tpu_torch.examples.gpt_pretrain, "
        "apex_tpu_torch.ops.pair_bias_attention, apex_tpu_torch.contrib, "
        "apex_tpu_torch.contrib.openfold_triton, "
        "apex_tpu_torch.contrib.openfold_triton.fused_adam_swa, "
        "apex_tpu_torch.amp, apex_tpu_torch.amp.policy, "
        "apex_tpu_torch.amp.scaler, apex_tpu_torch.fp16_utils, "
        "apex_tpu_torch.optimizers.fused_adagrad, "
        "apex_tpu_torch.examples.simple, apex_tpu_torch.models.convert, "
        "apex_tpu_torch.amp.quant, apex_tpu_torch.serving.quant, "
        "apex_tpu_torch.serving.paged_kv_cache, "
        "apex_tpu_torch.serving.prefix_cache, apex_tpu_torch._logging, "
        "apex_tpu_torch.obs, apex_tpu_torch.obs.alerts, "
        "apex_tpu_torch.obs.bridge, apex_tpu_torch.obs.metrics, "
        "apex_tpu_torch.obs.request_trace, apex_tpu_torch.obs.slo, "
        "apex_tpu_torch.obs.trace, apex_tpu_torch.utils.serialization, "
        "apex_tpu_torch.resilience, "
        "apex_tpu_torch.resilience.fault_injection, "
        "apex_tpu_torch.resilience.checkpoint, "
        "apex_tpu_torch.resilience.async_checkpoint, "
        "apex_tpu_torch.resilience.retry, "
        "apex_tpu_torch.resilience.supervisor, "
        "apex_tpu_torch.serving.weights, apex_tpu_torch.serving.reload, "
        "apex_tpu_torch.serving.fleet, apex_tpu_torch.serving.rollout, "
        "apex_tpu_torch.transformer.parallel_state, "
        "apex_tpu_torch.transformer.tensor_parallel.mappings, "
        "apex_tpu_torch.transformer.tensor_parallel.cross_entropy, "
        "apex_tpu_torch.transformer.tensor_parallel.utils, "
        "apex_tpu_torch.transformer.testing.distributed, "
        "apex_tpu_torch.resilience.elastic, "
        "apex_tpu_torch.transformer.tensor_parallel.random, "
        "apex_tpu_torch.transformer.tensor_parallel.data, "
        "apex_tpu_torch.transformer.tensor_parallel.memory, "
        "apex_tpu_torch.transformer.amp, "
        "apex_tpu_torch.transformer.microbatches, "
        "apex_tpu_torch.transformer._data, "
        "apex_tpu_torch.transformer.pipeline_parallel, "
        "apex_tpu_torch.transformer.pipeline_parallel.schedules, "
        "apex_tpu_torch.transformer.pipeline_parallel.p2p_communication, "
        "apex_tpu_torch.transformer.pipeline_parallel.utils, "
        "apex_tpu_torch.transformer.pipeline_parallel._timers, "
        "apex_tpu_torch.models.llama_pipeline, apex_tpu_torch.parallel, "
        "apex_tpu_torch.parallel.distributed, "
        "apex_tpu_torch.parallel.sync_batchnorm, apex_tpu_torch.parallel.LARC, "
        "apex_tpu_torch.contrib.optimizers, "
        "apex_tpu_torch.contrib.optimizers._zero_base, "
        "apex_tpu_torch.contrib.optimizers.distributed_fused_adam, "
        "apex_tpu_torch.contrib.optimizers.distributed_fused_lamb, "
        "apex_tpu_torch.examples.imagenet_main, "
        "apex_tpu_torch.examples.imagenet_data, "
        "apex_tpu_torch.examples.bert_pretrain, apex_tpu_torch.models.vit, "
        "apex_tpu_torch.transformer.recompute, "
        "apex_tpu_torch.transformer.testing.standalone_bert, "
        "apex_tpu_torch.transformer.moe, "
        "apex_tpu_torch.transformer.context_parallel, "
        "apex_tpu_torch.contrib.halo, apex_tpu_torch.contrib.halo.bottleneck, "
        "apex_tpu_torch.utils.conv, apex_tpu_torch.utils.dropout, "
        "apex_tpu_torch.contrib.halo.halo_exchange, "
        "apex_tpu_torch.transformer.log_util, "
        "apex_tpu_torch.transformer.testing.arguments, "
        "apex_tpu_torch.transformer.testing.global_vars, "
        "apex_tpu_torch.transformer.testing.commons, "
        "apex_tpu_torch.examples.megatron_gpt_pretrain, "
        "apex_tpu_torch.amp.lists, apex_tpu_torch.amp.functional, "
        "apex_tpu_torch.utils._native, apex_tpu_torch.utils.nvtx, "
        "apex_tpu_torch.feature_registry, "
        "apex_tpu_torch.resilience.guarded, "
        "apex_tpu_torch.resilience.data_guard, "
        "apex_tpu_torch.resilience.consistency, "
        "apex_tpu_torch.fused_dense, apex_tpu_torch.mlp, "
        "apex_tpu_torch.contrib.multihead_attn, apex_tpu_torch.contrib.fmha, "
        "apex_tpu_torch.contrib.xentropy, apex_tpu_torch.contrib.focal_loss, "
        "apex_tpu_torch.contrib.transducer, "
        "apex_tpu_torch.contrib.group_norm, apex_tpu_torch.contrib.groupbn, "
        "apex_tpu_torch.contrib.cudnn_gbn, "
        "apex_tpu_torch.contrib.conv_bias_relu, "
        "apex_tpu_torch.contrib.index_mul_2d, "
        "apex_tpu_torch.contrib.sparsity, apex_tpu_torch.RNN, "
        "apex_tpu_torch.RNN.cells, apex_tpu_torch.RNN.rnn, "
        "apex_tpu_torch.RNN.models, apex_tpu_torch.examples.dcgan_main_amp, "
        "apex_tpu_torch.examples.imagenet_run_convergence\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'apex_tpu', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_flax_or_apex_tpu(path):
    assert path.is_file(), f"{path} is missing"
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_scan_pattern_tells_the_port_from_the_reference():
    for line in ("import jax", "from jax import numpy", "import flax.linen",
                 "from apex_tpu.ops import layer_norm", "import apex_tpu",
                 "    from apex_tpu import serving"):
        assert _FORBIDDEN.search(line), line
    for line in ("import apex_tpu_torch", "from apex_tpu_torch.ops import x",
                 "import jaxtyping", "import numpy"):
        assert not _FORBIDDEN.search(line), line


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from apex_tpu_torch import serving as sv
    from apex_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sv.DecodeEngine(model, slots=1, max_len=8, prefill_len=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sv.init_cache(cfg, slots=1, max_len=8)
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.transformer.testing import GPTModel

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_pretrain.main(["--steps", "1"])
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.examples import simple

    with pytest.raises(RuntimeError, match="device='cpu'"):
        simple.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LossScaler().init()
    from apex_tpu_torch.models import (
        LlamaPipeConfig,
        build_llama_pipeline,
        init_llama_pipeline_params,
    )
    from apex_tpu_torch.transformer.pipeline_parallel.utils import (
        report_memory,
    )

    pcfg = LlamaPipeConfig(cfg, layers_per_stage=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_llama_pipeline(pcfg, pp_rank=0, pp_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_llama_pipeline_params(pcfg, pp_rank=0, pp_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        report_memory("probe")
    from apex_tpu_torch.examples import imagenet_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        imagenet_main.resnet10_ish(10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imagenet_main.run_training(distributed=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imagenet_main.main(["--steps", "1"])
    from apex_tpu_torch.examples import bert_pretrain
    from apex_tpu_torch.models import ViTConfig, ViTForImageClassification
    from apex_tpu_torch.transformer.testing import BertModel

    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert_pretrain.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTForImageClassification(ViTConfig(num_hidden_layers=1))
    from apex_tpu_torch.contrib.halo import SpatialBottleneck
    from apex_tpu_torch.transformer.moe import ExpertParallelMLP

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExpertParallelMLP(4, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialBottleneck(8, 4, 8, spatial_axis=None)
    from apex_tpu_torch.examples import megatron_gpt_pretrain
    from apex_tpu_torch.transformer.testing.commons import (
        GPTPipeConfig,
        build_gpt_pipeline,
        init_gpt_pipeline_params,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        megatron_gpt_pretrain.main(["--num-layers", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_gpt_pipeline(GPTPipeConfig(), pp_rank=0, pp_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gpt_pipeline_params(GPTPipeConfig(), pp_rank=0, pp_size=1)


@pytest.mark.parametrize("port,ref", [
    ("apex_tpu_torch.transformer.moe", "apex_tpu/transformer/moe.py"),
    ("apex_tpu_torch.transformer.context_parallel",
     "apex_tpu/transformer/context_parallel.py"),
    ("apex_tpu_torch.contrib.halo", "apex_tpu/contrib/halo/__init__.py"),
    ("apex_tpu_torch.contrib.halo.halo_exchange",
     "apex_tpu/contrib/halo/halo_exchange.py"),
    ("apex_tpu_torch.contrib.halo.bottleneck",
     "apex_tpu/contrib/halo/bottleneck.py"),
])
def test_parallel_axes_export_the_jax_names(port, ref):
    """The expert-, context- and spatial-parallel modules carry the JAX
    module's ``__all__`` (read from its source, so no JAX is imported),
    every name defined; ``apex_tpu_torch.transformer`` reaches ``moe`` and
    ``context_parallel`` as attributes, as the JAX package does."""
    import ast
    import importlib

    import apex_tpu_torch.transformer as transformer

    tree = ast.parse((ROOT / ref).read_text())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets))
    module = importlib.import_module(port)
    assert list(module.__all__) == list(want)
    assert all(hasattr(module, name) for name in want)
    for name in ("moe", "context_parallel"):
        assert getattr(transformer, name).__name__ == \
            f"apex_tpu_torch.transformer.{name}"


# every kernel of the port, module by module: (name, the JAX file:function
# of its table row)
_KERNELS = [
    ("layer_norm_fwd", "apex_tpu/ops/layer_norm.py", "_fwd_kernel"),
    ("layer_norm_bwd", "apex_tpu/ops/layer_norm.py", "_bwd_kernel"),
    ("flash_attention_fwd", "apex_tpu/ops/flash_attention.py", "_fwd_kernel"),
    ("flash_attention_dq", "apex_tpu/ops/flash_attention.py", "_dq_kernel"),
    ("flash_attention_dkv", "apex_tpu/ops/flash_attention.py", "_dkv_kernel"),
    ("fused_lm_head_fwd", "apex_tpu/ops/fused_lm_head.py", "_fwd_kernel"),
    ("fused_lm_head_dh", "apex_tpu/ops/fused_lm_head.py", "_dh_kernel"),
    ("fused_lm_head_de", "apex_tpu/ops/fused_lm_head.py", "_de_kernel"),
    ("scaled_softmax_fwd", "apex_tpu/ops/softmax.py", "_fwd_kernel"),
    ("scaled_softmax_bwd", "apex_tpu/ops/softmax.py", "_bwd_kernel"),
    ("lamb_phase1", "apex_tpu/ops/packed_update.py", "_lamb_phase1_kernel"),
    ("packed_adam", "apex_tpu/ops/packed_update.py", "_adam_kernel"),
    ("packed_adagrad", "apex_tpu/ops/packed_update.py", "_adagrad_kernel"),
    ("pair_bias_attention_fwd", "apex_tpu/ops/pair_bias_attention.py",
     "_fwd_kernel"),
    ("pair_bias_attention_dq", "apex_tpu/ops/pair_bias_attention.py",
     "_dq_kernel"),
    ("pair_bias_attention_dkv", "apex_tpu/ops/pair_bias_attention.py",
     "_dkv_kernel"),
    ("pair_bias_attention_dbias", "apex_tpu/ops/pair_bias_attention.py",
     "_dbias_kernel"),
]


# the port's kernels with no Pallas counterpart: each ``replaces`` names the
# JAX function whose tree-wide pass it stands for
_PORT_KERNELS = [
    ("mt_l2norm", "apex_tpu/multi_tensor_apply/__init__.py",
     "multi_tensor_l2norm"),
    ("mt_scale", "apex_tpu/multi_tensor_apply/__init__.py",
     "multi_tensor_scale"),
    ("mt_adam", "apex_tpu/optimizers/fused_adam.py", "_update"),
    ("mt_lamb", "apex_tpu/optimizers/fused_lamb.py", "_update"),
]


@pytest.mark.parametrize("name,jax_file,jax_fn", _KERNELS,
                         ids=[k[0] for k in _KERNELS])
def test_kernel_registry(name, jax_file, jax_fn):
    """``_dispatch.KERNELS`` lists the kernel once, its source is under
    ``csrc/``, and ``replaces`` points at the Pallas kernel function: the
    named line of the JAX file defines it."""
    from apex_tpu_torch.ops import _build, _dispatch

    assert [k.name for k in _dispatch.KERNELS] == \
        [k[0] for k in _KERNELS + _PORT_KERNELS]

    found = [k for k in _dispatch.KERNELS if k.name == name]
    assert len(found) == 1, [k.name for k in _dispatch.KERNELS]
    kernel = found[0]
    assert kernel.source.endswith(".cu")
    assert (_build.CSRC / kernel.source).is_file()
    assert _build.CSRC == ROOT / "apex_tpu_torch" / "csrc"
    where, fn = kernel.replaces.split()
    path, line = where.split(":")
    assert (path, fn) == (jax_file, jax_fn)
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith(f"def {fn}("), text


@pytest.mark.parametrize("name,jax_file,jax_fn", _PORT_KERNELS,
                         ids=[k[0] for k in _PORT_KERNELS])
def test_port_kernel_registry(name, jax_file, jax_fn):
    """The multi-tensor kernels: each listed once, its source under
    ``csrc/``, and ``replaces`` pointing at the JAX function or method whose
    tree-wide pass it stands for: the named line defines it, and no
    ``pallas_call`` lies in its body."""
    from apex_tpu_torch.ops import _build, _dispatch

    found = [k for k in _dispatch.KERNELS if k.name == name]
    assert len(found) == 1, [k.name for k in _dispatch.KERNELS]
    kernel = found[0]
    assert kernel.source.endswith(".cu")
    assert (_build.CSRC / kernel.source).is_file()
    where, fn = kernel.replaces.split()
    path, line = where.split(":")
    assert (path, fn) == (jax_file, jax_fn)
    lines = (ROOT / path).read_text().splitlines()
    head = lines[int(line) - 1]
    assert head.lstrip().startswith(f"def {fn}("), head
    indent = len(head) - len(head.lstrip())
    body = []
    for text in lines[int(line):]:
        if text.strip() and len(text) - len(text.lstrip()) <= indent:
            break
        body.append(text)
    assert body and not any("pallas_call" in t for t in body)


def _jax_all(ref: str) -> list:
    """A JAX module's ``__all__``, read from its source (no JAX import)."""
    import ast

    tree = ast.parse((ROOT / ref).read_text())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets))


def test_resilience_exports_every_jax_name():
    """``apex_tpu_torch.resilience`` holds every name of
    ``apex_tpu.resilience.__all__``, in its order, each defined; the
    training side's modules carry their JAX twins' ``__all__``."""
    import importlib

    import apex_tpu_torch.resilience as rz

    want = _jax_all("apex_tpu/resilience/__init__.py")
    assert list(rz.__all__[:len(want)]) == list(want)
    assert [n for n in want if not hasattr(rz, n)] == []
    for mod in ("data_guard", "consistency", "supervisor"):
        port = importlib.import_module(f"apex_tpu_torch.resilience.{mod}")
        names = _jax_all(f"apex_tpu/resilience/{mod}.py")
        assert set(names) <= set(port.__all__), mod
        assert all(hasattr(port, n) for n in names), mod
    guarded = importlib.import_module("apex_tpu_torch.resilience.guarded")
    assert set(_jax_all("apex_tpu/resilience/guarded.py")) <= set(
        guarded.__all__)
    faults = importlib.import_module(
        "apex_tpu_torch.resilience.fault_injection")
    assert set(_jax_all("apex_tpu/resilience/fault_injection.py")) <= set(
        faults.__all__)


@pytest.mark.parametrize("port,names", [
    ("apex_tpu_torch.transformer",
     ["AttnMaskType", "AttnType", "LayerType", "ModelType"]),
    ("apex_tpu_torch.transformer.functional",
     _jax_all("apex_tpu/transformer/functional/__init__.py")),
    ("apex_tpu_torch.amp",
     ["quant", "INT8_QMAX", "quantize_int8", "dequantize_int8"]),
    ("apex_tpu_torch.utils",
     ["PackedBuffer", "pack_pytree", "unpack_pytree",
      "flatten_dense_tensors", "unflatten_dense_tensors", "tree_paths",
      "leaf_crc32", "tree_to_host_dict", "tree_from_host_dict"]),
    ("apex_tpu_torch.fused_dense",
     _jax_all("apex_tpu/fused_dense/__init__.py")),
    ("apex_tpu_torch.mlp", _jax_all("apex_tpu/mlp/__init__.py")),
    ("apex_tpu_torch.RNN", _jax_all("apex_tpu/RNN/__init__.py")),
    ("apex_tpu_torch.RNN.cells", _jax_all("apex_tpu/RNN/cells.py")),
])
def test_namespaces_hold_the_jax_names(port, names):
    """Each name by ``getattr`` on the package; the enums are the
    ``transformer.enums`` classes, the rope forms ``ops.rope``'s and the
    quantizers ``amp.quant``'s.  The JAX pytree math (``tree_add`` ...)
    stays out of ``utils``."""
    import importlib

    module = importlib.import_module(port)
    assert [n for n in names if not hasattr(module, n)] == []
    if port == "apex_tpu_torch.transformer":
        from apex_tpu_torch.transformer import enums

        assert module.AttnMaskType is enums.AttnMaskType
    if port == "apex_tpu_torch.transformer.functional":
        from apex_tpu_torch.ops import rope

        assert module.fused_apply_rotary_pos_emb is \
            rope.fused_apply_rotary_pos_emb
    if port == "apex_tpu_torch.amp":
        assert module.quantize_int8 is module.quant.quantize_int8
    if port == "apex_tpu_torch.utils":
        assert not hasattr(module, "tree_add")
    if port == "apex_tpu_torch.RNN":
        assert module.models.__name__ == "apex_tpu_torch.RNN.models"


# the JAX package's modules with no twin in the port, and why
_NO_TWIN = {
    "utils/compat.py": "JAX version shims (the shard_map import, a jit "
                       "cache-size probe): nothing of PyTorch to port",
}
# each example of the repo and its twin under apex_tpu_torch/examples/
_EXAMPLE_TWINS = {
    "simple/main.py": "simple.py",
    "gpt/pretrain.py": "megatron_gpt_pretrain.py",
    "llama/pretrain.py": "llama_pretrain.py",
    "bert/pretrain.py": "bert_pretrain.py",
    "imagenet/main.py": "imagenet_main.py",
    "imagenet/data.py": "imagenet_data.py",
    "imagenet/run_convergence.py": "imagenet_run_convergence.py",
    "dcgan/main_amp.py": "dcgan_main_amp.py",
}


def test_every_jax_module_and_example_has_a_port_twin():
    """Every ``apex_tpu/**/*.py`` has a file at the same path under
    ``apex_tpu_torch/`` but those of ``_NO_TWIN``; every
    ``examples/<dir>/<file>.py`` has its twin by ``_EXAMPLE_TWINS``."""
    jax_pkg, port = ROOT / "apex_tpu", ROOT / "apex_tpu_torch"
    missing = sorted(str(p.relative_to(jax_pkg))
                     for p in jax_pkg.rglob("*.py")
                     if not (port / p.relative_to(jax_pkg)).is_file())
    assert missing == sorted(_NO_TWIN)
    examples = sorted(str(p.relative_to(ROOT / "examples"))
                      for p in (ROOT / "examples").glob("*/*.py"))
    assert examples == sorted(_EXAMPLE_TWINS)
    assert [t for t in _EXAMPLE_TWINS.values()
            if not (port / "examples" / t).is_file()] == []


def test_new_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.fused_dense import (
        DenseNoBias,
        FusedDense,
        FusedDenseGeluDense,
    )
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.resilience import init_guard_state

    for make in (lambda: init_guard_state(LossScaler()),
                 lambda: FusedDense(2, 2), lambda: DenseNoBias(2, 2),
                 lambda: FusedDenseGeluDense(2, 4, 2),
                 lambda: MLP([2, 2])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# the contrib modules of the zoo: (port module, its JAX twin's source)
_CONTRIB = [
    ("multihead_attn", "multihead_attn/__init__.py"),
    ("fmha", "fmha.py"),
    ("xentropy", "xentropy/__init__.py"),
    ("xentropy.softmax_xentropy", "xentropy/softmax_xentropy.py"),
    ("focal_loss", "focal_loss/__init__.py"),
    ("focal_loss.focal_loss", "focal_loss/focal_loss.py"),
    ("transducer", "transducer/__init__.py"),
    ("transducer.transducer", "transducer/transducer.py"),
    ("group_norm", "group_norm/__init__.py"),
    ("group_norm.group_norm", "group_norm/group_norm.py"),
    ("groupbn", "groupbn/__init__.py"),
    ("groupbn.batch_norm", "groupbn/batch_norm.py"),
    ("cudnn_gbn", "cudnn_gbn/__init__.py"),
    ("cudnn_gbn.batch_norm", "cudnn_gbn/batch_norm.py"),
    ("conv_bias_relu", "conv_bias_relu/__init__.py"),
    ("conv_bias_relu.conv_bias_relu", "conv_bias_relu/conv_bias_relu.py"),
    ("index_mul_2d", "index_mul_2d/__init__.py"),
    ("index_mul_2d.index_mul_2d", "index_mul_2d/index_mul_2d.py"),
    ("sparsity", "sparsity/__init__.py"),
    ("sparsity.asp", "sparsity/asp.py"),
    ("sparsity.sparse_masklib", "sparsity/sparse_masklib.py"),
    ("sparsity.permutation_search", "sparsity/permutation_search.py"),
]


@pytest.mark.parametrize("port,ref", _CONTRIB, ids=[c[0] for c in _CONTRIB])
def test_contrib_modules_export_the_jax_names(port, ref):
    """Each contrib module carries its JAX twin's ``__all__`` (read from
    the source, so no JAX is imported), in its order, every name reached
    by ``getattr``; the module also reaches the JAX names that its twin
    defines outside ``__all__`` (``segment_ids_from_cu_seqlens``,
    ``pack_joint_output``)."""
    import importlib

    module = importlib.import_module(f"apex_tpu_torch.contrib.{port}")
    want = _jax_all(f"apex_tpu/contrib/{ref}")
    assert list(module.__all__) == list(want)
    assert [n for n in want if getattr(module, n, None) is None] == []
    extra = {"fmha": ["segment_ids_from_cu_seqlens"],
             "transducer.transducer": ["pack_joint_output"]}
    assert all(callable(getattr(module, n)) for n in extra.get(port, ()))


def test_contrib_lists_the_jax_submodules():
    """``apex_tpu_torch.contrib`` lists JAX's ``_SUBMODULES`` (read from its
    source), and each loads as an attribute of the package."""
    import ast

    import apex_tpu_torch.contrib as contrib

    tree = ast.parse((ROOT / "apex_tpu/contrib/__init__.py").read_text())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "_SUBMODULES"
                        for t in node.targets))
    assert "RNN" not in want
    assert tuple(contrib._SUBMODULES) == tuple(want)
    for name in want:
        assert getattr(contrib, name).__name__ == \
            f"apex_tpu_torch.contrib.{name}"
        assert name in dir(contrib)
    with pytest.raises(AttributeError):
        contrib.RNN


def test_contrib_modules_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn,
        SelfMultiheadAttn,
    )

    for make in (lambda: SelfMultiheadAttn(64, 2),
                 lambda: EncdecMultiheadAttn(64, 2),
                 lambda: GroupNorm(4, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
