"""amp O1 in the port against the JAX package's: the policy-scoped op
namespace (``amp/functional.py``, ``amp/lists.py``) on the cases of
``tests/test_amp_lists.py``, and the O1 steps of the two examples that
take it (``examples/simple`` and the ImageNet ``run_training``, resnet10).

Each namespace case runs the same numpy inputs through JAX's
``apex_tpu.amp.functional`` op and the port's op of the same rule (torch's
name where it differs: ``arctan2`` is ``atan2``, ``concatenate`` ``cat``,
``equal`` ``eq``): the output dtypes equal, the values within ``1e-6``
relative where both compute in fp32 and within bf16's ``2**-7`` relative
(a rounding of the half product's sum) where the op runs in bf16.  The
example steps start from JAX's weights (and, for the MLP, JAX's data):
the MLP's 200 O1 fp16 steps' losses within ``1e-5`` and its parameters
within ``1e-5`` of JAX's; resnet10's O1 steps (bf16 and fp16, one
process, batch 8 of 32 x 32, SGD at lr 0.1) against JAX's
``run_training``: the first loss within ``1e-6`` and the 3 losses within
``1e-3`` (fp32 from half images; lr 0.1 on a batch of 8 carries fp32
rounding differences of the batch norms' sums into the next steps: the
same run at O0 differs by 5.8e-5, at O1 fp16 by 2.8e-4, at O1 bf16 by
7e-7, on the CPU).
"""

import importlib.util
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.amp import functional as F
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.policy import get_policy

ROOT = Path(__file__).resolve().parent.parent
HALF = torch.bfloat16
TDTYPES = [torch.float16, torch.bfloat16, torch.float32]
BF16_REL = 2.0 ** -7
FP32_REL = 1e-6


@pytest.fixture(autouse=True)
def _no_ambient_policy():
    """``initialize`` at O1 installs a process-wide policy in each package:
    none before a test, none after."""
    import apex_tpu.amp.functional as JF

    F.set_active_policy(None)
    JF.set_active_policy(None)
    yield
    F.set_active_policy(None)
    JF.set_active_policy(None)


def jax_o1():
    import jax.numpy as jnp
    from apex_tpu.amp import functional as JF
    from apex_tpu.amp.policy import get_policy as jpolicy

    return JF.active_policy(jpolicy("O1", half_dtype=jnp.bfloat16))


def o1():
    return F.active_policy(get_policy("O1", half_dtype=HALF))


def _jdt(t):
    import jax.numpy as jnp

    return {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
            torch.float32: jnp.float32}[t]


def _pair(shape, dtype, seed):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    import jax.numpy as jnp

    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(_jdt(dtype))


def _same(out, ref, rel):
    import jax.numpy as jnp

    assert _jdt(out.dtype) == ref.dtype, (out.dtype, ref.dtype)
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), r, rtol=rel,
                               atol=rel * np.abs(r).max())


# --- basic casts ------------------------------------------------------------

def test_matmul_and_einsum_cast_to_half_like_jax():
    from apex_tpu.amp import functional as JF

    x, jx = _pair((8, 8), torch.float32, 0)
    with o1(), jax_o1():
        _same(F.matmul(x, x), JF.matmul(jx, jx), BF16_REL)
        _same(F.einsum("ij,jk->ik", x, x), JF.einsum("ij,jk->ik", jx, jx),
              BF16_REL)
        assert F.linear(x, x).dtype == HALF


@pytest.mark.parametrize("name,jname,kw", [
    ("exp", "exp", {}), ("sum", "sum", {}), ("softmax", "softmax", {"dim": -1}),
    ("linalg_norm", "linalg_norm", {}), ("log1p", "log1p", {}),
    ("gelu", "gelu", {})])
def test_float_funcs_cast_to_fp32_like_jax(name, jname, kw):
    from apex_tpu.amp import functional as JF

    h, jh = _pair((16,), HALF, 1)
    h, jh = h.abs(), abs(jh)
    with o1(), jax_o1():
        out = getattr(F, name)(h, **kw)
        ref = getattr(JF, jname)(jh)
    if name == "gelu":
        # flax's gelu is the tanh form; torch's takes it by keyword
        with o1():
            out = F.gelu(h, approximate="tanh")
    _same(out, ref, FP32_REL)


def test_no_policy_and_o0_pass_through():
    x, h = torch.ones(4, 4), torch.ones(8, dtype=HALF)
    assert F.matmul(x, x).dtype == torch.float32
    assert F.exp(h).dtype == HALF
    with F.active_policy(get_policy("O0")):
        assert F.matmul(x, x).dtype == torch.float32
        assert F.exp(h).dtype == HALF
    # O2 and O3 patch nothing either (apex's patch_torch_functions)
    with F.active_policy(get_policy("O2")):
        assert F.exp(h).dtype == HALF


# --- promotion ---------------------------------------------------------------

@pytest.mark.parametrize("name,jname", [("mul", "multiply"), ("add", "add"),
                                        ("div", "divide"),
                                        ("atan2", "arctan2")])
def test_binary_promote_matches_jax(name, jname):
    from apex_tpu.amp import functional as JF

    with o1(), jax_o1():
        for i, (xt, yt) in enumerate(itertools.product(TDTYPES, TDTYPES)):
            (x, jx), (y, jy) = _pair((8,), xt, i), _pair((8,), yt, 100 + i)
            y, jy = y.abs() + 1, abs(jy) + 1
            _same(getattr(F, name)(x, y), getattr(JF, jname)(jx, jy),
                  FP32_REL if torch.float32 in (xt, yt) or xt != yt
                  else BF16_REL if HALF in (xt, yt) else 2.0 ** -10)


def test_comparison_and_sequences_like_jax():
    from apex_tpu.amp import functional as JF

    (h, jh), (f, jf) = _pair((2, 2), HALF, 3), _pair((2, 2), torch.float32, 4)
    with o1(), jax_o1():
        np.testing.assert_array_equal(F.gt(h, f).numpy(),
                                      np.asarray(JF.greater(jh, jf)))
        _same(F.cat([h, f]), JF.concatenate([jh, jf]), FP32_REL)
        _same(F.stack([h, h]), JF.stack([jh, jh]), FP32_REL)
        assert F.eq(h, f).dtype == torch.bool


def test_kwargs_follow_cast_rules():
    x, h = torch.ones(4, 4), torch.ones(8, dtype=HALF)
    with o1():
        assert F.matmul(x, other=x).dtype == HALF
        assert F.softmax(input=h, dim=-1).dtype == torch.float32
        assert F.cat(tensors=[h, torch.ones(8)]).dtype == torch.float32


def test_later_non_o1_initialize_keeps_o1_policy():
    x = torch.ones(4, 4)
    amp.initialize(torch.nn.Linear(4, 4), opt_level="O1")
    amp.initialize(torch.nn.Linear(4, 4), opt_level="O2")
    assert F.matmul(x, x).dtype == HALF


def test_grad_dtype_and_value_through_half_matmul_like_jax():
    import jax
    import jax.numpy as jnp
    from apex_tpu.amp import functional as JF

    x, jx = _pair((4, 4), torch.float32, 5)
    x.requires_grad_()
    with o1():
        F.matmul(x, x).float().sum().backward()

    def loss(a):
        with jax_o1():
            return JF.matmul(a, a).astype(jnp.float32).sum()

    ref = jax.grad(loss)(jx)
    assert x.grad.dtype == torch.float32 and ref.dtype == jnp.float32
    _same(x.grad, ref, BF16_REL)


def test_policy_properties_match_jax():
    import jax.numpy as jnp
    from apex_tpu.amp.policy import get_policy as jpolicy

    for level in ("O0", "O1", "O2", "O3"):
        p, j = (get_policy(level, half_dtype=torch.float16),
                jpolicy(level, half_dtype=jnp.float16))
        for f in ("param_dtype", "compute_dtype", "output_dtype"):
            assert _jdt(getattr(p, f)) == getattr(j, f), (level, f)
        for f in ("keep_norm_fp32", "master_weights", "loss_scale"):
            assert getattr(p, f) == getattr(j, f), (level, f)


# --- the lists ----------------------------------------------------------------

def test_reference_map_covers_every_jax_entry():
    """Every reference registry entry the JAX map records is mapped here,
    to a wrapped op, BANNED, or N/A with its reason."""
    from apex_tpu.amp import lists as jlists

    wrapped = set(lists.HALF_FUNCS + lists.FLOAT_FUNCS + lists.PROMOTE_FUNCS
                  + lists.SEQUENCE_FUNCS)
    assert set(jlists.REFERENCE_MAP) <= set(lists.REFERENCE_MAP)
    for entry, val in lists.REFERENCE_MAP.items():
        if val.startswith("BANNED"):
            assert entry in lists.BANNED_FUNCS
        elif val.startswith("N/A"):
            assert len(val) > len("N/A: ") + 20, entry
        else:
            assert val in wrapped, f"{entry} -> {val}"
    for name in jlists.SEQUENCE_FUNCS + ["softmax", "exp", "matmul", "add"]:
        assert name in wrapped


@pytest.mark.parametrize("rule,names", [
    ("half", lists.HALF_FUNCS), ("float", lists.FLOAT_FUNCS),
    ("promote", lists.PROMOTE_FUNCS), ("sequence", lists.SEQUENCE_FUNCS)])
def test_every_listed_op_is_wrapped_with_its_rule(rule, names):
    for name in names:
        op = getattr(F, name.replace(".", "_"))
        assert op.__amp_rule__ == rule and callable(op.__wrapped__), name
        assert op.__name__ in F.__all__ or name.replace(".", "_") in F.__all__


def test_banned_binary_cross_entropy_raises():
    with pytest.raises(RuntimeError, match="logits"):
        F.binary_cross_entropy(torch.ones(4), torch.ones(4))


def test_register_functions():
    if hasattr(F, "sigmoid"):
        delattr(F, "sigmoid")
    F.register_float_function("sigmoid")
    x = torch.ones(4, dtype=HALF)
    with o1():
        assert F.sigmoid(x).dtype == torch.float32
    assert F.sigmoid(x).dtype == HALF
    F.register_half_function("my_gemm", lambda a, b: a @ b)
    with o1():
        assert F.my_gemm(torch.ones(4, 4), torch.ones(4, 4)).dtype == HALF


# --- the O1 steps of the examples ----------------------------------------------

def _load(name, path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_simple_o1_fp16_steps_match_jax():
    """``examples/simple/main.py``'s O1 fp16 loop (its weights, data and
    step, 200 steps) against ``simple.train`` from the same weights."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import amp as jamp
    from apex_tpu.optimizers import FusedAdam as JAdam

    from apex_tpu_torch.examples import simple

    jsimple = _load("apex_tpu_examples_simple_main",
                    ROOT / "examples" / "simple" / "main.py")
    k1, k2, kx = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"w1": jax.random.normal(k1, (16, 64)) * 0.3,
              "b1": jnp.zeros((64,)),
              "w2": jax.random.normal(k2, (64, 1)) * 0.3,
              "b2": jnp.zeros((1,))}
    x = jax.random.normal(kx, (512, 16))
    y = jnp.sin(x.sum(axis=1, keepdims=True))
    amped = jamp.initialize(jsimple.apply_fn, params, opt_level="O1",
                            half_dtype=jnp.float16)
    scaler, opt = amped.scaler, JAdam(lr=1e-2, master_weights=False)

    @jax.jit
    def step(p, o, s):
        def scaled(p):
            pred = amped.apply(p, x)
            return scaler.scale_loss(jnp.mean((pred.astype(jnp.float32) - y)
                                              ** 2), s)
        loss, g = jax.value_and_grad(scaled)(p)
        g, found = scaler.unscale(g, s)
        p, o = opt.step(g, p, o, found_inf=found)
        return p, o, scaler.update(s, found), loss / s.scale

    p, o, s, ref = amped.params, opt.init(amped.params), amped.scaler_state, []
    for _ in range(200):
        p, o, s, loss = step(p, o, s)
        ref.append(float(loss))

    model = simple.SimpleMLP(torch.Generator(), "cpu")
    with torch.no_grad():
        for n, q in model.named_parameters():
            q.copy_(torch.from_numpy(np.array(params[n])))
    losses, state = simple.train(model, torch.from_numpy(np.array(x)),
                                 opt_level="O1", half=torch.float16,
                                 steps=200)
    np.testing.assert_allclose([float(v) for v in losses], ref, rtol=0,
                               atol=1e-5)
    assert float(state.scale) == float(s.scale)
    for n, q in model.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p[n]),
                                   rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("half", ["bf16", "fp16"])
def test_resnet10_o1_run_training_matches_jax(half):
    """``run_training(opt_level="O1")`` from the JAX driver's init against
    the JAX driver's ``run_training`` (the batch on its 8 virtual devices,
    batch norms over the whole batch) and the port's one process."""
    import jax

    from apex_tpu_torch.examples import imagenet_main as im
    from apex_tpu_torch.models import resnet_params_from_jax

    jmain = _load("apex_tpu_examples_imagenet_main",
                  ROOT / "examples" / "imagenet" / "main.py")
    kw = dict(arch="resnet10", opt_level="O1", half=half, batch_size=8,
              image_size=32, num_classes=10, steps=3, lr=0.1, seed=0,
              verbose=False)
    want = jmain.run_training(**kw)["losses"]
    v = jmain.resnet10_ish(10).init(jax.random.PRNGKey(0),
                                    np.zeros((2, 32, 32, 3), np.float32),
                                    train=True)
    init = resnet_params_from_jax(jax.tree.map(np.asarray, v))
    got = im.run_training(device="cpu", distributed=False, init_state=init,
                          **kw)
    assert abs(got["losses"][0] - want[0]) < 1e-6
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=1e-3)
    assert {q.dtype for q in got["model"].parameters()} == {torch.float32}
