"""``apex_tpu_torch.fused_dense`` and ``apex_tpu_torch.mlp`` against
``apex_tpu.fused_dense`` / ``apex_tpu.mlp`` on the CPU: the flax modules
initialized in JAX, their weights carried over by
``models.convert.dense_params_from_jax`` (``kernel [in, out]`` ->
``weight [out, in]``), the same numpy inputs through both.

Forward within 1e-5 (fp32; JAX at ``precision=highest``, the port with
TF32 off, as on the CPU) and 1e-2 relative (bf16, both accumulating in
fp32 and rounding the product to bf16 before the bias); the gradients of
``sum(y ** 2)`` with respect to the input and every parameter within
1e-4 of the largest magnitude (fp32).  The functional forms take the
same kernels as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.fused_dense as jfd
import apex_tpu.mlp as jmlp
from apex_tpu_torch import fused_dense as fd
from apex_tpu_torch import mlp as tmlp
from apex_tpu_torch.models.convert import dense_params_from_jax

IN, MID, OUT, ROWS = 8, 32, 16, 5


def _x(seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (ROWS, IN)).astype(dtype)


def _pair(kind):
    """(port module, flax module, flax params as numpy)."""
    x = jnp.asarray(_x(0))
    if kind == "dense":
        port = fd.FusedDense(IN, OUT, device="cpu")
        ref = jfd.FusedDense(OUT)
    elif kind == "nobias":
        port = fd.DenseNoBias(IN, OUT, device="cpu")
        ref = jfd.DenseNoBias(OUT)
    elif kind == "gelu":
        port = fd.FusedDenseGeluDense(IN, MID, OUT, device="cpu")
        ref = jfd.FusedDenseGeluDense(MID, OUT)
    else:
        act = kind.split("_")[1]
        port = tmlp.MLP([IN, MID, 12, OUT], activation=act, device="cpu")
        ref = jmlp.MLP([IN, MID, 12, OUT], activation=act)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(1), x))
    # flax zero-inits the biases: give them values so they are checked
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape).astype(v.dtype) * 0.1
                      if "bias" in jax.tree_util.keystr(p) else v), params)
    port.load_state_dict(dense_params_from_jax(params))
    return port, ref, params


KINDS = ["dense", "nobias", "gelu", "mlp_none", "mlp_relu", "mlp_sigmoid"]


@pytest.mark.parametrize("kind", KINDS)
def test_forward_and_backward_match_jax_fp32(kind):
    port, ref, params = _pair(kind)
    x = _x(3)
    xt = torch.tensor(x, requires_grad=True)
    y = port(xt)
    (y ** 2).sum().backward()

    def loss(p, x):
        with jax.default_matmul_precision("highest"):
            return jnp.sum(ref.apply(p, x) ** 2)

    with jax.default_matmul_precision("highest"):
        jy = ref.apply(params, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    want = {k: v.numpy() for k, v in dense_params_from_jax(
        jax.tree.map(np.asarray, gp)).items()}
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0,
                                   atol=1e-4 * np.abs(want[name]).max(),
                                   err_msg=name)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0,
                               atol=1e-4 * np.abs(gx).max())


@pytest.mark.parametrize("kind", ["dense", "gelu", "mlp_relu"])
def test_bf16_input_keeps_jax_s_dtype_rules(kind):
    """A bf16 input with fp32 parameters: the weights cast to bf16, each
    product accumulated in fp32 and rounded to bf16, the bias added in
    bf16 — the output bf16, within 1e-2 of JAX's relative to its largest
    magnitude."""
    port, ref, params = _pair(kind)
    x = _x(4)
    y = port(torch.tensor(x).to(torch.bfloat16))
    jy = ref.apply(params, jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().detach().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_functional_forms_take_jax_s_kernels():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, IN)).astype(np.float32)
    k1 = (rng.standard_normal((IN, MID)) * 0.1).astype(np.float32)
    b1 = rng.standard_normal(MID).astype(np.float32)
    k2 = (rng.standard_normal((MID, OUT)) * 0.1).astype(np.float32)
    b2 = rng.standard_normal(OUT).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, k1, b1, k2, b2)]
    j = [jnp.asarray(a) for a in (x, k1, b1, k2, b2)]
    with jax.default_matmul_precision("highest"):
        pairs = [
            (fd.linear_bias(t[0], t[1], t[2]), jfd.linear_bias(*j[:3])),
            (fd.linear_bias(t[0], t[1]), jfd.linear_bias(j[0], j[1])),
            (fd.linear_gelu_linear(*t), jfd.linear_gelu_linear(*j)),
            (tmlp.mlp_forward(t[0], [t[1], t[3]], [t[2], None], "sigmoid"),
             jmlp.mlp_forward(j[0], [j[1], j[3]], [j[2], None], "sigmoid"))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_refusals_and_parameter_names():
    with pytest.raises(ValueError, match="activation"):
        tmlp.mlp_forward(torch.ones(1, 2), [torch.ones(2, 2)], [None], "tanh")
    with pytest.raises(ValueError, match="activation"):
        tmlp.MLP([2, 2], activation="tanh", device="cpu")
    with pytest.raises(ValueError, match="at least"):
        tmlp.MLP([4], device="cpu")
    with pytest.raises(ValueError, match="input width"):
        tmlp.MLP([4, 2], device="cpu")(torch.ones(1, 3))
    names = [n for n, _ in tmlp.MLP([4, 3, 2], bias=False,
                                    device="cpu").named_parameters()]
    assert names == ["weight_0", "weight_1"]
    assert [n for n, _ in fd.FusedDenseGeluDense(
        4, 8, 2, device="cpu").named_parameters()] == [
        "weight1", "bias1", "weight2", "bias2"]
    with pytest.raises(ValueError, match="unconsumed"):
        dense_params_from_jax({"params": {"kernel": np.ones((2, 2)),
                                          "scale": np.ones(2)}})
