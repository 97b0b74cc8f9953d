"""Gradients of the port's differentiable CARAFE sites (``CarafeFn``: kernel
forward, composition-vjp backward; on the CPU the forward runs the kernels'
plain versions) against ``jax.grad`` through the
JAX ``custom_vjp`` pair ``carafe_up`` / ``carafe_tail`` (Pallas forward in
interpret mode, XLA-composition backward).

Tolerances: float32 rtol = atol = 1e-4 (different summation orders, as
test_torch_carafe.py); bf16 relative L2 error <= 0.02.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops.pallas import carafe_tail as jax_ct
from cswin_unet_tpu_torch.ops.cuda.carafe_tail import (CarafeFn, carafe_tail,
                                                       carafe_up)

torch.set_num_threads(2)

ORDER = ("down_kernel", "down_bias", "encoder_kernel", "encoder_bias",
         "out_kernel", "out_bias", "cls_kernel")


def _params(rng, C, C_out, up, nc=None):
    cm = C // 4
    mk = lambda *s, sc=0.2: (rng.standard_normal(s) * sc).astype(np.float32)
    p = [mk(1, 1, C, cm), mk(cm), mk(3, 3, cm, 9 * up * up), mk(9 * up * up),
         mk(1, 1, C, C_out), mk(C_out)]
    return p + ([mk(1, 1, C_out, nc)] if nc else [])


def _oihw(a):
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)


def _hwio(a):
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _grads(fn_name, up, x, params, g, dtype):
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    jfn = getattr(jax_ct, fn_name)
    _, vjp = jax.vjp(lambda a, *p: jfn(a, *p, up_factor=up),
                     jnp.asarray(x).astype(dtype), *map(jnp.asarray, params))
    want = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g).astype(dtype))]

    fn = {"carafe_up": carafe_up, "carafe_tail": carafe_tail}[fn_name]
    leaves = [torch.from_numpy(x).to(tdtype).requires_grad_()] + [
        torch.from_numpy(_oihw(p)).requires_grad_() for p in params]
    out = fn(*leaves, up_factor=up)
    out.backward(torch.from_numpy(g).to(tdtype))
    got = [leaves[0].grad.float().numpy()] + [
        _hwio(t.grad.float().numpy()) for t in leaves[1:]]
    return got, want


@pytest.mark.parametrize("fn_name,up,nc", [("carafe_up", 2, None),
                                           ("carafe_tail", 4, 5)])
def test_carafe_fn_grads_f32_match_jax(fn_name, up, nc, monkeypatch):
    calls = []
    apply = CarafeFn.apply
    monkeypatch.setattr(CarafeFn, "apply", lambda *a: calls.append(1) or apply(*a))
    rng = np.random.default_rng(7)
    C = 16
    params = _params(rng, C, 8, up, nc)
    x = rng.standard_normal((2, 6, 5, C)).astype(np.float32)
    g = rng.standard_normal((2, 6 * up, 5 * up, nc or 8)).astype(np.float32)
    got, want = _grads(fn_name, up, x, params, g, jnp.float32)
    assert calls == [1]
    assert len(got) == len(want) == 7 + (nc is not None)
    for name, a, b in zip(("x",) + ORDER, got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("fn_name,up,nc", [("carafe_up", 2, None),
                                           ("carafe_tail", 4, 5)])
def test_carafe_fn_grads_bf16_match_jax(fn_name, up, nc):
    rng = np.random.default_rng(8)
    C = 16
    params = _params(rng, C, 8, up, nc)
    x = rng.standard_normal((2, 6, 6, C)).astype(np.float32)
    g = rng.standard_normal((2, 6 * up, 6 * up, nc or 8)).astype(np.float32)
    got, want = _grads(fn_name, up, x, params, g, jnp.bfloat16)
    for name, a, b in zip(("x",) + ORDER, got, want):
        assert _rel_l2(a, b) <= 0.02, (name, _rel_l2(a, b))
