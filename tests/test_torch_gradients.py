"""PyTorch port, gradients of the ``'scan'`` engine against JAX's (CPU,
float64).

Counterpart of ``tests/test_gradients.py``: the same MSE objectives over
250-300 steps of ``run_abcmodel``, ``run_gr4j``, ``run_hbvedu`` and
``run_cemaneigegr4j``, differentiated by ``torch.autograd`` in the port and
by ``jax.grad`` in the JAX package, on the same numpy inputs.  Both run the
same float64 equations through the same ``where``-based branches, so their
gradients agree at ``rtol=1e-9`` (measured differences ~1e-13): this is
what ``differential_evolution(polish=True)`` and ``gradient_descent``
differentiate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrmpg_tpu.ops as jax_ops
from rrmpg_tpu_torch import ops

torch.set_num_threads(1)

RTOL = 1e-9
F64 = torch.float64


def _as_t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _port_grads(loss, params):
    """``loss`` of one-member (1,) leaf tensors, and its gradient; a
    parameter that reaches the loss only through comparisons (CTG, whose
    thermal state only gates melt) is outside the graph: its gradient is 0,
    as ``jax.grad`` gives it."""
    leaves = {k: torch.tensor([v], dtype=F64, requires_grad=True)
              for k, v in params.items()}
    val = loss(leaves)
    grads = torch.autograd.grad(val, list(leaves.values()),
                                allow_unused=True)
    return float(val.detach()), {k: 0.0 if g is None else float(g[0])
                                 for k, g in zip(leaves, grads)}


def _jax_grads(loss, params):
    val, grads = jax.value_and_grad(loss)(
        {k: jnp.asarray(v, jnp.float64) for k, v in params.items()})
    return float(val), {k: float(g) for k, g in grads.items()}


def _compare(port_loss, jax_loss, params):
    got_val, got = _port_grads(port_loss, params)
    want_val, want = _jax_grads(jax_loss, params)
    np.testing.assert_allclose(got_val, want_val, rtol=RTOL)
    for name in params:
        assert np.isfinite(got[name]), f"non-finite gradient for {name}"
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   err_msg=name)
    assert any(abs(g) > 0 for g in got.values())


def _abc():
    rng = np.random.default_rng(0)
    prec, qobs = rng.uniform(0, 20, 300), rng.uniform(0, 3, 300)

    def port(p):
        qsim = ops.run_abcmodel(_as_t(prec), 2.0, p)[0].reshape(-1)
        return ((qsim - _as_t(qobs)) ** 2).mean()

    def ref(p):
        qsim, _ = jax_ops.run_abcmodel(jnp.asarray(prec), 2.0, p)
        return jnp.mean((qsim - jnp.asarray(qobs)) ** 2)

    return port, ref, {'a': 0.3, 'b': 0.2, 'c': 0.15}


def _gr4j():
    rng = np.random.default_rng(1)
    prec, etp = rng.uniform(0, 15, 300), rng.uniform(0, 4, 300)
    qobs = rng.uniform(0, 5, 300)

    def port(p):
        qsim = ops.run_gr4j(_as_t(prec), _as_t(etp), 0.4, 0.3,
                            p)[0].reshape(-1)
        return ((qsim - _as_t(qobs)) ** 2).mean()

    def ref(p):
        qsim, _, _ = jax_ops.run_gr4j(jnp.asarray(prec), jnp.asarray(etp),
                                      0.4, 0.3, p)
        return jnp.mean((qsim - jnp.asarray(qobs)) ** 2)

    return port, ref, {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}


def _hbv():
    rng = np.random.default_rng(2)
    T = 250
    temp, prec = rng.uniform(-10, 20, T), rng.uniform(0, 15, T)
    month = rng.integers(0, 12, T)
    pe_m, t_m = rng.uniform(0.5, 4, 12), rng.uniform(-5, 15, 12)
    qobs = rng.uniform(0, 3, T)
    inits = (0.0, 100.0, 3.0, 10.0)

    def port(p):
        qsim = ops.run_hbvedu(_as_t(temp), _as_t(prec),
                              torch.as_tensor(month), _as_t(pe_m),
                              _as_t(t_m), *inits, p)[0].reshape(-1)
        return ((qsim - _as_t(qobs)) ** 2).mean()

    def ref(p):
        qsim, *_ = jax_ops.run_hbvedu(
            jnp.asarray(temp), jnp.asarray(prec), jnp.asarray(month),
            jnp.asarray(pe_m), jnp.asarray(t_m), *inits, p)
        return jnp.mean((qsim - jnp.asarray(qobs)) ** 2)

    return port, ref, {'T_t': 0.2, 'DD': 4.5, 'FC': 150.0, 'Beta': 2.2,
                       'C': 0.03, 'PWP': 110.0, 'K_0': 0.1, 'K_1': 0.05,
                       'K_2': 0.02, 'K_p': 0.03, 'L': 3.0}


def _cemaneigegr4j():
    rng = np.random.default_rng(3)
    T, L = 250, 5
    prec = rng.uniform(0, 15, (T, L))
    temp = rng.uniform(-10, 15, (T, L))
    frac = np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1)
    etp, qobs = rng.uniform(0, 4, T), rng.uniform(0, 5, T)

    def port(p):
        qsim = ops.run_cemaneigegr4j(_as_t(prec), _as_t(temp), _as_t(etp),
                                     _as_t(frac), 2.0, -1.0, 0.4, 0.3,
                                     p)[0].reshape(-1)
        return ((qsim - _as_t(qobs)) ** 2).mean()

    def ref(p):
        qsim, *_ = jax_ops.run_cemaneigegr4j(
            jnp.asarray(prec), jnp.asarray(temp), jnp.asarray(etp),
            jnp.asarray(frac), 2.0, -1.0, 0.4, 0.3, p)
        return jnp.mean((qsim - jnp.asarray(qobs)) ** 2)

    return port, ref, {'CTG': 0.3, 'Kf': 3.7, 'x1': 300.0, 'x2': 1.0,
                       'x3': 90.0, 'x4': 2.0}


@pytest.mark.f64only
@pytest.mark.parametrize("family", [_abc, _gr4j, _hbv, _cemaneigegr4j],
                         ids=["abc", "gr4j", "hbvedu", "cemaneigegr4j"])
def test_scan_gradients_equal_jax(family):
    _compare(*family())
