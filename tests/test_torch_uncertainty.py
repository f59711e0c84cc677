"""PyTorch port, GLUE weights and prediction limits against JAX (CPU).

``rrmpg_tpu_torch.tools.uncertainty`` computes on the card unless asked
for the CPU (``device='cpu'`` here); its results are numpy, as the JAX
package's.  Weights must equal JAX's to ``rtol=1e-12`` (one sum and one
division per member); prediction limits are members' own values picked by
the same weighted-CDF rule, so they must be equal, with and without
``batch_size``.  The errors are JAX's: all-zero weights raise
``ValueError``, a bad ``batch_size`` ``TypeError``.
"""

import numpy as np
import pytest
import torch

from rrmpg_tpu.tools import uncertainty as jax_glue
from rrmpg_tpu_torch.tools import glue_weights, prediction_limits

torch.set_num_threads(1)

QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


def _ensemble(T=60, N=300, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(5.0, 1.0, N)
    qsim = centers[None, :] + rng.normal(0, 0.3, (T, N))
    scores = 1.0 - np.abs(centers - 5.0)
    return qsim, scores


@pytest.mark.parametrize("higher,threshold", [(True, 0.0), (True, 0.6),
                                              (False, 0.5), (False, 2.0)])
def test_glue_weights_match_jax(higher, threshold):
    _, scores = _ensemble()
    if not higher:
        scores = -scores + 1.0          # losses: lower is better
    want = jax_glue.glue_weights(scores, threshold, higher)
    got = glue_weights(scores, threshold, higher, device='cpu')
    assert isinstance(got, np.ndarray) and got.shape == scores.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isclose(got.sum(), 1.0)


def test_glue_weights_non_finite_and_none_behavioural():
    scores = np.array([0.8, 0.4, -0.2, np.nan, np.inf, -np.inf, 0.0])
    got = glue_weights(scores, device='cpu')
    np.testing.assert_allclose(got, jax_glue.glue_weights(scores),
                               rtol=1e-12, atol=0)
    assert (got[2:] == 0.0).all() and got[0] > got[1] > 0.0
    assert not glue_weights(np.array([-1.0, np.nan]), device='cpu').any()


@pytest.mark.parametrize("batch_size", [None, 7, 1, 60, 1000],
                         ids=["whole", "chunks-7", "chunks-1", "exact",
                              "larger"])
def test_prediction_limits_match_jax(batch_size):
    qsim, scores = _ensemble()
    w = jax_glue.glue_weights(scores, 0.3)
    want = jax_glue.prediction_limits(qsim, w, QUANTILES,
                                      batch_size=batch_size)
    got = prediction_limits(qsim, w, QUANTILES, batch_size=batch_size,
                            device='cpu')
    assert isinstance(got, np.ndarray) and got.shape == (5, 60)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got, axis=0) >= 0)


def test_prediction_limits_take_a_tensor_and_float32():
    qsim, scores = _ensemble(seed=2)
    w = glue_weights(scores, 0.0, device='cpu')
    want = prediction_limits(qsim, w, device='cpu')
    got = prediction_limits(torch.as_tensor(qsim), w, device='cpu')
    np.testing.assert_array_equal(got, want)
    got32 = prediction_limits(qsim.astype(np.float32), w, device='cpu')
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want, rtol=1e-6)


def test_prediction_limits_all_zero_weights_raise():
    for fn in (jax_glue.prediction_limits,
               lambda q, w: prediction_limits(q, w, device='cpu')):
        with pytest.raises(ValueError, match="No behavioral"):
            fn(np.ones((10, 3)), np.zeros(3))


@pytest.mark.parametrize("batch_size", [0, 2.5, "3"])
def test_prediction_limits_bad_batch_size_raises(batch_size):
    """TypeError in both packages (for a string, from the comparison with
    T, as in JAX)."""
    qsim, scores = _ensemble(T=20, N=30)
    w = glue_weights(scores, device='cpu')
    match = None if isinstance(batch_size, str) else "batch_size"
    with pytest.raises(TypeError, match=match):
        prediction_limits(qsim, w, batch_size=batch_size, device='cpu')
    with pytest.raises(TypeError, match=match):
        jax_glue.prediction_limits(qsim, w, batch_size=batch_size)


def test_glue_on_a_port_monte_carlo():
    """GLUE end to end on the port: a Monte-Carlo of ABC, weights by NSE,
    limits that cover most observations; the same ensemble through JAX's
    GLUE gives the same limits."""
    from rrmpg_tpu_torch.models import ABCModel
    from rrmpg_tpu_torch.tools import monte_carlo

    prec = np.random.default_rng(1).uniform(0, 15, 400)
    truth = ABCModel(params={'a': 0.4, 'b': 0.2, 'c': 0.3}, device='cpu',
                     dtype=torch.float64)
    qobs = truth.simulate(prec).numpy().ravel()
    np.random.seed(0)
    mc = monte_carlo(ABCModel(device='cpu', dtype=torch.float64), 256,
                     qobs=qobs, prec=prec, metrics=('nse',))
    w = glue_weights(mc['nse'], behavioral_threshold=0.0, device='cpu')
    assert w.sum() > 0
    lo, hi = prediction_limits(mc['qsim'], w, quantiles=(0.05, 0.95),
                               device='cpu')
    assert np.mean((qobs >= lo) & (qobs <= hi)) > 0.5
    np.testing.assert_array_equal(
        np.stack([lo, hi]),
        jax_glue.prediction_limits(mc['qsim'], w, quantiles=(0.05, 0.95)))


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        glue_weights(np.ones(3))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        prediction_limits(np.ones((4, 3)), np.ones(3) / 3)
