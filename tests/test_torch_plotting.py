"""PyTorch port, the plotting helpers (CPU, headless backend).

``rrmpg_tpu_torch.utils.plot_utils`` draws what
``rrmpg_tpu.utils.plot_utils`` draws: the same figure elements as
``tests/test_plotting.py`` for all four functions, from numpy arrays and
from tensors, and the same errors.  The port's result types (Sobol',
Morris, the Pareto front, the assimilation diagnostics) are drawn as they
come out of the port's tools.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rrmpg_tpu_torch.tools.assimilation import EnKFDiagnostics  # noqa: E402
from rrmpg_tpu_torch.tools.moo import ParetoResult  # noqa: E402
from rrmpg_tpu_torch.tools.sensitivity import (  # noqa: E402
    MorrisResult, SobolResult)
from rrmpg_tpu_torch.utils.plot_utils import (  # noqa: E402
    plot_assimilation, plot_pareto_front, plot_qsim_range, plot_sensitivity)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_qsim_range_basic(as_tensor):
    qsim = np.random.default_rng(0).uniform(0, 5, (100, 30))
    fig, ax = plot_qsim_range(torch.tensor(qsim) if as_tensor else qsim)
    assert len(ax.lines) == 1
    assert len(ax.collections) == 2  # two quantile bands
    np.testing.assert_allclose(ax.lines[0].get_ydata(), qsim.mean(axis=1))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_qsim_range_with_obs_and_x(as_tensor):
    rng = np.random.default_rng(1)
    qsim, qobs, x = rng.uniform(0, 5, (50, 10)), rng.uniform(0, 5, 50), \
        np.arange(50)
    conv = torch.tensor if as_tensor else np.asarray
    fig, ax = plot_qsim_range(conv(qsim), x_vals=conv(x), qobs=conv(qobs))
    assert len(ax.lines) == 2
    np.testing.assert_allclose(ax.lines[1].get_ydata(), qobs)


def test_plot_qsim_range_errors():
    with pytest.raises(ValueError):
        plot_qsim_range(np.zeros(10))  # not 2-D
    with pytest.raises(ValueError):
        plot_qsim_range(np.zeros((10, 3)), qobs=np.zeros((5, 2)))
    with pytest.raises(ValueError):
        plot_qsim_range(np.zeros((10, 3)), x_vals="dates")
    with pytest.raises(ValueError):
        plot_qsim_range(torch.zeros(10))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_sensitivity_sobol_and_morris(as_tensor):
    conv = torch.tensor if as_tensor else np.asarray
    sob = SobolResult(s1=conv([0.3, 0.5]), st=conv([0.4, 0.6]),
                      s1_conf=conv([0.02, 0.03]), st_conf=conv([0.02, 0.03]),
                      mean=1.0, var=2.0, n=64, n_used=64, nfev=256,
                      names=('a', 'b'))
    fig, ax = plot_sensitivity(sob)
    assert len(ax.patches) == 4  # 2 params x 2 index families
    assert [t.get_text() for t in ax.get_xticklabels()] == ['a', 'b']

    mor = MorrisResult(mu=conv([1.0, -2.0]), mu_star=conv([1.0, 2.0]),
                       sigma=conv([0.1, 0.4]), mu_star_conf=conv([0.05, 0.1]),
                       n_effects=np.array([8, 8]), nfev=24, names=None)
    fig, ax = plot_sensitivity(mor)
    assert len(ax.patches) == 4

    with pytest.raises(TypeError):
        plot_sensitivity({"not": "a result"})


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_pareto_front(as_tensor):
    conv = torch.tensor if as_tensor else np.asarray
    f1 = np.linspace(0, 1, 5)
    front = np.column_stack([f1, 1 - f1])
    pop_f = np.vstack([front, front + 0.3])
    res = ParetoResult(x=np.zeros((5, 3)), f=conv(front),
                       population=np.zeros((10, 3)), population_f=conv(pop_f),
                       rank=conv(np.array([0] * 5 + [1] * 5)), nit=3, nfev=40)
    fig, ax = plot_pareto_front(res, labels=("L_q", "L_sca"))
    assert len(ax.lines) == 1 and len(ax.collections) == 1
    assert ax.get_xlabel() == "L_q" and ax.get_ylabel() == "L_sca"

    bad = res._replace(f=np.zeros((5, 3)))
    with pytest.raises(ValueError):
        plot_pareto_front(bad)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_assimilation(as_tensor):
    rng = np.random.default_rng(2)
    conv = torch.tensor if as_tensor else np.asarray
    diags = EnKFDiagnostics(innovation=conv(rng.normal(0, 1, (12, 1))),
                            prior_spread=conv(rng.uniform(0, 1, 12)),
                            posterior_mean=np.zeros((12, 4)))
    fig, (ax1, ax2) = plot_assimilation(diags)
    assert ax1.lines and ax2.lines
    assert "spread" in ax2.lines[0].get_label()

    diags_pf = diags._replace(ess=conv(rng.uniform(1, 64, 12)))
    fig, (ax1, ax2) = plot_assimilation(diags_pf)
    assert ax2.lines and "sample size" in ax2.lines[0].get_label()


def test_plot_assimilation_of_a_cycle():
    """The diagnostics as ``assimilation_cycle`` returns them."""
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.tools import assimilation_cycle, perturb_state

    rng = np.random.default_rng(3)
    prec, etp = rng.gamma(0.8, 6.0, 60), rng.uniform(1, 4, 60)
    model = GR4J(params={'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7},
                 device='cpu', dtype=torch.float64)
    obs = model.simulate(prec, etp, s_init=0.6, r_init=0.5)[:, 0].numpy()
    params = {k: np.full(16, v) for k, v in model.get_params().items()}
    _, st = model.simulate(prec[:10], etp[:10], params=params,
                           return_final_state=True)
    st = perturb_state(st, torch.Generator().manual_seed(0))
    _, _, _, diags = assimilation_cycle(
        model, {'prec': prec[10:], 'etp': etp[10:]}, obs[10:], 10, 0.05,
        params=params, initial_state=st, backend='scan')
    fig, (ax1, ax2) = plot_assimilation(diags)
    # lines[0] is the zero line.
    np.testing.assert_allclose(ax1.lines[1].get_ydata(),
                               diags.innovation[:, 0])
