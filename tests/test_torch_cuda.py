"""PyTorch port, the hand-written CUDA kernels on an NVIDIA GPU.

Every test here needs the card and skips elsewhere.  The file imports no
JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel (GR4J K1 MSE, K2 stats, K3 trajectories (also bit for bit
K4's cold entry), K4 trajectories + state; ABC K6 single launch (also at
its chunk edges, and the same bits from run to run), K7 three launches
(also at its chunk edges, for 1, 7 and 4096 members);
the snow family's K8
objective, K9 trajectories and K10 trajectories + state; HBV-Edu K12
objective, K13 trajectories, K14 trajectories + state; the warm entry of
the objectives; the regional K5 and K11, one and three catchments in a
launch; the staged K1/K2, K5, K8, K11 and K12 at the edges of their 64-step
tiles, K9 at the edges of its 32-step staging and store tiles) is held
against its plain PyTorch version on the same CUDA tensors,
and the regional objectives on the card against the same calls on CPU
tensors.  Tolerances:
float64 ``rtol=1e-9, atol=1e-12`` (the same operations in another order);
float32 trajectories ``rtol=5e-3, atol=1e-3`` and objectives
``rtol=2e-2`` (rounding compounds over the recurrence; rrmpg_tpu's own
fused-vs-XLA float32 drift is 8.5e-3 relative).  DE on the card: a fused
fit checkpointed and resumed equals the unbroken one bit for bit, and
``polish=True`` on the fused engine is skipped with JAX's message.  The ABC scan in float32
is held to ``1e-4`` of each series' largest value: the
parallel order of the sums differs from the plain version's.  HBV-Edu
members whose soil store goes negative are NaN in kernel and plain
version alike; the NaN sets must be equal.  The snow kernels write the
snow step's products without fused multiply-adds, so their snow state is the
plain version's bit for bit: the snow-only outflow must be equal, not close.
K8 (layers in registers at 1 and 5 layers, in shared memory otherwise) and
K12 stage their forcing 64 steps at a time; their cases at T shorter than,
equal to and not a multiple of a tile, with N = 200 (a ragged last block)
and gaps at the tile edges, check the staging with the same tolerances.
Ensemble data assimilation: the scan backend against the host backend
through the warm entry of K4, K14 and K10 (GR4J, HBV-Edu, hyst + ice; 129
and 200 members, 7 cycles of 9 days, EnKF with parameters and the particle
filter) at the trajectory tolerances, the scan backend's window loop under
``torch.cuda.set_sync_debug_mode('error')``, and the resampling index
clamped where a float32 sum of the weights ends short.  The masked metrics
give a member the same bits in any row of a batch, and GR4J's
``fit(method='sce', engine='scan')`` on 4 shards of one card is the
unsharded SCE fit bit for bit.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from rrmpg_tpu_torch import models
from rrmpg_tpu_torch.models import GR4J, ABCModel, HBVEdu
from rrmpg_tpu_torch.ops import abc, fused_abc as fa
from rrmpg_tpu_torch.ops import fused_gr4j as fg
from rrmpg_tpu_torch.ops import fused_hbv as fh
from rrmpg_tpu_torch.ops import fused_snow as fs

pytestmark = pytest.mark.cuda

DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')
TOL = {torch.float64: {"traj": (1e-9, 1e-12), "obj": (1e-9, 1e-12)},
       torch.float32: {"traj": (5e-3, 1e-3), "obj": (2e-2, 0.0)}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(device, dtype, T=500, N=300, x4_max=9.9, gaps=False, seed=0):
    rng = np.random.default_rng(seed)
    qobs = rng.uniform(0, 5, T)
    if gaps:
        qobs[::11] = np.nan
    series = [torch.tensor(a, dtype=dtype, device=device)
              for a in (rng.uniform(0, 15, T), rng.uniform(0, 4, T), qobs)]
    params = {'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, x4_max, N)}
    return (*series, {k: torch.tensor(v, dtype=dtype, device=device)
                      for k, v in params.items()})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("mode", ["traj", "mse", "stats", "mse+masked",
                                  "stats+masked"])
def test_kernel_matches_plain(cuda, dtype, n1, n2, x4_max, mode):
    masked = mode.endswith("masked")
    prec, etp, qobs, params = _inputs(cuda, dtype, x4_max=x4_max,
                                      gaps=masked)
    packed = fg.pack_params(params, 0.4, 0.3)
    fg.reset_launches()
    if mode == "traj":
        got = fg.gr4j_simulate_fused(prec, etp, 0.4, 0.3, params, n1, n2)
        want = fg.gr4j_simulate_reference(prec, etp, packed, n1, n2)
        rtol, atol = TOL[dtype]["traj"]
        kernel = "gr4j_traj"
    else:
        stats = mode.startswith("stats")
        count = int(torch.isfinite(qobs).sum())
        got = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.4, 0.3, params,
                                         n1, n2, stats=stats, masked=masked)
        want = fg.gr4j_objective_reference(prec, etp, qobs, packed, n1, n2,
                                           stats, masked, count)
        rtol, atol = TOL[dtype]["obj"]
        kernel = "gr4j_stats" if stats else "gr4j_mse"
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kernel] == 1
    assert got.device.type == "cuda" and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_golden_excel_trajectory_fused_float64(cuda):
    params = {'x1': np.exp(5.76865628090826),
              'x2': np.sinh(1.61742503661094),
              'x3': np.exp(4.24316129943456),
              'x4': np.exp(-0.117506799276908) + 0.5}
    data = pd.read_csv(os.path.join(DATA_DIR, 'gr4j_example_data.csv'))
    model = GR4J(params=params, device=cuda, dtype=torch.float64)
    qsim = model.simulate(data.prec, data.etp, s_init=0.6, r_init=0.7,
                          engine='fused')
    assert np.allclose(qsim.cpu().numpy().ravel(), data.qsim_excel)


def test_fit_launches_one_kernel_per_generation(cuda):
    rng = np.random.default_rng(3)
    prec, etp = rng.uniform(0, 15, 400), rng.uniform(0, 4, 400)
    qobs = GR4J(params={'x1': 500.0, 'x2': 0.5, 'x3': 80.0, 'x4': 2.0},
                dtype=torch.float64).simulate(prec, etp).cpu().numpy().ravel()
    fg.reset_launches()
    res = GR4J(device=cuda).fit(qobs, prec, etp, engine='fused', seed=0,
                                maxiter=4)
    assert fg.LAUNCHES["gr4j_mse"] == res.nit + 1
    assert np.isfinite(res.fun)


def test_mixed_devices_raise(cuda):
    prec, etp, _, params = _inputs(cuda, torch.float32, N=4, T=10)
    with pytest.raises(ValueError, match="one device"):
        fg.gr4j_simulate_fused(prec.cpu(), etp.cpu(), 0.0, 0.0, params)


# ---------------------------------------------------------------------------
# ABC: K6 (one launch) and K7 (three launches)
# ---------------------------------------------------------------------------

def _abc_close(got, want):
    if want.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    else:
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [1, 1000, 70000, 1_000_003])
@pytest.mark.parametrize("c", [0.0, 0.12, 1.0])
def test_abc_kernels_match_plain(cuda, dtype, T, c):
    prec = torch.tensor(np.random.default_rng(T).uniform(0, 20, T),
                        dtype=dtype, device=cuda)
    params = {'a': 0.3, 'b': 0.4, 'c': c}
    want = abc.run_abcmodel_pscan(prec, 5.0, params)
    fg.reset_launches()
    single = fa.abc_fused_single(prec, 5.0, params)
    chunked = fa.abc_fused(prec, 5.0, params)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["abc_fused_single"] == 1
    assert fg.LAUNCHES["abc_fused"] == 1
    for got in (single, chunked):
        assert got[1][0].item() == 5.0 and got[0][0].item() == 0.0
        for g, w in zip(got, want):
            assert g.shape == (T,) and g.dtype == dtype
            _abc_close(g, w)
    for g, w in zip(single, chunked):
        _abc_close(g, w)
    if T <= 20000:
        for g, w in zip(single, abc.run_abcmodel(prec, 5.0, params)):
            _abc_close(g, w)


@pytest.mark.parametrize("kernel", [fa.abc_fused_single, fa.abc_fused])
def test_abc_kernels_members_in_one_launch(cuda, kernel):
    rng = np.random.default_rng(1)
    prec = torch.tensor(rng.uniform(0, 20, 9001), dtype=torch.float64,
                        device=cuda)
    np.random.seed(2)
    raw = ABCModel(device=cuda).get_random_params(num=37)
    params = {k: torch.tensor(raw[k], dtype=torch.float64, device=cuda)
              for k in 'abc'}
    s0 = torch.tensor(rng.uniform(0, 9, 37), dtype=torch.float64,
                      device=cuda)
    fg.reset_launches()
    got = kernel(prec, s0, params)
    # Twice in a row: the second launch must not see the first one's flags,
    # and gives the same bits (K6 composes in an order fixed by the chunk).
    again = kernel(prec, s0, params)
    torch.cuda.synchronize()
    assert sum(fg.LAUNCHES.values()) == 2
    for g, g2, w in zip(got, again, abc.run_abcmodel_pscan(prec, s0, params)):
        assert g.shape == (37, 9001)
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12)
        assert torch.equal(g2, g)


def _abc_chunk(dtype):
    from rrmpg_tpu_torch.ops._build import load_library

    return load_library().rrmpg_abc_chunk_size(int(dtype == torch.float64))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunks,extra", [(1, -1), (1, 0), (1, 1), (32, 1),
                                          (300, 17)])
def test_abc_single_kernel_at_chunk_edges(cuda, dtype, chunks, extra):
    """K6 one step short of, at and one past a chunk, 33 chunks whose last
    is one step long, and 301 chunks (Fenwick nodes up to 256 chunks), with
    members at c = 0, 0.12 and 1, against the doubling scan and K7."""
    t_len = chunks * _abc_chunk(dtype) + extra
    rng = np.random.default_rng(t_len)
    prec = torch.tensor(rng.uniform(0, 20, t_len), dtype=dtype, device=cuda)
    params = {'a': torch.tensor([0.3, 0.2, 0.5], dtype=dtype, device=cuda),
              'b': torch.tensor([0.4, 0.1, 0.3], dtype=dtype, device=cuda),
              'c': torch.tensor([0.0, 0.12, 1.0], dtype=dtype, device=cuda)}
    s0 = torch.tensor([5.0, 0.0, 2.5], dtype=dtype, device=cuda)
    got = fa.abc_fused_single(prec, s0, params)
    for g, w, k7 in zip(got, abc.run_abcmodel_pscan(prec, s0, params),
                        fa.abc_fused(prec, s0, params)):
        assert g.shape == (3, t_len)
        for row in range(3):
            _abc_close(g[row], w[row])
            _abc_close(g[row], k7[row])
    assert torch.equal(got[1][:, 0], s0)
    assert not bool(got[0][:, 0].any())


@pytest.mark.parametrize("shape", [(1, 1_000_003), (512, 12418)])
def test_abc_single_kernel_is_bit_reproducible(cuda, shape):
    """K6 five times on the same inputs: the same bits every time (one long
    series of 245 chunks; many members of four chunks)."""
    n, t_len = shape
    rng = np.random.default_rng(4)
    prec = torch.tensor(rng.uniform(0, 20, t_len), dtype=torch.float32,
                        device=cuda)
    a = rng.uniform(0, 1, n)
    params = {k: torch.tensor(v, dtype=torch.float32, device=cuda)
              for k, v in (('a', a), ('b', rng.uniform(0, 1 - a)),
                           ('c', rng.uniform(0, 1, n)))}
    s0 = torch.tensor(rng.uniform(0, 9, n), dtype=torch.float32, device=cuda)
    first = fa.abc_fused_single(prec, s0, params)
    for _ in range(4):
        for g, f in zip(fa.abc_fused_single(prec, s0, params), first):
            assert torch.equal(g, f)


K7_EDGES = [(n, chunks) for n in (1, 4096) for chunks in (1, 2, 32, 33)] + [
    (7, 256), (7, 257)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,chunks", K7_EDGES)
@pytest.mark.parametrize("last", ["one_step", "full"])
def test_abc_chunked_kernel_at_chunk_edges(cuda, dtype, n, chunks, last):
    """K7 with ``chunks`` chunks a member, the last one step long or full,
    for one member, 4096 members and 7 (one carry block of 8 members a warp,
    part-filled; at 257 chunks a team of two warps a member), against the
    doubling scan and K6."""
    chunk = _abc_chunk(dtype)
    t_len = (chunks - 1) * chunk + 1 if last == "one_step" else chunks * chunk
    rng = np.random.default_rng(chunks * 7 + n)
    prec = torch.tensor(rng.uniform(0, 20, t_len), dtype=dtype, device=cuda)
    a = rng.uniform(0, 1, n)
    c = rng.uniform(0, 1, n)
    c[:3] = (0.0, 0.12, 1.0)[:n]
    params = {k: torch.tensor(v, dtype=dtype, device=cuda)
              for k, v in (('a', a), ('b', rng.uniform(0, 1 - a)), ('c', c))}
    s0 = torch.tensor(rng.uniform(0, 9, n), dtype=dtype, device=cuda)
    fg.reset_launches()
    got = fa.abc_fused(prec, s0, params)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["abc_fused"] == 1
    want = abc.run_abcmodel_pscan(prec, s0, params)
    single = fa.abc_fused_single(prec, s0, params)
    for g, w, k6 in zip(got, want, single):
        assert g.shape == (n, t_len) and g.dtype == dtype
        _abc_close(g, w)
        _abc_close(g, k6)
    assert torch.equal(got[1][:, 0], s0)
    assert not bool(got[0][:, 0].any())


@pytest.mark.parametrize("kernel", ["abc_fused_single", "abc_fused",
                                    "run_abcmodel_pscan"])
def test_abc_float32_tracks_float64(cuda, kernel):
    """In float32, K6, K7 and the doubling scan stay within ``abc_tol`` of
    the float64 doubling scan on the same inputs where a small c (7e-5)
    makes the store remember thousands of steps: 4096 members x 32 chunks.
    Maps kept as (1 - A, B) round no (1 - c); with A kept, both kernels
    strayed past it."""
    fn = abc.run_abcmodel_pscan if kernel == "run_abcmodel_pscan" else \
        getattr(fa, kernel)
    t_len = 32 * _abc_chunk(torch.float32)
    rng = np.random.default_rng(5)
    prec = torch.tensor(rng.uniform(0, 20, t_len), dtype=torch.float32,
                        device=cuda)
    a = rng.uniform(0, 1, 4096)
    c = rng.uniform(0, 1, 4096)
    c[:4] = (0.0, 0.12, 1.0, 7e-5)
    params = {k: torch.tensor(v, dtype=torch.float32, device=cuda)
              for k, v in (('a', a), ('b', rng.uniform(0, 1 - a)), ('c', c))}
    s0 = torch.tensor(rng.uniform(0, 9, 4096), dtype=torch.float32,
                      device=cuda)
    exact = abc.run_abcmodel_pscan(prec.double(), s0.double(),
                                   {k: v.double() for k, v in params.items()})
    for g, w in zip(fn(prec, s0, params), exact):
        torch.testing.assert_close(g.double(), w, rtol=0.0,
                                   atol=1e-4 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# DE on the card: checkpoint and resume, polish
# ---------------------------------------------------------------------------

def _fit_inputs():
    rng = np.random.default_rng(3)
    prec, etp = rng.uniform(0, 15, 400), rng.uniform(0, 4, 400)
    qobs = GR4J(params={'x1': 500.0, 'x2': 0.5, 'x3': 80.0, 'x4': 2.0},
                dtype=torch.float64).simulate(prec, etp).cpu().numpy().ravel()
    return qobs, prec, etp


def test_fused_fit_resumed_equals_unbroken(cuda, tmp_path):
    """Seven generations saved every five, resumed to twelve: the card's
    generator state comes back from the file, so the resumed fit walks the
    unbroken one's population bit for bit."""
    qobs, prec, etp = _fit_inputs()
    path = str(tmp_path / "fit.npz")
    kw = dict(engine='fused', seed=0, tol=0.0)
    full = GR4J(device=cuda).fit(qobs, prec, etp, maxiter=12, **kw)
    GR4J(device=cuda).fit(qobs, prec, etp, maxiter=7, checkpoint_path=path,
                          checkpoint_every=5, **kw)
    fg.reset_launches()
    resumed = GR4J(device=cuda).fit(qobs, prec, etp, maxiter=12,
                                    resume_from=path, **kw)
    assert fg.LAUNCHES["gr4j_mse"] == 5          # no initial population
    assert resumed.nit == full.nit == 12 and resumed.nfev == full.nfev
    assert resumed.fun == full.fun
    np.testing.assert_array_equal(resumed.population, full.population)
    np.testing.assert_array_equal(resumed.population_energies,
                                  full.population_energies)


def test_fused_fit_polish_is_skipped_and_scan_polish_runs(cuda):
    """The fused kernels have no backward: ``polish=True`` leaves the fit as
    it was and says so.  The 'scan' engine is differentiated on the card."""
    qobs, prec, etp = _fit_inputs()
    kw = dict(engine='fused', seed=0, maxiter=3)
    plain = GR4J(device=cuda).fit(qobs, prec, etp, **kw)
    polished = GR4J(device=cuda).fit(qobs, prec, etp, polish=True, **kw)
    assert polished.message == (plain.message
                                + " Polish skipped (RuntimeError).")
    assert polished.fun == plain.fun and polished.nfev == plain.nfev
    kw = dict(engine='scan', seed=0, maxiter=2)
    plain = GR4J(device=cuda).fit(qobs[:120], prec[:120], etp[:120], **kw)
    polished = GR4J(device=cuda).fit(qobs[:120], prec[:120], etp[:120],
                                     polish=True, polish_steps=3, **kw)
    assert "skipped" not in polished.message
    assert polished.nfev == plain.nfev + 4 and polished.fun <= plain.fun


# ---------------------------------------------------------------------------
# HBV-Edu: K12 (objective) and K13 (trajectories)
# ---------------------------------------------------------------------------

def _hbv_inputs(device, dtype, T=500, N=300, gaps=False, seed=0):
    rng = np.random.default_rng(seed)
    qobs = rng.uniform(0, 5, T)
    if gaps:
        qobs[::11] = np.nan
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    forcings = (as_t(rng.uniform(-8, 22, T)), as_t(rng.uniform(0, 15, T)),
                torch.tensor(rng.integers(0, 12, T), device=device),
                as_t(rng.uniform(0.5, 4, 12)), as_t(rng.uniform(-3, 18, 12)))
    bounds = HBVEdu._default_bounds
    params = {k: as_t(rng.uniform(*bounds[k], N)) for k in bounds}
    # Small field capacities empty the soil store: those members go NaN.
    params['FC'][:N // 10] = 2.0
    return forcings, as_t(qobs), params


def _assert_close_nan_aware(got, want, rtol, atol, some_nan=True):
    """NaN at the same places, the rest close; ``some_nan``: some but not
    all elements are NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if some_nan:
        assert 0 < int(nan.sum()) < nan.numel()
    torch.testing.assert_close(got[~nan], want[~nan], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["traj", "mse", "stats", "mse+masked",
                                  "stats+masked"])
def test_hbv_kernel_matches_plain(cuda, dtype, mode):
    masked = mode.endswith("masked")
    forcings, qobs, params = _hbv_inputs(cuda, dtype, gaps=masked)
    inits = (0.0, 100.0, 3.0, 10.0)
    packed = fh.pack_params(params, *inits)
    temp, prec, month, pe_m, t_m = forcings
    series = (temp, prec, pe_m[month], t_m[month])
    fg.reset_launches()
    if mode == "traj":
        got = fh.hbv_simulate_fused(*forcings, *inits, params)
        want = fh.hbv_simulate_reference(*series, packed)
        rtol, atol = TOL[dtype]["traj"]
        kernel = "hbv_traj"
    else:
        stats = mode.startswith("stats")
        count = int(torch.isfinite(qobs).sum())
        got = fh.hbv_ensemble_mse_fused(*forcings, qobs, *inits, params,
                                        stats=stats, masked=masked)
        want = fh.hbv_objective_reference(*series, qobs, packed, stats,
                                          masked, count)
        rtol, atol = TOL[dtype]["obj"]
        kernel = "hbv_stats" if stats else "hbv_mse"
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kernel] == 1
    assert got.device.type == "cuda" and got.dtype == dtype
    _assert_close_nan_aware(got, want, rtol, atol)


def _matlab_forcing():
    read = lambda name, **kw: pd.read_csv(os.path.join(DATA_DIR, name), **kw)
    daily = read('hbv_daily_inputs.txt', sep='\t',
                 names=['date', 'month', 'temp', 'prec'])
    monthly = read('hbv_monthly_inputs.txt', sep=' ',
                   names=['temp', 'not_needed', 'evap'])
    return daily, monthly


# K13's edges: one step (the initialization step alone), around and at its
# 64-step staging and store tiles, two whole tiles; one member, last blocks
# of 1 and of 72 members.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("N", [1, 129, 200])
def test_hbv_traj_tile_and_block_edges(cuda, dtype, T, N):
    """K13 on the MATLAB forcing, a tenth of the members (at least one)
    dry: the plain version's values with the same NaN members, and K14's
    cold entry bit for bit (one time loop serves both)."""
    daily, monthly = _matlab_forcing()
    as_t = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=cuda)
    forcings = (as_t(daily.temp[:T]), as_t(daily.prec[:T]),
                torch.tensor(daily.month.to_numpy()[:T] - 1, device=cuda),
                as_t(monthly.evap), as_t(monthly.temp))
    rng = np.random.default_rng(N)
    bounds = HBVEdu._default_bounds
    params = {k: as_t(rng.uniform(*bounds[k], N)) for k in bounds}
    params['FC'][:max(1, N // 10)] = 2.0
    inits = (0.0, 100.0, 3.0, 10.0)
    fg.reset_launches()
    got = fh.hbv_simulate_fused(*forcings, *inits, params)
    q_state, _ = fh.hbv_simulate_state_fused(*forcings, *inits, params)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["hbv_traj"] == fg.LAUNCHES["hbv_traj_state"] == 1
    want = fh.hbv_simulate_reference(
        *_hbv_series(forcings), fh.pack_params(params, *inits))
    _assert_close_nan_aware(got, want, *TOL[dtype]["traj"], some_nan=False)
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(q_state))
    assert torch.equal(got[~nan], q_state[~nan])


def test_golden_matlab_trajectory_fused_float64(cuda):
    read = lambda name, **kw: pd.read_csv(os.path.join(DATA_DIR, name), **kw)
    daily, monthly = _matlab_forcing()
    qsim_matlab = read('hbv_qsim.csv', header=None, names=['qsim'])
    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    model = HBVEdu(params=params, device=cuda, dtype=torch.float64)
    qsim = model.simulate(daily.temp, daily.prec, daily.month, monthly.evap,
                          monthly.temp, snow_init=0, soil_init=100,
                          s1_init=3, s2_init=10, engine='fused')
    qsim = (qsim.cpu().numpy().ravel() * 410 * 1000) / (24 * 60 * 60)
    assert np.allclose(qsim, qsim_matlab.qsim)


def test_default_device_is_the_card(cuda):
    classes = [getattr(models, name) for name in models.__all__]
    classes = [c for c in classes if isinstance(c, type)
               and issubclass(c, models.BaseModel)
               and c is not models.BaseModel]
    assert len(classes) == 8
    for cls in classes:
        assert cls().device.type == "cuda"


# ---------------------------------------------------------------------------
# The snow family: K8 (objective) and K9 (trajectories)
# ---------------------------------------------------------------------------

SNOW_INITS = (2.0, -1.0, 0.4, 0.3)       # snow pack, thermal state, s, r
ALTITUDES = [550, 620, 700, 785, 920]
FRAC_ICE = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
HYST_PARAMS = {"Thacc": 18.6, "Rsp": 0.22, "CTG": 0.78, "Kf": 4.02,
               "x1": 546, "x2": 0.53, "x3": 276, "x4": 1.32}
# variant -> (hyst, ice, snow_only, UH register lengths)
SNOW_VARIANTS = {"plain": (False, False, False, (3, 7)),
                 "hyst": (True, False, False, (10, 21)),
                 "ice": (False, True, False, (10, 21)),
                 "hyst+ice": (True, True, False, (3, 7)),
                 "snow-only": (False, False, True, (10, 21))}


def _snow_inputs(device, dtype, L, x4_hi, T=300, N=200, gaps=False, seed=0):
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    qobs = rng.uniform(1, 5, T)
    ndsi = rng.uniform(0, 100, (L, T))
    if gaps:
        qobs[::11] = np.nan
        ndsi[0, ::5] = np.nan
        ndsi[L - 1, 50:120] = np.nan
    layers = (as_t(rng.uniform(0, 15, (T, L))),
              as_t(rng.uniform(-12, 18, (T, L))),
              as_t(np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1)))
    params = {'CTG': rng.uniform(0, 1, N), 'Kf': rng.uniform(0, 10, N),
              'Thacc': rng.uniform(1, 100, N), 'Rsp': rng.uniform(0, 1, N),
              'x1': rng.uniform(10, 1200, N), 'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 5000, N),
              'x4': rng.uniform(1.1, x4_hi, N), 'DDF': rng.uniform(0, 30, N)}
    return (layers, as_t(rng.uniform(0, 4, T)), as_t(qobs), as_t(ndsi),
            as_t(rng.uniform(0, 0.7, L)),
            {k: as_t(v) for k, v in params.items()})


# The SCA statistics exist for the hysteresis variants only.
SNOW_CASES = [(variant, mode) for variant, flags in SNOW_VARIANTS.items()
              for mode in ("traj", "mse", "stats+masked", "sca_stats",
                           "sca_stats+masked")
              if flags[0] or not mode.startswith("sca_stats")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("variant,mode", SNOW_CASES)
def test_snow_kernel_matches_plain(cuda, dtype, L, variant, mode):
    hyst, ice, snow_only, uh = SNOW_VARIANTS[variant]
    masked = mode.endswith("masked")
    sca = mode.startswith("sca_stats")
    (prec, temp, frac), etp, qobs, ndsi, frac_ice, params = _snow_inputs(
        cuda, dtype, L, 2.9 if uh == (3, 7) else 9.9, gaps=masked)
    snow0, th0, s_init, r_init = SNOW_INITS
    variant_kw = dict(hyst=hyst, ice=ice, snow_only=snow_only,
                      num_uh1=uh[0], num_uh2=uh[1])
    packed = fs.pack_params(params, s_init, r_init, snow_only)
    snow, rain, consts = fs.layer_inputs(prec, frac, hyst)
    plain_args = (packed, consts,
                  frac_ice if ice else torch.zeros_like(frac_ice), snow0,
                  th0, hyst, ice, snow_only, *uh)
    fg.reset_launches()
    if mode == "traj":
        got = fs.snowgr4j_simulate_fused(
            prec, temp, etp, frac, *SNOW_INITS, params,
            frac_ice=frac_ice if ice else None, **variant_kw)
        want = fs.snowgr4j_simulate_reference(snow, rain, temp, etp,
                                              *plain_args)
        kernel, (rtol, atol) = "snow_traj", TOL[dtype]["traj"]
    else:
        stats = mode.startswith("stats")
        got = fs.snowgr4j_ensemble_mse_fused(
            prec, temp, etp, frac, qobs, *SNOW_INITS, params,
            frac_ice=frac_ice if ice else None, ndsi=ndsi if sca else None,
            stats=stats, sca_stats=sca, masked=masked, **variant_kw)
        want = fs.snowgr4j_objective_reference(
            snow, rain, temp, etp, qobs, *plain_args, stats=stats,
            masked=masked, count=int(torch.isfinite(qobs).sum()),
            ndsi=ndsi.T.contiguous() if sca else None,
            band_counts=(torch.isfinite(ndsi).sum(dim=1).to(dtype)
                         if sca else None))
        kernel = ("snow_sca_stats" if sca
                  else "snow_stats" if stats else "snow_mse")
        rtol, atol = TOL[dtype]["obj"]
    torch.cuda.synchronize()
    assert fg.LAUNCHES[kernel] == 1
    assert got.device.type == "cuda" and got.dtype == dtype
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if snow_only and mode == "traj":
        assert torch.equal(got, want)     # the snow state, bit for bit


def _read(name, **kw):
    return pd.read_csv(os.path.join(DATA_DIR, name), **kw)


@pytest.mark.parametrize("name", ['Cemaneige', 'CemaneigeGR4J',
                                  'CemaneigeHystGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_golden_snow_trajectories_fused_float64(cuda, name):
    make = lambda **kw: getattr(models, name)(device=cuda,
                                              dtype=torch.float64, **kw)
    if name == 'Cemaneige':
        df = _read('cemaneige_validation_data.csv', sep=';')
        qsim, want = make(params={'CTG': 0.25, 'Kf': 3.74}).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp,
            met_station_height=495, altitudes=ALTITUDES,
            engine='fused'), df.liquid_outflow
    elif name == 'CemaneigeGR4J':
        params = {'CTG': 0.25, 'Kf': 3.74,
                  'x1': np.exp(5.25483021675164),
                  'x2': np.sinh(1.58209470624126),
                  'x3': np.exp(4.3853181982412),
                  'x4': np.exp(0.954786342674327) + 0.5}
        df = _read('cemaneigegr4j_validation_data.csv', sep=';', index_col=0)
        qsim, want = make(params=params).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp, df.pe,
            met_station_height=495, altitudes=ALTITUDES, s_init=0.6,
            r_init=0.7, engine='fused'), df.qsim
    elif name == 'CemaneigeHystGR4J':
        df = _read('cemaneigehystgr4j_validation_data.csv', index_col=0)
        qsim, want = make(params=HYST_PARAMS).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp, df.pe,
            met_station_height=700, altitudes=ALTITUDES, s_init=0.5,
            r_init=0.4, engine='fused'), df.qsim
    else:
        df = _read('cemaneigehystgr4jice_validation_data.csv', index_col=0)
        qsim, want = make(params=dict(HYST_PARAMS, DDF=5)).simulate(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp, df.pe,
            FRAC_ICE, met_station_height=700, altitudes=ALTITUDES,
            s_init=0.5, r_init=0.4, sca_init=0.2, engine='fused'), df.qsim
    assert np.allclose(qsim.cpu().numpy().ravel(), want.to_numpy())


def test_snow_fits_launch_one_kernel_per_generation(cuda):
    rng = np.random.default_rng(4)
    T = 400
    mean_t = rng.uniform(-8, 14, T)
    forcing = (rng.uniform(0, 14, T), mean_t, mean_t - 2, mean_t + 2,
               rng.uniform(0, 3, T), FRAC_ICE)
    kw = dict(met_station_height=700, altitudes=ALTITUDES, engine='fused',
              seed=0, maxiter=3)
    qobs = rng.uniform(0.2, 5, T)
    qobs[::13] = np.nan
    ndsi = [rng.uniform(0, 100, T) for _ in range(5)]
    ndsi[2][::7] = np.nan
    model = models.CemaneigeHystGR4JIce(device=cuda)
    fg.reset_launches()
    res = model.fit(qobs, *forcing, loss_metric='kge', **kw)
    res_sca = model.fit_Q_SCA(qobs, *forcing, *ndsi, **kw)
    assert fg.LAUNCHES["snow_stats"] == res.nit + 1
    assert fg.LAUNCHES["snow_sca_stats"] == res_sca.nit + 1
    assert fg.LAUNCHES["snow_mse"] == fg.LAUNCHES["snow_traj"] == 0
    assert np.isfinite(res.fun) and np.isfinite(res_sca.fun)


def test_snow_too_many_layers_raise(cuda):
    (prec, temp, frac), etp, _, _, _, params = _snow_inputs(
        cuda, torch.float64, 60, 2.9, T=20, N=4)
    with pytest.raises(ValueError, match="at most"):
        fs.snowgr4j_simulate_fused(prec, temp, etp, frac, *SNOW_INITS,
                                   params, hyst=True)
    # 48 layers of two float64 states and the layer constant fit the
    # narrowest block.
    out = fs.snowgr4j_simulate_fused(prec[:, :48], temp[:, :48], etp,
                                     frac[:, :48], *SNOW_INITS, params)
    torch.cuda.synchronize()
    assert out.shape == (4, 20) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# Forecast mode: the state kernels K4, K14, K10 and the warm objectives
# ---------------------------------------------------------------------------

OBJECTIVE_MODES = ["mse", "stats", "mse+masked", "stats+masked"]


def _gr4j_rows(state):
    return torch.cat([state.s[None], state.r[None], state.pr_history.T])


def _gr4j_state_plain(prec, etp, params, state, uh, inits):
    packed = fg.pack_params(params, *inits, state)
    hist = None if state is None else fg.history_rows(state, uh[1], prec)
    return fg.gr4j_simulate_state_reference(prec, etp, packed, hist, *uh)


# (cold steps, warm steps, members): 300 cold steps, then 200, 4 or 1 warm
# (below H = n2 - 1 the tail of the incoming history is kept); and the
# edges of K4's staging and store tiles (64 steps; 32 in the split kernel:
# one step, 63, 64, 65, two whole tiles; warm as many again) and its
# blocks: the split kernel's of 64 members (one member, last blocks of 1
# and 8) and the tile kernel's of 128 ("split+1", "split+72": that many
# past fg.traj_split_members(), last blocks of 1 and 72, resolved on the
# card).
GR4J_STATE_SHAPES = [(300, 200, 300), (300, 4, 300), (300, 1, 300)] + [
    (t, t, n) for t in (1, 63, 64, 65, 128)
    for n in (1, 129, 200, "split+1", "split+72")]


def _k4_members(n):
    return n if isinstance(n, int) else (
        fg.traj_split_members() + int(n.split("+")[1]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("cut,warm_len,n", GR4J_STATE_SHAPES)
def test_gr4j_state_kernel_matches_plain(cuda, dtype, n1, n2, x4_max, cut,
                                         warm_len, n):
    """K4 cold over ``cut`` steps, then warm from its own state; a
    ``warm_len`` below H = n2 - 1 keeps the tail of the incoming history."""
    prec, etp, _, params = _inputs(cuda, dtype, N=_k4_members(n),
                                   x4_max=x4_max)
    uh, inits = (n1, n2), (0.4, 0.3)
    rtol, atol = TOL[dtype]["traj"]
    fg.reset_launches()
    q_a, st = fg.gr4j_simulate_state_fused(prec[:cut], etp[:cut], params,
                                           None, *inits, *uh)
    tail = slice(cut, cut + warm_len)
    q_b, st_b = fg.gr4j_simulate_state_fused(prec[tail], etp[tail], params,
                                             st, num_uh1=n1, num_uh2=n2)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_traj_state"] == 2
    want_a, rows_a = _gr4j_state_plain(prec[:cut], etp[:cut], params, None,
                                       uh, inits)
    want_b, rows_b = _gr4j_state_plain(prec[tail], etp[tail], params, st, uh,
                                       inits)
    assert st_b.pr_history.shape == (params['x1'].shape[0], n2 - 1)
    for got, want in ((q_a, want_a), (_gr4j_rows(st), rows_a),
                      (q_b, want_b), (_gr4j_rows(st_b), rows_b)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    # Split invariance against the unbroken K3 run.
    full = fg.gr4j_simulate_fused(prec[:cut + warm_len], etp[:cut + warm_len],
                                  *inits, params, *uh)
    torch.testing.assert_close(torch.cat([q_a, q_b], dim=1), full,
                               rtol=1e-9 if dtype == torch.float64 else rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("n", [1, 129, 200, "split+1", "split+72"])
def test_gr4j_traj_kernel_is_k4_cold(cuda, dtype, n1, n2, x4_max, T, n):
    """K3 (its split kernel up to fg.traj_split_members() members, its tile
    kernel beyond) gives K4's cold trajectories bit for bit, and agrees
    with its plain version, at the edges of their 64-step tiles and their
    blocks."""
    prec, etp, _, params = _inputs(cuda, dtype, T=T, N=_k4_members(n),
                                   x4_max=x4_max)
    fg.reset_launches()
    got = fg.gr4j_simulate_fused(prec, etp, 0.4, 0.3, params, n1, n2)
    k4, _ = fg.gr4j_simulate_state_fused(prec, etp, params, None, 0.4, 0.3,
                                         n1, n2)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_traj"] == 1
    assert torch.equal(got, k4)
    want = fg.gr4j_simulate_reference(prec, etp,
                                      fg.pack_params(params, 0.4, 0.3), n1,
                                      n2)
    rtol, atol = TOL[dtype]["traj"]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
def test_gr4j_state_split_kernel_is_the_tile_kernel(cuda, dtype, n1, n2,
                                                    x4_max):
    """K4's split kernel (at most fg.traj_split_members() members) and its
    tile kernel (one member more) give the same members the same bits,
    cold over 130 steps and warm over 70 (a ragged last tile in both)."""
    n = fg.traj_split_members()
    prec, etp, _, params = _inputs(cuda, dtype, T=200, N=n + 1,
                                   x4_max=x4_max)
    some = {k: v[:n] for k, v in params.items()}
    runs = []
    for members in (params, some):
        q_a, st = fg.gr4j_simulate_state_fused(prec[:130], etp[:130],
                                               members, None, 0.4, 0.3, n1,
                                               n2)
        q_b, st_b = fg.gr4j_simulate_state_fused(prec[130:], etp[130:],
                                                 members, st, num_uh1=n1,
                                                 num_uh2=n2)
        runs.append([q_a, _gr4j_rows(st).T, q_b, _gr4j_rows(st_b).T])
    torch.cuda.synchronize()
    for tile, split in zip(*runs):
        assert torch.equal(tile[:n], split)


def test_gr4j_long_history_enters_short_registers(cuda):
    """A 20-input history from a (10, 21) run is trimmed for a (3, 7)
    kernel; a 6-input history cannot enter a (10, 21) kernel."""
    prec, etp, _, params = _inputs(cuda, torch.float64, x4_max=2.9)
    _, st = fg.gr4j_simulate_state_fused(prec[:300], etp[:300], params, None,
                                         0.4, 0.3, 10, 21)
    got, got_st = fg.gr4j_simulate_state_fused(prec[300:], etp[300:], params,
                                               st, num_uh1=3, num_uh2=7)
    want, rows = _gr4j_state_plain(prec[300:], etp[300:], params, st, (3, 7),
                                   (0.0, 0.0))
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(_gr4j_rows(got_st), rows, rtol=1e-9,
                               atol=1e-12)
    with pytest.raises(ValueError, match="holds 6 routing inputs"):
        fg.gr4j_simulate_state_fused(prec[:9], etp[:9], params, got_st)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("mode", OBJECTIVE_MODES)
def test_gr4j_warm_objective_matches_plain(cuda, dtype, n1, n2, x4_max, mode):
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    prec, etp, qobs, params = _inputs(cuda, dtype, x4_max=x4_max,
                                      gaps=masked)
    _, st = fg.gr4j_simulate_state_fused(prec[:300], etp[:300], params, None,
                                         0.4, 0.3, n1, n2)
    tail = slice(300, None)
    fg.reset_launches()
    got = fg.gr4j_ensemble_mse_fused(prec[tail], etp[tail], qobs[tail], 0.0,
                                     0.0, params, n1, n2, stats=stats,
                                     masked=masked, state=st)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_stats" if stats else "gr4j_mse"] == 1
    want = fg.gr4j_objective_reference(
        prec[tail], etp[tail], qobs[tail],
        fg.pack_params(params, 0.0, 0.0, st), n1, n2, stats, masked,
        int(torch.isfinite(qobs[tail]).sum()),
        fg.history_rows(st, n2, prec))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


def _hbv_cut(forcings, lo, hi):
    temp, prec, month, pe_m, t_m = forcings
    return (temp[lo:hi].contiguous(), prec[lo:hi].contiguous(),
            month[lo:hi].contiguous(), pe_m, t_m)


def _hbv_series(forcings):
    temp, prec, month, pe_m, t_m = forcings
    return temp, prec, pe_m[month], t_m[month]


# (cold steps, warm steps, members): the long and the one-step warm
# segment, and the edges of K10's and K14's 32-step staging and store
# tiles (31, 33, 65 steps) and blocks (one member; a last block of one).
STATE_SHAPES = [(300, 200, 300), (300, 1, 300), (31, 33, 1), (33, 65, 129),
                (65, 31, 129)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cut,warm_len,n", STATE_SHAPES)
def test_hbv_state_kernel_matches_plain(cuda, dtype, cut, warm_len, n):
    """K14 cold, then warm from its own stores; NaN members (negative soil
    under pow) are NaN in trajectory and state, in the same positions."""
    forcings, _, params = _hbv_inputs(cuda, dtype, N=n)
    inits = (0.0, 100.0, 3.0, 10.0)
    rtol, atol = TOL[dtype]["traj"]
    some_nan = n >= 10          # a tenth of the members is dry
    head, tail = _hbv_cut(forcings, 0, cut), _hbv_cut(forcings, cut,
                                                      cut + warm_len)
    fg.reset_launches()
    q_a, st = fh.hbv_simulate_state_fused(*head, *inits, params)
    q_b, st_b = fh.hbv_simulate_state_fused(*tail, 0.0, 0.0, 0.0, 0.0, params,
                                            state=st)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["hbv_traj_state"] == 2
    want_a, rows_a = fh.hbv_simulate_state_reference(
        *_hbv_series(head), fh.pack_params(params, *inits))
    want_b, rows_b = fh.hbv_simulate_state_reference(
        *_hbv_series(tail), fh.pack_params(params, *st), True)
    _assert_close_nan_aware(q_a, want_a, rtol, atol, some_nan)
    _assert_close_nan_aware(torch.stack(st), rows_a, rtol, atol, some_nan)
    _assert_close_nan_aware(q_b, want_b, rtol, atol, some_nan)
    _assert_close_nan_aware(torch.stack(st_b), rows_b, rtol, atol, some_nan)
    full = fh.hbv_simulate_fused(*_hbv_cut(forcings, 0, cut + warm_len),
                                 *inits, params)
    _assert_close_nan_aware(torch.cat([q_a, q_b], dim=1), full,
                            1e-9 if dtype == torch.float64 else rtol, atol,
                            some_nan)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", OBJECTIVE_MODES)
def test_hbv_warm_objective_matches_plain(cuda, dtype, mode):
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    forcings, qobs, params = _hbv_inputs(cuda, dtype, gaps=masked)
    _, st = fh.hbv_simulate_state_fused(*_hbv_cut(forcings, 0, 300), 0.0,
                                        100.0, 3.0, 10.0, params)
    tail, qobs = _hbv_cut(forcings, 300, 500), qobs[300:].contiguous()
    fg.reset_launches()
    got = fh.hbv_ensemble_mse_fused(*tail, qobs, 0.0, 0.0, 0.0, 0.0, params,
                                    stats=stats, masked=masked, state=st)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["hbv_stats" if stats else "hbv_mse"] == 1
    want = fh.hbv_objective_reference(
        *_hbv_series(tail), qobs, fh.pack_params(params, *st), stats, masked,
        int(torch.isfinite(qobs).sum()), True)
    _assert_close_nan_aware(got, want, *TOL[dtype]["obj"])


STATE_VARIANTS = {k: v for k, v in SNOW_VARIANTS.items() if k != "snow-only"}


def _snow_plain_inputs(prec, frac, frac_ice, params, state, hyst, ice, uh,
                       like):
    """(snow, rain, packed, layer constants, frac_ice, state rows, history,
    (N, L) constants of the final bundle) for the plain versions."""
    snow, rain, consts = fs.layer_inputs(prec, frac, hyst)
    frac_ice = frac_ice if ice else torch.zeros_like(frac_ice)
    n, num_layers = params['CTG'].shape[0], prec.shape[1]
    if state is None:
        return (snow, rain, fs.pack_params(params, *SNOW_INITS[2:]), consts,
                frac_ice, None, None,
                consts.expand(n, num_layers).contiguous())
    state_in, consts, hist = fs.warm_rows(state, hyst, num_layers, uh[1],
                                          like)
    return (snow, rain, fs.pack_params(params, 0.0, 0.0, False, state.gr4j),
            consts, frac_ice, state_in, hist, consts.T.contiguous())


def _snow_state_pair(layers, etp, frac_ice, params, state, hyst, ice, uh):
    """K10 and its plain version on the same inputs: two (q, bundle)."""
    prec, temp, frac = layers
    snow0, th0, s_init, r_init = (0.0,) * 4 if state is not None \
        else SNOW_INITS
    got = fs.snowgr4j_simulate_state_fused(
        prec, temp, etp, frac, params, state, snow0, th0, s_init, r_init,
        frac_ice=frac_ice if ice else None, hyst=hyst, ice=ice,
        num_uh1=uh[0], num_uh2=uh[1])
    (snow, rain, packed, consts, ice_frac, state_in, hist,
     consts_nl) = _snow_plain_inputs(prec, frac, frac_ice, params, state,
                                     hyst, ice, uh, etp)
    want_q, rows = fs.snowgr4j_simulate_state_reference(
        snow, rain, temp, etp, packed, consts, ice_frac, snow0, th0, hyst,
        ice, *uh, state_in, hist)
    return got, (want_q, fs.bundle_from_rows(rows, consts_nl, hyst, uh[1]))


def _assert_snow_states_agree(got, want, rtol, atol):
    torch.testing.assert_close(_gr4j_rows(got.gr4j), _gr4j_rows(want.gr4j),
                               rtol=rtol, atol=atol)
    assert got.snow._fields == want.snow._fields
    for g, w in zip(got.snow, want.snow):
        assert torch.equal(g, w)          # the snow state, bit for bit


# (cold steps, warm steps, members): K10 over 200 steps, warm for 100 or 3
# (shorter than the history), and the edges of its 32-step staging and
# store tiles (31, 33, 65 steps) and blocks (one member: one warp; a last
# block of one).
SNOW_STATE_SHAPES = [(200, 100, 200), (200, 3, 200), (31, 33, 1),
                     (33, 65, 129), (65, 31, 129)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 2, 5])
@pytest.mark.parametrize("variant", list(STATE_VARIANTS))
@pytest.mark.parametrize("cut,warm_len,n", SNOW_STATE_SHAPES)
def test_snow_state_kernel_matches_plain(cuda, dtype, L, variant, cut,
                                         warm_len, n):
    """K10 cold over ``cut`` steps, then warm from its own bundle (per-member
    layer constants of the first segment, passed through unchanged); L = 1
    and 5 keep the layer states in registers, L = 2 in shared memory."""
    hyst, ice, _, uh = STATE_VARIANTS[variant]
    layers, etp, _, _, frac_ice, params = _snow_inputs(
        cuda, dtype, L, 2.9 if uh == (3, 7) else 9.9,
        T=max(300, cut + warm_len), N=n)
    rtol, atol = TOL[dtype]["traj"]
    head = [x[:cut].contiguous() for x in layers]
    tail = [x[cut:cut + warm_len].contiguous() for x in layers]
    fg.reset_launches()
    (q_a, st), (want_a, want_st) = _snow_state_pair(
        head, etp[:cut].contiguous(), frac_ice, params, None, hyst, ice, uh)
    (q_b, st_b), (want_b, want_st_b) = _snow_state_pair(
        tail, etp[cut:cut + warm_len].contiguous(), frac_ice, params, st,
        hyst, ice, uh)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["snow_traj_state"] == 2
    for got, want in ((q_a, want_a), (q_b, want_b)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    _assert_snow_states_agree(st, want_st, rtol, atol)
    _assert_snow_states_agree(st_b, want_st_b, rtol, atol)
    assert torch.equal(st_b.snow[-1], st.snow[-1])   # constants pass through
    # Split invariance needs the first segment's constants, so the unbroken
    # run is the plain version entering cold with them.
    if dtype == torch.float64:
        prec, temp, frac = (x[:cut + warm_len].contiguous() for x in layers)
        snow, rain, _ = fs.layer_inputs(prec, frac, hyst)
        consts = fs.layer_inputs(head[0], head[2], hyst)[2]
        full = fs.snowgr4j_simulate_reference(
            snow, rain, temp, etp[:cut + warm_len].contiguous(),
            fs.pack_params(params, *SNOW_INITS[2:]), consts,
            frac_ice if ice else torch.zeros_like(frac_ice), *SNOW_INITS[:2],
            hyst, ice, False, *uh)
        torch.testing.assert_close(torch.cat([q_a, q_b], dim=1), full,
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("variant", list(STATE_VARIANTS))
@pytest.mark.parametrize("mode", ["mse", "stats+masked"])
def test_snow_warm_objective_matches_plain(cuda, dtype, L, variant, mode):
    hyst, ice, _, uh = STATE_VARIANTS[variant]
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    layers, etp, qobs, _, frac_ice, params = _snow_inputs(
        cuda, dtype, L, 2.9 if uh == (3, 7) else 9.9, gaps=masked)
    cut = 200
    head = [x[:cut].contiguous() for x in layers]
    prec, temp, frac = (x[cut:].contiguous() for x in layers)
    etp_b, qobs_b = etp[cut:].contiguous(), qobs[cut:].contiguous()
    (_, st), _ = _snow_state_pair(head, etp[:cut].contiguous(), frac_ice,
                                  params, None, hyst, ice, uh)
    fg.reset_launches()
    got = fs.snowgr4j_ensemble_mse_fused(
        prec, temp, etp_b, frac, qobs_b, 0.0, 0.0, 0.0, 0.0, params,
        frac_ice=frac_ice if ice else None, hyst=hyst, ice=ice, stats=stats,
        num_uh1=uh[0], num_uh2=uh[1], state=st, masked=masked)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["snow_stats" if stats else "snow_mse"] == 1
    (snow, rain, packed, consts, ice_frac, state_in, hist,
     _) = _snow_plain_inputs(prec, frac, frac_ice, params, st, hyst, ice, uh,
                             etp_b)
    want = fs.snowgr4j_objective_reference(
        snow, rain, temp, etp_b, qobs_b, packed, consts, ice_frac, 0.0, 0.0,
        hyst, ice, False, *uh, stats=stats, masked=masked,
        count=int(torch.isfinite(qobs_b).sum()), state_in=state_in,
        hist=hist)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


def test_forecast_cycle_on_the_card(cuda, tmp_path):
    """Spin-up, state through a file, ensemble continuation and warm
    recalibration of GR4J through the class, counted by launches."""
    from rrmpg_tpu_torch.tools import load_state, save_state

    rng = np.random.default_rng(5)
    prec, etp = rng.uniform(0, 15, 600), rng.uniform(0, 4, 600)
    truth = {'x1': 500.0, 'x2': 0.5, 'x3': 80.0, 'x4': 2.0}
    model = GR4J(params=truth, device=cuda, dtype=torch.float64)
    full = model.simulate(prec, etp, s_init=0.5, r_init=0.4, engine='fused')
    fg.reset_launches()
    q_a, st = model.simulate(prec[:400], etp[:400], s_init=0.5, r_init=0.4,
                             return_final_state=True, engine='fused')
    save_state(str(tmp_path / "state.npz"), st)
    st = load_state(str(tmp_path / "state.npz"))
    np.random.seed(0)
    q_b, st_b = model.simulate(prec[400:], etp[400:],
                               params=GR4J().get_random_params(50),
                               initial_state=st, return_final_state=True,
                               engine='fused')
    q_one = model.simulate(prec[400:], etp[400:], initial_state=st,
                           engine='fused')
    assert fg.LAUNCHES["gr4j_traj_state"] == 3
    assert q_b.shape == (200, 50) and st_b.s.shape == (50,)
    torch.testing.assert_close(torch.cat([q_a, q_one]), full, rtol=1e-9,
                               atol=1e-12)
    res = model.fit(q_one.cpu().numpy().ravel(), prec[400:], etp[400:],
                    initial_state=st, engine='fused', seed=0, maxiter=4)
    assert fg.LAUNCHES["gr4j_mse"] == res.nit + 1
    assert np.isfinite(res.fun)


# ---------------------------------------------------------------------------
# Regional: K5 (GR4J) and K11 (snow + GR4J), C catchments in one launch
# ---------------------------------------------------------------------------

def _regional_qobs(rng, C, T, gaps):
    qobs = rng.uniform(0, 5, (C, T))
    if gaps:
        qobs[0, T // 2:] = np.nan           # a record that ends early
        qobs[C - 1, ::11] = np.nan          # scattered gaps
    return qobs


def _regional_counts(qobs, masked):
    if not masked:
        return torch.full((qobs.shape[0],), float(qobs.shape[1]),
                          dtype=qobs.dtype, device=qobs.device)
    return torch.isfinite(qobs).sum(dim=1).to(qobs.dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("mode", ["mse", "stats", "mse+masked",
                                  "stats+masked"])
def test_regional_gr4j_kernel_matches_plain(cuda, dtype, C, n1, n2, x4_max,
                                            mode):
    masked, stats = mode.endswith("masked"), mode.startswith("stats")
    rng = np.random.default_rng(C)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    prec, etp = as_t(rng.uniform(0, 15, (C, 400))), as_t(
        rng.uniform(0, 4, (C, 400)))
    qobs = as_t(_regional_qobs(rng, C, 400, masked))
    _, _, _, params = _inputs(cuda, dtype, x4_max=x4_max)
    fg.reset_launches()
    got = fg.gr4j_regional_objective_fused(prec, etp, qobs, 0.4, 0.3, params,
                                           n1, n2, stats=stats, masked=masked)
    want = fg.gr4j_regional_objective_reference(
        prec, etp, qobs, fg.pack_params(params, 0.4, 0.3), n1, n2, stats,
        masked, _regional_counts(qobs, masked))
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_regional"] == 1
    assert got.shape == ((4, C, 300) if stats else (C, 300))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_regional_one_catchment_is_k1(cuda, dtype):
    """K5 with C = 1 runs K1/K2's staged one-arm body over the same series
    (K1/K2 take it one member a thread, or for small ensembles with
    production and routing in separate warps, which is the same operations
    on the same values): the same numbers as the single-catchment launch,
    bit for bit."""
    prec, etp, qobs, params = _inputs(cuda, dtype, gaps=True)
    for stats in (False, True):
        single = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.4, 0.3,
                                            params, stats=stats, masked=True)
        regional = fg.gr4j_regional_objective_fused(
            prec[None], etp[None], qobs[None], 0.4, 0.3, params,
            stats=stats, masked=True)
        assert torch.equal(regional[:, 0] if stats else regional[0], single)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("variant", ["plain", "hyst", "ice", "hyst+ice"])
@pytest.mark.parametrize("mode", ["mse", "stats+masked"])
def test_regional_snow_kernel_matches_plain(cuda, dtype, C, L, variant,
                                            mode):
    hyst, ice = {"plain": (False, False), "hyst": (True, False),
                 "ice": (False, True), "hyst+ice": (True, True)}[variant]
    masked, stats = mode.endswith("masked"), mode.startswith("stats")
    rng = np.random.default_rng(10 * C + L)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    T = 300
    prec = as_t(rng.uniform(0, 15, (C, T, L)))
    temp = as_t(rng.uniform(-12, 18, (C, T, L)))
    frac = as_t(np.clip(rng.uniform(-0.3, 1.2, (C, T, L)), 0, 1))
    etp = as_t(rng.uniform(0, 4, (C, T)))
    qobs = as_t(_regional_qobs(rng, C, T, masked))
    frac_ice = as_t(rng.uniform(0, 0.7, (C, L)))
    *_, params = _snow_inputs(cuda, dtype, L, 9.9)
    snow0, th0, s_init, r_init = SNOW_INITS
    fg.reset_launches()
    got = fs.snowgr4j_regional_mse_fused(
        prec, temp, etp, frac, qobs, snow0, th0, s_init, r_init, params,
        frac_ice=frac_ice if ice else None, hyst=hyst, ice=ice, stats=stats,
        masked=masked)
    snow, rain, consts = fs.layer_inputs(prec, frac, hyst)
    want = fs.snowgr4j_regional_objective_reference(
        snow, rain, temp, etp, qobs, fs.pack_params(params, s_init, r_init),
        consts, frac_ice if ice else torch.zeros_like(frac_ice), snow0, th0,
        hyst, ice, stats=stats, masked=masked,
        counts=_regional_counts(qobs, masked))
    torch.cuda.synchronize()
    assert fg.LAUNCHES["snow_regional"] == 1
    assert got.shape == ((4, C, 200) if stats else (C, 200))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


def test_regional_objectives_through_entry_points(cuda):
    """The public regional objectives on the card against the same calls
    on CPU tensors (the plain versions), float64, ragged records, every
    loss metric; one launch per call."""
    from rrmpg_tpu_torch import interop
    from rrmpg_tpu_torch.parallel import (regional_gr4j_objective,
                                          regional_snow_objective)

    rng = np.random.default_rng(4)
    C, T, L, N = 3, 365, 5, 256
    qobs = _regional_qobs(rng, C, T, True)
    gr4j_np = (rng.uniform(0, 15, (C, T)), rng.uniform(0, 4, (C, T)), qobs)
    layers_np = (rng.uniform(0, 15, (C, T, L)), rng.uniform(-12, 18, (C, T, L)),
                 rng.uniform(0, 1, (C, T, L)))
    frac_ice_np = rng.uniform(0, 0.7, L)
    gr4j_params = {'x1': rng.uniform(100, 1200, N),
                   'x2': rng.uniform(-5, 3, N), 'x3': rng.uniform(20, 300, N),
                   'x4': rng.uniform(1.1, 2.9, N)}
    snow_params = dict(gr4j_params, CTG=rng.uniform(0, 1, N),
                       Kf=rng.uniform(0, 10, N), Thacc=rng.uniform(1, 100, N),
                       Rsp=rng.uniform(0, 1, N), DDF=rng.uniform(0, 30, N))
    results = {}
    for device in (cuda, "cpu"):
        kw = dict(device=device, dtype=torch.float64)
        prec, etp, qo = interop.regional_forcing_from_numpy(*gr4j_np, **kw)
        etp_s, qo_s, lp, lt, lf, fi = interop.regional_forcing_from_numpy(
            gr4j_np[1], qobs, layers=layers_np, frac_ice=frac_ice_np, **kw)
        gp = interop.params_from_numpy(gr4j_params, **kw)
        sp = interop.params_from_numpy(snow_params, **kw)
        for metric in ("mse", "rmse", "nse", "kge"):
            fg.reset_launches()
            results[(device, "gr4j", metric)] = regional_gr4j_objective(
                prec, etp, qo, 0.3, 0.3, gp, loss_metric=metric).cpu()
            results[(device, "snow", metric)] = regional_snow_objective(
                lp, lt, etp_s, lf, qo_s, 0.0, 0.0, 0.5, 0.4, sp,
                frac_ice=fi, hyst=True, ice=True, loss_metric=metric).cpu()
            if device is cuda:
                assert fg.LAUNCHES["gr4j_regional"] == 1
                assert fg.LAUNCHES["snow_regional"] == 1
    for (device, family, metric), got in results.items():
        if device == "cpu":
            continue
        want = results[("cpu", family, metric)]
        assert got.shape == (C, N) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# K8 and K12 redesigned: forcing staged in 64-step tiles, K8's layers in
# registers for 1 and 5 layers.  The edges of a tile and of a block.
# ---------------------------------------------------------------------------

TILE = 64                     # steps per staged tile (snow_objective.cu)
EDGE_STEPS = [37, 64, 150]    # shorter than a tile, one tile, a ragged last
EDGE_MEMBERS = 200            # one full block of 128 and a ragged one of 72


def _tile_edge_gaps(qobs, ndsi):
    """NaN observations on both sides of every tile edge (steps 63/64 and
    127/128): discharge, the first NDSI band, and a run across the first
    edge in the last band."""
    T = qobs.shape[0]
    edges = [t for t in (TILE - 1, TILE, 2 * TILE - 1, 2 * TILE) if t < T]
    qobs, ndsi = qobs.clone(), ndsi.clone()
    qobs[edges] = torch.nan
    ndsi[0, edges] = torch.nan
    ndsi[-1, TILE - 4:min(TILE + 6, T)] = torch.nan
    return qobs, ndsi


# (variant, mode): the widest SCA mode, a discharge mode, the snow-only one.
EDGE_SNOW_CASES = [("hyst+ice", "sca_stats"), ("plain", "stats"),
                   ("hyst", "mse"), ("snow-only", "stats")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 2, 5, 7])
@pytest.mark.parametrize("T", EDGE_STEPS)
@pytest.mark.parametrize("variant,mode", EDGE_SNOW_CASES)
def test_snow_objective_tile_and_block_edges(cuda, dtype, L, T, variant,
                                             mode):
    """K8 at 1 and 5 layers (registers) and 2 and 7 (shared-memory
    columns), T shorter than a tile, one tile and a ragged last tile, N not
    a multiple of the block, gaps in discharge and NDSI at the tile edges;
    against the plain version."""
    hyst, ice, snow_only, uh = SNOW_VARIANTS[variant]
    sca, stats = mode == "sca_stats", mode == "stats"
    (prec, temp, frac), etp, qobs, ndsi, frac_ice, params = _snow_inputs(
        cuda, dtype, L, 2.9 if uh == (3, 7) else 9.9, T=T, N=EDGE_MEMBERS,
        seed=T + L)
    qobs, ndsi = _tile_edge_gaps(qobs, ndsi)
    snow0, th0, s_init, r_init = SNOW_INITS
    packed = fs.pack_params(params, s_init, r_init, snow_only)
    snow, rain, consts = fs.layer_inputs(prec, frac, hyst)
    fg.reset_launches()
    got = fs.snowgr4j_ensemble_mse_fused(
        prec, temp, etp, frac, qobs, *SNOW_INITS, params,
        frac_ice=frac_ice if ice else None, ndsi=ndsi if sca else None,
        hyst=hyst, ice=ice, snow_only=snow_only, stats=stats, sca_stats=sca,
        num_uh1=uh[0], num_uh2=uh[1], masked=True)
    want = fs.snowgr4j_objective_reference(
        snow, rain, temp, etp, qobs, packed, consts,
        frac_ice if ice else torch.zeros_like(frac_ice), snow0, th0, hyst,
        ice, snow_only, *uh, stats=stats, masked=True,
        count=int(torch.isfinite(qobs).sum()),
        ndsi=ndsi.T.contiguous() if sca else None,
        band_counts=(torch.isfinite(ndsi).sum(dim=1).to(dtype)
                     if sca else None))
    torch.cuda.synchronize()
    kernel = "snow_sca_stats" if sca else "snow_stats" if stats else "snow_mse"
    assert fg.LAUNCHES[kernel] == 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 2, 5])
@pytest.mark.parametrize("stats", [False, True])
def test_snow_warm_objective_across_a_tile_edge(cuda, dtype, L, stats):
    """K8's warm entry (first_step = -1) over a 100-step continuation that
    crosses the first tile edge, from the state K10 ends a 70-step cold run
    in; gaps at the edge."""
    hyst, ice, _, uh = STATE_VARIANTS["hyst+ice"]
    layers, etp, qobs, ndsi, frac_ice, params = _snow_inputs(
        cuda, dtype, L, 2.9, T=170, N=EDGE_MEMBERS, seed=L)
    cut = 70
    head = [x[:cut].contiguous() for x in layers]
    tail = [x[cut:].contiguous() for x in layers]
    etp_b = etp[cut:].contiguous()
    qobs_b, _ = _tile_edge_gaps(qobs[cut:].contiguous(), ndsi[:, cut:])
    (_, st), _ = _snow_state_pair(head, etp[:cut].contiguous(), frac_ice,
                                  params, None, hyst, ice, uh)
    fg.reset_launches()
    got = fs.snowgr4j_ensemble_mse_fused(
        *tail[:2], etp_b, tail[2], qobs_b, 0.0, 0.0, 0.0, 0.0, params,
        frac_ice=frac_ice, hyst=hyst, ice=ice, stats=stats, num_uh1=uh[0],
        num_uh2=uh[1], state=st, masked=True)
    (snow, rain, packed, consts, ice_frac, state_in, hist,
     _) = _snow_plain_inputs(tail[0], tail[2], frac_ice, params, st, hyst,
                             ice, uh, etp_b)
    want = fs.snowgr4j_objective_reference(
        snow, rain, tail[1], etp_b, qobs_b, packed, consts, ice_frac, 0.0,
        0.0, hyst, ice, False, *uh, stats=stats, masked=True,
        count=int(torch.isfinite(qobs_b).sum()), state_in=state_in,
        hist=hist)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["snow_stats" if stats else "snow_mse"] == 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


@pytest.mark.parametrize("name", ['Cemaneige', 'CemaneigeGR4J',
                                  'CemaneigeHystGR4J',
                                  'CemaneigeHystGR4JIce'])
def test_golden_snow_through_the_objective_float64(cuda, name):
    """The four Excel sheets (5 layers, so K8's register path) through K8
    in float64: the statistics of the kernel's discharge against the Excel
    column give a mean squared error within np.allclose's reach and the
    Excel column's mean."""
    make = lambda **kw: getattr(models, name)(device=cuda,
                                              dtype=torch.float64, **kw)
    fg.reset_launches()
    if name == 'Cemaneige':
        df = _read('cemaneige_validation_data.csv', sep=';')
        want = df.liquid_outflow.to_numpy()
        model = make(params={'CTG': 0.25, 'Kf': 3.74})
        prec, temp, frac, snow0, th0 = model._prepare(
            df.precipitation, df.mean_temp, df.min_temp, df.max_temp, 495,
            ALTITUDES, 0, 0)
        stats = fs.cemaneige_ensemble_mse_fused(
            prec, temp, frac, torch.tensor(want, device=cuda), snow0, th0,
            model._prepare_params(None)[0], stats=True)
    else:
        kw = dict(met_station_height=495, altitudes=ALTITUDES, s_init=0.6,
                  r_init=0.7)
        if name == 'CemaneigeGR4J':
            params = {'CTG': 0.25, 'Kf': 3.74,
                      'x1': np.exp(5.25483021675164),
                      'x2': np.sinh(1.58209470624126),
                      'x3': np.exp(4.3853181982412),
                      'x4': np.exp(0.954786342674327) + 0.5}
            df = _read('cemaneigegr4j_validation_data.csv', sep=';',
                       index_col=0)
        else:
            params = HYST_PARAMS
            kw.update(met_station_height=700, s_init=0.5, r_init=0.4)
            df = _read(f'{name.lower()}_validation_data.csv', index_col=0)
        if name == 'CemaneigeHystGR4JIce':
            params = dict(HYST_PARAMS, DDF=5)
            kw.update(frac_ice=FRAC_ICE, sca_init=0.2)
        want = df.qsim.to_numpy()
        model = make(params=params)
        f = model._prepare(df.precipitation, df.mean_temp, df.min_temp,
                           df.max_temp, df.pe, kw.get('frac_ice'),
                           kw['met_station_height'], ALTITUDES, 0, 0,
                           kw.get('sca_init', 0), kw['s_init'], kw['r_init'])
        # UH (10, 21): the Excel x4 of CemaneigeGR4J (3.1) lies above the
        # class bound whose registers the calibration path uses.
        stats = fs.snowgr4j_ensemble_mse_fused(
            f.prec, f.mean_temp, f.etp, f.frac_solid_prec,
            torch.tensor(want, device=cuda), f.snow_pack_init,
            f.thermal_state_init, f.s_init, f.r_init,
            model._prepare_params(None)[0], frac_ice=f.frac_ice,
            hyst=model._hyst, ice=model._ice, stats=True)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["snow_stats"] == 1
    stats = stats.cpu().numpy().reshape(4, -1)[:, 0]
    # np.allclose of every step: |q - want| <= 1e-8 + 1e-5 |want|.
    assert stats[0] <= np.mean((1e-8 + 1e-5 * np.abs(want)) ** 2)
    assert np.isclose(stats[1], want.mean(), rtol=1e-5, atol=1e-8)


EDGE_HBV_MODES = ["mse", "stats+masked"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", EDGE_STEPS + [3652])
@pytest.mark.parametrize("mode", EDGE_HBV_MODES)
def test_hbv_objective_tile_and_block_edges(cuda, dtype, T, mode):
    """K12 at T shorter than a tile, one tile, ragged last tiles, N not a
    multiple of the block, gaps at the tile edges; NaN members (negative
    soil under the Beta power) the same set as the plain version's."""
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    forcings, qobs, params = _hbv_inputs(cuda, dtype, T=T, N=EDGE_MEMBERS,
                                         seed=T)
    if masked:
        qobs, _ = _tile_edge_gaps(qobs, qobs[None])
    inits = (0.0, 100.0, 3.0, 10.0)
    fg.reset_launches()
    got = fh.hbv_ensemble_mse_fused(*forcings, qobs, *inits, params,
                                    stats=stats, masked=masked)
    want = fh.hbv_objective_reference(
        *_hbv_series(forcings), qobs, fh.pack_params(params, *inits), stats,
        masked, int(torch.isfinite(qobs).sum()) if masked else T)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["hbv_stats" if stats else "hbv_mse"] == 1
    _assert_close_nan_aware(got, want, *TOL[dtype]["obj"])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", EDGE_HBV_MODES)
def test_hbv_warm_objective_across_a_tile_edge(cuda, dtype, mode):
    """K12's warm entry over a 100-step continuation that crosses the first
    tile edge, from the stores K14 ends a 70-step cold run in."""
    stats, masked = mode.startswith("stats"), mode.endswith("masked")
    forcings, qobs, params = _hbv_inputs(cuda, dtype, T=170, N=EDGE_MEMBERS)
    cut = 70
    head, tail = _hbv_cut(forcings, 0, cut), _hbv_cut(forcings, cut, 170)
    qobs_b = qobs[cut:].contiguous()
    if masked:
        qobs_b, _ = _tile_edge_gaps(qobs_b, qobs_b[None])
    _, state = fh.hbv_simulate_state_fused(*head, 0.0, 100.0, 3.0, 10.0,
                                           params)
    fg.reset_launches()
    got = fh.hbv_ensemble_mse_fused(*tail, qobs_b, 0.0, 0.0, 0.0, 0.0,
                                    params, stats=stats, masked=masked,
                                    state=state)
    want = fh.hbv_objective_reference(
        *_hbv_series(tail), qobs_b, fh.pack_params(params, *state), stats,
        masked, int(torch.isfinite(qobs_b).sum()) if masked else 100, True)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["hbv_stats" if stats else "hbv_mse"] == 1
    _assert_close_nan_aware(got, want, *TOL[dtype]["obj"])


# ---------------------------------------------------------------------------
# K1/K2 and K11 redesigned: forcing staged in tiles; K1/K2 with one
# production arm a step, and for small ensembles production and routing in
# separate warps; K11 as the regional variant of K8's kernel.
# ---------------------------------------------------------------------------

EDGE_GR4J_STEPS = [1, 37, 65, 128]   # one step, < a tile, a 1-step tile, two
# K1/K2's two kernels: production and routing in separate warps (200
# members), and one member a thread (one member more than the split kernel
# takes, fg.split_members() + 1, resolved on the card).  NaN forcing or an
# inf or NaN store makes every member NaN; p == e leaves every one finite.
GR4J_KERNEL_SIZES = ["split", "one a thread"]


def _gr4j_members(kernel):
    return EDGE_MEMBERS if kernel == "split" else fg.split_members() + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("T", EDGE_GR4J_STEPS)
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kernel", GR4J_KERNEL_SIZES)
def test_gr4j_objective_tile_and_block_edges(cuda, dtype, n1, n2, x4_max, T,
                                             stats, kernel):
    """K1/K2 (both kernels) at T of one step, shorter than a tile, with a
    last tile of one step and whole tiles, N not a multiple of the block,
    gaps at the tile edges; against the plain version."""
    prec, etp, qobs, params = _inputs(cuda, dtype, T=T,
                                      N=_gr4j_members(kernel),
                                      x4_max=x4_max, seed=T)
    qobs, _ = _tile_edge_gaps(qobs, qobs[None])
    fg.reset_launches()
    got = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.4, 0.3, params, n1,
                                     n2, stats=stats, masked=True)
    want = fg.gr4j_objective_reference(
        prec, etp, qobs, fg.pack_params(params, 0.4, 0.3), n1, n2, stats,
        True, int(torch.isfinite(qobs).sum()))
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_stats" if stats else "gr4j_mse"] == 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kernel", GR4J_KERNEL_SIZES)
def test_gr4j_warm_objective_across_a_tile_edge(cuda, dtype, n1, n2, x4_max,
                                                stats, kernel):
    """K1/K2's warm entry (both kernels) over a 100-step continuation that
    crosses tile edges, from the state K4 ends a 30-step cold run in; gaps
    at the edges."""
    prec, etp, qobs, params = _inputs(cuda, dtype, T=130,
                                      N=_gr4j_members(kernel), x4_max=x4_max)
    cut = 30
    _, state = fg.gr4j_simulate_state_fused(
        prec[:cut].contiguous(), etp[:cut].contiguous(), params, None, 0.4,
        0.3, n1, n2)
    tail = [x[cut:].contiguous() for x in (prec, etp)]
    qobs_b, _ = _tile_edge_gaps(qobs[cut:].contiguous(), qobs[None, cut:])
    fg.reset_launches()
    got = fg.gr4j_ensemble_mse_fused(*tail, qobs_b, 0.0, 0.0, params, n1, n2,
                                     stats=stats, masked=True, state=state)
    want = fg.gr4j_objective_reference(
        *tail, qobs_b, fg.pack_params(params, 0.0, 0.0, state), n1, n2,
        stats, True, int(torch.isfinite(qobs_b).sum()),
        fg.history_rows(state, n2, prec))
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_stats" if stats else "gr4j_mse"] == 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


# (label, s_init, steps with NaN prec, steps with NaN etp); every seventh
# step has p == e.
GR4J_EDGE_INPUTS = [("p == e", 0.4, [], []),
                    ("NaN forcing", 0.4, [100], [200]),
                    ("inf store", float("inf"), [], []),
                    ("NaN store", float("nan"), [], [])]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", GR4J_EDGE_INPUTS, ids=lambda c: c[0])
@pytest.mark.parametrize("kernel", GR4J_KERNEL_SIZES)
def test_gr4j_objective_one_arm_edges_match_two_arm_plain(cuda, dtype, case,
                                                          kernel):
    """Where the two-arm step's inactive arm is not a plain zero (p == e,
    NaN forcing, an inf or NaN store), K1/K2's one-arm step gives the same
    numbers as the plain version, which computes both arms: NaN exactly
    where it has NaN, and close elsewhere."""
    _, s_init, nan_p, nan_e = case
    prec, etp, qobs, params = _inputs(cuda, dtype, T=300,
                                      N=_gr4j_members(kernel), x4_max=2.9,
                                      seed=7)
    etp[::7] = prec[::7]
    prec[nan_p] = torch.nan
    etp[nan_e] = torch.nan
    got = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, s_init, 0.3, params,
                                     3, 7, stats=True)
    want = fg.gr4j_objective_reference(
        prec, etp, qobs, fg.pack_params(params, s_init, 0.3), 3, 7, True)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.all()) == (case[0] != "p == e")
    torch.testing.assert_close(got[~nan], want[~nan],
                               rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 2, 5, 7])
@pytest.mark.parametrize("T", [37, 128])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("variant", ["plain", "hyst", "ice", "hyst+ice"])
def test_regional_snow_objective_tile_and_block_edges(cuda, dtype, L, T, C,
                                                      variant):
    """K11 at 1 and 5 layers (registers) and 2 and 7 (shared-memory
    columns), T shorter than a tile and two whole tiles, N not a multiple
    of the block, catchment 0's record cut short and gaps at the tile edges
    in every catchment; MSE and statistics against the plain version."""
    hyst, ice = {"plain": (False, False), "hyst": (True, False),
                 "ice": (False, True), "hyst+ice": (True, True)}[variant]
    rng = np.random.default_rng(T + L)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    prec = as_t(rng.uniform(0, 15, (C, T, L)))
    temp = as_t(rng.uniform(-12, 18, (C, T, L)))
    frac = as_t(np.clip(rng.uniform(-0.3, 1.2, (C, T, L)), 0, 1))
    etp = as_t(rng.uniform(0, 4, (C, T)))
    qobs = _regional_qobs(rng, C, T, True)
    qobs[:, [t for t in (TILE - 1, TILE, 2 * TILE - 1) if t < T]] = np.nan
    qobs = as_t(qobs)
    frac_ice = as_t(rng.uniform(0, 0.7, (C, L)))
    *_, params = _snow_inputs(cuda, dtype, L, 2.9, N=EDGE_MEMBERS)
    snow0, th0, s_init, r_init = SNOW_INITS
    snow, rain, consts = fs.layer_inputs(prec, frac, hyst)
    want = fs.snowgr4j_regional_objective_reference(
        snow, rain, temp, etp, qobs, fs.pack_params(params, s_init, r_init),
        consts, frac_ice if ice else torch.zeros_like(frac_ice), snow0, th0,
        hyst, ice, 3, 7, stats=True, masked=True,
        counts=_regional_counts(qobs, True))
    for stats in (False, True):
        fg.reset_launches()
        got = fs.snowgr4j_regional_mse_fused(
            prec, temp, etp, frac, qobs, snow0, th0, s_init, r_init, params,
            frac_ice=frac_ice if ice else None, hyst=hyst, ice=ice,
            stats=stats, num_uh1=3, num_uh2=7, masked=True)
        torch.cuda.synchronize()
        assert fg.LAUNCHES["snow_regional"] == 1
        assert got.shape == ((4, C, EDGE_MEMBERS) if stats
                             else (C, EDGE_MEMBERS))
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want if stats else want[0],
                                   rtol=TOL[dtype]["obj"][0],
                                   atol=TOL[dtype]["obj"][1])


# ---------------------------------------------------------------------------
# K9 and K5 redesigned: K9 stages its forcing and its stores in 32-step
# tiles, its layers in registers for 1 and 5 layers; K5 runs K1/K2's staged
# body.  The edges of a tile, of a block and of the layer count.
# ---------------------------------------------------------------------------

# One step, around and at K9's 32-step tiles (snow_objective.cu).
EDGE_TRAJ_STEPS = [1, 37, 64, 65, 128]
EDGE_TRAJ_MEMBERS = [200, 129]           # last blocks of 72 and of 1 member


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [1, 2, 5, 7])
@pytest.mark.parametrize("T", EDGE_TRAJ_STEPS)
@pytest.mark.parametrize("N", EDGE_TRAJ_MEMBERS)
@pytest.mark.parametrize("variant", list(SNOW_VARIANTS))
def test_snow_traj_tile_and_block_edges(cuda, dtype, L, T, N, variant):
    """K9 at 1 and 5 layers (registers) and 2 and 7 (shared-memory
    columns), T of one step, around and at the 32-step tiles, N with a
    ragged last block, every variant (both UH register pairs) and the
    snow-only routine, whose outflow is the plain version's bit for bit."""
    hyst, ice, snow_only, uh = SNOW_VARIANTS[variant]
    (prec, temp, frac), etp, _, _, frac_ice, params = _snow_inputs(
        cuda, dtype, L, 2.9 if uh == (3, 7) else 9.9, T=T, N=N, seed=T + L)
    snow0, th0, s_init, r_init = SNOW_INITS
    snow, rain, consts = fs.layer_inputs(prec, frac, hyst)
    fg.reset_launches()
    got = fs.snowgr4j_simulate_fused(
        prec, temp, etp, frac, *SNOW_INITS, params,
        frac_ice=frac_ice if ice else None, hyst=hyst, ice=ice,
        snow_only=snow_only, num_uh1=uh[0], num_uh2=uh[1])
    want = fs.snowgr4j_simulate_reference(
        snow, rain, temp, etp, fs.pack_params(params, s_init, r_init,
                                              snow_only), consts,
        frac_ice if ice else torch.zeros_like(frac_ice), snow0, th0, hyst,
        ice, snow_only, *uh)
    torch.cuda.synchronize()
    assert fg.LAUNCHES["snow_traj"] == 1
    assert got.shape == (N, T) and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["traj"][0],
                               atol=TOL[dtype]["traj"][1])
    if snow_only:
        assert torch.equal(got, want)     # the snow state, bit for bit


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n1,n2,x4_max", [(3, 7, 2.9), (10, 21, 9.9)])
@pytest.mark.parametrize("T", EDGE_GR4J_STEPS)
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("stats", [False, True])
def test_regional_gr4j_tile_and_block_edges(cuda, dtype, n1, n2, x4_max, T,
                                            C, stats):
    """K5 at T of one step, shorter than a 64-step tile, with a last tile
    of one step and whole tiles, N not a multiple of the block, catchment
    0's record cut short (C = 3) and gaps at the tile edges in every
    catchment; against the plain version."""
    rng = np.random.default_rng(T + C)
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    prec, etp = as_t(rng.uniform(0, 15, (C, T))), as_t(
        rng.uniform(0, 4, (C, T)))
    qobs = rng.uniform(0, 5, (C, T))
    qobs[:, [t for t in (TILE - 1, TILE, 2 * TILE - 1) if t < T]] = np.nan
    if C > 1:
        qobs[0, max(1, 2 * T // 3):] = np.nan
    qobs = as_t(qobs)
    _, _, _, params = _inputs(cuda, dtype, N=EDGE_MEMBERS, x4_max=x4_max,
                              seed=T)
    fg.reset_launches()
    got = fg.gr4j_regional_objective_fused(prec, etp, qobs, 0.4, 0.3, params,
                                           n1, n2, stats=stats, masked=True)
    want = fg.gr4j_regional_objective_reference(
        prec, etp, qobs, fg.pack_params(params, 0.4, 0.3), n1, n2, stats,
        True, _regional_counts(qobs, True))
    torch.cuda.synchronize()
    assert fg.LAUNCHES["gr4j_regional"] == 1
    assert got.shape == ((4, C, EDGE_MEMBERS) if stats
                         else (C, EDGE_MEMBERS))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype]["obj"][0],
                               atol=TOL[dtype]["obj"][1])


# ---------------------------------------------------------------------------
# Ensemble data assimilation on the card: the scan backend (a loop over
# windows that reads nothing back) against the host backend, both through
# the warm entry of K4 / K14 / K10, at members around a block edge
# ---------------------------------------------------------------------------

ASSIM_MEMBERS = (129, 200)
ASSIM_WINDOW, ASSIM_CYCLES = 9, 7
ASSIM_MODELS = ("GR4J", "HBVEdu", "CemaneigeHystGR4JIce")
ASSIM_METHODS = {
    "enkf": dict(obs_std=0.05, estimate_params=True, inflation=1.02),
    "pf": dict(obs_std=0.1, method="pf", ess_threshold=0.8, jitter=0.1),
}


def _assim_setup(name, n, device, dtype, seed=0):
    """Model, forcing, simulate keywords, observations, parameters and a
    spread state of ``n`` members, spun up over 30 days on the card."""
    from rrmpg_tpu_torch.tools import perturb_state

    rng = np.random.default_rng(seed)
    T = 30 + ASSIM_WINDOW * ASSIM_CYCLES
    model = getattr(models, name)(device=device, dtype=dtype)
    np.random.seed(seed)
    params = model.get_random_params(n)
    if name == "GR4J":
        forcings = {'prec': rng.gamma(0.8, 6.0, T),
                    'etp': rng.uniform(1.0, 4.0, T)}
        kw = {}
    elif name == "HBVEdu":
        for k, v in {'FC': 177.1, 'PWP': 105.89, 'Beta': 2.35}.items():
            params[k] = v * rng.uniform(0.95, 1.05, n)
        forcings = {'temp': rng.uniform(-5.0, 15.0, T),
                    'prec': rng.gamma(0.8, 6.0, T),
                    'month': (np.arange(T) // 8) % 12 + 1}
        kw = {'PE_m': rng.uniform(0.5, 4.0, 12),
              'T_m': rng.uniform(-2.0, 15.0, 12)}
    else:
        mt = rng.uniform(-10.0, 15.0, T)
        forcings = {'prec': rng.uniform(0.0, 15.0, T), 'mean_temp': mt,
                    'min_temp': mt - 2.0, 'max_temp': mt + 2.0,
                    'etp': rng.uniform(0.0, 4.0, T)}
        kw = dict(met_station_height=495, altitudes=[550, 620, 700, 785, 920],
                  frac_ice=[0.1, 0.2, 0.3, 0.4, 0.5])
    head = {k: v[:30] for k, v in forcings.items()}
    tail = {k: v[30:] for k, v in forcings.items()}
    q, state = model.simulate(**head, **kw, params=params,
                              return_final_state=True, engine='fused')
    state = perturb_state(state, torch.Generator(device=device).manual_seed(1),
                          rel_std=0.3)
    q_tail = model.simulate(**tail, **kw, params=params, initial_state=state,
                            engine='fused')
    obs = 1.2 * q_tail[:, 0].double().cpu().numpy()
    return model, tail, kw, obs, params, state


def _assim_leaves(state):
    from rrmpg_tpu_torch.tools.assimilation import _named_leaves

    return [leaf for _, leaf in _named_leaves(state)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", list(ASSIM_METHODS))
@pytest.mark.parametrize("N", ASSIM_MEMBERS)
@pytest.mark.parametrize("name", ASSIM_MODELS)
def test_assimilation_scan_backend_matches_host(cuda, name, N, method,
                                                dtype):
    from rrmpg_tpu_torch.tools import assimilation_cycle

    model, tail, kw, obs, params, state = _assim_setup(name, N, cuda, dtype)
    options = dict(ASSIM_METHODS[method])
    if options.get("estimate_params") or method == "pf":
        options["param_bounds"] = model._default_bounds
    runs = {backend: assimilation_cycle(
        model, tail, obs, ASSIM_WINDOW, params=params, initial_state=state,
        key=torch.Generator(device=cuda).manual_seed(5), backend=backend,
        engine='fused', **options, **kw) for backend in ("host", "scan")}
    (sh, ph, qh, dh), (ss, ps, qs, ds) = runs["host"], runs["scan"]
    rtol, atol = TOL[dtype]["traj"]
    assert qs.shape == (ASSIM_WINDOW * ASSIM_CYCLES, N)
    assert np.isfinite(qs).all()
    np.testing.assert_allclose(qs, qh, rtol=rtol, atol=atol)
    np.testing.assert_allclose(ds.innovation, dh.innovation, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(ds.posterior_mean, dh.posterior_mean,
                               rtol=rtol, atol=atol)
    for a, b in zip(_assim_leaves(ss), _assim_leaves(sh)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=rtol, atol=atol)
    for k in params.dtype.names:
        np.testing.assert_allclose(ps[k], ph[k], rtol=rtol, atol=atol)
    if method == "pf":
        np.testing.assert_allclose(ds.ess, dh.ess, rtol=rtol)


@pytest.mark.parametrize("method", list(ASSIM_METHODS))
@pytest.mark.parametrize("name", ASSIM_MODELS)
def test_assimilation_scan_loop_reads_nothing_back(cuda, name, method):
    """Every synchronisation of the host with the card inside the scan
    backend's window loop raises under ``set_sync_debug_mode('error')``."""
    from rrmpg_tpu_torch.tools import assimilation as assim

    model, tail, kw, obs, params, state = _assim_setup(name, 200, cuda,
                                                       torch.float32)
    options = dict(inflation=1.0, frozen=assim.CONSTANT_FIELDS,
                   postprocess=assim.REPAIR_KNOWN, estimate_params=False,
                   param_bounds=None, method='enkf', ess_threshold=0.5,
                   jitter=0.0)
    options.update(ASSIM_METHODS[method])
    obs_std = options.pop("obs_std")
    if options["estimate_params"] or method == "pf":
        options["estimate_params"] = True
        options["param_bounds"] = model._default_bounds
    run, finish = assim._scan_program(
        model, tail, obs, ASSIM_WINDOW, obs_std, params, state,
        torch.Generator(device=cuda).manual_seed(5), ASSIM_CYCLES,
        sim_kwargs=dict(kw, engine='fused'), **options)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _, _, q, diags = finish(out)
    assert np.isfinite(q).all() and np.isfinite(diags.innovation).all()


def test_resample_index_clamped_on_the_card(cuda):
    """A float32 sum of normalized weights that rounds below the last
    stratified position: the index stays N - 1, and the gather of a state
    at those indices runs (an index of N would trip the card's bounds
    assertion)."""
    from rrmpg_tpu_torch.tools.assimilation import (
        _systematic_resample_indices, _take)
    from rrmpg_tpu_torch.models.states import ABCState

    n = 100_000
    w = torch.full((n,), (1.0 - 1e-5) / n, dtype=torch.float32, device=cuda)
    cumsum = torch.cumsum(w, 0)
    u = torch.tensor(1.0 - 2.0 ** -24, dtype=torch.float32, device=cuda)
    positions = (torch.arange(n, dtype=torch.float32, device=cuda) + u) / n
    assert float(positions[-1]) > float(cumsum[-1])
    idx = _systematic_resample_indices(w, u)
    want = np.minimum(np.searchsorted(cumsum.cpu().numpy(),
                                      positions.cpu().numpy()), n - 1)
    np.testing.assert_array_equal(idx.cpu().numpy(), want)
    assert int(idx.max()) == n - 1
    state = ABCState(storage=torch.arange(n, dtype=torch.float32,
                                          device=cuda))
    taken = _take(state, idx)
    torch.cuda.synchronize()
    assert float(taken.storage[-1]) == n - 1


# ---------------------------------------------------------------------------
# The device mesh: every shard one launch on its device, bit for bit the
# unsharded launch
# ---------------------------------------------------------------------------

def _launches_of(fn):
    fg.reset_launches()
    result = fn()
    torch.cuda.synchronize()
    return result, {k: v for k, v in fg.LAUNCHES.items() if v}


def _mesh_fit_cases():
    """(class, fit kwargs, objective kernel) of the fused fits on a mesh:
    K1/K2 (GR4J), K12 (HBV-Edu), K8 (the hysteresis + ice model, also its
    SCA statistics through fit_Q_SCA)."""
    rng = np.random.default_rng(6)
    T = 200
    gr4j = dict(prec=rng.uniform(0, 15, T), etp=rng.uniform(0, 4, T))
    hbv = dict(temp=rng.uniform(-5, 15, T), prec=rng.uniform(0, 10, T),
               month=np.arange(T) % 12 + 1, PE_m=rng.uniform(0, 3, 12),
               T_m=rng.uniform(-5, 15, 12), soil_init=100.0)
    mean_t = rng.uniform(-9, 13, T)
    snow = dict(prec=rng.uniform(0, 14, T), mean_temp=mean_t,
                min_temp=mean_t - rng.uniform(0.5, 4, T),
                max_temp=mean_t + rng.uniform(0.5, 4, T),
                etp=rng.uniform(0, 3, T), met_station_height=700,
                altitudes=[550, 620, 700, 785, 920],
                frac_ice=np.array([0.02, 0.04, 0.25, 0.51, 0.71]))
    obs = rng.uniform(0.5, 4, T)
    obs[::13] = np.nan
    return [("GR4J", gr4j, "gr4j_mse", "mse"),
            ("GR4J", gr4j, "gr4j_stats", "kge"),
            ("HBVEdu", hbv, "hbv_mse", "mse"),
            ("CemaneigeHystGR4JIce", snow, "snow_mse", "mse")], obs


@pytest.mark.parametrize("case", range(4))
def test_mesh_fit_launches_once_per_shard_bit_for_bit(cuda, case):
    """Four shards of one card: every DE generation is four launches of the
    fused objective (one a shard), and the fit equals the unsharded one bit
    for bit (each member's arithmetic is its own)."""
    from rrmpg_tpu_torch.parallel import default_mesh

    cases, obs = _mesh_fit_cases()
    name, forcing, kernel, metric = cases[case]
    model = getattr(models, name)(device=cuda)
    kw = dict(engine='fused', seed=1, popsize=8, maxiter=3, tol=0.0,
              loss_metric=metric)
    mesh = default_mesh([cuda] * 4)
    plain, n_plain = _launches_of(lambda: model.fit(obs, **forcing, **kw))
    sharded, n_mesh = _launches_of(
        lambda: model.fit(obs, **forcing, mesh=mesh, **kw))
    assert n_plain == {kernel: plain.nit + 1}
    assert n_mesh == {kernel: 4 * (plain.nit + 1)}
    np.testing.assert_array_equal(sharded.population, plain.population)
    np.testing.assert_array_equal(sharded.population_energies,
                                  plain.population_energies)
    if name == "CemaneigeHystGR4JIce":
        ndsi = {f'NDSI{i + 1}': np.random.default_rng(i).uniform(
            0, 100, len(obs)) for i in range(5)}
        plain, n_plain = _launches_of(
            lambda: model.fit_Q_SCA(obs, **forcing, **ndsi, **kw))
        sharded, n_mesh = _launches_of(
            lambda: model.fit_Q_SCA(obs, **forcing, **ndsi, mesh=mesh, **kw))
        assert n_mesh == {"snow_sca_stats": 4 * n_plain["snow_sca_stats"]}
        np.testing.assert_array_equal(sharded.population_energies,
                                      plain.population_energies)


def test_mesh_regional_kernels_launch_once_per_shard(cuda):
    """K5 and K11 on a 2 x 2 (ensemble, catchment) mesh of one card: four
    launches, bit for bit the one unsharded launch."""
    from rrmpg_tpu_torch import interop
    from rrmpg_tpu_torch.parallel import (ensemble_catchment_mesh,
                                          regional_gr4j_objective,
                                          regional_snow_objective)

    rng = np.random.default_rng(7)
    C, T, L, N = 4, 300, 5, 512
    kw = dict(device=cuda, dtype=torch.float32)
    qobs = _regional_qobs(rng, C, T, True)
    prec, etp, qo = interop.regional_forcing_from_numpy(
        rng.uniform(0, 15, (C, T)), rng.uniform(0, 4, (C, T)), qobs, **kw)
    etp_s, qo_s, lp, lt, lf, fi = interop.regional_forcing_from_numpy(
        etp.cpu().numpy(), qobs, layers=(
            rng.uniform(0, 15, (C, T, L)), rng.uniform(-12, 18, (C, T, L)),
            rng.uniform(0, 1, (C, T, L))),
        frac_ice=rng.uniform(0, 0.7, (C, L)), **kw)
    *_, params = _snow_inputs(cuda, torch.float32, L, 2.9, N=N)
    mesh = ensemble_catchment_mesh(2, 2, devices=[cuda] * 4)
    for metric in ("mse", "kge"):
        def gr4j(mesh=None):
            return regional_gr4j_objective(prec, etp, qo, 0.3, 0.3, params,
                                           loss_metric=metric, mesh=mesh)

        def snow(mesh=None):
            return regional_snow_objective(
                lp, lt, etp_s, lf, qo_s, 0.0, 0.0, 0.5, 0.4, params,
                frac_ice=fi, hyst=True, ice=True, loss_metric=metric,
                mesh=mesh)

        for fn, kernel in ((gr4j, "gr4j_regional"), (snow, "snow_regional")):
            want, n_plain = _launches_of(fn)
            got, n_mesh = _launches_of(lambda: fn(mesh))
            assert n_plain == {kernel: 1} and n_mesh == {kernel: 4}
            assert got.shape == (C, N)
            assert torch.equal(got, want), (kernel, metric)


def test_current_device_kept_across_launches_on_every_device(cuda):
    """An entry point selects its device itself (the library's own CUDA
    runtime); the caller's current device is the same after a launch on
    every visible card, and a fit on a mesh over all of them equals the
    unsharded fit."""
    from rrmpg_tpu_torch.parallel import default_mesh

    before = torch.cuda.current_device()
    for i in range(torch.cuda.device_count()):
        prec, etp, qobs, params = _inputs(torch.device("cuda", i),
                                          torch.float32)
        out = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.4, 0.3, params,
                                         10, 21)
        torch.cuda.synchronize(i)
        assert out.device == torch.device("cuda", i)
        assert torch.cuda.current_device() == before
    qobs, prec, etp = _fit_inputs()
    kw = dict(engine='fused', seed=0, maxiter=3, tol=0.0)
    mesh = default_mesh()
    assert mesh.size == torch.cuda.device_count()
    plain = GR4J(device=cuda).fit(qobs, prec, etp, **kw)
    sharded = GR4J(device=cuda).fit(qobs, prec, etp, mesh=mesh, **kw)
    np.testing.assert_array_equal(sharded.population_energies,
                                  plain.population_energies)
    assert torch.cuda.current_device() == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T", [365, 12418])
def test_scan_metrics_do_not_depend_on_the_row(cuda, dtype, T):
    """A member's masked metrics are the same bits in a batch of 12 and in
    one of 3 (ATen's sum would choose its order from the batch's shape and
    a row's alignment), so a 'scan' objective on a mesh shard gives the
    unsharded numbers."""
    from rrmpg_tpu_torch.utils import metrics

    rng = np.random.default_rng(1)
    obs = rng.uniform(0, 5, T)
    obs[::13] = np.nan
    obs = torch.tensor(obs, dtype=dtype, device=cuda)
    sim = torch.tensor(rng.uniform(0, 5, (12, T)), dtype=dtype, device=cuda)
    for metric in (metrics.mse, metrics.nse, metrics.kge):
        whole = metric(obs[None, :], sim, dim=-1)
        parts = torch.cat([metric(obs[None, :], sim[k:k + 3].clone(),
                                  dim=-1) for k in range(0, 12, 3)])
        assert torch.equal(whole, parts), metric.__name__


def test_sce_fit_on_a_mesh_of_one_card_is_the_unsharded_fit(cuda):
    """``fit(method='sce', engine='scan', mesh=)``: the per-point
    objective on 4 shards of one card gives the unsharded SCE fit bit for
    bit (3 of the 12 candidates a shard)."""
    from rrmpg_tpu_torch.parallel import default_mesh

    qobs, prec, etp = (a[-365:] for a in _fit_inputs())
    kw = dict(method='sce', engine='scan', seed=0, maxiter=1)
    plain = GR4J(device=cuda).fit(qobs, prec, etp, **kw)
    sharded = GR4J(device=cuda).fit(qobs, prec, etp,
                                    mesh=default_mesh(['cuda:0'] * 4), **kw)
    np.testing.assert_array_equal(sharded.population, plain.population)
    np.testing.assert_array_equal(sharded.population_energies,
                                  plain.population_energies)
