"""PyTorch port, ``CAMELSLoader.load_basins`` against the JAX loader.

Both loaders read the same CAMELS-format files, written here from a seed
(the file writer of ``tests/test_masked.py``, copied): inner and outer
joins, column selection and basin order, the errors of a forcing gap under
an outer join, of disjoint periods and of a bad ``join``, and the loaded
arrays through the port's regional objective against JAX's.  The loaders
are pandas both: results must be equal, NaN where the other has NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrmpg_tpu.data import CAMELSLoader as JaxLoader
from rrmpg_tpu.parallel.regional import (
    regional_gr4j_objective as jax_regional_gr4j_objective)
from rrmpg_tpu_torch import interop
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.parallel import regional_gr4j_objective

torch.set_num_threads(1)


def _write_camels_basin(directory, basin, T=800, q_sentinel_rows=(),
                        start="1980-01-01"):
    """Minimal CAMELS-format file pair with optional -999 discharge."""
    import pandas as pd

    rng = np.random.default_rng(hash(basin) % 2 ** 31)
    dates = pd.date_range(start, periods=T, freq="D")
    met = directory / f"{basin}_lump_cida_forcing_leap.txt"
    flow = directory / f"{basin}_05_model_output.txt"
    with open(met, "w") as f:
        f.write("lat 45.0\n318.0\n1000000\n")
        f.write("Year Mnth Day Hr dayl(s) prcp(mm/day) srad(W/m2) "
                "swe(mm) tmax(C) tmin(C) vp(Pa)\n")
        for d in dates:
            p = rng.uniform(0, 12)
            f.write(f"{d.year} {d.month} {d.day} 12 43200 {p:.2f} 200 0 "
                    f"{rng.uniform(5, 25):.2f} {rng.uniform(-5, 5):.2f} "
                    "800\n")
    with open(flow, "w") as f:
        f.write("YR MNTH DY HR SWE PRCP RAIM TAIR PET ET MOD_RUN "
                "OBS_RUN\n")
        for i, d in enumerate(dates):
            q = -999.0 if i in q_sentinel_rows else rng.uniform(0.1, 5)
            f.write(f"{d.year} {d.month} {d.day} 12 0 0 0 10 "
                    f"{rng.uniform(0, 4):.2f} 1 1 {q:.2f}\n")


@pytest.fixture
def region(tmp_path):
    """Three basins: a full record, one with a discharge gap, one that
    starts a year later."""
    _write_camels_basin(tmp_path, "02002000", T=900)
    _write_camels_basin(tmp_path, "02002001", T=900,
                        q_sentinel_rows=tuple(range(350, 420)))
    _write_camels_basin(tmp_path, "02002002", T=700, start="1980-07-01")
    return tmp_path


def _both(directory, **kw):
    return (JaxLoader(data_dir=directory).load_basins(**kw),
            CAMELSLoader(data_dir=directory).load_basins(**kw))


def _assert_same(want, got):
    (w_index, w_arrays), (g_index, g_arrays) = want, got
    assert g_index.equals(w_index)
    assert list(g_arrays) == list(w_arrays)
    for column, arr in w_arrays.items():
        assert g_arrays[column].shape == arr.shape
        np.testing.assert_array_equal(g_arrays[column], arr)


@pytest.mark.parametrize("kw", [
    dict(join="inner"),
    dict(join="inner", columns=["prcp(mm/day)", "PET", "QObs(mm/d)"]),
    dict(join="inner", basin_numbers=["02002002", "02002000"]),
    dict(join="outer", basin_numbers=["02002000", "02002001"]),
], ids=["inner", "columns", "order", "outer"])
def test_load_basins_matches_jax(region, kw):
    want, got = _both(region, **kw)
    _assert_same(want, got)
    index, arrays = got
    assert all(a.shape == (len(kw.get("basin_numbers", "abc")), len(index))
               for a in arrays.values())


def test_outer_join_pads_observations_with_nan(region):
    """Ragged discharge records come back NaN-padded, forcing complete."""
    want, got = _both(region, join="outer",
                      basin_numbers=["02002000", "02002001"],
                      columns=["prcp(mm/day)", "PET", "QObs(mm/d)"])
    _assert_same(want, got)
    qobs = got[1]["QObs(mm/d)"]
    assert np.isnan(qobs[1]).sum() == 70 and np.isfinite(qobs[0]).all()
    assert np.isfinite(got[1]["prcp(mm/day)"]).all()


def test_outer_join_forcing_gap_raises_like_jax(region):
    for loader in (JaxLoader(data_dir=region), CAMELSLoader(data_dir=region)):
        with pytest.raises(ValueError, match="padded forcing column"):
            loader.load_basins(join="outer")


def test_disjoint_periods_and_bad_join_raise_like_jax(tmp_path):
    _write_camels_basin(tmp_path, "03000000", T=400, start="1980-01-01")
    _write_camels_basin(tmp_path, "03000001", T=400, start="1990-01-01")
    for loader in (JaxLoader(data_dir=tmp_path),
                   CAMELSLoader(data_dir=tmp_path)):
        with pytest.raises(ValueError, match="share no common dates"):
            loader.load_basins(join="inner")
        with pytest.raises(ValueError, match="join must be 'inner' or "
                                             "'outer'"):
            loader.load_basins(join="left")


def test_loaded_region_through_the_regional_objective(region):
    """load_basins(join='outer') -> the port's masked regional GR4J sweep
    equals JAX's on the same files (rtol 1e-10, float64)."""
    basins = ["02002000", "02002001"]
    index, arrays = CAMELSLoader(data_dir=region).load_basins(
        basin_numbers=basins, join="outer")
    prec, etp, qobs = (arrays[k] for k in ("prcp(mm/day)", "PET",
                                           "QObs(mm/d)"))
    rng = np.random.default_rng(3)
    params = {'x1': rng.uniform(100, 1200, 5), 'x2': rng.uniform(-5, 3, 5),
              'x3': rng.uniform(20, 300, 5), 'x4': rng.uniform(1.1, 2.9, 5)}
    want = np.asarray(jax_regional_gr4j_objective(
        prec, etp, qobs, 0.3, 0.3, {k: jnp.asarray(v)
                                    for k, v in params.items()},
        engine="xla"))
    got = regional_gr4j_objective(
        *interop.regional_forcing_from_numpy(prec, etp, qobs, device='cpu',
                                             dtype=torch.float64),
        0.3, 0.3, interop.params_from_numpy(params, device='cpu',
                                            dtype=torch.float64))
    assert got.shape == (2, 5) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
