"""The benchmark's plain reference against the program's 'scan' engine
(plain PyTorch) in float64 on the CPU, at a small size."""

import json

import numpy as np
import pytest
import torch

from perfbench.models import gr4j as gr4j_model
from perfbench.models import snow as snow_model
from perfbench.reference import gr4j, losses, snow
from perfbench.tests.conftest import ROOT

F64 = torch.float64
DAYS, MEMBERS = 400, 16


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


def draw(cfg, names, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.tensor(rng.uniform(*cfg["bounds"][k], MEMBERS),
                            dtype=F64) for k in names}


def time_means(qsim, qobs):
    """(4, N) time means over the finite observations of (N, T) qsim."""
    valid = torch.isfinite(qobs)
    q, o = qsim[:, valid], qobs[valid]
    return torch.stack([((q - o) ** 2).mean(1), q.mean(1), (q * q).mean(1),
                        (q * o).mean(1)])


def series(cfg):
    rec = gr4j_model.record(cfg)
    return {k: torch.tensor(v[:DAYS], dtype=F64) for k, v in rec.items()}


@pytest.mark.parametrize("gap_days", [0, 37])
def test_gr4j_reference_agrees_with_the_scan_engine(gap_days):
    from rrmpg_tpu_torch.ops import run_gr4j

    cfg = config("gr4j-01031500")
    s = series(cfg)
    s["qobs"][:gap_days] = float("nan")
    params = draw(cfg, gr4j.PARAMS, 1)
    want = time_means(run_gr4j(s["prec"], s["etp"], 0.3, 0.2, params,
                               *cfg["uh"])[0], s["qobs"])
    got = gr4j.objective_stats(s["prec"], s["etp"], s["qobs"], params, 0.3,
                               0.2, *cfg["uh"])
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_gr4j_reference_takes_a_series_per_member():
    cfg = config("gr4j-01031500")
    s = series(cfg)
    params = draw(cfg, gr4j.PARAMS, 2)
    shifted = {k: torch.roll(v, 50) for k, v in s.items()}
    per_member = {k: torch.stack([s[k], shifted[k]] * (MEMBERS // 2), 1)
                  for k in s}
    got = gr4j.objective_stats(per_member["prec"], per_member["etp"],
                               per_member["qobs"], params, 0.0, 0.0,
                               *cfg["uh"])
    for j, one in enumerate((s, shifted)):
        want = gr4j.objective_stats(one["prec"], one["etp"], one["qobs"],
                                    params, 0.0, 0.0, *cfg["uh"])
        torch.testing.assert_close(got[:, j::2], want[:, j::2], rtol=1e-12,
                                   atol=0.0)


def test_snow_reference_agrees_with_the_scan_engine():
    from rrmpg_tpu_torch.ops import run_cemaneigehystgr4jice

    cfg = config("cemaneigehystgr4jice-5band")
    rec = {k: v[:DAYS] for k, v in gr4j_model.record(cfg).items()}
    prec, tmean, frac = (torch.tensor(a, dtype=F64) for a in
                         snow_model.layer_forcing(
                             rec, cfg["met_station_height"],
                             cfg["altitudes"]))
    etp, qobs = (torch.tensor(rec[k], dtype=F64) for k in ("etp", "qobs"))
    frac_ice = torch.tensor(cfg["frac_ice"], dtype=F64)
    params = draw(cfg, snow.PARAMS, 3)
    inits = dict(snow_pack_init=5.0, thermal_state_init=-1.0, s_init=0.3,
                 r_init=0.5)
    qsim = run_cemaneigehystgr4jice(
        prec, tmean, etp, frac_ice, frac, inits["snow_pack_init"],
        inits["thermal_state_init"], 0.0, inits["s_init"], inits["r_init"],
        params, *cfg["uh"])[0]
    got = snow.objective_stats(prec, tmean, frac, etp, qobs, frac_ice,
                               params, inits, *cfg["uh"])
    torch.testing.assert_close(got, time_means(qsim, qobs), rtol=1e-10,
                               atol=1e-12)


def test_snow_layer_forcing_agrees_with_the_program():
    from rrmpg_tpu_torch.ops import (calculate_solid_fraction,
                                     extrapolate_precipitation,
                                     extrapolate_temperature)

    cfg = config("cemaneigehystgr4jice-5band")
    rec = {k: v[:DAYS] for k, v in gr4j_model.record(cfg).items()}
    prec, tmean, frac = snow_model.layer_forcing(
        rec, cfg["met_station_height"], cfg["altitudes"])
    alt, z0 = np.asarray(cfg["altitudes"]), cfg["met_station_height"]
    t = {k: torch.tensor(rec[k], dtype=F64) for k in ("tmin", "tmax")}
    mean = 0.5 * (t["tmin"] + t["tmax"])
    lo, mid, hi = extrapolate_temperature(t["tmin"], mean, t["tmax"], alt, z0)
    p = extrapolate_precipitation(torch.tensor(rec["prec"], dtype=F64), alt,
                                  z0)
    np.testing.assert_allclose(prec, p.numpy(), rtol=1e-14)
    np.testing.assert_allclose(tmean, mid.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        frac, calculate_solid_fraction(p, alt, mid, lo, hi).numpy(),
        rtol=0, atol=1e-12)


def test_scores_agree_with_the_programs_losses():
    from rrmpg_tpu_torch.ops import losses_from_stats

    cfg = config("gr4j-01031500")
    s = series(cfg)
    s["qobs"][:20] = float("nan")
    stats = gr4j.objective_stats(s["prec"], s["etp"], s["qobs"],
                                 draw(cfg, gr4j.PARAMS, 4), 0.0, 0.0,
                                 *cfg["uh"])
    want = losses_from_stats(stats, s["qobs"])
    got = losses.scores(stats, s["qobs"])
    for k in ("nse", "kge"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12)


def test_widest_gap():
    nan, inf = float("nan"), float("inf")
    assert losses.widest_gap([0.5, -30.0], [0.5001, -30.3]) == \
        pytest.approx(0.3 / 30.3)
    assert losses.widest_gap([nan], [nan]) == 0.0
    assert losses.widest_gap([nan], [0.2]) == inf
    assert losses.widest_gap([0.2], [nan]) == inf
