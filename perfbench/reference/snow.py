"""Plain CemaNeige with hysteresis and glacier ice melt before GR4J, the
yardstick of the benchmark's snow cells.

CemaNeige (Valery, Andreassian & Perrin 2014, J. Hydrol. 517:1166-1175) on
L elevation layers, with the snow-cover hysteresis of Riboust et al. (2019,
J. Hydrol. Hydromech. 67:70-81), a degree-day melt of the glaciated share
of each layer where its snowpack is at most 1 mm (kratzert/RRMPG
``cemaneigehystgr4jice.py``), and GR4J fed with the layers' mean liquid
water plus the ice melt.  Plain PyTorch, one time loop over a batch of M
members; imports nothing of the program under test.  The layers' constant,
the mean annual solid precipitation, is worked out here from the layer
forcing the benchmark made.
"""

import torch

from perfbench.reference import gr4j

PARAMS = ("CTG", "Kf", "Thacc", "Rsp", "x1", "x2", "x3", "x4", "DDF")
SHIELD_SWE = 1.0     # mm of snowpack above which the ice does not melt


class Members:
    """Layer states (M, L) and the GR4J stores of M members."""

    def __init__(self, params, psol_annual, frac_ice, snow0, th0, s_init,
                 r_init, num_uh1, num_uh2):
        col = {k: params[k][:, None] for k in ("CTG", "Kf", "Thacc", "Rsp",
                                               "DDF")}
        self.ctg, self.kf, self.thacc = col["CTG"], col["Kf"], col["Thacc"]
        self.rsp, self.ddf = col["Rsp"], col["DDF"]
        self.th_melt = psol_annual[None, :] * self.rsp      # (M, L)
        self.frac_ice = frac_ice
        self.snow0, self.th0 = snow0, th0
        m, layers = params["x1"].shape[0], psol_annual.shape[0]
        like = params["x1"]
        self.g = like.new_zeros((m, layers))
        self.etg = like.new_zeros((m, layers))
        self.sca = like.new_zeros((m, layers))
        self.swe_max = like.new_zeros((m, layers))
        self.first = True
        self.gr4j = gr4j.Members(params, s_init, r_init, num_uh1, num_uh2)

    def layers(self, snow, rain, temp):
        """One day of every layer; returns the (M, L) liquid water.  The
        first day starts from the initial pack and thermal state."""
        if self.first:
            g = torch.full_like(self.g, self.snow0)
            th = torch.full_like(self.g, self.th0)
            self.first = False
        else:
            g = self.g + snow
            th = self.ctg * self.etg + (1.0 - self.ctg) * temp
        th = torch.clamp(th, max=0.0)
        zero = torch.zeros_like(g)
        pot_melt = torch.where((th == 0.0) & (temp > 0.0),
                               torch.minimum(self.kf * temp, g), zero)
        balance = snow - pot_melt
        accumulating = balance >= 0.0
        thacc = torch.where(self.thacc > 0, self.thacc,
                            torch.ones_like(self.thacc))
        sca_acc = torch.where(self.thacc > 0,
                              self.sca + balance / thacc, self.sca)
        th_max = torch.minimum(self.swe_max, self.th_melt)
        positive = th_max > 0.0
        sca_abl = torch.where(
            positive, g / torch.where(positive, th_max, torch.ones_like(g)),
            zero)
        sca = torch.clamp(torch.where(accumulating, sca_acc, sca_abl),
                          0.0, 1.0)
        swe_max = torch.where(accumulating, torch.maximum(self.swe_max, g),
                              self.swe_max)
        melt = torch.minimum((0.9 * sca + 0.1) * pot_melt, g)
        g = g - melt
        self.sca = sca
        self.swe_max = torch.where(g == 0.0, zero, swe_max)
        self.g, self.etg = g, th
        return rain + melt

    def step(self, snow, rain, temp, etp):
        liquid = self.layers(snow, rain, temp).mean(dim=1)
        ice = torch.clamp(self.ddf * temp, min=0.0)
        ice = torch.where(self.g > SHIELD_SWE, torch.zeros_like(ice), ice)
        return self.gr4j.step(liquid + (ice * self.frac_ice).sum(dim=1), etp)


def objective_stats(prec, mean_temp, frac_solid, etp, qobs, frac_ice,
                    params, inits, num_uh1, num_uh2):
    """(4, M) time means of the coupled model's discharge against ``qobs``.
    ``prec``, ``mean_temp`` and ``frac_solid`` are the (T, L) layer forcing,
    ``etp`` and ``qobs`` (T,), ``frac_ice`` (L,), ``params`` a dict of (M,)
    tensors and ``inits`` the dict of the four initial values."""
    snow = prec * frac_solid
    rain = prec - snow
    psol_annual = 365.25 * snow.mean(dim=0)
    members = Members(params, psol_annual, frac_ice, inits["snow_pack_init"],
                      inits["thermal_state_init"], inits["s_init"],
                      inits["r_init"], num_uh1, num_uh2)
    return gr4j.time_means(members, (snow, rain, mean_temp, etp), qobs,
                           lambda m, s, r, t, e: m.step(s, r, t, e))
