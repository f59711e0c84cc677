"""Plain GR4J (Perrin, Michel & Andreassian 2003, J. Hydrol. 279:275-289),
the yardstick of the benchmark's GR4J cells.

Plain PyTorch, one time loop over a batch of M members, in whatever dtype
the caller gives (float64 for the reference, a lower one for the control).
It imports nothing of the program under test: the unit-hydrograph
ordinates, the stores and the time means are worked out here again from
the benchmark's own inputs.  The unit hydrographs run on fixed register
lengths (``num_uh1``, ``num_uh2``); ordinates past ceil(x4) / ceil(2 x4)
are exactly zero, so any length that covers the members' x4 gives the
published model.

Forcing is (T,) (one series for every member) or (T, M) (a series per
member, as a regional sample draws members from several catchments).
"""

import torch

PARAMS = ("x1", "x2", "x3", "x4")


def _s_curve1(t, x4):
    frac = torch.clamp(t / x4, 0.0, 1.0)
    return torch.where(t <= 0, torch.zeros_like(frac), frac ** 2.5)


def _s_curve2(t, x4):
    ratio = t / x4
    rising = 0.5 * torch.clamp(ratio, 0.0, 1.0) ** 2.5
    falling = 1.0 - 0.5 * torch.clamp(2.0 - ratio, 0.0, 1.0) ** 2.5
    out = torch.where(t <= x4, rising, falling)
    return torch.where(t <= 0, torch.zeros_like(out), out)


def uh_ordinates(x4, num_uh1, num_uh2):
    """(M, num_uh1) and (M, num_uh2) ordinates of UH1 and UH2."""
    x4 = x4[:, None]
    j1 = torch.arange(1, num_uh1 + 1, dtype=x4.dtype, device=x4.device)
    j2 = torch.arange(1, num_uh2 + 1, dtype=x4.dtype, device=x4.device)
    return (_s_curve1(j1, x4) - _s_curve1(j1 - 1.0, x4),
            _s_curve2(j2, x4) - _s_curve2(j2 - 1.0, x4))


class Members:
    """The stores and unit-hydrograph registers of M members."""

    def __init__(self, params, s_init, r_init, num_uh1, num_uh2):
        self.x1, self.x2, self.x3, x4 = (params[k] for k in PARAMS)
        self.s = s_init * self.x1
        self.r = r_init * self.x3
        self.oh1, self.oh2 = uh_ordinates(x4, num_uh1, num_uh2)
        self.uh1 = torch.zeros_like(self.oh1)
        self.uh2 = torch.zeros_like(self.oh2)

    def step(self, p, e):
        """One day: net rainfall, production store, percolation, the two
        unit hydrographs, groundwater exchange and the routing store.
        Returns the (M,) discharge."""
        x1, x3 = self.x1, self.x3
        p_n = torch.clamp(p - e, min=0.0)
        e_n = torch.clamp(e - p, min=0.0)
        sr = self.s / x1
        tp = torch.tanh(p_n / x1)
        te = torch.tanh(e_n / x1)
        p_s = x1 * (1.0 - sr * sr) * tp / (1.0 + sr * tp)
        e_s = self.s * (2.0 - sr) * te / (1.0 + (1.0 - sr) * te)
        s = self.s - e_s + p_s
        perc = s * (1.0 - (1.0 + (4.0 / 9.0 * s / x1) ** 4) ** -0.25)
        self.s = s - perc
        p_r = perc + (p_n - p_s)

        self.uh1 = torch.nn.functional.pad(self.uh1[:, 1:], (0, 1)) \
            + self.oh1 * (0.9 * p_r)[:, None]
        self.uh2 = torch.nn.functional.pad(self.uh2[:, 1:], (0, 1)) \
            + self.oh2 * (0.1 * p_r)[:, None]

        exchange = self.x2 * (self.r / x3) ** 3.5
        r = torch.clamp(self.r + self.uh1[:, 0] + exchange, min=0.0)
        q_r = r * (1.0 - (1.0 + (r / x3) ** 4) ** -0.25)
        self.r = r - q_r
        q_d = torch.clamp(self.uh2[:, 0] + exchange, min=0.0)
        return q_r + q_d


def time_means(members, forcing, qobs, step):
    """(4, M) time means [mse, mean q, mean q^2, mean q qobs] over the days
    whose observation is finite (every day where none is missing).
    ``forcing`` is a tuple of (T, ...) series handed to ``step`` day by
    day; ``qobs`` is (T,) or (T, M)."""
    t_len = qobs.shape[0]
    valid = torch.isfinite(qobs)
    obs = torch.where(valid, qobs, torch.zeros_like(qobs))
    acc = None
    for t in range(t_len):
        q = step(members, *(f[t] for f in forcing))
        o = obs[t]
        terms = torch.stack([(q - o) ** 2, q, q * q, q * o])
        terms = torch.where(valid[t], terms, torch.zeros_like(terms))
        acc = terms if acc is None else acc + terms
    count = valid.sum(dim=0).to(acc.dtype)
    return acc / count


def objective_stats(prec, etp, qobs, params, s_init, r_init, num_uh1,
                    num_uh2):
    """(4, M) time means of GR4J's discharge against ``qobs``; ``params`` is
    a dict of (M,) tensors, every tensor in one dtype on one device."""
    members = Members(params, s_init, r_init, num_uh1, num_uh2)
    return time_means(members, (prec, etp), qobs,
                      lambda m, p, e: m.step(p, e))
