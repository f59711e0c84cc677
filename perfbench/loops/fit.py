"""Calibrations back to back: the model class's ``fit`` with the fused
engine over the whole record, fit ``i`` of a run seeded with the run's seed
plus ``i``.

The work of a fit is fixed: ``tol`` 0 never stops differential evolution
early, so every fit runs ``maxiter`` generations of ``popsize`` x 4
members.  Each fit ends with its result on the host.  After the window the
reference recomputes the loss of every member of every fit's final
population and of its best parameters, and the check holds the fits to
them:

* ``fun_gap``, ``energy_gap``: the loss each fit reports for its best
  parameters, and the energies it files under each final member, against
  the reference's loss of those parameters;
* ``pop_excess``: by the reference's losses, how far the median member of
  a fit's final population lies above its best, the worst fit's (a sound
  run's population has gathered round its best; one whose generations did
  no work is still its first draw);
* ``count_gap``: how far a fit's generations and evaluations fall short of
  ``maxiter`` and ``popsize`` x 4 x (``maxiter`` + 1), or its population
  of ``popsize`` x 4 members.

Traffic parameters: ``popsize``, ``maxiter``, ``tol``, ``loss_metric``,
``polish``; ``days`` (optional) cuts the record to its first days.
"""

import time

import numpy as np
import torch



class Run:
    def __init__(self, plan, devices, seed):
        self.plan, self.devices, self.seed = plan, devices, seed

    def setup(self):
        self.fit = self.plan.model.Fit(self.plan.config, self.plan.traffic,
                                       self.devices[0])
        self.days = self.fit.days
        self.index = 0

    def call(self, spans):
        """One fit, seeded with the run's seed plus its index."""
        t0 = time.time_ns()
        result = self.fit.run(self.seed + self.index)
        spans.append(("fit", t0, time.time_ns()))
        self.index += 1
        return result

    def finish(self, outputs):
        self.results = outputs
        return sum(r.nfev for r in outputs) * self.days

    def release(self):
        torch.cuda.empty_cache()

    def answers(self):
        r = self.results
        return {"fun": torch.tensor([x.fun for x in r], dtype=torch.float64),
                "energy": torch.tensor(np.concatenate(
                    [x.population_energies for x in r]),
                    dtype=torch.float64)}

    def reference(self, dtype):
        """The reference's loss, in ``dtype``, of every fit's best
        parameters and of every member of its final population."""
        r = self.results
        rows = np.concatenate([np.stack([x.x for x in r])]
                              + [x.population for x in r])
        out = self.fit.reference_mse(
            torch.tensor(rows, dtype=torch.float64), dtype)
        out = out.to(torch.float64)
        if dtype == torch.float64:
            self.float64 = out
        return {"fun": out[:len(r)], "energy": out[len(r):]}

    def scores(self):
        """``pop_excess`` and ``count_gap`` of the fits, from the float64
        reference that :meth:`reference` left."""
        r, tr = self.results, self.plan.traffic
        best = self.float64[:len(r)]
        members = self.float64[len(r):].split(
            [len(x.population) for x in r])
        excess = max(float(((m - b) / b).median())
                     for m, b in zip(members, best))
        pop_size = tr["popsize"] * len(self.plan.model.PARAMS)
        short = max(abs(x.nit - tr["maxiter"])
                    + abs(x.nfev - pop_size * (tr["maxiter"] + 1))
                    + abs(x.population.shape[0] - pop_size) for x in r)
        return {"pop_excess": excess, "count_gap": float(short)}

    def member_day_ops(self):
        return self.fit.member_day_ops()
