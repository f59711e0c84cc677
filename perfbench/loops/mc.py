"""Monte-Carlo sweep: chunks of members drawn on the device from the seed,
one after another, as a study of millions of members runs them.

Each chunk is one call of the model's fused statistics objective, then
``ops.losses_from_stats`` for NSE and KGE, then the chunk's best member of
each score; nothing is read back inside the window.  Of every chunk the
benchmark keeps, on the device, ``kept_per_call`` members, one in each
equal slice of the chunk at a position drawn once from the seed, and the
chunk's two best members: their
parameters and the program's NSE and KGE.  After the
window the reference recomputes a sample of ``checked`` of the kept
members, drawn from the seed, and the sweep's best member of each score.

Traffic parameters: ``members`` (a chunk), ``days`` (the first days of the
record), ``kept_per_call``, ``checked``.
"""

import time

import numpy as np
import torch

from perfbench.harness import stratified
from perfbench.reference import losses


class Run:
    def __init__(self, plan, devices, seed):
        self.plan, self.devices, self.seed = plan, devices, seed
        self.device = devices[0]
        tr = plan.traffic
        self.members, self.days = tr["members"], tr["days"]
        self.kept_per_call, self.checked = tr["kept_per_call"], tr["checked"]

    def setup(self):
        self.model = self.plan.model.Objective(self.plan.config, self.days,
                                               self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.fixed = stratified(self.members, self.kept_per_call,
                                self.generator)

    def call(self, spans):
        """One chunk; returns the (P + 2, k + 2) kept block: parameters,
        NSE and KGE of the kept members."""
        from rrmpg_tpu_torch import ops

        m = self.model
        t0 = time.time_ns()
        draws = torch.addcmul(m.lows, m.span, torch.rand(
            (len(m.params), self.members), generator=self.generator,
            device=self.device, dtype=m.lows.dtype))
        params = {k: draws[j] for j, k in enumerate(m.params)}
        t1 = time.time_ns()
        stats = m.program_stats(params)
        scores = ops.losses_from_stats(stats, m.qobs)
        t2 = time.time_ns()
        nse, kge = scores["nse"], scores["kge"]
        at = torch.cat([self.fixed, nse.argmax()[None], kge.argmax()[None]])
        kept = torch.cat([draws.index_select(1, at), nse[at][None],
                          kge[at][None]])
        spans += [("draw", t0, t1), ("program", t1, t2),
                  ("keep", t2, time.time_ns())]
        return kept

    def finish(self, outputs):
        self.kept = torch.cat(outputs, dim=1)
        return len(outputs) * self.members * self.days

    def release(self):
        self.kept = self.kept.to("cpu", torch.float64)
        del self.generator, self.fixed
        torch.cuda.empty_cache()

    def _columns(self):
        """The kept members the check reads: a sample of ``checked`` drawn
        from the seed, and the sweep's best member of each score."""
        rows, p = self.kept, len(self.model.params)
        rng = np.random.default_rng(self.seed)
        n = rows.shape[1]
        sample = rng.choice(n, size=min(self.checked, n), replace=False)
        best = [int(torch.nan_to_num(rows[p + j], nan=-np.inf).argmax())
                for j in range(2)]
        return torch.as_tensor(np.unique(np.concatenate([sample, best])))

    def answers(self):
        cols = self._columns()
        p = len(self.model.params)
        return {"nse": self.kept[p, cols], "kge": self.kept[p + 1, cols]}

    def reference(self, dtype):
        """The reference's NSE and KGE of the checked members, computed in
        ``dtype`` on the host from the program's inputs."""
        cols = self._columns()
        params = {k: self.kept[j, cols]
                  for j, k in enumerate(self.model.params)}
        stats = self.model.reference_stats(params, dtype)
        qobs = self.model.qobs.to("cpu", torch.float64).to(dtype)
        out = losses.scores(stats, qobs)
        return {k: v.to(torch.float64) for k, v in out.items()}

    def member_day_ops(self):
        return self.model.member_day_ops()
