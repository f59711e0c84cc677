"""Regional sweep: one chunk of members a call, drawn on the device from
the seed, over C catchments on a device mesh, one call after another.

The catchments are made from the configuration's basin: each one's days
are the basin's hydrological years in an order drawn from the seed, so
every catchment has the basin's length and climate in another sequence.
The last catchments' gauges opened later: they have no discharge for their
first ``gauges_opened_after_years`` years, and the objective masks those
days; their forcing is complete.  The series are prepared once, before the
window, as a user looping over chunks prepares them.

Of every call the benchmark keeps, on the device, one (catchment, member)
pair in each block of one catchment and one ensemble shard's members, at a
member drawn once from the seed, and the call's best pair: the member's
parameters and the program's loss.  So every call's check reaches every
catchment, the late gauges' masks and valid counts among them, and every
card's block.  After the window the reference recomputes a sample of
``checked`` of the kept pairs, drawn from the seed in equal parts from
each block, and the sweep's best pair.

Traffic parameters: ``catchments``, ``members``, ``mesh`` (ensemble,
catchment), ``loss_metric``, ``gauges_opened_after_years``, ``checked``.
"""

import time

import numpy as np
import torch

from perfbench.harness import stratified


def make_region(rec, years, catchments, opened_after, rng):
    """(C, T) series of ``catchments`` permutations of the record's
    hydrological years; the last ``len(opened_after)`` catchments lose
    their discharge over their first ``opened_after`` years."""
    blocks = [np.flatnonzero(years == y) for y in np.unique(years)]
    out = {k: np.empty((catchments, len(v))) for k, v in rec.items()}
    first = catchments - len(opened_after)
    for c in range(catchments):
        order = rng.permutation(len(blocks))
        days = np.concatenate([blocks[i] for i in order])
        for k, v in rec.items():
            out[k][c] = v[days]
        if c >= first:
            gap = sum(len(blocks[i]) for i in order[:opened_after[c - first]])
            out["qobs"][c, :gap] = np.nan
    return out


class Run:
    def __init__(self, plan, devices, seed):
        self.plan, self.devices, self.seed = plan, devices, seed
        tr = plan.traffic
        self.members, self.checked = tr["members"], tr["checked"]
        self.shards = tr["mesh"][0]

    def setup(self):
        model, cfg, tr = self.plan.model, self.plan.config, self.plan.traffic
        rng = np.random.default_rng(self.seed)
        region = make_region(model.record(cfg), model.water_years(cfg),
                             tr["catchments"], tr["gauges_opened_after_years"],
                             rng)
        self.days = region["qobs"].shape[1]
        self.obj = model.Regional(cfg, tr, region, self.devices)
        self.home = self.devices[0]
        self.generator = torch.Generator(device=self.home)
        self.generator.manual_seed(self.seed)
        m = self.members
        self.fixed = torch.cat([c * m + stratified(m, self.shards,
                                                   self.generator)
                                for c in range(tr["catchments"])])

    def _block(self, flat):
        """The (catchment, ensemble shard) block of flat positions."""
        member = flat % self.members
        return (flat // self.members) * self.shards \
            + member * self.shards // self.members

    def call(self, spans):
        """One call over every catchment; returns the (P + 2, k + 1) kept
        block: parameters, loss and flat (catchment, member) position."""
        o = self.obj
        t0 = time.time_ns()
        draws = torch.addcmul(o.lows, o.span, torch.rand(
            (len(o.params), self.members), generator=self.generator,
            device=self.home, dtype=o.lows.dtype))
        params = {k: draws[j] for j, k in enumerate(o.params)}
        t1 = time.time_ns()
        losses = o.program_losses(params).reshape(-1)
        t2 = time.time_ns()
        at = torch.cat([self.fixed,
                        torch.nan_to_num(losses, nan=torch.inf).argmin()[None]])
        kept = torch.cat([draws.index_select(1, at % self.members),
                          losses[at][None], at[None].to(draws.dtype)])
        spans += [("draw", t0, t1), ("program", t1, t2),
                  ("keep", t2, time.time_ns())]
        return kept

    def finish(self, outputs):
        self.kept = torch.cat(outputs, dim=1)
        return (len(outputs) * self.plan.traffic["catchments"] * self.members
                * self.days)

    def release(self):
        self.kept = self.kept.to("cpu", torch.float64)
        del self.generator, self.fixed
        torch.cuda.empty_cache()

    def _columns(self):
        """A sample of ``checked`` kept pairs drawn from the seed, equal
        parts from each (catchment, ensemble shard) block, and the sweep's
        best pair."""
        p = len(self.obj.params)
        loss = self.kept[p]
        block = self._block(self.kept[p + 1].round().long()).numpy()
        blocks = self.plan.traffic["catchments"] * self.shards
        per = max(1, self.checked // blocks)
        rng = np.random.default_rng(self.seed + 1)
        sample = [rng.choice(cols, size=min(per, len(cols)), replace=False)
                  for cols in (np.flatnonzero(block == b)
                               for b in range(blocks))]
        best = int(torch.nan_to_num(loss, nan=np.inf).argmin())
        return torch.as_tensor(np.unique(np.concatenate(sample + [[best]])))

    def answers(self):
        cols = self._columns()
        return {"loss": self.kept[len(self.obj.params), cols]}

    def reference(self, dtype):
        cols = self._columns()
        p = len(self.obj.params)
        flat = self.kept[p + 1, cols].round().long()
        params = {k: self.kept[j, cols] for j, k in enumerate(self.obj.params)}
        out = self.obj.reference_losses(flat // self.members, params, dtype)
        return {"loss": out.to(torch.float64)}

    def member_day_ops(self):
        return self.obj.member_day_ops()
