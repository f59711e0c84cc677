"""Faults planted under a cell's timed path, to show that the check of
``correct`` catches them: the benchmark's tests plant them at CPU sizes,
``perfbench/control.py --fault`` on the cards at a cell's own size.

Each model module names, per loop kind, the program's entry that the
timed path reaches (``ENTRIES``: module, attribute, and the positional
series it takes with their time axis), so a fault needs no table of cells.

* ``altered``: a statistic or loss 10 % off where it is produced;
* ``half_the_days``: the time means over the first half of the record;
* ``half_the_members``: half of the members evaluated, the other half's
  results copied from them;
* ``no_work``: the entry's output left as allocated (zeros);
* ``no_exchange``: every shard's block of a mesh call is the first
  shard's (the other devices' results never reach the caller);
* ``unchanged_state``: differential evolution whose generations leave the
  population as they found it, with the counters of a full run.
"""

import contextlib
import importlib

import torch


def altered(real, series):
    def fn(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[1 if out.dim() > 1 else slice(None)] *= 1.1
        return out
    return fn


def half_the_days(real, series):
    def fn(*args, **kwargs):
        args = list(args)
        for i, axis in series.items():
            args[i] = args[i].narrow(axis, 0, args[i].shape[axis] // 2)
            args[i] = args[i].contiguous()
        qobs = args[max(series)]
        if "count" in kwargs:
            kwargs["count"] = int(torch.isfinite(qobs).sum())
        if "counts" in kwargs:
            kwargs["counts"] = torch.isfinite(qobs).sum(1).to(qobs.dtype)
        return real(*args, **kwargs)
    return fn


def half_the_members(real, series):
    def fn(*args, **kwargs):
        args = list(args)
        at = next(i for i, a in enumerate(args) if isinstance(a, dict))
        members = next(iter(args[at].values())).shape[-1]
        half = max(1, members // 2)
        args[at] = {k: v[..., :half] for k, v in args[at].items()}
        out = real(*args, **kwargs)
        return out[..., torch.arange(members, device=out.device) % half]
    return fn


def no_work(real, series):
    def fn(*args, **kwargs):
        return torch.zeros_like(real(*args, **kwargs))
    return fn


def _no_exchange():
    import rrmpg_tpu_torch.parallel.regional as regional

    real = regional.sharded_call

    def fn(local, mesh, args, in_axes, out_axes, pad=True):
        out = real(local, mesh, args, in_axes, out_axes, pad)
        c, n = out.shape
        block = out[:c // mesh.shape["catchment"],
                    :n // mesh.shape["ensemble"]]
        return block.repeat(mesh.shape["catchment"], mesh.shape["ensemble"])

    return regional, "sharded_call", fn


def _unchanged_state():
    import rrmpg_tpu_torch.tools.calibration as calibration

    real = calibration.differential_evolution

    def fn(objective, bounds, **kwargs):
        maxiter = kwargs["maxiter"]
        result = real(objective, bounds, **dict(kwargs, maxiter=0))
        return result._replace(nit=maxiter,
                               nfev=result.nfev * (maxiter + 1))

    return calibration, "differential_evolution", fn


ON_ENTRY = {"altered": altered, "half_the_days": half_the_days,
            "half_the_members": half_the_members, "no_work": no_work}
ELSEWHERE = {"no_exchange": (_no_exchange, ("regional",)),
             "unchanged_state": (_unchanged_state, ("fit",))}


def applicable(plan):
    """The faults that ``plan``'s cell can have."""
    kind = plan.traffic["kind"]
    return sorted(list(ON_ENTRY) + [f for f, (_, kinds) in ELSEWHERE.items()
                                    if kind in kinds])


@contextlib.contextmanager
def planted(fault, plan):
    """``fault`` planted under ``plan``'s timed path while the block
    runs."""
    if fault in ON_ENTRY:
        name, attr, series = plan.model.ENTRIES[plan.traffic["kind"]]
        module = importlib.import_module(name)
        replacement = ON_ENTRY[fault](getattr(module, attr), series)
    else:
        module, attr, replacement = ELSEWHERE[fault][0]()
    real = getattr(module, attr)
    setattr(module, attr, replacement)
    try:
        yield
    finally:
        setattr(module, attr, real)
