"""PyTorch port, the multi-process runtime (CPU, float64, gloo).

``initialize()`` in one process with nothing to join is a no-op that
reports one process, as JAX's is.  Two processes joined through a
``file://`` store, each with two CPU shards, span a mesh of four shards in
rank order; the shared evaluator runs each process's own shards and
gathers the rest, so a fused GR4J ``fit`` (DE seeded alike on both ranks)
and ``regional_gr4j_objective`` on a 2 x 2 (ensemble, catchment) mesh give
every rank the single-process four-shard result.  The two processes run
this file as a script, under a timeout, so that a hang fails the test
instead of stalling the run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

F64 = torch.float64
TIMEOUT = 120


def _fit_case():
    rng = np.random.default_rng(8)
    prec, etp = rng.uniform(0, 12, 60), rng.uniform(0, 4, 60)
    qobs = rng.uniform(0.5, 3, 60)
    qobs[::9] = np.nan
    return qobs, prec, etp


def _regional_case():
    from rrmpg_tpu_torch import interop

    rng = np.random.default_rng(4)
    qobs = rng.uniform(0, 5, (4, 80))
    qobs[1, 40:] = np.nan
    series = interop.regional_forcing_from_numpy(
        rng.uniform(0, 15, (4, 80)), rng.uniform(0, 4, (4, 80)), qobs,
        device='cpu', dtype=F64)
    params = {k: torch.as_tensor(rng.uniform(lo, hi, 6), dtype=F64)
              for k, (lo, hi) in zip(('x1', 'x2', 'x3', 'x4'),
                                     ((100, 1200), (-5, 3), (20, 300),
                                      (1.1, 2.9)))}
    return series, params


def _run(devices):
    """(fit population, fit energies, regional losses) on a 4-shard mesh
    built from this process's ``devices``."""
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.parallel import (default_mesh,
                                          ensemble_catchment_mesh,
                                          regional_gr4j_objective)

    mesh = default_mesh(devices)
    assert mesh.size == 4
    res = GR4J(device='cpu', dtype=F64).fit(
        *_fit_case(), engine='fused', seed=3, popsize=4, maxiter=3,
        mesh=mesh)
    series, params = _regional_case()
    losses = regional_gr4j_objective(
        *series, 0.3, 0.3, params, loss_metric='kge',
        mesh=ensemble_catchment_mesh(2, 2, devices=devices))
    return res.population, res.population_energies, losses.numpy()


def test_initialize_single_process_is_a_no_op():
    import torch.distributed as dist

    from rrmpg_tpu_torch.parallel import initialize

    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        rank, count, devices = initialize()
        assert (rank, count) == (0, 1) and devices >= 1
        assert not dist.is_initialized()
        assert initialize(num_processes=1)[:2] == (0, 1)
        assert not dist.is_initialized()
    finally:
        os.environ.update(env)


def test_initialize_with_a_coordinator_but_no_world_size_raises():
    """A coordinator is something to join: without a world size the call
    raises instead of running the whole job alone in every process."""
    import torch.distributed as dist

    from rrmpg_tpu_torch.parallel import initialize

    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        for address in ("localhost:12355", "file:///nonexistent/store"):
            with pytest.raises(ValueError, match="world size"):
                initialize(address)
        assert not dist.is_initialized()
    finally:
        os.environ.update(env)


def test_two_gloo_processes_equal_one_process(tmp_path):
    torch.set_num_threads(1)
    want = _run(['cpu'] * 4)
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(store),
         str(tmp_path / f"rank{rank}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the two gloo processes did not end in {TIMEOUT} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["population"], want[0])
        np.testing.assert_array_equal(got["energies"], want[1])
        np.testing.assert_array_equal(got["losses"], want[2])


def _worker(rank, store, out):
    """One of the two processes: two CPU shards of the four."""
    torch.set_num_threads(1)
    from rrmpg_tpu_torch.parallel import initialize

    assert initialize(f"file://{store}", num_processes=2, process_id=rank,
                      backend="gloo") == (rank, 2, 2)
    population, energies, losses = _run(['cpu'] * 2)
    np.savez(out, population=population, energies=energies, losses=losses)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
