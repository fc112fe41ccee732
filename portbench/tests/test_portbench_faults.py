"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (one chip, so no exchange between chips to
leave out)."""
import numpy as np
import pytest
import torch
from conftest import ALL_CELLS, cell_of, run_tiny

from repro_torch.core import plan as plan_mod
from repro_torch.serve import solver as solver_mod

def _state_unchanged(monkeypatch):
    """The PCG loop returns its start state: x stays 0, status as
    reported."""
    real = plan_mod._pcg_device

    def broken(*args, **kw):
        x, it, relres, status, hist = real(*args, **kw)
        return torch.zeros_like(x), it, relres, status, hist
    monkeypatch.setattr(plan_mod, "_pcg_device", broken)


def _slab_state_unchanged(monkeypatch):
    """The slab step returns the state it was given."""
    def broken(self, state, rtol=1e-7, maxiter=10_000, quantum=16, **kw):
        return state, quantum
    monkeypatch.setattr(plan_mod.SolverPlan, "run_slab", broken)


def _answer_altered(monkeypatch):
    """One entry of each answer is changed where it is extracted."""
    real = plan_mod.SolverPlan._extract

    def broken(self, x_dev):
        x = real(self, x_dev).copy()
        x[x.shape[0] // 2] += 1e-3 * (np.abs(x).max() + 1.0)
        return x
    monkeypatch.setattr(plan_mod.SolverPlan, "_extract", broken)


def _half_the_slab_left_out(monkeypatch):
    """Requests packed into odd slots are left out of the slab: their
    column stays zero and retires as converged at x = 0."""
    real = solver_mod._SlabGroup.pack

    def broken(self, slot, req):
        real(self, slot, req)
        if slot % 2:
            self.state.r[:, slot] = 0.0
    monkeypatch.setattr(solver_mod._SlabGroup, "pack", broken)


SOLVE = [_state_unchanged, _answer_altered]
SERVICE = [_slab_state_unchanged, _answer_altered, _half_the_slab_left_out]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ALL_CELLS
    for f in {"solve": SOLVE, "service": SERVICE}[
        cell_of(w)["workload"]["traffic"]]])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    line = run_tiny(workload, seconds=1.5)
    assert not line["correct"], line["checks"]
