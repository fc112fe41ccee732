"""The control: the reference accepts the program's float64 answers and
rejects those of its float32 path (``control.py`` on the card at the cells'
size; here at a size the CPU holds)."""
import pytest
from conftest import run_tiny, tiny_config


@pytest.mark.parametrize("workload", ["thermal2.solve", "thermal2.service"])
def test_float64_passes_float32_fails(workload):
    # float32 reads 1.5e-6-2.2e-6 here against float64's ~9e-8
    ok = run_tiny(workload, seconds=3.0)
    assert ok["correct"], ok["checks"]
    low = run_tiny(workload, seconds=3.0, dtype="float32")
    assert not low["correct"]
    limit = tiny_config(workload)["limits"]["true_relres_max"]
    assert low["checks"]["true_relres_max"]["value"] > limit
