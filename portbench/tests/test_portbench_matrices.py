"""The seeded generators at small sizes: the graph Laplacian bitwise the
port's generator, the P1 lattice equal to a plain assembly element by
element."""
import numpy as np
import pytest
from conftest import spec

from portbench.lib.rhs import seed_sequence
from repro_torch.core.matrices import graph_laplacian


def _same(a, b) -> bool:
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _lattice_by_elements(nx, ny, c):
    """The same operator assembled the plain way: a dense loop over every
    triangle of the extended grid, then the inner nodes' block."""
    side = nx + 2
    k = np.array([[2, -1, -1], [-1, 2, -1], [-1, -1, 2]]) / (2 * np.sqrt(3))
    full = np.zeros((side * (ny + 2), side * (ny + 2)))
    for j in range(ny + 1):
        for i in range(nx + 1):
            for t, tri in ((0, [(i, j), (i + 1, j), (i, j + 1)]),
                           (1, [(i + 1, j), (i + 1, j + 1), (i, j + 1)])):
                ids = [jj * side + ii for ii, jj in tri]
                full[np.ix_(ids, ids)] += c[t, j, i] * k
    inner = [j * side + i for j in range(1, ny + 1) for i in range(1, nx + 1)]
    return full[np.ix_(inner, inner)]


@pytest.mark.parametrize("nx,ny,seed", [(1, 1, 3), (7, 5, 2**40 + 3),
                                        (12, 12, -5)])
def test_fem2d_p1_lognormal_is_the_element_sum(nx, ny, seed):
    fam = spec.load_module("matrices", "fem2d_p1_lognormal")
    got = fam.make({"nx": nx, "ny": ny, "sigma": 1.0},
                   np.random.default_rng(seed_sequence(seed, 0)))
    c = fam.conductivity(nx, ny, 1.0,
                         np.random.default_rng(seed_sequence(seed, 0)))
    want = _lattice_by_elements(nx, ny, c)
    np.testing.assert_allclose(got.toarray(), want, rtol=1e-13, atol=1e-13)
    assert got.nnz == np.count_nonzero(want) == \
        nx * ny + 2 * ((nx - 1) * ny + nx * (ny - 1) + (nx - 1) * (ny - 1))
    assert np.linalg.eigvalsh(want).min() > 0


@pytest.mark.parametrize("n,seed", [(50, 0), (600, 9), (20_000, 2**35)])
def test_graph_laplacian_is_the_ports(n, seed):
    fam = spec.load_module("matrices", "graph_laplacian")
    got = fam.make({"n": n, "avg_degree": 4}, np.random.default_rng(seed))
    assert _same(got, graph_laplacian(n, 4, seed=seed))


@pytest.mark.parametrize("family,params", [
    ("fem2d_p1_lognormal", {"nx": 12, "ny": 9, "sigma": 1.0}),
    ("graph_laplacian", {"n": 300, "avg_degree": 4})])
def test_seed_makes_the_matrix(family, params):
    fam = spec.load_module("matrices", family)

    def make(seed):
        return fam.make(params, np.random.default_rng(seed_sequence(seed, 0)))
    assert _same(make(11), make(11))
    assert not _same(make(11), make(12))
    a = make(11)
    assert (a - a.T).nnz == 0 and a.has_canonical_format


def test_a_fixed_matrix_seed_holds_the_matrix():
    """Each configuration is one matrix for every run (its ``matrix.seed``),
    as its source is; the run's seed draws only the right-hand sides."""
    from conftest import tiny_config

    from portbench.lib.harness import make_matrix
    for workload in ("thermal2.solve", "g3_circuit.solve"):
        config = tiny_config(workload)
        assert _same(make_matrix(config, 1), make_matrix(config, 2))
        config["matrix"]["seed"] += 1
        assert not _same(make_matrix(config, 1), make_matrix(tiny_config(
            workload), 1))
