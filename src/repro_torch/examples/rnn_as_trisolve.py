"""The paper's idea beyond its domain: vectorizing an RNN recurrence (twin
of ``examples/rnn_as_trisolve.py``).

The RG-LRU recurrence  h_t = a_t * h_{t-1} + b_t  (RecurrentGemma) is the
forward substitution of a bidiagonal lower-triangular system

    L h = b,   L = I - shift(diag(a)).

A *single* chain admits no equivalent reordering (every edge fixes the
order: the ER condition pins the natural order), so HBMC cannot break the
sequential dependence -- the paper's technique is about *exploiting
existing independence*, not creating it.  But a batch of B independent
chains is exactly a B-block, one-color HBMC instance: the secondary
reordering interleaves the chains lane-major (b_s = T, w = B), turning T*B
scalar steps into T rounds of B-wide vector work -- with bit-exact results
(equivalent reordering).  Within a chain, the complementary trick is the
*associative scan* (O(log T) depth), here the doubling scan of the port's
RG-LRU layer (``repro_torch.models.rglru.doubling_scan``, PyTorch ops over
the same ``combine`` as the reference's ``jax.lax.associative_scan``).

    PYTHONPATH=src python -m repro_torch.examples.rnn_as_trisolve \
        [--device cpu]
"""
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..core.sell import pack_steps
from ..core.trisolve import DeviceTables, forward_solve
from ..kernels.config import resolve_device
from ..models.rglru import doubling_scan
from . import device_parser


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    args = device_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    B, T = 8, 512
    a = rng.uniform(0.5, 0.99, size=(B, T))   # gates
    b = rng.normal(size=(B, T))

    # --- reference: sequential recurrence, chain by chain ----------------
    t0 = time.perf_counter()
    h_seq = np.zeros((B, T))
    for i in range(B):
        h = 0.0
        for t in range(T):
            h = a[i, t] * h + b[i, t]
            h_seq[i, t] = h
    t_seq = time.perf_counter() - t0

    # --- HBMC view: B chains = B blocks of one color, w = B lanes --------
    # lane-major (round-major) order: index(t, i) = t*B + i
    n = B * T
    rows_sub = np.arange(1, T)[:, None] * B + np.arange(B)[None, :]
    cols_sub = rows_sub - B
    tri = sp.coo_matrix(
        (-a[:, 1:].T.ravel(), (rows_sub.ravel(), cols_sub.ravel())),
        shape=(n, n)).tocsr()
    diag = np.ones(n)
    rounds = [np.arange(t * B, (t + 1) * B) for t in range(T)]  # T rounds
    tables = pack_steps(tri, diag, rounds)
    dev = DeviceTables.from_host(tables, device=device)
    q = torch.tensor(b.T.ravel(), device=device)   # lane-major RHS
    h_hbmc = forward_solve(dev, q).cpu().numpy().reshape(T, B).T
    forward_solve(dev, q)                          # warm
    _sync(device)
    t0 = time.perf_counter()
    forward_solve(dev, q)
    _sync(device)
    t_hbmc = time.perf_counter() - t0

    # --- doubling scan (intra-chain parallelism) -------------------------
    at, bt = torch.tensor(a, device=device), torch.tensor(b, device=device)
    h_scan = doubling_scan(at, bt).cpu().numpy()
    _sync(device)
    t0 = time.perf_counter()
    doubling_scan(at, bt)
    _sync(device)
    t_scan = time.perf_counter() - t0

    err_hbmc = float(np.abs(h_hbmc - h_seq).max())
    err_scan = float(np.abs(h_scan - h_seq).max())
    print(f"B={B} chains, T={T} steps")
    print(f"sequential python       : {t_seq*1e3:8.2f} ms "
          f"({B*T} scalar steps)")
    print(f"HBMC lane-major solve   : {t_hbmc*1e3:8.2f} ms "
          f"({T} rounds x {B} lanes)  max|err| = {err_hbmc:.2e}")
    print(f"doubling scan           : {t_scan*1e3:8.2f} ms "
          f"(log2(T)={int(np.log2(T))} levels)   max|err| = {err_scan:.2e}")
    print("\nHBMC exposes *existing* independence (batch lanes) with exact "
          "equivalence; the associative scan creates intra-chain "
          "parallelism algebraically.  RecurrentGemma production code uses "
          "both (see repro_torch/models/rglru.py, whose prefill runs "
          "this doubling scan).")
    return dict(h_seq=h_seq, h_hbmc=h_hbmc, h_scan=h_scan,
                err_hbmc=err_hbmc, err_scan=err_scan, t_seq=t_seq,
                t_hbmc=t_hbmc, t_scan=t_scan)


if __name__ == "__main__":
    main()
