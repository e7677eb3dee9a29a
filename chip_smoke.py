#!/usr/bin/env python3
"""End-to-end smoke of the PyTorch port (``manisdp_tpu_torch``) on one
CUDA GPU.

    python3 chip_smoke.py [--gset DIR] [--bqp DIR] [--seed 0] [--out DIR]
                          [--phases 1-3,20-21]

Phases (each prints one line; a failed check raises and the exit code is
not 0):
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build kernels K1-K11 from ``manisdp_tpu_torch/csrc``;
  3. every K1 / K2 mode against its plain PyTorch twin on the card at the
     G67 shapes (n = 10^4, p_pad in {8, 24, 40, 48}, f64 and f32),
     with times;
  4. a G1-size solve (n = 800: dense cost, eigh certificate);
  5. the G67-size solve (n = 10^4: sparse cost through K1, f32 tCG,
     device LOBPCG certificate), with the kernels' launch counters and an
     independent KKT oracle (dense f64 eigvalsh of S on the card);
  6. K3, K4 (both orderings, with and without base / alpha, and
     ``colsum_pattern``) and K1's ``al_hess`` mode against their twins at
     the shapes of trace-min matrix completion at n = 12,000 (nnzP =
     9.0 M, m = 4.49 M, p_pad in {8, 16, 24}, f64 and f32; K3 also at
     p_pad 1, 33, 64, 130, with U = Y and with strided Y / U, and its
     32-B sectors per entry), each K3 / K4 call repeated bit for bit, with
     times;
  7. that matrix completion solved through ``solve_sdp`` (the primal AL
     on the factored constraint operator, f32 tCG, device LOBPCG
     certificate), with the launch counters and an independent KKT oracle
     on the card (A(YᵀY) from the raw SeDuMi triplets, f64 eigvalsh of the
     dense S = mat(c - Aᵀy), the duality gap);
  8. K5 (``apply``, ``aat``, ``axpy``), K4's ``scatter_pos`` mode and gather
     on the dense carrier (f64 and f32), and K6 (f64), against their twins
     at the shapes of matrix completion at n = 4,000 (m = 1.32 M), with
     times;
  9. that matrix completion through ``solve_sedumi`` on its default
     options (the entrywise carrier, kernel K5), with the same oracle;
 10. the same with ``al_op_mode="dense"`` (the dense carrier, K4
     ``scatter_pos``), which must reach phase 9's objective;
 11. the same with ``cert_method="dense_eigh"`` (f32 eigh + K6
     refinement), with its tier counts and one plain f64 eigh of the final
     S for comparison;
 12. the dual path's kernels against their twins, f64 and f32: K7 and
     K8 (``adjoint``, ``sym_mat``, ``sym_factor`` at p_pad 8 / 64 / 192)
     at the BQP SOS dual's expanded shape q = 60 (n~ = 3,662), K2 ``proj``
     with the Hessian's eG term, K11 without the projection at phase 15's
     tCG shapes (1 x 8 / 48 x 496), K4 on the q = 60 original-basis DualOp
     (n = 1,831, m = 523,686; its row-length profile on a line first), on
     the d = 30 quartic-sphere iAB pair and on skewed rows (one row of
     10^5 entries among 10^6 rows of one; half the rows empty;
     scatter_pos with a 10^5-entry row), each repeated bit for bit;
 13. the BQP SOS dual through ``solve_bqp_sos_dual`` (the expanded-basis
     SymDualOp: K7, K8, K2, and the compressed dense certificate, K6) at
     q = 30 against the JAX package's optimum, then at q = 60 with
     bench.py's settings, with an oracle (f64 eigvalsh of the returned X
     on the card; the bound below 100,000 seeded +-1 points), launch
     counts, peak memory and one ``torch.profiler`` breakdown;
 14. the same instances in the original basis through
     ``solve_dual_unitdiag`` (the DualOp on K4, devrr certificate at
     q = 60), with an oracle from the raw SeDuMi triplets;
 15. the quartic over the sphere at d = 30 through ``solve_dual_sdp`` (the
     general variant with iAB on K4), against the JAX package's optimum;
 16. the primal moment path's kernels against their twins, f64 and f32:
     K9 and K10 (plain and with the fused es_vals base) at the BQP q = 60
     expanded shape (n~ = 3,662, flat m = 13.4 M), and K2's masked mode
     (proj, proj with the eG term, retr, renormalize) at the clique
     chain's (p_pad, N = 4,220) shapes;
 17. the BQP moment primal through ``solve_bqp_mom`` (SymMomOp: K9, K10,
     K8 ``sym_factor``, the compressed dense certificate) at q = 30 against
     the JAX package's optimum, then at q = 60 with bench.py's
     bench_bqp_primal settings, held to phase 13's q = 60 SOS dual
     objective, with an on-card KKT oracle from the raw
     frontends/moments.bqpmom triplets and one ``torch.profiler``
     breakdown;
 18. examples/example_bqp_sparse.py's clique chain (t = 20 cliques of 20
     variables, 20 blocks of 211) through ``solve_multiblock`` (K3, K4, K1
     ``al_hess``, K2 masked) with a block-diagonal on-card KKT oracle, and
     its SOS dual through ``solve_dual_multiblock`` (K4, K2 masked); the
     two objectives must agree;
 19. ``solve_sedumi`` on a two-block input (a quartic over two spheres
     that share one variable: two moment blocks of 66), held to the
     optimum of its SOS dual through ``solve_dual_multiblock``;
 20. the batched MaxCut path's kernels against their twins: K1's instance
     mode (``plain``, ``cost``, ``hess``; library: one ``torch.sparse.mm``
     of the block-diagonal CSR) and K2 with the instance stride at the
     sparse batch's shape (8 instances, n_pad = 3,072, p_pad in {40, 48},
     f64), and K11, the tCG vector step, in f64 and f32 there and at
     B = 1 with the G67 shape;
 21. ``solve_maxcut_batch`` (p0 = 40, as phases 4-5) on 16 G1-size
     stand-ins (one dense bucket of 1,024) and on 8 toroidal +-1 grids of
     G48's shape (60 x 50) with 4 of 50 x 50 (sparse buckets of 3,072 and
     2,560, K1's instance mode): every instance at status 0 with an
     on-card KKT oracle and within 1e-6 of its single-instance solve; the
     sparse batch solved twice must give bit-equal results;
 22. the clique chain at t = 5 through ``solve_multiblock`` twice: equal
     histories (no float atomics in its reductions);
 23. the options that run whole solves or LOBPCG stages in float32, each
     held to the objective of the path without them (phase 5, 7, 9, 13 or
     22's, or solved here when that phase did not run) and to that
     phase's on-card oracle, with the f32 launches of every kernel: the
     G67 stand-in with ``inner_dtype="mixed"`` and with
     ``cert_method="lobpcg", cert_pre_dtype="float32"`` (1e-7);
     mc-12000 through ``solve_sdp`` with ``inner_dtype="mixed"``; mc-4000
     through ``solve_sedumi`` with ``cert_method="rowrr"`` (its f32
     LOBPCG stage at ``cert_pre_dtype="auto"``); bqp-q60 expanded with
     ``inner_dtype="mixed"``; bqp-q60 in the original basis with rowrr and
     with lobpcg plus the f32 stage (1e-6); the chain at t = 5 through
     both multiblock drivers with ``inner_dtype="mixed"`` (primal and dual
     within 1e-6).  The LOBPCG solves also time one certificate call at
     their final point with the f32 stage and without it, with both
     stages' iteration counts;
 24. the sharded paths (``parallel/``), each rank a process started by
     ``parallel.spawn_ranks``: mc-12000 (phase 7's instance and options)
     through ``solve_sdp(mesh=)`` over the constraint operator sharded by
     pattern id (K3 / K4 / K1 per shard, K1 / K3 on the shard's columns,
     the column blocks joined by all-gathers, true sums all-reduced) on
     NCCL at world size 1 (24a), then on gloo at world size 2 with both
     ranks on
     card 0 (24b; first each shard's apply_factored, adjoint_on_pattern,
     matmat_pattern, matvec_pattern and AL Hessian against the unsharded
     operator's, and each shard's K3 / K4 / K1 against its plain twin at
     the shard's shapes, 1e-12 f64 / 1e-5 f32), each at status 0 with
     the on-card oracle <= 1e-8, within 1e-6 of phase 7's (24a) and
     24a's (24b) objective, every rank bit-equal and launching K1, K3, K4
     and K11 (at world 2 K1 and K3 on its columns); before the spawns,
     each world-2 and world-4 piece's K1 ``al_hess`` / ``plain`` and K3
     built and timed in this process beside the whole pattern's and the
     twins (``piece_times``);
     phase 21's sparse batch through ``solve_maxcut_batch(mesh=)`` over a
     2-rank batch axis on gloo (24c), every instance within 1e-6 of phase
     21's; with two or more cards, 24a again on NCCL across min(4, cards)
     cards (24d; otherwise one line says why it did not run).  Gloo
     stages CUDA all-reduces through the host, so its times are labelled
     host-staged;
 25. the row-sharded SOS-dual operator and the model-sharded MaxCut RTR
     (slice 6b; K7 / K8 row-block modes, K11 peer and split modes): at
     world 1 on
     NCCL (one spawn), ShardedSymDualOp at q = 120 (n~ = 14,522): apply,
     adjoint and apply -> scale by idAAt -> adjoint of a seeded symmetric
     M and tuple y, held to the single-card K7 / K8 (1e-12 f64, 1e-5
     f32) and each row-block mode to its plain twin on the card, with
     times, each launch's ms, the full-mode K7's ms, K7's library
     yardstick (index_add_ of M at the sorted-index class map, within
     1e-13) and the collectives' ms (25a; no all-to-all at one rank); the
     apply at q = 180 in f64 (n~ = 32,582: its q x (q + 1) slab would
     exceed a block's shared memory) held to index_add_'s class sums
     within 1e-13, its ms beside its bound and its peak memory (25f); the
     G67-size
     dense MaxCut (the stand-in's cost as a dense 10^4 x 10^4 f64 C, p =
     40, a seeded Oblique.rand start, JAX's default TROptions) through
     sharded_maxcut_solve, K11 in its peer mode (the group's choice on
     NCCL) and again in its split mode, each bit-equal to the single-card
     RTR (fx, Y, TR and tCG counts), and K11's peer and split modes at its
     tCG shape bit-equal to each other and to the one launch, each timed
     beside its bound (25c); then over 2 gloo ranks on card 0 (one spawn)
     the operator at q = 60 (25b) and the RTR in K11's split mode (fx
     within 1e-12, Y within 1e-10, equal counts; 25c; also K11's peer
     mode between the two processes at the rank's shape, bit-equal to the
     split mode, host-timed), every rank's replicated outputs
     bit-equal;
     phase 21's 16 dense G1-size stand-ins through
     batched_sharded_maxcut_solve on a (2, 2) (batch, model) mesh of 4
     gloo ranks on card 0, every instance held to the single-card batched
     RTR (25d); with two or more cards, 25a and 25c on NCCL across min(4,
     cards) cards, the RTR in K11's peer mode where every pair of the
     cards has peer access and again in split mode, both held to the
     single card, K11's two modes timed side by side at the rank's shape
     (25e; otherwise one line says why it did not run).
``--phases`` selects phases (default all; 1-2 always run).  A phase runs
with the rest of its group (3 | 4 | 5 | 6-7 | 8-11 | 12-15 | 16-19 |
20 | 21 | 22 | 23 | 24 | 25), and 16-19 bring 12-15 (phase 17 reads phase
13's objective); the ``kernels`` line lists the kernels whose phases ran
(with phase 23, each kernel's f32 launches there; with phase 24, rank
0's launches in 24b of the row's kernel, or of its mode where the mode
has a counter of its own).
The host builds of phases 17-18's SeDuMi data (numpy, about a minute
each) and of phases 22-23's chain run in worker processes started with
the script.  Phases 9-11, 13-15, 17-19, 21 and 23 report peak device
memory.
Every kernel case carries its time, its plain twin's, the least time the
card could take (``bound_ms``: bytes at 3.35 TB/s or operations at the
dtype's peak) and the time of one PyTorch library call computing the same
function where there is one (``library_ms``).  Then one ``{"kernels": [...]}`` line and,
last, the result line ``{"ok": true, "device": {...}}``.

``--capture-stall`` (phase 7) records the devrr certificate's calls,
saves the first converged point it cannot certify to
build/mc12000_stall/ and re-runs the certificate there under other
budgets beside a dense eigvalsh (ROADMAP Queue C).

``--gset DIR`` reads G1.txt / G67.txt from a Gset directory and ``--bqp
DIR`` bqp_Q_60_1.txt / bqp_e_60_1.txt (and the q = 30 files); without them
(or when a file is missing) seeded stand-ins of the same shape are used
and labelled so.  The full record (every timing, both solves) goes to
``chip_smoke.json`` in ``--out`` (default ``build/chip_smoke``).
It needs one CUDA device and exits with an error without one.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# factor widths of phase 3: the G67 solve runs its tCG at p_pad = 40
# (p0 = 40) and its certificate on blocks of 24 rows; 8 and 48 bracket
# the rank buckets
P_PADS = (8, 24, 40, 48)
HOT_P_PAD = 40
# trace-min matrix completion at n = 12,000, the reference construction
# (example_matrixcompletion.m; bench.py bench_mc at p = 6000); the AL's
# rank ramp keeps p_pad in {8, 16, 24}
MC = dict(p=6000, q=6000, rank=10, m_samples=4_800_000, seed=3)
AL_P_PADS = (8, 16, 24)
AL_HOT_P_PAD = 16
# matrix completion at n = 4,000 (bench.py bench_mc(2000), the JAX bench's
# mc_n4000 row, uncut): below the entrywise and dense carriers' limits
MC4 = dict(p=2000, q=2000, rank=10, m_samples=1_600_000, seed=3)
# the BQP SOS dual (bench.py:176-199: the stand-in construction and the
# settings of its bqp_q60_dual row) and the quartic over the sphere
# (examples/example_qsphere.py:23-37)
BQP_Q = 60
BQP_KW = dict(line_search=True, inner_dtype="tcg32", p_bucket=192)
QS_D = 30
# its moment side (the monomials of degree <= 2 in QS_D variables) and
# the solve's options; its tCG runs on the Euclidean manifold at (1,
# p_pad, QS_N), p_pad 8 ... 48, so K11 steps without the projection
QS_N = (QS_D + 1) * (QS_D + 2) // 2
QS_KW = dict(theta=1e-1, tau2=0.5)
# the BQP moment primal with bench_bqp_primal's settings (bench.py:202-218)
# and examples/example_bqp_sparse.py's chain: t cliques of CHAIN_Q
# variables overlapping by 2, and its primal options; phase 19's sparse
# quartic over two spheres (two cliques of QS2_K variables sharing one)
# with tests/test_sparse_quartic.py's options
BQP_PRIMAL_KW = dict(inner_dtype="tcg32", p_bucket=192)
CHAIN_T, CHAIN_Q = 20, 20
CHAIN_PRIMAL_KW = dict(line_search=True, tau1=1.0)
QS2_K = 10
QS2_PRIMAL_KW = dict(theta=1e-2, tau1=0.02, tau2=0.1, sigma0=1e-2,
                     sigma_min=1e-1, line_search=True, max_outer=1000)
QS2_DUAL_KW = dict(gama=2.0, alpha=0.01, sigma0=1e-2, theta=1e-2, delta=6,
                   max_outer=1000)
# the batched MaxCut path (phases 20-21): a dense bucket of G1-size
# stand-ins and a sparse, ragged one of toroidal grids of G48's shape
# (60 x 50) and of 50 x 50; K1 / K2 / K11 are checked at the first
# sparse bucket's shape, p_pad in {40, 48} (p0 = 40 and its first growth)
BATCH_DENSE = 16
BATCH_GRID, BATCH_GRID_B = (60, 50), 8
BATCH_GRID2, BATCH_GRID2_B = (50, 50), 4
BATCH_N_PAD = 3072
BATCH_P_PADS = (40, 48)
# phase 22: a short clique chain solved twice (the determinism check)
CHAIN5_T = 5
# phase 24 (the sharded paths): its ranks on gloo share card 0, its NCCL
# runs put one rank on each of up to SHARD_NCCL_MAX cards; the protocol
# checks' inputs are SHARD_P x n factors, an n x SHARD_K block and sigma
SHARD_GLOO_WORLD = 2
SHARD_NCCL_MAX = 4
SHARD_P, SHARD_K, SHARD_SIGMA = AL_HOT_P_PAD, 11, 0.37
# the world sizes whose pieces phase 24 times in the main process
SHARD_PIECE_WORLDS = (2, 4)
# phase 25 (slice 6b): the row-sharded SOS-dual operator at q = 120 on
# NCCL (25a, 25e) and q = 60 over gloo ranks on card 0 (25b); the G67-size
# dense MaxCut RTR column-sharded at p = 40 (25c, 25e); the batch of
# phase 21's 16 dense G1-size stand-ins on a (2, 2) (batch, model) mesh of
# gloo ranks on card 0 (25d); the operator at q = 180 on NCCL at world 1
# (25f), where the f64 q x (q + 1) slab would exceed a block's 232,448
# bytes of shared memory
SYMDUAL_NCCL_Q, SYMDUAL_GLOO_Q, SYMDUAL_BIG_Q = 120, 60, 180
MAXCUT_SHARD_P = 40
BATCH_SHARD_MESH = (2, 2)
# the phases and their groups: a phase runs with the rest of its group;
# 16-19 read phase 13's SOS-dual objective; 23 reads the objectives of 5,
# 7, 9, 13 and 22 where they ran (and solves them itself where not), 24
# those of 7 and 21
LAST_PHASE = 25
GROUPS = ((3,), (4,), (5,), (6, 7), (8, 9, 10, 11), (12, 13, 14, 15),
          (16, 17, 18, 19), (20,), (21,), (22,), (23,), (24,), (25,))
NEEDS = {16: (12,)}
# the JAX package's optima on the CPU (f64), the values the port is held to
JAX_BQP30 = -154.7359587770444
JAX_QS30 = -7.324338872437511
JAX_BQPMOM30 = -154.73595877704594
# phase 12's skewed CSR cases for K4: one row of 10^5 entries among 10^6
# rows of one, half the rows empty, and scatter_pos with a 10^5-entry row
SKEW_ROWS, SKEW_LONG = 1_000_000, 100_000
# K3's extra factor widths (phase 6): below a vector, odd, and beyond one
# chunk of 64 vectors in f64
K3_EXTRA_P = (1, 33, 64, 130)
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
# FLOP/s outside the tensor cores (f64 34 T, f32 67 T)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def laplacian_cost(n, i, j, w):
    """C = -L/4 of the graph with edges (i, j, w): the MaxCut SDP cost."""
    import scipy.sparse as sp
    W = sp.coo_matrix((np.r_[w, w], (np.r_[i, j], np.r_[j, i])),
                      shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    return (-0.25) * (sp.diags(deg) - W).tocsr()


def g1_standin(seed):
    """Erdos-Renyi graph of G1's size: n = 800, 19,176 unit edges."""
    n, m = 800, 19176
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    pick = rng.choice(iu.size, size=m, replace=False)
    return laplacian_cost(n, iu[pick], ju[pick], np.ones(m))


def torus_standin(rows, cols, seed):
    """rows x cols toroidal grid with seeded +-1 weights (the Gset toroidal
    graphs' construction): n = rows * cols, 2n edges."""
    a, b = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    v = (a * cols + b).ravel()
    right = (a * cols + (b + 1) % cols).ravel()
    down = (((a + 1) % rows) * cols + b).ravel()
    i = np.r_[v, v]
    j = np.r_[right, down]
    w = np.random.default_rng(seed + 1).choice([-1.0, 1.0], size=i.size)
    return laplacian_cost(rows * cols, i, j, w)


def g67_standin(seed):
    """100 x 100 toroidal grid with +-1 weights, G67's shape: n = 10^4,
    20,000 edges."""
    return torus_standin(100, 100, seed)


def load_graph(name, gset_dir, seed):
    from manisdp_tpu_torch.frontends.gset import load_gset_laplacian
    path = os.path.join(gset_dir, f"{name}.txt") if gset_dir else None
    if path and os.path.exists(path):
        return (-0.25) * load_gset_laplacian(path), f"Gset {name}"
    make = g1_standin if name == "G1" else g67_standin
    return make(seed), f"seeded stand-in for {name} (seed {seed})"


def time_ms(fn, reps=25, warm=3):
    """Median device milliseconds of one call, from CUDA events around
    it.  A spin kernel holds the stream while the host enqueues the call,
    so its launches run back to back and the events time the device work
    rather than the host's launch overhead."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)        # ~1 ms at H100 clocks
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def max_err(got, ref, per_output=False):
    """The largest absolute error and the relative error: against the
    largest reference entry of all outputs, or (``per_output``) the
    largest of each output's own relative error."""
    import torch
    if isinstance(ref, tuple):
        pairs = list(zip(got, ref))
    else:
        pairs = [(got, ref)]
    errs = [float(torch.max(torch.abs(g - r))) for g, r in pairs]
    scales = [max(float(torch.max(torch.abs(r))), 1e-300) for _, r in pairs]
    if per_output:
        return max(errs), max(e / s for e, s in zip(errs, scales))
    return max(errs), max(errs) / max(scales)


def kkt_oracle_on_card(C_sp, res, device):
    """Independent KKT check on the card: diag(X) = 1, lambda_min of the
    dense S = C - diag(z) by f64 eigvalsh, and complementarity
    <C,X> = sum(z), computed from the returned factor alone."""
    import torch
    Y = torch.as_tensor(res.Y, dtype=torch.float64, device=device)
    C = torch.as_tensor(C_sp.toarray(), dtype=torch.float64, device=device)
    X = Y.T @ Y
    pinf = float(torch.max(torch.abs(torch.diagonal(X) - 1.0)))
    z = torch.sum(C * X, dim=0)
    S = C - torch.diag(z)
    del X
    w = torch.linalg.eigvalsh(S)
    dinf = max(0.0, -float(w[0])) / (1.0 + float(w[-1]))
    obj = float(torch.sum(z))
    comp = abs(res.obj - obj) / (1.0 + abs(obj))
    return dict(pinf=pinf, dinf=dinf, comp=comp,
                eta=max(pinf, dinf, comp), lam_min=float(w[0]))


def worst_errors(rows):
    """The largest absolute and relative error of each kernel's rows."""
    worst = {}
    for r in rows:
        w = worst.setdefault(r["kernel"], dict(max_abs_err=0.0, rel_err=0.0))
        w["max_abs_err"] = max(w["max_abs_err"], r["max_abs_err"])
        w["rel_err"] = max(w["rel_err"], r["rel_err"])
    return worst


def nbytes(*items):
    """Bytes of the given tensors; an int item is a byte count."""
    return sum(t if isinstance(t, int) else t.numel() * t.element_size()
               for t in items if t is not None)


def gathered(x, col):
    """Bytes a gather of x at ``col`` must read: at most one read of each
    of x's entries, at most one per index."""
    return min(x.numel(), col.numel()) * x.element_size()


def bound(bytes_, flops, dtype):
    """The least time (ms) the card could take: the larger of the bytes at
    the HBM rate and the operations at the dtype's peak, and which."""
    tb = bytes_ / PEAK_BYTES
    tf = flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def csr(ptr, col, val, shape):
    """A torch CSR tensor on the same arrays (the library yardstick)."""
    import torch
    return torch.sparse_csr_tensor(ptr, col, val, size=shape)


def pass_times(fn, reps=20):
    """Device ms per call of each kernel that ``fn()`` launches, by kernel
    name: torch.profiler over ``reps`` calls after a warm one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.self_device_time_total:
            continue
        name = re.search(r"(\w+)(<[^(]*>)?\(", evt.key)
        name = name.group(1) if name else evt.key[:60]
        out[name] = out.get(name, 0.0) + evt.self_device_time_total / reps / 1e3
    return out


def check_case(rows, name, mode, fn, twin, args, kw, tol, reads=(),
               flops=0.0, library=None, fresh=None, per_output=False,
               repeat=False, scale=None, passes=False, **info):
    """One kernel call against its twin on the same inputs, timed, with
    its bound (``reads``: the input tensors the function must read once;
    its outputs are written once) and the time of ``library``, one
    PyTorch call computing the same function (None where there is none;
    a call the installed PyTorch refuses is recorded as null with the
    error).  ``fresh()``, for a kernel that updates its inputs in place:
    new copies of ``args`` for the kernel's and the twin's checked calls
    (the timed repeats then run on drifting values).  ``per_output``:
    each output's error relative to its own scale (max_err).  ``repeat``:
    a second kernel call on the same inputs (new copies from ``fresh()``
    where given) must give the same bits.
    ``scale``: per-entry error scales (a sum's sum of absolute terms) for
    the relative error, in place of the largest reference entry.
    ``passes``: also each launch's device time (pass_times).  A NaN in
    the kernel's output fails the case."""
    import torch
    got = fn(*(fresh() if fresh else args), **kw)
    ref = twin(*(fresh() if fresh else args), **kw)
    again = fn(*(fresh() if fresh else args), **kw) if repeat else None
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(got, ref, per_output)
    if scale is not None:
        rel_err = float(torch.max(torch.abs(got - ref).double() / scale))
    outs = got if isinstance(got, tuple) else (got,)
    b_ms, b_by = bound(nbytes(*reads, *outs), flops, info["dtype"])
    row = dict(kernel=name, mode=mode, **info, max_abs_err=abs_err,
               rel_err=rel_err, tol=tol,
               ms=time_ms(lambda: fn(*args, **kw)),
               plain_ms=time_ms(lambda: twin(*args, **kw)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    if repeat:
        again = again if isinstance(again, tuple) else (again,)
        row["bit_equal"] = all(torch.equal(g, a) for g, a in zip(outs, again))
    if passes:
        row["passes_ms"] = pass_times(lambda: fn(*args, **kw))
    row["nan_free"] = not any(bool(torch.any(torch.isnan(g))) for g in outs)
    if library is not None:
        try:
            row["library_ms"] = time_ms(library)
        except (RuntimeError, NotImplementedError, TypeError) as err:
            row["library_error"] = str(err).splitlines()[0][:200]
    rows.append(row)
    if not (rel_err <= tol and row["nan_free"]):
        raise AssertionError(f"kernel disagrees with its twin: {row}")
    if repeat and not row["bit_equal"]:
        raise AssertionError(f"a repeated call changed the bits: {row}")


def row_profile(ptr):
    """Row-length profile of a CSR pointer (host numpy): rows, entries,
    longest and mean row, the commonest lengths, K4's plan
    (csr_gather_plan) and the rows it hands to a warp each."""
    from manisdp_tpu_torch import kernels as K
    lens = np.diff(ptr.cpu().numpy().astype(np.int64))
    nnz, nrows = int(lens.sum()), int(lens.size)
    lengths, counts = np.unique(lens, return_counts=True)
    top = np.argsort(counts)[::-1][:4]
    plan = K.csr_gather_plan(nnz, nrows)
    return dict(rows=nrows, nnz=nnz, max=int(lens.max(initial=0)),
                mean=nnz / max(nrows, 1), empty=int(np.sum(lens == 0)),
                most_common={int(lengths[i]): int(counts[i]) for i in top},
                plan=plan, long_rows=0 if plan == 2 else
                int(np.sum(lens > K.CSR_LONG_ROW)))


def phase_kernels(C_sp, device, seed):
    """Every K1 / K2 mode against its twin at the G67 shapes."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.sparse import SymCOO

    C64 = SymCOO.from_scipy(C_sp, device)
    n = C64.n
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    for dt in (torch.float64, torch.float32):
        C = C64.astype(dt)
        Ccsr = csr(C.colptr, C.i, C.v, (n, n))     # C symmetric: CSR = CSC
        Cr = (C.i, C.colptr, C.v)
        for p in P_PADS:
            rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                         dtype=torch.float64,
                                         device=device).to(dt)
            Y = K.oblique_cols_plain(rnd(p, n), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n), "proj")
            z = rnd(n)
            eG = K.symcoo_spmm_plain(Y, C, "cost")[1]
            V = rnd(n, 9)       # matvec_block's (n, k) block, K1 on V.T
            Yu = Y + U
            fl = 2.0 * C.nnz * p
            cases = [
                ("symcoo_spmm", "plain", (Y, C, "plain"), {}, (Y, *Cr), fl,
                 lambda: Ccsr @ Y.T),
                ("symcoo_spmm", "shift", (Y, C, "shift"), dict(z=z),
                 (Y, *Cr, z), fl + 2 * p * n, None),
                ("symcoo_spmm", "cost", (Y, C, "cost"), {}, (Y, *Cr),
                 fl + 2 * p * n, None),
                ("symcoo_spmm", "hess", (U, C, "hess"), dict(B=Y, eG=eG),
                 (U, *Cr, Y, eG), fl + 6 * p * n, None),
                ("symcoo_spmm", "plain_strided", (V.T, C, "plain"), {},
                 (V, *Cr), 18.0 * C.nnz, lambda: Ccsr @ V),
                ("oblique_cols", "proj", (Y, U, "proj"), {}, (Y, U),
                 4 * p * n, None),
                ("oblique_cols", "proj_eG", (Y, U, "proj"),
                 dict(v=Yu, g=z), (Y, U, Yu, z), 6 * p * n, None),
                ("oblique_cols", "retr", (Y, U, "retr"), {}, (Y, U),
                 5 * p * n, None),
                ("oblique_cols", "renormalize", (Yu, None, "renormalize"),
                 {}, (Yu,), 3 * p * n, None),
            ]
            for name, mode, args, kw, reads, flops, lib in cases:
                k1 = name == "symcoo_spmm"
                check_case(rows, name, mode, getattr(K, name),
                           getattr(K, f"{name}_plain"), args, kw, tol[dt],
                           reads=reads, flops=flops, library=lib,
                           repeat=True, passes=k1, dtype=str(dt)[6:],
                           p_pad=p, n=n, nnz=C.nnz)
    return rows


def mc_instance(spec):
    """The matrix completion of ``spec`` (SeDuMi data) and its build
    seconds."""
    from manisdp_tpu_torch.frontends.workloads import matrix_completion
    t0 = time.perf_counter()
    data, _ = matrix_completion(spec["p"], spec["q"], rank=spec["rank"],
                                m_samples=spec["m_samples"],
                                seed=spec["seed"])
    return data, time.perf_counter() - t0


def phase_al_kernels(op64, device, seed):
    """K3, K4 and K1 al_hess against their twins at the matrix-completion
    shapes."""
    import torch
    from manisdp_tpu_torch import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, m = op64.n, op64.m
    sigma = 0.37
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    for dt in (torch.float64, torch.float32):
        op = op64.astype(dt)
        rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                     dtype=torch.float64,
                                     device=device).to(dt)
        info = dict(dtype=str(dt)[6:], n=n, m=m, nnzP=op.pat.nnz,
                    nnzA=op.nnz)
        e, w = rnd(op.pat.nnz), rnd(m)
        nP = op.pat.nnz
        A_k = csr(op.krow_ptr, op.a2p, op.v, (m, nP))
        A_p = csr(op.pat_ptr, op.kp, op.vp, (nP, m))
        # K4 does not depend on p: once per dtype, both orderings
        k4 = [("apply_from_e", (e, op.krow_ptr, op.a2p, op.v), {},
               lambda: A_k @ e),
              ("adjoint_on_pattern", (w, op.pat_ptr, op.kp, op.vp), {},
               lambda: A_p @ w),
              ("es_vals", (w, op.pat_ptr, op.kp, op.vp),
               dict(base=op.pat.v, alpha=sigma),
               lambda: torch.addmv(op.pat.v, A_p, w, alpha=sigma)),
              ("s_vals", (w, op.pat_ptr, op.kp, op.vp),
               dict(base=op.pat.v, alpha=-1.0),
               lambda: torch.addmv(op.pat.v, A_p, w, alpha=-1.0))]
        # ConstraintOp.colsum_pattern: rows = pattern columns (~750 entries)
        sv, ones = rnd(nP), torch.ones(n, dtype=dt, device=device)
        P_cols = csr(op.pat.colptr, op.pat.i, sv, (n, n))
        k4.append(("colsum_pattern", (ones, op.pat.colptr, op.pat.i, sv),
                   {}, lambda: P_cols @ ones))
        for mode, args, kw, lib in k4:
            check_case(rows, "csr_gather", mode, K.csr_gather,
                       K.csr_gather_plain, args, kw, tol[dt],
                       reads=(gathered(args[0], args[2]), *args[1:],
                              kw.get("base")), flops=2.0 * args[2].numel(),
                       library=lib, repeat=True, p_pad=None,
                       rows_profile=row_profile(args[1]), **info)
        del P_cols
        es = K.csr_gather_plain(w, op.pat_ptr, op.kp, op.vp, base=op.pat.v,
                                alpha=sigma)
        ayu = K.csr_gather_plain(rnd(m), op.pat_ptr, op.kp, op.vp)
        Pz = csr(op.pat.colptr, op.pat.i, torch.zeros_like(op.pat.v),
                 (n, n))
        Pr = (op.pat.i, op.pat.colptr)
        def sectors(p):
            """32-B sectors one entry's gather touches: N-major (the
            kernel's (n, pp) copy) and p-major (the (p, n) factor)."""
            pp, _ = K.pattern_dots_layout(p, dt)
            return dict(n_major=-(-pp * op.pat.v.element_size() // 32),
                        p_major=p)

        for p in K3_EXTRA_P:
            # K3 alone at other widths, U = Y, and strided Y / U
            Y = K.oblique_cols_plain(rnd(p, n), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n), "proj")
            check_case(rows, "pattern_dots", "pair_dots", K.pattern_dots,
                       K.pattern_dots_plain, (Y, U, op.pat), {}, tol[dt],
                       reads=(Y, U, *Pr), flops=2.0 * nP * p,
                       library=lambda Y=Y, U=U: torch.sparse.sampled_addmm(
                           Pz, U.T.contiguous(), Y, beta=0.0),
                       repeat=True, p_pad=p, sectors=sectors(p), **info)
        for p in AL_P_PADS:
            Y = K.oblique_cols_plain(rnd(p, n), None, "renormalize")
            U = K.oblique_cols_plain(Y, rnd(p, n), "proj")
            YeG = rnd(n)
            hess = dict(vals=es, B=Y, vals2=ayu, coefs=(2.0, 4.0 * sigma))
            # e_k = <Y[:, i_k], U[:, j_k]> = (U^T Y)[j_k, i_k]: the pattern
            # in CSR by column j is the sampling mask
            sddmm = lambda Y=Y, U=U: torch.sparse.sampled_addmm(  # noqa: E731
                Pz, U.T.contiguous(), Y, beta=0.0)
            # a transposed Y and a column-strided U (non-contiguous views)
            Ys = Y.T.contiguous().T
            Us = torch.zeros((p, 2 * n), dtype=dt, device=device)[:, ::2]
            Us.copy_(U)
            for name, mode, args, kw, reads, flops, lib in (
                    ("pattern_dots", "pair_dots", (Y, U, op.pat), {},
                     (Y, U, *Pr), 2.0 * nP * p, sddmm),
                    ("pattern_dots", "pair_dots_u_is_y", (Y, Y, op.pat), {},
                     (Y, *Pr), 2.0 * nP * p,
                     lambda Y=Y: torch.sparse.sampled_addmm(
                         Pz, Y.T.contiguous(), Y, beta=0.0)),
                    ("pattern_dots", "pair_dots_strided", (Ys, Us, op.pat),
                     {}, (Ys, Us, *Pr), 2.0 * nP * p,
                     lambda Ys=Ys, Us=Us: torch.sparse.sampled_addmm(
                         Pz, Us.T.contiguous(), Ys.contiguous(),
                         beta=0.0)),
                    ("symcoo_spmm", "al_hess", (U, op.pat, "al_hess"),
                     hess, (U, *Pr, es, Y, ayu), 4.0 * nP * p, None),
                    ("symcoo_spmm", "al_hess_diag", (U, op.pat, "al_hess"),
                     dict(hess, eG=YeG), (U, *Pr, es, Y, ayu, YeG),
                     4.0 * nP * p + 6 * p * n, None)):
                k3 = name == "pattern_dots"
                check_case(rows, name, mode, getattr(K, name),
                           getattr(K, f"{name}_plain"), args, kw, tol[dt],
                           reads=reads, flops=flops, library=lib,
                           repeat=True, passes=not k3, p_pad=p,
                           **(dict(sectors=sectors(p)) if k3 else {}),
                           **info)
    return rows


def al_kkt_oracle_on_card(data, res, device):
    """Independent KKT check of a general-variant solve on the card, from
    the raw SeDuMi triplets and the returned (Y, y) alone: pinf from
    A(YᵀY), dinf from f64 eigvalsh of the dense S = mat(c - Aᵀy), gap from
    <C, X> and bᵀy.  No ConstraintOp and no kernel is used."""
    import torch
    t0 = time.perf_counter()
    n = int(data.K.s)
    At = data.At.tocoo()
    f64 = dict(dtype=torch.float64, device=device)
    lin = torch.as_tensor(At.row.astype(np.int64), device=device)
    k = torch.as_tensor(At.col.astype(np.int64), device=device)
    v = torch.as_tensor(At.data, **f64)
    Y = torch.as_tensor(res.Y, **f64)
    y = torch.as_tensor(res.y, **f64)
    b = torch.as_tensor(data.b, **f64)
    m = b.shape[0]
    Ax = torch.zeros(m, **f64).index_add_(
        0, k, v * torch.sum(Y[:, lin % n] * Y[:, lin // n], dim=0))
    pinf = float(torch.linalg.norm(Ax - b) / (1.0 + torch.linalg.norm(b)))
    cnz = np.flatnonzero(data.c)
    cl = torch.as_tensor(cnz, device=device)
    cv = torch.as_tensor(data.c[cnz], **f64)
    obj = float(torch.sum(cv * torch.sum(Y[:, cl % n] * Y[:, cl // n],
                                         dim=0)))
    by = float(torch.dot(b, y))
    gap = abs(obj - by) / (1.0 + abs(obj) + abs(by))
    del Ax, Y
    S = torch.zeros(n * n, **f64)
    S[cl] = cv
    S.index_add_(0, lin, -v * y[k])
    S = S.reshape(n, n).T          # vec is column-major; S is symmetric
    wv = torch.linalg.eigvalsh(S)
    lam_min, lam_max = float(wv[0]), float(wv[-1])
    del S
    dinf = max(0.0, -lam_min) / (1.0 + lam_max)
    torch.cuda.synchronize()
    return dict(pinf=pinf, dinf=dinf, gap=gap, eta=max(pinf, dinf, gap),
                obj=obj, trace_X=float(np.sum(res.Y * res.Y)), by=by,
                lam_min=lam_min, lam_max=lam_max,
                seconds=time.perf_counter() - t0)


def mc_options():
    """bench.py's overrides on recipe("mc"): delta 10, TR 8 x 6, theta
    1e-2, f32 tCG."""
    from manisdp_tpu_torch import recipes
    _, kw = recipes.recipe("mc")
    return dict(kw, delta=10, tr_maxinner=6, tr_maxiter=8, theta=1e-2,
                inner_dtype="tcg32")


def al_solve_phase(data, op, build_s, assemble_s, device, spy=None):
    """Matrix completion at n = 12,000 through solve_sdp (given its
    ConstraintOp, assembled in ``assemble_s``) with bench.py's mc
    settings; ``spy``: a CertSpy recording its certificate calls."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import solve_sdp

    n = int(data.K.s)
    kw = mc_options()
    K.reset_launches()
    torch.cuda.synchronize()
    if spy is not None:
        spy.install()
    t0 = time.perf_counter()
    try:
        res = solve_sdp(op, data.b, data.c, n, device=device,
                        verbose=False, **kw)
        torch.cuda.synchronize()
    finally:
        if spy is not None:
            spy.remove()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    spmm_modes = dict(K.SPMM_LAUNCHES)
    out = dict(phase="mc12000_solve", instance=MC, n=n, m=op.m,
               nnzA=op.nnz, nnzP=op.pat.nnz, options=kw,
               instance_build_s=build_s, assemble_s=assemble_s,
               seconds=seconds, solver_time_s=res.time, status=res.status,
               obj=res.obj, eta=res.eta, gap=res.gap, pinf=res.pinf,
               dinf=res.dinf, iterations=res.iterations,
               fac_size=res.fac_size, rtr_iters=res.rtr_iters,
               hess_calls=res.hess_calls,
               rtr_iters_per_s=res.rtr_iters / seconds, timers=res.timers,
               launches=launches, symcoo_spmm_modes=spmm_modes,
               outer=[dict(gap=h["gap"], pinf=h["pinf"], dinf=h["dinf"])
                      for h in res.history])
    if spy is not None:
        out["cert_calls"] = spy.history
    out["oracle"] = al_kkt_oracle_on_card(data, res, device)
    emit(out)
    if res.status != 0 or not res.eta <= 1e-8:
        raise AssertionError(f"mc12000: status {res.status}, eta {res.eta}")
    if not out["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"mc12000: KKT oracle {out['oracle']}")
    for name in ("pattern_dots", "csr_gather"):
        if launches[name] <= 0:
            raise AssertionError(f"the mc12000 solve never launched {name}")
    if spmm_modes["al_hess"] <= 0:
        raise AssertionError("the mc12000 solve never launched K1 al_hess")
    return out


class CertSpy:
    """Records the devrr certificate calls of one solve (ROADMAP Queue C,
    the mc-12000 devrr stall): ``install()`` swaps a recording
    DeviceCertSolver and a wrapped certificate closure into
    solvers.primal_al, ``remove()`` restores them; ``calls`` holds the
    LOBPCG calls of the latest certificate (each with its operator, budget,
    start block X0, padded deflation rows and ``last`` dict), ``point``
    the first outer iteration whose summary ``capture(summary, opt)``
    accepts (Y, sv and its calls; by default max(gap, pinf) <= 1e-10,
    dinf > tol and num_neg = 0), ``history`` every certificate's summary.
    tests/test_torch_cert.py captures its CPU point with it."""

    def __init__(self, capture=None):
        self.capture = capture or (lambda h, opt: max(
            h["gap"], h["pinf"]) <= 1e-10 and h["dinf"] > opt.tol and
            h["num_neg"] == 0)
        self.calls, self.history, self.point = [], [], None

    def install(self):
        from manisdp_tpu_torch.solvers import primal_al
        spy = self
        base = primal_al.DeviceCertSolver

        class Recording(base):
            def solve(self, mvr, gen, X0=None, Ydefl=None, maxiter=200,
                      tol=1e-10, **kw):
                res = super().solve(mvr, gen, X0=X0, Ydefl=Ydefl,
                                    maxiter=maxiter, tol=tol, **kw)
                spy.calls.append(dict(
                    solver=self, mvr=mvr, maxiter=maxiter, tol=tol,
                    X0=None if X0 is None else X0.clone(),
                    Ydefl=None if Ydefl is None else Ydefl.clone(),
                    last=dict(self.last), lam_min=float(res.lam_min),
                    num_neg=int(res.num_neg)))
                return res

        make = primal_al._make_certificate

        def make_spy(variant, op, n, k, use_eigh, opt, gen):
            inner = make(variant, op, n, k, use_eigh, opt, gen)

            def cert(Y, sv, z, gap=np.inf, pinf=np.inf):
                spy.calls = []
                out = inner(Y, sv, z, gap=gap, pinf=pinf)
                lam_min, lam_max, num_neg = out[:3]
                dinf = max(0.0, -lam_min) / (1.0 + lam_max)
                spy.history.append(dict(
                    gap=gap, pinf=pinf, dinf=dinf, num_neg=num_neg,
                    lobpcg=[dict(maxiter=c["maxiter"],
                                 iters=c["last"]["iters"],
                                 resid=float(c["last"]["resid"]),
                                 lam_min=c["lam_min"])
                            for c in spy.calls]))
                if spy.point is None and spy.calls and \
                        spy.capture(spy.history[-1], opt):
                    spy.point = dict(
                        iteration=len(spy.history), Y=Y.clone(),
                        sv=sv.clone(), n=n, k=k, opt=opt, gen=gen,
                        calls=list(spy.calls), dinf=dinf,
                        lam_max=float(lam_max))
                return out
            return cert

        self._saved = (base, make)
        primal_al.DeviceCertSolver = Recording
        primal_al._make_certificate = make_spy

    def remove(self):
        from manisdp_tpu_torch.solvers import primal_al
        primal_al.DeviceCertSolver, primal_al._make_certificate = \
            self._saved


def stall_study(spy, op, out_dir, long_maxiter=1600):
    """Re-run the certificate on the captured stalled point under the
    driver's budgets, ``long_maxiter`` iterations and a block of 48,
    beside a dense f64 eigvalsh of the same S; saves the point to
    ``out_dir``/mc12000_stall.npz and returns the numbers."""
    import torch
    from manisdp_tpu_torch.ops.eigs_rr import DeviceCertSolver

    def sync():
        if op.pat.i.is_cuda:
            torch.cuda.synchronize()

    pt = spy.point
    if pt is None:
        return dict(captured=False)
    first = pt["calls"][0]
    opt, n, k = pt["opt"], pt["n"], pt["k"]
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "mc12000_stall.npz"),
             Y=pt["Y"].cpu().numpy(), sv=pt["sv"].cpu().numpy(),
             X0=first["X0"].cpu().numpy(),
             Ydefl=first["Ydefl"].cpu().numpy(),
             pat_i=op.pat.i.cpu().numpy(), pat_j=op.pat.j.cpu().numpy())
    mvr, X0, Yd = first["mvr"], first["X0"], first["Ydefl"]
    dr = Yd.shape[0]

    def run(label, block_cap, budgets):
        solver = DeviceCertSolver(n, k, deflate_rows=dr, block_cap=block_cap)
        gen = torch.Generator(device=X0.device)
        gen.manual_seed(opt.seed)
        sync()
        t0 = time.perf_counter()
        x0, steps = X0, []
        for mi in budgets:
            res = solver.solve(mvr, gen, X0=x0, Ydefl=Yd, maxiter=mi,
                               tol=opt.cert_inner_tol)
            x0 = res.neg_vecs
            lam_max = float(res.lam_max)
            steps.append(dict(
                maxiter=mi, iters=solver.last["iters"],
                resid=float(solver.last["resid"]),
                lam_min=float(res.lam_min), num_neg=int(res.num_neg),
                ritz0=float(res.neg_vals[0]),
                dinf=max(0.0, -float(res.lam_min)) / (1.0 + lam_max)))
        sync()
        return dict(label=label, block=solver.b,
                    seconds=time.perf_counter() - t0, steps=steps,
                    certified=steps[-1]["dinf"] <= opt.tol)

    runs = [run("driver", 24, (opt.lobpcg_maxiter_warm, opt.lobpcg_maxiter)),
            run(f"maxiter_{long_maxiter}", 24, (long_maxiter,)),
            run("block_cap_48", 48,
                (opt.lobpcg_maxiter_warm, opt.lobpcg_maxiter)),
            run(f"block_cap_48_maxiter_{long_maxiter}", 48,
                (long_maxiter,))]
    S = op.pattern_dense(pt["sv"])
    S = 0.5 * (S + S.T)
    t0 = time.perf_counter()
    w = torch.linalg.eigvalsh(S)
    sync()
    eig_s = time.perf_counter() - t0
    del S
    wb = w[:48].cpu().numpy()
    lam_max = float(w[-1])
    return dict(
        captured=True, iteration=pt["iteration"], dinf=pt["dinf"],
        calls=[dict(maxiter=c["maxiter"], iters=c["last"]["iters"],
                    resid=float(c["last"]["resid"]),
                    scale=float(c["last"]["scale"]),
                    lo=float(c["last"]["lo"]), hi=float(c["last"]["hi"]),
                    lam_min=c["lam_min"], num_neg=c["num_neg"])
               for c in pt["calls"]],
        reruns=runs, eigvalsh_s=eig_s, lam_min_exact=float(w[0]),
        lam_max_exact=lam_max,
        dinf_exact=max(0.0, -float(w[0])) / (1.0 + lam_max),
        bottom48=wb.tolist(),
        below_1e_8_scaled=int(torch.sum(w < 1e-8 * (1.0 + lam_max))))


def phase_carrier_kernels(ew, dense, device, seed):
    """K5's three modes and K4 on the dense carrier (scatter_pos with and
    without base, the flat-position gather) against their twins at the
    n = 4,000 matrix-completion shapes, f64 and f32; then K6 (f64) on the
    refinement inputs of the instance's dual slack S = C - Aᵀy."""
    import torch
    from manisdp_tpu_torch import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, m = ew.n, ew.m
    sigma = 0.37
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=device)
    E64, w64 = rnd(n, n), rnd(m)
    W64 = ew.res_from_mvec(w64.cpu().numpy())   # w's dense representative
    for dt in (torch.float64, torch.float32):
        eo, do = ew.astype(dt), dense.astype(dt)
        E, w, W = E64.to(dt), w64.to(dt), W64.to(dt)
        info = dict(dtype=str(dt)[6:], n=n, m=m, nnzA=do.nnz,
                    npos=int(do.pos.shape[0]))
        scatter = dict(pos=do.pos, size=n * n)
        seg = (w, do.pos_ptr, do.kq, do.vq)
        # the scatter as one CSR product over all n^2 rows (empty rows
        # where no A entry lands)
        counts = torch.zeros(n * n + 1, dtype=torch.int64, device=device)
        counts[do.pos.long() + 1] = (do.pos_ptr[1:] - do.pos_ptr[:-1]).long()
        A_full = csr(torch.cumsum(counts, 0).to(torch.int32), do.kq, do.vq,
                     (n * n, m))
        A_dense = csr(do.krow_ptr, do.ij, do.v, (m, n * n))
        Cflat = do.C.view(-1)
        n2 = float(n * n)
        for name, mode, args, kw, reads, flops, lib in (
                ("masked_sym", "apply", (E, eo.aval, eo.dfac, "apply"), {},
                 (E, eo.aval, eo.dfac), 4 * n2, None),
                ("masked_sym", "aat", (E, eo.aval, eo.dfac, "aat"), {},
                 (E, eo.aval, eo.dfac), 5 * n2, None),
                ("masked_sym", "axpy", (W, eo.aval, None, "axpy"),
                 dict(C=eo.C, alpha=sigma), (W, eo.aval, eo.C), 3 * n2,
                 None),
                ("csr_gather", "scatter_pos", seg,
                 dict(scatter, base=Cflat, alpha=sigma),
                 (gathered(w, do.kq), *seg[1:], do.pos, Cflat), 2.0 * do.nnz,
                 lambda: torch.addmv(Cflat, A_full, w, alpha=sigma)),
                ("csr_gather", "scatter_pos_adjoint", seg, scatter,
                 (gathered(w, do.kq), *seg[1:], do.pos), 2.0 * do.nnz,
                 lambda: A_full @ w),
                ("csr_gather", "dense_apply_from_e",
                 (E.view(-1), do.krow_ptr, do.ij, do.v),
                 {},
                 (gathered(E, do.ij), do.krow_ptr, do.ij, do.v),
                 2.0 * do.nnz,
                 lambda: A_dense @ E.view(-1))):
            check_case(rows, name, mode, getattr(K, name),
                       getattr(K, f"{name}_plain"), args, kw, tol[dt],
                       reads=reads, flops=flops, library=lib,
                       repeat=name == "csr_gather", **info)
        del A_full, counts
    S = ew.s_vals(W64)
    V = torch.linalg.eigh(S.to(torch.float32))[1].to(torch.float64)
    SV = V.T @ (S @ V)
    SV = 0.5 * (SV + SV.T)
    B = V.T @ V
    mu = torch.diagonal(SV) / torch.diagonal(B)
    check_case(rows, "oa_refine", "f64", K.oa_refine, K.oa_refine_plain,
               (SV, B, mu, torch.min(mu), torch.max(mu)), {},
               tol[torch.float64], reads=(SV, B, mu), flops=12.0 * n * n,
               dtype="float64", n=n)
    return rows


def mc4_solve_phase(label, data, device, call, expect, **extra):
    """One solve of the n = 4,000 matrix completion with bench.py's mc
    settings plus ``extra``, through ``call(kw)``; checks that the
    operator ladder picked the class named ``expect``, the solver's and
    the oracle's eta, and reports peak device memory and every launch
    counter of the solve."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops import dense_cert
    from manisdp_tpu_torch.solvers import primal_al

    kw = dict(mc_options(), **extra)
    picked = []
    select = primal_al._select_operator

    def spy(opt, op):
        picked.append(select(opt, op))
        return picked[-1]

    primal_al._select_operator = spy
    K.reset_launches()
    dense_cert.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = call(kw)
        torch.cuda.synchronize()
    finally:
        primal_al._select_operator = select
    seconds = time.perf_counter() - t0
    out = dict(phase=label, instance=MC4, n=int(data.K.s),
               m=int(data.b.shape[0]),
               operator=type(picked[0]).__name__ if picked else None,
               options=kw, seconds=seconds, solver_time_s=res.time,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               status=res.status, obj=res.obj, eta=res.eta, gap=res.gap,
               pinf=res.pinf, dinf=res.dinf, iterations=res.iterations,
               fac_size=res.fac_size, rtr_iters=res.rtr_iters,
               hess_calls=res.hess_calls, timers=res.timers,
               launches=dict(K.LAUNCHES), csr_modes=dict(K.CSR_LAUNCHES),
               masked_modes=dict(K.MASKED_LAUNCHES),
               cert_tiers=dict(dense_cert.COUNTS))
    out["oracle"] = al_kkt_oracle_on_card(data, res, device)
    emit(out)
    if out["operator"] != expect:
        raise AssertionError(f"{label}: the ladder picked "
                             f"{out['operator']}, expected {expect}")
    if res.status != 0 or not res.eta <= 1e-8:
        raise AssertionError(f"{label}: status {res.status}, eta {res.eta}")
    if not out["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"{label}: KKT oracle {out['oracle']}")
    return out, res


def carrier_solve_phases(data, op, device):
    """Phases 9-11 on the n = 4,000 matrix completion (``op`` its
    ConstraintOp): solve_sedumi on the defaults, then the dense carrier and
    the dense_eigh certificate through solve_sdp."""
    import torch
    from manisdp_tpu_torch import solve_sdp, solve_sedumi

    n = int(data.K.s)
    ew, _ = mc4_solve_phase(
        "mc4000_entrywise", data, device,
        lambda kw: solve_sedumi(data, device=device, verbose=False, **kw),
        "EntrywiseConstraintOp")
    for mode, count in ew["masked_modes"].items():
        if count <= 0:
            raise AssertionError(f"the entrywise solve never launched K5 "
                                 f"{mode}")
    by_op = lambda kw: solve_sdp(op, data.b, data.c, n,  # noqa: E731
                                 device=device, verbose=False, **kw)
    dense, _ = mc4_solve_phase("mc4000_dense", data, device, by_op,
                               "DenseConstraintOp", al_op_mode="dense")
    if dense["csr_modes"]["scatter_pos"] <= 0:
        raise AssertionError("the dense solve never launched K4 scatter_pos")
    rel = abs(dense["obj"] - ew["obj"]) / abs(ew["obj"])
    if not rel <= 1e-8 or dense["iterations"] != ew["iterations"]:
        raise AssertionError(
            f"dense vs entrywise: objectives {dense['obj']} / {ew['obj']} "
            f"(rel {rel}), iterations {dense['iterations']} / "
            f"{ew['iterations']}")
    cert, res = mc4_solve_phase("mc4000_dense_eigh", data, device, by_op,
                                "EntrywiseConstraintOp",
                                cert_method="dense_eigh")
    if cert["launches"]["oa_refine"] <= 0:
        raise AssertionError("the dense_eigh solve never launched K6")
    # the exact certificate dense_eigh stands in for, on the final S
    S = torch.as_tensor(res.S, dtype=torch.float64, device=device)
    S = 0.5 * (S + S.T)
    cmp = dict(phase="mc4000_cert_compare",
               dense_eigh_cert_s=cert["timers"].get("cert"),
               devrr_cert_s=ew["timers"].get("cert"),
               cert_tiers=cert["cert_tiers"],
               eigh_f64_ms=time_ms(lambda: torch.linalg.eigh(S), reps=3,
                                   warm=1),
               eigh_f32_ms=time_ms(lambda: torch.linalg.eigh(S.float()),
                                   reps=3, warm=1),
               dense_vs_entrywise_obj_rel=rel)
    emit(cmp)
    return dict(entrywise=ew, dense=dense, dense_eigh=cert, compare=cmp)


def bqp_instance(q, bqp_dir):
    """Q, e of the BQP of size q: the reference's bqp_Q_{q}_1.txt /
    bqp_e_{q}_1.txt from ``bqp_dir`` when present, else bench.py's seeded
    stand-in of the same class (bench.py:176-179)."""
    path = os.path.join(bqp_dir, f"bqp_Q_{q}_1.txt") if bqp_dir else None
    if path and os.path.exists(path):
        Q = np.loadtxt(path, delimiter=",")
        e = np.loadtxt(os.path.join(bqp_dir, f"bqp_e_{q}_1.txt"),
                       delimiter=",")
        return Q, e, f"reference bqp instance q = {q}, i = 1"
    rng = np.random.default_rng(1)
    Q = rng.standard_normal((q, q))
    Q = (Q + Q.T) / 2.0
    e = rng.standard_normal(q)
    return Q, e, f"seeded stand-in for bqp q = {q} (default_rng(1))"


def qs_instance(d):
    """The quartic over the sphere of examples/example_qsphere.py: its SOS
    dual data (A, b, c, mb, f, dAAt) from frontends.sos.qssos."""
    from manisdp_tpu_torch.frontends.monomials import monomial_basis
    from manisdp_tpu_torch.frontends.sos import qssos
    coe = np.random.RandomState(1).randn(monomial_basis(d, 4).shape[1])
    return qssos(d, coe)


def symdual_class_map(q, device, kernel=False, canonical=None):
    """The int64 (n~, n~) map from an entry of the SOS-dual adjoint W to
    its slot of the flat y = (y0, y1, Y2, Y3, Y4): the twin (``kernel``:
    K8's adjoint, whose workspace is only its output) on y_flat = arange,
    exact in f64 (the length is < 2^53).  torch.take(y_flat, map) is then
    the unscaled adjoint: K8's library yardstick.  With ``canonical``
    (symdual_canonical_slots) in place of the arange, each entry maps to
    its class's sorted-index slot: K7's yardstick (class_sums)."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.symdual import _split
    idx = canonical if canonical is not None else torch.arange(
        1 + q + q * q + q ** 3 + q ** 4, dtype=torch.float64, device=device)
    adjoint = K.symdual_adjoint if kernel else K.symdual_adjoint_plain
    W = adjoint(_split(idx, q), q)
    del idx
    return W.long()


def symdual_canonical_slots(q, device):
    """For each slot of the flat y, the slot of its class's sorted-index
    representative (Y2[min, max], Y3 and Y4 at their sorted indices), as
    f64; Y4 built a slab of i at a time."""
    import torch
    o2, o3, o4 = 1 + q, 1 + q + q * q, 1 + q + q * q + q ** 3
    out = torch.empty((o4 + q ** 4,), dtype=torch.float64, device=device)
    out[:o2] = torch.arange(o2, dtype=torch.float64, device=device)
    a = torch.arange(q, device=device)

    def flat(off, idx):
        s = torch.sort(torch.stack(torch.broadcast_tensors(*idx)), dim=0)[0]
        f = s[0]
        for t in s[1:]:
            f = f * q + t
        return (off + f).reshape(-1)

    out[o2:o3] = flat(o2, (a[:, None], a[None, :]))
    out[o3:o4] = flat(o3, (a[:, None, None], a[None, :, None],
                           a[None, None, :]))
    j, k, l = a[:, None, None], a[None, :, None], a[None, None, :]
    for i in range(q):
        out[o4 + i * q ** 3:o4 + (i + 1) * q ** 3] = flat(
            o4, (torch.full_like(j, i), j, k, l))
    return out


def class_sums(out, cls, M):
    """K7's library yardstick: every class sum of M by one index_add_ of
    its entries at their class's sorted-index slot (``cls``:
    symdual_class_map with ``canonical``, flattened), into the zeroed
    flat ``out``.  The same sums as K7 up to their order."""
    return out.zero_().index_add_(0, cls, M.reshape(-1))


def class_sums_errors(y, sums, canon, q):
    """K7's per-degree output ``y`` against the class sums ``sums`` read
    at every slot's sorted-index slot (``canon``, int64), repeated-index
    slots 0: the largest absolute error of each degree and the largest
    sum.  One temporary the size of the largest degree (in place after
    the gather)."""
    import torch
    from manisdp_tpu_torch.ops.symdual import _repeat_masks
    masks = (None, None) + _repeat_masks(q, sums.device)
    errs, scale, o = [], 0.0, 0
    for d, v in enumerate(y):
        ref = torch.take(sums, canon[o:o + v.numel()]).view(v.shape)
        if masks[d] is not None:
            ref.masked_fill_(masks[d], 0)
        scale = max(scale, float(ref.max()), -float(ref.min()))
        errs.append(float(ref.sub_(v).abs_().max()))
        o += v.numel()
        del ref
    return errs, scale


def phase_dual_kernels(top64, dop64, iab64, device, seed):
    """K7, K8's modes and K2's eG epilogue at the expanded q = 60 shape,
    K4 on the original-basis DualOp and on the iAB pair, f64 and f32,
    against their twins.  K8 takes y as views of one flat buffer (K7's
    output layout) with NaN in every don't-care slot; its unscaled
    adjoint is timed beside torch.take of the class map, K7's apply beside
    index_add_ of M at the sorted-index class map (class_sums)."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.symdual import (_dontcare_mask, _flatten,
                                               _split)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, n = top64.q, top64.n
    sigma = 0.37
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=device)
    M64 = rnd(n, n)
    M64 = 0.5 * (M64 + M64.T)
    B64 = rnd(n, n)
    skew = skew_inputs(device, seed)
    emit(dict(phase="k4_row_profiles", long_row=K.CSR_LONG_ROW,
              dual_apply=row_profile(dop64.krow_ptr),
              dual_adjoint=row_profile(dop64.pos_ptr),
              iab_mat=row_profile(iab64.row_ptr),
              iab_rmat=row_profile(iab64.col_ptr),
              **{f"skew_{k}": row_profile(c["ptr"])
                 for k, c in skew.items()}))
    cls = symdual_class_map(q, device)
    canon = symdual_canonical_slots(q, device)
    cls_canon = symdual_class_map(q, device, canonical=canon).view(-1)
    canon = canon.long()
    dontcare = torch.as_tensor(_dontcare_mask(q), device=device)
    for dt in (torch.float64, torch.float32):
        info = dict(dtype=str(dt)[6:], q=q, n=n)
        top = top64.astype(dt)
        M, Xm = M64.to(dt), B64.to(dt)
        y_flat = _flatten(*K.symdual_apply_plain(M, q))
        y_flat[dontcare] = float("nan")
        y = _split(y_flat, q)
        n2 = float(n * n)
        k7 = (K.symdual_apply, K.symdual_apply_plain)
        k8 = (K.symdual_adjoint, K.symdual_adjoint_plain)
        cases = [
            ("symdual_apply", "apply", k7, (M, q), {}, (M,), n2),
            ("symdual_apply", "y_step", k7, (M, q),
             dict(scale=top.idAAt, shift=top.Ac), (M,), n2),
            ("symdual_adjoint", "adjoint", k8, (y, q), {}, y, 0.0),
            ("symdual_adjoint", "adjoint_scaled", k8, (y, q),
             dict(scale=top.idAAt), y, n2),
            ("symdual_adjoint", "residual", k8, (y, q),
             dict(B1=M, c1=-1.0, B2=Xm, c2=-1.0 / sigma), (*y, M, Xm),
             4 * n2),
            ("symdual_adjoint", "sym_mat",
             (K.symdual_sym_mat, K.symdual_sym_mat_plain), (M, q), {},
             (M,), 3 * n2),
        ]
        for p in (8, 64, 192):
            Y = rnd(p, n).to(dt)
            for renorm in (True, False):
                cases.append((
                    "symdual_adjoint",
                    f"sym_factor_p{p}_{'renorm' if renorm else 'plain'}",
                    (K.symdual_sym_factor, K.symdual_sym_factor_plain),
                    (Y, q, renorm), {}, (Y,), 4.0 * p * n))
        sums = torch.empty_like(y_flat)
        for name, mode, (fn, twin), args, kw, reads, flops in cases:
            k7_case = name == "symdual_apply"
            take = mode == "adjoint"
            index_add = k7_case and mode == "apply"
            lib = (lambda: torch.take(y_flat, cls)) if take else (
                lambda: class_sums(sums, cls_canon, M)) if index_add else None
            check_case(rows, name, mode, fn, twin, args, kw, tol[dt],
                       reads=reads, flops=flops, repeat=True,
                       passes=k7_case, library=lib, **info)
            if index_add:
                # the same sums in another order (index_add_'s atomics)
                errs, big = class_sums_errors(fn(*args, **kw),
                                              class_sums(sums, cls_canon, M),
                                              canon, q)
                rows[-1].update(
                    library="index_add_ of M at the sorted-index class map",
                    library_rel_err=max(errs) / big)
                if not rows[-1]["library_rel_err"] <= tol[dt]:
                    raise AssertionError("K7 differs from index_add_: "
                                         f"{rows[-1]}")
            if take:
                # the gather reads the 8-byte index map besides
                rows[-1].update(
                    library_index_mb=cls.numel() * cls.element_size() / 1e6,
                    library_bit_equal=bool(torch.equal(
                        torch.take(y_flat, cls), fn(*args, **kw))))
                if not rows[-1]["library_bit_equal"]:
                    raise AssertionError("K8 adjoint differs from "
                                         f"torch.take: {rows[-1]}")
        del y, y_flat, sums
        # K2 proj with the Hessian's eG term at the solve's widest factor
        Y, H, U = (rnd(192, n).to(dt) for _ in range(3))
        g = rnd(n).to(dt)
        check_case(rows, "oblique_cols", "proj_eG", K.oblique_cols,
                   K.oblique_cols_plain, (Y, H, "proj"), dict(v=U, g=g),
                   tol[dt], reads=(Y, H, U, g), flops=6.0 * 192 * n,
                   repeat=True, p_pad=192, **info)
        del M, Xm, Y, H, U
        # K11 without the projection at the qs-d30 solve's narrowest and
        # widest tCG shapes
        for p in (8, 48):
            tcg_case(rows, (1, p, QS_N), dt, tol[dt], rnd, device, "step")
        # K4 on the original-basis DualOp (q = 60) and the iAB pair
        dop, iab = dop64.astype(dt), iab64.astype(dt)
        nd, md = dop.n, dop.m
        Md = rnd(nd, nd).to(dt).view(-1)
        w = rnd(md).to(dt)
        A_k = csr(dop.krow_ptr, dop.lin_r, dop.v_r, (md, nd * nd))
        A_t = csr(dop.pos_ptr, dop.k_c, dop.v_c, (int(dop.pos.shape[0]), md))
        negAc = -dop.Ac
        nnz = float(dop.v_r.numel())
        dinfo = dict(dtype=str(dt)[6:], n=nd, m=md, nnzA=int(nnz))
        u = rnd(iab.ncols).to(dt)
        Mi = rnd(iab.nrows).to(dt)
        I_r = csr(iab.row_ptr, iab.col_r, iab.val_r, (iab.nrows, iab.ncols))
        I_c = csr(iab.col_ptr, iab.row_c, iab.val_c, (iab.ncols, iab.nrows))
        inz = float(iab.val_r.numel())
        iinfo = dict(dtype=str(dt)[6:], nrows=iab.nrows, ncols=iab.ncols,
                     nnz=int(inz))
        for mode, args, kw, reads, flops, lib, inf in (
                ("dual_apply", (Md, dop.krow_ptr, dop.lin_r, dop.v_r),
                 {},
                 (gathered(Md, dop.lin_r), dop.krow_ptr, dop.lin_r, dop.v_r),
                 2 * nnz, lambda: A_k @ Md, dinfo),
                ("dual_y_step", (Md, dop.krow_ptr, dop.lin_r, dop.v_r),
                 dict(base=negAc),
                 (gathered(Md, dop.lin_r), dop.krow_ptr,
                                    dop.lin_r, dop.v_r, negAc), 2 * nnz,
                 lambda: torch.addmv(negAc, A_k, Md), dinfo),
                ("dual_adjoint", (w, dop.pos_ptr, dop.k_c, dop.v_c),
                 dict(pos=dop.pos, size=nd * nd),
                 (gathered(w, dop.k_c), dop.pos_ptr, dop.k_c, dop.v_c,
                  dop.pos), 2 * nnz,
                 lambda: A_t @ w, dinfo),
                ("iab_mat", (u, iab.row_ptr, iab.col_r, iab.val_r),
                 {},
                 (gathered(u, iab.col_r), iab.row_ptr, iab.col_r, iab.val_r),
                 2 * inz,
                 lambda: I_r @ u, iinfo),
                ("iab_rmat", (Mi, iab.col_ptr, iab.row_c, iab.val_c),
                 {},
                 (gathered(Mi, iab.row_c), iab.col_ptr, iab.row_c,
                  iab.val_c), 2 * inz,
                 lambda: I_c @ Mi, iinfo)):
            check_case(rows, "csr_gather", mode, K.csr_gather,
                       K.csr_gather_plain, args, kw, tol[dt], reads=reads,
                       flops=flops, library=lib, repeat=True,
                       rows_profile=row_profile(args[1]), **inf)
        del A_k, A_t, I_r, I_c
        skew_cases(rows, skew, dt, tol[dt])
    return rows


def skew_inputs(device, seed):
    """Phase 12's skewed CSR inputs (f64; host numpy from ``seed``): one
    row of SKEW_LONG entries among SKEW_ROWS rows of one; the same count
    of rows, half of them empty and the rest 1-8 long; a scatter_pos
    operator of SKEW_ROWS / 10 positions, one with SKEW_LONG entries."""
    import torch
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                    device=device)

    def ptr_of(lens):
        return np.concatenate([[0], np.cumsum(lens)])

    out = {}
    lens = np.ones(SKEW_ROWS, dtype=np.int64)
    lens[SKEW_ROWS // 3] = SKEW_LONG
    lens_e = np.where(rng.random(SKEW_ROWS) < 0.5, 0,
                      rng.integers(1, 9, SKEW_ROWS))
    npos = SKEW_ROWS // 10
    lens_s = rng.integers(1, 4, npos)
    lens_s[npos // 2] = SKEW_LONG
    for name, ln, ncols in (("long_row", lens, SKEW_ROWS),
                            ("empty_rows", lens_e, SKEW_ROWS),
                            ("scatter_pos_long_row", lens_s, npos)):
        nnz = int(ln.sum())
        ptr = i32(ptr_of(ln))
        out[name] = dict(ptr=ptr, col=i32(rng.integers(0, ncols, nnz)),
                         val=f64(rng.standard_normal(nnz)),
                         x=f64(rng.standard_normal(ncols)), nrows=ln.size,
                         ncols=ncols)
    sp = out["scatter_pos_long_row"]
    size = 4 * npos
    sp.update(pos=i32(np.sort(rng.choice(size, npos, replace=False))),
              size=size, base=f64(rng.standard_normal(size)))
    return out


def sum_scale(x, ptr, col, val, base=None, alpha=1.0, pos=None,
              size=None):
    """Per-output error scale of K4's sums: |base| + |alpha| times the sum
    of the row's absolute terms, in f64.  A sum of L terms in any order is
    off by up to ~L * eps of that (10^5 terms in f32: ~1e-3 of it),
    however it is taken, so rows of 10^5 entries are held relative to it
    rather than to the largest output."""
    import torch
    from manisdp_tpu_torch import kernels as K
    d = torch.float64
    abs_base = None if base is None else torch.abs(base.to(d))
    s = K.csr_gather_plain(torch.abs(x.to(d)), ptr, col,
                           torch.abs(val.to(d)), abs_base, abs(alpha), pos,
                           size)
    return torch.clamp(s, min=torch.finfo(d).tiny)


def skew_cases(rows, skew, dt, tol):
    """K4 on the skewed inputs of skew_inputs, in ``dt``, each held to its
    twin relative to the rows' absolute sums (sum_scale) and repeated bit
    for bit; library: the CSR product.  The f64 case is the one that
    catches a wrong long-row sum: 1e-12 of the 10^5-entry row's absolute
    sum (~6.4e4) is ~6e-8, far below one term (~0.6), while the f32
    case's 1e-5 of it (~0.64) is about one term, so a dropped or repeated
    entry could pass in f32."""
    import torch
    from manisdp_tpu_torch import kernels as K
    for name, c in skew.items():
        x, val = c["x"].to(dt), c["val"].to(dt)
        args = (x, c["ptr"], c["col"], val)
        if "pos" in c:
            base = c["base"].to(dt)
            kw = dict(pos=c["pos"], size=c["size"], base=base, alpha=0.5)
            # the same function as one CSR product over all output rows
            counts = torch.zeros(c["size"] + 1, dtype=torch.int64,
                                 device=x.device)
            counts[c["pos"].long() + 1] = (c["ptr"][1:] -
                                           c["ptr"][:-1]).long()
            A = csr(torch.cumsum(counts, 0).to(torch.int32), c["col"], val,
                    (c["size"], c["ncols"]))
            lib = lambda A=A, base=base, x=x: torch.addmv(  # noqa: E731
                base, A, x, alpha=0.5)
            reads = (gathered(x, c["col"]), *args[1:], c["pos"], base)
        else:
            kw = {}
            A = csr(c["ptr"], c["col"], val, (c["nrows"], c["ncols"]))
            lib = lambda A=A, x=x: A @ x  # noqa: E731
            reads = (gathered(x, c["col"]), *args[1:])
        check_case(rows, "csr_gather", f"skew_{name}", K.csr_gather,
                   K.csr_gather_plain, args, kw, tol, reads=reads,
                   flops=2.0 * c["col"].numel(), library=lib, repeat=True,
                   scale=sum_scale(*args, **kw),
                   rows_profile=row_profile(c["ptr"]), dtype=str(dt)[6:],
                   nrows=c["nrows"], nnz=int(c["col"].numel()))
        del A


def dual_kkt_oracle_on_card(A, b, c, n, f, res, device):
    """Independent KKT check of a dual solve on the card from the raw
    SeDuMi dual triplets (A (m, f + n^2), column-major vec; b as solved)
    and the returned (Y, y, X, obj), with the residuals of
    solvers/dual_al.py:176-200: As = mat(A_psd' y) - (Y'Y - C),
    Af = B'y - c_f, pinf = (|As| + |Af|) / (1 + |(C, c_f)|), dinf from f64
    eigvalsh of X, gap = |obj - b'y| / (1 + |obj| + |b'y|)."""
    import scipy.sparse as sp
    import torch
    t0 = time.perf_counter()
    f64 = dict(dtype=torch.float64, device=device)
    A = sp.coo_matrix(A)
    c = np.asarray(c, dtype=np.float64).ravel()
    y = torch.as_tensor(res.y, **f64)
    psd = A.col >= f
    col = A.col[psd].astype(np.int64) - f
    lin = torch.as_tensor((col % n) * n + col // n, device=device)
    rows = torch.as_tensor(A.row[psd].astype(np.int64), device=device)
    At_y = torch.zeros(n * n, **f64).index_add_(
        0, lin, torch.as_tensor(A.data[psd], **f64) * y[rows])
    cnz = np.flatnonzero(c[f:])
    Cf = torch.zeros(n * n, **f64)
    Cf[torch.as_tensor((cnz % n) * n + cnz // n, device=device)] = \
        torch.as_tensor(c[f:][cnz], **f64)
    Y = torch.as_tensor(res.Y, **f64)
    As = At_y.view(n, n) - (Y.T @ Y - Cf.view(n, n))
    fr = A.col < f
    Bty = torch.zeros(f, **f64).index_add_(
        0, torch.as_tensor(A.col[fr].astype(np.int64), device=device),
        torch.as_tensor(A.data[fr], **f64) *
        y[torch.as_tensor(A.row[fr].astype(np.int64), device=device)])
    cf = torch.as_tensor(c[:f], **f64)
    Af = Bty - cf
    normc = 1.0 + float(torch.sqrt(torch.sum(Cf * Cf) + torch.sum(cf * cf)))
    pinf = (float(torch.linalg.norm(As)) + float(torch.linalg.norm(Af))) \
        / normc
    by = float(torch.dot(torch.as_tensor(np.asarray(b).ravel(), **f64), y))
    gap = abs(res.obj - by) / (1.0 + abs(res.obj) + abs(by))
    del At_y, As, Y
    wv = torch.linalg.eigvalsh(torch.as_tensor(res.X, **f64))
    lam_min, lam_max = float(wv[0]), float(wv[-1])
    dinf = max(0.0, -lam_min) / (1.0 + abs(lam_max))
    torch.cuda.synchronize()
    return dict(pinf=pinf, dinf=dinf, gap=gap, eta=max(pinf, dinf, gap),
                by=by, lam_min=lam_min, lam_max=lam_max,
                seconds=time.perf_counter() - t0)


def profile_breakdown(fn):
    """Run ``fn`` under torch.profiler; device seconds and launches by
    kernel kind (device events only: kernels, memcpy, memset), the
    profiled wall and the device busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kinds = (("K1 symcoo_spmm", ("symcoo_spmm_kernel", "spmm_nmajor")),
             ("K9 symmom_apply", ("mom_stage", "mom_sym<", "mom_rows")),
             ("K10 symmom_adjoint", ("namespace)::coef_kernel",
                                     "namespace)::out_kernel")),
             ("K7 symdual_apply", ("symdual_stage", "symdual_sym<",
                                   "symdual_y4")),
             ("K8 symdual_adjoint", ("adjoint_kernel", "sym_factor_kernel",
                                     "sym_mat_pair_kernel",
                                     "sym_mat_tile_kernel")),
             ("K2 oblique_cols", ("oblique_cols", "oblique_tiles")),
             ("K11 tcg_step", ("tcg_",)),
             ("K4 csr_gather", ("csr_gather",)),
             ("K6 oa_refine", ("oa_refine",)),
             ("GEMM (cuBLAS)", ("gemm", "gemv", "sm90_xmma", "cutlass",
                                "Kernel2", "dot_kernel")),
             ("cuSOLVER", ("syevd", "syevj", "sytrd", "ormtr", "orgtr",
                           "steqr", "stedc", "potrf", "cusolver", "lansy",
                           "larf", "geqrf")),
             ("memcpy / memset", ("Memcpy", "Memset", "memcpy", "memset")),
             ("NCCL collectives", ("nccl",)),
             ("reductions", ("reduce", "Reduce")),
             ("indexing / copies", ("index", "Index", "gather", "scatter",
                                    "copy", "cat", "Cat", "tril", "triu")),
             ("elementwise", ("elementwise", "Elementwise", "vectorized",
                              "unrolled")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_kind = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if not us:
            continue
        kind = next((k for k, keys in kinds
                     if any(key in evt.key for key in keys)), "other")
        d = by_kind.setdefault(kind, dict(s=0.0, launches=0, top=[]))
        d["s"] += us / 1e6
        d["launches"] += evt.count
        d["top"].append((us / 1e6, evt.key[:80]))
    for d in by_kind.values():
        d["top"] = sorted(d["top"], reverse=True)[:3]
    busy = sum(d["s"] for d in by_kind.values())
    return out, dict(wall_s=wall, device_busy_s=busy,
                     busy_share=busy / wall, by_kind=by_kind)


def solve_with_counts(label, call, device, check_ok=True, **extra):
    """One solve through ``call()`` (the dual solves first, then the
    moment primal and the multiblock drivers): seconds, peak device
    memory, every launch counter and the certificate tiers of that run."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops import dense_cert

    K.reset_launches()
    dense_cert.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = dict(phase=label, **extra, seconds=seconds,
               solver_time_s=res.time,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               status=res.status, obj=res.obj, eta=res.eta, gap=res.gap,
               pinf=res.pinf, dinf=res.dinf, iterations=res.iterations,
               fac_size=res.fac_size, rtr_iters=res.rtr_iters,
               hess_calls=res.hess_calls, timers=res.timers,
               launches=dict(K.LAUNCHES), f32_launches=dict(K.F32_LAUNCHES),
               csr_modes=dict(K.CSR_LAUNCHES),
               oblique_modes=dict(K.OBLIQUE_LAUNCHES),
               tcg_launches=dict(K.TCG_LAUNCHES),
               symdual_modes=dict(K.SYMDUAL_LAUNCHES),
               spmm_modes=dict(K.SPMM_LAUNCHES),
               cert_tiers=dict(dense_cert.COUNTS))
    if check_ok and (res.status != 0 or not res.eta <= 1e-8):
        emit(out)
        raise AssertionError(f"{label}: status {res.status}, eta {res.eta}")
    return out, res


def bqp_sample_min(Q, e, device, count=100_000, seed=0):
    """min x'Qx + e'x over ``count`` seeded random x in {-1, 1}^q."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    x = 2.0 * torch.randint(0, 2, (count, Q.shape[0]), generator=gen,
                            device=device).to(torch.float64) - 1.0
    Qt, et = torch.as_tensor(Q, **f64), torch.as_tensor(e, **f64)
    vals = torch.sum((x @ Qt) * x, dim=1) + x @ et
    return float(torch.min(vals))


def dual_phases(args, device, top60, dop60, q60_data, bqp_label):
    """Phases 13-15: the BQP SOS dual in both bases (q = 30 against the JAX
    package's optimum first, then q = 60) and the quartic over the sphere
    through the general variant."""
    import torch
    from manisdp_tpu_torch import solve_dual_sdp, solve_dual_unitdiag
    from manisdp_tpu_torch.frontends.sos import assemble_bqpsos
    from manisdp_tpu_torch.solvers import dual_al
    from manisdp_tpu_torch.solvers.dual_unitdiag import solve_bqp_sos_dual

    out = {}
    # -- 13. the expanded basis (SymDualOp) --
    Q30, e30, lab30 = bqp_instance(30, args.bqp)
    q30 = Q30.shape[0]
    standin30 = "stand-in" in lab30
    kw30 = dict(line_search=True, inner_dtype="tcg32")
    r, res = solve_with_counts(
        "bqp30_expanded",
        lambda: solve_bqp_sos_dual(Q30, e30, q30, device=device,
                                   verbose=False, **kw30),
        device, instance=lab30, options=kw30)
    r["rel_to_jax"] = abs(res.obj - JAX_BQP30) / abs(JAX_BQP30) \
        if standin30 else None
    emit(r)
    out["bqp30_expanded"] = r
    Q, e = q60_data[:2]
    q = Q.shape[0]
    r, res = solve_with_counts(
        "bqp60_expanded",
        lambda: solve_bqp_sos_dual(Q, e, q, device=device, verbose=False,
                                   **BQP_KW),
        device, instance=bqp_label, options=BQP_KW, n_expanded=top60.n,
        m_true=top60.m_true)
    t0 = time.perf_counter()
    wv = torch.linalg.eigvalsh(torch.as_tensor(res.X, dtype=torch.float64,
                                               device=device))
    lam_min, lam_max = float(wv[0]), float(wv[-1])
    sample_min = bqp_sample_min(Q, e, device, seed=args.seed)
    r["oracle"] = dict(
        dinf=max(0.0, -lam_min) / (1.0 + abs(lam_max)), lam_min=lam_min,
        lam_max=lam_max, sample_min_100k=sample_min,
        bound_minus_sample=res.obj - sample_min,
        seconds=time.perf_counter() - t0)
    emit(r)
    out["bqp60_expanded"] = r
    if not r["oracle"]["dinf"] <= 1e-8:
        raise AssertionError(f"bqp60 expanded: oracle {r['oracle']}")
    if not res.obj <= sample_min + 1e-9 * abs(res.obj):
        raise AssertionError(f"bqp60: the SOS bound {res.obj} exceeds a "
                             f"sampled value {sample_min}")
    for key in ("symdual_apply", "symdual_adjoint", "oblique_cols",
                "oa_refine"):
        if r["launches"][key] <= 0:
            raise AssertionError(f"the bqp60 expanded solve never launched "
                                 f"{key}")
    for mode in ("adjoint", "residual"):
        if r["symdual_modes"][mode] <= 0:
            raise AssertionError(f"the bqp60 expanded solve never launched "
                                 f"K8 {mode}")
    _, prof = profile_breakdown(
        lambda: solve_bqp_sos_dual(Q, e, q, device=device, verbose=False,
                                   **BQP_KW))
    prof = dict(phase="bqp60_expanded_profile", **prof)
    emit(prof)
    out["bqp60_profile"] = prof

    # -- 14. the original basis (DualOp, K4) --
    A, b, c, mb, f, dAAt = assemble_bqpsos(Q30, e30, q30)
    maxb = float(np.max(np.abs(b)))
    r, res = solve_with_counts(
        "bqp30_original",
        lambda: solve_dual_unitdiag(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                                    device=device, verbose=False, **kw30),
        device, instance=lab30, options=kw30)
    r["obj_unscaled"] = res.obj * maxb
    r["rel_to_jax"] = abs(res.obj * maxb - JAX_BQP30) / abs(JAX_BQP30) \
        if standin30 else None
    r["oracle"] = dual_kkt_oracle_on_card(A, b / maxb, c, mb, f, res,
                                          device)
    emit(r)
    out["bqp30_original"] = r
    for key in ("bqp30_expanded", "bqp30_original"):
        rel = out[key]["rel_to_jax"]
        if rel is not None and not rel <= 1e-7:
            raise AssertionError(f"{key}: {rel} from the JAX optimum")
    A, b, c, mb, f, dAAt = q60_data[2]
    maxb = float(np.max(np.abs(b)))
    kw_orig = dict(line_search=True, inner_dtype="tcg32")
    r, res = solve_with_counts(
        "bqp60_original",
        lambda: solve_dual_unitdiag(dop60, None, None, mb, device=device,
                                    verbose=False, **kw_orig),
        device, instance=bqp_label, options=kw_orig, n=mb, m=int(A.shape[0]),
        nnzA=int(A.nnz))
    r["obj_unscaled"] = res.obj * maxb
    r["rel_to_expanded"] = abs(res.obj * maxb - out["bqp60_expanded"]["obj"]) \
        / abs(out["bqp60_expanded"]["obj"])
    r["oracle"] = dual_kkt_oracle_on_card(A, b / maxb, c, mb, f, res,
                                          device)
    emit(r)
    out["bqp60_original"] = r
    if not r["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"bqp60 original: oracle {r['oracle']}")
    if not r["rel_to_expanded"] <= 1e-6:
        raise AssertionError(f"bqp60: the bases disagree by "
                             f"{r['rel_to_expanded']}")
    if r["csr_modes"]["gather"] <= 0 or r["csr_modes"]["scatter_pos"] <= 0:
        raise AssertionError("the bqp60 original solve never launched K4")

    # -- 15. the general variant: the quartic over the sphere --
    t0 = time.perf_counter()
    A, b, c, mb, f, dAAt = qs_instance(QS_D)
    build_s = time.perf_counter() - t0
    maxb = float(np.max(np.abs(b)))
    kw_qs = QS_KW
    iab_calls = {"mat": 0, "rmat": 0}
    mat, rmat = dual_al._iab_mat, dual_al._iab_rmat

    def spy_mat(*a):
        iab_calls["mat"] += 1
        return mat(*a)

    def spy_rmat(*a):
        iab_calls["rmat"] += 1
        return rmat(*a)
    dual_al._iab_mat, dual_al._iab_rmat = spy_mat, spy_rmat
    try:
        r, res = solve_with_counts(
            "qs30_general",
            lambda: solve_dual_sdp(A, b / maxb, c, mb, f=f, dAAt=dAAt,
                                   device=device, verbose=False, **kw_qs),
            device, instance=f"quartic over the sphere d = {QS_D} "
            "(RandomState(1), examples/example_qsphere.py)", options=kw_qs,
            n=mb, m=int(A.shape[0]), f=f, instance_build_s=build_s)
    finally:
        dual_al._iab_mat, dual_al._iab_rmat = mat, rmat
    r["iab_calls"] = dict(iab_calls)
    r["obj_unscaled"] = res.obj * maxb
    r["rel_to_jax"] = abs(res.obj * maxb - JAX_QS30) / abs(JAX_QS30)
    r["oracle"] = dual_kkt_oracle_on_card(A, b / maxb, c, mb, f, res,
                                          device)
    emit(r)
    out["qs30_general"] = r
    if not r["oracle"]["eta"] <= 1e-8 or not r["rel_to_jax"] <= 1e-6:
        raise AssertionError(f"qs30: oracle {r['oracle']}, "
                             f"{r['rel_to_jax']} from the JAX optimum")
    if min(iab_calls.values()) <= 0 or r["csr_modes"]["gather"] <= 0:
        raise AssertionError("the qs30 solve never ran the iAB pair on K4")
    return out


def build_bqpmom(q, bqp_dir):
    """The raw frontends/moments.bqpmom SeDuMi data of the BQP of size q
    (the q = 60 oracle's triplets) and its build seconds; runs in a worker
    process."""
    from manisdp_tpu_torch.frontends.moments import bqpmom
    Q, e, _ = bqp_instance(q, bqp_dir)
    t0 = time.perf_counter()
    data = bqpmom(q, Q, e)
    return data, time.perf_counter() - t0


def build_chain(t, q, which):
    """examples/example_bqp_sparse.py's instance (the chain of t cliques of
    q variables, its RandomState(1) objective) as its moment relaxation
    (``which="mom"``: SeDuMi data) or its SOS relaxation (``"sos"``: A, b,
    c, mbs, f, dAAt), and the build seconds; runs in a worker process."""
    from manisdp_tpu_torch.frontends.sparse_moments import (
        bqpmom_sparse, bqpsos_sparse, clique_chain, sparse_objective_basis)
    n, cliques = clique_chain(t, q)
    nsp = sparse_objective_basis(n, cliques)
    nsp = nsp[:, ~np.all(nsp == 0, axis=0)]
    coe = np.random.RandomState(1).randn(nsp.shape[1])
    t0 = time.perf_counter()
    make = bqpmom_sparse if which == "mom" else bqpsos_sparse
    out = make(n, cliques, coe)
    return out, time.perf_counter() - t0


def start_host_builds(bqp_dir, phases):
    """Start the host builds the selected phases read (16-18: the raw q = 60
    bqpmom triplets and the chain's two relaxations; 22: the short chain;
    23: both relaxations of the short chain)
    in worker processes, one each (spawned, so they never touch the card);
    returns the pool (None when no phase needs one) and the pending
    results."""
    import multiprocessing
    builds = {}
    if 16 in phases:
        builds.update(bqpmom60=(build_bqpmom, (BQP_Q, bqp_dir)),
                      chain_mom=(build_chain, (CHAIN_T, CHAIN_Q, "mom")),
                      chain_sos=(build_chain, (CHAIN_T, CHAIN_Q, "sos")))
    if 22 in phases or 23 in phases:
        builds["chain5"] = (build_chain, (CHAIN5_T, CHAIN_Q, "mom"))
    if 23 in phases:
        builds["chain5_sos"] = (build_chain, (CHAIN5_T, CHAIN_Q, "sos"))
    if not builds:
        return None, {}
    pool = multiprocessing.get_context("spawn").Pool(len(builds))
    jobs = {name: pool.apply_async(fn, fargs)
            for name, (fn, fargs) in builds.items()}
    pool.close()
    return pool, jobs


def flat_slot_map(q):
    """frontends/moments.bqpmom row index -> SymMomOp flat slot index: the
    map of tests/test_symmom.py's _flat_slot_map, which a test holds this
    to, built without its monomial_basis(q, 4) loop.  The repeated-monomial
    rows follow that basis's label order: degree 2, 3, 4, and within a
    degree the squarefree supports in colex order (largest variable
    first), one row per pair and two per triple or quadruple."""
    from itertools import combinations
    q2, q3 = q * q, q ** 3
    bD2 = 1 + q
    bSv = bD2 + q2
    bSp = bSv + q2
    bE2 = bSp + q3
    bE4 = bE2 + q2
    bE6 = bE4 + q3

    def colex(k):
        c = np.array(list(combinations(range(q), k)),
                     dtype=np.int64).reshape(-1, k)
        return c[np.lexsort(c.T)].T           # last variable major

    pu, pv = colex(2)
    head = [np.arange(1 + q)]
    head.append(np.stack([bD2 + pu * q + pv, bD2 + pv * q + pu], 1).ravel())
    for k in range(q):
        b = np.delete(np.arange(q), k)
        keep = (pu != k) & (pv != k)
        head += [bSv + k * q + b, bSp + k * q2 + pu[keep] * q + pv[keep]]
    a, b, c = colex(3)
    a4, b4, c4, d4 = colex(4)
    eq = [bE2 + pu * q + pv,
          np.stack([bE4 + a * q2 + b * q + c,
                    bE4 + b * q2 + a * q + c], 1).ravel(),
          np.stack([bE6 + ((a4 * q + b4) * q + c4) * q + d4,
                    bE6 + ((b4 * q + a4) * q + c4) * q + d4], 1).ravel()]
    return np.concatenate(head + eq)


def phase_mom_kernels(mop64, N, device, seed):
    """K9 and K10 (plain, and with es_vals' fused base) at the expanded
    shape of ``mop64``, and K2's masked modes at the chain's (p_pad, N)
    shapes with a seeded half-oblique mask, f64 and f32, against their
    twins."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.symmom import dontcare_mask

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, n, m = mop64.q, mop64.n, mop64.m
    rows = []
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=device)
    M64, y64 = rnd(n, n), rnd(m)
    # K10 reads only the valid slots of y; every other slot is don't-care,
    # and holds NaN here: neither K10 nor its twin may let it through
    dc = torch.as_tensor(dontcare_mask(q), device=device)
    valid = m - int(torch.count_nonzero(dc))
    y64 = torch.where(dc, torch.full_like(y64, float("nan")), y64)
    k9 = (K.symmom_apply, K.symmom_apply_plain)
    k10 = (K.symmom_adjoint, K.symmom_adjoint_plain)
    q4 = float(q) ** 4
    for dt in (torch.float64, torch.float32):
        info = dict(dtype=str(dt)[6:], q=q, n=n, m=m)
        M, y, C = M64.to(dt), y64.to(dt), mop64.C.to(dt)
        yb = valid * y.element_size()
        for name, mode, (fn, twin), args, kw, reads, flops in (
                ("symmom_apply", "apply", k9, (M, q), {}, (M,), 12 * q4),
                ("symmom_adjoint", "adjoint", k10, (y, q), {}, (yb,),
                 40 * q4),
                ("symmom_adjoint", "es_vals", k10, (y, q),
                 dict(base=C, alpha=0.37), (yb, C), 42 * q4)):
            check_case(rows, name, mode, fn, twin, args, kw, tol[dt],
                       reads=reads, flops=flops, repeat=True, passes=True,
                       **info)
            if name == "symmom_apply":
                # every don't-care slot of A(M) exactly 0
                rows[-1]["dontcare_zero"] = not bool(
                    torch.any(fn(*args)[dc] != 0))
                if not rows[-1]["dontcare_zero"]:
                    raise AssertionError(f"K9 wrote a don't-care slot: "
                                         f"{rows[-1]}")
        del M, y, C
    del dc
    mask64 = (torch.rand(N, generator=gen, device=device) < 0.5).double()
    for dt in (torch.float64, torch.float32):
        mask = mask64.to(dt)
        for p in (8, 16, 24):
            info = dict(dtype=str(dt)[6:], p_pad=p, n=N)
            Y = K.oblique_cols_plain(rnd(p, N).to(dt), None, "renormalize",
                                     mask=mask)
            H, U, g = rnd(p, N).to(dt), rnd(p, N).to(dt), rnd(N).to(dt)
            for mode, args, kw, reads, flops in (
                    ("proj", (Y, H, "proj"), {}, (Y, H, mask), 4 * p * N),
                    ("proj_eG", (Y, H, "proj"), dict(v=U, g=g),
                     (Y, H, U, g, mask), 6 * p * N),
                    ("retr", (Y, H, "retr"), {}, (Y, H, mask), 5 * p * N),
                    ("renormalize", (Y, None, "renormalize"), {},
                     (Y, mask), 3 * p * N)):
                check_case(rows, "oblique_cols", f"masked_{mode}",
                           K.oblique_cols, K.oblique_cols_plain, args,
                           dict(kw, mask=mask), tol[dt], reads=reads,
                           flops=flops, repeat=True, **info)
        # K11 with the masked product's tangent projection (the chain's
        # tCG), p 8
        tcg_case(rows, (1, 8, N), dt, tol[dt], rnd, device, "step_proj_masked",
                 mask=mask)
    return rows


def mom_kkt_oracle_on_card(data, op, res, device):
    """Independent KKT check of a solve_bqp_mom result on the card, from the
    raw frontends/moments.bqpmom triplets (At over the original basis of
    n_orig columns, one row per reference constraint) and the returned
    (Y, y): X = Yoᵀ Yo with Yo the first copy of each original column, y
    read at the reference's rows through ``flat_slot_map``; pinf from
    A(X), the reference's certificate (ManiSDP_unitdiag.m:65-69:
    S = mat(c - Aᵀy) - diag(z), z = colsum(S ∘ X)) by f64 eigvalsh, gap
    from <C, X> and bᵀy + sum(z).  No SymMomOp method and no kernel is
    used."""
    import torch
    t0 = time.perf_counter()
    n = op.n_orig
    At = data.At.tocoo()
    f64 = dict(dtype=torch.float64, device=device)
    lin = torch.as_tensor(At.row.astype(np.int64), device=device)
    k = torch.as_tensor(At.col.astype(np.int64), device=device)
    v = torch.as_tensor(At.data, **f64)
    Yo = torch.as_tensor(res.Y, **f64)[:, op.dup0.long()]
    smap = torch.as_tensor(flat_slot_map(op.q), device=device)
    y = torch.as_tensor(res.y, **f64)[smap]
    b = torch.as_tensor(data.b, **f64)
    X = Yo.T @ Yo
    Xv = X.T.reshape(-1)                   # column-major vec
    Ax = torch.zeros(b.shape[0], **f64).index_add_(0, k, v * Xv[lin])
    pinf = float(torch.linalg.norm(Ax - b) / (1.0 + torch.linalg.norm(b)))
    diag_err = float(torch.max(torch.abs(torch.diagonal(X) - 1.0)))
    cnz = np.flatnonzero(data.c)
    S = torch.zeros(n * n, **f64)
    S[torch.as_tensor(cnz, device=device)] = torch.as_tensor(data.c[cnz],
                                                             **f64)
    obj = float(torch.dot(S, Xv))
    S.index_add_(0, lin, -v * y[k])
    S = S.reshape(n, n).T
    z = torch.sum(S * X, dim=0)
    by = float(torch.dot(b, y)) + float(torch.sum(z))
    gap = abs(obj - by) / (1.0 + abs(obj) + abs(by))
    S = S - torch.diag(z)
    wv = torch.linalg.eigvalsh(0.5 * (S + S.T))
    lam_min, lam_max = float(wv[0]), float(wv[-1])
    del S, X, Xv, Ax
    dinf = max(0.0, -lam_min) / (1.0 + abs(lam_max))
    torch.cuda.synchronize()
    return dict(pinf=pinf, dinf=dinf, gap=gap, eta=max(pinf, dinf, gap),
                diag_err=diag_err, obj=obj, by=by, lam_min=lam_min,
                lam_max=lam_max, m_true=int(b.shape[0]),
                seconds=time.perf_counter() - t0)


def mom_phases(args, device, mop60, Q60, e60, bqp_label, dual60_obj,
               raw60):
    """Phase 17: the BQP moment primal at q = 30 (against the JAX package's
    optimum) and q = 60 (against the SOS dual's objective, with the KKT
    oracle and one profiled repeat)."""
    from manisdp_tpu_torch.solvers.primal_mom import solve_bqp_mom

    out = {}
    Q30, e30, lab30 = bqp_instance(30, args.bqp)
    q30 = Q30.shape[0]
    kw30 = dict(inner_dtype="tcg32")
    r, res = solve_with_counts(
        "bqpmom30",
        lambda: solve_bqp_mom(Q30, e30, q30, device=device, verbose=False,
                              **kw30),
        device, instance=lab30, options=kw30)
    r["rel_to_jax"] = abs(res.obj - JAX_BQPMOM30) / abs(JAX_BQPMOM30) \
        if "stand-in" in lab30 else None
    emit(r)
    out["bqpmom30"] = r
    if r["rel_to_jax"] is not None and not r["rel_to_jax"] <= 1e-7:
        raise AssertionError(f"bqpmom30: {r['rel_to_jax']} from the JAX "
                             "optimum")
    q = Q60.shape[0]
    r, res = solve_with_counts(
        "bqpmom60",
        lambda: solve_bqp_mom(Q60, e60, q, device=device, verbose=False,
                              **BQP_PRIMAL_KW),
        device, instance=bqp_label, options=BQP_PRIMAL_KW,
        n_expanded=mop60.n, n_orig=mop60.n_orig, m_flat=mop60.m,
        m_true=mop60.m_true)
    r["rel_to_sos_dual"] = abs(res.obj - dual60_obj) / abs(dual60_obj)
    data60, raw_build_s = raw60
    r["oracle"] = dict(mom_kkt_oracle_on_card(data60, mop60, res, device),
                       raw_build_s=raw_build_s)
    emit(r)
    out["bqpmom60"] = r
    if not r["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"bqpmom60: oracle {r['oracle']}")
    if not r["rel_to_sos_dual"] <= 1e-6:
        raise AssertionError(f"bqpmom60: {r['rel_to_sos_dual']} from the "
                             "q = 60 SOS dual")
    for key in ("symmom_apply", "symmom_adjoint", "oblique_cols",
                "oa_refine"):
        if r["launches"][key] <= 0:
            raise AssertionError(f"the bqpmom60 solve never launched {key}")
    if r["symdual_modes"]["sym_factor"] <= 0:
        raise AssertionError("the bqpmom60 solve never launched K8 "
                             "sym_factor")
    _, prof = profile_breakdown(
        lambda: solve_bqp_mom(Q60, e60, q, device=device, verbose=False,
                              **BQP_PRIMAL_KW))
    prof = dict(phase="bqpmom60_profile", **prof)
    emit(prof)
    out["bqpmom60_profile"] = prof
    return out


def block_kkt_oracle_on_card(data, res, device):
    """Independent KKT check of a multiblock primal solve on the card, from
    the raw SeDuMi triplets (At (sum n_i^2, m), each block's column-major
    vec stacked; K.s, K.nob) and the returned (Y, y): X_i = Y_iᵀ Y_i per
    column group; pinf from A(X); z = colsum(S ∘ X) on the first nob
    (unit-diagonal) blocks, S = mat(c - Aᵀy) - diag(z) restricted to the
    block diagonal; dinf from f64 eigvalsh of each block; gap from <C, X>
    and bᵀy + sum(z).  No ConstraintOp and no kernel is used."""
    import torch
    t0 = time.perf_counter()
    ns = np.asarray(data.K.s, dtype=np.int64)
    nob = int(data.K.nob)
    off = np.concatenate([[0], np.cumsum(ns)])
    off2 = np.concatenate([[0], np.cumsum(ns ** 2)])
    N = int(off[-1])
    f64 = dict(dtype=torch.float64, device=device)

    def to_global(lin):
        bl = np.searchsorted(off2, lin, side="right") - 1
        loc = lin - off2[bl]
        return (torch.as_tensor(loc % ns[bl] + off[bl], device=device),
                torch.as_tensor(loc // ns[bl] + off[bl], device=device))

    At = data.At.tocoo()
    gi, gj = to_global(At.row.astype(np.int64))
    k = torch.as_tensor(At.col.astype(np.int64), device=device)
    v = torch.as_tensor(At.data, **f64)
    Y = torch.as_tensor(res.Y, **f64)
    y = torch.as_tensor(res.y, **f64)
    b = torch.as_tensor(data.b, **f64)
    X = Y.T @ Y
    Ax = torch.zeros(b.shape[0], **f64).index_add_(0, k, v * X[gi, gj])
    pinf = float(torch.linalg.norm(Ax - b) / (1.0 + torch.linalg.norm(b)))
    cnz = np.flatnonzero(data.c)
    ci, cj = to_global(cnz.astype(np.int64))
    cv = torch.as_tensor(data.c[cnz], **f64)
    obj = float(torch.sum(cv * X[ci, cj]))
    S = torch.zeros((N, N), **f64)
    S.index_put_((ci, cj), cv, accumulate=True)
    S.index_put_((gi, gj), -v * y[k], accumulate=True)
    mask = torch.zeros(N, **f64)
    mask[:int(off[nob])] = 1.0
    blocks = [slice(int(off[i]), int(off[i + 1])) for i in range(len(ns))]
    z = torch.cat([torch.sum(S[sl, sl] * X[sl, sl], dim=0)
                   for sl in blocks]) * mask
    by = float(torch.dot(b, y)) + float(torch.sum(z))
    gap = abs(obj - by) / (1.0 + abs(obj) + abs(by))
    S.diagonal().sub_(z)
    dinf, lam_min = 0.0, np.inf
    for sl in blocks:
        Sb = S[sl, sl]
        wv = torch.linalg.eigvalsh(0.5 * (Sb + Sb.T))
        lam_min = min(lam_min, float(wv[0]))
        dinf = max(dinf, max(0.0, -float(wv[0])) / (1.0 + abs(float(wv[-1]))))
    del S, X
    torch.cuda.synchronize()
    return dict(pinf=pinf, dinf=dinf, gap=gap, eta=max(pinf, dinf, gap),
                obj=obj, by=by, lam_min=lam_min,
                seconds=time.perf_counter() - t0)


def chain_phases(device, chain_mom, chain_sos):
    """Phase 18: the clique chain through both multiblock drivers."""
    import torch
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    from manisdp_tpu_torch.solvers.dual_multiblock import \
        solve_dual_multiblock
    from manisdp_tpu_torch.solvers.multiblock import solve_multiblock

    label = (f"examples/example_bqp_sparse.py: clique_chain({CHAIN_T}, "
             f"{CHAIN_Q}), RandomState(1) objective")
    data, mom_build_s = chain_mom
    ns = [int(s) for s in data.K.s]
    t0 = time.perf_counter()
    op = ConstraintOp.build_multiblock(data.At, data.b, data.c, ns, device)
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    r, res = solve_with_counts(
        "chain_primal",
        lambda: solve_multiblock(op, None, None, ns=ns, nob=data.K.nob,
                                 device=device, verbose=False,
                                 **CHAIN_PRIMAL_KW),
        device, instance=label, options=CHAIN_PRIMAL_KW, blocks=len(ns),
        N=op.n, m=op.m, nnzA=op.nnz, instance_build_s=mom_build_s,
        assemble_s=assemble_s)
    r["oracle"] = block_kkt_oracle_on_card(data, res, device)
    emit(r)
    if not r["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"chain primal: oracle {r['oracle']}")
    for key in ("pattern_dots", "csr_gather"):
        if r["launches"][key] <= 0:
            raise AssertionError(f"the chain primal never launched {key}")
    if r["spmm_modes"]["al_hess"] <= 0 or r["oblique_modes"]["masked"] <= 0:
        raise AssertionError("the chain primal never launched K1 al_hess "
                             "or K2's masked mode")
    primal = r
    (A, b, c, mbs, f, dAAt), sos_build_s = chain_sos
    maxb = float(np.max(np.abs(b)))
    r, res = solve_with_counts(
        "chain_dual",
        lambda: solve_dual_multiblock(A, b / maxb, c, ns=mbs, nob=len(mbs),
                                      f=f, dAAt=dAAt, device=device,
                                      verbose=False),
        device, instance=label, blocks=len(mbs), m=int(A.shape[0]),
        nnzA=int(A.nnz), f=int(f), instance_build_s=sos_build_s)
    r["obj_unscaled"] = res.obj * maxb
    r["rel_to_primal"] = abs(res.obj * maxb - primal["obj"]) / \
        max(1.0, abs(primal["obj"]))
    emit(r)
    if not r["rel_to_primal"] <= 1e-6:
        raise AssertionError(f"chain: primal {primal['obj']} and dual "
                             f"{r['obj_unscaled']} disagree")
    if r["launches"]["csr_gather"] <= 0 or \
            r["oblique_modes"]["masked"] <= 0:
        raise AssertionError("the chain dual never launched K4 or K2's "
                             "masked mode")
    return dict(primal=primal, dual=r)


def two_block_phase(device):
    """Phase 19: solve_sedumi on the two-block moment relaxation of a
    quartic over two spheres sharing a variable, held to its SOS dual's
    optimum through solve_dual_multiblock."""
    from manisdp_tpu_torch import solve_sedumi
    from manisdp_tpu_torch.frontends.sparse_moments import (
        qsmom_sparse, qssos_sparse, sparse_quartic_basis)
    from manisdp_tpu_torch.solvers.dual_multiblock import \
        solve_dual_multiblock

    N = 2 * QS2_K - 1
    cliques = [list(range(QS2_K)), list(range(QS2_K - 1, N))]
    coe = np.random.RandomState(0).randn(
        sparse_quartic_basis(N, cliques).shape[1])
    data = qsmom_sparse(N, cliques, coe)
    label = (f"quartic over two spheres, cliques {QS2_K} + {QS2_K} sharing "
             "one variable (RandomState(0))")
    r, res = solve_with_counts(
        "two_block_sedumi",
        lambda: solve_sedumi(data, device=device, verbose=False,
                             **QS2_PRIMAL_KW),
        device, instance=label, options=QS2_PRIMAL_KW,
        ns=[int(s) for s in data.K.s], m=int(data.b.shape[0]))
    A, b, c, mbs, f, dAAt = qssos_sparse(N, cliques, coe)
    maxb = float(np.max(np.abs(b)))
    rd, resd = solve_with_counts(
        "two_block_sos_dual",
        lambda: solve_dual_multiblock(A, b / maxb, c, ns=mbs, nob=0, f=f,
                                      dAAt=dAAt, device=device,
                                      verbose=False, **QS2_DUAL_KW),
        device, instance=label, options=QS2_DUAL_KW)
    r["sos_dual"] = dict(obj=resd.obj * maxb, status=resd.status,
                         eta=resd.eta, seconds=rd["seconds"])
    r["rel_to_sos_dual"] = abs(res.obj - resd.obj * maxb) / \
        max(1.0, abs(res.obj))
    emit(r)
    if not r["rel_to_sos_dual"] <= 1e-6:
        raise AssertionError(f"two-block: primal {res.obj} and SOS dual "
                             f"{resd.obj * maxb} disagree")
    if r["oblique_modes"]["masked"] <= 0:
        raise AssertionError("the two-block solve never launched K2's "
                             "masked mode")
    return r


def batch_graphs():
    """Phase 21's instances: 16 G1-size stand-ins (dense bucket of 1,024)
    and, sparse and ragged, 8 toroidal +-1 grids of G48's shape (60 x 50,
    n = 3,000, bucket 3,072) and 4 of 50 x 50 (n = 2,500, bucket 2,560)."""
    dense = [g1_standin(s) for s in range(BATCH_DENSE)]
    sparse = [torus_standin(*BATCH_GRID, s) for s in range(BATCH_GRID_B)] + \
        [torus_standin(*BATCH_GRID2, s) for s in range(BATCH_GRID2_B)]
    return dense, sparse


def tcg_case(rows, shape, dt, tol, rnd, device, mode, mask=None):
    """K11 (``kernels.tcg_step``) against its twin at one (B, p, n) shape:
    a CG start (d = r, z_r = <r, r>, an SPD-like Hd, the first trust
    region of an oblique solve, (pi sqrt(n) / 8)^2), mode "step" without
    the tangent projection, "step_proj*" with it (Y a point of unit
    columns; ``mask`` the masked product's).  The bound counts one read of
    d, Hd, eta, Heta, r (and Y, mask) and one write of eta, Heta, r, d."""
    import torch
    from manisdp_tpu_torch import kernels as K
    r = rnd(*shape).to(dt)
    Hd = r * (1.0 + rnd(*shape).abs().to(dt))
    eta, Heta = rnd(*shape).to(dt), rnd(*shape).to(dt)
    r_r = torch.sum(r * r, dim=(1, 2))
    z = torch.zeros_like(r_r)
    sc = torch.stack([z, z, r_r, r_r, z, z + np.pi ** 2 * shape[2] / 64, z,
                      z + 1], 1)
    st = torch.zeros((shape[0], 2), dtype=torch.int32, device=device)
    Y = None
    if mode != "step":
        Y = K.oblique_cols_plain(rnd(*shape).to(dt), None, "renormalize",
                                 mask=mask)
    vecs = (r, Hd, eta, Heta, r)

    def fresh(vecs=vecs):
        return tuple(t.clone() for t in vecs) + (sc, st, 1, Y, mask)

    L = shape[0] * shape[1] * shape[2]
    check_case(rows, "tcg_step", mode, K.tcg_step, K.tcg_step_plain,
               fresh(), {}, tol, reads=(r, Hd, eta, Heta, r, sc, st, Y,
                                        mask),
               flops=(14.0 + (4.0 if Y is not None else 0.0)) * L,
               fresh=fresh, per_output=True, repeat=True,
               dtype=str(dt)[6:], p_pad=shape[1], n=shape[2],
               instances=shape[0])


def tcg_iteration_ms(Cs, Ys, p_pad, n_pad, dtype, device, reps=40):
    """Host and device ms per tCG iteration of the MaxCut RTR at the
    solved points ``Ys`` (numpy (p_i, n_i) factors of solve_maxcut_unitdiag
    or solve_maxcut_batch) of the costs ``Cs`` (scipy): one instance, the
    single solve's tCG (a SymCOO; float32 is the solve's tcg32), several,
    the batch's (a BatchedSymCOO, float64), each factor zero-padded to
    ``p_pad`` rows and, in the batch, to ``n_pad`` columns with unit
    padding columns.  Host: the Python loop body (the Hessian, K11 and,
    where it is a separate launch, the tangent projection, with their
    wrappers and the torch ops between them), timed while a spin kernel
    holds the card, so no call waits for it; device: CUDA events around
    the same calls, which the card runs back to back after the spin.
    Each is the difference of a tCG call of _TCG_CHUNK iterations (which
    reads nothing back inside; mininner = _TCG_CHUNK) and one of 0, over
    _TCG_CHUNK, from the medians of ``reps`` calls (the host's also from
    the fastest call: the host's clock moves with its neighbours' load);
    ``iterations`` says how many iterations each instance ran before a
    stop.  Uses only core.trustregions._make_tcg, so it
    times any tree's package."""
    import torch
    from manisdp_tpu_torch.core import TROptions
    from manisdp_tpu_torch.core import trustregions as TRm
    from manisdp_tpu_torch.ops.sparse import BatchedSymCOO, SymCOO
    from manisdp_tpu_torch.solvers.maxcut import make_maxcut_problem
    chunk = TRm._TCG_CHUNK
    problem = make_maxcut_problem(False)
    B = len(Cs)
    Y = np.zeros((B, p_pad, n_pad))
    for b, Yb in enumerate(Ys):
        Y[b, :Yb.shape[0], :Yb.shape[1]] = Yb
        Y[b, 0, Yb.shape[1]:] = 1.0
    Y = torch.as_tensor(Y, device=device)
    if B == 1:
        C = SymCOO.from_scipy(Cs[0], device)
        Y = Y[0]
        low = dtype == torch.float32
    else:
        C = BatchedSymCOO.from_scipy(Cs, n_pad, device)
        low = False
    _, aux = problem.cost(Y, C)
    g, gaux = problem.grad(Y, C, aux)
    params = C.astype(torch.float32) if low else C
    Delta = torch.tensor(np.pi * np.sqrt(n_pad) / 8, dtype=torch.float64,
                         device=device)
    extra = ()
    if B > 1:
        Delta = Delta.expand(B).clone()
        extra = (torch.ones(B, dtype=torch.bool, device=device),)
    tcgs = {k: TRm._make_tcg(problem, TROptions(
        maxinner=k, mininner=max(k, 1),
        tcg_dtype="float32" if low else None), batched=B > 1)
        for k in (0, chunk)}

    def call(k):
        return tcgs[k](Y, g, Delta, params, aux, gaux, *extra)

    for k in (0, chunk):
        call(k)
    torch.cuda.synchronize()
    host, host_min, dev = {}, {}, {}
    for k in (0, chunk):
        hs, ds = [], []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(40_000_000)       # ~20 ms at H100 clocks
            a.record()
            t0 = time.perf_counter()
            out = call(k)
            hs.append((time.perf_counter() - t0) * 1e3)
            b.record()
            b.synchronize()
            ds.append(a.elapsed_time(b))
        host[k], dev[k] = statistics.median(hs), statistics.median(ds)
        host_min[k] = min(hs)
    iters = out[2].reshape(-1).tolist()
    return dict(shape=[B, p_pad, n_pad], dtype=str(dtype)[6:],
                host_ms=(host[chunk] - host[0]) / chunk,
                host_min_ms=(host_min[chunk] - host_min[0]) / chunk,
                device_ms=(dev[chunk] - dev[0]) / chunk,
                iterations=iters, chunk=chunk)


def phase_batch_kernels(C_b, device, seed):
    """Phase 20: K1's instance mode and K2 with the instance stride at the
    sparse batch's shape (8 instances, n_pad = 3,072, f64), and K11 in f64
    and f32 there and at B = 1 with the G67 shape."""
    import scipy.sparse as sp
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.sparse import BatchedSymCOO

    n = BATCH_N_PAD
    C = BatchedSymCOO.from_scipy(C_b, n, device)
    B = C.nb
    blocks = []
    for M in C_b:
        c = sp.coo_matrix(0.5 * (M + M.T))
        blocks.append(sp.coo_matrix((c.data, (c.row, c.col)), shape=(n, n)))
    bd = sp.block_diag(blocks, format="csr")
    BD = csr(*(torch.as_tensor(a, device=device) for a in
               (bd.indptr.astype(np.int64), bd.indices.astype(np.int64),
                bd.data)), bd.shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=device)
    rows = []
    Cr = (C.i, C.colptr, C.v)
    nnz = int(C.i.shape[0])
    for p in BATCH_P_PADS:
        Y = K.oblique_cols_plain(rnd(B, p, n), None, "renormalize")
        U = K.oblique_cols_plain(Y, rnd(B, p, n), "proj")
        eG = K.symcoo_spmm_plain(Y, C, "cost")[1]
        Yt = Y.transpose(1, 2).reshape(B * n, p).contiguous()
        Yu = Y + U
        fl = 2.0 * nnz * p
        cases = [
            ("symcoo_spmm", "instance_plain", (Y, C, "plain"), {},
             (Y, *Cr), fl, lambda: torch.sparse.mm(BD, Yt)),
            ("symcoo_spmm", "instance_cost", (Y, C, "cost"), {}, (Y, *Cr),
             fl + 2 * B * p * n, None),
            ("symcoo_spmm", "instance_hess", (U, C, "hess"),
             dict(B=Y, eG=eG), (U, *Cr, Y, eG), fl + 6 * B * p * n, None),
            ("oblique_cols", "instance_proj", (Y, U, "proj"), {}, (Y, U),
             4 * B * p * n, None),
            ("oblique_cols", "instance_retr", (Y, U, "retr"), {}, (Y, U),
             5 * B * p * n, None),
            ("oblique_cols", "instance_renormalize",
             (Yu, None, "renormalize"), {}, (Yu,), 3 * B * p * n, None),
        ]
        for name, mode, args, kw, reads, flops, lib in cases:
            k1 = name == "symcoo_spmm"
            check_case(rows, name, mode, getattr(K, name),
                       getattr(K, f"{name}_plain"), args, kw, 1e-12,
                       reads=reads, flops=flops, library=lib, repeat=k1,
                       passes=k1, dtype="float64", p_pad=p, n=n,
                       instances=B, nnz=nnz)
    for shape in ((B, BATCH_P_PADS[-1], n), (1, HOT_P_PAD, 10 ** 4)):
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for mode in ("step", "step_proj"):
                tcg_case(rows, shape, dt, tol, rnd, device, mode)
    return rows


def run_batch(Cs, device):
    """One solve_maxcut_batch call (p0 = 40, as phases 4-5), with seconds,
    peak device memory and the launch counters of that run."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import solve_maxcut_batch
    K.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve_maxcut_batch(Cs, p0=40, device=device, verbose=False)
    torch.cuda.synchronize()
    return res, dict(seconds=time.perf_counter() - t0,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                     launches=dict(K.LAUNCHES),
                     instance_launches=dict(K.INSTANCE_LAUNCHES),
                     tcg_launches=dict(K.TCG_LAUNCHES),
                     oblique_modes=dict(K.OBLIQUE_LAUNCHES))


def check_tcg_launches(label, run):
    """K11 ran one launch per tCG iteration of an oblique solve and
    projected every next direction itself: no separate K2 ``proj`` launch
    is left in the tCG loop (the solve's other proj calls, one or two per
    outer RTR iteration, stay below a tenth of the steps)."""
    tl, steps = run["tcg_launches"], run["launches"]["tcg_step"]
    if not (steps > 0 and tl["projected"] == steps):
        raise AssertionError(f"{label}: K11 launches {tl}, {steps} steps")
    proj = run.get("oblique_modes", {}).get("proj")
    if proj is not None and not proj < steps / 10:
        raise AssertionError(f"{label}: {proj} K2 proj launches against "
                             f"{steps} tCG steps")


def batch_phase(label, Cs, source, device, repeat=False, tcg_shape=None):
    """Phase 21, one group: the batch solve, an on-card KKT oracle for
    every instance, each instance's single solve (the objectives must
    agree to 1e-6), and with ``repeat`` a second batch solve that must give
    bit-equal objectives and iteration counts."""
    import torch
    from manisdp_tpu_torch import solve_maxcut_unitdiag
    res, run = run_batch(Cs, device)
    buckets = {}
    table = []
    single_s = 0.0
    for C, r in zip(Cs, res):
        n = C.shape[0]
        buckets.setdefault(int(-(-n // 256) * 256), r.time)
        oracle = kkt_oracle_on_card(C, r, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = solve_maxcut_unitdiag(C, p0=40, device=device,
                                       verbose=False)
        torch.cuda.synchronize()
        single_s += time.perf_counter() - t0
        table.append(dict(n=n, status=r.status, eta=r.eta,
                          oracle_eta=oracle["eta"], obj=r.obj,
                          single_obj=single.obj,
                          rel_to_single=abs(r.obj - single.obj) /
                          max(1.0, abs(single.obj)),
                          outer=r.iterations, hess_calls=r.hess_calls,
                          fac_size=r.fac_size[-1]))
    out = dict(phase=label, source=source, instances=len(Cs), **run,
               bucket_seconds=buckets, timers=res[0].timers,
               seconds_per_instance=run["seconds"] / len(Cs),
               single_seconds=single_s,
               single_seconds_per_instance=single_s / len(Cs),
               table=table)
    if tcg_shape is not None:
        B, p_pad, n_pad = tcg_shape
        out["tcg_iteration"] = tcg_iteration_ms(
            Cs[:B], [r.Y for r in res[:B]], p_pad, n_pad, torch.float64,
            device)
    if repeat:
        res2, run2 = run_batch(Cs, device)
        out["repeat"] = dict(
            seconds=run2["seconds"],
            bit_equal=all(a.obj == b.obj and a.iterations == b.iterations
                          and a.hess_calls == b.hess_calls
                          for a, b in zip(res, res2)))
    emit(out)
    for t in table:
        if t["status"] != 0 or not t["eta"] <= 1e-8 or \
                not t["oracle_eta"] <= 1e-8 or \
                not t["rel_to_single"] <= 1e-6:
            raise AssertionError(f"{label}: instance {t}")
    if run["instance_launches"]["oblique_cols"] <= 0:
        raise AssertionError(f"{label} never launched K2's instance mode")
    check_tcg_launches(label, run)
    if repeat and not out["repeat"]["bit_equal"]:
        raise AssertionError(f"{label}: the repeated batch solve differs")
    return out


def chain_repeat_phase(device, chain5):
    """Phase 22: clique_chain(5, 20) through solve_multiblock twice on one
    card; the two histories must be equal (its reductions use no float
    atomics)."""
    import torch
    from manisdp_tpu_torch.solvers.multiblock import solve_multiblock
    data, build_s = chain5
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_multiblock(data.At, data.b, data.c, ns=data.K.s,
                               nob=data.K.nob, device=device, verbose=False,
                               **CHAIN_PRIMAL_KW)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0))
    (r1, s1), (r2, s2) = runs
    equal = (r1.obj == r2.obj and r1.iterations == r2.iterations and
             r1.history == r2.history)
    out = dict(phase="chain5_repeat",
               instance=f"clique_chain({CHAIN5_T}, {CHAIN_Q}), "
               "RandomState(1) objective", instance_build_s=build_s,
               seconds=[s1, s2], status=[r1.status, r2.status],
               obj=[r1.obj, r2.obj], outer=[r1.iterations, r2.iterations],
               histories_equal=equal)
    emit(out)
    if r1.status != 0 or not equal:
        raise AssertionError(f"chain5: not repeatable: {out}")
    return out


def cert_call_ms(kind, mv64, mv32, n, k, Ydefl, opt, device):
    """The certificate at a solve's final point with its f32 stage
    (``mv32``) and without it: ``cold``, from a random start with the
    first call's budget (lobpcg_maxiter); ``warm``, from the cold f64
    call's vectors with the warm budget (lobpcg_maxiter_warm), as the
    driver calls it after its first outer iteration.  ``kind`` "lobpcg"
    is ops/eigs.lobpcg_certificate (then lobpcg_refine f64 iterations);
    "rowrr" the drivers' DeviceCertSolver with the linear bound (one
    budget for both stages).  Each call is timed once, host clock around
    a synchronize."""
    import torch
    from manisdp_tpu_torch.ops.eigs import lobpcg_certificate
    from manisdp_tpu_torch.ops.eigs_rr import DeviceCertSolver

    def call(mv32_or_none, X0, maxiter):
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        info = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "lobpcg":
            res = lobpcg_certificate(
                mv64, n, k, gen, maxiter=maxiter, deflate=Ydefl, X0=X0,
                matvec32=mv32_or_none, refine_iters=opt.lobpcg_refine,
                info=info)
        else:
            solver = DeviceCertSolver(
                n, k, deflate_rows=0 if Ydefl is None else Ydefl.shape[0],
                bound="linear")
            res = solver.solve(mv64, gen, X0=X0, Ydefl=Ydefl,
                               maxiter=maxiter, tol=opt.cert_inner_tol,
                               matvec32_rows=mv32_or_none)
            info = solver.last
        lam_min, lam_max = float(res.lam_min), float(res.lam_max)
        torch.cuda.synchronize()
        return res, dict(
            ms=(time.perf_counter() - t0) * 1e3, iters=int(info["iters"]),
            iters32=int(info.get("iters32", 0)),
            iters64=int(info.get("iters64", info["iters"])),
            resid=float(info["resid"]), lam_min=lam_min, lam_max=lam_max,
            dinf=max(0.0, -lam_min) / (1.0 + abs(lam_max)))

    out, X0 = {}, None
    for start, maxiter in (("cold", opt.lobpcg_maxiter),
                           ("warm", opt.lobpcg_maxiter_warm)):
        res64, f64 = call(None, X0, maxiter)
        _, f32 = call(mv32, X0, maxiter)
        out[start] = dict(f32=f32, f64=f64,
                          f32_over_f64=f32["ms"] / f64["ms"])
        X0 = res64.neg_vecs
    return out


def f32_solve(label, call, ref, rtol, device, oracle, needs=(), cert=None,
              **extra):
    """One phase-23 solve through solve_with_counts, held to ``ref``
    (dict(obj=..., source=...), the objective of the path without the f32
    stage) to ``rtol`` relative and to ``oracle(res)``'s eta <= 1e-8;
    ``needs``: kernels that must have launched in f32 in this solve;
    ``cert(res)``: the certificate call with and without its f32 stage at
    the final point (cert_call_ms)."""
    r, res = solve_with_counts(label, call, device, **extra)
    r["ref"] = ref
    r["rel_to_ref"] = abs(res.obj - ref["obj"]) / abs(ref["obj"])
    r["oracle"] = oracle(res)
    if cert is not None:
        r["cert_call"] = cert(res)
    emit(r)
    if not r["rel_to_ref"] <= rtol:
        raise AssertionError(f"{label}: objective {res.obj} is "
                             f"{r['rel_to_ref']} from {ref}")
    if not r["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"{label}: KKT oracle {r['oracle']}")
    for name in needs:
        if r["f32_launches"][name] <= 0:
            raise AssertionError(f"{label}: {name} never launched in f32")
    return r, res


def f32_phases(args, device, rec, keep, jobs):
    """Phase 23: the options that run whole RTR solves or LOBPCG stages in
    float32 (``inner_dtype="mixed"``, ``cert_method="lobpcg"``,
    ``cert_pre_dtype``), each held to the objective of its phase's f64
    path (taken from that phase when it ran, else solved here) and to its
    phase's on-card oracle.  ``keep`` holds the instances earlier phases
    built (rebuilt here when they did not run)."""
    import torch
    from manisdp_tpu_torch import (solve_dual_unitdiag, solve_maxcut_unitdiag,
                                   solve_sdp, solve_sedumi)
    from manisdp_tpu_torch.config import merged_options
    from manisdp_tpu_torch.frontends.sos import assemble_bqpsos
    from manisdp_tpu_torch.kernels import symcoo_spmm
    from manisdp_tpu_torch.ops.dualops import DualOp
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    from manisdp_tpu_torch.solvers.dual_multiblock import \
        solve_dual_multiblock
    from manisdp_tpu_torch.solvers.dual_unitdiag import solve_bqp_sos_dual
    from manisdp_tpu_torch.solvers.maxcut import _symcoo
    from manisdp_tpu_torch.solvers.multiblock import solve_multiblock

    t_phase = time.perf_counter()
    f64 = dict(dtype=torch.float64, device=device)
    out = {}

    def reference(found, label, solve):
        """The objective of the path without the f32 stage: ``found`` (its
        phase's record), else one solve here with that phase's options."""
        if found is not None:
            return dict(obj=found, source=f"phase {label}")
        t0 = time.perf_counter()
        res = solve()
        if res.status != 0:
            raise AssertionError(f"reference of phase {label}: status "
                                 f"{res.status}")
        return dict(obj=res.obj, source=f"phase {label}'s options, "
                    "solved in phase 23", seconds=time.perf_counter() - t0)

    # -- G67 stand-in: mixed, then lobpcg with the f32 stage --
    C67, src67 = load_graph("G67", args.gset, args.seed)
    ref = reference(rec.get("g67", {}).get("obj"), "5",
                    lambda: solve_maxcut_unitdiag(
        C67, p0=40, device=device, verbose=False))
    g67_oracle = lambda res: kkt_oracle_on_card(C67, res, device)  # noqa
    out["g67_mixed"], _ = f32_solve(
        "G67_mixed", lambda: solve_maxcut_unitdiag(
            C67, p0=40, device=device, verbose=False, inner_dtype="mixed"),
        ref, 1e-7, device, g67_oracle,
        needs=("symcoo_spmm", "oblique_cols", "tcg_step"), instance=src67,
        options=dict(p0=40, inner_dtype="mixed"))
    kw_lob = dict(p0=40, cert_method="lobpcg", cert_pre_dtype="float32")
    opt = merged_options("maxcut_unitdiag", **kw_lob)
    Cs = _symcoo(C67, device)
    Cs32 = Cs.astype(torch.float32)

    def g67_cert(res):
        Y = torch.as_tensor(res.Y, **f64)
        z = Cs.quad_cols(Y)
        z32 = z.to(torch.float32)
        return cert_call_ms(
            "lobpcg", lambda V: symcoo_spmm(V, Cs, "shift", z=z),
            lambda V: symcoo_spmm(V, Cs32, "shift", z=z32), Cs.n,
            opt.delta + 1, Y, opt, device)
    out["g67_lobpcg"], _ = f32_solve(
        "G67_lobpcg_f32", lambda: solve_maxcut_unitdiag(
            C67, device=device, verbose=False, **kw_lob),
        ref, 1e-7, device, g67_oracle, needs=("symcoo_spmm",),
        cert=g67_cert, instance=src67, options=kw_lob)
    if out["g67_lobpcg"]["spmm_modes"]["shift"] <= 0:
        raise AssertionError("the G67 lobpcg solve never launched K1 shift")
    del Cs, Cs32

    # -- mc-12000 through solve_sdp with the mixed pre-stage --
    if "mc12000" in keep:
        data, op_mc = keep["mc12000"]
    else:
        data, _ = mc_instance(MC)
        op_mc = ConstraintOp.build(data.At, data.b, data.c, int(data.K.s),
                                   device)
    n = int(data.K.s)
    ref = reference(rec.get("mc12000", {}).get("obj"), "7", lambda: solve_sdp(
        op_mc, data.b, data.c, n, device=device, verbose=False,
        **mc_options()))
    kw = dict(mc_options(), inner_dtype="mixed")
    out["mc12000_mixed"], _ = f32_solve(
        "mc12000_mixed", lambda: solve_sdp(op_mc, data.b, data.c, n,
                                           device=device, verbose=False,
                                           **kw),
        ref, 1e-6, device,
        lambda res: al_kkt_oracle_on_card(data, res, device),
        needs=("pattern_dots", "csr_gather", "symcoo_spmm"), instance=MC,
        options=kw)
    del data, op_mc

    # -- mc-4000 through solve_sedumi with rowrr (its f32 stage at "auto")
    if "mc4000" in keep:
        data4 = keep.pop("mc4000")
    else:
        data4, _ = mc_instance(MC4)
    ref = reference(
        rec["mc4000"]["entrywise"]["obj"] if "mc4000" in rec else None, "9",
        lambda: solve_sedumi(data4, device=device, verbose=False,
                             **mc_options()))
    kw = dict(mc_options(), cert_method="rowrr")
    opt = merged_options("general", **kw)

    def mc4_cert(res):
        S = torch.as_tensor(res.S, **f64)
        S32 = S.to(torch.float32)
        return cert_call_ms("rowrr", lambda V: V @ S, lambda V: V @ S32,
                            S.shape[0], opt.delta + 1,
                            torch.as_tensor(res.Y, **f64), opt, device)
    out["mc4000_rowrr"], _ = f32_solve(
        "mc4000_rowrr", lambda: solve_sedumi(data4, device=device,
                                             verbose=False, **kw),
        ref, 1e-6, device,
        lambda res: al_kkt_oracle_on_card(data4, res, device),
        needs=("masked_sym",), cert=mc4_cert, instance=MC4, options=kw)
    del data4

    # -- bqp-q60: expanded with the mixed pre-stage; original basis with
    #    rowrr (f32 stage at "auto") and lobpcg with the f32 stage --
    if "bqp60" in keep:
        Q, e, data60, dop60, bqp_label = keep.pop("bqp60")
    else:
        Q, e, bqp_label = bqp_instance(BQP_Q, args.bqp)
        data60 = assemble_bqpsos(Q, e, BQP_Q)
        A, b, c, mb, f, dAAt = data60
        dop60 = DualOp.build(A, b / np.max(np.abs(b)), c, mb, f, dAAt,
                             device=device)
    q = Q.shape[0]
    ref = reference(
        rec["dual"]["bqp60_expanded"]["obj"] if "dual" in rec else None,
        "13", lambda: solve_bqp_sos_dual(Q, e, q, device=device,
                                         verbose=False, **BQP_KW))
    kw = dict(BQP_KW, inner_dtype="mixed")

    def expanded_oracle(res):
        wv = torch.linalg.eigvalsh(torch.as_tensor(res.X, **f64))
        lam_min, lam_max = float(wv[0]), float(wv[-1])
        dinf = max(0.0, -lam_min) / (1.0 + abs(lam_max))
        return dict(dinf=dinf, eta=dinf, lam_min=lam_min, lam_max=lam_max)
    out["bqp60_expanded_mixed"], _ = f32_solve(
        "bqp60_expanded_mixed", lambda: solve_bqp_sos_dual(
            Q, e, q, device=device, verbose=False, **kw),
        ref, 1e-6, device, expanded_oracle,
        needs=("symdual_apply", "symdual_adjoint", "oblique_cols"),
        instance=bqp_label, options=kw)
    A, b, c, mb, f, dAAt = data60
    maxb = float(np.max(np.abs(b)))
    ref = dict(ref, obj=ref["obj"] / maxb, unscaled=ref["obj"])
    for name, extra in (("rowrr", dict(cert_method="rowrr")),
                        ("lobpcg", dict(cert_method="lobpcg",
                                        cert_pre_dtype="float32"))):
        kw = dict(line_search=True, inner_dtype="tcg32", **extra)
        opt = merged_options("dual_unitdiag", **kw)

        def orig_cert(res, kind=name):
            X = torch.as_tensor(res.X, **f64)
            X32 = X.to(torch.float32)
            return cert_call_ms(kind, lambda V: V @ X, lambda V: V @ X32,
                                mb, opt.delta + 1, None, opt, device)
        out[f"bqp60_original_{name}"], _ = f32_solve(
            f"bqp60_original_{name}", lambda: solve_dual_unitdiag(
                dop60, None, None, mb, device=device, verbose=False, **kw),
            ref, 1e-6, device,
            lambda res: dual_kkt_oracle_on_card(A, b / maxb, c, mb, f, res,
                                                device),
            needs=("csr_gather",), cert=orig_cert, instance=bqp_label,
            options=kw)
    del dop60, data60

    # -- chain-t5 through both multiblock drivers with the mixed stage --
    (data, _), ((A, b, c, mbs, f, dAAt), _) = (jobs["chain5"].get(),
                                              jobs["chain5_sos"].get())
    ns = [int(s) for s in data.K.s]
    kw = dict(CHAIN_PRIMAL_KW, inner_dtype="mixed")
    label = f"clique_chain({CHAIN5_T}, {CHAIN_Q}), RandomState(1) objective"
    ref = reference(
        rec["chain5"]["obj"][0] if "chain5" in rec else None, "22",
        lambda: solve_multiblock(data.At, data.b, data.c, ns=ns,
                                 nob=data.K.nob, device=device,
                                 verbose=False, **CHAIN_PRIMAL_KW))
    out["chain5_primal_mixed"], rp = f32_solve(
        "chain5_primal_mixed", lambda: solve_multiblock(
            data.At, data.b, data.c, ns=ns, nob=data.K.nob, device=device,
            verbose=False, **kw),
        ref, 1e-6, device,
        lambda res: block_kkt_oracle_on_card(data, res, device),
        needs=("pattern_dots", "csr_gather", "symcoo_spmm", "oblique_cols"),
        instance=label, options=kw)
    maxb = float(np.max(np.abs(b)))
    out["chain5_dual_mixed"], rd = solve_with_counts(
        "chain5_dual_mixed", lambda: solve_dual_multiblock(
            A, b / maxb, c, ns=mbs, nob=len(mbs), f=f, dAAt=dAAt,
            device=device, verbose=False, inner_dtype="mixed"),
        device, instance=label, options=dict(inner_dtype="mixed"))
    r = out["chain5_dual_mixed"]
    r["obj_unscaled"] = rd.obj * maxb
    r["rel_to_primal"] = abs(rd.obj * maxb - rp.obj) / max(1.0, abs(rp.obj))
    emit(r)
    if not r["rel_to_primal"] <= 1e-6:
        raise AssertionError(f"chain5 mixed: primal {rp.obj} and dual "
                             f"{r['obj_unscaled']} disagree")
    for name in ("csr_gather", "oblique_cols"):
        if r["f32_launches"][name] <= 0:
            raise AssertionError(f"chain5 dual mixed: {name} never "
                                 "launched in f32")
    out["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="f32_options", seconds=out["seconds"],
              solves={k: dict(status=v["status"], seconds=v["seconds"],
                              rel_to_ref=v.get("rel_to_ref",
                                               v.get("rel_to_primal")))
                      for k, v in out.items() if isinstance(v, dict)}))
    return out


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) /
                 max(float(np.max(np.abs(ref))), 1e-300))


def _digest(*arrays):
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def shard_inputs(op, device, seed):
    """Phase 24b's protocol inputs at mc-12000 (a (SHARD_P, n) factor Y, a
    tangent U, w (m,), V (n, SHARD_K), eG (n,)) and the unsharded
    operator's outputs on them in f64 and f32, as host arrays."""
    import torch
    from manisdp_tpu_torch import kernels as K
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=device)
    Y = K.oblique_cols_plain(rnd(SHARD_P, op.n), None, "renormalize")
    U = K.oblique_cols_plain(Y, rnd(SHARD_P, op.n), "proj")
    ins = dict(Y=Y, U=U, w=rnd(op.m), V=rnd(op.n, SHARD_K), eG=rnd(op.n))
    out = {f"in_{k}": v.cpu().numpy() for k, v in ins.items()}
    for dt in (torch.float64, torch.float32):
        o = op.astype(dt)
        Y, U, w, V, eG = (ins[k].to(dt) for k in ("Y", "U", "w", "V", "eG"))
        es, sv = o.es_vals(w, SHARD_SIGMA), o.s_vals(w)
        ayu = o.normal_factored(Y, U)
        coefs = (2.0, 4.0 * SHARD_SIGMA)
        ref = dict(apply_factored=o.apply_factored(Y, U),
                   adjoint_on_pattern=o.adjoint_on_pattern(w),
                   matmat_pattern=o.matmat_pattern(Y, es),
                   matvec_pattern=o.matvec_pattern(V, sv),
                   al_hess=o.al_hess(U, Y, es, ayu, coefs),
                   al_hess_diag=o.al_hess(U, Y, es, ayu, coefs, eG=eG))
        out.update({f"{str(dt)[6:]}_{k}": v.cpu().numpy()
                    for k, v in ref.items()})
    return out


def shard_checks(sop, path):
    """Each method of this rank's shard against the unsharded operator's
    outputs (``shard_inputs``, saved at ``path``): relative errors, f64
    and f32 (the adjoint on this rank's slice of the pattern)."""
    import torch
    dev = sop.device
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    errs = {}
    for dt in (torch.float64, torch.float32):
        o = sop.astype(dt)
        Y, U, w, V, eG = (torch.as_tensor(ref[f"in_{k}"], device=dev).to(dt)
                          for k in ("Y", "U", "w", "V", "eG"))
        es, sv = o.es_vals(w, SHARD_SIGMA), o.s_vals(w)
        ayu = o.normal_factored(Y, U)
        coefs = (2.0, 4.0 * SHARD_SIGMA)
        got = dict(apply_factored=o.apply_factored(Y, U),
                   adjoint_on_pattern=o.adjoint_on_pattern(w),
                   matmat_pattern=o.matmat_pattern(Y, es),
                   matvec_pattern=o.matvec_pattern(V, sv),
                   al_hess=o.al_hess(U, Y, es, ayu, coefs),
                   al_hess_diag=o.al_hess(U, Y, es, ayu, coefs, eG=eG))
        name = str(dt)[6:]
        for k, v in got.items():
            want = ref[f"{name}_{k}"]
            if k == "adjoint_on_pattern":
                want = want[sop.lo:sop.lo + v.shape[0]]
            errs[f"{name}_{k}"] = _rel_err(v.cpu().numpy(), want)
    return errs


def shard_times(sop, path):
    """Phase 24b's per-shard kernel times (ranks in turns, one at a time on
    the card): K3 pair dots, K4 A(·) and Aᵀ on the slice, K1 ``al_hess`` on
    the slice, each against its plain twin at the shard's own shapes (its
    errors), its bound and, for K3 and K4, phase 6's library call on the
    shard's arrays (``sampled_addmm`` on its pattern, its CSR products),
    f32 (the tCG's) and f64; then the all-reduces
    of the solve's shapes ((m,), (p, n), (k, n)), both ranks together,
    host clock around a synchronize (gloo stages them through the
    host)."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.parallel.distributed import all_reduce
    dev = sop.device
    with np.load(path) as z:
        ins = {k: z[f"in_{k}"] for k in ("Y", "U", "w")}
    rows = []
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn != dist.get_rank():
            continue
        for dt in (torch.float32, torch.float64):
            o = sop.local.astype(dt)
            Y, U, w = (torch.as_tensor(ins[k], device=dev).to(dt)
                       for k in ("Y", "U", "w"))
            p, n = Y.shape
            e = o.pattern_pair_dots(Y, U)
            es = o.es_vals(w, SHARD_SIGMA)
            ayu = o.adjoint_on_pattern(w)
            nP, nA, m = o.pat.nnz, o.nnz, o.m
            coefs = (2.0, 4.0 * SHARD_SIGMA)
            pat = (o.pat.i, o.pat.colptr)
            name = str(dt)[6:]
            # the library yardsticks of phase 6 on the shard's own arrays:
            # sampled_addmm on its pattern, its CSR products
            Pz = csr(o.pat.colptr, o.pat.i, torch.zeros_like(o.pat.v),
                     (n, n))
            A_k = csr(o.krow_ptr, o.a2p, o.v, (m, nP))
            A_p = csr(o.pat_ptr, o.kp, o.vp, (nP, m))
            for kern, fn, twin, reads, writes, flops, lib in (
                    ("pattern_dots", lambda: o.pattern_pair_dots(Y, U),
                     lambda: K.pattern_dots_plain(Y, U, o.pat),
                     (Y, U, *pat), e, 2.0 * nP * p,
                     lambda: torch.sparse.sampled_addmm(
                         Pz, U.T.contiguous(), Y, beta=0.0)),
                    ("csr_gather.apply_from_e", lambda: o.apply_from_e(e),
                     lambda: K.csr_gather_plain(e, o.krow_ptr, o.a2p, o.v),
                     (gathered(e, o.a2p), o.krow_ptr, o.a2p, o.v),
                     torch.empty(m, dtype=dt), 2.0 * nA, lambda: A_k @ e),
                    ("csr_gather.adjoint_on_pattern",
                     lambda: o.adjoint_on_pattern(w),
                     lambda: K.csr_gather_plain(w, o.pat_ptr, o.kp, o.vp),
                     (gathered(w, o.kp), o.pat_ptr, o.kp, o.vp), e,
                     2.0 * nA, lambda: A_p @ w),
                    ("symcoo_spmm.al_hess",
                     lambda: o.al_hess(U, Y, es, ayu, coefs),
                     lambda: K.symcoo_spmm_plain(U, o.pat, "al_hess",
                                                 vals=es, B=Y, vals2=ayu,
                                                 coefs=coefs),
                     (U, Y, *pat, es, ayu), U, 4.0 * nP * p, None)):
                b_ms, b_by = bound(nbytes(*reads, writes), flops, name)
                err, rel_err = max_err(fn(), twin())
                row = dict(rank=dist.get_rank(), kernel=kern, dtype=name,
                           p=p, nnzP_local=nP, nnzA_local=nA,
                           max_abs_err=err, rel_err=rel_err, ms=time_ms(fn),
                           plain_ms=time_ms(twin), bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
                if lib is not None:
                    try:
                        row["library_ms"] = time_ms(lib)
                    except (RuntimeError, NotImplementedError,
                            TypeError) as err_:
                        row["library_error"] = str(err_).splitlines()[0][:200]
                rows.append(row)
            del Pz, A_k, A_p
        torch.cuda.synchronize()
    dist.barrier()
    p, n = ins["Y"].shape
    reduces = []
    for label, shape, dt in (("m_f64", (sop.m,), torch.float64),
                             ("m_f32", (sop.m,), torch.float32),
                             ("pn_f64", (p, n), torch.float64),
                             ("pn_f32", (p, n), torch.float32),
                             ("kn_f64", (SHARD_K, n), torch.float64)):
        t = torch.ones(shape, dtype=dt, device=dev)
        ts = []
        for it in range(13):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            all_reduce(t, sop.group)
            torch.cuda.synchronize()
            if it >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        reduces.append(dict(shape=label, bytes=t.numel() * t.element_size(),
                            ms=statistics.median(ts)))
    return dict(kernels=rows, all_reduce=reduces)


def piece_times(arrays, worlds, device, seed=24, p=SHARD_P):
    """The sharded operator's per-shard K1 ``al_hess`` (its two products,
    no epilogue, as a shard launches it), K1 ``plain`` (one factor: beside
    ``al_hess``, whether the walk waits on its gathers) and K3, f32 and
    f64, on every rank's piece of ``partition(arrays, world)`` for each
    world size (1: the whole pattern, in the same call), each piece built
    in this process with ``ShardedConstraintOp.from_piece(...).local``: no
    ranks are spawned.  Each row: the kernel's ms and its twin's (the
    twin's relative error), the bound from the piece's own bytes (the
    factors' rows its entries read, its pattern's rows, column pointers and
    values, its output; HBM rate), the whole pattern's ms, for K3
    ``sampled_addmm`` on the piece's pattern, and a hash of the output
    (K1's on the piece's columns, so a package whose K1 writes all n
    columns hashes alike).  ``device`` "cpu" runs the twins untimed."""
    import hashlib
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.parallel.sharded_ops import (ShardedConstraintOp,
                                                        partition)
    dev = torch.device(device)
    timed = time_ms if dev.type == "cuda" else (lambda fn: float("nan"))
    n = int(arrays["n"])

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    rows, whole = [], {}
    for world in (1,) + tuple(worlds):
        for rank, piece in enumerate(partition(arrays, world)):
            o64 = ShardedConstraintOp.from_piece(piece, arrays, rank, world,
                                                 dev).local
            c0, c1 = int(piece["pat_j"][0]), int(piece["pat_j"][-1]) + 1
            r0, r1 = int(piece["pat_i"].min()), int(piece["pat_i"].max()) + 1
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + 1000 * world + rank)
            rnd = lambda *sh: torch.randn(  # noqa: E731
                sh, generator=gen, dtype=torch.float64, device=dev)
            Y64 = K.oblique_cols_plain(rnd(p, n), None, "renormalize")
            U64 = K.oblique_cols_plain(Y64, rnd(p, n), "proj")
            es64, ayu64 = rnd(o64.pat.nnz), rnd(o64.pat.nnz)
            for dt in (torch.float32, torch.float64):
                o = o64.astype(dt)
                Y, U, es, ayu = (t.to(dt) for t in (Y64, U64, es64, ayu64))
                coefs = (2.0, 4.0 * SHARD_SIGMA)
                nP, name = o.pat.nnz, str(dt)[6:]
                esz = torch.empty((), dtype=dt).element_size()
                fac, ptrs = p * esz, 4 * (c1 - c0 + 1)
                Pz = csr(o.pat.colptr, o.pat.i, torch.zeros_like(o.pat.v),
                         (n, n))
                cases = (
                    ("symcoo_spmm.al_hess",
                     lambda: o.al_hess(U, Y, es, ayu, coefs),
                     lambda: K.symcoo_spmm_plain(
                         U, o.pat, "al_hess", vals=es, B=Y, vals2=ayu,
                         coefs=coefs),
                     2 * (r1 - r0) * fac + nP * (4 + 2 * esz) + ptrs +
                     (c1 - c0) * fac, 4.0 * nP * p, None),
                    ("symcoo_spmm.plain", lambda: o.matmat_pattern(U, es),
                     lambda: K.symcoo_spmm_plain(U, o.pat, "plain",
                                                 vals=es),
                     (r1 - r0) * fac + nP * (4 + esz) + ptrs +
                     (c1 - c0) * fac, 2.0 * nP * p, None),
                    ("pattern_dots", lambda: o.pattern_pair_dots(Y, U),
                     lambda: K.pattern_dots_plain(Y, U, o.pat),
                     (r1 - r0) * fac + (c1 - c0) * fac + nP * (4 + esz) +
                     ptrs, 2.0 * nP * p,
                     lambda: torch.sparse.sampled_addmm(
                         Pz, U.T.contiguous(), Y, beta=0.0)))
                for kern, fn, twin, nbytes, flops, lib in cases:
                    got, ref = fn(), twin()
                    if kern != "pattern_dots" and got.shape[-1] == n:
                        got, ref = got[:, c0:c1], ref[:, c0:c1]
                    err, rel = max_err(got, ref)
                    b_ms, b_by = bound(nbytes, flops, name)
                    row = dict(world=world, rank=rank, kernel=kern,
                               dtype=name, p=p, nnzP=nP, cols=[c0, c1],
                               rows=[r0, r1], max_abs_err=err, rel_err=rel,
                               hash=digest(got), ms=timed(fn),
                               plain_ms=timed(twin), bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
                    if lib is not None:
                        row["library_ms"] = timed(lib)
                    if world == 1:
                        whole[kern, name] = row["ms"]
                    row["whole_ms"] = whole.get((kern, name))
                    rows.append(row)
                del Pz
            del o64
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def launches_24b(name, rank):
    """A ``kernels``-line row's launches in one 24b rank's solve: the
    kernel's count for a row named by the kernel alone, its mode's count
    for a row of a mode with a counter of its own (K1 / K2 / K4 modes, the
    instance modes), else None (the row gets no 24b count)."""
    base, _, mode = name.partition(".")
    if not mode:
        return rank["launches"][base]
    if mode == "instance":
        return rank["instance_launches"][base]
    modes = {"symcoo_spmm": "symcoo_spmm_modes", "oblique_cols":
             "oblique_modes", "csr_gather": "csr_modes"}.get(base)
    return rank[modes].get(mode) if modes else None


def shard_rank(paths, check_path, kw):
    """One rank of phase 24a / 24b / 24d (parallel.spawn_ranks): this
    rank's shard of mc-12000 from its piece at ``paths[rank]`` (saved by
    shard_phases), the protocol checks when ``check_path`` is given, then
    solve_sdp on the 1-D model mesh over all ranks; returns the result's
    scalars, digests of its arrays (the factor and multipliers too on rank
    0), seconds, launches and collectives."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import solve_sdp
    from manisdp_tpu_torch.parallel.mesh import make_mesh, mesh_axis
    from manisdp_tpu_torch.parallel.sharded_ops import ShardedConstraintOp
    world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    mesh = make_mesh(world, "model", "cuda")
    with np.load(paths[rank]) as z:
        piece = {k: z[k] for k in z.files}
    glob = {k: piece.pop(k) for k in ("pat_i_all", "pat_j_all", "b", "m",
                                      "n")}
    glob["pat_i"], glob["pat_j"] = glob.pop("pat_i_all"), \
        glob.pop("pat_j_all")
    sop = ShardedConstraintOp.from_piece(piece, glob, rank, world, device,
                                         mesh_axis(mesh, "model")[2])
    torch.cuda.synchronize()
    out = dict(rank=rank, world=world, device=str(device),
               backend=dist.get_backend(), load_s=time.perf_counter() - t0,
               local_nnzP=sop.local.pat.nnz, local_nnzA=sop.local.nnz)
    if check_path is not None:
        out["checks"] = shard_checks(sop, check_path)
        out["times"] = shard_times(sop, check_path)
    K.reset_launches()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    res = solve_sdp(sop, None, None, int(glob["n"]), mesh=mesh,
                    device=device, verbose=False, **kw)
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, status=res.status,
               obj=res.obj, eta=res.eta, gap=res.gap, pinf=res.pinf,
               dinf=res.dinf, iterations=res.iterations,
               fac_size=res.fac_size, rtr_iters=res.rtr_iters,
               hess_calls=res.hess_calls, sigma=res.sigma,
               timers=res.timers, launches=dict(K.LAUNCHES),
               symcoo_spmm_modes=dict(K.SPMM_LAUNCHES),
               oblique_modes=dict(K.OBLIQUE_LAUNCHES),
               csr_modes=dict(K.CSR_LAUNCHES),
               instance_launches=dict(K.INSTANCE_LAUNCHES),
               span_launches=dict(K.SPAN_LAUNCHES),
               collectives=dict(K.COLLECTIVES),
               history=[dict(gap=h["gap"], pinf=h["pinf"], dinf=h["dinf"])
                        for h in res.history],
               digest=_digest(res.Y, res.y, res.S, res.z, res.X))
    if rank == 0:
        out.update(Y=res.Y, y=res.y)
    return out


def batch_rank(Cs):
    """Phase 24c's rank: solve_maxcut_batch (p0 = 40) with its bucket
    split over a 1-D batch mesh of all ranks."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import solve_maxcut_batch
    from manisdp_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(dist.get_world_size(), "batch", "cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_maxcut_batch(Cs, p0=40, mesh=mesh, device=device,
                             verbose=False)
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0,
                objs=[r.obj for r in res], status=[r.status for r in res],
                eta=[r.eta for r in res],
                outer=[r.iterations for r in res],
                digest=_digest(*[r.Y for r in res]),
                launches=dict(K.LAUNCHES),
                instance_launches=dict(K.INSTANCE_LAUNCHES),
                collectives=dict(K.COLLECTIVES))


def _save_pieces(arrays, world, out_dir):
    """partition() of the operator's host arrays into ``world`` pieces,
    one .npz a rank with the global pattern, b, m and n; returns the
    paths."""
    from manisdp_tpu_torch.parallel.sharded_ops import partition
    paths = []
    for r, piece in enumerate(partition(arrays, world)):
        path = os.path.join(out_dir, f"mc12000_w{world}_r{r}.npz")
        np.savez(path, pat_i_all=arrays["pat_i"], pat_j_all=arrays["pat_j"],
                 b=arrays["b"], m=arrays["m"], n=arrays["n"], **piece)
        paths.append(path)
    return paths


def shard_phases(device, rec, keep):
    """Phase 24: mc-12000 through ``solve_sdp(mesh=)`` over its sharded
    constraint operator (24a: NCCL at world size 1; 24b: gloo at world
    size 2 with both ranks on card 0, after the protocol checks; 24d:
    NCCL over min(4, cards) cards where there are two or more), held to
    phase 7's objective and the on-card oracle, and phase 21's sparse
    batch through ``solve_maxcut_batch(mesh=)`` over a 2-rank batch axis
    (24c), held to phase 21's objectives.  Gloo stages every CUDA
    all-reduce through the host: its times are not NCCL's."""
    import shutil
    import tempfile
    import torch
    from types import SimpleNamespace
    from manisdp_tpu_torch import solve_maxcut_batch, solve_sdp
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    from manisdp_tpu_torch.parallel import spawn_ranks

    t_phase = time.perf_counter()
    out = {}
    if "mc12000" in keep:
        data, op_mc = keep["mc12000"]
    else:
        data, _ = mc_instance(MC)
        op_mc = ConstraintOp.build(data.At, data.b, data.c, int(data.K.s),
                                   device)
    n = int(data.K.s)
    kw = mc_options()
    ref_obj = rec.get("mc12000", {}).get("obj")
    ref_src = "phase 7"
    if ref_obj is None:
        ref = solve_sdp(op_mc, data.b, data.c, n, device=device,
                        verbose=False, **kw)
        if ref.status != 0:
            raise AssertionError(f"phase 24's reference: status {ref.status}")
        ref_obj, ref_src = ref.obj, "phase 7's options, solved in phase 24"
    t0 = time.perf_counter()
    arrays = op_mc.host_arrays(full=True)
    tmp = tempfile.mkdtemp(prefix="shard24_", dir="build")
    cards = torch.cuda.device_count()
    nccl_world = min(SHARD_NCCL_MAX, cards)
    try:
        pieces = {w: _save_pieces(arrays, w, tmp)
                  for w in sorted({1, SHARD_GLOO_WORLD, nccl_world})}
        check_path = os.path.join(tmp, "checks.npz")
        np.savez(check_path, **shard_inputs(op_mc, device, 24))
        out["setup_s"] = time.perf_counter() - t0
        # each world-2 and world-4 piece's K1 / K3 in this process, beside
        # the whole pattern's and the twins
        t0 = time.perf_counter()
        out["pieces"] = piece_times(arrays, SHARD_PIECE_WORLDS, device)
        emit(dict(phase="mc12000_shard_pieces",
                  seconds=time.perf_counter() - t0, rows=out["pieces"]))
        for r in out["pieces"]:
            if not r["rel_err"] <= (1e-12 if r["dtype"] == "float64"
                                    else 1e-5):
                raise AssertionError(
                    f"24: {r['kernel']} ({r['dtype']}) on piece "
                    f"{r['rank']} of {r['world']} against its twin: "
                    f"relative error {r['rel_err']}")
        del arrays

        def rel(a, b):
            return abs(a - b) / max(1.0, abs(b))

        def run(label, world, backend, dev, check):
            t0 = time.perf_counter()
            ranks = spawn_ranks(shard_rank, world, backend, dev,
                                args=(pieces[world],
                                      check_path if check else None, kw))
            r0 = ranks[0]
            oracle = al_kkt_oracle_on_card(
                data, SimpleNamespace(Y=r0.pop("Y"), y=r0.pop("y")), device)
            res = dict(phase=f"mc12000_sharded_{label}", world=world,
                       backend=backend, ranks_on=dev,
                       all_reduce_staging=("host (gloo)" if backend == "gloo"
                                           else "device (NCCL)"),
                       call_s=time.perf_counter() - t0, oracle=oracle,
                       ranks=ranks)
            emit(dict(res, ranks=[{k: v for k, v in r.items()
                                   if k != "history"} for r in ranks]))
            for r in ranks:
                if r["status"] != 0 or not r["eta"] <= 1e-8:
                    raise AssertionError(f"24{label}: rank {r['rank']} "
                                         f"status {r['status']}, eta "
                                         f"{r['eta']}")
                for name in ("symcoo_spmm", "pattern_dots", "csr_gather",
                             "tcg_step"):
                    if r["launches"][name] <= 0:
                        raise AssertionError(f"24{label}: rank {r['rank']} "
                                             f"never launched {name}")
                    if world > 1 and name in r["span_launches"] and \
                            r["span_launches"][name] <= 0:
                        raise AssertionError(
                            f"24{label}: rank {r['rank']} never launched "
                            f"{name} on its shard's columns")
            if not oracle["eta"] <= 1e-8:
                raise AssertionError(f"24{label}: KKT oracle {oracle}")
            for r in ranks[1:]:
                if r["digest"] != r0["digest"] or r["obj"] != r0["obj"] or \
                        r["iterations"] != r0["iterations"]:
                    raise AssertionError(f"24{label}: rank {r['rank']}'s "
                                         "result differs from rank 0's")
            return res

        # -- 24a: NCCL, one rank --
        a = out["a"] = run("a", 1, "nccl", "cuda", False)
        a["rel_to_phase7"] = rel(a["ranks"][0]["obj"], ref_obj)
        a["reference"] = ref_src
        if not a["rel_to_phase7"] <= 1e-6:
            raise AssertionError(f"24a: objective {a['ranks'][0]['obj']} "
                                 f"against {ref_src}'s {ref_obj}")
        # -- 24b: gloo, two ranks on card 0, protocol checks first --
        b = out["b"] = run("b", SHARD_GLOO_WORLD, "gloo", "cuda:0", True)
        b["rel_to_24a"] = rel(b["ranks"][0]["obj"], a["ranks"][0]["obj"])
        for r in b["ranks"]:
            for k, e in r["checks"].items():
                if not e <= (1e-12 if k.startswith("float64") else 1e-5):
                    raise AssertionError(f"24b: rank {r['rank']} {k} "
                                         f"relative error {e}")
            for t in r["times"]["kernels"]:
                if not t["rel_err"] <= (1e-12 if t["dtype"] == "float64"
                                        else 1e-5):
                    raise AssertionError(
                        f"24b: rank {t['rank']}'s {t['kernel']} "
                        f"({t['dtype']}) against its twin on the shard: "
                        f"relative error {t['rel_err']}")
        if not b["rel_to_24a"] <= 1e-6:
            raise AssertionError(f"24b: objective against 24a's: "
                                 f"{b['rel_to_24a']}")
        # -- 24c: the sparse batch over a 2-rank batch axis (gloo) --
        _, sparse_b = batch_graphs()
        found = rec.get("batch", {}).get("sparse")
        if found is not None:
            ref_objs, bsrc = [t["obj"] for t in found["table"]], "phase 21"
        else:
            ref_objs = [r.obj for r in solve_maxcut_batch(
                sparse_b, p0=40, device=device, verbose=False)]
            bsrc = "phase 21's batch, solved in phase 24"
        t0 = time.perf_counter()
        ranks = spawn_ranks(batch_rank, SHARD_GLOO_WORLD, "gloo", "cuda:0",
                            args=(sparse_b,))
        c = out["c"] = dict(
            phase="batch_sparse_sharded_c", world=SHARD_GLOO_WORLD,
            backend="gloo", all_reduce_staging="host (gloo)",
            call_s=time.perf_counter() - t0, reference=bsrc,
            rel_to_phase21=[rel(o, r) for o, r in zip(ranks[0]["objs"],
                                                       ref_objs)],
            ranks=ranks)
        emit(c)
        if not (all(s == 0 for s in ranks[0]["status"]) and
                max(c["rel_to_phase21"]) <= 1e-6):
            raise AssertionError(f"24c: {c['rel_to_phase21']}, status "
                                 f"{ranks[0]['status']}")
        if any(r["digest"] != ranks[0]["digest"] or
               r["objs"] != ranks[0]["objs"] for r in ranks[1:]):
            raise AssertionError("24c: the ranks' batch results differ")
        if any(r["instance_launches"]["symcoo_spmm"] <= 0 for r in ranks):
            raise AssertionError("24c: a rank never launched K1's instance "
                                 "mode")
        # -- 24d: NCCL across cards --
        if cards >= 2:
            d = out["d"] = run("d", nccl_world, "nccl", "cuda", False)
            d["rel_to_24a"] = rel(d["ranks"][0]["obj"],
                                  a["ranks"][0]["obj"])
            if not d["rel_to_24a"] <= 1e-6:
                raise AssertionError(f"24d: objective against 24a's: "
                                     f"{d['rel_to_24a']}")
        else:
            out["d"] = dict(phase="mc12000_sharded_d", run=False,
                            reason=f"{cards} CUDA device: NCCL needs one "
                            "card per rank, so the cross-card run needs "
                            "two or more")
            emit(out["d"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="sharded_summary", seconds=out["seconds"],
              setup_s=out["setup_s"]))
    return out


def idaat(q):
    """SymDualOp's per-degree 1 / class size of the expanded basis (ops/
    symdual.py build_bqpsos), the scale between apply and adjoint."""
    d0 = 4.0 * (1 + q + q * (q - 1) // 2)
    return 1.0 / np.array([d0, 8.0 * q, 8.0 * q, 24.0, 24.0])


def host_ms(fn, reps=7, warm=2):
    """Median wall ms of ``fn()`` ending in a synchronize (for calls whose
    collectives go through the host, where CUDA events would time the
    host's copies only in part)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def rows_in_one_process(apply_rows, top, rows, q, D):
    """K7's row-block mode (``kernels.symdual_apply_rows`` or its twin)
    over D ranks in one process: a thread per rank on the same stream,
    the all-to-all done by slicing the ranks' send buffers, the
    all-reduce a sum of the ranks' partials.  ``rows`` (q, q, n~) is the
    whole grid.  Returns (y0, y1, Y2, Y3, Y4): rank 0's replicated
    outputs and every rank's Y4 rows joined."""
    import threading
    import torch
    ql = q // D
    bar = threading.Barrier(D, timeout=600)   # a hung rank raises
    sends, parts, outs, errs = [None] * D, [None] * D, [None] * D, []

    def rank(r):
        def a2a(send, recv):
            sends[r] = send
            bar.wait()                  # every rank's send is enqueued
            for s in range(D):
                recv[s].copy_(sends[s][r])
            bar.wait()                  # every copy is enqueued

        def reduce(t):
            parts[r] = t
            bar.wait()
            total = torch.stack(parts).sum(0)
            bar.wait()
            t.copy_(total)

        try:
            outs[r] = apply_rows(top, rows[r * ql:(r + 1) * ql], q, r * ql,
                                 a2a, reduce)
        except BaseException as err:    # noqa: BLE001 - re-raised below
            errs.append(err)
            bar.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(D)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return outs[0][:4] + (torch.cat([o[4] for o in outs]),)


def symdual_rank(q, seed):
    """One rank of 25a / 25b / 25e: ShardedSymDualOp(q) on the 1-D model
    mesh of all ranks, f64 and f32, against the single-card kernels on
    the whole matrix (K7, K8) and each row-block mode against its plain
    twin on the card (the same collectives): apply of a seeded symmetric
    M, the adjoint of a seeded tuple y, and apply -> scale by idAAt ->
    adjoint.  Errors relative to the reference's largest entry (the largest
    absolute error by dtype and check); digests of the replicated outputs
    (y0 .. Y3 and the adjoints' top rows); then, in f64, the row-block
    modes' times against their twins and bounds, the adjoint's beside
    torch.take of the class map's rows for this rank (its library
    yardstick, checked bit-equal), the full-mode K7 on the whole M, and at
    world 1 the apply beside index_add_ of M at the sorted-index class map
    (its library yardstick, class_sums, within 1e-13 of the largest sum),
    each launch's device ms (torch.profiler) and the collectives' ms."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.ops.symdual import _split
    from manisdp_tpu_torch.parallel.distributed import all_reduce, all_to_all
    from manisdp_tpu_torch.parallel.mesh import make_mesh
    from manisdp_tpu_torch.parallel.symdual_sharded import ShardedSymDualOp
    world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    gloo = dist.get_backend() == "gloo"
    op = ShardedSymDualOp(q, make_mesh(world, "model", "cuda"))
    n, o, rows, ql = op.n, 2 + q, op.rows, op.ql
    qrows = slice(o + rows.start * q, o + rows.stop * q)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    M64 = torch.randn((n, n), generator=gen, dtype=torch.float64,
                      device=device)
    M64 = 0.5 * (M64 + M64.T)
    flat64 = torch.randn((1 + q + q * q + q ** 3 + q ** 4,), generator=gen,
                         dtype=torch.float64, device=device)
    scale64 = torch.as_tensor(idaat(q), device=device)
    a2a = lambda s_, r_: all_to_all(s_, r_, op.group)  # noqa: E731
    red = lambda t: all_reduce(t, op.group)  # noqa: E731

    worst = {}

    def rel(check, got, ref):
        """On the card: the largest |got - ref| over the largest |ref|."""
        err = float(torch.max(torch.abs(got - ref)))
        w = worst.setdefault(name, {})
        w[check] = max(w.get(check, 0.0), err)
        return err / max(float(torch.max(torch.abs(ref))), 1e-300)

    out = dict(rank=rank, world=world, backend=dist.get_backend(), q=q,
               device=str(device), rows=[rows.start, rows.stop], errors={},
               max_abs_err=worst, digests={}, launches={}, collectives={})
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        M, scale = M64.to(dt), scale64.to(dt)
        top, rowsQ = op.split_matrix(M)
        K.reset_launches()
        y = op.apply(top, rowsQ)
        torch.cuda.synchronize()
        out["launches"][f"{name}_apply"] = dict(
            symdual_apply=K.LAUNCHES["symdual_apply"],
            rows=K.SYMDUAL_APPLY_LAUNCHES["rows"])
        out["collectives"][f"{name}_apply"] = dict(K.COLLECTIVES)
        ref = K.symdual_apply(M, q)
        err = dict(apply=max(max(rel("apply", y[d], ref[d])
                                 for d in range(4)),
                             rel("apply", y[4], ref[4][rows])))
        ys = _split(flat64.to(dt), q)
        K.reset_launches()
        Wt, Wr = op.adjoint(ys[:4] + (ys[4][rows].contiguous(),))
        torch.cuda.synchronize()
        out["launches"][f"{name}_adjoint"] = dict(
            symdual_adjoint=K.LAUNCHES["symdual_adjoint"],
            rows=K.SYMDUAL_LAUNCHES["adjoint_rows"])
        out["collectives"][f"{name}_adjoint"] = dict(K.COLLECTIVES)
        W = K.symdual_adjoint(ys, q)
        err["adjoint"] = max(rel("adjoint", Wt, W[:o]),
                             rel("adjoint", Wr, W[qrows]))
        del W
        Rt, Rr = op.adjoint(tuple(t * scale[d] for d, t in enumerate(y)))
        R = K.symdual_adjoint(ref, q, scale=scale)
        err["roundtrip"] = max(rel("roundtrip", Rt, R[:o]),
                               rel("roundtrip", Rr, R[qrows]))
        del R
        tw = K.symdual_apply_rows_plain(top, rowsQ, q, rows.start, a2a, red)
        err["apply_twin"] = max(rel("apply_twin", g, t)
                                for g, t in zip(y, tw))
        yl = ys[:4] + (ys[4][rows].contiguous(),)
        tw8 = K.symdual_adjoint_rows_plain(yl, q, rows.start)
        err["adjoint_twin"] = max(rel("adjoint_twin", Wt, tw8[0]),
                                  rel("adjoint_twin", Wr, tw8[1]))
        out["errors"][name] = err
        out["digests"][name] = _digest(*(t.cpu().numpy() for t in
                                         (*y[:4], Wt, Rt)))
        del tw, tw8, ref, Rt, Rr, Wt, Wr, ys, yl
        if dt == torch.float32:
            continue
        # times (f64): each mode against its twin and its bound; the
        # collectives alone at the apply's shapes
        timer = host_ms if gloo else time_ms
        apply = lambda: op.apply(top, rowsQ)  # noqa: E731
        twin = lambda: K.symdual_apply_rows_plain(  # noqa: E731
            top, rowsQ, q, rows.start, a2a, red)
        adj = lambda: op.adjoint(yl)  # noqa: E731
        yl = _split(flat64, q)[:4] + (_split(flat64, q)[4][rows].clone(),)
        adj_twin = lambda: K.symdual_adjoint_rows_plain(  # noqa: E731
            yl, q, rows.start)
        flat_out = 1 + q + q * q + q ** 3
        send = torch.ones((world, ql * q ** 3 // world), dtype=dt,
                          device=device)
        recv = torch.empty_like(send)
        part = torch.ones((flat_out,), dtype=dt, device=device)
        t = dict(
            apply_ms=timer(apply), apply_plain_ms=timer(twin),
            apply_bound=bound(nbytes(top, rowsQ, part, y[4]), 0.0, name),
            full_mode_ms=timer(lambda: K.symdual_apply(M, q)),
            adjoint_ms=timer(adj), adjoint_plain_ms=timer(adj_twin),
            adjoint_bound=bound(nbytes(*yl, top, ql * q * n * 8), 0.0, name),
            all_to_all_ms=timer(lambda: a2a(send, recv)),
            all_to_all_bytes=nbytes(send),
            all_reduce_ms=timer(lambda: red(part)),
            all_reduce_bytes=nbytes(part),
            staging="host (gloo)" if gloo else "device (NCCL)")
        # K8's library yardstick on this rank's rows: torch.take of the
        # local flat y over the class map's top and local Q rows, Y4's
        # slots shifted to the local block
        if world == 1:
            # K7's library yardstick: the class sums by one index_add_
            canon = symdual_canonical_slots(q, device)
            cls = symdual_class_map(q, device, canonical=canon).view(-1)
            canon = canon.long()
            sums = torch.empty((flat_out + q ** 4,), dtype=dt, device=device)
            t["apply_library_ms"] = timer(lambda: class_sums(sums, cls, M))
            errs, big = class_sums_errors(apply(), class_sums(sums, cls, M),
                                          canon, q)
            t["apply_library_rel_err"] = max(errs) / big
            del sums, cls, canon
            if not t["apply_library_rel_err"] <= 1e-13:
                raise AssertionError("K7's row-block apply differs from "
                                     "index_add_ of the class map: "
                                     f"{t['apply_library_rel_err']}")
        cls = symdual_class_map(q, device)
        cls = torch.cat([cls[:o], cls[qrows]])
        cls[cls >= 1 + q + q * q + q ** 3] -= rows.start * q ** 3
        yl_flat = torch.cat([v.reshape(-1) for v in yl])
        take = lambda: torch.take(yl_flat, cls)  # noqa: E731
        t.update(adjoint_library_ms=timer(take),
                 adjoint_library_index_mb=nbytes(cls) / 1e6,
                 adjoint_library_bit_equal=bool(torch.equal(
                     take(), torch.cat(adj()))))
        if not t["adjoint_library_bit_equal"]:
            raise AssertionError("K8's row-block adjoint differs from "
                                 "torch.take of the class map's rows")
        del cls, yl_flat
        if not gloo:
            t["apply_launches_ms"] = pass_times(apply, reps=5)
            t["adjoint_launches_ms"] = pass_times(adj, reps=5)
        out["times"] = t
        del send, recv, part, top, rowsQ, y
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def symdual_big_rank(q, seed):
    """25f, NCCL at world 1: ShardedSymDualOp(q).apply in f64 at a q whose
    q x (q + 1) slab would not fit a block's shared memory, held to the
    class sums of a seeded M by index_add_ (class_sums; the map built by
    K8's adjoint), repeated-index slots zeroed: every degree within 1e-13
    of the largest sum (the plain twin's q^4 temporaries would not fit the
    card).  The map is freed before the apply; times beside the bound,
    each launch's ms and the peak memory."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.parallel.mesh import make_mesh
    from manisdp_tpu_torch.parallel.symdual_sharded import ShardedSymDualOp
    device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    op = ShardedSymDualOp(q, make_mesh(dist.get_world_size(), "model",
                                       "cuda"))
    if op.ql != q:
        raise ValueError("25f runs at world 1")
    n, ny = op.n, 1 + q + q * q + q ** 3 + q ** 4
    free, total = torch.cuda.mem_get_info(device)
    out = dict(q=q, n=n, world=1, dtype="float64",
               slab_bytes=8 * q * (q + 1), smem_bytes=232_448,
               card_free_gb_at_start=free / 1e9, card_gb=total / 1e9)
    t0 = time.perf_counter()
    canon = symdual_canonical_slots(q, device)
    cls = symdual_class_map(q, device, kernel=True, canonical=canon).view(-1)
    canon = canon.long()
    torch.cuda.synchronize()
    out["class_map_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    M = torch.randn((n, n), generator=gen, dtype=torch.float64,
                    device=device)
    sums = torch.empty((ny,), dtype=torch.float64, device=device)
    out["library_ms"] = time_ms(lambda: class_sums(sums, cls, M), reps=5,
                                warm=1)
    class_sums(sums, cls, M)
    del cls
    torch.cuda.empty_cache()
    top, rowsQ = op.split_matrix(M)
    K.reset_launches()
    y = op.apply(top, rowsQ)
    torch.cuda.synchronize()
    out["launches"] = dict(rows=K.SYMDUAL_APPLY_LAUNCHES["rows"],
                           all_to_all=K.COLLECTIVES["all_to_all"],
                           all_reduce=K.COLLECTIVES["all_reduce"])
    errs, big = class_sums_errors(y, sums, canon, q)
    out["abs_err_by_degree"] = errs
    out["max_abs_err"] = max(errs)
    out["rel_err"] = max(errs) / big
    del y, sums, canon
    torch.cuda.empty_cache()
    apply = lambda: op.apply(top, rowsQ)  # noqa: E731
    out["ms"] = time_ms(apply, reps=5, warm=1)
    out["launches_ms"] = pass_times(apply, reps=2)
    out["bound"] = bound(nbytes(top, rowsQ, 8 * ny), 0.0, "float64")
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if not out["rel_err"] <= 1e-13:
        raise AssertionError(f"25f: q = {q} apply differs from index_add_: "
                             f"{out['rel_err']}")
    if out["launches"] != dict(rows=1, all_to_all=0, all_reduce=1):
        raise AssertionError(f"25f: launches {out['launches']}")
    return out


def maxcut_shard_rank(C_sp, p, seed, single, peer_k11=False):
    """One rank of 25c / 25e: the dense G67-size MaxCut RTR through
    sharded_maxcut_solve (JAX's default TROptions) on the 1-D model mesh
    of all ranks from a seeded Oblique.rand start, K11 in the mode the
    group chooses (peer on NCCL with peer access, else split) and, where
    that is peer, once more in split mode; with ``single`` first the
    single-card make_trustregions(make_maxcut_problem(dense=True)) in this
    process on the same input.  Returns each solve's fx (and its hex),
    counts, seconds and launches, digests of Y (rank 0: Y itself), and
    K11's modes at this rank's tCG shape (``k11_modes``; the peer mode
    there too with ``peer_k11``)."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.core import TROptions, make_trustregions
    from manisdp_tpu_torch.manifolds import Oblique
    from manisdp_tpu_torch.parallel.mesh import (make_mesh, mesh_axis,
                                                 sharded_maxcut_solve)
    from manisdp_tpu_torch.solvers.maxcut import make_maxcut_problem
    world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(world, "model", "cuda")
    group = mesh_axis(mesh, "model")[2]
    n = C_sp.shape[0]
    C = torch.as_tensor(C_sp.toarray(), dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    Y0 = Oblique.rand(gen, p, n)
    typ = Oblique.typicaldist(p, n)
    out = dict(rank=rank, world=world, backend=dist.get_backend(),
               device=str(device))

    def record(res, seconds, mode):
        r = dict(fx=float(res.fx), fx_hex=float(res.fx).hex(),
                 norm_grad=float(res.norm_grad), iters=res.iters,
                 inner_iters=res.inner_iters, seconds=seconds, mode=mode,
                 launches=dict(K.LAUNCHES), tcg=dict(K.TCG_LAUNCHES),
                 collectives=dict(K.COLLECTIVES),
                 digest=_digest(res.Y.cpu().numpy()))
        if rank == 0:
            r["Y"] = res.Y.cpu().numpy()
        return r

    if single:
        base = make_trustregions(make_maxcut_problem(dense=True), TROptions(
            maxiter=4, maxinner=10, tolgradnorm=1e-8))
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r1 = base(Y0, C, typ)
        torch.cuda.synchronize()
        out["single"] = record(r1, time.perf_counter() - t0, None)
        del r1

    def sharded(mode):
        # twice: the first call also sets up the peer mode's buffers (and,
        # in a fresh process, NCCL's communicator and the GEMM handles)
        solve, shard = sharded_maxcut_solve(mesh, tcg_mode=mode)
        Yl, Cl = shard(Y0, C)
        secs = []
        for _ in range(2):
            K.reset_launches()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            res = solve(Yl, Cl, typ)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rec = record(res, secs[1], solve.manifold.tcg_mode)
        rec["first_s"] = secs[0]
        if dist.get_backend() == "nccl":
            # where a warm solve's time goes: device busy share, by kind
            dist.barrier()
            rec["profile"] = profile_breakdown(
                lambda: solve(Yl, Cl, typ))[1]
        solve.manifold.close()
        return rec, Yl

    out["sharded"], Yl = sharded(None)
    if out["sharded"]["mode"] == "peer":
        out["sharded_split"], _ = sharded("split")
    del C
    out["local_shape"] = list(Yl.shape)
    out["k11"] = k11_modes(Yl, group, gen, typ,
                           peer_k11 or out["sharded"]["mode"] == "peer")
    return out


def k11_modes(Yl, group, gen, typ, peer):
    """K11 at this rank's tCG shape (1, p, n / D), f64, with the tangent
    projection, as the sharded solve runs it, from one seeded state: the
    split mode (its partials all-reduced) and, with ``peer``, the peer mode
    (a PeerSums of ``group``), each against its twin (the split's with the
    all-reduce, the peer's with distributed.ordered_sum), against each
    other and, at one rank, against the one launch; digests of every
    output and of the next scalar state (which every rank must share);
    each mode's ms: one call (CUDA events; host-timed on gloo), a step in
    a chain of 50 at the host's pace (``host_chain_ms``: CUDA events
    around them, no spin before) and, on NCCL, at the device's
    (``chain_ms``: the 50 steps enqueued behind a spin kernel, so the
    ranks run them back to back in lockstep, the first step taking up
    their skew) and its kernels and collectives by name (``pass_times``;
    across ranks a kernel's time includes its wait for the others); on
    NCCL also one all-reduce of each of the split mode's partials, (1,
    nblk, 2) and (1, nblk), at the device's pace; the bound at this
    shape."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.parallel.distributed import all_reduce, ordered_sum
    from manisdp_tpu_torch.parallel.peer import PeerSums
    device = Yl.device
    world = dist.get_world_size(group)
    shape = (1,) + tuple(Yl.shape)
    r = torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    Hd = r * (1.0 + torch.randn(shape, generator=gen, dtype=torch.float64,
                                device=device).abs())
    eta, Heta = torch.zeros_like(r), torch.zeros_like(r)
    r_r = all_reduce(torch.sum(r * r, dim=(1, 2)), group)
    z = torch.zeros_like(r_r)
    sc = torch.stack([z, z, r_r, r_r, z, z + typ ** 2 / 64, z, z + 1], 1)
    st = torch.zeros((1, 2), dtype=torch.int32, device=device)
    Y = Yl[None]
    gloo = dist.get_backend(group) == "gloo"
    L = r.numel()
    out = dict(shape=list(shape), world=world,
               staging="host (gloo)" if gloo else "device (NCCL)",
               bound=bound(nbytes(r, Hd, eta, Heta, r, sc, st, Y, eta, Heta,
                                  r, r), 18.0 * L, "float64"))

    def fresh():
        return tuple(t.clone() for t in (r, Hd, eta, Heta, r))

    def chain_ms(fn, steps=50, reps=5, spin_ms=0.0):
        ts = []
        fn()
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier(group)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin_ms:
                torch.cuda._sleep(int(spin_ms * 2e6))   # ~2e6 cycles a ms
            a.record()
            for _ in range(steps):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / steps)
        return statistics.median(ts)

    def device_chain_ms(fn, host_ms, steps=50):
        """chain_ms behind a spin longer than the host takes to enqueue
        the steps (``host_ms`` a step at the host's pace)."""
        return chain_ms(fn, steps, spin_ms=1.5 * steps * host_ms + 2.0)

    red = lambda t: all_reduce(t, group)  # noqa: E731
    peers = PeerSums(group) if peer else None
    modes = dict(split=dict(reduce=red, twin=red))
    if peer:
        modes["peer"] = dict(peer=peers,
                             twin=lambda t: ordered_sum(t, group))
    one = K.tcg_step(*fresh(), sc, st, 1, Y, None)
    got = {}
    for name, kw in modes.items():
        twin = kw.pop("twin")
        g = got[name] = K.tcg_step(*fresh(), sc, st, 1, Y, None, **kw)
        ref = K.tcg_step_plain(*fresh(), sc, st, 1, Y, None, twin)
        torch.cuda.synchronize()
        bufs = fresh()
        timer = host_ms if gloo else time_ms
        step = functools.partial(K.tcg_step, *bufs, sc, st, 1, Y, None,
                                 **kw)
        host_chain = chain_ms(step)
        out[name] = dict(
            rel_err=max(_rel_err(a.cpu().numpy(), f.cpu().numpy())
                        for a, f in zip(g[:5], ref[:5])),
            max_abs_err=max(float(torch.max(torch.abs(a - f)))
                            for a, f in zip(g[:5], ref[:5])),
            digest=_digest(*(t.cpu().numpy() for t in g)),
            scalars_digest=_digest(*(t.cpu().numpy() for t in g[4:])),
            bit_equal_one_launch=world == 1 and all(
                torch.equal(a, f) for a, f in zip(g, one)),
            ms=timer(step),
            plain_ms=timer(lambda: K.tcg_step_plain(*fresh(), sc, st, 1, Y,
                                                    None, twin)),
            host_chain_ms=host_chain,
            chain_ms=None if gloo else device_chain_ms(step, host_chain),
            passes_ms=None if gloo else pass_times(step, reps=10))
    bufs = fresh()
    out["one_launch_ms"] = time_ms(lambda: K.tcg_step(*bufs, sc, st, 1, Y,
                                                      None))
    if not gloo:
        nblk = K.tcg_blocks(L)
        out["all_reduce_ms"] = {}
        for part in (torch.zeros((1, nblk, 2), dtype=torch.float64,
                                 device=device),
                     torch.zeros((1, nblk), dtype=torch.float64,
                                 device=device)):
            ar = functools.partial(all_reduce, part, group)
            out["all_reduce_ms"][str(tuple(part.shape))] = device_chain_ms(
                ar, chain_ms(ar))
    if peer:
        out["peer_vs_split"] = dict(
            bit_equal=all(torch.equal(a, f) for a, f in
                          zip(got["peer"], got["split"])),
            rel_err=max(_rel_err(a.cpu().numpy(), f.cpu().numpy())
                        for a, f in zip(got["peer"][:5], got["split"][:5])))
        torch.cuda.synchronize()
        dist.barrier(group)
        peers.close()
    return out


def batch_shard_rank(Cs, p, seed):
    """One rank of 25d: batched_sharded_maxcut_solve (JAX's default
    TROptions) on a (batch, model) = BATCH_SHARD_MESH mesh of all ranks,
    the dense costs and seeded Oblique.rand starts of ``Cs``."""
    import torch
    import torch.distributed as dist
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.manifolds import Oblique
    from manisdp_tpu_torch.parallel.mesh import (batched_sharded_maxcut_solve,
                                                 make_mesh_2d)
    device = torch.device("cuda", torch.cuda.current_device())
    Ys, Cd, typ = batch_shard_inputs(Cs, p, seed, device)
    solve, shard = batched_sharded_maxcut_solve(
        make_mesh_2d(*BATCH_SHARD_MESH, "cuda"))
    Yl, Cl = shard(Ys, Cd)
    del Cd
    K.reset_launches()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    res = solve(Yl, Cl, typ)
    torch.cuda.synchronize()
    out = dict(rank=dist.get_rank(), seconds=time.perf_counter() - t0,
               local_shape=list(Yl.shape), fx=res.fx.cpu().tolist(),
               iters=res.iters.tolist(), inner_iters=res.inner_iters.tolist(),
               launches=dict(K.LAUNCHES), tcg=dict(K.TCG_LAUNCHES),
               collectives=dict(K.COLLECTIVES),
               digest=_digest(res.Y.cpu().numpy()))
    if dist.get_rank() == 0:
        out["Y"] = res.Y.cpu().numpy()
    return out


def batch_shard_inputs(Cs, p, seed, device):
    """25d's inputs: the (B, n, n) dense costs, a seeded (B, p, n)
    Oblique.rand start and typicaldist."""
    import torch
    from manisdp_tpu_torch.manifolds import Oblique
    n = Cs[0].shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    Ys = torch.stack([Oblique.rand(gen, p, n) for _ in Cs])
    Cd = torch.stack([torch.as_tensor(C.toarray(), dtype=torch.float64,
                                      device=device) for C in Cs])
    return Ys, Cd, Oblique.typicaldist(p, n)


def rank_jobs(jobs):
    """A rank of phase 25 running several jobs in one spawn: ``jobs`` a
    list of (name, function name in this module, kwargs); returns
    {name: result}."""
    return {name: globals()[fn](**kw) for name, fn, kw in jobs}


def shard_piece_rows(rec):
    """The ``kernels`` line's rows of K1 and K3 on a shard's columns (the
    sharded operator's mode): launches from rank 0 of 24b (gloo, world 2;
    K1's in every mode), times from phase 24's main-process run of the
    world-2 piece of rank 0 in f32 (K1 ``al_hess``, the tCG's Hessian),
    each row's max_abs_err the worst over every piece and both dtypes;
    beside them the world-4 pieces' times and the whole pattern's in the
    same call."""
    pieces, r0 = rec["pieces"], rec["b"]["ranks"][0]
    out = []
    for name, kern, rep, lib in (
            ("symcoo_spmm.span", "symcoo_spmm.al_hess",
             "parallel/sharded_ops.py:213", None),
            ("pattern_dots.span", "pattern_dots",
             "parallel/sharded_ops.py:178",
             "torch.sparse.sampled_addmm on the piece's pattern")):
        mine = [r for r in pieces if r["kernel"] == kern]
        hot = next(r for r in mine if r["world"] == 2 and r["rank"] == 0
                   and r["dtype"] == "float32")
        out.append(dict(
            name=name, route="cuda",
            source=f"manisdp_tpu_torch/csrc/{kern.split('.')[0]}.cu",
            replaces=f"manisdp_tpu/{rep}",
            launches=r0["span_launches"][kern.split(".")[0]],
            max_abs_err=max(r["max_abs_err"] for r in mine if r["world"] > 1),
            ms=hot["ms"], plain_ms=hot["plain_ms"], bound_ms=hot["bound_ms"],
            bound_by=hot["bound_by"], library_ms=hot["library_ms"],
            library=lib or "none: no single PyTorch call computes it",
            whole_ms=hot["whole_ms"],
            pieces={f"w{r['world']}r{r['rank']}_{r['dtype']}": [
                r["ms"], r["bound_ms"]] for r in mine if r["world"] > 1}))
    return out


def sharded_6b_rows(rec):
    """The ``kernels`` line's rows of phase 25's three modes: launches,
    times and bounds from rank 0 of 25a (K7 / K8 row blocks, f64, q = 120,
    NCCL at world 1) and 25c (K11 split, f64, the G67 shape at world 1);
    each row's max_abs_err the worst of its own checks (the mode against
    the single-card kernel and against its twin).  The apply's library
    call is index_add_ of M at the sorted-index class map (beside it the
    full-mode K7 on the whole M and 25f's q = 180 run), the adjoint's
    torch.take of the class map's rows; no single PyTorch call computes
    K11's step (library_ms null).  K11's split row counts its launches in
    25c's gloo solve at world 2 (the mode gloo takes), the peer row in the
    solve at world 1 (NCCL); both rows' times are world 1's, and 25e's
    (four cards) go beside them where it ran."""
    a, c = rec["a"]["ranks"][0], rec["c"]["world1"]["ranks"][0]
    c2 = rec["c"]["world2"]["ranks"][0]
    f = rec["f"]
    t, k11 = a["times"], c["k11"]
    e = rec.get("e", {}).get("maxcut")
    k11e = {m: [r["k11"][m] for r in e["ranks"]] for m in ("split", "peer")
            if m in e["ranks"][0]["k11"]} if e else {}
    want_e = e["ranks"][0]["sharded"]["mode"] if e else None
    err = a["max_abs_err"]["float64"]
    row = dict(route="cuda", library_ms=None,
               library="none: no single PyTorch call computes it")
    return [
        dict(row, name="symdual_apply.rows",
             source="manisdp_tpu_torch/csrc/symdual_apply.cu",
             replaces="manisdp_tpu/parallel/symdual_sharded.py:79",
             launches=a["launches"]["float64_apply"]["rows"],
             max_abs_err=max(err["apply"], err["apply_twin"]),
             ms=t["apply_ms"],
             plain_ms=t["apply_plain_ms"], bound_ms=t["apply_bound"][0],
             bound_by=t["apply_bound"][1],
             passes_ms=t.get("apply_launches_ms"),
             library_ms=t.get("apply_library_ms"),
             library="index_add_ of M at the sorted-index class map",
             full_mode_ms=t["full_mode_ms"],
             all_to_all_ms=t["all_to_all_ms"], q=a["q"], world=a["world"],
             q180=dict(ms=f["ms"], bound_ms=f["bound"][0],
                       library_ms=f["library_ms"], rel_err=f["rel_err"],
                       passes_ms=f["launches_ms"], peak_gb=f["peak_gb"])),
        dict(row, name="symdual_adjoint.rows",
             source="manisdp_tpu_torch/csrc/symdual_adjoint.cu",
             replaces="manisdp_tpu/parallel/symdual_sharded.py:178",
             launches=a["launches"]["float64_adjoint"]["rows"],
             max_abs_err=max(err["adjoint"], err["adjoint_twin"]),
             ms=t["adjoint_ms"], plain_ms=t["adjoint_plain_ms"],
             bound_ms=t["adjoint_bound"][0], bound_by=t["adjoint_bound"][1],
             library_ms=t["adjoint_library_ms"],
             library="torch.take of the class map's rows",
             library_index_mb=t["adjoint_library_index_mb"], q=a["q"],
             world=a["world"]),
    ] + [dict(row, name=f"tcg_step.{m}",
               source="manisdp_tpu_torch/csrc/tcg_step.cu",
               replaces="manisdp_tpu/parallel/mesh.py:55",
               launches=(c2 if m == "split" else c)["sharded"]["tcg"][m],
               max_abs_err=k11[m]["max_abs_err"], ms=k11[m]["ms"],
               plain_ms=k11[m]["plain_ms"], bound_ms=k11["bound"][0],
               bound_by=k11["bound"][1], chain_ms=k11[m]["chain_ms"],
               host_chain_ms=k11[m]["host_chain_ms"],
               one_launch_ms=k11["one_launch_ms"],
               passes_ms=k11[m]["passes_ms"], shape=k11["shape"],
               **({"cards": dict(
                   world=e["world"], shape=e["ranks"][0]["k11"]["shape"],
                   bound_ms=e["ranks"][0]["k11"]["bound"][0],
                   ms=[x["ms"] for x in k11e[m]],
                   chain_ms=[x["chain_ms"] for x in k11e[m]],
                   host_chain_ms=[x["host_chain_ms"] for x in k11e[m]],
                   passes_ms=k11e[m][0]["passes_ms"],
                   all_reduce_ms=e["ranks"][0]["k11"]["all_reduce_ms"],
                   solve_s=e["ranks"][0]["sharded" if m == want_e
                                        else "sharded_split"]["seconds"])}
                  if m in k11e
                  else {}))
           for m in ("split", "peer")]


def sharded_6b_phases(device, seed):
    """Phase 25: ShardedSymDualOp at q = 120 on NCCL at world 1 (25a) and
    at q = 60 over 2 gloo ranks on card 0 (25b); the dense G67-size MaxCut
    RTR through sharded_maxcut_solve at world 1 (25c, K11's peer mode and
    then its split mode, each bit-equal to the single-card RTR) and over 2
    gloo ranks (25c, split); the 16 G1-size dense
    stand-ins through batched_sharded_maxcut_solve on a (2, 2) mesh of
    gloo ranks on card 0 (25d); with two or more cards, 25a and 25c on
    NCCL across min(4, cards) cards (25e).  Gloo stages every collective
    through the host: its times are labelled so."""
    import torch
    from manisdp_tpu_torch.core import TROptions, make_batched_trustregions
    from manisdp_tpu_torch.parallel import spawn_ranks
    from manisdp_tpu_torch.solvers.maxcut import make_maxcut_problem

    t_phase = time.perf_counter()
    # the ranks share card 0 with this process (25f peaks near 45 GB):
    # hand back what the earlier phases left cached
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(main_process_gb=dict(
        allocated=torch.cuda.memory_allocated(device) / 1e9,
        reserved=torch.cuda.memory_reserved(device) / 1e9))
    cards = torch.cuda.device_count()
    nccl_world = min(SHARD_NCCL_MAX, cards)
    tol = {"float64": 1e-12, "float32": 1e-5}

    C_sp, _ = load_graph("G67", None, seed)

    def spawn(world, backend, dev, q=None, single=None, big_q=None,
              peer_k11=False):
        """One spawn of ``world`` ranks running the operator's job (at q),
        the MaxCut RTR's (with the single-card reference when ``single``;
        K11's peer mode checked beside the split mode with ``peer_k11``
        or where the group chooses it) and 25f's (at big_q), each a list
        of the ranks' results."""
        jobs = []
        if q is not None:
            jobs.append(("symdual", "symdual_rank", dict(q=q,
                                                         seed=seed + 25)))
        if single is not None:
            jobs.append(("maxcut", "maxcut_shard_rank", dict(
                C_sp=C_sp, p=MAXCUT_SHARD_P, seed=seed + 25, single=single,
                peer_k11=peer_k11)))
        if big_q is not None:
            jobs.append(("big", "symdual_big_rank", dict(q=big_q,
                                                         seed=seed + 25)))
        t0 = time.perf_counter()
        ranks = spawn_ranks(rank_jobs, world, backend, dev, args=(jobs,))
        call_s = time.perf_counter() - t0
        return {name: ([r[name] for r in ranks], call_s) for name, *_ in jobs}

    def symdual(label, ranks, call_s):
        r0 = ranks[0]
        q, world, backend = r0["q"], r0["world"], r0["backend"]
        res = dict(phase=f"symdual_sharded_{label}", q=q, n=2 + q + q * q,
                   world=world, backend=backend, ranks_on=r0["device"],
                   call_s=call_s, ranks=ranks)
        emit(res)
        for r in ranks:
            for dt, errs in r["errors"].items():
                for k, e in errs.items():
                    if not e <= tol[dt]:
                        raise AssertionError(f"25{label}: rank {r['rank']} "
                                             f"{dt} {k} relative error {e}")
            for k, c in r["collectives"].items():
                # no all-to-all at one rank
                want = (2 if world > 1 else 0, 1) if k.endswith("apply") \
                    else (0, 0)
                if (c["all_to_all"], c["all_reduce"]) != want:
                    raise AssertionError(f"25{label}: {k} collectives {c}")
            for k, c in r["launches"].items():
                if any(v != 1 for v in c.values()):
                    raise AssertionError(f"25{label}: {k} launches {c}")
            if r["digests"] != ranks[0]["digests"]:
                raise AssertionError(f"25{label}: rank {r['rank']}'s "
                                     "replicated outputs differ from rank 0's")
        return res

    def maxcut(label, ranks, call_s, ref, want):
        """25c / 25e's checks: counts and bits against the single card,
        K11 in mode ``want`` (and never in the other), K11's modes at the
        rank's shape against their twins, each other and the one launch,
        every rank the same bits."""
        r0 = ranks[0]
        world, backend = r0["world"], r0["backend"]
        single = r0.get("single", ref)
        Y1 = single.pop("Y", None) if ref is None else ref["Y"]
        Ys = r0["sharded"].pop("Y")
        Yss = r0.get("sharded_split", {}).pop("Y", None)
        res = dict(phase=f"maxcut_sharded_{label}", n=C_sp.shape[0],
                   p=MAXCUT_SHARD_P, world=world, backend=backend,
                   ranks_on=r0["device"], call_s=call_s, mode=want,
                   fx_rel=abs(r0["sharded"]["fx"] - single["fx"]) /
                   abs(single["fx"]),
                   Y_abs=float(np.max(np.abs(Ys - Y1))),
                   split_Y_abs=None if Yss is None else float(
                       np.max(np.abs(Yss - Y1))),
                   single={k: v for k, v in single.items() if k != "Y"},
                   ranks=ranks)
        emit(res)
        other = "split" if want == "peer" else "peer"
        for r in ranks:
            for key in ("sharded", "sharded_split"):
                g = r.get(key)
                if g is None:
                    continue
                if (g["iters"], g["inner_iters"]) != (single["iters"],
                                                      single["inner_iters"]):
                    raise AssertionError(f"25{label}: rank {r['rank']} {key} "
                                         f"counts {g['iters']}, "
                                         f"{g['inner_iters']}")
                if g["digest"] != r0[key]["digest"] or \
                        g["fx_hex"] != r0[key]["fx_hex"]:
                    raise AssertionError(f"25{label}: rank {r['rank']}'s "
                                         f"{key} result differs from rank "
                                         "0's")
            g = r["sharded"]
            if g["mode"] != want or g["tcg"][want] <= 0 or \
                    g["tcg"][other] != 0 or g["launches"]["oblique_cols"] <= 0:
                raise AssertionError(f"25{label}: rank {r['rank']} ran K11 "
                                     f"in {g['mode']} ({g['tcg']}), not "
                                     f"{want}, or never launched K2")
            if "sharded_split" in r and (
                    r["sharded_split"]["tcg"]["peer"] != 0 or
                    r["sharded_split"]["tcg"]["split"] <= 0):
                raise AssertionError(f"25{label}: rank {r['rank']} split "
                                     f"solve {r['sharded_split']['tcg']}")
            k11 = r["k11"]
            for m in ("split", "peer"):
                if m not in k11:
                    continue
                if not k11[m]["rel_err"] <= 1e-12 or (
                        world == 1 and not k11[m]["bit_equal_one_launch"]):
                    raise AssertionError(f"25{label}: K11 {m} {k11[m]}")
                if k11[m]["scalars_digest"] != \
                        r0["k11"][m]["scalars_digest"]:
                    raise AssertionError(f"25{label}: rank {r['rank']}'s "
                                         f"K11 {m} scalar state differs "
                                         "from rank 0's")
            pv = k11.get("peer_vs_split")
            if pv is not None and not (pv["bit_equal"] if world <= 2
                                       else pv["rel_err"] <= 1e-12):
                raise AssertionError(f"25{label}: K11 peer against split "
                                     f"{pv}")
        for key, y_abs in (("sharded", res["Y_abs"]),
                           ("sharded_split", res["split_Y_abs"])):
            if key not in r0:
                continue
            g = r0[key]
            if world == 1:
                if g["fx_hex"] != single["fx_hex"] or \
                        g["digest"] != single["digest"]:
                    raise AssertionError(f"25{label}: {key} not bit-equal "
                                         "to the single-card RTR")
            elif not (abs(g["fx"] - single["fx"]) / abs(single["fx"]) <=
                      1e-12 and y_abs <= 1e-10):
                raise AssertionError(f"25{label}: {key} fx {g['fx']}, Y "
                                     f"{y_abs}")
        return res, dict(single, Y=Y1)

    # -- 25a / 25c at world 1 (NCCL), one spawn; 25b / 25c at world 2
    #    (gloo on card 0), one spawn --
    one = spawn(1, "nccl", "cuda", q=SYMDUAL_NCCL_Q, single=True,
                big_q=SYMDUAL_BIG_Q)
    # the two processes on card 0 also check K11's peer mode: they meet at
    # its flag barrier, a time slice a barrier (tools/peer_probe.py case b)
    two = spawn(SHARD_GLOO_WORLD, "gloo", "cuda:0", q=SYMDUAL_GLOO_Q,
                single=False, peer_k11=True)
    out["a"] = symdual("a", *one["symdual"])
    out["f"] = dict(phase="symdual_sharded_f", backend="nccl",
                    call_s=one["big"][1], **one["big"][0][0])
    emit(out["f"])
    out["b"] = symdual("b", *two["symdual"])
    c1, single = maxcut("c1", *one["maxcut"], None, "peer")
    c2, _ = maxcut("c2", *two["maxcut"], single, "split")
    out["c"] = dict(world1=c1, world2=c2)
    # -- 25d: the batch on a (batch, model) mesh --
    dense, _ = batch_graphs()
    t0 = time.perf_counter()
    world = BATCH_SHARD_MESH[0] * BATCH_SHARD_MESH[1]
    ranks = spawn_ranks(batch_shard_rank, world, "gloo", "cuda:0",
                        args=(dense, MAXCUT_SHARD_P, seed + 25))
    call_s = time.perf_counter() - t0
    Ys, Cd, typ = batch_shard_inputs(dense, MAXCUT_SHARD_P, seed + 25, device)
    t0 = time.perf_counter()
    ref = make_batched_trustregions(make_maxcut_problem(dense=True),
                                    TROptions(maxiter=4, maxinner=10,
                                              tolgradnorm=1e-8))(Ys, Cd, typ)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    del Cd
    r0 = ranks[0]
    fx_ref = ref.fx.cpu().numpy()
    d = out["d"] = dict(
        phase="batch_sharded_d", instances=len(dense), n=dense[0].shape[0],
        p=MAXCUT_SHARD_P, mesh=list(BATCH_SHARD_MESH), backend="gloo",
        ranks_on="cuda:0", staging="host (gloo)", call_s=call_s,
        single_card_s=single_s,
        fx_rel=float(np.max(np.abs(r0["fx"] - fx_ref) / np.abs(fx_ref))),
        Y_abs=float(np.max(np.abs(r0.pop("Y") - ref.Y.cpu().numpy()))),
        ranks=ranks)
    emit(d)
    if not (d["fx_rel"] <= 1e-12 and d["Y_abs"] <= 1e-10):
        raise AssertionError(f"25d: fx {d['fx_rel']}, Y {d['Y_abs']}")
    for r in ranks:
        if not (np.array_equal(r["iters"], ref.iters) and
                np.array_equal(r["inner_iters"], ref.inner_iters)):
            raise AssertionError(f"25d: rank {r['rank']} counts differ")
        if r["digest"] != r0["digest"] or r["tcg"]["split"] <= 0 or \
                r["tcg"]["peer"] != 0:
            raise AssertionError(f"25d: rank {r['rank']}: {r['tcg']}")
    # -- 25e: NCCL across cards --
    if cards >= 2:
        from manisdp_tpu_torch.parallel.peer import tcg_mode
        want = tcg_mode("nccl", [(0, c) for c in range(nccl_world)])
        e = spawn(nccl_world, "nccl", "cuda", q=SYMDUAL_NCCL_Q, single=False)
        out["e"] = dict(symdual=symdual("e", *e["symdual"]),
                        maxcut=maxcut("e", *e["maxcut"], single, want)[0])
    else:
        out["e"] = dict(phase="sharded_6b_e", run=False,
                        reason=f"{cards} CUDA device: NCCL needs one card "
                        "per rank, so the cross-card runs need two or more")
        emit(out["e"])
    out["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="sharded_6b_summary", seconds=out["seconds"]))
    return out


def solve_phase(label, C_sp, source, device, check_oracle, tcg_shape=None):
    """One solve_maxcut_unitdiag call (p0 = 40) with its launch counts;
    with ``tcg_shape`` (p_pad, n) also the host and device ms per tCG
    iteration at its solution (tcg_iteration_ms, float32 as the solve's
    tcg32)."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch import solve_maxcut_unitdiag

    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_maxcut_unitdiag(C_sp, p0=40, device=device, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    out = dict(phase=label, source=source, n=C_sp.shape[0],
               nnz=int(C_sp.nnz), seconds=seconds, status=res.status,
               obj=res.obj, eta=res.eta, dinf=res.dinf,
               outer_iters=res.iterations, fac_size=res.fac_size,
               rtr_iters=res.rtr_iters, hess_calls=res.hess_calls,
               rtr_iters_per_s=res.rtr_iters / seconds, timers=res.timers,
               launches=launches, tcg_launches=dict(K.TCG_LAUNCHES),
               oblique_modes=dict(K.OBLIQUE_LAUNCHES))
    if tcg_shape is not None:
        out["tcg_iteration"] = tcg_iteration_ms(
            [C_sp], [res.Y], *tcg_shape, torch.float32, device)
    if check_oracle:
        out["oracle"] = kkt_oracle_on_card(C_sp, res, device)
    emit(out)
    if res.status != 0 or not res.eta <= 1e-8:
        raise AssertionError(f"{label}: status {res.status}, eta {res.eta}")
    if check_oracle and not out["oracle"]["eta"] <= 1e-8:
        raise AssertionError(f"{label}: KKT oracle {out['oracle']}")
    return out


def parse_phases(spec):
    """``--phases``: "1-3,20-21" -> the set of phases to run.  Phases 1-2
    always run; a phase brings the rest of its group, and a group the
    groups its checks read (GROUPS, NEEDS)."""
    want = {1, 2}
    for part in spec.split(","):
        if not part.strip():
            continue
        lo, _, hi = part.strip().partition("-")
        lo, hi = int(lo), int(hi or lo)
        if not 1 <= lo <= hi <= LAST_PHASE:
            raise ValueError(f"phase range {part!r} is not within "
                             f"1-{LAST_PHASE}")
        want.update(range(lo, hi + 1))
    while True:
        grown = set(want)
        for group in GROUPS:
            if grown & set(group):
                grown |= set(group)
        for phase, needs in NEEDS.items():
            if phase in grown:
                grown |= set(needs)
        if grown == want:
            return want
        want = grown


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gset", default=None,
                    help="Gset directory holding G1.txt and G67.txt")
    ap.add_argument("--bqp", default=None,
                    help="directory holding the reference's bqp_Q_60_1.txt "
                    "and bqp_e_60_1.txt (and the q = 30 files)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                    help="directory of the full JSON record")
    ap.add_argument("--phases", type=parse_phases,
                    default=parse_phases(f"1-{LAST_PHASE}"),
                    help="phases to run, e.g. 1-3,20-21 (default: all; "
                    "1-2 always run)")
    ap.add_argument("--capture-stall", action="store_true",
                    help="phase 7: record the devrr certificate's calls, "
                    "save the first converged point it cannot certify to "
                    "build/mc12000_stall/ and re-run the certificate there "
                    "under other budgets (ROADMAP Queue C)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import manisdp_tpu_torch  # noqa: F401  (fails outside the repository)
    pool, jobs = start_host_builds(args.bqp, args.phases)
    try:
        return run_phases(args, jobs)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()


def run_phases(args, jobs):
    """The selected phases and the closing lines; ``jobs`` are the pending
    host builds of start_host_builds."""
    import torch
    from manisdp_tpu_torch import kernels as K
    from manisdp_tpu_torch.kernels.build import build_info

    ph = args.phases
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    rows, al_rows, carrier_rows, dual_rows, mom_rows, batch_rows = \
        [], [], [], [], [], []
    rec = {}
    keep = {}       # instances of earlier phases that phase 23 solves again
    # -- 1. environment --
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs f64/f32")
    emit(dict(phase="environment", python=sys.version.split()[0],
              torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0),
              device_count=torch.cuda.device_count(), nvidia_smi=smi,
              phases=sorted(ph)))

    # -- 2. build --
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build_info.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=build_s, ptxas=ptxas))

    # -- 3. kernels vs twins --
    if 3 in ph:
        C67, _ = load_graph("G67", args.gset, args.seed)
        rows = phase_kernels(C67, device, args.seed)
        emit(dict(phase="kernels_vs_twins", cases=len(rows),
                  worst=worst_errors(rows),
                  table=[{k: r[k] for k in ("kernel", "mode", "dtype",
                                              "p_pad", "rel_err", "ms",
                                              "plain_ms")}
                         for r in rows]))

    # -- 4. G1-size solve (dense path) --
    if 4 in ph:
        C1, src1 = load_graph("G1", args.gset, args.seed)
        rec["g1"] = solve_phase("G1_solve", C1, src1, device,
                                check_oracle=True)
    # -- 5. G67-size solve: the slice --
    if 5 in ph:
        C67, src67 = load_graph("G67", args.gset, args.seed)
        g67 = rec["g67"] = solve_phase("G67_solve", C67, src67, device,
                                       check_oracle=True,
                                       tcg_shape=(HOT_P_PAD, 10 ** 4))
        for name in ("symcoo_spmm", "oblique_cols", "tcg_step"):
            if g67["launches"][name] <= 0:
                raise AssertionError(f"the G67 solve never launched {name}")
        check_tcg_launches("G67_solve", g67)

    # -- 6. K3 / K4 / K1 al_hess vs twins at the matrix-completion shapes --
    from manisdp_tpu_torch.ops.sparse import ConstraintOp
    if 6 in ph:
        data, mc_build_s = mc_instance(MC)
        t0 = time.perf_counter()
        op_mc = ConstraintOp.build(data.At, data.b, data.c, int(data.K.s),
                                   device)
        torch.cuda.synchronize()
        assemble_s = time.perf_counter() - t0
        al_rows = phase_al_kernels(op_mc, device, args.seed)
        emit(dict(phase="al_kernels_vs_twins", cases=len(al_rows),
                  worst=worst_errors(al_rows),
                  table=[{k: r.get(k) for k in ("kernel", "mode", "dtype",
                                                "p_pad", "rel_err", "ms",
                                                "plain_ms", "bound_ms",
                                                "library_ms", "bit_equal")}
                         for r in al_rows]))
        # -- 7. the slice's solve: matrix completion at n = 12,000 --
        spy = CertSpy() if args.capture_stall else None
        rec["mc12000"] = al_solve_phase(data, op_mc, mc_build_s, assemble_s,
                                        device, spy=spy)
        if spy is not None:
            rec["mc12000_stall"] = stall_study(spy, op_mc, os.path.join(
                "build", "mc12000_stall"))
            emit(dict(phase="mc12000_stall", **rec["mc12000_stall"]))
            del spy
        if 23 in ph or 24 in ph:
            keep["mc12000"] = (data, op_mc)
        del data, op_mc

    # -- 8. carrier kernels vs twins at the n = 4,000 matrix completion --
    if 8 in ph:
        from manisdp_tpu_torch.ops.sparse import EntrywiseConstraintOp
        data4, mc4_build_s = mc_instance(MC4)
        setup = rec["mc4000_setup"] = dict(instance_build_s=mc4_build_s)
        t0 = time.perf_counter()
        op4 = ConstraintOp.build(data4.At, data4.b, data4.c,
                                 int(data4.K.s), device)
        torch.cuda.synchronize()
        setup["assemble_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ew4 = EntrywiseConstraintOp.detect(op4)
        torch.cuda.synchronize()
        setup["entrywise_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense4 = op4.to_dense_op()
        torch.cuda.synchronize()
        setup["dense_build_s"] = time.perf_counter() - t0
        carrier_rows = phase_carrier_kernels(ew4, dense4, device, args.seed)
        emit(dict(phase="carrier_kernels_vs_twins", instance=MC4, n=op4.n,
                  m=op4.m, nnzA=op4.nnz, **setup, cases=len(carrier_rows),
                  worst=worst_errors(carrier_rows),
                  table=[{k: r.get(k) for k in ("kernel", "mode", "dtype",
                                                "rel_err", "ms", "plain_ms",
                                                "bit_equal")}
                         for r in carrier_rows]))
        del ew4, dense4
        # -- 9-11. the carriers' solves: matrix completion at n = 4,000 --
        rec["mc4000"] = carrier_solve_phases(data4, op4, device)
        if 23 in ph:
            keep["mc4000"] = data4
        del op4, data4

    # -- 12. the dual path's kernels vs twins --
    if 12 in ph:
        from manisdp_tpu_torch.frontends.sos import assemble_bqpsos
        from manisdp_tpu_torch.ops.dualops import DualOp
        from manisdp_tpu_torch.ops.symdual import SymDualOp
        from manisdp_tpu_torch.solvers.dual_general import build_iab
        dual_setup = rec["dual_setup"] = {}
        Q60, e60, bqp_label = bqp_instance(BQP_Q, args.bqp)
        t0 = time.perf_counter()
        top60 = SymDualOp.build_bqpsos(Q60, e60, BQP_Q, device=device)
        torch.cuda.synchronize()
        dual_setup["symdual_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data60 = assemble_bqpsos(Q60, e60, BQP_Q)
        dual_setup["assemble_bqpsos_s"] = time.perf_counter() - t0
        A60, b60, c60, mb60, f60, dAAt60 = data60
        t0 = time.perf_counter()
        dop60 = DualOp.build(A60, b60 / np.max(np.abs(b60)), c60, mb60, f60,
                             dAAt60, device=device)
        torch.cuda.synchronize()
        dual_setup["dualop_build_s"] = time.perf_counter() - t0
        Aq, bq, cq, mbq, fq, dAAtq = qs_instance(QS_D)
        t0 = time.perf_counter()
        iab30 = build_iab(Aq, mbq, fq, dAAtq, device)
        torch.cuda.synchronize()
        dual_setup["build_iab_s"] = time.perf_counter() - t0
        dual_rows = phase_dual_kernels(top60, dop60, iab30, device,
                                       args.seed)
        del iab30
        emit(dict(phase="dual_kernels_vs_twins", instance=bqp_label,
                  n_expanded=top60.n, n=mb60, m=dop60.m,
                  nnzA=int(dop60.v_r.numel()), **dual_setup,
                  cases=len(dual_rows), worst=worst_errors(dual_rows),
                  table=[{k: r.get(k) for k in ("kernel", "mode", "dtype",
                                                "rel_err", "ms", "plain_ms",
                                                "bound_ms", "library_ms",
                                                "bit_equal", "passes_ms")}
                         for r in dual_rows]))
        # -- 13-15. the dual solves --
        rec["dual"] = dual_phases(args, device, top60, dop60,
                                  (Q60, e60, data60), bqp_label)
        if 23 in ph:
            keep["bqp60"] = (Q60, e60, data60, dop60, bqp_label)
        del top60, dop60, data60

    # -- 16. the moment primal's and the multiblock drivers' kernels --
    if 16 in ph:
        from manisdp_tpu_torch.ops.symmom import SymMomOp
        mom_setup = rec["mom_setup"] = {}
        t0 = time.perf_counter()
        mop60 = SymMomOp.build_bqpmom(Q60, e60, BQP_Q, device=device)
        torch.cuda.synchronize()
        mom_setup["symmom_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chain_mom = jobs["chain_mom"].get()
        mom_setup["chain_build_wait_s"] = time.perf_counter() - t0
        N_chain = int(np.sum(chain_mom[0].K.s))
        mom_rows = phase_mom_kernels(mop60, N_chain, device, args.seed)
        emit(dict(phase="mom_kernels_vs_twins", instance=bqp_label,
                  n_expanded=mop60.n, m_flat=mop60.m, chain_N=N_chain,
                  **mom_setup, cases=len(mom_rows),
                  worst=worst_errors(mom_rows),
                  table=[{k: r.get(k) for k in ("kernel", "mode", "dtype",
                                                "rel_err", "ms", "plain_ms",
                                                "bound_ms", "bit_equal",
                                                "passes_ms")}
                         for r in mom_rows]))
        # -- 17. the BQP moment primal --
        t0 = time.perf_counter()
        raw60 = jobs["bqpmom60"].get()
        mom_setup["bqpmom60_build_wait_s"] = time.perf_counter() - t0
        rec["mom"] = mom_phases(args, device, mop60, Q60, e60, bqp_label,
                                rec["dual"]["bqp60_expanded"]["obj"], raw60)
        del mop60, raw60
        # -- 18. the clique chain through both multiblock drivers --
        t0 = time.perf_counter()
        chain_sos = jobs["chain_sos"].get()
        mom_setup["chain_sos_build_wait_s"] = time.perf_counter() - t0
        rec["chain"] = chain_phases(device, chain_mom, chain_sos)
        del chain_mom, chain_sos
        # -- 19. solve_sedumi on a two-block input --
        rec["two_block"] = two_block_phase(device)

    # -- 20. the batch kernels vs twins --
    if 20 in ph or 21 in ph:
        dense_b, sparse_b = batch_graphs()
    if 20 in ph:
        batch_rows = phase_batch_kernels(sparse_b[:BATCH_GRID_B], device,
                                         args.seed)
        emit(dict(phase="batch_kernels_vs_twins", cases=len(batch_rows),
                  worst=worst_errors(batch_rows),
                  table=[{k: r[k] for k in ("kernel", "mode", "dtype",
                                              "p_pad", "instances",
                                              "rel_err", "ms", "plain_ms",
                                              "bound_ms", "library_ms")}
                         for r in batch_rows]))
    # -- 21. the batched solves --
    if 21 in ph:
        rec["batch"] = dict(
            dense=batch_phase(
                "batch_dense", dense_b,
                f"{BATCH_DENSE} seeded G1-size stand-ins (seeds 0-"
                f"{BATCH_DENSE - 1})", device),
            sparse=batch_phase(
                "batch_sparse", sparse_b,
                f"seeded toroidal +-1 grid stand-ins: {BATCH_GRID_B} of "
                f"{BATCH_GRID[0]} x {BATCH_GRID[1]} (G48's shape) and "
                f"{BATCH_GRID2_B} of {BATCH_GRID2[0]} x {BATCH_GRID2[1]}",
                device, repeat=True,
                tcg_shape=(BATCH_GRID_B, BATCH_P_PADS[-1], BATCH_N_PAD)))
        if rec["batch"]["sparse"]["instance_launches"]["symcoo_spmm"] <= 0:
            raise AssertionError("the sparse batch never launched K1's "
                                 "instance mode")
    # -- 22. the multiblock determinism check --
    if 22 in ph:
        rec["chain5"] = chain_repeat_phase(device, jobs["chain5"].get())
    # -- 23. the float32 options: mixed, the lobpcg certificate, the f32
    #    LOBPCG stage --
    if 23 in ph:
        rec["f32"] = f32_phases(args, device, rec, keep, jobs)
    # -- 24. the sharded primal AL and the data-parallel batch --
    if 24 in ph:
        rec["sharded"] = shard_phases(device, rec, keep)
    keep.clear()
    # -- 25. the row-sharded SOS-dual operator and the model-sharded RTR --
    if 25 in ph:
        rec["sharded_6b"] = sharded_6b_phases(device, args.seed)

    # each kernel's hot call on its main path: the f32 tCG's Hessian and
    # projection (G67 solve), the f32 AL Hessian's products (mc solves),
    # the f64 refinement pass (dense_eigh solve), the f32 dual Hessian's
    # operator, adjoint and epilogue (bqp solves), the f32 moment
    # Hessian's operator and adjoint (bqpmom60), the f64 masked Hessian
    # epilogue (chain primal), the f64 batched Hessian, projection and tCG
    # step (sparse batch)
    def pick(table, name, mode, p_pad=None, dtype="float32"):
        return next(r for r in table if r["kernel"] == name and
                    r["mode"] == mode and r["dtype"] == dtype and
                    r.get("p_pad") == p_pad)

    def worst_abs(table, name, modes):
        return max(r["max_abs_err"] for r in table
                   if r["kernel"] == name and r["mode"] in modes)

    all_rows = rows + al_rows + carrier_rows + dual_rows + mom_rows + \
        batch_rows
    # (phases whose results it reads, and then: name, row, modes whose
    #  worst error it reports, source, replaces, launches on the main path)
    specs = [
        ((3, 5), lambda: (
            "symcoo_spmm.hess", pick(rows, "symcoo_spmm", "hess", HOT_P_PAD),
            None, "symcoo_spmm.cu", "ops/sparse.py:40",
            rec["g67"]["launches"]["symcoo_spmm"])),
        ((3, 5), lambda: (
            "oblique_cols.proj", pick(rows, "oblique_cols", "proj",
                                      HOT_P_PAD),
            None, "oblique_cols.cu", "manifolds/oblique.py:27",
            rec["g67"]["launches"]["oblique_cols"])),
        ((6,), lambda: (
            "symcoo_spmm.al_hess",
            pick(al_rows, "symcoo_spmm", "al_hess", AL_HOT_P_PAD), None,
            "symcoo_spmm.cu", "solvers/primal_al.py:97",
            rec["mc12000"]["symcoo_spmm_modes"]["al_hess"])),
        ((6,), lambda: (
            "pattern_dots", pick(al_rows, "pattern_dots", "pair_dots",
                                 AL_HOT_P_PAD), None,
            "pattern_dots.cu", "ops/sparse.py:240",
            rec["mc12000"]["launches"]["pattern_dots"])),
        ((6,), lambda: (
            "csr_gather", pick(al_rows, "csr_gather", "adjoint_on_pattern"),
            ("apply_from_e", "adjoint_on_pattern", "es_vals", "s_vals"),
            "csr_gather.cu", "ops/sparse.py:244",
            rec["mc12000"]["launches"]["csr_gather"])),
        ((8,), lambda: (
            "masked_sym.apply", pick(carrier_rows, "masked_sym", "apply"),
            ("apply",), "masked_sym.cu", "ops/sparse.py:551",
            rec["mc4000"]["entrywise"]["masked_modes"]["apply"])),
        ((8,), lambda: (
            "masked_sym.aat", pick(carrier_rows, "masked_sym", "aat"),
            ("aat",), "masked_sym.cu", "ops/sparse.py:558",
            rec["mc4000"]["entrywise"]["masked_modes"]["aat"])),
        ((8,), lambda: (
            "masked_sym.axpy", pick(carrier_rows, "masked_sym", "axpy"),
            ("axpy",), "masked_sym.cu", "ops/sparse.py:561",
            rec["mc4000"]["entrywise"]["masked_modes"]["axpy"])),
        ((8,), lambda: (
            "csr_gather.scatter_pos",
            pick(carrier_rows, "csr_gather", "scatter_pos"),
            ("scatter_pos", "scatter_pos_adjoint"), "csr_gather.cu",
            "ops/sparse.py:401",
            rec["mc4000"]["dense"]["csr_modes"]["scatter_pos"])),
        ((8,), lambda: (
            "oa_refine", pick(carrier_rows, "oa_refine", "f64",
                              dtype="float64"), ("f64",), "oa_refine.cu",
            "ops/dense_cert.py:83",
            rec["mc4000"]["dense_eigh"]["launches"]["oa_refine"])),
        ((12,), lambda: (
            "symdual_apply", pick(dual_rows, "symdual_apply", "apply"),
            ("apply", "y_step"), "symdual_apply.cu", "ops/symdual.py:97",
            rec["dual"]["bqp60_expanded"]["launches"]["symdual_apply"])),
        ((12,), lambda: (
            "symdual_adjoint.adjoint",
            pick(dual_rows, "symdual_adjoint", "adjoint"),
            ("adjoint", "adjoint_scaled"), "symdual_adjoint.cu",
            "ops/symdual.py:174",
            rec["dual"]["bqp60_expanded"]["symdual_modes"]["adjoint"])),
        ((12,), lambda: (
            "symdual_adjoint.residual",
            pick(dual_rows, "symdual_adjoint", "residual", dtype="float64"),
            ("residual",), "symdual_adjoint.cu", "ops/symdual.py:174",
            rec["dual"]["bqp60_expanded"]["symdual_modes"]["residual"])),
        ((12,), lambda: (
            "symdual_adjoint.sym_factor",
            pick(dual_rows, "symdual_adjoint", "sym_factor_p192_renorm",
                 dtype="float64"),
            tuple(r["mode"] for r in dual_rows
                  if r["mode"].startswith("sym_factor")),
            "symdual_adjoint.cu", "ops/symdual.py:446",
            rec["dual"]["bqp60_expanded"]["symdual_modes"]["sym_factor"])),
        ((12,), lambda: (
            "symdual_adjoint.sym_mat",
            pick(dual_rows, "symdual_adjoint", "sym_mat", dtype="float64"),
            ("sym_mat",), "symdual_adjoint.cu", "ops/symdual.py:363",
            rec["dual"]["bqp60_expanded"]["symdual_modes"]["sym_mat"])),
        ((12,), lambda: (
            "oblique_cols.proj_eG",
            pick(dual_rows, "oblique_cols", "proj_eG", 192), ("proj_eG",),
            "oblique_cols.cu", "solvers/dual_al.py:123",
            rec["dual"]["bqp60_expanded"]["oblique_modes"]["proj_eG"])),
        ((12,), lambda: (
            "csr_gather.dual_op",
            pick(dual_rows, "csr_gather", "dual_apply"),
            ("dual_apply", "dual_y_step", "dual_adjoint"), "csr_gather.cu",
            "ops/dualops.py:178",
            rec["dual"]["bqp60_original"]["launches"]["csr_gather"])),
        ((12,), lambda: (
            "csr_gather.iab", pick(dual_rows, "csr_gather", "iab_mat"),
            ("iab_mat", "iab_rmat"), "csr_gather.cu",
            "solvers/dual_al.py:152",
            rec["dual"]["qs30_general"]["launches"]["csr_gather"])),
        ((16,), lambda: (
            "symmom_apply", pick(mom_rows, "symmom_apply", "apply"),
            ("apply",), "symmom_apply.cu", "ops/symmom.py:291",
            rec["mom"]["bqpmom60"]["launches"]["symmom_apply"])),
        ((16,), lambda: (
            "symmom_adjoint", pick(mom_rows, "symmom_adjoint", "adjoint"),
            ("adjoint", "es_vals"), "symmom_adjoint.cu",
            "ops/symmom.py:297",
            rec["mom"]["bqpmom60"]["launches"]["symmom_adjoint"])),
        ((16,), lambda: (
            "oblique_cols.masked",
            pick(mom_rows, "oblique_cols", "masked_proj_eG", 8,
                 dtype="float64"),
            ("masked_proj", "masked_proj_eG", "masked_retr",
             "masked_renormalize"), "oblique_cols.cu",
            "manifolds/product.py:52",
            rec["chain"]["primal"]["oblique_modes"]["masked"])),
        ((20, 21), lambda: (
            "symcoo_spmm.instance",
            pick(batch_rows, "symcoo_spmm", "instance_hess",
                 BATCH_P_PADS[0], dtype="float64"),
            ("instance_plain", "instance_cost", "instance_hess"),
            "symcoo_spmm.cu", "solvers/batch.py:68",
            rec["batch"]["sparse"]["instance_launches"]["symcoo_spmm"])),
        ((20, 21), lambda: (
            "oblique_cols.instance",
            pick(batch_rows, "oblique_cols", "instance_proj",
                 BATCH_P_PADS[0], dtype="float64"),
            ("instance_proj", "instance_retr", "instance_renormalize"),
            "oblique_cols.cu", "solvers/batch.py:78",
            rec["batch"]["sparse"]["instance_launches"]["oblique_cols"])),
        ((12, 15), lambda: (
            "tcg_step.euclidean", pick(dual_rows, "tcg_step", "step", 48,
                                       dtype="float64"),
            ("step",), "tcg_step.cu", "core/trustregions.py:102",
            rec["dual"]["qs30_general"]["launches"]["tcg_step"])),
        ((20, 21), lambda: (
            "tcg_step", pick(batch_rows, "tcg_step", "step_proj",
                             BATCH_P_PADS[-1], dtype="float64"),
            ("step", "step_proj", "step_proj_masked"), "tcg_step.cu",
            "core/trustregions.py:102",
            rec["batch"]["sparse"]["launches"]["tcg_step"])),
    ]
    kern = []
    if 24 in ph:
        kern += shard_piece_rows(rec["sharded"])
    if 25 in ph:
        kern += sharded_6b_rows(rec["sharded_6b"])
    for needs, make in specs:
        if not set(needs) <= ph:
            continue
        name, r, modes, src, rep, launches = make()
        base = name.split(".")[0]
        kern.append(dict(
            name=name, route="cuda", source=f"manisdp_tpu_torch/csrc/{src}",
            replaces=f"manisdp_tpu/{rep}", launches=launches,
            max_abs_err=(worst_abs(all_rows, base, modes) if modes
                         else worst_errors(rows + al_rows)[base]
                         ["max_abs_err"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **({"passes_ms": r["passes_ms"]} if "passes_ms" in r else {}),
            **({"f32_launches_phase23": sum(
                v["f32_launches"][base] for v in rec["f32"].values()
                if isinstance(v, dict))} if "f32" in rec else {}),
            **({"launches_phase24b_rank0": n24} if (n24 := launches_24b(
                name, rec["sharded"]["b"]["ranks"][0]) if "sharded" in rec
                else None) is not None else {})))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, phases=sorted(ph), build_s=build_s,
                       kernel_rows=rows, al_kernel_rows=al_rows,
                       carrier_kernel_rows=carrier_rows,
                       dual_kernel_rows=dual_rows, mom_kernel_rows=mom_rows,
                       batch_kernel_rows=batch_rows, **rec, kernels=kern,
                       total_s=time.perf_counter() - t_start),
                  f, indent=1)
    emit(dict(kernels=kern))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
