#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dqgp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds the Pauli-feature (K1), states (K2), fused
             Pauli-feature (K3) and fused states (K4) kernels and the
             adjoint kernel (the backward of K1 and K2) for sm_90a, K1's
             (both precisions) and K3's 11- and 12-qubit instantiations, and the
             first layouts that phases 9, 13, 15a and 16 time beside their
             redesigns (the adjoint's; K1's and K2's float64), one nvcc
             each, all started together, with ptxas's register and
             spill report; for each of the instantiations (1-12 qubits of K1
             in float32 and float64 and of K3, 1-10 of K2 in both precisions,
             K4 and the adjoint) its
             registers, stack frame and spills, which must be 0 and 0; K1's
             geometry and resident blocks an SM at the north star's circuit
             (float32 and float64), K1 float64's at config #7's, K3's at
             config #7's, K2's (float32 and float64) and K4's at config
             #5's, the adjoint's at all three;
3. K1      — the kernel against its plain PyTorch version on the same CUDA
             tensors: 8 circuit families x every qubit count 1..10 (each
             instantiation, both sides of the register/lane split) x batch
             {1, 130, 84240}, plus the main path's own shapes (chebyshev
             4 qubits / 3 layers, G=40, at B = 84240 step rows, 1000 CV and
             predict-train rows, 200 predict-test rows), max abs diff <= 5e-6;
4. main    — the north-star problem (bench.py:52-77: N=1000 2-D inputs,
             chebyshev 4 qubits / 3 layers, projected Matérn-1.5 kernel,
             4 regional agents, rho=L=100) trained for 5 ADMM iterations with
             per-iteration 5-fold CV through ``train(..., device=cuda)``,
             then ``predict_quantum_gp`` + ``evaluate_predictions`` on 200
             held-out rows. K1 must have run in every step, CV pass and
             predict, and K1's float64 instantiation in the condition-number
             backfill (``cond_mode="auto"`` is "host" on the card: one launch
             an agent and 16-row chunk of z rows); the z trajectory must stay within
             5e-3 and every CV and test NLPD within 0.05 of the JAX float64
             reference (tests/fixtures/torch_port_northstar.json);
4b. gate   — the same problem trained for the 25 iterations of the bench
             gate (bench.py:59-60) against the JAX float64 run of 25
             (tests/fixtures/torch_port_northstar_25.json): the largest z and
             CV-NLPD deviation up to iterations 5, 10, 15, 20 and 25, the
             first iteration and component that leaves the bars (z 5e-3,
             CV-NLPD 0.05), the test NLPD; K1's exact launch count again.
             The bars are asserted over the first GATE_HELD_ITERS
             iterations: two float32 feature engines part after that (the
             JAX package's own raw float32 leaves its float64 trajectory
             within ~10 iterations, bench.py:512-519);
5. times   — CUDA-event times of one ADMM iteration (step + CV, as train()
             runs it on the card, and with the condition numbers in the step
             as cond_mode="device" has them), of K1 vs
             its plain version at B=84240, G=40, n=4 (a call, and from the
             profiler the kernel alone, with its bound and share of it; the
             kernel alone at the 1000 CV rows too), and of the projected
             1000x1000 Gram;
6. states  — K2 (float32 <= 2e-6, float64 <= 1e-12), K1's float64
             instantiation (<= 1e-12) and K4 (<= 3e-6 against the plain fused
             engine and against the plain unfused states) on the same CUDA
             tensors: 8 families x every qubit count 1..10 (each
             instantiation, both sides of the register/lane split) x batch
             {1, 130, 22500}, plus the fidelity path's shapes (kyriienko
             6 qubits / 1 layer, G=23, at 22500 step rows, 900 CV and
             predict-train rows, 100 predict-test rows); every third float64
             angle is one of F64_SPECIAL_ANGLES (+-1e6, +-1e15, +-1e300,
             2^31, next to multiples of pi/2);
7. fidelity — BASELINE config #5 (kyriienko 6 qubits / 1 layer, fidelity
             kernel) at the reference's 1-D size: the synthetic dataset
             generated on the card (its float64 Gram through K2's float64
             instantiation; Y within 1e-6 of the JAX float64 dataset), the
             CLI's train/test split and regional partition over 4 agents,
             5 ADMM iterations with 5-fold CV, predict and evaluate. K2 must
             have run in every step, CV pass and predict, its float64
             instantiation in the dataset and the backfill; z within 5e-3,
             every agent NLL within rtol 1e-4, every CV-NLPD and the test
             NLPD within max(0.05, 2 |JAX f32 - JAX f64|) of the JAX float32
             values (tests/fixtures/torch_port_fidelity.json);
8. fused   — the same training for 2 iterations with fusion on: K4 runs in
             K2's place, under the same bars;
9. times   — one fidelity ADMM iteration (step + CV, without and with the
             condition numbers in the step), K2 vs plain and K4 vs
             plain fused (both from angles) at B=22500, G=23, n=6, with each
             one's bound and share of it; K2 vs K4 at 4, 6, 8 and 10 qubits
             (kyriienko, 1 layer) at the same row count, in turns, with
             their bounds and, from the profiler, each kernel's own device
             time beside K3's on the same program; the 900x900 fidelity
             Gram; the float64 kernels — K2 at the dataset's B=1000, K1 and
             K2 at 10 qubits (kyriienko, 1 layer) at B=1000 and B=22500 —
             each in turns with its first layout and its plain complex128
             version (a call), the two kernels alone (profiler), and the
             float64 bound;
10. K3     — the fused Pauli-feature kernel against its plain version (the
             plain fused engine) and against K1's plain unfused version on
             the same CUDA tensors, max abs diff <= 8e-6: 8 families x
             every qubit count 1..10 (each instantiation, both sides of the
             register/lane split) x batch {1, 130, 108032}, plus config #7's
             own shapes (chebyshev 10 qubits / 2 layers, G=70, at 108032
             step rows, 54016 zero-shift rows, 512 CV rows, 49999
             predict-train rows, 512 predict-test rows);
11. config #7 — BASELINE config #7 through ``train(..., device=cuda)`` with
             streamed gradients and CV on a 512-row subsample, then
             ``parallel.blocked.make_cg_predictor`` and
             ``evaluate_predictions``. (a) The fixture problem (config #7's
             width, 1111 samples over 8 agents, 3 iterations, CG predict of
             the 112 held-out rows) held to
             tests/fixtures/torch_port_config7.json: z within 5e-3, agent
             NLLs scored at JAX's own z of each iteration within
             max(1e-4, 2 x the JAX package's own relative spread there:
             its step's NLLs against the same z scored from float64
             features, its eager float32 engine and the float32 fused
             program), CV and test NLPD within
             max(0.05, 2 |JAX f32 - JAX f64|), the spread over JAX's
             feature precision. (b) Full size: 49999 rows
             over 64 agents (Nmax 844), 2 iterations, the CG predictor on
             all rows and a 512-row predict: K3's exact launch count and no
             other kernel, iteration 1's nll_sum within 1e-3 relative of the
             JAX package's 90126.2668, the streamed gradient within 1e-6
             of the central one on 2 agents, and the CG posterior within
             mean rtol 1e-3 / variance rtol 1e-2 (atol 1e-5) of the dense
             float64 one on the first 4096 training rows;
12. times  — one full-size ADMM iteration (step and CV), K3 (angles ->
             features) vs K1 vs the plain fused version at B=108032, n=10,
             G=70, in turns, with K3's bound; K3 vs K1 at 4, 6, 8 and 10
             qubits at the same row count (fusion's crossover on the card); the CG
             predictor's set-up (timed in 11b: features, pivoted Cholesky,
             the alpha solve) and 512-row predict, and the float64
             gram_matvec at N=49999 with 1 and 512 right-hand sides.

13. cond   — ``cond_mode`` "device", "host" and off (``compute_cond=False``):
             the north star for 5 iterations and config #5 for 2, each mode
             on the same z trajectory (cond is reporting only); the port's
             host backfill (float64 Grams from complex128 states through
             K1's and K2's float64 kernels) at the JAX fixture's z rows
             (tests/fixtures/torch_port_driver_modes.json) within rtol 1e-6
             where cond < 1e8 and in the reference's 1e12/1e15 bucket above;
             the backfill's time, the device-mode floors beside the host
             values, and the float64 kernels at the backfill's shapes in
             turns with their first layouts and plain versions;
14. chained — ``chain_iters``: the north star for 25 iterations in chunks
             of 5 and config #5 for 5 in one chunk, each a CUDA-graph replay
             of the chunk's steps and CV passes, against the same runs one
             iteration at a time: z, theta, psi identical, agent NLLs and CV
             scores within rtol 1e-12, the same stop; a stop inside a chunk
             (7 iterations in chunks of 3). K1 (north star) and K2 (config
             #5) must run inside the graph: their launches in a chained run
             are measured by the profiler, whose device record counts a
             graph's kernels at every replay (the wrappers count Python
             calls: the capture once, no replay), and must be the warm-up's
             2 plus 2k a replay; ms an iteration of both modes by CUDA
             events, kernels an iteration and the graph pool's peak;
15. autodiff — (a) the adjoint kernel (``csrc/circuit_vjp.cu``, K1's and
             K2's backward) against its plain version (torch.autograd
             through their plain versions): 8 families x every qubit count
             1..10 x batch {1, 130} x features and states, plus the three
             autodiff steps' shapes (VJP_SHAPES: the north star's B=1,040 at
             4 qubits, config #5's B=900 at 6, states, config #7's B=54,016
             at 10, the plain version on slices there), within 5e-5 of
             max(1, max |g|); at those shapes the kernel, its first layout
             (``csrc/circuit_vjp_first_layout.cu``) and the plain version in
             turns, each kernel alone from the profiler, and the bound;
             (b) the north star for 3 iterations with grad_method="autodiff"
             (K1 forward, the adjoint kernel backward, in every step; K1 in
             the CV passes) against the JAX fixture's run: z within 5e-3,
             CV-NLPD within 0.05, iteration 1's gradient within 1e-3 of its
             largest component of JAX's; one autodiff iteration timed beside
             the central one, and the adjoint's share of the step's device
             time; (c), after phase 12: config #7 with
             grad_method="autodiff", the fixture problem against
             tests/fixtures/torch_port_config7_autodiff.json (agent NLLs at
             JAX's z within phase 11a's bars, iteration 1's gradient within
             config7_autodiff_grad_bar, z within 5e-3), then at full width
             (49,999 rows, 64 agents, 2 iterations: K3 twice and the adjoint
             once an iteration, iteration 1's nll_sum against the JAX log's)
             and its step timed beside phase 12's streamed step;
16. cond7  — config #7 at full width (phase 11b's 49,999 rows over 64
             agents, 2 streamed iterations) with the CLI's defaults for the
             condition numbers: compute_cond=True, cond_mode "auto" (= host
             on the card). Its backfill makes exactly 64 x ceil(T/16) K1
             float64 launches and no other; the condition numbers of 4
             agents are held to the same backfill through the plain
             complex128 engine (rtol 1e-6 below 1e8, the reference's bucket
             above). Then the backfill at the JAX log's 25 iterations'
             shapes (one 16-row and one 9-row chunk an agent, 128 launches):
             total ms, K1 float64's and the eigvalsh's device ms, peak
             memory; K1 float64 at the 16-row chunk's B=13,504 in turns with
             its first layout and plain version.

17. cli    — the port's CLI (``dqgp_tpu_torch.cli``) on the card at full
             width, against the JAX package's CLI on the same flags
             (tests/fixtures/torch_port_cli.json,
             scripts/record_torch_port_cli.py). Run A: the README's SRTM
             command (BASELINE config #2: maharashtra, 1,000 normalized rows,
             chebyshev 4 qubits / 3 layers, projected Matérn, 4 agents) on
             the stand-in tiles of scripts/make_synthetic_tiles.py (written
             into srtm_data/ where missing, their digests JAX's), with
             --fit-noise --predictive-noise and 5 iterations: K1 in the step,
             CV and predicts, K1 float64 in the backfill and the noise fit.
             Run B: config #5 in the quantum-dataset mode: K2, K2 float64 in
             the dataset and the backfill. Each run's launches exactly
             (cli_launches_expected), no plain engine, the dataset after the
             split (X exact; Y within 1e-12 / 1e-6), the summary's keys and
             stop; run A's z and CV-NLPD over CLI_HELD_ITERS (the float32
             Gram forks the SRTM trajectory from iteration 2: the
             deviations of all 5 are printed), its condition numbers'
             buckets, its own test and train NLPD (0.05), its fitted sigma
             (rtol 1e-3) and test and train NLPD (0.05) at JAX's own z; run B's agent NLLs (rtol 1e-4), CV and
             test NLPD (config #5's bars) and ground-truth comparison (each
             metric of the trained z and of theta*: the NLPDs at the NLPD
             bar, the rest at rtol 1e-5; the verdict, which counts winners
             decided by differences below those bars, is printed). Then
             ``python -m dqgp_tpu_torch.cli ... --dataset-only`` in a
             subprocess. The ``cli`` line: each run's stage seconds (load,
             split, train, backfill, noise fit, predicts), launches and
             deviations.

18. scale-out — the rest of the one-device scale-out
             (``parallel/blocked.py``: the low-rank eigenvalue clip over a
             matrix-free LOBPCG, the Gram-free blocked Cholesky,
             ``nll_large``), on 11b's z: (a) the clip against the dense eigh
             clip (``regularize_gram``) on indefinite matrices (n = 64 and
             4,096) for both methods, rtol 1e-6 / atol 1e-8, lambda_min rtol
             1e-5, ``saturated`` both ways; on config #7's float64 Gram of
             4,096 rows; (b) runs C and D, ``--regularization thresholding``
             and ``tikhonov`` on the CLI's CG route with config #7's flags
             cut to 1,999 train rows, 8 agents, 2 iterations
             (SCALE_OUT_RUNS), against the JAX CLI's runs
             (tests/fixtures/torch_port_scale_out.json): K3's exact launches,
             no plain engine, the dataset, z and CV-NLPD over
             SCALE_OUT_HELD_ITERS, at JAX's z the test and train NLPD
             (max(0.05, twice JAX's own spread over float64 features and
             over the dense posterior)) and the CG route against the dense
             regularized posterior
             (mean rtol 1e-3, variance rtol 1e-2, atol 1e-5); (c) the
             float64 Gram-free factor of all 49,999 training rows (seconds,
             peak memory, logdet) and ``nll_large`` on 36,864 rows against
             a dense float64 factor (rtol 1e-8), and in float32; (d) the
             posterior of all 5,556 test rows from that factor, against
             11b's CG posterior on the first 512 (the CG bars), its metrics
             and seconds beside 11b's CG; (e)
             ``dqgp_tpu_torch.examples.scale_out_50k.run(20000)``.

19. 12 qubits — K1 (float32 and float64) and K3 with a sample's state
             across 2 and 4 warps (the 11- and 12-qubit instantiations, built
             from csrc/pauli_features_q11_12.cu, pauli_features_f64_q11_12.cu
             and pauli_features_fused_q11_12.cu): (a) against their plain
             versions at 11 and 12 qubits (chebyshev and random 2-D 2
             layers, every gate kind on the warp bits; B = 1, 131 and the
             slice's batch: 108,032 for K3 and K1 float32, 13,504 for K1
             float64, whose angles hold F64_SPECIAL_ANGLES), 5e-6 in float32
             and 1e-12 in float64, and their times beside their bounds;
             (b) config #7 at 12 qubits at full width (11b's 49,999 rows over
             64 agents, chebyshev 12 qubits / 2 layers, P = 84) for 2
             iterations with the CLI's condition numbers: K3's and K1
             float64's exact launches, no plain engine, iteration 1's agent
             NLLs of 2 agents against the plain float64 engine within config
             #7's NLL bar, the step, CV pass and backfill timed, then one
             iteration with fusion off (K1 float32 in K3's place); (c) the
             fixture problem at 12 qubits (999 rows over 8 agents, 2
             iterations, CG predict) held to tests/fixtures/torch_port_12q.json
             as 11a holds the 10-qubit one, and run E, config #7's CLI flags at
             12 qubits with the condition numbers and the noise fit on the CG
             route (RUN_E_FLAGS), held to the JAX CLI's run at run C's bars,
             the fitted sigma and the NLPDs at JAX's z.

The last two lines are a JSON record of the kernels (K1, K1_f64, K2,
K2_f64, K3, K4 and the adjoint, each with its bound: the larger of its bytes
over the card's memory rate and its operations over the rate of their type)
and ``{"ok": true, "device": {...}}``. The script imports nothing of JAX.

    python3 chip_smoke.py --k1

runs phases 1, 2, 3, 4b and K1's times only (no result lines): the quick
check of the Pauli-feature kernel.

    python3 chip_smoke.py --k3

runs phases 1, 2, 10 and K3's times only (no result lines): the quick check
of the fused Pauli-feature kernel.

    python3 chip_smoke.py --states

runs phases 1, 2, 6 and the two states kernels' times only (no result
lines): the quick check of K2 and K4.

    python3 chip_smoke.py --vjp

runs phases 1, 2 and 15a only (no result lines): the quick check of the
adjoint kernel.

    python3 chip_smoke.py --cond

runs phases 1, 2 and 16 only (no result lines): config #7 with its
condition numbers.

    python3 chip_smoke.py --cli

runs phases 1, 2 and 17 only (no result lines): the port's CLI.

    python3 chip_smoke.py --scale-out

runs phases 1, 2 and 18 only (no result lines), after training phase 11b's
problem for its z and CG posterior, and adds the full-size parts: the
example at its default N = 50,000 and the clip on all 49,999 training rows.

    python3 chip_smoke.py --q12

runs phases 1, 2 and 19 only (no result lines): 11 and 12 qubits.
"""

import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_northstar.json")
FIXTURE_25 = os.path.join(REPO, "tests", "fixtures", "torch_port_northstar_25.json")

# The north-star problem (bench.py:52-77) plus held-out test rows.
N_SAMPLES, N_TEST, N_AGENTS = 1000, 200, 4
NUM_QUBITS, NUM_FEATURES, NUM_LAYERS = 4, 2, 3
ITERS = 5
GATE_ITERS = 25       # the bench gate's trajectory length (bench.py:59-60)
GATE_HELD_ITERS = 7   # the prefix of it that holds the bars on the card (iteration 8
                      # leaves by a z component of ~3): phase 4b asserts them over it
GATE_MARKS = (5, 10, 15, 20, 25)
Z_TOL = 5e-3      # bench.py:59-60: z rounds to 4 dp each iteration; the bars
NLPD_TOL = 0.05   # cover last-digit flips, not a numerics divergence
K1_TOL = 5e-6     # float32 features, as tests/test_pallas_circuit.py holds them
STEP_ROWS = 4 * 81 * 260  # K1's batch in one step: agents x (2P+1) shifts x Nmax
K1_BATCHES = (1, 130, 84240)

# The fidelity-kernel problem: BASELINE config #5 (a 6-qubit, 1-layer
# kyriienko fidelity kernel on a synthetic quantum-GP dataset) at the
# reference's recommended 1-D size (cli.py:338), split and partitioned as
# cli.py:342-378 does.
FID_SAMPLES, FID_TEST_SPLIT, FID_AGENTS, FID_SEED = 1000, 0.1, 4, 42
FID_QUBITS, FID_LAYERS = 6, 1
FID_ITERS, FID_FUSED_ITERS = 5, 2
FID_STEP_ROWS = 4 * 25 * 225  # K2's batch in one step: agents x (2P+1) x Nmax
WARP_QUBITS = tuple(range(1, 11))  # every instantiation of K1's to K4's templates
STATES_CROSSOVER_QUBITS = (4, 6, 8, 10)  # K2 vs K4, kyriienko 1 layer
STATES_BATCHES = (1, 130, FID_STEP_ROWS)
K2_TOL = 2e-6     # float32 states, as tests/test_pallas_circuit.py holds them
F64_TOL = 1e-12   # float64 states and features, as tests/test_native.py
F64_TIMING_QUBITS = 10                       # the float64 kernels' times: kyriienko, 1 layer,
F64_TIMING_ROWS = (FID_SAMPLES, FID_STEP_ROWS)  # at the dataset's and the step's row counts
K4_TOL = 3e-6     # fused float32 states, as tests/test_fusion.py
NLL_RTOL = 1e-4
FIDELITY_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_fidelity.json")

# BASELINE config #7, the scale-out case (BASELINE.md:41), as
# results_round5/cli_config7_50k.log ran it: the classical 2-D dataset
# generate_data_numpy(55555, 2, 0.1, 42), a 0.1 held-out split, a regional
# partition over 64 agents (49,999 train rows, shards of 717-844), chebyshev
# 10 qubits / 2 layers (P = 70) under a projected Matérn kernel, rho = L =
# 100, noise 0.1, streamed gradients, CV on a 512-row subsample, then the CG
# posterior. The fixture problem keeps every width and cuts depth: 1,111
# samples over 8 agents.
C7_SAMPLES, C7_AGENTS, C7_NMAX = 55555, 64, 844
C7_FIX_SAMPLES, C7_FIX_AGENTS, C7_FIX_ITERS = 1111, 8, 3
C7_TEST_SPLIT, C7_SEED, C7_QUBITS, C7_LAYERS = 0.1, 42, 10, 2
C7_CV_MAX, C7_ITERS = 512, 2
C7_STEP_ROWS = 2 * C7_AGENTS * C7_NMAX   # K3's batch per parameter: +-h of every agent
C7_ZERO_ROWS = C7_AGENTS * C7_NMAX       # K3's batch for the Gram at wrap(z)
C7_NLL_ITER1 = 90126.2668   # results_round5/cli_config7_50k.log:71, the JAX package's
C7_CV_ITER1 = 104.8780      # iteration 1 from the same seeded initial state
C7_DENSE_ROWS, C7_TEST_ROWS = 4096, 512
K3_TOL = 8e-6     # fused float32 features, as tests/test_fusion.py:63
CROSSOVER_QUBITS = (4, 6, 8)     # K3 vs K1 below config #7's 10 qubits

# The card's published peaks (NVIDIA's data sheet, H100 SXM, at 700 W), for
# each kernel's bound: the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12   # outside the tensor cores, which these kernels do not use
CONFIG7_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_config7.json")

# The driver's modes (phases 13-15) on the north star and config #5, held to
# tests/fixtures/torch_port_driver_modes.json
# (scripts/record_torch_port_driver_modes.py).
DRIVER_MODES_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_driver_modes.json")
COND_ITERS, COND_FID_ITERS = 5, 2    # phase 13: cond_mode device / host / off
COND_RTOL = 1e-6                     # float64 Grams from complex128 states on both sides
COND_EXACT_BELOW = 1e8               # above it, the reference's bucket must agree
EIG_FIT_ROWS = 100                   # the backfill of a 100-iteration fit (the benchmark's)
EIG_REPS = 5
EIG_MAX_RTOL = 1e-10                 # max|w|, kernel vs eigvalsh on one float64 Gram
CHAIN_K = 5                          # phase 14: iterations a CUDA-graph replay
CHAIN_FID_ITERS = 5
CHAIN_STOP_ITERS, CHAIN_STOP_K = 7, 3  # a stop inside the third chunk
CHAIN_LONG_ITERS = 100               # the capture's one-time cost against a longer run
AUTODIFF_ITERS = 3                   # phase 15
AUTODIFF_GRAD_TOL = 1e-3             # of the largest component: float32 features on both
                                     # sides, whose last ulps the NLL solve amplifies
VJP_TOL = 5e-5                       # float32 adjoint vs plain autograd, of max(1, max |g|)
FIRST_LAYOUT_VJP = "circuit_vjp_first_layout.cu"  # the adjoint's first layout, timed in 15a
F64_FIRST_LAYOUT = "circuit_f64_first_layout.cu"  # K1's and K2's float64 first layout, timed
FIRST_LAYOUTS = (FIRST_LAYOUT_VJP, F64_FIRST_LAYOUT)  # in phases 9, 13 and 16
# angles that phase 6 sets among the random float64 ones: large (the float64
# sin_cos's Payne-Hanek reduction from 2^31 up) and next to multiples of pi/2
F64_SPECIAL_ANGLES = (1e6, -1e6, 1e15, -1e15, 1e300, -1e300, 2.0 ** 31, np.pi / 2, np.pi,
                      -3 * np.pi, float(np.nextafter(np.pi, 4.0)), 1e5 * np.pi)
# phase 16: config #7 with the CLI's condition numbers (cond_mode "auto" = "host"
# on the card), then the backfill at the shapes of the JAX log's 25 iterations
# (one 16-row and one 9-row chunk an agent), held against the plain engine on
# C7_COND_HELD agents
C7_COND_ITERS, C7_COND_HELD = 25, 4
VJP_PLAIN_ROWS = 2048                # the plain autograd's slice at config #7's shape: its
                                     # saved states (54,016 x 1024 complex64 a gate) do not fit
# phase 15a's timed shapes: each autodiff step's adjoint launch (agents x Nmax rows)
VJP_SHAPES = (("north star", N_AGENTS * 260, "features"),
              ("config #5", FID_AGENTS * 225, "states"),
              ("config #7", C7_AGENTS * C7_NMAX, "features"))
CONFIG7_AUTODIFF_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                                        "torch_port_config7_autodiff.json")

# phase 17: the port's CLI, held to tests/fixtures/torch_port_cli.json (the
# JAX package's CLI on the same flags, scripts/record_torch_port_cli.py).
# Run A is the README's SRTM command (BASELINE config #2, README.md:77-81)
# on the stand-in tiles of scripts/make_synthetic_tiles.py, with the noise
# fit and 5 of --max-iter's default 100 iterations; run B is BASELINE config
# #5 in the CLI's quantum-dataset mode.
CLI_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_cli.json")
CLI_ITERS = 5
CLI_RUNS = {
    "A": ["--real-world-dataset", "srtm", "--srtm-region", "maharashtra",
          "--dataset-max-samples", "1000", "--dataset-normalize",
          "--encoding", "chebyshev", "--kernel-type", "projected", "--num-layers", "3",
          "--num-qubits", "4", "--outer-kernel", "matern", "--rho", "100", "--L", "100",
          "--n-agents", "4",
          "--fit-noise", "--predictive-noise", "--no-plot", "--max-iter", str(CLI_ITERS)],
    "B": ["--input-dim", "1", "--n-dataset", "1000", "--encoding", "kyriienko",
          "--num-qubits", "6", "--num-layers", "1", "--kernel-type", "fidelity",
          "--n-agents", "4", "--riemannian-method", "conjugate_gradient",
          "--seed", "42", "--data-seed", "42", "--no-plot", "--max-iter", str(CLI_ITERS)],
}
SRTM_DIR = os.path.join(REPO, "srtm_data")
SIGMA_RTOL = 1e-3   # run A's fitted noise, at JAX's own z
CLI_Y_TOL = {"A": 1e-12,  # the Y scaling's summation order
             "B": 1e-6}   # config #5's data: its float64 Gram on the card (phase 7's bar)
# Run A's z and CV-NLPD are held over this prefix of its iterations: the
# float32 Matérn Gram's last ulps fork the SRTM trajectory from iteration 2
# (ROADMAP Queue 3; tests/test_torch_cli.py follows JAX's run exactly with
# JAX's float32 Grams in the step). Its noise fit and NLPDs are then held at
# JAX's own z; every deviation of its own run is printed.
CLI_HELD_ITERS = 1
GT_METRIC_RTOL = 1e-5   # run B's prediction metrics but the NLPD (float32 features)

# phase 18: the rest of the one-device scale-out. Runs C and D are config #7's
# CLI flags (results_round5/cli_config7_50k.log: classical 2-D data, chebyshev
# 10 qubits / 2 layers, projected Matérn, regional partition, streamed
# gradients, CV on a 512-row subsample; compute_cond off, as
# examples/scale_out_training.py:89,96 runs it) with --regularization on the
# CG route, cut to 2,222 samples (1,999 train rows), 8 agents and 2
# iterations, and --predict-cg-threshold 1024 so that the CLI takes the CG
# route. SCALE_OUT_CPU_RUNS are the same flags at the north star's circuit,
# 4 agents and 270 train rows, the size the CPU tests run. Both are held to
# tests/fixtures/torch_port_scale_out.json (scripts/record_torch_port_scale_out.py).
SCALE_OUT_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_scale_out.json")
_SCALE_OUT_COMMON = ["--classical-dataset", "--input-dim", "2", "--data-seed", "42",
                     "--encoding", "chebyshev", "--kernel-type", "projected",
                     "--outer-kernel", "matern", "--partition", "regional",
                     "--grad-method", "streamed", "--cv-max-samples", "512", "--max-iter", "2",
                     "--no-cond", "--no-plot"]
SCALE_OUT_RUNS = {
    name: _SCALE_OUT_COMMON + ["--n-dataset", "2000", "--num-qubits", "10", "--num-layers", "2",
                               "--n-agents", "8", "--predict-cg-threshold", "1024",
                               "--regularization", method]
    for name, method in (("C", "thresholding"), ("D", "tikhonov"))}
SCALE_OUT_CPU_RUNS = {
    name: _SCALE_OUT_COMMON + ["--n-dataset", "270", "--num-qubits", "4", "--num-layers", "3",
                               "--n-agents", "4", "--predict-cg-threshold", "128",
                               "--regularization", method]
    for name, method in (("C", "thresholding"), ("D", "tikhonov"))}
SCALE_OUT_HELD_ITERS = 1   # z and CV-NLPD: the float32 Gram may fork iteration 2
SCALE_OUT_Y_TOL = 1e-12
CG_MEAN_RTOL, CG_VAR_RTOL, CG_ATOL = 1e-3, 1e-2, 1e-5   # §2's CG-vs-dense bars
CLIP_RTOL, CLIP_ATOL = 1e-6, 1e-8       # the clip vs eigh (tests/test_blocked.py:224-233)
CLIP_LAMBDA_RTOL = 1e-5
CLIP_N = (64, 4096)                     # 18a's indefinite matrices
CLIP_NEGATIVES = {64: (-0.8, -0.05), 4096: (-0.8, -0.05, -1e-3)}
CLIP_GRAM_ROWS = 4096                   # 18a's slice of config #7's Gram
NLL_LARGE_ROWS = 36 * 1024              # the example's nll_large rows
NLL_LARGE_RTOL = 1e-8                   # float64 blocked vs dense factor at 36,864 rows
EXAMPLE_N, EXAMPLE_FULL_N = 20000, 50000

# phase 19: 11 and 12 qubits. K1 (float32 and float64) and K3 with a sample's
# state across 2 and 4 warps (csrc/pauli_features_q11_12.cu,
# pauli_features_f64_q11_12.cu, pauli_features_fused_q11_12.cu) against their
# plain versions, then config #7 at 12 qubits (BASELINE.md:41: "10-12 qubits"):
# chebyshev 12 qubits / 2 layers, P = 84, at full width (19b) and against the
# JAX package (19c: tests/fixtures/torch_port_12q.json,
# scripts/record_torch_port_12q.py).
WIDE_QUBITS = (11, 12)
WIDE_BATCHES = (1, 131)     # one sample; a batch that ends inside a round of groups
WIDE_HELD_ROWS = 4096       # the rows held to the plain version at the slice's batch
C12_QUBITS = 12
C12_F64_ROWS = 16 * C7_NMAX  # K1 float64 in the backfill: 16 z rows of the largest agent
Q12_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_12q.json")
C12_FIX_SAMPLES, C12_FIX_AGENTS, C12_FIX_ITERS = 1111, 8, 2
# the CPU tests' cut of the fixture problem: 2 agents of 23-24 rows, 1 iteration
C12_CPU_SAMPLES, C12_CPU_AGENTS, C12_CPU_ITERS = 53, 2, 1
# run E: config #7's CLI flags (phase 18b's) at 12 qubits with the CLI's
# condition numbers (no --no-cond) and the noise fit, on the CG route; and
# the same flags at the CPU tests' size: 44 samples (40 train rows), 2
# agents, 1 iteration, the CG route from 16 train rows
_RUN_E_COMMON = [f for f in _SCALE_OUT_COMMON if f != "--no-cond"]


def _run_e_flags(n_dataset: int, agents: int, cg_threshold: int, iters: int):
    flags = list(_RUN_E_COMMON)
    flags[flags.index("--max-iter") + 1] = str(iters)
    return flags + ["--n-dataset", str(n_dataset), "--num-qubits", str(C12_QUBITS),
                    "--num-layers", "2", "--n-agents", str(agents),
                    "--predict-cg-threshold", str(cg_threshold), "--fit-noise"]


RUN_E_FLAGS = _run_e_flags(2000, 8, 1024, 2)
RUN_E_CPU_FLAGS = _run_e_flags(40, 2, 16, 1)


def array_digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float64).tobytes()).hexdigest()


def make_problem():
    """Seeded north-star data: (X, Y, X_test, Y_test) as float64 numpy."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (N_SAMPLES, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(N_SAMPLES)
    X_test = rng.uniform(-0.99, 0.99, (N_TEST, 2))
    Y_test = (np.sin(3 * X_test[:, 0]) * np.cos(2 * X_test[:, 1])
              + 0.1 * rng.randn(N_TEST))
    return X, Y, X_test, Y_test


def problem_digest(X, Y, X_test, Y_test) -> str:
    h = hashlib.sha256()
    for a in (X, Y, X_test, Y_test):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def backfill_launches(iters: int, agents: int) -> int:
    """Float64 feature launches of the host condition-number backfill
    (``driver.host_condition_numbers``): one an agent and 16-row chunk."""
    return agents * -(-iters // 16)


def backfill_eig_counts(iters: int, sizes) -> dict:
    """The batched eigenvalue kernel's counts (``ops/cuda_eig.py``) in the
    host backfill of ``iters`` z rows over agents of ``sizes`` rows: one
    launch a 16-row chunk for every agent whose Gram it takes (at most its
    limit of rows), each of those Grams counted, and the other agents' Grams
    through eigvalsh."""
    from dqgp_tpu_torch.ops.cuda_eig import MAX_N

    took = sum(n <= MAX_N for n in sizes)
    return {"eig": -(-iters // 16) if took else 0, "eig_grams": iters * took,
            "eig_eigvalsh_grams": iters * (len(sizes) - took)}


def counts_hold(counts: dict, want: dict) -> bool:
    """Every count of ``want`` in ``counts``."""
    return all(counts[k] == v for k, v in want.items())


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def agent_rows(log_path: str) -> list:
    """Each agent's training rows, as the CLI's log lists them."""
    with open(log_path) as f:
        return [int(n) for n in re.findall(r"^\s*Agent \d+: (\d+) samples$", f.read(), re.M)]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _cuda_time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _alternate_ms(fns, reps: int):
    """Times of each fn in ``fns`` (ms), measured in turns a, b, ..., b, a
    after one warm-up call each; returns the mean of the two turns."""
    for f in fns:
        f()
    first = [_cuda_time_ms(f, reps) for f in fns]
    second = [_cuda_time_ms(f, reps) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def _device_ms(fn, reps: int, name: str = "") -> float:
    """Device time of one call of ``fn`` (ms), which launches one kernel:
    the kernel's own time as torch.profiler records it over ``reps`` calls,
    without the host's share of a call, which is most of a small launch's
    CUDA-event time. Averaged over the launches the profiler kept: on a
    loaded host it drops some, and a sum over ``reps`` would then read low.
    With ``name``, only kernels whose name holds it count. Where it kept
    none in two tries, the CUDA-event time of a call stands in (an upper
    bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [k for k in prof.key_averages() if k.device_time_total > 0 and name in k.key]
        kept = sum(k.count for k in kernels)
        if kept:
            return sum(k.device_time_total for k in kernels) / kept * 1e-3
    return _cuda_time_ms(fn, reps)


def build_kernels(sources):
    """Build every source with its own nvcc, all started together; returns
    {source: (report line, ptxas log: empty where a build was reused)}."""
    from dqgp_tpu_torch.ops import _build

    def one(src):
        t0 = time.time()
        lib_path, log = _build.build(src)
        return f"{src} -> {os.path.basename(lib_path)} in {time.time() - t0:.2f} s", log

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(one, sources)))


# the warp kernels' entry functions, templated on the qubit count
WARP_KERNELS = {"K1": "warp_pauli_features_kernel", "K1_f64": "warp_pauli_features_f64_kernel",
                "K2": "warp_states_kernel", "K2_f64": "warp_states_f64_kernel",
                "K3": "warp_features_kernel", "K4": "warp_states_fused_kernel",
                "vjp": "warp_vjp_kernel"}


def warp_ptxas(log: str, entry: str) -> dict:
    """{qubits: (registers, stack bytes, spill store bytes, spill load bytes)}
    of every instantiation of the kernel template ``entry`` in ptxas -v's
    report."""
    found, n, frame = {}, None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            n = None
        m = re.search(rf"Compiling entry function '\w*?\d+{entry}ILi(\d+)E", ln)
        if m:
            n = int(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and n is not None:
            found[n] = (int(m.group(1)),) + frame
            n = None
    return dict(sorted(found.items()))


def fidelity_problem(dev):
    """Config #5's dataset generated on ``dev``, split and partitioned as
    cli.py:342-378 does. Returns (spec, X, Y, theta*, X_tr, Y_tr, X_te,
    Y_te, splits)."""
    import contextlib
    import io

    from dqgp_tpu_torch.data import (
        generate_quantum_gp_data, split_data_numpy, train_test_split_np)
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    spec = QuantumKernelSpec(
        circuit=build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS),
        kernel_type="fidelity")
    X, Y, theta = generate_quantum_gp_data(
        FID_SAMPLES, 1, spec, data_seed=FID_SEED, param_seed=FID_SEED, device=dev)
    X_tr, X_te, Y_tr, Y_te, _, _ = train_test_split_np(X, Y, FID_TEST_SPLIT, FID_SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X_tr, Y_tr, FID_AGENTS, "regional", 1.0, FID_SEED)
    return spec, X, Y, theta, X_tr, Y_tr, X_te, Y_te, splits


def config7_spec(qubits: int = C7_QUBITS):
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    return QuantumKernelSpec(circuit=build_circuit("chebyshev", qubits, 2, C7_LAYERS),
                             kernel_type="projected", outer_kernel="matern")


def config7_problem(n_samples: int, n_agents: int):
    """Config #7's classical dataset, split and partitioned as the CLI's
    classical mode does (cli.py:342-378). Returns (X_tr, Y_tr, X_te, Y_te,
    splits) as float64 numpy."""
    import contextlib
    import io

    from dqgp_tpu_torch.data import (
        generate_data_numpy, split_data_numpy, train_test_split_np)

    X, Y = generate_data_numpy(n_samples, 2, 0.1, C7_SEED)
    X_tr, X_te, Y_tr, Y_te, _, _ = train_test_split_np(X, Y, C7_TEST_SPLIT, C7_SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X_tr, Y_tr, n_agents, "regional", 1.0, C7_SEED)
    return X_tr, Y_tr, X_te, Y_te, splits


def config7_train_config(iters: int, grad_method: str = "streamed", compute_cond: bool = False,
                         **kw):
    """The driver settings of config #7's run (examples/scale_out_training.py:
    89,96 sets compute_cond=False; the CLI's default is True, phase 16)."""
    from dqgp_tpu_torch.driver import TrainConfig

    return TrainConfig(max_iter=iters, seed=C7_SEED, grad_method=grad_method,
                       cv_max_samples=C7_CV_MAX, compute_cond=compute_cond, **kw)


def config7_test_nlpd_bar(ref) -> float:
    """max(0.05, 2 |JAX f32 - JAX f64 features|) for the CG test NLPD; both
    packages solve in float64 here (the port on every device)."""
    t_ref = ref["test_metrics"]["nlpd"]
    return max(NLPD_TOL, 2 * abs(t_ref - ref["test_nlpd_f64_features"]))


C7_NLL_RESCORES = ("agent_nll_f64_features", "agent_nll_eager_f32", "agent_nll_fused_f32")


def config7_nll_bars(ref) -> np.ndarray:
    """Per-iteration agent-NLL bars: max(1e-4, 2 x the JAX package's own
    spread), the spread being the largest relative difference of that
    iteration between its step's agent NLLs and the same NLLs re-scored at
    the same z from float64 features, from its eager float32 engine and from
    the float32 gate-fused program (the one K3 runs), where the fixture
    holds them. On these 10-qubit Matérn Grams a last-ulp feature change
    moves an agent NLL by up to ~5e-4 relative."""
    nll = np.array(ref["agent_nll"])
    spread = np.max([(np.abs(nll - np.array(ref[k])) / np.abs(nll)).max(axis=1)
                     for k in C7_NLL_RESCORES if k in ref], axis=0)
    return np.maximum(NLL_RTOL, 2 * spread)


C7_GRAD_RESCORES = ("iteration1_grad_f64_features", "iteration1_grad_fused_f32")


def config7_autodiff_grad_bar(ref) -> float:
    """Iteration 1's autodiff gradient bar at config #7, as a fraction of
    its largest component: max(AUTODIFF_GRAD_TOL, 2 x the JAX package's own
    spread), the spread being the largest difference between its step's
    gradient and the same gradient from float64 features and from the
    float32 gate-fused program (the one K3 runs), as the fixture
    (tests/fixtures/torch_port_config7_autodiff.json) holds them. The
    10-qubit Matérn Grams amplify a last-ulp feature change in the gradient
    as they do in the agent NLLs (config7_nll_bars)."""
    g = np.array(ref["iteration1_grad"])
    spread = max(np.abs(np.array(ref[k]) - g).max() for k in C7_GRAD_RESCORES)
    return max(AUTODIFF_GRAD_TOL, 2 * spread / np.abs(g).max())


def config7_agent_nll_at(spec, splits, z_traj, dev, noise_std: float) -> np.ndarray:
    """The port's agent NLLs (len(z_traj), A) at the given consensus vectors:
    the step's Gram at wrap(z) for all agents in one feature call, then the
    masked float64 NLL, as the streamed step forms them.

    From iteration 2 on, two runs' z trajectories part within the z bar (a
    last-ulp feature change moves a 4-dp-rounded gradient), and an agent NLL
    at a different z differs by more than the feature engines do. Scored at
    the reference's own z, the agent NLLs compare the engines alone."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.models.gp.posterior import masked_nll_core
    from dqgp_tpu_torch.parallel.consensus import agent_grams, make_agent_batch

    batch = make_agent_batch(splits, dev)
    out = []
    for z in z_traj:
        z32 = M.wrap(torch.as_tensor(z, dtype=torch.float64, device=dev)).to(torch.float32)
        K = agent_grams(spec, batch.X, z32[None])[:, 0].to(torch.float64)
        res, _ = masked_nll_core(K, batch.Y.to(torch.float64), batch.mask.to(torch.float64),
                                 noise_std, compute_cond=False)
        out.append(res.nll.cpu().numpy())
    return np.array(out)


def check_config7_fixture(res, metrics, ref, iters: int, nll_at_ref_z):
    """Hold a fixture-problem run (its first ``iters`` iterations), the
    port's agent NLLs at the reference's z trajectory (``nll_at_ref_z``,
    from ``config7_agent_nll_at``) and its CG test metrics (None to skip) to
    tests/fixtures/torch_port_config7.json; returns (z dev, worst NLL rel
    dev, worst CV-NLPD dev / bar, test NLPD dev / bar)."""
    z_dev, nll_dev, cv_ratio = check_fidelity_run(res, ref, iters, "config #7 fixture",
                                                  config7_nll_bars(ref), nll=nll_at_ref_z)
    if metrics is None:
        return z_dev, nll_dev, cv_ratio, float("nan")
    t_ref = ref["test_metrics"]["nlpd"]
    t_bar = config7_test_nlpd_bar(ref)
    t_ratio = abs(metrics["nlpd"] - t_ref) / t_bar
    check(np.isfinite(metrics["nlpd"]) and t_ratio <= 1.0,
          f"config #7 fixture test NLPD {metrics['nlpd']} vs JAX f32 {t_ref} beyond {t_bar}")
    return z_dev, nll_dev, cv_ratio, t_ratio


def check_fidelity_run(res, ref, iters: int, what: str, nll_rtol=NLL_RTOL, nll=None):
    """Hold a fidelity training run to the fixture's first ``iters``
    iterations; returns (z dev, worst NLL rel dev, worst CV-NLPD dev / bar).
    ``nll_rtol`` is one bar, or one per iteration; ``nll`` (iters, A) are
    the agent NLLs held to the fixture's, by default the run's own."""
    check(res.iterations == iters, f"{what}: stopped after {res.iterations} != {iters}")
    z = np.array([h["consensus_params"] for h in res.cv_history])
    z_dev = float(np.abs(z - np.array(ref["z_trajectory"][:iters])).max())
    if nll is None:
        nll = np.array([h["agent_losses"] for h in res.nll_history])
    nll = np.asarray(nll)[:iters]
    nll_ref = np.array(ref["agent_nll"][:iters])
    nll_bar = np.broadcast_to(np.asarray(nll_rtol, np.float64).reshape(-1, 1)[:iters],
                              nll_ref.shape)
    nll_rel = np.abs(nll - nll_ref) / np.abs(nll_ref)
    nll_dev = float(nll_rel.max())
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    cv32 = np.array(ref["cv_nlpd"][:iters])
    cv_bar = np.maximum(NLPD_TOL, 2 * np.abs(cv32 - np.array(ref["cv_nlpd_f64_features"][:iters])))
    cv_ratio = float((np.abs(cv - cv32) / cv_bar).max())
    check(bool(np.all(np.isfinite(nll))) and bool(np.all(np.isfinite(cv))),
          f"{what}: non-finite NLL or CV score")
    check(z_dev <= Z_TOL, f"{what}: z trajectory deviates {z_dev} > {Z_TOL}")
    check(bool(np.all(nll_rel <= nll_bar)), f"{what}: agent NLLs deviate "
          f"{nll_rel.max(axis=1).tolist()} (relative, per iteration) beyond the bars "
          f"{np.asarray(nll_rtol).tolist()}")
    check(cv_ratio <= 1.0, f"{what}: CV-NLPD {cv.tolist()} vs JAX f32 {cv32.tolist()} "
          f"beyond the bars {cv_bar.tolist()}")
    return z_dev, nll_dev, cv_ratio


def _allclose(got, want, rtol: float, atol: float) -> float:
    """The worst of |got - want| / (atol + rtol |want|) (<= 1 passes)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def northstar_spec():
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    return QuantumKernelSpec(
        circuit=build_circuit("chebyshev", NUM_QUBITS, NUM_FEATURES, NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")


def check_k1(rand_angles) -> float:
    """Phase 3: K1 (float32) against its plain version on the same CUDA
    tensors, for 8 families x every qubit count K1 is built for x batch {1,
    130, 84240}, plus the north star's own shapes. Returns the worst max abs
    diff."""
    import torch

    from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    main_circuit = northstar_spec().circuit
    cases = [(build_circuit(enc, n, NUM_FEATURES, 2), B)
             for enc in ENCODING_TYPES for n in WARP_QUBITS for B in K1_BATCHES]
    cases += [(main_circuit, B) for B in (STEP_ROWS, N_SAMPLES, N_TEST)]
    worst = 0.0
    for circuit, B in cases:
        n = circuit.num_qubits
        angles = rand_angles(circuit, B)
        got = K.pauli_features_from_angles(circuit, angles)
        want = K.pauli_features_reference(circuit, angles)
        torch.cuda.synchronize()
        check(got.shape == (B, 3 * n) and got.dtype == torch.float32,
              f"K1 shape {tuple(got.shape)} {got.dtype}")
        err = float((got - want).abs().max())
        check(np.isfinite(err) and err <= K1_TOL,
              f"K1 vs plain {circuit.name} {n}q B={B}: max abs diff {err}")
        worst = max(worst, err)
        del angles, got, want
    print(f"phase 3 K1 vs plain ({time.time() - t0:.2f} s): {len(cases)} cases, max abs diff "
          f"{worst:.3e} (tol {K1_TOL})", flush=True)
    return worst


def time_k1(rand_angles) -> dict:
    """K1 vs its plain version at the north star's step shape, in turns
    within one call (a call by CUDA events), and the kernel alone on the
    device (profiler) there and at the CV pass's 1000 rows, with the step
    shape's bound. Returns the times (ms) and the bound for the kernels
    record."""
    from dqgp_tpu_torch.ops import cuda_circuit as K

    circuit = northstar_spec().circuit
    angles = rand_angles(circuit, STEP_ROWS)
    k1_ms, plain_ms = _alternate_ms(
        [lambda: K.pauli_features_from_angles(circuit, angles),
         lambda: K.pauli_features_reference(circuit, angles)], 20)
    device_ms = _device_ms(lambda: K.pauli_features_from_angles(circuit, angles), 20)
    cv_angles = rand_angles(circuit, N_SAMPLES)
    cv_device_ms = _device_ms(lambda: K.pauli_features_from_angles(circuit, cv_angles), 20)
    bound, bound_by = k1_bound(circuit, STEP_ROWS)
    return {"ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "device_ms": device_ms, "device_ms_cv_rows": cv_device_ms}


def k1_times_text(t: dict) -> str:
    return (f"K1 {t['ms']:.4f} ms a call vs plain {t['plain_ms']:.4f} ms at B={STEP_ROWS} "
            f"G={northstar_spec().circuit.num_gates} n={NUM_QUBITS} "
            f"({t['plain_ms'] / t['ms']:.1f}x), the kernel alone on the device (profiler) "
            f"{t['device_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), K1 at {t['bound_ms'] / t['ms']:.1%} of it a call, "
            f"{t['bound_ms'] / t['device_ms']:.1%} the kernel alone; the kernel alone at "
            f"B={N_SAMPLES} {t['device_ms_cv_rows']:.4f} ms")


def gate_deviations(z, cv, ref):
    """A north-star run (z (T, P), CV-NLPD (T,)) against the reference's
    first T iterations: (per-iteration largest |z - z_ref|, per-iteration
    |cv - cv_ref|, the number of leading iterations inside both bars, and
    the first departure as (iteration, "z[component]" or "CV-NLPD",
    deviation), or None)."""
    z, cv = np.asarray(z, np.float64), np.asarray(cv, np.float64)
    T = len(z)
    z_abs = np.abs(z - np.asarray(ref["z_trajectory"][:T]))
    z_dev = z_abs.max(axis=1)
    cv_dev = np.abs(cv - np.asarray(ref["cv_nlpd"][:T]))
    for i in range(T):
        if not z_dev[i] <= Z_TOL:
            comp = int(np.argmax(np.where(np.isnan(z_abs[i]), np.inf, z_abs[i])))
            return z_dev, cv_dev, i, (i + 1, f"z[{comp}]", float(z_dev[i]))
        if not cv_dev[i] <= NLPD_TOL:
            return z_dev, cv_dev, i, (i + 1, "CV-NLPD", float(cv_dev[i]))
    return z_dev, cv_dev, T, None


def northstar_gate(dev) -> dict:
    """Phase 4b: the north-star problem trained for the bench gate's 25
    iterations through K1, against the JAX float64 run of 25."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.data import split_data_numpy
    from dqgp_tpu_torch.driver import TrainConfig, train
    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp
    from dqgp_tpu_torch.ops import cuda_circuit as K

    with open(FIXTURE_25) as f:
        ref = json.load(f)
    X, Y, X_test, Y_test = make_problem()
    check(problem_digest(X, Y, X_test, Y_test) == ref["problem"]["sha256"]
          and ref["iterations"] == GATE_ITERS, "the 25-iteration fixture is another problem's")
    spec = northstar_spec()
    splits = split_data_numpy(X, Y, N_AGENTS, "regional")
    cfg = TrainConfig(max_iter=GATE_ITERS, verbose=False)
    K.reset_launch_counts()
    t0 = time.time()
    res = train(spec, splits, X, Y, cfg, device=dev)
    mean, var = predict_quantum_gp(
        spec, torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
        torch.as_tensor(X_test, device=dev), torch.as_tensor(res.z, device=dev),
        noise_std=cfg.noise_std)
    metrics = evaluate_predictions(Y_test, mean, var)
    torch.cuda.synchronize()
    gate_s = time.time() - t0
    counts = K.launch_counts()
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    f64 = backfill_launches(GATE_ITERS, N_AGENTS)
    eig = backfill_eig_counts(GATE_ITERS, [len(x) for x, _ in splits])
    check(counts["K1"] == 2 * GATE_ITERS + 2 + rescores and counts["K1_f64"] == f64
          and counts_hold(counts, eig)
          and sum(counts.values()) == counts["K1"] + f64 + sum(eig.values()),
          f"gate launches {counts}: want K1 = 2*{GATE_ITERS} + 2 + {rescores}, K1_f64 = {f64} "
          f"and {eig} (the condition-number backfill) and no other kernel")
    check(res.iterations == GATE_ITERS and res.converged_by == ref["converged_by"],
          f"gate run stopped {res.converged_by}@{res.iterations}")
    z = np.array([h["consensus_params"] for h in res.cv_history])
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    check(bool(np.all(np.isfinite(z))) and bool(np.all(np.isfinite(cv)))
          and bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()),
          "non-finite z, CV score or prediction in the gate run")
    z_dev, cv_dev, held, first = gate_deviations(z, cv, ref)
    # the same deviation as a distance on the torus: z is wrapped to one
    # period, so a component next to the seam reads as a whole period apart
    wrapped = np.abs(z - np.asarray(ref["z_trajectory"][:len(z)])) % M.PERIOD
    torus_dev = np.minimum(wrapped, M.PERIOD - wrapped).max(axis=1)
    nlpd_dev = abs(metrics["nlpd"] - ref["test_metrics"]["nlpd"])
    print(f"phase 4b north-star gate: {GATE_ITERS} ADMM iterations + predict in {gate_s:.2f} s; "
          f"K1 launches {counts['K1']} (= 2*{GATE_ITERS} + 2 + {rescores}), K1_f64 {f64} (the "
          f"condition-number backfill); largest deviation "
          f"from the JAX float64 run up to iteration "
          + ", ".join(f"{m}: z {z_dev[:m].max():.1e} (on the torus {torus_dev[:m].max():.1e}) "
                      f"/ CV-NLPD {cv_dev[:m].max():.1e}" for m in GATE_MARKS)
          + f" (bars {Z_TOL} / {NLPD_TOL}); inside both bars for the first {held} iterations"
          + (f", first out at iteration {first[0]}: {first[1]} by {first[2]:.3e} (on the "
             f"torus {torus_dev[first[0] - 1]:.3e})" if first else "")
          + f"; test NLPD {metrics['nlpd']:.4f} vs {ref['test_metrics']['nlpd']:.4f} (dev "
          f"{nlpd_dev:.1e}, bar {NLPD_TOL}); asserted over the first {GATE_HELD_ITERS}",
          flush=True)
    check(held >= GATE_HELD_ITERS, f"the gate's bars hold for {held} iterations, fewer than "
          f"{GATE_HELD_ITERS}: first out {first}")
    if GATE_HELD_ITERS == GATE_ITERS:
        check(nlpd_dev <= NLPD_TOL, f"gate test NLPD deviates {nlpd_dev} > {NLPD_TOL}")
    return {"held_iterations": held, "first_out": first, "z_dev": float(z_dev.max()),
            "z_torus_dev": float(torus_dev.max()), "cv_dev": float(cv_dev.max()),
            "test_nlpd_dev": nlpd_dev}


def check_k3(rand_angles):
    """Phase 10: K3 against its plain version (the plain fused engine) and
    K1's plain unfused version on the same CUDA tensors, for 8 families x
    every qubit count K3 is built for x batch {1, 130, 108032}, plus config
    #7's own shapes. Returns the worst max abs diff against each."""
    import torch

    from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    circuit = config7_spec().circuit
    n_train_full = C7_SAMPLES - int(np.ceil(C7_TEST_SPLIT * C7_SAMPLES))
    cases = [(build_circuit(enc, n, 2, 2), B) for enc in ENCODING_TYPES
             for n in WARP_QUBITS for B in (1, 130, C7_STEP_ROWS)]
    cases += [(circuit, B) for B in (C7_STEP_ROWS, C7_ZERO_ROWS, C7_CV_MAX,
                                     n_train_full, C7_TEST_ROWS)]
    worst = worst_unfused = 0.0
    for c, B in cases:
        a = rand_angles(c, B)
        got = K.pauli_features_from_angles_fused(c, a)
        torch.cuda.synchronize()
        check(got.shape == (B, 3 * c.num_qubits) and got.dtype == torch.float32,
              f"K3 shape {tuple(got.shape)} {got.dtype}")
        e = float((got - K.pauli_features_fused_reference(c, a)).abs().max())
        eu = float((got - K.pauli_features_reference(c, a)).abs().max())
        check(np.isfinite(e) and e <= K3_TOL and np.isfinite(eu) and eu <= K3_TOL,
              f"K3 vs plain {c.name} {c.num_qubits}q B={B}: max abs diff {e} (fused), "
              f"{eu} (unfused) > {K3_TOL}")
        worst, worst_unfused = max(worst, e), max(worst_unfused, eu)
        del a, got
    print(f"phase 10 K3 vs plain ({time.time() - t0:.2f} s): {len(cases)} cases, max abs "
          f"diff {worst:.3e} vs the plain fused engine, {worst_unfused:.3e} vs K1's plain "
          f"unfused version (tol {K3_TOL})", flush=True)
    return worst, worst_unfused


def time_k3(rand_angles, smi: str) -> dict:
    """K3 (angles -> features) vs K1 vs the plain fused version at config #7's
    step shape (10 qubits), in turns within one call, and K3 vs K1 at 4, 6
    and 8 qubits (chebyshev, 2 layers) at the same row count: fusion's
    crossover on the card. Returns the times (ms) and K3's bound."""
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    circuit = config7_spec().circuit
    a = rand_angles(circuit, C7_STEP_ROWS)
    k3_ms, k1_ms, plain_ms = _alternate_ms(
        [lambda: K.pauli_features_from_angles_fused(circuit, a),
         lambda: K.pauli_features_from_angles(circuit, a),
         lambda: K.pauli_features_fused_reference(circuit, a)], 5)
    del a
    crossover = {}
    for n in CROSSOVER_QUBITS:
        c = build_circuit("chebyshev", n, 2, C7_LAYERS)
        a = rand_angles(c, C7_STEP_ROWS)
        crossover[n] = _alternate_ms([lambda: K.pauli_features_from_angles_fused(c, a),
                                      lambda: K.pauli_features_from_angles(c, a)], 10)
        del a
    crossover[C7_QUBITS] = [k3_ms, k1_ms]
    bound_ms, bound_by = k3_bound(circuit, C7_STEP_ROWS)
    print(f"phase 12 K3 times ({time.time() - t0:.2f} s) [{smi}]: at B={C7_STEP_ROWS} "
          f"n={C7_QUBITS} G={circuit.num_gates}: K3 {k3_ms:.3f} ms vs K1 {k1_ms:.3f} ms vs "
          f"plain fused {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), K3 at "
          f"{bound_ms / k3_ms:.1%} of it, K3/K1 {k3_ms / k1_ms:.3f}; K3 vs K1 at "
          f"B={C7_STEP_ROWS}, chebyshev 2 layers: "
          + ", ".join(f"{n} qubits {t3:.4f} vs {t1:.4f} ms ({t3 / t1:.2f})"
                      for n, (t3, t1) in crossover.items()), flush=True)
    return {"ms": k3_ms, "plain_ms": plain_ms, "k1_ms": k1_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "k3_vs_k1_ms": {str(n): list(t) for n, t in crossover.items()}}


# Operations of one sample, counted from the arithmetic the kernels run: a
# multiply or an add is one, a fused multiply-add two, a sine or a cosine
# one; swaps and sign flips none.

def gate_ops(circuit) -> int:
    """The unfused gate sequence (statevector.cuh, and warp_state.cuh's
    apply_gate: K1 and K2)."""
    from dqgp_tpu_torch.ops.circuit import CRX, CRY, CRZ, CX, CZ, H, RZZ

    dim, ops = circuit.dim, 0
    for g in circuit.gates:
        if g.kind == RZZ:            # half angle, sin, cos; a phase on each amplitude
            ops += 3 + 6 * dim
        elif g.kind == H:            # (r0 +- r1) * sqrt(1/2) for each of 4 outputs
            ops += 8 * (dim // 2)
        elif g.kind not in (CX, CZ):  # rotations: 4 outputs of 2 products and a sum
            ops += 3 + 12 * (dim // 4 if g.kind in (CRX, CRY, CRZ) else dim // 2)
    return ops


def fused_program_ops(circuit) -> int:
    """The fused program (fusion.py: K3 and K4): each SU2 op's 2x2 built from
    its gates (half angle, sin, cos and a complex 2x2 product per gate), then
    applied to its amplitude pairs (28 operations a pair, 12 where the 2x2 is
    real or diagonal); each diagonal run's K-term phase, sin, cos and complex
    multiply per amplitude."""
    from dqgp_tpu_torch.ops.fusion import DiagOp, SU2Op, fuse_circuit

    dim, ops = circuit.dim, 0
    for op in fuse_circuit(circuit).ops:
        if isinstance(op, SU2Op):
            pairs = dim // 4 if op.control >= 0 else dim // 2
            ops += 59 * len(op.gate_idxs) + pairs * (12 if op.real or op.diag else 28)
        elif isinstance(op, DiagOp):
            ops += dim * (2 * op.K + 7)
    return ops


def feature_ops(n: int) -> int:
    """<X_q>, <Y_q>, <Z_q> of every qubit: 16 operations an amplitude pair."""
    return n * (16 * (1 << (n - 1)) + 2)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(the least time the card could take, in ms; "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound(circuit, B: int, real_bytes: int = 4):
    """K1: angles (B, G) in, features (B, 3n) out, float32 (or float64
    against the card's FP64 rate with ``real_bytes`` 8)."""
    n = circuit.num_qubits
    return bound_ms(real_bytes * B * (circuit.num_gates + 3 * n),
                    B * (gate_ops(circuit) + feature_ops(n)),
                    FP64_OPS_PER_S if real_bytes == 8 else FP32_OPS_PER_S)


def k2_bound(circuit, B: int, real_bytes: int = 4):
    """K2: angles (B, G) float32 in, states (B, 2^n) complex64 out (or
    float64 and complex128 against the card's FP64 rate with ``real_bytes``
    8)."""
    return bound_ms(real_bytes * B * (circuit.num_gates + 2 * circuit.dim),
                    B * gate_ops(circuit),
                    FP64_OPS_PER_S if real_bytes == 8 else FP32_OPS_PER_S)


def k3_bound(circuit, B: int):
    """K3: angles (B, G) and C in (from 11 qubits up the kernel derives C's
    columns and reads no C), features (B, 3n) out, float32."""
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops.fusion import diag_patterns_concat, fuse_circuit

    n = circuit.num_qubits
    c_bytes = (diag_patterns_concat(fuse_circuit(circuit)).nbytes
               if n <= K.ONE_WARP_QUBITS else 0)
    return bound_ms(4 * B * (circuit.num_gates + 3 * n) + c_bytes,
                    B * (fused_program_ops(circuit) + feature_ops(n)))


def k4_bound(circuit, B: int):
    """K4: angles (B, G) float32 and C in, states (B, 2^n) complex64 out."""
    from dqgp_tpu_torch.ops.fusion import diag_patterns_concat, fuse_circuit

    c_bytes = diag_patterns_concat(fuse_circuit(circuit)).nbytes
    return bound_ms(4 * B * circuit.num_gates + 8 * B * circuit.dim + c_bytes,
                    B * fused_program_ops(circuit))


def check_states(rand_angles) -> dict:
    """Phase 6: K2 (float32 and float64), K1's float64 instantiation and K4
    against their plain versions on the same CUDA tensors, for 8 families x
    every qubit count the kernels are built for x batch {1, 130, 22500},
    plus config #5's own shapes; the float64 angles hold F64_SPECIAL_ANGLES
    in every third place. K4 is held to the plain fused engine and to the
    plain unfused states. Returns the worst max abs diff of each."""
    import torch

    from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    fid_circuit = build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS)
    n_train = FID_SAMPLES - int(np.ceil(FID_TEST_SPLIT * FID_SAMPLES))
    st_cases = [(build_circuit(enc, n, NUM_FEATURES, 2), B)
                for enc in ENCODING_TYPES for n in WARP_QUBITS for B in STATES_BATCHES]
    st_cases += [(fid_circuit, B) for B in (FID_STEP_ROWS, n_train, FID_SAMPLES - n_train)]
    err = dict.fromkeys(("K2", "K2_f64", "K1_f64", "K4", "K4_unfused"), 0.0)

    def hold(key, got, want, tol, what):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{key} {what}: {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        e = float((got - want).abs().max())
        check(np.isfinite(e) and e <= tol, f"{key} vs plain {what}: max abs diff {e} > {tol}")
        err[key] = max(err[key], e)

    special = torch.tensor(F64_SPECIAL_ANGLES, dtype=torch.float64, device="cuda")
    for circuit, B in st_cases:
        what = f"{circuit.name} {circuit.num_qubits}q B={B}"
        a32, a64 = rand_angles(circuit, B), rand_angles(circuit, B, torch.float64)
        flat = a64.view(-1)[::3]  # every third float64 angle a special one
        flat.copy_(special.repeat(flat.numel() // len(special) + 1)[:flat.numel()])
        plain = K.states_reference(circuit, a32)
        hold("K2", K.states_from_angles(circuit, a32), plain, K2_TOL, what)
        fused = K.states_from_angles_fused(circuit, a32)
        hold("K4", fused, K.states_fused_reference(circuit, a32), K4_TOL, what)
        hold("K4_unfused", fused, plain, K4_TOL, what)
        del plain, fused
        hold("K2_f64", K.states_from_angles(circuit, a64),
             K.states_reference(circuit, a64), F64_TOL, what)
        hold("K1_f64", K.pauli_features_from_angles(circuit, a64),
             K.pauli_features_reference(circuit, a64), F64_TOL, what)
    print(f"phase 6 states vs plain ({time.time() - t0:.2f} s): {len(st_cases)} cases; max "
          f"abs diff K2 f32 {err['K2']:.3e} (tol {K2_TOL}), K2 f64 {err['K2_f64']:.3e} (tol "
          f"{F64_TOL}), K1 f64 {err['K1_f64']:.3e} (tol {F64_TOL}; the float64 angles hold "
          f"{', '.join(f'{v:g}' for v in F64_SPECIAL_ANGLES)} in every third place), K4 "
          f"{err['K4']:.3e} vs plain fused / {err['K4_unfused']:.3e} vs plain unfused (tol "
          f"{K4_TOL})", flush=True)
    return err


def time_f64(name: str, circuit, angles, reps: int) -> dict:
    """K1's or K2's float64 kernel (``name``) at one shape: its first layout,
    the register layout and the plain complex128 version in turns within one
    call (CUDA events, a call each), then the two kernels alone (the
    profiler), and the float64 bound. The first layout is held to the new
    kernel at F64_TOL on the way."""
    from dqgp_tpu_torch.ops import cuda_circuit as K

    new, plain, first, bound = {
        "K1_f64": (K.pauli_features_from_angles, K.pauli_features_reference,
                   pauli_features_f64_first_layout, k1_bound),
        "K2_f64": (K.states_from_angles, K.states_reference, states_f64_first_layout,
                   k2_bound)}[name]
    calls = [lambda: first(circuit, angles), lambda: new(circuit, angles),
             lambda: plain(circuit, angles)]
    e = float((calls[0]() - calls[1]()).abs().max())
    check(e <= F64_TOL, f"{name}'s first layout and register layout differ by {e}")
    first_ms, ms, plain_ms = _alternate_ms(calls, reps)
    # each kernel by its own name: a stray record would halve the average
    first_dev = _device_ms(calls[0], reps, {"K1_f64": "pauli_features_kernel_f64",
                                            "K2_f64": "states_kernel_f64"}[name])
    dev = _device_ms(calls[1], reps, WARP_KERNELS[name])
    B = angles.shape[0]
    b, by = bound(circuit, B, 8)
    return {"name": name, "B": B, "qubits": circuit.num_qubits, "gates": circuit.num_gates,
            "first_layout_ms": first_ms, "ms": ms, "plain_ms": plain_ms,
            "first_layout_device_ms": first_dev, "device_ms": dev, "bound_ms": b,
            "bound_by": by}


def f64_text(t: dict) -> str:
    return (f"{t['name']} n={t['qubits']} G={t['gates']} B={t['B']}: first layout "
            f"{t['first_layout_ms']:.4f} ms (alone {t['first_layout_device_ms']:.4f}) -> "
            f"{t['ms']:.4f} ms (alone {t['device_ms']:.4f}) vs plain {t['plain_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}): "
            f"{t['bound_ms'] / t['device_ms']:.2%} of it alone (first layout "
            f"{t['bound_ms'] / t['first_layout_device_ms']:.2%})")


def time_states(rand_angles, smi: str) -> dict:
    """K2 and K4 (both angles -> states) vs their plain versions at config
    #5's step shape, in turns within one call; K2 vs K4 at 4, 6, 8 and 10
    qubits (kyriienko, 1 layer) at the same row count, each with its bound:
    fusion's crossover for states on the card. A call's time is by CUDA
    events; at these sizes most of it is the host's, so the kernels' own
    device time is read from the profiler beside it, and there K3 runs the
    same program too: the fused body under its own bit map with a reduction
    where K4 has its store, which is what the states kernels' map and
    write-out cost. Then K2's float64 instantiation vs plain complex128 at
    the dataset's 1000 rows, and the two float64 kernels (K1's and K2's
    shared-memory layout) at 10 qubits against their plain versions and
    float64 bounds. Returns each kernel's times (ms) and bound for the
    kernels record."""
    import torch

    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    fid_circuit = build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS)
    a = rand_angles(fid_circuit, FID_STEP_ROWS)
    k2_ms, k2_plain_ms, k4_ms, k4_plain_ms = _alternate_ms(
        [lambda: K.states_from_angles(fid_circuit, a),
         lambda: K.states_reference(fid_circuit, a),
         lambda: K.states_from_angles_fused(fid_circuit, a),
         lambda: K.states_fused_reference(fid_circuit, a)], 20)
    k2_dev_ms = _device_ms(lambda: K.states_from_angles(fid_circuit, a), 20)
    k4_dev_ms = _device_ms(lambda: K.states_from_angles_fused(fid_circuit, a), 20)
    del a
    crossover = {}
    for n in STATES_CROSSOVER_QUBITS:
        c = build_circuit("kyriienko", n, 1, FID_LAYERS)
        a = rand_angles(c, FID_STEP_ROWS)
        calls = [lambda: K.states_from_angles(c, a),
                 lambda: K.states_from_angles_fused(c, a),
                 lambda: K.pauli_features_from_angles_fused(c, a)]
        t2, t4 = _alternate_ms(calls[:2], 20)
        crossover[n] = (t2, k2_bound(c, FID_STEP_ROWS)[0], t4, k4_bound(c, FID_STEP_ROWS)[0],
                        *(_device_ms(f, 20) for f in calls))
        del a
    # the float64 kernels: K2 at the dataset's 1000 rows (config #5), K1 and
    # K2 at 10 qubits (kyriienko, 1 layer), each beside its first layout
    k2_64 = time_f64("K2_f64", fid_circuit, rand_angles(fid_circuit, FID_SAMPLES, torch.float64),
                     20)
    c64 = build_circuit("kyriienko", F64_TIMING_QUBITS, 1, FID_LAYERS)
    f64 = []
    for B in F64_TIMING_ROWS:
        a64 = rand_angles(c64, B, torch.float64)
        f64 += [time_f64(name, c64, a64, 3 if B > FID_SAMPLES else 10)
                for name in ("K1_f64", "K2_f64")]
        del a64
    for t in f64[-2:]:  # at the step's row count the redesign must win outright
        check(t["ms"] < min(t["plain_ms"], t["first_layout_ms"]),
              f"{t['name']} at B={t['B']} is not faster than its plain version and its first "
              f"layout: {f64_text(t)}")
    k2_b, k2_by = k2_bound(fid_circuit, FID_STEP_ROWS)
    k4_b, k4_by = k4_bound(fid_circuit, FID_STEP_ROWS)
    print(f"phase 9 states times ({time.time() - t0:.2f} s) [{smi}]: at B={FID_STEP_ROWS} "
          f"G={fid_circuit.num_gates} n={FID_QUBITS}: K2 {k2_ms:.4f} ms vs plain "
          f"{k2_plain_ms:.4f} ms ({k2_plain_ms / k2_ms:.1f}x), bound {k2_b:.5f} ms ({k2_by}), "
          f"K2 at {k2_b / k2_ms:.1%} of it; K4 from angles {k4_ms:.4f} ms vs plain fused "
          f"{k4_plain_ms:.4f} ms ({k4_plain_ms / k4_ms:.1f}x), bound {k4_b:.5f} ms ({k4_by}), "
          f"K4 at {k4_b / k4_ms:.1%} of it; the kernels alone on the device (profiler) K2 "
          f"{k2_dev_ms:.4f} ms, K4 {k4_dev_ms:.4f} ms; K2 vs K4 at B={FID_STEP_ROWS}, "
          f"kyriienko 1 layer (a call by CUDA events, then the kernel alone on the device, "
          f"there also K3 on the same program: K3's bit map and a reduction in the store's "
          f"place): "
          + ", ".join(f"{n} qubits {t2:.4f} ms ({b2 / t2:.1%} of {b2:.5f}) vs {t4:.4f} ms "
                      f"({b4 / t4:.1%} of {b4:.5f}), K4/K2 {t4 / t2:.2f}, device {d2:.4f} / "
                      f"{d4:.4f} / K3 {d3:.4f} ms"
                      for n, (t2, b2, t4, b4, d2, d4, d3) in crossover.items())
          + f"; the float64 kernels, first layout -> register layout vs plain complex128 "
          f"(bounds against {FP64_OPS_PER_S / 1e12:.0f} TFLOP/s FP64): "
          + "; ".join(f64_text(t) for t in [k2_64] + f64), flush=True)
    cross = {str(n): dict(zip(("k2_ms", "k2_bound_ms", "k4_ms", "k4_bound_ms",
                               "k2_device_ms", "k4_device_ms", "k3_device_ms"), t))
             for n, t in crossover.items()}
    return {"K2": {"ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_b, "bound_by": k2_by,
                   "device_ms": k2_dev_ms, "k2_vs_k4_by_qubits": cross},
            "K2_f64": {**k2_64, "at_10_qubits": f64},
            "K4": {"ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_b, "bound_by": k4_by,
                   "device_ms": k4_dev_ms}}


def config7_phases(dev, smi: str, rand_angles):
    """Phases 10-12, 15c and 16: K3 against its plain version, the config #7
    path (fixture problem, then full size) and its times, then config #7
    with grad_method="autodiff" and with its condition numbers. Returns
    (K3's entry of the kernels record, the autodiff record, the condition
    numbers' record, 11b's problem, z and CG posterior for phase 18)."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.data import generate_data_numpy
    from dqgp_tpu_torch.driver import init_admm_state, train
    from dqgp_tpu_torch.models.gp.cv import cv_fold_scores_impl, kfold_pad_indices
    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.models.gp.posterior import masked_nll_and_grad, predict_quantum_gp
    from dqgp_tpu_torch.models.kernels.quantum_kernel import (
        gram_and_shift_grads, kernel_features)
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops.fusion import fuse_circuit
    from dqgp_tpu_torch.parallel import blocked as BL
    from dqgp_tpu_torch.parallel.consensus import (
        make_admm_step, make_agent_batch, streamed_nll_and_grad)

    spec = config7_spec()
    circuit = spec.circuit
    P = spec.num_parameters
    program = fuse_circuit(circuit)
    check((circuit.num_gates, P, len(program.ops), program.n_rows) == (70, 70, 32, 260),
          "config #7's circuit is not G=70, P=70, 32 fused ops, R=260")

    worst, worst_unfused = check_k3(rand_angles)
    n_train_full = C7_SAMPLES - int(np.ceil(C7_TEST_SPLIT * C7_SAMPLES))

    # 11a. the fixture problem: config #7's width, cut depth ------------------
    with open(CONFIG7_FIXTURE) as f:
        ref = json.load(f)
    t0 = time.time()
    X, Y = generate_data_numpy(C7_FIX_SAMPLES, 2, 0.1, C7_SEED)
    check(array_digest(X) == ref["problem"]["x_sha256"]
          and array_digest(Y) == ref["problem"]["y_sha256"], "fixture dataset differs")
    X_tr, Y_tr, X_te, Y_te, splits = config7_problem(C7_FIX_SAMPLES, C7_FIX_AGENTS)
    check([len(x) for x, _ in splits] == ref["problem"]["shard_sizes"], "shard sizes differ")
    cfg = config7_train_config(C7_FIX_ITERS, verbose=False)
    K.reset_launch_counts()
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    predict = BL.make_cg_predictor(spec, X_tr, Y_tr, torch.as_tensor(res.z, device=dev),
                                   cfg.noise_std, device=dev)
    mean, var = predict(X_te)
    metrics = evaluate_predictions(Y_te, mean, var)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    want_k3 = C7_FIX_ITERS * (P + 2) + rescores + 2
    check(counts["K3"] == want_k3 and sum(counts.values()) == counts["K3"],
          f"fixture launches {counts}: want K3 = {C7_FIX_ITERS}*({P}+2) + {rescores} + 2 "
          f"and no other kernel")
    check(mean.shape == (len(X_te),) and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(var).all()), "non-finite fixture prediction")
    # the agent NLLs at JAX's own z (not the main path's launches: the counts
    # were read above); the run's own, at its own z, are printed beside them
    nll_at_ref = config7_agent_nll_at(spec, splits, ref["z_trajectory"][:C7_FIX_ITERS], dev,
                                      cfg.noise_std)
    own = np.array([h["agent_losses"] for h in res.nll_history])
    own_dev = (np.abs(own - ref["agent_nll"]) / np.abs(ref["agent_nll"])).max(axis=1)
    z_dev, nll_dev, cv_ratio, t_ratio = check_config7_fixture(res, metrics, ref, C7_FIX_ITERS,
                                                              nll_at_ref)
    print(f"phase 11a config #7 fixture problem ({time.time() - t0:.2f} s): "
          f"{len(X_tr)} train rows over {C7_FIX_AGENTS} agents, {C7_FIX_ITERS} streamed ADMM "
          f"iterations + CG predict of {len(X_te)} rows; launches {counts} (K3 = "
          f"{C7_FIX_ITERS}*({P}+2) + {rescores} + 2); z dev {z_dev:.1e} (tol {Z_TOL}), worst "
          f"agent NLL rel dev at JAX's z {nll_dev:.2e} (bars per iteration "
          f"{[f'{b:.2e}' for b in config7_nll_bars(ref)]}; at the run's own z "
          f"{[f'{d:.2e}' for d in own_dev]}), worst CV-NLPD dev / bar "
          f"{cv_ratio:.3f}, test NLPD {metrics['nlpd']:.4f} vs JAX {ref['test_metrics']['nlpd']:.4f} "
          f"(dev / bar {t_ratio:.3f}); CG alpha {predict.alpha_result.iterations} iterations "
          f"(JAX f64 {ref['cg']['alpha_iterations']})", flush=True)

    # 11b. config #7 at full size ---------------------------------------------
    t0 = time.time()
    X_tr, Y_tr, X_te, Y_te, splits = config7_problem(C7_SAMPLES, C7_AGENTS)
    sizes = [len(x) for x, _ in splits]
    check(len(X_tr) == n_train_full == 49999 and sizes[:4] == [795, 787, 750, 764]
          and (min(sizes), max(sizes)) == (717, C7_NMAX),
          f"config #7 partition differs from the log's: {len(X_tr)} rows, {sizes[:4]}...")
    cfg = config7_train_config(C7_ITERS, verbose=False)
    K.reset_launch_counts()
    t1 = time.time()
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    torch.cuda.synchronize()
    train_s = time.time() - t1
    train_counts = K.launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    predict = BL.make_cg_predictor(spec, X_tr, Y_tr, torch.as_tensor(res.z, device=dev),
                                   cfg.noise_std, device=dev)
    ev[1].record()
    mean, var = predict(X_te[:C7_TEST_ROWS])
    ev[2].record()
    metrics = evaluate_predictions(Y_te[:C7_TEST_ROWS], mean, var)
    torch.cuda.synchronize()
    setup_ms, predict_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    counts = K.launch_counts()
    # 11b's problem, z and CG posterior, for phase 18
    c7 = {"X_tr": X_tr, "Y_tr": Y_tr, "X_te": X_te, "Y_te": Y_te, "splits": splits,
          "z": torch.as_tensor(res.z, device=dev), "mean": mean, "var": var,
          "setup_ms": setup_ms, "predict_ms": predict_ms,
          "alpha_iterations": predict.alpha_result.iterations}
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    # per step: the Gram at wrap(z) + one +-h launch per parameter; per CV
    # pass: one; per predictor: the training rows, then the eval rows
    want_train = C7_ITERS * (1 + P) + C7_ITERS + rescores
    check(train_counts["K3"] == want_train and counts["K3"] == want_train + 2
          and sum(counts.values()) == counts["K3"],
          f"config #7 launches {train_counts} / {counts}: want K3 = {C7_ITERS}*(1+{P}) + "
          f"{C7_ITERS} + {rescores} in training, + 2 with the predictor, and no K1")
    check(not any(K.wide_launch_counts().values()),
          f"config #7 at 10 qubits took a wide instantiation: {K.wide_launch_counts()}")
    nll1 = res.nll_history[0]["total_nll"]
    cv1 = res.cv_history[0]["consensus_cv_score"]
    nll_rel = abs(nll1 - C7_NLL_ITER1) / C7_NLL_ITER1
    z = np.asarray(res.z)
    check(np.all(np.isfinite(z)) and all(np.all(np.isfinite(h["agent_losses"]))
                                         for h in res.nll_history),
          "non-finite z or agent NLL")
    check(mean.shape == (C7_TEST_ROWS,) and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(var).all()), "non-finite config #7 prediction")
    print(f"phase 11b config #7 at full size ({time.time() - t0:.2f} s): {len(X_tr)} train "
          f"rows over {C7_AGENTS} agents (Nmax {max(sizes)}), {C7_ITERS} streamed ADMM "
          f"iterations in {train_s:.2f} s, CG predictor set-up {setup_ms / 1e3:.2f} s + "
          f"predict of {C7_TEST_ROWS} rows {predict_ms / 1e3:.2f} s; launches {counts} (K3 = {C7_ITERS}*(1+{P}) + {C7_ITERS} + "
          f"{rescores} + 2); iteration 1 nll_sum {nll1:.4f} vs JAX {C7_NLL_ITER1} (rel dev "
          f"{nll_rel:.2e}, tol 1e-3), CV-NLPD {cv1:.4f} vs JAX {C7_CV_ITER1}; nll_sum "
          f"{[round(h['total_nll'], 4) for h in res.nll_history]}; CG alpha "
          f"{predict.alpha_result.iterations} iterations (residual "
          f"{predict.alpha_result.residual_norm:.2e}), variance "
          f"{[(r.iterations, f'{r.residual_norm:.2e}') for r in predict.variance_results]}; "
          f"test NLPD {metrics['nlpd']:.4f}, R2 {metrics['r2']:.4f}", flush=True)
    check(nll_rel <= 1e-3, f"iteration 1 nll_sum {nll1} vs {C7_NLL_ITER1}: rel {nll_rel}")

    # streamed = central on 2 agents at iteration 1's z (not the main path's
    # launches: the counts were read above)
    theta0, psi0, _ = init_admm_state(C7_AGENTS, P, cfg.seed, cfg.rho)
    xi = torch.as_tensor(theta0 + psi0 / cfg.rho)
    phase = 2.0 * np.pi * xi / M.PERIOD
    z1 = M.round4(M.circular_mean_from_sums(torch.cos(phase).sum(0), torch.sin(phase).sum(0)))
    check(np.allclose(z1.numpy(), res.cv_history[0]["consensus_params"], rtol=0, atol=1e-12),
          "iteration 1's z differs from the run's")
    z32 = M.wrap(z1).to(torch.float32).to(dev)
    b2 = make_agent_batch(splits[:2], dev)
    streamed = streamed_nll_and_grad(spec, b2, z32, cfg.shift_value, cfg.noise_std,
                                     compute_cond=False)
    Kc, dKc = gram_and_shift_grads(spec, b2.X, z32, cfg.shift_value)
    central = masked_nll_and_grad(Kc.double(), dKc, b2.Y, b2.mask, cfg.noise_std,
                                  compute_cond=False)
    del Kc, dKc
    g_scale = float(central.grad.abs().max())
    g_dev = float((streamed.grad - central.grad).abs().max()) / g_scale
    print(f"phase 11b streamed vs central gradient on 2 agents at iteration 1's z: max "
          f"|diff| / max |g| = {g_dev:.2e} (tol 1e-6), NLL rel dev "
          f"{float(((streamed.nll - central.nll) / central.nll).abs().max()):.2e}", flush=True)
    check(g_dev <= 1e-6, f"streamed gradient deviates {g_dev} from the central one")

    # the CG posterior against the dense float64 one on the first 4,096 rows
    z_t = torch.as_tensor(res.z, device=dev)
    Xd, Yd, Xq = X_tr[:C7_DENSE_ROWS], Y_tr[:C7_DENSE_ROWS], X_te[:C7_TEST_ROWS]
    m_cg, v_cg = BL.make_cg_predictor(spec, Xd, Yd, z_t, cfg.noise_std, device=dev)(Xq)
    m_d, v_d = predict_quantum_gp(spec, torch.as_tensor(Xd, device=dev),
                                  torch.as_tensor(Yd, device=dev),
                                  torch.as_tensor(Xq, device=dev), z_t,
                                  noise_std=cfg.noise_std)
    m_ratio = _allclose(m_cg.cpu(), m_d.cpu(), 1e-3, 1e-5)
    v_ratio = _allclose(v_cg.cpu(), v_d.cpu(), 1e-2, 1e-5)
    print(f"phase 11b CG vs dense float64 posterior on {C7_DENSE_ROWS} training rows, "
          f"{C7_TEST_ROWS} test rows: worst mean dev / bar {m_ratio:.3f} (rtol 1e-3, atol "
          f"1e-5), worst variance dev / bar {v_ratio:.3f} (rtol 1e-2, atol 1e-5)", flush=True)
    check(m_ratio <= 1.0 and v_ratio <= 1.0, "CG posterior disagrees with the dense one")

    # 12. times ----------------------------------------------------------------
    t0 = time.time()
    step = make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                          compute_cond=False, grad_method="streamed")
    batch = make_agent_batch(splits, dev)
    theta, psi = torch.as_tensor(res.theta, device=dev), torch.as_tensor(res.psi, device=dev)
    sel = np.random.RandomState(cfg.seed).choice(len(X_tr), C7_CV_MAX, replace=False)
    Xc, Yc = torch.as_tensor(X_tr[sel], device=dev), torch.as_tensor(Y_tr[sel], device=dev)
    folds = kfold_pad_indices(C7_CV_MAX, cfg.cv_folds, cfg.seed, dev)
    out = step(theta, psi, batch)
    step_ms = _cuda_time_ms(lambda: step(theta, psi, batch), 2)
    cv_ms = _cuda_time_ms(lambda: cv_fold_scores_impl(spec, Xc, Yc, out.z, *folds,
                                                      noise_std=cfg.noise_std), 5)

    k3 = time_k3(rand_angles, smi)

    # the predictor's parts, in its float64 (its set-up and predict were
    # timed in 11b; the alpha solve is the set-up's rest)
    X32 = torch.as_tensor(X_tr, device=dev).to(torch.float32)
    feats_ms = _cuda_time_ms(lambda: kernel_features(spec, X32, z_t), 3)
    F = kernel_features(spec, X32, z_t).to(torch.float64)
    chol_ms = _cuda_time_ms(lambda: BL.pivoted_cholesky(spec, F, 64), 2)
    ones = torch.ones(len(X_tr), dtype=torch.float64, device=dev)
    v1 = torch.randn((len(X_tr), 1), dtype=torch.float64, device=dev)
    v512 = torch.randn((len(X_tr), C7_TEST_ROWS), dtype=torch.float64, device=dev)
    mv_ms, mv512_ms = _alternate_ms([lambda: BL.gram_matvec(spec, F, v1, ones, 4096),
                                     lambda: BL.gram_matvec(spec, F, v512, ones, 4096)], 2)
    print(f"phase 12 times ({time.time() - t0:.2f} s) [{smi}]: config #7 ADMM iteration "
          f"= step {step_ms:.1f} ms + CV {cv_ms:.2f} ms ({C7_AGENTS} agents, Nmax {C7_NMAX}, "
          f"CV on {C7_CV_MAX} rows); CG predictor set-up on "
          f"{len(X_tr)} rows {setup_ms:.1f} ms = features {feats_ms:.3f} ms + rank-64 pivoted "
          f"Cholesky {chol_ms:.2f} ms + alpha solve ({predict.alpha_result.iterations} "
          f"iterations) the rest; predict {C7_TEST_ROWS} rows {predict_ms:.1f} ms; float64 "
          f"gram_matvec at N={len(X_tr)}: 1 right-hand side {mv_ms:.2f} ms "
          f"({len(X_tr) ** 2 / (mv_ms * 1e-3):.3e} entries/s), {C7_TEST_ROWS} {mv512_ms:.2f} ms",
          flush=True)
    ad = config7_autodiff_phase(dev, smi, (X_tr, Y_tr, splits), step_ms)
    cond = config7_cond_phase(dev, smi, (X_tr, Y_tr, splits), rand_angles)
    return ({"launches": counts["K3"], "max_abs_err": worst, **k3, "library_ms": None,
             "max_abs_err_vs_unfused": worst_unfused, "step_ms": step_ms}, ad, cond, c7)


def config7_cond_phase(dev, smi: str, full, rand_angles) -> dict:
    """Phase 16: config #7 as phases 11b-12 run it (``full``: 11b's 49,999
    rows over 64 agents), with the CLI's defaults for the condition numbers:
    compute_cond=True and cond_mode "auto" (dqgp_tpu/cli.py:115, :396), which
    is "host" on the card. Its backfill after training makes one K1 float64
    launch an agent and 16-row chunk (64 for its 2 iterations) and no other
    launch; it is held on C7_COND_HELD agents against the same backfill
    through the plain complex128 engine. Then the backfill at the shapes of
    the JAX log's 25 iterations (results_round5/cli_config7_50k.log): the
    run's 2 z rows and 23 torus points from a seeded generator, one 16-row
    and one 9-row chunk an agent (128 launches), timed by CUDA events, with
    its peak allocated memory; on the same chunks again, K1 float64's
    device time (the profiler) and the float64 eigvalsh's (CUDA events);
    the same backfill with K1 float64's first layout in the kernel's place;
    and K1 float64 at the 16-row chunk's shape beside its first layout and
    its plain version. Returns K1_f64's numbers for the kernels record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.driver import host_condition_numbers, resolve_cond_mode, train
    from dqgp_tpu_torch.models.kernels import quantum_kernel as QK
    from dqgp_tpu_torch.models.kernels.quantum_kernel import features_from_angles, grams_at_rows
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops.statevector import angle_matrix

    X_tr, Y_tr, splits = full
    spec = config7_spec()
    P, n_max = spec.num_parameters, max(len(x) for x, _ in splits)
    cfg = config7_train_config(C7_ITERS, compute_cond=True, cond_mode="auto", verbose=False)
    check(resolve_cond_mode(cfg, dev) == "host", "cond_mode auto does not resolve to host")
    t0 = time.time()
    K.reset_launch_counts()
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    train_s = time.time() - t0
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    want_k3 = C7_ITERS * (1 + P) + C7_ITERS + rescores
    want_f64 = backfill_launches(C7_ITERS, C7_AGENTS)
    eig = backfill_eig_counts(C7_ITERS, [len(x) for x, _ in splits])
    check(counts["K1_f64"] == want_f64 and counts["K3"] == want_k3 and counts_hold(counts, eig)
          and sum(counts.values()) == want_f64 + want_k3 + sum(eig.values()),
          f"config #7 with cond launches {counts}: want K3 = {want_k3} in training and "
          f"K1_f64 = {want_f64} and {eig} in the backfill, no other kernel")
    host = np.array([h["condition_numbers"] for h in res.nll_history])
    check(host.shape == (C7_ITERS, C7_AGENTS) and not bool(np.isnan(host).any()),
          f"the backfill left a condition number out: {host.shape}")
    nll_rel = abs(res.nll_history[0]["total_nll"] - C7_NLL_ITER1) / C7_NLL_ITER1
    check(nll_rel <= 1e-3, f"iteration 1 nll_sum deviates {nll_rel} from the JAX log's")
    rows = np.array([h["consensus_params"] for h in res.cv_history])
    # the same backfill through the plain engine on the first agents
    saved = QK.pauli_features_from_angles
    QK.pauli_features_from_angles = K.pauli_features_reference
    try:
        plain = host_condition_numbers(spec, splits[:C7_COND_HELD], rows, device=dev)
    finally:
        QK.pauli_features_from_angles = saved
    plain_eig = backfill_eig_counts(len(rows), [len(x) for x, _ in splits[:C7_COND_HELD]])
    check(K.launch_counts() == {k: v + plain_eig.get(k, 0) for k, v in counts.items()},
          f"the plain backfill launched {K.launch_counts()}: want {counts} and {plain_eig} more")
    rel = hold_host_cond(host[:, :C7_COND_HELD], plain,
                         f"config #7's backfill vs the plain engine on {C7_COND_HELD} agents")
    print(f"phase 16 config #7 with condition numbers ({time.time() - t0:.2f} s) [{smi}]: "
          f"{len(X_tr)} train rows over {C7_AGENTS} agents, {C7_ITERS} streamed iterations with "
          f"compute_cond=True, cond_mode auto = host, in {train_s:.2f} s; launches {counts} "
          f"(K3 = {want_k3}, K1_f64 = {want_f64}: one an agent and 16-row chunk); iteration 1 "
          f"nll_sum rel dev {nll_rel:.2e} from the JAX log's; condition numbers of the first "
          f"{C7_COND_HELD} agents vs the plain complex128 engine's: worst rel dev below 1e12 "
          f"{rel:.2e} (bar {COND_RTOL} below {COND_EXACT_BELOW:.0e}, buckets above); "
          f"iteration 1: " + ", ".join(f"{v:.4e}" for v in host[0, :8]) + ", ...; the plain "
          f"engine's: " + ", ".join(f"{v:.4e}" for v in plain[0]), flush=True)

    # the backfill at the shapes of 25 iterations
    gen = torch.Generator().manual_seed(C7_SEED)
    Z = np.concatenate([rows, (torch.rand((C7_COND_ITERS - len(rows), P), generator=gen,
                                          dtype=torch.float64) * np.pi).numpy()])
    t0 = time.time()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    cond25 = host_condition_numbers(spec, splits, Z, device=dev)
    ev[1].record()
    torch.cuda.synchronize()
    total_ms = ev[0].elapsed_time(ev[1])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    counts25 = K.launch_counts()
    want25 = {"K1_f64": backfill_launches(C7_COND_ITERS, C7_AGENTS),
              **backfill_eig_counts(C7_COND_ITERS, [len(x) for x, _ in splits])}
    check(counts25 == {**dict.fromkeys(counts25, 0), **want25},
          f"the 25-row backfill launched {counts25}: want {want25} and nothing else")
    check(not bool(np.isnan(cond25).any()), "the 25-row backfill left a value out")
    # where its time goes, on the same chunks and agents again: the float64
    # features alone under the profiler (K1 f64's device time), then each
    # Gram stack's eigvalsh alone by CUDA events (it waits for the host, and
    # its hundreds of kernels a Gram would swamp the profiler)
    Zw = M.wrap(torch.as_tensor(Z, device=dev))
    Xs = [torch.as_tensor(X_i, device=dev) for X_i, _ in splits]
    chunks = [Zw[s0:s0 + 16] for s0 in range(0, len(Z), 16)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for rows_c in chunks:
            for X_i in Xs:
                a = angle_matrix(spec.circuit, X_i[None], rows_c, torch.float64)
                features_from_angles(spec, a.reshape(-1, a.shape[-1]))
        torch.cuda.synchronize()
    k1_dev = sum(e.self_device_time_total for e in prof.key_averages()
                 if WARP_KERNELS["K1_f64"] in e.key) / 1e3
    eigh_ms, eigh_n = 0.0, 0
    for rows_c in chunks:
        for X_i in Xs:
            gram = grams_at_rows(spec, X_i, rows_c)
            ev[0].record()
            torch.linalg.eigvalsh(gram)
            ev[1].record()
            torch.cuda.synchronize()
            eigh_ms += ev[0].elapsed_time(ev[1])
            eigh_n += gram.shape[0]
            del gram
    # the same backfill with K1 f64's first layout in the kernel's place, as
    # the package ran it before the register layout
    QK.pauli_features_from_angles = pauli_features_f64_first_layout
    try:
        ev[0].record()
        cond_first = host_condition_numbers(spec, splits, Z, device=dev)
        ev[1].record()
        torch.cuda.synchronize()
    finally:
        QK.pauli_features_from_angles = saved
    first_ms = ev[0].elapsed_time(ev[1])
    # timed, not held: where a Gram is singular to float64 its smallest
    # |eigenvalue| is rounding noise, which two float64 feature engines move
    # by orders of magnitude, across the 1e15 bucket edge too; what is held
    # to the plain engine is the C7_COND_HELD agents above, at the run's z
    check(not bool(np.isnan(cond_first).any()), "the first layout's backfill left a value out")
    t16 = time_f64("K1_f64", spec.circuit, rand_angles(spec.circuit, 16 * n_max, torch.float64),
                   3)
    print(f"phase 16 backfill at 25 iterations' shapes ({time.time() - t0:.2f} s) [{smi}]: "
          f"{C7_COND_ITERS} z rows (the run's {len(rows)} + {C7_COND_ITERS - len(rows)} seeded "
          f"torus points), {C7_AGENTS} agents of {min(len(x) for x, _ in splits)}-{n_max} rows, "
          f"one 16-row and one 9-row chunk an agent: {counts25['K1_f64']} K1_f64 launches, "
          f"{total_ms:.1f} ms (CUDA events); on the same chunks again, K1 f64 alone {k1_dev:.1f} "
          f"ms on the device ({k1_dev / total_ms:.1%} of the backfill) and the float64 eigvalsh "
          f"of the {eigh_n} Grams (stacks of 16 or 9, n_i x n_i) {eigh_ms:.1f} ms "
          f"({eigh_ms / eigh_n:.2f} ms a Gram, {eigh_ms / total_ms:.1%}); peak allocated "
          f"{peak:.2f} GiB; the same backfill through K1 f64's first layout {first_ms:.1f} ms; "
          + f64_text(t16), flush=True)
    return {"launches": counts["K1_f64"], "train_s": train_s, "backfill_25_ms": total_ms,
            "backfill_25_launches": counts25["K1_f64"], "backfill_25_k1_f64_device_ms": k1_dev,
            "backfill_25_eigvalsh_ms": eigh_ms, "backfill_25_peak_gib": peak,
            "backfill_25_first_layout_ms": first_ms,
            "cond_rel_dev_vs_plain": rel, **t16}


def runs_identical(a, b, what: str):
    """Hold run ``b`` to run ``a``: the same stop, z, theta and psi (and the
    z trajectory) identical, agent NLLs and CV scores within rtol 1e-12.
    Returns (worst NLL rel dev, worst CV rel dev)."""
    check((b.iterations, b.converged_by) == (a.iterations, a.converged_by),
          f"{what}: stopped {b.converged_by}@{b.iterations} vs {a.converged_by}@{a.iterations}")
    for f in ("z", "theta", "psi"):
        check(np.array_equal(getattr(b, f), getattr(a, f)), f"{what}: {f} differs")
    za = np.array([h["consensus_params"] for h in a.cv_history])
    zb = np.array([h["consensus_params"] for h in b.cv_history])
    check(np.array_equal(za, zb), f"{what}: the z trajectories differ")
    na = np.array([h["agent_losses"] for h in a.nll_history])
    nb = np.array([h["agent_losses"] for h in b.nll_history])
    ca = np.array([h["consensus_cv_score"] for h in a.cv_history])
    cb = np.array([h["consensus_cv_score"] for h in b.cv_history])
    nll_dev = float((np.abs(nb - na) / np.abs(na)).max())
    cv_dev = float((np.abs(cb - ca) / np.abs(ca)).max())
    check(nll_dev <= 1e-12 and cv_dev <= 1e-12,
          f"{what}: agent NLLs / CV scores deviate {nll_dev:.2e} / {cv_dev:.2e} > 1e-12")
    return nll_dev, cv_dev


def cond_bucket(c: float) -> str:
    """The reference's buckets (main.py:2557-2643)."""
    return "Good" if c < 1e12 else ("Moderate" if c < 1e15 else "Poor")


def hold_host_cond(got, want, what: str) -> float:
    """The port's float64 backfill against the JAX package's: rtol
    COND_RTOL where cond < COND_EXACT_BELOW, the same bucket above; returns
    the worst relative deviation of the values below 1e12."""
    got, want = np.asarray(got), np.asarray(want)
    # a Gram singular to float64 (config #5's fidelity Grams: ~43 nonzero
    # eigenvalues of 225) may read inf, as max|w| / tiny overflows: "Poor"
    check(got.shape == want.shape and not bool(np.isnan(got).any()),
          f"{what}: host condition numbers {got.shape}, NaN or misshapen")
    with np.errstate(invalid="ignore"):  # inf - inf where both read inf
        rel = np.abs(got - want) / want
    exact = np.where(want < COND_EXACT_BELOW, rel, 0.0)
    check(bool(np.all(exact <= COND_RTOL)),
          f"{what}: host condition numbers deviate {exact.max():.2e} > {COND_RTOL}")
    check(all(cond_bucket(g) == cond_bucket(w) for g, w in zip(got.ravel(), want.ravel())),
          f"{what}: host condition numbers {got.tolist()} not in JAX's buckets {want.tolist()}")
    finite = want < 1e12
    return float(rel[finite].max()) if finite.any() else float("nan")


def northstar_splits():
    from dqgp_tpu_torch.data import split_data_numpy

    X, Y, X_test, Y_test = make_problem()
    return X, Y, X_test, Y_test, split_data_numpy(X, Y, N_AGENTS, "regional")


def cond_phase(dev, smi: str, rand_angles, fid) -> dict:
    """Phase 13: cond_mode device / host / off on the north star and config
    #5 (``fid``: phase 7's spec, splits and training rows), the backfill at
    the JAX fixture's z rows, and the float64 kernels at the backfill's
    shapes. Returns the float64 kernels' backfill times for the record."""
    import torch

    from dqgp_tpu_torch.driver import TrainConfig, host_condition_numbers, train
    from dqgp_tpu_torch.ops import cuda_circuit as K

    with open(DRIVER_MODES_FIXTURE) as f:
        ref = json.load(f)["host_cond"]
    X, Y, X_test, Y_test, splits = northstar_splits()
    check(problem_digest(X, Y, X_test, Y_test) == ref["northstar"]["problem_sha256"],
          "north-star data differ from the driver-modes fixture's")
    fspec, fsplits, fX, fX_tr, fY_tr = fid
    check(array_digest(fX) == ref["fidelity"]["x_sha256"], "config #5 X differs from the fixture's")
    cells = (("north star", "northstar", northstar_spec(), splits, X, Y, COND_ITERS, 42, "K1"),
             ("config #5", "fidelity", fspec, fsplits, fX_tr, fY_tr, COND_FID_ITERS, FID_SEED,
              "K2"))
    for what, key, spec, spl, Xtr, Ytr, iters, seed, kernel in cells:
        t0 = time.time()
        runs, counts = {}, {}
        for mode in ("device", "host", "off"):
            kw = dict(compute_cond=False) if mode == "off" else dict(cond_mode=mode)
            K.reset_launch_counts()
            runs[mode] = train(spec, spl, Xtr, Ytr,
                               TrainConfig(max_iter=iters, seed=seed, verbose=False, **kw),
                               device=dev)
            torch.cuda.synchronize()
            counts[mode] = K.launch_counts()
        for mode in ("host", "off"):
            runs_identical(runs["device"], runs[mode], f"{what} cond {mode} vs device")
        f64 = backfill_launches(iters, len(spl))
        eig = backfill_eig_counts(iters, [len(x) for x, _ in spl])
        check(counts["host"][kernel + "_f64"] == f64
              and counts["device"][kernel + "_f64"] == counts["off"][kernel + "_f64"] == 0,
              f"{what}: float64 launches {counts}: want {f64} in the host backfill only")
        # the eigenvalue kernel's counts, read from train()'s own backfill
        check(counts_hold(counts["host"], eig)
              and counts_hold(counts["device"], dict.fromkeys(eig, 0))
              and counts_hold(counts["off"], dict.fromkeys(eig, 0)),
              f"{what}: eigenvalue counts {counts}: want {eig} in the host backfill only")
        host = np.array([h["condition_numbers"] for h in runs["host"].nll_history])
        floors = np.array([h["condition_numbers"] for h in runs["device"].nll_history])
        check(not bool(np.isnan(host).any()) and bool(np.all(np.isnan(
            [h["condition_numbers"] for h in runs["off"].nll_history]))),
            f"{what}: a host value missing, or off not all NaN")
        rows = np.array(ref[key]["z_rows"])
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = host_condition_numbers(spec, spl, rows, device=dev)
        ev[1].record()
        torch.cuda.synchronize()
        rel = hold_host_cond(got, ref[key]["cond"], what)
        print(f"phase 13 cond {what} ({time.time() - t0:.2f} s) [{smi}]: {iters} iterations "
              f"each with cond_mode device, host and off: one z trajectory, agent NLLs and CV "
              f"identical; host backfill {f64} {kernel}_f64 launches and, read from the run, "
              f"{ {k: counts['host'][k] for k in eig} }; at the JAX "
              f"fixture's {len(rows)} z rows the backfill took {ev[0].elapsed_time(ev[1]):.2f} ms "
              f"and agrees with JAX's host_condition_numbers (worst rel dev below 1e12: "
              f"{rel:.2e}, bar {COND_RTOL} below {COND_EXACT_BELOW:.0e}, buckets above); the run's "
              f"iteration 1, host (exact float64) vs device (float32-built Gram, floors): "
              + ", ".join(f"{h:.4e} vs {d:.4e}" for h, d in zip(host[0], floors[0]))
              + f"; JAX at its own iteration 1: "
              + ", ".join(f"{w:.4e}" for w in ref[key]["cond"][0]), flush=True)

    # the float64 kernels at the backfill's shapes: a 16-row chunk of the
    # north star's largest shard, all 25 gate rows at once (6,500 samples),
    # and config #5's 5 rows of a 225-row shard
    t0 = time.time()
    ns_circuit = northstar_spec().circuit
    n_max = max(len(x) for x, _ in splits)
    times = {}
    for name, circuit, B in (("K1_f64", ns_circuit, 16 * n_max),
                             ("K1_f64", ns_circuit, GATE_ITERS * n_max),
                             ("K2_f64", fspec.circuit,
                              FID_ITERS * max(len(x) for x, _ in fsplits))):
        times.setdefault(name, []).append(
            time_f64(name, circuit, rand_angles(circuit, B, torch.float64), 10))
    print(f"phase 13 float64 kernels at the backfill's shapes ({time.time() - t0:.2f} s) "
          f"[{smi}]: " + "; ".join(f64_text(t) for ts in times.values() for t in ts),
          flush=True)
    return times


# the float32 kernels' names as the profiler reports them (each a substring
# of its instantiations' demangled names, and of no other kernel's)
PROFILED_NAMES = {"K1": "warp_pauli_features_kernel", "K2": "warp_states_kernel",
                  "K1_vjp": "warp_vjp_kernel"}


def _profiled(fn, names=()):
    """(result, kernels the profiler saw, their device ms, host wall ms,
    {name: launches of the kernels whose name holds PROFILED_NAMES[name]},
    {name: their device ms}) of one call of ``fn``. The counts are the
    device's own record: kernels replayed from a CUDA graph count each time
    they run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n, us = 0, 0.0
    counts, named_us = dict.fromkeys(names, 0), dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += e.count
            us += e.self_device_time_total
            for name in names:
                if PROFILED_NAMES[name] in e.key:
                    counts[name] += e.count
                    named_us[name] += e.self_device_time_total
    return out, n, us / 1e3, wall, counts, {k: v / 1e3 for k, v in named_us.items()}


def chained_phase(dev, smi: str, fid) -> dict:
    """Phase 14: chain_iters on the card (a CUDA-graph replay a chunk)
    against the per-iteration loop. Returns the chained launches and the
    chunk statistics for the record."""
    import torch

    from dqgp_tpu_torch.driver import TrainConfig, host_condition_numbers, train
    from dqgp_tpu_torch.ops import cuda_circuit as K

    X, Y, _, _, splits = northstar_splits()
    spec = northstar_spec()
    fspec, fsplits, _, fX_tr, fY_tr = fid
    out = {}

    def timed(fn):
        """(result, ms by CUDA events) of one call."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        res = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return res, ev[0].elapsed_time(ev[1])

    for what, sp, spl, Xtr, Ytr, iters, k, seed, kernel in (
            ("north star", spec, splits, X, Y, GATE_ITERS, CHAIN_K, 42, "K1"),
            ("config #5", fspec, fsplits, fX_tr, fY_tr, CHAIN_FID_ITERS, CHAIN_K, FID_SEED, "K2"),
            ("north star, a stop inside a chunk", spec, splits, X, Y, CHAIN_STOP_ITERS,
             CHAIN_STOP_K, 42, "K1")):
        t0 = time.time()
        runs, ms, counts = {}, {}, {}
        for chain in (1, k):
            cfg = TrainConfig(max_iter=iters, seed=seed, chain_iters=chain, verbose=False)
            K.reset_launch_counts()
            runs[chain], ms[chain] = timed(lambda: train(sp, spl, Xtr, Ytr, cfg, device=dev))
            counts[chain] = K.launch_counts()
            ms[chain] /= iters
        a, b = runs[1], runs[k]
        nll_dev, cv_dev = runs_identical(a, b, f"{what}: chain_iters={k} vs 1")
        st = b.chain_stats
        per, replays = st["launches_per_replay"], st["replays"]
        rescores = sum(h["solver"] == "float64-rescue" for h in b.cv_history)
        rescues = sum(h["solver"].endswith("-rescue") for h in b.nll_history)
        # a rescued row restarts chunking: one more replay each
        check(st["captured"] and per == {kernel: 2 * k}
              and (replays == -(-iters // k) or rescues > 0),
              f"{what}: the graph captured {per} over {replays} replays: want "
              f"{{{kernel!r}: {2 * k}}} over {-(-iters // k)}")
        # The launches, measured: the same chained run again under the
        # profiler, whose device record counts a graph's kernels at every
        # replay (the wrappers count Python calls: the capture once, no
        # replay). Eager: the warm-up's step and CV pass, CV re-scores and
        # rescued rows; each replay: k steps and k CV passes.
        cfg = TrainConfig(max_iter=iters, seed=seed, chain_iters=k, verbose=False)
        p, n_k, dev_k, wall_k, measured, _ = _profiled(
            lambda: train(sp, spl, Xtr, Ytr, cfg, device=dev), (kernel,))
        runs_identical(a, p, f"{what}: the profiled chained run")
        launches = measured[kernel]
        p_replays = p.chain_stats["replays"]
        want = (2 + 2 * k * p_replays + sum(h["solver"] == "float64-rescue" for h in p.cv_history)
                + sum(h["solver"].endswith("-rescue") for h in p.nll_history))
        check(launches == want,
              f"{what}: the profiler saw {launches} {kernel} launches in the chained run, want "
              f"{want} (2 eager + {2 * k} a replay x {p_replays} + re-scores and rescues)")
        steady = [h["iter_time"] for h in b.nll_history[k:]] or [float("nan")]
        steady1 = [h["iter_time"] for h in a.nll_history[1:]]
        # the backfill alone at the run's z rows: the same eigendecompositions
        # that cond_mode "device" runs inside the steps
        _, backfill_ms = timed(lambda: host_condition_numbers(
            sp, spl, np.array([h["consensus_params"] for h in a.cv_history]), device=dev))
        line = (f"phase 14 chained {what} ({time.time() - t0:.2f} s) [{smi}]: {iters} iterations "
                f"in chunks of {k}: {replays} replays of one CUDA graph; z, theta, psi identical "
                f"to the per-iteration run, agent NLL / CV rel dev {nll_dev:.1e} / {cv_dev:.1e}, "
                f"stop {b.converged_by}@{b.iterations}; {kernel} launches measured by the "
                f"profiler in a chained run {launches} = 2 eager + {2 * k} a replay x "
                f"{p_replays} (+ CV re-scores {rescores}, rescued rows {rescues}; the wrappers "
                f"counted {counts[k][kernel]}: the warm-up and the capture, no replay); train() "
                f"by CUDA events {ms[1]:.3f} ms an "
                f"iteration one at a time vs {ms[k]:.3f} chained (warm-up, capture and "
                f"backfill included); steady iterations (host clock) median "
                f"{np.median(steady1) * 1e3:.3f} vs {np.median(steady) * 1e3:.3f} ms; the first "
                f"chunk (warm-up, capture, first replay) {b.nll_history[0]['iter_time'] * k:.3f} s "
                f"of which warm-up {st['warmup_s']:.3f} s, capture {st['capture_s']:.3f} s; the "
                f"backfill alone at the run's {iters} z rows {backfill_ms:.2f} ms; graph pool "
                f"peak {st['graph_pool_peak_bytes'] / 2**20:.1f} MiB")
        if iters == GATE_ITERS:
            # kernels an iteration and the idle share, from the profiler over
            # a whole run of each mode (its host cost is in the wall)
            cfg1 = TrainConfig(max_iter=iters, seed=seed, verbose=False)
            _, n, dev_ms, wall, _, _ = _profiled(
                lambda: train(sp, spl, Xtr, Ytr, cfg1, device=dev))
            prof = {1: (n / iters, dev_ms / iters, wall / iters),
                    k: (n_k / iters, dev_k / iters, wall_k / iters)}
            line += "; profiled runs, one at a time vs chained: " + " vs ".join(
                f"{n:.0f} kernels, device {d:.3f} ms, wall {w:.3f} ms an iteration, idle share "
                f"{1 - d / w:.3f}" for n, d, w in prof.values())
            # a longer run, over which the capture's one-time cost spreads
            long = {}
            for chain in (1, k):
                cfg = TrainConfig(max_iter=CHAIN_LONG_ITERS, seed=seed, chain_iters=chain,
                                  verbose=False)
                long[chain] = timed(lambda: train(sp, spl, Xtr, Ytr, cfg, device=dev))
            runs_identical(long[1][0], long[k][0], f"{what}, {CHAIN_LONG_ITERS} iterations")
            long_ms = {c: t / long[c][0].iterations for c, (_, t) in long.items()}
            line += (f"; {long[1][0].iterations} iterations ({long[1][0].converged_by}): "
                     f"train() {long_ms[1]:.3f} vs {long_ms[k]:.3f} ms an iteration, identical")
            out[kernel] = {"launches_chained": launches, "launches_per_replay": per[kernel],
                           "replays": p_replays, "ms_per_iteration": ms[1],
                           "ms_per_iteration_chained": ms[k],
                           "ms_per_iteration_long_run": long_ms[1],
                           "ms_per_iteration_long_run_chained": long_ms[k],
                           "backfill_ms": backfill_ms,
                           "graph_pool_peak_bytes": st["graph_pool_peak_bytes"],
                           "profile": {str(c): dict(zip(("kernels", "device_ms", "wall_ms"), v))
                                       for c, v in prof.items()}}
        elif kernel == "K2":
            out[kernel] = {"launches_chained": launches, "launches_per_replay": per[kernel],
                           "replays": p_replays, "ms_per_iteration": ms[1],
                           "ms_per_iteration_chained": ms[k],
                           "graph_pool_peak_bytes": st["graph_pool_peak_bytes"]}
        print(line, flush=True)
    return out


def vjp_ops(circuit, output: str) -> int:
    """The adjoint kernel's operations for one sample: the forward sequence,
    lambda's seed (2 O psi: 24 operations an amplitude pair and qubit; a
    copy for a state's cotangent), every gate undone on both states, and
    each rotation's Im <lambda|P|phi> (8 an amplitude pair, 4 an amplitude
    for RZZ)."""
    from dqgp_tpu_torch.ops.circuit import CRX, CRY, CRZ, CX, CZ, RZZ, H

    dim, n = circuit.dim, circuit.num_qubits
    ops = 3 * gate_ops(circuit) + (24 * n * (dim // 2) if output == "features" else 0)
    for g in circuit.gates:
        if g.kind == RZZ:
            ops += 4 * dim
        elif g.kind not in (H, CX, CZ):
            ops += 8 * (dim // 4 if g.kind in (CRX, CRY, CRZ) else dim // 2)
    return ops


def vjp_bound(circuit, B: int, output: str):
    """The adjoint kernel: angles (B, G) and the cotangent in, the gradient
    (B, G) out, float32."""
    cot = 3 * circuit.num_qubits if output == "features" else 2 * circuit.dim
    return bound_ms(4 * B * (2 * circuit.num_gates + cot), B * vjp_ops(circuit, output))


def vjp_first_layout_config(num_qubits: int, num_gates: int):
    """(threads per block, padded angle-row stride, dynamic smem bytes) of
    the adjoint's first layout: a thread's two float32 states as
    [amplitude][thread] re and im planes and its angle row at an odd
    stride; threads per block halve from 128 until that fits 200 KB."""
    dim, gstride = 1 << num_qubits, num_gates | 1
    tpb = 128
    while tpb > 1 and tpb * 4 * (4 * dim + gstride) > 200 * 1024:
        tpb //= 2
    return tpb, gstride, tpb * 4 * (4 * dim + gstride)


@functools.lru_cache(maxsize=None)
def _first_layout_library(source: str = FIRST_LAYOUT_VJP):
    import ctypes

    from dqgp_tpu_torch.ops import _build

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = _build.load(source)
    signatures = {
        FIRST_LAYOUT_VJP: {"dqgp_circuit_vjp_first_layout": [vp] * 4 + [i32] * 6 + [i64, vp]},
        F64_FIRST_LAYOUT: {
            "dqgp_pauli_features_f64_first_layout": [vp] * 3 + [i32] * 5 + [i64, vp],
            "dqgp_states_f64_first_layout": [vp] * 3 + [i32] * 6 + [i64, vp]},
    }[source]
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i32
    return lib


def pauli_features_f64_first_layout(circuit, angles):
    """K1's float64 kernel in the first layout (csrc/circuit_f64_first_layout.cu:
    one thread a sample, the state in shared memory), launched as its
    wrapper did before the register layout, for the times of phases 9, 13
    and 16. It counts no launch: the package does not run it."""
    import torch

    from dqgp_tpu_torch.ops import cuda_circuit as K

    B, G = angles.shape
    out = torch.empty((B, 3 * circuit.num_qubits), dtype=torch.float64, device=angles.device)
    tpb, gstride, smem = K.launch_config(circuit.num_qubits, G, 8)
    err = _first_layout_library(F64_FIRST_LAYOUT).dqgp_pauli_features_f64_first_layout(
        angles.data_ptr(), K._gate_table(circuit, angles.device).data_ptr(), out.data_ptr(),
        B, G, circuit.num_qubits, tpb, gstride, smem, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the first-layout K1 float64 launch failed: error {err}")
    return out


def states_f64_first_layout(circuit, angles):
    """K2's float64 kernel in the first layout (qubit q on bit q), as
    ``pauli_features_f64_first_layout``."""
    import torch

    from dqgp_tpu_torch.ops import cuda_circuit as K

    B, G = angles.shape
    out = torch.empty((B, circuit.dim), dtype=torch.complex128, device=angles.device)
    tpb, gstride, sstride, smem = K.states_launch_config(circuit.num_qubits, G, 8)
    err = _first_layout_library(F64_FIRST_LAYOUT).dqgp_states_f64_first_layout(
        angles.data_ptr(), K._gate_table(circuit, angles.device).data_ptr(), out.data_ptr(),
        B, G, circuit.num_qubits, tpb, gstride, sstride, smem,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the first-layout K2 float64 launch failed: error {err}")
    return out


def vjp_first_layout(circuit, angles, cotangent, output: str):
    """The adjoint's first layout (csrc/circuit_vjp_first_layout.cu: one
    thread a sample, both states in shared memory, qubit q on bit q for
    both outputs), launched as its wrapper did, for phase 15a's times. It
    counts no launch: the package does not run it."""
    import torch

    from dqgp_tpu_torch.ops import cuda_circuit as K

    B, G = angles.shape
    grad = torch.empty_like(angles)
    cot = cotangent.contiguous()
    if output == "states":
        cot = torch.view_as_real(cot)
    tpb, gstride, smem = vjp_first_layout_config(circuit.num_qubits, G)
    err = _first_layout_library().dqgp_circuit_vjp_first_layout(
        angles.data_ptr(), K._gate_table(circuit, angles.device).data_ptr(), cot.data_ptr(),
        grad.data_ptr(), B, G, circuit.num_qubits, K.VJP_OUTPUTS.index(output), tpb, gstride,
        smem, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the first-layout adjoint's launch failed: error {err}")
    return grad


def vjp_shape_circuit(what: str):
    """The circuit of phase 15a's shape ``what`` (VJP_SHAPES)."""
    from dqgp_tpu_torch.models.circuits import build_circuit

    if what == "north star":
        return northstar_spec().circuit
    if what == "config #5":
        return build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS)
    return config7_spec().circuit


def check_vjp(rand_angles) -> dict:
    """Phase 15a: the adjoint kernel (K1's and K2's backward) against its
    plain version (torch.autograd through K1's and K2's plain versions) on
    the same CUDA tensors, for 8 families x every qubit count 1..10 x batch
    {1, 130} x both outputs, plus each autodiff step's shape (VJP_SHAPES; at
    config #7's the plain version on the first and the last VJP_PLAIN_ROWS
    rows of the launch), within VJP_TOL of max(1, max |plain|); the first
    layout at those shapes too. Then at each shape the new kernel, the first
    layout and the plain version timed in turns (a call by CUDA events; the
    plain version on the slice at config #7's), the two kernels alone from
    the profiler, and the bound. Returns the worst errors and {shape:
    record}."""
    import torch

    from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(5)

    def cotangent(circuit, B, output):
        if output == "features":
            return torch.rand((B, 3 * circuit.num_qubits), generator=gen, device="cuda") * 2 - 1
        return torch.randn((B, circuit.dim), generator=gen, device="cuda",
                           dtype=torch.complex64)

    def hold(got, want, what):
        check(got.shape == want.shape and got.dtype == torch.float32,
              f"adjoint shape {tuple(got.shape)} {got.dtype} ({what})")
        diff = float((got - want).abs().max())
        err = diff / max(1.0, float(want.abs().max()))
        check(np.isfinite(err) and err <= VJP_TOL, f"adjoint vs plain {what}: {err}")
        return err, diff

    cases = [(build_circuit(enc, n, NUM_FEATURES, 2), B, out)
             for enc in ENCODING_TYPES for n in WARP_QUBITS for B in (1, 130)
             for out in K.VJP_OUTPUTS]
    worst = worst_abs = worst_first = 0.0
    for circuit, B, output in cases:
        a = rand_angles(circuit, B)
        cot = cotangent(circuit, B, output)
        got = K.circuit_vjp(circuit, a, cot, output)
        want = K.circuit_vjp_reference(circuit, a, cot, output)
        torch.cuda.synchronize()
        err, diff = hold(got, want, f"{circuit.name} {circuit.num_qubits}q B={B} {output}")
        worst, worst_abs = max(worst, err), max(worst_abs, diff)

    shapes = {}
    for what, B, output in VJP_SHAPES:
        circuit = vjp_shape_circuit(what)
        a = rand_angles(circuit, B)
        cot = cotangent(circuit, B, output)
        sliced = what == "config #7"
        rows = [slice(0, VJP_PLAIN_ROWS), slice(B - VJP_PLAIN_ROWS, B)] if sliced else [slice(0, B)]
        got = K.circuit_vjp(circuit, a, cot, output)
        first = vjp_first_layout(circuit, a, cot, output)
        for r in rows:
            want = K.circuit_vjp_reference(circuit, a[r], cot[r], output)
            torch.cuda.synchronize()
            err, diff = hold(got[r], want, f"{what} B={B} rows {r.start}:{r.stop}")
            worst, worst_abs = max(worst, err), max(worst_abs, diff)
            worst_first = max(worst_first, hold(first[r], want, f"{what}, first layout")[0])
        del got, first
        ap, cp = (a[:VJP_PLAIN_ROWS], cot[:VJP_PLAIN_ROWS]) if sliced else (a, cot)
        reps = 3 if sliced else 20
        ms, first_ms, plain_ms = _alternate_ms(
            [lambda: K.circuit_vjp(circuit, a, cot, output),
             lambda: vjp_first_layout(circuit, a, cot, output),
             lambda: K.circuit_vjp_reference(circuit, ap, cp, output)], reps)
        device_ms = _device_ms(lambda: K.circuit_vjp(circuit, a, cot, output), reps)
        first_device_ms = _device_ms(lambda: vjp_first_layout(circuit, a, cot, output), reps)
        bound, bound_by = vjp_bound(circuit, B, output)
        shapes[what] = {"B": B, "qubits": circuit.num_qubits, "gates": circuit.num_gates,
                        "output": output, "ms": ms, "device_ms": device_ms,
                        "first_layout_ms": first_ms, "first_layout_device_ms": first_device_ms,
                        "plain_ms": plain_ms, "plain_rows": len(ap), "bound_ms": bound,
                        "bound_by": bound_by}
        del a, cot
        torch.cuda.empty_cache()
    print(f"phase 15a adjoint vs plain ({time.time() - t0:.2f} s): {len(cases)} cases + "
          f"{len(VJP_SHAPES)} autodiff-step shapes, worst |diff| / max(1, max |plain|) "
          f"{worst:.3e} (tol {VJP_TOL}), max abs diff {worst_abs:.3e}; the first layout at the "
          f"shapes {worst_first:.3e}; " + "; ".join(
              f"{what} B={t['B']} n={t['qubits']} G={t['gates']} {t['output']}: {t['ms']:.4f} ms "
              f"a call, {t['device_ms']:.4f} alone vs first layout {t['first_layout_ms']:.4f} / "
              f"{t['first_layout_device_ms']:.4f} vs plain (autograd, {t['plain_rows']} rows) "
              f"{t['plain_ms']:.4f}; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), share "
              f"{t['bound_ms'] / t['ms']:.2%} a call, {t['bound_ms'] / t['device_ms']:.2%} alone "
              f"(first layout {t['bound_ms'] / t['first_layout_device_ms']:.2%})"
              for what, t in shapes.items()), flush=True)
    return {"max_abs_err": worst_abs, "max_rel_err": worst, "max_rel_err_first_layout": worst_first,
            "by_shape": shapes}


def autodiff_phase(dev, smi: str, rand_angles) -> dict:
    """Phase 15: the adjoint kernel against its plain version and its first
    layout (15a), then (15b) the north star with grad_method="autodiff"
    against the JAX fixture's run, iteration 1's gradient beside JAX's, and
    one autodiff iteration timed beside the central one as train() runs
    them on the card. Returns the adjoint's record."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.driver import TrainConfig, train
    from dqgp_tpu_torch.models.gp.cv import cv_fold_scores_impl, kfold_pad_indices
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.parallel.consensus import (
        autodiff_nll_and_grad, make_admm_step, make_agent_batch)

    with open(DRIVER_MODES_FIXTURE) as f:
        ref = json.load(f)["autodiff"]
    X, Y, X_test, Y_test, splits = northstar_splits()
    check(problem_digest(X, Y, X_test, Y_test) == ref["problem_sha256"],
          "north-star data differ from the autodiff fixture's")
    check(N_AGENTS * max(len(x) for x, _ in splits) == VJP_SHAPES[0][1],
          "the autodiff step's adjoint batch is not the one phase 15a timed")
    vjp = check_vjp(rand_angles)
    spec = northstar_spec()
    cfg = TrainConfig(max_iter=AUTODIFF_ITERS, grad_method="autodiff", verbose=False)
    t0 = time.time()
    K.reset_launch_counts()
    res = train(spec, splits, X, Y, cfg, device=dev)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    train_s = time.time() - t0
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    f64 = backfill_launches(AUTODIFF_ITERS, N_AGENTS)
    eig = backfill_eig_counts(AUTODIFF_ITERS, [len(x) for x, _ in splits])
    check(counts["K1"] == 2 * AUTODIFF_ITERS + rescores and counts["K1_vjp"] == AUTODIFF_ITERS
          and counts["K1_f64"] == f64 and counts_hold(counts, eig)
          and sum(counts.values()) == counts["K1"] + counts["K1_vjp"] + f64 + sum(eig.values()),
          f"autodiff launches {counts}: want K1 = 2*{AUTODIFF_ITERS} + {rescores} (each step's "
          f"Gram and CV pass), K1_vjp = {AUTODIFF_ITERS} (each step's backward), K1_f64 = "
          f"{f64} and {eig} (the backfill)")
    check((res.iterations, res.converged_by) == (ref["iterations"], ref["converged_by"]),
          f"autodiff run stopped {res.converged_by}@{res.iterations}")
    z = np.array([h["consensus_params"] for h in res.cv_history])
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    z_dev = float(np.abs(z - np.array(ref["z_trajectory"])).max())
    cv_dev = float(np.abs(cv - np.array(ref["cv_nlpd"])).max())
    z1 = torch.as_tensor(ref["iteration1_z"], dtype=torch.float64, device=dev)
    g = autodiff_nll_and_grad(spec, make_agent_batch(splits, dev), M.wrap(z1), cfg.noise_std,
                              compute_cond=False).grad.cpu().numpy()
    g_ref = np.array(ref["iteration1_grad"])
    g_dev = float(np.abs(g - g_ref).max() / np.abs(g_ref).max())
    check(bool(np.all(np.isfinite(g))), "non-finite autodiff gradient")
    worst = np.unravel_index(np.argmax(np.abs(g - g_ref)), g.shape)

    # one iteration (step + CV) of each gradient, as train() runs it on the
    # card (cond_mode "auto" = "host": no condition numbers in the step), in
    # turns; the adjoint's device time within an autodiff step
    batch = make_agent_batch(splits, dev)
    Xt, Yt = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    theta, psi = torch.as_tensor(res.theta, device=dev), torch.as_tensor(res.psi, device=dev)
    folds = kfold_pad_indices(N_SAMPLES, cfg.cv_folds, cfg.seed, dev)
    steps = {m: make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                               compute_cond=False, grad_method=m)
             for m in ("autodiff", "central")}

    def iteration(m):
        def run():
            out = steps[m](theta, psi, batch)
            cv_fold_scores_impl(spec, Xt, Yt, out.z, *folds, noise_std=cfg.noise_std)
        return run

    ad_ms, central_ms = _alternate_ms([iteration("autodiff"), iteration("central")], 5)
    _, _, step_dev_ms, _, _, vjp_ms = _profiled(lambda: steps["autodiff"](theta, psi, batch),
                                                 ("K1_vjp",))
    vjp_dev_ms = vjp_ms["K1_vjp"]
    print(f"phase 15b autodiff north star ({train_s:.2f} s) [{smi}]: {AUTODIFF_ITERS} iterations "
          f"with grad_method=autodiff, launches {counts}; z dev {z_dev:.1e} (tol {Z_TOL}), CV-NLPD "
          f"dev {cv_dev:.2e} (tol {NLPD_TOL}); iteration 1's gradient vs jax.value_and_grad: max "
          f"|diff| / max |g| = {g_dev:.2e} (tol {AUTODIFF_GRAD_TOL}); agent 1 "
          + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in zip(g[0, :6], g_ref[0, :6]))
          + f" ...; the largest difference at agent {worst[0] + 1}, component {worst[1]}: "
          f"{g[worst]:.5f} vs {g_ref[worst]:.5f}; one iteration (step + 5-fold CV, as train() "
          f"runs it) autodiff {ad_ms:.3f} ms vs central {central_ms:.3f} ms; the autodiff step's "
          f"device time {step_dev_ms:.3f} ms, of which the adjoint {vjp_dev_ms:.4f} ms "
          f"({vjp_dev_ms / step_dev_ms:.1%})", flush=True)
    check(z_dev <= Z_TOL, f"autodiff z trajectory deviates {z_dev} > {Z_TOL}")
    check(cv_dev <= NLPD_TOL, f"autodiff CV-NLPD deviates {cv_dev} > {NLPD_TOL}")
    check(g_dev <= AUTODIFF_GRAD_TOL,
          f"autodiff gradient deviates {g_dev:.2e} > {AUTODIFF_GRAD_TOL} of its largest component")
    ns = vjp["by_shape"]["north star"]
    return {"launches": counts["K1_vjp"], "max_abs_err": vjp["max_abs_err"],
            "max_rel_err": vjp["max_rel_err"],
            "max_rel_err_first_layout": vjp["max_rel_err_first_layout"],
            **{k: ns[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                  "first_layout_ms", "first_layout_device_ms", "B")},
            "by_shape": vjp["by_shape"],
            "northstar_iteration_ms": {"autodiff": ad_ms, "central": central_ms},
            "northstar_autodiff_step_device_ms": step_dev_ms,
            "northstar_adjoint_device_ms_in_step": vjp_dev_ms}


def config7_autodiff_phase(dev, smi: str, full, streamed_step_ms: float) -> dict:
    """Phase 15c: config #7 with grad_method="autodiff". (a) The fixture
    problem (1,111 samples over 8 agents, 3 iterations) held to
    tests/fixtures/torch_port_config7_autodiff.json: agent NLLs at JAX's own
    z within config7_nll_bars, iteration 1's gradient within
    config7_autodiff_grad_bar of its largest component, z within Z_TOL over
    the iterations both runs share. (b) Full width (``full``: phase 11b's 49,999
    rows over 64 agents), C7_ITERS iterations: K3 twice an iteration (the
    step's forward at 64 x 844 rows and the CV pass) and the adjoint once
    (the step's backward), finite NLLs, z and gradients, iteration 1's
    nll_sum against the JAX log's; the step timed beside phase 12's
    streamed one, and the adjoint's device time within it. Returns the
    record."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.driver import train
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.parallel.consensus import (
        autodiff_nll_and_grad, make_admm_step, make_agent_batch)

    spec = config7_spec()
    P = spec.num_parameters
    with open(CONFIG7_AUTODIFF_FIXTURE) as f:
        ref = json.load(f)

    def launches_ok(counts, res, iters, what):
        rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
        check(counts["K3"] == 2 * iters + rescores and counts["K1_vjp"] == iters
              and sum(counts.values()) == counts["K3"] + counts["K1_vjp"],
              f"{what} launches {counts}: want K3 = 2*{iters} + {rescores} (each step's forward "
              f"and CV pass), K1_vjp = {iters} (each step's backward), no other kernel")
        return rescores

    # (a) the fixture problem
    t0 = time.time()
    X_tr, Y_tr, _, _, splits = config7_problem(C7_FIX_SAMPLES, C7_FIX_AGENTS)
    check([len(x) for x, _ in splits] == ref["problem"]["shard_sizes"], "shard sizes differ")
    cfg = config7_train_config(C7_FIX_ITERS, grad_method="autodiff", verbose=False)
    K.reset_launch_counts()
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    launches_ok(counts, res, C7_FIX_ITERS, "config #7 autodiff fixture")
    iters = min(res.iterations, ref["iterations"])
    z = np.array([h["consensus_params"] for h in res.cv_history])[:iters]
    z_dev = float(np.abs(z - np.array(ref["z_trajectory"])[:iters]).max())
    nll = config7_agent_nll_at(spec, splits, ref["z_trajectory"], dev, cfg.noise_std)
    bars = config7_nll_bars(ref)
    nll_dev = (np.abs(nll - ref["agent_nll"]) / np.abs(ref["agent_nll"])).max(axis=1)
    z1 = torch.as_tensor(ref["iteration1_z"], dtype=torch.float64, device=dev)
    g = autodiff_nll_and_grad(spec, make_agent_batch(splits, dev), M.wrap(z1), cfg.noise_std,
                              compute_cond=False).grad.cpu().numpy()
    g_ref = np.array(ref["iteration1_grad"])
    g_dev = float(np.abs(g - g_ref).max() / np.abs(g_ref).max())
    g_bar = config7_autodiff_grad_bar(ref)
    cv = [h["consensus_cv_score"] for h in res.cv_history][:iters]
    print(f"phase 15c config #7 autodiff, fixture problem ({time.time() - t0:.2f} s): "
          f"{len(X_tr)} train rows over {C7_FIX_AGENTS} agents, {res.iterations} iterations, "
          f"launches {counts}; z dev {z_dev:.1e} (tol {Z_TOL}); agent NLL rel dev at JAX's z "
          f"{[f'{d:.2e}' for d in nll_dev]} (bars {[f'{b:.2e}' for b in bars]}); iteration 1's "
          f"gradient vs jax.value_and_grad: max |diff| / max |g| = {g_dev:.2e} (bar "
          f"{g_bar:.2e} = max({AUTODIFF_GRAD_TOL}, 2 x JAX's own spread)); CV-NLPD "
          f"{[round(v, 4) for v in cv]} vs JAX "
          f"{[round(v, 4) for v in ref['cv_nlpd'][:iters]]}", flush=True)
    check(bool(np.all(np.isfinite(g))) and bool(np.all(np.isfinite(nll))),
          "non-finite config #7 autodiff gradient or NLL")
    check(z_dev <= Z_TOL, f"config #7 autodiff z deviates {z_dev} > {Z_TOL}")
    check(bool(np.all(nll_dev <= bars)), f"config #7 autodiff agent NLLs {nll_dev} beyond {bars}")
    check(g_dev <= g_bar, f"config #7 autodiff gradient deviates {g_dev:.2e} > {g_bar:.2e}")

    # (b) full width
    t0 = time.time()
    X_tr, Y_tr, splits = full
    cfg = config7_train_config(C7_ITERS, grad_method="autodiff", verbose=False)
    K.reset_launch_counts()
    t1 = time.time()
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    torch.cuda.synchronize()
    train_s = time.time() - t1
    counts = K.launch_counts()
    launches_ok(counts, res, C7_ITERS, "config #7 autodiff at full width")
    nll1 = res.nll_history[0]["total_nll"]
    nll_rel = abs(nll1 - C7_NLL_ITER1) / C7_NLL_ITER1
    check(np.all(np.isfinite(res.z)) and all(np.all(np.isfinite(h["agent_losses"]))
                                             for h in res.nll_history),
          "non-finite config #7 autodiff z or agent NLL")
    step = make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                          compute_cond=False, grad_method="autodiff")
    batch = make_agent_batch(splits, dev)
    theta, psi = torch.as_tensor(res.theta, device=dev), torch.as_tensor(res.psi, device=dev)
    out = step(theta, psi, batch)
    check(bool(torch.isfinite(out.theta).all()) and bool(torch.isfinite(out.nll).all()),
          "non-finite config #7 autodiff step")
    step_ms = _cuda_time_ms(lambda: step(theta, psi, batch), 3)
    _, _, step_dev_ms, _, _, vjp_ms = _profiled(lambda: step(theta, psi, batch), ("K1_vjp",))
    vjp_dev_ms = vjp_ms["K1_vjp"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 15c config #7 autodiff at full width ({time.time() - t0:.2f} s) [{smi}]: "
          f"{len(X_tr)} train rows over {C7_AGENTS} agents, {C7_ITERS} iterations in "
          f"{train_s:.2f} s, launches {counts}; iteration 1 nll_sum {nll1:.4f} vs JAX "
          f"{C7_NLL_ITER1} (rel dev {nll_rel:.2e}, tol 1e-3); the autodiff step {step_ms:.1f} ms "
          f"(device {step_dev_ms:.1f} ms, of which the adjoint at B={C7_AGENTS * C7_NMAX} "
          f"{vjp_dev_ms:.3f} ms, {vjp_dev_ms / step_dev_ms:.1%}) vs the streamed step "
          f"{streamed_step_ms:.1f} ms (phase 12, this call); peak allocated {peak:.2f} GiB",
          flush=True)
    check(nll_rel <= 1e-3, f"config #7 autodiff iteration 1 nll_sum {nll1}: rel {nll_rel}")
    return {"launches": counts["K1_vjp"], "step_ms": step_ms, "step_device_ms": step_dev_ms,
            "adjoint_device_ms_in_step": vjp_dev_ms, "streamed_step_ms": streamed_step_ms,
            "fixture": {"z_dev": z_dev, "nll_rel_dev": nll_dev.tolist(), "grad_dev": g_dev,
                        "grad_bar": g_bar}}


# --------------------------------------------------------------------------
# phase 17: the port's CLI
# --------------------------------------------------------------------------

# every hand kernel's plain version, which its wrapper runs only for a tensor
# on the CPU: phase 17 counts their calls
PLAIN_ENGINES = ("pauli_features_reference", "states_reference",
                 "pauli_features_fused_reference", "states_fused_reference",
                 "circuit_vjp_reference")


def ensure_srtm_tiles(tiles) -> None:
    """Write the stand-in SRTM tiles into srtm_data/ where one of ``tiles``
    is missing: scripts/make_synthetic_tiles.py, run as a subprocess."""
    if all(os.path.exists(os.path.join(SRTM_DIR, f"{t}.hgt")) for t in tiles):
        return
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synthetic_tiles.py"),
                    SRTM_DIR], check=True, cwd=REPO, capture_output=True)


def file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_port_cli(flags, log_path: str, cwd: str = REPO):
    """The port's ``cli.run(flags)`` in ``cwd`` (the README's SRTM command
    reads ./srtm_data) with ``--metrics-json`` beside ``log_path``, which
    gets the run's standard output. Returns (the summary
    as the metrics JSON holds it, the stage seconds, the split the CLI made:
    [X_train, X_test, Y_train, Y_test], the wall seconds of the run)."""
    import contextlib
    import io

    import dqgp_tpu_torch.data as D
    from dqgp_tpu_torch import cli

    metrics = os.path.splitext(log_path)[0] + ".json"
    split = []
    real_split = D.train_test_split_np

    def capture(*args, **kwargs):
        out = real_split(*args, **kwargs)
        split.extend(out[:4])
        return out

    out = io.StringIO()
    D.train_test_split_np = capture
    t0 = time.perf_counter()
    try:
        with contextlib.chdir(cwd), contextlib.redirect_stdout(out):
            _, stages = cli.run(list(flags) + ["--metrics-json", metrics])
    finally:
        D.train_test_split_np = real_split
    wall = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(out.getvalue())
    with open(metrics) as f:
        return json.load(f), stages, split, wall


def _cond_buckets(summary):
    """The reference's bucket of every recorded condition number (the
    metrics JSON writes an infinite one as null)."""
    return [[cond_bucket(np.inf if c is None else c) for c in h["condition_numbers"]]
            for h in summary["nll_history"]]


def hold_cli_run(name: str, summary, split, ref) -> dict:
    """Run ``name`` of the port's CLI against the JAX CLI's (``ref``, the
    fixture's run): the dataset after the split, the summary's keys, the
    stop, then run A's trajectory over its held prefix and its condition
    numbers' buckets, or run B's agent NLLs, CV and test NLPD (config #5's
    bars) and ground-truth comparison. Returns the deviations."""
    want, ds = ref["summary"], ref["dataset"]
    X_tr, X_te, Y_tr, Y_te = split
    check(array_digest(X_tr) == ds["x_train_sha256"]
          and array_digest(X_te) == ds["x_test_sha256"],
          f"run {name}: X after the split differs from JAX's")
    y_dev = float(max(np.abs(Y_tr - np.array(ds["Y_train"])).max(),
                      np.abs(Y_te - np.array(ds["Y_test"])).max()))
    check(y_dev <= CLI_Y_TOL[name], f"run {name}: Y deviates {y_dev} > {CLI_Y_TOL[name]}")
    check(set(summary) == set(want), f"run {name}: summary keys {sorted(set(summary) ^ set(want))} "
                                     f"differ from JAX's")
    check(summary["iterations"] == want["iterations"]
          and summary["converged_by"] == want["converged_by"],
          f"run {name}: stopped {summary['converged_by']}@{summary['iterations']}, JAX "
          f"{want['converged_by']}@{want['iterations']}")
    z = [h["consensus_params"] for h in summary["cv_history"]]
    cv = np.array([h["consensus_cv_score"] for h in summary["cv_history"]])
    dev = {"Y": y_dev}
    if name == "A":
        z_dev, cv_dev, held, first = gate_deviations(z, cv, ref)
        dev.update(z=z_dev.tolist(), cv_nlpd=cv_dev.tolist(), held_iterations=held,
                   first_departure=first)
        for part in ("test", "train"):
            dev[f"{part}_nlpd"] = summary[f"{part}_metrics"]["nlpd"] - want[f"{part}_metrics"]["nlpd"]
        dev["sigma_rel"] = (summary["noise_fit"]["fitted_noise_std"]
                            / want["noise_fit"]["fitted_noise_std"] - 1)
        nll1, nll1_ref = (np.array(h["nll_history"][0]["agent_losses"]) for h in (summary, want))
        dev["agent_nll_rel_iteration_1"] = float((np.abs(nll1 - nll1_ref) / np.abs(nll1_ref)).max())
        check(held >= CLI_HELD_ITERS, f"run A leaves its bars at {first}, inside the "
                                      f"held prefix of {CLI_HELD_ITERS} iterations")
        check(max(abs(dev["test_nlpd"]), abs(dev["train_nlpd"])) <= NLPD_TOL,
              f"run A: test / train NLPD deviate {dev['test_nlpd']} / {dev['train_nlpd']} "
              f"beyond {NLPD_TOL}")
        check(_cond_buckets(summary) == _cond_buckets(want),
              f"run A: host condition numbers {[h['condition_numbers'] for h in summary['nll_history']]} "
              f"not in JAX's buckets")
        return dev
    z_dev = float(np.abs(np.array(z) - np.array(ref["z_trajectory"])).max())
    nll = np.array([h["agent_losses"] for h in summary["nll_history"]])
    nll_ref = np.array([h["agent_losses"] for h in want["nll_history"]])
    nll_dev = float((np.abs(nll - nll_ref) / np.abs(nll_ref)).max())
    cv32 = np.array(ref["cv_nlpd"])
    cv_bar = np.maximum(NLPD_TOL, 2 * np.abs(cv32 - np.array(ref["cv_nlpd_f64_features"])))
    t32 = want["test_metrics"]["nlpd"]
    t_bar = max(NLPD_TOL, 2 * abs(t32 - ref["test_nlpd_f64_features"]))
    t_dev = abs(summary["test_metrics"]["nlpd"] - t32)
    dev.update(z=z_dev, agent_nll_rel=nll_dev,
               cv_nlpd_over_bar=float((np.abs(cv - cv32) / cv_bar).max()),
               test_nlpd=t_dev, test_nlpd_bar=t_bar)
    check(z_dev <= Z_TOL, f"run B: z deviates {z_dev} > {Z_TOL}")
    check(nll_dev <= NLL_RTOL, f"run B: agent NLLs deviate {nll_dev} > {NLL_RTOL}")
    check(dev["cv_nlpd_over_bar"] <= 1.0, f"run B: CV-NLPD {cv.tolist()} vs JAX f32 "
                                          f"{cv32.tolist()} beyond the bars {cv_bar.tolist()}")
    check(t_dev <= t_bar, f"run B: test NLPD deviates {t_dev} > {t_bar}")
    # The ground-truth comparison: each metric's trained and ground-truth
    # values, the NLPDs at the NLPD bar, the rest at GT_METRIC_RTOL. Its
    # winners and verdict are printed, not held: on config #5 the trained z
    # and theta* predict alike to ~1e-7 relative and their NLPDs differ by
    # less than the NLPD bar, so the signs the verdict counts are float32 noise.
    rows, want_rows = summary["gt_comparison"]["metrics"], want["gt_comparison"]["metrics"]
    check(rows.keys() == want_rows.keys(), f"run B: ground-truth comparison of {list(rows)}")
    worst = 0.0
    for k, w in want_rows.items():
        for side in ("trained", "ground_truth"):
            err = abs(rows[k][side] - w[side])
            bar = t_bar if k == "nlpd" else GT_METRIC_RTOL * abs(w[side])
            worst = max(worst, err / bar if bar else float(err > 0))
    dev.update(gt_metrics_over_bar=worst, gt_verdict=[summary["gt_comparison"]["verdict"],
                                                      want["gt_comparison"]["verdict"]])
    check(worst <= 1.0, f"run B: ground-truth comparison {rows} vs JAX's {want_rows}")
    return dev


def cli_at_reference_z(split, ref, device) -> dict:
    """Run A's noise fit and predictions at JAX's own selected z (the
    fixture's ``best_cv_z``) on the CLI's split: the fitted sigma within
    SIGMA_RTOL of JAX's, and with JAX's sigma, as ``--predictive-noise``
    scores them, the test and train NLPD within NLPD_TOL of JAX's."""
    import torch

    from dqgp_tpu_torch.models.gp import evaluate_predictions, fit_noise_std, predict_quantum_gp

    want = ref["summary"]
    X_tr, X_te, Y_tr, Y_te = split
    spec = northstar_spec()   # run A's circuit and kernel are the north star's
    z = np.asarray(want["best_cv_z"], np.float64)
    sigma = want["noise_fit"]["fitted_noise_std"]
    fit = fit_noise_std(spec, X_tr, Y_tr, z, current_noise_std=want["config"]["noise_std"],
                        device=device)
    out = {"sigma_rel": abs(fit.noise_std / sigma - 1)}
    check(out["sigma_rel"] <= SIGMA_RTOL, f"run A at JAX's z: fitted sigma {fit.noise_std} vs "
                                          f"JAX's {sigma} beyond rtol {SIGMA_RTOL}")
    X_t, Y_t = torch.as_tensor(X_tr, device=device), torch.as_tensor(Y_tr, device=device)
    for part, X, Y in (("test", X_te, Y_te), ("train", X_tr, Y_tr)):
        mean, var = predict_quantum_gp(spec, X_t, Y_t, torch.as_tensor(X, device=device),
                                       torch.as_tensor(z, device=device), noise_std=sigma)
        got = evaluate_predictions(Y, mean, var + sigma ** 2)["nlpd"]
        out[f"{part}_nlpd"] = got - want[f"{part}_metrics"]["nlpd"]
        check(abs(out[f"{part}_nlpd"]) <= NLPD_TOL,
              f"run A at JAX's z: {part} NLPD {got} vs JAX's "
              f"{want[f'{part}_metrics']['nlpd']} beyond {NLPD_TOL}")
    return out


def cli_launches_expected(name: str, summary, sizes) -> dict:
    """Each hand kernel's launches in run ``name``: the step and the CV pass
    an iteration (and a float64 CV re-score where one was flagged), two a
    predict (training and evaluated rows: test, train, and for run B the
    ground-truth parameters' test), one float64 an agent and 16 z rows in
    the backfill, one float64 for run A's noise fit and for run B's dataset;
    and the backfill's eigenvalue counts over agents of ``sizes`` rows."""
    iters = summary["iterations"]
    rescores = sum(h["solver"] == "float64-rescue" for h in summary["cv_history"])
    backfill = backfill_launches(iters, summary["config"]["n_agents"])
    eig = nonzero(backfill_eig_counts(iters, sizes))
    if name == "A":
        return {"K1": 2 * iters + 4 + rescores, "K1_f64": backfill + 1, **eig}
    return {"K2": 2 * iters + 6 + rescores, "K2_f64": 1 + backfill, **eig}


def cli_phase(dev, smi: str) -> dict:
    """Phase 17: runs A and B through the port's CLI on the card, held to
    tests/fixtures/torch_port_cli.json; run A's noise fit and NLPDs at JAX's
    z; the module entry point in a subprocess. Prints the ``cli`` line;
    returns each run's launches."""
    import contextlib
    from unittest import mock

    from dqgp_tpu_torch.ops import cuda_circuit as K

    t_phase = time.time()
    with open(CLI_FIXTURE) as f:
        fixture = json.load(f)
    tiles = fixture["runs"]["A"]["tiles_sha256"]
    ensure_srtm_tiles(tiles)
    for t, digest in tiles.items():
        check(file_digest(os.path.join(SRTM_DIR, f"{t}.hgt")) == digest,
              f"stand-in tile {t} differs from the one JAX's run read")
    report = {}
    # the runs' own output and metrics JSON, read back and not printed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as out_dir:
        for name, flags in CLI_RUNS.items():
            ref = fixture["runs"][name]
            K.reset_launch_counts()
            with contextlib.ExitStack() as patches:
                plain = {n: patches.enter_context(mock.patch.object(K, n, wraps=getattr(K, n)))
                         for n in PLAIN_ENGINES}
                summary, stages, split, wall = run_port_cli(
                    flags + ["--device", str(dev)], os.path.join(out_dir, f"run_{name}.log"))
            counts = {k: v for k, v in K.launch_counts().items() if v}
            sizes = agent_rows(os.path.join(out_dir, f"run_{name}.log"))
            check(len(sizes) == summary["config"]["n_agents"],
                  f"run {name}'s log lists {len(sizes)} agents")
            want = cli_launches_expected(name, summary, sizes)
            check(counts == want, f"run {name}: launches {counts}, want {want} and no other kernel")
            plain = {n: m.call_count for n, m in plain.items() if m.call_count}
            check(not plain, f"run {name} reached a plain engine on the card: {plain}")
            dev_ = hold_cli_run(name, summary, split, ref)
            if name == "A":
                dev_["at_jax_z"] = cli_at_reference_z(split, ref, dev)
            iter_times = [h["iter_time"] for h in summary["nll_history"]]
            report[name] = {
                "stages_s": stages, "wall_s": wall,
                "other_s": wall - sum(stages.values()),
                "iterations": summary["iterations"],
                "iteration_ms_first": 1e3 * iter_times[0],
                "iteration_ms_steady_median": 1e3 * float(np.median(iter_times[1:])),
                "launches": counts, "deviations": dev_,
                "test_nlpd": summary["test_metrics"]["nlpd"],
                "jax_test_nlpd": ref["summary"]["test_metrics"]["nlpd"],
            }
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "dqgp_tpu_torch.cli", *CLI_RUNS["B"], "--dataset-only",
         "--device", "cuda"], cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "Stopping after dataset loading" in proc.stdout,
          f"python -m dqgp_tpu_torch.cli --dataset-only exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    report["module_entry_point_s"] = time.time() - t0
    report["phase_s"] = time.time() - t_phase
    report["device"] = smi
    print("cli " + json.dumps(report, default=float), flush=True)
    return {name: report[name]["launches"] for name in CLI_RUNS}


# --------------------------------------------------------------------------
# phase 18: the rest of the one-device scale-out
# --------------------------------------------------------------------------


def indefinite_matrix(n: int, negatives=(-0.8, -0.05), seed: int = 0) -> np.ndarray:
    """tests/test_blocked.py:212-217: a symmetric matrix with spectrum
    linspace(0.5, 3.0) whose first eigenvalues are ``negatives``."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    w = np.linspace(0.5, 3.0, n)
    w[:len(negatives)] = negatives
    A = (Q * w) @ Q.T
    return (A + A.T) / 2


def scale_out_spec(flags):
    """The kernel spec a run of SCALE_OUT_RUNS or SCALE_OUT_CPU_RUNS builds."""
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    def flag(name):
        return flags[flags.index(name) + 1]

    return QuantumKernelSpec(
        circuit=build_circuit("chebyshev", int(flag("--num-qubits")), 2, int(flag("--num-layers"))),
        kernel_type="projected", outer_kernel="matern", regularization=flag("--regularization"))


def scale_out_launches_expected(summary, num_parameters: int) -> int:
    """K3's launches in a run of SCALE_OUT_RUNS: each streamed step (the Gram
    at wrap(z) and one +-h batch a parameter) and CV pass (and a float64 CV
    re-score where one was flagged), then the CG predictor's training rows
    and one a predict (test rows, the train subsample)."""
    iters = summary["iterations"]
    rescores = sum(h["solver"] == "float64-rescue" for h in summary["cv_history"])
    return iters * (1 + num_parameters) + iters + rescores + 3


def hold_scale_out_run(name: str, summary, split, ref) -> dict:
    """Run ``name`` of the port's CLI against the JAX CLI's (``ref``): the
    dataset after the split (X exact, Y within SCALE_OUT_Y_TOL), the
    summary's keys and stop, z and CV-NLPD over SCALE_OUT_HELD_ITERS (all
    deviations returned), the run's own test and train NLPD (returned, not
    held: they follow the run's own z)."""
    want, ds = ref["summary"], ref["dataset"]
    X_tr, X_te, Y_tr, Y_te = split
    check(array_digest(X_tr) == ds["x_train_sha256"]
          and array_digest(X_te) == ds["x_test_sha256"],
          f"run {name}: X after the split differs from JAX's")
    y_dev = float(max(np.abs(Y_tr - np.array(ds["Y_train"])).max(),
                      np.abs(Y_te - np.array(ds["Y_test"])).max()))
    check(y_dev <= SCALE_OUT_Y_TOL, f"run {name}: Y deviates {y_dev} > {SCALE_OUT_Y_TOL}")
    check(set(summary) == set(want), f"run {name}: summary keys "
                                     f"{sorted(set(summary) ^ set(want))} differ from JAX's")
    check(summary["iterations"] == want["iterations"]
          and summary["converged_by"] == want["converged_by"],
          f"run {name}: stopped {summary['converged_by']}@{summary['iterations']}, JAX "
          f"{want['converged_by']}@{want['iterations']}")
    z = [h["consensus_params"] for h in summary["cv_history"]]
    cv = [h["consensus_cv_score"] for h in summary["cv_history"]]
    z_dev, cv_dev, held, first = gate_deviations(z, cv, ref)
    check(held >= SCALE_OUT_HELD_ITERS, f"run {name} leaves its bars at {first}, inside the "
                                        f"held prefix of {SCALE_OUT_HELD_ITERS} iterations")
    return {"Y": y_dev, "z": z_dev.tolist(), "cv_nlpd": cv_dev.tolist(),
            "held_iterations": held, "first_departure": first,
            **{f"own_{part}_nlpd": summary[f"{part}_metrics"]["nlpd"]
               - want[f"{part}_metrics"]["nlpd"] for part in ("test", "train")}}


def scale_out_nlpd_bar(ref, part: str) -> float:
    """The bar of run ``ref``'s ``part`` ("test" or "train") NLPD at JAX's z:
    max(NLPD_TOL, twice JAX's own spread of it), over float64 features (PERF.md
    §2's config #7 bar) and over the dense posterior (the CG route's own
    tolerance: config #7's variances are small differences that the CG's
    tolerance moves)."""
    at = ref["nlpd_at_z"]
    own = at[f"{part}_nlpd_f32"]
    return max(NLPD_TOL, 2 * abs(own - at[f"{part}_nlpd_f64_features"]),
               2 * abs(own - at[f"{part}_nlpd_dense"]))


def scale_out_at_reference_z(flags, split, ref, device) -> dict:
    """Run ``ref``'s CG route at JAX's own selected z (the fixture's
    ``best_cv_z``) on the CLI's split, as the CLI predicts: the clip's
    lambda_min beside JAX's; the test and train-subsample NLPD within
    ``scale_out_nlpd_bar`` of JAX's; the CG mean and variance on the test
    rows against the dense float64 posterior, whose square Gram goes
    through regularize_gram (CG_MEAN_RTOL / CG_VAR_RTOL, CG_ATOL), and that
    posterior's NLPD beside JAX's dense one."""
    import torch
    from unittest import mock

    from dqgp_tpu_torch.models.gp import evaluate_predictions, predict_quantum_gp
    from dqgp_tpu_torch.parallel import blocked as BL

    want = ref["summary"]
    X_tr, X_te, Y_tr, Y_te = split
    spec = scale_out_spec(flags)
    noise = want["config"]["noise_std"]
    z = torch.as_tensor(np.asarray(want["best_cv_z"], np.float64), device=device)
    X_t, Y_t = torch.as_tensor(X_tr, device=device), torch.as_tensor(Y_tr, device=device)
    clips = []
    real = BL.make_lowrank_regularizer

    def capture(*args, **kwargs):
        clips.append(real(*args, **kwargs))
        return clips[-1]

    t0 = time.perf_counter()
    with mock.patch.object(BL, "make_lowrank_regularizer", capture):
        predict = BL.make_cg_predictor(spec, X_t, Y_t, z, noise, device=device)
    setup_s = time.perf_counter() - t0
    check(len(clips) == 1, f"the CG predictor built {len(clips)} clips, want 1")
    reg, jclip = clips[0], ref["clip"][0]
    threshold = int(flags[flags.index("--predict-cg-threshold") + 1])
    sub_n = min(len(X_tr), max(threshold, 1024))
    sel = np.random.RandomState(want["config"]["seed"]).choice(len(X_tr), sub_n, replace=False)
    out = {"setup_s": setup_s, "lambda_min": float(reg.lambda_min),
           "jax_lambda_min": jclip["lambda_min"],
           "nonzero_w": int(torch.count_nonzero(reg.w)), "jax_nonzero_w": jclip["nonzero_w"],
           "shift": float(reg.shift), "saturated": bool(reg.saturated),
           "alpha_iterations": predict.alpha_result.iterations}
    mean = None
    for part, X, Y in (("test", X_te, Y_te), ("train", X_tr[sel], Y_tr[sel])):
        m, v = predict(X)
        got = evaluate_predictions(Y, m, v)["nlpd"]
        bar = scale_out_nlpd_bar(ref, part)
        out[f"{part}_nlpd"], out[f"{part}_nlpd_bar"] = got - want[f"{part}_metrics"]["nlpd"], bar
        check(abs(out[f"{part}_nlpd"]) <= bar,
              f"at JAX's z: {part} NLPD {got} vs JAX's {want[f'{part}_metrics']['nlpd']} "
              f"beyond {bar}")
        if mean is None:
            mean, var = m, v
    m_d, v_d = predict_quantum_gp(spec, X_t, Y_t, torch.as_tensor(X_te, device=device), z,
                                  noise_std=noise)
    out["dense_test_nlpd"] = (evaluate_predictions(Y_te, m_d, v_d)["nlpd"]
                              - ref["nlpd_at_z"]["test_nlpd_dense"])
    out["cg_mean_over_bar"] = _allclose(mean.cpu(), m_d.cpu(), CG_MEAN_RTOL, CG_ATOL)
    out["cg_var_over_bar"] = _allclose(var.cpu(), v_d.cpu(), CG_VAR_RTOL, CG_ATOL)
    check(out["cg_mean_over_bar"] <= 1.0 and out["cg_var_over_bar"] <= 1.0,
          f"at JAX's z the CG route with the clip disagrees with the dense regularized "
          f"posterior: {out}")
    return out


def clip_phase(dev, c7) -> dict:
    """18a: the clip on indefinite matrices (n = 64 and 4,096) against the
    dense eigh clip for both methods, ``saturated`` both ways; then on
    config #7's float64 Gram of the first CLIP_GRAM_ROWS training rows at
    11b's z against the dense eigh clip of the same Gram."""
    import dataclasses

    import torch

    from dqgp_tpu_torch.models.kernels.quantum_kernel import (
        gram_from_features, kernel_features, regularize_gram)
    from dqgp_tpu_torch.parallel import blocked as BL

    t0 = time.time()
    report = {}
    for n in CLIP_N:
        negatives = CLIP_NEGATIVES[n]
        A = torch.as_tensor(indefinite_matrix(n, negatives), device=dev)
        v = torch.randn((n, 3), dtype=torch.float64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(n))
        for method in ("thresholding", "tikhonov"):
            t1 = time.perf_counter()
            reg = BL.make_lowrank_regularizer_from_matvec(lambda x: A @ x, n, method, rank=8,
                                                          dtype=torch.float64, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            dense = regularize_gram(A, method)
            mv = _allclose(reg.matvec(A @ v, v).cpu(), (dense @ v).cpu(), CLIP_RTOL, CLIP_ATOL)
            dg = _allclose((torch.diagonal(A) + reg.diag_correction()).cpu(),
                           torch.diagonal(dense).cpu(), CLIP_RTOL, CLIP_ATOL)
            lam_dev = abs(float(reg.lambda_min) / negatives[0] - 1)
            report[f"{method}_{n}"] = {"matvec_over_bar": mv, "diag_over_bar": dg,
                                       "lambda_min": float(reg.lambda_min),
                                       "lambda_min_rel_dev": lam_dev, "s": secs}
            check(mv <= 1.0 and dg <= 1.0 and lam_dev <= CLIP_LAMBDA_RTOL
                  and not bool(reg.saturated),
                  f"18a clip {method} at n = {n} vs eigh: {report[f'{method}_{n}']}")
        short = BL.make_lowrank_regularizer_from_matvec(lambda x: A @ x, n, "thresholding",
                                                        rank=1, dtype=torch.float64, device=dev)
        check(bool(short.saturated), f"18a: rank 1 < {len(negatives)} negatives at n = {n} "
                                     f"is not saturated")
    # config #7's float64 Gram, first CLIP_GRAM_ROWS rows, at 11b's z
    spec = dataclasses.replace(config7_spec(), regularization="thresholding")
    X = torch.as_tensor(c7["X_tr"][:CLIP_GRAM_ROWS], device=dev).to(torch.float32)
    F = kernel_features(spec, X, c7["z"]).to(torch.float64)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reg = BL.make_lowrank_regularizer(spec, F, block=4096, dtype=torch.float64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    K = gram_from_features(dataclasses.replace(spec, regularization=None), F)
    eig = torch.linalg.eigvalsh(K)
    dense = regularize_gram(K, "thresholding")
    v = torch.randn((CLIP_GRAM_ROWS, 3), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    mv = _allclose(reg.matvec(K @ v, v).cpu(), (dense @ v).cpu(), CLIP_RTOL, CLIP_ATOL)
    report["config7_gram"] = {"rows": CLIP_GRAM_ROWS, "s": secs, "lambda_min": float(reg.lambda_min),
                              "eigvalsh_min": float(eig[0]), "eigvalsh_max": float(eig[-1]),
                              "nonzero_w": int(torch.count_nonzero(reg.w)),
                              "saturated": bool(reg.saturated), "matvec_over_bar": mv}
    check(mv <= 1.0, f"18a clip on config #7's Gram vs eigh: {report['config7_gram']}")
    del K, dense, F
    print(f"phase 18a clip ({time.time() - t0:.2f} s): " + "; ".join(
        f"{k}: " + ", ".join(f"{kk} {vv:.3g}" if isinstance(vv, float) else f"{kk} {vv}"
                             for kk, vv in r.items()) for k, r in report.items()), flush=True)
    return report


def scale_out_cli_phase(dev) -> dict:
    """18b: runs C and D through the port's CLI on the card against the
    fixture, and their CG route at JAX's z."""
    import contextlib
    from unittest import mock

    from dqgp_tpu_torch.ops import cuda_circuit as K

    with open(SCALE_OUT_FIXTURE) as f:
        fixture = json.load(f)
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_out_") as out_dir:
        for name, flags in SCALE_OUT_RUNS.items():
            ref = fixture["runs"][name]
            check(ref["flags"] == flags, f"run {name}'s flags differ from the fixture's")
            K.reset_launch_counts()
            with contextlib.ExitStack() as patches:
                plain = {n: patches.enter_context(mock.patch.object(K, n, wraps=getattr(K, n)))
                         for n in PLAIN_ENGINES}
                summary, stages, split, wall = run_port_cli(
                    flags + ["--device", str(dev)], os.path.join(out_dir, f"run_{name}.log"))
            counts = {k: v for k, v in K.launch_counts().items() if v}
            want = {"K3": scale_out_launches_expected(summary, scale_out_spec(flags).num_parameters)}
            check(counts == want, f"run {name}: launches {counts}, want {want} and no other kernel")
            plain = {n: m.call_count for n, m in plain.items() if m.call_count}
            check(not plain, f"run {name} reached a plain engine on the card: {plain}")
            with open(os.path.join(out_dir, f"run_{name}.log")) as f:
                check("low-rank eigenvalue clip" in f.read(),
                      f"run {name} did not log the clip on the CG route")
            dev_ = hold_scale_out_run(name, summary, split, ref)
            t0 = time.time()
            at_z = scale_out_at_reference_z(flags, split, ref, dev)
            report[name] = {"stages_s": stages, "wall_s": wall, "launches": counts,
                            "deviations": dev_, "at_jax_z": at_z,
                            "at_jax_z_s": time.time() - t0,
                            "test_nlpd": summary["test_metrics"]["nlpd"],
                            "jax_test_nlpd": ref["summary"]["test_metrics"]["nlpd"],
                            "jax_cpu_s": ref["seconds_cpu"]}
    return report


def config7_cg_reference(dev) -> dict:
    """Phase 11b's problem, 2 iterations and its CG posterior on the first
    C7_TEST_ROWS test rows (for ``--scale-out``, which runs without 11b)."""
    import torch

    from dqgp_tpu_torch.driver import train
    from dqgp_tpu_torch.parallel import blocked as BL

    spec = config7_spec()
    X_tr, Y_tr, X_te, Y_te, splits = config7_problem(C7_SAMPLES, C7_AGENTS)
    cfg = config7_train_config(C7_ITERS, verbose=False)
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    z = torch.as_tensor(res.z, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    predict = BL.make_cg_predictor(spec, X_tr, Y_tr, z, cfg.noise_std, device=dev)
    ev[1].record()
    mean, var = predict(X_te[:C7_TEST_ROWS])
    ev[2].record()
    torch.cuda.synchronize()
    return {"X_tr": X_tr, "Y_tr": Y_tr, "X_te": X_te, "Y_te": Y_te, "z": z, "mean": mean,
            "var": var, "setup_ms": ev[0].elapsed_time(ev[1]),
            "predict_ms": ev[1].elapsed_time(ev[2]),
            "alpha_iterations": predict.alpha_result.iterations}


def factor_phase(dev, c7) -> dict:
    """18c and 18d on K3's features at 11b's z: the Gram-free float64
    factor of all training rows, the posterior of all test rows from it
    against 11b's CG; then ``nll_large`` on NLL_LARGE_ROWS rows in float64
    against a dense float64 factor, and in float32."""
    import torch

    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.models.kernels.quantum_kernel import (
        gram_from_features, kernel_features)
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.parallel import blocked as BL

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    spec, noise = config7_spec(), 0.1
    X_tr, Y_tr, X_te, Y_te, z = (c7[k] for k in ("X_tr", "Y_tr", "X_te", "Y_te", "z"))
    n, m = len(X_tr), len(X_te)
    K.reset_launch_counts()
    F32 = kernel_features(spec, torch.as_tensor(X_tr, device=dev).to(torch.float32), z)
    F_te = kernel_features(spec, torch.as_tensor(X_te, device=dev).to(torch.float32),
                           z).to(torch.float64)
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    check(counts == {"K3": 2}, f"18c launches {counts}: want K3 = 2 (train and test rows)")
    F64 = F32.to(torch.float64)
    y = torch.as_tensor(Y_tr, device=dev)
    report = {"launches": counts}

    # 18c: the factor of all training rows
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (L, logdet), factor_s = timed(lambda: BL.gram_free_blocked_cholesky(
        spec, F64, noise, block=1024, dtype=torch.float64))
    peak = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(logdet)), f"18c factor: logdet {float(logdet)}")
    report["factor"] = {"rows": n, "n_pad": L.shape[0], "s": factor_s, "logdet": float(logdet),
                        "peak_gb": peak / 1e9, "factor_gb": L.numel() * 8 / 1e9,
                        "flops": n ** 3 / 3}

    # 18d: the posterior from the factor
    def solves():
        y_pad = torch.zeros((L.shape[0], 1), dtype=torch.float64, device=dev)
        y_pad[:n, 0] = y
        w = torch.linalg.solve_triangular(L, y_pad, upper=False)
        return torch.linalg.solve_triangular(L.T, w, upper=True)[:n, 0]

    alpha, solve_s = timed(solves)

    def predictions():
        means, vars_ = [], []
        for s in range(0, m, 1024):
            Kts = gram_from_features(spec, F64, F_te[s:s + 1024])          # (n, chunk)
            means.append(Kts.T @ alpha)
            Kp = torch.zeros((L.shape[0], Kts.shape[1]), dtype=torch.float64, device=dev)
            Kp[:n] = Kts
            V = torch.linalg.solve_triangular(L, Kp, upper=False)
            kdiag = BL._k_diag(spec, F_te[s:s + 1024], torch.float64)
            vars_.append(torch.clamp(kdiag - torch.sum(V * V, dim=0), min=1e-10))
            del Kts, Kp, V
        return torch.cat(means), torch.cat(vars_)

    (mean, var), predict_s = timed(predictions)
    del L
    torch.cuda.empty_cache()
    check(mean.shape == (m,) and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(var).all()), "18d: non-finite posterior from the factor")
    mr = _allclose(mean[:C7_TEST_ROWS].cpu(), c7["mean"].cpu(), CG_MEAN_RTOL, CG_ATOL)
    vr = _allclose(var[:C7_TEST_ROWS].cpu(), c7["var"].cpu(), CG_VAR_RTOL, CG_ATOL)
    metrics = evaluate_predictions(Y_te, mean, var)
    report["posterior"] = {
        "test_rows": m, "solves_s": solve_s, "predict_s": predict_s,
        "factor_route_s": factor_s + solve_s + predict_s,
        "cg_setup_s": c7["setup_ms"] / 1e3, "cg_predict_512_s": c7["predict_ms"] / 1e3,
        "cg_alpha_iterations": c7["alpha_iterations"],
        "mean_over_bar_vs_cg": mr, "var_over_bar_vs_cg": vr,
        **{k: metrics[k] for k in ("nlpd", "r2", "rmse", "coverage_1sigma", "coverage_2sigma")
           if k in metrics}}
    check(mr <= 1.0 and vr <= 1.0, f"18d: the factor's posterior vs 11b's CG: mean "
                                   f"{mr}, variance {vr} of the bars")

    # 18c: nll_large on NLL_LARGE_ROWS rows, float64 and float32, vs a dense factor
    rows = NLL_LARGE_ROWS
    torch.cuda.reset_peak_memory_stats()
    (nll, comps), nll_s = timed(lambda: BL.nll_large(spec, F64[:rows], y[:rows], noise,
                                                     block=1024, dtype=torch.float64))
    nll_peak = torch.cuda.max_memory_allocated() - base

    def dense_nll():
        C = torch.empty((rows, rows), dtype=torch.float64, device=dev)
        for s in range(0, rows, 4096):
            C[s:s + 4096] = gram_from_features(spec, F64[s:min(s + 4096, rows)], F64[:rows])
        C.diagonal().add_(noise ** 2)
        Lc = torch.linalg.cholesky(C)
        del C
        alpha_d = torch.cholesky_solve(y[:rows, None], Lc)[:, 0]
        ld = 2.0 * torch.sum(torch.log(torch.diagonal(Lc)))
        return 0.5 * ld + 0.5 * torch.sum(y[:rows] * alpha_d) + 0.5 * rows * np.log(2 * np.pi)

    ref, dense_s = timed(dense_nll)
    torch.cuda.empty_cache()
    rel = abs(float(nll) / float(ref) - 1)
    (nll32, _), nll32_s = timed(lambda: BL.nll_large(spec, F32[:rows], y[:rows].float(), noise,
                                                     block=1024))
    rel32 = abs(float(nll32) / float(nll) - 1)
    report["nll_large"] = {"rows": rows, "nll": float(nll), "dense_nll": float(ref),
                           "rel_dev": rel, "rtol": NLL_LARGE_RTOL, "s": nll_s,
                           "dense_s": dense_s, "peak_gb": nll_peak / 1e9,
                           "terms": {k: float(v) for k, v in comps.items()},
                           "float32_nll": float(nll32), "float32_rel_dev": rel32,
                           "float32_s": nll32_s}
    check(rel <= NLL_LARGE_RTOL, f"18c nll_large {float(nll)} vs dense {float(ref)}: rel {rel}")
    check(np.isfinite(float(nll32)), f"18c float32 nll_large {float(nll32)}")
    return report


def example_phase(dev, N: int) -> dict:
    """18e: ``dqgp_tpu_torch.examples.scale_out_50k.run(N)`` on the card."""
    import torch

    from dqgp_tpu_torch.examples import scale_out_50k
    from dqgp_tpu_torch.ops import cuda_circuit as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    r = scale_out_50k.run(N, dev, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in K.launch_counts().items() if v}
    check(counts == {"K3": 1}, f"example N={N}: launches {counts}, want K3 = 1")
    check(r["mean"].shape == (scale_out_50k.M,) and bool(torch.isfinite(r["mean"]).all())
          and bool(torch.isfinite(r["var"]).all()) and np.isfinite(r["nll"]),
          f"example N={N}: non-finite result")
    return {"N": N, "launches": counts, "wall_s": wall,
            **{k: r[k] for k in ("cg_iterations", "cg_residual", "cg_converged", "n_chol", "nll",
                                 "features_s", "posterior_s", "nll_s")}}


def full_clip(dev, c7) -> dict:
    """``--scale-out``: ``make_lowrank_regularizer`` on all of config #7's
    training rows at 11b's z, float64, as the CG predictor builds it."""
    import dataclasses

    import torch

    from dqgp_tpu_torch.models.kernels.quantum_kernel import kernel_features
    from dqgp_tpu_torch.parallel import blocked as BL

    spec = dataclasses.replace(config7_spec(), regularization="thresholding")
    F = kernel_features(spec, torch.as_tensor(c7["X_tr"], device=dev).to(torch.float32),
                        c7["z"]).to(torch.float64)
    calls = [0]

    def counted_matvec(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    real = BL.gram_matvec
    BL.gram_matvec = counted_matvec
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = BL.make_lowrank_regularizer(spec, F, block=4096, dtype=torch.float64)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        BL.gram_matvec = real
    check(bool(torch.isfinite(reg.lambda_min)), "the full-size clip's lambda_min is not finite")
    return {"rows": len(c7["X_tr"]), "s": secs, "matvecs": calls[0],
            "lambda_min": float(reg.lambda_min), "nonzero_w": int(torch.count_nonzero(reg.w)),
            "saturated": bool(reg.saturated)}


def scale_out_phase(dev, smi: str, c7, full: bool = False) -> dict:
    """Phase 18: 18a-e; with ``full``, also the example at EXAMPLE_FULL_N and
    the clip on all 49,999 rows. Prints the ``scale_out`` line; returns it."""
    import torch

    torch.cuda.empty_cache()
    t_phase = time.time()
    report = {"device": smi}
    t0 = time.time()
    report["clip"] = clip_phase(dev, c7)
    report["clip_s"] = time.time() - t0
    t0 = time.time()
    report["cli"] = scale_out_cli_phase(dev)
    report["cli_s"] = time.time() - t0
    print("phase 18b " + json.dumps(report["cli"], default=float), flush=True)
    t0 = time.time()
    report["factor"] = factor_phase(dev, c7)
    report["factor_phase_s"] = time.time() - t0
    print("phase 18c-d " + json.dumps(report["factor"], default=float), flush=True)
    t0 = time.time()
    report["example"] = example_phase(dev, EXAMPLE_N)
    report["example_s"] = time.time() - t0
    print("phase 18e " + json.dumps(report["example"], default=float), flush=True)
    if full:
        t0 = time.time()
        report["example_full"] = example_phase(dev, EXAMPLE_FULL_N)
        report["example_full_s"] = time.time() - t0
        print("phase 18 example at full size " + json.dumps(report["example_full"],
                                                            default=float), flush=True)
        report["clip_full"] = full_clip(dev, c7)
        print("phase 18 clip at full size " + json.dumps(report["clip_full"], default=float),
              flush=True)
    report["phase_s"] = time.time() - t_phase
    print(f"phase 18 scale-out ({report['phase_s']:.2f} s) [{smi}]", flush=True)
    return report


# --------------------------------------------------------------------------
# phase 19: 11 and 12 qubits
# --------------------------------------------------------------------------


def every_kind_circuit(n: int):
    """Every gate kind on the warp bits of an n-qubit state (n = 11, 12): each
    kind with its target on qubit 10 and on qubit n - 1 and, for the two-qubit
    kinds, its control on a warp bit over a register or a lane target, then
    the kinds again on seeded qubits. Its fused program has phase runs of RZ,
    CRZ, CZ and RZZ members on warp bits, which no circuit family has."""
    from dqgp_tpu_torch.ops.circuit import CX, Circuit, Gate

    rng = np.random.RandomState(n)
    pairs = [(10, 4), (n - 1, 8), (2, 10), (7, n - 1)] + ([(10, 11), (11, 10)] if n >= 12 else [])
    gates = [Gate(kind=kind, qubit=q, control=c if kind >= CX else -1)
             for kind in range(10) for q, c in pairs]
    for kind in list(range(10)) * 3:
        q = int(rng.randint(n))
        c = int((q + 1 + rng.randint(n - 1)) % n) if kind >= CX else -1
        gates.append(Gate(kind=kind, qubit=q, control=c))
    order = rng.permutation(len(gates))
    return Circuit(num_qubits=n, num_features=1, num_parameters=1,
                   gates=tuple(gates[i] for i in order), name="every_kind")


def check_wide_kernels(rand_angles, smi: str) -> dict:
    """Phase 19a: K3, K1 float32 and K1 float64 at 11 and 12 qubits (a
    sample's state across 2 and 4 warps) against their plain versions on the
    same CUDA tensors: chebyshev 2-D 2 layers, the random family (CZ, RZ and
    CRZ members) and ``every_kind_circuit``, at B = 1, 131 and the slice's
    batch (108,032 for K3 and K1 float32, the backfill's 13,504 for K1
    float64; the first WIDE_HELD_ROWS rows held there); the float64 angles
    hold F64_SPECIAL_ANGLES in every third place. Then each kernel at the
    slice's batch on chebyshev, in turns with its plain version (a call) and
    alone (the profiler), beside its bound. Returns the kernels' records."""
    import torch

    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.ops import cuda_circuit as K

    t0 = time.time()
    special = torch.tensor(F64_SPECIAL_ANGLES, dtype=torch.float64, device="cuda")
    kernels = {  # wrapper, plain version, bar, the slice's batch, float64
        "K3": (K.pauli_features_from_angles_fused, K.pauli_features_fused_reference, K1_TOL,
               C7_STEP_ROWS, False),
        "K1": (K.pauli_features_from_angles, K.pauli_features_reference, K1_TOL,
               C7_STEP_ROWS, False),
        "K1_f64": (K.pauli_features_from_angles, K.pauli_features_reference, F64_TOL,
                   C12_F64_ROWS, True)}

    def angles_for(name, circuit, B):
        f64 = kernels[name][4]
        a = rand_angles(circuit, B, torch.float64 if f64 else torch.float32)
        if f64:
            flat = a.view(-1)[::3]  # every third float64 angle a special one
            flat.copy_(special.repeat(flat.numel() // len(special) + 1)[:flat.numel()])
        return a

    err = dict.fromkeys(kernels, 0.0)
    k3_unfused, cases = 0.0, 0
    for n in WIDE_QUBITS:
        circuits = (build_circuit("chebyshev", n, 2, C7_LAYERS),
                    build_circuit("random", n, 2, C7_LAYERS), every_kind_circuit(n))
        for c in circuits:
            for name, (kernel, plain, tol, rows, f64) in kernels.items():
                for B in WIDE_BATCHES + (rows,):
                    a = angles_for(name, c, B)
                    got = kernel(c, a)
                    torch.cuda.synchronize()
                    check(got.shape == (B, 3 * n) and got.dtype == a.dtype,
                          f"{name} shape {tuple(got.shape)} {got.dtype}")
                    held, a_held = got[:WIDE_HELD_ROWS], a[:WIDE_HELD_ROWS]
                    e = float((held - plain(c, a_held)).abs().max())
                    check(np.isfinite(e) and e <= tol, f"{name} vs plain {c.name} {n}q B={B}: "
                                                       f"max abs diff {e} > {tol}")
                    err[name] = max(err[name], e)
                    if name == "K3":  # beside the plain unfused version, printed
                        u = float((held - K.pauli_features_reference(c, a_held)).abs().max())
                        k3_unfused = max(k3_unfused, u)
                    cases += 1
                    del a, got, held, a_held
    print(f"phase 19a K1 and K3 at {WIDE_QUBITS} qubits vs plain ({time.time() - t0:.2f} s): "
          f"{cases} cases (chebyshev, random, every gate kind on the warp bits; B = "
          f"{WIDE_BATCHES} and the slice's batch, its first {WIDE_HELD_ROWS} rows held); max "
          f"abs diff K3 {err['K3']:.3e} (tol {K1_TOL}; {k3_unfused:.3e} vs the plain unfused "
          f"version), K1 float32 {err['K1']:.3e} (tol {K1_TOL}), K1 float64 "
          f"{err['K1_f64']:.3e} (tol {F64_TOL}, the float64 angles hold "
          f"{', '.join(f'{v:g}' for v in F64_SPECIAL_ANGLES)} in every third place)", flush=True)

    t0 = time.time()
    times = {}
    for n in WIDE_QUBITS:
        c = config7_spec(n).circuit
        for name, (kernel, plain, _, rows, f64) in kernels.items():
            a = angles_for(name, c, rows)
            ms, plain_ms = _alternate_ms([lambda: kernel(c, a), lambda: plain(c, a)], 2)
            device_ms = _device_ms(lambda: kernel(c, a), 3, WARP_KERNELS[name])
            bound, bound_by = (k3_bound(c, rows) if name == "K3"
                               else k1_bound(c, rows, 8 if f64 else 4))
            times.setdefault(name, {})[n] = {
                "B": rows, "G": c.num_gates, "ms": ms, "plain_ms": plain_ms,
                "device_ms": device_ms, "bound_ms": bound, "bound_by": bound_by}
            del a
            torch.cuda.empty_cache()
    print(f"phase 19a times ({time.time() - t0:.2f} s) [{smi}]: chebyshev 2 layers, "
          + "; ".join(f"{name} n={n} B={t['B']} G={t['G']}: {t['ms']:.3f} ms a call, "
                      f"{t['device_ms']:.3f} alone, plain {t['plain_ms']:.1f} ms; bound "
                      f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
                      f"{t['bound_ms'] / t['device_ms']:.1%} of it alone"
                      for name, by_n in times.items() for n, t in by_n.items()), flush=True)
    out = {}
    for name in kernels:
        t = times[name][C12_QUBITS]
        out[name] = {"max_abs_err": err[name], **{k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "B")},
            "at_11_qubits": times[name][11]}
    out["K3"]["max_abs_err_vs_unfused"] = k3_unfused
    return out


def agent_nll_plain_f64(spec, splits, z, dev, noise_std: float) -> np.ndarray:
    """The agents' NLLs at z (P,) from float64 features through the plain
    complex128 engine (K1's plain version) on ``dev``: the Gram at wrap(z),
    then the masked float64 NLL, as the streamed step forms them."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.models.gp.posterior import masked_nll_core
    from dqgp_tpu_torch.models.kernels import quantum_kernel as QK
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops.statevector import angle_matrix
    from dqgp_tpu_torch.parallel.consensus import make_agent_batch

    batch = make_agent_batch(splits, dev)
    zw = M.wrap(torch.as_tensor(np.asarray(z), dtype=torch.float64, device=dev))
    angles = angle_matrix(spec.circuit, batch.X, zw, torch.float64)  # (A, N, G)
    saved = QK.pauli_features_from_angles
    QK.pauli_features_from_angles = K.pauli_features_reference
    try:
        flat = QK.features_from_angles(spec, angles.reshape(-1, angles.shape[-1]))
    finally:
        QK.pauli_features_from_angles = saved
    gram = QK.gram_from_features(spec, flat.reshape(*angles.shape[:-1], flat.shape[-1]))
    res, _ = masked_nll_core(gram, batch.Y.to(torch.float64), batch.mask.to(torch.float64),
                             noise_std, compute_cond=False)
    return res.nll.cpu().numpy()


def config7_wide_phase(dev, smi: str, full, ref) -> dict:
    """Phase 19b: config #7 at 12 qubits, full width (``full``: 11b's 49,999
    rows over 64 agents; chebyshev 12 qubits / 2 layers, P = 84), 2 streamed
    iterations with the CLI's condition numbers (compute_cond=True, cond_mode
    "auto" = host): K3 once at wrap(z) and once a parameter a step and once a
    CV pass, K1 float64 once an agent and 16-row chunk in the backfill, no
    other kernel and no plain engine; iteration 1's agent NLLs of two agents
    whose rows lie inside the encoding's arccos domain against the same NLLs
    from the plain float64 engine, within config #7's NLL bar at 12 qubits
    (the fixture's first iteration: max(1e-4, 2 x JAX's own spread)). Then
    its times: a step and a CV pass (CUDA events), the backfill of the run's
    z rows, peak memory; and one iteration with fusion off, K1 float32 in
    K3's place."""
    import contextlib
    from unittest import mock

    import torch

    from dqgp_tpu_torch import config
    from dqgp_tpu_torch.driver import host_condition_numbers, resolve_cond_mode, train
    from dqgp_tpu_torch.models.gp.cv import cv_fold_scores_impl, kfold_pad_indices
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.parallel.consensus import make_admm_step, make_agent_batch

    X_tr, Y_tr, splits = full
    spec = config7_spec(C12_QUBITS)
    P = spec.num_parameters
    check((spec.circuit.num_gates, P) == (84, 84), "config #7 at 12 qubits is not G = P = 84")
    cfg = config7_train_config(C7_ITERS, compute_cond=True, cond_mode="auto", verbose=False)
    check(resolve_cond_mode(cfg, dev) == "host", "cond_mode auto does not resolve to host")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.time()
    with contextlib.ExitStack() as patches:
        plain = {n: patches.enter_context(mock.patch.object(K, n, wraps=getattr(K, n)))
                 for n in PLAIN_ENGINES}
        res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
        torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = K.launch_counts()
    wide = K.wide_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    plain = {n: m.call_count for n, m in plain.items() if m.call_count}
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    want_k3 = C7_ITERS * (1 + P) + C7_ITERS + rescores
    want_f64 = backfill_launches(C7_ITERS, C7_AGENTS)
    eig = backfill_eig_counts(C7_ITERS, [len(x) for x, _ in splits])
    check(counts["K3"] == want_k3 and counts["K1_f64"] == want_f64 and counts_hold(counts, eig)
          and sum(counts.values()) == want_k3 + want_f64 + sum(eig.values()),
          f"config #7 at 12 qubits launches {counts}: want K3 = {C7_ITERS}*(1+{P}) + "
          f"{C7_ITERS} + {rescores}, K1_f64 = {want_f64} and {eig} (the backfill), no other "
          f"kernel")
    check(wide == {"K1": 0, "K1_f64": want_f64, "K3": want_k3},
          f"config #7 at 12 qubits counts wide launches {wide}: want every K3 and K1_f64 "
          f"launch ({want_k3}, {want_f64})")
    check(not plain, f"config #7 at 12 qubits reached a plain engine on the card: {plain}")
    host = np.array([h["condition_numbers"] for h in res.nll_history])
    check(host.shape == (C7_ITERS, C7_AGENTS) and not bool(np.isnan(host).any()),
          f"the backfill left a condition number out: {host.shape}")
    check(np.all(np.isfinite(res.z)) and all(np.all(np.isfinite(h["agent_losses"]))
                                             for h in res.nll_history),
          "non-finite z or agent NLL at 12 qubits")
    # two agents whose rows all lie inside arccos's domain [-1, 1]^2: the
    # encoding clips x, so at the agents wholly outside it (0, 1, 6-9, ...)
    # every row has the same features, the Gram is all ones and the NLL does
    # not see them
    held = [i for i, (x, _) in enumerate(splits) if np.all(np.abs(x) <= 1)][:2]
    z1 = res.cv_history[0]["consensus_params"]
    own = np.asarray(res.nll_history[0]["agent_losses"])[held]
    held_splits = [splits[i] for i in held]
    plain_nll = agent_nll_plain_f64(spec, held_splits, z1, dev, cfg.noise_std)
    nll_rel = float((np.abs(own - plain_nll) / np.abs(plain_nll)).max())
    # beside them, the same NLLs from K3's features outside the step
    k3_nll = config7_agent_nll_at(spec, held_splits, [z1], dev, cfg.noise_std)[0]
    nll_bar = float(config7_nll_bars(ref)[0])

    # times (not the main path's launches: the counts were read above)
    step = make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                          compute_cond=False, grad_method="streamed")
    batch = make_agent_batch(splits, dev)
    theta, psi = torch.as_tensor(res.theta, device=dev), torch.as_tensor(res.psi, device=dev)
    sel = np.random.RandomState(cfg.seed).choice(len(X_tr), C7_CV_MAX, replace=False)
    Xc, Yc = torch.as_tensor(X_tr[sel], device=dev), torch.as_tensor(Y_tr[sel], device=dev)
    folds = kfold_pad_indices(C7_CV_MAX, cfg.cv_folds, cfg.seed, dev)
    out = step(theta, psi, batch)
    step_ms = _cuda_time_ms(lambda: step(theta, psi, batch), 1)
    cv_ms = _cuda_time_ms(lambda: cv_fold_scores_impl(spec, Xc, Yc, out.z, *folds,
                                                      noise_std=cfg.noise_std), 3)
    rows = np.array([h["consensus_params"] for h in res.cv_history])
    backfill_ms = _cuda_time_ms(lambda: host_condition_numbers(spec, splits, rows, device=dev), 1)
    del out, batch
    torch.cuda.empty_cache()

    # fusion off: K1 float32 in K3's place, one iteration
    config.use_fusion = "off"
    try:
        K.reset_launch_counts()
        t1 = time.time()
        off = train(spec, splits, X_tr, Y_tr, config7_train_config(1, verbose=False), device=dev)
        torch.cuda.synchronize()
        off_s = time.time() - t1
        off_counts = K.launch_counts()
        off_wide = K.wide_launch_counts()
    finally:
        config.use_fusion = "auto"
    off_rescores = sum(h["solver"] == "float64-rescue" for h in off.cv_history)
    want_k1 = (1 + P) + 1 + off_rescores
    check(off_counts["K1"] == want_k1 and sum(off_counts.values()) == want_k1,
          f"config #7 at 12 qubits with fusion off launches {off_counts}: want K1 = 1 + {P} + "
          f"1 + {off_rescores} and no other kernel")
    check(off_wide == {"K1": want_k1, "K1_f64": 0, "K3": 0},
          f"config #7 at 12 qubits with fusion off counts wide launches {off_wide}: want "
          f"K1 = {want_k1}")
    off_rel = abs(off.nll_history[0]["total_nll"] / res.nll_history[0]["total_nll"] - 1)
    print(f"phase 19b config #7 at 12 qubits ({time.time() - t0:.2f} s) [{smi}]: {len(X_tr)} "
          f"train rows over {C7_AGENTS} agents, chebyshev {C12_QUBITS} qubits / {C7_LAYERS} "
          f"layers (P = {P}), {C7_ITERS} streamed iterations with compute_cond=True, cond_mode "
          f"auto = host, in {train_s:.2f} s (peak allocated {peak:.2f} GiB); launches {counts} "
          f"(K3 = {want_k3}, K1_f64 = {want_f64}), wide {wide}, no plain engine; nll_sum "
          f"{[round(h['total_nll'], 4) for h in res.nll_history]}, CV-NLPD "
          f"{[round(h['consensus_cv_score'], 4) for h in res.cv_history]}; iteration 1's "
          f"agent NLLs of agents {held} {own.tolist()} vs the plain float64 engine's "
          f"{plain_nll.tolist()}: rel dev {nll_rel:.2e} (bar {nll_bar:.2e}; K3's features "
          f"outside the step: {k3_nll.tolist()}); a step {step_ms:.1f} ms, a CV pass "
          f"{cv_ms:.2f} ms, the backfill of {len(rows)} z rows {backfill_ms:.1f} ms; fusion "
          f"off (K1 float32): 1 iteration in "
          f"{off_s:.2f} s, launches {off_counts}, iteration 1 nll_sum rel dev from K3's "
          f"{off_rel:.2e}", flush=True)
    check(nll_rel <= nll_bar, f"config #7 at 12 qubits: agent NLLs {own} vs the plain float64 "
                              f"engine's {plain_nll}: rel dev {nll_rel} > {nll_bar}")
    return {"train_s": train_s, "launches": counts, "peak_gib": peak, "step_ms": step_ms,
            "cv_ms": cv_ms, "backfill_ms": backfill_ms, "agent_nll_rel_dev": nll_rel,
            "agent_nll": own.tolist(), "agent_nll_plain_f64": plain_nll.tolist(),
            "agent_nll_bar": nll_bar, "agent_nll_held_agents": held,
            "nll_sum": [h["total_nll"] for h in res.nll_history],
            "fusion_off": {"s": off_s, "launches": off_counts, "nll_sum_rel_dev": off_rel}}


def config7_wide_fixture_phase(dev, ref) -> dict:
    """Phase 19c, the fixture problem: config #7's fixture problem (phase
    11a's data, 999 rows over 8 agents) at 12 qubits for C12_FIX_ITERS
    iterations and its CG posterior, held to the 12-qubit fixture as 11a
    holds the 10-qubit one: z within 5e-3, agent NLLs at JAX's own z within
    ``config7_nll_bars``, CV and test NLPD within max(0.05, 2 |JAX f32 - JAX
    f64|); K3's exact launches and no other kernel."""
    import torch

    from dqgp_tpu_torch.data import generate_data_numpy
    from dqgp_tpu_torch.driver import train
    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.parallel import blocked as BL

    t0 = time.time()
    spec = config7_spec(C12_QUBITS)
    P = spec.num_parameters
    X, Y = generate_data_numpy(C12_FIX_SAMPLES, 2, 0.1, C7_SEED)
    check(array_digest(X) == ref["problem"]["x_sha256"]
          and array_digest(Y) == ref["problem"]["y_sha256"]
          and ref["problem"]["num_qubits"] == C12_QUBITS, "12-qubit fixture dataset differs")
    X_tr, Y_tr, X_te, Y_te, splits = config7_problem(C12_FIX_SAMPLES, C12_FIX_AGENTS)
    check([len(x) for x, _ in splits] == ref["problem"]["shard_sizes"], "shard sizes differ")
    cfg = config7_train_config(C12_FIX_ITERS, verbose=False)
    K.reset_launch_counts()
    res = train(spec, splits, X_tr, Y_tr, cfg, device=dev)
    predict = BL.make_cg_predictor(spec, X_tr, Y_tr, torch.as_tensor(res.z, device=dev),
                                   cfg.noise_std, device=dev)
    mean, var = predict(X_te)
    metrics = evaluate_predictions(Y_te, mean, var)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    want_k3 = C12_FIX_ITERS * (P + 2) + rescores + 2
    check(counts["K3"] == want_k3 and sum(counts.values()) == counts["K3"],
          f"12-qubit fixture launches {counts}: want K3 = {C12_FIX_ITERS}*({P}+2) + "
          f"{rescores} + 2 and no other kernel")
    nll_at_ref = config7_agent_nll_at(spec, splits, ref["z_trajectory"][:C12_FIX_ITERS], dev,
                                      cfg.noise_std)
    z = np.array([h["consensus_params"] for h in res.cv_history])
    z_devs = np.abs(z - np.array(ref["z_trajectory"])).max(axis=1)
    print(f"phase 19c 12-qubit fixture problem: z dev by iteration "
          f"{[f'{d:.1e}' for d in z_devs]}", flush=True)
    z_dev, nll_dev, cv_ratio, t_ratio = check_config7_fixture(res, metrics, ref, C12_FIX_ITERS,
                                                              nll_at_ref)
    report = {"s": time.time() - t0, "launches": counts, "z_dev": z_dev,
              "z_dev_by_iteration": z_devs.tolist(), "agent_nll_rel_dev_at_jax_z": nll_dev,
              "agent_nll_bars": config7_nll_bars(ref).tolist(), "cv_nlpd_over_bar": cv_ratio,
              "test_nlpd_over_bar": t_ratio, "test_nlpd": metrics["nlpd"],
              "jax_test_nlpd": ref["test_metrics"]["nlpd"], "jax_cpu_s": ref["seconds_cpu"]}
    print("phase 19c fixture " + json.dumps(report, default=float), flush=True)
    return report


def run_e_at_reference_z(flags, split, ref, device) -> dict:
    """Run E's noise fit and CG route at JAX's own selected z (the fixture's
    ``best_cv_z``) on the CLI's split, as the CLI predicts: the fitted sigma
    within SIGMA_RTOL of JAX's; with JAX's sigma the test and
    train-subsample NLPD within ``scale_out_nlpd_bar`` of JAX's, and the CG
    mean and variance on the test rows against the dense float64 posterior
    (CG_MEAN_RTOL / CG_VAR_RTOL, CG_ATOL)."""
    import torch

    from dqgp_tpu_torch.models.gp import evaluate_predictions, fit_noise_std, predict_quantum_gp
    from dqgp_tpu_torch.parallel import blocked as BL

    want = ref["summary"]
    X_tr, X_te, Y_tr, Y_te = split
    spec = config7_spec(int(flags[flags.index("--num-qubits") + 1]))
    z = np.asarray(want["best_cv_z"], np.float64)
    sigma = want["noise_fit"]["fitted_noise_std"]
    fit = fit_noise_std(spec, X_tr, Y_tr, z, current_noise_std=want["config"]["noise_std"],
                        device=device)
    out = {"sigma_rel": abs(fit.noise_std / sigma - 1)}
    check(out["sigma_rel"] <= SIGMA_RTOL, f"run E at JAX's z: fitted sigma {fit.noise_std} vs "
                                          f"JAX's {sigma} beyond rtol {SIGMA_RTOL}")
    X_t, Y_t = torch.as_tensor(X_tr, device=device), torch.as_tensor(Y_tr, device=device)
    z_t = torch.as_tensor(z, device=device)
    predict = BL.make_cg_predictor(spec, X_t, Y_t, z_t, sigma, device=device)
    threshold = int(flags[flags.index("--predict-cg-threshold") + 1])
    sub_n = min(len(X_tr), max(threshold, 1024))
    sel = np.random.RandomState(want["config"]["seed"]).choice(len(X_tr), sub_n, replace=False)
    mean = None
    for part, X, Y in (("test", X_te, Y_te), ("train", X_tr[sel], Y_tr[sel])):
        m, v = predict(X)
        got = evaluate_predictions(Y, m, v)["nlpd"]
        bar = scale_out_nlpd_bar(ref, part)
        out[f"{part}_nlpd"], out[f"{part}_nlpd_bar"] = got - want[f"{part}_metrics"]["nlpd"], bar
        check(abs(out[f"{part}_nlpd"]) <= bar,
              f"run E at JAX's z: {part} NLPD {got} vs JAX's {want[f'{part}_metrics']['nlpd']} "
              f"beyond {bar}")
        if mean is None:
            mean, var = m, v
    m_d, v_d = predict_quantum_gp(spec, X_t, Y_t, torch.as_tensor(X_te, device=device), z_t,
                                  noise_std=sigma)
    out["dense_test_nlpd"] = (evaluate_predictions(Y_te, m_d, v_d)["nlpd"]
                              - ref["nlpd_at_z"]["test_nlpd_dense"])
    out["cg_mean_over_bar"] = _allclose(mean.cpu(), m_d.cpu(), CG_MEAN_RTOL, CG_ATOL)
    out["cg_var_over_bar"] = _allclose(var.cpu(), v_d.cpu(), CG_VAR_RTOL, CG_ATOL)
    check(out["cg_mean_over_bar"] <= 1.0 and out["cg_var_over_bar"] <= 1.0,
          f"run E at JAX's z: the CG route disagrees with the dense posterior: {out}")
    return out


def run_e_launches_expected(summary, num_parameters: int, sizes) -> dict:
    """Run E's launches: K3 as in runs C and D; K1 float64 once an agent and
    16 z rows in the backfill and once in the noise fit; and the backfill's
    eigenvalue counts over agents of ``sizes`` rows."""
    return {"K3": scale_out_launches_expected(summary, num_parameters),
            "K1_f64": backfill_launches(summary["iterations"], summary["config"]["n_agents"]) + 1,
            **nonzero(backfill_eig_counts(summary["iterations"], sizes))}


def run_e_phase(dev, ref) -> dict:
    """Phase 19c, run E: the port's CLI on RUN_E_FLAGS (config #7's CLI flags
    at 12 qubits with the condition numbers and the noise fit, on the CG
    route) against the JAX CLI's run (the fixture's ``run_e``), at run C's
    bars: the dataset (X exact, Y within SCALE_OUT_Y_TOL), the summary's
    keys and stop, z and CV-NLPD over SCALE_OUT_HELD_ITERS, the condition
    numbers' buckets, and at JAX's z the fitted sigma and the NLPDs
    (``run_e_at_reference_z``); the launches exactly and no plain engine."""
    import contextlib
    from unittest import mock

    from dqgp_tpu_torch.ops import cuda_circuit as K

    check(ref["flags"] == RUN_E_FLAGS + ["--cond-mode", "host"],
          "run E's flags differ from the fixture's")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_e_") as out_dir:
        K.reset_launch_counts()
        with contextlib.ExitStack() as patches:
            plain = {n: patches.enter_context(mock.patch.object(K, n, wraps=getattr(K, n)))
                     for n in PLAIN_ENGINES}
            summary, stages, split, wall = run_port_cli(
                RUN_E_FLAGS + ["--device", str(dev)], os.path.join(out_dir, "run_E.log"))
        sizes = agent_rows(os.path.join(out_dir, "run_E.log"))
    check(len(sizes) == summary["config"]["n_agents"], f"run E's log lists {len(sizes)} agents")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    want = run_e_launches_expected(summary, config7_spec(C12_QUBITS).num_parameters, sizes)
    check(counts == want, f"run E: launches {counts}, want {want} and no other kernel")
    plain = {n: m.call_count for n, m in plain.items() if m.call_count}
    check(not plain, f"run E reached a plain engine on the card: {plain}")
    dev_ = hold_scale_out_run("E", summary, split, ref)
    check(_cond_buckets(summary) == _cond_buckets(ref["summary"]),
          f"run E: host condition numbers "
          f"{[h['condition_numbers'] for h in summary['nll_history']]} not in JAX's buckets")
    t0 = time.time()
    at_z = run_e_at_reference_z(RUN_E_FLAGS, split, ref, dev)
    report = {"stages_s": stages, "wall_s": wall, "launches": counts, "deviations": dev_,
              "at_jax_z": at_z, "at_jax_z_s": time.time() - t0,
              "sigma": summary["noise_fit"]["fitted_noise_std"],
              "jax_sigma": ref["summary"]["noise_fit"]["fitted_noise_std"],
              "test_nlpd": summary["test_metrics"]["nlpd"],
              "jax_test_nlpd": ref["summary"]["test_metrics"]["nlpd"],
              "jax_cpu_s": ref["seconds_cpu"]}
    print("phase 19c run E " + json.dumps(report, default=float), flush=True)
    return report


def wide_phase(dev, smi: str, rand_angles, full=None) -> dict:
    """Phase 19: 19a, 19b (on ``full``, 11b's problem, or the same made anew)
    and 19c. Returns the kernels' records and the phases' reports."""
    import torch

    torch.cuda.empty_cache()
    t_phase = time.time()
    with open(Q12_FIXTURE) as f:
        fixture = json.load(f)
    kernels = check_wide_kernels(rand_angles, smi)
    if full is None:
        X_tr, Y_tr, _, _, splits = config7_problem(C7_SAMPLES, C7_AGENTS)
        full = (X_tr, Y_tr, splits)
    c12 = config7_wide_phase(dev, smi, full, fixture["fixture"])
    fix = config7_wide_fixture_phase(dev, fixture["fixture"])
    run_e = run_e_phase(dev, fixture["run_e"])
    print(f"phase 19 11 and 12 qubits ({time.time() - t_phase:.2f} s) [{smi}]", flush=True)
    return {"kernels": kernels, "config7": c12, "fixture": fix, "run_e": run_e}


# the batched eigenvalue kernel, as ptxas and the profiler name it
EIG_ENTRY = "gram_extremes_kernel"


def eig_ptxas(log: str) -> tuple:
    """(registers, stack B, spill stores B, spill loads B) of the batched
    eigenvalue kernel in ptxas -v's report; None where the build was reused."""
    frame = None
    for ln in log.splitlines():
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and frame is not None:
            return (int(m.group(1)),) + frame
    return None


def eig_phase(dev, smi: str) -> dict:
    """Phase 20: the batched eigenvalue kernel (ops/cuda_eig.py) on one
    backfill chunk of the north star (16 z rows x 4 agents: 64 Grams of
    238-260 rows), held to eigvalsh (the present path, an agent a call) and
    timed against it in turns with CUDA events, then alone (the profiler);
    its bound is 4n^3/3 operations a Gram at the card's FP64 rate. Then the
    whole backfill of a 100-iteration fit (7 chunks) both ways, and a Gram
    and a z row with a NaN."""
    import torch

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.driver import host_condition_numbers
    from dqgp_tpu_torch.models.kernels.quantum_kernel import grams_at_rows
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops import cuda_eig as E

    t0 = time.time()
    X, Y, X_test, Y_test, splits = northstar_splits()
    spec = northstar_spec()
    with open(FIXTURE) as f:
        Z = np.array(json.load(f)["z_trajectory"])
    rng = np.random.RandomState(20)
    rows = Z[rng.randint(len(Z), size=EIG_FIT_ROWS)] + rng.uniform(-0.05, 0.05, (EIG_FIT_ROWS,
                                                                                Z.shape[1]))
    zw = M.wrap(torch.as_tensor(rows[:16], device=dev))
    grams = [grams_at_rows(spec, torch.as_tensor(X_i, device=dev), zw) for X_i, _ in splits]
    sizes = [g.shape[1] for g in grams]
    K.reset_launch_counts()
    got = E.gram_extremes(grams)
    counts = K.launch_counts()
    check(counts["eig"] == 1 and counts["eig_grams"] == 64,
          f"one launch for the chunk's 64 Grams, got {counts}")
    want = torch.cat([E.gram_extremes_reference(g) for g in grams])
    tiny = torch.finfo(torch.float64).tiny
    cg, cw = [(w[:, 0] / torch.clamp(w[:, 1], min=tiny)).cpu().numpy() for w in (got, want)]
    rel = hold_host_cond(cg, cw, "the chunk's condition numbers, kernel vs eigvalsh")
    # each end on its own: max|w| relative, min|w| as a share of n * eps *
    # max|w| (both backward stable on the same float64 Gram), which holds the
    # small end where the condition number is above 1e8 and the bucket does not
    big = float(((got[:, 0] - want[:, 0]).abs() / want[:, 0]).max())
    n_rows = torch.tensor([g.shape[1] for g in grams for _ in range(g.shape[0])],
                          dtype=torch.float64, device=dev)
    small = float(((got[:, 1] - want[:, 1]).abs()
                   / (n_rows * torch.finfo(torch.float64).eps * want[:, 0])).max())
    check(big <= EIG_MAX_RTOL and small <= 1.0,
          f"the chunk's extremes, kernel vs eigvalsh: max|w| rel dev {big:.2e} (bar "
          f"{EIG_MAX_RTOL}), min|w| dev {small:.3f} of n * eps * max|w| (bar 1)")

    kernel = lambda: E.gram_extremes(grams)  # noqa: E731
    plain = lambda: [E.gram_extremes_reference(g) for g in grams]  # noqa: E731
    ms, plain_ms = _alternate_ms([kernel, plain], EIG_REPS)
    alone = _device_ms(kernel, EIG_REPS, EIG_ENTRY)
    ops = sum(g.shape[0] * 4 * g.shape[1] ** 3 / 3 for g in grams)
    bound = ops / FP64_OPS_PER_S * 1e3
    C = E.cluster_size(max(sizes))
    clusters = E._library().dqgp_gram_extremes_max_clusters(C, E.smem_bytes(max(sizes), C))

    # the backfill of a 100-iteration fit (7 chunks) through the kernel and
    # through eigvalsh (no n under the kernel's limit); then a z row with a
    # NaN, on which the kernel reads NaN and eigvalsh raises: the backfill
    # raises both ways
    real_max = E.MAX_N

    def backfill(max_n, z_rows=rows):
        E.MAX_N = max_n
        try:
            return host_condition_numbers(spec, splits, z_rows, device=dev)
        finally:
            E.MAX_N = real_max

    # the counts read from the main path's own backfill of the fit
    K.reset_launch_counts()
    fit_got = backfill(real_max)
    fit_counts = {k: v for k, v in K.launch_counts().items() if k.startswith("eig")}
    fit_want = backfill_eig_counts(EIG_FIT_ROWS, [len(x) for x, _ in splits])
    check(fit_counts == fit_want,
          f"the fit's backfill counted {fit_counts}: want {fit_want}")
    fit_rel = hold_host_cond(fit_got, backfill(0), "the fit's backfill, kernel vs eigvalsh")
    fit_ms, fit_plain_ms = _alternate_ms([lambda: backfill(real_max), lambda: backfill(0)], 1)

    def outcome(fn):
        try:
            return str(np.asarray(fn()).tolist())
        except torch.linalg.LinAlgError as exc:
            return f"raises {type(exc).__name__}"

    nan_gram = grams[0][:1].clone()
    nan_gram[0, 3, 1] = nan_gram[0, 1, 3] = float("nan")
    nan_kernel = outcome(lambda: E.gram_extremes([nan_gram]).cpu())
    nan_eigvalsh = outcome(lambda: E.gram_extremes_reference(nan_gram).cpu())
    nan_rows = rows[:2].copy()
    nan_rows[1, 3] = np.nan
    nan_backfill = [outcome(lambda: backfill(m, nan_rows)) for m in (real_max, 0)]
    check(nan_backfill[0] == nan_backfill[1],
          f"a NaN z row: the backfill through the kernel {nan_backfill[0]}, through "
          f"eigvalsh {nan_backfill[1]}")
    print(f"phase 20 batched eigenvalue kernel ({time.time() - t0:.2f} s) [{smi}]: one "
          f"north-star backfill chunk, 64 Grams of {sorted(set(sizes))} rows in clusters of "
          f"{C} ({E.smem_bytes(max(sizes), C)} B shared memory a block, {clusters} clusters "
          f"at once): {ms:.3f} ms a call (alone {alone:.3f}) vs eigvalsh an agent a call "
          f"{plain_ms:.3f} ms; bound {bound:.4f} ms ({ops:.3e} operations at FP64): "
          f"{bound / alone:.2%} of it alone; condition numbers vs eigvalsh: worst rel dev "
          f"{rel:.2e} (below 1e12), max|w| rel dev {big:.2e} (bar {EIG_MAX_RTOL}), min|w| dev "
          f"{small:.3f} of n * eps * max|w| (bar 1); a fit's backfill ({EIG_FIT_ROWS} z rows, "
          f"counted {fit_counts}) {fit_ms:.2f} ms vs eigvalsh {fit_plain_ms:.2f} ms "
          f"(worst rel dev {fit_rel:.2e}); a NaN Gram: kernel {nan_kernel}, eigvalsh "
          f"{nan_eigvalsh}; a NaN z row: the backfill {nan_backfill[0]} both ways", flush=True)
    return {"ms": ms, "device_ms": alone, "plain_ms": plain_ms, "bound_ms": bound,
            "ops": ops, "sizes": sizes, "cluster": C, "clusters": clusters,
            "worst_rel_dev": rel, "max_rel_dev": big, "min_dev_of_n_eps_max": small,
            "launches_fit_backfill": fit_counts["eig"], "fit_backfill_ms": fit_ms,
            "fit_backfill_eigvalsh_ms": fit_plain_ms, "nan_eigvalsh": nan_eigvalsh}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--k1", action="store_true",
                    help="phases 1, 2, 3, 4b and K1's times only, without the result lines")
    ap.add_argument("--k3", action="store_true",
                    help="phases 1, 2, 10 and K3's times only, without the result lines")
    ap.add_argument("--states", action="store_true",
                    help="phases 1, 2, 6 and K2's and K4's times only, without the "
                         "result lines")
    ap.add_argument("--vjp", action="store_true",
                    help="phases 1, 2 and 15a (the adjoint kernel against its plain version "
                         "and its first layout, and their times) only, without the result lines")
    ap.add_argument("--cond", action="store_true",
                    help="phases 1, 2 and 16 (config #7 with its condition numbers) only, "
                         "without the result lines")
    ap.add_argument("--cli", action="store_true",
                    help="phases 1, 2 and 17 (the README's SRTM command and config #5 "
                         "through the port's CLI) only, without the result lines")
    ap.add_argument("--q12", action="store_true",
                    help="phases 1, 2 and 19 (K1 and K3 at 11 and 12 qubits, config #7 at 12 "
                         "qubits at full width and against the JAX package) only, without the "
                         "result lines")
    ap.add_argument("--scale-out", action="store_true",
                    help="phases 1, 2 and 18 (the clip, --regularization on the CLI's CG "
                         "route, the Gram-free factor, nll_large, the example) with the "
                         "example and the clip at full size, without the result lines")
    ap.add_argument("--eig", action="store_true",
                    help="phases 1, 2 and 20 (the batched eigenvalue kernel of the "
                         "condition-number backfill against eigvalsh) only, without the "
                         "result lines")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from dqgp_tpu_torch import config
    from dqgp_tpu_torch.data import split_data_numpy
    from dqgp_tpu_torch.driver import TrainConfig, train
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.gp.cv import cv_fold_scores_impl, kfold_pad_indices
    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp
    from dqgp_tpu_torch.models.kernels.quantum_kernel import (
        gram_from_features, kernel_features)
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops import cuda_eig
    from dqgp_tpu_torch.ops.fusion import fuse_circuit
    from dqgp_tpu_torch.parallel.consensus import make_admm_step, make_agent_batch

    dev = torch.device("cuda", 0)
    config.set_precision_policy()
    config.use_fusion = "auto"

    # 1. device --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # phase 1: the card's name and power limit, as nvidia-smi gives them

    # 2. build ---------------------------------------------------------------
    t0 = time.time()
    builds = build_kernels(K.SOURCES + (cuda_eig.SOURCE,) + FIRST_LAYOUTS)
    for src in K.SOURCES:
        K._library(src)
    cuda_eig._library()
    for src in FIRST_LAYOUTS:
        _first_layout_library(src)
    # each warp kernel's sources: 1-10 qubits, then 11-12 where it goes there
    warp_sources = {name: (K.kernel_source(name, 1),) + (
        (K.WIDE_SOURCES[name],) if name in K.WIDE_SOURCES else ()) for name in WARP_KERNELS}
    regs = {}
    for name, srcs in warp_sources.items():
        regs[name] = {}
        for src in srcs:
            regs[name].update(warp_ptxas(builds[src][1], WARP_KERNELS[name]))
    fid_circuit = build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS)
    main_circuit = northstar_spec().circuit
    # each warp kernel's geometry at its paths' circuits: (kernel, geometry, qubits, path)
    c7_circuit = config7_spec().circuit
    c12_circuit = config7_spec(C12_QUBITS).circuit
    geos = [("K1", K.features_geometry(main_circuit), NUM_QUBITS, "the north star"),
            ("K1_f64", K.features_geometry(main_circuit, 8), NUM_QUBITS,
             "the north star's backfill"),
            ("K1_f64", K.features_geometry(c7_circuit, 8), C7_QUBITS, "config #7's backfill"),
            ("K2", K.states_geometry(fid_circuit), FID_QUBITS, "config #5"),
            ("K2_f64", K.states_geometry(fid_circuit, 8), FID_QUBITS,
             "config #5's dataset and backfill"),
            ("K3", K.fused_geometry(c7_circuit), C7_QUBITS, "config #7"),
            ("K3", K.fused_geometry(c12_circuit), C12_QUBITS, "config #7 at 12 qubits"),
            ("K1", K.features_geometry(c12_circuit), C12_QUBITS, "config #7 at 12 qubits"),
            ("K1_f64", K.features_geometry(c12_circuit, 8), C12_QUBITS,
             "config #7's backfill at 12 qubits"),
            ("K4", K.fused_geometry(fid_circuit), FID_QUBITS, "config #5"),
            ("vjp", K.vjp_geometry(main_circuit), NUM_QUBITS, "the north star"),
            ("vjp", K.vjp_geometry(fid_circuit), FID_QUBITS, "config #5"),
            ("vjp", K.vjp_geometry(c7_circuit), C7_QUBITS, "config #7")]
    per_sm = [K.blocks_per_sm(name, geo, n) for name, geo, n, _ in geos]
    print(f"phase 2 build ({time.time() - t0:.2f} s): "
          + " | ".join(builds[src][0] for src in K.SOURCES + (cuda_eig.SOURCE,) + FIRST_LAYOUTS)
          + " | ptxas by qubit count (registers, stack B, spill stores B, spill loads B): "
          + "; ".join(f"{name}: " + (", ".join(f"{n}: {info}" for n, info in r.items())
                                     or "reused") for name, r in regs.items())
          + " | " + "; ".join(
              f"{name} at {path}'s circuit ({n} qubits): "
              f"{geo.threads} threads per block, {geo.lanes} lanes ({geo.warps} warps) a sample, "
              f"{geo.samples} samples a block, {geo.smem_bytes} B dynamic shared memory (C "
              f"{geo.c_bytes} B), "
              f"{k} blocks an SM ({k * geo.threads // 32} warps)"
              for (name, geo, n, path), k in zip(geos, per_sm)), flush=True)
    for name, srcs in warp_sources.items():  # after the report, which names what failed
        want = range(1, K.MAX_QUBITS[name.split("_")[0]] + 1)
        check(not all(builds[src][1] for src in srcs) or set(regs[name]) == set(want),
              f"ptxas reported {name} instantiations {sorted(regs[name])}, want {list(want)}")
        check(all(info[1:] == (0, 0, 0) for info in regs[name].values()),
              f"{name} uses a stack frame or spills: {regs[name]}")
    check(all(v >= 1 for v in per_sm), f"a warp kernel does not fit an SM: {per_sm}")
    eig_regs = eig_ptxas(builds[cuda_eig.SOURCE][1])
    print(f"phase 2 batched eigenvalue kernel, ptxas (registers, stack B, spill stores B, spill "
          f"loads B): {eig_regs or 'reused'}; cluster limits: "
          + ", ".join(f"{C} blocks {cuda_eig.cluster_limit(C)} rows"
                      for C in cuda_eig.CLUSTER_SIZES), flush=True)
    check(eig_regs is None or eig_regs[1:] == (0, 0, 0),
          f"the batched eigenvalue kernel uses a stack frame or spills: {eig_regs}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_angles(circuit, B, dtype=torch.float32):
        return (torch.rand((B, circuit.num_gates), generator=gen, device=dev,
                           dtype=dtype) * 4.0 - 1.0) * np.pi

    if args.k1:
        check_k1(rand_angles)
        northstar_gate(dev)
        print(f"phase 5 K1 times [{smi}]: {k1_times_text(time_k1(rand_angles))}", flush=True)
    if args.k3:
        check_k3(rand_angles)
        time_k3(rand_angles, smi)
    if args.states:
        check_states(rand_angles)
        time_states(rand_angles, smi)
    if args.vjp:
        check_vjp(rand_angles)
    if args.cond:
        X_tr, Y_tr, _, _, c7_splits = config7_problem(C7_SAMPLES, C7_AGENTS)
        config7_cond_phase(dev, smi, (X_tr, Y_tr, c7_splits), rand_angles)
    if args.cli:
        cli_phase(dev, smi)
    if args.scale_out:
        scale_out_phase(dev, smi, config7_cg_reference(dev), full=True)
    if args.q12:
        wide_phase(dev, smi, rand_angles)
    if args.eig:
        eig_phase(dev, smi)
    if (args.k1 or args.k3 or args.states or args.vjp or args.cond or args.cli or args.scale_out
            or args.q12 or args.eig):
        return 0

    # 3. K1 vs plain on the card ----------------------------------------------
    worst = check_k1(rand_angles)

    # 4. the main path ------------------------------------------------------------
    with open(FIXTURE) as f:
        ref = json.load(f)
    X, Y, X_test, Y_test = make_problem()
    check(problem_digest(X, Y, X_test, Y_test) == ref["problem"]["sha256"],
          "north-star data differ from the fixture's")
    spec = northstar_spec()
    splits = split_data_numpy(X, Y, N_AGENTS, "regional")
    check(N_AGENTS * (2 * spec.num_parameters + 1) * max(len(x) for x, _ in splits)
          == STEP_ROWS, "the step's K1 batch is not the one phase 3 checked")
    cfg = TrainConfig(max_iter=ITERS, verbose=False)

    K.reset_launch_counts()
    t0 = time.time()
    res = train(spec, splits, X, Y, cfg, device=dev)
    z_best = torch.as_tensor(res.z, device=dev)
    mean, var = predict_quantum_gp(
        spec, torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
        torch.as_tensor(X_test, device=dev), z_best, noise_std=cfg.noise_std)
    metrics = evaluate_predictions(Y_test, mean, var)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counts = K.launch_counts()
    launches = counts["K1"]

    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    check(launches == 2 * ITERS + 2 + rescores,
          f"K1 launches {launches} != 2*{ITERS} + 2 + {rescores} re-scores")
    launches_f64 = counts["K1_f64"]
    check(launches_f64 == backfill_launches(ITERS, N_AGENTS),
          f"K1_f64 launches {launches_f64}: want {backfill_launches(ITERS, N_AGENTS)} (the "
          f"condition-number backfill)")
    main_eig = backfill_eig_counts(ITERS, [len(x) for x, _ in splits])
    check(counts_hold(counts, main_eig),
          f"eigenvalue counts {counts}: want {main_eig} (the backfill)")
    check(sum(counts.values()) == launches + launches_f64 + sum(main_eig.values()),
          f"other kernels ran on the K1 path: {counts}")
    check(not any(np.isnan(h["condition_numbers"]).any() for h in res.nll_history),
          "the backfill left a condition number out")
    nlls = [v for h in res.nll_history for v in h["agent_losses"]]
    cvs = [h["consensus_cv_score"] for h in res.cv_history]
    check(res.iterations == ref["iterations"] and res.converged_by == ref["converged_by"],
          f"stopped {res.converged_by}@{res.iterations}, reference "
          f"{ref['converged_by']}@{ref['iterations']}")
    check(all(np.isfinite(nlls)) and all(np.isfinite(cvs)), "non-finite NLL or CV score")
    check(mean.shape == (N_TEST,) and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(var).all()), "non-finite prediction")
    z_traj = np.array([h["consensus_params"] for h in res.cv_history])
    z_dev = float(np.abs(z_traj - np.array(ref["z_trajectory"])).max())
    cv_dev = float(np.abs(np.array(cvs) - np.array(ref["cv_nlpd"])).max())
    nlpd_dev = abs(metrics["nlpd"] - ref["test_metrics"]["nlpd"])
    print(f"phase 4 main path: {ITERS} ADMM iterations + predict in {main_s:.2f} s; "
          f"K1 launches {launches} (= 2*{ITERS} + 2 + {rescores} f64 CV re-scores), K1_f64 "
          f"{launches_f64} and eigenvalue counts { {k: counts[k] for k in main_eig} } (the "
          f"condition-number backfill); z dev {z_dev:.1e} (tol {Z_TOL}), CV-NLPD dev "
          f"{cv_dev:.2e}, test NLPD "
          f"{metrics['nlpd']:.4f} vs {ref['test_metrics']['nlpd']:.4f} "
          f"(tol {NLPD_TOL}), test R2 {metrics['r2']:.4f}", flush=True)
    check(z_dev <= Z_TOL, f"z trajectory deviates {z_dev} > {Z_TOL}")
    check(cv_dev <= NLPD_TOL, f"CV-NLPD deviates {cv_dev} > {NLPD_TOL}")
    check(nlpd_dev <= NLPD_TOL, f"test NLPD deviates {nlpd_dev} > {NLPD_TOL}")

    # 4b. the bench gate's 25 iterations (its launches are not phase 4's: the
    # counts were read above)
    gate = northstar_gate(dev)

    # 5. times (after warm-up; launches here are not the main path's) -------
    batch = make_agent_batch(splits, dev)
    Xt, Yt = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    state = [torch.as_tensor(res.theta, device=dev), torch.as_tensor(res.psi, device=dev)]
    folds = kfold_pad_indices(N_SAMPLES, cfg.cv_folds, cfg.seed, dev)

    def iteration_fn(compute_cond):
        step = make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                              compute_cond=compute_cond)

        def iteration():
            out = step(state[0], state[1], batch)
            cv_fold_scores_impl(spec, Xt, Yt, out.z, *folds, noise_std=cfg.noise_std)
            state[0], state[1] = out.theta, out.psi
        return iteration

    # as train() runs it on the card (cond_mode "auto" = "host": no
    # condition numbers in the step), and with them in the step ("device")
    iter_ms, iter_cond_ms = _alternate_ms([iteration_fn(False), iteration_fn(True)], 5)

    k1 = time_k1(rand_angles)

    z32 = torch.as_tensor(res.z, device=dev)

    def gram_1000():
        gram_from_features(spec, kernel_features(spec, Xt, z32))

    gram_1000()
    gram_ms = _cuda_time_ms(gram_1000, 20)
    print(f"phase 5 times [{smi}]: ADMM iteration (step + 5-fold CV) "
          f"{iter_ms:.3f} ms as train() runs it on the card (cond_mode host), "
          f"{iter_cond_ms:.3f} ms with the condition numbers in the step (cond_mode device); "
          f"{k1_times_text(k1)}; 1000x1000 projected Gram "
          f"{gram_ms:.4f} ms ({1e6 / (gram_ms * 1e-3):.3e} entries/s)", flush=True)

    # 6. K2, K1 float64 and K4 vs their plain versions on the card ------------
    err = check_states(rand_angles)

    # 7. the fidelity path: dataset, split, 5 ADMM iterations, predict -------
    with open(FIDELITY_FIXTURE) as f:
        fref = json.load(f)
    fcfg = TrainConfig(max_iter=FID_ITERS, verbose=False, seed=FID_SEED)
    K.reset_launch_counts()
    t0 = time.time()
    fspec, FX, FY, theta_star, X_tr, Y_tr, X_te, Y_te, fsplits = fidelity_problem(dev)
    gen_s = time.time() - t0
    check(fspec.circuit.num_gates == 23 and fspec.num_parameters == 12,
          "config #5's circuit is not G=23, P=12")
    check(array_digest(FX) == fref["problem"]["x_sha256"], "dataset X differs from the fixture's")
    check(np.array_equal(theta_star, fref["problem"]["theta_star"]), "theta* differs")
    y_dev = float(np.abs(FY - np.array(fref["problem"]["Y"])).max())
    check(y_dev <= 1e-6, f"dataset Y deviates {y_dev} > 1e-6 from the JAX float64 dataset")
    check([len(x) for x, _ in fsplits] == fref["problem"]["shard_sizes"], "shard sizes differ")
    check(FID_AGENTS * (2 * fspec.num_parameters + 1) * max(len(x) for x, _ in fsplits)
          == FID_STEP_ROWS, "the step's K2 batch is not the one phase 6 checked")
    t1 = time.time()
    fres = train(fspec, fsplits, X_tr, Y_tr, fcfg, ground_truth_params=theta_star, device=dev)
    fmean, fvar = predict_quantum_gp(
        fspec, torch.as_tensor(X_tr, device=dev), torch.as_tensor(Y_tr, device=dev),
        torch.as_tensor(X_te, device=dev), torch.as_tensor(fres.z, device=dev),
        noise_std=fcfg.noise_std)
    fmetrics = evaluate_predictions(Y_te, fmean, fvar)
    torch.cuda.synchronize()
    fid_s = time.time() - t1
    fcounts = K.launch_counts()
    frescores = sum(h["solver"] == "float64-rescue" for h in fres.cv_history)
    fid_f64 = 1 + backfill_launches(FID_ITERS, FID_AGENTS)
    feig = backfill_eig_counts(FID_ITERS, [len(x) for x, _ in fsplits])
    check(fcounts["K2"] == 2 * FID_ITERS + 2 + frescores and fcounts["K2_f64"] == fid_f64
          and counts_hold(fcounts, feig)
          and fcounts["K1"] == fcounts["K1_f64"] == fcounts["K4"] == 0,
          f"fidelity path launches {fcounts}: want K2 = 2*{FID_ITERS} + 2 + "
          f"{frescores}, K2_f64 = {fid_f64} (the dataset Gram and the condition-number "
          f"backfill) and {feig} (the backfill), no other kernel")
    check(fres.converged_by == fref["converged_by"], f"stopped by {fres.converged_by}")
    check(fmean.shape == (len(X_te),) and bool(torch.isfinite(fmean).all())
          and bool(torch.isfinite(fvar).all()), "non-finite fidelity prediction")
    fz_dev, fnll_dev, fcv_ratio = check_fidelity_run(fres, fref, FID_ITERS, "fidelity")
    tref = fref["test_metrics"]["nlpd"]
    t_bar = max(NLPD_TOL, 2 * abs(tref - fref["test_nlpd_f64_features"]))
    check(abs(fmetrics["nlpd"] - tref) <= t_bar,
          f"fidelity test NLPD {fmetrics['nlpd']} vs JAX f32 {tref} beyond {t_bar}")
    print(f"phase 7 fidelity path: dataset ({FID_SAMPLES} rows, f64 Gram on the card) "
          f"in {gen_s:.2f} s, Y dev {y_dev:.2e} (tol 1e-6); {FID_ITERS} ADMM iterations "
          f"+ predict in {fid_s:.2f} s; launches {fcounts} (K2 = 2*{FID_ITERS} + 2 + "
          f"{frescores} re-scores, K2_f64 = 1 + {fid_f64 - 1} backfill); z dev {fz_dev:.1e} (tol {Z_TOL}), agent NLL rel dev "
          f"{fnll_dev:.2e} (tol {NLL_RTOL}), worst CV-NLPD dev / bar {fcv_ratio:.3f}, "
          f"CV-NLPD {[round(h['consensus_cv_score'], 4) for h in fres.cv_history]} vs "
          f"JAX f32 {[round(v, 4) for v in fref['cv_nlpd']]}; test NLPD "
          f"{fmetrics['nlpd']:.4f} vs {tref:.4f} (bar {t_bar:.3f}), test R2 "
          f"{fmetrics['r2']:.4f}", flush=True)

    # 8. the fidelity path with fusion on: K4 in K2's place ------------------
    config.use_fusion = "on"
    try:
        K.reset_launch_counts()
        ures = train(fspec, fsplits, X_tr, Y_tr,
                     TrainConfig(max_iter=FID_FUSED_ITERS, verbose=False, seed=FID_SEED),
                     ground_truth_params=theta_star, device=dev)
        torch.cuda.synchronize()
        ucounts = K.launch_counts()
    finally:
        config.use_fusion = "auto"
    urescores = sum(h["solver"] == "float64-rescue" for h in ures.cv_history)
    ufid_f64 = backfill_launches(FID_FUSED_ITERS, FID_AGENTS)
    ueig = backfill_eig_counts(FID_FUSED_ITERS, [len(x) for x, _ in fsplits])
    check(ucounts["K4"] == 2 * FID_FUSED_ITERS + urescores and ucounts["K2_f64"] == ufid_f64
          and counts_hold(ucounts, ueig)
          and sum(ucounts.values()) == ucounts["K4"] + ufid_f64 + sum(ueig.values()),
          f"fused path launches {ucounts}: want K4 = 2*{FID_FUSED_ITERS} + "
          f"{urescores}, K2_f64 = {ufid_f64} and {ueig} (the backfill: float64 never fuses) "
          f"and no other kernel")
    uz_dev, unll_dev, ucv_ratio = check_fidelity_run(ures, fref, FID_FUSED_ITERS, "fused")
    program = fuse_circuit(fspec.circuit)
    print(f"phase 8 fused fidelity path: {FID_FUSED_ITERS} ADMM iterations, "
          f"{len(program.ops)} fused ops (R={program.n_rows}) for {fspec.circuit.num_gates} "
          f"gates; launches {ucounts}; z dev {uz_dev:.1e}, agent NLL rel dev "
          f"{unll_dev:.2e}, worst CV-NLPD dev / bar {ucv_ratio:.3f}", flush=True)

    # 9. times of the fidelity path ------------------------------------------
    fbatch = make_agent_batch(fsplits, dev)
    FXt, FYt = torch.as_tensor(X_tr, device=dev), torch.as_tensor(Y_tr, device=dev)
    fstate = [torch.as_tensor(fres.theta, device=dev), torch.as_tensor(fres.psi, device=dev)]
    ffolds = kfold_pad_indices(len(X_tr), fcfg.cv_folds, fcfg.seed, dev)

    def fid_iteration_fn(compute_cond):
        fstep = make_admm_step(fspec, rho=fcfg.rho, L=fcfg.L, noise_std=fcfg.noise_std,
                               compute_cond=compute_cond)

        def fid_iteration():
            out = fstep(fstate[0], fstate[1], fbatch)
            cv_fold_scores_impl(fspec, FXt, FYt, out.z, *ffolds, noise_std=fcfg.noise_std)
        return fid_iteration

    fid_iter_ms, fid_iter_cond_ms = _alternate_ms([fid_iteration_fn(False),
                                                   fid_iteration_fn(True)], 5)

    fz32 = torch.as_tensor(fres.z, device=dev)

    def fid_gram():
        gram_from_features(fspec, kernel_features(fspec, FXt, fz32))

    fid_gram()
    fgram_ms = _cuda_time_ms(fid_gram, 20)
    print(f"phase 9 times [{smi}]: fidelity ADMM iteration (step + 5-fold CV) "
          f"{fid_iter_ms:.3f} ms as train() runs it on the card, {fid_iter_cond_ms:.3f} ms "
          f"with the condition numbers in the step; {len(X_tr)}x{len(X_tr)} fidelity Gram {fgram_ms:.4f} ms "
          f"({len(X_tr) ** 2 / (fgram_ms * 1e-3):.3e} entries/s)", flush=True)
    st = time_states(rand_angles, smi)

    # 13-15. the driver's modes: cond_mode, chain_iters, autodiff ------------
    fid = (fspec, fsplits, FX, X_tr, Y_tr)
    backfill = cond_phase(dev, smi, rand_angles, fid)
    chained = chained_phase(dev, smi, fid)
    adjoint = autodiff_phase(dev, smi, rand_angles)

    k3, adjoint7, cond7, c7 = config7_phases(dev, smi, rand_angles)

    # 17. the port's CLI: the README's SRTM command and config #5 -----------
    cli_launches = cli_phase(dev, smi)

    # 18. the rest of the one-device scale-out, on 11b's z -------------------
    scale = scale_out_phase(dev, smi, c7)
    full = (c7["X_tr"], c7["Y_tr"], c7["splits"])
    del c7

    # 19. 11 and 12 qubits: K1 and K3 across warps, config #7 at 12 qubits ---
    wide = wide_phase(dev, smi, rand_angles, full)
    del full

    # 20. the batched eigenvalue kernel of the condition-number backfill ------
    eig = eig_phase(dev, smi)

    print(json.dumps({"kernels": [
        {"name": "pauli_features (K1)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:392",
         "launches": launches, "max_abs_err": worst, **k1,
         "library_ms": None, "gate_25_iterations": gate, "chained": chained["K1"],
         "launches_cli_run_a": cli_launches["A"]["K1"]},
        {"name": "pauli_features float64 (K1_f64)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features.cu",
         "replaces": "dqgp_tpu/ops/statevector.py:148",
         "replaces_note": "no Pallas kernel: the JAX package runs float64 features on its "
                          "complex128 XLA engine (state_from_angles :148, pauli_features :172)",
         "launches": cond7["launches"], "max_abs_err": err["K1_f64"],
         **{k: cond7[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                  "first_layout_ms", "first_layout_device_ms", "B")},
         "library_ms": None, "config7_cond": cond7,
         "launches_northstar_backfill": launches_f64, "backfill_shapes": backfill["K1_f64"],
         "launches_cli_run_a": cli_launches["A"]["K1_f64"]},
        {"name": "states (K2)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/states.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:238",
         "launches": fcounts["K2"], "max_abs_err": err["K2"], **st["K2"],
         "library_ms": None, "chained": chained["K2"],
         "launches_cli_run_b": cli_launches["B"]["K2"]},
        {"name": "states float64 (K2_f64)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/states.cu",
         "replaces": "dqgp_tpu/ops/statevector.py:148",
         "replaces_note": "no Pallas kernel: the JAX package runs float64 states on its "
                          "complex128 XLA engine (state_from_angles :148)",
         "launches": fcounts["K2_f64"], "max_abs_err": err["K2_f64"],
         **{k: st["K2_f64"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                         "first_layout_ms", "first_layout_device_ms", "B",
                                         "at_10_qubits")},
         "library_ms": None, "backfill_shapes": backfill["K2_f64"],
         "launches_cli_run_b": cli_launches["B"]["K2_f64"]},
        {"name": "pauli_features_fused (K3)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features_fused.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:330", **k3,
         "launches_scale_out": {
             **{f"cli_run_{n}": r["launches"]["K3"] for n, r in scale["cli"].items()},
             "factor_features": scale["factor"]["launches"]["K3"],
             "example": scale["example"]["launches"]["K3"]}},
        {"name": "states_fused (K4)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/states_fused.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:278",
         "launches": ucounts["K4"], "max_abs_err": err["K4"], **st["K4"],
         "library_ms": None, "max_abs_err_vs_unfused": err["K4_unfused"]},
        {"name": "pauli_features_fused at 11-12 qubits (K3)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features_fused_q11_12.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:330",
         "launches": wide["config7"]["launches"]["K3"], **wide["kernels"]["K3"],
         "library_ms": None, "launches_fixture": wide["fixture"]["launches"]["K3"],
         "launches_cli_run_e": wide["run_e"]["launches"]["K3"]},
        {"name": "pauli_features at 11-12 qubits (K1)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features_q11_12.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:392",
         "launches": wide["config7"]["fusion_off"]["launches"]["K1"], **wide["kernels"]["K1"],
         "library_ms": None},
        {"name": "pauli_features float64 at 11-12 qubits (K1_f64)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features_f64_q11_12.cu",
         "replaces": "dqgp_tpu/ops/statevector.py:148",
         "replaces_note": "no Pallas kernel: the JAX package runs float64 features on its "
                          "complex128 XLA engine (state_from_angles :148, pauli_features :172)",
         "launches": wide["config7"]["launches"]["K1_f64"], **wide["kernels"]["K1_f64"],
         "library_ms": None, "launches_cli_run_e": wide["run_e"]["launches"]["K1_f64"]},
        {"name": "circuit_vjp (the backward of K1 and K2)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/circuit_vjp.cu",
         "replaces": "dqgp_tpu/parallel/consensus.py:157",
         "replaces_note": "jax.value_and_grad through the XLA engine: the Pallas kernels "
                          "have no VJP, so there is no TPU kernel",
         **adjoint, "library_ms": None, "launches_config7": adjoint7["launches"],
         "config7_autodiff": adjoint7},
        {"name": "gram_extremes (the backfill's batched eigenvalues)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/gram_extremes.cu",
         "replaces": None,
         "replaces_note": "no TPU kernel: the JAX package computes the backfill's "
                          "eigenvalues on the host's LAPACK",
         "launches": counts["eig"], **eig,
         "library_ms": eig["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
