#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py                   # paths A-D for 3 iterations,
                                            # path E for 3000 epochs
    python3 chip_smoke.py --iterations 100  # the DPI recipes' full budget
    python3 chip_smoke.py --epochs 35000    # the D-DBSDE recipe's full budget
    python3 chip_smoke.py --hjb-epochs 15000  # path I's full budget
    python3 chip_smoke.py --fn-iterations 40  # path K's full budget
    python3 chip_smoke.py --dbdp-sub-iter recipe  # paths M, N in full

Paths (the Burgers 100-d w1.0 recipe through ``PicardRunner`` at full
width: nx=100, 4x128 ELU net, B=4096 points from the path's sampler; A-D
at the recipe's DATA.TPU.PALLAS_PRECISION, bf16x3, the net on the tensor
cores; every path's fit, and path E's epochs, as CUDA-graph replays,
TRAIN.FUSED's "auto"):
  A  the merged estimator kernel (``csrc/generate.cu``), M=4096;
  A' A with TRAIN.FUSED false: the fit as a plain loop;
  B  DATA.TPU.PALLAS_GENERATE false, PALLAS_TERMINAL and PALLAS_INTEGRAL
     true: the standalone terminal and integral kernels (``terminal.cu``,
     ``integral.cu``);
  C  PALLAS_GENERATE false, PRNG true: the chunk estimators (64 chunks of
     64 samples each, Kahan over chunks), normals from ``normals.cu``;
  D  configs/burgers/base_100d_T1.0_w1.0_best.yaml: M=8192 with antithetic
     pairing, through the merged kernel;
  E  configs/burgers/diffusion_100d_T1.0_beta10.0.yaml, the D-DBSDE
     baseline (K=20 steps, batch 512, beta 10, the same 4x128 ELU net) as
     the recipe stands: an epoch (its draws, the rollout kernel
     ``csrc/rollout.cu`` with its seed from a device table, the loss, the
     Adam step) is one graph replay; cut to 3000 of its 35 000 epochs
     (``--epochs``);
  F  A with DATA.TPU.PALLAS_PRECISION highest: the merged kernel's FP32-FMA
     net pass;
  G  B with DATA.TPU.PALLAS_PRECISION highest: the integral kernel's
     FP32-FMA net pass;
  H  configs/hjb/base_100d_T1.0_w0.1.yaml (the HJB family: the OU equation
     with a 5-component mixture terminal, the 4x512 PISGradNet, B = M =
     4096, PALLAS_PRECISION default): the merged kernel's HJB instance
     (``csrc/generate_pis.cu``), one bf16 pass; cut to 3 iterations
     (``--iterations``);
  J  H with PALLAS_PRECISION bf16x3;
  I  configs/hjb/diffusion_100d_T1.0.yaml, the D-DBSDE baseline on the OU
     equation (K=50, a plain 4x512 ELU net, beta 10): one replay, with
     the rollout inside, per epoch; cut to 2000 of its 15 000 epochs
     (``--hjb-epochs``);
  K  configs/fully_nonlinear/base_100d_T1.0_w0.0_nov.yaml (the FN family:
     GBMEquationComplexExact, B = 2048, M = 1024 + 1024, SDGD v = 100,
     the 3x64 ELU net, HESSIAN_STORE bf16, the eval with the full Hessian):
     the split route every call, the chunk estimators in plain PyTorch (no
     kernel); cut to 3 iterations (``--fn-iterations``);
  L  K with DATA.TPU.PRNG true: the chunks' normals from ``normals.cu``;
     2 iterations;
  M  configs/fully_nonlinear/fn_100d_T1.0.yaml, the DBDP baseline (K = 50
     grid times, batch 512, a 3x64 value and gradient net a grid time): a
     sub-iteration (x0, the rollout, the loss with its Hessian, backward,
     Adam) is one graph replay over a static working pair; every grid
     time's 150 sub-iterations cut to 10 (``--dbdp-sub-iter``);
  N  configs/hjb/fn_100d_T1.0.yaml, DBDP on the OU equation (4x512 net
     pairs, 125 sub-iterations cut to 10).
Each path's kernel launch counts are read around its run (every count set
to 0 just before) and checked against its generation calls (A-D, F, G, K,
L; the net kernels' also by precision mode), its epochs (E, I) or its
sub-iterations (M, N: grid times x sub-iterations, plus the terminal
pre-fit's), and its CUDA-graph replays against its epochs or
sub-iterations (0 on A'). A wrapper counts only eager launches: on E, I, M
and N the rollout runs inside each replay, where no wrapper runs, so its
count is its graphs' capture warm-ups (WARMUP eager calls each), and its
launches inside the replays are read from a torch.profiler trace of one
timed block of the run (an eval interval of E and I, the third grid time
of M and N): one kernel event per replay. The
rate probe's entry point (``python -m
deeppicarditeration_torch.utils.probe_roofline``) is driven the same way.

Phases (each failure exits non-zero; the result line is printed last, and
only when every phase passed):
  1. build the seven CUDA kernels from ``deeppicarditeration_torch/csrc``
     (one nvcc each, all started together); the tensor-core kernels of
     ``generate.cu``, ``integral.cu`` and ``generate_pis.cu`` must hold
     HGMMA (wgmma) in their SASS; the instructions per normal, by pipe,
     that the terminal kernel's draw loop issues at nx = 100
     (``utils/probe_roofline.py:sass_mix``);
  2. the merged kernel against its plain PyTorch version on the same
     external noise (B=256, M=4096; zero iterate and a random net), in
     bf16x3 and in highest;
  3. the merged kernel's Philox normals against the plain version's
     torch.Generator normals (B=64, bf16x3): within 5 CLT standard errors
     per output, and a mean squared z-score near 1;
  4. path A, 3 iterations (``--iterations``), then path A': A's rRMSE at
     every iteration within 1 % of A''s (the captured fit against the
     loop; capturable Adam's bias correction is f32 on the card, the
     loop's f64 on the host), their fit ms, and iteration 1's relative
     difference by segment (the same dataset);
  5. at path A's shapes (B=4096, M=4096) with its zero and trained
     iterates, in bf16x3 and in highest: the merged kernel against the
     plain version in the same mode on the same noise (and the max |diff|
     of the kernel's bf16x3 and highest outputs), the merged kernel with
     antithetic pairing on the same half noise at M=8192; its Philox draws
     against torch.Generator draws (bf16x3, a Bonferroni CLT bound over all
     outputs);
  6. at the same shapes: the terminal and integral kernels against their
     plain versions on the same noise, with and without antithetic
     pairing (the integral with the zero and the trained iterate, in both
     modes); the in-kernel draws of the merged, terminal and integral
     kernels against the host Philox of ``ops/philox.py``, value for value
     (each kernel with its own draws equals its plain version fed the
     host's draws, at the first and last 8 points; the net kernels in both
     modes); the terminal kernel's Box-Muller against philox.cuh's, bit
     for bit, at all 2^23 uniforms; the normals kernel's values against
     the host Philox at the head and the end of a 2^28 buffer, its
     moments over 2^30 draws, its lag 1-8 correlations, and its
     independence from the buffer's shape;
  7. paths B, C, D, F and G, 3 iterations each;
  8. the rollout kernel at path E's shapes (K=20, B=512, nx=100, the
     baseline's mix of full and tail-shrunk steps) and at B=511, nx=7:
     its draws against the host Philox value for value, its paths against
     the plain version fed those draws, the increment relation, xs[0] =
     x0, the same values at another B, its seed from a device table in a
     captured graph replayed 3 times (each replay at its entry's seed), and
     the law of the endpoint over 2^16 x 100 paths; path E's epoch draws
     in its graph against the eager draws, bit for bit;
  9. path E, 3000 epochs (``--epochs``): one graph replay per epoch with
     the rollout inside (no eager launch but the capture's warm-up; one
     rollout kernel per replay in the traced interval), the
     final rRMSE under ``DIFFUSION_RRMSE_MAX`` (beside the eager epoch's),
     ms per epoch and the kernel's share of it;
 10. the probe kernel in each mode against its plain version at 2
     iterations, and in the elu mode also at the entry point's full size
     (1024 iterations); then the entry point at full size, its rates beside
     the bound model's peaks and its loop's SASS per unit (the elu chain's
     exp must stay in the loop);
 12. paths H and J, 3 iterations each: one ``generate_pis`` launch per
     iteration in the path's mode, rRMSE at iterations 1-3 under
     ``HJB_RRMSE_MAX``;
 13. ``generate_pis`` at path H's shapes (B = M = 4096, nx=100, the
     trained 4x512 PISGradNet and the zero iterate): against its plain
     version on the same external noise (max |diff| / max(|plain|, 1)
     per value and gradient columns within ``PIS_REL_TOL``), the zero
     iterate in "default" and "bf16x3" and the net in "bf16x3" at all B
     points, the net in "default" at the first ``PIS_B`` = 256 (at all B
     its error is printed beside the plain version's own under a
     permutation of the net's hidden units); its own draws against the
     host Philox at the first and last 8 points; its law against the
     plain version's on independent streams (a Bonferroni CLT bound, 64
     points);
 14. path I's epoch draws in its graph against the eager draws; path I,
     2000 epochs (``--hjb-epochs``): one graph replay per epoch with the
     rollout inside, the final rRMSE under ``HJB_DIFFUSION_RRMSE_MAX``;
 15. paths K (3 iterations, its peak memory) and L (2): the split route
     every call, no kernel on K, on L one normals launch per chunk (64 a
     call), rRMSE at iterations 1-3 under ``FN_RRMSE_MAX``; the normals
     kernel at their chunk shape (2048, 32, 100) against the host Philox
     at both ends of the buffer, and its mean and variance;
 16. the rollout kernel at the DBDP recipes' shapes (K = 50, B = 512,
     nx = 100) and at B=511, nx=7: its draws against the host Philox, its
     paths against the plain version on those draws, its seed table in a
     captured graph;
 17. paths M and N (10 sub-iterations a grid time, ``--dbdp-sub-iter``):
     one graph replay per sub-iteration (two graphs: the pre-fit's and
     the steps'), the rollout launches, ms per sub-iteration, the final
     grid rRMSE under ``DBDP_RRMSE_MAX`` (``DBDP_RRMSE_MAX_RECIPE`` at the
     recipes' own budgets);
 18. path M's captured sub-iterations against the eager per-pair loop on
     the same seeds (pre-fit and 2 grid times, 10 sub-iterations each):
     the pairs' parameters within ``DBDP_CAPTURED_REL`` (both with
     capturable Adams: the step count on the card, the bias correction in
     f32); beside it, measured and not gated, the difference from the
     eager loop with the host's f64 bias correction;
 11. kernel, plain-version and library times at the paths' shapes, and
     each kernel's bound, printed as one ``{"kernels": [...]}`` JSON line
     (the net kernels with a row per precision mode, timed in turns in
     this call; the terminal kernel with and without antithetic pairing,
     each against its own bound). A time below its bound fails the run:
     the model counted too much (the model: FP32, INT32, SFU and TENSOR
     pipes and an ISSUE limit on the instructions of the function's own
     arithmetic, per-normal and per-unit counts read off the SASS; the
     issue time of the SASS's whole loop, moves and branches included,
     beside it as ``sass_issue_ms``); the normals kernel also at paths
     K/L's chunk shape and the rollout kernel at M/N's, each with its
     launches on those paths; the rollout timed writing four rotating
     output buffers.
Needs one NVIDIA H100 SXM card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# configs/burgers/base_100d_T1.0_w1.0.yaml with its BASE chain resolved
BURGERS_W1_RECIPE = {
    "NAME": "Cha5.0_NoEnT_100D_T1.0_w0.0_DS4096_M4096_E16_w1.0",
    "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": 100, "alpha": 1.0, "k": 5.0, "T": 1.0}},
    "METHOD": {"cls": "Picard"},
    "PICARD": {"N": 100},
    "DATA": {"DATA_SIZE": 4096,
             "kwargs": {"t_always_uniform": True,
                        "n_estimate_terminal": 4096,
                        "n_estimate_integral": 4096},
             "CHUNK_ELEMS": 33554432,
             "SAMPLE_BOUND": 2.0},
    "TRAIN": {"N_EPOCHS": 16, "BATCH_SIZE": 512, "SUPERVISE_GRADIENT": True,
              "LOSS": {"beta": 0.0,
                       "SCALER": {"cls": "FixedLossScaler",
                                  "kwargs": {"fixed_weight": 1.0}}}},
    "NETWORK": {"cls": "PicardSolution", "NEURONS": [128, 128, 128, 128],
                "ACTIVATIONS": ["ELU", "ELU", "ELU", "ELU"], "BOUND": None,
                "RELOAD": True},
    "EVAL": {"L2_N_POINTS": 10000, "FREQ": 8, "TEST_GRAD": True},
}

# configs/burgers/base_100d_T1.0_w1.0_best.yaml on top of the w1.0 recipe
BURGERS_W1_BEST = {
    "NAME": BURGERS_W1_RECIPE["NAME"] + "_w1.0_best",
    "DATA": {"kwargs": {"n_estimate_terminal": 8192,
                        "n_estimate_integral": 8192},
             "TPU": {"ANTITHETIC": True}},
}

# configs/burgers/diffusion_100d_T1.0_beta10.0.yaml on top of the w1.0
# recipe (its BASE is the w0.0 recipe, which differs from w1.0 only in the
# three keys below that the Picard path reads: NAME, PICARD.N, fixed_weight)
BURGERS_DIFFUSION = {
    "NAME": "Cha5.0_NoEnT_100D_T1.0_w0.0_DS4096_M4096_E16_Diffusion_K20_"
            "beta10.0",
    "METHOD": {"cls": "Diffusion", "K": 20, "dt": 0.005},
    "PICARD": {"N": 1},
    "TRAIN": {"N_EPOCHS": 35000,
              "LOSS": {"beta": 10.0,
                       "SCALER": {"kwargs": {"fixed_weight": 0.0}}}},
    "EVAL": {"FREQ": 100},
}

# configs/hjb/base_100d_T1.0_w0.1.yaml (no BASE)
HJB_RECIPE = {
    "NAME": "OU_NoEnT_100D_T1.0_w0.1_M4096_hid512_lr1e-3_E16",
    "FORCE": True,
    "EQUATION": {"cls": "OUProcessEquation",
                 "kwargs": {"nx": 100, "alpha": 1.0, "T": 1.0,
                            "num_components": 5, "mean_scale": 1.0,
                            "var_scale": 2.0, "alpha_scale": 4.0}},
    "METHOD": {"cls": "Picard"},
    "PICARD": {"N": 40},
    "DATA": {"DATA_SIZE": 4096,
             "kwargs": {"t_always_uniform": True,
                        "n_estimate_terminal": 4096,
                        "n_estimate_integral": 4096},
             "CHUNK_ELEMS": 33554432,
             "TPU": {"PALLAS_PRECISION": "default"}},
    "TRAIN": {"N_EPOCHS": 16, "BATCH_SIZE": 512, "SUPERVISE_GRADIENT": True,
              "LOSS": {"beta": 0.0,
                       "SCALER": {"cls": "FixedLossScaler",
                                  "kwargs": {"fixed_weight": 0.1}}},
              "OPTIMIZER": {"kwargs": {"lr": 0.001}}},
    "NETWORK": {"cls": "PicardSolution", "NEURONS": [512, 512, 512, 512],
                "ACTIVATIONS": ["ELU", "ELU", "ELU", "ELU"], "BOUND": None,
                "RELOAD": True, "PISGRADNET": True},
    "EVAL": {"L2_N_POINTS": 100, "FREQ": 8, "TEST_GRAD": True},
}

# configs/hjb/diffusion_100d_T1.0.yaml on top of it (its BASE)
HJB_DIFFUSION = {
    "NAME": HJB_RECIPE["NAME"] + "_Diffusion_K50",
    "METHOD": {"cls": "Diffusion", "K": 50, "dt": 0.005},
    "PICARD": {"N": 1},
    "TRAIN": {"N_EPOCHS": 15000, "LOSS": {"beta": 10.0}},
    "NETWORK": {"PISGRADNET": False},
    "EVAL": {"FREQ": 100},
}

# configs/fully_nonlinear/base_100d_T1.0_w0.0_nov.yaml (no BASE)
FN_RECIPE = {
    "NAME": "GBMOne_NoEnT_100D_T1.0_w0.0_nov_2048_1024",
    "FORCE": True,
    "EQUATION": {"cls": "GBMEquationComplexExact",
                 "kwargs": {"nx": 100, "alpha": 1.0, "T": 1.0}},
    "METHOD": {"cls": "Picard"},
    "PICARD": {"N": 40},
    "DATA": {"DATA_SIZE": 2048,
             "kwargs": {"t_always_uniform": True,
                        "n_estimate_terminal": 1024,
                        "n_estimate_integral": 1024},
             "CHUNK_ELEMS": 8388608,
             "HESSIAN_APPROXIMATION": {"method": "SDGD",
                                       "kwargs": {"v": 100}},
             "TPU": {"HESSIAN_STORE": "bf16"}},
    "TRAIN": {"N_EPOCHS": 16, "BATCH_SIZE": 512, "SUPERVISE_GRADIENT": True,
              "SUPERVISE_HESSIAN": False,
              "LOSS": {"beta": 0.0,
                       "SCALER": {"cls": "FixedLossScaler",
                                  "kwargs": {"fixed_weight": 0.0}}}},
    "NETWORK": {"cls": "PicardSolution", "NEURONS": [64, 64, 64],
                "ACTIVATIONS": ["ELU", "ELU", "ELU"], "BOUND": None,
                "RELOAD": True},
    "EVAL": {"L2_N_POINTS": 1000, "FREQ": 4, "TEST_GRAD": True,
             "TEST_HESSIAN": True},
}

# configs/fully_nonlinear/fn_100d_T1.0.yaml on top of it (its BASE)
FN_DBDP = {
    "NAME": FN_RECIPE["NAME"] + "_FullyNonlinearSolver_0.02_150",
    "METHOD": {"cls": "FullyNonlinearSolver", "dt": 0.02,
               "num_sub_iter": 150},
    "PICARD": {"N": 1},
    "TRAIN": {"N_EPOCHS": 1, "LOSS": {"beta": 0.0}},
    "EVAL": {"FREQ": 1},
}

# configs/hjb/fn_100d_T1.0.yaml on top of the HJB recipe (its BASE)
HJB_DBDP = {
    "NAME": HJB_RECIPE["NAME"] + "_FullyNonlinearSolver_0.02_125",
    "METHOD": {"cls": "FullyNonlinearSolver", "dt": 0.02,
               "num_sub_iter": 125},
    "PICARD": {"N": 1},
    "TRAIN": {"N_EPOCHS": 1, "LOSS": {"beta": 0.0}},
    "NETWORK": {"PISGRADNET": False},
    "EVAL": {"FREQ": 1},
}

# path -> (recipe layers, CLI-style overrides)
PATHS = {
    "A": ((BURGERS_W1_RECIPE,), []),
    "A'": ((BURGERS_W1_RECIPE,), ["TRAIN.FUSED", "false"]),
    "B": ((BURGERS_W1_RECIPE,),
          ["DATA.TPU.PALLAS_GENERATE", "false",
           "DATA.TPU.PALLAS_TERMINAL", "true",
           "DATA.TPU.PALLAS_INTEGRAL", "true"]),
    "C": ((BURGERS_W1_RECIPE,),
          ["DATA.TPU.PALLAS_GENERATE", "false", "DATA.TPU.PRNG", "true"]),
    "D": ((BURGERS_W1_RECIPE, BURGERS_W1_BEST), []),
    "E": ((BURGERS_W1_RECIPE, BURGERS_DIFFUSION), []),
    "F": ((BURGERS_W1_RECIPE,), ["DATA.TPU.PALLAS_PRECISION", "highest"]),
    "G": ((BURGERS_W1_RECIPE,),
          ["DATA.TPU.PALLAS_GENERATE", "false",
           "DATA.TPU.PALLAS_TERMINAL", "true",
           "DATA.TPU.PALLAS_INTEGRAL", "true",
           "DATA.TPU.PALLAS_PRECISION", "highest"]),
    "H": ((HJB_RECIPE,), []),
    "J": ((HJB_RECIPE,), ["DATA.TPU.PALLAS_PRECISION", "bf16x3"]),
    "I": ((HJB_RECIPE, HJB_DIFFUSION), []),
    "K": ((FN_RECIPE,), []),
    "L": ((FN_RECIPE,), ["DATA.TPU.PRNG", "true"]),
    "M": ((FN_RECIPE, FN_DBDP), []),
    "N": ((HJB_RECIPE, HJB_DBDP), []),
}
# the precision modes of the net kernels' rows, the main path's first
MODES = ("bf16x3", "highest")

TOL = 5e-5  # kernel vs plain on the same noise: rtol = atol
CLT_SIGMAS = 5.0  # per output, phase 3
CLT_FAMILY_P = 1e-3  # chance of a false failure over all outputs
Z2_BAND = (0.8, 1.25)  # mean (|diff|/SE)^2, 1 expected
EXACT_SEED = (7 << 32) | 5  # in-kernel vs host draws: both seed words used
EDGE = 8  # points checked at each end of the launch
DRAW_TOL = 1e-5  # normals kernel vs host Philox: rtol = atol
NORMALS_CHECK = 2 ** 16  # values checked at each end of the buffer
RRMSE_MAX = 0.35
# path A (the captured fit) against A' (the loop): rRMSE within 1 % at
# every iteration, fixed before the first run
FUSED_RRMSE_REL = 0.01
# Path E's final rRMSE at its cut (3000 of 35 000 epochs), fixed before its
# first run on the card: an untrained net scores ~1 (the zero function
# exactly 1); the JAX records end at 0.089-0.098 after 35 000 epochs; at
# 3000 epochs Adam at lr 1e-3 should be near 0.10-0.20 (PERF.md, the
# prediction for path E). The limit leaves room for another random stream
# and flags a run that did not train.
DIFFUSION_EPOCHS = 3000
DIFFUSION_RRMSE_MAX = 0.35
# the eager epoch's final rRMSE at 3000 epochs (before the epoch was a
# graph replay; one H100 80GB HBM3 at 700 W, PERF.md section 5)
DIFFUSION_RRMSE_EAGER = 0.02843
# The HJB family (paths H, J, I), each limit fixed before the first run of
# this code on the card (PERF.md, the HJB prediction). generate_pis against
# its plain version on the same noise: max |diff| / max(|plain|, 1), for
# the value column and the gradient columns apart: f32 sums in another
# order, and under the one-pass mode a bf16 rounding that an f32
# difference of an ulp can flip.
PIS_REL_TOL = {"default": 1e-3, "bf16x3": 1e-4}
PIS_MODES = ("default", "bf16x3")  # path H's first
# Points of the "default" comparison with a net (bf16x3 and the zero
# iterate: all B). At all B the one-pass mode's gradient columns differ by
# 1.8e-3 (PERF.md, the HJB findings): bf16 roundings that the f32 order
# flips, weighted by 1/sqrt(s - t), whose tail grows with the points; the
# limit holds at 256, as when it was fixed.
PIS_B = 256
# path H's rRMSE at iterations 1, 2, 3 and after (the JAX record under
# "default": 0.394, 0.178, 0.156, bench_results/hjb100d_tpu_prec_default)
HJB_RRMSE_MAX = (0.60, 0.35, 0.30)
# path I's final rRMSE at its cut: an untrained net scores ~1; the JAX
# records end at 0.073-0.104 after 15 000 epochs
# the final iterate's eval beside the in-training one (path H's recipe
# evaluates on 100 points; scripts/run_tpu_recipe.py, which wrote the JAX
# records, on 1000)
FINAL_EVAL_POINTS = 1000
HJB_DIFFUSION_EPOCHS = 2000
HJB_DIFFUSION_RRMSE_MAX = 0.35
PATH_TOL = 1e-5  # rollout kernel vs host Philox / plain version: rtol=atol
LAW_ROWS = 2 ** 16  # endpoint law check: rows of 100 dimensions
PROBE_TOL = 1e-5  # probe kernel vs plain (f32 sums reordered): rtol=atol
# Every mode is checked at PROBE_CHECK_ITERS iterations. bits and normals
# only there: their plain version draws every unit on the host (~0.8 s for 2
# iterations at a full grid, ~7 min at 1024). elu draws only iteration 0's
# normals, so it is also checked at the entry point's full size, where each
# partial sum adds PROBE_ITERS x 32 terms in another order and through
# another exp than the plain version: |diff| <= ELU_SUM_ULPS 2^-24 x (its
# sum of |terms|), ELU_SUM_ULPS = 2 (PROBE_ITERS + 32) (recursive summation
# on both sides, at most PROBE_ITERS + 31 additions per term) + 16 (expf and
# torch.exp within 2 ulp each of a value below 1, on terms of mean
# magnitude ~1/2).
PROBE_CHECK_ITERS = 2
PROBE_ITERS, PROBE_REPEATS = 1024, 8  # the probe's entry point at full size
ELU_SUM_ULPS = 2 * (PROBE_ITERS + 32) + 16
# The elu probe's chain through the accumulator keeps its exp in the loop:
# one special function per unit in the loop's SASS. The bits and normals
# sums depend on every iteration's draws and equal the plain version, so
# they cannot be hoisted. No kernel, and no probe mode, may beat its bound.
NORMALS_CHUNK = (4096, 64, 100)  # path C's per-chunk draw
# The FN family (paths K, L, M, N), each limit fixed before the first run
# of this code on the card (PERF.md, the FN prediction). Path K's rRMSE at
# iterations 1, 2, 3 and after: about 1.3x the JAX record under
# HESSIAN_STORE bf16 (0.4274, 0.3239, 0.2569; bench_results/
# fn100d_tpu_hessbf16.jsonl); the port draws other streams.
FN_RRMSE_MAX = (0.55, 0.42, 0.34)
FN_ITERATIONS = 3  # path K's cut (the recipe's own: 40)
FN_PRNG_ITERATIONS = 2  # path L's
FN_CHUNK = (2048, 32, 100)  # paths K, L: B x gen.chunk x nx per chunk
# Paths M and N: the DBDP recipes with every grid time's sub-iterations cut
# to DBDP_SUB_ITER (the recipes' own: 150 and 125). The final grid rRMSE
# (100 points a grid time, 51 grid times) at that cut, from
# utils/dbdp_sweep.py on the card (PERF.md): M scores 0.14-0.20 over three
# seeds at 10 sub-iterations and 0.25-0.45 at 1-5, so its limit parts the
# two. N cannot be parted so: the terminal pre-fit alone scores ~0.09 (one
# sub-iteration), the sweep's drift 0.15 at 10, and only the recipe's
# budget falls below the pre-fit; its limit catches an untrained sweep
# (~0.25). At the recipes' budgets: M 1.5x the JAX record 0.0278; N the
# lesser of 1.5x the JAX 0.068 and a value below the pre-fit's 0.089.
DBDP_SUB_ITER = 10
DBDP_RRMSE_MAX = {"M": 0.23, "N": 0.20}
DBDP_RRMSE_MAX_RECIPE = {"M": 0.042, "N": 0.085}
DBDP_ROLLOUT = (50, 512, 100)  # K, B, nx of the DBDP recipes' paths
# Captured DBDP against the eager loop (phase 18): the same kernels, both
# with capturable Adams, replayed or launched one by one. (Against the
# eager loop with the host's f64 bias correction the difference was
# 1.147e-05 on an H100 at 700 W; Adam's arithmetic on the card is held to
# optax's in tests/test_torch_gpu.py.)
DBDP_CAPTURED_REL = 1e-5

# NVIDIA's data sheet for the H100 SXM (dense, at 700 W): FP32 FLOP/s
# outside the tensor cores, and HBM3 bytes/s
H100_SXM = "H100 80GB HBM3"
SMS = 132
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# dense bf16 tensor-core FLOP/s (wgmma), the data sheet's
PEAK_BF16_TENSOR = 989e12
# Per-SM issue rates per clock for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 128 FP32
# add/multiply/FMA, 64 32-bit integer add/logical/shift/multiply, 16
# special functions (log2, exp2, sin, cos, rsqrt, rcp); and four warp
# schedulers that issue one warp instruction each a clock, 128 thread
# instructions in all, whatever pipe runs them (ISSUE). The clock is the
# one at which 128 FMA/SM give the data sheet's FP32 peak (~1.98 GHz).
CLOCK_HZ = PEAK_FP32_FLOPS / (SMS * 128 * 2)
PEAK_INT32_OPS = SMS * 64 * CLOCK_HZ
PEAK_SFU_OPS = SMS * 16 * CLOCK_HZ
PEAK_ISSUE = SMS * 128 * CLOCK_HZ
# A work model is (FP32, INT32, SFU, bytes, bf16 tensor FLOPs, other
# instructions). FP32 is in FLOPs of PEAK_FP32_FLOPS: an FMA counts 2, and
# so does any other FP32 instruction counted in the SASS (it takes the FMA's
# slot); FP32 / 2 + INT32 + SFU is the function's instructions, which the
# ISSUE limit counts. Other (moves, branches, loop and address arithmetic
# of one implementation) is left out of the bound and reported beside it
# (``sass_issue_ms``).
#
# Integer work per draw, counted in the SASS of the rate probe's loops
# (``cuobjdump -sass`` of csrc/probe.cu, printed by phase 10): a
# Philox4x32-10 call is 33 integer instructions (a 32x32 product with both
# halves is one IMAD.WIDE, a three-input XOR one LOP3, the key schedule is
# hoisted, the constant stream word folds part of rounds 1-2), and the
# uniform's shift-or is one LEA.HI per word: 33 / 4 + 1 per 32-bit word.
# Box-Muller's fast path adds 11 per pair: logf's exponent split 4, sqrtf's
# range test 2, sincosf's quadrant 5 (its slow path, for arguments above
# 105615, is never taken on (0, 2 pi]).
INT_PER_WORD = 33 / 4 + 1
INT_PER_NORMAL = INT_PER_WORD + 11 / 2
# Per normal, besides, from the SASS of the terminal kernel's draw loop on
# its fast path (phase 1's "terminal kernel's SASS per normal", PR 9 and
# PR 10 on CUDA 12.8: all 38.5, fp32 21.5, int 14.25, sfu 0.5, sts 0.25):
# logf, sqrtf and sincosf are FP32 polynomials around one MUFU.RSQ a pair,
# so 21.5 FP32 instructions (43 FLOPs of slots) and 0.5 special functions;
# 38.5 instructions in all, of which 38.5 - 21.5 - INT_PER_NORMAL - 0.5 on
# no counted pipe (moves, branches, the store).
FP32_PER_NORMAL = 2 * 21.5
SFU_PER_NORMAL = 0.5
ISSUE_PER_NORMAL = 38.5
OTHER_PER_NORMAL = ISSUE_PER_NORMAL - 21.5 - INT_PER_NORMAL - SFU_PER_NORMAL
# Per unit of the rate probe, on top of nothing: its loops' SASS per unit
# (phase 10's "the loop's SASS per unit", PR 9 and PR 10 on CUDA 12.8).
# bits: all 12.0, fp32 2.03125 (the uniform's subtract, the accumulation),
# int 9.25 (INT_PER_WORD); elu: all 18.1875, fp32 11.0625 (the ELU's
# compare, selects, subtract, product, exp's range reduction and the
# accumulation), int 2.03125, sfu 1.0 (the MUFU.EX2 of expf). The elu
# loop's opcodes per unit (``cuobjdump -sass`` on CUDA 12.8): of its int,
# expf's exponent shift (SHF.L.U32 or IMAD.SHL.U32, one) is the
# function's; an IMAD.MOV.U32 (a move) and 1/32 ISETP (the loop's test)
# are not; nor are its BSSY, BRA, BSYNC (a branch around the exp), MOV
# and HFMA2.MMA (moves). The normals mode's loop holds sincosf's slow
# path, so it is modelled per normal (above) plus the accumulation's add.
PROBE_BITS_FP32, PROBE_BITS_ISSUE = 2 * 2.03125, 12.0
PROBE_ELU_FP32, PROBE_ELU_INT, PROBE_ELU_SFU = 2 * 11.0625, 1, 1
PROBE_ELU_ISSUE = 18.1875


def path_cfg(path: str, n_iter: int = None, device: str = "cuda",
             epochs: int = None, overrides=()):
    """The path's recipe; ``overrides``: CLI-style pairs on top of the
    path's own."""
    from deeppicarditeration_torch.config import default_cfg

    layers, own = PATHS[path]
    cfg = default_cfg()
    for layer in layers:
        cfg.merge(layer, allow_new=False)
    cfg.merge_from_list(list(own) + list(overrides))
    if n_iter is not None:
        cfg.PICARD.N = n_iter
    if epochs is not None:
        cfg.TRAIN.N_EPOCHS = epochs
    cfg.DEVICE = device
    return cfg.freeze()


def diffusion_cfg(epochs: int, device: str = "cuda"):
    return path_cfg("E", device=device, epochs=epochs)


def hjb_diffusion_cfg(epochs: int, device: str = "cuda"):
    return path_cfg("I", device=device, epochs=epochs)


def burgers_w1_cfg(n_iter: int, device: str = "cuda"):
    return path_cfg("A", n_iter, device)


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, reps: int) -> float:
    import torch

    from deeppicarditeration_torch.device import Timer

    fn()  # warm-up
    with Timer(torch.device("cuda")) as tm:
        for _ in range(reps):
            fn()
    return tm.ms / reps


def _in_turns(fns: dict, reps: int) -> dict:
    """ms per call of each of ``fns`` (two versions), timed in turns: a, b,
    b, a, ``reps`` calls each time; the mean of each's two turns."""
    (ka, fa), (kb, fb) = fns.items()
    ta1, tb1, tb2, ta2 = (_time_ms(fa, reps), _time_ms(fb, reps),
                          _time_ms(fb, reps), _time_ms(fa, reps))
    print(f"in turns: {ka} {ta1:.3f}, {kb} {tb1:.3f}, {kb} {tb2:.3f}, {ka} "
          f"{ta2:.3f} ms")
    return {ka: (ta1 + ta2) / 2, kb: (tb1 + tb2) / 2}


def _device_ms(fn, kernel: str, reps: int):
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, from a torch.profiler trace of ``reps`` calls of ``fn``;
    None where the trace shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0))
        if kernel in ev.key and ev.count and total:
            return total / ev.count / 1e3
    return None


@contextlib.contextmanager
def _traced_block(runner, nth: int):
    """Traces the ``nth`` block that the baselines time
    (``baselines.Timer``: an eval interval of D-DBSDE, a grid time of
    DBDP) inside ``runner.run()`` (torch.profiler, CUDA activity). Yields
    a dict that then holds the graph replays in that block (``replays``)
    and the rollout kernel's device events in its trace (``launches``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training import baselines

    seen = {"n": 0, "replays": 0, "launches": 0}
    timer = baselines.Timer

    class Traced(timer):
        def __enter__(self):
            seen["n"] += 1
            if seen["n"] == nth:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._replays = runner.graph_replays
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            if seen["n"] == nth:
                torch.cuda.synchronize()
                self._prof.__exit__(*exc)
                seen["replays"] = runner.graph_replays - self._replays
                seen["launches"] = kernels.trace_launches(
                    self._prof, kernels.ROLLOUT_KERNEL)
            return False

    baselines.Timer = Traced
    try:
        yield seen
    finally:
        baselines.Timer = timer


def _not_below(label: str, ms: float, bound_ms: float) -> None:
    """Fail where a measured time beats its bound: the bound model counts
    more work than the kernel does."""
    if not ms >= bound_ms:
        _fail(f"{label}: {ms:.4f} ms beats its bound of {bound_ms:.4f} ms")


def _same(label: str, out, ref) -> float:
    """Kernel vs plain version on the same noise; fails on a mismatch, else
    returns the max |diff|."""
    import torch

    torch.cuda.synchronize()
    err = (out - ref).abs()
    ok = bool((err <= TOL + TOL * ref.abs()).all())
    print(f"kernel vs plain ({label}): max |diff| {float(err.max()):.3e}, "
          f"within rtol=atol={TOL}: {ok}")
    if not ok or not torch.isfinite(out).all():
        _fail(f"kernel disagrees with its plain version ({label})")
    return float(err.max())


def _clt(label, out, ref, var, m, bound) -> None:
    """In-kernel draws vs torch.Generator draws: every |diff| within
    ``bound`` standard errors, and a mean squared z-score in Z2_BAND."""
    import torch

    z = (out - ref).abs() / torch.sqrt(2.0 * var / m).clamp(min=1e-12)
    zmax, z2 = float(z.max()), float((z * z).mean())
    print(f"Philox vs torch.Generator ({label}, B={out.shape[0]} M={m}): "
          f"max |diff|/SE {zmax:.2f} (bound {bound:.2f}), mean "
          f"(|diff|/SE)^2 {z2:.3f} (band {Z2_BAND})")
    if not (zmax < bound and Z2_BAND[0] <= z2 <= Z2_BAND[1]
            and torch.isfinite(out).all()):
        _fail(f"in-kernel draws disagree with the plain version's law "
              f"({label})")


def _pis_rel(out, ref):
    """max |out - ref| / max(|ref|, 1) over the value column and over the
    gradient columns."""
    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    return rel(out[:, :1], ref[:, :1]), rel(out[:, 1:], ref[:, 1:])


def _pis_same(label: str, out, ref, mode: str) -> float:
    """generate_pis vs plain on the same noise: fails unless ``_pis_rel``
    is within PIS_REL_TOL[mode] for both; returns the max |diff|."""
    import torch

    torch.cuda.synchronize()
    ev, eg = _pis_rel(out, ref)
    err = float((out - ref).abs().max())
    ok = (ev <= PIS_REL_TOL[mode] and eg <= PIS_REL_TOL[mode]
          and bool(torch.isfinite(out).all()))
    print(f"kernel vs plain ({label}): max |diff| {err:.3e}; relative "
          f"value {ev:.3e}, gradient {eg:.3e}, within {PIS_REL_TOL[mode]}: "
          f"{ok}")
    if not ok:
        _fail(f"generate_pis disagrees with its plain version ({label})")
    return err


def _permuted(sol, seed: int):
    """``sol`` with the hidden units of its PISGradNet's main stack
    permuted: the same function, whose dots sum in another order."""
    import copy

    import torch

    from deeppicarditeration_torch.models.solution import Solution

    mod = copy.deepcopy(sol.module)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for a, b in zip(mod.nn_module[:-1], mod.nn_module[1:]):
            perm = torch.randperm(a.out_features, generator=g).to(
                a.weight.device)
            a.weight.copy_(a.weight[perm])
            a.bias.copy_(a.bias[perm])
            b.weight.copy_(b.weight[:, perm])
    return Solution.from_net(mod, "Value", mod.dim)


def _check_pis(runner, n_iter: int, max_err: dict):
    """Phase 13: generate_pis at path H's shapes with ``runner``'s equation
    and trained iterate. Against its plain version on the same external
    noise (PIS_REL_TOL): the zero iterate in both modes and the iterate
    under bf16x3 at all B points, the iterate under "default" at the first
    PIS_B; there at all B, measured beside the plain version's own
    disagreement with itself when the net's hidden units are permuted.
    Its own draws against the host Philox at the first and last EDGE
    points; its law against the plain version's (CLT, 64 points). Updates
    ``max_err``; returns (eq, sol, tx, B, M)."""
    import torch

    from deeppicarditeration_torch.device import make_generator
    from deeppicarditeration_torch.models.solution import Solution
    from deeppicarditeration_torch.ops import estimators as est
    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training.picard import gen_config_from_cfg

    dev = torch.device("cuda")
    eq, sol = runner.equation, runner.u_current
    cfg = path_cfg("H", n_iter)
    gen = gen_config_from_cfg(cfg)
    nb, mm, nx = int(cfg.DATA.DATA_SIZE), gen.n_estimate_terminal, eq.nx
    tx = est.sample_tx(make_generator(dev, 40), eq, nb, gen, device=dev)
    g = torch.Generator(device=dev).manual_seed(41)
    noise = (torch.rand((nb, mm, 1), generator=g, device=dev),
             torch.randn((nb, mm, nx), generator=g, device=dev),
             torch.randn((nb, mm, nx), generator=g, device=dev))

    def pair(s, mode, b):
        """(kernel, plain) on the first b points."""
        t, n = tx[:b].contiguous(), [v[:b] for v in noise]
        return (kernels.generate_pis_cuda(0, eq, s, t, mm, *n,
                                          precision=mode),
                kernels.generate_with_gradients_plain(0, eq, s, t, mm, *n,
                                                      precision=mode))

    for label, s in (("zero iterate", Solution.zero(nx)),
                     (f"iterate {n_iter}", sol)):
        for mode in PIS_MODES:
            b = PIS_B if (mode == "default" and s.kind == "net") else nb
            key = _err_key("generate_pis", mode)
            max_err[key] = max(max_err[key], _pis_same(
                f"generate_pis {mode}, {label}, B={b} M={mm}",
                *pair(s, mode, b), mode))
    out, ref = pair(sol, "default", nb)
    perm = kernels.generate_with_gradients_plain(
        0, eq, _permuted(sol, 42), tx, mm, *noise, precision="default")
    print("generate_pis default, iterate %d, B=%d M=%d (measured): kernel "
          "vs plain, relative value %.3e, gradient %.3e; the plain version "
          "with the net's hidden units permuted vs plain %.3e, %.3e" % (
              n_iter, nb, mm, *_pis_rel(out, ref), *_pis_rel(perm, ref)))
    del noise, out, ref, perm
    pts = list(range(EDGE)) + list(range(nb - EDGE, nb))
    u_h, nt_h, ni_h = _host_draws(EXACT_SEED, pts, mm, nx, dev)
    for mode in PIS_MODES:
        key = _err_key("generate_pis", mode)
        max_err[key] = max(max_err[key], _pis_same(
            f"generate_pis {mode}, iterate {n_iter}, own draws vs host "
            f"Philox at points 0-{EDGE - 1} and {nb - EDGE}-{nb - 1}, "
            f"M={mm}",
            kernels.generate_pis_cuda(EXACT_SEED, eq, sol, tx, mm,
                                      precision=mode)[pts],
            kernels.generate_with_gradients_plain(
                0, eq, sol, tx[pts], mm, u_h, nt_h, ni_h,
                precision=mode), mode))
    del u_h, nt_h, ni_h
    out = kernels.generate_pis_cuda(5, eq, sol, tx[:64].contiguous(), mm,
                                    precision=PIS_MODES[0])
    ref, var = kernels.generate_with_gradients_plain(
        7, eq, sol, tx[:64], mm, precision=PIS_MODES[0], return_var=True)
    _clt(f"generate_pis {PIS_MODES[0]}, iterate {n_iter}", out, ref, var,
         mm, _bonferroni(64 * (1 + nx)))
    return eq, sol, tx, nb, mm


def _err_key(stem: str, mode: str) -> str:
    """max_err's key of a net kernel in a precision mode."""
    return stem if mode == "highest" else f"{stem} {mode}"


def _bonferroni(n_out: int) -> float:
    return statistics.NormalDist().inv_cdf(1 - CLT_FAMILY_P / (2 * n_out))


def _host_draws(seed, points, rows, nx, device):
    """The estimator kernels' own draws at ``points`` (rows of tx in the
    launch), from the host Philox: (u01, terminal dW, integral dW)."""
    import torch

    from deeppicarditeration_torch.ops import philox

    def dev(a):
        return torch.from_numpy(a).to(device)

    return (dev(philox.estimator_times(seed, points, rows)),
            dev(philox.estimator_normals(seed, points, rows, nx,
                                         philox.STREAM_TERMINAL)),
            dev(philox.estimator_normals(seed, points, rows, nx,
                                         philox.STREAM_INTEGRAL)))


def _problem(b, m, nx, net, seed, device):
    import torch

    from deeppicarditeration_torch.equations import make_equation
    from deeppicarditeration_torch.models.networks import MLP
    from deeppicarditeration_torch.models.solution import Solution

    g = torch.Generator().manual_seed(seed)
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    sol = Solution.zero(nx)
    if net:
        mod = MLP(1 + nx, (128,) * 4, ("ELU",) * 4, 1, generator=g)
        sol = Solution.from_net(mod.to(device), "Value", nx)
    t = torch.rand((b, 1), generator=g) * 0.99 + 0.005
    x = torch.randn((b, nx), generator=g) * t.sqrt()
    return eq, sol, torch.cat([t, x], 1).to(device)


# ---- work and bound models (per call, from the call's shapes) -------------

def _terminal_work(b, m, nx, anti):
    """The work model (FP32, INT32, SFU, bytes, bf16 tensor, other) of one
    terminal estimator call: the normals, X_T and the sums (5 FP32 FLOPs
    per sample and dimension), the sigmoid per sample; t, x, g0 in,
    (B, 1 + nx) out."""
    n = b * (m // 2 if anti else m) * nx
    return (FP32_PER_NORMAL * n + 5 * b * m * nx + 4 * b * m,
            INT_PER_NORMAL * n, SFU_PER_NORMAL * n + 2 * b * m,
            4 * (b * (2 + nx) + b * (1 + nx)), 0, OTHER_PER_NORMAL * n)


def _net_work(nx, neurons, precision):
    """(FP32, bf16 tensor) FLOPs of the frozen net's pass per sample.
    "highest": all of ``generate_flops_per_sample`` on the FP32 pipe.
    bf16x3 / "default": the layers' products (layer 1 forward and each
    hidden layer forward and backward) on the tensor pipe, 3 passes or 1;
    on the FP32 pipe the head, its gradient and the contraction with W1's
    column sums in as many products, one subtract per split A element, 3
    operations per hidden unit for bias and ELU, 1 for elu'(z) backward."""
    from deeppicarditeration_torch.ops.kernels import (
        generate_flops_per_sample,
    )

    if not neurons:
        return 0, 0
    net = generate_flops_per_sample(nx, neurons)
    if precision == "highest":
        return net, 0
    passes = 3 if precision == "bf16x3" else 1
    hidden = sum(a * c for a, c in zip(neurons, neurons[1:]))
    mm = 2 * ((1 + nx) * neurons[0] + 2 * hidden)
    split = (1 + nx) + 2 * sum(neurons[1:])
    epilogue = 3 * sum(neurons) + sum(neurons[:-1])
    return passes * (net - mm) + split + epilogue, passes * mm


def _integral_work(b, m, nx, anti, neurons, n_weights, precision="highest"):
    """The same for one integral estimator call: normals and the time
    uniforms, X_s and the sums (4 FP32 per sample and dimension), the net's
    forward and backward pass (``_net_work``), an exp per hidden unit
    (ELU), ~10 FP32 and 2 special functions per sample; t, x, f0 and the
    weights in, (B, 1 + nx) out."""
    rows = m // 2 if anti else m
    n, n_u = b * rows * nx, b * rows
    net_fp32, net_tensor = _net_work(nx, neurons, precision)
    return (FP32_PER_NORMAL * n + n_u + b * m * (net_fp32 + 4 * nx + 10),
            INT_PER_NORMAL * n + INT_PER_WORD * n_u,
            SFU_PER_NORMAL * n + b * m * (2 + sum(neurons)),
            4 * (b * (2 + nx) + n_weights + b * (1 + nx)),
            b * m * net_tensor, OTHER_PER_NORMAL * n)


def _merged_work(b, m, nx, anti, neurons, n_weights, precision="highest"):
    t = _terminal_work(b, m, nx, anti)
    i = _integral_work(b, m, nx, anti, neurons, n_weights, precision)
    w = [a + c for a, c in zip(t, i)]
    w[3] = i[3] + 4 * b
    return tuple(w)


def _pis_work(b, m, nx, hidden, ncomp, n_weights, precision):
    """(FP32, INT32, SFU, bytes, bf16 tensor) of one generate_pis call.
    Terminal chain: the normals, X_T (2 FP32 per dimension), the mixture's
    terms per component (3 FP32 and a reciprocal per dimension), the
    gradient sums (2). With a net (``hidden``), besides: the integral
    normals and time uniform, X_s (2), the mixture at e^{-lambda/2} X_s
    and its gradient (twice the terms), w, the drift and |w|^2 (6), the
    sums (2) per dimension; per sample the embedding's sin and cos (20
    FP32 each, the precise functions on the FP32 pipe) and an exp per
    hidden unit of the gate, the encoder and the net (ELU); the products
    (``generate_pis_macs_per_sample``) on the tensor pipe, 3 passes or 1.
    t, x, g0, f0, the packed weights and the mixture in, (B, 1 + nx) out."""
    from deeppicarditeration_torch.ops.kernels import (
        generate_pis_macs_per_sample,
    )

    n, s = b * m * nx, b * m
    fp32 = FP32_PER_NORMAL * n + n * (4 + 3 * ncomp) + s * (2 * ncomp + 4)
    int_ops = INT_PER_NORMAL * n
    other = OTHER_PER_NORMAL * n
    sfu = SFU_PER_NORMAL * n + n * ncomp + s * (ncomp + 1)
    tensor, w_bytes = 0, 0
    if hidden:
        c = 64
        fp32 += (FP32_PER_NORMAL * n + n * (10 + 6 * ncomp)
                 + s * (40 * c + 2 * ncomp + 10))
        int_ops += INT_PER_NORMAL * n + INT_PER_WORD * s
        other += OTHER_PER_NORMAL * n
        sfu += (SFU_PER_NORMAL * n + 2 * n * ncomp
                + s * (c * (len(hidden) + 2) + sum(hidden) + ncomp + 1))
        passes = 3 if precision == "bf16x3" else 1
        tensor = passes * 2 * s * generate_pis_macs_per_sample(nx, hidden)
        w_bytes = n_weights * (4 if precision == "bf16x3" else 2)
    return (fp32, int_ops, sfu,
            4 * (b * (4 + nx) + b * (1 + nx) + 2 * ncomp * (nx + 1))
            + w_bytes, tensor, other)


def _normals_work(n):
    return (FP32_PER_NORMAL * n, INT_PER_NORMAL * n, SFU_PER_NORMAL * n,
            4 * n, 0, OTHER_PER_NORMAL * n)


def _rollout_work(K, b, nx):
    """One rollout: K B nx normals; per normal a product and two sums; x0
    (and the step scales) in, xs (K+1, B, nx) and xi (K, B, nx) out."""
    n = K * b * nx
    return ((FP32_PER_NORMAL + 2 * 3) * n, INT_PER_NORMAL * n,
            SFU_PER_NORMAL * n, 4 * ((2 * K + 1) * b * nx + b * nx + b), 0,
            OTHER_PER_NORMAL * n)


def _probe_work(which, units, grid):
    """One probe call of ``units`` units: the mode's draw or ELU chain plus
    the accumulation; the (grid * 8, 128) partial sums out."""
    n_bytes = 4 * grid * 8 * 128
    if which == "bits":
        return (PROBE_BITS_FP32 * units, INT_PER_WORD * units, 0, n_bytes, 0,
                (PROBE_BITS_ISSUE - PROBE_BITS_FP32 / 2 - INT_PER_WORD)
                * units)
    if which == "normals":
        return ((FP32_PER_NORMAL + 2) * units, INT_PER_NORMAL * units,
                SFU_PER_NORMAL * units, n_bytes, 0, OTHER_PER_NORMAL * units)
    return (PROBE_ELU_FP32 * units, PROBE_ELU_INT * units,
            PROBE_ELU_SFU * units, n_bytes, 0,
            (PROBE_ELU_ISSUE - PROBE_ELU_FP32 / 2 - PROBE_ELU_INT
             - PROBE_ELU_SFU) * units)


def _issue(work) -> float:
    """Instructions of a work model that the ISSUE limit counts: the
    function's own arithmetic on the FP32, INT32 and SFU pipes, without
    the loop, address and move instructions of one implementation."""
    fp32, int_ops, sfu = work[:3]
    return fp32 / 2 + int_ops + sfu


def _sass_issue_ms(work) -> float:
    """ms that the schedulers take to issue every instruction of the
    kernel's SASS in the work model, its overhead (``other``) included:
    where the kernel stands against its own instruction stream."""
    return (_issue(work) + work[5]) / PEAK_ISSUE * 1e3


def _bound(work):
    """(bound ms, "bytes" | "operations", binding pipe): the larger of the
    bytes over HBM3's rate and the busiest pipe's operations over its
    rate (the pipes run side by side; TENSOR: bf16 wgmma; ISSUE: the
    function's instructions on every pipe, ``_issue``, over the
    schedulers' 128 a clock and SM)."""
    fp32, int_ops, sfu, n_bytes, tensor, _ = work
    t = {"FP32": fp32 / PEAK_FP32_FLOPS, "INT32": int_ops / PEAK_INT32_OPS,
         "SFU": sfu / PEAK_SFU_OPS, "TENSOR": tensor / PEAK_BF16_TENSOR,
         "ISSUE": _issue(work) / PEAK_ISSUE}
    pipe = max(t, key=t.get)
    t_bytes = n_bytes / PEAK_BYTES_S
    if t_bytes > t[pipe]:
        return t_bytes * 1e3, "bytes", "HBM"
    return t[pipe] * 1e3, "operations", pipe


# ---- paths -----------------------------------------------------------------

def _run_path(path: str, n_iter: int, overrides=()):
    """Run one path (``overrides`` on top of its recipe, as in
    ``path_cfg``); returns (runner, {library name: launches})."""
    import torch

    from deeppicarditeration_torch.ops import estimators as est
    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training.picard import (
        FUSED,
        PicardRunner,
        fit_route,
    )

    cfg = path_cfg(path, n_iter, overrides=overrides)
    runner = PicardRunner(cfg, exp_root=ROOT / "build" / "chip_smoke_runs"
                          / path)
    for lib in kernels.ALL:
        lib.launches = 0
        lib.mode_launches.clear()
    for route in est.route_calls:
        est.route_calls[route] = 0
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.source.stem: lib.launches for lib in kernels.ALL}
    modes = {lib.source.stem: dict(lib.mode_launches) for lib in kernels.ALL
             if lib.mode_launches}
    routes = dict(est.route_calls)
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    final = {}
    for r in rows:
        if r["context"] == "eval":
            final[int(r["iter"])] = r
    for tm in runner.timings:
        ev = final.get(tm["iter"], {})
        print(f"path {path} iteration {tm['iter']}: generate "
              f"{tm['generate_ms']:.1f} ms, fit {tm['fit_ms']:.1f} ms, "
              f"rRMSE {ev.get('rRMSE')}, rRMSEg {ev.get('rRMSEg')}")
    steps = int(cfg.DATA.DATA_SIZE) // int(cfg.TRAIN.BATCH_SIZE)
    fused = fit_route(cfg, steps, True)[0] == FUSED
    replays = n_iter * int(cfg.TRAIN.N_EPOCHS) if fused else 0
    print(f"path {path}: {n_iter} iterations in {wall:.1f} s; generation "
          f"calls {runner.generate_calls}, by the route taken {routes}; "
          f"launches {launches}, by precision {modes}; fit CUDA-graph "
          f"replays {runner.graph_replays} (one per epoch: {replays})")
    if runner.graph_replays != replays:
        _fail(f"path {path}: {runner.graph_replays} graph replays, want "
              f"{replays}")
    steady = [tm for tm in runner.timings if tm["iter"] > 1]
    if len(steady) >= 2:
        for key in ("generate_ms", "fit_ms"):
            v = [tm[key] for tm in steady]
            q = statistics.quantiles(v, n=4)
            print(f"path {path} steady state (iterations 2-{n_iter}): {key} "
                  f"median {statistics.median(v):.1f}, quartiles "
                  f"{q[0]:.1f}-{q[2]:.1f}")
    curve = [final[i]["rRMSE"] for i in sorted(final)]
    from deeppicarditeration_torch.evaluation.evaluator import eval_solution

    m = eval_solution(torch.Generator(device=runner.device).manual_seed(1234),
                      runner.u_current, runner.equation, FINAL_EVAL_POINTS,
                      test_grad=True)
    print(f"path {path} iterate {n_iter} on {FINAL_EVAL_POINTS} points "
          f"(the JAX records' post-iteration eval): rRMSE {m['rRMSE']}, "
          f"rRMSEg {m['rRMSEg']}")
    if curve:
        last = final[max(final)]
        print(f"path {path} final rRMSE {last['rRMSE']}, rRMSEg "
              f"{last['rRMSEg']}; mean rRMSE of the last "
              f"{min(10, len(curve))} iterations "
              f"{statistics.mean(curve[-10:])}")
    for i in range(1, n_iter + 1):
        r = final.get(i, {}).get("rRMSE")
        limit = _rrmse_limit(path, i)
        if r is None or not math.isfinite(r) or r > limit:
            _fail(f"path {path} iteration {i} rRMSE {r} (want finite and "
                  f"<= {limit})")
    return runner, launches, (routes, modes)


def _rrmse_limit(path: str, i: int) -> float:
    """Path ``path``'s rRMSE limit at iteration i."""
    if path in ("H", "J"):
        return HJB_RRMSE_MAX[min(i, len(HJB_RRMSE_MAX)) - 1]
    if path in ("K", "L"):
        return FN_RRMSE_MAX[min(i, len(FN_RRMSE_MAX)) - 1]
    return RRMSE_MAX


def _captured_vs_loop(runner_a, runner_l, n_iter: int) -> None:
    """Phase 4's comparison: path A (the fit as CUDA-graph replays) against
    A' (the loop). Fails unless A's rRMSE at every iteration is within
    FUSED_RRMSE_REL of A''s; prints both fits' steady-state ms and
    iteration 1's relative difference by segment (the same dataset)."""
    rows = {}
    for key, runner in (("A", runner_a), ("A'", runner_l)):
        rows[key] = [json.loads(ln) for ln in (
            runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    seg1 = {k: [r for r in v if r["context"] in ("train", "eval")
                and r["iter"] == 1] for k, v in rows.items()}
    rel = [max(abs(a[m] - b[m]) / abs(b[m]) for m in (
        ("train_loss",) if a["context"] == "train" else ("rRMSE", "rRMSEg")))
        for a, b in zip(seg1["A"], seg1["A'"])]
    print(f"captured vs loop, iteration 1 (the same dataset), relative "
          f"difference by segment (train loss; eval rRMSE, rRMSEg): "
          + ", ".join(f"{v:.3e}" for v in rel))
    fit_a, fit_l = (statistics.median(tm["fit_ms"] for tm in r.timings
                                      if tm["iter"] > 1) if n_iter > 1
                    else None for r in (runner_a, runner_l))
    print(f"fit ms per iteration, steady state (median of iterations "
          f"2-{n_iter}): captured (A) {fit_a}, loop (A') {fit_l}")
    for i in range(1, n_iter + 1):
        a, b = ([r["rRMSE"] for r in rows[k] if r["context"] == "eval"
                 and r["iter"] == i][-1] for k in ("A", "A'"))
        print(f"iteration {i}: rRMSE captured {a}, loop {b}, relative "
              f"difference {abs(a - b) / b:.3e}")
        if not abs(a - b) <= FUSED_RRMSE_REL * b:
            _fail(f"path A's rRMSE at iteration {i} ({a}) is not within "
                  f"{FUSED_RRMSE_REL:.0%} of path A''s ({b})")


def _path_e_inputs(eq, b, K, dt, seed, device):
    """t0 ~ U(0, T), x0 ~ law(X_t0) and the tail-shrunk steps, as the
    D-DBSDE baseline draws them."""
    import torch

    from deeppicarditeration_torch.training.baselines import rollout_dts

    g = torch.Generator(device=device).manual_seed(seed)
    t0 = eq.T * torch.rand((b, 1), generator=g, device=device)
    x0 = eq.sample_x(g, t0)
    return x0.contiguous(), rollout_dts(eq, t0, dt, K).sqrt().contiguous()


def _rollout_vs_host(x0, sdt, a: float, K: int):
    """The rollout kernel's own draws against the host Philox, its paths
    against the plain version fed those draws, and the increment relation;
    returns (xs, xi, the largest |diff|)."""
    import torch

    from deeppicarditeration_torch.ops import kernels, philox

    b, nx = x0.shape
    xs, xi = kernels.paths_cuda(EXACT_SEED, x0, sdt, a, K)
    torch.cuda.synchronize()
    host = torch.from_numpy(philox.path_normals(EXACT_SEED, K, b, nx)).to(
        x0.device)
    ref, _ = kernels.paths_plain(0, x0, sdt, a, K, host)
    steps = sdt[None] * a * xi
    errs = {"xi vs host Philox": (xi, host), "xs vs plain on the host "
            "draws": (xs, ref), "increments": (xs[1:] - xs[:-1], steps)}
    worst = 0.0
    for label, (out, want) in errs.items():
        err = (out - want).abs()
        ok = bool((err <= PATH_TOL + PATH_TOL * want.abs()).all())
        print(f"rollout kernel K={K} B={b} nx={nx} ({label}): max |diff| "
              f"{float(err.max()):.3e}, within rtol=atol={PATH_TOL}: {ok}")
        if not ok or not torch.isfinite(out).all():
            _fail(f"the rollout kernel disagrees ({label})")
        worst = max(worst, float(err.max()))
    return xs, xi, worst


def _rollout_table_in_graph(x0, sdt, a: float, K: int) -> float:
    """The rollout kernel with its seed from a ``SeedTable``, captured once
    in a CUDA graph and replayed 3 times: each replay's draws against the
    host Philox at that replay's seed, its paths against the plain version
    on those draws; returns the largest |diff|."""
    import torch

    from deeppicarditeration_torch.ops import kernels, philox

    b, nx = x0.shape
    seeds = [EXACT_SEED, 20261017, (1 << 64) - 11]
    table = kernels.SeedTable(len(seeds), x0.device)
    table.fill(seeds)
    kernels.paths_cuda(table, x0, sdt, a, K)  # eager: builds and warms
    table.fill(seeds)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xs, xi = kernels.paths_cuda(table, x0, sdt, a, K)
    worst = 0.0
    for i, seed in enumerate(seeds):
        graph.replay()
        torch.cuda.synchronize()
        host = torch.from_numpy(philox.path_normals(seed, K, b, nx)).to(
            x0.device)
        ref, _ = kernels.paths_plain(0, x0, sdt, a, K, host)
        for label, out, want in (("xi", xi, host), ("xs", xs, ref)):
            err = (out - want).abs()
            if not bool((err <= PATH_TOL + PATH_TOL * want.abs()).all()):
                _fail(f"the rollout kernel in a graph, replay {i} (seed "
                      f"table entry {i}): {label} off by "
                      f"{float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
    if int(table.index[0]) != len(seeds):
        _fail(f"the seed table's index is {int(table.index[0])} after "
              f"{len(seeds)} replays")
    print(f"rollout kernel K={K} B={b} nx={nx}, seed from a table, one "
          f"capture replayed {len(seeds)} times: each replay = the host "
          f"Philox at its entry and the plain paths, max |diff| "
          f"{worst:.3e}; the index advanced in the graph to "
          f"{int(table.index[0])}")
    return worst


def _rollout_ragged(K: int, device, seed: int = 27) -> float:
    """The rollout kernel at B = 511, nx = 7 (columns a multiple of neither
    the 32-column tile nor 4: element stores) against the host Philox and
    the plain version; returns the largest |diff|."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x0 = torch.randn((511, 7), generator=g, device=device)
    sdt = torch.rand((511, 1), generator=g, device=device) * 0.2
    _, _, worst = _rollout_vs_host(x0, sdt.contiguous(), 1.3, K)
    return worst


def _rollout_times(x0, sdt, a: float, K: int):
    """(back-to-back ms, device ms) per launch of the rollout kernel at
    (K, B, nx), each launch writing the next of four output pairs, so that
    it writes lines L2 does not hold (as after the rest of an epoch)."""
    import torch

    from deeppicarditeration_torch.ops import kernels

    b, nx = x0.shape
    outs = [(torch.empty((K + 1, b, nx), device=x0.device),
             torch.empty((K, b, nx), device=x0.device)) for _ in range(4)]
    turn = [0]

    def launch():
        turn[0] += 1
        return kernels.paths_cuda(5, x0, sdt, a, K, out=outs[turn[0] % 4])

    return _time_ms(launch, 200), _device_ms(launch, "paths_kernel", 200)


def _check_epoch_draws(path: str, epochs: int = 3) -> None:
    """The D-DBSDE epoch's draws as its graph takes them (t0, x0, xT from
    the registered per-epoch generators, the paths from the seed table)
    against the eager draws of the same epochs, bit for bit."""
    import torch

    from deeppicarditeration_torch.device import derive_seed
    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training import baselines
    from deeppicarditeration_torch.training.fused import FusedStep
    from deeppicarditeration_torch.training.picard import PicardRunner
    from deeppicarditeration_torch.training.trainer import reset_optimizer

    runner = PicardRunner(path_cfg(path, epochs=epochs),
                          exp_root=ROOT / "build" / "chip_smoke_runs"
                          / f"{path}_draws")
    runner.i = 1
    tw = float(runner.cfg.TRAIN.LOSS.beta)
    gens = baselines.epoch_generators(runner)
    seeds = kernels.SeedTable(epochs, runner.device)
    seeds.fill([derive_seed(runner.seed, 1, e, baselines.PATHS)
                for e in range(epochs)])
    mod = torch.nn.Linear(1, 1).to(runner.device)
    opt = torch.optim.Adam(mod.parameters(), capturable=True)
    reset_optimizer(opt)
    step = FusedStep(lambda: [v.clone() for v in baselines.diffusion_inputs(
        runner, gens, seeds, tw) if v is not None], {}, mod, opt,
        generators=list(gens.values()), state=[seeds.index])
    for epoch in range(epochs):
        baselines.seed_epoch(runner, gens, epoch)
        got = step()
        want = [v for v in baselines.diffusion_draws(runner, epoch, tw)
                if v is not None]
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, want)):
            _fail(f"path {path}: the epoch graph's draws differ from the "
                  f"eager draws at epoch {epoch}")
    print(f"path {path}: the epoch's draws in its graph (dts, ts, xs"
          f"{', xT' if tw > 0 else ''}) = the eager draws, bit for bit, "
          f"over {epochs} replays")


def _dbdp_rollout_inputs(device, seed: int = 25):
    """x0 (B, nx) ~ N(0, 4 I) (path N's law; path M starts at 0) and the
    constant step sqrt(dt) of the DBDP recipes' paths."""
    import torch

    K, b, nx = DBDP_ROLLOUT
    g = torch.Generator(device=device).manual_seed(seed)
    x0 = 2.0 * torch.randn((b, nx), generator=g, device=device)
    return x0, torch.full((b, 1), math.sqrt(0.02), device=device), K


def _normals_vs_host(shape, device) -> float:
    """The normals kernel at ``shape`` against the host Philox, value for
    value, at the head and the end of the buffer, and its mean and variance
    over the buffer (z-scores); returns the largest |diff|."""
    import torch

    from deeppicarditeration_torch.ops import kernels, philox

    v = kernels.normals_cuda(EXACT_SEED, shape, device).reshape(-1)
    n = v.numel()
    worst = 0.0
    for start in (0, n - NORMALS_CHECK):
        ref = torch.from_numpy(philox.normals_flat(
            EXACT_SEED, start, NORMALS_CHECK)).to(device)
        err = (v[start:start + NORMALS_CHECK] - ref).abs()
        ok = bool((err <= DRAW_TOL + DRAW_TOL * ref.abs()).all())
        print(f"normals kernel at {tuple(shape)} vs host Philox at flat "
              f"indices {start}-{start + NORMALS_CHECK - 1}: max |diff| "
              f"{float(err.max()):.3e}, within rtol=atol={DRAW_TOL}: {ok}")
        if not ok:
            _fail("the normals kernel's values differ from the host "
                  "Philox's")
        worst = max(worst, float(err.max()))
    x = v.double()
    zm = float(x.mean()) * math.sqrt(n)
    zv = (float(x.var()) - 1.0) / math.sqrt(2.0 / n)
    print(f"normals kernel at {tuple(shape)}: mean z-score {zm:.2f}, "
          f"variance z-score {zv:.2f} (bound {CLT_SIGMAS})")
    if abs(zm) > CLT_SIGMAS or abs(zv) > CLT_SIGMAS or not torch.isfinite(
            v).all():
        _fail(f"the normals kernel's law at {tuple(shape)} is off")
    return worst


def _check_rollout_dbdp(device) -> float:
    """Phase 16: the rollout kernel at the DBDP recipes' shapes (K = 50,
    B = 512, nx = 100, one step size); returns the largest |diff|."""
    import torch

    x0, sdt, K = _dbdp_rollout_inputs(device)
    xs, _, worst = _rollout_vs_host(x0, sdt, 1.0, K)
    if not torch.equal(xs[0], x0):
        _fail("rollout at DBDP's shapes: xs[0] != x0")
    worst = max(worst, _rollout_ragged(K, device),
                _rollout_table_in_graph(x0, sdt, 1.0, K))
    return worst


def _captured_dbdp_vs_eager(path: str = "M", sub_iter: int = 10):
    """Phase 18: path M's DBDP sub-iterations as graph replays of the
    static working pair (``CapturedPairFit``) against the per-pair eager
    loop (``EagerPairFit``) on the same seeds: the terminal pre-fit and
    grid times K and K - 1 (the warm start between), ``sub_iter``
    sub-iterations each, at the recipe's shapes. Every pair's parameters
    within DBDP_CAPTURED_REL of the largest |parameter|. Returns that
    relative difference and, measured only, the one from the eager loop
    whose Adams keep the step count and bias correction on the host."""
    import torch

    from deeppicarditeration_torch.training import baselines
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = path_cfg(path, overrides=["METHOD.num_sub_iter", str(sub_iter)])
    nets = {}
    for name, make in (
            ("eager", baselines.EagerPairFit),
            ("captured", baselines.CapturedPairFit),
            ("eager, host bias correction",
             lambda sw, nets: baselines.EagerPairFit(sw, nets, False))):
        runner = PicardRunner(cfg, exp_root=ROOT / "build"
                              / "chip_smoke_runs"
                              / f"{path}_{name.split(',')[0]}")
        runner.i = 1
        sw = baselines.DBDPSweep(runner)
        nets[name] = baselines.init_dbdp_nets(runner, sw.K)
        fit = make(sw, nets[name])
        for kk in (sw.K + 1, sw.K, sw.K - 1):
            if kk < sw.K:
                nets[name].copy_pair(kk, kk - 1)
            fit(0, kk)
        torch.cuda.synchronize()
        if name == "captured" and runner.graph_replays != 3 * sub_iter:
            _fail(f"captured DBDP: {runner.graph_replays} replays, want "
                  f"{3 * sub_iter}")
    with torch.no_grad():
        flat = {name: torch.cat([p.reshape(-1) for p in n.parameters()])
                for name, n in nets.items()}
        b = flat["eager"]
        rel = float((flat["captured"] - b).abs().max() / b.abs().max())
        b = flat["eager, host bias correction"]
        rel_host = float((flat["captured"] - b).abs().max() / b.abs().max())
    print(f"path {path}: captured DBDP (pre-fit, grid times K, K - 1, "
          f"{sub_iter} sub-iterations each, one replay each) vs the eager "
          f"per-pair loop on the same seeds, both with capturable Adams: "
          f"max |diff| / max |param| {rel:.3e} (limit {DBDP_CAPTURED_REL}); "
          f"vs the eager loop with the host's f64 bias correction "
          f"(measured, not gated): {rel_host:.3e}")
    if not rel <= DBDP_CAPTURED_REL:
        _fail(f"captured DBDP differs from the eager loop by {rel:.3e}")
    return rel, rel_host


def _run_dbdp(path: str, sub_iter):
    """Phase 17: path M or N (the DBDP recipes) through the CLI's runner,
    every grid time's sub-iterations cut to ``sub_iter`` ("recipe": the
    recipe's own); returns (runner, launches, median ms per
    sub-iteration, the final grid rRMSE)."""
    import torch

    from deeppicarditeration_torch.models.factory import is_enforce_terminal
    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training.fused import WARMUP
    from deeppicarditeration_torch.training.picard import PicardRunner

    own = ([] if sub_iter == "recipe"
           else ["METHOD.num_sub_iter", str(sub_iter)])
    cfg = path_cfg(path, overrides=own)
    n_sub = int(cfg.METHOD.num_sub_iter)
    runner = PicardRunner(cfg, exp_root=ROOT / "build" / "chip_smoke_runs"
                          / path)
    for lib in kernels.ALL:
        lib.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with _traced_block(runner, 3) as traced:
        runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launches = {lib.source.stem: lib.launches for lib in kernels.ALL}
    K = round(runner.equation.T / float(cfg.METHOD.dt))
    prefit = not is_enforce_terminal(cfg)
    want_roll = K * n_sub + (n_sub if prefit else 0)
    # a sub-iteration is one replay with the rollout inside; the wrapper
    # counts only each graph's (the pre-fit's, the interior steps')
    # WARMUP eager warm-up calls
    graphs = len(runner.fused_steps)
    want = {name: (WARMUP * graphs if name == "rollout" else 0)
            for name in launches}
    if (launches != want or runner.rollout_calls != want_roll
            or runner.graph_replays != want_roll
            or graphs != (2 if prefit else 1)):
        _fail(f"path {path}: launches {launches}, rollouts "
              f"{runner.rollout_calls}, graph replays "
              f"{runner.graph_replays} of {graphs} graphs; want {want} and "
              f"{want_roll} replays (K={K} x {n_sub} sub-iterations"
              f"{' + the terminal pre-fit' if prefit else ''})")
    _one_per_replay(path, "the third grid time", traced, n_sub)
    per_sub = [tm["ms"] / tm["sub_iters"] for tm in runner.timings
               if tm["k"] <= K]
    q = statistics.quantiles(per_sub, n=4)
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in rows if r["context"] == "eval"]
    print(f"path {path}: K={K} x {n_sub} sub-iterations in {wall:.1f} s, "
          f"{runner.graph_replays} graph replays of {graphs} graphs; "
          f"eager launches {launches}; ms per sub-iteration (CUDA events "
          f"per grid time, the third traced) median {statistics.median(per_sub):.3f}, quartiles "
          f"{q[0]:.3f}-{q[2]:.3f}, first grid time {per_sub[0]:.3f}; peak "
          f"memory {peak:.2f} GiB above what was held before")
    step = max(1, len(evals) // 10)
    print(f"path {path} grid rRMSE by grid time k: " + ", ".join(
        f"{K - j}: {r['rRMSE']:.4f}" for j, r in
        list(enumerate(evals))[step - 1::step]))
    r = evals[-1]["rRMSE"]
    ref = "0.0278" if path == "M" else "0.068-0.0684"
    print(f"path {path} final grid rRMSE {r} (the JAX records at the "
          f"recipe's budget: {ref})")
    limit = (DBDP_RRMSE_MAX_RECIPE if sub_iter == "recipe"
             else DBDP_RRMSE_MAX)[path]
    if r is None or not math.isfinite(r) or r > limit:
        _fail(f"path {path} final grid rRMSE {r} (want finite and <= "
              f"{limit})")
    return runner, launches, statistics.median(per_sub), r, traced


def _one_per_replay(path: str, block: str, traced: dict, replays: int):
    """Fail unless the traced block held ``replays`` graph replays and one
    rollout kernel event in the trace for each."""
    print(f"path {path}: {block} traced: {traced['replays']} graph "
          f"replays, {traced['launches']} rollout kernel events "
          f"(torch.profiler)")
    if not traced["replays"] == traced["launches"] == replays:
        _fail(f"path {path}: {block} held {traced['replays']} graph "
              f"replays and {traced['launches']} rollout kernel events; "
              f"want {replays} of each")


def _check_rollout(cfg, device) -> float:
    """Phase 8: the rollout kernel at path E's shapes; returns the max
    |diff| against the host Philox's draws and the plain paths."""
    import torch

    from deeppicarditeration_torch.equations import make_equation
    from deeppicarditeration_torch.ops import kernels

    K, b, dt = int(cfg.METHOD.K), int(cfg.TRAIN.BATCH_SIZE), float(
        cfg.METHOD.dt)
    eq = make_equation(cfg.EQUATION.cls, **cfg.EQUATION.kwargs)
    a = eq.alpha_sqrt
    x0, sdt = _path_e_inputs(eq, b, K, dt, 21, device)
    full_step = torch.full_like(sdt, dt).sqrt()
    n_full = int((sdt == full_step).sum())
    n_short = int((sdt < full_step).sum())
    xs, xi, worst = _rollout_vs_host(x0, sdt, a, K)
    if not torch.equal(xs[0], x0) or not (n_full and n_short
                                          and n_full + n_short == b):
        _fail(f"rollout: xs[0] != x0, or not a mix of full and tail-shrunk "
              f"steps ({n_full} full, {n_short} shorter)")
    xs_b, xi_b = kernels.paths_cuda(EXACT_SEED, x0[:100].contiguous(),
                                    sdt[:100].contiguous(), a, K)
    if not (torch.equal(xi_b, xi[:, :100]) and torch.equal(xs_b,
                                                           xs[:, :100])):
        _fail("the rollout kernel's values depend on B")
    print(f"rollout kernel: xs[0] = x0; {n_full} rows with the full step, "
          f"{n_short} tail-shrunk; the same values at B=100 and B={b}")
    worst = max(worst, _rollout_ragged(K, device),
                _rollout_table_in_graph(x0, sdt, a, K))
    # the endpoint's law: (X_K - x0) / (sqrt(alpha) sqrt(K dt_b)) ~ N(0, 1)
    x0, sdt = _path_e_inputs(eq, LAW_ROWS, K, dt, 22, device)
    xs, _ = kernels.paths_cuda(23, x0, sdt, a, K)
    z = ((xs[-1] - x0) / (a * sdt * math.sqrt(K))).double().reshape(-1)
    n = z.numel()
    zm, zv = float(z.mean()) * math.sqrt(n), (float(z.var()) - 1.0) / \
        math.sqrt(2.0 / n)
    print(f"rollout kernel endpoint over {n} draws: mean z-score {zm:.2f}, "
          f"variance z-score {zv:.2f} (bound {CLT_SIGMAS})")
    if abs(zm) > CLT_SIGMAS or abs(zv) > CLT_SIGMAS:
        _fail("the rollout kernel's endpoint law is off")
    return worst


def _run_diffusion(epochs: int, path: str = "E"):
    """Phases 9 and 14: path E or I through the CLI's runner; returns
    (runner, launches, ms per epoch)."""
    import torch

    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.training.fused import WARMUP
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = path_cfg(path, epochs=epochs)
    limit = DIFFUSION_RRMSE_MAX if path == "E" else HJB_DIFFUSION_RRMSE_MAX
    runner = PicardRunner(cfg, exp_root=ROOT / "build" / "chip_smoke_runs"
                          / path)
    for lib in kernels.ALL:
        lib.launches = 0
    t0 = time.perf_counter()
    with _traced_block(runner, 2) as traced:
        runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {lib.source.stem: lib.launches for lib in kernels.ALL}
    # the rollout inside the epoch's graph: the wrapper counts the
    # capture's warm-up calls, the only eager launches
    want = {name: (WARMUP if name == "rollout" else 0)
            for name in launches}
    if (launches != want or runner.rollout_calls != epochs
            or runner.graph_replays != epochs
            or len(runner.fused_steps) != 1):
        _fail(f"path {path}: launches {launches}, rollouts "
              f"{runner.rollout_calls}, graph replays "
              f"{runner.graph_replays}; want {want} and {epochs} replays of "
              f"one graph")
    _one_per_replay(path, "the second eval interval", traced,
                    int(cfg.EVAL.FREQ))
    per_epoch = [tm["interval_ms"] / tm["epochs"] for tm in runner.timings]
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in rows if r["context"] == "eval"]
    q = statistics.quantiles(per_epoch, n=4)
    print(f"path {path}: {epochs} epochs in {wall:.1f} s; eager launches "
          f"{launches}; ms per epoch (CUDA events per {cfg.EVAL.FREQ}-epoch "
          f"interval, the second traced) median {statistics.median(per_epoch):.3f}, quartiles "
          f"{q[0]:.3f}-{q[2]:.3f}, first interval {per_epoch[0]:.3f}; "
          f"epochs total {sum(tm['interval_ms'] for tm in runner.timings):.0f}"
          f" ms")
    step = max(1, len(evals) // 10)
    print(f"path {path} rRMSE by epoch: " + ", ".join(
        f"{r['step'] + 1}: {r['rRMSE']:.4f}" for r in evals[step - 1::step]))
    last = evals[-1]
    ref = (f"the eager epoch at {DIFFUSION_EPOCHS} epochs: "
           f"{DIFFUSION_RRMSE_EAGER}; JAX records after 35000 epochs: "
           f"0.0894-0.0981 / 0.221-0.227" if path == "E" else
           "JAX records after 15000 epochs: 0.0732-0.1043 / 0.447-0.585")
    print(f"path {path} final rRMSE {last['rRMSE']}, rRMSEg {last['rRMSEg']} "
          f"({ref}); {runner.graph_replays} epochs as CUDA-graph replays")
    r = last["rRMSE"]
    if r is None or not math.isfinite(r) or r > limit:
        _fail(f"path {path} final rRMSE {r} (want finite and <= {limit})")
    return runner, launches, statistics.median(per_epoch), traced


def _expect_launches(path, runner, launches, seen, want):
    """Fail unless every kernel launched exactly ``want`` times (0 where not
    named), the net kernels all in the path's precision mode, and the
    dispatch took the path's route for every generation call."""
    from deeppicarditeration_torch.ops import estimators as est
    from deeppicarditeration_torch.training.picard import gen_config_from_cfg

    routes, modes = seen
    full = {name: want.get(name, 0) for name in launches}
    mode = gen_config_from_cfg(runner.cfg).pallas_precision
    want_modes = {name: {mode: n} for name, n in full.items()
                  if n and name in ("generate", "integral", "generate_pis")}
    route = (est.MERGED if path in ("A", "A'", "D", "F", "H", "J")
             else est.SPLIT)
    want_routes = {r: runner.generate_calls if r == route else 0
                   for r in routes}
    if (launches != full or runner.generate_calls == 0
            or routes != want_routes or modes != want_modes):
        _fail(f"path {path}: launches {launches}, by precision {modes}, "
              f"want {full}, {want_modes}; routes {routes}, want "
              f"{want_routes}")


def _hgmma_counts():
    """(HGMMA, WARPGROUP.DEPBAR) instructions in the SASS of the
    tensor-core kernels (``cuobjdump -sass`` of the built libraries, all
    instantiations), by kernel. A DEPBAR waits for wgmma to finish: one
    per slab group is the design, one per HGMMA a serialised pass."""
    import re

    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.utils.probe_roofline import library_sass

    out = {}
    for lib, fn in ((kernels.GENERATE, "generate_tc_kernel"),
                    (kernels.INTEGRAL, "integral_tc_kernel"),
                    (kernels.GENERATE_PIS, "generate_pis_kernel")):
        sass = library_sass(lib)
        body = [part for part in re.split(r"\n\s*Function : ", sass)
                if part.split("\n", 1)[0].find(fn) >= 0]
        out[fn] = (sum(part.count("HGMMA") for part in body),
                   sum(part.count("WARPGROUP.DEPBAR") for part in body))
    return out


def _elu_abs_sums(seed, grid, iters, dev):
    """The elu probe's (grid * 8, 128) sums of |term| over every term each
    partial sum adds: iters times those of iteration 0's units (the shift
    acc * 1e-30 is below f32 resolution for any x0 the draw gives)."""
    import torch

    from deeppicarditeration_torch.ops import philox

    rows, lanes = philox.PROBE_ROWS, philox.LANES
    x = torch.from_numpy(philox.probe_units(seed, "normals", grid, 1)).to(
        dev).reshape(grid, rows, philox.PROBE_BLK // rows, lanes)
    y = torch.where(x > 0, x, torch.exp(x) - 1.0)
    ge = torch.where(x > 0, torch.ones_like(x), y + 1.0)
    return iters * (y * ge).abs().sum(dim=2).reshape(grid * rows, lanes)


def _probe_phase(dev):
    """Phase 10: the probe kernel in each mode against its plain version,
    then the probe's entry point at full size, its rates beside the bound
    model; returns (max |diff|, the entry point's launches, per-mode
    results)."""
    import torch

    from deeppicarditeration_torch.ops import kernels
    from deeppicarditeration_torch.utils import probe_roofline

    worst = 0.0
    checks = [(which, PROBE_CHECK_ITERS) for which in kernels.PROBE_MODES]
    for which, iters in checks + [("elu", PROBE_ITERS)]:
        grid = kernels.probe_grid(which)
        out = kernels.probe_cuda(which, EXACT_SEED, iters, dev, grid)
        ref = kernels.probe_plain(which, EXACT_SEED, grid, iters, dev)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        if iters == PROBE_CHECK_ITERS:
            limit, how = PROBE_TOL + PROBE_TOL * ref.abs(), \
                f"rtol=atol={PROBE_TOL}"
        else:
            limit = ELU_SUM_ULPS * 2.0 ** -24 * _elu_abs_sums(
                EXACT_SEED, grid, iters, dev)
            how = (f"{ELU_SUM_ULPS} x 2^-24 x the sum of |terms| (at most "
                   f"{float(limit.max()):.3e}; |ref| up to "
                   f"{float(ref.abs().max()):.3e})")
        ok = bool((err <= limit).all())
        print(f"probe kernel vs plain ({which}, grid {grid}, {iters} "
              f"iterations): max |diff| {float(err.max()):.3e}, within "
              f"{how}: {ok}")
        if not ok or not torch.isfinite(out).all():
            _fail(f"the probe kernel disagrees with its plain version "
                  f"({which}, {iters} iterations)")
        worst = max(worst, float(err.max()))
    kernels.PROBE.launches = 0
    probes = {r["probe"]: r for r in probe_roofline.main(
        ["--iters", str(PROBE_ITERS), "--repeats", str(PROBE_REPEATS)])}
    launches_probe = kernels.PROBE.launches
    if launches_probe != len(probes) * (1 + PROBE_REPEATS):
        _fail(f"the probe's entry point launched {launches_probe} times")
    peaks = {"FP32": PEAK_FP32_FLOPS, "INT32": PEAK_INT32_OPS,
             "SFU": PEAK_SFU_OPS, "ISSUE": PEAK_ISSUE}
    modes = {}
    for which, r in probes.items():
        work = _probe_work(which, r["units"], r["grid"])
        bms, _, pipe = _bound(work)
        per_unit = dict(zip(("FP32", "INT32", "SFU", "ISSUE"),
                            (w / r["units"] for w in (*work[:3],
                                                      _issue(work)))))
        implied = {p: r["units_per_s"] * per_unit[p] for p in peaks
                   if per_unit[p]}
        sass = r["sass_per_unit"]
        print(f"probe {which}: {r['units_per_s']:.4e} units/s "
              f"({r['s_per_call'] * 1e3:.3f} ms for {r['units']:.3e} units, "
              f"grid {r['grid']}); implied "
              + ", ".join(f"{p} {v:.3e}/s = {v / peaks[p]:.2f} of the "
                          f"model's {peaks[p]:.3e}"
                          for p, v in implied.items())
              + f"; bound {bms:.3f} ms ({pipe}), "
              f"{100 * bms / (r['s_per_call'] * 1e3):.0f} % of it reached "
              f"(issuing all its SASS: {_sass_issue_ms(work):.3f} ms); "
              f"the loop's SASS per unit: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sass.items())
              + f" (model, instructions: FP32 {per_unit['FP32'] / 2}, INT32 "
              f"{per_unit['INT32']}, SFU {per_unit['SFU']}, all "
              f"{per_unit['ISSUE']})")
        if which == "elu" and sass["sfu"] != PROBE_ELU_SFU:
            _fail("the elu probe's exp left its loop (SASS special "
                  f"functions per unit {sass['sfu']})")
        _not_below(f"probe {which}", r["s_per_call"] * 1e3, bms)
        modes[which] = {"units_per_s": r["units_per_s"],
                        "ms": r["s_per_call"] * 1e3, "units": r["units"],
                        "grid": r["grid"], "bound_ms": bms,
                        "bound_pipe": pipe,
                        "sass_issue_ms": _sass_issue_ms(work),
                        "implied_ops_per_s": implied,
                        "sass_per_unit": sass}
    return worst, launches_probe, modes


def _sub_iter(v: str):
    return v if v == "recipe" else int(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iterations", type=int, default=3,
                    help="Picard iterations of paths A-D (default 3)")
    ap.add_argument("--epochs", type=int, default=DIFFUSION_EPOCHS,
                    help=f"epochs of path E (default {DIFFUSION_EPOCHS}; "
                         "the recipe's own is 35000)")
    ap.add_argument("--hjb-epochs", type=int, default=HJB_DIFFUSION_EPOCHS,
                    help=f"epochs of path I (default {HJB_DIFFUSION_EPOCHS}; "
                         "the recipe's own is 15000)")
    ap.add_argument("--fn-iterations", type=int, default=FN_ITERATIONS,
                    help=f"Picard iterations of path K (default "
                         f"{FN_ITERATIONS}; the recipe's own is 40); path L "
                         f"runs at most {FN_PRNG_ITERATIONS}")
    ap.add_argument("--dbdp-sub-iter", type=_sub_iter, default=DBDP_SUB_ITER,
                    help=f"sub-iterations per grid time of paths M and N "
                         f"(default {DBDP_SUB_ITER}; 'recipe': the recipes' "
                         f"own, 150 and 125)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (ROOT / "deeppicarditeration_torch" / "csrc").is_dir():
        print(f"chip_smoke: no deeppicarditeration_torch package beside "
              f"{ROOT / 'chip_smoke.py'}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deeppicarditeration_torch.device import make_generator
    from deeppicarditeration_torch.models.solution import Solution
    from deeppicarditeration_torch.ops import estimators as est
    from deeppicarditeration_torch.ops import kernels, philox
    from deeppicarditeration_torch.training.picard import gen_config_from_cfg
    from deeppicarditeration_torch.utils import probe_roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if H100_SXM not in name:
        _fail(f"the bound uses the peaks of the H100 SXM ({H100_SXM!r}); "
              f"this card is {name!r}")
    t_start = time.perf_counter()

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build(*kernels.ALL)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(kernels.ALL)} kernels in parallel")
    for lib in kernels.ALL:
        info = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {lib.so_path.name}: nvcc {lib.build_seconds or 0:.1f} s; "
              + " | ".join(info))
    hgmma = _hgmma_counts()
    print("tensor-core kernels' SASS: " + ", ".join(
        f"{k} HGMMA {h}, WARPGROUP.DEPBAR {d}" for k, (h, d) in hgmma.items()))
    if not all(h for h, _ in hgmma.values()):
        _fail("a tensor-core kernel holds no HGMMA in its SASS")
    terminal_sass = probe_roofline.sass_mix(
        probe_roofline.library_sass(kernels.TERMINAL))
    print("terminal kernel's SASS per normal at nx=100 (the draw loop's "
          "fast path): " + json.dumps(terminal_sass))
    max_err = {f"{lib.source.stem}{sfx}": 0.0 for lib in kernels.ALL
               for sfx in ("", " bf16x3", " default")}

    # ---- 2. merged kernel vs plain, same external noise, full width --------
    b, m, nx = 256, 4096, 100
    for net in (False, True):
        eq, sol, tx = _problem(b, m, nx, net, 1, dev)
        g = torch.Generator(device=dev).manual_seed(2)
        u01 = torch.rand((b, m, 1), generator=g, device=dev)
        nt = torch.randn((b, m, nx), generator=g, device=dev)
        ni = torch.randn((b, m, nx), generator=g, device=dev)
        for mode in MODES:
            label = (f"merged {mode}, "
                     f"{'random net' if net else 'zero iterate'}, B={b} M={m}")
            key = _err_key("generate", mode)
            max_err[key] = max(max_err[key], _same(
                label, kernels.generate_with_gradients_cuda(
                    0, eq, sol, tx, m, u01, nt, ni, precision=mode),
                kernels.generate_with_gradients_plain(
                    0, eq, sol, tx, m, u01, nt, ni, precision=mode)))
        del u01, nt, ni

    # ---- 3. in-kernel Philox vs torch.Generator noise (CLT) ---------------
    eq, sol, tx = _problem(64, m, nx, True, 3, dev)
    out = kernels.generate_with_gradients_cuda(20261016, eq, sol, tx, m,
                                               precision=MODES[0])
    ref, var = kernels.generate_with_gradients_plain(
        7, eq, sol, tx, m, precision=MODES[0], return_var=True)
    _clt("merged, random net", out, ref, var, m, CLT_SIGMAS)

    # ---- 4. path A, captured, against A', the loop ---------------------------
    n_iter = args.iterations
    runner_a, launches_a, routes_a = _run_path("A", n_iter)
    _expect_launches("A", runner_a, launches_a, routes_a,
                     {"generate": runner_a.generate_calls})
    runner_l, launches_l, routes_l = _run_path("A'", n_iter)
    _expect_launches("A'", runner_l, launches_l, routes_l,
                     {"generate": runner_l.generate_calls})
    _captured_vs_loop(runner_a, runner_l, n_iter)

    # ---- 5. merged kernel at path A's shapes -------------------------------
    eq, sol = runner_a.equation, runner_a.u_current  # the trained iterate
    cfg = path_cfg("A", n_iter)
    gen = gen_config_from_cfg(cfg)
    nb, mm = int(cfg.DATA.DATA_SIZE), gen.n_estimate_terminal
    tx = est.sample_tx(make_generator(dev, 4), eq, nb, gen, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    u01 = torch.rand((nb, mm, 1), generator=g, device=dev)
    nt = torch.randn((nb, mm, nx), generator=g, device=dev)
    ni = torch.randn((nb, mm, nx), generator=g, device=dev)
    zero = Solution.zero(nx)
    outs = {}
    for label, s in (("zero iterate", zero), (f"iterate {n_iter}", sol)):
        for mode in MODES:
            key = _err_key("generate", mode)
            outs[mode] = kernels.generate_with_gradients_cuda(
                0, eq, s, tx, mm, u01, nt, ni, precision=mode)
            max_err[key] = max(max_err[key], _same(
                f"merged {mode}, {label}, B={nb} M={mm}", outs[mode],
                kernels.generate_with_gradients_plain(
                    0, eq, s, tx, mm, u01, nt, ni, precision=mode)))
        delta = float((outs["bf16x3"] - outs["highest"]).abs().max())
        print(f"merged kernel, {label}, B={nb} M={mm}: max |bf16x3 - "
              f"highest| {delta:.3e} (the JAX package measured ~2e-5 on the "
              f"TPU)")
    del outs
    # antithetic pairing at M=8192 on the same noise as half draws
    for mode in MODES:
        key = _err_key("generate", mode)
        max_err[key] = max(max_err[key], _same(
            f"merged {mode} antithetic, iterate {n_iter}, B={nb} "
            f"M={2 * mm}",
            kernels.generate_with_gradients_cuda(
                0, eq, sol, tx, 2 * mm, u01, nt, ni, antithetic=True,
                precision=mode),
            kernels.generate_with_gradients_plain(
                0, eq, sol, tx, 2 * mm, u01, nt, ni, antithetic=True,
                precision=mode)))
    bound_z = _bonferroni(nb * (1 + nx))
    out = kernels.generate_with_gradients_cuda(5, eq, sol, tx, mm,
                                               precision=MODES[0])
    ref, var = kernels.generate_with_gradients_plain(
        7, eq, sol, tx, mm, precision=MODES[0], return_var=True)
    _clt(f"merged, iterate {n_iter}", out, ref, var, mm, bound_z)
    del out, ref, var

    # ---- 6. standalone kernels at the same shapes --------------------------
    for anti in (False, True):
        rows = mm // 2 if anti else mm
        h = nt[:, :rows]
        max_err["terminal"] = max(max_err["terminal"], _same(
            f"terminal{' antithetic' if anti else ''}, B={nb} M={mm}",
            kernels.terminal_with_gradients_cuda(
                0, eq, tx, mm, h.contiguous(), antithetic=anti),
            kernels.terminal_with_gradients_plain(
                0, eq, tx, mm, h, antithetic=anti)))
        cases = [("zero iterate", zero), (f"iterate {n_iter}", sol)]
        for label, s in (cases if not anti else cases[1:]):
            u, n = u01[:, :rows].contiguous(), ni[:, :rows].contiguous()
            for mode in MODES:
                key = _err_key("integral", mode)
                max_err[key] = max(max_err[key], _same(
                    f"integral {mode}{' antithetic' if anti else ''}, "
                    f"{label}, B={nb} M={mm}",
                    kernels.integral_with_gradients_cuda(
                        0, eq, s, tx, mm, u, n, antithetic=anti,
                        precision=mode),
                    kernels.integral_with_gradients_plain(
                        0, eq, s, tx, mm, u, n, antithetic=anti,
                        precision=mode)))
            del u, n
    del u01, nt, ni
    # each estimator kernel with its own draws at all nb points, against
    # its plain version fed the host Philox's draws at the first and last
    # EDGE points (whose keys are their rows in the launch)
    pts = list(range(EDGE)) + list(range(nb - EDGE, nb))
    u_h, nt_h, ni_h = _host_draws(EXACT_SEED, pts, mm, nx, dev)
    txp = tx[pts]
    for anti in (False, True):
        rows = mm // 2 if anti else mm
        u, a, c = (v[:, :rows].contiguous() for v in (u_h, nt_h, ni_h))
        tag = (f"{' antithetic' if anti else ''}, iterate {n_iter}, own "
               f"draws vs host Philox at points 0-{EDGE - 1} and "
               f"{nb - EDGE}-{nb - 1}, M={mm}")
        checks = [("terminal", "highest",
                   kernels.terminal_with_gradients_cuda(
                       EXACT_SEED, eq, tx, mm, antithetic=anti),
                   kernels.terminal_with_gradients_plain(
                       0, eq, txp, mm, a, antithetic=anti))]
        for mode in MODES:
            kw = dict(antithetic=anti, precision=mode)
            checks += [
                ("generate", mode,
                 kernels.generate_with_gradients_cuda(
                     EXACT_SEED, eq, sol, tx, mm, **kw),
                 kernels.generate_with_gradients_plain(
                     0, eq, sol, txp, mm, u, a, c, **kw)),
                ("integral", mode,
                 kernels.integral_with_gradients_cuda(
                     EXACT_SEED, eq, sol, tx, mm, **kw),
                 kernels.integral_with_gradients_plain(
                     0, eq, sol, txp, mm, u, c, **kw))]
        for stem, mode, out, ref in checks:
            key = _err_key(stem, mode)
            max_err[key] = max(max_err[key], _same(
                f"{stem}{'' if stem == 'terminal' else ' ' + mode}{tag}",
                out[pts], ref))
        del checks
        del u, a, c
    del u_h, nt_h, ni_h

    # the terminal kernel's guard-free Box-Muller against philox.cuh's, bit
    # for bit, at all 2^23 uniforms
    bad = kernels.terminal_draw_mismatches(dev)
    print(f"terminal kernel's Box-Muller vs philox.cuh's over all 2^23 "
          f"uniforms: {bad} mismatches")
    if bad:
        _fail("the terminal kernel's Box-Muller differs from philox.cuh's")

    # normals: the host Philox's values at the head and the end of a 2^28
    # buffer; moments over 4 x 2^28 draws, lag 1-8 correlations; layout
    n_buf, n_total, lags = 2 ** 28, 0, range(1, 9)
    s1 = s2 = s4 = 0.0
    lag = dict.fromkeys(lags, 0.0)
    for i in range(4):
        v = kernels.normals_cuda(EXACT_SEED + i, (n_buf,), dev)
        if not torch.isfinite(v).all():
            _fail("the normals kernel wrote a non-finite value")
        for start in ((0, n_buf - NORMALS_CHECK) if i == 0 else ()):
            ref = torch.from_numpy(philox.normals_flat(
                EXACT_SEED, start, NORMALS_CHECK)).to(dev)
            err = (v[start:start + NORMALS_CHECK] - ref).abs()
            ok = bool((err <= DRAW_TOL + DRAW_TOL * ref.abs()).all())
            print(f"normals kernel vs host Philox at flat indices {start}-"
                  f"{start + NORMALS_CHECK - 1}: max |diff| "
                  f"{float(err.max()):.3e}, within rtol=atol={DRAW_TOL}: "
                  f"{ok}")
            if not ok:
                _fail("the normals kernel's values differ from the host "
                      "Philox's")
            max_err["normals"] = max(max_err["normals"], float(err.max()))
        x = v.double()
        del v
        s1 += float(x.sum())
        s2 += float((x * x).sum())
        s4 += float((x ** 4).sum())
        for k in lags:
            lag[k] += float((x[k:] * x[:-k]).sum())
        n_total += n_buf
        del x
    se = 1.0 / math.sqrt(n_total)
    z_mom = {"mean": (s1 / n_total) / se,
             "var": (s2 / n_total - 1.0) / (math.sqrt(2.0) * se),
             "m4": (s4 / n_total - 3.0) / (math.sqrt(96.0) * se),
             **{f"lag{k}": (lag[k] / (n_total - 4 * k)) / se for k in lags}}
    print(f"normals kernel over {n_total} draws: mean {s1 / n_total:.3e}, "
          f"var {s2 / n_total:.6f}, 4th moment {s4 / n_total:.5f}, lag-1 "
          f"{lag[1] / (n_total - 4):.3e}; z-scores "
          + ", ".join(f"{k} {v:.2f}" for k, v in z_mom.items()))
    if any(abs(v) > CLT_SIGMAS for v in z_mom.values()):
        _fail("the normals kernel's moments are off N(0, 1)")
    a = kernels.normals_cuda(11, NORMALS_CHUNK, dev).reshape(-1)
    c = kernels.normals_cuda(11, (12345, 7), dev).reshape(-1)
    if not torch.equal(a[:c.numel()], c):
        _fail("the normals kernel's draws depend on the buffer's shape")
    print(f"normals kernel: the same seed gives the same {c.numel()} "
          f"leading values at shapes {NORMALS_CHUNK} and (12345, 7)")
    del a, c

    # ---- 7. paths B, C, D --------------------------------------------------
    runner_b, launches_b, routes_b = _run_path("B", n_iter)
    calls = runner_b.generate_calls
    _expect_launches("B", runner_b, launches_b, routes_b,
                     {"terminal": calls, "integral": calls})
    runner_c, launches_c, routes_c = _run_path("C", n_iter)
    gen_c = gen_config_from_cfg(path_cfg("C", n_iter))
    width = est._act_width(runner_c.u_current)
    per_call = (gen_c.n_estimate_terminal // gen_c.chunk(mm, nb, nx)
                + gen_c.n_estimate_integral // gen_c.chunk(mm, nb, nx, width))
    if per_call != 2 * 64 or gen_c.chunk(mm, nb, nx, 0) != 64:
        _fail(f"path C: {per_call} chunks per call, want 2 x 64")
    _expect_launches("C", runner_c, launches_c, routes_c,
                     {"normals": per_call * runner_c.generate_calls})
    runner_d, launches_d, routes_d = _run_path("D", n_iter)
    _expect_launches("D", runner_d, launches_d, routes_d,
                     {"generate": runner_d.generate_calls})
    runner_f, launches_f, routes_f = _run_path("F", n_iter)
    _expect_launches("F", runner_f, launches_f, routes_f,
                     {"generate": runner_f.generate_calls})
    runner_g, launches_g, routes_g = _run_path("G", n_iter)
    calls = runner_g.generate_calls
    _expect_launches("G", runner_g, launches_g, routes_g,
                     {"terminal": calls, "integral": calls})

    # ---- 8. rollout kernel at path E's shapes -----------------------------
    cfg_e = diffusion_cfg(args.epochs)
    max_err["rollout"] = _check_rollout(cfg_e, dev)
    _check_epoch_draws("E")

    # ---- 9. path E ---------------------------------------------------------
    runner_e, launches_e, ms_epoch, traced_e = _run_diffusion(args.epochs)

    # ---- 10. rate probe ----------------------------------------------------
    max_err["probe"], launches_probe, modes = _probe_phase(dev)

    # ---- 12. paths H and J: the HJB family through generate_pis ----------
    runner_h, launches_h, routes_h = _run_path("H", n_iter)
    _expect_launches("H", runner_h, launches_h, routes_h,
                     {"generate_pis": runner_h.generate_calls})
    runner_j, launches_j, routes_j = _run_path("J", n_iter)
    _expect_launches("J", runner_j, launches_j, routes_j,
                     {"generate_pis": runner_j.generate_calls})

    # ---- 13. generate_pis at path H's shapes -------------------------------
    eq_h, sol_h, tx_h, nb_h, mm_h = _check_pis(runner_h, n_iter, max_err)

    # ---- 14. path I: the HJB D-DBSDE recipe -------------------------------
    _check_epoch_draws("I")
    runner_i, launches_i, ms_epoch_i, traced_i = _run_diffusion(
        args.hjb_epochs, "I")

    # ---- 15. paths K and L: the FN DPI recipe ------------------------------
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    n_fn = args.fn_iterations
    runner_k, launches_k, routes_k = _run_path("K", n_fn)
    peak_k = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    _expect_launches("K", runner_k, launches_k, routes_k, {})
    print(f"path K: peak device memory {peak_k:.2f} GiB above the "
          f"{held / 2 ** 30:.2f} GiB held before it "
          f"(torch.cuda.max_memory_allocated, the run and its final eval)")
    n_l = min(n_fn, FN_PRNG_ITERATIONS)
    runner_l2, launches_l2, routes_l2 = _run_path("L", n_l)
    gen_l = gen_config_from_cfg(runner_l2.cfg)
    nb_l, nx_l = int(runner_l2.cfg.DATA.DATA_SIZE), runner_l2.equation.nx
    width_l = est._act_width(runner_l2.u_current)
    chunks_l = (gen_l.n_estimate_terminal
                // gen_l.chunk(gen_l.n_estimate_terminal, nb_l, nx_l)
                + gen_l.n_estimate_integral
                // gen_l.chunk(gen_l.n_estimate_integral, nb_l, nx_l,
                              width_l))
    print(f"path L: {chunks_l} normals launches per generation call "
          f"(terminal + integral chunks of {FN_CHUNK[1]} samples)")
    if (nb_l, gen_l.chunk(gen_l.n_estimate_integral, nb_l, nx_l, width_l),
            nx_l) != FN_CHUNK:
        _fail(f"path L's chunk is not {FN_CHUNK}")
    _expect_launches("L", runner_l2, launches_l2, routes_l2,
                     {"normals": chunks_l * runner_l2.generate_calls})
    max_err["normals fn"] = _normals_vs_host(FN_CHUNK, dev)

    # ---- 16. rollout kernel at the DBDP recipes' shapes --------------------
    max_err["rollout dbdp"] = _check_rollout_dbdp(dev)

    # ---- 17. paths M and N: the DBDP recipes -------------------------------
    runner_m, launches_m, ms_sub_m, _, traced_m = _run_dbdp(
        "M", args.dbdp_sub_iter)
    runner_n, launches_n, ms_sub_n, _, traced_n = _run_dbdp(
        "N", args.dbdp_sub_iter)

    # ---- 18. captured DBDP against the eager loop -------------------------
    dbdp_rel, dbdp_rel_host = _captured_dbdp_vs_eager("M")

    # ---- 11. times and bounds at the paths' shapes -------------------------
    neurons = sol.module.neurons
    n_weights = sum(p.numel() for p in sol.module.parameters())
    rows = []

    def row(lib, stem, replaces, path, launches, n_calls, ms, plain_ms,
            work, library_ms=None, shape="", extra=None, mode=None,
            err_key=None):
        bound_ms, bound_by, pipe = _bound(work)
        name = lib if mode is None else f"{lib} {mode}"
        _not_below(name, ms, bound_ms)
        print(f"{name}: {ms:.3f} ms per call at {shape} (path {path}), "
              f"plain {plain_ms:.3f} ms, library {library_ms}, bound "
              f"{bound_ms:.3f} ms ({bound_by}, {pipe}; FP32 {work[0]:.3e}, "
              f"INT32 {work[1]:.3e}, SFU {work[2]:.3e}, bytes "
              f"{work[3]:.3e}, bf16 tensor {work[4]:.3e}); "
              f"{ms / bound_ms:.1f}x the bound; the SASS's every "
              f"instruction would take {_sass_issue_ms(work):.3f} ms to "
              f"issue")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"deeppicarditeration_torch/csrc/{stem}.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "launches_per_iteration": launches / n_iter,
            "launches_per_call": launches / max(n_calls, 1),
            "max_abs_err": max_err[err_key or _err_key(stem,
                                                       mode or "highest")],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_pipe": pipe,
            "sass_issue_ms": _sass_issue_ms(work), "library_ms": library_ms,
            **({} if mode is None else {"precision": mode}), **(extra or {})})

    src = "deeppicarditeration_tpu/ops/pallas_kernels.py"
    shape = f"B={nb} M={mm} nx={nx}, {len(neurons)}x128 net"
    # the net kernels in both modes, timed in turns (bf16x3, highest,
    # highest, bf16x3), with their plain versions
    gen_ms = _in_turns({mode: (lambda mode=mode: kernels.
                               generate_with_gradients_cuda(
                                   5, eq, sol, tx, mm, precision=mode))
                        for mode in MODES}, 3)
    int_ms = _in_turns({mode: (lambda mode=mode: kernels.
                               integral_with_gradients_cuda(
                                   5, eq, sol, tx, mm, precision=mode))
                        for mode in MODES}, 3)
    for mode, (path, runner, launches) in zip(MODES, (
            ("A", runner_a, launches_a), ("F", runner_f, launches_f))):
        row("generate_with_gradients", "generate", f"{src}:869", path,
            launches["generate"], runner.generate_calls, gen_ms[mode],
            _time_ms(lambda: kernels.generate_with_gradients_plain(
                5, eq, sol, tx, mm, precision=mode), 2),
            _merged_work(nb, mm, nx, False, neurons, n_weights, mode),
            shape=shape, mode=mode)
    ms_d = _in_turns({mode: (lambda mode=mode: kernels.
                             generate_with_gradients_cuda(
                                 5, eq, sol, tx, 2 * mm, antithetic=True,
                                 precision=mode)) for mode in MODES}, 2)
    for mode in MODES:
        bd = _bound(_merged_work(nb, 2 * mm, nx, True, neurons, n_weights,
                                 mode))
        _not_below(f"generate_with_gradients {mode} antithetic", ms_d[mode],
                   bd[0])
        print(f"generate_with_gradients {mode} antithetic (path D's shapes, "
              f"M={2 * mm}): {ms_d[mode]:.3f} ms per call, bound "
              f"{bd[0]:.3f} ms ({bd[2]})")
    # the terminal kernel with antithetic pairing at the same M (path D's
    # pairing on the split route), against its own bound
    ms_ta = _time_ms(lambda: kernels.terminal_with_gradients_cuda(
        5, eq, tx, mm, antithetic=True), 10)
    bd_ta = _bound(_terminal_work(nb, mm, nx, True))
    _not_below("terminal_with_gradients antithetic", ms_ta, bd_ta[0])
    print(f"terminal_with_gradients antithetic (M={mm}): {ms_ta:.3f} ms per "
          f"call, bound {bd_ta[0]:.3f} ms ({bd_ta[2]}); "
          f"{ms_ta / bd_ta[0]:.1f}x the bound")
    row("terminal_with_gradients", "terminal", f"{src}:1244", "B",
        launches_b["terminal"], runner_b.generate_calls,
        _time_ms(lambda: kernels.terminal_with_gradients_cuda(
            5, eq, tx, mm), 10),
        _time_ms(lambda: kernels.terminal_with_gradients_plain(
            5, eq, tx, mm), 2),
        _terminal_work(nb, mm, nx, False), shape=f"B={nb} M={mm} nx={nx}",
        extra={"antithetic": {"ms": ms_ta, "bound_ms": bd_ta[0],
                              "bound_pipe": bd_ta[2]},
               "sass_per_normal": terminal_sass})
    for mode, (path, runner, launches) in zip(MODES, (
            ("B", runner_b, launches_b), ("G", runner_g, launches_g))):
        row("integral_with_gradients", "integral", f"{src}:690", path,
            launches["integral"], runner.generate_calls, int_ms[mode],
            _time_ms(lambda: kernels.integral_with_gradients_plain(
                5, eq, sol, tx, mm, precision=mode), 2),
            _integral_work(nb, mm, nx, False, neurons, n_weights, mode),
            shape=shape, mode=mode)
    n_chunk = math.prod(NORMALS_CHUNK)
    cuda_gen = torch.Generator(device=dev).manual_seed(5)
    row("normals", "normals", f"{src}:71", "C", launches_c["normals"],
        runner_c.generate_calls,
        _time_ms(lambda: kernels.normals_cuda(5, NORMALS_CHUNK, dev), 50),
        _time_ms(lambda: kernels.normals_plain(5, NORMALS_CHUNK, dev), 50),
        _normals_work(n_chunk),
        library_ms=_time_ms(lambda: torch.randn(
            NORMALS_CHUNK, generator=cuda_gen, device=dev), 50),
        shape=f"{NORMALS_CHUNK}")
    # rollout at path E's shapes, one launch per epoch
    K_e, b_e = int(cfg_e.METHOD.K), int(cfg_e.TRAIN.BATCH_SIZE)
    eq_e = runner_e.equation
    x0, sdt = _path_e_inputs(eq_e, b_e, K_e, float(cfg_e.METHOD.dt), 24, dev)
    # back to back (host overhead included) and device time
    ms_roll, dev_roll = _rollout_times(x0, sdt, eq_e.alpha_sqrt, K_e)
    row("paths", "rollout", "deeppicarditeration_tpu/ops/rollout.py:98", "E",
        launches_e["rollout"], runner_e.rollout_calls, ms_roll,
        _time_ms(lambda: kernels.paths_plain(5, x0, sdt, eq_e.alpha_sqrt,
                                             K_e), 200),
        _rollout_work(K_e, b_e, eq_e.nx),
        shape=f"K={K_e} B={b_e} nx={eq_e.nx}",
        extra={"launches_per_iteration": launches_e["rollout"],
               "graph_replays": runner_e.graph_replays,
               "traced_replays": traced_e["replays"],
               "traced_launches": traced_e["launches"],
               "device_ms": dev_roll, "ms_per_epoch": ms_epoch,
               "share_of_epoch": (None if dev_roll is None
                                  else dev_roll / ms_epoch)})
    if dev_roll is not None:
        _not_below("paths (device time)", dev_roll, rows[-1]["bound_ms"])
    share = ("not measured (no device time in the trace)" if dev_roll is None
             else f"{100 * dev_roll / ms_epoch:.3f} %")
    print(f"path E: the rollout kernel takes {ms_roll:.4f} ms per call back "
          f"to back, {dev_roll} ms of device time (torch.profiler), of "
          f"{ms_epoch:.3f} ms per epoch; its device time's share {share}")
    # the probe at the entry point's full size in the elu mode, where it is
    # also checked against its plain version; every mode under "modes"
    grid = kernels.probe_grid("elu")
    row("probe", "probe", "scripts/probe_vpu_roofline.py:50",
        "probe entry point", launches_probe, len(modes) * (1 + PROBE_REPEATS),
        modes["elu"]["ms"],
        _time_ms(lambda: kernels.probe_plain(
            "elu", EXACT_SEED, grid, PROBE_ITERS, dev), 1),
        _probe_work("elu", probe_roofline.units_per_call(grid, PROBE_ITERS),
                    grid),
        shape=f"elu, grid {grid}, {PROBE_ITERS} iterations",
        extra={"launches_per_iteration": None, "modes": modes})
    # generate_pis at path H's shapes, both modes in turns (the trained
    # iterate); its plain version at the same shapes, one call each
    hidden_h = sol_h.module.hidden_shapes
    n_w_h = sum(p.numel() for p in sol_h.module.parameters())
    ncomp = int(eq_h.gmm_means.shape[0])
    pis_ms = _in_turns({mode: (lambda mode=mode: kernels.generate_pis_cuda(
        5, eq_h, sol_h, tx_h, mm_h, precision=mode)) for mode in PIS_MODES},
        2)
    for mode, (path, runner, launches) in zip(PIS_MODES, (
            ("H", runner_h, launches_h), ("J", runner_j, launches_j))):
        row("generate_pis", "generate_pis", f"{src}:869", path,
            launches["generate_pis"], runner.generate_calls, pis_ms[mode],
            _time_ms(lambda: kernels.generate_with_gradients_plain(
                5, eq_h, sol_h, tx_h, mm_h, precision=mode), 1),
            _pis_work(nb_h, mm_h, nx, hidden_h, ncomp, n_w_h, mode),
            shape=f"B={nb_h} M={mm_h} nx={nx}, 4x512 PISGradNet",
            mode=mode, extra={"instance": "OU + PISGradNet (HJB)"})
    # the normals kernel at paths K/L's chunk shape, launched by path L
    n_fn_chunk = math.prod(FN_CHUNK)
    row("normals", "normals", f"{src}:71", "L", launches_l2["normals"],
        runner_l2.generate_calls,
        _time_ms(lambda: kernels.normals_cuda(5, FN_CHUNK, dev), 50),
        _time_ms(lambda: kernels.normals_plain(5, FN_CHUNK, dev), 50),
        _normals_work(n_fn_chunk),
        library_ms=_time_ms(lambda: torch.randn(
            FN_CHUNK, generator=cuda_gen, device=dev), 50),
        shape=f"{FN_CHUNK}", err_key="normals fn",
        extra={"launches_per_iteration": launches_l2["normals"] / n_l,
               "instance": "FN chunk (path L)"})
    # the rollout kernel at the DBDP recipes' shapes, launched by M and N
    x0_d, sdt_d, K_d = _dbdp_rollout_inputs(dev, 26)
    ms_roll_d, dev_roll_d = _rollout_times(x0_d, sdt_d, 1.0, K_d)
    row("paths", "rollout", "deeppicarditeration_tpu/ops/rollout.py:98",
        "M", launches_m["rollout"], runner_m.rollout_calls, ms_roll_d,
        _time_ms(lambda: kernels.paths_plain(5, x0_d, sdt_d, 1.0, K_d), 200),
        _rollout_work(*DBDP_ROLLOUT),
        shape="K={} B={} nx={}".format(*DBDP_ROLLOUT), err_key="rollout dbdp",
        extra={"instance": "DBDP (paths M, N)",
               "launches_per_iteration": (launches_m["rollout"]
                                          / int(runner_m.cfg.PICARD.N)),
               "graph_replays": runner_m.graph_replays,
               "traced_replays": traced_m["replays"],
               "traced_launches": traced_m["launches"],
               "launches_N": launches_n["rollout"],
               "graph_replays_N": runner_n.graph_replays,
               "traced_replays_N": traced_n["replays"],
               "traced_launches_N": traced_n["launches"],
               "device_ms": dev_roll_d,
               "captured_vs_eager_rel": dbdp_rel,
               "captured_vs_host_bias_correction_rel": dbdp_rel_host,
               "ms_per_sub_iteration": {"M": ms_sub_m, "N": ms_sub_n},
               "share_of_sub_iteration": (
                   None if dev_roll_d is None else
                   {"M": dev_roll_d / ms_sub_m, "N": dev_roll_d / ms_sub_n})})
    if dev_roll_d is not None:
        _not_below("paths at DBDP's shapes (device time)", dev_roll_d,
                   rows[-1]["bound_ms"])
    print(f"paths M, N: the rollout kernel at K={K_d} B={DBDP_ROLLOUT[1]} "
          f"takes {ms_roll_d:.4f} ms per call back to back, {dev_roll_d} ms "
          f"of device time, of {ms_sub_m:.3f} / {ms_sub_n:.3f} ms per "
          f"sub-iteration; {launches_m['rollout']} / "
          f"{launches_n['rollout']} eager launches, one in each of "
          f"{runner_m.graph_replays} / {runner_n.graph_replays} graph "
          f"replays")
    per_i = [tm["interval_ms"] / tm["epochs"] for tm in runner_i.timings]
    print(f"path I: {ms_epoch_i:.3f} ms per epoch (median), "
          f"{launches_i['rollout']} eager rollout launches and one in each "
          f"of {runner_i.graph_replays} graph replays (traced: "
          f"{traced_i['launches']} in {traced_i['replays']}; K="
          f"{int(runner_i.cfg.METHOD.K)}), first interval {per_i[0]:.3f} ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"card check")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
