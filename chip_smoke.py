#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order (each prints its lines; any failure exits non-zero):

1. environment -- card name and power limit, torch / CUDA / nvcc / triton;
2. build       -- compile ``rrmpg_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels     -- every fused kernel against its plain PyTorch version on
                  the same CUDA tensors, float64 and float32: GR4J (K1 MSE,
                  K2 stats, K3 trajectories; both UH register pairs, with
                  and without NaN gaps in qobs; K1/K2 also at T = 1, 37, 65
                  and 128 around their staging tiles, N = 200 and 33793
                  (the split kernel and one member a thread), gaps at tile
                  edges, and warm across a tile edge), ABC (K6 single
                  launch, K7
                  three launches; T in {1, 1000, 70000, 1000003}, c in
                  {0, 0.12, 1}; against the doubling scan, the sequential
                  loop and each other; also one step short of, at and past
                  a chunk, at 33, 257 and 2442 chunks in both types and at
                  the Monte-Carlo's 4096 x 12418, both in float32
                  against the float64 doubling scan at 4096 x 32 chunks
                  with a member at c = 7e-5, and K6 five times on the
                  same inputs at 10M steps and at 4096 x 12418, the same
                  bits every time), HBV-Edu (K12 MSE and stats with
                  and without gaps, K13 trajectories; NaN-aware) and the
                  snow family (K8 MSE, stats and SCA statistics with and
                  without gaps, K9 trajectories; plain, hysteresis, ice and
                  hysteresis + ice variants and the snow-only routine; 1, 2,
                  5 and 7 layers (K8 and K9 keep 1 and 5 in registers, any
                  other count in shared memory); both UH register pairs; K8
                  and K12 also at T = 37 and 128 around their 64-step
                  staging tiles, N = 200, gaps at tile edges; K9 at T = 1,
                  37, 64, 65 and 128 around its 32-step staging and store
                  tiles, N = 200 and 129, the snow-only outflow bit for bit
                  at every edge, every variant in turn); then
                  the state kernels
                  (K4, K14, K10: trajectories and every state row, cold and
                  warm; K10 at 1, 2, 5 and 7 layers, its snow rows bit for
                  bit; K10 and K14 also at T = 1, 31, 32, 33, 65 and 128
                  around K10's 32-step staging and store tiles, K4 also at
                  T = 1, 63, 64, 65 and 128 around its 64-step ones, cold
                  and then warm from their own state (at T = 1 a warm
                  segment shorter than the history), N = 1, 129 and 200
                  (K4's split kernel; its tile kernel at 8449 and 8520),
                  K4 at both UH register pairs, K10 at 2 and 5 layers,
                  plain and hysteresis + ice, K14 with NaN members; K13 at
                  K4's edges on the MATLAB forcing with NaN members, and
                  K13 against K14's cold entry bit for bit; K3 at K4's
                  edges, both UH register pairs, against the plain version
                  and K4's cold entry bit for bit) and
                  the warm entry of the
                  objectives (K1/K2, K12, K8, with and without gaps), and in
                  float64 a split run against the unbroken one; then the
                  regional kernels (K5, K11: one and three catchments, the
                  three with a short record and gaps, MSE and statistics,
                  both UH register pairs, every snow variant at 1 and 5
                  layers; K5 also at T = 1, 37, 65 and 128, N = 200, gaps
                  at tile edges and a record cut short; K11 also at 1, 2, 5
                  and 7 layers, T = 37 and 128, N = 200, gaps at tile edges
                  and a record cut short);
4. golden      -- the fused engines in float64 against the authors' Excel
                  GR4J trajectory, MATLAB HBV-Edu trajectory and the four
                  Excel snow trajectories (tests/data/);
5. main paths  -- float32, through the public entry points, each with the
                  launch counters set to 0 just before and read just after:
                  GR4J on CAMELS basin 01031500 (131072-member Monte-Carlo
                  through K2, two DE calibrations through K1/K2, a fused
                  simulation through K3); HBV-Edu on the 3652 MATLAB days
                  (131072-member Monte-Carlo and two calibrations through
                  K12, a fused simulation through K13); ABC (one member over
                  10 000 000 steps through K6, a 4096-member Monte-Carlo and
                  a calibration on CAMELS 01031500); DE's JAX contract
                  (a fused GR4J fit on CAMELS 01031500 saved every 5
                  generations, broken off at 10 and resumed to 15, equal to
                  the unbroken 15 bit for bit; the fused fit with
                  polish=True, skipped as the kernels have no backward;
                  gradient_descent through the sequential engine on the
                  last 365 days, 20 steps); the hysteresis + ice
                  snow model on the 1827 days and 5 elevation layers of its
                  Excel sheet (131072-member Monte-Carlo, two calibrations
                  and a discharge + snow-cover calibration through K8, a
                  fused simulation through K9, and the snow-only routine
                  through both); the forecast path of GR4J, HBV-Edu and the
                  hysteresis + ice snow model on the same records (spin-up of
                  the calibrated model over all but the last 365 days with
                  its final state through K4 / K14 / K10, the state through a
                  file, a 131072-member continuation of the last 365 days
                  from that one state through the same kernels' warm entry,
                  and two recalibrations on those days through the warm
                  K1/K2, K12, K8), and one warm continuation of ABC and of
                  the snow-only routine on the sequential engine; the regional
                  path (eight CAMELS-format basins written from 01031500 with
                  scaled forcing, one record ending at half and one with 10 %
                  gaps, through ``load_basins(join='outer')``; the regional
                  GR4J objective through K5 and the regional hysteresis + ice
                  snow objective through K11, 8 catchments x 131072 members,
                  'mse' and 'kge'; GLUE weights and prediction limits over a
                  20000-member CemaneigeGR4J Monte-Carlo through K9); the
                  analysis tools (``tools``): ``fit(method='sce')`` of GR4J
                  on CAMELS 01031500 through K1 (K1 launches 1 + nit beta,
                  ``nfev`` exact, ``fun`` against the 'scan' engine) and of
                  HBV-Edu on the MATLAB days through K12 (the field
                  capacity's bound lowered to 1 mm, so NaN members arise
                  and are quarantined), ``fit_Q_SCA(pareto=True)`` of the
                  hysteresis + ice model (pop 128, 30 generations, one K8
                  SCA-statistics launch a generation; the front re-evaluated
                  through the 'scan' engine, its hypervolume against the
                  initial population's), Sobol' (n = 1024, 6144 points) and
                  Morris (64 trajectories) over a fused GR4J MSE, one K1
                  launch each, DE-MC (16 chains x 400 steps, two K1 launches
                  a step) and ``monte_carlo`` of 16384 GR4J members with the
                  FDC signatures through K3 (K2 never); the assimilation
                  path (``assim``): ``assimilation_cycle`` over the last 365
                  days in 36 windows of 10 days at 131072 members, GR4J on
                  CAMELS 01031500 against a twin truth (the calibrated model
                  through K3 with noise; the ensemble starts from the
                  spun-up state, K4, dry and spread): the EnKF on the host
                  and the scan backend (bit-equal expected, held to the
                  float32 trajectory tolerance), the particle filter and the
                  joint parameter EnKF on the scan backend, each through 36
                  warm K4 launches and closer to the truth after 5 cycles
                  than the free run; HBV-Edu on the MATLAB days (36 K14) and
                  the hysteresis + ice model on its Excel sheet (36 K10), the
                  EnKF on the scan backend; ABC's particle filter on the
                  sequential engine; 'fused' against 'scan' window steps at
                  256 members; the scan loop under
                  ``torch.cuda.set_sync_debug_mode('error')``; cycles a
                  second of both backends at 1024 x 128 and 131072 x 36;
                  the device mesh (``mesh``): the fused GR4J fits of the
                  main path (K1 'mse', K2 'kge'), an HBV-Edu fit (K12)
                  and the hysteresis + ice fit and ``fit_Q_SCA`` (K8),
                  both at popsize 12 (populations 4 divides), on
                  ``default_mesh()`` (every visible GPU) and on 4 shards
                  of cuda:0, bit for bit the unsharded
                  fits with shards x their launches; the regional GR4J (K5,
                  8 x 131072 x 12418) and snow (K11, 8 x 131072 x 1827 x 5)
                  objectives on a 2 x 2 (ensemble, catchment) mesh of
                  cuda:0, four launches bit for bit the one; the 'scan'
                  engine's ``simulate`` and ``monte_carlo`` on both meshes
                  at 4096 members x 365 days; the fused simulate and
                  statistics raising under a mesh; ``initialize()`` in one
                  process (NCCL) and a mesh fit after it equal to the one
                  before; the ten port examples (``examples``):
                  ``examples/torch/01-10`` in this process at
                  ``RRMPG_EXAMPLE_FAST=1``, each through the kernels its
                  study runs on (EXAMPLE_KERNELS), their launches counted
                  in the ``kernels`` line; the JAX package's last
                  surfaces (``surface``): ABC's 'scan' engine on the
                  Toeplitz products (``linear_recurrence``,
                  ``run_abcmodel_matscan``) at 10M steps in float32 and
                  float64 and at 4096 x 12418 with a member at c = 7e-5
                  against K6, K7 and the float64 doubling scan, under
                  'highest' and 'high' float32 matmul precision bit for
                  bit, timed beside K6 and K7, and the class's 10M-step
                  ``simulate`` and CAMELS ``fit`` on it; a fused GR4J fit
                  (K1) checkpointed to a directory
                  (``torch.distributed.checkpoint``), broken off and
                  resumed, bit for bit the unbroken fit, unsharded and on
                  4 shards of cuda:0; GR4J ``fit(method='sce',
                  engine='scan', mesh=)`` on ``default_mesh()`` and on 4
                  shards of cuda:0 bit for bit the unsharded SCE fit, the
                  fused form raising; ``config.enable_x64()`` making a
                  fused ``simulate`` without ``dtype`` K3's float64 run.
                  Then each kernel is compared with its plain version at
                  the shapes the main path gave it;
6. times       -- each kernel against its plain version and its bound:
                  GR4J and HBV-Edu at 131072 members x 3651 days, the snow
                  kernels at 131072 x 3651 x 5 layers (hysteresis + ice),
                  ABC at 10 000 000 steps; the state kernels cold and warm,
                  and the warm objectives beside the cold ones; K8, K12 and
                  K1/K2 also at the shapes of a fit generation (135 x 1827
                  x 5 layers, 165 x 3652, 60 x 12418), K8, K12 and K2 over
                  N = 16896 .. 262144 at T = 3651, and the SASS
                  instructions of the time loops of the objectives, K5 and
                  K9 by class; K9 also at GLUE's 20000 x 3652 (one layer);
                  K5 at 8 catchments x 131072 x 3651 (UH (3, 7) and (10,
                  21)) and over the regional path's 12418 days, and K11 at
                  8 x 131072 x 3651 x 5 layers; K10 and K14 also at the
                  forecast path's shapes (the one-member spin-up over 1462
                  days x 5 layers and 3287 days, the 131072-member
                  continuation of 365 days), and the SASS of their time
                  loops; K4 also at its forecast shapes (the one-member
                  spin-up over 12053 CAMELS days and the 131072-member
                  continuation of 365 days, UH (10, 21)); K3 also at the
                  main path's one-member simulate over 12418 days; K6 and
                  K7 also at the Monte-Carlo's 4096 x 12418 and in float64
                  at 10M steps.

``--phases a,b`` (development) runs only the named phases after the build:
kernels, golden, main, forecast, regional, tools, assim, mesh, examples,
surface, times; the result
lines need them all (``assim`` without ``main`` takes the golden parameter
sets for the calibrated ones).  ``--compare DIR[,DIR...]`` (development) builds the kernel sources in
each DIR (another version's ``rrmpg_tpu_torch/csrc``) beside this
checkout's, times K1-K14 of both in turns with the largest output
difference between the builds (K4, K10 and K14 also at the forecast path's
shapes, K3 at the main path's simulate, K6 and K7 at their phase-6
shapes), and holds K1/K2, K5/K9, K10/K14, K4/K13 (trajectories and every
state row) and K3/K7 of both to each other bit for bit on the goldens and
edge inputs; it exits 3.

The last two lines are a JSON object describing the kernels and the
result line ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import functools
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import rrmpg_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
F32, F64 = torch.float32, torch.float64
GR4J_SRC = "rrmpg_tpu_torch/csrc/gr4j_fused.cu"
ABC_SRC = "rrmpg_tpu_torch/csrc/abc_scan.cu"
HBV_SRC = "rrmpg_tpu_torch/csrc/hbv_fused.cu"
SNOW_SRC = "rrmpg_tpu_torch/csrc/snow_fused.cu"
SNOW_OBJECTIVE_SRC = "rrmpg_tpu_torch/csrc/snow_objective.cu"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "gr4j_mse": (GR4J_SRC, "rrmpg_tpu/ops/pallas_gr4j.py:228"),
    "gr4j_stats": (GR4J_SRC, "rrmpg_tpu/ops/pallas_gr4j.py:285"),
    "gr4j_traj": (GR4J_SRC, "rrmpg_tpu/ops/pallas_gr4j.py:156"),
    "abc_fused_single": (ABC_SRC, "rrmpg_tpu/ops/pallas_linear_scan.py:169"),
    "abc_fused": (ABC_SRC, "rrmpg_tpu/ops/pallas_linear_scan.py:28"),
    "hbv_objective": (HBV_SRC, "rrmpg_tpu/ops/pallas_hbv.py:109"),
    "hbv_traj": (HBV_SRC, "rrmpg_tpu/ops/pallas_hbv.py:203"),
    "snow_objective": (SNOW_OBJECTIVE_SRC,
                       "rrmpg_tpu/ops/pallas_snow.py:115"),
    "snow_traj": (SNOW_OBJECTIVE_SRC, "rrmpg_tpu/ops/pallas_snow.py:213"),
    "gr4j_traj_state": (GR4J_SRC, "rrmpg_tpu/ops/pallas_gr4j.py:179"),
    "hbv_traj_state": (HBV_SRC, "rrmpg_tpu/ops/pallas_hbv.py:223"),
    "snow_traj_state": (SNOW_SRC, "rrmpg_tpu/ops/pallas_snow.py:336"),
    "gr4j_regional": (GR4J_SRC, "rrmpg_tpu/ops/pallas_gr4j.py:680"),
    "snow_regional": (SNOW_OBJECTIVE_SRC,
                      "rrmpg_tpu/ops/pallas_snow.py:1027"),
}
# Kernels with several modes: mode -> (line of the mode in the TPU kernel,
# the key its launches, error and times are kept under).  The entry of the
# ``kernels`` line carries the mode named in TOP_MODE at the top.
KERNEL_MODES = {
    "gr4j_mse": {"cold": ("rrmpg_tpu/ops/pallas_gr4j.py:228", "gr4j_mse"),
                 "warm": ("rrmpg_tpu/ops/pallas_gr4j.py:143",
                          "gr4j_mse_warm")},
    "gr4j_stats": {"cold": ("rrmpg_tpu/ops/pallas_gr4j.py:285",
                            "gr4j_stats"),
                   "warm": ("rrmpg_tpu/ops/pallas_gr4j.py:143",
                            "gr4j_stats_warm")},
    "hbv_objective": {"mse": ("rrmpg_tpu/ops/pallas_hbv.py:109", "hbv_mse"),
                      "stats": ("rrmpg_tpu/ops/pallas_hbv.py:151",
                                "hbv_stats"),
                      "warm": ("rrmpg_tpu/ops/pallas_hbv.py:95",
                               "hbv_warm")},
    "snow_objective": {"mse": ("rrmpg_tpu/ops/pallas_snow.py:264",
                               "snow_mse"),
                       "stats": ("rrmpg_tpu/ops/pallas_snow.py:265",
                                 "snow_stats"),
                       "sca_stats": ("rrmpg_tpu/ops/pallas_snow.py:270",
                                     "snow_sca_stats"),
                       "warm": ("rrmpg_tpu/ops/pallas_snow.py:150",
                                "snow_warm")},
    "gr4j_traj_state": {
        "cold": ("rrmpg_tpu/ops/pallas_gr4j.py:179", "gr4j_traj_state_cold"),
        "warm": ("rrmpg_tpu/ops/pallas_gr4j.py:143",
                 "gr4j_traj_state_warm")},
    "hbv_traj_state": {
        "cold": ("rrmpg_tpu/ops/pallas_hbv.py:223", "hbv_traj_state_cold"),
        "warm": ("rrmpg_tpu/ops/pallas_hbv.py:95", "hbv_traj_state_warm")},
    "snow_traj_state": {
        "cold": ("rrmpg_tpu/ops/pallas_snow.py:336", "snow_traj_state_cold"),
        "warm": ("rrmpg_tpu/ops/pallas_snow.py:366",
                 "snow_traj_state_warm")},
}
TOP_MODE = {"gr4j_mse": "cold", "gr4j_stats": "cold",
            "hbv_objective": "stats", "snow_objective": "stats",
            "gr4j_traj_state": "warm", "hbv_traj_state": "warm",
            "snow_traj_state": "warm"}
BOUNDS_X4_WIDE = 9.9      # exercises every tap of the (10, 21) registers
MC_MEMBERS = 131072
FORECAST_DAYS = 365       # the segment continued and recalibrated on
FORECAST_FIT_MAXITER = 10
SEQUENTIAL_MEMBERS = 4096  # ABC and snow-only continuation, 'scan' engine
# Parameters calibrated by the cold main paths, for the forecast path.
CALIBRATED = {}
ABC_MC_MEMBERS = 4096
ABC_STEPS = 10_000_000
ABC_PARAMS = {'a': 0.3, 'b': 0.2, 'c': 0.15}
TIME_MEMBERS, TIME_STEPS = 131072, 3651
# Golden parameters (tests/test_models_golden.py).
GR4J_GOLDEN = {'x1': np.exp(5.76865628090826),
               'x2': np.sinh(1.61742503661094),
               'x3': np.exp(4.24316129943456),
               'x4': np.exp(-0.117506799276908) + 0.5}
HBV_GOLDEN = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
HBV_INITS = (0.0, 100.0, 3.0, 10.0)      # snow, soil, s1, s2
HBV_AREA = 410                           # km^2, mm/day <-> m^3/s
# The snow goldens' settings (tests/test_models_golden.py).
ALTITUDES = [550, 620, 700, 785, 920]
CEMANEIGE_GOLDEN = {'CTG': 0.25, 'Kf': 3.74}
CEMANEIGEGR4J_GOLDEN = dict(CEMANEIGE_GOLDEN,
                            x1=np.exp(5.25483021675164),
                            x2=np.sinh(1.58209470624126),
                            x3=np.exp(4.3853181982412),
                            x4=np.exp(0.954786342674327) + 0.5)
HYST_GOLDEN = {"Thacc": 18.6, "Rsp": 0.22, "CTG": 0.78, "Kf": 4.02,
               "x1": 546, "x2": 0.53, "x3": 276, "x4": 1.32}
FRAC_ICE_GOLDEN = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
# (name, hyst, ice) of the four GR4J compositions.
SNOW_VARIANTS = (("plain", False, False), ("hyst", True, False),
                 ("ice", False, True), ("hyst+ice", True, True))
SNOW_CHECK_INITS = (2.0, -1.0, 0.4, 0.3)  # snow pack, thermal state, s, r
SNOW_FIT_MAXITER = 20
# Steps of forcing K8 and K12 stage per tile, and a member count that ends
# in a ragged block of 128: the edges the kernels phase checks.
STAGE_TILE = 64
EDGE_MEMBERS = 200
# K1/K2's and K5's edges: one step, less than a tile, a last tile of one
# step, two whole tiles.
GR4J_EDGE_STEPS = (1, 37, 65, 128)
# K9's edges: one step, around and at its 32-step staging and store tiles,
# and last blocks of 72 and of 1 member.
TRAJ_EDGE_STEPS = (1, 37, 64, 65, 128)
TRAJ_EDGE_MEMBERS = (200, 129)
# K10's and K14's edges: one step (warm: shorter than the history), around
# and at their 32-step staging and store tiles, two whole tiles; one member
# (K10: a block of one warp), and last blocks of 1 and of 72 members.
STATE_EDGE_STEPS = (1, 31, 32, 33, 65, 128)
STATE_EDGE_MEMBERS = (1, 129, 200)
# K4's and K13's edges: one step (K4 warm: shorter than the history), around
# and at their 64-step staging and store tiles, two whole tiles.
TILE64_EDGE_STEPS = (1, 63, 64, 65, 128)
# The forecast path's one-member spin-ups: the hysteresis + ice sheet's 1827
# days and the MATLAB HBV-Edu record's 3652, each less the last 365.
SNOW_SPINUP_DAYS = 1827 - FORECAST_DAYS
HBV_SPINUP_DAYS = 3652 - FORECAST_DAYS
FORECAST_UH = (10, 21)   # the hysteresis classes' x4 bound, 10
# Tolerances of the kernel-vs-plain checks, (rtol, atol).  float64: the same
# operations in another order (FMA contraction) and libdevice vs ATen
# tanh/pow.  float32: rounding compounds over thousands of steps of the
# recurrence; the fused-vs-XLA float32 drift of rrmpg_tpu is 8.5e-3
# relative.  ABC in float32: the scan sums in another order than its plain
# version; the error is held to 1e-4 of each series' largest value.
TOL = {F64: {"traj": (1e-9, 1e-12), "obj": (1e-9, 1e-12)},
       F32: {"traj": (5e-3, 1e-3), "obj": (2e-2, 0.0)}}
ABC_TOL_F64 = (1e-9, 1e-12)
ABC_RTOL_OF_MAX_F32 = 1e-4

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Floating-point operations of one step, counted from the CUDA sources with
# +, -, *, /, compare-and-select and each tanh / sqrt / rsqrt / pow call as
# one operation (a lower count than what the card really issues, so the bound
# stays a bound).  GR4J step: production store 28 (one arm a step, as
# gr4j_production computes it: the two-arm gr4j_step_pr does 37), UH
# registers 2 + (2*NUH1 - 1) + (2*NUH2 - 1), routing store and outflow 21.
# hbv_step: snow 10, soil 14, reservoirs and discharge 17.  ABC: a*P,
# alpha*S + B, coeff*P + c*S_prev.  Objective sums: 3 (MSE) or 8 (stats).
GR4J_STEP_OPS = {(3, 7): 28 + 2 + 5 + 13 + 21, (10, 21): 28 + 2 + 19 + 41 + 21}
HBV_STEP_OPS = 10 + 14 + 17
ABC_STEP_OPS = 6
OBJECTIVE_OPS = {"mse": 3, "stats": 8}
# snow_step.cuh, per layer and step: snow_layer_step 20 (plain) or 32
# (hysteresis), the ice melt 5, the layer sum 1; per step 2 for the mean and
# the ice term; the objective always forms its four sums (8); the SCA
# statistics add 10 per band.
SNOW_LAYER_OPS = {False: 20, True: 32}
SNOW_ICE_OPS = 5
SNOW_SUMS_OPS = 8
SNOW_SCA_OPS = 10      # per band: 100*sca, the difference, four sums
# GPU cycles to spin before a timed run of launches, so that the host has
# queued them all before the first one starts.
SPIN_CYCLES = 40_000_000


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def errors(got, want, rtol, atol, nan_ok=False):
    """(max abs err, max rel err, within allclose(rtol, atol), NaN count).

    Outputs must be finite, except with ``nan_ok`` (HBV-Edu members whose
    soil store went negative): then kernel and plain version must be NaN
    at the same places and the rest is compared."""
    got, want = got.double(), want.double()
    nan = torch.isnan(want)
    if nan_ok:
        check(torch.equal(torch.isnan(got), nan),
              "kernel and plain version are NaN at different places")
        got, want = got[~nan], want[~nan]
    else:
        check(torch.isfinite(got).all().item(), "kernel output is not finite")
    if got.numel() == 0:
        return 0.0, 0.0, True, int(nan.sum())
    diff = (got - want).abs()
    diff = torch.where(got == want, 0.0, diff)        # equal infinities
    rel = diff / want.abs().clamp_min(torch.finfo(F64).tiny)
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), float(rel.max()), ok, int(nan.sum())


def report(label, got, want, rtol, atol, nan_ok=False):
    """Print one kernel-vs-plain comparison and fail if it disagrees;
    returns the max abs error."""
    torch.cuda.synchronize()
    abs_err, rel_err, ok, n_nan = errors(got, want, rtol, atol, nan_ok)
    nan_note = f" nan={n_nan}/{want.numel()}" if nan_ok else ""
    print(f"    {label} shape={tuple(got.shape)} max_abs={abs_err:.3e} "
          f"max_rel={rel_err:.3e} rtol={rtol:g} atol={atol:.3g}{nan_note} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: kernel disagrees with its plain version")
    return abs_err


def report_members(label, got, want):
    """Print one comparison of (N, T) float32 ABC series and fail unless
    every member is within ABC_RTOL_OF_MAX_F32 of that member's own
    largest value; returns the max abs error."""
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{label}: not finite")
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    limit = ABC_RTOL_OF_MAX_F32 * want.abs().amax(dim=-1, keepdim=True)
    share = float((diff / limit.clamp_min(torch.finfo(F64).tiny)).max())
    ok = bool((diff <= limit).all())
    print(f"    {label} shape={tuple(got.shape)} max_abs={float(diff.max()):.3e}"
          f" worst share of the member's limit {share:.3e} (limits "
          f"{float(limit.min()):.3g}..{float(limit.max()):.3g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: a member disagrees beyond its tolerance")
    return float(diff.max())


def abc_tol(want):
    if want.dtype == F64:
        return ABC_TOL_F64
    return 0.0, ABC_RTOL_OF_MAX_F32 * float(want.abs().max())


def device_ms(fn, reps):
    """Mean device time in ms of ``reps`` calls queued back to back (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops, n_bytes):
    """The least time the card could take, and which resource binds."""
    by_ops = ops / PEAK_F32_FLOPS * 1e3
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def as_tensor(a, dtype):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=DEVICE)


def basin():
    from rrmpg_tpu_torch.data import CAMELSLoader

    df = CAMELSLoader().load_basin('01031500')
    return (df['QObs(mm/d)'].to_numpy(), df['prcp(mm/day)'].to_numpy(),
            df['PET'].to_numpy())


def hbv_data():
    """The MATLAB example: daily forcing, monthly climatologies and the
    MATLAB discharge (m^3/s)."""
    import pandas as pd

    data = REPO / "tests" / "data"
    daily = pd.read_csv(data / 'hbv_daily_inputs.txt', sep='\t',
                        names=['date', 'month', 'temp', 'prec'])
    monthly = pd.read_csv(data / 'hbv_monthly_inputs.txt', sep=' ',
                          names=['temp', 'not_needed', 'evap'])
    qsim = pd.read_csv(data / 'hbv_qsim.csv', header=None, names=['qsim'])
    forcing = dict(temp=daily.temp.to_numpy(), prec=daily.prec.to_numpy(),
                   month=daily.month.to_numpy(), PE_m=monthly.evap.to_numpy(),
                   T_m=monthly.temp.to_numpy())
    return forcing, qsim.qsim.to_numpy()


def gr4j_random_params(rng, n, x4_hi, dtype):
    p = {'x1': rng.uniform(100, 1200, n), 'x2': rng.uniform(-5, 3, n),
         'x3': rng.uniform(20, 300, n), 'x4': rng.uniform(1.1, x4_hi, n)}
    return {k: as_tensor(v, dtype) for k, v in p.items()}


def hbv_random_params(rng, n, dtype, n_dry=0):
    """Members within the class bounds; the first ``n_dry`` get a field
    capacity that empties the soil store, so they go NaN."""
    from rrmpg_tpu_torch.models import HBVEdu

    p = {k: rng.uniform(lo, hi, n)
         for k, (lo, hi) in HBVEdu._default_bounds.items()}
    p['FC'][:n_dry] = 2.0
    return {k: as_tensor(v, dtype) for k, v in p.items()}


def hbv_tensors(forcing, dtype, t_len=None):
    """(temp, prec, month0, pe_m, t_m) tensors as the wrappers take them."""
    cut = slice(None, t_len)
    return (as_tensor(forcing['temp'][cut], dtype),
            as_tensor(forcing['prec'][cut], dtype),
            torch.tensor(forcing['month'][cut] - 1, device=DEVICE),
            as_tensor(forcing['PE_m'], dtype), as_tensor(forcing['T_m'], dtype))


def hbv_kernel(fh, tensors, qobs, params, mode, masked=False):
    """One HBV kernel mode ('traj', 'mse' or 'stats') through its wrapper."""
    if mode == "traj":
        return fh.hbv_simulate_fused(*tensors, *HBV_INITS, params)
    return fh.hbv_ensemble_mse_fused(*tensors, qobs, *HBV_INITS, params,
                                     stats=mode == "stats", masked=masked)


def hbv_plain(fh, tensors, qobs, params, mode, masked=False):
    """The plain version of the same mode on the same inputs."""
    temp, prec, month, pe_m, t_m = tensors
    series = (temp, prec, pe_m[month], t_m[month])
    packed = fh.pack_params(params, *HBV_INITS)
    if mode == "traj":
        return fh.hbv_simulate_reference(*series, packed)
    count = int(torch.isfinite(qobs).sum()) if masked else qobs.shape[0]
    return fh.hbv_objective_reference(*series, qobs, packed, mode == "stats",
                                      masked, count)

class SnowData:
    """Layer forcing and observations of one snow call, on the card;
    ``qobs`` and ``ndsi`` are keyed by ``masked`` (the gapped copies)."""

    def __init__(self, prec, temp, frac, etp, frac_ice, qobs, ndsi=None,
                 qobs_gap=None, ndsi_gap=None):
        self.prec, self.temp, self.frac, self.etp = prec, temp, frac, etp
        self.frac_ice = frac_ice
        self.qobs = {False: qobs, True: qobs if qobs_gap is None else qobs_gap}
        self.ndsi = {False: ndsi, True: ndsi if ndsi_gap is None else ndsi_gap}

    def cut(self, lo, hi):
        """The same data over the steps [lo, hi)."""
        rows = lambda x: None if x is None else x[lo:hi].contiguous()
        bands = lambda x: None if x is None else x[:, lo:hi].contiguous()
        return SnowData(rows(self.prec), rows(self.temp), rows(self.frac),
                        rows(self.etp), self.frac_ice, rows(self.qobs[False]),
                        bands(self.ndsi[False]), rows(self.qobs[True]),
                        bands(self.ndsi[True]))

    def tile_edge_gaps(self):
        """This data with gaps (masked copies only) on both sides of every
        64-step tile edge: discharge, the first NDSI band, and a run
        across the first edge in the last band."""
        qobs, ndsi = self.qobs[True].clone(), self.ndsi[True].clone()
        t_len = qobs.shape[0]
        edges = [t for t in (STAGE_TILE - 1, STAGE_TILE, 2 * STAGE_TILE - 1,
                             2 * STAGE_TILE) if t < t_len]
        qobs[edges] = torch.nan
        ndsi[0, edges] = torch.nan
        ndsi[-1, STAGE_TILE - 4:STAGE_TILE + 6] = torch.nan
        return SnowData(self.prec, self.temp, self.frac, self.etp,
                        self.frac_ice, self.qobs[False], self.ndsi[False],
                        qobs, ndsi)

    @classmethod
    def random(cls, rng, t_len, num_layers, dtype, temp_range=(-12, 18),
               frac_range=(-0.3, 1.2), ice_hi=0.7, qobs_range=(1, 5)):
        shape = (t_len, num_layers)
        forcing = [as_tensor(a, dtype) for a in (
            rng.uniform(0, 15, shape), rng.uniform(*temp_range, shape),
            np.clip(rng.uniform(*frac_range, shape), 0, 1),
            rng.uniform(0, 4, t_len), rng.uniform(0, ice_hi, num_layers))]
        qobs = rng.uniform(*qobs_range, t_len)
        ndsi = rng.uniform(0, 100, (num_layers, t_len))
        # Gaps: discharge and each band by their own.
        qobs_gap, ndsi_gap = qobs.copy(), ndsi.copy()
        qobs_gap[::17] = np.nan
        qobs_gap[40:55] = np.nan
        ndsi_gap[0, ::5] = np.nan
        ndsi_gap[-1, 100:160] = np.nan
        return cls(*forcing, *(as_tensor(a, dtype) for a in (
            qobs, ndsi, qobs_gap, ndsi_gap)))


def snow_random_params(rng, n, dtype, x4_hi):
    """Members over the widest bounds of the snow classes."""
    p = {'CTG': rng.uniform(0, 1, n), 'Kf': rng.uniform(0, 10, n),
         'Thacc': rng.uniform(1, 100, n), 'Rsp': rng.uniform(0, 1, n),
         'x1': rng.uniform(10, 1200, n), 'x2': rng.uniform(-5, 3, n),
         'x3': rng.uniform(20, 5000, n), 'x4': rng.uniform(1.1, x4_hi, n),
         'DDF': rng.uniform(0, 30, n)}
    return {k: as_tensor(v, dtype) for k, v in p.items()}


def snow_call(fs, d, params, mode, hyst=False, ice=False, snow_only=False,
              uh=(10, 21), masked=False, inits=SNOW_CHECK_INITS, plain=False):
    """One mode ('traj', 'mse', 'stats' or 'sca_stats') of K8 / K9 through
    its wrapper or, with ``plain``, the plain version on the same inputs."""
    snow0, th0, s_init, r_init = inits
    frac_ice = d.frac_ice if ice else None
    sca = mode == "sca_stats"
    qobs, ndsi = d.qobs[masked], (d.ndsi[masked] if sca else None)
    if not plain:
        if mode == "traj":
            return fs.snowgr4j_simulate_fused(
                d.prec, d.temp, d.etp, d.frac, snow0, th0, s_init, r_init,
                params, frac_ice=frac_ice, hyst=hyst, ice=ice,
                snow_only=snow_only, num_uh1=uh[0], num_uh2=uh[1])
        return fs.snowgr4j_ensemble_mse_fused(
            d.prec, d.temp, d.etp, d.frac, qobs, snow0, th0, s_init, r_init,
            params, frac_ice=frac_ice, ndsi=ndsi, hyst=hyst, ice=ice,
            stats=mode == "stats", sca_stats=sca, snow_only=snow_only,
            num_uh1=uh[0], num_uh2=uh[1], masked=masked)
    packed = fs.pack_params(params, s_init, r_init, snow_only)
    snow, rain, consts = fs.layer_inputs(d.prec, d.frac, hyst)
    if frac_ice is None:
        frac_ice = torch.zeros_like(d.frac_ice)
    args = (packed, consts, frac_ice, snow0, th0, hyst, ice, snow_only, *uh)
    if mode == "traj":
        return fs.snowgr4j_simulate_reference(snow, rain, d.temp, d.etp,
                                              *args)
    count = int(torch.isfinite(qobs).sum())
    return fs.snowgr4j_objective_reference(
        snow, rain, d.temp, d.etp, qobs, *args, stats=mode == "stats",
        masked=masked, count=count,
        ndsi=ndsi.T.contiguous() if sca else None,
        band_counts=(torch.isfinite(ndsi).sum(dim=1).to(ndsi.dtype)
                     if sca else None))



# ---------------------------------------------------------------------------
# The state kernels and the warm objectives: kernel and plain version on the
# same inputs
# ---------------------------------------------------------------------------

def gr4j_rows(state):
    """A batched GR4JState as the (2 + H, N) rows the kernel writes."""
    return torch.cat([state.s[None], state.r[None], state.pr_history.T])


def snow_rows(state):
    """A batched SnowGR4JState as rows: GR4J's, then every snow leaf (the
    layer constants last)."""
    return torch.cat([gr4j_rows(state.gr4j)] + [leaf.T for leaf in state.snow])


def gr4j_state_plain(fg, prec, etp, params, state, uh, inits=(0.0, 0.0)):
    """The plain version of K4 on the same inputs: (q, (2 + H, N) rows)."""
    packed = fg.pack_params(params, *inits, state)
    hist = None if state is None else fg.history_rows(state, uh[1], prec)
    return fg.gr4j_simulate_state_reference(prec, etp, packed, hist, *uh)


def gr4j_state_pair(fg, prec, etp, params, state, uh, inits=(0.0, 0.0)):
    """K4 and its plain version: the kernel's final state, then
    ((q, q_plain), (rows, rows_plain))."""
    got_q, got_st = fg.gr4j_simulate_state_fused(prec, etp, params, state,
                                                 *inits, *uh)
    want_q, want_rows = gr4j_state_plain(fg, prec, etp, params, state, uh,
                                         inits)
    return got_st, (got_q, want_q), (gr4j_rows(got_st), want_rows)


def gr4j_warm_objective_pair(fg, prec, etp, qobs, params, state, uh, stats,
                             masked):
    n1, n2 = uh
    got = fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0, params, n1,
                                     n2, stats=stats, masked=masked,
                                     state=state)
    count = int(torch.isfinite(qobs).sum()) if masked else qobs.shape[0]
    want = fg.gr4j_objective_reference(
        prec, etp, qobs, fg.pack_params(params, 0.0, 0.0, state), n1, n2,
        stats, masked, count, fg.history_rows(state, n2, prec))
    return got, want


def hbv_cut(tensors, lo, hi):
    temp, prec, month, pe_m, t_m = tensors
    return (temp[lo:hi].contiguous(), prec[lo:hi].contiguous(),
            month[lo:hi].contiguous(), pe_m, t_m)


def hbv_state_kernel(fh, tensors, params, state, inits=HBV_INITS):
    """K14 through its wrapper; ``state`` is the (snow, soil, s1, s2) tuple
    of a warm entry or None.  Returns (q, final stores)."""
    start = inits if state is None else (0.0, 0.0, 0.0, 0.0)
    return fh.hbv_simulate_state_fused(*tensors, *start, params, state=state)


def hbv_state_plain(fh, tensors, params, state, inits=HBV_INITS):
    """The plain version of K14 on the same inputs: (q, (4, N) rows)."""
    temp, prec, month, pe_m, t_m = tensors
    packed = fh.pack_params(params, *(inits if state is None else state))
    return fh.hbv_simulate_state_reference(
        temp, prec, pe_m[month], t_m[month], packed, state is not None)


def hbv_state_pair(fh, tensors, params, state, inits=HBV_INITS):
    """K14 and its plain version: the kernel's final stores, then
    ((q, q_plain), (rows, rows_plain))."""
    got_q, got_st = hbv_state_kernel(fh, tensors, params, state, inits)
    want_q, want_rows = hbv_state_plain(fh, tensors, params, state, inits)
    return got_st, (got_q, want_q), (torch.stack(got_st), want_rows)


def hbv_warm_objective_plain(fh, tensors, qobs, params, state, stats,
                             masked):
    temp, prec, month, pe_m, t_m = tensors
    count = int(torch.isfinite(qobs).sum()) if masked else qobs.shape[0]
    return fh.hbv_objective_reference(
        temp, prec, pe_m[month], t_m[month], qobs,
        fh.pack_params(params, *state), stats, masked, count, True)


def hbv_warm_objective_pair(fh, tensors, qobs, params, state, stats, masked):
    got = fh.hbv_ensemble_mse_fused(*tensors, qobs, 0.0, 0.0, 0.0, 0.0,
                                    params, stats=stats, masked=masked,
                                    state=state)
    return got, hbv_warm_objective_plain(fh, tensors, qobs, params, state,
                                         stats, masked)


def snow_plain_inputs(fs, d, params, state, hyst, ice, uh, s_init, r_init):
    """What the plain versions take: (snow, rain, packed, layer constants,
    frac_ice, state rows, history, (N, L) constants of the final bundle)."""
    snow, rain, consts = fs.layer_inputs(d.prec, d.frac, hyst)
    frac_ice = d.frac_ice if ice else torch.zeros_like(d.frac_ice)
    n, num_layers = params['CTG'].shape[0], d.prec.shape[1]
    if state is None:
        return (snow, rain, fs.pack_params(params, s_init, r_init), consts,
                frac_ice, None, None,
                consts.expand(n, num_layers).contiguous())
    state_in, consts, hist = fs.warm_rows(state, hyst, num_layers, uh[1],
                                          d.etp)
    return (snow, rain, fs.pack_params(params, 0.0, 0.0, False, state.gr4j),
            consts, frac_ice, state_in, hist, consts.T.contiguous())


def snow_state_kernel(fs, d, params, state, hyst, ice, uh,
                      inits=SNOW_CHECK_INITS):
    """K10 through its wrapper: (q, final bundle).  A warm entry reads no
    init scalar."""
    snow0, th0, s_init, r_init = (0.0,) * 4 if state is not None else inits
    return fs.snowgr4j_simulate_state_fused(
        d.prec, d.temp, d.etp, d.frac, params, state, snow0, th0, s_init,
        r_init, frac_ice=d.frac_ice if ice else None, hyst=hyst, ice=ice,
        num_uh1=uh[0], num_uh2=uh[1])


def snow_state_plain(fs, d, params, state, hyst, ice, uh,
                     inits=SNOW_CHECK_INITS):
    """The plain version of K10 on the same inputs: (q, final bundle)."""
    snow0, th0, s_init, r_init = (0.0,) * 4 if state is not None else inits
    (snow, rain, packed, consts, frac_ice, state_in, hist,
     consts_nl) = snow_plain_inputs(fs, d, params, state, hyst, ice, uh,
                                    s_init, r_init)
    want_q, want_rows = fs.snowgr4j_simulate_state_reference(
        snow, rain, d.temp, d.etp, packed, consts, frac_ice, snow0, th0, hyst,
        ice, *uh, state_in, hist)
    return want_q, fs.bundle_from_rows(want_rows, consts_nl, hyst, uh[1])


def snow_state_pair(fs, d, params, state, hyst, ice, uh,
                    inits=SNOW_CHECK_INITS):
    """K10 and its plain version: the kernel's final bundle, then
    ((q, q_plain), (bundle, bundle_plain))."""
    got_q, got_st = snow_state_kernel(fs, d, params, state, hyst, ice, uh,
                                      inits)
    want_q, want_st = snow_state_plain(fs, d, params, state, hyst, ice, uh,
                                       inits)
    return got_st, (got_q, want_q), (got_st, want_st)


def snow_warm_objective_kernel(fs, d, params, state, hyst, ice, uh, stats,
                               masked):
    return fs.snowgr4j_ensemble_mse_fused(
        d.prec, d.temp, d.etp, d.frac, d.qobs[masked], 0.0, 0.0, 0.0, 0.0,
        params, frac_ice=d.frac_ice if ice else None, hyst=hyst, ice=ice,
        stats=stats, num_uh1=uh[0], num_uh2=uh[1], state=state,
        masked=masked)


def snow_warm_objective_plain(fs, d, params, state, hyst, ice, uh, stats,
                              masked):
    qobs = d.qobs[masked]
    (snow, rain, packed, consts, frac_ice, state_in, hist,
     _) = snow_plain_inputs(fs, d, params, state, hyst, ice, uh, 0.0, 0.0)
    return fs.snowgr4j_objective_reference(
        snow, rain, d.temp, d.etp, qobs, packed, consts, frac_ice, 0.0, 0.0,
        hyst, ice, False, *uh, stats=stats, masked=masked,
        count=int(torch.isfinite(qobs).sum()), state_in=state_in, hist=hist)


def snow_warm_objective_pair(*args, **kw):
    return (snow_warm_objective_kernel(*args, **kw),
            snow_warm_objective_plain(*args, **kw))


def snow_bits_unequal(got, want):
    """Elements of the snow half of two bundles that differ in any bit (the
    layer constants excluded: they only pass through)."""
    return sum(int((g != w).sum())
               for g, w in zip(got.snow[:-1], want.snow[:-1]))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment():
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA GPU.", file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(card)
    nvcc = subprocess.run(
        [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "nvcc"), "--version"], capture_output=True, text=True)
    nvcc_line = (nvcc.stdout.strip().splitlines() or ["nvcc: none"])[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(f"[1 environment] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"{nvcc_line}, triton {triton_version}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    return card


# A kernel's name and template arguments in a mangled symbol.
KERNEL_NAME = re.compile(r"_cu_[0-9a-f]{8}\d+([a-z0-9_]+_kernel)I(\w+?)EEv")


def template_args(mangled):
    """'fLi10ELi21ELb1E' -> 'float, 10, 21, true'."""
    args = [{"d": "double", "f": "float"}.get(mangled[0], mangled[0])]
    for kind, value in re.findall(r"L([ib])(\d+)E", mangled):
        args.append(value if kind == "i" else str(value == "1").lower())
    return ", ".join(args)


def ptxas_table(log):
    """{kernel<template arguments>: (registers, bytes of spill stores)} of
    every instantiation in nvcc's -Xptxas -v output."""
    table, kernel, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(KERNEL_NAME, ln)
            kernel, spill = (m.group(1) + "<" + template_args(m.group(2))
                             + ">") if m else ln.split("'")[1], 0
        elif "spill stores" in ln:
            spill = max(spill, int(ln.split("bytes spill stores")[0]
                                   .split(",")[-1]))
        elif "Used" in ln and "registers" in ln and kernel:
            regs = int(ln.split("Used")[1].split("registers")[0])
            table[kernel] = (regs, spill)
            kernel = None
    return table


def phase_build():
    from rrmpg_tpu_torch.ops._build import load_library

    lib = load_library()
    print(f"[2 build] {lib.path.name} built in {lib.build_seconds:.1f} s "
          f"(0.0 = found built)")
    # One line per kernel instantiation.
    table = ptxas_table(lib.log)
    for kernel, (regs, spill) in table.items():
        print(f"    ptxas: {kernel}: {regs} registers, {spill} bytes "
              "spill stores")
    check(len(table) > 0, "no kernel found in the build log")


def phase_kernels_gr4j(prec_np, etp_np, qobs_np, n=500, t_len=3651):
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    qobs_gap = qobs_np[:t_len].copy()
    qobs_gap[::17] = np.nan
    qobs_gap[400:430] = np.nan
    n_checks = 0
    for dtype in (F64, F32):
        tol = TOL[dtype]
        prec, etp = as_tensor(prec_np[:t_len], dtype), as_tensor(
            etp_np[:t_len], dtype)
        for n1, n2 in fg.SUPPORTED_UH:
            rng = np.random.default_rng(n1)
            params = gr4j_random_params(
                rng, n, 2.9 if n1 == 3 else BOUNDS_X4_WIDE, dtype)
            packed = fg.pack_params(params, 0.4, 0.3)
            cases = [("traj", fg.gr4j_simulate_fused(
                          prec, etp, 0.4, 0.3, params, n1, n2),
                      fg.gr4j_simulate_reference(prec, etp, packed, n1, n2))]
            for masked, qo in ((False, qobs_np[:t_len]), (True, qobs_gap)):
                qo = as_tensor(qo, dtype)
                count = int(torch.isfinite(qo).sum()) if masked else t_len
                for stats in (False, True):
                    name = ("stats" if stats else "mse") + (
                        "+masked" if masked else "")
                    cases.append((name, fg.gr4j_ensemble_mse_fused(
                        prec, etp, qo, 0.4, 0.3, params, n1, n2,
                        stats=stats, masked=masked),
                        fg.gr4j_objective_reference(
                            prec, etp, qo, packed, n1, n2, stats, masked,
                            count)))
            for name, got, want in cases:
                report(f"gr4j {str(dtype)[6:]} uh=({n1},{n2}) {name:13s}",
                       got, want, *tol["traj" if name == "traj" else "obj"])
                n_checks += 1
    print(f"[3 kernels] GR4J: {n_checks} kernel-vs-plain checks passed at "
          f"N={n}, T={t_len}")
    gr4j_edge_checks(prec_np, etp_np, qobs_np)


def tile_edge_gaps(qobs):
    """A copy of a (..., T) numpy record with NaN on both sides of its
    64-step tile edges (steps 63/64 and 127/128)."""
    qobs = qobs.copy()
    edges = [t for t in (STAGE_TILE - 1, STAGE_TILE, 2 * STAGE_TILE - 1,
                         2 * STAGE_TILE) if t < qobs.shape[-1]]
    qobs[..., edges] = np.nan
    return qobs


def gr4j_edge_checks(prec_np, etp_np, qobs_np):
    """K1/K2 around their staging tiles (64 steps; 32 in the split kernel):
    T = 1, 37, 65 and 128 (one step, shorter than a tile, a last tile of
    one step, whole tiles), gaps on both sides of the tile edges, both UH
    register pairs, MSE and statistics; cold, and warm over 100 steps
    across a tile edge from the state K4 ends 30 cold steps in.  N = 200
    (the split kernel, a ragged last block) and one more than the split
    kernel takes (one member a thread, a last block of one member)."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    n_checks = 0
    sizes = (EDGE_MEMBERS, fg.split_members() + 1)
    for dtype, uh, n in ((d, u, k) for d in (F64, F32)
                         for u in fg.SUPPORTED_UH for k in sizes):
        tol, name = TOL[dtype]["obj"], str(dtype)[6:]
        params = gr4j_random_params(
            np.random.default_rng(uh[1]), n,
            2.9 if uh[0] == 3 else BOUNDS_X4_WIDE, dtype)
        packed = fg.pack_params(params, 0.4, 0.3)
        for t_len in GR4J_EDGE_STEPS:
            prec, etp = (as_tensor(a[:t_len], dtype)
                         for a in (prec_np, etp_np))
            qobs = as_tensor(tile_edge_gaps(qobs_np[:t_len]), dtype)
            want = fg.gr4j_objective_reference(
                prec, etp, qobs, packed, *uh, stats=True, masked=True,
                count=int(torch.isfinite(qobs).sum()))
            for stats in (False, True):
                report(f"gr4j {name} T={t_len} N={n} uh={uh} "
                       f"{'stats' if stats else 'mse'}+masked",
                       fg.gr4j_ensemble_mse_fused(
                           prec, etp, qobs, 0.4, 0.3, params, *uh,
                           stats=stats, masked=True),
                       want if stats else want[0], *tol)
                n_checks += 1
        cut, t_len = 30, 130
        prec, etp = (as_tensor(a[:t_len], dtype)
                     for a in (prec_np, etp_np))
        state, _, _ = gr4j_state_pair(
            fg, prec[:cut].contiguous(), etp[:cut].contiguous(), params,
            None, uh, (0.4, 0.3))
        tail = (prec[cut:].contiguous(), etp[cut:].contiguous(),
                as_tensor(tile_edge_gaps(qobs_np[cut:t_len]), dtype))
        for stats in (False, True):
            got, want = gr4j_warm_objective_pair(fg, *tail, params, state,
                                                 uh, stats, True)
            report(f"gr4j {name} warm T={t_len - cut} across a tile edge "
                   f"N={n} uh={uh} "
                   f"{'stats' if stats else 'mse'}+masked", got, want,
                   *tol)
            n_checks += 1
    print(f"[3 kernels] GR4J K1/K2 tile and block edges: {n_checks} "
          f"kernel-vs-plain checks passed at T in (1, 37, 65, 128) and a "
          f"warm 100-step continuation, N in {sizes}")


def phase_kernels_abc():
    from rrmpg_tpu_torch.ops import abc, fused_abc as fa

    n_checks = 0
    for dtype in (F64, F32):
        for t_len in (1, 1000, 70000, 1_000_003):
            prec = as_tensor(
                np.random.default_rng(t_len).uniform(0, 20, t_len), dtype)
            for c in (0.0, 0.12, 1.0):
                params = {'a': 0.3, 'b': 0.4, 'c': c}
                want = abc.run_abcmodel_pscan(prec, 5.0, params)
                single = fa.abc_fused_single(prec, 5.0, params)
                chunked = fa.abc_fused(prec, 5.0, params)
                pairs = [("K6 vs pscan", single, want),
                         ("K7 vs pscan", chunked, want),
                         ("K6 vs K7", single, chunked)]
                if t_len <= 20000:
                    seq = abc.run_abcmodel(prec, 5.0, params)
                    pairs += [("K6 vs loop", single, seq),
                              ("K7 vs loop", chunked, seq)]
                check(single[1][0].item() == 5.0 and single[0][0].item() == 0
                      and chunked[1][0].item() == 5.0
                      and chunked[0][0].item() == 0,
                      "ABC kernels: S[0] != s0 or q[0] != 0")
                for what, got, ref in pairs:
                    for series, g, w in zip(("q", "S"), got, ref):
                        report(f"abc {str(dtype)[6:]} T={t_len} c={c:g} "
                               f"{what} {series}", g, w, *abc_tol(w))
                        n_checks += 1
    print(f"[3 kernels] ABC: {n_checks} checks passed")


def abc_members(rng, n, dtype):
    """ABC parameters over the class's bounds (b <= 1 - a, as
    ``get_random_params`` draws them), the first three members at c = 0,
    0.12 and 1, and initial storages: (params, s0) on the card."""
    a = rng.uniform(0, 1, n)
    params = {'a': a, 'b': rng.uniform(0, 1 - a), 'c': rng.uniform(0, 1, n)}
    params['c'][:3] = (0.0, 0.12, 1.0)
    return ({k: as_tensor(v, dtype) for k, v in params.items()},
            as_tensor(rng.uniform(0, 9, n), dtype))


def abc_edge_checks(prec_basin):
    """K6 and K7 around their chunks (4096 steps a block in float32, 2048 in
    float64): T one step short of, at and one past one chunk, 33 chunks
    (the last one step long), 257 chunks (K7's carry pass: a team of two
    warps for the member) and 2442 chunks (float32: the bench's 10M
    steps; float64: 2441 chunks and 7 steps), c in (0, 0.12, 1), against
    the doubling scan and each other; at the Monte-Carlo's shape, 4096
    members x 12418 CAMELS days (four chunks a member in float32), both
    types; K6 and K7 in float32 against the doubling scan in float64 on the
    same inputs at 4096 members x 32 chunks, one member at c = 7e-5.  Then
    K6 five times on the same inputs at T = 10M and at the Monte-Carlo
    shape (float32): the same bits every time."""
    from rrmpg_tpu_torch.ops import abc, fused_abc as fa
    from rrmpg_tpu_torch.ops._build import load_library

    n_checks = 0
    for dtype in (F32, F64):
        chunk = load_library().rrmpg_abc_chunk_size(int(dtype == F64))
        last = ABC_STEPS if dtype == F32 else 2441 * chunk + 7
        for t_len in (chunk - 1, chunk, chunk + 1, 32 * chunk + 1,
                      256 * chunk + 1, last):
            prec = as_tensor(
                np.random.default_rng(t_len).uniform(0, 20, t_len), dtype)
            for c in (0.0, 0.12, 1.0):
                params = {'a': 0.3, 'b': 0.4, 'c': c}
                want = abc.run_abcmodel_pscan(prec, 5.0, params)
                single = fa.abc_fused_single(prec, 5.0, params)
                chunked = fa.abc_fused(prec, 5.0, params)
                check(single[1][0].item() == 5.0 and single[0][0].item() == 0,
                      "K6: S[0] != s0 or q[0] != 0")
                for what, got, ref in (("K6 vs pscan", single, want),
                                       ("K7 vs pscan", chunked, want),
                                       ("K6 vs K7", single, chunked)):
                    for series, g, w in zip(("q", "S"), got, ref):
                        report(f"abc {str(dtype)[6:]} T={t_len} "
                               f"({-(-t_len // chunk)} chunks) c={c:g} "
                               f"{what} {series}", g, w, *abc_tol(w))
                        n_checks += 1
        basin = as_tensor(prec_basin, dtype)
        params, s0 = abc_members(np.random.default_rng(3), ABC_MC_MEMBERS,
                                 dtype)
        want = abc.run_abcmodel_pscan(basin, s0, params)
        single = fa.abc_fused_single(basin, s0, params)
        for what, got, ref in (("K6 vs pscan", single, want),
                               ("K7 vs pscan", fa.abc_fused(basin, s0,
                                                            params), want)):
            for series, g, w in zip(("q", "S"), got, ref):
                report(f"abc {str(dtype)[6:]} N={ABC_MC_MEMBERS} "
                       f"T={len(prec_basin)} {what} {series}", g, w,
                       *abc_tol(w))
                n_checks += 1
        check(torch.equal(single[1][:, 0], s0), "K6: S[:, 0] != s0")
    # float32 against float64 on the same float32 inputs where a small c
    # remembers thousands of steps (a fourth member at c = 7e-5): 4096
    # members x 32 chunks.  The doubling scan's error is printed beside.
    t_len = 32 * load_library().rrmpg_abc_chunk_size(0)
    prec = as_tensor(np.random.default_rng(5).uniform(0, 20, t_len), F32)
    params, s0 = abc_members(np.random.default_rng(5), ABC_MC_MEMBERS, F32)
    params['c'][3] = 7e-5
    exact = abc.run_abcmodel_pscan(prec.double(), s0.double(),
                                   {k: v.double() for k, v in params.items()})
    for what, fn in (("K6", fa.abc_fused_single), ("K7", fa.abc_fused),
                     ("doubling scan", abc.run_abcmodel_pscan)):
        for series, g, w in zip(("q", "S"), fn(prec, s0, params), exact):
            label = (f"abc float32 N={ABC_MC_MEMBERS} T={t_len} {what} vs "
                     f"float64 {series}")
            tol = abc_tol(w.float())                  # float32's tolerance
            if what == "doubling scan":
                torch.cuda.synchronize()
                err = errors(g, w, *tol)[0]
                print(f"    {label} max_abs={err:.3e} (of the largest value "
                      f"{err / float(w.abs().max()):.3e}; not checked)")
            else:
                report(label, g, w, *tol)
                n_checks += 1
    del exact
    prec = as_tensor(np.random.default_rng(0).uniform(0, 20, ABC_STEPS), F32)
    basin = as_tensor(prec_basin, F32)
    params, s0 = abc_members(np.random.default_rng(3), ABC_MC_MEMBERS, F32)
    for what, args in ((f"T={ABC_STEPS}", (prec, 0.0, ABC_PARAMS)),
                       (f"N={ABC_MC_MEMBERS} T={len(prec_basin)}",
                        (basin, s0, params))):
        first = fa.abc_fused_single(*args)
        same = all(all(torch.equal(a, b) for a, b in zip(
            first, fa.abc_fused_single(*args))) for _ in range(4))
        print(f"    abc float32 {what} K6 five runs on the same inputs: "
              f"{'the same bits' if same else 'DIFFERENT BITS'}")
        check(same, f"K6 gave other bits on the same inputs ({what})")
        n_checks += 1
    print(f"[3 kernels] ABC K6/K7 chunk edges: {n_checks} checks passed")


def gr4j_traj_edge_checks(prec_np, etp_np):
    """K3 at K4's edges on CAMELS 01031500: T in TILE64_EDGE_STEPS, N in
    STATE_EDGE_MEMBERS (the split kernel: last blocks of 1 and 8 members)
    and one and 72 members past fg.traj_split_members() (the tile kernel:
    last blocks of 1 and 72), both UH register pairs, float64 and float32;
    against the plain version, and bit for bit K4's cold entry."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    n_checks = 0
    sizes = STATE_EDGE_MEMBERS + (fg.traj_split_members() + 1,
                                  fg.traj_split_members() + 72)
    for dtype in (F64, F32):
        tol, name = TOL[dtype]["traj"], str(dtype)[6:]
        for t_len in TILE64_EDGE_STEPS:
            prec, etp = (as_tensor(a[:t_len], dtype)
                         for a in (prec_np, etp_np))
            for n in sizes:
                for uh in fg.SUPPORTED_UH:
                    params = gr4j_random_params(
                        np.random.default_rng(n + uh[0]), n,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE, dtype)
                    got = fg.gr4j_simulate_fused(prec, etp, 0.4, 0.3, params,
                                                 *uh)
                    report(f"gr4j {name} K3 T={t_len} N={n} uh={uh} traj",
                           got, fg.gr4j_simulate_reference(
                               prec, etp, fg.pack_params(params, 0.4, 0.3),
                               *uh), *tol)
                    k4, _ = fg.gr4j_simulate_state_fused(prec, etp, params,
                                                         None, 0.4, 0.3, *uh)
                    check(bits_equal(got, k4), f"gr4j {name} T={t_len} "
                          f"N={n} uh={uh}: K3 and K4's cold entry differ "
                          "in a bit")
                    n_checks += 2
    print(f"[3 kernels] K3 tile and block edges: {n_checks} checks passed at "
          f"T in {TILE64_EDGE_STEPS}, N in {sizes}, both UH, against the "
          f"plain version and bit for bit K4 cold")


def phase_kernels_hbv(forcing, qobs_np, n=1000):
    from rrmpg_tpu_torch.ops import fused_hbv as fh

    qobs_gap = qobs_np.copy()
    qobs_gap[::17] = np.nan
    qobs_gap[400:430] = np.nan
    n_checks = 0
    for dtype in (F64, F32):
        tensors = hbv_tensors(forcing, dtype)
        params = hbv_random_params(np.random.default_rng(12), n, dtype,
                                   n_dry=n // 20)
        for mode, masked in (("traj", False), ("mse", False), ("stats", False),
                             ("mse", True), ("stats", True)):
            qobs = as_tensor(qobs_gap if masked else qobs_np, dtype)
            args = (fh, tensors, qobs, params, mode, masked)
            got, want = hbv_kernel(*args), hbv_plain(*args)
            report(f"hbv {str(dtype)[6:]} {mode}"
                   f"{'+masked' if masked else ''}", got, want,
                   *TOL[dtype]["traj" if mode == "traj" else "obj"],
                   nan_ok=True)
            n_checks += 1
        # K12 at the edges of its staging: T shorter than a tile and two
        # whole tiles (T = 3652 above ends in a ragged one), N not a
        # multiple of the block, gaps on both sides of the tile edges.
        params = hbv_random_params(np.random.default_rng(13), EDGE_MEMBERS,
                                   dtype, n_dry=EDGE_MEMBERS // 20)
        for edge_t in (37, 128):
            gaps = qobs_np[:edge_t].copy()
            gaps[[t for t in (STAGE_TILE - 1, STAGE_TILE, 2 * STAGE_TILE - 1)
                  if t < edge_t]] = np.nan
            for mode, masked in (("mse", False), ("stats", True)):
                qobs = as_tensor(gaps if masked else qobs_np[:edge_t], dtype)
                args = (fh, hbv_tensors(forcing, dtype, edge_t), qobs, params,
                        mode, masked)
                report(f"hbv {str(dtype)[6:]} T={edge_t} N={EDGE_MEMBERS} "
                       f"{mode}{'+masked' if masked else ''}",
                       hbv_kernel(*args), hbv_plain(*args),
                       *TOL[dtype]["obj"], nan_ok=True)
                n_checks += 1
    print(f"[3 kernels] HBV-Edu: {n_checks} kernel-vs-plain checks passed at "
          f"N={n}, T={len(qobs_np)} and N={EDGE_MEMBERS}, T in (37, 128)")


def phase_kernels_snow(n=256, t_len=300):
    """K8 and K9, every instantiated variant against the plain version.

    float32: kernel and plain version are compared on the same float32
    inputs with the tolerances of the other kernels.  The snow step's
    products are written without fused multiply-adds, so both sides take
    the same branches and no member has to be set aside; the snow-only
    outflow, which is the snow state alone, is also counted for bit
    equality.  K8 and K9 run their layers in registers at 1 and 5 layers
    and in shared-memory columns at any other count (2 and 7 here); T = 300
    ends in a ragged tile, and a second pass at T = 37 (shorter than a
    tile) and T = 128 (two whole tiles) with N = 200 (a ragged last block)
    and gaps at the tile edges covers the edges of K8's staging
    (snow_traj_edge_checks those of K9)."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n_checks, unequal = 0, 0
    for dtype in (F64, F32):
        tol = TOL[dtype]
        name = str(dtype)[6:]
        for num_layers in (1, 2, 5, 7):
            d = SnowData.random(np.random.default_rng(num_layers), t_len,
                                num_layers, dtype)
            # The snow-only routine (no GR4J, no UH registers).
            params = snow_random_params(np.random.default_rng(3), n, dtype,
                                        2.9)
            cases = [("traj", False)] + [
                (mode, masked) for masked in (False, True)
                for mode in ("mse", "stats")]
            for mode, masked in cases:
                kw = dict(snow_only=True, masked=masked)
                got = snow_call(fs, d, params, mode, **kw)
                want = snow_call(fs, d, params, mode, plain=True, **kw)
                report(f"snow {name} L={num_layers} snow-only {mode}"
                       f"{'+masked' if masked else ''}", got, want,
                       *tol["traj" if mode == "traj" else "obj"])
                n_checks += 1
                if mode == "traj":
                    unequal += int((got != want).sum())
            for uh in fg.SUPPORTED_UH:
                params = snow_random_params(
                    np.random.default_rng(uh[0]), n, dtype,
                    2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                for variant, hyst, ice in SNOW_VARIANTS:
                    kw = dict(hyst=hyst, ice=ice, uh=uh)
                    label = (f"snow {name} L={num_layers} uh={uh} "
                             f"{variant:8s}")
                    report(f"{label} traj",
                           snow_call(fs, d, params, "traj", **kw),
                           snow_call(fs, d, params, "traj", plain=True,
                                     **kw), *tol["traj"])
                    n_checks += 1
                    for masked in (False, True):
                        n_checks += snow_objective_checks(
                            fs, d, params, label, masked, kw, tol["obj"])
        # The edges of the staging: T shorter than a tile and a whole
        # number of tiles, N not a multiple of the block, gaps on both
        # sides of every tile edge.
        for edge_t in (37, 128):
            for num_layers in (1, 2, 5, 7):
                d = SnowData.random(np.random.default_rng(edge_t), edge_t,
                                    num_layers, dtype).tile_edge_gaps()
                params = snow_random_params(np.random.default_rng(4),
                                            EDGE_MEMBERS, dtype, 2.9)
                label = (f"snow {name} T={edge_t} N={EDGE_MEMBERS} "
                         f"L={num_layers}")
                kw = dict(snow_only=True, masked=True)
                report(f"{label} snow-only stats+masked",
                       snow_call(fs, d, params, "stats", **kw),
                       snow_call(fs, d, params, "stats", plain=True, **kw),
                       *tol["obj"])
                n_checks += 1 + snow_objective_checks(
                    fs, d, params, f"{label} hyst+ice", True,
                    dict(hyst=True, ice=True, uh=(3, 7)), tol["obj"])
    print(f"[3 kernels] snow: {n_checks} kernel-vs-plain checks passed at "
          f"N={n}, T={t_len}, L in (1, 2, 5, 7), and at T in (37, 128), "
          f"N={EDGE_MEMBERS}; snow-only outflow elements that differ from "
          f"the plain version in any bit: {unequal}")
    check(unequal == 0, "the snow-only outflow of K9 is not the plain "
          "version's bit for bit")
    snow_traj_edge_checks()


def snow_traj_edge_checks():
    """K9 around its staging and store tiles (32 steps) and its blocks:
    T = 1, 37, 64, 65 and 128, N = 200 and 129 (ragged last blocks of 72
    and 1 members), 1, 2, 5 and 7 layers (registers at 1 and 5, shared
    columns otherwise), the snow-only routine (its outflow bit for bit) at
    every edge and one composition variant at one UH register pair at each
    (T, N, L, dtype) edge, taken in turn so that every layer count and
    dtype, and every (T, N) edge across its eight (L, dtype) slots, sees all
    eight, float64 and float32."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n_checks, unequal = 0, 0
    combos = [(uh, v) for uh in fg.SUPPORTED_UH for v in SNOW_VARIANTS]
    for i_dtype, dtype in enumerate((F64, F32)):
        tol, name = TOL[dtype]["traj"], str(dtype)[6:]
        for i_t, t_len in enumerate(TRAJ_EDGE_STEPS):
            for i_layer, num_layers in enumerate((1, 2, 5, 7)):
                d = SnowData.random(np.random.default_rng(t_len + num_layers),
                                    t_len, num_layers, dtype)
                for i_n, n in enumerate(TRAJ_EDGE_MEMBERS):
                    label = f"snow {name} traj T={t_len} N={n} L={num_layers}"
                    params = snow_random_params(np.random.default_rng(n), n,
                                                dtype, 2.9)
                    got = snow_call(fs, d, params, "traj", snow_only=True)
                    want = snow_call(fs, d, params, "traj", snow_only=True,
                                     plain=True)
                    report(f"{label} snow-only", got, want, *tol)
                    unequal += int((got != want).sum())
                    n_checks += 1
                    # One composition an edge, in turn: the 10 (T, N) edges
                    # of each dtype and layer count take all 8 (UH pair,
                    # variant) pairs, and so do the 8 (L, dtype) slots of
                    # each (T, N) edge.
                    uh, (variant, hyst, ice) = combos[
                        (i_t * len(TRAJ_EDGE_MEMBERS) + i_n + 4 * i_dtype
                         + i_layer) % len(combos)]
                    params = snow_random_params(
                        np.random.default_rng(n + uh[0]), n, dtype,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                    kw = dict(hyst=hyst, ice=ice, uh=uh)
                    report(f"{label} uh={uh} {variant}",
                           snow_call(fs, d, params, "traj", **kw),
                           snow_call(fs, d, params, "traj", plain=True, **kw),
                           *tol)
                    n_checks += 1
    print(f"[3 kernels] K9 tile and block edges: {n_checks} kernel-vs-plain "
          f"checks passed at T in {TRAJ_EDGE_STEPS}, N in "
          f"{TRAJ_EDGE_MEMBERS}, L in (1, 2, 5, 7), the snow-only routine "
          f"and one (UH pair, variant) an edge in turn (all 8 at every L "
          f"and dtype, and at every (T, N)); snow-only outflow elements that "
          f"differ from the plain version in any bit: {unequal}")
    check(unequal == 0, "the snow-only outflow of K9 is not the plain "
          "version's bit for bit")


def snow_objective_checks(fs, d, params, label, masked, kw, tol):
    """K8's modes (MSE, statistics and with hysteresis the SCA statistics)
    against one plain run of the widest: MSE is row 0 of the statistics,
    which are rows 0..3 of the SCA statistics.  Returns the count."""
    widest = "sca_stats" if kw["hyst"] else "stats"
    want = snow_call(fs, d, params, widest, plain=True, masked=masked, **kw)
    n_checks = 0
    for mode in ("mse", "stats", "sca_stats"):
        if mode == "sca_stats" and not kw["hyst"]:
            continue
        got = snow_call(fs, d, params, mode, masked=masked, **kw)
        ref = {"mse": want[0], "stats": want[:4], "sca_stats": want}[mode]
        report(f"{label} {mode}{'+masked' if masked else ''}", got, ref,
               *tol)
        n_checks += 1
    return n_checks


def phase_kernels_state_gr4j(prec_np, etp_np, qobs_np, n=500, t_len=3651,
                             warm_len=1000):
    """K4 cold over the first ``t_len - warm_len`` steps and warm over the
    rest, the warm K1/K2 on that rest, short segments, a long history into
    short registers, and in float64 the split run against the unbroken K3."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    cut = t_len - warm_len
    qobs_gap = qobs_np[cut:t_len].copy()
    qobs_gap[::17] = np.nan
    qobs_gap[400:430] = np.nan
    n_checks = 0
    for dtype in (F64, F32):
        tol, name = TOL[dtype], str(dtype)[6:]
        prec, etp = (as_tensor(a[:t_len], dtype) for a in (prec_np, etp_np))
        head = (prec[:cut].contiguous(), etp[:cut].contiguous())
        tail = (prec[cut:].contiguous(), etp[cut:].contiguous())
        for uh in fg.SUPPORTED_UH:
            params = gr4j_random_params(
                np.random.default_rng(uh[0]), n,
                2.9 if uh[0] == 3 else BOUNDS_X4_WIDE, dtype)
            label = f"gr4j {name} uh={uh}"
            state, traj, rows = gr4j_state_pair(fg, *head, params, None, uh,
                                                (0.4, 0.3))
            report(f"{label} K4 cold traj", *traj, *tol["traj"])
            report(f"{label} K4 cold state rows", *rows, *tol["traj"])
            state_b, traj_b, rows_b = gr4j_state_pair(fg, *tail, params,
                                                      state, uh)
            report(f"{label} K4 warm traj", *traj_b, *tol["traj"])
            report(f"{label} K4 warm state rows", *rows_b, *tol["traj"])
            n_checks += 4
            # Segments shorter than the history, warm and cold.
            short = (tail[0][:3].contiguous(), tail[1][:3].contiguous())
            for entry, st in (("warm", state), ("cold", None)):
                _, traj_s, rows_s = gr4j_state_pair(fg, *short, params, st,
                                                    uh, (0.0, 0.0))
                report(f"{label} K4 {entry} T=3 traj", *traj_s, *tol["traj"])
                report(f"{label} K4 {entry} T=3 state rows", *rows_s,
                       *tol["traj"])
                n_checks += 2
            if uh == (3, 7):
                # A 20-tap history (a (10, 21) run of the same members)
                # enters the (3, 7) kernel trimmed to its last 6 taps.
                long_state, _, _ = gr4j_state_pair(fg, *head, params, None,
                                                   (10, 21), (0.4, 0.3))
                check(long_state.pr_history.shape == (n, 20),
                      "the (10, 21) state does not carry 20 taps")
                some = (tail[0][:50].contiguous(), tail[1][:50].contiguous())
                _, traj_l, rows_l = gr4j_state_pair(fg, *some, params,
                                                    long_state, uh)
                report(f"{label} K4 warm, 20-tap history, traj", *traj_l,
                       *tol["traj"])
                report(f"{label} K4 warm, 20-tap history, state rows",
                       *rows_l, *tol["traj"])
                n_checks += 2
            for masked, qo in ((False, qobs_np[cut:t_len]), (True, qobs_gap)):
                qo = as_tensor(qo, dtype)
                for stats in (False, True):
                    got, want = gr4j_warm_objective_pair(
                        fg, *tail, qo, params, state, uh, stats, masked)
                    report(f"{label} warm {'stats' if stats else 'mse'}"
                           f"{'+masked' if masked else ''}", got, want,
                           *tol["obj"])
                    n_checks += 1
            if dtype == F64:
                full = fg.gr4j_simulate_fused(prec, etp, 0.4, 0.3, params,
                                              *uh)
                report(f"{label} split K4 + K4 vs unbroken K3",
                       torch.cat([traj[0], traj_b[0]], dim=1), full, 1e-9,
                       1e-12)
                n_checks += 1
    print(f"[3 kernels] GR4J state kernel and warm objectives: {n_checks} "
          f"checks passed at N={n}, T={cut} cold + {warm_len} warm")


def phase_kernels_state_hbv(forcing, qobs_np, n=1000, warm_len=1000):
    from rrmpg_tpu_torch.ops import fused_hbv as fh

    t_len = len(qobs_np)
    cut = t_len - warm_len
    qobs_gap = qobs_np[cut:].copy()
    qobs_gap[::17] = np.nan
    qobs_gap[400:430] = np.nan
    n_checks = 0
    for dtype in (F64, F32):
        tol, name = TOL[dtype], str(dtype)[6:]
        tensors = hbv_tensors(forcing, dtype)
        head, tail = hbv_cut(tensors, 0, cut), hbv_cut(tensors, cut, t_len)
        params = hbv_random_params(np.random.default_rng(12), n, dtype,
                                   n_dry=n // 20)
        state, traj, rows = hbv_state_pair(fh, head, params, None)
        state_b, traj_b, rows_b = hbv_state_pair(fh, tail, params, state)
        for what, pair in (("K14 cold traj", traj),
                           ("K14 cold state rows", rows),
                           ("K14 warm traj", traj_b),
                           ("K14 warm state rows", rows_b)):
            report(f"hbv {name} {what}", *pair, *tol["traj"], nan_ok=True)
            n_checks += 1
        check(bool(torch.isnan(rows[0]).any()),
              "no HBV member went NaN: the NaN path was not exercised")
        for masked, qo in ((False, qobs_np[cut:]), (True, qobs_gap)):
            qo = as_tensor(qo, dtype)
            for stats in (False, True):
                got, want = hbv_warm_objective_pair(fh, tail, qo, params,
                                                    state, stats, masked)
                report(f"hbv {name} warm {'stats' if stats else 'mse'}"
                       f"{'+masked' if masked else ''}", got, want,
                       *tol["obj"], nan_ok=True)
                n_checks += 1
        full = fh.hbv_simulate_fused(*tensors, *HBV_INITS, params)
        check(bits_equal(full[:, :cut], traj[0]),
              f"hbv {name}: K13 and K14's cold entry differ in a bit")
        n_checks += 1
        if dtype == F64:
            report(f"hbv {name} split K14 + K14 vs unbroken K13",
                   torch.cat([traj[0], traj_b[0]], dim=1), full, 1e-9, 1e-12,
                   nan_ok=True)
            n_checks += 1
    print(f"[3 kernels] HBV-Edu state kernel and warm objectives: {n_checks} "
          f"checks passed at N={n}, T={cut} cold + {warm_len} warm")


def phase_kernels_state_snow(n=256, t_len=300, warm_len=100):
    """K10 cold and warm at 1, 2, 5 and 7 layers (registers at 1 and 5,
    shared columns otherwise) and the warm K8 at 1 and 5, every variant.
    The snow rows of the state are counted for bit equality with the plain
    version.  A cold start computes its layer constants from the series it
    is given, so the split check in float64 holds one warm hop against
    two (the first of 3 steps, shorter than the history)."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs

    cut = t_len - warm_len
    n_checks, unequal = 0, 0
    for dtype in (F64, F32):
        tol, name = TOL[dtype], str(dtype)[6:]
        for num_layers in (1, 2, 5, 7):
            d = SnowData.random(np.random.default_rng(num_layers), t_len,
                                num_layers, dtype)
            head, tail = d.cut(0, cut), d.cut(cut, t_len)
            for uh in fg.SUPPORTED_UH:
                params = snow_random_params(
                    np.random.default_rng(uh[0]), n, dtype,
                    2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                for variant, hyst, ice in SNOW_VARIANTS:
                    label = (f"snow {name} L={num_layers} uh={uh} "
                             f"{variant:8s}")
                    state, traj, (got_st, want_st) = snow_state_pair(
                        fs, head, params, None, hyst, ice, uh)
                    report(f"{label} K10 cold traj", *traj, *tol["traj"])
                    report(f"{label} K10 cold state rows", snow_rows(got_st),
                           snow_rows(want_st), *tol["traj"])
                    unequal += snow_bits_unequal(got_st, want_st)
                    state_b, traj_b, (got_b, want_b) = snow_state_pair(
                        fs, tail, params, state, hyst, ice, uh)
                    report(f"{label} K10 warm traj", *traj_b, *tol["traj"])
                    report(f"{label} K10 warm state rows", snow_rows(got_b),
                           snow_rows(want_b), *tol["traj"])
                    unequal += snow_bits_unequal(got_b, want_b)
                    check(torch.equal(got_b.snow[-1], state.snow[-1]),
                          f"{label}: the layer constants changed on the way "
                          "through a continuation")
                    n_checks += 4
                    for masked in ((False, True) if num_layers in (1, 5)
                                   else ()):
                        for stats in (False, True):
                            got, want = snow_warm_objective_pair(
                                fs, tail, params, state, hyst, ice, uh, stats,
                                masked)
                            report(f"{label} warm "
                                   f"{'stats' if stats else 'mse'}"
                                   f"{'+masked' if masked else ''}", got,
                                   want, *tol["obj"])
                            n_checks += 1
                    if dtype == F64:
                        hop1, hop2 = tail.cut(0, 3), tail.cut(3, warm_len)
                        q1, st1 = fs.snowgr4j_simulate_state_fused(
                            hop1.prec, hop1.temp, hop1.etp, hop1.frac, params,
                            state, frac_ice=d.frac_ice if ice else None,
                            hyst=hyst, ice=ice, num_uh1=uh[0], num_uh2=uh[1])
                        q2, st2 = fs.snowgr4j_simulate_state_fused(
                            hop2.prec, hop2.temp, hop2.etp, hop2.frac, params,
                            st1, frac_ice=d.frac_ice if ice else None,
                            hyst=hyst, ice=ice, num_uh1=uh[0], num_uh2=uh[1])
                        report(f"{label} two hops (3 + {warm_len - 3} steps) "
                               "vs one, traj", torch.cat([q1, q2], dim=1),
                               traj_b[0], 1e-9, 1e-12)
                        report(f"{label} two hops vs one, state rows",
                               snow_rows(st2), snow_rows(got_b), 1e-9, 1e-12)
                        n_checks += 2
    print(f"[3 kernels] snow state kernel and warm objectives: {n_checks} "
          f"checks passed at N={n}, T={cut} cold + {warm_len} warm, L in "
          f"(1, 2, 5, 7) (the warm objectives at 1 and 5); snow state "
          f"elements that differ from the plain version in any bit: "
          f"{unequal}")
    check(unequal == 0, "K10's snow state differs from the plain version")


def k4_kernels_agree(fg, head, tail, params, state, uh, q, rows, q_b,
                     rows_b):
    """K4's split kernel on all but the last of ``params``' members
    (fg.traj_split_members() of them), cold over ``head`` and warm over
    ``tail`` from ``state``, against the tile kernel's outputs for all of
    them (``q``, ``rows``, ``q_b``, ``rows_b``): equal bit for bit.
    Returns the number of checks."""
    n = fg.traj_split_members()
    some = {k: v[:n] for k, v in params.items()}
    q_s, st_s = fg.gr4j_simulate_state_fused(*head, some, None, 0.4, 0.3,
                                             *uh)
    q_sb, st_sb = fg.gr4j_simulate_state_fused(
        *tail, some, type(state)(*(leaf[:n] for leaf in state)), 0.0, 0.0,
        *uh)
    same = all(bits_equal(a, b) for a, b in (
        (q_s, q[:n]), (gr4j_rows(st_s), rows[:, :n]), (q_sb, q_b[:n]),
        (gr4j_rows(st_sb), rows_b[:, :n])))
    check(same, f"K4's split and tile kernels differ in a bit (uh={uh}, "
          f"T={head[0].shape[0]})")
    return 1


def state_edge_checks(forcing, prec_np, etp_np):
    """The trajectory kernels around their staging and store tiles and
    their blocks, N in STATE_EDGE_MEMBERS (one member runs K10 in a block of
    one warp), float64 and float32.  K10 and K14: cold over T steps, then
    warm over the next T from the kernel's own state (at T = 1 shorter than
    the history, H = 6 or 20), T in STATE_EDGE_STEPS; K10 at 2 and 5 layers
    (shared columns and registers), the plain and the hysteresis + ice
    variant (phase 3's other checks and the CUDA tests take the other two to
    these edges) at one UH register pair at each (T, N, L, dtype) edge,
    taken in turn so that every layer count and dtype, and every (T, N)
    edge across its four (L, dtype) slots, sees all four (UH pair, variant)
    pairs, its snow rows bit for bit; K14
    on the MATLAB forcing with NaN members (a tenth of them, at least one,
    dry).  K4 in the same way on CAMELS 01031500 (days with p == e among
    them) at both UH register pairs, its split kernel at N in
    STATE_EDGE_MEMBERS (blocks of 64 members: last blocks of 1 and 8) and
    its tile kernel one and 72 members past fg.traj_split_members() (last
    blocks of 1 and 72), and K13 cold on the MATLAB forcing with NaN
    members, bit for bit K14's cold entry, T in TILE64_EDGE_STEPS."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n_checks, unequal = 0, 0
    k10_combos = [(uh, v) for uh in fg.SUPPORTED_UH
                  for v in SNOW_VARIANTS[::3]]
    k4_sizes = STATE_EDGE_MEMBERS + (fg.traj_split_members() + 1,
                                     fg.traj_split_members() + 72)
    for i_dtype, dtype in enumerate((F64, F32)):
        tol, name = TOL[dtype]["traj"], str(dtype)[6:]
        tensors = hbv_tensors(forcing, dtype)
        for t_len in TILE64_EDGE_STEPS:
            prec, etp = (as_tensor(a[:2 * t_len], dtype)
                         for a in (prec_np, etp_np))
            head = (prec[:t_len].contiguous(), etp[:t_len].contiguous())
            tail = (prec[t_len:].contiguous(), etp[t_len:].contiguous())
            hbv_head = hbv_cut(tensors, 0, t_len)
            for n in k4_sizes:
                for uh in fg.SUPPORTED_UH:
                    params = gr4j_random_params(
                        np.random.default_rng(n + uh[0]), n,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE, dtype)
                    state, traj, rows = gr4j_state_pair(
                        fg, *head, params, None, uh, (0.4, 0.3))
                    _, traj_b, rows_b = gr4j_state_pair(fg, *tail, params,
                                                        state, uh)
                    for what, pair in (("cold traj", traj),
                                       ("cold state rows", rows),
                                       ("warm traj", traj_b),
                                       ("warm state rows", rows_b)):
                        report(f"gr4j {name} K4 T={t_len} N={n} uh={uh} "
                               f"{what}", *pair, *tol)
                        n_checks += 1
                    if n == k4_sizes[-2]:
                        # The split kernel's members are the tile kernel's
                        # bit for bit.
                        n_checks += k4_kernels_agree(
                            fg, head, tail, params, state, uh, traj[0],
                            rows[0], traj_b[0], rows_b[0])
            for n in STATE_EDGE_MEMBERS:
                params = hbv_random_params(np.random.default_rng(n), n, dtype,
                                           n_dry=max(1, n // 10))
                args = (fh, hbv_head, None, params, "traj")
                got = hbv_kernel(*args)
                report(f"hbv {name} K13 T={t_len} N={n} traj", got,
                       hbv_plain(*args), *tol, nan_ok=True)
                check(bits_equal(got, hbv_state_kernel(fh, hbv_head, params,
                                                       None)[0]),
                      f"hbv {name} T={t_len} N={n}: K13 and K14's cold "
                      "entry differ in a bit")
                n_checks += 2
        for i_t, t_len in enumerate(STATE_EDGE_STEPS):
            head = hbv_cut(tensors, 0, t_len)
            tail = hbv_cut(tensors, t_len, 2 * t_len)
            for n in STATE_EDGE_MEMBERS:
                params = hbv_random_params(np.random.default_rng(n), n, dtype,
                                           n_dry=max(1, n // 10))
                state, traj, rows = hbv_state_pair(fh, head, params, None)
                _, traj_b, rows_b = hbv_state_pair(fh, tail, params, state)
                for what, pair in (("cold traj", traj),
                                   ("cold state rows", rows),
                                   ("warm traj", traj_b),
                                   ("warm state rows", rows_b)):
                    report(f"hbv {name} K14 T={t_len} N={n} {what}", *pair,
                           *tol, nan_ok=True)
                    n_checks += 1
            for i_layer, num_layers in enumerate((2, 5)):
                d = SnowData.random(np.random.default_rng(t_len + num_layers),
                                    2 * t_len, num_layers, dtype)
                head, tail = d.cut(0, t_len), d.cut(t_len, 2 * t_len)
                for i_n, n in enumerate(STATE_EDGE_MEMBERS):
                    # One (UH pair, variant) an edge, in turn: the 18 (T, N)
                    # edges of each dtype and layer count take all four, and
                    # so do the 4 (L, dtype) slots of each (T, N) edge.
                    uh, (variant, hyst, ice) = k10_combos[
                        (i_t * len(STATE_EDGE_MEMBERS) + i_n + 2 * i_dtype
                         + i_layer) % len(k10_combos)]
                    params = snow_random_params(
                        np.random.default_rng(n + uh[0]), n, dtype,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                    label = (f"snow {name} K10 T={t_len} N={n} "
                             f"L={num_layers} uh={uh} {variant}")
                    state, traj, (got, want) = snow_state_pair(
                        fs, head, params, None, hyst, ice, uh)
                    _, traj_b, (got_b, want_b) = snow_state_pair(
                        fs, tail, params, state, hyst, ice, uh)
                    for what, pair in (
                            ("cold traj", traj),
                            ("cold state rows",
                             (snow_rows(got), snow_rows(want))),
                            ("warm traj", traj_b),
                            ("warm state rows",
                             (snow_rows(got_b), snow_rows(want_b)))):
                        report(f"{label} {what}", *pair, *tol)
                        n_checks += 1
                    unequal += (snow_bits_unequal(got, want)
                                + snow_bits_unequal(got_b, want_b))
    print(f"[3 kernels] K4, K10, K13 and K14 tile and block edges: "
          f"{n_checks} checks passed at T in {STATE_EDGE_STEPS} (K10, K14) "
          f"and {TILE64_EDGE_STEPS} (K4, K13) cold + as many warm, N in "
          f"{STATE_EDGE_MEMBERS} (K4 also {k4_sizes[-2:]}: its split "
          f"kernel bit for bit its tile kernel), K10 at L in "
          f"(2, 5), plain and hyst+ice at both UH pairs in turn, "
          f"K13 bit for bit K14 cold; "
          f"K10 snow state elements that differ from the plain version in "
          f"any bit: {unequal}")
    check(unequal == 0, "K10's snow state differs from the plain version at "
          "a tile or block edge")


def phase_golden(forcing, qsim_matlab):
    import pandas as pd
    from rrmpg_tpu_torch.models import GR4J, HBVEdu

    data = pd.read_csv(REPO / "tests" / "data" / "gr4j_example_data.csv")
    model = GR4J(params=GR4J_GOLDEN, dtype=F64)
    q = model.simulate(data.prec, data.etp, s_init=0.6, r_init=0.7,
                       engine='fused').cpu().numpy().ravel()
    err = float(np.max(np.abs(q - data.qsim_excel.to_numpy())))
    ok = np.allclose(q, data.qsim_excel)
    print(f"[4 golden] GR4J fused float64 vs Excel qsim: T={len(q)} "
          f"max_abs={err:.3e} np.allclose={ok}")
    check(ok, "fused GR4J does not reproduce the Excel trajectory")

    snow, soil, s1, s2 = HBV_INITS
    q = HBVEdu(params=HBV_GOLDEN, dtype=F64).simulate(
        **forcing, snow_init=snow, soil_init=soil, s1_init=s1, s2_init=s2,
        engine='fused').cpu().numpy().ravel()
    q = q * HBV_AREA * 1000 / (24 * 60 * 60)
    err = float(np.max(np.abs(q - qsim_matlab)))
    ok = np.allclose(q, qsim_matlab)
    print(f"[4 golden] HBV-Edu fused float64 vs MATLAB qsim: T={len(q)} "
          f"max_abs={err:.3e} np.allclose={ok}")
    check(ok, "fused HBV-Edu does not reproduce the MATLAB trajectory")

    # The four Excel snow trajectories through K9.
    for name, (want, call) in snow_golden_calls(F64).items():
        q, want = call().cpu().numpy().ravel(), want.to_numpy()
        ok = np.allclose(q, want)
        print(f"[4 golden] {name} fused float64 vs Excel: T={len(q)} "
              f"max_abs={float(np.max(np.abs(q - want))):.3e} "
              f"np.allclose={ok}")
        check(ok, f"fused {name} does not reproduce the Excel trajectory")


def snow_golden_calls(dtype):
    """The four Excel snow sheets through K9 (each class's fused simulate
    with the goldens' settings): {name: (Excel column, zero-argument
    call)}."""
    import pandas as pd
    from rrmpg_tpu_torch.models import (Cemaneige, CemaneigeGR4J,
                                        CemaneigeHystGR4J,
                                        CemaneigeHystGR4JIce)

    def read(name, **kw):
        return pd.read_csv(REPO / "tests" / "data" / name, **kw)

    def met(df):
        return (df.precipitation, df.mean_temp, df.min_temp, df.max_temp)

    calls = {}
    df = read('cemaneige_validation_data.csv', sep=';')
    calls["Cemaneige"] = (df.liquid_outflow, functools.partial(
        Cemaneige(params=CEMANEIGE_GOLDEN, dtype=dtype).simulate, *met(df),
        met_station_height=495, altitudes=ALTITUDES, engine='fused'))
    df = read('cemaneigegr4j_validation_data.csv', sep=';', index_col=0)
    calls["CemaneigeGR4J"] = (df.qsim, functools.partial(
        CemaneigeGR4J(params=CEMANEIGEGR4J_GOLDEN, dtype=dtype).simulate,
        *met(df), df.pe, met_station_height=495, altitudes=ALTITUDES,
        s_init=0.6, r_init=0.7, engine='fused'))
    df = read('cemaneigehystgr4j_validation_data.csv', index_col=0)
    calls["CemaneigeHystGR4J"] = (df.qsim, functools.partial(
        CemaneigeHystGR4J(params=HYST_GOLDEN, dtype=dtype).simulate,
        *met(df), df.pe, met_station_height=700, altitudes=ALTITUDES,
        s_init=0.5, r_init=0.4, engine='fused'))
    df = read('cemaneigehystgr4jice_validation_data.csv', index_col=0)
    calls["CemaneigeHystGR4JIce"] = (df.qsim, functools.partial(
        CemaneigeHystGR4JIce(params=dict(HYST_GOLDEN, DDF=5),
                             dtype=dtype).simulate,
        *met(df), df.pe, FRAC_ICE_GOLDEN, met_station_height=700,
        altitudes=ALTITUDES, s_init=0.5, r_init=0.4, sca_init=0.2,
        engine='fused'))
    return calls


def run_counted(fn):
    """Run ``fn`` with the launch counts set to 0 just before; returns its
    result, the counts read just after, and the wall seconds."""
    from rrmpg_tpu_torch.ops import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, {k: v for k, v in LAUNCHES.items() if v}, seconds


def check_fit(model_cls, res, what):
    check(np.isfinite(res.fun), f"{what}: fit fun is not finite: {res.fun}")
    for name, v in zip(model_cls._param_list, res.x):
        lo, hi = model_cls._default_bounds[name]
        check(lo - 1e-5 * abs(lo) <= v <= hi + 1e-5 * abs(hi),
              f"{what}: fit {name}={v} outside ({lo}, {hi})")


def population_params(model_cls, res):
    pop = torch.tensor(res.population, dtype=F32, device=DEVICE)
    return {n: pop[:, j].contiguous()
            for j, n in enumerate(model_cls._param_list)}


def phase_main_path_gr4j(card, qobs, prec, etp):
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.tools import monte_carlo

    names = GR4J._param_list
    walls = {}

    def drive():
        np.random.seed(0)
        t0 = time.perf_counter()
        mc = monte_carlo(GR4J(), num=MC_MEMBERS, qobs=qobs, prec=prec,
                         etp=etp, return_qsim=False, engine='fused',
                         metrics=('mse', 'nse', 'kge'))
        torch.cuda.synchronize()
        walls["mc"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_mse = GR4J().fit(qobs, prec, etp, engine='fused', seed=0,
                             maxiter=30)
        walls["fit_mse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_kge = GR4J().fit(qobs, prec, etp, engine='fused', seed=0,
                             maxiter=30, loss_metric='kge')
        walls["fit_kge"] = time.perf_counter() - t0
        CALIBRATED["GR4J"] = {k: float(v) for k, v in zip(names, res_kge.x)}
        calibrated = GR4J(params=CALIBRATED["GR4J"])
        return mc, res_mse, res_kge, calibrated, calibrated.simulate(
            prec, etp, engine='fused')

    (mc, res_mse, res_kge, calibrated, qsim), launches, _ = run_counted(drive)
    for m in ('mse', 'nse', 'kge'):
        check(mc[m].shape == (MC_MEMBERS,), f"MC {m} has shape {mc[m].shape}")
        check(np.isfinite(mc[m]).all(), f"MC {m} has non-finite values")
    check_fit(GR4J, res_mse, "GR4J mse")
    check_fit(GR4J, res_kge, "GR4J kge")
    check(qsim.shape == (len(prec), 1) and bool(torch.isfinite(qsim).all()),
          "calibrated GR4J simulation is not a finite (T, 1) series")
    expect = {"gr4j_stats": 1 + res_kge.nit + 1,
              "gr4j_mse": res_mse.nit + 1, "gr4j_traj": 1}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    print(f"[5 main path] GR4J, CAMELS 01031500 T={len(prec)} float32: MC "
          f"{MC_MEMBERS} members best NSE {np.max(mc['nse']):.4f} in "
          f"{walls['mc']:.3f} s; fit mse nit={res_mse.nit} "
          f"fun={res_mse.fun:.5f} in {walls['fit_mse']:.3f} s; fit kge "
          f"nit={res_kge.nit} 1-KGE={res_kge.fun:.5f} in "
          f"{walls['fit_kge']:.3f} s; launches {launches} == expected; "
          f"{card}")

    # Each kernel against its plain version at the shapes the main path
    # gave it (these launches are not counted above).
    prec_t, etp_t, qobs_t = (as_tensor(a, F32) for a in (prec, etp, qobs))
    masked = bool(np.isnan(qobs).any())
    count = int(np.isfinite(qobs).sum())
    mc_params, _ = GR4J()._prepare_params(mc['params'])
    pop_params = population_params(GR4J, res_kge)
    cal_params, _ = calibrated._prepare_params(None)
    cases = [
        ("gr4j_stats", "MC", mc_params, (10, 21), True),
        ("gr4j_mse", "fit population", pop_params, (3, 7), False),
        ("gr4j_stats", "fit population", pop_params, (3, 7), True),
        ("gr4j_traj", "calibrated", cal_params, (10, 21), None),
    ]
    max_abs = {}
    for kernel, what, params, (n1, n2), stats in cases:
        packed = fg.pack_params(params, 0.0, 0.0)
        if stats is None:
            got = fg.gr4j_simulate_fused(prec_t, etp_t, 0.0, 0.0, params,
                                         n1, n2)
            want = fg.gr4j_simulate_reference(prec_t, etp_t, packed, n1, n2)
        else:
            got = fg.gr4j_ensemble_mse_fused(prec_t, etp_t, qobs_t, 0.0, 0.0,
                                             params, n1, n2, stats=stats,
                                             masked=masked)
            want = fg.gr4j_objective_reference(prec_t, etp_t, qobs_t, packed,
                                               n1, n2, stats, masked, count)
        err = report(f"main-path shape {kernel} ({what})", got, want,
                     *TOL[F32]["traj" if stats is None else "obj"])
        max_abs[kernel] = max(max_abs.get(kernel, 0.0), err)
    return launches, max_abs, walls


DE_RESUME_AT = (10, 15)    # generations before the break, and in all
DE_CHECKPOINT_EVERY = 5
GD_DAYS = 365              # gradient_descent's segment, 'scan' engine
GD_STEPS = 20


def phase_main_path_de(card, qobs, prec, etp):
    """DE's JAX contract on the card: a fused GR4J fit on CAMELS 01031500
    checkpointed every DE_CHECKPOINT_EVERY generations into a temporary
    ``.npz``, broken off and resumed, against the unbroken fit bit for bit;
    ``polish=True`` on the fused engine (no backward: skipped with JAX's
    message); ``gradient_descent`` through the 'scan' engine's ``run_gr4j``
    on the last GD_DAYS days (finite, no worse than its start)."""
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.ops import run_gr4j
    from rrmpg_tpu_torch.tools import gradient_descent

    broken, total = DE_RESUME_AT
    bounds = [GR4J._default_bounds[p] for p in GR4J._param_list]
    q_seg, p_seg, e_seg = (as_tensor(a[-GD_DAYS:], F32)
                           for a in (qobs, prec, etp))
    seen = torch.isfinite(q_seg)

    def segment_mse(x):
        params = {n: x[j:j + 1] for j, n in enumerate(GR4J._param_list)}
        qsim = run_gr4j(p_seg, e_seg, 0.0, 0.0, params)[0][0]
        return ((qsim - q_seg)[seen] ** 2).mean()

    walls = {}

    def drive():
        kw = dict(engine='fused', seed=1, tol=0.0)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "de.npz")
            t0 = time.perf_counter()
            full = GR4J().fit(qobs, prec, etp, maxiter=total, **kw)
            walls["fit_unbroken"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            part = GR4J().fit(qobs, prec, etp, maxiter=broken,
                              checkpoint_path=path,
                              checkpoint_every=DE_CHECKPOINT_EVERY, **kw)
            walls["fit_checkpointed"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = GR4J().fit(qobs, prec, etp, maxiter=total,
                                 resume_from=path, **kw)
            walls["fit_resumed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        polished = GR4J().fit(qobs, prec, etp, maxiter=broken, polish=True,
                              **kw)
        walls["fit_polish"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gd = gradient_descent(segment_mse, bounds, x0=full.x,
                              steps=GD_STEPS, dtype=F32)
        walls["gradient_descent"] = time.perf_counter() - t0
        return full, part, resumed, polished, gd

    (full, part, resumed, polished, gd), launches, _ = run_counted(drive)
    check_fit(GR4J, full, "GR4J unbroken fit")
    check(part.nit == broken and resumed.nit == full.nit == total,
          f"DE generations: part {part.nit}, resumed {resumed.nit}, "
          f"unbroken {full.nit}")
    same = (resumed.fun == full.fun and resumed.nfev == full.nfev
            and np.array_equal(resumed.x, full.x)
            and np.array_equal(resumed.population, full.population)
            and np.array_equal(resumed.population_energies,
                               full.population_energies))
    check(same, "the resumed fit differs from the unbroken one")
    check(polished.message.endswith(" Polish skipped (RuntimeError).")
          and np.isfinite(polished.fun),
          f"fused fit with polish=True: {polished.message!r}")
    with torch.no_grad():
        start = float(segment_mse(torch.tensor(full.x, dtype=F32,
                                               device=DEVICE)))
    check(gd.success and np.isfinite(gd.fun) and gd.fun <= start
          and gd.nfev == GD_STEPS + 1,
          f"gradient_descent: fun {gd.fun} from {start}")
    check_fit(GR4J, gd, "gradient_descent")
    # Every fit generation is one K1 launch; the resumed fit evaluates no
    # initial population; the polish's one forward pass is one more.
    expect = {"gr4j_mse": (full.nit + 1) + (part.nit + 1)
              + (resumed.nit - part.nit) + (polished.nit + 1) + 1}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    print(f"[5 main path] DE, GR4J fused fit on CAMELS 01031500 T="
          f"{len(prec)} float32: {broken} generations saved every "
          f"{DE_CHECKPOINT_EVERY} and resumed to {total} equal the unbroken "
          f"{total} bit for bit (fun {full.fun:.6f}); polish=True on the "
          f"fused engine: {polished.message!r}; gradient_descent 'scan' "
          f"{GD_DAYS} days x {GD_STEPS} steps: MSE {start:.5f} -> "
          f"{gd.fun:.5f}; launches {launches} == expected; {card}")
    return launches, {}, walls


def phase_main_path_hbv(card, forcing, qsim_matlab):
    from rrmpg_tpu_torch.models import HBVEdu
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.tools import monte_carlo

    names = HBVEdu._param_list
    snow, soil, s1, s2 = HBV_INITS
    inits = dict(snow_init=snow, soil_init=soil, s1_init=s1, s2_init=s2)
    # Observations: the MATLAB discharge back in mm/day, with a few gaps.
    qobs = qsim_matlab * (24 * 60 * 60) / (HBV_AREA * 1000)
    qobs[200:215] = np.nan
    qobs[::97] = np.nan
    walls = {}

    def drive():
        np.random.seed(0)
        t0 = time.perf_counter()
        mc = monte_carlo(HBVEdu(), num=MC_MEMBERS, qobs=qobs,
                         return_qsim=False, engine='fused',
                         metrics=('mse', 'nse', 'kge'), **forcing, **inits)
        torch.cuda.synchronize()
        walls["mc"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_mse = HBVEdu().fit(qobs, **forcing, **inits, engine='fused',
                               seed=0, maxiter=30)
        walls["fit_mse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_kge = HBVEdu().fit(qobs, **forcing, **inits, engine='fused',
                               seed=0, maxiter=30, loss_metric='kge')
        walls["fit_kge"] = time.perf_counter() - t0
        CALIBRATED["HBV-Edu"] = {k: float(v)
                                 for k, v in zip(names, res_kge.x)}
        calibrated = HBVEdu(params=CALIBRATED["HBV-Edu"])
        return mc, res_mse, res_kge, calibrated, calibrated.simulate(
            **forcing, **inits, engine='fused')

    (mc, res_mse, res_kge, calibrated, qsim), launches, _ = run_counted(drive)
    n_nan = int(np.isnan(mc['mse']).sum())
    for m in ('mse', 'nse', 'kge'):
        check(mc[m].shape == (MC_MEMBERS,), f"MC {m} has shape {mc[m].shape}")
        check(int(np.isnan(mc[m]).sum()) == n_nan
              and not np.isinf(mc[m]).any(),
              f"HBV MC {m}: NaN members differ between metrics, or inf")
    check(n_nan < MC_MEMBERS // 2, f"{n_nan} of {MC_MEMBERS} HBV MC members "
          "are NaN")
    check_fit(HBVEdu, res_mse, "HBV mse")
    check_fit(HBVEdu, res_kge, "HBV kge")
    check(qsim.shape == (len(qobs), 1) and bool(torch.isfinite(qsim).all()),
          "calibrated HBV simulation is not a finite (T, 1) series")
    expect = {"hbv_stats": 1 + res_kge.nit + 1, "hbv_mse": res_mse.nit + 1,
              "hbv_traj": 1}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    print(f"[5 main path] HBV-Edu, MATLAB example T={len(qobs)} float32: MC "
          f"{MC_MEMBERS} members ({n_nan} NaN) best NSE "
          f"{np.nanmax(mc['nse']):.4f} in {walls['mc']:.3f} s; fit mse "
          f"nit={res_mse.nit} fun={res_mse.fun:.5f} in "
          f"{walls['fit_mse']:.3f} s; fit kge nit={res_kge.nit} "
          f"1-KGE={res_kge.fun:.5f} in {walls['fit_kge']:.3f} s; launches "
          f"{launches} == expected; {card}")

    tensors = hbv_tensors(forcing, F32)
    qobs_t = as_tensor(qobs, F32)
    mc_params, _ = HBVEdu()._prepare_params(mc['params'])
    pop_params = population_params(HBVEdu, res_kge)
    cal_params, _ = calibrated._prepare_params(None)
    max_abs = {}
    for kernel, what, params, mode in (
            ("hbv_stats", "MC", mc_params, "stats"),
            ("hbv_mse", "fit population", pop_params, "mse"),
            ("hbv_stats", "fit population", pop_params, "stats"),
            ("hbv_traj", "calibrated", cal_params, "traj")):
        args = (fh, tensors, qobs_t, params, mode, True)
        got, want = hbv_kernel(*args), hbv_plain(*args)
        err = report(f"main-path shape {kernel} ({what})", got, want,
                     *TOL[F32]["traj" if mode == "traj" else "obj"],
                     nan_ok=True)
        max_abs[kernel] = max(max_abs.get(kernel, 0.0), err)
    return launches, max_abs, walls


def phase_main_path_abc(card, qobs, prec_basin):
    from rrmpg_tpu_torch.models import ABCModel
    from rrmpg_tpu_torch.ops import abc, fused_abc as fa
    from rrmpg_tpu_torch.tools import monte_carlo

    prec_long = np.random.default_rng(0).uniform(0, 20, ABC_STEPS)
    prec_t = as_tensor(prec_long, F32)
    walls = {}

    def drive():
        t0 = time.perf_counter()
        q_long, s_long = ABCModel(params=ABC_PARAMS).simulate(
            prec_long, engine='fused', return_storage=True)
        torch.cuda.synchronize()
        walls["simulate"] = time.perf_counter() - t0
        # The three-launch scan has no engine of its own in the class (nor
        # in rrmpg_tpu): its users call the op, at the same shape.
        t0 = time.perf_counter()
        chunked = fa.abc_fused(prec_t, 0.0, ABC_PARAMS)
        torch.cuda.synchronize()
        walls["abc_fused_op"] = time.perf_counter() - t0
        np.random.seed(0)
        t0 = time.perf_counter()
        mc = monte_carlo(ABCModel(), num=ABC_MC_MEMBERS, qobs=qobs,
                         prec=prec_basin, return_qsim=False, engine='fused',
                         metrics=('mse', 'nse'))
        torch.cuda.synchronize()
        walls["mc"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = ABCModel().fit(qobs, prec_basin, seed=0, maxiter=30)
        walls["fit"] = time.perf_counter() - t0
        calibrated = ABCModel(params={k: float(v) for k, v in
                                      zip(ABCModel._param_list, res.x)})
        return q_long, s_long, chunked, mc, res, calibrated.simulate(
            prec_basin, engine='fused')

    (q_long, s_long, chunked, mc, res, qsim), launches, _ = run_counted(
        drive)
    check(q_long.shape == s_long.shape == (ABC_STEPS, 1)
          and bool(torch.isfinite(q_long).all())
          and bool(torch.isfinite(s_long).all()),
          "ABC 10M-step simulation is not a finite (T, 1) pair")
    for m in ('mse', 'nse'):
        check(mc[m].shape == (ABC_MC_MEMBERS,)
              and np.isfinite(mc[m]).all(), f"ABC MC {m} is not finite")
    check_fit(ABCModel, res, "ABC mse")
    check(qsim.shape == (len(prec_basin), 1)
          and bool(torch.isfinite(qsim).all()),
          "calibrated ABC simulation is not a finite (T, 1) series")
    expect = {"abc_fused_single": 3, "abc_fused": 1}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    print(f"[5 main path] ABC float32: simulate T={ABC_STEPS} in "
          f"{walls['simulate']:.3f} s; MC {ABC_MC_MEMBERS} members on CAMELS "
          f"01031500 (T={len(prec_basin)}) best NSE {np.max(mc['nse']):.4f} "
          f"in {walls['mc']:.3f} s; fit mse nit={res.nit} fun={res.fun:.5f} "
          f"in {walls['fit']:.3f} s (the Toeplitz scan per generation); "
          f"launches {launches} == expected; {card}")

    # What the main path computed at 10M steps (K6 through the class, K7
    # through the op) against the plain version, then the kernels
    # themselves at that shape and at the Monte-Carlo's.
    max_abs = {}
    want = abc.run_abcmodel_pscan(prec_t, 0.0, ABC_PARAMS)
    for what, got in (
            ("ABCModel.simulate", (q_long[:, 0], s_long[:, 0])),
            ("ops.abc_fused", chunked),
            ("abc_fused_single", fa.abc_fused_single(prec_t, 0.0,
                                                     ABC_PARAMS)),
            ("abc_fused", fa.abc_fused(prec_t, 0.0, ABC_PARAMS))):
        for series, g, w in zip(("q", "S"), got, want):
            err = report(f"main-path shape {what} (T={ABC_STEPS}) {series}",
                         g, w, *abc_tol(w))
            if what in KERNELS:
                max_abs[what] = max(max_abs.get(what, 0.0), err)
    mc_params, _ = ABCModel()._prepare_params(mc['params'])
    basin_t = as_tensor(prec_basin, F32)
    got = fa.abc_fused_single(basin_t, 0.0, mc_params)
    want = abc.run_abcmodel_pscan(basin_t, 0.0, mc_params)
    for series, g, w in zip(("q", "S"), got, want):
        err = report(f"main-path shape abc_fused_single (MC) {series}", g, w,
                     *abc_tol(w))
        max_abs["abc_fused_single"] = max(max_abs["abc_fused_single"], err)
    return launches, max_abs, walls


def snow_main_data():
    """The hysteresis + ice Excel sheet's forcing; its simulated discharge
    with a few gaps as observations; five NDSI bands made from a seed (the
    repository has no observed NDSI), two of them with gaps."""
    import pandas as pd

    df = pd.read_csv(REPO / "tests" / "data"
                     / "cemaneigehystgr4jice_validation_data.csv",
                     index_col=0)
    met = dict(prec=df.precipitation.to_numpy(),
               mean_temp=df.mean_temp.to_numpy(),
               min_temp=df.min_temp.to_numpy(),
               max_temp=df.max_temp.to_numpy(), etp=df.pe.to_numpy())
    qobs = df.qsim.to_numpy().copy()
    qobs[300:320] = np.nan
    qobs[::91] = np.nan
    rng = np.random.default_rng(5)
    ndsi = [rng.uniform(0, 100, len(df)) for _ in ALTITUDES]
    ndsi[1][rng.choice(len(df), 200, replace=False)] = np.nan
    ndsi[4][::13] = np.nan
    return met, qobs, ndsi


def phase_main_path_snow(card):
    from rrmpg_tpu_torch.models import Cemaneige, CemaneigeHystGR4JIce
    from rrmpg_tpu_torch.ops import fused_snow as fs
    from rrmpg_tpu_torch.tools import monte_carlo

    model_cls = CemaneigeHystGR4JIce
    met, qobs, ndsi = snow_main_data()
    setup = dict(met_station_height=700, altitudes=ALTITUDES, s_init=0.5,
                 r_init=0.4)
    fit_kw = dict(engine='fused', seed=0, maxiter=SNOW_FIT_MAXITER, **setup)
    station = {k: met[k] for k in ("prec", "mean_temp", "min_temp",
                                   "max_temp")}
    # The snow-only routine calibrates against the layer-mean outflow of
    # the golden parameters.
    outflow = Cemaneige(params=CEMANEIGE_GOLDEN).simulate(
        **station, met_station_height=700,
        altitudes=ALTITUDES).cpu().numpy().ravel().astype(np.float64)
    walls = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        return out

    def drive():
        np.random.seed(0)
        mc = timed("mc", lambda: monte_carlo(
            model_cls(), num=MC_MEMBERS, qobs=qobs, return_qsim=False,
            engine='fused', metrics=('mse', 'nse', 'kge'), **met,
            frac_ice=FRAC_ICE_GOLDEN, **setup))
        forcing = (*met.values(), FRAC_ICE_GOLDEN)
        res_mse = timed("fit_mse", lambda: model_cls().fit(
            qobs, *forcing, **fit_kw))
        res_kge = timed("fit_kge", lambda: model_cls().fit(
            qobs, *forcing, loss_metric='kge', **fit_kw))
        res_sca = timed("fit_q_sca", lambda: model_cls().fit_Q_SCA(
            qobs, *forcing, *ndsi, loss_metric='kge', **fit_kw))
        CALIBRATED["snow"] = {
            k: float(v) for k, v in zip(model_cls._param_list, res_kge.x)}
        calibrated = model_cls(params=CALIBRATED["snow"])
        qsim = timed("simulate", lambda: calibrated.simulate(
            *forcing, engine='fused', **setup))
        res_snow = timed("cemaneige_fit", lambda: Cemaneige().fit(
            outflow, **station, met_station_height=700, altitudes=ALTITUDES,
            engine='fused', seed=0, maxiter=SNOW_FIT_MAXITER))
        snow_model = Cemaneige(params={
            k: float(v) for k, v in zip(Cemaneige._param_list, res_snow.x)})
        snow_out = timed("cemaneige_simulate", lambda: snow_model.simulate(
            **station, met_station_height=700, altitudes=ALTITUDES,
            engine='fused'))
        return (mc, res_mse, res_kge, res_sca, calibrated, qsim, res_snow,
                snow_model, snow_out)

    (mc, res_mse, res_kge, res_sca, calibrated, qsim, res_snow, snow_model,
     snow_out), launches, _ = run_counted(drive)
    for m in ('mse', 'nse', 'kge'):
        check(mc[m].shape == (MC_MEMBERS,), f"MC {m} has shape {mc[m].shape}")
        check(np.isfinite(mc[m]).all(), f"snow MC {m} has non-finite values")
    for res, what in ((res_mse, "mse"), (res_kge, "kge"),
                      (res_sca, "Q+SCA")):
        check_fit(model_cls, res, f"snow {what}")
    check_fit(Cemaneige, res_snow, "Cemaneige mse")
    t_len = len(qobs)
    for series, what in ((qsim, "calibrated snow"), (snow_out, "Cemaneige")):
        check(series.shape == (t_len, 1)
              and bool(torch.isfinite(series).all()),
              f"{what} simulation is not a finite (T, 1) series")
    expect = {"snow_stats": 1 + res_kge.nit + 1,
              "snow_mse": res_mse.nit + 1 + res_snow.nit + 1,
              "snow_sca_stats": res_sca.nit + 1, "snow_traj": 2}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    print(f"[5 main path] CemaneigeHystGR4JIce, Excel forcing T={t_len} x "
          f"{len(ALTITUDES)} layers float32: MC {MC_MEMBERS} members best "
          f"NSE {np.max(mc['nse']):.4f} in {walls['mc']:.3f} s; fit mse "
          f"nit={res_mse.nit} fun={res_mse.fun:.5f} in "
          f"{walls['fit_mse']:.3f} s; fit kge nit={res_kge.nit} "
          f"1-KGE={res_kge.fun:.5f} in {walls['fit_kge']:.3f} s; fit_Q_SCA "
          f"kge nit={res_sca.nit} fun={res_sca.fun:.5f} in "
          f"{walls['fit_q_sca']:.3f} s; Cemaneige fit nit={res_snow.nit} "
          f"fun={res_snow.fun:.3e}; launches {launches} == expected; {card}")

    # Each kernel mode against its plain version at the shapes the main
    # path gave it (these launches are not counted above).
    f = model_cls()._prepare(*met.values(), FRAC_ICE_GOLDEN, 700, ALTITUDES,
                             0, 0, 0, 0.5, 0.4)
    forcing = (f.prec, f.mean_temp, f.frac_solid_prec, f.etp, f.frac_ice)
    d = SnowData(*forcing, as_tensor(qobs, F32),
                 as_tensor(np.stack(ndsi), F32))
    d_snow = SnowData(*forcing, as_tensor(outflow, F32))
    mc_params, _ = model_cls()._prepare_params(mc['params'])
    cal_params, _ = calibrated._prepare_params(None)
    snow_params, _ = snow_model._prepare_params(None)
    full = dict(hyst=True, ice=True, uh=(10, 21), inits=(0.0, 0.0, 0.5, 0.4))
    only = dict(snow_only=True, inits=(0.0, 0.0, 0.0, 0.0))
    cases = [
        ("snow_stats", "MC", d, mc_params, "stats", dict(full, masked=True)),
        ("snow_mse", "fit population", d, population_params(
            model_cls, res_mse), "mse", dict(full, masked=True)),
        ("snow_stats", "fit population", d, population_params(
            model_cls, res_kge), "stats", dict(full, masked=True)),
        ("snow_sca_stats", "fit_Q_SCA population", d, population_params(
            model_cls, res_sca), "sca_stats", dict(full, masked=True)),
        ("snow_traj", "calibrated", d, cal_params, "traj", full),
        ("snow_mse", "Cemaneige fit population", d_snow, population_params(
            Cemaneige, res_snow), "mse", only),
        ("snow_traj", "Cemaneige", d_snow, snow_params, "traj", only),
    ]
    max_abs = {}
    for kernel, what, data, params, mode, kw in cases:
        err = report(f"main-path shape {kernel} ({what})",
                     snow_call(fs, data, params, mode, **kw),
                     snow_call(fs, data, params, mode, plain=True, **kw),
                     *TOL[F32]["traj" if mode == "traj" else "obj"])
        max_abs[kernel] = max(max_abs.get(kernel, 0.0), err)
    return launches, max_abs, walls


def state_leaves(state):
    if type(state).__name__ == "SnowGR4JState":
        return state_leaves(state.snow) + state_leaves(state.gr4j)
    return list(state)


def forecast_family(card, label, model_cls, cut, cold_kw, qobs, counters,
                    nan_ok=False):
    """The forecast cycle of one family through its entry points, the launch
    counts read around each call: spin-up with the final state, the state
    through a file, a full-width continuation from that one state,
    recalibration on the last days.  ``cut(lo, hi)`` gives ``simulate``'s
    forcing keywords over [lo, hi); ``counters`` names the launch counts of
    the state kernel and of the MSE and statistics objectives.

    Returns what the kernel comparison needs, the launches by mode key and
    the walls."""
    from rrmpg_tpu_torch.tools import load_state, save_state

    state_name, mse_name, stats_name = counters
    t_len = len(qobs)
    split = t_len - FORECAST_DAYS
    model = model_cls(params=CALIBRATED[label])
    walls = {}

    def step(key, fn, expect):
        result, got, seconds = run_counted(fn)
        want = expect(result)
        check(got == want, f"{label} forecast, {key}: launch counts {got} "
              f"differ from the expected {want}")
        walls[key] = seconds
        return result

    q_a, state = step("spin_up", lambda: model.simulate(
        **cut(0, split), **cold_kw, return_final_state=True, engine='fused'),
        lambda r: {state_name: 1})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_state(path, state)
        loaded = load_state(path)
    for a, b in zip(state_leaves(state), state_leaves(loaded)):
        check(np.array_equal(a.cpu().numpy(), b, equal_nan=True),
              f"{label}: the state changed on its way through the file")
    np.random.seed(1)
    members = model_cls().get_random_params(MC_MEMBERS)
    tail = cut(split, t_len)
    q_b, state_b = step("continuation", lambda: model.simulate(
        **tail, params=members, initial_state=loaded,
        return_final_state=True, engine='fused'),
        lambda r: {state_name: 1})
    fit_kw = dict(initial_state=loaded, engine='fused', seed=0,
                  maxiter=FORECAST_FIT_MAXITER)
    res_mse = step("fit_mse", lambda: model_cls().fit(
        qobs[split:], **tail, **fit_kw), lambda r: {mse_name: r.nit + 1})
    res_kge = step("fit_kge", lambda: model_cls().fit(
        qobs[split:], **tail, loss_metric='kge', **fit_kw),
        lambda r: {stats_name: r.nit + 1})

    check(q_a.shape == (split, 1) and bool(torch.isfinite(q_a).all()),
          f"{label} spin-up is not a finite (T, 1) series")
    check(q_b.shape == (FORECAST_DAYS, MC_MEMBERS),
          f"{label} continuation has shape {tuple(q_b.shape)}")
    bad = ~torch.isfinite(q_b).all(dim=0)
    n_bad = int(bad.sum())
    check(n_bad == 0 or (nan_ok and n_bad < MC_MEMBERS // 2),
          f"{label} continuation: {n_bad} members are not finite")
    for leaf in state_leaves(state_b):
        check(leaf.shape[0] == MC_MEMBERS, f"{label}: a final state leaf has "
              f"shape {tuple(leaf.shape)}")
        leaf_bad = ~torch.isfinite(leaf.reshape(MC_MEMBERS, -1)).all(dim=1)
        check(bool((leaf_bad <= bad).all()),
              f"{label}: a member with a finite trajectory has a non-finite "
              "final state")
    check_fit(model_cls, res_mse, f"{label} warm mse")
    check_fit(model_cls, res_kge, f"{label} warm kge")
    # The first members once more on the sequential engine, from the same
    # state: the fused continuation must agree with it.
    some = 64
    q_scan = model.simulate(**tail, params=members[:some],
                            initial_state=loaded, engine='scan')
    report(f"forecast {label}: fused continuation vs 'scan', {some} members",
           q_b[:, :some], q_scan, *TOL[F32]["traj"], nan_ok=nan_ok)
    print(f"[5 main path] forecast {label} float32: spin-up T={split} in "
          f"{walls['spin_up']:.3f} s, state through a file, continuation "
          f"{MC_MEMBERS} members x {FORECAST_DAYS} days ({n_bad} not finite) "
          f"in {walls['continuation']:.3f} s; warm fit mse nit={res_mse.nit} "
          f"fun={res_mse.fun:.5f} in {walls['fit_mse']:.3f} s; warm fit kge "
          f"nit={res_kge.nit} 1-KGE={res_kge.fun:.5f} in "
          f"{walls['fit_kge']:.3f} s; launches as expected around each "
          f"call; {card}")
    launches = {f"{state_name}_cold": 1, f"{state_name}_warm": 1,
                "mse_warm": res_mse.nit + 1, "stats_warm": res_kge.nit + 1}
    return (model, loaded, members, res_mse, res_kge), launches, walls


def phase_forecast(card, qobs, prec, etp, forcing, qsim_matlab):
    """The forecast path of the three families whose kernels carry state,
    then each kernel against its plain version at the shapes the path gave
    it, then ABC and the snow-only routine on the sequential engine."""
    from rrmpg_tpu_torch.models import (ABCModel, Cemaneige,
                                        CemaneigeHystGR4JIce, GR4J, HBVEdu)
    from rrmpg_tpu_torch.models.states import broadcast_state
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    launches, max_abs, walls = {}, {}, {}
    tol = TOL[F32]

    def keep(key, err):
        max_abs[key] = max(max_abs.get(key, 0.0), err)

    def shared(model, loaded, num):
        return broadcast_state(model._single_member_state(loaded), num)

    # GR4J on CAMELS 01031500.
    t_len = len(qobs)
    split = t_len - FORECAST_DAYS
    (model, loaded, members, res_mse, res_kge), got, w = forecast_family(
        card, "GR4J", GR4J, lambda lo, hi: dict(prec=prec[lo:hi],
                                                etp=etp[lo:hi]),
        {}, qobs, ("gr4j_traj_state", "gr4j_mse", "gr4j_stats"))
    launches.update({"gr4j_traj_state_cold": got["gr4j_traj_state_cold"],
                     "gr4j_traj_state_warm": got["gr4j_traj_state_warm"],
                     "gr4j_mse_warm": got["mse_warm"],
                     "gr4j_stats_warm": got["stats_warm"]})
    walls["GR4J"] = w
    series = [as_tensor(a, F32) for a in (prec, etp, qobs)]
    head = [x[:split].contiguous() for x in series]
    tail = [x[split:].contiguous() for x in series]
    masked = bool(np.isnan(qobs[split:]).any())
    cal_params, _ = model._prepare_params(None)
    _, traj, rows = gr4j_state_pair(fg, *head[:2], cal_params, None, (10, 21))
    keep("gr4j_traj_state_cold", report(
        "forecast shape gr4j_traj_state cold (spin-up) traj", *traj,
        *tol["traj"]))
    keep("gr4j_traj_state_cold", report(
        "forecast shape gr4j_traj_state cold (spin-up) state rows", *rows,
        *tol["traj"]))
    mc_params, _ = model._prepare_params(members)
    _, traj, rows = gr4j_state_pair(fg, *tail[:2], mc_params,
                                    shared(model, loaded, MC_MEMBERS),
                                    (10, 21))
    keep("gr4j_traj_state_warm", report(
        "forecast shape gr4j_traj_state warm (continuation) traj", *traj,
        *tol["traj"]))
    keep("gr4j_traj_state_warm", report(
        "forecast shape gr4j_traj_state warm (continuation) state rows",
        *rows, *tol["traj"]))
    for key, res, stats in (("gr4j_mse_warm", res_mse, False),
                            ("gr4j_stats_warm", res_kge, True)):
        pop = population_params(GR4J, res)
        pair = gr4j_warm_objective_pair(
            fg, *tail, pop, shared(model, loaded, pop['x1'].shape[0]), (3, 7),
            stats, masked)
        keep(key, report(f"forecast shape {key} (fit population)", *pair,
                         *tol["obj"]))

    # HBV-Edu on the MATLAB days (observations as in its main path).
    hbv_qobs = qsim_matlab * (24 * 60 * 60) / (HBV_AREA * 1000)
    hbv_qobs[200:215] = np.nan
    hbv_qobs[::97] = np.nan
    t_len = len(hbv_qobs)
    split = t_len - FORECAST_DAYS

    def hbv_cut_kw(lo, hi):
        return dict(forcing, temp=forcing['temp'][lo:hi],
                    prec=forcing['prec'][lo:hi],
                    month=forcing['month'][lo:hi])

    snow0, soil0, s1_0, s2_0 = HBV_INITS
    (model, loaded, members, res_mse, res_kge), got, w = forecast_family(
        card, "HBV-Edu", HBVEdu, hbv_cut_kw,
        dict(snow_init=snow0, soil_init=soil0, s1_init=s1_0, s2_init=s2_0),
        hbv_qobs, ("hbv_traj_state", "hbv_mse", "hbv_stats"), nan_ok=True)
    launches.update({"hbv_traj_state_cold": got["hbv_traj_state_cold"],
                     "hbv_traj_state_warm": got["hbv_traj_state_warm"],
                     "hbv_warm": got["mse_warm"] + got["stats_warm"]})
    walls["HBV-Edu"] = w
    tensors = hbv_tensors(forcing, F32)
    head, tail = hbv_cut(tensors, 0, split), hbv_cut(tensors, split, t_len)
    qobs_tail = as_tensor(hbv_qobs[split:], F32)
    masked = bool(np.isnan(hbv_qobs[split:]).any())
    cal_params, _ = model._prepare_params(None)
    _, traj, rows = hbv_state_pair(fh, head, cal_params, None)
    mc_params, _ = model._prepare_params(members)
    _, traj_w, rows_w = hbv_state_pair(
        fh, tail, mc_params, tuple(shared(model, loaded, MC_MEMBERS)))
    for key, what, pair in (
            ("hbv_traj_state_cold", "cold (spin-up) traj", traj),
            ("hbv_traj_state_cold", "cold (spin-up) state rows", rows),
            ("hbv_traj_state_warm", "warm (continuation) traj", traj_w),
            ("hbv_traj_state_warm", "warm (continuation) state rows",
             rows_w)):
        keep(key, report(f"forecast shape hbv_traj_state {what}", *pair,
                         *tol["traj"], nan_ok=True))
    for res, stats in ((res_mse, False), (res_kge, True)):
        pop = population_params(HBVEdu, res)
        pair = hbv_warm_objective_pair(
            fh, tail, qobs_tail, pop,
            tuple(shared(model, loaded, pop['T_t'].shape[0])), stats, masked)
        keep("hbv_warm", report(
            f"forecast shape hbv_{'stats' if stats else 'mse'} warm (fit "
            "population)", *pair, *tol["obj"], nan_ok=True))

    # The hysteresis + ice snow model on its Excel sheet.
    met, snow_qobs, _ = snow_main_data()
    t_len = len(snow_qobs)
    split = t_len - FORECAST_DAYS
    setup = dict(met_station_height=700, altitudes=ALTITUDES,
                 frac_ice=FRAC_ICE_GOLDEN)
    (model, loaded, members, res_mse, res_kge), got, w = forecast_family(
        card, "snow", CemaneigeHystGR4JIce,
        lambda lo, hi: dict({k: v[lo:hi] for k, v in met.items()}, **setup),
        dict(s_init=0.5, r_init=0.4), snow_qobs,
        ("snow_traj_state", "snow_mse", "snow_stats"))
    launches.update({"snow_traj_state_cold": got["snow_traj_state_cold"],
                     "snow_traj_state_warm": got["snow_traj_state_warm"],
                     "snow_warm": got["mse_warm"] + got["stats_warm"]})
    walls["snow"] = w
    f = model._prepare(*met.values(), FRAC_ICE_GOLDEN, 700, ALTITUDES, 0, 0,
                       0, 0.5, 0.4)
    d = SnowData(f.prec, f.mean_temp, f.frac_solid_prec, f.etp, f.frac_ice,
                 as_tensor(snow_qobs, F32))
    # The met preprocessing works step by step, so the layer forcing of a
    # segment is the segment of the layer forcing.
    head, tail = d.cut(0, split), d.cut(split, t_len)
    masked = bool(np.isnan(snow_qobs[split:]).any())
    kw = dict(hyst=True, ice=True, uh=(10, 21))
    cal_params, _ = model._prepare_params(None)
    _, traj, (got_st, want_st) = snow_state_pair(
        fs, head, cal_params, None, inits=(0.0, 0.0, 0.5, 0.4), **kw)
    mc_params, _ = model._prepare_params(members)
    _, traj_w, (got_w, want_w) = snow_state_pair(
        fs, tail, mc_params, shared(model, loaded, MC_MEMBERS), **kw)
    for key, what, pair in (
            ("snow_traj_state_cold", "cold (spin-up) traj", traj),
            ("snow_traj_state_cold", "cold (spin-up) state rows",
             (snow_rows(got_st), snow_rows(want_st))),
            ("snow_traj_state_warm", "warm (continuation) traj", traj_w),
            ("snow_traj_state_warm", "warm (continuation) state rows",
             (snow_rows(got_w), snow_rows(want_w)))):
        keep(key, report(f"forecast shape snow_traj_state {what}", *pair,
                         *tol["traj"]))
    unequal = (snow_bits_unequal(got_st, want_st)
               + snow_bits_unequal(got_w, want_w))
    print(f"    forecast shape snow_traj_state: snow state elements that "
          f"differ from the plain version in any bit: {unequal}")
    check(unequal == 0, "K10's snow state differs from the plain version at "
          "the forecast path's shapes")
    for res, stats in ((res_mse, False), (res_kge, True)):
        pop = population_params(CemaneigeHystGR4JIce, res)
        pair = snow_warm_objective_pair(
            fs, tail, pop, shared(model, loaded, pop['CTG'].shape[0]),
            stats=stats, masked=masked, **kw)
        keep("snow_warm", report(
            f"forecast shape snow_{'stats' if stats else 'mse'} warm (fit "
            "population)", *pair, *tol["obj"]))

    # ABC and the snow-only routine carry state on the sequential engine
    # only: one warm continuation each, on the card.
    def sequential():
        abc_model = ABCModel(params=ABC_PARAMS)
        split = len(prec) - FORECAST_DAYS
        q_a, st = abc_model.simulate(prec[:split], initial_state=5.0,
                                     return_final_state=True, engine='fused')
        np.random.seed(2)
        q_b, st_b = abc_model.simulate(
            prec[split:], params=ABCModel().get_random_params(
                SEQUENTIAL_MEMBERS), initial_state=st,
            return_final_state=True)
        q_one = abc_model.simulate(prec[split:], initial_state=st)
        full = abc_model.simulate(prec, initial_state=5.0, engine='scan')
        station = {k: met[k] for k in ("prec", "mean_temp", "min_temp",
                                       "max_temp")}
        snow_kw = dict(met_station_height=700, altitudes=ALTITUDES)
        snow_model = Cemaneige(params=CEMANEIGE_GOLDEN)
        split_s = len(snow_qobs) - FORECAST_DAYS
        _, snow_st = snow_model.simulate(
            **{k: v[:split_s] for k, v in station.items()}, **snow_kw,
            return_final_state=True)
        np.random.seed(3)
        out, snow_st_b = snow_model.simulate(
            **{k: v[split_s:] for k, v in station.items()}, **snow_kw,
            params=Cemaneige().get_random_params(SEQUENTIAL_MEMBERS),
            initial_state=snow_st, return_final_state=True)
        return q_a, q_b, st_b, q_one, full, out, snow_st_b

    (q_a, q_b, st_b, q_one, full, out, snow_st_b), got, seconds = run_counted(
        sequential)
    check(got == {"abc_fused_single": 1},
          f"sequential continuations: launch counts {got}")
    check(q_b.shape == (FORECAST_DAYS, SEQUENTIAL_MEMBERS)
          and bool(torch.isfinite(q_b).all())
          and st_b.storage.shape == (SEQUENTIAL_MEMBERS,),
          "ABC warm continuation is not finite at the expected shape")
    report("forecast ABC: cold K6 + warm 'scan' vs unbroken 'scan'",
           torch.cat([q_a, q_one]), full, *abc_tol(full))
    check(out.shape == (FORECAST_DAYS, SEQUENTIAL_MEMBERS)
          and bool(torch.isfinite(out).all())
          and snow_st_b.g.shape == (SEQUENTIAL_MEMBERS, len(ALTITUDES)),
          "Cemaneige warm continuation is not finite at the expected shape")
    print(f"[5 main path] forecast ABC and Cemaneige on the sequential "
          f"engine, on the card, float32: {SEQUENTIAL_MEMBERS}-member warm "
          f"continuations of {FORECAST_DAYS} days in {seconds:.3f} s "
          f"(with both spin-ups); {card}")
    launches["abc_fused_single"] = got["abc_fused_single"]
    return launches, max_abs, walls


# ---------------------------------------------------------------------------
# The regional path: K5 and K11, (catchment x member) in one launch
# ---------------------------------------------------------------------------

def regional_counts(qobs, masked):
    """(C,) steps each catchment of a (C, T) record averages over, counted
    here and not by the wrappers' helper."""
    if not masked:
        return torch.full((qobs.shape[0],), float(qobs.shape[1]),
                          dtype=qobs.dtype, device=qobs.device)
    return torch.isfinite(qobs).sum(dim=1).to(qobs.dtype)


def regional_gr4j_plain(fg, prec, etp, qobs, params, uh, masked,
                        inits=(0.4, 0.3)):
    """The plain version of K5 in its widest mode: (4, C, N) statistics,
    whose row 0 is the MSE."""
    return fg.gr4j_regional_objective_reference(
        prec, etp, qobs, fg.pack_params(params, *inits), *uh, stats=True,
        masked=masked, counts=regional_counts(qobs, masked))


def regional_snow_call(fs, d, params, hyst, ice, uh, masked, stats=True,
                       inits=SNOW_CHECK_INITS, plain=False):
    """K11 through its wrapper or, with ``plain``, the plain version in its
    widest mode ((4, C, N) statistics).  ``d`` holds (C, T, L) ``prec``,
    ``temp``, ``frac``, (C, T) ``etp`` and ``qobs`` and (C, L)
    ``frac_ice``."""
    snow0, th0, s_init, r_init = inits
    qobs = d["qobs"]
    if not plain:
        return fs.snowgr4j_regional_mse_fused(
            d["prec"], d["temp"], d["etp"], d["frac"], qobs, snow0, th0,
            s_init, r_init, params, frac_ice=d["frac_ice"] if ice else None,
            hyst=hyst, ice=ice, stats=stats, num_uh1=uh[0], num_uh2=uh[1],
            masked=masked)
    snow, rain, consts = fs.layer_inputs(d["prec"], d["frac"], hyst)
    frac_ice = d["frac_ice"] if ice else torch.zeros_like(d["frac_ice"])
    return fs.snowgr4j_regional_objective_reference(
        snow, rain, d["temp"], d["etp"], qobs, fs.pack_params(
            params, s_init, r_init), consts, frac_ice, snow0, th0, hyst, ice,
        *uh, stats=True, masked=masked, counts=regional_counts(qobs, masked))


def regional_snow_random(rng, c, t_len, num_layers, dtype, gaps,
                         edges=False):
    """(C, T, L) layer forcing, (C, T) etp and observations (catchment 0's
    record cut short and NaN gaps in the others with ``gaps``, and with
    ``edges`` NaN on both sides of every 64-step tile edge) and (C, L)
    glacier fractions, from one numpy recipe."""
    shape = (c, t_len, num_layers)
    qobs = rng.uniform(0, 5, (c, t_len))
    if gaps:
        qobs[0, t_len * 2 // 3:] = np.nan
        qobs[1:, ::13] = np.nan
    if edges:
        qobs = tile_edge_gaps(qobs)
    d = dict(prec=rng.uniform(0, 15, shape), temp=rng.uniform(-12, 18, shape),
             frac=np.clip(rng.uniform(-0.3, 1.2, shape), 0, 1),
             etp=rng.uniform(0, 4, (c, t_len)), qobs=qobs,
             frac_ice=rng.uniform(0, 0.7, (c, num_layers)))
    return {k: as_tensor(v, dtype) for k, v in d.items()}


def phase_kernels_regional(prec_np, etp_np, qobs_np, n=256, t_len=1000,
                           snow_t_len=300):
    """K5 and K11 against their plain versions: float64 and float32, one
    and three catchments (three with a short record and gaps, masked), MSE
    and statistics; K5 at both UH register pairs on scaled copies of the
    CAMELS forcing, K11 in every variant at 1 and 5 layers."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs

    rng = np.random.default_rng(11)
    scale = rng.uniform(0.8, 1.2, (3, 1))
    qobs_gap = np.tile(qobs_np[:t_len], (3, 1))
    qobs_gap[0, t_len // 2:] = np.nan
    qobs_gap[1, rng.random(t_len) < 0.1] = np.nan
    n_checks = 0
    for dtype in (F64, F32):
        tol = TOL[dtype]["obj"]
        name = str(dtype)[6:]
        for c, masked in ((1, False), (3, True)):
            prec, etp = (as_tensor(a[:t_len] * scale[:c], dtype)
                         for a in (prec_np, etp_np))
            qobs = as_tensor(qobs_gap[:c] if masked
                             else np.tile(qobs_np[:t_len], (c, 1)), dtype)
            for uh in fg.SUPPORTED_UH:
                params = gr4j_random_params(
                    np.random.default_rng(uh[0]), n,
                    2.9 if uh[0] == 3 else BOUNDS_X4_WIDE, dtype)
                want = regional_gr4j_plain(fg, prec, etp, qobs, params, uh,
                                           masked)
                for stats in (False, True):
                    got = fg.gr4j_regional_objective_fused(
                        prec, etp, qobs, 0.4, 0.3, params, *uh, stats=stats,
                        masked=masked)
                    report(f"gr4j_regional {name} C={c} uh={uh} "
                           f"{'stats' if stats else 'mse'}"
                           f"{'+masked' if masked else ''}", got,
                           want if stats else want[0], *tol)
                    n_checks += 1
            for num_layers in (1, 5):
                d = regional_snow_random(np.random.default_rng(num_layers),
                                         c, snow_t_len, num_layers, dtype,
                                         masked)
                for uh in fg.SUPPORTED_UH:
                    params = snow_random_params(
                        np.random.default_rng(uh[0]), n, dtype,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                    for variant, hyst, ice in SNOW_VARIANTS:
                        kw = dict(hyst=hyst, ice=ice, uh=uh, masked=masked)
                        want = regional_snow_call(fs, d, params, plain=True,
                                                  **kw)
                        for stats in (False, True):
                            got = regional_snow_call(fs, d, params,
                                                     stats=stats, **kw)
                            report(f"snow_regional {name} C={c} "
                                   f"L={num_layers} uh={uh} {variant:8s} "
                                   f"{'stats' if stats else 'mse'}"
                                   f"{'+masked' if masked else ''}", got,
                                   want if stats else want[0], *tol)
                            n_checks += 1
        n_checks += gr4j_regional_edge_checks(prec_np, etp_np, qobs_np,
                                              dtype)
        # K11 around its 64-step staging tiles: layers in registers (1, 5)
        # and in shared-memory columns (2, 7), T shorter than a tile and two
        # whole tiles, N = 200 (a ragged last block), gaps at the tile edges
        # and a record cut short.
        for edge_t in (37, 128):
            for num_layers in (1, 2, 5, 7):
                params = snow_random_params(np.random.default_rng(4),
                                            EDGE_MEMBERS, dtype, 2.9)
                for c in (1, 3):
                    d = regional_snow_random(
                        np.random.default_rng(edge_t + num_layers), c,
                        edge_t, num_layers, dtype, True, edges=True)
                    for variant, hyst, ice in SNOW_VARIANTS:
                        kw = dict(hyst=hyst, ice=ice, uh=(3, 7), masked=True)
                        want = regional_snow_call(fs, d, params, plain=True,
                                                  **kw)
                        for stats in (False, True):
                            got = regional_snow_call(fs, d, params,
                                                     stats=stats, **kw)
                            report(f"snow_regional {name} T={edge_t} "
                                   f"N={EDGE_MEMBERS} C={c} L={num_layers} "
                                   f"{variant:8s} "
                                   f"{'stats' if stats else 'mse'}+masked",
                                   got, want if stats else want[0], *tol)
                            n_checks += 1
    print(f"[3 kernels] regional: {n_checks} kernel-vs-plain checks passed "
          f"(K5 N={n} T={t_len}, and at T in {GR4J_EDGE_STEPS}, "
          f"N={EDGE_MEMBERS}; K11 N={n} T={snow_t_len}, and at T in (37, "
          f"128), N={EDGE_MEMBERS}, L in (1, 2, 5, 7); C in (1, 3))")


def gr4j_regional_edge_checks(prec_np, etp_np, qobs_np, dtype):
    """K5 around K1/K2's 64-step staging tiles, which it shares: T = 1, 37,
    65 and 128, N = 200 (a ragged last block), one catchment and three (the
    first record cut short at two thirds), gaps on both sides of the tile
    edges, both UH register pairs, MSE and statistics.  Returns the count
    of checks."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    tol, name = TOL[dtype]["obj"], str(dtype)[6:]
    scale = np.random.default_rng(12).uniform(0.8, 1.2, (3, 1))
    n_checks = 0
    for uh in fg.SUPPORTED_UH:
        params = gr4j_random_params(np.random.default_rng(uh[1]),
                                    EDGE_MEMBERS,
                                    2.9 if uh[0] == 3 else BOUNDS_X4_WIDE,
                                    dtype)
        for t_len in GR4J_EDGE_STEPS:
            for c in (1, 3):
                prec, etp = (as_tensor(a[:t_len] * scale[:c], dtype)
                             for a in (prec_np, etp_np))
                qobs = tile_edge_gaps(np.tile(qobs_np[:t_len], (c, 1)))
                if c > 1:
                    qobs[0, max(1, 2 * t_len // 3):] = np.nan
                qobs = as_tensor(qobs, dtype)
                want = regional_gr4j_plain(fg, prec, etp, qobs, params, uh,
                                           True)
                for stats in (False, True):
                    got = fg.gr4j_regional_objective_fused(
                        prec, etp, qobs, 0.4, 0.3, params, *uh, stats=stats,
                        masked=True)
                    report(f"gr4j_regional {name} T={t_len} N={EDGE_MEMBERS} "
                           f"C={c} uh={uh} "
                           f"{'stats' if stats else 'mse'}+masked", got,
                           want if stats else want[0], *tol)
                    n_checks += 1
    return n_checks


REGION_BASINS = 8
REGION_CHECK_MEMBERS = 4096    # members per catchment held against plain
GLUE_MEMBERS = 20000
GLUE_DAYS = 3652


def write_region(directory, seed=0):
    """CAMELS-format files of REGION_BASINS basins made from the bundled
    01031500: each basin's precipitation scaled by a seeded factor in
    [0.8, 1.2] and its PET by one in [0.9, 1.1] (as
    ``examples/05_uncertainty_regional.py`` does); basin 0's discharge
    record ends at half (-999 after it), basin 1's has 10 % scattered -999
    gaps."""
    import pandas as pd
    from rrmpg_tpu_torch.data.camelsloader import BUNDLED_DIR

    met_path = BUNDLED_DIR / "01031500_lump_cida_forcing_leap.txt"
    flow_path = BUNDLED_DIR / "01031500_05_model_output.txt"
    head = met_path.read_text().splitlines()[:4]
    met = pd.read_csv(met_path, sep=r"\s+", header=3)
    flow = pd.read_csv(flow_path, sep=r"\s+", header=0)
    rng = np.random.default_rng(seed)
    for b in range(REGION_BASINS):
        basin = f"{90000000 + b:08d}"
        m, f = met.copy(), flow.copy()
        m["prcp(mm/day)"] *= rng.uniform(0.8, 1.2)
        f["PET"] *= rng.uniform(0.9, 1.1)
        obs = f["OBS_RUN"].to_numpy().copy()
        if b == 0:
            obs[len(obs) // 2:] = -999.0
        elif b == 1:
            obs[rng.random(len(obs)) < 0.1] = -999.0
        f["OBS_RUN"] = obs
        (directory / f"{basin}_lump_cida_forcing_leap.txt").write_text(
            "\n".join(head) + "\n"
            + m.to_csv(sep=" ", header=False, index=False))
        f.to_csv(directory / f"{basin}_05_model_output.txt", sep=" ",
                 index=False)


def region_snow_arrays(seed=1):
    """The hysteresis + ice Excel sheet's 5-layer forcing for
    REGION_BASINS catchments, as numpy: (C, T, L) precipitation scaled per
    catchment by a seeded factor in [0.8, 1.2], temperature and solid
    fraction, (C, T) PET scaled by one in [0.9, 1.1], the sheet's discharge
    with its gaps (catchment 0's record ending at half), and (C, L) glacier
    fractions scaled per catchment by one in [0.5, 1.5]."""
    from rrmpg_tpu_torch.models import CemaneigeHystGR4JIce

    met, qobs, _ = snow_main_data()
    f = CemaneigeHystGR4JIce(dtype=F64)._prepare(
        *met.values(), FRAC_ICE_GOLDEN, 700, ALTITUDES, 0, 0, 0, 0.5, 0.4)
    prec, temp, frac, etp = (x.cpu().numpy() for x in (
        f.prec, f.mean_temp, f.frac_solid_prec, f.etp))
    rng = np.random.default_rng(seed)
    c = REGION_BASINS
    qobs_ct = np.tile(qobs, (c, 1))
    qobs_ct[0, len(qobs) // 2:] = np.nan
    return dict(
        prec=np.stack([prec * rng.uniform(0.8, 1.2) for _ in range(c)]),
        temp=np.stack([temp] * c), frac=np.stack([frac] * c),
        etp=np.stack([etp * rng.uniform(0.9, 1.1) for _ in range(c)]),
        qobs=qobs_ct,
        frac_ice=np.stack([np.clip(FRAC_ICE_GOLDEN * rng.uniform(0.5, 1.5),
                                   0, 1) for _ in range(c)]))


def weighted_quantile_np(values, weights, q):
    """One weighted quantile of one time step, in numpy: the first sorted
    member whose normalized cumulative weight reaches ``q``."""
    order = np.argsort(values, kind="stable")
    cdf = np.cumsum(weights[order])
    return values[order][np.argmax(cdf / cdf[-1] >= q)]


def phase_regional(card):
    """The regional path through the public entry points: eight CAMELS
    basins written from the bundled one, ``load_basins(join='outer')``, the
    regional GR4J objective (K5) and the regional snow objective (K11) at
    8 x 131072 members for 'mse' and 'kge', and GLUE on a 20000-member
    Monte-Carlo of CemaneigeGR4J (K9); then each regional launch against its
    plain version on the first REGION_CHECK_MEMBERS members."""
    from rrmpg_tpu_torch import interop
    from rrmpg_tpu_torch.data import CAMELSLoader
    from rrmpg_tpu_torch.models import (CemaneigeGR4J, CemaneigeHystGR4JIce,
                                        GR4J)
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs
    from rrmpg_tpu_torch.parallel import (regional_gr4j_objective,
                                          regional_snow_objective)
    from rrmpg_tpu_torch.tools import (glue_weights, monte_carlo,
                                       prediction_limits)

    n = MC_MEMBERS
    np.random.seed(4)
    gr4j_members = GR4J().get_random_params(n)
    snow_members = CemaneigeHystGR4JIce().get_random_params(n)
    snow_np = region_snow_arrays()
    loader = CAMELSLoader()
    df = loader.load_basin('01031500').iloc[:GLUE_DAYS]
    glue_qobs = df['QObs(mm/d)'].to_numpy()
    glue_met = dict(prec=df['prcp(mm/day)'].to_numpy(),
                    mean_temp=((df['tmax(C)'] + df['tmin(C)']) / 2).to_numpy(),
                    min_temp=df['tmin(C)'].to_numpy(),
                    max_temp=df['tmax(C)'].to_numpy(),
                    etp=df['PET'].to_numpy())
    height = loader.get_station_height('01031500')
    walls, out = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        return result

    with tempfile.TemporaryDirectory() as tmp:
        write_region(Path(tmp))

        def drive():
            index, arrays = timed("load_basins", lambda: CAMELSLoader(
                tmp).load_basins(join='outer'))
            prec, etp, qobs = interop.regional_forcing_from_numpy(
                arrays['prcp(mm/day)'], arrays['PET'], arrays['QObs(mm/d)'],
                device=DEVICE)
            params = interop.params_from_numpy(gr4j_members, device=DEVICE)
            for loss in ('mse', 'kge'):
                out[f"gr4j {loss}"] = timed(
                    f"gr4j {loss}", lambda: regional_gr4j_objective(
                        prec, etp, qobs, 0.3, 0.3, params, loss_metric=loss))
            etp_s, qobs_s, prec_s, temp_s, frac_s, frac_ice = (
                interop.regional_forcing_from_numpy(
                    snow_np["etp"], snow_np["qobs"],
                    layers=(snow_np["prec"], snow_np["temp"],
                            snow_np["frac"]),
                    frac_ice=snow_np["frac_ice"], device=DEVICE))
            snow_params = interop.params_from_numpy(snow_members,
                                                    device=DEVICE)
            for loss in ('mse', 'kge'):
                out[f"snow {loss}"] = timed(
                    f"snow {loss}", lambda: regional_snow_objective(
                        prec_s, temp_s, etp_s, frac_s, qobs_s, 0.0, 0.0, 0.5,
                        0.4, snow_params, frac_ice=frac_ice, hyst=True,
                        ice=True, loss_metric=loss))
            np.random.seed(5)
            mc = timed("glue monte_carlo", lambda: monte_carlo(
                CemaneigeGR4J(), num=GLUE_MEMBERS, qobs=glue_qobs,
                **glue_met, met_station_height=height, metrics=('nse',),
                engine='fused'))
            weights = timed("glue weights", lambda: glue_weights(
                mc['nse'], behavioral_threshold=0.3))
            limits = timed("glue limits", lambda: prediction_limits(
                mc['qsim'], weights, quantiles=(0.05, 0.5, 0.95)))
            return (index, arrays, (prec, etp, qobs, params),
                    (prec_s, temp_s, etp_s, frac_s, qobs_s, frac_ice,
                     snow_params), mc, weights, limits)

        (index, arrays, gr4j_in, snow_in, mc, weights, limits), launches, \
            _ = run_counted(drive)

    qobs_np = arrays['QObs(mm/d)']
    t_len = len(index)
    n_valid = np.isfinite(qobs_np).sum(axis=1)
    check(n_valid[0] < t_len // 2 + 400 and n_valid[1] < 0.95 * t_len
          and np.isfinite(arrays['prcp(mm/day)']).all(),
          f"load_basins: the ragged records did not come through "
          f"(valid days {n_valid.tolist()} of {t_len})")
    for key, losses in out.items():
        check(losses.shape == (REGION_BASINS, n)
              and bool(torch.isfinite(losses).all()),
              f"regional {key}: losses of shape {tuple(losses.shape)}, "
              "not all finite")
    expect = {"gr4j_regional": 2, "snow_regional": 2, "snow_traj": 1}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    lo, med, hi = limits
    valid = np.isfinite(glue_qobs)
    coverage = float(np.mean((glue_qobs[valid] >= lo[valid])
                             & (glue_qobs[valid] <= hi[valid])))
    behavioural = int((weights > 0).sum())
    check(limits.shape == (3, GLUE_DAYS) and np.isfinite(limits).all()
          and bool(np.all(lo <= med) and np.all(med <= hi))
          and behavioural > 0 and abs(float(weights.sum()) - 1.0) < 1e-6,
          "GLUE: prediction limits not finite and ordered, or no "
          "behavioural member")
    qsim = mc['qsim']
    for t in range(0, GLUE_DAYS, 365):
        for k, q in enumerate((0.05, 0.5, 0.95)):
            want = weighted_quantile_np(qsim[t].astype(np.float64), weights,
                                        q)
            check(np.isclose(limits[k, t], want, rtol=1e-6),
                  f"GLUE: limit {q} at step {t} is {limits[k, t]}, numpy "
                  f"gives {want}")
    best = {k: v.min(dim=1).values.double().cpu().numpy()
            for k, v in out.items()}
    print(f"[5 main path] regional, {REGION_BASINS} CAMELS-format basins "
          f"(load_basins join='outer', T={t_len}, valid days "
          f"{n_valid.tolist()}) x {n} members float32: GR4J mse in "
          f"{walls['gr4j mse']:.3f} s, best per catchment "
          f"{np.round(best['gr4j mse'], 3).tolist()}; kge in "
          f"{walls['gr4j kge']:.3f} s, best 1-KGE "
          f"{np.round(best['gr4j kge'], 3).tolist()}; {card}")
    print(f"[5 main path] regional snow, hyst+ice Excel forcing T="
          f"{snow_np['qobs'].shape[1]} x {len(ALTITUDES)} layers x "
          f"{REGION_BASINS} catchments x {n} members: mse in "
          f"{walls['snow mse']:.3f} s, kge in {walls['snow kge']:.3f} s, best "
          f"1-KGE {np.round(best['snow kge'], 3).tolist()}; {card}")
    print(f"[5 main path] GLUE, CemaneigeGR4J {GLUE_MEMBERS} members x "
          f"{GLUE_DAYS} days of 01031500: {behavioural} behavioural (NSE > "
          f"0.3), 90 % band covers {coverage:.1%} of the observations, best "
          f"NSE {np.nanmax(mc['nse']):.3f}; monte_carlo "
          f"{walls['glue monte_carlo']:.3f} s, limits "
          f"{walls['glue limits']:.3f} s; launches {launches} == expected; "
          f"{card}")

    # Each regional launch against its plain version on the first members
    # of every catchment (these launches are not counted above).
    m = REGION_CHECK_MEMBERS
    max_abs = {}
    prec, etp, qobs, params = gr4j_in
    sub = {k: v[:m].contiguous() for k, v in params.items()}
    masked = bool(torch.isnan(qobs).any())
    want = regional_gr4j_plain(fg, prec, etp, qobs, sub, (10, 21), masked,
                               (0.3, 0.3))
    for stats in (False, True):
        got = fg.gr4j_regional_objective_fused(prec, etp, qobs, 0.3, 0.3,
                                               sub, stats=stats,
                                               masked=masked)
        err = report(f"main-path shape gr4j_regional "
                     f"({'stats' if stats else 'mse'}, first {m} members)",
                     got, want if stats else want[0], *TOL[F32]["obj"])
        max_abs["gr4j_regional"] = max(max_abs.get("gr4j_regional", 0.0),
                                       err)
    prec_s, temp_s, etp_s, frac_s, qobs_s, frac_ice, snow_params = snow_in
    d = dict(prec=prec_s, temp=temp_s, frac=frac_s, etp=etp_s, qobs=qobs_s,
             frac_ice=frac_ice)
    sub = {k: v[:m].contiguous() for k, v in snow_params.items()}
    kw = dict(hyst=True, ice=True, uh=(10, 21), masked=True,
              inits=(0.0, 0.0, 0.5, 0.4))
    want = regional_snow_call(fs, d, sub, plain=True, **kw)
    for stats in (False, True):
        err = report(f"main-path shape snow_regional "
                     f"({'stats' if stats else 'mse'}, first {m} members)",
                     regional_snow_call(fs, d, sub, stats=stats, **kw),
                     want if stats else want[0], *TOL[F32]["obj"])
        max_abs["snow_regional"] = max(max_abs.get("snow_regional", 0.0),
                                       err)
    return launches, max_abs, walls


# The tools phase: SCE-UA, NSGA-II, Sobol' / Morris, DE-MC and the FDC
# signatures of monte_carlo, driven through their entry points.
TOOLS_SCE_MAXITER = 20
TOOLS_PARETO = dict(pop_size=128, n_generations=30)
TOOLS_SOBOL_N = 1024
TOOLS_SOBOL_CHECKED = 512      # design points held against the plain version
TOOLS_MORRIS_TRAJECTORIES = 64
TOOLS_DEMC = dict(num_chains=16, num_steps=400)
TOOLS_DEMC_SIGMA = 2.0         # mm/day: the Gaussian likelihood's error
TOOLS_MC_MEMBERS = 16384
TOOLS_MC_CHECKED = 256         # members whose signatures are held to float64
SIGNATURE_TOL = (5e-3, 1e-3)


def sce_counts(res, dim, n_complexes=None):
    """(p, m, beta) of an SCE-UA run on ``dim`` parameters and its exact
    evaluation count."""
    p = n_complexes or max(2, dim)
    m = beta = 2 * dim + 1
    return p, beta, p * m + res.nit * beta * 3 * p


def gr4j_mse_objective(prec_t, etp_t, qobs_t, record=None):
    """A user's batched GR4J MSE objective on the fused op (K1): (P, 4)
    candidates -> (P,); ``record`` keeps each call's candidates and losses."""
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.models.gr4j import fit_uh_lengths
    from rrmpg_tpu_torch.ops import gr4j_ensemble_mse_fused

    n1, n2 = fit_uh_lengths(GR4J._default_bounds['x4'][1])

    def objective(X):
        params = {n: X[:, j].contiguous()
                  for j, n in enumerate(GR4J._param_list)}
        out = gr4j_ensemble_mse_fused(prec_t, etp_t, qobs_t, 0.0, 0.0, params,
                                      num_uh1=n1, num_uh2=n2)
        if record is not None:
            record.append((X, out))
        return out

    return objective, (n1, n2)


def gr4j_mse_plain(prec_t, etp_t, qobs_t, X, uh):
    """K1's plain version on the candidates X (rows in parameter order)."""
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    params = {n: torch.as_tensor(X[:, j], dtype=prec_t.dtype,
                                 device=DEVICE).contiguous()
              for j, n in enumerate(GR4J._param_list)}
    return fg.gr4j_objective_reference(prec_t, etp_t, qobs_t,
                                       fg.pack_params(params, 0.0, 0.0),
                                       *uh)


def phase_tools(card, qobs, prec, etp, forcing, qsim_matlab):
    """The analysis tools through their entry points, at full width:
    ``fit(method='sce')`` of GR4J on CAMELS 01031500 (K1) and of HBV-Edu on
    the MATLAB days (K12); ``fit_Q_SCA(pareto=True)`` of the hysteresis +
    ice model on its Excel sheet (K8's SCA statistics); Sobol' indices and
    Morris screening over a fused GR4J MSE (K1, one launch each); DE-MC on
    a Gaussian likelihood from K1 (two launches a step); and
    ``monte_carlo`` with the FDC signatures (K3, never K2).  Each with its
    launch counts read just after; then the checks against the 'scan'
    engine and the plain versions (not counted)."""
    from rrmpg_tpu_torch.models import GR4J, CemaneigeHystGR4JIce, HBVEdu
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops.uh import required_uh_lengths
    from rrmpg_tpu_torch.tools import (demc_sample, hypervolume_2d,
                                       monte_carlo, morris_screening,
                                       sobol_indices)
    from rrmpg_tpu_torch.utils import (calibration_loss, fdc_fhv, fdc_flv,
                                       fdc_fms, mse)

    launches, max_abs, walls = {}, {}, {}

    def counted(key, fn):
        result, counts, seconds = run_counted(fn)
        walls[key] = seconds
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return result, counts

    prec_t, etp_t, qobs_t = (as_tensor(a, F32) for a in (prec, etp, qobs))
    names = GR4J._param_list
    t_len = len(prec)

    # SCE-UA on GR4J, every CCE step one K1 launch of 3 p candidates.
    res, counts = counted("sce GR4J", lambda: GR4J().fit(
        qobs, prec, etp, method='sce', engine='fused', loss_metric='mse',
        seed=0, maxiter=TOOLS_SCE_MAXITER))
    check_fit(GR4J, res, "SCE GR4J")
    p, beta, nfev = sce_counts(res, len(names))
    check(res.nfev == nfev, f"SCE GR4J nfev {res.nfev}, expected {nfev}")
    expect = {"gr4j_mse": 1 + res.nit * beta}
    check(counts == expect,
          f"SCE GR4J launch counts {counts} differ from {expect}")
    qsim = GR4J(params=dict(zip(names, map(float, res.x)))).simulate(
        prec, etp, engine='scan')[:, 0]
    scan_fun = float(mse(qobs_t, qsim))
    check(np.isclose(res.fun, scan_fun, rtol=TOL[F32]["obj"][0]),
          f"SCE GR4J fun {res.fun} against the 'scan' engine's {scan_fun}")
    print(f"[5 tools] SCE-UA GR4J fused on CAMELS 01031500 T={t_len} "
          f"float32: p={p}, {3 * p} candidates a CCE step, nit={res.nit}, "
          f"nfev={res.nfev}, fun {res.fun:.5f} ('scan' at x: "
          f"{scan_fun:.5f}), success={res.success} in "
          f"{walls['sce GR4J']:.3f} s; launches {counts} == expected; "
          f"{card}")

    # SCE-UA on HBV-Edu with the field capacity's bound lowered to 1 mm, so
    # that members whose soil store empties arise: their losses are NaN
    # (K12 keeps them NaN), counted on the device through the objective,
    # and the optimizer must never select one.
    snow, soil, s1, s2 = HBV_INITS
    inits = dict(snow_init=snow, soil_init=soil, s1_init=s1, s2_init=s2)
    hbv_qobs = qsim_matlab * (24 * 60 * 60) / (HBV_AREA * 1000)
    hbv_qobs[::97] = np.nan
    seen = []

    class CountedHBV(HBVEdu):
        _default_bounds = dict(HBVEdu._default_bounds, FC=(1.0, 200.0))

        def _batch_objective(self, *args, **kw):
            objective = super()._batch_objective(*args, **kw)

            def counted_objective(X):
                out = objective(X)
                seen.append(torch.isnan(out).sum())
                return out

            return counted_objective

    res_hbv, counts = counted("sce HBV-Edu", lambda: CountedHBV().fit(
        hbv_qobs, **forcing, **inits, method='sce', engine='fused', seed=0,
        maxiter=TOOLS_SCE_MAXITER))
    n_nan = int(torch.stack(seen).sum())
    p_h, beta_h, nfev_h = sce_counts(res_hbv, len(HBVEdu._param_list))
    check(np.isfinite(res_hbv.fun) and res_hbv.nfev == nfev_h and n_nan > 0,
          f"SCE HBV-Edu: fun {res_hbv.fun}, nfev {res_hbv.nfev} (expected "
          f"{nfev_h}), {n_nan} NaN candidates")
    check_fit(CountedHBV, res_hbv, "SCE HBV-Edu")
    expect = {"hbv_mse": 1 + res_hbv.nit * beta_h}
    check(counts == expect,
          f"SCE HBV-Edu launch counts {counts} differ from {expect}")
    print(f"[5 tools] SCE-UA HBV-Edu fused on the MATLAB days "
          f"T={len(hbv_qobs)} float32, FC in (1, 200): p={p_h}, "
          f"nit={res_hbv.nit}, nfev="
          f"{res_hbv.nfev}, fun {res_hbv.fun:.5f}, {n_nan} NaN candidates "
          f"quarantined in {walls['sce HBV-Edu']:.3f} s; launches {counts} "
          f"== expected; {card}")

    # NSGA-II: the Q-vs-SCA Pareto front, one K8 launch a generation.
    met, snow_qobs, ndsi = snow_main_data()
    snow_forcing = (*met.values(), FRAC_ICE_GOLDEN)
    setup = dict(met_station_height=700, altitudes=ALTITUDES, s_init=0.5,
                 r_init=0.4)
    pareto_kw = dict(loss_metric='kge', engine='fused', seed=0, pareto=True,
                     **setup)
    gens = TOOLS_PARETO["n_generations"]
    front, counts = counted("pareto", lambda: CemaneigeHystGR4JIce(
        ).fit_Q_SCA(snow_qobs, *snow_forcing, *ndsi, **pareto_kw,
                    **TOOLS_PARETO))
    expect = {"snow_sca_stats": gens + 1}
    check(counts == expect,
          f"Pareto fit launch counts {counts} differ from {expect}")
    initial, counts0 = run_counted(lambda: CemaneigeHystGR4JIce().fit_Q_SCA(
        snow_qobs, *snow_forcing, *ndsi, **pareto_kw,
        pop_size=TOOLS_PARETO["pop_size"], n_generations=0))[:2]
    check(counts0 == {"snow_sca_stats": 1},
          f"the initial population's launch counts {counts0}")
    check(len(front.x) >= 1 and (front.rank == 0).sum() == len(front.x)
          and np.isfinite(front.f).all(),
          f"Pareto front of {len(front.x)} members, ranks "
          f"{np.unique(front.rank)}, not all finite")
    finite0 = np.isfinite(initial.population_f).all(axis=1)
    nadir = initial.population_f[finite0].max(axis=0)
    hv_0 = hypervolume_2d(initial.population_f, nadir)
    hv = hypervolume_2d(front.f, nadir)
    check(hv >= hv_0, f"hypervolume {hv} of the front below the initial "
          f"population's {hv_0}")
    # The front re-evaluated through the 'scan' engine's trajectories.
    model = CemaneigeHystGR4JIce()
    params = {n: front.x[:, j]
              for j, n in enumerate(model._param_list)}
    out = model.simulate(*snow_forcing, params=params, engine='scan',
                         return_storage=True, **setup)
    loss = calibration_loss('kge')
    obs_t = as_tensor(snow_qobs, F32)
    l_q = loss(obs_t[:, None], out[0], dim=0)
    sca = 100.0 * out[5]                                   # (T, L, F)
    l_sca = sum(loss(as_tensor(ndsi[b], F32)[:, None], sca[:, b], dim=0)
                for b in range(len(ALTITUDES)))
    scan_f = torch.stack([l_q, l_sca], dim=1).double().cpu().numpy()
    check(np.allclose(front.f, scan_f, rtol=TOL[F32]["obj"][0]),
          f"Pareto front f against the 'scan' components: largest "
          f"difference {np.abs(front.f - scan_f).max()}")
    print(f"[5 tools] NSGA-II fit_Q_SCA(pareto=True) CemaneigeHystGR4JIce "
          f"fused, Excel sheet T={len(snow_qobs)} x {len(ALTITUDES)} layers "
          f"float32: pop {TOOLS_PARETO['pop_size']} x {gens} generations, "
          f"front {len(front.x)} members, (1-KGE_q, sum 1-KGE_sca) from "
          f"{front.f.min(axis=0).round(4).tolist()} to "
          f"{front.f.max(axis=0).round(4).tolist()}, hypervolume {hv:.4f} "
          f">= initial {hv_0:.4f} (nadir {nadir.round(4).tolist()}); 'scan' "
          f"components within {np.abs(front.f / scan_f - 1).max():.2e}; "
          f"in {walls['pareto']:.3f} s; launches {expect} == expected "
          f"(+1 for the initial population); {card}")

    # Sobol' and Morris over a fused GR4J MSE: the design in one launch.
    bounds = [GR4J._default_bounds[n] for n in names]
    record = []
    objective, uh = gr4j_mse_objective(prec_t, etp_t, qobs_t, record)
    sob, counts = counted("sobol", lambda: sobol_indices(
        objective, bounds, n=TOOLS_SOBOL_N, seed=0, batched=True,
        names=tuple(names)))
    rows = TOOLS_SOBOL_N * (len(names) + 2)
    check(counts == {"gr4j_mse": 1} and record[0][0].shape[0] == rows,
          f"Sobol': launch counts {counts} for {rows} design points")
    X0, f0 = record[0]
    k = TOOLS_SOBOL_CHECKED
    want = gr4j_mse_plain(prec_t, etp_t, qobs_t, X0[:k], uh)
    max_abs["gr4j_mse"] = report(
        f"tools shape gr4j_mse (Sobol' design, first {k} of {rows})",
        f0[:k], want, *TOL[F32]["obj"])
    check(np.isfinite(sob.s1).all() and np.isfinite(sob.st).all()
          and sob.n_used == TOOLS_SOBOL_N,
          f"Sobol' indices not finite: {sob}")
    record.clear()
    mor, counts = counted("morris", lambda: morris_screening(
        objective, bounds, num_trajectories=TOOLS_MORRIS_TRAJECTORIES,
        seed=0, batched=True, names=tuple(names)))
    points = TOOLS_MORRIS_TRAJECTORIES * (len(names) + 1)
    check(counts == {"gr4j_mse": 1} and record[0][0].shape[0] == points
          and np.isfinite(mor.mu_star).all()
          and (mor.n_effects == TOOLS_MORRIS_TRAJECTORIES).all(),
          f"Morris: launch counts {counts}, {mor}")
    print(f"[5 tools] Sobol' n={TOOLS_SOBOL_N} ({rows} points, one K1 "
          f"launch) over GR4J fused MSE, CAMELS 01031500: S1 "
          f"{np.round(sob.s1, 3).tolist()}, ST {np.round(sob.st, 3).tolist()}"
          f" in {walls['sobol']:.3f} s; Morris {TOOLS_MORRIS_TRAJECTORIES} "
          f"trajectories ({points} points, one launch): mu* "
          f"{np.round(mor.mu_star, 3).tolist()} in {walls['morris']:.3f} s; "
          f"{card}")

    # DE-MC on a Gaussian likelihood from K1: two launches a step.
    scale = -0.5 * t_len / TOOLS_DEMC_SIGMA ** 2
    mse_objective, _ = gr4j_mse_objective(prec_t, etp_t, qobs_t)
    chain, counts = counted("demc", lambda: demc_sample(
        lambda X: scale * mse_objective(X), bounds, seed=0, batched=True,
        **TOOLS_DEMC))
    steps = TOOLS_DEMC["num_steps"]
    expect = {"gr4j_mse": 1 + 2 * steps}
    check(counts == expect, f"DE-MC launch counts {counts} differ from "
          f"{expect}")
    plain_map = scale * float(gr4j_mse_plain(
        prec_t, etp_t, qobs_t, chain.x_map[None, :], uh)[0])
    check(0.0 < chain.acceptance_rate < 1.0
          and np.isfinite(chain.r_hat).all()
          and np.isclose(chain.logp_map, plain_map,
                         rtol=TOL[F32]["obj"][0]),
          f"DE-MC: acceptance {chain.acceptance_rate}, r_hat "
          f"{chain.r_hat}, logp_map {chain.logp_map} against the plain "
          f"version's {plain_map}")
    print(f"[5 tools] DE-MC GR4J fused Gaussian likelihood (sigma "
          f"{TOOLS_DEMC_SIGMA} mm/day) on CAMELS 01031500: "
          f"{TOOLS_DEMC['num_chains']} chains x {steps} steps, acceptance "
          f"{chain.acceptance_rate:.3f}, r_hat "
          f"{np.round(chain.r_hat, 3).tolist()}, x_map "
          f"{np.round(chain.x_map, 3).tolist()}, logp_map "
          f"{chain.logp_map:.2f} (plain {plain_map:.2f}) in "
          f"{walls['demc']:.3f} s ({walls['demc'] / steps * 1e3:.2f} ms a "
          f"step); launches {counts} == expected; {card}")

    # monte_carlo with the FDC signatures: the trajectory kernel K3 once.
    metrics = ('mse', 'fhv', 'flv', 'fms')
    np.random.seed(6)
    mc, counts = counted("mc signatures", lambda: monte_carlo(
        GR4J(), TOOLS_MC_MEMBERS, qobs, metrics=metrics, return_qsim=False,
        engine='fused', prec=prec, etp=etp))
    check(counts == {"gr4j_traj": 1},
          f"monte_carlo with signatures: launch counts {counts}, expected "
          "K3 once and K2 never")
    for m in metrics:
        check(mc[m].shape == (TOOLS_MC_MEMBERS,) and np.isfinite(mc[m]).all(),
              f"monte_carlo {m}: shape {mc[m].shape}, not all finite")
    k = TOOLS_MC_CHECKED
    members, _ = GR4J(dtype=F64)._prepare_params(mc['params'][:k])
    traj = fg.gr4j_simulate_reference(
        as_tensor(prec, F64), as_tensor(etp, F64),
        fg.pack_params(members, 0.0, 0.0),
        *required_uh_lengths(members['x4'])).T               # (T, k)
    obs64 = as_tensor(qobs, F64)[:, None]
    plain = {'fhv': fdc_fhv(obs64, traj, dim=0),
             'flv': fdc_flv(obs64, traj, dim=0),
             'fms': fdc_fms(obs64, traj, dim=0),
             'mse': mse(obs64, traj, dim=0)}
    worst = {}
    for m in metrics:
        want = plain[m].cpu().numpy()
        diff = np.abs(mc[m][:k] - want)
        worst[m] = float(diff.max())
        check(np.allclose(mc[m][:k], want, rtol=SIGNATURE_TOL[0],
                          atol=SIGNATURE_TOL[1]),
              f"monte_carlo {m} of the first {k} members: largest "
              f"difference {worst[m]} from float64 signatures of the plain "
              "trajectories")
    print(f"[5 tools] monte_carlo GR4J {TOOLS_MC_MEMBERS} x {t_len} fused "
          f"with {metrics}, return_qsim=False: median FHV "
          f"{np.median(mc['fhv']):.2f} %, FLV {np.median(mc['flv']):.2f} %, "
          f"FMS {np.median(mc['fms']):.2f} % in "
          f"{walls['mc signatures']:.3f} s; first {k} members within "
          f"rtol={SIGNATURE_TOL[0]}, atol={SIGNATURE_TOL[1]} of float64 "
          f"signatures of the plain trajectories (largest differences "
          f"{ {m: float(f'{v:.2e}') for m, v in worst.items()} }); launches "
          f"{counts} == expected; {card}")
    total = sum(walls.values())
    print(f"[5 tools] the tools' entry points took {total:.3f} s; {card}")
    return launches, max_abs, walls


# ---------------------------------------------------------------------------
# The assimilation path: ensemble data assimilation on the warm entries of
# K4, K14 and K10
# ---------------------------------------------------------------------------

ASSIM_MEMBERS = 131072
ASSIM_WINDOW = 10            # days a cycle; the last 365 days give 36 cycles
ASSIM_NOISE = 0.02           # std of the twin truth's observation noise
ASSIM_SEED = 0
ASSIM_WALL_SHAPE = (1024, 128)   # benchmarks/assim_cycle.py's members x windows
ASSIM_CHECK = (256, 5)       # members x cycles of 'fused' against 'scan'
ASSIM_ABC_MEMBERS = 4096
ASSIM_SPREAD = 0.2           # lognormal scale of the joint run's parameters
ASSIM_DRY = 0.5              # the ensemble starts with its stores halved
ASSIM_SPIN_IN = 5            # cycles left out of the RMSE (the filter's spin-in)
# Parameters of the path when it runs without the main paths
# (``--phases assim``, development): the golden sets.
ASSIM_FALLBACK = {"GR4J": GR4J_GOLDEN, "HBV-Edu": HBV_GOLDEN,
                  "snow": dict(HYST_GOLDEN, DDF=5.0)}


def generator(seed):
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return g


def assim_ensemble(model, state, n, seed):
    """``n`` members around one spun-up ``state``, started dry: every
    dynamical field scaled by ASSIM_DRY (the series constants kept), then
    broadcast and spread with ``perturb_state(rel_std=0.2)``."""
    from rrmpg_tpu_torch.models.states import broadcast_state
    from rrmpg_tpu_torch.tools import perturb_state
    from rrmpg_tpu_torch.tools.assimilation import (CONSTANT_FIELDS,
                                                    _flatten_state)

    one = model._single_member_state(state)
    X, rebuild = _flatten_state(broadcast_state(one, 1), CONSTANT_FIELDS)
    dry = rebuild(X * ASSIM_DRY)
    shared = broadcast_state(model._single_member_state(dry), n)
    return perturb_state(shared, generator(seed), rel_std=0.2)


def shared_params(model, n):
    """The model's one parameter set for ``n`` members (state estimation)."""
    return {name: torch.full((n,), float(getattr(model, name)), dtype=F32,
                             device=DEVICE) for name in model._param_list}


def around(model, n, seed, rel):
    """``n`` members around the model's parameters (lognormal factors of
    scale ``rel``, clipped into the class bounds), on the card."""
    g = generator(seed)
    out = {}
    for name in model._param_list:
        lo, hi = model._default_bounds[name]
        z = torch.randn(n, generator=g, device=DEVICE)
        value = getattr(model, name) * torch.exp(rel * z - 0.5 * rel ** 2)
        out[name] = value.clamp(lo, hi).to(F32)
    return out


def subset(params, state, k):
    from rrmpg_tpu_torch.models.states import map_state

    return ({n: v[:k].contiguous() for n, v in params.items()},
            map_state(lambda leaf: leaf[:k].contiguous(), state))


def scan_loop_without_sync(model, forcings, obs, obs_std, params, state,
                           seed, cycles, **options):
    """The scan backend with every synchronisation of the host with the
    card inside its window loop an error (``set_sync_debug_mode``): the
    set-up copies to the card and the results come back outside it."""
    from rrmpg_tpu_torch.tools import assimilation as assim

    opts = dict(inflation=1.0, frozen=assim.CONSTANT_FIELDS,
                postprocess=assim.REPAIR_KNOWN, estimate_params=False,
                param_bounds=None, method='enkf', ess_threshold=0.5,
                jitter=0.0, sim_kwargs={'engine': 'fused'})
    opts.update(options)
    run, finish = assim._scan_program(model, forcings, obs, ASSIM_WINDOW,
                                      obs_std, params, state, generator(seed),
                                      cycles, **opts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return finish(out)


def phase_assim(card, qobs, prec, etp, forcing, qsim_matlab):
    """Ensemble data assimilation through ``tools.assimilation_cycle``, float32
    on the card, the launch counts read around every call.  A twin
    experiment: the truth is the calibrated model with noise; the
    forecaster's 131072 members start from its spun-up state dry (stores
    halved) and spread (``perturb_state(rel_std=0.2)``).  The state runs
    share the calibrated parameters (a state-only EnKF over members whose
    parameters differ does worse than the free run: it takes parameter
    error for state error); the joint run draws them around it within the
    class bounds.  The RMSE leaves out the first ASSIM_SPIN_IN cycles, in
    which the filter pulls the dry start in (and its first analysis
    overshoots), as the JAX package's twin tests do.

    GR4J on CAMELS 01031500: the EnKF on both backends, the particle filter
    and the joint parameter EnKF on the scan backend, each 36 warm K4
    launches and closer to the truth than the free run; HBV-Edu on the
    MATLAB days (K14) and the hysteresis + ice model on its Excel sheet
    (K10), the EnKF on the scan backend; ABC's particle filter on the
    sequential engine.  Then 'fused' against 'scan' window steps at 256
    members, the scan loop with every host synchronisation an error, and
    the cycles a second of both backends at 1024 members x 128 windows and
    at 131072 x 36.  K4, K14 and K10 are held to their plain versions on the
    first window."""
    from rrmpg_tpu_torch.models import (ABCModel, CemaneigeHystGR4JIce, GR4J,
                                        HBVEdu)
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs
    from rrmpg_tpu_torch.tools import assimilation_cycle

    launches, max_abs, walls = {}, {}, {}
    tol = TOL[F32]
    n, w, days = ASSIM_MEMBERS, ASSIM_WINDOW, FORECAST_DAYS
    cycles = days // w
    rng = np.random.default_rng(ASSIM_SEED)
    cold = {"gr4j_traj_state": "gr4j_traj_state_cold",
            "hbv_traj_state": "hbv_traj_state_cold",
            "snow_traj_state": "snow_traj_state_cold"}
    warm = {k: v[:-4] + "warm" for k, v in cold.items()}

    def counted(key, fn, expect, modes=warm):
        result, got, seconds = run_counted(fn)
        check(got == expect, f"assim {key}: launch counts {got} differ "
              f"from the expected {expect}")
        walls[key] = seconds
        for k, v in got.items():
            k = modes.get(k, k)
            launches[k] = launches.get(k, 0) + v
        return result

    def keep(key, err):
        max_abs[key] = max(max_abs.get(key, 0.0), err)

    def finite(label, result, n_cycles=cycles):
        state, _, q, diags = result
        check(q.shape == (n_cycles * w, state_leaves(state)[0].shape[0])
              and np.isfinite(q).all(),
              f"assim {label}: qsim of shape {q.shape} is not finite")
        check(all(bool(torch.isfinite(x).all()) for x in state_leaves(state)),
              f"assim {label}: the final state is not finite")
        check(np.isfinite(diags.innovation).all(),
              f"assim {label}: innovations not finite")

    def rmse(q, truth):
        """RMSE of the ensemble mean against the truth over the cycled days
        after the filter's spin-in."""
        mean = (q.mean(axis=1, dtype=np.float64) if isinstance(q, np.ndarray)
                else q.double().mean(dim=1).cpu().numpy())
        days_in = slice(ASSIM_SPIN_IN * w, cycles * w)
        return float(np.sqrt(np.mean((mean[days_in] - truth[days_in]) ** 2)))

    # GR4J on CAMELS 01031500: the twin truth is the calibrated model over
    # the whole record (K3) with noise; the forecaster's ensemble starts
    # from the spun-up state dry and spread.  The state runs share the
    # calibrated parameters; the joint run draws them around it.
    t_len = len(prec)
    split = t_len - days
    params0 = CALIBRATED.get("GR4J", ASSIM_FALLBACK["GR4J"])
    model = GR4J(params=params0)
    tail = dict(prec=prec[split:], etp=etp[split:])
    _, state = counted("GR4J spin-up", lambda: model.simulate(
        prec[:split], etp[:split], return_final_state=True, engine='fused'),
        {"gr4j_traj_state": 1}, cold)
    q_true = counted("GR4J truth", lambda: model.simulate(
        prec, etp, engine='fused'), {"gr4j_traj": 1})[split:, 0]
    truth = q_true.cpu().numpy().astype(np.float64)
    obs = truth + rng.normal(0.0, ASSIM_NOISE, days)
    ens = assim_ensemble(model, state, n, 2)
    members = shared_params(model, n)
    spread = around(model, n, 1, ASSIM_SPREAD)
    free = {}
    for label, params in (("shared", members), ("spread", spread)):
        free[label] = rmse(counted(f"GR4J free run {label}", lambda: (
            model.simulate(**tail, params=params, initial_state=ens,
                           engine='fused')), {"gr4j_traj_state": 1}), truth)
    runs = {}
    for label, backend, params, kw in (
            ("EnKF host", "host", "shared", dict(obs_std=0.05)),
            ("EnKF scan", "scan", "shared", dict(obs_std=0.05)),
            ("PF scan", "scan", "shared", dict(obs_std=0.1, method='pf',
                                               jitter=0.05)),
            ("EnKF params scan", "scan", "spread", dict(
                obs_std=0.05, estimate_params=True,
                param_bounds=GR4J._default_bounds))):
        chosen = members if params == "shared" else spread
        runs[label] = counted(f"GR4J {label}", lambda: assimilation_cycle(
            model, tail, obs, w, params=chosen, initial_state=ens,
            key=generator(3), backend=backend, engine='fused', **kw),
            {"gr4j_traj_state": cycles})
        finite(f"GR4J {label}", runs[label])
        err = rmse(runs[label][2], truth)
        check(err < free[params], f"assim GR4J {label}: ensemble-mean RMSE "
              f"{err} against the truth not below the free run's "
              f"{free[params]}")
        print(f"[5 assim] GR4J {label} {n} x {cycles} cycles of {w} days, "
              f"fused, {params} parameters: ensemble-mean RMSE {err:.4f} "
              f"mm/day against the truth after {ASSIM_SPIN_IN} cycles (free "
              f"run {free[params]:.4f}) in "
              f"{walls[f'GR4J {label}']:.3f} s, "
              f"{cycles / walls[f'GR4J {label}']:.1f} cycles/s; {cycles} K4 "
              f"launches; {card}")
    host, scan = runs["EnKF host"], runs["EnKF scan"]
    for what, a, b in (("qsim", scan[2], host[2]),
                       ("innovation", scan[3].innovation,
                        host[3].innovation),
                       ("posterior mean", scan[3].posterior_mean,
                        host[3].posterior_mean)):
        report(f"assim GR4J EnKF scan vs host backend: {what}",
               torch.from_numpy(a), torch.from_numpy(b), *tol["traj"])
    for a, b in zip(state_leaves(scan[0]), state_leaves(host[0])):
        report("assim GR4J EnKF scan vs host backend: final state leaf",
               a, b, *tol["traj"])
    same = np.array_equal(scan[2], host[2]) and all(
        torch.equal(a, b) for a, b in zip(state_leaves(scan[0]), state_leaves(host[0])))
    print(f"    scan and host backend bit-equal (qsim, final state): {same}")
    pf_ess = runs["PF scan"][3].ess
    print(f"    PF scan: ESS per cycle min {pf_ess.min():.1f} max "
          f"{pf_ess.max():.1f} of {n}")
    p_means = runs["EnKF params scan"][3].param_mean
    print(f"    EnKF params scan: mean x1..x4 first cycle "
          f"{np.round(p_means[0], 3).tolist()}, last "
          f"{np.round(p_means[-1], 3).tolist()}, truth "
          f"{[round(float(params0[k]), 3) for k in GR4J._param_list]}")
    prec_t, etp_t = (as_tensor(a[split:split + w], F32) for a in (prec, etp))
    _, traj, rows = gr4j_state_pair(fg, prec_t, etp_t, spread, ens,
                                    (10, 21))
    keep("gr4j_traj_state_warm", report(
        "assim shape gr4j_traj_state warm (first window) traj", *traj,
        *tol["traj"]))
    keep("gr4j_traj_state_warm", report(
        "assim shape gr4j_traj_state warm (first window) state rows", *rows,
        *tol["traj"]))
    gr4j_case = (model, tail, obs, spread, ens, {})

    # HBV-Edu on the MATLAB days: a twin truth continued from the spin-up.
    hbv = HBVEdu(params=CALIBRATED.get("HBV-Edu", ASSIM_FALLBACK["HBV-Edu"]))
    t_len = len(qsim_matlab)
    split = t_len - days
    const = dict(PE_m=forcing['PE_m'], T_m=forcing['T_m'])

    def hbv_cut(lo, hi):
        return {k: forcing[k][lo:hi] for k in ("temp", "prec", "month")}

    snow0, soil0, s1_0, s2_0 = HBV_INITS
    _, state = counted("HBV-Edu spin-up", lambda: hbv.simulate(
        **hbv_cut(0, split), **const, snow_init=snow0, soil_init=soil0,
        s1_init=s1_0, s2_init=s2_0, return_final_state=True,
        engine='fused'), {"hbv_traj_state": 1}, cold)
    tail = hbv_cut(split, t_len)
    truth = counted("HBV-Edu truth", lambda: hbv.simulate(
        **tail, **const, initial_state=state, engine='fused'),
        {"hbv_traj_state": 1})[:, 0].cpu().numpy().astype(np.float64)
    obs = truth + rng.normal(0.0, ASSIM_NOISE, days)
    members = shared_params(hbv, n)
    ens = assim_ensemble(hbv, state, n, 5)
    q_free = counted("HBV-Edu free run", lambda: hbv.simulate(
        **tail, **const, params=members, initial_state=ens, engine='fused'),
        {"hbv_traj_state": 1})
    result = counted("HBV-Edu EnKF scan", lambda: assimilation_cycle(
        hbv, tail, obs, w, 0.05, params=members, initial_state=ens,
        key=generator(6), backend='scan', engine='fused', **const),
        {"hbv_traj_state": cycles})
    finite("HBV-Edu EnKF scan", result)
    print(f"[5 assim] HBV-Edu EnKF scan {n} x {cycles} cycles of {w} days, "
          f"fused: ensemble-mean RMSE {rmse(result[2], truth):.4f} mm/day "
          f"(free run {rmse(q_free, truth):.4f}) in "
          f"{walls['HBV-Edu EnKF scan']:.3f} s; {cycles} K14 launches; "
          f"{card}")
    tensors = hbv_tensors(forcing, F32)
    window = tuple(x[split:split + w].contiguous() for x in tensors[:3]) + \
        tensors[3:]
    _, traj, rows = hbv_state_pair(fh, window, members, tuple(ens))
    keep("hbv_traj_state_warm", report(
        "assim shape hbv_traj_state warm (first window) traj", *traj,
        *tol["traj"]))
    keep("hbv_traj_state_warm", report(
        "assim shape hbv_traj_state warm (first window) state rows", *rows,
        *tol["traj"]))
    hbv_case = (hbv, tail, obs, members, ens, const)

    # The hysteresis + ice snow model on its Excel sheet, 5 layers.
    met, snow_qobs, _ = snow_main_data()
    setup = dict(met_station_height=700, altitudes=ALTITUDES,
                 frac_ice=FRAC_ICE_GOLDEN)
    snow = CemaneigeHystGR4JIce(params=CALIBRATED.get(
        "snow", ASSIM_FALLBACK["snow"]))
    t_len = len(snow_qobs)
    split = t_len - days

    def snow_cut(lo, hi):
        return {k: v[lo:hi] for k, v in met.items()}

    _, state = counted("snow spin-up", lambda: snow.simulate(
        **snow_cut(0, split), **setup, s_init=0.5, r_init=0.4,
        return_final_state=True, engine='fused'), {"snow_traj_state": 1},
        cold)
    tail = snow_cut(split, t_len)
    truth = counted("snow truth", lambda: snow.simulate(
        **tail, **setup, initial_state=state, engine='fused'),
        {"snow_traj_state": 1})[:, 0].cpu().numpy().astype(np.float64)
    obs = truth + rng.normal(0.0, ASSIM_NOISE, days)
    members = shared_params(snow, n)
    ens = assim_ensemble(snow, state, n, 8)
    q_free = counted("snow free run", lambda: snow.simulate(
        **tail, **setup, params=members, initial_state=ens, engine='fused'),
        {"snow_traj_state": 1})
    result = counted("snow EnKF scan", lambda: assimilation_cycle(
        snow, tail, obs, w, 0.05, params=members, initial_state=ens,
        key=generator(9), backend='scan', engine='fused', **setup),
        {"snow_traj_state": cycles})
    finite("snow EnKF scan", result)
    print(f"[5 assim] CemaneigeHystGR4JIce EnKF scan {n} x {cycles} cycles "
          f"of {w} days x {len(ALTITUDES)} layers, fused: ensemble-mean RMSE "
          f"{rmse(result[2], truth):.4f} mm/day (free run "
          f"{rmse(q_free, truth):.4f}) in {walls['snow EnKF scan']:.3f} s; "
          f"{cycles} K10 launches; {card}")
    f = snow._prepare(*snow_cut(split, split + w).values(), FRAC_ICE_GOLDEN,
                      700, ALTITUDES, 0, 0, 0, 0, 0)
    d = SnowData(f.prec, f.mean_temp, f.frac_solid_prec, f.etp, f.frac_ice,
                 as_tensor(obs[:w], F32))
    _, traj, (got_st, want_st) = snow_state_pair(
        fs, d, members, ens, hyst=True, ice=True, uh=(10, 21))
    keep("snow_traj_state_warm", report(
        "assim shape snow_traj_state warm (first window) traj", *traj,
        *tol["traj"]))
    keep("snow_traj_state_warm", report(
        "assim shape snow_traj_state warm (first window) state rows",
        snow_rows(got_st), snow_rows(want_st), *tol["traj"]))
    snow_case = (snow, tail, obs, members, ens, setup)

    # ABC carries state on the sequential engine only: its particle filter.
    abc = ABCModel(params=ABC_PARAMS)
    split = len(prec) - days
    _, state = counted("ABC spin-up", lambda: abc.simulate(
        prec[:split], initial_state=5.0, return_final_state=True,
        engine='fused'), {"abc_fused_single": 1}, {})
    truth = abc.simulate(prec[split:], initial_state=state)[:, 0]
    truth = truth.cpu().numpy().astype(np.float64)
    obs = truth + rng.normal(0.0, ASSIM_NOISE, days)
    np.random.seed(10)
    abc_members = ABCModel().get_random_params(ASSIM_ABC_MEMBERS)
    ens = assim_ensemble(abc, state, ASSIM_ABC_MEMBERS, 11)
    q_free = abc.simulate(prec[split:], params=abc_members,
                          initial_state=ens)
    result = counted("ABC PF scan", lambda: assimilation_cycle(
        abc, {'prec': prec[split:]}, obs, w, 0.1, params=abc_members,
        initial_state=ens, key=generator(12), backend='scan', method='pf',
        jitter=0.05), {})
    finite("ABC PF scan", result)
    print(f"[5 assim] ABC PF scan {ASSIM_ABC_MEMBERS} x {cycles} cycles of "
          f"{w} days, 'scan' engine: ensemble-mean RMSE "
          f"{rmse(result[2], truth):.4f} (free run {rmse(q_free, truth):.4f})"
          f" in {walls['ABC PF scan']:.3f} s; no kernel launched; {card}")

    # 'fused' against 'scan' window steps, and the scan loop without a
    # synchronisation, at 256 members.
    k, c = ASSIM_CHECK
    for label, (m, tail, obs, members, ens, kw) in (
            ("GR4J", gr4j_case), ("HBV-Edu", hbv_case),
            ("CemaneigeHystGR4JIce", snow_case)):
        sub_params, sub_state = subset(members, ens, k)
        head = {key: v[:c * w] for key, v in tail.items()}
        out = {engine: assimilation_cycle(
            m, head, obs[:c * w], w, 0.05, params=sub_params,
            initial_state=sub_state, key=generator(13), backend='scan',
            engine=engine, **kw) for engine in ('fused', 'scan')}
        report(f"assim {label} {k} x {c} cycles: 'fused' vs 'scan' qsim",
               torch.from_numpy(out['fused'][2]),
               torch.from_numpy(out['scan'][2]), *tol["traj"])
        report(f"assim {label} {k} x {c} cycles: 'fused' vs 'scan' "
               "posterior mean", torch.from_numpy(out['fused'][3]
                                                  .posterior_mean),
               torch.from_numpy(out['scan'][3].posterior_mean), *tol["traj"])
        for a, b in zip(state_leaves(out['fused'][0]),
                        state_leaves(out['scan'][0])):
            report(f"assim {label} {k} x {c} cycles: 'fused' vs 'scan' "
                   "final state leaf", a, b, *tol["traj"])
        configs = [dict()]
        if label == "GR4J":
            configs.append(dict(method='pf', jitter=0.05, ess_threshold=1.0,
                                estimate_params=True,
                                param_bounds=GR4J._default_bounds))
        for options in configs:
            sim = dict(kw, engine='fused')
            result = scan_loop_without_sync(
                m, head, obs[:c * w], 0.05, sub_params, sub_state, 14, c,
                sim_kwargs=sim, **options)
            finite(f"{label} without sync", result, c)
            print(f"    assim {label} scan loop {options.get('method', 'enkf')}"
                  f"{' + params' if options else ''}: {c} cycles with "
                  "torch.cuda.set_sync_debug_mode('error'): no "
                  "synchronisation")

    # Cycles a second of both backends: 1024 members x 128 windows of 10
    # days (benchmarks/assim_cycle.py's shape) and 131072 x 36 (above).
    members_w, windows = ASSIM_WALL_SHAPE
    span = windows * w
    split = len(prec) - span
    _, state = counted("GR4J wall spin-up", lambda: model.simulate(
        prec[:split], etp[:split], return_final_state=True, engine='fused'),
        {"gr4j_traj_state": 1}, cold)
    tail = dict(prec=prec[split:], etp=etp[split:])
    obs = counted("GR4J wall truth", lambda: model.simulate(
        **tail, initial_state=state, engine='fused'),
        {"gr4j_traj_state": 1})[:, 0].cpu().numpy() + rng.normal(
            0.0, ASSIM_NOISE, span)
    members = shared_params(model, members_w)
    ens = assim_ensemble(model, state, members_w, 16)
    rates = {}
    for backend in ("host", "scan"):
        key = f"GR4J EnKF {backend} {members_w} x {windows}"
        counted(key, lambda: assimilation_cycle(
            model, tail, obs, w, 0.05, params=members, initial_state=ens,
            key=generator(17), backend=backend, engine='fused'),
            {"gr4j_traj_state": windows})
        rates[backend] = windows / walls[key]
    big = {b: cycles / walls[f"GR4J EnKF {b}"] for b in ("host", "scan")}
    print(f"[5 assim] cycles/s, GR4J EnKF, engine='fused', float32: "
          f"{members_w} members x {windows} windows of {w}: host "
          f"{rates['host']:.1f}, scan {rates['scan']:.1f} (scan/host "
          f"{rates['scan'] / rates['host']:.2f}); {n} x {cycles}: host "
          f"{big['host']:.1f}, scan {big['scan']:.1f} (scan/host "
          f"{big['scan'] / big['host']:.2f}); {card}")
    total = sum(walls.values())
    print(f"[5 assim] the assimilation path's entry points took {total:.3f} "
          f"s; {card}")
    return launches, max_abs, walls


# The mesh phase: the device mesh (rrmpg_tpu_torch.parallel) through the
# public entry points.
MESH_SHARDS = 4            # shards of cuda:0: each entry of a mesh is one
# Population multipliers whose populations the 4 shards divide (an
# unsharded run of another size has no sharded twin: DE pads to the shards).
MESH_HBV_POPSIZE = 12      # 12 x 11 = 132 members
MESH_SNOW_POPSIZE = 12     # 12 x 9 = 108 members (the main path's 135 is not)
MESH_SCAN = dict(members=4096, days=365)   # the 'scan' engine's cut depth


def phase_mesh(card, qobs, prec, etp, forcing, qsim_matlab):
    """The device mesh through the public entry points: the fused fits of
    GR4J on CAMELS 01031500 (K1 'mse', K2 'kge'), HBV-Edu on the MATLAB
    days (K12) and the hysteresis + ice model on its Excel sheet (K8, also
    ``fit_Q_SCA``: K8's SCA statistics) on ``default_mesh()`` (every
    visible GPU) and on MESH_SHARDS shards of cuda:0, each bit for bit the
    unsharded fit with shards x its launches; the regional GR4J (K5, 8 x
    131072 x 12418) and snow (K11, 8 x 131072 x 1827 x 5) objectives on a
    2 x 2 (ensemble, catchment) mesh of cuda:0, four launches bit for bit
    the one; the 'scan' engine's ``simulate(mesh=)`` and
    ``monte_carlo(mesh=)`` at MESH_SCAN's cut depth; the fused simulate and
    statistics branches raising under a mesh; a single-process
    ``initialize()`` (NCCL, world size 1) and a mesh fit after it equal to
    the one before.  Then every kernel of the phase against its plain
    version at the shapes shard 0 gave it (not counted;
    :func:`mesh_shard_checks`)."""
    import socket

    import torch.distributed as dist

    from rrmpg_tpu_torch import interop
    from rrmpg_tpu_torch.models import GR4J, CemaneigeHystGR4JIce, HBVEdu
    from rrmpg_tpu_torch.parallel import (default_mesh,
                                          ensemble_catchment_mesh,
                                          initialize, regional_gr4j_objective,
                                          regional_snow_objective)
    from rrmpg_tpu_torch.tools import monte_carlo

    launches, max_abs, walls = {}, {}, {}

    def counted(key, fn):
        result, counts, seconds = run_counted(fn)
        walls[key] = seconds
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return result, counts

    meshes = {"every GPU": default_mesh(),
              f"{MESH_SHARDS} x cuda:0": default_mesh(["cuda:0"]
                                                      * MESH_SHARDS)}
    check(meshes["every GPU"].size == torch.cuda.device_count(),
          "default_mesh() does not span every visible GPU")

    # The fused fits: unsharded, then on each mesh.
    snow, soil, s1, s2 = HBV_INITS
    hbv_qobs = qsim_matlab * (24 * 60 * 60) / (HBV_AREA * 1000)
    hbv_qobs[200:215] = np.nan
    hbv_qobs[::97] = np.nan
    met, snow_qobs, ndsi = snow_main_data()
    snow_args = (snow_qobs, *met.values(), FRAC_ICE_GOLDEN)
    snow_kw = dict(engine='fused', seed=0, maxiter=SNOW_FIT_MAXITER,
                   popsize=MESH_SNOW_POPSIZE, met_station_height=700,
                   altitudes=ALTITUDES, s_init=0.5, r_init=0.4)
    fits = [
        ("GR4J mse", GR4J, "fit", (qobs, prec, etp),
         dict(engine='fused', seed=0, maxiter=30), "gr4j_mse"),
        ("GR4J kge", GR4J, "fit", (qobs, prec, etp),
         dict(engine='fused', seed=0, maxiter=30, loss_metric='kge'),
         "gr4j_stats"),
        ("HBV-Edu mse", HBVEdu, "fit", (hbv_qobs,),
         dict(**forcing, snow_init=snow, soil_init=soil, s1_init=s1,
              s2_init=s2, engine='fused', seed=0, maxiter=30,
              popsize=MESH_HBV_POPSIZE), "hbv_mse"),
        ("hyst+ice mse", CemaneigeHystGR4JIce, "fit", snow_args, snow_kw,
         "snow_mse"),
        ("hyst+ice Q+SCA kge", CemaneigeHystGR4JIce, "fit_Q_SCA",
         (*snow_args, *ndsi), dict(snow_kw, loss_metric='kge'),
         "snow_sca_stats"),
    ]
    results = {}
    for label, cls, method, args, kw, kernel in fits:
        plain, n_plain = counted(f"{label}", lambda: getattr(cls(), method)(
            *args, **kw))
        check(set(n_plain) == {kernel}, f"mesh phase, {label}: unsharded "
              f"launches {n_plain}, expected {kernel} only")
        results[label] = plain
        line = []
        for name, mesh in meshes.items():
            sharded, n_mesh = counted(f"{label} on {name}", lambda: getattr(
                cls(), method)(*args, mesh=mesh, **kw))
            expect = {kernel: mesh.size * n_plain[kernel]}
            check(n_mesh == expect, f"mesh phase, {label} on {name}: "
                  f"launches {n_mesh}, expected {expect}")
            check(np.array_equal(sharded.population, plain.population)
                  and np.array_equal(sharded.population_energies,
                                     plain.population_energies)
                  and sharded.nit == plain.nit,
                  f"mesh phase, {label} on {name}: not bit-equal to the "
                  "unsharded fit")
            line.append(f"{name} ({mesh.size} shards) "
                        f"{walls[f'{label} on {name}']:.3f} s, {n_mesh}")
        print(f"[5 mesh] {label} fit, {len(plain.population)} members, "
              f"nit={plain.nit}: unsharded {walls[label]:.3f} s, {n_plain}; "
              + "; ".join(line) + f"; bit-equal; {card}")

    # The regional sweeps on a 2 x 2 (ensemble, catchment) mesh of cuda:0.
    mesh2 = ensemble_catchment_mesh(2, 2, devices=["cuda:0"] * MESH_SHARDS)
    rng = np.random.default_rng(0)
    c, t_len = REGION_BASINS, len(prec)
    qobs_ct = np.tile(qobs, (c, 1))
    qobs_ct[0, t_len // 2:] = np.nan
    qobs_ct[1, rng.random(t_len) < 0.1] = np.nan
    gr4j_in = interop.regional_forcing_from_numpy(
        np.stack([prec * rng.uniform(0.8, 1.2) for _ in range(c)]),
        np.stack([etp * rng.uniform(0.9, 1.1) for _ in range(c)]), qobs_ct,
        device=DEVICE)
    np.random.seed(4)
    gr4j_params = interop.params_from_numpy(
        GR4J().get_random_params(MC_MEMBERS), device=DEVICE)
    snow_np = region_snow_arrays()
    etp_s, qobs_s, prec_s, temp_s, frac_s, frac_ice = (
        interop.regional_forcing_from_numpy(
            snow_np["etp"], snow_np["qobs"],
            layers=(snow_np["prec"], snow_np["temp"], snow_np["frac"]),
            frac_ice=snow_np["frac_ice"], device=DEVICE))
    snow_params = interop.params_from_numpy(
        CemaneigeHystGR4JIce().get_random_params(MC_MEMBERS), device=DEVICE)
    sweeps = {
        "gr4j_regional": lambda loss, mesh: regional_gr4j_objective(
            *gr4j_in, 0.3, 0.3, gr4j_params, loss_metric=loss, mesh=mesh),
        "snow_regional": lambda loss, mesh: regional_snow_objective(
            prec_s, temp_s, etp_s, frac_s, qobs_s, 0.0, 0.0, 0.5, 0.4,
            snow_params, frac_ice=frac_ice, hyst=True, ice=True,
            loss_metric=loss, mesh=mesh)}
    for kernel, sweep in sweeps.items():
        for loss in ("mse", "kge"):
            key = f"{kernel} {loss}"
            want, n_plain = counted(key, lambda: sweep(loss, None))
            got, n_mesh = counted(f"{key} on 2 x 2",
                                  lambda: sweep(loss, mesh2))
            check(n_plain == {kernel: 1} and n_mesh == {kernel: 4},
                  f"mesh phase, {key}: launches {n_plain} unsharded, "
                  f"{n_mesh} on the 2 x 2 mesh; expected 1 and 4")
            check(got.shape == want.shape == (c, MC_MEMBERS),
                  f"mesh phase, {key}: shape {tuple(got.shape)}")
            equal = torch.equal(got, want)
            if not equal:
                err = report(f"mesh phase, {key} on 2 x 2 against "
                             "unsharded (each member's own arithmetic, "
                             "expected bit for bit)", got, want,
                             *TOL[F32]["obj"])
            print(f"[5 mesh] {key}, {c} x {MC_MEMBERS}: unsharded "
                  f"{walls[key]:.3f} s, 2 x 2 mesh of cuda:0 "
                  f"{walls[key + ' on 2 x 2']:.3f} s, launches {n_plain} / "
                  f"{n_mesh}, " + ("bit-equal" if equal else
                                   f"max |diff| {err:.3g}") + f"; {card}")

    # The 'scan' engine on a mesh, and what raises under one.
    days = slice(len(prec) - MESH_SCAN["days"], None)
    np.random.seed(7)
    members = GR4J().get_random_params(MESH_SCAN["members"])
    scan_plain = GR4J().simulate(prec[days], etp[days], params=members)
    np.random.seed(8)
    mc_plain = monte_carlo(GR4J(), MESH_SCAN["members"], qobs[days],
                           metrics=('nse',), prec=prec[days], etp=etp[days])
    for name, mesh in meshes.items():
        got, _ = counted(f"scan simulate on {name}", lambda: GR4J().simulate(
            prec[days], etp[days], params=members, mesh=mesh))
        np.random.seed(8)
        mc, _ = counted(f"scan monte_carlo on {name}", lambda: monte_carlo(
            GR4J(), MESH_SCAN["members"], qobs[days], mesh,
            metrics=('nse',), prec=prec[days], etp=etp[days]))
        check(torch.equal(got, scan_plain)
              and np.array_equal(mc['qsim'], mc_plain['qsim'])
              and np.array_equal(mc['nse'], mc_plain['nse'], equal_nan=True),
              f"mesh phase, 'scan' simulate / monte_carlo on {name}: not "
              "bit-equal to the unsharded run")
        for what, call in (
                ("fused simulate", lambda: GR4J().simulate(
                    prec, etp, engine='fused', mesh=mesh)),
                ("fused statistics", lambda: monte_carlo(
                    GR4J(), 8, qobs, mesh, return_qsim=False,
                    engine='fused', prec=prec, etp=etp))):
            try:
                call()
            except ValueError:
                continue
            raise SmokeFailure(f"mesh phase: the {what} on {name} did not "
                               "raise ValueError")
    print(f"[5 mesh] 'scan' simulate and monte_carlo, "
          f"{MESH_SCAN['members']} members x {MESH_SCAN['days']} days: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()
                      if k.startswith("scan")) + "; bit-equal to unsharded; "
          f"fused simulate and statistics raise ValueError; {card}")

    # One process, NCCL: initialize() and a mesh fit equal to the one
    # before.
    label, cls, method, args, kw, kernel = fits[0]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    rank, world, count = initialize(f"localhost:{port}", num_processes=1)
    try:
        check((rank, world) == (0, 1) and dist.get_backend() == "nccl",
              f"initialize(): rank {rank}, world {world}, backend "
              f"{dist.get_backend()}")
        after, n_after = counted("fit after initialize", lambda: getattr(
            cls(), method)(*args, mesh=default_mesh(), **kw))
    finally:
        dist.destroy_process_group()
    check(np.array_equal(after.population_energies,
                         results[label].population_energies),
          "mesh phase: the fit after initialize() differs from the one "
          "before")
    print(f"[5 mesh] initialize(): NCCL, rank {rank} of {world}, {count} "
          f"device(s); {label} fit on default_mesh() after it "
          f"{walls['fit after initialize']:.3f} s, {n_after}, bit-equal to "
          f"the one before; {card}")

    # Every kernel of the phase against its plain version on the inputs of
    # shard 0 (not counted): the fits' kernels on the first 1/MESH_SHARDS
    # of each final population at the fit's forcing, the regional kernels
    # on the 2 x 2 mesh's first (catchment, member) block, whole.
    max_abs.update(mesh_shard_checks(results, qobs, prec, etp, forcing,
                                     hbv_qobs, met, snow_qobs, ndsi, gr4j_in,
                                     gr4j_params, (prec_s, temp_s, etp_s,
                                                   frac_s, qobs_s, frac_ice),
                                     snow_params))
    print(f"[5 mesh] the mesh phase's entry points took "
          f"{sum(walls.values()):.3f} s; {card}")
    return launches, max_abs, walls


def mesh_shard_checks(results, qobs, prec, etp, forcing, hbv_qobs, met,
                      snow_qobs, ndsi, gr4j_in, gr4j_params, snow_in,
                      snow_params):
    """K1, K2, K12, K8 ('mse' and SCA statistics), K5 and K11 against their
    plain versions at the shapes one shard of the mesh phase gave them;
    returns the max abs error of each kernel."""
    from rrmpg_tpu_torch.models import CemaneigeHystGR4JIce, GR4J, HBVEdu
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    def shard(cls, label):
        res = results[label]
        share = len(res.population) // MESH_SHARDS
        return {k: v[:share].contiguous()
                for k, v in population_params(cls, res).items()}, share

    max_abs = {}

    def keep(kernel, err):
        max_abs[kernel] = max(max_abs.get(kernel, 0.0), err)

    prec_t, etp_t, qobs_t = (as_tensor(a, F32) for a in (prec, etp, qobs))
    masked = bool(np.isnan(qobs).any())
    count = int(np.isfinite(qobs).sum())
    for kernel, label, stats in (("gr4j_mse", "GR4J mse", False),
                                 ("gr4j_stats", "GR4J kge", True)):
        params, share = shard(GR4J, label)
        got = fg.gr4j_ensemble_mse_fused(prec_t, etp_t, qobs_t, 0.0, 0.0,
                                         params, 3, 7, stats=stats,
                                         masked=masked)
        want = fg.gr4j_objective_reference(
            prec_t, etp_t, qobs_t, fg.pack_params(params, 0.0, 0.0), 3, 7,
            stats, masked, count)
        keep(kernel, report(f"mesh shard shape {kernel} ({share} x "
                            f"{len(prec)})", got, want, *TOL[F32]["obj"]))

    params, share = shard(HBVEdu, "HBV-Edu mse")
    tensors = hbv_tensors(forcing, F32)
    args = (fh, tensors, as_tensor(hbv_qobs, F32), params, "mse", True)
    keep("hbv_mse", report(
        f"mesh shard shape hbv_mse ({share} x {len(hbv_qobs)})",
        hbv_kernel(*args), hbv_plain(*args), *TOL[F32]["obj"], nan_ok=True))

    model_cls = CemaneigeHystGR4JIce
    f = model_cls()._prepare(*met.values(), FRAC_ICE_GOLDEN, 700, ALTITUDES,
                             0, 0, 0, 0.5, 0.4)
    d = SnowData(f.prec, f.mean_temp, f.frac_solid_prec, f.etp, f.frac_ice,
                 as_tensor(snow_qobs, F32), as_tensor(np.stack(ndsi), F32))
    kw = dict(hyst=True, ice=True, uh=(10, 21), masked=True,
              inits=(0.0, 0.0, 0.5, 0.4))
    for kernel, label, mode in (("snow_mse", "hyst+ice mse", "mse"),
                                ("snow_sca_stats", "hyst+ice Q+SCA kge",
                                 "sca_stats")):
        params, share = shard(model_cls, label)
        keep(kernel, report(
            f"mesh shard shape {kernel} ({share} x {len(snow_qobs)} x "
            f"{len(ALTITUDES)})", snow_call(fs, d, params, mode, **kw),
            snow_call(fs, d, params, mode, plain=True, **kw),
            *TOL[F32]["obj"]))

    # The 2 x 2 (ensemble, catchment) mesh's shard 0: the first half of the
    # catchments and of the members.
    c, n = REGION_BASINS // 2, MC_MEMBERS // 2
    prec_c, etp_c, qobs_c = (x[:c].contiguous() for x in gr4j_in)
    sub = {k: v[:n].contiguous() for k, v in gr4j_params.items()}
    masked = bool(torch.isnan(qobs_c).any())
    want = regional_gr4j_plain(fg, prec_c, etp_c, qobs_c, sub, (10, 21),
                               masked, (0.3, 0.3))
    for stats in (False, True):
        got = fg.gr4j_regional_objective_fused(prec_c, etp_c, qobs_c, 0.3,
                                               0.3, sub, stats=stats,
                                               masked=masked)
        keep("gr4j_regional", report(
            f"mesh shard shape gr4j_regional ({'stats' if stats else 'mse'}"
            f", {c} catchments x {n} members x {prec_c.shape[1]})", got,
            want if stats else want[0], *TOL[F32]["obj"]))
    d = {k: x[:c].contiguous() for k, x in zip(
        ("prec", "temp", "etp", "frac", "qobs", "frac_ice"), snow_in)}
    sub = {k: v[:n].contiguous() for k, v in snow_params.items()}
    kw = dict(hyst=True, ice=True, uh=(10, 21),
              masked=bool(torch.isnan(d["qobs"]).any()),
              inits=(0.0, 0.0, 0.5, 0.4))
    want = regional_snow_call(fs, d, sub, plain=True, **kw)
    for stats in (False, True):
        keep("snow_regional", report(
            f"mesh shard shape snow_regional ({'stats' if stats else 'mse'}"
            f", {c} catchments x {n} members x {d['prec'].shape[1]} x "
            f"{d['prec'].shape[2]})",
            regional_snow_call(fs, d, sub, stats=stats, **kw),
            want if stats else want[0], *TOL[F32]["obj"]))
    return max_abs


EXAMPLES_DIR = REPO / "examples" / "torch"
# Each port example -> the launch counters (ops._launch.LAUNCHES) its run on
# the card must raise above 0: the kernels its study goes through.
EXAMPLE_KERNELS = {
    "01_model_api": ("snow_stats", "snow_mse", "snow_traj"),
    "02_speed_comparison": ("abc_fused_single", "abc_fused"),
    "03_hysteresis_icemelt": ("snow_sca_stats", "snow_mse", "snow_traj"),
    "04_large_scale_ensembles": ("gr4j_mse",),
    "05_uncertainty_regional": ("snow_traj", "gr4j_regional"),
    "06_forecast_mode": ("gr4j_traj", "gr4j_traj_state", "snow_traj_state",
                         "gr4j_mse"),
    "07_sensitivity": ("gr4j_mse",),
    "08_assimilation": ("gr4j_traj", "gr4j_traj_state"),
    "09_pareto_front": ("snow_sca_stats", "snow_traj"),
    "10_bayesian_inference": ("gr4j_mse",),
}
# The wrappers that launch the kernels, by module of rrmpg_tpu_torch.ops.
LAUNCHING_WRAPPERS = {
    "fused_abc": ("abc_fused_single", "abc_fused"),
    "fused_gr4j": ("gr4j_simulate_fused", "gr4j_simulate_state_fused",
                   "gr4j_ensemble_mse_fused",
                   "gr4j_regional_objective_fused"),
    "fused_hbv": ("hbv_simulate_fused", "hbv_simulate_state_fused",
                  "hbv_ensemble_mse_fused"),
    "fused_snow": ("snowgr4j_simulate_fused",
                   "snowgr4j_simulate_state_fused",
                   "snowgr4j_ensemble_mse_fused",
                   "snowgr4j_regional_mse_fused", "cemaneige_simulate_fused",
                   "cemaneige_ensemble_mse_fused"),
}


def launch_key(counter, warm):
    """The key of the ``kernels`` line under which a launch counted as
    ``counter`` is kept: the key of its mode in KERNEL_MODES (the warm mode
    where the wrapper was given a state), else the counter itself."""
    for name, modes in KERNEL_MODES.items():
        keys = {mode: key for mode, (_, key) in modes.items()}
        if counter == name or counter in keys.values():
            return keys["warm"] if warm else keys.get("cold", counter)
    return counter


def tree_map(fn, x):
    """``x`` with ``fn`` applied to each tensor in its tuples, named
    tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def tree_leaves(x):
    """The tensors of ``x`` (as :func:`tree_map` walks it), in order."""
    leaves = []
    tree_map(leaves.append, x)
    return leaves


def call_shape(args, kwargs):
    """What sets a wrapper call's shape: the shape and dtype of each input
    tensor and each flag or count (not the float initial stores)."""
    shape = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            shape.append((tuple(x.shape), str(x.dtype)))
        elif isinstance(x, dict):
            for k, v in x.items():
                shape.append(k)
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif not isinstance(x, float):
            shape.append(x)

    walk((args, sorted(kwargs.items())))
    return tuple(shape)


class WrapperCalls:
    """Stands in for every launching wrapper (LAUNCHING_WRAPPERS) under
    each name the loaded modules of rrmpg_tpu_torch give it, while
    installed.  An outermost wrapper call adds its launches to ``counted``
    (by launch counter) and ``launches`` (by :func:`launch_key`), and the
    first call at each shape is kept, its inputs copied before the call,
    in ``calls``: {(launch key, wrapper, shape): (wrapper, args, kwargs)}.
    A wrapper reached under a name it does not replace would launch
    without adding to ``counted``."""

    def __init__(self):
        from rrmpg_tpu_torch import ops

        self.spies = {}
        for module, names in LAUNCHING_WRAPPERS.items():
            for name in names:
                fn = getattr(getattr(ops, module), name)
                self.spies[fn] = self._spy(fn, inspect.signature(fn))
        self.depth = 0
        self.counted, self.launches, self.calls = {}, {}, {}
        self.example = None

    def _spy(self, fn, signature):
        from rrmpg_tpu_torch.ops import LAUNCHES

        @functools.wraps(fn)
        def spy(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            shape = (fn.__name__, call_shape(args, kwargs))
            seen = any(k[0] == self.example and k[2:] == shape
                       for k in self.calls)
            kept = None if seen else tree_map(torch.clone, (args, kwargs))
            before = dict(LAUNCHES)
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            warm = signature.bind(*args, **kwargs).arguments.get(
                "state") is not None
            for counter, count in LAUNCHES.items():
                added = count - before[counter]
                if not added:
                    continue
                key = launch_key(counter, warm)
                self.counted[counter] = self.counted.get(counter, 0) + added
                self.launches[key] = self.launches.get(key, 0) + added
                if kept is not None:
                    self.calls.setdefault((self.example, key, *shape),
                                          (fn, *kept))
            return out
        return spy

    @staticmethod
    def _swap(table):
        """Replace every function of ``table``'s keys by its value under
        each name a loaded module of rrmpg_tpu_torch gives it."""
        for module in [m for n, m in list(sys.modules.items())
                       if n.startswith("rrmpg_tpu_torch") and m is not None]:
            for name, value in list(vars(module).items()):
                if inspect.isfunction(value) and value in table:
                    setattr(module, name, table[value])

    def install(self):
        self._swap(self.spies)

    def uninstall(self):
        self._swap({spy: fn for fn, spy in self.spies.items()})

    def reset(self, example):
        self.example = example
        self.counted, self.launches = {}, {}


def check_example_result(stem, result):
    """Hold what an example prints as a check: 02's K6 against the 'scan'
    engine's Toeplitz products at K6's own float32 tolerance
    (ABC_RTOL_OF_MAX_F32 of the largest discharge) and its K7 ensemble
    finite, 06's chained,
    day-by-day, class and snow forecasts equal to their unbroken runs
    (max |dq| <= 1e-6), 08's scan backend equal to its host backend."""
    check(isinstance(result, dict), f"example {stem} returned {result!r}")
    if stem == "02_speed_comparison":
        limit = ABC_RTOL_OF_MAX_F32 * result["q_max"]
        check(result["max_dq"] <= limit, f"example {stem}: K6 and the "
              f"Toeplitz scan differ by {result['max_dq']:.3e} > {limit:.3e}")
        check(result["ensemble_finite"], f"example {stem}: K7's ensemble "
              "is not finite")
    elif stem == "06_forecast_mode":
        for key in ("chained_max_dq", "daily_max_dq", "class_max_dq",
                    "snow_max_dq"):
            check(result[key] <= 1e-6, f"example {stem}: {key} "
                  f"{result[key]:.3e} > 1e-6")
    elif stem == "08_assimilation":
        check(result["backends_max_dq"] == 0.0, f"example {stem}: the scan "
              f"and host backends differ by {result['backends_max_dq']:.3e}")
    print(f"[5 examples] {stem}: its own checks held")


def examples_shape_checks(calls):
    """Each kernel the examples launched, at each shape an example gave
    it (the first such call, its inputs as given), against its plain
    version: the same wrapper on the same inputs moved to the CPU, where
    it runs its plain version.  An output may be NaN where the plain
    version's is (DE-MC proposes members outside the bounds), and nowhere
    else.  Returns the max abs error by launch key and the seconds taken."""
    t0 = time.perf_counter()
    max_abs = {}
    for (example, key, name, _), (fn, args, kwargs) in calls.items():
        got = tree_leaves(fn(*args, **kwargs))
        want = tree_leaves(fn(*tree_map(lambda x: x.cpu(), args),
                              **tree_map(lambda x: x.cpu(), kwargs)))
        check(len(got) == len(want), f"{name}: {len(got)} outputs on the "
              f"card, {len(want)} in its plain version")
        dims = "; ".join("x".join(map(str, a.shape))
                         for a in tree_leaves((args, kwargs)) if a.dim())
        for i, (g, w) in enumerate(zip(got, want)):
            if not g.is_floating_point():
                check(torch.equal(g.cpu(), w), f"{name} output {i} differs")
                continue
            w = w.to(g.device)
            if "abc" in key:
                tol = abc_tol(w)
            else:
                tol = TOL[w.dtype]["traj" if "traj" in key else "obj"]
            err = report(f"example shape {key} ({example}: {name}, output "
                         f"{i}, inputs {dims})", g, w, *tol, nan_ok=True)
            max_abs[key] = max(max_abs.get(key, 0.0), err)
    return max_abs, time.perf_counter() - t0


def phase_examples(card):
    """The ten port examples (``examples/torch``), in this process on the
    card at ``RRMPG_EXAMPLE_FAST=1``: each loaded with ``runpy`` (not as
    ``__main__``) and its ``main(['--device', 'cuda'])`` called, with the
    launch counts set to 0 just before and read just after: each must go
    through the kernels EXAMPLE_KERNELS names, and what it returns must pass
    :func:`check_example_result`.  WrapperCalls stands in for the wrappers
    meanwhile, and every kernel launched is then held against its plain
    version at each shape an example gave it (:func:`examples_shape_checks`).
    Nothing is caught: an example that raises fails the run.

    Returns the launches by key of the ``kernels`` line (``examples/<key>``,
    a state kernel's or objective's warm launches under its warm mode), the
    max abs errors of the shape checks and the walls."""
    import runpy

    paths = sorted(EXAMPLES_DIR.glob("[0-9]*.py"))
    check([p.stem for p in paths] == list(EXAMPLE_KERNELS),
          f"examples/torch holds {[p.name for p in paths]}")
    launches, walls = {}, {}
    saved_fast = os.environ.get("RRMPG_EXAMPLE_FAST")
    os.environ["RRMPG_EXAMPLE_FAST"] = "1"
    spy = WrapperCalls()
    spy.install()
    try:
        for path in paths:
            print(f"[5 examples] {path.stem} ...", flush=True)
            spy.reset(path.stem)
            example = runpy.run_path(str(path), run_name="example")
            result, got, seconds = run_counted(
                lambda: example["main"](["--device", DEVICE]))
            missing = [k for k in EXAMPLE_KERNELS[path.stem]
                       if not got.get(k)]
            check(not missing, f"example {path.stem} launched no "
                  f"{missing}; its launches: {got}")
            check(spy.counted == got, f"example {path.stem} launched "
                  f"{got}, of which its wrapper calls account for "
                  f"{spy.counted}")
            check_example_result(path.stem, result)
            for key, count in spy.launches.items():
                launches["examples/" + key] = (
                    launches.get("examples/" + key, 0) + count)
            walls[path.stem] = seconds
            print(f"[5 examples] {path.stem}: {seconds:.2f} s, launches "
                  f"{spy.launches}; {card}")
    finally:
        spy.uninstall()
        if saved_fast is None:
            os.environ.pop("RRMPG_EXAMPLE_FAST")
        else:
            os.environ["RRMPG_EXAMPLE_FAST"] = saved_fast
    print(f"[5 examples] the ten examples in {sum(walls.values()):.2f} s, "
          f"launches {launches}; {card}")
    max_abs, seconds = examples_shape_checks(spy.calls)
    walls["shape checks"] = seconds
    print(f"[5 examples] {len(spy.calls)} kernel-vs-plain checks at the "
          f"examples' shapes in {seconds:.2f} s; {card}")
    return launches, max_abs, walls


# The JAX package's last surfaces (phase ``surface``): the depths of its
# runs.
SURFACE_DE = (10, 30)            # generations before the break, and in all
SURFACE_SCE_DAYS = 365           # SCE on a mesh: the record's last days
SURFACE_SCE_MAXITER = 1
SURFACE_SMALL_C = 7e-5           # the smallest c of PERF.md's section 2


def surface_abc(card, prec_basin):
    """(a) of :func:`phase_surface`: ``linear_recurrence`` and
    ``run_abcmodel_matscan`` (the 'scan' engine's Toeplitz products) at 10M
    steps in float32 and float64 and at the Monte-Carlo's 4096 x 12418 with
    a member at c = 7e-5, against K6 and K7 (the errors kept as theirs,
    the small-c member's aside; at the Monte-Carlo shape each member within
    ABC's tolerance of its own largest value), and against the float64
    doubling scan (float64 at 10M, the float32 Monte-Carlo shape member by
    member); every float32 run twice, under
    'highest' and under 'high' float32 matmul precision, bit for bit; CUDA
    event times beside K6's and K7's.  The kernels' launches here compare
    and are not counted.  Returns the max abs errors by kernel and the
    times."""
    from rrmpg_tpu_torch.ops import abc, fused_abc as fa, linear_recurrence

    max_abs, times = {}, {}

    def recurrence(prec, s0, params):
        return linear_recurrence(1.0 - params['c'],
                                 params['a'][..., None] * prec[1:], s0)

    def both(prec, s0, params):
        return (*abc.run_abcmodel_matscan(prec, s0, params),
                recurrence(prec, s0, params))

    def under_both_precisions(label, fn):
        """``fn()`` under 'highest', then under 'high' float32 matmul
        precision, which must give the same bits (TF32 stays out)."""
        torch.set_float32_matmul_precision("highest")
        highest = fn()
        torch.set_float32_matmul_precision("high")
        high = fn()
        torch.cuda.synchronize()
        torch.set_float32_matmul_precision("highest")
        check(all(torch.equal(a, b) for a, b in zip(highest, high)),
              f"{label}: 'high' float32 matmul precision changed the result")
        return highest

    def compare(label, q, s, s_tail, kernels):
        """Each kernel's (q, S) against matscan's, and its S after step 0
        against ``linear_recurrence``'s: one series."""
        for name, (kq, ks) in kernels.items():
            for series, g, w in (("q", kq, q), ("S", ks, s)):
                max_abs[name] = max(max_abs.get(name, 0.0), report(
                    f"surface {label} {name} vs matscan {series}", g, w,
                    *abc_tol(w)))
            report(f"surface {label} {name} vs linear_recurrence S",
                   ks[..., 1:], s_tail, *abc_tol(s_tail))

    def compare_members(label, q, s, s_tail, kernels, small):
        """As :func:`compare` on (N, T) float32 series, each member held
        within ABC_RTOL_OF_MAX_F32 of its own largest value.  The member
        ``small`` (c = 7e-5, storages ~1e4) is held alone against matscan
        and its errors are not the kernels' ``max_abs_err``; against
        ``linear_recurrence`` (JAX's rounded ``1 - c``) it is left out."""
        others = torch.arange(q.shape[0], device=DEVICE) != small
        for name, (kq, ks) in kernels.items():
            for series, g, w in (("q", kq, q), ("S", ks, s)):
                max_abs[name] = max(max_abs.get(name, 0.0), report_members(
                    f"surface {label} {name} vs matscan {series}", g[others],
                    w[others]))
                report_members(f"surface {label} member {small} {name} vs "
                               f"matscan {series}", g[small:small + 1],
                               w[small:small + 1])
            report_members(f"surface {label} {name} vs linear_recurrence S",
                           ks[others, 1:], s_tail[others])

    prec_np = np.random.default_rng(0).uniform(0, 20, ABC_STEPS)
    for dtype, suffix in ((F32, ""), (F64, "_f64")):
        prec = as_tensor(prec_np, dtype)
        member = {k: as_tensor(v, dtype) for k, v in ABC_PARAMS.items()}
        s0 = as_tensor(0.0, dtype)
        label = f"T={ABC_STEPS} {str(dtype)[6:]}"
        q, s, s_tail = under_both_precisions(
            label, lambda: both(prec, s0, member))
        compare(label, q, s, s_tail, {
            "abc_fused_single": fa.abc_fused_single(prec, s0, member),
            "abc_fused": fa.abc_fused(prec, s0, member)})
        if dtype == F64:
            for series, g, w in zip(("q", "S"), (q, s),
                                    abc.run_abcmodel_pscan(prec, s0,
                                                           member)):
                report(f"surface {label} matscan vs pscan {series}", g, w,
                       *abc_tol(w))
        for key, fn, reps in (
                ("matscan", lambda: abc.run_abcmodel_matscan(
                    prec, s0, member), 10),
                ("linear_recurrence", lambda: recurrence(prec, s0, member),
                 10),
                ("K6", lambda: fa.abc_fused_single(prec, s0, member), 20),
                ("K7", lambda: fa.abc_fused(prec, s0, member), 20)):
            times[key + suffix] = device_ms(fn, reps)
        del q, s, s_tail

    basin = as_tensor(prec_basin, F32)
    params, s0 = abc_members(np.random.default_rng(3), ABC_MC_MEMBERS, F32)
    params['c'][3] = SURFACE_SMALL_C
    label = f"Monte-Carlo {ABC_MC_MEMBERS} x {basin.shape[0]}"
    q, s, s_tail = under_both_precisions(label,
                                         lambda: both(basin, s0, params))
    # linear_recurrence takes JAX's coefficient, a rounded 1 - c: at c =
    # 7e-5 over these 12418 steps it drifts 1.2e-4 of the member's largest
    # storage (the CPU in float32), past ABC's tolerance, which is why
    # the 'scan' engine builds its powers from c.  It is held on the other
    # members, and that member's drift is printed and held below 1e-3.
    compare_members(label, q, s, s_tail, {
        "abc_fused_single": fa.abc_fused_single(basin, s0, params),
        "abc_fused": fa.abc_fused(basin, s0, params)}, 3)
    ref = abc.run_abcmodel_pscan(basin.double(), s0.double(),
                                 {k: v.double() for k, v in params.items()})
    drift = float((s_tail[3].double() - ref[1][3, 1:]).abs().max()
                  / ref[1][3].abs().max())
    print(f"    surface {label} member 3 (c={SURFACE_SMALL_C:g}) "
          f"linear_recurrence (a rounded 1 - c, JAX's form) vs float64 "
          f"pscan: max |err| / max = {drift:.3e}")
    check(drift < 1e-3, f"linear_recurrence at c={SURFACE_SMALL_C:g} "
          f"drifts {drift:.3e} of the storage's largest value")
    # Member by member within 1e-4 of the member's own largest value (the
    # member at c = 7e-5 holds storages ~1e4): c = 0, 0.12, 1, 7e-5, then
    # a random one.
    for k in range(5):
        for series, g, w in zip(("q", "S"), (q, s), ref):
            report(f"surface {label} member {k} (c="
                   f"{float(params['c'][k]):g}) float32 matscan vs float64 "
                   f"pscan {series}", g[k], w[k], *abc_tol(w[k].float()))
    del q, s, s_tail, ref
    for key, fn, reps in (
            ("matscan_mc", lambda: abc.run_abcmodel_matscan(
                basin, s0, params), 10),
            ("K6_mc", lambda: fa.abc_fused_single(basin, s0, params), 20),
            ("K7_mc", lambda: fa.abc_fused(basin, s0, params), 20)):
        times[key] = device_ms(fn, reps)
    print("[5 surface] ABC device ms (CUDA events; matscan = the 'scan' "
          "engine's Toeplitz products, not a library call): " + ", ".join(
              f"{k} {v:.4f}" for k, v in times.items()) + f"; {card}")
    return max_abs, times


def same_run(a, b):
    """Two OptimizeResults equal bit for bit."""
    return (a.nit == b.nit and a.nfev == b.nfev and a.fun == b.fun
            and np.array_equal(a.x, b.x)
            and np.array_equal(a.population, b.population)
            and np.array_equal(a.population_energies, b.population_energies))


def phase_surface(card, qobs, prec, etp):
    """The JAX package's last surfaces through the public entry points,
    each check failing the run: (a) :func:`surface_abc`, then
    ``ABCModel(params).simulate(<10M steps>, engine='scan')`` against K6,
    and ``ABCModel().fit`` on CAMELS 01031500, both on the Toeplitz scan
    and launching no kernel; (b) a fused GR4J fit on CAMELS 01031500 (K1)
    checkpointed to a directory (``torch.distributed.checkpoint``) every
    DE_CHECKPOINT_EVERY generations, broken off at 10 and resumed to 30,
    bit for bit the unbroken 30, unsharded and on MESH_SHARDS shards of
    cuda:0 (shards x the launches, bit for bit the unsharded fit); (c) GR4J
    ``fit(method='sce', engine='scan', mesh=)`` on the record's last
    SURFACE_SCE_DAYS days on ``default_mesh()`` and on MESH_SHARDS shards
    of cuda:0, bit for bit the unsharded SCE fit and launching no kernel,
    and ``engine='fused'`` raising ``ValueError`` as JAX's does; (d) after
    ``config.enable_x64()`` a fused GR4J ``simulate`` with no ``dtype`` (K3
    in float64) bit for bit the one with ``dtype=torch.float64`` and held
    against the 'scan' engine, and float32 the default again after
    ``enable_x64(False)``."""
    from rrmpg_tpu_torch import config
    from rrmpg_tpu_torch.models import ABCModel, GR4J
    from rrmpg_tpu_torch.ops import fused_abc as fa
    from rrmpg_tpu_torch.parallel import default_mesh, pad_to_multiple

    launches, walls = {}, {}

    def counted(key, fn):
        result, counts, seconds = run_counted(fn)
        walls[key] = seconds
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return result, counts

    # (a) ABC's 'scan' engine on the Toeplitz products.
    max_abs, times = surface_abc(card, prec)
    prec_long = np.random.default_rng(0).uniform(0, 20, ABC_STEPS)
    (q_scan, s_scan), n_sim = counted(
        "ABC simulate", lambda: ABCModel(
            params=ABC_PARAMS).simulate(prec_long, engine='scan',
                                        return_storage=True))
    res_abc, n_fit = counted("ABC fit", lambda: ABCModel().fit(
        qobs, prec, seed=0, maxiter=30))
    check(not n_sim and not n_fit, f"ABC's 'scan' engine launched kernels: "
          f"{n_sim}, {n_fit}")
    check_fit(ABCModel, res_abc, "ABC 'scan' fit")
    k6 = fa.abc_fused_single(as_tensor(prec_long, F32), 0.0, ABC_PARAMS)
    for series, g, w in zip(("q", "S"), k6, (q_scan[:, 0], s_scan[:, 0])):
        max_abs["abc_fused_single"] = max(max_abs["abc_fused_single"], report(
            f"surface ABCModel.simulate 'scan' T={ABC_STEPS}: K6 vs it "
            f"{series}", g, w, *abc_tol(w)))
    del q_scan, s_scan, k6
    print(f"[5 surface] ABCModel 'scan' float32: simulate T={ABC_STEPS} in "
          f"{walls['ABC simulate']:.3f} s, fit on CAMELS 01031500 "
          f"(T={len(prec)}) nit={res_abc.nit} fun={res_abc.fun:.5f} in "
          f"{walls['ABC fit']:.3f} s, no kernel launched; {card}")

    # (b) DE checkpoints to a directory, unsharded and on a mesh.
    broken, total = SURFACE_DE
    shards = default_mesh(["cuda:0"] * MESH_SHARDS)
    fits = {}
    for label, mesh in (("unsharded", None),
                        (f"{MESH_SHARDS} x cuda:0", shards)):
        kw = dict(engine='fused', seed=1, tol=0.0, mesh=mesh)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "de")

            def runs():
                full = GR4J().fit(qobs, prec, etp, maxiter=total, **kw)
                part = GR4J().fit(qobs, prec, etp, maxiter=broken,
                                  checkpoint_path=path,
                                  checkpoint_every=DE_CHECKPOINT_EVERY, **kw)
                check(os.path.isfile(os.path.join(path, ".metadata")),
                      f"{path} holds no checkpoint directory")
                return full, part, GR4J().fit(qobs, prec, etp,
                                              maxiter=total,
                                              resume_from=path, **kw)

            (full, part, resumed), n = counted(f"DE directory {label}", runs)
        check(part.nit == broken and same_run(resumed, full),
              f"DE {label}: {broken} generations to a directory and resumed "
              f"to {total} differ from the unbroken {total}")
        check_fit(GR4J, full, f"GR4J fit {label}")
        expect = {"gr4j_mse": ((total + 1) + (broken + 1) + (total - broken))
                  * (1 if mesh is None else MESH_SHARDS)}
        check(n == expect, f"DE {label}: launches {n}, expected {expect}")
        fits[label] = full
    check(same_run(*fits.values()), "the fused fit on the mesh differs from "
          "the unsharded one")
    print(f"[5 surface] DE, GR4J fused fit on CAMELS 01031500: {broken} "
          f"generations saved to a directory every {DE_CHECKPOINT_EVERY} and "
          f"resumed to {total} equal the unbroken {total} bit for bit, "
          f"unsharded ({walls['DE directory unsharded']:.3f} s for the "
          f"three fits) and on {MESH_SHARDS} shards of cuda:0 ("
          f"{walls[f'DE directory {MESH_SHARDS} x cuda:0']:.3f} s); fun "
          f"{full.fun:.6f}; {card}")

    # (c) SCE-UA on a mesh with the 'scan' objective, per point.
    days = slice(-SURFACE_SCE_DAYS, None)
    sce_args = (qobs[days], prec[days], etp[days])
    sce_kw = dict(method='sce', engine='scan', seed=0,
                  maxiter=SURFACE_SCE_MAXITER)
    p = max(2, len(GR4J._param_list))
    unsharded = {}
    for label, mesh in (("default_mesh()", default_mesh()),
                        (f"{MESH_SHARDS} x cuda:0", shards)):
        n_complexes = pad_to_multiple(p, mesh.size)
        if n_complexes not in unsharded:
            unsharded[n_complexes], n = counted(
                f"SCE scan p={n_complexes}", lambda: GR4J().fit(
                    *sce_args, n_complexes=n_complexes, **sce_kw))
            check(not n, f"the 'scan' SCE fit launched {n}")
        res, n = counted(f"SCE scan {label}", lambda: GR4J().fit(
            *sce_args, mesh=mesh, **sce_kw))
        check(not n, f"the 'scan' SCE fit on {label} launched {n}")
        check_fit(GR4J, res, f"SCE on {label}")
        check(same_run(res, unsharded[n_complexes]),
              f"fit(method='sce', engine='scan') on {label} differs from "
              "the unsharded SCE fit")
    raised = None
    try:
        GR4J().fit(*sce_args, method='sce', engine='fused', mesh=shards,
                   maxiter=1)
    except ValueError as exc:
        raised = str(exc)
    check(raised is not None and "per-point" in raised,
          f"fit(method='sce', engine='fused', mesh=) did not raise JAX's "
          f"ValueError: {raised!r}")
    print(f"[5 surface] SCE, GR4J fit(method='sce', engine='scan') on the "
          f"last {SURFACE_SCE_DAYS} days, maxiter {SURFACE_SCE_MAXITER}: on "
          f"default_mesh() ({walls['SCE scan default_mesh()']:.3f} s) and "
          f"{MESH_SHARDS} shards of cuda:0 ("
          f"{walls[f'SCE scan {MESH_SHARDS} x cuda:0']:.3f} s) bit for bit "
          f"the unsharded fit, nfev {res.nfev}; engine='fused' raises; "
          f"{card}")

    # (d) enable_x64: float64 without dtype=.
    config.enable_x64()
    model = GR4J(params=GR4J_GOLDEN)
    q_auto, n_auto = counted("simulate enable_x64", lambda: model.simulate(
        prec, etp, engine='fused'))
    config.enable_x64(False)
    q_f64, n_f64 = counted("simulate float64", lambda: GR4J(
        params=GR4J_GOLDEN, dtype=F64).simulate(prec, etp, engine='fused'))
    check(model.dtype == F64 and q_auto.dtype == F64
          and torch.equal(q_auto, q_f64),
          "enable_x64(): simulate without dtype differs from dtype=float64")
    check(n_auto == n_f64 == {"gr4j_traj": 1},
          f"enable_x64 simulate launched {n_auto}, the float64 one {n_f64}")
    check(config.default_float() == F32
          and GR4J(params=GR4J_GOLDEN).dtype == F32,
          "enable_x64(False) left float64 the default")
    plain = GR4J(params=GR4J_GOLDEN, dtype=F64).simulate(prec, etp,
                                                         engine='scan')
    max_abs["gr4j_traj"] = report(
        f"surface enable_x64 K3 float64 (1 x {len(prec)}) vs the 'scan' "
        "engine",
        q_auto, plain, *TOL[F64]["traj"])
    print(f"[5 surface] enable_x64(): fused GR4J simulate without dtype "
          f"launched K3 in float64, bit for bit dtype=torch.float64; "
          f"enable_x64(False) restored float32; {card}")
    print(f"[5 surface] launches {launches}; {card}")
    return launches, max_abs, walls


def measure_row(rows, card, name, kernel, plain, ops, n_bytes, reps, what,
                dtype=F32):
    """Time ``kernel`` and its ``plain`` version, print one ``[6 times]``
    line and keep ``rows[name] = dict(ms, plain_ms, bound_ms, bound_by)``;
    returns the kernel's ms.  The kernel is timed in two rounds (a gap
    between them is drift); the plain version, seconds long, in one cold
    call on the host clock.  ``ops`` are counted against the float32 peak
    in either type (the card's float64 rate outside the tensor cores is
    half of it, so a float64 bound by operations is low by up to 2x)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kernel_a = device_ms(kernel, reps)
    kernel_b = device_ms(kernel, reps)
    ms = min(kernel_a, kernel_b)
    bound, by = bound_ms(ops, n_bytes)
    rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    print(f"[6 times] {name} {str(dtype)[6:]} {what}: kernel {kernel_a:.4f}/"
          f"{kernel_b:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound:.4f} ms by {by} (operations "
          f"{ops / PEAK_F32_FLOPS * 1e3:.4f} ms, bytes "
          f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms), kernel/bound "
          f"{ms / bound:.1f}x; {card}")
    return ms


def snow_time_inputs(n, t_len, num_layers):
    """The snow kernels' timing inputs: (T, L) forcing and members over
    the flagship bounds, from one numpy recipe."""
    rng = np.random.default_rng(2)
    d = SnowData.random(rng, t_len, num_layers, F32, temp_range=(-10, 15),
                        frac_range=(0, 1), ice_hi=0.5, qobs_range=(0, 5))
    params = {k: as_tensor(rng.uniform(lo, hi, n), F32)
              for k, (lo, hi) in (
                  ('CTG', (0, 1)), ('Kf', (0, 6)), ('Thacc', (5, 50)),
                  ('Rsp', (0.1, 1)), ('x1', (100, 1200)), ('x2', (-5, 3)),
                  ('x3', (20, 300)), ('x4', (1.1, 2.9)), ('DDF', (1, 10)))}
    return d, params


def forecast_shape_calls(forcing):
    """K4, K10 and K14 at the forecast path's shapes: the one-member cold
    spin-up with its final state (GR4J: all but the last FORECAST_DAYS of
    CAMELS 01031500, UH (10, 21), as the class simulates; snow:
    SNOW_SPINUP_DAYS x 5 layers, hysteresis + ice, UH FORECAST_UH, from the
    bench recipe; HBV-Edu: the first HBV_SPINUP_DAYS MATLAB days) and the
    131072-member warm continuation of FORECAST_DAYS from a carried state
    (the state a cold run over as many days before ends in).  Returns
    {name: (call, plain call, operations, bytes, description)}."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n, t_warm, num_layers, uh = MC_MEMBERS, FORECAST_DAYS, 5, FORECAST_UH
    h = uh[1] - 1
    calls = {}
    _, prec_np, etp_np = basin()
    prec, etp = (as_tensor(a, F32) for a in (prec_np, etp_np))
    t_spin = prec.shape[0] - t_warm
    spin = (prec[:t_spin].contiguous(), etp[:t_spin].contiguous())
    gr4j_one = gr4j_random_params(np.random.default_rng(5), 1, 2.9, F32)
    calls["gr4j_traj_state_spinup"] = (
        lambda: fg.gr4j_simulate_state_fused(*spin, gr4j_one, None, 0.3, 0.3,
                                             *uh)[0],
        lambda: gr4j_state_plain(fg, *spin, gr4j_one, None, uh,
                                 (0.3, 0.3))[0],
        GR4J_STEP_OPS[uh] * t_spin,
        4 * (2 * t_spin + 6 + t_spin + 2 + h), f"spin-up uh={uh} N=1 "
        f"T={t_spin}")
    before = (prec[t_spin - t_warm:t_spin].contiguous(),
              etp[t_spin - t_warm:t_spin].contiguous())
    last = (prec[t_spin:].contiguous(), etp[t_spin:].contiguous())
    gr4j_members = gr4j_random_params(np.random.default_rng(6), n, 2.9, F32)
    _, gr4j_state = fg.gr4j_simulate_state_fused(*before, gr4j_members, None,
                                                 0.3, 0.3, *uh)
    calls["gr4j_traj_state_continuation"] = (
        lambda: fg.gr4j_simulate_state_fused(*last, gr4j_members, gr4j_state,
                                             num_uh1=uh[0],
                                             num_uh2=uh[1])[0],
        lambda: gr4j_state_plain(fg, *last, gr4j_members, gr4j_state, uh)[0],
        GR4J_STEP_OPS[uh] * n * t_warm,
        4 * (2 * t_warm + (6 + h) * n + n * t_warm + (2 + h) * n),
        f"continuation uh={uh} N={n} T={t_warm}")
    kw = dict(hyst=True, ice=True, uh=uh, inits=(0.0, 0.0, 0.3, 0.3))
    snow_step = (num_layers * (SNOW_LAYER_OPS[True] + SNOW_ICE_OPS + 1) + 2
                 + GR4J_STEP_OPS[uh])
    rows = 2 + h + 4 * num_layers        # K10's state rows per member
    t_spin = SNOW_SPINUP_DAYS
    d_spin, p_spin = snow_time_inputs(1, t_spin, num_layers)
    calls["snow_traj_state_spinup"] = (
        lambda: snow_state_kernel(fs, d_spin, p_spin, None, **kw)[0],
        lambda: snow_state_plain(fs, d_spin, p_spin, None, **kw)[0],
        snow_step * t_spin,
        4 * (3 * t_spin * num_layers + t_spin + 2 * num_layers + 11
             + t_spin + rows),
        f"spin-up hyst+ice uh={uh} N=1 T={t_spin} L={num_layers}")
    d, params = snow_time_inputs(n, 2 * t_warm, num_layers)
    tail = d.cut(t_warm, 2 * t_warm)
    _, state = snow_state_kernel(fs, d.cut(0, t_warm), params, None, **kw)
    calls["snow_traj_state_continuation"] = (
        lambda: snow_state_kernel(fs, tail, params, state, **kw)[0],
        lambda: snow_state_plain(fs, tail, params, state, **kw)[0],
        snow_step * n * t_warm,
        4 * (3 * t_warm * num_layers + t_warm + num_layers
             + (11 + 5 * num_layers + h) * n + n * t_warm + rows * n),
        f"continuation hyst+ice uh={uh} N={n} T={t_warm} L={num_layers}")
    tensors = hbv_tensors(forcing, F32)
    t_spin = HBV_SPINUP_DAYS
    head = hbv_cut(tensors, 0, t_spin)
    one = hbv_random_params(np.random.default_rng(6), 1, F32)
    calls["hbv_traj_state_spinup"] = (
        lambda: hbv_state_kernel(fh, head, one, None)[0],
        lambda: hbv_state_plain(fh, head, one, None)[0],
        HBV_STEP_OPS * t_spin, 4 * (4 * t_spin + 17 + t_spin + 4),
        f"spin-up N=1 T={t_spin}")
    hbv_tail = hbv_cut(tensors, t_spin, t_spin + t_warm)
    members = hbv_random_params(np.random.default_rng(7), n, F32)
    _, hbv_state = hbv_state_kernel(fh, hbv_cut(tensors, t_spin - t_warm,
                                                t_spin), members, None)
    calls["hbv_traj_state_continuation"] = (
        lambda: hbv_state_kernel(fh, hbv_tail, members, hbv_state)[0],
        lambda: hbv_state_plain(fh, hbv_tail, members, hbv_state)[0],
        HBV_STEP_OPS * n * t_warm,
        4 * (4 * t_warm + 17 * n + n * t_warm + 4 * n),
        f"continuation N={n} T={t_warm}")
    return calls


def cat_outputs(fn, *args):
    """``fn(*args)``'s outputs as one tensor."""
    return torch.cat(fn(*args))


def rotating(fn, series, *args):
    """A zero-argument call of ``fn(x, *args)`` whose ``x`` takes turns
    through ``series``, so that no launch finds its input in the 50 MB L2
    cache."""
    turn = itertools.count()
    return lambda: fn(series[next(turn) % len(series)], *args)


def abc_time_calls(prec_basin):
    """K6 and K7 at the bench's 10M steps (float32 and, as ``*_f64``,
    float64; three copies of the series take turns) and at the
    Monte-Carlo's 4096 members x 12418 CAMELS days (``*_mc``, float32).
    Parameters are device tensors, as the class passes them: a Python float
    would cost a host-to-device copy that waits for the stream.  Returns
    {name: (call, plain call, check call, operations, bytes, description,
    dtype)}; the check call runs the kernel on one fixed input and returns
    q and S as one tensor."""
    from rrmpg_tpu_torch.ops import abc, fused_abc as fa

    calls = {}
    kernels = (("abc_fused_single", fa.abc_fused_single),
               ("abc_fused", fa.abc_fused))
    for dtype, suffix in ((F32, ""), (F64, "_f64")):
        rng = np.random.default_rng(0)
        series = [as_tensor(rng.uniform(0, 20, ABC_STEPS), dtype)
                  for _ in range(3)]
        member = {k: as_tensor(v, dtype) for k, v in ABC_PARAMS.items()}
        s0 = as_tensor(0.0, dtype)
        size = 4 if dtype == F32 else 8
        for name, fn in kernels:
            calls[name + suffix] = (
                rotating(fn, series, s0, member),
                rotating(abc.run_abcmodel_pscan, series, s0, member),
                functools.partial(cat_outputs, fn, series[0], s0, member),
                ABC_STEP_OPS * ABC_STEPS, 3 * size * ABC_STEPS,
                f"N=1 T={ABC_STEPS}", dtype)
    basin = as_tensor(prec_basin, F32)
    params, s0 = abc_members(np.random.default_rng(3), ABC_MC_MEMBERS, F32)
    n, t_len = ABC_MC_MEMBERS, basin.shape[0]
    for name, fn in kernels:
        calls[name + "_mc"] = (
            functools.partial(fn, basin, s0, params),
            functools.partial(abc.run_abcmodel_pscan, basin, s0, params),
            functools.partial(cat_outputs, fn, basin, s0, params),
            ABC_STEP_OPS * n * t_len, 4 * (t_len + 4 * n + 2 * n * t_len),
            f"Monte-Carlo N={n} T={t_len}", F32)
    return calls


def gr4j_simulate_call(prec_np, etp_np):
    """K3 at the main path's ``simulate``: one member over the whole CAMELS
    01031500 record, UH (10, 21).  Returns (call, plain call, operations,
    bytes, description)."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    prec, etp = as_tensor(prec_np, F32), as_tensor(etp_np, F32)
    t_len, uh = prec.shape[0], (10, 21)
    one = gr4j_random_params(np.random.default_rng(5), 1, 2.9, F32)
    return (lambda: fg.gr4j_simulate_fused(prec, etp, 0.0, 0.0, one, *uh),
            lambda: fg.gr4j_simulate_reference(
                prec, etp, fg.pack_params(one, 0.0, 0.0), *uh),
            GR4J_STEP_OPS[uh] * t_len, 4 * (3 * t_len + 6),
            f"simulate uh={uh} N=1 T={t_len}")


def gr4j_regional_bench_call(uh, t_len=TIME_STEPS):
    """K5 at C = 8 catchments x 131072 members x ``t_len`` CAMELS 01031500
    days (3651: the regional shape of bench.py:258-276; None: the whole
    record, 12418 days, as the regional main path sweeps it), MSE (masked
    where the record has gaps): each catchment's forcing a scaled copy, one
    parameter set per member shared by all.  Returns (call, plain call,
    operations, bytes, description)."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    n, c = TIME_MEMBERS, REGION_BASINS
    qobs_np, prec_np, etp_np = basin()
    t_len = len(qobs_np) if t_len is None else t_len
    rng = np.random.default_rng(8)
    scale = rng.uniform(0.8, 1.2, (c, 1))
    prec, etp = (as_tensor(a[:t_len] * scale, F32) for a in (prec_np, etp_np))
    qobs = as_tensor(np.tile(qobs_np[:t_len], (c, 1)), F32)
    masked = bool(torch.isnan(qobs).any())
    members = gr4j_random_params(np.random.default_rng(uh[0]), n, 2.9, F32)
    packed = fg.pack_params(members, 0.0, 0.0)
    return (lambda: fg.gr4j_regional_objective_fused(
                prec, etp, qobs, 0.0, 0.0, members, *uh, masked=masked),
            lambda: fg.gr4j_regional_objective_reference(
                prec, etp, qobs, packed, *uh, masked=masked,
                counts=regional_counts(qobs, masked)),
            (GR4J_STEP_OPS[uh] + OBJECTIVE_OPS["mse"]) * c * n * t_len,
            4 * (3 * c * t_len + 6 * n + c + c * n),
            f"C={c} uh={uh} N={n} T={t_len} mse{'+masked' * masked}")


def glue_traj_call():
    """K9 at the shape of GLUE's Monte-Carlo: CemaneigeGR4J (one layer, no
    hysteresis, no ice), 20000 members x 3652 days, UH (10, 21) (the
    class's simulate never takes shorter registers); forcing and members
    from the recipe of the snow timing inputs.
    Returns (call, plain call, operations, bytes, description)."""
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n, t_len, num_layers = GLUE_MEMBERS, GLUE_DAYS, 1
    d, params = snow_time_inputs(n, t_len, num_layers)
    kw = dict(uh=(10, 21), inits=(0.0, 0.0, 0.3, 0.3))
    ops = (num_layers * (SNOW_LAYER_OPS[False] + 1) + 1
           + GR4J_STEP_OPS[(10, 21)]) * n * t_len
    n_bytes = 4 * (3 * t_len * num_layers + t_len + num_layers + 11 * n
                   + n * t_len)
    return (lambda: snow_call(fs, d, params, "traj", **kw),
            lambda: snow_call(fs, d, params, "traj", plain=True, **kw),
            ops, n_bytes,
            f"GLUE shape plain uh=(10, 21) N={n} T={t_len} L={num_layers}")


def times_regional(measure):
    """K5 and K11 against their plain versions and bounds (``measure`` is
    :func:`measure_row` with its rows and card bound): K5 at 8 x 131072 x
    3651 at both UH register pairs and over the main path's whole record
    (T = 12418), K11 at 8 x 131072 x 3651 x 5 layers, hysteresis + ice, UH
    (3, 7).  The plain versions advance all catchments in one time loop and
    are timed once."""
    for uh, key in (((3, 7), "gr4j_regional_uh37"),
                    ((10, 21), "gr4j_regional")):
        fn, plain, ops, n_bytes, what = gr4j_regional_bench_call(uh)
        measure(key, fn, plain, ops, n_bytes, 3, what)
    fn, plain, ops, n_bytes, what = gr4j_regional_bench_call((10, 21), None)
    measure("gr4j_regional_record", fn, plain, ops, n_bytes, 2, what)
    del fn, plain
    fn, plain, ops, n_bytes, what = regional_snow_bench_call()
    measure("snow_regional", fn, plain, ops, n_bytes, 3, what)


# ---------------------------------------------------------------------------
# The objectives up close: SASS of the time loop, time against N, fit shapes
# ---------------------------------------------------------------------------

CUOBJDUMP = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                         "cuobjdump")
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
# Classes of SASS opcodes, by the opcode's first word.
SASS_CLASSES = (
    ("mufu", ("MUFU",)),
    ("fp64", ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")),
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
              "FCHK", "FRND", "FSWZADD")),
    ("lds/sts", ("LDS", "STS", "LDSM")),
    ("ldg", ("LDG", "LDGSTS", "LD", "UBLKCP", "UTMALDG")),
    ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BREAK",
                "BRX", "JMP", "WARPSYNC", "BAR", "SYNCS", "DEPBAR",
                "LDGDEPBAR")),
)
# The instantiations whose time loop is read: (kernel, template arguments
# as the build lines print them).  K8 at the bench shape (statistics and
# SCA statistics, hysteresis + ice, UH (3, 7); 5 layers in registers, and
# the run-time layer count), K12's three modes, K1/K2 at the bench shape
# (UH (10, 21)) and the fit's (UH (3, 7), no gaps in CAMELS 01031500; the
# split kernel runs there: its production and routing loops are the two
# inner loops of its tile loop, each run by its own warps), and
# K11 at the regional bench shape (hysteresis + ice, UH (3, 7); 5 layers
# in registers and the run-time count; snow_regional_kernel is the name of
# its earlier design, which --compare may build); K5 at both UH register
# pairs (MSE; the main path's masked at (10, 21)); K9 at the bench shape
# (hysteresis + ice, UH (3, 7), 5 layers in registers and the run-time
# count), GLUE's (plain, UH (10, 21), one layer) and the snow-only routine
# (5 layers), with the template arguments of its earlier design (no layer
# count), which --compare may build; K10 at the bench shape (5 layers in
# registers and the run-time count) and the forecast path's (UH (10, 21)),
# and in its earlier design (no layer count); K13 and K14 (one body, the
# template arguments of their earlier design); K4 at both UH register pairs
# and its split kernel at the forecast spin-up's (10, 21); K3 likewise (its
# split kernel at the main path's simulate).
SASS_TARGETS = (
    ("snow_objective_kernel", "float, 3, 7, true, true, false, false, 5"),
    ("snow_objective_kernel", "float, 3, 7, true, true, false, true, 5"),
    ("snow_objective_kernel", "float, 3, 7, true, true, false, false, 0"),
    ("hbv_objective_kernel", "float, false, false"),
    ("hbv_objective_kernel", "float, true, false"),
    ("hbv_objective_kernel", "float, false, true"),
    ("gr4j_objective_kernel", "float, 10, 21, false, false"),
    ("gr4j_objective_kernel", "float, 10, 21, true, false"),
    ("gr4j_objective_kernel", "float, 3, 7, false, false"),
    ("gr4j_objective_kernel", "float, 3, 7, true, false"),
    ("gr4j_objective_split_kernel", "float, 3, 7, false, false"),
    ("gr4j_objective_split_kernel", "float, 3, 7, true, false"),
    ("snow_regional_objective_kernel", "float, 3, 7, true, true, 5"),
    ("snow_regional_objective_kernel", "float, 3, 7, true, true, 0"),
    ("snow_regional_kernel", "float, 3, 7, true, true"),
    ("gr4j_regional_kernel", "float, 3, 7, false, false"),
    ("gr4j_regional_kernel", "float, 10, 21, false, false"),
    ("gr4j_regional_kernel", "float, 10, 21, false, true"),
    ("snow_traj_kernel", "float, 3, 7, true, true, false, 5"),
    ("snow_traj_kernel", "float, 3, 7, true, true, false, 0"),
    ("snow_traj_kernel", "float, 10, 21, false, false, false, 1"),
    ("snow_traj_kernel", "float, 1, 1, false, false, true, 5"),
    ("snow_traj_kernel", "float, 3, 7, true, true, false"),
    ("snow_traj_kernel", "float, 10, 21, false, false, false"),
    ("snow_traj_kernel", "float, 1, 1, false, false, true"),
    ("snow_traj_state_kernel", "float, 3, 7, true, true, 5"),
    ("snow_traj_state_kernel", "float, 3, 7, true, true, 0"),
    ("snow_traj_state_kernel", "float, 10, 21, true, true, 5"),
    ("snow_traj_state_kernel", "float, 3, 7, true, true"),
    ("snow_traj_state_kernel", "float, 10, 21, true, true"),
    ("hbv_traj_kernel", "float"),
    ("hbv_traj_state_kernel", "float"),
    ("gr4j_traj_state_kernel", "float, 10, 21"),
    ("gr4j_traj_state_kernel", "float, 3, 7"),
    ("gr4j_traj_state_split_kernel", "float, 10, 21"),
    ("gr4j_traj_kernel", "float, 10, 21"),
    ("gr4j_traj_kernel", "float, 3, 7"),
    ("gr4j_traj_split_kernel", "float, 10, 21"),
)
# Probes of what one operation costs in SASS (each minus probe_add).
PROBE_SRC = r"""
#define PROBE(name, expr)                                                   \
  extern "C" __global__ void name(const float* x, const float* y,          \
                                  float* o) {                              \
    const int i = threadIdx.x;                                             \
    const float a = x[i], b = y[i];                                        \
    o[i] = expr;                                                           \
  }
PROBE(probe_add, a + b)
PROBE(probe_div, a / b)
PROBE(probe_powf, powf(a, b))
PROBE(probe_exp2_log2, exp2f(b * log2f(a)))
"""
SWEEP_MEMBERS = (16896, 33792, 67584, 131072, 262144)
# K2 also below one block of 128 per SM (its split kernel runs up to 33792).
GR4J_SWEEP_SMALL = (2112, 4224, 8448)
# The times of a fit generation's shape, carried in the kernels line.
# The times of the forecast path's shapes, carried in the kernels line.
FORECAST_SHAPE_ROWS = {
    "gr4j_traj_state": ("gr4j_traj_state_spinup",
                        "gr4j_traj_state_continuation"),
    "snow_traj_state": ("snow_traj_state_spinup",
                        "snow_traj_state_continuation"),
    "hbv_traj_state": ("hbv_traj_state_spinup",
                       "hbv_traj_state_continuation")}
# The times of K3 and K6 / K7 at their other shapes (the main paths'
# simulate and Monte-Carlo, float64), carried in the kernels line.
SHAPE_ROWS = {"gr4j_traj": ("gr4j_traj_simulate",),
              "abc_fused_single": ("abc_fused_single_mc",
                                   "abc_fused_single_f64"),
              "abc_fused": ("abc_fused_mc", "abc_fused_f64")}
FIT_SHAPE_ROWS = {"snow_objective": "snow_mse_fit",
                  "hbv_objective": "hbv_mse_fit",
                  "gr4j_mse": "gr4j_mse_fit", "gr4j_stats": "gr4j_stats_fit"}
GR4J_FIT_SHAPE = (60, 12418)        # members (15 x 4 parameters), CAMELS days
GR4J_FIT_UH = (3, 7)                # plain GR4J's x4 bound, 2.9
SNOW_FIT_SHAPE = (135, 1827, 5)     # members (15 x 9 parameters), days, layers
SNOW_FIT_UH = (10, 21)              # from the hysteresis classes' x4 bound, 10
HBV_FIT_SHAPE = (165, 3652)         # members (15 x 11 parameters), days


def sass_class(opcode):
    base = opcode.split(".")[0]
    for name, bases in SASS_CLASSES:
        if base in bases:
            return name
    return "other"


def sass_functions(path):
    """{mangled name: [(address, opcode, operands)]} of every kernel in a
    library or cubin, from ``cuobjdump -sass``."""
    listing = subprocess.run([CUOBJDUMP, "-sass", str(path)],
                             capture_output=True, text=True, check=True).stdout
    funcs, current = {}, None
    for ln in listing.splitlines():
        if "Function :" in ln:
            current = funcs.setdefault(ln.split("Function :")[1].strip(), [])
        elif current is not None:
            m = SASS_LINE.search(ln)
            if m:
                current.append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    return funcs


def sass_loops(instrs):
    """(first, last) address of every loop: a branch back to an earlier
    address (the trap at a kernel's end branches to itself)."""
    spans = set()
    for addr, opcode, operands in instrs:
        m = re.search(r"0x([0-9a-f]+)", operands)
        if opcode.split(".")[0] == "BRA" and m and int(m.group(1), 16) < addr:
            spans.add((int(m.group(1), 16), addr))
    return spans


def time_loop_profile(instrs):
    """The time loop of a kernel: the largest loop, or inside it a loop of
    at least 40 % of its size (a step loop inside a tile loop).  Returns
    (instructions of that loop outside its inner loops, by class; sizes of
    its inner loops), or None without a loop."""
    spans = sass_loops(instrs)
    if not spans:
        return None

    def inside(span):
        return [i for i in instrs if span[0] <= i[0] <= span[1]]

    loop = max(spans, key=lambda s: len(inside(s)))
    while True:
        big = [s for s in spans if s != loop and loop[0] <= s[0]
               and s[1] <= loop[1]
               and len(inside(s)) >= 0.4 * len(inside(loop))]
        if not big:
            break
        loop = max(big, key=lambda s: len(inside(s)))
    nested = [s for s in spans if s != loop and loop[0] <= s[0]
              and s[1] <= loop[1]]
    outer = [s for s in nested if not any(
        t != s and t[0] <= s[0] and s[1] <= t[1] for t in nested)]
    own = [i for i in inside(loop)
           if not any(s[0] <= i[0] <= s[1] for s in outer)]
    classes = {}
    for _, opcode, _ in own:
        classes[sass_class(opcode)] = classes.get(sass_class(opcode), 0) + 1
    return classes, sorted(len(inside(s)) for s in outer)


def sass_step_counts(lib):
    """{(kernel, template arguments): time_loop_profile} of SASS_TARGETS in
    a built library."""
    wanted = set(SASS_TARGETS)
    found = {}
    for name, instrs in sass_functions(lib.path).items():
        m = re.search(KERNEL_NAME, name)
        if m and (m.group(1), template_args(m.group(2))) in wanted:
            found[(m.group(1), template_args(m.group(2)))] = (
                time_loop_profile(instrs))
    return found


def sass_summary(profile):
    """One line's worth of a time_loop_profile."""
    if profile is None:
        return "no loop found"
    classes, inner = profile
    text = f"{sum(classes.values())} per step (" + ", ".join(
        f"{k} {classes.get(k, 0)}" for k, _ in SASS_CLASSES) + (
        f", other {classes.get('other', 0)})")
    if inner:
        text += f" + inner loop(s) of {inner} per trip"
    return text


def probe_costs():
    """SASS instructions of an IEEE float division, powf and
    exp2f(y * log2f(x)) on sm_90a, each beyond an addition's kernel."""
    from rrmpg_tpu_torch.ops._build import NVCC_FLAGS, _find_nvcc

    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        src.write_text(PROBE_SRC)
        flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_find_nvcc(), *flags, "-cubin", "-o", str(cubin),
                        str(src)], check=True, capture_output=True)
        funcs = sass_functions(cubin)
    sizes = {name: sum(1 for _, op, _ in instrs if op != "NOP")
             for name, instrs in funcs.items()}
    return {name: size - sizes["probe_add"] for name, size in sizes.items()
            if name != "probe_add"}


def k8_k12_calls(d, snow_params, tensors, hbv_qobs, hbv_params):
    """The K8 and K12 calls of the bench shape, by mode, as zero-argument
    functions through the wrappers (for timing, so no plain version)."""
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    kw = dict(hyst=True, ice=True, uh=(3, 7), inits=(0.0, 0.0, 0.3, 0.3))
    calls = {f"snow_{mode}": functools.partial(snow_call, fs, d, snow_params,
                                               mode, **kw)
             for mode in ("mse", "stats")}
    # The warm entries continue from the state a cold run ends in (K10 and
    # K14, the same in both designs).
    _, snow_state = snow_state_kernel(fs, d, snow_params, None, **kw)
    calls["snow_warm"] = functools.partial(
        snow_warm_objective_kernel, fs, d, snow_params, snow_state, True, True,
        (3, 7), True, False)
    calls.update({f"hbv_{mode}": functools.partial(
        hbv_kernel, fh, tensors, hbv_qobs, hbv_params, mode)
        for mode in ("mse", "stats")})
    _, hbv_state = fh.hbv_simulate_state_fused(*tensors, *HBV_INITS,
                                               hbv_params)
    calls["hbv_warm"] = functools.partial(
        fh.hbv_ensemble_mse_fused, *tensors, hbv_qobs, 0.0, 0.0, 0.0, 0.0,
        hbv_params, stats=True, state=hbv_state)
    calls["snow_sca_stats"] = functools.partial(
        snow_call, fs, d, snow_params, "sca_stats", **kw)
    return calls


def gr4j_fit_shape_calls():
    """K1 and K2 at the shape of a GR4J ``fit`` generation on CAMELS
    01031500: 60 members x 12418 days, UH (3, 7), the basin's own
    discharge (no gaps), cold from empty stores.  As fit_shape_calls."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    n, t_len = GR4J_FIT_SHAPE
    qobs, prec, etp = (as_tensor(a[:t_len], F32) for a in basin())
    params = gr4j_random_params(np.random.default_rng(5), n, 2.9, F32)
    packed = fg.pack_params(params, 0.0, 0.0)
    calls = {}
    for mode in ("mse", "stats"):
        stats = mode == "stats"
        calls[f"gr4j_{mode}_fit"] = (
            functools.partial(fg.gr4j_ensemble_mse_fused, prec, etp, qobs,
                              0.0, 0.0, params, *GR4J_FIT_UH, stats=stats),
            functools.partial(fg.gr4j_objective_reference, prec, etp, qobs,
                              packed, *GR4J_FIT_UH, stats=stats),
            (GR4J_STEP_OPS[GR4J_FIT_UH] + OBJECTIVE_OPS[mode]) * n * t_len,
            4 * (3 * t_len + 6 * n + (4 if stats else 1) * n),
            f"fit shape uh={GR4J_FIT_UH} N={n} T={t_len} {mode}")
    return calls


def fit_shape_calls(forcing, qsim_matlab):
    """K8, K12, K1 and K2 at the shapes of a ``fit`` generation: the snow
    fit's 135 members x 1827 days x 5 layers (MSE, gaps in discharge,
    hysteresis + ice, UH (10, 21)), the HBV-Edu fit's 165 members x 3652
    days (MSE with gaps) and the GR4J fit's (gr4j_fit_shape_calls).
    Returns {name: (call, plain call, operations, bytes, description)}."""
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n, t_len, num_layers = SNOW_FIT_SHAPE
    d, params = snow_time_inputs(n, t_len, num_layers)
    kw = dict(hyst=True, ice=True, uh=SNOW_FIT_UH, masked=True,
              inits=(0.0, 0.0, 0.3, 0.3))
    snow_ops = ((num_layers * (SNOW_LAYER_OPS[True] + SNOW_ICE_OPS + 1) + 2
                 + GR4J_STEP_OPS[SNOW_FIT_UH] + SNOW_SUMS_OPS) * n * t_len)
    snow_bytes = 4 * (3 * t_len * num_layers + 2 * t_len + 2 * num_layers
                      + 11 * n + n)
    hn, ht = HBV_FIT_SHAPE
    tensors = hbv_tensors(forcing, F32, ht)
    qobs = qsim_matlab[:ht] * (24 * 60 * 60) / (HBV_AREA * 1000)
    qobs[200:215] = np.nan
    qobs[::97] = np.nan
    qobs = as_tensor(qobs, F32)
    hbv_params = hbv_random_params(np.random.default_rng(4), hn, F32)
    args = (fh, tensors, qobs, hbv_params, "mse", True)
    return {**gr4j_fit_shape_calls(), 
        "snow_mse_fit": (
            lambda: snow_call(fs, d, params, "mse", **kw),
            lambda: snow_call(fs, d, params, "mse", plain=True, **kw),
            snow_ops, snow_bytes,
            f"fit shape hyst+ice uh={SNOW_FIT_UH} N={n} T={t_len} "
            f"L={num_layers} mse+masked"),
        "hbv_mse_fit": (
            lambda: hbv_kernel(*args), lambda: hbv_plain(*args),
            (HBV_STEP_OPS + OBJECTIVE_OPS["mse"]) * hn * ht,
            4 * (5 * ht + 17 * hn + hn),
            f"fit shape N={hn} T={ht} mse+masked"),
    }


def sweep_calls(forcing, qsim_matlab, members):
    """K8 statistics (131072-shape recipe, hysteresis + ice, UH (3, 7), 5
    layers), K12 statistics and K2 (UH (10, 21), CAMELS 01031500) at
    T = 3651 with ``members`` members."""
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    d, params = snow_time_inputs(members, TIME_STEPS, 5)
    tensors = hbv_tensors(forcing, F32, TIME_STEPS)
    qobs = as_tensor(qsim_matlab[:TIME_STEPS], F32)
    hbv_params = hbv_random_params(np.random.default_rng(2), members, F32)
    kw = dict(hyst=True, ice=True, uh=(3, 7), inits=(0.0, 0.0, 0.3, 0.3))
    return {"snow_stats": lambda: snow_call(fs, d, params, "stats", **kw),
            "hbv_stats": lambda: hbv_kernel(fh, tensors, qobs, hbv_params,
                                            "stats"),
            "gr4j_stats": gr4j_sweep_call(members)}


def gr4j_sweep_call(members):
    """K2 at T = 3651 (CAMELS 01031500, UH (10, 21)) with ``members``
    members, as one zero-argument call."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    qobs, prec, etp = (as_tensor(a[:TIME_STEPS], F32) for a in basin())
    params = gr4j_random_params(np.random.default_rng(1), members, 2.9, F32)
    return functools.partial(fg.gr4j_ensemble_mse_fused, prec, etp, qobs,
                             0.0, 0.0, params, 10, 21, stats=True)


def print_sass(card, label, lib):
    for (kernel, targs), profile in sorted(sass_step_counts(lib).items()):
        print(f"[6 times] SASS {label}{kernel}<{targs}> time loop: "
              f"{sass_summary(profile)}; {card}")


@contextlib.contextmanager
def using_library(lib):
    """Let the wrappers launch from ``lib`` (another build of the sources
    with the same C interface) instead of the checkout's own library."""
    from rrmpg_tpu_torch.ops import _build

    saved = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = saved


def output_difference(got, want):
    """(largest absolute difference where both are finite, whether the two
    are equal element for element with NaN where the other has NaN)."""
    got, want = got.double(), want.double()
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    both = ~(nan_got | nan_want)
    diff = float((got[both] - want[both]).abs().max()) if bool(
        both.any()) else 0.0
    same = bool(torch.equal(nan_got, nan_want)) and bool(
        torch.equal(got[both], want[both]))
    return diff, same


def bits_equal(got, want):
    """Whether two tensors are equal element for element, NaN where the
    other has NaN."""
    return output_difference(got, want)[1]


def gr4j_bench_calls():
    """K1 and K2 at the bench shape: 131072 members x 3651 CAMELS days,
    UH (10, 21), members over plain GR4J's bounds."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    qobs, prec, etp = (as_tensor(a[:TIME_STEPS], F32) for a in basin())
    params = gr4j_random_params(np.random.default_rng(1), TIME_MEMBERS, 2.9,
                                F32)
    return {f"gr4j_{mode}": functools.partial(
        fg.gr4j_ensemble_mse_fused, prec, etp, qobs, 0.0, 0.0, params, 10, 21,
        stats=mode == "stats") for mode in ("mse", "stats")}


def gr4j_equality_calls():
    """K1/K2 calls on which two builds of the same arithmetic must agree
    bit for bit: the Excel GR4J sheet (its golden parameters among 255
    random members) and the whole CAMELS 01031500 record (37 days with
    p == e), float64 and float32, both UH register pairs, MSE and
    statistics, cold and warm (from the state K4 ends the first half in);
    and edge inputs (300 steps, every seventh with p == e): NaN forcing at
    two steps, an inf and a NaN initial store.  Returns {name: call}."""
    import pandas as pd
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    sheet = pd.read_csv(REPO / "tests" / "data" / "gr4j_example_data.csv")
    records = {"excel": (sheet.prec.to_numpy(), sheet.etp.to_numpy(),
                         sheet.qobs.to_numpy()),
               "camels": tuple(basin()[k] for k in (1, 2, 0))}
    rng = np.random.default_rng(7)
    edge_p = rng.uniform(0, 15, 300)
    edge_e = rng.uniform(0, 4, 300)
    edge_e[::7] = edge_p[::7]
    edge_q = rng.uniform(0, 5, 300)
    calls = {}
    for dtype in (F64, F32):
        name = str(dtype)[6:]
        for uh in ((3, 7), (10, 21)):
            params = gr4j_random_params(np.random.default_rng(uh[0]), 256,
                                        2.9 if uh[0] == 3 else
                                        BOUNDS_X4_WIDE, dtype)
            for k, v in GR4J_GOLDEN.items():
                params[k][0] = v
            for record, (p, e, q) in records.items():
                p, e, q = (as_tensor(a, dtype) for a in (p, e, q))
                half = p.shape[0] // 2
                _, state = fg.gr4j_simulate_state_fused(
                    p[:half].contiguous(), e[:half].contiguous(), params,
                    None, 0.6, 0.7, *uh)
                tail = [x[half:].contiguous() for x in (p, e, q)]
                for stats in (False, True):
                    mode = "stats" if stats else "mse"
                    calls[f"{record} {name} uh={uh} {mode}"] = (
                        functools.partial(fg.gr4j_ensemble_mse_fused, p, e,
                                          q, 0.6, 0.7, params, *uh,
                                          stats=stats))
                    calls[f"{record} {name} uh={uh} {mode} warm"] = (
                        functools.partial(fg.gr4j_ensemble_mse_fused, *tail,
                                          0.0, 0.0, params, *uh,
                                          stats=stats, state=state))
            p, e, q = (as_tensor(a, dtype) for a in (edge_p, edge_e, edge_q))
            nan_p, nan_e = p.clone(), e.clone()
            nan_p[100] = torch.nan
            nan_e[200] = torch.nan
            for label, forcing, s_init in (
                    ("p == e", (p, e), 0.4), ("NaN forcing", (nan_p, nan_e),
                                              0.4),
                    ("inf store", (p, e), float("inf")),
                    ("NaN store", (p, e), float("nan"))):
                calls[f"edge {label} {name} uh={uh} stats"] = (
                    functools.partial(fg.gr4j_ensemble_mse_fused, *forcing, q,
                                      s_init, 0.3, params, *uh, stats=True))
    return calls


def shared_source_calls():
    """K5, K9 and K10 at their bench shapes (K5 at both UH register pairs
    and over the main path's whole record; K9 at 131072 x 3651 x 5 layers
    and at GLUE's shape; K10 cold and warm), and K3 and K4, which share
    `gr4j_step.cuh` with K1/K2 and K5 (K8 is timed with K12), as
    zero-argument calls that return one tensor: {name: (call,
    description)}."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n, t_len = TIME_MEMBERS, TIME_STEPS
    qobs_np, prec_np, etp_np = basin()
    prec, etp = (as_tensor(a[:t_len], F32) for a in (prec_np, etp_np))
    params = gr4j_random_params(np.random.default_rng(1), n, 2.9, F32)
    _, state = fg.gr4j_simulate_state_fused(prec, etp, params, None, 0.0, 0.0,
                                            10, 21)
    d, snow_params = snow_time_inputs(n, t_len, 5)
    kw = dict(hyst=True, ice=True, uh=(3, 7), inits=(0.0, 0.0, 0.3, 0.3))
    _, snow_state = snow_state_kernel(fs, d, snow_params, None, **kw)
    shape = f"N={n} T={t_len}"
    calls = {name: (fn, what) for name, (fn, _, _, _, what) in (
        ("gr4j_regional_uh37", gr4j_regional_bench_call((3, 7))),
        ("gr4j_regional", gr4j_regional_bench_call((10, 21))),
        ("gr4j_regional_record", gr4j_regional_bench_call((10, 21), None)),
        ("snow_traj_glue", glue_traj_call()))}
    calls.update({name: (fn, shape) for name, fn in (
        ("snow_traj", lambda: snow_call(fs, d, snow_params, "traj", **kw)),
        ("gr4j_traj", lambda: fg.gr4j_simulate_fused(prec, etp, 0.0, 0.0,
                                                     params, 10, 21)),
        ("gr4j_traj_state_cold", lambda: fg.gr4j_simulate_state_fused(
            prec, etp, params, None, 0.0, 0.0, 10, 21)[0]),
        ("gr4j_traj_state_warm", lambda: fg.gr4j_simulate_state_fused(
            prec, etp, params, state, num_uh1=10, num_uh2=21)[0]),
        ("snow_traj_state_cold", lambda: snow_state_kernel(
            fs, d, snow_params, None, **kw)[0]),
        ("snow_traj_state_warm", lambda: snow_state_kernel(
            fs, d, snow_params, snow_state, **kw)[0]))})
    return calls


def k5_k9_equality_calls():
    """K5 and K9 calls on which two builds of the same arithmetic must agree
    bit for bit, float64 and float32: K9 on the four Excel snow sheets
    (each class's fused simulate) and on random forcing at T = 65 and 300,
    N = 129, 1, 2, 5 and 7 layers, every variant at both UH register pairs
    and the snow-only routine; K5 on three scaled copies of CAMELS
    01031500 (one record cut at half, one with 10 % gaps) and on the Excel
    GR4J sheet as one catchment (its golden parameters among 255 random
    members), both UH register pairs, MSE and statistics, and on edge
    inputs (300 steps, every seventh with p == e): NaN forcing at two
    steps, an inf and a NaN initial store.  Returns {name: call}."""
    import pandas as pd
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_snow as fs

    calls = {}
    qobs_np, prec_np, etp_np = basin()
    sheet = pd.read_csv(REPO / "tests" / "data" / "gr4j_example_data.csv")
    rng = np.random.default_rng(9)
    scale = rng.uniform(0.8, 1.2, (3, 1))
    region_q = np.tile(qobs_np, (3, 1))
    region_q[0, len(qobs_np) // 2:] = np.nan
    region_q[1, rng.random(len(qobs_np)) < 0.1] = np.nan
    edge_p = rng.uniform(0, 15, (1, 300))
    edge_e = rng.uniform(0, 4, (1, 300))
    edge_e[:, ::7] = edge_p[:, ::7]
    edge_q = rng.uniform(0, 5, (1, 300))
    for dtype in (F64, F32):
        name = str(dtype)[6:]
        for sheet_name, (_, call) in snow_golden_calls(dtype).items():
            calls[f"K9 {sheet_name} {name}"] = call
        for t_len in (65, 300):
            for num_layers in (1, 2, 5, 7):
                d = SnowData.random(np.random.default_rng(num_layers), t_len,
                                    num_layers, dtype)
                label = f"K9 {name} T={t_len} L={num_layers}"
                params = snow_random_params(np.random.default_rng(3), 129,
                                            dtype, 2.9)
                calls[f"{label} snow-only"] = functools.partial(
                    snow_call, fs, d, params, "traj", snow_only=True)
                for uh in fg.SUPPORTED_UH:
                    params = snow_random_params(
                        np.random.default_rng(uh[0]), 129, dtype,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                    for variant, hyst, ice in SNOW_VARIANTS:
                        calls[f"{label} uh={uh} {variant}"] = (
                            functools.partial(snow_call, fs, d, params,
                                              "traj", hyst=hyst, ice=ice,
                                              uh=uh))
        region = (as_tensor(prec_np * scale, dtype),
                  as_tensor(etp_np * scale, dtype),
                  as_tensor(region_q, dtype))
        excel = tuple(as_tensor(a[None], dtype) for a in (
            sheet.prec.to_numpy(), sheet.etp.to_numpy(),
            sheet.qobs.to_numpy()))
        edge = tuple(as_tensor(a, dtype) for a in (edge_p, edge_e, edge_q))
        nan_forcing = tuple(x.clone() for x in edge)
        nan_forcing[0][0, 100] = torch.nan
        nan_forcing[1][0, 200] = torch.nan
        for uh in fg.SUPPORTED_UH:
            params = gr4j_random_params(np.random.default_rng(uh[0]), 256,
                                        2.9 if uh[0] == 3 else
                                        BOUNDS_X4_WIDE, dtype)
            for k, v in GR4J_GOLDEN.items():
                params[k][0] = v
            cases = (("CAMELS x3", region, 0.6, True),
                     ("Excel", excel, 0.6, False),
                     ("edge p == e", edge, 0.4, False),
                     ("edge NaN forcing", nan_forcing, 0.4, False),
                     ("edge inf store", edge, float("inf"), False),
                     ("edge NaN store", edge, float("nan"), False))
            for label, series, s_init, masked in cases:
                for stats in (False, True):
                    calls[f"K5 {label} {name} uh={uh} "
                          f"{'stats' if stats else 'mse'}"] = (
                        functools.partial(
                            fg.gr4j_regional_objective_fused, *series,
                            s_init, 0.7, params, *uh, stats=stats,
                            masked=masked))
    return calls


def hbv_traj_calls(tensors, params):
    """K13 and K14 (cold, and warm from the state the cold run ends in) at
    the bench shape, as zero-argument calls that return the trajectory."""
    from rrmpg_tpu_torch.ops import fused_hbv as fh

    _, state = hbv_state_kernel(fh, tensors, params, None)
    return {"hbv_traj": functools.partial(hbv_kernel, fh, tensors, None,
                                          params, "traj"),
            "hbv_traj_state_cold": lambda: hbv_state_kernel(
                fh, tensors, params, None)[0],
            "hbv_traj_state_warm": lambda: hbv_state_kernel(
                fh, tensors, params, state)[0]}


def flat(q, state):
    """A trajectory and every leaf of a state as one flat tensor."""
    return torch.cat([q.reshape(-1)] + [leaf.reshape(-1)
                                        for leaf in state_leaves(state)])


def k10_k14_equality_calls(forcing):
    """K10 and K14 calls on which two builds of the same arithmetic must
    agree bit for bit, float64 and float32, each a cold run over the first
    part and a warm run over the rest from its state, returning both
    trajectories and both states as one tensor: K10 through the three
    coupled snow classes on their Excel sheets (split at half) and on random
    forcing at T = 65 and 300 (split at 32 and 200) and at T = 40 split at 37
    (a warm segment of 3 steps, shorter than the history), N = 129, 1, 2, 5
    and 7 layers, every variant at both UH register pairs; K14 on the MATLAB
    record (its golden parameters among 199 random members, a tenth of them
    dry and NaN; split at half) and at T = 65, N = 1 (split at 33).
    Returns {name: call}."""
    import pandas as pd
    from rrmpg_tpu_torch.models import (CemaneigeGR4J, CemaneigeHystGR4J,
                                        CemaneigeHystGR4JIce)
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh
    from rrmpg_tpu_torch.ops import fused_snow as fs

    def chained(kernel, head, tail, params, cold_kw):
        def call():
            q_a, st = kernel(head, params, None, **cold_kw)
            q_b, st_b = kernel(tail, params, st, **cold_kw)
            return torch.cat([flat(q_a, st), flat(q_b, st_b)])
        return call

    def sheet_call(model, columns, kw, half):
        def call():
            cut = lambda lo, hi: [c.iloc[lo:hi] for c in columns]
            q_a, st = model.simulate(*cut(0, half), **kw,
                                     return_final_state=True, engine='fused')
            q_b, st_b = model.simulate(*cut(half, None), **kw,
                                       initial_state=st,
                                       return_final_state=True,
                                       engine='fused')
            return torch.cat([flat(q_a, st), flat(q_b, st_b)])
        return call

    def snow_kernel(d, params, state, **kw):
        return snow_state_kernel(fs, d, params, state, **kw)

    def hbv_kernel_chain(tensors, params, state):
        return hbv_state_kernel(fh, tensors, params, state)

    calls = {}
    data = REPO / "tests" / "data"
    sheets = {
        "CemaneigeGR4J": (
            CemaneigeGR4J, CEMANEIGEGR4J_GOLDEN, 495,
            pd.read_csv(data / 'cemaneigegr4j_validation_data.csv', sep=';',
                        index_col=0), {}),
        "CemaneigeHystGR4J": (
            CemaneigeHystGR4J, HYST_GOLDEN, 700,
            pd.read_csv(data / 'cemaneigehystgr4j_validation_data.csv',
                        index_col=0), {}),
        "CemaneigeHystGR4JIce": (
            CemaneigeHystGR4JIce, dict(HYST_GOLDEN, DDF=5), 700,
            pd.read_csv(data / 'cemaneigehystgr4jice_validation_data.csv',
                        index_col=0), dict(frac_ice=FRAC_ICE_GOLDEN))}
    for dtype in (F64, F32):
        name = str(dtype)[6:]
        for sheet, (cls, golden, height, df, extra) in sheets.items():
            columns = [df.precipitation, df.mean_temp, df.min_temp,
                       df.max_temp, df.pe]
            calls[f"K10 {sheet} {name}"] = sheet_call(
                cls(params=golden, dtype=dtype), columns,
                dict(extra, met_station_height=height, altitudes=ALTITUDES),
                len(df) // 2)
        for t_len, split in ((65, 32), (300, 200), (40, 37)):
            for num_layers in (1, 2, 5, 7):
                d = SnowData.random(np.random.default_rng(num_layers), t_len,
                                    num_layers, dtype)
                head, tail = d.cut(0, split), d.cut(split, t_len)
                for uh in fg.SUPPORTED_UH:
                    params = snow_random_params(
                        np.random.default_rng(uh[0]), 129, dtype,
                        2.9 if uh[0] == 3 else BOUNDS_X4_WIDE)
                    for variant, hyst, ice in SNOW_VARIANTS:
                        calls[f"K10 {name} T={split}+{t_len - split} "
                              f"L={num_layers} uh={uh} {variant}"] = chained(
                            snow_kernel, head, tail, params,
                            dict(hyst=hyst, ice=ice, uh=uh))
        tensors = hbv_tensors(forcing, dtype)
        half = tensors[0].shape[0] // 2
        params = hbv_random_params(np.random.default_rng(11), 200, dtype,
                                   n_dry=20)
        for k, v in HBV_GOLDEN.items():
            params[k][-1] = v
        calls[f"K14 MATLAB {name}"] = chained(
            hbv_kernel_chain, hbv_cut(tensors, 0, half),
            hbv_cut(tensors, half, tensors[0].shape[0]), params, {})
        one = hbv_random_params(np.random.default_rng(12), 1, dtype)
        calls[f"K14 T=33+32 N=1 {name}"] = chained(
            hbv_kernel_chain, hbv_cut(tensors, 0, 33),
            hbv_cut(tensors, 33, 65), one, {})
    return calls


def k4_k13_equality_calls(forcing):
    """K4 and K13 calls on which two builds must agree bit for bit, float64
    and float32, each returning its trajectories and state rows as one
    tensor.  K4 (the same arithmetic in both builds): a cold run over the
    first part and a warm run over the rest from its state, on the Excel
    GR4J sheet (its golden parameters among 255 random members: the split
    kernel) and the whole CAMELS 01031500 record (37 days with p == e; also
    with one member more than the split kernel takes), split at half, and
    at T = 40 split at 37 (a warm segment shorter than the history), both
    UH register pairs; cold on edge inputs (300 steps, every seventh with
    p == e): NaN forcing at two steps, an inf and a NaN initial store.  K13
    on the MATLAB record (its golden parameters among 199 random members, a
    tenth of them dry and NaN) and at T = 65, N = 1: bit-equal in float64;
    in float32 a build before K13 took the float32 soil power differs.
    Returns {name: call}."""
    import pandas as pd
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh

    def k4(prec, etp, params, uh, inits):
        q, st = fg.gr4j_simulate_state_fused(prec, etp, params, None, *inits,
                                             *uh)
        return flat(q, st)

    def chained(prec, etp, params, uh, split):
        head = (prec[:split].contiguous(), etp[:split].contiguous())
        tail = (prec[split:].contiguous(), etp[split:].contiguous())

        def call():
            q_a, st = fg.gr4j_simulate_state_fused(*head, params, None, 0.6,
                                                   0.7, *uh)
            q_b, st_b = fg.gr4j_simulate_state_fused(*tail, params, st, 0.0,
                                                     0.0, *uh)
            return torch.cat([flat(q_a, st), flat(q_b, st_b)])
        return call

    sheet = pd.read_csv(REPO / "tests" / "data" / "gr4j_example_data.csv")
    records = {"excel": (sheet.prec.to_numpy(), sheet.etp.to_numpy()),
               "camels": tuple(basin()[k] for k in (1, 2))}
    rng = np.random.default_rng(7)
    edge_p = rng.uniform(0, 15, 300)
    edge_e = rng.uniform(0, 4, 300)
    edge_e[::7] = edge_p[::7]
    calls = {}
    for dtype in (F64, F32):
        name = str(dtype)[6:]
        for uh in fg.SUPPORTED_UH:
            params = gr4j_random_params(np.random.default_rng(uh[0]), 256,
                                        2.9 if uh[0] == 3 else
                                        BOUNDS_X4_WIDE, dtype)
            for k, v in GR4J_GOLDEN.items():
                params[k][0] = v
            many = gr4j_random_params(np.random.default_rng(uh[1]),
                                      fg.traj_split_members() + 1,
                                      2.9 if uh[0] == 3 else BOUNDS_X4_WIDE,
                                      dtype)
            for record, (p, e) in records.items():
                p, e = as_tensor(p, dtype), as_tensor(e, dtype)
                calls[f"K4 {record} {name} uh={uh}"] = chained(
                    p, e, params, uh, p.shape[0] // 2)
                if record == "camels":
                    calls[f"K4 T=37+3 {name} uh={uh}"] = chained(
                        p[:40], e[:40], params, uh, 37)
                    calls[f"K4 {record} N={many['x1'].shape[0]} {name} "
                          f"uh={uh}"] = chained(p, e, many, uh,
                                                p.shape[0] // 2)
            p, e = as_tensor(edge_p, dtype), as_tensor(edge_e, dtype)
            nan_p, nan_e = p.clone(), e.clone()
            nan_p[100] = torch.nan
            nan_e[200] = torch.nan
            for label, forcing_pe, s_init in (
                    ("p == e", (p, e), 0.4),
                    ("NaN forcing", (nan_p, nan_e), 0.4),
                    ("inf store", (p, e), float("inf")),
                    ("NaN store", (p, e), float("nan"))):
                calls[f"K4 edge {label} {name} uh={uh}"] = functools.partial(
                    k4, *forcing_pe, params, uh, (s_init, 0.3))
        tensors = hbv_tensors(forcing, dtype)
        params = hbv_random_params(np.random.default_rng(11), 200, dtype,
                                   n_dry=20)
        for k, v in HBV_GOLDEN.items():
            params[k][-1] = v
        calls[f"K13 MATLAB {name}"] = functools.partial(
            hbv_kernel, fh, tensors, None, params, "traj")
        one = hbv_random_params(np.random.default_rng(12), 1, dtype)
        calls[f"K13 T=65 N=1 {name}"] = functools.partial(
            hbv_kernel, fh, hbv_cut(tensors, 0, 65), None, one, "traj")
    return calls


def k3_k7_equality_calls():
    """K3 and K7 calls on which two builds must agree bit for bit, float64
    and float32.  K3 (one production arm a step gives the two-arm step's
    values): the Excel GR4J sheet (its golden parameters among 255 random
    members: the split kernel), the whole CAMELS 01031500 record (the same
    members, and one more than the split kernel takes: the tile kernel),
    both UH register pairs; cold on edge inputs (300 steps, every seventh
    with p == e): NaN forcing at two steps, an inf and a NaN initial store.
    K7: T = 10M (float32), one step past a chunk, and the Monte-Carlo's
    4096 x 12418, q and S as one tensor; against a build from before K7's
    redesign (runs out of shared memory composed in another order) these
    calls differ by rounding in both types, the exception to bit equality
    that phase 3 covers by holding K7 to the doubling scan and K6 at
    ``abc_tol``.  Returns {name: call}."""
    import pandas as pd
    from rrmpg_tpu_torch.ops import fused_abc as fa
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops._build import load_library

    sheet = pd.read_csv(REPO / "tests" / "data" / "gr4j_example_data.csv")
    _, prec_basin, etp_basin = basin()
    records = {"excel": (sheet.prec.to_numpy(), sheet.etp.to_numpy()),
               "camels": (prec_basin, etp_basin)}
    rng = np.random.default_rng(7)
    edge_p = rng.uniform(0, 15, 300)
    edge_e = rng.uniform(0, 4, 300)
    edge_e[::7] = edge_p[::7]
    calls = {}
    for dtype in (F64, F32):
        name = str(dtype)[6:]
        for uh in fg.SUPPORTED_UH:
            x4_hi = 2.9 if uh[0] == 3 else BOUNDS_X4_WIDE
            params = gr4j_random_params(np.random.default_rng(uh[0]), 256,
                                        x4_hi, dtype)
            for k, v in GR4J_GOLDEN.items():
                params[k][0] = v
            many = gr4j_random_params(np.random.default_rng(uh[1]),
                                      fg.traj_split_members() + 1, x4_hi,
                                      dtype)
            for record, (p, e) in records.items():
                p, e = as_tensor(p, dtype), as_tensor(e, dtype)
                calls[f"K3 {record} {name} uh={uh}"] = functools.partial(
                    fg.gr4j_simulate_fused, p, e, 0.6, 0.7, params, *uh)
                if record == "camels":
                    calls[f"K3 {record} N={many['x1'].shape[0]} {name} "
                          f"uh={uh}"] = functools.partial(
                              fg.gr4j_simulate_fused, p, e, 0.6, 0.7, many,
                              *uh)
            p, e = as_tensor(edge_p, dtype), as_tensor(edge_e, dtype)
            nan_p, nan_e = p.clone(), e.clone()
            nan_p[100] = torch.nan
            nan_e[200] = torch.nan
            for label, forcing_pe, s_init in (
                    ("p == e", (p, e), 0.4),
                    ("NaN forcing", (nan_p, nan_e), 0.4),
                    ("inf store", (p, e), float("inf")),
                    ("NaN store", (p, e), float("nan"))):
                calls[f"K3 edge {label} {name} uh={uh}"] = functools.partial(
                    fg.gr4j_simulate_fused, *forcing_pe, s_init, 0.3, params,
                    *uh)
        chunk = load_library().rrmpg_abc_chunk_size(int(dtype == F64))
        for t_len in (chunk + 1, ABC_STEPS):
            if dtype == F64 and t_len == ABC_STEPS:
                continue
            prec = as_tensor(
                np.random.default_rng(t_len).uniform(0, 20, t_len), dtype)
            calls[f"K7 T={t_len} {name}"] = functools.partial(
                cat_outputs, fa.abc_fused, prec, 5.0,
                {'a': 0.3, 'b': 0.4, 'c': 0.12})
        members, s0 = abc_members(np.random.default_rng(3), ABC_MC_MEMBERS,
                                  dtype)
        calls[f"K7 N={ABC_MC_MEMBERS} T={len(prec_basin)} {name}"] = (
            functools.partial(cat_outputs, fa.abc_fused,
                              as_tensor(prec_basin, dtype), s0, members))
    return calls


def sass_by_kernel(path):
    """{kernel<template arguments>: [(opcode, operands)]} of a library."""
    out = {}
    for name, instrs in sass_functions(path).items():
        m = re.search(KERNEL_NAME, name)
        if m:
            key = f"{m.group(1)}<{template_args(m.group(2))}>"
            out[key] = [(op, args) for _, op, args in instrs]
    return out


def regional_snow_bench_call():
    """K11 at the regional bench shape, 8 catchments x 131072 members x
    3651 days x 5 layers, hysteresis + ice, UH (3, 7), MSE: each
    catchment's forcing a scaled copy of one recipe, one parameter set per
    member shared by all.  Returns (call, plain call, operations, bytes,
    description)."""
    from rrmpg_tpu_torch.ops import fused_snow as fs

    n, t_len, c, num_layers, uh = (TIME_MEMBERS, TIME_STEPS, REGION_BASINS,
                                   5, (3, 7))
    scale = np.random.default_rng(8).uniform(0.8, 1.2, (c, 1))
    d, snow_params = snow_time_inputs(n, t_len, num_layers)
    factors = [float(f) for f in scale[:, 0]]
    region = dict(prec=torch.stack([d.prec * f for f in factors]),
                  temp=torch.stack([d.temp] * c),
                  frac=torch.stack([d.frac] * c),
                  etp=torch.stack([d.etp * f for f in factors]),
                  qobs=torch.stack([d.qobs[False]] * c),
                  frac_ice=torch.stack([d.frac_ice] * c))
    kw = dict(hyst=True, ice=True, uh=uh, masked=False,
              inits=(0.0, 0.0, 0.3, 0.3))
    series = c * (3 * t_len * num_layers + 2 * t_len + 2 * num_layers)
    return (lambda: regional_snow_call(fs, region, snow_params, stats=False,
                                       **kw),
            lambda: regional_snow_call(fs, region, snow_params, plain=True,
                                       **kw),
            (num_layers * (SNOW_LAYER_OPS[True] + SNOW_ICE_OPS + 1) + 2
             + GR4J_STEP_OPS[uh] + SNOW_SUMS_OPS) * c * n * t_len,
            4 * (series + 11 * n + c + c * n),
            f"C={c} hyst+ice uh={uh} N={n} T={t_len} L={num_layers} mse")


def phase_compare(card, other_dirs, forcing, qsim_matlab):
    """Development: build the kernel sources in each of ``other_dirs``
    (another version's ``rrmpg_tpu_torch/csrc``) beside this checkout's,
    and time K1-K14 of each against this one's in turns (other, this, this,
    other) at the bench shapes (K5 also over the main path's record, K9
    also at GLUE's shape, K4, K10 and K14 also at the forecast path's
    shapes, K3 also at the main path's simulate, K6 and K7 also at the
    Monte-Carlo's shape and in float64), K1, K2, K8 and K12 at the fit
    shapes and over SWEEP_MEMBERS, with the largest output difference
    between the two builds for each timed call, the SASS of the time loops,
    the instantiations whose SASS differs and the registers that differ;
    then K1/K2, K5/K9, K10/K14, K4/K13 and K3/K7 of both builds on the
    goldens and edge inputs, bit for bit.  Times only: the kernels phase
    checks this checkout's kernels."""
    from rrmpg_tpu_torch.ops._build import BUILD_DIR, build_library, \
        load_library

    this = load_library()
    others = []
    for k, src in enumerate(other_dirs):
        lib = build_library(src, BUILD_DIR / f"compare{k}", strict=False)
        print(f"[compare] {src}: {lib.path.name} built in "
              f"{lib.build_seconds:.1f} s")
        # Registers and spills where the two builds differ.
        theirs, ours = ptxas_table(lib.log), ptxas_table(this.log)
        for kernel in sorted(set(theirs) | set(ours)):
            if theirs.get(kernel) != ours.get(kernel):
                print(f"    ptxas {kernel}: {src} {theirs.get(kernel)}, "
                      f"this {ours.get(kernel)} (registers, spill bytes)")
        others.append((str(src), lib))
    ours = sass_by_kernel(this.path)
    for label, lib in others:
        theirs = sass_by_kernel(lib.path)
        both = sorted(set(ours) & set(theirs))
        differ = [k for k in both if ours[k] != theirs[k]]
        print(f"[compare] SASS against {label}: {len(both) - len(differ)} "
              f"of the {len(both)} instantiations in both builds identical "
              f"instruction for instruction; differing: {differ}")
    for label, lib in [("this", this)] + others:
        print_sass(card, f"{label}: ", lib)
    for name, extra in probe_costs().items():
        print(f"[compare] {name}: {extra} SASS instructions beyond an "
              "addition's kernel (sm_90a, -O3)")

    def outputs(fn, lib):
        with using_library(lib):
            out = fn()
        torch.cuda.synchronize()
        return out

    def turns(name, fn, reps, what, check_fn=None):
        for label, lib in others:
            diff, same = output_difference(outputs(check_fn or fn, this),
                                           outputs(check_fn or fn, lib))
            ms = []
            for use in (lib, this, this, lib):
                with using_library(use):
                    ms.append(device_ms(fn, reps))
            print(f"[compare] {name} {what}: {label} {ms[0]:.4f} / "
                  f"{ms[3]:.4f} ms, this {ms[1]:.4f} / {ms[2]:.4f} ms, "
                  f"this/{label} {min(ms[1:3]) / min(ms[0], ms[3]):.3f}; "
                  f"largest output difference {diff:.3e}, bit-equal {same}; "
                  f"{card}")

    n, t_len = TIME_MEMBERS, TIME_STEPS
    for name, fn in gr4j_bench_calls().items():
        turns(name, fn, 5, f"uh=(10, 21) N={n} T={t_len}")
    _, prec_np, etp_np = basin()
    fn, _, _, _, what = gr4j_simulate_call(prec_np, etp_np)
    turns("gr4j_traj_simulate", fn, 20, what)
    for name, (fn, _, check_fn, _, _, what, dtype) in abc_time_calls(
            prec_np).items():
        turns(name, fn, 20, f"{str(dtype)[6:]} {what}", check_fn)
    fn, _, _, _, what = regional_snow_bench_call()
    turns("snow_regional", fn, 3, what)
    for name, (fn, what) in shared_source_calls().items():
        turns(name, fn, 3, what)
    for name, (fn, _, _, _, what) in forecast_shape_calls(forcing).items():
        turns(name, fn, 5, what)
    d, snow_params = snow_time_inputs(n, t_len, 5)
    tensors = hbv_tensors(forcing, F32, t_len)
    hbv_qobs = as_tensor(qsim_matlab[:t_len], F32)
    hbv_params = hbv_random_params(np.random.default_rng(2), n, F32)
    for name, fn in hbv_traj_calls(tensors, hbv_params).items():
        turns(name, fn, 3, f"N={n} T={t_len}")
    bench = k8_k12_calls(d, snow_params, tensors, hbv_qobs, hbv_params)
    sca = bench.pop("snow_sca_stats")
    for name, fn in bench.items():
        turns(name, fn, 3, f"N={n} T={t_len}")
    del d, bench
    for name, (fn, _, _, _, what) in fit_shape_calls(forcing,
                                                     qsim_matlab).items():
        turns(name, fn, 20, what)
    for members in GR4J_SWEEP_SMALL:
        turns("gr4j_stats", gr4j_sweep_call(members), 5,
              f"sweep N={members} T={t_len}")
    for members in SWEEP_MEMBERS:
        for name, fn in sweep_calls(forcing, qsim_matlab, members).items():
            turns(name, fn, 3, f"sweep N={members} T={t_len}")
    turns("snow_sca_stats", sca, 3, f"N={n} T={t_len}")
    for family, calls in (("K1/K2", gr4j_equality_calls()),
                          ("K5/K9", k5_k9_equality_calls()),
                          ("K10/K14", k10_k14_equality_calls(forcing)),
                          ("K4/K13", k4_k13_equality_calls(forcing)),
                          ("K3/K7", k3_k7_equality_calls())):
        for label, lib in others:
            unequal = []
            for name, fn in calls.items():
                diff, same = output_difference(outputs(fn, this),
                                               outputs(fn, lib))
                print(f"[compare] {family} {name}: this against {label}, "
                      f"largest difference {diff:.3e}, bit-equal {same}")
                if not same:
                    unequal.append(name)
            print(f"[compare] {family} against {label}: "
                  f"{len(calls) - len(unequal)} of {len(calls)} calls "
                  f"bit-equal; differing: {unequal}")


def times_objectives(measure, card, forcing, qsim_matlab):
    """K8, K12 and K1/K2 beyond the bench shape: at the shapes of a ``fit``
    generation (against plain version and bound), over SWEEP_MEMBERS at
    T = 3651 (kernel only: time against N says whether the SMs' issue or
    one thread's latency binds), and the SASS of their time loops."""
    from rrmpg_tpu_torch.ops._build import load_library

    for name, (fn, plain, ops, n_bytes, what) in fit_shape_calls(
            forcing, qsim_matlab).items():
        measure(name, fn, plain, ops, n_bytes, 20, what)
    sweep = [(m, "gr4j_stats", gr4j_sweep_call(m)) for m in GR4J_SWEEP_SMALL]
    for members in SWEEP_MEMBERS:
        sweep += [(members, name, fn) for name, fn in sweep_calls(
            forcing, qsim_matlab, members).items()]
    for members, name, fn in sweep:
        ms = device_ms(fn, 3)
        print(f"[6 times] sweep {name} float32 N={members} T={TIME_STEPS}: "
              f"kernel {ms:.4f} ms, "
              f"{members * TIME_STEPS / (ms * 1e-3):.4e} member-steps/s; "
              f"{card}")
    print_sass(card, "", load_library())


def phase_times(card, prec_np, etp_np, qobs_np, forcing, qsim_matlab):
    """Kernel, plain version and bound of every kernel; returns
    ``{name: dict(ms, plain_ms, bound_ms, bound_by)}``."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.ops import fused_hbv as fh

    n, t_len = TIME_MEMBERS, TIME_STEPS
    rows = {}

    measure = functools.partial(measure_row, rows, card)

    # GR4J, 131072 x 3651.
    prec, etp, qobs = (as_tensor(a[:t_len], F32)
                       for a in (prec_np, etp_np, qobs_np))
    params = gr4j_random_params(np.random.default_rng(1), n, 2.9, F32)
    packed = fg.pack_params(params, 0.0, 0.0)
    uh = fg.SUPPORTED_UH[1]
    shape = f"uh={uh} N={n} T={t_len}"
    step = GR4J_STEP_OPS[uh] * n * t_len
    for mode in ("mse", "stats"):
        stats = mode == "stats"
        ms = measure(
            f"gr4j_{mode}",
            lambda: fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0,
                                               params, *uh, stats=stats),
            lambda: fg.gr4j_objective_reference(prec, etp, qobs, packed, *uh,
                                                stats=stats),
            step + OBJECTIVE_OPS[mode] * n * t_len,
            4 * (3 * t_len + 6 * n + (4 if stats else 1) * n), 5, shape)
        print(f"    {n * t_len / (ms * 1e-3):.4e} member-steps/s")
    measure("gr4j_traj",
            lambda: fg.gr4j_simulate_fused(prec, etp, 0.0, 0.0, params, *uh),
            lambda: fg.gr4j_simulate_reference(prec, etp, packed, *uh),
            step, 4 * (2 * t_len + 6 * n + n * t_len), 5, shape)

    # K4 cold and warm, and the warm K1/K2, at the same shape.  The warm
    # entries start from the state the cold run ends in; they read H = 20
    # history rows per member more, and K4 writes 2 + H state rows.
    h = uh[1] - 1
    _, state = fg.gr4j_simulate_state_fused(prec, etp, params, None, 0.0, 0.0,
                                            *uh)
    packed_w = fg.pack_params(params, 0.0, 0.0, state)
    hist = fg.history_rows(state, uh[1], prec)
    traj_bytes = 4 * (2 * t_len + 6 * n + n * t_len + (2 + h) * n)
    measure("gr4j_traj_state_cold",
            lambda: fg.gr4j_simulate_state_fused(prec, etp, params, None, 0.0,
                                                 0.0, *uh),
            lambda: fg.gr4j_simulate_state_reference(prec, etp, packed, None,
                                                     *uh),
            step, traj_bytes, 5, shape)
    measure("gr4j_traj_state_warm",
            lambda: fg.gr4j_simulate_state_fused(prec, etp, params, state,
                                                 num_uh1=uh[0],
                                                 num_uh2=uh[1]),
            lambda: fg.gr4j_simulate_state_reference(prec, etp, packed_w,
                                                     hist, *uh),
            step, traj_bytes + 4 * h * n, 5, shape)
    for mode in ("mse", "stats"):
        stats = mode == "stats"
        measure(
            f"gr4j_{mode}_warm",
            lambda: fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0,
                                               params, *uh, stats=stats,
                                               state=state),
            lambda: fg.gr4j_objective_reference(prec, etp, qobs, packed_w,
                                                *uh, stats=stats, hist=hist),
            step + OBJECTIVE_OPS[mode] * n * t_len,
            4 * (3 * t_len + (6 + h) * n + (4 if stats else 1) * n), 5, shape)
    del state, packed_w, hist

    # HBV-Edu, 131072 x 3651, on the first 3651 MATLAB days.
    tensors = hbv_tensors(forcing, F32, t_len)
    hbv_qobs = as_tensor(qsim_matlab[:t_len], F32)
    hbv_params = hbv_random_params(np.random.default_rng(2), n, F32)
    shape = f"N={n} T={t_len}"
    step = HBV_STEP_OPS * n * t_len
    for mode in ("mse", "stats", "traj"):
        name = "hbv_traj" if mode == "traj" else f"hbv_{mode}"
        out_bytes = {"mse": n, "stats": 4 * n, "traj": n * t_len}[mode]
        n_series = 4 if mode == "traj" else 5
        args = (fh, tensors, hbv_qobs, hbv_params, mode)
        ms = measure(name, lambda: hbv_kernel(*args),
                     lambda: hbv_plain(*args),
                     step + OBJECTIVE_OPS.get(mode, 0) * n * t_len,
                     4 * (n_series * t_len + 17 * n + out_bytes), 5, shape)
        print(f"    {n * t_len / (ms * 1e-3):.4e} member-steps/s")

    # K14 cold and warm and the warm K12 (statistics): the same work plus
    # four state rows per member.
    _, hbv_state = fh.hbv_simulate_state_fused(*tensors, *HBV_INITS,
                                               hbv_params)
    traj_bytes = 4 * (4 * t_len + 17 * n + n * t_len + 4 * n)
    for entry, st in (("cold", None), ("warm", hbv_state)):
        measure(f"hbv_traj_state_{entry}",
                lambda: hbv_state_kernel(fh, tensors, hbv_params, st),
                lambda: hbv_state_plain(fh, tensors, hbv_params, st),
                step, traj_bytes, 5, shape)
    measure("hbv_warm",
            lambda: fh.hbv_ensemble_mse_fused(
                *tensors, hbv_qobs, 0.0, 0.0, 0.0, 0.0, hbv_params,
                stats=True, state=hbv_state),
            lambda: hbv_warm_objective_plain(fh, tensors, hbv_qobs,
                                             hbv_params, hbv_state, True,
                                             False),
            step + OBJECTIVE_OPS["stats"] * n * t_len,
            4 * (5 * t_len + 17 * n + 4 * n), 5, shape + " stats")
    del hbv_state

    # The snow family at the hysteresis + ice flagship shape: 131072 x 3651
    # x 5 layers, UH (3, 7), forcing and members from one numpy recipe.
    from rrmpg_tpu_torch.ops import fused_snow as fs

    num_layers, uh = 5, fg.SUPPORTED_UH[0]
    d, snow_params = snow_time_inputs(n, t_len, num_layers)
    kw = dict(hyst=True, ice=True, uh=uh, inits=(0.0, 0.0, 0.3, 0.3))
    shape = f"hyst+ice uh={uh} N={n} T={t_len} L={num_layers}"
    step = (num_layers * (SNOW_LAYER_OPS[True] + SNOW_ICE_OPS + 1) + 2
            + GR4J_STEP_OPS[uh]) * n * t_len
    series = 3 * t_len * num_layers + t_len + 2 * num_layers
    extra = {  # mode: (operations per step, values read, values written)
        "mse": (SNOW_SUMS_OPS, t_len, n),
        "stats": (SNOW_SUMS_OPS, t_len, 4 * n),
        "sca_stats": (SNOW_SUMS_OPS + SNOW_SCA_OPS * num_layers,
                      t_len + t_len * num_layers + num_layers,
                      (4 + 4 * num_layers) * n),
        "traj": (0, 0, n * t_len)}
    for mode, (ops, read, written) in extra.items():
        name = f"snow_{mode}"
        ms = measure(
            name, lambda: snow_call(fs, d, snow_params, mode, **kw),
            lambda: snow_call(fs, d, snow_params, mode, plain=True, **kw),
            step + ops * n * t_len, 4 * (series + read + 11 * n + written),
            3, shape)
        print(f"    {n * t_len / (ms * 1e-3):.4e} member-steps/s")

    # K10 cold and warm and the warm K8 (statistics).  A warm entry reads
    # 4L state rows, L constants and H = 6 history rows per member instead
    # of the L shared constants; K10 writes 2 + H + 4L state rows.
    h = uh[1] - 1
    pair_kw = dict(hyst=True, ice=True, uh=uh, inits=(0.0, 0.0, 0.3, 0.3))
    _, snow_state = snow_state_kernel(fs, d, snow_params, None, **pair_kw)
    warm_read = (5 * num_layers + h) * n
    traj_values = series + 11 * n + n * t_len + (2 + h + 4 * num_layers) * n
    for entry, st, read in (("cold", None, 0), ("warm", snow_state,
                                                warm_read)):
        measure(f"snow_traj_state_{entry}",
                lambda: snow_state_kernel(fs, d, snow_params, st, **pair_kw),
                lambda: snow_state_plain(fs, d, snow_params, st, **pair_kw),
                step, 4 * (traj_values + read), 3, shape)
    measure("snow_warm",
            lambda: snow_warm_objective_kernel(
                fs, d, snow_params, snow_state, True, True, uh, True, False),
            lambda: snow_warm_objective_plain(
                fs, d, snow_params, snow_state, True, True, uh, True, False),
            step + SNOW_SUMS_OPS * n * t_len,
            4 * (series + t_len + 11 * n + 4 * n + warm_read), 3,
            shape + " stats")
    del snow_state, d, snow_params
    # K10 and K14 at the forecast path's shapes: the one-member spin-up is
    # one thread's chain, the continuation 131072 x 365.
    for name, (fn, plain, ops, n_bytes, what) in forecast_shape_calls(
            forcing).items():
        measure(name, fn, plain, ops, n_bytes, 5, what)
    fn, plain, ops, n_bytes, what = glue_traj_call()
    ms = measure("snow_traj_glue", fn, plain, ops, n_bytes, 5, what)
    print(f"    {GLUE_MEMBERS * GLUE_DAYS / (ms * 1e-3):.4e} member-steps/s")
    del fn, plain
    times_objectives(measure, card, forcing, qsim_matlab)
    times_regional(measure)

    # K3 at the main path's simulate, one member over 12418 days.
    fn, plain, ops, n_bytes, what = gr4j_simulate_call(prec_np, etp_np)
    measure("gr4j_traj_simulate", fn, plain, ops, n_bytes, 20, what)

    # ABC: K6 and K7 at 10M steps (float32, float64) and at the
    # Monte-Carlo's shape.
    for name, (fn, plain, _, ops, n_bytes, what, dtype) in abc_time_calls(
            prec_np).items():
        ms = measure(name, fn, plain, ops, n_bytes, 20, what, dtype)
        steps = ops / ABC_STEP_OPS
        print(f"    {steps / (ms * 1e-3):.4e} steps/s, "
              f"{n_bytes / (ms * 1e-3) / 1e9:.1f} GB/s of the "
              f"{n_bytes / 1e6:.0f} MB that must move")
    return rows


def kernel_entries(launches, max_abs, times):
    """The fourteen kernels of the ``kernels`` line.  A kernel with several
    modes (KERNEL_MODES) carries the mode named in TOP_MODE at the top, the
    launches of all its modes together, and every mode under ``modes``.
    ``launches`` also counts the examples' launches of the kernel (or mode),
    which ``examples_launches`` gives alone."""
    def entry(name, launches_n, err, row):
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    out = []
    for name in KERNELS:
        if name not in KERNEL_MODES:
            examples = launches.get("examples/" + name, 0)
            out.append(entry(name, launches.get(name, 0) + examples,
                             max_abs[name], times[name]))
            out[-1]["examples_launches"] = examples
            if name in SHAPE_ROWS:
                out[-1]["shapes"] = {row: times[row]
                                     for row in SHAPE_ROWS[name]}
            continue
        modes = KERNEL_MODES[name]
        keys = [key for _, key in modes.values()]
        examples = sum(launches.get("examples/" + k, 0) for k in keys)
        combined = entry(name,
                         sum(launches.get(k, 0) for k in keys) + examples,
                         max(max_abs[k] for k in keys),
                         times[modes[TOP_MODE[name]][1]])
        combined["examples_launches"] = examples
        combined["modes"] = {
            mode: {"replaces": line, "launches": launches.get(key, 0),
                   "examples_launches": launches.get("examples/" + key, 0),
                   "max_abs_err": max_abs[key], **times.get(key, {})}
            for mode, (line, key) in modes.items()}
        for mode, detail in combined["modes"].items():
            check(detail["launches"] > 0, f"{name}, mode {mode}, was "
                  "launched no time on the main paths")
        if name in FIT_SHAPE_ROWS:
            combined["fit_shape"] = times[FIT_SHAPE_ROWS[name]]
        if name in FORECAST_SHAPE_ROWS:
            combined["forecast_shapes"] = {
                row: times[row] for row in FORECAST_SHAPE_ROWS[name]}
        out.append(combined)
    return out


PHASES = ("kernels", "golden", "main", "forecast", "regional", "tools",
          "assim", "mesh", "examples", "surface", "times")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="development: the phases to run after the "
                        "build, of " + ", ".join(PHASES))
    parser.add_argument("--compare", metavar="DIR[,DIR...]",
                        help="development: time K1-K14 "
                        "built from the kernel sources in each DIR against "
                        "this checkout's, in turns, then stop")
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    check(phases <= set(PHASES), f"unknown phase in {sorted(phases)}")
    started = time.perf_counter()

    def lap(what):
        print(f"[elapsed] {time.perf_counter() - started:.0f} s after {what}")

    card = phase_environment()
    phase_build()
    lap("the build")
    qobs, prec, etp = basin()
    forcing, qsim_matlab = hbv_data()
    if args.compare:
        phase_compare(card, args.compare.split(","), forcing, qsim_matlab)
        lap("the comparison")
        sys.exit(3)
    if "kernels" in phases:
        phase_kernels_gr4j(prec, etp, qobs)
        phase_kernels_abc()
        abc_edge_checks(prec)
        phase_kernels_hbv(forcing, qsim_matlab)
        phase_kernels_snow()
        lap("the cold kernels against their plain versions")
        phase_kernels_state_gr4j(prec, etp, qobs)
        phase_kernels_state_hbv(forcing, qsim_matlab)
        phase_kernels_state_snow()
        state_edge_checks(forcing, prec, etp)
        gr4j_traj_edge_checks(prec, etp)
        lap("the state kernels and warm objectives against theirs")
        phase_kernels_regional(prec, etp, qobs)
        lap("the regional kernels against theirs")
    if "golden" in phases:
        phase_golden(forcing, qsim_matlab)
        lap("the goldens")
    launches, max_abs = {}, {}

    def gather(name, result):
        for key, count in result[0].items():
            launches[key] = launches.get(key, 0) + count
        for key, err in result[1].items():
            max_abs[key] = max(max_abs.get(key, 0.0), err)
        print(f"[5 main path] {name} wall: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in result[2].items()) + f"; {card}")

    if "main" in phases:
        gather("GR4J", phase_main_path_gr4j(card, qobs, prec, etp))
        gather("DE", phase_main_path_de(card, qobs, prec, etp))
        gather("HBV-Edu", phase_main_path_hbv(card, forcing, qsim_matlab))
        gather("ABC", phase_main_path_abc(card, qobs, prec))
        gather("snow", phase_main_path_snow(card))
        lap("the four main paths")
    if "forecast" in phases:
        check("main" in phases, "the forecast path continues the models the "
              "main paths calibrated: run both")
        result = phase_forecast(card, qobs, prec, etp, forcing, qsim_matlab)
        walls = {f"{family} {k}": v for family, w in result[2].items()
                 for k, v in w.items()}
        gather("forecast", (result[0], result[1], walls))
        lap("the forecast path")
    if "regional" in phases:
        gather("regional", phase_regional(card))
        lap("the regional path")
    if "tools" in phases:
        gather("tools", phase_tools(card, qobs, prec, etp, forcing,
                                    qsim_matlab))
        lap("the tools")
    if "assim" in phases:
        gather("assim", phase_assim(card, qobs, prec, etp, forcing,
                                    qsim_matlab))
        lap("the assimilation path")
    if "mesh" in phases:
        gather("mesh", phase_mesh(card, qobs, prec, etp, forcing,
                                  qsim_matlab))
        lap("the mesh phase")
    if "examples" in phases:
        gather("examples", phase_examples(card))
        lap("the examples")
    if "surface" in phases:
        gather("surface", phase_surface(card, qobs, prec, etp))
        lap("the surface phase")
    if "times" in phases:
        times = phase_times(card, prec, etp, qobs, forcing, qsim_matlab)
        lap("the times")
    if phases != set(PHASES):
        print(f"ran only {sorted(phases)}: no result line")
        sys.exit(3)
    kernels = kernel_entries(launches, max_abs, times)
    check(len(kernels) == len(KERNELS) == 14, "the kernels line must list "
          "fourteen kernels")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on the "
              "main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
