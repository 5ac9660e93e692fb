#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``anqs_quantum_chemistry_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
It builds every CUDA kernel of the port from the sources in this checkout
(one ``nvcc`` each, all started together), holds each against its plain
PyTorch version on the card at the shapes of the paths that run it, then
drives the port's two training paths through ``VMC(...)``,
``init_state()`` and ``step()``/``run()``, each for 5 steps from random
weights (seed 0), with every kernel's launch count set to 0 just before the
path and read just after:

- N2 main path (``main_path_vmc``): N2/STO-3G, MADE (512 hidden, 10 qubits
  per qudit), Gumbel top-k sampling of the whole 14400-determinant sector
  (14464 rows), sector membership, MinSR top-50, clip 1.0, Adam 1e-3. Its
  energies are checked against the exact sector Hamiltonian and against the
  trajectory of the first run on the card; before it, dynamic membership
  ('hash' and 'table') must find the sector path's pairs on its batch.
- Li2O toy model (``li2o_vmc``): Li2O/STO-3G, 30 qubits, MADE 512, 6 qubits
  per qudit, 8192 Gumbel samples, hash membership (the ``hash_lookup``
  kernel, which runs the ``hash_tags`` kernel first), MinSR top-50, clip
  1.0, Adam 3e-3. Step 0's pair count and energy are checked against the
  host: ``np.isin`` of the partners, and the float64 Rayleigh quotient of H
  restricted to step 0's own sample set. Before it, the lookup and the tag
  build are held bit for bit against their plain versions at Li2O's table
  (nb 1024, tags in shared memory), a two-word random-key table and Li2O's
  set built with ``hash_extra_bits`` 6 (nb 65536, tags read from global
  memory).

Then the driver (all three from random weights, seed 0, counts set to 0
before each and read after):

- N2 exact summation (``main_path_vmc`` with ``sampling_mode='exact'``: the
  whole sorted sector, static membership) for 3 steps. Step 0 shares the
  Gumbel path's weights and determinants, so its energy must equal
  ``N2_ENERGIES[0]`` within 1e-5 Ha and the float64 Rayleigh quotient within
  1e-4 Ha; before it, the unbiased full energy of those weights (all 7.7M
  partners through the network) must equal the Rayleigh quotient
  within 1e-4 Ha. Kernel #1 launches once a step.
- N2 through ``run()`` into a temporary run directory: 6 steps, full energy
  every 3, checkpoints every 3, windows of 2 steps. The whole sector is
  sampled, so row 3's full energy must equal its energy within 1e-4 Ha;
  ``result.csv`` must have 6 rows under the JAX package's header
  (``JAX_CSV_HEADER``); a run resumed from ``ckpt_3`` must repeat rows 3-5
  within 1e-6 Ha.
- Li2O with multinomial sampling and the adaptive budget
  (``sample_precisely``, 4096 unique determinants targeted) for 3 steps,
  the budget adapted after each step as ``run`` does: energies finite,
  ``unique_num`` at most 8192, each step's counts summing to its budget
  less ``dropped`` (its sample drawn once more from a copy of the
  generator's state), kernels #1 and #2 once a step.

Last, the matrix-element kernel runs at the full tables of C2H4/6-31G (52
qubits, two words a determinant, 104278 terms in 20776 groups) on 8192
random determinants of its (8, 8) sector, bit for bit against its plain
version and within one float32 ulp of the float64 host reference on the
first 64 rows.

Then the C2H4 transformer trainer (``c2h4_vmc``, the JAX package's
``examples/c2h4_transformer.py`` at its full width and settings: the
transformer with d_model 128, 3 layers, 4 heads, d_ff 512, logit_cap 4,
qubit_per_qudit 4, 4096 Gumbel samples and the 2048 pinned HF neighbours,
prefilter membership, the 'grouped' group order, MinSR top-50, clip 0.25,
the example's learning-rate schedule), counts set to 0 before its steps and
read after:

- Membership cross-check on one set (the transformer's samples at its
  initial weights, seed 1, and the pinned neighbours): the prefilter's
  capacities are doubled from (row 64, dense 256) until it drops no row,
  each level printed; then prefilter and hash membership must find the
  same pairs and agree on the numerators t to 1e-6 of the largest |t|,
  and on e to 1e-6 of the largest |e| over rows with log|psi| > -60 (the
  two combine with different float32 arithmetic, JAX's ``_combine_rows``
  and ``_combine``, so they are not bit-identical). Kernel #3 (stage 1)
  alone on the set as one block must equal its plain version bit for bit
  (``fp_filter_check``).
- 5 steps from seed 0, the overflow policy acting after each step as
  ``run`` does: energies finite, 4096 <= ``unique_num`` <= 6144,
  ``table_overflow`` 0, no row dropped from the first step that drops
  none, and on that step ``found_pairs`` equal to a host count over its
  own set and the energy within 1e-4 Ha of the float64 Rayleigh quotient
  over that set (matrix elements summed term by term on the host). Kernels
  #1 and #2 (and the tag build) launch twice a step: stage 3a and the dense
  fallback 3b; kernel #3 once a step (stage 1 of the one row block).

Last, the Li2O NADE campaign (``li2o_nade_vmc``: the JAX package's
``examples/cisd_pretrain_vmc.py``, ``li2o_closure.py`` and
``li2o_distill_closure.py`` at their full width: Li2O/STO-3G, NADE with
hidden widths (128, 128), qubit_per_qudit 6, 8192 Gumbel samples,
prefilter membership at capacities (768, 4096), MinSR top-50, clip 0.5,
gradient weights |psi|^(2/2)), counts set to 0 before (b) and read after
(d):

- (a) The CISD vector of the packaged Li2O file (``cisd_ground_state``):
  4425 determinants, its energy within 1e-6 Ha of the JAX campaign's
  (``LI2O_CISD_ENERGY``).
- (b) 200 full-batch pretraining steps on it at lr 1e-3 from fresh weights
  (seed 0): the loss falls below 1.0, and the returned parameters are the
  best-loss snapshot (their loss equals the history's best).
- (c) The JAX package's closure state (``li2o_nade_closure_params``), one
  step at lr 0: energy within 0.2 mHa of the JAX record's median
  (``LI2O_CLOSURE_ENERGY``), ``found_pairs`` within 2% of its median
  (``LI2O_CLOSURE_PAIRS``), no row dropped; ``found_pairs`` equal to a host
  count over the step's own set and the energy within 1e-4 Ha of the
  float64 Rayleigh quotient over it.
- (d) ``run()`` from (b)'s weights for 12 steps in windows of 5 with a
  distillation cycle every 5 iterations (100 Adam steps at 1e-4, tau
  0.1): cycles on rows 5 and 10 only, each with ``distill_loss_last <
  distill_loss_first``, every row finite, ``unique_num`` 8192.
- (e) Kernels #1, #2 and the tag build launch twice for each local-energy
  evaluation (stages 3a and 3b), kernel #3 once (stage 1): 13 steps and 2
  cycles.

Last, the Li2O support-CI closure (the JAX package's ``runs/li2o_sci``
chain at full width: NADE (128, 128), qubit_per_qudit 6, 16,384 Gumbel
samples, prefilter at (768, 4096), its 131,072-determinant selected-CI
target and its states ckpt_4, ckpt_13 and ckpt_26, all packaged), counts
set to 0 before (b) and read after (f):

- (a) H over the target's top 8192 by |coef| from the packaged integrals
  (the C++ builder on the host: nnz 848,626) and its ground state
  (``restricted_ground_state``) within 1e-8 Ha of the JAX package's.
- (b) ckpt_26: ``support_rayleigh`` over those 8192 within 2e-6 Ha, and
  ``support_ci.polish``'s loss and mass (temperature 2, linear lam 30) over
  all 131,072 rows within 1e-5 relative, of the JAX package's float32
  values on the CPU (the TPU's records printed beside them); two sampled
  full energies at 16,384 (seeds 1 and 2) within 0.05 mHa of the TPU's
  confirmations (mean -88.705147) and within chemical accuracy of FCI.
- (c) ckpt_13: the loss of ``examples/li2o_sci_polish.py`` (temperature 4,
  quadratic lam 1000) within 1e-5 relative of JAX's, then 20 full-batch
  steps of that polish at lr 1e-4: the loss falls.
- (d) 50 distillation steps (batch 8192, lr 3e-4) from the packaged
  closure state: finite, falling.
- (e) 3 steps of the pinned-support VMC (``li2o_pin_vmc``, 8192 pinned
  target determinants) from ckpt_13: step 0 within 0.2 mHa of the JAX
  run's iteration 0, no row dropped, ``found_pairs`` equal to a host
  count and the energy within 1e-4 Ha of the float64 Rayleigh quotient
  over its own set.
- (f) 5 ``support_vmc`` steps (rq) and 10 L-BFGS iterations on the 8192
  support from ckpt_26: the first rq within 1e-6 Ha of JAX's, nothing
  NaN. Kernel #1 launches once for each full energy, kernels #1 and #2
  twice and kernel #3 once for each pinned step; kernel #1 at the full
  energy's 16,384 rows equals its plain version bit for bit.

Last, the C2H4/6-31G CISD -> support-CI chain (the JAX package's
``runs/c2h4_cisd_made``, ``runs/c2h4_sci`` and
``runs/c2h4_cisd_transformer_emp_lr0.0001`` at full width: 52 qubits,
MADE-2048 with a 512-wide phase net and the 8-head transformer,
qubit_per_qudit 4, 8192 Gumbel samples, prefilter at (768, 4096); the
packaged CISD vector, selected-CI target and JAX states ckpt_4000, ckpt_47
and ckpt_3000), counts set to 0 before (c) and read after (f):

- (a) The spin-orbital integrals rebuilt from the packaged spatial form,
  and the host's H over the CISD vector's top 4096 with its ground state
  within 1e-8 Ha of the JAX package's.
- (b) 100 pretraining steps of a fresh MADE-2048 on the CISD vector at
  batch 8192: the loss falls.
- (c) ckpt_4000 in ``cisd_pretrain_vmc``'s MADE trainer (MinSR top 50,
  clip 0.5, Born weights): steps at lr 0, the overflow policy after each,
  until one drops no row; its ``found_pairs`` equal to a host count, its
  energy within 1e-4 Ha of the float64 Rayleigh quotient over its own set
  and within 1 mHa of JAX's last rows; then ``run()`` for 5 steps.
- (d) ckpt_47: ``support_rayleigh`` over the target's top 8192 within 1e-5
  Ha, and the example's polish loss and mass (temperature 4, linear lam
  30, chunks of 8192) over all 262,144 rows within 1e-5 relative, of the
  JAX package's float32 CPU values; one sampled full energy at 8192 (row
  chunks of 1024) within 0.05 mHa of the TPU's confirmations.
- (e) 20 full-batch polish steps at 262,144 rows from ckpt_47, 50
  distillation steps from ckpt_4000, and on the top-8192 support from
  ckpt_47 5 ``support_vmc`` steps (rq), 5 ``rq_refit`` steps (beta 0.05,
  clip 1.0) and 10 L-BFGS evaluations: the losses fall, every rq finite
  and the first ckpt_47's.
- (f) The transformer (ckpt_3000, 'highest'): log|psi| over the target's
  top 512 against JAX's float32 values (``data/c2h4_transformer_logpsi.
  npz``; 1e-5 + 1e-5 |la|, the phase to 1e-4), a clean step at lr 0 in its
  trainer (empirical weights, no SR) against the host as in (c), and a
  sampled full energy at 512 (row chunks of 128): finite. Kernels #1 and
  #2 launch twice a step, kernel #3 once a step, kernel #1 once a row
  chunk of each full energy.
- (g) Kernel #1 at the full energy's row chunk (1024) and whole sample
  (8192) against its plain version, bit for bit.

Last, the host chemistry layer and direct CI (``chem_build_phase``), counts
set to 0 before (b) and read after it:

- (a) N2/STO-3G at 2.0 angstrom built from atoms by ``Molecule.create``
  into a temporary ``mols_dir``: HF, CISD and FCI within 1e-8 Ha of the JAX
  package's record (``N2_R_*``); kernel #1 against its plain version at
  its Hamiltonian (9454 terms in 1744 groups).
- (b) ``DISSOCIATION_STEPS`` steps of ``experiments.dissociation_curve``
  (exact summation over the 14,400 determinants, MADE 512, qubit_per_qudit
  10, MinSR top 50, clip 1.0, Adam 1e-3) on it through its ``main``: every
  energy finite and at or above FCI - 1e-6 Ha (an exact energy is a
  Rayleigh quotient), the curve's CSV under JAX's header; kernel #1 once a
  step.
- (c) The direct-CI sigma at a random vector (numpy ``--seed``) of that
  molecule's sector: float64 on the card against ``host_sigma_f64`` to
  1e-10 relative, float32 against float64 to 1e-5; the float32/float64
  pair again over Li2O's 41,409,225 determinants.
- (d) Li2O/STO-3G's FCI by ``direct_ci_ground_state`` on the card from the
  packaged integrals: within 2e-6 Ha of the JAX package's record and its
  ipr within 1e-4, and its vector's quotient over the string tables rounded
  to float32 (the record's arithmetic) within 1e-8 Ha of the record; the
  Davidson iterations and the residual printed.

Last, Cr2/SV at 84 qubits (``cr2_phase``: the JAX package's
``examples/cr2_step.py`` and ``cr2_train.py`` at full width through
``experiments.vmc.cr2_vmc``: three words a determinant, 2,240,694 terms in
471,774 groups, MADE 1024 with logit_cap 8, qubit_per_qudit 6, 1024
Gumbel samples and the 64 pinned HF neighbours, prefilter membership in
128-row blocks at capacities (1024, 64), the 'grouped' group order),
counts set to 0 before (e) and read after (f):

- (a) The packaged molecule (``data/cr2_sv.npz``, built by the port)
  loaded; its sizes and sector exactly, HF and MP2 within 1e-8 Ha of the
  JAX record (``CR2_*``).
- (b) Kernel #1 on its W = 3 tables: ``CR2_CHECK_ROWS`` rows of a set of
  the packaged JAX state ckpt_1000 bit for bit against its plain version.
- (c) Kernel #2 and its tag build bit for bit against their plain
  versions at K 3 / E 16 on that set's table (the partners of
  ``CR2_LOOKUP_ROWS`` rows), at K 4 / E 16 on a random 100-qubit table
  and at K 2 / E 8 and E 16 on random 64-qubit tables (numpy
  ``CR2_SEED``).
- (d) Prefilter, hash and search membership on that set: the same pairs,
  t within 1e-6 of max|t|, no row dropped; kernel #3 (stage 1) on the
  set's first 128-row block against the set's fingerprint table (nb 512 x
  E 16, in shared memory), bit for bit its plain version.
- (e) ckpt_1000, one step at lr 0: within 2 mHa of the JAX run's tail-50
  mean, ``found_pairs`` equal to a host count, and the step's float64
  estimator within 1e-4 Ha of the float64 Rayleigh quotient over its own
  set built from the integrals (``chem/fci.matrix_element`` on every pair
  with popcount(x ^ y) <= 4; the step reports that estimator rounded to
  float32, as JAX's does, 2.4e-4 Ha a unit at 2086 Ha).
- (f) ``CR2_STEPS`` steps from random weights (seed 0): finite energies;
  kernels #1 and #2 (and the tag build) once a row block and once for the
  dense rows each step, kernel #3 once a row block (9 a step).

Last, the ansatz and step options of the JAX package (``options_phase``),
from seed 0 at full width, each leg's launches counted from 0 (paths
``options_spin_flip``, ``options_sign``,
``options_perm``, ``options_li2o``, ``options_ensemble``):

- (a) N2 main path with ``spin_flip_abs``, ``spin_flip_phase`` and
  ``couple_spin_flip``, 5 steps: over step 0's set, log|psi(flip x)| =
  log|psi(x)| and psi(flip x) = (-1)^(n_open/2) psi(x) to 2e-5; its
  ``found_pairs`` equal to a host count and its energy within 1e-4 Ha of
  the float64 Rayleigh quotient over the set.
- (b) N2 with the signs of its sector FCI vector (the port's own solve) as
  a 2^20 ``sign_structure``, 3 steps: every phase its table entry exactly;
  the energy against the quotient as in (a).
- (c) N2 in exact summation with ``qubit_perm`` = alpha orbitals first,
  then beta, 3 steps: the permuted Hamiltonian's sector FCI equal to the
  unpermuted one to 1e-8 Ha; step 0 within 1e-5 Ha of the float64 quotient
  over the permuted sector.
- (d) The Li2O toy model with ``head_mode='log_psi'``, 'sanqs_paper'
  activations, hidden widths (512, 512), biases (on, on, off),
  ``masking_depth=1``, ``compute_dtype='bfloat16'``,
  ``topk_impl='bisect'`` and MinSR without regularisation, 3 steps:
  bfloat16 storage bit for bit the CPU's and log|psi| within 5e-3 of a CPU
  copy; ``exact_top_k`` equal to the ordered top-k bit for bit on the last
  frontier; finite energies; step 0's ``found_pairs`` equal to a host
  count (hash membership: masking depth lets samples leave the
  sector).
- (e) N2 as a 4-replica ensemble (``init_ensemble_state``,
  ``_multi_step_ensemble``), 3 steps each: every replica's energies within
  2e-5 relative of a standalone run at its seed; replicas 0 and 1 apart.

Last, the spin chains (``spin_phase``: ``VMC(ham=, masker=, ref_det=)``
on ``applications/spin_systems.py``'s Hamiltonians), from seed 0, each
path's launches counted from 0 (paths ``spin_dm6``, ``spin_xxz8``,
``spin_tfi10``, ``spin_tfi64``, ``spin_dm40``):

- (a) Three trainings through ``run()`` with the settings and bounds of
  the JAX package's tests (qubit_per_qudit 2, MADE 64, lr 1e-2, windows of
  50): the XY+DM chain at 6 sites (64 samples, 800 steps; best within 1%
  of ``exact_ground_energy``), XXZ at 8 sites in Sz = 0 from the Neel
  state (128 samples, 1200 steps; 1%), the critical TFI chain at 10 sites
  (1024 samples, 1000 steps; 0.5%, last ``energy_var`` < 0.1); each best
  above the exact energy less 1e-3.
- (b) The open TFI chain at 64 sites (W 2) at full width (MADE 512,
  qubit_per_qudit 4, 8192 Gumbel samples, MinSR top 50, clip 1.0, Adam
  1e-3; the main net's output layer scaled by ``SPIN_SHARPEN`` so that
  the set holds connected pairs), 'auto' membership (prefilter: kernels
  #1 and #2 twice a step, kernel #3 once), 5 steps: step 0's ``found_pairs`` equal to a host count and its energy
  within 1e-4 Ha of the float64 Rayleigh quotient over its set; every
  energy at or above the free-fermion E0 = -81.1259801 less 1e-4 of |E0|.
- (c) The XY+DM chain at 40 sites (W 2, two groups on each flip mask: the
  real and the odd-Y channel), the same net and sampler under hash
  membership, 5 steps: 'auto' membership refused; step 0's pairs, its
  quotient and every row's e_re and e_im (to 1e-4 of max|e|) against a
  float64 complex host oracle (``host_local_energies``); each step's mean
  imaginary energy within 1e-5 of max(|E|, 1 Ha); every energy at or
  above the free-fermion E0 = -58.5609429 less 1e-4 of |E0|; kernel #1 on
  the set bit for bit against its plain version.

Then the data-parallel path (``mesh``; ``experiments/dryrun_multichip.py``'s
legs, each rank a spawned process of a ``torch.distributed`` group, the
kernels built by this script before the spawn): NCCL at 1 rank, then gloo
at 4 ranks sharing the card and, in the same spawn, at 2 (a sub-group of
its first two ranks; gloo's collectives stage the card's tensors through
the host; NCCL takes one rank a card):

- ``li2o``: the Li2O toy model's state at seed 0 (8192 Gumbel samples of
  MADE 512), its local energies under 'hash_dist' (each rank's bucket
  shard answered by kernel #2, kernel #1 on its rows) gathered, equal bit
  for bit to one process's 'hash';
- ``n2``: the N2 flagship (``main_path_vmc``) one step on the mesh against
  one process, every metric within 1e-4 + 3e-4 |a|, then 3 steps more;
- at 2 ranks ``n2_run`` (N2 through ``run()``, 6 steps in windows of 3,
  the full energy and a checkpoint every 3; rank 0's ``result.csv``
  against one process's rows, every column within 1e-5 + 1e-4 |a|), and
  at 2 and 4 ranks ``li2o_tight`` (Li2O's
  membership with both routing slacks at 1.0: overflow reported, no false
  hit, equal values where found).

Every rank reports its launches of kernels #1, #2, the tag build and #3 in
each leg, each nonzero where the leg runs the kernel.

The script checks; it does not time. A kernel's time on the card and its
roofline share are the benchmark's (``benchmark/run.py --trace 1``).

Every line is flushed as it is printed. The line before the last is
``{"kernels": [...]}`` (each kernel's largest |kernel - plain| and its
launches on each path), the last ``{"ok": true, "device": {...}}``; any
failed check exits non-zero before either. Imports torch, numpy, scipy and
the port only.
"""

import json
import os
import re
import subprocess
import sys
import time

T_START = time.monotonic()
# The script's own guard: half the 1200 s within which a run must exit.
TIME_LIMIT_S = 600.0
ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
EXACT_STEPS = 3
DRIVER_STEPS = 6
MULTINOMIAL_STEPS = 3
# The header of the result.csv that the JAX package's ``VMC.run`` writes
# (its sorted metric names, then the driver's four columns).
JAX_CSV_HEADER = (
    "dropped,energy,energy_imag,energy_var,found_pairs,found_ratio,"
    "grad_norm,hf_log_abs,hf_proj_energy,ipr,max_log_abs,min_log_abs,"
    "pf_dropped_rows,sampled_prob,table_overflow,unique_num,iter_idx,"
    "wall_time,full_energy,full_energy_var"
)
# Kernel #1 vs its plain version: the same rounding contract, and float64
# sums of +-bf16 values are exact in any order, so they agree bit for bit.
ME_TOL = 0.0
C2H4_ROWS = 8192  # examples/c2h4_support_ci.py's sample_num
HASH_TOL = 0.0  # a gather and a select: kernel and plain agree bit for bit
# Li2O's set in a table above the lookup's shared-memory tier (nb 65536).
HASH_BIG_EXTRA_BITS = 6
# The N2 main path's energies from its first runs on the card (NVIDIA H100
# 80GB HBM3, 700 W, torch 2.11.0+cu128): same weights, sampler and
# arithmetic, so a run reproduces them to float32 rounding.
N2_ENERGIES = (-78.008568, -78.132286, -78.260254, -78.394211, -78.530220)
# The JAX Li2O NADE campaign's records: the CISD energy of its saved vector
# (runs/li2o_cisd_vector.npz, 4425 determinants), and the closure leg at
# the state the port ships (runs/li2o_closure/result.csv, last 100 rows:
# energy -88.699219 to -88.699272 Ha, found_pairs 657750-667566,
# pf_dropped_rows 0 at capacities (768, 4096)), medians.
LI2O_CISD_ENERGY = -88.69115259556716
LI2O_CISD_DETS = 4425
LI2O_CLOSURE_ENERGY = -88.699265
LI2O_CLOSURE_PAIRS = 662700
NADE_PRETRAIN_STEPS = 200
NADE_RUN_STEPS = 12
NADE_DISTILL_PERIOD = 5
POLISH_STEPS = 20
DISTILL_STEPS = 50
PIN_STEPS = 3
SUPPORT_VMC_STEPS = 5
LBFGS_EVALS = 10
# The Li2O support-CI closure (the JAX package's runs/li2o_sci): the
# restricted ground energy of the target's top 8192 determinants by |coef|
# (tests/test_torch_native.py::test_li2o_top8192_energy), and the JAX
# package's float32 values on the CPU for the packaged states, each computed
# by the test named beside it in tests/test_torch_li2o_sci.py: ckpt_26's
# Rayleigh quotient over that support (test_ckpt26_rayleigh_matches_jax),
# its ``support_ci.polish`` loss and mass over the whole target at
# temperature 2, linear lam 30 (test_ckpt26_polish_loss_matches_jax), and
# ckpt_13's loss of ``examples/li2o_sci_polish.py`` at temperature 4,
# quadratic lam 1000 (test_ckpt13_example_loss_matches_jax).
LI2O_SCI_TOP = 8192
LI2O_SCI_TOP_E0 = -88.7053389233
LI2O_SCI_CKPT26_RAYLEIGH = -88.705312172438
LI2O_SCI_CKPT26_LOSS = 0.7433463931
LI2O_SCI_CKPT26_MASS = 0.9999099970
LI2O_SCI_CKPT13_LOSS = 1.5286744833
# ckpt_26's exact restricted quotient of the complex amplitudes exp(la + i
# ph) over the top 8192, as ``support_vmc`` reports it at its first step
# (test_ckpt26_support_vmc_rq_matches_jax); it differs from the real
# projection's above because ckpt_26's phases are not all 0 or pi.
LI2O_SCI_CKPT26_RQ = -88.705280948815
# The TPU's records of the same quantities (its default-precision matmuls;
# runs/li2o_sci/polish_summary_lam30_lin.json, runs/logs/
# li2o_sci_polish2.log), printed beside the port's, not gated.
TPU_CKPT26_LOSS = 0.7428562641
TPU_CKPT26_MASS = 0.999917209
TPU_CKPT13_LOSS = 1.528461
# Five sampled full energies of ckpt_26 at 16,384 on the TPU
# (runs/li2o_sci/confirm_energies.npy), their mean; the pinned-VMC leg's
# iteration 0 from ckpt_13 (runs/logs/li2o_pin.log).
LI2O_SCI_CONFIRM_ENERGY = -88.705147
LI2O_PIN_STEP0_ENERGY = -88.702309
# The C2H4/6-31G CISD -> support-CI chain (``c2h4_cisd_sci_phase``): the
# JAX package's runs at their full width, ``C2H4_ROWS`` samples, the full
# energy in row chunks of 1024 (the transformer's: 512 samples in chunks
# of 128, cut from 1024 to keep the whole script inside its time limit
# with the Cr2 phase; a sampled full energy is checked only for being
# finite).
C2H4_ROW_CHUNK = 1024
C2H4_TR_FULL_SAMPLES = 512
C2H4_TR_ROW_CHUNK = 128
C2H4_PRETRAIN_STEPS = 100
C2H4_RUN_STEPS = 5
C2H4_CISD_DETS = 29593
C2H4_CISD_TOP = 4096
# The JAX package's values on the CPU (``tests/test_torch_c2h4_sci.py``
# recomputes each): ``restricted_ground_state`` over the top 4096 of the
# packaged CISD vector; ckpt_47's ``support_rayleigh`` over the target's
# top 8192 and its ``polish`` loss and mass over all 262,144 rows
# (temperature 4, linear lam 30, chunks of 8192; float32).
C2H4_CISD_TOP_E0 = -78.19798892093382
C2H4_SCI_TOP = 8192
C2H4_SCI_CKPT47_RAYLEIGH = -78.190076653442
C2H4_SCI_CKPT47_LOSS = 79.2032470703
C2H4_SCI_CKPT47_MASS = 0.9997919202
# The JAX runs' records: the mean energy of ``runs/c2h4_cisd_made``'s
# iterations 3997-3999 (-78.16374, -78.16380, -78.16377; ckpt_4000 is
# their end state), and the mean of the five TPU confirmations of ckpt_47
# (``runs/c2h4_sci/confirm_energies.npy``, std 2.5e-6).
C2H4_MADE_RECORD_ENERGY = -78.16377
C2H4_SCI_CONFIRM_ENERGY = -78.1886096
# The molecule build from atoms and direct CI (``chem_build_phase``): N2/STO-3G
# at 2.0 angstrom against the JAX package's record (runs/n2_dissociation.csv,
# row 2.0: HF, CISD, FCI; host float64, so reproducible to ~1e-12), the
# dissociation recipe's exact steps on it, and Li2O/STO-3G's FCI by direct CI
# against the JAX package's (runs/li2o_fci_summary.json: the float64
# Rayleigh quotient and the ipr of its 41,409,225-determinant solve). That
# quotient upcasts float32 string tables; the port's takes float64 ones, and
# the port's vector with the tables rounded to float32 gives JAX's record to
# LI2O_JAX_TABLES_TOL.
N2_R = 2.0
N2_R_HF = -107.06729389526026
N2_R_CISD = -107.31528185085801
N2_R_FCI = -107.45515453326401
N2_R_TOL = 1e-8
DISSOCIATION_STEPS = 20
LI2O_FCI_ENERGY = -88.7054497444615
LI2O_FCI_IPR = 0.82054769548887
LI2O_FCI_TOL = 2e-6
LI2O_JAX_TABLES_TOL = 1e-8
LI2O_IPR_TOL = 1e-4
SIGMA64_TOL = 1e-10  # device float64 sigma vs host_sigma_f64, relative
SIGMA32_TOL = 1e-5  # device float32 sigma vs float64, relative
# Cr2/SV at 84 qubits (``cr2_phase``): the JAX package's records of its
# build (runs/cr2_prep_summary.json: sizes, HF, MP2) and of its training leg
# (runs/cr2_train/summary.json: the best energy and the mean of the last 50
# of 1000 iterations, whose end state ckpt_1000 the port ships).
CR2_TERMS = 2_240_694
CR2_GROUPS = 471_774
CR2_HF = -2085.787294075257
CR2_MP2 = -2086.294215432151
CR2_BEST = -2085.9443359375
CR2_TAIL50 = -2085.9428466796876
CR2_CHECK_ROWS = 128  # kernel #1 against its plain version
CR2_LOOKUP_ROWS = 32  # rows of the set whose partners query kernel #2
CR2_STEPS = 3
CR2_SEED = 0  # numpy seed of the random key tables
# The data-parallel phase: (backend, plan) of each spawn, a plan's entries
# (ranks, legs) run in turn on the spawn's first ranks.
MESH_RUNS = (
    ("nccl", ((1, ("li2o", "n2")),)),
    ("gloo", ((4, ("li2o", "n2", "li2o_tight")),
              (2, ("li2o", "n2", "n2_run", "li2o_tight")))),
)
# Kernels each leg must launch on every rank.
MESH_KERNELS = {
    "li2o": ("fused_matrix_elements", "hash_lookup", "hash_tags"),
    "n2": ("fused_matrix_elements",),
    "n2_run": ("fused_matrix_elements",),
    "li2o_tight": ("hash_lookup", "hash_tags"),
}
# An H100 SM's INT32 pipe: 64 lanes (logic, shifts, compares), the pipe
# that kernel #3's operations (``fp_filter_ops``) go through.
INT32_LANES_PER_SM = 64


class SmokeFailure(Exception):
    pass


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def me_check(torch, label, words, tables):
    """Kernel #1 against its plain version on ``words``, bit for bit.
    Returns max|kernel - plain|; fails on any disagreement."""
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        fused_matrix_elements,
        matrix_elements_plain,
    )

    me = fused_matrix_elements(words, tables)
    plain = matrix_elements_plain(words, tables)
    torch.cuda.synchronize()
    shape = (words.shape[0], tables.n_groups)
    check(me.shape == shape, f"{label}: shape {tuple(me.shape)}")
    check(bool(torch.isfinite(me).all()), f"{label}: non-finite elements")
    err = float((me - plain).abs().max())
    same = bool(torch.equal(me, plain))
    n_rows, n_terms = words.shape[0], tables.splits.shape[1]
    log(f"kernel fused_matrix_elements at {label}: B={n_rows} T={n_terms} "
        f"M={tables.n_groups} W={words.shape[1]} max|kernel - plain| = "
        f"{err:.3e} Ha (tol {ME_TOL:g}), bit-identical {same}")
    check(same and err <= ME_TOL,
          f"kernel #1 disagrees with its plain version at {label}: {err}")
    return err


def kernel_phase(torch, mol, words):
    """Kernel #1 at N2's tables on the whole sector against its plain
    version and, on the first rows, the float64 host reference. Returns
    max|kernel - plain|."""
    from anqs_quantum_chemistry_torch.chem.fci import sector_matrix_elements
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        build_tables,
        fused_matrix_elements,
    )

    ham = mol.qubit_ham
    tables = build_tables(ham, "cuda")
    err = me_check(torch, "N2", words, tables)

    # Float64 host reference on the first rows (one float32 rounding).
    rows = 512
    me = fused_matrix_elements(words[:rows], tables)
    dets = words[:rows, 0].cpu().numpy().astype("uint64")
    ref = torch.from_numpy(sector_matrix_elements(ham, dets))
    got = me.cpu().double()
    ref_err = float(((got - ref).abs() - 2.4e-7 * ref.abs()).max())
    log(f"kernel vs float64 host reference ({rows} rows): max excess over "
        f"one float32 ulp = {ref_err:.3e} Ha")
    check(ref_err <= 1e-6, "kernel disagrees with the float64 reference")
    return err


def c2h4_phase(torch):
    """Kernel #1 at the full C2H4/6-31G tables on ``C2H4_ROWS`` random
    determinants of its (8, 8) sector (numpy, seed 0). Returns
    max|kernel - plain|."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import (
        random_sector_dets,
        sector_matrix_elements,
    )
    from anqs_quantum_chemistry_torch.chem.molecule import load_c2h4
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        build_tables,
        fused_matrix_elements,
    )

    mol = load_c2h4()
    ham = mol.qubit_ham
    dets = random_sector_dets(mol.n_orbitals, mol.n_alpha, mol.n_beta,
                              C2H4_ROWS, np.random.default_rng(0))
    words = np.stack([dets & np.uint64(0xFFFFFFFF), dets >> np.uint64(32)],
                     axis=1).astype(np.int64)
    words = torch.from_numpy(words).cuda()
    tables = build_tables(ham, "cuda")
    err = me_check(torch, "C2H4", words, tables)
    rows = 64
    me = fused_matrix_elements(words[:rows], tables).cpu().double()
    ref = torch.from_numpy(sector_matrix_elements(ham, dets[:rows]))
    ref_err = float(((me - ref).abs() - 2.4e-7 * ref.abs()).max())
    log(f"C2H4 kernel vs float64 host reference ({rows} rows): max excess "
        f"over one float32 ulp = {ref_err:.3e} Ha")
    check(ref_err <= 1e-6, "C2H4: kernel disagrees with the float64 "
          "reference")
    return err


def _counted_kernels():
    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        fp_filter,
        hash_lookup,
        hash_tags,
    )
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        fused_matrix_elements,
    )

    return {"fused_matrix_elements": fused_matrix_elements,
            "hash_lookup": hash_lookup, "hash_tags": hash_tags,
            "fp_filter": fp_filter}


def reset_launches():
    for wrapper in _counted_kernels().values():
        wrapper.launches = 0


def read_launches():
    return {name: wrapper.launches
            for name, wrapper in _counted_kernels().items()}


def membership_crosscheck_phase(torch, mol, vmc):
    """Dynamic membership ('hash', 'table') against the sector path on the
    N2 main path's full-sector batch: the same pairs found, the same
    overflow-free numerators t to 1e-6 relative (float32 sums of the same
    terms)."""
    from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine

    words = vmc.sector_words
    valid = torch.arange(words.shape[0], device="cuda") < mol.fci_ndet
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
        ref = vmc.engine.local_energy_sector(
            words, la, ph, valid, vmc.sector_words, vmc.sector_partner_idx,
            vmc.sector_partner_found, sector_pos=vmc.sector_pos,
        )
        scale = float(torch.max(torch.abs(ref.t_re)))
        for membership in ("hash", "table"):
            eng = PauliEngine(mol.qubit_ham, device="cuda",
                              membership=membership)
            e = eng.local_energy_proxy(words, la, ph, valid)
            err = max(float(torch.max(torch.abs(e.t_re - ref.t_re))),
                      float(torch.max(torch.abs(e.t_im - ref.t_im))))
            log(f"N2 {membership} membership: found_pairs "
                f"{int(e.found_pairs)} (sector path "
                f"{int(ref.found_pairs)}), table_overflow "
                f"{int(e.table_overflow)}, max|t - t_sector| = {err:.3e} "
                f"(max|t| {scale:.3e})")
            check(int(e.found_pairs) == int(ref.found_pairs),
                  f"{membership} membership finds other pairs than the "
                  "sector path")
            check(int(e.table_overflow) == 0,
                  f"{membership} membership overflowed on N2")
            check(err <= 1e-6 * scale,
                  f"{membership} membership: t disagrees with the sector "
                  "path")


def trainer_phase(torch, mol, vmc):
    """5 steps of the main path; returns the kernel launches they made."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import sector_hamiltonian

    state = vmc.init_state()

    # Reference for the first step's energy: the Rayleigh quotient of the
    # initial weights over the whole sector, with the float64 sector
    # Hamiltonian built on the host from the Pauli terms.
    n_real = mol.fci_ndet
    sector = vmc.sector_words[:n_real]
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(sector)
    psi = np.exp(la.double().cpu().numpy() + 1j * ph.double().cpu().numpy())
    dets = sector[:, 0].cpu().numpy().astype(np.uint64)
    h = sector_hamiltonian(mol.qubit_ham, dets)
    e_ref = float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)

    reset_launches()
    rows = []
    for i in range(STEPS):
        row = vmc.step(state)
        rows.append(row)
        log(f"step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f} launches {read_launches()}")
    launches = read_launches()

    e_fci = mol.fci_energy
    log(f"E_FCI {e_fci:.6f}; step-0 Rayleigh quotient reference "
        f"{e_ref:.6f} (|step 0 - ref| = {abs(rows[0]['energy'] - e_ref):.2e}"
        " Ha)")
    for i, row in enumerate(rows):
        check(int(row["unique_num"]) == n_real,
              f"step {i}: unique_num {row['unique_num']} != {n_real}")
        check(np.isfinite(row["energy"]), f"step {i}: energy not finite")
        check(row["energy"] >= e_fci - 1e-5,
              f"step {i}: energy {row['energy']} below E_FCI {e_fci}")
    # float32 amplitudes and matrix elements against float64: ~1e-6
    # relative at |E| ~ 100 Ha.
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "step-0 energy disagrees with the Rayleigh quotient")
    drift = max(abs(r["energy"] - e) for r, e in zip(rows, N2_ENERGIES))
    log(f"max |energy - first card run| = {drift:.2e} Ha")
    check(drift <= 1e-5, "N2 energies moved from the first card run's")
    check(launches == {"fused_matrix_elements": STEPS, "hash_lookup": 0,
                       "hash_tags": 0, "fp_filter": 0},
          f"N2 path launched {launches} in {STEPS} steps")
    return launches


def li2o_sample(torch, vmc, seed):
    """A canonically sorted 8192-row Li2O sample set and its amplitudes,
    drawn with its own generator (the trainer's stays untouched)."""
    from anqs_quantum_chemistry_torch.ops import keys
    from anqs_quantum_chemistry_torch.ops.bits import MASK32
    from anqs_quantum_chemistry_torch.sampling.sampler import sample

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        words, _, valid, _ = sample(vmc.anqs, vmc.sampling_config, gen)
        words = torch.where(valid[:, None], words, MASK32)
        words, _, valid = keys.sort_words(words, valid)
        la, ph = vmc.anqs.log_psi(words)
    return words, valid, la, ph


def fp_filter_ops(n_words, entries):
    """(INT32-pipe instructions, multiplies) a partner of kernel #3 with
    keys of K = max(W, 2) words and E = ``entries`` slots a bucket: what
    its hashing and compares take in the SASS of ``fp_filter_kernel``
    (sm_90a; 46 and 11 at K 3, E 16, 51 and 5 at K 2, E 32): K key XORs
    and the K - 1 folded mix2 and fp32 rounds, each 3 shifts and 3 XORs
    (LOP3, three inputs at a time; the bucket mask and the fingerprint's
    low bit fold into the last), the E compares with their OR folded into
    the predicates (ISETP.EQ.OR, E / 8 PLOP3) and one SEL; the rounds'
    multiplies (IMAD, on the FMA pipe), the first of mix2 and fp32 shared.
    Addresses, bounds tests and branches are not counted."""
    k = max(n_words, 2)
    return 12 * (k - 1) + k + entries + entries // 8 + 1, 6 * (k - 1) - 1


def fp_filter_check(torch, label, fptab, words, a_cols):
    """Kernel #3 (the prefilter's stage 1) alone on ``words`` against
    ``fptab``: bit for bit its plain version."""
    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        fp_filter,
        fp_filter_plain,
        fp_in_shared_memory,
    )

    words = words.contiguous()
    with torch.no_grad():
        got = fp_filter(fptab, words, a_cols)
        want = fp_filter_plain(fptab, words, a_cols)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"kernel fp_filter at {label}: {int((got != want).sum())} "
              "entries differ from its plain version")
    (b, w), m, (nb, e) = words.shape, a_cols.shape[1], fptab.shape
    log(f"kernel fp_filter at {label} (B {b}, W {w}, M {m}, nb {nb} x E "
        f"{e}, {'shared' if fp_in_shared_memory(nb, e) else 'global'} "
        f"memory): {int(got.sum())} hits, equal")


def hash_lookup_phase(torch, vmc):
    """Kernel #2 and its tag build against their plain versions, bit for
    bit, on three tables: Li2O's (8192 sampled rows, queries of all 3072
    groups), a two-word set with real high words, and Li2O's set in a table
    above the shared-memory tier. Also holds kernel #1 against its plain
    version at Li2O's shapes. Returns max|kernel - plain| of the lookup,
    the tag build and kernel #1."""
    import copy

    import numpy as np

    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        ENTRIES,
        hash_lookup,
        hash_lookup_plain,
        hash_tags,
        hash_tags_plain,
        tags_in_shared_memory,
    )

    eng = vmc.engine
    words, valid, la, ph = li2o_sample(torch, vmc, seed=1)
    check(int(valid.sum()) == vmc.config.sample_num, "Li2O sample short")
    tab, nb, overflow = eng._hash_build(words, la, ph, valid)
    (q_lo,) = eng._hash_queries(words)
    q_hi = None  # one-word keys: no high words

    def compare(label, tab, q_lo, q_hi):
        tags = hash_tags(tab)
        tags_plain = hash_tags_plain(tab)
        tags_equal = bool(torch.equal(tags, tags_plain))
        tag_err = float((tags.int() - tags_plain.int()).abs().max())
        got = hash_lookup(tab, q_lo, q_hi)
        want = hash_lookup_plain(tab, q_lo, q_hi)
        torch.cuda.synchronize()
        bits_equal = all(
            bool(torch.equal(g.view(torch.int32), w.view(torch.int32)))
            for g, w in zip(got[:2], want[:2])
        ) and bool(torch.equal(got[2], want[2]))
        err = max(float(torch.max(torch.abs(g - w))) for g, w in
                  zip(got[:2], want[:2]))
        tier = ("shared memory" if tags_in_shared_memory(tab.shape[0])
                else "global memory")
        log(f"kernel hash_lookup ({label}): Q={q_lo.numel()} "
            f"nb={tab.shape[0]} ({tab.numel() * 4 / 1024:.0f} KB, tags "
            f"{tab.shape[0] * ENTRIES / 1024:.0f} KB in {tier}) found "
            f"{int(got[2].sum())} max|kernel - plain| = {err:.3e}, "
            f"bit-identical {bits_equal}; kernel hash_tags bit-identical "
            f"{tags_equal} ({int((tags != 0).sum())} live slots)")
        check(bits_equal and err <= HASH_TOL,
              f"hash_lookup kernel disagrees with its plain version "
              f"({label})")
        check(tags_equal and tag_err <= HASH_TOL, f"hash_tags kernel "
              f"disagrees with its plain version ({label})")
        return err, tag_err

    log(f"Li2O hash table: nb={nb}, table_overflow {int(overflow)}")
    check(int(overflow) == 0, "Li2O hash table overflowed")
    check(tags_in_shared_memory(nb), "Li2O's tags not in shared memory")
    err, tag_err = compare("Li2O, W=1", tab, q_lo, q_hi)

    # Two-word keys with real high words: hits, misses that share key_lo
    # with an entry (only key_hi tells them apart), random misses, and keys
    # whose bits read as a float NaN or as the empty-slot NEG.
    rng = np.random.default_rng(7)
    n = 8192
    keys2 = rng.integers(0, 1 << 32, (n, 2), dtype=np.int64)
    keys2[:4] = [[0x7FC00001, 0xFFC00000], [0xF149F2CA, 0xF149F2CA],
                 [0xF149F2CA, 0], [0xFFFFFFFF, 0xFFFFFFFF]]
    words2 = torch.from_numpy(keys2).cuda()
    valid2 = torch.ones(n, dtype=torch.bool, device="cuda")
    valid2[-64:] = False
    la2 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    ph2 = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32)).cuda()
    tab2, _, overflow2 = eng._hash_build(words2, la2, ph2, valid2)
    check(int(overflow2) == 0, "two-word hash table overflowed")
    pick = rng.integers(0, n, 1 << 20)
    q2 = keys2[pick].copy()
    kind = rng.integers(0, 3, len(pick))
    q2[kind == 1, 1] ^= rng.integers(1, 1 << 32, int((kind == 1).sum()))
    q2[kind == 2] = rng.integers(0, 1 << 32, (int((kind == 2).sum()), 2))
    q2 = torch.from_numpy(q2.astype(np.uint32).view(np.int32)).cuda()
    errs = compare("random keys, W=2", tab2, q2[:, 0].contiguous(),
                   q2[:, 1].contiguous())
    err, tag_err = max(err, errs[0]), max(tag_err, errs[1])
    del tab2, q2

    # Li2O's set as the overflow policy would grow its table.
    big_eng = copy.copy(eng)
    big_eng.hash_extra_bits = HASH_BIG_EXTRA_BITS
    tab_big, nb_big, overflow_big = big_eng._hash_build(words, la, ph, valid)
    check(int(overflow_big) == 0 and not tags_in_shared_memory(nb_big),
          f"large table: nb {nb_big}, overflow {int(overflow_big)}")
    errs = compare(f"Li2O, W=1, hash_extra_bits {HASH_BIG_EXTRA_BITS}",
                   tab_big, q_lo, q_hi)
    err, tag_err = max(err, errs[0]), max(tag_err, errs[1])
    del tab_big

    # Kernel #1 at Li2O's shapes.
    return err, tag_err, me_check(torch, "Li2O", words, eng.me_tables)


def li2o_trainer_phase(torch, vmc):
    """5 steps of the Li2O toy model; returns the kernel launches."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import sector_hamiltonian
    from anqs_quantum_chemistry_torch.chem.jw import words_to_ints

    state = vmc.init_state()
    # Step 0's own sample set, replayed: the generator's state is restored,
    # so step 0 draws the same uniforms.
    gen_state = state.generator.get_state()
    words, _, valid, _, la, ph, _ = vmc._support_and_eloc(state)
    state.generator.set_state(gen_state)
    keep = valid.cpu().numpy()
    dets = words[:, 0].cpu().numpy().astype(np.uint64)[keep]
    psi = np.exp(la.double().cpu().numpy()[keep]
                 + 1j * ph.double().cpu().numpy()[keep])

    def progress(i, row):
        log(f"Li2O step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"table_overflow {int(row['table_overflow'])} grad_norm "
            f"{row['grad_norm']:.4f} launches {read_launches()}")

    # ``run`` starts from ``init_state()`` again: the same weights and
    # generator as the replay above.
    reset_launches()
    _, rows, _ = vmc.run(STEPS, checkpoint_every=None, on_iter=progress)
    launches = read_launches()

    ham = vmc.ham
    a = words_to_ints(ham.a_masks)
    host_pairs = int(np.isin(dets[:, None] ^ a[None, :], dets).sum())
    h = sector_hamiltonian(ham, dets)
    e_ref = float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)
    log(f"Li2O step 0 on the host: "
        f"found_pairs {host_pairs}, Rayleigh quotient over its "
        f"{len(dets)} determinants {e_ref:.6f} (|step 0 - ref| = "
        f"{abs(rows[0]['energy'] - e_ref):.2e} Ha); HF "
        f"{vmc.mol.hf_energy:.6f}")
    for i, row in enumerate(rows):
        check(int(row["unique_num"]) == vmc.config.sample_num,
              f"Li2O step {i}: unique_num {row['unique_num']}")
        check(int(row["table_overflow"]) == 0,
              f"Li2O step {i}: table_overflow {row['table_overflow']}")
        check(np.isfinite(row["energy"]), f"Li2O step {i}: energy")
    check(int(rows[0]["found_pairs"]) == host_pairs,
          "Li2O step-0 found_pairs disagrees with the host count")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "Li2O step-0 energy disagrees with the Rayleigh quotient")
    check(launches == {"fused_matrix_elements": STEPS, "hash_lookup": STEPS,
                       "hash_tags": STEPS, "fp_filter": 0},
          f"Li2O path launched {launches} in {STEPS} steps")
    return launches


def sector_rayleigh(mol, vmc, words):
    """The float64 Rayleigh quotient of ``vmc``'s current weights over the
    N2 sector's first ``mol.fci_ndet`` rows of ``words`` (the host-built
    sector Hamiltonian)."""
    import numpy as np

    import torch
    from anqs_quantum_chemistry_torch.chem.fci import sector_hamiltonian

    sector = words[:mol.fci_ndet]
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(sector)
    psi = np.exp(la.double().cpu().numpy() + 1j * ph.double().cpu().numpy())
    dets = sector[:, 0].cpu().numpy().astype(np.uint64)
    h = sector_hamiltonian(mol.qubit_ham, dets)
    return float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)


def n2_exact_phase(torch, mol):
    """``EXACT_STEPS`` steps of the main path in exact summation (the whole
    sector, static membership) from the Gumbel path's initial weights,
    after one full-energy measurement. Returns the kernel launches of the
    steps."""
    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc

    vmc = main_path_vmc(device="cuda", sampling_mode="exact")
    check(vmc.exact_partner_idx is not None, "exact: no static membership")
    state = vmc.init_state()
    e_ref = sector_rayleigh(mol, vmc, vmc.exact_words)

    # The full energy of the initial weights over the whole sector: every
    # partner inside the sector is in the basis, so it is the Rayleigh
    # quotient too.
    words, valid = vmc.exact_words, vmc.exact_valid
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
        fe, _, fe_var = vmc._full_energy(words, la, ph, valid)
        fe = float(fe)
    log(f"N2 full energy at the initial weights: {fe:.6f} (|full - "
        f"Rayleigh quotient| = {abs(fe - e_ref):.2e} Ha), variance "
        f"{float(fe_var):.4e}; {words.shape[0] * vmc.engine.n_groups} "
        f"partners through the network")
    check(abs(fe - e_ref) <= 1e-4, "N2 full energy disagrees with the "
          "Rayleigh quotient")

    reset_launches()
    rows = []
    for i in range(EXACT_STEPS):
        row = vmc.step(state)
        rows.append(row)
        log(f"N2 exact step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f} launches {read_launches()}")
    launches = read_launches()
    log(f"N2 exact: step 0 {rows[0]['energy']:.6f}, Gumbel path's "
        f"{N2_ENERGIES[0]:.6f} (|diff| = "
        f"{abs(rows[0]['energy'] - N2_ENERGIES[0]):.2e} Ha), Rayleigh "
        f"quotient {e_ref:.6f} (|diff| = {abs(rows[0]['energy'] - e_ref):.2e}"
        f" Ha)")
    for i, row in enumerate(rows):
        check(int(row["unique_num"]) == mol.fci_ndet,
              f"exact step {i}: unique_num {row['unique_num']}")
        check(np.isfinite(row["energy"]), f"exact step {i}: energy")
    check(abs(rows[0]["energy"] - N2_ENERGIES[0]) <= 1e-5,
          "N2 exact step 0 disagrees with the Gumbel path's step 0")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "N2 exact step 0 disagrees with the Rayleigh quotient")
    check(launches == {"fused_matrix_elements": EXACT_STEPS,
                       "hash_lookup": 0, "hash_tags": 0, "fp_filter": 0},
          f"N2 exact launched {launches} in {EXACT_STEPS} steps")
    return launches


def n2_driver_phase(torch):
    """``run()`` of the main path into a temporary run directory: 6 steps,
    full energy every 3, checkpoints every 3, windows of 2 steps; then a
    run resumed from ``ckpt_3`` must repeat rows 3-5. Returns the kernel
    launches of the first run."""
    import tempfile

    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc

    with tempfile.TemporaryDirectory() as tmp:
        first, resumed = os.path.join(tmp, "run"), os.path.join(tmp, "resume")
        kw = dict(device="cuda", full_energy_period=3)
        vmc = main_path_vmc(run_dir=first, **kw)
        reset_launches()
        _, history, best = vmc.run(DRIVER_STEPS, checkpoint_every=3,
                                   steps_per_call=2)
        launches = read_launches()
        for row in history:
            log(f"N2 run row {row['iter_idx']}: energy {row['energy']:.6f} "
                f"full_energy {row['full_energy']:.6f} unique_num "
                f"{int(row['unique_num'])}")
        with open(os.path.join(first, "result.csv")) as f:
            lines = f.read().splitlines()
        files = sorted(os.listdir(first))
        log(f"N2 run: best {best['energy']:.6f} at iter "
            f"{best['iter']}, files {files}, launches {launches}")
        check(len(history) == DRIVER_STEPS and len(lines) == DRIVER_STEPS + 1,
              f"result.csv has {len(lines) - 1} rows")
        check(lines[0] == JAX_CSV_HEADER, f"result.csv header {lines[0]}")
        for name in ("config.json", "best_energy.npy", "ckpt_3", "ckpt_6"):
            check(name in files, f"run directory lacks {name}")
        measured = [r["iter_idx"] for r in history
                    if np.isfinite(r["full_energy"])]
        fe_gap = abs(history[3]["full_energy"] - history[3]["energy"])
        log(f"N2 run: full energy on rows {measured}; row 3 |full - energy|"
            f" = {fe_gap:.2e} Ha")
        check(measured == [3], f"full energy on rows {measured}")
        check(fe_gap <= 1e-4, "full energy disagrees with the energy")
        check(launches == {"fused_matrix_elements": DRIVER_STEPS + 1,
                           "hash_lookup": 0, "hash_tags": 0,
                           "fp_filter": 0},
              f"N2 run launched {launches}")

        vmc2 = main_path_vmc(run_dir=resumed, **kw)
        _, again, _ = vmc2.run(DRIVER_STEPS, checkpoint_every=3,
                               steps_per_call=2,
                               resume_from=os.path.join(first, "ckpt_3"))
        check([r["iter_idx"] for r in again] == [3, 4, 5],
              f"resumed rows {[r['iter_idx'] for r in again]}")
        diff = max(abs(a[k] - b[k]) for a, b in zip(history[3:], again)
                   for k in ("energy", "full_energy")
                   if np.isfinite(a[k]) or np.isfinite(b[k]))
        log(f"N2 resumed from ckpt_3: rows 3-5 energies "
            f"{[round(r['energy'], 6) for r in again]}, max |resumed - "
            f"uninterrupted| = {diff:.3e} Ha")
        check(diff <= 1e-6, "the resumed run does not repeat rows 3-5")
    return launches


def li2o_multinomial_phase(torch):
    """``MULTINOMIAL_STEPS`` steps of the Li2O toy model with multinomial
    sampling and the adaptive budget (``sample_precisely``, 4096 unique
    determinants targeted), the budget adapted after each step as ``run``
    does. Before each step its sample is drawn once more from a copy of
    the generator's state to check the counts. Returns the kernel
    launches of the steps."""
    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import li2o_vmc
    from anqs_quantum_chemistry_torch.sampling.sampler import (
        multinomial_sample,
    )

    vmc = li2o_vmc(device="cuda", sampling_mode="multinomial",
                   sample_precisely=True, target_unique=4096)
    cfg = vmc.config
    state = vmc.init_state()
    reset_launches()
    rows = []
    for i in range(MULTINOMIAL_STEPS):
        budget = vmc._current_budget(cfg)
        gen_state = state.generator.get_state()
        out = multinomial_sample(vmc.anqs, cfg.sample_num, budget,
                                 generator=state.generator)
        state.generator.set_state(gen_state)
        counts, dropped = int(out.counts.sum()), int(out.dropped)
        row = vmc.step(state)
        vmc._adapt_budget(cfg, row["unique_num"])
        rows.append(row)
        log(f"Li2O multinomial step {i}: budget {budget}, counts {counts} + "
            f"dropped {dropped}, energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"table_overflow {int(row['table_overflow'])} launches "
            f"{read_launches()}")
        check(counts + dropped == budget, f"step {i}: counts {counts} + "
              f"dropped {dropped} != budget {budget}")
        check(int(row["dropped"]) == dropped
              and int(row["unique_num"]) == int(out.valid.sum()),
              f"step {i}: the step drew another sample than its replay")
        check(np.isfinite(row["energy"]), f"multinomial step {i}: energy")
        check(int(row["unique_num"]) <= cfg.sample_num,
              f"multinomial step {i}: unique_num {row['unique_num']}")
        check(int(row["table_overflow"]) == 0,
              f"multinomial step {i}: table_overflow")
    launches = read_launches()
    n = MULTINOMIAL_STEPS
    check(launches == {"fused_matrix_elements": n, "hash_lookup": n,
                       "hash_tags": n, "fp_filter": 0},
          f"Li2O multinomial launched {launches} in {n} steps")
    return launches


def c2h4_set(torch, vmc, generator):
    """One step's determinant set of the C2H4 trainer (``VMC._support``:
    the Gumbel samples and the pinned HF neighbours, canonically sorted,
    repeated rows invalid) drawn with ``generator`` at the current weights,
    whose state is then restored (the step that follows draws the same
    samples); and its amplitudes. Launches no kernel."""
    gen_state = generator.get_state()
    words, _, valid, _ = vmc._support(generator)
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
    generator.set_state(gen_state)
    return words, valid, la, ph


def host_pairs_and_rayleigh(ham, words, valid, la, ph):
    """(connected pairs, float64 Rayleigh quotient) of a two-word set on the
    host (``host_local_energies``)."""
    pairs, energy, _ = host_local_energies(ham, words, valid, la, ph)
    return pairs, energy


def host_local_energies(ham, words, valid, la, ph):
    """(connected pairs, float64 Rayleigh quotient, complex128 local
    energies of the valid rows in their order) of a two-word set on the
    host: every ordered pair (x, y) of the set's valid rows with x ^ y a
    flip mask (the diagonal included), counted once for each group of that
    mask, as the engine counts ``found_pairs``; its element <y|H|x> summed
    term by term in float64, each group's sum turned by its phase offset
    (``PauliHamiltonian.phase_offsets``, the odd-Y channel); psi = exp(la
    + i ph) over the set, and E_loc(x) = (H_set psi)(x) / psi(x)."""
    import numpy as np
    import scipy.sparse

    from anqs_quantum_chemistry_torch.chem.jw import words_to_ints

    keep = valid.cpu().numpy()
    dets = words_to_ints(words.cpu().numpy()[keep])
    psi = np.exp(la.double().cpu().numpy()[keep]
                 + 1j * ph.double().cpu().numpy()[keep])
    # Groups by distinct flip mask (the odd-Y channel repeats a mask).
    masks, group_mask = np.unique(words_to_ints(ham.a_masks),
                                  return_inverse=True)
    mask_groups = np.argsort(group_mask, kind="stable")
    mask_count = np.bincount(group_mask, minlength=len(masks))
    mask_first = np.cumsum(mask_count) - mask_count
    n = len(dets)
    src, dst, mask = [], [], []
    for r in range(0, n, 1024):
        x = dets[r:r + 1024, None] ^ dets[None, :]
        pos = np.clip(np.searchsorted(masks, x), 0, len(masks) - 1)
        i, j = np.nonzero(masks[pos] == x)
        src.append(i + r)
        dst.append(j)
        mask.append(pos[i, j])
    src, dst, mask = (np.concatenate(v) for v in (src, dst, mask))
    # One (pair, group) entry for each group of the pair's mask.
    per_pair = mask_count[mask]
    entry = np.repeat(np.arange(len(src)), per_pair)
    grp = mask_groups[np.repeat(mask_first[mask] - (np.cumsum(per_pair)
                                                     - per_pair), per_pair)
                      + np.arange(int(per_pair.sum()))]
    starts = np.asarray(ham.group_starts, np.int64)
    sizes = np.diff(starts)[grp]
    pair = np.repeat(np.arange(len(grp)), sizes)
    term = (np.repeat(starts[grp] - (np.cumsum(sizes) - sizes), sizes)
            + np.arange(int(sizes.sum())))
    par = dets[src[entry]][pair] & words_to_ints(ham.b_words)[term]
    for shift in (32, 16, 8, 4, 2, 1):
        par = par ^ (par >> np.uint64(shift))
    sign = 1.0 - 2.0 * (par & np.uint64(1)).astype(np.float64)
    me = np.bincount(pair, weights=sign * np.asarray(ham.weights)[term],
                     minlength=len(grp)).astype(np.complex128)
    if ham.phase_offsets is not None:
        me = me * np.exp(1j * np.asarray(ham.phase_offsets, np.float64)[grp])
    h = scipy.sparse.csr_matrix((me, (dst[entry], src[entry])),
                                shape=(n, n))
    h_psi = h @ psi
    norm = np.vdot(psi, psi).real
    energy = np.real(np.vdot(psi, h_psi)) / norm + ham.constant
    return len(grp), float(energy), h_psi / psi + ham.constant


def c2h4_membership_phase(torch, vmc):
    """Prefilter membership against hash membership on one C2H4 set
    (Gumbel samples of the transformer at its initial weights, seed 1, and
    the pinned neighbours): the prefilter's capacities are doubled, as the
    overflow policy doubles them, until it drops no row; then both must
    find the same pairs and agree on the numerators t (which the energy
    uses) to 1e-6 of the largest |t|. Their e are sums of other float32
    terms (JAX's ``_combine_rows`` scales a row's sum by 1/|psi(x)| clipped
    at e^60; ``_combine`` clips each pair's ratio), so e is held to 1e-6 of
    the largest |e| only on rows with log|psi| > -60, where neither clip
    binds. Then kernel #3 alone on the set at those capacities against its
    plain version."""
    import copy

    words, valid, la, ph = c2h4_set(
        torch, vmc, torch.Generator(device="cuda").manual_seed(1))
    hash_eng = copy.copy(vmc.engine)
    hash_eng.membership = "hash"
    eng = vmc.engine
    with torch.no_grad():
        ref = hash_eng.local_energy_proxy(words, la, ph, valid)
        levels = []
        while True:
            e = eng.local_energy_proxy(words, la, ph, valid)
            levels.append((eng.prefilter_row_capacity,
                           eng.prefilter_dense_rows,
                           int(e.pf_dropped_rows)))
            log(f"C2H4 prefilter at capacities (row "
                f"{eng.prefilter_row_capacity}, dense "
                f"{eng.prefilter_dense_rows}, hash_extra_bits "
                f"{eng.hash_extra_bits}): pf_dropped_rows "
                f"{int(e.pf_dropped_rows)}, found_pairs {int(e.found_pairs)}")
            if int(e.pf_dropped_rows) == 0:
                break
            check(len(levels) <= vmc.config.max_overflow_escalations,
                  "C2H4: prefilter capacities beyond the escalation cap")
            eng = eng.with_capacities(
                prefilter_row_capacity=2 * eng.prefilter_row_capacity,
                prefilter_dense_rows=2 * eng.prefilter_dense_rows,
                hash_extra_bits=eng.hash_extra_bits + 1)
    torch.cuda.synchronize()
    unclipped = valid & (la > -60.0)
    diffs = {}
    for field in ("e_re", "e_im", "t_re", "t_im"):
        got, want = getattr(e, field), getattr(ref, field)
        if field[0] == "e":
            got, want = got[unclipped], want[unclipped]
        diffs[field] = (float(torch.max(torch.abs(got - want))),
                        float(torch.max(torch.abs(want))),
                        bool(torch.equal(got, want)))
    log(f"C2H4 set: {int(valid.sum())} rows ({int(unclipped.sum())} with "
        f"log|psi| > -60); hash membership found_pairs "
        f"{int(ref.found_pairs)} (table_overflow {int(ref.table_overflow)})"
        f", prefilter {int(e.found_pairs)} (table_overflow "
        f"{int(e.table_overflow)}); max|prefilter - hash| (max|hash|, "
        f"bit-identical): " + ", ".join(
            f"{k} {d:.3e} ({m:.3e}, {same})" for k, (d, m, same)
            in diffs.items()))
    check(int(e.found_pairs) == int(ref.found_pairs),
          "C2H4: prefilter and hash membership find other pairs")
    check(int(e.table_overflow) == int(ref.table_overflow) == 0,
          "C2H4: hash table overflowed")
    for field, (d, m, _) in diffs.items():
        check(d <= 1e-6 * m, f"C2H4: prefilter {field} disagrees with hash")

    fptab = eng._hash_build(words, la, ph, valid, with_fp=True)[3]
    fp_filter_check(torch, "the C2H4 set (one block)", fptab, words,
                    eng.a_cols)


def c2h4_trainer_phase(torch):
    """The C2H4 transformer trainer (``c2h4_vmc``: the example's full width
    and settings) for ``STEPS`` steps from seed 0, the overflow policy
    acting after each step as ``run`` does, after the membership
    cross-check on its initial weights. Returns the launches."""
    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import c2h4_vmc

    vmc = c2h4_vmc(device="cuda")
    log(f"C2H4 trainer: membership {vmc.engine.membership}, group order "
        f"{vmc.engine.weights_matmul}, {vmc.ref_neighbor_words.shape[0]} "
        "pinned neighbours")
    c2h4_membership_phase(torch, vmc)

    state = vmc.init_state()
    reset_launches()
    rows, ref = [], None
    for i in range(STEPS):
        snap = (c2h4_set(torch, vmc, state.generator) if ref is None
                else None)
        row = vmc.step(state)
        rows.append(row)
        log(f"C2H4 step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"pf_dropped_rows {int(row['pf_dropped_rows'])} table_overflow "
            f"{int(row['table_overflow'])} escalations "
            f"{vmc._overflow_escalations}")
        if ref is None and int(row["pf_dropped_rows"]) == 0:
            ref = (i, snap)
        vmc._handle_overflow({**row, "iter_idx": i})
    launches = read_launches()
    log(f"C2H4 path launches {launches}; capacities after the run (row "
        f"{vmc.engine.prefilter_row_capacity}, dense "
        f"{vmc.engine.prefilter_dense_rows})")

    for i, row in enumerate(rows):
        check(np.isfinite(row["energy"]), f"C2H4 step {i}: energy")
        check(4096 <= int(row["unique_num"]) <= 6144,
              f"C2H4 step {i}: unique_num {row['unique_num']}")
        check(int(row["table_overflow"]) == 0,
              f"C2H4 step {i}: table_overflow {row['table_overflow']}")
    check(ref is not None, "C2H4: every step dropped rows")
    i0, snap = ref
    check(all(int(r["pf_dropped_rows"]) == 0 for r in rows[i0:]),
          "C2H4: rows dropped after the last escalation")
    host_pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    log(f"C2H4 step {i0} (the first with no dropped row) on the host: "
        f"found_pairs {host_pairs}, "
        f"Rayleigh quotient over its {int(snap[1].sum())} determinants "
        f"{e_ref:.6f} (|step - ref| = {abs(rows[i0]['energy'] - e_ref):.2e} "
        f"Ha); HF {vmc.mol.hf_energy:.6f}")
    check(int(rows[i0]["found_pairs"]) == host_pairs,
          "C2H4: found_pairs disagrees with the host count")
    check(abs(rows[i0]["energy"] - e_ref) <= 1e-4,
          "C2H4: energy disagrees with the Rayleigh quotient")
    check(launches == {"fused_matrix_elements": 2 * STEPS,
                       "hash_lookup": 2 * STEPS, "hash_tags": 2 * STEPS,
                       "fp_filter": STEPS},
          f"C2H4 path launched {launches} in {STEPS} steps (kernel #3 once "
          "a step: one row block)")
    return launches


def li2o_nade_phase(torch):
    """The Li2O NADE campaign at full width: (a) the CISD vector, (b)
    supervised pretraining on it, (c) one step of the JAX closure state
    against the JAX record and the host, (d) ``run()`` with distillation
    cycles from (b)'s weights, (e) the kernels' launches on (b)-(d).
    Returns the launches."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import cisd_ground_state
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        li2o_nade_closure_params,
        li2o_nade_vmc,
    )
    from anqs_quantum_chemistry_torch.optim.pretrain import (
        amplitude_targets_from_coefs,
        pack_dets,
        pretrain,
    )

    vmc = li2o_nade_vmc(device="cuda", distill_period=NADE_DISTILL_PERIOD,
                        distill_steps=100, distill_lr=1e-4, distill_tau=0.1)
    mol = vmc.mol
    log(f"Li2O NADE trainer: membership {vmc.engine.membership}, "
        f"capacities (row {vmc.engine.prefilter_row_capacity}, dense "
        f"{vmc.engine.prefilter_dense_rows})")

    # (a) The CISD vector.
    e_cisd, dets, coef = cisd_ground_state(mol.qubit_ham, mol.hf_det)
    log(f"Li2O CISD on the host: {len(dets)} determinants,"
        f" E {e_cisd:.9f} (JAX {LI2O_CISD_ENERGY:.9f}, |diff| "
        f"{abs(e_cisd - LI2O_CISD_ENERGY):.2e} Ha)")
    check(len(dets) == LI2O_CISD_DETS, "Li2O CISD: determinant count")
    check(abs(e_cisd - LI2O_CISD_ENERGY) <= 1e-6, "Li2O CISD: energy")

    # (b) Pretraining from fresh weights.
    probs, phases = amplitude_targets_from_coefs(coef)
    words = pack_dets(dets, mol.qubit_num).cuda()
    vmc.init_state()
    reset_launches()
    params, hist = pretrain(vmc.anqs, words, probs, phases,
                            iters=NADE_PRETRAIN_STEPS, lr=1e-3,
                            log_every=50)
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
        tp = torch.from_numpy(probs).cuda()
        dph = ph - torch.from_numpy(phases).cuda()
        returned = float(-2.0 * torch.sum(tp * la) + torch.sum(tp * dph * dph))
    best = hist[-1]["best_loss"]
    log(f"Li2O NADE pretraining: {NADE_PRETRAIN_STEPS} full-batch steps; "
        "loss " + ", ".join(
            f"{r['iter']}: {r['loss']:.5f}" for r in hist)
        + f"; best {best:.5f}, returned parameters' loss {returned:.5f}")
    check(best < 1.0, f"Li2O NADE pretraining: best loss {best}")
    check(abs(returned - best) <= 1e-4 * abs(best),
          "Li2O NADE pretraining: the returned parameters are not the best")

    # (c) The JAX closure state, one step at lr 0.
    state = vmc.init_state()
    vmc.anqs.load_state_dict(li2o_nade_closure_params())
    snap = c2h4_set(torch, vmc, state.generator)
    row = vmc.step(state, overrides={"lr": 0.0, "lr_schedule": None})
    host_pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    log(f"Li2O NADE closure state, one step at lr 0: "
        f"energy {row['energy']:.6f} (JAX "
        f"record {LI2O_CLOSURE_ENERGY:.6f}, diff "
        f"{(row['energy'] - LI2O_CLOSURE_ENERGY) * 1e3:+.4f} mHa), "
        f"found_pairs {int(row['found_pairs'])} (JAX {LI2O_CLOSURE_PAIRS}, "
        f"{100 * (row['found_pairs'] / LI2O_CLOSURE_PAIRS - 1):+.2f}%), "
        f"pf_dropped_rows {int(row['pf_dropped_rows'])}, unique_num "
        f"{int(row['unique_num'])}; host: "
        f"found_pairs {host_pairs}, Rayleigh quotient {e_ref:.6f} "
        f"(|step - ref| = {abs(row['energy'] - e_ref):.2e} Ha)")
    check(abs(row["energy"] - LI2O_CLOSURE_ENERGY) <= 2e-4,
          "Li2O NADE closure state: energy off the JAX record")
    check(abs(row["found_pairs"] - LI2O_CLOSURE_PAIRS)
          <= 0.02 * LI2O_CLOSURE_PAIRS,
          "Li2O NADE closure state: found_pairs off the JAX record")
    check(int(row["pf_dropped_rows"]) == 0 == int(row["table_overflow"]),
          "Li2O NADE closure state: rows dropped")
    check(int(row["found_pairs"]) == host_pairs,
          "Li2O NADE: found_pairs disagrees with the host count")
    check(abs(row["energy"] - e_ref) <= 1e-4,
          "Li2O NADE: energy disagrees with the Rayleigh quotient")

    # (d) run() from the pretrained weights, with distillation cycles.
    _, history, _ = vmc.run(NADE_RUN_STEPS, init_params=params,
                            steps_per_call=NADE_DISTILL_PERIOD,
                            checkpoint_every=None, log_every=0)
    launches = read_launches()
    for i, r in enumerate(history):
        log(f"Li2O NADE run row {i}: energy {r['energy']:.6f} unique_num "
            f"{int(r['unique_num'])} found_pairs {int(r['found_pairs'])} "
            f"pf_dropped_rows {int(r['pf_dropped_rows'])} distill_loss "
            f"{r['distill_loss_first']:.5f} -> {r['distill_loss_last']:.5f} "
            f"distill_energy {r['distill_energy']:.6f}")
    cycles = [i for i, r in enumerate(history)
              if np.isfinite(r["distill_loss_first"])]
    check(len(history) == NADE_RUN_STEPS, "Li2O NADE run: row count")
    check(cycles == [5, 10], f"Li2O NADE run: cycles on rows {cycles}")
    for i in cycles:
        check(history[i]["distill_loss_last"]
              < history[i]["distill_loss_first"],
              f"Li2O NADE run: cycle {i} did not lower its loss")
        check(np.isfinite(history[i]["distill_energy"]),
              f"Li2O NADE run: cycle {i} energy")
    for i, r in enumerate(history):
        check(all(np.isfinite(v) for k, v in r.items()
                  if not k.startswith(("distill", "full_energy"))),
              f"Li2O NADE run: row {i} not finite")
        check(int(r["unique_num"]) == 8192,
              f"Li2O NADE run: row {i} unique_num {r['unique_num']}")
    evaluations = 1 + NADE_RUN_STEPS + len(cycles)
    log(f"Li2O NADE path launches {launches}")
    check(launches == {"fused_matrix_elements": 2 * evaluations,
                       "hash_lookup": 2 * evaluations,
                       "hash_tags": 2 * evaluations,
                       "fp_filter": evaluations},
          f"Li2O NADE path launched {launches} in {evaluations} "
          "local-energy evaluations")
    return launches


def li2o_support_ci_phase(torch):
    """The Li2O support-CI closure at full width (the JAX package's
    ``runs/li2o_sci`` chain, its packaged target and states): (a) the
    host's restricted H and ground state over the target's top 8192; (b)
    ckpt_26's Rayleigh quotient, polish loss, mass and two sampled full
    energies; (c) ckpt_13's example polish loss and 20 full-batch polish
    steps; (d) 50 distillation steps; (e) 3 pinned-VMC steps; (f)
    ``support_vmc`` and L-BFGS on the 8192 support. Counts are set to 0
    before (b) and read after (f); then kernel #1 at the full energy's
    rows against its plain version. Returns (launches, max|kernel -
    plain|)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem import fci
    from anqs_quantum_chemistry_torch.chem import selected_ci as sci
    from anqs_quantum_chemistry_torch.experiments import support_ci as scp
    from anqs_quantum_chemistry_torch.experiments.li2o_pin_vmc import (
        li2o_pin_vmc,
    )
    from anqs_quantum_chemistry_torch.experiments.li2o_sci_polish import (
        example_polish_loss,
    )
    from anqs_quantum_chemistry_torch.experiments.li2o_support_ci import (
        li2o_sci_params,
        li2o_sci_vmc,
        load_target,
    )
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        LI2O_FCI_ENERGY,
        li2o_nade_closure_params,
    )
    from anqs_quantum_chemistry_torch.ops.keys import sort_words
    from anqs_quantum_chemistry_torch.optim.pretrain import pretrain
    from anqs_quantum_chemistry_torch.sampling.sampler import (
        gumbel_top_k_sample,
    )

    vmc = li2o_sci_vmc(device="cuda")
    mol = vmc.mol

    # (a) The target, the integrals and the host's restricted H.
    td, tc, e_target = load_target()
    d8, c8 = sci.truncate_by_weight(td, tc, LI2O_SCI_TOP)
    h8 = fci.sparse_hamiltonian(d8, mol.h1, mol.v)
    e8, _ = sci.restricted_ground_state(d8, mol.h1, mol.v, mol.e_nuc)
    log(f"Li2O support CI: target {len(td)} determinants (E0 "
        f"{e_target:.6f}), integrals h1 {mol.h1.shape} v {mol.v.shape}; H "
        f"over its top {LI2O_SCI_TOP} built on the host (nnz {h8.nnz}); "
        f"restricted_ground_state E0 "
        f"{e8:.10f} (JAX {LI2O_SCI_TOP_E0:.10f}, |diff| "
        f"{abs(e8 - LI2O_SCI_TOP_E0):.1e} Ha)")
    check(len(td) == 131_072, "Li2O support CI: target size")
    check(h8.nnz == 848_626, f"Li2O support CI: nnz {h8.nnz}")
    check(abs(e8 - LI2O_SCI_TOP_E0) <= 1e-8, "Li2O support CI: top-8192 E0")

    # (b) ckpt_26: Rayleigh quotient, polish loss and mass, full energies.
    reset_launches()
    vmc.anqs.load_state_dict(li2o_sci_params(26))
    t8 = scp.make_target(d8, c8, mol.qubit_num, "cuda")
    target = scp.make_target(td, tc, mol.qubit_num, "cuda")
    rq26 = scp.support_rayleigh(mol, t8, vmc.anqs, h=h8)
    with torch.no_grad():
        loss26, mass26 = (float(x) for x in scp.polish_loss(
            vmc.anqs, target, 2.0, 30.0, "lin"))
    rel_loss = abs(loss26 / LI2O_SCI_CKPT26_LOSS - 1.0)
    rel_mass = abs(mass26 / LI2O_SCI_CKPT26_MASS - 1.0)
    log(f"Li2O ckpt_26: Rayleigh quotient over the top {LI2O_SCI_TOP} "
        f"{rq26:.9f} (JAX float32 {LI2O_SCI_CKPT26_RAYLEIGH:.9f}, |diff| "
        f"{abs(rq26 - LI2O_SCI_CKPT26_RAYLEIGH):.1e} Ha); polish loss "
        f"(T 2, linear lam 30) over {len(td)} rows {loss26:.10f} (JAX float32"
        f" {LI2O_SCI_CKPT26_LOSS:.10f}, rel {rel_loss:.1e}; TPU record "
        f"{TPU_CKPT26_LOSS}), mass {mass26:.10f} (JAX float32 "
        f"{LI2O_SCI_CKPT26_MASS:.10f}, rel {rel_mass:.1e}; TPU record "
        f"{TPU_CKPT26_MASS})")
    check(abs(rq26 - LI2O_SCI_CKPT26_RAYLEIGH) <= 2e-6,
          "Li2O ckpt_26: Rayleigh quotient")
    check(rel_loss <= 1e-5 and rel_mass <= 1e-5,
          "Li2O ckpt_26: polish loss or mass")
    for seed in (1, 2):
        e, var = scp.sampled_full_energy(
            vmc, torch.Generator(device="cuda").manual_seed(seed), 16384)
        log(f"Li2O ckpt_26 sampled full energy (16384, seed {seed}): "
            f"{e:.7f} var {var:.3e} (TPU "
            f"confirmations' mean {LI2O_SCI_CONFIRM_ENERGY:.6f}, diff "
            f"{(e - LI2O_SCI_CONFIRM_ENERGY) * 1e3:+.4f} mHa; FCI "
            f"{LI2O_FCI_ENERGY:.6f}, gap "
            f"{(e - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa)")
        check(abs(e - LI2O_SCI_CONFIRM_ENERGY) <= 5e-5,
              "Li2O ckpt_26: sampled full energy off the confirmations")
        check(e - LI2O_FCI_ENERGY < 1.6e-3,
              "Li2O ckpt_26: not within chemical accuracy")

    # (c) ckpt_13: the example's polish loss, then 20 full-batch steps.
    vmc.anqs.load_state_dict(li2o_sci_params(13))
    with torch.no_grad():
        loss13 = float(example_polish_loss(vmc.anqs, target, 4.0, 1000.0)[0])
    rel13 = abs(loss13 / LI2O_SCI_CKPT13_LOSS - 1.0)
    best13, first13 = scp.fit_stage(
        vmc.anqs, lambda: example_polish_loss(vmc.anqs, target, 4.0,
                                              1000.0)[0], 1e-4, POLISH_STEPS)
    log(f"Li2O ckpt_13: example polish loss (T 4, quadratic lam 1000) "
        f"{loss13:.10f} (JAX float32 {LI2O_SCI_CKPT13_LOSS:.10f}, rel "
        f"{rel13:.1e}; TPU record {TPU_CKPT13_LOSS}); {POLISH_STEPS} "
        f"full-batch steps at lr 1e-4 over {len(td)} rows: loss "
        f"{first13:.6f} -> best {best13:.6f}")
    check(rel13 <= 1e-5, "Li2O ckpt_13: example polish loss")
    check(first13 == loss13 or abs(first13 / loss13 - 1.0) <= 1e-6,
          "Li2O ckpt_13: the stage's first loss")
    check(best13 < first13, "Li2O ckpt_13: the polish loss did not fall")

    # (d) Distillation from the packaged closure state.
    vmc.anqs.load_state_dict(li2o_nade_closure_params())
    _, hist = pretrain(vmc.anqs, target["words"], target["p"], target["ph"],
                       torch.Generator(device="cuda").manual_seed(100),
                       iters=DISTILL_STEPS, lr=3e-4, batch=8192,
                       log_every=10)
    log(f"Li2O distillation from the closure state: {DISTILL_STEPS} steps "
        f"(batch 8192, lr 3e-4); loss " + ", ".join(
            f"{r['iter']}: {r['loss']:.5f}" for r in hist)
        + f"; best {hist[-1]['best_loss']:.5f}")
    check(all(np.isfinite(r["loss"]) for r in hist),
          "Li2O distillation: non-finite loss")
    check(hist[-1]["best_loss"] < hist[0]["loss"],
          "Li2O distillation: the loss did not fall")

    # (e) Pinned-support VMC from ckpt_13.
    pin = li2o_pin_vmc(device="cuda")
    state = pin.init_state()
    pin.anqs.load_state_dict(li2o_sci_params(13))
    log(f"Li2O pinned VMC: {pin.coupled_words.shape[0]} pinned "
        "determinants")
    snap = c2h4_set(torch, pin, state.generator)
    pin_rows = []
    for i in range(PIN_STEPS):
        row = pin.step(state)
        pin._handle_overflow({**row, "iter_idx": i})
        pin_rows.append(row)
        log(f"Li2O pinned VMC step {i}: energy {row['energy']:.6f} "
            f"unique_num {int(row['unique_num'])} found_pairs "
            f"{int(row['found_pairs'])} pf_dropped_rows "
            f"{int(row['pf_dropped_rows'])}")
        check(np.isfinite(row["energy"]), "Li2O pinned VMC: energy")
    row0 = pin_rows[0]
    host_pairs, e_ref = host_pairs_and_rayleigh(pin.ham, *snap)
    log(f"Li2O pinned VMC step 0 against the JAX run's iteration 0 "
        f"{LI2O_PIN_STEP0_ENERGY:.6f}: diff "
        f"{(row0['energy'] - LI2O_PIN_STEP0_ENERGY) * 1e3:+.4f} mHa; host: "
        f"found_pairs {host_pairs}, "
        f"Rayleigh quotient {e_ref:.6f} (|step - ref| = "
        f"{abs(row0['energy'] - e_ref):.2e} Ha)")
    check(abs(row0["energy"] - LI2O_PIN_STEP0_ENERGY) <= 2e-4,
          "Li2O pinned VMC: step 0 off the JAX record")
    check(int(row0["pf_dropped_rows"]) == 0, "Li2O pinned VMC: rows dropped")
    check(int(row0["found_pairs"]) == host_pairs,
          "Li2O pinned VMC: found_pairs disagrees with the host count")
    check(abs(row0["energy"] - e_ref) <= 1e-4,
          "Li2O pinned VMC: energy disagrees with the Rayleigh quotient")

    # (f) support_vmc and L-BFGS on the 8192 support from ckpt_26.
    vmc.anqs.load_state_dict(li2o_sci_params(26))
    rows = []
    scp.support_vmc(vmc.anqs, t8, h8, mol.e_nuc, lrs=(1e-4,),
                    steps_per_stage=SUPPORT_VMC_STEPS, log_every=1,
                    on_log=rows.append)
    vmc.anqs.load_state_dict(li2o_sci_params(26))
    lrows = []
    _, linfo = scp.support_vmc_lbfgs(vmc.anqs, t8, h8, mol.e_nuc,
                                     maxiter=LBFGS_EVALS,
                                     segment=LBFGS_EVALS, log_every=1,
                                     on_log=lrows.append)
    launches = read_launches()
    log(f"Li2O support_vmc (rq, lr 1e-4) over {LI2O_SCI_TOP} rows: rq "
        + ", ".join(f"{r['rq']:.7f}" for r in rows)
        + f"; first rq {rows[0]['rq']:.9f} (JAX float32 "
        f"{LI2O_SCI_CKPT26_RQ:.9f}, "
        f"|diff| {abs(rows[0]['rq'] - LI2O_SCI_CKPT26_RQ):.1e} Ha; the real"
        f" projection's quotient (b) {rq26:.9f}); L-BFGS "
        f"{len(lrows)} evaluations: "
        f"rq {lrows[0]['rq']:.7f} -> {lrows[-1]['rq']:.7f}, best "
        f"{linfo[-1]['best_rq']:.7f}, mass {lrows[-1]['mass']:.7f}")
    check(len(rows) == SUPPORT_VMC_STEPS, "Li2O support_vmc: rows")
    check(abs(rows[0]["rq"] - LI2O_SCI_CKPT26_RQ) <= 1e-6,
          "Li2O support_vmc: first rq")
    check(all(np.isfinite(r["rq"]) and np.isfinite(r["mass"])
              for r in rows + lrows), "Li2O support_vmc: NaN")
    check(len(lrows) >= LBFGS_EVALS, f"Li2O L-BFGS: {len(lrows)} evaluations")
    full_evals = 2
    check(launches == {"fused_matrix_elements": full_evals + 2 * PIN_STEPS,
                       "hash_lookup": 2 * PIN_STEPS,
                       "hash_tags": 2 * PIN_STEPS, "fp_filter": PIN_STEPS},
          f"Li2O support-CI path launched {launches}")
    log(f"Li2O support-CI path launches {launches} (the 2 full energies "
        f"launch kernel #1 once each; each pinned step launches kernels #1 "
        f"and #2 twice, stages 3a and 3b, and kernel #3 once)")

    # Kernel #1 at the full energy's 16,384 rows.
    with torch.no_grad():
        s = gumbel_top_k_sample(
            vmc.anqs, 16384, torch.Generator(device="cuda").manual_seed(1))
        fe_words = sort_words(s.words)[0]
    return launches, me_check(torch, "Li2O full energy", fe_words,
                              vmc.engine.me_tables)


def c2h4_made_step_check(torch, vmc, state, label, record=None):
    """Steps of ``vmc`` at lr 0 from its current weights, the overflow
    policy acting after each, until one drops no row; that step's
    ``found_pairs`` against a host count over its own set and its energy
    against the float64 Rayleigh quotient over it (and, with ``record``
    (energy, tol), against a JAX record). Returns the rows."""
    import numpy as np

    rows = []
    while True:
        snap = c2h4_set(torch, vmc, state.generator)
        row = vmc.step(state, overrides={"lr": 0.0, "lr_schedule": None})
        rows.append(row)
        log(f"{label} step at lr 0: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs "
            f"{int(row['found_pairs'])} pf_dropped_rows "
            f"{int(row['pf_dropped_rows'])}; "
            f"capacities (row {vmc.engine.prefilter_row_capacity}, dense "
            f"{vmc.engine.prefilter_dense_rows})")
        check(np.isfinite(row["energy"]), f"{label}: energy")
        if int(row["pf_dropped_rows"]) == 0:
            break
        before = vmc._overflow_escalations
        vmc._handle_overflow({**row, "iter_idx": len(rows) - 1})
        log(f"{label}: escalation {vmc._overflow_escalations}")
        check(vmc._overflow_escalations > before and len(rows) <= 4,
              f"{label}: rows dropped and no escalation left")
    row = rows[-1]
    host_pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    msg = (f"{label} clean step on the host: "
           f"found_pairs {host_pairs}, Rayleigh quotient over its "
           f"{int(snap[1].sum())} determinants {e_ref:.6f} (|step - ref| = "
           f"{abs(row['energy'] - e_ref):.2e} Ha)")
    if record is not None:
        msg += (f"; JAX record {record[0]:.6f}, diff "
                f"{(row['energy'] - record[0]) * 1e3:+.4f} mHa")
    log(msg)
    check(int(row["table_overflow"]) == 0, f"{label}: table overflow")
    check(int(row["found_pairs"]) == host_pairs,
          f"{label}: found_pairs disagrees with the host count")
    check(abs(row["energy"] - e_ref) <= 1e-4,
          f"{label}: energy disagrees with the Rayleigh quotient")
    if record is not None:
        check(abs(row["energy"] - record[0]) <= record[1],
              f"{label}: energy off the JAX record")
    return rows


def sigma_check(torch, h1, v, n_alpha, n_beta, label, seed, host=True):
    """The device sigma at a random vector (numpy ``seed``) of the sector:
    float64 against ``host_sigma_f64`` (with ``host``) and float32 against
    float64, each as max|diff| / max|reference|."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.direct_ci import (
        host_sigma_f64, make_sigma, sigma_operands)

    n_orb = h1.shape[0] // 2
    ops = sigma_operands(h1, v, n_alpha, n_beta, device="cuda")
    sig32, sa, sb = make_sigma(n_orb, ops.s_alpha, ops.s_beta,
                               dtype=torch.float32, device="cuda")
    sig64, _, _ = make_sigma(n_orb, ops.s_alpha, ops.s_beta,
                             dtype=torch.float64, device="cuda")
    c = np.zeros((sa, sb))
    c[:ops.s_alpha, :ops.s_beta] = np.random.default_rng(seed).standard_normal(
        (ops.s_alpha, ops.s_beta))
    c64 = torch.from_numpy(c).cuda()
    c32 = c64.float()
    tab64, tab32 = ops.tables(torch.float64), ops.tables(torch.float32)
    s64 = sig64(c64, *tab64, 0.0)
    s32 = sig32(c32, *tab32, 0.0)
    scale = float(s64.abs().max())
    err32 = float((s32.double() - s64).abs().max()) / scale
    del s32
    out = {"S_a": ops.s_alpha, "S_b": ops.s_beta, "rel_err_f32": err32}
    if host:
        ref = host_sigma_f64(c, *(t.cpu().numpy() for t in tab64))
        out["rel_err_f64"] = float(np.abs(s64.cpu().numpy() - ref).max()
                                   / np.abs(ref).max())
    log(f"sigma at {label} ({ops.s_alpha} x {ops.s_beta} strings, padded "
        f"{sa} x {sb}): " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in out.items()))
    if host:
        check(out["rel_err_f64"] <= SIGMA64_TOL,
              f"{label}: float64 sigma vs host_sigma_f64 "
              f"{out['rel_err_f64']:.3e}")
    check(err32 <= SIGMA32_TOL, f"{label}: float32 sigma vs float64 "
          f"{err32:.3e}")


def li2o_quotient_f32_tables(torch, li2o, coeffs):
    """The float64 Rayleigh quotient of the (S_a, S_b) vector ``coeffs``
    on the card over the string tables rounded to float32 and upcast, as
    the JAX package's record was taken (plus e_nuc)."""
    from anqs_quantum_chemistry_torch.chem.direct_ci import (
        make_sigma, sigma_operands)

    ops = sigma_operands(li2o.h1, li2o.v, li2o.n_alpha, li2o.n_beta,
                         device="cuda")
    sig64, sa, sb = make_sigma(li2o.h1.shape[0] // 2, ops.s_alpha,
                               ops.s_beta, dtype=torch.float64,
                               device="cuda")
    c = torch.zeros((sa, sb), dtype=torch.float64, device="cuda")
    c[:ops.s_alpha, :ops.s_beta] = torch.from_numpy(coeffs).cuda()
    tabs = [t.double() if t.is_floating_point() else t
            for t in ops.tables(torch.float32)]
    hc = sig64(c, *tabs, 0.0)
    return float(torch.dot(c.reshape(-1), hc.reshape(-1))
                 / torch.dot(c.reshape(-1), c.reshape(-1))) + li2o.e_nuc


def chem_build_phase(torch, seed):
    """The host chemistry layer and direct CI: (a) N2/STO-3G at ``N2_R``
    angstrom built from atoms (``Molecule.create`` into a temporary
    ``mols_dir``) against the JAX record; (b) ``DISSOCIATION_STEPS`` exact
    steps of the dissociation recipe on it through its entry point, kernel
    #1 held against its plain version at its Hamiltonian; (c) the device
    sigma against its plain version at that molecule's 14,400-determinant
    sector; (d) Li2O/STO-3G's FCI by ``direct_ci_ground_state`` on the card
    from the packaged integrals. Returns (the launches of (b), max|kernel
    - plain| of kernel #1)."""
    import tempfile

    import numpy as np

    from anqs_quantum_chemistry_torch.chem.direct_ci import (
        direct_ci_ground_state)
    from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
    from anqs_quantum_chemistry_torch.chem.molecule import load_li2o
    from anqs_quantum_chemistry_torch.experiments import dissociation_curve
    from anqs_quantum_chemistry_torch.ops.matrix_elements import build_tables

    with tempfile.TemporaryDirectory() as tmp:
        mol = dissociation_curve.n2_at(N2_R, mols_dir=tmp, device="cuda")
        for label, got, want in (("HF", mol.hf_energy, N2_R_HF),
                                 ("CISD", mol.cisd_energy, N2_R_CISD),
                                 ("FCI", mol.fci_energy, N2_R_FCI)):
            log(f"N2 r={N2_R} {label} {got:.14f}, record {want:.14f}, "
                f"|diff| {abs(got - want):.2e} Ha")
            check(abs(got - want) <= N2_R_TOL, f"N2 r={N2_R} {label} "
                  f"{got} vs the record {want}")
        log(f"N2 r={N2_R} MP2 {mol.mp2_energy:.10f} CCSD "
            f"{mol.ccsd_energy:.10f} CCSD(T) {mol.ccsd_t_energy:.10f} "
            f"ipr {mol.fci_ipr:.6f}, {mol.qubit_ham.n_terms} terms in "
            f"{mol.qubit_ham.n_groups} groups")

        dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
        words = np.concatenate([dets, np.full(64, 0xFFFFFFFF, np.uint64)])
        words = torch.from_numpy(words.astype(np.int64)[:, None]).cuda()
        err = me_check(torch, f"N2 r={N2_R}", words,
                       build_tables(mol.qubit_ham, "cuda"))
        del words
        torch.cuda.empty_cache()

        reset_launches()
        res = dissociation_curve.main(
            ["dissociation_curve", "5", str(DISSOCIATION_STEPS), str(N2_R)],
            device="cuda", mols_dir=tmp, run_root=tmp)[N2_R]
        launches = read_launches()
        energies = res["energies"]
        log(f"N2 r={N2_R} dissociation recipe, {len(energies)} exact steps: "
            f"energies {[round(e, 6) for e in energies]}; launches "
            f"{launches}")
        check(len(energies) == DISSOCIATION_STEPS, "dissociation: "
              f"{len(energies)} rows")
        check(all(np.isfinite(energies)), "dissociation: non-finite energy")
        low = min(energies) - mol.fci_energy
        check(low >= -1e-6, f"dissociation: an exact energy {low:.3e} Ha "
              "below FCI")
        check(launches == {"fused_matrix_elements": DISSOCIATION_STEPS,
                           "hash_lookup": 0, "hash_tags": 0,
                           "fp_filter": 0},
              f"dissociation launched {launches}")
        with open(os.path.join(tmp, "n2_dissociation.csv")) as f:
            lines = f.read().splitlines()
        check(lines[0] == "r_angstrom,hf,cisd,fci,vmc" and len(lines) == 2,
              f"n2_dissociation.csv: {lines}")

        sigma_check(torch, mol.h1, mol.v, mol.n_alpha, mol.n_beta,
                    f"N2 r={N2_R}", seed)

    li2o = load_li2o()
    sigma_check(torch, li2o.h1, li2o.v, li2o.n_alpha, li2o.n_beta, "Li2O",
                seed, host=False)
    torch.cuda.empty_cache()
    fci = direct_ci_ground_state(li2o.h1, li2o.v, li2o.n_alpha, li2o.n_beta,
                                 li2o.e_nuc, tol=1e-4, device="cuda",
                                 verbose=log, return_coeffs=True)
    e_jax_tables = li2o_quotient_f32_tables(torch, li2o, fci.coeffs)
    log(f"Li2O FCI by direct CI: {fci.energy:.13f} (record "
        f"{LI2O_FCI_ENERGY:.13f}, diff "
        f"{fci.energy - LI2O_FCI_ENERGY:+.2e} Ha; the same vector over the "
        f"tables rounded to float32 as JAX's {e_jax_tables:.13f}, diff "
        f"{e_jax_tables - LI2O_FCI_ENERGY:+.2e} Ha), float32 Ritz "
        f"{fci.energy_f32:.10f}, ipr {fci.ipr:.11f} (record "
        f"{LI2O_FCI_IPR}), {fci.iterations} Davidson iterations, residual "
        f"{fci.residual:.3e}")
    check(abs(fci.energy - LI2O_FCI_ENERGY) <= LI2O_FCI_TOL,
          f"Li2O FCI {fci.energy} vs {LI2O_FCI_ENERGY}")
    check(abs(e_jax_tables - LI2O_FCI_ENERGY) <= LI2O_JAX_TABLES_TOL,
          f"Li2O quotient over float32 tables {e_jax_tables} vs "
          f"{LI2O_FCI_ENERGY}")
    check(abs(fci.ipr - LI2O_FCI_IPR) <= LI2O_IPR_TOL,
          f"Li2O FCI ipr {fci.ipr} vs {LI2O_FCI_IPR}")
    return launches, err


def c2h4_cisd_sci_phase(torch):
    """The C2H4/6-31G CISD -> support-CI chain at full width (the JAX
    package's ``runs/c2h4_cisd_made``, ``runs/c2h4_sci`` and
    ``runs/c2h4_cisd_transformer_emp_lr0.0001``; their packaged vector,
    target and states): (a) the integrals and the host's restricted ground
    state over the CISD vector's top 4096; (b) 100 pretraining steps of a
    fresh MADE-2048; (c) the MADE CISD trainer from ckpt_4000: a clean step
    at lr 0 against the host and JAX's rows, then ``run()``; (d) ckpt_47's
    quotient, polish loss and mass and a sampled full energy; (e) polish,
    distillation and the support-restricted optimisers at cut depth; (f)
    the transformer from ckpt_3000: log|psi| against JAX, a clean step, a
    sampled full energy; (g) kernel #1 at the full energy's shapes against
    its plain version. Counts are set to 0 before (c) and read after (f).
    Returns (launches, max|kernel - plain| of kernel #1)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem import fci
    from anqs_quantum_chemistry_torch.chem import selected_ci as sci
    from anqs_quantum_chemistry_torch.chem.molecule import (
        DATA_DIR,
        load_c2h4,
    )
    from anqs_quantum_chemistry_torch.convert import load_params_npz
    from anqs_quantum_chemistry_torch.experiments import support_ci as scp
    from anqs_quantum_chemistry_torch.experiments.c2h4_support_ci import (
        BEST_STATE,
        C2H4_CISD_VECTOR,
        C2H4_SCI_TARGET,
        POLISH,
        WARM_STATE,
        c2h4_sci_vmc,
    )
    from anqs_quantum_chemistry_torch.experiments.c2h4_support_transformer \
        import WARM_STATE as TR_STATE
    from anqs_quantum_chemistry_torch.experiments.cisd_pretrain_vmc import (
        NETS,
        vmc_config,
    )
    from anqs_quantum_chemistry_torch.experiments.li2o_support_ci import (
        load_target,
    )
    from anqs_quantum_chemistry_torch.experiments.vmc import VMC
    from anqs_quantum_chemistry_torch.ops.keys import sort_words
    from anqs_quantum_chemistry_torch.optim.pretrain import (
        amplitude_targets_from_coefs,
        pack_dets,
        pretrain,
    )
    from anqs_quantum_chemistry_torch.sampling.sampler import (
        gumbel_top_k_sample,
    )

    mol = load_c2h4()

    # (a) The packaged integrals, the CISD vector, the host's H.
    with np.load(C2H4_CISD_VECTOR) as d:
        dets, coef, e_cisd = d["dets"], d["coef"], float(d["e_cisd"])
    d4, c4 = sci.truncate_by_weight(dets, coef, C2H4_CISD_TOP)
    h4 = fci.sparse_hamiltonian(d4, mol.h1, mol.v)
    e4 = fci._ground_state(h4)[0] + mol.e_nuc
    log(f"C2H4 CISD -> SCI: integrals h1 {mol.h1.shape} v {mol.v.shape} "
        f"from the spatial form; CISD vector {len(dets)} determinants (E "
        f"{e_cisd:.10f}); H over its top {C2H4_CISD_TOP} built on the host "
        f"(nnz {h4.nnz}), ground state E0 {e4:.10f} (JAX "
        f"{C2H4_CISD_TOP_E0:.10f}, |diff| {abs(e4 - C2H4_CISD_TOP_E0):.1e} "
        f"Ha)")
    check(mol.h1.shape == (52, 52) and mol.v.shape == (52,) * 4,
          "C2H4: integral shapes")
    check(len(dets) == C2H4_CISD_DETS, "C2H4: CISD vector size")
    check(abs(e4 - C2H4_CISD_TOP_E0) <= 1e-8, "C2H4: top-4096 CISD E0")

    # (b) 100 pretraining steps of a fresh MADE-2048 on the CISD vector.
    made = VMC(mol, vmc_config(mol, "made", C2H4_ROWS, 4, 4000, True,
                               1.0), NETS["made"], device="cuda")
    state = made.init_state()
    probs, phases = amplitude_targets_from_coefs(coef)
    words = pack_dets(dets, mol.qubit_num).cuda()
    _, hist = pretrain(
        made.anqs, words, probs, phases,
        torch.Generator(device="cuda").manual_seed(0),
        iters=C2H4_PRETRAIN_STEPS, lr=1e-3, batch=C2H4_ROWS,
        log_every=25)
    log(f"C2H4 MADE-2048 pretraining: {C2H4_PRETRAIN_STEPS} steps (batch "
        f"{C2H4_ROWS}, lr 1e-3); loss " + ", ".join(
            f"{r['iter']}: {r['loss']:.5f}" for r in hist)
        + f"; best {hist[-1]['best_loss']:.5f}")
    check(all(np.isfinite(r["loss"]) for r in hist),
          "C2H4 pretraining: non-finite loss")
    check(hist[-1]["best_loss"] < hist[0]["loss"],
          "C2H4 pretraining: the loss did not fall")

    # (c) The MADE CISD trainer from the packaged ckpt_4000.
    reset_launches()
    warm = load_params_npz(WARM_STATE)
    made.anqs.load_state_dict(warm)
    made_rows = c2h4_made_step_check(
        torch, made, state, "C2H4 MADE ckpt_4000",
        (C2H4_MADE_RECORD_ENERGY, 1e-3))
    _, history, _ = made.run(C2H4_RUN_STEPS, init_params=warm,
                             steps_per_call=C2H4_RUN_STEPS,
                             checkpoint_every=None, log_every=0)
    log(f"C2H4 MADE run(): {C2H4_RUN_STEPS} steps, energies "
        + ", ".join(f"{r['energy']:.6f}" for r in history))
    check(len(history) == C2H4_RUN_STEPS and all(
        np.isfinite(r["energy"]) for r in history), "C2H4 MADE run()")
    made_evals = len(made_rows) + C2H4_RUN_STEPS

    # (d) ckpt_47: restricted quotient, polish loss and mass, full energy.
    vmc = c2h4_sci_vmc(device="cuda")
    gen = vmc.init_state().generator
    vmc.anqs.load_state_dict(load_params_npz(BEST_STATE))
    td, tc, e_target = load_target(C2H4_SCI_TARGET)
    d8, c8 = sci.truncate_by_weight(td, tc, C2H4_SCI_TOP)
    h8 = fci.sparse_hamiltonian(d8, mol.h1, mol.v)
    t8 = scp.make_target(d8, c8, mol.qubit_num, "cuda")
    target = scp.make_target(td, tc, mol.qubit_num, "cuda")
    rq47 = scp.support_rayleigh(mol, t8, vmc.anqs, h=h8)
    with torch.no_grad():
        loss47, mass47 = (float(x) for x in scp.polish_loss(
            vmc.anqs, target, POLISH["temp"], POLISH["lam"], POLISH["kind"],
            POLISH["chunk"]))
    rel_loss = abs(loss47 / C2H4_SCI_CKPT47_LOSS - 1.0)
    rel_mass = abs(mass47 / C2H4_SCI_CKPT47_MASS - 1.0)
    log(f"C2H4 ckpt_47: target {len(td)} determinants (E0 {e_target:.6f});"
        f" H over its top {C2H4_SCI_TOP} on the host (nnz {h8.nnz}); "
        f"Rayleigh quotient "
        f"{rq47:.9f} (JAX float32 {C2H4_SCI_CKPT47_RAYLEIGH:.9f}, |diff| "
        f"{abs(rq47 - C2H4_SCI_CKPT47_RAYLEIGH):.1e} Ha); polish loss (T 4,"
        f" linear lam 30, chunk 8192) {loss47:.8f} (JAX float32 "
        f"{C2H4_SCI_CKPT47_LOSS:.8f}, rel {rel_loss:.1e}), mass "
        f"{mass47:.10f} (JAX float32 {C2H4_SCI_CKPT47_MASS:.10f}, rel "
        f"{rel_mass:.1e})")
    check(len(td) == 262_144, "C2H4: target size")
    check(abs(rq47 - C2H4_SCI_CKPT47_RAYLEIGH) <= 1e-5,
          "C2H4 ckpt_47: Rayleigh quotient")
    check(rel_loss <= 1e-5 and rel_mass <= 1e-5,
          "C2H4 ckpt_47: polish loss or mass")
    e47, var47 = scp.sampled_full_energy(vmc, gen, C2H4_ROWS,
                                         row_chunk=C2H4_ROW_CHUNK)
    log(f"C2H4 ckpt_47 sampled full energy ({C2H4_ROWS}, row chunk "
        f"{C2H4_ROW_CHUNK}): {e47:.7f} "
        f"var {var47:.3e} (TPU confirmations {C2H4_SCI_CONFIRM_ENERGY:.7f}"
        f" +- 2.5e-6, diff {(e47 - C2H4_SCI_CONFIRM_ENERGY) * 1e3:+.4f} "
        "mHa)")
    check(abs(e47 - C2H4_SCI_CONFIRM_ENERGY) <= 5e-5,
          "C2H4 ckpt_47: sampled full energy off the confirmations")

    # (e) The support chain at cut depth.
    _, pinfo = scp.polish(vmc.anqs, target, **{
        **POLISH, "lrs": (POLISH["lrs"][0],), "steps": POLISH_STEPS})
    log(f"C2H4 polish from ckpt_47: {POLISH_STEPS} full-batch steps over "
        f"{len(td)} rows (lr {POLISH['lrs'][0]:g}, chunk {POLISH['chunk']})"
        f": best loss {pinfo[0]['loss']:.6f} (from {loss47:.6f}), mass "
        f"{pinfo[0]['mass']:.7f}")
    check(pinfo[0]["loss"] < loss47, "C2H4 polish: the loss did not fall")
    vmc.anqs.load_state_dict(warm)
    _, dhist = pretrain(
        vmc.anqs, target["words"], target["p"], target["ph"],
        torch.Generator(device="cuda").manual_seed(100), iters=DISTILL_STEPS,
        lr=3e-4, batch=8192, log_every=10)
    log(f"C2H4 distillation from ckpt_4000: {DISTILL_STEPS} steps (batch "
        f"8192, lr 3e-4); loss " + ", ".join(
            f"{r['iter']}: {r['loss']:.5f}" for r in dhist))
    check(all(np.isfinite(r["loss"]) for r in dhist)
          and dhist[-1]["best_loss"] < dhist[0]["loss"],
          "C2H4 distillation: the loss did not fall")
    support = {}
    for name, kw in (("rq", {}),
                     ("rq_refit", dict(objective="rq_refit", refit_beta=0.05,
                                       refit_clip=1.0, target_coef=c8))):
        vmc.anqs.load_state_dict(load_params_npz(BEST_STATE))
        rows = []
        scp.support_vmc(vmc.anqs, t8, h8, mol.e_nuc, lrs=(1e-4,),
                        steps_per_stage=SUPPORT_VMC_STEPS, log_every=1,
                        on_log=rows.append, **kw)
        support[name] = [r["rq"] for r in rows]
    vmc.anqs.load_state_dict(load_params_npz(BEST_STATE))
    lrows = []
    scp.support_vmc_lbfgs(vmc.anqs, t8, h8, mol.e_nuc, maxiter=LBFGS_EVALS,
                          segment=LBFGS_EVALS, log_every=1,
                          on_log=lrows.append)
    support["lbfgs"] = [r["rq"] for r in lrows]
    for name, rq in support.items():
        log(f"C2H4 {name} over the top {C2H4_SCI_TOP} from ckpt_47: rq "
            + ", ".join(f"{x:.7f}" for x in rq))
        check(len(rq) >= SUPPORT_VMC_STEPS and all(
            np.isfinite(x) for x in rq), f"C2H4 {name}: rq")
        check(abs(rq[0] - support["rq"][0]) <= 1e-9,
              f"C2H4 {name}: the first rq is not ckpt_47's")
    check(len(lrows) >= LBFGS_EVALS, "C2H4 L-BFGS: evaluations")
    del h8, target, t8
    torch.cuda.empty_cache()

    # (f) The transformer from the packaged ckpt_3000 at 'highest'.
    tr = VMC(mol, vmc_config(mol, "transformer", C2H4_ROWS, 4, 3000,
                             False, 1.0, 1e-4), NETS["transformer"],
             device="cuda")
    tr_state = tr.init_state()
    tr.anqs.load_state_dict(load_params_npz(TR_STATE))
    with np.load(os.path.join(DATA_DIR, "c2h4_transformer_logpsi.npz")) as d:
        jla, jph = d["log_abs"], d["phase"]
    dr, _ = sci.truncate_by_weight(td, tc, len(jla))
    with torch.no_grad():
        la, ph = (x.cpu().numpy() for x in tr.anqs.log_psi(
            pack_dets(dr, mol.qubit_num).cuda()))
    # log|psi| to 1e-5 + 1e-5 |la|; the phase, a float32 sum of 13 qudits'
    # pi x outputs that reaches 78 here (one ulp 7.6e-6), to 1e-4.
    err_la = float(np.max(np.abs(la - jla) / (1e-5 + 1e-5 * np.abs(jla))))
    err_ph = float(np.max(np.abs(ph - jph)))
    log(f"C2H4 transformer ckpt_3000 ({tr.anqs.config.matmul_precision}): "
        f"log|psi| and phase over the target's top {len(jla)} against JAX "
        f"float32: max |diff| {np.max(np.abs(la - jla)):.2e} (largest share "
        f"of the 1e-5 + 1e-5 |la| tolerance {err_la:.2f}) and {err_ph:.2e} "
        f"(tolerance 1e-4; max |phase| {np.max(np.abs(jph)):.1f})")
    check(err_la <= 1.0 and err_ph <= 1e-4,
          "C2H4 transformer: log|psi| or phase off JAX's")
    tr_rows = c2h4_made_step_check(torch, tr, tr_state,
                                   "C2H4 transformer ckpt_3000")
    etr, vtr = scp.sampled_full_energy(tr, tr_state.generator,
                                       C2H4_TR_FULL_SAMPLES,
                                       row_chunk=C2H4_TR_ROW_CHUNK)
    log(f"C2H4 transformer sampled full energy ({C2H4_TR_FULL_SAMPLES}, row"
        f" chunk {C2H4_TR_ROW_CHUNK}): {etr:.6f} var {vtr:.3e} (JAX's last "
        "rows about -78.1614 .. -78.1655)")
    check(np.isfinite(etr) and np.isfinite(vtr),
          "C2H4 transformer: sampled full energy")
    launches = read_launches()
    tr_evals = len(tr_rows)
    full_launches = (C2H4_ROWS // C2H4_ROW_CHUNK
                     + C2H4_TR_FULL_SAMPLES // C2H4_TR_ROW_CHUNK)
    evals = made_evals + tr_evals
    log(f"C2H4 CISD -> SCI path launches {launches} ({made_evals} MADE and "
        f"{tr_evals} transformer steps launch kernels #1 and #2 twice, "
        f"stages 3a and 3b, and kernel #3 once; the two full energies "
        f"launch kernel #1 {full_launches} times, once a row chunk)")
    check(launches == {"fused_matrix_elements": 2 * evals + full_launches,
                       "hash_lookup": 2 * evals, "hash_tags": 2 * evals,
                       "fp_filter": evals},
          f"C2H4 CISD -> SCI path launched {launches}")
    del tr
    torch.cuda.empty_cache()

    # (g) Kernel #1 at the full energy's row chunk and whole sample.
    with torch.no_grad():
        s = gumbel_top_k_sample(vmc.anqs, C2H4_ROWS,
                                torch.Generator(device="cuda").manual_seed(1))
        fe_words = sort_words(s.words)[0]
    return launches, max(
        me_check(torch, f"C2H4 full energy B {rows}", fe_words[:rows],
                 vmc.engine.me_tables)
        for rows in (C2H4_ROW_CHUNK, C2H4_ROWS))


def cr2_host_pairs_and_rayleigh(torch, mol, a_words, words, valid, la,
                                ph):
    """(connected pairs, float64 Rayleigh quotient) of a three-word set on
    the host, from the integrals and not from the Pauli form: every ordered
    pair (x, y) of the set's valid rows with x ^ y a flip mask A_m of the
    engine (the diagonal included) counts as a pair; H over the set is
    ``chem/fci.matrix_element`` (Slater-Condon with Python ints, any width)
    on every pair with popcount(x ^ y) <= 4, and psi = exp(la + i ph)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import matrix_element
    from anqs_quantum_chemistry_torch.chem.jw import words_to_pyints
    from anqs_quantum_chemistry_torch.ops.bits import popcount

    keep = valid.cpu()
    w = words.cpu()[keep]
    dets = words_to_pyints(w.numpy())
    flips = set(words_to_pyints(a_words.cpu().numpy()))
    psi = np.exp(la.double().cpu().numpy()[keep.numpy()]
                 + 1j * ph.double().cpu().numpy()[keep.numpy()])
    n = len(dets)
    near = popcount(w[:, None, :] ^ w[None, :, :]) <= 4
    i_idx, j_idx = (t.tolist() for t in torch.nonzero(near, as_tuple=True))
    h = np.zeros((n, n))
    pairs = 0
    for i, j in zip(i_idx, j_idx):
        pairs += (dets[i] ^ dets[j]) in flips
        if i <= j:
            h[i, j] = h[j, i] = matrix_element(dets[i], dets[j], mol.h1,
                                               mol.v)
    energy = (np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real
              + mol.e_nuc)
    return pairs, float(energy), len(i_idx)


def lookup_check(torch, label, tab, cols, entries):
    """Kernel #2 and its tag build against their plain versions on ``tab``
    (``entries`` a bucket) and the query columns ``cols``, bit for bit.
    Returns max|kernel - plain|."""
    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        hash_lookup,
        hash_lookup_plain,
        hash_tags,
        hash_tags_plain,
        key_words,
        tags_in_shared_memory,
    )

    got = hash_lookup(tab, *cols, entries=entries)
    want = hash_lookup_plain(tab, *cols, entries=entries)
    tags = hash_tags(tab, entries)
    torch.cuda.synchronize()
    same = (all(torch.equal(g.view(torch.int32), p.view(torch.int32))
                for g, p in zip(got[:2], want[:2]))
            and torch.equal(got[2], want[2])
            and torch.equal(tags, hash_tags_plain(tab, entries)))
    err = float(torch.max(torch.abs(got[0] - want[0])))
    tier = ("shared" if tags_in_shared_memory(tab.shape[0], entries)
            else "global")
    log(f"kernel hash_lookup at {label} (K {key_words(tab, entries)}, E "
        f"{entries}, nb {tab.shape[0]}, tags in {tier} memory): "
        f"Q={cols[0].numel()} found {int(got[2].sum())}, bit-identical "
        f"(lookup and tags) {same}")
    check(same and err <= HASH_TOL,
          f"kernel #2 disagrees with its plain version at {label}")
    return err


def random_key_table(torch, n_qubits, rng, hash_epb=None, n_keys=8192,
                     n_queries=1 << 20):
    """A bucket table of ``n_keys`` random ``n_qubits``-bit keys (numpy
    ``rng``) built by ``PauliEngine._hash_build`` at ``hash_epb``, and
    int32 query columns: stored keys, keys with one bit of word 0 flipped,
    and random keys."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
    from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine

    w = -(-n_qubits // 32)
    ham = PauliHamiltonian(
        qubit_num=n_qubits, constant=0.0,
        a_masks=np.zeros((1, w), np.uint32),
        b_words=np.zeros((1, w), np.uint32), weights=np.ones(1),
        group_starts=np.array([0, 1]))
    eng = PauliEngine(ham, device="cuda", membership="hash",
                      hash_epb=hash_epb)
    top = (1 << (n_qubits - 32 * (w - 1))) - 1
    keys = rng.integers(0, 1 << 32, (n_keys, w), dtype=np.int64)
    keys[:, -1] &= top
    keys = np.unique(keys, axis=0)
    n = len(keys)
    tab, _, overflow = eng._hash_build(
        torch.from_numpy(keys).cuda(),
        torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda(),
        torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32)).cuda(),
        torch.ones(n, dtype=torch.bool, device="cuda"))
    # 8-entry buckets at ~25% load overflow a few keys (JAX's hash_epb
    # note); those keys are missing from both versions' table alike.
    log(f"{n_qubits}-qubit random table at E {eng.hash_epb}: {n} keys, "
        f"{int(overflow)} overflowed")
    q = keys[rng.integers(0, n, n_queries)]
    kind = rng.integers(0, 3, n_queries)
    q[kind == 1, 0] ^= 1 << 7
    rand = rng.integers(0, 1 << 32, (int((kind == 2).sum()), w),
                        dtype=np.int64)
    rand[:, -1] &= top
    q[kind == 2] = rand
    q = torch.from_numpy(q.astype(np.uint32).view(np.int32)).cuda()
    return tab, [q[:, j].contiguous() for j in range(w)], eng.hash_epb

# ``options_phase``: the ansatz and step options of the JAX package on the
# N2 main path and the Li2O toy model (steps of each leg).
OPT_SPIN_STEPS = 5
OPT_STEPS = 3
OPT_REPLICAS = 4
SPIN_FLIP_TOL = 2e-5  # JAX tests/test_spin_flip.py's tolerance
PERM_FCI_TOL = 1e-8
ENSEMBLE_RTOL = 2e-5  # JAX tests/test_ensemble_step.py's tolerance


def sorted_set(words, valid, la, ph):
    """A one-word set's valid rows on the host, sorted: (uint64 dets,
    complex128 psi = exp(la + i ph))."""
    import numpy as np

    keep = valid.cpu().numpy()
    dets = words[:, 0].cpu().numpy().astype(np.uint64)[keep]
    psi = np.exp(la.double().cpu().numpy()[keep]
                 + 1j * ph.double().cpu().numpy()[keep])
    order = np.argsort(dets)
    return dets[order], psi[order]


def pairs_in_set(ham, dets):
    """Ordered pairs (x, x ^ A_m) of the sorted ``dets`` inside them (a
    binary search of every partner): the step's ``found_pairs``."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.jw import words_to_ints

    partner = dets[:, None] ^ words_to_ints(ham.a_masks)[None, :]
    idx = np.clip(np.searchsorted(dets, partner), 0, len(dets) - 1)
    return int(np.sum(dets[idx] == partner))


def quotient(h, psi):
    """The float64 Rayleigh quotient of ``psi`` under the sparse ``h``."""
    import numpy as np

    return float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)


def replay_set(vmc, state):
    """Step 0's own set and amplitudes, drawn with the generator's state
    restored after, so that the step draws the same uniforms."""
    gen_state = state.generator.get_state()
    words, _, valid, _, la, ph, _ = vmc._support_and_eloc(state)
    state.generator.set_state(gen_state)
    return words, valid, la, ph


def run_steps(torch, vmc, state, n, label):
    """``n`` steps, each printed; returns (rows, the launches of the
    steps)."""
    import numpy as np

    reset_launches()
    rows = []
    for i in range(n):
        row = vmc.step(state)
        rows.append(row)
        log(f"{label} step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f}")
    launches = read_launches()
    for i, row in enumerate(rows):
        check(np.isfinite(row["energy"]), f"{label} step {i}: energy")
    log(f"{label}: launches {launches}")
    return rows, launches


def options_phase(torch, mol):
    """The ansatz and step options at full width from seed 0, five legs
    with their launches counted from 0: (a) N2 with spin-flip
    symmetrization of log|psi| and the phase and the flip closure of the
    sample set; (b) N2 with the FCI vector's signs as a fixed sign
    structure; (c) N2 in exact summation with the alpha orbitals first;
    (d) the Li2O toy model with the per-layer patterns, the log_psi head,
    masking depth 1, bfloat16 activations, ``topk_impl='bisect'`` and MinSR
    without regularisation; (e) N2 as a 4-replica ensemble against
    standalone runs. Returns {path: launches}."""
    import copy

    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import (
        _ground_state,
        sector_hamiltonian,
    )
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        LI2O_OPTIONS,
        li2o_vmc,
        main_path_vmc,
    )
    from anqs_quantum_chemistry_torch.models import precision
    from anqs_quantum_chemistry_torch.ops import bits as bitops
    from anqs_quantum_chemistry_torch.ops.topk import exact_top_k
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig
    from anqs_quantum_chemistry_torch.sampling import sampler

    launches = {}
    n_real = mol.fci_ndet

    # (a) Spin flip.
    vmc = main_path_vmc(device="cuda", couple_spin_flip=True,
                        anqs_options=dict(spin_flip_abs=True,
                                          spin_flip_phase=True))
    state = vmc.init_state()
    words, valid, la, ph = replay_set(vmc, state)
    check(int(valid.sum()) == n_real, "spin flip: the set is not the sector")
    with torch.no_grad():
        w = words[valid]
        flipped = bitops.interleave_swap(w, mol.qubit_num)
        la0, ph0 = vmc.anqs.log_psi(w)
        la1, ph1 = vmc.anqs.log_psi(flipped)
    n_open = bitops.popcount(w ^ flipped) // 2
    sign = 1.0 - 2.0 * ((n_open // 2) % 2).double()
    amp0 = torch.exp(la0.double())
    amp1 = torch.exp(la1.double())
    abs_err = float(torch.max(torch.abs(la1 - la0)))
    psi_err = max(
        float(torch.max(torch.abs(amp1 * torch.cos(ph1.double())
                                  - sign * amp0 * torch.cos(ph0.double())))),
        float(torch.max(torch.abs(amp1 * torch.sin(ph1.double())
                                  - sign * amp0 * torch.sin(ph0.double())))))
    log(f"options (a) spin flip over the {n_real}-row set: max|la(flip x) - "
        f"la(x)| = {abs_err:.3e}, max|psi(flip x) - (-1)^(n_open/2) "
        f"psi(x)| = {psi_err:.3e}")
    check(abs_err <= SPIN_FLIP_TOL, "spin flip: |psi| not flip-invariant")
    check(psi_err <= SPIN_FLIP_TOL, "spin flip: the sign relation fails")
    sector_dets, psi = sorted_set(words, valid, la, ph)
    pairs = pairs_in_set(vmc.ham, sector_dets)
    h_sector = sector_hamiltonian(vmc.ham, sector_dets)
    e_ref = quotient(h_sector, psi)
    rows, launches["options_spin_flip"] = run_steps(
        torch, vmc, state, OPT_SPIN_STEPS, "options (a) spin flip")
    log(f"options (a): step 0 found_pairs {int(rows[0]['found_pairs'])} "
        f"(host {pairs}), energy {rows[0]['energy']:.6f} (Rayleigh quotient "
        f"{e_ref:.6f}, |diff| {abs(rows[0]['energy'] - e_ref):.2e} Ha)")
    check(int(rows[0]["found_pairs"]) == pairs,
          "spin flip: found_pairs disagrees with the host count")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "spin flip: energy disagrees with the Rayleigh quotient")
    check(launches["options_spin_flip"]["fused_matrix_elements"]
          == OPT_SPIN_STEPS, "spin flip: kernel #1 launches")
    del vmc, state

    # (b) The FCI vector's signs as the sign structure (a 2^20 table).
    e_fci, coef = _ground_state(h_sector)
    # The solver's global sign and the signs of coefficients that vanish
    # by symmetry are arbitrary: fix the largest positive and give the
    # vanishing ones phase 0, so that every call builds the same table.
    coef = coef * np.sign(coef[np.argmax(np.abs(coef))])
    table = np.zeros(1 << mol.qubit_num, np.float32)
    table[sector_dets.astype(np.int64)] = np.where(
        coef < -1e-12 * np.max(np.abs(coef)), np.pi, 0.0)
    log(f"options (b): sector FCI {e_fci:.8f} Ha, "
        f"{int(np.sum(table == np.pi))} signs pi")
    vmc = main_path_vmc(device="cuda", sign_structure=table)
    state = vmc.init_state()
    words, valid, la, ph = replay_set(vmc, state)
    want = torch.from_numpy(table).cuda()[words[:, 0][valid]]
    check(torch.equal(ph[valid], want), "sign structure: a phase is not its "
          "table entry")
    dets, psi = sorted_set(words, valid, la, ph)
    check(np.array_equal(dets, sector_dets), "sign structure: the set is "
          "not the sector")
    e_ref = quotient(h_sector, psi)
    rows, launches["options_sign"] = run_steps(
        torch, vmc, state, OPT_STEPS, "options (b) sign structure")
    log(f"options (b): every phase its table entry; step 0 energy "
        f"{rows[0]['energy']:.6f} (Rayleigh quotient {e_ref:.6f}, |diff| "
        f"{abs(rows[0]['energy'] - e_ref):.2e} Ha)")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "sign structure: energy disagrees with the Rayleigh quotient")
    del vmc, state

    # (c) Exact summation with the alpha orbitals first, then beta.
    perm = tuple(range(0, mol.qubit_num, 2)) + tuple(
        range(1, mol.qubit_num, 2))
    vmc = main_path_vmc(device="cuda", sampling_mode="exact",
                        qubit_perm=perm)
    check(vmc.exact_partner_idx is not None, "perm: no static membership")
    state = vmc.init_state()
    words, valid = vmc.exact_words, vmc.exact_valid
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
    dets, psi = sorted_set(words, valid, la, ph)
    h_perm = sector_hamiltonian(vmc.ham, dets)
    e_ref = quotient(h_perm, psi)
    e_fci_perm, _ = _ground_state(h_perm)
    log(f"options (c): permuted sector FCI {e_fci_perm:.8f} Ha (unpermuted "
        f"{e_fci:.8f}, |diff| {abs(e_fci_perm - e_fci):.2e}; the molecule's "
        f"{mol.fci_energy:.6f})")
    check(abs(e_fci_perm - e_fci) <= PERM_FCI_TOL,
          "perm: the permuted Hamiltonian's FCI moved")
    check(abs(e_fci - mol.fci_energy) <= 1e-6, "N2 sector FCI")
    rows, launches["options_perm"] = run_steps(
        torch, vmc, state, OPT_STEPS, "options (c) qubit_perm exact")
    log(f"options (c): step 0 {rows[0]['energy']:.6f}, permuted-sector "
        f"Rayleigh quotient {e_ref:.6f} (|diff| "
        f"{abs(rows[0]['energy'] - e_ref):.2e} Ha)")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-5,
          "perm: exact energy disagrees with the Rayleigh quotient")
    del vmc, state, h_perm

    # (d) Li2O: patterns, log_psi head, masking depth, bfloat16, the
    # 'bisect' top-k, MinSR without regularisation.
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    check(torch.equal(precision.store(x.cuda(), "bfloat16").cpu(),
                      precision.store(x, "bfloat16")),
          "bfloat16 storage rounds otherwise on the card")
    vmc = li2o_vmc(device="cuda", anqs_options=LI2O_OPTIONS,
                   topk_impl="bisect",
                   sr=SRConfig(max_indices_num=50, use_reg=False))
    check(vmc.anqs.aux is None and vmc.sector_words is None,
          "Li2O options: the log_psi head or the hash path is missing")
    state = vmc.init_state()
    words, valid, la, ph = replay_set(vmc, state)
    cpu_anqs = copy.deepcopy(vmc.anqs).cpu()
    with torch.no_grad():
        la_cpu = cpu_anqs.log_psi(words[:256].cpu())[0]
    la_gap = float(torch.max(torch.abs(la[:256].cpu() - la_cpu)))
    log(f"options (d): log|psi| of 256 rows on the card vs the CPU: max "
        f"|diff| {la_gap:.3e} (bfloat16 activations)")
    check(la_gap <= 5e-3, "bfloat16 net differs between card and CPU")
    li2o_dets, _ = sorted_set(words, valid, la, ph)
    li2o_pairs = pairs_in_set(vmc.ham, li2o_dets)
    n_alpha = np.zeros(len(li2o_dets), np.int64)
    n_beta = np.zeros(len(li2o_dets), np.int64)
    for q in range(0, vmc.mol.qubit_num, 2):
        n_alpha += ((li2o_dets >> np.uint64(q)) & np.uint64(1)).astype(
            np.int64)
        n_beta += ((li2o_dets >> np.uint64(q + 1)) & np.uint64(1)).astype(
            np.int64)
    outside = int(np.sum((n_alpha != vmc.mol.n_alpha)
                         | (n_beta != vmc.mol.n_beta)))
    calls = []
    select = sampler._select_top_k

    def recording(x, k, impl):
        calls.append((x, k))
        return select(x, k, impl)

    sampler._select_top_k = recording
    try:
        rows, launches["options_li2o"] = run_steps(
            torch, vmc, state, OPT_STEPS, "options (d) Li2O")
    finally:
        sampler._select_top_k = select
    x_last, k_last = calls[-1]
    v_b, i_b = exact_top_k(x_last, k_last)
    v_s, i_s = sampler._top_k(x_last, k_last)
    same = torch.equal(i_b, i_s) and torch.equal(v_b, v_s)
    log(f"options (d): last frontier {x_last.numel()} candidates, top "
        f"{k_last}: exact_top_k {'equals' if same else 'DIFFERS FROM'} the "
        f"ordered top-k; step 0 found_pairs {int(rows[0]['found_pairs'])} "
        f"(host {li2o_pairs}); {outside} of {len(li2o_dets)} samples "
        "outside the (N_alpha, N_beta) sector")
    check(same, "exact_top_k differs from the ordered top-k")
    check(int(rows[0]["found_pairs"]) == li2o_pairs,
          "Li2O options: found_pairs disagrees with the host count")
    check(launches["options_li2o"] == {"fused_matrix_elements": OPT_STEPS,
                                       "hash_lookup": OPT_STEPS,
                                       "hash_tags": OPT_STEPS,
                                       "fp_filter": 0},
          f"Li2O options launched {launches['options_li2o']}")
    del vmc, state, cpu_anqs, calls, x_last

    # (e) A 4-replica ensemble against standalone runs of seeds 0-3.
    vmc = main_path_vmc(device="cuda")
    ens = vmc.init_ensemble_state(OPT_REPLICAS)
    reset_launches()
    _, metrics = vmc._multi_step_ensemble(OPT_STEPS, OPT_REPLICAS)(ens)
    launches["options_ensemble"] = read_launches()
    e_ens = metrics["energy"]
    worst = 0.0
    for r in range(OPT_REPLICAS):
        vmc.config = vmc.config.replace(seed=r)
        solo = vmc.init_state()
        e_solo = [vmc.step(solo)["energy"] for _ in range(OPT_STEPS)]
        worst = max(worst, float(np.max(np.abs(e_ens[r] - e_solo)
                                        / np.abs(e_solo))))
        log(f"options (e) replica {r}: {np.round(e_ens[r], 6).tolist()}, "
            f"standalone seed {r}: {np.round(e_solo, 6).tolist()}")
    log(f"options (e): {OPT_REPLICAS} replicas x {OPT_STEPS} steps; "
        f"max relative |replica - standalone| {worst:.2e}; launches "
        f"{launches['options_ensemble']}")
    check(worst <= ENSEMBLE_RTOL, "ensemble replica differs from its "
          "standalone run")
    check(not np.allclose(e_ens[0], e_ens[1]), "replicas 0 and 1 agree")
    check(launches["options_ensemble"]["fused_matrix_elements"]
          == OPT_STEPS * OPT_REPLICAS, "ensemble: kernel #1 launches")
    del vmc, ens
    for path, counts in launches.items():
        check(counts["fused_matrix_elements"] > 0, f"{path}: no kernel #1")
    return launches


# The spin chains (``spin_phase``): three trainings to the exact energy
# with the settings and bounds of the JAX package's tests (name: sites,
# samples, iterations, relative bound above E0), each at qubit_per_qudit 2,
# MADE 64, lr 1e-2, seed 0, windows of 50 steps; then two chains at full
# width (MADE 512, qubit_per_qudit 4, 8192 Gumbel samples, MinSR top 50,
# clip 1.0, Adam 1e-3, seed 0) for SPIN_STEPS steps each: the open TFI
# chain at 64 sites (j = h = 1, 'auto' membership: prefilter) and the XY+DM
# chain at 40 sites (jxy 1, d 0.6, hash membership). Their exact ground
# energies are those of free fermions (``tfi_free_fermion_e0``,
# ``dm_free_fermion_e0``; equal to the dense diagonalisation at 8-12 and
# 4-10 sites to 1e-13), pinned here to seven decimals.
SPIN_TRAININGS = (
    ("dm6", 6, 64, 800, 0.01),  # JAX tests/test_spin_systems.py:191-215
    ("xxz8", 8, 128, 1200, 0.01),  # JAX tests/test_oracles.py:232-261
    ("tfi10", 10, 1024, 1000, 0.005),  # JAX tests/test_oracles.py:199-229
)
SPIN_WINDOW = 50
SPIN_STEPS = 5
SPIN_SAMPLES = 8192
TFI64_E0 = -81.1259801
DM40_E0 = -58.5609429
SPIN_E_TOL = 1e-4  # relative: the set's quotient is never below E0
SPIN_RQ_TOL = 1e-4  # Ha: step 0's energy against the host's quotient
SPIN_ELOC_TOL = 1e-4  # of max|e|: the engine's float32 against float64
# Of max(|E|, 1 Ha): a Hermitian H restricted to a set has a real
# quotient (the floor keeps a step whose energy passes near 0 from asking
# for more than float32 can give; a phase turned the wrong way gives
# imaginary parts of the order of the local energies).
SPIN_IMAG_TOL = 1e-5
# At the seed's own weights the full-width nets spread their 8192 samples
# over 2^40 or 2^64 states, and the set holds no connected pair besides
# the diagonal, so (b) and (c) would check nothing of the off-diagonal
# elements. The main net's output layer is scaled by this factor after
# init_state: the conditionals sharpen, the set gathers around the mode,
# and it holds thousands of pairs (3536 for DM-40, 648 off the diagonal
# for TFI-64 on the CPU at seed 0).
SPIN_SHARPEN = 16.0


def tfi_free_fermion_e0(n, j=1.0, h=1.0):
    """The open TFI chain's ground energy, -1/2 sum sigma_k over the
    singular values of A - B (A_ii = 2h, A_{i,i+-1} = -j, B_{i,i+1} = -j,
    B_{i+1,i} = j)."""
    import numpy as np

    off = np.full(n - 1, -j)
    a = np.diag(np.full(n, 2.0 * h)) + np.diag(off, 1) + np.diag(off, -1)
    b = np.diag(off, 1) - np.diag(off, -1)
    return -0.5 * float(np.linalg.svd(a - b, compute_uv=False).sum())


def dm_free_fermion_e0(n, jxy=1.0, d=0.6):
    """The open XY+DM chain's ground energy: an XX chain with hopping 2
    sqrt(jxy^2 + d^2), the sum of the negative eigenvalues of its n x n
    tridiagonal."""
    import numpy as np

    t = np.full(n - 1, 2.0 * np.hypot(jxy, d))
    ev = np.linalg.eigvalsh(np.diag(t, 1) + np.diag(t, -1))
    return float(ev[ev < 0].sum())


def spin_system(name, n):
    """(Hamiltonian, masker, reference determinant) of a spin chain of the
    phase: the XY+DM chain (idle masker), XXZ at Sz = 0 from the Neel state,
    or the TFI chain (idle masker), each from 0 but XXZ."""
    from anqs_quantum_chemistry_torch.applications import spin_systems as ss
    from anqs_quantum_chemistry_torch.symmetries import (
        Masker,
        idle_symmetry,
        particle_number_symmetry,
    )

    if name.startswith("dm"):
        return ss.dm_chain_hamiltonian(n), Masker([idle_symmetry(n)]), 0
    if name.startswith("xxz"):
        return (ss.heisenberg_xxz_hamiltonian(n),
                Masker([particle_number_symmetry(n, n // 2)]),
                sum(1 << i for i in range(0, n, 2)))
    return ss.tfi_hamiltonian(n), Masker([idle_symmetry(n)]), 0


def spin_vmc(name, n, **cfg):
    """A ``VMC`` on a spin chain of the phase, on the card."""
    from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
    from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig

    ham, masker, ref_det = spin_system(name, n)
    width = cfg.pop("width")
    return VMC(ham=ham, masker=masker, ref_det=ref_det,
               config=VMCConfig(sampling_mode="gumbel", seed=0,
                                symmetry_level="no_sym", **cfg),
               anqs_config=AnqsConfig(hidden_widths=(width,)),
               device="cuda")


def spin_steps(torch, vmc, label, e0):
    """``SPIN_STEPS`` steps from the seed's weights with the main net's
    output layer scaled by ``SPIN_SHARPEN``, the overflow policy after each
    as ``run`` acts; every energy finite and not below ``e0`` (less
    SPIN_E_TOL of |e0|), no row dropped, step 0's set holding connected
    pairs off the diagonal. Returns (rows, step 0's set (words, valid, la,
    ph), launches)."""
    import numpy as np

    state = vmc.init_state()
    depth = len(vmc.anqs.config.hidden_widths)
    out_layer = dict(vmc.anqs.main.named_parameters())
    with torch.no_grad():
        for name in (f"w{depth}", f"b{depth}"):
            out_layer[name].mul_(SPIN_SHARPEN)
    snap = replay_set(vmc, state)
    reset_launches()
    rows = []
    for i in range(SPIN_STEPS):
        row = vmc.step(state)
        rows.append(row)
        log(f"{label} step {i}: energy {row['energy']:.6f} energy_imag "
            f"{row['energy_imag']:.3e} unique_num {int(row['unique_num'])} "
            f"found_pairs {int(row['found_pairs'])} pf_dropped_rows "
            f"{int(row['pf_dropped_rows'])} table_overflow "
            f"{int(row['table_overflow'])}")
        vmc._handle_overflow({**row, "iter_idx": i})
    launches = read_launches()
    for i, row in enumerate(rows):
        check(np.isfinite(row["energy"]), f"{label} step {i}: energy")
        check(row["energy"] >= e0 - SPIN_E_TOL * abs(e0),
              f"{label} step {i}: energy {row['energy']} below E0 {e0}")
        check(int(row["pf_dropped_rows"]) == 0
              and int(row["table_overflow"]) == 0,
              f"{label} step {i}: membership dropped rows or keys")
        check(int(row["unique_num"]) == SPIN_SAMPLES,
              f"{label} step {i}: unique_num {row['unique_num']}")
    diagonal = 0 if vmc.ham.a_masks[0].any() else SPIN_SAMPLES
    check(int(rows[0]["found_pairs"]) > diagonal,
          f"{label}: step 0's set holds no pair off the diagonal")
    log(f"{label}: launches {launches}")
    return rows, snap, launches


def spin_phase(torch):
    """The spin chains on the card, with the launches of each path counted
    from 0: (a) the XY+DM chain at 6 sites, XXZ at 8 (Sz = 0) and the
    critical TFI chain at 10 trained through ``VMC.run`` to within the JAX
    tests' bounds of ``exact_ground_energy``; (b) the open TFI chain at 64
    sites at full width (output layer sharpened: ``spin_steps``), 'auto'
    membership (prefilter: both kernels), step
    0's pairs and energy against the host and every energy at or above the
    free-fermion E0; (c) the XY+DM chain at 40 sites at full width under
    hash membership, the odd-Y phase channel: step 0's pairs and every
    row's e_re and e_im against a float64 complex host oracle, the mean
    imaginary energy 0, every energy at or above the free-fermion E0,
    'auto' refused, kernel #1 on its duplicate flip masks equal to its
    plain version. Returns ({path: launches}, max|kernel - plain| of
    kernel #1)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.applications.spin_systems import (
        exact_ground_energy,
    )
    from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig

    launches = {}

    # (a) Trainings to the exact energy.
    for name, n, sample_num, iters, rel in SPIN_TRAININGS:
        vmc = spin_vmc(name, n, sample_num=sample_num,
                       qubit_per_qudit=2, lr=1e-2, iter_num=iters, width=64)
        e_exact = exact_ground_energy(vmc.ham)
        reset_launches()
        _, history, best = vmc.run(checkpoint_every=None,
                                   steps_per_call=SPIN_WINDOW, log_every=0)
        launches[f"spin_{name}"] = read_launches()
        gap = best["energy"] - e_exact
        log(f"spin (a) {name}: best {best['energy']:.6f} at iter "
            f"{best['iter']}, exact {e_exact:.6f}, gap {gap:+.3e} "
            f"({gap / abs(e_exact):+.2e} of |E0|; bound {rel:g}), last "
            f"energy_var {history[-1]['energy_var']:.3e}, {iters} steps, "
            f"launches {launches[f'spin_{name}']}")
        check(len(history) == iters, f"spin {name}: {len(history)} rows")
        check(best["energy"] < e_exact + rel * abs(e_exact),
              f"spin {name}: best {best['energy']} not within {rel:g} of "
              f"{e_exact}")
        check(best["energy"] > e_exact - 1e-3,
              f"spin {name}: best {best['energy']} below the exact energy")
        if name.startswith("tfi"):
            check(history[-1]["energy_var"] < 0.1,
                  f"spin {name}: last energy_var {history[-1]['energy_var']}")
        check(launches[f"spin_{name}"] == {"fused_matrix_elements": iters,
                                           "hash_lookup": 0, "hash_tags": 0,
                                           "fp_filter": 0},
              f"spin {name}: launches {launches[f'spin_{name}']}")
        del vmc

    full = dict(sample_num=SPIN_SAMPLES, qubit_per_qudit=4, lr=1e-3,
                grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
                width=512)

    # (b) TFI-64, real channel, prefilter membership.
    e0 = tfi_free_fermion_e0(64)
    log(f"spin (b) TFI-64 free-fermion E0 {e0:.7f} (pinned {TFI64_E0})")
    check(abs(e0 - TFI64_E0) < 1e-6, "TFI-64 E0")
    vmc = spin_vmc("tfi64", 64, **full)
    check(vmc.engine.membership == "prefilter",
          f"TFI-64 'auto' is {vmc.engine.membership}")
    check(vmc.engine.group_phase is None, "TFI-64 has a phase channel")
    log(f"spin (b) TFI-64: {vmc.ham.n_groups} groups, {vmc.ham.n_terms} "
        "terms")
    rows, snap, launches["spin_tfi64"] = spin_steps(
        torch, vmc, "spin (b) TFI-64", e0)
    pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    log(f"spin (b) TFI-64 step 0 on the host: found_pairs {pairs}, "
        f"Rayleigh quotient {e_ref:.6f} (|step - ref| "
        f"{abs(rows[0]['energy'] - e_ref):.2e})")
    check(int(rows[0]["found_pairs"]) == pairs,
          "TFI-64: found_pairs disagrees with the host count")
    check(abs(rows[0]["energy"] - e_ref) <= SPIN_RQ_TOL,
          "TFI-64: energy disagrees with the Rayleigh quotient")
    check(launches["spin_tfi64"] == {
        "fused_matrix_elements": 2 * SPIN_STEPS,
        "hash_lookup": 2 * SPIN_STEPS, "hash_tags": 2 * SPIN_STEPS,
        "fp_filter": SPIN_STEPS}, f"TFI-64 launches {launches['spin_tfi64']}")
    del vmc, snap

    # (c) DM-40, the odd-Y channel, hash membership.
    e0 = dm_free_fermion_e0(40)
    log(f"spin (c) DM-40 free-fermion E0 {e0:.7f} (pinned {DM40_E0})")
    check(abs(e0 - DM40_E0) < 1e-6, "DM-40 E0")
    vmc = spin_vmc("dm40", 40, engine_overrides={"membership": "hash"},
                   **full)
    check(vmc.engine.group_phase is not None, "DM-40: no phase channel")
    try:
        PauliEngine(vmc.ham, device="cuda", membership="auto")
    except ValueError as e:
        log(f"spin (c) DM-40 'auto' membership refused: {e}")
    else:
        raise SmokeFailure("DM-40: 'auto' (prefilter) accepted the odd-Y "
                           "channel")
    rows, snap, launches["spin_dm40"] = spin_steps(
        torch, vmc, "spin (c) DM-40", e0)
    words, valid, la, ph = snap
    with torch.no_grad():
        e = vmc.engine.local_energy_proxy(words, la, ph, valid)
    pairs, e_ref, e_host = host_local_energies(vmc.ham, words, valid, la, ph)
    keep = valid.cpu().numpy()
    e_re = e.e_re.double().cpu().numpy()[keep]
    e_im = e.e_im.double().cpu().numpy()[keep]
    scale = float(np.max(np.abs(e_host)))
    err = max(float(np.max(np.abs(e_re - e_host.real))),
              float(np.max(np.abs(e_im - e_host.imag))))
    log(f"spin (c) DM-40 step 0 on the host: found_pairs {pairs} (step "
        f"{int(rows[0]['found_pairs'])}), Rayleigh quotient {e_ref:.6f} "
        f"(step {rows[0]['energy']:.6f}), max|e - host| over "
        f"{int(keep.sum())} rows {err:.3e} (max|e| {scale:.3f})")
    check(int(rows[0]["found_pairs"]) == pairs == int(e.found_pairs),
          "DM-40: found_pairs disagrees with the host count")
    check(err <= SPIN_ELOC_TOL * scale,
          "DM-40: local energies disagree with the complex host oracle")
    check(abs(rows[0]["energy"] - e_ref) <= SPIN_RQ_TOL,
          "DM-40: energy disagrees with the Rayleigh quotient")
    for i, row in enumerate(rows):
        check(abs(row["energy_imag"])
              <= SPIN_IMAG_TOL * max(abs(row["energy"]), 1.0),
              f"DM-40 step {i}: mean imaginary energy {row['energy_imag']}")
    check(launches["spin_dm40"] == {
        "fused_matrix_elements": SPIN_STEPS, "hash_lookup": SPIN_STEPS,
        "hash_tags": SPIN_STEPS, "fp_filter": 0},
        f"DM-40 launches {launches['spin_dm40']}")
    # Kernel #1 on the duplicate flip masks, at the step's shapes.
    return launches, me_check(torch, "DM-40 (duplicate masks)", words,
                              vmc.engine.me_tables)


def cr2_phase(torch):
    """Cr2/SV at 84 qubits (the JAX package's ``examples/cr2_step.py`` and
    ``cr2_train.py`` at full width, ``experiments.vmc.cr2_vmc``): (a) the
    packaged molecule against the JAX record; (b) kernel #1 on its grouped
    W = 3 tables; (c) kernel #2 at K 3 / E 16 on a Cr2 set's table, K 4 on a
    random 100-qubit table, K 2 at E 8 and 16; (d) prefilter, hash and
    search membership on one set of the packaged JAX state ckpt_1000, and
    kernel #3 alone on a 128-row block of it (``fp_filter_check``); (e)
    one step at lr 0 from ckpt_1000 against the JAX record and the host;
    (f) ``CR2_STEPS`` steps from random weights; (g) the kernels' launches
    on (e)-(f). Returns (launches, max|kernel - plain| of kernel #1, of
    kernel #2)."""
    import copy

    import numpy as np

    from anqs_quantum_chemistry_torch.chem.molecule import load_cr2
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        CR2_ANQS,
        VMC,
        cr2_ckpt1000_params,
        cr2_config,
    )

    # (a) The packaged molecule.
    mol = load_cr2()
    ham = mol.qubit_ham
    log(f"Cr2/SV: {mol.qubit_num} qubits, sector ({mol.n_alpha}, "
        f"{mol.n_beta}), T {ham.n_terms}, M {ham.n_groups}, HF "
        f"{mol.hf_energy:.9f} (record "
        f"{CR2_HF:.9f}), MP2 {mol.mp2_energy:.9f} (record {CR2_MP2:.9f})")
    check((mol.qubit_num, mol.n_alpha, mol.n_beta, ham.n_terms,
           ham.n_groups) == (84, 24, 24, CR2_TERMS, CR2_GROUPS),
          "Cr2: sizes differ from the JAX record")
    check(abs(mol.hf_energy - CR2_HF) <= 1e-8
          and abs(mol.mp2_energy - CR2_MP2) <= 1e-8,
          "Cr2: HF or MP2 differs from the JAX record")

    vmc = VMC(mol, cr2_config(), CR2_ANQS, device="cuda")  # cr2_vmc's
    eng = vmc.engine
    log(f"Cr2 trainer: membership {eng.membership}, weights_matmul "
        f"{eng.weights_matmul}, hash_epb {eng.hash_epb}, me_chunk "
        f"{eng.me_chunk}, pf_row_chunk {eng.pf_row_chunk}, capacities (row "
        f"{eng.prefilter_row_capacity}, dense {eng.prefilter_dense_rows})")
    check((eng.membership, eng.weights_matmul) == ("prefilter", "grouped"),
          "Cr2: the engine does not resolve as JAX's")

    # One set of the JAX state ckpt_1000 (the step of (e) draws it again).
    state = vmc.init_state()
    vmc.anqs.load_state_dict(cr2_ckpt1000_params())
    snap = c2h4_set(torch, vmc, state.generator)
    words, valid, la, ph = snap
    log(f"Cr2 ckpt_1000 set: {words.shape[0]} rows, {int(valid.sum())} "
        "valid")

    # (b) Kernel #1 on the grouped W = 3 tables.
    k1_err = me_check(torch, f"Cr2 ({CR2_CHECK_ROWS} rows)",
                      words[:CR2_CHECK_ROWS], eng.me_tables)
    torch.cuda.empty_cache()

    # (c) Kernel #2 at the new layouts.
    tab, nb, overflow = eng._hash_build(words, la, ph, valid)
    check(int(overflow) == 0, "Cr2: the set's table overflowed")
    k2_err = lookup_check(
        torch, "the Cr2 set's table", tab,
        list(eng._hash_queries(words[:CR2_LOOKUP_ROWS])), eng.hash_epb)
    rng = np.random.default_rng(CR2_SEED)
    for n_qubits, epb in ((100, None), (64, 8), (64, 16)):
        rtab, cols, entries = random_key_table(torch, n_qubits, rng, epb)
        k2_err = max(k2_err, lookup_check(
            torch, f"a random {n_qubits}-qubit table", rtab, cols, entries))
    torch.cuda.empty_cache()

    # (d) Prefilter, hash and search membership on the set.
    engines = {"prefilter": eng}
    for name in ("hash", "search"):
        engines[name] = copy.copy(eng)
        engines[name].membership = name
    with torch.no_grad():
        results = {name: e.local_energy_proxy(words, la, ph, valid)
                   for name, e in engines.items()}
    ref = results["search"]
    t_max = float(torch.max(torch.abs(ref.t_re)))
    diffs = {name: float(torch.max(torch.abs(r.t_re - ref.t_re)))
             for name, r in results.items()}
    log("Cr2 memberships on the ckpt_1000 set: " + ", ".join(
        f"{name} found_pairs {int(r.found_pairs)} table_overflow "
        f"{int(r.table_overflow)} pf_dropped_rows {int(r.pf_dropped_rows)} "
        f"max|t - t_search| {diffs[name]:.3e}"
        for name, r in results.items()) + f"; max|t| {t_max:.3e}")
    pairs = {int(r.found_pairs) for r in results.values()}
    check(len(pairs) == 1, "Cr2: the memberships find other pairs")
    check(int(results["prefilter"].pf_dropped_rows) == 0,
          "Cr2: the prefilter dropped rows")
    check(all(d <= 1e-6 * t_max for d in diffs.values()),
          "Cr2: the memberships' t disagree")
    fptab = eng._hash_build(words, la, ph, valid, with_fp=True)[3]
    fp_filter_check(torch, f"a Cr2 row block ({eng.pf_row_chunk} rows of "
                    "the set)", fptab, words[:eng.pf_row_chunk], eng.a_cols)
    # The step of (e) reports its float64 estimator over these local
    # energies rounded to float32, as JAX's does: 2.4e-4 Ha a unit at 2086
    # Ha. The unrounded estimator is what (e) holds to the quotient.
    a_x = torch.where(valid, torch.exp(la), 0.0).double()
    e64 = float(torch.sum(a_x * results["prefilter"].t_re.double())
                / torch.sum(a_x**2))
    del results, ref, tab
    torch.cuda.empty_cache()

    # (e) One step at lr 0 from ckpt_1000; (f) steps from random weights.
    reset_launches()
    row = vmc.step(state, overrides={"lr": 0.0, "lr_schedule": None})
    host_pairs, e_ref, n_near = cr2_host_pairs_and_rayleigh(
        torch, mol, eng.a_words, *snap)
    ulp = float(np.spacing(np.float32(abs(e64))))
    log(f"Cr2 ckpt_1000, one step at lr 0: energy "
        f"{row['energy']:.7f} (JAX tail-50 mean {CR2_TAIL50:.7f}, diff "
        f"{(row['energy'] - CR2_TAIL50) * 1e3:+.4f} mHa; JAX best "
        f"{CR2_BEST:.7f}), found_pairs {int(row['found_pairs'])}, "
        f"pf_dropped_rows {int(row['pf_dropped_rows'])}, unique_num "
        f"{int(row['unique_num'])}; host ({n_near} pairs "
        f"with popcount <= 4): found_pairs {host_pairs}, Rayleigh quotient "
        f"from the integrals {e_ref:.7f}; the step's float64 estimator "
        f"{e64:.7f} (|e64 - ref| = {abs(e64 - e_ref):.2e} Ha, |step - e64| "
        f"= {abs(row['energy'] - e64):.2e}, float32 unit {ulp:.2e})")
    check(abs(row["energy"] - CR2_TAIL50) <= 2e-3,
          "Cr2 ckpt_1000: energy off the JAX record")
    check(int(row["found_pairs"]) == host_pairs,
          "Cr2 ckpt_1000: found_pairs differs from the host count")
    check(abs(e64 - e_ref) <= 1e-4,
          "Cr2 ckpt_1000: energy off the float64 Rayleigh quotient")
    check(abs(row["energy"] - e64) <= ulp,
          "Cr2 ckpt_1000: the step's energy is not its estimator's")
    state = vmc.init_state()
    rows = [vmc.step(state) for _ in range(CR2_STEPS)]
    launches = read_launches()
    log(f"Cr2 {CR2_STEPS} steps from random weights: energies "
        + ", ".join(f"{r['energy']:.6f}" for r in rows)
        + f"; found_pairs {[int(r['found_pairs']) for r in rows]}, "
        f"pf_dropped_rows {[int(r['pf_dropped_rows']) for r in rows]}; "
        f"launches {launches}")
    check(all(np.isfinite(r["energy"]) for r in rows),
          "Cr2: non-finite energy")
    blocks = -(-words.shape[0] // eng.pf_row_chunk)  # stage 1 and 3a's
    n = (blocks + 1) * (1 + CR2_STEPS)  # and 3b's
    check(launches == {"fused_matrix_elements": n, "hash_lookup": n,
                       "hash_tags": n, "fp_filter": blocks * (1 + CR2_STEPS)},
          f"Cr2: launches {launches}, expected {n} of kernels #1 and #2, "
          f"{blocks} of kernel #3 a step")
    return launches, k1_err, k2_err


def mesh_phase(torch):
    """The data-parallel legs of ``MESH_RUNS``: each rank's report of each
    leg logged, and each kernel of ``MESH_KERNELS`` launched on every rank.
    Returns the launches by path, summed over the ranks."""
    from anqs_quantum_chemistry_torch.experiments import dryrun_multichip

    by_path = {}
    for backend, plan in MESH_RUNS:
        try:
            spawned = dryrun_multichip.launch(plan, backend, "cuda", "full")
        except Exception as exc:  # a rank failed: its traceback says why
            raise SmokeFailure(f"mesh {backend} {plan}: {exc}")
        log(f"mesh: {backend}, {len(spawned)} rank(s) spawned")
        for n_ranks, legs in plan:
            tag = f"mesh_{backend}{n_ranks}"
            reports = [rep[n_ranks] for rep in spawned[:n_ranks]]
            for leg in legs:
                for rank, rep in enumerate(reports):
                    r = rep[leg]
                    shown = {k: v for k, v in r.items()
                             if not k.endswith(("_ms", "_s"))
                             and k not in ("ms", "later_energies",
                                           "energies")}
                    log(f"  {leg} rank {rank}: {shown}")
                    for kernel in MESH_KERNELS[leg]:
                        check(r["launches"][kernel] > 0,
                              f"{tag} {leg} rank {rank}: {kernel} not "
                              "launched")
                by_path[f"{tag}_{leg}"] = {
                    k: sum(rep[leg]["launches"][k] for rep in reports)
                    for k in reports[0][leg]["launches"]}
    return by_path


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="numpy seed of the direct-CI sigma's random "
                        "vectors (default 0)")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from anqs_quantum_chemistry_torch.chem.molecule import load_n2
    from anqs_quantum_chemistry_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    build_logs = cuda_build.build(["fused_me", "hash_lookup"])
    for name, text in build_logs.items():
        instance = name
        for line in text.splitlines():
            # ptxas -v names each entry function (mangled) before its
            # resource lines; label those by the kernel's template
            # arguments (W of fused_me; K, E and the tag tier of
            # hash_lookup).
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                targs = re.findall(r"L[ib](\d+)E", found.group(1))
                instance = f"{name}<{','.join(targs)}>" if targs else name
            elif "registers" in line or "spill" in line:
                log(f"  {instance}: {line.strip()}")

    mol = load_n2()
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        li2o_vmc,
        main_path_vmc,
    )

    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = np.concatenate([dets, np.full(64, 0xFFFFFFFF, np.uint64)])
    words = torch.from_numpy(words.astype(np.int64)[:, None]).cuda()
    me_errs = [kernel_phase(torch, mol, words)]

    n2 = main_path_vmc(device="cuda")
    membership_crosscheck_phase(torch, mol, n2)
    n2_launches = trainer_phase(torch, mol, n2)
    del n2

    li2o = li2o_vmc(device="cuda")
    hash_err, tags_err, err = hash_lookup_phase(torch, li2o)
    me_errs.append(err)
    li2o_launches = li2o_trainer_phase(torch, li2o)
    del li2o

    exact_launches = n2_exact_phase(torch, mol)
    driver_launches = n2_driver_phase(torch)
    multinomial_launches = li2o_multinomial_phase(torch)

    me_errs.append(c2h4_phase(torch))
    c2h4_launches = c2h4_trainer_phase(torch)
    nade_launches = li2o_nade_phase(torch)
    sci_launches, err = li2o_support_ci_phase(torch)
    me_errs.append(err)
    c2h4_sci_launches, err = c2h4_cisd_sci_phase(torch)
    me_errs.append(err)
    chem_launches, err = chem_build_phase(torch, args.seed)
    me_errs.append(err)
    cr2_launches, err, cr2_hash_err = cr2_phase(torch)
    me_errs.append(err)
    options_launches = options_phase(torch, mol)
    spin_launches, err = spin_phase(torch)
    me_errs.append(err)
    mesh_launches = mesh_phase(torch)

    # Each kernel's launches on the path it was ported for (kernel #3's: the
    # Cr2 path, which the benchmark's cr2.prefilter cell runs); every
    # path's counts stand beside them.
    csrc = "anqs_quantum_chemistry_torch/csrc/"
    pallas = "anqs_quantum_chemistry_tpu/ops/pallas_kernels.py:"
    hash_common = {"route": "cuda", "source": csrc + "hash_lookup.cu",
                   "replaces": pallas + "32", "tol": HASH_TOL, "ok": True}
    entries = [
        {"name": "fused_matrix_elements", "route": "cuda",
         "source": csrc + "fused_me.cu", "replaces": pallas + "100",
         "launches": n2_launches["fused_matrix_elements"],
         "max_abs_err": max(me_errs), "tol": ME_TOL, "ok": True},
        dict(hash_common, name="hash_lookup",
             launches=li2o_launches["hash_lookup"],
             max_abs_err=max(hash_err, cr2_hash_err)),
        dict(hash_common, name="hash_tags",
             launches=li2o_launches["hash_tags"], max_abs_err=tags_err),
        {"name": "fp_filter", "route": "cuda",
         "source": csrc + "hash_lookup.cu", "replaces": None,
         "launches": cr2_launches["fp_filter"], "max_abs_err": 0, "tol": 0,
         "ok": True},
    ]
    by_path = {"n2": n2_launches, "li2o": li2o_launches,
               "n2_exact": exact_launches, "n2_driver": driver_launches,
               "li2o_multinomial": multinomial_launches,
               "c2h4_transformer": c2h4_launches,
               "li2o_nade": nade_launches,
               "li2o_support_ci": sci_launches,
               "c2h4_cisd_sci": c2h4_sci_launches,
               "n2_dissociation": chem_launches,
               "cr2": cr2_launches, **options_launches, **spin_launches,
               **mesh_launches}
    for entry in entries:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in by_path.items()}

    elapsed = time.monotonic() - T_START
    log(f"total: {elapsed:.1f} s")
    check(elapsed < TIME_LIMIT_S, f"took {elapsed:.0f} s")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
