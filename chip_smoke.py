#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``anqs_quantum_chemistry_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
It builds every CUDA kernel of the port from the sources in this checkout
(one ``nvcc`` each, all started together), holds each against its plain
PyTorch version on the card at the shapes of the paths that run it and
times both, then drives the port's two training paths through ``VMC(...)``,
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
  memory), and timed as the median of 5 batches of 20 calls.

Then the driver (all three from random weights, seed 0, counts set to 0
before each and read after):

- N2 exact summation (``main_path_vmc`` with ``sampling_mode='exact'``: the
  whole sorted sector, static membership) for 3 steps. Step 0 shares the
  Gumbel path's weights and determinants, so its energy must equal
  ``N2_ENERGIES[0]`` within 1e-5 Ha and the float64 Rayleigh quotient within
  1e-4 Ha; before it, the unbiased full energy of those weights (all 7.7M
  partners through the network, timed) must equal the Rayleigh quotient
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
first 64 rows; it is timed beside the plain version and, where the (T, M)
float32 one-hot fits in the card's free memory, the dense two-matmul form.

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
  and ``_combine``, so they are not bit-identical). Each prefilter stage
  is timed by its spans (``prefilter_stage_ms``), kernels #1 and #2 alone
  at its shapes (``prefilter_kernels``), and kernel #3 (stage 1) alone on
  the set as one block, bit for bit its plain version, beside its bound
  (``fp_filter_figures``).
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
  float64 Rayleigh quotient over it. Both kernels are timed at the
  prefilter's two shapes (3a: all rows x 768 candidates; 3b: the dense
  rows x every group) beside their bounds.
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
  (the C++ builder on the host: time, nnz 848,626) and its ground state
  (``restricted_ground_state``) within 1e-8 Ha of the JAX package's.
- (b) ckpt_26: ``support_rayleigh`` over those 8192 within 2e-6 Ha, and
  ``support_ci.polish``'s loss and mass (temperature 2, linear lam 30) over
  all 131,072 rows within 1e-5 relative, of the JAX package's float32
  values on the CPU (the TPU's records printed beside them); two sampled
  full energies at 16,384 (seeds 1 and 2) within 0.05 mHa of the TPU's
  confirmations (mean -88.705147) and within chemical accuracy of FCI.
- (c) ckpt_13: the loss of ``examples/li2o_sci_polish.py`` (temperature 4,
  quadratic lam 1000) within 1e-5 relative of JAX's, then 20 full-batch
  steps of that polish at lr 1e-4: the loss falls; ms a step and the peak
  memory.
- (d) 50 distillation steps (batch 8192, lr 3e-4) from the packaged
  closure state: finite, falling, ms a step.
- (e) 3 steps of the pinned-support VMC (``li2o_pin_vmc``, 8192 pinned
  target determinants) from ckpt_13: step 0 within 0.2 mHa of the JAX
  run's iteration 0, no row dropped, ``found_pairs`` equal to a host
  count and the energy within 1e-4 Ha of the float64 Rayleigh quotient
  over its own set.
- (f) 5 ``support_vmc`` steps (rq) and 10 L-BFGS iterations on the 8192
  support from ckpt_26: the first rq within 1e-6 Ha of JAX's, nothing
  NaN. Kernel #1 launches once for each full energy, kernels #1 and #2
  twice and kernel #3 once for each pinned step; kernel #1 is timed at the full energy's 16,384
  rows and both at the pinned step's prefilter shapes.

Last, the C2H4/6-31G CISD -> support-CI chain (the JAX package's
``runs/c2h4_cisd_made``, ``runs/c2h4_sci`` and
``runs/c2h4_cisd_transformer_emp_lr0.0001`` at full width: 52 qubits,
MADE-2048 with a 512-wide phase net and the 8-head transformer,
qubit_per_qudit 4, 8192 Gumbel samples, prefilter at (768, 4096); the
packaged CISD vector, selected-CI target and JAX states ckpt_4000, ckpt_47
and ckpt_3000), counts set to 0 before (c) and read after (f):

- (a) The spin-orbital integrals rebuilt from the packaged spatial form,
  and the host's H over the CISD vector's top 4096 (time, nnz) with its
  ground state within 1e-8 Ha of the JAX package's.
- (b) 100 pretraining steps of a fresh MADE-2048 on the CISD vector at
  batch 8192: the loss falls; ms a step.
- (c) ckpt_4000 in ``cisd_pretrain_vmc``'s MADE trainer (MinSR top 50,
  clip 0.5, Born weights): steps at lr 0, the overflow policy after each,
  until one drops no row; its ``found_pairs`` equal to a host count, its
  energy within 1e-4 Ha of the float64 Rayleigh quotient over its own set
  and within 1 mHa of JAX's last rows; then ``run()`` for 5 steps.
- (d) ckpt_47: ``support_rayleigh`` over the target's top 8192 within 1e-5
  Ha, and the example's polish loss and mass (temperature 4, linear lam
  30, chunks of 8192) over all 262,144 rows within 1e-5 relative, of the
  JAX package's float32 CPU values; one sampled full energy at 8192 (row
  chunks of 1024) within 0.05 mHa of the TPU's confirmations (time, peak
  memory).
- (e) 20 full-batch polish steps at 262,144 rows from ckpt_47, 50
  distillation steps from ckpt_4000, and on the top-8192 support from
  ckpt_47 5 ``support_vmc`` steps (rq), 5 ``rq_refit`` steps (beta 0.05,
  clip 1.0) and 10 L-BFGS evaluations: ms a step and peak memory each.
- (f) The transformer (ckpt_3000, 'highest'): log|psi| over the target's
  top 512 against JAX's float32 values (``data/c2h4_transformer_logpsi.
  npz``; 1e-5 + 1e-5 |la|, the phase to 1e-4), a clean step at lr 0 in its
  trainer (empirical weights, no SR) against the host as in (c), and a
  sampled full energy at 512 (row chunks of 128): finite; time and peak
  memory. Kernels #1 and #2 launch twice a step, kernel #3 once a step,
  kernel #1 once a row chunk of each full energy.
- (g) Both kernels at (c)'s prefilter shapes and kernel #1 at the full
  energy's row chunk (1024) and whole sample (8192), against their plain
  versions (bit for bit) and bounds.

Last, the host chemistry layer and direct CI (``chem_build_phase``), counts
set to 0 before (b) and read after it:

- (a) N2/STO-3G at 2.0 angstrom built from atoms by ``Molecule.create``
  into a temporary ``mols_dir``: HF, CISD and FCI within 1e-8 Ha of the JAX
  package's record (``N2_R_*``), the host time of each stage; kernel #1
  against its plain version at its Hamiltonian (9454 terms in 1744
  groups), timed beside its bound.
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
  to float32 (the record's arithmetic) within 1e-8 Ha of the record; the Davidson iterations, the residual, the host time of
  the tables, ms a float32 sigma, the float64 quotient's and the solve's
  time and the peak memory printed.

Last, Cr2/SV at 84 qubits (``cr2_phase``: the JAX package's
``examples/cr2_step.py`` and ``cr2_train.py`` at full width through
``experiments.vmc.cr2_vmc``: three words a determinant, 2,240,694 terms in
471,774 groups, MADE 1024 with logit_cap 8, qubit_per_qudit 6, 1024
Gumbel samples and the 64 pinned HF neighbours, prefilter membership in
128-row blocks at capacities (1024, 64), the 'grouped' group order),
counts set to 0 before (e) and read after (f):

- (a) The packaged molecule (``data/cr2_sv.npz``, built by the port)
  loaded and timed; its sizes and sector exactly, HF and MP2 within 1e-8
  Ha of the JAX record (``CR2_*``).
- (b) Kernel #1 on its W = 3 tables: ``CR2_CHECK_ROWS`` rows of a set of
  the packaged JAX state ckpt_1000 bit for bit against its plain version,
  timed beside its bound (the dense library form's (T, M) one-hot does
  not fit); the whole 1088-row set in one launch, timed.
- (c) Kernel #2 and its tag build bit for bit against their plain
  versions at K 3 / E 16 on that set's table (the partners of
  ``CR2_LOOKUP_ROWS`` rows), at K 4 / E 16 on a random 100-qubit table
  and at K 2 / E 8 and E 16 on random 64-qubit tables (numpy
  ``CR2_SEED``), each timed beside its bound.
- (d) Prefilter, hash and search membership on that set: the same pairs,
  t within 1e-6 of max|t|, no row dropped; each membership's time and
  each prefilter stage's (the set as one row block); kernel #3 (stage 1)
  on the set's first 128-row block against the set's fingerprint table (nb
  512 x E 16, in shared memory), bit for bit its plain version, timed
  beside its operation bound and the plain version's time.
- (e) ckpt_1000, one step at lr 0: within 2 mHa of the JAX run's tail-50
  mean, ``found_pairs`` equal to a host count, and the step's float64
  estimator within 1e-4 Ha of the float64 Rayleigh quotient over its own
  set built from the integrals (``chem/fci.matrix_element`` on every pair
  with popcount(x ^ y) <= 4; the step reports that estimator rounded to
  float32, as JAX's does, 2.4e-4 Ha a unit at 2086 Ha).
- (f) ``CR2_STEPS`` steps from random weights (seed 0): finite energies,
  ms a step, peak memory; kernels #1 and #2 (and the tag build) once a
  row block and once for the dense rows each step, kernel #3 once a row
  block (9 a step).

Last, the ansatz and step options of the JAX package (``options_phase``),
from seed 0 at full width, each leg's step time printed and its launches
counted from 0 (paths ``options_spin_flip``, ``options_sign``,
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
  frontier (both timed); finite energies; step 0's ``found_pairs`` equal to
  a host count (hash membership: masking depth lets samples leave the
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
  above the exact energy less 1e-3; ms a step.
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
  the set bit for bit against its plain version, timed.

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
each leg (each nonzero where the leg runs the kernel) and its ms a step; the
ranks share one card, so those times are no scaling figure.

Last, the trainer's measurement surface (``measure``) on ``bench.py``'s
three N2 configurations (``bench.py:48-81`` without JAX's table layout
override: the sampled sector headline, the same with
``sector_membership='off'``, exact summation) and the Li2O toy model
(hash membership: kernel #2): for each, ``VMC.step_cost_analysis()`` (its
totals and top five sources; kernel #1's entry nonzero, and kernel #2's at
Li2O), ``VMC.profile_stages(reps=10)`` (CUDA events), and the host-clock
ms a step of one synchronised ``VMC._multi_step(25)`` window after a
25-step warm-up window, with every kernel's launches counted in that
window (kernel #1 once a step; kernels #2 and the tag build once a step at
Li2O; kernel #3 never) and its energies finite.

Every line is flushed as it is printed. The line before the last is
``{"kernels": [...]}``, the last ``{"ok": true, "device": {...}}``; any failed
check exits non-zero before either. Imports torch, numpy, scipy and the
port only.
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
# The measurement phase: bench.py's three N2 configurations (VMC overrides
# of ``main_path_vmc``) and the Li2O toy model; its window of steps.
MEASURE_CONFIGS = (
    ("n2_sector", "n2", {}),
    ("n2_dynamic", "n2", {"sector_membership": "off"}),
    ("n2_exact", "n2", {"sampling_mode": "exact", "sample_num": 16384}),
    ("li2o", "li2o", {}),
)
MEASURE_WINDOW = 25
MEASURE_TOP = 5
# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores. The float64 add rate outside the tensor cores (64 lanes an
# SM) is set in main() from the card's SM count and maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_LANES_PER_SM = 64
FP64_ADDS_PER_S = None
# Kernel #3's rates, set in main() the same way: an SM's INT32 pipe has 64
# lanes (logic, shifts, compares), and its four schedulers dispatch one
# 32-lane instruction a clock each, 128 lanes, whatever the pipe.
INT32_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
INT32_OPS_PER_S = None


class SmokeFailure(Exception):
    pass


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warmup=3):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def median_ms(fn, batches=5, reps=20):
    """Median over ``batches`` of the mean device time of ``reps``
    back-to-back calls of ``fn``, after 3 warm-up calls."""
    import statistics

    return statistics.median(cuda_ms(fn, reps, warmup=3 if i == 0 else 0)
                             for i in range(batches))


def kernel_device_ms(fn, kernels, reps=20):
    """{kernel: mean device time (ms) of one launch} over ``reps`` calls of
    ``fn``, from ``torch.profiler``'s kernel records whose name contains
    each of ``kernels``: the kernels' own time, without the host time of
    the wrappers that launch them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for kernel in kernels:
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and kernel in ev.key]
        check(sum(ev.count for ev in events) == reps,
              f"profiler: {kernel} launched {[ev.count for ev in events]}")
        out[kernel] = sum(ev.self_device_time_total for ev in events) / (
            1e3 * reps)
    return out


def me_bound(words, tables):
    """(bytes moved, bytes ms, operations ms) of kernel #1 on ``words``:
    each operand of the function read once -- W 32-bit words a row, W
    sign-mask words and three bf16 splits a term (4W + 6 B), the group
    offsets and the tiles' group and term offsets -- and the (B, M) float32
    output written once; three float64 adds per (row, term) pair, one a
    split (the rounding contract), at the SMs' float64 rate."""
    n_rows, n_words = words.shape
    n_terms = tables.splits.shape[1]
    n_bytes = (n_rows * n_words * 4 + n_terms * (4 * n_words + 6)
               + tables.group_starts.numel() * 4
               + tables.kernel.tile_starts.numel() * 4
               + n_rows * tables.n_groups * 4)
    return (n_bytes, n_bytes / HBM_BYTES_PER_S * 1e3,
            3.0 * n_rows * n_terms / FP64_ADDS_PER_S * 1e3)


def dense_library(torch, words, tables):
    """The yardstick (never called by the port): the dense two-matmul
    float32 form, sign @ (T, M) one-hot of the weights. Returns (callable,
    None), or (None, why) where its operands do not fit in free memory."""
    from anqs_quantum_chemistry_torch.ops import bits
    from anqs_quantum_chemistry_torch.ops.matrix_elements import _sign_bits

    n_rows, n_terms = words.shape[0], tables.splits.shape[1]
    n_groups = tables.n_groups
    need = 4 * (n_terms * n_groups + 3 * n_rows * n_terms + n_rows * n_groups)
    free, _ = torch.cuda.mem_get_info()
    if need > 0.7 * free:
        return None, (f"not timed: (T, M) dense is "
                      f"{n_terms * n_groups * 4 / 1e9:.1f} GB, all operands "
                      f"{need / 1e9:.1f} GB of {free / 1e9:.1f} GB free")
    group_id = torch.repeat_interleave(
        torch.arange(n_groups, device="cuda"),
        torch.diff(tables.group_starts.to(torch.int64)),
    )
    dense = torch.zeros((n_terms, n_groups), dtype=torch.float32,
                        device="cuda")
    dense[torch.arange(n_terms, device="cuda"), group_id] = (
        tables.splits.to(torch.float32).sum(0))
    x = bits.unpack(words, tables.qubit_num, dtype=torch.float32)
    b_bits = _sign_bits(tables.b_words, tables.qubit_num)

    def library():
        p = x @ b_bits
        return (1.0 - 2.0 * torch.remainder(p, 2.0)) @ dense

    return library, None


def me_figures(torch, label, words, tables, reps, plain_reps):
    """Kernel #1 against its plain version on ``words``, bit for bit, and
    its time beside the plain version's, the dense library form's and its
    bound. Returns the figures; fails on any disagreement."""
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
    del plain

    ms = cuda_ms(lambda: fused_matrix_elements(words, tables), reps=reps)
    plain_ms = cuda_ms(lambda: matrix_elements_plain(words, tables),
                       reps=plain_reps, warmup=1)
    library, why = dense_library(torch, words, tables)
    if library is None:
        library_ms, lib_note = None, why
    else:
        lib_err = float((library() - me).abs().max())
        library_ms = cuda_ms(library, reps=plain_reps, warmup=1)
        lib_note = (f"dense two-matmul library form {library_ms:.4f} ms "
                    f"(max|lib - kernel| = {lib_err:.3e})")
    del library
    torch.cuda.empty_cache()
    n_bytes, bytes_ms, ops_ms = me_bound(words, tables)
    bound_ms = max(bytes_ms, ops_ms)
    log(f"kernel timing at {label}: {ms:.4f} ms ({ms / bound_ms:.1f}x its "
        f"bound), plain {plain_ms:.4f} ms, {lib_note}; bound "
        f"{bound_ms * 1e3:.2f} us = max(bytes {bytes_ms * 1e3:.2f} us: "
        f"{n_bytes / 1e6:.1f} MB moved, float64 adds {ops_ms * 1e3:.2f} "
        f"us: {3 * n_rows * n_terms / 1e6:.0f}M)")
    return {
        "B": n_rows, "T": n_terms, "M": tables.n_groups,
        "W": words.shape[1], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def kernel_phase(torch, mol, words):
    from anqs_quantum_chemistry_torch.chem.fci import sector_matrix_elements
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        build_tables,
        fused_matrix_elements,
    )

    ham = mol.qubit_ham
    tables = build_tables(ham, "cuda")
    figures = me_figures(torch, "N2", words, tables, reps=50, plain_reps=5)

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
    return {
        "name": "fused_matrix_elements",
        "route": "cuda",
        "source": "anqs_quantum_chemistry_torch/csrc/fused_me.cu",
        "replaces": "anqs_quantum_chemistry_tpu/ops/pallas_kernels.py:100",
        "launches": None,
        "max_abs_err": figures["max_abs_err"],
        "tol": ME_TOL,
        "ok": True,
        "ms": figures["ms"],
        "plain_ms": figures["plain_ms"],
        "bound_ms": figures["bound_ms"],
        "bound_by": figures["bound_by"],
        "library_ms": figures["library_ms"],
        "by_molecule": {"n2": figures},
    }


def c2h4_phase(torch, me_entry):
    """Kernel #1 at the full C2H4/6-31G tables on ``C2H4_ROWS`` random
    determinants of its (8, 8) sector (numpy, seed 0)."""
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

    t = time.perf_counter()
    mol = load_c2h4()
    ham = mol.qubit_ham
    dets = random_sector_dets(mol.n_orbitals, mol.n_alpha, mol.n_beta,
                              C2H4_ROWS, np.random.default_rng(0))
    words = np.stack([dets & np.uint64(0xFFFFFFFF), dets >> np.uint64(32)],
                     axis=1).astype(np.int64)
    words = torch.from_numpy(words).cuda()
    tables = build_tables(ham, "cuda")
    log(f"C2H4 set-up: {time.perf_counter() - t:.2f} s")
    figures = me_figures(torch, "C2H4", words, tables, reps=10,
                         plain_reps=1)
    rows = 64
    me = fused_matrix_elements(words[:rows], tables).cpu().double()
    ref = torch.from_numpy(sector_matrix_elements(ham, dets[:rows]))
    ref_err = float(((me - ref).abs() - 2.4e-7 * ref.abs()).max())
    log(f"C2H4 kernel vs float64 host reference ({rows} rows): max excess "
        f"over one float32 ulp = {ref_err:.3e} Ha")
    check(ref_err <= 1e-6, "C2H4: kernel disagrees with the float64 "
          "reference")
    me_entry["by_molecule"]["c2h4"] = figures
    me_entry["max_abs_err"] = max(me_entry["max_abs_err"],
                                  figures["max_abs_err"])


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
        t = time.perf_counter()
        row = vmc.step(state)
        dt = time.perf_counter() - t
        rows.append(row)
        log(f"step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f} step_s {dt:.4f} "
            f"launches {read_launches()}")
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


def lookup_bound(n_q, key_words, tab, entries=32):
    """(bytes moved, bytes ms, operations ms) of kernel #2 on ``n_q``
    queries of ``key_words`` 32-bit words into table ``tab`` of
    ``entries`` entries a bucket: each input read once -- 4 B a key word
    and the table -- and the (la, ph, found) outputs written once; per
    query the hash (9 integer operations for each of the K - 1 mixes of K
    = max(key_words, 2) words) and K + 1 compares of each entry, counted at
    the float32 rate (the data sheet gives no integer rate outside the
    tensor cores)."""
    k = max(key_words, 2)
    n_bytes = n_q * 4 * key_words + tab.numel() * 4 + n_q * (4 + 4 + 1)
    return (n_bytes, n_bytes / HBM_BYTES_PER_S * 1e3,
            n_q * (9 * (k - 1) + (k + 1) * entries) / FP32_FLOP_PER_S * 1e3)


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


def fp_filter_bound(n_rows, n_words, n_groups, n_buckets, entries):
    """(bytes moved, bytes ms, operations ms) of kernel #3 on ``n_rows``
    rows of ``n_words`` words against ``n_groups`` masks and an
    (``n_buckets``, ``entries``) fingerprint table: the rows (8 B a word),
    the planar masks (4 B a word) and the table read once, the (B, M) bool
    mask written once; the ``fp_filter_ops`` instructions a partner, the
    INT32 pipe's at its rate and all of them at the dispatch rate, whichever
    takes longer."""
    partners = n_rows * n_groups
    n_bytes = (8 * n_rows * n_words + 4 * n_words * n_groups
               + 4 * n_buckets * entries + partners)
    alu, fma = fp_filter_ops(n_words, entries)
    dispatch_per_s = (INT32_OPS_PER_S * DISPATCH_LANES_PER_SM
                      / INT32_LANES_PER_SM)
    ops_s = partners * max(alu / INT32_OPS_PER_S, (alu + fma) / dispatch_per_s)
    return n_bytes, n_bytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def fp_filter_figures(torch, label, fptab, words, a_cols):
    """Kernel #3 (the prefilter's stage 1) alone on ``words`` against
    ``fptab``: bit for bit its plain version, then timed (median of 5 x
    20) beside its bound and the plain version's time. Returns the
    figures."""
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
        ms = median_ms(lambda: fp_filter(fptab, words, a_cols))
        plain_ms = cuda_ms(lambda: fp_filter_plain(fptab, words, a_cols),
                           reps=2, warmup=1)
    (b, w), m, (nb, e) = words.shape, a_cols.shape[1], fptab.shape
    _, bytes_ms, ops_ms = fp_filter_bound(b, w, m, nb, e)
    figures = {"B": b, "W": w, "M": m, "nb": nb, "E": e,
               "smem": fp_in_shared_memory(nb, e), "hits": int(got.sum()),
               "ms": ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "plain_ms": plain_ms}
    log(f"kernel fp_filter at {label} (B {b}, W {w}, M {m}, nb {nb} x E "
        f"{e}, {'shared' if figures['smem'] else 'global'} memory): "
        f"{ms:.4f} ms, bound {figures['bound_ms'] * 1e3:.2f} us "
        f"({figures['bound_by']}; {ms / figures['bound_ms']:.2f}x); plain "
        f"{plain_ms:.3f} ms; {figures['hits']} hits, equal")
    return figures


def hash_lookup_phase(torch, vmc):
    """Kernel #2 and its tag build against their plain versions, bit for
    bit, on three tables: Li2O's (8192 sampled rows, queries of all 3072
    groups), a two-word set with real high words, and Li2O's set in a table
    above the shared-memory tier; both kernels timed on the first and the
    lookup on the third. Also holds kernel #1 against its plain version at
    Li2O's shapes and times it; returns the three kernels' figures."""
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
    big_ms = median_ms(lambda: hash_lookup(tab_big, q_lo, q_hi))
    del tab_big

    ms = median_ms(lambda: hash_lookup(tab, q_lo, q_hi))
    tags_call_ms = median_ms(lambda: hash_tags(tab))
    device = kernel_device_ms(lambda: hash_lookup(tab, q_lo, q_hi),
                              ("hash_lookup_kernel", "hash_tags_kernel"))
    tags_ms = device["hash_tags_kernel"]
    plain_ms = cuda_ms(lambda: hash_lookup_plain(tab, q_lo, q_hi), reps=2,
                       warmup=1)
    tags_plain_ms = cuda_ms(lambda: hash_tags_plain(tab), reps=5, warmup=1)
    key_words = 1 if q_hi is None else 2
    n_bytes, bytes_ms, ops_ms = lookup_bound(q_lo.numel(), key_words, tab)
    bound_ms = max(bytes_ms, ops_ms)
    # The tag build reads three planes of the table once (key_lo, key_hi
    # and log|psi|; never the phase) and writes a byte a slot; per slot,
    # the hash (9 operations) and the empty-slot compare.
    tag_bytes = 3 * 4 * nb * ENTRIES + nb * ENTRIES
    tag_bytes_ms = tag_bytes / HBM_BYTES_PER_S * 1e3
    tag_ops_ms = nb * ENTRIES * 10 / FP32_FLOP_PER_S * 1e3
    tag_bound_ms = max(tag_bytes_ms, tag_ops_ms)
    log(f"hash_lookup timing (median of 5 x 20 calls, tag build included): "
        f"{ms:.4f} ms ({ms / bound_ms:.2f}x its bound), plain "
        f"{plain_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us "
        f"({n_bytes / 1e6:.1f} MB moved with {key_words} 32-bit key word(s) "
        f"a query); at nb {nb_big} (tags in global memory) {big_ms:.4f} ms")
    log(f"device time a launch (torch.profiler, 20 calls): lookup kernel "
        f"{device['hash_lookup_kernel']:.4f} ms, tag build "
        f"{tags_ms:.4f} ms")
    log(f"hash_tags timing: {tags_ms:.4f} ms on the device (the wrapper "
        f"alone, median of 5 x 20 calls: {tags_call_ms:.4f} ms, bound by "
        f"its host time), plain {tags_plain_ms:.4f} ms; bound "
        f"{tag_bound_ms * 1e3:.3f} us ({tag_bytes / 1e3:.0f} KB moved)")
    log("hash_lookup, hash_tags library_ms: null (no single PyTorch call "
        "computes a bucket-hash lookup or its tags)")

    # Kernel #1 at Li2O's shapes.
    li2o_figures = me_figures(torch, "Li2O", words, eng.me_tables, reps=20,
                              plain_reps=2)
    common = {"route": "cuda",
              "source": "anqs_quantum_chemistry_torch/csrc/hash_lookup.cu",
              "replaces": "anqs_quantum_chemistry_tpu/ops/pallas_kernels.py:32",
              "launches": None, "tol": HASH_TOL, "ok": True,
              "library_ms": None}
    lookup_entry = dict(
        common, name="hash_lookup", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        ms_global_tier=big_ms,
        kernel_device_ms=device["hash_lookup_kernel"],
    )
    tags_entry = dict(
        common, name="hash_tags", max_abs_err=tag_err, ms=tags_ms,
        plain_ms=tags_plain_ms, bound_ms=tag_bound_ms,
        bound_by="bytes" if tag_bytes_ms >= tag_ops_ms else "operations",
    )
    return lookup_entry, tags_entry, li2o_figures


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
            f"{row['grad_norm']:.4f} wall_time {row['wall_time']:.4f} "
            f"launches {read_launches()}")

    # ``run`` starts from ``init_state()`` again: the same weights and
    # generator as the replay above.
    reset_launches()
    _, rows, _ = vmc.run(STEPS, checkpoint_every=None, on_iter=progress)
    launches = read_launches()

    t = time.perf_counter()
    ham = vmc.ham
    a = words_to_ints(ham.a_masks)
    host_pairs = int(np.isin(dets[:, None] ^ a[None, :], dets).sum())
    h = sector_hamiltonian(ham, dets)
    e_ref = float(np.real(np.vdot(psi, h @ psi)) / np.vdot(psi, psi).real)
    log(f"Li2O step 0 on the host ({time.perf_counter() - t:.1f} s): "
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
    sector, static membership) from the Gumbel path's initial weights;
    times the step and one full-energy measurement. Returns the kernel
    launches of the steps."""
    import statistics

    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import main_path_vmc

    t = time.perf_counter()
    vmc = main_path_vmc(device="cuda", sampling_mode="exact")
    log(f"N2 exact set-up: {time.perf_counter() - t:.2f} s")
    check(vmc.exact_partner_idx is not None, "exact: no static membership")
    state = vmc.init_state()
    e_ref = sector_rayleigh(mol, vmc, vmc.exact_words)

    # The full energy of the initial weights over the whole sector: every
    # partner inside the sector is in the basis, so it is the Rayleigh
    # quotient too.
    words, valid = vmc.exact_words, vmc.exact_valid
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fe, _, fe_var = vmc._full_energy(words, la, ph, valid)
        fe = float(fe)
        fe_s = time.perf_counter() - t
    log(f"N2 full energy at the initial weights: {fe:.6f} (|full - "
        f"Rayleigh quotient| = {abs(fe - e_ref):.2e} Ha), variance "
        f"{float(fe_var):.4e}; {words.shape[0] * vmc.engine.n_groups} "
        f"partners through the network in {fe_s:.3f} s (host clock, "
        "synchronised)")
    check(abs(fe - e_ref) <= 1e-4, "N2 full energy disagrees with the "
          "Rayleigh quotient")

    reset_launches()
    rows, times = [], []
    for i in range(EXACT_STEPS):
        t = time.perf_counter()
        row = vmc.step(state)
        times.append(time.perf_counter() - t)
        rows.append(row)
        log(f"N2 exact step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f} step_s {times[-1]:.4f} "
            f"launches {read_launches()}")
    launches = read_launches()
    log(f"N2 exact: step 0 {rows[0]['energy']:.6f}, Gumbel path's "
        f"{N2_ENERGIES[0]:.6f} (|diff| = "
        f"{abs(rows[0]['energy'] - N2_ENERGIES[0]):.2e} Ha), Rayleigh "
        f"quotient {e_ref:.6f} (|diff| = {abs(rows[0]['energy'] - e_ref):.2e}"
        f" Ha); median step {statistics.median(times[1:]):.4f} s")
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
    return launches, {"exact_step_s": statistics.median(times[1:]),
                      "full_energy_s": fe_s}


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
        t = time.perf_counter()
        _, history, best = vmc.run(DRIVER_STEPS, checkpoint_every=3,
                                   steps_per_call=2)
        run_s = time.perf_counter() - t
        launches = read_launches()
        for row in history:
            log(f"N2 run row {row['iter_idx']}: energy {row['energy']:.6f} "
                f"full_energy {row['full_energy']:.6f} unique_num "
                f"{int(row['unique_num'])} wall_time {row['wall_time']:.3f}")
        with open(os.path.join(first, "result.csv")) as f:
            lines = f.read().splitlines()
        files = sorted(os.listdir(first))
        log(f"N2 run: {run_s:.2f} s, best {best['energy']:.6f} at iter "
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

    t = time.perf_counter()
    vmc = li2o_vmc(device="cuda", sampling_mode="multinomial",
                   sample_precisely=True, target_unique=4096)
    log(f"Li2O multinomial set-up: {time.perf_counter() - t:.2f} s")
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
        t = time.perf_counter()
        row = vmc.step(state)
        dt = time.perf_counter() - t
        vmc._adapt_budget(cfg, row["unique_num"])
        rows.append(row)
        log(f"Li2O multinomial step {i}: budget {budget}, counts {counts} + "
            f"dropped {dropped}, energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"table_overflow {int(row['table_overflow'])} step_s {dt:.4f} "
            f"launches {read_launches()}")
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


def prefilter_stage_ms(torch, eng, words, la, ph, valid, reps):
    """The prefilter's stages on one canonically sorted batch, in the
    engine's own row blocks, from their spans (``utils/spans.py``): the
    mean of ``reps`` recorded calls of ``local_energy_proxy`` after one
    warm-up call. Returns {'pf.build', 'pf.stage1', 'pf.stage2',
    'pf.stage3a', 'pf.stage3b', 'pf.merge': device ms a call, summed over
    the row blocks}."""
    from anqs_quantum_chemistry_torch.utils import spans

    with torch.no_grad():
        eng.local_energy_proxy(words, la, ph, valid)
        with spans.recording() as rec:
            for _ in range(reps):
                eng.local_energy_proxy(words, la, ph, valid)
    return {name: e["device_ms"] for name, e in rec.summary(reps).items()
            if name.startswith("pf.")}


def prefilter_kernels(torch, eng, words, la, ph, valid):
    """Kernels #1 and #2 alone at the prefilter's shapes on one
    canonically sorted batch (``PauliEngine._proxy_via_prefilter`` at the
    engine's capacities, the batch as one row block), each on its stage's
    real inputs: {'kernel1_3a': kernel #1 on the batch, 'kernel1_3b': on
    the dense rows, 'kernel2_3a': kernel #2 on stage 3a's B x c_row
    queries, 'kernel2_3b': on the dense rows' partners: a callable each},
    and {'kernel2_3a', 'kernel2_3b': query count, 'rows_3b': dense rows}."""
    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        as_int32,
        hash_lookup,
    )

    m = eng.n_groups
    with torch.no_grad():
        tab, nb, _, fptab = eng._hash_build(words, la, ph, valid,
                                            with_fp=True)
        hit = eng._fp_candidates(fptab, words) & valid[:, None]
        c_row = min(eng.prefilter_row_capacity, m)
        keys_m = m - torch.arange(m, dtype=torch.int32, device=words.device)
        _, m_idx = torch.topk(torch.where(hit, keys_m, 0), c_row, dim=1)
        over = valid & (torch.sum(hit, dim=1) > c_row)
        _, _, safe_rows = eng._dense_rows(over)
        rw = words[safe_rows]

    def queries(rows, idx=None):
        w32, a32 = as_int32(rows), as_int32(eng.a_words)
        return [(w32[:, None, i] ^ (a32[:, i][idx] if idx is not None
                                    else a32[None, :, i])).reshape(-1)
                for i in range(rows.shape[1])]

    q3a, q3b = queries(words, m_idx), queries(rw)
    kernels = {
        "kernel1_3a": lambda: eng.matrix_elements(words),
        "kernel1_3b": lambda: eng.matrix_elements(rw),
        "kernel2_3a": lambda: hash_lookup(tab, *q3a, entries=eng.hash_epb),
        "kernel2_3b": lambda: hash_lookup(tab, *q3b, entries=eng.hash_epb),
    }
    return kernels, {"kernel2_3a": q3a[0].numel(),
                     "kernel2_3b": q3b[0].numel(), "rows_3b": rw.shape[0]}


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
    binds. Times each prefilter stage and kernel at those capacities.
    Returns the figures."""
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

    times = prefilter_stage_ms(torch, eng, words, la, ph, valid, reps=5)
    kernels, queries = prefilter_kernels(torch, eng, words, la, ph, valid)
    with torch.no_grad():
        for name, fn in kernels.items():
            times[name] = cuda_ms(fn, reps=5, warmup=1)
        times["prefilter_total_ms"] = cuda_ms(
            lambda: eng.local_energy_proxy(words, la, ph, valid), reps=5,
            warmup=1)
        times["hash_membership_total_ms"] = cuda_ms(
            lambda: hash_eng.local_energy_proxy(words, la, ph, valid),
            reps=3, warmup=1)
    log("C2H4 prefilter stages (device ms, mean of 5; "
        f"Q 3a {queries['kernel2_3a']}, Q 3b {queries['kernel2_3b']}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    tab = eng._hash_build(words, la, ph, valid)[0]
    bounds = {}
    for stage in ("kernel2_3a", "kernel2_3b"):
        _, bytes_ms, ops_ms = lookup_bound(queries[stage], 2, tab)
        bounds[stage] = max(bytes_ms, ops_ms)
        log(f"kernel hash_lookup at the C2H4 {stage[-2:]} shape: "
            f"{times[stage]:.4f} ms, bound {bounds[stage] * 1e3:.2f}"
            f" us ({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
            f"{times[stage] / bounds[stage]:.2f}x), nb "
            f"{tab.shape[0]}")
    fptab = eng._hash_build(words, la, ph, valid, with_fp=True)[3]
    k3 = fp_filter_figures(torch, "the C2H4 set (one block)", fptab, words,
                           eng.a_cols)
    return {"capacities": levels, "rows": int(valid.sum()),
            "queries": queries, "stage_ms": times, "lookup_bound_ms": bounds,
            "max_abs_diff_vs_hash": {k: d for k, (d, _, _) in diffs.items()},
            "kernel3": k3}


def c2h4_trainer_phase(torch):
    """The C2H4 transformer trainer (``c2h4_vmc``: the example's full width
    and settings) for ``STEPS`` steps from seed 0, the overflow policy
    acting after each step as ``run`` does, after the membership
    cross-check on its initial weights. Returns (launches, figures)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import c2h4_vmc

    t = time.perf_counter()
    vmc = c2h4_vmc(device="cuda")
    log(f"C2H4 trainer set-up: {time.perf_counter() - t:.2f} s "
        f"(membership {vmc.engine.membership}, group order "
        f"{vmc.engine.weights_matmul}, {vmc.ref_neighbor_words.shape[0]} "
        "pinned neighbours)")
    figures = c2h4_membership_phase(torch, vmc)

    state = vmc.init_state()
    reset_launches()
    rows, step_ms, ref = [], [], None
    for i in range(STEPS):
        snap = (c2h4_set(torch, vmc, state.generator) if ref is None
                else None)
        t = time.perf_counter()
        row = vmc.step(state)
        dt = time.perf_counter() - t
        rows.append(row)
        step_ms.append(dt * 1e3)
        log(f"C2H4 step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"pf_dropped_rows {int(row['pf_dropped_rows'])} table_overflow "
            f"{int(row['table_overflow'])} escalations "
            f"{vmc._overflow_escalations} step_ms {dt * 1e3:.1f}")
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
    t = time.perf_counter()
    host_pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    log(f"C2H4 step {i0} (the first with no dropped row) on the host "
        f"({time.perf_counter() - t:.1f} s): found_pairs {host_pairs}, "
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
    figures.update(escalations=vmc._overflow_escalations,
                   first_clean_step=i0, step_ms=step_ms,
                   energies=[r["energy"] for r in rows])
    return launches, figures


def li2o_nade_kernel_figures(torch, vmc, snap, label="Li2O NADE"):
    """Kernels #1 and #2 at the two prefilter shapes of one set (``snap``;
    Li2O NADE's by default): their device times, each alone
    (``prefilter_kernels``), beside their bounds."""
    eng = vmc.engine
    words, valid, la, ph = snap
    kernels, queries = prefilter_kernels(torch, eng, words, la, ph, valid)
    with torch.no_grad():
        ms = {name: cuda_ms(fn, reps=10) for name, fn in kernels.items()}
    tab = eng._hash_build(words, la, ph, valid)[0]
    figures = {"rows_3a": int(words.shape[0]), **queries}
    for key, rows in (("3a", words), ("3b", words[:queries["rows_3b"]])):
        _, bytes_ms, ops_ms = me_bound(rows, eng.me_tables)
        figures[f"kernel1_{key}"] = {
            "B": int(rows.shape[0]), "ms": ms[f"kernel1_{key}"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        _, bytes_ms, ops_ms = lookup_bound(queries[f"kernel2_{key}"],
                                           words.shape[1], tab)
        figures[f"kernel2_{key}"] = {
            "Q": queries[f"kernel2_{key}"], "ms": ms[f"kernel2_{key}"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    for key in ("kernel1_3a", "kernel1_3b", "kernel2_3a", "kernel2_3b"):
        f = figures[key]
        log(f"{label} {key}: {f['ms']:.4f} ms, bound "
            f"{f['bound_ms'] * 1e3:.2f} us ({f['bound_by']}; "
            f"{f['ms'] / f['bound_ms']:.2f}x), "
            + (f"B {f['B']}" if "B" in f else f"Q {f['Q']}, nb "
               f"{tab.shape[0]}"))
    return figures


def li2o_nade_phase(torch):
    """The Li2O NADE campaign at full width: (a) the CISD vector, (b)
    supervised pretraining on it, (c) one step of the JAX closure state
    against the JAX record and the host, (d) ``run()`` with distillation
    cycles from (b)'s weights, (e) the kernels' launches on (b)-(d).
    Returns (launches, figures)."""
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

    t = time.perf_counter()
    vmc = li2o_nade_vmc(device="cuda", distill_period=NADE_DISTILL_PERIOD,
                        distill_steps=100, distill_lr=1e-4, distill_tau=0.1)
    mol = vmc.mol
    log(f"Li2O NADE trainer set-up: {time.perf_counter() - t:.2f} s "
        f"(membership {vmc.engine.membership}, capacities (row "
        f"{vmc.engine.prefilter_row_capacity}, dense "
        f"{vmc.engine.prefilter_dense_rows}))")

    # (a) The CISD vector.
    t = time.perf_counter()
    e_cisd, dets, coef = cisd_ground_state(mol.qubit_ham, mol.hf_det)
    cisd_s = time.perf_counter() - t
    log(f"Li2O CISD ({cisd_s:.1f} s on the host): {len(dets)} determinants,"
        f" E {e_cisd:.9f} (JAX {LI2O_CISD_ENERGY:.9f}, |diff| "
        f"{abs(e_cisd - LI2O_CISD_ENERGY):.2e} Ha)")
    check(len(dets) == LI2O_CISD_DETS, "Li2O CISD: determinant count")
    check(abs(e_cisd - LI2O_CISD_ENERGY) <= 1e-6, "Li2O CISD: energy")

    # (b) Pretraining from fresh weights.
    probs, phases = amplitude_targets_from_coefs(coef)
    words = pack_dets(dets, mol.qubit_num).cuda()
    vmc.init_state()
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, hist = pretrain(vmc.anqs, words, probs, phases,
                            iters=NADE_PRETRAIN_STEPS, lr=1e-3,
                            log_every=50)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
        tp = torch.from_numpy(probs).cuda()
        dph = ph - torch.from_numpy(phases).cuda()
        returned = float(-2.0 * torch.sum(tp * la) + torch.sum(tp * dph * dph))
    best = hist[-1]["best_loss"]
    log(f"Li2O NADE pretraining: {NADE_PRETRAIN_STEPS} full-batch steps in "
        f"{pretrain_s:.2f} s ({pretrain_s / NADE_PRETRAIN_STEPS * 1e3:.2f} "
        "ms a step); loss " + ", ".join(
            f"{r['iter']}: {r['loss']:.5f}" for r in hist)
        + f"; best {best:.5f}, returned parameters' loss {returned:.5f}")
    check(best < 1.0, f"Li2O NADE pretraining: best loss {best}")
    check(abs(returned - best) <= 1e-4 * abs(best),
          "Li2O NADE pretraining: the returned parameters are not the best")

    # (c) The JAX closure state, one step at lr 0.
    state = vmc.init_state()
    vmc.anqs.load_state_dict(li2o_nade_closure_params())
    snap = c2h4_set(torch, vmc, state.generator)
    t = time.perf_counter()
    row = vmc.step(state, overrides={"lr": 0.0, "lr_schedule": None})
    closure_step_s = time.perf_counter() - t
    t = time.perf_counter()
    host_pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    log(f"Li2O NADE closure state, one step at lr 0 "
        f"({closure_step_s * 1e3:.1f} ms): energy {row['energy']:.6f} (JAX "
        f"record {LI2O_CLOSURE_ENERGY:.6f}, diff "
        f"{(row['energy'] - LI2O_CLOSURE_ENERGY) * 1e3:+.4f} mHa), "
        f"found_pairs {int(row['found_pairs'])} (JAX {LI2O_CLOSURE_PAIRS}, "
        f"{100 * (row['found_pairs'] / LI2O_CLOSURE_PAIRS - 1):+.2f}%), "
        f"pf_dropped_rows {int(row['pf_dropped_rows'])}, unique_num "
        f"{int(row['unique_num'])}; host ({time.perf_counter() - t:.1f} s): "
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
    t = time.perf_counter()
    _, history, _ = vmc.run(NADE_RUN_STEPS, init_params=params,
                            steps_per_call=NADE_DISTILL_PERIOD,
                            checkpoint_every=None, log_every=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = read_launches()
    for i, r in enumerate(history):
        log(f"Li2O NADE run row {i}: energy {r['energy']:.6f} unique_num "
            f"{int(r['unique_num'])} found_pairs {int(r['found_pairs'])} "
            f"pf_dropped_rows {int(r['pf_dropped_rows'])} distill_loss "
            f"{r['distill_loss_first']:.5f} -> {r['distill_loss_last']:.5f} "
            f"distill_energy {r['distill_energy']:.6f} wall "
            f"{r['wall_time']:.3f} s")
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
    log(f"Li2O NADE path ({run_s:.2f} s for the run) launches {launches}")
    check(launches == {"fused_matrix_elements": 2 * evaluations,
                       "hash_lookup": 2 * evaluations,
                       "hash_tags": 2 * evaluations,
                       "fp_filter": evaluations},
          f"Li2O NADE path launched {launches} in {evaluations} "
          "local-energy evaluations")

    # The kernels at this path's shapes, on the closure step's set.
    figures = li2o_nade_kernel_figures(torch, vmc, snap)
    figures.update(cisd_s=cisd_s, pretrain_ms_per_step=pretrain_s * 1e3
                   / NADE_PRETRAIN_STEPS, closure_step_s=closure_step_s,
                   closure_energy=row["energy"],
                   closure_found_pairs=row["found_pairs"], run_s=run_s)
    return launches, figures


def li2o_support_ci_phase(torch):
    """The Li2O support-CI closure at full width (the JAX package's
    ``runs/li2o_sci`` chain, its packaged target and states): (a) the
    host's restricted H and ground state over the target's top 8192; (b)
    ckpt_26's Rayleigh quotient, polish loss, mass and two sampled full
    energies; (c) ckpt_13's example polish loss and 20 full-batch polish
    steps; (d) 50 distillation steps; (e) 3 pinned-VMC steps; (f)
    ``support_vmc`` and L-BFGS on the 8192 support. Counts are set to 0
    before (b) and read after (f). Returns (launches, figures)."""
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

    figures = {}
    t_phase = time.perf_counter()
    vmc = li2o_sci_vmc(device="cuda")
    mol = vmc.mol

    # (a) The target, the integrals and the host's restricted H.
    td, tc, e_target = load_target()
    d8, c8 = sci.truncate_by_weight(td, tc, LI2O_SCI_TOP)
    t = time.perf_counter()
    h8 = fci.sparse_hamiltonian(d8, mol.h1, mol.v)
    figures["h_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    e8, _ = sci.restricted_ground_state(d8, mol.h1, mol.v, mol.e_nuc)
    figures["ground_state_s"] = time.perf_counter() - t
    log(f"Li2O support CI: target {len(td)} determinants (E0 "
        f"{e_target:.6f}), integrals h1 {mol.h1.shape} v {mol.v.shape}; H "
        f"over its top {LI2O_SCI_TOP} built on the host in "
        f"{figures['h_build_s']:.2f} s (nnz {h8.nnz}); "
        f"restricted_ground_state {figures['ground_state_s']:.2f} s: E0 "
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
    fulls = []
    for seed in (1, 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        e, var = scp.sampled_full_energy(
            vmc, torch.Generator(device="cuda").manual_seed(seed), 16384)
        torch.cuda.synchronize()
        fulls.append({"seed": seed, "energy": e, "var": var,
                      "s": time.perf_counter() - t})
        log(f"Li2O ckpt_26 sampled full energy (16384, seed {seed}, "
            f"{fulls[-1]['s']:.2f} s): {e:.7f} var {var:.3e} (TPU "
            f"confirmations' mean {LI2O_SCI_CONFIRM_ENERGY:.6f}, diff "
            f"{(e - LI2O_SCI_CONFIRM_ENERGY) * 1e3:+.4f} mHa; FCI "
            f"{LI2O_FCI_ENERGY:.6f}, gap "
            f"{(e - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa)")
        check(abs(e - LI2O_SCI_CONFIRM_ENERGY) <= 5e-5,
              "Li2O ckpt_26: sampled full energy off the confirmations")
        check(e - LI2O_FCI_ENERGY < 1.6e-3,
              "Li2O ckpt_26: not within chemical accuracy")
    figures["full_energies"] = fulls

    # (c) ckpt_13: the example's polish loss, then 20 full-batch steps.
    vmc.anqs.load_state_dict(li2o_sci_params(13))
    with torch.no_grad():
        loss13 = float(example_polish_loss(vmc.anqs, target, 4.0, 1000.0)[0])
    rel13 = abs(loss13 / LI2O_SCI_CKPT13_LOSS - 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    best13, first13 = scp.fit_stage(
        vmc.anqs, lambda: example_polish_loss(vmc.anqs, target, 4.0,
                                              1000.0)[0], 1e-4, POLISH_STEPS)
    torch.cuda.synchronize()
    figures["polish_ms_per_step"] = (time.perf_counter() - t) * 1e3 / (
        POLISH_STEPS + 1)
    figures["polish_peak_gb"] = (torch.cuda.max_memory_allocated()
                                 - base) / 1e9
    log(f"Li2O ckpt_13: example polish loss (T 4, quadratic lam 1000) "
        f"{loss13:.10f} (JAX float32 {LI2O_SCI_CKPT13_LOSS:.10f}, rel "
        f"{rel13:.1e}; TPU record {TPU_CKPT13_LOSS}); {POLISH_STEPS} "
        f"full-batch steps at lr 1e-4 over {len(td)} rows: loss "
        f"{first13:.6f} -> best {best13:.6f}, "
        f"{figures['polish_ms_per_step']:.1f} ms a step, peak "
        f"{figures['polish_peak_gb']:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before")
    check(rel13 <= 1e-5, "Li2O ckpt_13: example polish loss")
    check(first13 == loss13 or abs(first13 / loss13 - 1.0) <= 1e-6,
          "Li2O ckpt_13: the stage's first loss")
    check(best13 < first13, "Li2O ckpt_13: the polish loss did not fall")

    # (d) Distillation from the packaged closure state.
    vmc.anqs.load_state_dict(li2o_nade_closure_params())
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, hist = pretrain(vmc.anqs, target["words"], target["p"], target["ph"],
                       torch.Generator(device="cuda").manual_seed(100),
                       iters=DISTILL_STEPS, lr=3e-4, batch=8192,
                       log_every=10)
    torch.cuda.synchronize()
    figures["distill_ms_per_step"] = (time.perf_counter() - t) * 1e3 / (
        DISTILL_STEPS)
    log(f"Li2O distillation from the closure state: {DISTILL_STEPS} steps "
        f"(batch 8192, lr 3e-4), {figures['distill_ms_per_step']:.2f} ms a "
        f"step; loss " + ", ".join(f"{r['iter']}: {r['loss']:.5f}"
                                   for r in hist)
        + f"; best {hist[-1]['best_loss']:.5f}")
    check(all(np.isfinite(r["loss"]) for r in hist),
          "Li2O distillation: non-finite loss")
    check(hist[-1]["best_loss"] < hist[0]["loss"],
          "Li2O distillation: the loss did not fall")

    # (e) Pinned-support VMC from ckpt_13.
    t = time.perf_counter()
    pin = li2o_pin_vmc(device="cuda")
    state = pin.init_state()
    pin.anqs.load_state_dict(li2o_sci_params(13))
    log(f"Li2O pinned VMC set-up: {time.perf_counter() - t:.2f} s "
        f"({pin.coupled_words.shape[0]} pinned determinants)")
    snap = c2h4_set(torch, pin, state.generator)
    pin_rows = []
    for i in range(PIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        row = pin.step(state)
        row["step_s"] = time.perf_counter() - t
        pin._handle_overflow({**row, "iter_idx": i})
        pin_rows.append(row)
        log(f"Li2O pinned VMC step {i}: energy {row['energy']:.6f} "
            f"unique_num {int(row['unique_num'])} found_pairs "
            f"{int(row['found_pairs'])} pf_dropped_rows "
            f"{int(row['pf_dropped_rows'])} step_s {row['step_s']:.4f}")
        check(np.isfinite(row["energy"]), "Li2O pinned VMC: energy")
    row0 = pin_rows[0]
    t = time.perf_counter()
    host_pairs, e_ref = host_pairs_and_rayleigh(pin.ham, *snap)
    log(f"Li2O pinned VMC step 0 against the JAX run's iteration 0 "
        f"{LI2O_PIN_STEP0_ENERGY:.6f}: diff "
        f"{(row0['energy'] - LI2O_PIN_STEP0_ENERGY) * 1e3:+.4f} mHa; host "
        f"({time.perf_counter() - t:.1f} s): found_pairs {host_pairs}, "
        f"Rayleigh quotient {e_ref:.6f} (|step - ref| = "
        f"{abs(row0['energy'] - e_ref):.2e} Ha)")
    check(abs(row0["energy"] - LI2O_PIN_STEP0_ENERGY) <= 2e-4,
          "Li2O pinned VMC: step 0 off the JAX record")
    check(int(row0["pf_dropped_rows"]) == 0, "Li2O pinned VMC: rows dropped")
    check(int(row0["found_pairs"]) == host_pairs,
          "Li2O pinned VMC: found_pairs disagrees with the host count")
    check(abs(row0["energy"] - e_ref) <= 1e-4,
          "Li2O pinned VMC: energy disagrees with the Rayleigh quotient")
    figures["pin_step_ms"] = [r["step_s"] * 1e3 for r in pin_rows]

    # (f) support_vmc and L-BFGS on the 8192 support from ckpt_26.
    vmc.anqs.load_state_dict(li2o_sci_params(26))
    rows = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    scp.support_vmc(vmc.anqs, t8, h8, mol.e_nuc, lrs=(1e-4,),
                    steps_per_stage=SUPPORT_VMC_STEPS, log_every=1,
                    on_log=rows.append)
    figures["support_vmc_ms_per_step"] = (time.perf_counter() - t) * 1e3 / (
        SUPPORT_VMC_STEPS)
    vmc.anqs.load_state_dict(li2o_sci_params(26))
    lrows = []
    t = time.perf_counter()
    _, linfo = scp.support_vmc_lbfgs(vmc.anqs, t8, h8, mol.e_nuc,
                                     maxiter=LBFGS_EVALS,
                                     segment=LBFGS_EVALS, log_every=1,
                                     on_log=lrows.append)
    figures["lbfgs_ms_per_eval"] = (time.perf_counter() - t) * 1e3 / max(
        1, len(lrows))
    launches = read_launches()
    log(f"Li2O support_vmc (rq, lr 1e-4) over {LI2O_SCI_TOP} rows: rq "
        + ", ".join(f"{r['rq']:.7f}" for r in rows)
        + f" ({figures['support_vmc_ms_per_step']:.1f} ms a step); first "
        f"rq {rows[0]['rq']:.9f} (JAX float32 {LI2O_SCI_CKPT26_RQ:.9f}, "
        f"|diff| {abs(rows[0]['rq'] - LI2O_SCI_CKPT26_RQ):.1e} Ha; the real"
        f" projection's quotient (b) {rq26:.9f}); L-BFGS "
        f"{len(lrows)} evaluations ({figures['lbfgs_ms_per_eval']:.1f} ms "
        f"each): rq {lrows[0]['rq']:.7f} -> {lrows[-1]['rq']:.7f}, best "
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

    # The kernels at this path's shapes: kernel #1 at the full energy's
    # 16,384 rows, both at the pinned step's prefilter stages.
    with torch.no_grad():
        s = gumbel_top_k_sample(
            vmc.anqs, 16384, torch.Generator(device="cuda").manual_seed(1))
        fe_words = sort_words(s.words)[0]
    figures["kernel1_full_energy"] = me_figures(
        torch, "Li2O full energy", fe_words, vmc.engine.me_tables, reps=10,
        plain_reps=2)
    figures.update(li2o_nade_kernel_figures(torch, pin, snap,
                                            "Li2O pinned VMC"))
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"Li2O support-CI phase: {figures['phase_s']:.1f} s")
    return launches, figures


def c2h4_made_step_check(torch, vmc, state, label, record=None):
    """Steps of ``vmc`` at lr 0 from its current weights, the overflow
    policy acting after each, until one drops no row; that step's
    ``found_pairs`` against a host count over its own set and its energy
    against the float64 Rayleigh quotient over it (and, with ``record``
    (energy, tol), against a JAX record). Returns (rows, the clean step's
    set)."""
    import numpy as np

    rows = []
    while True:
        snap = c2h4_set(torch, vmc, state.generator)
        torch.cuda.synchronize()
        t = time.perf_counter()
        row = vmc.step(state, overrides={"lr": 0.0, "lr_schedule": None})
        row["step_s"] = time.perf_counter() - t
        rows.append(row)
        log(f"{label} step at lr 0: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs "
            f"{int(row['found_pairs'])} pf_dropped_rows "
            f"{int(row['pf_dropped_rows'])} ({row['step_s'] * 1e3:.0f} ms); "
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
    t = time.perf_counter()
    host_pairs, e_ref = host_pairs_and_rayleigh(vmc.ham, *snap)
    msg = (f"{label} clean step on the host ({time.perf_counter() - t:.1f} "
           f"s): found_pairs {host_pairs}, Rayleigh quotient over its "
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
    return rows, snap


def timed(torch, fn):
    """(result, seconds, peak GB above the memory held before) of fn()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t,
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def sigma_check(torch, h1, v, n_alpha, n_beta, label, seed, host=True):
    """The device sigma at a random vector (numpy ``seed``) of the sector:
    float64 against ``host_sigma_f64`` (with ``host``) and float32 against
    float64, each as max|diff| / max|reference|; the host time of the
    tables, and the device time of each sigma (CUDA events, mean of 3)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.chem.direct_ci import (
        host_sigma_f64, make_sigma, sigma_operands)

    n_orb = h1.shape[0] // 2
    t = time.perf_counter()
    ops = sigma_operands(h1, v, n_alpha, n_beta, device="cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t
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
    out = {"S_a": ops.s_alpha, "S_b": ops.s_beta, "tables_s": tables_s,
           "rel_err_f32": err32,
           "ms_f32": cuda_ms(lambda: sig32(c32, *tab32, 0.0), 3, 1),
           "ms_f64": cuda_ms(lambda: sig64(c64, *tab64, 0.0), 3, 1)}
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
    return out


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
    from the packaged integrals. Returns (the launches of (b), figures)."""
    import tempfile

    import numpy as np

    from anqs_quantum_chemistry_torch.chem.direct_ci import (
        direct_ci_ground_state)
    from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
    from anqs_quantum_chemistry_torch.chem.molecule import load_li2o
    from anqs_quantum_chemistry_torch.experiments import dissociation_curve
    from anqs_quantum_chemistry_torch.ops.matrix_elements import build_tables

    t_phase = time.perf_counter()
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mol = dissociation_curve.n2_at(N2_R, mols_dir=tmp, device="cuda")
        figures["n2_build_s"] = time.perf_counter() - t
        figures["n2_stage_s"] = dict(mol.build_seconds)
        log(f"N2 r={N2_R} from atoms: {figures['n2_build_s']:.2f} s (host); "
            "stages " + ", ".join(f"{k} {v:.2f} s"
                                  for k, v in mol.build_seconds.items()))
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
        figures["kernel1"] = me_figures(
            torch, f"N2 r={N2_R}", words, build_tables(mol.qubit_ham, "cuda"),
            reps=20, plain_reps=3)
        del words
        torch.cuda.empty_cache()

        reset_launches()
        t = time.perf_counter()
        res = dissociation_curve.main(
            ["dissociation_curve", "5", str(DISSOCIATION_STEPS), str(N2_R)],
            device="cuda", mols_dir=tmp, run_root=tmp)[N2_R]
        launches = read_launches()
        figures["dissociation_s"] = time.perf_counter() - t
        energies = res["energies"]
        log(f"N2 r={N2_R} dissociation recipe, {len(energies)} exact steps "
            f"({figures['dissociation_s']:.2f} s with set-up, "
            f"{res['s_per_step']:.4f} s a step): energies "
            f"{[round(e, 6) for e in energies]}; launches {launches}")
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
        figures["dissociation_s_per_step"] = res["s_per_step"]

        figures["sigma_n2"] = sigma_check(torch, mol.h1, mol.v, mol.n_alpha,
                                          mol.n_beta, f"N2 r={N2_R}", seed)

    li2o = load_li2o()
    figures["sigma_li2o"] = sigma_check(torch, li2o.h1, li2o.v, li2o.n_alpha,
                                        li2o.n_beta, "Li2O", seed,
                                        host=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    fci = direct_ci_ground_state(li2o.h1, li2o.v, li2o.n_alpha, li2o.n_beta,
                                 li2o.e_nuc, tol=1e-4, device="cuda",
                                 verbose=log, return_coeffs=True)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    sig = figures["sigma_li2o"]
    e_jax_tables = li2o_quotient_f32_tables(torch, li2o, fci.coeffs)
    figures["li2o_fci"] = {
        "energy": fci.energy, "energy_f32": fci.energy_f32,
        "energy_f32_tables": e_jax_tables,
        "ipr": fci.ipr, "iterations": fci.iterations,
        "residual": fci.residual, "solve_s": solve_s, "peak_gb": peak}
    log(f"Li2O FCI by direct CI: {fci.energy:.13f} (record "
        f"{LI2O_FCI_ENERGY:.13f}, diff "
        f"{fci.energy - LI2O_FCI_ENERGY:+.2e} Ha; the same vector over the "
        f"tables rounded to float32 as JAX's {e_jax_tables:.13f}, diff "
        f"{e_jax_tables - LI2O_FCI_ENERGY:+.2e} Ha), float32 Ritz "
        f"{fci.energy_f32:.10f}, ipr {fci.ipr:.11f} (record "
        f"{LI2O_FCI_IPR}), {fci.iterations} Davidson iterations, residual "
        f"{fci.residual:.3e}; solve {solve_s:.2f} s (host clock, "
        f"synchronised): tables {sig['tables_s']:.2f} s (host), a float32 "
        f"sigma {sig['ms_f32']:.1f} ms, the float64 quotient's sigma "
        f"{sig['ms_f64']:.1f} ms; peak {peak:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before")
    check(abs(fci.energy - LI2O_FCI_ENERGY) <= LI2O_FCI_TOL,
          f"Li2O FCI {fci.energy} vs {LI2O_FCI_ENERGY}")
    check(abs(e_jax_tables - LI2O_FCI_ENERGY) <= LI2O_JAX_TABLES_TOL,
          f"Li2O quotient over float32 tables {e_jax_tables} vs "
          f"{LI2O_FCI_ENERGY}")
    check(abs(fci.ipr - LI2O_FCI_IPR) <= LI2O_IPR_TOL,
          f"Li2O FCI ipr {fci.ipr} vs {LI2O_FCI_IPR}")
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"chem build phase: {figures['phase_s']:.1f} s")
    return launches, figures


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
    sampled full energy; (g) the kernels at this path's shapes. Counts are
    set to 0 before (c) and read after (f). Returns (launches, figures)."""
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

    figures = {}
    t_phase = time.perf_counter()
    mol = load_c2h4()

    # (a) The packaged integrals, the CISD vector, the host's H.
    with np.load(C2H4_CISD_VECTOR) as d:
        dets, coef, e_cisd = d["dets"], d["coef"], float(d["e_cisd"])
    d4, c4 = sci.truncate_by_weight(dets, coef, C2H4_CISD_TOP)
    t = time.perf_counter()
    h4 = fci.sparse_hamiltonian(d4, mol.h1, mol.v)
    figures["h_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    e4 = fci._ground_state(h4)[0] + mol.e_nuc
    figures["ground_state_s"] = time.perf_counter() - t
    log(f"C2H4 CISD -> SCI: integrals h1 {mol.h1.shape} v {mol.v.shape} "
        f"from the spatial form; CISD vector {len(dets)} determinants (E "
        f"{e_cisd:.10f}); H over its top {C2H4_CISD_TOP} built on the host "
        f"in {figures['h_build_s']:.2f} s (nnz {h4.nnz}), ground state in "
        f"{figures['ground_state_s']:.2f} s: E0 {e4:.10f} (JAX "
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
    (_, hist), pre_s, _ = timed(torch, lambda: pretrain(
        made.anqs, words, probs, phases,
        torch.Generator(device="cuda").manual_seed(0),
        iters=C2H4_PRETRAIN_STEPS, lr=1e-3, batch=C2H4_ROWS,
        log_every=25))
    figures["pretrain_ms_per_step"] = pre_s * 1e3 / C2H4_PRETRAIN_STEPS
    log(f"C2H4 MADE-2048 pretraining: {C2H4_PRETRAIN_STEPS} steps (batch "
        f"{C2H4_ROWS}, lr 1e-3), {figures['pretrain_ms_per_step']:.2f} "
        "ms a step; loss " + ", ".join(f"{r['iter']}: {r['loss']:.5f}"
                                       for r in hist)
        + f"; best {hist[-1]['best_loss']:.5f}")
    check(all(np.isfinite(r["loss"]) for r in hist),
          "C2H4 pretraining: non-finite loss")
    check(hist[-1]["best_loss"] < hist[0]["loss"],
          "C2H4 pretraining: the loss did not fall")

    # (c) The MADE CISD trainer from the packaged ckpt_4000.
    reset_launches()
    warm = load_params_npz(WARM_STATE)
    made.anqs.load_state_dict(warm)
    made_rows, snap = c2h4_made_step_check(
        torch, made, state, "C2H4 MADE ckpt_4000",
        (C2H4_MADE_RECORD_ENERGY, 1e-3))
    t = time.perf_counter()
    _, history, _ = made.run(C2H4_RUN_STEPS, init_params=warm,
                             steps_per_call=C2H4_RUN_STEPS,
                             checkpoint_every=None, log_every=0)
    torch.cuda.synchronize()
    figures["made_run_s"] = time.perf_counter() - t
    log(f"C2H4 MADE run(): {C2H4_RUN_STEPS} steps in "
        f"{figures['made_run_s']:.2f} s, energies "
        + ", ".join(f"{r['energy']:.6f}" for r in history))
    check(len(history) == C2H4_RUN_STEPS and all(
        np.isfinite(r["energy"]) for r in history), "C2H4 MADE run()")
    figures["made_step_ms"] = [r["step_s"] * 1e3 for r in made_rows]
    figures["made_escalations"] = made._overflow_escalations
    figures["made_energy"] = made_rows[-1]["energy"]
    figures["made_found_pairs"] = made_rows[-1]["found_pairs"]
    made_evals = len(made_rows) + C2H4_RUN_STEPS
    made_snap = snap

    # (d) ckpt_47: restricted quotient, polish loss and mass, full energy.
    vmc = c2h4_sci_vmc(device="cuda")
    gen = vmc.init_state().generator
    vmc.anqs.load_state_dict(load_params_npz(BEST_STATE))
    td, tc, e_target = load_target(C2H4_SCI_TARGET)
    d8, c8 = sci.truncate_by_weight(td, tc, C2H4_SCI_TOP)
    t = time.perf_counter()
    h8 = fci.sparse_hamiltonian(d8, mol.h1, mol.v)
    figures["h8_build_s"] = time.perf_counter() - t
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
        f" H over its top {C2H4_SCI_TOP} on the host in "
        f"{figures['h8_build_s']:.2f} s (nnz {h8.nnz}); Rayleigh quotient "
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
    (e47, var47), fe_s, fe_gb = timed(torch, lambda: scp.sampled_full_energy(
        vmc, gen, C2H4_ROWS, row_chunk=C2H4_ROW_CHUNK))
    figures["full_energy"] = {"energy": e47, "var": var47, "s": fe_s,
                              "peak_gb": fe_gb}
    log(f"C2H4 ckpt_47 sampled full energy ({C2H4_ROWS}, row chunk "
        f"{C2H4_ROW_CHUNK}; {fe_s:.2f} s, peak {fe_gb:.2f} GB): {e47:.7f} "
        f"var {var47:.3e} (TPU confirmations {C2H4_SCI_CONFIRM_ENERGY:.7f}"
        f" +- 2.5e-6, diff {(e47 - C2H4_SCI_CONFIRM_ENERGY) * 1e3:+.4f} "
        "mHa)")
    check(abs(e47 - C2H4_SCI_CONFIRM_ENERGY) <= 5e-5,
          "C2H4 ckpt_47: sampled full energy off the confirmations")

    # (e) The support chain at cut depth.
    def polish_steps():
        return scp.polish(vmc.anqs, target, **{
            **POLISH, "lrs": (POLISH["lrs"][0],), "steps": POLISH_STEPS})

    (_, pinfo), s, gb = timed(torch, polish_steps)
    figures["polish"] = {"ms_per_step": s * 1e3 / (POLISH_STEPS + 1),
                         "peak_gb": gb}
    log(f"C2H4 polish from ckpt_47: {POLISH_STEPS} full-batch steps over "
        f"{len(td)} rows (lr {POLISH['lrs'][0]:g}, chunk {POLISH['chunk']})"
        f": best loss {pinfo[0]['loss']:.6f} (from {loss47:.6f}), mass "
        f"{pinfo[0]['mass']:.7f}; {figures['polish']['ms_per_step']:.1f} ms "
        f"a step, peak {gb:.2f} GB")
    check(pinfo[0]["loss"] < loss47, "C2H4 polish: the loss did not fall")
    vmc.anqs.load_state_dict(warm)
    (_, dhist), s, gb = timed(torch, lambda: pretrain(
        vmc.anqs, target["words"], target["p"], target["ph"],
        torch.Generator(device="cuda").manual_seed(100), iters=DISTILL_STEPS,
        lr=3e-4, batch=8192, log_every=10))
    figures["distill"] = {"ms_per_step": s * 1e3 / DISTILL_STEPS,
                          "peak_gb": gb}
    log(f"C2H4 distillation from ckpt_4000: {DISTILL_STEPS} steps (batch "
        f"8192, lr 3e-4), {figures['distill']['ms_per_step']:.2f} ms a step,"
        f" peak {gb:.2f} GB; loss " + ", ".join(
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
        _, s, gb = timed(torch, lambda: scp.support_vmc(
            vmc.anqs, t8, h8, mol.e_nuc, lrs=(1e-4,),
            steps_per_stage=SUPPORT_VMC_STEPS, log_every=1,
            on_log=rows.append, **kw))
        support[name] = {"ms_per_step": s * 1e3 / SUPPORT_VMC_STEPS,
                         "peak_gb": gb, "rq": [r["rq"] for r in rows]}
    vmc.anqs.load_state_dict(load_params_npz(BEST_STATE))
    lrows = []
    (_, linfo), s, gb = timed(torch, lambda: scp.support_vmc_lbfgs(
        vmc.anqs, t8, h8, mol.e_nuc, maxiter=LBFGS_EVALS,
        segment=LBFGS_EVALS, log_every=1, on_log=lrows.append))
    support["lbfgs"] = {"ms_per_step": s * 1e3 / max(1, len(lrows)),
                        "peak_gb": gb, "rq": [r["rq"] for r in lrows]}
    for name, f in support.items():
        log(f"C2H4 {name} over the top {C2H4_SCI_TOP} from ckpt_47: rq "
            + ", ".join(f"{x:.7f}" for x in f["rq"])
            + f" ({f['ms_per_step']:.1f} ms a step, peak "
            f"{f['peak_gb']:.2f} GB)")
        check(len(f["rq"]) >= SUPPORT_VMC_STEPS and all(
            np.isfinite(x) for x in f["rq"]), f"C2H4 {name}: rq")
        check(abs(f["rq"][0] - support["rq"]["rq"][0]) <= 1e-9,
              f"C2H4 {name}: the first rq is not ckpt_47's")
    check(len(lrows) >= LBFGS_EVALS, "C2H4 L-BFGS: evaluations")
    figures["support"] = support
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
    tr_rows, tr_snap = c2h4_made_step_check(torch, tr, tr_state,
                                            "C2H4 transformer ckpt_3000")
    figures["transformer_step_ms"] = [r["step_s"] * 1e3 for r in tr_rows]
    figures["transformer_escalations"] = tr._overflow_escalations
    (etr, vtr), s, gb = timed(torch, lambda: scp.sampled_full_energy(
        tr, tr_state.generator, C2H4_TR_FULL_SAMPLES,
        row_chunk=C2H4_TR_ROW_CHUNK))
    figures["transformer_full_energy"] = {"energy": etr, "var": vtr, "s": s,
                                          "peak_gb": gb}
    log(f"C2H4 transformer sampled full energy ({C2H4_TR_FULL_SAMPLES}, row"
        f" chunk {C2H4_TR_ROW_CHUNK}): {etr:.6f} var {vtr:.3e}, {s:.2f} s, "
        f"peak {gb:.2f} GB (JAX's last rows about -78.1614 .. -78.1655)")
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

    # (g) The kernels at this path's shapes: both at the MADE step's
    # prefilter stages; kernel #1 at the full energy's row chunk and whole
    # sample.
    figures.update(li2o_nade_kernel_figures(torch, made, made_snap,
                                            "C2H4 MADE CISD"))
    with torch.no_grad():
        s = gumbel_top_k_sample(vmc.anqs, C2H4_ROWS,
                                torch.Generator(device="cuda").manual_seed(1))
        fe_words = sort_words(s.words)[0]
    for rows in (C2H4_ROW_CHUNK, C2H4_ROWS):
        figures[f"kernel1_full_energy_{rows}"] = me_figures(
            torch, f"C2H4 full energy B {rows}", fe_words[:rows],
            vmc.engine.me_tables, reps=10, plain_reps=1)
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"C2H4 CISD -> SCI phase: {figures['phase_s']:.1f} s")
    return launches, figures


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


def lookup_figures(torch, label, tab, cols, entries, batches=3, reps=5):
    """Kernel #2 and its tag build against their plain versions on ``tab``
    (``entries`` a bucket) and the query columns ``cols``, bit for bit;
    the lookup's time (the wrapper's whole call, tag build included: the
    median of ``batches`` x ``reps``) beside its bound and the plain
    version's time. Returns the figures."""
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
    n_q = cols[0].numel()
    k = key_words(tab, entries)
    ms = median_ms(lambda: hash_lookup(tab, *cols, entries=entries),
                   batches=batches, reps=reps)
    plain_ms = cuda_ms(lambda: hash_lookup_plain(tab, *cols,
                                                 entries=entries),
                       reps=1, warmup=1)
    n_bytes, bytes_ms, ops_ms = lookup_bound(n_q, len(cols), tab, entries)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    tier = ("shared" if tags_in_shared_memory(tab.shape[0], entries)
            else "global")
    log(f"kernel hash_lookup at {label} (K {k}, E {entries}, nb "
        f"{tab.shape[0]}, tags in {tier} memory): Q={n_q} found "
        f"{int(got[2].sum())}, bit-identical (lookup and tags) {same}; "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}: {n_bytes / 1e6:.1f} MB; "
        f"{ms / bound_ms:.2f}x)")
    check(same and err <= HASH_TOL,
          f"kernel #2 disagrees with its plain version at {label}")
    return {"K": k, "E": entries, "nb": tab.shape[0], "Q": n_q,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    """``n`` steps, each printed with its time; returns (rows, step times,
    the launches of the steps)."""
    import statistics

    import numpy as np

    reset_launches()
    rows, times = [], []
    for i in range(n):
        t = time.perf_counter()
        row = vmc.step(state)
        times.append(time.perf_counter() - t)
        rows.append(row)
        log(f"{label} step {i}: energy {row['energy']:.6f} unique_num "
            f"{int(row['unique_num'])} found_pairs {int(row['found_pairs'])} "
            f"grad_norm {row['grad_norm']:.4f} step_s {times[-1]:.4f}")
    launches = read_launches()
    for i, row in enumerate(rows):
        check(np.isfinite(row["energy"]), f"{label} step {i}: energy")
    log(f"{label}: median step {statistics.median(times[1:]):.4f} s "
        f"(steps 1-{n - 1}), launches {launches}")
    return rows, times, launches


def options_phase(torch, mol):
    """The ansatz and step options at full width from seed 0, five legs
    with their launches counted from 0: (a) N2 with spin-flip
    symmetrization of log|psi| and the phase and the flip closure of the
    sample set; (b) N2 with the FCI vector's signs as a fixed sign
    structure; (c) N2 in exact summation with the alpha orbitals first;
    (d) the Li2O toy model with the per-layer patterns, the log_psi head,
    masking depth 1, bfloat16 activations, ``topk_impl='bisect'`` and MinSR
    without regularisation; (e) N2 as a 4-replica ensemble against
    standalone runs. Returns ({path: launches}, {leg: median step s})."""
    import copy
    import statistics

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

    t_phase = time.perf_counter()
    launches, step_s = {}, {}
    n_real = mol.fci_ndet

    # (a) Spin flip.
    t_leg = time.perf_counter()
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
    rows, times, launches["options_spin_flip"] = run_steps(
        torch, vmc, state, OPT_SPIN_STEPS, "options (a) spin flip")
    step_s["spin_flip"] = statistics.median(times[1:])
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
    log(f"options (a) leg: {time.perf_counter() - t_leg:.1f} s")

    # (b) The FCI vector's signs as the sign structure (a 2^20 table).
    t = t_leg = time.perf_counter()
    e_fci, coef = _ground_state(h_sector)
    # The solver's global sign and the signs of coefficients that vanish
    # by symmetry are arbitrary: fix the largest positive and give the
    # vanishing ones phase 0, so that every call builds the same table.
    coef = coef * np.sign(coef[np.argmax(np.abs(coef))])
    table = np.zeros(1 << mol.qubit_num, np.float32)
    table[sector_dets.astype(np.int64)] = np.where(
        coef < -1e-12 * np.max(np.abs(coef)), np.pi, 0.0)
    fci_s = time.perf_counter() - t
    log(f"options (b): sector FCI {e_fci:.8f} Ha ({fci_s:.2f} s on the "
        f"host), {int(np.sum(table == np.pi))} signs pi")
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
    rows, times, launches["options_sign"] = run_steps(
        torch, vmc, state, OPT_STEPS, "options (b) sign structure")
    step_s["sign"] = statistics.median(times[1:])
    log(f"options (b): every phase its table entry; step 0 energy "
        f"{rows[0]['energy']:.6f} (Rayleigh quotient {e_ref:.6f}, |diff| "
        f"{abs(rows[0]['energy'] - e_ref):.2e} Ha)")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-4,
          "sign structure: energy disagrees with the Rayleigh quotient")
    del vmc, state
    log(f"options (b) leg: {time.perf_counter() - t_leg:.1f} s")

    # (c) Exact summation with the alpha orbitals first, then beta.
    t_leg = time.perf_counter()
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
    rows, times, launches["options_perm"] = run_steps(
        torch, vmc, state, OPT_STEPS, "options (c) qubit_perm exact")
    step_s["perm"] = statistics.median(times[1:])
    log(f"options (c): step 0 {rows[0]['energy']:.6f}, permuted-sector "
        f"Rayleigh quotient {e_ref:.6f} (|diff| "
        f"{abs(rows[0]['energy'] - e_ref):.2e} Ha)")
    check(abs(rows[0]["energy"] - e_ref) <= 1e-5,
          "perm: exact energy disagrees with the Rayleigh quotient")
    del vmc, state, h_perm
    log(f"options (c) leg: {time.perf_counter() - t_leg:.1f} s")

    # (d) Li2O: patterns, log_psi head, masking depth, bfloat16, the
    # 'bisect' top-k, MinSR without regularisation.
    t_leg = time.perf_counter()
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    check(torch.equal(precision.store(x.cuda(), "bfloat16").cpu(),
                      precision.store(x, "bfloat16")),
          "bfloat16 storage rounds otherwise on the card")
    t = time.perf_counter()
    vmc = li2o_vmc(device="cuda", anqs_options=LI2O_OPTIONS,
                   topk_impl="bisect",
                   sr=SRConfig(max_indices_num=50, use_reg=False))
    log(f"options (d) Li2O set-up: {time.perf_counter() - t:.2f} s")
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
        rows, times, launches["options_li2o"] = run_steps(
            torch, vmc, state, OPT_STEPS, "options (d) Li2O")
    finally:
        sampler._select_top_k = select
    step_s["li2o"] = statistics.median(times[1:])
    x_last, k_last = calls[-1]
    v_b, i_b = exact_top_k(x_last, k_last)
    v_s, i_s = sampler._top_k(x_last, k_last)
    same = torch.equal(i_b, i_s) and torch.equal(v_b, v_s)
    t_b = cuda_ms(lambda: exact_top_k(x_last, k_last), 10)
    t_s = cuda_ms(lambda: sampler._top_k(x_last, k_last), 10)
    log(f"options (d): last frontier {x_last.numel()} candidates, top "
        f"{k_last}: exact_top_k {'equals' if same else 'DIFFERS FROM'} the "
        f"ordered top-k ({t_b:.3f} ms vs the stable sort's {t_s:.3f} ms); "
        f"step 0 found_pairs {int(rows[0]['found_pairs'])} (host "
        f"{li2o_pairs}); {outside} of {len(li2o_dets)} samples outside the "
        f"(N_alpha, N_beta) sector")
    check(same, "exact_top_k differs from the ordered top-k")
    check(int(rows[0]["found_pairs"]) == li2o_pairs,
          "Li2O options: found_pairs disagrees with the host count")
    check(launches["options_li2o"] == {"fused_matrix_elements": OPT_STEPS,
                                       "hash_lookup": OPT_STEPS,
                                       "hash_tags": OPT_STEPS,
                                       "fp_filter": 0},
          f"Li2O options launched {launches['options_li2o']}")
    del vmc, state, cpu_anqs, calls, x_last
    log(f"options (d) leg: {time.perf_counter() - t_leg:.1f} s")

    # (e) A 4-replica ensemble against standalone runs of seeds 0-3.
    t_leg = time.perf_counter()
    vmc = main_path_vmc(device="cuda")
    ens = vmc.init_ensemble_state(OPT_REPLICAS)
    reset_launches()
    t = time.perf_counter()
    _, metrics = vmc._multi_step_ensemble(OPT_STEPS, OPT_REPLICAS)(ens)
    torch.cuda.synchronize()
    ens_s = time.perf_counter() - t
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
    step_s["ensemble_call"] = ens_s
    log(f"options (e): {OPT_REPLICAS} replicas x {OPT_STEPS} steps in "
        f"{ens_s:.3f} s ({ens_s / OPT_STEPS:.4f} s a step of all replicas); "
        f"max relative |replica - standalone| {worst:.2e}; launches "
        f"{launches['options_ensemble']}")
    check(worst <= ENSEMBLE_RTOL, "ensemble replica differs from its "
          "standalone run")
    check(not np.allclose(e_ens[0], e_ens[1]), "replicas 0 and 1 agree")
    check(launches["options_ensemble"]["fused_matrix_elements"]
          == OPT_STEPS * OPT_REPLICAS, "ensemble: kernel #1 launches")
    del vmc, ens
    log(f"options (e) leg: {time.perf_counter() - t_leg:.1f} s")
    for path, counts in launches.items():
        check(counts["fused_matrix_elements"] > 0, f"{path}: no kernel #1")
    log(f"options phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, step_s


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
    ph), median step ms, launches)."""
    import statistics

    import numpy as np

    state = vmc.init_state()
    depth = len(vmc.anqs.config.hidden_widths)
    out_layer = dict(vmc.anqs.main.named_parameters())
    with torch.no_grad():
        for name in (f"w{depth}", f"b{depth}"):
            out_layer[name].mul_(SPIN_SHARPEN)
    snap = replay_set(vmc, state)
    reset_launches()
    rows, step_ms = [], []
    for i in range(SPIN_STEPS):
        t = time.perf_counter()
        row = vmc.step(state)
        step_ms.append((time.perf_counter() - t) * 1e3)
        rows.append(row)
        log(f"{label} step {i}: energy {row['energy']:.6f} energy_imag "
            f"{row['energy_imag']:.3e} unique_num {int(row['unique_num'])} "
            f"found_pairs {int(row['found_pairs'])} pf_dropped_rows "
            f"{int(row['pf_dropped_rows'])} table_overflow "
            f"{int(row['table_overflow'])} step_ms {step_ms[-1]:.1f}")
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
    median = statistics.median(step_ms[1:])
    log(f"{label}: median step {median:.1f} ms (steps 1-{SPIN_STEPS - 1}), "
        f"launches {launches}")
    return rows, snap, median, launches


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
    plain version. Returns ({path: launches}, figures)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.applications.spin_systems import (
        exact_ground_energy,
    )
    from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig

    t_phase = time.perf_counter()
    launches, figures = {}, {}

    # (a) Trainings to the exact energy.
    for name, n, sample_num, iters, rel in SPIN_TRAININGS:
        vmc = spin_vmc(name, n, sample_num=sample_num,
                       qubit_per_qudit=2, lr=1e-2, iter_num=iters, width=64)
        e_exact = exact_ground_energy(vmc.ham)
        reset_launches()
        t = time.perf_counter()
        _, history, best = vmc.run(checkpoint_every=None,
                                   steps_per_call=SPIN_WINDOW, log_every=0)
        run_s = time.perf_counter() - t
        launches[f"spin_{name}"] = read_launches()
        gap = best["energy"] - e_exact
        ms = 1e3 * run_s / iters
        figures[name] = {"exact": e_exact, "best": best["energy"],
                         "gap": gap, "ms_per_step": ms,
                         "last_energy_var": history[-1]["energy_var"]}
        log(f"spin (a) {name}: best {best['energy']:.6f} at iter "
            f"{best['iter']}, exact {e_exact:.6f}, gap {gap:+.3e} "
            f"({gap / abs(e_exact):+.2e} of |E0|; bound {rel:g}), last "
            f"energy_var {history[-1]['energy_var']:.3e}, {iters} steps in "
            f"{run_s:.1f} s ({ms:.2f} ms a step), launches "
            f"{launches[f'spin_{name}']}")
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
    t = time.perf_counter()
    vmc = spin_vmc("tfi64", 64, membership="auto", **full)
    check(vmc.engine.membership == "prefilter",
          f"TFI-64 'auto' is {vmc.engine.membership}")
    check(vmc.engine.group_phase is None, "TFI-64 has a phase channel")
    log(f"spin (b) TFI-64 set-up {time.perf_counter() - t:.2f} s: "
        f"{vmc.ham.n_groups} groups, {vmc.ham.n_terms} terms")
    rows, snap, figures["tfi64_step_ms"], launches["spin_tfi64"] = (
        spin_steps(torch, vmc, "spin (b) TFI-64", e0))
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
    figures["tfi64_energies"] = [r["energy"] for r in rows]
    del vmc, snap

    # (c) DM-40, the odd-Y channel, hash membership.
    e0 = dm_free_fermion_e0(40)
    log(f"spin (c) DM-40 free-fermion E0 {e0:.7f} (pinned {DM40_E0})")
    check(abs(e0 - DM40_E0) < 1e-6, "DM-40 E0")
    vmc = spin_vmc("dm40", 40, membership="hash", **full)
    check(vmc.engine.group_phase is not None, "DM-40: no phase channel")
    try:
        PauliEngine(vmc.ham, device="cuda", membership="auto")
    except ValueError as e:
        log(f"spin (c) DM-40 'auto' membership refused: {e}")
    else:
        raise SmokeFailure("DM-40: 'auto' (prefilter) accepted the odd-Y "
                           "channel")
    rows, snap, figures["dm40_step_ms"], launches["spin_dm40"] = (
        spin_steps(torch, vmc, "spin (c) DM-40", e0))
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
    figures["dm40_energies"] = [r["energy"] for r in rows]
    figures["dm40_eloc_err"] = err
    # Kernel #1 on the duplicate flip masks, at the step's shapes.
    figures["kernel1_dm40"] = me_figures(torch, "DM-40 (duplicate masks)",
                                         words, vmc.engine.me_tables,
                                         reps=20, plain_reps=3)
    del vmc, snap, words, e
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"spin phase: {figures['phase_s']:.1f} s")
    return launches, figures


def cr2_phase(torch):
    """Cr2/SV at 84 qubits (the JAX package's ``examples/cr2_step.py`` and
    ``cr2_train.py`` at full width, ``experiments.vmc.cr2_vmc``): (a) the
    packaged molecule against the JAX record; (b) kernel #1 on its grouped
    W = 3 tables; (c) kernel #2 at K 3 / E 16 on a Cr2 set's table, K 4 on a
    random 100-qubit table, K 2 at E 8 and 16; (d) prefilter, hash and
    search membership on one set of the packaged JAX state ckpt_1000, and
    kernel #3 alone on a 128-row block of it (``fp_filter_figures``); (e)
    one step at lr 0 from ckpt_1000 against the JAX record and the host;
    (f) ``CR2_STEPS`` steps from random weights; (g) the kernels' launches
    on (e)-(f). Returns (launches, figures)."""
    import copy

    import numpy as np

    from anqs_quantum_chemistry_torch.chem.molecule import load_cr2
    from anqs_quantum_chemistry_torch.experiments.vmc import (
        CR2_ANQS,
        VMC,
        cr2_ckpt1000_params,
        cr2_config,
    )
    from anqs_quantum_chemistry_torch.ops.matrix_elements import (
        fused_matrix_elements,
    )

    t_phase = time.perf_counter()
    figures = {}
    # (a) The packaged molecule.
    t = time.perf_counter()
    mol = load_cr2()
    ham = mol.qubit_ham
    figures["load_s"] = time.perf_counter() - t
    log(f"Cr2/SV loaded in {figures['load_s']:.2f} s: {mol.qubit_num} "
        f"qubits, sector ({mol.n_alpha}, {mol.n_beta}), T {ham.n_terms}, M "
        f"{ham.n_groups}, HF {mol.hf_energy:.9f} (record "
        f"{CR2_HF:.9f}), MP2 {mol.mp2_energy:.9f} (record {CR2_MP2:.9f})")
    check((mol.qubit_num, mol.n_alpha, mol.n_beta, ham.n_terms,
           ham.n_groups) == (84, 24, 24, CR2_TERMS, CR2_GROUPS),
          "Cr2: sizes differ from the JAX record")
    check(abs(mol.hf_energy - CR2_HF) <= 1e-8
          and abs(mol.mp2_energy - CR2_MP2) <= 1e-8,
          "Cr2: HF or MP2 differs from the JAX record")

    t = time.perf_counter()
    vmc = VMC(mol, cr2_config(), CR2_ANQS, device="cuda")  # cr2_vmc's
    figures["setup_s"] = time.perf_counter() - t
    eng = vmc.engine
    log(f"Cr2 trainer set-up: {figures['setup_s']:.2f} s (membership "
        f"{eng.membership}, weights_matmul {eng.weights_matmul}, hash_epb "
        f"{eng.hash_epb}, me_chunk {eng.me_chunk}, pf_row_chunk "
        f"{eng.pf_row_chunk}, capacities (row {eng.prefilter_row_capacity},"
        f" dense {eng.prefilter_dense_rows}))")
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
    tables = eng.me_tables
    k1 = me_figures(torch, f"Cr2 ({CR2_CHECK_ROWS} rows)",
                    words[:CR2_CHECK_ROWS], tables, reps=5, plain_reps=1)
    ms_full = cuda_ms(lambda: fused_matrix_elements(words, tables), reps=5,
                      warmup=1)
    n_bytes, bytes_ms, ops_ms = me_bound(words, tables)
    k1_full = {"B": words.shape[0], "ms": ms_full,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log(f"kernel fused_matrix_elements at the Cr2 set (B "
        f"{words.shape[0]}, one launch): {ms_full:.4f} ms, bound "
        f"{k1_full['bound_ms'] * 1e3:.2f} us ({k1_full['bound_by']}: "
        f"{n_bytes / 1e6:.1f} MB; {ms_full / k1_full['bound_ms']:.2f}x)")
    torch.cuda.empty_cache()

    # (c) Kernel #2 at the new layouts.
    tab, nb, overflow = eng._hash_build(words, la, ph, valid)
    check(int(overflow) == 0, "Cr2: the set's table overflowed")
    k2 = {"cr2_k3_e16": lookup_figures(
        torch, "the Cr2 set's table", tab,
        list(eng._hash_queries(words[:CR2_LOOKUP_ROWS])), eng.hash_epb)}
    rng = np.random.default_rng(CR2_SEED)
    for label, n_qubits, epb in (("k4_e16", 100, None), ("k2_e8", 64, 8),
                                 ("k2_e16", 64, 16)):
        rtab, cols, entries = random_key_table(torch, n_qubits, rng, epb)
        k2[label] = lookup_figures(
            torch, f"a random {n_qubits}-qubit table", rtab, cols, entries)
    torch.cuda.empty_cache()

    # (d) Prefilter, hash and search membership on the set.
    engines = {"prefilter": eng}
    for name in ("hash", "search"):
        engines[name] = copy.copy(eng)
        engines[name].membership = name
    results, totals = {}, {}
    with torch.no_grad():
        for name, e in engines.items():
            results[name], totals[name], _ = timed(
                torch, lambda e=e: e.local_energy_proxy(words, la, ph,
                                                        valid))
    ref = results["search"]
    t_max = float(torch.max(torch.abs(ref.t_re)))
    diffs = {name: float(torch.max(torch.abs(r.t_re - ref.t_re)))
             for name, r in results.items()}
    log("Cr2 memberships on the ckpt_1000 set: " + ", ".join(
        f"{name} found_pairs {int(r.found_pairs)} table_overflow "
        f"{int(r.table_overflow)} pf_dropped_rows {int(r.pf_dropped_rows)} "
        f"max|t - t_search| {diffs[name]:.3e} ({totals[name]:.3f} s)"
        for name, r in results.items()) + f"; max|t| {t_max:.3e}")
    pairs = {int(r.found_pairs) for r in results.values()}
    check(len(pairs) == 1, "Cr2: the memberships find other pairs")
    check(int(results["prefilter"].pf_dropped_rows) == 0,
          "Cr2: the prefilter dropped rows")
    check(all(d <= 1e-6 * t_max for d in diffs.values()),
          "Cr2: the memberships' t disagree")
    stage_ms = prefilter_stage_ms(torch, eng, words, la, ph, valid, reps=2)
    kernels, queries = prefilter_kernels(torch, eng, words, la, ph, valid)
    with torch.no_grad():
        for name, fn in kernels.items():
            stage_ms[name] = cuda_ms(fn, reps=2, warmup=1)
    log(f"Cr2 prefilter stages (device ms, mean of 2, in the engine's row "
        f"blocks; the kernels alone, the set as one block; Q 3a "
        f"{queries['kernel2_3a']}, Q 3b {queries['kernel2_3b']}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stage_ms.items()))
    fptab = eng._hash_build(words, la, ph, valid, with_fp=True)[3]
    k3 = fp_filter_figures(torch, f"a Cr2 row block ({eng.pf_row_chunk} "
                           "rows of the set)", fptab,
                           words[:eng.pf_row_chunk], eng.a_cols)
    figures.update(membership_s=totals, stage_ms=stage_ms, queries=queries,
                   found_pairs=pairs.pop(), kernel3=k3)
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
    row, step_s, _ = timed(torch, lambda: vmc.step(
        state, overrides={"lr": 0.0, "lr_schedule": None}))
    t = time.perf_counter()
    host_pairs, e_ref, n_near = cr2_host_pairs_and_rayleigh(
        torch, mol, eng.a_words, *snap)
    ulp = float(np.spacing(np.float32(abs(e64))))
    host_s = time.perf_counter() - t
    log(f"Cr2 ckpt_1000, one step at lr 0 ({step_s:.3f} s): energy "
        f"{row['energy']:.7f} (JAX tail-50 mean {CR2_TAIL50:.7f}, diff "
        f"{(row['energy'] - CR2_TAIL50) * 1e3:+.4f} mHa; JAX best "
        f"{CR2_BEST:.7f}), found_pairs {int(row['found_pairs'])}, "
        f"pf_dropped_rows {int(row['pf_dropped_rows'])}, unique_num "
        f"{int(row['unique_num'])}; host ({host_s:.1f} s, {n_near} pairs "
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
    torch.cuda.reset_peak_memory_stats()
    rows, times = [], []
    for _ in range(CR2_STEPS):
        t = time.perf_counter()
        rows.append(vmc.step(state))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = read_launches()
    log(f"Cr2 {CR2_STEPS} steps from random weights: energies "
        + ", ".join(f"{r['energy']:.6f}" for r in rows)
        + f"; found_pairs {[int(r['found_pairs']) for r in rows]}, "
        f"pf_dropped_rows {[int(r['pf_dropped_rows']) for r in rows]}; "
        + ", ".join(f"{s * 1e3:.1f}" for s in times)
        + f" ms a step; peak {peak:.2f} GB; launches {launches}")
    check(all(np.isfinite(r["energy"]) for r in rows),
          "Cr2: non-finite energy")
    blocks = -(-words.shape[0] // eng.pf_row_chunk)  # stage 1 and 3a's
    n = (blocks + 1) * (1 + CR2_STEPS)  # and 3b's
    check(launches == {"fused_matrix_elements": n, "hash_lookup": n,
                       "hash_tags": n, "fp_filter": blocks * (1 + CR2_STEPS)},
          f"Cr2: launches {launches}, expected {n} of kernels #1 and #2, "
          f"{blocks} of kernel #3 a step")
    figures.update(
        kernel1=k1, kernel1_set=k1_full, kernel2=k2, host_s=host_s,
        ckpt1000_energy=row["energy"], ckpt1000_energy_f64=e64,
        ckpt1000_rayleigh=e_ref,
        ckpt1000_found_pairs=int(row["found_pairs"]), lr0_step_s=step_s,
        step_ms=[s * 1e3 for s in times],
        energies=[r["energy"] for r in rows], peak_gb=peak,
        phase_s=time.perf_counter() - t_phase)
    log(f"Cr2 phase: {figures['phase_s']:.1f} s")
    return launches, figures


def mesh_phase(torch):
    """The data-parallel legs of ``MESH_RUNS``; returns (launches by path,
    figures)."""
    from anqs_quantum_chemistry_torch.experiments import dryrun_multichip

    t0 = time.perf_counter()
    by_path, figures = {}, {}
    for backend, plan in MESH_RUNS:
        t = time.perf_counter()
        try:
            spawned = dryrun_multichip.launch(plan, backend, "cuda", "full")
        except Exception as exc:  # a rank failed: its traceback says why
            raise SmokeFailure(f"mesh {backend} {plan}: {exc}")
        log(f"mesh: {backend}, {len(spawned)} rank(s) spawned: "
            f"{time.perf_counter() - t:.1f} s")
        for n_ranks, legs in plan:
            mesh_figures(f"mesh_{backend}{n_ranks}", legs,
                         [rep[n_ranks] for rep in spawned[:n_ranks]],
                         by_path, figures)
    figures["phase_s"] = time.perf_counter() - t0
    log(f"mesh phase: {figures['phase_s']:.1f} s")
    return by_path, figures


def mesh_figures(tag, legs, reports, by_path, figures):
    """Log and check each leg's reports of a mesh (one a rank); add its
    launches summed over the ranks to ``by_path`` and its times to
    ``figures``."""
    for leg in legs:
        for rank, rep in enumerate(reports):
            r = rep[leg]
            extra = {k: v for k, v in r.items()
                     if k not in ("launches", "ms", "leg_s",
                                  "later_energies", "energies")}
            log(f"  {leg} rank {rank}: {r['ms']:.2f} ms a step, "
                f"leg {r['leg_s']:.1f} s, launches {r['launches']}, "
                f"{extra}")
            for kernel in MESH_KERNELS[leg]:
                check(r["launches"][kernel] > 0,
                      f"{tag} {leg} rank {rank}: {kernel} not launched")
        by_path[f"{tag}_{leg}"] = {
            k: sum(rep[leg]["launches"][k] for rep in reports)
            for k in reports[0][leg]["launches"]}
        figures[f"{tag}_{leg}_ms"] = [rep[leg]["ms"] for rep in reports]
        figures[f"{tag}_{leg}_s"] = reports[0][leg]["leg_s"]
        for one in ("solo_ms", "hash_ms"):  # the same work, one process
            if one in reports[0][leg]:
                figures[f"{tag}_{leg}_{one}"] = [
                    rep[leg][one] for rep in reports]
        if "max_diff" in reports[0][leg]:
            figures[f"{tag}_{leg}_max_diff"] = reports[0][leg][
                "max_diff"]


def measure_phase(torch):
    """``MEASURE_CONFIGS`` through the measurement surface; returns
    (launches by path, figures)."""
    import numpy as np

    from anqs_quantum_chemistry_torch.experiments.vmc import (
        li2o_vmc,
        main_path_vmc,
    )
    from anqs_quantum_chemistry_torch.utils import cost

    t0 = time.perf_counter()
    makers = {"n2": main_path_vmc, "li2o": li2o_vmc}
    by_path, figures = {}, {}
    for name, maker, overrides in MEASURE_CONFIGS:
        t = time.perf_counter()
        vmc = makers[maker](device="cuda", **overrides)
        setup_s = time.perf_counter() - t
        counts = vmc.step_cost_analysis()
        top = list(counts["by_source"].items())[:MEASURE_TOP]
        stages = vmc.profile_stages(reps=10)
        window = vmc._multi_step(MEASURE_WINDOW)
        state = vmc.init_state()
        window(state)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        _, metrics = window(state)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3 / MEASURE_WINDOW
        launches = read_launches()
        matmul = cost.matmul_flops(counts["by_source"])
        jacobians = cost.matmul_flops(counts["by_source"], "minsr_jacobians")
        log(f"measure {name}: set-up {setup_s:.2f} s; step_cost_analysis "
            f"flops {counts['flops']} (matmul {matmul}, of it MinSR's "
            f"jacrev {jacobians}), transcendentals "
            f"{counts['transcendentals']}, bytes accessed "
            f"{counts[cost.BYTES]}, device {counts['device']}")
        for source, entry in top:
            log(f"  {source}: {entry}")
        for kernel in ("fused_matrix_elements", "hash_lookup", "hash_tags"):
            if kernel in counts["by_source"] and kernel not in dict(top):
                log(f"  {kernel}: {counts['by_source'][kernel]}")
        log(f"  profile_stages (ms, CUDA events, reps 10): "
            f"{ {k: v for k, v in stages.items() if k != 'device'} }")
        log(f"  _multi_step({MEASURE_WINDOW}) after a {MEASURE_WINDOW}-step "
            f"warm-up: {step_ms:.3f} ms a step (host clock), launches "
            f"{launches}, energy {metrics['energy'][0]:.6f} -> "
            f"{metrics['energy'][-1]:.6f}, found_pairs "
            f"{int(metrics['found_pairs'][-1])}, table_overflow "
            f"{int(metrics['table_overflow'].max())}")
        check(counts["device"] == "cuda" and stages["device"] == "cuda",
              f"measure {name}: counted on {counts['device']}, timed on "
              f"{stages['device']}")
        check(counts["flops"] > matmul > jacobians > 0
              and counts[cost.BYTES] > 0,
              f"measure {name}: counts {counts['flops']}, matmul {matmul}, "
              f"MinSR's jacrev {jacobians}")
        check(counts["by_source"].get("fused_matrix_elements", {}).get(
            "flops", 0) > 0, f"measure {name}: no kernel #1 count")
        check(all(v > 0 and np.isfinite(v) for k, v in stages.items()
                  if k != "device"), f"measure {name}: stages {stages}")
        check(np.all(np.isfinite(metrics["energy"])),
              f"measure {name}: energies not finite")
        check(launches["fused_matrix_elements"] == MEASURE_WINDOW
              and launches["fp_filter"] == 0,
              f"measure {name}: kernels #1 and #3 launched {launches}")
        if maker == "li2o":
            check(counts["by_source"].get("hash_lookup", {}).get(
                cost.BYTES, 0) > 0, f"measure {name}: no kernel #2 count")
            check(launches["hash_lookup"] == MEASURE_WINDOW
                  and launches["hash_tags"] == MEASURE_WINDOW,
                  f"measure {name}: kernel #2 launched {launches}")
        by_path[f"measure_{name}"] = launches
        figures[name] = {
            "flops": counts["flops"], "matmul_flops": matmul,
            "minsr_jacobian_flops": jacobians,
            "transcendentals": counts["transcendentals"],
            "bytes_accessed": counts[cost.BYTES],
            "kernel_counts": {k: counts["by_source"][k] for k in (
                "fused_matrix_elements", "hash_lookup", "hash_tags")
                if k in counts["by_source"]},
            "stages_ms": {k: v for k, v in stages.items() if k != "device"},
            "step_ms": step_ms}
        del vmc, state
    figures["phase_s"] = time.perf_counter() - t0
    log(f"measure phase: {figures['phase_s']:.1f} s")
    return by_path, figures


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

    global FP64_ADDS_PER_S
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(clock.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    FP64_ADDS_PER_S = sms * FP64_LANES_PER_SM * mhz * 1e6
    log(f"float64 add rate for bounds: {sms} SMs x {FP64_LANES_PER_SM} "
        f"lanes x {mhz:.0f} MHz (nvidia-smi clocks.max.sm) = "
        f"{FP64_ADDS_PER_S:.4g}/s")
    global INT32_OPS_PER_S
    INT32_OPS_PER_S = sms * INT32_LANES_PER_SM * mhz * 1e6

    t = time.perf_counter()
    build_logs = cuda_build.build(["fused_me", "hash_lookup"])
    log(f"build: {time.perf_counter() - t:.2f} s")
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
    me_entry = kernel_phase(torch, mol, words)

    t0 = time.perf_counter()
    n2 = main_path_vmc(device="cuda")
    log(f"N2 trainer set-up: {time.perf_counter() - t0:.2f} s")
    membership_crosscheck_phase(torch, mol, n2)
    n2_launches = trainer_phase(torch, mol, n2)
    del n2

    t0 = time.perf_counter()
    li2o = li2o_vmc(device="cuda")
    log(f"Li2O trainer set-up: {time.perf_counter() - t0:.2f} s")
    hash_entry, tags_entry, li2o_figures = hash_lookup_phase(torch, li2o)
    me_entry["by_molecule"]["li2o"] = li2o_figures
    li2o_launches = li2o_trainer_phase(torch, li2o)
    del li2o

    exact_launches, exact_times = n2_exact_phase(torch, mol)
    driver_launches = n2_driver_phase(torch)
    multinomial_launches = li2o_multinomial_phase(torch)

    c2h4_phase(torch, me_entry)
    c2h4_launches, c2h4_figures = c2h4_trainer_phase(torch)
    nade_launches, nade_figures = li2o_nade_phase(torch)
    sci_launches, sci_figures = li2o_support_ci_phase(torch)
    c2h4_sci_launches, c2h4_sci_figures = c2h4_cisd_sci_phase(torch)
    chem_launches, chem_figures = chem_build_phase(torch, args.seed)
    cr2_launches, cr2_figures = cr2_phase(torch)
    options_launches, options_step_s = options_phase(torch, mol)
    spin_launches, spin_figures = spin_phase(torch)
    mesh_launches, mesh_figures = mesh_phase(torch)
    measure_launches, measure_figures = measure_phase(torch)

    # Each kernel's launches on the path it was ported for (kernel #3's: the
    # Cr2 path, which the benchmark's cr2.prefilter cell runs); every
    # path's counts stand beside them.
    fp_entry = {"name": "fp_filter", "cr2_block": cr2_figures.pop("kernel3"),
                "c2h4": c2h4_figures.pop("kernel3")}
    me_entry["launches"] = n2_launches["fused_matrix_elements"]
    hash_entry["launches"] = li2o_launches["hash_lookup"]
    tags_entry["launches"] = li2o_launches["hash_tags"]
    fp_entry["launches"] = cr2_launches["fp_filter"]
    by_path = {"n2": n2_launches, "li2o": li2o_launches,
               "n2_exact": exact_launches, "n2_driver": driver_launches,
               "li2o_multinomial": multinomial_launches,
               "c2h4_transformer": c2h4_launches,
               "li2o_nade": nade_launches,
               "li2o_support_ci": sci_launches,
               "c2h4_cisd_sci": c2h4_sci_launches,
               "n2_dissociation": chem_launches,
               "cr2": cr2_launches, **options_launches, **spin_launches,
               **mesh_launches, **measure_launches}
    for entry in (me_entry, hash_entry, tags_entry, fp_entry):
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in by_path.items()}
    me_entry["n2_exact_step_s"] = exact_times["exact_step_s"]
    me_entry["n2_full_energy_s"] = exact_times["full_energy_s"]
    stage_ms = c2h4_figures["stage_ms"]
    me_entry["ms_c2h4_prefilter_batch"] = stage_ms["kernel1_3a"]
    hash_entry["c2h4_prefilter"] = {
        f"{key}_{stage}": value for stage in ("3a", "3b")
        for key, value in (
            ("Q", c2h4_figures["queries"][f"kernel2_{stage}"]),
            ("ms", stage_ms[f"kernel2_{stage}"]),
            ("bound_ms", c2h4_figures["lookup_bound_ms"][
                f"kernel2_{stage}"]))}
    me_entry["li2o_nade_prefilter"] = {
        stage: nade_figures[f"kernel1_{stage}"] for stage in ("3a", "3b")}
    hash_entry["li2o_nade_prefilter"] = {
        stage: nade_figures[f"kernel2_{stage}"] for stage in ("3a", "3b")}
    me_entry["li2o_full_energy"] = sci_figures["kernel1_full_energy"]
    me_entry["li2o_pin_prefilter"] = {
        stage: sci_figures[f"kernel1_{stage}"] for stage in ("3a", "3b")}
    hash_entry["li2o_pin_prefilter"] = {
        stage: sci_figures[f"kernel2_{stage}"] for stage in ("3a", "3b")}
    me_entry["li2o_support_ci"] = {
        k: sci_figures[k] for k in (
            "h_build_s", "ground_state_s", "full_energies",
            "polish_ms_per_step", "polish_peak_gb", "distill_ms_per_step",
            "pin_step_ms", "support_vmc_ms_per_step", "lbfgs_ms_per_eval",
            "phase_s")}

    me_entry["c2h4_cisd_prefilter"] = {
        stage: c2h4_sci_figures[f"kernel1_{stage}"] for stage in ("3a", "3b")}
    hash_entry["c2h4_cisd_prefilter"] = {
        stage: c2h4_sci_figures[f"kernel2_{stage}"] for stage in ("3a", "3b")}
    me_entry["c2h4_full_energy"] = {
        rows: c2h4_sci_figures[f"kernel1_full_energy_{rows}"]
        for rows in (C2H4_ROW_CHUNK, C2H4_ROWS)}
    me_entry["c2h4_cisd_sci"] = {
        k: v for k, v in c2h4_sci_figures.items()
        if not k.startswith(("kernel1_", "kernel2_", "rows_"))}

    me_entry["by_molecule"]["n2_r2.0"] = chem_figures.pop("kernel1")
    me_entry["chem_build"] = chem_figures
    me_entry["by_molecule"]["cr2"] = cr2_figures.pop("kernel1")
    me_entry["cr2_set"] = cr2_figures.pop("kernel1_set")
    hash_entry["layouts"] = cr2_figures.pop("kernel2")
    me_entry["cr2"] = cr2_figures
    me_entry["options_step_s"] = options_step_s
    me_entry["by_molecule"]["dm40"] = spin_figures.pop("kernel1_dm40")
    me_entry["spin"] = spin_figures
    me_entry["mesh"] = mesh_figures
    me_entry["measure"] = measure_figures
    me_entry["max_abs_err"] = max(me_entry["max_abs_err"],
                                  me_entry["by_molecule"]["cr2"][
                                      "max_abs_err"])
    hash_entry["max_abs_err"] = max(
        [hash_entry["max_abs_err"]]
        + [f["max_abs_err"] for f in hash_entry["layouts"].values()])

    elapsed = time.monotonic() - T_START
    log(f"total: {elapsed:.1f} s")
    check(elapsed < TIME_LIMIT_S, f"took {elapsed:.0f} s")
    log(json.dumps({"kernels": [me_entry, hash_entry, tags_entry,
                                fp_entry]}))
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
