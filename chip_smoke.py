#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu   # tiny CPU rehearsal, no kernels

Phases, each printed as it runs:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build: all four Hopper kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (in parallel), and their ``-Xptxas -v`` report; spills
   and serialized ``wgmma`` are flagged, and fail the run on the
   tensor-core kernels (``gram_bf16``, ``matmul_bf16``, ``flash_bf16``).
3. parity at full width.  K1 (fused shifted Gram), K3 (tiled matmul,
   alpha = 1.5) and K4 (causal flash attention) each have two routes,
   ``simt`` and ``wgmma``; each route is driven once through its
   ``kernels.ops`` entry as a path of its own (counts zeroed before, read
   after), and every other case reads its route's counter around its own
   call.  K1 with c = 0, below and above the clamp floor: f32 11,999^2 and
   ragged 1000 x 333 (simt); bf16 11,999^2 (wgmma, staged: rows of 11,999
   are not 16-byte aligned) and its column-major view (staged once,
   column-major kept), 12,000^2 and its column-major view (zero-copy),
   ragged 1000 x 333 and 333 x 1000 — f32 within K1_TOL (max error /
   max|G|), bf16 elementwise within m eps (|A|^T |A|), G exactly
   symmetric, the applied shift max(c, floor).  K2 (r-term combine) at 11,999^2, r
   in {1, 4}, f32 and bf16, xw in {0, 1} (f32: max error / max|result|;
   bf16 output: one bf16 ulp plus the f32 sums' error bound,
   elementwise).  K3:
   f32 11,999^2 (simt), bf16 11,999^2 (wgmma, staged: rows of 11,999 are
   not 16-byte aligned), bf16 12,000^2 and 4,096^2 transposed views
   (wgmma, zero-copy, both majors), mixed f32/bf16 (simt) and ragged
   1001 x 333 @ 333 x 517 in each, held elementwise to the f32 sums'
   error bound k eps |alpha| (|A| @ |B|).  K4 at one qwen3-8b layer
   (b = 1, s = 4,096, 32 heads of 128) and s = 4,000: bf16 (wgmma) in
   (b, s, h, d) and (b, h, s, d) storage at d = 128 and 64, f32 (simt)
   (f32: max error / max|v| within 1e-5; bf16: elementwise within the
   rounding bound of P to bf16 before PV, as in the Pallas body, and of
   the bf16 output, 2^-8 (P|V|) + 2^-8 |o|, plus the f32 term).
   3b: K1's f32 route split over m (``kernels/gram.py::gram_split``) at
   ZoloMuon's six shapes (phase 20's five and phase 19's 4,096 x 1,024)
   and the edge cases (2,047 x 1,409, 2,048 x 1, 63 and 65, 5 x 64, which
   must take S = 1, and 3,072 x 4,096), each row-major and as a
   column-major view, at c = 0 and c > 0: within K1_TOL, exactly
   symmetric, bitwise the same over two launches, on its split; the
   rule's S = 1 at the large shapes; K2 at the six shapes with xw a
   number and a tensor, within K2_TOL_F32, one launch a call.
4. kernel times (CUDA events, warm), beside the plain version, one
   PyTorch library call computing the same function, and the bound:
   every route of K1, K3 and K4 on its own (K1 bf16 at 11,999^2, staged,
   with the staging copy also timed alone, and at 12,000^2 as it lies);
   the library calls with f32 output from bf16 operands
   (``torch.mm(..., out_dtype=torch.float32)``, for K3 bf16 and K1 bf16)
   are checked against the plain version first.  K1 f32 and K2 also
   report their device time per call from ``torch.profiler`` over the
   same calls (host time against device time), K1 its split S.  4b: K1
   f32 and K2 (r = 2) the same way at ZoloMuon's six shapes, 12,288 x
   4,096 (phase 19) and 21b's rank blocks 6,144 x 4,096 and 3,072 x
   4,096, before any other phase has run (the profiler recorded no device
   time after phases 17-19 in one run).
5. main path: the paper's linverse matrix (n = 11,999, kappa = 9.06e3)
   synthesized on the card and solved through
   ``plan(SvdConfig(method="zolo_cuda", ...)).svd(a)``, with the kernel
   launch counts of each solve, the accuracy against the exact spectrum,
   the wall time and the peak device memory.
   Then a split of one solve (``plan.polar`` vs ``eigh``) and the
   first CholeskyQR2 pass's numerical margin (the f32 Gram's smallest
   eigenvalue against the clamped shift and the first-pass ridge).
6. the same plan on ``method="zolo_static"`` (plain torch ops): its time
   and its singular values against the kernel path's.
7. the dynamic path: the same matrix through
   ``plan(SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
   l0_policy="runtime", r=4, qr_mode="cholqr2")).svd(a)``: the run-time
   bound l_init, the iterations, the last residual, converged, the wall
   time of a warm solve, the peak memory, the K1/K2 launches per solve
   (K1: 1 + 2r in the CholeskyQR2 iteration, then 1 per iteration; K2:
   1 per iteration) and the accuracy figures of phase 5, held to the
   same limits.
8. the plain yardstick of the dynamic path, ``method="zolo"``: it
   launches no kernel, and its singular values agree with phase 7's.
   (Phase 7 keeps ``qr_mode="cholqr2"``: the CholeskyQR2-first solve.)
9. the bf16 compute plan: the same f32 matrix through
   ``plan(SvdConfig(method="zolo_cuda", ..., compute_dtype="bfloat16"))
   .svd(a)`` — bf16 iterates, every K1 launch on bf16 operands (``wgmma``,
   10 per solve; K2 2), f32 factors back: wall time, peak memory, the
   polar/eigh split, and the reference's bf16 criteria (orthogonality of
   U and Vh <= 8 eps(bf16) = 0.0625, the top half of s within 5e-2
   relative of the exact spectrum, all finite); then the same plan on
   ``zolo_static`` (no kernel launch), whose factors meet the same limits
   against phase 9's singular values; then (9c) the same config with the
   default ``method="auto"`` (QDWH on the card, as the reference's
   pricing picks), held to the same bf16 limits.
10. the dynamic default: the same f32 matrix through
    ``plan(SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
    l0_policy="runtime", r=4)).svd(a)`` with ``qr_mode`` unset: the
    run-time bound sits below 10 sqrt(eps(f32)), so the first iteration
    must be the structured Householder one (counted); l_init, the
    branch, iterations, residual, converged, wall time, K1/K2 launches
    by route (K1 one per Cholesky iteration, K2 one per iteration), the
    phase-5 accuracy limits, its singular values against phase 7's; the
    structured Householder term's time inside that solve (synchronised
    around its call: the first iteration but its K2 combine); then (10b)
    the plain yardstick ``zolo``, no kernel launch.
11. static Householder: ``zolo_cuda`` with ``qr_mode="householder"``
    (kappa hint, ``estimate_at_plan``, r = 4): launches, wall time,
    accuracy, the polar/eigh split.
12. QDWH, the paper's baseline: ``qdwh_static`` (kappa hint) and dynamic
    ``qdwh`` (run-time bound): iterations (QR and Cholesky apart, counted),
    wall time beside phases 5 and 7, the polar/eigh split, accuracy; no
    kernel launch.
13. the direct baselines on ``synthesize("linverse", n=2048)`` (the same
    spectrum shape, kappa = 9.06e3): ``newton``, ``zolo_cuda`` with
    ``eig_method="jacobi"`` (block-Jacobi, nb = 32) and ``jacobi_svd``
    (nb = 32), both with the port's sweep cap of 40, each held to the
    phase-5 accuracy limits.
14. resilience, on the phase-5 matrix: (a) ``svd_verified`` of the
    phase-5 plan and ``judge_plan`` — healthy, K1 10 / K2 2, wall time
    beside phase 5's ``svd`` and the health check alone — and the same
    config through ``solve_with_escalation``, which must pass at rung 0;
    (b) ``solve_with_escalation`` on ``zolo_static`` with
    ``faulty_ops(cuda_zolo_ops(), nan_at_iter=0)``: rung 0 fails
    ("non-finite factors", K1 10 / K2 2), rung 1 (``householder``) passes
    (K1 1 / K2 2) within the phase-5 limits; (c) the ladder on the
    dynamic default (phase 10's config): each rung's reasons,
    kappa_est, envelope and seconds, rung 0 carrying the envelope reason
    exactly when kappa_est exceeds ``envelope_kappa_max``, the trail
    ending ``passed``; (d) ``svd_batched_verified`` on four 2,048²
    linverse matrices with entry 2 set to NaN: only that entry fails.
    Per rung, the launches and seconds are read at its verdict
    (``RungProbe``); a rung on a kernel backend must launch K1 and K2, a
    plain one nothing.
15. the kernels' conditioning envelope at n = 11,999: the linverse
    singular vectors with a geometric spectrum from 1 to 1/kappa, kappa
    in {1e4, 2e4, 5e4, 1e5, 1e6} on f32 iterates and {3e3, 1e4, 3e4,
    1e5} on bf16 ones, the polar stage alone (``zolo_pd_cuda``, l0 =
    1/kappa, r = choose_r(kappa)): finite, orthogonality of Q,
    ||A - QH||_F/||A||_F and the dynamic bound's kappa_est; the
    envelope is the largest kappa within the limits (f32: 1e-4; bf16:
    orthogonality 0.0625) with every smaller one within too.
16. the partial-spectrum frontend on the phase-5 matrix, k = 128, the
    inner solves on the phase-5 config: (a) ``strategy="sketch"``
    (l, q_iters and the decision; the panel solve K1 10 / K2 2; top-k s
    within 1e-4; the a-posteriori residual), (b) ``"dense"``, (c)
    ``"auto"``, (d) ``topk_adaptive(tol=0)``, which must escalate to a
    ``passed`` rung, (e) ``"dnc"`` on ``synthesize("linverse",
    n=4096)`` with ``zolo_cuda_dynamic`` sign probes (converged, count
    within [k, l], rounds; the s error recorded), (f)
    ``lowrank_truncate(a, 128)``: ||A - P Q^T||_F within 1e-4 relative
    of the Eckart-Young optimum, and P Q^T against (a)'s triplets.

With ``--profile-split`` (not in the default run), then one phase-5
solve split by device time into K1, K2, factorizations, triangular
solves, products, ``eigh``, collectives/staging and other: its polar
stage under ``torch.profiler`` (each kernel counted under the outermost
op that launched it; the top kernels printed), its ``eigh`` timed alone
(see ``split_solve``).

17. paper Algorithm 3 (``repro_torch.dist``): GROUPED_WORLD = 4 ranks
    spawned on the one card, joined by gloo (each with a collective
    timeout; the parent has a deadline for all), each calling with the
    full phase-5 matrix (synthesized on rank 0, broadcast): (a)
    ``plan(SvdConfig(kappa, l0_policy="estimate_at_plan"), mesh=
    zolo_group_mesh(4))``, the (4, 1) grid, cold and warm; (b) the same
    on ``zolo_group_mesh(2)``, the (2, 2) grid (11,999 rows padded to
    12,000, 6,000 a rank), then (``--profile-split``) one solve split on
    rank 0 as above; (c) ``SvdConfig(l0_policy="runtime")`` on (2, 2)
    (``zolo_grouped_dynamic``); (f) ``zolo_grouped_dynamic`` on (2, 2)
    with l0 pinned at PINNED_L, below 10 sqrt(eps(f32)): the extreme
    regime, where sep > 1 puts shifted CholeskyQR2 in place of the
    Householder first iteration (no Householder term may run); (d)
    ``solve_with_escalation`` of (b)'s config on (2, 2); (e)
    ``compressed_psum`` of a 4,096^2 f32 gradient a rank at rank 64 over
    the (2, 2) grid's "zolo" group, against its plain version from the
    all-gathered gradients.  Per rank: the method, K1/K2 launches
    (K1 = 3 + (I - 1), plus 1 for (c)'s sigma_min Gram; K2 = I), K2's xw
    (1 on zolo index 0, 0 elsewhere), the all-reduces per axis ((a) 0 sep
    / I zolo; (b) 2 + (I - 1) sep / I zolo; (c) 1 + 2 + 1 + 2 (I - 1) sep
    / I zolo; (f) 2 + 1 + 2 (I - 1) sep / I zolo) and their bytes, the
    local iterate's shape, wall time, peak memory, and that every rank
    holds identical factors and (c), (f) the same iterations and l_init;
    on rank 0 the phase-5 accuracy limits, (a)'s
    s against phase 5's, and (a)'s polar/eigh split.  Gloo stages every
    collective through host memory: these times are one card shared by
    four processes, not the paper's multi-node scaling.  After (a) every
    rank audits (a)'s plan together (``plan.audit(a)``: it runs the
    plan's collectives); each report must be ok with the executed
    budget, 0 "sep" and I "zolo" all-reduces.
18. the SVD service (``repro_torch.serve``) on ``zolo_cuda``, f32,
    ``verify=True``, ``audit_plans=True``: (a) an open-loop stream
    through ``launch.svd_serve.run_workload`` (SERVE_REQUESTS at
    SERVE_RATE/s over SERVE_SHAPES, kappa 1e3, mode "standard", batch
    4): every future resolved within the phase-5 limits against its
    exact spectrum, 0 plan constructions and hit rate 1.0 after warmup,
    one passed audit per bucket with 0 host syncs, each batch's K1/K2
    equal to slots x the bucket plan's per-solve counts; solves/s,
    p50/p99, pad waste, slot fill, peak memory; (b) the phase-5 matrix
    through a service on a 12,000 rung (batch 1): its s against phase
    5's, its wall beside phase 5's; (c) one ``topk:128`` request at
    4,096^2 against the exact leading 128 values; (d) a NaN-injected
    request (rung 0 fails, rung 1 resolves: 1 retry, 0 quarantined) and
    a deadline expired by a skewed clock; (e) ``SvdPlan.audit(a)`` of
    the phase-5 plan (ok, 0 host syncs, K1 10 / K2 2) and of the
    dynamic default (its host syncs reported).  Each audit prints the
    synchronising calls CUDA's sync debug mode saw, by line.
19. the LM training path with ZoloMuon (``repro_torch.train``):
    qwen3-8b at full width (d 4,096, 32/8 heads of 128, d_ff 12,288,
    vocab 151,936, bf16 compute, f32 masters, per-stage remat), depth cut
    to TRAIN_LAYERS, batch TRAIN_BATCH x TRAIN_SEQ of ``SyntheticLM``
    tokens: one warm step and TRAIN_STEPS timed ones (seconds, tokens/s,
    the optimizer's update and its ``orthogonalize`` calls apart from
    forward+backward, peak memory), every loss and gradient norm finite,
    K1/K2 launches in every timed step equal to the Muon plans' count
    (per matrix 1 + 2r + I - 1 K1 and I K2); (b) one more step under
    CUDA's sync debug mode (synchronising calls by line); (c) one leaf
    kind's update on ``zolo_cuda`` against a ``zolo_static`` plan on the
    card within MUON_TOL; (d) K1 and K2 at Muon's tall shape (12,288 x
    4,096) beside their plain versions, library calls and bounds; (e)
    ``python -m repro_torch.launch.train`` in process on the smoke
    config, then its resume from the checkpoint it saved under
    ``build/``.
20. LM serving (``repro_torch.serve.ServeEngine``, greedy) and the MoE,
    SSD and RG-LRU families at full width, depth cut (SERVE_LM): (a)
    qwen3-8b serving from a 32,768-slot KV ring; (b) recurrentgemma-2b
    serving after a prompt longer than its 2,048 window and not a
    multiple of it; (c) mamba2-130m serving and training (ZoloMuon); (d)
    moonshot-v1-16b-a3b training (Muon on the 64-expert stacks) and
    serving.  Each serving run: prefill seconds, decode ms a token (CUDA
    events around each step), tokens/s, cache and peak memory, K1-K4
    launches (0), the synchronising calls of one decode step (0), and
    (a-c) the decode logits against ``hidden_states`` -> ``lm_head`` over
    the same tokens within SERVE_LM_TOL, the greedy tokens equal to that
    forward's argmax wherever its top-2 gap exceeds the tolerance.  Each
    training run: seconds a step, the share in ``orthogonalize``, peak
    memory, and K1/K2 a step equal to the Muon plans' count.
21. the sharded train path (``repro_torch.dist.sharding``): (a) phase
    19's case (the same seed state) on a one-rank ("data", "model") =
    (1, 1) NCCL ``DeviceMesh`` on the card, the state placed by
    ``tree_shardings(arch_rules(...))`` and every step under
    ``activation_hints``: its first step against the unsharded step from
    the same state (loss and gradient norm within SHARDED_TOL relative,
    every updated parameter within MUON_TOL of its update's size), K1/K2
    a step equal to phase 19's, 0 collectives a step, 0 synchronising
    calls (one step under the sync debug mode), the step time beside
    phase 19's and the peak memory; (b) ZoloMuon's row-split solve on
    SHARDED_ROWS_WORLD gloo ranks on the card, on (a)'s momenta of the
    SHARDED_ROWS_CASES leaves (see SHARDED_TOL's note): per rank K1/K2
    equal to the plan's, the Gram and prescale all-reduces over "data"
    and none over "model", Q gathered over "data" within MUON_TOL of the
    single-rank zolo_cuda and zolo_static factors, then K1/K2 at the
    ranks' block shapes against their plain versions; (c) the dry-run
    CLI (``python -m repro_torch.launch.dryrun``) on DRYRUN_CELL on the
    (16, 16) fake mesh, plain and ``--optimized``, and the smoke cells,
    in three subprocesses at once: status ok, per-kind collective counts
    and bytes per rank, the Muon Grams' all-reduces over "data",
    argument bytes per rank and seconds.
22. (a) the port's linter: ``python -m repro_torch.analysis
    src/repro_torch --baseline lint-baseline-torch.json --format=json``
    in a subprocess (the linter needs neither JAX nor torch): rc 0, no
    finding, no parse error, no stale baseline entry, 7 rules; the file
    count and the seconds.  (b) the six ``examples/torch_*.py`` on the
    card at their own defaults, each under its own deadline
    (EXAMPLE_TIMEOUT), its wall seconds printed and its own accuracy
    lines held to the reference's limits:
    ``torch_quickstart.py`` (f64, n = 512; no kernel launch),
    ``torch_distributed_svd.py`` as a script (8 gloo ranks sharing the
    card; its ranks' launches are not counted), ``torch_svd_serve.py``,
    ``torch_svd_topk.py``, ``torch_train_lm.py --full`` (mamba2-130m at
    full width and depth, EXAMPLE_TRAIN: to its periodic checkpoint,
    then resumed from it; K1/K2 = phase 20c's per step times the steps)
    and ``torch_serve_lm.py`` (no kernel launch).  Those that run in
    this process are driven through their ``main(argv)`` with every
    launch count set to 0 before and read after (``example_<name>`` in
    every kernel record's ``launches_by_path``).

4c. K5 (``kernels/cholesky.py``, batched blocked Cholesky): parity at
    (4, 1,000), (1, 4,097) and ragged (2, 129), (3, 385) against its
    plain version (the same blocked algorithm in torch ops), with the
    strides, zero upper triangle and residual ||L L^T - Z||_F / ||Z||_F
    of ``cholesky_ex``'s; an indefinite entry's info; then at (4, 11,999,
    11,999) (the dense solve's shifted Grams): K5's time beside its bound,
    its plain version and two library yardsticks (the batched
    ``cholesky_ex`` the port called before K5 and four single-matrix
    calls), its L against the plain version's (K5_TOL, as at the parity
    shapes), its residual beside the library's, the cuSOLVER kernels each
    yardstick runs (by name, from ``torch.profiler``), and the sweep of n
    over K5_SWEEP_N at batches 1, 2 and 4 against ``cholesky_ex`` (the
    smallest stack that takes K5; CHOLESKY_MIN_N is a limit of scope).
    ``--k5-only`` runs phases 1, 2 and 4c alone (record in
    ``chiprun_out/chip_smoke_k5.json``).  Phase 5 also counts K5's
    launches a solve (``k5_launches_per_solve``: 3 Choleskys at n =
    11,999), and 16a a top-k request's (``k5_launches``: 0, its
    factorizations are at n = 877 < CHOLESKY_MIN_N).

Phases 10-12 run one timed solve each (phases 5 and 7 warmed those
paths at this shape); 5, 7 and 9 run a warm solve before the timed one.

The line before the last names the card and its power limit; the one
before it is a JSON object with one record per kernel and route
(``gram/simt``, ``gram/wgmma``, ``grouped_combine``, ``matmul/simt``,
``matmul/wgmma``, ``flash_attention/wgmma``, ``flash_attention/simt``),
each with its launches on every path above (``launches_by_path``,
phase 20's serving and training runs and phase 22's examples included),
and ``cholesky`` (K5: its launches a dense solve and a top-k request,
phase 4c's times and its error against its plain version);
the last is ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without that line.  It also exits non-zero
when no CUDA device is present (unless rehearsing on the CPU) and when
run outside a checkout of the repository.  A full record is written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N = 11_999          # the paper's linverse dimension (Table 3)
KAPPA = 9.06e3      # its 2-norm condition number
R = 4               # the paper's r for linverse
# phase 13's direct baselines run the linverse spectrum at this n: the
# block-Jacobi eigensolver at n = 11,999 with nb = 32 is 374 host-loop
# rounds per sweep, and the linverse spectrum takes 15-25 sweeps
BASELINE_N = 2048
# phase 14d: the batched verified solve's matrices (4 of them)
BATCH_N = 2048
# phase 15: the kappa sweep of the kernels' envelope, per compute dtype
ENVELOPE_F32 = (1e4, 2e4, 5e4, 1e5, 1e6)
ENVELOPE_BF16 = (3e3, 1e4, 3e4, 1e5)
# phase 16: k of the top-k solves, and the n of the d&c one (each sign
# probe is a full n x n dynamic polar solve, up to 13 of them)
TOPK_K = 128
DNC_N = 4096
# phase 17: grouped Algorithm 3 on this many gloo ranks sharing the card,
# the collectives' timeout in every rank, the parent's deadline for all
# of them, and 17e's compressed_psum: an (n, n) f32 gradient a rank,
# rank-k factors, held to its plain version within CPSUM_TOL of
# max|g_hat| (f32 sums over n = 4,096 products: eps sqrt(n) = 7.6e-6)
GROUPED_WORLD = 4
GROUPED_TIMEOUT = 300
# 17f pins the dynamic driver's lower bound at phase 10's run-time bound on
# the card, in the extreme regime (below 10 sqrt(eps(f32)) = 3.45e-3),
# where a sep > 1 mesh puts shifted CholeskyQR2 in place of the
# structured Householder first iteration
PINNED_L = 2.59e-6
GROUPED_DEADLINE = 480
CPSUM_N, CPSUM_RANK = 4096, 64
CPSUM_TOL = 1e-5
# phase 18: the SVD service on zolo_cuda, f32: (a) an open-loop stream of
# SERVE_REQUESTS at SERVE_RATE/s over SERVE_SHAPES (buckets 4,163^2,
# 4,163 x 2,775 and 1,850^2 on the default ladder), (b) the phase-5
# matrix on a SERVE_FULL_BASE rung (one zero row and column), (c) the
# top-k lane at SERVE_TOPK_N, (d) a NaN-injected request at SERVE_FAULT_N
SERVE_SHAPES = ((4096, 3072), (3000, 2000), (2000, 3000), (1536, 1536))
SERVE_REQUESTS, SERVE_RATE = 24, 4.0
SERVE_KAPPA, SERVE_BATCH = 1e3, 4
SERVE_FULL_BASE = 12_000
SERVE_TOPK, SERVE_TOPK_N = 128, 4096
SERVE_FAULT_N = 1536
# phase 19: the LM training path with ZoloMuon at the full width of
# TRAIN_ARCH (src/repro/configs/qwen3_8b.py): depth cut 36 -> TRAIN_LAYERS,
# global batch 256 -> TRAIN_BATCH at the train_4k sequence length (b = 1
# would leave every 4,096-wide gradient of its 4,095 predicted tokens
# rank-deficient); one warm step, TRAIN_STEPS timed ones, one more under
# CUDA's sync debug mode.  One leaf kind's Muon update on zolo_cuda is
# held to the same momentum through a zolo_static plan on the card within
# MUON_TOL of max|Q| (f32 Grams summed in another order over m = 12,288
# rows, through 3 iterations: eps sqrt(m) ~ 1.3e-5, times a small factor)
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 2, 2, 4096
TRAIN_STEPS = 3
MUON_TOL = 1e-4
MUON_YARDSTICK = "stages/0/mlp/wo"
# the launcher on the smoke config: LAUNCH_STEPS[0] steps, then a resume
# to LAUNCH_STEPS[1] from the checkpoint it saved
LAUNCH_STEPS = (4, 6)
# phase 20: LM serving (ServeEngine) and the MoE, SSD and RG-LRU families
# at full width, depth cut: (a) qwen3-8b (src/repro/configs/qwen3_8b.py),
# 36 -> 2 layers, b 8 (decode_32k's 128, cut), cache capacity 32,768
# (decode_32k's context), prompt 4,096, 64 greedy tokens; (b)
# recurrentgemma-2b, 26 -> 3 layers (one (R, R, A) stage), b 4, prompt
# 3,000 (longer than the 2,048 window and not a multiple of it), max_len
# 4,096, 32 tokens; (c) mamba2-130m at full depth (24 layers): serve b 8,
# prompt 4,096, 64 tokens, and train one warm and 2 timed steps at b 2 x
# 4,096; (d) moonshot-v1-16b-a3b, 48 -> 1 layer: train one warm and one
# timed step at b 2 x 4,096 (Muon on the 64-expert stacks), then serve b
# 4, prompt 2,048, 32 tokens, with a capacity factor of num_experts / top_k
# so that no token is dropped.  Decode logits are held to hidden_states ->
# lm_head over the same tokens within SERVE_LM_TOL of max|logits| (bf16
# products and activations through the cut depth, summed in another order
# by the prefill's blocked attention and the decode's ring; the bf16
# forward test of tests/test_torch_models.py holds the port to the
# reference at the same 5e-2); in (d) the capacity factor keeps the
# forward's b s tokens from coupling, as decode routes b at a time.  Each
# training case holds the updates of its YARDSTICKS leaves on zolo_cuda to
# zolo_static on the card within MUON_TOL (the m of these leaves is at
# most 3,352, below phase 19c's 12,288), and K1/K2 at each of its Muon
# shapes to their plain versions
SERVE_LM_TOL = 5e-2
# what one decode step may allocate beyond the caches it writes in place:
# one layer's cache and this slack for a layer's one-token activations and
# the ring's f32 chunk (DECODE_CHUNK slots of k and v: 256 MiB at 20a's b
# 8, 8 kv heads of 128), so that it does not grow with depth
DECODE_SLACK = 256 * 2**20
SERVE_LM = {
    "20a": {"arch": "qwen3-8b", "layers": 2, "parts": ("serve",),
            "serve": {"batch": 8, "prompt": 4096, "gen": 64,
                      "max_len": 32768}},
    "20b": {"arch": "recurrentgemma-2b", "layers": 3, "parts": ("serve",),
            "serve": {"batch": 4, "prompt": 3000, "gen": 32,
                      "max_len": 4096}},
    "20c": {"arch": "mamba2-130m", "layers": 24, "parts": ("serve", "train"),
            "serve": {"batch": 8, "prompt": 4096, "gen": 64,
                      "max_len": 4096 + 64},
            "train": {"batch": 2, "seq": 4096, "steps": 2,
                      "yardsticks": ("stages/0/mixer/in_proj",
                                     "stages/0/mixer/out_proj")}},
    "20d": {"arch": "moonshot-v1-16b-a3b", "layers": 1,
            "parts": ("train", "serve"),
            "train": {"batch": 2, "seq": 4096, "steps": 1,
                      "yardsticks": ("stages/0/mixer/wq",
                                     "stages/0/mlp/router",
                                     "stages/0/mlp/wi_gate",
                                     "stages/0/mlp/wo")},
            "serve": {"batch": 4, "prompt": 2048, "gen": 32,
                      "max_len": 2048 + 32}},
}
# phase 21: (a) phase 19's step on a (1, 1) mesh against the unsharded
# one from the same state: the same ops on replicated DTensors, so
# loss and gradient norm within SHARDED_TOL relative; (b) ZoloMuon's
# row-split solve (SvdPlan._polar_rows_batched, what the sharded update
# runs on each rank's local blocks) on SHARDED_ROWS_WORLD gloo ranks
# sharing the card, spawned as phase 17's are, on the momenta of 21a's
# last step: each case a Muon leaf on a ("data", "model") mesh, the stack
# over "model" and the long dimension over "data" (the ("opt_stack",
# "opt_rows") hints), Q gathered over "data" held to the single-rank
# zolo_cuda and zolo_static factors within MUON_TOL.  DTensor's own
# redistributes (functional collectives) hang over gloo on CUDA tensors
# (torch 2.11+cu128) and NCCL takes one rank a card, so the whole sharded
# train step on (2, 2) runs only on the CPU
# (tests/test_torch_sharded_train.py); the solve's collectives are plain
# c10d all-reduces, which gloo runs on CUDA tensors.  (c) the dry-run's
# cell, and its deadline for both subprocesses.
SHARDED_TOL = 1e-5
SHARDED_ROWS_WORLD = 4
SHARDED_ROWS_CASES = (("stages/0/mlp/wo", (2, 2)),
                      ("stages/0/mlp/wi_gate", (2, 2)),
                      ("stages/0/mlp/wo", (4, 1)))
SHARDED_ROWS_DEADLINE = 300
DRYRUN_CELL = ("qwen3-8b", "train_4k")
DRYRUN_TIMEOUT = 300
# phase 22: (a) the port's linter (``python -m repro_torch.analysis``) over
# src/repro_torch against its committed baseline, in a subprocess: rc 0,
# no finding, no parse error, LINT_RULES rules; (b) the six
# examples/torch_*.py on the card at their own defaults, each under its
# own deadline (seconds), torch_train_lm.py with --full (mamba2-130m at
# full width and depth) at EXAMPLE_TRAIN's batch and sequence: first to
# the step of its periodic checkpoint (the example's ckpt_every = 50),
# then resumed from it on the same --ckpt-dir to the second step count.
# Each example's accuracy lines are held to the reference's own limits:
# f64 orthogonality 1e-13 and reconstruction / singular values 1e-12
# (tests/test_solver.py, tests/test_grouped.py), top-k values 1e-10 of
# s_max and the adaptive residual 1e-5 (tests/test_spectral.py), the f32
# service lane ACCURACY_TOL
LINT_RULES = 7
LINT_TIMEOUT = 120
EXAMPLE_TRAIN = {"batch": 2, "seq": 512, "steps": (50, 55)}
EXAMPLE_TIMEOUT = {"quickstart": 90, "distributed_svd": 240,
                   "svd_serve": 90, "svd_topk": 90, "train_lm": 240,
                   "serve_lm": 90}
F64_ORTH_TOL = 1e-13
F64_REC_TOL = 1e-12
TOPK_S_RTOL = 1e-10
TOPK_RESIDUAL_TOL = 1e-5
# the rehearsal's toy sizes (no --full)
EXAMPLE_REHEARSAL = {"quickstart": ["--n", "64"],
                     "distributed_svd": ["--m", "64", "--n", "32"],
                     "svd_topk": ["--m", "256", "--n", "64", "--k", "8"],
                     "serve_lm": ["--batch", "2", "--prompt", "16",
                                  "--gen", "4"],
                     "train_lm": {"batch": 2, "seq": 32, "steps": (2, 3)}}
# the CPU rehearsal: the same cases on the smoke configs at a tiny size
SERVE_LM_REHEARSAL = {
    "20a": {"layers": 2, "serve": {"batch": 2, "prompt": 48, "gen": 6,
                                   "max_len": 64}},
    "20b": {"layers": 3, "serve": {"batch": 2, "prompt": 40, "gen": 5,
                                   "max_len": 64}},
    "20c": {"layers": 3, "serve": {"batch": 2, "prompt": 40, "gen": 6,
                                   "max_len": 46},
            "train": {"batch": 2, "seq": 64, "steps": 2}},
    "20d": {"layers": 1, "train": {"batch": 2, "seq": 64, "steps": 1},
            "serve": {"batch": 2, "prompt": 32, "gen": 4, "max_len": 36}},
}
RAGGED = (1000, 333)
EXPECT_LAUNCHES = {"gram": 10, "grouped_combine": 2,  # per static solve
                   "gram/simt": 10, "gram/wgmma": 0,
                   "matmul": 0, "flash_attention": 0,
                   "matmul/simt": 0, "matmul/wgmma": 0,
                   "flash_attention/simt": 0, "flash_attention/wgmma": 0}
# per bf16 compute solve (phase 9): the same 2 iterations on bf16 iterates
EXPECT_BF16_LAUNCHES = dict(EXPECT_LAUNCHES, **{"gram/simt": 0,
                                                "gram/wgmma": 10})
MM_RAGGED = (1001, 333, 517)   # (m, k, n): no multiple of any tile
MM_ALIGNED = 12_000  # rows of 12,000 bf16: TMA reads them as they lie
MM_TRANSPOSED = 4096  # transposed (column-major) views: MN-major operands
MM_ALPHA = 1.5
# one attention layer of qwen3-8b (src/repro/configs/qwen3_8b.py): 32
# query heads of 128, its 8 kv heads expanded to 32; b = 1, s = 4,096
ATTN = {"b": 1, "s": 4096, "h": 32, "d": 128}
ATTN_RAGGED_S = 4000
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 on them, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
K1_TOL = 5e-5       # max|err| / max|G|: f32 sums over m = 12k products
# phase 3b: K1's f32 split route at ZoloMuon's shapes (phase 20's five and
# phase 19's K/V momenta, 4,096 x 1,024, each with S > 1 on 132 SMs) and
# its edge cases (ragged tiles, n below and around the narrow tile, a
# short m that must take S = 1, a wide A); the shapes that must keep
# S = 1 (128-wide tiles, no split); K2's r there
K1_SPLIT_SHAPES = ((2048, 1408), (2048, 2048), (2048, 64), (3352, 768),
                   (1536, 768), (4096, 1024))
K1_EDGE_SHAPES = ((2047, 1409), (2048, 1), (2048, 63), (2048, 65), (5, 64),
                  (3072, 4096))
K1_UNSPLIT_SHAPES = ((11_999, 11_999), (12_288, 4096), (6144, 4096),
                     (3072, 4096), (5, 64))
MUON_R = 2
# phase 4b also times K1/K2 at Muon's shapes with S = 1: phase 19's tall one
# and 21b's rank blocks
K1_MUON_UNSPLIT_SHAPES = ((12_288, 4096), (6144, 4096), (3072, 4096))
# step seconds before K1's split route and K2's single launch, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5: phase 19 chip call 4
# of PR 21, 20c/20d chip call 16 of PR 20), printed beside this run's
PRIOR_STEP_S = {"19": 2.253, "20c": 0.904, "20d": 4.354}
K2_TOL_F32 = 1e-6   # max|err| / max|Y| in f32 (bf16: combine_bf16_ok)
ACCURACY_TOL = 1e-4  # f32 eps * sqrt(n) ~ 1.3e-5, times a small factor
# a bf16 compute solve, held to the reference's own bf16 criteria:
# orthogonality of U and Vh <= default_orth_tol(bf16) = 8 eps(bf16)
# (src/repro/resilience/health.py), and the top half of s within 5e-2
# relative of the exact spectrum (tests/test_bf16_envelope.py)
BF16_ORTH_TOL = 8 * 2.0 ** -7
BF16_S_RTOL = 5e-2
# K4 in f32, max error / max|v|: the d-term scores and the s-term sums
# are rounded in another order than the plain version (measured ~1e-7).
# bf16 is held elementwise by flash_bf16_bound, with this as its f32 term
K4_TOL_F32 = 1e-5
KERNEL_MODULES = ("gram", "grouped_combine", "matmul", "flash_attention")
# K5 (phase 4c): parity shapes (batch, n), the full-size stack, and the
# sweep beside cholesky_ex by n and batch; its own counter
# (kernels/cholesky.py::launches), outside KERNEL_MODULES so the other
# phases' launch dicts keep their keys
K5_PARITY = ((4, 1000), (1, 4097), (2, 129), (3, 385))
K5_NEAR_ID = (4, 4096)
K5_SWEEP_N = (877, 1024, 1408, 2048, 4096, N)
K5_SWEEP_BATCH = (1, 2, 4)
K5_PER_SOLVE = 3  # phase 5: two Choleskys in the CholeskyQR2 iteration,
                  # one in the Cholesky iteration, all at n = 11,999
# max|L - L_plain| / max|L_plain|, f32 in another summation order at
# kappa <= ~4e3: on an H100 1.2-1.7e-6 at K5_PARITY, 6.1e-7 at (4, 11,999)
K5_TOL = 1e-5
K5_RESID_FACTOR = 4.0  # K5's residual against cholesky_ex's
# K1, K3 and K4 pick a route per call (kernels/gram.py, matmul.py,
# flash_attention.py)
ROUTED = ("gram", "matmul", "flash_attention")
ROUTES = ("simt", "wgmma")
# the tensor-core kernels' entry points' names
WGMMA_KERNELS = ("gram_bf16", "matmul_bf16", "flash_bf16")


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg):
    if not ok:
        fail(msg)


class Clock:
    """CUDA events on the card, the host clock in a CPU rehearsal."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def ms(self, fn, reps, warm=1):
        for _ in range(warm):
            fn()
        self.sync()
        if self.device.type == "cuda":
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            self.torch.cuda.synchronize()
            return e0.elapsed_time(e1) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def bf16_ulp(torch, want):
    """One bf16 ulp of each element of ``want``."""
    w = want.float().abs()
    _, e = torch.frexp(torch.where(w > 0, w, torch.ones_like(w)))
    return torch.where(w > 0, torch.ldexp(torch.ones_like(w), e - 8),
                       torch.full_like(w, 2.0 ** -133))


def combine_bf16_ok(torch, got, want, x, t, a, mhat, xw):
    """K2 with a bf16 output: |got - want| <= one bf16 ulp of want plus
    the forward error bound of the two f32 sums, (2r + 2) eps(f32)
    |mhat| (|xw x| + sum_j |a_j t_j|) — the kernel's fused multiply-adds
    and the plain version's separate products round differently, which
    only shows where the sum cancels.  Returns (ok, elements beyond one
    ulp)."""
    r = t.shape[0]
    mag = (abs(xw) * x.float().abs()
           + torch.einsum("j,jmn->mn", a.abs(), t.float().abs()))
    slack = (2 * r + 2) * torch.finfo(torch.float32).eps * \
        float(abs(mhat)) * mag
    diff = (got.float() - want.float()).abs()
    ulp = bf16_ulp(torch, want)
    return bool((diff <= ulp + slack).all()), int((diff > ulp).sum())


def phase_device(torch, device):
    say("== phase 1: device")
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type == "cuda":
        info["name"] = torch.cuda.get_device_name(0)
        info["count"] = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        info["nvidia_smi"] = smi[0]
        say(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    info["allow_tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                          "cudnn": torch.backends.cudnn.allow_tf32}
    info["float32_matmul_precision"] = torch.get_float32_matmul_precision()
    say(json.dumps(info))
    return info


def phase_build():
    from repro_torch.kernels import build

    say("== phase 2: build")
    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    flags = []
    for name, path in libs.items():
        say(f"{name}: {os.path.relpath(path, HERE)}")
        entry = None
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "smem", "bytes stack", "warning",
                                       "serialized")):
                say("  " + line.strip())
            spills = "spill stores" in line and \
                not line.strip().startswith("0 bytes stack frame, 0 bytes")
            if spills or "serialized" in line:
                flags.append((name, entry or "", line.strip()))
    for name, entry, line in flags:
        say(f"FLAG {name}: {line} ({entry})")
    say(f"build seconds: {secs:.1f}")
    # the tensor-core kernels must neither spill nor serialize their wgmma
    bad = [f for f in flags if "serialized" in f[2]
           or any(k in f[1] for k in WGMMA_KERNELS)]
    check(not bad, f"wgmma kernels spill or serialize: {bad}")
    return {"seconds": secs, "ptxas": dict(build.PTXAS_LOG),
            "flags": [list(f) for f in flags]}


def kernel_modules():
    """The launch counters of the four kernel wrappers."""
    import importlib

    return tuple(importlib.import_module(f"repro_torch.kernels.{name}")
                 for name in KERNEL_MODULES)


def read_counts(counters):
    """{kernel: launches}, plus {"kernel/route": launches} for K3 and K4."""
    counts = {}
    for m in counters:
        name = m.__name__.rsplit(".", 1)[-1]
        counts[name] = m.launches
        for route, c in getattr(m, "launches_by_route", {}).items():
            counts[f"{name}/{route}"] = c
    return counts


def zero_counts(counters):
    for mod in counters:
        mod.launches = 0
        for route in getattr(mod, "launches_by_route", {}):
            mod.launches_by_route[route] = 0
        getattr(mod, "launches_by_split", {}).clear()


def split_counts():
    """K1's ``"simt"`` launches by split S since the counts were last
    zeroed: {S: launches}."""
    from repro_torch.kernels import gram as kgram

    return dict(sorted(kgram.launches_by_split.items()))


def path_run(torch, counters, fn):
    """Drive one path: every launch count set to 0 just before, read
    just after (the device synchronised in between)."""
    zero_counts(counters)
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, read_counts(counters)


def check_path_launches(device, name, route, launches):
    """The path of ``name`` on ``route`` launched that kernel once, on that
    route, and nothing else."""
    if device.type == "cuda":
        want = {k: int(k == name) for k in KERNEL_MODULES}
        want.update({f"{k}/{r}": int(k == name and r == route)
                     for k in ROUTED for r in ROUTES})
        check(launches == want, f"the {name} path ({route}) launched "
              f"{launches}, expected {want}")


def route_call(device, mod, route, fn):
    """fn() with ``mod``'s route counters read around it: on the card it
    must launch once, on ``route``."""
    before = dict(mod.launches_by_route)
    out = fn()
    delta = {r: mod.launches_by_route[r] - before[r] for r in before}
    if device.type == "cuda":
        check(delta == {r: int(r == route) for r in before},
              f"{mod.__name__} launched {delta}, expected one on {route}")
    return out


def matmul_case(torch, device, rows, a, b, tag, route, got=None):
    """K3 against its plain version, elementwise within the f32 sums'
    forward error bound k eps |alpha| (|A| @ |B|) (two orders of k exact
    products); launched on ``route`` (checked on the card) unless ``got``
    comes from a path run."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops, ref

    k = a.shape[1]
    if got is None:
        got = route_call(device, kmm, route,
                         lambda: ops.matmul(a, b, MM_ALPHA))
    want = ref.matmul_ref(a, b, MM_ALPHA)
    diff = (got - want).abs()
    bound = (k * torch.finfo(torch.float32).eps * abs(MM_ALPHA)
             * (a.float().abs() @ b.float().abs()))
    ok = bool((diff <= bound).all())
    err = float(diff.amax())
    rel = err / float(want.abs().amax())
    rows.append({"kernel": "matmul", "route": route, "case": tag,
                 "max_abs_err": err, "rel_err": rel})
    say(f"K3 {tag} [{route}]: max_abs_err {err:.3e} rel {rel:.3e}, within "
        f"k eps |alpha| (|A| @ |B|) everywhere: {ok}")
    check(ok, f"K3 {tag}")
    check(got.dtype == torch.float32, f"K3 {tag}: output {got.dtype}")


def flash_bf16_bound(torch, q, k, v, want):
    """Elementwise bound on a bf16 K4 output against the plain version
    ``want`` (f32, P kept in f32): 2^-8 (P|V|)_ij for P rounded to bf16
    before PV (2^-8 relative per weight; P|V| is the plain version on
    |v|), 2^-8 |o_ij| for the bf16 output (|o| <= |want| + 2^-8 P|V|),
    and K4_TOL_F32 max|v| for the f32 arithmetic."""
    from repro_torch.kernels import ref

    u = 2.0 ** -8
    pv = ref.flash_attention_ref(q, k, v.abs())
    return ((u + u * u) * pv + u * want.abs()
            + K4_TOL_F32 * float(v.float().abs().amax()))


def flash_case(torch, device, rows, q, k, v, tag, route, got=None):
    """K4 against its plain version: f32 max error / max|v| within
    K4_TOL_F32; bf16 elementwise within flash_bf16_bound; launched on
    ``route`` (checked on the card) unless ``got`` comes from a path
    run."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref

    if got is None:
        got = route_call(device, kflash, route,
                         lambda: ops.flash_attention(q, k, v))
    want = ref.flash_attention_ref(q, k, v)
    diff = (got.float() - want).abs()
    err = float(diff.amax())
    rel = err / float(v.float().abs().amax())
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"K4 {tag}: output {got.dtype} {tuple(got.shape)}")
    row = {"kernel": "flash_attention", "route": route, "case": tag,
           "max_abs_err": err, "rel_err": rel}
    tag = f"{tag} [{route}]"
    if q.dtype == torch.float32:
        say(f"K4 {tag}: max_abs_err {err:.3e}, / max|v| {rel:.3e} "
            f"(tolerance {K4_TOL_F32:.3e})")
        ok = rel <= K4_TOL_F32
    else:
        bound = flash_bf16_bound(torch, q, k, v, want)
        ratio = float((diff / bound).amax())
        row["max_err_over_bound"] = ratio
        ok = ratio <= 1.0
        say(f"K4 {tag}: max_abs_err {err:.3e}, / max|v| {rel:.3e}; "
            f"max |err| / (2^-8 (P|V| + |o|) + f32 term) {ratio:.3f} "
            f"(tolerance 1)")
        del bound
    rows.append(row)
    check(ok, f"K4 {tag}: beyond its tolerance")


def phase_parity(torch, device, n, ragged, attn, mm_ragged, s_ragged,
                 mm_aligned, mm_transposed):
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops, ref

    say("== phase 3: kernel parity at full width")
    gen = torch.Generator(device=device).manual_seed(1234)
    rows = []

    counters = kernel_modules()
    paths = {}
    bf = torch.bfloat16

    def k1_case(a, tag, route, got0=None):
        """K1 against its plain version at c = 0, below and above the clamp
        floor: an f32 A within K1_TOL (max error / max|G|), a bf16 A
        elementwise within the f32 sums' forward error bound
        m eps (|A|^T |A|) (as K3 bf16 is held: the tensor cores sum in
        another order and rounding than cuBLAS), G exactly symmetric, the
        applied shift max(c, floor).  Each call reads
        its route's counter around it (on the card: one launch, on
        ``route``); ``got0``: the c = 0 result of a path run."""
        g0 = ref.gram_ref(a)
        floor = 8.0 * torch.finfo(torch.float32).eps * \
            float(torch.diagonal(g0).amax())
        del g0
        bound = None
        if a.dtype == bf:
            absa = a.float().abs()
            bound = a.shape[0] * torch.finfo(torch.float32).eps * \
                (absa.mT @ absa)
            del absa
        for cname, c in (("0", 0.0), ("below_floor", 0.25 * floor),
                         ("above_floor", 4.0 * floor)):
            if cname == "0" and got0 is not None:
                got = got0
            else:
                got = route_call(device, kgram, route,
                                 lambda: ops.gram(a, c))
            want = ref.gram_ref(a, c)
            diff = (got - want).abs()
            err = float(diff.amax())
            rel = err / float(want.abs().amax())
            row = {"kernel": "gram", "route": route,
                   "case": f"{tag} c={cname}", "max_abs_err": err,
                   "rel_err": rel}
            line = f"K1 {tag} c={cname} [{route}]: max_abs_err {err:.3e} " \
                f"rel {rel:.3e}"
            if bound is None:
                ok = rel <= K1_TOL
            else:
                ratio = float((diff / bound).amax())
                row["max_err_over_bound"] = ratio
                line += (f"; max |err| / (m eps |A|^T |A|) {ratio:.3e} "
                         f"(tolerance 1)")
                ok = bool((diff <= bound).all())
            rows.append(row)
            say(line)
            check(got.dtype == torch.float32, f"K1 {tag}: {got.dtype}")
            check(ok, f"K1 {tag} c={cname}: beyond its tolerance")
            check(bool(torch.equal(got, got.mT)), f"K1 {tag} not symmetric")
            if c:
                # the shift the kernel applied, averaged over the diagonal
                # (c_eff is only ~8 ulps of max diag G, below the parity
                # tolerance): max(c, floor), i.e. the clamp fired or not
                applied = float((torch.diagonal(got).double()
                                 - torch.diagonal(ops.gram(a)).double())
                                .mean())
                expect = max(c, floor)
                say(f"   applied shift {applied:.4e}, expected {expect:.4e}")
                check(abs(applied - expect) <= 0.05 * expect,
                      f"K1 {tag} c={cname}: shift {applied:.4e} applied, "
                      f"{expect:.4e} expected")
            del got, want, diff
        del bound

    # K1: one path per route (f32 on simt, bf16 on wgmma), each at the
    # linverse width; then every other case, its route's counter read
    # around it
    a32 = torch.randn((n, n), generator=gen, dtype=torch.float32,
                      device=device)
    for route, a_, tag in (("simt", a32, f"f32 {n}x{n}"),
                           ("wgmma", a32.to(bf), f"bf16 {n}x{n} (staged)")):
        got, paths[f"gram/{route}"] = path_run(
            torch, counters, lambda: ops.gram(a_))
        say(f"kernels.ops.gram path, {tag}: launches "
            f"{paths[f'gram/{route}']}")
        check_path_launches(device, "gram", route, paths[f"gram/{route}"])
        k1_case(a_, tag, route, got)
        del got
    k1_case(a_.mT, f"bf16 {n}x{n} (column-major view, staged)", "wgmma")
    del a_
    na = mm_aligned
    a = torch.randn((na, na), generator=gen, device=device).to(bf)
    k1_case(a, f"bf16 {na}x{na} (row-major, zero-copy)", "wgmma")
    k1_case(a.mT, f"bf16 {na}x{na} (column-major view, zero-copy)",
            "wgmma")
    del a
    small = torch.randn(ragged, generator=gen, device=device)
    k1_case(small, f"f32 {ragged[0]}x{ragged[1]}", "simt")
    for t in (small, small.mT.contiguous()):
        k1_case(t.to(bf), f"bf16 {t.shape[0]}x{t.shape[1]}", "wgmma")
    del small
    if device.type == "cuda":
        torch.cuda.empty_cache()

    x32 = a32
    t32 = torch.randn((R, n, n), generator=gen, dtype=torch.float32,
                      device=device)
    coef = torch.randn((R,), generator=gen, dtype=torch.float32,
                       device=device)
    mhat = torch.tensor(0.987, device=device)
    for r in (1, R):
        for xdt, tdt, tag in ((torch.float32, torch.float32, "f32"),
                              (torch.bfloat16, torch.bfloat16, "bf16"),
                              (torch.bfloat16, torch.float32, "bf16/f32")):
            x = x32.to(xdt)
            t = t32[:r].to(tdt)
            for xw in (0.0, 1.0):
                got = ops.grouped_combine(x, t, coef[:r], mhat, xw)
                want = ref.grouped_combine_ref(x, t, coef[:r], mhat, xw)
                err = float((got.float() - want.float()).abs().amax())
                case = f"{tag} r={r} xw={xw:g}"
                if xdt == torch.float32:
                    rel = err / float(want.abs().amax())
                    ok = rel <= K2_TOL_F32
                    say(f"K2 {case}: max_abs_err {err:.3e} rel {rel:.3e}")
                else:
                    rel = None
                    ok, beyond = combine_bf16_ok(torch, got, want, x, t,
                                                 coef[:r], mhat, xw)
                    say(f"K2 {case}: max_abs_err {err:.3e}, within one "
                        f"bf16 ulp + f32 sum bound: {ok} ({beyond} "
                        f"elements beyond one ulp)")
                rows.append({"kernel": "grouped_combine", "case": case,
                             "max_abs_err": err, "rel_err": rel})
                check(ok, f"K2 {case}")
                del got, want
            del x, t

    # K3: its path is kernels.ops.matmul (no solver path reaches it), one
    # path per route; then every case, its route's counter read around it
    b32 = t32[0]
    for route, (a_, b_, tag) in (
            ("simt", (a32, b32, f"f32 {n}x{n}")),
            ("wgmma", (a32.to(bf), b32.to(bf), f"bf16 {n}x{n} (staged)"))):
        got, paths[f"matmul/{route}"] = path_run(
            torch, counters, lambda: ops.matmul(a_, b_, MM_ALPHA))
        say(f"kernels.ops.matmul path, {tag}: launches "
            f"{paths[f'matmul/{route}']}")
        check_path_launches(device, "matmul", route,
                            paths[f"matmul/{route}"])
        matmul_case(torch, device, rows, a_, b_, tag, route, got)
        del got, a_, b_
    na, nt = mm_aligned, mm_transposed
    a = torch.randn((na, na), generator=gen, device=device).to(bf)
    b = torch.randn((na, na), generator=gen, device=device).to(bf)
    matmul_case(torch, device, rows, a, b,
                f"bf16 {na}x{na} (row-major, zero-copy)", "wgmma")
    at, bt = a[:nt, :nt].contiguous().mT, b[:nt, :nt].contiguous().mT
    del a, b
    matmul_case(torch, device, rows, at, bt,
                f"bf16 {nt}x{nt} (transposed views, zero-copy)", "wgmma")
    matmul_case(torch, device, rows, at.mT, bt,
                f"bf16 {nt}x{nt} (row-major A, transposed B)", "wgmma")
    matmul_case(torch, device, rows, at.float(), bt,
                f"f32/bf16 {nt}x{nt} (mixed)", "simt")
    del at, bt
    mm, kk, nn = mm_ragged
    for dt, tag, route in ((torch.float32, "f32", "simt"),
                           (bf, "bf16 (staged)", "wgmma")):
        a = torch.randn((mm, kk), generator=gen, device=device).to(dt)
        b = torch.randn((kk, nn), generator=gen, device=device).to(dt)
        matmul_case(torch, device, rows, a, b,
                    f"{tag} ({mm}, {kk}) @ ({kk}, {nn})", route)
    matmul_case(torch, device, rows, a, b.float(),
                f"bf16/f32 ({mm}, {kk}) @ ({kk}, {nn}) (mixed)", "simt")
    del a, b
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # K4: its path is kernels.ops.flash_attention (no model reaches it), one
    # path per route: bf16 at d = 128 (wgmma) and f32 (simt)
    b_, s_, h_, d_ = attn["b"], attn["s"], attn["h"], attn["d"]

    def qkv(dt, s, d, layout):
        shape = (b_, h_, s, d) if layout == "bhsd" else (b_, s, h_, d)
        out = [torch.randn(shape, generator=gen, device=device).to(dt)
               for _ in range(3)]
        return [t.transpose(1, 2) for t in out] if layout == "bhsd" else out

    for dt, tag, route in ((bf, "bf16", "wgmma"),
                           (torch.float32, "f32", "simt")):
        q, k, v = qkv(dt, s_, d_, "bshd")
        got, paths[f"flash_attention/{route}"] = path_run(
            torch, counters, lambda: ops.flash_attention(q, k, v))
        say(f"kernels.ops.flash_attention path, {tag} {(b_, s_, h_, d_)}: "
            f"launches {paths[f'flash_attention/{route}']}")
        check_path_launches(device, "flash_attention", route,
                            paths[f"flash_attention/{route}"])
        flash_case(torch, device, rows, q, k, v, f"{tag} s={s_}", route, got)
        del got
        r_ = slice(0, s_ragged)
        flash_case(torch, device, rows, q[:, r_].contiguous(),
                   k[:, r_].contiguous(), v[:, r_].contiguous(),
                   f"{tag} s={s_ragged}", route)
        del q, k, v
    # the wgmma route's other shapes: both layouts, d = 64 and 128, both s
    for d in (d_, d_ // 2):
        for s in (s_, s_ragged):
            for layout in ("bshd", "bhsd"):
                if (d, s, layout) == (d_, s_, "bshd"):
                    continue  # its path run above
                q, k, v = qkv(bf, s, d, layout)
                flash_case(torch, device, rows, q, k, v,
                           f"bf16 s={s} d={d} {layout}", "wgmma")
                del q, k, v
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows, (a32, t32, coef, mhat), paths


def phase_split_parity(torch, device, split_shapes, edge_shapes,
                       unsplit_shapes):
    """Phase 3b: K1's f32 route split over m, and K2, at ZoloMuon's shapes.

    K1 at every shape, row-major and as a column-major view (both read as
    they lie), at c = 0, below and above the clamp floor: within K1_TOL
    (max error / max|G|), exactly symmetric, the applied shift max(c,
    floor), bitwise the same over two launches, and every launch on the
    "simt" route with the S the rule gives.  The rule's S = 1 at ``unsplit_shapes`` and
    S > 1 at ``split_shapes`` on this card's SM count.  K2 (r = MUON_R)
    at ``split_shapes`` with xw a python number and a tensor, within
    K2_TOL_F32, one launch a call."""
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import grouped_combine as kcomb
    from repro_torch.kernels import ops, ref

    say("== phase 3b: K1 f32 split over m, and K2, at ZoloMuon's shapes")
    on_card = device.type == "cuda"
    sms = kgram.device_sms(device) if on_card else 132
    gen = torch.Generator(device=device).manual_seed(2022)
    rows = []
    rule = {f"{m_}x{n_}": kgram.gram_split(m_, n_, sms)
            for m_, n_ in tuple(unsplit_shapes) + tuple(split_shapes)}
    say(f"gram_split on {sms} SMs: {rule}")
    if on_card:
        check(all(rule[f"{m_}x{n_}"] == 1 for m_, n_ in unsplit_shapes)
              and all(rule[f"{m_}x{n_}"] > 1 for m_, n_ in split_shapes),
              f"3b: the split rule gave {rule}")
        resident = {t: kgram.gram_resident(t) for t in (128, 64)}
        say(f"split kernel: resident blocks an SM {resident}, the rule "
            f"assumes {kgram.GRAM_RESIDENT}")
        check(resident == kgram.GRAM_RESIDENT,
              f"3b: resident blocks {resident}")
    for m_, n_ in tuple(split_shapes) + tuple(edge_shapes):
        a = torch.randn((m_, n_), generator=gen, device=device)
        sl = kgram.gram_split(m_, n_, sms)
        g0 = ref.gram_ref(a)
        floor = 8.0 * torch.finfo(torch.float32).eps * \
            float(torch.diagonal(g0).amax())
        del g0
        for lay, x in (("row-major", a),
                       ("column-major view", a.mT.contiguous().mT)):
            tag = f"f32 {m_}x{n_} {lay} S={sl}"
            for cname, c in (("0", 0.0), ("below_floor", 0.25 * floor),
                             ("above_floor", 4.0 * floor)):
                zero_counts(kernel_modules())
                got = ops.gram(x, c)
                again = ops.gram(x, c)
                launched = (kgram.launches, dict(kgram.launches_by_route),
                            split_counts())
                want = ref.gram_ref(x, c)
                err = float((got - want).abs().amax())
                rel = err / max(float(want.abs().amax()), 1e-30)
                same = bool(torch.equal(got, again))
                sym = bool(torch.equal(got, got.mT))
                say(f"K1 {tag} c={cname}: max_abs_err {err:.3e} rel "
                    f"{rel:.3e}, symmetric {sym}, two launches bitwise "
                    f"equal {same}; launches {launched}")
                rows.append({"kernel": "gram", "route": "simt",
                             "case": f"{tag} c={cname}", "max_abs_err": err,
                             "rel_err": rel, "bitwise_repeat": same})
                check(rel <= K1_TOL and sym and same,
                      f"3b: K1 {tag} c={cname}")
                if on_card:
                    check(launched == (2, {"simt": 2, "wgmma": 0},
                                       {sl: 2}),
                          f"3b: K1 {tag} launched {launched}")
                if c:
                    applied = float((torch.diagonal(got).double()
                                     - torch.diagonal(ops.gram(x)).double())
                                    .mean())
                    expect = max(c, floor)
                    check(abs(applied - expect) <= 0.05 * expect,
                          f"3b: K1 {tag} c={cname}: shift {applied:.4e} "
                          f"applied, {expect:.4e} expected")
                del got, again, want
        del a
    for m_, n_ in split_shapes:
        x = torch.randn((m_, n_), generator=gen, device=device)
        t = torch.randn((MUON_R, m_, n_), generator=gen, device=device)
        coef = torch.randn((MUON_R,), generator=gen, device=device)
        mhat = torch.tensor(0.987, device=device)
        for xw in (1.0, torch.tensor(1.0, device=device), -0.5,
                   torch.tensor(-0.5, device=device)):
            kind = "tensor" if isinstance(xw, torch.Tensor) else "number"
            case = f"f32 r={MUON_R} {m_}x{n_} xw={float(xw):g} ({kind})"
            before = kcomb.launches
            got = ops.grouped_combine(x, t, coef, mhat, xw)
            n_launch = kcomb.launches - before
            want = ref.grouped_combine_ref(x, t, coef, mhat, xw)
            err = float((got - want).abs().amax())
            rel = err / float(want.abs().amax())
            say(f"K2 {case}: max_abs_err {err:.3e} rel {rel:.3e}, "
                f"launches {n_launch}")
            rows.append({"kernel": "grouped_combine", "case": case,
                         "max_abs_err": err, "rel_err": rel})
            check(rel <= K2_TOL_F32, f"3b: K2 {case}")
            if on_card:
                check(n_launch == 1, f"3b: K2 {case}: {n_launch} launches")
            del got, want
        del x, t
    if on_card:
        torch.cuda.empty_cache()
    return {"rows": rows, "rule": rule}


def fmt_ms(ms):
    return "n/a" if ms is None else f"{ms:.3f} ms"


def library_f32_out(torch, clock, fn, ok, reps):
    """Time one library call with f32 output from bf16 operands
    (``torch.mm(..., out_dtype=torch.float32)``) after checking its result
    with ``ok``; {"ms": None, "error": text} when this torch lacks it."""
    try:
        got = fn()
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        text = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        say(f"library call unavailable: {text}")
        return {"ms": None, "error": text}
    check(got.dtype == torch.float32, f"library call returned {got.dtype}")
    check(ok(got), "library call disagrees with the plain version")
    del got
    return {"ms": clock.ms(fn, reps, warm=1), "call": "torch.mm(..., "
            "out_dtype=torch.float32)"}


def device_ms(torch, fn, reps):
    """fn's device time from ``torch.profiler`` (CUPTI) over ``reps``
    calls, recorded in the active step of a schedule after a warm-up step
    of one call: {"ms": the device time of every kernel, memset and copy
    the calls ran, over ``reps``, or None where the trace is not whole;
    "per_call": how many they ran a call; "by_name": {name: ms a call}};
    None off the card.  A trace can miss events (one of five 42 ms kernels
    once, every event after phases 17-19 once): where the count of
    recorded operations is not a whole multiple of ``reps``, or is 0, the
    device time is not measured ("ms" None)."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile, schedule

    active = []  # the active step's averages, handed over as it ends
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: active.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    total, count, by_name = 0.0, 0, {}
    for e in (active[0] if active else ()):
        if getattr(getattr(e, "device_type", None), "name", "") != "CUDA" \
                or e.key.startswith("ProfilerStep"):  # the step's span
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        count += e.count
        by_name[e.key[:80]] = us / reps / 1e3
    whole = count > 0 and count % reps == 0
    return {"ms": total / reps / 1e3 if whole else None,
            "per_call": count / reps, "by_name": by_name}


def k1_bound(m, n, itemsize, peak):
    """K1's bound: G is symmetric, so the function needs m n (n + 1) flops
    (its upper triangle); bytes: A read once, G (f32) written once."""
    flops = float(m) * n * (n + 1)
    nbytes = float(itemsize) * m * n + 4.0 * n * n
    return (max(flops / peak, nbytes / PEAK_BYTES) * 1e3,
            "operations" if flops / peak > nbytes / PEAK_BYTES else "bytes")


def k1_f32_times(torch, clock, a32, reps, profile=False):
    """K1 on an f32 A (c = 0) beside its plain version, ``a.T @ a`` and
    its bound, with its split S and tile; with ``profile``, also the
    device time per call of the kernel and of the library call from the
    profiler over the same calls."""
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops, ref

    m, n = a32.shape
    sms = kgram.device_sms(a32.device) if a32.is_cuda else 132
    slices = kgram.gram_split(m, n, sms)
    rec = {"ms": clock.ms(lambda: ops.gram(a32), reps),
           "plain_ms": clock.ms(lambda: ref.gram_ref(a32), reps),
           "library_ms": clock.ms(lambda: a32.mT @ a32, reps),
           "library": "a.T @ a", "shape": f"A f32 ({m}, {n}), c = 0",
           "slices": slices, "tile": kgram.gram_tile(slices)}
    if profile:
        rec["device"] = device_ms(torch, lambda: ops.gram(a32), reps)
        rec["library_device"] = device_ms(torch, lambda: a32.mT @ a32,
                                          reps)
        # the same A stored column-major (the CholeskyQR2 second pass's
        # operands) as the wrapper takes it (in place; copied row-major
        # where S = 1 and no column is float4-aligned), against a
        # row-major copy made here and K1
        acol = a32.mT.contiguous().mT
        rec["col_ms"] = clock.ms(lambda: ops.gram(acol), reps)
        rec["col_copy_ms"] = clock.ms(lambda: ops.gram(acol.contiguous()),
                                      reps)
        del acol
    rec["bound_ms"], rec["bound_by"] = k1_bound(m, n, 4, PEAK_F32)
    return rec


def fmt_dev_ms(dev):
    """A profiler device time, or why there is none."""
    if dev["ms"] is None:
        return (f"not measured (the trace holds {dev['per_call']:g} "
                f"operations a call)")
    return f"{dev['ms']:.4f} ms ({dev['per_call']:g} a call)"


def fmt_device(rec):
    """`` device K / L ms`` of a record's profiler times (and K1's
    column-major read), or nothing."""
    if rec.get("device") is None:
        return ""
    return (f"; device {fmt_dev_ms(rec['device'])}, library "
            f"{fmt_dev_ms(rec['library_device'])}"
            + (f"; column-major A as the wrapper takes it "
               f"{rec['col_ms']:.4f} ms, copied row-major first "
               f"{rec['col_copy_ms']:.4f} ms"
               if "col_ms" in rec else ""))


def k2_f32_times(torch, clock, x, t, a, mhat, reps, profile=False):
    """K2 (xw = 1) on an f32 X and (r, m, n) terms beside its plain
    version, one ``addmm`` computing the whole combine (checked against
    the plain version first) and its bound; with ``profile``, also the
    device time per call of both from the profiler, and one device
    operation a call checked; printed."""
    from repro_torch.kernels import ops, ref

    m, n = x.shape
    r = t.shape[0]
    xrow = x.view(1, -1)
    mh = float(mhat)  # read once, outside the timed calls
    # one call computing mhat (xw X + sum_j a_j T_j) in f32 (xw = 1):
    # the (1, r) @ (r, m n) product plus beta X
    arow, tflat = a.view(1, r), t.reshape(r, -1)

    def library():
        return torch.addmm(xrow, arow, tflat, beta=mh, alpha=mh)

    want = ref.polar_update_ref(x, t, a, mhat)
    lib_err = float((library().view(m, n) - want).abs().amax())
    check(lib_err <= K2_TOL_F32 * float(want.abs().amax()),
          f"K2 r={r}: addmm is not the combine ({lib_err:.3e})")
    del want
    rec = {"ms": clock.ms(lambda: ops.polar_update(x, t, a, mhat),
                          4 * reps, warm=2),
           "plain_ms": clock.ms(
               lambda: ref.polar_update_ref(x, t, a, mhat), reps),
           "library_ms": clock.ms(library, 4 * reps, warm=2),
           "library_max_abs_err": lib_err,
           "einsum_terms_only_ms": clock.ms(
               lambda: torch.einsum("j,jmn->mn", a, t), reps)}
    if profile:
        rec["device"] = device_ms(
            torch, lambda: ops.polar_update(x, t, a, mhat), reps)
        rec["library_device"] = device_ms(torch, library, reps)
    nbytes = 4.0 * (r + 2) * m * n
    flops = (2.0 * r + 2.0) * m * n
    rec["bound_ms"] = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
    rec["bound_by"] = "bytes" if nbytes / PEAK_BYTES > \
        flops / PEAK_F32 else "operations"
    rec["shape"] = f"X f32 ({m}, {n}), T ({r}, {m}, {n}), xw = 1"
    say(f"K2 f32 r={r} ({m}, {n}): kernel {rec['ms']:.3f} ms, plain "
        f"{rec['plain_ms']:.3f} ms, library (addmm) "
        f"{rec['library_ms']:.3f} ms (max_abs_err against the plain "
        f"version {lib_err:.3e}; einsum of the terms alone, without X "
        f"and mhat: {rec['einsum_terms_only_ms']:.3f} ms), bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})" + fmt_device(rec))
    if rec.get("device") is not None:
        # one launch a call: no device operation but the combine kernel,
        # and no more of it than calls (a trace that missed events reads
        # fewer, and its device time is not measured)
        dev = rec["device"]
        check(dev["per_call"] <= 1
              and all("combine" in k for k in dev["by_name"]),
              f"K2 r={r} ({m}, {n}): {dev['per_call']} device operations a "
              f"call, not one launch: {dev['by_name']}")
    return rec


def phase_times_gram(torch, device, clock, a32, mm_aligned, reps):
    """K1's times: the f32 case at 11,999^2 and bf16 at 11,999^2 (rows
    not 16-byte aligned: staged) and at 12,000^2 (as it lies), each beside
    its plain version, one library call and its bound; the bf16 staging
    copy alone."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops, ref

    n = a32.shape[1]
    k1 = {"simt": k1_f32_times(torch, clock, a32, reps, profile=True)}
    gen = torch.Generator(device=device).manual_seed(97)
    for size, tag in ((n, "staged"), (mm_aligned, "zero-copy")):
        bf = a32.to(torch.bfloat16) if size == n else torch.randn(
            (size, size), generator=gen, device=device).to(torch.bfloat16)

        def lib_ok(got, bf=bf):
            want = ref.gram_ref(bf)
            return float((got - want).abs().amax()) <= \
                K1_TOL * float(want.abs().amax())

        # one call computing bf16 A^T A in f32 (bf16 in, f32 out), checked
        # against the plain version first
        lib = library_f32_out(
            torch, clock,
            lambda: torch.mm(bf.mT, bf, out_dtype=torch.float32), lib_ok,
            reps)
        rec = {"ms": clock.ms(lambda: ops.gram(bf), reps, warm=2),
               "plain_ms": clock.ms(lambda: ref.gram_ref(bf), reps),
               "library_ms": lib["ms"], "library": lib,
               "shape": f"A bf16 ({size}, {size}), c = 0, {tag}"}
        if tag == "staged":
            # the copy into rows padded to a multiple of 8 elements, alone
            rec["staging_ms"] = clock.ms(lambda: kmm.stage_bf16(bf), reps,
                                         warm=2)
        rec["bound_ms"], rec["bound_by"] = k1_bound(size, size, 2,
                                                    PEAK_BF16)
        k1["wgmma" if size == n else f"wgmma_{size}"] = rec
        del bf
    for key, rec in k1.items():
        say(f"K1 {key} {rec['shape']}: kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, library {fmt_ms(rec['library_ms'])}"
            f", bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})"
            + (f"; staging copy alone {rec['staging_ms']:.3f} ms"
               if "staging_ms" in rec else "")
            + (f"; S = {rec['slices']}" if "slices" in rec else "")
            + fmt_device(rec))
    return k1


def phase_times(torch, device, clock, tensors, n, attn, mm_aligned):
    from repro_torch.kernels import ops, ref

    say("== phase 4: kernel times")
    # the plain versions and library calls of K1 and K3 are cuBLAS
    # products: they must run in true f32, as the kernels do
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the f32 plain and library times would not be f32")
    a32, t32, coef, mhat = tensors
    reps = 5 if device.type == "cuda" else 2
    recs = {}

    recs["gram"] = phase_times_gram(torch, device, clock, a32, mm_aligned,
                                    reps)

    out = {r: k2_f32_times(torch, clock, a32, t32[:r], coef[:r], mhat, reps,
                           profile=True)
           for r in (1, R)}
    recs["grouped_combine"] = dict(out[R], r1=out[1])

    # K3, one record per route: simt (f32), wgmma (bf16, staged at 11,999
    # and as it lies at 12,000)
    b32 = t32[0]
    zero = torch.zeros((1, 1), device=device)
    k3 = {}

    def k3_bound(size, itemsize, peak):
        flops = 2.0 * size ** 3
        nbytes = 2.0 * itemsize * size * size + 4.0 * size * size
        return (max(flops / peak, nbytes / PEAK_BYTES) * 1e3,
                "operations" if flops / peak > nbytes / PEAK_BYTES
                else "bytes")

    rec = {"ms": clock.ms(lambda: ops.matmul(a32, b32, MM_ALPHA), reps),
           "plain_ms": clock.ms(lambda: ref.matmul_ref(a32, b32, MM_ALPHA),
                                reps),
           # one call computing alpha (A @ B) in f32 (beta = 0 ignores zero)
           "library_ms": clock.ms(lambda: torch.addmm(
               zero, a32, b32, beta=0.0, alpha=MM_ALPHA), reps),
           "library": "torch.addmm(zero, a, b, beta=0, alpha=1.5)",
           "shape": f"A, B f32 ({n}, {n}) @ ({n}, {n}), alpha = {MM_ALPHA}"}
    rec["bound_ms"], rec["bound_by"] = k3_bound(n, 4, PEAK_F32)
    k3["simt"] = rec
    for size, tag in ((n, "staged"), (mm_aligned, "zero-copy")):
        if size == n:
            ab, bb = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
        else:
            gen = torch.Generator(device=device).manual_seed(98)
            ab, bb = (torch.randn((size, size), generator=gen,
                                  device=device).to(torch.bfloat16)
                      for _ in range(2))

        def lib_ok(got, ab=ab, bb=bb):
            want = ref.matmul_ref(ab, bb)
            bound = (ab.shape[1] * torch.finfo(torch.float32).eps
                     * (ab.float().abs() @ bb.float().abs()))
            return bool(((got - want).abs() <= bound).all())

        # one call computing A @ B in f32 from bf16 operands (no alpha: one
        # scalar multiply of C is not what the comparison is about)
        lib = library_f32_out(
            torch, clock,
            lambda: torch.mm(ab, bb, out_dtype=torch.float32), lib_ok, reps)
        rec = {"ms": clock.ms(lambda: ops.matmul(ab, bb, MM_ALPHA), reps,
                              warm=2),
               "plain_ms": clock.ms(
                   lambda: ref.matmul_ref(ab, bb, MM_ALPHA), reps),
               "library_ms": lib["ms"], "library": lib,
               "library_bf16_out_ms": clock.ms(lambda: ab @ bb, reps),
               "shape": f"A, B bf16 ({size}, {size}) @ ({size}, {size}), "
                        f"alpha = {MM_ALPHA}, {tag}"}
        rec["bound_ms"], rec["bound_by"] = k3_bound(size, 2, PEAK_BF16)
        k3["wgmma" if size == n else f"wgmma_{size}"] = rec
        del ab, bb
    for key, rec in k3.items():
        say(f"K3 {key} {rec['shape']}: kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, library {fmt_ms(rec['library_ms'])}, "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    recs["matmul"] = k3

    import torch.nn.functional as F

    b_, s_, h_, d_ = attn["b"], attn["s"], attn["h"], attn["d"]
    gen = torch.Generator(device=device).manual_seed(99)
    # QK^T and PV over the lower triangle, diagonal included
    flops = 2.0 * 2.0 * b_ * h_ * (s_ * (s_ + 1) / 2.0) * d_
    k4 = {}
    for dt, tag, route, peak in (
            (torch.bfloat16, "bf16", "wgmma", PEAK_BF16),
            (torch.float32, "f32", "simt", PEAK_F32)):
        q, k_, v = (torch.randn((b_, s_, h_, d_), generator=gen,
                                device=device).to(dt) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k_, v))
        nbytes = 4.0 * b_ * s_ * h_ * d_ * dt.itemsize
        # the plain version first: after the K3 phase's GEMMs, its 0.1 s of
        # steady load settles the clocks before the 0.3 ms kernel calls
        # (timed first, the bf16 kernel reads slower than when timed later)
        plain_ms = clock.ms(lambda: ref.flash_attention_ref(q, k_, v), reps)
        rec = {"ms": clock.ms(lambda: ops.flash_attention(q, k_, v),
                              4 * reps, warm=20),
               "plain_ms": plain_ms,
               "library_ms": clock.ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True), 4 * reps, warm=20),
               "library": "scaled_dot_product_attention(is_causal=True)",
               "bound_ms": max(flops / peak, nbytes / PEAK_BYTES) * 1e3,
               "bound_by": "operations" if flops / peak > nbytes /
               PEAK_BYTES else "bytes",
               "shape": f"q, k, v {tag} {(b_, s_, h_, d_)}, causal"}
        if route == "wgmma":
            # the same layer stored (b, h, s, d), read through its strides
            qh, kh, vh = (x.contiguous().transpose(1, 2)
                          for x in (qt, kt, vt))
            rec["bhsd_ms"] = clock.ms(
                lambda: ops.flash_attention(qh, kh, vh), 4 * reps, warm=20)
            del qh, kh, vh
        say(f"K4 {route} {tag} {(b_, s_, h_, d_)}: kernel {rec['ms']:.3f} "
            f"ms, plain {rec['plain_ms']:.3f} ms, library (sdpa) "
            f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']})"
            + (f"; (b, h, s, d) layout {rec['bhsd_ms']:.3f} ms"
               if "bhsd_ms" in rec else ""))
        k4[route] = rec
        del q, k_, v, qt, kt, vt
    recs["flash_attention"] = k4
    return recs


def phase_times_muon(torch, device, clock, shapes):
    """Phase 4b: K1 f32 and K2 (r = MUON_R) at ZoloMuon's shapes, in one
    place: each against its plain version, timed beside it, one library
    call and its bound, K1 with its split S, and both with their device
    time per call from ``torch.profiler`` over the same calls (host time
    against device time; K2 one device operation a call)."""
    say("== phase 4b: K1 f32 and K2 at ZoloMuon's shapes, events and "
        "device time")
    out = {f"{m_}x{n_}": muon_kernel_times(torch, device, clock, m_, n_,
                                           MUON_R, "4b", profile=True)
           for m_, n_ in shapes}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def spd_stack(torch, device, b, n, seed=0):
    """b shifted Grams Z_j = G + c_j I of one Gram G = X^T X / n of a
    Gaussian n x n X (c_j from 1e-3 to 1), f32: the shape and conditioning
    (kappa <= ~4e3) of the solver's Cholesky stacks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, n), generator=gen, device=device)
    g = (x.mT @ x) / n
    del x
    c = torch.logspace(-3, 0, max(b, 2), device=device)[:b]
    return g[None] + c[:, None, None] * torch.eye(n, device=device)


def chol_residual(torch, z, l):
    """max over the stack of ||L L^T - Z||_F / ||Z||_F (Z's lower triangle
    mirrored), in f32 products (TF32 off)."""
    zs = torch.tril(z) + torch.tril(z, -1).mT
    r = torch.linalg.matrix_norm(l @ l.mT - zs) / torch.linalg.matrix_norm(zs)
    return float(r.amax())


def chol_residual_f64(torch, z, l):
    """chol_residual with the products in f64, a matrix at a time."""
    out = 0.0
    for i in range(z.shape[0]):
        zs = (torch.tril(z[i]) + torch.tril(z[i], -1).mT).double()
        l64 = l[i].double()
        out = max(out, float(torch.linalg.matrix_norm(l64 @ l64.mT - zs)
                             / torch.linalg.matrix_norm(zs)))
    return out


def cusolver_kernels(torch, fn):
    """{kernel name: device ms} of one call of fn, from torch.profiler;
    None off the card."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key[:100]] = us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12])


def phase_k5(torch, device, clock, n, batch):
    """Phase 4c: K5 against its plain version and cuSOLVER (module
    docstring)."""
    from repro_torch.kernels import cholesky as kchol
    from repro_torch.kernels import ref

    say("== phase 4c: K5, batched blocked Cholesky")
    on_card = device.type == "cuda"
    call = kchol.cholesky_kernel_call if on_card else ref.cholesky_ref
    rec = {"parity": []}
    shapes = K5_PARITY if on_card else ((2, 129), (1, 200))
    for b, m in shapes:
        z = spd_stack(torch, device, b, m, seed=m)
        before = kchol.launches
        l, info = call(z)
        lp, infop = ref.cholesky_ref(z)
        lx, infox = torch.linalg.cholesky_ex(z)
        clock.sync()
        err = float((l - lp).abs().amax() / lp.abs().amax())
        row = {"case": f"({b}, {m}, {m})", "max_rel_err_plain": err,
               "residual": chol_residual(torch, z, l),
               "residual_cholesky_ex": chol_residual(torch, z, lx),
               "launches": kchol.launches - before}
        say(f"K5 {row}")
        check(int(info.abs().sum()) == 0 and int(infop.abs().sum()) == 0
              and int(infox.abs().sum()) == 0, f"K5 {row['case']}: info")
        check(l.stride() == lx.stride(), f"K5 strides {l.stride()}, "
              f"cholesky_ex {lx.stride()}")
        check(bool((torch.triu(l, 1) == 0).all()), "K5 wrote above the "
              "diagonal")
        check(err <= K5_TOL, f"K5 against its plain version {err:.3e}")
        check(row["residual"] <= K5_RESID_FACTOR * row["residual_cholesky_ex"]
              + 1e-6, f"K5 residual {row}")
        check(not on_card or row["launches"] == 1, "K5 launches")
        rec["parity"].append(row)
    # near the identity (the CholeskyQR2 second pass's Gram): products far
    # below the diagonal's ulp, where summing them into the matrix instead
    # of from zero loses them (K5_NEAR_ID)
    if on_card:
        b, m = K5_NEAR_ID
        gen = torch.Generator(device=device).manual_seed(5)
        # off-diagonal entries ~1e-3, each product ~1e-6 of the diagonal
        x = torch.randn((m, m), generator=gen, device=device) * 4e-3
        zn = (torch.eye(m, device=device) + x.mT @ x).expand(b, m, m)
        zn = zn + torch.logspace(-4, -1, b, device=device)[:, None, None] \
            * torch.eye(m, device=device)
        ln, _ = call(zn)
        lnx, _ = torch.linalg.cholesky_ex(zn)
        near = {"case": f"near identity ({b}, {m}, {m})",
                "residual_f64": chol_residual_f64(torch, zn, ln),
                "residual_f64_cholesky_ex": chol_residual_f64(torch, zn,
                                                              lnx)}
        say(f"K5 {near}")
        check(near["residual_f64"] <= K5_RESID_FACTOR *
              near["residual_f64_cholesky_ex"], f"K5 {near}")
        rec["near_identity"] = near
        del x, zn, ln, lnx
    # an indefinite entry: its info names the pivot, the others are intact
    z = spd_stack(torch, device, 3, shapes[-1][1], seed=1)
    z[1, 170, 170] = -1.0
    l, info = call(z)
    _, infox = torch.linalg.cholesky_ex(z)
    rec["indefinite_info"] = info.tolist()
    say(f"K5 info with an indefinite entry {info.tolist()}, cholesky_ex "
        f"{infox.tolist()}")
    check(info.tolist() == [0, 171, 0] == infox.tolist(), "K5 info")
    del z, l, lp, lx, info

    # the dense solve's stacks
    z = spd_stack(torch, device, batch, n, seed=2)
    flops = batch * n ** 3 / 3.0
    nbytes = batch * 8.0 * n * n
    bound = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    reps = 3 if on_card else 1
    before = kchol.launches
    l, info = call(z)
    lx, _ = torch.linalg.cholesky_ex(z)
    full = {"shape": f"({batch}, {n}, {n}) f32", "bound_ms": bound,
            "bound_by": "operations" if flops / PEAK_F32 > nbytes / PEAK_BYTES
            else "bytes",
            "residual": chol_residual(torch, z, l),
            "residual_cholesky_ex": chol_residual(torch, z, lx),
            "info": info.tolist(), "launches": kchol.launches - before}
    del lx
    check(full["residual"] <= K5_RESID_FACTOR * full["residual_cholesky_ex"]
          + 1e-6, f"K5 residual at full size {full}")
    # the plain version, timed once and its L kept for the parity check
    kept = []
    full["plain_ms"] = clock.ms(
        lambda: kept.append(ref.cholesky_ref(z)[0]), 1, warm=0)
    lp = kept.pop()
    full["max_rel_err_plain"] = float((l - lp).abs().amax()
                                      / lp.abs().amax())
    del l, lp
    say(f"K5 at full size against its plain version: "
        f"{full['max_rel_err_plain']:.3e} of max|L|")
    check(full["max_rel_err_plain"] <= K5_TOL, f"K5 against its plain "
          f"version at full size {full['max_rel_err_plain']:.3e}")
    check(not on_card or full["launches"] == 1, "K5 launches")
    full["ms"] = clock.ms(lambda: call(z), reps)
    full["library_ms"] = clock.ms(lambda: torch.linalg.cholesky_ex(z), reps)
    full["library"] = "torch.linalg.cholesky_ex of the stack"
    full["library_singles_ms"] = clock.ms(
        lambda: [torch.linalg.cholesky_ex(z[i]) for i in range(batch)], reps)
    full["tflops"] = flops / full["ms"] / 1e9
    full["roofline_pct"] = 100.0 * bound / full["ms"]
    if on_card:
        # K5's own kernels by device time, the stack and one matrix
        full["device"] = device_ms(torch, lambda: call(z), 1)
        full["device_batch1"] = device_ms(torch, lambda: call(z[:1]), 1)
        full["cusolver_batched_kernels"] = cusolver_kernels(
            torch, lambda: torch.linalg.cholesky_ex(z))
        full["cusolver_single_kernels"] = cusolver_kernels(
            torch, lambda: torch.linalg.cholesky_ex(z[0]))
    say(f"K5 {json.dumps(full)}")
    rec["full"] = full
    del z
    # the sweep beside cholesky_ex (CHOLESKY_MIN_BATCH)
    sweep = []
    for m in (K5_SWEEP_N if on_card else (96, 160)):
        for b in K5_SWEEP_BATCH:
            z = spd_stack(torch, device, b, m, seed=3)
            r_ = min(50, max(3, int(3e11 / (b * m ** 3)))) if on_card \
                else 1
            row = {"n": m, "batch": b,
                   "k5_ms": clock.ms(lambda: call(z), r_),
                   "cholesky_ex_ms": clock.ms(
                       lambda: torch.linalg.cholesky_ex(z), r_)}
            row["k5_faster"] = row["k5_ms"] < row["cholesky_ex_ms"]
            say(f"K5 sweep {row}")
            sweep.append(row)
            del z
    rec["sweep"] = sweep
    rec["min_n"] = kchol.CHOLESKY_MIN_N
    if on_card:
        torch.cuda.empty_cache()
    return rec


def run_solve(torch, clock, p, a, counters):
    """One ``p.svd_info(a)`` (``p.svd(a)`` with its PolarInfo) with every
    launch count set to 0 just before and read just after; returns (u, s,
    vh, seconds, launches, info)."""
    zero_counts(counters)
    clock.sync()
    t0 = time.perf_counter()
    u, s, vh, info = p.svd_info(a)
    clock.sync()
    secs = time.perf_counter() - t0
    return u, s, vh, secs, read_counts(counters), info


def accuracy(torch, a, u, s, vh, s_true):
    """The phase-5 figures: max|s - s_true|/s_max, ||A - U S Vh||_F /
    ||A||_F and the orthogonality of U and Vh, all in f64; raises if any
    exceeds ACCURACY_TOL or the factors are not finite and descending."""
    from repro_torch.core.svd import orthogonality

    n = a.shape[0]
    check(bool(torch.isfinite(u).all() and torch.isfinite(s).all()
               and torch.isfinite(vh).all()), "non-finite factors")
    check(u.shape == (n, n) and s.shape == (n,) and vh.shape == (n, n),
          "factor shapes")
    check(bool((s[:-1] >= s[1:]).all()), "singular values not descending")
    s64 = s.double()
    s_err = float((s64 - s_true).abs().amax()) / float(s_true[0])
    a64 = a.double()
    resid = float(torch.linalg.matrix_norm(
        a64 - (u.double() * s64) @ vh.double()) /
        torch.linalg.matrix_norm(a64))
    del a64
    rec = {"s_err": s_err, "residual": resid,
           "orth_u": float(orthogonality(u.double())),
           "orth_vh": float(orthogonality(vh.double().mT))}
    say(f"max|s - s_true|/s_max {s_err:.3e}; ||A - U S Vh||_F/||A||_F "
        f"{resid:.3e}; orth(U) {rec['orth_u']:.3e}; orth(Vh) "
        f"{rec['orth_vh']:.3e}")
    for name, val in rec.items():
        check(val <= ACCURACY_TOL, f"{name} {val:.3e} > {ACCURACY_TOL:g}")
    return rec


def phase_main(torch, device, clock, n):
    import repro_torch.solver as S
    from repro_torch.configs import svd_paper

    say("== phase 5: main path (linverse through zolo_cuda)")
    counters = kernel_modules()
    t0 = time.perf_counter()
    a, s_true = svd_paper.synthesize("linverse", n=n, dtype=torch.float32,
                                     device=device)
    clock.sync()
    say(f"synthesized linverse ({n}, {n}) kappa {KAPPA:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R)
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    say(repr(p))
    check(len(p.schedule) == 2, f"schedule of {len(p.schedule)} iterations")
    from repro_torch.kernels import cholesky as kchol

    runs = []
    for label in ("warm", "timed"):
        if device.type == "cuda" and label == "timed":
            torch.cuda.reset_peak_memory_stats()
        k5_before = kchol.launches
        u, s, vh, secs, launches, _ = run_solve(torch, clock, p, a,
                                                counters)
        k5 = kchol.launches - k5_before
        say(f"{label} solve: {secs:.3f} s, launches {launches}, K5 {k5}")
        if device.type == "cuda":
            check(k5 == K5_PER_SOLVE, f"K5 launched {k5} times in one "
                  f"solve, expected {K5_PER_SOLVE}")
        if device.type == "cuda":
            for k, v in EXPECT_LAUNCHES.items():
                check(launches[k] == v, f"{k} launched {launches[k]} times "
                      f"in one solve, expected {v}")
        runs.append((secs, launches))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    main = {"n": n, "kappa": KAPPA, "r": R, "iterations": len(p.schedule),
            "warm_s": runs[0][0], "timed_s": runs[1][0],
            "launches_per_solve": runs[1][1], "peak_bytes": peak,
            "k5_launches_per_solve": k5}
    main.update(accuracy(torch, a, u, s, vh, s_true))
    say(f"wall {runs[1][0]:.3f} s; peak memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    s_cuda = s
    del u, vh

    main["stages"] = phase_stages(torch, clock, p, a)
    main["first_pass"] = phase_first_pass(torch, p, a)

    say("== phase 6: plain yardstick (zolo_static)")
    ps = S.plan(cfg.replace(method="zolo_static"), (n, n), torch.float32,
                device=device)
    _, s_plain, _, secs, launches, _ = run_solve(torch, clock, ps, a,
                                                 counters)
    check(all(v == 0 for v in launches.values()),
          f"the plain path launched kernels: {launches}")
    sdiff = float(((s_plain.double() - s_cuda.double()).abs()
                   / float(s_true[0])).amax())
    say(f"zolo_static solve: {secs:.3f} s; max|s_static - s_cuda|/s_max "
        f"{sdiff:.3e}")
    check(sdiff <= ACCURACY_TOL, f"zolo_static vs zolo_cuda {sdiff:.3e}")
    main["plain_s"] = secs
    main["plain_s_diff"] = sdiff
    main["plain_launches"] = launches
    return main, a, s_true, s_cuda


def phase_dynamic(torch, device, clock, a, s_true):
    """Phases 7 and 8: the dynamic path on the same matrix, through the
    kernels and then through the plain ``zolo`` yardstick."""
    import repro_torch.solver as S

    say("== phase 7: dynamic path (linverse through zolo_cuda_dynamic)")
    n = a.shape[0]
    counters = kernel_modules()
    # qr_mode="cholqr2": the CholeskyQR2-first dynamic solve (the f32
    # run-time bound sits below 10 sqrt(eps), where the default "auto"
    # takes the structured Householder first iteration: phase 10)
    cfg = S.SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
                      l0_policy="runtime", r=R, qr_mode="cholqr2")
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    say(repr(p))
    check(p.mode == "dynamic" and p.method == "zolo_cuda_dynamic",
          f"plan resolved to {p!r}")
    runs = []
    for label in ("warm", "timed"):
        if device.type == "cuda" and label == "timed":
            torch.cuda.reset_peak_memory_stats()
        u, s, vh, secs, launches, info = run_solve(torch, clock, p, a,
                                                   counters)
        iters = int(info.iterations)
        rec = {"l_init": float(info.l_init), "iterations": iters,
               "residual": float(info.residual),
               "converged": bool(info.converged),
               "l_final": float(info.l_final)}
        say(f"{label} solve: {secs:.3f} s, launches {launches}, {rec}")
        check(rec["converged"], f"the dynamic solve did not converge: {rec}")
        # K1: 1 + 2r Grams in the CholeskyQR2 iteration, 1 in each
        # Cholesky iteration after it; K2: one combine per iteration
        want = zolo_launch_want(iters, 1 + 2 * R)
        if device.type == "cuda":
            check(launches == want, f"dynamic solve launched {launches}, "
                  f"expected {want} for {iters} iterations")
        runs.append((secs, launches))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    dyn = dict(rec, warm_s=runs[0][0], timed_s=runs[1][0],
               launches_per_solve=runs[1][1], peak_bytes=peak)
    dyn.update(accuracy(torch, a, u, s, vh, s_true))
    say(f"wall {runs[1][0]:.3f} s; peak memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    del u, vh
    dyn["stages"] = phase_dynamic_stages(torch, clock, p, a)

    say("== phase 8: plain yardstick of the dynamic path (zolo)")
    pz = S.plan(cfg.replace(method="zolo"), (n, n), torch.float32,
                device=device)
    _, s_plain, _, secs, launches, info = run_solve(torch, clock, pz, a,
                                                    counters)
    check(all(v == 0 for v in launches.values()),
          f"the plain dynamic path launched kernels: {launches}")
    sdiff = float(((s_plain.double() - s.double()).abs()
                   / float(s_true[0])).amax())
    say(f"zolo solve: {secs:.3f} s, {int(info.iterations)} iterations, "
        f"converged {bool(info.converged)}; max|s_zolo - s_cuda|/s_max "
        f"{sdiff:.3e}")
    check(sdiff <= ACCURACY_TOL, f"zolo vs zolo_cuda_dynamic {sdiff:.3e}")
    dyn.update(plain_s=secs, plain_s_diff=sdiff, plain_launches=launches,
               plain_iterations=int(info.iterations))
    return dyn, s


def bf16_accuracy(torch, u, s, vh, s_ref, what):
    """The phase-9 figures: finite f32 factors, orthogonality of U and Vh
    (f64) within BF16_ORTH_TOL, and the top half of s within BF16_S_RTOL
    relative of ``s_ref`` (the exact spectrum, or another solve's s)."""
    from repro_torch.core.svd import orthogonality

    n = s_ref.shape[0]
    check(bool(torch.isfinite(u).all() and torch.isfinite(s).all()
               and torch.isfinite(vh).all()), f"{what}: non-finite factors")
    check(u.dtype == s.dtype == vh.dtype == torch.float32,
          f"{what}: factors in {u.dtype}, {s.dtype}, {vh.dtype}")
    check(u.shape == (n, n) and s.shape == (n,) and vh.shape == (n, n),
          f"{what}: factor shapes")
    top = slice(0, n // 2)
    s_rel = float(((s[top].double() - s_ref[top].double()).abs()
                   / s_ref[top].double()).amax())
    rec = {"s_top_half_rel": s_rel,
           "orth_u": float(orthogonality(u.double())),
           "orth_vh": float(orthogonality(vh.double().mT))}
    say(f"{what}: top-half max|s - s_ref|/s_ref {s_rel:.3e} (limit "
        f"{BF16_S_RTOL:g}); orth(U) {rec['orth_u']:.3e}, orth(Vh) "
        f"{rec['orth_vh']:.3e} (limit {BF16_ORTH_TOL:g})")
    check(s_rel <= BF16_S_RTOL, f"{what}: top-half s error {s_rel:.3e}")
    for name in ("orth_u", "orth_vh"):
        check(rec[name] <= BF16_ORTH_TOL, f"{what}: {name} {rec[name]:.3e}")
    return rec


def phase_bf16(torch, device, clock, a, s_true):
    """Phase 9: the f32 linverse matrix solved through a bf16 compute plan
    (``compute_dtype="bfloat16"``: bf16 iterates, K1 on bf16 operands,
    f32 factors back), then the same plan on the plain ``zolo_static``."""
    import repro_torch.solver as S

    say("== phase 9: bf16 compute plan (linverse through zolo_cuda, "
        "compute_dtype=bfloat16)")
    n = a.shape[0]
    counters = kernel_modules()
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R,
                      compute_dtype="bfloat16")
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    say(repr(p))
    check(p.compute_dtype == torch.bfloat16 and len(p.schedule) == 2,
          f"plan resolved to {p!r}, {len(p.schedule)} iterations")
    from repro_torch.kernels import cholesky as kchol

    runs = []
    for label in ("warm", "timed"):
        if device.type == "cuda" and label == "timed":
            torch.cuda.reset_peak_memory_stats()
        k5_before = kchol.launches
        u, s, vh, secs, launches, _ = run_solve(torch, clock, p, a,
                                                counters)
        k5 = kchol.launches - k5_before
        say(f"{label} solve: {secs:.3f} s, launches {launches}, K5 {k5}")
        if device.type == "cuda":
            check(k5 == K5_PER_SOLVE, f"K5 launched {k5} times in one "
                  f"solve, expected {K5_PER_SOLVE}")
        if device.type == "cuda":
            check(launches == EXPECT_BF16_LAUNCHES, f"the bf16 compute "
                  f"solve launched {launches}, expected "
                  f"{EXPECT_BF16_LAUNCHES}")
        runs.append((secs, launches))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    rec = {"n": n, "kappa": KAPPA, "r": R, "compute_dtype": "bfloat16",
           "warm_s": runs[0][0], "timed_s": runs[1][0],
           "launches_per_solve": runs[1][1], "peak_bytes": peak}
    say(f"wall {runs[1][0]:.3f} s; peak memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    rec.update(bf16_accuracy(torch, u, s, vh, s_true.to(s.device),
                             "bf16 compute solve"))
    del u, vh
    rec["stages"] = phase_stages(torch, clock, p, a)

    say("== phase 9b: plain yardstick of the bf16 compute plan "
        "(zolo_static)")
    ps = S.plan(cfg.replace(method="zolo_static"), (n, n), torch.float32,
                device=device)
    u, s_plain, vh, secs, launches, _ = run_solve(torch, clock, ps, a,
                                                  counters)
    check(all(v == 0 for v in launches.values()),
          f"the plain bf16 compute path launched kernels: {launches}")
    say(f"zolo_static bf16 compute solve: {secs:.3f} s")
    rec["plain_s"] = secs
    rec["plain"] = bf16_accuracy(torch, u, s_plain, vh, s,
                                 "zolo_static against zolo_cuda (bf16)")
    del u, vh

    say("== phase 9c: the bf16 compute plan with the default method")
    pa = S.plan(cfg.replace(method="auto", r=None), (n, n), torch.float32,
                device=device)
    say(repr(pa))
    u, s_auto, vh, secs, launches, info = run_solve(torch, clock, pa, a,
                                                    counters)
    say(f"{pa.method} bf16 compute solve: {secs:.3f} s, "
        f"{int(info.iterations)} iterations, launches {launches}")
    rec["auto"] = {"method": pa.method, "timed_s": secs,
                   "iterations": int(info.iterations),
                   "launches_per_solve": launches}
    rec["auto"].update(bf16_accuracy(torch, u, s_auto, vh,
                                     s_true.to(s.device),
                                     f"{pa.method} (bf16 compute)"))
    return rec


class TermCounter:
    """Counts the calls of the engines' first-iteration terms and QDWH's
    two iteration forms while it is entered (the module attributes are
    wrapped, and restored on exit), and times the structured Householder
    term inside the solve: ``seconds`` holds its synchronised wall time,
    all of the dynamic solve's first iteration but its K2 combine."""

    TIMED = ("term_sum_householder",)

    TARGETS = (("repro_torch.core.zolo", "term_sum_householder"),
               ("repro_torch.core.zolo", "term_sum_cholqr2"),
               ("repro_torch.core.qdwh", "_qdwh_qr_iter"),
               ("repro_torch.core.qdwh", "_qdwh_chol_iter"))

    def __init__(self, clock):
        self.clock = clock

    def __enter__(self):
        import importlib

        self.counts = {name: 0 for _, name in self.TARGETS}
        self.seconds = {name: 0.0 for name in self.TIMED}
        self.saved = []
        for modname, name in self.TARGETS:
            mod = importlib.import_module(modname)
            real = getattr(mod, name)

            def counted(*args, _real=real, _name=name, **kw):
                self.counts[_name] += 1
                if _name not in self.seconds:
                    return _real(*args, **kw)
                self.clock.sync()
                t0 = time.perf_counter()
                out = _real(*args, **kw)
                self.clock.sync()
                self.seconds[_name] += time.perf_counter() - t0
                return out

            self.saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False


def first_branch(counts):
    """The dynamic Zolo solve's first-iteration term, from its counts."""
    if counts["term_sum_householder"]:
        return "householder"
    return "cholqr2" if counts["term_sum_cholqr2"] else "chol"


def zolo_launch_want(iters, qr_grams):
    """K1/K2 launches of one Zolo solve on the f32 route: ``qr_grams`` K1
    launches in the QR-form first iteration (CholeskyQR2: 1 + 2r; the
    structured Householder QR: 0), one per Cholesky iteration after it,
    and one K2 combine per iteration."""
    want = {"gram": qr_grams + (iters - 1), "grouped_combine": iters,
            "matmul": 0, "flash_attention": 0}
    want.update({f"{k}/{r}": 0 for k in ROUTED for r in ROUTES})
    want["gram/simt"] = want["gram"]
    return want


def timed_solves(torch, device, clock, p, a, counters, labels=("warm",
                                                                "timed")):
    """``run_solve`` once per label (peak memory reset before the last);
    returns the last solve's (u, s, vh, info), its launches, its
    ``TermCounter``, the seconds of each run and the peak memory."""
    secs = []
    for label in labels:
        if device.type == "cuda" and label == labels[-1]:
            torch.cuda.reset_peak_memory_stats()
        with TermCounter(clock) as tc:
            u, s, vh, t, launches, info = run_solve(torch, clock, p, a,
                                                    counters)
        say(f"{label} solve: {t:.3f} s, launches {launches}, terms "
            f"{tc.counts}")
        secs.append(t)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    return (u, s, vh, info), launches, tc, secs, peak


def info_record(info):
    return {"l_init": float(info.l_init),
            "iterations": int(info.iterations),
            "residual": float(info.residual),
            "converged": bool(info.converged),
            "l_final": float(info.l_final)}


def s_diff(torch, s, s_ref, s_true):
    return float(((s.double() - s_ref.double()).abs()
                  / float(s_true[0])).amax())


def phase_dynamic_default(torch, device, clock, a, s_true, s_qr2):
    """Phases 10 and 10b: the default dynamic config (no qr_mode) through
    the kernels, which takes the structured Householder first iteration
    on an f32 run-time bound, and its plain yardstick ``zolo``."""
    import repro_torch.solver as S

    say("== phase 10: the dynamic default (linverse through "
        "zolo_cuda_dynamic, qr_mode unset)")
    n = a.shape[0]
    counters = kernel_modules()
    cfg = S.SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
                      l0_policy="runtime", r=R)
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    say(repr(p))
    check("first_mode" not in p._backend_kwargs,
          f"the default plan binds {p._backend_kwargs}")
    # one solve: phase 7 warmed the dynamic path at this shape
    (u, s, vh, info), launches, tc, secs, peak = timed_solves(
        torch, device, clock, p, a, counters, labels=("timed",))
    terms = tc.counts
    rec = info_record(info)
    rec["first_branch"] = first_branch(terms)
    rec["householder_term_s"] = tc.seconds["term_sum_householder"]
    say(f"l_init {rec['l_init']:.4e} (10 sqrt(eps) = "
        f"{10 * torch.finfo(torch.float32).eps ** 0.5:.4e}); first "
        f"iteration: {rec['first_branch']}; {rec['iterations']} "
        f"iterations, residual {rec['residual']:.3e}, converged "
        f"{rec['converged']}; K1 {launches['gram']} (simt "
        f"{launches['gram/simt']}, wgmma {launches['gram/wgmma']}), K2 "
        f"{launches['grouped_combine']}")
    check(rec["first_branch"] == "householder" and
          terms["term_sum_householder"] == 1,
          f"the default dynamic solve's first iteration: {terms}")
    check(rec["converged"], f"the dynamic default did not converge: {rec}")
    want = zolo_launch_want(rec["iterations"], 0)
    if device.type == "cuda":
        check(launches == want, f"dynamic default launched {launches}, "
              f"expected {want}")
        check(launches["gram/simt"] > 0 and launches["grouped_combine"] > 0,
              "the dynamic default launched no K1 or K2")
    rec.update(timed_s=secs[0], launches_per_solve=launches,
               peak_bytes=peak)
    rec.update(accuracy(torch, a, u, s, vh, s_true))
    rec["s_diff_phase7"] = s_diff(torch, s, s_qr2, s_true)
    say(f"wall {secs[0]:.3f} s, of which the first iteration's "
        f"structured Householder term ({R} terms, its K2 combine apart) "
        f"{rec['householder_term_s']:.3f} s; peak memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}"
        f"; max|s - s_phase7|/s_max {rec['s_diff_phase7']:.3e}")
    check(rec["s_diff_phase7"] <= ACCURACY_TOL,
          f"dynamic default vs phase 7 {rec['s_diff_phase7']:.3e}")
    del u, vh

    say("== phase 10b: plain yardstick of the dynamic default (zolo)")
    pz = S.plan(cfg.replace(method="zolo"), (n, n), torch.float32,
                device=device)
    (_, s_plain, _, info), launches, tc, secs, _ = timed_solves(
        torch, device, clock, pz, a, counters, labels=("timed",))
    terms = tc.counts
    check(all(v == 0 for v in launches.values()),
          f"the plain dynamic path launched kernels: {launches}")
    check(first_branch(terms) == "householder",
          f"zolo's first iteration: {terms}")
    sdiff = s_diff(torch, s_plain, s, s_true)
    say(f"zolo solve: {secs[0]:.3f} s, {int(info.iterations)} iterations, "
        f"converged {bool(info.converged)}; max|s_zolo - s_cuda|/s_max "
        f"{sdiff:.3e}")
    check(bool(info.converged) and sdiff <= ACCURACY_TOL,
          f"zolo vs zolo_cuda_dynamic {sdiff:.3e}")
    rec.update(plain_s=secs[0], plain_s_diff=sdiff,
               plain_iterations=int(info.iterations))
    return rec


def phase_householder_static(torch, device, clock, a, s_true):
    """Phase 11: the static schedule with a structured Householder first
    iteration on ``zolo_cuda``."""
    import repro_torch.solver as S

    say("== phase 11: static Householder (linverse through zolo_cuda, "
        "qr_mode=householder)")
    n = a.shape[0]
    counters = kernel_modules()
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R,
                      qr_mode="householder")
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    say(repr(p))
    iters = len(p.schedule)
    # one solve: phase 5 warmed the static path at this shape
    (u, s, vh, _), launches, tc, secs, peak = timed_solves(
        torch, device, clock, p, a, counters, labels=("timed",))
    terms = tc.counts
    check(terms["term_sum_householder"] == 1 and
          terms["term_sum_cholqr2"] == 0, f"static terms {terms}")
    want = zolo_launch_want(iters, 0)
    say(f"{iters} iterations; K1 {launches['gram']} (simt "
        f"{launches['gram/simt']}), K2 {launches['grouped_combine']}; wall "
        f"{secs[0]:.3f} s; peak memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    if device.type == "cuda":
        check(launches == want, f"static Householder solve launched "
              f"{launches}, expected {want}")
    rec = {"iterations": iters, "timed_s": secs[0],
           "launches_per_solve": launches, "peak_bytes": peak}
    rec.update(accuracy(torch, a, u, s, vh, s_true))
    del u, vh
    rec["stages"] = phase_stages(torch, clock, p, a)
    return rec


def phase_qdwh(torch, device, clock, a, s_true, zolo_s):
    """Phase 12: the paper's baseline, QDWH-PD, through ``qdwh_static``
    (the plan's schedule) and ``qdwh`` (run-time bound), beside the Zolo
    solves of phases 5 and 7."""
    import repro_torch.solver as S

    say("== phase 12: QDWH (linverse through qdwh_static and qdwh)")
    n = a.shape[0]
    counters = kernel_modules()
    out = {}
    for name, cfg in (
            ("qdwh_static", S.SvdConfig(method="qdwh_static", kappa=KAPPA,
                                        l0_policy="estimate_at_plan")),
            ("qdwh", S.SvdConfig(method="qdwh", mode="dynamic",
                                 l0_policy="runtime"))):
        p = S.plan(cfg, (n, n), torch.float32, device=device)
        say(repr(p))
        (u, s, vh, info), launches, tc, secs, peak = timed_solves(
            torch, device, clock, p, a, counters, labels=("timed",))
        terms = tc.counts
        check(all(v == 0 for v in launches.values()),
              f"{name} launched kernels: {launches}")
        rec = info_record(info)
        rec.update(qr_iterations=terms["_qdwh_qr_iter"],
                   chol_iterations=terms["_qdwh_chol_iter"],
                   timed_s=secs[0], peak_bytes=peak)
        check(rec["qr_iterations"] + rec["chol_iterations"]
              == rec["iterations"], f"{name}: {terms} vs {rec}")
        if name == "qdwh":
            check(rec["converged"], f"qdwh did not converge: {rec}")
        say(f"{name}: {rec['iterations']} iterations ({rec['qr_iterations']}"
            f" QR, {rec['chol_iterations']} Cholesky), l_init "
            f"{rec['l_init']:.4e}, residual {rec['residual']:.3e}, "
            f"converged {rec['converged']}; wall {secs[0]:.3f} s against "
            f"Zolo's {zolo_s[name]:.3f} s (same matrix, "
            f"{'phase 5' if name == 'qdwh_static' else 'phase 7'}); peak "
            f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
        rec.update(accuracy(torch, a, u, s, vh, s_true))
        del u, vh
        rec["stages"] = phase_stages(torch, clock, p, a)
        rec["zolo_s"] = zolo_s[name]
        out[name] = rec
    return out


class EighCalls:
    """Counts ``torch.linalg.eigh`` calls while entered.  A block-Jacobi
    round makes one (batched) call, so the sweeps a solve ran are the
    calls over the rounds per sweep, ``jacobi_rounds(n)``."""

    def __init__(self, torch):
        self.linalg = torch.linalg

    def __enter__(self):
        self.calls, self.real = 0, self.linalg.eigh

        def counted(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)

        self.linalg.eigh = counted
        return self

    def __exit__(self, *exc):
        self.linalg.eigh = self.real
        return False


def jacobi_rounds(n, nb=32):
    """Rounds per block-Jacobi sweep: the block count (padded to even)
    less one."""
    b = -(-n // nb)
    return b + b % 2 - 1


def jacobi_sweeps(calls, n, what):
    """The sweeps behind ``calls`` eigh calls, checked below the cap: a
    solve that reaches the cap stops unconverged without a signal."""
    from repro_torch.core import eig

    sweeps, rest = divmod(calls, jacobi_rounds(n))
    check(rest == 0, f"{what}: {calls} eigh calls for "
          f"{jacobi_rounds(n)} rounds a sweep")
    check(sweeps < eig.MAX_SWEEPS, f"{what} ran into the sweep cap "
          f"({sweeps} of {eig.MAX_SWEEPS})")
    return sweeps


def phase_baselines(torch, device, clock, n):
    """Phase 13: the direct baselines on the linverse spectrum at a
    reduced n: scaled Newton, ``zolo_cuda`` with the block-Jacobi
    eigensolver, and the one-sided block-Jacobi SVD; the block-Jacobi
    sweeps each took (counted) are held below the cap."""
    import repro_torch.solver as S
    from repro_torch.configs import svd_paper
    from repro_torch.core import svd as tsvd

    say(f"== phase 13: direct baselines at n = {n} (newton, eig "
        f"jacobi, jacobi_svd)")
    counters = kernel_modules()
    a, s_true = svd_paper.synthesize("linverse", n=n, dtype=torch.float32,
                                     device=device)
    out = {}
    for name, cfg in (
            ("newton", S.SvdConfig(method="newton")),
            ("zolo_cuda+jacobi", S.SvdConfig(
                method="zolo_cuda", kappa=KAPPA,
                l0_policy="estimate_at_plan", r=R, eig_method="jacobi"))):
        p = S.plan(cfg, (n, n), torch.float32, device=device)
        say(repr(p))
        # one solve each: the earlier phases warmed cuBLAS and cuSOLVER,
        # and a block-Jacobi solve takes tens of seconds at this n
        with EighCalls(torch) as ec:
            (u, s, vh, info), launches, _, secs, _ = timed_solves(
                torch, device, clock, p, a, counters, labels=("timed",))
        if device.type == "cuda":
            want = (EXPECT_LAUNCHES if name.startswith("zolo") else
                    {k: 0 for k in launches})
            check(launches == want, f"{name} launched {launches}, "
                  f"expected {want}")
        rec = dict(info_record(info), timed_s=secs[0],
                   launches_per_solve=launches)
        if name.endswith("jacobi"):
            rec["eig_sweeps"] = jacobi_sweeps(ec.calls, n, name)
        say(f"{name}: {rec['iterations']} iterations, converged "
            f"{rec['converged']}, residual {rec['residual']:.3e}; wall "
            f"{secs[0]:.3f} s"
            + (f"; block-Jacobi eig {rec['eig_sweeps']} sweeps"
               if "eig_sweeps" in rec else ""))
        # Newton keeps the reference's stop, ||X+ - X||_F / ||X+||_F <=
        # 10 eps, which f32 iterates do not reach at this n (the
        # residual floors near 1e-5): it runs its 30 iterations and is
        # held to the accuracy limits below, as every solve here
        if name != "newton":
            check(rec["converged"], f"{name} did not converge: {rec}")
        rec.update(accuracy(torch, a, u, s, vh, s_true))
        del u, vh
        rec["stages"] = phase_stages(torch, clock, p, a)
        out[name] = rec
    clock.sync()
    t0 = time.perf_counter()
    with EighCalls(torch) as ec:
        u, s, vh = tsvd.jacobi_svd(a, nb=32)
    clock.sync()
    rec = {"timed_s": time.perf_counter() - t0,
           "sweeps": jacobi_sweeps(ec.calls, n, "jacobi_svd")}
    say(f"jacobi_svd: {rec['timed_s']:.3f} s, {rec['sweeps']} sweeps")
    rec.update(accuracy(torch, a, u, s, vh, s_true))
    out["jacobi_svd"] = rec
    return out


class RungProbe:
    """Reads each escalation rung's kernel launches and wall time while
    it is entered.  The ladder judges every rung that planned right after
    its solve, through ``repro_torch.resilience.health.judge_plan``; that
    module attribute is wrapped (and restored on exit) to synchronise,
    read the counts and the clock, and zero the counts for the next
    rung.  A rung that could not plan is not judged: its (plan-time only)
    seconds fall to the next rung."""

    def __init__(self, clock, counters):
        self.clock, self.counters = clock, counters

    def __enter__(self):
        from repro_torch.resilience import health

        self.mod, self.real = health, health.judge_plan
        self.rungs = []
        zero_counts(self.counters)
        self.clock.sync()
        self.t0 = time.perf_counter()

        def judged(plan, h, **kw):
            self.clock.sync()
            secs = time.perf_counter() - self.t0
            launches = read_counts(self.counters)
            verdict = self.real(plan, h, **kw)
            self.rungs.append({"method": plan.method, "seconds": secs,
                               "launches": launches})
            zero_counts(self.counters)
            self.clock.sync()
            self.t0 = time.perf_counter()
            return verdict

        health.judge_plan = judged
        return self

    def __exit__(self, *exc):
        self.mod.judge_plan = self.real
        return False


def trail_record(trail, rungs):
    """One record per rung of an escalation trail, with the launches and
    seconds ``RungProbe`` read for each judged rung."""
    out, judged = [], iter(rungs)
    for t in trail:
        rec = {"rung": t.rung, "reason": t.reason, "outcome": t.outcome,
               "method": t.config.method, "error": t.error}
        if t.verdict is not None:
            probe = next(judged)
            rec.update(method=probe["method"], seconds=probe["seconds"],
                       launches=probe["launches"],
                       reasons=list(t.verdict.reasons),
                       orth=t.verdict.orth, kappa_est=t.verdict.kappa_est,
                       kappa_max=t.verdict.kappa_max)
        out.append(rec)
        say(f"  rung {rec['rung']} [{rec['reason']}] {rec['method']}: "
            f"{rec['outcome']}"
            + (f", {rec['seconds']:.3f} s, K1 {rec['launches']['gram']} "
               f"K2 {rec['launches']['grouped_combine']}, kappa_est "
               f"{rec['kappa_est']:.4g} (envelope {rec['kappa_max']}), "
               f"orth {rec['orth']:.3e}, reasons {rec['reasons']}"
               if "seconds" in rec else f" ({rec['error']})"))
    return out


def sum_launches(records):
    total = {}
    for rec in records:
        for k, v in rec.get("launches", {}).items():
            total[k] = total.get(k, 0) + v
    return total


def check_rung_kernels(device, rungs):
    """A rung on a kernel backend launched K1 and K2; a rung on a plain
    one launched nothing (no kernel path silently ran plain ops)."""
    if device.type != "cuda":
        return
    for rec in rungs:
        if "launches" not in rec:
            continue
        if rec["method"].startswith("zolo_cuda"):
            check(rec["launches"]["gram"] > 0 and
                  rec["launches"]["grouped_combine"] > 0,
                  f"kernel rung launched no K1/K2: {rec}")
        else:
            check(all(v == 0 for v in rec["launches"].values()),
                  f"plain rung launched kernels: {rec}")


def phase_resilience(torch, device, clock, a, s_true, main_rec, batch_n):
    """Phase 14: the verified solve, the escalation ladder on an injected
    fault and on the dynamic default, and a batched verified solve with
    one poisoned entry."""
    import repro_torch.resilience as RES
    import repro_torch.solver as S
    from repro_torch.configs import svd_paper
    from repro_torch.core import registry
    from repro_torch.core.zolo_cuda import cuda_zolo_ops

    n = a.shape[0]
    counters = kernel_modules()
    out = {}
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R)

    say("== phase 14a: svd_verified on the phase-5 plan")
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    zero_counts(counters)
    clock.sync()
    t0 = time.perf_counter()
    u, s, vh, health = p.svd_verified(a)
    clock.sync()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    verdict = RES.judge_plan(p, health)
    # the health check alone (the Gram of U and three reductions; the
    # PolarInfo scalars it also reads cost nothing)
    health_ms = clock.ms(lambda: RES.solve_health(u, s, vh), reps=3)
    rec = {"seconds": secs, "svd_seconds_phase5": main_rec["timed_s"],
           "health_ms": health_ms, "launches_per_solve": launches,
           "verdict": str(verdict), "orth": verdict.orth,
           "orth_tol": verdict.orth_tol, "kappa_est": verdict.kappa_est,
           "kappa_max": verdict.kappa_max}
    say(f"svd_verified: {secs:.3f} s (phase 5 svd {main_rec['timed_s']:.3f}"
        f" s); solve_health alone {health_ms:.2f} ms; launches {launches}; "
        f"{verdict}; kappa_est {verdict.kappa_est:.4g} (envelope "
        f"{verdict.kappa_max})")
    check(verdict.ok, f"the phase-5 solve judged unhealthy: {verdict}")
    if device.type == "cuda":
        for k, v in EXPECT_LAUNCHES.items():
            check(launches[k] == v, f"{k} launched {launches[k]} times in "
                  f"the verified solve, expected {v}")
    rec["s_err"] = float((s.double() - s_true).abs().amax()) / float(
        s_true[0])
    check(rec["s_err"] <= ACCURACY_TOL, f"verified s error {rec['s_err']}")
    del u, vh
    with RungProbe(clock, counters) as probe:
        _, s, _, trail = RES.solve_with_escalation(a, cfg)
    rec["ladder"] = trail_record(trail, probe.rungs)
    check([t.outcome for t in trail] == ["passed"],
          f"the phase-5 config climbed the ladder: {rec['ladder']}")
    check_rung_kernels(device, rec["ladder"])
    out["verified"] = rec

    say("== phase 14b: escalation from an injected NaN (zolo_static on "
        "the kernel bundle)")
    cfg_b = S.SvdConfig(method="zolo_static", qr_mode="cholqr2",
                        kappa=KAPPA, l0_policy="estimate_at_plan", r=R,
                        extra=(("ops", RES.faulty_ops(cuda_zolo_ops(),
                                                    nan_at_iter=0)),))
    with RungProbe(clock, counters) as probe:
        u, s, vh, trail = RES.solve_with_escalation(a, cfg_b)
    rungs = trail_record(trail, probe.rungs)
    check([t.outcome for t in trail] == ["failed", "passed"],
          f"14b trail {rungs}")
    check("non-finite factors" in trail[0].verdict.reasons,
          f"14b rung 0 reasons {trail[0].verdict.reasons}")
    check(trail[1].config.qr_mode == "householder",
          f"14b rung 1 {trail[1].reason}")
    if device.type == "cuda":
        want = [(EXPECT_LAUNCHES["gram"], 2), (1, 2)]
        got = [(r["launches"]["gram"], r["launches"]["grouped_combine"])
               for r in rungs]
        check(got == want, f"14b K1/K2 per rung {got}, expected {want}")
    acc = accuracy(torch, a, u, s, vh, s_true)
    out["nan_fault"] = {"trail": rungs, **acc}
    del u, vh

    say("== phase 14c: escalation on the dynamic default "
        "(zolo_cuda_dynamic, qr_mode unset)")
    cfg_c = S.SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
                        l0_policy="runtime", r=R)
    with RungProbe(clock, counters) as probe:
        u, s, vh, trail = RES.solve_with_escalation(a, cfg_c)
    rungs = trail_record(trail, probe.rungs)
    envelope = registry.envelope_kappa_max(
        registry.get_polar("zolo_cuda_dynamic"), torch.float32)
    v0 = trail[0].verdict
    beyond = v0.kappa_est > envelope
    check(beyond == any("envelope" in r for r in v0.reasons),
          f"14c rung 0: kappa_est {v0.kappa_est:.4g} vs envelope "
          f"{envelope:.4g}, reasons {v0.reasons}")
    check(trail[-1].outcome == "passed", f"14c trail {rungs}")
    check_rung_kernels(device, rungs)
    acc = accuracy(torch, a, u, s, vh, s_true)
    out["dynamic_default"] = {"trail": rungs, "envelope": envelope,
                              "rung0_beyond_envelope": beyond,
                              "seconds": sum(r.get("seconds", 0.0)
                                             for r in rungs), **acc}
    say(f"14c: {len(trail)} rung(s), {out['dynamic_default']['seconds']:.3f}"
        f" s in all; rung 0 kappa_est {v0.kappa_est:.4g} "
        f"{'>' if beyond else '<='} envelope {envelope:.4g}")
    del u, vh

    say(f"== phase 14d: svd_batched_verified on (4, {batch_n}, {batch_n}), "
        f"entry 2 NaN")
    mats = torch.stack([svd_paper.synthesize(
        "linverse", n=batch_n, dtype=torch.float32, device=device,
        seed=i)[0] for i in range(4)])
    mats[2] = float("nan")
    pb = S.plan(cfg, (batch_n, batch_n), torch.float32, device=device)
    zero_counts(counters)
    clock.sync()
    t0 = time.perf_counter()
    _, s, _, health = pb.svd_batched_verified(mats)
    clock.sync()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    oks = [RES.judge_plan(pb, RES.SolveHealth(*(t[i] for t in health))).ok
           for i in range(4)]
    say(f"batched verified: {secs:.3f} s, launches {launches}, verdicts "
        f"{oks}")
    check(oks == [True, True, False, True], f"14d verdicts {oks}")
    check(all(tuple(t.shape) == (4,) for t in health),
          "14d health leaves lack the batch axis")
    if device.type == "cuda":
        check(launches["gram"] == 4 * EXPECT_LAUNCHES["gram"] and
              launches["grouped_combine"] == 4 * 2,
              f"14d launched {launches}")
    out["batched"] = {"seconds": secs, "launches_per_solve": launches,
                      "verdicts": oks}
    del mats
    return out


def polar_quality(torch, a, q):
    """(finite, orth(Q), ||A - Q H||_F / ||A||_F) in f64, with H the
    symmetric part of Q^T A (the best H for this Q)."""
    from repro_torch.core.svd import orthogonality

    finite = bool(torch.isfinite(q).all())
    q64, a64 = q.double(), a.double()
    qa = q64.mT @ a64
    h = 0.5 * (qa + qa.mT)
    del qa
    back = float(torch.linalg.matrix_norm(a64 - q64 @ h)
                 / torch.linalg.matrix_norm(a64))
    return finite, float(orthogonality(q64)), back


def dynamic_kappa_est(torch, x):
    """1/l_init of the dynamic engine on ``x`` (its bounds: alpha =
    sigma_max_upper, l = sigma_min_lower_qr(X / alpha) clamped to
    [4 eps, 1 - eps] in the accumulation precision)."""
    from repro_torch.core import norms

    eps = torch.finfo(torch.float32).eps
    x0 = x / norms.sigma_max_upper(x).to(x.dtype)
    l0 = torch.clamp(norms.sigma_min_lower_qr(x0), 4 * eps, 1.0 - eps)
    return float(1.0 / l0)


def phase_envelope(torch, device, clock, n):
    """Phase 15: the kernels' conditioning envelope at full width.  The
    linverse synthesizer's singular vectors with a geometric spectrum
    from 1 to 1/kappa; the polar stage alone, through ``zolo_pd_cuda``
    with l0 = 1/kappa and r = choose_r(kappa) (what a plan at that hint
    binds; the plan-time cap would refuse most of these kappa)."""
    from repro_torch.configs import svd_paper
    from repro_torch.core.coeffs import choose_r
    from repro_torch.core.zolo_cuda import zolo_pd_cuda

    say(f"== phase 15: kappa envelope of zolo_cuda at n = {n}")
    counters = kernel_modules()
    rows = []
    total = {}
    for dtype, kappas, orth_tol, back_tol in (
            (torch.float32, ENVELOPE_F32, ACCURACY_TOL, ACCURACY_TOL),
            (torch.bfloat16, ENVELOPE_BF16, BF16_ORTH_TOL, None)):
        for kappa in kappas:
            a, _ = svd_paper.synthesize("linverse", n=n, dtype=torch.float32,
                                        device=device, cond=kappa)
            x = a.to(dtype)
            r = choose_r(kappa)
            zero_counts(counters)
            clock.sync()
            t0 = time.perf_counter()
            q, _, info = zolo_pd_cuda(x, l0=1.0 / kappa, r=r)
            clock.sync()
            secs = time.perf_counter() - t0
            launches = read_counts(counters)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            finite, orth, back = polar_quality(torch, a, q)
            ok = finite and orth <= orth_tol and (back_tol is None
                                                  or back <= back_tol)
            row = {"dtype": str(dtype).split(".")[-1], "kappa": kappa,
                   "r": r, "iterations": int(info.iterations),
                   "seconds": secs, "finite": finite, "orth": orth,
                   "backward": back,
                   "kappa_est": dynamic_kappa_est(torch, x), "ok": ok,
                   "K1": launches["gram"], "K2": launches["grouped_combine"],
                   "K1_wgmma": launches["gram/wgmma"]}
            rows.append(row)
            say(f"{row['dtype']} kappa {kappa:g} (r={r}, "
                f"{row['iterations']} it): {secs:.3f} s, finite {finite}, "
                f"orth {orth:.3e}, ||A-QH||/||A|| {back:.3e}, dynamic "
                f"kappa_est {row['kappa_est']:.4g}, K1 {row['K1']} "
                f"(wgmma {row['K1_wgmma']}) K2 {row['K2']} -> "
                f"{'within' if ok else 'beyond'} the limits")
            if device.type == "cuda":
                check(row["K1"] > 0 and row["K2"] > 0,
                      f"the sweep launched no K1/K2: {row}")
            del a, x, q
    envelope = {}
    for name in ("float32", "bfloat16"):
        pts = [r for r in rows if r["dtype"] == name]
        passing = []
        for r in pts:  # the largest kappa below the first failure
            if not r["ok"]:
                break
            passing.append(r["kappa"])
        envelope[name] = passing[-1] if passing else None
    say(f"measured envelope (largest kappa within the limits, all smaller "
        f"ones within too): {envelope}")
    return {"rows": rows, "envelope": envelope, "launches": total}


def topk_error(torch, s, s_true, k):
    return float((s.double() - s_true[:k]).abs().amax()) / float(s_true[0])


def phase_topk(torch, device, clock, a, s_true, k, dnc_n):
    """Phase 16: the partial-spectrum frontend on the linverse matrix:
    sketch, dense, auto, adaptive, d&c (at a reduced n) and
    lowrank_truncate."""
    import repro_torch.solver as S
    import repro_torch.spectral as SP
    from repro_torch.configs import svd_paper
    from repro_torch.optim import lowrank_truncate

    n = a.shape[0]
    counters = kernel_modules()
    svd = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R)
    base = SP.TopKConfig(k=k, strategy="sketch", tol=1e-5, kappa=KAPPA,
                         svd=svd)
    out = {}

    def run(label, plan, fn):
        zero_counts(counters)
        clock.sync()
        t0 = time.perf_counter()
        res = fn()
        clock.sync()
        secs = time.perf_counter() - t0
        launches = read_counts(counters)
        u, s, vh = res[:3]
        check(bool(torch.isfinite(u).all() and torch.isfinite(s).all()
                   and torch.isfinite(vh).all()), f"16 {label} not finite")
        check(tuple(u.shape) == (n, k) and tuple(vh.shape) == (k, n),
              f"16 {label} shapes {tuple(u.shape)} {tuple(vh.shape)}")
        rec = {"strategy": plan.strategy, "l": plan.l,
               "q_iters": plan.q_iters,
               "decision": {key: v for key, v in plan.decision.items()},
               "seconds": secs, "launches": launches,
               "s_err": topk_error(torch, s, s_true, k)}
        say(f"{label}: {plan!r}; {secs:.3f} s, launches K1 "
            f"{launches['gram']} K2 {launches['grouped_combine']}; top-{k} "
            f"s error {rec['s_err']:.3e}")
        check(rec["s_err"] <= ACCURACY_TOL, f"16 {label} s error "
              f"{rec['s_err']:.3e}")
        return rec, res

    say(f"== phase 16a: top-{k} by sketch (zolo_cuda panel)")
    from repro_torch.kernels import cholesky as kchol

    p = SP.plan_topk(base, (n, n), torch.float32, device=device)
    k5_before = kchol.launches
    rec, (u, s, vh) = run("sketch", p, lambda: p.topk(a))
    # the sketch's and the panel's factorizations are at n = l < N0
    rec["k5_launches"] = kchol.launches - k5_before
    check(rec["k5_launches"] == 0, f"16a launched K5 "
          f"{rec['k5_launches']} times")
    rec["residual"] = float(p.residual(a, u, s, vh))
    say(f"sketch: l {p.l}, q_iters {p.q_iters}, decision {p.decision}; "
        f"residual {rec['residual']:.3e}")
    if device.type == "cuda":
        check(rec["launches"]["gram"] == EXPECT_LAUNCHES["gram"] and
              rec["launches"]["grouped_combine"] == 2,
              f"16a panel solve launched {rec['launches']}")
    out["sketch"] = rec
    ref_triplets = (u, s, vh)

    say(f"== phase 16b: top-{k} by the dense solve")
    pd = SP.plan_topk(base.replace(strategy="dense"), (n, n), torch.float32,
                      device=device)
    out["dense"], _ = run("dense", pd, lambda: pd.topk(a))

    say(f"== phase 16c: top-{k}, strategy auto")
    pa = SP.plan_topk(base.replace(strategy="auto"), (n, n), torch.float32,
                      device=device)
    out["auto"], _ = run("auto", pa, lambda: pa.topk(a))

    say(f"== phase 16d: topk_adaptive(tol=0) on the sketch plan")
    with RungProbe(clock, counters) as probe:
        rec, (_, _, _, info) = run("adaptive", p,
                                   lambda: p.topk_adaptive(a, tol=0.0))
    rec["escalated"] = info["escalated"]
    rec["residual"] = info["residual"]
    rec["trail"] = trail_record(info.get("trail", ()), probe.rungs)
    # the probe read (and zeroed) the counts at the rung's verdict: the
    # path's launches are the rungs' (rung 0's include the sketch's panel
    # solve that ran before the ladder) plus what ran after
    rec["launches"] = sum_launches(rec["trail"] + [rec])
    if device.type == "cuda":
        want = (2 * EXPECT_LAUNCHES["gram"], 2 * 2)
        got = (rec["launches"]["gram"], rec["launches"]["grouped_combine"])
        check(got == want, f"16d sketch + dense rung launched {got}, "
              f"expected {want}")
    check(info["escalated"] and info["trail"][-1].outcome == "passed",
          f"16d did not escalate to a passed rung: {rec['trail']}")
    check_rung_kernels(device, rec["trail"])
    out["adaptive"] = rec

    say(f"== phase 16e: top-{k} by d&c on linverse n = {dnc_n} "
        f"(zolo_cuda_dynamic sign probes)")
    a4, s4 = svd_paper.synthesize("linverse", n=dnc_n, dtype=torch.float32,
                                  device=device)
    pn = SP.plan_topk(base.replace(strategy="dnc", svd=S.SvdConfig(
        method="zolo_cuda_dynamic")), (dnc_n, dnc_n), torch.float32,
        device=device)
    zero_counts(counters)
    clock.sync()
    t0 = time.perf_counter()
    u, s, vh, info = pn.topk_with_info(a4)
    clock.sync()
    rec = {"strategy": pn.strategy, "l": pn.l, "seconds":
           time.perf_counter() - t0, "launches": read_counts(counters),
           "converged": info["converged"], "count": info["count"],
           "rounds": info["rounds"], "shift": float(info["shift"]),
           "s_err": topk_error(torch, s, s4, k),
           "sign_method": pn._inner["sign"].method,
           "panel_method": pn._inner["panel"].method}
    say(f"d&c: {pn!r}; {rec['seconds']:.3f} s, converged "
        f"{rec['converged']}, count {rec['count']:g}, rounds "
        f"{rec['rounds']}, shift {rec['shift']:.4e}; K1 "
        f"{rec['launches']['gram']} K2 {rec['launches']['grouped_combine']};"
        f" top-{k} s error {rec['s_err']:.3e}")
    check(bool(torch.isfinite(s).all()), "16e d&c values not finite")
    check(rec["converged"] and k <= rec["count"] <= pn.l,
          f"16e d&c found no window: {rec}")
    # the s error is recorded, not held to the f32 limit: the extraction's
    # shifted CholeskyQR2 biases every value by about eps * trace(Q1^T Q1)
    # / 2 in f32 (ROADMAP Queue C): 1.2e-4 at n = 4,096 on an NVIDIA H100
    # 80GB HBM3 (700 W)
    if device.type == "cuda":
        check(rec["launches"]["gram"] > 0 and
              rec["launches"]["grouped_combine"] > 0,
              f"16e sign probes launched no K1/K2: {rec['launches']}")
    out["dnc"] = rec
    del a4, u, vh

    say(f"== phase 16f: lowrank_truncate(a, {k})")
    zero_counts(counters)
    clock.sync()
    t0 = time.perf_counter()
    pf, qf = lowrank_truncate(a, k)
    clock.sync()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    u, s, vh = ref_triplets
    approx = (pf.double() @ qf.double().mT)
    sketch_k = (u.double() * s.double()) @ vh.double()
    diff = float(torch.linalg.matrix_norm(approx - sketch_k)
                 / torch.linalg.matrix_norm(sketch_k))
    del sketch_k
    err = float(torch.linalg.matrix_norm(a.double() - approx))
    best = float(torch.sqrt((s_true[k:] ** 2).sum()))
    # the plan it ran: the cached one of its config (no kappa hint, so
    # the model's 1e6 and an auto-priced inner method)
    pl = SP.plan_topk(SP.TopKConfig(k=k, tol=1e-6), (n, n), torch.float32,
                      device=device)
    # the inner solve that ran: the sketch's panel, or the dense solve
    inner = pl._inner.get("panel", pl._inner["dense"])
    rec = {"seconds": secs, "launches": launches, "vs_sketch": diff,
           "frobenius_error": err, "eckart_young": best,
           "strategy": pl.strategy, "l": pl.l, "q_iters": pl.q_iters,
           "inner_method": inner.method}
    say(f"lowrank_truncate: {pl!r} (its {inner.shape} solve on "
        f"{inner.method}); "
        f"{secs:.3f} s, launches {launches}; "
        f"||P Q^T - U S Vh (16a)||_F / ||U S Vh||_F {diff:.3e}; "
        f"||A - P Q^T||_F {err:.6e} against the optimum {best:.6e}")
    check(err <= best * (1 + 1e-4), f"16f beyond Eckart-Young: {rec}")
    out["lowrank_truncate"] = rec
    return out


def phase_stages(torch, clock, p, a):
    """Split one solve: prescale + Zolo-PD + form_h (``plan.polar``), then
    ``eigh`` of the 12k x 12k H; the rest of ``svd`` is U = Q V and the
    sort."""
    clock.sync()
    t0 = time.perf_counter()
    _, h, _ = p.polar(a)
    clock.sync()
    t1 = time.perf_counter()
    p._eig_spec.fn(h, **p._eig_kwargs)
    clock.sync()
    t2 = time.perf_counter()
    stages = {"polar_s": t1 - t0, "eigh_s": t2 - t1}
    say(f"stages: prescale + {p.method} + form_h {stages['polar_s']:.3f} "
        f"s, {p.eig_method} {stages['eigh_s']:.3f} s")
    return stages


def phase_dynamic_stages(torch, clock, p, a):
    """Split one dynamic solve: the run-time bounds (``sigma_max_upper``,
    then ``sigma_min_lower_qr`` of the scaled matrix: one QR and 13 pairs
    of triangular vector solves), the whole polar stage
    (``plan.polar``: the bounds again, Zolo-PD and ``form_h``), and
    ``eigh``."""
    from repro_torch.core import eig, norms

    clock.sync()
    t0 = time.perf_counter()
    x0 = a / norms.sigma_max_upper(a)
    norms.sigma_min_lower_qr(x0)
    clock.sync()
    t1 = time.perf_counter()
    del x0
    _, h, _ = p.polar(a)
    clock.sync()
    t2 = time.perf_counter()
    eig.eigh(h)
    clock.sync()
    t3 = time.perf_counter()
    stages = {"bounds_s": t1 - t0, "polar_s": t2 - t1, "eigh_s": t3 - t2}
    say(f"stages: run-time bounds {stages['bounds_s']:.3f} s; bounds + "
        f"Zolo-PD + form_h {stages['polar_s']:.3f} s; eigh "
        f"{stages['eigh_s']:.3f} s")
    return stages


def phase_first_pass(torch, p, a):
    """The numerical margin of the first CholeskyQR2 pass: the f32 Gram's
    smallest eigenvalue against the clamped smallest shift c_eff and the
    first-pass ridge, and whether Z_1 = G + shift I factors in f32."""
    from repro_torch.core import zolo
    from repro_torch.kernels import ops

    x, _ = p._prescale(a)
    g = ops.gram(x)
    c0 = torch.tensor(p.schedule[0].c[0::2], dtype=torch.float32,
                      device=a.device)
    c_eff = zolo._clamp_shift(c0, g, torch.float32)
    lam_min = float(torch.linalg.eigvalsh(g.double())[0])
    n = g.shape[-1]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    z = g[None] + c_eff[:, None, None] * eye  # Z_j as the engine builds them
    info_clamped = int(torch.linalg.cholesky_ex(z[0]).info)
    z = zolo._first_pass_ridge(z, c_eff, torch.float32)[0]
    ridge = float((torch.diagonal(z) - torch.diagonal(g)).double().mean())
    info_ridged = int(torch.linalg.cholesky_ex(z).info)
    rec = {"gram_lambda_min": lam_min, "c_eff": float(c_eff[0]),
           "ridge": ridge, "cholesky_info_clamped": info_clamped,
           "cholesky_info_ridged": info_ridged}
    say(f"first pass: lambda_min(G) {lam_min:.3e}, c_eff {rec['c_eff']:.3e}, "
        f"ridged shift {ridge:.3e}; f32 Cholesky info of G + c_eff I: "
        f"{info_clamped}, with the ridge: {info_ridged}")
    check(info_ridged == 0, "the ridged first-pass Z does not factor")
    return rec


# --- the device-time split (torch.profiler) ----------------------------------

PROFILE_GROUPS = ("K1", "K2", "factorizations", "triangular solves",
                  "products", "eigh", "collectives/staging", "other")
# top-level torch ops by group: a kernel counts where the op that
# launched it (its outermost enclosing op) belongs
PROFILE_OPS = (
    ("eigh", ("eigh", "syevd")),
    ("collectives/staging", ("gloo", "c10d", "all_reduce", "allreduce",
                             "all_gather", "allgather", "broadcast")),
    ("factorizations", ("cholesky", "geqrf", "householder_product",
                        "orgqr", "ormqr", "linalg_qr", "potrf", "getrf",
                        "linalg_inv", "lu_factor")),
    ("triangular solves", ("solve_triangular", "triangular_solve",
                           "trsm")),
    ("products", ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul",
                  "aten::einsum", "aten::baddbmm", "aten::linear")))


def profile_group(kernel, op=""):
    """The group of one device kernel ``kernel`` launched under the
    top-level op ``op`` ("" when no op encloses it)."""
    k = kernel.lower()
    if "gram_slices" in k or "gram_shift" in k or "gram_bf16" in k:
        return "K1"
    if "combine_scalar" in k or "combine_vec4" in k:
        return "K2"
    if "memcpy" in k and ("dtoh" in k or "htod" in k):
        return "collectives/staging"
    o = op.lower()
    for group, keys in PROFILE_OPS:
        if any(key in o for key in keys):
            return group
    if "gemm" in k:
        return "products"
    return "other"


def profile_split(torch, clock, fn, top=12):
    """Device time of one ``fn()`` by group (``PROFILE_GROUPS``), from a
    ``torch.profiler`` trace: each kernel goes to the group of the
    outermost op that launched it, or by its own name when no op
    encloses it (K1 and K2 are launched through ``ctypes``).  ``wall_s``
    is fn's own synchronised time inside the trace; ``parse_s`` what
    reading the trace took after it.  Returns (record, fn's result); the
    record says "not measured" when the trace holds no device time (the
    CPU rehearsal)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        clock.sync()
        t0 = time.perf_counter()
        out = fn()
        clock.sync()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    # the trace's device events give each kernel name's time; the ops
    # that launched them only split that time between groups.  Events
    # that share a correlation id share one kernel list (on the H100 a
    # batched cuSOLVER call repeated it thousands of times): read it once
    events = prof.events()
    cpu_names = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    shares, total, count, seen, group_of = {}, {}, 0, set(), {}
    for ev in events:
        if ev.device_type == DeviceType.CPU:
            kernels = getattr(ev, "kernels", None) or []
            if not kernels or ev.id in seen:
                continue
            seen.add(ev.id)
            root = ev
            while getattr(root, "cpu_parent", None) is not None:
                root = root.cpu_parent
            for k in kernels:
                key = (k.name, root.name)
                if key not in group_of:
                    group_of[key] = profile_group(*key)
                part = shares.setdefault(k.name, {})
                g = group_of[key]
                part[g] = part.get(g, 0.0) + k.duration
        elif ev.name not in cpu_names:  # a device-side op annotation
            count += 1
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            total[ev.name] = total.get(ev.name, 0.0) + ms
    groups = {g: 0.0 for g in PROFILE_GROUPS}
    by_kernel = {}
    for name, ms in total.items():
        part = shares.get(name) or {profile_group(name): 1.0}
        norm = sum(part.values())
        for g, w in part.items():
            groups[g] += ms * w / norm
            by_kernel[(name, g)] = by_kernel.get((name, g), 0.0) \
                + ms * w / norm
    device_ms = sum(total.values())
    parse = time.perf_counter() - t1
    if device_ms <= 0:
        say(f"profiler: no device time in the trace (wall {wall:.3f} s): "
            f"the split is not measured")
        return {"wall_s": wall, "parse_s": parse, "device_ms": None,
                "groups_ms": "not measured"}, out
    rec = {"wall_s": wall, "parse_s": parse, "device_ms": device_ms,
           "device_events": count, "groups_ms": groups,
           "idle_share": max(0.0, 1.0 - device_ms / 1e3 / wall),
           "top": [[name, g, ms] for (name, g), ms in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:top]]}
    say(f"profiler: wall {wall:.3f} s, device {device_ms / 1e3:.3f} s in "
        f"{count} device events (trace read in {parse:.1f} s); "
        + ", ".join(f"{g} {ms / 1e3:.3f} s" for g, ms in groups.items()))
    for name, g, ms in rec["top"]:
        say(f"  {ms:10.2f} ms  [{g}] {name[:100]}")
    return rec, out


# --- phase 17: grouped Algorithm 3 on gloo ranks sharing the card ------------


class CollectiveCounter:
    """Counts the all-reduces issued on each named process group while
    entered (``torch.distributed.all_reduce`` is wrapped, and restored on
    exit), their bytes and shapes.  ``axes`` is {id(group): axis name},
    or ``meshes``: the "sep" and "zolo" groups of grouped meshes."""

    def __init__(self, meshes=(), axes=None):
        self.axis = dict(axes or {})
        for mesh in meshes:
            self.axis[id(mesh.sep_group)] = "sep"
            self.axis[id(mesh.zolo_group)] = "zolo"

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.real, self.calls = dist, dist.all_reduce, []

        def counted(t, *args, group=None, **kw):
            self.calls.append((self.axis.get(id(group), "other"),
                               tuple(t.shape), t.numel() * t.element_size()))
            return self.real(t, *args, group=group, **kw)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.real
        return False

    def record(self, axes=("sep", "zolo"), gram_bytes=None):
        """Per axis (and "other"): the count and bytes; with
        ``gram_bytes``, how many carried at least that many (the (n, n)
        Grams, against the prescale's vectors and scalars).  The "zolo"
        all-reduce carries a rank's local iterate: its shapes too."""
        out = {}
        for ax in tuple(axes) + ("other",):
            calls = [c for c in self.calls if c[0] == ax]
            out[ax] = len(calls)
            out[f"{ax}_bytes"] = sum(c[2] for c in calls)
            if gram_bytes is not None:
                out[f"{ax}_grams"] = sum(1 for c in calls
                                         if c[2] >= gram_bytes)
        if "zolo" in axes:
            out["zolo_shapes"] = sorted({c[1] for c in self.calls
                                         if c[0] == "zolo"})
        return out


class XwRecorder:
    """Records the X weight ``xw`` of every grouped combine while entered
    (``repro_torch.kernels.ops.grouped_combine`` is wrapped: K2 on a CUDA
    iterate)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.mod, self.real, self.xw = ops, ops.grouped_combine, []

        def recorded(x, t, a, mhat, xw=1.0):
            self.xw.append(float(xw))
            return self.real(x, t, a, mhat, xw)

        ops.grouped_combine = recorded
        return self

    def __exit__(self, *exc):
        self.mod.grouped_combine = self.real
        return False


def grouped_solve(torch, clock, p, a, counters, meshes, label):
    """One ``p.svd_info(a)`` on this rank with every launch count, the
    all-reduce counter and the combine weights set to 0 just before and
    read just after; peak memory reset before."""
    if a.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    with CollectiveCounter(meshes) as coll, XwRecorder() as xw, \
            TermCounter(clock) as tc:
        clock.sync()
        t0 = time.perf_counter()
        u, s, vh, info = p.svd_info(a)
        clock.sync()
        secs = time.perf_counter() - t0
    rec = {"label": label, "method": p.method, "r": p.r, "sep": p.sep,
           "seconds": secs, "launches": read_counts(counters),
           "collectives": coll.record(), "xw": sorted(set(xw.xw)),
           "terms": dict(tc.counts), "first_branch": first_branch(tc.counts),
           "peak_bytes": torch.cuda.max_memory_allocated()
           if a.device.type == "cuda" else None}
    rec.update(info_record(info))
    return (u, s, vh), rec


def identical_on_ranks(torch, u, s, vh):
    """True on every rank when all ranks hold bit-identical factors (a
    digest of s, U's column sums and Vh's row sums, all-gathered)."""
    import torch.distributed as dist

    d = torch.cat([s.double(), u.double().sum(0), vh.double().sum(1)])
    parts = [torch.empty_like(d) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, d)
    return all(torch.equal(t, parts[0]) for t in parts)


def agree_on_ranks(torch, device, values):
    """The all-gathered ``values`` (floats) of every rank."""
    import torch.distributed as dist

    v = torch.tensor(values, dtype=torch.float64, device=device)
    parts = [torch.empty_like(v) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, v)
    return [t.tolist() for t in parts]


def grouped_stages(torch, clock, p, a, rank):
    """The polar/eigh split of one grouped solve: ``plan.polar`` on every
    rank (it is collective), ``eigh`` of H timed on rank 0 only."""
    clock.sync()
    t0 = time.perf_counter()
    _, h, _ = p.polar(a)
    clock.sync()
    t1 = time.perf_counter()
    stages = {"polar_s": t1 - t0}
    if rank == 0:
        p._eig_spec.fn(h, **p._eig_kwargs)
        clock.sync()
        stages["eigh_s"] = time.perf_counter() - t1
    return stages


def grouped_compressed_psum(torch, clock, mesh, n, k):
    """17e: ``compressed_psum`` of this rank's (n, n) f32 gradient over
    the mesh's "zolo" group at rank k, against its plain version from
    the all-gathered gradients (the same sums in the group's rank order,
    the same CholeskyQR2); returns the errors and both times."""
    import torch.distributed as dist

    from repro_torch.core.structured_qr import cholesky_qr2
    from repro_torch.optim import compressed_psum

    dev = mesh.device
    gen = torch.Generator(device=dev)
    me = dist.get_rank()
    g = torch.randn((n, n), generator=gen.manual_seed(100 + me), device=dev)
    err = 1e-3 * torch.randn((n, n), generator=gen.manual_seed(200 + me),
                             device=dev)
    q_prev = torch.randn((n, k), generator=gen.manual_seed(7), device=dev)
    group = mesh.zolo_group
    size = dist.get_world_size(group)

    def plain():
        g_fb = g + err
        parts = [torch.empty_like(g_fb) for _ in range(size)]
        dist.all_gather(parts, g_fb, group=group)
        p = sum(gj @ q_prev for gj in parts)
        p = cholesky_qr2(p)
        q = sum(gj.mT @ p for gj in parts)
        g_hat = p @ q.mT / size
        return g_hat, g_fb - g_hat, q

    got = compressed_psum(g, err, q_prev, k, group)
    want = plain()
    scale = float(want[0].abs().amax())
    rec = {"n": n, "rank": k, "group_size": size,
           "g_hat_err": float((got[0] - want[0]).abs().amax()) / scale,
           "err_err": float((got[1] - want[1]).abs().amax()) / scale,
           "q_err": float((got[2] - want[2]).abs().amax())
           / float(want[2].abs().amax())}
    del got, want
    rec["ms"] = clock.ms(lambda: compressed_psum(g, err, q_prev, k, group),
                         reps=3)
    rec["plain_ms"] = clock.ms(plain, reps=3)
    return rec


def grouped_run(torch, rank, device, n, cpsum, profile):
    """Phase 17 on one rank: 17a-17f (see the module docstring); with
    ``profile`` one 17b solve split on rank 0."""
    import torch.distributed as dist

    import repro_torch.solver as S
    from repro_torch.configs import svd_paper
    from repro_torch.dist import zolo_group_mesh
    from repro_torch.resilience import solve_with_escalation

    clock = Clock(torch, device)
    counters = kernel_modules()
    m41 = zolo_group_mesh(4, device=device)
    m22 = zolo_group_mesh(2, device=device)
    meshes = (m41, m22)
    out = {"rank": rank, "position_4x1": [m41.zolo_index, m41.sep_index],
           "position_2x2": [m22.zolo_index, m22.sep_index]}
    if rank == 0:
        a, s_true = svd_paper.synthesize("linverse", n=n,
                                         dtype=torch.float32, device=device)
    else:
        a = torch.empty((n, n), dtype=torch.float32, device=device)
        s_true = torch.empty((n,), dtype=torch.float64, device=device)
    clock.sync()
    t0 = time.perf_counter()
    dist.broadcast(a, 0)
    dist.broadcast(s_true, 0)
    clock.sync()
    out["broadcast_s"] = time.perf_counter() - t0
    cfg = S.SvdConfig(kappa=KAPPA, l0_policy="estimate_at_plan")

    # 17a: (4, 1), cold then warm
    p = S.plan(cfg, (n, n), torch.float32, mesh=m41)
    fac, cold = grouped_solve(torch, clock, p, a, counters, meshes, "cold")
    del fac
    fac, rec = grouped_solve(torch, clock, p, a, counters, meshes, "warm")
    rec["schedule"] = len(p.schedule)
    rec["cold_s"] = cold["seconds"]
    rec["identical"] = identical_on_ranks(torch, *fac)
    if rank == 0:
        rec["accuracy"] = accuracy(torch, a, *fac, s_true)
        rec["s"] = fac[1].double().cpu().tolist()
    del fac
    rec["stages"] = grouped_stages(torch, clock, p, a, rank)
    # the plan audit of 17a's plan: every rank together (it runs the
    # plan's collectives); the parent checks each rank's report
    zero_counts(counters)
    clock.sync()
    t0 = time.perf_counter()
    rep = p.audit(a, raise_on_fail=False)
    clock.sync()
    rec["audit"] = {"ok": rep.ok, "violations": rep.violations,
                    "seconds": time.perf_counter() - t0,
                    "psum_counts": rep.psum_counts,
                    "expect_psums": rep.expect_psums,
                    "collectives": rep.collectives,
                    "host_syncs": rep.host_syncs,
                    "device_syncs": rep.device_syncs,
                    "device_sync_sites": rep.device_sync_sites,
                    "launches": read_counts(counters)}
    out["17a"] = rec

    # 17b: (2, 2), the same config; then (profile) one solve under the
    # profiler
    p = S.plan(cfg, (n, n), torch.float32, mesh=m22)
    fac, rec = grouped_solve(torch, clock, p, a, counters, meshes, "warm")
    rec["schedule"] = len(p.schedule)
    rec["identical"] = identical_on_ranks(torch, *fac)
    if rank == 0:
        rec["accuracy"] = accuracy(torch, a, *fac, s_true)
    del fac
    if profile and rank == 0:
        rec["profile"] = split_solve(torch, clock, p, a)
    elif profile:
        p.polar(a)
    out["17b"] = rec

    # 17c: run-time conditioning on (2, 2)
    p = S.plan(S.SvdConfig(l0_policy="runtime"), (n, n), torch.float32,
               mesh=m22)
    fac, rec = grouped_solve(torch, clock, p, a, counters, meshes, "warm")
    rec["identical"] = identical_on_ranks(torch, *fac)
    rec["ranks_iterations_l_init"] = agree_on_ranks(
        torch, device, [rec["iterations"], rec["l_init"]])
    if rank == 0:
        rec["accuracy"] = accuracy(torch, a, *fac, s_true)
    del fac
    out["17c"] = rec

    # 17f: the bound pinned in the extreme regime on (2, 2): the shifted
    # CholeskyQR2 substitution for the Householder first iteration
    p = S.plan(S.SvdConfig(method="zolo_grouped_dynamic", l0=PINNED_L),
               (n, n), torch.float32, mesh=m22)
    fac, rec = grouped_solve(torch, clock, p, a, counters, meshes, "warm")
    rec["identical"] = identical_on_ranks(torch, *fac)
    rec["ranks_iterations_l_init"] = agree_on_ranks(
        torch, device, [rec["iterations"], rec["l_init"]])
    if rank == 0:
        rec["accuracy"] = accuracy(torch, a, *fac, s_true)
    del fac
    out["17f"] = rec

    # 17d: the ladder on 17b's config
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with RungProbe(clock, counters) as probe, \
            CollectiveCounter(meshes) as coll:
        clock.sync()
        t0 = time.perf_counter()
        u, s, vh, trail = solve_with_escalation(a, cfg, mesh=m22)
        clock.sync()
        secs = time.perf_counter() - t0
    rec = {"seconds": secs, "trail": trail_record(trail, probe.rungs),
           "collectives": coll.record(),
           "peak_bytes": torch.cuda.max_memory_allocated()
           if device.type == "cuda" else None}
    rec["launches"] = sum_launches(rec["trail"])
    if rank == 0:
        rec["accuracy"] = accuracy(torch, a, u, s, vh, s_true)
    del u, s, vh
    out["17d"] = rec

    del a
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # 17e: compressed_psum over the zolo group of (2, 2)
    out["17e"] = grouped_compressed_psum(torch, clock, m22, *cpsum)
    return out


def grouped_rank(rank, world, init, n, dev_type, cpsum, profile, queue):
    """One rank of phase 17 (a spawned process): join the gloo world,
    run 17a-17f, put the record (or the traceback) on ``queue``."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, os.path.join(HERE, "src"))
        torch.set_num_threads(1)
        device = torch.device(dev_type, 0) if dev_type == "cuda" else \
            torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUPED_TIMEOUT))
        try:
            queue.put(grouped_run(torch, rank, device, n, cpsum, profile))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def check_grouped(device, recs, s_main, n):
    """The parent's checks of phase 17's per-rank records."""
    on_card = device.type == "cuda"
    ranks = sorted(recs)
    r0 = recs[0]
    # 17a and 17b: the reference's static pick.  A rank's group evaluates
    # one term: a CholeskyQR2 first iteration is 3 K1 launches (the
    # shifted Gram, the Q1 and the Q2 Grams), a Cholesky one 1; one K2
    # combine an iteration
    for key, sep in (("17a", 1), ("17b", 2)):
        iters = r0[key]["schedule"]
        want_k = zolo_launch_want(iters, 3)
        want_c = {"sep": 0 if sep == 1 else 2 + (iters - 1), "zolo": iters}
        m_pad = n + (-n) % sep
        for r in ranks:
            rec = recs[r][key]
            check(rec["method"] == "zolo_grouped",
                  f"{key} rank {r}: method {rec['method']}")
            check(rec["identical"], f"{key}: ranks disagree")
            if on_card:
                check(rec["launches"] == want_k, f"{key} rank {r}: "
                      f"launches {rec['launches']}, expected {want_k}")
            got_c = {ax: rec["collectives"][ax] for ax in ("sep", "zolo")}
            check(got_c == want_c, f"{key} rank {r}: all-reduces {got_c}, "
                  f"expected {want_c}")
            check(rec["collectives"]["zolo_shapes"] == [(m_pad // sep, n)],
                  f"{key} rank {r}: local iterate "
                  f"{rec['collectives']['zolo_shapes']}")
            zolo_index = recs[r][f"position_{4 if sep == 1 else 2}x{sep}"][0]
            want_xw = [1.0] if zolo_index == 0 else [0.0]
            check(not on_card or rec["xw"] == want_xw, f"{key} rank {r}: "
                  f"K2's xw {rec['xw']}, expected {want_xw}")
    # 17a's plan audit: the executed budget at sep = 1 (no "sep"
    # all-reduce is issued on a one-rank group), one "zolo" an iteration
    iters = r0["17a"]["schedule"]
    want_c = {"sep": 0, "zolo": iters}
    for r in ranks:
        au = recs[r]["17a"]["audit"]
        got_c = {ax: au["psum_counts"].get(ax, 0) for ax in want_c}
        check(au["ok"] and au["expect_psums"] == want_c and got_c == want_c,
              f"17a rank {r}: plan audit {au}, expected all-reduces "
              f"{want_c}")
    s_a = r0["17a"]["s"]
    s_max = s_a[0]
    s_vs_main = max(abs(x - y) for x, y in zip(s_a, s_main)) / s_max
    say(f"17a s against phase 5's: {s_vs_main:.3e}")
    check(s_vs_main <= ACCURACY_TOL, f"17a s vs phase 5 {s_vs_main:.3e}")
    # 17c: the run-time bound, CholeskyQR2 first at sep = 2
    c = r0["17c"]
    iters = c["iterations"]
    for r in ranks:
        rec = recs[r]["17c"]
        check(rec["method"] == "zolo_grouped_dynamic",
              f"17c rank {r}: method {rec['method']}")
        check(rec["identical"], "17c: ranks disagree")
        check(rec["first_branch"] == "cholqr2",
              f"17c rank {r}: first branch {rec['first_branch']}")
        check(rec["converged"], f"17c rank {r}: not converged")
        check(all(v == rec["ranks_iterations_l_init"][0]
                  for v in rec["ranks_iterations_l_init"]),
              f"17c: ranks disagree on (iterations, l_init) "
              f"{rec['ranks_iterations_l_init']}")
        want_c = {"sep": 1 + 2 + 1 + 2 * (iters - 1), "zolo": iters}
        got_c = {ax: rec["collectives"][ax] for ax in ("sep", "zolo")}
        check(got_c == want_c, f"17c rank {r}: all-reduces {got_c}, "
              f"expected {want_c}")
        if on_card:
            want_k = zolo_launch_want(iters, 3 + 1)  # + the sigma_min Gram
            check(rec["launches"] == want_k, f"17c rank {r}: launches "
                  f"{rec['launches']}, expected {want_k}")
    # 17f: the pinned bound in the extreme regime: the Householder first
    # iteration replaced by shifted CholeskyQR2 at sep = 2, no estimate
    f = r0["17f"]
    iters = f["iterations"]
    hh_thresh = 10.0 * (2.0 ** -23) ** 0.5  # 10 sqrt(eps(f32))
    for r in ranks:
        rec = recs[r]["17f"]
        check(rec["method"] == "zolo_grouped_dynamic",
              f"17f rank {r}: method {rec['method']}")
        check(rec["l_init"] < hh_thresh, f"17f rank {r}: l_init "
              f"{rec['l_init']:.4g} not below 10 sqrt(eps) = {hh_thresh:.4g}")
        check(rec["identical"], "17f: ranks disagree")
        check(rec["first_branch"] == "cholqr2" and
              rec["terms"]["term_sum_householder"] == 0,
              f"17f rank {r}: first-iteration terms {rec['terms']}")
        check(rec["converged"], f"17f rank {r}: not converged")
        check(all(v == rec["ranks_iterations_l_init"][0]
                  for v in rec["ranks_iterations_l_init"]),
              f"17f: ranks disagree on (iterations, l_init) "
              f"{rec['ranks_iterations_l_init']}")
        want_c = {"sep": 2 + 1 + 2 * (iters - 1), "zolo": iters}
        got_c = {ax: rec["collectives"][ax] for ax in ("sep", "zolo")}
        check(got_c == want_c, f"17f rank {r}: all-reduces {got_c}, "
              f"expected {want_c}")
        if on_card:
            want_k = zolo_launch_want(iters, 3)
            check(rec["launches"] == want_k, f"17f rank {r}: launches "
                  f"{rec['launches']}, expected {want_k}")
    # 17d: healthy at rung 0
    for r in ranks:
        trail = recs[r]["17d"]["trail"]
        check([t["outcome"] for t in trail] == ["passed"],
              f"17d rank {r}: trail {trail}")
        if on_card:
            k = recs[r]["17d"]["launches"]
            check(k["gram"] > 0 and k["grouped_combine"] > 0,
                  f"17d rank {r}: the grouped rung launched {k}")
            check(k == recs[0]["17d"]["launches"],
                  f"17d: ranks launched {k} and {recs[0]['17d']['launches']}")
    # 17e
    for r in ranks:
        e = recs[r]["17e"]
        worst = max(e["g_hat_err"], e["err_err"], e["q_err"])
        check(worst <= CPSUM_TOL, f"17e rank {r}: compressed_psum vs plain "
              f"{worst:.3e} > {CPSUM_TOL:g}")


def split_solve(torch, clock, p, a, eig=True):
    """One solve of plan ``p`` split: its polar stage (prescale, Zolo-PD,
    ``form_h``: ``p.polar``) traced by ``profile_split``, then (``eig``)
    its ``eigh`` of H timed alone by the clock — one cuSOLVER call that
    launches so many small kernels that reading their trace would take
    minutes — and recorded as the "eigh" group.  The rest of the solve,
    U = Q V and the sort, is one product: not split."""
    rec, (_, h, _) = profile_split(torch, clock, lambda: p.polar(a))
    if eig:
        clock.sync()
        t0 = time.perf_counter()
        p._eig_spec.fn(h, **p._eig_kwargs)
        clock.sync()
        rec["eigh_s"] = time.perf_counter() - t0
        if isinstance(rec["groups_ms"], dict):
            rec["groups_ms"]["eigh"] += rec["eigh_s"] * 1e3
        say(f"eigh (clock) {rec['eigh_s']:.3f} s")
    return rec


def phase_profile(torch, device, clock, a):
    """The device-time split of one phase-5 solve (``split_solve``)."""
    import repro_torch.solver as S

    say("== profile: one phase-5 solve, its polar stage under "
        "torch.profiler")
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R)
    p = S.plan(cfg, tuple(a.shape), torch.float32, device=device)
    return split_solve(torch, clock, p, a)


def spawn_ranks(torch, target, args, world, deadline, label):
    """Spawn ``world`` ranks running ``target(rank, world, init, *args,
    queue)`` on a gloo world (file:// init under build/), collect one
    record a rank; fails on a rank's error, death or the deadline, and
    stops every rank it started.  Returns ({rank: record}, seconds)."""
    import queue as queue_mod
    import tempfile

    import torch.multiprocessing as mp

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    scratch = os.path.join(HERE, "build")
    os.makedirs(scratch, exist_ok=True)
    init = "file://" + os.path.join(tempfile.mkdtemp(dir=scratch), "init")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, world, init) + tuple(args) + (results,))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    recs = {}
    try:
        while len(recs) < world:
            if time.perf_counter() - t0 > deadline:
                fail(f"{label} ranks did not finish within {deadline} s")
            try:
                rec = results.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                check(not dead, f"a {label} rank died (exit codes "
                      f"{[p.exitcode for p in procs]})")
                continue
            check("error" not in rec, f"{label} rank {rec['rank']} "
                  f"failed:\n{rec.get('error')}")
            recs[rec["rank"]] = rec
        for p in procs:
            p.join(60)
        check(all(p.exitcode == 0 for p in procs),
              f"{label} ranks exited {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(os.path.dirname(init[len("file://"):]),
                      ignore_errors=True)
    return recs, time.perf_counter() - t0


def phase_grouped(torch, device, n, s_main, cpsum, profile):
    """Phase 17: paper Algorithm 3 on GROUPED_WORLD gloo ranks sharing
    the device (spawned; each rank runs K1/K2 on the card, the
    collectives go through gloo and host memory)."""
    say(f"== phase 17: grouped Algorithm 3, {GROUPED_WORLD} gloo ranks on "
        f"{device}, linverse n = {n}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    recs, secs = spawn_ranks(torch, grouped_rank,
                             (n, device.type, cpsum, profile),
                             GROUPED_WORLD, GROUPED_DEADLINE, "phase 17")
    for key in ("17a", "17b", "17c", "17f", "17d"):
        rows = [recs[r][key] for r in sorted(recs)]
        acc = rows[0].get("accuracy")
        say(f"{key}: " + "; ".join(
            f"rank {r}: {row.get('method', 'ladder')} "
            f"{row['seconds']:.3f} s, K1 "
            f"{row['launches']['gram']} K2 "
            f"{row['launches']['grouped_combine']}, all-reduces "
            f"{row['collectives']['sep']} sep / "
            f"{row['collectives']['zolo']} zolo, peak "
            + ("not measured" if row["peak_bytes"] is None
               else f"{row['peak_bytes'] / 2**30:.2f} GiB")
            for r, row in enumerate(rows)))
        if acc:
            say(f"{key} rank 0 accuracy: {acc}")
    say(f"17a stages (rank 0): {recs[0]['17a']['stages']}; 17c l_init "
        f"{recs[0]['17c']['l_init']:.4g}, iterations "
        f"{recs[0]['17c']['iterations']}, first branch "
        f"{recs[0]['17c']['first_branch']}; 17f l_init "
        f"{recs[0]['17f']['l_init']:.4g}, iterations "
        f"{recs[0]['17f']['iterations']}, first branch "
        f"{recs[0]['17f']['first_branch']}")
    say(f"17e: {recs[0]['17e']}")
    au = recs[0]["17a"]["audit"]
    say(f"17a plan audit (rank 0): ok {au['ok']}, {au['seconds']:.3f} s, "
        f"all-reduces {au['psum_counts']} (budget {au['expect_psums']}), "
        f"collectives {au['collectives']}, host syncs {au['host_syncs']}, "
        f"device syncs {au['device_syncs']} {au['device_sync_sites']}, K1 "
        f"{au['launches']['gram']} "
        f"K2 {au['launches']['grouped_combine']}")
    check_grouped(device, recs, s_main, n)
    say(f"phase 17: {secs:.1f} s, broadcast {recs[0]['broadcast_s']:.3f} s")
    for r in recs.values():
        r["17a"].pop("s", None)
    return {"seconds": secs, "world": GROUPED_WORLD, "ranks": recs}



# --- phase 18: the SVD service and the plan audit ----------------------------


class AuditRecorder:
    """Keeps every plan-audit report made while entered, with its
    synchronised wall time (``repro_torch.analysis.plan_audit.audit_plan``
    is wrapped, and restored on exit): the service audits its bucket
    plans at warmup and keeps only the counters."""

    def __init__(self, clock):
        self.clock = clock

    def __enter__(self):
        from repro_torch.analysis import plan_audit

        self.mod, self.real, self.reports = plan_audit, \
            plan_audit.audit_plan, []

        def recorded(plan, a=None, **kw):
            self.clock.sync()
            t0 = time.perf_counter()
            rep = self.real(plan, a, **kw)
            self.clock.sync()
            self.reports.append((rep, time.perf_counter() - t0))
            return rep

        plan_audit.audit_plan = recorded
        return self

    def __exit__(self, *exc):
        self.mod.audit_plan = self.real
        return False


class BatchProbe:
    """Reads the kernel launches of every batch a service runs
    (``SvdService._run_batch`` of ``svc`` wrapped on the instance): one
    record per batch with its bucket, rung, filled slots and launches."""

    def __init__(self, svc, counters):
        self.svc, self.counters, self.batches = svc, counters, []
        real = svc._run_batch

        def probed(key, rung, batch, k):
            before = read_counts(counters)
            out = real(key, rung, batch, k)
            after = read_counts(counters)
            self.batches.append({
                "bucket": tuple(key), "rung": rung, "method":
                out[2].method if hasattr(out[2], "method") else
                out[2].strategy,
                "launches": {c: after[c] - before[c] for c in after}})
            return out

        svc._run_batch = probed


def audit_record(rep, secs):
    """The printed and kept fields of one plan-audit report."""
    rec = {"entry": rep.entry, "ok": rep.ok, "seconds": secs,
           "violations": list(rep.violations),
           "psum_counts": dict(rep.psum_counts),
           "expect_psums": rep.expect_psums,
           "host_syncs": rep.host_syncs,
           "host_sync_ops": dict(rep.host_sync_ops),
           "device_syncs": rep.device_syncs,
           "device_sync_sites": dict(rep.device_sync_sites),
           "wide_compute": rep.wide_compute, "wide_ok": dict(rep.wide_ok),
           "kernel_launches": {k: v for k, v in rep.kernel_launches.items()
                               if v}}
    say(f"audit {rep.entry}: ok {rep.ok}, {secs:.3f} s, host syncs "
        f"{rep.host_syncs} {rec['host_sync_ops']}, device syncs "
        f"{rep.device_syncs} {rec['device_sync_sites']}, all-reduces "
        f"{rec['psum_counts']} (budget "
        f"{rep.expect_psums}), launches {rec['kernel_launches']}, "
        f"checks {rep.checks}"
        + (f", violations {rep.violations}" if rep.violations else ""))
    return rec


def serve_accuracy(torch, a, out, kappa, k=None):
    """One served request against its synthesized spectrum: max|s -
    s_true|/s_max (the leading k for a top-k request), and for a full SVD
    ||A - U S Vh||_F/||A||_F and the orthogonality of U and Vh, in f64."""
    from repro_torch.core.svd import orthogonality

    u, s, vh = (t.double() for t in out)
    m, n = a.shape
    nmin = min(m, n)
    s_true = torch.logspace(0.0, -math.log10(kappa), nmin,
                            dtype=torch.float64, device=s.device)
    if k is not None:
        s_true = s_true[:k]
    check(bool(torch.isfinite(u).all() and torch.isfinite(s).all()
               and torch.isfinite(vh).all()), "a served result not finite")
    rec = {"s_err": float((s - s_true).abs().amax() / s_true[0])}
    if k is None:
        a64 = a.double()
        rec["residual"] = float(torch.linalg.matrix_norm(
            a64 - (u * s) @ vh) / torch.linalg.matrix_norm(a64))
        rec["orth_u"] = float(orthogonality(u))
        rec["orth_vh"] = float(orthogonality(vh.mT))
    for name, val in rec.items():
        check(val <= ACCURACY_TOL, f"served {tuple(a.shape)}: {name} "
              f"{val:.3e} > {ACCURACY_TOL:g}")
    return rec


def per_solve_launches(plan):
    """K1/K2 launches of one solve of a static ``zolo_cuda`` bucket plan:
    CholeskyQR2 first (1 + 2r K1), one K1 per later iteration, one K2 an
    iteration."""
    return zolo_launch_want(len(plan.schedule), 1 + 2 * plan.r)


def phase_serve(torch, device, clock, a, s_main, main_rec, sizes):
    """Phase 18: the SVD service on ``zolo_cuda`` (f32, verified, every
    bucket audited at warmup): (a) an open-loop stream through
    ``launch.svd_serve.run_workload``, (b) the phase-5 matrix at full
    width through a service on a 12,000 rung, (c) the top-k lane, (d)
    retries and deadlines through the service, (e) the plan audit of the
    phase-5 plan and of the dynamic default."""
    import repro_torch.serve as SV
    import repro_torch.solver as S
    from repro_torch.launch import svd_serve as L
    from repro_torch.resilience import ServiceFaults

    counters = kernel_modules()
    on_card = device.type == "cuda"
    base = dict(method="zolo_cuda", verify=True, audit_plans=True,
                device=str(device))
    out = {}

    say(f"== phase 18a: open-loop stream, {sizes['requests']} requests at "
        f"{sizes['rate']:g}/s over {sizes['shapes']}, kappa "
        f"{SERVE_KAPPA:g}, batch {SERVE_BATCH}")
    svc = SV.SvdService(SV.ServiceConfig(batch_size=SERVE_BATCH, **base))
    probe = BatchProbe(svc, counters)
    served = []
    real_submit = svc.submit

    def submit(x, mode="standard", deadline=None):
        fut = real_submit(x, mode, deadline)
        served.append((x, fut))
        return fut

    svc.submit = submit
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with AuditRecorder(clock) as audits:
        rec, launches = path_run(torch, counters, lambda: L.run_workload(
            svc, sizes["shapes"], requests=sizes["requests"],
            rate=sizes["rate"], kappa=SERVE_KAPPA, dtype=torch.float32,
            seed=0))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card \
        else None
    st = svc.stats()
    rec["launches"] = launches
    rec["warm_buckets"] = [tuple(k) for k in st["warm_buckets"]]
    rec["plan_audits"] = st["plan_audits"]
    rec["audits"] = [audit_record(r, secs) for r, secs in audits.reports]
    check(rec["ok"] == sizes["requests"] and
          all(f.exception() is None for _, f in served),
          f"18a: {sizes['requests'] - rec['ok']} requests failed")
    worst = {}
    for x, fut in served:
        acc = serve_accuracy(torch, x, fut.result(), SERVE_KAPPA)
        for name, val in acc.items():
            worst[name] = max(worst.get(name, 0.0), val)
    rec["worst"] = worst
    say(f"18a: {rec['solves_per_s']:.3f} solves/s, p50 "
        f"{rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} ms, wall "
        f"{rec['wall_s']:.3f} s, {rec['batches']} batches, pad waste "
        f"{rec['pad_waste']:.4f}, slot fill {rec['slot_fill']:.4f}, hit "
        f"rate {rec['plan_cache_hit_rate']}, retraces {rec['retraces']}, "
        f"peak "
        + ("not measured" if rec["peak_bytes"] is None
           else f"{rec['peak_bytes'] / 2**30:.2f} GiB")
        + f"; worst {worst}")
    want_buckets = sorted({tuple(svc.policy.key_for(sh, torch.float32,
                                                    "standard"))
                           for sh in sizes["shapes"]})
    check(sorted(rec["warm_buckets"]) == want_buckets,
          f"18a buckets {rec['warm_buckets']}, expected {want_buckets}")
    check(rec["retraces"] == 0 and rec["plan_cache_hit_rate"] == 1.0,
          f"18a steady state: retraces {rec['retraces']}, hit rate "
          f"{rec['plan_cache_hit_rate']}")
    nb = len(want_buckets)
    check(rec["plan_audits"] == {"audited": nb, "passed": nb, "failed": 0},
          f"18a plan audits {rec['plan_audits']}")
    check(all(r["ok"] and r["host_syncs"] == 0 for r in rec["audits"]),
          f"18a audits {rec['audits']}")
    rec["batch_launches"] = []
    for b in probe.batches:
        key = SV.BucketKey(*b["bucket"])
        plan, _ = svc._bucket_plan(key)
        per = per_solve_launches(plan)
        want = {c: SERVE_BATCH * per[c] for c in ("gram", "grouped_combine")}
        got = {c: b["launches"][c] for c in ("gram", "grouped_combine")}
        rec["batch_launches"].append({"bucket": b["bucket"], "got": got,
                                      "want": want})
        say(f"  batch {b['bucket'][:2]} rung {b['rung']} {b['method']}: "
            f"K1 {got['gram']} K2 {got['grouped_combine']} (slots "
            f"{SERVE_BATCH} x per-solve K1 {per['gram']} K2 "
            f"{per['grouped_combine']})")
        if on_card:
            check(got == want, f"18a batch {b['bucket']}: launches {got}, "
                  f"expected {want}")
    out["stream"] = rec
    del served, svc, probe

    n = a.shape[0]
    say(f"== phase 18b: the phase-5 matrix ({n}, {n}) through a service "
        f"on the {sizes['full_base']} rung")
    svc = SV.SvdService(SV.ServiceConfig(batch_size=1,
                                         base=sizes["full_base"], **base))
    probe = BatchProbe(svc, counters)

    def full():
        fut = svc.submit(a)
        return fut.result()

    clock.sync()
    t0 = time.perf_counter()
    (u, s, vh), launches = path_run(torch, counters, full)
    secs = time.perf_counter() - t0
    key = probe.batches[0]["bucket"]
    s_vs_main = float((s.double() - s_main.double()).abs().amax()
                      / s_main.double()[0])
    rec = {"bucket": key, "seconds": secs, "launches": launches,
           "phase5_s": main_rec["timed_s"], "s_vs_phase5": s_vs_main}
    rec["per_solve"] = per_solve_launches(svc._bucket_plan(
        SV.BucketKey(*key))[0])
    say(f"18b: bucket {key[:2]}, {secs:.3f} s (cold: plan, padding and "
        f"solve) against phase 5's {main_rec['timed_s']:.3f} s; K1 "
        f"{launches['gram']} K2 {launches['grouped_combine']} (per solve "
        f"{rec['per_solve']['gram']} / {rec['per_solve']['grouped_combine']}"
        f"); max|s - s_phase5|/s_max {s_vs_main:.3e}")
    check(key[:2] == (sizes["full_base"],) * 2, f"18b bucket {key}")
    check(s_vs_main <= ACCURACY_TOL, f"18b s vs phase 5 {s_vs_main:.3e}")
    check(u.shape == (n, n) and vh.shape == (n, n), "18b factor shapes")
    if on_card:
        check({c: launches[c] for c in ("gram", "grouped_combine")} ==
              {c: rec["per_solve"][c] for c in ("gram", "grouped_combine")},
              f"18b launches {launches}")
    out["full_width"] = rec
    del u, s, vh, svc, probe

    tk = sizes["topk"]
    m_k = sizes["topk_n"]
    say(f"== phase 18c: the topk:{tk} lane, one ({m_k}, {m_k}) request")
    svc = SV.SvdService(SV.ServiceConfig(batch_size=1, **base))
    x = L.synth_matrix(m_k, m_k, SERVE_KAPPA, seed=101, dtype=torch.float32,
                       device=device)
    with AuditRecorder(clock) as audits:
        svc.warmup([(m_k, m_k)], modes=(f"topk:{tk}",), dtypes=("float32",))

    def topk():
        fut = svc.submit(x, mode=f"topk:{tk}")
        return fut.result()

    clock.sync()
    t0 = time.perf_counter()
    res, launches = path_run(torch, counters, topk)
    secs = time.perf_counter() - t0
    plan, _ = svc._bucket_plan(svc.policy.key_for((m_k, m_k), torch.float32,
                                                  f"topk:{tk}"))
    rec = {"strategy": plan.strategy, "seconds": secs, "launches": launches,
           "audit": audit_record(*audits.reports[0])}
    rec.update(serve_accuracy(torch, x, res, SERVE_KAPPA, k=tk))
    check(tuple(res[0].shape) == (m_k, tk) and tuple(res[2].shape) ==
          (tk, m_k), "18c factor shapes")
    say(f"18c: {plan!r}; {secs:.3f} s, K1 {launches['gram']} K2 "
        f"{launches['grouped_combine']}; top-{tk} s error "
        f"{rec['s_err']:.3e}")
    check(rec["audit"]["ok"], f"18c audit {rec['audit']}")
    out["topk"] = rec
    del svc, x, res

    fn = sizes["fault_n"]
    say(f"== phase 18d: a NaN-injected request ({fn}, {fn}) through the "
        f"service, and a deadline under a skewed clock")
    svc = SV.SvdService(SV.ServiceConfig(
        batch_size=1, faults=ServiceFaults(nan_request_seqs=(0,)), **base))
    probe = BatchProbe(svc, counters)
    x = L.synth_matrix(fn, fn, SERVE_KAPPA, seed=202, dtype=torch.float32,
                       device=device)

    def retried():
        fut = svc.submit(x)
        return fut.result()

    clock.sync()
    t0 = time.perf_counter()
    res, launches = path_run(torch, counters, retried)
    secs = time.perf_counter() - t0
    st = svc.stats()
    rec = {"seconds": secs, "launches": launches,
           "batches": [{"rung": b["rung"], "method": b["method"],
                        "launches": {c: b["launches"][c] for c in
                                     ("gram", "grouped_combine")}}
                       for b in probe.batches],
           "retries": st["retries"], "quarantined": st["quarantined"],
           "health_failures": st["health_failures"]}
    rec.update(serve_accuracy(torch, x, res, SERVE_KAPPA))
    for b in rec["batches"]:
        say(f"  rung {b['rung']} {b['method']}: K1 "
            f"{b['launches']['gram']} K2 {b['launches']['grouped_combine']}")
    say(f"18d: resolved in {secs:.3f} s; retries {rec['retries']}, health "
        f"failures {rec['health_failures']}, quarantined "
        f"{rec['quarantined']}")
    check([b["rung"] for b in rec["batches"]] == [0, 1],
          f"18d rungs {rec['batches']}")
    check((rec["retries"], rec["quarantined"], rec["health_failures"]) ==
          (1, 0, 1), f"18d counters {rec}")
    if on_card:
        k0 = rec["batches"][0]["launches"]
        check(rec["batches"][0]["method"] == "zolo_cuda" and
              k0["gram"] > 0 and k0["grouped_combine"] > 0,
              f"18d rung 0 {rec['batches'][0]}")
    del svc, probe, x, res

    fake = {"t": 0.0}
    svc = SV.SvdService(SV.ServiceConfig(
        batch_size=4, faults=ServiceFaults(clock_skew=100.0), **base),
        clock=lambda: fake["t"])
    fut = svc.submit(torch.zeros((fn, fn), device=device), deadline=50.0)
    fake["t"] = 60.0
    svc.poll()
    rec["deadline"] = {"t_submit": fut.t_submit, "exception":
                       type(fut.exception()).__name__,
                       "deadline_expired": svc.stats()["deadline_expired"]}
    say(f"18d: skewed clock: submitted at {fut.t_submit}, "
        f"{rec['deadline']['exception']}, deadline_expired "
        f"{rec['deadline']['deadline_expired']}")
    check(rec["deadline"]["exception"] == "DeadlineExceeded" and
          rec["deadline"]["deadline_expired"] == 1, f"18d {rec['deadline']}")
    out["resilience"] = rec
    del svc, fut

    say("== phase 18e: SvdPlan.audit() of the phase-5 plan and of the "
        "dynamic default")
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R)
    dd_cfg = S.SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
                         l0_policy="runtime", r=R)
    for label, c in (("static", cfg), ("dynamic_default", dd_cfg)):
        p = S.plan(c, (n, n), torch.float32, device=device)
        zero_counts(counters)
        clock.sync()
        t0 = time.perf_counter()
        rep = p.audit(a, raise_on_fail=False)
        clock.sync()
        out[f"audit_{label}"] = r = audit_record(
            rep, time.perf_counter() - t0)
        r["launches"] = read_counts(counters)
    st = out["audit_static"]
    check(st["ok"] and st["host_syncs"] == 0,
          f"18e phase-5 plan audit {st}")
    if on_card:
        check({c: st["kernel_launches"].get(c, 0) for c in
               ("gram", "grouped_combine")} ==
              {"gram": EXPECT_LAUNCHES["gram"],
               "grouped_combine": EXPECT_LAUNCHES["grouped_combine"]},
              f"18e phase-5 plan audit launches {st['kernel_launches']}")
    check(out["audit_dynamic_default"]["ok"],
          f"18e dynamic default audit {out['audit_dynamic_default']}")
    return out

class TrainProbe:
    """Times the parts of a train step while entered: the optimizer's
    ``ZoloMuon.update`` and every ``orthogonalize`` inside it (module
    attributes of ``repro_torch.optim.muon`` wrapped, and restored on
    exit), each between two device synchronisations."""

    def __init__(self, clock):
        self.clock = clock
        self.update_s = self.orth_s = 0.0
        self.orth_calls = 0

    def __enter__(self):
        from repro_torch.optim import muon

        self.mod = muon
        self.real = (muon.orthogonalize, muon.ZoloMuon.update)
        real_orth, real_update = self.real

        def timed(fn, field):
            def run(*args, **kwargs):
                self.clock.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.clock.sync()
                setattr(self, field, getattr(self, field)
                        + time.perf_counter() - t0)
                if field == "orth_s":
                    self.orth_calls += 1
                return out
            return run

        muon.orthogonalize = timed(real_orth, "orth_s")
        muon.ZoloMuon.update = timed(real_update, "update_s")
        return self

    def __exit__(self, *exc):
        self.mod.orthogonalize, self.mod.ZoloMuon.update = self.real
        return False


def sync_sites(torch, fn):
    """Run ``fn`` under CUDA's sync debug mode: (its result, the number
    of synchronising calls, {site: count}), a site being the warning's
    file:line and the innermost ``repro_torch`` frame that led to it."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack
                if f"{os.sep}repro_torch{os.sep}" in f.filename]
        # no frame of the port: name the caller's last frames instead
        where = (f" via {os.path.relpath(ours[-1].filename, HERE)}:"
                 f"{ours[-1].lineno}" if ours else " via " + " < ".join(
                     f"{os.path.basename(f.filename)}:{f.lineno}"
                     for f in reversed(stack[-6:])))
        tail = os.sep.join(filename.split(os.sep)[-3:])
        sites[f"{tail}:{lineno}{where}"] += 1

    prev = torch.cuda.get_sync_debug_mode()
    # the first switch to "warn" in a process reports one synchronising
    # call of its own (torch 2.11+cu128): make it outside the window
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(prev)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum(sites.values()), dict(sites)


def muon_launch_want(plans):
    """K1/K2 launches of one optimizer step: per Muon leaf ``(plan,
    matrices)``, each matrix one static ``zolo_cuda`` solve of its plan
    (CholeskyQR2 first: 1 + 2r K1, one K1 per later iteration, one K2 an
    iteration)."""
    want = dict.fromkeys(zolo_launch_want(1, 0), 0)
    for plan, count in plans:
        per = zolo_launch_want(len(plan.schedule), 1 + 2 * plan.r)
        for k in want:
            want[k] += count * per[k]
    return want


def muon_leaf_shapes(params):
    """(every leaf name, [(name, shape)] of the Muon-labelled leaves)."""
    from repro_torch import tree
    from repro_torch.optim import muon as MU

    names, flags, _ = tree.flatten_with_names(MU.muon_labels(params))
    shapes = [tuple(p.shape) for p in tree.leaves(params)]
    return names, [(n, sh) for n, f, sh in zip(names, flags, shapes) if f]


def muon_plans(muon_cfg, muon_leaves, device):
    """The plans every Muon leaf runs on (cached per kind after the first
    step): ({(rows, cols): [plan, solves a step]}, the K1/K2 launches a
    step they predict, a printable record)."""
    from repro_torch.optim import muon as MU

    plans = {}
    for _, sh in muon_leaves:
        rows, cols = sh[-2:]
        p = MU._polar_plan(muon_cfg.method, rows, cols, muon_cfg.r,
                           muon_cfg.l0, muon_cfg.max_iters,
                           muon_cfg.polar_dtype, str(device))
        plans.setdefault((rows, cols), [p, 0])[1] += math.prod(sh[:-2])
    want = muon_launch_want([tuple(v) for v in plans.values()])
    rec = {f"{k[0]}x{k[1]}": {
        "method": p.method, "r": p.r, "iterations": len(p.schedule),
        "canonical": [max(k), min(k)], "solves_per_step": c}
        for k, (p, c) in plans.items()}
    return plans, want, rec


def muon_yardstick(torch, device, clock, counters, muon_cfg, leaf, mu,
                   label, f64=False):
    """One Muon leaf's update on the card: its momentum ``mu`` through its
    ``zolo_cuda`` plan and through a ``zolo_static`` plan of the same
    config, on the same inputs.  Checks the K1/K2 launches of each run
    (the zolo_static one none) and max|Q_cuda - Q_static| / max|Q| within
    MUON_TOL.  With ``f64`` the two are also held to the same plan solved
    in f64 (``zolo_static``, no f32 compute), and the matrices'
    sigma_min / sigma_max read from their f64 Grams: where a matrix has
    singular values below the f32 Gram's floor (sqrt(eps) sigma_max) the
    f32 polar factor is not determined to MUON_TOL by any route, so there
    the check is that zolo_cuda lies no further from the f64 factor than
    twice zolo_static's distance plus MUON_TOL, and the direct MUON_TOL
    check holds wherever zolo_static itself is within MUON_TOL of the f64
    factor.  Returns the record (errors, orthogonality, conditioning,
    times, launches)."""
    import dataclasses

    import repro_torch.solver as S
    from repro_torch.optim import muon as MU

    on_card = device.type == "cuda"
    lead, (rows, cols) = mu.shape[:-2], mu.shape[-2:]
    p_cuda = MU._polar_plan(muon_cfg.method, rows, cols, muon_cfg.r,
                            muon_cfg.l0, muon_cfg.max_iters,
                            muon_cfg.polar_dtype, str(device))
    p_static = S.plan(dataclasses.replace(p_cuda.config,
                                          method="zolo_static"),
                      (rows, cols), torch.float32, device=device)
    stack = mu.reshape((-1, rows, cols))
    ys = {}
    for route, p in (("zolo_cuda", p_cuda), ("zolo_static", p_static)):
        zero_counts(counters)
        clock.sync()
        t0 = time.perf_counter()
        q = p.polar_batched(stack, want_h=False)[0]
        clock.sync()
        ys[route] = {"seconds": time.perf_counter() - t0,
                     "launches": read_counts(counters), "q": q}
    q_cuda, q_static = ys["zolo_cuda"].pop("q"), ys["zolo_static"].pop("q")
    err = float((q_cuda - q_static).abs().amax() / q_static.abs().amax())
    qc = (q_cuda if rows >= cols else q_cuda.mT).double()
    orth = float(torch.linalg.matrix_norm(qc.mT @ qc - torch.eye(
        min(rows, cols), dtype=torch.float64, device=device)).amax()
        / min(rows, cols))
    del qc
    rec = {"leaf": leaf, "shape": list(mu.shape), "max_rel_err": err,
           "orth": orth, **ys}
    direct = True
    if f64:
        a64 = stack.double()
        p64 = S.plan(dataclasses.replace(p_cuda.config, method="zolo_static",
                                         compute_dtype=None),
                     (rows, cols), torch.float64, device=device)
        q64 = p64.polar_batched(a64, want_h=False)[0]
        s64 = q64.abs().amax()
        per = [(q - q64).abs().amax(dim=(-2, -1)) / s64
               for q in (q_cuda.double(), q_static.double())]
        g = a64.mT @ a64 if rows >= cols else a64 @ a64.mT
        sig = torch.linalg.eigvalsh(g).clamp(min=0).sqrt()  # ascending
        ratio = sig[:, 0] / sig[:, -1]
        floor = math.sqrt(torch.finfo(torch.float32).eps)
        worst = int(per[0].argmax())
        rec.update({
            "err_cuda_vs_f64": float(per[0].max()),
            "err_static_vs_f64": float(per[1].max()),
            "sigma_ratio_min": float(ratio.min()),
            "matrices_below_f32_gram_floor": int((ratio < floor).sum()),
            "matrices": len(ratio), "worst_matrix": worst,
            "worst_sigma_ratio": float(ratio[worst])})
        del a64, q64, g, sig
        direct = rec["err_static_vs_f64"] <= MUON_TOL
    say(f"{label} {leaf} {tuple(mu.shape)}: max|Q_cuda - Q_static| / "
        f"max|Q| {err:.3e} (tolerance {MUON_TOL:g}), orthogonality "
        f"{orth:.3e}, zolo_cuda {ys['zolo_cuda']['seconds']:.3f} s (K1 "
        f"{ys['zolo_cuda']['launches']['gram']} K2 "
        f"{ys['zolo_cuda']['launches']['grouped_combine']}), zolo_static "
        f"{ys['zolo_static']['seconds']:.3f} s"
        + (f"; against the f64 solve zolo_cuda {rec['err_cuda_vs_f64']:.3e}"
           f", zolo_static {rec['err_static_vs_f64']:.3e}; sigma_min / "
           f"sigma_max down to {rec['sigma_ratio_min']:.3e} "
           f"({rec['matrices_below_f32_gram_floor']} of "
           f"{rec['matrices']} matrices below sqrt(eps_f32)); worst "
           f"matrix {rec['worst_matrix']} at "
           f"{rec['worst_sigma_ratio']:.3e}" if f64 else ""))
    if f64:
        check(rec["err_cuda_vs_f64"]
              <= 2 * rec["err_static_vs_f64"] + MUON_TOL,
              f"{label}: {leaf} zolo_cuda {rec['err_cuda_vs_f64']:.3e} "
              f"from the f64 solve, zolo_static "
              f"{rec['err_static_vs_f64']:.3e}")
    if direct:
        check(err <= MUON_TOL, f"{label}: {leaf} zolo_cuda vs zolo_static "
              f"{err:.3e}")
    if on_card:
        per = zolo_launch_want(len(p_cuda.schedule), 1 + 2 * p_cuda.r)
        count = math.prod(lead)
        check(ys["zolo_cuda"]["launches"]["gram"] == count * per["gram"]
              and ys["zolo_cuda"]["launches"]["grouped_combine"]
              == count * per["grouped_combine"]
              and ys["zolo_static"]["launches"]["gram"] == 0
              and ys["zolo_static"]["launches"]["grouped_combine"] == 0,
              f"{label}: {leaf} launches {ys}")
    del q_cuda, q_static, stack
    if on_card:
        torch.cuda.empty_cache()
    return rec


def muon_kernel_times(torch, device, clock, m_, n_, r, label,
                      profile=False):
    """K1 and K2 at one of Muon's tall shapes (m_, n_), each against its
    plain version (within K1_TOL / K2_TOL_F32 of its max) and timed beside
    it, one library call and its bound (with ``profile``, also their
    device times): {"gram/simt": ..., "grouped_combine": ...}."""
    from repro_torch.kernels import ops, ref

    on_card = device.type == "cuda"
    # more calls where one is tens of microseconds
    reps = (5 if m_ * n_ * n_ >= 1e10 else 20) if on_card else 2
    gen = torch.Generator(device=device).manual_seed(19)
    x = torch.randn((m_, n_), generator=gen, device=device)
    t = torch.randn((r, m_, n_), generator=gen, device=device)
    coef = torch.randn((r,), generator=gen, device=device)
    mhat = torch.tensor(0.987, device=device)
    g_err = float((ops.gram(x) - ref.gram_ref(x)).abs().amax()
                  / ref.gram_ref(x).abs().amax())
    c_err = float((ops.polar_update(x, t, coef, mhat)
                   - ref.polar_update_ref(x, t, coef, mhat)).abs().amax()
                  / ref.polar_update_ref(x, t, coef, mhat).abs().amax())
    check(g_err <= K1_TOL and c_err <= K2_TOL_F32,
          f"{label} ({m_}, {n_}): K1 {g_err:.3e} K2 {c_err:.3e} against the "
          "plain versions")
    k1 = dict(k1_f32_times(torch, clock, x, reps, profile), max_rel_err=g_err)
    say(f"K1 simt {k1['shape']}: kernel {k1['ms']:.3f} ms, plain "
        f"{k1['plain_ms']:.3f} ms, library {fmt_ms(k1['library_ms'])}, "
        f"bound {k1['bound_ms']:.3f} ms ({k1['bound_by']}); S = "
        f"{k1['slices']} (tile {k1['tile']}); max error / max|G| "
        f"{g_err:.3e}" + fmt_device(k1))
    k2 = dict(k2_f32_times(torch, clock, x, t, coef, mhat, reps, profile),
              max_rel_err=c_err)
    return {"gram/simt": k1, "grouped_combine": k2}


def phase_train(torch, device, clock, sizes):
    """Phase 19: the LM training path of ``repro_torch`` with ZoloMuon.

    ``make_train_step`` on ``sizes["cfg"]`` (qwen3-8b at full width on the
    card), f32 masters, bf16 compute, per-stage remat, SyntheticLM data:
    one warm step, then timed steps (launches read around each, the
    optimizer's update and its ``orthogonalize`` calls timed apart), then
    one step under CUDA's sync debug mode.  Checks: finite losses and
    gradient norms, K1/K2 launches a step equal to the plans' count, one
    leaf kind's update against a ``zolo_static`` plan on the card, K1 and
    K2 at Muon's tall shape against their plain versions; then the
    launcher (``repro_torch.launch.train``) on the smoke config, and its
    resume from the checkpoint it saved."""
    import contextlib
    import io

    from repro_torch import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.optim import muon as MU
    from repro_torch.train import step as TS

    t_phase = time.perf_counter()
    counters = kernel_modules()
    on_card = device.type == "cuda"
    cfg, b, s = sizes["cfg"], sizes["batch"], sizes["seq"]
    muon_cfg = MU.MuonConfig()
    say(f"== phase 19: training {cfg.name} ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype} compute, remat {cfg.remat}), batch {b} x {s}, "
        f"ZoloMuon ({MU.polar_method(muon_cfg.method, muon_cfg.polar_dtype)},"
        f" r = {muon_cfg.r}, l0 = {muon_cfg.l0:g})")
    init_fn, step_fn = TS.make_train_step(cfg, muon_cfg, total_steps=100,
                                          warmup=1)
    clock.sync()
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    clock.sync()
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
           "seq": s, "init_s": time.perf_counter() - t0,
           "params": M.param_count(state.params)}
    if on_card:
        rec["state_bytes"] = torch.cuda.memory_allocated()
    names, muon_leaves = muon_leaf_shapes(state.params)
    rec["muon_leaves"] = {n: list(sh) for n, sh in muon_leaves}
    rec["solves_per_step"] = sum(math.prod(sh[:-2]) for _, sh in muon_leaves)
    say(f"{rec['params']:,} parameters, init {rec['init_s']:.3f} s; Muon "
        f"leaves {rec['muon_leaves']} ({rec['solves_per_step']} polar "
        f"solves a step)"
        + (f"; state {rec['state_bytes'] / 2**30:.2f} GiB" if on_card
           else ""))
    data = SyntheticLM(cfg.vocab_size, s, b, dtype=cfg.dtype,
                       device=str(device))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(1 + sizes["steps"]):
        batch = data.batch_at(i)
        with TrainProbe(clock) as probe:
            zero_counts(counters)
            clock.sync()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            clock.sync()
            secs = time.perf_counter() - t0
            launches = read_counts(counters)
            by_split = split_counts()
        m = {k: float(v) for k, v in metrics.items()}
        steps.append({"step": i, "seconds": secs, "update_s": probe.update_s,
                      "orthogonalize_s": probe.orth_s,
                      "orthogonalize_calls": probe.orth_calls,
                      "fwd_bwd_s": secs - probe.update_s,
                      "launches": launches, "k1_by_split": by_split, **m})
        say(f"{'warm' if i == 0 else 'timed'} step {i}: {secs:.3f} s "
            f"(forward+backward {secs - probe.update_s:.3f}, update "
            f"{probe.update_s:.3f} of which orthogonalize {probe.orth_s:.3f}"
            f" in {probe.orth_calls} calls), loss {m['loss']:.5f}, grad "
            f"norm {m['grad_norm']:.5f}, lr scale {m['lr_scale']:g}, K1 "
            f"{launches['gram']} (simt {launches['gram/simt']}, wgmma "
            f"{launches['gram/wgmma']}; by split S {by_split}) K2 "
            f"{launches['grouped_combine']}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"19: step {i} loss {m['loss']} grad norm {m['grad_norm']}")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card \
        else None
    rec["steps"] = steps
    timed = steps[1:]
    rec["step_s"] = sum(t["seconds"] for t in timed) / len(timed)
    rec["tokens_per_s"] = b * s / rec["step_s"]
    for k in ("update_s", "orthogonalize_s", "fwd_bwd_s"):
        rec[k] = sum(t[k] for t in timed) / len(timed)

    plans, want, rec["plans"] = muon_plans(muon_cfg, muon_leaves, device)
    rec["launches_per_step"] = timed[-1]["launches"]
    rec["launches_want"] = want
    say(f"plans {rec['plans']}; K1/K2 a step expected {want['gram']} / "
        f"{want['grouped_combine']}")
    check(all(p.method == "zolo_cuda" for p, _ in plans.values()),
          f"19: Muon plans {rec['plans']}")
    if on_card:
        for t in timed:
            check(t["launches"] == want, f"19: step {t['step']} launched "
                  f"{t['launches']}, expected {want}")

    say("== phase 19b: one step under CUDA's sync debug mode")
    batch = data.batch_at(len(steps))
    if on_card:
        (state, metrics), n_sync, sites = sync_sites(
            torch, lambda: step_fn(state, batch))
        clock.sync()
    else:
        state, metrics = step_fn(state, batch)
        n_sync, sites = None, {}
    rec["device_syncs"], rec["device_sync_sites"] = n_sync, sites
    say(f"synchronising calls in one step: {n_sync} {sites}")
    check(math.isfinite(float(metrics["loss"])), "19b: loss not finite")

    say(f"== phase 19c: {MUON_YARDSTICK}'s Muon update, zolo_cuda against "
        "zolo_static on the same momentum")
    mu = dict(zip(names, tree.leaves(state.opt["mu"])))[MUON_YARDSTICK]
    rows, cols = mu.shape[-2:]
    rec["yardstick"] = muon_yardstick(torch, device, clock, counters,
                                      muon_cfg, MUON_YARDSTICK, mu, "19c")
    del mu, state, metrics, batch
    if on_card:
        torch.cuda.empty_cache()

    say(f"== phase 19d: K1 and K2 at Muon's tall shape ({max(rows, cols)}, "
        f"{min(rows, cols)})")
    rec["kernel_times"] = muon_kernel_times(
        torch, device, clock, max(rows, cols), min(rows, cols), muon_cfg.r,
        "19d")

    say(f"== phase 19e: the launcher on the {TRAIN_ARCH} smoke config, "
        f"{LAUNCH_STEPS[0]} steps, then a resume to {LAUNCH_STEPS[1]}")
    ckpt_dir = os.path.join(HERE, "build", "train_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log = os.path.join(ckpt_dir, "log.jsonl")
    args = ["--arch", TRAIN_ARCH, "--smoke", "--batch", "2", "--seq", "64",
            "--device", str(device), "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "2", "--log", log]
    outs = []
    zero_counts(counters)
    for n_steps in LAUNCH_STEPS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            final = launch_train.main(args + ["--steps", str(n_steps)])
        outs.append(buf.getvalue())
        check(int(final.step) == n_steps,
              f"19e: the launcher stopped at {int(final.step)}")
    clock.sync()
    with open(log) as f:
        logged = [json.loads(line) for line in f]
    launch = {"launches": read_counts(counters), "log": logged,
              "steps": [int(r_["step"]) for r_ in logged],
              "checkpoints": sorted(os.listdir(ckpt_dir))}
    say(f"launcher: {outs[1].strip().splitlines()} log {logged}; launches "
        f"{launch['launches']}")
    check(f"[loop] resumed from step {LAUNCH_STEPS[0]}" in outs[1]
          and "resumed" not in outs[0],
          f"19e: no resume from step {LAUNCH_STEPS[0]}: {outs}")
    check(all(math.isfinite(r_["loss"]) for r_ in logged),
          f"19e: a logged loss is not finite {logged}")
    if on_card:
        check(launch["launches"]["gram"] > 0
              and launch["launches"]["grouped_combine"] > 0,
              f"19e: the launcher's Muon solves ran no kernel "
              f"{launch['launches']}")
    rec["launcher"] = launch
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"phase 19 ({rec['seconds']:.1f} s): {rec['step_s']:.3f} s a step "
        f"(before K1's split and K2's single launch: "
        f"{PRIOR_STEP_S['19']} s), {rec['tokens_per_s']:.1f} "
        f"tokens/s, update {rec['update_s']:.3f} s (orthogonalize "
        f"{rec['orthogonalize_s']:.3f} s), forward+backward "
        f"{rec['fwd_bwd_s']:.3f} s, peak "
        + ("not measured" if rec["peak_bytes"] is None
           else f"{rec['peak_bytes'] / 2**30:.2f} GiB"))
    return rec


class ServeProbe:
    """Times a ``ServeEngine``'s prefill and each decode step of one
    ``generate`` call (CUDA events, read once after it; the host clock in
    a CPU rehearsal) and keeps their logits, by wrapping the engine's
    ``_prefill`` and ``_decode`` while entered."""

    def __init__(self, torch, engine, keep_logits=True):
        self.torch, self.engine, self.keep = torch, engine, keep_logits
        self.marks, self.logits = [], []

    def _mark(self):
        if self.torch.cuda.is_available():
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _wrap(self, fn):
        def run(*args):
            t0 = self._mark()
            logits, caches = fn(*args)
            self.marks.append((t0, self._mark()))
            if self.keep:
                self.logits.append(logits)
            return logits, caches
        return run

    def __enter__(self):
        self.real = (self.engine._prefill, self.engine._decode)
        self.engine._prefill = self._wrap(self.real[0])
        self.engine._decode = self._wrap(self.real[1])
        return self

    def __exit__(self, *exc):
        self.engine._prefill, self.engine._decode = self.real
        return False

    def ms(self):
        """[prefill ms, decode ms of each step]"""
        out = []
        for t0, t1 in self.marks:
            out.append(t0.elapsed_time(t1) if hasattr(t0, "elapsed_time")
                       else (t1 - t0) * 1e3)
        return out


def decode_bound_ms(cfg, params, caches, batch):
    """The least time of one decode step at PEAK_BYTES, and its bytes:
    every weight it uses read once (the embedding's ``batch`` rows when
    untied; an MoE layer's experts scaled by the most ``batch`` tokens can
    route to, min(E, batch k) of E), the cache read once (a ring's valid
    slots only, min(pos, w) of w, at the step's ``pos``) and what changes
    in it written once (one ring slot; the SSD and RG-LRU states whole)."""
    from repro_torch import tree

    pos = int(caches["pos"])
    weights = 0
    for name, t in zip(*tree.flatten_with_names(params)[:2]):
        nbytes = t.numel() * t.element_size()
        keys = name.split("/")
        if name == "embed" and not cfg.tie_embeddings:
            nbytes = batch * t.shape[-1] * t.element_size()
        elif cfg.num_experts and keys[-2:-1] == ["mlp"] \
                and keys[-1] != "router":
            nbytes *= min(cfg.num_experts,
                          batch * cfg.moe_top_k) / cfg.num_experts
        weights += nbytes
    cache = 0
    for name, t in zip(*tree.flatten_with_names(caches)[:2]):
        if name == "pos":
            continue
        nbytes = t.numel() * t.element_size()
        if name.split("/")[-1] in ("k", "v"):  # a ring, (..., b, w, kv, d)
            w = t.shape[-3]
            cache += nbytes * (min(pos, w) + 1) / w
        else:
            cache += 2 * nbytes
    total = weights + cache
    return total / PEAK_BYTES * 1e3, total


def layer_cache_bytes(cfg, caches):
    """The bytes of the largest one layer's decode cache."""
    from repro_torch import tree

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in tree.leaves(c))

    return max([nbytes(c) // cfg.num_stages for c in caches["stages"]]
               + [nbytes(c) for c in caches["rem"]])


def serve_lm_case(torch, device, clock, counters, cfg, case, label):
    """One arch through ``ServeEngine.generate`` (greedy) at full width:
    prefill seconds, decode ms a token (median), tokens/s, cache and peak
    memory, launches of the path (K1-K4 must stay 0), the synchronising
    calls of one decode step (must be 0) and the memory it allocates
    beyond the caches (at most one layer's cache and DECODE_SLACK, so it
    does not grow with depth); then the decode logits against
    ``hidden_states`` -> ``lm_head`` over the prompt plus the generated
    tokens, and the greedy tokens against that forward's argmax wherever
    its top-2 gap exceeds the tolerance.  An MoE config is served with a
    capacity factor of num_experts / top_k, so that no token is dropped
    and the forward's b s tokens route as decode's b at a time do."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    on_card = device.type == "cuda"
    b, s, gen = case["batch"], case["prompt"], case["gen"]
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.moe_top_k)
    gen_ = torch.Generator(device=device).manual_seed(20)
    params = M.init_params(cfg, gen_)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen_,
                           device=device, dtype=torch.int32)
    eng = ServeEngine(cfg, params, max_len=case["max_len"])
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "pattern": list(cfg.block_pattern), "batch": b, "prompt": s,
           "gen": gen, "max_len": case["max_len"],
           "capacity_factor": cfg.capacity_factor if cfg.num_experts
           else None, "params": M.param_count(params)}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with ServeProbe(torch, eng) as probe:
        zero_counts(counters)
        clock.sync()
        t0 = time.perf_counter()
        toks, caches = eng.generate({"tokens": prompt}, steps=gen)
        host = toks.cpu()  # the one read back
        secs = time.perf_counter() - t0
        rec["launches"] = read_counts(counters)
    ms = probe.ms()
    decode_ms = sorted(ms[1:])
    rec.update({
        "generate_s": secs, "prefill_s": ms[0] / 1e3,
        "decode_ms_median": decode_ms[len(decode_ms) // 2]
        if decode_ms else None,
        "decode_ms_min": decode_ms[0] if decode_ms else None,
        "decode_ms_max": decode_ms[-1] if decode_ms else None,
        "tokens_per_s": b * gen / secs,
        "decode_tokens_per_s": b * len(decode_ms) / (sum(decode_ms) / 1e3)
        if decode_ms else None,
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in tree.leaves(caches)),
        "peak_bytes": torch.cuda.max_memory_allocated() - base
        if on_card else None})
    rec["decode_bound_ms"], rec["decode_bound_bytes"] = decode_bound_ms(
        cfg, params, caches, b)
    check(host.shape == (b, gen) and int(host.min()) >= 0
          and int(host.max()) < cfg.vocab_size,
          f"{label}: tokens {tuple(host.shape)} out of range")
    logits = torch.stack([lg.float() for lg in probe.logits], dim=1)
    check(bool(torch.isfinite(logits).all()),
          f"{label}: logits not finite")
    # the greedy tokens are the argmax of the logits they were drawn from
    check(torch.equal(logits[..., :cfg.vocab_size].argmax(-1).int().cpu(),
                      host), f"{label}: greedy tokens are not the "
          f"argmax of their logits")
    if on_card:
        kernels_off = all(v == 0 for v in rec["launches"].values())
        check(kernels_off, f"{label}: serving launched "
              f"{rec['launches']}, expected no K1-K4")

    # the synchronising calls of one decode step, and what it allocates
    # beyond the caches it writes in place
    nxt = toks[:, -1:]
    rec["layer_cache_bytes"] = layer_cache_bytes(cfg, caches)
    if on_card:
        clock.sync()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _, rec["decode_step_syncs"], rec["decode_step_sync_sites"] = \
            sync_sites(torch, lambda: eng._decode(params, nxt, caches))
        clock.sync()
        rec["decode_step_transient_bytes"] = \
            torch.cuda.max_memory_allocated() - held
        check(rec["decode_step_syncs"] == 0, f"{label}: "
              f"{rec['decode_step_syncs']} synchronising calls in a decode "
              f"step {rec['decode_step_sync_sites']}")
        limit = rec["layer_cache_bytes"] + DECODE_SLACK
        check(rec["decode_step_transient_bytes"] <= limit, f"{label}: a "
              f"decode step allocates {rec['decode_step_transient_bytes']}"
              f" bytes beyond its caches, above one layer's cache + slack "
              f"{limit}")
    else:
        rec["decode_step_syncs"], rec["decode_step_sync_sites"] = None, {}
        rec["decode_step_transient_bytes"] = None
    del caches, probe

    # the forward over prompt + all generated tokens but the last,
    # projected at the decode positions only
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.no_grad():
        x, _ = M.hidden_states(params, {"tokens": full}, cfg)
        want = M.lm_head(params, x[:, s - 1:], cfg).float()
    del x
    scale = float(want.abs().amax())
    err = float((want - logits).abs().amax()) / scale
    top2 = want[..., :cfg.vocab_size].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > SERVE_LM_TOL * scale
    agree = want[..., :cfg.vocab_size].argmax(-1).int() == toks
    rec.update({"forward_max_rel_err": err,
                "greedy_clear_positions": int(clear.sum()),
                "greedy_agree_where_clear": int((agree & clear).sum()),
                "greedy_agree_all": int(agree.sum())})
    check(err <= SERVE_LM_TOL, f"{label}: decode logits against the "
          f"forward {err:.3e} > {SERVE_LM_TOL}")
    check(bool(agree[clear].all()), f"{label}: greedy tokens differ "
          f"from the forward's argmax at {int((clear & ~agree).sum())}"
          f" clear positions")
    del want, params, toks, logits
    if on_card:
        torch.cuda.empty_cache()
    say(f"{label} {cfg.name} ({cfg.num_layers} layers {cfg.block_pattern}, "
        f"{rec['params']:,} parameters), b {b}, prompt {s}, {gen} tokens, "
        f"max_len {case['max_len']}: prefill {rec['prefill_s']:.3f} s, "
        f"decode {fmt_ms(rec['decode_ms_median'])} a token (median; "
        f"{fmt_ms(rec['decode_ms_min'])} to {fmt_ms(rec['decode_ms_max'])}"
        f"; bound {fmt_ms(rec['decode_bound_ms'])} for "
        f"{rec['decode_bound_bytes'] / 1e9:.3f} GB), "
        f"generate {secs:.3f} s = {rec['tokens_per_s']:.1f} tokens/s "
        f"(decode alone {rec['decode_tokens_per_s']:.1f}), cache "
        f"{rec['cache_bytes'] / 2**30:.3f} GiB, peak "
        + ("not measured" if rec["peak_bytes"] is None
           else f"{rec['peak_bytes'] / 2**30:.2f} GiB")
        + f"; syncs in a decode step {rec['decode_step_syncs']}, its "
        f"transient memory "
        + ("not measured" if rec["decode_step_transient_bytes"] is None
           else f"{rec['decode_step_transient_bytes'] / 2**20:.1f} MiB")
        + f" (one layer's cache {rec['layer_cache_bytes'] / 2**20:.1f} MiB)"
        f"; against the forward {rec['forward_max_rel_err']:.3e} "
        f"(tolerance {SERVE_LM_TOL:g}), greedy = forward argmax at "
        f"{rec['greedy_agree_where_clear']}/{rec['greedy_clear_positions']}"
        f" clear positions ({rec['greedy_agree_all']}/{b * gen} in all)"
        + (f", capacity factor {cfg.capacity_factor:g}"
           if cfg.num_experts else "")
        + f"; launches {rec['launches']}")
    return rec


def train_lm_case(torch, device, clock, counters, cfg, case, label):
    """``make_train_step`` with ZoloMuon on one arch at full width: one
    warm step and ``case["steps"]`` timed ones, seconds, tokens/s, the
    share in ``orthogonalize``, peak memory, and the K1/K2 launches of
    every timed step, which must equal the Muon plans' count; then the
    ``case["yardsticks"]`` leaves' updates on zolo_cuda against
    zolo_static (:func:`muon_yardstick`), and K1/K2 at each Muon shape
    against their plain versions (:func:`muon_kernel_times`)."""
    from repro_torch import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import muon as MU
    from repro_torch.train import step as TS

    on_card = device.type == "cuda"
    b, s = case["batch"], case["seq"]
    muon_cfg = MU.MuonConfig()
    init_fn, step_fn = TS.make_train_step(cfg, muon_cfg, total_steps=100,
                                          warmup=1)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    names, muon_leaves = muon_leaf_shapes(state.params)
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
           "seq": s, "params": M.param_count(state.params),
           "muon_leaves": {n: list(sh) for n, sh in muon_leaves},
           "solves_per_step": sum(math.prod(sh[:-2])
                                  for _, sh in muon_leaves)}
    data = SyntheticLM(cfg.vocab_size, s, b, dtype=cfg.dtype,
                       device=str(device))
    steps = []
    for i in range(1 + case["steps"]):
        batch = data.batch_at(i)
        with TrainProbe(clock) as probe:
            zero_counts(counters)
            clock.sync()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            clock.sync()
            secs = time.perf_counter() - t0
            launches = read_counts(counters)
            by_split = split_counts()
        m = {k: float(v) for k, v in metrics.items()}
        steps.append({"step": i, "seconds": secs, "update_s": probe.update_s,
                      "orthogonalize_s": probe.orth_s,
                      "fwd_bwd_s": secs - probe.update_s,
                      "launches": launches, "k1_by_split": by_split, **m})
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{label}: step {i} loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
        say(f"{label} {'warm' if i == 0 else 'timed'} step {i}: {secs:.3f} s"
            f" (forward+backward {secs - probe.update_s:.3f}, update "
            f"{probe.update_s:.3f} of which orthogonalize {probe.orth_s:.3f})"
            f", loss {m['loss']:.5f}, aux {m['aux_loss']:.5f}, K1 "
            f"{launches['gram']} (by split S {by_split}) K2 "
            f"{launches['grouped_combine']}")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card \
        else None
    rec["steps"] = steps
    timed = steps[1:]
    rec["step_s"] = sum(t["seconds"] for t in timed) / len(timed)
    rec["tokens_per_s"] = b * s / rec["step_s"]
    for k in ("update_s", "orthogonalize_s", "fwd_bwd_s"):
        rec[k] = sum(t[k] for t in timed) / len(timed)
    rec["orthogonalize_share"] = rec["orthogonalize_s"] / rec["step_s"]
    plans, want, rec["plans"] = muon_plans(muon_cfg, muon_leaves, device)
    rec["launches_per_step"] = timed[-1]["launches"]
    rec["launches_want"] = want
    check(all(p.method == "zolo_cuda" for p, _ in plans.values()),
          f"{label}: Muon plans {rec['plans']}")
    if on_card:
        for t in timed:
            check(t["launches"] == want, f"{label}: step {t['step']} "
                  f"launched {t['launches']}, expected {want}")
    del metrics, batch
    mus = dict(zip(names, tree.leaves(state.opt["mu"])))
    labelled = {n for n, _ in muon_leaves}
    sticks = [n for n in case.get("yardsticks", ()) if n in labelled]
    if on_card:  # the smoke configs of a rehearsal lack some of them
        check(len(sticks) == len(case.get("yardsticks", ())),
              f"{label}: yardsticks {case.get('yardsticks')} not all Muon "
              f"leaves {sorted(labelled)}")
    rec["yardsticks"] = [muon_yardstick(torch, device, clock, counters,
                                        muon_cfg, n, mus[n], label, f64=True)
                         for n in sticks]
    del mus, state
    rec["kernel_times"] = {
        f"{m_}x{n_}": muon_kernel_times(torch, device, clock, m_, n_,
                                        muon_cfg.r, label)
        for m_, n_ in sorted({(max(k), min(k)) for k in plans},
                             reverse=True)}
    if on_card:
        torch.cuda.empty_cache()
    prior = PRIOR_STEP_S.get(label)
    say(f"{label} {cfg.name} ({cfg.num_layers} layers, {rec['params']:,} "
        f"parameters), batch {b} x {s}: {rec['step_s']:.3f} s a step"
        + ("" if prior is None else f" (before K1's split and K2's single "
           f"launch: {prior} s)") + ", "
        f"{rec['tokens_per_s']:.1f} tokens/s, orthogonalize "
        f"{rec['orthogonalize_s']:.3f} s ({100 * rec['orthogonalize_share']:.1f}%"
        f" of the step), {rec['solves_per_step']} polar solves a step over "
        f"{len(plans)} plans {rec['plans']}; K1/K2 a step "
        f"{rec['launches_per_step']['gram']} / "
        f"{rec['launches_per_step']['grouped_combine']} (expected "
        f"{want['gram']} / {want['grouped_combine']}), peak "
        + ("not measured" if rec["peak_bytes"] is None
           else f"{rec['peak_bytes'] / 2**30:.2f} GiB"))
    return rec


def phase_serve_lm(torch, device, clock, cases):
    """Phase 20: LM serving through ``ServeEngine`` and the MoE, SSD and
    RG-LRU families, at full width (each config's depth cut as
    ``cases`` says): (a) qwen3-8b serving, (b) recurrentgemma-2b serving
    after a prompt longer than its window and not a multiple of it, (c)
    mamba2-130m serving and training, (d) moonshot-v1-16b-a3b training
    (Muon on the expert stacks) and serving."""
    import dataclasses

    t_phase = time.perf_counter()
    counters = kernel_modules()
    out = {}
    for label, case in cases.items():
        cfg = dataclasses.replace(case["cfg"], num_layers=case["layers"])
        for part in case["parts"]:
            say(f"== phase {label}: {part} {cfg.name} at full width "
                f"({case['cfg'].num_layers} layers cut to {cfg.num_layers})")
            if part == "serve":
                out[f"{label}_serve"] = serve_lm_case(
                    torch, device, clock, counters, cfg, case["serve"], label)
            else:
                out[f"{label}_train"] = train_lm_case(
                    torch, device, clock, counters, cfg, case["train"], label)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 20 ({out['seconds']:.1f} s)")
    return out



def place_state(cfg, state, batch, mesh):
    """(rules, the state and the batch placed by ``tree_shardings`` of
    ``arch_rules``) — each rank cuts its own shards (no collective)."""
    from repro_torch.dist import sharding as S
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import step as TS

    b, s = batch["tokens"].shape
    rules = S.arch_rules(cfg, mesh, ShapeConfig("train", "train", s, b))
    axes = TS.state_axes_for_params(cfg, state.params)
    placed = S.distribute_tree(state, S.tree_shardings(mesh, rules, axes),
                               src_data_rank=None)
    return rules, placed, place_batch(batch, rules)


def place_batch(batch, rules):
    from repro_torch.dist import sharding as S

    return S.distribute_tree(batch, S.tree_shardings(
        rules.mesh, rules, {"tokens": ("batch", None)}), src_data_rank=None)


def update_agreement(new_params, ref_params, old_params):
    """max over leaves of max|p - p_ref| / max|p_ref - p_old|: the
    difference of two updates of the same state relative to the update's
    size (for a Muon leaf, max|dQ|/max|Q|); ``ref_params`` may lie on the
    host.  Returns (the max, {leaf: ratio})."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree

    names, new, _ = tree.flatten_with_names(new_params)
    ratios = {}
    for name, x, r, p0 in zip(names, new, tree.leaves(ref_params),
                              tree.leaves(old_params)):
        x = x.full_tensor() if isinstance(x, DTensor) else x
        p0 = p0.full_tensor() if isinstance(p0, DTensor) else p0
        r = r.to(x.device)
        step = float((r.float() - p0.float()).abs().max())
        diff = float((x.float() - r.float()).abs().max())
        ratios[name] = diff / step if step else diff
    return max(ratios.values()), ratios


def phase_sharded_1x1(torch, device, clock, sizes, train_rec):
    """Phase 21a: phase 19's training case on a one-rank (1, 1)
    ("data", "model") mesh (NCCL on the card), placed by the rules and
    run under the hints.  Returns (its record, the momenta of the
    SHARDED_ROWS_CASES leaves after its last step, on the host)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding as S
    from repro_torch.launch.dryrun import CollectiveRecorder, mesh_group_axes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import muon as MU
    from repro_torch.train import step as TS

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    counters = kernel_modules()
    cfg, b, s = sizes["cfg"], sizes["batch"], sizes["seq"]
    say(f"== phase 21a: phase 19's {cfg.name} step on a (1, 1) ('data', "
        f"'model') mesh ({'nccl' if on_card else 'gloo'}), batch {b} x {s}, "
        "under activation_hints")
    scratch = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method="file://" + os.path.join(scratch,
                                                                 "init"),
                            rank=0, world_size=1)
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b, "seq": s}
    try:
        mesh = make_debug_mesh(1, 1, device_type=device.type)
        muon_cfg = MU.MuonConfig()
        init_fn, step_fn = TS.make_train_step(cfg, muon_cfg, total_steps=100,
                                              warmup=1)
        state = init_fn(torch.Generator(device=device).manual_seed(0))
        names, muon_leaves = muon_leaf_shapes(state.params)
        _, want, _ = muon_plans(muon_cfg, muon_leaves, device)
        data = SyntheticLM(cfg.vocab_size, s, b, dtype=cfg.dtype,
                           device=str(device))
        batch = data.batch_at(0)
        # the unsharded step from the same state; its parameters wait on
        # the host
        ref, ref_m = step_fn(state, batch)
        ref_m = {k: float(v) for k, v in ref_m.items()}
        ref_params = tree.map(lambda t: t.cpu(), ref.params)
        del ref
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        rules, placed, pbatch = place_state(cfg, state, batch, mesh)
        rec["placements"] = sorted({str(tuple(x.placements)) for x in
                                    tree.leaves(placed)})
        steps = []
        for i in range(3):
            if i:
                pbatch = place_batch(data.batch_at(i), rules)
            rec_mode = CollectiveRecorder(mesh_group_axes(mesh))
            zero_counts(counters)
            clock.sync()
            t0 = time.perf_counter()

            def run():
                with S.activation_hints(rules), rec_mode:
                    return step_fn(placed if i == 0 else new, pbatch)

            if i == 2 and on_card:
                (out, metrics), n_sync, sites = sync_sites(torch, run)
            else:
                out, metrics = run()
                n_sync, sites = None, {}
            clock.sync()
            secs = time.perf_counter() - t0
            m = {k: float(v) for k, v in metrics.items()}
            st = {"step": i, "seconds": secs,
                  "launches": read_counts(counters),
                  "collectives": len(rec_mode.records),
                  "syncs": n_sync, "sync_sites": sites, **m}
            steps.append(st)
            say(f"sharded step {i} ({['vs unsharded', 'timed', 'sync debug'][i]}"
                f"): {secs:.3f} s, loss {m['loss']:.6f}, grad norm "
                f"{m['grad_norm']:.6f}, K1 {st['launches']['gram']} K2 "
                f"{st['launches']['grouped_combine']}, collectives "
                f"{st['collectives']}"
                + (f", synchronising calls {n_sync} {sites}" if i == 2
                   else ""))
            if i == 0:
                worst, ratios = update_agreement(out.params, ref_params,
                                                 state.params)
                rec["vs_unsharded"] = {
                    "loss": [m["loss"], ref_m["loss"]],
                    "grad_norm": [m["grad_norm"], ref_m["grad_norm"]],
                    "max_update_diff": worst,
                    "worst_leaf": max(ratios, key=ratios.get)}
                say(f"21a vs the unsharded step: loss {m['loss']:.8g} / "
                    f"{ref_m['loss']:.8g}, grad norm {m['grad_norm']:.8g} / "
                    f"{ref_m['grad_norm']:.8g}, max|dp|/max|update| "
                    f"{worst:.3e} ({rec['vs_unsharded']['worst_leaf']})")
                for k in ("loss", "grad_norm"):
                    check(abs(m[k] - ref_m[k]) <= SHARDED_TOL * abs(ref_m[k]),
                          f"21a: {k} {m[k]} against the unsharded "
                          f"{ref_m[k]}")
                check(worst <= MUON_TOL, f"21a: an update differs by "
                      f"{worst:.3e} of its size: {ratios}")
                del placed, state, ref_params
            new = out
            check(math.isfinite(m["loss"]), f"21a: step {i} loss {m}")
            check(st["collectives"] == 0, f"21a: step {i} issued "
                  f"{st['collectives']} collectives on a one-rank mesh")
            if on_card:
                check(st["launches"] == want, f"21a: step {i} launched "
                      f"{st['launches']}, phase 19's plans say {want}")
        if on_card:
            check(steps[2]["syncs"] == 0, f"21a: {steps[2]['syncs']} "
                  f"synchronising calls in a step: {steps[2]['sync_sites']}")
        rec["steps"] = steps
        rec["launches_per_step"] = steps[1]["launches"]
        rec["launches_want"] = want
        rec["step_s"] = steps[1]["seconds"]
        rec["phase19_step_s"] = train_rec["step_s"]
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card \
            else None
        # 21b's inputs: the momenta of the last step, on the host
        mu_names, mu_leaves, _ = tree.flatten_with_names(new.opt["mu"])
        leaves = {leaf for leaf, _ in SHARDED_ROWS_CASES}
        momenta = {n_: (x.to_local() if isinstance(x, DTensor) else x)
                   .float().cpu()
                   for n_, x in zip(mu_names, mu_leaves) if n_ in leaves}
        del new, out, mu_leaves
    finally:
        dist.destroy_process_group()
        shutil.rmtree(scratch, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"phase 21a ({rec['seconds']:.1f} s): a step {rec['step_s']:.3f} s "
        f"on the (1, 1) mesh against phase 19's {rec['phase19_step_s']:.3f}"
        f" s unsharded; peak "
        + ("not measured" if rec["peak_bytes"] is None
           else f"{rec['peak_bytes'] / 2**30:.2f} GiB"))
    return rec, momenta


# --- phase 21b: ZoloMuon's row-split solve on gloo ranks sharing the card ---


def mesh_groups(torch, world, data, model):
    """This rank's ("data", "model") process groups of a (data, model)
    mesh over ``world`` ranks laid out data-major (rank = d * model + m),
    as ``init_device_mesh`` lays them; every rank creates every group, in
    the same order.  Returns (data group, model group, d, m)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    check(data * model == world, f"mesh {(data, model)} on {world} ranks")
    d, m = divmod(rank, model)
    mine = {}
    for axis, members in (
            ("data", [[i * model + j for i in range(data)]
                      for j in range(model)]),
            ("model", [[i * model + j for j in range(model)]
                       for i in range(data)])):
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = g
    return mine["data"], mine["model"], d, m


def sharded_rows_run(torch, rank, device, cases):
    """One rank of 21b: per case, its block of the momentum stack (its
    "model" slice of the stack, its "data" block of the long dimension),
    the row-split solve on it with the kernels counted and the all-reduces
    counted per mesh axis, Q gathered over "data" (a plain c10d
    all-gather), and this rank's matrices solved whole by the zolo_cuda
    and zolo_static plans for the yardstick."""
    import dataclasses

    import torch.distributed as dist

    import repro_torch.solver as S
    from repro_torch.optim import muon as MU

    counters = kernel_modules()
    muon_cfg = MU.MuonConfig()
    world = dist.get_world_size()
    groups, out = {}, {"rank": rank, "cases": []}
    for case in cases:
        data, model = case["mesh"]
        if (data, model) not in groups:
            groups[(data, model)] = mesh_groups(torch, world, data, model)
        g_data, g_model, d, m = groups[(data, model)]
        mu = torch.load(case["path"], mmap=True, weights_only=True)
        s, rows, cols = mu.shape
        per = s // model
        long_dim = 1 if rows >= cols else 2
        blk = mu.shape[long_dim] // data
        mine = mu[m * per:(m + 1) * per]
        local = mine.narrow(long_dim, d * blk, blk).to(device).contiguous()
        plan = MU._polar_plan(muon_cfg.method, rows, cols, muon_cfg.r,
                              muon_cfg.l0, muon_cfg.max_iters,
                              muon_cfg.polar_dtype, str(device))
        counter = CollectiveCounter(axes={id(g_data): "data",
                                          id(g_model): "model"})
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        with counter:
            q = plan._polar_rows_batched(local, group=g_data, index=d)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(counters)
        qm = q.movedim(long_dim, 0).contiguous()
        full = torch.empty((blk * data,) + tuple(qm.shape[1:]),
                           dtype=qm.dtype, device=device)
        dist.all_gather_into_tensor(full, qm, group=g_data)
        q_full = full.movedim(0, long_dim)
        a = mine.to(device)
        q_cuda = plan.polar_batched(a, want_h=False)[0]
        p_static = S.plan(dataclasses.replace(plan.config,
                                              method="zolo_static"),
                          (rows, cols), torch.float32, device=device)
        q_static = p_static.polar_batched(a, want_h=False)[0]
        n = min(rows, cols)
        rec = {"leaf": case["leaf"], "mesh": [data, model],
               "coords": [d, m], "local_shape": list(local.shape),
               "iterations": len(plan.schedule), "r": plan.r,
               "seconds": secs, "launches": launches,
               "all_reduces": counter.record(("data", "model"), n * n * 4),
               "err_vs_zolo_cuda": float((q_full - q_cuda).abs().amax()
                                         / q_cuda.abs().amax()),
               "err_vs_zolo_static": float((q_full - q_static).abs().amax()
                                           / q_static.abs().amax()),
               "checksum": float(q_full.double().sum())}
        out["cases"].append(rec)
        del mu, mine, local, q, qm, full, q_full, a, q_cuda, q_static
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sharded_rows_rank(rank, world, init, dev_type, cases, queue):
    """One rank of phase 21b (a spawned process): join the gloo world,
    run the cases, put the record (or the traceback) on ``queue``."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, os.path.join(HERE, "src"))
        torch.set_num_threads(1)
        device = torch.device(dev_type, 0) if dev_type == "cuda" else \
            torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUPED_TIMEOUT))
        try:
            queue.put(sharded_rows_run(torch, rank, device, cases))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def phase_sharded_rows(torch, device, clock, momenta):
    """Phase 21b: ZoloMuon's row-split solve on SHARDED_ROWS_WORLD gloo
    ranks sharing the device, on ``momenta`` (21a's, {leaf: (s, rows,
    cols)} on the host), one SHARDED_ROWS_CASES entry at a time; then K1
    and K2 at each rank block's canonical shape against their plain
    versions (not counted: the ranks' counts are the path's)."""
    import tempfile

    from repro_torch.analysis.plan_audit import MODE_SEP_PSUMS
    from repro_torch.optim import muon as MU

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    say(f"== phase 21b: ZoloMuon's row-split solve on {SHARDED_ROWS_WORLD} "
        f"gloo ranks on {device}: "
        + "; ".join(f"{leaf} {tuple(momenta[leaf].shape)} on (data, model)"
                    f" = {mesh}" for leaf, mesh in SHARDED_ROWS_CASES))
    if on_card:
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    try:
        paths = {}
        for leaf in {leaf for leaf, _ in SHARDED_ROWS_CASES}:
            paths[leaf] = os.path.join(tmp, leaf.replace("/", "_") + ".pt")
            torch.save(momenta[leaf].contiguous(), paths[leaf])
        cases = [{"leaf": leaf, "mesh": list(mesh), "path": paths[leaf]}
                 for leaf, mesh in SHARDED_ROWS_CASES]
        recs, secs = spawn_ranks(torch, sharded_rows_rank,
                                 (device.type, cases), SHARDED_ROWS_WORLD,
                                 SHARDED_ROWS_DEADLINE, "phase 21b")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    muon_cfg = MU.MuonConfig()
    out = {"seconds": secs, "world": SHARDED_ROWS_WORLD, "cases": []}
    shapes = set()
    for i, (leaf, (data, model)) in enumerate(SHARDED_ROWS_CASES):
        s_, rows, cols = momenta[leaf].shape
        plan = MU._polar_plan(muon_cfg.method, rows, cols, muon_cfg.r,
                              muon_cfg.l0, muon_cfg.max_iters,
                              muon_cfg.polar_dtype, str(device))
        count = s_ // model
        iters = len(plan.schedule)
        want = muon_launch_want([(plan, count)])
        grams = count * (MODE_SEP_PSUMS["cholqr2"]
                         + MODE_SEP_PSUMS["chol"] * (iters - 1))
        rows_ = [recs[r]["cases"][i] for r in sorted(recs)]
        label = f"21b {leaf} on ({data}, {model})"
        for r, c in enumerate(rows_):
            ar = c["all_reduces"]
            say(f"{label} rank {r} {tuple(c['local_shape'])}: "
                f"{c['seconds']:.3f} s, K1 {c['launches']['gram']} K2 "
                f"{c['launches']['grouped_combine']}, all-reduces over data "
                f"{ar['data']} ({ar['data_grams']} Grams, "
                f"{ar['data_bytes']:,} B), over model {ar['model']}, other "
                f"{ar['other']}; Q gathered over data vs single-rank "
                f"zolo_cuda {c['err_vs_zolo_cuda']:.3e}, vs zolo_static "
                f"{c['err_vs_zolo_static']:.3e}")
            check(c["err_vs_zolo_cuda"] <= MUON_TOL
                  and c["err_vs_zolo_static"] <= MUON_TOL,
                  f"{label} rank {r}: Q differs by "
                  f"{c['err_vs_zolo_cuda']:.3e} (zolo_cuda) / "
                  f"{c['err_vs_zolo_static']:.3e} (zolo_static)")
            check(ar["data_grams"] == grams and ar["data"] == grams
                  + count * 9 and ar["model"] == 0 and ar["other"] == 0,
                  f"{label} rank {r}: all-reduces {ar}, expected {grams} "
                  f"Grams and {count * 9} prescale ones over data, none "
                  "over model")
            if on_card:
                check(c["launches"] == want, f"{label} rank {r}: launched "
                      f"{c['launches']}, the plan says {want}")
            shapes.add(tuple(c["local_shape"][1:]) if rows >= cols
                       else tuple(c["local_shape"][:0:-1]))
        for m in range(model):
            sums = {c["checksum"] for c in rows_ if c["coords"][1] == m}
            check(len(sums) == 1, f"{label}: the ranks of model slice {m} "
                  f"gathered different factors {sums}")
        out["cases"].append({"leaf": leaf, "mesh": [data, model],
                             "launches_want": want, "grams_want": grams,
                             "ranks": rows_})
    # K1 and K2 at the ranks' block shapes (canonical: m >= n may not
    # hold for a block), against their plain versions
    out["kernel_times"] = {
        f"{m_}x{n_}": muon_kernel_times(torch, device, clock, m_, n_,
                                        muon_cfg.r, "21b block")
        for m_, n_ in sorted(shapes)}
    out["phase_seconds"] = time.perf_counter() - t_phase
    say(f"phase 21b: {out['phase_seconds']:.1f} s ({secs:.1f} s of ranks)")
    return out


# 21c's small cells: every step kind of the smoke config of the
# reference's small-mesh test (tests/test_dryrun_unit.py) on a (1, 1)
# fake mesh
DRYRUN_SMALL = r"""
import json, sys
from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.config import ShapeConfig
D.init_fake_process_group()
mesh = make_debug_mesh(1, 1, device_type="cpu")
cfg = C.get_smoke_config("recurrentgemma-2b")
for kind in ("train", "prefill", "decode"):
    D.run_cell(cfg.name, ShapeConfig(f"smoke_{kind}", kind, 64, 2), False,
               sys.argv[1], mesh=mesh, cfg=cfg)
"""


def phase_dryrun(torch):
    """Phase 21c: the dry-run CLI on DRYRUN_CELL on the (16, 16) fake
    mesh, plain and --optimized, and the small cells (DRYRUN_SMALL), in
    three subprocesses at once."""
    import tempfile

    arch, shape = DRYRUN_CELL
    say(f"== phase 21c: python -m repro_torch.launch.dryrun --arch {arch} "
        f"--shape {shape} [--optimized] on the (16, 16) fake mesh, and the "
        "recurrentgemma-2b smoke config's train, prefill and decode cells "
        "on a (1, 1) fake mesh")
    out = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out] + flag, cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for flag in ([], ["--optimized"])]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", DRYRUN_SMALL, out], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DRYRUN_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    secs = time.perf_counter() - t0
    check(all(p.returncode == 0 for p in procs),
          f"21c: the dry-run exited {[p.returncode for p in procs]}: "
          f"{[e[-2000:] for _, e in logs]}")
    rec = {"seconds": secs}
    for opt in (False, True):
        fn = os.path.join(out, f"{arch}__{shape}__16_16"
                          f"{'__opt' if opt else ''}.json")
        with open(fn) as f:
            cell = json.load(f)
        cell.pop("trace", None)
        key = "optimized" if opt else "plain"
        rec[key] = cell
        check(cell["status"] == "ok", f"21c: {key} cell {cell['status']}: "
              f"{cell.get('error')}")
        coll = cell["collectives"]
        say(f"21c {key}: {cell['run_s']} s run, {cell['total_s']} s in all;"
            f" per rank: flops {cell['cost']['flops']:.4g}, argument bytes "
            f"{cell['memory']['argument_size_in_bytes']:,}; "
            + "; ".join(f"{k} {coll[k]['count']} / {coll[k]['bytes']:,} B"
                        for k in ("all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"))
            + f"; by axis {cell['collectives_by_axis']}")
    check(rec["optimized"]["collectives_by_axis"].get("data", {}).get(
        "all-reduce", 0) > 0, "21c: no all-reduce over data in the "
        "optimized cell")
    rec["small"] = {}
    for kind in ("train", "prefill", "decode"):
        fn = f"recurrentgemma-2b__smoke_{kind}__1_1.json"
        with open(os.path.join(out, fn)) as f:
            cell = json.load(f)
        rec["small"][fn] = {k: cell.get(k) for k in (
            "status", "error", "run_s", "cost", "memory")}
        say(f"21c small cell {fn}: {cell['status']} "
            f"{cell.get('error', '')[-300:]}")
        check(cell["status"] == "ok", f"21c: {fn} {cell['status']}")
    shutil.rmtree(out, ignore_errors=True)
    say(f"phase 21c: {secs:.1f} s for the three runs")
    return rec


# --- phase 22: the linter and the six examples on the card ------------------


def phase_lint():
    """Phase 22a: the port's linter CLI over src/repro_torch against its
    committed baseline, and its rule list, in subprocesses (no JAX is
    needed, nor torch)."""
    say("== phase 22a: python -m repro_torch.analysis src/repro_torch "
        "--baseline lint-baseline-torch.json --format=json")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cli = [sys.executable, "-m", "repro_torch.analysis"]
    t0 = time.perf_counter()
    out = subprocess.run(
        cli + ["src/repro_torch", "--baseline", "lint-baseline-torch.json",
               "--format=json"], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=LINT_TIMEOUT)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"22a: the linter exited {out.returncode}: "
          f"{out.stdout[-3000:]} {out.stderr[-2000:]}")
    rep = json.loads(out.stdout)
    listed = subprocess.run(cli + ["--list-rules"], cwd=HERE, env=env,
                            capture_output=True, text=True,
                            timeout=LINT_TIMEOUT)
    check(listed.returncode == 0, f"22a: --list-rules exited "
          f"{listed.returncode}: {listed.stderr[-2000:]}")
    rules = [line.split(":", 1)[0] for line in listed.stdout.splitlines()]
    import importlib.util

    rec = {"files": rep["files"], "findings": rep["findings"],
           "errors": rep["errors"], "baselined": len(rep["baselined"]),
           "suppressed": rep["suppressed"],
           "stale_baseline": rep["stale_baseline"], "rules": rules,
           "seconds": secs,
           "jax_installed": importlib.util.find_spec("jax") is not None}
    say(f"22a: {rep['files']} files, {len(rep['findings'])} findings, "
        f"{len(rep['errors'])} errors, {rec['baselined']} baselined, "
        f"{rep['suppressed']} suppressed, {len(rules)} rules {rules}; "
        f"{secs:.2f} s (JAX installed: {rec['jax_installed']})")
    check(rep["ok"] and rep["findings"] == [] and rep["errors"] == []
          and rep["stale_baseline"] == [],
          f"22a: the port is not lint clean: {rep}")
    check(len(rules) == LINT_RULES, f"22a: {len(rules)} rules, expected "
          f"{LINT_RULES}: {rules}")
    return rec


def load_example(name):
    """The module of examples/torch_<name>.py."""
    import importlib.util

    path = os.path.join(HERE, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, counters, name, runs):
    """Drive examples/torch_<name>.py in this process: ``main(argv)`` for
    each argv of ``runs``, under the example's deadline, its output
    captured (and echoed), every launch count set to 0 just before the
    first run and read just after the last.  The signal handlers a run
    installs (the training loop's) are put back.  Returns (the outputs,
    the printed text of each run, launches, wall seconds)."""
    import contextlib
    import io
    import signal

    mod = load_example(name)
    limit = EXAMPLE_TIMEOUT[name]

    def expire(signum, frame):
        raise TimeoutError(f"22b: torch_{name}.py did not finish within "
                           f"{limit} s")

    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGALRM)}
    outs, texts = [], []
    zero_counts(counters)
    t0 = time.perf_counter()
    signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        for argv in runs:
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    outs.append(mod.main(argv))
            finally:
                texts.append(buf.getvalue())
                say(buf.getvalue().rstrip())
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    except Exception as e:
        fail(f"22b: torch_{name}.py {runs[len(texts) - 1]} raised {e!r}")
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    secs = time.perf_counter() - t0
    return outs, texts, read_counts(counters), secs


def run_example_ranks(device, args):
    """examples/torch_distributed_svd.py as a script (its ranks are its
    children), in a session of its own so that a deadline stops the
    ranks too.  Returns (stdout, wall seconds)."""
    import signal

    limit = EXAMPLE_TIMEOUT["distributed_svd"]
    cmd = [sys.executable,
           os.path.join(HERE, "examples", "torch_distributed_svd.py"),
           "--device", device.type] + args
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        fail(f"22b: torch_distributed_svd.py did not finish within "
             f"{limit} s")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait(10)
    secs = time.perf_counter() - t0
    say(out.rstrip())
    check(p.returncode == 0, f"22b: torch_distributed_svd.py exited "
          f"{p.returncode}: {err[-4000:]}")
    return out, secs


def printed_values(text, key):
    """The numbers printed as ``key=value`` (or ``key: value``)."""
    vals = []
    for line in text.splitlines():
        for part in line.replace(":", "=").split():
            if part.startswith(key + "="):
                vals.append(float(part.split("=", 1)[1]))
    return vals


def phase_examples(torch, device, rehearse, lm_rec):
    """Phase 22b: the six examples at their own defaults on the card (at
    toy size in a rehearsal), each checked against the reference's limits,
    with its wall seconds and, where it runs in this process, its K1-K4
    launches."""
    import ast

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    counters = kernel_modules()
    dev = ["--device", str(device)]
    small = EXAMPLE_REHEARSAL if rehearse else {}
    train = small.get("train_lm", EXAMPLE_TRAIN)
    rec = {}
    zero = {k: 0 for k in read_counts(counters)}

    def done(name, secs, launches, **extra):
        rec[name] = dict(extra, seconds=secs, launches=launches)
        if isinstance(launches, dict):
            ran = {k: v for k, v in launches.items() if v}
            launches = f"K1 {launches['gram']} / K2 " \
                f"{launches['grouped_combine']}, every kernel {ran}"
        say(f"22b {name}: {secs:.1f} s; launches {launches}")

    say("== phase 22b: examples/torch_quickstart.py")
    (out,), _, launches, secs = run_example(
        torch, counters, "quickstart", [dev + small.get("quickstart", [])])
    done("quickstart", secs, launches, method=out["method"],
         **{k: out[k] for k in ("residual", "orth_u", "sigma_err",
                                "zolo_iterations", "zolo_orth",
                                "zolo_rec", "qdwh_iterations")})
    check(out["residual"] < F64_REC_TOL and out["sigma_err"] < F64_REC_TOL
          and out["orth_u"] < F64_ORTH_TOL and out["zolo_orth"]
          < F64_ORTH_TOL and out["zolo_rec"] < F64_REC_TOL,
          f"22b quickstart: beyond the f64 limits {rec['quickstart']}")
    check(out["qdwh_iterations"] >= out["zolo_iterations"],
          f"22b quickstart: QDWH took fewer iterations than Zolo-PD "
          f"{rec['quickstart']}")
    check(launches == zero, f"22b quickstart: an f64 solve launched "
          f"{launches}")

    say("== phase 22b: examples/torch_distributed_svd.py (8 gloo ranks"
        + (" sharing the card)" if on_card else ")"))
    text, secs = run_example_ranks(device,
                                   small.get("distributed_svd", []))
    orth, rec_err = printed_values(text, "orth"), printed_values(text, "rec")
    s_err = [float(line.rsplit(":", 1)[1]) for line in text.splitlines()
             if "singular-value error vs LAPACK" in line]
    done("distributed_svd", secs, "not counted (its ranks are child "
         "processes)", orth=orth, rec=rec_err, sigma_err=s_err,
         retraces=printed_values(text, "retraces"))
    check("ranks: 8 (gloo" in text and len(orth) == 4 and len(rec_err) == 2
          and len(s_err) == 2, f"22b distributed_svd: unexpected output "
          f"{text[-3000:]}")
    check(max(orth) < F64_ORTH_TOL and max(rec_err) < F64_REC_TOL
          and max(s_err) < F64_REC_TOL and printed_values(
              text, "retraces") == [0.0, 0.0],
          f"22b distributed_svd: beyond the f64 limits "
          f"{rec['distributed_svd']}")

    say("== phase 22b: examples/torch_svd_serve.py")
    (out,), _, launches, secs = run_example(torch, counters, "svd_serve",
                                            [dev])
    done("svd_serve", secs, launches, **out)
    check(out["solves"] == 24 and out["retraces"] == 0
          and out["hit_rate"] == 1.0
          and out["worst_rec"]["float64"] < F64_REC_TOL
          and out["worst_rec"]["float32"] < ACCURACY_TOL,
          f"22b svd_serve: {out}")

    say("== phase 22b: examples/torch_svd_topk.py")
    (out,), _, launches, secs = run_example(
        torch, counters, "svd_topk", [dev + small.get("svd_topk", [])])
    done("svd_topk", secs, launches, **out)
    check(out["strategy"] == "sketch" and out["near_full_strategy"]
          == "dense" and out["rel_err"] <= TOPK_S_RTOL
          and out["adaptive"]["residual"] <= TOPK_RESIDUAL_TOL
          and not out["adaptive"]["escalated"] and out["solves"] == 4
          and out["retraces"] == 0, f"22b svd_topk: {out}")

    first, second = train["steps"]
    say(f"== phase 22b: examples/torch_train_lm.py"
        f"{'' if rehearse else ' --full'} --batch {train['batch']} --seq "
        f"{train['seq']}: {first} steps, then resumed to {second}")
    ckpt_dir = os.path.join(HERE, "build", "example_train_lm")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = dev + ["--batch", str(train["batch"]), "--seq",
                  str(train["seq"]), "--ckpt-dir", ckpt_dir] + \
        ([] if rehearse else ["--full"])
    outs, texts, launches, secs = run_example(
        torch, counters, "train_lm", [args + ["--steps", str(first)],
                                      args + ["--steps", str(second)]])
    losses = [ast.literal_eval(line)["loss"] for t in texts
              for line in t.splitlines() if line.startswith("{'step'")]
    done("train_lm", secs, launches, runs=outs, losses=losses)
    check(outs[0]["start_step"] == 0 and outs[0]["step"] == first
          and outs[0]["latest_ckpt"] == first
          and "resumed" not in texts[0], f"22b train_lm: {outs[0]}")
    check(f"[loop] resumed from step {first}" in texts[1]
          and outs[1]["start_step"] == first and outs[1]["step"] == second,
          f"22b train_lm: no resume from step {first}: {outs[1]}")
    check(losses and all(math.isfinite(v) for v in losses),
          f"22b train_lm: a logged loss is not finite {losses}")
    if on_card:
        per_step = lm_rec["20c_train"]["launches_per_step"]
        want = {k: second * per_step[k] for k in ("gram",
                                                  "grouped_combine")}
        check({k: launches[k] for k in want} == want,
              f"22b train_lm: K1/K2 {launches} over {second} steps, "
              f"expected phase 20c's per step ({per_step}) times {second}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    say("== phase 22b: examples/torch_serve_lm.py")
    (out,), _, launches, secs = run_example(
        torch, counters, "serve_lm", [dev + small.get("serve_lm", [])])
    done("serve_lm", secs, launches, archs=out)
    gen = 4 if rehearse else 48
    check(len(out) == 4 and all(r_["in_vocab"] and r_["shape"][1] == gen
                                for r_ in out.values()),
          f"22b serve_lm: {out}")
    check(launches == zero, f"22b serve_lm: serving launched {launches}")
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"phase 22b ({rec['seconds']:.1f} s): "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in rec.items()
                    if isinstance(v, dict)))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run every phase but the build on the CPU at a "
                         "tiny size (the wrappers then run their plain "
                         "versions); prints no ok line")
    ap.add_argument("--profile-split", action="store_true",
                    help="also split one phase-5 solve, and one 17b solve "
                         "on rank 0, by device time under torch.profiler "
                         "(about 90 s more on the card)")
    ap.add_argument("--k5-only", action="store_true",
                    help="run phases 1, 2 and 4c (K5) alone")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import configs as CFG

    device = torch.device("cpu") if args.rehearse_cpu else \
        torch.device("cuda", 0)
    if device.type == "cuda":
        n, ragged, attn = N, RAGGED, ATTN
        mm_ragged, s_ragged = MM_RAGGED, ATTN_RAGGED_S
        mm_aligned, mm_transposed = MM_ALIGNED, MM_TRANSPOSED
        baseline_n, batch_n, topk_k, dnc_n = BASELINE_N, BATCH_N, TOPK_K, \
            DNC_N
        cpsum = (CPSUM_N, CPSUM_RANK)
        serve = {"shapes": SERVE_SHAPES, "requests": SERVE_REQUESTS,
                 "rate": SERVE_RATE, "full_base": SERVE_FULL_BASE,
                 "topk": SERVE_TOPK, "topk_n": SERVE_TOPK_N,
                 "fault_n": SERVE_FAULT_N}
        train_cfg, train_b, train_s = CFG.get_config(TRAIN_ARCH), \
            TRAIN_BATCH, TRAIN_SEQ
        serve_lm = {k: dict(v, cfg=CFG.get_config(v["arch"]))
                    for k, v in SERVE_LM.items()}
        split_sets = (K1_SPLIT_SHAPES, K1_EDGE_SHAPES, K1_UNSPLIT_SHAPES)
        muon_shapes = K1_SPLIT_SHAPES + K1_MUON_UNSPLIT_SHAPES
    else:
        split_sets = (((256, 40), (130, 64)), ((129, 33), (5, 16)), ())
        muon_shapes = ((256, 40), (130, 64))
        n, ragged, attn = 160, (50, 17), {"b": 1, "s": 96, "h": 4, "d": 16}
        mm_ragged, s_ragged = (37, 29, 41), 80
        mm_aligned, mm_transposed = 168, 64
        baseline_n, batch_n, topk_k, dnc_n = 128, 64, 8, 128
        cpsum = (128, 8)
        serve = {"shapes": ((96, 64), (90, 60), (60, 90), (48, 48)),
                 "requests": 8, "rate": 50.0, "full_base": n + 1,
                 "topk": 8, "topk_n": 96, "fault_n": 48}
        train_cfg, train_b, train_s = CFG.get_smoke_config(TRAIN_ARCH), 2, \
            64
        serve_lm = {}
        for k, v in SERVE_LM.items():
            small = SERVE_LM_REHEARSAL[k]
            serve_lm[k] = dict(v, cfg=CFG.get_smoke_config(v["arch"]),
                               layers=small["layers"])
            for part in v["parts"]:
                serve_lm[k][part] = dict(v[part], **small[part])
    train = {"cfg": dataclasses.replace(train_cfg, num_layers=TRAIN_LAYERS),
             "batch": train_b, "seq": train_s, "steps": TRAIN_STEPS}
    clock = Clock(torch, device)

    t_start = time.perf_counter()
    record = {"device": phase_device(torch, device)}
    if device.type == "cuda":
        record["build"] = phase_build()
    if args.k5_only:
        record["k5"] = phase_k5(torch, device, clock, n, R)
        record["seconds"] = time.perf_counter() - t_start
        out_dir = os.path.join(HERE, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_k5.json"), "w") as f:
            json.dump(record, f, indent=1, default=str)
        say(json.dumps({"k5": record["k5"]["full"]}))
        if device.type == "cuda":
            say(record["device"]["nvidia_smi"])
        return 0
    record["parity"], tensors, paths = phase_parity(
        torch, device, n, ragged, attn, mm_ragged, s_ragged, mm_aligned,
        mm_transposed)
    record["split_parity"] = phase_split_parity(torch, device, *split_sets)
    times = phase_times(torch, device, clock, tensors, n, attn, mm_aligned)
    del tensors
    times["muon"] = phase_times_muon(torch, device, clock, muon_shapes)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["k5"] = phase_k5(torch, device, clock, n, R)
    record["times"] = times
    record["path_launches"] = paths
    main_rec, a, s_true, s_main = phase_main(torch, device, clock, n)
    record["main"] = main_rec
    dyn_rec, s_dyn = phase_dynamic(torch, device, clock, a, s_true)
    record["dynamic"] = dyn_rec
    record["bf16_compute"] = bf_rec = phase_bf16(torch, device, clock, a,
                                                 s_true)
    record["dynamic_default"] = dd_rec = phase_dynamic_default(
        torch, device, clock, a, s_true, s_dyn)
    del s_dyn
    record["householder_static"] = hh_rec = phase_householder_static(
        torch, device, clock, a, s_true)
    record["qdwh"] = phase_qdwh(
        torch, device, clock, a, s_true,
        {"qdwh_static": main_rec["timed_s"], "qdwh": dyn_rec["timed_s"]})
    record["baselines"] = base_rec = phase_baselines(torch, device, clock,
                                                     baseline_n)
    record["resilience"] = res_rec = phase_resilience(
        torch, device, clock, a, s_true, main_rec, batch_n)
    record["envelope"] = env_rec = phase_envelope(torch, device, clock, n)
    record["topk"] = topk_rec = phase_topk(torch, device, clock, a, s_true,
                                           topk_k, dnc_n)
    if args.profile_split:
        record["profile_static"] = phase_profile(torch, device, clock, a)
    record["grouped"] = grouped_rec = phase_grouped(
        torch, device, n, s_main.tolist(), cpsum, args.profile_split)
    record["serve"] = serve_rec = phase_serve(torch, device, clock, a,
                                              s_main, main_rec, serve)
    del a
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["train"] = train_rec = phase_train(torch, device, clock, train)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["serve_lm"] = lm_rec = phase_serve_lm(torch, device, clock,
                                                 serve_lm)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["sharded_1x1"], momenta = phase_sharded_1x1(
        torch, device, clock, train, train_rec)
    sh1_rec = record["sharded_1x1"]
    record["sharded_rows"] = rows_rec = phase_sharded_rows(
        torch, device, clock, momenta)
    del momenta
    record["dryrun"] = phase_dryrun(torch)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["lint"] = phase_lint()
    record["examples"] = ex_rec = phase_examples(
        torch, device, args.rehearse_cpu, lm_rec)
    record["seconds"] = time.perf_counter() - t_start

    def muon_row(t):
        row = {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "max_rel_err")}
        row.update({k: t[k] for k in ("slices", "tile", "col_ms",
                                      "col_copy_ms") if k in t})
        for k in ("device", "library_device"):
            if t.get(k) is not None:
                row[f"{k}_ms"] = t[k]["ms"]
        return row

    kernels = []
    sources = {"gram": ("src/repro_torch/kernels/csrc/gram.cu",
                        "src/repro/kernels/gram.py:41"),
               "grouped_combine": (
                   "src/repro_torch/kernels/csrc/grouped_combine.cu",
                   "src/repro/kernels/grouped_combine.py:36"),
               "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:22"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:31")}
    # per record: (kernel, route or None, its times, its parity case, the
    # path whose launches it reports: a solve, or its kernels.ops entry)
    solves = {name: rec["launches_per_solve"] for name, rec in (
        ("static_solve", main_rec), ("dynamic_solve", dyn_rec),
        ("bf16_compute_solve", bf_rec), ("dynamic_default_solve", dd_rec),
        ("householder_static_solve", hh_rec),
        (f"jacobi_eig_solve_n{baseline_n}", base_rec["zolo_cuda+jacobi"]),
        ("verified_solve", res_rec["verified"]),
        (f"batched_verified_4x{batch_n}", res_rec["batched"]))}
    solves.update({
        "escalation_nan_fault": sum_launches(res_rec["nan_fault"]["trail"]),
        "escalation_dynamic_default": sum_launches(
            res_rec["dynamic_default"]["trail"]),
        "kappa_sweep": env_rec["launches"],
        "topk_sketch": topk_rec["sketch"]["launches"],
        "topk_dense": topk_rec["dense"]["launches"],
        "topk_auto": topk_rec["auto"]["launches"],
        "topk_adaptive": topk_rec["adaptive"]["launches"],
        f"topk_dnc_n{dnc_n}": topk_rec["dnc"]["launches"],
        "lowrank_truncate": topk_rec["lowrank_truncate"]["launches"]})
    # phase 17, per rank (every rank's counts were checked equal)
    g0 = grouped_rec["ranks"][0]
    solves.update({"grouped_static_4x1": g0["17a"]["launches"],
                   "grouped_static_2x2": g0["17b"]["launches"],
                   "grouped_dynamic_2x2": g0["17c"]["launches"],
                   "grouped_dynamic_pinned_2x2": g0["17f"]["launches"],
                   "escalation_grouped_2x2": g0["17d"]["launches"],
                   "grouped_audit_4x1": g0["17a"]["audit"]["launches"]})
    # phase 18: the service's paths and the plan audits
    solves.update({"serve_stream": serve_rec["stream"]["launches"],
                   "serve_full_width": serve_rec["full_width"]["launches"],
                   "serve_topk": serve_rec["topk"]["launches"],
                   "serve_retry": serve_rec["resilience"]["launches"],
                   "audit_static": serve_rec["audit_static"]["launches"],
                   "audit_dynamic_default":
                       serve_rec["audit_dynamic_default"]["launches"]})
    # phase 19: one timed train step (every timed step was checked equal)
    # and the launcher's two runs
    solves.update({f"train_step_{TRAIN_ARCH}":
                       train_rec["launches_per_step"],
                   "launch_train_smoke": train_rec["launcher"]["launches"]})
    # phase 20: each generate call, and one timed train step
    for key, r_ in lm_rec.items():
        if key.endswith("_serve"):
            solves[f"serve_{r_['arch']}"] = r_["launches"]
        elif key.endswith("_train"):
            solves[f"train_step_{r_['arch']}"] = r_["launches_per_step"]
    # phase 21: a sharded step on the (1, 1) mesh
    solves[f"train_step_sharded_1x1_{TRAIN_ARCH}"] = \
        sh1_rec["launches_per_step"]
    # 21b: rank 0's row-split solves, per case
    for case in rows_rec["cases"]:
        d_, m_ = case["mesh"]
        leaf = case["leaf"].rsplit("/", 1)[-1]
        solves[f"muon_sharded_{d_}x{m_}_{TRAIN_ARCH}_{leaf}_rank0"] = \
            case["ranks"][0]["launches"]
    # phase 22b: each example (its runs together; the distributed one's
    # ranks are children and are not counted)
    for name, r_ in ex_rec.items():
        if isinstance(r_, dict):
            solves[f"example_{name}"] = r_["launches"]
    entries = [("gram", "simt", times["gram"]["simt"],
                "f32 %dx%d c=0" % (n, n), "static_solve"),
               ("gram", "wgmma", times["gram"]["wgmma"],
                "bf16 %dx%d (staged) c=0" % (n, n), "bf16_compute_solve"),
               ("grouped_combine", None, times["grouped_combine"],
                "f32 r=%d xw=1" % R, "static_solve"),
               ("matmul", "simt", times["matmul"]["simt"],
                "f32 %dx%d" % (n, n), None),
               ("matmul", "wgmma", times["matmul"]["wgmma"],
                "bf16 %dx%d (staged)" % (n, n), None),
               ("flash_attention", "wgmma", times["flash_attention"]["wgmma"],
                "bf16 s=%d" % attn["s"], None),
               ("flash_attention", "simt", times["flash_attention"]["simt"],
                "f32 s=%d" % attn["s"], None)]
    for name, route, t, case, main_path in entries:
        src, replaces = sources[name]
        key = name if route is None else f"{name}/{route}"
        err = next(row["max_abs_err"] for row in record["parity"]
                   if row["kernel"] == name and row["case"] == case)
        by_path = {p: counts[key] if isinstance(counts, dict) else counts
                   for p, counts in solves.items()}
        if key in paths:
            # its own path: its kernels.ops entry, driven once per route
            by_path[f"kernels.ops.{name}"] = paths[key][key]
        launches = by_path[main_path or f"kernels.ops.{name}"]
        rec = {"name": key, "route": "cuda", "kernel_route": route,
               "source": src, "replaces": replaces, "launches": launches,
               "launches_by_path": by_path, "max_abs_err": err,
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "case": t["shape"]}
        if "slices" in t:
            rec["slices"] = t["slices"]
        for k in ("device", "library_device"):
            if t.get(k) is not None:
                rec[f"{k}_ms"] = t[k]["ms"]
        if key == "gram/wgmma":
            rec["staging_ms"] = t["staging_ms"]
            aligned = times["gram"][f"wgmma_{mm_aligned}"]
            rec["aligned"] = {k: aligned[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "shape")}
        if key in train_rec["kernel_times"]:
            rec["muon_shape"] = muon_row(train_rec["kernel_times"][key])
            # phase 20's training cases, each of their Muon shapes
            rec["muon_shapes_20"] = {
                f"{r_['arch']} {shape}": muon_row(kt[key])
                for k_, r_ in lm_rec.items() if k_.endswith("_train")
                for shape, kt in r_["kernel_times"].items()}
            # 21b's rank blocks
            rec["muon_blocks_21b"] = {
                shape: muon_row(kt[key])
                for shape, kt in rows_rec["kernel_times"].items()}
            # phase 4b: every Muon shape with its device time
            rec["muon_shapes_4b"] = {
                shape: muon_row(kt[key])
                for shape, kt in times["muon"].items()}
        kernels.append(rec)
    # K5: its launches on the paths that count them (phase 5's dense
    # solve, 16a's top-k request), its times and error from phase 4c
    k5 = record["k5"]["full"]
    k5_paths = {"static_solve": main_rec["k5_launches_per_solve"],
                "topk_sketch": topk_rec["sketch"]["k5_launches"]}
    k5_row = {"name": "cholesky", "route": "cuda", "kernel_route": None,
              "source": "src/repro_torch/kernels/csrc/cholesky.cu",
              "replaces": "torch.linalg.cholesky_ex (no Pallas kernel)",
              "launches": k5_paths["static_solve"],
              "launches_by_path": k5_paths,
              "max_rel_err_plain": k5["max_rel_err_plain"],
              "max_rel_err_plain_parity": max(
                  row["max_rel_err_plain"]
                  for row in record["k5"]["parity"]),
              "ms": k5["ms"], "plain_ms": k5["plain_ms"],
              "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
              "library_ms": k5["library_ms"],
              "library_singles_ms": k5["library_singles_ms"],
              "case": k5["shape"]}
    if (k5.get("device") or {}).get("ms") is not None:
        k5_row["device_ms"] = k5["device"]["ms"]
    kernels.append(k5_row)
    record["kernels"] = kernels
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    say(f"total seconds: {record['seconds']:.1f}")

    say(json.dumps({"kernels": kernels}))
    if device.type != "cuda":
        say(json.dumps({"rehearsal": True, "device": "cpu"}))
        return 0
    say(record["device"]["nvidia_smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
