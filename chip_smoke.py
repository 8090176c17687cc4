#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py                 # on a machine with an H100
    python3 chip_smoke.py --device cpu --n-train 3000 --n-test 500 --d 32 \\
        --classes 16 --chunk 1024 --check-n 512 --check-b 24 --check-q 100

The second form rehearses phases 2-13 on the CPU at a tiny size, through
the kernels' plain versions; a run on the card never takes that path (add
--fig3-n-train 600 --fig3-n-test 200 --fig3-runs 2 --qp-iters 8 to shrink
phase 4 too, --coreset 16 --kb-check-tiles 2 --kb-evict-coreset 4 for
the kernelized bank, --ring-classes 16 --ring-d 40 --ring-n-train 2000
--ring-n-test 300 --ring-check-n 512 --ring-plain-n 256 for phase 7b,
--live-chunk 200 --live-kb-rows 1024 --live-kb-chunk 256 for phase 10, and
--table1-runs 1 --table1-datasets synthetic_a,waveform --lasvm-cap 300
--cvm-passes 4 --cvm-n-train 600 for phase 11, and --zoo-smoke --zoo-batch 2
--zoo-prompt 32 --zoo-gen 8 --zoo-requests 6 --zoo-slots 3 --zoo-req-prompt
8,24 --zoo-docs 320 --moe-batch 2 --moe-prompt 32 --moe-gen 6 --hybrid-batch 2
--hybrid-prompt 32 --hybrid-gen 8 --long-len 256 --encdec-batch 2
--encdec-prompt 16 --encdec-gen 8 --launch-batch 2 --launch-seq 64,32 for
phases 12 and 13: the smoke configs, fewer requests, lm-15m for 13b).

Phases, in order; any failure raises and the script exits non-zero:
  1. device: name, count, power limit, versions; build every kernel from
     src/repro_torch/kernels/csrc and print their ptxas reports, and each
     kernel's static shared memory beside its byte model's static terms;
  2. each kernel against its plain PyTorch version on the card: B1 (one
     pass of Algorithm 1 for a bank), B2 (fused bank predict, all three
     epilogues), B4 (Algorithm 1 for one model; also at D = 65,536, where
     its w row stays in device memory) and B3 (the fused
     Algorithm 2 for a bank); top-k at every list layout in B2 and B6 serve
     (k = B on phase 3's bank shape; k = 728 and k = B = 1,536, the lists in
     device memory); B5 (the Gram block, with its row-norms kernel) bit for
     bit on ragged cases and at the kernelized bank's K_cs shape, linear B5
     bit-equal to B2's scores, and R1 (the core-set row recursion) with B5
     over the first --kb-check-tiles tiles of phase 6b's pass, for both
     evictions, at S = --coreset and at --kb-evict-coreset (whose buffers
     fill and evict) in every R1 layout (staged at 4, 2 and 1 models per
     CTA, and the first port's), each bit-equal to the plain path, and
     over 2 tiles at S = 256 and 300 (slots in a device scratch); M1 (the
     Sec 4.3 multi-ball recursion) bit for bit at L = 1, 2, 3, 8, both
     variants, D = 30, 32, 33, on random rows and on a stream whose updates
     fall on block edges (with blocks of none and pair merges), in every
     layout (the grid of one CTA an SM; one CTA with the stream read in
     place and the tables in shared or device memory) and in a grid forced
     to 2 CTAs of one row; P1 (the perceptron, on B4's walk) and P2 (Pegasos)
     at mnist89's D = 784 and synthetic_a's D = 2 (--fig3-n-train rows), P2
     at k = 1, 20 and 7 (N not whole steps) in every layout (the walk in
     B4's three layouts; the walk over blocks; the step form staged, a ring
     of two steps, and in place): the same decisions row for row and w
     within the engine tolerance, or a first parting certified as an f32
     tie;
  3. the main path at a deployment's size: a 200-class x 3-point C-grid
     bank (B = 600) over MNIST's widths (D = 784, 60,000 training rows,
     10,000 held-out rows) made from --seed: fit_chunked_many -> ckpt.save
     -> BankServer.from_checkpoint -> ragged serving -> swap_bank, with the
     kernels' launch counts read around it and the served steps' kernel
     milliseconds printed beside the serve wall (7a does the same);
  4. the paper's algorithms at full width, with the launch counts read
     around the phase: (a) Fig 3's configuration (mnist89, D = 784, 11,800
     training rows, C = 10, L in 1, 2, 5, 10, 20, 50 over --fig3-runs
     permutations; fit for L = 1 through B4, fit_lookahead through B3), each
     fit of the first permutation held against the plain version; (b) the
     600-model bank of phase 3 trained with Algorithm 2 (lookahead 10) in
     one fit_bank pass through B3, held against the plain version on the
     same inputs, checkpointed, restored and served through B2; (c) fit_chunked(lookahead=10) (the qp engine) and
     kernels.streamsvm_fit at Fig 3's size, timed;
  6. the kernelized bank (paper Sec 4.2): (a) examples/kernel_bank.py's flow
     on two rings (linear and RBF, both evictions, s_tile, checkpoint,
     ragged serving, hot swap); (b) at full width, phase 3's stream and
     bank layout (600 models, D = 784, 60,000 rows) trained with RBF
     (gamma 1, S = --coreset, block_n 256) in one pass per eviction through
     B5 and R1, checkpointed with save_kernel_bank and served (ovr) through
     BankServer, with the launch counts read around it; each eviction's
     bank bit-equal to the pass through R1's plain version and through its
     first port's layout;
  7. B6, the ring (bank_resident="hbm"), with the launch counts read around
     its paths: (a) phases 3 and 4b forced to "hbm" (fit_chunked_many,
     checkpoint, BankServer over the same ragged requests; the Algorithm-2
     bank), each equal to its "vmem" result bit for bit; (b) the repo's
     beyond-VMEM configuration bank_b1536_d4096_hbm_beyond_vmem (512 blob
     classes x C in {1, 10, 100}, D = 4,096, block_n 256, b_tile 64, 60,000
     training and 10,000 held-out rows from --seed, drawn on the device):
     trained and served (ovr) "hbm" and "vmem", equal bit for bit; Algorithm
     2 run or refused as the byte model predicts; the ring at J = 1, 2, 3, 4
     tiles per CTA equal to B1 over the first --ring-check-n rows, and
     against its plain version over the first --ring-plain-n; every byte
     model equal to ptxas's static bytes plus the launch's dynamic bytes;
  8. the multi-ball (paper Sec 4.3) on benchmarks/beyond.py's path at full
     width: mnist89 (11,800 x 784), C = 10, L = 1, 2, 4, 8 through M1 (the
     grid layout: 132 CTAs x 45 rows, 2 windows), the launch count read
     around the path; each fit bit-equal to M1's plain version, m and
     active equal to the reference's, L = 1 equal to Algorithm 1's m;
     held-out accuracy, the layout, the updates, and M1's ms a fit per L
     by events and on the card alone;
  9. the sharded fits on torch.distributed: 2 gloo ranks spawned on the
     card run fit_bank_sharded over phase 3's 600-model bank and
     fit_sharded(lookahead=10) over mnist89; both ranks bit-equal to each
     other and to the per-range fits folded by fold_merge; accuracy beside
     phase 3's unsharded bank;
  10. the live loop (repro_torch.live: train -> fold -> hot swap, a commit
     every fold), with the launch counts read around (a) and (b): (a) phase
     3's 600-model bank over 60,000 drifting class-blob rows in 4,096-row
     chunks, K = 4, rotate_every 4, FlakySource transient faults and a
     poison chunk, a BankServer (ovr) answering ragged requests between
     chunks; crashed once at each of the 7 PHASES through
     run_live_with_restarts, bit-identical to the clean run (bank, served
     ids and margins, durable stats); K = 1 bit-equal to fit_bank chunk by
     chunk; "hbm" bit-equal to "vmem"; (b) the kernel bank's loop (600
     models, RBF, S = --coreset) over the first 30,720 rows in 7,680-row
     chunks, crashed at post_fold and mid_checkpoint, bit-identical, and
     BankServer.from_checkpoint on its live checkpoint serving the loop's
     last pushed bank bit for bit; (c) the loop of (a) SPMD on 2 gloo ranks
     sharing the card, run to the end and killed at a chunk: every rank
     bit-equal, equal to the per-range run, and the killed run resumed
     without a mesh (one remesh) bit-equal to it; a seeded chaos_schedule
     bit-identical to chaos_reference. Per-chunk train and fold ms (events),
     swap, commit and resume ms, commit bytes, served queries/s;
  11. the paper's baselines (repro_torch.baselines), with the launch counts
     of P1, P2 (and P2's by layout), B1, B3 and B4 read around (a): (a)
     Table 1 on the 8 datasets
     of PAPER_TABLE1 at their generators' full sizes from --seed
     (benchmarks/table1.py's protocol): C* from (1, 10, 100) by one
     fit_c_grid pass (B1) on the validation tail, the per-model
     streamsvm_fit loop (B4) timed beside it; over --table1-runs stream
     orders the perceptron (P1), Pegasos k = 1 and 20 (P2, lambda =
     1/(C* N)), Algorithm 1 (B4) and Algorithm 2 with L = 10 (B3); once a
     dataset LASVM (its C from {1, 10} on a 2,000-row prefix, then on
     --lasvm-cap rows) and the batch l2-SVM (2,000 iterations); the seven
     held-out accuracies beside the paper's and each baseline's seconds; the
     first --table1-checks orders' P1, P2, Algorithm 1 (B4) and Algorithm 2
     (B3) fits, through their entry points, against the same entry points
     on the host's CPU (the plain versions), every parting certified as an
     f32 tie or failing; LASVM's final pass on synthetic_b
     (C6_LASVM_DATASETS) against the same call on the host's CPU: n_sv, w
     and b equal bit for bit (ROADMAP C6); (b) Fig 2
     (fig2_cvm.py's protocol): CVM on mnist89, C = 10, eps 1e-4, up to
     --cvm-passes passes of solver_iters 1,000, the accuracy after each pass
     beside one pass of Algorithms 1 and 2, the passes to match Algorithm 2,
     the seconds a pass; (c) examples/torch_quickstart.py's main at its
     default size; wall seconds of each;
  12. the LLM zoo's serving path (repro_torch.configs, models, serve's
     ContinuousBatcher), with B4's launches read around (c); in (a), (d)
     and 13 (a), (d) one step (a prefill; the A = 1 train step; one more
     launcher step) runs untimed against the dry run's memory count on
     meta tensors of its shapes (memory_check: its peak above the
     arguments within MEMORY_RTOL of max_memory_allocated's): (a)
     examples/torch_serve.py's path with internlm2-1.8b at its published
     widths (24 layers, d_model 2,048, 16 / 8 heads x 128, SwiGLU 8,192,
     vocab 92,544, bf16; 1,889,110,016 parameters drawn on the card from
     --seed): batch 8, prompt 512, 64 greedy tokens, max_len 576; prefill
     and decode ms, tokens/s and max_memory_allocated beside their bounds;
     every step's logits within ZOO_TF_TOL x max|logit| of the
     teacher-forced forward over the same tokens and the greedy tokens
     equal where its top-two logits part by twice that; an f32 copy at full
     width and 2 layers, on the same weights, on the card against the
     host's CPU (TF32 off) within ZOO_F32_TOL; (b) ContinuousBatcher(8
     slots) over xlstm-125m at its published widths: 16 requests from
     --seed (prompts 16-128 tokens, max_new 4-48), each request's tokens
     equal to its solo greedy decode up to a first parting certified as a
     bf16 tie against an f32 replay of the solo prefix, and equal bit for
     bit to its decode alone in its slot of the batcher's 8-row step;
     utilisation beside static batching's, steps/s and admitted/s; (c) examples/llm_feature_svm.py's features (pooled
     embeddings and final hidden states, 4,096 wide) of 1,024 + 256
     styled_corpus documents from (a)'s backbone, streamed once in 128-row
     chunks through fit_chunked(c=10, lookahead=1) (B4 at D = 4,096), held
     against the same call on the host's CPU (m equal, w within the engine
     tolerance, or a parting certified as an f32 tie); held-out accuracy,
     seconds and B4's launches; (d) qwen3-moe-30b-a3b at its published
     widths and depth (48 layers, 128 experts top-8, ~30.5 B parameters,
     bf16, drawn on the card layer by layer from --seed): batch 8, prompt
     512, 32 greedy tokens through examples/torch_serve.py's path; prefill
     and decode ms and peak memory beside their bounds (decode's: every
     expert's weights a step, as the reference's form reads them; a
     gathered form's beside it), the dropped assignments; an f32 copy of
     the first 2 layers at full width on the card against the host's CPU
     (logits and each layer's aux within ZOO_MOE_F32_TOL, the dropped
     assignments per layer equal, the greedy tokens equal where margins
     part); (e) zamba2-1.2b at its published widths and depth (38 Mamba2
     layers, one shared attention block applied 7 times, bf16) through the
     same path: batch 8, prompt 512, 128 greedy tokens, max_len 640;
     prefill and decode ms and peak memory beside their bounds; an f32 copy
     of the whole model decoding the same tokens within ZOO_F32_TOL of its
     640-token teacher-forced forward (the chunked SSD, where decode runs
     the recurrence), the bf16 decode within ZOO_HYBRID_TF_TOL of the bf16
     forward (tools/hybrid_faults.py reads the same check with decode
     faults planted), and a 2-layer f32 copy on the card against the
     host's CPU at prompts 512 and 17; (f) (e)'s model at
     long_500k: decode_state(1, 524,288), the KV, SSM and conv states drawn
     from --seed, 8 timed decode steps against the bytes bound, peak
     memory, finite logits, one shared application's attention over its
     524,288 positions against an f32 replay on the host within ZOO_F32_TOL
     x sum p|v|; (g) whisper-base at its published widths (6 + 6 layers,
     bf16), batch 8, frames (8, 1,500, 512) from --seed, prompt 64, 64
     greedy tokens: encode, prefill and decode ms and peak memory beside
     their bounds, decode within ZOO_TF_TOL of the teacher-forced forward,
     an f32 copy at full width and depth against the host's CPU;
  13. the LLM zoo's training path (repro_torch.optim, train), with B4's
     launches read around (c): (a) examples/llm_feature_svm.py's
     pretraining with internlm2-1.8b at its published widths (bf16, f32
     moments): 60 steps of make_train_step over 8 x 64 tokens of
     styled_corpus(seed=42), the loss falling by TRAIN_LOSS_DROP (the last 10
     steps' mean against the first 10's) and every grad_norm finite; one
     step with microbatches=4 against 1 within tests/test_train_loop.py's
     tolerances; remat "full" against "none" (the loss bit for bit, the grad
     norm within TRAIN_REMAT_GN_RTOL); ms a step, tokens/s and peak memory
     beside the step's bound; (b) examples/torch_train_lm.py --full
     (lm-100m) preempted at step 30 and resumed from its step-20
     checkpoint, every loss and state leaf equal to the uninterrupted run's
     bit for bit under torch.use_deterministic_algorithms; (c) 12c's path
     over (a)'s trained backbone, through fit_chunked at lookahead 1 (B4)
     and 10 (the qp engine), each held to the host's CPU, the held-out
     accuracies beside 12c's; (d) python -m repro_torch.launch.train's
     main: zamba2-1.2b 30 steps of 8 x 512 tokens (--remat full) and
     whisper-base 30 steps of 8 x 128 tokens, preempted after step 20 and
     resumed from its step-15 checkpoint bit-equal to the uninterrupted run
     under --deterministic; each loss falling and every grad norm finite,
     remat "full" against "none" on one batch (the loss bit for bit, the
     grad norm within TRAIN_REMAT_GN_RTOL), ms a step, tokens/s and peak
     memory beside the step's bound;
  5. (printed last) kernel times at the main path's shapes against their
     bounds, printed as one JSON line {"kernels": [...]}, with torch.matmul's
     bare product (no epilogue) at the server step and at 7b's serve; where
     7b's whole launches part from their plain versions, each parted model's
     first parting certified as an f32 tie (ROADMAP C5; Algorithm 1 by
     parting_tie, Algorithm 2 by stream_parting at lookahead 10; the plain
     version over the model's lane alone, after its whole-stream run is held
     to the full run's lane bit for bit) or the phase fails; R1 at
     tile --kb-check-tiles and at tile 0 (the seeding tile) per eviction,
     every layout bit-equal to the plain version and timed in turns, the
     planned layout's device time (torch.profiler) the median of 5 rounds;
     P1 and P2 (k = 1, with k = 20 beside it) at mnist89's first stream
     order of phase 11, by events and on the card alone, and at k = 20 the
     walk over blocks and the step form in turns (a row of its own for the
     walk over blocks).
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
RTOL_W, ATOL_W = 2e-4, 2e-5  # the repo's engine tolerance: f32 sums reordered
TIE_REL = 1e-5  # ids are compared where the top-two gap exceeds this * max|score|
R1_ROUNDS = 5  # phase 5 times each R1 layout in turns over this many rounds (median)
SPIN_CYCLES = 50_000_000  # ~25 ms of the card's clock: R1's card-only launches queue behind it


def score_atol(want):
    """Absolute tolerance for margins: the engine's atol scaled by the size of
    the scores, since the f32 summation-order error of a D-long dot product
    grows with its terms (the reference's Gram tolerances scale the same way)."""
    return ATOL_W * max(1.0, want.abs().max().item())


def make_blobs(n, n_classes, d, seed, proto_seed=0):
    """Unit-norm class blobs; a fixed proto_seed shares the classes between
    the training and held-out draws."""
    proto = (np.random.default_rng(proto_seed).normal(size=(n_classes, d)) * 3).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    X = (rng.normal(size=(n, d)) + proto[labels]).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, labels


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps, warmup=1):
    """Mean milliseconds per call: CUDA events on the card, the host clock
    on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_close(name, got, want, rtol, atol):
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item()
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond rtol={rtol}, atol={atol}")
    return (got - want).abs().max().item()


def separated(scores_sorted, rel):
    """(…, k) mask of sorted positions whose value is more than rel * max|s|
    from both neighbours: where an id is decided by the values, not a tie."""
    tol = rel * scores_sorted.abs().max()
    gaps = scores_sorted[..., :-1] - scores_sorted[..., 1:]
    above = torch.cat([torch.full_like(gaps[..., :1], torch.inf), gaps], dim=-1)
    below = torch.cat([gaps, torch.full_like(gaps[..., :1], torch.inf)], dim=-1)
    return torch.minimum(above, below) > tol


def compare_ids(name, got, want, sorted_scores, k):
    """Ids equal wherever the plain scores separate them; near-ties counted."""
    sep = separated(sorted_scores, TIE_REL)[..., :k]
    if got.ndim < sep.ndim:  # one id per row (the ovr epilogue)
        sep = sep[..., 0]
    bad = ((got.cpu() != want.cpu()) & sep.cpu()).sum().item()
    ties = (~sep).sum().item()
    print(f"  {name}: {bad} separated id mismatches, {ties} near-ties of {sep.numel()}")
    if bad:
        raise AssertionError(f"{name}: {bad} ids differ where the scores are separated")


KB_GAMMA = 1.0  # phase 6b's RBF bandwidth on unit-norm rows
#: Phase 6b's pass seconds per eviction with R1's first layouts (PERF.md,
#: H100 80GB HBM3 at 700 W), printed beside this run's.
KB_PASS_BEFORE = {"smallest-coef": 0.229, "farthest-point": 0.337}


def bit_equal(name, got, want):
    """Two tensors equal bit for bit, compared on their device; returns the
    largest difference (0.0)."""
    if not torch.equal(got, want):
        bad = got != want
        raise AssertionError(f"{name}: differs at {int(bad.sum())} entries (max |err| "
                             f"{(got - want).abs().max().item():.3e})")
    return 0.0


def bank_bit_equal(name, got, want):
    """Two kernel banks equal bit for bit in every leaf."""
    for leaf in got._fields:
        bit_equal(f"{name} {leaf}", getattr(got, leaf), getattr(want, leaf))


def kb_stream(args):
    """Phase 6b's stream: phase 3's blobs with its 600-model C-grid signs."""
    from repro_torch.core import ovr_signs

    c_pts = (1.0, 10.0, 100.0)
    Xtr, ytr = make_blobs(args.n_train, args.classes, args.d, seed=args.seed)
    Xte, yte = make_blobs(args.n_test, args.classes, args.d, seed=args.seed + 1)
    Y = np.tile(ovr_signs(ytr, args.classes, device="cpu").numpy(), (len(c_pts), 1))
    cs = np.repeat(np.asarray(c_pts, np.float32), args.classes)
    return dict(X=Xtr, Y=Y, cs=cs, Xte=Xte, yte=yte, c_pts=c_pts)


def rows_inputs(dev, kb, state, t, farthest):
    """R1's inputs at tile ``t`` of phase 6b's pass from the bank ``state``
    reached before it, built as fit_kernel_bank builds them."""
    from repro_torch.core.meb import _pair_gram
    from repro_torch.kernels.gram import gram_fused, row_norms

    bn = 256
    A = torch.as_tensor(kb["X"][t * bn : (t + 1) * bn], device=dev)
    y = torch.as_tensor(kb["Y"][:, t * bn : (t + 1) * bn], device=dev).contiguous()
    b, s, d = state.points.shape
    P = state.points.reshape(b * s, d)
    an = row_norms(A)
    k_cs = gram_fused(A, P, an, row_norms(P), KB_GAMMA, epilogue="rbf").reshape(bn, b, s)
    k_tt = gram_fused(A, A, an, an, KB_GAMMA, epilogue="rbf")
    kbb = _pair_gram(state.points, state.points, "rbf", KB_GAMMA).contiguous() if farthest else None
    c_inv = 1.0 / torch.as_tensor(kb["cs"], device=dev)
    st = [x.clone() for x in (state.idx, state.coef, state.q, state.r, state.xi2, state.m)]
    return dict(args=(k_cs, k_tt, y), state=st, c_inv=c_inv, kbb=kbb, base=t * bn, n_valid=bn)


def run_rows(fn, inp):
    """One R1 call on fresh copies of the state (and kbb); returns the new
    state, then kbb where there is one."""
    st = [x.clone() for x in inp["state"]]
    kbb = None if inp["kbb"] is None else inp["kbb"].clone()
    fn(*inp["args"], *st, inp["c_inv"], inp["c_inv"], base=inp["base"], n_valid=inp["n_valid"],
       kbb=kbb)
    return st + ([] if kbb is None else [kbb])


def time_states_ms(call, states, dev, card_only=False):
    """Mean ms of ``call(state)`` over ``states[1:]`` back to back, each a
    copy of the inputs made beforehand, after ``call(states[0])`` as a
    warm-up: CUDA events around them, as ``time_ms`` times the other kernels
    (the host clock on the CPU). ``card_only``: the launches are queued
    behind a spin kernel that outlasts their queuing, so the events time the
    card alone, without the wrapper's host time between launches; raises
    where the spin did not outlast it."""
    call(states[0])
    sync(dev)
    reps = len(states) - 1
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for st in states[1:]:
            call(st)
        return (time.perf_counter() - t0) * 1e3 / reps
    spin, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    if card_only:
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    for st in states[1:]:
        call(st)
    e1.record()
    queued = (time.perf_counter() - t0) * 1e3
    e1.synchronize()
    if card_only and spin.elapsed_time(e0) <= queued:
        raise AssertionError(f"timing: the spin ({spin.elapsed_time(e0):.2f} ms) ended before "
                             f"the {reps} launches were queued ({queued:.2f} ms)")
    return e0.elapsed_time(e1) / reps


def time_rows_ms(fn, inp, dev, reps, card_only=False):
    """Mean ms of one R1 launch over ``reps`` launches back to back, each on
    its own copy of the state (``time_states_ms``)."""
    copies = [([x.clone() for x in inp["state"]],
               None if inp["kbb"] is None else inp["kbb"].clone()) for _ in range(reps + 1)]
    call = lambda c: fn(*inp["args"], *c[0], inp["c_inv"], inp["c_inv"], base=inp["base"],
                        n_valid=inp["n_valid"], kbb=c[1])
    return time_states_ms(call, copies, dev, card_only)


# ----------------------------------------------------------------------------


def phase_device(dev):
    from repro_torch.kernels import _build

    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if dev.type != "cuda":
        return
    t0 = time.perf_counter()
    _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
          f"(per source: {json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})})")
    for name in _build.SOURCES:
        print(f"ptxas [{name}]:\n{_build.ptxas_report(name)}")
    for src, kern, model in smem_models():
        print(f"shared memory per CTA [{kern}]: ptxas static "
              f"{sorted(_build.static_smem(src, kern))} B; byte model static {model} B")


def smem_models():
    """(source, kernel, static bytes by the byte models) for every kernel the
    byte models describe; the dynamic terms are checked in phases 2 and 7."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.streamsvm_scan import SCAN_SMEM

    pring = ops.predict_vmem_bytes(8, 8, bank_resident="hbm")
    chunked = sum(SCAN_SMEM.values())
    return (
        ("baselines", "pegasos_kernel", 0),  # all dynamic, checked in phase 2
        ("streamsvm_scan", "scan_kernel", chunked),
        ("streamsvm_scan", "lookahead_kernel", chunked),
        ("streamsvm_scan", "scan_res_kernel", 0),  # all dynamic, checked in phase 7
        ("streamsvm_scan", "lookahead_small_kernel", 0),
        ("streamsvm_scan", "scan_ring_kernel", 0),  # all dynamic, checked in phase 7
        ("streamsvm_single", "single_kernel", 0),  # all dynamic, checked in phase 2
        ("predict", "predict_kernel", sum(ops.predict_vmem_bytes(8, 8).values())),
        ("predict", "predict_ring_kernel", pring["stages"]),
        ("gram", "gram_kernel", ops.kernel_engine_vmem_bytes(8, 8, coreset_size=1)["gram_tiles"]),
        ("kernel_bank", "rows_kernel", 0),  # the first port's R1 layouts: no shared memory
        ("kernel_bank", "rows_wide_kernel", 0),  # (slots in registers or a device scratch)
        ("kernel_bank", "rows_staged_kernel", 0),  # all dynamic, checked in phase 7
        ("multiball", "multiball_kernel", 0),  # all dynamic, checked in phase 7
        ("multiball", "multiball_grid_kernel", 0),  # all dynamic, checked in phase 7
    )


def scan_inputs(rng, b, n, d, dev, *, bp, ragged_n=0, sign0=True, start=None):
    """Padded inputs of B1's wrapper: b live models padded to bp lanes."""
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.where(rng.random((bp, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    if sign0:
        Y[:, rng.random(n) < 0.05] = 0.0  # padding rows of the stream
        Y[rng.random((bp, n)) < 0.02] = 0.0  # rows inert for one model only
    Y[b:] = 0.0
    cs = np.geomspace(0.5, 100.0, bp).astype(np.float32)
    live = np.arange(bp) < b
    if start is None:
        W0 = (Y[:, :1] * X[:1]).astype(np.float32)
        r0, xi20, m0 = np.zeros(bp, np.float32), 1.0 / cs, np.ones(bp, np.int32)
    else:
        W0, r0, xi20, m0 = (t.cpu().numpy() for t in start)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    return dict(
        X=t(X), Y=t(Y), W0=t(W0), r0=t(np.where(live, r0, np.inf)), xi20=t(xi20),
        c_inv=t(np.where(live, 1.0 / cs, 1.0)), m0=t(m0, torch.int32),
        gain=t(np.where(live, 1.0 / cs, 1.0)), n_valid=n - ragged_n,
    )


def check_m(name, got, want):
    if not torch.equal(got.cpu(), want.cpu()):
        diff = (got.cpu() != want.cpu()).nonzero().flatten().tolist()
        raise AssertionError(f"{name}: m differs from the plain version at {diff}")


def check_state(name, got, want, live=None):
    """(w, r, xi2, m) of a kernel against its plain version: floats within
    the engine tolerance, m equal. Returns the w max|err|."""
    if live is not None:
        got, want = [x[:live] for x in got], [x[:live] for x in want]
    err = check_close(f"{name} w", got[0], want[0], RTOL_W, ATOL_W)
    check_close(f"{name} r", got[1], want[1], 1e-4, 0.0)
    check_close(f"{name} xi2", got[2], want[2], 1e-3, 1e-6)
    check_m(name, got[3], want[3])
    return err


def check_single(dev, args, rng):
    """B4 against its plain version at phase 3's width and at D = 65,536,
    where the w row does not fit shared memory (it stays in device memory);
    on the card, its dynamic shared memory against the byte model."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import streamsvm_scan as scan_mod

    for n, d in ((args.check_n, args.d), (300, 65_536)):
        print(f"[2] B4 against its plain version: N={n} (ragged), D={d}, "
              f"{single_note(scan_mod.single_plan(d), d)}")
        check_single_at(dev, rng, n, d)
    if dev.type == "cuda":
        lib = scan_mod._single_lib()
        if _build.static_smem("streamsvm_single", "single_kernel") != {0}:
            raise AssertionError("single_kernel: static shared memory beside the byte model's 0")
        for d in (args.d, 784, 4096, 65_536):
            plan = scan_mod.single_plan(d)
            have = lib.streamsvm_single_dyn_bytes(d, int(plan["w_in_smem"]), plan["chunk"])
            model = sum(plan["smem"].values())
            if have != model or model > scan_mod.SMEM_PER_BLOCK:
                raise AssertionError(f"B4 D={d}: requests {have} B, model {model} B")
            print(f"  B4 D={d} ({single_note(plan, d)}): {have} B requested = byte model")


def single_note(plan, d):
    """B4's layout, as printed."""
    staged = "whole blocks" if plan["chunk"] >= d else f"{plan['chunk']}-column chunks"
    return f"{staged} staged, w in {'shared' if plan['w_in_smem'] else 'device'} memory"


def check_single_at(dev, rng, n, d):
    from repro_torch.kernels import ops
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan, streamsvm_scan_plain

    start = None
    for label in ("ragged N, a zero row, sign-0 rows", "continue from the ball"):
        X = rng.normal(size=(n, d)).astype(np.float32)
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        X[n // 3] = 0.0  # a zero feature row is a real point
        y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
        y[rng.random(n) < 0.05] = 0.0
        if start is None:
            y[0] = 1.0
            start = (torch.as_tensor(y[0] * X[0], device=dev), 0.0, 0.1, 1)
        Xp = ops._pad_to(torch.as_tensor(X, device=dev), 256, 0)
        yp = ops._pad_to(torch.as_tensor(y, device=dev), 256, 0)
        kw = dict(n_valid=n - 37, block_n=256)
        w0, r0, xi20, m0 = start
        got = streamsvm_scan(Xp, yp, w0, r0, xi20, 0.1, m0, 0.1, **kw)
        want = streamsvm_scan_plain(Xp, yp, w0, r0, xi20, 0.1, m0, 0.1, **kw)
        sync(dev)
        err = check_state(f"B4 {label}", got, want)
        print(f"  {label}: w max|err| {err:.3e}, m equal ({int(got[3])})")
        start = got


def edge_stream(n, d, seed):
    """A quiet cloud (norm ~0.05 sqrt(D)) with loud rows (unit directions,
    each 3x the last) on the first and last scan row of every other 32-row
    block from block 2 on (scan row p is stream row p + 1): M1's updates on
    block edges, blocks without any, and pair merges (C) for L >= 2; the
    same stream tests/test_torch_multiball.py holds to a row-at-a-time loop
    and checks for those properties."""
    rng = np.random.default_rng(seed)
    X = 0.05 * rng.normal(size=(n, d))
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    scale = 1.0
    for b in range(2, (n - 1) // 32, 2):
        for p in (32 * b, 32 * b + 31):
            v = rng.normal(size=d)
            X[p + 1] = scale * v / np.linalg.norm(v)
            scale *= 3.0
    return X.astype(np.float32), y.astype(np.float32)


def multiball_state(X, y, L, slack0):
    """fit_multiball's state after row 0 (slot 0 opened at y0 x0)."""
    dev, d = X.device, X.shape[1]
    w = torch.zeros((L, d), device=dev)
    w[0] = y[0] * X[0]
    r, xi2 = torch.zeros(L, device=dev), torch.zeros(L, device=dev)
    xi2[0] = slack0
    m = torch.zeros(L, dtype=torch.int32, device=dev)
    m[0] = 1
    act = torch.zeros(L, dtype=torch.bool, device=dev)
    act[0] = True
    return [w, r, xi2, m, act]


def run_multiball(fn, X, y, L, c_inv, slack0, **kw):
    """One M1 pass (kernel or plain) over rows 1.. of (X, y) from the seeded
    state; returns the state (w, r, xi2, m, active)."""
    st = multiball_state(X, y, L, slack0)
    fn(X[1:], y[1:], *st, c_inv, slack0, **kw)
    return st


def multiball_note(plan):
    """One M1 layout in words."""
    if plan["layout"] == "grid":
        return (f"grid of {plan['n_ctas']} CTAs x {plan['rows']} rows, "
                f"{plan['windows']} window(s)")
    return f"one CTA, stream staged {plan['x_smem']}, tables in shared memory {plan['tables_smem']}"


def check_multiball(dev):
    """M1 against its plain version, bit for bit in every leaf, in every
    layout multiball_plan reaches (each forced by a budget of its own
    bytes: the grid of one CTA an SM, then one CTA with the stream staged
    or read in place and the tables in shared or device memory; the
    centers in device memory), the grid forced small (2 CTAs of one row: a
    window a row pair), and each one-CTA layout the plan does not reach at
    these shapes (below the grid's one-row bytes), launched in its own
    plan: L = 1, 2, 3, 8, both variants, D = 30 and 33 (rows not 16-byte
    aligned: element loads) and 32, on random unit rows and on the edge
    stream."""
    from repro_torch.kernels.multiball import (
        LAYOUTS,
        _launch,
        cta_plan,
        grid_smem,
        multiball_layouts,
        multiball_scan,
        multiball_scan_plain,
    )

    print("[2] M1 against its plain version: L = 1, 2, 3, 8, both variants, every layout")
    n_cases = 0
    for L in (1, 2, 3, 8):
        for d in (30, 32, 33):
            for stream in ("random", "edges"):
                if stream == "random":
                    g = np.random.default_rng(100 * L + d)
                    Xn = g.normal(size=(300, d)).astype(np.float32)
                    Xn /= np.linalg.norm(Xn, axis=1, keepdims=True)
                    yn = np.where(g.random(300) < 0.5, -1.0, 1.0).astype(np.float32)
                    c = 10.0
                else:
                    Xn, yn = edge_stream(300, d, L)
                    c = 1e4
                X, y = torch.as_tensor(Xn, device=dev), torch.as_tensor(yn, device=dev)
                c_inv = float(np.float32(1.0 / c))
                one_row = sum(grid_smem(d, L, 1).values())
                for variant, slack0 in (("exact", c_inv), ("paper-listing", 1.0)):
                    want = run_multiball(multiball_scan_plain, X, y, L, c_inv, slack0)
                    reached = multiball_layouts(L, d, n=299)
                    runs = [(multiball_note(p), multiball_scan,
                             dict(smem_budget=sum(p["smem"].values()))) for p in reached]
                    runs.append(("grid of 2 CTAs x 1 row", multiball_scan,
                                 dict(smem_budget=one_row, n_ctas=2)))
                    for xs, ts in LAYOUTS if dev.type == "cuda" else ():  # the kernel's plans
                        plan = cta_plan(L, d, xs, ts)
                        if plan not in reached:
                            runs.append((multiball_note(plan) + " (its own plan)",
                                         lambda *a, plan=plan: _launch(plan, *a), {}))
                    for label, fn, kw in runs:
                        got = run_multiball(fn, X, y, L, c_inv, slack0, **kw)
                        sync(dev)
                        for leaf, a, b in zip(("w", "r", "xi2", "m", "active"), got, want):
                            bit_equal(f"M1 L={L} D={d} {stream} {variant} {label} {leaf}", a, b)
                        n_cases += 1
        print(f"  L={L}: D = 30, 32, 33, random and edge streams, both variants: "
              + "; ".join(multiball_note(p) for p in multiball_layouts(L, 32, n=299))
              + "; a grid of 2 CTAs x 1 row"
              + ("; the other one-CTA layouts in their own plans" if dev.type == "cuda" else "")
              + f": bit-equal (m of the last case {want[3].tolist()})")
    print(f"  {n_cases} kernel runs, each bit-equal to the plain version")


def check_lookahead(dev, args, rng):
    from repro_torch.kernels import ops
    from repro_torch.kernels.streamsvm_scan import (
        streamsvm_scan_lookahead_many,
        streamsvm_scan_lookahead_many_plain,
    )

    b, n, d = args.check_b, args.check_n, args.d
    mix = (1, 2, 3, 5, 8, 16, 10, 4, 1, 16)  # per-model windows, cycled
    print(f"[2] B3 against its plain version: B={b}, N={n}, D={d}, L per model {mix}")
    cases = [
        ("f32", dict(bp=-(-b // 8) * 8), torch.float32),
        ("bf16", dict(bp=-(-b // 8) * 8), torch.bfloat16),
        ("ragged B and N", dict(bp=-(-(b - 3) // 8) * 8, ragged_n=37), torch.float32),
    ]
    prev = None
    for label, kw, sdt in cases + [("continue from balls", None, torch.float32)]:
        if kw is None:
            kw = dict(bp=prev[0].shape[0], start=prev)
        bb = b - 3 if "ragged" in label else b
        inp = scan_inputs(rng, bb, n, d, dev, **kw)
        X, Y = inp.pop("X").to(sdt), inp.pop("Y").to(sdt)
        bp = Y.shape[0]
        L = torch.tensor([mix[i % len(mix)] if i < bb else 1 for i in range(bp)],
                         dtype=torch.int32, device=dev)
        args_ = (X, Y, *(inp[k] for k in ("W0", "r0", "xi20", "c_inv", "m0", "gain")))
        kw2 = dict(lookahead=L, lookahead_max=max(mix), n_valid=inp["n_valid"], block_n=256)
        got = streamsvm_scan_lookahead_many(*args_, **kw2)
        want = streamsvm_scan_lookahead_many_plain(*args_, **kw2)
        sync(dev)
        err = check_state(f"B3 {label}", got, want, live=bb)
        print(f"  {label}: w max|err| {err:.3e}, m equal (sum {int(got[3][:bb].sum())})")
        if label == "f32":
            prev = got

    Xn = rng.normal(size=(n, d)).astype(np.float32)
    Yn = np.where(rng.random((b, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    cs = np.geomspace(0.5, 100.0, b).astype(np.float32)
    ls = tuple(mix[i % len(mix)] for i in range(b))
    fits = [
        ops.streamsvm_fit_many(Xn, Yn, cs, variant="lookahead", lookahead=ls, b_tile=bt,
                               block_n=256, device=dev)
        for bt in (8, 16, 64)
    ]
    for bt, f in zip((16, 64), fits[1:]):
        for leaf, x, y in zip("w r xi2 m".split(), fits[0], f):
            if not torch.equal(x, y):
                raise AssertionError(f"B3 b_tile=8 and b_tile={bt} differ in {leaf}")
    print("  b_tile 8 / 16 / 64: bit-identical")


def phase_kernels(dev, args, rng):
    from repro_torch.kernels import ops
    from repro_torch.kernels.predict import predict_bank_fused, predict_bank_plain
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan_many, streamsvm_scan_many_plain

    b, n, d = args.check_b, args.check_n, args.d
    print(f"[2] B1 against its plain version: B={b}, N={n}, D={d}")
    cases = [
        ("f32", dict(bp=-(-b // 8) * 8), torch.float32),
        ("bf16", dict(bp=-(-b // 8) * 8), torch.bfloat16),
        ("ragged B and N", dict(bp=-(-(b - 3) // 8) * 8, ragged_n=37), torch.float32),
    ]
    prev = None
    for label, kw, sdt in cases + [("continue from balls", None, torch.float32)]:
        if kw is None:  # continue from the f32 case's state, on a fresh stream
            kw = dict(bp=prev[0].shape[0], start=prev)
        bb = b - 3 if "ragged" in label else b
        inp = scan_inputs(rng, bb, n, d, dev, **kw)
        X, Y = inp.pop("X").to(sdt), inp.pop("Y").to(sdt)
        args_ = (X, Y, *(inp[k] for k in ("W0", "r0", "xi20", "c_inv", "m0", "gain")))
        got = streamsvm_scan_many(*args_, n_valid=inp["n_valid"], block_n=256)
        want = streamsvm_scan_many_plain(*args_, n_valid=inp["n_valid"], block_n=256)
        sync(dev)
        err = check_close(f"B1 {label} w", got[0][:bb], want[0][:bb], RTOL_W, ATOL_W)
        check_close(f"B1 {label} r", got[1][:bb], want[1][:bb], 1e-4, 0.0)
        check_close(f"B1 {label} xi2", got[2][:bb], want[2][:bb], 1e-3, 1e-6)
        if not torch.equal(got[3].cpu(), want[3].cpu()):
            diff = (got[3] != want[3]).nonzero().flatten().tolist()
            raise AssertionError(f"B1 {label}: m differs at models {diff}")
        print(f"  {label}: w max|err| {err:.3e}, m equal (sum {int(got[3][:bb].sum())})")
        if label == "f32":
            prev = got

    # The bank's tiling must not change a bit of the result.
    Xn = rng.normal(size=(n, d)).astype(np.float32)
    Yn = np.where(rng.random((b, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    cs = np.geomspace(0.5, 100.0, b).astype(np.float32)
    fits = [
        ops.streamsvm_fit_many(Xn, Yn, cs, b_tile=bt, block_n=256, device=dev)
        for bt in (8, 16, 64)
    ]
    for bt, f in zip((16, 64), fits[1:]):
        for leaf, x, y in zip("w r xi2 m".split(), fits[0], f):
            if not torch.equal(x, y):
                raise AssertionError(f"B1 b_tile=8 and b_tile={bt} differ in {leaf}")
    print("  b_tile 8 / 16 / 64: bit-identical")

    check_single(dev, args, rng)
    check_baselines(dev, args)
    check_multiball(dev)
    check_lookahead(dev, args, rng)
    check_layouts(dev, args, rng)
    print(f"[2] B2 and B6 serve top-k at any k: Q=250 (ragged), D={d}")
    check_topk_any_k(dev, args, rng)

    q, bq = args.check_q, args.classes * 3
    print(f"[2] B2 against its plain version: Q={q} (ragged), B={bq}, D={d}")
    Q = torch.as_tensor(rng.normal(size=(q, d)).astype(np.float32), device=dev)
    W = torch.as_tensor(rng.normal(size=(bq, d)).astype(np.float32), device=dev)
    qb = 256
    Qp = ops._pad_to(Q, qb, 0)
    nc_pad, _, _ = ops.ovr_group_tiling(bq, args.classes, None)
    if nc_pad != args.classes:
        raise ValueError("the B2 check needs a class count that is a multiple of 8")
    bias = torch.zeros(bq, device=dev)
    full = (Qp @ W.T).sort(dim=1, descending=True).values
    for ep, kw in (
        ("scores", {}),
        ("ovr", dict(nc_pad=nc_pad, b_tile=nc_pad)),
        ("topk", dict(k=5)),
    ):
        got = predict_bank_fused(Qp, W, bias, epilogue=ep, q_block=qb, **kw)
        want = predict_bank_plain(Qp, W, bias, epilogue=ep, q_block=qb, **kw)
        sync(dev)
        if ep == "scores":
            err = check_close("B2 scores", got[:q], want[:q], RTOL_W, score_atol(want[:q]))
            print(f"  scores: max|err| {err:.3e}")
            continue
        if ep == "ovr":
            ids_g, val_g = got
            ids_w, val_w = want
            grp = (Qp @ W.T).reshape(Qp.shape[0], -1, nc_pad).sort(dim=-1, descending=True).values
            compare_ids("ovr ids", ids_g[:q], ids_w[:q], grp[:q], 1)
        else:
            val_g, ids_g = got
            val_w, ids_w = want
            compare_ids("topk ids", ids_g[:q], ids_w[:q], full[:q], 5)
        err = check_close(f"B2 {ep} values", val_g[:q], val_w[:q], RTOL_W, score_atol(val_w[:q]))
        print(f"  {ep}: values max|err| {err:.3e}")


def no_live(kw):
    """B3's keywords without the live count, for the ring and the plain
    versions (which walk every lane)."""
    return {k: v for k, v in kw.items() if k != "n_live"}


def plan_of(inp, kw, budget=None):
    """The layout (``scan_plan``) B1 or B3 takes for the inputs ``inp`` and
    keywords ``kw`` under the shared-memory budget ``budget``."""
    from repro_torch.kernels.streamsvm_scan import scan_plan

    X, Y = inp[0], inp[1]
    return scan_plan(Y.shape[0], X.shape[1], lookahead_max=kw.get("lookahead_max"),
                     n_live=kw.get("n_live"), dtype=X.dtype, smem_budget=budget)


def layout_note(plan):
    """One line for a B1 / B3 launch's layout (``scan_plan``)."""
    by = sum(plan["smem"].values())
    return (f"{plan['layout']}, {plan['models_per_cta']} model(s) x {plan['ctas']} CTAs"
            + (f", window in {plan['window'].replace('smem', 'shared')} memory"
               if plan["window"] else "")
            + f", {by} B {'static' if plan['layout'] == 'chunked' else 'dynamic'}")


def ring_note(Y, bp, d, lookahead):
    """B6's layout at a launch of its wrapper's defaults, as printed."""
    from repro_torch.kernels.streamsvm_scan import ring_plan

    plan = ring_plan(bp, d, lookahead=lookahead, dtype=Y.dtype)
    return (f"the ring {plan['layout']}, {plan['n_ctas']} CTAs, J <= {plan['jmax']}, "
            f"{plan['group']} tiles a step, {sum(plan['smem'].values())} B")


def check_layouts(dev, args, rng):
    """Phase 2: B1 and B3 in each layout (``scan_plan``) bit-equal to the
    ring, B6 train, which this code does not share: at Fig 3's single-model
    launch (L = 2, 10, 50: the small layout; the chunked kernel under the
    smallest budget), at phase 3's chunk and at 4b's launch (600 live models
    over the whole stream: 8 models per CTA at the card's limit, 4 under a
    60,000 B budget, the chunked kernels under the smallest) and where no
    tile fits (D = 12,288: the chunked kernels at the card's limit)."""
    from repro_torch.data import mnist89_like, permuted, preprocess_for
    from repro_torch.kernels.streamsvm_scan import (
        SCAN_SMEM,
        streamsvm_scan_lookahead_many,
        streamsvm_scan_lookahead_many_ring,
        streamsvm_scan_many,
        streamsvm_scan_many_ring,
    )

    floor = sum(SCAN_SMEM.values())  # the chunked kernels: the smallest budget "vmem" runs under

    def against_ring(label, kernel, ring, inp, kw, budgets):
        ref = ring(*inp, **no_live(kw))
        for budget in budgets:
            check_equal(f"{label} under a budget of {budget} B against the ring",
                        kernel(*inp, **kw, smem_budget=budget), ref)
        seen = "; ".join(layout_note(plan_of(inp, kw, by)) for by in budgets)
        print(f"  {label}: bit-equal to the ring in {seen}")
        return ref

    b3 = streamsvm_scan_lookahead_many
    print("[2] B1 and B3 in every layout against the ring (B6 train)")
    Xtr, ytr, Xte, _ = mnist89_like(seed=args.seed)
    Xtr, _ = preprocess_for("mnist89", Xtr[: args.fig3_n_train], Xte[:1])
    Xp, yp = permuted(Xtr, ytr[: args.fig3_n_train], seed=args.seed * 7777)
    Xf, yf = torch.as_tensor(Xp, device=dev), torch.as_tensor(yp, device=dev)
    inp, n, live = seeded_bank_inputs(Xf, yf[None, :], torch.full((1,), 10.0, device=dev), 8)
    for L in (2, 10, 50):
        kw = dict(lookahead=torch.where(live, L, 1).to(torch.int32), lookahead_max=L,
                  n_valid=n, n_live=1)
        against_ring(f"B3 at Fig 3's launch, N={n} D={Xf.shape[1]} L={L}", b3,
                     streamsvm_scan_lookahead_many_ring, inp, kw, (None, floor))

    b, d = args.classes * 3, args.d
    X, yc = make_blobs(args.chunk, args.classes, d, seed=args.seed + 5)
    Y = np.tile(np.where(yc[None, :] == np.arange(args.classes)[:, None], 1.0, -1.0), (3, 1))
    cs = torch.as_tensor(np.repeat(np.asarray((1.0, 10.0, 100.0), np.float32), args.classes),
                         device=dev)
    bp = -(-b // 64) * 64
    inp, n, live = seeded_bank_inputs(torch.as_tensor(X, device=dev),
                                      torch.as_tensor(Y, dtype=torch.float32, device=dev), cs, bp)
    against_ring(f"B1 at phase 3's chunk, N={n} D={d} B={b} (padded to {bp})",
                 streamsvm_scan_many, streamsvm_scan_many_ring, inp, dict(n_valid=n),
                 (None, 60_000, floor))

    X, yc = make_blobs(args.n_train, args.classes, d, seed=args.seed + 6)
    Y = np.tile(np.where(yc[None, :] == np.arange(args.classes)[:, None], 1.0, -1.0), (3, 1))
    inp, n, live = seeded_bank_inputs(torch.as_tensor(X, device=dev),
                                      torch.as_tensor(Y, dtype=torch.float32, device=dev), cs, bp)
    kw = dict(lookahead=torch.where(live, 10, 1).to(torch.int32), lookahead_max=10, n_valid=n,
              n_live=b)
    against_ring(f"B3 at 4b's launch, N={n} D={d} B={b} (padded to {bp}) L=10", b3,
                 streamsvm_scan_lookahead_many_ring, inp, kw, (None, 60_000, floor))

    dw, bw, nw = 12_288, 140, 256
    inp = scan_inputs(rng, bw, nw, dw, dev, bp=144, ragged_n=9)
    nv = inp.pop("n_valid")
    args_ = tuple(inp[k] for k in ("X", "Y", "W0", "r0", "xi20", "c_inv", "m0", "gain"))
    kw1 = dict(n_valid=nv)
    kw3 = dict(lookahead=None, lookahead_max=7, n_valid=nv, n_live=bw)
    if plan_of(args_, kw1)["layout"] != "chunked" or plan_of(args_, kw3)["layout"] != "chunked":
        raise AssertionError(f"D={dw}: the plan should fall back to the chunked kernels")
    against_ring(f"B1 where no tile fits, N={nw} D={dw} B={bw}", streamsvm_scan_many,
                 streamsvm_scan_many_ring, args_, kw1, (None,))
    L = torch.tensor([(1, 3, 7)[i % 3] if i < bw else 1 for i in range(144)], dtype=torch.int32,
                     device=dev)
    against_ring(f"B3 where no tile fits, N={nw} D={dw} B={bw} L in (1, 3, 7)", b3,
                 streamsvm_scan_lookahead_many_ring, args_, {**kw3, "lookahead": L}, (None,))


def check_topk_any_k(dev, args, rng):
    """Phase 2's top-k at every list layout: k = B on phase 3's bank shape
    (600 x 784: the shared-memory lists at their largest) and k = 728 (one
    past them) and k = B on 7b's model count at D = 784 (1,536 lanes: the
    lists in the outputs, in device memory). One ragged served step (250
    queries); B2 and the ring against the plain version and each other."""
    from repro_torch.kernels.predict import (
        TOPK_SMEM_MAX_K,
        predict_bank_fused,
        predict_bank_plain,
        predict_bank_ring,
    )

    d, q = args.d, 250
    Q = torch.as_tensor(rng.normal(size=(q, d)).astype(np.float32), device=dev)
    Qp = torch.nn.functional.pad(Q, (0, 0, 0, 256 - q))
    for b in (args.classes * 3, args.ring_classes * 3):
        W = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=dev)
        W[b - 1] = W[1]  # an exact tie across the whole bank
        bias = torch.zeros(b, device=dev)
        full = (Qp @ W.T).sort(dim=1, descending=True).values
        for k in sorted({b, min(b, TOPK_SMEM_MAX_K + 1)}):
            t0 = time.perf_counter()
            got = predict_bank_fused(Qp, W, bias, epilogue="topk", q_block=256, k=k)
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            check_equal(f"B6 serve topk against B2 at B={b} k={k}",
                        predict_bank_ring(Qp, W, bias, epilogue="topk", q_block=256, k=k), got)
            want = predict_bank_plain(Qp, W, bias, epilogue="topk", q_block=256, k=k)
            compare_ids(f"topk ids B={b} k={k} ({'shared' if k <= TOPK_SMEM_MAX_K else 'device'}"
                        " memory lists)", got[1][:q], want[1][:q], full[:q], k)
            err = check_close(f"B2 topk values B={b} k={k}", got[0][:q], want[0][:q], RTOL_W,
                              score_atol(want[0][:q]))
            print(f"    values max|err| {err:.3e}; B6 serve bit-equal to B2; one launch "
                  f"{ms:.1f} ms (host clock, first call)")


def check_kernel_bank(dev, args, rng, kb):
    """Phase 2's B5 and R1 checks: B5 and its row norms on small ragged
    cases, then the engine's kernel path over the first --kb-check-tiles
    tiles of phase 6b's pass against its plain path (both evictions), then
    B5 at the full K_cs shape those tiles reach."""
    from repro_torch.core.kernel_bank import _fit_kernel_bank
    from repro_torch.kernels.gram import gram_fused, gram_plain, row_norms, row_norms_plain
    from repro_torch.kernels.kernel_bank import rows_layouts, rows_plan
    from repro_torch.kernels.predict import predict_bank_fused

    print("[2] B5 against its plain version: ragged M, N, D; f32 and bf16 A; linear and rbf")
    for m, n, d in ((37, 130, 33), (65, 1, 7), (200, 321, 784), (700, 2000, 785)):
        for dt in (torch.float32, torch.bfloat16):
            A = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32), device=dev).to(dt)
            B = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
            an, bn = row_norms(A), row_norms(B)
            if not (torch.equal(an, row_norms_plain(A)) and torch.equal(bn, row_norms_plain(B))):
                raise AssertionError(f"row norms differ from the plain version at {(m, d)}")
            for ep in ("linear", "rbf"):
                got = gram_fused(A, B, an, bn, 0.1, epilogue=ep)
                want = gram_plain(A, B, an, bn, 0.1, epilogue=ep)
                sync(dev)
                bit_equal(f"B5 {ep} {m}x{n}x{d} {dt}", got, want)
            if dev.type == "cuda":  # one product body (the plain versions differ: B2's is a matmul)
                bit_equal(f"B5 linear against B2 scores {m}x{n}x{d} {dt}",
                          gram_fused(A, B, an, bn, epilogue="linear"),
                          predict_bank_fused(A, B, torch.zeros(n, device=dev), epilogue="scores",
                                             q_block=m))
    print("  bit-equal to the plain version everywhere (one fmaf chain per element); row norms "
          "equal" + ("; linear B5 bit-equal to B2's scores" if dev.type == "cuda" else ""))

    tiles, bn = args.kb_check_tiles, 256
    b, d = kb["Y"].shape[0], args.d
    Xd = torch.as_tensor(kb["X"][: tiles * bn], device=dev)
    Yd = torch.as_tensor(kb["Y"][:, : tiles * bn], device=dev)
    csd = torch.as_tensor(kb["cs"], device=dev)
    out = {}
    # S = --coreset is phase 6b's pass; the smaller --kb-evict-coreset fills
    # the buffers within these tiles, so both eviction policies run. Each
    # R1 layout rows_layouts offers (staged, and the first port's) runs
    # both, each forced by a budget of its own bytes. S = 256 and 300 (the
    # slots in device memory) run the planned layout over 2 tiles.
    for s, nt in ((args.coreset, tiles), (args.kb_evict_coreset, tiles), (256, 2), (300, 2)):
        print(f"[2] R1 and B5 on phase 6b's stream: the first {nt} tiles ({nt * bn} rows), "
              f"B={b}, S={s}, D={d}, rbf gamma {KB_GAMMA}, against the plain path")
        for ev in ("smallest-coef", "farthest-point"):
            far = ev == "farthest-point"
            kw = dict(kernel="rbf", coreset_size=s, eviction=ev, variant="exact", block_n=bn,
                      s_tile=None, stream_dtype=None)
            t0 = time.perf_counter()
            want = _fit_kernel_bank(Xd[: nt * bn], Yd[:, : nt * bn], csd, KB_GAMMA, plain=True,
                                    **kw)
            sync(dev)
            plain_s = time.perf_counter() - t0
            planned = rows_plan(b, s, farthest=far)["layout"]
            layouts = rows_layouts(b, s, farthest=far) if nt == tiles else [None]
            names = []
            for lay in layouts:
                budget = None if lay is None else sum(lay["smem"].values())  # forces lay
                got = _fit_kernel_bank(Xd[: nt * bn], Yd[:, : nt * bn], csd, KB_GAMMA,
                                       smem_budget=budget, **kw)
                sync(dev)
                name = planned if lay is None else lay["layout"]
                bank_bit_equal(f"R1+B5 S={s} {ev} {name}", got, want)
                names.append(name)
                if s == args.coreset and name == planned:
                    out[ev] = dict(state=got, err=0.0)
            filled = int((want.idx >= 0).sum())
            print(f"  {ev}: R1 {', '.join(names)} (planned: {planned}) each bit-equal to the "
                  f"plain path in every leaf (sum m {int(want.m.sum())}, {filled} slots filled, "
                  f"{int(want.m.sum()) - filled} evictions); plain path {plain_s:.1f} s")
    A = torch.as_tensor(kb["X"][tiles * bn : (tiles + 1) * bn], device=dev)
    P = out["smallest-coef"]["state"].points.reshape(-1, d)
    an, pn = row_norms(A), row_norms(P)
    got = gram_fused(A, P, an, pn, KB_GAMMA, epilogue="rbf")
    want = gram_plain(A, P, an, pn, KB_GAMMA, epilogue="rbf")
    sync(dev)
    err = bit_equal("B5 at the K_cs shape", got, want)
    if not torch.equal(torch.diagonal(gram_fused(A, A, an, an, KB_GAMMA, epilogue="rbf")),
                       torch.ones(len(A), device=dev)):
        raise AssertionError("B5's RBF diagonal is not exactly 1")
    print(f"  B5 at the K_cs shape ({bn} x {P.shape[0]} x {d}, rbf): bit-equal to the plain "
          "version; the RBF diagonal is exactly 1")
    out["kcs"] = dict(A=A, P=P, err=err)
    return out


def phase_main_path(dev, args):
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import fit_chunked_many, ovr_signs, predict_c_grid
    from repro_torch.kernels.predict import predict_bank_fused
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan_many
    from repro_torch.serve import BankServer

    n_classes, c_pts, d = args.classes, (1.0, 10.0, 100.0), args.d
    print(f"[3] main path: {n_classes} classes x C {c_pts} = {n_classes * len(c_pts)} "
          f"models, D={d}, {args.n_train} training rows, {args.n_test} held-out rows")
    Xtr, ytr = make_blobs(args.n_train, n_classes, d, seed=args.seed)
    Xte, yte = make_blobs(args.n_test, n_classes, d, seed=args.seed + 1)
    cs = np.repeat(np.asarray(c_pts, np.float32), n_classes)
    Y = np.tile(ovr_signs(ytr, n_classes, device="cpu").numpy(), (len(c_pts), 1))
    chunks = [
        (Xtr[lo : lo + args.chunk], Y[:, lo : lo + args.chunk])
        for lo in range(0, len(Xtr), args.chunk)
    ]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    streamsvm_scan_many.launches = 0
    predict_bank_fused.launches = 0

    sync(dev)
    t0 = time.perf_counter()
    result = fit_chunked_many(chunks, cs, b_tile=64, device=dev)
    sync(dev)
    t_fit = time.perf_counter() - t0
    bank = result.ball
    for name, leaf in zip("w r xi2".split(), bank[:3]):
        if not torch.isfinite(leaf).all():
            raise AssertionError(f"trained bank has non-finite {name}")

    with tempfile.TemporaryDirectory() as td:
        ckpt.save(td, bank, meta={"position": result.position, "n_classes": n_classes})
        server = BankServer.from_checkpoint(
            td, epilogue="ovr", q_block=256, b_tile=200, device=dev
        )
    rng = np.random.default_rng(args.seed + 7)
    reqs, lo = [], 0
    while lo < len(Xte):  # ragged client batches, FIFO-packed into slots
        m = int(rng.integers(1, 200))
        reqs.append(server.submit(Xte[lo : lo + m]))
        lo += m
    t0 = time.perf_counter()
    stats = server.run()
    sync(dev)
    t_serve = time.perf_counter() - t0
    cls = torch.as_tensor(np.concatenate([r.result[0] for r in reqs]))
    margin = torch.as_tensor(np.concatenate([r.result[1] for r in reqs]))
    launches = {  # the fit's chunks and the served steps, at phase 5's shapes
        "streamsvm_scan": streamsvm_scan_many.launches,
        "predict_bank": predict_bank_fused.launches,
    }

    # Hot swap with requests queued: 256 rows score on the old bank, the
    # last 64 on the new one.
    more = [(Xte[:500], np.tile(ovr_signs(yte[:500], n_classes, device="cpu").numpy(), (len(c_pts), 1)))]
    result2 = fit_chunked_many(more, cs, resume=result, b_tile=64)
    swap_reqs = [server.submit(Xte[lo : lo + 64]) for lo in range(0, 320, 64)]
    server.step()
    queued = server.pending_rows()
    server.swap_bank(result2.ball)
    server.run()
    sync(dev)
    swap_launches = {
        "streamsvm_scan": streamsvm_scan_many.launches - launches["streamsvm_scan"],
        "predict_bank": predict_bank_fused.launches - launches["predict_bank"],
    }
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    print(f"  fit: {result.position} rows x {bank.w.shape[0]} models in {t_fit:.3f} s")
    print(f"  serve: {len(Xte)} queries in {stats.steps} steps, {t_serve:.3f} s, "
          f"{len(Xte) / t_serve:.0f} queries/s, slot utilisation {stats.utilization:.4f}")
    step_ms, kernel_ms = served_kernel_ms(dev, bank.w, Xte, n_classes, stats.steps, ring=False)
    print(f"  served steps' kernel (B2): {stats.steps} x {step_ms:.4f} ms = {kernel_ms:.2f} ms of "
          f"the {t_serve * 1e3:.2f} ms serve wall ({kernel_ms / (t_serve * 1e3):.1%})")
    acc1 = [float((cls[:, g].numpy() == yte).mean()) for g in range(len(c_pts))]
    for cval, acc in zip(c_pts, acc1):
        print(f"  C={cval:g}: held-out accuracy {acc:.4f}")
    print(f"  max_memory_allocated: {peak} bytes")
    print(f"  launches on the main path: {launches}; then the 500-row resume and the hot swap "
          f"{swap_launches}")
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")

    # Served ids against the direct readout on the card's plain path.
    rcls, rmargin = predict_c_grid(bank, torch.as_tensor(Xte, device=dev), n_classes)
    scores = (torch.as_tensor(Xte, device=dev) @ bank.w.T).reshape(len(Xte), -1, n_classes)
    grp = scores.sort(dim=-1, descending=True).values
    compare_ids("served ovr ids vs predict_c_grid", cls, rcls, grp, 1)
    check_close("served margins vs predict_c_grid", margin, rmargin, RTOL_W, score_atol(rmargin))
    if queued != 64 or server.stats.bank_swaps != 1 or not all(r.done for r in swap_reqs):
        raise AssertionError(f"swap_bank lost requests: {queued} queued, stats {server.stats}")
    new_cls, _ = predict_c_grid(result2.ball, torch.as_tensor(Xte[256:320], device=dev), n_classes)
    new_s = (torch.as_tensor(Xte[256:320], device=dev) @ result2.ball.w.T).reshape(64, -1, n_classes)
    compare_ids("rows scored after the swap vs the new bank", torch.as_tensor(swap_reqs[4].result[0]),
                new_cls, new_s.sort(dim=-1, descending=True).values, 1)
    return dict(chunk=chunks[0], chunks=chunks, cs=cs, bank=bank, launches=launches, acc=acc1,
                fit_s=t_fit,
                data=(Xtr, Y, Xte, yte), served=(cls, margin))


def serve_ovr(dev, bank, Xte, n_classes):
    """Checkpoint ``bank``, restore it into a BankServer (ovr epilogue) and
    serve the held-out rows in ragged requests; returns the served
    ``(class ids, margins)`` and the server's stats."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.serve import BankServer

    with tempfile.TemporaryDirectory() as td:
        ckpt.save(td, bank, meta={"n_classes": n_classes})
        server = BankServer.from_checkpoint(td, epilogue="ovr", q_block=256, b_tile=200, device=dev)
    rng = np.random.default_rng(11)
    reqs, lo = [], 0
    while lo < len(Xte):
        m = int(rng.integers(1, 200))
        reqs.append(server.submit(Xte[lo : lo + m]))
        lo += m
    stats = server.run()
    cls = torch.as_tensor(np.concatenate([r.result[0] for r in reqs]))
    margin = torch.as_tensor(np.concatenate([r.result[1] for r in reqs]))
    return cls, margin, stats


def served_kernel_ms(dev, w, Xq, n_classes, steps, ring):
    """The kernel's part of a BankServer.run() serve: the CUDA-event
    milliseconds of one served step's launch (256 query slots of ``Xq``, the
    ovr epilogue at b_tile 200, as ops.predict_bank hands it to B2 or, with
    ``ring``, to B6 serve), back to back, times the steps served. The
    launches made here are measurement: the wrapper's count is put back."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.predict import predict_bank_fused, predict_bank_ring

    b, d = w.shape
    g = b // n_classes
    nc_pad, g_tile, gp = ops.ovr_group_tiling(b, n_classes, 200)
    Wp = ops._pad_to(ops._pad_to(w.reshape(g, n_classes, d), nc_pad, 1), gp, 0).reshape(-1, d)
    lane = torch.arange(gp * nc_pad, device=dev)
    bias = torch.where((lane % nc_pad < n_classes) & (lane // nc_pad < g), 0.0,
                       ops.NEG_MASK).to(torch.float32)
    Q = ops._pad_to(torch.as_tensor(Xq[:256], device=dev), 256, 0)
    fn = predict_bank_ring if ring else predict_bank_fused
    kw = dict(epilogue="ovr", q_block=256, b_tile=g_tile * nc_pad, nc_pad=nc_pad)
    before = fn.launches
    ms = time_ms(lambda: fn(Q, Wp, bias, **kw), dev, 50 if dev.type == "cuda" else 1)
    fn.launches = before
    return ms, ms * steps


def seeded_bank_inputs(X, Y, cs, bp):
    """The padded inputs ``ops.streamsvm_fit_many`` hands B1 or B3 for a bank
    seeded from row 0 (block_n 256, the bank padded to ``bp`` lanes):
    ``(args, n_valid, live)``."""
    from repro_torch.kernels import ops

    b, dev = Y.shape[0], X.device
    live = torch.arange(bp, device=dev) < b
    pad = lambda v: ops._pad_to(v, bp, 0)
    c_inv = torch.where(live, pad(1.0 / cs), 1.0)
    args = (
        ops._pad_to(X[1:], 256, 0), ops._pad_to(ops._pad_to(Y[:, 1:], 256, 1), bp, 0),
        pad(Y[:, :1] * X[:1]), torch.where(live, pad(torch.zeros(b, device=dev)), torch.inf),
        pad(1.0 / cs), c_inv, pad(torch.ones(b, dtype=torch.int32, device=dev)), c_inv,
    )
    return args, X.shape[0] - 1, live


def phase_algorithms(dev, args, main):
    """The paper's Algorithms 1 and 2 at full width (phase 4)."""
    from repro_torch.core import fit, fit_bank, fit_chunked, fit_lookahead, predict_c_grid
    from repro_torch.data import chunk_stream, mnist89_like, permuted, preprocess_for
    from repro_torch.kernels import streamsvm_fit
    from repro_torch.kernels.predict import predict_bank_fused
    from repro_torch.kernels.streamsvm_scan import (
        streamsvm_scan,
        streamsvm_scan_lookahead_many,
        streamsvm_scan_lookahead_many_plain,
    )

    counters = (predict_bank_fused, streamsvm_scan_lookahead_many, streamsvm_scan)
    for f in counters:
        f.launches = 0
    Xtr, ytr, Xte, yte = mnist89_like(seed=args.seed)
    Xtr, ytr, Xte, yte = Xtr[: args.fig3_n_train], ytr[: args.fig3_n_train], \
        Xte[: args.fig3_n_test], yte[: args.fig3_n_test]
    Xtr, Xte = preprocess_for("mnist89", Xtr, Xte)
    C, Ls = 10.0, (1, 2, 5, 10, 20, 50)
    print(f"[4a] Fig 3: mnist89, D={Xtr.shape[1]}, {len(Xtr)} training rows, {len(Xte)} "
          f"held-out rows, C={C:g}, L in {Ls}, {args.fig3_runs} permutations")
    Xte_t = torch.as_tensor(Xte, device=dev)
    fig3, fig3_by_L = [], {}
    for L in Ls:
        accs, ms, secs = [], [], []
        before_L = streamsvm_scan_lookahead_many.launches
        for run in range(args.fig3_runs):
            Xp, yp = permuted(Xtr, ytr, seed=args.seed * 7777 + run)
            Xd, yd = torch.as_tensor(Xp, device=dev), torch.as_tensor(yp, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            ball = fit(Xd, yd, C) if L <= 1 else fit_lookahead(Xd, yd, C, L)
            sync(dev)
            secs.append(time.perf_counter() - t0)
            if not all(torch.isfinite(v).all() for v in ball[:3]):
                raise AssertionError(f"Fig 3 L={L} run {run}: non-finite ball")
            accs.append(float((torch.sign(Xte_t @ ball.w).cpu().numpy() == yte).mean()) * 100)
            ms.append(int(ball.m))
            if run == 0 and dev.type == "cuda":  # the kernel against its plain version
                Xc, yc = torch.as_tensor(Xp), torch.as_tensor(yp)
                want = fit(Xc, yc, C) if L <= 1 else fit_lookahead(Xc, yc, C, L)
                check_state(f"Fig 3 L={L} against the plain version", ball, want)
        fig3_by_L[L] = streamsvm_scan_lookahead_many.launches - before_L
        fig3.append(dict(L=L, mean=float(np.mean(accs)), std=float(np.std(accs)),
                         m=float(np.mean(ms)), s=float(np.mean(secs))))
        print(f"  L={L}: held-out accuracy {np.mean(accs):.2f} +- {np.std(accs):.3f} %, "
              f"m {np.mean(ms):.1f}, {np.mean(secs) * 1e3:.1f} ms per fit"
              + (" (first permutation equal to the plain version)" if dev.type == "cuda" else ""))

    n_classes, c_pts = args.classes, (1.0, 10.0, 100.0)
    X6, Y6, X6te, y6te = main["data"]
    print(f"[4b] Algorithm 2 bank: {n_classes} classes x C {c_pts} = {Y6.shape[0]} models, "
          f"lookahead 10, one fit_bank pass over {len(X6)} rows")
    Xd, Yd = torch.as_tensor(X6, device=dev), torch.as_tensor(Y6, device=dev)
    cs6 = torch.as_tensor(main["cs"], device=dev)
    fig3_b3 = streamsvm_scan_lookahead_many.launches  # Fig 3's single-model B3 launches
    sync(dev)
    t0 = time.perf_counter()
    bank = fit_bank(Xd, Yd, cs6, variant="lookahead", lookahead=10, b_tile=64)
    sync(dev)
    t_fit = time.perf_counter() - t0
    bank_b3 = streamsvm_scan_lookahead_many.launches - fig3_b3
    for name, leaf in zip("w r xi2".split(), bank[:3]):
        if not torch.isfinite(leaf).all():
            raise AssertionError(f"the lookahead bank has non-finite {name}")
    # The bank's one B3 launch against the plain version on the inputs
    # fit_bank gave it: the whole stream, windows carried across every block
    # and the partial windows flushed after the last row.
    b6 = Yd.shape[0]
    in3, n3, live3 = seeded_bank_inputs(Xd, Yd, cs6, -(-b6 // 64) * 64)
    kw3 = dict(lookahead=torch.where(live3, 10, 1).to(torch.int32), lookahead_max=10, n_valid=n3,
               n_live=b6)
    t0 = time.perf_counter()
    want3 = streamsvm_scan_lookahead_many_plain(*in3, **no_live(kw3))
    sync(dev)
    plain3 = (time.perf_counter() - t0) * 1e3
    err3 = check_state("the lookahead bank against the plain version", bank, want3, live=b6)
    print(f"  the bank's B3 launch equals the plain version over {n3} rows: w max|err| "
          f"{err3:.3e}, m equal (plain version {plain3 / 1e3:.1f} s)")
    t0 = time.perf_counter()
    cls, margin, stats = serve_ovr(dev, bank, X6te, n_classes)
    sync(dev)
    t_serve = time.perf_counter() - t0
    print(f"  fit: {len(X6)} rows x {bank.w.shape[0]} models in {t_fit:.3f} s; m mean "
          f"{bank.m.float().mean().item():.1f}; served {len(X6te)} queries in {stats.steps} "
          f"steps, {t_serve:.3f} s")
    for g, cval in enumerate(c_pts):
        acc = float((cls[:, g].numpy() == y6te).mean())
        print(f"  C={cval:g}: held-out accuracy {acc:.4f} (Algorithm 1 bank: {main['acc'][g]:.4f})")
    rcls, rmargin = predict_c_grid(bank, torch.as_tensor(X6te, device=dev), n_classes)
    scores = (torch.as_tensor(X6te, device=dev) @ bank.w.T).reshape(len(X6te), -1, n_classes)
    compare_ids("served lookahead-bank ids vs predict_c_grid", cls, rcls,
                scores.sort(dim=-1, descending=True).values, 1)
    check_close("served lookahead-bank margins", margin, rmargin, RTOL_W, score_atol(rmargin))

    print(f"[4c] fit_chunked(lookahead=10, qp engine, {args.qp_iters} BC steps) and "
          f"kernels.streamsvm_fit at Fig 3's size")
    Xp, yp = permuted(Xtr, ytr, seed=args.seed * 7777)
    sync(dev)
    t0 = time.perf_counter()
    ck = fit_chunked(chunk_stream(Xp, yp, 4096), C, lookahead=10, qp_iters=args.qp_iters,
                     device=dev)
    sync(dev)
    t_qp = time.perf_counter() - t0
    t0 = time.perf_counter()
    kb = streamsvm_fit(torch.as_tensor(Xp, device=dev), torch.as_tensor(yp, device=dev), C)
    sync(dev)
    t_kb = time.perf_counter() - t0
    for name, ball in (("fit_chunked", ck.ball), ("streamsvm_fit", kb)):
        acc = float((torch.sign(Xte_t @ ball.w).cpu().numpy() == yte).mean()) * 100
        if not torch.isfinite(ball.w).all():
            raise AssertionError(f"{name}: non-finite w")
        print(f"  {name}: held-out accuracy {acc:.2f} %, m {int(ball.m)}")
    print(f"  fit_chunked {t_qp:.3f} s over {ck.position} rows; streamsvm_fit {t_kb * 1e3:.1f} ms")
    launches = {f.__name__: f.launches for f in counters}
    print(f"  launches in phase 4: {launches}")
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel of phase 4 was never launched: {launches}")
    b3 = dict(inputs=in3, kw=kw3, err=err3, plain_ms=plain3, pushes=float((bank.m - 1).sum()),
              bank_launches=bank_b3, fig3_launches=fig3_b3, fig3_by_L=fig3_by_L)
    return dict(launches=launches, fig3=(Xp, yp), bank=bank, b3=b3, data4b=(Xd, Yd, cs6),
                fit_s=t_fit)


def make_rings(n, d, seed):
    """examples/kernel_bank.py's two rings: inner ring +1, outer ring -1,
    the other dimensions noise."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)
    radius = np.where(y > 0, 1.0, 2.5)
    theta = rng.uniform(0, 2 * np.pi, size=n)
    X = rng.normal(scale=0.1, size=(n, d)).astype(np.float32)
    X[:, 0] += (radius * np.cos(theta)).astype(np.float32)
    X[:, 1] += (radius * np.sin(theta)).astype(np.float32)
    return X, y


def phase_rings(dev, args):
    """Phase 6a: the torch twin of examples/kernel_bank.py's flow."""
    from repro_torch.core import fit_kernel_bank, kernel_bank_decision, save_kernel_bank
    from repro_torch.serve import BankServer

    c_pts, d, s, gamma = (0.5, 5.0, 50.0), 8, 64, 2.0
    Xtr, ytr = make_rings(1200, d, seed=0)
    Xte, yte = make_rings(400, d, seed=1)
    Y = np.tile(ytr[None, :], (len(c_pts), 1))
    cs = np.asarray(c_pts, np.float32)
    Xte_d = torch.as_tensor(Xte, device=dev)
    print(f"[6a] two rings: {len(Xtr)} training / {len(Xte)} held-out rows, D={d}, C {c_pts}, "
          f"S={s}, gamma {gamma}, block_n 128")
    kw = dict(gamma=gamma, coreset_size=s, block_n=128, device=dev)

    def acc(bank, kernel):
        sc = kernel_bank_decision(bank, Xte_d, kernel=kernel, gamma=gamma).cpu().numpy()
        return [float(np.mean(np.sign(c) == yte)) for c in sc.T]

    banks = {}
    for kernel in ("linear", "rbf"):
        sync(dev)
        t0 = time.perf_counter()
        banks[kernel] = fit_kernel_bank(Xtr, Y, cs, kernel=kernel, **kw)
        sync(dev)
        accs = acc(banks[kernel], kernel)
        print(f"  {kernel}: one pass in {(time.perf_counter() - t0) * 1e3:.1f} ms, m max "
              f"{int(banks[kernel].m.max())}; held-out accuracy "
              + ", ".join(f"C={c:g}: {a:.4f}" for c, a in zip(c_pts, accs)))
    best = max(acc(banks["rbf"], "rbf"))
    if not best > 0.9:
        raise AssertionError(f"the RBF bank should separate the rings: best accuracy {best}")
    fp = fit_kernel_bank(Xtr, Y, cs, kernel="rbf", eviction="farthest-point", **kw)
    print(f"  eviction: smallest-coef {best:.4f}, farthest-point {max(acc(fp, 'rbf')):.4f}")
    tiled = fit_kernel_bank(Xtr, Y, cs, kernel="rbf", s_tile=16, **kw)
    for name, a, b in zip(tiled._fields, banks["rbf"], tiled):
        if not torch.equal(a, b):
            raise AssertionError(f"s_tile=16 changed {name}")
    print("  s_tile=16: bit-identical (7 of 7 leaves)")

    bank = banks["rbf"]
    with tempfile.TemporaryDirectory() as td:
        save_kernel_bank(td, bank, kernel="rbf", gamma=gamma)
        server = BankServer.from_checkpoint(td, q_block=128, device=dev)
    rng = np.random.default_rng(args.seed + 5)
    reqs, lo = [], 0
    while lo < len(Xte):
        m = int(rng.integers(1, 90))
        reqs.append(server.submit(Xte[lo : lo + m]))
        lo += m
    server.run()
    steps = server.stats.steps
    served = np.concatenate([r.result for r in reqs])
    direct = kernel_bank_decision(bank, Xte_d, kernel="rbf", gamma=gamma).cpu().numpy()
    if not np.array_equal(served, direct):
        raise AssertionError("served kernel scores differ from kernel_bank_decision")
    swap = [server.submit(Xte[lo : lo + 50]) for lo in range(0, 200, 50)]
    server.step()  # 128 rows on the old bank
    queued = server.pending_rows()
    server.swap_bank(fp, kernel="rbf", gamma=gamma)
    server.run()
    after = kernel_bank_decision(fp, Xte_d[128:200], kernel="rbf", gamma=gamma).cpu().numpy()
    got = np.concatenate([swap[2].result[28:], swap[3].result])
    if queued != 72 or not all(r.done for r in swap) or not np.array_equal(got, after) \
            or not np.array_equal(swap[0].result, direct[:50]):
        raise AssertionError(f"swap_bank lost or misscored requests: {queued} queued")
    print(f"  save_kernel_bank -> BankServer.from_checkpoint(q_block=128): {len(reqs)} ragged "
          f"requests in {steps} steps, scores bit-equal to kernel_bank_decision; "
          f"swap_bank kept {queued} queued rows, scored on the new bank bit for bit")


def phase_kernel_bank(dev, args, kb, main):
    """Phase 6b: the 600-model RBF bank at full width through B5 and R1."""
    from repro_torch.core import fit_kernel_bank, kernel_bank_decision, save_kernel_bank
    from repro_torch.core.kernel_bank import _fit_kernel_bank
    from repro_torch.kernels.gram import gram_fused, row_norms
    from repro_torch.kernels.kernel_bank import kernel_bank_rows, rows_plan
    from repro_torch.serve import BankServer

    b, n_classes, s = kb["Y"].shape[0], args.classes, args.coreset
    print(f"[6b] kernelized bank: {b} models (phase 3's layout), D={args.d}, {len(kb['X'])} "
          f"training rows, rbf gamma {KB_GAMMA}, S={s}, block_n 256, s_tile None")
    Xd = torch.as_tensor(kb["X"], device=dev)
    Yd = torch.as_tensor(kb["Y"], device=dev)
    csd = torch.as_tensor(kb["cs"], device=dev)
    Xte_d = torch.as_tensor(kb["Xte"], device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counters = (gram_fused, row_norms, kernel_bank_rows)
    for f in counters:
        f.launches = 0
    banks, fit_s, rows_launches = {}, {}, {}
    for ev in ("smallest-coef", "farthest-point"):
        r0 = kernel_bank_rows.launches
        sync(dev)
        t0 = time.perf_counter()
        banks[ev] = fit_kernel_bank(Xd, Yd, csd, kernel="rbf", gamma=KB_GAMMA, coreset_size=s,
                                    eviction=ev, block_n=256)
        sync(dev)
        fit_s[ev] = time.perf_counter() - t0
        rows_launches[ev] = kernel_bank_rows.launches - r0
        bank = banks[ev]
        for name in ("coef", "q", "r", "xi2", "points"):
            if not torch.isfinite(getattr(bank, name)).all():
                raise AssertionError(f"{ev} kernel bank has non-finite {name}")
        kept = (bank.idx >= 0).sum(1).float()
        r1 = rows_plan(b, s, farthest=ev == "farthest-point")["layout"]
        print(f"  {ev}: one pass in {fit_s[ev]:.3f} s (R1 {r1}; with R1's first layouts "
              f"{KB_PASS_BEFORE[ev]:.3f} s, PERF.md); "
              f"core vectors kept per model mean {kept.mean().item():.1f} (min "
              f"{int(kept.min())}), m mean {bank.m.float().mean().item():.1f} (max "
              f"{int(bank.m.max())}), {int(bank.m.sum() - kept.sum())} evictions")
    train_launches = {f.__name__: f.launches for f in counters}

    bank = banks["smallest-coef"]
    with tempfile.TemporaryDirectory() as td:
        save_kernel_bank(td, bank, kernel="rbf", gamma=KB_GAMMA, meta={"n_classes": n_classes})
        server = BankServer.from_checkpoint(td, epilogue="ovr", q_block=256, device=dev)
    rng = np.random.default_rng(args.seed + 9)
    reqs, lo = [], 0
    while lo < len(kb["Xte"]):
        m = int(rng.integers(1, 200))
        reqs.append(server.submit(kb["Xte"][lo : lo + m]))
        lo += m
    sync(dev)
    t0 = time.perf_counter()
    stats = server.run()
    sync(dev)
    t_serve = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    cls = torch.as_tensor(np.concatenate([r.result[0] for r in reqs]))
    print(f"  serve (ovr, q_block 256): {len(kb['Xte'])} queries in {stats.steps} steps, "
          f"{t_serve:.3f} s, {len(kb['Xte']) / t_serve:.0f} queries/s")
    print(f"  max_memory_allocated: {peak} bytes")
    print(f"  launches: training passes {train_launches}; with serving {launches}")
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the kernelized bank was never launched: {launches}")
    print(f"  the pass's first {args.kb_check_tiles} tiles equal the plain path (phase 2: "
          "the same inputs, both evictions)")
    # The whole pass again through the first port's R1 layout (held to the
    # plain version in phases 2 and 5), after the launches were read: the
    # banks equal bit for bit.
    for ev in ("smallest-coef", "farthest-point"):
        first = rows_plan(b, s, farthest=ev == "farthest-point", smem_budget=0)["layout"]
        again = _fit_kernel_bank(Xd, Yd, csd, KB_GAMMA, kernel="rbf", coreset_size=s,
                                 eviction=ev, variant="exact", block_n=256, s_tile=None,
                                 stream_dtype=None, smem_budget=0)
        bank_bit_equal(f"6b {ev} bank against R1's {first} layout", banks[ev], again)
        print(f"  {ev}: the bank equals, bit for bit in every leaf, the pass through R1's "
              f"{first} layout")

    yte = kb["yte"]
    accs = {}
    for ev, bk in banks.items():
        sc = kernel_bank_decision(bk, Xte_d, kernel="rbf", gamma=KB_GAMMA)
        grouped = sc.reshape(len(yte), -1, n_classes)
        pred = grouped.argmax(-1).cpu().numpy()
        accs[ev] = [float((pred[:, g] == yte).mean()) for g in range(grouped.shape[1])]
        if ev == "smallest-coef":
            compare_ids("served kernel-bank ids vs kernel_bank_decision", cls,
                        torch.as_tensor(pred), grouped.sort(dim=-1, descending=True).values.cpu(), 1)
            if not torch.equal(cls, torch.as_tensor(pred, dtype=torch.int32)):
                raise AssertionError("served ids differ from the direct readout")
    for g, c in enumerate(kb["c_pts"]):
        print(f"  C={c:g}: held-out accuracy smallest-coef {accs['smallest-coef'][g]:.4f}, "
              f"farthest-point {accs['farthest-point'][g]:.4f} (linear bank, phase 3: "
              f"{main['acc'][g]:.4f})")
    return dict(banks=banks, fit_s=fit_s, train_launches=train_launches, launches=launches,
                rows_launches=rows_launches, serve_launches=launches["gram_fused"]
                - train_launches["gram_fused"])


RING_C = (1.0, 10.0, 100.0)  # phase 7b's C grid (benchmarks/streaming_throughput.py)


def make_blobs_on(n, n_classes, d, seed, dev, proto_seed=0):
    """make_blobs' unit-norm class blobs drawn with torch on ``dev`` (phase
    7b's 60,000 x 4,096 stream is ~1 GB); the fixed proto_seed shares the
    classes between the training and held-out draws."""
    g = torch.Generator(device=dev).manual_seed(proto_seed)
    proto = torch.randn((n_classes, d), generator=g, device=dev) * 3
    g = torch.Generator(device=dev).manual_seed(1_000 + seed)
    labels = torch.randint(0, n_classes, (n,), generator=g, device=dev)
    X = torch.randn((n, d), generator=g, device=dev) + proto[labels]
    return X / X.norm(dim=1, keepdim=True), labels


def check_equal(name, got, want):
    """Two banks (or tuples of tensors) equal bit for bit."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: leaf {i} differs at {int((a != b).sum())} entries")


def parting_tie(kernel, plain, inp, n, model, lo=0, hi=None):
    """Where the kernel's and the plain version's decisions for ``model``
    first part (bisecting n_valid over the prefix runs ``kernel(nv)`` and
    ``plain(nv)`` between ``lo``, where they agree, and ``hi``, default
    ``n``, where they part), and the exact margin there: Algorithm 1 for the model
    alone in float64 up to that row gives ``(row, dist, r, bound)``, with
    ``bound`` the f32 error of evaluating dist from
    d^2 = |w|^2 - 2 y <w, x> + |x|^2 + xi2 + 1/C: each D-long sum errs by at
    most (D + 2) u times its absolute terms (u = 2^-24), and
    |delta dist| <= |delta d^2| / (2 dist)."""
    hi = n if hi is None else hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if int(kernel(mid)[3][model]) == int(plain(mid)[3][model]):
            lo = mid
        else:
            hi = mid
    X, Y, W0, _, xi20, c_inv, _, gain = (t.double() for t in inp)
    w, r = W0[model].clone(), torch.zeros((), dtype=torch.float64, device=X.device)
    xi2, ci, ga = xi20[model], c_inv[model], gain[model]
    d = X.shape[1]
    for i in range(lo + 1):
        y, x = Y[model, i], X[i]
        if y == 0:
            continue
        dist = torch.sqrt((w @ w) - 2 * y * (w @ x) + (x @ x) + xi2 + ci)
        if i == lo:
            terms = (w @ w) + 2 * w.norm() * x.norm() + (x @ x) + xi2 + ci
            bound = (d + 2) * 2.0**-24 * terms / (2 * dist)
            return lo, float(dist), float(r), float(bound)
        if dist >= r:
            s = 0.5 * (1 - r / dist)
            w, r = (1 - s) * w + s * y * x, r + 0.5 * (dist - r)
            xi2 = xi2 * (1 - s) ** 2 + s * s * ga
    raise AssertionError(f"model {model}: the parting row {lo} is inert")


def phase_ring(dev, args, main, algos):
    """Phase 7: B6, the ring (bank_resident="hbm"), at full width."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import fit_bank, fit_chunked_many, ovr_signs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import kernel_bank as kb_mod
    from repro_torch.kernels import multiball as mb_mod
    from repro_torch.kernels import predict as predict_mod
    from repro_torch.kernels import streamsvm_scan as scan_mod
    from repro_torch.kernels.predict import TOPK_SMEM_MAX_K, predict_bank_ring
    from repro_torch.kernels.streamsvm_scan import (
        ring_plan,
        streamsvm_scan_lookahead_many_ring,
        streamsvm_scan_many,
        streamsvm_scan_many_ring,
        streamsvm_scan_many_ring_plain,
    )
    from repro_torch.serve import BankServer

    counters = (streamsvm_scan_many_ring, streamsvm_scan_lookahead_many_ring, predict_bank_ring)
    for f in counters:
        f.launches = 0
    n_classes = args.classes
    print(f'[7a] the main path with bank_resident="hbm": phase 3\'s {len(main["cs"])}-model '
          f"bank over its {len(main['chunks'])} chunks, served over its ragged requests; "
          "phase 4b's Algorithm-2 bank")
    sync(dev)
    t0 = time.perf_counter()
    res = fit_chunked_many(main["chunks"], main["cs"], b_tile=64, bank_resident="hbm", device=dev)
    sync(dev)
    t_fit_a = time.perf_counter() - t0
    check_equal('7a "hbm" bank against phase 3\'s "vmem" bank', res.ball, main["bank"])
    with tempfile.TemporaryDirectory() as td:
        ckpt.save(td, res.ball, meta={"position": res.position, "n_classes": n_classes})
        server = BankServer.from_checkpoint(td, epilogue="ovr", q_block=256, b_tile=200,
                                            bank_resident="hbm", device=dev)
    Xte3 = main["data"][2]
    rng = np.random.default_rng(args.seed + 7)  # phase 3's requests
    reqs, lo = [], 0
    while lo < len(Xte3):
        m = int(rng.integers(1, 200))
        reqs.append(server.submit(Xte3[lo : lo + m]))
        lo += m
    t0 = time.perf_counter()
    stats = server.run()
    sync(dev)
    t_serve_a = time.perf_counter() - t0
    served = (np.concatenate([r.result[0] for r in reqs]), np.concatenate([r.result[1] for r in reqs]))
    check_equal("7a served ids and margins against phase 3's", served, main["served"])
    Xd, Yd, cs6 = algos["data4b"]
    sync(dev)
    t0 = time.perf_counter()
    la = fit_bank(Xd, Yd, cs6, variant="lookahead", lookahead=10, b_tile=64, bank_resident="hbm")
    sync(dev)
    t_la_a = time.perf_counter() - t0
    check_equal('7a "hbm" Algorithm-2 bank against phase 4b\'s', la, algos["bank"])
    print(f"  fit {t_fit_a:.3f} s (vmem, phase 3: {main['fit_s']:.3f} s), bit-equal to phase 3's "
          f"bank; served {len(Xte3)} queries in {stats.steps} steps, {t_serve_a:.3f} s, ids and "
          f"margins bit-equal to phase 3's; Algorithm 2 {t_la_a:.3f} s (vmem, phase 4b: "
          f"{algos['fit_s']:.3f} s), bit-equal to phase 4b's bank")
    step_ms, kernel_ms = served_kernel_ms(dev, res.ball.w, Xte3, n_classes, stats.steps, ring=True)
    print(f"  served steps' kernel (B6 serve): {stats.steps} x {step_ms:.4f} ms = {kernel_ms:.2f} "
          f"ms of the {t_serve_a * 1e3:.2f} ms serve wall ({kernel_ms / (t_serve_a * 1e3):.1%})")
    launches_a = {f.__name__: f.launches for f in counters}
    print(f"  launches of B6 in 7a: {launches_a}")
    if dev.type == "cuda" and min(launches_a.values()) < 1:
        raise AssertionError(f"a B6 path of 7a was never launched: {launches_a}")
    for f in counters:
        f.launches = 0

    rc, d = args.ring_classes, args.ring_d
    b = rc * len(RING_C)
    print(f"[7b] bank_b1536_d4096_hbm_beyond_vmem: {rc} classes x C {RING_C} = {b} models, "
          f"D={d}, {args.ring_n_train} training rows, {args.ring_n_test} held-out rows, "
          "block_n 256, b_tile 64")
    Xtr, ytr = make_blobs_on(args.ring_n_train, rc, d, args.seed, dev)
    Xte, yte = make_blobs_on(args.ring_n_test, rc, d, args.seed + 1, dev)
    Y = ovr_signs(ytr, rc, device=dev).repeat(len(RING_C), 1)
    cs = torch.tensor(RING_C, device=dev).repeat_interleave(rc)
    kw = dict(block_n=256, b_tile=64)
    budget = ops.vmem_budget_bytes()
    banks, secs = {}, {}
    for resident in ("hbm", "vmem"):
        sync(dev)
        t0 = time.perf_counter()
        banks[resident] = fit_bank(Xtr, Y, cs, bank_resident=resident, **kw)
        sync(dev)
        secs[resident] = time.perf_counter() - t0
    check_equal('7b "hbm" bank against "vmem"', banks["hbm"], banks["vmem"])
    for name, leaf in zip("w r xi2".split(), banks["hbm"][:3]):
        if not torch.isfinite(leaf).all():
            raise AssertionError(f"7b bank has non-finite {name}")
    out = {}
    for resident in ("hbm", "vmem"):
        sync(dev)
        t0 = time.perf_counter()
        out[resident] = ops.predict_bank(Xte, banks["hbm"].w, epilogue="ovr", n_classes=rc,
                                         q_block=256, b_tile=64, bank_resident=resident)
        sync(dev)
        secs["serve_" + resident] = time.perf_counter() - t0
    check_equal('7b served ids and margins, "hbm" against "vmem"', out["hbm"], out["vmem"])
    accs = [float((out["hbm"][0][:, g] == yte).float().mean()) for g in range(len(RING_C))]
    print(f"  fit: hbm {secs['hbm']:.3f} s, vmem {secs['vmem']:.3f} s, bit-equal (m mean "
          f"{banks['hbm'].m.float().mean().item():.1f}); served {len(Xte)} queries (ovr, q_block "
          f"256): hbm {secs['serve_hbm']:.3f} s, vmem {secs['serve_vmem']:.3f} s, bit-equal; "
          "held-out accuracy " + ", ".join(f"C={c:g}: {a:.4f}" for c, a in zip(RING_C, accs)))
    by = ops.engine_vmem_bytes(b, d, lookahead_max=10, bank_resident="hbm", **kw)
    la = {}
    if sum(by.values()) <= budget:
        for resident in ("hbm", "vmem"):
            sync(dev)
            t0 = time.perf_counter()
            la[resident] = fit_bank(Xtr, Y, cs, variant="lookahead", lookahead=10,
                                    bank_resident=resident, **kw)
            sync(dev)
            secs["la_" + resident] = time.perf_counter() - t0
        check_equal('7b "hbm" Algorithm-2 bank against "vmem" (B3)', la["hbm"], la["vmem"])
        print(f"  Algorithm 2 (lookahead 10): the byte model admits {sum(by.values())} B of "
              f"{budget} B; hbm {secs['la_hbm']:.3f} s, vmem {secs['la_vmem']:.3f} s, bit-equal")
    else:
        try:
            fit_bank(Xtr[:300], Y[:, :300], cs, variant="lookahead", lookahead=10,
                     bank_resident="hbm", **kw)
        except ValueError as err:
            if "breakdown" not in str(err):
                raise
            print(f"  Algorithm 2 (lookahead 10): refused by the preflight, as the byte model "
                  f"predicts ({sum(by.values())} B > {budget} B)")
        else:
            raise AssertionError("Algorithm 2 at this D ran beyond the byte model's budget")
    launches_b = {f.__name__: f.launches for f in counters}
    print(f"  launches of B6 in 7b: {launches_b}")
    need = [f.__name__ for f in counters if la or f is not streamsvm_scan_lookahead_many_ring]
    if dev.type == "cuda" and min(launches_b[k] for k in need) < 1:
        raise AssertionError(f"a B6 path of 7b was never launched: {launches_b}")

    bp = -(-b // 64) * 64
    tiles = bp // 8
    in_c, n_c, live = seeded_bank_inputs(Xtr[: args.ring_check_n], Y[:, : args.ring_check_n], cs, bp)
    ref = streamsvm_scan_many(*in_c, n_valid=n_c)
    js = []
    for j in (1, 2, 3, 4):
        n_ctas = -(-tiles // j)
        jmax = ring_plan(bp, d, lookahead=False, n_ctas=n_ctas)["jmax"]
        if tiles % j == 0 and jmax != j:
            raise AssertionError(f"n_ctas={n_ctas} gives {jmax} tiles per CTA, not {j}")
        check_equal(f"the ring at J={jmax} against B1", streamsvm_scan_many_ring(
            *in_c, n_valid=n_c, n_ctas=n_ctas), ref)
        js.append(f"{jmax} ({ring_plan(bp, d, lookahead=False, n_ctas=n_ctas)['layout']})")
    print(f"  the first {n_c} rows: the ring at J = {', '.join(js)} tiles per CTA bit-equal to B1")
    in_p, n_p, _ = seeded_bank_inputs(Xtr[: args.ring_plain_n], Y[:, : args.ring_plain_n], cs, bp)
    kernel = lambda nv: streamsvm_scan_many_ring(*in_p, n_valid=nv)
    plain = lambda nv: streamsvm_scan_many_ring_plain(*in_p, n_valid=nv, ring_tile=bp // 2,
                                                      n_ctas=1)
    b1 = lambda nv: streamsvm_scan_many(*in_p, n_valid=nv)
    got, want = kernel(n_p), plain(n_p)
    sync(dev)
    parted = (got[3][:b] != want[3][:b]).nonzero().flatten().tolist()
    if len(parted) > 1:  # the seeded data part on one f32 tie (ROADMAP section C)
        raise AssertionError(f"the ring against its plain version: m differs at {parted}")
    for model in parted:  # a decision tie within the f32 error, B1 parting there too
        row, dist, r, bound = parting_tie(kernel, plain, in_p, n_p, model)
        print(f"  model {model} parts from the plain version at row {row}: float64 "
              f"(dist - r)/r = {(dist - r) / r:.3e}, f32 error bound {bound / r:.3e} of r: a tie")
        if abs(dist - r) > bound:
            raise AssertionError(f"model {model} parts at row {row} by more than the f32 error")
        before, after = b1(row), b1(row + 1)
        if (int(before[3][model]) != int(plain(row)[3][model])
                or int(after[3][model]) == int(plain(row + 1)[3][model])):
            raise AssertionError(f"model {model}: B1 does not part from the plain version at "
                                 f"row {row} as the ring does")
        check_state(f"model {model} up to its parting row", [x[model] for x in kernel(row)],
                    [x[model] for x in plain(row)])
    keep = torch.ones(b, dtype=torch.bool, device=got[3].device)
    keep[parted] = False
    err = check_state("the ring against its plain version", [x[:b][keep] for x in got],
                      [x[:b][keep] for x in want])
    print(f"  the first {n_p} rows: the ring against its plain version (ring tile {bp // 2}): "
          f"w max|err| {err:.3e}, m equal on {int(keep.sum())} of {b} models"
          + (f"; {len(parted)} parted on a tie (above)" if parted else ""))

    if dev.type == "cuda":  # the byte models against what the kernels allocate
        lib, plib = scan_mod._lib(), predict_mod._lib()
        (ring_static,) = _build.static_smem("streamsvm_scan", "scan_ring_kernel")
        squeeze = sum(scan_mod.SCAN_SMEM.values()) - 1  # below every vmem layout
        shapes = [(640, 784, False, None, None), (640, 784, True, None, None),
                  (640, 784, False, None, squeeze), (640, 784, True, None, squeeze),
                  (bp, d, False, None, None), (bp, d, True, None, None),
                  (bp, d, True, None, squeeze)] + [
                      (bp, d, False, -(-tiles // j), None) for j in (1, 2, 3, 4)]
        for sbp, sd, look, n_ctas, by in shapes:
            plan = ring_plan(sbp, sd, lookahead=look, n_ctas=n_ctas, smem_budget=by)
            have = ring_static + lib.streamsvm_scan_ring_dyn_bytes(
                sd, plan["jmax"], scan_mod._RING_LAYOUTS[plan["layout"]], int(look), 0)
            model = sum(plan["smem"].values()) if n_ctas else sum(ops.engine_vmem_bytes(
                sbp, sd, lookahead_max=10 if look else None, bank_resident="hbm",
                smem_budget=by).values())
            if have != model:
                raise AssertionError(f"ring B={sbp} D={sd}: allocates {have} B, model {model} B")
            print(f"  ring B={sbp} D={sd} lookahead={look} J={plan['jmax']} {plan['layout']} "
                  f"({plan['group']} tiles a step) under {by or 'the card'}: {have} B allocated "
                  f"(static {ring_static} + dynamic {have - ring_static}) = byte model")
        (pr_static,) = _build.static_smem("predict", "predict_ring_kernel")
        for ep, k in (("ovr", None), ("scores", None), ("topk", 5), ("topk", 727),
                      ("topk", 728)):
            have = pr_static + plib.predict_bank_ring_dyn_bytes(
                {"scores": 0, "ovr": 1, "topk": 2}[ep], k or 0)
            model = sum(ops.predict_vmem_bytes(b, d, epilogue=ep, k=k, n_classes=rc if ep == "ovr"
                                               else None, bank_resident="hbm").values())
            if have != model:
                raise AssertionError(f"serving ring {ep}: allocates {have} B, model {model} B")
        if plib.predict_bank_max_k() != TOPK_SMEM_MAX_K:
            raise AssertionError(f"topk lists: the kernel keeps k <= {plib.predict_bank_max_k()} "
                                 f"in shared memory, the byte model {TOPK_SMEM_MAX_K}")
        # B1 / B3: each layout's static bytes (ptxas) plus its dynamic
        # request against the byte model, at the shapes of phases 3, 4 and 7b,
        # at the card's limit and under a 60,000 B budget.
        kern = {"chunked": ("scan_kernel", "lookahead_kernel"),
                "resident": ("scan_res_kernel",) * 2, "small": (None, "lookahead_small_kernel")}
        f32 = torch.float32
        for sb, sd, lmax, dt, by in (
                (600, 784, None, f32, None), (600, 784, 10, f32, None), (1, 784, 10, f32, None),
                (1, 784, 50, f32, None), (1, 784, 10, torch.bfloat16, None),
                (b, d, None, f32, None), (b, d, 10, f32, None), (1, 4096, 50, f32, None),
                (16, 12_288, None, f32, None), (600, 784, None, f32, 60_000),
                (600, 784, 10, f32, 60_000), (1, 784, 10, f32, 60_000)):
            plan = scan_mod.scan_plan(-(-sb // 8) * 8, sd, lookahead_max=lmax, n_live=sb, dtype=dt,
                                      smem_budget=by)
            (static,) = _build.static_smem("streamsvm_scan", kern[plan["layout"]][lmax is not None])
            bf = int(dt == torch.bfloat16)
            dyn = 0 if plan["layout"] == "chunked" else (
                lib.streamsvm_scan_small_dyn_bytes(sd, lmax, int(plan["window"] == "smem"), bf)
                if plan["layout"] == "small" else lib.streamsvm_scan_resident_dyn_bytes(
                    sd, plan["models_per_cta"], int(lmax is not None), bf))
            model = sum(ops.engine_vmem_bytes(sb, sd, lookahead_max=lmax, stream_dtype=dt,
                                              smem_budget=by).values())
            if static + dyn != model or model > (by or ops.DEFAULT_VMEM_BUDGET_BYTES):
                raise AssertionError(f"B{3 if lmax else 1} B={sb} D={sd}: allocates "
                                     f"{static + dyn} B, model {model} B")
            print(f"  B{3 if lmax else 1} B={sb} D={sd} L={lmax} {dt}: {layout_note(plan)}: "
                  f"{static + dyn} B allocated = byte model")
        # R1: the planned layout's static bytes plus its dynamic request
        # against the byte model, at phase 6b's S and phase 2's.
        klib = kb_mod._lib()
        for s in sorted({args.coreset, args.kb_evict_coreset, 129, 256, 300}):
            for ev in ("smallest-coef", "farthest-point"):
                plan = kb_mod.rows_plan(600, s, farthest=ev == "farthest-point")
                staged = plan["layout"] == "staged"
                (static,) = _build.static_smem("kernel_bank", {
                    "staged": "rows_staged_kernel", "registers": "rows_kernel",
                    "wide": "rows_wide_kernel"}[plan["layout"]])
                dyn = klib.kernel_bank_rows_staged_bytes(
                    s, int(ev == "farthest-point")) if staged else 0
                model = ops.kernel_engine_vmem_bytes(600, 784, coreset_size=s,
                                                     eviction=ev)["row_recursion"]
                if static + dyn != model:
                    raise AssertionError(f"R1 S={s} {ev}: allocates {static + dyn} B, model "
                                         f"{model} B")
                print(f"  R1 B=600 S={s} {ev}: {plan['layout']}: {static + dyn} B "
                      "allocated = byte model")
        # M1: every layout's static bytes (ptxas) plus its dynamic request
        # against the byte model, at phase 8's widths (and its N), phase 2's,
        # D = 4,096 and where the grid does not fit (L = 72 at D = 768).
        mlib = mb_mod._lib()
        (m_static,) = _build.static_smem("multiball", "multiball_kernel")
        (g_static,) = _build.static_smem("multiball", "multiball_grid_kernel")
        for L, md in ((1, 784), (2, 784), (4, 784), (8, 784), (3, 30), (8, 33), (8, 4096),
                      (72, 768)):
            for plan in mb_mod.multiball_layouts(L, md, n=11_799 if md == 784 else None):
                if plan["layout"] == "grid":
                    have = g_static + mlib.multiball_grid_dyn_bytes(md, L, plan["rows"])
                else:
                    have = m_static + mlib.multiball_dyn_bytes(md, L, int(plan["x_smem"]),
                                                               int(plan["tables_smem"]))
                if have != sum(plan["smem"].values()):
                    raise AssertionError(f"M1 L={L} D={md} {plan}: allocates {have} B, model "
                                         f"{sum(plan['smem'].values())} B")
            print(f"  M1 L={L} D={md}: {len(mb_mod.multiball_layouts(L, md))} layouts ("
                  + "; ".join(multiball_note(p) for p in mb_mod.multiball_layouts(L, md))
                  + "), each allocates its byte model")
        for src, kern, model in smem_models():
            if kern in ("scan_ring_kernel", "predict_ring_kernel"):
                continue  # checked above with their dynamic bytes
            if _build.static_smem(src, kern) != {model}:
                raise AssertionError(f"{kern}: ptxas {_build.static_smem(src, kern)} B, "
                                     f"model {model} B")
        print("  every byte model equals ptxas's static bytes plus the launch's dynamic bytes")
    b7 = dict(X=Xtr, Y=Y, cs=cs, Xte=Xte, w=banks["hbm"].w, n_classes=rc, bp=bp,
              la_m=la["hbm"].m if la else None)
    return dict(launches_a=launches_a, launches_b=launches_b, secs=secs, fit_a=t_fit_a,
                serve_a=t_serve_a, la_a=t_la_a, b7=b7)


#: fit_multiball's slot counts on mnist89 (C = 10) by the JAX reference,
#: repro.core.multiball on the CPU (tests/test_torch_multiball.py holds the
#: port's CPU path to the reference at this size).
MULTIBALL_REFERENCE_M = {1: [18], 2: [14, 17], 4: [12, 17, 10, 14],
                         8: [13, 8, 11, 9, 8, 8, 14, 16]}


def phase_multiball(dev, args):
    """Phase 8: the paper's Sec 4.3 multi-ball on benchmarks/beyond.py's
    path at full width (mnist89, 11,800 x 784, C = 10), L = 1, 2, 4, 8,
    through M1; the launch count read around the path; then each L's fit
    against M1's plain version on the same rows, its layout and updates,
    and M1 timed two ways (events around launches back to back, and the
    card alone behind a spin)."""
    from repro_torch.core import fit
    from repro_torch.core.multiball import decision_function, fit_multiball
    from repro_torch.data import load_dataset, preprocess_for
    from repro_torch.kernels.multiball import multiball_plan, multiball_scan, multiball_scan_plain
    from repro_torch.kernels.ops import vmem_budget_bytes

    Xtr, ytr, Xte, yte = load_dataset("mnist89")
    Xtr, Xte = preprocess_for("mnist89", Xtr, Xte)
    n = min(len(ytr), args.fig3_n_train)
    X, y = torch.as_tensor(Xtr[:n], device=dev), torch.as_tensor(ytr[:n], device=dev)
    Xt = torch.as_tensor(Xte, device=dev)
    d = X.shape[1]
    Ls = (1, 2, 4, 8)
    print(f"[8] multi-ball (Sec 4.3) on beyond.py's path: mnist89, N={n}, D={d}, C=10, "
          f"L in {Ls}")
    multiball_scan.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    fits = {L: fit_multiball(X, y, 10.0, n_balls=L) for L in Ls}
    accs = {L: float((torch.sign(decision_function(fits[L], Xt)).cpu().numpy() == yte).mean())
            for L in Ls}
    sync(dev)
    t_path = time.perf_counter() - t0
    launches = multiball_scan.launches
    print(f"  the path: {len(Ls)} fits and their readouts in {t_path:.3f} s; M1 launches "
          f"{launches}")
    if dev.type == "cuda" and launches != len(Ls):
        raise AssertionError(f"phase 8: M1 launched {launches} times for {len(Ls)} fits")
    c_inv = float(np.float32(1.0 / 10.0))
    ms_by_L = {}
    for L in Ls:
        got = fits[L]
        for leaf in ("w", "r", "xi2"):
            if not torch.isfinite(getattr(got, leaf)).all():
                raise AssertionError(f"M1 L={L}: non-finite {leaf}")
        t1 = time.perf_counter()
        want = run_multiball(multiball_scan_plain, X, y, L, c_inv, c_inv)
        sync(dev)
        plain = (time.perf_counter() - t1) * 1e3
        for leaf, a, b in zip(("w", "r", "xi2", "m", "active"), got, want):
            bit_equal(f"M1 L={L} at full width {leaf}", a, b)
        # fit_multiball's budget, so the plan printed and timed is the one that ran
        budget = vmem_budget_bytes()
        launch = lambda st: multiball_scan(X[1:], y[1:], *st, c_inv, c_inv, smem_budget=budget)
        ms, card_ms = (time_states_ms(launch, [multiball_state(X, y, L, c_inv)
                                               for _ in range(2 * args.reps + 1)], dev, card)
                       for card in (False, True))
        ms_by_L[L] = (ms, plain, card_ms)
        m = got.m.tolist()
        if n == 11_800 and (m != MULTIBALL_REFERENCE_M[L] or not bool(got.active.all())):
            raise AssertionError(f"M1 L={L}: m {m}, active {got.active.tolist()}; the "
                                 f"reference's m {MULTIBALL_REFERENCE_M[L]}, all active")
        plan = multiball_plan(L, d, n=n - 1, smem_budget=budget)
        print(f"  L={L}: m {m}, active {got.active.tolist()}, r "
              f"{[round(v, 4) for v in got.r.tolist()]}, held-out acc {accs[L]:.4f}; bit-equal "
              f"to the plain version; {sum(m) - 1} updates in {multiball_note(plan)}; M1 "
              f"{ms:.4f} ms a fit by events, {card_ms:.4f} "
              f"{'on the card alone' if dev.type == 'cuda' else 'again (host clock)'}; plain "
              f"{plain:.1f} ms")
    ball = fit(X, y, 10.0)
    if int(ball.m) != int(fits[1].m[0]):
        raise AssertionError(f"M1 L=1: m {int(fits[1].m[0])}, Algorithm 1's {int(ball.m)}")
    print(f"  L=1 equals Algorithm 1's m ({int(ball.m)}, fit through B4)")
    L = Ls[-1]
    ms, plain, card_ms = ms_by_L[L]
    flops = 3.0 * (n - 1) * L * d  # each row against each slot once: sub, mul, add over D
    nbytes = 4.0 * ((n - 1) * (d + 1) + 2 * L * (d + 4))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "multiball_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/multiball.cu",
        "replaces": "src/repro/core/multiball.py:131", "launches": launches,
        "max_abs_err": 0.0, "ms": ms, "device_ms": card_ms, "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        "shape": f"phase 8's fits: N={n} D={d} L={L}, {multiball_note(multiball_plan(L, d, n=n - 1, smem_budget=budget))} "
                 "(ms, device_ms at L = 1, 2, 4: "
                 + ", ".join(f"{ms_by_L[k][0]:.4f} / {ms_by_L[k][2]:.4f}" for k in Ls[:-1]) + ")",
        "launches_by_phase": {"8": launches},
    }


def sharded_rank(rank, world, store, device):
    """Phase 9, one rank: the sharded fits on ``device`` over a gloo group;
    saves its results under ``store``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import fit_bank_sharded, fit_sharded

    dist.init_process_group("gloo", init_method=f"file://{store}/pg", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        dev = torch.device(device)
        X, Y, cs, Xf, yf = (torch.as_tensor(np.load(f"{store}/{k}.npy"), device=dev)
                            for k in ("X", "Y", "cs", "Xf", "yf"))
        t0 = time.perf_counter()
        bank = fit_bank_sharded(X, Y, cs, mesh, b_tile=64)
        sync(dev)
        t_bank = time.perf_counter() - t0
        ball = fit_sharded(Xf, yf, 10.0, mesh, lookahead=10)
        np.savez(f"{store}/rank{rank}.npz", *(v.cpu().numpy() for v in (*bank, *ball)),
                 t_bank=t_bank)
    finally:
        dist.destroy_process_group()


def phase_sharded(dev, args, main, world=2):
    """Phase 9: the sharded fits on torch.distributed, ``world`` gloo ranks
    spawned on the one card (NCCL takes one rank a card): fit_bank_sharded
    on phase 3's 600-model bank and fit_sharded(lookahead=10) on mnist89.
    Every rank must hold the per-range single-process fits folded by
    fold_merge, bit for bit."""
    import multiprocessing

    from repro_torch.core import fit_bank, fit_lookahead, fold_merge, predict_c_grid, stack_banks
    from repro_torch.core import Ball, shard_ranges
    from repro_torch.data import load_dataset, preprocess_for

    Xtr, Y, Xte, yte = main["data"]
    Xf, yf, _, _ = load_dataset("mnist89")
    Xf, _ = preprocess_for("mnist89", Xf, Xf[:1])
    nf = (min(len(yf), args.fig3_n_train) // world) * world
    print(f"[9] sharded fits: {world} gloo ranks on {dev}: fit_bank_sharded over phase 3's "
          f"{Y.shape[0]} models x {len(Xtr)} rows, fit_sharded(lookahead=10) over mnist89's "
          f"{nf} rows")
    with tempfile.TemporaryDirectory() as store:
        for k, v in (("X", Xtr), ("Y", Y), ("cs", main["cs"]), ("Xf", Xf[:nf]), ("yf", yf[:nf])):
            np.save(f"{store}/{k}.npy", np.ascontiguousarray(v, np.float32))
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=sharded_rank, args=(r, world, store, str(dev)))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        t_ranks = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"phase 9: a rank failed or hung (exit codes {codes})")
        outs = [np.load(f"{store}/rank{r}.npz") for r in range(world)]
        res = [[o[f"arr_{i}"] for i in range(8)] for o in outs]
        t_bank = [float(o["t_bank"]) for o in outs]
    for r in range(1, world):
        for i, (a, b) in enumerate(zip(res[0], res[r])):
            if not np.array_equal(a, b):
                raise AssertionError(f"phase 9: rank {r} differs from rank 0 in leaf {i}")
    X, Yd = torch.as_tensor(Xtr, device=dev), torch.as_tensor(Y, device=dev)
    cs = torch.as_tensor(main["cs"], device=dev)
    shard_n = -(-len(Xtr) // world)
    banks = []
    for lo, hi in shard_ranges(len(Xtr), world):
        if lo < hi:
            pad = shard_n - (hi - lo)
            banks.append(fit_bank(torch.nn.functional.pad(X[lo:hi], (0, 0, 0, pad)),
                                  torch.nn.functional.pad(Yd[:, lo:hi], (0, pad)), cs, b_tile=64))
    want = fold_merge(stack_banks(banks))
    Xfd, yfd = torch.as_tensor(Xf[:nf], device=dev), torch.as_tensor(yf[:nf], device=dev)
    balls = [fit_lookahead(Xfd[lo:hi], yfd[lo:hi], 10.0, 10) for lo, hi in shard_ranges(nf, world)]
    want_ball = fold_merge(Ball(*(torch.stack(v) for v in zip(*balls))))
    for i, (a, b) in enumerate(zip(res[0], [*want, *want_ball])):
        if not np.array_equal(a, b.cpu().numpy()):
            raise AssertionError(f"phase 9: leaf {i} differs from the folded per-range fits")
    n_classes = args.classes
    cls, _ = predict_c_grid(Ball(*(torch.as_tensor(v, device=dev) for v in res[0][:4])),
                            torch.as_tensor(Xte, device=dev), n_classes)
    acc = [float((cls[:, g].cpu().numpy() == yte).mean()) for g in range(cls.shape[1])]
    print(f"  {world} ranks in {t_ranks:.1f} s (spawn to exit; the bank's sharded fit "
          f"{max(t_bank):.3f} s on the slowest rank); every rank bit-equal to rank 0 and to the "
          f"per-range fits folded by fold_merge (bank: m sum {int(res[0][3].sum())}; "
          f"fit_sharded: m {int(res[0][7])}, r {float(res[0][5]):.4f})")
    print("  held-out accuracy per C, sharded against phase 3's unsharded bank: "
          + ", ".join(f"C={c:g}: {a:.4f} / {b:.4f}" for c, a, b in zip((1.0, 10.0, 100.0), acc,
                                                                         main["acc"])))
    return dict(acc=acc, t_ranks=t_ranks)


LIVE_SOURCE_FAULTS = {2: 2, 6: 1, 9: -1}  # chunk -> transient faults; -1: poison (phase 10a)
#: Phase 10a's crashes: one at each boundary of PHASES, each on a chunk where
#: it fires (rotations at every 4th chunk, a fold and a commit every chunk).
LIVE_FAILPOINTS = (("fetch", 1), ("post_train", 3), ("post_fold", 5), ("post_rotate", 7),
                   ("post_swap", 8), ("mid_checkpoint", 10), ("post_checkpoint", 12))
LIVE_KILL = ("post_train", 6)  # where phase 10c's ranks are killed
LIVE_KB_FAILPOINTS = (("post_fold", 1), ("mid_checkpoint", 2))  # phase 10b


def drifting_blobs(n, chunk, n_classes, d, seed, n_test):
    """Phase 10's stream: unit-norm class blobs whose prototypes move a
    little every ``chunk`` rows (examples/live_bank.py's drift), and
    ``n_test`` held-out rows drawn at the last chunk's prototypes."""
    rng = np.random.default_rng(seed)
    proto = (rng.normal(size=(n_classes, d)) * 3).astype(np.float32)
    drift = (rng.normal(size=(n_classes, d)) * 0.15).astype(np.float32)
    n_chunks = -(-n // chunk)

    def draw(m, t):
        labels = rng.integers(0, n_classes, size=m)
        X = rng.normal(size=(m, d)).astype(np.float32) + (proto + t * drift)[labels]
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        return X, labels

    parts = [draw(min(chunk, n - t * chunk), t) for t in range(n_chunks)]
    X, labels = np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])
    Xte, yte = draw(n_test, n_chunks - 1)
    return X, labels, Xte, yte


def live_linear(X, Y, cs, chunk, ckpt_dir, device, **kw):
    """Phase 10a's loop over ``X``, ``Y`` in ``chunk``-row chunks: K = 4,
    rotate_every 4, retire "merge", a fold, a hot swap and a commit every
    chunk, b_tile 64 (phase 3's), the source with LIVE_SOURCE_FAULTS."""
    from repro_torch.live import ArraySource, FlakySource, LiveBank

    kw.setdefault("cls", LiveBank)
    cls = kw.pop("cls")
    return cls(FlakySource(ArraySource(X, Y, chunk), LIVE_SOURCE_FAULTS), cs,
               ckpt_dir=ckpt_dir, n_sub_banks=4, rotate_every=4, retire="merge", swap_every=1,
               checkpoint_every_folds=1, b_tile=64, sleep=lambda s: None, device=device, **kw)


def live_timed_class():
    """LiveBank with timers around its phases, and ragged requests served
    after every hot swap (phase 10). Train and fold: CUDA events around the
    call (the host clock on the CPU); swap, commit and resume: the host
    clock around the call and a synchronize. What it adds changes no bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.live import LiveBank

    class TimedLive(LiveBank):
        def __init__(self, *a, queries=None, **kw):
            super().__init__(*a, **kw)
            self.times = {k: [] for k in ("train", "fold", "swap", "save", "resume", "serve")}
            self.save_bytes, self.max_age, self.served_rows = [], 0, 0
            self.queries, self._req_rng = queries, np.random.default_rng(17)

        def _timed(self, key, fn, *a, events=False):
            dev = self.device
            if events and dev.type == "cuda":
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a)
                e1.record()
                e1.synchronize()
                self.times[key].append(e0.elapsed_time(e1))
                return out
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a)
            sync(dev)
            self.times[key].append((time.perf_counter() - t0) * 1e3)
            return out

        def _train(self, X, y):
            return self._timed("train", super()._train, X, y, events=True)

        def _merged(self):
            return self._timed("fold", super()._merged, events=True)

        def _restore(self):
            return self._timed("resume", super()._restore)

        def _checkpoint(self, i):
            before = self.stats.checkpoints
            self._timed("save", super()._checkpoint, i)
            if self.stats.checkpoints == before:
                self.times["save"].pop()  # nothing durable yet: no commit was made
            elif self._leader():
                arrays = ckpt.load_manifest(self.ckpt_dir)["arrays_file"]
                self.save_bytes.append(Path(self.ckpt_dir, arrays).stat().st_size)

        def _push(self, merged):
            self._timed("swap", super()._push, merged)
            if self.queries is None or self.server is None:
                return
            reqs, lo = [], 0
            while lo < 1024:  # ragged client batches between chunks
                m = int(self._req_rng.integers(1, 200))
                at = (self.chunk_idx * 1024 + lo) % (len(self.queries) - m)
                reqs.append(self.server.submit(self.queries[at : at + m]))
                lo += m
            self._timed("serve", self.server.run)
            self.served_rows += lo

        def _cadences(self, i):
            super()._cadences(i)
            self.max_age = max(self.max_age, self.stats.bank_age_chunks)

    return TimedLive


def bank_leaves_equal(name, got, want):
    """Two banks (Ball or KernelBank) equal bit for bit in every leaf."""
    for leaf, a, b in zip(want._fields, got, want):
        bit_equal(f"{name} {leaf}", a, b)


def live_rank(rank, world, store, device, chunk):
    """Phase 10c, one rank: the linear loop of 10a SPMD over a DeviceMesh of
    ``world`` gloo ranks (n_stream_shards = world), first to the end, then
    killed at LIVE_KILL; saves what this rank holds each time."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import InjectedFailure

    dist.init_process_group("gloo", init_method=f"file://{store}/pg", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        X, Y, cs = (np.load(f"{store}/{k}.npy") for k in ("X", "Y", "cs"))
        t0 = time.perf_counter()
        live = live_linear(X, Y, cs, chunk, f"{store}/mesh", device, mesh=mesh)
        stats = live.run()
        sync(torch.device(device))
        t_run = time.perf_counter() - t0
        full = [v.cpu().numpy() for v in live.serving_bank()]
        killed = live_linear(X, Y, cs, chunk, f"{store}/kill", device, mesh=mesh,
                             failpoints=[LIVE_KILL])
        try:
            killed.run()
        except InjectedFailure:
            pass
        else:
            raise AssertionError(f"phase 10c: the kill at {LIVE_KILL} never fired")
        at_kill = [v.cpu().numpy() for v in killed.serving_bank()]
        np.savez(f"{store}/rank{rank}.npz", *full, *at_kill, t_run=t_run,
                 stats=json.dumps(stats.durable()), shards=live.n_stream_shards)
    finally:
        dist.destroy_process_group()


def phase_live(dev, args, smi):
    """Phase 10: the live loop (repro_torch.live) at the main path's width:
    (a) the linear loop, crashed at every phase, K = 1 and "hbm"; (b) the
    kernel bank's loop; (c) the loop SPMD on 2 gloo ranks, killed and resumed
    without a mesh, and a chaos schedule."""
    import multiprocessing

    from repro_torch.checkpoint import ckpt
    from repro_torch.core import fit_bank, ovr_signs
    from repro_torch.kernels.gram import gram_fused, row_norms
    from repro_torch.kernels.kernel_bank import kernel_bank_rows
    from repro_torch.kernels.predict import predict_bank_fused
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan_many, streamsvm_scan_many_ring
    from repro_torch.live import (
        ArraySource,
        LiveBank,
        chaos_reference,
        chaos_schedule,
        run_chaos,
        run_live_with_restarts,
    )
    from repro_torch.runtime import StragglerPolicy
    from repro_torch.serve import BankServer

    t_phase = time.perf_counter()
    n_classes, c_pts, d, chunk = args.classes, (1.0, 10.0, 100.0), args.d, args.live_chunk
    card = smi or "cpu"
    X, labels, Xte, yte = drifting_blobs(args.n_train, chunk, n_classes, d, args.seed + 21,
                                         args.n_test)
    Y = np.tile(ovr_signs(labels, n_classes, device="cpu").numpy(), (len(c_pts), 1))
    cs = np.repeat(np.asarray(c_pts, np.float32), n_classes)
    n_chunks = -(-len(X) // chunk)
    print(f"[10] live loop ({card}): {len(cs)} models, D={d}, {len(X)} drifting rows in "
          f"{n_chunks} chunks of {chunk} (last {len(X) - (n_chunks - 1) * chunk}); K=4, "
          f"rotate_every 4, retire merge, a fold, swap and commit every chunk; source faults "
          f"{LIVE_SOURCE_FAULTS} (-1: poison)")
    counters = (streamsvm_scan_many, streamsvm_scan_many_ring, predict_bank_fused, gram_fused,
                row_norms, kernel_bank_rows)
    for f in counters:
        f.launches = 0
    by_run, last = {}, {f.__name__: 0 for f in counters}

    def count(run):
        """The launches since the last count, filed under ``run``."""
        now = {f.__name__: f.launches for f in counters}
        by_run[run] = {k: now[k] - last[k] for k in now if now[k] > last[k]}
        last.update(now)
        return by_run[run]

    TimedLive = live_timed_class()
    server_factory = lambda bank: BankServer(bank, epilogue="ovr", n_classes=n_classes,
                                             q_block=256, b_tile=200, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        # (a) the clean run (with the source faults), timed, serving between chunks
        clean = live_linear(X, Y, cs, chunk, f"{td}/a", dev, cls=TimedLive, queries=Xte,
                            server_factory=server_factory)
        sync(dev)
        t0 = time.perf_counter()
        stats = clean.run()
        sync(dev)
        t_clean = time.perf_counter() - t0
        bank = clean.serving_bank()
        for name, leaf in zip(("w", "r", "xi2"), bank[:3]):
            if not torch.isfinite(leaf).all():
                raise AssertionError(f"phase 10a: the serving bank has non-finite {name}")
        steps_between = clean.server.stats.steps  # the steps that served between chunks
        ids, margins = clean.server.score(Xte)
        clean_launches = count("10a clean run, its requests and the held-out score")
        acc = [float((ids[:, g] == yte).mean()) for g in range(len(c_pts))]
        # crashes at every phase of PHASES, with the same source faults
        crashy = live_linear(X, Y, cs, chunk, f"{td}/a_crash", dev, cls=TimedLive,
                             server_factory=server_factory, failpoints=list(LIVE_FAILPOINTS))
        t0 = time.perf_counter()
        cstats = run_live_with_restarts(crashy, sleep=lambda s: None)
        sync(dev)
        t_crash = time.perf_counter() - t0
        if cstats.restarts != len(LIVE_FAILPOINTS):
            raise AssertionError(f"phase 10a: {cstats.restarts} restarts for "
                                 f"{len(LIVE_FAILPOINTS)} failpoints")
        bank_leaves_equal("10a crashed run's bank against the clean run's", crashy.serving_bank(),
                          bank)
        cids, cmargins = crashy.server.score(Xte)
        count("10a crashed 7 times, and its held-out score")
        if not (np.array_equal(cids, ids) and np.array_equal(cmargins, margins)):
            raise AssertionError("phase 10a: the crashed run serves other ids or margins")
        if cstats.durable() != stats.durable():
            raise AssertionError(f"phase 10a: durable stats differ: {cstats.durable()} "
                                 f"against {stats.durable()}")
        # K = 1 against fit_bank continued chunk by chunk
        k1 = LiveBank(ArraySource(X, Y, chunk), cs, ckpt_dir=f"{td}/a_k1", n_sub_banks=1,
                      rotate_every=10**9, swap_every=1, b_tile=64, device=dev)
        k1.run()
        count("10a K=1")
        ref = None
        csd = torch.as_tensor(cs, device=dev)
        for lo in range(0, len(X), chunk):
            ref = fit_bank(torch.as_tensor(X[lo : lo + chunk], device=dev),
                           torch.as_tensor(Y[:, lo : lo + chunk], device=dev), csd, ref, b_tile=64)
        count("10a fit_bank chunk by chunk (the K=1 check)")
        bank_leaves_equal("10a K=1 against fit_bank chunk by chunk", k1.serving_bank(), ref)
        # the clean run with bank_resident="hbm" (B6, the ring)
        hbm = live_linear(X, Y, cs, chunk, f"{td}/a_hbm", dev, bank_resident="hbm")
        hbm.run()
        hbm_launches = count('10a "hbm"')
        bank_leaves_equal('10a "hbm" against "vmem"', hbm.serving_bank(), bank)
        served_ms, served_kernel = served_kernel_ms(dev, bank.w, Xte, n_classes, steps_between,
                                                    ring=False)
        serve_wall = sum(clean.times["serve"])
        print(f"  (a) [{card}] clean run {t_clean:.3f} s: {stats.chunks_ingested} chunks, "
              f"{stats.folds} folds, {stats.swaps} swaps, {stats.rotations} rotations, {stats.retirements} "
              f"retirements, {stats.checkpoints} commits; retries {stats.retries}, quarantined "
              f"{stats.quarantined}, largest bank_age_chunks {clean.max_age}")
        print(f"      train ms per chunk (events): {[round(t, 3) for t in clean.times['train']]}")
        print(f"      fold ms per chunk (events): {[round(t, 3) for t in clean.times['fold']]}")
        print(f"      swap ms: median {np.median(clean.times['swap']):.3f} (max "
              f"{max(clean.times['swap']):.3f}); commit ms: median "
              f"{np.median(clean.times['save']):.1f} (max {max(clean.times['save']):.1f}), bytes "
              f"{min(clean.save_bytes)}..{max(clean.save_bytes)}")
        print(f"      served between chunks: {clean.served_rows} queries in "
              f"{steps_between} steps, {serve_wall:.2f} ms, "
              f"{clean.served_rows / (serve_wall / 1e3):.0f} queries/s; the steps' kernel (B2) "
              f"{steps_between} x {served_ms:.4f} ms = {served_kernel:.2f} ms of the "
              f"serve wall ({served_kernel / serve_wall:.1%})")
        print(f"      held-out accuracy at the last chunk's prototypes per C: "
              + ", ".join(f"C={c:g}: {a:.4f}" for c, a in zip(c_pts, acc)))
        print(f"  (a) crashed at {len(LIVE_FAILPOINTS)} phases "
              f"({', '.join(p for p, _ in LIVE_FAILPOINTS)}): {cstats.restarts} restarts in "
              f"{t_crash:.3f} s, retries {cstats.retries}, "
              f"quarantined {cstats.quarantined}, largest bank_age_chunks {crashy.max_age}; "
              f"resume ms (restore + fold) {[round(t, 1) for t in crashy.times['resume']]}; bank, "
              "served ids and margins, durable stats bit-identical to the clean run")
        print("  (a) K=1 bit-equal to fit_bank continued chunk by chunk; \"hbm\" bit-equal to "
              "\"vmem\"")
        out["a"] = dict(train=clean.times["train"], fold=clean.times["fold"],
                        save=clean.times["save"], bytes=clean.save_bytes,
                        resume=crashy.times["resume"], qps=clean.served_rows / (serve_wall / 1e3))

        # (b) the kernel bank's loop
        kb_rows = min(args.live_kb_rows, len(X))
        kchunk = args.live_kb_chunk
        Xk, Yk = X[:kb_rows], Y[:, :kb_rows]
        print(f"  (b) [{card}] kernel bank: {len(cs)} models, RBF gamma {KB_GAMMA}, "
              f"S={args.coreset}, block_n 256, {kb_rows} rows in chunks of {kchunk}, K=2, rotate_every 2, a commit "
              "every fold")
        kserver = lambda b: BankServer(b, kernel="rbf", gamma=KB_GAMMA, epilogue="ovr",
                                       n_classes=n_classes, q_block=256, device=dev)

        def kernel_live(name, **kw):
            return TimedLive(ArraySource(Xk, Yk, kchunk), cs, ckpt_dir=f"{td}/{name}",
                             bank_kind="kernel", kernel="rbf", gamma=KB_GAMMA,
                             coreset_size=args.coreset, block_n=256, n_sub_banks=2,
                             rotate_every=2, swap_every=1, server_factory=kserver,
                             sleep=lambda s: None, device=dev, **kw)

        kclean = kernel_live("b")
        t0 = time.perf_counter()
        kstats = kclean.run()
        sync(dev)
        t_kclean = time.perf_counter() - t0
        kbank = kclean.serving_bank()
        q = Xte[:2048]
        kids, kmargins = kclean.server.score(q)
        kernel_launches = count("10b clean run and the held-out score")
        kcrash = kernel_live("b_crash", failpoints=list(LIVE_KB_FAILPOINTS))
        t0 = time.perf_counter()
        kcstats = run_live_with_restarts(kcrash, sleep=lambda s: None)
        sync(dev)
        t_kcrash = time.perf_counter() - t0
        if kcstats.restarts != len(LIVE_KB_FAILPOINTS):
            raise AssertionError(f"phase 10b: {kcstats.restarts} restarts")
        bank_leaves_equal("10b crashed kernel run against the clean run", kcrash.serving_bank(),
                          kbank)
        if kcstats.durable() != kstats.durable():
            raise AssertionError(f"phase 10b: durable stats differ: {kcstats.durable()} "
                                 f"against {kstats.durable()}")
        t0 = time.perf_counter()
        from_ckpt = BankServer.from_checkpoint(f"{td}/b_crash", epilogue="ovr",
                                               n_classes=n_classes, q_block=256, device=dev)
        sync(dev)
        t_from = time.perf_counter() - t0
        manifest = ckpt.load_manifest(f"{td}/b_crash")
        folded = BankServer._fold_live_checkpoint(f"{td}/b_crash", manifest, manifest["meta"], {},
                                                  dev)
        bank_leaves_equal("10b live checkpoint folded against the loop's last pushed bank",
                          folded, kbank)
        fids, fmargins = from_ckpt.score(q)
        count("10b crashed twice, and from_checkpoint's score")
        if not (np.array_equal(kids, fids) and np.array_equal(kmargins, fmargins)):
            raise AssertionError("phase 10b: from_checkpoint serves other bits than the loop")
        kacc = [float((kids[:, g] == yte[:2048]).mean()) for g in range(len(c_pts))]
        print(f"      clean run {t_kclean:.3f} s, crashed at {[p for p, _ in LIVE_KB_FAILPOINTS]} "
              f"{t_kcrash:.3f} s ({kcstats.restarts} restarts), bit-identical; dropped |coef| "
              f"mass {kstats.merge_dropped_mass:.4f}")
        print(f"      train ms per chunk (events): {[round(t, 3) for t in kclean.times['train']]}; "
              f"fold ms: {[round(t, 3) for t in kclean.times['fold']]}")
        print(f"      commit ms {[round(t, 1) for t in kclean.times['save']]}, bytes "
              f"{kclean.save_bytes}; resume ms (restore + fold) "
              f"{[round(t, 1) for t in kcrash.times['resume']]}; swap ms median "
              f"{np.median(kclean.times['swap']):.3f}")
        print(f"      BankServer.from_checkpoint on the live checkpoint {t_from * 1e3:.1f} ms, "
              f"serving the loop's last pushed bank bit for bit; held-out accuracy per C: "
              + ", ".join(f"C={c:g}: {a:.4f}" for c, a in zip(c_pts, kacc)))
        out["b"] = dict(train=kclean.times["train"], fold=kclean.times["fold"],
                        save=kclean.times["save"], bytes=kclean.save_bytes,
                        resume=kcrash.times["resume"])
        print("  launches in phase 10 (a, b), by run: " + "; ".join(
            f"{run}: {n}" for run, n in by_run.items()))
        path = {"streamsvm_scan_many": clean_launches, "predict_bank_fused": clean_launches,
                "streamsvm_scan_many_ring": hbm_launches, "gram_fused": kernel_launches,
                "row_norms": kernel_launches, "kernel_bank_rows": kernel_launches}
        missing = [k for k, run in path.items() if not run.get(k)]
        if dev.type == "cuda" and missing:
            raise AssertionError(f"kernels of phase 10's path were never launched: {missing} "
                                 f"({by_run})")

        # (c) elastic: 2 gloo ranks SPMD on the card, killed, resumed without a mesh
        world = 2
        store = f"{td}/c"
        Path(store).mkdir()
        for k, v in (("X", X), ("Y", Y), ("cs", cs)):
            np.save(f"{store}/{k}.npy", np.ascontiguousarray(v, np.float32))
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=live_rank, args=(r, world, store, str(dev), chunk))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        t_ranks = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"phase 10c: a rank failed or hung (exit codes {codes})")
        outs = [np.load(f"{store}/rank{r}.npz") for r in range(world)]
        n_leaves = len(bank)
        for r in range(1, world):
            for i in range(2 * n_leaves):
                if not np.array_equal(outs[0][f"arr_{i}"], outs[r][f"arr_{i}"]):
                    raise AssertionError(f"phase 10c: rank {r} differs from rank 0 in leaf {i}")
            if str(outs[r]["stats"]) != str(outs[0]["stats"]):
                raise AssertionError("phase 10c: the ranks' durable stats differ")
        per_range = live_linear(X, Y, cs, chunk, f"{td}/c_ref", dev, n_stream_shards=world)
        pstats = per_range.run()
        for i, want in enumerate(per_range.serving_bank()):
            if not np.array_equal(outs[0][f"arr_{i}"], want.cpu().numpy()):
                raise AssertionError(f"phase 10c: the mesh run differs from the per-range run in "
                                     f"leaf {i}")
        if json.loads(str(outs[0]["stats"])) != json.loads(json.dumps(pstats.durable())):
            raise AssertionError("phase 10c: the mesh run's durable stats differ")
        resumed = live_linear(X, Y, cs, chunk, f"{store}/kill", dev, cls=TimedLive)
        rstats = resumed.run()
        if resumed.n_stream_shards != world or rstats.remeshes != 1:
            raise AssertionError(f"phase 10c: the resume took {resumed.n_stream_shards} shards "
                                 f"and {rstats.remeshes} remeshes")
        bank_leaves_equal("10c killed on 2 ranks, resumed without a mesh, against the per-range "
                          "run", resumed.serving_bank(), per_range.serving_bank())
        if rstats.durable() != pstats.durable():
            raise AssertionError("phase 10c: the resumed run's durable stats differ")
        # a seeded chaos schedule, no mesh
        sched = chaos_schedule(args.seed, n_chunks=n_chunks, n_shards=world, kills=3)

        def make_live(mesh, failpoints, faults, name):
            return LiveBank(ArraySource(X, Y, chunk), cs, ckpt_dir=f"{td}/{name}", n_sub_banks=4,
                            rotate_every=4, swap_every=1, b_tile=64, mesh=mesh,
                            n_stream_shards=world, shard_faults=faults, failpoints=failpoints,
                            straggler_policy=StragglerPolicy(), sleep=lambda s: None, device=dev)

        t0 = time.perf_counter()
        chaos = run_chaos(functools.partial(make_live, name="c_chaos"), sched)
        cref = chaos_reference(functools.partial(make_live, name="c_chaos_ref"), sched)
        sync(dev)
        t_chaos = time.perf_counter() - t0
        bank_leaves_equal("10c chaos run against chaos_reference", chaos.serving_bank(),
                          cref.serving_bank())
        if chaos.stats.durable() != cref.stats.durable():
            raise AssertionError("phase 10c: the chaos run's durable stats differ")
        print(f"  (c) [{card}] {world} gloo ranks on {dev}, n_stream_shards {world}: the mesh run and the "
              f"run killed at {LIVE_KILL} in {t_ranks:.1f} s (spawn to exit; the mesh run "
              f"{max(float(o['t_run']) for o in outs):.3f} s on the slowest rank); every rank "
              f"bit-equal to rank 0 and to the per-range run; resumed without a mesh "
              f"({rstats.remeshes} remesh, resume ms {[round(t, 1) for t in resumed.times['resume']]}"
              f"), bit-equal to the per-range run")
        print(f"      chaos schedule (seed {args.seed}): kills {list(sched.kills)}, lost "
              f"{sched.lost}, flaky/poison {sched.flaky}, slow {list(sched.slow)}: "
              f"{chaos.stats.restarts} restarts, rows_lost {chaos.stats.rows_lost}, "
              f"ranges_reissued {chaos.stats.ranges_reissued}, in {t_chaos:.3f} s with its "
              "reference; bit-identical to chaos_reference")
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s ({card})")
    out["launches"] = by_run
    return out


def kernel_row(name, src, replaces, launches, err, ms, plain, flops, nbytes, lib, shape):
    """One row of phase 5's {"kernels": [...]} line; the bound is the larger
    of the operations at F32_PEAK and the bytes at HBM_BYTES_PER_S."""
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, "shape": shape,
    }


def phase_times(dev, args, main, algos, kb, kbc, kbres, ring):
    from repro_torch.kernels import ops
    from repro_torch.kernels import streamsvm_scan as scan_mod
    from repro_torch.kernels.predict import (
        predict_bank_fused,
        predict_bank_plain,
        predict_bank_ring,
        predict_bank_ring_plain,
    )
    from repro_torch.kernels.streamsvm_scan import (
        streamsvm_scan,
        streamsvm_scan_lookahead_many,
        streamsvm_scan_lookahead_many_plain,
        streamsvm_scan_lookahead_many_ring,
        streamsvm_scan_lookahead_many_ring_plain,
        streamsvm_scan_many,
        streamsvm_scan_many_plain,
        streamsvm_scan_many_ring,
        streamsvm_scan_many_ring_plain,
        streamsvm_scan_plain,
    )

    reps = 1 if dev.type == "cpu" else args.reps
    # B1 at the main path's first call: one chunk, the bank seeded from row 0.
    X, Y = (torch.as_tensor(a, device=dev) for a in main["chunk"])
    b, d = Y.shape[0], X.shape[1]
    bp = -(-b // 64) * 64
    args1, n, _ = seeded_bank_inputs(X, Y, torch.as_tensor(main["cs"], device=dev), bp)
    got = streamsvm_scan_many(*args1, n_valid=n)
    want = streamsvm_scan_many_plain(*args1, n_valid=n)
    sync(dev)
    err1 = check_close("B1 at the main-path shape, w", got[0][:b], want[0][:b], RTOL_W, ATOL_W)
    if not torch.equal(got[3].cpu(), want[3].cpu()):
        raise AssertionError("B1 at the main-path shape: m differs from the plain version")
    ms1 = time_ms(lambda: streamsvm_scan_many(*args1, n_valid=n), dev, reps)
    plan1 = plan_of(args1, dict(n_valid=n))
    plain1 = time_ms(lambda: streamsvm_scan_many_plain(*args1, n_valid=n), dev, 1, warmup=0)
    flops1 = 4.0 * b * n * d + 2.0 * n * 32 * d + 6.0 * b * n * 32
    bytes1 = 4.0 * (n * d + b * n + 2 * b * d + 6 * b)
    # B6 train (Algorithm 1) at phase 7a's first launch: the same chunk and
    # work as B1 there, so the same bound; it must give B1's bits.
    got_r = streamsvm_scan_many_ring(*args1, n_valid=n)
    check_equal("B6 (Algorithm 1) against B1 at the main-path shape", got_r, got)
    t0 = time.perf_counter()
    want_r = streamsvm_scan_many_ring_plain(*args1, n_valid=n, ring_tile=bp, n_ctas=1)
    sync(dev)
    plain_r = (time.perf_counter() - t0) * 1e3
    err_r = check_state("B6 (Algorithm 1) against its plain version", got_r, want_r, live=b)
    ms_r = time_ms(lambda: streamsvm_scan_many_ring(*args1, n_valid=n), dev, reps)
    # B3 at its main-path launch (phase 4b): the whole stream, 10-row windows,
    # held against the plain version there.
    b3 = algos["b3"]
    in3, kw3, pushes = b3["inputs"], b3["kw"], b3["pushes"]
    n3 = kw3["n_valid"]
    ms3 = time_ms(lambda: streamsvm_scan_lookahead_many(*in3, **kw3), dev, reps)
    plan3 = plan_of(in3, kw3)
    kw3r = no_live(kw3)  # the ring walks every lane
    # B3's own work: h = <w, x_k> for every model and row and each row's
    # |x_k|^2 (the Gram's diagonal is all a distance needs; there is no
    # deferred update and g changes only in a flush), plus, for every pushed
    # row, at least one distance in a flush (this run's pushes).
    flops3 = 2.0 * b * n3 * d + 2.0 * n3 * d + 3.0 * d * pushes
    bytes3 = 4.0 * (n3 * d + b * n3 + 2 * b * d + 6 * b)
    # B6 train (Algorithm 2) at phase 7a's lookahead launch: B3's inputs,
    # work and bound; it must give B3's bits.
    got3 = streamsvm_scan_lookahead_many(*in3, **kw3)
    got_r3 = streamsvm_scan_lookahead_many_ring(*in3, **kw3r)
    check_equal("B6 (Algorithm 2) against B3 at the bank's launch", got_r3, got3)
    t0 = time.perf_counter()
    want_r3 = streamsvm_scan_lookahead_many_ring_plain(*in3, **kw3r, ring_tile=bp, n_ctas=1)
    sync(dev)
    plain_r3 = (time.perf_counter() - t0) * 1e3
    err_r3 = check_state("B6 (Algorithm 2) against its plain version", got_r3, want_r3, live=b)
    ms_r3 = time_ms(lambda: streamsvm_scan_lookahead_many_ring(*in3, **kw3r), dev, reps)
    L3 = kw3["lookahead"][:b]
    flushes3 = int((-(-(got3[3][:b] - in3[6][:b]) // L3)).sum())
    # B3 at Fig 3's launches (phase 4a): one model over the permuted
    # training stream, as fit_lookahead hands it to B3 (the live count 1),
    # at L = 10 and at L = 50.
    Xf3, yf3 = (torch.as_tensor(a, device=dev) for a in algos["fig3"])
    in3f, n3f, live3f = seeded_bank_inputs(Xf3, yf3[None, :], torch.full((1,), 10.0, device=dev), 8)
    d3f = Xf3.shape[1]
    fig3_rows = {}
    for L in (10, 50):
        kw3f = dict(lookahead=torch.where(live3f, L, 1).to(torch.int32), lookahead_max=L,
                    n_valid=n3f, n_live=1)
        got3f = streamsvm_scan_lookahead_many(*in3f, **kw3f)
        plan3f = plan_of(in3f, kw3f)
        t0 = time.perf_counter()
        want3f = streamsvm_scan_lookahead_many_plain(*in3f, **no_live(kw3f))
        sync(dev)
        plain3f = (time.perf_counter() - t0) * 1e3
        err3f = check_state(f"B3 at the Fig 3 shape, L={L}", got3f, want3f, live=1)
        ms3f = time_ms(lambda: streamsvm_scan_lookahead_many(*in3f, **kw3f), dev, 10 * reps)
        pushes3f = float(got3f[3][0] - 1)
        fig3_rows[L] = dict(
            err=err3f, ms=ms3f, plain=plain3f, plan=plan3f, pushes=pushes3f,
            flushes=-(-int(pushes3f) // L),
            flops=2.0 * n3f * d3f + 2.0 * n3f * d3f + 3.0 * d3f * pushes3f,
            nbytes=4.0 * (n3f * d3f + n3f + 2 * d3f + 6))
    # B4 at Fig 3's shapes: one model over the permuted training stream.
    Xf, yf = (torch.as_tensor(a, device=dev) for a in algos["fig3"])
    n4 = Xf.shape[0] - 1
    Xf4, yf4 = ops._pad_to(Xf[1:], 256, 0), ops._pad_to(yf[1:], 256, 0)
    args4 = (Xf4, yf4, yf[0] * Xf[0], 0.0, 0.1, 0.1, 1, 0.1)
    got4 = streamsvm_scan(*args4, n_valid=n4)
    sync(dev)
    t0 = time.perf_counter()
    want4 = streamsvm_scan_plain(*args4, n_valid=n4)
    sync(dev)
    plain4 = (time.perf_counter() - t0) * 1e3
    err4 = check_state("B4 at the Fig 3 shape", got4, want4)
    ms4 = time_ms(lambda: streamsvm_scan(*args4, n_valid=n4), dev, 10 * reps)
    d4 = Xf.shape[1]
    # g = <w, y x> per row, the 32-row block Gram, and the deferred update.
    flops4 = 2.0 * n4 * d4 + 2.0 * n4 * 32 * d4 + 2.0 * n4 * d4
    bytes4 = 4.0 * (n4 * d4 + n4 + 2 * d4 + 6)
    # B2 at the main path's server step: 256 query slots against the bank.
    W = main["bank"].w
    Q = torch.as_tensor(make_blobs(256, args.classes, d, seed=args.seed + 3)[0], device=dev)
    nc = args.classes
    bias = torch.zeros(W.shape[0], device=dev)
    kw = dict(epilogue="ovr", q_block=256, b_tile=200 if 200 % nc == 0 else nc, nc_pad=nc)
    got2 = predict_bank_fused(Q, W, bias, **kw)
    want2 = predict_bank_plain(Q, W, bias, **kw)
    err2 = check_close("B2 at the main-path shape, margins", got2[1], want2[1], RTOL_W,
                       score_atol(want2[1]))
    ms2 = time_ms(lambda: predict_bank_fused(Q, W, bias, **kw), dev, 50 * reps)
    plain2 = time_ms(lambda: predict_bank_plain(Q, W, bias, **kw), dev, 50 * reps)
    # B6 serve at the same server step: B2's work and bound, B2's bits.
    got_r2 = predict_bank_ring(Q, W, bias, **kw)
    check_equal("B6 serve against B2 at the main-path step", got_r2, got2)
    err_r2 = check_close("B6 serve against its plain version, margins", got_r2[1],
                         predict_bank_ring_plain(Q, W, bias, **kw)[1], RTOL_W, score_atol(want2[1]))
    ms_r2 = time_ms(lambda: predict_bank_ring(Q, W, bias, **kw), dev, 50 * reps)
    plain_r2 = time_ms(lambda: predict_bank_ring_plain(Q, W, bias, **kw), dev, 50 * reps)
    flops2 = 2.0 * Q.shape[0] * W.shape[0] * d
    mm2 = time_ms(lambda: torch.matmul(Q, W.T), dev, 50 * reps)
    print(f"  torch.matmul, product only, no epilogue, at the server step ({Q.shape[0]} x "
          f"{W.shape[0]} x {d}): {mm2:.4f} ms (B2 ovr {ms2:.4f} ms, B6 serve ovr {ms_r2:.4f} ms)")
    bytes2 = 4.0 * (Q.shape[0] * d + W.shape[0] * (d + 1) + 2 * Q.shape[0] * (W.shape[0] // nc))

    row = kernel_row
    by_L = b3["fig3_by_L"]
    f10, f50 = fig3_rows[10], fig3_rows[50]
    kernels = [
        row("streamsvm_scan", "src/repro_torch/kernels/csrc/streamsvm_scan.cu",
            "src/repro/kernels/streamsvm_scan.py:800", main["launches"]["streamsvm_scan"],
            err1, ms1, plain1, flops1, bytes1, None,
            f"N={n} D={d} B={b} (bank padded to {bp}) f32; {layout_note(plan1)}"),
        row("predict_bank", "src/repro_torch/kernels/csrc/predict.cu",
            "src/repro/kernels/predict.py:321", main["launches"]["predict_bank"],
            err2, ms2, plain2, flops2, bytes2, None,
            f"Q=256 B={W.shape[0]} D={d} ovr n_classes={nc} f32"),
        row("streamsvm_scan_lookahead", "src/repro_torch/kernels/csrc/streamsvm_scan.cu",
            "src/repro/kernels/streamsvm_scan.py:800", b3["bank_launches"], b3["err"], ms3,
            b3["plain_ms"], flops3, bytes3, None,
            f"the Algorithm-2 bank's launch (phase 4b): N={n3} D={d} B={b} (bank padded to "
            f"{bp}) L=10 f32, {pushes:.0f} pushes, {flushes3} flushes; {layout_note(plan3)}"),
        row("streamsvm_scan_lookahead[fig3]", "src/repro_torch/kernels/csrc/streamsvm_scan.cu",
            "src/repro/kernels/streamsvm_scan.py:800", b3["fig3_launches"] - by_L.get(50, 0),
            f10["err"], f10["ms"], f10["plain"], f10["flops"], f10["nbytes"], None,
            f"Fig 3's single-model launches at L = 2, 5, 10, 20 (phase 4a), timed at: N={n3f} "
            f"D={d3f} B=1 (padded to 8) L=10 f32, {f10['pushes']:.0f} pushes, "
            f"{f10['flushes']} flushes; {layout_note(f10['plan'])}"),
        row("streamsvm_scan_lookahead[fig3 L=50]",
            "src/repro_torch/kernels/csrc/streamsvm_scan.cu",
            "src/repro/kernels/streamsvm_scan.py:800", by_L.get(50, 0), f50["err"], f50["ms"],
            f50["plain"], f50["flops"], f50["nbytes"], None,
            f"Fig 3's single-model launches at L = 50 (phase 4a): N={n3f} D={d3f} B=1 (padded "
            f"to 8) L=50 f32, {f50['pushes']:.0f} pushes, {f50['flushes']} flushes; "
            f"{layout_note(f50['plan'])}"),
        row("streamsvm_single", "src/repro_torch/kernels/csrc/streamsvm_single.cu",
            "src/repro/kernels/streamsvm_scan.py:639", algos["launches"]["streamsvm_scan"],
            err4, ms4, plain4, flops4, bytes4, None,
            f"N={n4} D={d4} one model f32, {int(got4[3]) - 1} updates, "
            f"{single_note(scan_mod.single_plan(d4), d4)} (B3's small layout on "
            f"this stream at L = 10: {f10['ms']:.4f} ms)"),
    ]
    # The scores epilogue against the library product, at the held-out size.
    Qs = torch.as_tensor(make_blobs(args.n_test, args.classes, d, seed=args.seed + 4)[0], device=dev)
    Qsp = ops._pad_to(Qs, 256, 0)
    ms_s = time_ms(lambda: predict_bank_fused(Qsp, W, bias, epilogue="scores", q_block=256), dev, 5 * reps)
    lib_s = time_ms(lambda: torch.matmul(Qs, W.T), dev, 5 * reps)
    bound_s = max(2.0 * len(Qs) * W.shape[0] * d / F32_PEAK,
                  4.0 * (len(Qs) * d + W.shape[0] * d + len(Qs) * W.shape[0]) / HBM_BYTES_PER_S) * 1e3
    print(f"  B2 scores at Q={len(Qs)}: kernel {ms_s:.4f} ms, torch.matmul {lib_s:.4f} ms, "
          f"bound {bound_s:.4f} ms (operations)")
    # B6 serve's scores at the held-out size, against B2 and the library.
    got_rs = predict_bank_ring(Qsp, W, bias, epilogue="scores", q_block=256)
    check_equal("B6 serve scores against B2 at Q=10,000",
                (got_rs,), (predict_bank_fused(Qsp, W, bias, epilogue="scores", q_block=256),))
    sync(dev)
    t0 = time.perf_counter()
    want_rs = predict_bank_ring_plain(Qsp, W, bias, epilogue="scores", q_block=256)
    sync(dev)
    plain_rs = (time.perf_counter() - t0) * 1e3
    err_rs = check_close("B6 serve scores against its plain version", got_rs, want_rs, RTOL_W,
                         score_atol(want_rs))
    ms_rs = time_ms(lambda: predict_bank_ring(Qsp, W, bias, epilogue="scores", q_block=256), dev,
                    5 * reps)
    flops_s = 2.0 * len(Qs) * W.shape[0] * d
    bytes_s = 4.0 * (len(Qs) * d + W.shape[0] * d + len(Qs) * W.shape[0])
    ring_src = "src/repro_torch/kernels/csrc/streamsvm_scan.cu"
    kernels += [
        row("streamsvm_scan_ring", ring_src, "src/repro/kernels/streamsvm_scan.py:899",
            ring["launches_a"]["streamsvm_scan_many_ring"], err_r, ms_r, plain_r, flops1, bytes1,
            None, f"phase 7a's first launch: N={n} D={d} B={b} (bank padded to {bp}) f32, "
            f"Algorithm 1 ({ring_note(args1[1], bp, d, False)}; B1 here {ms1:.4f} ms); plain: "
            "one ring tile"),
        row("streamsvm_scan_ring_lookahead", ring_src, "src/repro/kernels/streamsvm_scan.py:899",
            ring["launches_a"]["streamsvm_scan_lookahead_many_ring"], err_r3, ms_r3, plain_r3,
            flops3, bytes3, None, f"phase 7a's Algorithm-2 launch: N={n3} D={d} B={b} (bank "
            f"padded to {bp}) L=10 f32, {pushes:.0f} pushes ({ring_note(in3[1], bp, d, True)}; "
            f"B3 here {ms3:.4f} ms); plain: one ring tile"),
        row("predict_bank_ring", "src/repro_torch/kernels/csrc/predict.cu",
            "src/repro/kernels/predict.py:321", ring["launches_a"]["predict_bank_ring"], err_r2,
            ms_r2, plain_r2, flops2, bytes2, None,
            f"phase 7a's server step: Q=256 B={W.shape[0]} D={d} ovr n_classes={nc} f32"),
        row("predict_bank_ring[scores]", "src/repro_torch/kernels/csrc/predict.cu",
            "src/repro/kernels/predict.py:321", 0, err_rs, ms_rs, plain_rs, flops_s, bytes_s,
            lib_s, f"Q={len(Qs)} B={W.shape[0]} D={d} scores f32, a yardstick against "
            "torch.matmul (library_ms): no path of this run launches the scores epilogue"),
    ]
    kernels += ring_7b_rows(dev, args, ring, row)
    print(f"  B6 train (Algorithm 1): kernel {ms_r:.4f} ms ({ring_note(args1[1], bp, d, False)}; "
          f"B1 {ms1:.4f}), plain {plain_r:.1f} ms; (Algorithm 2): kernel {ms_r3:.4f} ms "
          f"({ring_note(in3[1], bp, d, True)}; B3 {ms3:.4f}), plain {plain_r3:.1f} ms; B4 at "
          f"Fig 3's shape {ms4:.4f} ms (B3's small layout there, L=10: {f10['ms']:.4f}); B6 "
          f"serve: ovr step {ms_r2:.4f} ms (B2 {ms2:.4f}), scores at Q={len(Qs)} {ms_rs:.4f} ms "
          f"(B2 {ms_s:.4f})")
    print(f"  B1 at phase 3's chunk {ms1:.4f} ms ({layout_note(plan1)}); B3 at 4b's launch "
          f"{ms3:.4f} ms ({layout_note(plan3)}, {pushes:.0f} pushes, {flushes3} flushes); B3 at "
          f"Fig 3's launch L=10 {f10['ms']:.4f} ms ({layout_note(f10['plan'])}, "
          f"{f10['pushes']:.0f} pushes, {f10['flushes']} flushes), L=50 {f50['ms']:.4f} ms "
          f"({layout_note(f50['plan'])}, {f50['pushes']:.0f} pushes, {f50['flushes']} flushes)")
    kernels += kernel_bank_rows_json(dev, kb, kbc, kbres, row, reps, args.kb_check_tiles)
    return kernels



def lane_prefix_runs(fn, inp, runs, lanes, **kw):
    """``fn`` (B6 train or its plain version) over a bank of ``lanes`` lanes,
    lane j a copy of model ``runs[j][0]``'s lane of ``inp``
    (``seeded_bank_inputs``) with its signs zeroed past its first
    ``runs[j][1]`` rows, the unused lanes' everywhere. A row whose sign is 0
    moves no state (s = 0, nothing pushed), so lane j ends in the state of
    the prefix run ``fn(n_valid=runs[j][1])`` of its model, partial window
    flushed: one call gives several prefixes of several models. ``kw``: the
    wrapper's keywords (a (B,) ``lookahead`` is taken lane by lane).
    Returns [(w, r, xi2, m)] per run."""
    X, Y, W0, r0, xi20, c_inv, m0, gain = inp
    if len(runs) > lanes:
        raise ValueError(f"{len(runs)} prefixes in a bank of {lanes} lanes")
    src = torch.tensor([m for m, _ in runs] + [runs[0][0]] * (lanes - len(runs)),
                       device=Y.device)
    pick = lambda t: t.index_select(0, src).contiguous()
    if max(nv for _, nv in runs) == 0:  # every lane is its seed
        return [(W0[m], r0[m], xi20[m], m0[m]) for m, _ in runs]
    cut = torch.zeros(lanes, dtype=torch.long, device=Y.device)
    cut[: len(runs)] = torch.tensor([nv for _, nv in runs], device=Y.device)
    Yl = pick(Y).masked_fill(torch.arange(Y.shape[1], device=Y.device)[None, :] >= cut[:, None], 0)
    kw = {k: pick(v) if k == "lookahead" else v for k, v in kw.items()}
    out = fn(X, Yl, *(pick(t) for t in (W0, r0, xi20, c_inv, m0, gain)),
             n_valid=max(nv for _, nv in runs), **kw)
    return [tuple(x[j] for x in out) for j in range(len(runs))]


def lane_equal(got, lane):
    """A prefix run's (w, m) against the whole launch's lane, bit for bit."""
    return int(got[3]) == int(lane[3]) and torch.equal(got[0], lane[0])


def certify_7b_partings(dev, inp, n, parted, got, want, lookahead):
    """C5: every model of ``parted`` (7b's launch, ``got`` the ring's states,
    ``want`` the plain version's) certified at its first parting, or the
    phase fails. The plain version runs on the parted models' lanes alone,
    each call one ring tile holding all its prefixes (``lane_prefix_runs``;
    its products are taken LANE_GROUP lanes at a time, so a lane's bits do
    not depend on the tile's width), its run over the whole stream held
    first to the whole plain run's lane bit for bit (else the phase fails);
    the ring runs prefixes in banks of the launch's width. Prints the calls'
    count and seconds. Algorithm
    1 (``lookahead`` None): an 8-way search for the first prefix whose m
    parts, then ``parting_tie``'s float64 margin. Algorithm 2: the ring's
    pushes from its m over every 40th prefix and then every prefix of the
    strides where m grows, the plain states at every segment end of every
    parted model in one call, and ``stream_parting`` (lookahead 10) over
    the model's stream. Returns the certificates."""
    from repro_torch.kernels.partings import stream_parting
    from repro_torch.kernels.streamsvm_scan import (
        LANE_GROUP,
        streamsvm_scan_lookahead_many_ring,
        streamsvm_scan_lookahead_many_ring_plain,
        streamsvm_scan_many_ring,
        streamsvm_scan_many_ring_plain,
    )

    bp = inp[2].shape[0]
    if lookahead is None:
        k_fn, p_fn, kw = streamsvm_scan_many_ring, streamsvm_scan_many_ring_plain, {}
    else:
        k_fn, p_fn = streamsvm_scan_lookahead_many_ring, streamsvm_scan_lookahead_many_ring_plain
        kw = dict(lookahead=torch.full((bp,), lookahead, dtype=torch.int32, device=dev),
                  lookahead_max=lookahead)
    k_cache, p_cache = {}, {}
    spent = {"ring": [0, 0.0], "plain": [0, 0.0]}  # calls, seconds

    def cached(cache, fn, width, runs, what, **extra):
        todo = sorted({r for r in runs if r not in cache})
        for i in range(0, len(todo), width):
            part = todo[i : i + width]
            t0 = time.perf_counter()
            cache.update(zip(part, lane_prefix_runs(fn, inp, part, width, **kw, **extra)))
            sync(dev)
            spent[what][0] += 1
            spent[what][1] += time.perf_counter() - t0
        return [cache[r] for r in runs]

    kernel = lambda runs: cached(k_cache, k_fn, bp, runs, "ring")

    def plain(runs):  # one tile holds them
        width = -(-len(runs) // LANE_GROUP) * LANE_GROUP
        return cached(p_cache, p_fn, width, runs, "plain", ring_tile=width, n_ctas=1)

    zs = {}

    def parting_args(model):
        """stream_parting's stream (row 0 the seed y_0 x_0, the W0 lane),
        1/C, gain, lookahead and tolerances for ``model``."""
        if model not in zs:
            X, Y = inp[0], inp[1]
            zs[model] = torch.cat([inp[2][model][None, :] * 1.0,
                                   Y[model, :n, None] * X[:n]]).double().cpu()
        return (zs[model], float(inp[5][model]), float(inp[7][model]), lookahead)

    # The first plain call: each model's whole stream among its first prefixes.
    first, pushes = [], {}
    for model in parted:
        if not lane_equal(kernel([(model, n)])[0], tuple(x[model] for x in got)):
            raise AssertionError(f"C5: model {model}: the ring over its lane alone differs from "
                                 "its lane of the whole launch")
        if lookahead is None:  # the 8-way search's first round
            first += [(model, n * (i + 1) // 8) for i in range(8)]
            continue
        coarse = list(range(0, n, 40)) + [n]
        mk = [int(t[3]) for t in kernel([(model, v) for v in coarse])]
        fine = [v for a, b, ma, mb in zip(coarse, coarse[1:], mk, mk[1:]) if mb != ma
                for v in range(a + 1, b)]
        m_at = dict(zip(coarse, mk))
        m_at.update(zip(fine, (int(t[3]) for t in kernel([(model, v) for v in fine]))))
        pushes[model] = [v for a, b, ma, mb in zip(coarse, coarse[1:], mk, mk[1:]) if mb != ma
                         for v in range(a + 1, b + 1) if m_at[v] != m_at[v - 1]]  # stream rows
        ends = {p + 1 for p in pushes[model][lookahead - 1 :: lookahead]} | {n + 1}
        first += [(model, e - 1) for e in sorted(ends)] + [(model, 0)]
    if first:
        plain(first)
    for model in parted:
        if not lane_equal(plain([(model, n)])[0], tuple(x[model] for x in want)):
            raise AssertionError(f"C5: model {model}: the plain version over its lane alone "
                                 "differs from its lane of the whole plain run")
    certs = []
    if lookahead is not None:
        # stream_parting asks for the plain states its replay needs (the rows
        # whose push test is within the f32 bound, one after another): run it
        # on the cache alone, the ring's state standing in for each state the
        # cache lacks, so one dry run names all it asks for; gather every
        # model's misses into one plain call and repeat until none is missed.
        misses = set()

        def dry(model, nv):
            if (model, nv - 1) not in p_cache:
                misses.add((model, nv - 1))
                return kernel([(model, nv - 1)])[0]
            return p_cache[(model, nv - 1)]

        while True:
            misses.clear()
            for model in parted:
                stream_parting(lambda nv: kernel([(model, nv - 1)])[0],
                               lambda nv: dry(model, nv), *parting_args(model),
                               rtol=RTOL_W, atol=ATOL_W, pushes_a=pushes[model])
            if not misses:
                break
            plain(sorted(misses))
    for model in parted:
        if lookahead is None:
            lo, hi = 0, n
            while hi - lo > 1:
                pts = sorted({lo + (hi - lo) * (i + 1) // 8 for i in range(7)} - {lo} | {hi})
                runs = [(model, v) for v in pts]
                ms = [(int(a[3]), int(b[3])) for a, b in zip(kernel(runs), plain(runs))]
                i = next(i for i, (a, b) in enumerate(ms) if a != b)
                lo, hi = (pts[i - 1] if i else lo), pts[i]
            row, dist, r, bound = parting_tie(None, None, inp, n, model, lo=lo, hi=hi)
            cert = dict(model=model, kind="push", row=row + 1, margin=dist - r, bound=bound,
                        rel=(dist - r) / r, rel_bound=bound / r, tie=abs(dist - r) <= bound)
        else:
            part = stream_parting(lambda nv: kernel([(model, nv - 1)])[0],
                                  lambda nv: plain([(model, nv - 1)])[0],
                                  *parting_args(model), rtol=RTOL_W, atol=ATOL_W,
                                  pushes_a=pushes[model])
            if part is None:
                raise AssertionError(f"C5: model {model}: its lane alone does not part")
            cert = dict(model=model, **part, rel=part["margin"], rel_bound=part["bound"])
        certs.append(cert)
        what = "a tie" if cert["tie"] else "NOT a tie"
        print(f"  C5: {'Algorithm 1' if lookahead is None else 'Algorithm 2'} model {model} "
              f"first parts at stream row {cert['row']} ({cert['kind']}): float64 margin "
              f"{cert['margin']:.3e} against the f32 bound {cert['bound']:.3e}"
              + (f" ((dist - r)/r {cert['rel']:.3e}, bound {cert['rel_bound']:.3e} of r)"
                 if lookahead is None else "") + f": {what}")
        if not cert["tie"]:
            raise AssertionError(f"C5: model {model} parts from the plain version at stream row "
                                 f"{cert['row']}, not on an f32 tie: {cert}")
    if parted:
        print(f"  C5: {'Algorithm 1' if lookahead is None else 'Algorithm 2'}: {spent['ring'][0]} "
              f"ring calls {spent['ring'][1]:.1f} s, {spent['plain'][0]} plain calls (one tile "
              f"each) {spent['plain'][1]:.1f} s")
    return certs


def ring_7b_rows(dev, args, ring, row):
    """Phase 5's rows for B6 at phase 7b's launches (1,536 x 4,096): the
    Algorithm-1 and Algorithm-2 fits over the whole stream and the ovr
    serve of the held-out rows, each with the count of its launches in 7b,
    B1's / B3's / B2's time at the same launch beside it, and one plain call.
    Where a model's m parts from the plain version's over the 60,000 rows,
    its first parting is certified as an f32 tie (``certify_7b_partings``,
    ROADMAP C5) or the phase fails; max_abs_err is over the models whose m
    agrees."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.predict import (
        predict_bank_fused,
        predict_bank_ring,
        predict_bank_ring_plain,
    )
    from repro_torch.kernels.streamsvm_scan import (
        streamsvm_scan_lookahead_many,
        streamsvm_scan_lookahead_many_ring,
        streamsvm_scan_lookahead_many_ring_plain,
        streamsvm_scan_many,
        streamsvm_scan_many_ring,
        streamsvm_scan_many_ring_plain,
    )

    b7, lb = ring["b7"], ring["launches_b"]
    reps = 1 if dev.type == "cpu" else 2
    b, bp, d = b7["Y"].shape[0], b7["bp"], b7["X"].shape[1]
    src = "src/repro_torch/kernels/csrc/streamsvm_scan.cu"
    ref = "src/repro/kernels/streamsvm_scan.py:899"
    inp, n, live = seeded_bank_inputs(b7["X"], b7["Y"], b7["cs"], bp)

    def against_plain(name, got, plain_fn):
        sync(dev)
        t0 = time.perf_counter()
        want = plain_fn()
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = got[3][:b] == want[3][:b]
        err = check_state(name, [x[:b][same] for x in got], [x[:b][same] for x in want])
        return err, plain_ms, (~same).nonzero().flatten().tolist(), want

    def certified(certs):
        return "; ".join(f"model {c['model']} at stream row {c['row']} ({c['kind']}, margin "
                         f"{c['margin']:.3e}, bound {c['bound']:.3e})" for c in certs)

    out, notes, c5_s = [], [], 0.0
    got = streamsvm_scan_many_ring(*inp, n_valid=n)
    ms = time_ms(lambda: streamsvm_scan_many_ring(*inp, n_valid=n), dev, reps)
    ms_b1 = time_ms(lambda: streamsvm_scan_many(*inp, n_valid=n), dev, reps)
    plan_b1 = plan_of(inp, dict(n_valid=n))
    err, plain, parted, want = against_plain(
        "7b's Algorithm-1 launch against its plain version", got,
        lambda: streamsvm_scan_many_ring_plain(*inp, n_valid=n, ring_tile=bp, n_ctas=1))
    t0 = time.perf_counter()
    certs1 = certify_7b_partings(dev, inp, n, parted, got, want, None)
    c5_s += time.perf_counter() - t0
    out.append(row(
        "streamsvm_scan_ring[7b]", src, ref, lb["streamsvm_scan_many_ring"], err, ms, plain,
        4.0 * b * n * d + 2.0 * n * 32 * d + 6.0 * b * n * 32,
        4.0 * (n * d + b * n + 2 * b * d + 6 * b), None,
        f"phase 7b's Algorithm-1 launch: N={n} D={d} B={b} f32, {ring_note(inp[1], bp, d, False)} "
        f"(B1 at this launch {ms_b1:.3f} ms: {layout_note(plan_b1)}); max_abs_err over the "
        f"{b - len(parted)} models whose m the plain version matches; "
        f"{len(parted)} parted, each at a certified f32 tie" + (
            f" ({certified(certs1)})" if certs1 else "")))
    notes.append(f"Algorithm 1 {ms:.3f} ms ({ring_note(inp[1], bp, d, False)}; B1 {ms_b1:.3f}: "
                 f"{layout_note(plan_b1)}), "
                 f"plain {plain / 1e3:.1f} s, {len(parted)} models part, each first at a "
                 f"certified f32 tie: {parted}")
    if b7["la_m"] is not None:
        kw = dict(lookahead=torch.where(live, 10, 1).to(torch.int32), lookahead_max=10,
                  n_valid=n)
        got = streamsvm_scan_lookahead_many_ring(*inp, **kw)
        ms = time_ms(lambda: streamsvm_scan_lookahead_many_ring(*inp, **kw), dev, reps)
        ms_b3 = time_ms(lambda: streamsvm_scan_lookahead_many(*inp, **kw), dev, reps)
        plan_b3 = plan_of(inp, kw)
        flushes = int((-(-(b7["la_m"] - 1) // 10)).sum())
        err, plain, parted, want = against_plain(
            "7b's Algorithm-2 launch against its plain version", got,
            lambda: streamsvm_scan_lookahead_many_ring_plain(*inp, **kw, ring_tile=bp, n_ctas=1))
        t0 = time.perf_counter()
        certs2 = certify_7b_partings(dev, inp, n, parted, got, want, 10)
        c5_s += time.perf_counter() - t0
        pushes = float((b7["la_m"] - 1).sum())
        out.append(row(
            "streamsvm_scan_ring_lookahead[7b]", src, ref,
            lb["streamsvm_scan_lookahead_many_ring"], err, ms, plain,
            2.0 * b * n * d + 2.0 * n * d + 3.0 * d * pushes,
            4.0 * (n * d + b * n + 2 * b * d + 6 * b), None,
            f"phase 7b's Algorithm-2 launch: N={n} D={d} B={b} L=10 f32, {pushes:.0f} pushes, "
            f"{flushes} flushes, {ring_note(inp[1], bp, d, True)} (B3 at this launch "
            f"{ms_b3:.3f} ms: {layout_note(plan_b3)}); "
            f"max_abs_err over the {b - len(parted)} models whose m the plain version matches; "
            f"{len(parted)} parted, each at a certified f32 tie" + (
                f" ({certified(certs2)})" if certs2 else "")))
        notes.append(f"Algorithm 2 {ms:.3f} ms ({ring_note(inp[1], bp, d, True)}; B3 "
                     f"{ms_b3:.3f}: {layout_note(plan_b3)}), plain "
                     f"{plain / 1e3:.1f} s, {len(parted)} models part, each first at a "
                     f"certified f32 tie: {parted}")
    # The ovr serve of 7b's held-out rows, as ops.predict_bank hands it over.
    nc = b7["n_classes"]
    g = b // nc
    nc_pad, g_tile, gp = ops.ovr_group_tiling(b, nc, 64)
    Q = ops._pad_to(b7["Xte"].float(), 256, 0)
    Wp = ops._pad_to(ops._pad_to(b7["w"].reshape(g, nc, d), nc_pad, 1), gp, 0).reshape(-1, d)
    lane = torch.arange(gp * nc_pad, device=dev)
    bias = torch.where((lane % nc_pad < nc) & (lane // nc_pad < g), 0.0,
                       ops.NEG_MASK).to(torch.float32)
    kw = dict(epilogue="ovr", q_block=256, b_tile=g_tile * nc_pad, nc_pad=nc_pad)
    got = predict_bank_ring(Q, Wp, bias, **kw)
    check_equal("7b's serve: the ring against B2", got, predict_bank_fused(Q, Wp, bias, **kw))
    sync(dev)
    t0 = time.perf_counter()
    want = predict_bank_ring_plain(Q, Wp, bias, **kw)
    sync(dev)
    plain = (time.perf_counter() - t0) * 1e3
    err = check_close("7b's serve against its plain version, margins", got[1], want[1], RTOL_W,
                      score_atol(want[1]))
    ms = time_ms(lambda: predict_bank_ring(Q, Wp, bias, **kw), dev, 5 * reps)
    ms_b2 = time_ms(lambda: predict_bank_fused(Q, Wp, bias, **kw), dev, 5 * reps)
    q, bl = Q.shape[0], Wp.shape[0]
    mm = time_ms(lambda: torch.matmul(Q, Wp.T), dev, 5 * reps)
    print(f"  torch.matmul, product only, no epilogue, at 7b's serve ({q} x {bl} x {d}): "
          f"{mm:.4f} ms (B2 ovr {ms_b2:.4f} ms, B6 serve ovr {ms:.4f} ms)")
    out.append(row(
        "predict_bank_ring[7b]", "src/repro_torch/kernels/csrc/predict.cu",
        "src/repro/kernels/predict.py:321", lb["predict_bank_ring"], err, ms, plain,
        2.0 * q * bl * d, 4.0 * (q * d + bl * (d + 1) + 2 * q * g), None,
        f"phase 7b's serve: Q={q} B={b} (padded to {bl}) D={d} ovr n_classes={nc} f32 "
        f"(B2 at this launch {ms_b2:.4f} ms)"))
    notes.append(f"serve {ms:.4f} ms (B2 {ms_b2:.4f}), plain {plain:.1f} ms")
    print("  B6 at phase 7b's launches: " + "; ".join(notes))
    print(f"  C5: the partings' certification took {c5_s:.1f} s")
    return out


def kernel_bank_rows_json(dev, kb, kbc, kbres, row, reps, t):
    """Phase 5's rows for B5 (K_cs launch, served step at Q = --n-test, the
    row norms) and R1 (tile --kb-check-tiles and tile 0, per eviction)."""
    from repro_torch.core.kernel_bank import KernelBank
    from repro_torch.kernels.gram import gram_fused, gram_plain, row_norms, row_norms_plain
    from repro_torch.kernels.kernel_bank import (
        kernel_bank_rows,
        kernel_bank_rows_plain,
        rows_layouts,
        rows_plan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in full f32
    out = []
    gsrc, gref = "src/repro_torch/kernels/csrc/gram.cu", "src/repro/kernels/gram.py:83"

    def gram_row(name, A, P, launches, what):
        m, dd = A.shape
        n = P.shape[0]
        an, pn = row_norms(A), row_norms(P)
        call = lambda: gram_fused(A, P, an, pn, KB_GAMMA, epilogue="rbf")
        got = call()
        sync(dev)
        t0 = time.perf_counter()
        want = gram_plain(A, P, an, pn, KB_GAMMA, epilogue="rbf")
        sync(dev)
        plain = (time.perf_counter() - t0) * 1e3
        err = bit_equal(name, got, want)
        del got, want
        ms = time_ms(call, dev, reps)
        lib = time_ms(lambda: torch.matmul(A, P.T), dev, reps)
        # 2 M N D for the products and sums, 6 M N for the RBF epilogue
        flops = 2.0 * m * n * dd + 6.0 * m * n
        nbytes = 4.0 * (m * dd + n * dd + m + n + m * n)
        r = row(name, gsrc, gref, launches, err, ms, plain, flops, nbytes, lib,
                f"{what}: M={m} N={n} D={dd} rbf f32 (library_ms: torch.matmul, the linear "
                "Gram without the RBF epilogue; no one call computes the RBF Gram)")
        print(f"  {name} ({what}): kernel {ms:.4f} ms, plain {plain:.1f} ms, torch.matmul "
              f"{lib:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        return r

    bank = kbres["banks"]["smallest-coef"]
    b, s, d = bank.points.shape
    P = bank.points.reshape(b * s, d)
    A = kbc["kcs"]["A"]
    # Phase 6b's launches have two shapes: each training tile's K_cs block
    # and every 256-row served step (BankServer scores a kernel bank in
    # q_block steps) are 256 x B S; each tile's K_tt is 256 x 256. One R1
    # launch a tile counts the tiles.
    ktt = sum(kbres["rows_launches"].values())
    if kbres["train_launches"]["gram_fused"] != 2 * ktt:
        raise AssertionError(f"phase 6b: {kbres['train_launches']['gram_fused']} training "
                             f"launches of B5 over {ktt} tiles, not one K_cs and one K_tt each")
    out.append(gram_row("gram", A, P, kbres["launches"]["gram_fused"] - ktt,
                        "the K_cs launch of a training tile and of a served step"))
    out.append(gram_row("gram[K_tt]", A, A, ktt, "the K_tt launch of a training tile"))
    Q = torch.as_tensor(kb["Xte"], device=dev)
    out.append(gram_row("gram[yardstick]", Q, P, 0,
                        f"a yardstick: Q={Q.shape[0]} queries in one launch, which no path of "
                        "this run makes"))
    del Q

    X = torch.as_tensor(kb["X"], device=dev)
    got = row_norms(X)
    sync(dev)
    t0 = time.perf_counter()
    want = row_norms_plain(X)
    sync(dev)
    plain = (time.perf_counter() - t0) * 1e3
    err = check_close("row norms", got, want, 0.0, 0.0)
    ms = time_ms(lambda: row_norms(X), dev, reps)
    lib = time_ms(lambda: (X * X).sum(1), dev, reps)
    n, dd = X.shape
    r = row("gram_row_norms", gsrc, "src/repro/kernels/gram.py:77",
            kbres["launches"]["row_norms"], err, ms, plain, 2.0 * n * dd, 4.0 * (n * dd + n),
            lib, f"N={n} D={dd} f32 (library_ms: (X * X).sum(1), another summation order)")
    out.append(r)
    print(f"  gram_row_norms: kernel {ms:.4f} ms, plain {plain:.1f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del X

    # R1 at tile t of the pass (the state phase 2 reached) and at tile 0
    # (the seeding tile, from the empty bank): every layout bit-equal to the
    # plain version, each timed in turns over R1_ROUNDS rounds by events
    # (the row's ms, as the other rows) and on the card alone (device_ms);
    # the row takes the planned layout's medians.
    empty = KernelBank(idx=torch.full((b, s), -1, dtype=torch.int32, device=dev),
                       coef=torch.zeros(b, s, device=dev), points=torch.zeros(b, s, d, device=dev),
                       q=torch.zeros(b, device=dev), r=torch.zeros(b, device=dev),
                       xi2=torch.zeros(b, device=dev), m=torch.zeros(b, dtype=torch.int32,
                                                                     device=dev))
    launches_per_pass = kbres["rows_launches"]
    for at in (t, 0):
        for ev in ("smallest-coef", "farthest-point"):
            far = ev == "farthest-point"
            inp = rows_inputs(dev, kb, kbc[ev]["state"] if at else empty, at, far)
            sync(dev)
            t0 = time.perf_counter()
            want = run_rows(kernel_bank_rows_plain, inp)
            sync(dev)
            plain = (time.perf_counter() - t0) * 1e3
            planned = rows_plan(b, s, farthest=far)["layout"]
            rounds = {}
            for lay in rows_layouts(b, s, farthest=far):
                fn = functools.partial(kernel_bank_rows, smem_budget=sum(lay["smem"].values()))
                got = run_rows(fn, inp)
                sync(dev)
                for leaf, g, w in zip(("idx", "coef", "q", "r", "xi2", "m", "kbb"), got, want):
                    bit_equal(f"R1 {ev} {lay['layout']} at tile {at}: {leaf}", g, w)
                rounds[lay["layout"]] = fn
            times = {(name, card): [] for name in rounds for card in (False, True)}
            for _ in range(R1_ROUNDS):
                for (name, card), v in times.items():
                    v.append(time_rows_ms(rounds[name], inp, dev, 2 * reps, card_only=card))
            med = {key: float(np.median(v)) for key, v in times.items()}
            ms, card_ms = med[planned, False], med[planned, True]
            k_cs, k_tt, y = inp["args"]
            bn = k_tt.shape[0]
            live_rows = float((y != 0).sum())  # (model, row) pairs that reach g and d^2
            absorbed = float((want[5] - inp["state"][5]).sum())
            updating = float((want[5] != inp["state"][5]).sum())  # models that absorb a row
            # g (2S) and ~12 scalar operations per live pair; per absorb the
            # (1-s) scaling and the slot choice (S, or 2 S^2 + 4 S for
            # farthest-point's scores); kbb's row and column writes. Bytes:
            # K_cs, K_tt and y read once, the state read and written once,
            # and for farthest-point the S x S Kbb slab of each model that
            # absorbs a row (the others' slabs are not touched).
            flops = live_rows * (2 * s + 12) + absorbed * (2 * s + (2 * s * s + 4 * s if far else s))
            nbytes = 4.0 * (bn * b * s + bn * bn + b * bn + 2 * b + 2 * (2 * b * s + 4 * b)
                            + (2 * s * s * updating if far else 0))
            spread = ", ".join(
                f"{name} {med[name, card]:.4f} ({min(v):.4f}-{max(v):.4f})"
                + (" on the card alone" if card else " by events") for (name, card), v in times.items())
            what = (f"tile {at} of the pass" if at else
                    "tile 0, the seeding tile from the empty bank (one launch of each pass, "
                    "also counted in the tile-8 row's launches)")
            r = row(f"kernel_bank_rows[{ev}]" + ("" if at else "[tile 0]"),
                    "src/repro_torch/kernels/csrc/kernel_bank.cu",
                    "src/repro/core/kernel_bank.py:251 (row_body, a lax.scan: no pl.pallas_call)",
                    launches_per_pass[ev] if at else 1, 0.0, ms, plain, flops, nbytes, None,
                    f"one tile: block_n={bn} B={b} S={s}, {what}, {absorbed:.0f} absorbs by "
                    f"{updating:.0f} models of {live_rows:.0f} live (model, row) pairs; layout "
                    f"{planned}; ms: CUDA events around {2 * reps} launches back to back "
                    f"(the wrapper's host time between them included), device_ms: the same "
                    f"launches queued behind a spin (the card alone); medians of {R1_ROUNDS} "
                    f"rounds; every layout bit-equal to the plain version, medians (range): "
                    f"{spread}")
            r["device_ms"] = card_ms
            out.append(r)
            print(f"  R1 {ev} at tile {at}: {absorbed:.0f} absorbs by {updating:.0f} models; "
                  f"kernel {ms:.4f} ms per tile by events, {card_ms:.4f} ms on the card alone "
                  f"({planned}, medians of {R1_ROUNDS} rounds; every layout: {spread}), plain "
                  f"{plain:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); bit-equal")
    return out


# ----------------------------------------------------------------------------
# P1 and P2 (the perceptron and Pegasos), and phase 11: the paper's baselines


def check_p1(label, X, y, plain_dev=None):
    """P1 against its plain version on X, y (run on ``plain_dev``, default
    X's device): the same mistakes row for row (n_updates equal) and w within
    the engine tolerance, or a first parting certified as an f32 tie
    (``perceptron_parting``). Returns the w max|err| (None after a tie) and
    the plain version's ms (one host-clocked call)."""
    from repro_torch.kernels.baselines import perceptron_scan, perceptron_scan_plain
    from repro_torch.kernels.partings import perceptron_parting

    pd = X.device if plain_dev is None else torch.device(plain_dev)
    fk = torch.zeros(X.shape[0], dtype=torch.uint8, device=X.device)
    wk, mk = perceptron_scan(X, y, flags=fk)
    X, y, fk, wk, mk = (t.to(pd) for t in (X, y, fk, wk, mk))
    fp = torch.zeros_like(fk)
    sync(pd)
    t0 = time.perf_counter()
    wp, mp = perceptron_scan_plain(X, y, flags=fp)
    sync(pd)
    plain = (time.perf_counter() - t0) * 1e3
    part = perceptron_parting(X, y, fk, fp)
    if part is not None:
        if not part["tie"]:
            raise AssertionError(f"P1 {label}: parts from its plain version at {part}")
        print(f"  P1 {label}: parts from its plain version at a certified f32 tie {part}")
        return None, plain
    if int(mk) != int(mp):
        raise AssertionError(f"P1 {label}: {int(mk)} updates, plain {int(mp)}")
    err = check_close(f"P1 {label} w", wk, wp, RTOL_W, ATOL_W)
    print(f"  P1 {label}: the same {int(mk)} mistakes row for row, w max|err| {err:.3e}, plain "
          f"{plain:.1f} ms on {pd.type}")
    return err, plain


def check_p2(label, X, y, lam, k, plans=None, plain_dev=None):
    """P2 against its plain version (k rows a step, the trailing partial step
    dropped; run once on ``plain_dev``, default X's device): in each of
    ``plans`` (launched through the private ``_launch``; default: the
    planned layout through ``pegasos_scan``), the same violations row for
    row and w within the engine tolerance, or a first parting certified as
    an f32 tie (``pegasos_parting``, with the walk's terms for a walk).
    Returns ``gap`` (the last plan's w max|err|, measured after a tie too),
    ``viol`` (its violations) and ``plain`` (the plain version's ms, one
    host-clocked call)."""
    from repro_torch.kernels import baselines as kbl
    from repro_torch.kernels.partings import pegasos_parting

    pd = X.device if plain_dev is None else torch.device(plain_dev)
    n = X.shape[0] // k * k
    Xk, yk = X[:n], y[:n]
    Xp, yp = Xk.to(pd), yk.to(pd)
    fp = torch.zeros(n, dtype=torch.uint8, device=pd)
    sync(pd)
    t0 = time.perf_counter()
    wp = kbl.pegasos_scan_plain(Xp, yp, lam, k, flags=fp)
    sync(pd)
    plain = (time.perf_counter() - t0) * 1e3
    gap = viol = None
    for plan in plans or [None]:
        def run(m, flags=None, plan=plan):
            if plan is None or Xk.device.type == "cpu":  # the plain version on the CPU
                return kbl.pegasos_scan(Xk[:m], yk[:m], lam, k, flags=flags)
            w = torch.zeros(Xk.shape[1], device=Xk.device)
            if m:
                kbl._launch(plan, Xk[:m], yk[:m], lam, k, w, flags)
            return w

        used = plan or kbl.pegasos_plan(X.shape[1], k)
        note = layout_note(used)
        fk = torch.zeros(n, dtype=torch.uint8, device=X.device)
        wk = run(n, fk).to(pd)
        fk = fk.to(pd)
        states = lambda t, run=run: (run(t * k).to(pd),
                                     kbl.pegasos_scan_plain(Xp[: t * k], yp[: t * k], lam, k))
        part = pegasos_parting(Xp, yp, lam, k, fk, fp, states,
                               walk_rows=used.get("rows"))
        gap, viol = float((wk - wp).abs().max()), int(fk.sum())
        if part is not None:
            if not part["tie"]:
                raise AssertionError(f"P2 {label} ({note}): parts from its plain version at "
                                     f"{part}")
            print(f"  P2 {label} ({note}): parts from its plain version at a certified f32 tie "
                  f"{part}; w max|err| {gap:.3e}")
            continue
        check_close(f"P2 {label} ({note}) w", wk, wp, RTOL_W, ATOL_W)
        print(f"  P2 {label} ({note}): the same {viol} violations row for row, w max|err| "
              f"{gap:.3e}")
    print(f"  P2 {label}: plain {plain:.1f} ms on {pd.type}")
    return dict(gap=gap, viol=viol, plain=plain)


def layout_note(plan):
    """P2's layout in a few words: the walk's rows a block and B4's staging,
    or the step form's name."""
    from repro_torch.kernels.streamsvm_scan import SINGLE_DC

    if plan["layout"] == "blocks":
        return f"walk over blocks, {plan['rows']} rows a block, split over a cluster"
    if plan["layout"] != "walk":
        return plan["layout"]
    staging = ("whole blocks staged" if plan["chunk"] != SINGLE_DC
               else f"{SINGLE_DC}-column chunks")
    return (f"walk, {plan['rows']} rows a block, {staging}, w in "
            f"{'shared' if plan['w_in_smem'] else 'device'} memory")


def check_baselines(dev, args):
    """Phase 2: P1 and P2 against their plain versions on the card, at
    mnist89's D = 784 and synthetic_a's D = 2 (--fig3-n-train rows of each),
    P2 at k = 1, 20 and 7 (N not whole steps of 7) in every layout
    (``pegasos_layouts``: the walk in B4's three layouts, the walk over
    blocks where it takes k, the step form staged and in place); on
    the card, P2's dynamic shared memory against its byte model in every
    layout."""
    from repro_torch.data import load_dataset, preprocess_for
    from repro_torch.kernels import _build
    from repro_torch.kernels.baselines import (
        _blocks_lib, _pegasos_lib, _walk_lib, pegasos_layouts)

    for name in ("mnist89", "synthetic_a"):
        Xtr, ytr, Xte, _ = load_dataset(name, seed=args.seed)
        Xtr, _ = preprocess_for(name, Xtr, Xte)
        n = min(len(ytr), args.fig3_n_train)
        X, y = torch.as_tensor(Xtr[:n], device=dev), torch.as_tensor(ytr[:n], device=dev)
        d = X.shape[1]
        print(f"[2] P1 and P2 against their plain versions: {name}, N={n}, D={d}")
        check_p1(name, X, y)
        lam = 1.0 / (10.0 * n)  # Table 1's lambda at C = 10
        for k in (1, 20, 7):
            check_p2(f"{name} k={k} lam={lam:.3g}", X, y, lam, k, pegasos_layouts(d, k))
    if dev.type == "cuda":
        for kern in ("pegasos_kernel", "pegasos_blocks_kernel"):
            if _build.static_smem("baselines", kern) != {0}:
                raise AssertionError(f"{kern}: static shared memory beside the byte model's 0")
        lib, slib, blib = _pegasos_lib(), _walk_lib(), _blocks_lib()
        for d, k in ((2, 1), (784, 1), (784, 20), (300, 20), (22, 20), (20_000, 1), (33, 7),
                     (784, 64), (20_000, 20)):
            for plan in pegasos_layouts(d, k):
                if plan["layout"] == "walk":
                    have = slib.pegasos_single_dyn_bytes(d, int(plan["w_in_smem"]), plan["chunk"])
                elif plan["layout"] == "blocks":
                    have = blib.pegasos_blocks_dyn_bytes(d, plan["rows"])
                else:
                    have = lib.pegasos_dyn_bytes_c(d, k, plan["staged"])
                model = sum(plan["smem"].values())
                if have != model:
                    raise AssertionError(f"P2 D={d} k={k} ({layout_note(plan)}): requests "
                                         f"{have} B, byte model {model} B")
        print("  P2's dynamic shared memory equals its byte model in every layout at D = 2 ... "
              "20,000, k = 1, 7, 20 and 64")


def check_fit(label, Xp, yp, c, lookahead=None):
    """Algorithm 1 (``fit``: B4) or 2 (``fit_lookahead`` at L = ``lookahead``:
    B3) through the entry point on the card, against the same entry point on
    the host's CPU, where it runs the kernel's plain version on the inputs
    it builds the same way: m (the pushes) equal and w within the engine
    tolerance, or a first parting certified as an f32 tie
    (``partings.stream_parting``, from prefix runs of both). Returns the w
    max|err| (None after a tie)."""
    from repro_torch.core import fit, fit_lookahead
    from repro_torch.kernels.partings import stream_parting

    kernel = "B4" if lookahead is None else "B3"
    run = ((lambda X, y: fit(X, y, c)) if lookahead is None
           else (lambda X, y: fit_lookahead(X, y, c, lookahead)))
    Xc, yc = Xp.cpu(), yp.cpu()
    card = lambda nv: tuple(run(Xp[:nv], yp[:nv]))
    host = lambda nv: tuple(run(Xc[:nv], yc[:nv]))
    n = len(yc)
    (wk, _, _, mk), (wp, _, _, mp) = card(n), host(n)
    wk = wk.cpu()
    if int(mk) == int(mp) and torch.allclose(wk, wp, rtol=RTOL_W, atol=ATOL_W):
        err = float((wk - wp).abs().max())
        print(f"  {kernel} {label}: m {int(mk)} as the plain version's, w max|err| {err:.3e}")
        return err
    c_inv = float(1.0 / torch.tensor(c, dtype=torch.float32))
    part = stream_parting(card, host, yc[:, None] * Xc, c_inv, c_inv, lookahead,
                          rtol=RTOL_W, atol=ATOL_W)
    if part is None or not part["tie"]:
        raise AssertionError(f"{kernel} {label}: m {int(mk)}, plain {int(mp)}, w max|err| "
                             f"{float((wk - wp).abs().max()):.3e}; first parting {part}")
    print(f"  {kernel} {label}: m {int(mk)}, plain {int(mp)}; the first parting is a "
          f"certified f32 tie: {part}")
    return None


C6_LASVM_DATASETS = ("synthetic_b",)  # phase 11: LASVM held to the host CPU's pass (~14 s each)


def check_lasvm(label, X, y, C, got, acc):
    """C6: LASVM's pass on the card (``got`` = (w, b, n_sv)) against the same
    call on the host's CPU over the same rows and C: n_sv, w and b equal bit
    for bit, else the phase fails. LASVM sums every dot product in one fixed
    order (``baselines.lasvm.dots``), so each step is the same exactly
    rounded float64 operation on both devices and the passes cannot part
    (``tools/lasvm_passes.py`` shows where they part when the sums are each
    device's own). Returns both held-out accuracies."""
    from repro_torch.baselines import fit_lasvm

    wk, bk, nk = got
    t0 = time.perf_counter()
    wc, bc, nc = fit_lasvm(X.cpu(), y.cpu(), C=C, return_bias=True, device="cpu")
    t_cpu = time.perf_counter() - t0
    acc_k, acc_c = acc(wk, bk), acc(wc.to(X.device), bc)
    wk = wk.cpu()
    if not (nk == nc and torch.equal(wk, wc) and bk == bc):
        raise AssertionError(f"C6: LASVM {label}: the card's pass (n_sv {nk}, b {bk!r}) differs "
                             f"from the host CPU's (n_sv {nc}, b {bc!r}), w max|err| "
                             f"{float((wk - wc).abs().max()):.3e}")
    print(f"  LASVM {label} (C={C:g}): n_sv {nk}, w and b {bk!r} bit-equal to the host CPU's "
          f"pass; held out {acc_k:.2f} on the card, {acc_c:.2f} on the CPU ({t_cpu:.1f} s on "
          "the CPU)")
    return acc_k, acc_c


TABLE1_C_GRID = (1.0, 10.0, 100.0)  # benchmarks/table1.py's C grid
TABLE1_COLUMNS = ("batch", "perceptron", "pegasos1", "pegasos20", "lasvm", "algo1", "algo2")


def phase_baselines(dev, args):
    """Phase 11: the paper's baselines on the card, Table 1 and Fig 2 at the
    generators' full sizes, with the protocol of benchmarks/table1.py:39-127
    and fig2_cvm.py:17-38; then examples/torch_quickstart.py's main. The
    launch counts of P1, P2, B1, B3 and B4 are read around (a). Returns what
    phase 5 needs for P1's and P2's rows."""
    from repro_torch.baselines import (
        fit_batch_l2svm, fit_cvm, fit_lasvm, fit_pegasos, fit_perceptron)
    from repro_torch.core import fit, fit_c_grid, fit_lookahead
    from repro_torch.data import PAPER_TABLE1, load_dataset, permuted, preprocess_for
    from repro_torch.kernels import streamsvm_fit
    from repro_torch.kernels.baselines import pegasos_plan, pegasos_scan, perceptron_scan
    from repro_torch.kernels.streamsvm_scan import (
        streamsvm_scan, streamsvm_scan_lookahead_many, streamsvm_scan_many)

    t_phase = time.perf_counter()
    names = [n for n in PAPER_TABLE1 if args.table1_datasets in (None, "all")
             or n in args.table1_datasets.split(",")]
    counted = {"P1": perceptron_scan, "P2": pegasos_scan, "B1": streamsvm_scan_many,
               "B3": streamsvm_scan_lookahead_many, "B4": streamsvm_scan}
    for f in counted.values():
        f.launches = 0
    pegasos_scan.layout_launches = {}
    want_blocks = 0  # P2 at k = 20 where pegasos_plan takes the walk over blocks
    print(f"[11] the paper's baselines: (a) Table 1 on {len(names)} datasets at full size, "
          f"{args.table1_runs} stream orders, LASVM on up to {args.lasvm_cap} rows")

    def timed(secs, key, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        secs[key] += time.perf_counter() - t0
        return out

    rows, checked, lasvm_runs = [], {}, {}
    t_a = time.perf_counter()
    for name in names:
        Xtr0, ytr0, Xte, yte = load_dataset(name, seed=args.seed)
        Xtr0, Xte = preprocess_for(name, Xtr0, Xte)
        n, d = Xtr0.shape
        n_val = max(500, n // 10)
        X, y = torch.as_tensor(Xtr0, device=dev), torch.as_tensor(ytr0, device=dev)
        Xva, yva = X[-n_val:], y[-n_val:]
        Xt, yt = torch.as_tensor(Xte, device=dev), torch.as_tensor(yte, device=dev)

        def acc(w, b=0.0, Xe=Xt, ye=yt):
            return float(((Xe.to(w.dtype) @ w + b).sign() == ye.to(w.dtype)).double().mean()) * 100

        secs = {k: 0.0 for k in ("grid", "loop", *TABLE1_COLUMNS)}
        # C* over the grid by one fit_c_grid pass (B1); the per-model loop
        # (B4, one stream read a C) timed beside it; both warmed up first.
        grid = torch.tensor(TABLE1_C_GRID, device=dev)
        fit_c_grid(X, y, grid)
        bank = timed(secs, "grid", lambda: fit_c_grid(X, y, grid))
        for c in TABLE1_C_GRID:
            streamsvm_fit(X, y, c)
        timed(secs, "loop", lambda: [streamsvm_fit(X, y, c) for c in TABLE1_C_GRID])
        val = [acc(bank.w[i], Xe=Xva, ye=yva) for i in range(len(TABLE1_C_GRID))]
        c_star = TABLE1_C_GRID[int(np.argmax(val))]
        lam = 1.0 / (c_star * n)
        accs = {k: [] for k in TABLE1_COLUMNS}
        for r in range(args.table1_runs):
            Xp0, yp0 = permuted(Xtr0, ytr0, seed=args.seed * 1000 + r)
            Xp, yp = torch.as_tensor(Xp0, device=dev), torch.as_tensor(yp0, device=dev)
            if r < args.table1_checks:
                checked[name, r] = (Xp, yp, lam, c_star)
            accs["perceptron"].append(acc(timed(secs, "perceptron",
                                                lambda: fit_perceptron(Xp, yp))[0]))
            accs["pegasos1"].append(acc(timed(secs, "pegasos1",
                                              lambda: fit_pegasos(Xp, yp, lam, k=1))))
            accs["pegasos20"].append(acc(timed(secs, "pegasos20",
                                               lambda: fit_pegasos(Xp, yp, lam, k=20))))
            want_blocks += pegasos_plan(d, 20)["layout"] == "blocks"
            if r == 0:  # LASVM once per dataset, its own C from {1, 10} on a prefix
                best_l, c_l = -1.0, 1.0
                cap = min(2000, args.lasvm_cap)
                for c_try in (1.0, 10.0):
                    w_try, b_try, _ = timed(secs, "lasvm", lambda: fit_lasvm(
                        Xp[:cap], yp[:cap], C=c_try, return_bias=True))
                    a_try = acc(w_try, b_try, Xe=Xva, ye=yva)
                    if a_try > best_l:
                        best_l, c_l = a_try, c_try
                wl, bl, nsv = timed(secs, "lasvm", lambda: fit_lasvm(
                    Xp[: args.lasvm_cap], yp[: args.lasvm_cap], C=c_l, return_bias=True))
                accs["lasvm"].append(acc(wl, bl))
                if name in C6_LASVM_DATASETS:
                    lasvm_runs[name] = (Xp[: args.lasvm_cap], yp[: args.lasvm_cap], c_l,
                                        (wl, bl, nsv), acc)
            accs["algo1"].append(acc(timed(secs, "algo1", lambda: fit(Xp, yp, c_star)).w))
            accs["algo2"].append(acc(timed(secs, "algo2",
                                           lambda: fit_lookahead(Xp, yp, c_star, 10)).w))
        wb, obj = timed(secs, "batch", lambda: fit_batch_l2svm(X, y, c_star, iters=2000))
        accs["batch"].append(acc(wb))
        if not torch.isfinite(obj) or not torch.isfinite(wb).all():
            raise AssertionError(f"phase 11 {name}: the batch solver is not finite")
        row = {k: float(np.mean(v)) for k, v in accs.items()}
        for k, v in row.items():
            if not 0.0 < v <= 100.0:
                raise AssertionError(f"phase 11 {name}: {k} accuracy {v}")
        rows.append(dict(dataset=name, n=n, d=d, C=c_star, lasvm_C=c_l, nsv=nsv, secs=secs,
                         **row))
        paper = PAPER_TABLE1[name]
        print(f"  {name} (N={n}, D={d}, C*={c_star:g}, LASVM C={c_l:g}, {nsv} SVs): "
              + ", ".join(f"{k} {row[k]:.2f} (paper {p})" for k, p in zip(TABLE1_COLUMNS, paper)))
        print(f"    C-grid: one pass {secs['grid']:.4f} s, per-model loop {secs['loop']:.4f} s "
              f"({secs['loop'] / max(secs['grid'], 1e-9):.2f}x); seconds: "
              + ", ".join(f"{k} {secs[k]:.3f}" for k in TABLE1_COLUMNS)
              + f" (LASVM's 3 fits, the others over {args.table1_runs} orders)")
    t_a = time.perf_counter() - t_a
    launches = {k: f.launches for k, f in counted.items()}
    launches["P2 blocks"] = pegasos_scan.layout_launches.get("blocks", 0)
    print(f"  launches in phase 11a: {launches} (P2 by layout: {pegasos_scan.layout_launches}); "
          f"(a) {t_a:.1f} s")
    if dev.type == "cuda":
        missing = [k for k, v in launches.items() if v == 0 and (k != "P2 blocks" or want_blocks)]
        if missing:
            raise AssertionError(f"phase 11a: kernels of its path were never launched: {missing}")
        want_p2 = 2 * args.table1_runs * len(names)
        if (launches["P1"] != args.table1_runs * len(names) or launches["P2"] != want_p2
                or launches["P2 blocks"] != want_blocks):
            raise AssertionError(f"phase 11a: P1 / P2 / P2's walk over blocks launched "
                                 f"{launches['P1']} / {launches['P2']} / "
                                 f"{launches['P2 blocks']} times (want {want_blocks} over blocks)")
    t_c = time.perf_counter()
    for (name, r), (Xp, yp, lam, c_star) in checked.items():  # after the launches were read
        # the plain versions on the host's CPU: the same function, in a tenth
        # of the card's time for a loop of small launches (phase 2 runs them
        # on the card)
        label = f"{name}, Table 1's order {r}"
        check_p1(label, Xp, yp, plain_dev="cpu")
        for k in (1, 20):
            check_p2(f"{label}, k={k}", Xp, yp, lam, k, plain_dev="cpu")
        check_fit(f"{label} (Algorithm 1, C={c_star:g})", Xp, yp, c_star)
        check_fit(f"{label} (Algorithm 2, C={c_star:g}, L=10)", Xp, yp, c_star, 10)
    t_c = time.perf_counter() - t_c
    print(f"  the first {args.table1_checks} order(s)' P1, P2, B4 and B3 fits against their "
          f"plain versions (on the CPU): {t_c:.1f} s")
    t_l = time.perf_counter()
    lasvm_held = {name: check_lasvm(name, *run) for name, run in lasvm_runs.items()}
    t_l = time.perf_counter() - t_l
    print(f"  C6: LASVM's final pass on the card held to the host CPU's on "
          f"{len(lasvm_held)} dataset(s) ({', '.join(lasvm_held)}): {t_l:.1f} s")

    # (b) Fig 2: CVM's passes against one pass of Algorithms 1 and 2.
    t_b = time.perf_counter()
    Xtr, ytr, Xte, yte = load_dataset("mnist89", seed=args.seed)
    Xtr, Xte = preprocess_for("mnist89", Xtr, Xte)
    nf = min(len(ytr), args.cvm_n_train)
    X, y = torch.as_tensor(Xtr[:nf], device=dev), torch.as_tensor(ytr[:nf], device=dev)
    Xt, yt = torch.as_tensor(Xte, device=dev), torch.as_tensor(yte, device=dev)
    acc = lambda w: float(((Xt.to(w.dtype) @ w).sign() == yt.to(w.dtype)).double().mean()) * 100
    a1, a2 = acc(fit(X, y, 10.0).w), acc(fit_lookahead(X, y, 10.0, 10).w)
    sync(dev)
    t0 = time.perf_counter()
    res = fit_cvm(X, y, C=10.0, eps=1e-4, max_passes=args.cvm_passes, solver_iters=1000)
    sync(dev)
    t_cvm = time.perf_counter() - t0
    curve = [acc(w) for w in res["w_per_pass"]]
    match = next((i + 1 for i, a in enumerate(curve) if a >= a2), None)
    t_b = time.perf_counter() - t_b
    print(f"[11] (b) Fig 2: CVM on mnist89 (N={nf}, D={X.shape[1]}), C=10, eps 1e-4, "
          f"{res['passes']} passes (at most {args.cvm_passes}), solver_iters 1000, "
          f"{len(res['core_idx'])} core vectors, r {res['r']:.6f}; {t_cvm:.2f} s, "
          f"{t_cvm / res['passes']:.3f} s a pass")
    print("  accuracy after each pass: " + ", ".join(f"{a:.2f}" for a in curve))
    print(f"  one pass of Algorithm 1: {a1:.2f}, of Algorithm 2 (L=10): {a2:.2f}; passes for "
          f"CVM to match Algorithm 2: {match}")

    # (c) the quickstart twin at its default size.
    t_q = time.perf_counter()
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart

    q = torch_quickstart.main(["--device", dev.type]
                              + (["--n-train", "2000", "--classes", "8", "--bank-n", "300",
                                  "--bank-d", "16"] if dev.type == "cpu" else []))
    t_q = time.perf_counter() - t_q
    total = time.perf_counter() - t_phase
    print(f"[11] wall seconds: (a) Table 1 {t_a:.1f}, its plain checks {t_c:.1f}, LASVM's "
          f"(C6) {t_l:.1f}, (b) Fig 2 "
          f"{t_b:.1f}, (c) the quickstart twin {t_q:.1f} (accuracies {q['acc']}); phase 11 "
          f"{total:.1f} s" + ("" if total < 60 else " (over a minute)"))
    mn = checked.get(("mnist89", 0))
    return dict(launches=launches, rows=rows, fig2=dict(curve=curve, match=match, a1=a1, a2=a2),
                mnist89=mn, seconds=total, lasvm=lasvm_held)


BF16_PEAK = 989e12  # H100 SXM dense bf16 FLOP/s (data sheet)
ZOO_DENSE = "internlm2-1.8b"  # phase 12a / 12c: the dense decoder at its published widths
ZOO_RECURRENT = "xlstm-125m"  # phase 12b: the continuous batcher's family
ZOO_TF_TOL = 0.05  # 12a: decode logits against the teacher-forced forward, x max|logit| (bf16)
ZOO_F32_TOL = 1e-4  # 12a: the card against the host's CPU on the f32 copy, x max|logit|


def zoo_tree(tree, fn):
    """``fn`` applied to every tensor of a parameter or state tree."""
    if isinstance(tree, dict):
        return {k: zoo_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zoo_tree(v, fn) for v in tree)
    return fn(tree)


def zoo_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from zoo_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from zoo_leaves(v)
    else:
        yield tree


def rel_gap(logits):
    """Each row's top-two logit gap over its max |logit| (f32)."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) / logits.float().abs().amax(-1)


MEMORY_RTOL = 0.05  # 12a, 12d, 13a, 13d: the dry run's counted peak against the allocator's


def meta_like(tree):
    """``tree`` with every tensor an empty meta tensor of its shape and dtype."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(*(meta_like(v) for v in tree)) if hasattr(tree, "_fields") else \
            type(tree)(meta_like(v) for v in tree)
    return torch.empty_like(tree, device="meta") if isinstance(tree, torch.Tensor) else tree


def memory_check(label, dev, count, step):
    """The dry run's memory analysis against the card's allocator for one
    step: ``count()`` runs the dry run's live-bytes count
    (``launch.dryrun.step_memory`` / ``train_memory``) on meta tensors of
    the step's shapes, one rank, no DTensor; ``step()`` runs the step on the
    card once, untimed, between reset_peak_memory_stats and
    max_memory_allocated, less what was allocated before it. The count's
    peak above the arguments must lie within MEMORY_RTOL of the
    allocator's; the allocator's requested bytes (its sizes before its
    512-byte rounding and block reuse) are printed beside it. Returns (the
    numbers, the step's outputs)."""
    t0 = time.perf_counter()
    got = count()
    t_count = time.perf_counter() - t0
    rec = dict(predicted=got["peak_bytes"], temp=got["temp_size_in_bytes"],
               output=got["output_size_in_bytes"], count_s=t_count)
    said = (f"the dry run's count on meta, one rank, {got['peak_bytes']:,} B above the arguments "
            f"(temp {got['temp_size_in_bytes']:,}, output {got['output_size_in_bytes']:,}; "
            f"{t_count:.2f} s)")
    if dev.type != "cuda":
        print(f"  {label} memory: {said}; no card to hold it to")
        return rec, step()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    sync(dev)
    before = torch.cuda.memory_allocated(dev)
    req_before = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = step()
    sync(dev)
    t_step = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated(dev) - before
    requested = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"] - req_before
    gap = got["peak_bytes"] / measured - 1.0
    rec.update(measured=measured, requested=requested, gap=gap, step_s=t_step)
    print(f"  {label} memory ({smi}): {said} against the card's max_memory_allocated "
          f"{measured:,} B above what was allocated before the step (requested {requested:,} B): "
          f"{gap:+.3%} (bound {MEMORY_RTOL:.0%}; the step {t_step:.2f} s, untimed)")
    if abs(gap) > MEMORY_RTOL:
        raise AssertionError(f"{label}: the dry run's count {got['peak_bytes']:,} B lies "
                             f"{gap:+.3%} from the allocator's {measured:,} B (bound {MEMORY_RTOL})")
    return rec, out


def prefill_memory(label, dev, model, params, batch):
    """``memory_check`` of one prefill of ``batch`` (with its max_len)."""
    from repro_torch.launch.dryrun import step_memory

    meta_params, meta_batch = model.init(device="meta"), meta_like(batch)
    count = lambda: step_memory(lambda: model.prefill(meta_params, meta_batch),
                                (meta_params, meta_batch))
    rec, out = memory_check(label, dev, count, lambda: model.prefill(params, batch))
    del out
    return rec


def train_memory_count(model, tcfg, batch):
    """``count()`` of ``memory_check`` for ``make_train_step(model, tcfg)``
    at one microbatch of ``batch``'s shapes, on meta."""
    from repro_torch.launch.dryrun import train_memory
    from repro_torch.optim import adamw

    params = model.init(device="meta")
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[tcfg.moment_dtype]
    state = {"params": params, "opt": adamw.init(params, mdt)}
    mb = meta_like(batch)
    return lambda: train_memory(model, tcfg, state, mb)


def zoo_dense(dev, args):
    """Phase 12a: examples/torch_serve.py's path at the dense config's
    published widths. Returns the model and its params for 12c."""
    import dataclasses

    import torch_serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ZOO_DENSE, smoke=args.zoo_smoke)
    model = build_model(cfg)
    sync(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0  # earlier phases'
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in zoo_leaves(params))
    B, P, G = args.zoo_batch, args.zoo_prompt, args.zoo_gen
    T = P + G
    esz = params["embed"].element_size()
    kv_bytes = 2 * cfg.n_layers * B * T * cfg.n_kv_heads * cfg.hd * esz  # k and v
    w_bytes = n_params * esz
    print(f"[12a] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads x {cfg.hd}, {cfg.mlp} d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}: {n_params:,} parameters ({w_bytes / 1e9:.3f} GB) drawn on {dev} "
          f"from --seed in {t_init:.2f} s; batch {B}, prompt {P}, {G} generated, max_len {T}, "
          f"KV cache {kv_bytes / 1e6:.1f} MB")
    batch = torch_serve.make_batch(cfg, B, P, args.seed, dev)
    torch_serve.serve(model, params, batch, 3)  # warm-up: the same shapes' first launches
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = torch_serve.serve(model, params, batch, G, keep_logits=True)
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    toks = res["tokens"]
    if not all(torch.isfinite(l).all() for l in res["logits"]):
        raise AssertionError("12a: non-finite logits")

    # Bounds (the card's least time for this run's work): prefill by its
    # operations at the bf16 peak (the layers' products for every prompt
    # token, causal attention's pairs, the last position's unembedding),
    # decode by its bytes (every weight but the embedding table, whose B rows
    # are gathered, and the cache's valid positions read once a step).
    emb = params["embed"].numel()
    unemb = cfg.d_model * cfg.vocab
    layer_params = n_params - emb - (0 if cfg.tie_embeddings else unemb)
    attn_pairs = B * cfg.n_layers * P * (P + 1) // 2
    pf_flops = (2.0 * layer_params * B * P + 4.0 * attn_pairs * cfg.n_heads * cfg.hd
                + 2.0 * unemb * B)
    pf_bound = pf_flops / BF16_PEAK * 1e3
    per_pos = kv_bytes / T  # cache bytes of one position, all layers, both k and v
    dec_bytes = [(n_params - emb) * esz + B * cfg.d_model * esz + (P + j + 1) * per_pos
                 for j in range(G - 1)]
    dec_bound = float(np.mean(dec_bytes)) / HBM_BYTES_PER_S * 1e3
    dec_flops_bound = 2.0 * (n_params - emb) * B / BF16_PEAK * 1e3
    pf_ms = res["prefill_s"] * 1e3
    dec_ms = res["decode_s"] * 1e3 / (G - 1)
    print(f"  prefill {pf_ms:.3f} ms ({B * P / res['prefill_s']:.1f} tokens/s); bound "
          f"{pf_bound:.4f} ms (operations: {pf_flops / 1e12:.3f} TFLOP at 989 TFLOP/s bf16)")
    print(f"  decode {dec_ms:.3f} ms a step of {B} tokens ({(G - 1) * B / res['decode_s']:.1f} "
          f"tokens/s) over {G - 1} steps; bound {dec_bound:.4f} ms (bytes: "
          f"{np.mean(dec_bytes) / 1e9:.3f} GB a step at 3.35 TB/s; operations "
          f"{dec_flops_bound:.4f} ms)")
    if peak is not None:
        print(f"  torch.cuda.max_memory_allocated over the timed run {peak / 1e9:.3f} GB (less "
              f"{held / 1e9:.3f} GB that earlier phases hold); bound "
              f"{(w_bytes + kv_bytes) / 1e9:.3f} GB (the weights and the KV cache)")

    # Each step's logits against the teacher-forced forward of the same prefix:
    # one causal pass (no cache) over the prompt and the tokens fed back.
    with torch.inference_mode():
        seq = torch.cat([batch["tokens"], toks[:, :-1]], dim=1)
        h, _ = model._stack(params, model._embed(params, {**batch, "tokens": seq}))
        tf = model._unembed(params, h[:, P - 1 :])  # (B, G, V)
    worst, compared, parted = teacher_forced_check("12a", res["logits"], tf)
    print(f"  every step's logits within {worst:.4g} x max|logit| of the teacher-forced "
          f"forward (bound {ZOO_TF_TOL}); greedy tokens equal at all {compared} of {B * G} "
          f"(row, step) pairs whose margins part by > {2 * ZOO_TF_TOL}; {parted} ties went "
          "either way")
    mem = prefill_memory("12a", dev, model, params, {**batch, "max_len": T})

    # The card against the host's CPU: an f32 copy at full width and 2 layers,
    # on the first 2 layers of the weights just drawn.
    if dev.type == "cuda":
        assert not torch.backends.cuda.matmul.allow_tf32
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", act_dtype="float32")
    small = {k: v for k, v in params.items() if k != "layers"}
    small["layers"] = zoo_tree(params["layers"], lambda t: t[:2])
    small = zoo_tree(small, lambda t: t.float())
    P2, G2 = min(64, P), 4
    toks2 = torch.cat([batch["tokens"], toks], dim=1)[:2, : P2 + G2]
    err = card_against_host(build_model(cfg2), small, dev, [{"tokens": toks2}], G2)
    if err > ZOO_F32_TOL:
        raise AssertionError(f"12a: the card's f32 2-layer run lies {err:.3e} x max|logit| "
                             f"from the host CPU's (bound {ZOO_F32_TOL})")
    print(f"  f32 copy, full width, 2 layers, batch 2, prompt {P2}, {G2 - 1} decode steps: the "
          f"card within {err:.3e} x max|logit| of the host's CPU (bound {ZOO_F32_TOL}; TF32 off)")
    del small, tf, h, res
    return model, params, dict(prefill_ms=pf_ms, prefill_bound_ms=pf_bound, decode_ms=dec_ms,
                               decode_bound_ms=dec_bound, peak_bytes=peak,
                               mem_bound_bytes=w_bytes + kv_bytes, tf_err=worst, cpu_err=err,
                               memory=mem)


def zoo_solo(model, params, prompt, n_new, dev, feed=None):
    """tests/test_serving.py:14-24's single-request greedy decode, on the
    port: its tokens and each step's logits (f32, on the host's memory).
    With ``feed``, the steps are fed those tokens instead (a replay)."""
    logits, st = model.prefill(params, {"tokens": torch.as_tensor(prompt[None, :], device=dev),
                                        "max_len": 128})
    toks, steps = [int(torch.argmax(logits[0]))], [logits[0].float().cpu()]
    for i in range(n_new - 1):
        nxt = toks[-1] if feed is None else feed[i]
        logits, st = model.decode_step(params, st, torch.tensor([[nxt]], dtype=torch.int32,
                                                                device=dev))
        toks.append(int(torch.argmax(logits[0])))
        steps.append(logits[0].float().cpu())
    return toks, steps


def zoo_tie(model, params, req, want, steps, t, dev):
    """Certify the first parting of a batched request from its solo decode
    as a bf16 tie: at step ``t`` the solo run took token a, the batched run
    token b. Replay the solo prefix in f32 on the same weights (cast): the
    solo's bf16 rounding error at that step is E = max |bf16 - f32| over
    the vocabulary. A tie when the solo's bf16 logits of a and b lie within
    2 E (each run's rounding may move either by E). Returns the numbers."""
    import dataclasses

    from repro_torch.models import build_model

    model32 = build_model(dataclasses.replace(model.cfg, param_dtype="float32",
                                              act_dtype="float32"))
    params32 = zoo_tree(params, lambda x: x.float())
    _, steps32 = zoo_solo(model32, params32, req.prompt, t + 1, dev, feed=want[:t])
    lo16, lo32 = steps[t], steps32[t]
    a, b = want[t], req.generated[t]
    scale = lo16.abs().max().item()
    E = (lo16 - lo32).abs().max().item()
    gap = (lo16[a] - lo16[b]).item()
    return dict(rid=req.rid, step=t, gap=gap / scale, bf16_err=E / scale,
                f32_gap=(lo32[a] - lo32[b]).item() / scale, tie=gap <= 2 * E)


def zoo_requests(model, params, specs, slots, dev):
    """``specs`` (prompt, max_new) through a ContinuousBatcher of ``slots``
    slots (timed), and each alone through ``zoo_solo`` (timed)."""
    from repro_torch.serve import ContinuousBatcher, Request

    zoo_solo(model, params, specs[0][0][:8], 2, dev)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    solo = [zoo_solo(model, params, prompt, n, dev) for prompt, n in specs]
    sync(dev)
    t_solo = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=prompt, max_new=n) for i, (prompt, n) in enumerate(specs)]
    batcher = ContinuousBatcher(model, params, n_slots=slots)
    slot_of, admit = {}, batcher.admit

    def admit_and_record(req):  # the slot each request is admitted to
        free = batcher.free_slots()
        if admit(req):
            slot_of[req.rid] = free[0]
            return True
        return False

    batcher.admit = admit_and_record
    sync(dev)
    t0 = time.perf_counter()
    stats = batcher.run(reqs)
    sync(dev)
    t_run = time.perf_counter() - t0
    if stats.finished != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"12b: {stats.finished} of {len(reqs)} requests finished")
    for r in reqs:
        if len(r.generated) != r.max_new:
            raise AssertionError(f"12b: request {r.rid} got {len(r.generated)} tokens")
    return reqs, solo, stats, t_run, t_solo, slot_of


def zoo_solo_in_slot(model, params, prompt, n_new, slots, slot, dev):
    """One request's greedy decode in the batcher's step shape: admitted by
    a batch-1 prefill scattered into ``slot`` of a fresh ``slots``-slot
    state, then decode steps of ``slots`` rows (the others idle). A decode
    row depends only on its own inputs, so this gives the batched run's
    bits for the request; it is the same arithmetic without the other
    requests' admissions, steps and releases."""
    from repro_torch.serve.token_scheduler import _scatter_slot

    logits, one = model.prefill(params, {"tokens": torch.as_tensor(prompt[None, :], device=dev),
                                         "max_len": 4096})
    state = model.decode_state(slots, 1, device=dev)
    with torch.inference_mode():
        state = {**_scatter_slot({k: v for k, v in state.items() if k != "pos"},
                                 {k: v for k, v in one.items() if k != "pos"}, slot), "pos": 0}
    toks = [int(torch.argmax(logits[0]))]
    feed = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    for _ in range(n_new - 1):
        feed[slot, 0] = toks[-1]
        logits, state = model.decode_step(params, state, feed)
        toks.append(int(torch.argmax(logits[slot])))
    return toks


def first_parting(got, want):
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)


def zoo_batcher(dev, args):
    """Phase 12b: ContinuousBatcher over the recurrent config's published
    widths (bf16). Each request against its solo greedy decode (batch 1), a
    first parting certified as a bf16 tie by an f32 replay (``zoo_tie``);
    and bit for bit against its decode alone in its slot of the batcher's
    step shape (``zoo_solo_in_slot``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ZOO_RECURRENT, smoke=args.zoo_smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed + 1), device=dev)
    n_params = sum(t.numel() for t in zoo_leaves(params))
    rng = np.random.default_rng(args.seed + 12)
    lo, hi = args.zoo_req_prompt
    specs = [(rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1))).astype(np.int32),
              int(rng.integers(4, 49))) for _ in range(args.zoo_requests)]
    S = args.zoo_slots
    print(f"[12b] {cfg.name}: {cfg.n_layers} blocks (1 sLSTM in {cfg.slstm_every}), d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}, {n_params:,} parameters; "
          f"{len(specs)} requests, prompts {lo}-{hi} tokens, max_new 4-48, {S} slots")
    reqs, solo, stats, t_run, t_solo, slot_of = zoo_requests(model, params, specs, S, dev)
    ties, equal_steps = [], 0
    for r, (want, steps) in zip(reqs, solo):
        t = first_parting(r.generated, want)
        equal_steps += len(want) if t is None else t
        if t is None:
            continue
        tie = zoo_tie(model, params, r, want, steps, t, dev)
        if not tie["tie"]:
            raise AssertionError(f"12b: request {r.rid} parts from its solo decode at step {t}, "
                                 f"not a bf16 tie: {tie}")
        ties.append(tie)
    lengths = [n for _, n in specs]
    static_util = sum(lengths) / (S * sum(max(lengths[i : i + S]) for i in range(0, len(lengths), S)))
    print(f"  bf16: every request's tokens equal its solo greedy decode"
          + (f", or up to a first parting certified as a bf16 tie ({len(ties)} requests; "
             f"{equal_steps} of {sum(lengths)} tokens compared before the partings): "
             + "; ".join(f"request {x['rid']} step {x['step']}: gap {x['gap']:.4g}, the "
                         f"solo's bf16 error {x['bf16_err']:.4g}, f32 gap {x['f32_gap']:.4g}"
                         for x in ties) + " (x max|logit|)" if ties else "")
          + f"; steps {stats.steps}, utilisation {stats.utilization:.4f} (static batching of the "
          f"same lengths in arrival order: {static_util:.4f})")
    print(f"  batcher {t_run:.3f} s: {stats.steps / t_run:.1f} steps/s, "
          f"{stats.admitted / t_run:.2f} admitted/s, "
          f"{sum(lengths) / t_run:.1f} generated tokens/s; the {len(specs)} solo decodes one "
          f"after another {t_solo:.3f} s")

    # The batcher's bookkeeping, bit for bit: each request alone in its slot.
    t0 = time.perf_counter()
    for r, (prompt, n) in zip(reqs, specs):
        alone = zoo_solo_in_slot(model, params, prompt, n, S, slot_of[r.rid], dev)
        if alone != r.generated:
            raise AssertionError(f"12b: request {r.rid} in slot {slot_of[r.rid]} differs from "
                                 f"its decode alone in that slot at step "
                                 f"{first_parting(r.generated, alone)}")
    t_alone = time.perf_counter() - t0
    print(f"  every request's {sum(lengths)} tokens equal, bit for bit, its decode alone in "
          f"its slot of a step of {S} rows ({t_alone:.1f} s): the batcher's admissions, slots and "
          "releases change no bit")
    return dict(utilization=stats.utilization, static_utilization=static_util,
                steps_per_s=stats.steps / t_run, admitted_per_s=stats.admitted / t_run,
                ties=ties, equal_steps=equal_steps, seconds=t_run)


def zoo_features(dev, args, model, params, label="12c", lookaheads=(1,), trained=None):
    """examples/llm_feature_svm.py's features from a backbone (12c: 12a's
    random-init one; 13c: 13a's trained one, ``trained`` its steps),
    streamed once through fit_chunked per lookahead: 1 runs B4, held against
    the host's CPU (m equal, w within the engine tolerance, or a parting
    certified as an f32 tie); 10 runs the qp engine (plain torch) on the
    card, held to the host's CPU within the engine tolerance, m equal.
    Returns B4's launches and each lookahead's accuracy and m."""
    from repro_torch.core import accuracy, fit_chunked
    from repro_torch.core.meb import Ball
    from repro_torch.data import styled_corpus
    from repro_torch.kernels.partings import stream_parting
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan

    cfg = model.cfg
    n_tr, n_te, chunk, C = args.zoo_docs - args.zoo_docs // 5, args.zoo_docs // 5, 128, 10.0
    t0 = time.perf_counter()
    toks, labels = styled_corpus(cfg.vocab, n_tr + n_te, 65, seed=args.seed)
    toks = toks[:, :-1]
    t_data = time.perf_counter() - t0

    def embed_docs(tokens, center):
        """Mean-pooled token embeddings beside mean-pooled final hidden
        states, each L2-normalised, centred and L2-normalised again."""
        with torch.inference_mode():
            t = torch.as_tensor(tokens, device=dev)
            e = model._embed(params, {"tokens": t})
            h, _ = model._stack(params, e)

            def pool(x):
                f = x.float().mean(1)
                return f / torch.clamp(f.norm(dim=-1, keepdim=True), min=1e-8)

            feats = torch.cat([pool(e), pool(h)], dim=-1) - center
            return feats / torch.clamp(feats.norm(dim=-1, keepdim=True), min=1e-8)

    zero = torch.zeros(2 * cfg.d_model, device=dev)
    center = embed_docs(toks[:chunk], zero).mean(0)
    sync(dev)
    t0 = time.perf_counter()
    F = torch.cat([embed_docs(toks[lo : lo + chunk], center) for lo in range(0, n_tr, chunk)])
    F_te = embed_docs(toks[n_tr:], center)
    sync(dev)
    t_embed = time.perf_counter() - t0
    y = torch.as_tensor(labels[:n_tr], device=dev)
    y_te = torch.as_tensor(labels[n_tr:], device=dev)
    Fc, yc = F.cpu(), y.cpu()
    d = F.shape[1]
    backbone = f"{trained}-step trained" if trained else "random-init"
    print(f"[{label}] {n_tr} + {n_te} styled_corpus documents of 64 tokens (vocab {cfg.vocab}, "
          f"{t_data:.2f} s to draw), embedded by the {backbone} {cfg.name} backbone into "
          f"{d}-wide features ({t_embed:.3f} s), streamed in {chunk}-row chunks")
    out = dict(launches=0, acc={}, m={}, fit_s={})
    for la in lookaheads:
        def run(Fx, yx, nv):
            return tuple(fit_chunked(((Fx[lo : min(lo + chunk, nv)], yx[lo : min(lo + chunk, nv)])
                                      for lo in range(0, nv, chunk)), c=C, lookahead=la).ball)

        streamsvm_scan.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        ball = run(F, y, n_tr)
        sync(dev)
        t_fit = time.perf_counter() - t0
        if la == 1:
            out["launches"] = streamsvm_scan.launches
        want = run(Fc, yc, n_tr)
        wk, mk = ball[0].cpu(), int(ball[3])
        if mk == int(want[3]) and torch.allclose(wk, want[0], rtol=RTOL_W, atol=ATOL_W):
            held = f"m {mk} as the host CPU's, w max|err| {(wk - want[0]).abs().max().item():.3e}"
        elif la == 1:
            c_inv = float(1.0 / torch.tensor(C, dtype=torch.float32))
            part = stream_parting(lambda nv: run(F, y, nv), lambda nv: run(Fc, yc, nv),
                                  yc[:, None] * Fc, c_inv, c_inv, None, rtol=RTOL_W, atol=ATOL_W)
            if part is None or not part["tie"]:
                raise AssertionError(f"{label}: m {mk}, the host CPU's {int(want[3])}; first "
                                     f"parting {part}")
            held = (f"m {mk}, the host CPU's {int(want[3])}: the first parting a certified f32 "
                    f"tie {part}")
        else:
            raise AssertionError(f"{label}: the qp engine (lookahead {la}) on the card: m {mk}, "
                                 f"w max|err| {(wk - want[0]).abs().max().item():.3e} from the "
                                 f"host CPU's (m {int(want[3])}; bound rtol {RTOL_W}, atol "
                                 f"{ATOL_W})")
        acc = float(accuracy(Ball(*ball), F_te, y_te)) * 100
        out["acc"][la], out["m"][la], out["fit_s"][la] = acc, mk, t_fit
        engine = (f"B4 launched {out['launches']} times" if la == 1
                  else "the qp engine (plain torch, qp_iters 128)")
        print(f"  fit_chunked(c={C:g}, lookahead={la}): {engine}, the pass {t_fit:.4f} s; {held}; "
              f"held-out accuracy {acc:.2f} %")
        if dev.type == "cuda" and la == 1 and out["launches"] < 1:
            raise AssertionError(f"{label}: fit_chunked never launched B4")
    return out


ZOO_MOE = "qwen3-moe-30b-a3b"  # phase 12d: the MoE decoder at its published widths
ZOO_MOE_F32_TOL = 1e-4  # 12d: the card against the host's CPU on the f32 2-layer copy
# (logits x max|logit|; each layer's aux relative); greedy tokens compared where the
# top-two logits part by more than twice it


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in zoo_leaves(tree))


def moe_routed(stats, n_layers):
    """Per call of a forward (prefill, then each decode step): the dropped
    assignments and the distinct experts that received a kept assignment,
    summed over the layers, from ``DecoderLM.moe_stats``."""
    calls = [stats[i : i + n_layers] for i in range(0, len(stats), n_layers)]
    return [dict(dropped=sum(int(s["dropped"]) for s in c),
                 experts=[int(s["experts"][s["kept"]].unique().numel()) for s in c])
            for c in calls]


def zoo_moe(dev, args):
    """Phase 12d: examples/torch_serve.py's path with the MoE decoder at its
    published widths and depth. Decode cannot be held to the teacher-forced
    forward: capacity depends on the call's token count (C = 1 at a decode
    step of 8 tokens, 320 at the 4,096-token prefill), so decode drops
    assignments that the forward keeps, the reference's semantics. The card
    is held instead to the host's CPU on an f32 copy of the first 2 layers
    at full width: prefill and decode logits and each layer's aux within
    ZOO_MOE_F32_TOL, every layer's dropped assignments equal, and the greedy
    tokens equal wherever the top-two logits part by twice the bound."""
    import dataclasses

    import torch_serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity

    cfg = get_config(ZOO_MOE, smoke=args.zoo_smoke)
    mc = cfg.moe
    model = build_model(cfg)
    sync(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in zoo_leaves(params))
    w_bytes = tree_bytes(params)
    B, P, G = args.moe_batch, args.moe_prompt, args.moe_gen
    T = P + G
    esz = params["embed"].element_size()
    kv_bytes = 2 * cfg.n_layers * B * T * cfg.n_kv_heads * cfg.hd * esz
    c_pf, c_dec = capacity(mc, B * P), capacity(mc, B)
    print(f"[12d] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads x {cfg.hd}, {mc.n_experts} experts top-{mc.top_k} d_ff "
          f"{mc.d_ff} (capacity factor {mc.capacity_factor}), vocab {cfg.vocab}, "
          f"{cfg.param_dtype}: {n_params:,} parameters ({w_bytes / 1e9:.3f} GB, the router f32) "
          f"drawn on {dev} from --seed in {t_init:.2f} s, layer by layer into the stacked leaves; "
          f"batch {B}, prompt {P}, {G} generated, KV cache {kv_bytes / 1e6:.1f} MB; capacity "
          f"{c_pf} slots an expert at the prefill's {B * P} tokens, {c_dec} at a decode step's {B}")
    batch = torch_serve.make_batch(cfg, B, P, args.seed, dev)
    torch_serve.serve(model, params, batch, 3)  # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = torch_serve.serve(model, params, batch, G, keep_logits=True)
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    if not all(torch.isfinite(l).all() for l in res["logits"]):
        raise AssertionError("12d: non-finite logits")
    toks = res["tokens"]
    if toks.shape != (B, G) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"12d: generated tokens of shape {tuple(toks.shape)} or out of range")

    # Routing of the same run, replayed with the layers' stats on (the stats
    # read each layer's experts, so the timed run above keeps them off).
    model.moe_stats = []
    torch_serve.serve(model, params, batch, G)
    routed = moe_routed(model.moe_stats, cfg.n_layers)
    model.moe_stats = None
    mem = prefill_memory("12d", dev, model, params, {**batch, "max_len": T})

    # Bounds. Prefill, by its operations at the bf16 peak: the layers' dense
    # products (attention projections, the router) for every token, the E x C
    # expert slots' three products, causal attention's pairs, the last
    # position's unembedding. Decode, by its bytes: the reference's form runs
    # the expert products over all E experts, so every weight but the
    # embedding table is read a step, with the cache's valid positions.
    L, D, E, Fd = cfg.n_layers, cfg.d_model, mc.n_experts, mc.d_ff
    expert_bytes = L * E * 3 * D * Fd * esz
    emb_bytes = params["embed"].numel() * esz
    unemb = D * cfg.vocab
    dense_layer = (n_params - params["embed"].numel() - (0 if cfg.tie_embeddings else unemb)
                   - L * E * 3 * D * Fd)
    attn_pairs = B * L * P * (P + 1) // 2
    expert_flops = 6.0 * L * E * c_pf * D * Fd
    pf_flops = (2.0 * dense_layer * B * P + expert_flops + 4.0 * attn_pairs * cfg.n_heads * cfg.hd
                + 2.0 * unemb * B)
    pf_bound = pf_flops / BF16_PEAK * 1e3
    per_pos = kv_bytes / T
    dec_bytes = [w_bytes - emb_bytes + B * D * esz + (P + j + 1) * per_pos for j in range(G - 1)]
    dec_bound = float(np.mean(dec_bytes)) / HBM_BYTES_PER_S * 1e3
    gathered = [w_bytes - emb_bytes - expert_bytes + sum(r["experts"]) * 3 * D * Fd * esz
                + B * D * esz + (P + j + 1) * per_pos for j, r in enumerate(routed[1:])]
    gathered_bound = float(np.mean(gathered)) / HBM_BYTES_PER_S * 1e3
    pf_ms = res["prefill_s"] * 1e3
    dec_ms = res["decode_s"] * 1e3 / (G - 1)
    print(f"  prefill {pf_ms:.3f} ms ({B * P / res['prefill_s']:.1f} tokens/s); bound "
          f"{pf_bound:.4f} ms (operations: {pf_flops / 1e12:.3f} TFLOP at 989 TFLOP/s bf16, "
          f"{expert_flops / 1e12:.3f} of it the {E} x {c_pf} expert slots)")
    print(f"  decode {dec_ms:.3f} ms a step of {B} tokens ({(G - 1) * B / res['decode_s']:.1f} "
          f"tokens/s) over {G - 1} steps; bound {dec_bound:.4f} ms (bytes: "
          f"{np.mean(dec_bytes) / 1e9:.3f} GB a step at 3.35 TB/s, all {E} experts' weights as the "
          f"reference's form reads them); a gathered form reading only the experts a step "
          f"routes to ({np.mean([sum(r['experts']) for r in routed[1:]]) / L:.1f} of {E} a layer "
          f"on average): {np.mean(gathered) / 1e9:.3f} GB, {gathered_bound:.4f} ms (recorded, "
          f"not built)")
    print(f"  dropped assignments: prefill {routed[0]['dropped']} of {B * P * mc.top_k * L}; "
          f"decode steps {sum(r['dropped'] for r in routed[1:])} of "
          f"{(G - 1) * B * mc.top_k * L} (capacity {c_dec} an expert a step)")
    if peak is not None:
        print(f"  torch.cuda.max_memory_allocated over the timed run {peak / 1e9:.3f} GB (less "
              f"{held / 1e9:.3f} GB that earlier phases hold); bound "
              f"{(w_bytes + kv_bytes) / 1e9:.3f} GB (the weights and the KV cache)")

    # The card against the host's CPU: an f32 copy of the first 2 layers at
    # full width (the full model is freed first: the copy is ~7 GB a side).
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", act_dtype="float32")
    small = {k: v for k, v in params.items() if k != "layers"}
    small["layers"] = zoo_tree(params["layers"], lambda t: t[:2])
    host = zoo_tree(small, lambda t: t.float().cpu())
    toks2 = torch.cat([batch["tokens"], toks], dim=1)[:2].cpu()
    del small, params, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    card = zoo_tree(host, lambda t: t.to(dev))
    model2 = build_model(cfg2)
    P2, G2 = min(64, P), 4
    runs = []
    for p, dv in ((card, dev), (host, torch.device("cpu"))):
        model2.moe_stats = []
        t2 = toks2.to(dv)
        lg, st = model2.prefill(p, {"tokens": t2[:, :P2], "max_len": P2 + G2})
        out = [lg.float().cpu()]
        for i in range(P2, P2 + G2 - 1):
            lg, st = model2.decode_step(p, st, t2[:, i : i + 1])
            out.append(lg.float().cpu())
        stats = [(int(s["dropped"]), float(s["aux"]), s["capacity"]) for s in model2.moe_stats]
        runs.append((out, stats))
    model2.moe_stats = None
    (got, gs), (want, ws) = runs
    err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
    aux_err = max(abs(a[1] - b[1]) / max(abs(b[1]), 1e-30) for a, b in zip(gs, ws))
    if err > ZOO_MOE_F32_TOL or aux_err > ZOO_MOE_F32_TOL:
        raise AssertionError(f"12d: the card's f32 2-layer run lies {err:.3e} x max|logit| "
                             f"(aux {aux_err:.3e}) from the host CPU's (bound {ZOO_MOE_F32_TOL})")
    if [a[0] for a in gs] != [b[0] for b in ws]:
        raise AssertionError(f"12d: dropped assignments per layer and call differ: card "
                             f"{[a[0] for a in gs]}, host CPU {[b[0] for b in ws]}")
    compared = 0
    for a, b in zip(got, want):
        parts = rel_gap(b) > 2 * ZOO_MOE_F32_TOL
        if not bool((a.argmax(-1) == b.argmax(-1))[parts].all()):
            raise AssertionError("12d: a greedy token of the f32 copy differs where margins part")
        compared += int(parts.sum())
    print(f"  f32 copy, full width, 2 layers, batch 2, prompt {P2}, {G2 - 1} decode steps: the "
          f"card within {err:.3e} x max|logit| of the host's CPU, each layer's aux within "
          f"{aux_err:.3e} (bound {ZOO_MOE_F32_TOL}); dropped assignments per layer and call equal "
          f"({[a[0] for a in gs]}, capacity {[a[2] for a in gs]}); greedy tokens equal at all "
          f"{compared} of {2 * G2} (row, call) pairs whose margins part by > "
          f"{2 * ZOO_MOE_F32_TOL}")
    del card, host
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(prefill_ms=pf_ms, prefill_bound_ms=pf_bound, decode_ms=dec_ms,
                decode_bound_ms=dec_bound, gathered_bound_ms=gathered_bound, peak_bytes=peak,
                mem_bound_bytes=w_bytes + kv_bytes, cpu_err=err, aux_err=aux_err,
                dropped=[r["dropped"] for r in routed], memory=mem)


ZOO_HYBRID = "zamba2-1.2b"  # phases 12e, 12f, 13d: the hybrid family at its published widths
ZOO_ENCDEC = "whisper-base"  # phases 12g, 13d: the encoder-decoder at its published widths
LONG_STEPS = 8  # 12f: decode steps timed at long_500k
LAUNCH_STEPS = 30  # 13d: steps of each run through the launcher
# 12e: the bf16 decode's logits against the bf16 teacher-forced forward,
# x max|logit|. tools/hybrid_faults.py's worst steps on an H100 at seeds
# 0-4: the sound model 0.0712-0.1223; a conv state never advanced, an SSM
# state dropped, a cache position not advanced 1.187-1.507. The SSM state or
# softplus(dt) rounded to bf16 read 0.0726-0.1838, inside the sound spread,
# and no fixed bound tells them from rounding (PERF.md §6).
ZOO_HYBRID_TF_TOL = 0.2


def teacher_forced_check(label, got, tf, tol=ZOO_TF_TOL):
    """Each step's logits ``got[j]`` (B, V) against the teacher-forced
    forward's ``tf[:, j]``: within ``tol`` x max|logit|, and the greedy
    tokens equal where the forward's top-two logits part by twice that.
    Returns (the worst error over max|logit|, rows compared, ties parted)."""
    worst, compared, parted = 0.0, 0, 0
    for j, g in enumerate(got):
        want = tf[:, j].float()
        scale = want.abs().max().item()
        err = (g.float() - want).abs().max().item()
        worst = max(worst, err / scale)
        if err > tol * scale:
            raise AssertionError(f"{label}: step {j}'s logits lie {err:.4g} from the teacher-forced "
                                 f"forward's (bound {tol} x {scale:.4g})")
        parts = rel_gap(want) > 2 * tol
        same = g.float().argmax(-1) == want.argmax(-1)
        if not bool(same[parts].all()):
            raise AssertionError(f"{label}: step {j}: a greedy token differs where margins part")
        compared += int(parts.sum())
        parted += int((~same).sum())
    return worst, compared, parted


def rel_err(got, want):
    """The largest difference over ``want``'s max |logit|."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def teacher_forced_logits(model, params, seq, P, G):
    """One forward over ``seq`` (B, P + G) without a cache: the logits at
    the G positions that predict its last G tokens, (B, G, V) f32."""
    with torch.inference_mode():
        h, _ = model._forward(params, params["embed"][seq.long()])
        return model._logits(params, h[:, P - 1 : P + G - 1]).float()


def card_against_host(model, params, dev, batches, n_dec):
    """Each batch (``tokens`` (B, P + n_dec) and the model's other inputs)
    prefilled with its first P tokens on the card and on the host's CPU,
    then n_dec - 1 decode steps fed the next tokens: the largest difference
    of any step's logits over that step's max|logit|."""
    host = zoo_tree(params, lambda t: t.cpu())
    err = 0.0
    for b in batches:
        runs = []
        for p, dv in ((params, dev), (host, torch.device("cpu"))):
            bb = {k: v.to(dv) for k, v in b.items()}
            toks = bb.pop("tokens")
            P = toks.shape[1] - n_dec
            lg, st = model.prefill(p, {**bb, "tokens": toks[:, :P], "max_len": toks.shape[1]})
            out = [lg.float().cpu()]
            for i in range(P, P + n_dec - 1):
                lg, st = model.decode_step(p, st, toks[:, i : i + 1])
                out.append(lg.float().cpu())
            runs.append(out)
        err = max(err, max(((a - c).abs().max() / c.abs().max()).item() for a, c in zip(*runs)))
    return err


def matrix_params(tree):
    """Parameters of a tree's matrices (the leaves products read)."""
    return sum(t.numel() for t in zoo_leaves(tree) if t.dim() >= 2)


def zoo_zamba2(dev, args):
    """Phase 12e: examples/torch_serve.py's path with Zamba2 at its
    published widths and depth. Returns the model and params for 12f."""
    import dataclasses

    import torch_serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ZOO_HYBRID, smoke=args.zoo_smoke)
    ssm = cfg.ssm
    model = build_model(cfg)
    sync(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    sync(dev)
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in zoo_leaves(params))
    w_bytes = tree_bytes(params)
    esz = params["embed"].element_size()
    B, P, G = args.hybrid_batch, args.hybrid_prompt, args.hybrid_gen
    T = P + G
    D, V, A = cfg.d_model, cfg.vocab, model.n_shared
    d_in = ssm.expand * D
    nh, hp, n = d_in // ssm.head_dim, ssm.head_dim, ssm.d_state
    kv_bytes = 2 * A * B * T * cfg.n_kv_heads * cfg.hd * esz
    state_bytes = (cfg.n_layers * B * nh * hp * n * 4
                   + cfg.n_layers * B * (ssm.d_conv - 1) * (d_in + 2 * n) * esz)
    print(f"[12e] {cfg.name}: {cfg.n_layers} Mamba2 layers (d_inner {d_in}, {nh} SSM heads x {hp}, "
          f"d_state {n}, chunk {ssm.chunk}), one shared attention + {cfg.mlp} block ({cfg.n_heads} "
          f"heads x {cfg.hd}, d_ff {cfg.d_ff}) applied {A} times, vocab {V}, {cfg.param_dtype}: "
          f"{n_params:,} parameters ({w_bytes / 1e9:.3f} GB) drawn on {dev} from --seed in "
          f"{t_init:.2f} s; batch {B}, prompt {P}, {G} generated, max_len {T}; KV {kv_bytes / 1e6:.1f} "
          f"MB ({A} slices), SSM and conv states {state_bytes / 1e6:.1f} MB")
    batch = torch_serve.make_batch(cfg, B, P, args.seed, dev)
    torch_serve.serve(model, params, batch, 3)  # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = torch_serve.serve(model, params, batch, G, keep_logits=True)
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    if not all(torch.isfinite(l).all() for l in res["logits"]):
        raise AssertionError("12e: non-finite logits")
    toks = res["tokens"]

    # Bounds. Prefill by its operations: the bf16 products (each Mamba2
    # layer's in_proj and out_proj, the shared block's projections and MLP at
    # each application, causal attention's pairs, the last position's
    # unembedding) at 989 TFLOP/s, and the SSD's f32 products (the chunked
    # form's C Bᵀ, its decay mask, the intra-chunk product, the chunk
    # states and the off-diagonal readout; the recurrence's update and
    # readout where P is not a multiple of the chunk) at 67 TFLOP/s.
    # Decode by its bytes: every weight but the embedding table, the B rows
    # gathered from it, every KV slice's valid positions, and the SSM and
    # conv states read and written.
    mamba_mm = matrix_params([lp["mix"] for lp in params["mamba"]])
    shared_mm = matrix_params(params["shared"])
    pairs = B * P * (P + 1) // 2
    pf_bf16 = (2.0 * B * P * (mamba_mm + A * shared_mm) + 4.0 * A * pairs * cfg.n_heads * cfg.hd
               + 2.0 * D * V * B)
    l = ssm.chunk
    if P % l == 0 and P > 1:
        ssd = B * (P // l) * (2 * l * l * n + nh * (l * l + 2 * l * l * hp + 4 * l * hp * n))
    else:
        ssd = B * P * nh * 4 * hp * n
    pf_f32 = float(cfg.n_layers * ssd)
    pf_bound = (pf_bf16 / BF16_PEAK + pf_f32 / F32_PEAK) * 1e3
    per_pos = kv_bytes / T
    emb_bytes = params["embed"].numel() * esz
    dec_bytes = [w_bytes - emb_bytes + B * D * esz + (P + j + 1) * per_pos + 2 * state_bytes
                 for j in range(G - 1)]
    dec_bound = float(np.mean(dec_bytes)) / HBM_BYTES_PER_S * 1e3
    pf_ms = res["prefill_s"] * 1e3
    dec_ms = res["decode_s"] * 1e3 / (G - 1)
    print(f"  prefill {pf_ms:.3f} ms ({B * P / res['prefill_s']:.1f} tokens/s); bound {pf_bound:.4f} "
          f"ms (operations: {pf_bf16 / 1e12:.3f} TFLOP bf16 at 989 TFLOP/s, the SSD's "
          f"{pf_f32 / 1e12:.4f} TFLOP f32 at 67 TFLOP/s)")
    print(f"  decode {dec_ms:.3f} ms a step of {B} tokens ({(G - 1) * B / res['decode_s']:.1f} "
          f"tokens/s) over {G - 1} steps; bound {dec_bound:.4f} ms (bytes: "
          f"{np.mean(dec_bytes) / 1e9:.3f} GB a step at 3.35 TB/s)")
    if peak is not None:
        print(f"  torch.cuda.max_memory_allocated over the timed run {peak / 1e9:.3f} GB (less "
              f"{held / 1e9:.3f} GB that earlier phases hold); bound "
              f"{(w_bytes + kv_bytes + state_bytes) / 1e9:.3f} GB (weights, KV, states)")

    # Decode against one teacher-forced pass over all P + G tokens (P + G =
    # 640 is five chunks: the chunked SSD, where decode took the recurrence).
    # The logic in f32: an f32 copy of the whole model decodes the same
    # tokens within ZOO_F32_TOL of its own forward. The bf16 run, its
    # recurrence and its states in the model's dtypes: every step within
    # ZOO_HYBRID_TF_TOL of the bf16 forward, and the greedy tokens equal
    # where that forward's top-two logits part by twice the bound. The
    # distances from the f32 forward are printed, not bounded.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    model32, p32 = build_model(cfg32), zoo_tree(params, lambda t: t.float())
    seq = torch.cat([batch["tokens"], toks], dim=1)
    tf16 = teacher_forced_logits(model, params, seq, P, G)
    tf32 = teacher_forced_logits(model32, p32, seq, P, G)
    with torch.inference_mode():
        lg, st = model32.prefill(p32, {"tokens": seq[:, :P], "max_len": T})
        dec32 = [lg]
        for j in range(G - 1):
            lg, st = model32.decode_step(p32, st, seq[:, P + j : P + j + 1])
            dec32.append(lg)
        del st
    err32 = max(rel_err(dec32[j], tf32[:, j]) for j in range(G))
    if err32 > ZOO_F32_TOL:
        raise AssertionError(f"12e: the f32 copy's decode lies {err32:.3e} x max|logit| from its "
                             f"teacher-forced forward (bound {ZOO_F32_TOL})")
    tf_err, compared, parted = teacher_forced_check("12e", res["logits"], tf16, ZOO_HYBRID_TF_TOL)
    own = max(rel_err(tf16[:, j], tf32[:, j]) for j in range(G))
    f32_err = max(rel_err(res["logits"][j], tf32[:, j]) for j in range(G))
    print(f"  f32 copy of the whole model: its decode within {err32:.3e} x max|logit| of its "
          f"teacher-forced forward over {P + G} tokens (bound {ZOO_F32_TOL})")
    print(f"  bf16: every step's logits within {tf_err:.4g} x max|logit| of the bf16 forward (bound "
          f"{ZOO_HYBRID_TF_TOL}); greedy tokens equal at all {compared} of {B * G} (row, step) "
          f"pairs whose margins part by > {2 * ZOO_HYBRID_TF_TOL}; {parted} ties went either way; "
          f"from the f32 forward (not bounded): the bf16 decode {f32_err:.4g}, the bf16 forward "
          f"{own:.4g}")
    del model32, p32, dec32, tf16

    # The card against the host's CPU: an f32 copy at full width, 2 Mamba2
    # layers and the shared block, prompts of whole chunks and of 17 tokens.
    if dev.type == "cuda":
        assert not torch.backends.cuda.matmul.allow_tf32
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", act_dtype="float32")
    small = {k: v for k, v in params.items() if k != "mamba"}
    small["mamba"] = params["mamba"][:2]
    small = zoo_tree(small, lambda t: t.float())
    seq2 = torch.cat([batch["tokens"], toks], dim=1)[:2]
    p_chunked = min(P, 512) // l * l
    err = card_against_host(build_model(cfg2), small, dev,
                            [{"tokens": seq2[:, : p + 4]} for p in (p_chunked, 17)], 4)
    if err > ZOO_F32_TOL:
        raise AssertionError(f"12e: the card's f32 copy lies {err:.3e} x max|logit| from the host "
                             f"CPU's (bound {ZOO_F32_TOL})")
    print(f"  f32 copy, full width, 2 Mamba2 layers + the shared block, batch 2, prompts "
          f"{p_chunked} (chunked) and 17 (sequential), 3 decode steps each: the card within "
          f"{err:.3e} x max|logit| of the host's CPU (bound {ZOO_F32_TOL}; TF32 off)")
    del small, tf32, res
    return model, params, dict(prefill_ms=pf_ms, prefill_bound_ms=pf_bound, decode_ms=dec_ms,
                               decode_bound_ms=dec_bound, peak_bytes=peak, tf_err=tf_err,
                               f32_err=f32_err, own_bf16=own, decode32_err=err32, cpu_err=err)


def zoo_long(dev, args, model, params):
    """Phase 12f: 12e's model decoding at shapes.py's long_500k cell: one
    sequence, --long-len positions of KV in every shared slice, the KV, SSM
    and conv states drawn from --seed. A warm-up step, then LONG_STEPS timed
    steps at the last positions of the buffer."""
    cfg = model.cfg
    N, steps = args.long_len, LONG_STEPS
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = model.decode_state(1, N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for t in zoo_leaves(state["c"]):
        t.normal_(generator=gen)
    kv_bytes = tree_bytes(state["c"]["kv"])
    state_bytes = tree_bytes(state["c"]["ssm"]) + tree_bytes(state["c"]["conv"])
    w_bytes = tree_bytes(params)
    emb_bytes = params["embed"].numel() * params["embed"].element_size()
    state["pos"] = N - steps - 1
    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab, (1, steps + 1)),
                           dtype=torch.int32, device=dev)
    logits, state = model.decode_step(params, state, toks[:, :1])  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    out = []
    for i in range(1, steps + 1):
        logits, state = model.decode_step(params, state, toks[:, i : i + 1])
        out.append(logits)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    if not all(torch.isfinite(l).all() for l in out):
        raise AssertionError("12f: non-finite logits")
    nbytes = w_bytes - emb_bytes + cfg.d_model * 2 + kv_bytes + 2 * state_bytes
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[12f] {cfg.name} at long_500k: batch 1, {N:,} positions, KV {kv_bytes / 1e9:.3f} GB "
          f"({model.n_shared} slices x k, v), SSM and conv states {state_bytes / 1e6:.1f} MB, drawn "
          f"from --seed; {steps} decode steps after a warm-up, at positions {N - steps}-{N - 1}")
    print(f"  {ms:.3f} ms a step; bound {bound:.4f} ms (bytes: {nbytes / 1e9:.3f} GB a step at "
          f"3.35 TB/s: the weights but the embedding table, every KV position, the states read "
          f"and written)")
    if peak is not None:
        print(f"  torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB over the state and the steps "
              f"(less {held / 1e9:.3f} GB held: earlier phases and 12e's weights); the state {(kv_bytes + state_bytes) / 1e9:.3f} "
              f"GB, so {(peak - kv_bytes - state_bytes) / 1e9:.3f} GB in flight (direct_attention "
              f"takes each slice's K and V to f32)")

    # One shared application's attention at the last position: the card's f32
    # attention over slice 0's K and V against an f32 replay on the host.
    from repro_torch.models.layers import direct_attention

    kc, vc = state["c"]["kv"]["k"][0], state["c"]["kv"]["v"][0]
    q = torch.randn((1, 1, cfg.n_heads, cfg.hd), generator=gen, device=dev, dtype=torch.float32)
    kw = dict(causal=True, q_offset=N - 1, kv_valid_len=N)
    direct_attention(q, kc, vc, **kw)  # warm-up
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    got = direct_attention(q, kc, vc, **kw)
    sync(dev)
    att_ms = (time.perf_counter() - t0) * 1e3
    att_extra = torch.cuda.max_memory_allocated(dev) - before if dev.type == "cuda" else None
    # The host's replay, written out: softmax(q k^T / sqrt(hd)) v in f32, the
    # probabilities rounded to V's dtype as the reference's attention rounds
    # them, and each output's scale sum_i p_i |v_i| (the outputs are sums of
    # N terms of either sign that mostly cancel, so their f32 error scales
    # with it).
    k32, v32 = kc.cpu().float()[0], vc.cpu().float()[0]  # (N, KV, hd)
    G = cfg.n_heads // cfg.n_kv_heads
    qh = q.cpu()[0, 0].reshape(cfg.n_kv_heads, G, cfg.hd)
    pr = torch.softmax(torch.einsum("kgd,nkd->kgn", qh, k32) / cfg.hd ** 0.5, dim=-1)
    pr = pr.to(vc.dtype).float()
    want = torch.einsum("kgn,nkd->kgd", pr, v32).reshape(cfg.n_heads, cfg.hd)
    scale = torch.einsum("kgn,nkd->kgd", pr, v32.abs()).reshape(cfg.n_heads, cfg.hd)
    err = ((got.cpu()[0, 0] - want).abs() / scale).max().item()
    del k32, v32, pr
    if err > ZOO_F32_TOL:
        raise AssertionError(f"12f: slice 0's attention on the card lies {err:.3e} x sum p|v| from "
                             f"the host's f32 replay (bound {ZOO_F32_TOL})")
    att_bytes = tree_bytes([kc, vc])
    print(f"  slice 0's attention at position {N - 1:,} (f32 query): the card within {err:.3e} x "
          f"sum_i p_i |v_i| of the host's f32 replay over the same K and V (bound {ZOO_F32_TOL}); one call "
          f"{att_ms:.3f} ms against {att_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms for its "
          f"{att_bytes / 1e9:.3f} GB of bf16 K and V" + (
              "" if att_extra is None else f", {att_extra / 1e9:.3f} GB allocated beyond them "
              "(their f32 copies and the scores)"))
    del state, out, kc, vc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=bound, peak_bytes=peak, attn_ms=att_ms, attn_err=err,
                attn_extra_bytes=att_extra)


def zoo_whisper(dev, args):
    """Phase 12g: examples/torch_serve.py's path with Whisper at its
    published widths and depth, frames drawn from --seed."""
    import dataclasses

    import torch_serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ZOO_ENCDEC, smoke=args.zoo_smoke)
    model = build_model(cfg)
    sync(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    n_params = sum(t.numel() for t in zoo_leaves(params))
    w_bytes = tree_bytes(params)
    esz = params["embed"].element_size()
    B, P, G = args.encdec_batch, args.encdec_prompt, args.encdec_gen
    T, S, D, V, L = P + G, cfg.encoder_seq, cfg.d_model, cfg.vocab, cfg.n_layers
    H, hd = cfg.n_heads, cfg.hd
    kv_bytes = 2 * L * B * T * cfg.n_kv_heads * hd * esz
    print(f"[12g] {cfg.name}: {cfg.n_encoder_layers} + {L} layers, d_model {D}, {H} heads x {hd}, "
          f"{cfg.mlp} d_ff {cfg.d_ff}, vocab {V}, {cfg.param_dtype}: {n_params:,} parameters "
          f"({w_bytes / 1e9:.3f} GB) drawn on {dev} from --seed; batch {B}, frames ({B}, {S}, {D}) "
          f"drawn N(0, 0.1^2) from --seed, prompt {P}, {G} generated, max_len {T}")
    batch = torch_serve.make_batch(cfg, B, P, args.seed, dev)
    torch_serve.serve(model, params, batch, 3)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc_out = model.encode(params, batch["frames"])
    sync(dev)
    enc_ms = (time.perf_counter() - t0) * 1e3
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = torch_serve.serve(model, params, batch, G, keep_logits=True)
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    if not all(torch.isfinite(l).all() for l in res["logits"]):
        raise AssertionError("12g: non-finite logits")
    toks = res["tokens"]

    # Bounds, by the products at 989 TFLOP/s: the encoder's layers and
    # pairs over S frames; the decoder's self-attention and MLP products per
    # token, its cross-attention's q / o per token and k / v over the S
    # encoder positions (recomputed at every call, as the reference does),
    # the pairs, the unembedding of the last position. Decode also by its
    # bytes (the weights but the embedding table, the self KV's valid
    # positions, enc_out): the larger of the two.
    enc_mm = matrix_params(params["enc_layers"])
    dec = params["dec_layers"]
    xkv = sum(lp["xattn"][k].numel() for lp in dec for k in ("wk", "wv"))
    dec_mm = matrix_params(dec) - xkv
    enc_flops = 2.0 * B * S * enc_mm + 4.0 * cfg.n_encoder_layers * B * S * S * H * hd
    pf_flops = (enc_flops + 2.0 * B * P * dec_mm + 2.0 * B * S * xkv
                + 4.0 * L * B * (P * (P + 1) // 2 + P * S) * H * hd + 2.0 * D * V * B)
    pf_bound = pf_flops / BF16_PEAK * 1e3
    dec_flops = [2.0 * B * dec_mm + 2.0 * B * S * xkv + 4.0 * L * B * (P + j + 1 + S) * H * hd
                 + 2.0 * D * V * B for j in range(G - 1)]
    emb_bytes = params["embed"].numel() * esz
    dec_bytes = [w_bytes - emb_bytes + B * D * esz + (P + j + 1) * kv_bytes / T + B * S * D * esz
                 for j in range(G - 1)]
    dec_bound = float(np.mean([max(f / BF16_PEAK, b / HBM_BYTES_PER_S)
                               for f, b in zip(dec_flops, dec_bytes)])) * 1e3
    pf_ms = res["prefill_s"] * 1e3
    dec_ms = res["decode_s"] * 1e3 / (G - 1)
    print(f"  encode {enc_ms:.3f} ms (bound {enc_flops / BF16_PEAK * 1e3:.4f} ms); prefill with the "
          f"encode {pf_ms:.3f} ms ({B * P / res['prefill_s']:.1f} tokens/s), bound {pf_bound:.4f} ms "
          f"({pf_flops / 1e12:.4f} TFLOP at 989 TFLOP/s)")
    print(f"  decode {dec_ms:.3f} ms a step of {B} tokens ({(G - 1) * B / res['decode_s']:.1f} "
          f"tokens/s) over {G - 1} steps; bound {dec_bound:.4f} ms (operations "
          f"{np.mean(dec_flops) / 1e9:.2f} GFLOP a step, {2.0 * B * S * xkv / 1e9:.2f} of them the "
          f"cross K / V recomputed; bytes {np.mean(dec_bytes) / 1e9:.4f} GB)")
    if peak is not None:
        print(f"  torch.cuda.max_memory_allocated over the timed run {peak / 1e9:.3f} GB (less "
              f"{held / 1e9:.3f} GB held); weights, KV and enc_out "
              f"{(w_bytes + kv_bytes + B * S * D * esz) / 1e9:.4f} GB")

    with torch.inference_mode():
        seq = torch.cat([batch["tokens"], toks], dim=1)
        h = model._decoder(params, params["embed"][seq.long()], enc_out)
        tf = model._logits(params, h[:, P - 1 : P + G - 1])
    worst, compared, parted = teacher_forced_check("12g", res["logits"], tf)
    print(f"  every step's logits within {worst:.4g} x max|logit| of the teacher-forced forward "
          f"(bound {ZOO_TF_TOL}); greedy tokens equal at all {compared} of {B * G} (row, step) "
          f"pairs whose margins part by > {2 * ZOO_TF_TOL}; {parted} ties went either way")

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    p32 = zoo_tree(params, lambda t: t.float())
    seq2 = torch.cat([batch["tokens"], toks], dim=1)[:2]
    p2 = min(16, P)
    err = card_against_host(build_model(cfg32), p32, dev,
                            [{"tokens": seq2[:, : p2 + 4], "frames": batch["frames"][:2]}], 4)
    if err > ZOO_F32_TOL:
        raise AssertionError(f"12g: the card's f32 copy lies {err:.3e} x max|logit| from the host "
                             f"CPU's (bound {ZOO_F32_TOL})")
    print(f"  f32 copy at full width and depth, batch 2, prompt {p2}, 3 decode steps: the card "
          f"within {err:.3e} x max|logit| of the host's CPU (bound {ZOO_F32_TOL}; TF32 off)")
    del params, p32, res, tf, h, enc_out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(encode_ms=enc_ms, prefill_ms=pf_ms, prefill_bound_ms=pf_bound, decode_ms=dec_ms,
                decode_bound_ms=dec_bound, peak_bytes=peak, tf_err=worst, cpu_err=err)


def phase_zoo(dev, args):
    """Phase 12: the LLM zoo's serving path (ROADMAP A14; 12e-12g A14.3)."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(ROOT / "examples"))
    model, params, dense = zoo_dense(dev, args)
    t_a = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    batched = zoo_batcher(dev, args)
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = zoo_features(dev, args, model, params)
    t_c = time.perf_counter() - t0
    del model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe = zoo_moe(dev, args)
    t_d = time.perf_counter() - t0
    hybrid = phase_families(dev, args)
    total = time.perf_counter() - t_phase
    print(f"[12] wall seconds: (a) {t_a:.1f}, (b) {t_b:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f}, "
          f"(e-g) {hybrid['seconds']:.1f}; phase 12 {total:.1f} s")
    return dict(dense=dense, batched=batched, features=feats, moe=moe, families=hybrid,
                seconds=total)


def phase_families(dev, args):
    """Phases 12e-12g: Zamba2 and Whisper served (ROADMAP A14.3)."""
    sys.path.insert(0, str(ROOT / "examples"))
    t0 = time.perf_counter()
    model, params, zamba = zoo_zamba2(dev, args)
    t_e = time.perf_counter() - t0
    t0 = time.perf_counter()
    long = zoo_long(dev, args, model, params)
    t_f = time.perf_counter() - t0
    del model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whisper = zoo_whisper(dev, args)
    t_g = time.perf_counter() - t0
    print(f"[12e-g] wall seconds: (e) {t_e:.1f}, (f) {t_f:.1f}, (g) {t_g:.1f}")
    return dict(zamba2=zamba, long=long, whisper=whisper, seconds=t_e + t_f + t_g)


TRAIN_ARCH = "internlm2-1.8b"  # phase 13a: the dense decoder trained at its published widths
TRAIN_LOSS_DROP = 0.5  # 13a: the last 10 steps' mean loss this far (nats) below the first 10's
TRAIN_REMAT_GN_RTOL = 1e-5  # 13a: remat "full" against "none": grad norm (the loss: bit for bit)
ADAMW_BYTES = 22  # 13a: a bf16 param's AdamW step with f32 moments: p, g, m, v read, p, m, v written


def train_batches(cfg, steps):
    """examples/llm_feature_svm.py's pretraining batches: 8 documents of 64
    tokens from styled_corpus(vocab, 256, 65, seed=42), slid by 8 a step."""
    from repro_torch.data import styled_corpus

    pre, _ = styled_corpus(cfg.vocab, 256, 65, seed=42)
    return [pre[(i * 8) % 248 : (i * 8) % 248 + 8] for i in range(steps)]


def train_dense(dev, args):
    """Phase 13a: the feature example's pretraining (make_train_step, AdamW
    with f32 moments, TrainCfg(peak_lr=1e-3, warmup_steps=10,
    total_steps=60)) with the dense config at its published widths; the
    loss falling, every grad_norm finite, microbatches=4 equal to 1 within
    tests/test_train_loop.py's tolerances, and remat "full" against "none".
    Returns the model, the trained params and the numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainCfg, init_state, make_train_step

    cfg = get_config(TRAIN_ARCH, smoke=args.zoo_smoke)
    model = build_model(cfg)
    tcfg = TrainCfg(peak_lr=1e-3, warmup_steps=10, total_steps=60)
    steps = 60  # the feature example's pretraining
    docs = train_batches(cfg, steps)
    batch = lambda i: {"tokens": torch.as_tensor(docs[i][:, :-1], device=dev),
                       "targets": torch.as_tensor(docs[i][:, 1:], device=dev)}
    fresh = lambda: init_state(model, torch.Generator(device=dev).manual_seed(args.seed), tcfg)
    sync(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

    # microbatches=4 against 1 on one batch, at warmup's second step (lr > 0)
    t0 = time.perf_counter()
    res = {}
    for A in (1, 4):
        st = fresh()
        st["opt"] = st["opt"]._replace(step=st["opt"].step + 1)
        b0 = batch(0)
        step = make_train_step(model, dataclasses.replace(tcfg, microbatches=A))
        if A == 1:  # this step's memory against the dry run's count
            mem, (st, m) = memory_check("13a", dev, train_memory_count(model, tcfg, b0),
                                        lambda: step(st, b0))
        else:
            st, m = step(st, b0)
        res[A] = (float(m["loss"]), float(m["grad_norm"]), st["params"])
        del st
    (l1, g1, p1), (l4, g4, p4) = res[1], res[4]
    worst = 0.0
    for a, b in zip(zoo_leaves(p1), zoo_leaves(p4)):
        a, b = a.float(), b.float()
        if not torch.allclose(b, a, rtol=0.1, atol=2e-2):
            raise AssertionError("13a: microbatches=4 and 1 give params beyond rtol 0.1 / atol 2e-2")
        worst = max(worst, float((a - b).abs().max()))
    if abs(l4 - l1) > 2e-2 * abs(l1) or abs(g4 - g1) > 2e-2 * abs(g1):
        raise AssertionError(f"13a: microbatches=4 loss {l4} / grad_norm {g4} against 1's {l1} / "
                             f"{g1} (rtol 2e-2)")
    del res, p1, p4
    t_mb = time.perf_counter() - t0

    state = fresh()
    n_params = sum(t.numel() for t in zoo_leaves(state["params"]))
    step = make_train_step(model, tcfg)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms = [], []
    sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step(state, batch(i))
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        if i == 0:
            sync(dev)
            t1 = time.perf_counter()
    sync(dev)
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    if not all(np.isfinite(gnorms)) or not all(np.isfinite(losses)):
        raise AssertionError(f"13a: a non-finite loss or grad_norm: {losses}, {gnorms}")
    k = min(10, steps // 2)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    if not last < first - TRAIN_LOSS_DROP:
        raise AssertionError(f"13a: the loss did not fall by {TRAIN_LOSS_DROP}: the first {k} "
                             f"steps' mean {first:.4f}, the last {k}'s {last:.4f}")
    tokens = docs[0][:, :-1].size
    ms = (t_end - t1) / max(steps - 1, 1) * 1e3
    flops_ms = 6.0 * n_params * tokens / BF16_PEAK * 1e3
    bytes_ms = ADAMW_BYTES * n_params / HBM_BYTES_PER_S * 1e3
    mom = 4 * 2 * n_params
    p_bytes = n_params * state["params"]["embed"].element_size()
    print(f"[13a] {cfg.name} trained at its published widths: {n_params:,} parameters "
          f"({cfg.param_dtype}, f32 moments), {steps} steps of {docs[0].shape[0]} x "
          f"{docs[0].shape[1] - 1} tokens from styled_corpus(seed=42), TrainCfg(peak_lr=1e-3, "
          f"warmup_steps=10, total_steps=60)")
    print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}: the first {k} steps' mean {first:.4f}, the "
          f"last {k}'s {last:.4f} (falls by {first - last:.4f}, asked {TRAIN_LOSS_DROP}); "
          f"grad_norm finite at every step ({min(gnorms):.4g} to {max(gnorms):.4g})")
    print(f"  {ms:.3f} ms a step over steps 2-{steps} ({tokens * 1e3 / ms:.1f} tokens/s); bound "
          f"{max(flops_ms, bytes_ms):.4f} ms, the larger of 6 x params x tokens at 989 TFLOP/s "
          f"({flops_ms:.4f} ms) and AdamW's {ADAMW_BYTES} B a param at 3.35 TB/s ({bytes_ms:.4f} ms)")
    if peak is not None:
        print(f"  torch.cuda.max_memory_allocated over the {steps} steps {peak / 1e9:.3f} GB (less "
              f"{held / 1e9:.3f} GB that earlier phases hold): params {p_bytes / 1e9:.3f} GB, "
              f"grads {p_bytes / 1e9:.3f}, moments {mom / 1e9:.3f}, so {(peak - 2 * p_bytes - mom) / 1e9:.3f} "
              f"GB of AdamW's f32 slices and activations")
    print(f"  microbatches=4 against 1 at warmup's second step: loss {l4:.6f} / {l1:.6f}, grad_norm "
          f"{g4:.6f} / {g1:.6f}, params within {worst:.3e} (tolerances of "
          f"tests/test_train_loop.py: rtol 2e-2; rtol 0.1, atol 2e-2) ({t_mb:.1f} s)")

    # remat "full" against "none": the trained params, one batch, loss and grads
    params = state["params"]
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rem = {}
    for remat in ("none", "full"):
        mr = build_model(cfg, remat=remat)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ps = zoo_tree(params, lambda t: t.detach().requires_grad_())
        loss, _ = mr.loss(ps, batch(0))
        grads = torch.autograd.grad(loss, list(zoo_leaves(ps)))
        gn = float(adamw.global_norm(list(grads)))
        pk = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else 0
        rem[remat] = (loss.detach(), gn, pk)
        del ps, grads, loss
    (ln, gn_n, pk_n), (lf, gn_f, pk_f) = rem["none"], rem["full"]
    if not torch.equal(ln, lf) or abs(gn_f - gn_n) > TRAIN_REMAT_GN_RTOL * gn_n:
        raise AssertionError(f"13a: remat full loss {float(lf)} / grad norm {gn_f} against none's "
                             f"{float(ln)} / {gn_n}")
    print(f"  remat \"full\" against \"none\" (loss and grads of one batch): the loss bit for bit, "
          f"grad norm {gn_f:.6f} / {gn_n:.6f} (bound rtol {TRAIN_REMAT_GN_RTOL}: the embedding's "
          f"backward accumulates with atomics); peak {pk_f / 1e9:.3f} / {pk_n / 1e9:.3f} GB")
    return model, params, dict(losses=losses, first=first, last=last, ms=ms,
                               bound_ms=max(flops_ms, bytes_ms), flops_ms=flops_ms,
                               bytes_ms=bytes_ms, peak_bytes=peak, n_params=n_params,
                               tokens_per_s=tokens * 1e3 / ms, memory=mem)


def train_resume(dev, args):
    """Phase 13b: examples/torch_train_lm.py's main (lm-100m with --full)
    preempted at step 30 and resumed from its step-20 checkpoint, against
    the same run uninterrupted: every loss and every leaf of the final state
    (params, moments, step) bit for bit, under --deterministic."""
    import shutil

    import torch_train_lm

    size, crash = ((["--steps", "23", "--batch", "2", "--seq", "16"], "21") if args.zoo_smoke
                   else (["--full", "--steps", "32"], "30"))
    base = ["--device", dev.type, "--deterministic", "--quiet"] + size
    tmp = tempfile.mkdtemp(prefix="chip_smoke_13b_")
    try:
        t0 = time.perf_counter()
        crashed = torch_train_lm.main(base + ["--crash-at", crash, "--ckpt-dir", f"{tmp}/a"])
        t_crash = time.perf_counter() - t0
        t0 = time.perf_counter()
        clean = torch_train_lm.main(base + ["--crash-at", "0", "--ckpt-dir", f"{tmp}/b"])
        t_clean = time.perf_counter() - t0
        ckpt_bytes = sum(p.stat().st_size for p in Path(f"{tmp}/a").glob("arrays-*.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from repro_torch._tree import leaves

    a, b = leaves(crashed["state"]), leaves(clean["state"])  # the restored dicts are key-sorted
    same = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    if crashed["losses"] != clean["losses"] or not same or clean["resumed_at"] is not None:
        raise AssertionError(f"13b: the resumed run (from step {crashed['resumed_at']}) differs from "
                             "the uninterrupted one")
    steps = len(clean["losses"])
    print(f"[13b] examples/torch_train_lm.py {crashed['arch']} ({crashed['n_params']:,} parameters), "
          f"{steps} steps under torch.use_deterministic_algorithms: preempted, resumed at step "
          f"{crashed['resumed_at']} from a {ckpt_bytes / 1e9:.3f} GB checkpoint; every loss "
          f"({clean['losses'][0]:.4f} -> {clean['losses'][-1]:.4f}) and all {len(a)} state leaves "
          f"equal the uninterrupted run's bit for bit; {t_crash:.1f} s with the preemption, "
          f"{t_clean:.1f} s without")
    return dict(resumed_at=crashed["resumed_at"], steps=steps, seconds=t_crash + t_clean)


def remat_check(label, cfg, params, batch):
    """Loss and grads of one batch with remat "full" against "none": the
    loss bit for bit, the grad norm within TRAIN_REMAT_GN_RTOL."""
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    out = {}
    for remat in ("none", "full"):
        ps = zoo_tree(params, lambda t: t.detach().requires_grad_())
        loss, _ = build_model(cfg, remat=remat).loss(ps, batch)
        grads = torch.autograd.grad(loss, list(zoo_leaves(ps)))
        out[remat] = (loss.detach(), float(adamw.global_norm(list(grads))))
        del ps, grads, loss
    (ln, gn), (lf, gf) = out["none"], out["full"]
    if not torch.equal(ln, lf) or abs(gf - gn) > TRAIN_REMAT_GN_RTOL * gn:
        raise AssertionError(f"{label}: remat full loss {float(lf)} / grad norm {gf} against none's "
                             f"{float(ln)} / {gn}")
    return gf, gn


def launched(label, out, n_params, tokens, flops):
    """Checks and prints one launcher run: every loss and grad norm finite,
    the last 10 steps' mean loss below the first 10's. ``flops``: a step's
    operations for its bound."""
    losses, gnorms = out["losses"], out["grad_norms"]
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"{label}: a non-finite loss or grad_norm: {losses}, {gnorms}")
    k = min(10, len(losses) // 2)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    if not last < first:
        raise AssertionError(f"{label}: the loss did not fall: the first {k} steps' mean "
                             f"{first:.4f}, the last {k}'s {last:.4f}")
    ms = out["ms_per_step"]
    flops_ms = flops / BF16_PEAK * 1e3
    bytes_ms = ADAMW_BYTES * n_params / HBM_BYTES_PER_S * 1e3
    print(f"  {out['arch']}: {n_params:,} parameters, loss {losses[0]:.4f} -> {losses[-1]:.4f} (the "
          f"first {k} steps' mean {first:.4f}, the last {k}'s {last:.4f}); grad_norm finite "
          f"({min(gnorms):.4g} to {max(gnorms):.4g}); {ms:.3f} ms a step over steps 2-"
          f"{len(losses)} ({tokens * 1e3 / ms:.1f} tokens/s); bound {max(flops_ms, bytes_ms):.4f} "
          f"ms ({flops / 1e12:.3f} TFLOP at 989 TFLOP/s {flops_ms:.4f}, AdamW's {ADAMW_BYTES} B a "
          f"param at 3.35 TB/s {bytes_ms:.4f})")
    return dict(first=first, last=last, ms=ms, bound_ms=max(flops_ms, bytes_ms),
                tokens_per_s=tokens * 1e3 / ms)


def train_launcher(dev, args):
    """Phase 13d: Zamba2 and Whisper trained through python -m
    repro_torch.launch.train's main at their published widths and depth."""
    import shutil

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import token_batches
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model
    from repro_torch.train import TrainCfg, make_train_step

    steps, B = LAUNCH_STEPS, args.launch_batch
    seq_h, seq_e = args.launch_seq
    smoke = ["--smoke"] if args.zoo_smoke else []
    res = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_13d_")
    try:
        for arch, seq in ((ZOO_HYBRID, seq_h), (ZOO_ENCDEC, seq_e)):
            cfg = get_config(arch, smoke=args.zoo_smoke)
            base = ["--arch", arch, "--steps", str(steps), "--batch", str(B), "--seq", str(seq),
                    "--device", dev.type, "--quiet"] + smoke
            sync(dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
            if arch == ZOO_HYBRID:
                # remat "full": without it the 38 layers' f32 SSD activations
                # took the run to 73.96 GB on an H100 80GB (PERF.md)
                out = launch.main(base + ["--ckpt-every", "0", "--remat", "full"])
                print(f"[13d] python -m repro_torch.launch.train --arch {arch} --steps {steps} "
                      f"--batch {B} --seq {seq} --remat full (the chunked SSD: {seq} a multiple "
                      f"of {cfg.ssm.chunk}), bf16, f32 moments, token_batches(seed=1)")
                extra = {}
            else:
                # preempted after 2/3 of the steps, resumed from the checkpoint at half,
                # against the run uninterrupted, under deterministic algorithms
                every, cut_at = steps // 2, steps * 2 // 3
                det = base + ["--deterministic", "--ckpt-every", str(every)]
                t0 = time.perf_counter()
                cut = launch.main(det + ["--ckpt-dir", f"{tmp}/a", "--stop-after", str(cut_at)])
                resumed = launch.main(det + ["--ckpt-dir", f"{tmp}/a", "--resume"])
                t_cut = time.perf_counter() - t0
                out = launch.main(det + ["--ckpt-dir", f"{tmp}/b"])
                a, b = leaves(resumed["state"]), leaves(out["state"])
                same = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                                for x, y in zip(a, b))
                if (resumed["start"] != every or cut["losses"][:every] + resumed["losses"]
                        != out["losses"] or not same):
                    raise AssertionError(f"13d: {arch} resumed at step {resumed['start']} differs "
                                         "from the uninterrupted run")
                print(f"[13d] python -m repro_torch.launch.train --arch {arch} --steps {steps} "
                      f"--batch {B} --seq {seq} --ckpt-every {every} --deterministic (frames: "
                      f"the launcher's zeros): preempted after step {cut_at}, resumed from the "
                      f"step-{every} checkpoint, every loss and all {len(a)} state leaves equal "
                      f"the uninterrupted run's bit for bit ({t_cut:.1f} s preempted and "
                      f"resumed, {out['seconds']:.1f} s uninterrupted)")
                extra = dict(resumed_at=resumed["start"])
            peak = torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None
            # a step's operations: 6 x params x tokens; Whisper's encoder
            # matrices see encoder_seq frames a sequence, not seq tokens
            flops = 6.0 * out["n_params"] * B * seq
            if cfg.family == "encdec":
                enc = matrix_params(out["state"]["params"]["enc_layers"])
                flops += 6.0 * enc * B * (cfg.encoder_seq - seq)
            r = launched("13d", out, out["n_params"], B * seq, flops)
            if peak is not None:
                print(f"    torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB (params, grads, "
                      f"moments {(2 * 2 + 8) * out['n_params'] / 1e9:.3f} GB and activations)")
            first = next(token_batches(cfg.vocab, B, seq, 1, seed=1))
            batch = {k: torch.as_tensor(v, device=dev) for k, v in first.items()}
            if cfg.family == "encdec":
                batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), device=dev)
            gf, gn = remat_check("13d", cfg, out["state"]["params"], batch)
            print(f"    remat \"full\" against \"none\" on the trained params and the first "
                  f"batch: the loss bit for bit, grad norm {gf:.6f} / {gn:.6f} (bound rtol "
                  f"{TRAIN_REMAT_GN_RTOL})")
            if arch == ZOO_HYBRID:  # one more step, as the launcher runs it, against the count
                model = build_model(cfg, remat="full")
                tcfg = TrainCfg(moment_dtype=cfg.moment_dtype)
                step = make_train_step(model, tcfg)
                extra["memory"], _ = memory_check("13d", dev, train_memory_count(model, tcfg, batch),
                                                  lambda: step(out["state"], batch))
            res[arch] = dict(r, peak_bytes=peak, **extra)
            del out, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_train(dev, args, zoo):
    """Phase 13: the LLM zoo's training path (ROADMAP A14.1; 13d A14.4's launcher)."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(ROOT / "examples"))
    model, params, dense = train_dense(dev, args)
    t_a = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    resume = train_resume(dev, args)
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = zoo_features(dev, args, model, params, label="13c", lookaheads=(1, 10),
                         trained=len(dense["losses"]))
    t_c = time.perf_counter() - t0
    print(f"  13c against 12c: held-out accuracy {feats['acc'][1]:.2f} % (lookahead 1, B4) and "
          f"{feats['acc'][10]:.2f} % (lookahead 10, the qp engine) from the trained backbone; "
          f"{zoo['features']['acc'][1]:.2f} % from the random-init one (12c, lookahead 1)")
    del model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launcher = train_launcher(dev, args)
    t_d = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"[13] wall seconds: (a) {t_a:.1f}, (b) {t_b:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f}; "
          f"phase 13 {total:.1f} s")
    return dict(dense=dense, resume=resume, features=feats, launcher=launcher, seconds=total)


def baseline_rows(dev, args, res, row):
    """Phase 5's rows for P1 and P2 at mnist89's first stream order of phase
    11: ms by events around launches back to back and on the card alone
    behind a spin (``device_ms``), the plain version's ms (one host-clocked
    call), the launches on phase 11's path. P2's row is k = 1 (the walk),
    with k = 20 beside it, each in its planned layout, their decisions held
    to the plain version first (``check_p2``)."""
    from repro_torch.kernels.baselines import (
        _launch, pegasos_layouts, pegasos_plan, pegasos_scan, perceptron_scan,
        perceptron_scan_plain)

    if res["mnist89"] is None:
        return []
    X, y, lam, _ = res["mnist89"]
    n, d = X.shape
    reps = 2 * args.reps + 1 if dev.type == "cuda" else 2
    none = [None] * reps
    wk, mk = perceptron_scan(X, y)
    err1 = check_close("P1 at phase 5", wk, perceptron_scan_plain(X, y)[0], RTOL_W, ATOL_W)
    ms1, dev1 = (time_states_ms(lambda _: perceptron_scan(X, y), none, dev, card)
                 for card in (False, True))
    plain1 = time_ms(lambda: perceptron_scan_plain(X, y), dev, 1, warmup=0)
    m = int(mk)
    out = [dict(row("perceptron_scan", "src/repro_torch/kernels/csrc/streamsvm_single.cu",
                    "src/repro/baselines/perceptron.py:12", res["launches"]["P1"], err1, ms1,
                    plain1, 2.0 * n * d + m * d, 4.0 * (n * d + n + d), None,
                    f"mnist89 in phase 11's first stream order: N={n} D={d}, {m} mistakes; "
                    "B4's walk (whole blocks staged, w in shared memory); launches: every "
                    "dataset and stream order of phase 11a (the reference's lax.scan has no "
                    "pl.pallas_call: `replaces` names the scan)"), device_ms=dev1)]
    # k = 1 in the planned layout; k = 20 in the walk over blocks and in the
    # step form in turns (events, then the card alone), each first held to
    # the plain version on the card, the planned one's numbers its layout's
    # (phase 2 has held every layout to it)
    chk = check_p2("k=1 at phase 5", X, y, lam, 1)
    err, viol, plain = chk["gap"], chk["viol"], chk["plain"]
    ms, card = (time_states_ms(lambda _: pegasos_scan(X, y, lam, 1), none, dev, c)
                for c in (False, True))
    flops = 2.0 * n * d + 2.0 * viol * d + 5.0 * n * d
    nbytes = 4.0 * (n * d + n + d)
    note = layout_note(pegasos_plan(d, 1))
    nk = n // 20 * 20
    Xk, yk = X[:nk], y[:nk]
    layouts = pegasos_layouts(d, 20)
    pair = {name: next(p for p in layouts if p["layout"] == name) for name in ("blocks", "staged")}
    chk20 = {name: check_p2(f"k=20 at phase 5 ({name})", Xk, yk, lam, 20, [p])
             for name, p in pair.items()}
    gaps = {name: c["gap"] for name, c in chk20.items()}
    viol20, plain20 = chk20["blocks"]["viol"], chk20["blocks"]["plain"]
    turns = {}
    for name, p in pair.items():
        launch = ((lambda w, p=p: _launch(p, Xk, yk, lam, 20, w, None))
                  if dev.type == "cuda" else (lambda _: pegasos_scan(Xk, yk, lam, 20)))
        turns[name] = [time_states_ms(launch, [torch.zeros(d, device=dev) for _ in range(reps)],
                                      dev, c) for c in (False, True)]
    (bl_ms, bl_card), (st_ms, st_card) = turns["blocks"], turns["staged"]
    plan20 = pegasos_plan(d, 20)
    name20 = "blocks" if plan20["layout"] == "blocks" else "staged"
    e20, (ms20, card20), note20 = gaps[name20], turns[name20], layout_note(plan20)
    flops20 = 2.0 * nk * d + 2.0 * viol20 * d + 5.0 * (nk // 20) * d
    nbytes20 = 4.0 * (nk * d + nk + d)
    src = {"walk": "src/repro_torch/kernels/csrc/streamsvm_single.cu"}.get(
        pegasos_plan(d, 1)["layout"], "src/repro_torch/kernels/csrc/baselines.cu")
    out.append(dict(row("pegasos_scan", src, "src/repro/baselines/pegasos.py:28",
                        res["launches"]["P2"], err, ms, plain, flops, nbytes, None,
                        f"mnist89 in phase 11's first stream order: N={n} D={d} k=1 ({note}), "
                        f"lam {lam:.4g}, {viol} violations; k=20 ({note20}): ms {ms20:.4f}, "
                        f"device_ms {card20:.4f}, plain {plain20:.1f}, {viol20} violations, w "
                        f"max|err| {e20:.3e}; the step form (staged) at k=20: ms {st_ms:.4f}, "
                        f"device_ms {st_card:.4f}; launches: k = 1 and 20 over every dataset "
                        "and stream order of phase 11a"),
                    device_ms=card, ms_k20=ms20, device_ms_k20=card20, plain_ms_k20=plain20,
                    step_form_ms_k20=st_ms, step_form_device_ms_k20=st_card))
    out.append(dict(row("pegasos_scan[blocks]", "src/repro_torch/kernels/csrc/baselines.cu",
                        "src/repro/baselines/pegasos.py:28", res["launches"]["P2 blocks"],
                        gaps["blocks"], bl_ms, plain20, flops20, nbytes20, None,
                        f"P2's walk over blocks at k=20 on mnist89 ({layout_note(pair['blocks'])}"
                        f"): N={nk} D={d}, {viol20} violations; in turns with the step form "
                        f"(staged: ms {st_ms:.4f}, device_ms {st_card:.4f}); launches: the "
                        "k = 20 fits of phase 11a that pegasos_plan sends to it"),
                    device_ms=bl_card))
    print(f"  P1 at mnist89: {ms1:.4f} ms by events, {dev1:.4f} on the card alone, plain "
          f"{plain1:.1f} ms, bound {out[0]['bound_ms']:.4f} ms; P2 k=1 {ms:.4f} / {card:.4f} ms, "
          f"plain {plain:.1f}; k=20 ({note20}) {ms20:.4f} / {card20:.4f} ms, plain "
          f"{plain20:.1f}; walk over blocks {bl_ms:.4f} / {bl_card:.4f}, step form "
          f"{st_ms:.4f} / {st_card:.4f} in turns; bound {out[1]['bound_ms']:.4f} ms "
          f"({out[1]['bound_by']}), {out[2]['bound_ms']:.4f} at k=20")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=60_000)
    ap.add_argument("--n-test", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=784)
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--check-n", type=int, default=2048)
    ap.add_argument("--check-b", type=int, default=64)
    ap.add_argument("--check-q", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fig3-runs", type=int, default=20, help="permutations per L (Fig 3)")
    ap.add_argument("--fig3-n-train", type=int, default=11_800)
    ap.add_argument("--fig3-n-test", type=int, default=1_983)
    ap.add_argument("--qp-iters", type=int, default=128, help="BC steps per qp flush")
    ap.add_argument("--coreset", type=int, default=64, help="S of the kernelized bank (6b)")
    ap.add_argument("--kb-check-tiles", type=int, default=8,
                    help="tiles of phase 6b's pass held against the plain path")
    ap.add_argument("--kb-evict-coreset", type=int, default=16,
                    help="a smaller S for the phase-2 check, small enough to evict")
    ap.add_argument("--ring-classes", type=int, default=512, help="phase 7b: blob classes")
    ap.add_argument("--ring-d", type=int, default=4096, help="phase 7b: D")
    ap.add_argument("--ring-n-train", type=int, default=60_000)
    ap.add_argument("--ring-n-test", type=int, default=10_000)
    ap.add_argument("--ring-check-n", type=int, default=8192,
                    help="phase 7b: rows of the ring-against-B1 checks at J = 1..4")
    ap.add_argument("--ring-plain-n", type=int, default=512,
                    help="phase 7b: rows of the ring-against-plain check")
    ap.add_argument("--live-chunk", type=int, default=4096, help="phase 10: rows a chunk")
    ap.add_argument("--live-kb-rows", type=int, default=30_720,
                    help="phase 10b: the kernel loop's rows (the first of 10a's stream)")
    ap.add_argument("--live-kb-chunk", type=int, default=7680, help="phase 10b: rows a chunk")
    ap.add_argument("--table1-runs", type=int, default=5, help="phase 11a: stream orders")
    ap.add_argument("--table1-datasets", default="all",
                    help="phase 11a: comma-separated names of PAPER_TABLE1 (default: all 8)")
    ap.add_argument("--table1-checks", type=int, default=1,
                    help="phase 11a: the first stream orders whose P1, P2, B4 and B3 fits are "
                         "held against their plain versions")
    ap.add_argument("--lasvm-cap", type=int, default=8000, help="phase 11a: LASVM's rows")
    ap.add_argument("--cvm-passes", type=int, default=32, help="phase 11b: CVM's most passes")
    ap.add_argument("--cvm-n-train", type=int, default=11_800,
                    help="phase 11b: mnist89's first rows for Fig 2")
    ap.add_argument("--zoo-smoke", action="store_true",
                    help="phase 12: the reduced (smoke) configs instead of the published widths")
    ap.add_argument("--zoo-batch", type=int, default=8, help="phase 12a: prompts a batch")
    ap.add_argument("--zoo-prompt", type=int, default=512, help="phase 12a: prompt tokens")
    ap.add_argument("--zoo-gen", type=int, default=64, help="phase 12a: generated tokens")
    ap.add_argument("--zoo-requests", type=int, default=16, help="phase 12b: requests")
    ap.add_argument("--zoo-slots", type=int, default=8, help="phase 12b: decode slots")
    ap.add_argument("--zoo-req-prompt", default=(16, 128),
                    type=lambda s: tuple(int(v) for v in s.split(",")),
                    help="phase 12b: the shortest and longest prompt, e.g. 16,128")
    ap.add_argument("--zoo-docs", type=int, default=1280,
                    help="phases 12c, 13c: documents (4/5 streamed for training, 1/5 held out)")
    ap.add_argument("--moe-batch", type=int, default=8, help="phase 12d: prompts a batch")
    ap.add_argument("--moe-prompt", type=int, default=512, help="phase 12d: prompt tokens")
    ap.add_argument("--moe-gen", type=int, default=32, help="phase 12d: generated tokens")
    ap.add_argument("--hybrid-batch", type=int, default=8, help="phase 12e: prompts a batch")
    ap.add_argument("--hybrid-prompt", type=int, default=512, help="phase 12e: prompt tokens")
    ap.add_argument("--hybrid-gen", type=int, default=128, help="phase 12e: generated tokens")
    ap.add_argument("--long-len", type=int, default=524_288,
                    help="phase 12f: KV positions (shapes.py's long_500k)")
    ap.add_argument("--encdec-batch", type=int, default=8, help="phase 12g: prompts a batch")
    ap.add_argument("--encdec-prompt", type=int, default=64, help="phase 12g: prompt tokens")
    ap.add_argument("--encdec-gen", type=int, default=64, help="phase 12g: generated tokens")
    ap.add_argument("--launch-batch", type=int, default=8, help="phase 13d: sequences a step")
    ap.add_argument("--launch-seq", default=(512, 128),
                    type=lambda s: tuple(int(v) for v in s.split(",")),
                    help="phase 13d: Zamba2's and Whisper's sequence length, e.g. 512,128")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; nothing was run")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device(args.device)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    print("[1] device")
    phase_device(dev)
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    kb = kb_stream(args)
    phase_kernels(dev, args, rng)
    kbc = check_kernel_bank(dev, args, rng, kb)
    main_out = phase_main_path(dev, args)
    algos = phase_algorithms(dev, args, main_out)
    phase_rings(dev, args)
    kbres = phase_kernel_bank(dev, args, kb, main_out)
    ring = phase_ring(dev, args, main_out, algos)
    m1 = phase_multiball(dev, args)
    phase_sharded(dev, args, main_out)
    phase_live(dev, args, smi)
    baselines = phase_baselines(dev, args)
    zoo = phase_zoo(dev, args)
    train = phase_train(dev, args, zoo)
    print("[5] kernel times at the main path's shapes")
    kernels = (phase_times(dev, args, main_out, algos, kb, kbc, kbres, ring) + [m1]
               + baseline_rows(dev, args, baselines, kernel_row))
    for row in kernels:  # phase 11's launches of the earlier kernels it drives
        key, phase = {"streamsvm_scan": ("B1", "3"), "streamsvm_scan_lookahead[fig3]": ("B3", "4a"),
                      "streamsvm_single": ("B4", "4a")}.get(row["name"], (None, None))
        if key is not None:
            row["launches_by_phase"] = {phase: row["launches"], "11": baselines["launches"][key]}
            row["launches"] += baselines["launches"][key]
            if key == "B4":  # phases 12c and 13c stream a backbone's features through B4
                for ph, feats in (("12", zoo["features"]), ("13", train["features"])):
                    row["launches_by_phase"][ph] = feats["launches"]
                    row["launches"] += feats["launches"]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    if smi is not None:
        print(smi)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(json.dumps({"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
