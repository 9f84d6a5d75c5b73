"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Drives the port (`src/repro_torch`) only; imports nothing of JAX or of the
reference package. Phases, each of which must pass or the script exits
non-zero before its last line:

  1. environment: card name and power limit (nvidia-smi), torch and CUDA
     versions, and the time to build every kernel from
     `src/repro_torch/csrc` (one nvcc per source, all in parallel);
  2. kernels: each CUDA kernel held against its plain PyTorch version on
     the card, at random shapes (r in 1..5 and 33, r >= 5 the runtime-r
     instance, r = 33 with zero-width segments; B in 1 and 4; empty rows,
     empty slots and full-word leftover slots in the packed K1/K2 tables;
     any shift and mask in K1's general form; K2 with direct words, entries
     past the source included, at r = 1, 2, 5) and at each session's shapes
     (B = 1 and B = 4, where K1's general form on the unpacked tables must
     write the packed K1's buffers). K1/K2/K3-min must be bitwise equal,
     K3-sum within rtol 1e-5 of the scatter plain version (which sums with
     atomics; atol 0 at the session shapes, whose sums do not cancel); K3
     (sum and min) and K5, the CSR-streaming body, bitwise the sequential
     plain version at B = 1, 2, 4, 5 on random CSR with empty rows, ragged
     tiles and a long tile, and at the session shapes;
  3. slice: the er-76k session (ER, n = 80,000 padded for K = 4, r = 2,
     average degree 8, seed 76) through `engine.compile(...).run(...)`:
     delivered words of one exchange bitwise equal to the NumPy executor,
     pagerank (10 iterations) within rtol 1e-5 of the NumPy oracle, sssp(0)
     and multi_sssp (B = 4) bitwise, exact shuffle bits, and every kernel
     launched on this main path (launch counts reset just before it);
  4. scale: the same at n ~ 1e6 (about 8M CSR entries), pagerank only,
     with host compile/partition times, per-phase device times, and the
     launch counts of its own run (reset just before it);
  5. spmv: the engine's backend="spmv" route (K5) on the er-76k graph and
     plan (pagerank in modes single / uncoded / coded / coded-fast within
     rtol 1e-5 with exact bits, degree_count bitwise, personalized
     pagerank at B = 4 through run_batch) and on the scale graph and plan
     (pagerank coded, steady time and device idle share); then the dense
     API, `ops.pagerank_step` (K4) for 10 steps on the dense adjacency of
     an ER graph with n = 16,384, p = 0.01, seed 5, in float32 and in
     float16, within rtol 1e-5 of the oracle. Each path's launch counts
     are reset just before it and read just after;
  6. modes: the reference's default engine, backend="numpy" (the plan
     executors on the card: the coded route's encode and decode as the
     plan kernels `xor_encode_plan` / `xor_decode_plan`, the packed K1
     and K2 on the plan's tables composed for one server and one
     receiver, K3 reducing), on the er-76k graph and plan: pagerank,
     sssp(0), connected_components, degree, multi_sssp (B = 4) and
     personalized pagerank (B = 4) in modes single / uncoded / coded /
     coded-fast for 10 iterations (the two pageranks within rtol 1e-5 of
     the sparse NumPy oracle, the others bitwise,
     exact bits; delivered words of each plan mode bitwise the NumPy
     executor; both plan kernels and K3 launched on that run, counts reset
     just before it); both plan kernels bitwise their plain versions at
     the er-76k and scale shapes, B = 1 and 4; the three XOR routes
     ("numpy", "xor-kernel", "xor-ref") bitwise the NumPy executor at the
     er-76k and scale shapes, K1's dense form launched on the
     "xor-kernel" route's run; at scale, pagerank in uncoded / coded /
     coded-fast for 10 iterations with steady ms/iter, device busy,
     per-phase spans and peak memory beside the fused route's; the dense
     path on the dense phase's graph (padded to n = 16,392 for K = 4,
     r = 2): pagerank and sssp in the four modes for 3 iterations against
     the dense NumPy oracle (both plan kernels launched on the coded
     runs), with the peak device memory, then both plan kernels bitwise
     their plain versions on pagerank's (broadcast) and sssp's
     (transposed) [n, n] Map output in the layout the Map hands over;
     at scale also each mode's session build (the coded session
     composes its coded tables there) and first iteration; mode coded-ref
     on ER n = 2,000 (padded to 2,004), p = 0.02,
     seed 5, for 2 iterations: its delivered dict equal to mode coded's
     on the dense path, sssp bitwise the dense coded state;
  7. elastic (on the scale and er-76k sessions): at scale,
     backend="numpy", mode coded, `fail((1,))` and `fail((0, 1))` (|failed|
     = r: re-Maps, pairs demoted to full-word leftover columns) with the
     host repair time (against a fresh `compile_plan_csr` on the degraded
     allocation for (1,), whose arrays must equal the repair's but
     `col_sender`), the session build, the first post-failure iteration,
     steady time and device busy beside the healthy session's; pagerank
     and sssp for 10 iterations bitwise the healthy session's with the
     host plan's bits plus the hand-over, the plan kernels bitwise their
     plain versions on the repaired tables (records at B = 1 and 4) and
     launched on that run (counts reset just before it); `update` by a
     seeded delta of 5,000 inserted and 5,000 deleted edges on backend
     "numpy" and "fused": host `apply_delta` against a fresh compile, the
     fused rebind against a fresh fused session, the plan array-identical
     to the fresh one and the rebound tables equal to a fresh fused
     session's, pagerank and sssp bitwise the fresh session's (pagerank
     within rtol 1e-5 of the oracle), K1 / K2 / K3 and the plan kernels
     held against their plain versions on the new tables, each route's
     launches; at er-76k a `FaultSchedule` (server 1 crashes at iteration 3
     and recovers at 7, of 10) with the bits and `FaultLog` equal to the
     host's accounting and the states bitwise the uninterrupted run's;
     checkpoints every 2 iterations (er-76k padded to n = 80,136), restored
     at epoch 6 and resumed bitwise at K = 4 and K' = 8, with the save cost
     per iteration; `GraphService` with 64 sssp queries through
     max_batch = 4 and one crash, each column bitwise the standalone run's,
     queries/s, latency percentiles and mean batch;
  8. dist: the fused route with `group=` on a one-rank NCCL process group
     (a FileStore under build/; NCCL takes one card per rank) on the
     er-76k and scale sessions: one exchange's delivered words at B = 1
     and 4, pagerank and sssp(0) for 10 iterations bitwise the virtual
     route's on the same card with its bits, K1 / K2 / K3 launched on the
     group route's run (counts reset just before it), both routes' steady
     time and device busy, and the NCCL collectives' device time per
     iteration; the group is destroyed at the end;
  9. table2: karate and er-76k through the port's registry into a fresh
     cache under build/ (the er-76k edge list synthesized, its sha256 the
     reference's `ER76K_SHA256`, read back with the largest-CC step),
     `run_table2` at K = 6, r = 1, 2, 3 with every record but its timings
     equal to the reference's (`TABLE2_EXPECTED`), the markdown printed;
     coded pagerank (rtol 1e-5) and sssp(0) (bitwise) for 10 iterations
     against the host oracle on the registry-loaded er-76k (n = 79,979,
     padded to 79,980 by `graphs.allocate`, K = 6, r = 2) on backend
     "numpy" and "fused", exact bits, each route's kernels launched on its
     run, steady time and device busy; then `examples/port_quickstart.py`
     and `examples/port_coded_pagerank.py` on the card in parallel
     subprocesses (300 s timeout each), which must exit 0;
  10. topology: the two-level (racks x servers) coded Shuffle through
     `engine.compile(..., "coded", path="sparse", topology=Topology(R, S))`
     on backend="fused" (K1 over the R rack buffers, K2 with its direct
     words, "xor_decode_direct") and "numpy" (the plan kernels on the
     rack-level plan). er-76k at K = 8, r = 2 (n = 80,024, 640,648
     entries) on Topology(4, 2), (2, 4), (1, 8) and Topology.flat(8): the
     host plans' per-level bits exactly the reference's (`TOPO_EXPECTED`),
     one exchange's delivered words bitwise the flat plan's, pagerank,
     sssp(0) and multi_sssp (B = 4) for 10 iterations against the flat
     fused session (sssp and multi_sssp bitwise, pagerank within rtol
     1e-5), exact bits, the kernels of both routes launched on that path
     (counts reset just before it), Topology.flat(8) the flat session
     with its tables; K2's direct form bitwise its plain version at the
     4 x 2 and 2 x 4 shapes, B = 1 and 4. Then ER n ~ 1e6 (seed 7) at
     K = 8 on Topology(4, 2) (both backends) and flat (backend "numpy";
     the flat fused route is the scale phase's, at K = 4), pagerank for 10
     iterations against the oracle: host compile and session build times,
     steady ms per iteration, device busy and idle share, peak memory;
  11. serve: K6 `ssd_chunk` (rtol 1e-4, atol 1e-4 * max|plain|) and K7
     `ssd_state_scan` (bitwise) against their plain versions at the
     `tests/test_kernels.py` ssd shapes, K6 at ragged shapes in float32
     and bf16, both at the serve shape (G = 128 groups, 32 chunks of 64,
     P = 64, N = 128; K6 with the serve path's bf16 x, B and C shared by
     the 32 heads of a sequence, and with float32 inputs) and, for K7,
     256 chunks;
     `ops.ssd` against the sequential oracle at 5e-4. Then mamba2-370m at
     full width and depth (48 layers, d_model 1,024, vocab 50,280), bf16
     weights from a seeded generator: `decode.prefill` of B = 4 prompts of
     2,048 tokens through K6 and K7 (48 launches each, counted on that
     run); each layer's kernel block against its plain block on the same
     input (2^-6 * max|y|, final state 1e-3 * max|h|); the last logits
     finite and within twice bf16's own distance from float32 of the
     plain chunked prefill's; `serve.generate` (B = 4, 32-token prompts,
     32 new tokens, in the vocabulary). In float32, each layer's chunked
     block against 128 decode steps of it, and a 4-layer prefill of 128
     tokens against the decode loop, within 1e-3 of their max.

Every device busy time and idle share comes from a complete profiler
window (`profiled_window`): one whose records of the port's kernels differ
from what the launch counters counted in it, kernel by kernel, is taken
again, up to three times, and is then reported as not measured with
`profile_incomplete` set.

The kernel phase also holds K4 (float32 rtol 1e-4 / atol 1e-5, float16
2e-3) and K5 (rtol 1e-5, atol 1e-6 for standard-normal values, bitwise
repeatable, bitwise the sequential plain version for every `bm`) against
their plain versions. The serve phase also holds K6 at chunks of 128 to
400 tokens (P = 64, N = 128; staged in parts where a chunk does not fit a
block: float32 from Q = 180, bf16 at Q = 400) and `ops.ssd` at chunk 256,
and times K6 at Q = 128 and 256. Prints the `kernels` JSON line
(K1-K3 and K5 timed at the er-76k shapes with launches from their er-76k
paths, K2's direct form at the er-76k 4 x 2 session's shapes with
launches from the topology path and at n ~ 1e6 in `kernels_scale`, the plan kernels on the er-76k plan's tables with launches from
the modes phase's er-76k run, K1's dense form at the slot words of the
er-76k coded route with launches from the "xor-kernel" route's run, K3
and K5 also at B = 4 and with their L2 sector traffic in the
full records, K4 at 16,384^2 float32 with launches from the dense path; K1 and K2
are the packed kernels the session runs, their bounds counted on the
packed tables, with the count on the unpacked layout and K1's general form
timed on it kept in the full records; K6 and K7 at the serve shape with
launches from the bf16 prefill, K6 on the serve path's inputs, its bound
counting bf16 reads and the bf16 tensor-core rate, with its float32-input
record logged and kept in the full records), the card's name and power
limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SUM_RTOL = 1e-5
SLICE_N = 80_000          # er-76k: the registry's soc-Epinions1 stand-in
SCALE_N = 1_000_000       # about 8M CSR entries at average degree 8
DENSE_N = 16_384          # dense pagerank_step: a 1.07 GB float32 adjacency
SERVE_ARCH = "mamba2-370m"
SERVE_B, SERVE_L = 4, 2_048              # the prefill: 8,192 tokens
GEN_B, GEN_PROMPT, GEN_NEW = 4, 32, 32   # the lockstep decode
CONSIST_L = 128                          # float32 prefill vs decode loop
CONSIST_DEPTH = 4                        # its end-to-end depth
SSD_RTOL = 1e-4           # K6 vs plain: rtol, and atol as a share of max|plain|
BF16_BLOCK_TOL = 2.0 ** -6  # a bf16 block, kernel vs plain: share of max|y|
STATE_TOL = 1e-3          # its float32 final state: share of max|h|
CONSIST_TOL = 1e-3        # float32 decode steps vs the chunked prefill
SPMV_MODES = ("single", "uncoded", "coded", "coded-fast")
TOPO_K = 8                # the two-level cells: K = 8, r = 2
TOPO_SHAPES = ((4, 2), (2, 4), (1, 8))
# What the reference's host plan gives er-76k at K = 8, r = 2 per topology
# (rack redundancy, rack deliveries, rack leftovers, inter-rack bits,
# intra-rack bits, the flat schedule's inter-rack bits): exact counts.
TOPO_EXPECTED = {
    (4, 2): (2, 342_674, 68_640, 6_603_824, 17_528_704, 7_742_624),
    (2, 4): (1, 136_994, 0, 4_383_808, 13_163_232, 6_598_736),
    (1, 8): (1, 0, 0, 0, 15_362_752, 0),
}
TABLE2_K, TABLE2_R = 6, (1, 2, 3)
# The reference's Table II records (`repro.experiments.run_table2`) for
# karate and er-76k at K = 6, r = 1, 2, 3, every field but the timings, in
# this order: exact values (floats are the reference's, bit for bit).
TABLE2_FIELDS = ("n", "n_padded", "edges", "density", "uncoded", "coded",
                 "coded_leftover_unicast", "gain", "uncoded_er",
                 "coded_er_asymptotic", "coded_er_finite", "lower_bound_er",
                 "paper_shuffle_speedup", "paper_overall_speedup")
TABLE2_EXPECTED = {
    ("karate", 1): (34, 36, 78, 0.12037037037037036, 0.09567901234567901,
                    0.09567901234567901, 0.0, 1.0, 0.10030864197530864,
                    0.10030864197530864, 0.10030864197530864,
                    0.10030864197530864, None, None),
    ("karate", 2): (34, 60, 78, 0.043333333333333335, 0.029722222222222223,
                    0.021805555555555557, 0.0, 1.3630573248407643,
                    0.028888888888888895, 0.014444444444444447,
                    0.03231272840479022, 0.014444444444444447, None, None),
    ("karate", 3): (34, 60, 78, 0.043333333333333335, 0.021388888888888888,
                    0.012725694444444444, 0.0, 1.6807639836289223,
                    0.021666666666666667, 0.007222222222222223,
                    0.020209906241079937, 0.007222222222222223, None, None),
    ("er-76k", 1): (79979, 79980, 320324, 0.00010015131940024266,
                    8.338481219454651e-05, 8.338481219454651e-05, 0.0, 1.0,
                    8.345943283353555e-05, 8.345943283353555e-05,
                    8.345943283353555e-05, 8.345943283353555e-05, None, None),
    ("er-76k", 2): (79979, 79980, 320324, 0.00010015131940024266,
                    6.677557111208285e-05, 3.358272676446181e-05, 0.0,
                    1.9883903883214942, 6.676754626682845e-05,
                    3.3383773133414225e-05, 3.4042594863626345e-05,
                    3.3383773133414225e-05, None, None),
    ("er-76k", 3): (79979, 79980, 320324, 0.00010015131940024266,
                    5.0139754243387055e-05, 1.741636822840369e-05, 0.0,
                    2.8788868945487756, 5.007565970012133e-05,
                    1.669188656670711e-05, 1.7170755633022682e-05,
                    1.669188656670711e-05, None, None),
}
# sha256 of the er-76k edge list the reference's registry synthesizes.
ER76K_SHA256 = "27885762e4d17be74002eeccaaba4dea08234c772833e2f5ee21e5bcddfb520f"
REPLACES = {
    "xor_encode": "src/repro/kernels/xor_code/xor_code.py:26",
    "xor_encode_dense": "src/repro/kernels/xor_code/xor_code.py:26",
    "xor_encode_plan": "src/repro/kernels/xor_code/xor_code.py:26",
    "xor_decode": "src/repro/core/fused_shuffle.py:640",
    "xor_decode_direct": "src/repro/core/fused_shuffle.py:700",
    "xor_decode_plan": "src/repro/core/shuffle_plan.py:295",
    "segment_reduce": "src/repro/core/engine.py:166",
    "spmv_dense": "src/repro/kernels/spmv/spmv.py:29",
    "spmv_csr": "src/repro/kernels/spmv/spmv.py:29",
    "ssd_chunk": "src/repro/kernels/ssd_scan/ssd_scan.py:54",
    "ssd_state_scan": "src/repro/kernels/ssd_scan/ops.py:40",
}
SOURCES = {
    "xor_encode": "src/repro_torch/csrc/xor_code.cu",
    "xor_encode_dense": "src/repro_torch/csrc/xor_code.cu",
    "xor_encode_plan": "src/repro_torch/csrc/xor_code.cu",
    "xor_decode": "src/repro_torch/csrc/xor_code.cu",
    "xor_decode_direct": "src/repro_torch/csrc/xor_code.cu",
    "xor_decode_plan": "src/repro_torch/csrc/xor_code.cu",
    "segment_reduce": "src/repro_torch/csrc/segment_reduce.cu",
    "spmv_dense": "src/repro_torch/csrc/spmv.cu",
    "spmv_csr": "src/repro_torch/csrc/spmv.cu",
    "ssd_chunk": "src/repro_torch/csrc/ssd_scan.cu",
    "ssd_state_scan": "src/repro_torch/csrc/ssd_scan.cu",
}


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(torch, nbytes: float, flops: float,
          rate: str = "f32") -> tuple[float, str]:
    """Least time on the card (ms) for `nbytes` moved over its HBM rate and
    `flops` operations at its `rate` ("f32" outside the tensor cores,
    "bf16" on them), and which of the two bounds it. The figures are
    `launch/roofline.card_of`'s (NVIDIA's data sheet); another card than
    those it knows raises."""
    from repro_torch.launch.roofline import card_of

    fig = card_of("cuda")
    t_bytes = nbytes / fig.hbm_bw
    t_ops = flops / (fig.f32_flops if rate == "f32" else fig.bf16_flops)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms_graph(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Median device milliseconds of one kernel launch: `calls` launches
    captured in a CUDA graph, each replay timed with CUDA events, so the
    host's launch overhead is not counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def word_err(torch, a, b) -> float:
    """Max |a - b| of two int32 word tensors read as uint32 (0 = bitwise)."""
    m = 0xFFFFFFFF
    d = (a.to(torch.int64) & m) - (b.to(torch.int64) & m)
    return float(d.abs().max()) if d.numel() else 0.0


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def u32(rng, shape):
    """Random uint32 words as an int32 array."""
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32).view(np.int32)


def random_general(rng, K, W, Lmax, nnz, r, B):
    """Random tables of K1's general form in the ranges it accepts (the
    sentinels Lmax and nnz included), any shift and mask words."""
    return dict(
        src=u32(rng, (nnz, B) if B > 1 else (nnz,)),
        loc_e=rng.integers(0, nnz + 1, size=(K, Lmax)).astype(np.int32),
        enc_l=rng.integers(0, Lmax + 1, size=(K, W, r)).astype(np.int32),
        enc_shift=rng.integers(0, 32, size=(K, W, r)).astype(np.int32),
        enc_mask=u32(rng, (K, W, r)))


def random_packed(rng, K, W, nnz, Dmax, r, B):
    """Random packed K1/K2 tables: entries with the zero sentinel nnz,
    codes over the whole book (segments, the full word of a leftover,
    empty slots), positions over every buffer column (the zero column W
    included), deliveries per receiver from 0 to Dmax."""
    from repro_torch.core.fused_shuffle import code_book

    counts = rng.integers(0, Dmax + 1, size=K)
    code = lambda shape: rng.integers(0, r + 2, size=shape).astype(np.uint8)  # noqa: E731
    return dict(
        src=u32(rng, (nnz, B) if B > 1 else (nnz,)),
        enc_e=rng.integers(0, nnz + 1, size=(K, W, r)).astype(np.int32),
        enc_code=code((K, W, r)),
        dec_pos=rng.integers(0, K * (W + 1), size=(K, Dmax, r)).astype(np.int32),
        dec_code=code((K, Dmax, r)),
        strip_e=rng.integers(0, nnz + 1, size=(K, Dmax, r, r - 1)).astype(np.int32),
        strip_code=code((K, Dmax, r, r - 1)),
        book=code_book(r).view(np.int32),
        ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))


ENC_PACKED = ("src", "enc_e", "enc_code", "book")
DEC_PACKED = ("dec_pos", "dec_code", "strip_e", "strip_code", "book", "ptr")
ENC_GENERAL = ("src", "loc_e", "enc_l", "enc_shift", "enc_mask")


def run_packed(xc, t, ref: bool, total=None):
    """Packed K1 then K2 (or their plain versions) on tables `t`."""
    if ref:
        buf = xc.ref.xor_encode_packed(*(t[k] for k in ENC_PACKED))
        return buf, xc.ref.xor_decode_packed(t["src"], buf,
                                             *(t[k] for k in DEC_PACKED))
    buf = xc.xor_encode_packed(*(t[k] for k in ENC_PACKED))
    return buf, xc.xor_decode_packed(t["src"], buf, *(t[k] for k in DEC_PACKED),
                                     total=total)


def random_reduce(rng, n, nnz, M, B):
    deg = rng.integers(0, 2 * nnz // max(n, 1) + 1, size=n)
    deg[rng.random(n) < 0.2] = 0                     # empty rows
    indptr = np.concatenate([[0], np.cumsum(deg)])
    nnz = int(indptr[-1])
    gather = rng.permutation(nnz + M)[:nnz]
    shape = (nnz, B) if B > 1 else (nnz,)
    ev = rng.standard_normal(shape).astype(np.float32)
    dw = rng.standard_normal((M, B) if B > 1 else (M,)).astype(np.float32)
    words = dw.view(np.uint32).byteswap().view(np.int32)
    return ev, words, gather.astype(np.int32), indptr.astype(np.int32)


def check_reduce(torch, got, want, op: str, what: str, atol: float) -> float:
    """Min bitwise; sum within rtol 1e-5 plus `atol` (0 where every sum is
    of values of one sign, so the relative bound alone holds)."""
    if op == "min":
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{what}: segment_reduce min not bitwise")
        return 0.0
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=atol)
    return float((got - want).abs().max()) if got.numel() else 0.0


def kernel_phase(torch, dev) -> None:
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.kernels.segment_reduce import ref as sr_ref
    from repro_torch.kernels.xor_code import ops as xops
    from repro_torch.kernels.xor_code import ref as xref
    from repro_torch.kernels.xor_code import xor_code as xc

    rng = np.random.default_rng(11)
    cases = 0
    for r in (1, 2, 3, 4, 5, 33):
        for B in (1, 4):
            up = lambda d: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                            for k, v in d.items()}
            t = up(random_packed(rng, 3, 57, 300, 33, r, B))
            buf, out = run_packed(xc, t, ref=False)
            buf0, out0 = run_packed(xc, t, ref=True)
            g = up(random_general(rng, 3, 57, 41, 300, r, B))
            gen = xc.xor_encode_gather(*(g[k] for k in ENC_GENERAL))
            gen0 = xref.xor_encode_gather(*(g[k] for k in ENC_GENERAL))
            torch.cuda.synchronize()
            if not (torch.equal(buf, buf0) and torch.equal(out, out0)):
                raise AssertionError(f"packed K1/K2 not bitwise at r={r} B={B}")
            if not torch.equal(gen, gen0):
                raise AssertionError(f"general K1 not bitwise at r={r} B={B}")
            rows = torch.from_numpy(u32(rng, (r, 77, B))).to(dev)
            valid = torch.from_numpy(rng.random((r, 77)) < 0.6).to(dev)
            if not torch.equal(xops.xor_encode(rows, valid),
                               xref.xor_encode(rows, valid)):
                raise AssertionError(f"dense xor_encode not bitwise at r={r}")
            cases += 1
    for r in (1, 2, 5):
        for B in (1, 4):
            t = up(random_packed(rng, 3, 57, 300, 33, r, B))
            direct = torch.from_numpy(rng.integers(
                0, 303, size=(3, 33)).astype(np.int32)).to(dev)
            buf, flat = run_packed(xc, t, ref=False)
            dec = (t["src"], buf) + tuple(t[k] for k in DEC_PACKED)
            got = xc.xor_decode_packed(*dec, direct_e=direct)
            want = xc.ref.xor_decode_packed(*dec, direct_e=direct)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got | flat, got)):
                raise AssertionError(f"K2 with direct words not bitwise its "
                                     f"plain version at r={r} B={B}")
            cases += 1
    for op in ("sum", "min"):
        for B in (1, 4):
            ev, words, gather, indptr = random_reduce(rng, 500, 4000, 900, B)
            args = [torch.from_numpy(a).to(dev)
                    for a in (ev, words, gather, indptr)]
            ident = 0.0 if op == "sum" else float("inf")
            # Standard-normal values: a row's sum can cancel to near 0.
            check_reduce(torch, sr.segment_reduce(*args, op, ident),
                         sr_ref.segment_reduce(*args, op, ident), op,
                         f"random {op} B={B}", atol=1e-6)
    cases_spmv = spmv_kernel_checks(torch, dev, rng)
    cases_stream = stream_kernel_checks(torch, dev, rng)
    log(f"kernel phase: {cases} random exchange cases (packed K1/K2, general "
        f"and dense K1; r = 33 the runtime-r instance with zero-width "
        f"segments; K2 with direct words at r = 1, 2, 5), the K3 sum/min "
        f"cases, {cases_spmv} K4/K5 cases and "
        f"{cases_stream} K3/K5 cases bitwise the sequential plain version "
        f"(long tiles included) agree with the plain versions")


def stream_case(rng, n, B, long_row: int = 5000):
    """A CSR of `n` rows for K3 and K5: 30% empty rows, degrees 0..40
    (ragged tiles), one row of `long_row` entries (a long tile, in parts of
    TILE_ENTRIES), K3's gather and standard-normal values (sums cancel, so
    only the sequential order is bitwise), K5's indices and values."""
    deg = rng.integers(0, 41, size=n)
    deg[rng.random(n) < 0.3] = 0
    deg[n // 3] = long_row
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz, M = int(indptr[-1]), 3000
    shape = lambda m: (m, B) if B > 1 else (m,)  # noqa: E731
    dv = rng.standard_normal(shape(M)).astype(np.float32)
    return dict(
        indptr=indptr, gather=rng.permutation(nnz + M)[:nnz].astype(np.int32),
        ev=rng.standard_normal(shape(nnz)).astype(np.float32),
        words=dv.view(np.uint32).byteswap().view(np.int32),
        indices=rng.integers(0, n, size=nnz).astype(np.int32),
        c=rng.standard_normal(shape(n)).astype(np.float32))


def bitwise(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def stream_kernel_checks(torch, dev, rng) -> int:
    """K3 (sum, min) and K5, the CSR-streaming body, bitwise against the
    sequential plain version at B = 1, 2, 4, 5 (vector widths 1, 2, 4 and
    column chunks), with empty rows, ragged tiles and a long tile; K3-min
    also bitwise the scatter plain version; two runs bitwise equal; K5 the
    same bits for every `bm`."""
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.kernels.segment_reduce import ref as sr_ref
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.spmv import spmv as spmv_k

    cases = 0
    for B in (1, 2, 4, 5):
        t = {k: torch.from_numpy(v).to(dev)
             for k, v in stream_case(rng, 7001, B).items()}
        red = (t["ev"], t["words"], t["gather"], t["indptr"])
        for op, ident in (("sum", 0.0), ("min", float("inf"))):
            got = sr.segment_reduce(*red, op, ident)
            again = sr.segment_reduce(*red, op, ident)
            if not (bitwise(torch, got, sr_ref.segment_reduce_seq(*red, op, ident))
                    and bitwise(torch, got, again)):
                raise AssertionError(f"K3 {op} not bitwise the sequential "
                                     f"plain version (or not repeatable) at B={B}")
            if op == "min" and not bitwise(
                    torch, got, sr_ref.segment_reduce(*red, op, ident)):
                raise AssertionError(f"K3 min not bitwise the plain version at B={B}")
        want = spmv_ref.spmv_csr_seq(t["indptr"], t["indices"], t["c"])
        for bm in (1, 8, 128, 256):
            if not bitwise(torch, spmv_k.spmv_csr(t["indptr"], t["indices"],
                                                  t["c"], bm=bm), want):
                raise AssertionError(f"K5 not bitwise the sequential plain "
                                     f"version at B={B} bm={bm}")
        cases += 1
    return cases


def random_csr(rng, n, B):
    """CSR with empty rows and one long row, standard-normal values on a
    2^-10 grid: every partial sum is exact in float32, so the long row's
    sum cannot differ by summation order (on real values the 20,000-entry
    row's order alone moves it by ~1e-4, past rtol 1e-5)."""
    deg = rng.integers(0, 17, size=n)
    deg[rng.random(n) < 0.2] = 0                     # empty rows
    deg[n // 2] = 20_000                             # one long row
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    c = np.round(rng.standard_normal((n, B) if B > 1 else n) * 1024) / 1024
    return indptr, indices, c.astype(np.float32)


def spmv_kernel_checks(torch, dev, rng) -> int:
    """K4 at the reference's test shapes, its block sweep's 512 x 512 and
    ragged shapes, in float32 and float16; K5 on random CSR at B = 1 and
    4 over the row tiles, bitwise repeatable."""
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.spmv import spmv as spmv_k

    f32, f16 = torch.float32, torch.float16
    cases = 0
    for m, n in ((128, 128), (256, 384), (300, 300), (100, 250), (1, 128),
                 (128, 1), (512, 512), (255, 1001), (3, 7)):
        adj_np, x_np = rng.random((m, n)) < 0.2, rng.standard_normal(n)
        for a_dt, x_dt in ((f32, f32), (f16, f16), (f16, f32)):
            adj = torch.from_numpy(adj_np).to(dev, a_dt)
            x = torch.from_numpy(x_np).to(dev, x_dt)
            tol = (dict(rtol=1e-4, atol=1e-5) if a_dt == x_dt == f32
                   else dict(rtol=2e-3, atol=2e-3))
            torch.testing.assert_close(spmv_k.spmv_dense(adj, x),
                                       spmv_ref.spmv(adj, x), **tol)
            cases += 1
    for B in (1, 4):
        for bm in (1, 32, 128, 256):
            args = [torch.from_numpy(a).to(dev)
                    for a in random_csr(rng, 5000, B)]
            got = spmv_k.spmv_csr(*args, bm=bm)
            again = spmv_k.spmv_csr(*args, bm=bm)
            torch.testing.assert_close(got, spmv_ref.spmv_csr(*args),
                                       rtol=SUM_RTOL, atol=1e-6)
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"K5 not repeatable at B={B} bm={bm}")
            if not bitwise(torch, got, spmv_ref.spmv_csr_seq(*args)):
                raise AssertionError(f"K5 not bitwise the sequential plain "
                                     f"version at B={B} bm={bm}")
            cases += 1
    return cases


# ---------------------------------------------------------------------------
# slice / scale phases
# ---------------------------------------------------------------------------


def er_session(n_base: int, seed: int, K: int = 4, r: int = 2):
    from repro_torch import graphs
    from repro_torch.core.allocation import divisible_n, er_allocation

    t0 = time.perf_counter()
    g = graphs.erdos_renyi(n_base, 8.0 / (n_base - 1), seed=seed)
    n = divisible_n(g.n, K, r)
    g = g.padded(n)
    alloc = er_allocation(n, K, r)
    return g, alloc, time.perf_counter() - t0


def general_tables(torch, eng) -> dict:
    """K1's general form's arguments on the session's unpacked tables
    (uploaded here; the session itself holds only the packed ones)."""
    from repro_torch.core.fused_shuffle import _i32

    s = eng.fused.sched
    return {k: _i32(getattr(s, k), eng.device)
            for k in ("loc_e", "enc_l", "enc_shift", "enc_mask")}


def hold_session(torch, eng, ev, what: str, general: dict) -> dict:
    """Run the packed K1 and K2 and K3 (sum and min) on Map output `ev`
    [nnz(, B)] at a session's shapes and hold each against its plain
    version: K1, K2 and K3-min bitwise, K3-sum within rtol 1e-5 with atol
    0 of the scatter plain version (every Map value here is positive, so
    no row sum cancels) and K3 sum and min bitwise the sequential plain
    version; K1's general form on the unpacked tables must write the same
    buffers. Returns each kernel's arguments and its max abs error."""
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.kernels.segment_reduce import ref as sr_ref
    from repro_torch.kernels.xor_code import xor_code as xc

    fx = eng.fused
    t = dict(fx.tables, src=ev.view(torch.int32))
    buf, words = run_packed(xc, t, ref=False, total=fx.M)
    buf0, words0 = run_packed(xc, t, ref=True)
    gen_args = (t["src"],) + tuple(general[k] for k in ENC_GENERAL[1:])
    gen = xc.xor_encode_gather(*gen_args)
    red = {op: (ev, words, eng._gather, eng._indptr, op, ident)
           for op, ident in (("sum", 0.0), ("min", np.inf))}
    acc = {op: sr.segment_reduce(*a, tiles=eng._tiles) for op, a in red.items()}
    acc0 = {op: sr_ref.segment_reduce(*a) for op, a in red.items()}
    seq = {op: sr_ref.segment_reduce_seq(*a) for op, a in red.items()}
    torch.cuda.synchronize()
    if not torch.equal(buf, buf0):
        raise AssertionError(f"K1 xor_encode not bitwise at {what}")
    if not torch.equal(gen, buf):
        raise AssertionError(f"general K1 on the unpacked tables differs "
                             f"from the packed K1 at {what}")
    if not torch.equal(words, words0):
        raise AssertionError(f"K2 xor_decode not bitwise at {what}")
    err3 = check_reduce(torch, acc["sum"], acc0["sum"], "sum", what, atol=0.0)
    check_reduce(torch, acc["min"], acc0["min"], "min", what, atol=0.0)
    for op in red:
        if not bitwise(torch, acc[op], seq[op]):
            raise AssertionError(f"K3 {op} not bitwise the sequential plain "
                                 f"version at {what}")
    return {"tables": t, "general": gen_args, "red": red["sum"],
            "words": words,
            "err": {"xor_encode": word_err(torch, buf, buf0),
                    "xor_decode": word_err(torch, words, words0),
                    "segment_reduce": err3}}


def packed_bytes(eng, B: int = 1) -> tuple[int, int]:
    """Bytes the packed K1 and K2 must move on this session's data: each
    packed table read once (K2: the rows of real deliveries), the book,
    each distinct src word and buffer word a slot with a nonzero mask
    reads (sentinels excluded), each output written once. A two-level
    session's K1 writes its R rack buffers, and its K2 also reads its
    direct_e table and each distinct direct word."""
    fx = eng.fused
    p, nnz, M = fx.packed, fx.nnz, fx.M
    K, W, r = p.enc_e.shape
    live = lambda code: p.book[1][code] != 0  # noqa: E731
    e1 = p.enc_e[(p.enc_e < nnz) & live(p.enc_code)]
    k1 = (p.enc_e.nbytes + p.enc_code.nbytes + p.book.nbytes
          + 4 * B * np.unique(e1).size + 4 * B * K * (W + 1))
    rows = np.arange(p.dec_pos.shape[1])[None, :] < np.diff(eng.plan.ptr)[:, None]
    pos, pc = p.dec_pos[rows], p.dec_code[rows]
    got = pos[live(pc) & (pos % (W + 1) < W)]
    se, sc = p.strip_e[rows], p.strip_code[rows]
    e2 = se[(se < nnz) & live(sc)]
    n = int(rows.sum())
    k2 = (n * r * 5 + n * r * (r - 1) * 5 + 4 * (p.dec_pos.shape[0] + 1)
          + p.book.nbytes + 4 * B * np.unique(got).size
          + 4 * B * np.unique(e2).size + 4 * B * M)
    if p.direct_e is not None:           # K2's direct form: its table and words
        de = p.direct_e[rows]
        k2 += 4 * n + 4 * B * np.unique(de[de < nnz]).size
    return int(k1), int(k2)


def unpacked_bytes(eng, B: int = 1) -> tuple[int, int]:
    """The same count for the unpacked layout (`bound_ms_old_layout`):
    three words per K1 slot and the loc_e hop, four words per K2 segment
    and three per strip slot."""
    fx, s = eng.fused, eng.fused.sched
    K, W, r = s.enc_l.shape
    nnz, M = fx.nnz, fx.M
    lmask = s.enc_l < s.Lmax
    kk = np.broadcast_to(np.arange(K)[:, None, None], s.enc_l.shape)
    e_ref = s.loc_e[kk[lmask], s.enc_l[lmask]]
    e_ref = np.unique(e_ref[e_ref < nnz])
    k1 = (3 * s.enc_l.nbytes + 4 * int(lmask.sum())
          + 4 * B * e_ref.size + 4 * B * K * (W + 1))
    dvalid = np.arange(s.Dmax)[None, :] < np.diff(eng.plan.ptr)[:, None]
    dmask = dvalid[..., None] & (s.dec_w < s.W)
    got_ref = np.unique(s.dec_s[dmask].astype(np.int64) * (s.W + 1)
                        + s.dec_w[dmask]) if dmask.any() else np.zeros(0)
    smask = (dvalid[..., None, None] & (s.strip_l < s.Lmax))
    ks = np.broadcast_to(np.arange(K)[:, None, None, None], s.strip_l.shape)
    se = s.loc_e[ks[smask], s.strip_l[smask]] if smask.any() else np.zeros(0, int)
    n_dec = int(dvalid.sum())
    k2 = (4 * 4 * n_dec * r + 3 * 4 * int(smask.sum()) + 4 * (K + 1)
          + 4 * B * got_ref.size + 4 * B * np.unique(se[se < nnz]).size
          + 4 * B * M)
    return int(k1), int(k2)


def kernel_records(torch, eng) -> list[dict]:
    """Hold K1/K2/K3 against their plain versions at this session's shapes,
    on pagerank's Map output (B = 1) and on multi_sssp's over a seeded
    random [n, 4] state (B = 4); time them at B = 1 and compute each
    kernel's bytes bound, K1's and K2's also on the layout before packing
    (`bound_ms_old_layout`). K1's record carries the general form's time
    on the unpacked tables (`general_ms`), the same card's before. K3's
    record carries its L2 sector traffic and, under "b4", the same record
    at B = 4 (pagerank's Map over the random [n, 4] state)."""
    from repro_torch.core import algorithms as algo
    from repro_torch.kernels.xor_code import xor_code as xc

    fx, dev = eng.fused, eng.device
    general = general_tables(torch, eng)
    state4 = torch.from_numpy(np.random.default_rng(4).random(
        (eng.g.n, 4), dtype=np.float32)).to(dev)
    ev4 = algo.multi_sssp([0, 1, 2, 3]).map_edge_values_t(eng._dg, state4)
    hold_session(torch, eng, ev4.contiguous(), "the session shapes, B = 4",
                 general)
    prog = algo.pagerank()
    ev4 = prog.map_edge_values_t(eng._dg, state4).contiguous()
    held4 = hold_session(torch, eng, ev4, "the session shapes, pagerank B = 4",
                         general)
    state = torch.as_tensor(prog.init(eng.g), device=dev)
    ev = prog.map_edge_values_t(eng._dg, state).contiguous()
    held = hold_session(torch, eng, ev, "the session shapes, B = 1", general)
    t = held["tables"]
    buf = xc.xor_encode_packed(*(t[k] for k in ENC_PACKED))
    dec_args = (t["src"], buf) + tuple(t[k] for k in DEC_PACKED)

    # All three kernels are bound by bytes (a few integer ops per word),
    # so bound_ms = bytes / memory rate.
    k1_bytes, k2_bytes = packed_bytes(eng)
    k1_old, k2_old = unpacked_bytes(eng)
    runs = (
        ("xor_encode", k1_bytes,
         lambda: xc.xor_encode_packed(*(t[k] for k in ENC_PACKED)),
         lambda: xc.ref.xor_encode_packed(*(t[k] for k in ENC_PACKED)), None),
        ("xor_decode", k2_bytes,
         lambda: xc.xor_decode_packed(*dec_args, total=fx.M),
         lambda: xc.ref.xor_decode_packed(*dec_args), None))
    records = [kernel_record(torch, name, kernel, plain, library,
                             held["err"][name], nbytes, 0)
               for name, nbytes, kernel, plain, library in runs]
    for rec, old in zip(records, (k1_old, k2_old)):
        rec["bytes_old_layout"] = old
        rec["bound_ms_old_layout"] = bound(torch, old, 0)[0]
    records[0]["general_ms"] = time_ms_graph(
        torch, lambda: xc.xor_encode_gather(*held["general"]))
    rec3 = segment_reduce_record(torch, eng, held)
    rec3["b4"] = segment_reduce_record(torch, eng, held4)
    return records + [rec3]


def l2_sectors(nnz: int, B: int) -> dict:
    """The L2 sector traffic of the random reads of K3 / K5: one 32-byte
    sector per entry and column for a per-column gather (the first
    designs), one per entry and chunk of up to 4 columns read as one vector
    (the CSR-streaming body, where B's alignment allows)."""
    V = 4 if B % 4 == 0 else 2 if B % 2 == 0 else 1
    return {"l2_sector_bytes": 32 * nnz * B,
            "l2_sector_bytes_vector": 32 * nnz * (B // V)}


def segment_reduce_record(torch, eng, held) -> dict:
    """K3 (sum) on a session's gather at the width of `held` (from
    `hold_session`): bound (gather, indptr, the gathered values, the
    output), L2 sectors, the scatter plain version's time (`plain_ms`), the
    sequential plain version's (`seq_plain_ms`), `torch.segment_reduce` on
    the values gathered beforehand (`library_ms`, timed only) and on the
    same inputs as K3, gathered in the call (`library_with_gather_ms`:
    concatenation, index and segment_reduce)."""
    from repro_torch.core.bitcodec import words_to_floats_t
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.kernels.segment_reduce import ref as sr_ref

    red_args = held["red"]
    ev, words = red_args[0], held["words"]
    nnz, n = eng.g.csr.nnz, eng.g.n
    B = 1 if ev.dim() == 1 else ev.shape[1]
    nbytes = 4 * nnz + 4 * (n + 1) + 4 * B * nnz + 4 * B * n
    rows = eng._gather.long()
    gathered = torch.cat([ev, words_to_floats_t(words)])[rows]
    offsets = eng._indptr.long()
    rec = kernel_record(
        torch, "segment_reduce",
        lambda: sr.segment_reduce(*red_args, tiles=eng._tiles),
        lambda: sr_ref.segment_reduce(*red_args),
        lambda: torch.segment_reduce(gathered, "sum", offsets=offsets, axis=0),
        held["err"]["segment_reduce"], nbytes, 0)
    rec["seq_plain_ms"] = time_ms(
        torch, lambda: sr_ref.segment_reduce_seq(*red_args), reps=5)
    rec["library_with_gather_ms"] = time_ms(torch, lambda: torch.segment_reduce(
        torch.cat([ev, words_to_floats_t(words)])[rows], "sum", offsets=offsets,
        axis=0))
    rec.update(l2_sectors(nnz, B), B=B)
    return rec


def kernel_record(torch, name: str, kernel, plain, library, err: float,
                  nbytes: float, flops: float, rate: str = "f32") -> dict:
    """One kernel's line: device time (CUDA graph), plain and library call
    times (None where no single PyTorch call computes the same function),
    and its bound from this run's bytes and operations (at `rate`, float32
    outside the tensor cores by default)."""
    bound_ms, bound_by = bound(torch, nbytes, flops, rate)
    return {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
        "ms": time_ms_graph(torch, kernel),
        "plain_ms": time_ms(torch, plain, reps=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if library is None else time_ms(torch, library),
        "ms_per_call": time_ms(torch, kernel), "bytes": int(nbytes)}


def record_launches(records: list[dict], launches: dict, path: str) -> dict:
    """Write the launch counts of a path's run (cleared just before it, read
    just after) into `records`; fail if a kernel never ran."""
    for rec in records:
        rec["launches"] = launches.get(rec["name"], 0)
        if rec["launches"] <= 0:
            raise AssertionError(f"kernel {rec['name']} never launched on "
                                 f"{path}")
    return launches


def session_costs(fx) -> dict:
    """What the packed tables cost the session: the host time to pack a
    schedule (timed again here on its own), and the device bytes of the
    tables it uploads against those of the unpacked tables and loc_e."""
    from repro_torch.core.fused_shuffle import pack_schedule

    t0 = time.perf_counter()
    pack_schedule(fx.sched, fx.nnz)
    s = fx.sched
    unpacked = sum(getattr(s, k).size * 4 for k in (
        "loc_e", "enc_l", "enc_shift", "enc_mask", "dec_s", "dec_w",
        "dec_mask", "dec_shift", "strip_l", "strip_shift", "strip_mask"))
    return {"pack_s": time.perf_counter() - t0,
            "table_bytes": sum(t.numel() * t.element_size()
                               for t in fx.tables.values()),
            "table_bytes_unpacked": unpacked + fx.tables["ptr"].numel() * 4}


def slice_phase(torch, dev, n_base: int) -> tuple[list[dict], dict, tuple]:
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
    from repro_torch.core.shuffle_plan import compile_plan_csr
    from repro_torch.kernels import _build

    g, alloc, t_graph = er_session(n_base, seed=76)
    t0 = time.perf_counter()
    plan = compile_plan_csr(g.csr, alloc)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = engine.compile(algo.pagerank(), g, alloc, plan=plan, path="sparse",
                         backend="fused", device=dev)
    fx = eng.fused
    t_session = time.perf_counter() - t0
    s = fx.sched
    info = dict(n=g.n, nnz=g.csr.nnz, C=int(plan.col_sender.size), W=s.W,
                Lmax=s.Lmax, Dmax=s.Dmax, M=fx.M, graph_s=t_graph,
                compile_s=t_compile, session_s=t_session, **session_costs(fx))
    log(f"slice: er-76k {json.dumps(info)}")

    # Delivered words of one exchange vs the NumPy executor.
    prog = algo.pagerank()
    ev_np = prog.map_edge_values(g, prog.init(g)).astype(np.float32)
    want = floats_to_words(plan.execute_coded_sparse(ev_np, eng.tables).values)
    got = t_words_to_np(fx.exchange(torch.from_numpy(ev_np).to(dev)))
    if not np.array_equal(got, want):
        raise AssertionError("delivered words differ from execute_coded_sparse")

    records = kernel_records(torch, eng)

    # The main path: reset the counts, run the sessions, read the counts.
    _build.LAUNCHES.clear()
    runs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs["pagerank"] = eng.run(10)
    torch.cuda.synchronize()
    info["pagerank_s_per_iter"] = (time.perf_counter() - t0) / 10
    runs["sssp"] = eng.with_program(algo.sssp(0)).run(10)
    roots = [0, g.n // 7, g.n // 2, g.n - 1]
    runs["multi_sssp"] = eng.with_program(algo.multi_sssp(roots)).run(10)
    torch.cuda.synchronize()
    launches = record_launches(records, dict(_build.LAUNCHES),
                               "the er-76k path")

    oracle = {
        "pagerank": algo.reference_run(algo.pagerank(), g, 10),
        "sssp": algo.reference_run(algo.sssp(0), g, 10),
        "multi_sssp": algo.reference_run(algo.multi_sssp(roots), g, 10),
    }
    for name, res in runs.items():
        st = res.state.cpu().numpy()
        if st.shape != oracle[name].shape or not np.isfinite(
                st[np.isfinite(oracle[name])]).all():
            raise AssertionError(f"{name}: bad state shape or values")
        if name == "pagerank":
            np.testing.assert_allclose(st, oracle[name], rtol=SUM_RTOL, atol=0)
            info["pagerank_max_rel_err"] = float(
                np.max(np.abs(st - oracle[name]) / np.abs(oracle[name])))
        elif not np.array_equal(st.view(np.uint32),
                                oracle[name].view(np.uint32)):
            raise AssertionError(f"{name}: not bitwise equal to the oracle")
        B = res.batch
        if res.shuffle_bits != (plan.coded_bits + plan.leftover_bits) * B * 10:
            raise AssertionError(f"{name}: shuffle bits are not exact")
    info["launches"] = launches
    info.update(iteration_profile(torch, eng))
    log(f"slice phase ok: {json.dumps(info)}")
    return records, info, (g, alloc, plan, oracle["pagerank"])


# The kernel each launch counter counts, as torch.profiler names it.
SYMBOL_OF_COUNTER = {
    "xor_encode": "xor_encode_packed_kernel",
    "xor_encode_plan": "xor_encode_packed_kernel",
    "xor_decode": "xor_decode_packed_kernel",
    "xor_decode_plan": "xor_decode_packed_kernel",
    "xor_decode_direct": "xor_decode_packed_kernel",
    "xor_encode_gather": "xor_encode_gather_kernel",
    "xor_encode_dense": "xor_encode_dense_kernel",
    "segment_reduce": "csr_stream_kernel",
    "spmv_csr": "csr_stream_kernel",
    "spmv_dense": "spmv_dense_kernel",
    "ssd_chunk": "ssd_chunk_kernel",
    "ssd_state_scan": "ssd_state_scan_kernel",
}
KERNEL_SYMBOL = re.compile(
    r"\b(" + "|".join(sorted(set(SYMBOL_OF_COUNTER.values()))) + r")\b")
PROFILE_TRIES = 3


def profiled_window(torch, fn) -> dict:
    """torch.profiler's device records of one call of `fn` (ended by a
    synchronize), and the host wall time around it.

    Each window traces a warm-up call of `fn` first and discards it (the
    profiler's schedule: warmup 1, active 1), since records of a window's
    first kernels can be lost while tracing starts, and the warm-up keeps
    the card's clocks up where idle time before the call would let them
    fall. The window must then hold exactly one record of each launch of
    the port's kernels that the launch counters (`_build.LAUNCHES`)
    counted during the active call, kernel by kernel; one that lost (or
    doubled) a record is taken again, up to PROFILE_TRIES windows in all.
    Returns {"kernels": [...] or None, "annotations", "wall_s", "tries",
    "profile_incomplete"}: the device's kernel and copy records, with the
    ranges marked on the device's timeline (the profiler's step, and
    torch.distributed's collectives) apart in "annotations", since they
    overlap the work they cover; kernels None (and the flag True) when no
    window was complete, so that no partial busy time is reported.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import _build

    for tries in range(1, PROFILE_TRIES + 1):
        events = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda prof: events.extend(prof.events())) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = collections.Counter(_build.LAUNCHES)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = collections.Counter(_build.LAUNCHES)
            prof.step()
        launched.subtract(before)
        want = collections.Counter()
        for name, count in launched.items():
            want[SYMBOL_OF_COUNTER[name]] += count
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        marks = [e for e in device if getattr(e, "is_user_annotation", False)
                 or e.name.startswith("ProfilerStep")]
        kernels = sorted((e for e in device if e not in marks),
                         key=lambda e: e.time_range.start)
        ours = collections.Counter(m.group(0) for m in map(
            KERNEL_SYMBOL.search, (e.name for e in kernels)) if m)
        if kernels and ours == want:
            return {"kernels": kernels, "annotations": marks, "wall_s": wall,
                    "tries": tries, "profile_incomplete": False}
        log(f"profile window {tries}: records of the port's kernels "
            f"{dict(ours)} for launches {dict(+want)}, {len(kernels)} kernel "
            f"records in all, the first {[e.name[:40] for e in kernels[:4]]}")
    return {"kernels": None, "annotations": None, "wall_s": wall,
            "tries": PROFILE_TRIES, "profile_incomplete": True}


def busy_and_idle(kernels) -> tuple[float, float | None]:
    """Device busy seconds of a window's kernel records, and the idle share
    over the span from the first kernel's start to the last one's end."""
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e6
    return busy, (1.0 - busy / span if span > 0 else None)


def busy_ms(m: dict) -> str:
    """A profile's busy ms per iteration for a log line."""
    b = m.get("device_busy_s_per_iter")
    return "not measured (profile incomplete)" if b is None else f"{b * 1e3:.4f}"


def iteration_profile(torch, eng, iters: int = 10) -> dict:
    """Where an iteration's time goes, from a state already on the card.

    steady_s_per_iter: host clock around `run(iters, state=<device
    tensor>)` ended by a synchronize (no host init or upload inside),
    median of 5 such runs; host_enqueue_s_per_iter: the same clock read
    before the synchronize, the host's own time to issue the work.
    device_busy_s_per_iter / device_idle_share: from torch.profiler's
    kernel records over the same call (`profiled_window`: a window whose
    records of the port's kernels are not the counted launches is taken
    again, and after
    PROFILE_TRIES incomplete windows both are None with
    profile_incomplete True), idle = 1 - busy / (last kernel end - first
    kernel start); profile_tries counts the windows taken.
    phase_s_per_iter: the tracer's synchronised spans (each phase ends
    with a synchronize, so these add up to more than the steady time).
    """
    from repro_torch.obs import Tracer, set_tracer

    state = torch.as_tensor(eng.program.init(eng.g), device=eng.device)
    eng.run(2, state=state)
    torch.cuda.synchronize()
    steady, enqueue = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.run(iters, state=state)
        enqueue.append((time.perf_counter() - t0) / iters)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) / iters)
    out = {"steady_s_per_iter": statistics.median(steady),
           "host_enqueue_s_per_iter": statistics.median(enqueue)}

    win = profiled_window(torch, lambda: eng.run(iters, state=state))
    out["profile_tries"] = win["tries"]
    out["profile_incomplete"] = win["profile_incomplete"]
    out["device_busy_s_per_iter"] = out["device_idle_share"] = None
    if win["kernels"] is not None:
        busy, out["device_idle_share"] = busy_and_idle(win["kernels"])
        out["device_busy_s_per_iter"] = busy / iters

    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        eng.run(iters, state=state)
    finally:
        set_tracer(prev)
    phases = {}
    for sp in tracer.spans():
        if sp.name.startswith("phase."):
            phases[sp.name] = phases.get(sp.name, 0.0) + sp.duration_s / iters
    out["phase_s_per_iter"] = phases
    return out


def call_profile(torch, fn, top: int = 6) -> dict:
    """Where one call's time goes: host wall time around it (ended by a
    synchronize), the device's busy time and idle share over the span of
    its kernels, the number of kernels, and the `top` kernels by device
    time, from a complete `profiled_window` (busy, idle and kernels None,
    profile_incomplete True, when none was)."""
    win = profiled_window(torch, fn)
    out = {"wall_ms": win["wall_s"] * 1e3, "profile_tries": win["tries"],
           "profile_incomplete": win["profile_incomplete"],
           "device_busy_ms": None, "device_idle_share": None, "kernels": None,
           "top_ms": None}
    if win["kernels"] is None:
        return out
    busy, out["device_idle_share"] = busy_and_idle(win["kernels"])
    by_name: dict = {}
    for e in win["kernels"]:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    out.update(device_busy_ms=busy * 1e3, kernels=len(win["kernels"]),
               top_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


def scale_phase(torch, dev, n_base: int) -> tuple[list[dict], dict, tuple]:
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.shuffle_plan import compile_plan_csr
    from repro_torch.kernels import _build

    g, alloc, t_graph = er_session(n_base, seed=7)
    t0 = time.perf_counter()
    plan = compile_plan_csr(g.csr, alloc)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = engine.compile(algo.pagerank(), g, alloc, plan=plan, path="sparse",
                         backend="fused", device=dev)
    fx = eng.fused
    t_session = time.perf_counter() - t0
    info = dict(n=g.n, nnz=g.csr.nnz, C=int(eng.plan.col_sender.size),
                W=fx.sched.W, Lmax=fx.sched.Lmax, Dmax=fx.sched.Dmax, M=fx.M,
                graph_s=t_graph, compile_s=t_compile, session_s=t_session,
                **session_costs(fx))
    eng.run(1)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = eng.run(10)
    torch.cuda.synchronize()
    info["pagerank_s_per_iter"] = (time.perf_counter() - t0) / 10
    launches = dict(_build.LAUNCHES)
    want = algo.reference_run(algo.pagerank(), g, 10)
    got = res.state.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)
    info["pagerank_max_rel_err"] = float(np.max(np.abs(got - want) / np.abs(want)))
    info.update(iteration_profile(torch, eng))
    info["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    records = kernel_records(torch, eng)
    info["launches"] = record_launches(records, launches, "the scale path")
    log(f"scale phase ok: {json.dumps(info)}")
    return records, info, (g, alloc, plan, want)


# ---------------------------------------------------------------------------
# spmv phase: the engine's backend="spmv" route (K5) and the dense API (K4)
# ---------------------------------------------------------------------------


def spmv_csr_record(torch, eng, state) -> dict:
    """Hold K5 against its plain versions on the session's CSR and the Map
    of `state`: within rtol 1e-5 (atol 0: every value is positive) of the
    scatter plain version, bitwise the sequential one, bitwise repeatable
    and the same bits for every `bm`; time it beside a CSR sparse tensor
    times the vector (`torch.sparse_csr_tensor(...) @ c`, timed only), with
    its bound and L2 sector traffic. Under "b4" the same at B = 4 (a
    seeded random positive [n, 4] payload)."""
    c = eng.program.map_source_t(eng._dg, state).contiguous()
    rec = spmv_csr_width(torch, eng, c)
    c4 = torch.from_numpy(np.random.default_rng(5).random(
        (eng.g.n, 4), dtype=np.float32) + 0.01).to(c.device)
    rec["b4"] = spmv_csr_width(torch, eng, c4)
    return rec


def spmv_csr_width(torch, eng, c) -> dict:
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.spmv import spmv as spmv_k

    args = (eng._indptr, eng._indices, c)
    got = spmv_k.spmv_csr(*args, bm=eng.bm, tiles=eng._tiles)
    again = spmv_k.spmv_csr(*args, bm=eng.bm, tiles=eng._tiles)
    want = spmv_ref.spmv_csr(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
    if not bitwise(torch, got, again):
        raise AssertionError("K5 spmv_csr is not bitwise repeatable")
    if not bitwise(torch, got, spmv_ref.spmv_csr_seq(*args)):
        raise AssertionError("K5 spmv_csr is not bitwise the sequential "
                             "plain version")
    n, nnz = eng.g.n, eng.g.csr.nnz
    B = 1 if c.dim() == 1 else c.shape[1]
    for bm in (8, 32, 256):
        if not bitwise(torch, spmv_k.spmv_csr(*args, bm=bm, tiles=eng._tiles), got):
            raise AssertionError(f"K5 spmv_csr depends on bm ({bm})")
    sp = torch.sparse_csr_tensor(
        eng._indptr, eng._indices,
        torch.ones(nnz, dtype=torch.float32, device=c.device), size=(n, n))
    rec = kernel_record(
        torch, "spmv_csr",
        lambda: spmv_k.spmv_csr(*args, bm=eng.bm, tiles=eng._tiles),
        lambda: spmv_ref.spmv_csr(*args), lambda: sp @ c,
        float((got - want).abs().max()),
        4 * nnz + 4 * (n + 1) + 4 * B * n + 4 * B * n, nnz * B)
    rec["seq_plain_ms"] = time_ms(
        torch, lambda: spmv_ref.spmv_csr_seq(*args), reps=5)
    rec.update(l2_sectors(nnz, B), B=B)
    return rec


def spmv_dense_record(torch, adj, x) -> dict:
    """Hold K4 against its plain version on the dense path's inputs and
    time it beside `torch.mv` (timed only; float16 inputs go to it as
    float16, a float16 output)."""
    from repro_torch.kernels.spmv import ref as spmv_ref
    from repro_torch.kernels.spmv import spmv as spmv_k

    got, want = spmv_k.spmv_dense(adj, x), spmv_ref.spmv(adj, x)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-4, atol=1e-5) if adj.dtype == torch.float32
           else dict(rtol=2e-3, atol=2e-3))
    torch.testing.assert_close(got, want, **tol)
    m, n = adj.shape
    xl = x.to(adj.dtype)
    return kernel_record(
        torch, "spmv_dense", lambda: spmv_k.spmv_dense(adj, x),
        lambda: spmv_ref.spmv(adj, x), lambda: torch.mv(adj, xl),
        float((got - want).abs().max()),
        m * n * adj.element_size() + n * x.element_size() + 4 * m, 2 * m * n)


def check_pagerank(got, want, what: str) -> float:
    """Finite, the oracle's shape, within rtol 1e-5 (atol 0); returns the
    max relative error."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: bad state shape or values")
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0,
                               err_msg=what)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def spmv_phase(torch, dev, er: tuple, scale: tuple) -> tuple[dict, dict, dict]:
    """The backend="spmv" route on the er-76k and scale graphs and plans
    that the slice and scale phases built (passing `plan=` reuses their
    cached edge tables). Returns K5's records at both shapes and the info."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.kernels import _build

    g, alloc, plan, want = er
    t0 = time.perf_counter()
    sessions = {mode: engine.compile(
        algo.pagerank(), g, alloc, mode, backend="spmv", device=dev,
        plan=None if mode == "uncoded" else plan) for mode in SPMV_MODES}
    info = {"er76k": {"session_s": time.perf_counter() - t0}}
    bits = {"single": 0, "uncoded": plan.uncoded_bits,
            "coded": plan.coded_bits + plan.leftover_bits,
            "coded-fast": plan.coded_bits}
    prefs = algo.uniform_prefs(g.n, 4)
    ppr = algo.personalized_pagerank(prefs)
    eng = sessions["coded"]

    # The er-76k spmv path: reset the counts, run, read the counts.
    _build.LAUNCHES.clear()
    runs = {mode: s.run(10) for mode, s in sessions.items()}
    deg = eng.with_program(algo.degree_count()).run(1)
    ppr_res = eng.with_program(ppr).run_batch(prefs, 10)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if launches.get("spmv_csr", 0) <= 0:
        raise AssertionError("K5 spmv_csr never launched on the er-76k "
                             "spmv path")
    er_info = info["er76k"]
    for mode, res in runs.items():
        er_info[f"{mode}_max_rel_err"] = check_pagerank(
            res.state.cpu().numpy(), want, f"spmv pagerank {mode}")
        if res.shuffle_bits != bits[mode] * 10:
            raise AssertionError(f"spmv {mode}: shuffle bits are not exact")
    deg_want = algo.reference_run(algo.degree_count(), g, 1)
    if not np.array_equal(deg.state.cpu().numpy().view(np.uint32),
                          deg_want.view(np.uint32)):
        raise AssertionError("spmv degree_count not bitwise")
    er_info["ppr_max_rel_err"] = check_pagerank(
        ppr_res.state.cpu().numpy(), algo.reference_run(ppr, g, 10),
        "spmv personalized pagerank B=4")
    if ppr_res.shuffle_bits != bits["coded"] * 4 * 10:
        raise AssertionError("spmv ppr: shuffle bits are not exact")
    er_info["launches"] = launches
    er_info.update(iteration_profile(torch, eng))
    state = torch.as_tensor(algo.pagerank().init(g), device=dev)
    rec_er = spmv_csr_record(torch, eng, state)
    rec_er["launches"] = launches["spmv_csr"]
    log(f"spmv phase, er-76k ok: {json.dumps(er_info)}")

    g, alloc, plan, want = scale
    t0 = time.perf_counter()
    eng = engine.compile(algo.pagerank(), g, alloc, "coded", backend="spmv",
                         plan=plan, device=dev)
    sc_info = info["scale"] = {"session_s": time.perf_counter() - t0}
    eng.run(1)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = eng.run(10)
    torch.cuda.synchronize()
    sc_info["pagerank_s_per_iter"] = (time.perf_counter() - t0) / 10
    launches = dict(_build.LAUNCHES)
    if launches.get("spmv_csr", 0) <= 0:
        raise AssertionError("K5 spmv_csr never launched on the scale "
                             "spmv path")
    sc_info["launches"] = launches
    sc_info["pagerank_max_rel_err"] = check_pagerank(
        res.state.cpu().numpy(), want, "spmv pagerank at scale")
    if res.shuffle_bits != (plan.coded_bits + plan.leftover_bits) * 10:
        raise AssertionError("spmv at scale: shuffle bits are not exact")
    sc_info.update(iteration_profile(torch, eng))
    state = torch.as_tensor(algo.pagerank().init(g), device=dev)
    rec_scale = spmv_csr_record(torch, eng, state)
    rec_scale["launches"] = launches["spmv_csr"]
    log(f"spmv phase, scale ok: {json.dumps(sc_info)}")
    return rec_er, rec_scale, info


def dense_phase(torch, dev) -> tuple[dict, dict]:
    """`ops.pagerank_step` (K4) for 10 steps on the dense adjacency of an
    ER graph (n = 16,384, p = 0.01, seed 5), float32 and float16 (0/1
    entries are exact in float16; rank / deg stays float32), each within
    rtol 1e-5 of the NumPy oracle. Returns K4's record at float32 (with
    the float16 record in the info)."""
    from repro_torch import graphs
    from repro_torch.core import algorithms as algo
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmv import ops as spmv_ops

    g = graphs.erdos_renyi(DENSE_N, 0.01, seed=5)
    want = algo.reference_run(algo.pagerank(), g, 10)
    rows = torch.from_numpy(g.csr.rows.astype(np.int64)).to(dev)
    cols = torch.from_numpy(g.csr.indices.astype(np.int64)).to(dev)
    init = torch.as_tensor(algo.pagerank().init(g), device=dev)
    info, records = {"n": g.n, "nnz": g.csr.nnz}, {}
    for name, dt in (("float32", torch.float32), ("float16", torch.float16)):
        adj = torch.zeros((g.n, g.n), dtype=dt, device=dev)
        adj[rows, cols] = 1
        spmv_ops.pagerank_step(adj, init)            # warm up
        torch.cuda.synchronize()
        # The dense path: reset the counts, run, read the counts.
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        rank = init
        for _ in range(10):
            rank = spmv_ops.pagerank_step(adj, rank)
        torch.cuda.synchronize()
        info[f"{name}_s_per_step"] = (time.perf_counter() - t0) / 10
        launches = dict(_build.LAUNCHES)
        if launches.get("spmv_dense", 0) <= 0:
            raise AssertionError(f"K4 spmv_dense never launched on the "
                                 f"dense {name} path")
        info[f"{name}_launches"] = launches
        info[f"{name}_max_rel_err"] = check_pagerank(
            rank.cpu().numpy(), want, f"dense pagerank_step {name}")
        deg = torch.clamp(adj.sum(0, dtype=torch.float32), min=1.0)
        records[name] = spmv_dense_record(torch, adj, init / deg)
        records[name]["launches"] = launches["spmv_dense"]
        del adj
        torch.cuda.empty_cache()
    info["float16_kernel"] = records["float16"]
    log(f"dense phase ok: {json.dumps(info)}")
    return records["float32"], info


# ---------------------------------------------------------------------------
# modes phase: backend="numpy" (the plan executors on the card), the dense
# path and coded-ref, with K1's dense form on the coded route
# ---------------------------------------------------------------------------


def check_state(got, want, name: str, what: str) -> float | None:
    """Float-sum programs (pagerank, personalized pagerank) within rtol
    1e-5 (returns the max relative error); every other program bitwise."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: state shape {got.shape}, want "
                             f"{want.shape}")
    if name in ("pagerank", "ppr"):
        return check_pagerank(got, want, what)
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError(f"{what}: not bitwise equal to the oracle")
    return None


def same_delivered(got: dict, want: dict, what: str) -> None:
    """Two dict deliveries hold the same keys and the same float32 bits."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: servers differ")
    for k in want:
        if got[k].keys() != want[k].keys():
            raise AssertionError(f"{what}: server {k} got other values")
        for key, v in want[k].items():
            if (np.float32(got[k][key]).view(np.uint32)
                    != np.float32(v).view(np.uint32)):
                raise AssertionError(f"{what}: server {k} value {key} differs")


def hold_xor_routes(torch, eng, ev, what: str) -> dict:
    """The plan executor's three XOR routes on the card: delivered words of
    one coded Shuffle of the [nnz] edge values `ev` bitwise the NumPy
    executor's. Returns the launch counts of the "xor-kernel" route's run
    (cleared just before it): K1's dense form's path."""
    from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
    from repro_torch.kernels import _build

    ev_np = ev.cpu().numpy()
    want = floats_to_words(eng.plan.execute_coded_sparse(ev_np, eng.tables).values)
    launches = {}
    for backend in ("numpy", "xor-kernel", "xor-ref"):
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        got = t_words_to_np(eng.dplan.words(ev, "coded", backend=backend))
        if backend == "xor-kernel":
            launches = dict(_build.LAUNCHES)
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: coded words on the {backend} route "
                                 "differ from execute_coded_sparse")
    if launches.get("xor_encode_dense", 0) <= 0:
        raise AssertionError(f"{what}: K1's dense form never launched on the "
                             "xor-kernel route")
    return launches


def xor_dense_record(torch, eng, ev, launches: dict) -> dict:
    """K1's dense form at the shape the "xor-kernel" route hands it: the
    slot words [C, r] of one Shuffle of `ev`, as rows [r, C, 1]. Bitwise
    its plain version; bound: the [r, C] words read and the [C] written;
    launches from that route's run (`hold_xor_routes`)."""
    from repro_torch.kernels.xor_code import ref as xref
    from repro_torch.kernels.xor_code import xor_code as xc

    dp = eng.dplan
    src, t = dp.coded_source(ev)
    slotw = xref.plan_slot_words(src, t.slot_e, t.slot_code, dp.book)
    rows = slotw.t().contiguous()[..., None]
    valid = torch.ones(rows.shape[:2], dtype=torch.bool, device=rows.device)
    got, want = xc.xor_encode_dense(rows, valid), xref.xor_encode(rows, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 xor_encode_dense not bitwise its plain version")
    r, C = rows.shape[:2]
    rec = kernel_record(torch, "xor_encode_dense",
                        lambda: xc.xor_encode_dense(rows, valid),
                        lambda: xref.xor_encode(rows, valid), None,
                        word_err(torch, got, want), 4 * r * C + 4 * C, r * C)
    rec.update(C=C, r=r, launches=launches["xor_encode_dense"])
    return rec


def plan_bytes(dp, t, n_src: int) -> dict:
    """Bytes the plan encode and decode must move on the coded tables `t`
    of a source of n_src entries, as `packed_bytes` counts the packed K1
    and K2 (B weighs the words): each table read once, the book, each
    distinct source word a live slot reads (mask kept, not the sentinel),
    each distinct coded word a live segment reads, each output written
    once. Encode: slot_e, slot_code, the slots' source words, the
    [C + L + 1, B] buffer (its zero column too). Decode: dec_pos,
    dec_code, strip_e, strip_code, the coded words, the strips' source
    words, [M, B] out."""
    book = dp.book.cpu().numpy().view(np.uint32)
    kept = lambda code: book[1][np.minimum(code, book.shape[1] - 1)] != 0  # noqa: E731
    slot_e, slot_code, pos, pos_code, strip_e, strip_code = (
        x.cpu().numpy() for x in (t.slot_e, t.slot_code, t.dec_pos,
                                  t.dec_code, t.strip_e, t.strip_code))
    enc_fixed = slot_e.nbytes + slot_code.nbytes + book.nbytes
    dec_fixed = (pos.nbytes + pos_code.nbytes + strip_e.nbytes
                 + strip_code.nbytes + book.nbytes)
    return {"enc_fixed": enc_fixed,
            "enc_words": (np.unique(slot_e[kept(slot_code) & (slot_e < n_src)]).size
                          + slot_e.shape[0] + 1),
            "dec_fixed": dec_fixed,
            "dec_words": (np.unique(pos[kept(pos_code)]).size
                          + np.unique(strip_e[kept(strip_code)
                                              & (strip_e < n_src)]).size
                          + pos.shape[0])}


def hold_plan_kernels(torch, dp, values, what: str, dense: bool = False):
    """Both plan kernels bitwise their plain versions on the Map output
    `values` ([nnz(, B)] edge values, or the [n, n] matrix as the dense
    Map hands it over when `dense`), through the session's coded tables
    for its layout. Returns the source, the tables, both kernels'
    outputs and their max abs word errors."""
    from repro_torch.kernels.xor_code import ref as xref
    from repro_torch.kernels.xor_code import xor_code as xc

    src, t = dp.coded_source(values, dense=dense)
    enc = (src, t.slot_e, t.slot_code, dp.book)
    dec = (t.dec_pos, t.dec_code, t.strip_e, t.strip_code, dp.book)
    coded, coded0 = xc.xor_encode_plan(*enc), xref.xor_encode_plan(*enc)
    words = xc.xor_decode_plan(src, coded, *dec)
    words0 = xref.xor_decode_plan(src, coded, *dec)
    torch.cuda.synchronize()
    if not torch.equal(coded, coded0):
        raise AssertionError(f"xor_encode_plan not bitwise its plain version "
                             f"at {what}")
    if not torch.equal(words, words0):
        raise AssertionError(f"xor_decode_plan not bitwise its plain version "
                             f"at {what}")
    return src, t, enc, dec, coded, (word_err(torch, coded, coded0),
                                     word_err(torch, words, words0))


def plan_records(torch, eng, ev, ev4, what: str) -> list[dict]:
    """The plan encode and decode on the session's composed tables, on the
    Map output `ev` [nnz] and `ev4` [nnz, 4]: each bitwise its plain
    version (the decode on the kernel's coded columns); timed at B = 1 and,
    under "b4", at B = 4, with bounds from `plan_bytes`."""
    from repro_torch.kernels.xor_code import ref as xref
    from repro_torch.kernels.xor_code import xor_code as xc

    dp = eng.dplan
    out, cost = {}, None
    for B, values in ((4, ev4), (1, ev)):
        src, t, enc, dec, coded, err = hold_plan_kernels(
            torch, dp, values, f"{what}, B = {B}")
        cost = cost or plan_bytes(dp, t, src.shape[0])
        enc_b = cost["enc_fixed"] + 4 * B * cost["enc_words"]
        dec_b = cost["dec_fixed"] + 4 * B * cost["dec_words"]
        out[B] = [
            kernel_record(torch, "xor_encode_plan",
                          lambda: xc.xor_encode_plan(*enc),
                          lambda: xref.xor_encode_plan(*enc), None, err[0],
                          enc_b, 0),
            kernel_record(torch, "xor_decode_plan",
                          lambda: xc.xor_decode_plan(src, coded, *dec),
                          lambda: xref.xor_decode_plan(src, coded, *dec),
                          None, err[1], dec_b, 0)]
    plan = dp.plan
    for rec, rec4 in zip(out[1], out[4]):
        rec.update(C=int(plan.slot_pair.shape[0]), r=plan.r,
                   P=int(plan.pos_covered.size), L=int(plan.pos_left.size),
                   b4={k: rec4[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bytes", "max_abs_err")})
    return out[1]


PLAN_KERNELS = ("xor_encode_plan", "xor_decode_plan")


def modes_er76k(torch, dev, er: tuple) -> tuple[dict, dict]:
    """backend="numpy" on the er-76k graph and plan: six programs x four
    modes, 10 iterations each, against the sparse NumPy oracle, delivered
    words bitwise the NumPy executor per mode and XOR route; the launch
    counts of that run (cleared just before it) for the plan encode and
    decode and K3. Returns the plan kernels' records (bitwise their plain
    versions at B = 1 and 4) and K1's dense form's (on the "xor-kernel"
    route, launches from that route's run), and the info."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
    from repro_torch.kernels import _build

    g, alloc, plan, _ = er
    roots = [0, g.n // 7, g.n // 2, g.n - 1]
    progs = {"pagerank": algo.pagerank(), "sssp": algo.sssp(0),
             "cc": algo.connected_components(), "degree": algo.degree_count(),
             "multi_sssp": algo.multi_sssp(roots),
             "ppr": algo.personalized_pagerank(algo.uniform_prefs(g.n, 4))}
    t0 = time.perf_counter()
    sessions = {mode: engine.compile(algo.pagerank(), g, alloc, mode,
                                     path="auto", backend="numpy", plan=plan,
                                     device=dev) for mode in SPMV_MODES}
    info = {"session_s": time.perf_counter() - t0}
    pr = algo.pagerank()
    ev = pr.map_edge_values_t(g.device_view(dev), torch.as_tensor(
        pr.init(g), device=dev)).contiguous()
    ev_np = ev.cpu().numpy()
    for mode in SPMV_MODES[1:]:
        want = floats_to_words(plan.execute_sparse(ev_np, mode,
                                                   sessions[mode].tables).values)
        if not np.array_equal(t_words_to_np(sessions[mode].dplan.words(ev, mode)),
                              want):
            raise AssertionError(f"numpy backend {mode}: delivered words "
                                 "differ from the NumPy executor")
    k1d_launches = hold_xor_routes(torch, sessions["coded"], ev, "er-76k")

    # The path: reset the counts, run every program in every mode, read.
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = {(mode, name): sessions[mode].with_program(prog).run(10)
            for mode in SPMV_MODES for name, prog in progs.items()}
    torch.cuda.synchronize()
    info["run_s"] = time.perf_counter() - t0
    launches = info["launches"] = dict(_build.LAUNCHES)
    for name in PLAN_KERNELS + ("segment_reduce",):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the er-76k "
                                 "numpy-backend path")
    oracle = {name: algo.reference_run(prog, g, 10, path="sparse")
              for name, prog in progs.items()}
    for (mode, name), res in runs.items():
        err = check_state(res.state.cpu().numpy(), oracle[name], name,
                          f"numpy backend {mode} {name}")
        if err is not None:
            info[f"{mode}_{name}_max_rel_err"] = err
        bits = 0 if mode == "single" else engine._plan_bits(plan, mode)
        if res.shuffle_bits != bits * res.batch * 10:
            raise AssertionError(f"numpy backend {mode} {name}: shuffle bits "
                                 "are not exact")
    for mode in SPMV_MODES[1:]:
        info[mode] = iteration_profile(torch, sessions[mode])
    coded = sessions["coded"]
    ev4 = progs["ppr"].map_edge_values_t(coded._dg, torch.as_tensor(
        progs["ppr"].init(g), device=dev)).contiguous()
    recs = plan_records(torch, coded, ev, ev4, "er-76k")
    record_launches(recs, launches, "the er-76k numpy-backend coded path")
    info["xor_kernel_route_launches"] = k1d_launches
    return recs + [xor_dense_record(torch, coded, ev, k1d_launches)], info


def modes_scale(torch, dev, scale: tuple, fused: dict) -> tuple[dict, dict]:
    """Pagerank in uncoded / coded / coded-fast under backend="numpy" at
    scale, 10 iterations, with the fused route's numbers beside: the
    paper's coded-against-uncoded comparison on the card, each mode's
    steady time, device busy, spans and peak memory logged beside the
    fused route's. The plan kernels' records at these shapes (bitwise
    their plain versions at B = 1 and 4) with the coded run's launches;
    the three XOR routes bitwise the NumPy executor there, and K1's
    dense-form record with the "xor-kernel" route's launches."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.kernels import _build

    g, alloc, plan, want = scale
    smi = nvidia_smi()
    keys = ("steady_s_per_iter", "host_enqueue_s_per_iter",
            "device_busy_s_per_iter", "device_idle_share", "phase_s_per_iter",
            "pagerank_s_per_iter", "peak_mem_bytes")
    info = {"fused": {k: fused[k] for k in keys}}
    for mode in SPMV_MODES[1:]:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = engine.compile(algo.pagerank(), g, alloc, mode, path="auto",
                             backend="numpy", plan=plan, device=dev)
        m = info[mode] = {"session_s": time.perf_counter() - t0,
                          "bits_per_iter": engine._plan_bits(plan, mode)}
        t0 = time.perf_counter()
        eng.run(1)
        torch.cuda.synchronize()
        m["first_iter_s"] = time.perf_counter() - t0
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = eng.run(10)
        torch.cuda.synchronize()
        m["pagerank_s_per_iter"] = (time.perf_counter() - t0) / 10
        m["launches"] = launches = dict(_build.LAUNCHES)
        m["pagerank_max_rel_err"] = check_pagerank(
            res.state.cpu().numpy(), want, f"numpy backend {mode} at scale")
        if res.shuffle_bits != engine._plan_bits(plan, mode) * 10:
            raise AssertionError(f"numpy backend {mode} at scale: shuffle "
                                 "bits are not exact")
        m.update(iteration_profile(torch, eng))
        m["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        log(f"modes phase, scale, numpy {mode}: steady "
            f"{m['steady_s_per_iter'] * 1e3:.4f} ms/iter, device busy "
            f"{busy_ms(m)} ms/iter, spans "
            f"{json.dumps({k: v * 1e3 for k, v in m['phase_s_per_iter'].items()})}"
            f" ms, peak {m['peak_mem_bytes']} B, session {m['session_s']:.4f} s,"
            f" first iteration {m['first_iter_s']:.4f} s | {smi}")
        if mode == "coded":
            pr = algo.pagerank()
            ev = pr.map_edge_values_t(eng._dg, torch.as_tensor(
                pr.init(g), device=dev)).contiguous()
            state4 = torch.from_numpy(np.random.default_rng(4).random(
                (g.n, 4), dtype=np.float32)).to(dev)
            ev4 = pr.map_edge_values_t(eng._dg, state4).contiguous()
            recs = plan_records(torch, eng, ev, ev4, "scale")
            record_launches(recs, launches,
                            "the scale numpy-backend coded path")
            k1d_launches = hold_xor_routes(torch, eng, ev, "scale")
            m["xor_kernel_route_launches"] = k1d_launches
            recs.append(xor_dense_record(torch, eng, ev, k1d_launches))
            del ev, ev4, state4        # out of coded-fast's peak memory
        del eng
    log(f"modes phase, scale, fused: steady "
        f"{fused['steady_s_per_iter'] * 1e3:.4f} ms/iter, device busy "
        f"{busy_ms(fused)} ms/iter, peak "
        f"{fused['peak_mem_bytes']} B | {smi}")
    return recs, info


def modes_dense(torch, dev) -> dict:
    """The dense path on the dense phase's graph (ER, n = 16,384, p = 0.01,
    seed 5, padded to 16,392 for K = 4, r = 2): pagerank and sssp in every
    mode, 3 iterations, against the dense NumPy oracle (the coded runs
    launch both plan kernels on tables into the [n, n] values' storage);
    the peak device memory of these runs. Then both plan kernels bitwise
    their plain versions on each program's Map output as the Map hands it
    over (pagerank's a broadcast row, sssp's a transposed matrix, indices
    near 2**28), through the coded session's tables for that layout."""
    from repro_torch import graphs
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.allocation import divisible_n, er_allocation
    from repro_torch.core.shuffle_plan import compile_plan_csr
    from repro_torch.kernels import _build

    g = graphs.erdos_renyi(DENSE_N, 0.01, seed=5)
    n = divisible_n(g.n, 4, 2)
    g = g.padded(n)
    alloc = er_allocation(n, 4, 2)
    plan = compile_plan_csr(g.csr, alloc)
    info = {"n": n, "nnz": g.csr.nnz, "M": int(plan.all_k.size)}
    t0 = time.perf_counter()
    progs = {"pagerank": algo.pagerank(), "sssp": algo.sssp(0)}
    oracle = {name: algo.reference_run(p, g, 3, path="dense")
              for name, p in progs.items()}
    info["oracle_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for mode in SPMV_MODES:
        eng = engine.compile(algo.pagerank(), g, alloc, mode, path="dense",
                             backend="numpy", plan=plan, device=dev)
        for name, prog in progs.items():
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            res = eng.with_program(prog).run(3)
            torch.cuda.synchronize()
            if mode == "coded":
                info[f"coded_{name}_launches"] = record_launches(
                    [{"name": k} for k in PLAN_KERNELS], dict(_build.LAUNCHES),
                    f"the dense coded {name} path")
                coded = eng
            info[f"{mode}_{name}_s_per_iter"] = (time.perf_counter() - t0) / 3
            err = check_state(res.state.cpu().numpy(), oracle[name], name,
                              f"dense path {mode} {name}")
            if err is not None:
                info[f"{mode}_{name}_max_rel_err"] = err
            bits = 0 if mode == "single" else engine._plan_bits(plan, mode)
            if res.shuffle_bits != bits * 3:
                raise AssertionError(f"dense path {mode} {name}: shuffle "
                                     "bits are not exact")
        del eng
    info["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    info["mem_before_bytes"] = int(base)
    for name, prog in progs.items():
        values = prog.map_values_t(coded._dd, torch.as_tensor(prog.init(g),
                                                             device=dev))
        src, t, *_, err = hold_plan_kernels(torch, coded.dplan, values,
                                            f"the dense {name} layout",
                                            dense=True)
        info[f"coded_{name}_held"] = {
            "strides": list(values.stride()), "n_src": int(src.shape[0]),
            "max_entry": int(t.slot_e[t.slot_e < src.shape[0]].max()),
            "max_abs_err": list(err)}
        del values, src, t
    return info


def modes_coded_ref(torch, dev) -> dict:
    """Mode coded-ref (the literal per-group reference, on the host, with
    the Map and Reduce on the card) on ER n = 2,000 (padded to 2,004),
    p = 0.02, seed 5, K = 4, r = 2, for 2 iterations: its delivered dict
    equal to mode coded's on the dense path, its sssp state bitwise the
    dense coded state, both against the dense NumPy oracle."""
    from repro_torch import graphs
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.allocation import divisible_n, er_allocation
    from repro_torch.core.coded_shuffle import run_coded

    g = graphs.erdos_renyi(2_000, 0.02, seed=5)
    n = divisible_n(g.n, 4, 2)
    g = g.padded(n)
    alloc = er_allocation(n, 4, 2)
    info = {"n": n, "nnz": g.csr.nnz}
    dense = engine.compile(algo.pagerank(), g, alloc, "coded", path="dense",
                           backend="numpy", device=dev)
    pr = algo.pagerank()
    values = pr.map_values_t(g.dense_device_view(dev),
                             torch.as_tensor(pr.init(g), device=dev))
    host = values.contiguous().cpu().numpy()
    ref = run_coded(g.adj, host, alloc)
    bits = ref.bits_sent + engine._unicast_leftovers(g, alloc, host,
                                                     ref.delivered)
    res = dense.dplan.execute(values, "coded")
    same_delivered(res.delivered, ref.delivered, "coded-ref vs dense coded")
    if bits != res.bits_sent:
        raise AssertionError("coded-ref bits differ from the dense coded bits")
    cref = engine.compile(algo.pagerank(), g, alloc, "coded-ref", path="auto",
                          backend="numpy", device=dev)
    for name, prog in (("pagerank", pr), ("sssp", algo.sssp(0))):
        t0 = time.perf_counter()
        got = cref.with_program(prog).run(2)
        torch.cuda.synchronize()
        info[f"{name}_s_per_iter"] = (time.perf_counter() - t0) / 2
        want = dense.with_program(prog).run(2)
        oracle = algo.reference_run(prog, g, 2, path="dense")
        for r_, what in ((got, "coded-ref"), (want, "dense coded")):
            err = check_state(r_.state.cpu().numpy(), oracle, name,
                              f"{what} {name}")
            if err is not None:
                info[f"{what}_{name}_max_rel_err"] = err
        if name == "sssp" and not torch.equal(got.state.view(torch.int32),
                                              want.state.view(torch.int32)):
            raise AssertionError("coded-ref sssp not bitwise the dense coded")
        if got.shuffle_bits != want.shuffle_bits:
            raise AssertionError("coded-ref shuffle bits differ from coded")
    return info


def modes_phase(torch, dev, er: tuple, scale: tuple,
                fused_scale: dict) -> tuple[dict, dict, dict]:
    """The reference's default engine (backend="numpy") on the card: the
    er-76k and scale sessions' graphs and plans (passed as `plan=`), the
    dense path and coded-ref. Returns the plan kernels' and K1's
    dense-form records at the er-76k and scale shapes and the info."""
    rec_er, info_er = modes_er76k(torch, dev, er)
    log(f"modes phase, er-76k ok: {json.dumps(info_er)}")
    rec_scale, info_scale = modes_scale(torch, dev, scale, fused_scale)
    log(f"modes phase, scale ok: {json.dumps(info_scale)}")
    info_dense = modes_dense(torch, dev)
    log(f"modes phase, dense path ok: {json.dumps(info_dense)}")
    info_ref = modes_coded_ref(torch, dev)
    log(f"modes phase, coded-ref ok: {json.dumps(info_ref)}")
    return rec_er, rec_scale, {"er76k": info_er, "scale": info_scale,
                               "dense": info_dense, "coded_ref": info_ref}


# ---------------------------------------------------------------------------
# elastic phase: failures, graph deltas, fault schedules, checkpoints and the
# query service on the plan kernels and the packed K1 / K2
# ---------------------------------------------------------------------------


ELASTIC_DELTA = 5_000     # inserted and deleted undirected edges at scale
CKPT_N = 80_136           # er-76k padded for K = 4 and K' = 8 at r = 2
SERVE_QUERIES, SERVE_MAX_BATCH = 64, 4


def traced(fn):
    """Run `fn` under an enabled tracer; returns (its result, wall seconds,
    seconds per span name summed over its spans)."""
    from repro_torch.obs import Tracer, set_tracer

    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        set_tracer(prev)
    wall = time.perf_counter() - t0
    spans: dict = {}
    for sp in tracer.spans():
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration_s
    return out, wall, spans


def synced(torch, fn):
    """(fn(), seconds) with the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_plan(a, b, skip=(), what: str = "") -> None:
    """Every array of two ShufflePlans equal in dtype, shape and value."""
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{what}: plan field {f.name} differs")
        elif x != y:
            raise AssertionError(f"{what}: plan field {f.name} differs")


def seeded_delta(g, seed: int, nins: int, ndel: int):
    """An EdgeDelta of `ndel` existing and `nins` new undirected edges of
    `g`'s real vertices, drawn from `seed`."""
    from repro_torch.graphs import EdgeDelta

    rng = np.random.default_rng(seed)
    csr, n = g.csr, g.n
    upper = np.flatnonzero(csr.rows < csr.indices)
    pick = rng.choice(upper, size=ndel, replace=False)
    dels = np.stack([csr.rows[pick], csr.indices[pick]], axis=1)
    key = csr.rows.astype(np.int64) * n + csr.indices
    cand = rng.integers(0, g.params.get("padded_from", n), size=(4 * nins, 2))
    lo, hi = cand.min(axis=1), cand.max(axis=1)
    k = lo * n + hi
    pos = np.minimum(np.searchsorted(key, k), key.size - 1)
    ok = (lo != hi) & (key[pos] != k)
    _, first = np.unique(k[ok], return_index=True)
    take = np.sort(first)[:nins]
    ins = np.stack([lo[ok][take], hi[ok][take]], axis=1)
    if ins.shape[0] != nins:
        raise AssertionError("could not draw the delta's inserted edges")
    return EdgeDelta.for_graph(g, insert=ins, delete=dels)


def same_state(torch, a, b, what: str) -> None:
    if not bitwise(torch, a, b):
        raise AssertionError(f"{what}: states not bitwise equal")


def elastic_fail(torch, dev, healthy, runs: dict, failed: tuple,
                 fresh_compile: bool) -> tuple[list[dict], dict]:
    """`healthy.fail(failed)` on backend="numpy", mode coded, at scale: host
    repair (span `plan.repair`) and session build times, against a fresh
    `compile_plan_csr` on the degraded allocation when `fresh_compile`
    (its arrays equal to the repair's but `col_sender` while |failed| < r;
    from r on the repair also demotes pairs, which a fresh compile does
    not); the first
    post-failure iteration; pagerank and sssp for 10 iterations, launch
    counts read over them, states bitwise the healthy session's, bits the
    host plan's plus the hand-over; the plan kernels bitwise their plain
    versions on the repaired tables (records at B = 1, and at B = 4 under
    "b4"); steady ms, device busy and idle share."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core.shuffle_plan import compile_plan_csr
    from repro_torch.kernels import _build

    what = f"elastic fail{failed}"
    deg, build_s, spans = traced(lambda: healthy.fail(failed))
    rs, plan = deg.recovery, deg.plan
    info = {"repair_s": spans["plan.repair"], "session_build_s": build_s,
            "handover_bits": rs.handover_bits,
            "demoted_pairs": rs.demoted_pairs,
            "remapped_vertices": rs.remapped_vertices,
            "M": int(plan.all_k.size), "C": int(plan.slot_pair.shape[0]),
            "L": int(plan.left_k.size),
            "dead_receivers_deliveries": int(np.diff(plan.ptr)[list(failed)].sum())}
    if info["dead_receivers_deliveries"] or np.isin(plan.col_sender, failed).any():
        raise AssertionError(f"{what}: a dead server still sends or receives")
    if (rs.demoted_pairs > 0) != (len(failed) >= healthy.alloc.r):
        raise AssertionError(f"{what}: demotions {rs.demoted_pairs}")
    if fresh_compile:
        t0 = time.perf_counter()
        fresh = compile_plan_csr(healthy.g.csr, deg.alloc)
        info["fresh_compile_s"] = time.perf_counter() - t0
        if len(failed) < healthy.alloc.r:    # the repair contract's regime
            same_plan(plan, fresh, skip=("col_sender",), what=what)
        del fresh
    state = torch.as_tensor(healthy.program.init(healthy.g), device=dev)
    _, info["first_iter_s"] = synced(torch, lambda: deg.run(1, state=state))
    info["time_to_recover_s"] = info["session_build_s"] + info["first_iter_s"]
    _build.LAUNCHES.clear()
    got = {"pagerank": deg.run(10),
           "sssp": deg.with_program(algo.sssp(0)).run(10)}
    torch.cuda.synchronize()
    launches = info["launches"] = dict(_build.LAUNCHES)
    bits = plan.coded_bits + plan.leftover_bits + rs.handover_bits
    for name, res in got.items():
        same_state(torch, res.state, runs[name].state, f"{what} {name}")
        if res.shuffle_bits != 10 * bits:
            raise AssertionError(f"{what} {name}: bits are not the host "
                                 "plan's plus the hand-over")
    info["bits_per_iter"] = bits
    pr = algo.pagerank()
    ev = pr.map_edge_values_t(deg._dg, state).contiguous()
    state4 = torch.from_numpy(np.random.default_rng(4).random(
        (deg.g.n, 4), dtype=np.float32)).to(dev)
    ev4 = pr.map_edge_values_t(deg._dg, state4).contiguous()
    recs = plan_records(torch, deg, ev, ev4, f"{what}'s repaired tables")
    record_launches(recs, launches, f"the {what} path")
    info.update(iteration_profile(torch, deg))
    return recs, info


def elastic_update(torch, dev, scale: tuple, healthy, runs: dict) -> dict:
    """`update(delta)` at scale on backend "numpy" and "fused", with a seeded
    delta of ELASTIC_DELTA inserted and deleted edges: host `apply_delta`
    (span `plan.apply_delta`) and the session update against a fresh
    `compile_plan_csr` on the mutated graph and a fresh session build; the
    plan array-identical to the fresh one; pagerank and sssp for 10
    iterations on both updated sessions bitwise the fresh session's (and
    pagerank within rtol 1e-5 of the NumPy oracle); K1 / K2 / K3 held
    against their plain versions on the rebound packed tables, the fused
    rebind's time (span `fused.rebind`: partition, pack, upload) against a
    fresh fused session's build; each route's launch counts."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.graph_models import Graph
    from repro_torch.core.shuffle_plan import compile_plan_csr
    from repro_torch.kernels import _build

    g, alloc, plan, _ = scale
    delta = seeded_delta(g, 11, ELASTIC_DELTA, ELASTIC_DELTA)
    info = {"inserted": delta.num_insert, "deleted": delta.num_delete}
    upd, info["numpy_update_s"], spans = traced(lambda: healthy.update(delta))
    info["apply_delta_s"] = spans["plan.apply_delta"]
    st = upd.delta_stats
    info.update(inserted_values=st.inserted_values,
                deleted_values=st.deleted_values)
    g2 = Graph(model=g.model, params=dict(g.params), csr=upd.g.csr)
    t0 = time.perf_counter()
    fresh_plan = compile_plan_csr(g2.csr, alloc)
    info["fresh_compile_s"] = time.perf_counter() - t0
    same_plan(upd.plan, fresh_plan, what="elastic update")
    t0 = time.perf_counter()
    fresh = engine.compile(algo.pagerank(), g2, alloc, "coded", path="sparse",
                           backend="numpy", plan=fresh_plan, device=dev)
    info["fresh_numpy_session_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused0 = engine.compile(algo.pagerank(), g, alloc, "coded", path="sparse",
                            backend="fused", plan=plan, device=dev)
    info["fused_session_s"] = time.perf_counter() - t0
    fupd, info["fused_update_s"], spans = traced(lambda: fused0.update(delta))
    info["fused_rebind_s"] = spans["fused.rebind"]
    del fused0
    t0 = time.perf_counter()
    fresh_fused = engine.compile(algo.pagerank(), g2, alloc, "coded",
                                 path="sparse", backend="fused",
                                 plan=fresh_plan, device=dev)
    info["fresh_fused_session_s"] = time.perf_counter() - t0
    for k, t in fresh_fused.fused.tables.items():
        if not torch.equal(t, fupd.fused.tables[k]):
            raise AssertionError(f"elastic update: rebound table {k} differs "
                                 "from a fresh fused session's")
    del fresh_fused
    want = {"pagerank": fresh.run(10),
            "sssp": fresh.with_program(algo.sssp(0)).run(10)}
    oracle = algo.reference_run(algo.pagerank(), g2, 10)
    info["pagerank_max_rel_err"] = check_pagerank(
        want["pagerank"].state.cpu().numpy(), oracle, "elastic update fresh")
    for route, eng in (("numpy", upd), ("fused", fupd)):
        _build.LAUNCHES.clear()
        got = {"pagerank": eng.run(10),
               "sssp": eng.with_program(algo.sssp(0)).run(10)}
        torch.cuda.synchronize()
        launches = info[f"{route}_launches"] = dict(_build.LAUNCHES)
        names = (("xor_encode", "xor_decode") if route == "fused"
                 else PLAN_KERNELS) + ("segment_reduce",)
        for name in names:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{name} never launched on the updated "
                                     f"{route} session")
        for name, res in got.items():
            same_state(torch, res.state, want[name].state,
                       f"elastic update {route} {name}")
            if res.shuffle_bits != want[name].shuffle_bits:
                raise AssertionError(f"elastic update {route} {name}: bits")
    pr = algo.pagerank()
    ev = pr.map_edge_values_t(fupd._dg, torch.as_tensor(
        pr.init(fupd.g), device=dev)).contiguous()
    held = hold_session(torch, fupd, ev, "the rebound tables",
                        general_tables(torch, fupd))
    info["rebound_max_abs_err"] = held["err"]
    dp = upd.dplan
    hold_plan_kernels(torch, dp, ev, "the patched plan's tables")
    info.update({f"{route}_{k}": v for route, eng in (("numpy", upd),
                                                       ("fused", fupd))
                 for k, v in iteration_profile(torch, eng).items()
                 if k in ("steady_s_per_iter", "device_busy_s_per_iter",
                          "device_idle_share")})
    return info


def elastic_schedule(torch, dev, er: tuple) -> dict:
    """A FaultSchedule at er-76k, backend numpy, mode coded: server 1 crashes
    at iteration 3 and recovers at 7, over 10 iterations of pagerank and of
    sssp. The bits equal the host's accounting (3 + 3 healthy iterations,
    4 repaired ones with their hand-over), the FaultLog's hand-over and
    recovery bits too, and the final states are bitwise the uninterrupted
    run's."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.faults import FaultSchedule

    g, alloc, plan, _ = er
    eng = engine.compile(algo.pagerank(), g, alloc, "coded", path="sparse",
                         backend="numpy", plan=plan, device=dev)
    sched = FaultSchedule([(3, "crash", (1,)), (7, "recover", (1,))])
    rep, _, rs = plan.repair(g.csr, alloc, (1,))
    healthy_bits = plan.coded_bits + plan.leftover_bits
    degraded_bits = rep.coded_bits + rep.leftover_bits + rs.handover_bits
    want_bits = 6 * healthy_bits + 4 * degraded_bits
    info = {"healthy_bits_per_iter": healthy_bits,
            "degraded_bits_per_iter": degraded_bits}
    for name, prog in (("pagerank", algo.pagerank()), ("sssp", algo.sssp(0))):
        e = eng.with_program(prog)
        clean = e.run(10)
        res, info[f"{name}_s"] = synced(
            torch, lambda: e.run(10, fault_schedule=sched))
        same_state(torch, res.state, clean.state, f"elastic schedule {name}")
        log_ = res.faults
        if (res.shuffle_bits != want_bits or log_.crashes != 1
                or log_.recoveries != 1
                or log_.handover_bits != 4 * rs.handover_bits
                or log_.recovery_bits != degraded_bits):
            raise AssertionError(f"elastic schedule {name}: bits "
                                 f"{res.shuffle_bits} / log {log_} against "
                                 f"the host's {want_bits}")
        info[f"{name}_bits"] = res.shuffle_bits
    info["clean_bits"] = 10 * healthy_bits
    return info


def elastic_checkpoints(torch, dev, er: tuple) -> dict:
    """Checkpoints at er-76k padded to n = CKPT_N (divisible for K = 4 and
    K' = 8 at r = 2): sssp and pagerank, 10 iterations with
    checkpoint_every=2 into a temporary directory, then `restore` at epoch
    6 and resume for 4: bitwise the uninterrupted run at K = 4 (and the
    same bits) and elastically at K' = 8. The save cost per iteration:
    the checkpointed run's time less the plain run's, over 10."""
    import tempfile

    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.allocation import er_allocation
    from repro_torch.core.checkpoint import SessionCheckpointer

    g = er[0].padded(CKPT_N)
    alloc = er_allocation(CKPT_N, 4, 2)
    info = {"n": CKPT_N}
    for name, prog in (("sssp", algo.sssp(0)), ("pagerank", algo.pagerank())):
        eng = engine.compile(prog, g, alloc, "coded", path="sparse",
                             backend="numpy", device=dev)
        full, plain_s = synced(torch, lambda: eng.run(10))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            ck = SessionCheckpointer(d, keep=5)
            saved, ck_s = synced(torch, lambda: eng.run(
                10, checkpoint=ck, checkpoint_every=2))
            ck.wait()
            same_state(torch, saved.state, full.state, f"checkpointed {name}")
            info[f"{name}_save_s_per_iter"] = (ck_s - plain_s) / 10
            for K in (4, 8):
                e2, ckpt = engine.restore(d, prog, g, K=K, epoch=6,
                                          mode="coded", path="sparse",
                                          backend="numpy", device=dev)
                res = e2.run(4, state=ckpt.state, start_iter=ckpt.iteration,
                             start_bits=ckpt.shuffle_bits)
                same_state(torch, res.state, full.state,
                           f"restored {name} at K = {K}")
                if K == 4 and res.shuffle_bits != full.shuffle_bits:
                    raise AssertionError(f"restored {name}: bits differ")
                info[f"{name}_K{K}_bits"] = res.shuffle_bits
    return info


def elastic_service(torch, dev, er: tuple) -> dict:
    """GraphService at er-76k: SERVE_QUERIES sssp queries (10 iterations
    each) submitted at once through max_batch = SERVE_MAX_BATCH, server 1
    crashing at the batch boundary half way through: queries/s, latency
    percentiles, mean batch; every column bitwise the standalone sssp run
    of its root."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.serve import GraphService

    g, alloc, plan, _ = er
    roots = [int(x) for x in np.random.default_rng(64).choice(
        g.params.get("padded_from", g.n), size=SERVE_QUERIES, replace=False)]
    crash_at = SERVE_QUERIES // SERVE_MAX_BATCH // 2
    sched = FaultSchedule([(crash_at, "crash", (1,))])
    with GraphService(g, alloc, plan=plan, max_batch=SERVE_MAX_BATCH,
                      max_wait_s=0.002, fault_schedule=sched,
                      device=dev) as svc:
        svc.submit("sssp", roots[0], iters=10).result(timeout=600)  # warm
        t0 = time.perf_counter()
        futs = [svc.submit("sssp", s, iters=10) for s in roots]
        cols = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    st = svc.stats
    info = {"queries": SERVE_QUERIES, "wall_s": wall,
            "queries_per_s": SERVE_QUERIES / wall,
            "p50_s": st.latency_p50, "p95_s": st.latency_p95,
            "p99_s": st.latency_p99, "mean_batch": st.mean_batch,
            "batches": st.batches, "crashes": st.crashes, "crash_at": crash_at,
            "shuffle_bits": st.shuffle_bits}
    if st.crashes != 1 or st.queries != SERVE_QUERIES + 1:
        raise AssertionError(f"elastic service: {st}")
    eng = engine.compile(algo.sssp(0), g, alloc, "coded", path="sparse",
                         backend="numpy", plan=plan, device=dev)
    for s, col in zip(roots, cols):
        want = eng.with_program(algo.sssp(s)).run(10).state
        same_state(torch, col, want, f"service sssp({s})")
    return info


def elastic_phase(torch, dev, er: tuple, scale: tuple, smi: str) -> dict:
    """The sessions that change, on the card (see the module docstring)."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine

    g, alloc, plan, want = scale
    t0 = time.perf_counter()
    healthy = engine.compile(algo.pagerank(), g, alloc, "coded",
                             path="sparse", backend="numpy", plan=plan,
                             device=dev)
    info = {"healthy_session_s": time.perf_counter() - t0}
    runs = {"pagerank": healthy.run(10),
            "sssp": healthy.with_program(algo.sssp(0)).run(10)}
    info["healthy_pagerank_max_rel_err"] = check_pagerank(
        runs["pagerank"].state.cpu().numpy(), want, "elastic healthy")
    info["healthy"] = {k: v for k, v in iteration_profile(
        torch, healthy).items() if k != "phase_s_per_iter"}
    records = {}
    for failed in ((1,), (0, 1)):
        key = "fail" + "".join(map(str, failed))
        records[key], info[key] = elastic_fail(
            torch, dev, healthy, runs, failed, fresh_compile=failed == (1,))
        f = info[key]
        log(f"elastic phase, scale fail{failed}: repair "
            f"{f['repair_s']:.3f} s (compile_plan_csr "
            f"{f.get('fresh_compile_s', float('nan')):.3f} s), session build "
            f"{f['session_build_s']:.3f} s, first iteration "
            f"{f['first_iter_s'] * 1e3:.3f} ms, steady "
            f"{f['steady_s_per_iter'] * 1e3:.4f} ms/iter (healthy "
            f"{info['healthy']['steady_s_per_iter'] * 1e3:.4f}), device busy "
            f"{busy_ms(f)} ms/iter (healthy "
            f"{busy_ms(info['healthy'])}), "
            f"demoted {f['demoted_pairs']}, handover {f['handover_bits']} "
            f"bits | {smi}")
        log("elastic phase, plan kernels on the repaired tables: "
            + json.dumps(records[key]))
    info["update"] = u = elastic_update(torch, dev, scale, healthy, runs)
    log(f"elastic phase, scale update(+{u['inserted']}, -{u['deleted']}): "
        f"apply_delta {u['apply_delta_s']:.3f} s (compile_plan_csr "
        f"{u['fresh_compile_s']:.3f} s), numpy update "
        f"{u['numpy_update_s']:.3f} s (fresh session "
        f"{u['fresh_numpy_session_s']:.3f} s), fused rebind "
        f"{u['fused_rebind_s']:.3f} s of update {u['fused_update_s']:.3f} s "
        f"(fresh fused session {u['fresh_fused_session_s']:.3f} s) | {smi}")
    del healthy, runs
    info["schedule"] = elastic_schedule(torch, dev, er)
    log(f"elastic phase, er-76k fault schedule: {json.dumps(info['schedule'])}")
    info["checkpoint"] = elastic_checkpoints(torch, dev, er)
    log(f"elastic phase, checkpoints: {json.dumps(info['checkpoint'])}")
    info["service"] = s = elastic_service(torch, dev, er)
    log(f"elastic phase, service: {s['queries_per_s']:.1f} queries/s, p50 "
        f"{s['p50_s'] * 1e3:.2f} ms, p95 {s['p95_s'] * 1e3:.2f} ms, p99 "
        f"{s['p99_s'] * 1e3:.2f} ms, mean batch {s['mean_batch']:.2f} | {smi}")
    info["records"] = records
    return info


# ---------------------------------------------------------------------------
# dist phase: the fused exchange on a torch.distributed group (NCCL, world 1)
# ---------------------------------------------------------------------------


FUSED_KERNELS = ("xor_encode", "xor_decode", "segment_reduce")


def pagerank_and_sssp() -> dict:
    from repro_torch.core import algorithms as algo

    return {"pagerank": algo.pagerank(), "sssp": algo.sssp(0)}


def need_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on {path}")


def dist_cell(torch, dev, what: str, cell: tuple, group) -> dict:
    """The fused exchange on `group` against the virtual route on one
    session (graph, allocation, plan, oracle pagerank): one exchange's
    delivered words at B = 1 and 4 and pagerank / sssp for 10 iterations
    bitwise, exact bits, K1 / K2 / K3 launched on the group route's run
    (counts reset just before it), steady time, device busy and the NCCL
    collectives' device time per iteration (their `nccl:` ranges on the
    device's timeline; one rank's all-gather is a device-to-device
    copy)."""
    from repro_torch.core import engine
    from repro_torch.kernels import _build

    g, alloc, plan, want = cell
    progs = pagerank_and_sssp()
    info = {}
    sessions = {}
    for route, opts in (("virtual", {}), ("group", {"group": group})):
        t0 = time.perf_counter()
        sessions[route] = engine.compile(progs["pagerank"], g, alloc, plan=plan,
                                         path="sparse", backend="fused",
                                         device=dev, **opts)
        info[f"{route}_session_s"] = time.perf_counter() - t0
    virt, grp = sessions["virtual"], sessions["group"]
    pr = progs["pagerank"]
    state4 = torch.from_numpy(np.random.default_rng(4).random(
        (g.n, 4), dtype=np.float32)).to(dev)
    for st in (torch.as_tensor(pr.init(g), device=dev), state4):
        ev = pr.map_edge_values_t(virt._dg, st).contiguous()
        if not torch.equal(grp.fused.exchange(ev), virt.fused.exchange(ev)):
            raise AssertionError(f"dist {what}: the group's delivered words "
                                 "differ from the virtual route's")
    _build.LAUNCHES.clear()
    runs = {name: grp.with_program(p).run(10) for name, p in progs.items()}
    torch.cuda.synchronize()
    info["launches"] = launches = dict(_build.LAUNCHES)
    need_launches(launches, FUSED_KERNELS, f"the dist {what} path")
    for name, p in progs.items():
        ref = virt.with_program(p).run(10)
        if not torch.equal(runs[name].state.view(torch.int32),
                           ref.state.view(torch.int32)):
            raise AssertionError(f"dist {what} {name}: not bitwise the "
                                 "virtual route's state")
        if runs[name].shuffle_bits != ref.shuffle_bits:
            raise AssertionError(f"dist {what} {name}: bits differ")
    info["pagerank_max_rel_err"] = check_pagerank(
        runs["pagerank"].state.cpu().numpy(), want, f"dist {what}")
    for route, eng in sessions.items():
        info[route] = iteration_profile(torch, eng)
    state = torch.as_tensor(pr.init(g), device=dev)
    win = profiled_window(torch, lambda: grp.run(10, state=state))
    info["nccl_s_per_iter"] = None
    info["nccl_profile_incomplete"] = win["profile_incomplete"]
    if win["kernels"] is not None:
        by_name: dict = {}
        for e in win["kernels"]:
            by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                    + e.time_range.elapsed_us() / 1e3 / 10)
        info["group_ms_per_iter_by_kernel"] = sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]
        nccl = [e for e in win["annotations"] if e.name.startswith("nccl:")]
        info["nccl_ranges"] = sorted({e.name for e in nccl})
        info["nccl_s_per_iter"] = sum(e.time_range.elapsed_us()
                                      for e in nccl) / 1e6 / 10
    return info


def dist_phase(torch, dev, er: tuple, scale: tuple, smi: str) -> dict:
    """The fused route with `group=` on a one-rank NCCL group (a FileStore
    under build/, so no port is opened) against the virtual route, on the
    er-76k session (K = 4, r = 2) and at scale. NCCL needs one card per
    rank, so one card runs one rank of all K servers; the group is
    destroyed at the end."""
    import torch.distributed as dist

    store = ROOT / "build" / "dist-store"
    store.unlink(missing_ok=True)
    store.parent.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        info = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        for what, cell in (("er-76k", er), ("scale", scale)):
            c = info[what] = dist_cell(torch, dev, what, cell, dist.group.WORLD)
            nccl = c["nccl_s_per_iter"]
            log(f"dist phase, {what}: NCCL world 1 bitwise the virtual route;"
                f" steady {c['group']['steady_s_per_iter'] * 1e3:.4f} ms/iter "
                f"(virtual {c['virtual']['steady_s_per_iter'] * 1e3:.4f}), "
                f"device busy {busy_ms(c['group'])} ms/iter (virtual "
                f"{busy_ms(c['virtual'])}), NCCL collectives "
                f"{'not measured' if nccl is None else f'{nccl * 1e3:.4f}'} "
                f"ms/iter {c.get('nccl_ranges')}, launches {c['launches']} | "
                f"{smi}")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    log(f"dist phase ok: {json.dumps(info)}")
    return info


# ---------------------------------------------------------------------------
# table2 phase: the paper's Table II through the registry, then the examples
# ---------------------------------------------------------------------------


EXAMPLES = ("port_quickstart.py", "port_coded_pagerank.py")
EXAMPLE_TIMEOUT_S = 300


def table2_records(cache: pathlib.Path) -> dict:
    """`run_table2` on karate and er-76k (synthesized into `cache`, written
    as an edge list, read back with its largest-CC step), every record but
    its timings held against TABLE2_EXPECTED, the cached file against the
    reference's sha256."""
    from repro_torch.experiments import run_table2, to_markdown

    t0 = time.perf_counter()
    result = run_table2(("karate", "er-76k"), K=TABLE2_K, r_grid=TABLE2_R,
                        cache_dir=cache, download=False)
    info = {"run_table2_s": time.perf_counter() - t0,
            "times": [{k: row[k] for k in ("dataset", "r", "load_s", "compile_s")}
                      for row in result["rows"]]}
    digest = hashlib.sha256((cache / "er-76k.edges").read_bytes()).hexdigest()
    if digest != ER76K_SHA256:
        raise AssertionError(f"er-76k cache file sha256 {digest} is not the "
                             "reference's")
    if len(result["rows"]) != len(TABLE2_EXPECTED):
        raise AssertionError("table2: wrong number of records")
    for row in result["rows"]:
        got = tuple(row[k] for k in TABLE2_FIELDS)
        want = TABLE2_EXPECTED[(row["dataset"], row["r"])]
        if got != want:
            raise AssertionError(f"table2 {row['dataset']} r = {row['r']}: "
                                 f"{got} is not the reference's {want}")
    log("table2 phase, the port's Table II, equal to the reference's:\n"
        + to_markdown(result))
    return info


def table2_engine(torch, dev, cache: pathlib.Path, smi: str) -> dict:
    """Coded pagerank and sssp for 10 iterations on the registry-loaded
    er-76k at K = 6, r = 2 (padded by `graphs.allocate`) on backend
    "numpy" and on "fused" (path "sparse"): pagerank within rtol 1e-5 of
    the host oracle, sssp bitwise, exact bits, each route's kernels
    launched (counts reset just before its run), then held against their
    plain versions at these shapes on pagerank's Map output at B = 1 and a
    seeded B = 4 one (`hold_session` on fused, `hold_plan_kernels` on
    numpy), steady time and busy."""
    from repro_torch import graphs
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.shuffle_plan import compile_plan_csr
    from repro_torch.experiments import registry
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    g = registry.load("er-76k", cache_dir=cache)
    gp, alloc = graphs.allocate(g, TABLE2_K, 2)
    info = {"load_s": time.perf_counter() - t0, "n": g.n, "n_padded": gp.n,
            "nnz": gp.csr.nnz}
    t0 = time.perf_counter()
    plan = compile_plan_csr(gp.csr, alloc)
    info["compile_s"] = time.perf_counter() - t0
    progs = pagerank_and_sssp()
    oracle = {name: algo.reference_run(p, gp, 10) for name, p in progs.items()}
    bits = (plan.coded_bits + plan.leftover_bits) * 10
    state4 = torch.from_numpy(np.random.default_rng(4).random(
        (gp.n, 4), dtype=np.float32)).to(dev)
    for backend, path, kernels in (("numpy", "auto",
                                    PLAN_KERNELS + ("segment_reduce",)),
                                   ("fused", "sparse", FUSED_KERNELS)):
        t0 = time.perf_counter()
        eng = engine.compile(progs["pagerank"], gp, alloc, "coded", path=path,
                             backend=backend, plan=plan, device=dev)
        m = info[backend] = {"session_s": time.perf_counter() - t0}
        _build.LAUNCHES.clear()
        runs = {name: eng.with_program(p).run(10) for name, p in progs.items()}
        torch.cuda.synchronize()
        m["launches"] = dict(_build.LAUNCHES)
        what = f"the table2 er-76k {backend} path"
        need_launches(m["launches"], kernels, what)
        m["pagerank_max_rel_err"] = check_pagerank(
            runs["pagerank"].state.cpu().numpy(), oracle["pagerank"], what)
        got = runs["sssp"].state.cpu().numpy()
        if not np.array_equal(got.view(np.uint32), oracle["sssp"].view(np.uint32)):
            raise AssertionError(f"sssp on {what}: not bitwise the oracle")
        for name, res in runs.items():
            if res.shuffle_bits != bits:
                raise AssertionError(f"{name} on {what}: bits are not exact")
        pr = progs["pagerank"]
        for B, st in ((1, torch.as_tensor(pr.init(gp), device=dev)),
                      (4, state4)):
            ev = pr.map_edge_values_t(eng._dg, st).contiguous()
            at = f"{what}, B = {B}"
            if backend == "fused":
                err = hold_session(torch, eng, ev, at,
                                   general_tables(torch, eng))["err"]
            else:
                err = dict(zip(PLAN_KERNELS,
                               hold_plan_kernels(torch, eng.dplan, ev, at)[-1]))
            m[f"max_abs_err_b{B}"] = err
        m.update(iteration_profile(torch, eng))
        log(f"table2 phase, registry er-76k (n = {g.n}, padded {gp.n}, K = "
            f"{TABLE2_K}, r = 2), {backend}: steady "
            f"{m['steady_s_per_iter'] * 1e3:.4f} ms/iter, device busy "
            f"{busy_ms(m)} ms/iter, idle {m['device_idle_share']}, launches "
            f"{m['launches']} | {smi}")
        del eng, runs
    return info


def run_examples() -> dict:
    """Both port examples on the card, in parallel subprocesses with a
    timeout; each must exit 0 (each holds its own states). Every process
    started here is ended before this returns."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            log(f"--- examples/{name} (exit {proc.returncode})\n{text.strip()}")
            if proc.returncode != 0:
                raise AssertionError(f"examples/{name} exited {proc.returncode}")
            out[name] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"examples_s": out}


def table2_phase(torch, dev, smi: str) -> dict:
    cache = ROOT / "build" / "table2-cache"
    shutil.rmtree(cache, ignore_errors=True)
    info = table2_records(cache)
    info["engine"] = table2_engine(torch, dev, cache, smi)
    info.update(run_examples())
    log(f"table2 phase ok: {json.dumps(info)}")
    return info


# ---------------------------------------------------------------------------
# topology phase: the two-level (racks x servers) coded Shuffle
# ---------------------------------------------------------------------------


def check_topology_plan(hp, plan, alloc, shape) -> dict:
    """The host plans' per-level numbers against `TOPO_EXPECTED` (the
    reference's, exact), with the flat schedule's inter-rack bits from
    `loads.empirical_loads(plan, alloc, topology=)`."""
    from repro_torch.core.loads import empirical_loads
    from repro_torch.launch.mesh import Topology

    got = (hp.inter.r, int(hp.inter.all_k.size), int(hp.inter.left_k.size),
           hp.inter_rack_bits, hp.intra_rack_bits,
           int(empirical_loads(plan, alloc, topology=Topology(*shape))
               ["inter_rack_bits"]))
    if got != TOPO_EXPECTED[shape]:
        raise AssertionError(f"topology {shape}: plan numbers {got}, the "
                             f"reference's {TOPO_EXPECTED[shape]}")
    keys = ("rack_redundancy", "rack_deliveries", "rack_leftovers",
            "inter_rack_bits", "intra_rack_bits", "flat_inter_rack_bits")
    return dict(zip(keys, got))


def direct_record(torch, eng, ev, what: str) -> dict:
    """K2's direct form at a two-level fused session's shapes on Map output
    `ev` [nnz(, B)]: the rack-level K1 and K2 with direct words bitwise
    their plain versions; timed (CUDA graph), its bound from the packed
    tables' bytes (`packed_bytes`) over the card's HBM rate, and the
    rack-level K1's time beside it (`rack_encode_ms`)."""
    from repro_torch.kernels.xor_code import xor_code as xc

    fx = eng.fused
    t = dict(fx.tables, src=ev.view(torch.int32))
    enc = tuple(t[k] for k in ENC_PACKED)
    buf, buf0 = xc.xor_encode_packed(*enc), xc.ref.xor_encode_packed(*enc)
    dec = (t["src"], buf) + tuple(t[k] for k in DEC_PACKED)
    kernel = lambda: xc.xor_decode_packed(*dec, total=fx.M,  # noqa: E731
                                          direct_e=t["direct_e"])
    plain = lambda: xc.ref.xor_decode_packed(  # noqa: E731
        *dec, direct_e=t["direct_e"])
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not (torch.equal(buf, buf0) and torch.equal(got, want)):
        raise AssertionError(f"rack-level K1 or K2 with direct words not "
                             f"bitwise its plain version at {what}")
    k1_bytes, k2_bytes = packed_bytes(eng, 1 if ev.dim() == 1 else ev.shape[1])
    rec = kernel_record(torch, "xor_decode_direct", kernel, plain, None,
                        word_err(torch, got, want), k2_bytes, 0)
    rec["rack_encode_ms"] = time_ms_graph(torch, lambda: xc.xor_encode_packed(*enc))
    rec["rack_encode_bound_ms"] = bound(torch, k1_bytes, 0)[0]
    return rec


def topology_er76k(torch, dev) -> tuple[dict, dict]:
    """er-76k at K = 8, r = 2 on Topology(4, 2), (2, 4), (1, 8) and
    Topology.flat(8), backend="fused" and "numpy": the host plans' numbers
    exactly the reference's; one exchange's delivered words bitwise the
    flat plan's (`execute_coded_sparse`); then the path (counts cleared
    just before, read just after): pagerank, sssp(0) and multi_sssp
    (B = 4), 10 iterations each, on every session; sssp and multi_sssp
    bitwise the flat fused session's, pagerank within rtol 1e-5 of it,
    exact bits; Topology.flat(8) the flat session, with its tables. Returns
    K2's direct-form record (launches from that path) and the info."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
    from repro_torch.core.shuffle_plan import (compile_hierarchical,
                                               compile_plan_csr)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Topology

    g, alloc, t_graph = er_session(SLICE_N, 76, K=TOPO_K)
    plan = compile_plan_csr(g.csr, alloc)
    info = {"n": g.n, "nnz": g.csr.nnz, "M": int(plan.all_k.size),
            "coded_bits": plan.coded_bits + plan.leftover_bits,
            "uncoded_bits": plan.uncoded_bits, "graph_s": t_graph}
    if (g.n, g.csr.nnz, info["M"], info["coded_bits"], info["uncoded_bits"]) \
            != (80_024, 640_648, 480_086, 7_764_608, 15_362_752):
        raise AssertionError(f"er-76k at K = 8 is not the reference's: {info}")
    roots = [0, g.n // 7, g.n // 2, g.n - 1]
    progs = {"pagerank": algo.pagerank(), "sssp": algo.sssp(0),
             "multi_sssp": algo.multi_sssp(roots)}
    flat = engine.compile(algo.pagerank(), g, alloc, "coded", path="sparse",
                          backend="fused", plan=plan, device=dev)
    base = {name: flat.with_program(p).run(10) for name, p in progs.items()}
    for name, res in base.items():
        check_state(res.state.cpu().numpy(),
                    algo.reference_run(progs[name], g, 10), name,
                    f"flat K = 8 {name}")
    pr = algo.pagerank()
    ev = pr.map_edge_values_t(flat._dg, torch.as_tensor(
        pr.init(g), device=dev)).contiguous()
    want = floats_to_words(plan.execute_coded_sparse(ev.cpu().numpy(),
                                                     flat.tables).values)
    sessions = {}
    for shape in TOPO_SHAPES + ("flat",):
        topo = Topology.flat(TOPO_K) if shape == "flat" else Topology(*shape)
        key = "flat" if shape == "flat" else f"{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        hp = compile_hierarchical(g.csr, alloc, topo)
        m = info[key] = {"compile_s": time.perf_counter() - t0}
        if shape != "flat":
            m.update(check_topology_plan(hp, plan, alloc, shape))
        for backend in ("fused", "numpy"):
            t0 = time.perf_counter()
            eng = engine.compile(pr, g, alloc, "coded", path="sparse",
                                 backend=backend, plan=hp, device=dev)
            m[f"{backend}_session_s"] = time.perf_counter() - t0
            if (eng.hplan is None) != (shape == "flat"):
                raise AssertionError(f"{key} {backend}: wrong session kind")
            got = (eng.fused.exchange(ev) if backend == "fused"
                   else eng.dplan.words(ev, "coded"))
            if not np.array_equal(t_words_to_np(got), want):
                raise AssertionError(f"{key} {backend}: delivered words differ "
                                     "from the flat plan's")
            sessions[(key, backend)] = eng
    tables = sessions[("flat", "fused")].fused.tables
    if tables.keys() != flat.fused.tables.keys() or not all(
            torch.equal(t, flat.fused.tables[k]) for k, t in tables.items()):
        raise AssertionError("Topology.flat(8): its tables differ from the "
                             "flat session's")

    # The path: reset the counts, run every program on every session, read.
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    runs = {(key, backend, name): eng.with_program(p).run(10)
            for (key, backend), eng in sessions.items()
            for name, p in progs.items()}
    torch.cuda.synchronize()
    info["run_s"] = time.perf_counter() - t0
    launches = info["launches"] = dict(_build.LAUNCHES)
    for name in ("xor_encode", "xor_decode", "xor_decode_direct",
                 "xor_encode_plan", "xor_decode_plan", "segment_reduce"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the er-76k "
                                 "topology path")
    for (key, backend, name), res in runs.items():
        eng = sessions[(key, backend)]
        what = f"topology {key} {backend} {name}"
        err = check_state(res.state.cpu().numpy(), base[name].state.cpu().numpy(),
                          name, what)
        m = info[key].setdefault(backend, {})
        if err is not None:
            m[f"{name}_max_rel_err"] = err
        m[f"{name}_bitwise_flat"] = bool(torch.equal(
            res.state.view(torch.int32), base[name].state.view(torch.int32)))
        per = (eng.hplan.inter_rack_bits + eng.hplan.intra_rack_bits
               if eng.hplan is not None else info["coded_bits"])
        if res.shuffle_bits != per * res.batch * 10:
            raise AssertionError(f"{what}: shuffle bits are not exact")
        if key == "flat" and backend == "fused" and not m[f"{name}_bitwise_flat"]:
            raise AssertionError(f"{what}: not the flat session's state")
    for key in ("4x2", "2x4"):
        for backend in ("fused", "numpy"):
            info[key][backend].update(iteration_profile(
                torch, sessions[(key, backend)]))
    rec = direct_record(torch, sessions[("4x2", "fused")], ev, "er-76k 4x2")
    state4 = torch.from_numpy(np.random.default_rng(4).random(
        (g.n, 4), dtype=np.float32)).to(dev)
    ev4 = pr.map_edge_values_t(flat._dg, state4).contiguous()
    for key in ("4x2", "2x4"):
        for e in (ev, ev4):
            direct_record(torch, sessions[(key, "fused")], e, f"er-76k {key}")
    record_launches([rec], launches, "the er-76k topology path")
    return rec, info


def topology_scale(torch, dev, smi: str) -> tuple[dict, dict]:
    """ER n ~ 1e6 (seed 7) at K = 8, r = 2 on Topology(4, 2) (backend
    "fused" and "numpy") and flat ("numpy"), pagerank for 10 iterations: host
    compile and session build times, per-level bits, steady ms per
    iteration, device busy and idle share, peak memory, pagerank within
    rtol 1e-5 of the oracle, exact bits, each run's launch counts. Returns
    K2's direct-form record at these shapes and the info."""
    from repro_torch.core import algorithms as algo
    from repro_torch.core import engine
    from repro_torch.core.loads import empirical_loads
    from repro_torch.core.shuffle_plan import (compile_hierarchical,
                                               compile_plan_csr)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Topology

    g, alloc, t_graph = er_session(SCALE_N, 7, K=TOPO_K)
    info = {"n": g.n, "nnz": g.csr.nnz, "graph_s": t_graph}
    t0 = time.perf_counter()
    want = algo.reference_run(algo.pagerank(), g, 10)
    info["oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = compile_plan_csr(g.csr, alloc)
    info["flat_compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hp = compile_hierarchical(g.csr, alloc, Topology(4, 2))
    info["compile_hierarchical_s"] = time.perf_counter() - t0
    info.update(M=int(plan.all_k.size), rack_redundancy=hp.inter.r,
                inter_rack_bits=hp.inter_rack_bits,
                intra_rack_bits=hp.intra_rack_bits,
                flat_bits=plan.coded_bits + plan.leftover_bits,
                flat_inter_rack_bits=int(empirical_loads(
                    plan, alloc, topology=Topology(4, 2))["inter_rack_bits"]))
    pr, rec = algo.pagerank(), None
    # The flat K = 8 session runs on backend "numpy" only: the flat fused
    # route is the scale phase's (at K = 4), and its session build here
    # (13.5 s on an H100 80GB HBM3 host) would keep the script from its
    # time budget.
    cells = (("4x2", hp, "fused"), ("4x2", hp, "numpy"),
             ("flat", plan, "numpy"))
    for key, p, backend in cells:
        bits = (hp.inter_rack_bits + hp.intra_rack_bits if key == "4x2"
                else info["flat_bits"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = engine.compile(pr, g, alloc, "coded", path="sparse",
                             backend=backend, plan=p, device=dev)
        m = info[f"{key}_{backend}"] = {
            "session_s": time.perf_counter() - t0}
        eng.run(1)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = eng.run(10)
        torch.cuda.synchronize()
        m["pagerank_s_per_iter"] = (time.perf_counter() - t0) / 10
        m["launches"] = dict(_build.LAUNCHES)
        m["pagerank_max_rel_err"] = check_pagerank(
            res.state.cpu().numpy(), want, f"scale {key} {backend}")
        if res.shuffle_bits != bits * 10:
            raise AssertionError(f"scale {key} {backend}: shuffle bits "
                                 "are not exact")
        m.update(iteration_profile(torch, eng))
        m["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        if key == "4x2" and backend == "fused":
            ev = pr.map_edge_values_t(eng._dg, torch.as_tensor(
                pr.init(g), device=dev)).contiguous()
            rec = direct_record(torch, eng, ev, "scale 4x2")
            record_launches([rec], m["launches"], "the scale 4x2 path")
            del ev
        log(f"topology phase, scale, {key} {backend}: steady "
            f"{m['steady_s_per_iter'] * 1e3:.4f} ms/iter, device busy "
            f"{busy_ms(m)} ms/iter, "
            f"idle {m['device_idle_share']}, peak {m['peak_mem_bytes']} B,"
            f" session {m['session_s']:.4f} s | {smi}")
        del eng, res
    return rec, info


def topology_phase(torch, dev, smi: str) -> tuple[dict, dict, dict]:
    rec_er, info_er = topology_er76k(torch, dev)
    log(f"topology phase, er-76k ok: {json.dumps(info_er)}")
    rec_scale, info_scale = topology_scale(torch, dev, smi)
    log(f"topology phase, scale ok: {json.dumps(info_scale)}")
    return rec_er, rec_scale, {"er76k": info_er, "scale": info_scale}


# ---------------------------------------------------------------------------
# serve phase: K6 / K7 and mamba2-370m at full width
# ---------------------------------------------------------------------------


def ssd_chunk_inputs(torch, dev, rng, G, Ch, Q, P, N, dtype=None, heads=1):
    """K6's inputs: x, b and c in `dtype` (float32 by default), b and c of
    G // heads rows (each shared by `heads` groups), dt and dta float32."""
    dtype = dtype or torch.float32
    dt = rng.uniform(0.01, 0.2, (G, Ch, Q))
    arrays = (rng.standard_normal((G, Ch, Q, P)), dt,
              dt * -rng.uniform(0.5, 2.0, (G, 1, 1)),
              rng.standard_normal((G // heads, Ch, Q, N)),
              rng.standard_normal((G // heads, Ch, Q, N)))
    return [torch.from_numpy(a).to(dev, torch.float32 if i in (1, 2) else dtype)
            for i, a in enumerate(arrays)]


def k6_cost(args) -> tuple[int, int]:
    """K6's bytes (each input read once in its own type, each float32
    output written once) and its operations over the causal triangle (the
    scores and y_intra for s <= t, plus S)."""
    x, _, _, b, _ = args
    G, Ch, Q, P = x.shape
    N = b.shape[-1]
    tri = Q * (Q + 1) // 2
    nbytes = (x.numel() * x.element_size() + 2 * 4 * G * Ch * Q
              + 2 * b.numel() * b.element_size()
              + 4 * (G * Ch * Q * P + G * Ch * N * P + G * Ch + G * Ch * Q * N))
    return nbytes, 2 * G * Ch * (tri * N + tri * P + Q * N * P)


def check_ssd_chunk(torch, args, what: str) -> float:
    """K6 (one shot, or staged in parts where a chunk does not fit a
    block) against its plain version: rtol 1e-4 and atol 1e-4 * max|plain|
    per output (float32 in another summation order). Returns the max abs
    error over the four outputs."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_k

    got, want = ssd_k.ssd_chunk(*args), ssd_ref.ssd_chunk(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=SSD_RTOL,
                                   atol=SSD_RTOL * float(w.abs().max()),
                                   msg=lambda m: f"K6 at {what}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def check_state_scan(torch, G, S, h0, what: str) -> None:
    """K7 against its plain version, bitwise: one rounded multiply and one
    rounded add per chunk in both, in the same order."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_k

    got, want = ssd_k.ssd_state_scan(G, S, h0), ssd_ref.ssd_state_scan(G, S, h0)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K7 ssd_state_scan not bitwise at {what}")


def ssd_kernel_checks(torch, dev, rng) -> tuple[dict, dict]:
    """K6 and K7 at the `tests/test_kernels.py` ssd shapes, K6 at ragged
    shapes (float32, and bf16 with b / c shared by 2 groups), both at the
    serve shape and K7 at 256 chunks; `ops.ssd` against the sequential
    oracle at the reference's 5e-4. Returns K6's record at the serve shape
    with the serve path's inputs (bf16, B / C shared by the heads), its
    float32-input record inside it, and K7's record."""
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_k

    cases = 0
    for G, L, P, N, chunk in ((1, 64, 8, 4, 16), (2, 128, 16, 8, 32),
                              (3, 128, 32, 16, 64), (2, 256, 8, 8, 128),
                              (1, 32, 64, 32, 32)):
        args = ssd_chunk_inputs(torch, dev, rng, G, L // chunk, chunk, P, N)
        check_ssd_chunk(torch, args, f"G={G} L={L} P={P} N={N} chunk={chunk}")
        _, S, Gd, _ = ssd_k.ssd_chunk(*args)
        h0 = torch.from_numpy(rng.standard_normal(S[:, 0].shape)).to(
            dev, torch.float32)
        for h in (None, h0):
            check_state_scan(torch, Gd, S, h, f"G={G} L={L} chunk={chunk}")
        arrays = (rng.standard_normal((G, L, P)), rng.uniform(0.01, 0.2, (G, L)),
                  -rng.uniform(0.5, 2.0, G), rng.standard_normal((G, L, N)),
                  rng.standard_normal((G, L, N)), rng.standard_normal(G))
        ssd_args = [torch.from_numpy(a).to(dev, torch.float32) for a in arrays]
        y, h = ssd_ops.ssd(*ssd_args, chunk=chunk)
        y0, h0 = ssd_ref.ssd_scan_batched(*ssd_args)
        torch.testing.assert_close(y, y0, rtol=5e-4, atol=5e-4)
        torch.testing.assert_close(h, h0, rtol=5e-4, atol=5e-4)
        cases += 1

    # Ragged shapes (Q, P or N not a multiple of the tiles), float32 and
    # bf16 with b / c shared by 2 groups. These and the serve-path inputs
    # draw from a generator of their own, so the model's tokens, drawn from
    # `rng` after these checks, do not depend on them.
    rng2 = np.random.default_rng(15)
    for G, Ch, Q, P, N in ((2, 4, 16, 8, 4), (2, 2, 128, 72, 136),
                           (2, 3, 5, 3, 7), (2, 2, 200, 24, 40)):
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_chunk_inputs(torch, dev, rng2, G, Ch, Q, P, N, dtype, 2)
            check_ssd_chunk(torch, args, f"{dtype} G={G} Ch={Ch} Q={Q} P={P} N={N}")
            cases += 1

    # Chunks past one block's shared memory (Mamba2's P = 64, N = 128 at
    # Q = 256 in float32, which the reference computes; bf16 at Q = 400):
    # staged in parts, held to K6's gates, `ops.ssd` at chunk 256 against
    # the oracle. Timed at 2,048 tokens per group (the serve shape's), per
    # token against one shot at Q = 128.
    rng3 = np.random.default_rng(256)
    arrays = (rng3.standard_normal((2, 512, 64)), rng3.uniform(0.01, 0.2, (2, 512)),
              -rng3.uniform(0.5, 2.0, 2), rng3.standard_normal((2, 512, 128)),
              rng3.standard_normal((2, 512, 128)), rng3.standard_normal(2))
    ssd_args = [torch.from_numpy(a).to(dev, torch.float32) for a in arrays]
    y, h = ssd_ops.ssd(*ssd_args, chunk=256)
    y0, h0 = ssd_ref.ssd_scan_batched(*ssd_args)
    torch.testing.assert_close(y, y0, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(h, h0, rtol=5e-4, atol=5e-4)
    large = {}
    for dtype, tag, qs in ((torch.float32, "float32", (128, 180, 256)),
                           (torch.bfloat16, "bf16", (128, 256, 400))):
        for q in qs:
            args = ssd_chunk_inputs(torch, dev, rng3, 8, 2, q, 64, 128, dtype, 2)
            check_ssd_chunk(torch, args, f"{tag} Q={q}")
            large[f"q{q}_{tag}_part_tokens"] = ssd_k.part_tokens(q, 64, 128, dtype)
            cases += 1
        for q in (128, 256):
            targs = ssd_chunk_inputs(torch, dev, rng3, 128, 2048 // q, q, 64,
                                     128, dtype, 32)
            large[f"q{q}_{tag}_ms"] = time_ms_graph(
                torch, lambda: ssd_k.ssd_chunk(*targs))
        del args, targs
    log(f"K6 at chunks of 128 to 400 (timed: G = 128, 2,048 tokens, P = 64, "
        f"N = 128, B / C shared by 32): {json.dumps(large)}")

    # The serve shape: B = 4 sequences x 32 heads, L = 2,048 in 32 chunks,
    # at the serve path's inputs (bf16 x, B and C shared by the 32 heads of
    # a sequence) and at float32 inputs materialised per group (PR 13's).
    cfg = configs.get(SERVE_ARCH)
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    G, Ch, Q = SERVE_B * nh, SERVE_L // s.chunk, s.chunk
    P, N = s.head_dim, s.d_state
    args = ssd_chunk_inputs(torch, dev, rng2, G, Ch, Q, P, N, torch.bfloat16, nh)
    err6 = check_ssd_chunk(torch, args, "the serve shape, serve-path inputs")
    args32 = ssd_chunk_inputs(torch, dev, rng, G, Ch, Q, P, N)
    err32 = check_ssd_chunk(torch, args32, "the serve shape, float32 inputs")
    _, S, Gd, _ = ssd_k.ssd_chunk(*args32)
    check_state_scan(torch, Gd, S, None, "the serve shape")
    long_args = ssd_chunk_inputs(torch, dev, rng, 32, 256, Q, P, N)
    _, S_long, G_long, _ = ssd_k.ssd_chunk(*long_args)
    check_state_scan(torch, G_long, S_long, None, "256 chunks")
    del long_args, S_long, G_long
    log(f"serve phase: K6/K7 and ops.ssd agree with their plain versions at "
        f"{cases} test and ragged shapes, the serve shape (bf16 with shared "
        f"B / C, and float32) and (K7) 256 chunks")

    # Bounds from this run's inputs: each input read once in its own type,
    # each output written once. K6's operations at the bf16 tensor-core
    # rate for the serve path's inputs; at the float32 rate for the float32
    # record, as PR 13 reckoned it. K7: one multiply-add per state.
    rec6 = kernel_record(torch, "ssd_chunk", lambda: ssd_k.ssd_chunk(*args),
                         lambda: ssd_ref.ssd_chunk(*args), None, err6,
                         *k6_cost(args), rate="bf16")
    rec32 = kernel_record(torch, "ssd_chunk", lambda: ssd_k.ssd_chunk(*args32),
                          lambda: ssd_ref.ssd_chunk(*args32), None, err32,
                          *k6_cost(args32))
    rec6["float32_inputs"] = {k: rec32[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "ms_per_call",
        "bytes")}
    log(f"K6 at the serve shape, float32 inputs: "
        f"{json.dumps(rec6['float32_inputs'])}")
    k7_bytes = 4 * (2 * G * Ch * N * P + G * Ch + G * N * P)
    k7_flops = 2 * G * Ch * N * P
    rec7 = kernel_record(torch, "ssd_state_scan",
                         lambda: ssd_k.ssd_state_scan(Gd, S),
                         lambda: ssd_ref.ssd_state_scan(Gd, S), None, 0.0,
                         k7_bytes, k7_flops)
    rec6["shape"] = dict(G=G, Ch=Ch, Q=Q, P=P, N=N, heads=nh, dtype="bfloat16")
    rec6["large_chunks"] = large
    rec7["shape"] = dict(G=G, Ch=Ch, Q=Q, P=P, N=N)
    return rec6, rec7


def cast_params(params, dtype, n_layers: int | None = None):
    """A copy of a `Params` tree in another dtype (on the same device),
    keeping the first `n_layers` of the stacked layers (all by default)."""
    from repro_torch.models.layers import Params

    def tree(p, stacked):
        return {k: tree(p[k], stacked or k == "layers")
                if isinstance(p[k], Params)
                else (p[k][:n_layers] if stacked else p[k]).to(dtype)
                for k in p.keys()}
    return Params(tree(params, False))


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def lockstep(params, cfg, x, other) -> list[tuple[float, float]]:
    """Each layer's block on the same input through the kernel path and
    through `other(lp, hn)` (another path computing the same block), the
    stack advanced by the kernel path's output: per layer, the max
    difference of the block outputs and of the final SSM states, each
    relative to the max of `other`'s. Free of the amplification across
    layers that the end-to-end logits carry."""
    from repro_torch.models import ssm, transformer as tfm
    from repro_torch.models.layers import rms_norm

    out = []
    for i in range(cfg.n_layers):
        lp = tfm.layer(params["layers"], i)
        hn = rms_norm(x, lp["norm"], cfg.norm_eps)
        y, (_, h) = ssm.mamba2_block(lp["mixer"], cfg, hn)
        y0, h0 = other(lp["mixer"], hn)
        out.append((rel_err(y, y0), rel_err(h, h0)))
        x = x + y
    return out


def serve_phase(torch, dev, smi: str) -> tuple[dict, dict, dict]:
    """K6 / K7 checks, then mamba2-370m served at full width (module
    docstring, phase 6). Returns K6's and K7's records (launches from the
    bf16 prefill) and the phase's info.

    With the reference's random init, 48 layers amplify rounding a few
    thousand times (a 1e-6 change of the embeddings moves the float32
    logits by ~4e-3 of their max), so end-to-end logits of two correct
    paths differ by about as much as bf16 differs from float32. The
    tolerances are therefore held per layer, in lockstep (`lockstep`),
    and end to end against the noise floor measured in the same run.
    """
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import decode as dec
    from repro_torch.models import ssm, transformer as tfm
    from repro_torch.models.layers import init_params, rms_norm

    rng = np.random.default_rng(13)
    rec6, rec7 = ssd_kernel_checks(torch, dev, rng)

    cfg = configs.get(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(tfm.model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    info = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "params": sum(p.numel() for p in params.parameters()),
            "init_s": time.perf_counter() - t0}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_B, SERVE_L))).to(dev)
    batch = {"tokens": toks}

    def plain_block(lp, hn):
        y, (_, h) = ssm.mamba2_block(lp, cfg, hn, use_kernel=False)
        return y, h
    with torch.inference_mode():
        plain = dec.prefill(params, cfg, batch, use_kernel=False)
        dec.prefill(params, cfg, batch)                          # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # The main path: reset the counts, prefill, read the counts.
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        logits = dec.prefill(params, cfg, batch)
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        for _ in range(2):
            t0 = time.perf_counter()
            dec.prefill(params, cfg, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dec.prefill(params, cfg, batch, use_kernel=False)
        torch.cuda.synchronize()
        info["plain_prefill_s"] = time.perf_counter() - t0
        params32 = cast_params(params, torch.float32)
        plain32 = dec.prefill(params32, cfg, batch, use_kernel=False)
        # The amplification, for the record: float32 through the kernels,
        # and float32 with the embeddings moved by 1e-6 of themselves.
        info["f32_prefill_max_rel_err"] = rel_err(
            dec.prefill(params32, cfg, batch), plain32)
        x32 = tfm._embed_inputs(params32, cfg, batch) * (1 + 1e-6)
        for i in range(cfg.n_layers):
            lp = tfm.layer(params32["layers"], i)
            y, _ = ssm.mamba2_block(lp["mixer"], cfg, rms_norm(
                x32, lp["norm"], cfg.norm_eps), use_kernel=False)
            x32 = x32 + y
        info["f32_perturb_1e-6_max_rel_err"] = rel_err(tfm.logits_of(
            params32, rms_norm(x32, params32["final_norm"], cfg.norm_eps)[:, -1]),
            plain32)
        del x32
        steps = lockstep(params, cfg, tfm._embed_inputs(params, cfg, batch),
                         plain_block)
    for name in ("ssd_chunk", "ssd_state_scan"):
        if launches.get(name, 0) != cfg.n_layers:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} "
                                 f"times in the prefill, not {cfg.n_layers}")
    if logits.shape != (SERVE_B, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} "
                             f"or values not finite")
    info["prefill_max_rel_err"] = rel_err(logits, plain)
    info["bf16_noise_max_rel_err"] = rel_err(plain, plain32)
    info["lockstep_block_max_rel_err"] = max(y for y, _ in steps)
    info["lockstep_state_max_rel_err"] = max(h for _, h in steps)
    if info["lockstep_block_max_rel_err"] > BF16_BLOCK_TOL or \
            info["lockstep_state_max_rel_err"] > STATE_TOL:
        raise AssertionError(f"a kernel block is off the plain block: {steps}")
    if info["prefill_max_rel_err"] > 2 * info["bf16_noise_max_rel_err"]:
        raise AssertionError(
            f"kernel prefill off the plain prefill by "
            f"{info['prefill_max_rel_err']} of max|logit|, more than twice "
            f"bf16's own {info['bf16_noise_max_rel_err']}")
    rec6["launches"], rec7["launches"] = launches["ssd_chunk"], launches["ssd_state_scan"]
    info["prefill_launches"] = launches
    info["prefill_s"] = statistics.median(times)
    info["prefill_tokens_per_s"] = SERVE_B * SERVE_L / info["prefill_s"]
    info["prefill_peak_mem_bytes"] = peak

    prompts = rng.integers(0, cfg.vocab, (GEN_B, GEN_PROMPT))
    serve.generate(cfg, params, prompts[:, :2], 2, device=dev)   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve.generate(cfg, params, prompts, GEN_NEW, device=dev)
    gen_s = time.perf_counter() - t0
    if out.shape != (GEN_B, GEN_NEW) or out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"generate: shape {out.shape} or tokens outside "
                             f"[0, {cfg.vocab})")
    info["decode_ms_per_step"] = gen_s / (GEN_PROMPT + GEN_NEW - 1) * 1e3
    info["generate_s"] = gen_s
    cache = dec.init_cache(cfg, ShapeSpec("profile", 2, GEN_B, "decode"),
                           device=dev)
    one = {"tokens": torch.from_numpy(prompts[:, :1]).to(dev)}
    with torch.inference_mode():
        dec.decode_step(params, cfg, cache, one)
        info["decode_step_profile"] = call_profile(
            torch, lambda: dec.decode_step(params, cfg, cache, one))
        info["prefill_profile"] = call_profile(
            torch, lambda: dec.prefill(params, cfg, batch))
    del cache

    # float32: every layer's chunked (kernel) block against 128 decode
    # steps of the same block, over all 48 layers; end to end, prefill
    # against the decode loop at a depth of 4 layers, where the
    # amplification is small.
    del params
    ctoks = toks[:, :CONSIST_L]

    def decode_block(lp, hn):
        state = ssm.empty_state(cfg, hn.shape[0], dtype=hn.dtype, device=dev)
        ys = []
        for t in range(hn.shape[1]):
            y, state = ssm.mamba2_block(lp, cfg, hn[:, t:t + 1], state=state)
            ys.append(y)
        return torch.cat(ys, dim=1), state[1]

    with torch.inference_mode():
        steps = lockstep(params32, cfg,
                         tfm._embed_inputs(params32, cfg, {"tokens": ctoks}),
                         decode_block)
        cfg4 = dataclasses.replace(cfg, n_layers=CONSIST_DEPTH)
        p4 = cast_params(params32, torch.float32, CONSIST_DEPTH)
        want = dec.prefill(p4, cfg4, {"tokens": ctoks})
        cache = dec.init_cache(cfg4, ShapeSpec("consist", CONSIST_L, SERVE_B,
                                               "decode"),
                               dtype=torch.float32, device=dev)
        for i in range(CONSIST_L):
            step, cache = dec.decode_step(p4, cfg4, cache,
                                          {"tokens": ctoks[:, i:i + 1]})
    info["f32_lockstep_decode_block_max_rel_err"] = max(y for y, _ in steps)
    info["f32_lockstep_decode_state_max_rel_err"] = max(h for _, h in steps)
    info["f32_decode_vs_prefill_max_rel_err"] = rel_err(step, want)
    worst = max(info["f32_lockstep_decode_block_max_rel_err"],
                info["f32_lockstep_decode_state_max_rel_err"],
                info["f32_decode_vs_prefill_max_rel_err"])
    if worst > CONSIST_TOL or not torch.isfinite(step).all():
        raise AssertionError(f"float32 decode steps off the chunked prefill: "
                             f"{json.dumps(info)}")
    del params32, p4, cache
    torch.cuda.empty_cache()
    log(f"serve: prefill B={SERVE_B} L={SERVE_L}: "
        f"{info['prefill_tokens_per_s']:.1f} tokens/s "
        f"({info['prefill_s'] * 1e3:.3f} ms) | {smi}")
    log(f"serve: decode B={GEN_B}: {info['decode_ms_per_step']:.3f} ms per "
        f"decoded token (one lockstep step) | {smi}")
    log(f"serve: peak device memory of the prefill {peak} bytes | {smi}")
    log(f"serve phase ok: {json.dumps(info)}")
    return rec6, rec7, info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write every record to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, numpy {np.__version__}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        f"(per source: {json.dumps(built)})")
    for lib in sorted(_build.BUILD_DIR.glob("*.log")):
        log(f"--- {lib.name}\n{lib.read_text().strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain spmv
    result = {"card": smi, "build_s": built}
    wall = result["phase_wall_s"] = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        wall[name] = time.perf_counter() - t0
        return out

    timed("kernels", kernel_phase, torch, dev)
    records, result["slice"], er = timed("slice", slice_phase, torch, dev,
                                         SLICE_N)
    scale_records, result["scale"], scale = timed("scale", scale_phase, torch,
                                                  dev, SCALE_N)
    k5_er, k5_scale, result["spmv"] = timed("spmv", spmv_phase, torch, dev,
                                            er, scale)
    plan_er, plan_scale, result["modes"] = timed(
        "modes", modes_phase, torch, dev, er, scale, result["scale"])
    result["elastic"] = timed("elastic", elastic_phase, torch, dev, er, scale,
                              smi)
    result["dist"] = timed("dist", dist_phase, torch, dev, er, scale, smi)
    del er, scale
    result["table2"] = timed("table2", table2_phase, torch, dev, smi)
    k2d_er, k2d_scale, result["topology"] = timed("topology", topology_phase,
                                                  torch, dev, smi)
    k4, result["dense"] = timed("dense", dense_phase, torch, dev)
    k6, k7, result["serve"] = timed("serve", serve_phase, torch, dev, smi)
    log(f"phase wall times (s): {json.dumps(wall)}")
    records += plan_er + [k2d_er, k4, k5_er, k6, k7]
    scale_records += [k5_scale] + plan_scale + [k2d_scale]
    result["kernels_scale"] = scale_records
    log("kernels at the scale shapes: " + json.dumps(scale_records))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    result["kernels"] = records
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                    # any failed phase: no result line
        traceback.print_exc()
        code = 1
    sys.exit(code)
