#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device   -- the card's name and power limit (nvidia-smi).
  2. build    -- nvcc builds every kernel of src/repro_torch/csrc/ for sm_90a.
  3. kernels  -- each kernel against its plain PyTorch version at the main
                 paths' shapes: max error against a stated tolerance, kernel,
                 plain and library times (CUDA events), and the bound. K1
                 (int8 GEMM) and K2a (bf16-pool attention) for slice 1; K4
                 (packed 2/4-bit GEMM, also against K1 on the unpacked
                 codes) and K2b (int8/int4-pool attention) for slice 2.
  4. parity   -- a 2-layer full-width tinyllama-1.1b: one prefill_slot and one
                 decode_step on the CPU (plain versions) and on the card
                 (kernels), logits compared at a stated tolerance: the
                 uniform int8 state over a bf16 pool, then the mixed
                 2/4/8-bit state over int8 and int4 pools; then
                 [parity-window]: the uniform state under WindowSpec(12, 1)
                 (40-token prompt, eviction before the decode) over bf16
                 and int8 pools; then [parity-int]: the uniform/bf16 and
                 mixed/int4 states with act_bits=8 (integer GEMMs; the same
                 activation specs on both sides); then [parity-gemma2]: a
                 2-layer (one local, one global) full-width gemma2-2b with
                 its window cut to 64, a 200-token prompt.
  5. serve    -- full tinyllama-1.1b (22 layers, random seeded weights, int8
                 per-channel export, paged bf16 KV) through ServingEngine:
                 12 greedy requests on 8 slots; launch counters must equal
                 what the path implies and the tick must sync the host once.
  6. profile  -- a few more full-batch decode ticks on the same engine: host
                 wall per tick, one tick under the sync debug mode (exactly
                 one synchronizing operation, the tick's host transfer),
                 then device time by kernel (torch.profiler) and the
                 device's idle share.
  7. mixed serve -- the same requests through the mixed 2/4/8-bit export
                 (2- and 4-bit sites packed) over an int4 KV pool, with its
                 exact launch counts, the export's and the KV cache's device
                 bytes; then its own profile.
 7b. serve-window -- long-context serving (slice 4): 12 greedy requests of
                 384-896 prompt tokens on 8 slots, max_seq 1024, under
                 WindowSpec(256, sink_blocks=2), uniform int8 over a bf16
                 pool: K2c exactly n_layers launches per tick and K2a/K2b
                 none, one sync per tick, at most max_live_blocks(256, 2, 8)
                 = 35 table entries per live slot after every tick, no block
                 leaked; then its profile.
 7c. serve-int -- fully-integer serving (slice 5, act_bits=8): the
                 uniform/bf16 cell's requests with every matmul input
                 quantized per tensor and each GEMM an int8 x int8 product
                 summed in int32: K5 exactly 155 launches per forward, K1
                 none, K2a n_layers per tick, one sync per tick, quant_report
                 with every GEMM input integer and the uniform-int8 BOPs;
                 then serve-int-mixed, the mixed/int4 cell the same way (K5
                 44 and K6 111 per forward, K2b n_layers per tick, BOPs
                 below uniform); each with its profile.
 7d. serve-gemma2 -- gemma2-2b at full width and depth (slice 6: 26
                 layers alternating local and global, softcaps, GeGLU,
                 sandwich norms), uniform int8 over a bf16 pool of
                 16-token blocks, 4 slots of max_seq 4608, 8 greedy
                 requests (2 of them 4200-4500 tokens, past the 4096
                 window): K1 183 per forward, K7 26 per prefill and none
                 in a tick, K2a 13 and K2c 13 a tick, one sync a tick;
                 then its profile.
  8. train-parity -- one CGMQ step of a 2-layer full-width model on the CPU
                 (plain versions) and on the card (K3), same state: loss,
                 gradient norms per leaf and new gates, each against a
                 stated tolerance.
  9. train    -- full tinyllama-1.1b (22 layers, random seeded weights),
                 batch 8 x 128 of lm_tokens: 2 fp32 warmup steps,
                 activation calibration on 3 batches, then 12 CGMQ steps
                 from 16-bit gates under budget_rbop 0.07; K3 launches
                 exactly 221 per CGMQ forward and none before; the
                 controller certifies; ms per step, peak memory and a
                 torch.profiler split of one step.
 10. train->serve -- the certified state exported to int codes and served
                 (2 greedy requests) through ServingEngine on the card.

The kernels phase also holds K5 and K6 (int8 x int8 GEMMs summed in int32,
slice 5) bit for bit against their plain versions at every GEMM shape of
the int cells, with both activation loaders (int8 codes, and fp32
activations quantized in the kernel), and K6 bit for bit against K5 on the
unpacked codes, and K7 (whole-prompt flash attention, slice 6) within its
stated tolerance at tinyllama's and gemma2's prefill shapes, a ragged S,
fp32 operands, head_dim 128 and Hq == Hkv, each case naming the kernel it
ran (bf16 at head_dim 64-256: tensor cores; fp32: FMA); the build phase
shows the tensor-core instances' HGMMA and UTMALDG instructions (SASS, by
cuobjdump). Every prefill on the card runs K7, so the tinyllama
serve cells count it too (22 a prefill, none in a tick); the training
forwards do not (K7 has no backward), calibration does. It holds K3
(fused gated fake-quant) bit for bit
against its plain version at the training step's shapes, and K2c
(windowed paged attention) against its plain version on bf16, fp32, int8
and int4 pools under binding windows with and without sinks, sinks that
cover a block in part, and a window that does not bind (then bit for bit
against K2a/K2b).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Imports torch and the port
only: never jax, never the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
SLOTS, MAX_SEQ, BLOCK = 8, 512, 8
MIXED_KV = "int4"
N_REQUESTS, MAX_NEW, PROMPT_LO, PROMPT_HI = 12, 32, 16, 384

# serve-window (slice 4): long prompts under a sliding window with sinks
WIN_MAX_SEQ, WIN_WINDOW, WIN_SINK_BLOCKS = 1024, 256, 2
WIN_PROMPT_LO, WIN_PROMPT_HI = 384, 896
# K2c kernel cases (window, sinks in tokens): binding with sinks, binding
# without, sinks covering a block in part, not binding; timed at the first
K2C_CASES = ((WIN_WINDOW, WIN_SINK_BLOCKS * BLOCK), (WIN_WINDOW, 0),
             (WIN_WINDOW, 12), (4096, 0))
# [parity-window]: a window that binds on a 40-token prompt, one sink block
PARITY_WINDOW, PARITY_WINDOW_SINK_BLOCKS, PARITY_WINDOW_PLEN = 12, 1, 40

# serve-gemma2 (slice 6): gemma2-2b at full width and depth, 4 slots of
# max_seq 4608 over a bf16 pool of 16-token blocks; 6 prompts of 22-352
# tokens and 2 of 4200-4500, so that the 4096 window binds in K7's
# prefill and in K2c's decode
G2_SLOTS, G2_MAX_SEQ, G2_BLOCK = 4, 4608, 16
G2_SHORT, G2_LONG = (6, 22, 352), (2, 4200, 4500)
# [parity-gemma2]: 2 layers (one local, one global), the window cut to 64
# so that it binds on a 200-token prompt (a 4096-token full-width prefill
# is beyond the CPU)
G2_PARITY_WINDOW, G2_PARITY_PLEN = 64, 200
# K7 kernel cases (name, B, Hq, Hkv, hd, S, dtype, window, sinks, softcap):
# tinyllama's prefill at the serve cells' largest bucket and under the
# serve-window spec (window 256, 2 sink blocks of 8); gemma2's local and
# global layers at [serve-gemma2]'s longest bucket; a ragged S over two
# batch rows; fp32 operands (the FMA kernel); head_dim 128 at qwen3-4b's
# heads (32 over 8); Hq == Hkv at musicgen-large's (32, hd 64), two
# ragged batch rows under a window whose 4 sinks cover a key tile in part.
# The first is the kernels line's entry: SDPA computes exactly its function
# (no softcap, which SDPA lacks).
K7_CASES = (
    ("tinyllama-prefill", 1, 32, 4, 64, 512, "bfloat16", None, 0, None),
    ("tinyllama-window", 1, 32, 4, 64, 1024, "bfloat16", WIN_WINDOW,
     WIN_SINK_BLOCKS * BLOCK, None),
    ("gemma2-local", 1, 8, 4, 256, G2_MAX_SEQ, "bfloat16", 4096, 0, 50.0),
    ("gemma2-global", 1, 8, 4, 256, G2_MAX_SEQ, "bfloat16", None, 0, 50.0),
    ("ragged", 2, 8, 4, 256, 333, "bfloat16", 64, 5, 50.0),
    ("fp32", 1, 8, 4, 256, 1024, "float32", 256, 0, 50.0),
    ("qwen3-hd128", 1, 32, 8, 128, 2048, "bfloat16", None, 0, None),
    ("mha-window", 2, 32, 32, 64, 777, "bfloat16", 128, 4, None),
)

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores. Both kernels compute in fp32 on the CUDA cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# bf16 tensor-core peak (dense): the bound of K7's operations over bf16
# operands (fp32 operands: FP32_FLOP_S)
BF16_FLOP_S = 989e12
# int8 tensor-core peak (dense): the bound of the integer GEMMs' operations
INT8_OPS_S = 1979e12
# slice 5: the activation width of the integer cells
INT_ACT_BITS = 8
# torch._int_mm, the integer GEMMs' library yardstick, needs M > 16
INT_MM_MIN_M = 32

# K1 tolerance: the kernel reassociates an fp32 sum of up to K = 5632 terms
# (scale * sum(x * codes) + bias * rowsum against x @ (codes*scale + bias)).
# The classical bound is K * eps32 * (|x| @ |w|) ~ 3.4e-4 of that magnitude;
# rounding errors of random sign grow like sqrt(K) * eps32 ~ 4.5e-6, so an
# elementwise 1e-4 of |x| @ |w| holds with a wide margin and still catches
# any indexing fault (which errs by O(1) of it).
K1_RTOL = 1e-4
# K4 tolerance against its plain version: K1's (the same fp32 sums). Against
# K1 on the unpacked codes K4 is bit-equal by design (one tile body, same K
# order, same explicitly rounded epilogue); the run reports whether it is,
# and fails only beyond K1's tolerance.
K4_RTOL = K1_RTOL
# K2a tolerance: the plain version (like the JAX oracle) rounds the softmax
# probabilities to bf16 before the PV product; the kernel (like the TPU
# kernel) keeps them fp32. A bf16 rounding moves each probability by at most
# 2^-9 of itself, so the output moves by at most 2^-9 * max|v|; we allow
# twice that, plus 1e-5 of fp32 noise.
K2_TOL_FACTOR = 2.0 ** -8
# K2b tolerances. Against the plain version:
# repro_torch.kernels.paged_attention.ref.bf16_rounding_tolerance, derived
# there from the plain version's bf16 roundings of the dequantized K and V
# (which the kernel keeps in fp32, as the TPU kernel does) and of the
# probabilities: 2^-8 max|v| (1 + S), S the largest hd^-0.5 sum |q||k|.
# Against the plain version with q in fp32, which rounds nothing to bf16
# and so computes the kernel's own fp32 function: 1e-4 of max|v|, a wide
# margin over fp32 reassociation that a wrong nibble or scale group (an
# error of order max|v|) still breaks.
K2B_F32_RTOL = 1e-4
# K2's calls back to back, and SDPA's beside them, are timed over this many
# calls: at tinyllama's shapes both are host-bound, and 20 calls leave the
# host's noise in the comparison
K2_ITERS = 200
# Path parity tolerance: activations are bf16 between layers in both runs;
# kernel-vs-plain fp32 reassociation flips a few bf16 roundings (2^-8
# relative each), which two layers and the head carry to the logits. We
# allow 4% of the largest |logit|, about ten bf16 ulps at that magnitude,
# or, where the model itself is more sensitive than that, twice the
# logits' own spread: how far the CPU run moves when its GEMM sums alone
# are accumulated in fp64 instead of fp32 (same codes, same everything
# else). The card's kernels change exactly those roundings. The mixed
# 2/4/8-bit stand-in state is such a model: its 2-bit sites inflate the
# activations, and the 8-bit activation grids after them turn a changed
# rounding into a whole grid step.
PARITY_RTOL = 4e-2
PARITY_SPREAD_FACTOR = 2.0

# Training (phases 8-10): the recipe's defaults (per-tensor gates, dir2,
# gate_lr 0.01, dir_clip 10, Adam lr 1e-4 clipped at 1.0) on batches of
# 8 x 128 tokens of lm_tokens(seed 0, noise 0.05).
TRAIN_BATCH, TRAIN_SEQ = 8, 128
WARMUP_STEPS, CALIB_BATCHES, CGMQ_STEPS = 2, 3, 12
# CGMQ starts every gate at 16 bits; the budget needs 8 bits everywhere
# (rbop 0.0625), which a clipped direction reaches in one step
TRAIN_GATE0, TRAIN_BUDGET_RBOP = 3.05, 0.07
# K3 gate levels: below the 0.5 clamp, then 2/4/8/16/16/32 bits
K3_LEVELS = (0.3, 0.8, 1.5, 2.5, 3.05, 3.5, 5.5)
# K3 per element: clip (2), subtract, divide, round, multiply, add
K3_FLOPS_PER_ELEMENT = 7.0
# train-parity: a 2-layer full-width step, batch x seq
PARITY_TRAIN = (2, 64)
# ... held to tests/test_torch_train.py's tolerances: the loss; a
# gradient's norm, or a sum's error against its terms' L1 mass; new gates
# from the same statistics to fp32 steps
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_CTRL_ATOL = 1e-3, 2e-2, 1e-6


class SmokeFailure(SystemExit):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean host wall time of one call of ``fn``, which only enqueues work,
    over ``iters`` calls; the queue is drained before and after."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured into one
    CUDA graph and replayed: for kernels whose device time per launch is
    below the host cost of launching them from Python, where ``time_ms``
    would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def copies_past_l2(nbytes: int, limit: int = 256) -> int:
    """How many copies of an operand to rotate so that consecutive timed
    launches read it cold from HBM (the 50 MB L2 is exceeded), as the
    decode path does: each layer's weights and pools are read once."""
    return max(1, min(limit, math.ceil(120e6 / max(nbytes, 1))))


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOP_S):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = out.stdout.strip().splitlines()[0]
    print(line)
    return line


def sass_counts(name: str):
    """{kernel: {op: count}} of wgmma (HGMMA) and TMA load (UTMALDG)
    instructions in each kernel of a built library, read from its SASS with
    the cuobjdump that ships beside the toolkit's nvcc (fails without it)."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    check(tool.exists(), f"no cuobjdump beside nvcc ({tool}): the tensor-core "
          f"instances' SASS cannot be read")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(("HGMMA", "UTMALDG"), 0)
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in ln
    return counts


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall for "
          f"{sorted(report) or 'nothing (cached)'}")
    for name, r in report.items():
        print(f"[build] {name}: nvcc {r['seconds']:.2f} s")
        for ln in r["ptxas"]:
            print(f"[build]   {ln}")
    # K7's tensor-core instances (tc::kernel<64/128/256>) must issue wgmma
    # over TMA-staged tiles: HGMMA and UTMALDG in their SASS
    counts = sass_counts("flash_attention")
    for fn, c in counts.items():
        print(f"[build] flash_attention SASS {fn}: "
              + ", ".join(f"{op} {n}" for op, n in c.items()))
    tc = {fn: c for fn, c in counts.items() if "tc6kernel" in fn}
    check(len(tc) == 3 and all(min(c.values()) > 0 for c in tc.values()),
          f"K7's tensor-core instances lack HGMMA or UTMALDG: {tc}")


def _prompts(vocab: int, lo: int = PROMPT_LO, hi: int = PROMPT_HI):
    rng = __import__("numpy").random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, N_REQUESTS)
    return [rng.integers(0, vocab, (int(n),)) for n in lens]


def _bucket(plen: int) -> int:
    b = 8
    while b < plen:
        b *= 2
    return min(b, MAX_SEQ)


def k1_case(m: int, k: int, n: int, gen, card: str):
    """K1 against its plain version at (M, K, N). Returns a result dict."""
    import torch

    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    dev = "cuda"
    x = torch.randn((m, k), generator=gen, device=dev)
    codes = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
    bias = (torch.rand((n,), generator=gen, device=dev) - 0.5) * 1e-3
    rowsum = x.sum(dim=1)
    got = quant_matmul(x, codes, scale, bias, rowsum)
    want = quant_matmul_ref(x, codes, scale, bias)
    w = codes.to(torch.float32) * scale + bias
    mag = x.abs() @ w.abs()
    torch.cuda.synchronize()
    err = (got - want).abs()
    ok = bool((err <= K1_RTOL * mag + 1e-6).all())
    res = {"shape": (m, k, n), "max_abs_err": float(err.max()),
           "max_rel_err": float((err / (mag + 1e-30)).max()), "ok": ok}

    cc = [codes.clone() for _ in range(copies_past_l2(codes.numel()))]
    wc = [w.clone() for _ in range(copies_past_l2(4 * w.numel(), 64))]
    it = iter(range(1 << 30))
    res["ms"] = time_ms(lambda: quant_matmul(
        x, cc[next(it) % len(cc)], scale, bias, rowsum))
    res["plain_ms"] = time_ms(lambda: quant_matmul_ref(
        x, cc[next(it) % len(cc)], scale, bias))
    res["library_ms"] = time_ms(lambda: x @ wc[next(it) % len(wc)])
    res["bytes"] = 4 * m * k + k * n + 8 * n + 4 * m + 4 * m * n
    res["flops"] = 2.0 * m * n * k
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    print(f"[kernels] quant_matmul M={m} K={k} N={n}: max_abs_err "
          f"{res['max_abs_err']:.3e}, max err/(|x|@|w|) "
          f"{res['max_rel_err']:.3e} (tol {K1_RTOL:g}) -> "
          f"{'ok' if ok else 'FAIL'}; kernel {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, library (x @ w_fp32) "
          f"{res['library_ms']:.4f} ms, bound {res['bound_ms'] * 1e3:.2f} us "
          f"({res['bound_by']}) [{card}]")
    return res


def sdpa_yardstick(q, kd, vd, table, valid, limit: int = 64):
    """K2's library yardstick: SDPA over each row's attended keys (``valid``,
    (B, max_blocks * bs) bool), gathered from the pools ``kd``/``vd``
    through ``table`` beforehand (the gather, and for a quantized pool the
    dequantization, are not timed), in bf16, GQA heads expanded, padded to
    the longest row and masked. Returns a function that runs it over
    enough copies of the gathered K and V, in turn, that consecutive calls
    read them from HBM, as K2's timed calls read their pools."""
    import itertools

    import torch
    import torch.nn.functional as F

    b, kvh, g, hd = q.shape
    bs, mb = kd.shape[1], table.shape[1]
    lmax = int(valid.sum(dim=1).max())
    idx = torch.sort((~valid).to(torch.int32), dim=1,
                     stable=True).indices[:, :lmax]
    safe = torch.where(table >= 0, table, 0).long()

    def live(x):
        xg = x[safe].reshape(b, mb * bs, kvh, hd).to(torch.bfloat16)
        xg = xg.gather(1, idx[:, :, None, None].expand(b, lmax, kvh, hd))
        return xg.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()

    qs = q.reshape(b, kvh * g, 1, hd)
    mask = valid.gather(1, idx)[:, None, None, :]
    kg, vg = live(kd), live(vd)
    kv = [(kg, vg)] + [(kg.clone(), vg.clone()) for _ in range(
        copies_past_l2(2 * kg.numel() * 2, limit) - 1)]
    turn = itertools.count()

    def sdpa():
        k_, v_ = kv[next(turn) % len(kv)]
        return F.scaled_dot_product_attention(qs, k_, v_, attn_mask=mask)

    return sdpa


def k2_case(softcap, gen, card: str, max_pos: int):
    """K2a against its plain version, and against the plain version in
    fp32, at the decode shape (B=8, KV=4, G=8, hd=64, bs=8) with ragged pos
    and -1 table entries past each row."""
    import torch

    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    from repro_torch.kernels.paged_attention.ref import (attended,
                                                         paged_attention_ref)

    b, kvh, g, hd, bs = SLOTS, 4, 8, 64, BLOCK
    table_np, pos_np, nb, mb = _decode_table(max_pos)
    dev = "cuda"
    table = torch.from_numpy(table_np).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    kp = torch.randn((nb, bs, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    vp = torch.randn((nb, bs, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    got = paged_attention(q, kp, vp, table, pos, softcap=softcap)
    again = paged_attention(q, kp, vp, table, pos, softcap=softcap)
    want = paged_attention_ref(q, kp, vp, table, pos, softcap=softcap)
    f32 = paged_attention_ref(q.float(), kp, vp, table, pos, softcap=softcap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err32 = float((got - f32).abs().max())
    tol = K2_TOL_FACTOR * float(vp.abs().max()) + 1e-5
    tol32 = K2B_F32_RTOL * float(vp.abs().max())
    res = {"softcap": softcap, "max_abs_err": err, "tol": tol,
           "max_abs_err_f32": err32, "tol_f32": tol32,
           "repeat_bit_equal": bool(torch.equal(got, again))}
    res["ok"] = err <= tol and err32 <= tol32 and res["repeat_bit_equal"]

    pools = [(kp.clone(), vp.clone())
             for _ in range(copies_past_l2(2 * kp.numel() * 2, 64))]
    it = iter(range(1 << 30))

    def run_kernel():
        k_, v_ = pools[next(it) % len(pools)]
        paged_attention(q, k_, v_, table, pos, softcap=softcap)

    def run_plain():
        k_, v_ = pools[next(it) % len(pools)]
        paged_attention_ref(q, k_, v_, table, pos, softcap=softcap)

    res["ms"] = time_ms(run_kernel, K2_ITERS)
    res["graph_ms"] = graph_ms(run_kernel)
    res["host_ms"] = host_ms(lambda: paged_attention(q, kp, vp, table, pos,
                                                     softcap=softcap))
    res["plain_ms"] = time_ms(run_plain)
    res["library_ms"] = res["library_graph_ms"] = None
    if softcap is None:
        sdpa = sdpa_yardstick(q, kp, vp, table, attended(pos, mb * bs))
        res["library_ms"] = time_ms(sdpa, K2_ITERS)
        res["library_graph_ms"] = graph_ms(sdpa)
    tokens = int(pos_np.sum()) + b          # tokens each row attends
    res["bytes"] = (2 * b * kvh * g * hd + 2 * 2 * tokens * kvh * hd
                    + 4 * b * mb + 4 * b + 4 * b * kvh * g * hd)
    res["flops"] = 4.0 * tokens * kvh * g * hd
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    lib = "n/a (no softcap in SDPA)" if res["library_ms"] is None \
        else (f"{res['library_ms']:.4f} ms, graph "
              f"{res['library_graph_ms']:.4f} ms")
    print(f"[kernels] paged_attention B={b} KV={kvh} G={g} hd={hd} bs={bs} "
          f"max_pos={int(pos_np.max())} softcap={softcap}: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}), vs fp32 plain {err32:.3e} (tol "
          f"{tol32:.3e}) -> {'ok' if res['ok'] else 'FAIL'}; two calls "
          f"{'bit-identical' if res['repeat_bit_equal'] else 'DIFFER'}; "
          f"kernel {res['ms']:.4f} ms back to back, {res['graph_ms']:.4f} "
          f"ms graph (host {res['host_ms']:.4f} ms a call), plain "
          f"{res['plain_ms']:.4f} ms, library (SDPA) {lib}, "
          f"bound {res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) "
          f"[{card}]")
    return res


def k4_case(m: int, k: int, n: int, bits: int, gen, card: str):
    """K4 against its plain version and against K1 on the unpacked codes at
    (M, K, N) and ``bits``. Returns a result dict."""
    import torch

    from repro_torch.kernels.quant_matmul.quant_matmul import (
        quant_matmul, quant_matmul_packed)
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_packed_ref
    from repro_torch.quant.pack import pack_codes

    dev = "cuda"
    half = 1 << (bits - 1)
    x = torch.randn((m, k), generator=gen, device=dev)
    codes = torch.randint(-half, half, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
    packed = pack_codes(codes, bits)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
    bias = (torch.rand((n,), generator=gen, device=dev) - 0.5) * 1e-3
    rowsum = x.sum(dim=1)
    got = quant_matmul_packed(x, packed, scale, bias, rowsum, bits=bits, k=k)
    want = quant_matmul_packed_ref(x, packed, scale, bias, bits=bits, k=k)
    k1 = quant_matmul(x, codes, scale, bias, rowsum)
    w = codes.to(torch.float32) * scale + bias
    mag = x.abs() @ w.abs()
    torch.cuda.synchronize()
    err = (got - want).abs()
    k1_diff = (got - k1).abs()
    bit_equal = bool(torch.equal(got, k1))
    ok = bool((err <= K4_RTOL * mag + 1e-6).all()) \
        and bool((k1_diff <= K1_RTOL * mag + 1e-6).all())
    res = {"shape": (m, k, n), "bits": bits,
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / (mag + 1e-30)).max()),
           "k1_bit_equal": bit_equal, "k1_max_abs_diff": float(k1_diff.max()),
           "ok": ok}

    pc = [packed.clone() for _ in range(copies_past_l2(packed.numel()))]
    cc = [codes.clone() for _ in range(copies_past_l2(codes.numel()))]
    wc = [w.clone() for _ in range(copies_past_l2(4 * w.numel(), 64))]
    it = iter(range(1 << 30))
    res["ms"] = time_ms(lambda: quant_matmul_packed(
        x, pc[next(it) % len(pc)], scale, bias, rowsum, bits=bits, k=k))
    res["k1_ms"] = time_ms(lambda: quant_matmul(
        x, cc[next(it) % len(cc)], scale, bias, rowsum))
    res["plain_ms"] = time_ms(lambda: quant_matmul_packed_ref(
        x, pc[next(it) % len(pc)], scale, bias, bits=bits, k=k))
    res["library_ms"] = time_ms(lambda: x @ wc[next(it) % len(wc)])
    res["bytes"] = 4 * m * k + packed.numel() + 8 * n + 4 * m + 4 * m * n
    res["flops"] = 2.0 * m * n * k
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    print(f"[kernels] quant_matmul_packed {bits}-bit M={m} K={k} N={n}: "
          f"max_abs_err {res['max_abs_err']:.3e}, max err/(|x|@|w|) "
          f"{res['max_rel_err']:.3e} (tol {K4_RTOL:g}); vs K1 on the "
          f"unpacked codes {'bit-equal' if bit_equal else 'NOT bit-equal'} "
          f"(max diff {res['k1_max_abs_diff']:.3e}) -> "
          f"{'ok' if ok else 'FAIL'}; kernel {res['ms']:.4f} ms, K1 "
          f"{res['k1_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library "
          f"(x @ w_fp32) {res['library_ms']:.4f} ms, bound "
          f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) [{card}]")
    return res


def _int_operands(m: int, k: int, n: int, bits: int, gen):
    """fp32 activations with their 8-bit signed grid, their codes and row
    sums (plain version), ``bits``-bit weight codes and random epilogue
    vectors, on the card."""
    import torch

    from repro_torch.core.quantizer import affine_grid
    from repro_torch.kernels.quant_matmul.ref import quantize_act_ref

    dev = "cuda"
    x = torch.randn((m, k), generator=gen, device=dev) * 1.5
    beta = torch.tensor(4.0, device=dev)
    s, _ = affine_grid(INT_ACT_BITS, beta, True)
    grid = torch.stack([-beta, beta, s])
    qx, rowsum = quantize_act_ref(x, grid, INT_ACT_BITS)
    half = 1 << (bits - 1)
    codes = torch.randint(-half, half, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
    es = torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-5
    eb = (torch.rand((n,), generator=gen, device=dev) - 0.5) * 2e-4
    cst = torch.rand((n,), generator=gen, device=dev) - 0.5
    return x, grid, qx, rowsum, codes, es, eb, cst


def _int_mm_ms(qx, codes):
    """``torch._int_mm`` (int8 x int8 -> int32, no epilogue) on the same
    codes, at M = max(M, INT_MM_MIN_M) (it needs M > 16); None where K or N
    is not a multiple of 8, which it refuses."""
    import torch

    m, k = qx.shape
    n = codes.shape[1]
    if k % 8 or n % 8:
        return None, m
    mm = max(m, INT_MM_MIN_M)
    a = torch.zeros((mm, k), dtype=torch.int8, device=qx.device)
    a[:m] = qx
    cc = [codes.clone() for _ in range(copies_past_l2(codes.numel()))]
    it = iter(range(1 << 30))
    return time_ms(lambda: torch._int_mm(a, cc[next(it) % len(cc)])), mm


def k5_case(m: int, k: int, n: int, gen, card: str):
    """K5 against its plain version at (M, K, N), bit for bit, with both
    loaders: int8 activation codes with their row sums (the TPU kernel's
    contract) and fp32 activations quantized in the kernel (the serving
    path's launch, the one timed). Returns a result dict."""
    import torch

    from repro_torch.kernels.quant_matmul.quant_matmul import int_matmul
    from repro_torch.kernels.quant_matmul.ref import (int_matmul_ref,
                                                      quantize_act_ref)

    x, grid, qx, rowsum, codes, es, eb, cst = _int_operands(m, k, n, 8, gen)
    act = (grid, INT_ACT_BITS)
    want = int_matmul_ref(qx, codes, es, eb, rowsum, cst)
    got = int_matmul(qx, codes, es, eb, rowsum, cst)
    fused = int_matmul(x, codes, es, eb, None, cst, act=act)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum()) + int((fused != want).sum())
    err = max(float((got - want).abs().max()),
              float((fused - want).abs().max()))
    res = {"shape": (m, k, n), "mismatches": mismatches, "max_abs_err": err,
           "ok": mismatches == 0}

    cc = [codes.clone() for _ in range(copies_past_l2(codes.numel()))]
    it = iter(range(1 << 30))
    res["ms"] = time_ms(lambda: int_matmul(
        x, cc[next(it) % len(cc)], es, eb, None, cst, act=act))
    res["codes_in_ms"] = time_ms(lambda: int_matmul(
        qx, cc[next(it) % len(cc)], es, eb, rowsum, cst))

    def plain():
        q, r = quantize_act_ref(x, grid, INT_ACT_BITS)
        return int_matmul_ref(q, cc[next(it) % len(cc)], es, eb, r, cst)

    res["plain_ms"] = time_ms(plain)
    res["library_ms"], res["library_m"] = _int_mm_ms(qx, codes)
    res["bytes"] = 4 * m * k + k * n + 12 * n + 12 + 4 * m * n
    res["flops"] = 2.0 * m * n * k
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"],
                                                INT8_OPS_S)
    lib = "n/a (K, N not multiples of 8)" if res["library_ms"] is None \
        else f"{res['library_ms']:.4f} ms at M={res['library_m']}"
    print(f"[kernels] int_matmul M={m} K={k} N={n}: {mismatches} mismatches "
          f"against the plain version in 2 x {m * n} elements (bit for bit)"
          f" -> {'ok' if res['ok'] else 'FAIL'}; kernel {res['ms']:.4f} ms "
          f"(int8 codes in: {res['codes_in_ms']:.4f} ms), plain "
          f"{res['plain_ms']:.4f} ms, library (torch._int_mm) {lib}, bound "
          f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) [{card}]")
    return res


def k6_case(m: int, k: int, n: int, bits: int, gen, card: str):
    """K6 against its plain version, and against K5 on the unpacked codes,
    bit for bit, at (M, K, N) and ``bits``, with both loaders; timed with
    the fp32 loader. Returns a result dict."""
    import torch

    from repro_torch.kernels.quant_matmul.quant_matmul import (
        int_matmul, int_matmul_packed)
    from repro_torch.kernels.quant_matmul.ref import (int_matmul_packed_ref,
                                                      quantize_act_ref)
    from repro_torch.quant.pack import pack_codes

    x, grid, qx, rowsum, codes, es, eb, cst = _int_operands(m, k, n, bits,
                                                            gen)
    packed = pack_codes(codes, bits)
    act = (grid, INT_ACT_BITS)
    want = int_matmul_packed_ref(qx, packed, es, eb, rowsum, cst, bits=bits,
                                 k=k)
    got = int_matmul_packed(qx, packed, es, eb, rowsum, cst, bits=bits, k=k)
    fused = int_matmul_packed(x, packed, es, eb, None, cst, bits=bits, k=k,
                              act=act)
    k5 = int_matmul(x, codes, es, eb, None, cst, act=act)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum()) + int((fused != want).sum())
    k5_mismatches = int((fused != k5).sum())
    err = max(float((got - want).abs().max()),
              float((fused - want).abs().max()))
    res = {"shape": (m, k, n), "bits": bits, "mismatches": mismatches,
           "k5_mismatches": k5_mismatches, "max_abs_err": err,
           "ok": mismatches == 0 and k5_mismatches == 0}

    pc = [packed.clone() for _ in range(copies_past_l2(packed.numel()))]
    it = iter(range(1 << 30))
    res["ms"] = time_ms(lambda: int_matmul_packed(
        x, pc[next(it) % len(pc)], es, eb, None, cst, bits=bits, k=k,
        act=act))

    def plain():
        q, r = quantize_act_ref(x, grid, INT_ACT_BITS)
        return int_matmul_packed_ref(q, pc[next(it) % len(pc)], es, eb, r,
                                     cst, bits=bits, k=k)

    res["plain_ms"] = time_ms(plain)
    res["library_ms"], res["library_m"] = _int_mm_ms(qx, codes)
    res["bytes"] = 4 * m * k + packed.numel() + 12 * n + 12 + 4 * m * n
    res["flops"] = 2.0 * m * n * k
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"],
                                                INT8_OPS_S)
    lib = "n/a (K, N not multiples of 8)" if res["library_ms"] is None \
        else f"{res['library_ms']:.4f} ms at M={res['library_m']}"
    print(f"[kernels] int_matmul_packed {bits}-bit M={m} K={k} N={n}: "
          f"{mismatches} mismatches against the plain version in 2 x "
          f"{m * n} elements (bit for bit), {k5_mismatches} against K5 on "
          f"the unpacked codes -> {'ok' if res['ok'] else 'FAIL'}; kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library "
          f"(torch._int_mm, unpacked codes) {lib}, bound "
          f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) [{card}]")
    return res


def _decode_table(max_pos: int):
    """Ragged positions (the first at max_pos - 1) and a block table with
    only the blocks up to each pos mapped: the plain version (like the JAX
    oracle) gathers -1 entries from the garbage block, so a -1 at or below
    pos would make the two differ by design."""
    import numpy as np

    mb = -(-MAX_SEQ // BLOCK)
    nb = SLOTS * mb + 1
    rng = np.random.default_rng(SEED + 1)
    pos = rng.integers(0, max_pos, SLOTS).astype(np.int32)
    pos[0] = max_pos - 1
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((SLOTS, mb), -1, np.int32)
    for i, p in enumerate(pos):
        nblk = p // BLOCK + 1
        table[i, :nblk] = perm[i * mb:i * mb + nblk]
    return table, pos, nb, mb


def k2b_case(kv_dtype: str, gen, card: str, max_pos: int):
    """K2b against its plain version (and the plain version in fp32) at the
    decode shape (B=8, KV=4, G=8, hd=64, bs=8) over an int8 or int4 pool
    quantized by the port's codec (groups of 32: ng = 2)."""
    import torch

    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_quant
    from repro_torch.kernels.paged_attention.ref import (
        attended, bf16_rounding_tolerance, paged_attention_ref)
    from repro_torch.quant.kv import KVQuantSpec, dequantize_kv, quantize_kv

    b, kvh, g, hd, bs = SLOTS, 4, 8, 64, BLOCK
    table_np, pos_np, nb, mb = _decode_table(max_pos)
    dev = "cuda"
    table = torch.from_numpy(table_np).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    spec = KVQuantSpec(bits=8 if kv_dtype == "int8" else 4, group_size=32,
                       head_dim=hd)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    (kc, ks), (vc, vs) = (quantize_kv(torch.randn(
        (nb, bs, kvh, hd), generator=gen, device=dev), spec)
        for _ in range(2))
    kd, vd = dequantize_kv(kc, ks, spec), dequantize_kv(vc, vs, spec)
    got = paged_attention_quant(q, kc, vc, ks, vs, table, pos)
    again = paged_attention_quant(q, kc, vc, ks, vs, table, pos)
    want = paged_attention_ref(q, kc, vc, table, pos, k_scale=ks, v_scale=vs)
    f32 = paged_attention_ref(q.float(), kc, vc, table, pos, k_scale=ks,
                              v_scale=vs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err32 = float((got - f32).abs().max())
    tol = bf16_rounding_tolerance(q, kd, vd, table, pos)
    tol32 = K2B_F32_RTOL * float(vd.abs().max())
    res = {"kv_dtype": kv_dtype, "max_abs_err": err, "tol": tol,
           "max_abs_err_f32": err32, "tol_f32": tol32,
           "repeat_bit_equal": bool(torch.equal(got, again))}
    res["ok"] = err <= tol and err32 <= tol32 and res["repeat_bit_equal"]

    per_copy = 2 * (kc.numel() + ks.numel() * 2)
    pools = [(kc.clone(), vc.clone(), ks.clone(), vs.clone())
             for _ in range(copies_past_l2(per_copy, 64))]
    it = iter(range(1 << 30))

    def run_kernel():
        k_, v_, ks_, vs_ = pools[next(it) % len(pools)]
        paged_attention_quant(q, k_, v_, ks_, vs_, table, pos)

    def run_plain():
        k_, v_, ks_, vs_ = pools[next(it) % len(pools)]
        paged_attention_ref(q, k_, v_, table, pos, k_scale=ks_, v_scale=vs_)

    res["ms"] = time_ms(run_kernel, K2_ITERS)
    res["graph_ms"] = graph_ms(run_kernel)
    res["host_ms"] = host_ms(lambda: paged_attention_quant(
        q, kc, vc, ks, vs, table, pos))
    res["plain_ms"] = time_ms(run_plain)
    sdpa = sdpa_yardstick(q, kd, vd, table, attended(pos, mb * bs))
    res["library_ms"] = time_ms(sdpa, K2_ITERS)
    res["library_graph_ms"] = graph_ms(sdpa)
    tokens = int(pos_np.sum()) + b          # tokens each row attends
    vec_bytes = spec.bytes_per_vector()     # codes + fp16 scales
    res["bytes"] = (2 * b * kvh * g * hd + 2 * tokens * kvh * vec_bytes
                    + 4 * b * mb + 4 * b + 4 * b * kvh * g * hd)
    res["flops"] = 4.0 * tokens * kvh * g * hd
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    print(f"[kernels] paged_attention_quant {kv_dtype} B={b} KV={kvh} G={g} "
          f"hd={hd} bs={bs} max_pos={int(pos_np.max())}: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}), vs fp32 plain {err32:.3e} (tol "
          f"{tol32:.3e}), two calls "
          f"{'bit-identical' if res['repeat_bit_equal'] else 'DIFFER'} -> "
          f"{'ok' if res['ok'] else 'FAIL'}; kernel {res['ms']:.4f} ms "
          f"back to back, {res['graph_ms']:.4f} ms graph (host "
          f"{res['host_ms']:.4f} ms a call), plain {res['plain_ms']:.4f} "
          f"ms, library (SDPA, gathered dequantized KV) "
          f"{res['library_ms']:.4f} ms, graph "
          f"{res['library_graph_ms']:.4f} ms, bound "
          f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) [{card}]")
    return res


def _window_table(max_pos: int, window: int | None, sinks: int):
    """Ragged positions (the first at max_pos - 1, the second below the
    window, where only the clamp to the sink blocks keeps fl >= 0) over
    WIN_MAX_SEQ-token tables, with the blocks wholly outside the sinks and
    the window evicted (-1), as the serve-window engine leaves them; with
    ``window`` None nothing is evicted. Every -1 lies outside the live
    span, where the plain version masks what it gathers from block 0."""
    import numpy as np

    mb = -(-WIN_MAX_SEQ // BLOCK)
    nb = SLOTS * mb + 1
    rng = np.random.default_rng(SEED + 5)
    pos = rng.integers(0, max_pos, SLOTS).astype(np.int32)
    pos[0], pos[1] = max_pos - 1, WIN_WINDOW // 2
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((SLOTS, mb), -1, np.int32)
    sink_blocks = -(-sinks // BLOCK)
    for i, p in enumerate(pos):
        nblk = p // BLOCK + 1
        table[i, :nblk] = perm[i * mb:i * mb + nblk]
        if window is not None:
            fl = max((int(p) - window + 1) // BLOCK, sink_blocks)
            table[i, sink_blocks:fl] = -1
    return table, pos, nb, mb


def k2c_case(pool: str, window: int, sinks: int, gen, card: str,
             max_pos: int, timed: bool):
    """K2c against its plain version, and against the plain version in
    fp32, at the decode shape (B=8, KV=4, G=8,
    hd=64, bs=8, positions up to max_pos - 1) over a ``pool`` ("bf16",
    "fp32", "int8", "int4") pool, the table evicted as the engine leaves
    it; under a window that does not bind, also bit for bit against K2a or
    K2b. ``timed``: K2c, K2a/K2b on the unevicted table, the plain version
    and SDPA over the K/V gathered to the live span (L2-cold)."""
    import torch

    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention, paged_attention_quant, paged_attention_quant_window,
        paged_attention_window)
    from repro_torch.kernels.paged_attention.ref import (
        attended, bf16_rounding_tolerance, paged_attention_ref)
    from repro_torch.quant.kv import KVQuantSpec, dequantize_kv, quantize_kv

    b, kvh, g, hd, bs = SLOTS, 4, 8, 64, BLOCK
    full_np, pos_np, nb, mb = _window_table(max_pos, None, 0)
    dev = "cuda"
    table = torch.from_numpy(_window_table(max_pos, window, sinks)[0]).to(
        dev)
    full = torch.from_numpy(full_np).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    quant = pool in ("int8", "int4")
    if quant:
        spec = KVQuantSpec(bits=int(pool[-1]), group_size=32, head_dim=hd)
        (kc, ks), (vc, vs) = (quantize_kv(torch.randn(
            (nb, bs, kvh, hd), generator=gen, device=dev), spec)
            for _ in range(2))
        pools = (kc, vc, ks, vs)
        kd, vd = dequantize_kv(kc, ks, spec), dequantize_kv(vc, vs, spec)
        vec_bytes = spec.bytes_per_vector()
    else:
        dt = torch.bfloat16 if pool == "bf16" else torch.float32
        pools = tuple(torch.randn((nb, bs, kvh, hd), generator=gen,
                                  device=dev).to(dt) for _ in range(2))
        kd, vd = (t.float() for t in pools)
        vec_bytes = hd * pools[0].element_size()
    win = {"window": window, "sinks": sinks}

    def run_k2c(pl, tbl):
        if quant:
            return paged_attention_quant_window(q, *pl, tbl, pos, **win)
        return paged_attention_window(q, *pl, tbl, pos, **win)

    def run_unwindowed(pl, tbl):
        if quant:
            return paged_attention_quant(q, *pl, tbl, pos)
        return paged_attention(q, *pl, tbl, pos)

    def run_plain(pl, tbl, qq=q):
        scales = {"k_scale": pl[2], "v_scale": pl[3]} if quant else {}
        return paged_attention_ref(qq, pl[0], pl[1], tbl, pos, **win,
                                   **scales)

    got = run_k2c(pools, table)
    again = run_k2c(pools, table)
    want = run_plain(pools, table)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    res = {"pool": pool, "window": window, "sinks": sinks,
           "max_abs_err": err,
           "repeat_bit_equal": bool(torch.equal(got, again))}
    if quant:
        res["tol"] = bf16_rounding_tolerance(q, kd, vd, table, pos, **win)
    else:
        res["tol"] = K2_TOL_FACTOR * float(vd.abs().max()) + 1e-5
    # the plain version in fp32 rounds nothing to bf16: the kernel's own
    # function, held at K2b's fp32 tolerance
    err32 = float((got - run_plain(pools, table, q.float())).abs().max())
    res["max_abs_err_f32"] = err32
    res["tol_f32"] = K2B_F32_RTOL * float(vd.abs().max())
    ok = err <= res["tol"] and err32 <= res["tol_f32"] \
        and res["repeat_bit_equal"]
    note = f", vs fp32 plain {err32:.3e} (tol {res['tol_f32']:.3e})"
    note += "; two calls " + ("bit-identical" if res["repeat_bit_equal"]
                              else "DIFFER")
    if window > int(pos_np.max()) and not sinks:
        res["bit_equal"] = bool(torch.equal(got, run_unwindowed(pools,
                                                                full)))
        ok = ok and res["bit_equal"]
        note += ("; bit-equal to " if res["bit_equal"] else
                 "; NOT bit-equal to ") + ("K2b" if quant else "K2a")
    res["ok"] = ok
    valid = attended(pos, mb * bs, window, sinks)
    tokens = int(valid.sum())               # keys the rows attend
    print(f"[kernels] paged_attention_window {pool} B={b} KV={kvh} G={g} "
          f"hd={hd} bs={bs} max_pos={int(pos_np.max())} window={window} "
          f"sinks={sinks} ({tokens} live keys): max_abs_err {err:.3e} (tol "
          f"{res['tol']:.3e}){note} -> {'ok' if ok else 'FAIL'} [{card}]")
    if not timed:
        return res

    per_copy = sum(t.numel() * t.element_size() for t in pools)
    copies = [tuple(t.clone() for t in pools)
              for _ in range(copies_past_l2(per_copy, 64))]
    it = iter(range(1 << 30))

    def kernel():
        return run_k2c(copies[next(it) % len(copies)], table)

    res["ms"] = time_ms(kernel, K2_ITERS)
    res["graph_ms"] = graph_ms(kernel)
    res["host_ms"] = host_ms(lambda: run_k2c(pools, table))
    res["unwindowed_ms"] = time_ms(lambda: run_unwindowed(
        copies[next(it) % len(copies)], full), K2_ITERS)
    res["plain_ms"] = time_ms(lambda: run_plain(
        copies[next(it) % len(copies)], table))
    sdpa = sdpa_yardstick(q, kd, vd, table, valid)
    res["library_ms"] = time_ms(sdpa, K2_ITERS)
    res["library_graph_ms"] = graph_ms(sdpa)
    res["bytes"] = (2 * b * kvh * g * hd + 2 * tokens * kvh * vec_bytes
                    + 4 * b * mb + 4 * b + 4 * b * kvh * g * hd)
    res["flops"] = 4.0 * tokens * kvh * g * hd
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    print(f"[kernels] paged_attention_window {pool} window={window} "
          f"sinks={sinks}: kernel {res['ms']:.4f} ms back to back, "
          f"{res['graph_ms']:.4f} ms graph (host {res['host_ms']:.4f} ms a "
          f"call), without the window "
          f"({'K2b' if quant else 'K2a'}, whole rows) "
          f"{res['unwindowed_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"library (SDPA, live keys gathered) {res['library_ms']:.4f} ms, "
          f"graph {res['library_graph_ms']:.4f} ms, "
          f"bound {res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) "
          f"[{card}]")
    return res


def _gemma2_decode_inputs(gen, window: int | None = None):
    """K2's operands at [serve-gemma2]'s decode shape (B 4 slots, KV 4
    heads of G 2 query heads, head_dim 256, 16-token blocks, 288 a row; bf16
    q and pool): two rows of G2_LONG prompts after a few decoded tokens
    (4200-4500 + 16), as in the profiled tick, and two short ones. The
    table maps each row's blocks up to pos and, under ``window``, evicts
    those wholly outside it, as the engine does; every other entry is -1.
    Returns (q, k_pool, v_pool, table, pos, tokens attended per row)."""
    import numpy as np
    import torch

    b, kvh, g, hd, bs = G2_SLOTS, 4, 2, 256, G2_BLOCK
    mb = G2_MAX_SEQ // bs
    nb = b * mb + 1
    rng = np.random.default_rng(SEED + 7)
    pos = np.concatenate([rng.integers(G2_LONG[1], G2_LONG[2] + 1, 2),
                          rng.integers(G2_SHORT[1], G2_SHORT[2] + 1, 2)])
    pos = (pos + MAX_NEW // 2).astype(np.int32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        table[i, :p // bs + 1] = perm[i * mb:i * mb + p // bs + 1]
        if window is not None:
            table[i, :max((int(p) - window + 1) // bs, 0)] = -1
    attended = pos + 1 if window is None else np.minimum(pos + 1, window)
    dev = "cuda"
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev), attended)


def k2_long_case(softcap, window, gen, card: str):
    """K2a (``window`` None) or K2c (``window``, no sinks) at
    [serve-gemma2]'s decode shape with two long rows
    (``_gemma2_decode_inputs``): against the plain version at K2a's
    tolerance and against the plain version in fp32 (which rounds nothing
    to bf16: the kernel's own function) at K2b's fp32 tolerance, two calls
    bit-identical, K2c under a window that does not bind (the table's whole
    span) bit-equal to K2a. Times, over copies of the pools taken in turn
    so that each call reads its K/V from HBM: back to back from Python
    (``ms``), the device alone (``graph_ms``, a replayed CUDA graph; the
    bound fraction is the bytes bound over it), the host's work a call
    (``host_ms``), the plain version, and SDPA (``sdpa_yardstick``; no
    softcap, which SDPA lacks)."""
    import torch

    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention, paged_attention_window)
    from repro_torch.kernels.paged_attention.ref import (attended,
                                                         paged_attention_ref)

    q, kp, vp, table, pos, tokens = _gemma2_decode_inputs(gen, window)
    b, kvh, g, hd = q.shape
    bs, mb = kp.shape[1], table.shape[1]
    win = {} if window is None else {"window": window, "sinks": 0}

    def kernel(k_=kp, v_=vp):
        if window is None:
            return paged_attention(q, k_, v_, table, pos, softcap=softcap)
        return paged_attention_window(q, k_, v_, table, pos, **win,
                                      softcap=softcap)

    got, again = kernel(), kernel()
    want = paged_attention_ref(q, kp, vp, table, pos, softcap=softcap, **win)
    f32 = paged_attention_ref(q.float(), kp, vp, table, pos,
                              softcap=softcap, **win)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err32 = float((got - f32).abs().max())
    del want, f32
    tol = K2_TOL_FACTOR * float(vp.abs().max()) + 1e-5
    tol32 = K2B_F32_RTOL * float(vp.abs().max())
    res = {"softcap": softcap, "window": window, "max_abs_err": err,
           "tol": tol, "max_abs_err_f32": err32, "tol_f32": tol32,
           "repeat_bit_equal": bool(torch.equal(got, again))}
    ok = err <= tol and err32 <= tol32 and res["repeat_bit_equal"]
    note = ""
    if window is not None:
        # a window that cannot bind: K2a's chunks, so K2a's bits
        wide = paged_attention_window(q, kp, vp, table, pos, window=mb * bs,
                                      softcap=softcap)
        res["unbound_bit_equal"] = bool(torch.equal(
            wide, paged_attention(q, kp, vp, table, pos, softcap=softcap)))
        ok = ok and res["unbound_bit_equal"]
        note = ("; window %d bit-equal to K2a" if res["unbound_bit_equal"]
                else "; window %d NOT bit-equal to K2a") % (mb * bs)
    res["ok"] = ok
    n = int(tokens.sum())                  # keys the rows attend
    res["bytes"] = (2 * b * kvh * g * hd + 2 * 2 * n * kvh * hd
                    + 4 * b * mb + 4 * b + 4 * b * kvh * g * hd)
    res["flops"] = 4.0 * n * kvh * g * hd
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    copies = [(kp.clone(), vp.clone())
              for _ in range(copies_past_l2(res["bytes"], 8))]
    it = iter(range(1 << 30))

    def rotated():
        return kernel(*copies[next(it) % len(copies)])

    res["ms"] = time_ms(rotated, K2_ITERS)
    res["graph_ms"] = graph_ms(rotated)
    res["host_ms"] = host_ms(kernel)
    res["plain_ms"] = time_ms(lambda: paged_attention_ref(
        q, *copies[next(it) % len(copies)], table, pos, softcap=softcap,
        **win), iters=5, warmup=1)
    del copies
    sdpa = sdpa_yardstick(q, kp, vp, table, attended(pos, mb * bs, window),
                          limit=8)
    res["library_ms"] = time_ms(sdpa, K2_ITERS)
    res["library_graph_ms"] = graph_ms(sdpa)
    res["bound_fraction"] = res["bound_ms"] / res["graph_ms"]
    del sdpa
    torch.cuda.empty_cache()
    name = "paged_attention" if window is None else \
        f"paged_attention_window window={window}"
    print(f"[kernels] {name} gemma2 long rows B={b} KV={kvh} G={g} hd={hd} "
          f"bs={bs} max_blocks={mb} pos={pos.tolist()} softcap={softcap}: "
          f"max_abs_err {err:.3e} (tol {tol:.3e}), vs fp32 plain "
          f"{err32:.3e} (tol {tol32:.3e}), two calls "
          f"{'bit-identical' if res['repeat_bit_equal'] else 'DIFFER'}"
          f"{note} -> {'ok' if ok else 'FAIL'}; kernel {res['ms']:.4f} ms "
          f"back to back, {res['graph_ms']:.4f} ms device (graph), host "
          f"{res['host_ms']:.4f} ms a call; plain {res['plain_ms']:.4f} ms; "
          f"library (SDPA, attended keys gathered, no softcap) "
          f"{res['library_ms']:.4f} ms, {res['library_graph_ms']:.4f} ms "
          f"graph; bound {res['bound_ms'] * 1e3:.2f} us "
          f"({res['bound_by']}), {res['bound_fraction']:.3f} of it reached "
          f"[{card}]")
    return res


def mixed_k4_shapes(cfg) -> dict:
    """(K, N, bits) -> launches per forward of the mixed state's packed
    sites: 2-bit head, attn_q, mlp_gate; 4-bit attn_k, attn_v, mlp_up (the
    8-bit attn_o and mlp_down run K1)."""
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    return {(d, cfg.padded_vocab, 2): 1,
            (d, cfg.n_heads * hd, 2): layers,
            (d, cfg.d_ff, 2): layers,
            (d, cfg.n_kv_heads * hd, 4): 2 * layers,
            (d, cfg.d_ff, 4): layers}


def k3_shapes(cfg) -> dict:
    """(M, N, dtype) -> K3 launches per CGMQ forward of the [train] phase:
    the 155 weight sites (fp32 params; the head is the tied embedding,
    transposed) and the 66 fake-quantized activations (bf16, M = batch x
    seq: attn_o, mlp_up and mlp_down of every layer)."""
    d, hd, layers, ff = cfg.d_model, cfg.head_dim, cfg.n_layers, cfg.d_ff
    m = TRAIN_BATCH * TRAIN_SEQ
    return {(d, cfg.n_heads * hd, "float32"): 2 * layers,      # q, o
            (d, cfg.n_kv_heads * hd, "float32"): 2 * layers,   # k, v
            (d, ff, "float32"): 2 * layers,                    # gate, up
            (ff, d, "float32"): layers,                        # down
            (d, cfg.padded_vocab, "float32"): 1,               # head
            (m, d, "bfloat16"): 2 * layers,         # attn_o, mlp_down acts
            (m, ff, "bfloat16"): layers}            # mlp_up acts


def k3_case(m: int, n: int, dtype: str, gen, card: str):
    """K3 against its plain version at (M, N), bit for bit: per-channel
    gates over every level (and below the 0.5 clamp) and the [train]
    phase's scalar 16-bit gate, signed and unsigned. Timed at the scalar
    gate, signed, L2-cold, from a replayed CUDA graph (``graph_ms``): a
    launch is a few microseconds of device work, less than the wrapper's
    host cost."""
    import torch

    from repro_torch.kernels.fake_quant.fake_quant import fake_quant
    from repro_torch.kernels.fake_quant.ref import fake_quant_ref

    dev = "cuda"
    dt = getattr(torch, dtype)
    x = (torch.randn((m, n), generator=gen, device=dev) * 1.5).to(dt)
    levels = torch.tensor(K3_LEVELS, device=dev)
    gate = levels[torch.arange(n, device=dev) % len(levels)]
    scalar = torch.full((n,), TRAIN_GATE0, device=dev)
    beta = torch.rand((n,), generator=gen, device=dev) * 1.7 + 0.3
    mismatches, err = 0, 0.0
    for g in (gate, scalar):
        for signed in (True, False):
            got = fake_quant(x, g, beta, signed)
            want = fake_quant_ref(x, g, beta, signed)
            mismatches += int((got != want).sum())
            err = max(err, float((got.float() - want.float()).abs().max()))
    res = {"shape": (m, n), "dtype": dtype, "mismatches": mismatches,
           "max_abs_err": err, "ok": mismatches == 0}

    xc = [x.clone() for _ in range(copies_past_l2(x.numel()
                                                  * x.element_size()))]
    it = iter(range(1 << 30))
    res["ms"] = graph_ms(lambda: fake_quant(xc[next(it) % len(xc)], scalar,
                                            beta, True))
    res["plain_ms"] = graph_ms(lambda: fake_quant_ref(
        xc[next(it) % len(xc)], scalar, beta, True))
    # yardstick: the 8-bit per-tensor fake-quant of PyTorch, the same grid
    # rounded in another order (a time, not a reference)
    b0 = float(beta[0])
    res["library_ms"] = graph_ms(
        lambda: torch.fake_quantize_per_tensor_affine(
            xc[next(it) % len(xc)], 2 * b0 / 255, 0, -128, 127))
    res["bytes"] = 2 * m * n * x.element_size() + 8 * n
    res["flops"] = K3_FLOPS_PER_ELEMENT * m * n
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    print(f"[kernels] fake_quant {dtype} M={m} N={n}: {mismatches} "
          f"mismatches in 4 x {m * n} elements (bit for bit) -> "
          f"{'ok' if res['ok'] else 'FAIL'}; kernel {res['ms']:.4f} ms, "
          f"plain {res['plain_ms']:.4f} ms, library "
          f"(fake_quantize_per_tensor_affine, 8 bits) "
          f"{res['library_ms']:.4f} ms, bound {res['bound_ms'] * 1e3:.2f} us "
          f"({res['bound_by']}) [{card}]")
    return res


def k7_case(case, gen, card: str):
    """K7 against its plain version at one whole-prompt shape, inputs in
    the model's (B, S, H, hd) layout read through (B, H, S, hd) strides as
    attention_train hands them; kernel, plain and library (SDPA over the
    same tensors and mask) times, and the bound: the inputs and output
    moved once, the attended (q, k) pairs' 4 hd FLOPs at the tensor-core
    peak of the operands' type. Kernel and library times: ``ms`` and
    ``library_ms`` over back-to-back calls from Python, as every K7 time
    before the tensor-core kernel was taken, so the host's work per call
    counts where it exceeds the device's; ``graph_ms`` and
    ``library_graph_ms`` the device time alone, of a replayed CUDA graph;
    ``host_ms`` the host's wall time per wrapper call. Returns a result
    dict."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, kernel_for)
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         flash_attention_ref,
                                                         k7_tolerance)

    name, b, hq, hkv, hd, s, dtype, window, sinks, cap = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
               .to(dt).transpose(1, 2) for h in (hq, hkv, hkv))
    kw = {"causal": True, "window": window, "sinks": sinks, "softcap": cap}
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    vmax = float(v.float().abs().max())
    err = (got.float() - want.float()).abs()
    tol = k7_tolerance(want, v)
    res = {"case": name, "max_abs_err": float(err.max()),
           "ok": bool((err <= tol).all()), "kernel": kernel_for(dt, hd),
           "worst": float((err / tol).max())}
    mask = attention_mask(s, window=window, sinks=sinks, device="cuda")
    lib_kw = {"is_causal": True} if window is None else {"attn_mask": mask}

    def library():
        return F.scaled_dot_product_attention(q, k, v, scale=hd ** -0.5,
                                              enable_gqa=True, **lib_kw)

    def kernel():
        return flash_attention(q, k, v, **kw)

    res["ms"] = time_ms(kernel, iters=10, warmup=2)
    res["graph_ms"] = graph_ms(kernel, iters=10, warmup=2)
    res["host_ms"] = host_ms(kernel)
    res["plain_ms"] = time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              iters=5, warmup=1)
    res["library_ms"] = time_ms(library, iters=10, warmup=2)
    res["library_graph_ms"] = graph_ms(library, iters=10, warmup=2)
    lib_err = ""
    if cap is None:     # then SDPA computes the same function
        diff = float((library().float() - want.float()).abs().max())
        lib_err = f", |SDPA - plain| {diff:.3e}"
    pairs = int(mask.sum()) * b * hq
    res["bytes"] = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    res["flops"] = 4.0 * hd * pairs
    res["bound_ms"], res["bound_by"] = bound_ms(
        res["bytes"], res["flops"],
        BF16_FLOP_S if dt == torch.bfloat16 else FP32_FLOP_S)
    print(f"[kernels] flash_attention {name} ({res['kernel']} kernel): "
          f"B={b} Hq={hq} Hkv={hkv} hd={hd} S={s} {dtype} window={window} "
          f"sinks={sinks} softcap={cap}: max_abs_err "
          f"{res['max_abs_err']:.3e} (max|v| {vmax:.3f}; worst element "
          f"{res['worst']:.3f} of its tolerance) -> "
          f"{'ok' if res['ok'] else 'FAIL'}; kernel {res['ms']:.4f} ms "
          f"back to back (replayed graph {res['graph_ms']:.4f}, "
          f"{res['flops'] / res['graph_ms'] * 1e-9:.1f} TFLOP/s; host "
          f"{res['host_ms']:.4f} a call), plain {res['plain_ms']:.4f} ms, "
          f"library (SDPA{', no softcap' if cap is not None else ''}) "
          f"{res['library_ms']:.4f} ms back to back (replayed graph "
          f"{res['library_graph_ms']:.4f}){lib_err}; {pairs} attended pairs, "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) [{card}]")
    return res


def phase_kernels(cfg, m_prefill: int, card: str):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d, hd = cfg.d_model, cfg.head_dim
    qkvo = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
            (d, cfg.d_ff), (cfg.d_ff, d), (d, cfg.padded_vocab)]
    k1 = {}
    for m in (SLOTS, m_prefill):
        for k, n in qkvo:
            k1[(m, k, n)] = k1_case(m, k, n, gen, card)
    k1[(3, 100, 37)] = k1_case(3, 100, 37, gen, card)
    max_pos = PROMPT_HI + MAX_NEW
    k2 = [k2_case(None, gen, card, max_pos),
          k2_case(30.0, gen, card, max_pos)]
    k4 = {}
    for m in (SLOTS, m_prefill):
        for k, n, bits in mixed_k4_shapes(cfg):
            k4[(m, k, n, bits)] = k4_case(m, k, n, bits, gen, card)
    for bits in (2, 4):
        k4[(3, 101, 37, bits)] = k4_case(3, 101, 37, bits, gen, card)
    k2b = {kv: k2b_case(kv, gen, card, max_pos) for kv in ("int8", "int4")}
    win_pos = WIN_PROMPT_HI + MAX_NEW
    k2c = {(pool, w, sk): k2c_case(pool, w, sk, gen, card, win_pos,
                                   timed=(w, sk) == K2C_CASES[0])
           for pool in ("bf16", "fp32", "int8", "int4")
           for w, sk in K2C_CASES}
    # [serve-gemma2]'s decode shape, two long rows: K2a with gemma2's
    # softcap and without (SDPA's function), K2c under its 4096 window
    k2_long = {key: k2_long_case(*key, gen, card)
               for key in ((50.0, None), (None, None), (50.0, 4096))}
    k3 = {(m, n, dt): k3_case(m, n, dt, gen, card)
          for m, n, dt in k3_shapes(cfg)}
    for dt in ("float32", "bfloat16"):
        k3[(3, 101, dt)] = k3_case(3, 101, dt, gen, card)
    k5 = {}
    for m in (SLOTS, m_prefill):
        for k, n in qkvo:
            k5[(m, k, n)] = k5_case(m, k, n, gen, card)
    k5[(3, 101, 37)] = k5_case(3, 101, 37, gen, card)
    k6 = {}
    for m in (SLOTS, m_prefill):
        for k, n, bits in mixed_k4_shapes(cfg):
            k6[(m, k, n, bits)] = k6_case(m, k, n, bits, gen, card)
    for bits in (2, 4):
        k6[(3, 101, 37, bits)] = k6_case(3, 101, 37, bits, gen, card)
    k7 = {case[0]: k7_case(case, gen, card) for case in K7_CASES}
    torch.cuda.empty_cache()
    bad = [r["shape"] for r in k1.values() if not r["ok"]] \
        + [f"softcap={r['softcap']}" for r in k2 if not r["ok"]] \
        + [(r["shape"], r["bits"]) for r in k4.values() if not r["ok"]] \
        + [r["kv_dtype"] for r in k2b.values() if not r["ok"]] \
        + [(r["shape"], r["dtype"]) for r in k3.values() if not r["ok"]] \
        + [key for key, r in k2c.items() if not r["ok"]] \
        + [("gemma2 long rows",) + key for key, r in k2_long.items()
           if not r["ok"]] \
        + [("int_matmul",) + key for key, r in k5.items() if not r["ok"]] \
        + [("int_matmul_packed",) + key for key, r in k6.items()
           if not r["ok"]] \
        + [("flash_attention", key) for key, r in k7.items() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    n_eq = sum(r["k1_bit_equal"] for r in k4.values())
    print(f"[kernels] K4 bit-equal to K1 on the unpacked codes in {n_eq} of "
          f"{len(k4)} cases; K3 bit-equal to its plain version in all "
          f"{len(k3)} cases; K2c under a window that does not bind "
          f"bit-equal to K2a/K2b in all "
          f"{sum('bit_equal' in r for r in k2c.values())} cases and at "
          f"gemma2's long rows; K2a/K2b/K2c bit-identical over two calls in "
          f"all {len(k2) + len(k2b) + len(k2c) + len(k2_long)} cases; K5 "
          f"and K6 "
          f"bit-equal to their plain versions in all {len(k5) + len(k6)} "
          f"cases, K6 to K5 on the unpacked codes in all {len(k6)}; K7 "
          f"within its tolerance in all {len(k7)} cases [{card}]")
    return k1, k2, k4, k2b, k3, k2c, k5, k6, k7, k2_long


def _to(tree, dev):
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _cpu_rounding(*, gemm_fp64: bool = False, attention_fp32: bool = False):
    """Context that changes where the CPU's plain versions round, not what
    they compute: ``gemm_fp64`` accumulates the plain GEMMs in fp64 (then
    rounds to fp32); ``attention_fp32`` runs the plain paged attention with
    q in fp32, so it rounds neither K/V nor the probabilities to bf16, and
    the prefill's attention through K7's plain version, whose
    probabilities stay fp32 -- the kernels' own numerics (K2a/K2b and K7
    keep them fp32, as the TPU kernels do)."""
    import contextlib
    from unittest import mock

    import torch

    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.quant_matmul import quant_matmul as wrappers
    from repro_torch.kernels.quant_matmul import ref
    from repro_torch.models import attention

    def fp64_sums(x, codes, scale, bias):
        w = codes.to(torch.float32) * scale[None, :] + bias[None, :]
        return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)

    plain_attention = pa.paged_attention_ref

    def fp32_attention(q, *args, **kwargs):
        return plain_attention(q.to(torch.float32), *args, **kwargs)

    stack = contextlib.ExitStack()
    if gemm_fp64:
        for module in (ref, wrappers):
            stack.enter_context(mock.patch.object(
                module, "quant_matmul_ref", fp64_sums))
    if attention_fp32:
        stack.enter_context(mock.patch.object(pa, "paged_attention_ref",
                                              fp32_attention))
        stack.enter_context(mock.patch.object(
            attention, "_flash_prefill", lambda q, k, v: not (
                q.requires_grad or k.requires_grad or v.requires_grad)))
    return stack


def phase_parity(cfg, card: str, state: str = "uniform",
                 kv_dtype: str = "bf16", windowed: bool = False,
                 act_bits: int | None = None, plen: int | None = None,
                 tag: str | None = None):
    """One prefill_slot and one decode_step of a 2-layer full-width model on
    the CPU (plain versions) and on the card (kernels), same weights: the
    uniform int8 or the mixed 2/4/8-bit state, over a ``kv_dtype`` pool. A
    third run on the CPU with fp64 GEMM sums gives the logits' spread.

    ``windowed`` ([parity-window]): a PARITY_WINDOW_PLEN-token prompt under
    WindowSpec(PARITY_WINDOW, PARITY_WINDOW_SINK_BLOCKS), and the engine's
    out-of-window eviction before the decode step, so the decode runs K2c
    over a table with evicted blocks.

    ``act_bits`` ([parity-int]): integer GEMMs on both sides (K5/K6 on the
    card), on the activation specs ``make_act_specs`` calibrates once on
    the CPU and hands to every run, so both quantize on the same grids.

    ``plen`` and ``tag`` ([parity-gemma2]): a longer prompt, and every
    block it needs, under its own tag.

    For the mixed state, the integer GEMMs and [parity-gemma2] the CPU runs
    attend in fp32 (``_cpu_rounding``): on the ill-conditioned mixed model
    the plain attention's bf16 roundings of K, V and the probabilities
    alone move the decode logits by up to ~40% of their max, while the
    kernels keep them in fp32 by design; with integer GEMMs, which are
    exact on both sides, the attention is the only place the two runs
    round apart; gemma2's sandwich norms rescale every sublayer's output,
    so the phase holds it to the kernels' own numerics too."""
    import numpy as np
    import torch

    from repro_torch.core.sites import QuantContext
    from repro_torch.models import transformer as tfm
    from repro_torch.quant import specs_from_state
    from repro_torch.quant.kv import KVQuantSpec
    from repro_torch.serving import kv_pool
    from repro_torch.quant import ActQuantSpec
    from repro_torch.serving.engine import (export_int_model,
                                            make_act_specs,
                                            make_mixed_quant_state,
                                            make_uniform_quant_state)
    from repro_torch.serving.window import WindowSpec, first_live_block

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    spec = WindowSpec(PARITY_WINDOW, PARITY_WINDOW_SINK_BLOCKS).bind(BLOCK) \
        if windowed else None
    wmask = None if spec is None else spec.mask
    params_cpu = tfm.init_params(cfg2, SEED, device="cpu")
    make_state = make_mixed_quant_state if state == "mixed" \
        else make_uniform_quant_state
    qs_cpu = make_state(cfg2, params_cpu, device="cpu")
    kv_spec = None if kv_dtype == "bf16" else KVQuantSpec(
        bits=int(kv_dtype[-1]), group_size=math.gcd(cfg2.head_dim, 32),
        head_dim=cfg2.head_dim)
    plen = plen or (PARITY_WINDOW_PLEN if windowed else 20)
    # the table row covers the padded prompt that prefill writes
    slots, mb = 2, max(8, _bucket(plen) // BLOCK)
    rng = np.random.default_rng(SEED + 2)
    toks = np.zeros((1, _bucket(plen)), np.int64)
    toks[0, :plen] = rng.integers(0, cfg2.vocab_size, plen)
    act_cpu = {} if act_bits is None else make_act_specs(cfg2, params_cpu,
                                                        act_bits)
    out = {}
    attention_fp32 = state == "mixed" or act_bits is not None \
        or tag is not None
    runs = {"cpu": {"attention_fp32": attention_fp32},
            "cpu_fp64_sums": {"gemm_fp64": True,
                              "attention_fp32": attention_fp32},
            "cuda": {}}
    if attention_fp32:      # reported, not held: the plain bf16 attention
        runs["cpu_bf16_attention"] = {}
    for run, rounding in runs.items():
        dev = "cuda" if run == "cuda" else "cpu"
        params = _to(params_cpu, dev)
        qs = {**qs_cpu, "gates": _to(qs_cpu["gates"], dev),
              "betas": _to(qs_cpu["betas"], dev)}
        act = {k: ActQuantSpec(a.bits, a.beta.to(dev), a.signed)
               for k, a in act_cpu.items()}
        with _cpu_rounding(**rounding):
            qweights, _ = export_int_model(params, cfg2, qs, device=dev)
            qc = QuantContext("serve", cfg=qs["qcfg"], qweights=qweights,
                              specs={**specs_from_state(
                                  qs["gates"], qs["betas"], qs["signed"]),
                                  **act})
            cache = tfm.init_paged_cache(cfg2, slots, slots * mb + 1, BLOCK,
                                         kv_spec=kv_spec, device=dev)
            alloc = kv_pool.init_alloc(slots * mb + 1, slots, mb, device=dev)
            alloc = kv_pool.alloc_range(alloc, 0, 0, -(-plen // BLOCK))
            lp, cache = tfm.prefill_slot(
                qc, params, torch.from_numpy(toks).to(dev), plen, cache, 0,
                cfg2, block_table=alloc["table"], window=wmask)
            # every run decodes the plain CPU run's first token
            first = int(out["cpu"][0][plen - 1].argmax()) if out \
                else int(lp[0, plen - 1, :cfg2.vocab_size].argmax())
            adv = torch.tensor([True, False], device=dev)
            if spec is not None:
                fl = first_live_block(cache["pos"], spec.window,
                                      spec.sink_blocks, BLOCK)
                alloc = kv_pool.evict_out_of_window(alloc, fl, adv,
                                                    spec.sink_blocks)
            alloc = kv_pool.tick_alloc(alloc, cache["pos"], adv, BLOCK)
            ld, cache = tfm.decode_step(
                qc, params, cache, torch.tensor([first, 0], device=dev), cfg2,
                advance=adv, block_table=alloc["table"], window=wmask)
        out[run] = (lp[0, :plen, :cfg2.vocab_size].float().cpu(),
                    ld[0, 0, :cfg2.vocab_size].float().cpu())
        del params, qweights, qc, cache
    label = f"{state} state, {kv_dtype} KV" + (
        ", CPU attention in fp32" if attention_fp32 else "") + (
        f", act_bits {act_bits} ({len(act_cpu)} .in specs)"
        if act_bits is not None else "") + (
        f", window {spec.mask} over a {plen}-token prompt, "
        f"{int((alloc['table'][0] >= 0).sum())} of {-(-(plen + 1) // BLOCK)}"
        f" blocks left after eviction" if spec is not None else "") + (
        f", layers {cfg2.block_pattern}, local window {cfg2.window} over a "
        f"{plen}-token prompt" if "local" in cfg2.block_pattern else "")
    tag = tag or ("[parity-window]" if windowed else "[parity-int]"
                  if act_bits is not None else "[parity]")
    for name, i in (("prefill", 0), ("decode", 1)):
        ref, got = out["cpu"][i], out["cuda"][i]
        check(bool(torch.isfinite(got).all()), f"{name} logits not finite")
        diff = float((got - ref).abs().max())
        spread = float((out["cpu_fp64_sums"][i] - ref).abs().max())
        tol = max(PARITY_RTOL * float(ref.abs().max()),
                  PARITY_SPREAD_FACTOR * spread)
        last_ref, last_got = ref.reshape(-1, ref.shape[-1])[-1], \
            got.reshape(-1, got.shape[-1])[-1]
        top_ref, top_got = int(last_ref.argmax()), int(last_got.argmax())
        # a different top-1 is a fault only if the CPU's own logit at the
        # card's pick is clearly below its max
        top_ok = top_ref == top_got \
            or float(last_ref.max() - last_ref[top_got]) <= tol
        rows = ref.reshape(-1, ref.shape[-1])
        agree = float((rows.argmax(-1) == got.reshape(
            -1, got.shape[-1]).argmax(-1)).float().mean())
        print(f"{tag} 2-layer full-width {cfg.name}, {label}, {name}: "
              f"max |logit "
              f"diff| {diff:.4e}, max |logit| {float(ref.abs().max()):.4e}, "
              f"spread under fp64 GEMM sums {spread:.4e}; tol {tol:.4e} = "
              f"max({PARITY_RTOL:g} x max|logit|, {PARITY_SPREAD_FACTOR:g} x "
              f"spread); top-1 agreement {agree:.3f} over {rows.shape[0]} "
              f"row(s), last row cpu {top_ref} vs card {top_got} [{card}]")
        if attention_fp32:
            bf16 = out["cpu_bf16_attention"][i]
            print(f"{tag}   against the CPU with its plain bf16 attention "
                  f"instead: max |logit diff| "
                  f"{float((got - bf16).abs().max()):.4e}, last row top-1 "
                  f"{int(bf16.reshape(-1, bf16.shape[-1])[-1].argmax())}")
        check(diff <= tol, f"{label}: {name} logits differ by {diff} > {tol}")
        check(top_ok, f"{label}: {name} top-1 {top_got} vs plain {top_ref}")


def _counters() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels.fake_quant.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention, paged_attention_quant, paged_attention_quant_window,
        paged_attention_window)
    from repro_torch.kernels.quant_matmul.quant_matmul import (
        int_matmul, int_matmul_packed, quant_matmul, quant_matmul_packed)

    return {"quant_matmul": quant_matmul,
            "quant_matmul_packed": quant_matmul_packed,
            "int_matmul": int_matmul,
            "int_matmul_packed": int_matmul_packed,
            "paged_attention": paged_attention,
            "paged_attention_quant": paged_attention_quant,
            "paged_attention_window": paged_attention_window,
            "paged_attention_quant_window": paged_attention_quant_window,
            "flash_attention": flash_attention,
            "fake_quant": fake_quant}


def phase_serve(cfg, prompts, card: str, *, mixed: bool = False,
                params=None, act_bits: int | None = None):
    """The 22-layer serve: the uniform int8 state over a bf16 pool (slice
    1), or the mixed 2/4/8-bit state over a MIXED_KV pool (slice 2); with
    ``act_bits`` ([serve-int], [serve-int-mixed], slice 5) through the
    integer GEMMs, and its ``quant_report`` checked: every GEMM input served
    integer at ``act_bits``, the uniform state's BOPs the uniform-int8 ones,
    the mixed state's below. Every launch counter is set to 0 just before
    ``generate`` and read just after; they must equal what the path
    implies."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import (SamplingParams, ServingEngine,
                                            make_mixed_quant_state,
                                            make_uniform_quant_state)

    t0 = time.perf_counter()
    if params is None:
        params = tfm.init_params(cfg, SEED)
    make_state = make_mixed_quant_state if mixed else make_uniform_quant_state
    kv_dtype = MIXED_KV if mixed else "bf16"
    eng = ServingEngine(cfg, params, slots=SLOTS, max_seq=MAX_SEQ,
                        quant_state=make_state(cfg, params),
                        block_size=BLOCK, kv_dtype=kv_dtype,
                        act_bits=act_bits)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tag = "mixed 2/4/8-bit" if mixed else "uniform int8"
    phase = "[serve]"
    if act_bits is not None:
        phase = "[serve-int-mixed]" if mixed else "[serve-int]"
        tag += f", act_bits {act_bits}"
        rep = eng.quant_report()
        acts, bops = rep["acts"], rep["bops"]
        print(f"{phase} quant_report acts: {acts['covered']} of "
              f"{acts['total']} GEMM inputs served integer, fallback "
              f"{acts['fallback_sites']}, widths "
              f"{sorted(set(acts['bits'].values()))}; bops model "
              f"{bops['model']:.6e}, uniform int8 {bops['uniform_int8']:.6e},"
              f" rbop {bops['rbop']:.6f}; export bytes "
              f"{rep['totals']['bytes_device']} [{card}]")
        check(acts["covered"] == acts["total"] == 7 + 1
              and acts["fallback_sites"] == []
              and set(acts["bits"].values()) == {act_bits},
              f"quant_report acts {acts}")
        if mixed:
            check(bops["model"] < bops["uniform_int8"],
                  f"mixed BOPs {bops['model']} not below uniform int8 "
                  f"{bops['uniform_int8']}")
        else:
            check(abs(bops["model"] - bops["uniform_int8"])
                  <= 1e-6 * bops["uniform_int8"],
                  f"uniform BOPs {bops['model']} != uniform int8 "
                  f"{bops['uniform_int8']}")
    export = {"codes": sum(q.codes_bytes() for q in eng.qweights.values()),
              "aux": sum(q.aux_bytes() for q in eng.qweights.values())}
    pool_bytes = sum(t.numel() * t.element_size()
                     for entry in eng.cache["layers"] for t in entry.values())
    kv_per_token = pool_bytes / (eng.num_blocks * BLOCK)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = eng.generate(prompts, SamplingParams(max_new=MAX_NEW))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    st = eng.stats
    layers = cfg.n_layers
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    want = dict.fromkeys(counters, 0)
    want["flash_attention"] = layers * st["prefill_forwards"]
    # integer GEMMs: K5 takes K1's sites, K6 K4's
    k8, kp = ("int_matmul", "int_matmul_packed") if act_bits is not None \
        else ("quant_matmul", "quant_matmul_packed")
    if mixed:   # 8-bit attn_o, mlp_down: K1/K5; the five packed: K4/K6
        want.update({k8: 2 * layers * forwards,
                     kp: (5 * layers + 1) * forwards,
                     "paged_attention_quant": layers * st["decode_ticks"]})
    else:
        want.update({k8: (7 * layers + 1) * forwards,
                     "paged_attention": layers * st["decode_ticks"]})
    for r in results:
        check(r.finish_reason == "length" and len(r.tokens) == MAX_NEW,
              f"request {r.rid}: {r.finish_reason}, {len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: token outside the vocabulary")
    check(st["tick_syncs"] == st["decode_ticks"],
          f"{st['tick_syncs']} tick syncs for {st['decode_ticks']} ticks")
    path = [name for name, n in want.items() if n]
    check(launches == want and all(launches[name] for name in path),
          f"launch counters {launches}, the path implies {want}")
    ttft = [r.first_token_s - r.submit_s for r in eng.finished]
    decode_tokens = st["generated_tokens"] - len(results)
    print(f"{phase} {tag}, {kv_dtype} KV: tinyllama-1.1b {layers} layers, "
          f"{SLOTS} slots, {len(prompts)} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"max_new {MAX_NEW}: setup {setup_s:.2f} s; export on the card: "
          f"codes {export['codes']} B + aux {export['aux']} B = "
          f"{(export['codes'] + export['aux']) / 1e9:.4f} GB; KV pool "
          f"{kv_per_token:.0f} B per cached token "
          f"(kv_report {eng.kv_report()['bytes_per_cached_token']} B)")
    print(f"{phase} stats {json.dumps(st)}")
    print(f"{phase} launches {launches} == expected {want}; "
          f"tick_syncs == decode_ticks == {st['decode_ticks']}")
    print(f"{phase} {tag}: TTFT mean {sum(ttft) / len(ttft):.4f} s max "
          f"{max(ttft):.4f} s; decode {decode_tokens / st['decode_time_s']:.1f}"
          f" tok/s ({st['decode_time_s'] / st['decode_ticks'] * 1e3:.3f} ms "
          f"per tick); prefill {st['prefill_time_s']:.3f} s; wall "
          f"{wall:.3f} s [{card}]")
    return eng, launches, export


def phase_serve_window(cfg, card: str, params):
    """The 22-layer long-context serve (slice 4): the uniform int8 state
    over a bf16 pool under WindowSpec(WIN_WINDOW, WIN_SINK_BLOCKS), 12
    greedy requests whose prompts are all longer than the window, wave
    admission, driven tick by tick through ``step`` (what ``generate``
    does). Every launch counter is set to 0 just before the requests and
    read just after; after every tick the K2c launches must have grown by
    exactly n_layers per decode tick and no live slot may hold more than
    max_live_blocks table entries."""
    import torch

    from repro_torch.serving.engine import (Request, ServingEngine,
                                            make_uniform_quant_state)
    from repro_torch.serving.window import WindowSpec, max_live_blocks

    t0 = time.perf_counter()
    spec = WindowSpec(WIN_WINDOW, sink_blocks=WIN_SINK_BLOCKS)
    eng = ServingEngine(cfg, params, slots=SLOTS, max_seq=WIN_MAX_SEQ,
                        quant_state=make_uniform_quant_state(cfg, params),
                        block_size=BLOCK, kv_dtype="bf16",
                        attention_window=spec)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = _prompts(cfg.vocab_size, WIN_PROMPT_LO, WIN_PROMPT_HI)
    check(min(map(len, prompts)) > WIN_WINDOW, "a prompt fits the window")
    cap = max_live_blocks(WIN_WINDOW, WIN_SINK_BLOCKS, BLOCK)
    pool_bytes = sum(t.numel() * t.element_size()
                     for entry in eng.cache["layers"] for t in entry.values())
    layers = cfg.n_layers

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    k2c = counters["paged_attention_window"]
    reqs = [eng.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    held, bad_ticks, ticks = 0, [], 0
    while not all(r.done for r in reqs):
        before = k2c.launches
        eng.step()
        st = eng.stats
        new_ticks, ticks = st["decode_ticks"] - ticks, st["decode_ticks"]
        if k2c.launches - before != layers * new_ticks:
            bad_ticks.append((ticks, k2c.launches - before))
        live = [s for s, r in enumerate(eng.slot_req) if r is not None]
        if live:        # a check's read of the table, outside the tick
            rows = (eng.alloc["table"][live] >= 0).sum(dim=1)
            held = max(held, int(rows.max()))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    st = eng.stats
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    want = dict.fromkeys(counters, 0)
    want.update({"quant_matmul": (7 * layers + 1) * forwards,
                 "flash_attention": layers * st["prefill_forwards"],
                 "paged_attention_window": layers * st["decode_ticks"]})
    for r in reqs:
        check(r.finish_reason == "length" and len(r.output) == MAX_NEW,
              f"request {r.rid}: {r.finish_reason}, {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.rid}: token outside the vocabulary")
    check(st["tick_syncs"] == st["decode_ticks"],
          f"{st['tick_syncs']} tick syncs for {st['decode_ticks']} ticks")
    check(launches == want, f"launch counters {launches}, the path implies "
          f"{want}")
    check(not bad_ticks, f"ticks whose K2c launches are not {layers} per "
          f"decode tick: {bad_ticks[:5]}")
    check(held <= cap, f"a live slot held {held} blocks > {cap}")
    n_free = int(eng.alloc["n_free"])
    check(n_free == eng.num_blocks - 1
          and bool((eng.alloc["ref"][1:] == 0).all()),
          f"{eng.num_blocks - 1 - n_free} blocks leaked")
    ttft = [r.first_token_s - r.submit_s for r in reqs]
    decode_tokens = st["generated_tokens"] - len(reqs)
    print(f"[serve-window] uniform int8, bf16 KV, window {spec.window} + "
          f"{spec.sink_blocks} sink blocks: tinyllama-1.1b {layers} layers, "
          f"{SLOTS} slots, max_seq {WIN_MAX_SEQ}, {len(prompts)} requests, "
          f"prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens, max_new {MAX_NEW}: setup {setup_s:.2f} s; KV pool "
          f"{eng.num_blocks} blocks, {pool_bytes} B; most table entries of "
          f"a live slot after a tick {held} (max_live_blocks {cap}; the "
          f"table is {eng.max_blocks} wide) [{card}]")
    print(f"[serve-window] stats {json.dumps(st)}; kv_report window "
          f"{json.dumps(eng.kv_report()['window'])}")
    print(f"[serve-window] launches {launches} == expected {want}; K2c "
          f"{layers} per tick in every tick; tick_syncs == decode_ticks == "
          f"{st['decode_ticks']}; 0 blocks in use after the last retirement")
    tok_s = decode_tokens / st["decode_time_s"]
    print(f"[serve-window] TTFT mean {sum(ttft) / len(ttft):.4f} s max "
          f"{max(ttft):.4f} s; decode {tok_s:.1f} tok/s "
          f"({st['decode_time_s'] / st['decode_ticks'] * 1e3:.3f} ms "
          f"per tick); prefill {st['prefill_time_s']:.3f} s; wall "
          f"{wall:.3f} s [{card}]")
    return eng, prompts, launches


def _gemma2_prompts(vocab: int):
    """[serve-gemma2]'s prompts from default_rng(SEED): G2_SHORT then
    G2_LONG, so the second wave holds both long ones."""
    rng = __import__("numpy").random.default_rng(SEED)
    lens = [int(n) for count, lo, hi in (G2_SHORT, G2_LONG)
            for n in rng.integers(lo, hi + 1, count)]
    return [rng.integers(0, vocab, (n,)) for n in lens]


def phase_serve_gemma2(card: str):
    """[serve-gemma2] (slice 6): gemma2-2b at full width and depth (26
    layers alternating local and global, d 2304, 8 heads, KV 4, head_dim
    256, ff 9216, vocab 256000, tied embeddings; random weights from seed
    0), the uniform int8 state over a bf16 pool of 16-token blocks, 4 slots
    of max_seq 4608, 8 greedy requests (6 of 22-352 tokens, 2 of
    4200-4500), MAX_NEW new tokens each, wave admission, driven tick by
    tick through ``step`` (what ``generate`` does). Every launch counter is
    set to 0 just before the requests and read just after: K1 7 x 26 + 1 =
    183 per forward, K7 26 per prefill and none in a decode tick, K2a 13
    (global layers) and K2c 13 (local layers, window 4096) a tick, nothing
    else. Returns (engine, prompts, launches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            make_uniform_quant_state)

    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, SEED)
    eng = ServingEngine(cfg, params, slots=G2_SLOTS, max_seq=G2_MAX_SEQ,
                        quant_state=make_uniform_quant_state(cfg, params),
                        block_size=G2_BLOCK, kv_dtype="bf16")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = _gemma2_prompts(cfg.vocab_size)
    check(max(map(len, prompts)) > cfg.window, "no prompt passes the window")
    pool_bytes = sum(t.numel() * t.element_size()
                     for entry in eng.cache["layers"] for t in entry.values())
    kv_per_token = pool_bytes / (eng.num_blocks * G2_BLOCK)
    export = sum(q.codes_bytes() + q.aux_bytes()
                 for q in eng.qweights.values())
    layers, half = cfg.n_layers, cfg.n_layers // 2

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    k7 = counters["flash_attention"]
    reqs = [eng.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bad_steps = []
    while not all(r.done for r in reqs):
        before = (k7.launches, eng.stats["prefill_forwards"])
        eng.step()
        prefills = eng.stats["prefill_forwards"] - before[1]
        if k7.launches - before[0] != layers * prefills:
            bad_steps.append((eng.stats["decode_ticks"], prefills,
                              k7.launches - before[0]))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    st = eng.stats
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    want = dict.fromkeys(counters, 0)
    want.update({"quant_matmul": (7 * layers + 1) * forwards,
                 "flash_attention": layers * st["prefill_forwards"],
                 "paged_attention": half * st["decode_ticks"],
                 "paged_attention_window": half * st["decode_ticks"]})
    for r in reqs:
        check(r.finish_reason == "length" and len(r.output) == MAX_NEW,
              f"request {r.rid}: {r.finish_reason}, {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.rid}: token outside the vocabulary")
    check(st["tick_syncs"] == st["decode_ticks"],
          f"{st['tick_syncs']} tick syncs for {st['decode_ticks']} ticks")
    check(launches == want, f"launch counters {launches}, the path implies "
          f"{want}")
    check(not bad_steps, f"steps whose K7 launches are not {layers} per "
          f"prefill (tick, prefills, launches): {bad_steps[:5]}")
    check(kv_per_token == 2 * layers * cfg.n_kv_heads * cfg.head_dim * 2,
          f"{kv_per_token} B per cached token")
    ttft = [r.first_token_s - r.submit_s for r in reqs]
    decode_tokens = st["generated_tokens"] - len(reqs)
    print(f"[serve-gemma2] uniform int8, bf16 KV: gemma2-2b {layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), {G2_SLOTS} slots, "
          f"max_seq {G2_MAX_SEQ}, {len(prompts)} requests, prompts "
          f"{sorted(map(len, prompts))} tokens, max_new {MAX_NEW}: setup "
          f"{setup_s:.2f} s; export {export / 1e9:.4f} GB; KV pool "
          f"{eng.num_blocks} blocks of {G2_BLOCK}, {pool_bytes / 1e9:.4f} GB,"
          f" {kv_per_token:.0f} B per cached token; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    print(f"[serve-gemma2] stats {json.dumps(st)}")
    print(f"[serve-gemma2] launches {launches} == expected {want}; K7 "
          f"{layers} per prefill and none in a decode tick; tick_syncs == "
          f"decode_ticks == {st['decode_ticks']}")
    print(f"[serve-gemma2] TTFT mean {sum(ttft) / len(ttft):.4f} s max "
          f"{max(ttft):.4f} s; decode "
          f"{decode_tokens / st['decode_time_s']:.1f} tok/s "
          f"({st['decode_time_s'] / st['decode_ticks'] * 1e3:.3f} ms per "
          f"tick); prefill {st['prefill_time_s']:.3f} s for "
          f"{st['prefill_forwards']} prompts; wall {wall:.3f} s [{card}]")
    return eng, prompts, launches


def _synchronizing_ops(fn) -> int:
    """Synchronizing CUDA operations that ``fn()`` runs, as PyTorch's sync
    debug mode reports them (one warning each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def _one_sync(syncs: int, cell: str):
    check(syncs == 1, f"{cell}: a decode tick ran {syncs} synchronizing "
          f"CUDA operations, not the one host transfer")


def phase_profile(eng, prompts, card: str, ticks: int = 5,
                  slots: int = SLOTS):
    """Where a decode tick's time goes: ``ticks`` full-batch ticks timed on
    the host without the profiler, one tick under the sync debug mode
    (which counts its synchronizing operations), then ``ticks`` more under
    ``torch.profiler`` for the device time by kernel. The idle share is
    1 - device busy / unprofiled wall. Returns the synchronizing operations
    of that one tick."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    for i, p in enumerate(prompts[:slots]):
        eng.submit(Request(rid=1_000_000 + i, prompt=p,
                           max_new=2 * ticks + 3))
    eng.step()                       # the admission wave and a first tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()                   # each step ends in its one host sync
    wall_ms = (time.perf_counter() - t0) / ticks * 1e3
    syncs = _synchronizing_ops(eng.step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
    while any(r is not None for r in eng.slot_req):
        eng.step()
    kinds = tuple(_counters())
    by_kind = dict.fromkeys(kinds + ("other",), 0.0)
    others = {}
    aten_calls = 0
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            aten_calls += e.count       # host dispatches, nested ones too
        # device time lives on the kernel (CUDA-typed) events; CPU ops
        # carry the same time again as their children's
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us <= 0:
            continue
        # no kernel name is a substring of another's "<name>_kernel"
        kind = next((k for k in kinds if f"{k}_kernel" in e.key), "other")
        by_kind[kind] += us / 1e3 / ticks
        if kind == "other":
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + us / 1e3 / ticks
    busy = sum(by_kind.values())
    # every pass of K2 (split and combine) is named after its wrapper
    check(not any("paged_attention" in k for k in others),
          f"paged-attention kernels charged to 'other': "
          f"{[k for k in others if 'paged_attention' in k]}")
    tag = f"{eng.kv_dtype} KV, " + ("mixed" if any(
        q.packed for q in eng.qweights.values()) else "uniform int8") + (
        f", window {eng.window_spec.mask}" if eng.window_spec else "") + (
        f", act_bits {eng.act_bits}" if eng.act_bits else "")
    tag = f"{eng.cfg.name}, " + tag
    print(f"[profile] {tag}: {aten_calls / ticks:.0f} ATen calls per decode "
          f"tick (nested included) for {slots} slots; {syncs} synchronizing "
          f"CUDA operation(s) in one decode tick (sync debug mode)")
    if busy == 0:
        print(f"[profile] {tag}: decode tick {wall_ms:.3f} ms on the host "
              f"clock; device time not measured (the profiler saw no "
              f"kernels) [{card}]")
        return syncs
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {tag}: decode tick ({slots} slots): host wall "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; per tick " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in by_kind.items()) + f" [{card}]")
    print(f"[profile] {tag}: top other kernels per tick: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in top))
    return syncs


def _train_recipe(cfg, batch: int, seq: int):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as steps_lib

    return steps_lib.make_recipe(
        cfg, ShapeConfig("train", seq, batch, "train"), check_every=1,
        budget_rbop=TRAIN_BUDGET_RBOP)


def _leaf_names(tree, prefix=""):
    """Leaf paths of a tree of dicts/lists/tuples, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _act_grad_mass():
    """(masses, context): inside the context every train-mode activation
    site records, by layer, the sum of |dL/da| of its backward: the L1
    mass of the terms its probe's and its beta's gradients sum."""
    from unittest import mock

    from repro_torch.core.sites import QuantContext

    mass = {}
    act = QuantContext.act

    def hooked(self, name, a):
        out = act(self, name, a)
        if a.requires_grad:
            key = self._full(name) + ".a"
            a.register_hook(lambda g: mass.setdefault(key, []).append(
                g.float().abs().sum().cpu()))
        return out

    return mass, mock.patch.object(QuantContext, "act", hooked)


def _train_parity_run(recipe, state, batch):
    """One CGMQ step's loss, gradients, statistics and new gates."""
    import torch

    from repro_torch.core.controller import controller_update
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adam import tree_leaves

    t0 = time.perf_counter()
    amass, hooks = _act_grad_mass()
    with hooks:
        loss, (gp, gb, gprobe), astats, wstats = steps_lib.loss_and_grads(
            recipe, state, batch)
    new = controller_update(state.cgmq, recipe.ccfg, recipe.sites, gprobe,
                            wstats, astats, recipe.budget_bop)
    # the weight sites' L1 masses: |dL/dW| summed per layer
    mass = {k: w.abs().reshape(w.shape[0] if w.ndim == 3 else 1, -1).sum(
        dim=1).reshape(gprobe[k].shape).cpu()
        for k, w in tfm.site_weights(gp, recipe.cfg).items()}
    mass.update({k: torch.stack(v[::-1]).reshape(gprobe[k].shape)
                 for k, v in amass.items()})
    cpu = {k: v.cpu() for k, v in gb.items()}
    return {"loss": float(loss),
            "param_norms": [float(g.norm()) for g in tree_leaves(gp)],
            "sums": {("betas", k): v for k, v in cpu.items()}
            | {("probes", k): v.cpu() for k, v in gprobe.items()},
            "mass": mass,
            "stats": (gprobe, wstats, astats),
            "gates": {k: v.cpu() for k, v in new.gates.items()},
            "sat": bool(new.sat), "bop": float(new.bop),
            "s": time.perf_counter() - t0}


def phase_train_parity(cfg, card: str):
    """One CGMQ step of a 2-layer full-width model on the CPU (plain
    versions) and on the card (K3), from the same state and batch: weight
    gates cycled over 2/4/8/16 bits with ranges from the weights (a
    placeholder range of 1.0 puts every 2-bit weight at +-1/3 and the
    model's logits at ~60, where a single flipped code moves everything),
    activation gates over 8/16 bits (at 2 and 4 bits an activation grid
    turns every bf16 rounding the two devices place differently into a
    whole grid step; see tests/test_torch_train.py). Held: the loss; each
    parameter gradient's norm; each beta and probe gradient, a sum over
    its site's tensor, against that tensor's L1 gradient mass; the new
    gates from the CPU's statistics, and from the card's own."""
    import torch

    from repro_torch.bridge import train_state_from_numpy, tree_to_numpy
    from repro_torch.core.controller import controller_update, init_state
    from repro_torch.core.gates import gate_to_bits
    from repro_torch.core.sites import (init_ranges_from_weights,
                                        split_learnable_ranges)
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm

    b, sq = PARITY_TRAIN
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    recipe = _train_recipe(cfg2, b, sq)
    state = steps_lib.init_train_state(recipe, SEED, device="cpu")
    weights = tfm.site_weights(state.params, cfg2)
    betas, _ = split_learnable_ranges(init_ranges_from_weights(
        recipe.sites, recipe.qcfg, lambda n: weights[n + ".w"], "cpu"))
    state.betas = {k: betas[k] if k.endswith(".w") else v
                   for k, v in state.betas.items()}
    levels = {"w": (0.8, 1.5, 2.5, 3.5), "a": (2.5, 3.5)}
    state.cgmq = init_state(
        {k: torch.full_like(g, levels[k[-1]][i % len(levels[k[-1]])])
         for i, (k, g) in enumerate(sorted(state.cgmq.gates.items()))},
        recipe.sites)
    chunk = torch.from_numpy(lm_tokens(b, sq, cfg.vocab_size, seed=SEED + 3,
                                       noise=0.05))
    cpu = _train_parity_run(recipe, state, {"tokens": chunk[:, :-1],
                                            "targets": chunk[:, 1:]})
    dev_state = train_state_from_numpy(tree_to_numpy(state), device="cuda")
    card_ = _train_parity_run(recipe, dev_state, {
        "tokens": chunk[:, :-1].cuda(), "targets": chunk[:, 1:].cuda()})
    # the card's controller on the CPU's statistics: elementwise fp32
    to_card = (lambda t: {k: v.cuda() for k, v in t.items()})
    gprobe, wstats, astats = cpu["stats"]
    same = controller_update(
        dev_state.cgmq, recipe.ccfg, recipe.sites, to_card(gprobe),
        to_card(wstats), {k: to_card(v) for k, v in astats.items()},
        recipe.budget_bop)
    same_diff = max(float((same.gates[k].cpu() - v).abs().max())
                    for k, v in cpu["gates"].items())

    loss_tol = TRAIN_LOSS_RTOL * abs(cpu["loss"])
    loss_diff = abs(card_["loss"] - cpu["loss"])
    rel = [abs(g - c) / c if c else (0.0 if g == c else math.inf)
           for c, g in zip(cpu["param_norms"], card_["param_norms"])]
    names = _leaf_names(state.params)
    worst = max(range(len(rel)), key=rel.__getitem__)
    sums = {}
    for (kind, k), v in cpu["sums"].items():
        d = (card_["sums"][(kind, k)] - v).abs()
        m = cpu["mass"].get(k)
        # a site the forward never reaches: zero on both devices
        sums[(kind, k)] = float((d / m).max()) if m is not None \
            else (math.inf if bool(d.any()) else 0.0)
    worst_sum = max(sums, key=sums.get)
    step_max = recipe.ccfg.gate_lr * recipe.ccfg.dir_clip
    own_diff = max(float((card_["gates"][k] - v).abs().max())
                   for k, v in cpu["gates"].items())
    bits_equal = all(torch.equal(gate_to_bits(card_["gates"][k]),
                                 gate_to_bits(v))
                     for k, v in cpu["gates"].items())
    print(f"[train-parity] 2-layer full-width, batch {b} x {sq}, weight "
          f"gates 2/4/8/16 bits (ranges from the weights), activation gates "
          f"8/16 bits: CPU {cpu['s']:.1f} s, card {card_['s']:.1f} s "
          f"[{card}]")
    print(f"[train-parity] loss cpu {cpu['loss']:.6f} card "
          f"{card_['loss']:.6f}: |diff| {loss_diff:.3e} (tol {loss_tol:.3e} "
          f"= {TRAIN_LOSS_RTOL:g} x loss)")
    print(f"[train-parity] parameter gradient norms, {len(rel)} leaves: max "
          f"relative diff {rel[worst]:.3e} at {names[worst]} (tol "
          f"{TRAIN_GRAD_RTOL:g}); median {sorted(rel)[len(rel) // 2]:.3e}")
    print(f"[train-parity] beta and probe gradients, {len(sums)} sums: max "
          f"|diff| / L1 mass {sums[worst_sum]:.3e} at {'/'.join(worst_sum)} "
          f"(tol {TRAIN_GRAD_RTOL:g})")
    print(f"[train-parity] new gates from the CPU's statistics: max |diff| "
          f"{same_diff:.3e} (tol {TRAIN_CTRL_ATOL:g}); from the card's own: "
          f"max |diff| {own_diff:.3e} (tol {step_max:g} = gate_lr x "
          f"dir_clip), bit-widths {'equal' if bits_equal else 'DIFFER'}; "
          f"sat {cpu['sat']}/{card_['sat']}, bop {cpu['bop']:.6e}/"
          f"{card_['bop']:.6e}")
    check(math.isfinite(card_["loss"]) and loss_diff <= loss_tol,
          f"train loss {card_['loss']} vs plain {cpu['loss']}")
    check(rel[worst] <= TRAIN_GRAD_RTOL,
          f"gradient norm of {names[worst]} off by {rel[worst]}")
    check(sums[worst_sum] <= TRAIN_GRAD_RTOL,
          f"{worst_sum} gradient off by {sums[worst_sum]} of its mass")
    check(same_diff <= TRAIN_CTRL_ATOL and own_diff <= step_max
          and bits_equal, "new gates differ")
    check(cpu["sat"] == card_["sat"] and cpu["bop"] == card_["bop"],
          "sat or bop differ")


def phase_train(cfg, card: str):
    """The 22-layer CGMQ training path: 2 fp32 warmup steps, activation
    calibration on 3 batches, then 12 CGMQ steps from 16-bit gates under
    budget_rbop 0.07. Every launch counter is set to 0 just before the
    path and read just after: K3 launches exactly 221 per CGMQ forward and
    none in warmup and calibration, and no other kernel runs. Returns the
    trained state, its recipe and the path's launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.calibration import (apply_act_calibration,
                                              calibrate_activations)
    from repro_torch.core.controller import (export_bits, guarantee_satisfied,
                                             init_state)
    from repro_torch.core.sites import (init_ranges_from_weights,
                                        split_learnable_ranges)
    from repro_torch.data.synthetic import lm_tokens
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm

    dev = "cuda"
    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    recipe = _train_recipe(cfg, TRAIN_BATCH, TRAIN_SEQ)
    state = steps_lib.init_train_state(recipe, SEED)
    data = lm_tokens(2048, TRAIN_SEQ, cfg.vocab_size, seed=0, noise=0.05)

    def batch(i):
        idx = np.random.default_rng(i).integers(0, data.shape[0],
                                                TRAIN_BATCH)
        chunk = torch.from_numpy(data[idx]).to(dev)
        return {"tokens": chunk[:, :-1], "targets": chunk[:, 1:]}

    per_forward = sum(k3_shapes(cfg).values())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    k3, k7 = counters["fake_quant"], counters["flash_attention"]
    fp_step = steps_lib.make_train_step(
        dataclasses.replace(recipe, quant_enabled=False))
    warm = []
    for i in range(WARMUP_STEPS):
        state, m = fp_step(state, batch(i))
        warm.append(float(m["loss"]))
    warm_launches = k3.launches
    warm_k7 = k7.launches
    t0 = time.perf_counter()
    calib = calibrate_activations(
        lambda qc, b: tfm.forward_train(qc, state.params, b["tokens"], cfg),
        (batch(WARMUP_STEPS + i) for i in range(CALIB_BATCHES)),
        recipe.qcfg)
    calib_s = time.perf_counter() - t0
    calib_launches = k3.launches - warm_launches
    calib_k7 = k7.launches - warm_k7
    state.betas, _ = split_learnable_ranges(apply_act_calibration(
        init_ranges_from_weights(recipe.sites, recipe.qcfg, lambda n: None,
                                 dev), calib))
    # the warmup moved every gate too (no probe is reached with
    # quantization off); the CGMQ stage starts them all at 16 bits
    state.cgmq = init_state({k: torch.full_like(g, TRAIN_GATE0)
                             for k, g in state.cgmq.gates.items()},
                            recipe.sites)
    step = steps_lib.make_train_step(recipe)
    rows = []
    prof = None
    for i in range(CGMQ_STEPS):
        b = batch(WARMUP_STEPS + CALIB_BATCHES + i)
        before, before_k7 = k3.launches, k7.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == CGMQ_STEPS - 1:
            prof, (state, m) = _profiled(lambda: step(state, b))
        else:
            state, m = step(state, b)
        loss = float(m["loss"])         # the step's one host sync
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"loss": loss, "rbop": float(m["rbop"]),
                     "sat": bool(m["sat"]), "ms": ms,
                     "launches": k3.launches - before,
                     "k7": k7.launches - before_k7})
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    sat_at = next((i + 1 for i, r in enumerate(rows) if r["sat"]), None)
    print(f"[train] tinyllama-1.1b {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: setup {setup_s:.2f} s; warmup losses "
          f"{[round(v, 4) for v in warm]}; calibration {calib_s:.2f} s, "
          f"{len(calib)} activation ranges [{card}]")
    for i, r in enumerate(rows):
        print(f"[train] CGMQ step {i + 1}: loss {r['loss']:.4f} rbop "
              f"{r['rbop'] * 100:.3f}% sat={r['sat']} K3 launches "
              f"{r['launches']} {r['ms']:.1f} ms"
              + (" (profiled)" if i == CGMQ_STEPS - 1 else ""))
    steady = sorted(r["ms"] for r in rows[1:-1])
    step_ms = steady[len(steady) // 2]
    print(f"[train] ms per CGMQ step (median of steps 2-{CGMQ_STEPS - 1}, "
          f"host clock ending in the step's sync) {step_ms:.1f}; peak "
          f"device memory {peak / 2**30:.2f} GiB; sat first holds after "
          f"step {sat_at} [{card}]")
    bits = export_bits(state.cgmq)
    for k in sorted(bits):
        vals, counts = np.unique(bits[k], return_counts=True)
        print(f"[train]   {k}: " + ", ".join(
            f"{c} x {v}-bit" for v, c in zip(vals, counts)))
    want = {name: 0 for name in counters}
    want["fake_quant"] = per_forward * CGMQ_STEPS
    # calibration runs under no_grad, so its attention is K7's; the
    # training forwards keep the einsums (K7 has no backward)
    want["flash_attention"] = cfg.n_layers * CALIB_BATCHES
    print(f"[train] launches {launches} == expected {want}; K3 warmup "
          f"{warm_launches}, calibration {calib_launches}; K7 warmup "
          f"{warm_k7}, calibration {calib_k7}, CGMQ steps "
          f"{sum(r['k7'] for r in rows)}")
    check(all(math.isfinite(v) for v in warm)
          and all(math.isfinite(r["loss"]) for r in rows), "a loss is "
          "not finite")
    check(warm_launches == 0 and calib_launches == 0,
          "K3 launched during warmup or calibration")
    check(all(r["launches"] == per_forward for r in rows),
          f"K3 launches per CGMQ step {[r['launches'] for r in rows]}, "
          f"expected {per_forward}")
    check(warm_k7 == 0 and all(r["k7"] == 0 for r in rows),
          "K7 launched in a training forward")
    check(launches == want, f"launch counters {launches}, expected {want}")
    check(bool(state.cgmq.best_valid) and sat_at is not None,
          "the controller never certified the budget")
    check(guarantee_satisfied(state.cgmq, recipe.sites, recipe.budget_bop),
          "the exported gates break the BOP budget")
    _train_profile(prof, step_ms, card)
    return state, recipe, launches


def _profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return prof, out


def _train_profile(prof, step_ms: float, card: str):
    """Device time of one CGMQ step by kind: K3, the fake-quant backward
    (the kernels of the ATen ops under its record_function range), GEMMs,
    the rest; the idle share is 1 - busy / the unprofiled step's wall."""
    from torch.autograd import DeviceType

    busy = k3_us = gemm_us = 0.0
    others = {}
    for e in prof.key_averages():
        # kernels only: a record_function range also leaves a device-side
        # annotation spanning its kernels, which is not device work
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0 \
                or e.key == "fake_quant_backward":
            continue
        us = e.self_device_time_total
        busy += us
        if "fake_quant_kernel" in e.key:
            k3_us += us
        elif "gemm" in e.key.lower():
            gemm_us += us
        else:
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + us

    def aten_under(ev):
        return sum(c.name.startswith("aten::") + aten_under(c)
                   for c in ev.cpu_children)

    bwd = [ev for ev in prof.events() if ev.name == "fake_quant_backward"
           and ev.device_type == DeviceType.CPU]
    fq_bwd_us = sum(ev.device_time_total for ev in bwd)
    fq_aten = sum(aten_under(ev) for ev in bwd)
    if busy == 0:
        print(f"[train-profile] device time not measured (the profiler saw "
              f"no kernels) [{card}]")
        return
    busy_ms = busy / 1e3
    print(f"[train-profile] one CGMQ step: device busy {busy_ms:.1f} ms of "
          f"{step_ms:.1f} ms unprofiled wall, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}; K3 {k3_us / 1e3:.2f} ms "
          f"({k3_us / busy:.3f} of busy); fake-quant backward "
          f"{fq_bwd_us / 1e3:.2f} ms ({len(bwd)} calls, {fq_aten} ATen "
          f"ops, its kernels among the others); GEMMs {gemm_us / 1e3:.1f} "
          f"ms; other kernels {sum(others.values()) / 1e3:.1f} ms [{card}]")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print("[train-profile] top other kernels: " + "; ".join(
        f"{k} {v / 1e3:.2f} ms" for k, v in top))


def phase_train_serve(cfg, state, recipe, card: str):
    """Export the certified state (export_gates, the learned betas) to int
    codes and serve 2 greedy requests of 16 tokens through ServingEngine:
    tokens in the vocabulary, K1 launched for every site exported at 8
    bits (K4 for 2 and 4 bits), K3 not at all."""
    import numpy as np
    import torch

    from repro_torch.core.controller import export_gates
    from repro_torch.serving.engine import SamplingParams, ServingEngine

    qs = {"qcfg": recipe.qcfg, "gates": export_gates(state.cgmq),
          "betas": state.betas, "signed": recipe.signed}
    params = state.params
    state.opt = state.probes = None
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, params, slots=2, max_seq=64, quant_state=qs,
                        block_size=BLOCK)
    classes = {}
    for e in eng.export_ledger.entries.values():
        key = f"int{e['storage_bits']}" if "storage_bits" in e \
            else f"fp weights ({e['reason']})"
        classes[key] = classes.get(key, 0) + 1
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (12, 20)]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    results = eng.generate(prompts, SamplingParams(max_new=16))
    launches = {name: fn.launches for name, fn in counters.items()}
    st = eng.stats
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    per_layer = {8: 0, "packed": 0}
    for key, q in eng.qweights.items():
        n = 1 if key == "head.w" else cfg.n_layers
        per_layer["packed" if q.packed else 8] += n
    want = dict.fromkeys(counters, 0)
    want.update({"quant_matmul": per_layer[8] * forwards,
                 "quant_matmul_packed": per_layer["packed"] * forwards,
                 "flash_attention": cfg.n_layers * st["prefill_forwards"],
                 "paged_attention": cfg.n_layers * st["decode_ticks"]})
    print(f"[train->serve] export of the certified state: sites by storage "
          f"{classes}; 2 greedy requests x 16 tokens: "
          f"{[r.tokens for r in results]} [{card}]")
    print(f"[train->serve] launches {launches} == expected {want}")
    for r in results:
        check(len(r.tokens) == 16 and all(0 <= t < cfg.vocab_size
                                          for t in r.tokens),
              f"request {r.rid}: {r.tokens}")
    check(launches == want and launches["quant_matmul"]
          + launches["quant_matmul_packed"] > 0,
          f"serve launches {launches}, expected {want}")


def kernels_line(cfg, k1, k2, k4, k2b, k3, k2c, k5, k6, k7, k2_long,
                 launches, mixed_launches, train_launches, window_launches,
                 int_launches, int_mixed_launches, g2_launches):
    """One entry per kernel. quant_matmul: one decode step's K1 work on the
    uniform path (its 155 GEMMs at M = slots, each shape times its count
    per step); quant_matmul_packed: one decode step's K4 work on the mixed
    path (its 111 packed GEMMs); paged_attention / _quant: one launch at the
    decode shape (K2b over the mixed path's int4 pool); paged_attention_
    window: one K2c launch over a bf16 pool at window 256 + 16 sink tokens,
    positions up to 927; fake_quant: one CGMQ forward's K3 work (its 221
    launches, each shape times its count); int_matmul: one uniform decode
    step's K5 work (the 155 GEMMs at M = slots, fp32 activations quantized
    in the kernel; library: ``torch._int_mm`` at M = 32, which needs
    M > 16); int_matmul_packed: one mixed decode step's K6 work (its 111
    packed GEMMs; library: ``torch._int_mm`` on the unpacked codes);
    flash_attention: one K7 launch at tinyllama's prefill shape (S 512,
    32 heads over 4 KV heads, hd 64, bf16; library SDPA, the same
    function), its launches those of the uniform serve cell (22 a prefill);
    ``ms`` and ``library_ms`` back to back from Python, ``graph_ms`` and
    ``library_graph_ms`` the same calls' device time in a replayed graph.
    ``launches`` from each kernel's own path: serve, mixed serve, train,
    serve-window, serve-int, serve-int-mixed. K2a/K2b/K2c also give the
    wrapper's host time a call (``host_ms``), and K2a and K2c their case at
    [serve-gemma2]'s decode shape with two long rows (``gemma2_long_rows``:
    K2a with softcap 50, K2c under window 4096; launches from
    [serve-gemma2]; ``graph_ms`` the device time, ``bound_fraction`` the
    bound over it; SDPA without the softcap)."""

    def long_rows(r, n):
        return {"launches": n, "max_abs_err": r["max_abs_err"],
                "max_abs_err_f32": r["max_abs_err_f32"],
                "ms": r["ms"], "graph_ms": r["graph_ms"],
                "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "bound_fraction": r["bound_fraction"],
                "library_ms": r["library_ms"],
                "library_graph_ms": r["library_graph_ms"]}

    per_step = {(cfg.d_model, cfg.n_heads * cfg.head_dim): 2 * cfg.n_layers,
                (cfg.d_model, cfg.n_kv_heads * cfg.head_dim):
                    2 * cfg.n_layers,
                (cfg.d_model, cfg.d_ff): 2 * cfg.n_layers,
                (cfg.d_ff, cfg.d_model): cfg.n_layers,
                (cfg.d_model, cfg.padded_vocab): 1}
    rows = [(k1[(SLOTS, k, n)], c) for (k, n), c in per_step.items()]
    k1_bound, k1_by = bound_ms(sum(r["bytes"] * c for r, c in rows),
                               sum(r["flops"] * c for r, c in rows))
    rows4 = [(k4[(SLOTS, k, n, b)], c)
             for (k, n, b), c in mixed_k4_shapes(cfg).items()]
    k4_bound, k4_by = bound_ms(sum(r["bytes"] * c for r, c in rows4),
                               sum(r["flops"] * c for r, c in rows4))
    k2a, k2b4 = k2[0], k2b[MIXED_KV]
    k2c_bf16 = k2c[("bf16",) + K2C_CASES[0]]
    k7p = k7[K7_CASES[0][0]]
    rows3 = [(k3[key], c) for key, c in k3_shapes(cfg).items()]
    k3_bound, k3_by = bound_ms(sum(r["bytes"] * c for r, c in rows3),
                               sum(r["flops"] * c for r, c in rows3))
    rows5 = [(k5[(SLOTS, k, n)], c) for (k, n), c in per_step.items()]
    k5_bound, k5_by = bound_ms(sum(r["bytes"] * c for r, c in rows5),
                               sum(r["flops"] * c for r, c in rows5),
                               INT8_OPS_S)
    rows6 = [(k6[(SLOTS, k, n, b)], c)
             for (k, n, b), c in mixed_k4_shapes(cfg).items()]
    k6_bound, k6_by = bound_ms(sum(r["bytes"] * c for r, c in rows6),
                               sum(r["flops"] * c for r, c in rows6),
                               INT8_OPS_S)
    return {"kernels": [
        {"name": "quant_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/quant_matmul.py:126",
         "launches": launches["quant_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
         "ms": sum(r["ms"] * c for r, c in rows),
         "plain_ms": sum(r["plain_ms"] * c for r, c in rows),
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": sum(r["library_ms"] * c for r, c in rows)},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces":
             "src/repro/kernels/paged_attention/paged_attention.py:206",
         "launches": launches["paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "max_abs_err_f32": max(r["max_abs_err_f32"] for r in k2),
         "ms": k2a["ms"], "plain_ms": k2a["plain_ms"],
         "bound_ms": k2a["bound_ms"], "bound_by": k2a["bound_by"],
         "library_ms": k2a["library_ms"], "host_ms": k2a["host_ms"],
         "graph_ms": k2a["graph_ms"],
         "library_graph_ms": k2a["library_graph_ms"],
         "gemma2_long_rows": long_rows(k2_long[(50.0, None)],
                                       g2_launches["paged_attention"])},
        {"name": "quant_matmul_packed", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/quant_matmul.py:200",
         "launches": mixed_launches["quant_matmul_packed"],
         "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
         "ms": sum(r["ms"] * c for r, c in rows4),
         "plain_ms": sum(r["plain_ms"] * c for r, c in rows4),
         "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": sum(r["library_ms"] * c for r, c in rows4)},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces":
             "src/repro/kernels/paged_attention/paged_attention.py:95",
         "launches": mixed_launches["paged_attention_quant"],
         "max_abs_err": max(r["max_abs_err"] for r in k2b.values()),
         "max_abs_err_f32": max(r["max_abs_err_f32"]
                                for r in k2b.values()),
         "ms": k2b4["ms"], "plain_ms": k2b4["plain_ms"],
         "bound_ms": k2b4["bound_ms"], "bound_by": k2b4["bound_by"],
         "library_ms": k2b4["library_ms"], "host_ms": k2b4["host_ms"],
         "graph_ms": k2b4["graph_ms"],
         "library_graph_ms": k2b4["library_graph_ms"]},
        {"name": "paged_attention_window", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces":
             "src/repro/kernels/paged_attention/paged_attention.py:206",
         "launches": window_launches["paged_attention_window"],
         "max_abs_err": max(r["max_abs_err"] for r in k2c.values()),
         "max_abs_err_f32": max(r["max_abs_err_f32"]
                                for r in k2c.values()),
         "ms": k2c_bf16["ms"], "plain_ms": k2c_bf16["plain_ms"],
         "bound_ms": k2c_bf16["bound_ms"], "bound_by": k2c_bf16["bound_by"],
         "library_ms": k2c_bf16["library_ms"],
         "host_ms": k2c_bf16["host_ms"], "graph_ms": k2c_bf16["graph_ms"],
         "library_graph_ms": k2c_bf16["library_graph_ms"],
         "gemma2_long_rows": long_rows(k2_long[(50.0, 4096)],
                                       g2_launches["paged_attention_window"])},
        {"name": "fake_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/fake_quant/fake_quant.py:69",
         "launches": train_launches["fake_quant"],
         "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
         "ms": sum(r["ms"] * c for r, c in rows3),
         "plain_ms": sum(r["plain_ms"] * c for r, c in rows3),
         "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": sum(r["library_ms"] * c for r, c in rows3)},
        {"name": "int_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/quant_matmul.py:278",
         "launches": int_launches["int_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in k5.values()),
         "ms": sum(r["ms"] * c for r, c in rows5),
         "plain_ms": sum(r["plain_ms"] * c for r, c in rows5),
         "bound_ms": k5_bound, "bound_by": k5_by,
         "library_ms": sum(r["library_ms"] * c for r, c in rows5)},
        {"name": "int_matmul_packed", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/quant_matmul.py:349",
         "launches": int_mixed_launches["int_matmul_packed"],
         "max_abs_err": max(r["max_abs_err"] for r in k6.values()),
         "ms": sum(r["ms"] * c for r, c in rows6),
         "plain_ms": sum(r["plain_ms"] * c for r, c in rows6),
         "bound_ms": k6_bound, "bound_by": k6_by,
         "library_ms": sum(r["library_ms"] * c for r, c in rows6)},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces":
             "src/repro/kernels/flash_attention/flash_attention.py:103",
         "launches": launches["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k7.values()),
         "ms": k7p["ms"], "plain_ms": k7p["plain_ms"],
         "bound_ms": k7p["bound_ms"], "bound_by": k7p["bound_by"],
         "library_ms": k7p["library_ms"], "graph_ms": k7p["graph_ms"],
         "library_graph_ms": k7p["library_graph_ms"]},
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port; raises ImportError when run outside a checkout of the repo
    from repro_torch.configs import get_config

    # plain versions are the references: keep fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    cfg = get_config("tinyllama-1.1b")
    prompts = _prompts(cfg.vocab_size)
    m_prefill = max(_bucket(len(p)) for p in prompts)
    k1, k2, k4, k2b, k3, k2c, k5, k6, k7, k2_long = phase_kernels(
        cfg, m_prefill, card)
    phase_parity(cfg, card)
    for kv_dtype in ("int8", "int4"):
        phase_parity(cfg, card, state="mixed", kv_dtype=kv_dtype)
    for kv_dtype in ("bf16", "int8"):
        phase_parity(cfg, card, kv_dtype=kv_dtype, windowed=True)
    phase_parity(cfg, card, act_bits=INT_ACT_BITS)
    phase_parity(cfg, card, state="mixed", kv_dtype=MIXED_KV,
                 act_bits=INT_ACT_BITS)
    phase_parity(dataclasses.replace(get_config("gemma2-2b"),
                                     window=G2_PARITY_WINDOW),
                 card, plen=G2_PARITY_PLEN, tag="[parity-gemma2]")
    torch.cuda.empty_cache()
    eng, launches, export = phase_serve(cfg, prompts, card)
    _one_sync(phase_profile(eng, prompts, card), "uniform/bf16")
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    eng, mixed_launches, mixed_export = phase_serve(cfg, prompts, card,
                                                    mixed=True, params=params)
    total, uniform_total = (sum(e.values()) for e in (mixed_export, export))
    print(f"[serve] mixed export {total} B = {total / uniform_total:.4f} of "
          f"the uniform int8 export's {uniform_total} B (codes "
          f"{mixed_export['codes']} vs {export['codes']} B) [{card}]")
    check(total < uniform_total, "the mixed export is not smaller")
    _one_sync(phase_profile(eng, prompts, card), "mixed/int4")
    del eng
    torch.cuda.empty_cache()
    eng, win_prompts, window_launches = phase_serve_window(cfg, card, params)
    _one_sync(phase_profile(eng, win_prompts, card), "serve-window")
    del eng
    torch.cuda.empty_cache()
    int_launches = {}
    for mixed in (False, True):
        eng, int_launches[mixed], _ = phase_serve(
            cfg, prompts, card, mixed=mixed, params=params,
            act_bits=INT_ACT_BITS)
        _one_sync(phase_profile(eng, prompts, card),
                  "serve-int-mixed" if mixed else "serve-int")
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    eng, g2_prompts, g2_launches = phase_serve_gemma2(card)
    _one_sync(phase_profile(eng, g2_prompts[G2_SLOTS:], card,
                            slots=G2_SLOTS), "serve-gemma2")
    del eng
    torch.cuda.empty_cache()
    phase_train_parity(cfg, card)
    state, recipe, train_launches = phase_train(cfg, card)
    phase_train_serve(cfg, state, recipe, card)
    del state
    print(f"[done] {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps(kernels_line(cfg, k1, k2, k4, k2b, k3, k2c, k5, k6, k7,
                                  k2_long, launches, mixed_launches,
                                  train_launches, window_launches,
                                  int_launches[False], int_launches[True],
                                  g2_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
