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
                 2/4/8-bit state over int8 and int4 pools.
  5. serve    -- full tinyllama-1.1b (22 layers, random seeded weights, int8
                 per-channel export, paged bf16 KV) through ServingEngine:
                 12 greedy requests on 8 slots; launch counters must equal
                 what the path implies and the tick must sync the host once.
  6. profile  -- a few more full-batch decode ticks on the same engine: host
                 wall per tick, then device time by kernel (torch.profiler)
                 and the device's idle share.
  7. mixed serve -- the same requests through the mixed 2/4/8-bit export
                 (2- and 4-bit sites packed) over an int4 KV pool, with its
                 exact launch counts, the export's and the KV cache's device
                 bytes; then its own profile.

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

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores. Both kernels compute in fp32 on the CUDA cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

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


def copies_past_l2(nbytes: int, limit: int = 256) -> int:
    """How many copies of an operand to rotate so that consecutive timed
    launches read it cold from HBM (the 50 MB L2 is exceeded), as the
    decode path does: each layer's weights and pools are read once."""
    return max(1, min(limit, math.ceil(120e6 / max(nbytes, 1))))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
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


def _prompts(vocab: int):
    rng = __import__("numpy").random.default_rng(SEED)
    lens = rng.integers(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
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


def k2_case(softcap, gen, card: str, max_pos: int):
    """K2a against its plain version at the decode shape (B=8, KV=4, G=8,
    hd=64, bs=8) with ragged pos and -1 table entries past each row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

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
    want = paged_attention_ref(q, kp, vp, table, pos, softcap=softcap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = K2_TOL_FACTOR * float(vp.abs().max()) + 1e-5
    res = {"softcap": softcap, "max_abs_err": err, "tol": tol,
           "ok": err <= tol}

    pools = [(kp.clone(), vp.clone())
             for _ in range(copies_past_l2(2 * kp.numel() * 2, 64))]
    it = iter(range(1 << 30))

    def run_kernel():
        k_, v_ = pools[next(it) % len(pools)]
        paged_attention(q, k_, v_, table, pos, softcap=softcap)

    def run_plain():
        k_, v_ = pools[next(it) % len(pools)]
        paged_attention_ref(q, k_, v_, table, pos, softcap=softcap)

    res["ms"] = time_ms(run_kernel)
    res["plain_ms"] = time_ms(run_plain)
    res["library_ms"] = None
    if softcap is None:
        # yardstick: SDPA over the KV already gathered per row (the gather
        # itself is not timed), GQA heads expanded, mask col <= pos
        lmax = int(pos_np.max()) + 1
        safe = torch.where(table >= 0, table, 0).long()
        kg = kp[safe].reshape(b, mb * bs, kvh, hd)[:, :lmax]
        vg = vp[safe].reshape(b, mb * bs, kvh, hd)[:, :lmax]
        kg = kg.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vg = vg.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        qs = q.reshape(b, kvh * g, 1, hd)
        mask = (torch.arange(lmax, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask))
    tokens = int(pos_np.sum()) + b          # tokens each row attends
    res["bytes"] = (2 * b * kvh * g * hd + 2 * 2 * tokens * kvh * hd
                    + 4 * b * mb + 4 * b + 4 * b * kvh * g * hd)
    res["flops"] = 4.0 * tokens * kvh * g * hd
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    lib = "n/a (no softcap in SDPA)" if res["library_ms"] is None \
        else f"{res['library_ms']:.4f} ms"
    print(f"[kernels] paged_attention B={b} KV={kvh} G={g} hd={hd} bs={bs} "
          f"max_pos={int(pos_np.max())} softcap={softcap}: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}) -> {'ok' if res['ok'] else 'FAIL'}; "
          f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"library (SDPA) {lib}, bound {res['bound_ms'] * 1e3:.2f} us "
          f"({res['bound_by']}) [{card}]")
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
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention_quant
    from repro_torch.kernels.paged_attention.ref import (
        bf16_rounding_tolerance, paged_attention_ref)
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
           "ok": err <= tol and err32 <= tol32}

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

    res["ms"] = time_ms(run_kernel)
    res["plain_ms"] = time_ms(run_plain)
    # yardstick: SDPA over the KV already gathered and dequantized per row
    # (gather and dequantization not timed), GQA heads expanded, bf16
    lmax = int(pos_np.max()) + 1
    safe = torch.where(table >= 0, table, 0).long()
    kg = kd[safe].reshape(b, mb * bs, kvh, hd)[:, :lmax].to(torch.bfloat16)
    vg = vd[safe].reshape(b, mb * bs, kvh, hd)[:, :lmax].to(torch.bfloat16)
    kg = kg.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    qs = q.reshape(b, kvh * g, 1, hd)
    mask = (torch.arange(lmax, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask))
    tokens = int(pos_np.sum()) + b          # tokens each row attends
    vec_bytes = spec.bytes_per_vector()     # codes + fp16 scales
    res["bytes"] = (2 * b * kvh * g * hd + 2 * tokens * kvh * vec_bytes
                    + 4 * b * mb + 4 * b + 4 * b * kvh * g * hd)
    res["flops"] = 4.0 * tokens * kvh * g * hd
    res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], res["flops"])
    print(f"[kernels] paged_attention_quant {kv_dtype} B={b} KV={kvh} G={g} "
          f"hd={hd} bs={bs} max_pos={int(pos_np.max())}: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}), vs fp32 plain {err32:.3e} (tol "
          f"{tol32:.3e}) -> {'ok' if res['ok'] else 'FAIL'}; kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library "
          f"(SDPA, gathered dequantized KV) {res['library_ms']:.4f} ms, bound "
          f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']}) [{card}]")
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
    bad = [r["shape"] for r in k1.values() if not r["ok"]] \
        + [f"softcap={r['softcap']}" for r in k2 if not r["ok"]] \
        + [(r["shape"], r["bits"]) for r in k4.values() if not r["ok"]] \
        + [r["kv_dtype"] for r in k2b.values() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    n_eq = sum(r["k1_bit_equal"] for r in k4.values())
    print(f"[kernels] K4 bit-equal to K1 on the unpacked codes in {n_eq} of "
          f"{len(k4)} cases [{card}]")
    return k1, k2, k4, k2b


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
    q in fp32, so it rounds neither K/V nor the probabilities to bf16 --
    the kernels' own numerics (K2a/K2b keep them fp32, as the TPU kernel
    does)."""
    import contextlib
    from unittest import mock

    import torch

    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.quant_matmul import quant_matmul as wrappers
    from repro_torch.kernels.quant_matmul import ref

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
    return stack


def phase_parity(cfg, card: str, state: str = "uniform",
                 kv_dtype: str = "bf16"):
    """One prefill_slot and one decode_step of a 2-layer full-width model on
    the CPU (plain versions) and on the card (kernels), same weights: the
    uniform int8 or the mixed 2/4/8-bit state, over a ``kv_dtype`` pool. A
    third run on the CPU with fp64 GEMM sums gives the logits' spread.

    For the mixed state the CPU runs attend in fp32 (``_cpu_rounding``):
    on that ill-conditioned model the plain attention's bf16 roundings of
    K, V and the probabilities alone move the decode logits by up to ~40%
    of their max, while the kernels keep them in fp32 by design."""
    import numpy as np
    import torch

    from repro_torch.core.sites import QuantContext
    from repro_torch.models import transformer as tfm
    from repro_torch.quant import specs_from_state
    from repro_torch.quant.kv import KVQuantSpec
    from repro_torch.serving import kv_pool
    from repro_torch.serving.engine import (export_int_model,
                                            make_mixed_quant_state,
                                            make_uniform_quant_state)

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params_cpu = tfm.init_params(cfg2, SEED, device="cpu")
    make_state = make_mixed_quant_state if state == "mixed" \
        else make_uniform_quant_state
    qs_cpu = make_state(cfg2, params_cpu, device="cpu")
    kv_spec = None if kv_dtype == "bf16" else KVQuantSpec(
        bits=int(kv_dtype[-1]), group_size=math.gcd(cfg2.head_dim, 32),
        head_dim=cfg2.head_dim)
    plen, slots, mb = 20, 2, 8
    rng = np.random.default_rng(SEED + 2)
    toks = np.zeros((1, _bucket(plen)), np.int64)
    toks[0, :plen] = rng.integers(0, cfg2.vocab_size, plen)
    out = {}
    attention_fp32 = state == "mixed"
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
        with _cpu_rounding(**rounding):
            qweights, _ = export_int_model(params, cfg2, qs, device=dev)
            qc = QuantContext("serve", cfg=qs["qcfg"], qweights=qweights,
                              specs=specs_from_state(qs["gates"], qs["betas"],
                                                     qs["signed"]))
            cache = tfm.init_paged_cache(cfg2, slots, slots * mb + 1, BLOCK,
                                         kv_spec=kv_spec, device=dev)
            alloc = kv_pool.init_alloc(slots * mb + 1, slots, mb, device=dev)
            alloc = kv_pool.alloc_range(alloc, 0, 0, -(-plen // BLOCK))
            lp, cache = tfm.prefill_slot(
                qc, params, torch.from_numpy(toks).to(dev), plen, cache, 0,
                cfg2, block_table=alloc["table"])
            # every run decodes the plain CPU run's first token
            first = int(out["cpu"][0][plen - 1].argmax()) if out \
                else int(lp[0, plen - 1, :cfg2.vocab_size].argmax())
            adv = torch.tensor([True, False], device=dev)
            alloc = kv_pool.tick_alloc(alloc, cache["pos"], adv, BLOCK)
            ld, cache = tfm.decode_step(
                qc, params, cache, torch.tensor([first, 0], device=dev), cfg2,
                advance=adv, block_table=alloc["table"])
        out[run] = (lp[0, :plen, :cfg2.vocab_size].float().cpu(),
                    ld[0, 0, :cfg2.vocab_size].float().cpu())
        del params, qweights, qc, cache
    label = f"{state} state, {kv_dtype} KV" + (
        ", CPU attention in fp32" if attention_fp32 else "")
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
        print(f"[parity] 2-layer full-width, {label}, {name}: max |logit "
              f"diff| {diff:.4e}, max |logit| {float(ref.abs().max()):.4e}, "
              f"spread under fp64 GEMM sums {spread:.4e}; tol {tol:.4e} = "
              f"max({PARITY_RTOL:g} x max|logit|, {PARITY_SPREAD_FACTOR:g} x "
              f"spread); top-1 agreement {agree:.3f} over {rows.shape[0]} "
              f"row(s), last row cpu {top_ref} vs card {top_got} [{card}]")
        if attention_fp32:
            bf16 = out["cpu_bf16_attention"][i]
            print(f"[parity]   against the CPU with its plain bf16 attention "
                  f"instead: max |logit diff| "
                  f"{float((got - bf16).abs().max()):.4e}, last row top-1 "
                  f"{int(bf16.reshape(-1, bf16.shape[-1])[-1].argmax())}")
        check(diff <= tol, f"{label}: {name} logits differ by {diff} > {tol}")
        check(top_ok, f"{label}: {name} top-1 {top_got} vs plain {top_ref}")


def _counters() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        paged_attention, paged_attention_quant)
    from repro_torch.kernels.quant_matmul.quant_matmul import (
        quant_matmul, quant_matmul_packed)

    return {"quant_matmul": quant_matmul,
            "quant_matmul_packed": quant_matmul_packed,
            "paged_attention": paged_attention,
            "paged_attention_quant": paged_attention_quant}


def phase_serve(cfg, prompts, card: str, *, mixed: bool = False,
                params=None):
    """The 22-layer serve: the uniform int8 state over a bf16 pool (slice
    1), or the mixed 2/4/8-bit state over a MIXED_KV pool (slice 2). Every
    launch counter is set to 0 just before ``generate`` and read just after;
    they must equal what the path implies."""
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
                        block_size=BLOCK, kv_dtype=kv_dtype)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
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
    if mixed:   # 8-bit attn_o, mlp_down: K1; the five packed sites: K4
        want = {"quant_matmul": 2 * layers * forwards,
                "quant_matmul_packed": (5 * layers + 1) * forwards,
                "paged_attention": 0,
                "paged_attention_quant": layers * st["decode_ticks"]}
    else:
        want = {"quant_matmul": (7 * layers + 1) * forwards,
                "quant_matmul_packed": 0,
                "paged_attention": layers * st["decode_ticks"],
                "paged_attention_quant": 0}
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
    tag = "mixed 2/4/8-bit" if mixed else "uniform int8"
    print(f"[serve] {tag}, {kv_dtype} KV: tinyllama-1.1b {layers} layers, "
          f"{SLOTS} slots, {len(prompts)} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"max_new {MAX_NEW}: setup {setup_s:.2f} s; export on the card: "
          f"codes {export['codes']} B + aux {export['aux']} B = "
          f"{(export['codes'] + export['aux']) / 1e9:.4f} GB; KV pool "
          f"{kv_per_token:.0f} B per cached token "
          f"(kv_report {eng.kv_report()['bytes_per_cached_token']} B)")
    print(f"[serve] stats {json.dumps(st)}")
    print(f"[serve] launches {launches} == expected {want}; "
          f"tick_syncs == decode_ticks == {st['decode_ticks']}")
    print(f"[serve] {tag}: TTFT mean {sum(ttft) / len(ttft):.4f} s max "
          f"{max(ttft):.4f} s; decode {decode_tokens / st['decode_time_s']:.1f}"
          f" tok/s ({st['decode_time_s'] / st['decode_ticks'] * 1e3:.3f} ms "
          f"per tick); prefill {st['prefill_time_s']:.3f} s; wall "
          f"{wall:.3f} s [{card}]")
    return eng, launches, export


def phase_profile(eng, prompts, card: str, ticks: int = 5):
    """Where a decode tick's time goes: ``ticks`` full-batch ticks timed on
    the host without the profiler, then ``ticks`` more under
    ``torch.profiler`` for the device time by kernel. The idle share is
    1 - device busy / unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(rid=1_000_000 + i, prompt=p,
                           max_new=2 * ticks + 2))
    eng.step()                       # the admission wave and a first tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()                   # each step ends in its one host sync
    wall_ms = (time.perf_counter() - t0) / ticks * 1e3
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
    tag = f"{eng.kv_dtype} KV, " + ("mixed" if any(
        q.packed for q in eng.qweights.values()) else "uniform int8")
    print(f"[profile] {tag}: {aten_calls / ticks:.0f} ATen calls per decode "
          f"tick (nested included) for {SLOTS} slots")
    if busy == 0:
        print(f"[profile] {tag}: decode tick {wall_ms:.3f} ms on the host "
              f"clock; device time not measured (the profiler saw no "
              f"kernels) [{card}]")
        return
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {tag}: decode tick ({SLOTS} slots): host wall "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; per tick " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in by_kind.items()) + f" [{card}]")
    print(f"[profile] {tag}: top other kernels per tick: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in top))


def kernels_line(cfg, k1, k2, k4, k2b, launches, mixed_launches):
    """One entry per kernel. quant_matmul: one decode step's K1 work on the
    uniform path (its 155 GEMMs at M = slots, each shape times its count
    per step); quant_matmul_packed: one decode step's K4 work on the mixed
    path (its 111 packed GEMMs); paged_attention / _quant: one launch at the
    decode shape (K2b over the mixed path's int4 pool). ``launches`` from
    each kernel's own serve run."""
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
         "ms": k2a["ms"], "plain_ms": k2a["plain_ms"],
         "bound_ms": k2a["bound_ms"], "bound_by": k2a["bound_by"],
         "library_ms": k2a["library_ms"]},
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
         "ms": k2b4["ms"], "plain_ms": k2b4["plain_ms"],
         "bound_ms": k2b4["bound_ms"], "bound_by": k2b4["bound_by"],
         "library_ms": k2b4["library_ms"]},
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
    k1, k2, k4, k2b = phase_kernels(cfg, m_prefill, card)
    phase_parity(cfg, card)
    for kv_dtype in ("int8", "int4"):
        phase_parity(cfg, card, state="mixed", kv_dtype=kv_dtype)
    torch.cuda.empty_cache()
    eng, launches, export = phase_serve(cfg, prompts, card)
    phase_profile(eng, prompts, card)
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
    phase_profile(eng, prompts, card)
    print(f"[done] {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps(kernels_line(cfg, k1, k2, k4, k2b, launches,
                                  mixed_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
