"""Time one hand-written kernel of one checkout on one card.

    python3 scripts/kernel_timing.py --kernel k1|k2|k3|k4|k5|k6|k7
                                     [--src DIR] [--label NAME]

``k2`` (paged decode attention): K2a, K2b over an int4 pool and K2c under
window 256 with 16 sink tokens at tinyllama's decode shapes, and at
[serve-gemma2]'s decode shape with two long rows K2a with softcap 50 and
without, K2c under window 4096 with softcap 50; each over copies of its
pools taken in turn, so that each call reads its K/V from HBM, with SDPA
beside it (``chip_smoke.sdpa_yardstick``, the same rows gathered, no
softcap). ``k7`` (whole-prompt flash attention): each of ``chip_smoke``'s
K7 cases, warm L2. ``k1`` (fused dequant GEMM over int8 codes): every
GEMM shape of a decode step (tinyllama at 8 rows, gemma2 at 4) and of a
prefill (tinyllama at 512 rows, gemma2 at 4608, its head left out), and
``k4`` (over packed 2/4-bit codes) at the mixed state's packed shapes, by
the entry point the serving path calls (``quant_matmul_op`` /
``quant_matmul_packed_op``) on bf16 activations, the codes taken in turn
from copies past L2; each decode step's sums by launch count close the
output. ``k3`` (fused fake-quant): every shape of a CGMQ forward
(``chip_smoke.k3_shapes``), summed by launches into the forward. ``k5``
(int8 x int8 GEMM): every GEMM of [serve-int]'s uniform int8 state
(``chip_smoke.k1_shapes``) at 8 rows, summed into a decode step, and at
512 rows, on fp32 activations quantized in the kernel as the serving path
calls it, with ``torch._int_mm`` (at M 32 for the decode rows; it needs
M > 16) on the same codes beside each. ``k6``
(int8 x packed 2/4-bit GEMM): the mixed state's packed GEMMs at 8 rows
(summed into a decode step) and 512, on fp32 activations quantized in the
kernel, as the serving path calls it, and the 2-bit mlp_gate at 64, 352
and 4608 rows and with int8 codes in at 512.

The inputs are made as ``chip_smoke.py`` makes them; the wrappers called
are those of the ``repro_torch`` found in ``--src`` (default: this
checkout's ``src``). Each case prints three times a call: back to back
from Python (``chip_smoke.time_ms``; the host's work counts where it
exceeds the device's), the device time alone (a replayed CUDA graph,
``chip_smoke.graph_ms``) and the host's wall time (``chip_smoke.host_ms``),
and the library call's (SDPA, ``torch._int_mm``) by the first two methods
where the case has it. Point ``--src`` at the ``src`` of another commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists,
and run it in one call beside this checkout's, to compare two versions
of a kernel on the same card by the same methods. Correctness is ``chip_smoke.py``'s to check, not this
script's. The last line is one JSON object: the card, the kernel, the
label and each case's times.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on sys.path)


def _k2_cases(gen):
    """Yields (name, kernel, SDPA or None, iters) for each K2 case; the
    kernel takes its pools in turn from enough copies that the bytes it
    reads (``nbytes``, else the whole pools) miss L2."""
    import torch

    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import attended
    from repro_torch.quant.kv import KVQuantSpec, dequantize_kv, quantize_kv

    def rotated(call, pools, nbytes=None):
        nbytes = nbytes or sum(t.numel() * t.element_size() for t in pools)
        copies = [pools] + [tuple(t.clone() for t in pools) for _ in range(
            chip_smoke.copies_past_l2(nbytes, 64) - 1)]
        turn = itertools.count()
        return lambda: call(*copies[next(turn) % len(copies)])

    dev, iters = "cuda", chip_smoke.K2_ITERS
    b, kvh, g, hd, bs = chip_smoke.SLOTS, 4, 8, 64, chip_smoke.BLOCK
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    # tinyllama K2a and K2b: chip_smoke's decode table
    table_np, pos_np, nb, mb = chip_smoke._decode_table(
        chip_smoke.PROMPT_HI + chip_smoke.MAX_NEW)
    table = torch.from_numpy(table_np).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    valid = attended(pos, mb * bs)
    kp, vp = (torch.randn((nb, bs, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    yield ("tinyllama K2a", rotated(
        lambda k, v: pa.paged_attention(q, k, v, table, pos), (kp, vp)),
        chip_smoke.sdpa_yardstick(q, kp, vp, table, valid), iters)
    spec = KVQuantSpec(bits=4, group_size=32, head_dim=hd)
    (kc, ks), (vc, vs) = (quantize_kv(torch.randn(
        (nb, bs, kvh, hd), generator=gen, device=dev), spec)
        for _ in range(2))
    yield ("tinyllama K2b int4", rotated(
        lambda *kv: pa.paged_attention_quant(q, *kv, table, pos),
        (kc, vc, ks, vs)),
        chip_smoke.sdpa_yardstick(q, dequantize_kv(kc, ks, spec),
                                  dequantize_kv(vc, vs, spec), table, valid),
        iters)
    # tinyllama K2c: chip_smoke's serve-window table, evicted
    window, sinks = chip_smoke.K2C_CASES[0]
    max_pos = chip_smoke.WIN_PROMPT_HI + chip_smoke.MAX_NEW
    wt_np, wpos_np, wnb, wmb = chip_smoke._window_table(max_pos, window,
                                                        sinks)
    wt = torch.from_numpy(wt_np).to(dev)
    wpos = torch.from_numpy(wpos_np).to(dev)
    wk, wv = (torch.randn((wnb, bs, kvh, hd), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    yield (f"tinyllama K2c window {window} sinks {sinks}", rotated(
        lambda k, v: pa.paged_attention_window(q, k, v, wt, wpos,
                                               window=window, sinks=sinks),
        (wk, wv)),
        chip_smoke.sdpa_yardstick(q, wk, wv, wt, attended(
            wpos, wmb * bs, window, sinks)), iters)
    # gemma2's long rows
    for cap, w in ((50.0, None), (None, None), (50.0, 4096)):
        gq, gk, gv, gt, gpos, n = chip_smoke._gemma2_decode_inputs(gen, w)
        live = 2 * int(n.sum()) * gk[0, 0].numel() * gk.element_size()
        if w is None:
            def call(k, v, a=(gq, gt, gpos), cap=cap):
                return pa.paged_attention(a[0], k, v, *a[1:], softcap=cap)
            name = f"gemma2 long rows K2a softcap {cap}"
        else:
            def call(k, v, a=(gq, gt, gpos), cap=cap, w=w):
                return pa.paged_attention_window(a[0], k, v, *a[1:],
                                                 window=w, softcap=cap)
            name = f"gemma2 long rows K2c window {w} softcap {cap}"
        sdpa = chip_smoke.sdpa_yardstick(gq, gk, gv, gt, attended(
            gpos, gt.shape[1] * gk.shape[1], w), limit=8)
        yield name, rotated(call, (gk, gv), live), sdpa, iters


def _k7_cases(gen):
    """Yields (name, kernel, None, iters) for each of chip_smoke's K7
    cases."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention

    for name, b, hq, hkv, hd, s, dtype, window, sinks, cap in \
            chip_smoke.K7_CASES:
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .to(getattr(torch, dtype)).transpose(1, 2)
                   for h in (hq, hkv, hkv))
        kw = {"causal": True, "window": window, "sinks": sinks,
              "softcap": cap}
        yield (name, lambda q=q, k=k, v=v, kw=kw: flash_attention(
            q, k, v, **kw), None, 10)


def _qmm_cases(gen, packed: bool):
    """Yields (name, call, None, iters) for each K1 (``packed`` False) or
    K4 GEMM of chip_smoke's serve cells, and notes each decode GEMM's
    launches per step in ``_STEP``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.quant.pack import pack_codes

    dev = "cuda"
    tiny, g2 = get_config("tinyllama-1.1b"), get_config("gemma2-2b")
    for m, cfg, decode in ((chip_smoke.SLOTS, tiny, True),
                           (512, tiny, False),
                           (chip_smoke.G2_SLOTS, g2, True),
                           (chip_smoke.G2_MAX_SEQ, g2, False)):
        shapes = {(k, n, b): c for (k, n, b), c in
                  chip_smoke.mixed_k4_shapes(cfg).items()} if packed else \
            {(k, n, 8): c for (k, n), c in chip_smoke.k1_shapes(cfg).items()}
        for (k, n, bits), count in shapes.items():
            if not decode and n == cfg.padded_vocab and m > 512:
                continue
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            half = 1 << (bits - 1)
            codes = torch.randint(-half, half, (k, n), generator=gen,
                                  device=dev, dtype=torch.int8)
            if bits < 8:
                codes = pack_codes(codes, bits)
            scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-3
            bias = (torch.rand((n,), generator=gen, device=dev) - 0.5) * 1e-3
            copies = [codes] + [codes.clone() for _ in range(
                chip_smoke.copies_past_l2(codes.numel(), 64) - 1)]
            turn = itertools.count()
            if bits == 8:
                def call(x=x, c=copies, s=scale, b=bias, t=turn):
                    return ops.quant_matmul_op(x, c[next(t) % len(c)], s, b)
            else:
                def call(x=x, c=copies, s=scale, b=bias, t=turn, bits=bits,
                         k=k):
                    return ops.quant_matmul_packed_op(
                        x, c[next(t) % len(c)], s, b, bits=bits, k=k)
            name = (f"{cfg.name} M={m} K={k} N={n}"
                    + (f" {bits}-bit" if bits < 8 else ""))
            if decode:
                _STEP[name] = (f"{cfg.name} decode step", count)
            yield name, call, None, 20 if 2.0 * m * n * k < 2e11 else 5


def _k3_cases(gen):
    """Yields (name, call, None, iters) for each K3 shape of a CGMQ forward
    (``chip_smoke.k3_shapes``) at the [train] phase's scalar 16-bit gate,
    signed, x taken in turn from copies past L2; notes each shape's
    launches a forward in ``_STEP``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.fake_quant.fake_quant import fake_quant

    cfg = get_config("tinyllama-1.1b")
    for (m, n, dtype), count in chip_smoke.k3_shapes(cfg).items():
        x = (torch.randn((m, n), generator=gen, device="cuda") * 1.5).to(
            getattr(torch, dtype))
        gate = torch.full((n,), chip_smoke.TRAIN_GATE0, device="cuda")
        beta = torch.rand((n,), generator=gen, device="cuda") * 1.7 + 0.3
        copies = [x] + [x.clone() for _ in range(chip_smoke.copies_past_l2(
            x.numel() * x.element_size()) - 1)]
        turn = itertools.count()

        def call(c=copies, g=gate, b=beta, t=turn):
            return fake_quant(c[next(t) % len(c)], g, b, True)
        name = f"{cfg.name} K3 {m}x{n} {dtype}"
        _STEP[name] = (f"{cfg.name} CGMQ forward", count)
        yield name, call, None, 20


def _k6_cases(gen):
    """Yields (name, call, None, iters) for each K6 GEMM of the mixed state
    (``chip_smoke.mixed_k4_shapes``) at the decode rows (8) and a prefill
    (512 rows), as the serving path calls it: fp32 activations quantized
    in the kernel on an 8-bit grid, the packed codes taken in turn from
    copies past L2; notes each decode GEMM's launches a step in
    ``_STEP``. Then the 2-bit mlp_gate at 64, 352 and 4608 rows (one tile
    row, one wave of 132 tiles, twelve waves), and at 512 rows with int8
    activation codes in (no quantizing pass before the tiles)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul.quant_matmul import \
        int_matmul_packed
    from repro_torch.quant.pack import pack_codes

    cfg = get_config("tinyllama-1.1b")
    mlp_gate = (cfg.d_model, cfg.d_ff, 2)
    cases = [(m, key, count, m == chip_smoke.SLOTS, True)
             for m in (chip_smoke.SLOTS, 512)
             for key, count in chip_smoke.mixed_k4_shapes(cfg).items()]
    cases += [(m, mlp_gate, 0, False, True) for m in (64, 352, 4608)]
    cases += [(512, mlp_gate, 0, False, False)]
    for m, (k, n, bits), count, decode, quant in cases:
        x, grid, qx, rowsum, codes, es, eb, cst = chip_smoke._int_operands(
            m, k, n, bits, gen)
        packed = pack_codes(codes, bits)
        copies = [packed] + [packed.clone() for _ in range(
            chip_smoke.copies_past_l2(packed.numel()) - 1)]
        turn = itertools.count()
        if quant:
            def call(x=x, c=copies, t=turn, v=(es, eb, cst), a=(grid, 8),
                     bits=bits, k=k):
                return int_matmul_packed(x, c[next(t) % len(c)], v[0], v[1],
                                         None, v[2], bits=bits, k=k, act=a)
        else:
            def call(x=qx, c=copies, t=turn, v=(es, eb, cst), r=rowsum,
                     bits=bits, k=k):
                return int_matmul_packed(x, c[next(t) % len(c)], v[0], v[1],
                                         r, v[2], bits=bits, k=k)
        name = (f"{cfg.name} K6 M={m} K={k} N={n} {bits}-bit"
                + ("" if quant else " int8 x"))
        if decode:
            _STEP[name] = (f"{cfg.name} mixed decode step", count)
        yield name, call, None, 20


def _k5_cases(gen):
    """Yields (name, call, torch._int_mm or None, iters) for each K5 GEMM of
    the uniform int8 state (``chip_smoke.k1_shapes``) at the decode rows
    (8) and a prefill (512 rows), as the serving path calls it: fp32
    activations quantized in the kernel on an 8-bit grid, the codes taken
    in turn from copies past L2, ``torch._int_mm`` on the same codes at M =
    max(M, 32) beside it (None where K or N is no multiple of 8); notes
    each decode GEMM's launches a step in ``_STEP``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul.quant_matmul import int_matmul

    cfg = get_config("tinyllama-1.1b")
    for m in (chip_smoke.SLOTS, 512):
        for (k, n), count in chip_smoke.k1_shapes(cfg).items():
            x, grid, qx, _, codes, es, eb, cst = chip_smoke._int_operands(
                m, k, n, 8, gen)
            copies = [codes] + [codes.clone() for _ in range(
                chip_smoke.copies_past_l2(codes.numel()) - 1)]
            turn = itertools.count()

            def call(x=x, c=copies, t=turn, v=(es, eb, cst), a=(grid, 8)):
                return int_matmul(x, c[next(t) % len(c)], v[0], v[1], None,
                                  v[2], act=a)
            lib = None
            if k % 8 == 0 and n % 8 == 0:
                a = torch.zeros((max(m, chip_smoke.INT_MM_MIN_M), k),
                                dtype=torch.int8, device="cuda")
                a[:m] = qx

                def lib(a=a, c=copies, t=itertools.count()):
                    return torch._int_mm(a, c[next(t) % len(c)])
            name = f"{cfg.name} K5 M={m} K={k} N={n}"
            if m == chip_smoke.SLOTS:
                _STEP[name] = (f"{cfg.name} uniform int decode step", count)
            yield name, call, lib, 20


# decode GEMM name -> (model, launches per step), filled by _qmm_cases,
# _k3_cases (a CGMQ forward's shapes), _k5_cases and _k6_cases
_STEP: dict[str, tuple[str, int]] = {}

CASES = {"k1": lambda gen: _qmm_cases(gen, False), "k2": _k2_cases,
         "k3": _k3_cases, "k4": lambda gen: _qmm_cases(gen, True),
         "k5": _k5_cases, "k6": _k6_cases, "k7": _k7_cases}
# the library call timed beside a kernel's cases, where they have one
LIBRARY = {"k2": "SDPA", "k5": "torch._int_mm"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(CASES), required=True)
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    card = chip_smoke.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows = []
    for name, kernel, library, iters in CASES[args.kernel](gen):
        warm = min(3, iters)
        row = {"case": name,
               "ms": chip_smoke.time_ms(kernel, iters, warm),
               "graph_ms": chip_smoke.graph_ms(kernel, min(iters, 20), warm),
               "host_ms": chip_smoke.host_ms(kernel)}
        note = ""
        if library is not None:
            row["library_ms"] = chip_smoke.time_ms(library, iters, warm)
            row["library_graph_ms"] = chip_smoke.graph_ms(library)
            note = (f"; {LIBRARY[args.kernel]} {row['library_ms']:.4f} ms, "
                    f"graph {row['library_graph_ms']:.4f} ms")
        rows.append(row)
        print(f"[timing] {args.label} {name}: back to back "
              f"{row['ms']:.4f} ms, replayed graph {row['graph_ms']:.4f} "
              f"ms, host {row['host_ms']:.4f} ms a call{note} [{card}]")
        del kernel, library
        torch.cuda.empty_cache()
    steps = {}
    for row in rows:
        if row["case"] in _STEP:
            model, count = _STEP[row["case"]]
            step = steps.setdefault(model, dict.fromkeys(
                ("ms", "graph_ms", "launches"), 0))
            for key in ("ms", "graph_ms", "library_ms", "library_graph_ms"):
                if key in row:
                    step[key] = step.get(key, 0) + count * row[key]
            step["launches"] += count
    for model, step in steps.items():
        lib = "" if "library_ms" not in step else (
            f"; {LIBRARY[args.kernel]} {step['library_ms']:.4f} ms, graph "
            f"{step['library_graph_ms']:.4f} ms")
        print(f"[timing] {args.label} {model}, "
              f"{step['launches']} launches: back to back {step['ms']:.4f} "
              f"ms, replayed graph {step['graph_ms']:.4f} ms{lib} [{card}]")
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "label": args.label, "src": str(args.src),
                      "cases": rows, "decode_steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
