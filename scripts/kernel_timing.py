"""Time one hand-written kernel of one checkout on one card.

    python3 scripts/kernel_timing.py --kernel k2|k7 [--src DIR] [--label NAME]

``k2`` (paged decode attention): K2a, K2b over an int4 pool and K2c under
window 256 with 16 sink tokens at tinyllama's decode shapes, and at
[serve-gemma2]'s decode shape with two long rows K2a with softcap 50 and
without, K2c under window 4096 with softcap 50; each over copies of its
pools taken in turn, so that each call reads its K/V from HBM, with SDPA
beside it (``chip_smoke.sdpa_yardstick``, the same rows gathered, no
softcap). ``k7`` (whole-prompt flash attention): each of ``chip_smoke``'s
K7 cases, warm L2.

The inputs are made as ``chip_smoke.py`` makes them; the wrappers called
are those of the ``repro_torch`` found in ``--src`` (default: this
checkout's ``src``). Each case prints three times a call: back to back
from Python (``chip_smoke.time_ms``; the host's work counts where it
exceeds the device's), the device time alone (a replayed CUDA graph,
``chip_smoke.graph_ms``) and the host's wall time (``chip_smoke.host_ms``),
and SDPA's by the first two methods where the case has it. Point ``--src``
at the ``src`` of another commit unpacked by ``git archive`` into a
directory that ``.gitignore`` lists, and run it in one call beside this
checkout's, to compare two versions of a kernel on the same card by the
same methods. Correctness is ``chip_smoke.py``'s to check, not this
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


CASES = {"k2": _k2_cases, "k7": _k7_cases}


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
    for name, kernel, sdpa, iters in CASES[args.kernel](gen):
        warm = min(3, iters)
        row = {"case": name,
               "ms": chip_smoke.time_ms(kernel, iters, warm),
               "graph_ms": chip_smoke.graph_ms(kernel, min(iters, 20), warm),
               "host_ms": chip_smoke.host_ms(kernel)}
        note = ""
        if sdpa is not None:
            row["library_ms"] = chip_smoke.time_ms(sdpa, iters, warm)
            row["library_graph_ms"] = chip_smoke.graph_ms(sdpa)
            note = (f"; SDPA {row['library_ms']:.4f} ms, graph "
                    f"{row['library_graph_ms']:.4f} ms")
        rows.append(row)
        print(f"[timing] {args.label} {name}: back to back "
              f"{row['ms']:.4f} ms, replayed graph {row['graph_ms']:.4f} "
              f"ms, host {row['host_ms']:.4f} ms a call{note} [{card}]")
        del kernel, sdpa
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "label": args.label, "src": str(args.src),
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
