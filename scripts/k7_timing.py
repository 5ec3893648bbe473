"""Time K7 (whole-prompt flash attention) of one checkout on one card.

    python3 scripts/k7_timing.py [--src DIR] [--label NAME]

At each of ``chip_smoke.py``'s K7 cases, with the inputs made as there,
it launches the ``flash_attention`` wrapper of the ``repro_torch`` found
in ``--src`` (default: this checkout's ``src``) and prints three times a
call: back to back from Python (``chip_smoke.time_ms``, the host's work
counts where it exceeds the device's), the device time alone (a replayed
CUDA graph, ``chip_smoke.graph_ms``) and the host's wall time
(``chip_smoke.host_ms``). Point ``--src`` at the ``src`` of another commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists,
and run it in one call beside this checkout's, to compare two versions of
K7 on the same card by the same methods. Correctness is ``chip_smoke.py``'s
to check, not this script's. The last line is one JSON object: the card,
the label and each case's times.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on sys.path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k7_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention

    card = chip_smoke.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows = []
    for name, b, hq, hkv, hd, s, dtype, window, sinks, cap in \
            chip_smoke.K7_CASES:
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .to(getattr(torch, dtype)).transpose(1, 2)
                   for h in (hq, hkv, hkv))
        kw = {"causal": True, "window": window, "sinks": sinks,
              "softcap": cap}

        def kernel():
            return flash_attention(q, k, v, **kw)

        row = {"case": name,
               "ms": chip_smoke.time_ms(kernel, iters=10, warmup=2),
               "graph_ms": chip_smoke.graph_ms(kernel, iters=10, warmup=2),
               "host_ms": chip_smoke.host_ms(kernel)}
        rows.append(row)
        print(f"[k7-timing] {args.label} {name}: back to back "
              f"{row['ms']:.4f} ms, replayed graph {row['graph_ms']:.4f} "
              f"ms, host {row['host_ms']:.4f} ms a call [{card}]")
    print(json.dumps({"card": card, "label": args.label, "src":
                      str(args.src), "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
