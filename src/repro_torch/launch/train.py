"""Training launcher: CGMQ steps of one arch on synthetic LM tokens.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch tinyllama-1.1b-smoke --steps 3 --device cpu

Mirrors ``repro/launch/train.py`` without the mesh, the supervisor and
checkpoints: the recipe's defaults with ``check_every = max(10, steps //
10)``, random weights from seed 0, batches drawn from ``lm_tokens(2048,
seq, vocab, seed=0, noise=0.05)`` with ``default_rng(step)``, and one line
of loss, RBOP and the Sat flag every 10 steps and at the last. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.synthetic import lm_tokens
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--budget-rbop", type=float, default=0.0625)
    ap.add_argument("--direction", default="dir2")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    recipe = steps_lib.make_recipe(cfg, shape, direction=args.direction,
                                   budget_rbop=args.budget_rbop,
                                   check_every=max(10, args.steps // 10))
    state = steps_lib.init_train_state(recipe, 0, device=dev)
    step_fn = steps_lib.make_train_step(recipe)
    data = lm_tokens(2048, args.seq, cfg.vocab_size, seed=0, noise=0.05)

    for step in range(args.steps):
        idx = np.random.default_rng(step).integers(0, data.shape[0],
                                                   args.batch)
        chunk = torch.from_numpy(data[idx]).to(dev)
        state, m = step_fn(state, {"tokens": chunk[:, :-1],
                                   "targets": chunk[:, 1:]})
        done = step + 1
        if done % 10 == 0 or done == args.steps:
            print(f"step {done} loss {float(m['loss']):.4f} "
                  f"rbop {float(m['rbop']) * 100:.2f}% "
                  f"sat={bool(m['sat'])}")
    print(f"done at step {args.steps}")
    return state


if __name__ == "__main__":
    main()
