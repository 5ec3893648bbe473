"""The one TrainState of the training path (DESIGN.md §9).

Counterpart of ``repro/train/state.py``, the same seven fields:

  params  model parameters (nested dicts of tensors, ``repro``'s layout)
  betas   learnable quantization ranges, keyed ``<site>.w`` / ``<site>.a``
  opt     ``optim.adam.AdamState`` over ``(params, betas)``
  cgmq    ``core.controller.CGMQState``: gates, lagged Sat flag, BOP at the
          last check, the last certified snapshot and its validity flag
  probes  zero-valued gradient taps (never updated)
  rng     the run's seed, an int64 tensor (``repro`` carries a PRNG key
          that drives epoch permutations; the LLM path reads neither)
  step    global step counter (int32 tensor)
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    params: Any
    betas: Any
    opt: Any
    cgmq: Any = None
    probes: Any = None
    rng: Any = None
    step: Any = None
