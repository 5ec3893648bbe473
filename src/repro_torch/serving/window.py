"""Attention windows for long-context serving (DESIGN.md §17).

Counterpart of ``repro/serving/window.py``. A ``WindowSpec`` bounds how
much KV history a request's attention may read: a sliding window of the
last ``window`` token positions, plus an optional block-aligned "sink"
prefix (the first ``sink_blocks`` paged blocks) that is always attended and
never evicted. The live set of a slot at position ``p`` is

    blocks [0, sink_blocks)  U  blocks [first_live_block(p), p // bs]

and every other block is dead: no current or future query attends a
position inside it, so the engine's in-tick eviction
(``kv_pool.evict_out_of_window``) releases it. The mask rule, shared by
the dense prefill, the paged decode kernel (K2c) and its plain version:

    key position kp is valid for query position qp  iff
        kp <= qp  AND  (qp - kp < window  OR  kp < sink_blocks * bs)

Local layers tighten their architectural window to ``min(cfg.window,
window)`` and take no sinks; global layers take ``(window, sink_tokens)``
verbatim (``layer_mask``). Attention forwards receive the resolved
``(window, sink_tokens)`` tuple, not the spec.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Sliding-window + sink-block attention pattern for one engine.

    ``window``: how many trailing token positions stay attendable (>= 1).
    ``sink_blocks``: leading paged blocks pinned forever, attended by every
    query of a full-history layer and exempt from eviction. ``block_size``
    is bound by the engine (``bind``); it converts ``sink_blocks`` to token
    units and is required by ``sink_tokens``/``mask``/``live_blocks``.
    """

    window: int
    sink_blocks: int = 0
    block_size: int | None = None

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1: {self.window}")
        if self.sink_blocks < 0:
            raise ValueError(
                f"sink_blocks must be >= 0: {self.sink_blocks}")
        if self.block_size is not None and self.block_size < 1:
            raise ValueError(f"block_size must be >= 1: {self.block_size}")

    def bind(self, block_size: int) -> "WindowSpec":
        """The engine-resolved spec: sink units fixed to its block size."""
        return dataclasses.replace(self, block_size=int(block_size))

    @property
    def sink_tokens(self) -> int:
        if self.block_size is None:
            raise ValueError("WindowSpec is unbound; call bind(block_size)")
        return self.sink_blocks * self.block_size

    @property
    def mask(self) -> tuple[int, int]:
        """The ``(window, sink_tokens)`` tuple attention forwards take."""
        return (self.window, self.sink_tokens)

    def live_blocks(self, max_blocks: int) -> int:
        """Worst-case resident blocks per slot under eviction: the sinks
        plus the window span, which straddles one extra partly live block
        whenever the window boundary falls inside a block."""
        if self.block_size is None:
            raise ValueError("WindowSpec is unbound; call bind(block_size)")
        span = -(-self.window // self.block_size) + 1
        return min(max_blocks, self.sink_blocks + span)


def as_window_spec(window, block_size: int | None = None):
    """Coerce the engine's ``attention_window``: ``None`` (off), an int
    (sliding window, no sinks) or a ``WindowSpec``; bound to
    ``block_size`` when given."""
    if window is None:
        return None
    spec = window if isinstance(window, WindowSpec) \
        else WindowSpec(window=int(window))
    return spec.bind(block_size) if block_size is not None else spec


def first_live_block(pos, window: int, sink_blocks: int, block_size: int):
    """First logical block the sliding window still reaches at query
    position ``pos`` (an int tensor or a Python int). Block ``j`` is dead
    iff its last key position ``(j+1)*bs - 1 <= pos - window``; the floor
    division below solves that for ``j`` (it floors negatives, as
    ``repro``'s ``//`` does), clamped so the sink prefix is never dead."""
    if isinstance(pos, torch.Tensor):
        fl = torch.div(pos - window + 1, block_size, rounding_mode="floor")
        return torch.clamp(fl, min=sink_blocks)
    return max((int(pos) - window + 1) // block_size, sink_blocks)


def window_demand_blocks(spec: WindowSpec | None, max_blocks: int,
                         chunk_tokens: int | None,
                         block_size: int) -> int:
    """Worst-case pool blocks one slot can hold at any instant.

    Without a window, or without chunked prefill (which allocates the
    whole prompt before eviction can run), the bound is the full table
    width. With both, residency peaks between chunk evictions: the live
    set plus one chunk's worth of freshly written blocks."""
    if spec is None or chunk_tokens is None:
        return max_blocks
    chunk_blk = -(-chunk_tokens // block_size) + 1
    return min(max_blocks, spec.live_blocks(max_blocks) + chunk_blk)


def layer_mask(window: tuple[int, int] | None, kind: str,
               cfg_window: int | None):
    """The ``(window, sink_tokens)`` of one attention layer: local layers
    tighten their architectural window and take no sinks, global layers
    take the engine tuple verbatim; ``window=None`` means unmasked."""
    if window is None:
        return (cfg_window if kind == "local" else None, 0)
    w, sink = window
    if kind == "local":
        return (min(cfg_window, w), 0)
    return (w, sink)


def sink_block_count(sink_tokens: int, block_size: int) -> int:
    return -(-sink_tokens // block_size)


def window_report(spec: WindowSpec | None, max_blocks: int,
                  block_size: int) -> dict:
    """JSON-able summary of the engine's window."""
    if spec is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "window": spec.window,
        "sink_blocks": spec.sink_blocks,
        "block_size": block_size,
        "live_blocks_per_slot": spec.live_blocks(max_blocks),
        "table_blocks_per_slot": max_blocks,
        "residency_ratio":
            spec.live_blocks(max_blocks) / max(max_blocks, 1),
    }


def max_live_blocks(window: int, sink_blocks: int, block_size: int) -> int:
    """Most table entries a live slot holds after an in-tick eviction:
    sinks plus the window span, including the one partly live boundary
    block."""
    return sink_blocks + math.ceil(window / block_size) + 1
