"""Request sampling parameters (greedy only) and the non-finite guard.

Counterpart of ``repro/serving/sampling.py`` reduced to greedy decoding:
``temperature=0`` is the only value this slice serves. Greedy argmax takes
the first index among equal maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs. ``stop``: token ids that end the
    request early (the stop token is emitted); ``max_new`` counts every
    emitted token, stop included."""

    temperature: float = 0.0
    stop: tuple = ()
    max_new: int = 16

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.temperature > 0:
            raise NotImplementedError(
                "sampling with temperature > 0 is ported with ROADMAP queue 1"
                " item 10 (request lifecycle); this slice serves greedy only")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1: {self.max_new}")
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))
        if any(t < 0 for t in self.stop):
            raise ValueError(f"stop token ids must be >= 0: {self.stop}")


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """Per-row guard: True where every logit in the row is finite."""
    return torch.isfinite(logits).all(dim=-1)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int64 argmax, first index on ties."""
    return torch.argmax(logits, dim=-1)
