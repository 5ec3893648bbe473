"""Quantization sites and the ``QuantContext`` threaded through forwards.

Counterpart of ``repro/core/sites.py`` for the two modes serving needs:

  off    -- identity (full-precision serving).
  serve  -- deployment forward. Carries no gates: it runs off ``specs``
            (site -> ``quant.QuantSpec``, the frozen bits/range/sign) and
            ``qweights`` (site -> ``quant.QuantizedTensor``, the int-code
            export). Matmul sites with an export go through the fused-dequant
            GEMM (``models.layers.qmatmul`` asks ``serving_weight``);
            activations quantize at the spec's bits.

The collect, calibrate, train and export modes come with the training
slice. ``repro`` discovers sites with a collect-mode trace; the port lists
them from the config instead (``models.transformer.collect_sites``), and the
state initialisers below take that listing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from .quantizer import quantize

PER_TENSOR = "per_tensor"    # one gate per weight tensor / activation tensor
PER_CHANNEL = "per_channel"  # one gate per output channel
PER_WEIGHT = "per_weight"    # one gate per element


@dataclasses.dataclass(frozen=True)
class SiteInfo:
    """Static metadata for one matmul site (field for field ``repro``'s)."""

    name: str
    weight_shape: tuple[int, ...]   # one layer's weight shape
    fan_in: int                     # MACs contributed per output element
    out_features: int               # number of output channels
    positions: int                  # output positions per token
    stack: int                      # scan-stacked copies (leading gate dim)
    active_frac: float              # MoE: fraction of experts active
    act_quantized: bool             # False for fp outputs (head)
    w_signed: bool = True
    a_signed: bool = True


@dataclasses.dataclass
class QuantConfig:
    enabled: bool = True
    granularity: str = PER_TENSOR
    impl: str = "direct"
    input_bits: int = 8             # fixed input quantization (paper §4.2)
    quantize_acts: bool = True
    act_granularity: str | None = None   # defaults to `granularity`
    quantize_inputs: bool = False

    def __post_init__(self):
        if self.act_granularity is None:
            self.act_granularity = (
                PER_CHANNEL if self.granularity == PER_WEIGHT
                else self.granularity)
        if self.quantize_inputs:
            raise NotImplementedError(
                "quantize_inputs ('.in' activation sites) is ported with "
                "ROADMAP queue 1 item 9 (fully-integer GEMMs)")


def _group_shape(granularity: str, full_shape, out_features: int):
    if granularity == PER_TENSOR:
        return ()
    if granularity == PER_CHANNEL:
        return (out_features,)
    return tuple(full_shape)


class QuantContext:
    """Threaded through model forwards in mode ``"off"`` or ``"serve"``."""

    def __init__(self, mode: str = "off", cfg: QuantConfig | None = None,
                 qweights: dict[str, Any] | None = None,
                 specs: dict[str, Any] | None = None):
        if mode not in ("off", "serve"):
            raise NotImplementedError(
                f"QuantContext mode {mode!r} is ported with ROADMAP queue 1 "
                f"item 2 (CGMQ core); this slice has 'off' and 'serve'")
        self.mode = mode
        self.cfg = cfg or QuantConfig()
        self.qweights = qweights or {}
        self.specs = specs or {}
        self._prefix: list[str] = []
        # Per-layer child contexts of scan-stacked state, built on first use
        # by ``models.transformer`` and reused by every later forward.
        self.slices: dict[Any, "QuantContext"] = {}

    def child(self, qweights=None, specs=None) -> "QuantContext":
        """Sub-context for one layer of a stacked block, with per-layer
        slices of the serve state merged over this context's."""
        c = QuantContext(
            mode=self.mode, cfg=self.cfg,
            qweights={**self.qweights, **(qweights or {})},
            specs={**self.specs, **(specs or {})})
        c._prefix = list(self._prefix)
        return c

    @contextlib.contextmanager
    def scope(self, name: str):
        self._prefix.append(name)
        try:
            yield
        finally:
            self._prefix.pop()

    def _full(self, name: str) -> str:
        return "/".join(self._prefix + [name])

    # ---- quantization entry points -----------------------------------------
    def serving_weight(self, name: str):
        """Int-code export for this site, or None (serve mode only)."""
        if self.mode != "serve":
            return None
        return self.qweights.get(self._full(name) + ".w")

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "off" or not self.cfg.enabled:
            return w
        # serve mode reaches here only for sites without an int-code export
        # (``qmatmul`` takes the exported ones): fake-quant at the spec bits
        spec = self.specs[self._full(name) + ".w"]
        return quantize(w, spec.bits, spec.beta, spec.signed)

    def act(self, name: str, a: torch.Tensor) -> torch.Tensor:
        """Quantize an output activation at the site's spec bits."""
        if self.mode == "off" or not self.cfg.enabled \
                or not self.cfg.quantize_acts:
            return a
        spec = self.specs[self._full(name) + ".a"]
        return quantize(a, self._expand_act_gate(spec.bits, a),
                        self._expand_act_gate(spec.beta, a), spec.signed)

    def input_spec(self, name: str):
        """Activation spec for this matmul's INPUT, or None (serve only)."""
        if self.mode != "serve":
            return None
        return self.specs.get(self._full(name) + ".in")

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """Fixed-width input quantization (paper: 8-bit sensor data), with
        the range taken from the batch itself: ``beta = max|x|``."""
        if self.mode != "serve" or not self.cfg.enabled:
            return x
        beta = torch.clamp_min(x.detach().abs().max().to(torch.float32), 1e-8)
        return quantize(x, float(self.cfg.input_bits), beta, True)

    @staticmethod
    def _expand_act_gate(g, a: torch.Tensor):
        """Broadcast a group-shaped array against activation ``a``
        (feature-last)."""
        g = torch.as_tensor(g)
        if g.ndim == 0:
            return g
        return g.reshape((1,) * (a.ndim - g.ndim) + tuple(g.shape))


# ---------------------------------------------------------------------------
# State initialization from listed sites
# ---------------------------------------------------------------------------


def _stacked(shape: tuple[int, ...], stack: int) -> tuple[int, ...]:
    return ((stack,) + tuple(shape)) if stack > 1 else tuple(shape)


def init_gates(sites: dict[str, SiteInfo], cfg: QuantConfig, init: float,
               device) -> dict[str, torch.Tensor]:
    """Gate dict: one tensor per weight site and per quantized activation."""
    out = {}
    for s in sites.values():
        wshape = _group_shape(cfg.granularity, s.weight_shape, s.out_features)
        out[s.name + ".w"] = torch.full(_stacked(wshape, s.stack), init,
                                        dtype=torch.float32, device=device)
        if s.act_quantized:
            ashape = _group_shape(cfg.act_granularity, (s.out_features,),
                                  s.out_features)
            out[s.name + ".a"] = torch.full(_stacked(ashape, s.stack), init,
                                            dtype=torch.float32,
                                            device=device)
    return out


def init_ranges_from_weights(sites: dict[str, SiteInfo], cfg: QuantConfig,
                             weight_lookup, device) -> dict[str, Any]:
    """Weight ranges from min/max (paper §2.4); ``weight_lookup(name)``
    returns the (stacked) weight or None. Activation ranges are
    placeholders (beta=1) until calibration runs."""
    ranges: dict[str, Any] = {}
    for s in sites.values():
        w = weight_lookup(s.name)
        if w is None:
            beta = torch.ones(_stacked((), s.stack), dtype=torch.float32,
                              device=device)
            signed = True
        else:
            if cfg.granularity == PER_CHANNEL:
                red = tuple(range(w.ndim - 1)) if s.stack == 1 else tuple(
                    range(1, w.ndim - 1))
                beta = torch.amax(w.abs(), dim=red)
                all_pos = bool((torch.amin(w, dim=red) >= 0).all())
            elif cfg.granularity == PER_WEIGHT:
                beta = w.abs() + 1e-8
                all_pos = bool((w >= 0).all())
            else:
                if s.stack > 1:
                    beta = torch.amax(w.abs(), dim=tuple(range(1, w.ndim)))
                else:
                    beta = w.abs().max()
                all_pos = bool((w >= 0).all())
            signed = not all_pos
        ranges[s.name + ".w"] = {"beta": beta.to(torch.float32),
                                 "signed": signed}
        if s.act_quantized:
            ashape = _group_shape(cfg.act_granularity, (s.out_features,),
                                  s.out_features)
            ranges[s.name + ".a"] = {
                "beta": torch.ones(_stacked(ashape, s.stack),
                                   dtype=torch.float32, device=device),
                "signed": True,
            }
    return ranges


def split_learnable_ranges(ranges: dict[str, Any]):
    """Split into (betas dict, static signed map)."""
    betas = {k: v["beta"] for k, v in ranges.items()}
    signed = {k: bool(v["signed"]) for k, v in ranges.items()}
    return betas, signed
