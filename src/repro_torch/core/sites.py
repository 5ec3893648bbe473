"""Quantization sites and the ``QuantContext`` threaded through forwards.

Counterpart of ``repro/core/sites.py`` in four of its modes:

  off        -- identity (fp32 warmup, full-precision serving).
  calibrate  -- fp32 forward that records each output activation's range
                statistics (max, per-channel max, min, mean |a|) in
                ``act_stats`` (``core.calibration`` runs it), and with
                ``QuantConfig(quantize_inputs=True)`` each matmul input's
                per-tensor max, min and mean |x| (the ``.in`` sites).
  train      -- fake quantization from gates and learnable ranges, through
                ``gates.gated_fake_quant`` (K3 on the card) or the
                paper-literal residual chain (``impl="residual"``); records
                the per-site statistics the CGMQ directions need
                (``weight_stats``: group-mean |w|; ``act_stats``: |mean a|,
                kept in a's dtype) and adds the zero "probe" parameters
                whose gradients are the group-summed operand gradients.
  serve      -- deployment forward. Carries no gates: it runs off ``specs``
                (site -> ``quant.QuantSpec``, the frozen bits/range/sign) and
                ``qweights`` (site -> ``quant.QuantizedTensor``, the int-code
                export). Matmul sites with an export go through the fused-
                dequant GEMM (``models.layers.qmatmul`` asks
                ``serving_weight``); activations quantize at the spec's bits.

``repro`` discovers sites with a collect-mode trace and captures export
weights with an export-mode one; the port lists both from the config
(``models.transformer.collect_sites`` / ``site_weights``), and the state
initialisers below take that listing. Stacked per-layer state is sliced
into child contexts by ``models.transformer``; a child's stats come back
stacked to ``(R, ...)`` under ``repro``'s keys.

The probe trick: ``a + probe`` with ``probe = 0`` of the gate-group shape
makes ``dL/dprobe`` the group-summed ``dL/da``. A probe that the forward
never reaches (the ``.a`` probes of attn_q/k/v and mlp_gate, whose outputs
are not fake-quantized, as in ``repro``) gets no gradient; the directions
take that as zero, which is what ``repro``'s zero gradient is.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from . import gates as G
from .quantizer import fake_quant, quantize

PER_TENSOR = "per_tensor"    # one gate per weight tensor / activation tensor
PER_CHANNEL = "per_channel"  # one gate per output channel
PER_WEIGHT = "per_weight"    # one gate per element

MODES = ("off", "calibrate", "train", "serve")


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

    @property
    def macs_per_token(self) -> float:
        """MACs per token for ONE stacked copy of this site."""
        return float(self.fan_in) * self.out_features * self.positions \
            * self.active_frac


@dataclasses.dataclass
class QuantConfig:
    enabled: bool = True
    granularity: str = PER_TENSOR
    impl: str = "direct"            # 'direct' (telescoped) | 'residual'
    input_bits: int = 8             # fixed input quantization (paper §4.2)
    quantize_acts: bool = True
    act_granularity: str | None = None   # defaults to `granularity`
    # Gate the matmul INPUT activations too (".in" sites, DESIGN.md §16):
    # per-tensor affine, so the certificate covers w_bits x a_bits x MACs
    # and serving can run integer GEMMs. Off by default.
    quantize_inputs: bool = False

    def __post_init__(self):
        if self.act_granularity is None:
            self.act_granularity = (
                PER_CHANNEL if self.granularity == PER_WEIGHT
                else self.granularity)


def _group_shape(granularity: str, full_shape, out_features: int):
    if granularity == PER_TENSOR:
        return ()
    if granularity == PER_CHANNEL:
        return (out_features,)
    return tuple(full_shape)


class QuantContext:
    """Threaded through model forwards in one of ``MODES``."""

    def __init__(self, mode: str = "off", cfg: QuantConfig | None = None,
                 qweights: dict[str, Any] | None = None,
                 specs: dict[str, Any] | None = None, *,
                 gates: dict[str, torch.Tensor] | None = None,
                 ranges: dict[str, Any] | None = None,
                 probes: dict[str, torch.Tensor] | None = None):
        if mode not in MODES:
            raise NotImplementedError(
                f"QuantContext mode {mode!r} has no port: sites are listed "
                f"from the config (models.transformer.collect_sites) and "
                f"export weights taken by transformer.site_weights")
        self.mode = mode
        self.cfg = cfg or QuantConfig()
        self.qweights = qweights or {}
        self.specs = specs or {}
        self.gates = gates or {}
        self.ranges = ranges or {}
        self.probes = probes or {}
        # outputs of a calibrate or train forward
        self.act_stats: dict[str, dict[str, torch.Tensor]] = {}
        self.weight_stats: dict[str, torch.Tensor] = {}
        self._prefix: list[str] = []
        # Per-layer child contexts of scan-stacked serve state, built on
        # first use by ``models.transformer`` and reused by later forwards.
        self.slices: dict[Any, "QuantContext"] = {}
        # Serve mode: site -> folded integer-GEMM constants (or None),
        # built on first use by ``int_gemm_plan``.
        self.plans: dict[str, Any] = {}

    def child(self, qweights=None, specs=None, gates=None, ranges=None,
              probes=None) -> "QuantContext":
        """Sub-context for one layer of a stacked block, with per-layer
        slices of the state merged over this context's."""
        c = QuantContext(
            mode=self.mode, cfg=self.cfg,
            qweights={**self.qweights, **(qweights or {})},
            specs={**self.specs, **(specs or {})},
            gates={**self.gates, **(gates or {})},
            ranges={**self.ranges, **(ranges or {})},
            probes={**self.probes, **(probes or {})})
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
        if self.mode in ("off", "calibrate") or not self.cfg.enabled:
            return w
        key = self._full(name) + ".w"
        if self.mode == "serve":
            # reached only for sites without an int-code export (``qmatmul``
            # takes the exported ones): fake-quant at the spec bits
            spec = self.specs[key]
            return quantize(w, spec.bits, spec.beta, spec.signed)
        g = self.gates[key]
        rng = self.ranges[key]
        # group-reduced |w| for dir_2/dir_3 (paper §2.3)
        self.weight_stats[key] = self._w_group_stat(w, g)
        if key in self.probes:
            # the probe's gradient is the group-summed dL/dw through the STE
            w = w + self._expand_w_probe(self.probes[key], w).to(w.dtype)
        return self._fq(w, g, rng["beta"], rng["signed"])

    def act(self, name: str, a: torch.Tensor) -> torch.Tensor:
        """Quantize an output activation; records stats per mode."""
        if self.mode == "off" or not self.cfg.enabled \
                or not self.cfg.quantize_acts:
            return a
        key = self._full(name) + ".a"
        if self.mode == "serve":
            spec = self.specs[key]
            return quantize(a, self._expand_act_gate(spec.bits, a),
                            self._expand_act_gate(spec.beta, a), spec.signed)
        if self.mode == "calibrate":
            red = tuple(range(a.ndim - 1))
            self.act_stats[key] = {
                "max": torch.amax(torch.abs(a)),
                "max_per_ch": torch.amax(torch.abs(a), dim=red),
                "min": torch.amin(a),
                "mean_abs": torch.mean(torch.abs(a)),
            }
            return a
        g = self.gates[key]
        rng = self.ranges[key]
        # |mean over batch of a|, reduced to the gate-group shape
        self.act_stats[key] = {"mean_abs": self._act_group_stat(a, g)}
        if key in self.probes:
            # broadcast, then cast: the probe's gradient is an fp32 sum of
            # the bf16 activation gradients, as in repro
            a = a + self.probes[key].expand(a.shape).to(a.dtype)
        return self._fq(a, self._expand_act_gate(g, a),
                        self._expand_act_gate(rng["beta"], a), rng["signed"])

    def input_spec(self, name: str):
        """Activation spec for this matmul's INPUT, or None (serve only)."""
        if self.mode != "serve":
            return None
        return self.specs.get(self._full(name) + ".in")

    def int_gemm_plan(self, name: str):
        """The integer GEMM of a serve-mode site with an int-code export
        and an ``.in`` spec (``kernels.quant_matmul.ops.IntGemmPlan``), or
        None. Built at the first call and kept on this context, so the
        constants that depend only on the frozen weight and spec are
        folded once per site and layer, not once per forward."""
        if self.mode != "serve":
            return None
        full = self._full(name)
        if full not in self.plans:
            from repro_torch.kernels.quant_matmul.ops import int_gemm_plan

            qt = self.qweights.get(full + ".w")
            spec = self.specs.get(full + ".in")
            self.plans[full] = None if qt is None or spec is None \
                else int_gemm_plan(qt, spec)
        return self.plans[full]

    def act_in(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Quantize a matmul INPUT activation (the ``.in`` site, §16).

        Per-tensor affine, gated like any other site. Serve mode reaches
        this only for sites without an int-code export (``qmatmul`` runs
        the integer GEMM for the others) and quantizes at the spec, if the
        site has one; train mode fake-quantizes through the gate (K3 on the
        card), with its statistic and probe; calibrate mode records the
        per-tensor range statistics.
        """
        key = self._full(name) + ".in"
        if not self.cfg.enabled:
            return x
        if self.mode == "serve":
            spec = self.specs.get(key)
            if spec is None:
                return x
            return quantize(x, spec.bits, spec.beta, spec.signed)
        if self.mode == "off" or not self.cfg.quantize_inputs:
            return x
        if self.mode == "calibrate":
            self.act_stats[key] = {
                "max": torch.amax(torch.abs(x)),
                "min": torch.amin(x),
                "mean_abs": torch.mean(torch.abs(x)),
            }
            return x
        # train mode; a state trained before ``.in`` gates existed has none
        g = self.gates.get(key)
        if g is None:
            return x
        rng = self.ranges[key]
        self.act_stats[key] = {"mean_abs": self._act_group_stat(x, g)}
        if key in self.probes:
            x = x + self.probes[key].expand(x.shape).to(x.dtype)
        return self._fq(x, self._expand_act_gate(g, x),
                        self._expand_act_gate(rng["beta"], x), rng["signed"])

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """Fixed-width input quantization (paper: 8-bit sensor data), with
        the range taken from the batch itself: ``beta = max|x|``."""
        if self.mode not in ("train", "serve") or not self.cfg.enabled:
            return x
        beta = torch.clamp_min(x.detach().abs().max().to(torch.float32), 1e-8)
        return fake_quant(x, float(self.cfg.input_bits), beta, True)

    # ---- helpers ------------------------------------------------------------
    def _fq(self, x, g, beta, signed):
        if self.cfg.impl == "residual":
            return G.residual_fake_quant(x, g, beta, signed)
        return G.gated_fake_quant(x, g, beta, signed)

    @staticmethod
    def _expand_act_gate(g, a: torch.Tensor):
        """Broadcast a group-shaped array against activation ``a``
        (feature-last)."""
        g = torch.as_tensor(g)
        if g.ndim == 0:
            return g
        return g.reshape((1,) * (a.ndim - g.ndim) + tuple(g.shape))

    @staticmethod
    def _act_group_stat(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """|mean over batch (and non-group dims) of a|, shaped like the
        gate, in a's dtype."""
        a = a.detach()
        if g.ndim == 0:
            return torch.abs(torch.mean(a))
        return torch.abs(torch.mean(a, dim=tuple(range(a.ndim - g.ndim))))

    @staticmethod
    def _w_group_stat(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Group-reduced |w| (mean within group), shaped like the gate."""
        w = w.detach()
        if g.ndim == 0:
            return torch.mean(torch.abs(w))
        if g.shape == w.shape:
            return torch.abs(w)
        # per-channel (last axis): reduce every axis that does not line up
        # with the trailing gate shape
        extra = w.ndim - g.ndim
        red = tuple(i for i in range(w.ndim) if not (
            i >= extra and w.shape[i] == g.shape[i - extra]))
        return torch.mean(torch.abs(w), dim=red)

    @staticmethod
    def _expand_w_probe(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Broadcast a probe of group shape against weight ``w`` (trailing
        dims aligned, channel-last)."""
        if p.ndim == 0 or p.shape == w.shape:
            return p
        return p.reshape((1,) * (w.ndim - p.ndim) + tuple(p.shape))


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
        if cfg.quantize_inputs and s.act_quantized:
            # ``.in`` sites are per-tensor by contract: the integer GEMM
            # quantizes the whole input against ONE affine grid (§16)
            out[s.name + ".in"] = torch.full(_stacked((), s.stack), init,
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
        if cfg.quantize_inputs and s.act_quantized:
            ranges[s.name + ".in"] = {
                "beta": torch.ones(_stacked((), s.stack),
                                   dtype=torch.float32, device=device),
                "signed": True,
            }
    return ranges


def init_probes(sites: dict[str, SiteInfo], cfg: QuantConfig,
                device) -> dict[str, torch.Tensor]:
    """Zero probe params added to quantized activations (gradient taps)."""
    out = {}
    for s in sites.values():
        if s.act_quantized:
            ashape = _group_shape(cfg.act_granularity, (s.out_features,),
                                  s.out_features)
            out[s.name + ".a"] = torch.zeros(_stacked(ashape, s.stack),
                                             dtype=torch.float32,
                                             device=device)
        if cfg.quantize_inputs and s.act_quantized:
            out[s.name + ".in"] = torch.zeros(_stacked((), s.stack),
                                              dtype=torch.float32,
                                              device=device)
    return out


def split_learnable_ranges(ranges: dict[str, Any]):
    """Split into (betas dict, static signed map)."""
    betas = {k: v["beta"] for k, v in ranges.items()}
    signed = {k: bool(v["signed"]) for k, v in ranges.items()}
    return betas, signed


def merge_ranges(betas: dict[str, torch.Tensor], signed: dict[str, bool]):
    return {k: {"beta": betas[k], "signed": signed[k]} for k in betas}


def total_gate_count(gts: dict[str, torch.Tensor]) -> int:
    return int(sum(v.numel() for v in gts.values()))
