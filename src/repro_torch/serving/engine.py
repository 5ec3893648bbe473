"""Batched serving engine over the CGMQ-quantized model (paged, greedy).

Counterpart of ``repro/serving/engine.py``, reduced to this slice:

  * ``export_int_model`` freezes (params, quant_state) into
    ``QuantizedTensor``s per site at their 2/4/8-bit storage class (2- and
    4-bit codes packed along K). ``make_uniform_quant_state`` is the uniform
    stand-in state (gate 2.2, i.e. 8 bits, per channel);
    ``make_mixed_quant_state`` the mixed 2/4/8-bit one.
  * ``ServingEngine`` keeps slots over a paged KV pool -- bf16/fp32, or
    int8/int4 codes with fp16 group scales (``kv_dtype``) -- with a
    device-side block allocator. Wave admission: each free slot takes the
    next waiting request and prefills its whole (bucket-padded) prompt in
    one forward (``tfm.prefill_slot``); then every tick runs ``tick_alloc``,
    one ``decode_step`` for all slots and the greedy pick on the device, and
    fetches the tick's results in exactly ONE host transfer (``_sync``,
    counted in ``stats["tick_syncs"]``).
  * ``act_bits`` (DESIGN.md §16) serves fully-integer GEMMs: a few seeded
    batches calibrate a per-tensor ``ActQuantSpec`` for every matmul input
    (``make_act_specs``), and each site with an int-code export then
    quantizes its input and runs an int8 x int8 GEMM summed in int32 (K5
    for 8-bit codes, K6 for packed 2/4-bit ones on the card);
    ``quant_report`` certifies the BOPs at the served weight and
    activation widths.
  * ``attention_window`` (an int or a ``window.WindowSpec``, DESIGN.md §17)
    serves long prompts under a sliding window with pinned sink blocks:
    prefill and decode mask to it (decode through K2c on the card), and
    every tick first releases, on the device and inside the tick's one
    sync, the blocks the window no longer reaches
    (``kv_pool.evict_out_of_window``), so a slot holds O(window) blocks.

Models: the dense global decoder (``tinyllama-1.1b``) with every option
above, and ``gemma2-2b``'s local/global layers (uniform or float weights
over a bf16 pool, with or without a window; other pools, a mixed 2/4-bit
artifact and ``act_bits`` there raise, naming item 14). On the card every
prefill's attention runs K7.

Not ported yet, each rejected with ``NotImplementedError`` naming its
ROADMAP item: the ring layout, chunked prefill (so also between-chunk
eviction), undersized pools, sampling with temperature. Prefix sharing,
preemption, admission control and deadlines are absent.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import calibrate_activations
from repro_torch.core.sites import (QuantConfig, QuantContext, init_gates,
                                    init_ranges_from_weights,
                                    split_learnable_ranges)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.quant import (ActQuantSpec, export_act_sites, export_sites,
                               quant_report, specs_from_state)
from repro_torch.quant.kv import KVQuantSpec, kv_cache_report
from repro_torch.serving import kv_pool
from repro_torch.serving.window import (WindowSpec, as_window_spec,
                                        first_live_block, window_report)
from repro_torch.serving.sampling import (SamplingParams, finite_rows,
                                          greedy_tokens)

FINISHED_STOP = "stop"
FINISHED_LENGTH = "length"
FINISHED_ERROR = "error"


def _check_params_device(params, dev: torch.device):
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"params live on {have}, the call asked for {dev}")


# ---------------------------------------------------------------------------
# Int-code export
# ---------------------------------------------------------------------------


def export_int_model(params, cfg: ModelConfig, quant_state: dict, *,
                     pack: bool = True, warn: bool = True, device=None):
    """Full-model quantized export for the serving GEMMs.

    Takes every site's (stacked) weight from ``tfm.site_weights`` and
    freezes it at its per-layer, per-channel bits through
    ``quant.export_sites``, in its 2/4/8-bit storage class (``pack=False``
    keeps the unpacked int8 oracle layout). Returns ``(qweights, ledger)``:
    "<site>.w" -> ``QuantizedTensor`` and the ``ExportLedger`` of every
    site.
    """
    _check_params_device(params, resolve_device(device))
    return export_sites(tfm.site_weights(params, cfg), tfm.collect_sites(cfg),
                        quant_state["gates"], quant_state["betas"],
                        quant_state["signed"], pack=pack, warn=warn)


def make_uniform_quant_state(cfg: ModelConfig, params, *, gate_init=2.2,
                             granularity="per_channel", device=None):
    """A stand-in trained CGMQ state with one uniform gate everywhere
    (default T(2.2) = 8 bits), as ``repro``'s; not a trained state."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    qcfg = QuantConfig(granularity=granularity)
    sites = tfm.collect_sites(cfg)
    gates = init_gates(sites, qcfg, gate_init, dev)
    betas, signed = split_learnable_ranges(
        init_ranges_from_weights(sites, qcfg, lambda n: None, dev))
    return {"qcfg": qcfg, "gates": gates, "betas": betas, "signed": signed}


# Gate values landing exactly on T(g) = 2 / 4 / 8 bits (core.gates Eq. 4).
MIXED_GATE_LEVELS = (0.8, 1.5, 2.5)


def make_mixed_quant_state(cfg: ModelConfig, params, *, device=None):
    """A stand-in trained CGMQ state with MIXED 2/4/8-bit weight sites, as
    ``repro``'s: per-channel weight gates cycle through
    ``MIXED_GATE_LEVELS`` site by site in sorted key order, activations
    stay 8-bit. Not a trained state: the workload of the packed sub-byte
    serving path."""
    qs = make_uniform_quant_state(cfg, params, gate_init=2.5, device=device)
    gates = {}
    wi = 0
    for key in sorted(qs["gates"]):     # repro's key order, too
        g = qs["gates"][key]
        if key.endswith(".w"):
            g = torch.full_like(
                g, MIXED_GATE_LEVELS[wi % len(MIXED_GATE_LEVELS)])
            wi += 1
        gates[key] = g
    qs["gates"] = gates
    return qs


# bits -> the gate value whose T(g) is exactly that width; folds served
# activation widths back into the BOP certificate (DESIGN.md §16).
ACT_GATE_LEVELS = {2: 0.8, 4: 1.5, 8: 2.5}


def make_act_specs(cfg: ModelConfig, params, act_bits: int, *,
                   batches: int = 2, seq: int = 16, seed: int = 0) -> dict:
    """Calibrate per-tensor ``.in`` activation specs for serving (§16).

    Runs ``repro``'s seeded random batches (``default_rng(seed)``,
    ``batches`` of (1, ``seq``) tokens) through a calibrate-mode
    ``forward_train`` with ``QuantConfig(quantize_inputs=True)``, takes the
    running ranges of ``core.calibration.calibrate_activations``, and
    freezes every matmul input into an ``ActQuantSpec`` at ``act_bits``
    (stacked sites with a leading layer axis on ``beta``). Runs where the
    params live. Returns {"<site>.in": ActQuantSpec}.
    """
    qcfg = QuantConfig(quantize_inputs=True)
    rng = np.random.default_rng(seed)
    dev = params["embed"].device
    data = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq)))
            .to(dev) for _ in range(batches)]

    def fwd(qc, batch):
        tfm.forward_train(qc, params, batch, cfg)

    act_ranges = calibrate_activations(fwd, data, qcfg)
    return {key: ActQuantSpec(bits=int(act_bits),
                              beta=v["beta"].to(torch.float32),
                              signed=bool(v["signed"]))
            for key, v in act_ranges.items() if key.endswith(".in")}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _raise_on_layered(layered: bool, options: dict, cfg: ModelConfig):
    """Raise for an engine option that no test yet holds to repro on a
    layer pattern other than ("global",)."""
    hit = [name for name, on in options.items() if on]
    if layered and hit:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(hit)} over block_pattern="
            f"{cfg.block_pattern} is ported with ROADMAP queue 1 item 14 "
            f"(other block kinds and archs)")


@dataclasses.dataclass
class Request:
    """One unit of the serving lifecycle: waiting -> slot -> finished."""

    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    done: bool = False
    output: list = dataclasses.field(default_factory=list)
    params: SamplingParams | None = None
    finish_reason: str | None = None
    submit_s: float = 0.0
    first_token_s: float | None = None
    finish_s: float | None = None

    def __post_init__(self):
        if self.params is None:
            self.params = SamplingParams(max_new=self.max_new)
        self.max_new = self.params.max_new


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One emitted token (the admission tick yields the prefill token)."""

    rid: int
    token: int
    index: int
    done: bool = False
    finish_reason: str | None = None


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """Terminal state of one request, as returned by ``generate``."""

    rid: int
    prompt: np.ndarray
    tokens: list
    finish_reason: str
    params: SamplingParams


class ServingEngine:
    """Slot-based wave-admission serving around prefill_slot / decode_step.

    ``quant_state=None`` serves the float weights (mode "off"); with a
    quant_state every matmul site serves its export through the fused
    dequant GEMMs (int8 codes: K1, packed 2/4-bit codes: K4). ``kv_dtype``
    is the pool's storage: "bf16"/"fp32" floats, or "int8"/"int4" codes
    with fp16 scales over groups of ``gcd(head_dim, 32)`` head elements,
    quantized where they are written. ``block_size``/``num_blocks`` size
    the pool; the default ``slots * ceil(max_seq/bs) + 1`` blocks hold
    every slot at ``max_seq``, so the in-tick allocator can never run dry.
    ``attention_window``: ``None``, an int (a sliding window, no sinks) or a
    ``WindowSpec`` (window plus pinned sink blocks), bound to
    ``block_size``. ``act_bits`` (2, 4 or 8; needs a quant_state)
    calibrates a per-tensor spec for every matmul input and serves each
    exported site through the integer GEMMs (int8 codes: K5, packed: K6).
    ``device=None`` means the card.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 256, quant_state: dict | None = None,
                 kv_layout: str = "auto", kv_dtype: str = "bf16",
                 block_size: int = 8, num_blocks: int | None = None,
                 max_stop: int = 4, act_bits: int | None = None,
                 prefill_chunk_tokens: int | None = None,
                 attention_window: int | WindowSpec | None = None,
                 device=None):
        unported = {
            "kv_layout='ring'": (kv_layout == "ring", 10, "the ring layout"),
            "prefill_chunk_tokens": (prefill_chunk_tokens is not None, 12,
                                     "continuous batching"),
        }
        for opt, (hit, item, what) in unported.items():
            if hit:
                raise NotImplementedError(
                    f"{opt} is ported with ROADMAP queue 1 item {item} "
                    f"({what})")
        if kv_layout not in ("auto", "paged"):
            raise ValueError(f"kv_layout {kv_layout!r}")
        if kv_dtype not in ("bf16", "fp32", "int8", "int4"):
            raise ValueError(f"kv_dtype {kv_dtype!r}")
        tfm.check_supported(cfg)
        # held to repro on the dense global decoder; on another layer
        # pattern (gemma2's local/global) they come with item 14
        layered = cfg.block_pattern != ("global",)
        _raise_on_layered(layered, {
            f"kv_dtype={kv_dtype!r}": kv_dtype != "bf16",
            "act_bits": act_bits is not None}, cfg)
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        if act_bits is not None and quant_state is None:
            raise ValueError("act_bits requires a quant_state")
        if act_bits is not None and act_bits not in ACT_GATE_LEVELS:
            raise ValueError(f"act_bits must be one of "
                             f"{sorted(ACT_GATE_LEVELS)}, got {act_bits}")
        self.quant_state = quant_state
        self.qweights: dict = {}
        self.export_ledger = None
        self.act_bits = act_bits
        self.act_specs: dict[str, ActQuantSpec] = {}
        if quant_state is None:
            self._qc = QuantContext(mode="off")
        else:
            self.qweights, self.export_ledger = export_int_model(
                params, cfg, quant_state, device=self.device)
            _raise_on_layered(layered, {
                "a mixed 2/4-bit artifact": any(
                    q.packed for q in self.qweights.values())}, cfg)
            specs = specs_from_state(quant_state["gates"],
                                     quant_state["betas"],
                                     quant_state["signed"])
            if act_bits is not None:
                # fully-integer GEMMs (DESIGN.md §16): every site with an
                # export and an ``.in`` spec runs K5/K6
                self.act_specs = make_act_specs(cfg, params, act_bits)
                specs = {**specs, **self.act_specs}
                self.export_ledger.act_entries = export_act_sites(
                    self.act_specs, self.export_ledger.sites)
            self._qc = QuantContext(mode="serve", cfg=quant_state["qcfg"],
                                    qweights=self.qweights, specs=specs)

        self.block_size = block_size
        self.max_blocks = -(-max_seq // block_size)
        # Long context (DESIGN.md §17): None attends causally; a window
        # masks every layer to (window, sink_tokens) and drives the in-tick
        # eviction. Without chunked prefill a slot's worst case is still
        # its whole table (the prompt is written before the first
        # eviction: window.window_demand_blocks without a chunk size), so
        # the pool is sized as without a window.
        self.window_spec = as_window_spec(attention_window, block_size)
        self._window = None if self.window_spec is None \
            else self.window_spec.mask
        min_blocks = slots * self.max_blocks + 1
        if num_blocks is not None and num_blocks < min_blocks:
            raise NotImplementedError(
                f"num_blocks={num_blocks} < {min_blocks} oversubscribes the "
                f"pool; preemption is ported with ROADMAP queue 1 item 11")
        self.num_blocks = num_blocks or min_blocks
        self.kv_dtype = kv_dtype
        self._kv_store = torch.float32 if kv_dtype == "fp32" \
            else torch.bfloat16
        self.kv_spec = None
        if kv_dtype in ("int8", "int4"):
            # the largest power-of-two group <= 32 dividing head_dim, so the
            # kernel never sees a ragged group
            self.kv_spec = KVQuantSpec(bits=8 if kv_dtype == "int8" else 4,
                                       group_size=math.gcd(cfg.head_dim, 32),
                                       head_dim=cfg.head_dim)
        self.cache = tfm.init_paged_cache(cfg, slots, self.num_blocks,
                                          block_size, kv_dtype=self._kv_store,
                                          kv_spec=self.kv_spec,
                                          device=self.device)
        self._check_kv_contract()
        self.alloc = kv_pool.init_alloc(self.num_blocks, slots,
                                        self.max_blocks, device=self.device)
        self.max_stop = max_stop
        dev = self.device
        self.state = {
            "last_tok": torch.zeros((slots,), dtype=torch.int64, device=dev),
            "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
            "remaining": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "stop": torch.full((slots, max_stop), -1, dtype=torch.int64,
                               device=dev),
        }
        self.slot_req: list[Request | None] = [None] * slots
        self.waiting: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self._auto_rid = iter(range(1 << 20, 1 << 62))
        # The host-sync ledger: every device -> host transfer on the serving
        # path goes through ``_sync`` and is counted there.
        self.stats = {"prefill_forwards": 0, "decode_ticks": 0,
                      "generated_tokens": 0, "nan_failures": 0,
                      "tick_syncs": 0, "admit_syncs": 0,
                      "prefill_time_s": 0.0, "decode_time_s": 0.0}

    def _check_kv_contract(self):
        """Every pool holds exactly the declared storage: the float dtype,
        or codes of the spec's dtype with fp16 scales."""
        spec = self.kv_spec
        if spec is not None:
            want = {"k": spec.code_dtype, "v": spec.code_dtype,
                    "k_scale": spec.scale_dtype, "v_scale": spec.scale_dtype}
        else:
            want = {"k": self._kv_store, "v": self._kv_store}
        for entry in self.cache["layers"]:
            have = {name: t.dtype for name, t in entry.items()}
            if have != want:
                raise RuntimeError(f"KV pool holds {have}, kv_dtype="
                                   f"{self.kv_dtype!r} declares {want}")

    def kv_report(self) -> dict:
        """Bytes per cached token of the pools, by layer and in total
        (``quant.kv.kv_cache_report``); under a window also its residency
        bound (``window.window_report``) under ``"window"``."""
        kinds = list(self.cfg.block_pattern) * self.cfg.pattern_repeats
        report = kv_cache_report(kinds, self.cfg.n_kv_heads,
                                 self.cfg.head_dim, spec=self.kv_spec,
                                 dtype=self._kv_store, kv_dtype=self.kv_dtype)
        if self.window_spec is not None:
            report["window"] = window_report(self.window_spec,
                                             self.max_blocks, self.block_size)
        return report

    def quant_report(self) -> dict:
        """Bytes/BOPs ledger of the served artifact (``quant.quant_report``)
        with the KV section; needs an int export. With ``act_bits`` the
        served activation widths are folded into the gates (a per-tensor
        ``.in`` gate at the level whose T(g) is exactly that width), so
        ``bops.model`` certifies w_bits x a_bits x MACs (§16)."""
        if self.export_ledger is None:
            raise ValueError("no quantized export to report")
        gates = self.quant_state["gates"]
        if self.act_specs:
            gates = dict(gates)
            for key, spec in self.act_specs.items():
                gates[key] = torch.tensor(ACT_GATE_LEVELS[int(spec.bits)],
                                          dtype=torch.float32,
                                          device=self.device)
        return quant_report(self.export_ledger, gates, kv=self.kv_report())

    # ------------------------------------------------------------------
    def _prefill_shape(self, plen: int) -> int:
        """Right-pad the prompt to a power-of-two bucket (>= 8, <= max_seq);
        padding is causally masked from the real positions."""
        b = 8
        while b < plen:
            b *= 2
        return min(b, self.max_seq)

    def _validate_request(self, req: Request):
        if len(req.params.stop) > self.max_stop:
            raise ValueError(
                f"request {req.rid} has {len(req.params.stop)} stop tokens; "
                f"engine holds {self.max_stop} per slot (max_stop=...)")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"request {req.rid}: prompt must be a non-empty 1-D token "
                f"sequence (got shape {prompt.shape})")
        if prompt.size > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt length {prompt.size} exceeds "
                f"max_seq={self.max_seq}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"request {req.rid}: prompt must hold integer "
                             f"token ids (got dtype {prompt.dtype})")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"request {req.rid}: prompt token ids outside "
                f"[0, {self.cfg.vocab_size}) (min {lo}, max {hi})")

    def submit(self, req: Request) -> Request:
        """Enqueue one validated request (FIFO)."""
        self._validate_request(req)
        req.prompt = np.asarray(req.prompt, np.int32)
        req.submit_s = time.perf_counter()
        self.waiting.append(req)
        return req

    def _sync(self, t: torch.Tensor, kind: str) -> np.ndarray:
        """The one door from device to host: a transfer plus its ledger
        entry, so ``tick_syncs`` / ``admit_syncs`` are an audited count."""
        self.stats[kind + "_syncs"] += 1
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    def _admit_paged(self, s: int, req: Request) -> torch.Tensor:
        """Allocate the prompt's blocks and prefill it into slot ``s``.
        Returns the final prompt position's logits row (device)."""
        prompt = req.prompt
        plen = len(prompt)
        self.alloc = kv_pool.alloc_range(self.alloc, s, 0,
                                         -(-plen // self.block_size))
        toks = np.zeros((1, self._prefill_shape(plen)), np.int64)
        toks[0, :plen] = prompt
        logits, self.cache = tfm.prefill_slot(
            self._qc, self.params, torch.from_numpy(toks).to(self.device),
            plen, self.cache, s, self.cfg, block_table=self.alloc["table"],
            window=self._window)
        self.stats["prefill_forwards"] += 1
        return logits[0, plen - 1, : self.cfg.vocab_size]

    def _arm(self, s: int, row: torch.Tensor, req: Request):
        """Arm slot ``s``: pick its first token from the admission logits
        and write its device state rows. Returns device (first, ok)."""
        first = greedy_tokens(row[None])[0]
        ok = torch.isfinite(row).all()
        remaining = req.max_new - 1
        st = self.state
        st["last_tok"][s] = first
        st["active"][s] = ok & (remaining > 0)
        st["remaining"][s] = remaining
        stop = np.full((self.max_stop,), -1, np.int64)
        stop[: len(req.params.stop)] = req.params.stop
        st["stop"][s] = torch.from_numpy(stop).to(self.device)
        return first, ok

    def _retire(self, s: int, req: Request):
        req.done = True
        req.finish_s = time.perf_counter()
        self.finished.append(req)
        self.slot_req[s] = None
        self.alloc = kv_pool.free_slot(self.alloc, s)

    def _post_arm(self, admitted) -> list:
        """ONE batched transfer for the wave's first tokens and finite
        flags, then first-token bookkeeping and early retirement."""
        events = []
        if not admitted:
            return events
        host = self._sync(torch.stack(
            [torch.stack([f, o.to(torch.int64)]) for _, _, f, o in admitted]),
            "admit")
        now = time.perf_counter()
        for (s, req, _, _), (tok, ok) in zip(admitted, host):
            if not ok:
                req.finish_reason = FINISHED_ERROR
                self.stats["nan_failures"] += 1
                self._retire(s, req)
                events.append(TokenEvent(rid=req.rid, token=-1, index=0,
                                         done=True,
                                         finish_reason=FINISHED_ERROR))
                continue
            tok = int(tok)
            req.output.append(tok)
            req.first_token_s = now
            self.stats["generated_tokens"] += 1
            stopped = tok in req.params.stop
            if stopped or req.max_new <= 1:
                req.finish_reason = FINISHED_STOP if stopped \
                    else FINISHED_LENGTH
                self.state["active"][s] = False
                self._retire(s, req)
            events.append(TokenEvent(rid=req.rid, token=tok,
                                     index=len(req.output) - 1,
                                     done=req.done,
                                     finish_reason=req.finish_reason))
        return events

    def _admit_wave(self) -> list:
        t0 = time.perf_counter()
        admitted = []
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                continue
            if not self.waiting:
                break
            req = self.waiting.popleft()
            self.slot_req[s] = req
            row = self._admit_paged(s, req)
            first, ok = self._arm(s, row, req)
            admitted.append((s, req, first, ok))
        events = self._post_arm(admitted)
        if admitted:
            self.stats["prefill_time_s"] += time.perf_counter() - t0
        return events

    def _tick(self):
        """One device-side generation step for the whole batch: under a
        window, eviction of the blocks it no longer reaches; block
        allocation, decode, the non-finite guard, greedy pick, stop/length
        bookkeeping. Returns device tensors; nothing here waits for the
        card."""
        st = self.state
        live = st["active"]
        if self._window is not None:
            # before allocation, so freed blocks serve this tick's pops; fl
            # is the first block K2c's walk reads, so no evicted block is
            # ever attended
            sink_blocks = self.window_spec.sink_blocks
            fl = first_live_block(self.cache["pos"], self.window_spec.window,
                                  sink_blocks, self.block_size)
            self.alloc = kv_pool.evict_out_of_window(self.alloc, fl, live,
                                                     sink_blocks)
        self.alloc = kv_pool.tick_alloc(self.alloc, self.cache["pos"], live,
                                        self.block_size)
        logits, self.cache = tfm.decode_step(
            self._qc, self.params, self.cache, st["last_tok"], self.cfg,
            advance=live, block_table=self.alloc["table"],
            window=self._window)
        rows = logits[:, 0, : self.cfg.vocab_size]
        ok = finite_rows(rows)
        emitted = live & ok
        bad = live & ~ok
        nxt = torch.where(emitted, greedy_tokens(rows), st["last_tok"])
        hit_stop = (nxt[:, None] == st["stop"]).any(dim=-1)
        remaining = st["remaining"] - emitted.to(torch.int32)
        done = emitted & ((remaining <= 0) | hit_stop)
        self.state = {**st, "last_tok": nxt, "active": emitted & ~done,
                      "remaining": remaining}
        return torch.stack([nxt, emitted.to(torch.int64),
                            done.to(torch.int64), bad.to(torch.int64)])

    def step(self) -> list:
        """One engine tick: admit into free slots, decode the running
        batch, retire. Returns the tick's ``TokenEvent``s."""
        events = self._admit_wave()
        if not any(r is not None for r in self.slot_req):
            return events
        t0 = time.perf_counter()
        # the one host transfer of the tick: four (slots,) vectors
        nxt, emitted, done, bad = self._sync(self._tick(), "tick")
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self.stats["decode_ticks"] += 1
        for s in np.flatnonzero(bad):
            req = self.slot_req[int(s)]
            req.finish_reason = FINISHED_ERROR
            self.stats["nan_failures"] += 1
            self._retire(int(s), req)
            events.append(TokenEvent(rid=req.rid, token=-1,
                                     index=len(req.output), done=True,
                                     finish_reason=FINISHED_ERROR))
        for s, req in enumerate(self.slot_req):
            if req is None or not emitted[s]:
                continue
            tok = int(nxt[s])
            req.output.append(tok)
            self.stats["generated_tokens"] += 1
            if done[s]:
                req.finish_reason = (FINISHED_STOP if tok in req.params.stop
                                     else FINISHED_LENGTH)
                self._retire(s, req)
            events.append(TokenEvent(rid=req.rid, token=tok,
                                     index=len(req.output) - 1,
                                     done=req.done,
                                     finish_reason=req.finish_reason))
        return events

    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence,
                 params: SamplingParams | Sequence | None = None, *,
                 max_ticks: int = 100_000) -> list:
        """Serve a batch of prompts to completion; ``GenerationResult``s
        in prompt order."""
        if params is None or isinstance(params, SamplingParams):
            plist = [params or SamplingParams()] * len(prompts)
        else:
            plist = list(params)
            if len(plist) != len(prompts):
                raise ValueError(f"{len(prompts)} prompts but "
                                 f"{len(plist)} SamplingParams")
        reqs = [Request(rid=next(self._auto_rid), prompt=np.asarray(p),
                        params=sp) for p, sp in zip(prompts, plist)]
        for req in reqs:
            self._validate_request(req)
        for req in reqs:
            self.submit(req)
        for _ in range(max_ticks):
            if all(r.done for r in reqs):
                break
            self.step()
        if not all(r.done for r in reqs):
            raise RuntimeError(f"generate() still running after "
                               f"{max_ticks} ticks")
        return [GenerationResult(rid=r.rid, prompt=r.prompt,
                                 tokens=list(r.output),
                                 finish_reason=r.finish_reason,
                                 params=r.params) for r in reqs]
