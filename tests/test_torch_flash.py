"""Whole-prompt attention (K7's plain version) and gemma2 in the port,
against repro.

The plain version of K7 (``flash_attention_ref``, which a CPU tensor takes)
is held to repro's ``flash_attention_op`` -- its jnp oracle and its Pallas
kernel in interpret mode -- over window / softcap / GQA / bf16 cases, and,
with attention sinks (which repro's kernel does not take), to an fp64
numpy oracle of the mask rule. Then smoke gemma2-2b (local and global
layers, attention and logit softcaps, GeGLU, sandwich norms, scaled
embeddings) on params made from a seed with numpy and handed to the port
through ``bridge``: prefill and decode logits, and the greedy tokens of
``ServingEngine`` (uniform int8 state, bf16 pool, with and without a
window), against repro's model functions. Its prefill runs op by op
(``jax.disable_jit``), and the port's prefill logits equal it to an fp32
ulp. Jitted, XLA moves repro's roundings: its logits then part from its
own op-by-op run by up to ~4% of their max on this 4-layer model and can
flip a greedy token. Most of that is XLA keeping bf16 intermediates in
fp32 across fused ops (with ``xla_allow_excess_precision`` off, float
weights give the op-by-op logits to 1.3e-7); the quantized sites' fp32
arithmetic still moves ~0.8%. Its decode steps run jitted whole all the
same, with the excess precision off (op by op their compiles would add
~8 s to this file's ~32), and are held where the decode attention's sum
order holds them anyway. The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.configs import get_smoke_config as j_smoke
from repro.core.sites import QuantContext as JQuantContext
from repro.kernels.flash_attention.ops import flash_attention_op as j_fa_op
from repro.models import transformer as jtfm
from repro.quant.spec import QuantizedTensor as JQuantizedTensor
from repro.quant.spec import specs_from_state as j_specs_from_state
from repro.serving import kv_pool as jkv
from repro.serving import make_uniform_quant_state as j_uniform_state
from repro.serving import window as jwin
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.sites import QuantContext
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     flash_attention_ref)
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.quant.spec import specs_from_state
from repro_torch.serving import kv_pool
from repro_torch.serving import window as twin
from repro_torch.serving.engine import (SamplingParams, ServingEngine,
                                        export_int_model,
                                        make_mixed_quant_state)

BS = 4
# fp32 attention: both sides sum D = 16 products and S <= 256 softmax terms
# in fp32, in different orders (torch's CPU einsum vs XLA's dot, or the
# Pallas kernel's online softmax); 1e-5 of max|v| is far above that
# rounding and far below an O(max|v|) mask or head-indexing fault
FP32_RTOL = 1e-5
# bf16 output: the two fp32 results round to bf16 on their own, so they
# may land one bf16 ulp of the output apart, plus the fp32 term above
BF16_ULP_BITS = 7
# prefill logits against repro run op by op: the same fp32 and bf16
# operations in the same order (the dense attention's einsums sum D = 16
# products, which both sides round alike here), except the logit softcap's
# tanh (XLA's own against the C library's), an ulp or two at
# |logit| <= 30; 1e-5 of max|logit| bounds that and catches any moved bf16
# rounding (2^-8 relative) before the head
PREFILL_RTOL = 1e-5
# decode logits: the paged attention's plain versions sum in another order
# (torch's einsum against XLA's dot), which can flip a bf16 probability
# rounding that the layers carry to the logits (0.8% of their max measured
# on this model against repro op by op), and jitted, repro's FMAs move an
# fp32 rounding or two; the port's serving tests' bound, 2% of the largest
# |logit|, holds both, and a wrong mask or window moves the logits by O(1)
DECODE_RTOL = 2e-2

# (name, B, Hq, Hkv, S, causal, window, softcap, dtype): the TPU kernel's
# options; S = 256 spans two of the Pallas kernel's 128-blocks, so its
# block skipping runs too (a ragged S reads past the array in interpret
# mode, which fills with NaN)
FA_CASES = [
    ("causal-gqa", 2, 4, 2, 40, True, None, None, "float32"),
    ("window-softcap-bf16", 1, 4, 2, 40, True, 8, 50.0, "bfloat16"),
    ("long-window-softcap", 1, 2, 1, 256, True, 24, 30.0, "float32"),
]


def _qkv(seed, b, hq, hkv, s, d=16, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    if dtype == "bfloat16":     # values exact in bf16 on both sides
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _tol(ref: np.ndarray, vmax: float, dtype: str) -> np.ndarray:
    tol = FP32_RTOL * vmax
    if dtype == "bfloat16":
        mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
        tol = tol + 2.0 ** (np.floor(np.log2(mag)) - BF16_ULP_BITS)
    return tol


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", FA_CASES, ids=[c[0] for c in FA_CASES])
def test_flash_plain_matches_repro(case, use_pallas):
    _, b, hq, hkv, s, causal, window, cap, dtype = case
    q, k, v = _qkv(len(case[0]), b, hq, hkv, s, dtype=dtype)
    jdt = jnp.dtype(dtype)
    want = np.asarray(j_fa_op(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=causal, window=window, softcap=cap, use_pallas=use_pallas,
        interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = flash_attention_op(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             causal=causal, window=window, softcap=cap)
    assert got.dtype == tdt and got.shape == (b, hq, s, 16)
    err = np.abs(got.float().numpy() - want)
    assert (err <= _tol(want, np.abs(v).max(), dtype)).all(), err.max()


def _fp64_oracle(q, k, v, window, sinks, cap):
    """The mask rule written out in fp64 numpy, GQA by head index."""
    b, hq, s, d = q.shape
    groups = hq // k.shape[1]
    out = np.zeros(q.shape)
    for bi in range(b):
        for h in range(hq):
            kk, vv = k[bi, h // groups], v[bi, h // groups]
            for p in range(s):
                sc = kk.astype(np.float64) @ q[bi, h, p] / np.sqrt(d)
                if cap is not None:
                    sc = np.tanh(sc / cap) * cap
                kp = np.arange(s)
                keep = (kp <= p) & ((p - kp < window) | (kp < sinks))
                e = np.exp(sc[keep] - sc[keep].max())
                out[bi, h, p] = e @ vv[keep] / e.sum()
    return out


@pytest.mark.parametrize("window, sinks, cap", [(6, 4, None), (5, 9, 20.0),
                                                (64, 8, None)])
def test_flash_plain_sinks_match_fp64_oracle(window, sinks, cap):
    """sinks > 0 (repro's attention_train mask; its K7 has no sinks): a
    sink block that a 6-wide window passes, one it covers in part, and a
    window that does not bind."""
    q, k, v = _qkv(window + sinks, 1, 4, 2, 30)
    got = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window, sinks=sinks, softcap=cap)
    want = _fp64_oracle(q, k, v, window, sinks, cap)
    assert np.abs(got.numpy() - want).max() <= FP32_RTOL * np.abs(v).max()
    mask = attention_mask(30, window=window, sinks=sinks).numpy()
    kp, p = np.meshgrid(np.arange(30), np.arange(30))
    assert (mask == ((kp <= p) & ((p - kp < window) | (kp < sinks)))).all()


def test_flash_wrapper_checks_and_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 2, 12))
    flash_attention.launches = 0
    out = flash_attention(q, k, v, window=4, sinks=2)
    assert torch.equal(out, flash_attention_ref(q, k, v, window=4, sinks=2))
    assert flash_attention.launches == 0
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention_op(q, k[:, :1].expand(1, 3, 12, 16),
                           v[:, :1].expand(1, 3, 12, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention_op(q, k, v, window=0)


def test_attention_train_through_k7_branch_on_cpu(monkeypatch):
    """The branch the card's prefill takes (K7 over the model's (B, S, H,
    hd) tensors through transposed views), run on the CPU through the
    plain version, against the einsums: they part only by the bf16
    rounding of the probabilities, at most 2^-9 max|v| (twice that across
    a tie) on the attention output, plus one bf16 ulp of it (<= 2^-7
    max|v|): 3 x 2^-8 max|v|, which attn_o carries through at most its
    largest column L1 norm, plus a bf16 ulp of its own output."""
    cfg = get_smoke_config("gemma2-2b")
    rng = np.random.default_rng(4)
    p = {name: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[0]))
        for name, shape in (("wq", (64, 64)), ("wk", (64, 32)),
                            ("wv", (64, 32)), ("wo", (64, 64)))}
    x = torch.from_numpy(rng.normal(size=(1, 24, 64)).astype(
        np.float32)).to(torch.bfloat16)
    qc = QuantContext(mode="off")
    for kind, window in (("local", None), ("global", None),
                         ("global", (6, 4))):
        want, (k, v) = tattn.attention_train(qc, p, x, cfg, kind,
                                             window=window)
        with monkeypatch.context() as m:
            m.setattr(tattn, "_flash_prefill", lambda *a: True)
            got, (k2, v2) = tattn.attention_train(qc, p, x, cfg, kind,
                                                  window=window)
        assert torch.equal(k, k2) and torch.equal(v, v2)
        out_bound = 3 * 2.0 ** -8 * float(v.float().abs().max())
        wo_l1 = float(p["wo"].to(torch.bfloat16).float().abs().sum(0).max())
        tol = out_bound * wo_l1 + 2.0 ** -7 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# gemma2-smoke through the model and the engine
# ---------------------------------------------------------------------------


def _numpy_params(tcfg, seed=0):
    """Params in repro's layout (the port's init gives the tree), made from
    a seeded numpy generator: matrices ~ N(0, 1/fan_in), the embedding
    N(0, 0.02^2) as repro draws it, norm gains N(0, 0.1^2) so that every
    ``1 + gain`` is exercised."""
    rng = np.random.default_rng(seed)

    def fill(t, name):
        if isinstance(t, dict):
            return {k: fill(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v, name) for v in t]
        shape = tuple(t.shape)
        if name == "embed":
            a = rng.normal(size=shape) * 0.02
        elif name.startswith("ln") or name == "final_norm":
            a = rng.normal(size=shape) * 0.1
        else:
            a = rng.normal(size=shape) / np.sqrt(shape[-2])
        return a.astype(np.float32)

    return fill(ttfm.init_params(tcfg, 0, device="cpu"), "")


@pytest.fixture(scope="module")
def gemma():
    """gemma2-smoke on numpy params: repro's uniform int8 state (handed to
    the port through ``bridge``) and a serve context over the port's
    export of it. The export is the 8-bit class of ``export_sites``, held
    bit for bit to repro's in ``tests/test_torch_quant.py``; taking it
    spares repro's export-mode trace, whose compiles take ~8 s."""
    cfg, tcfg = j_smoke("gemma2-2b"), get_smoke_config("gemma2-2b")
    npp = _numpy_params(tcfg)
    params = jax.tree.map(jnp.asarray, npp)
    qs = j_uniform_state(cfg, params)
    tparams = bridge.params_from_numpy(npp, device="cpu")
    tqs = bridge.quant_state_from_numpy(
        jax.tree.map(np.asarray, qs["gates"]),
        jax.tree.map(np.asarray, qs["betas"]), qs["signed"],
        dataclasses.asdict(qs["qcfg"]), device="cpu")
    tqw, _ = export_int_model(tparams, tcfg, tqs, device="cpu")
    assert sorted(tqw) == sorted(f"{s}.w" for s in ttfm.collect_sites(tcfg))
    qw = {key: JQuantizedTensor(
        codes=jnp.asarray(t.codes.numpy()), scale=jnp.asarray(t.scale.numpy()),
        bias=jnp.asarray(t.bias.numpy()), storage_bits=t.storage_bits, k=t.k,
        colsum=jnp.asarray(t.colsum.numpy())) for key, t in tqw.items()}
    jqc = JQuantContext(mode="serve", cfg=qs["qcfg"], qweights=qw,
                        specs=j_specs_from_state(qs["gates"], qs["betas"],
                                                 qs["signed"]))
    return cfg, params, jqc, tcfg, tparams, tqs


def _repro_decode(cfg, params, jqc, cache, alloc, window):
    """repro's decode_step jitted whole for one slot's cache, compiled with
    XLA's excess precision off, so that bf16 results round where repro's
    ops say (jitted, XLA otherwise keeps them fp32 across fused ops)."""
    def step(p, c, t, a, tb):
        return jtfm.decode_step(jqc, p, c, t, cfg, advance=a, block_table=tb,
                                window=window)

    args = (params, cache, jnp.zeros((1,), jnp.int32),
            jnp.ones((1,), jnp.int32), alloc["table"])
    return jax.jit(step).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _repro_greedy(cfg, params, jqc, prompt, n_new, window=None, pad=32,
                  decode=None):
    """repro's prefill_slot run op by op, then its greedy decode_step loop
    (``decode``: ``_repro_decode``'s, made here if None) on one slot;
    returns (logit rows, tokens, decode)."""
    mb = 64 // BS
    plen = len(prompt)
    toks = np.zeros((1, pad), np.int32)
    toks[0, :plen] = prompt
    cache = jtfm.init_paged_cache(cfg, 1, mb + 1, BS)
    alloc = jkv.alloc_range(jkv.init_alloc(mb + 1, 1, mb), 0, 0,
                            -(-plen // BS))
    with jax.disable_jit():
        lg, cache = jtfm.prefill_slot(jqc, params, jnp.asarray(toks), plen,
                                      cache, 0, cfg,
                                      block_table=alloc["table"],
                                      window=window)
    rows = [np.asarray(lg[0, plen - 1, :cfg.vocab_size])]
    decode = decode or _repro_decode(cfg, params, jqc, cache, alloc, window)
    adv = jnp.ones((1,), jnp.int32)
    for _ in range(n_new - 1):
        alloc = jkv.tick_alloc(alloc, cache["pos"], adv, BS)
        tok = jnp.asarray([int(rows[-1].argmax())], jnp.int32)
        lg, cache = decode(params, cache, tok, adv, alloc["table"])
        rows.append(np.asarray(lg[0, 0, :cfg.vocab_size]))
    return rows, [int(r.argmax()) for r in rows], decode


def _port_rows(tcfg, tparams, qc, prompt, tokens, window=None, pad=32):
    """The port's prefill_slot + decode_step on one slot under the serve
    context ``qc``, fed ``tokens``; logit rows."""
    mb = 64 // BS
    plen = len(prompt)
    toks = torch.zeros((1, pad), dtype=torch.int64)
    toks[0, :plen] = torch.from_numpy(np.asarray(prompt))
    cache = ttfm.init_paged_cache(tcfg, 1, mb + 1, BS, device="cpu")
    alloc = kv_pool.alloc_range(kv_pool.init_alloc(mb + 1, 1, mb,
                                                   device="cpu"),
                                0, 0, -(-plen // BS))
    lg, cache = ttfm.prefill_slot(qc, tparams, toks, plen, cache, 0, tcfg,
                                  block_table=alloc["table"], window=window)
    rows = [lg[0, plen - 1, :tcfg.vocab_size]]
    adv = torch.ones((1,), dtype=torch.bool)
    for tok in tokens[:-1]:
        alloc = kv_pool.tick_alloc(alloc, cache["pos"], adv, BS)
        lg, cache = ttfm.decode_step(qc, tparams, cache, torch.tensor([tok]),
                                     tcfg, advance=adv,
                                     block_table=alloc["table"],
                                     window=window)
        rows.append(lg[0, 0, :tcfg.vocab_size])
    return rows


WINDOW = jwin.WindowSpec(12, 1).bind(BS).mask     # (12, 4)
PROMPTS = (26, 21)      # past the local layers' 8 and the window's 12
N_NEW = 4


@pytest.fixture(scope="module")
def oracle(gemma):
    """repro's greedy runs of both prompts without a window (None) and
    under WindowSpec(12, 1), each run at the first test that asks for it:
    window -> [(prompt, logit rows, tokens)]."""
    cfg, params, jqc = gemma[:3]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in PROMPTS]

    @functools.lru_cache(maxsize=None)
    def runs(window):
        decode, out = None, []
        for p in prompts:
            rows, toks, decode = _repro_greedy(cfg, params, jqc, p, N_NEW,
                                               window=window, decode=decode)
            out.append((p, rows, toks))
        return out

    return runs


def test_gemma2_params_through_bridge(gemma):
    """Numpy params in repro's tree reach the port through ``bridge``: the
    same tree as the port's own init, leaf for leaf equal; the port's
    sites are repro's."""
    cfg, params, _, tcfg, tparams, _ = gemma
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) \
        == jax.tree.structure(jax.tree.map(
            np.asarray, ttfm.init_params(tcfg, 0, device="cpu")))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(
            jax.tree.map(np.asarray, tparams))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert set(tparams["blocks"][0]) == {"ln1", "attn", "ln2", "mlp",
                                         "ln1_post", "ln2_post"}
    assert list(ttfm.collect_sites(tcfg))[:2] == ["p0_local/attn/attn_q",
                                                  "p0_local/attn/attn_k"]
    assert "p1_global/ffn/mlp_down" in ttfm.collect_sites(tcfg)


@pytest.mark.parametrize("window", [None, WINDOW], ids=["none", "window"])
def test_gemma2_prefill_and_decode_logits_match_repro(gemma, oracle, window):
    """Prefill and 3 decode steps of smoke gemma2 (uniform int8 export, bf16
    pool; local layers window 8), the port fed repro's tokens."""
    tcfg, tparams, tqs = gemma[3:]
    qw, _ = export_int_model(tparams, tcfg, tqs, device="cpu")
    qc = QuantContext("serve", cfg=tqs["qcfg"], qweights=qw,
                      specs=specs_from_state(tqs["gates"], tqs["betas"],
                                             tqs["signed"]))
    for prompt, rows, toks in oracle(window):
        got = _port_rows(tcfg, tparams, qc, prompt, toks, window=window)
        for i, (w, g) in enumerate(zip(rows, got)):
            rtol = PREFILL_RTOL if i == 0 else DECODE_RTOL
            assert np.abs(g.numpy() - w).max() <= rtol * np.abs(w).max()


@pytest.mark.parametrize("window", [None, WINDOW], ids=["none", "window"])
def test_gemma2_engine_greedy_tokens_equal_repro(gemma, oracle, window):
    """``ServingEngine`` (2 slots, wave admission, uniform int8, bf16 pool;
    under WindowSpec(12, 1) also the in-tick eviction): greedy tokens equal
    repro's exactly."""
    tcfg, tparams, tqs = gemma[3:]
    spec = None if window is None else twin.WindowSpec(12, 1)
    eng = ServingEngine(tcfg, tparams, slots=2, max_seq=64, block_size=BS,
                        quant_state=tqs, attention_window=spec,
                        device="cpu")
    res = eng.generate([p for p, _, _ in oracle(window)],
                       SamplingParams(max_new=N_NEW))
    assert [r.tokens for r in res] == [t for _, _, t in oracle(window)]
    assert eng.stats["tick_syncs"] == eng.stats["decode_ticks"]
    assert int(eng.alloc["n_free"]) == eng.num_blocks - 1


@pytest.mark.parametrize("kwargs, state", [
    ({"kv_dtype": "int8"}, "uniform"), ({"kv_dtype": "int4"}, "uniform"),
    ({"kv_dtype": "fp32"}, "uniform"), ({"act_bits": 8}, "uniform"),
    ({}, "mixed")])
def test_gemma2_unheld_engine_options_raise(gemma, kwargs, state):
    """The options no test here holds to repro on gemma2's layer pattern
    raise, naming item 14, rather than serve unchecked."""
    tcfg, tparams, tqs = gemma[3:]
    if state == "mixed":
        tqs = make_mixed_quant_state(tcfg, tparams, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        ServingEngine(tcfg, tparams, slots=2, max_seq=32, quant_state=tqs,
                      device="cpu", **kwargs)
