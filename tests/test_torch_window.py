"""Long-context serving of the port against repro (DESIGN.md §17).

On smoke tinyllama-1.1b with 8-token blocks: the window helpers, the
allocator's ``release_range``/``evict_out_of_window`` (bit for bit), the
plain version of K2c (``paged_attention_ref`` with ``window``/``sinks``)
against repro's oracle and its Pallas kernel in interpret mode, windowed
dense attention, the model-level windowed prefill + decode, and
``ServingEngine(attention_window=...)`` whose greedy tokens must equal
repro's model functions called eagerly under the same window
(``tests/test_long_context.py``'s oracle; repro's jitted engine is not
driven). The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.configs import get_smoke_config as j_smoke
from repro.core.sites import QuantContext as JQuantContext
from repro.kernels.paged_attention.ops import paged_attention_op as j_pa_op
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.quant import kv as jkvq
from repro.serving import kv_pool as jkv
from repro.serving import window as jwin
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.sites import QuantContext
from repro_torch.kernels.paged_attention.ops import paged_attention_op
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_quant_window, paged_attention_window)
from repro_torch.kernels.paged_attention.ref import (
    bf16_rounding_tolerance, paged_attention_ref)
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.quant import kv as tkvq
from repro_torch.serving import kv_pool
from repro_torch.serving import window as twin
from repro_torch.serving.engine import Request, SamplingParams, ServingEngine

BS = 8
# bf16 attention: repro's oracle and the plain version round the softmax
# probabilities to bf16 before the PV product, the Pallas kernel keeps them
# fp32; a bf16 rounding moves an output by at most 2^-9 max|v|, twice that
# for two roundings on either side of a tie (tests/test_torch_kernels.py)
PA_TOL_FACTOR = 2.0 ** -8
# logits: activations are bf16 between layers in both packages, so a fp32
# sum taken in another order can flip a bf16 rounding (2^-8 relative) that
# two layers carry to the logits; 2% of the largest |logit| is a few bf16
# ulps there (tests/test_torch_serving.py), a wrong mask moves them by O(1)
LOGIT_RTOL = 2e-2
# (window, sinks in tokens) at bs = 4, positions up to 23: binding with
# sinks, binding without, sinks covering a block in part, not binding
WINDOW_CASES = {"sinks": (6, 4), "no-sinks": (6, 0),
                "ragged-sinks": (7, 5), "wide": (64, 0)}


@pytest.fixture(scope="module")
def smoke():
    cfg = j_smoke("tinyllama-1.1b")
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, params, get_smoke_config("tinyllama-1.1b"), tparams


# ---------------------------------------------------------------------------
# window.py
# ---------------------------------------------------------------------------


def test_window_helpers_equal_repro():
    """Every helper over a grid of (pos, window, sink_blocks, bs), pos
    from below window - 1 (where only the clamp makes C's truncating and
    Python's flooring division agree) to several windows."""
    pos = np.arange(-3, 90, dtype=np.int32)
    for window in (1, 3, 8, 12, 17):
        for sink_blocks in (0, 1, 3):
            for bs in (1, 4, 8):
                want = np.asarray(jwin.first_live_block(
                    jnp.asarray(pos), window, sink_blocks, bs))
                got = twin.first_live_block(torch.from_numpy(pos), window,
                                            sink_blocks, bs)
                np.testing.assert_array_equal(got.numpy(), want)
                assert [twin.first_live_block(int(p), window, sink_blocks,
                                              bs) for p in pos] \
                    == [jwin.first_live_block(int(p), window, sink_blocks,
                                              bs) for p in pos]
                js = jwin.WindowSpec(window, sink_blocks).bind(bs)
                ts = twin.WindowSpec(window, sink_blocks).bind(bs)
                assert dataclasses.asdict(ts) == dataclasses.asdict(js)
                assert (ts.sink_tokens, ts.mask) == (js.sink_tokens, js.mask)
                for mb in (1, 4, 16):
                    assert ts.live_blocks(mb) == js.live_blocks(mb)
                    assert twin.window_report(ts, mb, bs) \
                        == jwin.window_report(js, mb, bs)
                    for chunk in (None, 5, 16):
                        assert twin.window_demand_blocks(ts, mb, chunk, bs) \
                            == jwin.window_demand_blocks(js, mb, chunk, bs)
                assert twin.max_live_blocks(window, sink_blocks, bs) \
                    == jwin.max_live_blocks(window, sink_blocks, bs)
                assert twin.sink_block_count(window, bs) \
                    == jwin.sink_block_count(window, bs)
                for kind in ("global", "local"):
                    for w in (None, (window, sink_blocks * bs)):
                        assert twin.layer_mask(w, kind, 10) \
                            == jwin.layer_mask(w, kind, 10)
    assert twin.window_report(None, 8, 8) == jwin.window_report(None, 8, 8)
    assert twin.window_demand_blocks(None, 8, 16, 8) == 8
    assert twin.as_window_spec(None) is None
    assert twin.as_window_spec(12, 8) == twin.WindowSpec(12, 0, 8)
    spec = twin.WindowSpec(12, 1)
    assert twin.as_window_spec(spec, 4) == twin.WindowSpec(12, 1, 4)
    assert twin.as_window_spec(spec) is spec
    for bad in ({"window": 0}, {"window": 4, "sink_blocks": -1},
                {"window": 4, "block_size": 0}):
        with pytest.raises(ValueError):
            twin.WindowSpec(**bad)
    with pytest.raises(ValueError, match="unbound"):
        _ = twin.WindowSpec(4, 1).sink_tokens


def test_resolve_window_equals_repro(smoke):
    cfg, _, tcfg, _ = smoke
    for kind in ("global", "local"):
        for w in (None, (5, 8), (10_000, 0)):
            assert tattn._resolve_window(w, kind, tcfg) \
                == jattn._resolve_window(w, kind, cfg)


# ---------------------------------------------------------------------------
# kv_pool: release_range, evict_out_of_window
# ---------------------------------------------------------------------------


def _shared_alloc():
    """repro's allocator after three admissions where slot 1 shares slot
    0's first two blocks (refcount 2) and slot 2 shares slot 0's third:
    evicting slots 0 and 1 together drops the same blocks twice."""
    nb, slots, mb = 20, 3, 6
    a = jkv.init_alloc(nb, slots, mb)
    a = jkv.alloc_range(a, 0, 0, 5)
    row0 = np.asarray(a["table"][0])
    a = jkv.share_prefix(a, 1, jnp.asarray(row0), 2)
    a = jkv.alloc_range(a, 1, 2, 3)
    a = jkv.share_prefix(a, 2, jnp.asarray(np.roll(row0, -2)), 1)
    a = jkv.alloc_range(a, 2, 1, 4)
    return a


def _to_torch(a):
    return {k: torch.from_numpy(np.array(v)) for k, v in a.items()}


def _same(j, t):
    for key in ("free", "n_free", "ref", "table"):
        np.testing.assert_array_equal(np.asarray(j[key]), t[key].numpy(),
                                      err_msg=key)


def test_release_range_equals_repro_bit_for_bit():
    ja = _shared_alloc()
    ta = _to_torch(ja)
    assert int(np.asarray(ja["ref"]).max()) == 2
    for slot, start, n in ((0, 1, 3), (1, 0, 2), (2, 4, 9), (0, 0, 6),
                           (1, 3, 0)):
        ja = jkv.release_range(ja, slot, start, n)
        ta = kv_pool.release_range(ta, slot, start, n)
        _same(ja, ta)
    for slot in range(3):      # retirement after eviction frees nothing twice
        ja, ta = jkv.free_slot(ja, slot), kv_pool.free_slot(ta, slot)
        _same(ja, ta)
    assert int(ta["n_free"]) == 19 and bool((ta["ref"][1:] == 0).all())


@pytest.mark.parametrize("sink_blocks", [0, 1])
def test_evict_out_of_window_equals_repro_bit_for_bit(sink_blocks):
    """Rows 0 and 1 drop the shared blocks in one call: each block is
    decremented twice and pushed once; a row outside ``live`` keeps its
    blocks; then a second eviction, an allocation and retirement."""
    ja = _shared_alloc()
    ta = _to_torch(ja)
    for fl, live in (([3, 4, 2], [True, True, False]),
                     ([5, 5, 3], [True, True, True]),
                     ([6, 6, 6], [False, True, True])):
        jfl = jnp.asarray(fl, jnp.int32)
        tfl = torch.tensor(fl, dtype=torch.int32)
        ja = jkv.evict_out_of_window(ja, jfl, jnp.asarray(live), sink_blocks)
        ta = kv_pool.evict_out_of_window(ta, tfl, torch.tensor(live),
                                         sink_blocks)
        _same(ja, ta)
        if sink_blocks:       # the sink column survives every eviction
            assert bool((ta["table"][:, 0] >= 0).all())
    pos = np.asarray([40, 44, 30], np.int32)
    live = np.asarray([True, True, True])
    ja = jkv.tick_alloc(ja, jnp.asarray(pos), jnp.asarray(live), BS)
    ta = kv_pool.tick_alloc(ta, torch.from_numpy(pos), torch.from_numpy(live),
                            BS)
    _same(ja, ta)
    for slot in range(3):
        ja, ta = jkv.free_slot(ja, slot), kv_pool.free_slot(ta, slot)
        _same(ja, ta)
    assert int(ta["n_free"]) == 19


# ---------------------------------------------------------------------------
# K2c's plain version against repro's oracle and Pallas kernel
# ---------------------------------------------------------------------------


def _win_inputs(seed, window, sinks, b=3, kvh=2, g=2, hd=64, bs=4, mb=6):
    """Ragged positions (one full row, one short row) and a table whose
    blocks wholly outside the sinks and the window are evicted (-1), as
    the engine leaves them: every -1 lies outside the live span, where
    repro's oracle (which gathers it from block 0) masks it too."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    pos = rng.integers(0, mb * bs, size=b).astype(np.int32)
    pos[0], pos[1] = mb * bs - 1, 2
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    sink_blocks = -(-sinks // bs)
    for i, p in enumerate(pos):
        n = p // bs + 1
        table[i, :n] = perm[i * mb:i * mb + n]
        fl = max((int(p) - window + 1) // bs, sink_blocks)
        table[i, sink_blocks:fl] = -1
    q = rng.normal(size=(b, kvh, g, hd)).astype(np.float32)
    k = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    return q, k, v, table, pos


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
@pytest.mark.parametrize("pool", ["bf16", "fp32"])
def test_window_plain_matches_repro_float_pools(pool, case, use_pallas):
    window, sinks = WINDOW_CASES[case]
    q, k, v, table, pos = _win_inputs(len(case) + len(pool), window, sinks)
    jd, td = (jnp.bfloat16, torch.bfloat16) if pool == "bf16" \
        else (jnp.float32, torch.float32)
    want = np.asarray(j_pa_op(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(table), jnp.asarray(pos), window=window, sinks=sinks,
        use_pallas=use_pallas, interpret=True))
    got = paged_attention_op(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(table),
        torch.from_numpy(pos), window=window, sinks=sinks)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = PA_TOL_FACTOR * np.abs(v).max() + 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
@pytest.mark.parametrize("bits", [8, 4])
def test_window_plain_matches_repro_quant_pools(bits, case, use_pallas):
    """int8 and int4 pools at head_dim 64 (two scale groups of 32)."""
    window, sinks = WINDOW_CASES[case]
    q, k, v, table, pos = _win_inputs(bits + len(case), window, sinks)
    jspec = jkvq.KVQuantSpec(bits=bits, group_size=32, head_dim=64)
    tspec = tkvq.KVQuantSpec(bits=bits, group_size=32, head_dim=64)
    jk, jv = (jkvq.quantize_kv(jnp.asarray(a), jspec) for a in (k, v))
    tk, tv = (tkvq.quantize_kv(torch.from_numpy(a), tspec) for a in (k, v))
    kd, vd = (tkvq.dequantize_kv(c, s, tspec) for c, s in (tk, tv))
    want = np.asarray(j_pa_op(
        jnp.asarray(q, jnp.bfloat16), jk[0], jv[0], jnp.asarray(table),
        jnp.asarray(pos), window=window, sinks=sinks, use_pallas=use_pallas,
        interpret=True, k_scale=jk[1], v_scale=jv[1]))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    args = (torch.from_numpy(table), torch.from_numpy(pos))
    got = paged_attention_op(tq, tk[0], tv[0], *args, window=window,
                             sinks=sinks, k_scale=tk[1], v_scale=tv[1])
    # against the oracle, which rounds where the plain version does, the
    # float pools' tolerance; against the fp32 Pallas kernel, the bound of
    # the plain version's bf16 roundings over the attended keys
    tol = bf16_rounding_tolerance(tq, kd, vd, *args, window=window,
                                  sinks=sinks) \
        if use_pallas else PA_TOL_FACTOR * float(vd.abs().max()) + 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("sinks", [0, 4])
def test_window_that_does_not_bind_equals_no_window(sinks):
    """A window wider than every position attends what no window does:
    the plain K2c equals the plain K2a/K2b bit for bit (with sinks too:
    they lie inside the window)."""
    q, k, v, table, pos = _win_inputs(5, 10_000, sinks)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    args = (torch.from_numpy(table), torch.from_numpy(pos))
    fk, fv = torch.from_numpy(k).to(torch.bfloat16), \
        torch.from_numpy(v).to(torch.bfloat16)
    assert torch.equal(paged_attention_op(tq, fk, fv, *args, window=10_000,
                                          sinks=sinks),
                       paged_attention_op(tq, fk, fv, *args))
    spec = tkvq.KVQuantSpec(bits=4, group_size=32, head_dim=64)
    (kc, ks), (vc, vs) = (tkvq.quantize_kv(torch.from_numpy(a), spec)
                          for a in (k, v))
    assert torch.equal(
        paged_attention_op(tq, kc, vc, *args, window=10_000, sinks=sinks,
                           k_scale=ks, v_scale=vs),
        paged_attention_op(tq, kc, vc, *args, k_scale=ks, v_scale=vs))


def test_window_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    window, sinks = WINDOW_CASES["sinks"]
    q, k, v, table, pos = _win_inputs(7, window, sinks)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    args = (torch.from_numpy(table), torch.from_numpy(pos))
    spec = tkvq.KVQuantSpec(bits=8, group_size=32, head_dim=64)
    (kc, ks), (vc, vs) = (tkvq.quantize_kv(torch.from_numpy(a), spec)
                          for a in (k, v))
    fk, fv = torch.from_numpy(k), torch.from_numpy(v)
    before = (paged_attention_window.launches,
              paged_attention_quant_window.launches)
    assert torch.equal(
        paged_attention_window(tq, fk, fv, *args, window=window, sinks=sinks),
        paged_attention_ref(tq, fk, fv, *args, window=window, sinks=sinks))
    assert torch.equal(
        paged_attention_quant_window(tq, kc, vc, ks, vs, *args, window=window,
                                     sinks=sinks),
        paged_attention_ref(tq, kc, vc, *args, window=window, sinks=sinks,
                            k_scale=ks, v_scale=vs))
    assert (paged_attention_window.launches,
            paged_attention_quant_window.launches) == before
    with pytest.raises(ValueError, match="window >= 1"):
        paged_attention_window(tq, fk, fv, *args, window=0)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------


def test_windowed_attention_train_equals_repro(smoke):
    """Dense (prefill) attention of one layer under (window 5, sinks 8),
    window 5 alone, and a window that does not bind (bit-equal to none)."""
    cfg, params, tcfg, tparams = smoke
    x = np.random.default_rng(3).normal(size=(1, 24, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"][0]["attn"].items()}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    none, _ = tattn.attention_train(QuantContext(mode="off"), tp, tx, tcfg)
    for w in ((5, 8), (5, 0), (24, 0)):
        want, _ = jattn.attention_train(
            JQuantContext(mode="off"), jp, jnp.asarray(x, jnp.bfloat16), cfg,
            "global", window=w)
        got, _ = tattn.attention_train(QuantContext(mode="off"), tp, tx,
                                       tcfg, window=w)
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert np.abs(got.float().numpy() - want).max() \
            <= LOGIT_RTOL * np.abs(want).max()
        assert torch.equal(got, none) == (w == (24, 0))


def _kv_spec(pkg, cfg, kv_dtype):
    if kv_dtype == "bf16":
        return None
    return pkg.KVQuantSpec(bits=8, group_size=math.gcd(cfg.head_dim, 32),
                           head_dim=cfg.head_dim)


def _port_rows(tcfg, tparams, kv_dtype, window, toks, plen, steps):
    """The port's prefill_slot + decode_step on one slot; logit rows."""
    qc = QuantContext(mode="off")
    mb = 64 // BS
    cache = ttfm.init_paged_cache(tcfg, 1, mb + 1, BS,
                                  kv_spec=_kv_spec(tkvq, tcfg, kv_dtype),
                                  device="cpu")
    alloc = kv_pool.init_alloc(mb + 1, 1, mb, device="cpu")
    alloc = kv_pool.alloc_range(alloc, 0, 0, -(-plen // BS))
    lg, cache = ttfm.prefill_slot(qc, tparams, torch.from_numpy(toks).long(),
                                  plen, cache, 0, tcfg,
                                  block_table=alloc["table"], window=window)
    rows = [lg[0, plen - 1]]
    adv = torch.ones((1,), dtype=torch.bool)
    for tok in steps:
        alloc = kv_pool.tick_alloc(alloc, cache["pos"], adv, BS)
        lg, cache = ttfm.decode_step(qc, tparams, cache,
                                     torch.tensor([tok]), tcfg, advance=adv,
                                     block_table=alloc["table"],
                                     window=window)
        rows.append(lg[0, 0])
    return rows


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_prefill_and_decode_logits_match_repro(smoke, kv_dtype):
    """A 20-token prompt and 4 decode steps under WindowSpec(12, 1): every
    position from 12 on has keys outside both the window and the sink
    block. repro's model functions eagerly, as tests/test_long_context.py
    drives them; and a window that does not bind equals none bit for
    bit."""
    cfg, params, tcfg, tparams = smoke
    wmask = twin.WindowSpec(12, 1).bind(BS).mask
    assert wmask == jwin.WindowSpec(12, 1).bind(BS).mask == (12, 8)
    rng = np.random.default_rng(6)
    plen = 20
    toks = np.zeros((1, 32), np.int32)
    toks[0, :plen] = rng.integers(0, cfg.vocab_size, plen)
    steps = [int(t) for t in rng.integers(0, cfg.vocab_size, 4)]
    qc = JQuantContext(mode="off")
    mb = 64 // BS
    cache = jtfm.init_paged_cache(cfg, 1, mb + 1, BS,
                                  kv_spec=_kv_spec(jkvq, cfg, kv_dtype))
    alloc = jkv.alloc_range(jkv.init_alloc(mb + 1, 1, mb), 0, 0,
                            -(-plen // BS))
    lg, cache = jtfm.prefill_slot(qc, params, jnp.asarray(toks), plen, cache,
                                  0, cfg, block_table=alloc["table"],
                                  window=wmask)
    want = [lg[0, plen - 1]]
    adv = jnp.ones((1,), jnp.int32)
    for tok in steps:
        alloc = jkv.tick_alloc(alloc, cache["pos"], adv, BS)
        lg, cache = jtfm.decode_step(qc, params, cache,
                                     jnp.asarray([tok], jnp.int32), cfg,
                                     advance=adv, block_table=alloc["table"],
                                     window=wmask)
        want.append(lg[0, 0])
    got = _port_rows(tcfg, tparams, kv_dtype, wmask, toks, plen, steps)
    v = cfg.vocab_size
    for w, g in zip(want, got):
        w = np.asarray(w[:v], np.float32)
        assert np.abs(g[:v].numpy() - w).max() <= LOGIT_RTOL * np.abs(w).max()
    none = _port_rows(tcfg, tparams, kv_dtype, None, toks, plen, steps)
    wide = _port_rows(tcfg, tparams, kv_dtype, (64, 0), toks, plen, steps)
    assert all(torch.equal(a, b) for a, b in zip(none, wide))
    assert not torch.equal(none[-1], got[-1])


def _repro_windowed_oracle(cfg, params, kv_dtype, prompt, n_new, wmask):
    """tests/test_long_context.py's oracle: repro's prefill_slot and
    greedy decode_step loop under the window mask, eagerly, one slot."""
    qc = JQuantContext(mode="off")
    mb = 64 // BS
    cache = jtfm.init_paged_cache(cfg, 1, mb + 1, BS,
                                  kv_spec=_kv_spec(jkvq, cfg, kv_dtype))
    alloc = jkv.alloc_range(jkv.init_alloc(mb + 1, 1, mb), 0, 0,
                            -(-len(prompt) // BS))
    plen = len(prompt)
    lg, cache = jtfm.prefill_slot(qc, params,
                                  jnp.asarray(prompt, jnp.int32)[None, :],
                                  plen, cache, 0, cfg,
                                  block_table=alloc["table"], window=wmask)
    row = np.asarray(lg[0, plen - 1, :cfg.vocab_size])
    out = []
    adv = jnp.ones((1,), jnp.int32)
    for _ in range(n_new):
        out.append(int(row.argmax()))
        alloc = jkv.tick_alloc(alloc, cache["pos"], adv, BS)
        lg, cache = jtfm.decode_step(qc, params, cache,
                                     jnp.asarray([out[-1]], jnp.int32), cfg,
                                     advance=adv, block_table=alloc["table"],
                                     window=wmask)
        row = np.asarray(lg[0, 0, :cfg.vocab_size])
    return out


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_engine_greedy_tokens_equal_repro_oracle(smoke, kv_dtype):
    """Two slots under WindowSpec(12, 1), prompts of 30 and 26 tokens, 5
    new tokens each: wave prefill, in-tick eviction (from position 27 on a
    row releases block 1) and the paged pool are invisible, the tokens
    equal repro's eager windowed oracle exactly."""
    cfg, params, tcfg, tparams = smoke
    spec = twin.WindowSpec(window=12, sink_blocks=1)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (30, 26)]
    n_new = 5
    want = [_repro_windowed_oracle(cfg, params, kv_dtype, p, n_new,
                                   jwin.WindowSpec(12, 1).bind(BS).mask)
            for p in prompts]
    eng = ServingEngine(tcfg, tparams, slots=2, max_seq=64, block_size=BS,
                        kv_dtype=kv_dtype, attention_window=spec,
                        device="cpu")
    assert eng.window_spec == spec.bind(BS) and eng._window == (12, 8)
    res = eng.generate(prompts, SamplingParams(max_new=n_new))
    assert [r.tokens for r in res] == want
    st = eng.stats
    assert st["tick_syncs"] == st["decode_ticks"]
    assert int(eng.alloc["n_free"]) == eng.num_blocks - 1
    assert eng.kv_report()["window"] == jwin.window_report(
        jwin.WindowSpec(12, 1).bind(BS), eng.max_blocks, BS)


def test_decode_far_past_the_window_keeps_residency_bounded(smoke):
    """Prompts of 10 and 45 tokens decode 70 tokens past a 16-token window
    with one sink block: after every tick no live slot holds more than
    max_live_blocks(16, 1, 8) = 4 table entries (without a window the
    longer one reaches 15), one host sync per tick, nothing leaks."""
    _, _, tcfg, tparams = smoke
    eng = ServingEngine(tcfg, tparams, slots=2, max_seq=128, block_size=BS,
                        attention_window=twin.WindowSpec(16, 1),
                        device="cpu")
    cap = twin.max_live_blocks(16, 1, BS)
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, tcfg.vocab_size, (n,)) for n in (10, 45)]
    held = []
    for i, p in enumerate(reqs):
        eng.submit(Request(rid=i, prompt=p, max_new=70))
    while eng.waiting or any(r is not None for r in eng.slot_req):
        eng.step()
        live = [s for s, r in enumerate(eng.slot_req) if r is not None]
        held.append(max([int((eng.alloc["table"][s] >= 0).sum())
                         for s in live], default=0))
        if live:
            assert int(eng.alloc["ref"][1:].sum()) == sum(
                int((eng.alloc["table"][s] >= 0).sum()) for s in live)
    assert max(held) == cap, held
    st = eng.stats
    assert st["tick_syncs"] == st["decode_ticks"] == 69
    assert int(eng.alloc["n_free"]) == eng.num_blocks - 1
    assert bool((eng.alloc["ref"][1:] == 0).all())
    assert [len(r.output) for r in eng.finished] == [70, 70]


def test_window_with_chunked_prefill_still_raises(smoke):
    _, _, tcfg, tparams = smoke
    with pytest.raises(NotImplementedError, match="item 12"):
        ServingEngine(tcfg, tparams, slots=2, max_seq=32, device="cpu",
                      attention_window=twin.WindowSpec(8, 1),
                      prefill_chunk_tokens=16)
    with pytest.raises(NotImplementedError, match="item 11"):
        ServingEngine(tcfg, tparams, slots=2, max_seq=32, device="cpu",
                      attention_window=8, num_blocks=5)
    with pytest.raises(NotImplementedError, match="item 10"):
        ServingEngine(tcfg, tparams, slots=2, max_seq=32, device="cpu",
                      attention_window=8, kv_layout="ring")
