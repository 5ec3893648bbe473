"""The split order of K2's decode walk, modelled in torch on the CPU.

The CUDA kernels (``csrc/paged_attention.cu``) cut each row's live blocks
into chunks of ``chunk`` blocks from the list's start, score each chunk in
its own thread block into a partial (m, l, acc), and merge the row's
partials in split order, an empty partial (l = 0) entering as zeros.
``split_model`` walks that dataflow in fp32: the same list (unwindowed,
blocks 0 .. pos // bs; windowed, the sink blocks, then [fl, pos // bs]),
the same chunks, the same skips (table entries of -1, columns past pos or
outside the window) and the same merge. These tests hold it to the plain
version (``paged_attention_ref``, bf16 probabilities) at K2's tolerances
and to its fp32 form (q in fp32: nothing rounded to bf16) within 1e-4 of
max|v|, on the edge cases of the split, and check that the host's split
plan does not depend on a window that cannot bind. The kernel itself runs
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from _port_env import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.paged_attention import split_plan
from repro_torch.kernels.paged_attention.ref import (bf16_rounding_tolerance,
                                                     paged_attention_ref)
from repro_torch.quant.kv import KVQuantSpec, dequantize_kv, quantize_kv

# K2's tolerances (chip_smoke.py, tests/test_torch_gpu.py): the plain
# version rounds the probabilities (and K, V) to bf16, the kernel keeps
# them fp32; against the fp32 form only the sum order differs
K2_TOL_FACTOR = 2.0 ** -8
K2B_F32_RTOL = 1e-4


def live_blocks(p: int, bs: int, max_blocks: int, window=None,
                sinks: int = 0) -> list[int]:
    """The logical blocks a row at ``p`` walks, in the kernel's order."""
    last = -1 if p < 0 else min(p // bs, max_blocks - 1)
    if window is None:
        return list(range(last + 1))
    sink_blocks = -(-sinks // bs)
    first = max((p - window + 1) // bs, sink_blocks)
    return list(range(min(sink_blocks, last + 1))) \
        + list(range(first, last + 1))


def split_model(q, kd, vd, table, pos, *, window=None, sinks=0,
                softcap=None, chunk=None):
    """K2's split walk over dequantized pools ``kd``/``vd`` (num_blocks,
    bs, KV, hd) fp32: (B, KV, G, hd) fp32. ``chunk`` overrides the split
    plan's blocks per chunk."""
    b, kvh, g, hd = q.shape
    bs, mb = kd.shape[1], table.shape[1]
    most = mb if window is None else min(mb, -(-sinks // bs)
                                         + -(-window // bs) + 1)
    c = chunk or split_plan(bs, mb, window, sinks)[0]
    n_splits = max(1, -(-most // c))
    if chunk is None:
        assert (c, n_splits) == split_plan(bs, mb, window, sinks)
    qf = q.float()
    out = torch.zeros((b, kvh, g, hd))
    for r in range(b):
        p = int(pos[r])
        blocks = live_blocks(p, bs, mb, window, sinks)
        assert len(blocks) <= n_splits * c
        parts = []
        for s in range(n_splits):
            rows = []
            for j in blocks[s * c:(s + 1) * c]:
                phys = int(table[r, j])
                for t in range(bs):
                    kp = j * bs + t
                    if phys < 0 or kp > p or (window is not None and not (
                            p - kp < window or kp < sinks)):
                        continue
                    rows.append((phys, t))
            if not rows:
                parts.append(None)          # an empty partial: l = 0
                continue
            ph = torch.tensor([x for x, _ in rows])
            tt = torch.tensor([x for _, x in rows])
            kk, vv = kd[ph, tt], vd[ph, tt]            # (n, KV, hd)
            sc = torch.einsum("kgd,nkd->kgn", qf[r], kk) * hd ** -0.5
            if softcap is not None:
                sc = torch.tanh(sc / softcap) * softcap
            m = sc.amax(-1)
            e = torch.exp(sc - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum("kgn,nkd->kgd", e, vv)))
        live = [x for x in parts if x is not None]
        if not live:
            continue
        mx = torch.stack([m for m, _, _ in live]).amax(0)
        lsum, acc = torch.zeros((kvh, g)), torch.zeros((kvh, g, hd))
        for part in parts:                  # split order
            if part is None:
                continue
            m, l, a = part
            w = torch.exp(m - mx)
            lsum = lsum + l * w
            acc = acc + a * w[..., None]
        out[r] = acc / lsum.clamp_min(1e-30)[..., None]
    return out


def _inputs(seed, positions, *, pool="bf16", hd=16, g=2, kvh=2, bs=4, mb=12,
            window=None, sinks=0):
    """Random q and pools, and a table mapping each row's live blocks (the
    blocks up to pos, less those a window has evicted); every other entry
    is -1. Returns (q, pools, scales, dequantized pools, table, pos)."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    nb = b * mb + 1
    pos = np.asarray(positions, np.int32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        for j in live_blocks(int(p), bs, mb, window, sinks):
            table[i, j] = perm[i * mb + j]
    q = torch.from_numpy(rng.normal(size=(b, kvh, g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.normal(size=(nb, bs, kvh, hd)).astype(
        np.float32)) for _ in range(2))
    if pool in ("int8", "int4"):
        spec = KVQuantSpec(bits=int(pool[-1]), group_size=8, head_dim=hd)
        (kc, ks), (vc, vs) = quantize_kv(k, spec), quantize_kv(v, spec)
        pools, scales = (kc, vc), {"k_scale": ks, "v_scale": vs}
        deq = (dequantize_kv(kc, ks, spec), dequantize_kv(vc, vs, spec))
    else:
        dt = torch.bfloat16 if pool == "bf16" else torch.float32
        pools, scales = (k.to(dt), v.to(dt)), {}
        deq = tuple(x.float() for x in pools)
    return (q, pools, scales, deq, torch.from_numpy(table),
            torch.from_numpy(pos))


def _hold(q, pools, scales, deq, table, pos, window=None, sinks=0,
          softcap=None, chunk=None):
    """The split model against the plain version and its fp32 form."""
    win = {} if window is None else {"window": window, "sinks": sinks}
    got = split_model(q, *deq, table, pos, softcap=softcap, chunk=chunk,
                      **win)
    want = paged_attention_ref(q, *pools, table, pos, softcap=softcap,
                               **win, **scales)
    f32 = paged_attention_ref(q.float(), *pools, table, pos,
                              softcap=softcap, **win, **scales)
    vmax = float(deq[1].abs().max())
    if scales:
        tol = bf16_rounding_tolerance(q, *deq, table, pos, **win)
    else:
        tol = K2_TOL_FACTOR * vmax + 1e-5
    assert float((got - want).abs().max()) <= tol
    assert float((got - f32).abs().max()) <= K2B_F32_RTOL * vmax
    return got


# bs 4, chunks of 2 blocks (8 tokens): rows that end on a chunk boundary
# (pos 7: tokens 0..7), one token past it (8), at pos 0, inside a single
# chunk (5), and a long row (45, six chunks), with -1 past each pos
EDGE_POSITIONS = [7, 8, 0, 5, 45]


@pytest.mark.parametrize("pool", ["bf16", "fp32", "int8", "int4"])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_split_walk_edges_hold_the_plain_version(pool, softcap):
    q, pools, scales, deq, table, pos = _inputs(0, EDGE_POSITIONS, pool=pool)
    _hold(q, pools, scales, deq, table, pos, softcap=softcap, chunk=2)
    _hold(q, pools, scales, deq, table, pos, softcap=softcap)


# (window, sinks) at bs 4, chunks of 2 blocks: a window that binds
# mid-chunk and mid-block (pos 45 attends 37..45) with sinks covering part
# of a block (6 tokens, two sink blocks), one that binds on a block
# boundary without sinks, and one that does not bind
WINDOW_EDGES = [(9, 6), (10, 0), (64, 0)]


@pytest.mark.parametrize("window, sinks", WINDOW_EDGES)
@pytest.mark.parametrize("pool", ["bf16", "int4"])
def test_windowed_split_walk_holds_the_plain_version(pool, window, sinks):
    q, pools, scales, deq, table, pos = _inputs(
        1, EDGE_POSITIONS, pool=pool, window=window, sinks=sinks)
    got = _hold(q, pools, scales, deq, table, pos, window=window,
                sinks=sinks, chunk=2)
    if window > int(pos.max()) and not sinks:
        # a window that does not bind walks K2a's list in K2a's chunks
        assert torch.equal(got, split_model(q, *deq, table, pos, chunk=2))


@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), chunk=st.integers(1, 4),
       window=st.sampled_from([None, 3, 8, 13, 100]),
       sinks=st.integers(0, 6), softcap=st.sampled_from([None, 20.0]),
       pool=st.sampled_from(["bf16", "fp32", "int8", "int4"]))
def test_split_walk_holds_the_plain_version_on_random_rows(
        seed, chunk, window, sinks, softcap, pool):
    rng = np.random.default_rng(seed)
    positions = [int(x) for x in rng.integers(0, 48, 3)]
    sinks = 0 if window is None else sinks
    q, pools, scales, deq, table, pos = _inputs(
        seed, positions, pool=pool, window=window, sinks=sinks)
    _hold(q, pools, scales, deq, table, pos, window=window, sinks=sinks,
          softcap=softcap, chunk=chunk)


@pytest.mark.parametrize("bs", [1, 4, 8, 16, 128])
@pytest.mark.parametrize("max_blocks", [1, 6, 64, 288])
@pytest.mark.parametrize("sinks", [0, 5])
def test_split_plan_ignores_a_window_that_cannot_bind(bs, max_blocks, sinks):
    """A window of at least the table's span leaves K2c's chunk and split
    count equal to K2a's (so K2c then walks K2a's chunks); a window that
    binds keeps the chunk and needs no more splits; the splits cover the
    table and fit the kernel (at most 64 blocks a chunk)."""
    chunk, n_splits = split_plan(bs, max_blocks)
    assert 1 <= chunk <= 64
    assert (n_splits - 1) * chunk < max_blocks <= n_splits * chunk
    for window in (max_blocks * bs, max_blocks * bs + 7):
        assert split_plan(bs, max_blocks, window, sinks) == (chunk, n_splits)
    bound = split_plan(bs, max_blocks, 2 * bs, sinks)
    assert bound[0] == chunk and bound[1] <= n_splits
    assert bound[1] * chunk >= min(max_blocks, -(-sinks // bs) + 3)


def _fake_entry(tensors, quant, windowed, calls):
    """Stands in for a C entry of ``csrc/paged_attention.cu``: reads the
    arguments in the order its signature lists them (``tensors`` maps a
    pointer to its tensor, the wrapper's allocations included) and writes
    the split model's output where the wrapper points ``out``."""
    nptr, nint = (9, 10) if quant else (7, 9)

    def entry(*args):
        assert len(args) == nptr + nint + 2 + 2 * windowed + 1
        ptrs, ints = args[:nptr], args[nptr:nptr + nint]
        scale, softcap = args[nptr + nint:nptr + nint + 2]
        win = args[nptr + nint + 2:-1]
        q, table, pos = (tensors[p] for p in (ptrs[0], *ptrs[-4:-2]))
        out, ws = (tensors[p] for p in ptrs[-2:])
        b, kvh, g, hd, bs, mb, chunk, n_splits = ints[:8]
        assert q.shape == (b, kvh, g, hd) and table.shape == (b, mb)
        assert (chunk, n_splits) == split_plan(bs, mb, *win)
        assert out.shape == (b, kvh, g, hd) and out.is_contiguous()
        assert ws.shape == (b * kvh * n_splits * g * (hd + 2),)
        assert out.dtype == ws.dtype == torch.float32
        assert scale == pytest.approx(hd ** -0.5)
        pools = [tensors[p] for p in ptrs[1:nptr - 4]]
        if quant:
            bits, gs = ints[8:]
            assert bits == (8 if pools[0].dtype == torch.int8 else 4)
            spec = KVQuantSpec(bits=bits, group_size=gs, head_dim=hd)
            deq = (dequantize_kv(pools[0], pools[2], spec),
                   dequantize_kv(pools[1], pools[3], spec))
        else:
            assert ints[8] == int(pools[0].dtype == torch.bfloat16)
            deq = tuple(p.float() for p in pools)
        kw = dict(zip(("window", "sinks"), win))
        got = split_model(q, *deq, table, pos, softcap=softcap or None,
                          **kw).contiguous()
        ctypes.memmove(out.data_ptr(), got.data_ptr(), got.numel() * 4)
        calls.append(args)
        return 0

    return entry


@pytest.mark.parametrize("window", [None, (9, 6)])
@pytest.mark.parametrize("pool", ["bf16", "fp32", "int8", "int4"])
def test_wrappers_hand_the_kernel_its_arguments(pool, window, monkeypatch):
    """The card path of the wrappers, with a stand-in for the C entry:
    pointers, shapes, the split plan, the output and the workspace (each
    its own fp32 allocation of its size), scale, softcap, window and
    stream in the order the entry takes them; one launch counted per
    call."""
    q, pools, scales, deq, table, pos = _inputs(
        3, EDGE_POSITIONS, pool=pool, window=window and window[0],
        sinks=window[1] if window else 0)
    tensors = {t.data_ptr(): t
               for t in (q, *pools, *scales.values(), table, pos)}
    calls = []
    empty = torch.empty

    def recorded_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        tensors[t.data_ptr()] = t
        return t

    monkeypatch.setattr(torch, "empty", recorded_empty)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    quant = bool(scales)
    name = "_quant_kernel_fn" if quant else "_kernel_fn"
    monkeypatch.setattr(pa, name, lambda windowed: _fake_entry(
        tensors, quant, windowed, calls))
    if quant:
        wrapper, launch = pa.paged_attention_quant, pa._launch_quant
        args = (q, *pools, scales["k_scale"], scales["v_scale"], table, pos)
    else:
        wrapper, launch = pa.paged_attention, pa._launch_float
        args = (q, *pools, table, pos)
    before = wrapper.launches
    got = launch(wrapper, *args, 5.0, window)
    kw = {} if window is None else dict(zip(("window", "sinks"), window))
    assert torch.equal(got, split_model(q, *deq, table, pos, softcap=5.0,
                                        **kw))
    assert len(calls) == 1 and wrapper.launches == before + 1


@pytest.mark.parametrize("case", ["head_dim", "aligned", "group", "block"])
def test_checks_name_the_kernels_limits(case):
    """The wrapper's checks raise on what the kernel does not take: a head
    dim that is not a multiple of 8, a misaligned operand, scale groups of
    fewer than 8 elements, blocks past 2048 tokens."""
    hd = 12 if case == "head_dim" else 16
    bs = 4096 if case == "block" else 4
    q = torch.zeros((2, 2, 2, hd), dtype=torch.bfloat16)
    pool = torch.zeros((5, bs, 2, hd), dtype=torch.bfloat16)
    table = torch.zeros((2, 3), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    if case == "aligned":
        q = torch.zeros((2 * 2 * 2 * hd + 1,), dtype=torch.bfloat16)[1:] \
            .view(2, 2, 2, hd)
    if case == "group":
        codes = torch.zeros((5, bs, 2, hd), dtype=torch.int8)
        sc = torch.zeros((5, bs, 2, 4), dtype=torch.float16)
        pa._check(q, codes, codes, table, pos, quantized=True)
        with pytest.raises(ValueError, match="scale groups"):
            pa._check_scales(q, codes, codes, sc, sc)
        return
    with pytest.raises(ValueError, match={"head_dim": "head_dim",
                                          "aligned": "aligned",
                                          "block": "blocks of"}[case]):
        pa._check(q, pool, pool, table, pos)
