"""The numerics of K7's tensor-core kernel, emulated in torch on the CPU.

The tensor cores take bf16 operands and sum in fp32. For S = Q K^T that is
exact where it matters: q, k and v are bf16 already, and a bf16 x bf16
product is exact in fp32. For O = P V the probabilities P must be bf16
too, and one rounding of P (2^-9 relative) moves outputs near zero, whose
bf16 ulp is tiny, by many ulps: beyond K7's bf16 tolerance
(``ref.k7_tolerance``: one bf16 ulp of the output plus 1e-5 of max|v|).
The kernel therefore splits P into ``P_hi = bf16(P)`` and
``P_lo = bf16(P - P_hi)`` and sums the two products in fp32.

``tc_emulation`` walks the kernel's dataflow: bf16 operands, fp32 Q K^T
over BK-key tiles, the scale (and softcap) with log2(e) folded in, the
mask, the online softmax in exp2 with its rescaling, P split in two bf16
terms, both products summed into one fp32 accumulator, the output divided
by max(l, 1e-30) and rounded to bf16. These tests hold it to
``flash_attention_ref`` within that tolerance, on cut-down K7 cases, and
show that the single-bf16-P variant breaks it: the reason the kernel
splits P.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _port_env import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     flash_attention_ref,
                                                     k7_tolerance)

LOG2E = 1.4426950408889634


def tc_emulation(q, k, v, *, causal=True, window=None, sinks=0,
                 softcap=None, bk=64, split=True):
    """K7's tensor-core dataflow on (B, Hq, S, D) / (B, Hkv, S, D) bf16
    operands -> (B, Hq, S, D) bf16. ``split=False`` rounds P once to
    bf16 instead of carrying it as two bf16 terms."""
    b, hq, s, d = q.shape
    groups = hq // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(groups, dim=1) for t in (k, v))
    mask = attention_mask(s, causal=causal, window=window, sinks=sinks)
    if softcap is None:
        scale, cap_log2e = torch.tensor(d ** -0.5 * LOG2E), None
    else:
        scale = torch.tensor(d ** -0.5 / softcap)
        cap_log2e = torch.tensor(softcap * LOG2E)
    m = torch.full((b, hq, s), -math.inf)
    l = torch.zeros((b, hq, s))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, bk):
        sc = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        x = sc * scale
        if cap_log2e is not None:
            x = torch.tanh(x) * cap_log2e
        x = torch.where(mask[:, k0:k0 + bk], x, -math.inf)
        new = torch.maximum(m, x.amax(-1))
        use = torch.where(new == -math.inf, 0.0, new)
        alpha = torch.exp2(m - use)
        p = torch.exp2(x - use[..., None])
        l = alpha * l + p.sum(-1)
        vt = vf[:, :, k0:k0 + bk]
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = alpha[..., None] * acc + pv
        m = new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def excess(got, want, v):
    """Each element's error over K7's bf16 tolerance (``k7_tolerance``: one
    bf16 ulp of the plain output plus K7_BF16_RTOL of max|v|): the
    emulation passes where every value is at most 1."""
    return (got.float() - want.float()).abs() / k7_tolerance(want, v)


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
        np.float32)).to(torch.bfloat16) for h in (hq, hkv, hkv))


# (name, hd, S, window, sinks, softcap, BK): the kernel's key tile per
# head dim (64 at hd 256, 128 below); K7's chip cases cut to S <= 512 and
# 4 heads over 2: tinyllama's hd 64, gemma2's hd 256 with its softcap,
# global and local, and the ragged window-64 + 5-sinks case
TC_CASES = [
    ("hd64", 64, 512, None, 0, None, 128),
    ("hd256-softcap", 256, 512, None, 0, 50.0, 64),
    ("hd256-window", 256, 512, 128, 0, 50.0, 64),
    ("ragged-sinks", 256, 333, 64, 5, 50.0, 64),
    ("hd64-ragged-sinks", 64, 333, 64, 5, None, 128),
]


@pytest.mark.parametrize("case", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_split_probabilities_hold_the_k7_tolerance(case):
    _, hd, s, window, sinks, cap, bk = case
    q, k, v = _qkv(hd + s, 1, 4, 2, s, hd)
    kw = {"window": window, "sinks": sinks, "softcap": cap}
    want = flash_attention_ref(q, k, v, **kw)
    got = tc_emulation(q, k, v, bk=bk, **kw)
    assert float(excess(got, want, v).max()) <= 1.0


@pytest.mark.parametrize("case", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_single_bf16_probabilities_break_the_k7_tolerance(case):
    """P rounded once to bf16 misses the tolerance on many outputs (those
    near zero): the measured reason for the split."""
    _, hd, s, window, sinks, cap, bk = case
    q, k, v = _qkv(hd + s, 1, 4, 2, s, hd)
    kw = {"window": window, "sinks": sinks, "softcap": cap}
    want = flash_attention_ref(q, k, v, **kw)
    over = excess(tc_emulation(q, k, v, bk=bk, split=False, **kw), want, v)
    assert float((over > 1.0).float().mean()) > 0.01
    assert float(over.max()) > 4.0


@settings(max_examples=12, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), s=st.integers(1, 200),
       hd=st.sampled_from([64, 128, 256]), causal=st.booleans(),
       window=st.sampled_from([None, 1, 17, 64]),
       sinks=st.sampled_from([0, 3, 70]),
       cap=st.sampled_from([None, 50.0]))
def test_split_probabilities_hold_the_tolerance_on_random_cases(
        seed, s, hd, causal, window, sinks, cap):
    """Any S against the kernel's tiles (BK 64 at hd 256, 128 below),
    causal or not, windows with sinks in and across a tile, with and
    without the softcap, GQA 2 over 1."""
    q, k, v = _qkv(seed, 1, 2, 1, s, hd)
    kw = {"causal": causal, "window": window,
          "sinks": sinks if window else 0, "softcap": cap}
    want = flash_attention_ref(q, k, v, **kw)
    got = tc_emulation(q, k, v, bk=64 if hd == 256 else 128, **kw)
    assert float(excess(got, want, v).max()) <= 1.0
