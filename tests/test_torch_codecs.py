"""The port's integer codecs against repro's: sub-byte weight packing
(``quant/pack.py``) and the KV-cache codec (``quant/kv.py``).

Same inputs, made from a seed with numpy, go through ``repro`` (JAX, on the
CPU) and ``repro_torch`` (CPU tensors). Both are integer bit operations and
fp32/fp16 arithmetic in the same order, so the tolerance is zero: packed
bytes, codes and scales are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # container without hypothesis: deterministic replay
    from _hyp_fallback import given, settings
    from _hyp_fallback import strategies as st

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.quant import kv as jkv
from repro.quant import pack as jpack
from repro_torch.quant import kv as tkv
from repro_torch.quant import pack as tpack

# a few examples each: first calls compile under JAX, so no deadline
PROP = settings(max_examples=6, deadline=None, database=None)


def _eq(a, t: torch.Tensor):
    a = np.asarray(a)
    b = t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@PROP
@given(k=st.integers(1, 37), n=st.integers(1, 9),
       bits=st.sampled_from([2, 4]), stacked=st.booleans(),
       seed=st.integers(0, 2**16))
def test_pack_codes_bit_equal_repro(k, n, bits, stacked, seed):
    """Odd and ragged K, with and without a leading stack axis."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    codes = rng.integers(lo, hi + 1, (3, k, n) if stacked else (k, n)
                         ).astype(np.int8)
    want = jpack.pack_codes(jnp.asarray(codes), bits)
    got = tpack.pack_codes(torch.from_numpy(codes), bits)
    _eq(want, got)
    assert got.is_contiguous()
    assert got.shape[-2] == tpack.packed_rows(k, bits) \
        == jpack.packed_rows(k, bits)
    _eq(jpack.unpack_codes(want, bits, k), tpack.unpack_codes(got, bits, k))
    _eq(codes, tpack.unpack_codes(got, bits, k))


def test_pack_codes_of_transposed_codes():
    """The tied head packs codes of ``embed.T``: strides do not matter."""
    rng = np.random.default_rng(0)
    codes = rng.integers(-2, 2, (9, 14)).astype(np.int8)
    t = torch.from_numpy(codes.T.copy()).T
    assert not t.is_contiguous()
    _eq(jpack.pack_codes(jnp.asarray(codes), 2), tpack.pack_codes(t, 2))
    with pytest.raises(ValueError, match="2 or 4"):
        tpack.pack_codes(t, 8)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_kv_codec_bit_equal_repro(bits, hd):
    """Codes and fp16 scales, dequantized values and unpacked nibbles, on
    vectors with an all-zero group (the scale floor) and an outlier."""
    rng = np.random.default_rng(hd + bits)
    gs = min(32, hd)
    x = (rng.normal(size=(3, 5, 2, hd)) * 2).astype(np.float32)
    x[0, 0, 0, :gs] = 0.0
    x[1, 2, 1, 3] = 40.0
    jspec = jkv.KVQuantSpec(bits=bits, group_size=gs, head_dim=hd)
    tspec = tkv.KVQuantSpec(bits=bits, group_size=gs, head_dim=hd)
    assert (tspec.packed_head, tspec.num_groups, tspec.bytes_per_vector()) \
        == (jspec.packed_head, jspec.num_groups, jspec.bytes_per_vector())
    for dtype in (np.float32, "bf16"):
        xj = jnp.asarray(x) if dtype is np.float32 \
            else jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x) if dtype is np.float32 \
            else torch.from_numpy(x).to(torch.bfloat16)
        jc, js = jkv.quantize_kv(xj, jspec)
        tc, ts = tkv.quantize_kv(xt, tspec)
        _eq(jc, tc)
        _eq(js, ts)
        _eq(jkv.dequantize_kv(jc, js, jspec), tkv.dequantize_kv(tc, ts, tspec))
        if bits == 4:
            _eq(jkv.unpack_int4(jc, hd).astype(jnp.int32),
                tkv.unpack_int4(tc, hd))
        # exactly idempotent, as repro's codec
        tc2, ts2 = tkv.quantize_kv(tkv.dequantize_kv(tc, ts, tspec), tspec)
        assert torch.equal(tc, tc2) and torch.equal(ts, ts2)


def test_kv_ragged_group_spec_from_cache_and_report():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 20)).astype(np.float32)
    jspec = jkv.KVQuantSpec(bits=4, group_size=8, head_dim=20)
    tspec = tkv.KVQuantSpec(bits=4, group_size=8, head_dim=20)
    jc, js = jkv.quantize_kv(jnp.asarray(x), jspec)
    tc, ts = tkv.quantize_kv(torch.from_numpy(x), tspec)
    _eq(jc, tc)
    _eq(js, ts)
    _eq(jkv.dequant_codes(jkv.unpack_int4(jc, 20), js, 20, 8),
        tkv.dequant_codes(tkv.unpack_int4(tc, 20), ts, 20, 8))
    entry = {"k": torch.zeros((2, 4, 2, 32), dtype=torch.uint8),
             "k_scale": torch.zeros((2, 4, 2, 2), dtype=torch.float16)}
    assert tkv.spec_from_cache(entry, 64) == tkv.KVQuantSpec(4, 32, 64)
    assert tkv.spec_from_cache({"k": entry["k"]}, 64) is None
    kinds = ["global"] * 22
    for spec_args, dtype in (((8, 32, 64), "int8"), ((4, 32, 64), "int4"),
                             (None, "bf16")):
        js_ = None if spec_args is None else jkv.KVQuantSpec(*spec_args)
        ts_ = None if spec_args is None else tkv.KVQuantSpec(*spec_args)
        assert tkv.kv_cache_report(kinds, 4, 64, spec=ts_, kv_dtype=dtype) \
            == jkv.kv_cache_report(kinds, 4, 64, spec=js_, kv_dtype=dtype)
    # tinyllama-1.1b's cache: 22 layers, 4 KV heads, head_dim 64, groups 32
    assert tkv.kv_cache_report(
        kinds, 4, 64, spec=tkv.KVQuantSpec(4, 32, 64))[
            "bytes_per_cached_token"] == 6336
    assert tkv.kv_cache_report(
        kinds, 4, 64, spec=tkv.KVQuantSpec(8, 32, 64))[
            "bytes_per_cached_token"] == 11968
    assert tkv.kv_cache_report(kinds, 4, 64)["bytes_per_cached_token"] \
        == 22528
