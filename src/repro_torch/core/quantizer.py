"""Quantization primitives (paper Eq. 1) with STE and learnable ranges.

Counterpart of ``repro/core/quantizer.py``. The quantizer maps ``x`` in
``[alpha, beta]`` onto a ``b``-bit uniform grid::

    Q(x, b, alpha, beta) = alpha + s * round((clip(x) - alpha) / s),
    s = (beta - alpha) / (2^b - 1)

Every step runs in float32 in the same order as ``repro``, and
``torch.round`` rounds half to even like ``jnp.round``, so codes, scales
and biases are bit-equal to ``repro``'s on the same inputs.

``fake_quant`` is the straight-through quantizer of training, an
``autograd.Function`` whose forward is ``quantize`` and whose backward is
``fq_bwd``, ``repro``'s ``_fq_bwd`` line for line: the STE mask on dx and
the LSQ derivative for beta, both in x's dtype (for a bf16 activation
site that means bf16 steps and fractions, as ``repro`` computes them), and
no gradient for the bits (the CGMQ directions move the gates).
"""

from __future__ import annotations

import torch

# Quantization at >= this many bits is an exact pass-through in fp32.
PASSTHROUGH_BITS = 32


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def quantize(x: torch.Tensor, bits, beta, signed: bool) -> torch.Tensor:
    """Pure quantization. ``alpha = -beta`` if signed else ``0``.

    ``bits``/``beta`` broadcast against ``x``. ``bits >= 32`` passes
    through. Computes in fp32 and returns ``x``'s dtype.
    """
    out_dtype = x.dtype
    x = x.to(torch.float32)
    beta = torch.clamp_min(_f32(beta, x), 1e-8)
    alpha = -beta if signed else torch.zeros_like(beta)
    span = beta - alpha
    static = isinstance(bits, (int, float))
    if static:
        # A host-side width (the fixed input bits): decide the pass-through
        # on the host and fill ``n`` on the device. A scalar tensor copied
        # from the host would make the host wait for the card, and dividing
        # by a Python scalar would run on the card as a reciprocal multiply.
        if bits >= PASSTHROUGH_BITS:
            return x.to(out_dtype)
        n = torch.full_like(span, 2.0 ** min(max(float(bits), 2.0), 31.0)
                            - 1.0)
    else:
        bits = _f32(bits, x)
        # Clamp bits into [2, 31] for the arithmetic; pass-through below.
        n = torch.exp2(torch.clamp(bits, 2.0, 31.0)) - 1.0
    s = span / n
    xc = torch.minimum(torch.maximum(x, alpha), beta)
    q = alpha + s * torch.round((xc - alpha) / s)
    if not static:
        q = torch.where(bits >= PASSTHROUGH_BITS, x, q)
    return q.to(out_dtype)


def fq_bwd(x: torch.Tensor, bits, beta: torch.Tensor, signed: bool,
           ct: torch.Tensor, want_dbeta: bool = True):
    """``(dx, dbeta)`` of ``quantize(x, bits, beta, signed)`` for the
    cotangent ``ct``: the straight-through estimator for x (identity inside
    [alpha, beta], zero outside, identity at >= 32 bits) and the
    round-as-constant derivative for beta summed down to beta's shape.
    ``dbeta`` is None unless ``want_dbeta``."""
    dt = x.dtype
    bits = _f32(bits, x)
    beta_c = torch.clamp_min(beta.to(dt), 1e-8)
    alpha = -beta_c if signed else torch.zeros_like(beta_c)
    passthrough = bits >= PASSTHROUGH_BITS

    # STE w.r.t. x: identity inside [alpha, beta], zero outside.
    in_range = (x >= alpha) & (x <= beta_c)
    dx = torch.where(in_range | passthrough, ct, 0.0)
    if not want_dbeta:
        return dx, None

    # LSQ-style derivative w.r.t. beta, n = round((clip(x)-alpha)/s) const:
    #   signed: dq/dbeta = -1 + 2n/(2^b-1); unsigned: n/(2^b-1);
    #   clipped: +1 above, alpha' (-1 signed, 0 unsigned) below.
    nsteps = (torch.exp2(torch.clamp(bits, 2.0, 31.0)) - 1.0).to(dt)
    s = (beta_c - alpha) / nsteps
    xc = torch.minimum(torch.maximum(x, alpha), beta_c)
    frac = torch.round((xc - alpha) / s) / nsteps
    if signed:
        dq_db_in, dq_db_lo = -1.0 + 2.0 * frac, -1.0
    else:
        dq_db_in, dq_db_lo = frac, 0.0
    dq_db = torch.where(x > beta_c, 1.0,
                        torch.where(x < alpha, dq_db_lo, dq_db_in))
    dq_db = torch.where(passthrough, 0.0, dq_db)
    full = ct * dq_db
    # sum the cotangent down to beta's shape (beta broadcasts against x)
    extra = full.ndim - beta.ndim
    dims = tuple(range(extra)) + tuple(
        extra + i for i, d in enumerate(beta.shape) if d == 1)
    dbeta = full.sum(dim=dims) if dims else full
    return dx, dbeta.reshape(beta.shape).to(beta.dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, beta, signed):
        ctx.save_for_backward(x, beta)
        ctx.bits, ctx.signed = bits, signed
        return quantize(x, bits, beta, signed)

    @staticmethod
    def backward(ctx, ct):
        x, beta = ctx.saved_tensors
        dx, dbeta = fq_bwd(x, ctx.bits, beta, ctx.signed, ct,
                           want_dbeta=ctx.needs_input_grad[2])
        return dx, None, dbeta, None


def fake_quant(x: torch.Tensor, bits, beta, signed: bool) -> torch.Tensor:
    """STE fake quantization: forward ``quantize``, backward ``fq_bwd``.

    ``bits`` is a host number or a tensor that broadcasts against ``x``
    (it gets no gradient); ``beta`` a tensor that does.
    """
    return _FakeQuant.apply(x, bits, torch.as_tensor(
        beta, dtype=torch.float32, device=x.device), signed)


def affine_grid(bits, beta, signed: bool):
    """The ``(scale, bias)`` of ``quantize_to_int``'s centered-code grid:
    ``codes * scale + bias`` reconstructs the quantized value."""
    beta = torch.clamp_min(torch.as_tensor(beta, dtype=torch.float32), 1e-8)
    alpha = -beta if signed else torch.zeros_like(beta)
    bits_f = _f32(bits, beta)
    n = torch.exp2(bits_f) - 1.0
    s = (beta - alpha) / n
    offset = torch.exp2(bits_f - 1.0)
    return s, alpha + offset * s


def quantize_to_int(x: torch.Tensor, bits, beta, signed: bool):
    """Export path: ``(codes, scale, bias)`` with ``codes * scale + bias``
    on the grid of ``quantize(x, bits, beta, signed)``.

    Codes are centered (``[-2^(b-1), 2^(b-1)-1]``); their dtype is int8 iff
    every element is <= 8 bits, else int32.
    """
    beta = torch.clamp_min(_f32(beta, x), 1e-8)
    alpha = -beta if signed else torch.zeros_like(beta)
    bits_f = _f32(bits, x)
    s, bias = affine_grid(bits_f, beta, signed)
    x = x.to(torch.float32)
    raw = torch.round((torch.minimum(torch.maximum(x, alpha), beta) - alpha) / s)
    codes = raw - torch.exp2(bits_f - 1.0)
    max_bits = bits if isinstance(bits, int) else int(bits_f.max().item())
    dtype = torch.int8 if max_bits <= 8 else torch.int32
    return codes.to(dtype), s, bias
