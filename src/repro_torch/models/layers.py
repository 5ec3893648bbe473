"""Shared model layers: norms, rotary embeddings, the GLU MLPs.

Counterpart of ``repro/models/layers.py``. Plain functions over explicit
params; quantization flows through the ``QuantContext`` (``qc``). Compute is
bf16 with fp32 accumulation and every cast sits where ``repro`` puts it, so
the two packages round at the same points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sites import QuantContext
from repro_torch.kernels.quant_matmul.ops import int_gemm, quant_matmul_qt

COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x, gain, eps=1e-6):
    """fp32 RMS norm times ``(1 + gain)``, cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gain.to(torch.float32))).to(x.dtype)


def qmatmul(qc: QuantContext, name: str, x, w):
    """Quantized matmul over the last axis of ``x``: (..., in) @ (in, out).

    In serve mode a site with an int-code export runs off its codes: with
    an ``.in`` spec the integer GEMM (``int_gemm``: the activation
    quantized per tensor, int8 x int8 products summed in int32; K5/K6 for
    a CUDA tensor), else the fused dequant GEMM (``quant_matmul_qt``:
    K1/K4), each taking its plain version for a CPU tensor. Otherwise the
    input goes through ``qc.act_in`` and the weight through ``qc.weight``,
    and the product is bf16 x bf16 with fp32 accumulation. Returns bf16.
    """
    qw = qc.serving_weight(name)
    if qw is not None:
        plan = qc.int_gemm_plan(name)
        y = quant_matmul_qt(x, qw) if plan is None else int_gemm(x, plan)
        return y.to(COMPUTE_DTYPE)
    x = qc.act_in(name, x)
    wq = qc.weight(name, w)
    # bf16 operands are exact in fp32: an fp32 product is bf16 x bf16 with
    # fp32 accumulation
    y = torch.matmul(x.to(COMPUTE_DTYPE).to(torch.float32),
                     wq.to(COMPUTE_DTYPE).to(torch.float32))
    return y.to(COMPUTE_DTYPE)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def glu_mlp(qc: QuantContext, p, x, kind: str):
    """SwiGLU / GeGLU MLP with quantization sites: the gate's activation
    (SiLU, or GELU with the tanh approximation, ``repro``'s
    ``jax.nn.gelu(approximate=True)``) in fp32, cast to bf16, times the up
    projection."""
    if kind not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"mlp={kind!r} is ported with ROADMAP queue 1 item 14 (other "
            f"block kinds and archs)")
    g = qmatmul(qc, "mlp_gate", x, p["w_gate"])
    u = qmatmul(qc, "mlp_up", x, p["w_up"])
    g32 = g.to(torch.float32)
    act = F.silu(g32) if kind == "swiglu" else F.gelu(g32, approximate="tanh")
    h = act.to(COMPUTE_DTYPE) * u
    h = qc.act("mlp_up", h)
    y = qmatmul(qc, "mlp_down", h, p["w_down"])
    return qc.act("mlp_down", y)


def init_glu_mlp(d_model: int, d_ff: int, *, reps: int, generator, device):
    """Scan-stacked (reps, ...) SwiGLU/GeGLU weights, ``randn /
    sqrt(fan_in)``."""
    def w(shape, fan_in):
        return torch.randn((reps,) + shape, generator=generator,
                           device=device) / fan_in ** 0.5

    return {
        "w_gate": w((d_model, d_ff), d_model),
        "w_up": w((d_model, d_ff), d_model),
        "w_down": w((d_ff, d_model), d_ff),
    }


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
