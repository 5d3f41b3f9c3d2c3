"""The format-dispatching dense layer and the int8 linears (counterpart of
``s2v_tpu/ops/quant.py``).

Opt-in int8 serving and QLoRA: the DiT's large projections (fused qkv, the
attention output, both feed-forward linears) run as int8 × int8 products
with per-output-channel weight scales and per-token dynamic activation
scales; adaLN modulation, the patch embedding and the output head stay in
the model dtype.  ``quantize_transformer_params(params)`` makes such a tree
and ``dense`` dispatches on the leaf's format, so bf16/fp32 and int8 trees
flow through the same model code.

Leaves: ``{"weight" [out, in], "bias"?}`` in the model dtype, or
``{"q" [out, in] int8, "scale" [out] fp32, "bias"?}``.  The int8 product is
``torch._int_mm`` (int32 accumulation), a plain matrix product that the JAX
package, too, leaves outside any kernel (``lax.dot_general``); on CUDA it
needs more than 16 rows (fewer are zero-padded here) and K, N multiples of 8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# quantized per block (JAX ``quantize_transformer_params``): ~96% of the
# DiT's linear operations
QUANTIZED_LEAVES = (("attn", "qkv"), ("attn", "to_out"), ("ff", "net_0"), ("ff", "net_2"))
# torch._int_mm on CUDA takes more than this many rows of the first operand
_INT_MM_MIN_ROWS = 16
# amax / 127 as XLA compiles the JAX package's ``/ 127.0``: a multiply by the
# fp32 reciprocal.  Written as a multiply it is the same on the CPU and on
# CUDA (PyTorch's CUDA division by a Python scalar multiplies by the
# reciprocal, its CPU division divides).
INV_127 = 1.0 / 127.0


def quantize_weight_int8(weight: torch.Tensor) -> dict:
    """``[..., out, in]`` -> ``{"q": int8 [..., out, in], "scale": fp32
    [..., out]}``, symmetric per output channel: the JAX function's values
    (its kernel is ``[in, out]``; the amax runs over ``in`` in both)."""
    w32 = weight.float()
    scale = w32.abs().amax(-1) * INV_127
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(w32 / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _int_mm(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K]`` × int8 ``[N, K]``ᵀ -> int32 ``[M, N]``, exact."""
    m, k = xq.shape
    n = q.shape[0]
    if xq.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 linears on CUDA need in/out widths that are multiples of 8; got {k} -> {n}")
        if m <= _INT_MM_MIN_ROWS:
            pad = xq.new_zeros((_INT_MM_MIN_ROWS + 1 - m, k))
            return torch._int_mm(torch.cat([xq, pad]), q.t())[:m]
    # q.t() is the column-major [K, N] operand cuBLASLt takes
    return torch._int_mm(xq.contiguous(), q.t())


def _int8_mm_forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q, scale)ᵀ`` through per-token int8 activations, in the
    JAX order of operations (``_int8_mm_impl``): the row amax in x's own
    dtype, then fp32 · (1/127); divide by that scale (not multiply by its
    reciprocal) before the half-to-even round; clamp to ±127; the int32
    product; ``(y · x_scale) · w_scale`` in fp32; cast to x's dtype."""
    # max |x| in one pass (exact in any dtype); x / x_scale promotes to fp32
    # without an fp32 copy of x; int32 · fp32 converts as it multiplies
    x_scale = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True).float() * INV_127
    x_scale = torch.where(x_scale == 0, torch.ones_like(x_scale), x_scale)
    xq = torch.div(x, x_scale).round_().clamp_(-127, 127).to(torch.int8)
    lead, k = x.shape[:-1], x.shape[-1]
    y = torch.mul(_int_mm(xq.reshape(-1, k), q), x_scale.reshape(-1, 1)).mul_(scale)
    return y.to(x.dtype).reshape(*lead, q.shape[0])


class _Int8MM(torch.autograd.Function):
    """The int8 product with a straight-through backward (JAX ``_int8_mm``,
    ``s2v_tpu/ops/quant.py:32-95``): ``round`` has a zero gradient, so the
    chain rule would stop every gradient that crosses a frozen int8 linear;
    the backward instead treats the op as the linear map it approximates,
    ``dx = (g · w_scale) @ q``, with ``g · w_scale`` in g's dtype, both
    operands rounded to bf16 (as in JAX, for fp32 inputs too) and fp32
    accumulation.  q and scale are frozen and get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return _int8_mm_forward(x, q, scale)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        lead, n = g.shape[:-1], g.shape[-1]
        gs = (g * scale.to(g.dtype)).to(torch.bfloat16).reshape(-1, n)
        if g.is_cuda:
            # |q| <= 127 is exact in bf16; a bf16 product with an fp32 result:
            # cuBLAS then reduces in fp32 too (a bf16 result may reduce
            # split-K partial sums in bf16)
            dx = torch.mm(gs, q.to(torch.bfloat16), out_dtype=torch.float32)
        else:
            # products of bf16 values and int8 are exact in fp32, so upcasting
            # first gives the fp32-accumulated result on the CPU
            dx = gs.float() @ q.float()
        return dx.to(ctx.x_dtype).reshape(*lead, q.shape[1]), None, None


def int8_dense(x: torch.Tensor, wq: dict, bias=None) -> torch.Tensor:
    """Per-token int8 linear: ``x`` ``[..., in]`` against ``wq = {"q" [out,
    in] int8, "scale" [out] fp32}``, in and out in x's dtype, then the bias.
    Differentiable with respect to ``x`` (see :class:`_Int8MM`)."""
    y = _Int8MM.apply(x, wq["q"], wq["scale"])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Format-dispatching linear: ``x @ weight.T + bias`` for a
    ``{"weight", "bias"?}`` leaf, :func:`int8_dense` for a ``{"q", "scale",
    "bias"?}`` leaf, in x's dtype.

    An optional ``"lora"`` entry, a tuple of ``(a [in, r], b [r, out])``
    factor pairs with the alpha/r scale folded into ``a``, is applied after
    the linear: ``y += (x @ a) @ b``, both products in x's dtype (an int8
    weight cannot absorb a merged delta)."""
    if "q" in params:
        y = int8_dense(x, params, params.get("bias"))
    else:
        y = F.linear(x, params["weight"], params.get("bias"))
    for a, b in params.get("lora", ()):
        y = y + ((x @ a.to(x.dtype)) @ b.to(x.dtype)).to(y.dtype)
    return y


def quantize_transformer_params(params: dict) -> dict:
    """Quantize each block's fused qkv, attention output and both
    feed-forward linears (biases kept as they are); every other leaf is
    shared with ``params``, which is not modified."""
    out = dict(params)
    blocks = []
    for layer in params["blocks"]:
        layer = dict(layer)
        for group, name in QUANTIZED_LEAVES:
            layer[group] = dict(layer[group])
            leaf = layer[group][name]
            qleaf = quantize_weight_int8(leaf["weight"])
            if "bias" in leaf:
                qleaf["bias"] = leaf["bias"]
            layer[group][name] = qleaf
        blocks.append(layer)
    out["blocks"] = blocks
    return out
