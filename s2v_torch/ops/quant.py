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
needs more than 16 rows and K, N multiples of 8, so other shapes are
zero-padded here (:func:`pad_int8_operands`; zeros add nothing to an int32
sum, so the product is the unpadded one bit for bit) and every width runs,
as JAX's ``int8_dense`` does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from s2v_torch.utils.device import needs_grad

# quantized per block (JAX ``quantize_transformer_params``): ~96% of the
# DiT's linear operations
QUANTIZED_LEAVES = (("attn", "qkv"), ("attn", "to_out"), ("ff", "net_0"), ("ff", "net_2"))
# torch._int_mm on CUDA takes more than this many rows of the first operand,
# and inner and output widths that are multiples of this
_INT_MM_MIN_ROWS = 16
_INT_MM_WIDTH = 8
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


def pad_int8_operands(xq: torch.Tensor, q: torch.Tensor):
    """int8 ``xq [M, K]`` and ``q [N, K]`` zero-padded to the shapes CUDA's
    ``torch._int_mm`` takes: M above 16 rows, K and N to multiples of 8
    (zero columns in both, zero rows of ``q``).  Returns the operands, the
    same tensors where no pad is needed (every 5b and 2b width), so the
    product's first ``M`` rows and ``N`` columns are the unpadded product."""
    m, k = xq.shape
    n = q.shape[0]
    pad_k, pad_n = -k % _INT_MM_WIDTH, -n % _INT_MM_WIDTH
    if pad_k or pad_n:
        q = F.pad(q, (0, pad_k, 0, pad_n))
    if pad_k or m <= _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, pad_k, 0, max(0, _INT_MM_MIN_ROWS + 1 - m)))
    return xq, q


def _int_mm(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K]`` × int8 ``[N, K]``ᵀ -> int32 ``[M, N]``, exact."""
    if xq.is_cuda:
        m, n = xq.shape[0], q.shape[0]
        xq, q = pad_int8_operands(xq, q)
        # q.t() is the column-major [K, N] operand cuBLASLt takes
        out = torch._int_mm(xq.contiguous(), q.t())
        return out if out.shape == (m, n) else out[:m, :n]
    return torch._int_mm(xq.contiguous(), q.t())


def _int8_mm_forward(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, tp=None) -> torch.Tensor:
    """``x @ dequant(q, scale)ᵀ`` through per-token int8 activations, in the
    JAX order of operations (``_int8_mm_impl``): the row amax in x's own
    dtype, then fp32 · (1/127); divide by that scale (not multiply by its
    reciprocal) before the half-to-even round; clamp to ±127; the int32
    product; ``(y · x_scale) · w_scale`` in fp32; cast to x's dtype.

    Row-parallel (``tp``, the ``model`` dim; ``x`` and ``q`` hold this
    rank's input columns): the row amax is the max over every rank's
    columns and the int32 products are summed over the ranks before the
    scales, so the result is the whole product's, bit for bit."""
    # max |x| in one pass (exact in any dtype); x / x_scale promotes to fp32
    # without an fp32 copy of x; int32 · fp32 converts as it multiplies
    amax = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True).float()
    if tp is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=tp.group)
    x_scale = amax * INV_127
    x_scale = torch.where(x_scale == 0, torch.ones_like(x_scale), x_scale)
    xq = torch.div(x, x_scale).round_().clamp_(-127, 127).to(torch.int8)
    lead, k = x.shape[:-1], x.shape[-1]
    acc = _int_mm(xq.reshape(-1, k), q)
    if tp is not None:
        dist.all_reduce(acc, group=tp.group)  # int32: exact
    y = torch.mul(acc, x_scale.reshape(-1, 1)).mul_(scale)
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
    def forward(ctx, x, q, scale, tp):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return _int8_mm_forward(x, q, scale, tp)

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
        return dx.to(ctx.x_dtype).reshape(*lead, q.shape[1]), None, None, None


def int8_dense(x: torch.Tensor, wq: dict, bias=None, tp=None) -> torch.Tensor:
    """Per-token int8 linear: ``x`` ``[..., in]`` against ``wq = {"q" [out,
    in] int8, "scale" [out] fp32}``, in and out in x's dtype, then the bias.
    Differentiable with respect to ``x`` (see :class:`_Int8MM`).  ``tp``:
    row-parallel over the ``model`` dim (see :func:`_int8_mm_forward`)."""
    y = _Int8MM.apply(x, wq["q"], wq["scale"], tp)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _lora_term(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    return ((x @ a.to(x.dtype)) @ b.to(x.dtype)).to(dtype)


def _rank0_bias(bias, tp):
    """A row-parallel linear's bias, added by ``model`` rank 0 only, so the
    ranks' partial sums add up to one bias.  Under autograd every rank
    keeps it in its graph (times 0 off rank 0) and its gradient, whole on
    rank 0, is summed over ``model``."""
    from s2v_torch.parallel.context import copy_to_model

    if bias is None:
        return None
    if needs_grad(bias):
        bias = copy_to_model(bias, tp)
        return bias if tp.rank == 0 else bias * 0
    return bias if tp.rank == 0 else None


def dense(params: dict, x: torch.Tensor, row_parallel=None) -> torch.Tensor:
    """Format-dispatching linear: ``x @ weight.T + bias`` for a
    ``{"weight", "bias"?}`` leaf, :func:`int8_dense` for a ``{"q", "scale",
    "bias"?}`` leaf, in x's dtype.

    An optional ``"lora"`` entry, a tuple of ``(a [in, r], b [r, out])``
    factor pairs with the alpha/r scale folded into ``a``, is applied after
    the linear: ``y += (x @ a) @ b``, both products in x's dtype (an int8
    weight cannot absorb a merged delta).

    ``row_parallel`` (the ``model`` dim of megatron TP): ``x``, the weight's
    columns and ``a``'s rows are this rank's slice of the input; the
    partial outputs are all-reduced (an int8 leaf sums its exact int32
    products, see :func:`int8_dense`, and then its adapters' partial
    terms), the bias added once."""
    from s2v_torch.parallel.context import reduce_from_model

    pairs = params.get("lora", ())
    if "q" in params:
        y = int8_dense(x, params, params.get("bias"), tp=row_parallel)
        if row_parallel is not None and pairs:
            extra = None
            for a, b in pairs:
                term = _lora_term(x, a, b, y.dtype)
                extra = term if extra is None else extra + term
            return y + reduce_from_model(extra, row_parallel)
    else:
        bias = params.get("bias") if row_parallel is None else _rank0_bias(params.get("bias"), row_parallel)
        y = F.linear(x, params["weight"], bias)
    for a, b in pairs:
        y = y + _lora_term(x, a, b, y.dtype)
    if row_parallel is not None and "q" not in params:
        y = reduce_from_model(y, row_parallel)
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
