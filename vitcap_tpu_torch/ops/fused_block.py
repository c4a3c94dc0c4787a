"""Fused ViT and BERT blocks, composed from the gemm, layer_norm and
attention kernels.

fused_vit_block is the composition of vitcap_tpu/ops/fused_block.py
_split_block_fwd ([LN1 + qkv] | attention | [proj + residual + LN2 + MLP +
residual]); fused_bert_block that of _bert_split_fwd ([qkv] | attention +
bias | [out-dense + post-LN1 + MLP + post-LN2]).  Each block launches 4 gemm,
2 layer_norm and 1 attention kernel on a CUDA device; on the CPU the same
composition runs the kernels' plain versions.

Past 1024 padded tokens (a 512-px image: 1025 tokens, Lp 1152) the same
composition stands for the TPU package's monolithic q-tiled kernels (K10:
_block_kernel, reached through _fused_block_fwd, and _bert_kernel, through
_fused_bert_fwd).  Those compute what the split kernels compute, rounded at
the same points, with the queries tiled by 128 to bound the TPU's f32 score
slab; the attention kernel here tiles queries by 64 and streams the keys at
any length, so nothing of that tiling carries over.  The split train blocks
cover 16-aligned lengths up to 1024, as the TPU package's do: a train call
past 1024 takes the plain chain of models.layers, whose attention is the
packed route (ops/flash_attention.py).  takes_split_train says which of
the two a train call takes.

Rounding follows the TPU kernels (see ops/gemm.py): the ViT gemms and the
BERT qkv round each product to the compute dtype and add bias and residual
in it; the BERT tail keeps each sublayer sum in f32 for its post-LayerNorm.

fused_vit_attn (with vit_attention_residual, its adapter for a ViTBlock)
is K11, vitcap_tpu/ops/fused_block.py:430: the attention half of the ViT
block, LN1 + qkv | attention | proj + residual, with a backward that
recomputes the plain chain as the TPU package's does.  tail_train is K12,
:831 _tail_train_kernel: the block's tail that also returns y1 and the
pre-GELU fc1 output, the same code as the train block's forward tail.
ops.call_counts() counts their CUDA calls.

The GEMM weights are cast (and BERT's q/k/v concatenated) once per module
and compute dtype, not per call; the cache is remade when a parameter is
replaced or changed in place (a checkpoint load).  These inference blocks
have no backward: under grad they raise, and gradient-carrying callers take
the train blocks below, or fused_vit_block_train (cfg.train_fused_blocks:
the inference kernels forward, the plain chain recomputed backward, as the
TPU package's custom_vjp does).

split_vit_block_train and split_bert_layer_train are the train blocks, the
ports of vitcap_tpu/ops/fused_block.py:959 split_vit_block_train and :1225
split_bert_layer_train: the same kernels forward (LayerNorm with row
statistics and the gemm's pre-GELU output for K6; for K7 the gemm's
dropout epilogue; attention with in-kernel prob dropout for K8), saving the
residuals the TPU package saves, and an analytic backward (torch.autograd.
Function): the d-GEMMs are plain matrix products with f32 results, as XLA's
are in the TPU package, and the attention backward is the attention_bwd
kernel.  Cotangents travel in the compute dtype where the TPU package casts
them.  They take the f32 parameters and return f32 parameter gradients.

Tensor parallelism (parallel/mesh.py shard_params): a block that carries a
TPShard holds its rank's heads of qkv (or q, k, v), its MLP columns of
fc1 and the matching columns of proj / out-dense and fc2.  Every route
runs the same kernels on the local heads and widths: attention on
tp.heads heads (its dropout salted with the global head), and each
row-split product as an f32 partial sum (gemm.row_gemm), summed over the
model axis before its bias and residual are added once and the
LayerNorm reads the full sum.  The train blocks' backwards also sum the
two partial input gradients of the column-split products (before LN2's
and LN1's backward in the ViT block, the fc1 input gradient and dx in the
BERT layer).  Under a shard the BERT hidden dropout follows the sum: it
runs in epilogue_plain with dropout.hidden_keep over the full width, the
kernel epilogue's bits.  The num_heads a caller passes is the model's;
the block runs tp.heads of them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import dropout
from ..parallel.tensor_parallel import (all_reduce_tp, local_heads,
                                        salt_heads, tp_of)
from .attention import MAX_LP, attention, attention_plain
from .attention_bwd import attention_bwd
from .gemm import gemm, gemm_plain, row_gemm
from .layer_norm import layer_norm, layer_norm_plain

# the kernels a composition launches, and their plain versions
KERNELS = (gemm, layer_norm, attention)
PLAIN = (gemm_plain, layer_norm_plain, attention_plain)
# CUDA calls of the compositions that stand for one TPU kernel each
# (fused_vit_attn: K11, 4 launches; tail_train: K12, 4 launches)
calls = {"fused_vit_attn": 0, "tail_train": 0}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_len(L: int) -> int:
    """Padded token length, the rule of the TPU package's pad_len: at least
    64 (the block dispatch gate) and 16-aligned up to 1024, 128-aligned
    beyond (577 -> 592, 628 -> 640)."""
    lp = max(64, _round_up(L, 16))
    return lp if lp <= MAX_LP else _round_up(L, 128)


def takes_split_train(L: int) -> bool:
    """Whether a train call of L tokens takes the split train blocks: L at
    least 64, 16-aligned and at most MAX_LP (the gates of
    vitcap_tpu/models/layers.py:248 and :526-528).  Any other train call
    takes the plain chain of models.layers, whose self-attention is the
    packed route from 64 tokens on."""
    return 64 <= L <= MAX_LP and L % 16 == 0


def _refuse_grad(name: str, p, x: torch.Tensor) -> None:
    """The inference blocks launch kernels with no backward: under grad mode
    with anything requiring grad they would drop every gradient silently,
    so they raise instead."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in p.parameters())):
        raise RuntimeError(
            f"{name} has no backward; gradient-carrying callers take "
            f"split_vit_block_train / split_bert_layer_train (the train "
            f"route of models.layers)")


def _block_weights(p, dt: torch.dtype, build):
    """build(p, dt) -> tuple of tensors, cached on the module p."""
    stamp = (dt,) + tuple((t.data_ptr(), t._version) for t in p.parameters())
    hit = p.__dict__.get("_fused_weights")
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, build(p, dt))
        p.__dict__["_fused_weights"] = hit
    return hit[1]


def _vit_weights(p, dt):
    return tuple(m.weight.to(dt) for m in (p.attn.qkv, p.attn.proj,
                                           p.mlp.fc1, p.mlp.fc2))


def _bert_weights(p, dt):
    ps = p.attention.self
    qkv = (ps.query, ps.key, ps.value)
    return (torch.cat([m.weight for m in qkv]).to(dt),
            torch.cat([m.bias for m in qkv]),
            p.attention.output.dense.weight.to(dt),
            p.intermediate.dense.weight.to(dt),
            p.output.dense.weight.to(dt))


def _vit_attention(ops, x2, B, L, num_heads, eps, n1w, n1b, wqkv, bqkv):
    """LN1, the qkv gemm (K1) and attention (K2) of a ViT block over x2
    (B * Lp, H) with L valid tokens per image -> the attention output (B *
    Lp, Hl), Hl the width of wqkv's num_heads heads (H unsplit).  ops:
    KERNELS or PLAIN."""
    gemm_, layer_norm_, attention_ = ops
    ln1 = layer_norm_(x2, n1w, n1b, eps, x2.dtype)
    slab = gemm_(ln1, wqkv, bqkv)
    return attention_(slab.view(B, -1, slab.shape[1]), num_heads,
                      L).reshape(-1, slab.shape[1] // 3)


def _vit_tail(ops, x2, attn, eps, wp, bp, n2w, n2b, w1, b1, w2, b2,
              stats=False, keep_pre=False, tp=None):
    """K3's tail over rows: y1 = x2 + proj(attn); LN2 (its f32 row
    statistics too when `stats`); fc1 + GELU (the pre-GELU fc1 output kept
    when `keep_pre`); out = y1 + fc2.  -> (out, y1, pre1, mu2, rs2), the
    last three None when not asked for.  ops: KERNELS or PLAIN; tp: the
    block's TPShard (proj and fc2 summed over the model axis)."""
    gemm_, layer_norm_ = ops[:2]
    dt = x2.dtype
    y1 = row_gemm(gemm_, tp, attn, wp, bp, residual=x2)
    if stats:
        ln2, mu2, rs2 = layer_norm_(y1, n2w, n2b, eps, dt, stats=True)
    else:
        ln2, mu2, rs2 = layer_norm_(y1, n2w, n2b, eps, dt), None, None
    pre1 = (torch.empty((y1.shape[0], w1.shape[0]), dtype=dt,
                        device=y1.device) if keep_pre else None)
    h = gemm_(ln2, w1, b1, gelu=True, pre_out=pre1)
    return row_gemm(gemm_, tp, h, w2, b2, residual=y1), y1, pre1, mu2, rs2


def fused_vit_block(p, x: torch.Tensor, num_heads: int, ln_eps: float,
                    l_actual: int = 0) -> torch.Tensor:
    """One pre-norm ViT block (bias-free, dropout-free).  p is a ViTBlock
    module.  l_actual > 0: x is already padded to pad_len with that many
    valid rows (the caller hoisted the pad out of its block loop)."""
    _refuse_grad("fused_vit_block", p, x)
    tp = tp_of(p)
    num_heads = local_heads(tp, num_heads)
    B, L, H = x.shape
    if l_actual:
        if L % 16 or (L > MAX_LP and L % 128):
            raise ValueError("pre-padded input must be pad_len-aligned")
        Lp, pad = L, 0
        L = l_actual
    else:
        Lp = pad_len(L)
        pad = Lp - L
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
    wqkv, wproj, w1, w2 = _block_weights(p, x.dtype, _vit_weights)
    x2 = x.contiguous().view(B * Lp, H)
    attn = _vit_attention(KERNELS, x2, B, L, num_heads, ln_eps,
                          p.norm1.weight, p.norm1.bias, wqkv, p.attn.qkv.bias)
    out = _vit_tail(KERNELS, x2, attn, ln_eps, wproj, p.attn.proj.bias,
                    p.norm2.weight, p.norm2.bias, w1, p.mlp.fc1.bias, w2,
                    p.mlp.fc2.bias, tp=tp)[0].view(B, Lp, H)
    return out[:, :L] if pad else out


class _FusedViTBlockTrain(torch.autograd.Function):
    """cfg.train_fused_blocks: the TPU package's fused_vit_block custom_vjp
    (vitcap_tpu/ops/fused_block.py:787-824).  Forward: the inference block
    (fused_vit_block: K1-K3, K10a past 1024 padded tokens), saving only x
    and the block's parameters.  Backward: _blk_vjp_bwd, autograd through
    the plain chain (models.layers._vit_block_plain) on x[:, :l_actual]:
    a train call, so its attention takes the packed route (K8 non-slab
    forward and backward); the padded rows get a zero gradient."""

    @staticmethod
    def forward(ctx, x, p, num_heads, eps, l_actual, *prm):
        ctx.save_for_backward(x, *prm)
        ctx.cfg = (p, num_heads, eps, l_actual)
        return fused_vit_block(p, x, num_heads, eps, l_actual)

    @staticmethod
    def backward(ctx, g):
        from ..models.layers import _vit_block_plain
        p, num_heads, eps, l_actual = ctx.cfg
        x = ctx.saved_tensors[0].detach().requires_grad_(
            ctx.needs_input_grad[0])
        prm = _vit_params(p)          # the tensors _vit_block_plain reads
        wrt = [t for t, need in zip((x,) + prm, ctx.needs_input_grad[:1]
                                    + ctx.needs_input_grad[5:]) if need]
        with torch.enable_grad():
            xs, gs = (x[:, :l_actual], g[:, :l_actual]) if l_actual else (x, g)
            out = _vit_block_plain(p, xs, num_heads, eps)
            got = iter(torch.autograd.grad(out, wrt, gs.to(out.dtype)))
        dx = next(got) if ctx.needs_input_grad[0] else None
        return (dx, None, None, None, None,
                *(next(got) if need else None
                  for need in ctx.needs_input_grad[5:]))


def fused_vit_block_train(p, x: torch.Tensor, num_heads: int, ln_eps: float,
                          l_actual: int = 0) -> torch.Tensor:
    """fused_vit_block with a backward (cfg.train_fused_blocks): the
    inference kernels forward, the plain chain recomputed backward.  p a
    ViTBlock module, x (B, L, H) pre-padded to pad_len with l_actual valid
    rows (0: all rows, or x unpadded).  Under a tensor-parallel shard it
    runs the rank's heads, as the blocks it composes do."""
    return _FusedViTBlockTrain.apply(x, p, num_heads, ln_eps, l_actual,
                                     *_vit_params(p))


def local_bias(bias, tp):
    """A per-head (B, nH, L, L) bias cut to the shard's heads (a
    head-broadcast or absent bias as it is)."""
    if tp is None or bias is None or bias.shape[1] == 1:
        return bias
    return bias[:, tp.head_offset:tp.head_offset + tp.heads]


def fused_bert_block(p, x: torch.Tensor, bias: torch.Tensor, num_heads: int,
                     ln_eps: float) -> torch.Tensor:
    """One post-norm BERT layer with an additive (B, 1, L, L) attention
    bias (deterministic path).  p is a BertLayer module."""
    _refuse_grad("fused_bert_block", p, x)
    tp = tp_of(p)
    num_heads = local_heads(tp, num_heads)
    bias = local_bias(bias, tp)
    B, L, H = x.shape
    Lp = pad_len(L)
    pad = Lp - L
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        bias = F.pad(bias, (0, pad, 0, pad))
    dt = x.dtype
    wqkv, bqkv, wo, w1, w2 = _block_weights(p, dt, _bert_weights)
    po = p.attention.output
    x2 = x.contiguous().view(B * Lp, H)
    slab = gemm(x2, wqkv, bqkv)
    attn = attention(slab.view(B, Lp, slab.shape[1]), num_heads, L,
                     bias.float().contiguous())
    s1 = row_gemm(gemm, tp, attn.view(B * Lp, -1), wo, po.dense.bias,
                  residual=x2, f32_sum=True, out_f32=True)
    y = layer_norm(s1, po.LayerNorm.weight, po.LayerNorm.bias, ln_eps, dt)
    h = gemm(y, w1, p.intermediate.dense.bias, gelu=True, f32_sum=True)
    s2 = row_gemm(gemm, tp, h, w2, p.output.dense.bias, residual=y,
                  f32_sum=True, out_f32=True)
    out = layer_norm(s2, p.output.LayerNorm.weight, p.output.LayerNorm.bias,
                     ln_eps, dt).view(B, Lp, H)
    return out[:, :L] if pad else out


# ---------------------------------------------------------------------------
# the attention half-block (K11) and the train tail (K12)
# ---------------------------------------------------------------------------

class _FusedViTAttn(torch.autograd.Function):
    """Forward: K11 as LN1, the qkv gemm, attention and the proj gemm with
    the residual (4 launches on CUDA).  Backward: the TPU package's
    _vjp_bwd (vitcap_tpu/ops/fused_block.py:448), autograd through the
    plain chain of its _xla_reference (:418): products in the compute
    dtype, the attention through models.layers mha (a train call: the
    packed route from 64 tokens on)."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads, eps,
                plain):
        B, L, H = x.shape
        dt = x.dtype
        ops = PLAIN if plain else KERNELS
        x2 = x.contiguous().view(B * L, H)
        attn = _vit_attention(ops, x2, B, L, num_heads, eps, lns, lnb,
                              wqkv.to(dt), bqkv)
        out = ops[0](attn, wproj.to(dt), bproj, residual=x2).view(B, L, H)
        if not plain and x.is_cuda:
            calls["fused_vit_attn"] += 1
        ctx.save_for_backward(x, lns, lnb, wqkv, bqkv, wproj, bproj)
        ctx.cfg = (num_heads, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        from ..models.layers import mha
        num_heads, eps = ctx.cfg
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        x, lns, lnb, wqkv, bqkv, wproj, bproj = leaves
        dt = x.dtype
        with torch.enable_grad():
            ln = layer_norm_plain(x, lns, lnb, eps, dt)
            qkv = ln @ wqkv.to(dt).t() + bqkv.to(dt)
            o = mha(*qkv.chunk(3, dim=-1), num_heads)
            out = x + o @ wproj.to(dt).t() + bproj.to(dt)
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g.to(dt)))
        return (*(next(got) if t.requires_grad else None for t in leaves),
                None, None, None)


def _fused_vit_attn(x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads, eps,
                    plain):
    if x.dim() != 3:
        raise ValueError(f"fused_vit_attn: x must be (B, L, H), got "
                         f"{tuple(x.shape)}")
    return _FusedViTAttn.apply(x, lns, lnb, wqkv, bqkv, wproj, bproj,
                               num_heads, eps, plain)


def fused_vit_attn(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor,
                   wqkv: torch.Tensor, bqkv: torch.Tensor,
                   wproj: torch.Tensor, bproj: torch.Tensor, num_heads: int,
                   eps: float) -> torch.Tensor:
    """x + proj(attention(LN1(x))), the attention half of a pre-norm ViT
    block: the port of vitcap_tpu/ops/fused_block.py:430 fused_vit_attn
    (K11, _fused_fwd :383, kernel :56).  x (B, L, H) in the compute dtype;
    lns, lnb (H,); wqkv (3H, H), bqkv (3H,), wproj (H, H), bproj (H,) in
    the torch Linear layout (out, in), any float dtype (cast to x's).

    Its rounding is _kernel's: LN1 with f32 statistics, the qkv product
    rounded then + bias in the compute dtype, the attention of K2 (at any
    length: the TPU kernel's q-tiles past 1024 keep a one-pass softmax over
    all keys), the proj product rounded, then + x, then + bproj, each in
    the compute dtype.  The TPU function pads L to pad_len and masks the
    padded keys; the kernels here run at L itself, which gives the same
    values.  Differentiable (the backward recomputes the plain chain)."""
    return _fused_vit_attn(x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads,
                           eps, False)


def fused_vit_attn_plain(x, lns, lnb, wqkv, bqkv, wproj, bproj,
                         num_heads: int, eps: float) -> torch.Tensor:
    """fused_vit_attn on the kernels' plain PyTorch versions, on any
    device: the reference the composition is held to."""
    return _fused_vit_attn(x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads,
                           eps, True)


def vit_attention_residual(p, x: torch.Tensor, num_heads: int,
                           ln_eps: float) -> torch.Tensor:
    """fused_vit_attn over a ViTBlock module's norm1 and attn parameters
    (vitcap_tpu/ops/fused_block.py:459, the param-tree adapter)."""
    return fused_vit_attn(x, p.norm1.weight, p.norm1.bias, p.attn.qkv.weight,
                          p.attn.qkv.bias, p.attn.proj.weight,
                          p.attn.proj.bias, num_heads, ln_eps)


def _tail_train(x, attn, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2, bfc2,
                eps, plain):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, attn, wproj, bproj, ln2s, ln2b, wfc1,
                                      bfc1, wfc2, bfc2)):
        raise RuntimeError("tail_train has no backward (the TPU kernel has "
                           "none); split_vit_block_train is the train block")
    if x.shape != attn.shape or x.dtype != attn.dtype:
        raise ValueError(f"tail_train: x {tuple(x.shape)} {x.dtype} and "
                         f"attn {tuple(attn.shape)} {attn.dtype} differ")
    H = x.shape[-1]
    dt = x.dtype
    out, y1, pre1, _, _ = _vit_tail(
        PLAIN if plain else KERNELS, x.reshape(-1, H).contiguous(),
        attn.reshape(-1, H).contiguous(), eps, wproj.to(dt), bproj, ln2s,
        ln2b, wfc1.to(dt), bfc1, wfc2.to(dt), bfc2, keep_pre=True)
    if not plain and x.is_cuda:
        calls["tail_train"] += 1
    lead = x.shape[:-1]
    return out.view(*lead, H), y1.view(*lead, H), pre1.view(*lead, -1)


def tail_train(x: torch.Tensor, attn: torch.Tensor, wproj: torch.Tensor,
               bproj: torch.Tensor, ln2s: torch.Tensor, ln2b: torch.Tensor,
               wfc1: torch.Tensor, bfc1: torch.Tensor, wfc2: torch.Tensor,
               bfc2: torch.Tensor, eps: float):
    """K12, vitcap_tpu/ops/fused_block.py:831 _tail_train_kernel: the tail
    of a ViT block that also returns what an analytic backward needs.  x,
    attn (..., H) in the compute dtype (the block input and the attention
    output); weights in the torch Linear layout (out, in) -> (out, y1,
    pre1): y1 = x + proj(attn) (+ bproj), the LN2 input; pre1 the fc1
    output before GELU; out = y1 + fc2(GELU(pre1)).  Rounded as the TPU
    kernel rounds (each product rounded, then residual and bias added in
    the compute dtype); GELU is the exact erf, where the TPU kernel uses
    the Abramowitz-Stegun form (|err| <= 1.5e-7).  The same code is the
    forward tail of split_vit_block_train (K6), which also keeps the LN2
    statistics.  Forward only, as in the TPU package: under grad with an
    input that requires grad it raises."""
    return _tail_train(x, attn, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                       bfc2, eps, False)


def tail_train_plain(x, attn, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                     bfc2, eps: float):
    """tail_train on the kernels' plain PyTorch versions, on any device."""
    return _tail_train(x, attn, wproj, bproj, ln2s, ln2b, wfc1, bfc1, wfc2,
                       bfc2, eps, True)


# ---------------------------------------------------------------------------
# train blocks: kernel forward, analytic backward
# ---------------------------------------------------------------------------

def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums and an f32 result, the operands in the compute
    dtype (the TPU package's dot with preferred_element_type=f32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _ln_bwd(dln: torch.Tensor, xhat: torch.Tensor, rsig: torch.Tensor,
            scale: torch.Tensor):
    """Gradients of y = xhat * scale + shift, xhat = (x - mu) * rsig, rows
    on dim 0: (dx f32, dscale, dshift)."""
    dscale = (dln * xhat).sum(0)
    dshift = dln.sum(0)
    dxhat = dln * scale.float()
    dx = rsig * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, dscale, dshift


def _gelu_grad(x32: torch.Tensor) -> torch.Tensor:
    """d/dx of exact (erf) GELU, in f32."""
    cdf = 0.5 * (1.0 + torch.erf(x32 * 0.7071067811865476))
    pdf = torch.exp(-0.5 * x32 * x32) * 0.3989422804014327
    return cdf + x32 * pdf


def _xhat(x: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor):
    return (x.float() - mu[:, None]) * rsig[:, None]


def _check_train_shape(name: str, x: torch.Tensor) -> Tuple[int, int, int]:
    B, Lp, H = x.shape
    if Lp % 16:
        raise ValueError(f"{name} needs a 16-aligned token axis (pre-pad "
                         f"with pad_len)")
    if Lp > MAX_LP:
        raise NotImplementedError(
            f"the split train blocks cover Lp <= {MAX_LP}, as the TPU "
            f"package's do; a train call at Lp={Lp} takes the plain chain "
            f"(models.layers, packed attention)")
    return B, Lp, H


def _vit_params(p) -> Tuple[torch.Tensor, ...]:
    return (p.norm1.weight, p.norm1.bias, p.attn.qkv.weight, p.attn.qkv.bias,
            p.attn.proj.weight, p.attn.proj.bias, p.norm2.weight,
            p.norm2.bias, p.mlp.fc1.weight, p.mlp.fc1.bias, p.mlp.fc2.weight,
            p.mlp.fc2.bias)


class _SplitViTBlockTrain(torch.autograd.Function):
    """Forward: K6 (LayerNorm with stats + qkv gemm; proj gemm + residual,
    LayerNorm with stats, fc1 gemm keeping pre1, fc2 gemm + residual) and
    K2's attention: 4 gemm, 2 layer_norm, 1 attention launches.  Backward:
    _sbt_vjp_bwd of the TPU package, with attention_bwd."""

    @staticmethod
    def forward(ctx, x, num_heads, eps, L, tp, *prm):
        n1w, n1b, wqkv, bqkv, wp, bp, n2w, n2b, w1, b1, w2, b2 = prm
        B, Lp, H = x.shape
        dt = x.dtype
        x2 = x.contiguous().view(B * Lp, H)
        ln1, mu1, rs1 = layer_norm(x2, n1w, n1b, eps, dt, stats=True)
        slab = gemm(ln1, wqkv.to(dt), bqkv).view(B, Lp, wqkv.shape[0])
        attn = attention(slab, num_heads, L)
        out, y1, pre1, mu2, rs2 = _vit_tail(
            KERNELS, x2, attn.view(B * Lp, -1), eps, wp.to(dt), bp, n2w,
            n2b, w1.to(dt), b1, w2.to(dt), b2, stats=True, keep_pre=True,
            tp=tp)
        ctx.save_for_backward(x2, slab, attn, y1, pre1, mu1, rs1, mu2, rs2,
                              *prm)
        ctx.cfg = (num_heads, L, tp)
        return out.view(B, Lp, H)

    @staticmethod
    def backward(ctx, g):
        (x2, slab, attn, y1, pre1, mu1, rs1, mu2, rs2, n1w, n1b, wqkv, bqkv,
         wp, bp, n2w, n2b, w1, b1, w2, b2) = ctx.saved_tensors
        num_heads, L, tp = ctx.cfg
        B, Lp, H3 = slab.shape
        H = H3 // 3             # the local heads' width (all of it unsplit)
        dt = x2.dtype
        g = g.to(dt).reshape(B * Lp, x2.shape[1])
        wqkv_d, wp_d, w1_d, w2_d = (w.to(dt) for w in (wqkv, wp, w1, w2))

        # tail: out = y1 + gelu(pre1) @ W2^T + b2
        h = F.gelu(pre1.float()).to(dt)
        dw2 = _mm32(g.t(), h)
        db2 = g.float().sum(0)
        dpre1 = (_mm32(g, w2_d) * _gelu_grad(pre1.float())).to(dt)
        xhat2 = _xhat(y1, mu2, rs2)
        ln2 = (xhat2 * n2w + n2b).to(dt)
        dw1 = _mm32(dpre1.t(), ln2)
        db1 = dpre1.float().sum(0)
        dy1_ln, dn2w, dn2b = _ln_bwd(all_reduce_tp(_mm32(dpre1, w1_d), tp),
                                     xhat2, rs2[:, None], n2w)
        dy1 = (g.float() + dy1_ln).to(dt)

        # proj: y1 = x + attn @ Wp^T + bp
        dattn = _mm32(dy1, wp_d).to(dt)
        dwp = _mm32(dy1.t(), attn.view(B * Lp, H))
        dbp = dy1.float().sum(0)

        dq, dk, dv = attention_bwd(slab, dattn.view(B, Lp, H), num_heads, L)
        dq, dk, dv = (t.view(B * Lp, H) for t in (dq, dk, dv))

        # qkv: slab = LN1(x) @ Wqkv^T + bqkv
        xhat1 = _xhat(x2, mu1, rs1)
        ln1 = (xhat1 * n1w + n1b).to(dt)
        dwqkv = torch.cat([_mm32(d.t(), ln1) for d in (dq, dk, dv)])
        dbqkv = torch.cat([d.float().sum(0) for d in (dq, dk, dv)])
        dln1 = all_reduce_tp(_mm32(dq, wqkv_d[:H]) + _mm32(dk, wqkv_d[H:2 * H])
                             + _mm32(dv, wqkv_d[2 * H:]), tp)
        dx_ln, dn1w, dn1b = _ln_bwd(dln1, xhat1, rs1[:, None], n1w)
        dx = (dy1.float() + dx_ln).to(dt).view(B, Lp, -1)
        return (dx, None, None, None, None, dn1w, dn1b, dwqkv, dbqkv, dwp,
                dbp, dn2w, dn2b, dw1, db1, dw2, db2)


def split_vit_block_train(p, x: torch.Tensor, num_heads: int,
                          ln_eps: float, l_actual: int = 0) -> torch.Tensor:
    """Train pre-norm ViT block (bias- and dropout-free) over a 16-aligned
    x (B, Lp, H) with l_actual valid rows (0: all).  Padded rows carry
    finite values, are masked as keys, and give and take no gradient when
    the upstream gradient's padded rows are zero."""
    B, Lp, H = _check_train_shape("split_vit_block_train", x)
    tp = tp_of(p)
    return _SplitViTBlockTrain.apply(x, local_heads(tp, num_heads), ln_eps,
                                     l_actual or Lp, tp, *_vit_params(p))


def _bert_params(p) -> Tuple[torch.Tensor, ...]:
    ps, po = p.attention.self, p.attention.output
    return (ps.query.weight, ps.query.bias, ps.key.weight, ps.key.bias,
            ps.value.weight, ps.value.bias, po.dense.weight, po.dense.bias,
            po.LayerNorm.weight, po.LayerNorm.bias,
            p.intermediate.dense.weight, p.intermediate.dense.bias,
            p.output.dense.weight, p.output.dense.bias,
            p.output.LayerNorm.weight, p.output.LayerNorm.bias)


class _SplitBertLayerTrain(torch.autograd.Function):
    """Forward: the qkv gemm, attention with bias and prob dropout (K8),
    then K7: out-dense gemm with the dropout epilogue and residual,
    LayerNorm with stats, fc1 gemm keeping pre1, fc2 gemm with the dropout
    epilogue and residual, LayerNorm with stats: 4 gemm, 2 layer_norm, 1
    attention launches.  Backward: _sblt_vjp_bwd of the TPU package, hidden
    masks regenerated by ops/dropout.py, attention_bwd with the bias and
    the prob-dropout seed."""

    @staticmethod
    def forward(ctx, x, bias, num_heads, eps, L, hidden_rate, attn_rate,
                seeds, tp, *prm):
        (wq, bq, wk, bk, wv, bv, wo, bo, l1w, l1b, wi, bi, wo2, bo2, l2w,
         l2b) = prm
        B, Lp, H = x.shape
        dt = x.dtype
        x2 = x.contiguous().view(B * Lp, H)
        slab = gemm(x2, torch.cat([wq, wk, wv]).to(dt),
                    torch.cat([bq, bk, bv])).view(B, Lp, 3 * wq.shape[0])
        a = attention(slab, num_heads, L, bias, attn_rate, seeds[0],
                      *salt_heads(tp))
        r1 = row_gemm(gemm, tp, a.view(B * Lp, -1), wo.to(dt), bo,
                      residual=x2, dropout=(hidden_rate, seeds[1], 0, Lp))
        y1, mu1, rs1 = layer_norm(r1, l1w, l1b, eps, dt, stats=True)
        pre1 = torch.empty((B * Lp, wi.shape[0]), dtype=dt, device=x.device)
        h = gemm(y1, wi.to(dt), bi, gelu=True, pre_out=pre1)
        r2 = row_gemm(gemm, tp, h, wo2.to(dt), bo2, residual=y1,
                      dropout=(hidden_rate, seeds[1], 1, Lp))
        out, mu2, rs2 = layer_norm(r2, l2w, l2b, eps, dt, stats=True)
        ctx.save_for_backward(x2, bias, slab, a, r1, y1, pre1, r2, mu1, rs1,
                              mu2, rs2, *prm)
        ctx.cfg = (num_heads, L, hidden_rate, attn_rate, seeds, tp)
        return out.view(B, Lp, H)

    @staticmethod
    def backward(ctx, g):
        (x2, bias, slab, a, r1, y1, pre1, r2, mu1, rs1, mu2, rs2, wq, bq, wk,
         bk, wv, bv, wo, bo, l1w, l1b, wi, bi, wo2, bo2, l2w,
         l2b) = ctx.saved_tensors
        num_heads, L, h_rate, a_rate, seeds, tp = ctx.cfg
        B, Lp, H3 = slab.shape
        H = H3 // 3             # the local heads' width (all of it unsplit)
        Hf = x2.shape[1]
        dt = x2.dtype
        wqkv = torch.cat([wq, wk, wv]).to(dt)
        wo_d, wi_d, wo2_d = (w.to(dt) for w in (wo, wi, wo2))

        def hmask(which, d):
            """The forward's hidden-dropout chain on a cotangent, in the
            compute dtype."""
            if h_rate == 0.0:
                return d
            keep = dropout.hidden_keep(seeds[1], which, h_rate, B, Lp, Hf,
                                       d.device).view(B * Lp, Hf)
            inv = torch.tensor(1.0 / (1.0 - h_rate), dtype=dt,
                               device=d.device)
            return torch.where(keep, d, 0.0).to(dt) * inv

        # LN2: out = LN(r2) * s2 + b2, r2 = y1 + dropout(gelu(pre1) @ Wo2^T)
        xhat2 = _xhat(r2, mu2, rs2)
        dr2, dl2w, dl2b = _ln_bwd(g.reshape(B * Lp, Hf).float(), xhat2,
                                  rs2[:, None], l2w)
        dr2 = dr2.to(dt)
        du = hmask(1, dr2)
        h = F.gelu(pre1.float()).to(dt)
        dwo2 = _mm32(du.t(), h)
        dbo2 = du.float().sum(0)
        dpre1 = (_mm32(du, wo2_d) * _gelu_grad(pre1.float())).to(dt)
        dwi = _mm32(dpre1.t(), y1)
        dbi = dpre1.float().sum(0)
        dy1 = (dr2.float() + all_reduce_tp(_mm32(dpre1, wi_d), tp)).to(dt)

        # LN1: y1 = LN(r1) * s1 + b1, r1 = x + dropout(a @ Wo^T + bo)
        xhat1 = _xhat(r1, mu1, rs1)
        dr1, dl1w, dl1b = _ln_bwd(dy1.float(), xhat1, rs1[:, None], l1w)
        dr1 = dr1.to(dt)
        dt_ = hmask(0, dr1)
        da = _mm32(dt_, wo_d).to(dt)
        dwo = _mm32(dt_.t(), a.view(B * Lp, H))
        dbo = dt_.float().sum(0)

        dq, dk, dv = attention_bwd(slab, da.view(B, Lp, H), num_heads, L,
                                   bias, a_rate, seeds[0], *salt_heads(tp))
        dq, dk, dv = (t.view(B * Lp, H) for t in (dq, dk, dv))
        dwq, dwk, dwv = (_mm32(d.t(), x2) for d in (dq, dk, dv))
        dbq, dbk, dbv = (d.float().sum(0) for d in (dq, dk, dv))
        dqkv = all_reduce_tp(_mm32(dq, wqkv[:H]) + _mm32(dk, wqkv[H:2 * H])
                             + _mm32(dv, wqkv[2 * H:]), tp)
        dx = (dr1.float() + dqkv).to(dt).view(B, Lp, Hf)
        return (dx, None, None, None, None, None, None, None, None, dwq, dbq,
                dwk, dbk, dwv, dbv, dwo, dbo, dl1w, dl1b, dwi, dbi, dwo2,
                dbo2, dl2w, dl2b)


def split_bert_layer_train(p, x: torch.Tensor, bias: torch.Tensor,
                           num_heads: int, ln_eps: float, l_actual: int = 0,
                           hidden_rate: float = 0.0, attn_rate: float = 0.0,
                           seeds: Sequence[int] = (0, 0)) -> torch.Tensor:
    """Train post-norm BERT layer over a 16-aligned x (B, Lp, H) and its
    f32 (B, 1, Lp, Lp) bias, l_actual valid rows (0: all); seeds = (attn
    prob seed, hidden seed), int32 values.  The bias is a mask and takes no
    gradient: one that requires grad raises (the TPU package returns zeros
    for it)."""
    B, Lp, H = _check_train_shape("split_bert_layer_train", x)
    if bias.requires_grad:
        raise ValueError("split_bert_layer_train: the attention bias takes "
                         "no gradient; pass a bias that does not require "
                         "grad")
    if bias.shape != (B, 1, Lp, Lp):
        raise ValueError(f"split_bert_layer_train: bias must be ({B}, 1, "
                         f"{Lp}, {Lp}), got {tuple(bias.shape)}")
    seeds = tuple(int(s) for s in seeds)
    tp = tp_of(p)
    return _SplitBertLayerTrain.apply(
        x, bias.float().contiguous(), local_heads(tp, num_heads), ln_eps,
        l_actual or Lp, float(hidden_rate), float(attn_rate), seeds, tp,
        *_bert_params(p))
