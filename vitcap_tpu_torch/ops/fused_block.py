"""Fused ViT and BERT blocks, composed from the gemm, layer_norm and
attention kernels.

fused_vit_block is the composition of vitcap_tpu/ops/fused_block.py
_split_block_fwd ([LN1 + qkv] | attention | [proj + residual + LN2 + MLP +
residual]); fused_bert_block that of _bert_split_fwd ([qkv] | attention +
bias | [out-dense + post-LN1 + MLP + post-LN2]).  Each block launches 4 gemm,
2 layer_norm and 1 attention kernel on a CUDA device; on the CPU the same
composition runs the kernels' plain versions.

Only single-q-tile lengths (Lp <= 1024) exist here; the TPU package's
monolithic q-tiled kernels for longer inputs are not ported yet.

Rounding follows the TPU kernels (see ops/gemm.py): the ViT gemms and the
BERT qkv round each product to the compute dtype and add bias and residual
in it; the BERT tail keeps each sublayer sum in f32 for its post-LayerNorm.

The GEMM weights are cast (and BERT's q/k/v concatenated) once per module
and compute dtype, not per call; the cache is remade when a parameter is
replaced or changed in place (a checkpoint load).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attention
from .gemm import gemm
from .layer_norm import layer_norm

MAX_LP = 1024


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_len(L: int) -> int:
    """Padded token length, the rule of the TPU package's pad_len: at least
    64 (the block dispatch gate) and 16-aligned up to 1024, 128-aligned
    beyond (577 -> 592, 628 -> 640)."""
    lp = max(64, _round_up(L, 16))
    return lp if lp <= MAX_LP else _round_up(L, 128)


def _check_lp(Lp: int) -> None:
    if Lp > MAX_LP:
        raise NotImplementedError(
            f"fused blocks cover Lp <= {MAX_LP}; the q-tiled kernels for "
            f"Lp={Lp} are not ported yet")


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


def fused_vit_block(p, x: torch.Tensor, num_heads: int, ln_eps: float,
                    l_actual: int = 0) -> torch.Tensor:
    """One pre-norm ViT block (bias-free, dropout-free).  p is a ViTBlock
    module.  l_actual > 0: x is already padded to pad_len with that many
    valid rows (the caller hoisted the pad out of its block loop)."""
    B, L, H = x.shape
    if l_actual:
        if L % 16:
            raise ValueError("pre-padded input must be pad_len-aligned")
        Lp, pad = L, 0
        L = l_actual
    else:
        Lp = pad_len(L)
        pad = Lp - L
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
    _check_lp(Lp)
    dt = x.dtype
    wqkv, wproj, w1, w2 = _block_weights(p, dt, _vit_weights)
    x2 = x.contiguous().view(B * Lp, H)
    ln1 = layer_norm(x2, p.norm1.weight, p.norm1.bias, ln_eps, dt)
    slab = gemm(ln1, wqkv, p.attn.qkv.bias)
    attn = attention(slab.view(B, Lp, 3 * H), num_heads, L)
    x1 = gemm(attn.view(B * Lp, H), wproj, p.attn.proj.bias, residual=x2)
    ln2 = layer_norm(x1, p.norm2.weight, p.norm2.bias, ln_eps, dt)
    h = gemm(ln2, w1, p.mlp.fc1.bias, gelu=True)
    out = gemm(h, w2, p.mlp.fc2.bias, residual=x1).view(B, Lp, H)
    return out[:, :L] if pad else out


def fused_bert_block(p, x: torch.Tensor, bias: torch.Tensor, num_heads: int,
                     ln_eps: float) -> torch.Tensor:
    """One post-norm BERT layer with an additive (B, 1, L, L) attention
    bias (deterministic path).  p is a BertLayer module."""
    B, L, H = x.shape
    Lp = pad_len(L)
    _check_lp(Lp)
    pad = Lp - L
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        bias = F.pad(bias, (0, pad, 0, pad))
    dt = x.dtype
    wqkv, bqkv, wo, w1, w2 = _block_weights(p, dt, _bert_weights)
    po = p.attention.output
    x2 = x.contiguous().view(B * Lp, H)
    slab = gemm(x2, wqkv, bqkv)
    attn = attention(slab.view(B, Lp, 3 * H), num_heads, L,
                     bias.float().contiguous())
    s1 = gemm(attn.view(B * Lp, H), wo, po.dense.bias, residual=x2,
              f32_sum=True, out_f32=True)
    y = layer_norm(s1, po.LayerNorm.weight, po.LayerNorm.bias, ln_eps, dt)
    h = gemm(y, w1, p.intermediate.dense.bias, gelu=True, f32_sum=True)
    s2 = gemm(h, w2, p.output.dense.bias, residual=y, f32_sum=True,
              out_f32=True)
    out = layer_norm(s2, p.output.LayerNorm.weight, p.output.LayerNorm.bias,
                     ln_eps, dt).view(B, Lp, H)
    return out[:, :L] if pad else out
