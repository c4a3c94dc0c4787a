"""flash_attention_packed: packed-layout attention with its backward, the
port of vitcap_tpu/ops/flash_attention.py:792-831 (K8 on separate q, k, v).

q, k and v stay (B, L, H) end to end, head h at columns [h*hd, (h+1)*hd):
the forward is the attention kernel (ops/attention.py attention_qkv,
replacing :670 _flash_fwd_packed, pallas_call :719) and the backward the
one-pass recompute kernel (ops/attention_bwd.py attention_bwd_qkv,
replacing :734 _flash_bwd_packed, pallas_call :777), each reading the three
operands by base pointer and strides, so views of one qkv tensor and
separate tensors are taken alike and nothing is copied into a slab.  The
forward saves q, k, v, the bias and the seed; the backward regenerates the
probabilities and the dropout keep bits from them (no (B, nh, L, L) tensor
is stored).

This is the train route of models.layers.mha: a gradient-carrying or
dropout-active self-attention with at least 64 tokens and a bias that is
None or head-broadcast, at any length (the ViT and BERT chains past 1024
padded tokens, and the plain layers at an unaligned length).  Attention-
prob dropout at `dropout_rate` draws its keep bits from the int32 `seed`
through the counter hash (ops/dropout.py), the TPU kernels' bits.

The TPU function pads an unaligned L to a multiple of 16 inside and slices
the output back; here the kernels bound every loop by the length they are
given, so l_actual == 0 runs at L itself, which computes the same values.
l_actual > 0 marks the inputs as already padded (16-aligned) with that
many valid rows: the padded keys are masked and the padded (B, Lp, H)
output is returned unsliced, as the TPU function returns it.

The bias is a mask and takes no gradient: the TPU function returns zeros
for it (ROADMAP F2); here a bias that requires grad raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import attention_qkv, attention_qkv_plain
from .attention_bwd import attention_bwd_qkv, attention_bwd_qkv_plain


class _FlashAttentionPacked(torch.autograd.Function):
    """Forward: one attention launch.  Backward: one attention_bwd call
    (two launches) with the forward's bias, rate and seed.  plain=True runs
    the kernels' plain versions on any device (flash_attention_packed_plain,
    the reference)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads, rate, l_actual, plain):
        fwd = attention_qkv_plain if plain else attention_qkv
        out = fwd(q, k, v, num_heads, l_actual, bias, rate, seed)
        ctx.save_for_backward(q, k, v, bias)
        ctx.cfg = (seed, num_heads, rate, l_actual, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        seed, num_heads, rate, l_actual, plain = ctx.cfg
        bwd = attention_bwd_qkv_plain if plain else attention_bwd_qkv
        dq, dk, dv = bwd(q, k, v, g.to(q.dtype).contiguous(), num_heads,
                         l_actual, bias, rate, seed)
        return dq, dk, dv, None, None, None, None, None, None


def _apply(q, k, v, bias, seed, num_heads, dropout_rate, l_actual, plain):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_packed: q, k, v must share one "
                         f"(B, L, H) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H = q.shape
    if l_actual:
        if L % 16:
            raise ValueError("flash_attention_packed: pre-padded input "
                             "(l_actual > 0) must be 16-aligned")
        if not 1 <= l_actual <= L:
            raise ValueError(f"flash_attention_packed: l_actual={l_actual} "
                             f"outside [1, {L}]")
    if bias is not None:
        if bias.requires_grad:
            raise ValueError("flash_attention_packed: the attention bias "
                             "takes no gradient; pass a bias that does not "
                             "require grad")
        if bias.shape != (B, 1, L, L):
            raise ValueError(f"flash_attention_packed: bias must be ({B}, "
                             f"1, {L}, {L}), got {tuple(bias.shape)}")
        bias = bias.float().contiguous()
    return _FlashAttentionPacked.apply(q, k, v, bias, int(seed), num_heads,
                                       float(dropout_rate), l_actual or L,
                                       plain)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: Optional[torch.Tensor],
                           seed: int, num_heads: int,
                           dropout_rate: float = 0.0,
                           l_actual: int = 0) -> torch.Tensor:
    """q, k, v (B, L, H) (views of one tensor or separate), bias None or
    (B, 1, L, L) additive, seed an int32 value (ignored at dropout_rate 0)
    -> (B, L, H).  l_actual > 0: pre-padded 16-aligned input with that many
    valid rows, output unsliced.  CUDA tensors launch the kernels; CPU
    tensors run their plain versions."""
    return _apply(q, k, v, bias, seed, num_heads, dropout_rate, l_actual,
                  False)


def flash_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: Optional[torch.Tensor], seed: int,
                                 num_heads: int, dropout_rate: float = 0.0,
                                 l_actual: int = 0) -> torch.Tensor:
    """flash_attention_packed on the kernels' plain PyTorch versions, on
    any device: the reference the kernels are held to."""
    return _apply(q, k, v, bias, seed, num_heads, dropout_rate, l_actual,
                  True)
