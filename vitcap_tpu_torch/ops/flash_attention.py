"""The two attention functions of vitcap_tpu/ops/flash_attention.py with
their backwards: flash_attention_packed (:792-831, K8 on separate q, k, v)
and flash_attention (:846-879, K9 on per-head q, k, v).

flash_attention_packed: q, k and v stay (B, L, H) end to end, head h at
columns [h*hd, (h+1)*hd): the forward is the attention kernel
(ops/attention.py attention_qkv, replacing :670 _flash_fwd_packed,
pallas_call :719) and the backward the one-pass recompute kernel
(ops/attention_bwd.py attention_bwd_qkv, replacing :734 _flash_bwd_packed,
pallas_call :777), each reading the three operands by base pointer and
strides, so views of one qkv tensor and separate tensors are taken alike
and nothing is copied into a slab.  The
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
for it; here a bias that requires grad raises.

flash_attention: q, k and v are (B, nH, L, dh), read in place by stride
(a contiguous tensor, or the per-head view of a (B, L, H) projection that
models.layers mha passes), with a bias that is None, (B, 1, L, L) or per
head (B, nH, L, L).  The TPU function pads L to Lp = round_up(L, 128) and picks its kernel
by Lp; here the kernels run at L itself and the same rule picks the
function:
- forward, Lp <= 1024: the attention kernel (ops/attention.py
  attention_heads), the math of :189 _flash_fwd_onepass (:165
  _onepass_kernel, pallas_call :237);
- forward, Lp > 1024: the kernel's online mode, the math of :251
  _flash_fwd_pallas (:129 _kernel, pallas_call :309): q pre-scaled in its
  dtype, an online softmax over 128-key tiles;
- backward, Lp <= 1024: the attention_bwd kernels (attention_bwd_heads),
  the math of :372 _flash_bwd_onepass (:324 _bwd_onepass_kernel,
  pallas_call :426), and a bias cotangent of zeros (:863-866);
- backward, Lp > 1024: autograd through the plain f32 attention of :834
  _xla_attention (no kernel there in the TPU package either), which gives
  the bias its true gradient (:867-876).
So the bias gradient depends on the length, as in the TPU package: zeros
up to 1024 padded tokens, the true gradient past it.  This is the
inference route of models.layers mha (a self-attention that carries no
gradient, with at least 64 tokens and no dropout, any bias).
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (MAX_LP, ONLINE_TK, attention_heads,
                        attention_heads_plain, attention_qkv,
                        attention_qkv_plain)
from .attention_bwd import (attention_bwd_heads, attention_bwd_heads_plain,
                            attention_bwd_qkv, attention_bwd_qkv_plain)


class _FlashAttentionPacked(torch.autograd.Function):
    """Forward: one attention launch.  Backward: one attention_bwd call
    (two launches) with the forward's bias, rate and seed.  plain=True runs
    the kernels' plain versions on any device (flash_attention_packed_plain,
    the reference)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads, rate, l_actual, plain,
                salt_heads):
        fwd = attention_qkv_plain if plain else attention_qkv
        out = fwd(q, k, v, num_heads, l_actual, bias, rate, seed,
                  *salt_heads)
        ctx.save_for_backward(q, k, v, bias)
        ctx.cfg = (seed, num_heads, rate, l_actual, plain, salt_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        seed, num_heads, rate, l_actual, plain, salt_heads = ctx.cfg
        bwd = attention_bwd_qkv_plain if plain else attention_bwd_qkv
        dq, dk, dv = bwd(q, k, v, g.to(q.dtype).contiguous(), num_heads,
                         l_actual, bias, rate, seed, *salt_heads)
        return dq, dk, dv, None, None, None, None, None, None, None


def _apply(q, k, v, bias, seed, num_heads, dropout_rate, l_actual, plain,
           salt_heads=(0, 0)):
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
                                       plain, tuple(salt_heads))


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: Optional[torch.Tensor],
                           seed: int, num_heads: int,
                           dropout_rate: float = 0.0,
                           l_actual: int = 0,
                           salt_heads=(0, 0)) -> torch.Tensor:
    """q, k, v (B, L, H) (views of one tensor or separate), bias None or
    (B, 1, L, L) additive, seed an int32 value (ignored at dropout_rate 0)
    -> (B, L, H).  l_actual > 0: pre-padded 16-aligned input with that many
    valid rows, output unsliced.  salt_heads (nh_total, head_offset): the
    dropout salt's global heads of a tensor-parallel rank (ops/attention.py
    attention; (0, 0) without).  CUDA tensors launch the kernels; CPU
    tensors run their plain versions."""
    return _apply(q, k, v, bias, seed, num_heads, dropout_rate, l_actual,
                  False, salt_heads)


def flash_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: Optional[torch.Tensor], seed: int,
                                 num_heads: int, dropout_rate: float = 0.0,
                                 l_actual: int = 0,
                                 salt_heads=(0, 0)) -> torch.Tensor:
    """flash_attention_packed on the kernels' plain PyTorch versions, on
    any device: the reference the kernels are held to."""
    return _apply(q, k, v, bias, seed, num_heads, dropout_rate, l_actual,
                  True, salt_heads)


# ---------------------------------------------------------------------------
# flash_attention (K9)
# ---------------------------------------------------------------------------

def takes_online(L: int) -> bool:
    """Whether K9 at L tokens is the TPU package's q-tiled online kernel:
    its padded length round_up(L, 128) is past 1024."""
    return -(-L // ONLINE_TK) * ONLINE_TK > MAX_LP


def _attention_f32(q, k, v, bias):
    """vitcap_tpu/ops/flash_attention.py:834 _xla_attention: the f32
    softmax attention whose VJP is K9's backward past 1024."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if bias is not None:
        s = s + bias.float()
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward: one attention launch (the online mode past 1024).
    Backward: one attention_bwd call (two launches) up to 1024, autograd
    through _attention_f32 past it.  plain=True runs the kernels' plain
    versions on any device (flash_attention_plain, the reference)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, plain):
        online = takes_online(q.shape[2])
        if plain:
            out = attention_heads_plain(q, k, v, q.shape[2], bias,
                                        online=online)
        else:
            out = attention_heads(q, k, v, bias, online)
        ctx.save_for_backward(q, k, v, bias)
        ctx.cfg = (online, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        online, plain = ctx.cfg
        if not online:
            g = g.to(q.dtype)
            if plain:
                dq, dk, dv = attention_bwd_heads_plain(q, k, v, g, q.shape[2],
                                                       bias)
            else:
                dq, dk, dv = attention_bwd_heads(q, k, v, g, bias)
            db = (torch.zeros_like(bias) if ctx.needs_input_grad[3]
                  else None)
            return dq, dk, dv, db, None
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) if t is not None
                      else None
                      for t, need in zip((q, k, v, bias),
                                         ctx.needs_input_grad)]
            out = _attention_f32(*leaves)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(got) if t is not None and t.requires_grad else None
                  for t in leaves), None)


def _flash(q, k, v, bias, plain):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, nH, "
                         f"L, dh) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, nh, L, _ = q.shape
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, B) \
                or bias.shape[1] not in (1, nh) or bias.shape[2:] != (L, L):
            raise ValueError(f"flash_attention: bias must be ({B}, 1 or "
                             f"{nh}, {L}, {L}), got {tuple(bias.shape)}")
        bias = bias.float().expand(B, -1, L, L).contiguous()
    return _FlashAttention.apply(q, k, v, bias, plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (B, nH, L, dh), bias None or additive (B, 1 | nH, L, L) ->
    (B, nH, L, dh) (on CUDA the per-head view of a contiguous (B, L, nH *
    dh) tensor).  CUDA tensors launch the kernels; CPU tensors run their
    plain versions.  The backward up to 1024 padded tokens is the
    attention_bwd kernel pair (head dims up to 64 on CUDA) with a zero bias
    gradient; past it, autograd through the f32 attention with the true
    bias gradient."""
    return _flash(q, k, v, bias, False)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """flash_attention on the kernels' plain PyTorch versions, on any
    device: the reference the kernels are held to."""
    return _flash(q, k, v, bias, True)
