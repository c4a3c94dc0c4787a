"""T2T-ViT, the port of vitcap_tpu/models/t2t_vit.py (eval semantics).

Two tokeniser families, as in the JAX package:

- `transformer` variants (t2t_vit_t_14/19/24): Token_transformer, a
  one-head attention whose output adds to v (the input changed width),
  then an MLP residual.
- `performer` variants (t2t_vit_7/10/12/14/19/24/14_resnext/14_wide): the
  published upstream Token_performer (the JAX package's docstring says
  why: the reference's vendored copy is truncated): kqv Linear(in, 3 *
  emb) split in k, q, v ORDER, positive random-feature attention
  exp(w^T x - |x|^2 / 2) / sqrt(m) over a frozen orthogonal projection w
  (m = emb / 2), the v skip, then an emb -> emb MLP residual.

The model: unfold(7, 4, 2) -> tokeniser(147 -> 64) -> unfold(3, 2, 1) ->
tokeniser(576 -> 64) -> unfold(3, 2, 1) -> project to embed_dim; CLS plus
the FIXED sinusoid pos-embed; pre-norm blocks without qkv bias, scaled by
qk_scale or head_dim^-0.5; the final norm.  Everything is plain PyTorch
(the JAX package computes it outside any Pallas kernel): F.unfold, the
products, softmax and exact-erf GELU in the input's dtype, LayerNorm
statistics in f32 (eps 1e-5).

Parameter names are the T2T release's state-dict names
(tokens_to_token.attention1.attn.qkv.weight, .kqv.weight, .mlp.0.weight,
.w; blocks.N.attn.qkv.weight; pos_embed is a (frozen) parameter).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import _Group, dense, layer_norm, vit_mlp

# name -> (embed_dim, depth, num_heads, mlp_ratio, tokens_type)
T2T_VITS = {
    "t2t_vit_t_14": (384, 14, 6, 3.0, "transformer"),
    "t2t_vit_t_19": (448, 19, 7, 3.0, "transformer"),
    "t2t_vit_t_24": (512, 24, 8, 3.0, "transformer"),
    "t2t_vit_7": (256, 7, 4, 2.0, "performer"),
    "t2t_vit_10": (256, 10, 4, 2.0, "performer"),
    "t2t_vit_12": (256, 12, 4, 2.0, "performer"),
    "t2t_vit_14": (384, 14, 6, 3.0, "performer"),
    "t2t_vit_19": (448, 19, 7, 3.0, "performer"),
    "t2t_vit_24": (512, 24, 8, 3.0, "performer"),
    "t2t_vit_14_resnext": (384, 14, 32, 3.0, "performer"),
    "t2t_vit_14_wide": (768, 4, 12, 3.0, "performer"),
}
TOKEN_DIM = 64
LN_EPS = 1e-5


def t2t_feature_dim(variant: str) -> int:
    return T2T_VITS[variant][0]


def sinusoid_pos_embed(n_position: int, d_hid: int) -> torch.Tensor:
    """transformer_block.py get_sinusoid_encoding, (1, n, d) f32."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.tensor(table[None], dtype=torch.float32)


def _ln(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(m, x, LN_EPS)


def _unfold(x: torch.Tensor, k: int, stride: int, pad: int):
    """nn.Unfold on NCHW x -> (B, L, C * k * k) tokens, torch's (C, kh, kw)
    feature order, and the output grid."""
    h = (x.shape[2] + 2 * pad - k) // stride + 1
    w = (x.shape[3] + 2 * pad - k) // stride + 1
    return F.unfold(x, k, padding=pad, stride=stride).transpose(1, 2), h, w


class TokenTransformer(nn.Module):
    def __init__(self, dim: int, in_dim: int, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = _Group(qkv=nn.Linear(dim, 3 * in_dim, bias=False,
                                         device=device),
                           proj=nn.Linear(in_dim, in_dim, device=device))
        self.norm2 = nn.LayerNorm(in_dim, device=device)
        self.mlp = _Group(fc1=nn.Linear(in_dim, in_dim, device=device),
                          fc2=nn.Linear(in_dim, in_dim, device=device))
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = dense(self.attn.qkv, _ln(x, self.norm1)).chunk(3, dim=-1)
        s = (q @ k.transpose(-1, -2)) * self.dim ** -0.5   # one head
        x = v + dense(self.attn.proj, torch.softmax(s, dim=-1) @ v)
        return x + vit_mlp(self.mlp, _ln(x, self.norm2))


class TokenPerformer(nn.Module):
    def __init__(self, dim: int, emb: int, kernel_ratio: float = 0.5,
                 device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.kqv = nn.Linear(dim, 3 * emb, device=device)
        self.proj = nn.Linear(emb, emb, device=device)
        self.norm2 = nn.LayerNorm(emb, device=device)
        self.mlp = _Group(**{"0": nn.Linear(emb, emb, device=device),
                             "2": nn.Linear(emb, emb, device=device)})
        m = int(emb * kernel_ratio)
        self.w = nn.Parameter(torch.empty(m, emb, device=device),
                              requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        k, q, v = dense(self.kqv, _ln(x, self.norm1)).chunk(3, dim=-1)
        w = self.w.to(x.dtype)
        m = w.shape[0]

        def prm_exp(u):
            xd = (u * u).sum(-1, keepdim=True) / 2
            return torch.exp(u @ w.t() - xd) / np.sqrt(m)

        kp, qp = prm_exp(k), prm_exp(q)                       # (B, T, m)
        d = torch.einsum("btm,bm->bt", qp, kp.sum(dim=1))[..., None]
        kptv = torch.einsum("btn,btm->bnm", v, kp)            # (B, emb, m)
        y = torch.einsum("btm,bnm->btn", qp, kptv) / (d + eps)
        y = v + dense(self.proj, y)
        h = F.gelu(dense(getattr(self.mlp, "0"), _ln(y, self.norm2)))
        return y + dense(getattr(self.mlp, "2"), h)


class T2TBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = _Group(qkv=nn.Linear(dim, 3 * dim, bias=False,
                                         device=device),
                           proj=nn.Linear(dim, dim, device=device))
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.mlp = _Group(fc1=nn.Linear(dim, hidden, device=device),
                          fc2=nn.Linear(hidden, dim, device=device))

    def forward(self, x: torch.Tensor, heads: int, scale: float
                ) -> torch.Tensor:
        B, L, D = x.shape
        q, k, v = (a.reshape(B, L, heads, D // heads).transpose(1, 2)
                   for a in dense(self.attn.qkv,
                                  _ln(x, self.norm1)).chunk(3, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(B, L, D)
        x = x + dense(self.attn.proj, o)
        return x + vit_mlp(self.mlp, _ln(x, self.norm2))


class T2TViT(nn.Module):
    """(B, 3, H, W) -> (B, 1 + N, D) post-norm tokens (CLS first).  depth:
    the body's block count (default the variant's)."""

    def __init__(self, variant: str, num_classes: int = 0, depth: int = 0,
                 device=None):
        super().__init__()
        embed, vdepth, heads, mlp_ratio, ttype = T2T_VITS[variant]
        self.variant, self.heads = variant, heads
        tok = TokenPerformer if ttype == "performer" else TokenTransformer
        self.tokens_to_token = _Group(
            attention1=tok(3 * 7 * 7, TOKEN_DIM, device=device),
            attention2=tok(TOKEN_DIM * 9, TOKEN_DIM, device=device),
            project=nn.Linear(TOKEN_DIM * 9, embed, device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, 14 * 14 + 1, embed,
                                                  device=device),
                                      requires_grad=False)
        hidden = int(embed * mlp_ratio)
        self.blocks = nn.ModuleList(T2TBlock(embed, hidden, device)
                                    for _ in range(depth or vdepth))
        self.norm = nn.LayerNorm(embed, device=device)
        if num_classes:
            self.head = nn.Linear(embed, num_classes, device=device)

    def forward(self, x: torch.Tensor, qk_scale: float = 0.0) -> torch.Tensor:
        t2t = self.tokens_to_token
        B = x.shape[0]
        x, h, w = _unfold(x, 7, 4, 2)
        x = t2t.attention1(x)
        x = x.transpose(1, 2).reshape(B, -1, h, w)
        x, h, w = _unfold(x, 3, 2, 1)
        x = t2t.attention2(x)
        x = x.transpose(1, 2).reshape(B, TOKEN_DIM, h, w)
        x, h, w = _unfold(x, 3, 2, 1)
        x = dense(t2t.project, x)
        cls = self.cls_token.to(x.dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        hd = x.shape[-1] // self.heads
        scale = qk_scale if qk_scale else hd ** -0.5
        for blk in self.blocks:
            x = blk(x, self.heads, scale)
        return _ln(x, self.norm)


def t2t_vit_from_jax(p, variant: str) -> Dict[str, torch.Tensor]:
    """The JAX package's init_t2t_vit tree -> T2TViT names (the inverse of
    its load_t2t_vit)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def lin(q, name, w="w", b="b"):
        out = {name + ".weight": t(np.asarray(q[w]).T)}
        if b in q:
            out[name + ".bias"] = t(q[b])
        return out

    def nrm(q, name):
        return {name + ".weight": t(q["scale"]), name + ".bias": t(q["bias"])}

    def tok(q, base):
        if "kqv" in q:
            return {**nrm(q["norm1"], base + ".norm1"),
                    **lin(q["kqv"], base + ".kqv"),
                    **lin(q["proj"], base + ".proj"),
                    **nrm(q["norm2"], base + ".norm2"),
                    **lin(q["mlp1"], base + ".mlp.0"),
                    **lin(q["mlp2"], base + ".mlp.2"),
                    base + ".w": t(q["w"])}
        return {**nrm(q["norm1"], base + ".norm1"),
                base + ".attn.qkv.weight": t(np.asarray(q["qkv_w"]).T),
                **lin(q["proj"], base + ".attn.proj"),
                **nrm(q["norm2"], base + ".norm2"),
                **lin(q["fc1"], base + ".mlp.fc1"),
                **lin(q["fc2"], base + ".mlp.fc2")}

    sd = {**tok(p["attention1"], "tokens_to_token.attention1"),
          **tok(p["attention2"], "tokens_to_token.attention2"),
          **lin(p["project"], "tokens_to_token.project"),
          "cls_token": t(p["cls_token"]), "pos_embed": t(p["pos_embed"]),
          **nrm(p["norm"], "norm")}
    for i, bp in enumerate(p["blocks"]):
        sd.update(tok(bp, f"blocks.{i}"))
    return sd
