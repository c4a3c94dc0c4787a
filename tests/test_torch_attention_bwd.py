"""The bf16 attention_bwd kernels' order of f32 sums, rendered in torch on
the CPU, against the plain version (attention_bwd_heads_plain).

The query-major kernel of csrc/attention_bwd.cu finds the row statistics
in one pass over 64-key tiles: a running max m, and l = sum exp(s - m) and
r_acc = sum dp exp(s - m) per thread (a lane of a group of four owns
columns 8 j + 2 lane + {0, 1} of each tile), both rescaled by exp(m_old -
m_new) when the max grows, then summed over the group of four and r =
r_acc / max(l, 1e-30) (one reciprocal); the plain version takes the max
and the sums over whole rows.  dq, dk and dv then sum tile by tile in f32.
kernel_order_bwd() renders that order (exact exp where the card takes
ex2.approx of x log2 e, or without a bias of one fma of the raw product;
an f64-emulated fma), and the rendering must keep at least 99%
of the bf16 dq, dk and dv values bit-equal to the plain version's: the
order of the sums moves a rare value by one bf16 ulp, no more.  The CUDA
kernels themselves are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from vitcap_tpu_torch.ops import dropout
from vitcap_tpu_torch.ops.attention_bwd import attention_bwd_heads_plain

TILE = 64     # keys per tile of the query-major kernel, queries of the other


def _fma(a, b, c):
    """f32 a * b + c rounded once (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order_bwd(q, k, v, g, l_actual, bias=None, rate=0.0, seed=0):
    """Per-head bf16 q, k, v, g (B, nH, Lp, hd) -> dq, dk, dv in the
    kernels' order of f32 sums."""
    B, nh, Lp, hd = q.shape
    dt = q.dtype
    scale = hd ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    keep = (dropout.attention_keep(seed, rate, B, nh, Lp, q.device)
            if rate > 0.0 else None)
    inv_rate = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    keys = torch.arange(Lp)

    def tile(rows, k0):
        """Scores (masked: -inf) and dropped dp of query rows `rows` against
        keys [k0, k0 + TILE), padded with masked keys past Lp."""
        cols = slice(k0, min(k0 + TILE, Lp))
        s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[:, :, rows, cols]
        s = s.masked_fill(keys[cols] >= l_actual, float("-inf"))
        dp = gf[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
        if keep is not None:
            dp = torch.where(keep[:, :, rows, cols], dp * inv_rate, 0.0)
        pad = TILE - s.shape[-1]
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        dp = torch.nn.functional.pad(dp, (0, pad))
        return s, dp

    # (a) the statistics pass: per lane of the group of four
    rows = slice(0, Lp)
    m = torch.full((B, nh, Lp, 1), float("-inf"))
    l = torch.zeros(B, nh, Lp, 4)
    r = torch.zeros(B, nh, Lp, 4)
    for k0 in range(0, l_actual, TILE):
        s, dp = tile(rows, k0)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - mn)
        l, r, m = l * corr, r * corr, mn
        x = torch.exp(s - m).unflatten(-1, (8, 4, 2))   # [j][lane][c]
        d = dp.unflatten(-1, (8, 4, 2))
        for j in range(8):
            for c in range(2):
                l = l + x[..., j, :, c]
                r = _fma(d[..., j, :, c], x[..., j, :, c], r)

    def quad(t):
        return ((t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]))[..., None]
    l = quad(l)
    inv = 1.0 / l.clamp_min(1e-30)
    r = quad(r) * inv
    # (a) the ds . K pass
    dq = torch.zeros(B, nh, Lp, hd)
    for k0 in range(0, l_actual, TILE):
        s, dp = tile(rows, k0)
        ds = (torch.exp(s - m) * inv * (dp - r)).to(dt).float()
        kt = torch.nn.functional.pad(kf[:, :, k0:k0 + TILE],
                                     (0, 0, 0, TILE - kf[:, :, k0:k0 + TILE]
                                      .shape[2]))
        dq = dq + ds @ kt
    # (b) over query tiles: p from m and 1 / max(l, 1e-30)
    dk = torch.zeros(B, nh, Lp, hd)
    dv = torch.zeros(B, nh, Lp, hd)
    for t0 in range(0, Lp, TILE):
        qr = slice(t0, min(t0 + TILE, Lp))
        s = (qf[:, :, qr] @ kf.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[:, :, qr]
        p = torch.exp(s - m[:, :, qr]) * inv[:, :, qr]
        p = p.masked_fill(keys >= l_actual, 0.0)
        dp = gf[:, :, qr] @ vf.transpose(-1, -2)
        pd = p
        if keep is not None:
            dp = torch.where(keep[:, :, qr], dp * inv_rate, 0.0)
            pd = torch.where(keep[:, :, qr], p * inv_rate, 0.0)
        ds = (p * (dp - r[:, :, qr])).to(dt).float()
        dv = dv + pd.to(dt).float().transpose(-1, -2) @ gf[:, :, qr]
        dk = dk + ds.transpose(-1, -2) @ qf[:, :, qr]
    return (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt)


@pytest.mark.parametrize("L,Lp,bias_heads,rate", [
    (577, 577, None, 0.0),       # K9 at the trunk length
    (577, 577, 2, 0.0),          # K9 with a per-head bias
    (577, 592, None, 0.0),       # the ViT slab
    (648, 656, 1, 0.1),          # the BERT slab: bias and prob dropout
])
def test_kernel_sum_order_keeps_bits(L, Lp, bias_heads, rate):
    rng = np.random.default_rng(L + Lp)
    B, nh, hd = 1, 2, 64

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    q, k, v, g = (rnd(B, nh, Lp, hd).to(torch.bfloat16) for _ in range(4))
    bias = None
    if bias_heads is not None:
        mask = rng.random((B, bias_heads, Lp, Lp)) > 0.2
        bias = torch.from_numpy(np.where(mask, 0.0, -10000.0)
                                .astype(np.float32)) + 0.5 * rnd(
            B, bias_heads, Lp, Lp)
        bias[..., 0] = 0.0
    got = kernel_order_bwd(q, k, v, g, L, bias, rate, seed=99)
    want = attention_bwd_heads_plain(q, k, v, g, L, bias, rate, seed=99)
    for name, o, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(o.float()).all(), name
        eq = (o == w).float().mean().item()
        assert eq >= 0.99, (name, eq)
        err = (o.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item(), (name, err)
        assert not o[:, :, L:].float().abs().any() or name == "dq"
