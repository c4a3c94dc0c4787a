"""SCAN image-text retrieval (Stacked Cross Attention, Lee et al. 2018), the
port of vitcap_tpu/models/scan.py (reference src/tools/captioning/scan.py
and scan_utils.py, the retrieval model the reference carries next to the
captioner).

- ScanConfig's defaults are the authors' COCO text-to-image setting: 36
  precomputed regions of 2048, a joint space of 1024, 300-d words, a
  one-layer bi-GRU, clipped-l2 attention norm, softmax temperature 9,
  LogSumExp pooling with lambda 6, margin 0.2 and the hardest negative.
- The text encoder is torch nn.GRU's gate math over a masked tail: a
  position past a caption's length carries the state through and outputs
  zero, so the reverse direction starts at the last valid token
  (pack_padded_sequence semantics).  Bi-GRU directions are averaged.
- The (n_image, n_caption) score matrix is computed as batched products
  with validity masks in place of the reference's per-caption slicing,
  cap_chunk captions at a time (the JAX package's lax.map): the pairwise
  (caption, image, word, dim) tensor lives one chunk at a time, so a
  smaller chunk lowers memory and changes no result.
- ScanModel holds the weights in torch's layout (Linear (out, in), GRU
  gates r|z|n), built on an explicit device from an explicit generator;
  scan_params_from_jax carries the JAX package's weights across.
SCAN reaches no Pallas kernel in the JAX package; on the card it runs
cuBLAS products and PyTorch's elementwise kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    img_dim: int = 2048          # precomputed region-feature dim
    vocab_size: int = 30522
    word_dim: int = 300
    embed_size: int = 1024
    num_layers: int = 1          # GRU layers; 0 = embedding only
    bi_gru: bool = True
    no_imgnorm: bool = False
    no_txtnorm: bool = False
    raw_feature_norm: str = "clipped_l2norm"
    lambda_softmax: float = 9.0
    lambda_lse: float = 6.0
    agg_func: str = "LogSumExp"  # LogSumExp | Max | Sum | Mean
    cross_attn: str = "t2i"      # t2i | i2t
    margin: float = 0.2
    max_violation: bool = True
    cap_chunk: int = 128         # captions a chunk in scoring


def l1norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / (x.abs().sum(dim, keepdim=True) + EPS)


def l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + EPS)


# ---------------------------------------------------------------------------
# the model and its weights
# ---------------------------------------------------------------------------

class GruDirection(nn.Module):
    """One direction of one GRU layer, nn.GRU's layout: w_ih (3H, in),
    w_hh (3H, H), gates r|z|n."""

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(3 * hidden, in_dim,
                                             device=device))
        self.w_hh = nn.Parameter(torch.empty(3 * hidden, hidden,
                                             device=device))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden, device=device))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden, device=device))


class ScanModel(nn.Module):
    """The image projection (EncoderImagePrecomp), the word embedding and
    the GRU layers (EncoderText): gru[layer][direction]."""

    def __init__(self, cfg: ScanConfig, device=None):
        super().__init__()
        self.img_proj = nn.Linear(cfg.img_dim, cfg.embed_size, device=device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.word_dim, device=device)
        dirs = 2 if cfg.bi_gru else 1
        self.gru = nn.ModuleList(
            nn.ModuleList(
                GruDirection(cfg.word_dim if li == 0
                             else cfg.embed_size * dirs, cfg.embed_size,
                             device=device)
                for _ in range(dirs))
            for li in range(cfg.num_layers))


def init_scan_params(cfg: ScanConfig,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> ScanModel:
    """Random weights by the JAX package's rule (the reference's): the
    image projection uniform in +-sqrt(6 / (img_dim + embed)) with a zero
    bias, the embedding uniform in +-0.1, every GRU tensor uniform in
    +-embed**-0.5.  Drawn on the CPU from `generator` (a CPU generator) in
    state-dict order, then moved to `device`: the card unless the caller
    asks for another (device="cpu")."""
    model = ScanModel(cfg, device="meta").to_empty(device=device)
    r = (6.0 / (cfg.img_dim + cfg.embed_size)) ** 0.5
    s = cfg.embed_size ** -0.5
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "img_proj.bias":
                p.zero_()
                continue
            lim = r if name == "img_proj.weight" else \
                0.1 if name == "embed.weight" else s
            t = torch.empty(p.shape)
            t.uniform_(-lim, lim, generator=generator)
            p.copy_(t)
    return model


def scan_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SCAN param tree (numpy leaves) -> a ScanModel state
    dict (CPU f32 tensors)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))
    sd = {"img_proj.weight": t(np.asarray(params["img_proj"]["kernel"]).T),
          "img_proj.bias": t(params["img_proj"]["bias"]),
          "embed.weight": t(params["embed"])}
    for li, layer in enumerate(params.get("gru", [])):
        for d, lp in enumerate(layer):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                sd[f"gru.{li}.{d}.{k}"] = t(lp[k])
    return sd


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def gru_direction(lp: GruDirection, x: torch.Tensor, lengths: torch.Tensor,
                  reverse: bool) -> torch.Tensor:
    """One GRU direction over (B, L, D) -> (B, L, H), nn.GRU's gate math.
    Positions >= length carry h through and output zero; the reverse
    direction runs from L-1 down, so it starts at each sequence's last
    valid token."""
    B, L, _ = x.shape
    H = lp.w_hh.shape[1]
    gi_all = F.linear(x, lp.w_ih, lp.b_ih)                 # (B, L, 3H)
    valid_all = (torch.arange(L, device=x.device)[None]
                 < lengths[:, None])[..., None]            # (B, L, 1)
    h = x.new_zeros(B, H)
    outs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gh = F.linear(h, lp.w_hh, lp.b_hh)
        i_r, i_z, i_n = gi_all[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1 - z) * n + z * h
        valid = valid_all[:, t]
        h = torch.where(valid, h_new, h)
        outs[t] = torch.where(valid, h_new, 0.0)
    return torch.stack(outs, dim=1)


def encode_text(model: ScanModel, cap_ids: torch.Tensor,
                lengths: torch.Tensor, cfg: ScanConfig) -> torch.Tensor:
    """(B, L) token ids -> (B, L, embed) (reference EncoderText.forward;
    bi-GRU directions averaged, then l2-normalised)."""
    x = model.embed(cap_ids)
    if cfg.num_layers:
        for layer in model.gru:
            fwd = gru_direction(layer[0], x, lengths, reverse=False)
            if cfg.bi_gru:
                bwd = gru_direction(layer[1], x, lengths, reverse=True)
                x = torch.cat([fwd, bwd], dim=-1)
            else:
                x = fwd
        if cfg.bi_gru:
            H = x.shape[-1] // 2
            x = (x[..., :H] + x[..., H:]) / 2
    else:
        valid = torch.arange(x.shape[1], device=x.device)[None] \
            < lengths[:, None]
        x = torch.where(valid[..., None], x, 0.0)
    if not cfg.no_txtnorm:
        x = l2norm(x, -1)
    return x


def encode_image(model: ScanModel, feats: torch.Tensor,
                 cfg: ScanConfig) -> torch.Tensor:
    """(B, R, img_dim) region features -> (B, R, embed)
    (reference EncoderImagePrecomp)."""
    x = model.img_proj(feats)
    if not cfg.no_imgnorm:
        x = l2norm(x, -1)
    return x


# ---------------------------------------------------------------------------
# stacked cross attention (reference func_attention scan_utils.py:236-292)
# ---------------------------------------------------------------------------

def func_attention(query: torch.Tensor, context: torch.Tensor,
                   cfg: ScanConfig, smooth: float,
                   q_valid: Optional[torch.Tensor] = None,
                   c_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (..., Lq, d), context (..., Ls, d), leading axes broadcast ->
    (weighted context (..., Lq, d), attn (..., Ls, Lq)).  q_valid (...,
    Lq) and c_valid (..., Ls) replace the reference's variable-length
    slicing."""
    attn = torch.einsum("...sd,...qd->...sq", context, query)
    norm = cfg.raw_feature_norm
    if norm == "softmax":
        # the reference softmaxes over queryL
        if q_valid is not None:
            attn = torch.where(q_valid[..., None, :], attn, -1e30)
        attn = torch.softmax(attn, dim=-1)
    elif norm == "l2norm":
        attn = l2norm(attn, -1)
    elif norm == "clipped_l2norm":
        attn = l2norm(F.leaky_relu(attn, 0.1), -1)
    elif norm == "l1norm":
        attn = l1norm(attn, -1)
    elif norm == "clipped_l1norm":
        attn = l1norm(F.leaky_relu(attn, 0.1), -1)
    elif norm == "clipped":
        attn = F.leaky_relu(attn, 0.1)
    elif norm != "no_norm":
        raise ValueError(f"unknown raw_feature_norm {norm}")
    # softmax over sourceL with temperature
    a = attn.transpose(-1, -2) * smooth                   # (..., Lq, Ls)
    if c_valid is not None:
        a = torch.where(c_valid[..., None, :], a, -1e30)
    a = torch.softmax(a, dim=-1)
    weighted = torch.einsum("...qs,...sd->...qd", a, context)
    return weighted, a.transpose(-1, -2)


def _cosine(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    w12 = (x1 * x2).sum(-1)
    w1 = torch.linalg.vector_norm(x1, dim=-1)
    w2 = torch.linalg.vector_norm(x2, dim=-1)
    return w12 / (w1 * w2).clamp_min(EPS)


def _aggregate(row_sim: torch.Tensor, valid: Optional[torch.Tensor],
               n_valid: torch.Tensor, cfg: ScanConfig) -> torch.Tensor:
    """row_sim (..., L) -> (...) by the reference's pooling; `valid` masks
    padded entries."""
    if cfg.agg_func == "LogSumExp":
        e = torch.exp(row_sim * cfg.lambda_lse)
        if valid is not None:
            e = torch.where(valid, e, 0.0)
        return torch.log(e.sum(-1).clamp_min(EPS)) / cfg.lambda_lse
    if cfg.agg_func == "Max":
        if valid is not None:
            row_sim = torch.where(valid, row_sim, -torch.inf)
        return row_sim.amax(-1)
    if cfg.agg_func == "Sum":
        if valid is not None:
            row_sim = torch.where(valid, row_sim, 0.0)
        return row_sim.sum(-1)
    if cfg.agg_func == "Mean":
        if valid is not None:
            row_sim = torch.where(valid, row_sim, 0.0)
        return row_sim.sum(-1) / n_valid
    raise ValueError(f"unknown agg_func {cfg.agg_func}")


def _chunks(n: int, size: int):
    for lo in range(0, n, size):
        yield slice(lo, min(lo + size, n))


def xattn_score_t2i(img_emb: torch.Tensor, cap_emb: torch.Tensor,
                    cap_lens: torch.Tensor, cfg: ScanConfig) -> torch.Tensor:
    """(n_img, R, d), (n_cap, Lw, d), (n_cap,) -> scores (n_img, n_cap):
    each caption's words attend every image's regions."""
    Lw = cap_emb.shape[1]
    words = torch.arange(Lw, device=cap_emb.device)
    sims = []
    for sl in _chunks(cap_emb.shape[0], cfg.cap_chunk):
        cap = cap_emb[sl][:, None]                      # (c, 1, Lw, d)
        ln = cap_lens[sl][:, None]                      # (c, 1)
        q_valid = (words < ln[..., None])               # (c, 1, Lw)
        wctx, _ = func_attention(cap, img_emb[None], cfg,
                                 smooth=cfg.lambda_softmax, q_valid=q_valid)
        row = _cosine(cap, wctx)                        # (c, n_img, Lw)
        sims.append(_aggregate(row, q_valid, ln.to(row.dtype), cfg))
    return torch.cat(sims).T


def xattn_score_i2t(img_emb: torch.Tensor, img_lens: torch.Tensor,
                    cap_emb: torch.Tensor, cap_lens: torch.Tensor,
                    cfg: ScanConfig) -> torch.Tensor:
    """(n_img, R, d), (n_img,), (n_cap, Lw, d), (n_cap,) -> (n_img,
    n_cap): each image's regions attend every caption's words."""
    R, Lw = img_emb.shape[1], cap_emb.shape[1]
    r_valid = torch.arange(R, device=img_emb.device)[None] \
        < img_lens[:, None]                             # (n_img, R)
    words = torch.arange(Lw, device=cap_emb.device)
    sims = []
    for sl in _chunks(cap_emb.shape[0], cfg.cap_chunk):
        cap = cap_emb[sl][:, None]                      # (c, 1, Lw, d)
        c_valid = words < cap_lens[sl][:, None, None]   # (c, 1, Lw)
        wctx, _ = func_attention(img_emb[None], cap, cfg,
                                 smooth=cfg.lambda_softmax, c_valid=c_valid)
        row = _cosine(img_emb[None], wctx)              # (c, n_img, R)
        sims.append(_aggregate(row, r_valid, img_lens.to(row.dtype), cfg))
    return torch.cat(sims).T


def scan_scores(img_emb, img_lens, cap_emb, cap_lens, cfg: ScanConfig):
    if cfg.cross_attn == "t2i":
        return xattn_score_t2i(img_emb, cap_emb, cap_lens, cfg)
    if cfg.cross_attn == "i2t":
        return xattn_score_i2t(img_emb, img_lens, cap_emb, cap_lens, cfg)
    raise ValueError(f"unknown cross_attn {cfg.cross_attn}")


# ---------------------------------------------------------------------------
# loss + retrieval metrics
# ---------------------------------------------------------------------------

def contrastive_loss(scores: torch.Tensor, cfg: ScanConfig) -> torch.Tensor:
    """Bidirectional hinge over the (B, B) in-batch score matrix
    (reference ContrastiveLoss scan_utils.py:455-498)."""
    B = scores.shape[0]
    diag = scores.diagonal()
    cost_s = (cfg.margin + scores - diag[:, None]).clamp_min(0.0)
    cost_im = (cfg.margin + scores - diag[None, :]).clamp_min(0.0)
    eye = torch.eye(B, dtype=torch.bool, device=scores.device)
    cost_s = torch.where(eye, 0.0, cost_s)
    cost_im = torch.where(eye, 0.0, cost_im)
    if cfg.max_violation:
        cost_s = cost_s.amax(dim=1)
        cost_im = cost_im.amax(dim=0)
    return cost_s.sum() + cost_im.sum()


def scan_forward(model: ScanModel, img_feats: torch.Tensor,
                 img_lens: Optional[torch.Tensor], cap_ids: torch.Tensor,
                 cap_lens: torch.Tensor, cfg: ScanConfig,
                 train: bool = True):
    """Training: the contrastive loss over the in-batch score matrix.
    Eval: (img_emb, cap_emb) for corpus-level retrieval (reference
    SCAN.forward scan.py:75-287)."""
    img_emb = encode_image(model, img_feats, cfg)
    cap_emb = encode_text(model, cap_ids, cap_lens, cfg)
    if not train:
        return img_emb, cap_emb
    scores = scan_scores(img_emb, img_lens, cap_emb, cap_lens, cfg)
    return contrastive_loss(scores, cfg)


def retrieval_metrics(scores, caps_per_image: int = 5) -> Dict[str, float]:
    """i2t / t2i R@{1,5,10} and median rank.  scores (n_img, n_cap) (a
    tensor or an array); caption j belongs to image j // caps_per_image."""
    s = (scores.detach().float().cpu().numpy()
         if isinstance(scores, torch.Tensor) else np.asarray(scores))
    n_img, n_cap = s.shape
    ranks = []
    for i in range(n_img):                              # image -> text
        order = np.argsort(-s[i])
        gold = list(range(i * caps_per_image, (i + 1) * caps_per_image))
        ranks.append(min(np.where(np.isin(order, gold))[0]))
    ranks = np.array(ranks)
    out = {f"i2t_R@{k}": float((ranks < k).mean() * 100) for k in (1, 5, 10)}
    out["i2t_medr"] = float(np.median(ranks) + 1)
    tranks = []
    for j in range(n_cap):                              # text -> image
        order = np.argsort(-s[:, j])
        tranks.append(int(np.where(order == j // caps_per_image)[0][0]))
    tranks = np.array(tranks)
    out.update({f"t2i_R@{k}": float((tranks < k).mean() * 100)
                for k in (1, 5, 10)})
    out["t2i_medr"] = float(np.median(tranks) + 1)
    return out
