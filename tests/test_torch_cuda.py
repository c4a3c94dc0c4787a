"""vitcap_tpu_torch CUDA kernels vs their plain PyTorch versions, on a card.

Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device the `cuda` tests skip (chip_smoke.py checks the
kernels at the flagship shapes); the rest check the wrappers' device rules.
"""

import copy

import numpy as np
import pytest
import torch

from vitcap_tpu_torch import ops
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import layers as TL
from vitcap_tpu_torch.models.config import tiny_config
from vitcap_tpu_torch.models.vitcap import init_params
from vitcap_tpu_torch.ops.attention import attention, attention_plain
from vitcap_tpu_torch.ops.attention_bwd import attention_bwd
from vitcap_tpu_torch.ops.decode_step import (decode_attention,
                                              decode_attention_plain,
                                              fused_decode_step,
                                              fused_decode_step_plain,
                                              pack_decode_context,
                                              pack_decode_layers, plan)
from vitcap_tpu_torch.ops.fused_block import fused_bert_block, fused_vit_block
from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain

NO_CUDA = "no CUDA device; kernels are checked by chip_smoke.py"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(NO_CUDA)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def plain_attention(monkeypatch):
    """models.layers' attention routes on their plain versions, so a plain
    block on the card launches no kernel: the reference a fused block is
    held to."""
    from vitcap_tpu_torch.ops import flash_attention as FA
    monkeypatch.setattr(TL, "flash_attention", FA.flash_attention_plain)
    monkeypatch.setattr(TL, "flash_attention_packed",
                        FA.flash_attention_packed_plain)


def _close(out, ref, dtype):
    """f32: 1e-4 (at least absolute); bf16: 2e-2 of the output's scale."""
    out, ref = out.float().cpu(), ref.float().cpu()
    assert torch.isfinite(out).all()
    scale = ref.abs().max().item()
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
    err = (out - ref).abs().max().item()
    assert err <= tol, (err, tol)


def test_wrappers_refuse_devices_without_a_kernel():
    """A wrapper runs the plain version only for CPU tensors: any other
    device gets its kernel or an error, never a silent fallback."""
    a = torch.empty(4, 8, device="meta")
    with pytest.raises(RuntimeError):
        gemm(a, torch.empty(8, 8, device="meta"))
    with pytest.raises(RuntimeError):
        layer_norm(a, torch.ones(8), torch.zeros(8), 1e-6, torch.float32)
    with pytest.raises(RuntimeError):
        attention(torch.empty(1, 4, 24, device="meta"), 2, 4)
    m = torch.empty(2, 5, 8, device="meta")
    with pytest.raises(RuntimeError):
        decode_attention(torch.empty(2, 2, 24, device="meta"), m, m, m, m,
                         torch.empty(2, 5, device="meta"),
                         torch.empty(1, dtype=torch.int32, device="meta"), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gemm_and_layer_norm_match_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    M, K, N = 240, 96, 136                 # ragged against every tile
    a = torch.randn(M, K, generator=g).to(cuda, dtype)
    w = (torch.randn(N, K, generator=g) * 0.1).to(cuda, dtype)
    b = torch.randn(N, generator=g).to(cuda)
    r = torch.randn(M, N, generator=g).to(cuda, dtype)
    for kw in (dict(), dict(gelu=True), dict(residual=r),
               dict(gelu=True, f32_sum=True),
               dict(residual=r, f32_sum=True, out_f32=True)):
        out, ref = gemm(a, w, b, **kw), gemm_plain(a, w, b, **kw)
        _close(out, ref, dtype)
        if out.dtype == torch.bfloat16:    # same rounding points as plain
            assert (out == ref).float().mean().item() >= 0.99
    for in_dt in (dtype, torch.float32):
        x = (torch.randn(M, N, generator=g) * 3 + 1).to(cuda, in_dt)
        _close(layer_norm(x, b, b, 1e-12, dtype),
               layer_norm_plain(x, b, b, 1e-12, dtype), dtype)
    with pytest.raises(ValueError):
        gemm(a[:, :90].contiguous(), w[:, :90].contiguous())   # K % 8


def _gemm_inputs(dev, M, K, N, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) * 0.05).to(dev, torch.bfloat16)
    b = (torch.randn(N, generator=g) * 0.1).to(dev)
    r = torch.randn(M, N, generator=g).to(dev, torch.bfloat16)
    return a, w, b, r


def _gemm_modes(r, rows_per_image):
    """Every epilogue mode of ops.gemm: (name, keyword arguments)."""
    return [("default", {}), ("gelu", dict(gelu=True)),
            ("residual", dict(residual=r)),
            ("pre_out", dict(gelu=True, pre_out=True)),
            ("f32_sum", dict(f32_sum=True)),
            ("f32_sum gelu", dict(f32_sum=True, gelu=True)),
            ("f32_sum residual", dict(f32_sum=True, residual=r)),
            ("f32_sum residual out_f32",
             dict(f32_sum=True, residual=r, out_f32=True)),
            ("out_f32", dict(out_f32=True)),
            ("dropout 0", dict(residual=r,
                               dropout=(0.0, 5, 0, rows_per_image))),
            ("dropout 0.1", dict(residual=r,
                                 dropout=(0.1, -918273, 1, rows_per_image)))]


def _check_gemm_modes(a, w, b, r, rows_per_image):
    """Each mode against gemm_plain: rounded outputs (bf16, or the bf16
    value stored as f32 by out_f32 without f32_sum) and the pre-GELU store
    at least 99% bit-equal and close; f32 sums within 1e-5 of their scale
    (only the order of the f32 sums differs)."""
    from vitcap_tpu_torch.ops.gemm import plan
    M, N = a.shape[0], w.shape[0]
    for name, kw in _gemm_modes(r, rows_per_image):
        pre = pre_ref = None
        if kw.pop("pre_out", False):
            pre, pre_ref = (torch.empty(M, N, dtype=a.dtype, device=a.device)
                            for _ in range(2))
        out = gemm(a, w, b, pre_out=pre, **kw)
        ref = gemm_plain(a, w, b, pre_out=pre_ref, **kw)
        where = (name, tuple(a.shape), N, plan(M, N, a.shape[1]))
        assert out.dtype == ref.dtype and out.shape == (M, N), where
        if kw.get("f32_sum") and out.dtype == torch.float32:
            err = (out - ref).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item(), where
        else:
            _close(out, ref, torch.bfloat16)
            assert (out == ref).float().mean().item() >= 0.99, where
        if pre is not None:
            _close(pre, pre_ref, torch.bfloat16)
            assert (pre == pre_ref).float().mean().item() >= 0.99, where


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 64, 128, 130, 384])
def test_cuda_bf16_gemm_modes_small_m(cuda, M):
    """gemm_split_kernel (K split over a cluster) at the decode step's and
    smaller row counts, every epilogue mode, the four products' widths."""
    from vitcap_tpu_torch.ops.gemm import plan
    for K, N in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        assert plan(M, N, K) > 0
        a, w, b, r = _gemm_inputs(cuda, M, K, N, M + K + N)
        _check_gemm_modes(a, w, b, r, 1 if M % 2 else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [96, 768, 3072])
def test_cuda_bf16_gemm_modes_ragged_wide(cuda, K):
    """gemm_wide_kernel where M cuts a 128-row tile (2000 = 15 x 128 + 80),
    N cuts a 256-column tile (2312) and, at 96, K cuts a 64-deep step;
    K = 3072 runs the 4-stage ring round 12 times."""
    from vitcap_tpu_torch.ops.gemm import plan
    M, N = 2000, 2312
    assert plan(M, N, K) == 0
    a, w, b, r = _gemm_inputs(cuda, M, K, N, K)
    _check_gemm_modes(a, w, b, r, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_image,images", [(592, 2), (1104, 5)])
def test_cuda_bf16_gemm_dropout_rows_per_image(cuda, rows_per_image, images):
    """The K7 dropout epilogue where tiles cross image boundaries (592 and
    1104 rows are not multiples of 64 or 128): 2 x 592 rows take the split
    kernel, 5 x 1104 the wide one."""
    from vitcap_tpu_torch.ops.gemm import plan
    M, K, N = rows_per_image * images, 768, 768
    assert (plan(M, N, K) == 0) == (rows_per_image == 1104)
    a, w, b, r = _gemm_inputs(cuda, M, K, N, rows_per_image)
    for rate in (0.0, 0.1):
        drop = (rate, 1234567, 1, rows_per_image)
        out = gemm(a, w, b, residual=r, dropout=drop)
        ref = gemm_plain(a, w, b, residual=r, dropout=drop)
        _close(out, ref, torch.bfloat16)
        assert (out == ref).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(128, 3072, 768), (384, 768, 2304),
                                   (2000, 3072, 768)])
def test_cuda_bf16_gemm_deterministic(cuda, M, K, N):
    """Two calls give the same bits: the split kernel adds its ranks'
    partials in rank order, the wide kernel splits nothing."""
    a, w, b, r = _gemm_inputs(cuda, M, K, N, 1)
    for kw in (dict(f32_sum=True, residual=r, out_f32=True),
               dict(gelu=True)):
        assert torch.equal(gemm(a, w, b, **kw), gemm(a, w, b, **kw))


@pytest.mark.cuda
def test_cuda_decode_attention_and_layer_norm_kernel_info(cuda):
    """kernel_info() reads every listed kernel's launch configuration: the
    kernels fit at least one block an SM at the 384-px beam-3 plan.  Read
    at a small geometry, it leaves the kernels able to launch at larger
    ones (f32 and bf16, the simple and the cluster kernel)."""
    from vitcap_tpu_torch.ops import decode_step as DS
    from vitcap_tpu_torch.ops import layer_norm as LN
    ln = LN.kernel_info()
    assert len(ln) == 4
    da = DS.kernel_info(628, 3)
    assert [k["name"].split("<")[0] for k in da] == [
        "decode_attention_cluster_kernel"] * 2 + [
        "decode_attention_simple_kernel"] * 2
    for k in ln + da:
        assert k["blocks_per_sm"] >= 1 and k["registers"] <= 255, k
    assert da[0]["ranks"] == 5
    DS.kernel_info(70, 1, 6)
    B, nb, nh, S, A, t = 1, 3, 2, 628, 20, 5
    for dtype in (torch.float32, torch.bfloat16):
        d = _decode_inputs(cuda, dtype, B, nb, 128, S, A, seed=9)
        qkv = torch.randn(B * nb, 2, 384, generator=torch.Generator()
                          .manual_seed(9)).to(cuda, dtype)
        bias = torch.where(d["valid"], 0.0, -10000.0).float().contiguous()
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        out = decode_attention(qkv, *caps, d["ctx_k"], d["ctx_v"], bias,
                               torch.tensor([t], dtype=torch.int32,
                                            device=cuda), nh)
        _close(out, decode_attention_plain(qkv, d["cap_k"], d["cap_v"],
                                           d["ctx_k"], d["ctx_v"], bias, t,
                                           nh), dtype)


@pytest.mark.cuda
def test_cuda_gemm_kernel_info(cuda):
    """Both bf16 gemm kernels are compiled per epilogue kind, without
    spills, and fit on an SM."""
    from vitcap_tpu_torch.ops import gemm as G
    info = G.kernel_info()
    names = [k["name"] for k in info]
    assert len(info) == 10
    assert sum(n.startswith("gemm_wide_kernel") for n in names) == 5
    assert sum(n.startswith("gemm_split_kernel") for n in names) == 5
    for k in info:
        assert k["local_bytes"] == 0 and k["blocks_per_sm"] >= 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 40, 64, 128])
def test_cuda_attention_matches_plain(cuda, dtype, hd):
    """Tensor-core (bf16, any hd) and CUDA-core (f32) kernels, ragged L,
    with and without the additive bias."""
    g = torch.Generator().manual_seed(hd)
    nh, B, L, Lp = 2, 3, 70, 80
    slab = torch.randn(B, Lp, 3 * nh * hd, generator=g).to(cuda, dtype)
    bias = torch.where(torch.rand(B, 1, Lp, Lp, generator=g) > 0.3, 0.0,
                       -10000.0).to(cuda)
    bias[..., 0] = 0.0                     # every row sees a key
    for bb in (None, bias):
        out, ref = attention(slab, nh, L, bb), attention_plain(slab, nh, L, bb)
        _close(out, ref, dtype)
        _bits_equal(out, ref)


def _bf16_attention_case(cuda, online, L, Lp, hd, bias_heads, rate=0.0,
                         nh=2, B=2, seed=0):
    """One bf16 attention call against its plain version on the card: the
    two-pass function over a (B, Lp, 3H) slab with l_actual L, or the
    online one over per-head (B, nH, L, hd) views (Lp = L); bias None
    (bias_heads None) or (B, bias_heads, Lp, Lp).  Within 2e-2 of the
    output's scale and at least 99% of values bit-equal."""
    from vitcap_tpu_torch.ops.attention import (attention_heads,
                                                attention_heads_plain,
                                                heads_view)
    g = torch.Generator().manual_seed(seed)
    slab = torch.randn(B, Lp, 3 * nh * hd, generator=g).to(cuda,
                                                           torch.bfloat16)
    bias = None
    if bias_heads is not None:
        bias = torch.where(torch.rand(B, bias_heads, Lp, Lp, generator=g)
                           > 0.3, 0.0, -10000.0)
        bias += 0.5 * torch.randn(B, bias_heads, Lp, Lp, generator=g)
        bias[..., 0] = 0.0
        bias = bias.to(cuda)
    ops.reset_counts()
    if online:
        q, k, v = (heads_view(t, nh) for t in slab.split(nh * hd, dim=-1))
        out = attention_heads(q, k, v, bias, online=True)
        ref = attention_heads_plain(q, k, v, L, bias, online=True)
        assert ops.mode_counts()["attention[online]"] == 1
    else:
        out = attention(slab, nh, L, bias, rate, 1234)
        ref = attention_plain(slab, nh, L, bias, rate, 1234)
    assert ops.launch_counts()["attention"] == 1
    _close(out, ref, torch.bfloat16)
    _bits_equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129])
def test_cuda_bf16_attention_ragged_lengths(cuda, online, past, L):
    """The wgmma kernels at l_actual on both sides of a key tile's edge
    (and one tile further), Lp not a multiple of 64 (two-pass: Lp = L + 5),
    with no bias, a (B, 1, Lp, Lp) and a per-head bias; the two-pass
    function also with prob dropout."""
    L += past * (128 if online else 64)
    Lp = L if online else L + 5
    for bias_heads in (None, 1, 2):
        _bf16_attention_case(cuda, online, L, Lp, 64, bias_heads, seed=L)
    if not online:
        _bf16_attention_case(cuda, False, L, Lp, 64, 1, rate=0.1, seed=L)


@pytest.mark.cuda
@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("hd", [8, 40, 64, 128])
def test_cuda_bf16_attention_head_dims(cuda, online, hd):
    """Every head size runs on the tensor cores, padded to 64 or 128 with
    zeros, in both modes and with each bias kind (and dropout)."""
    L = 200 if online else 150
    for bias_heads in (None, 1, 3):
        _bf16_attention_case(cuda, online, L, L if online else 171, hd,
                             bias_heads, nh=3, seed=hd)
    if not online:
        _bf16_attention_case(cuda, False, L, 171, hd, 3, rate=0.2, nh=3,
                             seed=hd)


@pytest.mark.cuda
def test_cuda_bf16_online_attention_long_per_head_bias(cuda):
    """K9's online mode at L 1030 (nine 128-key tiles, the last ragged)
    with a per-head bias and without one."""
    for bias_heads in (4, None):
        _bf16_attention_case(cuda, True, 1030, 1030, 64, bias_heads, nh=4,
                             seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("L,Lp", [(70, 80), (1030, 1100)])
def test_cuda_bf16_attention_padded_rows_stay_apart(cuda, L, Lp):
    """Padded query rows and padded keys (at and past l_actual) are the
    caller's to fill: any values there leave the valid rows' outputs
    unchanged, bit for bit."""
    g = torch.Generator().manual_seed(L)
    nh, hd = 2, 64
    slab = torch.randn(2, Lp, 3 * nh * hd, generator=g)
    bias = torch.randn(2, 1, Lp, Lp, generator=g)
    noisy = slab.clone()
    noisy[:, L:] = 1e4 * torch.randn(2, Lp - L, 3 * nh * hd, generator=g)
    outs = [attention(s.to(cuda, torch.bfloat16), nh, L, bias.to(cuda))
            for s in (slab, noisy)]
    assert torch.equal(outs[0][:, :L], outs[1][:, :L])
    assert torch.isfinite(outs[1][:, :L].float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_blocks_match_plain_blocks(cuda, plain_attention,
                                             dtype):
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=512)
    model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 130, 128, generator=g).to(cuda, dtype)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    _close(fused_vit_block(blk, x, 2, 1e-6),
           TL._vit_block_plain(blk, x, 2, 1e-6), dtype)
    bias = torch.zeros(2, 1, 130, 130, device=cuda)
    bias[:, :, 20:, :20] = -10000.0
    _close(fused_bert_block(layer, x, bias, 2, 1e-12),
           TL._bert_layer_plain(layer, x, bias, 2, 1e-12), dtype)


@pytest.mark.cuda
def test_cuda_greedy_runs_the_kernels_and_matches_cpu(cuda):
    """tiny_config(img_size=128): 5 full ViT blocks + 1 prefill layer per
    batch, so 24 gemm, 12 layer_norm and 6 attention launches; f32 ids
    equal the CPU run's (plain versions)."""
    cfg = tiny_config(img_size=128)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(rs.randint(0, 256, (2, 128, 128, 3))
                            .astype(np.uint8))
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    opts = TD.DecodeOptions(max_length=cfg.max_gen_length,
                            od_labels_start_posid=cfg.max_seq_a_len)

    def run(model, dev):
        return TD.generate(model, imgs.to(dev),
                           torch.zeros(2, od_len, dtype=torch.long,
                                       device=dev), None,
                           torch.full((2,), cfg.max_seq_a_len, device=dev),
                           cfg, opts)
    ref = run(cpu_model, "cpu")
    ops.reset_counts()
    out = run(gpu_model, cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gemm": 24, "layer_norm": 12,
                                   "attention": 6, "attention_bwd": 0,
                                   "decode_attention": 0}
    assert torch.equal(out["ids"].cpu(), ref["ids"])
    _close(out["tag_logits"], ref["tag_logits"], torch.float32)


def _decode_inputs(dev, dtype, B, nb, H, S, A, nL=None, seed=0):
    """Random flat-layout decode inputs: window qkv (or hidden state when
    nL is given), caption caches with history, context K/V, a per-image
    od validity."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dtype)
    lead = () if nL is None else (nL,)
    valid = torch.rand(B, S, generator=g) > 0.3
    valid[:, -1] = True
    return dict(ctx_k=rnd(*lead, B, S, H), ctx_v=rnd(*lead, B, S, H),
                cap_k=rnd(*lead, B * nb, A, H), cap_v=rnd(*lead, B * nb, A, H),
                valid=valid.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,nb,S", [(8, 1, 70), (64, 1, 70), (64, 3, 70),
                                     (128, 8, 70), (32, 10, 70),
                                     (64, 4, 2000), (64, 10, 70),
                                     (64, 3, 628), (128, 3, 628),
                                     (64, 1, 1076), (64, 8, 1076),
                                     (128, 1, 2000), (64, 1, 200),
                                     (64, 3, 780)])
def test_cuda_decode_attention_matches_plain(cuda, dtype, hd, nb, S):
    """Output and the in-place caption-cache write, every head size the
    kernels are built for, one to ten beams per image (more than 16 window
    rows take a second pass over V, or a second row tile), contexts that
    take every cluster size plan() picks here (1, 2, 5, 6, 8 ranks) and
    one that needs more than 48 KB of shared memory, t at both ends.  bf16
    on the cluster kernel: at least 99% of the outputs bit-equal over 64
    images, the precondition of PERF.md section 2 (S = 2000 included).
    A call of 3 images is not held to it: its tensor-core scores differ
    from the plain version's in a last bit now and then, and a (head, row)
    pair whose largest probabilities then round otherwise moves about a
    fifth of its outputs by an ulp, 1-2% of such a call's share at any
    length (F9, open; chip_smoke.py's sweep reports those shares)."""
    B, nh, A = 3, 2, 6
    H = nh * hd
    for t in (1, 4, A):
        d = _decode_inputs(cuda, dtype, B, nb, H, S, A, seed=t)
        g = torch.Generator().manual_seed(100 + t)
        qkv = torch.randn(B * nb, 2, 3 * H, generator=g).to(cuda, dtype)
        bias = torch.where(d["valid"], 0.0, -10000.0).float().contiguous()
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        ref = decode_attention_plain(qkv, d["cap_k"], d["cap_v"],
                                     d["ctx_k"], d["ctx_v"], bias, t, nh)
        ops.reset_counts()
        out = decode_attention(qkv, *caps, d["ctx_k"], d["ctx_v"], bias,
                               torch.tensor([t], dtype=torch.int32,
                                            device=cuda), nh)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == 1
        _close(out, ref, dtype)
        assert torch.equal(caps[0], d["cap_k"])
        assert torch.equal(caps[1], d["cap_v"])
    if plan(S, nb, hd, A, dtype).ranks:
        Bm, t = 64, 4
        d = _decode_inputs(cuda, dtype, Bm, nb, H, S, A, seed=7)
        g = torch.Generator().manual_seed(107)
        qkv = torch.randn(Bm * nb, 2, 3 * H, generator=g).to(cuda, dtype)
        bias = torch.where(d["valid"], 0.0, -10000.0).float().contiguous()
        ref = decode_attention_plain(qkv, d["cap_k"], d["cap_v"],
                                     d["ctx_k"], d["ctx_v"], bias, t, nh)
        out = decode_attention(qkv, d["cap_k"].clone(), d["cap_v"].clone(),
                               d["ctx_k"], d["ctx_v"], bias,
                               torch.tensor([t], dtype=torch.int32,
                                            device=cuda), nh)
        _close(out, ref, dtype)
        assert (out == ref).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_beam_groups_match_plain(cuda, dtype):
    """160 beams an image, constrained beam search's 32 FSM states of 5
    beams: 10 groups of 16 beams, each a launch row reading its image's
    context (bf16 the cluster kernel, f32 the simple one), against the
    plain version over 4 images at the flagship width (S 628, 12 heads of
    64, A 20), t at both ends: the caption caches equal, bf16 at least
    99% of the outputs bit-equal; bf16 launches count as grouped."""
    B, nb, nh, hd, S, A = 4, 160, 12, 64, 628, 20
    H = nh * hd
    p = plan(S, nb, hd, A, dtype)
    assert p.groups == 10 and bool(p.ranks) == (dtype == torch.bfloat16)
    for t in (1, A):
        d = _decode_inputs(cuda, dtype, B, nb, H, S, A, seed=t)
        g = torch.Generator().manual_seed(200 + t)
        qkv = torch.randn(B * nb, 2, 3 * H, generator=g).to(cuda, dtype)
        bias = torch.where(d["valid"], 0.0, -10000.0).float().contiguous()
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        ref = decode_attention_plain(qkv, d["cap_k"], d["cap_v"],
                                     d["ctx_k"], d["ctx_v"], bias, t, nh)
        ops.reset_counts()
        out = decode_attention(qkv, *caps, d["ctx_k"], d["ctx_v"], bias,
                               torch.tensor([t], dtype=torch.int32,
                                            device=cuda), nh)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == 1
        assert ops.mode_counts()["decode_attention[groups]"] == \
            int(dtype == torch.bfloat16)
        _close(out, ref, dtype)
        assert torch.equal(caps[0], d["cap_k"])
        assert torch.equal(caps[1], d["cap_v"])
        if dtype == torch.bfloat16:
            assert (out == ref).float().mean().item() >= 0.99, t


@pytest.mark.cuda
@pytest.mark.parametrize("S,nb", [(628, 3), (1076, 1)])
def test_cuda_decode_attention_deterministic_in_a_graph(cuda, S, nb):
    """The cluster kernel gives the same bits on every call, and a CUDA
    graph captured at one t serves another: t is read on the card."""
    B, nh, hd, A = 2, 2, 64, 20
    H = nh * hd
    d = _decode_inputs(cuda, torch.bfloat16, B, nb, H, S, A, seed=S)
    qkv = torch.randn(B * nb, 2, 3 * H, generator=torch.Generator()
                      .manual_seed(7)).to(cuda, torch.bfloat16)
    bias = torch.where(d["valid"], 0.0, -10000.0).float().contiguous()
    t_dev = torch.tensor([3], dtype=torch.int32, device=cuda)
    caps = [d["cap_k"].clone(), d["cap_v"].clone()]
    args = (qkv, *caps, d["ctx_k"], d["ctx_v"], bias, t_dev, nh)
    first = decode_attention(*args)
    assert torch.equal(decode_attention(*args), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(*args)
    for t in (3, 1, A):
        t_dev.fill_(t)
        graph.replay()
        torch.cuda.synchronize()
        ref = decode_attention_plain(qkv, d["cap_k"], d["cap_v"],
                                     d["ctx_k"], d["ctx_v"], bias, t, nh)
        assert (out == ref).float().mean().item() >= 0.99, t
        _close(out, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [100, 136, 768, 1032])
@pytest.mark.parametrize("rows", [1, 7, 131])
def test_cuda_layer_norm_paths_match_plain(cuda, H, rows):
    """Both loops of the kernel (vector: H 136, 768; scalar: H 100 not a
    multiple of 8, 1032 past the registers' 1024), row counts off the
    block's 4 rows, every dtype pair, with and without stats."""
    g = torch.Generator().manual_seed(H + rows)
    w = (torch.randn(H, generator=g) + 1).to(cuda)
    b = torch.randn(H, generator=g).to(cuda)
    for in_dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(rows, H, generator=g) * 3 + 1).to(cuda, in_dt)
        for out_dt in (torch.float32, torch.bfloat16):
            got = layer_norm(x, w, b, 1e-6, out_dt, stats=True)
            want = layer_norm_plain(x, w, b, 1e-6, out_dt, stats=True)
            for o, w_ in zip(got, want):
                _close(o, w_, o.dtype)
            _close(layer_norm(x, w, b, 1e-6, out_dt), want[0], out_dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_decode_step_matches_plain(cuda, dtype):
    """Two layers, 3 beams per image, H=128 in 2 heads: 7 launches per
    layer (4 gemm, 1 decode_attention, 2 layer_norm)."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=512)
    model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    packed = pack_decode_layers(model, dtype)
    B, nb, S, A, t = 2, 3, 45, 6, 3
    d = _decode_inputs(cuda, dtype, B, nb, 128, S, A, nL=2)
    k, v, bias = pack_decode_context(list(d["ctx_k"]), list(d["ctx_v"]),
                                     d["valid"])
    x = torch.randn(B * nb, 2, 128, generator=torch.Generator()
                    .manual_seed(1)).to(cuda, dtype)
    caps = [d["cap_k"].clone(), d["cap_v"].clone()]
    ref = fused_decode_step_plain(packed, k, v, bias, d["cap_k"], d["cap_v"],
                                  x, t, num_heads=2, eps=1e-12)
    ops.reset_counts()
    out = fused_decode_step(packed, k, v, bias, *caps, x,
                            torch.tensor(t, dtype=torch.int32, device=cuda),
                            num_heads=2, eps=1e-12)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gemm": 8, "layer_norm": 4,
                                   "attention": 0, "attention_bwd": 0,
                                   "decode_attention": 2}
    _close(out, ref, dtype)
    _close(caps[0], d["cap_k"], dtype)
    _close(caps[1], d["cap_v"], dtype)


@pytest.mark.cuda
def test_cuda_engines_match_cpu(cuda, monkeypatch):
    """tiny_config, f32: greedy and beam-3 ids on the card equal the CPU
    run's under both engines; the fused engine launches one
    decode_attention per layer and step."""
    cfg = tiny_config(img_size=128)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rs = np.random.RandomState(1)
    imgs = torch.from_numpy(rs.randint(0, 256, (2, 128, 128, 3))
                            .astype(np.uint8))
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    A = cfg.max_gen_length

    def run(model, dev, opts):
        return TD.generate(model, imgs.to(dev),
                           torch.zeros(2, od_len, dtype=torch.long,
                                       device=dev), None,
                           torch.full((2,), cfg.max_seq_a_len + 2,
                                      device=dev), cfg, opts)
    for engine in ("0", "1"):
        monkeypatch.setenv("VITCAP_DECODE_FUSED", engine)
        for nb in (1, 3):
            opts = TD.DecodeOptions(max_length=A, num_beams=nb,
                                    num_keep_best=min(nb, 2),
                                    od_labels_start_posid=cfg.max_seq_a_len)
            ref = run(cpu_model, "cpu", opts)
            ops.reset_counts()
            out = run(gpu_model, cuda, opts)
            torch.cuda.synchronize()
            want = cfg.decoder_layers * (A - 1) if engine == "1" else 0
            assert ops.launch_counts()["decode_attention"] == want
            assert torch.equal(out["ids"].cpu(), ref["ids"])
            _close(out["logprobs"], ref["logprobs"], torch.float32)


@pytest.mark.cuda
def test_cuda_caption_server_samples_on_the_card(cuda):
    """Sampled greedy and sampled beam-3 requests: the server's generator
    lives on the card and every request resolves with a caption."""
    from vitcap_tpu_torch.serving import CaptionServer
    cfg = tiny_config(img_size=128)
    model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    img = np.random.RandomState(2).randint(0, 256, (128, 128, 3)) \
        .astype(np.uint8)
    for nb in (1, 3):
        opts = TD.DecodeOptions(max_length=cfg.max_gen_length, num_beams=nb,
                                do_sample=True, top_k=20, top_p=0.9,
                                od_labels_start_posid=cfg.max_seq_a_len)
        with CaptionServer(model, cfg, opts, batch_size=2) as server:
            out = server.caption(img, timeout=120)
            assert server._generator.device.type == "cuda"
        assert out["ids"][0] == cfg.cls_token_id
        assert np.isfinite(out["logprob"])


# ---------------------------------------------------------------------------
# train kernels (K6, K7, K8 forward and backward) and train blocks
# ---------------------------------------------------------------------------

def test_attention_bwd_refuses_devices_without_a_kernel():
    s = torch.empty(1, 4, 24, device="meta")
    with pytest.raises(RuntimeError):
        attention_bwd(s, torch.empty(1, 4, 8, device="meta"), 2, 4)


def _bits_equal(out, ref):
    """bf16: the kernels round where the plain versions round, so only f32
    sums taken in another order may split a rare value by one ulp."""
    if out.dtype == torch.bfloat16:
        assert (out == ref).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_gemm_and_layer_norm_match_plain(cuda, dtype):
    """LayerNorm with stats; the gemm's pre-GELU output; the K7 dropout
    epilogue at rates 0 and 0.1 (rows of 48-token images)."""
    g = torch.Generator().manual_seed(3)
    M, K, N = 240, 96, 136
    a = torch.randn(M, K, generator=g).to(cuda, dtype)
    w = (torch.randn(N, K, generator=g) * 0.1).to(cuda, dtype)
    b = torch.randn(N, generator=g).to(cuda)
    r = torch.randn(M, N, generator=g).to(cuda, dtype)
    x = (torch.randn(M, N, generator=g) * 3 + 1).to(cuda, dtype)
    got = layer_norm(x, b, b, 1e-6, dtype, stats=True)
    want = layer_norm_plain(x, b, b, 1e-6, dtype, stats=True)
    for o, w_ in zip(got, want):
        _close(o, w_, o.dtype)
    pre, pre_ref = (torch.empty(M, N, dtype=dtype, device=cuda)
                    for _ in range(2))
    out = gemm(a, w, b, gelu=True, pre_out=pre)
    ref = gemm_plain(a, w, b, gelu=True, pre_out=pre_ref)
    _close(out, ref, dtype)
    _close(pre, pre_ref, dtype)
    _bits_equal(pre, pre_ref)
    for rate in (0.0, 0.1):
        drop = (rate, -918273, 1, 48)
        out = gemm(a, w, b, residual=r, dropout=drop)
        ref = gemm_plain(a, w, b, residual=r, dropout=drop)
        _close(out, ref, dtype)
        _bits_equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,hd", [(2, 64), (4, 32), (3, 8)])
def test_cuda_packed_attention_fwd_bwd_match_plain(cuda, dtype, nh, hd):
    """K8: forward with prob dropout and backward (two launches), with and
    without bias, L < Lp; a padded query row with zero upstream gradient
    takes none."""
    from vitcap_tpu_torch.ops.attention_bwd import attention_bwd_plain
    g = torch.Generator().manual_seed(hd)
    B, L, Lp = 2, 133, 144
    slab = torch.randn(B, Lp, 3 * nh * hd, generator=g).to(cuda, dtype)
    up = torch.randn(B, Lp, nh * hd, generator=g)
    up[:, L:] = 0.0
    up = up.to(cuda, dtype)
    bias = torch.where(torch.rand(B, 1, Lp, Lp, generator=g) > 0.3, 0.0,
                       -10000.0).to(cuda)
    bias[..., 0] = 0.0
    for bb in (None, bias):
        for rate in (0.0, 0.1):
            _close(attention(slab, nh, L, bb, rate, 77),
                   attention_plain(slab, nh, L, bb, rate, 77), dtype)
            ops.reset_counts()
            got = attention_bwd(slab, up, nh, L, bb, rate, -5)
            assert ops.launch_counts()["attention_bwd"] == 2
            want = attention_bwd_plain(slab, up, nh, L, bb, rate, -5)
            for o, w_ in zip(got, want):
                _close(o, w_, dtype)
                _bits_equal(o, w_)
            assert not got[0][:, L:].float().abs().any()


def _round16(n):
    return (n + 15) // 16 * 16


def _bf16_attention_bwd_case(cuda, L, Lp, hd, bias_heads, rate=0.0,
                             layout="slab", nh=2, B=2, seed=0):
    """One bf16 attention_bwd call against its plain version on the card:
    l_actual L, q, k, v read from a (B, Lp, 3H) slab, from separate (B, Lp,
    H) tensors ("qkv") or as per-head (B, nH, L, hd) views of (B, L, H)
    tensors ("heads", Lp = L, no dropout); an upstream gradient that is
    nonzero on every row, so query rows in [L, Lp) count in dk and dv as in
    the plain version; bias None or (B, bias_heads, Lp, Lp).  Two launches;
    within 2e-2 of each output's scale and at least 99% of values
    bit-equal; a second call gives the same bits; dk and dv are zero at
    keys in [L, Lp)."""
    from vitcap_tpu_torch.ops.attention import heads_view, merge_heads
    from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd_heads,
                                                    attention_bwd_heads_plain,
                                                    attention_bwd_plain,
                                                    attention_bwd_qkv,
                                                    attention_bwd_qkv_plain)
    g = torch.Generator().manual_seed(seed)
    H = nh * hd
    slab = torch.randn(B, Lp, 3 * H, generator=g).to(cuda, torch.bfloat16)
    up = torch.randn(B, Lp, H, generator=g).to(cuda, torch.bfloat16)
    bias = None
    if bias_heads is not None:
        bias = torch.where(torch.rand(B, bias_heads, Lp, Lp, generator=g)
                           > 0.3, 0.0, -10000.0)
        bias += 0.5 * torch.randn(B, bias_heads, Lp, Lp, generator=g)
        bias[..., 0] = 0.0
        bias = bias.to(cuda)
    if layout == "slab":
        def run():
            return attention_bwd(slab, up, nh, L, bias, rate, 4321)
        want = attention_bwd_plain(slab, up, nh, L, bias, rate, 4321)
    elif layout == "qkv":
        q, k, v = (t.contiguous() for t in slab.split(H, dim=-1))

        def run():
            return attention_bwd_qkv(q, k, v, up, nh, L, bias, rate, 4321)
        want = attention_bwd_qkv_plain(q, k, v, up, nh, L, bias, rate, 4321)
    else:
        assert L == Lp and rate == 0.0
        q, k, v, u = (heads_view(t, nh)
                      for t in (*slab.split(H, dim=-1), up))

        def run():
            return tuple(merge_heads(t)
                         for t in attention_bwd_heads(q, k, v, u, bias))
        want = tuple(merge_heads(t) for t in attention_bwd_heads_plain(
            q, k, v, u, L, bias))
    ops.reset_counts()
    got = run()
    assert ops.launch_counts()["attention_bwd"] == 2
    again = run()
    for o, o2, w_ in zip(got, again, want):
        _close(o, w_, torch.bfloat16)
        _bits_equal(o, w_)
        assert torch.equal(o, o2)
    for o in got[1:]:
        assert not o[:, L:].float().abs().any()


@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 16])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129])
def test_cuda_bf16_attention_bwd_ragged_lengths(cuda, past, L):
    """The wgmma backward at l_actual on both sides of a 64-row tile's edge,
    Lp = round_up(L, 16) and 16 past it, with no bias, a (B, 1, Lp, Lp) and
    a per-head bias, and with prob dropout."""
    Lp = _round16(L) + past
    for bias_heads in (None, 1, 2):
        _bf16_attention_bwd_case(cuda, L, Lp, 64, bias_heads, seed=L + past)
    _bf16_attention_bwd_case(cuda, L, Lp, 64, 1, rate=0.1, seed=L)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["slab", "qkv", "heads"])
@pytest.mark.parametrize("hd", [8, 40, 64])
def test_cuda_bf16_attention_bwd_head_dims(cuda, layout, hd):
    """Head sizes 8-64 padded with zeros to 64, on each operand layout the
    kernels read by stride, with each bias kind (and dropout where the
    entry point takes it)."""
    L, Lp = (150, 150) if layout == "heads" else (150, 176)
    for bias_heads in (None, 1, 3):
        _bf16_attention_bwd_case(cuda, L, Lp, hd, bias_heads, layout=layout,
                                 nh=3, seed=hd)
    if layout != "heads":
        _bf16_attention_bwd_case(cuda, L, Lp, hd, 3, rate=0.2, layout=layout,
                                 nh=3, seed=hd)


@pytest.mark.cuda
def test_cuda_bf16_attention_bwd_long_bias_dropout(cuda):
    """The 512-px decoder's shape: Lp 1104, l_actual 1096, separate q, k, v,
    a (B, 1, Lp, Lp) bias and rate 0.1 (and a per-head bias at rate 0)."""
    _bf16_attention_bwd_case(cuda, 1096, 1104, 64, 1, rate=0.1, layout="qkv",
                             B=1, seed=11)
    _bf16_attention_bwd_case(cuda, 1096, 1104, 64, 2, layout="slab", B=1,
                             seed=12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_train_blocks_match_cpu(cuda, dtype):
    """One ViT and one BERT train block (with hidden and prob dropout),
    forward and backward on the card against the same Functions on the
    CPU (plain versions): outputs and every gradient."""
    from vitcap_tpu_torch.ops.fused_block import (split_bert_layer_train,
                                                  split_vit_block_train)
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=512)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    for m in (cpu, gpu):
        m.requires_grad_(True)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 144, 128, generator=gen).to(dtype)
    bias = torch.zeros(2, 1, 144, 144)
    bias[:, :, 20:, :20] = -10000.0

    def run(model, dev):
        xx = x.to(dev).requires_grad_(True)
        o1 = split_vit_block_train(model.bert.encoder.blocks[0], xx, 2, 1e-6,
                                   130)
        o2 = split_bert_layer_train(model.bert.decoder.layer[0], o1,
                                    bias.to(dev), 2, 1e-12, 130, 0.2, 0.1,
                                    (11, -12))
        (o2[:, :130].float() ** 2).sum().backward()
        return o2, xx.grad, {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None}

    ops.reset_counts()
    out, gx, grads = run(gpu, cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gemm": 8, "layer_norm": 4,
                                   "attention": 2, "attention_bwd": 4,
                                   "decode_attention": 0}
    ref, rx, rgrads = run(cpu, "cpu")
    _close(out, ref, dtype)
    assert grads.keys() == rgrads.keys() and len(grads) == 28
    # bf16 gradients: the cotangents are rounded to bf16 at every link of
    # two blocks' backwards, so a one-ulp split of one value (f32 sums in
    # another order) travels; 5e-2 of each tensor's scale, with a floor of
    # 1e-3 of the largest gradient (the key bias's gradient is zero in exact
    # arithmetic and rounding noise here)
    pairs = [(gx, rx)] + [(grads[n], rgrads[n]) for n in grads]
    top = max(w.float().abs().max().item() for _, w in pairs)
    for got, want in pairs:
        if dtype == torch.float32:
            _close(got, want, dtype)
        else:
            got, want = got.float().cpu(), want.float().cpu()
            err = (got - want).abs().max().item()
            assert err <= 5e-2 * max(want.abs().max().item(), 1e-3 * top), \
                err


# ---------------------------------------------------------------------------
# past 1024 padded tokens (K10: 512-px inputs)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_long_matches_plain(cuda, dtype):
    """Lp = 1152 at the flagship head size: the ViT case (l_actual 1025, no
    bias) and the prefill case (l_actual 1076, the (B, 1, Lp, Lp) f32 bias
    with -10000 on od keys for the visual rows); each launch counts as
    long."""
    g = torch.Generator().manual_seed(11)
    B, Lp, nh = 2, 1152, 12
    slab = torch.randn(B, Lp, 3 * nh * 64, generator=g).to(cuda, dtype)
    bias = torch.zeros(B, 1, Lp, Lp)
    bias[:, :, 50:, :50] = -10000.0
    bias[:, :, :50, 7:50] = -10000.0
    bias = bias.to(cuda)
    ops.reset_counts()
    for L, bb in ((1025, None), (1076, bias)):
        _close(attention(slab, nh, L, bb), attention_plain(slab, nh, L, bb),
               dtype)
    assert ops.mode_counts()["attention[long]"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_blocks_long_match_plain_blocks(cuda, plain_attention,
                                                  dtype):
    """Both inference blocks at L = 1025 / 1076 (Lp 1152), H = 128 in 2
    heads of 64, against the plain blocks on the card (their attention on
    its plain version: only the fused blocks launch kernels)."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2,
                      intermediate_size=512)
    model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    g = torch.Generator().manual_seed(2)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    x = torch.randn(2, 1025, 128, generator=g).to(cuda, dtype)
    ops.reset_counts()
    _close(fused_vit_block(blk, x, 2, 1e-6),
           TL._vit_block_plain(blk, x, 2, 1e-6), dtype)
    xb = torch.randn(2, 1076, 128, generator=g).to(cuda, dtype)
    bias = torch.zeros(2, 1, 1076, 1076, device=cuda)
    bias[:, :, 50:, :50] = -10000.0
    _close(fused_bert_block(layer, xb, bias, 2, 1e-12),
           TL._bert_layer_plain(layer, xb, bias, 2, 1e-12), dtype)
    assert ops.launch_counts()["attention"] == 2
    assert ops.mode_counts()["attention[long]"] == 2


# ---------------------------------------------------------------------------
# K8 on separate q, k, v (512-px training)
# ---------------------------------------------------------------------------

def test_strided_attention_refuses_devices_without_a_kernel():
    from vitcap_tpu_torch.ops.attention import attention_qkv
    from vitcap_tpu_torch.ops.attention_bwd import attention_bwd_qkv
    t = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(RuntimeError):
        attention_qkv(t, t, t, 2, 4)
    with pytest.raises(RuntimeError):
        attention_bwd_qkv(t, t, t, t, 2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_strided_attention_long_matches_plain(cuda, dtype):
    """The attention and attention_bwd kernels on separate q, k, v at the
    512-px train lengths, 12 heads of 64: the ViT case (chunk views of one
    (B, 1152, 2304) qkv tensor, l_actual 1025, no bias) and the BERT case
    (separate q, k, v at Lp 1104, the (B, 1, Lp, Lp) bias, rate 0.1,
    l_actual 1096), forward and backward against the plain versions; every
    launch counts as long and non-slab."""
    from vitcap_tpu_torch.ops.attention import (attention_qkv,
                                                attention_qkv_plain)
    from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd_qkv,
                                                    attention_bwd_qkv_plain)
    g = torch.Generator().manual_seed(12)
    B, nh, H = 2, 12, 768
    qkv = torch.randn(B, 1152, 3 * H, generator=g).to(cuda, dtype)
    bert = [torch.randn(B, 1104, H, generator=g).to(cuda, dtype)
            for _ in range(3)]
    bias = torch.zeros(B, 1, 1104, 1104)
    bias[:, :, :70, 20:70] = -10000.0
    bias[:, :, 70:, :70] = -10000.0
    cases = [(qkv.chunk(3, dim=-1), 1025, None, 0.0),
             (bert, 1096, bias.to(cuda), 0.1)]
    ops.reset_counts()
    for (q, k, v), L, bb, rate in cases:
        up = torch.randn(q.shape, generator=g)
        up[:, L:] = 0.0
        up = up.to(cuda, dtype)
        _close(attention_qkv(q, k, v, nh, L, bb, rate, 31),
               attention_qkv_plain(q, k, v, nh, L, bb, rate, 31), dtype)
        got = attention_bwd_qkv(q, k, v, up, nh, L, bb, rate, 31)
        want = attention_bwd_qkv_plain(q, k, v, up, nh, L, bb, rate, 31)
        for o, w_ in zip(got, want):
            _close(o, w_, dtype)
            _bits_equal(o, w_)
    modes = ops.mode_counts()
    assert ops.launch_counts()["attention"] == 2
    assert modes["attention[non_slab]"] == modes["attention[long]"] == 2
    assert modes["attention[dropout]"] == 1
    assert modes["attention_bwd[non_slab]"] == modes["attention_bwd[long]"] \
        == 4
    assert modes["attention_bwd[dropout]"] == 2


@pytest.mark.cuda
def test_cuda_strided_attention_refuses_unaligned_layouts(cuda):
    """The kernels take any layout with a 16-byte aligned base and strides
    in 16-byte units; on any other the wrappers raise, never copy."""
    from vitcap_tpu_torch.ops.attention import attention_qkv
    from vitcap_tpu_torch.ops.attention_bwd import attention_bwd_qkv
    buf = torch.randn(2, 80, 3 * 64 + 8, device=cuda).bfloat16()
    q, k, v = buf[..., :64], buf[..., 64:128], buf[..., 128:192]
    assert attention_qkv(q, k, v, 1, 80).shape == (2, 80, 64)
    shifted = buf[..., 1:65]                  # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        attention_qkv(shifted, k, v, 1, 80)
    odd = torch.randn(2, 80, 68, device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError, match="strides"):
        attention_bwd_qkv(q, k, odd, q, 1, 80)
    column_major = v.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        attention_qkv(q, k, column_major, 1, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, dtype):
    """K9: flash_attention's kernels against flash_attention_plain on the
    card, 4 heads of 64, bias None, (B, 1, L, L) and (B, nH, L, L): at
    L 200 (one-pass forward, the attention_bwd pair backward with a zero
    bias gradient) on contiguous (B, nH, L, dh) tensors, and at L 1030
    (the online forward, the f32 autograd backward) on the per-head views
    of (B, L, H) tensors that mha passes.  Counts: one attention launch per
    forward, all through attention_heads, the online ones past 1024; two
    attention_bwd launches per one-pass backward."""
    from vitcap_tpu_torch.ops.attention import heads_view
    from vitcap_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    g = torch.Generator().manual_seed(21)
    B, nh, hd = 2, 4, 64
    ops.reset_counts()
    for L in (200, 1030):
        for kind in (None, 1, nh):
            if L == 200:
                qkv = [torch.randn(B, nh, L, hd, generator=g).to(cuda, dtype)
                       for _ in range(3)]
            else:
                qkv = [heads_view(torch.randn(B, L, nh * hd, generator=g)
                                  .to(cuda, dtype), nh) for _ in range(3)]
            bias = None
            if kind is not None:
                bias = torch.where(torch.rand(B, kind, L, L, generator=g)
                                   > 0.2, 0.0, -10000.0)
                bias[..., 0] = 0.0
                bias = bias.to(cuda).requires_grad_(True)
            up = torch.randn(B, nh, L, hd, generator=g).to(cuda, dtype)
            outs = []
            for fn in (flash_attention, flash_attention_plain):
                leaves = [t.detach().requires_grad_(True) for t in qkv]
                if bias is not None:
                    bias.grad = None
                o = fn(*leaves, bias)
                o.backward(up)
                outs.append([o] + [t.grad for t in leaves]
                            + [None if bias is None else bias.grad])
            for o, w_ in zip(outs[0][:4], outs[1][:4]):
                _close(o, w_, dtype)
                _bits_equal(o, w_)
            if bias is not None and L == 200:
                assert not outs[0][4].any()
            elif bias is not None:
                _close(outs[0][4], outs[1][4], torch.float32)
    modes = ops.mode_counts()
    assert ops.launch_counts()["attention"] == 6
    assert modes["attention[heads]"] == 6 and modes["attention[online]"] == 3
    assert ops.launch_counts()["attention_bwd"] == 6
    assert modes["attention_bwd[heads]"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_vit_attn_and_tail_train_match_plain(cuda, dtype):
    """K11 (fused_vit_attn: LN1, qkv gemm, attention, proj gemm with the
    residual) and K12 (tail_train) against their plain versions at L 90
    and 1030, 2 heads of 64; K11's backward (the plain chain, its
    attention the packed route) gives the same gradients either way.  Each
    CUDA call is four launches and one call count."""
    from vitcap_tpu_torch.ops.fused_block import (fused_vit_attn_plain,
                                                  tail_train,
                                                  tail_train_plain,
                                                  vit_attention_residual)
    torch.manual_seed(0)
    blk = TL.ViTBlock(128, 512, device=cuda)
    g = torch.Generator().manual_seed(22)
    ops.reset_counts()
    for L in (90, 1030):
        x = torch.randn(2, L, 128, generator=g).to(cuda, dtype)
        up = torch.randn(2, L, 128, generator=g).to(cuda, dtype)
        outs = []
        for plain in (False, True):
            xt = x.clone().requires_grad_(True)
            blk.zero_grad(set_to_none=True)
            if plain:
                o = fused_vit_attn_plain(
                    xt, blk.norm1.weight, blk.norm1.bias,
                    blk.attn.qkv.weight, blk.attn.qkv.bias,
                    blk.attn.proj.weight, blk.attn.proj.bias, 2, 1e-6)
            else:
                o = vit_attention_residual(blk, xt, 2, 1e-6)
            o.backward(up)
            outs.append([o, xt.grad, blk.attn.qkv.weight.grad])
        _close(outs[0][0], outs[1][0], dtype)
        _bits_equal(outs[0][0], outs[1][0])
        for a, b in zip(outs[0][1:], outs[1][1:]):
            assert torch.equal(a, b)
        w = (blk.attn.proj.weight, blk.attn.proj.bias, blk.norm2.weight,
             blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
             blk.mlp.fc2.weight, blk.mlp.fc2.bias)
        with torch.no_grad():
            for o, ref in zip(tail_train(x, up, *w, 1e-6),
                              tail_train_plain(x, up, *w, 1e-6)):
                _close(o, ref, dtype)
                _bits_equal(o, ref)
    assert ops.call_counts() == {"fused_vit_attn": 2, "tail_train": 2}


# ---------------------------------------------------------------------------
# checkpointing and SCST on the card
# ---------------------------------------------------------------------------

def _tiny_train_batch(cfg, dev, seed=0):
    rs = np.random.RandomState(seed)
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    masked_pos = np.zeros((2, T), np.int64)
    masked_pos[:, 1:4] = 1
    b = {"image": rs.randint(0, 256, (2, cfg.img_size, cfg.img_size, 3))
         .astype(np.uint8),
         "input_ids": rs.randint(1, cfg.vocab_size, (2, T)),
         "token_type_ids": np.concatenate(
             [np.zeros((2, A), np.int64), np.ones((2, T - A), np.int64)], 1),
         "seq_a_len": np.full((2,), A), "seq_len": np.full((2,), T),
         "masked_pos": masked_pos,
         "masked_ids": rs.randint(1, cfg.vocab_size,
                                  (2, cfg.max_masked_tokens)),
         "label": (rs.rand(2, cfg.tag_vocab_size) < 0.05).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


@pytest.mark.cuda
def test_cuda_checkpoint_resume_matches_continuation(cuda, tmp_path):
    """tiny_config(img_size=128) on the card, dropout 0.1: two steps, a
    snapshot, a restore into a model initialised otherwise (on the card:
    weights, moments), one step: the parameters and moments match the
    continued run's as closely as a copy of the run continued alongside."""
    import copy
    from vitcap_tpu_torch.solver import checkpointing as CK
    from vitcap_tpu_torch.solver.optimization import AdamWState
    from vitcap_tpu_torch.solver.train_step import (TrainHyper, TrainState,
                                                    init_train_state,
                                                    make_train_step)
    cfg = tiny_config(img_size=128, attention_probs_dropout_prob=0.1,
                      tag_loss_weight=1.0)
    step = make_train_step(cfg, TrainHyper(base_lr=1e-3, max_iter=20))
    batch = _tiny_train_batch(cfg, cuda)
    state = init_train_state(
        init_params(cfg, torch.Generator().manual_seed(0), cuda),
        torch.Generator().manual_seed(3))
    for _ in range(2):
        state, _ = step(state, batch)
    ck = CK.Checkpointer(str(tmp_path))
    ck.save(2, state)
    model, snap, it = ck.recover_or_load(
        None, init_params(cfg, torch.Generator().manual_seed(9), cuda))
    resumed = CK.restore_train_state(snap, model)
    assert it == 2 and next(model.parameters()).is_cuda
    assert all(t.is_cuda for t in resumed.opt.mu.values())
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    twin = TrainState(copy.deepcopy(state.model), AdamWState(
        state.opt.step, {n: t.clone() for n, t in state.opt.mu.items()},
        {n: t.clone() for n, t in state.opt.nu.items()}), gen)
    runs = [step(s, batch)[0] for s in (state, twin, resumed)]
    torch.cuda.synchronize()

    def diff(a, b):
        return max((x - y).abs().max().item() for x, y in zip(
            [*a.model.parameters(), *a.opt.mu.values(), *a.opt.nu.values()],
            [*b.model.parameters(), *b.opt.mu.values(), *b.opt.nu.values()]))
    assert diff(runs[0], runs[2]) <= diff(runs[0], runs[1])


@pytest.mark.cuda
def test_cuda_scst_step_matches_cpu(cuda):
    """tiny_config(img_size=128), f32: one SCST grad_step on the card and
    on the CPU given the same sampled ids, raw tokens, advantages and
    TokenSample indices (loss and grad norm within 1e-4 relative, the
    updated parameters as chip_smoke.py's train parity holds them);
    decode_fn on the fused engine
    launches decode_attention, its greedy ids equal the CPU's."""
    import copy
    import os
    from vitcap_tpu_torch.solver import scst as SC
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state)
    cfg = tiny_config(img_size=128)
    opts = TD.DecodeOptions(max_length=cfg.max_gen_length,
                            od_labels_start_posid=cfg.max_seq_a_len)
    A, K = cfg.max_gen_length, 2
    rs = np.random.RandomState(1)
    ids = rs.randint(1, cfg.vocab_size, (2 * K, A))
    ids[:, 0] = cfg.cls_token_id
    ids[ids == cfg.sep_token_id] = 7
    ids[0, 3], ids[0, 4:] = cfg.sep_token_id, cfg.pad_token_id
    raw = ids[:, 1:].copy()
    adv = rs.randn(2 * K).astype(np.float32)
    vidx = np.stack([np.concatenate([[0], rs.permutation(64)[:45] + 1])
                     for _ in range(2)])
    images = rs.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    od = np.zeros((2, cfg.max_seq_len - cfg.max_seq_a_len), np.int64)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for model, d in ((copy.deepcopy(cpu_model).to(cuda), cuda),
                     (cpu_model, "cpu")):
        batch = {"image": torch.from_numpy(images).to(d),
                 "od_ids": torch.from_numpy(od).to(d),
                 "seq_len": torch.full((2,), cfg.max_seq_len, device=d)}
        dec, grad = SC.make_scst_fns(
            cfg, opts, SC.ScstConfig(num_return=K, visual_token_ratio=0.7),
            TrainHyper(base_lr=1e-3, max_iter=20))
        old = os.environ.get("VITCAP_DECODE_FUSED")
        os.environ["VITCAP_DECODE_FUSED"] = "1"
        try:
            ops.reset_counts()
            g_ids = SC.make_scst_fns(cfg, opts, SC.ScstConfig(num_return=K),
                                     TrainHyper())[0](
                model, batch["image"], batch["od_ids"], None,
                batch["seq_len"], torch.Generator(device=d).manual_seed(0))[0]
            n_dec = ops.launch_counts()["decode_attention"]
        finally:
            if old is None:
                os.environ.pop("VITCAP_DECODE_FUSED")
            else:
                os.environ["VITCAP_DECODE_FUSED"] = old
        state = init_train_state(model, None)
        _, m = grad(state, batch, torch.from_numpy(ids).to(d),
                    torch.from_numpy(raw).to(d), torch.from_numpy(adv).to(d),
                    torch.from_numpy(vidx).to(d))
        out[str(d)] = (g_ids.cpu(), n_dec, {k: v.item() for k, v in m.items()},
                       [p.detach().cpu() for p in model.parameters()])
    (gg, gn, gm, gp), (cg, _, cm, cp) = out[str(cuda)], out["cpu"]
    # greedy and sampled loops, each decoder layer at every step
    assert gn == 2 * cfg.decoder_layers * (A - 1) and torch.equal(gg, cg)
    for k in ("scst_loss", "grad_norm", "mean_logprob"):
        assert abs(gm[k] - cm[k]) <= 1e-4 * abs(cm[k]), k
    # the first Adam step sends a near-zero gradient whose sign the order
    # of sums flips to the opposite +-lr step
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(gp, cp)])
    assert (diff <= 1e-2 * 1e-3).float().mean().item() >= 0.999
    assert diff.max().item() <= 2 * 1e-3 * (1 + 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,img", [("vit_huge_patch14_224_in21k", 112),
                                      ("vit_small_patch16_224", 128),
                                      ("vit_deit_base_distilled_patch16_384",
                                       128)])
def test_cuda_zoo_vit_runs_the_kernels_and_matches_plain(cuda, monkeypatch,
                                                         dtype, name, img):
    """The model zoo's ViT forward (2 blocks of the model's width, 65-66
    tokens: the fused blocks) on the card launches 4 gemm, 2 layer_norm and
    1 attention a block, the HDP=128 attention at head dims 80 and 96 and
    the wide LayerNorm at H 1280; its logits match the same composition
    on the kernels' plain versions on the card and, in f32, the CPU's."""
    import dataclasses
    from vitcap_tpu_torch.models import registry as TR
    from vitcap_tpu_torch.ops import fused_block as FB
    spec = dataclasses.replace(TR.model_spec(name), depth=2, img_size=img,
                               num_classes=10)
    cpu_model = TR.init_vision_params(spec, torch.Generator().manual_seed(0),
                                      "cpu")
    model = copy.deepcopy(cpu_model).to(cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, img, img, 3, generator=g) * 2 - 1
    with torch.no_grad():
        ops.reset_counts()
        got = TR.vit_forward(model, x.to(cuda), spec, head=True, dtype=dtype)
        torch.cuda.synchronize()
        hd = spec.hidden_size // spec.num_heads
        assert ops.launch_counts() == {"gemm": 8, "layer_norm": 4,
                                       "attention": 2, "attention_bwd": 0,
                                       "decode_attention": 0}
        modes = ops.mode_counts()
        assert modes["attention[hdp128]"] == (2 if hd > 64 else 0)
        assert modes["layer_norm[wide]"] == (4 if spec.hidden_size > 1024
                                             else 0)
        monkeypatch.setattr(FB, "KERNELS", FB.PLAIN)
        _close(got, TR.vit_forward(model, x.to(cuda), spec, head=True,
                                   dtype=dtype), dtype)
        if dtype == torch.float32:
            _close(got, TR.vit_forward(cpu_model, x, spec, head=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name,img,n_stages", [("hrnet_w18_small_v2", 128, 0),
                                               ("inception_v3", 107, 1),
                                               ("nasnetalarge", 96, 1)])
def test_cuda_zoo_2c_matches_cpu(cuda, name, img, n_stages):
    """A net of the zoo's part 2c (cuDNN convolutions, no hand kernel) in
    f32 on the card: the feature map and the logits within 1e-4 of their
    scale of the CPU's, the same weights (every norm and bias redrawn from
    a seed) and images, B=2; no kernel of the port launched."""
    from vitcap_tpu_torch.models import registry as TR
    spec = TR.model_spec(name, num_classes=10)
    model = TR.init_pooled_cnn_params(spec, torch.Generator().manual_seed(0),
                                      "cpu", n_stages)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(1 + 0.2 * torch.randn(
                    m.running_var.shape, generator=g).abs())
            for pn, p in m.named_parameters(recurse=False):
                if pn == "bias":
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = torch.rand(2, img, img, 3, generator=g) * 2 - 1
    card = copy.deepcopy(model).to(cuda)
    with torch.no_grad():
        ops.reset_counts()
        got = [TR.pooled_cnn_forward(card, x.to(cuda), spec, head=h).cpu()
               for h in (False, True)]
        torch.cuda.synchronize()
        assert not any(ops.launch_counts().values())
        want = [TR.pooled_cnn_forward(model, x, spec, head=h)
                for h in (False, True)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale
