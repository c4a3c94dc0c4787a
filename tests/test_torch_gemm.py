"""The bf16 gemm's choice of kernel and its order of f32 sums, on the CPU.

ops.gemm.plan(M, N, K) picks, per call, gemm_wide_kernel (0: 128 x 128
tiles, the whole K in one block) or gemm_split_kernel with clusters of
`ranks` blocks along K (csrc/gemm.cu).  Rank q of a split cluster sums the
64-deep k-steps [q s, (q + 1) s), s = ceil(nk / ranks), into an f32
partial, and an output's f32 sum is ((p0 + p1) + p2) + ... in rank order.
split_order() renders that order in torch; through the plain epilogue it
must keep at least 99% of the bf16 outputs bit-equal to gemm_plain for
every epilogue mode at the decode step's shapes (the f32 outputs within
1e-5 of their scale): the split moves a rare value by one bf16 ulp, no
more.  The CUDA kernels themselves are held to gemm_plain on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from vitcap_tpu_torch.ops.gemm import (H100_SMS, K_STEP, MAX_RANKS,
                                       SPLIT_TILE, epilogue_plain,
                                       gemm_plain, plan)

VIT = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072),
       "fc2": (3072, 768)}          # (K, N) of a block's four products
# rows of each main-path call site: B = 64 images of Lp padded tokens
LARGE_M = {"vit 384": 64 * 592, "prefill 384": 64 * 640,
           "bert train 384": 64 * 656, "vit 512 (filtered)": 64 * 528,
           "vit 512": 64 * 1152, "prefill 512": 64 * 1152}
# the fused decode step: 64 images x a 2-token window, greedy and beam-3
DECODE = {"greedy": 128, "beam-3": 384}
DECODE_RANKS = {("greedy", "qkv"): 3, ("greedy", "proj"): 6,
                ("greedy", "fc1"): 2, ("greedy", "fc2"): 8,
                ("beam-3", "qkv"): 1, ("beam-3", "proj"): 3,
                ("beam-3", "fc1"): 1, ("beam-3", "fc2"): 3}


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("site", sorted(LARGE_M))
def test_plan_takes_the_wide_kernel_at_encoder_shapes(site):
    """Every product of the encoder, the prefill and the train forward
    gives both consumer warpgroups of every SM a 128 x 128 tile:
    gemm_wide_kernel."""
    for K, N in VIT.values():
        assert plan(LARGE_M[site], N, K) == 0


@pytest.mark.parametrize("run", sorted(DECODE))
def test_plan_splits_k_at_decode_shapes(run):
    """The decode step's products take gemm_split_kernel with clusters of
    at most 8 blocks, every rank with at least one k-step, and at most one
    block per SM in all unless the tiles alone outnumber the SMs."""
    M = DECODE[run]
    for name, (K, N) in VIT.items():
        ranks = plan(M, N, K)
        assert ranks == DECODE_RANKS[run, name]
        assert 1 <= ranks <= MAX_RANKS
        nk = _cdiv(K, K_STEP)
        steps = _cdiv(nk, ranks)
        assert (ranks - 1) * steps < nk          # the last rank has work
        tiles = _cdiv(M, SPLIT_TILE[0]) * _cdiv(N, SPLIT_TILE[1])
        assert ranks == 1 or tiles * ranks <= H100_SMS
        assert ranks == min(MAX_RANKS, nk) or tiles * ranks >= H100_SMS // 2


def test_plan_edges():
    """Tiny products split as far as their k-steps allow; a card with more
    SMs needs more rows before it takes the wide kernel."""
    assert plan(1, 768, 768) == 6                # 12 k-steps, 2 per rank
    assert plan(4, 768, 8) == 1                  # one k-step
    assert plan(5632, 768, 768) == 0             # 44 x 6 = 264 tiles
    assert plan(5631, 768, 768, sms=132) == 0
    assert plan(5504, 768, 768) > 0              # 43 x 6 = 258 tiles
    assert plan(5632, 768, 768, sms=264) > 0


def split_order(a, w, ranks):
    """a (M, K) . w (N, K)^T in gemm_split_kernel's order of f32 sums."""
    K = a.shape[1]
    span = _cdiv(_cdiv(K, K_STEP), ranks) * K_STEP
    parts = [a[:, k:k + span].float() @ w[:, k:k + span].float().t()
             for k in range(0, K, span)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


MODES = {
    "default": dict(),
    "gelu": dict(gelu=True),
    "residual": dict(residual=True),
    "pre_out": dict(gelu=True, pre_out=True),
    "f32_sum": dict(f32_sum=True),
    "f32_sum gelu": dict(f32_sum=True, gelu=True),
    "f32_sum residual": dict(f32_sum=True, residual=True),
    "f32_sum residual out_f32": dict(f32_sum=True, residual=True,
                                     out_f32=True),
    "dropout 0.1": dict(residual=True, dropout=0.1),
    "dropout 0": dict(residual=True, dropout=0.0),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_split_order_matches_plain(mode):
    """Each epilogue mode at the decode step's eight shapes (greedy and
    beam-3 rows, the four products): the split kernel's order of f32 sums
    keeps >= 99% of the bf16 outputs bit-equal to gemm_plain."""
    rng = np.random.default_rng(sorted(MODES).index(mode))
    dt = torch.bfloat16
    for run, M in DECODE.items():
        for name, (K, N) in VIT.items():
            kw = dict(MODES[mode])
            ranks = plan(M, N, K)
            a = torch.from_numpy(rng.standard_normal((M, K),
                                                     np.float32)).to(dt)
            w = torch.from_numpy(rng.standard_normal((N, K), np.float32)
                                 * 0.02).to(dt)
            b = torch.from_numpy(rng.standard_normal(N, np.float32) * 0.02)
            if kw.pop("residual", False):
                kw["residual"] = torch.from_numpy(
                    rng.standard_normal((M, N), np.float32)).to(dt)
            pre = pre_ref = None
            if kw.pop("pre_out", False):
                pre, pre_ref = torch.empty(M, N, dtype=dt), torch.empty(
                    M, N, dtype=dt)
            if "dropout" in kw:
                kw["dropout"] = (kw["dropout"], -918273, 1, 64)
            got = epilogue_plain(split_order(a, w, ranks), dt, b,
                                 pre_out=pre, **kw)
            want = gemm_plain(a, w, b, pre_out=pre_ref, **kw)
            where = f"{mode} {run} {name} ranks {ranks}"
            assert got.dtype == want.dtype and got.shape == (M, N), where
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            if got.dtype == torch.float32:
                assert err <= 1e-5 * scale, (where, err, scale)
                continue
            assert err <= 2e-2 * scale, (where, err, scale)
            eq = (got == want).float().mean().item()
            assert eq >= 0.99, (where, eq)
            if pre is not None:
                assert (pre == pre_ref).float().mean().item() >= 0.99, where


def test_split_order_is_the_whole_sum():
    """The rendering adds every k-step once: with integer-valued inputs
    (exact in f32) it equals the plain product bit for bit at any split,
    ragged K included."""
    rng = np.random.default_rng(7)
    for K in (8, 96, 768, 3072):
        a = torch.from_numpy(rng.integers(-3, 4, (5, K)).astype(np.float32))
        w = torch.from_numpy(rng.integers(-3, 4, (7, K)).astype(np.float32))
        for ranks in range(1, MAX_RANKS + 1):
            assert torch.equal(split_order(a, w, ranks), a @ w.t())
