#!/usr/bin/env python3
"""Drive vitcap_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is not 0):
1. host facts: card name and power limit, CUDA, nvcc, Triton;
2. build the CUDA kernels from vitcap_tpu_torch/csrc;
3. each kernel vs its plain PyTorch version on the card, at the flagship
   shapes (ViT-B/16-384, B=64), in bf16 and f32: max abs error and times;
4. the fused ViT and BERT blocks vs the plain PyTorch blocks;
5. the main path: a CaptionServer (batch 64, bf16, random weights from a
   seed) answers 3 x 64 uint8 384x384 requests from client threads; each
   batch must launch exactly 72 gemm, 36 layer_norm and 18 attention
   kernels; prints greedy captions/s;
6. whole-path parity: greedy at flagship width in f32, B=2, on the card
   (kernels) and on the CPU (plain versions);
7. where one flagship greedy batch (B=64, bf16) spends its time: host-clock
   times of encode, prefill and decode loop, the device's busy time and
   idle share (torch.profiler), and device time by kernel.

The measurements are also written to chiprun_out/chip_smoke.json (and the
profile's tables to chiprun_out/profile_greedy.txt).

The line before the last is the card as nvidia-smi names it, with its
power limit; the last line is {"ok": true, "device": {...}}.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
B = 64                       # flagship serving batch
SEED = 0
F32_TOL = 1e-4               # f32 kernels vs plain: exact arithmetic,
                             # only the summation order differs
BF16_TOL = 2e-2              # bf16: of the output's scale
PER_BATCH = {"gemm": 72, "layer_norm": 36, "attention": 18}
SOURCES = {
    "gemm": ("vitcap_tpu_torch/csrc/gemm.cu",
             "vitcap_tpu/ops/fused_block.py:150 _qkv_kernel, :235 "
             "_tail_kernel, :534 _bert_qkv_kernel, :604 _bert_tail_kernel"),
    "layer_norm": ("vitcap_tpu_torch/csrc/layer_norm.cu",
                   "vitcap_tpu/ops/fused_block.py:150 _qkv_kernel (LN1), "
                   ":235 _tail_kernel (LN2), :604 _bert_tail_kernel "
                   "(post-LNs)"),
    "attention": ("vitcap_tpu_torch/csrc/attention.cu",
                  "vitcap_tpu/ops/fused_block.py:194 _attn_pairbd_kernel "
                  "(:167 perhead), :542 _bert_attn_pairbd_kernel "
                  "(:577 perhead)"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of `reps` calls issued back to back on the current
    stream (fn(i) may rotate inputs), timed with CUDA events after a
    warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(reps):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def compare(name, out, ref, dtype):
    """Max abs error of out vs ref, checked against the dtype's tolerance
    (f32: absolute, at least 1; bf16: relative to ref's scale)."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = (F32_TOL * max(1.0, scale) if dtype == torch.float32
           else BF16_TOL * scale)
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err:.3g} > {tol:.3g}")
    return err


def phase_host():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    try:
        import triton
        tri = triton.__version__
    except ImportError as e:
        tri = f"not importable ({e})"
    log(f"[host] card: {smi}")
    log(f"[host] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(f"[host] nvcc: {nvcc[-1] if nvcc else 'not found'}")
    log(f"[host] triton: {tri}")
    return smi


def phase_build():
    from vitcap_tpu_torch.ops import _build
    _build.library()
    log(f"[build] {_build.build_info['seconds']:.1f} s -> "
        f"{_build.build_info['path']}")
    info = _build.build_info["ptxas"]          # ptxas -v, per kernel
    spills = [ln for ln in info if "spill" in ln and " 0 bytes spill s" not in ln]
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in info
            if "Used " in ln]
    log(f"[build] ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
        f"registers, {len(spills)} with spills")
    for ln in spills:
        log(f"[build] ptxas spill: {ln}")


def phase_kernels(dev, rows):
    from vitcap_tpu_torch.ops.attention import attention, attention_plain
    from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    g = torch.Generator().manual_seed(SEED)
    M = B * 592
    H = 768

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    gemm_cases = [  # (name, K, N, epilogue)
        ("qkv", 768, 2304, dict()),
        ("proj+res", 768, 768, dict(residual=True)),
        ("fc1+gelu", 768, 3072, dict(gelu=True)),
        ("fc2+res", 3072, 768, dict(residual=True)),
        ("bert-out+res f32", 768, 768, dict(residual=True, f32_sum=True,
                                            out_f32=True)),
        ("bert-inter+gelu", 768, 3072, dict(gelu=True, f32_sum=True)),
        ("bert-output+res f32", 3072, 768, dict(residual=True, f32_sum=True,
                                                out_f32=True)),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, K, N, epi in gemm_cases:
            a = [rnd(M, K, dtype=dtype) for _ in range(2)]
            w = rnd(N, K, scale=0.02, dtype=dtype)
            b = rnd(N, scale=0.02)
            r = rnd(M, N, dtype=dtype) if epi.get("residual") else None
            kw = dict(epi, residual=r)
            out, ref = gemm(a[0], w, b, **kw), gemm_plain(a[0], w, b, **kw)
            err = compare(f"gemm {name} {dn}", out, ref, dtype)
            if out.dtype == torch.bfloat16:
                # the epilogue rounds where the plain version does, so only
                # the f32 sums' order can split a rare element by one ulp
                eq = (out == ref).float().mean().item()
                log(f"[kernel] gemm {name} bf16: {eq:.6f} of outputs "
                    f"bit-equal to the plain version")
                if eq < 0.99:
                    raise AssertionError(f"gemm {name}: only {eq:.4f} of "
                                         f"outputs bit-equal")
            ms = cuda_ms(lambda i: gemm(a[i % 2], w, b, **kw), 10)
            pms = cuda_ms(lambda i: gemm_plain(a[i % 2], w, b, **kw), 10)
            rows.append(dict(kernel="gemm", case=name, dtype=dn,
                             shape=f"M={M} K={K} N={N}", max_abs_err=err,
                             ms=ms, plain_ms=pms))
        for name, idt in (("ln", dtype), ("post-ln f32-in", torch.float32)):
            x = [rnd(M, H, scale=3.0, dtype=idt) + 1 for _ in range(2)]
            gm, bt = rnd(H) + 1, rnd(H)
            err = compare(f"layer_norm {name} {dn}",
                          layer_norm(x[0], gm, bt, 1e-6, dtype),
                          layer_norm_plain(x[0], gm, bt, 1e-6, dtype), dtype)
            ms = cuda_ms(lambda i: layer_norm(x[i % 2], gm, bt, 1e-6, dtype),
                         10)
            pms = cuda_ms(lambda i: layer_norm_plain(x[i % 2], gm, bt, 1e-6,
                                                     dtype), 10)
            rows.append(dict(kernel="layer_norm", case=name, dtype=dn,
                             shape=f"rows={M} H={H}", max_abs_err=err,
                             ms=ms, plain_ms=pms))
        for name, Bn, L, Lp, with_bias in (("vit", B, 577, 592, False),
                                           ("bert-prefill", B, 628, 640,
                                            True),
                                           ("ragged", 3, 70, 80, True)):
            slab = [rnd(Bn, Lp, 3 * H, dtype=dtype) for _ in range(2)]
            bias = None
            if with_bias:      # prefill-like: -10000 on a block of keys
                bias = torch.zeros(Bn, 1, Lp, Lp, device=dev)
                bias[:, :, : Lp // 4, Lp // 8: Lp // 4] = -10000.0
                bias[:, :, :, L:] = -10000.0
            err = compare(f"attention {name} {dn}",
                          attention(slab[0], 12, L, bias),
                          attention_plain(slab[0], 12, L, bias), dtype)
            ms = cuda_ms(lambda i: attention(slab[i % 2], 12, L, bias), 5)
            pms = cuda_ms(lambda i: attention_plain(slab[i % 2], 12, L,
                                                    bias), 5)
            rows.append(dict(kernel="attention", case=name, dtype=dn,
                             shape=f"B={Bn} L={L} Lp={Lp} heads=12x64",
                             max_abs_err=err, ms=ms, plain_ms=pms))
        del a, w, r, x, slab
        torch.cuda.empty_cache()
    for r in rows:
        log(f"[kernel] {r['kernel']:10s} {r['case']:20s} {r['dtype']:4s} "
            f"{r['shape']:32s} err {r['max_abs_err']:.3e}  "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")


def phase_blocks(dev, rows):
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.ops.fused_block import (fused_bert_block,
                                                  fused_vit_block)
    cfg = ModelConfig(num_hidden_layers=1, split_blocks=1, decoder_layers=1)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    g = torch.Generator().manual_seed(SEED + 1)
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        x = torch.randn(B, 577, H, generator=g).to(dev, dtype)
        err = compare(f"fused_vit_block {dn}",
                      fused_vit_block(blk, x, nh, 1e-6),
                      TL._vit_block_plain(blk, x, nh, 1e-6), dtype)
        ys = [x]
        ms = cuda_ms(lambda i: ys.append(
            fused_vit_block(blk, ys.pop(), nh, 1e-6)), 3)
        ys = [x]
        pms = cuda_ms(lambda i: ys.append(
            TL._vit_block_plain(blk, ys.pop(), nh, 1e-6)), 3)
        rows.append(dict(kernel="fused_vit_block", case="chain", dtype=dn,
                         shape=f"B={B} L=577", max_abs_err=err, ms=ms,
                         plain_ms=pms))
        xb = torch.randn(B, 628, H, generator=g).to(dev, dtype)
        bias = torch.zeros(B, 1, 628, 628, device=dev)
        bias[:, :, 50:, :50] = -10000.0      # visual rows never see text
        err = compare(f"fused_bert_block {dn}",
                      fused_bert_block(layer, xb, bias, nh, 1e-12),
                      TL._bert_layer_plain(layer, xb, bias, nh, 1e-12),
                      dtype)
        ys = [xb]
        ms = cuda_ms(lambda i: ys.append(
            fused_bert_block(layer, ys.pop(), bias, nh, 1e-12)), 3)
        ys = [xb]
        pms = cuda_ms(lambda i: ys.append(
            TL._bert_layer_plain(layer, ys.pop(), bias, nh, 1e-12)), 3)
        rows.append(dict(kernel="fused_bert_block", case="chain", dtype=dn,
                         shape=f"B={B} L=628", max_abs_err=err, ms=ms,
                         plain_ms=pms))
    for r in rows[-4:]:
        log(f"[block] {r['kernel']:16s} {r['dtype']:4s} {r['shape']:12s} "
            f"err {r['max_abs_err']:.3e}  kernels {r['ms']:.3f} ms  "
            f"plain {r['plain_ms']:.3f} ms")
    del model
    torch.cuda.empty_cache()


def phase_main_path(dev, smi):
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.data.tokenization import CaptionDecoder
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.serving import CaptionServer
    cfg = ModelConfig(dtype="bfloat16")
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    rs = np.random.RandomState(SEED)
    images = rs.randint(0, 256, (3, B, cfg.img_size, cfg.img_size, 3)) \
        .astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    opts = TD.DecodeOptions(max_length=cfg.max_gen_length,
                            od_labels_start_posid=cfg.max_seq_a_len)
    # warm-up batch outside the counted run (allocator, library handles)
    TD.generate(model, torch.from_numpy(images[0]).to(dev),
                torch.zeros(B, od_len, dtype=torch.long, device=dev), None,
                torch.full((B,), cfg.max_seq_a_len, device=dev), cfg, opts)
    torch.cuda.synchronize()

    results, per_batch, round_s = [], [], []
    server = CaptionServer(model, cfg, opts, tokenizer=CaptionDecoder(),
                           batch_size=B, max_delay_s=1.0)
    ops.reset_counts()
    t0 = time.perf_counter()
    try:
        for rnd in range(3):
            before = ops.launch_counts()
            t_round = time.perf_counter()
            futs = [None] * B

            def client(k, rnd=rnd):          # 8 clients, interleaved
                for i in range(k, B, 8):
                    futs[i] = server.submit(images[rnd, i])
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            results += [f.result(timeout=300) for f in futs]
            round_s.append(time.perf_counter() - t_round)
            after = ops.launch_counts()
            per_batch.append({k: after[k] - before[k] for k in after})
    finally:
        server.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    stats = server.stats()
    log(f"[main] batches {stats['batches']} requests {stats['requests']} "
        f"launches per batch {per_batch}")
    if stats["batches"] != 3:
        raise AssertionError(f"expected 3 batches of {B}, got {stats}")
    for d in per_batch:
        if d != PER_BATCH:
            raise AssertionError(f"launches per batch {d} != {PER_BATCH}")
    for r in results:
        if not (isinstance(r["caption"], str) and 0.0 < r["conf"] <= 1.0):
            raise AssertionError(f"bad result {r}")
    rate = len(results) / seconds
    log(f"[main] example captions (random weights): "
        f"{[r['caption'][:40] for r in results[:2]]}")
    log(f"[main] greedy captions/s {rate:.2f} (B={B}, bf16, "
        f"{cfg.max_gen_length} steps, {len(results)} requests in "
        f"{seconds:.3f} s, first batch included) on {smi}")
    log(f"[main] seconds per round of {B} requests: {round_s}")
    del model, server
    torch.cuda.empty_cache()
    return counts, {"captions_per_s": rate, "seconds": seconds,
                    "round_seconds": round_s}


def phase_parity(dev):
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    cfg = ModelConfig()                                   # f32
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rs = np.random.RandomState(SEED + 2)
    imgs = torch.from_numpy(rs.randint(0, 256, (2, cfg.img_size,
                                                 cfg.img_size, 3))
                            .astype(np.uint8))
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    opts = TD.DecodeOptions(max_length=cfg.max_gen_length,
                            od_labels_start_posid=cfg.max_seq_a_len)

    def run(model, d):
        od = torch.zeros(2, od_len, dtype=torch.long, device=d)
        sl = torch.full((2,), cfg.max_seq_a_len + 3, device=d)
        ctx = TD.build_decode_context(model, imgs.to(d), od, None, sl, cfg,
                                      opts)
        with torch.inference_mode():   # first decode step, as generate runs it
            dw = TD._decode_params_cast(model, cfg)
            step_ctx = dict(ctx, ctx_k=[k.float() for k in ctx["ctx_k"]],
                            ctx_v=[v.float() for v in ctx["ctx_v"]])
            ck, cv = TD._init_caps(2, cfg.decoder_layers, opts.max_length,
                                   cfg.hidden_size, cfg.compute_dtype,
                                   cfg.num_attention_heads, d)
            first = TD.decode_step(dw, ck, cv, step_ctx,
                                   torch.full((2,), cfg.cls_token_id,
                                              device=d), 1, cfg)
        out = TD.generate_greedy(model, None, None, None, None, cfg, opts,
                                 ctx=ctx)
        return {"tag_logits": ctx["tag_logits"],
                "ctx_k": torch.stack(ctx["ctx_k"]),
                "ctx_v": torch.stack(ctx["ctx_v"]),
                "first_logits": first, "ids": out["ids"]}

    ref = run(cpu_model, "cpu")
    got = run(gpu_model, dev)
    torch.cuda.synchronize()
    for key in ("tag_logits", "ctx_k", "ctx_v", "first_logits"):
        a, b = got[key].float().cpu(), ref[key].float()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"[parity] {key:12s} max rel err {rel:.3e}")
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            raise AssertionError(f"parity {key}: rel err {rel:.3e} > 1e-3")
    agree = (got["ids"].cpu() == ref["ids"]).float().mean().item()
    log(f"[parity] greedy id agreement GPU vs CPU: {agree:.4f} "
        f"({ref['ids'].numel()} ids)")


def summarise(rows, counts):
    """The per-kernel JSON entries: launches from the main path, the largest
    error of any check, and "ms"/"plain_ms" for one fused ViT block's
    launches of the kernel at B=64 bf16."""
    per_vit_block = {"qkv": 1, "proj+res": 1, "fc1+gelu": 1, "fc2+res": 1,
                     "ln": 2, "vit": 1}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = [(r, per_vit_block[r["case"]]) for r in mine
                if r["dtype"] == "bf16" and r["case"] in per_vit_block]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] * n for r, n in main),
            "plain_ms": sum(r["plain_ms"] * n for r, n in main),
        })
    return kernels


def phase_profile(dev):
    """One flagship greedy batch (B=64, bf16): host-clock phase times
    (median of 3, synchronised), then the same batch under torch.profiler:
    device busy time (the union of kernel and copy intervals), idle share
    against the unprofiled wall time, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models import vitcap as TM
    from vitcap_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(dtype="bfloat16")
    model = TM.init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    rs = np.random.RandomState(SEED + 3)
    imgs = torch.from_numpy(rs.randint(0, 256, (B, cfg.img_size,
                                                 cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.zeros(B, cfg.max_seq_len - cfg.max_seq_a_len,
                     dtype=torch.long, device=dev)
    sl = torch.full((B,), cfg.max_seq_a_len, device=dev)
    opts = TD.DecodeOptions(max_length=cfg.max_gen_length,
                            od_labels_start_posid=cfg.max_seq_a_len)
    stages = {
        "encode": lambda: TM.encode_images(model, imgs, cfg),
        "encode+prefill": lambda: TD.build_decode_context(
            model, imgs, od, None, sl, cfg, opts),
        "batch": lambda: TD.generate(model, imgs, od, None, sl, cfg, opts),
    }
    for _ in range(2):
        stages["batch"]()
    torch.cuda.synchronize()
    wall = {}
    for name, fn in stages.items():
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        wall[name] = sorted(ts)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages["batch"]()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:                    # union of device intervals, us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    out = {"wall_ms": wall, "decode_loop_ms": wall["batch"]
           - wall["encode+prefill"], "profiled_wall_ms": prof_wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / wall["batch"],
           "kernels": [{"name": k, "ms": ms, "count": n}
                       for k, (ms, n) in top]}
    log(f"[profile] wall ms (median of 3): {wall}; decode loop "
        f"{out['decode_loop_ms']:.3f}")
    log(f"[profile] device busy {busy:.3f} ms of {wall['batch']:.3f} ms "
        f"wall: idle share {out['idle_share']:.4f} (profiled wall "
        f"{prof_wall:.3f} ms, {len(spans)} device events)")
    for k, (ms, n) in top[:10]:
        log(f"[profile] {ms:9.3f} ms {n:6d}x {k[:90]}")
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_greedy.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=40, max_name_column_width=90))
    del model
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import vitcap_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    smi = phase_host()
    phase_build()
    rows = []
    phase_kernels(dev, rows)
    phase_blocks(dev, rows)
    counts, main_path = phase_main_path(dev, smi)
    phase_parity(dev)
    prof = phase_profile(dev)

    kernels = summarise(rows, counts)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "rows": rows, "main_path": main_path,
         "launches": counts, "profile": prof}, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
