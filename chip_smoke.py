#!/usr/bin/env python3
"""Drive vitcap_tpu_torch's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises, so the exit code is not 0):
1. host facts: card name and power limit, CUDA, nvcc, Triton;
2. build the CUDA kernels from vitcap_tpu_torch/csrc; print the bf16
   gemm, attention and attention_bwd kernels', the layer_norm kernel's
   and the decode_attention kernels' (at the 384-px beam-3 and the 512-px
   greedy geometry, with their cluster plan) launch configuration
   (registers, local bytes, shared memory per block, resident blocks per
   SM);
3. each kernel vs its plain PyTorch version on the card, at the flagship
   shapes (ViT-B/16-384, B=64), in bf16 and f32 (the f32 checks, here and
   in phases 8-10, over F32_B = 16 images): max abs error, times, the
   bound (the least time the card could take) and the time of one
   PyTorch call computing the same function (the yardstick); bf16 gemm
   and attention at least 99% bit-equal to their plain versions; the gemm
   at the fused decode step's four products (M = 128 greedy and 384
   beam-3 rows, bf16, timed per call from a CUDA graph of many calls)
   and the LayerNorm at the step's post-LN shapes (the same rows, f32 in,
   bf16 out, timed the same way); decode_attention at the greedy (64
   rows) and beam-3 (192 rows) geometries, S=628, A=20, t=10 (bf16 at
   least 99% bit-equal to the plain version on the cluster kernel; timed
   back to back and from a CUDA graph);
4. the fused ViT and BERT blocks vs the plain PyTorch blocks, and one
   fused decode step of the 4 decoder layers vs its plain version;
5. the greedy path: a CaptionServer (batch 64, bf16, random weights from a
   seed, eager decode engine) answers 3 x 64 uint8 384x384 requests from
   client threads; each batch must launch exactly 72 gemm, 36 layer_norm,
   18 attention and no decode_attention kernels; prints greedy captions/s;
5b. the beam path: the same with beam-3 on the fused decode engine
   (VITCAP_DECODE_FUSED=1); each batch must launch exactly 4 x 19
   decode_attention kernels beside its gemm and layer_norm launches; prints
   beam-3 captions/s, then greedy captions/s on the fused engine;
6. whole-path parity in f32, B=2, on the card (kernels) and on the CPU
   (plain versions): greedy and beam-3 ids under both engines;
7. where a flagship batch (B=64, bf16) spends its time, for greedy on each
   engine and beam-3 on the fused one: host-clock times of encode, prefill
   and decode loop, the device's busy time and idle share
   (torch.profiler), and device time by kernel;
8. training: the train kernels (LayerNorm with stats,
   the gemm's pre-GELU output and dropout epilogue, attention with prob
   dropout, attention_bwd) vs their plain versions at the flagship train
   shapes, bf16 and f32, with bounds and yardsticks; the ViT and BERT train
   blocks forward and backward vs the plain blocks; the flagship
   train step (B=64, bf16, attention dropout 0.1): img/s, step ms, peak
   memory, exactly TRAIN_PER_STEP launches per step; one f32 train step
   GPU vs CPU (loss, every gradient, the updated parameters); the profile
   of one flagship step;
9. high resolution: the flagship model built for 384 px
   (a 577-slot pos-embed, resized bicubically) serving 512x512 uint8 images:
   1025 visual tokens padded to 1152 and a 1076-token prefill, past 1024
   where the TPU package runs its q-tiled whole-block kernels (K10).  The
   kernels at Lp=1152 (B=64, bf16 and f32) and decode_attention over the
   1076-token context vs their plain versions with bounds and yardsticks;
   both K10 blocks vs the plain blocks; a
   CaptionServer answering 3 x 64 requests on the eager and the fused
   engine (exactly 72 gemm, 36 layer_norm and 18 attention launches per
   batch, all 18 attention launches long); one batch with
   token_filter_keep=0.5 (2 of its 18 attention launches long); greedy ids
   GPU vs CPU in f32 (B=2, full flagship, both engines); the profile of one
   512-px fused batch;
10. 512-px training: the flagship built for 384 px
   trained on 512x512 images, where every self-attention runs past 1024
   padded tokens on the plain chain's packed route (K8 on separate q, k,
   v: ops/flash_attention.py).  The strided attention and attention_bwd
   kernels at B=64, bf16 and f32 (ViT: views of one (64, 1152, 2304) qkv
   tensor, l_actual 1025; BERT: separate q, k, v at Lp 1104 with the bias
   and rate 0.1, l_actual 1096) vs their plain versions, with bounds and
   yardsticks (SDPA with the float mask and dropout_p, its backward on a
   retained graph); 6 flagship train steps at B=64 bf16 after one warm-up,
   each launching exactly TRAIN_512_PER_STEP kernels (19 attention, all
   non-slab and long; 38 attention_bwd; no gemm or layer_norm): img/s, step
   ms, peak memory; one f32 train step GPU vs CPU at 512 px (4+2 trunk
   blocks, 2 decoder layers, B=2, dropout 0.1, same seeds); the profile of
   one step (idle share, device time by kernel);
11. K9 on mha's inference route, K11 and K12: flash_attention's kernels
   at B=64, 12 heads of 64, bf16 and f32 (L 577 with no bias, a (B, 1, L,
   L) and a per-head (B, 12, L, L) bias; L 1025, the online mode, with no
   bias and the per-head one), forward and, at 577, the attention_bwd pair
   vs their plain versions with bounds and SDPA yardsticks (past 1024 the
   backward is autograd through the f32 attention: timed); fused_vit_attn
   at 577 and 1025 (its backward on 16 images) and tail_train at 577 vs
   their plain versions; the entry points as a user reaches them with
   exact launches per call (a no-grad vit_block with a bias and a no-grad
   bert_layer without one each launch one K9 forward); K9 and K11 GPU vs
   CPU in f32;
12. checkpointing: the flagship train step (the bench training line, B=64)
   takes 2 steps; the run is saved (solver/checkpointing.py), loaded into
   a fresh model, optimizer state and generator on the card, and one step
   taken from the resumed, the continued and a copied state: the resumed
   step matches the continued one as closely as the copy does (0 where
   every kernel is deterministic); a reference-named `.pt` loads through
   Checkpointer.recover_or_load with every parameter matched; save and
   load ms and the snapshot's bytes;
13. SCST (solver/scst.py): the kernels of its gradient step's fusion
   decoder at their shapes (128 sequences of 668 tokens padded to 672
   under the probe bias: the four gemm, LayerNorm with stats, attention
   and attention_bwd) and decode_attention at the sampled loop's 2 beams
   an image vs their plain versions, bf16, at least 99% bit-equal; then
   the flagship at 384 px, B=64, K=2 samples an
   image, greedy baseline, corpus CIDEr-D against 5 references an image
   (its greedy caption before training, 4 seeded captions of vocab
   words), bf16, the fused decode engine: one warm-up step, then 3 steps
   with decode, host reward and gradient timed apart, exact launches per
   kernel (SCST_DECODE, SCST_GRAD: the decoder trains over 128 sequences
   of 668 tokens padded to 672, under the probe bias), images/s and peak
   memory; one step at visual_token_ratio=0.7 (404 of 577 tokens); one
   f32 grad_step GPU vs CPU (4+2 trunk blocks, 2 decoder layers, B=2,
   the same ids, raw tokens, advantages and TokenSample indices).
14. the pipelines and the CLI (vitcap_tpu_torch.run): on a synthetic TSV
   dataset made from the seed (256 train and 128 test JPEGs of 480x400, 5
   captions and 3 tags an image), pipeline_train_eval_multi at the
   flagship (bf16, batches of 64, random weights from random_seed): 6
   train steps with snapshots at 3 and 6, predict (2 batches, eager
   engine) and evaluate; predict again on the fused engine with the
   speed breakdown; the same call again, all cached; the eager predict
   under torch.profiler; a 2-step SCST pass.  Prints train img/s over
   steps 2-6 beside the bare step's (phase 8), the host gap between
   steps, snapshot save ms, predict captions/s with pipeline_time,
   prep_time and the idle share, the .speed.yaml module_time, evaluate
   seconds and the report (METEOR and SPICE need nltk: where it is
   missing the report says so and the phase prints it), SCST img/s and
   the launches per train step and per predict batch.  Then the tiny
   test configuration in f32 on the card and on the CPU from one port
   `.ckpt` basemodel: per-step losses within rtol 1e-4, captions equal.
15. constrained beam search (models/cbs.py): decode_attention at 160
   beams an image (32 FSM states of 5 beams: 10 groups of 16), B=64,
   S=628, vs its plain version (bf16 on the cluster kernel at least 99%
   bit-equal, f32 on the simple kernel), with its bound; a CbsDecoder
   batch of 64 flagship images (bf16, random weights, synthetic
   detections of 3 vocab-word classes an image) on the eager and the
   fused engine: captions/s, exact launches (fused: every
   decode_attention over beam groups), peak memory, the profile (idle
   share, device time by kernel), each chosen caption replayed on its
   FSM meeting min(3, 2) constraints; the sparse search against the
   dense one on the card (the flagship in f32, B=2) and the tiny
   configuration's CbsDecoder ids on the card and the CPU, both engines.
16. data parallelism (parallel/ on torch.distributed) at the flagship,
   over a synthetic TSV dataset (128 + 128 JPEGs): a. `python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m
   vitcap_tpu_torch.run -c dp.yaml` (one rank over NCCL: 2 train steps, a
   128-image predict, evaluate) and the same YAML with no launcher, each a
   fresh process with the host RNGs seeded: the final snapshots bit-equal
   and the predict rows equal; the NCCL all-reduce's ms a step and its
   bytes; b. two ranks on cuda:0 over Gloo (this script with
   --dp-worker): the tiny f32 step at 2 x 4 rows equals 1 x 8 in this
   process, 2 flagship steps at 2 x 32 rows (dropout 0) match 1 x 64
   (losses within 2e-2, each rank's launches a step those of the 1 x 64
   step), the Gloo all-reduce ms, and the pipeline's predict at 2 ranks
   from a's snapshot: the merged rows equal a's, no shard left;
17. module 12: save_pretrained / from_pretrained of the flagship on the
   card (every parameter bit-equal, a greedy batch's ids equal, save and
   load ms, bytes); SCAN at its published configuration (ScanConfig(): 36
   regions of 2048, embed 1024, a bi-GRU): 5 Adam steps at batch 128,
   the scores of 1000 images x 5000 captions (ms, peak memory, R@1/5/10)
   and f32 scores card vs CPU at 8 x 40 within 1e-4.
18. the model zoo (models/registry.py create_model, random weights from
   the seed, bf16, B=64): the kernels at its new shapes vs their plain
   versions (the gemm at ViT-L/16-384's and ViT-H/14's products, attention
   at head dims 64, 80 and 96, each on its own width's instance, the
   LayerNorm at H 1024 and 1280); vit_large_patch16_384 at 384 and 512 px,
   vit_huge_patch14_224_in21k, vit_small_patch16_224,
   vit_base_resnet50_384 and vit_deit_base_distilled_patch16_384: exact
   launches per batch (attention[hd>64], layer_norm[wide] and
   attention[long] where the model has them), images/s (median of 5
   batches by CUDA events), peak memory, idle share, the logits vs the
   blocks' plain versions on the card (2e-2 of their scale; the plain
   chain's distance reported); resnet50 and t2t_vit_t_14 (no hand kernel:
   images/s); f32 card vs CPU at reduced depth (2 blocks of ViT-L and of
   ViT-H width, a 2-stage resnet50, T2T with 2 body blocks) within 1e-4.
19. the host side (vitcap_tpu_torch/native: the port's g++-built copies
   of the JAX package's C++; data/grain_loader.py; the profiler hooks):
   a. the three host libraries built with g++ (seconds each; the image
   decoder only where g++ finds libjpeg's jpeglib.h, which phase 1
   reports: without it phases 14, 16 and 19c run image_backend: pil);
   b. CIDEr-D at SCST's shape (192 hypotheses x 5 references): native
   vs Python within rtol 1e-9 and the ms of each, beside phase 13's SCST
   step, which rewards with the native scorer; c. 128 seeded 640x480
   JPEGs decoded, resized and cropped to 384 by PIL, the native exact
   mode (bit-equal to PIL) and the fast mode (within 1 LSB of exact on
   average), ms an image, then the fused predict of those images on each
   image_backend (captions/s, idle share, prep_time); d. the .lineidx.8b
   of a seeded 200 MiB TSV, native vs the Python scan (offsets equal, ms
   of each);
   e. 4 flagship train steps with loader: grain and grain_workers 2
   (the first 3 batches equal a grain_workers 0 loader's; img/s over
   steps 2-3 and the host gap); f. in that run, step 4 under
   jax_profile_dir, whose Chrome trace holds CUDA kernel events of the
   port's gemm and attention.
20. tensor parallelism (parallel/mesh.py make_mesh, shard_params(...,
   tensor_parallel=True), gather_params; parallel/tensor_parallel.py):
   a. attention and attention_bwd with prob dropout on a rank's head
   slice (heads 6-11 of 12, the salt's head offset) vs their plain
   versions, bf16 and f32; b. two ranks on cuda:0 over Gloo (this script
   with --tp-worker) on a (1, 2) grid against this process's unsplit
   runs: 2 flagship train steps (bf16, dropout 0.1, 16 images; losses
   within 2e-2, each rank's launches a step the unsplit step's kernels,
   the model axis's all-reduce ms a step) and one f32 step at 4 + 2 + 2
   blocks (loss rtol 1e-5, the gathered parameters rtol 2e-4 / atol
   1e-6); c. before each run's training a greedy and a beam-3 batch on
   the fused engine (f32 tokens equal the unsplit tokens; bf16 first-step
   logits within 2e-2 of their scale).
Phase 3 also runs decode_attention at S = 2000 context keys (hd 64 with 4
beams, hd 128 with 1), at least 99% bit-equal at B=64, with its share and
times, and a sweep of small calls (3 images, 8 seeds, 3 t; from 628 to
3000 keys) that prints each case's min and mean bit-equal share and holds
every call to at least 99% (F9).

The measurements are also written to chiprun_out/chip_smoke.json (and the
profiles' tables to chiprun_out/profile_<run>.txt).

The line before the last is the card as nvidia-smi names it, with its
power limit; the last line is {"ok": true, "device": {...}}.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
B = 64                       # flagship serving batch
SEED = 0
F32_TOL = 1e-4               # f32 kernels vs plain: exact arithmetic,
                             # only the summation order differs
BF16_TOL = 2e-2              # bf16: of the output's scale
F32_B = 16                   # images of the f32 kernel checks (of B): a
                             # check of exactness, not a timed main row
# H100 SXM peaks (NVIDIA's data sheet, dense): the bound of a kernel is
# the larger of its operations over the peak of their type and its bytes
# (each input read once, each output written once) over the HBM rate
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12
STEPS = 19                   # decode steps of a 20-token caption
ENCODE = {"gemm": 72, "layer_norm": 36, "attention": 18}   # per batch
PER_BATCH = dict(ENCODE, attention_bwd=0, decode_attention=0)
FUSED_PER_BATCH = {"gemm": 72 + 4 * 4 * STEPS,
                   "layer_norm": 36 + 4 * 2 * STEPS, "attention": 18,
                   "attention_bwd": 0, "decode_attention": 4 * STEPS}
# one flagship train step: 15 ViT train blocks (12 trunk + 3 tag) and 4
# BERT train blocks, each 4 gemm + 2 layer_norm + 1 attention forward and
# one attention_bwd call (2 launches) backward
TRAIN_PER_STEP = {"gemm": 76, "layer_norm": 38, "attention": 19,
                  "attention_bwd": 38, "decode_attention": 0}
TRAIN_MODES_PER_STEP = {"gemm[pre_out]": 19, "gemm[dropout]": 8,
                        "layer_norm[stats]": 38, "attention[dropout]": 4,
                        "attention[long]": 0, "attention[non_slab]": 0,
                        "attention_bwd[dropout]": 8,
                        "attention_bwd[long]": 0,
                        "attention_bwd[non_slab]": 0,
                        "attention[heads]": 0, "attention[online]": 0,
                        "attention_bwd[heads]": 0,
                        "decode_attention[groups]": 0,
                        "attention[hd>64]": 0, "layer_norm[wide]": 0,
                        "attention[tp]": 0, "attention_bwd[tp]": 0}
# one 512-px flagship train step: past 1024 padded tokens every
# self-attention takes the plain chain's packed route (flash_attention_
# packed): 15 ViT blocks at Lp 1152 (the CLS-only tag block attends from
# one query, plainly) and 4 decoder layers at Lp 1104 with prob dropout;
# the dense products and LayerNorms of the plain chain are PyTorch's
TRAIN_512_PER_STEP = {"gemm": 0, "layer_norm": 0, "attention": 19,
                      "attention_bwd": 38, "decode_attention": 0}
TRAIN_512_MODES_PER_STEP = {"gemm[pre_out]": 0, "gemm[dropout]": 0,
                            "layer_norm[stats]": 0, "attention[dropout]": 4,
                            "attention[long]": 19, "attention[non_slab]": 19,
                            "attention_bwd[dropout]": 8,
                            "attention_bwd[long]": 38,
                            "attention_bwd[non_slab]": 38,
                            "attention[heads]": 0, "attention[online]": 0,
                            "attention_bwd[heads]": 0,
                            "decode_attention[groups]": 0,
                            "attention[hd>64]": 0, "layer_norm[wide]": 0,
                            "attention[tp]": 0, "attention_bwd[tp]": 0}
HIGHRES = 512                # phase 9's images, against 384-px weights
LONG = {"attention[long]": 18}          # per 512-px batch: every block
FILTERED_LONG = {"attention[long]": 2}  # token_filter_keep=0.5: blocks 0, 1
SOURCES = {
    "gemm": ("vitcap_tpu_torch/csrc/gemm.cu",
             "vitcap_tpu/ops/fused_block.py:150 _qkv_kernel, :235 "
             "_tail_kernel, :534 _bert_qkv_kernel, :604 _bert_tail_kernel; "
             "the dense products of vitcap_tpu/ops/decode_step.py:115 "
             "_kernel and of the K10 kernels :125 _block_kernel, :470 "
             "_bert_kernel"),
    "layer_norm": ("vitcap_tpu_torch/csrc/layer_norm.cu",
                   "vitcap_tpu/ops/fused_block.py:150 _qkv_kernel (LN1), "
                   ":235 _tail_kernel (LN2), :604 _bert_tail_kernel "
                   "(post-LNs); the post-LNs of "
                   "vitcap_tpu/ops/decode_step.py:115 _kernel; the LNs of "
                   "K10 (:125 _block_kernel, :470 _bert_kernel)"),
    "attention": ("vitcap_tpu_torch/csrc/attention.cu "
                  "(attention_wgmma_kernel)",
                  "vitcap_tpu/ops/fused_block.py:194 _attn_pairbd_kernel "
                  "(:167 perhead), :542 _bert_attn_pairbd_kernel "
                  "(:577 perhead)"),
    "decode_attention": ("vitcap_tpu_torch/csrc/decode_attention.cu",
                         "vitcap_tpu/ops/decode_step.py:115 _kernel "
                         "(attention half; fused_decode_step :237)"),
}
# the train kernels and the kernels' modes: (source, TPU kernel, the row of
# the bf16 kernel phase that the summary line reports)
MODE_SOURCES = {
    "layer_norm[stats]": ("vitcap_tpu_torch/csrc/layer_norm.cu",
                          "vitcap_tpu/ops/fused_block.py:1381 "
                          "_qkv_train_kernel, :1398 _tail_train_stats_kernel "
                          "(LN stats, K6); :1095 _bert_tail_train_kernel "
                          "(post-LN stats, K7)", "vit rows"),
    "gemm[pre_out]": ("vitcap_tpu_torch/csrc/gemm.cu",
                      "vitcap_tpu/ops/fused_block.py:1398 "
                      "_tail_train_stats_kernel (pre1, K6); :1095 "
                      "_bert_tail_train_kernel (pre1, K7)",
                      "vit fc1+gelu+pre"),
    "gemm[dropout]": ("vitcap_tpu_torch/csrc/gemm.cu",
                      "vitcap_tpu/ops/fused_block.py:1095 "
                      "_bert_tail_train_kernel (hidden dropout, K7)",
                      "bert out-dense rate 0.0"),
    "attention[dropout]": ("vitcap_tpu_torch/csrc/attention.cu "
                           "(attention_wgmma_kernel)",
                           "vitcap_tpu/ops/flash_attention.py:484 "
                           "_fwd_packed_pair_kernel, :452 _fwd_packed_kernel "
                           "(flash_fwd_packed_slab :949, K8 forward)",
                           "bert train"),
    "attention[long]": ("vitcap_tpu_torch/csrc/attention.cu "
                        "(attention_wgmma_kernel)",
                        "vitcap_tpu/ops/fused_block.py:125 _block_kernel "
                        "(_fused_block_fwd :322, pallas_call :361), :470 "
                        "_bert_kernel (_fused_bert_fwd :701, pallas_call "
                        ":735): K10, Lp > 1024; its gemm and LayerNorm "
                        "launches count under gemm and layer_norm",
                        "vit long"),
    "attention_bwd": ("vitcap_tpu_torch/csrc/attention_bwd.cu",
                      "vitcap_tpu/ops/flash_attention.py:530 "
                      "_bwd_packed_pair_kernel, :600 _bwd_packed_kernel "
                      "(flash_bwd_packed_slab :882, K8 backward)", "vit"),
    "attention[non_slab]": ("vitcap_tpu_torch/csrc/attention.cu "
                            "(attention_wgmma_kernel; "
                            "vitcap_tpu_torch/ops/flash_attention.py)",
                            "vitcap_tpu/ops/flash_attention.py:670 "
                            "_flash_fwd_packed (pallas_call :719) -> :484 "
                            "_fwd_packed_pair_kernel, :452 _fwd_packed_kernel"
                            " (flash_attention_packed :792, K8 non-slab "
                            "forward)", "vit 1152"),
    "attention_bwd[non_slab]": ("vitcap_tpu_torch/csrc/attention_bwd.cu "
                                "(vitcap_tpu_torch/ops/flash_attention.py)",
                                "vitcap_tpu/ops/flash_attention.py:734 "
                                "_flash_bwd_packed (pallas_call :777) -> :530"
                                " _bwd_packed_pair_kernel, :600 "
                                "_bwd_packed_kernel (K8 non-slab backward)",
                                "vit 1152"),
    "attention[heads]": ("vitcap_tpu_torch/csrc/attention.cu "
                         "(attention_wgmma_kernel; "
                         "vitcap_tpu_torch/ops/flash_attention.py "
                         "flash_attention)",
                         "vitcap_tpu/ops/flash_attention.py:189 "
                         "_flash_fwd_onepass (pallas_call :237) -> :165 "
                         "_onepass_kernel (flash_attention :846, K9 "
                         "forward, Lp <= 1024)", "577 head"),
    "attention[online]": ("vitcap_tpu_torch/csrc/attention.cu "
                          "(attention_wgmma_online_kernel)",
                          "vitcap_tpu/ops/flash_attention.py:251 "
                          "_flash_fwd_pallas (pallas_call :309) -> :129 "
                          "_kernel (flash_attention :846, K9 forward past "
                          "1024)", "1025 head"),
    "attention_bwd[heads]": ("vitcap_tpu_torch/csrc/attention_bwd.cu "
                             "(vitcap_tpu_torch/ops/flash_attention.py "
                             "flash_attention)",
                             "vitcap_tpu/ops/flash_attention.py:372 "
                             "_flash_bwd_onepass (pallas_call :426) -> :324 "
                             "_bwd_onepass_kernel (K9 backward, Lp <= "
                             "1024)", "577 head"),
    "fused_vit_attn": ("vitcap_tpu_torch/ops/fused_block.py fused_vit_attn "
                       "(csrc/layer_norm.cu, gemm.cu, attention.cu)",
                       "vitcap_tpu/ops/fused_block.py:383 _fused_fwd "
                       "(pallas_call :402) -> :56 _kernel (fused_vit_attn "
                       ":430, K11)", "577"),
    "decode_attention[groups]": ("vitcap_tpu_torch/csrc/decode_attention.cu "
                                 "(decode_attention_cluster_kernel over "
                                 "beam groups)",
                                 "vitcap_tpu/ops/decode_step.py:115 _kernel "
                                 "(attention half; fused_decode_step :237), "
                                 "as constrained beam search reaches it at "
                                 "160 beams an image", "cbs160"),
    "attention[hd>64]": ("vitcap_tpu_torch/csrc/attention.cu "
                          "(attention_wgmma_kernel<80, ...> and <96, ...>: "
                          "head dims past 64 at their own width, "
                          "ops/attention.py plan)",
                          "vitcap_tpu/ops/fused_block.py:194 "
                          "_attn_pairbd_kernel (:167 perhead) at head dims "
                          "80 and 96, reached by vitcap_tpu/models/"
                          "registry.py vit_forward through layers.vit_block "
                          "(the model zoo's ViT-H/14 and old ViT-S/16)",
                          "zoo hd80"),
    "layer_norm[wide]": ("vitcap_tpu_torch/csrc/layer_norm.cu (the scalar "
                         "loop, rows past 1024)",
                         "vitcap_tpu/ops/fused_block.py:150 _qkv_kernel "
                         "(LN1), :235 _tail_kernel (LN2) at H 1280, reached "
                         "by vitcap_tpu/models/registry.py vit_forward (the "
                         "model zoo's ViT-H/14)", "zoo h1280"),
    "tail_train": ("vitcap_tpu_torch/ops/fused_block.py tail_train "
                   "(csrc/gemm.cu, layer_norm.cu)",
                   "vitcap_tpu/ops/fused_block.py:831 _tail_train_kernel "
                   "(K12)", "577"),
    "attention[tp]": ("vitcap_tpu_torch/csrc/attention.cu "
                      "(attention_wgmma_kernel, the dropout salt's global "
                      "head b * nh_total + head_offset + h)",
                      "vitcap_tpu/ops/flash_attention.py:484 "
                      "_fwd_packed_pair_kernel, :452 _fwd_packed_kernel (K8 "
                      "forward) on a tensor-parallel rank's heads, as "
                      "vitcap_tpu/parallel/mesh.py:106 shard_params("
                      "tensor_parallel=True) places them",
                      "bert train heads 6-11"),
    "attention_bwd[tp]": ("vitcap_tpu_torch/csrc/attention_bwd.cu (the "
                          "same salt)",
                          "vitcap_tpu/ops/flash_attention.py:530 "
                          "_bwd_packed_pair_kernel, :600 _bwd_packed_kernel "
                          "(K8 backward) on a tensor-parallel rank's heads",
                          "bert train heads 6-11"),
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


def bound(flops: float, nbytes: float, dn: str):
    """(bound ms, 'operations' or 'bytes') on an H100 SXM."""
    t_ops = flops / PEAK_FLOPS[dn] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    log(f"[host] g++ finds jpeglib.h (the native image decoder's "
        f"libjpeg headers): {_jpeg_headers()}; the pipelines' "
        f"image_backend: {_image_backend()}")
    return smi


def _jpeg_headers() -> bool:
    """Whether g++ on this host finds libjpeg's headers, which the native
    image decoder (vitcap_tpu_torch/native/imageproc.cpp) includes."""
    if not shutil.which("g++"):
        return False
    return subprocess.run(["g++", "-E", "-x", "c++", "-"],
                          input="#include <jpeglib.h>\n", text=True,
                          capture_output=True).returncode == 0


def _image_backend() -> str:
    """The pipelines' image_backend: the default 'native' where the native
    decoder can be built; 'pil' on a host without libjpeg's headers, where
    'native' raises."""
    return "native" if _jpeg_headers() else "pil"


def phase_build():
    """Build the kernels; print ptxas's registers and spills, and the bf16
    gemm, attention and attention_bwd kernels' launch configuration
    (returned)."""
    from vitcap_tpu_torch.ops import (_build, attention, attention_bwd,
                                      decode_step, gemm, layer_norm)
    _build.library()
    log(f"[build] {_build.build_info['seconds']:.1f} s -> "
        f"{_build.build_info['path']}")
    info = _build.build_info["ptxas"]          # ptxas -v, per kernel
    spills = [k for k in info if k["spill_bytes"]]
    log(f"[build] ptxas: {len(info)} kernels, max "
        f"{max((k['registers'] for k in info), default=0)} registers, "
        f"{len(spills)} with spills")
    for k in spills:
        log(f"[build] ptxas spill: {k['spill_bytes']} bytes, "
            f"{k['registers']} registers: {k['name'][:90]}")
    launch = (gemm.kernel_info() + attention.kernel_info()
              + attention_bwd.kernel_info() + layer_norm.kernel_info()
              + decode_step.kernel_info(628, 3) + decode_step.kernel_info(1076,
                                                                           1)
              + decode_step.kernel_info(2000, 4))
    for k in launch:
        geo = (f" (S={k['S']} nb={k['nb']}: {k['ranks']} ranks of "
               f"{k['keys_per_rank']} keys, capacity {k['keys_max']})"
               if "S" in k else "")
        log(f"[build] launch {k['name']}{geo}: {k['threads']} threads, "
            f"{k['registers']} registers, {k['local_bytes']} local (spill) "
            f"bytes, {k['shared_bytes']} shared bytes per block, "
            f"{k['blocks_per_sm']} blocks per SM")
    return launch


def _row(rows, kernel, case, dn, shape, err, ms, pms, lms, flops, nbytes):
    b_ms, b_by = bound(flops, nbytes, dn)
    rows.append(dict(kernel=kernel, case=case, dtype=dn, shape=shape,
                     max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                     flops=flops, bytes=nbytes, bound_ms=b_ms,
                     bound_by=b_by))


GEMM_CASES = [  # (name, K, N, epilogue)
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
# the fused decode step's four products (ops/decode_step.py _step), all
# f32 sums, at its greedy and beam-3 rows (64 images x a 2-token window)
DECODE_GEMM_CASES = [  # (name, K, N, epilogue)
    ("qkv", 768, 2304, dict(f32_sum=True)),
    ("out+res f32", 768, 768, dict(residual=True, f32_sum=True,
                                   out_f32=True)),
    ("fc1+gelu", 768, 3072, dict(gelu=True, f32_sum=True)),
    ("fc2+res f32", 3072, 768, dict(residual=True, f32_sum=True,
                                    out_f32=True)),
]
DECODE_GEMM_ROWS = {"greedy": B * 2, "beam3": B * 3 * 2}
# (kernel name in the rows, case, batch, l_actual, Lp, bias): ViT, the
# prefill, a ragged small case
ATTN_CASES = [("attention", "vit", B, 577, 592, False),
              ("attention", "bert-prefill", B, 628, 640, True),
              ("attention", "ragged", 3, 70, 80, True)]


def _prefill_bias(Bn, S, Lp, dev, od_len=50):
    """The prefill's additive mask (models/decode.py build_decode_context):
    od rows see their image's valid od slots (3 + 4 * (i % 12) of 50) and
    every other token; the other rows see no od slot; padded keys past S
    take -10000 (l_actual masks them as well)."""
    allow = torch.ones(Bn, 1, Lp, Lp, dtype=torch.bool)
    for i in range(Bn):
        allow[i, :, :od_len, 3 + 4 * (i % 12):od_len] = False
    allow[:, :, od_len:, :od_len] = False
    allow[..., S:] = False
    return torch.where(allow, 0.0, -10000.0).to(dev)


def phase_kernels(dev, rows, Lp=592, gemm_cases=GEMM_CASES,
                  attn_cases=ATTN_CASES, tag=""):
    """Each kernel vs its plain version, timed beside its bound and its
    yardstick: the gemms and LayerNorms over B * Lp rows, the attention
    cases (f32 over F32_B images); `tag` is appended to the gemm and
    LayerNorm case names."""
    from vitcap_tpu_torch.ops.attention import attention, attention_plain
    from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    g = torch.Generator().manual_seed(SEED)
    H = 768
    first = len(rows)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    for dtype, Bd in ((torch.bfloat16, B), (torch.float32, F32_B)):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        M = Bd * Lp
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
            bd = b.to(dtype)
            lms = cuda_ms(lambda i: F.linear(a[i % 2], w, bd), 10)
            out_es = 4 if epi.get("out_f32") else es
            nbytes = (es * (M * K + N * K + (M * N if r is not None else 0))
                      + 4 * N + out_es * M * N)
            _row(rows, "gemm", name + tag, dn, f"M={M} K={K} N={N}", err, ms,
                 pms, lms, 2.0 * M * K * N, nbytes)
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
            gl, bl = gm.to(idt), bt.to(idt)     # F.layer_norm: one dtype
            lms = cuda_ms(lambda i: F.layer_norm(x[i % 2], (H,), gl, bl,
                                                 1e-6), 10)
            in_es = 4 if idt == torch.float32 else 2
            _row(rows, "layer_norm", name + tag, dn, f"rows={M} H={H}", err,
                 ms, pms, lms, 8.0 * M * H, M * H * (in_es + es) + 8 * H)
        for kname, name, Bn, L, Lpa, with_bias in attn_cases:
            Bn = min(Bn, Bd)
            slab = [rnd(Bn, Lpa, 3 * H, dtype=dtype) for _ in range(2)]
            bias = _prefill_bias(Bn, L, Lpa, dev) if with_bias else None
            out = attention(slab[0], 12, L, bias)
            ref = attention_plain(slab[0], 12, L, bias)
            err = compare(f"{kname} {name} {dn}", out, ref, dtype)
            eq = _bits(f"{kname} {name}", out, ref)
            del out, ref
            ms = cuda_ms(lambda i: attention(slab[i % 2], 12, L, bias), 5)
            pms = cuda_ms(lambda i: attention_plain(slab[i % 2], 12, L,
                                                    bias), 5)
            # yardstick: SDPA on the slab's q/k/v with the same float mask
            mask = torch.zeros(Bn, 1, Lpa, Lpa, device=dev, dtype=dtype)
            mask[..., L:] = float("-inf")
            if bias is not None:
                mask = mask + bias.to(dtype)
            qkv = [s.view(Bn, Lpa, 3, 12, 64).permute(2, 0, 3, 1, 4)
                   for s in slab]
            lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                qkv[i % 2][0], qkv[i % 2][1], qkv[i % 2][2],
                attn_mask=mask), 5)
            nbytes = es * Bn * Lpa * 4 * H + (4 * Bn * Lpa * Lpa if with_bias
                                              else 0)
            _row(rows, kname, name, dn,
                 f"B={Bn} L={L} Lp={Lpa} heads=12x64", err, ms, pms, lms,
                 4.0 * Bn * 12 * Lpa * L * 64, nbytes)
            rows[-1]["bit_equal"] = eq
            del mask, qkv, slab, bias
            torch.cuda.empty_cache()
        del a, w, r, x
        torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[kernel] {r['kernel']:10s} {r['case']:20s} {r['dtype']:4s} "
            f"{r['shape']:32s} err {r['max_abs_err']:.3e}  "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device ms per call of `reps` calls of fn captured in one CUDA
    graph and replayed (after a warm-up call and a warm-up replay): the
    time of a kernel too short for back-to-back launches from the host to
    keep the card busy."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_decode_gemm(dev, rows):
    """The gemm at the fused decode step's four products (bf16, M = 128
    greedy and 384 beam-3 rows) vs its plain version: bf16 outputs at
    least 99% bit-equal, f32 outputs within 1e-5 of their scale; kernel,
    plain and F.linear times per call from CUDA graphs (graph_ms)."""
    from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
    g = torch.Generator().manual_seed(SEED + 11)
    dt, es = torch.bfloat16, 2
    first = len(rows)

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    for run, M in DECODE_GEMM_ROWS.items():
        for name, K, N, epi in DECODE_GEMM_CASES:
            a, w = rnd(M, K), rnd(N, K, scale=0.02)
            b = rnd(N, scale=0.02, dtype=torch.float32)
            r = rnd(M, N) if epi.get("residual") else None
            kw = dict(epi, residual=r)
            out, ref = gemm(a, w, b, **kw), gemm_plain(a, w, b, **kw)
            err = compare(f"gemm decode {name} {run}", out, ref, dt)
            eq = (out == ref).float().mean().item()
            if out.dtype == torch.bfloat16 and eq < 0.99:
                raise AssertionError(f"gemm decode {name} {run}: only "
                                     f"{eq:.4f} of outputs bit-equal")
            scale = ref.abs().max().item()
            if out.dtype == torch.float32 and err > 1e-5 * scale:
                raise AssertionError(f"gemm decode {name} {run}: f32 err "
                                     f"{err:.3g} > {1e-5 * scale:.3g}")
            ms = graph_ms(lambda: gemm(a, w, b, **kw))
            pms = graph_ms(lambda: gemm_plain(a, w, b, **kw))
            bd = b.to(dt)
            lms = graph_ms(lambda: F.linear(a, w, bd))
            out_es = 4 if epi.get("out_f32") else es
            nbytes = (es * (M * K + N * K + (M * N if r is not None else 0))
                      + 4 * N + out_es * M * N)
            _row(rows, "gemm", f"decode {name} {run}", "bf16",
                 f"M={M} K={K} N={N}", err, ms, pms, lms, 2.0 * M * K * N,
                 nbytes)
            rows[-1]["bit_equal"] = eq
    for r in rows[first:]:
        log(f"[kernel] gemm {r['case']:24s} {r['shape']:30s} err "
            f"{r['max_abs_err']:.3e}  bit-equal {r['bit_equal']:.6f}  kernel "
            f"{r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  "
            f"F.linear {r['library_ms'] * 1e3:.2f} us  bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")


def phase_decode_layer_norm(dev, rows):
    """The LayerNorm at the fused decode step's post-LN shapes (M = 128
    greedy and 384 beam-3 rows, H = 768, the f32 sublayer sum in, bf16
    out) vs its plain version, within the bf16 tolerance (bit-equal share
    recorded); kernel, plain and F.layer_norm times per call from CUDA
    graphs (graph_ms)."""
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    g = torch.Generator().manual_seed(SEED + 13)
    H, dt = 768, torch.bfloat16
    first = len(rows)
    for run, M in DECODE_GEMM_ROWS.items():
        x = (torch.randn(M, H, generator=g) * 3 + 1).to(dev)
        gm = (torch.randn(H, generator=g) + 1).to(dev)
        bt = torch.randn(H, generator=g).to(dev)
        out = layer_norm(x, gm, bt, 1e-12, dt)
        ref = layer_norm_plain(x, gm, bt, 1e-12, dt)
        err = compare(f"layer_norm decode {run}", out, ref, dt)
        eq = (out == ref).float().mean().item()
        ms = graph_ms(lambda: layer_norm(x, gm, bt, 1e-12, dt))
        pms = graph_ms(lambda: layer_norm_plain(x, gm, bt, 1e-12, dt))
        lms = graph_ms(lambda: F.layer_norm(x, (H,), gm, bt, 1e-12))
        _row(rows, "layer_norm", f"decode post-ln {run}", "bf16",
             f"rows={M} H={H} f32 in", err, ms, pms, lms, 8.0 * M * H,
             M * H * (4 + 2) + 8 * H)
        rows[-1]["bit_equal"] = eq
    for r in rows[first:]:
        log(f"[kernel] layer_norm {r['case']:24s} {r['shape']:24s} err "
            f"{r['max_abs_err']:.3e}  bit-equal {r['bit_equal']:.6f}  kernel "
            f"{r['ms'] * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  "
            f"F.layer_norm {r['library_ms'] * 1e3:.2f} us  bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")


def _decode_attention_inputs(dev, dtype, nb, t, S=628, A=20, H=768, g=None):
    """Flagship-width decode_attention inputs for B images of nb beams:
    window qkv, caption caches with history before slot t-1, context K/V,
    a per-image od validity (50 od slots, 3 + 4*i of them valid)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dtype)
    Bb = B * nb
    cap_k, cap_v = rnd(Bb, A, H), rnd(Bb, A, H)
    valid = torch.ones(B, S, dtype=torch.bool)
    for i in range(B):
        valid[i, 3 + 4 * (i % 12):50] = False
    bias = torch.where(valid, 0.0, -10000.0).float().to(dev)
    return dict(qkv=rnd(Bb, 2, 3 * H), cap_k=cap_k, cap_v=cap_v,
                ctx_k=rnd(B, S, H), ctx_v=rnd(B, S, H), bias=bias)


def _sdpa_decode_inputs(d, t, nh=12):
    """The same attention as one SDPA call: per row, keys = the caption
    slots < t (prev's at t-1), the MASK row's own key, the image's context
    (repeated per beam), under one float mask.  Built outside the timing."""
    Bb, _, H3 = d["qkv"].shape
    H = H3 // 3
    nb = Bb // d["ctx_k"].shape[0]
    hd = H // nh
    q, kw, vw = d["qkv"].split(H, dim=-1)
    ck, cv = d["cap_k"][:, :t].clone(), d["cap_v"][:, :t].clone()
    ck[:, t - 1], cv[:, t - 1] = kw[:, 0], vw[:, 0]

    def keys(cap, own, ctx):
        a = torch.cat([cap, own[:, 1:2],
                       ctx.repeat_interleave(nb, dim=0)], dim=1)
        return a.view(Bb, -1, nh, hd).transpose(1, 2).contiguous()
    S = d["ctx_k"].shape[1]
    mask = torch.zeros(Bb, 1, 2, t + 1 + S, device=q.device, dtype=q.dtype)
    mask[:, :, 0, t] = float("-inf")                 # prev: no MASK key
    mask[:, :, :, t + 1:] = d["bias"].repeat_interleave(nb, 0)[:, None, None]
    return (q.reshape(Bb, 2, nh, hd).transpose(1, 2).contiguous(),
            keys(ck, kw, d["ctx_k"]), keys(cv, vw, d["ctx_v"]), mask)


def phase_decode_attention(dev, rows, S=628, tag="",
                           cases=(("greedy", 1), ("beam3", 3)),
                           dtypes=(torch.bfloat16, torch.float32)):
    """decode_attention vs its plain version at `cases` (name, beams nb:
    the greedy and beam-3 geometries), S context tokens (628 at 384 px),
    A=20, t=10, in `dtypes`; `tag` is appended to the case names.  bf16 on the cluster
    kernel: at least 99% of outputs bit-equal.  ms: back-to-back launches
    (cuda_ms); graph_ms: per call from a CUDA graph."""
    from vitcap_tpu_torch.ops.decode_step import (decode_attention,
                                                  decode_attention_plain,
                                                  plan)
    g = torch.Generator().manual_seed(SEED + 5)
    nh, A, t, H = 12, 20, 10, 768
    t_dev = torch.tensor([t], dtype=torch.int32, device=dev)
    for dtype in dtypes:
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        for case, nb in cases:
            d = _decode_attention_inputs(dev, dtype, nb, t, S, A, H, g)
            Bb = B * nb
            caps = [d["cap_k"].clone(), d["cap_v"].clone()]
            sdpa = _sdpa_decode_inputs(d, t)
            args = (d["ctx_k"], d["ctx_v"], d["bias"])
            out = decode_attention(d["qkv"], *caps, *args, t_dev, nh)
            ref = decode_attention_plain(d["qkv"], d["cap_k"], d["cap_v"],
                                         *args, t, nh)
            err = compare(f"decode_attention {case} {dn}", out, ref, dtype)
            if not (torch.equal(caps[0], d["cap_k"])
                    and torch.equal(caps[1], d["cap_v"])):
                raise AssertionError(f"decode_attention {case} {dn}: "
                                     f"caption caches differ from plain")
            eq = (out == ref).float().mean().item()
            ranks = plan(S, nb, H // nh, A, dtype).ranks
            if ranks and eq < 0.99:
                raise AssertionError(f"decode_attention {case} {dn}: only "
                                     f"{eq:.4f} of outputs bit-equal")
            lib = F.scaled_dot_product_attention(*sdpa[:3],
                                                 attn_mask=sdpa[3])
            lib_err = (lib.transpose(1, 2).reshape(Bb, 2, H).float()
                       - ref.float()).abs().max().item()
            ms = cuda_ms(lambda i: decode_attention(d["qkv"], *caps, *args,
                                                    t_dev, nh), 20)
            gms = graph_ms(lambda: decode_attention(d["qkv"], *caps, *args,
                                                    t_dev, nh), 20)
            pms = cuda_ms(lambda i: decode_attention_plain(
                d["qkv"], *caps, *args, t, nh), 5)
            lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                *sdpa[:3], attn_mask=sdpa[3]), 20)
            # context K/V and bias once, the caption slots < t-1 of every
            # row, the window, the prev slot's k/v written, the output
            nbytes = (es * (2 * B * S * H + 2 * Bb * (t - 1) * H
                            + Bb * 2 * 3 * H + 2 * Bb * H + Bb * 2 * H)
                      + 4 * B * S)
            flops = 4.0 * Bb * 2 * (S + t) * H
            _row(rows, "decode_attention", case + tag, dn,
                 f"B={B} nb={nb} S={S} A={A} t={t} heads=12x64", err, ms,
                 pms, lms, flops, nbytes)
            r = rows[-1]
            r.update(bit_equal=eq, graph_ms=gms, ranks=ranks)
            log(f"[decode_attention] {case + tag:11s} {dn:4s} err {err:.3e} "
                f"(SDPA vs plain {lib_err:.3e})  bit-equal {eq:.6f}  "
                f"ranks {ranks}  kernel {ms:.4f} ms (graph {gms:.4f})  "
                f"plain {pms:.4f} ms  SDPA {lms:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB)")
            del d, caps, sdpa, out, ref, lib
            torch.cuda.empty_cache()


def phase_blocks(dev, rows):
    """The fused ViT and BERT blocks vs the plain blocks (their attention
    on its plain version: _plain_attention), chained calls timed."""
    with _plain_attention():
        _phase_blocks(dev, rows)


def _phase_blocks(dev, rows):
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


def phase_decode_step(dev, rows):
    """One fused decode step of the 4 flagship decoder layers (28
    launches) vs fused_decode_step_plain, greedy and beam-3, bf16 and f32;
    the bound counts the context K/V of 4 layers and the layer weights."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.ops.decode_step import (fused_decode_step,
                                                  fused_decode_step_plain,
                                                  pack_decode_layers)
    cfg = ModelConfig(num_hidden_layers=1, split_blocks=1)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    g = torch.Generator().manual_seed(SEED + 6)
    nL, H, S, A, t = cfg.decoder_layers, cfg.hidden_size, 628, 20, 10
    t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        packed = pack_decode_layers(model, dtype)
        w_bytes = sum(v.numel() * v.element_size() for v in packed.values())
        for case, nb in (("greedy", 1), ("beam3", 3)):
            Bb = B * nb

            def rnd(*shape):
                return torch.randn(*shape, generator=g).to(dev, dtype)
            ctx_k, ctx_v = rnd(nL, B, S, H), rnd(nL, B, S, H)
            bias = torch.zeros(B, S, device=dev)
            bias[:, 10:50] = -10000.0
            cap_k, cap_v = rnd(nL, Bb, A, H), rnd(nL, Bb, A, H)
            x = rnd(Bb, 2, H)
            args = (packed, ctx_k, ctx_v, bias)
            kw = dict(num_heads=cfg.num_attention_heads,
                      eps=cfg.bert_layer_norm_eps)
            caps = [cap_k.clone(), cap_v.clone()]
            ops.reset_counts()
            out = fused_decode_step(*args, *caps, x, t_dev, **kw)
            counts = ops.launch_counts()
            if counts != {"gemm": 4 * nL, "layer_norm": 2 * nL,
                          "attention": 0, "attention_bwd": 0,
                          "decode_attention": nL}:
                raise AssertionError(f"fused step launches {counts}")
            ref = fused_decode_step_plain(*args, cap_k, cap_v, x, t, **kw)
            err = compare(f"fused_decode_step {case} {dn}", out, ref, dtype)
            for got, want in zip(caps, (cap_k, cap_v)):
                compare(f"fused_decode_step {case} {dn} caches", got, want,
                        dtype)
            ms = cuda_ms(lambda i: fused_decode_step(*args, *caps, x, t_dev,
                                                     **kw), 10)
            pms = cuda_ms(lambda i: fused_decode_step_plain(
                *args, cap_k, cap_v, x, t, **kw), 3)
            nbytes = es * nL * (2 * B * S * H) + w_bytes
            b_ms, b_by = bound(0.0, nbytes, dn)
            rows.append(dict(kernel="fused_decode_step", case=case, dtype=dn,
                             shape=f"B={B} nb={nb} S={S} nL={nL} t={t}",
                             max_abs_err=err, ms=ms, plain_ms=pms,
                             bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
            log(f"[step] fused_decode_step {case:6s} {dn:4s} err {err:.3e}"
                f"  kernels {ms:.4f} ms  plain {pms:.4f} ms  bound "
                f"{b_ms:.4f} ms ({nbytes / 1e6:.1f} MB: context K/V + "
                f"weights)")
            del ctx_k, ctx_v, cap_k, cap_v, caps, out, ref
            torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()


def _flagship(dev):
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    cfg = ModelConfig(dtype="bfloat16")
    return cfg, init_params(cfg, torch.Generator().manual_seed(SEED), dev)


def _opts(cfg, **kw):
    from vitcap_tpu_torch.models import decode as TD
    return TD.DecodeOptions(max_length=cfg.max_gen_length,
                            od_labels_start_posid=cfg.max_seq_a_len, **kw)


@contextlib.contextmanager
def _env(name: str, value: str):
    """os.environ[name] = value inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def _engine(fused: bool):
    """Select the decode engine for a block, as a user does: through
    VITCAP_DECODE_FUSED."""
    return _env("VITCAP_DECODE_FUSED", "1" if fused else "0")


def _serve(dev, smi, cfg, model, opts, label, per_batch, img=None,
           modes=None):
    """A CaptionServer (batch B) answers 3 x B uint8 img x img requests
    (default: the model's size) from 8 client threads; every batch must
    launch exactly `per_batch` kernels, and of the kernels' modes exactly
    `modes` (the others none).  Returns the launch counts of the run (set
    to 0 just before it) and its rates."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.data.tokenization import CaptionDecoder
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.serving import CaptionServer
    img = img or cfg.img_size
    want = {**per_batch, **{k: 0 for k in ops.mode_counts()},
            **(modes or {})}
    rs = np.random.RandomState(SEED)
    images = rs.randint(0, 256, (3, B, img, img, 3)).astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    # warm-up batch outside the counted run (allocator, library handles)
    TD.generate(model, torch.from_numpy(images[0]).to(dev),
                torch.zeros(B, od_len, dtype=torch.long, device=dev), None,
                torch.full((B,), cfg.max_seq_a_len, device=dev), cfg, opts)
    torch.cuda.synchronize()

    results, batches, round_s = [], [], []
    server = CaptionServer(model, cfg, opts, tokenizer=CaptionDecoder(),
                           batch_size=B, max_delay_s=1.0)
    ops.reset_counts()
    t0 = time.perf_counter()
    try:
        for rnd in range(3):
            before = dict(ops.launch_counts(), **ops.mode_counts())
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
            if any(t.is_alive() for t in threads):
                raise AssertionError(f"{label}: a client thread hung")
            results += [f.result(timeout=300) for f in futs]
            round_s.append(time.perf_counter() - t_round)
            after = dict(ops.launch_counts(), **ops.mode_counts())
            batches.append({k: after[k] - before[k] for k in after})
    finally:
        server.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, modes_run = ops.launch_counts(), ops.mode_counts()
    stats = server.stats()
    log(f"[{label}] batches {stats['batches']} requests {stats['requests']} "
        f"launches per batch {batches}")
    if stats["batches"] != 3:
        raise AssertionError(f"{label}: expected 3 batches of {B}, got "
                             f"{stats}")
    for d in batches:
        if d != want:
            raise AssertionError(f"{label}: launches per batch {d} != "
                                 f"{want}")
    for r in results:
        if not (isinstance(r["caption"], str) and 0.0 < r["conf"] <= 1.0):
            raise AssertionError(f"{label}: bad result {r}")
    rate = len(results) / seconds
    log(f"[{label}] example captions (random weights): "
        f"{[r['caption'][:40] for r in results[:2]]}")
    log(f"[{label}] captions/s {rate:.2f} (B={B}, bf16, {img}x{img}, "
        f"{cfg.max_gen_length} steps, {len(results)} requests in "
        f"{seconds:.3f} s, first batch included) on {smi}")
    log(f"[{label}] seconds per round of {B} requests: {round_s}")
    return counts, {"captions_per_s": rate, "seconds": seconds,
                    "round_seconds": round_s, "launches_per_batch": batches,
                    "mode_launches": modes_run}


def phase_main_path(dev, smi):
    """Greedy on the eager engine (the default engine's path)."""
    cfg, model = _flagship(dev)
    with _engine(fused=False):
        counts, out = _serve(dev, smi, cfg, model, _opts(cfg), "greedy",
                             PER_BATCH)
    del model
    torch.cuda.empty_cache()
    return counts, out


def phase_beam_path(dev, smi):
    """Beam-3 on the fused engine (this slice's main path), then greedy on
    the fused engine."""
    cfg, model = _flagship(dev)
    with _engine(fused=True):
        counts, beam = _serve(dev, smi, cfg, model, _opts(cfg, num_beams=3),
                              "beam3-fused", FUSED_PER_BATCH)
        _, greedy = _serve(dev, smi, cfg, model, _opts(cfg), "greedy-fused",
                           FUSED_PER_BATCH)
    del model
    torch.cuda.empty_cache()
    return counts, {"beam3_fused": beam, "greedy_fused": greedy}


def phase_parity(dev):
    """f32, B=2, card vs CPU: tag logits, context K/V and first-step
    logits within 1e-3 relative; greedy and beam-3 ids equal, under both
    engines."""
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
    greedy, beam = _opts(cfg), _opts(cfg, num_beams=3, num_keep_best=2)

    def run(model, d, layout):
        od = torch.zeros(2, od_len, dtype=torch.long, device=d)
        sl = torch.tensor([cfg.max_seq_a_len + 3, cfg.max_seq_a_len + 40],
                          device=d)
        ctx = TD.build_decode_context(model, imgs.to(d), od, None, sl, cfg,
                                      greedy, layout=layout)
        with torch.inference_mode():   # first decode step, as generate runs it
            init, step, _ = TD._decode_engine(model, ctx, cfg, greedy, 2)
            first, _ = step(init(), torch.full((2,), cfg.cls_token_id,
                                               device=d), 1)
        k, v = ctx["ctx_k"], ctx["ctx_v"]
        if layout == "heads":
            k, v = torch.stack(k), torch.stack(v)
        return {"tag_logits": ctx["tag_logits"], "ctx_k": k, "ctx_v": v,
                "first_logits": first,
                "greedy": TD.generate_greedy(model, None, None, None, None,
                                             cfg, greedy, ctx=ctx)["ids"],
                "beam3": TD.generate_beam(model, None, None, None, None, cfg,
                                          beam, ctx=ctx)["ids"]}

    for layout in ("heads", "flat"):
        ref = run(cpu_model, "cpu", layout)
        got = run(gpu_model, dev, layout)
        torch.cuda.synchronize()
        for key in ("tag_logits", "ctx_k", "ctx_v", "first_logits"):
            a, b = got[key].float().cpu(), ref[key].float()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            log(f"[parity] {layout:5s} {key:12s} max rel err {rel:.3e}")
            if not (torch.isfinite(a).all() and rel <= 1e-3):
                raise AssertionError(f"parity {layout} {key}: rel err "
                                     f"{rel:.3e} > 1e-3")
        for key in ("greedy", "beam3"):
            same = torch.equal(got[key].cpu(), ref[key])
            log(f"[parity] {layout:5s} {key} ids GPU == CPU: {same} "
                f"({ref[key].numel()} ids)")
            if not same:
                raise AssertionError(f"parity {layout} {key}: ids differ")


def _train_batch(cfg, Bn, seed, dev, img=None):
    """A batch of the JAX package's bench training line (bench.py:151-164)
    from a numpy seed: uint8 img x img images (default: the model's size),
    ids in [999, 9000), captions of max_seq_a_len tokens, 3 masked
    positions, multi-hot labels at 0.2%."""
    rs = np.random.RandomState(seed)
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    img = img or cfg.img_size
    masked_pos = np.zeros((Bn, T), np.int64)
    masked_pos[:, 1:4] = 1
    batch = {
        "image": rs.randint(0, 256, (Bn, img, img, 3)).astype(np.uint8),
        "input_ids": rs.randint(999, 9000, (Bn, T)),
        "token_type_ids": np.concatenate(
            [np.zeros((Bn, A), np.int64), np.ones((Bn, T - A), np.int64)], 1),
        "seq_a_len": np.full((Bn,), A), "seq_len": np.full((Bn,), T),
        "masked_pos": masked_pos,
        "masked_ids": rs.randint(999, 9000, (Bn, cfg.max_masked_tokens)),
        "label": (rs.rand(Bn, cfg.tag_vocab_size) < 0.002)
                 .astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _bert_train_bias(Bn, L, Lp, dev):
    """The flagship decoder's bias at the train shape: 70 text tokens
    (20 causal caption, 50 od), then tag CLS and the visual tokens (577 at
    384 px, 1025 at 512 px), padded to Lp (padded keys are masked by
    l_actual)."""
    from vitcap_tpu_torch.models import vitcap as TM
    from vitcap_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig()
    A, T = cfg.max_seq_a_len, cfg.max_seq_len
    mask = TM.seq2seq_text_mask(torch.full((Bn,), A, device=dev),
                                torch.full((Bn,), T, device=dev), cfg)
    bias = TM.decoder_bias_from_text_mask(mask, L - T)
    return F.pad(bias, (0, Lp - L, 0, Lp - L)).contiguous()


def _time_pair(fn_kernel, fn_plain, reps=5, plain_reps=3):
    return cuda_ms(fn_kernel, reps), cuda_ms(fn_plain, plain_reps)


@contextlib.contextmanager
def _plain_attention():
    """models.layers' attention routes on the kernels' plain PyTorch
    versions (flash_attention_packed_plain for train calls,
    flash_attention_plain for calls that carry no gradient), so a plain
    block is plain PyTorch throughout: the reference a kernel block is
    held to."""
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.ops import flash_attention as FA
    kernels = (TL.flash_attention_packed, TL.flash_attention)
    TL.flash_attention_packed = FA.flash_attention_packed_plain
    TL.flash_attention = FA.flash_attention_plain
    try:
        yield
    finally:
        TL.flash_attention_packed, TL.flash_attention = kernels


def phase_train_kernels(dev, rows):
    """The train kernels vs their plain versions at the flagship train
    shapes (B=64), bf16 and f32: LayerNorm with stats (ViT and BERT rows),
    the gemm's pre-GELU output (ViT fc1), the K7 dropout epilogue (BERT
    out-dense and fc2, rates 0 and 0.1), attention with prob dropout (BERT,
    bias, 0.1), and attention_bwd (ViT: no bias, rate 0, l_actual 577;
    BERT: bias, 0.1, l_actual 648; f32 over F32_B images).  Yardsticks:
    F.layer_norm, F.linear, SDPA with a float mask and dropout_p, and
    SDPA's backward on a retained graph."""
    from vitcap_tpu_torch.ops.attention import attention, attention_plain
    from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd,
                                                    attention_bwd_plain)
    from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    g = torch.Generator().manual_seed(SEED + 7)
    H, nh, hd = 768, 12, 64
    first = len(rows)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def bits(name, out, ref):
        if out.dtype == torch.bfloat16:
            eq = (out == ref).float().mean().item()
            if eq < 0.99:
                raise AssertionError(f"{name}: only {eq:.4f} bit-equal")
            return eq
        return None

    for dtype, Bd in ((torch.bfloat16, B), (torch.float32, F32_B)):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        for case, M in (("vit rows", B * 592), ("bert rows", B * 656)):
            x = [rnd(M, H, scale=3.0, dtype=dtype) + 1 for _ in range(2)]
            gm, bt = rnd(H) + 1, rnd(H)
            out = layer_norm(x[0], gm, bt, 1e-6, dtype, stats=True)
            ref = layer_norm_plain(x[0], gm, bt, 1e-6, dtype, stats=True)
            err = max(compare(f"layer_norm[stats] {case} {dn}", o, r,
                              o.dtype) for o, r in zip(out, ref))
            ms, pms = _time_pair(
                lambda i: layer_norm(x[i % 2], gm, bt, 1e-6, dtype,
                                     stats=True),
                lambda i: layer_norm_plain(x[i % 2], gm, bt, 1e-6, dtype,
                                           stats=True), 10, 5)
            gl, bl = gm.to(dtype), bt.to(dtype)
            lms = cuda_ms(lambda i: F.layer_norm(x[i % 2], (H,), gl, bl,
                                                 1e-6), 10)
            _row(rows, "layer_norm[stats]", case, dn, f"rows={M} H={H}", err,
                 ms, pms, lms, 8.0 * M * H, M * H * 2 * es + 8 * M + 8 * H)
            del x
        # fc1 with the pre-GELU output (K6 / K7)
        M, K, N = B * 592, 768, 3072
        a = [rnd(M, K, dtype=dtype) for _ in range(2)]
        w, b = rnd(N, K, scale=0.02, dtype=dtype), rnd(N, scale=0.02)
        pre, pre_ref = (torch.empty(M, N, dtype=dtype, device=dev)
                        for _ in range(2))
        out = gemm(a[0], w, b, gelu=True, pre_out=pre)
        ref = gemm_plain(a[0], w, b, gelu=True, pre_out=pre_ref)
        err = max(compare(f"gemm[pre_out] {dn}", out, ref, dtype),
                  compare(f"gemm[pre_out] pre {dn}", pre, pre_ref, dtype))
        bits("gemm[pre_out]", out, ref)
        bits("gemm[pre_out] pre", pre, pre_ref)
        ms, pms = _time_pair(
            lambda i: gemm(a[i % 2], w, b, gelu=True, pre_out=pre),
            lambda i: gemm_plain(a[i % 2], w, b, gelu=True, pre_out=pre_ref),
            10, 5)
        bd = b.to(dtype)
        lms = cuda_ms(lambda i: F.linear(a[i % 2], w, bd), 10)
        _row(rows, "gemm[pre_out]", "vit fc1+gelu+pre", dn,
             f"M={M} K={K} N={N}", err, ms, pms, lms, 2.0 * M * K * N,
             es * (M * K + N * K + 2 * M * N) + 4 * N)
        del a, pre, pre_ref, out, ref
        # the K7 epilogue: bias, hidden dropout, residual
        M = B * 656
        for case, K in (("bert out-dense", 768), ("bert fc2", 3072)):
            a = [rnd(M, K, dtype=dtype) for _ in range(2)]
            w, b = rnd(H, K, scale=0.02, dtype=dtype), rnd(H, scale=0.02)
            r = rnd(M, H, dtype=dtype)
            for rate in (0.0, 0.1):
                drop = (rate, -1234567, 1, 656)
                out = gemm(a[0], w, b, residual=r, dropout=drop)
                ref = gemm_plain(a[0], w, b, residual=r, dropout=drop)
                name = f"gemm[dropout] {case} rate {rate} {dn}"
                err = compare(name, out, ref, dtype)
                bits(name, out, ref)
                ms, pms = _time_pair(
                    lambda i: gemm(a[i % 2], w, b, residual=r, dropout=drop),
                    lambda i: gemm_plain(a[i % 2], w, b, residual=r,
                                         dropout=drop), 10, 5)
                bd = b.to(dtype)
                lms = cuda_ms(lambda i: F.linear(a[i % 2], w, bd), 10)
                _row(rows, "gemm[dropout]", f"{case} rate {rate}", dn,
                     f"M={M} K={K} N={H}", err, ms, pms, lms,
                     2.0 * M * K * H, es * (M * K + H * K + 2 * M * H)
                     + 4 * H)
            del a, r
        # K8 forward (BERT train) and backward (ViT and BERT)
        for case, L, Lp, with_bias, rate in (
                ("vit", 577, 592, False, 0.0),
                ("bert", 648, 656, True, 0.1)):
            slab = rnd(Bd, Lp, 3 * H, dtype=dtype)
            up = rnd(Bd, Lp, H, dtype=dtype)
            up[:, L:] = 0.0
            bias = _bert_train_bias(Bd, L, Lp, dev) if with_bias else None
            mask = torch.zeros(Bd, 1, Lp, Lp, device=dev, dtype=dtype)
            mask[..., L:] = float("-inf")
            if bias is not None:
                mask = mask + bias.to(dtype)
            if rate > 0:
                out = attention(slab, nh, L, bias, rate, 4242)
                ref = attention_plain(slab, nh, L, bias, rate, 4242)
                err = compare(f"attention[dropout] {case} {dn}", out, ref,
                              dtype)
                eq = _bits(f"attention[dropout] {case}", out, ref)
                ms, pms = _time_pair(
                    lambda i: attention(slab, nh, L, bias, rate, 4242),
                    lambda i: attention_plain(slab, nh, L, bias, rate, 4242),
                    5, 2)
                qkv = slab.view(Bd, Lp, 3, nh, hd).permute(2, 0, 3, 1, 4)
                lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                    qkv[0], qkv[1], qkv[2], attn_mask=mask, dropout_p=rate),
                    5)
                _row(rows, "attention[dropout]", f"{case} train", dn,
                     f"B={Bd} L={L} Lp={Lp} heads=12x64 rate={rate}", err,
                     ms, pms, lms, 4.0 * Bd * nh * Lp * L * hd,
                     es * Bd * Lp * 4 * H + 4 * Bd * Lp * Lp)
                rows[-1]["bit_equal"] = eq
                del out, ref, qkv
            got = attention_bwd(slab, up, nh, L, bias, rate, 777)
            want = attention_bwd_plain(slab, up, nh, L, bias, rate, 777)
            err, eqs = 0.0, []
            for part, o, r in zip("qkv", got, want):
                name = f"attention_bwd {case} d{part} {dn}"
                err = max(err, compare(name, o, r, dtype))
                eqs.append(bits(name, o, r))
            del got, want
            ms, pms = _time_pair(
                lambda i: attention_bwd(slab, up, nh, L, bias, rate, 777),
                lambda i: attention_bwd_plain(slab, up, nh, L, bias, rate,
                                              777), 3, 2)
            # yardstick: SDPA's backward on a retained graph (its forward
            # saved what its backward reads; dropout from its own RNG)
            qkv = [t.detach().contiguous().requires_grad_(True) for t in
                   slab.view(Bd, Lp, 3, nh, hd).permute(2, 0, 3, 1, 4)]
            o = F.scaled_dot_product_attention(*qkv, attn_mask=mask,
                                               dropout_p=rate)
            go = up.view(Bd, Lp, nh, hd).transpose(1, 2)
            lms = cuda_ms(lambda i: torch.autograd.grad(
                o, qkv, go, retain_graph=True), 3)
            _row(rows, "attention_bwd", case, dn,
                 f"B={Bd} L={L} Lp={Lp} heads=12x64 rate={rate} "
                 f"bias={with_bias}", err, ms, pms, lms,
                 10.0 * Bd * nh * Lp * L * hd,
                 es * Bd * Lp * 7 * H + (4 * Bd * Lp * Lp if with_bias
                                         else 0))
            rows[-1]["bit_equal"] = eqs[0] and min(eqs)
            del slab, up, bias, mask, qkv, o
            torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[train-kernel] {r['kernel']:18s} {r['case']:26s} "
            f"{r['dtype']:4s} err {r['max_abs_err']:.3e}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" + (f"  bit-equal {r['bit_equal']:.5f}"
                                    if r.get("bit_equal") else ""))


def phase_train_blocks(dev, rows):
    """The ViT and BERT train blocks (kernel forward, analytic backward)
    vs the plain blocks on the card (autograd, the attention's plain
    versions: _plain_attention), bf16, B=64 at the flagship
    train shapes: the output (bf16: 2e-2 of the scale), the input gradient
    and every parameter gradient (5e-2: cotangents rounded to bf16 at every
    link; floor of the scale 1e-3 of the block's largest gradient, under
    which a gradient is bf16 noise of an exact zero, the key bias's), with
    forward+backward times.  The BERT check runs at rate 0
    (the plain layer's dropout masks are other bits); its time is also
    taken at the flagship's prob dropout 0.1."""
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.ops.fused_block import (split_bert_layer_train,
                                                  split_vit_block_train)
    cfg = ModelConfig(num_hidden_layers=1, split_blocks=1, decoder_layers=1)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    model.requires_grad_(True)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    g = torch.Generator().manual_seed(SEED + 8)
    H, nh, dt = 768, 12, torch.bfloat16
    first = len(rows)
    for name, p, L, Lp in (("vit", blk, 577, 592), ("bert", layer, 648,
                                                    656)):
        x = torch.randn(B, Lp, H, generator=g).to(dev, dt)
        co = torch.randn(B, L, H, generator=g).to(dev)
        bias = _bert_train_bias(B, L, Lp, dev) if name == "bert" else None

        def kern(rate=0.0):
            xx = x.detach().requires_grad_(True)
            if bias is None:
                o = split_vit_block_train(p, xx, nh, 1e-6, L)
            else:
                o = split_bert_layer_train(p, xx, bias, nh, 1e-12, L, 0.0,
                                           rate, (5, 6))
            (o[:, :L].float() * co).sum().backward()
            return o[:, :L], xx.grad[:, :L]

        def plain():
            xx = x[:, :L].detach().requires_grad_(True)
            with _plain_attention():
                if bias is None:
                    o = TL._vit_block_plain(p, xx, nh, 1e-6)
                else:
                    o = TL._bert_layer_plain(p, xx, bias[:, :, :L, :L], nh,
                                             1e-12)
                (o.float() * co).sum().backward()
            return o, xx.grad

        params = list(p.parameters())
        model.zero_grad(set_to_none=True)
        out, gx = kern()
        kg = [t.grad.clone() for t in params]
        model.zero_grad(set_to_none=True)
        ref, rx = plain()
        err = compare(f"{name} train block out", out, ref, dt)
        gerr = 0.0
        pairs = [(gx, rx)] + [(k_, t.grad) for t, k_ in zip(params, kg)]
        top = max(w.float().abs().max().item() for _, w in pairs)
        for got, want in pairs:
            e = (got.float() - want.float()).abs().max().item()
            scale = max(want.float().abs().max().item(), 1e-3 * top)
            if not e <= 5e-2 * scale:
                raise AssertionError(f"{name} train block grad: {e:.3g} > "
                                     f"5e-2 of {scale:.3g}")
            gerr = max(gerr, e / max(scale, 1e-30))
        rate = 0.1 if bias is not None else 0.0
        ms = cuda_ms(lambda i: kern(rate), 3)
        pms = cuda_ms(lambda i: plain(), 3)
        model.zero_grad(set_to_none=True)
        rows.append(dict(kernel=f"{name}_train_block", case="fwd+bwd",
                         dtype="bf16", shape=f"B={B} L={L} Lp={Lp}",
                         max_abs_err=err, grad_rel_err=gerr, ms=ms,
                         plain_ms=pms))
        del x, co, bias, out, gx, ref, rx, kg
    for r in rows[first:]:
        log(f"[train-block] {r['kernel']:16s} {r['shape']:20s} err "
            f"{r['max_abs_err']:.3e} grads {r['grad_rel_err']:.3e} of scale"
            f"  kernels {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms "
            f"(forward + backward)")
    del model
    torch.cuda.empty_cache()


def _train_step_flops(cfg, Bn, img=None):
    """Operations of one train step, the JAX package's count (bench.py
    _train_fwd_flops, 3x the forward): trunk and tag blocks over the visual
    tokens (of img x img images, default the model's size), decoder layers
    over text + tag CLS + visual, LM and tag heads."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    V = ((img or cfg.img_size) // cfg.patch_size) ** 2 + 1

    def block(tokens):
        return 2 * (4 * tokens * H * H + 2 * tokens * tokens * H
                    + 2 * tokens * H * I)
    L = cfg.max_seq_len + 1 + V
    fwd = ((cfg.num_hidden_layers + cfg.split_blocks) * block(V)
           + cfg.decoder_layers * block(L)
           + 2 * H * cfg.vocab_size * cfg.max_seq_len
           + 2 * H * cfg.tag_vocab_size)
    return 3.0 * Bn * fwd


def phase_train_step(dev, smi, img=None, per_step_want=TRAIN_PER_STEP,
                     modes_want=TRAIN_MODES_PER_STEP, steps=8, tag="train"):
    """The flagship train step (the JAX package's bench training line):
    ModelConfig(dtype='bfloat16', tag_loss_weight=1.0), B=64, attention
    dropout 0.1, TrainHyper(base_lr=1e-4, max_iter=1000), no probes, on
    img x img images (default 384); one warm-up step, then `steps` timed
    steps, synchronised, each launching exactly per_step_want kernels (and
    modes_want of the kernels' modes).  Returns the counts of the timed run
    (set to 0 just before it), the results, and the train state and step."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state,
                                                    make_train_step)
    cfg = ModelConfig(dtype="bfloat16", tag_loss_weight=1.0)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    state = init_train_state(model, torch.Generator().manual_seed(SEED + 9))
    step = make_train_step(cfg, TrainHyper(base_lr=1e-4, max_iter=1000))
    batch = _train_batch(cfg, B, SEED + 10, dev, img)
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batch, False)
    warm_loss = m["loss"].item()
    ops.reset_counts()
    per_step, losses = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        before, mb = ops.launch_counts(), ops.mode_counts()
        state, m = step(state, batch, False)
        after, ma = ops.launch_counts(), ops.mode_counts()
        d = {k: after[k] - before[k] for k in after}
        d.update({k: ma[k] - mb[k] for k in ma})
        per_step.append(d)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(ops.launch_counts(), **ops.mode_counts())
    want = dict(per_step_want, **modes_want)
    for d in per_step:
        if d != want:
            raise AssertionError(f"{tag} step launches {d} != {want}")
    losses = [v.item() for v in losses]
    gnorm = m["grad_norm"].item()
    if not all(math.isfinite(v) for v in losses + [gnorm]):
        raise AssertionError(f"{tag} step: loss {losses}, grad_norm {gnorm}")
    step_ms = seconds / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = B * steps / seconds
    flops = _train_step_flops(cfg, B, img)
    bound_ms = flops / PEAK_FLOPS["bf16"] * 1e3
    img = img or cfg.img_size
    log(f"[{tag}] launches per step {per_step[0]}")
    log(f"[{tag}] losses {[round(v, 4) for v in losses]} grad_norm "
        f"{gnorm:.4f}")
    log(f"[{tag}] {rate:.2f} img/s, step {step_ms:.3f} ms (B={B}, bf16, "
        f"{img}x{img}, attention dropout 0.1, {steps} steps after 1 warm-up,"
        f" host clock around synchronised work), peak memory {peak:.2f} GiB "
        f"(warm-up included), on {smi}")
    log(f"[{tag}] step bound {bound_ms:.3f} ms ({flops / 1e12:.2f} TFLOP at "
        f"the bf16 peak): the step takes {step_ms / bound_ms:.2f}x it")
    out = {"img_per_s": rate, "step_ms": step_ms, "peak_gib": peak,
           "step_tflop": flops / 1e12, "step_bound_ms": bound_ms,
           "losses": losses, "grad_norm": gnorm,
           "first_losses": [warm_loss, losses[0]],
           "launches_per_step": per_step[0]}
    return counts, out, (state, step, batch)


def phase_train_parity(dev, img=None, attention_want=None, tag="train"):
    """One f32 train step on the card vs the CPU: full width, 4 trunk
    blocks (2 of them forked into the tag branch), 2 decoder layers, B=2,
    img x img images (default 384), attention dropout 0.1 with the same
    seeds on both sides; attention_want: the card's exact attention and
    attention_bwd launches and modes, when given.  Loss and
    grad norm within 1e-4 relative; every gradient within 1e-3 of its
    leaf's scale (floor: 1e-6 of the largest gradient, under which a leaf
    is the rounding noise of a gradient that is zero in exact arithmetic);
    updated parameters: at least 99.9% within 1e-2 lr of the CPU's and all
    within 2 lr (the first Adam step sends every gradient above ~1e-7 to a
    +-lr step, so a gradient near zero whose sign the summation order
    flips moves by 2 lr)."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import draw_layer_seeds, init_params
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state,
                                                    make_train_step)
    cfg = ModelConfig(num_hidden_layers=4, split_blocks=2, decoder_layers=2,
                      tag_loss_weight=1.0)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    seeds = draw_layer_seeds(torch.Generator().manual_seed(SEED + 13),
                             cfg.decoder_layers)
    lr = 1e-4
    res = {}
    for model, d in ((gpu_model, dev), (cpu_model, "cpu")):
        state = init_train_state(model, None)
        step = make_train_step(cfg, TrainHyper(base_lr=lr, max_iter=1000))
        ops.reset_counts()
        _, m = step(state, _train_batch(cfg, 2, SEED + 12, d, img), True,
                    seeds)
        if d == dev and attention_want is not None:
            torch.cuda.synchronize()
            got = dict(ops.launch_counts(), **ops.mode_counts())
            got = {k: got[k] for k in attention_want}
            log(f"[{tag}-parity] card launches {got}")
            if got != attention_want:
                raise AssertionError(f"{tag} parity launches {got} != "
                                     f"{attention_want}")
        res[d] = ({k: v.item() for k, v in m.items()},
                  {n: p.grad.float().cpu() for n, p in
                   model.named_parameters() if p.grad is not None},
                  {n: p.detach().float().cpu() for n, p in
                   model.named_parameters()})
    torch.cuda.synchronize()
    (gm, gg, gp), (cm, cg, cp) = res[dev], res["cpu"]
    for k in ("loss", "masked_loss", "tag_loss", "grad_norm"):
        rel = abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)
        log(f"[{tag}-parity] {k:12s} GPU {gm[k]:.7g} CPU {cm[k]:.7g} rel "
            f"{rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"{tag} parity {k}: rel {rel:.3e}")
    if gg.keys() != cg.keys():
        raise AssertionError(f"{tag} parity: gradient sets differ")
    top = max(t.abs().max().item() for t in cg.values())
    worst = 0.0
    for n in cg:
        scale = max(cg[n].abs().max().item(), 1e-6 * top)
        e = (gg[n] - cg[n]).abs().max().item() / scale
        worst = max(worst, e)
        if not e <= 1e-3:
            raise AssertionError(f"{tag} parity grad {n}: {e:.3e} of "
                                 f"scale")
    diff = torch.cat([(gp[n] - cp[n]).abs().flatten() for n in cp])
    close = (diff <= 1e-2 * lr).float().mean().item()
    log(f"[{tag}-parity] {len(cg)} gradients, worst {worst:.3e} of their "
        f"scale; updated parameters: {close:.6f} within 1e-2 lr, max "
        f"{diff.max().item() / lr:.3e} lr")
    if not (close >= 0.999 and diff.max().item() <= 2.0 * lr * (1 + 1e-3)):
        raise AssertionError(f"{tag} parity: updated parameters differ")
    return {"grad_worst_rel": worst, "params_close_share": close,
            "params_max_diff_lr": diff.max().item() / lr, "gpu": gm,
            "cpu": cm}


def summarise(rows, counts, mode_counts):
    """The per-kernel JSON entries.  launches: the beam path's run
    (phase 5b) for the serving kernels; for the kernel modes, the train
    step's timed run (8 steps) for the train modes, the fused 512-px
    serving run (phase 9) for attention[long] and the 512-px train step's
    timed run (6 steps, phase 10) for the non-slab modes, the zoo's
    counted batches (phase 18) for attention[hd>64] and
    layer_norm[wide], whose numbers are one launch (call) at the bf16
    shape named in MODE_SOURCES.
    max_abs_err: the largest of any check of the kernel.
    ms / plain_ms / library_ms / bound_ms: for gemm, layer_norm and
    attention, the sum over one fused ViT block's launches at B=64 bf16
    (4 gemm, 2 layer_norm, 1 attention); for decode_attention, one launch
    at the beam-3 geometry, bf16.  bound_by: the kind that contributes most
    to bound_ms."""
    per_launch = {"gemm": {"qkv": 1, "proj+res": 1, "fc1+gelu": 1,
                           "fc2+res": 1},
                  "layer_norm": {"ln": 2}, "attention": {"vit": 1},
                  "decode_attention": {"beam3": 1}}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = [(r, per_launch[name][r["case"]]) for r in mine
                if r["dtype"] == "bf16" and r["case"] in per_launch[name]]
        by = {}
        for r, n in main:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * n
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] * n for r, n in main),
            "plain_ms": sum(r["plain_ms"] * n for r, n in main),
            "bound_ms": sum(by.values()),
            "bound_by": max(by, key=by.get),
            "library_ms": sum(r["library_ms"] * n for r, n in main),
        })
    for name, (src, replaces, case) in MODE_SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        r = next(r for r in mine if r["dtype"] == "bf16"
                 and r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": mode_counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    return kernels


def _profile(name, fn, reps=3):
    """Host-clock time of fn (median of reps, synchronised, after two
    warm-up calls), then one call under torch.profiler: device busy time
    (the union of kernel and copy intervals), idle share against the
    unprofiled wall time, device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(ts)[len(ts) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    out = {"wall_ms": wall, "profiled_wall_ms": prof_wall,
           "device_busy_ms": busy, "device_events": len(spans),
           "idle_share": 1.0 - busy / wall,
           "kernels": [{"name": k, "ms": ms, "count": n}
                       for k, (ms, n) in top]}
    log(f"[profile] {name}: device busy {busy:.3f} ms of {wall:.3f} ms "
        f"wall: idle share {out['idle_share']:.4f} (profiled wall "
        f"{prof_wall:.3f} ms, {len(spans)} device events)")
    for k, (ms, n) in top[:8]:
        log(f"[profile] {name}: {ms:9.3f} ms {n:6d}x {k[:80]}")
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=40, max_name_column_width=90))
    return out


def _median_ms(fn):
    """Median host-clock ms of 3 synchronised calls of fn."""
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[1]


def _profile_batch(name, fn, wall_prefill, reps=3):
    """_profile of one decode batch, with its host-clock phases."""
    out = _profile(name, fn, reps)
    wall = out["wall_ms"]
    out.update(batch_ms=wall, encode_prefill_ms=wall_prefill,
               decode_loop_ms=wall - wall_prefill)
    log(f"[profile] {name}: batch {wall:.3f} ms (median of {reps}), encode "
        f"+ prefill {wall_prefill:.3f} ms, decode loop "
        f"{out['decode_loop_ms']:.3f} ms")
    return out


def phase_train_profile(train, name="train_step"):
    """Where one flagship train step (B=64, bf16) spends its time."""
    state, step, batch = train
    box = [state]

    def one():
        box[0], _ = step(box[0], batch, False)
    out = _profile(name, one)
    log(f"[profile] {name}: step {out['wall_ms']:.3f} ms (median of 3)")
    return out


# one flagship train step with train_fused_blocks: the 15 ViT blocks run
# the inference kernels forward (4 gemm, 2 layer_norm, 1 attention each)
# and, in the backward, the plain chain recomputed (cuBLAS products, eager
# LayerNorm, one packed attention call: 1 attention and 2 attention_bwd
# launches on separate q, k, v); the 4 decoder layers as phase 8's
TRAIN_FUSED_PER_STEP = {"gemm": 76, "layer_norm": 38, "attention": 34,
                        "attention_bwd": 38, "decode_attention": 0}
TRAIN_FUSED_MODES_PER_STEP = dict(
    TRAIN_MODES_PER_STEP, **{"gemm[pre_out]": 4, "layer_norm[stats]": 8,
                             "attention[non_slab]": 15,
                             "attention_bwd[non_slab]": 30})
TRAIN_FUSED_STEPS = 2


def phase_train_fused(dev, smi, split, split_profile):
    """cfg.train_fused_blocks at the flagship train line (B=64, bf16,
    attention dropout 0.1) from phase 8's initial state and batch: 2
    steps, each launching exactly TRAIN_FUSED_PER_STEP (counts set to 0
    before, read after), their losses within BF16_TOL of phase 8's first
    two; then the step's time, idle share and peak memory beside phase
    8's (`split`, `split_profile`)."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state,
                                                    make_train_step)
    cfg = ModelConfig(dtype="bfloat16", tag_loss_weight=1.0,
                      train_fused_blocks=True)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    state = init_train_state(model, torch.Generator().manual_seed(SEED + 9))
    step = make_train_step(cfg, TrainHyper(base_lr=1e-4, max_iter=1000))
    batch = _train_batch(cfg, B, SEED + 10, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = dict(TRAIN_FUSED_PER_STEP, **TRAIN_FUSED_MODES_PER_STEP)
    losses, step_ms = [], []
    for _ in range(TRAIN_FUSED_STEPS):
        ops.reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = dict(ops.launch_counts(), **ops.mode_counts())
        if got != want:
            raise AssertionError(f"train_fused step launches {got} != "
                                 f"{want}")
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref = split["first_losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    log(f"[train_fused] launches per step {got}")
    log(f"[train_fused] losses {losses} vs the split route's {ref}: "
        f"relative {rel} (bound {BF16_TOL})")
    if not (all(math.isfinite(v) for v in losses)
            and max(rel) <= BF16_TOL):
        raise AssertionError(f"train_fused losses {losses} vs {ref}")
    prof = phase_train_profile((state, step, batch), "train_fused_step")
    log(f"[train_fused] step {prof['wall_ms']:.3f} ms (median of 3; the "
        f"first two {step_ms[0]:.3f}, {step_ms[1]:.3f}), idle share "
        f"{prof['idle_share']:.4f}, peak memory {peak:.2f} GiB; the split "
        f"route (phase 8): step {split_profile['wall_ms']:.3f} ms, idle "
        f"share {split_profile['idle_share']:.4f}, peak memory "
        f"{split['peak_gib']:.2f} GiB (B={B}, bf16, attention dropout "
        f"0.1) on {smi}")
    del state, step, batch, model
    torch.cuda.empty_cache()
    return {"losses": losses, "split_losses": ref, "loss_rel": rel,
            "first_step_ms": step_ms, "step_ms": prof["wall_ms"],
            "idle_share": prof["idle_share"], "peak_gib": peak,
            "split_step_ms": split_profile["wall_ms"],
            "split_idle_share": split_profile["idle_share"],
            "split_peak_gib": split["peak_gib"], "launches_per_step": got,
            "profile": prof}


def phase_profile(dev):
    """Flagship batches (B=64, bf16): greedy on the eager engine, greedy
    and beam-3 on the fused engine.  Encode once; encode + prefill per
    engine (the layouts differ), median of 3 each."""
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models import vitcap as TM
    cfg, model = _flagship(dev)
    rs = np.random.RandomState(SEED + 3)
    imgs = torch.from_numpy(rs.randint(0, 256, (B, cfg.img_size,
                                                 cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.zeros(B, cfg.max_seq_len - cfg.max_seq_a_len,
                     dtype=torch.long, device=dev)
    sl = torch.full((B,), cfg.max_seq_a_len, device=dev)
    out = {"encode_ms": _median_ms(lambda: TM.encode_images(model, imgs,
                                                            cfg))}
    log(f"[profile] encode {out['encode_ms']:.3f} ms")
    for name, fused, opts in (("greedy_eager", False, _opts(cfg)),
                              ("greedy_fused", True, _opts(cfg)),
                              ("beam3_fused", True,
                               _opts(cfg, num_beams=3))):
        with _engine(fused):
            prefill = _median_ms(lambda: TD.build_decode_context(
                model, imgs, od, None, sl, cfg, opts))
            out[name] = _profile_batch(name, lambda: TD.generate(
                model, imgs, od, None, sl, cfg, opts), prefill)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: high resolution (512 px against 384-px weights; K10)
# ---------------------------------------------------------------------------

def _block_work(Bn, Lp, L, es, bias, H=768, I=3072, nh=12):
    """One block's (operations, bytes): the four products over Lp rows and
    the attention's two over Lp queries and L keys; x read and the output
    written, the weights read once, and the f32 (B, 1, Lp, Lp) bias."""
    flops = 2.0 * Bn * Lp * H * (4 * H + 2 * I) + 4.0 * Bn * nh * Lp * L * (
        H // nh)
    nbytes = es * (2 * Bn * Lp * H + H * (4 * H + 2 * I)) + (
        4 * Bn * Lp * Lp if bias else 0)
    return flops, nbytes


def phase_highres_kernels(dev, rows):
    """The kernels at the 512-px shapes, B=64, Lp=1152, bf16 and f32: the
    ViT gemms and LayerNorms over B * 1152 rows, ViT attention (l_actual
    1025, no bias) and the prefill's (l_actual 1076 = 50 od + tag CLS +
    1025 visual, its (B, 1, Lp, Lp) f32 bias), each vs its plain version,
    with its bound and yardstick (F.linear, F.layer_norm, SDPA with the
    float mask); decode_attention over the 1076-token context."""
    phase_kernels(dev, rows, Lp=1152, gemm_cases=GEMM_CASES[:4],
                  attn_cases=[("attention[long]", "vit long", B, 1025, 1152,
                               False),
                              ("attention[long]", "bert-prefill long", B,
                               1076, 1152, True)],
                  tag=" long")
    # the decode step's attention over the 512-px context (50 od + tag CLS
    # + 1025 visual, unpadded)
    phase_decode_attention(dev, rows, S=1076, tag=" 512px")


def phase_highres_blocks(dev, rows):
    """fused_vit_block at L=1025 and fused_bert_block at L=1076 with the
    prefill bias (both Lp 1152, B=64), the K10 compositions, vs the plain
    blocks (their attention on its plain version: _plain_attention);
    chained calls timed, beside the block's bound."""
    with _plain_attention():
        _phase_highres_blocks(dev, rows)


def _phase_highres_blocks(dev, rows):
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.ops.fused_block import (fused_bert_block,
                                                  fused_vit_block)
    cfg = ModelConfig(num_hidden_layers=1, split_blocks=1, decoder_layers=1)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    g = torch.Generator().manual_seed(SEED + 14)
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    first = len(rows)
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, L in (("fused_vit_block", 1025), ("fused_bert_block",
                                                    1076)):
            x = torch.randn(B, L, H, generator=g).to(dev, dtype)
            if name == "fused_vit_block":
                def kern(y):
                    return fused_vit_block(blk, y, nh, 1e-6)

                def plain(y):
                    return TL._vit_block_plain(blk, y, nh, 1e-6)
            else:
                bias = _prefill_bias(B, L, L, dev)

                def kern(y):
                    return fused_bert_block(layer, y, bias, nh, 1e-12)

                def plain(y):
                    return TL._bert_layer_plain(layer, y, bias, nh, 1e-12)
            err = compare(f"{name} long {dn}", kern(x), plain(x), dtype)
            ys = [x]
            ms = cuda_ms(lambda i: ys.append(kern(ys.pop())), 3)
            ys = [x]
            pms = cuda_ms(lambda i: ys.append(plain(ys.pop())), 3)
            flops, nbytes = _block_work(
                B, 1152, L, 2 if dtype == torch.bfloat16 else 4,
                name == "fused_bert_block")
            b_ms, b_by = bound(flops, nbytes, dn)
            rows.append(dict(kernel=name, case="chain long", dtype=dn,
                             shape=f"B={B} L={L} Lp=1152", max_abs_err=err,
                             ms=ms, plain_ms=pms, flops=flops, bytes=nbytes,
                             bound_ms=b_ms, bound_by=b_by))
            del x, ys
            torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[block] {r['kernel']:16s} {r['dtype']:4s} {r['shape']:22s} "
            f"err {r['max_abs_err']:.3e}  kernels {r['ms']:.3f} ms  "
            f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}: {r['flops'] / 1e12:.3f} TFLOP, "
            f"{r['bytes'] / 1e6:.1f} MB)")
    del model
    torch.cuda.empty_cache()


def phase_highres_path(dev, smi):
    """The 512-px serving path: the flagship built for 384 px serves
    3 x 64 uint8 512x512 requests on the eager and on the fused engine
    (exactly 72 gemm, 36 layer_norm and 18 attention launches per batch,
    all 18 long); one batch with token_filter_keep=0.5 (2 long attention
    launches of 18); then the profile of one fused 512-px batch.  Returns
    the fused run's counts (set to 0 just before it) and the results."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models import vitcap as TM
    cfg, model = _flagship(dev)
    out = {}
    with _engine(fused=False):
        _, out["greedy_eager"] = _serve(dev, smi, cfg, model, _opts(cfg),
                                        "greedy-512", PER_BATCH,
                                        img=HIGHRES, modes=LONG)
    with _engine(fused=True):
        counts, out["greedy_fused"] = _serve(
            dev, smi, cfg, model, _opts(cfg), "greedy-fused-512",
            FUSED_PER_BATCH, img=HIGHRES, modes=LONG)
    counts = dict(counts, **out["greedy_fused"]["mode_launches"])
    for name, n in counts.items():
        if n == 0 and name in ("gemm", "layer_norm", "attention",
                               "decode_attention", "attention[long]"):
            raise AssertionError(f"{name}: no launch on the 512-px path")

    rs = np.random.RandomState(SEED + 15)
    imgs = torch.from_numpy(rs.randint(0, 256, (B, HIGHRES, HIGHRES, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.zeros(B, cfg.max_seq_len - cfg.max_seq_a_len,
                     dtype=torch.long, device=dev)
    sl = torch.full((B,), cfg.max_seq_a_len, device=dev)
    fcfg = cfg.replace(token_filter_keep=0.5)
    with _engine(fused=True):
        ops.reset_counts()
        res = TD.generate(model, imgs, od, None, sl, fcfg, _opts(fcfg))
        torch.cuda.synchronize()
        got = dict(ops.launch_counts(), **ops.mode_counts())
        want = {**FUSED_PER_BATCH, **{k: 0 for k in ops.mode_counts()},
                **FILTERED_LONG}
        log(f"[highres] token_filter_keep=0.5 batch launches {got}")
        if got != want:
            raise AssertionError(f"filtered batch launches {got} != {want}")
        if res["ids"].shape != (B, 1, cfg.max_gen_length) or not bool(
                (res["ids"][:, 0, 0] == cfg.cls_token_id).all()):
            raise AssertionError("filtered batch: bad ids")
        enc = TM.encode_images(model, imgs, fcfg)
        if enc["visual"].shape != (B, 513, cfg.hidden_size):
            raise AssertionError(f"filtered visual {enc['visual'].shape}")
        out["filtered_launches"] = got
        opts = _opts(cfg)
        out["encode_ms"] = _median_ms(lambda: TM.encode_images(model, imgs,
                                                               cfg))
        out["filtered_encode_ms"] = _median_ms(
            lambda: TM.encode_images(model, imgs, fcfg))
        prefill = _median_ms(lambda: TD.build_decode_context(
            model, imgs, od, None, sl, cfg, opts))
        log(f"[profile] 512 px: encode {out['encode_ms']:.3f} ms "
            f"(filtered 0.5: {out['filtered_encode_ms']:.3f} ms), encode + "
            f"prefill {prefill:.3f} ms")
        out["profile_fused"] = _profile_batch(
            "greedy_fused_512", lambda: TD.generate(model, imgs, od, None,
                                                    sl, cfg, opts), prefill)
    log(f"[highres] 512 px greedy captions/s: eager "
        f"{out['greedy_eager']['captions_per_s']:.2f}, fused "
        f"{out['greedy_fused']['captions_per_s']:.2f} (B={B}, bf16) on "
        f"{smi}")
    del model
    torch.cuda.empty_cache()
    return counts, out


def phase_highres_parity(dev):
    """f32, B=2, the full flagship built for 384 px on 512x512 images, card
    vs CPU: tag logits within 1e-3 relative and greedy ids equal on both
    engines, with 18 long attention launches on the card."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    cfg = ModelConfig()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rs = np.random.RandomState(SEED + 16)
    imgs = torch.from_numpy(rs.randint(0, 256, (2, HIGHRES, HIGHRES, 3))
                            .astype(np.uint8))
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    opts = _opts(cfg)

    def run(model, d):
        return TD.generate(model, imgs.to(d),
                           torch.zeros(2, od_len, dtype=torch.long, device=d),
                           None, torch.tensor([cfg.max_seq_a_len + 3,
                                               cfg.max_seq_a_len + 40],
                                              device=d), cfg, opts)
    out = {}
    for name, fused in (("eager", False), ("fused", True)):
        with _engine(fused):
            ref = run(cpu_model, "cpu")
            ops.reset_counts()
            got = run(gpu_model, dev)
            torch.cuda.synchronize()
        n_long = ops.mode_counts()["attention[long]"]
        a, b = got["tag_logits"].float().cpu(), ref["tag_logits"].float()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = torch.equal(got["ids"].cpu(), ref["ids"])
        log(f"[highres-parity] {name:5s} tag_logits max rel err {rel:.3e}; "
            f"greedy ids GPU == CPU: {same} ({ref['ids'].numel()} ids); "
            f"long attention launches {n_long}")
        if not (torch.isfinite(a).all() and rel <= 1e-3):
            raise AssertionError(f"highres parity {name}: rel {rel:.3e}")
        if not same:
            raise AssertionError(f"highres parity {name}: ids differ")
        if n_long != LONG["attention[long]"]:
            raise AssertionError(f"highres parity {name}: {n_long} long "
                                 f"attention launches, not {LONG}")
        out[name] = {"tag_logits_rel": rel, "ids_equal": same}
    return out


# ---------------------------------------------------------------------------
# phase 10: 512-px training (K8 on separate q, k, v past 1024 tokens)
# ---------------------------------------------------------------------------

def phase_train512_kernels(dev, rows):
    """The attention and attention_bwd kernels as the 512-px train step
    calls them through flash_attention_packed, B=64 bf16 and F32_B f32: ViT
    (chunk views of one (B, 1152, 2304) qkv tensor, l_actual 1025, no
    bias, rate 0) and BERT (separate contiguous q, k, v (B, 1104, 768), the
    decoder's (B, 1, 1104, 1104) f32 bias, rate 0.1, l_actual 1096).  The
    check against the plain versions runs on the first 16 images (their
    (16, 12, Lp, Lp) f32 scores and the backward's half-dozen of them fit
    beside the B=64 inputs; the keep bits of those images are the same at
    any B); the plain time is that of the same B=64 work in four calls of
    16 images.  Yardsticks: SDPA with the float mask (and dropout_p), and
    its backward on a retained graph."""
    from vitcap_tpu_torch.ops.attention import (attention_qkv,
                                                attention_qkv_plain)
    from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd_qkv,
                                                    attention_bwd_qkv_plain)
    g = torch.Generator().manual_seed(SEED + 17)
    H, nh, hd, Bc = 768, 12, 64, 16
    first = len(rows)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def chunks(q, k, v, *rest):
        return [(q[c:c + Bc], k[c:c + Bc], v[c:c + Bc],
                 *(t[c:c + Bc] if t is not None else None for t in rest))
                for c in range(0, q.shape[0], Bc)]

    for dtype, Bd in ((torch.bfloat16, B), (torch.float32, F32_B)):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        for case, L, Lp, with_bias, rate in (("vit 1152", 1025, 1152, False,
                                              0.0),
                                             ("bert 1104", 1096, 1104, True,
                                              0.1)):
            if with_bias:
                q, k, v = (rnd(Bd, Lp, H, dtype=dtype) for _ in range(3))
                bias = _bert_train_bias(Bd, L, Lp, dev)
            else:
                q, k, v = rnd(Bd, Lp, 3 * H, dtype=dtype).chunk(3, dim=-1)
                bias = None
            up = rnd(Bd, Lp, H, dtype=dtype)
            up[:, L:] = 0.0
            seed = 4343
            out = attention_qkv(q, k, v, nh, L, bias, rate, seed)
            (q16, k16, v16, b16, up16), = chunks(q, k, v, bias, up)[:1]
            ref = attention_qkv_plain(q16, k16, v16, nh, L, b16, rate, seed)
            err = compare(f"attention[non_slab] {case} {dn}", out[:Bc], ref,
                          dtype)
            eq = _bits(f"attention[non_slab] {case}", out[:Bc], ref)
            del out, ref
            ms = cuda_ms(lambda i: attention_qkv(q, k, v, nh, L, bias, rate,
                                                 seed), 5)
            pms = cuda_ms(lambda i: [attention_qkv_plain(
                qc, kc, vc, nh, L, bc, rate, seed)
                for qc, kc, vc, bc in chunks(q, k, v, bias)], 2)
            mask = torch.zeros(Bd, 1, Lp, Lp, device=dev, dtype=dtype)
            mask[..., L:] = float("-inf")
            if bias is not None:
                mask = mask + bias.to(dtype)
            heads = [t.unflatten(-1, (nh, hd)).transpose(1, 2)
                     for t in (q, k, v)]
            lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                *heads, attn_mask=mask, dropout_p=rate), 5)
            _row(rows, "attention[non_slab]", case, dn,
                 f"B={Bd} L={L} Lp={Lp} heads=12x64 rate={rate} "
                 f"bias={with_bias}", err, ms, pms, lms,
                 4.0 * Bd * nh * Lp * L * hd,
                 es * Bd * Lp * 4 * H + (4 * Bd * Lp * Lp if with_bias
                                         else 0))
            rows[-1]["bit_equal"] = eq

            got = attention_bwd_qkv(q, k, v, up, nh, L, bias, rate, seed)
            want = attention_bwd_qkv_plain(q16, k16, v16, up16, nh, L, b16,
                                           rate, seed)
            err, eqs = 0.0, []
            for part, o, r in zip("qkv", got, want):
                name = f"attention_bwd[non_slab] {case} d{part} {dn}"
                err = max(err, compare(name, o[:Bc], r, dtype))
                eqs.append(_bits(name, o[:Bc], r))
            del got, want
            ms = cuda_ms(lambda i: attention_bwd_qkv(q, k, v, up, nh, L, bias,
                                                     rate, seed), 3)
            pms = cuda_ms(lambda i: [attention_bwd_qkv_plain(
                qc, kc, vc, uc, nh, L, bc, rate, seed)
                for qc, kc, vc, bc, uc in chunks(q, k, v, bias, up)], 2)
            leaves = [t.detach().contiguous().requires_grad_(True)
                      for t in heads]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                               dropout_p=rate)
            go = up.view(Bd, Lp, nh, hd).transpose(1, 2)
            lms = cuda_ms(lambda i: torch.autograd.grad(
                o, leaves, go, retain_graph=True), 3)
            _row(rows, "attention_bwd[non_slab]", case, dn,
                 f"B={Bd} L={L} Lp={Lp} heads=12x64 rate={rate} "
                 f"bias={with_bias}", err, ms, pms, lms,
                 10.0 * Bd * nh * Lp * L * hd,
                 es * Bd * Lp * 7 * H + (4 * Bd * Lp * Lp if with_bias
                                         else 0))
            rows[-1]["bit_equal"] = eqs[0] and min(eqs)
            del q, k, v, up, bias, mask, heads, leaves, o, go
            del q16, k16, v16, b16, up16
            torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[train512-kernel] {r['kernel']:24s} {r['case']:10s} "
            f"{r['dtype']:4s} err {r['max_abs_err']:.3e}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" + (f"  bit-equal {r['bit_equal']:.5f}"
                                    if r.get("bit_equal") else ""))


def phase_train512(dev, smi, rows):
    """Phase 10: the kernels at the 512-px train shapes, the flagship train
    step at 512 px (counts set to 0 just before its timed steps), GPU vs
    CPU in f32 at 512 px, the profile of one step.  Returns the timed run's
    counts and the results."""
    phase_train512_kernels(dev, rows)
    counts, out, run = phase_train_step(
        dev, smi, img=HIGHRES, per_step_want=TRAIN_512_PER_STEP,
        modes_want=TRAIN_512_MODES_PER_STEP, steps=6, tag="train512")
    for name in ("attention", "attention_bwd", "attention[non_slab]",
                 "attention_bwd[non_slab]"):
        if counts[name] == 0:
            raise AssertionError(f"{name}: no launch on the 512-px train "
                                 f"path")
    out["profile"] = phase_train_profile(run, "train_step_512")
    del run
    torch.cuda.empty_cache()
    # 4 + 1 ViT blocks (the CLS-only tag block is plain) and 2 decoder
    # layers, all past 1024 padded tokens
    out["parity"] = phase_train_parity(
        dev, img=HIGHRES, tag="train512",
        attention_want={"attention": 7, "attention[non_slab]": 7,
                        "attention[long]": 7, "attention[dropout]": 2,
                        "attention_bwd": 14, "attention_bwd[non_slab]": 14,
                        "gemm": 0, "layer_norm": 0})
    return counts, out


# ---------------------------------------------------------------------------
# phase 11: K9 on mha's inference route, K11 and K12
# ---------------------------------------------------------------------------

# (L, bias): K9 at the trunk length (one-pass; no bias, the head-broadcast
# (B, 1, L, L) one and a per-head (B, 12, L, L) one) and past 1024 (the
# online mode)
K9_CASES = [(577, None), (577, "bcast"), (577, "head"), (1025, None),
            (1025, "head")]
K9_HEADS = {None: 0, "bcast": 1, "head": 12}
BC = 16                      # images of phase 11's backward and path checks


def _bits(name, out, ref):
    """bf16: the share of values bit-equal to the plain version, at least
    0.99 (the kernels round where the plain versions round)."""
    if out.dtype != torch.bfloat16:
        return None
    eq = (out == ref).float().mean().item()
    if eq < 0.99:
        raise AssertionError(f"{name}: only {eq:.4f} bit-equal")
    return eq


def _k9_bias(Bn, heads, L, dev, gd):
    """An additive f32 (Bn, heads, L, L) bias, made on the card: -10000 on
    about a fifth of the keys, N(0, 0.5) elsewhere, key 0 always seen."""
    b = torch.where(torch.rand(Bn, heads, L, L, device=dev, generator=gd)
                    > 0.2, 0.0, -10000.0)
    b += 0.5 * torch.randn(Bn, heads, L, L, device=dev, generator=gd)
    b[..., 0] = 0.0
    return b


def phase_flash_kernels(dev, rows):
    """K9's kernels as flash_attention calls them, B=64, 12 heads of 64,
    bf16 and f32, on the per-head views of (B, L, 768) tensors that mha
    passes: the forward (K9_CASES; the online mode at 1025) and, at 577,
    the attention_bwd pair (attention_bwd_heads) vs their plain versions,
    with bounds and SDPA yardsticks (the float mask; the backward on a
    retained graph).  Past 1024 the backward is autograd through the f32
    attention (no kernel; the plain version is the same code): timed, with
    the bias taking no gradient."""
    from vitcap_tpu_torch.ops.attention import heads_view
    from vitcap_tpu_torch.ops.attention_bwd import (
        attention_bwd_heads, attention_bwd_heads_plain)
    from vitcap_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_plain)
    gd = torch.Generator(device=dev).manual_seed(SEED + 21)
    H, nh, hd = 768, 12, 64
    first = len(rows)

    def per_head(dtype, L):
        return heads_view(torch.randn(B, L, H, device=dev, generator=gd)
                          .to(dtype), nh)

    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        for L, kind in K9_CASES:
            heads = K9_HEADS[kind]
            kname = "attention[online]" if L > 1024 else "attention[heads]"
            case = f"{L} {kind or 'none'}"
            q, k, v = (per_head(dtype, L=L) for _ in range(3))
            bias = _k9_bias(B, heads, L, dev, gd) if heads else None
            mask = None if bias is None else bias.to(dtype)
            with torch.no_grad():
                out = flash_attention(q, k, v, bias)
                ref = flash_attention_plain(q, k, v, bias)
                err = compare(f"{kname} {case} {dn}", out, ref, dtype)
                eq = _bits(f"{kname} {case}", out, ref)
                del out, ref
                ms = cuda_ms(lambda i: flash_attention(q, k, v, bias), 5)
                pms = cuda_ms(lambda i: flash_attention_plain(q, k, v, bias),
                              2)
                lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), 5)
            _row(rows, kname, case, dn, f"B={B} L={L} heads=12x64 "
                 f"bias={kind}", err, ms, pms, lms, 4.0 * B * nh * L * L * hd,
                 es * B * L * 4 * H + 4 * B * heads * L * L)
            rows[-1]["bit_equal"] = eq
            up = per_head(dtype, L=L)
            if L <= 1024:
                got = attention_bwd_heads(q, k, v, up, bias)
                want = attention_bwd_heads_plain(q, k, v, up, L, bias)
                err, eqs = 0.0, []
                for part, o, r in zip("qkv", got, want):
                    name = f"attention_bwd[heads] {case} d{part} {dn}"
                    err = max(err, compare(name, o, r, dtype))
                    eqs.append(_bits(name, o, r))
                del got, want
                ms = cuda_ms(lambda i: attention_bwd_heads(q, k, v, up,
                                                           bias), 3)
                pms = cuda_ms(lambda i: attention_bwd_heads_plain(
                    q, k, v, up, L, bias), 2)
                bname = "attention_bwd[heads]"
            else:
                # autograd through the f32 attention, on the kernel's route
                # and the plain one (the same code past 1024)
                timed = []
                for fn in (flash_attention, flash_attention_plain):
                    leaves = [t.detach().requires_grad_(True)
                              for t in (q, k, v)]
                    o = fn(*leaves, bias)
                    timed.append(cuda_ms(lambda i: torch.autograd.grad(
                        o, leaves, up, retain_graph=True), 2))
                    del o, leaves
                ms, pms = timed
                err, eqs = 0.0, [None]
                bname = "flash_attention bwd[f32]"
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lms = cuda_ms(lambda i: torch.autograd.grad(
                o, leaves, up, retain_graph=True), 3)
            _row(rows, bname, case, dn, f"B={B} L={L} heads=12x64 "
                 f"bias={kind}", err, ms, pms, lms,
                 10.0 * B * nh * L * L * hd,
                 es * B * L * 7 * H + 4 * B * heads * L * L)
            rows[-1]["bit_equal"] = eqs[0] and min(eqs)
            del q, k, v, up, bias, mask, leaves, o
            torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[flash-kernel] {r['kernel']:24s} {r['case']:10s} "
            f"{r['dtype']:4s} err {r['max_abs_err']:.3e}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" + (f"  bit-equal {r['bit_equal']:.5f}"
                                    if r.get("bit_equal") else ""))


def _vit_attn_weights(blk):
    return (blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight,
            blk.attn.qkv.bias, blk.attn.proj.weight, blk.attn.proj.bias)


def _tail_weights(blk):
    return (blk.attn.proj.weight, blk.attn.proj.bias, blk.norm2.weight,
            blk.norm2.bias, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
            blk.mlp.fc2.weight, blk.mlp.fc2.bias)


def phase_fused_attn_kernels(dev, rows):
    """K11 (fused_vit_attn: LN1, the qkv gemm, attention, the proj gemm
    with the residual) at L 577 and 1025 and K12 (tail_train) at L 577,
    B=64, bf16 and f32, vs their plain versions, beside their bounds (no
    single PyTorch call computes either: no yardstick).  K11's backward
    (the plain chain recomputed under autograd, its attention the packed
    route) on the first BC images vs the same chain on the plain
    attention: timed, gradients within the tolerance."""
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.ops.fused_block import (fused_vit_attn_plain,
                                                  tail_train,
                                                  tail_train_plain,
                                                  vit_attention_residual)
    torch.manual_seed(SEED + 22)
    H, nh, hd, I = 768, 12, 64, 3072
    blk = TL.ViTBlock(H, I, device=dev).requires_grad_(False)
    gd = torch.Generator(device=dev).manual_seed(SEED + 23)
    w_attn, w_tail = _vit_attn_weights(blk), _tail_weights(blk)
    first = len(rows)
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        for L in (577, 1025):
            M = B * L
            x = torch.randn(B, L, H, device=dev, generator=gd).to(dtype)
            with torch.no_grad():
                out = vit_attention_residual(blk, x, nh, 1e-6)
                ref = fused_vit_attn_plain(x, *w_attn, nh, 1e-6)
                err = compare(f"fused_vit_attn {L} {dn}", out, ref, dtype)
                eq = _bits(f"fused_vit_attn {L}", out, ref)
                del out, ref
                ms = cuda_ms(lambda i: vit_attention_residual(blk, x, nh,
                                                              1e-6), 5)
                pms = cuda_ms(lambda i: fused_vit_attn_plain(
                    x, *w_attn, nh, 1e-6), 2)
            _row(rows, "fused_vit_attn", str(L), dn,
                 f"B={B} L={L} H={H} heads=12x64", err, ms, pms, None,
                 2.0 * M * H * 4 * H + 4.0 * B * nh * L * L * hd,
                 es * (2 * M * H + 4 * H * H) + 4 * 8 * H)
            rows[-1]["bit_equal"] = eq
            # the backward on BC images: the kernels' route vs all plain
            xs = x[:BC].clone()
            up = torch.randn(BC, L, H, device=dev, generator=gd).to(dtype)
            res, timed = [], []
            for plain in (False, True):
                blk.requires_grad_(True)
                xt = xs.clone().requires_grad_(True)
                ctx = _plain_attention() if plain else contextlib.nullcontext()
                with ctx:
                    o = (fused_vit_attn_plain(xt, *w_attn, nh, 1e-6) if plain
                         else vit_attention_residual(blk, xt, nh, 1e-6))
                    leaves = [xt, blk.attn.qkv.weight, blk.attn.proj.weight]
                    res.append(torch.autograd.grad(o, leaves, up,
                                                   retain_graph=True))
                    timed.append(cuda_ms(lambda i: torch.autograd.grad(
                        o, leaves, up, retain_graph=True), 2))
                blk.requires_grad_(False)
                del o, xt, leaves
            err = max(compare(f"fused_vit_attn bwd {L} {n} {dn}", a, b,
                              dtype)
                      for n, a, b in zip(("dx", "dWqkv", "dWproj"), *res))
            _row(rows, "fused_vit_attn[bwd]", str(L), dn,
                 f"B={BC} L={L} H={H} heads=12x64", err, timed[0],
                 timed[1], None,
                 2.0 * (2.0 * BC * L * H * 4 * H) + 10.0 * BC * nh * L * L
                 * hd, es * (4 * BC * L * H + 4 * H * H))
            del x, xs, up, res
            torch.cuda.empty_cache()
        L, M = 577, B * 577
        x, attn = (torch.randn(B, L, H, device=dev, generator=gd).to(dtype)
                   for _ in range(2))
        with torch.no_grad():
            got = tail_train(x, attn, *w_tail, 1e-6)
            want = tail_train_plain(x, attn, *w_tail, 1e-6)
            err = 0.0
            for part, o, r in zip(("out", "y1", "pre1"), got, want):
                err = max(err, compare(f"tail_train {part} {dn}", o, r,
                                       dtype))
                _bits(f"tail_train {part}", o, r)
            del got, want
            ms = cuda_ms(lambda i: tail_train(x, attn, *w_tail, 1e-6), 5)
            pms = cuda_ms(lambda i: tail_train_plain(x, attn, *w_tail, 1e-6),
                          2)
        _row(rows, "tail_train", str(L), dn, f"B={B} L={L} H={H} I={I}",
             err, ms, pms, None, 2.0 * M * (H * H + 2 * H * I),
             es * (4 * M * H + M * I + H * H + 2 * H * I) + 4 * (5 * H + I))
        del x, attn
        torch.cuda.empty_cache()
    for r in rows[first:]:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"[fused-attn] {r['kernel']:20s} {r['case']:5s} {r['dtype']:4s} "
            f"err {r['max_abs_err']:.3e}  kernels {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def _all_counts():
    from vitcap_tpu_torch import ops
    return dict(ops.launch_counts(), **ops.mode_counts(),
                **ops.call_counts())


def phase_flash_path(dev):
    """The K9, K11 and K12 entry points as a user reaches them, at the
    flagship width (768, 12 heads of 64), BC images of bf16: a no-grad
    vit_block with a (B, 1, L, L) bias and a no-grad bert_layer without
    one (mha's inference route at 577), a no-grad vit_block with a
    per-head bias at 1025 (the online mode), flash_attention forward and
    backward at 577 with a per-head bias that requires grad (its gradient
    zero, as in the TPU package), vit_attention_residual forward and
    backward, tail_train.  Counts set to 0 just before, read just after;
    each call must launch exactly its kernels.  Returns the counts."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.ops.attention import heads_view
    from vitcap_tpu_torch.ops.flash_attention import flash_attention
    from vitcap_tpu_torch.ops.fused_block import (tail_train,
                                                  vit_attention_residual)
    cfg = ModelConfig(num_hidden_layers=1, split_blocks=1, decoder_layers=1)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    blk, layer = model.bert.encoder.blocks[0], model.bert.decoder.layer[0]
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    gd = torch.Generator(device=dev).manual_seed(SEED + 24)
    dt = torch.bfloat16

    def rnd(L):
        return torch.randn(BC, L, H, device=dev, generator=gd).to(dt)
    x577, x1025 = rnd(577), rnd(1025)
    bcast = _k9_bias(BC, 1, 577, dev, gd)
    head1025 = _k9_bias(BC, nh, 1025, dev, gd)
    head577 = _k9_bias(BC, nh, 577, dev, gd).requires_grad_(True)
    qkv = [heads_view(rnd(577), nh).detach().requires_grad_(True)
           for _ in range(3)]
    up = heads_view(rnd(577), nh)

    def flash_fwd_bwd():
        flash_attention(*qkv, head577).backward(up)
        if head577.grad is None or head577.grad.any():
            raise AssertionError("flash_attention at 577: the bias "
                                 "gradient must be zeros")

    def k11_fwd_bwd():
        xt = x577.clone().requires_grad_(True)
        vit_attention_residual(blk, xt, nh, 1e-6).backward(x577)

    k9 = {"attention": 1, "attention[heads]": 1}
    calls = [
        ("vit_block, no grad, (B, 1, L, L) bias, L 577",
         lambda: TL.vit_block(blk, x577, nh, 1e-6, bcast), True, k9),
        ("bert_layer, no grad, no bias, L 577",
         lambda: TL.bert_layer(layer, x577, None, nh, 1e-12), True, k9),
        ("vit_block, no grad, per-head bias, L 1025",
         lambda: TL.vit_block(blk, x1025, nh, 1e-6, head1025), True,
         dict(k9, **{"attention[online]": 1, "attention[long]": 1})),
        ("flash_attention forward + backward, per-head bias, L 577",
         flash_fwd_bwd, False,
         dict(k9, **{"attention_bwd": 2, "attention_bwd[heads]": 2})),
        ("vit_attention_residual forward + backward, L 577", k11_fwd_bwd,
         False, {"layer_norm": 1, "gemm": 2, "attention": 2,
                 "attention[non_slab]": 1, "attention_bwd": 2,
                 "attention_bwd[non_slab]": 2, "fused_vit_attn": 1}),
        ("tail_train, L 577",
         lambda: tail_train(x577, rnd(577), *_tail_weights(blk), 1e-6), True,
         {"gemm": 3, "gemm[pre_out]": 1, "layer_norm": 1, "tail_train": 1}),
    ]
    torch.cuda.synchronize()
    ops.reset_counts()
    for name, fn, no_grad, want in calls:
        before = _all_counts()
        with torch.no_grad() if no_grad else contextlib.nullcontext():
            fn()
        torch.cuda.synchronize()
        after = _all_counts()
        d = {k: after[k] - before[k] for k in after}
        want = {k: want.get(k, 0) for k in d}
        if d != want:
            raise AssertionError(f"{name}: launches {d} != {want}")
        log(f"[flash-path] {name}: "
            f"{ {k: n for k, n in d.items() if n} }")
    counts = _all_counts()
    del model, blk, layer, x577, x1025, bcast, head1025, head577, qkv, up
    torch.cuda.empty_cache()
    return counts


def phase_flash_parity(dev):
    """K9 and K11 on the card vs the CPU (their plain versions) in f32 at
    the flagship width, 2 images: flash_attention at L 577 with a
    per-head bias and at 1025 with a (B, 1, L, L) one, forward and the q,
    k, v gradients; vit_attention_residual at L 577 and 1025, forward and
    the x, Wqkv and Wproj gradients.  Each within F32_TOL of its scale."""
    from vitcap_tpu_torch.models import layers as TL
    from vitcap_tpu_torch.ops.flash_attention import flash_attention
    from vitcap_tpu_torch.ops.fused_block import vit_attention_residual
    g = torch.Generator().manual_seed(SEED + 25)
    worst = 0.0
    for L, heads in ((577, 12), (1025, 1)):
        qkv = [torch.randn(2, 12, L, 64, generator=g) for _ in range(3)]
        bias = torch.where(torch.rand(2, heads, L, L, generator=g) > 0.2,
                           0.0, -10000.0)
        up = torch.randn(2, 12, L, 64, generator=g)
        res = []
        for d in (dev, "cpu"):
            leaves = [t.to(d).requires_grad_(True) for t in qkv]
            o = flash_attention(*leaves, bias.to(d))
            o.backward(up.to(d))
            res.append([o.detach().cpu()] + [t.grad.cpu() for t in leaves])
        for n, a, b in zip(("out", "dq", "dk", "dv"), *res):
            worst = max(worst, compare(f"flash_attention GPU vs CPU {L} {n}",
                                       a, b, torch.float32))
    torch.manual_seed(SEED + 26)
    cpu_blk = TL.ViTBlock(768, 3072)
    gpu_blk = copy.deepcopy(cpu_blk).to(dev)
    for L in (577, 1025):
        x = torch.randn(2, L, 768, generator=g)
        up = torch.randn(2, L, 768, generator=g)
        res = []
        for blk, d in ((gpu_blk, dev), (cpu_blk, "cpu")):
            blk.zero_grad(set_to_none=True)
            xt = x.to(d).requires_grad_(True)
            o = vit_attention_residual(blk, xt, 12, 1e-6)
            o.backward(up.to(d))
            res.append([o.detach().cpu(), xt.grad.cpu(),
                        blk.attn.qkv.weight.grad.cpu(),
                        blk.attn.proj.weight.grad.cpu()])
        for n, a, b in zip(("out", "dx", "dWqkv", "dWproj"), *res):
            scale = max(b.abs().max().item(), 1e-30)
            e = (a - b).abs().max().item() / scale
            worst = max(worst, e)
            if not e <= F32_TOL:
                raise AssertionError(f"fused_vit_attn GPU vs CPU {L} {n}: "
                                     f"{e:.3e} of scale")
    log(f"[flash-parity] K9 and K11, f32, GPU vs CPU: worst {worst:.3e}")
    return {"worst": worst}


def phase_flash(dev, rows):
    """Phase 11: the kernels, the path with exact counts, GPU vs CPU."""
    phase_flash_kernels(dev, rows)
    phase_fused_attn_kernels(dev, rows)
    counts = phase_flash_path(dev)
    return counts, phase_flash_parity(dev)



# ---------------------------------------------------------------------------
# phase 3: decode_attention past the main path's contexts, and small calls
# ---------------------------------------------------------------------------

LONG_DECODE_CASES = [(64, 4, 2000), (128, 1, 2000)]   # (hd, nb, S)


def phase_decode_attention_long(dev, rows):
    """bf16 decode_attention at S = 2000 context keys on the cluster
    kernel, hd 64 with 4 beams and hd 128 with 1 (H = 768), B=64, A=20,
    t=10: at least 99% of outputs bit-equal to the plain version; times
    back to back and from a CUDA graph, with the bound and the SDPA
    yardstick."""
    from vitcap_tpu_torch.ops.decode_step import (decode_attention,
                                                  decode_attention_plain,
                                                  plan)
    g = torch.Generator().manual_seed(SEED + 6)
    A, t, H, es = 20, 10, 768, 2
    t_dev = torch.tensor([t], dtype=torch.int32, device=dev)
    for hd, nb, S in LONG_DECODE_CASES:
        nh = H // hd
        d = _decode_attention_inputs(dev, torch.bfloat16, nb, t, S, A, H, g)
        Bb = B * nb
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        args = (d["ctx_k"], d["ctx_v"], d["bias"])
        out = decode_attention(d["qkv"], *caps, *args, t_dev, nh)
        ref = decode_attention_plain(d["qkv"], d["cap_k"], d["cap_v"], *args,
                                     t, nh)
        case = f"long hd{hd} nb{nb}"
        err = compare(f"decode_attention {case}", out, ref, torch.bfloat16)
        eq = (out == ref).float().mean().item()
        ranks = plan(S, nb, hd, A).ranks
        if not ranks or eq < 0.99:
            raise AssertionError(f"decode_attention {case}: ranks {ranks}, "
                                 f"{eq:.5f} of outputs bit-equal")
        sdpa = _sdpa_decode_inputs(d, t, nh)
        ms = cuda_ms(lambda i: decode_attention(d["qkv"], *caps, *args,
                                                t_dev, nh), 20)
        gms = graph_ms(lambda: decode_attention(d["qkv"], *caps, *args,
                                                t_dev, nh), 20)
        pms = cuda_ms(lambda i: decode_attention_plain(
            d["qkv"], *caps, *args, t, nh), 3)
        lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            *sdpa[:3], attn_mask=sdpa[3]), 20)
        nbytes = (es * (2 * B * S * H + 2 * Bb * (t - 1) * H
                        + Bb * 2 * 3 * H + 2 * Bb * H + Bb * 2 * H)
                  + 4 * B * S)
        flops = 4.0 * Bb * 2 * (S + t) * H
        _row(rows, "decode_attention", case, "bf16",
             f"B={B} nb={nb} S={S} A={A} t={t} heads={nh}x{hd}", err, ms,
             pms, lms, flops, nbytes)
        r = rows[-1]
        r.update(bit_equal=eq, graph_ms=gms, ranks=ranks)
        log(f"[decode_attention] {case} S={S} bf16 err {err:.3e}  bit-equal "
            f"{eq:.6f}  ranks {ranks}  kernel {ms:.4f} ms (graph "
            f"{gms:.4f})  plain {pms:.4f} ms  SDPA {lms:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        del d, caps, sdpa, out, ref
        torch.cuda.empty_cache()


SWEEP_CASES = [(64, 3, 628), (128, 3, 628), (64, 1, 1076), (64, 8, 1076),
               (64, 4, 2000), (128, 1, 2000), (64, 3, 3000)]


def phase_decode_attention_sweep(dev, seeds=8):
    """bf16 decode_attention's bit-equal share over many small calls: the
    card test's geometry (3 images, 2 heads, A=6), `seeds` input seeds and
    t in 1, 4, 6 per case, the min and mean share printed; every call at
    least 99% bit-equal to the plain version (F9: a call of 3 images has
    6-48 (head, row) pairs, and one row whose largest probabilities round
    otherwise would move its share by 1-2%, so the kernel's scores and
    exponential are the plain version's, operation for operation)."""
    from vitcap_tpu_torch.ops.decode_step import (decode_attention,
                                                  decode_attention_plain,
                                                  plan)
    Bs, nh, A = 3, 2, 6
    out = {}
    for hd, nb, S in SWEEP_CASES:
        H = nh * hd
        p = plan(S, nb, hd, A)
        shares = []
        for seed in range(seeds):
            for t in (1, 4, A):
                g = torch.Generator().manual_seed(1000 * seed + t)

                def rnd(*shape):
                    return torch.randn(*shape, generator=g).to(
                        dev, torch.bfloat16)
                ctx_k, ctx_v = rnd(Bs, S, H), rnd(Bs, S, H)
                cap_k, cap_v = rnd(Bs * nb, A, H), rnd(Bs * nb, A, H)
                valid = torch.rand(Bs, S, generator=g) > 0.3
                valid[:, -1] = True
                bias = torch.where(valid, 0.0, -10000.0).float().to(dev)
                qkv = rnd(Bs * nb, 2, 3 * H)
                ref = decode_attention_plain(qkv, cap_k.clone(),
                                             cap_v.clone(), ctx_k, ctx_v,
                                             bias, t, nh)
                o = decode_attention(qkv, cap_k, cap_v, ctx_k, ctx_v, bias,
                                     torch.tensor([t], dtype=torch.int32,
                                                  device=dev), nh)
                shares.append((o == ref).float().mean().item())
        key = f"hd{hd} nb{nb} S{S}"
        out[key] = {"ranks": p.ranks, "min": min(shares),
                    "mean": sum(shares) / len(shares), "calls": len(shares)}
        log(f"[decode_attention] sweep {key} ({p.ranks} ranks): bit-equal "
            f"min {min(shares):.5f} mean {out[key]['mean']:.5f} over "
            f"{len(shares)} calls")
        if not p.ranks or min(shares) < 0.99:
            raise AssertionError(f"decode_attention sweep {key}: ranks "
                                 f"{p.ranks}, a call {min(shares):.5f} "
                                 f"bit-equal")
    return out


# ---------------------------------------------------------------------------
# phase 12: checkpointing
# ---------------------------------------------------------------------------

CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def _copy_state(state):
    """A TrainState that shares nothing with `state`."""
    from vitcap_tpu_torch.solver.optimization import AdamWState
    from vitcap_tpu_torch.solver.train_step import TrainState
    gen = None
    if state.generator is not None:
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
    opt = state.opt
    return TrainState(copy.deepcopy(state.model),
                      AdamWState(opt.step,
                                 {n: t.clone() for n, t in opt.mu.items()},
                                 {n: t.clone() for n, t in opt.nu.items()}),
                      gen)


def _state_diff(a, b):
    """(max abs difference over parameters and both moments, the names
    that differ)."""
    worst, names = 0.0, []
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for n in pa:
        for x, y in ((pa[n], pb[n]), (a.opt.mu[n], b.opt.mu[n]),
                     (a.opt.nu[n], b.opt.nu[n])):
            e = (x.float() - y.float()).abs().max().item()
            if e:
                names.append(n)
            worst = max(worst, e)
    return worst, sorted(set(names))


def phase_checkpoint(dev, smi, Bn=B, cfg_kw=None):
    """The flagship at 384 px with the bench training line (B=64, bf16,
    attention dropout 0.1): 2 steps; save; load into a fresh model,
    optimizer state and generator on the card; one step from the
    resumed state, one from the continued state and one from a copy of
    it.  The resumed step must match the continued one as closely as the
    two continued steps match each other.  Then a synthetic
    reference-named `.pt` through Checkpointer.recover_or_load: every
    parameter matched, nothing missing.  The msgpack and orbax halves
    (_msgpack_roundtrip, _orbax_roundtrip) save the same state in the JAX
    package's two formats, and their resumed steps pass the same check.
    Prints the save and load ms and the snapshot's bytes."""
    import shutil
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.solver import checkpointing as CK
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state,
                                                    make_train_step)
    from vitcap_tpu_torch import native
    # the orbax half's zstd library builds with g++ while the steps run
    zstd_build = threading.Thread(target=native.library, args=("zstd",))
    zstd_build.start()
    cfg = ModelConfig(**dict(dict(dtype="bfloat16", tag_loss_weight=1.0),
                             **(cfg_kw or {})))
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    state = init_train_state(model, torch.Generator().manual_seed(SEED + 9))
    step = make_train_step(cfg, TrainHyper(base_lr=1e-4, max_iter=1000))
    batch = _train_batch(cfg, Bn, SEED + 10, dev)
    # the orbax half's async Checkpointer reserves its pinned buffer while
    # the steps run, as a pipeline's recover_or_load does at its start
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ack = CK.Checkpointer(str(CKPT_DIR / "run_ob_async"), backend="orbax",
                          async_save=True)
    t0 = time.perf_counter()
    reserving = ack.reserve(model)
    for _ in range(2):
        state, _ = step(state, batch, False)
    torch.cuda.synchronize()
    if reserving is not None:
        reserving.join()
    log(f"[checkpoint] 2 train steps, the pinned buffer reserved beside "
        f"them: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    ck = CK.Checkpointer(str(CKPT_DIR / "run"))
    t0 = time.perf_counter()
    path = ck.save(2, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(path)
    fresh = init_params(cfg, torch.Generator().manual_seed(SEED + 77), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh, snap, it = ck.recover_or_load(None, fresh)
    resumed = CK.restore_train_state(snap, fresh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    if it != 2 or resumed.opt.step != 2:
        raise AssertionError(f"checkpoint: resumed at {it}, step "
                             f"{resumed.opt.step}")
    if next(resumed.model.parameters()).device != dev or any(
            t.device != dev for t in resumed.opt.mu.values()):
        raise AssertionError("checkpoint: the snapshot did not load on the "
                             "card")
    del snap
    mp = _msgpack_roundtrip(dev, smi, cfg, state, resumed)
    resumed_mp = mp.pop("state")
    shutil.rmtree(CKPT_DIR / "run_mp", ignore_errors=True)
    ob = _orbax_roundtrip(dev, smi, cfg, state, resumed, step, batch,
                          zstd_build, ack)
    resumed_ob = ob.pop("state")
    twin = _copy_state(state)
    out = {}
    for name, st in (("continued", state), ("twin", twin),
                     ("resumed", resumed), ("resumed_mp", resumed_mp),
                     ("resumed_ob", resumed_ob)):
        st, m = step(st, batch, False)
        out[name] = (st, m["loss"].item())
    torch.cuda.synchronize()
    twin_diff, twin_names = _state_diff(out["continued"][0], out["twin"][0])
    res_diff, res_names = _state_diff(out["continued"][0],
                                      out["resumed"][0])
    mp_diff, mp_names = _state_diff(out["continued"][0],
                                    out["resumed_mp"][0])
    ob_diff, ob_names = _state_diff(out["continued"][0],
                                    out["resumed_ob"][0])
    log(f"[checkpoint] step 3 losses: continued {out['continued'][1]:.6f} "
        f"twin {out['twin'][1]:.6f} resumed {out['resumed'][1]:.6f} "
        f"resumed from msgpack {out['resumed_mp'][1]:.6f} resumed from "
        f"orbax {out['resumed_ob'][1]:.6f}")
    log(f"[checkpoint] max |diff| after step 3 (parameters and moments): "
        f"continued vs twin {twin_diff:.3e} ({len(twin_names)} tensors), "
        f"continued vs resumed {res_diff:.3e} ({len(res_names)} tensors), "
        f"continued vs resumed from msgpack {mp_diff:.3e} "
        f"({len(mp_names)} tensors), continued vs resumed from orbax "
        f"{ob_diff:.3e} ({len(ob_names)} tensors)")
    if twin_names:
        log(f"[checkpoint] not bit-deterministic from one state: "
            f"{twin_names[:8]}")
    if not res_diff <= twin_diff:
        raise AssertionError(f"checkpoint: resumed differs by {res_diff:.3e}"
                             f", two continued runs by {twin_diff:.3e}")
    if not mp_diff <= twin_diff:
        raise AssertionError(f"checkpoint: resumed from msgpack differs by "
                             f"{mp_diff:.3e}, two continued runs by "
                             f"{twin_diff:.3e}")
    if not ob_diff <= twin_diff:
        raise AssertionError(f"checkpoint: resumed from orbax differs by "
                             f"{ob_diff:.3e}, two continued runs by "
                             f"{twin_diff:.3e}")
    # a reference-named .pt: 'module.' on everything but the image encoder
    src = out["continued"][0].model
    sd = {("" if n.startswith("image_encoder") else "module.") + n:
          t.detach().cpu() for n, t in src.state_dict().items()}
    pt = CKPT_DIR / "reference.pt"
    torch.save({"model": sd, "iteration": 3}, pt)
    del out, twin, resumed, resumed_mp, resumed_ob, state
    torch.cuda.empty_cache()
    base = CK.Checkpointer(str(CKPT_DIR / "fresh"))
    tgt = init_params(cfg, torch.Generator().manual_seed(SEED + 78), dev)
    t0 = time.perf_counter()
    tgt, snap, it = base.recover_or_load(str(pt), tgt)
    torch.cuda.synchronize()
    pt_ms = (time.perf_counter() - t0) * 1e3
    rep = base.load_report
    n_params = len(list(tgt.parameters()))
    same = all(torch.equal(p.detach().cpu(), sd[k]) for p, (_, k) in
               zip(tgt.parameters(), rep["matched"]))
    log(f"[checkpoint] reference .pt: {len(rep['matched'])} of {n_params} "
        f"matched, {len(rep['missing'])} missing, "
        f"{len(rep['shape_mismatch'])} shape-skipped, {len(rep['unused'])} "
        f"unused; weights equal: {same}")
    if (snap is not None or it != 0 or len(rep["matched"]) != n_params
            or rep["missing"] or rep["shape_mismatch"] or rep["unused"]
            or not same):
        raise AssertionError("checkpoint: reference .pt load report")
    log(f"[checkpoint] save {save_ms:.1f} ms, load + restore {load_ms:.1f} "
        f"ms, snapshot {nbytes} bytes ({nbytes / 2 ** 30:.3f} GiB: f32 "
        f"weights and both Adam moments); msgpack save "
        f"{mp['save_ms']:.1f} ms, load + restore {mp['load_ms']:.1f} ms, "
        f"{mp['bytes']} bytes; orbax save {ob['save_ms']:.1f} ms (async: "
        f"{ob['async_blocking_ms']:.1f} ms blocking), load + restore "
        f"{ob['load_ms']:.1f} ms, {ob['bytes']} bytes; .pt bridge load "
        f"{pt_ms:.1f} ms; B={Bn}, on {smi}")
    del tgt, src
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"save_ms": save_ms, "load_ms": load_ms, "pt_load_ms": pt_ms,
            "snapshot_bytes": nbytes, "twin_diff": twin_diff,
            "resumed_diff": res_diff, "nondeterministic": twin_names,
            "msgpack": dict(mp, resumed_diff=mp_diff),
            "orbax": dict(ob, resumed_diff=ob_diff)}


ORBAX_FIXTURE = ROOT / "tests" / "data" / "orbax_jax_tiny"
ZSTD_BENCH_BYTES = 1 << 30


def _tree_equal(a, b, path=""):
    """Whether two trees of tensors (dicts, lists) are the same, leaf by
    leaf, bit for bit (shape and dtype too); the first difference."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or a.keys() != b.keys():
            return path or "/"
        for k in b:
            bad = _tree_equal(a[k], b[k], f"{path}/{k}")
            if bad:
                return bad
        return None
    if isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            return path
        for i, (x, y) in enumerate(zip(a, b)):
            bad = _tree_equal(x, y, f"{path}/{i}")
            if bad:
                return bad
        return None
    x, y = (t if isinstance(t, torch.Tensor) else torch.tensor(t)
            for t in (a, b))
    if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)):
        return path
    return None


def _zstd_bench():
    """The hand-written zstd decoder over the committed fixture's chunk
    frames (concatenated frames are one zstd stream) repeated to about
    ZSTD_BENCH_BYTES of output, split over the host's CPUs (at most 8)
    decoding their shares into their parts of one buffer; then one
    thread over a quarter of it.  -> MB/s of output."""
    from concurrent.futures import ThreadPoolExecutor
    from vitcap_tpu_torch.utils import orbax_state as OS
    threads = min(8, os.cpu_count() or 1)
    frames = OS.chunk_frames(str(ORBAX_FIXTURE))
    one = b"".join(bytes(src) for _, src, _ in frames)
    out_one = sum(n for _, _, n in frames)
    reps = max(threads, ZSTD_BENCH_BYTES // out_one // threads * threads)
    total = out_one * reps
    counts = np.zeros(len(OS.COUNTERS), np.uint64)
    OS.zstd_decode_into(np.frombuffer(one, np.uint8),
                        np.empty(out_one, np.uint8), "fixture", counts)
    out = np.empty(total, np.uint8)
    out.fill(0)                            # fault the pages in first
    share = np.frombuffer(one * (reps // threads), np.uint8)
    part = out_one * (reps // threads)
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda i: OS.zstd_decode_into(
            share, out[i * part:(i + 1) * part], "bench"), range(threads)))
        par_s = time.perf_counter() - t0
    quarter = np.frombuffer(one * (reps // 4), np.uint8)
    one_out = out_one * (reps // 4)
    t0 = time.perf_counter()
    OS.zstd_decode_into(quarter, out[:one_out], "bench")
    one_s = time.perf_counter() - t0
    del out, share, quarter
    return {"frames": len(frames), "compressed_bytes": len(one),
            "decoded_bytes": out_one, "reps": reps, "output_bytes": total,
            "one_thread_bytes": one_out,
            "one_thread_MBps": one_out / one_s / 1e6, "threads": threads,
            "all_threads_MBps": part * threads / par_s / 1e6,
            "block_kinds": dict(zip(OS.COUNTERS, counts.tolist()))}


def _orbax_roundtrip(dev, smi, cfg, state, resumed, step, batch, build,
                     ack):
    """Phase 12's orbax half: `state` (2 flagship steps) saved with
    backend='orbax' (the JAX package's orbax directory, written by the
    port's own OCDBT, zarr and zstd code) and loaded on the card into a
    fresh model: weights, moments and generator equal the torch
    snapshot's (`resumed`) bit for bit, and a fused greedy batch of B from
    each model gives the same ids (run while an async save writes).  The
    async save: from a copy of the state that takes one more train step
    before the write is waited for, bit-equal to the synchronous one;
    `ack` is its Checkpointer, whose pinned buffer the phase reserved
    before its train steps, as a pipeline's recover_or_load does at its
    start.  Then the committed JAX-written
    fixture decodes bit-equal to its msgpack twin, and the zstd decoder is
    timed (_zstd_bench).  `build`: the thread building the decoder's
    library, started with the phase.  Returns the ms, bytes, MB/s and the
    orbax-resumed TrainState (under 'state')."""
    from vitcap_tpu_torch import native
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.solver import checkpointing as CK
    from vitcap_tpu_torch.utils import msgpack_state, orbax_state
    t_half = time.perf_counter()
    build.join()
    native.library("zstd")               # raises what the build raised
    zinfo = native.build_info["zstd"]
    twin = _copy_state(state)
    ck = CK.Checkpointer(str(CKPT_DIR / "run_ob"), backend="orbax")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ck.save(2, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(f.stat().st_size for f in Path(path).rglob("*")
                 if f.is_file())
    if not os.path.isdir(path) or not path.endswith(".orbax"):
        raise AssertionError(f"checkpoint: orbax snapshot {path}")
    fresh = init_params(cfg, torch.Generator().manual_seed(SEED + 80), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh, snap, it = ck.recover_or_load(None, fresh)
    got = CK.restore_train_state(snap, fresh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    del snap
    diff, names = _state_diff(got, resumed)
    if (it != 2 or got.opt.step != 2 or diff or names
            or next(got.model.parameters()).device != dev
            or not torch.equal(got.generator.get_state(),
                               resumed.generator.get_state())):
        raise AssertionError(f"checkpoint: the orbax snapshot resumed at "
                             f"{it}, step {got.opt.step}, {diff:.3e} from "
                             f"the torch one ({len(names)} tensors)")
    # async: one more train step (AdamW in place) while the writer runs
    torch.cuda.synchronize()
    apath = ack.save(2, twin)
    blocking_ms = ack.last_blocking_s * 1e3
    t0 = time.perf_counter()
    twin, _ = step(twin, batch, False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    del twin
    rs = np.random.RandomState(SEED + 15)
    imgs = torch.from_numpy(rs.randint(0, 256, (B, cfg.img_size,
                                                cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.zeros((B, cfg.max_seq_len - cfg.max_seq_a_len),
                     dtype=torch.long, device=dev)
    seq = torch.full((B,), cfg.max_seq_a_len, device=dev)
    ids = []
    with _engine(True):
        for st in (got, resumed):
            ids.append(TD.generate_greedy(st.model, imgs, od, None, seq, cfg,
                                          _opts(cfg))["ids"])
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError("checkpoint: the orbax-loaded model's fused "
                             "greedy ids differ from the torch-loaded one's")
    t0 = time.perf_counter()
    ack.wait_until_finished()
    wait_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    frames = [{k: src for k, src, _ in orbax_state.chunk_frames(p)}
              for p in (apath, path)]
    bad = [k for k in frames[1] if k not in frames[0]
           or not np.array_equal(frames[0][k], frames[1][k])]
    if bad or frames[0].keys() != frames[1].keys():
        raise AssertionError(f"checkpoint: the async orbax snapshot differs "
                             f"from the synchronous one at {bad[:4]} (a "
                             f"train step ran before it finished)")
    del frames
    compare_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(CKPT_DIR / "run_ob", ignore_errors=True)
    shutil.rmtree(CKPT_DIR / "run_ob_async", ignore_errors=True)
    t0 = time.perf_counter()
    fixture = orbax_state.load(str(ORBAX_FIXTURE))
    fixture_ms = (time.perf_counter() - t0) * 1e3
    bad = _tree_equal(fixture, msgpack_state.load(str(ORBAX_FIXTURE)
                                                  + ".ckpt"))
    if bad:
        raise AssertionError(f"checkpoint: the JAX-written fixture differs "
                             f"from its msgpack twin at {bad}")
    t0 = time.perf_counter()
    bench = _zstd_bench()
    bench_ms = (time.perf_counter() - t0) * 1e3
    kinds = bench["block_kinds"]
    gib = nbytes / 2 ** 30
    built = "built" if zinfo["built"] else "found"
    log(f"[checkpoint] orbax: zstd library {built} in "
        f"{zinfo['seconds']:.1f} s (in a thread since the phase "
        f"began); save {save_ms:.1f} ms, {nbytes} bytes ({gib:.3f} GiB, raw "
        f"zstd blocks); load + restore {load_ms:.1f} ms; weights, moments "
        f"and generator equal the torch snapshot's; a fused greedy batch "
        f"of {B}: the same ids")
    log(f"[checkpoint] orbax async: save {blocking_ms:.1f} ms blocking (its "
        f"pinned buffer reserved before the train steps), then a train step of "
        f"{step_ms:.1f} ms and the greedy batch ran before it finished "
        f"({wait_ms:.1f} ms more waited); bit-equal to the synchronous one "
        f"(compared chunk by chunk in {compare_ms:.1f} ms)")
    log(f"[checkpoint] orbax: the JAX-written fixture decodes bit-equal to "
        f"its msgpack twin ({fixture_ms:.1f} ms);"
        f" zstd decode of its {bench['frames']} frames x {bench['reps']} "
        f"({bench['output_bytes']} bytes out) on {bench['threads']} "
        f"threads: {bench['all_threads_MBps']:.1f} MB/s; a quarter on one "
        f"thread: {bench['one_thread_MBps']:.1f} MB/s ({bench_ms:.1f} ms "
        f"in all); a "
        f"JAX-written snapshot of {gib:.3f} GiB would decode in "
        f"{nbytes / bench['one_thread_MBps'] / 1e6:.2f} s on one thread, "
        f"{nbytes / bench['all_threads_MBps'] / 1e6:.2f} s on "
        f"{bench['threads']}; block kinds {kinds}; host CPUs "
        f"{os.cpu_count()}; the orbax half took "
        f"{time.perf_counter() - t_half:.1f} s; {smi}")
    return {"save_ms": save_ms, "async_blocking_ms": blocking_ms,
            "async_step_ms": step_ms, "async_wait_ms": wait_ms,
            "load_ms": load_ms, "bytes": nbytes,
            "fixture_ms": fixture_ms, "zstd_build_s": zinfo["seconds"],
            "async_compare_ms": compare_ms, "zstd_bench_ms": bench_ms,
            "zstd": bench, "state": got}


DEMO_DETECTIONS = [{"class": "dog", "conf": 0.97, "rect": [10, 20, 200, 300]},
                   {"class": "bench", "conf": 0.8, "rect": [0, 250, 384, 384]},
                   {"class": "dog", "conf": 0.6, "rect": [12, 22, 190, 310]}]


def _msgpack_roundtrip(dev, smi, cfg, state, resumed):
    """Phase 12's msgpack half: `state` (2 flagship steps) saved with
    backend='msgpack' (the JAX package's format) and loaded on the card
    into a fresh model: weights and moments equal the torch snapshot's
    (`resumed`) bit for bit; a fused greedy batch of B from each model
    gives the same ids; the port's demo and demo_e2e, run on a seeded
    JPEG from the msgpack file (on the card by default), each caption
    what the same call gives through models.decode.generate or
    models.cbs.constrained_beam_search directly on the torch-loaded
    weights.  Returns the save and load ms, the file's bytes and the
    msgpack-resumed TrainState (under 'state')."""
    from PIL import Image
    from vitcap_tpu_torch import demo, demo_e2e
    from vitcap_tpu_torch.data.tokenization import (DEFAULT_VOCAB,
                                                    BertTokenizer)
    from vitcap_tpu_torch.models import cbs as C
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.solver import checkpointing as CK
    ck = CK.Checkpointer(str(CKPT_DIR / "run_mp"), backend="msgpack")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ck.save(2, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(path)
    if CK.is_torch_file(path):
        raise AssertionError("checkpoint: the msgpack snapshot is a zip")
    fresh = init_params(cfg, torch.Generator().manual_seed(SEED + 79), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh, snap, it = ck.recover_or_load(None, fresh)
    got = CK.restore_train_state(snap, fresh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    del snap
    diff, names = _state_diff(got, resumed)
    if (it != 2 or got.opt.step != 2 or diff or names
            or next(got.model.parameters()).device != dev
            or not torch.equal(got.generator.get_state(),
                               resumed.generator.get_state())):
        raise AssertionError(f"checkpoint: the msgpack snapshot resumed at "
                             f"{it}, step {got.opt.step}, {diff:.3e} from "
                             f"the torch one ({len(names)} tensors)")
    rs = np.random.RandomState(SEED + 14)
    imgs = torch.from_numpy(rs.randint(0, 256, (B, cfg.img_size,
                                                cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.zeros((B, cfg.max_seq_len - cfg.max_seq_a_len),
                     dtype=torch.long, device=dev)
    seq = torch.full((B,), cfg.max_seq_a_len, device=dev)
    ids = []
    with _engine(True):
        for st in (got, resumed):
            ids.append(TD.generate_greedy(st.model, imgs, od, None, seq, cfg,
                                          _opts(cfg))["ids"])
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError("checkpoint: the msgpack-loaded model's fused "
                             "greedy ids differ from the torch-loaded one's")
    log(f"[checkpoint] msgpack: save {save_ms:.1f} ms, load + restore "
        f"{load_ms:.1f} ms, {nbytes} bytes; weights, moments and generator "
        f"equal the torch snapshot's; a fused greedy batch of {B}: the same "
        f"ids")
    # the demos, from the msgpack file, against direct calls
    enc = CKPT_DIR / "encoder"
    enc.mkdir(parents=True, exist_ok=True)
    (enc / "config.json").write_text(json.dumps({
        "hidden_size": cfg.hidden_size, "intermediate_size":
        cfg.intermediate_size, "num_attention_heads": cfg.num_attention_heads,
        "num_hidden_layers": cfg.num_hidden_layers,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_position_embeddings}))
    shutil.copy(DEFAULT_VOCAB, enc / "vocab.txt")
    jpeg, det = CKPT_DIR / "photo.jpg", CKPT_DIR / "det.json"
    Image.fromarray(rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)).save(
        jpeg, quality=90)
    det.write_text(json.dumps({"detections": DEMO_DETECTIONS}))
    argv = ["--checkpoint", path, "--image", str(jpeg), "--encoder-dir",
            str(enc), "--crop-size", str(cfg.img_size)]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    t0 = time.perf_counter()
    got_demo = demo.main(argv)
    demo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_e2e = demo_e2e.main(argv + ["--detections", str(det)])
    e2e_s = time.perf_counter() - t0
    dcfg = demo.encoder_config(str(enc), cfg.img_size)
    tok = BertTokenizer(str(DEFAULT_VOCAB))
    x = demo.load_image(str(jpeg), cfg.img_size, dev)
    model = resumed.model
    od1 = torch.zeros((1, od.shape[1]), dtype=torch.long, device=dev)
    with torch.inference_mode():
        out = TD.generate(model, x, od1, None, seq[:1], dcfg,
                          TD.DecodeOptions(
                              max_length=dcfg.max_gen_length,
                              od_labels_start_posid=dcfg.max_seq_a_len))
    want_demo = tok.decode(out["ids"][0, 0].tolist(),
                           skip_special_tokens=True)
    cons = ["dog", "bench"]           # by confidence, duplicates dropped
    od_tok = tok.tokenize("bench") + tok.tokenize("dog")    # sorted names
    od1[0, :len(od_tok)] = torch.tensor(tok.convert_tokens_to_ids(od_tok))
    fsm, _ = C.FiniteStateMachineBuilder(
        tok, {c: tok.tokenize(c) for c in cons},
        {c: sorted({c, c + "s"}) for c in cons}, 3).build(cons)
    opts = TD.DecodeOptions(max_length=dcfg.max_gen_length,
                            od_labels_start_posid=dcfg.max_seq_a_len)
    out = C.constrained_beam_search(
        model, x, od1, None, seq[:1] + len(od_tok),
        torch.from_numpy(fsm[None]).to(dev), dcfg, opts, beam_size=5)
    best, _ = C.select_best_beam_with_constraints(
        out["ids"][:, :, :, 1:].cpu().numpy(), out["logprobs"].cpu().numpy(),
        np.asarray([len(cons)]), 2, [dcfg.sep_token_id])
    want_e2e = tok.decode(best[0].tolist(), skip_special_tokens=True)
    log(f"[checkpoint] demo from the msgpack file {got_demo!r} ({demo_s:.1f}"
        f" s), generate directly {want_demo!r}; demo_e2e {got_e2e!r} "
        f"({e2e_s:.1f} s), constrained_beam_search directly {want_e2e!r}")
    if got_demo != want_demo or got_e2e != want_e2e or not got_demo:
        raise AssertionError("checkpoint: a demo's caption differs from "
                             "the direct call's")
    return {"save_ms": save_ms, "load_ms": load_ms, "bytes": nbytes,
            "demo": got_demo, "demo_e2e": got_e2e, "demo_s": demo_s,
            "demo_e2e_s": e2e_s, "state": got}


# ---------------------------------------------------------------------------
# phase 13: SCST
# ---------------------------------------------------------------------------

SCST_K = 2
# one SCST step on the fused engine at the flagship: the decode builds one
# context (15 ViT blocks, 3 prefill layers) and runs greedy (B rows) and
# sampled (B * K rows) loops of 19 steps, 4 layers of 4 gemm, 2 layer_norm
# and 1 decode_attention; the gradient runs the encoder's 15 train blocks
# and the 4 decoder layers at 672 tokens, each decoder layer twice (remat)
SCST_DECODE = {"gemm": 72 + 2 * 4 * 4 * STEPS,
               "layer_norm": 36 + 2 * 4 * 2 * STEPS, "attention": 18,
               "attention_bwd": 0, "decode_attention": 2 * 4 * STEPS}
SCST_GRAD = {"gemm": 4 * (15 + 2 * 4), "layer_norm": 2 * (15 + 2 * 4),
             "attention": 15 + 2 * 4, "attention_bwd": 2 * (15 + 4),
             "decode_attention": 0}


SCST_BK, SCST_L, SCST_LP = B * SCST_K, 668, 672   # 2A + S, padded


def _scst_probe_bias(dev, g):
    """The fusion decoder's bias in the SCST gradient step: the probe
    layout's allow-mask (solver/scst.py probe_allow_mask: 20 real tokens,
    20 MASK probes, the 628-token context) over B*K = 128 sequences, each
    image's od prefix valid up to a seeded length and repeated K times,
    as (128, 1, 668, 668) f32 of 0 / NEG_MASK_VALUE padded with zeros to
    672 (models/vitcap.py fusion_decoder; the padded keys are masked by
    l_actual 668)."""
    from vitcap_tpu_torch.models.layers import NEG_MASK_VALUE
    from vitcap_tpu_torch.solver.scst import probe_allow_mask
    S, od_len, A = SCST_L - 40, 50, 20
    n_od = torch.randint(1, od_len + 1, (B,), generator=g)
    valid = torch.arange(S)[None, :] >= od_len
    valid = valid | (torch.arange(S)[None, :] < n_od[:, None])
    allow = probe_allow_mask(valid.repeat_interleave(SCST_K, 0).to(dev),
                             od_len, A)
    bias = torch.where(allow, 0.0, NEG_MASK_VALUE)[:, None]
    del allow
    return F.pad(bias, (0, SCST_LP - SCST_L, 0, SCST_LP - SCST_L)) \
        .contiguous()


def phase_scst_kernels(dev, rows):
    """The kernels of the SCST gradient step's fusion decoder at its
    shapes, bf16, vs their plain versions: B*K = 128 sequences of 668
    tokens padded to 672 (M = 86016 rows), a layer's four gemm (qkv with
    its bias; out-dense and fc2 with the residual and the hidden-dropout
    epilogue at rate 0, as sampling-free scoring runs them; fc1 with GELU
    and the pre-GELU output), LayerNorm with stats, attention and
    attention_bwd under the probe bias (_scst_probe_bias) at rate 0 with
    l_actual 668, each at least 99% bit-equal (every part of the backward)
    and within the bf16 tolerance; then decode_attention at the sampled
    loop's geometry (K=2 beams an image, S=628), at least 99% bit-equal.
    Yardsticks: F.linear, F.layer_norm, SDPA with the float mask and its
    backward on a retained graph."""
    from vitcap_tpu_torch.ops.attention import attention, attention_plain
    from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd,
                                                    attention_bwd_plain)
    from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    g = torch.Generator().manual_seed(SEED + 40)
    dt, es, dn = torch.bfloat16, 2, "bf16"
    H, I, nh, hd = 768, 3072, 12, 64
    Bk, L, Lp = SCST_BK, SCST_L, SCST_LP
    M = Bk * Lp
    first = len(rows)

    def rnd(*shape, scale=1.0, dtype=dt):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def gemm_case(kernel, case, K, N, **kw):
        a = [rnd(M, K) for _ in range(2)]
        w, b = rnd(N, K, scale=0.02), rnd(N, scale=0.02, dtype=torch.float32)
        res = rnd(M, N) if "residual" in kw else None
        pre = [torch.empty(M, N, dtype=dt, device=dev) for _ in range(2)] \
            if kw.get("gelu") else [None, None]

        def call(fn, i, p):
            extra = dict(kw, residual=res) if res is not None else dict(kw)
            if p is not None:
                extra["pre_out"] = p
            return fn(a[i % 2], w, b, **extra)
        out, ref = call(gemm, 0, pre[0]), call(gemm_plain, 0, pre[1])
        name = f"{kernel} scst {case}"
        err = compare(name, out, ref, dt)
        eq = _bits(name, out, ref)
        if pre[0] is not None:
            err = max(err, compare(name + " pre", pre[0], pre[1], dt))
            eq = min(eq, _bits(name + " pre", pre[0], pre[1]))
        del out, ref
        ms, pms = _time_pair(lambda i: call(gemm, i, pre[0]),
                             lambda i: call(gemm_plain, i, pre[1]), 10, 3)
        bd = b.to(dt)
        lms = cuda_ms(lambda i: F.linear(a[i % 2], w, bd), 10)
        _row(rows, kernel, f"scst {case}", dn, f"M={M} K={K} N={N}", err, ms,
             pms, lms, 2.0 * M * K * N,
             es * (M * K + N * K + M * N * (1 + (res is not None)
                                             + (pre[0] is not None))) + 4 * N)
        rows[-1]["bit_equal"] = eq

    gemm_case("gemm", "qkv", H, 3 * H)
    gemm_case("gemm[dropout]", "out-dense", H, H, dropout=(0.0, 0, 0, Lp))
    gemm_case("gemm[pre_out]", "fc1+gelu+pre", H, I, gelu=True)
    gemm_case("gemm[dropout]", "fc2", I, H, dropout=(0.0, 0, 1, Lp))
    torch.cuda.empty_cache()
    x = [rnd(M, H, scale=3.0) + 1 for _ in range(2)]
    gm, bt = rnd(H, dtype=torch.float32) + 1, rnd(H, dtype=torch.float32)
    out = layer_norm(x[0], gm, bt, 1e-12, dt, stats=True)
    ref = layer_norm_plain(x[0], gm, bt, 1e-12, dt, stats=True)
    err = max(compare(f"layer_norm[stats] scst {i}", o, r, o.dtype)
              for i, (o, r) in enumerate(zip(out, ref)))
    eq = _bits("layer_norm[stats] scst", out[0], ref[0])
    del out, ref
    ms, pms = _time_pair(
        lambda i: layer_norm(x[i % 2], gm, bt, 1e-12, dt, stats=True),
        lambda i: layer_norm_plain(x[i % 2], gm, bt, 1e-12, dt, stats=True),
        10, 3)
    gl, bl = gm.to(dt), bt.to(dt)
    lms = cuda_ms(lambda i: F.layer_norm(x[i % 2], (H,), gl, bl, 1e-12), 10)
    _row(rows, "layer_norm[stats]", "scst decoder", dn, f"rows={M} H={H}",
         err, ms, pms, lms, 8.0 * M * H, M * H * 2 * es + 8 * M + 8 * H)
    rows[-1]["bit_equal"] = eq
    del x
    # K8 forward and backward under the probe bias
    bias = _scst_probe_bias(dev, g)
    slab = rnd(Bk, Lp, 3 * H)
    up = rnd(Bk, Lp, H)
    up[:, L:] = 0.0
    mask = bias.to(dt)
    mask[..., L:] = float("-inf")
    out = attention(slab, nh, L, bias, 0.0, 0)
    ref = attention_plain(slab, nh, L, bias, 0.0, 0)
    err = compare("attention scst", out, ref, dt)
    eq = _bits("attention scst", out, ref)
    del out, ref
    ms, pms = _time_pair(lambda i: attention(slab, nh, L, bias, 0.0, 0),
                         lambda i: attention_plain(slab, nh, L, bias, 0.0, 0),
                         5, 2)
    qkv = slab.view(Bk, Lp, 3, nh, hd).permute(2, 0, 3, 1, 4)
    lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qkv[0], qkv[1], qkv[2], attn_mask=mask), 5)
    _row(rows, "attention", "scst decoder", dn,
         f"B={Bk} L={L} Lp={Lp} heads=12x64 probe bias", err, ms, pms, lms,
         4.0 * Bk * nh * Lp * L * hd, es * Bk * Lp * 4 * H + 4 * Bk * Lp * Lp)
    rows[-1]["bit_equal"] = eq
    got = attention_bwd(slab, up, nh, L, bias, 0.0, 0)
    want = attention_bwd_plain(slab, up, nh, L, bias, 0.0, 0)
    err, eqs = 0.0, []
    for part, o, r in zip("qkv", got, want):
        name = f"attention_bwd scst d{part}"
        err = max(err, compare(name, o, r, dt))
        eqs.append(_bits(name, o, r))
    del got, want
    ms, pms = _time_pair(
        lambda i: attention_bwd(slab, up, nh, L, bias, 0.0, 0),
        lambda i: attention_bwd_plain(slab, up, nh, L, bias, 0.0, 0), 3, 2)
    q3 = [t.detach().contiguous().requires_grad_(True) for t in qkv]
    o = F.scaled_dot_product_attention(*q3, attn_mask=mask)
    go = up.view(Bk, Lp, nh, hd).transpose(1, 2)
    lms = cuda_ms(lambda i: torch.autograd.grad(o, q3, go,
                                                retain_graph=True), 3)
    _row(rows, "attention_bwd", "scst decoder", dn,
         f"B={Bk} L={L} Lp={Lp} heads=12x64 probe bias", err, ms, pms, lms,
         10.0 * Bk * nh * Lp * L * hd,
         es * Bk * Lp * 7 * H + 4 * Bk * Lp * Lp)
    rows[-1]["bit_equal"] = min(eqs)
    del slab, up, bias, mask, qkv, q3, o, go
    torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[scst-kernel] {r['kernel']:18s} {r['case']:24s} err "
            f"{r['max_abs_err']:.3e}  bit-equal {r['bit_equal']:.5f}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    phase_decode_attention(dev, rows, cases=(("scst sample2", SCST_K),),
                           dtypes=(torch.bfloat16,))


def _gt_captions(first, seed):
    """5 references an image: first[i] (the image's greedy caption before
    training, so that under random weights the rewards are not all 0),
    then 4 captions of 6-12 whole words of the vocab, from a numpy seed."""
    from vitcap_tpu_torch.data.tokenization import CaptionDecoder
    words = [w for w in CaptionDecoder().ids_to_tokens.values()
             if w.isalpha() and w.isascii()]
    rs = np.random.RandomState(seed)
    return [[c] + [" ".join(rs.choice(words, rs.randint(6, 13)))
                   for _ in range(4)] for c in first]


def _scst_batch(cfg, Bn, seed, dev):
    rs = np.random.RandomState(seed)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    return {"image": torch.from_numpy(rs.randint(
                0, 256, (Bn, cfg.img_size, cfg.img_size, 3))
                .astype(np.uint8)).to(dev),
            "od_ids": torch.zeros(Bn, od_len, dtype=torch.long, device=dev),
            "seq_len": torch.full((Bn,), cfg.max_seq_len, device=dev)}


def _counted(fn):
    """fn()'s result and the kernel launches and modes it made."""
    from vitcap_tpu_torch import ops
    before = dict(ops.launch_counts(), **ops.mode_counts())
    out = fn()
    after = dict(ops.launch_counts(), **ops.mode_counts())
    return out, {k: after[k] - before[k] for k in after}


def _cider_env(native: bool):
    """Select the CIDEr-D scorer for a block, as a user does: through
    VITCAP_NATIVE_CIDER (the C++ scorer unless it is 0)."""
    return _env("VITCAP_NATIVE_CIDER", "1" if native else "0")


def phase_scst(dev, smi, Bn=B, cfg_kw=None, native_cider=False,
               ratio07=True, tag="scst"):
    """Self-critical fine-tuning at the flagship (384 px, B=64, K=2,
    greedy baseline, corpus CIDEr-D against _gt_captions, max_length 20,
    bf16, fused decode engine): one warm-up step through
    scst_train_step, then 3 steps
    through decode_fn, the host reward and grad_step, each timed apart
    (host clock around synchronised work) with exact launch counts per
    kernel; then (ratio07) one step at visual_token_ratio=0.7.  The reward
    scores with the pure-Python CIDEr-D, or with the native C++ one
    (native_cider: phase 19).  Returns the counts of the timed run (set
    to 0 just before it) and the results."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.data.tokenization import CaptionDecoder
    from vitcap_tpu_torch.solver import scst as SC
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state)
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    cfg = ModelConfig(**dict(dict(dtype="bfloat16"), **(cfg_kw or {})))
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    opts = _opts(cfg)
    hyper = TrainHyper(base_lr=1e-5, max_iter=1000)
    tok = CaptionDecoder()
    batch = _scst_batch(cfg, Bn, SEED + 20, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    state = init_train_state(model, None)
    res = {}
    scorer = "native C++" if native_cider else "pure Python"
    with _engine(fused=True), _cider_env(native_cider):
        decode_fn, grad_step = SC.make_scst_fns(
            cfg, opts, SC.ScstConfig(num_return=SCST_K), hyper)
        first = decode_fn(model, batch["image"], batch["od_ids"], None,
                          batch["seq_len"], gen)[0]
        gt = _gt_captions([tok.decode(r) for r in first.tolist()],
                          SEED + 21)
        reward = SC.ScstReward("corpus", "greedy")
        torch.cuda.reset_peak_memory_stats()
        state, m = SC.scst_train_step(decode_fn, grad_step, reward, tok,
                                      state, batch, gt, gen)
        torch.cuda.synchronize()
        ops.reset_counts()
        steps = []
        for _ in range(3):
            t0 = time.perf_counter()
            (g_ids, s_ids, raw, vidx), dc = _counted(lambda: decode_fn(
                state.model, batch["image"], batch["od_ids"], None,
                batch["seq_len"], gen))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            greedy = [tok.decode(r) for r in g_ids.tolist()]
            samples = [tok.decode(r) for r in s_ids.tolist()]
            adv = torch.from_numpy(reward(gt, greedy, samples)).to(dev)
            t2 = time.perf_counter()
            (state, m), gc = _counted(lambda: grad_step(
                state, batch, s_ids, raw, adv, vidx))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            steps.append({"decode_ms": (t1 - t0) * 1e3,
                          "reward_ms": (t2 - t1) * 1e3,
                          "grad_ms": (t3 - t2) * 1e3,
                          "decode_launches": dc, "grad_launches": gc,
                          "loss": m["scst_loss"].item(),
                          "grad_norm": m["grad_norm"].item(),
                          "cider": reward.get_score(),
                          "adv_nonzero": int((adv != 0).sum().item())})
        counts = dict(ops.launch_counts(), **ops.mode_counts())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for st in steps:
            got_d = {k: st["decode_launches"][k] for k in SCST_DECODE}
            got_g = {k: st["grad_launches"][k] for k in SCST_GRAD}
            if got_d != SCST_DECODE or got_g != SCST_GRAD:
                raise AssertionError(f"scst launches: decode {got_d} != "
                                     f"{SCST_DECODE} or grad {got_g} != "
                                     f"{SCST_GRAD}")
            if not (math.isfinite(st["loss"]) and math.isfinite(
                    st["grad_norm"]) and st["grad_norm"] > 0):
                raise AssertionError(f"scst step: {st}")
        if s_ids.shape != (Bn * SCST_K, opts.max_length) or (
                g_ids[:, 0] != cfg.cls_token_id).any():
            raise AssertionError("scst: decode shapes or CLS")
        med = {k: sorted(st[k] for st in steps)[1]
               for k in ("decode_ms", "reward_ms", "grad_ms")}
        step_ms = sum(med.values())
        log(f"[{tag}] launches per step: decode "
            f"{steps[0]['decode_launches']}; grad "
            f"{steps[0]['grad_launches']}")
        log(f"[{tag}] losses {[round(s['loss'], 5) for s in steps]} "
            f"grad_norm {[round(s['grad_norm'], 4) for s in steps]} CIDEr-D "
            f"{[round(s['cider'], 4) for s in steps]} nonzero advantages "
            f"{[s['adv_nonzero'] for s in steps]}")
        log(f"[{tag}] median of 3 steps: decode {med['decode_ms']:.1f} ms, "
            f"host reward {med['reward_ms']:.1f} ms ({Bn * (SCST_K + 1)} "
            f"captions, {scorer} CIDEr-D), grad {med['grad_ms']:.1f} ms; "
            f"{Bn / step_ms * 1e3:.2f} images/s, peak memory {peak:.2f} GiB "
            f"(B={Bn}, K={SCST_K}, bf16, 384x384, fused engine) on {smi}")
        res.update(steps=steps, median=med, images_per_s=Bn / step_ms * 1e3,
                   peak_gib=peak, cider_scorer=scorer)
        if not ratio07:
            del state, model
            torch.cuda.empty_cache()
            return counts, res
        # TokenSample: 404 of 577 visual tokens
        dec7, grad7 = SC.make_scst_fns(
            cfg, opts, SC.ScstConfig(num_return=SCST_K,
                                     visual_token_ratio=0.7), hyper)
        t0 = time.perf_counter()
        (state, m7), c7 = _counted(lambda: SC.scst_train_step(
            dec7, grad7, reward, tok, state, batch, gt, gen))
        torch.cuda.synchronize()
        ms7 = (time.perf_counter() - t0) * 1e3
        if not (math.isfinite(m7["scst_loss"].item())
                and math.isfinite(m7["grad_norm"].item())):
            raise AssertionError(f"scst ratio 0.7: {m7}")
        want7 = {k: SCST_DECODE[k] + SCST_GRAD[k] for k in SCST_GRAD}
        got7 = {k: c7[k] for k in want7}
        if got7 != want7:
            raise AssertionError(f"scst ratio 0.7 launches {got7} != {want7}")
        log(f"[scst] visual_token_ratio 0.7 (404 of 577 tokens): loss "
            f"{m7['scst_loss'].item():.5f} grad_norm "
            f"{m7['grad_norm'].item():.4f}, step {ms7:.1f} ms, launches "
            f"{got7} on {smi}")
        res["ratio07"] = {"step_ms": ms7, "launches": got7}
    del state, model
    torch.cuda.empty_cache()
    return counts, res


def phase_scst_parity(dev, Bn=2):
    """One f32 grad_step on the card vs the CPU, full width (4 trunk
    blocks, 2 of them forked into the tag branch, 2 decoder layers), B=2,
    K=2, given the same sampled ids, raw tokens, advantages and
    TokenSample indices (404 of 577 tokens): loss, grad norm and mean
    logprob within 1e-4 relative; updated parameters at least 99.9%
    within 1e-2 lr and all within 2 lr (the rule of the train step's
    parity)."""
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.solver import scst as SC
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state)
    cfg = ModelConfig(num_hidden_layers=4, split_blocks=2, decoder_layers=2)
    opts = _opts(cfg)
    A = opts.max_length
    rs = np.random.RandomState(SEED + 30)
    ids = rs.randint(999, 9000, (Bn * SCST_K, A))
    ids[:, 0] = cfg.cls_token_id
    ids[0, 9], ids[0, 10:] = cfg.sep_token_id, cfg.pad_token_id
    ids[-1, A - 1] = cfg.sep_token_id
    raw = ids[:, 1:].copy()
    raw[0, 9:] = rs.randint(999, 9000, A - 10)
    adv = rs.randn(Bn * SCST_K).astype(np.float32)
    n_vis, keep = cfg.num_visual_tokens, int(round(0.7 * 577))
    vidx = np.stack([np.concatenate([[0], rs.permutation(n_vis - 1)[:keep - 1]
                                     + 1]) for _ in range(Bn)])
    lr = 1e-4
    cpu_model = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    res = {}
    for model, d in ((gpu_model, dev), (cpu_model, "cpu")):
        _, grad = SC.make_scst_fns(
            cfg, opts, SC.ScstConfig(num_return=SCST_K,
                                     visual_token_ratio=0.7),
            TrainHyper(base_lr=lr, max_iter=1000))
        state = init_train_state(model, None)
        batch = _scst_batch(cfg, Bn, SEED + 31, d)
        _, m = grad(state, batch, torch.from_numpy(ids).to(d),
                    torch.from_numpy(raw).to(d), torch.from_numpy(adv).to(d),
                    torch.from_numpy(vidx).to(d))
        res[d] = ({k: v.item() for k, v in m.items()},
                  {n: p.detach().float().cpu() for n, p in
                   model.named_parameters()})
    torch.cuda.synchronize()
    (gm, gp), (cm, cp) = res[dev], res["cpu"]
    for k in ("scst_loss", "grad_norm", "mean_logprob"):
        rel = abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)
        log(f"[scst-parity] {k:12s} GPU {gm[k]:.7g} CPU {cm[k]:.7g} rel "
            f"{rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"scst parity {k}: rel {rel:.3e}")
    diff = torch.cat([(gp[n] - cp[n]).abs().flatten() for n in cp])
    close = (diff <= 1e-2 * lr).float().mean().item()
    log(f"[scst-parity] updated parameters: {close:.6f} within 1e-2 lr, max "
        f"{diff.max().item() / lr:.3e} lr")
    if not (close >= 0.999 and diff.max().item() <= 2.0 * lr * (1 + 1e-3)):
        raise AssertionError("scst parity: updated parameters differ")
    return {"params_close_share": close,
            "params_max_diff_lr": diff.max().item() / lr, "gpu": gm,
            "cpu": cm}


# ---------------------------------------------------------------------------
# phase 14: the pipelines and the CLI (vitcap_tpu_torch.run)
# ---------------------------------------------------------------------------

PIPE_TRAIN, PIPE_TEST = 256, 128     # synthetic images of each split
PIPE_HW = (400, 480)                 # their (height, width): not 384
PIPE_WORDS = ("a an the two three man woman person child dog cat bird "
              "horse car bus train boat plate table street field beach "
              "water grass snow tree road red blue white black green "
              "small large young old sitting standing walking running "
              "riding holding eating playing looking on in with near "
              "under of and at").split()
PIPE_TAGS = ("man woman dog cat bird horse car bus train boat table tree "
             "grass water street").split()
PIPE_TEST_DATA = [{"test_data": "synthcoco", "test_split": "test"}]
TINY_TEST_DATA = [{"test_data": "tinycoco", "test_split": "test"}]


def _pipeline_dataset(root, seed, n_train=PIPE_TRAIN, n_test=PIPE_TEST,
                      hw=PIPE_HW, name="synthcoco"):
    """A TSV dataset in the reference's layout under root/data/<name>:
    {train,test}.tsv (key, 0, base64 JPEG of hw), .hw, .caption (5
    captions of 6-10 vocab words an image), .num_caption and .label (3
    tags an image), all from `seed`: smooth random images with noise."""
    import base64
    import io
    from PIL import Image
    from vitcap_tpu_torch.data.tsv import tsv_writer
    rs = np.random.RandomState(seed)
    d = os.path.join(root, "data", name)
    h, w = hw
    for split, n in (("train", n_train), ("test", n_test)):
        keys = [f"{split}{i:05d}" for i in range(n)]
        rows = []
        for k in keys:
            small = rs.randint(0, 256, (max(h // 40, 2), max(w // 40, 2), 3))
            img = np.asarray(Image.fromarray(small.astype(np.uint8)).resize(
                (w, h), Image.BICUBIC)).astype(np.int16)
            img = np.clip(img + rs.randint(-12, 13, img.shape), 0, 255)
            buf = io.BytesIO()
            Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                                       quality=90)
            rows.append((k, "0", base64.b64encode(buf.getvalue()).decode()))
        tsv_writer(rows, f"{d}/{split}.tsv")
        tsv_writer(((k, json.dumps([{"height": h, "width": w}]))
                    for k in keys), f"{d}/{split}.hw.tsv")
        tsv_writer(((k, json.dumps([
            {"caption": " ".join(rs.choice(PIPE_WORDS, rs.randint(6, 11)))}
            for _ in range(5)])) for k in keys), f"{d}/{split}.caption.tsv")
        tsv_writer(((k, "5") for k in keys), f"{d}/{split}.num_caption.tsv")
        tsv_writer(((k, json.dumps([
            {"class": t, "conf": 0.9}
            for t in rs.choice(PIPE_TAGS, 3, replace=False)]))
            for k in keys), f"{d}/{split}.label.tsv")


def _pipeline_param(root, **kw):
    """The flagship through the pipeline: the shipped
    VILT-L12-H784-uncased_16_384 text encoder (H 768, 12 heads, MLP 3072,
    vocab 30522, dropout 0.1) with VitEmb_vit_base_patch16_384 (12 trunk
    + 4 tag blocks), 4 decoder layers, topk 50, the reference YAML's
    sequence lengths (70, caption 20, generation 20), bf16,
    tag_loss_weight 1.0, batches of 64, random weights from random_seed
    (no basemodel), 8 loader threads, the native image decoder where the
    host can build it (_image_backend)."""
    p = {"data": "synthcoco", "test_data": "synthcoco",
         "test_split": "test", "net": "flagship", "expid": "phase14",
         "data_root": os.path.join(root, "data"),
         "output_root": os.path.join(root, "output"),
         "train_crop_size": 384, "test_crop_size": 384,
         "max_seq_length": 70, "max_seq_a_length": 20,
         "max_gen_length": 20, "topk": 50, "split_blocks": 4,
         "decoder_layers": 4, "compute_dtype": "bfloat16",
         "tag_loss_weight": 1.0, "effective_batch_size": B,
         "test_batch_size": B, "max_iter": 6, "snapshot_steps": 3,
         "base_lr": 1e-4, "random_seed": SEED, "num_workers": 8,
         "image_backend": _image_backend(), "device": "cuda"}
    p.update(kw)
    return p


@contextlib.contextmanager
def _wrapped(owner, name, wrap):
    """owner.name replaced by wrap(original) inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def _pipeline_probes(rec, seeded=False):
    """Inside the block the port's pipelines record into rec: 'steps', each
    train step (host time at its call and at its return after a
    synchronise, its launches, its loss); 'batches', the launches of each
    decode.generate call; 'save_ms' and each timed method's seconds
    (predict, evaluate; synchronised).  seeded: the train tensorizer and
    the train transform get fixed-seed RNGs (the pipelines' own are
    unseeded, as in the JAX package)."""
    import random
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
    from vitcap_tpu_torch.solver import checkpointing as TCK
    from vitcap_tpu_torch.solver import train_step as TTS
    for k in ("steps", "batches", "save_ms", "predict", "evaluate"):
        rec.setdefault(k, [])

    def make_step(make):
        def wrapped(*a, **kw):
            fn = make(*a, **kw)

            def step(state, batch, *rest):
                t0 = time.perf_counter()
                (state, m), c = _counted(lambda: fn(state, batch, *rest))
                torch.cuda.synchronize()
                rec["steps"].append({"t0": t0, "t1": time.perf_counter(),
                                     "launches": c, "loss": m["loss"]})
                return state, m
            return step
        return wrapped

    def generate(gen):
        def wrapped(*a, **kw):
            out, c = _counted(lambda: gen(*a, **kw))
            rec["batches"].append(c)
            return out
        return wrapped

    def timing(kind, scale=1.0):
        def wrap(method):
            def f(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = method(*a, **kw)
                torch.cuda.synchronize()
                rec[kind].append((time.perf_counter() - t0) * scale)
                return out
            return f
        return wrap

    def seeded_tensorizer(orig):
        def f(self):
            t = orig(self)
            t.rng = random.Random(SEED + 41)
            return t
        return f

    class Transform(TCP.TrainImageTransform):
        def __init__(self, *a, **kw):
            kw["seed"] = SEED + 42
            super().__init__(*a, **kw)

    cls = TCP.CaptionUniPipeline
    with contextlib.ExitStack() as st:
        st.enter_context(_wrapped(TTS, "make_train_step", make_step))
        st.enter_context(_wrapped(TD, "generate", generate))
        st.enter_context(_wrapped(TCK.Checkpointer, "save",
                                  timing("save_ms", 1e3)))
        st.enter_context(_wrapped(cls, "predict", timing("predict")))
        st.enter_context(_wrapped(cls, "evaluate", timing("evaluate")))
        if seeded:
            st.enter_context(_wrapped(cls, "train_caption_tensorizer",
                                      seeded_tensorizer))
            st.enter_context(_wrapped(TCP, "TrainImageTransform",
                                      lambda _: Transform))
        yield rec


def _same_launches(kind, per_call):
    """The launches every call made (they must be the same), nonzero only."""
    if not per_call or any(c != per_call[0] for c in per_call):
        raise AssertionError(f"pipeline {kind} launches differ: {per_call}")
    return {k: n for k, n in per_call[0].items() if n}


def _predict_rows(pip, n):
    from vitcap_tpu_torch.data.tsv import tsv_reader
    rows = [(k, json.loads(v)) for k, v in tsv_reader(pip.get_predict_file())]
    if len(rows) != n:
        raise AssertionError(f"predict TSV: {len(rows)} rows, not {n}")
    for k, caps in rows:
        if not (len(caps) == 1 and isinstance(caps[0]["caption"], str)
                and math.isfinite(caps[0]["conf"])):
            raise AssertionError(f"predict row {k}: {caps}")
    return rows


def _read_yaml(path):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def _check_report(report):
    """Bleu_4, ROUGE_L and CIDEr finite; METEOR and SPICE finite, or the
    report's _impl.not_run says why they did not run."""
    not_run = report.get("_impl", {}).get("not_run", {})
    for key in ("Bleu_4", "ROUGE_L", "CIDEr", "METEOR", "SPICE"):
        if key in not_run and key not in report:
            continue
        if not math.isfinite(report[key]):
            raise AssertionError(f"report {key}: {report}")
    return not_run


def phase_pipeline(dev, smi, bare_img_per_s):
    """vitcap_tpu_torch.run.pipeline_train_eval_multi on the card at the
    flagship (_pipeline_param) over a synthetic TSV dataset
    (_pipeline_dataset: 256 + 128 JPEGs of 480x400), under a temporary
    directory of build/:
    a. 6 train steps with snapshots at 3 and 6, predict (2 batches of 64,
       eager engine), evaluate;
    b. predict again with VITCAP_DECODE_FUSED=1, force_predict and
       speed_breakdown (the .speed.yaml's module_time), evaluate;
    c. the call of a again, which must train nothing, predict nothing,
       launch nothing and return b's results;
    d. the eager predict under torch.profiler (_profile: device busy time
       and idle share over the whole predict, model load included);
    e. a 2-step SCST pass from the final snapshot (fused engine, corpus
       CIDEr-D).
    Launch counts are set to 0 before each run and read after it; every
    train step and every predict batch of a run must launch the same.
    Then phase_pipeline_parity.  Returns the counts of a, b and e and the
    results."""
    import shutil
    import tempfile
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch import run as TR
    from vitcap_tpu_torch.utils import common as UC
    UC._LOGGING_INITED = True      # the pipelines log to their folders only
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_pipeline_",
                            dir=ROOT / "build")
    res, counts = {}, {}
    try:
        t0 = time.perf_counter()
        _pipeline_dataset(root, SEED + 50)
        res["dataset_s"] = time.perf_counter() - t0
        param = _pipeline_param(root)
        pip = TR.create_pipeline(dict(param, **PIPE_TEST_DATA[0]))
        snap = Path(pip.model_folder)

        # a. train, predict, evaluate
        ops.reset_counts()
        t0 = time.perf_counter()
        with _pipeline_probes({}) as rec:
            results = TR.pipeline_train_eval_multi(PIPE_TEST_DATA, param)
        run_s = time.perf_counter() - t0
        counts["train_predict"] = dict(ops.launch_counts(),
                                       **ops.mode_counts())
        for name in ("gemm", "layer_norm", "attention", "attention_bwd"):
            if counts["train_predict"][name] == 0:
                raise AssertionError(f"{name}: no launch on the pipeline "
                                     f"path")
        for it in (3, 6):
            if not (snap / f"model_iter_{it:07d}.ckpt").is_file():
                raise AssertionError(f"pipeline: no snapshot at {it}")
        steps = rec["steps"]
        losses = [s["loss"].item() for s in steps]
        if len(steps) != 6 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"pipeline train: losses {losses}")
        per_step = _same_launches("train step",
                                  [s["launches"] for s in steps])
        span = steps[5]["t1"] - steps[1]["t0"]
        rate = B * 5 / span
        # the same span less the iteration-3 snapshot's save
        rate_no_save = B * 5 / (span - rec["save_ms"][0] / 1e3)
        step_ms = [(s["t1"] - s["t0"]) * 1e3 for s in steps]
        gap_ms = [(steps[i]["t0"] - steps[i - 1]["t1"]) * 1e3
                  for i in range(1, 6)]
        rows = _predict_rows(pip, PIPE_TEST)
        if [k for k, _ in rows] != [f"test{i:05d}" for i in range(PIPE_TEST)]:
            raise AssertionError("pipeline predict: keys out of order")
        if len(rec["batches"]) != 2:
            raise AssertionError(f"predict: {len(rec['batches'])} batches")
        per_batch = _same_launches("predict batch", rec["batches"])
        speed = _read_yaml(pip.get_predict_file() + ".speed.yaml")
        not_run = _check_report(results[0])
        res["train"] = {"losses": losses, "img_per_s_steps_2_6": rate,
                        "img_per_s_steps_2_6_less_save": rate_no_save,
                        "step_ms": step_ms, "host_gap_ms": gap_ms,
                        "save_ms": rec["save_ms"],
                        "launches_per_step": per_step,
                        "bare_step_img_per_s": bare_img_per_s}
        pred_s = rec["predict"][0]
        res["predict"] = {"s": pred_s, "captions_per_s": PIPE_TEST / pred_s,
                          "launches_per_batch": per_batch,
                          "speed_yaml": speed}
        res["evaluate"] = {"s": rec["evaluate"][0],
                           "report": {k: v for k, v in results[0].items()
                                      if k != "_impl"}, "not_run": not_run}
        res["run_s"] = run_s
        log(f"[pipeline] {PIPE_TRAIN} + {PIPE_TEST} JPEGs of {PIPE_HW[1]}x"
            f"{PIPE_HW[0]} made in {res['dataset_s']:.1f} s; train + "
            f"predict + evaluate {run_s:.1f} s")
        log(f"[pipeline] train losses {[round(v, 4) for v in losses]}; "
            f"launches per step {per_step}")
        log(f"[pipeline] train {rate:.2f} img/s over steps 2-6, "
            f"{rate_no_save:.2f} less the iteration-3 snapshot's save (B={B}"
            f", bf16, dropout 0.1; host clock from step 2's call to step 6's "
            f"return, each step synchronised at its return); step ms "
            f"{[round(v, 1) for v in step_ms]}; host gap before steps 2-6 "
            f"(loader wait + batch copy) {[round(v, 1) for v in gap_ms]} "
            f"ms; bare step (phase 8) {bare_img_per_s:.2f} img/s; snapshot "
            f"save ms {[round(v, 1) for v in rec['save_ms']]}; on {smi}")
        log(f"[pipeline] predict (eager) {PIPE_TEST} captions in "
            f"{pred_s:.3f} s, model load included: "
            f"{PIPE_TEST / pred_s:.2f} captions/s; pipeline_time "
            f"{speed['pipeline_time']}, prep_time {speed['prep_time']}; "
            f"launches per batch {per_batch}")
        log(f"[pipeline] evaluate {rec['evaluate'][0]:.3f} s; report "
            f"{json.dumps(res['evaluate']['report'])}")
        if not_run:
            log(f"[pipeline] METEOR and SPICE did not run: "
                f"{not_run['METEOR']}")

        # b. the fused engine, with the speed breakdown
        ops.reset_counts()
        with _engine(fused=True), _pipeline_probes({}) as rec:
            results_b = TR.pipeline_train_eval_multi(
                PIPE_TEST_DATA, dict(param, force_predict=1,
                                     speed_breakdown=1))
        counts["fused_predict"] = dict(ops.launch_counts(),
                                       **ops.mode_counts())
        if counts["fused_predict"]["decode_attention"] == 0:
            raise AssertionError("decode_attention: no launch on the fused "
                                 "pipeline predict")
        if rec["steps"]:
            raise AssertionError("fused predict run trained")
        _predict_rows(pip, PIPE_TEST)
        _check_report(results_b[0])
        fused_batch = _same_launches("fused predict batch", rec["batches"])
        speed_b = _read_yaml(pip.get_predict_file() + ".speed.yaml")
        res["fused_predict"] = {
            "s": rec["predict"][0],
            "captions_per_s": PIPE_TEST / rec["predict"][0],
            "launches_per_batch": fused_batch, "speed_yaml": speed_b,
            "report": {k: v for k, v in results_b[0].items()
                       if k != "_impl"}}
        log(f"[pipeline] predict (fused) {PIPE_TEST} captions in "
            f"{rec['predict'][0]:.3f} s with the speed breakdown's extra "
            f"calls; launches per batch {fused_batch}")
        log(f"[pipeline] .speed.yaml module_time "
            f"{json.dumps(speed_b['module_time'])}")

        # c. the same call again: everything cached
        files = {f.name: f.stat().st_mtime for f in snap.iterdir()}
        ops.reset_counts()
        with _pipeline_probes({}) as rec:
            results_c = TR.pipeline_train_eval_multi(PIPE_TEST_DATA, param)
        cached = dict(ops.launch_counts(), **ops.mode_counts())
        now = {f.name: f.stat().st_mtime for f in snap.iterdir()}
        if (results_c != results_b or any(cached.values()) or rec["steps"]
                or rec["predict"] or rec["evaluate"] or now != files):
            raise AssertionError(f"pipeline re-run was not cached: "
                                 f"launches {cached}, files {now != files}")
        log("[pipeline] re-run: nothing trained, predicted, evaluated or "
            "launched; the same results")

        # d. where the predict's time goes
        pd = TR.create_pipeline(dict(param, force_predict=1,
                                     **PIPE_TEST_DATA[0]))
        with _engine(fused=False):
            res["predict_profile"] = _profile("pipeline_predict",
                                              pd.ensure_predict, reps=1)
        del pd

        # e. SCST from the final snapshot
        (snap / "model_iter_0000003.ckpt").unlink()
        ps = dict(param, expid="phase14_scst", scst=True, max_iter=2,
                  snapshot_steps=10, log_step=1,
                  cider_cached_tokens="corpus",
                  basemodel=str(snap / "model_iter_0000006.ckpt"))
        ops.reset_counts()
        with _engine(fused=True):
            sp = TR.create_pipeline(dict(ps, **PIPE_TEST_DATA[0]))
            sp.ensure_train()
        torch.cuda.synchronize()
        counts["scst"] = dict(ops.launch_counts(), **ops.mode_counts())
        for name in ("gemm", "layer_norm", "attention", "attention_bwd",
                     "decode_attention"):
            if counts["scst"][name] == 0:
                raise AssertionError(f"{name}: no launch on the pipeline's "
                                     f"SCST")
        m = sp.train_meters
        if not (Path(sp.model_folder) / "model_iter_0000002.ckpt").is_file() \
                or m.scst_loss.count != 2 \
                or not math.isfinite(m.scst_loss.global_avg):
            raise AssertionError("pipeline SCST: snapshot or loss")
        times = list(m.time.deque)
        res["scst"] = {"step_s": times, "img_per_s_step_2": B / times[1],
                       "loss": list(m.scst_loss.deque),
                       "cider": list(m.cider.deque)}
        log(f"[pipeline] SCST steps {[round(t, 3) for t in times]} s "
            f"(the first warms up): {B / times[1]:.2f} img/s in step 2; "
            f"losses {[round(v, 5) for v in m.scst_loss.deque]}")
        del sp
        torch.cuda.empty_cache()
        res["parity"] = phase_pipeline_parity(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, res


def phase_pipeline_parity(root, devices=("cuda", "cpu")):
    """The tiny test configuration (tests/test_torch_pipeline.py: H 32, 4
    heads, 2 + 1 trunk blocks, 2 decoder layers, crop 32, 3 steps, dropout
    0, f32) over a 6-image TSV dataset, once on the card and once on the
    CPU, from one port `.ckpt` basemodel written once, with seeded host
    RNGs: per-step losses within rtol 1e-4, the predict TSV's captions
    equal."""
    import shutil
    from vitcap_tpu_torch import run as TR
    from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB
    from vitcap_tpu_torch.models.vitcap import init_params
    _pipeline_dataset(root, SEED + 60, n_train=6, n_test=6, hw=(40, 48),
                      name="tinycoco")
    enc = os.path.join(root, "tiny_encoder")
    os.makedirs(enc)
    with open(os.path.join(enc, "config.json"), "w") as f:
        json.dump({"hidden_size": 32, "num_attention_heads": 4,
                   "intermediate_size": 64, "num_hidden_layers": 2,
                   "max_position_embeddings": 96, "type_vocab_size": 2,
                   "vocab_size": 30522, "layer_norm_eps": 1e-12,
                   "attention_probs_dropout_prob": 0.0}, f)
    shutil.copy(DEFAULT_VOCAB, enc)
    param = {"data": "tinycoco", "test_data": "tinycoco",
             "test_split": "test", "net": "tiny", "expid": "parity",
             "data_root": os.path.join(root, "data"),
             "text_encoder_type": enc, "train_crop_size": 32,
             "test_crop_size": 32, "max_seq_length": 26,
             "max_seq_a_length": 6, "max_gen_length": 6, "topk": 5,
             "split_blocks": 1, "decoder_layers": 2,
             "effective_batch_size": 2, "test_batch_size": 4,
             "max_iter": 3, "snapshot_steps": 2, "log_step": 1,
             "base_lr": 1e-3, "drop_out": 0.0, "num_workers": 1,
             "encode": "bert", "tag_loss_weight": 1.0,
             "compute_dtype": "float32", "image_backend": _image_backend(),
             "basemodel": os.path.join(root, "tiny_base.ckpt")}
    cfg = TR.create_pipeline(dict(param, device="cpu")).model_cfg
    model = init_params(cfg, torch.Generator().manual_seed(SEED + 61),
                        device="cpu")
    torch.save({"model": model.state_dict()}, param["basemodel"])
    out = {}
    for name, device in zip(("gpu", "cpu"), devices):
        p = dict(param, device=device,
                 output_root=os.path.join(root, f"tiny_{name}"))
        with _pipeline_probes({}, seeded=True) as rec:
            TR.pipeline_train_eval_multi(TINY_TEST_DATA, p)
        pip = TR.create_pipeline(dict(p, **TINY_TEST_DATA[0]))
        out[name] = {"losses": [s["loss"].item() for s in rec["steps"]],
                     "captions": [c[0]["caption"] for _, c in
                                  _predict_rows(pip, 6)]}
    gl, cl = out["gpu"]["losses"], out["cpu"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    if len(gl) != 3 or not rel <= 1e-4:
        raise AssertionError(f"tiny pipeline losses GPU {gl} vs CPU {cl}")
    if out["gpu"]["captions"] != out["cpu"]["captions"]:
        raise AssertionError(f"tiny pipeline captions GPU "
                             f"{out['gpu']['captions']} vs CPU "
                             f"{out['cpu']['captions']}")
    log(f"[pipeline] tiny config f32, GPU vs CPU: losses {gl} vs {cl} "
        f"(max relative difference {rel:.2e}, rtol 1e-4); the 6 captions "
        f"equal: {out['gpu']['captions'][:2]}...")
    return dict(out, max_rel_loss=rel)


# ---------------------------------------------------------------------------
# phase 15: constrained beam search (models/cbs.py)
# ---------------------------------------------------------------------------

CBS_BEAMS = 5                # beam_size = max(num_beams, 5)
CBS_MAX_CONS = 3             # max_given_constraints: 2^3 main states
CBS_NB = 2 ** CBS_MAX_CONS * 4 * CBS_BEAMS   # 160 beams an image
# a CBS batch on the fused engine: the encode and prefill, then 19 steps of
# 4 layers; every decode_attention launch over 10 beam groups an image
CBS_MODES = {"decode_attention[groups]": 4 * STEPS}
CBS_CLASSES = ("dog cat bird horse car bus train boat table bench clock "
               "kite pizza umbrella zebra lion elephant sheep cow bear "
               "bicycle laptop bottle chair").split()
CBS_TWO_WORD = ("cell phone", "teddy bear", "traffic light",
                "stop sign")
CBS_DIR = ROOT / "build" / "chip_smoke_cbs"


def phase_cbs_kernels(dev, rows, S=628, A=20, t=10):
    """decode_attention at constrained beam search's 160 beams an image (10
    groups of 16), B=64, S=628, 12 heads of 64, vs its plain version: bf16
    on the cluster kernel at least 99% bit-equal, f32 on the simple kernel
    within F32_TOL; times back to back and from a CUDA graph (bf16), the
    bound (the context once per image and head, the caption caches, the
    window in, the prev slot's k/v and the output out), no library
    yardstick (SDPA would repeat each image's context 160 times)."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.ops.decode_step import (decode_attention,
                                                  decode_attention_plain,
                                                  plan)
    g = torch.Generator().manual_seed(SEED + 15)
    nh, H, nb = 12, 768, CBS_NB
    Bb = B * nb
    t_dev = torch.tensor([t], dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        p = plan(S, nb, H // nh, A, dtype)
        if p.groups != 10 or bool(p.ranks) != (dtype == torch.bfloat16):
            raise AssertionError(f"decode_attention cbs {dn}: plan {p}")
        d = _decode_attention_inputs(dev, dtype, nb, t, S, A, H, g)
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        args = (d["ctx_k"], d["ctx_v"], d["bias"])
        ops.reset_counts()
        out = decode_attention(d["qkv"], *caps, *args, t_dev, nh)
        grouped = ops.mode_counts()["decode_attention[groups]"]
        ref = decode_attention_plain(d["qkv"], d["cap_k"], d["cap_v"], *args,
                                     t, nh)
        err = compare(f"decode_attention cbs {dn}", out, ref, dtype)
        if not (torch.equal(caps[0], d["cap_k"])
                and torch.equal(caps[1], d["cap_v"])):
            raise AssertionError(f"decode_attention cbs {dn}: caption "
                                 f"caches differ from plain")
        eq = (out == ref).float().mean().item()
        if p.ranks and (eq < 0.99 or grouped != 1):
            raise AssertionError(f"decode_attention cbs {dn}: {eq:.5f} of "
                                 f"outputs bit-equal, {grouped} grouped "
                                 f"launches")
        ms = cuda_ms(lambda i: decode_attention(d["qkv"], *caps, *args,
                                                t_dev, nh), 10)
        gms = graph_ms(lambda: decode_attention(d["qkv"], *caps, *args,
                                                t_dev, nh), 10)
        pms = cuda_ms(lambda i: decode_attention_plain(
            d["qkv"], *caps, *args, t, nh), 2)
        nbytes = (es * (2 * B * S * H + 2 * Bb * (t - 1) * H
                        + Bb * 2 * 3 * H + 2 * Bb * H + Bb * 2 * H)
                  + 4 * B * S)
        flops = 4.0 * Bb * 2 * (S + t) * H
        _row(rows, "decode_attention[groups]", "cbs160", dn,
             f"B={B} nb={nb} ({p.groups} groups) S={S} A={A} t={t} "
             f"heads=12x64", err, ms, pms, None, flops, nbytes)
        r = rows[-1]
        r.update(bit_equal=eq, graph_ms=gms, ranks=p.ranks, groups=p.groups)
        log(f"[cbs] decode_attention {nb} beams ({p.groups} groups, "
            f"{p.ranks} ranks) {dn} err {err:.3e}  bit-equal {eq:.6f}  "
            f"kernel {ms:.4f} ms (graph {gms:.4f})  plain {pms:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB)")
        del d, caps, out, ref
        torch.cuda.empty_cache()


def _cbs_files(keys, seed, root=CBS_DIR):
    """Synthetic detections for `keys` from `seed`: per image 3 classes of
    vocab words (one two-word class in three images of four) in boxes that
    do not overlap, and a blacklisted `person`, so the filter keeps 3
    constraints; the class hierarchy (every class a child of the root) and
    the constraint-to-token and wordform files."""
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    classes = list(CBS_CLASSES) + list(CBS_TWO_WORD)
    with open(root / "boxes.tsv", "w") as f:
        for i, k in enumerate(keys):
            names = list(rs.choice(CBS_CLASSES, 3 if i % 4 == 0 else 2,
                                   replace=False))
            if i % 4:
                names.append(CBS_TWO_WORD[i % len(CBS_TWO_WORD)])
            dets = [{"class": n, "conf": float(0.5 + 0.4 * rs.rand()),
                     "rect": [60 * j, 0, 60 * j + 50, 50]}
                    for j, n in enumerate(names)]
            dets.append({"class": "person", "conf": 0.99,
                         "rect": [0, 100, 50, 150]})
            f.write(f"{k}\t{json.dumps(dets)}\n")
    (root / "hierarchy.json").write_text(json.dumps(
        {"LabelName": "Entity",
         "Subcategory": [{"LabelName": c} for c in classes]}))
    from vitcap_tpu_torch.data.tokenization import CaptionDecoder
    vocab = CaptionDecoder().vocab
    words = sorted({w for c in classes for w in c.split()})
    (root / "c2t.tsv").write_text("".join(f"{w}\t{w}\n" for w in words))
    (root / "wf.tsv").write_text("".join(
        f"{w}\t{w},{w}s\n" if f"{w}s" in vocab else f"{w}\t{w}\n"
        for w in words))
    return root


def _cbs_decoder(root, sparse=True):
    """A CbsDecoder as the pipeline makes it (_make_cbs_decoder's
    defaults: NMS 0.85, 3 constraints, 2 to satisfy, 5 beams)."""
    from vitcap_tpu_torch.data.tokenization import CaptionDecoder
    from vitcap_tpu_torch.models import cbs as TC
    tok = CaptionDecoder()
    return TC.CbsDecoder(
        tok, TC.ConstraintFilter(str(root / "hierarchy.json"), 0.85,
                                 CBS_MAX_CONS),
        TC.FiniteStateMachineBuilder(
            tok, TC.load_wordforms(str(root / "c2t.tsv")),
            TC.load_wordforms(str(root / "wf.tsv")), CBS_MAX_CONS),
        TC.ConstraintBoxesReader(str(root / "boxes.tsv")),
        min_constraints_to_satisfy=2, beam_size=CBS_BEAMS, sparse=sparse)


def _cbs_met(decoder, keys, best, sep):
    """The constraints each chosen caption meets, replayed on its image's
    sparse FSM: the main-state bits of the state its words end in (None if
    a word has no transition)."""
    from vitcap_tpu_torch.models.cbs import build_sparse_fsm
    met = []
    for k, cons, ids in zip(keys, decoder._constraints(keys), best):
        fsm = build_sparse_fsm(decoder.builder, cons)
        nexts = {(f, w): t for f, t, w in fsm.edges}
        s = 0
        for w in ids.tolist():
            if w == sep:
                break
            if (s, w) in nexts:
                s = nexts[s, w]
            elif fsm.default_to[s] >= 0 and w not in fsm.removed[s]:
                s = int(fsm.default_to[s])
            else:
                s = None
                break
        met.append(None if s is None or s >= 2 ** CBS_MAX_CONS
                   else bin(s).count("1"))
    return met


def phase_cbs(dev, smi):
    """A CbsDecoder predict of 64 flagship images (bf16, random weights
    from the seed, uint8 384x384 images, synthetic detections: 3
    constraints an image) on the eager and the fused engine: one warm-up
    batch, then one batch timed on the host clock (FSM build, dispatch and
    collect) with its launches (set to 0 just before it; fused: exactly
    FUSED_PER_BATCH and every decode_attention over beam groups) and its
    peak memory, then one batch under torch.profiler (device busy time,
    idle share, device time by kernel); captions/s; every chosen caption
    replayed on its FSM meets min(n_cons, 2) constraints.  Returns the
    launch counts of the fused batch and the measurements."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models.cbs import put
    cfg, model = _flagship(dev)
    opts = _opts(cfg)
    keys = [f"cbs{i:03d}" for i in range(B)]
    root = _cbs_files(keys, SEED + 15)
    decoder = _cbs_decoder(root)
    rs = np.random.RandomState(SEED + 16)
    imgs = put(rs.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3))
               .astype(np.uint8), dev)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od = torch.zeros(B, od_len, dtype=torch.long, device=dev)
    tt = torch.ones_like(od)
    sl = torch.full((B,), cfg.max_seq_a_len, device=dev)
    t0 = time.perf_counter()
    _, n_cons = decoder.build_batch_fsm_sparse(keys)
    fsm_ms = (time.perf_counter() - t0) * 1e3
    if sorted(set(n_cons.tolist())) != [CBS_MAX_CONS]:
        raise AssertionError(f"cbs: constraints an image {n_cons}")

    def batch():
        out, n = decoder.dispatch(model, imgs, od, tt, sl, keys, cfg, opts)
        return decoder.collect(out, n, cfg)

    res, counts = {"fsm_build_ms": fsm_ms}, {}
    for name, fused in (("eager", False), ("fused", True)):
        with _engine(fused):
            batch()                                   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_counts()
            t0 = time.perf_counter()
            best, best_lp = batch()
            seconds = time.perf_counter() - t0
            got = dict(ops.launch_counts(), **ops.mode_counts())
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = dict(PER_BATCH if not fused else FUSED_PER_BATCH,
                        **{k: 0 for k in ops.mode_counts()})
            want.update(CBS_MODES if fused else {})
            if got != want:
                raise AssertionError(f"cbs {name}: launches {got} != {want}")
            counts[name] = got
            met = _cbs_met(decoder, keys, best, cfg.sep_token_id)
            need = [min(int(n), 2) for n in n_cons]
            if any(m is None or m < k for m, k in zip(met, need)):
                raise AssertionError(f"cbs {name}: constraints met {met}, "
                                     f"needed {need}")
            if not np.isfinite(best_lp).all():
                raise AssertionError(f"cbs {name}: log-probabilities "
                                     f"{best_lp}")
            prof = _profile(f"cbs_{name}", batch, reps=1)
            caps = [decoder.tokenizer.decode(c.tolist()) for c in best[:3]]
        res[name] = {"batch_s": seconds, "captions_per_s": B / seconds,
                     "peak_gib": peak, "launches": got,
                     "constraints_met": met, "profile": prof}
        log(f"[cbs] {name}: {B / seconds:.2f} captions/s (B={B}, "
            f"{CBS_NB} beams an image, bf16, one batch of {seconds:.3f} s "
            f"on the host clock), peak {peak:.2f} GiB, idle share "
            f"{prof['idle_share']:.4f}, constraints met "
            f"{sorted(set(met))} (FSM build {fsm_ms:.1f} ms) on {smi}")
        log(f"[cbs] {name}: launches {got}")
        log(f"[cbs] {name}: example captions (random weights): {caps}")
    del model, imgs
    torch.cuda.empty_cache()
    return counts["fused"], res


def phase_cbs_parity(dev, Bn=2):
    """f32: the sparse search against the dense one on the card (the
    flagship, B=2, the fused engine: decode_attention's simple kernel at
    160 beams), ids and log-probabilities equal on every live beam; then
    the tiny test configuration (the shipped vocab) on the card and on the
    CPU, CbsDecoder.decode's ids equal on both engines."""
    from vitcap_tpu_torch.models import cbs as TC
    from vitcap_tpu_torch.models.config import ModelConfig, tiny_config
    from vitcap_tpu_torch.models.vitcap import init_params
    keys = [f"cbs{i:03d}" for i in range(Bn)]
    root = _cbs_files(keys, SEED + 17)
    out = {}
    cfg = ModelConfig()                                   # f32
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    rs = np.random.RandomState(SEED + 18)
    imgs = TC.put(rs.randint(0, 256, (Bn, cfg.img_size, cfg.img_size, 3))
                  .astype(np.uint8), dev)
    od = torch.zeros(Bn, cfg.max_seq_len - cfg.max_seq_a_len,
                     dtype=torch.long, device=dev)
    sl = torch.full((Bn,), cfg.max_seq_a_len, device=dev)
    dec = _cbs_decoder(root)
    fsm, _ = dec.build_batch_fsm(keys)
    sfsm, _ = dec.build_batch_fsm_sparse(keys)
    with _engine(True):
        t0 = time.perf_counter()
        dense = TC.constrained_beam_search(
            model, imgs, od, None, sl, TC.put(fsm, dev), cfg, _opts(cfg),
            beam_size=CBS_BEAMS)
        torch.cuda.synchronize()
        out["dense_s"] = time.perf_counter() - t0
        sparse = TC.constrained_beam_search_sparse(
            model, imgs, od, None, sl,
            {k: TC.put(v, dev) for k, v in sfsm.items()}, cfg, _opts(cfg),
            beam_size=CBS_BEAMS)
    d_lp, s_lp = dense["logprobs"].cpu(), sparse["logprobs"].cpu()
    live = d_lp > -1e10
    same = torch.equal(dense["ids"].cpu()[live], sparse["ids"].cpu()[live])
    lp_err = (d_lp[live] - s_lp[live]).abs().max().item()
    log(f"[cbs] f32 B={Bn} sparse vs dense on the card: {int(live.sum())} "
        f"live beams, ids equal {same}, max lp diff {lp_err:.3e} (dense "
        f"search {out['dense_s']:.2f} s)")
    if not (same and lp_err <= 1e-4 and int(live.sum()) >= Bn * CBS_BEAMS):
        raise AssertionError("cbs: sparse search differs from dense")
    out.update(live_beams=int(live.sum()), lp_max_diff=lp_err)
    del model, dense, sparse
    torch.cuda.empty_cache()

    tcfg = tiny_config(vocab_size=30522)
    cpu_model = init_params(tcfg, torch.Generator().manual_seed(SEED), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    timgs = rs.randint(0, 256, (Bn, tcfg.img_size, tcfg.img_size, 3)) \
        .astype(np.uint8)
    tod = rs.randint(1, 30522, (Bn, tcfg.max_seq_len - tcfg.max_seq_a_len))
    for fused in (False, True):
        ids = []
        with _engine(fused):
            for model, d in ((gpu_model, dev), (cpu_model, "cpu")):
                args = [TC.put(a, d) for a in
                        (timgs, tod, np.ones_like(tod),
                         np.full(Bn, tcfg.max_seq_len))]
                ids.append(dec.decode(model, *args, keys, tcfg,
                                      _opts(tcfg))[0])
        same = np.array_equal(ids[0], ids[1])
        log(f"[cbs] tiny f32 {'fused' if fused else 'eager'} card vs CPU: "
            f"ids equal {same}")
        if not same:
            raise AssertionError("cbs: tiny card ids differ from the CPU's")
    out["tiny_card_equals_cpu"] = True
    import shutil
    shutil.rmtree(CBS_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: data parallelism (parallel/ on torch.distributed)
# ---------------------------------------------------------------------------

DP_TRAIN = 128               # phase 16's train images: 2 steps of 64
DP_TEST = 128                # and its predict: 4 batches of 32 on one rank
DP_TEST_BATCH = 32           # 2 full batches a rank at 2 ranks
DP_TIMEOUT = 600             # seconds a phase-16 child may take
DP_SITE = '''"""Loaded at the start of every Python process of chip_smoke.py phase
16's children (its directory is first on their PYTHONPATH): the
pipelines' host RNGs, unseeded in the package as in the JAX package, get
fixed seeds, so two runs read the same batches; every
torch.distributed.all_reduce is timed (synchronised, host clock) with
its bytes, written to $CHIP_SMOKE_DP_TIMES at exit."""
import atexit
import json
import os
import random
import time

import torch
import torch.distributed as dist

from vitcap_tpu_torch.data import tensorizers, transforms

_tensorizer_init = tensorizers.CaptionTensorizer.__init__
_transform_init = transforms.TrainImageTransform.__init__


def _seeded_tensorizer(self, *a, **kw):
    _tensorizer_init(self, *a, **kw)
    self.rng = random.Random(%(seed_t)d)


def _seeded_transform(self, *a, **kw):
    kw["seed"] = %(seed_i)d
    _transform_init(self, *a, **kw)


tensorizers.CaptionTensorizer.__init__ = _seeded_tensorizer
transforms.TrainImageTransform.__init__ = _seeded_transform

_all_reduce = dist.all_reduce
_timed = []


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize()


def _timed_all_reduce(t, *a, **kw):
    _sync(t)
    t0 = time.perf_counter()
    out = _all_reduce(t, *a, **kw)
    _sync(t)
    _timed.append({"bytes": t.numel() * t.element_size(),
                   "ms": (time.perf_counter() - t0) * 1e3,
                   "backend": dist.get_backend()})
    return out


dist.all_reduce = _timed_all_reduce


@atexit.register
def _dump():
    path = os.environ.get("CHIP_SMOKE_DP_TIMES")
    if path and _timed:
        with open(path + "." + os.environ.get("RANK", "none"), "w") as f:
            json.dump(_timed, f)
'''


def _dp_tiny_batch(cfg, dev):
    """8 rows from a numpy seed whose halves mask 1 and 3 tokens a row
    (the masked loss's normaliser differs between the halves)."""
    rs = np.random.RandomState(SEED + 62)
    T, A, n = cfg.max_seq_len, cfg.max_seq_a_len, 8
    masked_pos = np.zeros((n, T), np.int64)
    masked_pos[:n // 2, 2] = 1
    masked_pos[n // 2:, [1, 3, 4]] = 1
    label = (rs.rand(n, cfg.tag_vocab_size) < 0.05).astype(np.float32)
    label[:, 5] = 1.0
    batch = {
        "image": rs.randint(0, 256, (n, cfg.img_size, cfg.img_size, 3))
                 .astype(np.uint8),
        "input_ids": rs.randint(4, cfg.vocab_size, (n, T)),
        "token_type_ids": np.concatenate(
            [np.zeros((n, A), np.int64), np.ones((n, T - A), np.int64)], 1),
        "seq_a_len": np.full((n,), A), "seq_len": np.full((n,), T),
        "masked_pos": masked_pos,
        "masked_ids": rs.randint(1, cfg.vocab_size,
                                 (n, cfg.max_masked_tokens)),
        "label": label,
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _dp_tiny_cfg():
    from vitcap_tpu_torch.models.config import tiny_config
    return tiny_config(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0, tag_loss_weight=1.0)


def _dp_flagship_cfg():
    """The bench training line at dropout 0, so the 2 x 32 and 1 x 64 steps
    draw no masks."""
    from vitcap_tpu_torch.models.config import ModelConfig
    return ModelConfig(dtype="bfloat16", tag_loss_weight=1.0,
                       attention_probs_dropout_prob=0.0,
                       hidden_dropout_prob=0.0)


def _dp_steps(cfg, dev, batch, steps, rank=0, world=1):
    """`steps` train steps of this rank's rows of `batch` from the seed's
    weights (replicated from rank 0 in a group): per-step losses, launches
    and the state."""
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.parallel.mesh import local_rows, replicate_params
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state,
                                                    make_train_step)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    replicate_params(model)
    state = init_train_state(model, None)
    step = make_train_step(cfg, TrainHyper(base_lr=1e-4, max_iter=1000))
    mine = local_rows(batch, rank, world)
    losses, launches = [], []
    for _ in range(steps):
        (state, m), c = _counted(lambda: step(state, mine, False))
        losses.append(m["loss"].item())
        launches.append({k: n for k, n in c.items() if n})
    return losses, launches, state


def _flat_params(model):
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}


def dp_worker(rank, world, port, workdir):
    """One rank of phase 16b (`chip_smoke.py --dp-worker RANK WORLD PORT
    DIR`), its job in DIR/job.json: joins a Gloo group on the job's device
    (cuda:0 for both ranks: NCCL refuses two ranks on one card), takes the
    tiny f32 data-parallel step and 2 steps of the job's flagship config
    on its rows of the job's batch, then runs the pipeline's predict at
    `world` ranks; writes DIR/worker_<rank>.json and DIR/tiny_<rank>.pt."""
    rank, world = int(rank), int(world)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(ROOT))
    from vitcap_tpu_torch import run as TR
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.parallel import distributed as PD
    from vitcap_tpu_torch.solver import train_step as TTS
    from vitcap_tpu_torch.utils import common as UC
    UC._LOGGING_INITED = True      # the pipelines log to their folders only
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    dev = torch.device(job["device"])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    PD.ensure_init_distributed(backend="gloo", device=dev)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    try:
        cfg = _dp_tiny_cfg()
        losses, _, state = _dp_steps(cfg, dev, _dp_tiny_batch(cfg, dev), 1,
                                     rank, world)
        out["tiny_loss"] = losses[0]
        torch.save(_flat_params(state.model),
                   os.path.join(workdir, f"tiny_{rank}.pt"))
        del state

        timed = []
        reduce_grads = TTS.all_reduce_grads

        def timed_reduce(grads, extras=None, group=None):
            sync()
            t0 = time.perf_counter()
            res = reduce_grads(grads, extras, group)
            sync()
            timed.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "bytes": sum(g.numel() * g.element_size()
                                       for g in grads.values())})
            return res
        TTS.all_reduce_grads = timed_reduce
        cfg = ModelConfig(**job["flagship_cfg"])
        t0 = time.perf_counter()
        losses, launches, state = _dp_steps(
            cfg, dev, _train_batch(cfg, job["rows"], SEED + 61, dev), 2,
            rank, world)
        sync()
        out.update(flagship_losses=losses, flagship_launches=launches,
                   flagship_s=time.perf_counter() - t0, all_reduce=timed)
        TTS.all_reduce_grads = reduce_grads
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        out["results"] = TR.pipeline_train_eval_multi(PIPE_TEST_DATA,
                                                      job["pipeline"])
        out["predict_s"] = time.perf_counter() - t0
        PD.barrier()
    finally:
        PD.shutdown()
    with open(os.path.join(workdir, f"worker_{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


def _run_children(cmds, env, what, logdir):
    """Run the commands together, their output to logdir; wait up to
    DP_TIMEOUT s.  If one fails or the time runs out, kill the rest (a
    rank left alone would wait in a collective) and raise with the
    output."""
    logs = [Path(logdir) / f"{what.replace(' ', '_')}_{i}.log"
            for i in range(len(cmds))]
    procs = []
    for c, lg in zip(cmds, logs):
        with open(lg, "w") as f:
            procs.append(subprocess.Popen(c, cwd=str(ROOT), env=env,
                                          stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(c, p.returncode, lg.read_text()[-6000:])
           for c, p, lg in zip(cmds, procs, logs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{what}: " + "\n".join(
            f"{' '.join(c)} exited {rc}\n{out}" for c, rc, out in bad))


def _snapshot_diff(a, b):
    """Names whose tensors differ between two snapshots (model, both
    moments), and whether the generators' states and steps agree."""
    sa = torch.load(a, map_location="cpu", weights_only=True)
    sb = torch.load(b, map_location="cpu", weights_only=True)
    bad = [n for n in sa["model"] if not torch.equal(sa["model"][n],
                                                     sb["model"][n])]
    for k in ("mu", "nu"):
        bad += [f"{k} {n}" for n in sa["opt"][k]
                if not torch.equal(sa["opt"][k][n], sb["opt"][k][n])]
    same_rest = (sa["opt"]["step"] == sb["opt"]["step"]
                 and sa["iteration"] == sb["iteration"]
                 and torch.equal(sa["generator"], sb["generator"]))
    return bad, same_rest, len(sa["model"])


def phase_dp(dev, smi):
    """Data parallelism at the flagship (384 px, bf16, the pipeline's
    line), on a synthetic TSV dataset (DP_TRAIN + DP_TEST JPEGs from the
    seed; the children's host RNGs seeded by DP_SITE, one loader thread):
    a. one rank over NCCL: `python -m torch.distributed.run --standalone
       --nproc_per_node 1 -m vitcap_tpu_torch.run -c dp.yaml` (2 train
       steps, a 128-image predict in batches of 32, evaluate), then the
       same YAML with no launcher (`-p` names another expid): the final
       snapshots bit-equal, the predict rows equal; the NCCL all-reduce's
       ms a step and its bytes;
    b. two ranks on cuda:0 over Gloo (dp_worker, which makes its group
       with backend="gloo"): the tiny f32 step at 2 x 4 rows against this
       process's 1 x 8 (params rtol 2e-4 / atol 1e-6, loss rtol 1e-5); 2
       flagship steps at 2 x 32 rows against 1 x 64 (dropout 0; losses
       within 2e-2 relative; each rank's launches a step equal the 1 x 64
       step's); the pipeline's predict at 2 ranks from a's snapshot: the
       merged TSV equals a's rows key for key, no shard left.  Two ranks on
       one card measure the collective's cost, not scaling."""
    import dataclasses
    import shutil
    import tempfile
    from vitcap_tpu_torch.data.tsv import tsv_reader
    (ROOT / "build").mkdir(exist_ok=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=ROOT / "build")
    res = {}
    try:
        t0 = time.perf_counter()
        _pipeline_dataset(root, SEED + 60, n_train=DP_TRAIN, n_test=DP_TEST)
        site = Path(root) / "site"
        site.mkdir()
        (site / "sitecustomize.py").write_text(
            DP_SITE % {"seed_t": SEED + 41, "seed_i": SEED + 42})
        env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{ROOT}",
                   CHIP_SMOKE_DP_TIMES=str(Path(root) / "times"))
        env.pop("VITCAP_DECODE_FUSED", None)
        import yaml
        param = _pipeline_param(root, expid="dp_nccl", max_iter=2,
                                snapshot_steps=100, num_workers=1,
                                test_batch_size=DP_TEST_BATCH)
        yml = Path(root) / "dp.yaml"
        yml.write_text(yaml.safe_dump({
            "type": "pipeline_train_eval_multi",
            "all_test_data": PIPE_TEST_DATA, "param": param}))
        res["dataset_s"] = time.perf_counter() - t0

        # a. one rank over NCCL and the run without a launcher, side by
        # side on the card
        t0 = time.perf_counter()
        _run_children([[sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", "1", "-m",
                        "vitcap_tpu_torch.run", "-c", str(yml)],
                       [sys.executable, "-m", "vitcap_tpu_torch.run", "-c",
                        str(yml), "-p", "param: {expid: dp_plain}"]], env,
                      "one rank", root)
        res["one_rank_runs_s"] = time.perf_counter() - t0
        out = Path(root) / "output"
        snaps = {e: out / f"synthcoco_flagship_{e}" / "snapshot"
                 for e in ("dp_nccl", "dp_plain")}
        final = {e: s / "model_iter_0000002.ckpt" for e, s in snaps.items()}
        bad, same_rest, n_tensors = _snapshot_diff(final["dp_nccl"],
                                                   final["dp_plain"])
        if bad or not same_rest:
            raise AssertionError(f"dp: 1-rank NCCL snapshot differs from the "
                                 f"run without a launcher: {bad[:8]}, rest "
                                 f"same {same_rest}")
        rows = {}
        for e, s in snaps.items():
            preds = list(s.glob("*.predict.tsv"))
            if len(preds) != 1 or list(s.glob("*predict.tsv_*_*.tsv")):
                raise AssertionError(f"dp {e}: predict files "
                                     f"{sorted(p.name for p in s.iterdir())}")
            rows[e] = [(k, json.loads(v)[0]["caption"])
                       for k, v in tsv_reader(str(preds[0]))]
        keys = [f"test{i:05d}" for i in range(DP_TEST)]
        if [k for k, _ in rows["dp_nccl"]] != keys \
                or rows["dp_nccl"] != rows["dp_plain"]:
            raise AssertionError("dp: 1-rank NCCL predict rows differ")
        nccl = json.loads(Path(str(env["CHIP_SMOKE_DP_TIMES"]) + ".0")
                          .read_text())
        grad = [t for t in nccl if t["bytes"] > 1 << 20]
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if len(grad) != 2 or any(t["backend"] != backend for t in grad):
            raise AssertionError(f"dp: NCCL all-reduces {nccl}")
        res["nccl"] = {"all_reduce": nccl, "snapshot_tensors": n_tensors,
                       "grad_ms": [t["ms"] for t in grad],
                       "grad_bytes": grad[0]["bytes"]}
        log(f"[dp] dataset of {DP_TRAIN} + {DP_TEST} JPEGs made in "
            f"{res['dataset_s']:.1f} s")
        log(f"[dp] a. 1 rank over NCCL (torchrun) and no launcher, side by "
            f"side, {res['one_rank_runs_s']:.1f} s (2 flagship steps of {B},"
            f" a {DP_TEST}-image predict, evaluate; each a fresh process): "
            f"final snapshots bit-equal ({n_tensors} parameters, both "
            f"moments, the generator), predict rows equal")
        log(f"[dp] a. NCCL all-reduce of the gradient bucket, 1 rank: "
            f"{[round(t, 3) for t in res['nccl']['grad_ms']]} ms a step for "
            f"{grad[0]['bytes'] / 2 ** 20:.1f} MiB (synchronised, host "
            f"clock, beside the other run), on {smi}")

        # b. references in this process (no group): 1 x 8 tiny, 1 x 64
        cfg = _dp_tiny_cfg()
        ref_loss, _, st = _dp_steps(cfg, dev, _dp_tiny_batch(cfg, dev), 1)
        ref_tiny = _flat_params(st.model)
        del st
        cfg = _dp_flagship_cfg()
        ref_losses, ref_launch, st = _dp_steps(
            cfg, dev, _train_batch(cfg, B, SEED + 61, dev), 2)
        del st
        torch.cuda.empty_cache()

        # b. two ranks on cuda:0 over Gloo
        p2 = _pipeline_param(root, expid="dp_gloo", max_iter=2,
                             num_workers=1, test_batch_size=DP_TEST_BATCH,
                             device="cuda:0")
        snap2 = out / "synthcoco_flagship_dp_gloo" / "snapshot"
        snap2.mkdir(parents=True)
        (snap2 / "model_iter_0000002.ckpt").symlink_to(final["dp_nccl"])
        (Path(root) / "job.json").write_text(json.dumps({
            "device": str(dev), "rows": B, "pipeline": p2,
            "flagship_cfg": dataclasses.asdict(_dp_flagship_cfg())}))
        port = str(_free_port())
        t0 = time.perf_counter()
        _run_children([[sys.executable, str(ROOT / "chip_smoke.py"),
                        "--dp-worker", str(r), "2", port, root]
                       for r in range(2)], env, "2 ranks over Gloo", root)
        res["gloo_run_s"] = time.perf_counter() - t0
        w = [json.loads((Path(root) / f"worker_{r}.json").read_text())
             for r in range(2)]
        if any(x["backend"] != "gloo" for x in w):
            raise AssertionError(f"dp: backends {[x['backend'] for x in w]}")
        tiny = [torch.load(Path(root) / f"tiny_{r}.pt", weights_only=True)
                for r in range(2)]
        worst = 0.0
        for n, want in ref_tiny.items():
            if not torch.equal(tiny[0][n], tiny[1][n]):
                raise AssertionError(f"dp: ranks' parameters differ at {n}")
            torch.testing.assert_close(tiny[0][n], want, rtol=2e-4,
                                       atol=1e-6, msg=f"dp tiny {n}")
            worst = max(worst, (tiny[0][n] - want).abs().max().item())
        if not math.isclose(w[0]["tiny_loss"], ref_loss[0], rel_tol=1e-5):
            raise AssertionError(f"dp tiny loss {w[0]['tiny_loss']} vs "
                                 f"{ref_loss[0]}")
        for x in w:
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(x["flagship_losses"], ref_losses)]
            if max(rel) > 2e-2:
                raise AssertionError(f"dp flagship losses {x} vs "
                                     f"{ref_losses}")
            for c in x["flagship_launches"]:
                if c != ref_launch[0]:
                    raise AssertionError(f"dp rank {x['rank']} launches {c}"
                                         f" != the 1 x {B} step's "
                                         f"{ref_launch[0]}")
        preds = list(snap2.glob("*.predict.tsv"))
        left = list(snap2.glob("*predict.tsv_*_*.tsv"))
        if len(preds) != 1 or left:
            raise AssertionError(f"dp 2 ranks: predict files "
                                 f"{sorted(p.name for p in snap2.iterdir())}")
        merged = [(k, json.loads(v)[0]["caption"])
                  for k, v in tsv_reader(str(preds[0]))]
        if merged != rows["dp_nccl"]:
            diff = sum(a != b for a, b in zip(merged, rows["dp_nccl"]))
            raise AssertionError(f"dp: 2-rank merged predict differs from "
                                 f"the 1-rank rows ({diff} rows, "
                                 f"{len(merged)} merged)")
        gloo = [t["ms"] for x in w for t in x["all_reduce"]]
        res["gloo"] = {"workers": w, "tiny_max_abs_diff": worst,
                       "ref_losses": ref_losses, "ref_launches": ref_launch,
                       "grad_ms": gloo}
        log(f"[dp] b. 2 ranks on cuda:0 over Gloo, {res['gloo_run_s']:.1f} s"
            f" (2 processes): tiny f32 2 x 4 == 1 x 8 (params max abs diff "
            f"{worst:.3e}, loss {w[0]['tiny_loss']:.7f} vs "
            f"{ref_loss[0]:.7f})")
        log(f"[dp] b. flagship bf16 2 x {B // 2} losses "
            f"{[round(v, 5) for v in w[0]['flagship_losses']]} vs 1 x {B} "
            f"{[round(v, 5) for v in ref_losses]}; launches per rank and "
            f"step {w[0]['flagship_launches'][0]} (== the 1 x {B} step's)")
        log(f"[dp] b. Gloo all-reduce of the gradient bucket (the card's "
            f"tensors through the host): {[round(t, 1) for t in gloo]} ms "
            f"(ranks 0, 1; 2 steps), on {smi}; two ranks on one card "
            f"measure the collective's cost, not scaling")
        log(f"[dp] b. predict at 2 ranks (2 x {DP_TEST // 2} images in "
            f"batches of {DP_TEST_BATCH}): merged rows == the 1-rank rows "
            f"({len(merged)}), no shard left; rank 0 report "
            f"{json.dumps({k: v for k, v in w[0]['results'][0].items() if k != '_impl'})}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# phase 17: module 12 (models/pretrained.py, models/scan.py)
# ---------------------------------------------------------------------------

PRETRAINED_DIR = ROOT / "build" / "chip_smoke_pretrained"
SCAN_TRAIN_B = 128           # SCAN's training batch (the authors')
SCAN_IMAGES, SCAN_CAPS = 1000, 5000    # COCO 1K: 5 captions an image
SCAN_CHUNK = 32              # captions a scoring chunk at 1000 images


def phase_pretrained(dev, smi):
    """save_pretrained from the card and from_pretrained onto it at the
    flagship: every parameter bit-equal, and one greedy batch (8 images,
    eager engine) of the reloaded model gives the original's ids."""
    import shutil
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import decode as TD
    from vitcap_tpu_torch.models import pretrained as P
    cfg, model = _flagship(dev)
    shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.save_pretrained(str(PRETRAINED_DIR), model, cfg)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = (PRETRAINED_DIR / P.WEIGHTS_NAME).stat().st_size
        t0 = time.perf_counter()
        model2, cfg2 = P.from_pretrained(str(PRETRAINED_DIR), device=dev)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
    if cfg2 != cfg:
        raise AssertionError("pretrained: config differs")
    pa, pb = dict(model.named_parameters()), dict(model2.named_parameters())
    bad = [n for n in pa if pb[n].device != pa[n].device
           or not torch.equal(pa[n], pb[n])]
    if pa.keys() != pb.keys() or bad:
        raise AssertionError(f"pretrained: parameters differ: {bad[:8]}")
    rs = np.random.RandomState(SEED + 71)
    n = 8
    imgs = torch.from_numpy(rs.randint(0, 256, (n, cfg.img_size,
                                                 cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.from_numpy(rs.randint(999, min(9000, cfg.vocab_size),
                                     (n, cfg.max_seq_len
                                      - cfg.max_seq_a_len))).to(dev)
    sl = torch.full((n,), cfg.max_seq_len, device=dev)
    ids = []
    with _engine(fused=False):
        for m in (model, model2):
            ops.reset_counts()
            out = TD.generate(m, imgs, od, None, sl, cfg, _opts(cfg))
            ids.append(out["ids"].cpu())
            counts = ops.launch_counts()
            if not all(counts[k] for k in ("gemm", "layer_norm",
                                           "attention")):
                raise AssertionError(f"pretrained greedy launches {counts}")
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError("pretrained: greedy ids differ after reload")
    res = {"save_ms": save_ms, "load_ms": load_ms, "bytes": nbytes,
           "params": sum(p.numel() for p in pa.values())}
    log(f"[pretrained] save_pretrained {save_ms:.1f} ms, from_pretrained "
        f"{load_ms:.1f} ms (init on the card + load), {nbytes / 2 ** 20:.1f} "
        f"MiB pytorch_model.bin, {res['params']} parameters bit-equal; "
        f"greedy ids of {n} images equal after the reload; on {smi}")
    return res


def _scan_captions(rs, n, cfg, lmin=8, lmax=30):
    lens = rs.randint(lmin, lmax + 1, n)
    ids = rs.randint(1, cfg.vocab_size, (n, lmax))
    ids[np.arange(lmax)[None] >= lens[:, None]] = 0
    return torch.from_numpy(ids), torch.from_numpy(lens)


def phase_scan(dev, smi):
    """SCAN at the authors' COCO t2i configuration (ScanConfig()): 36
    regions of 2048 (non-negative synthetic features), embed 1024, words
    300, a bi-GRU, captions of 8-30 tokens, all from the seed.  5 Adam
    steps (lr 2e-4) at batch 128, losses finite; the scores of 1000
    images x 5000 captions (COCO 1K) in chunks of SCAN_CHUNK captions:
    ms, peak memory, R@1/5/10; f32 scores card vs CPU at 8 x 40 within
    1e-4."""
    import dataclasses
    from vitcap_tpu_torch.models import scan as S
    cfg = S.ScanConfig()
    model = S.init_scan_params(cfg, torch.Generator().manual_seed(SEED), dev)
    rs = np.random.RandomState(SEED + 72)
    feats = torch.from_numpy(rs.rand(SCAN_TRAIN_B, 36, cfg.img_dim)
                             .astype(np.float32)).to(dev)
    ids, lens = (t.to(dev) for t in _scan_captions(rs, SCAN_TRAIN_B, cfg))
    opt = torch.optim.Adam(model.parameters(), lr=2e-4)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = S.scan_forward(model, feats, None, ids, lens, cfg)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"scan losses {losses}")
    del opt, loss
    torch.cuda.empty_cache()

    feats = torch.from_numpy(rs.rand(SCAN_IMAGES, 36, cfg.img_dim)
                             .astype(np.float32)).to(dev)
    ids, lens = (t.to(dev) for t in _scan_captions(rs, SCAN_CAPS, cfg))
    score_cfg = dataclasses.replace(cfg, cap_chunk=SCAN_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        img_emb = S.encode_image(model, feats, cfg)
        cap_emb = S.encode_text(model, ids, lens, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores = S.scan_scores(img_emb, None, cap_emb, lens, score_cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if scores.shape != (SCAN_IMAGES, SCAN_CAPS) \
            or not torch.isfinite(scores).all():
        raise AssertionError(f"scan scores {scores.shape}")
    t3 = time.perf_counter()
    rec = S.retrieval_metrics(scores)
    metrics_s = time.perf_counter() - t3
    del feats, img_emb, cap_emb, scores

    cpu = copy.deepcopy(model).cpu()
    f8 = rs.rand(8, 36, cfg.img_dim).astype(np.float32)
    i40, l40 = _scan_captions(rs, 40, cfg)
    got, ref = [], []
    with torch.no_grad():
        for m, d, into in ((model, dev, got), (cpu, "cpu", ref)):
            ie = S.encode_image(m, torch.from_numpy(f8).to(d), cfg)
            ce = S.encode_text(m, i40.to(d), l40.to(d), cfg)
            into.append(S.scan_scores(ie, None, ce, l40.to(d), cfg).cpu())
    err = (got[0] - ref[0]).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"scan f32 card vs CPU: max abs err {err:.3e}")
    res = {"train_losses": losses, "train_step_ms": step_ms,
           "train_peak_gib": train_peak,
           "encode_ms": (t1 - t0) * 1e3, "score_ms": (t2 - t1) * 1e3,
           "score_peak_gib": peak, "cap_chunk": SCAN_CHUNK,
           "recall": rec, "metrics_s": metrics_s, "parity_max_abs_err": err}
    log(f"[scan] 5 Adam steps at batch {SCAN_TRAIN_B} (36 x 2048 regions, "
        f"bi-GRU, embed 1024): losses {[round(v, 4) for v in losses]}, step "
        f"ms {[round(v, 1) for v in step_ms]}, peak {train_peak:.2f} GiB")
    log(f"[scan] {SCAN_IMAGES} images x {SCAN_CAPS} captions (f32, chunks "
        f"of {SCAN_CHUNK}): encode {res['encode_ms']:.1f} ms, score "
        f"{res['score_ms']:.1f} ms (synchronised, host clock), peak "
        f"{peak:.2f} GiB; i2t R@1/5/10 {rec['i2t_R@1']:.2f} / "
        f"{rec['i2t_R@5']:.2f} / {rec['i2t_R@10']:.2f}, t2i "
        f"{rec['t2i_R@1']:.2f} / {rec['t2i_R@5']:.2f} / "
        f"{rec['t2i_R@10']:.2f} (random weights); on {smi}")
    log(f"[scan] f32 scores card vs CPU at 8 x 40: max abs err {err:.3e}")
    return res


# ---------------------------------------------------------------------------
# phase 18: the model zoo (module 13 part 1)
# ---------------------------------------------------------------------------

ZOO_B = 64                   # images a zoo batch
ZOO_TIMED = 5                # batches timed with CUDA events (median)
# (name, image size): the ViT family on the card, bf16
ZOO_VITS = [("vit_large_patch16_384", 384),
            ("vit_large_patch16_384", 512),
            ("vit_huge_patch14_224_in21k", 224),
            ("vit_small_patch16_224", 224),
            ("vit_base_resnet50_384", 384),
            ("vit_deit_base_distilled_patch16_384", 384)]
ZOO_CNNS = ["resnet50", "t2t_vit_t_14"]
# the kernel rows at the zoo's new shapes: gemm (name, tokens, K, N,
# epilogue), attention (name, heads, head dim, L), layer_norm (name, H, L)
ZOO_GEMMS = [("vit-l qkv", 577, 1024, 3072, {}),
             ("vit-l proj+res", 577, 1024, 1024, dict(residual=True)),
             ("vit-l fc1+gelu", 577, 1024, 4096, dict(gelu=True)),
             ("vit-l fc2+res", 577, 4096, 1024, dict(residual=True)),
             ("vit-h qkv", 257, 1280, 3840, {}),
             ("vit-h proj+res", 257, 1280, 1280, dict(residual=True)),
             ("vit-h fc1+gelu", 257, 1280, 5120, dict(gelu=True)),
             ("vit-h fc2+res", 257, 5120, 1280, dict(residual=True))]
ZOO_ATTN = [("attention", "zoo vit-l hd64", 16, 64, 577),
            ("attention[hd>64]", "zoo hd80", 16, 80, 257),
            ("attention[hd>64]", "zoo hd96", 8, 96, 197)]
ZOO_LN = [("layer_norm", "zoo h1024", 1024, 577),
          ("layer_norm[wide]", "zoo h1280", 1280, 257)]


def _zoo_images(n, size, seed, dev):
    """uint8 images made from the seed, moved to the card and normalised
    there to [-1, 1] in f32 (the captioner's (x / 255 - 0.5) / 0.5)."""
    rs = np.random.RandomState(seed)
    u8 = torch.from_numpy(rs.randint(0, 256, (n, size, size, 3))
                          .astype(np.uint8)).to(dev)
    return u8.float().div_(127.5).sub_(1.0)


def phase_zoo_kernels(dev, rows, Bn=None):
    """The kernels at the model zoo's new shapes vs their plain versions,
    B=64, with bounds and yardsticks: the gemm at ViT-L/16-384's and
    ViT-H/14's four products (bf16), attention at ViT-L's 16 heads of 64
    (L 577) and at head dims 80 (ViT-H/14: 16 heads, L 257, Lp 272) and 96
    (the old ViT-S/16: 8 heads, L 197, Lp 208), each on the instance of
    its own width (ops/attention.py plan; the row's `instance`), and the
    LayerNorm at H 1024 and H 1280 (rows wider than the register path),
    bf16 and f32."""
    from vitcap_tpu_torch.ops.attention import (attention, attention_plain,
                                                plan as attention_plan)
    from vitcap_tpu_torch.ops.fused_block import pad_len
    from vitcap_tpu_torch.ops.gemm import gemm, gemm_plain
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    Bn = Bn or ZOO_B
    g = torch.Generator().manual_seed(SEED + 40)
    first = len(rows)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    for name, L, K, N, epi in ZOO_GEMMS:
        M = Bn * pad_len(L)
        a = [rnd(M, K, dtype=torch.bfloat16) for _ in range(2)]
        w = rnd(N, K, scale=0.02, dtype=torch.bfloat16)
        b = rnd(N, scale=0.02)
        r = (rnd(M, N, dtype=torch.bfloat16) if epi.get("residual")
             else None)
        kw = dict(epi, residual=r)
        out, ref = gemm(a[0], w, b, **kw), gemm_plain(a[0], w, b, **kw)
        err = compare(f"gemm {name}", out, ref, torch.bfloat16)
        eq = _bits(f"gemm {name}", out, ref)
        ms = cuda_ms(lambda i: gemm(a[i % 2], w, b, **kw), 10)
        pms = cuda_ms(lambda i: gemm_plain(a[i % 2], w, b, **kw), 10)
        bd = b.to(torch.bfloat16)
        lms = cuda_ms(lambda i: F.linear(a[i % 2], w, bd), 10)
        nbytes = 2 * (M * K + N * K + M * N * (2 if r is not None else 1)
                      ) + 4 * N
        _row(rows, "gemm", name, "bf16", f"M={M} K={K} N={N}", err, ms, pms,
             lms, 2.0 * M * K * N, nbytes)
        rows[-1]["bit_equal"] = eq
        del a, w, r, out, ref
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        for kname, name, H, L in ZOO_LN:
            M = Bn * pad_len(L)
            x = [rnd(M, H, scale=3.0, dtype=dtype) + 1 for _ in range(2)]
            gm, bt = rnd(H) + 1, rnd(H)
            err = compare(f"layer_norm {name} {dn}",
                          layer_norm(x[0], gm, bt, 1e-6, dtype),
                          layer_norm_plain(x[0], gm, bt, 1e-6, dtype), dtype)
            ms = cuda_ms(lambda i: layer_norm(x[i % 2], gm, bt, 1e-6, dtype),
                         10)
            pms = cuda_ms(lambda i: layer_norm_plain(x[i % 2], gm, bt, 1e-6,
                                                     dtype), 10)
            gl, bl = gm.to(dtype), bt.to(dtype)
            lms = cuda_ms(lambda i: F.layer_norm(x[i % 2], (H,), gl, bl,
                                                 1e-6), 10)
            _row(rows, kname, name, dn, f"rows={M} H={H}", err, ms, pms, lms,
                 8.0 * M * H, M * H * 2 * es + 8 * H)
            del x
        for kname, name, nh, hd, L in ZOO_ATTN:
            Lp, H = pad_len(L), nh * hd
            if attention_plan(hd) != hd:
                raise AssertionError(f"attention {name}: head dim {hd} on "
                                     f"the {attention_plan(hd)}-column "
                                     f"instance")
            slab = [rnd(Bn, Lp, 3 * H, dtype=dtype) for _ in range(2)]
            out = attention(slab[0], nh, L)
            ref = attention_plain(slab[0], nh, L)
            err = compare(f"{kname} {name} {dn}", out, ref, dtype)
            eq = _bits(f"{kname} {name}", out, ref)
            del out, ref
            ms = cuda_ms(lambda i: attention(slab[i % 2], nh, L), 5)
            pms = cuda_ms(lambda i: attention_plain(slab[i % 2], nh, L), 3)
            mask = torch.zeros(Bn, 1, Lp, Lp, device=dev, dtype=dtype)
            mask[..., L:] = float("-inf")
            qkv = [s.view(Bn, Lp, 3, nh, hd).permute(2, 0, 3, 1, 4)
                   for s in slab]
            lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                qkv[i % 2][0], qkv[i % 2][1], qkv[i % 2][2],
                attn_mask=mask), 5)
            _row(rows, kname, name, dn,
                 f"B={Bn} L={L} Lp={Lp} heads={nh}x{hd}", err, ms, pms, lms,
                 4.0 * Bn * nh * Lp * L * hd, es * Bn * Lp * 4 * H)
            rows[-1].update(bit_equal=eq, instance=attention_plan(hd))
            del slab, qkv, mask
        torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[zoo-kernel] {r['kernel']:18s} {r['case']:16s} "
            f"{r['dtype']:4s} {r['shape']:36s} err {r['max_abs_err']:.3e}  "
            f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})"
            + (f"  bit-equal {r['bit_equal']:.6f}" if r.get("bit_equal")
               else ""))


@contextlib.contextmanager
def _zoo_plain_versions():
    """The fused blocks' composition on the kernels' plain versions
    (ops/fused_block.py PLAIN), on the card: the blocks' plain version,
    rounding where the kernels round."""
    from vitcap_tpu_torch.ops import fused_block as FB
    kernels = FB.KERNELS
    FB.KERNELS = FB.PLAIN
    try:
        yield
    finally:
        FB.KERNELS = kernels


def _zoo_plain_block(blk, x, num_heads, ln_eps, l_actual=0):
    """models.layers' plain chain on the valid rows of a pre-padded x."""
    from vitcap_tpu_torch.models import layers as TL
    L = l_actual or x.shape[1]
    y = TL._vit_block_plain(blk, x[:, :L], num_heads, ln_eps)
    return F.pad(y, (0, 0, 0, x.shape[1] - L)) if L < x.shape[1] else y


@contextlib.contextmanager
def _zoo_plain_blocks():
    """The zoo's ViT blocks on the plain chain with the attention's plain
    version: the reference a kernel forward is held to (no launch)."""
    from vitcap_tpu_torch.models import registry as TR
    kernel_block = TR.vit_block
    TR.vit_block = _zoo_plain_block
    try:
        with _plain_attention():
            yield
    finally:
        TR.vit_block = kernel_block


def _zoo_want(spec, L):
    """A ViT batch's launches and modes: per block 4 gemm, 2 layer_norm,
    1 attention; the head dim past 64 and rows past 1024 in their modes,
    padded lengths past 1024 in attention[long]."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.ops.fused_block import pad_len
    d = spec.depth
    want = {"gemm": 4 * d, "layer_norm": 2 * d, "attention": d,
            "attention_bwd": 0, "decode_attention": 0}
    want.update({k: 0 for k in ops.mode_counts()})
    want["attention[hd>64]"] = d if spec.hidden_size // spec.num_heads > 64 \
        else 0
    want["layer_norm[wide]"] = 2 * d if spec.hidden_size > 1024 else 0
    want["attention[long]"] = d if pad_len(L) > 1024 else 0
    return want


def _zoo_vit_flops(spec, L, Bn):
    """A batch's operations: the blocks' four products over the padded
    rows and the attention's two over the padded queries and L keys (the
    stem, patch embedding and head aside)."""
    from vitcap_tpu_torch.ops.fused_block import pad_len
    H, I, Lp = spec.hidden_size, spec.intermediate_size, pad_len(L)
    return spec.depth * (2.0 * Bn * Lp * H * (4 * H + 2 * I)
                         + 4.0 * Bn * Lp * L * H)


def _zoo_batches(fn, n):
    """Median and all CUDA-event ms of n calls of fn (after a warm-up)."""
    fn()
    ts = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        ts.append(t0.elapsed_time(t1))
    return sorted(ts)[len(ts) // 2], ts


def phase_zoo(dev, smi, Bn=None):
    """The model zoo's factory on the card (models/registry.py
    create_model, random weights from the seed, bf16): a.-c. the ViT
    family (ZOO_VITS) at B=64: exact launches per batch, images/s (the
    median of ZOO_TIMED batches by CUDA events), peak memory, the idle
    share (torch.profiler), the logits against the same model with its
    blocks on the kernels' plain versions on the card (2e-2 of their
    scale; the plain chain, which rounds elsewhere, is reported: bf16
    noise grows over 24-32 blocks); d. resnet50 and t2t_vit_t_14 at B=64,
    224 px: images/s, no hand-kernel launch."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import backbones as TB
    from vitcap_tpu_torch.models import registry as TR
    Bn = Bn or ZOO_B
    out = {"card": smi, "vit": {}, "cnn": {}, "mode_launches": {}}
    for name, img in ZOO_VITS:
        tag = f"{name}@{img}"
        m = TR.create_model(name, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED))
        spec = m.spec
        stride = (TB.HYBRIDS[spec.hybrid][2] if spec.hybrid
                  else spec.patch_size)
        L = (img // stride) ** 2 + spec.num_lead_tokens
        x = _zoo_images(Bn, img, SEED + 41, dev)

        def batch():
            return m.apply(m.params, x, head=True)
        with torch.no_grad():
            batch()
            torch.cuda.synchronize()
            ops.reset_counts()
            logits = batch()
            torch.cuda.synchronize()
            got = dict(ops.launch_counts(), **ops.mode_counts())
            for k, v in ops.mode_counts().items():
                out["mode_launches"][k] = out["mode_launches"].get(k, 0) + v
            want = _zoo_want(spec, L)
            log(f"[zoo] {tag}: launches per batch "
                f"{ {k: v for k, v in got.items() if v} }")
            if got != want:
                raise AssertionError(f"zoo {tag}: launches {got} != {want}")
            if logits.shape != (Bn, spec.num_classes) or not torch.isfinite(
                    logits).all():
                raise AssertionError(f"zoo {tag}: logits {logits.shape}")
            torch.cuda.reset_peak_memory_stats()
            ms, all_ms = _zoo_batches(batch, ZOO_TIMED)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = _profile(f"zoo_{name}_{img}", batch, reps=1)
            ops.reset_counts()
            with _zoo_plain_versions():
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                ref = batch()
                t1.record()
                t1.synchronize()
                pms = t0.elapsed_time(t1)
            if any(ops.launch_counts().values()):
                raise AssertionError(f"zoo {tag}: the plain blocks launched "
                                     f"{ops.launch_counts()}")
            err = compare(f"zoo {tag} logits", logits, ref, torch.bfloat16)
            # the plain chain (models.layers _vit_block_plain) rounds at
            # other points: bf16 noise grows over the blocks, reported only
            with _zoo_plain_blocks():
                chain = batch()
            err_chain = (chain.float() - logits.float()).abs().max().item()
            del chain
        flops = _zoo_vit_flops(spec, L, Bn)
        b_ms, _ = bound(flops, 0.0, "bf16")
        out["vit"][tag] = {
            "tokens": L, "launches_per_batch": {k: v for k, v in got.items()
                                                if v},
            "batch_ms": ms, "batch_ms_all": all_ms,
            "images_per_s": Bn / ms * 1e3, "plain_batch_ms_once": pms,
            "peak_gib": peak, "idle_share": prof["idle_share"],
            "device_busy_ms": prof["device_busy_ms"],
            "top_kernels": prof["kernels"][:6],
            "blocks_tflop": flops / 1e12, "blocks_bound_ms": b_ms,
            "logits_max_abs_err": err,
            "logits_scale": ref.float().abs().max().item(),
            "logits_vs_plain_chain_max_abs_err": err_chain}
        log(f"[zoo] {tag}: {Bn / ms * 1e3:.2f} images/s ({ms:.3f} ms a batch "
            f"of {Bn}, median of {ZOO_TIMED}; plain blocks {pms:.3f} ms), "
            f"peak {peak:.2f} GiB, idle share {prof['idle_share']:.4f}, "
            f"blocks {flops / 1e12:.2f} TFLOP (bound {b_ms:.2f} ms), logits "
            f"vs the blocks' plain versions err {err:.3e} (scale "
            f"{out['vit'][tag]['logits_scale']:.3f}; vs the plain chain "
            f"{err_chain:.3e}) on {smi}")
        del m, x, logits, ref
        torch.cuda.empty_cache()
    for name in ZOO_CNNS:
        m = TR.create_model(name, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED))
        x = _zoo_images(Bn, 224, SEED + 42, dev)

        def batch():
            return m.apply(m.params, x, head=True)
        with torch.no_grad():
            ops.reset_counts()
            logits = batch()
            torch.cuda.synchronize()
            got = {k: v for k, v in dict(ops.launch_counts(),
                                         **ops.mode_counts()).items() if v}
            if got or not torch.isfinite(logits).all():
                raise AssertionError(f"zoo {name}: hand-kernel launches "
                                     f"{got}, or non-finite logits")
            torch.cuda.reset_peak_memory_stats()
            ms, all_ms = _zoo_batches(batch, ZOO_TIMED)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out["cnn"][name] = {"batch_ms": ms, "batch_ms_all": all_ms,
                            "images_per_s": Bn / ms * 1e3, "peak_gib": peak}
        log(f"[zoo] {name}@224: {Bn / ms * 1e3:.2f} images/s ({ms:.3f} ms a "
            f"batch of {Bn}, median of {ZOO_TIMED}), peak {peak:.2f} GiB; no "
            f"hand-kernel launch (cuDNN convolutions and plain PyTorch, as "
            f"the JAX package computes them outside any Pallas kernel) on "
            f"{smi}")
        del m, x, logits
        torch.cuda.empty_cache()
    return out


def phase_zoo_parity(dev, devices=None):
    """e. f32, the card (kernels; cuDNN without TF32) against the CPU
    (plain versions), the same weights and images, for each family at a
    reduced depth: 2 blocks of ViT-L/16-384 width at 384 px and of
    ViT-H/14 at 224 px (head dim 80), a 2-stage resnet50, t2t_vit_t_14 with
    2 body blocks; B=2, within 1e-4."""
    import dataclasses
    from vitcap_tpu_torch.models import registry as TR
    devices = devices or (dev, torch.device("cpu"))
    res = {}
    cases = [("vit_large_patch16_384", 384, dict(depth=2)),
             ("vit_huge_patch14_224_in21k", 224, dict(depth=2)),
             ("resnet50", 224, dict(n_stages=2)),
             ("t2t_vit_t_14", 224, dict(depth=2))]
    for name, img, cut in cases:
        spec = TR.model_spec(name)
        gen = torch.Generator().manual_seed(SEED + 43)
        if isinstance(spec, TR.VisionModelSpec):
            spec = dataclasses.replace(spec, **cut)
            model = TR.init_vision_params(spec, gen, "cpu")
            fwd = TR.vit_forward
        elif isinstance(spec, TR.CnnModelSpec):
            model = TR.init_cnn_params(spec, gen, "cpu", **cut)
            spec = dataclasses.replace(spec, num_classes=0)
            fwd = TR.cnn_forward
        else:
            model = TR.init_t2t_vit_params(spec, gen, "cpu", **cut)
            fwd = TR.t2t_vit_forward
        x = _zoo_images(2, img, SEED + 44, "cpu")
        outs = []
        for d in devices:
            md = copy.deepcopy(model).to(d)
            with torch.no_grad():
                outs.append(fwd(md, x.to(d), spec,
                                head=bool(spec.num_classes)).float().cpu())
            del md
        err = compare(f"zoo parity {name}", outs[0], outs[1], torch.float32)
        res[name] = {"max_abs_err": err, "cut": cut,
                     "scale": outs[1].abs().max().item()}
        log(f"[zoo-parity] {name} {cut} f32 card vs CPU: max abs err "
            f"{err:.3e} (scale {res[name]['scale']:.3f})")
    return res


# phase 18, part 2a: one model per family at full depth, its own image
# size, B=64 bf16
ZOO_CNN2 = [("tf_efficientnet_b7_ns", 600),
            ("efficientnet_cc_b1_8e", 240),
            ("mobilenetv3_large_100", 224),
            ("mixnet_xl", 224),
            ("rexnet_200", 224),
            ("regnety_160", 224),
            ("nf_regnet_b1", 224),
            ("resnetv2_50x3_bitm", 480)]
ZOO_TRAIN = ("efficientnet_b3", 300, 0.2)   # name, image size, drop-path
# f32 card vs CPU: (name, image size, stages kept)
ZOO_CNN2_PARITY = [("tf_efficientnet_b7_ns", 600, 3),
                   ("efficientnet_cc_b1_8e", 240, 5),
                   ("mobilenetv3_large_100", 224, 3),
                   ("mixnet_xl", 224, 3),
                   ("rexnet_200", 224, 3),
                   ("regnety_160", 224, 2),
                   ("nf_regnet_b1", 224, 2),
                   ("resnetv2_50x3_bitm", 480, 2)]
# phase 18, part 2b: one model a family at full depth, the registry's
# image size, B=64 bf16; the train step of resnest50d runs the BNs on the
# pooled attention vector in train mode
ZOO_CNN2B = [("legacy_senet154", 224),
             ("skresnext50_32x4d", 224),
             ("resnest101e", 224),
             ("tresnet_l_448", 448),
             ("cspresnext50", 256),
             ("dpn92", 224),
             ("densenet161", 224),
             ("dla102x2", 224),
             ("ese_vovnet99b", 224),
             ("selecsls60b", 224)]
# name, image size, drop-path, the running statistic that must move
ZOO_TRAIN_2B = ("resnest50d", 224, 0.0, "layer1.0.conv2.bn1.running_mean")
# f32 card vs CPU: (name, image size, stages kept)
ZOO_CNN2B_PARITY = [(name, img, 2) for name, img in ZOO_CNN2B]
# phase 18c, part 2c: one model a family at full depth, the registry's
# image size, B=64 bf16; the train step of hrnet_w18 runs a fuse path's BN
# (whose gradient comes back through the upsample) in train mode
ZOO_CNN2C = [("hrnet_w64", 224),
             ("inception_v3", 299),
             ("inception_v4", 299),
             ("inception_resnet_v2", 299),
             ("xception", 299),
             ("xception71", 299),
             ("gluon_xception65", 299),
             ("nasnetalarge", 331),
             ("pnasnet5large", 331)]
ZOO_TRAIN_2C = ("hrnet_w18", 224, 0.0,
                "stage2.0.fuse_layers.0.1.1.running_mean")
# f32 card vs CPU: (name, image size, n_stages: the first module a stage,
# block a run of repeated blocks, cell a run of plain cells)
ZOO_CNN2C_PARITY = [(name, img, 1) for name, img in ZOO_CNN2C]


def _no_hand_kernels(what):
    from vitcap_tpu_torch import ops
    got = {k: v for k, v in dict(ops.launch_counts(),
                                 **ops.mode_counts()).items() if v}
    if got:
        raise AssertionError(f"{what}: hand-kernel launches {got}")


def _conv_flops(fn):
    """The operations one call of fn does (torch's FlopCounterMode: the
    convolutions and products, 2 a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def _eager_bytes(fn):
    """The bytes one call of fn moves op by op, as eager PyTorch runs it:
    every op that is no view reads its inputs of 3 or more dims (maps and
    conv kernels) and writes its outputs once."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.n += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor) and t.dim() >= 3)
                self.n += sum(t.numel() * t.element_size()
                              for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
            return out
    with _Count() as c:
        fn()
    return float(c.n)


def zoo_counts(models, Bn=None):
    """The operations (_conv_flops) and eager bytes (_eager_bytes) of a
    bf16 batch of Bn (ZOO_B) through each (name, image size) of `models`,
    counted on the meta device: shapes only, nothing computed, no card
    needed (`python3 chip_smoke.py --zoo-counts`: part 2c's models and its
    train case's forward; the predictions of PERF.md)."""
    from vitcap_tpu_torch.models import registry as TR
    Bn = Bn or ZOO_B
    out = {}
    for name, img in models:
        spec = TR.model_spec(name)
        m = TR._POOLED[type(spec)][0](spec.variant, spec.num_classes, 0,
                                      "meta").eval()
        x = torch.empty(Bn, img, img, 3, device="meta", dtype=torch.bfloat16)

        def batch():
            return TR.pooled_cnn_forward(m, x, spec, head=True,
                                         dtype=torch.bfloat16)
        with torch.no_grad():
            flops, moved = _conv_flops(batch), _eager_bytes(batch)
        out[f"{name}@{img}"] = (flops, moved)
        log(f"[zoo-counts] {name}@{img}, B={Bn} bf16: {flops / 1e12:.3f} "
            f"TFLOP (bound {bound(flops, 0.0, 'bf16')[0]:.2f} ms), "
            f"{flops / 2 / Bn / 1e9:.2f} GMAC an image; eager ops move "
            f"{moved / 1e9:.1f} GB ({bound(0.0, moved, 'bf16')[0]:.1f} ms)")
    return out


def phase_zoo_cnn2(dev, smi, Bn=None, models=None, tag="zoo2"):
    """The zoo's part 2 on the card (create_model, random weights from
    the seed, bf16, B=64): one model per family (`models`: ZOO_CNN2 for
    part 2a, ZOO_CNN2B for 2b, ZOO_CNN2C for 2c) at full depth and its own image size: no
    hand-kernel launch a batch (asserted), images/s (the median of
    ZOO_TIMED batches by CUDA events), peak memory, the idle share and
    device time by kernel (torch.profiler, a fresh profile a model), the
    operations a batch (FlopCounterMode) and their bound at the bf16 peak,
    the bytes its eager ops move (_eager_bytes) and their time at the
    card's memory rate."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import registry as TR
    Bn = Bn or ZOO_B
    out = {}
    for name, img in models or ZOO_CNN2:
        what = f"{name}@{img}"
        m = TR.create_model(name, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED))
        x = _zoo_images(Bn, img, SEED + 48, dev)

        def batch():
            return m.apply(m.params, x, head=True)
        with torch.no_grad():
            batch()
            torch.cuda.synchronize()
            ops.reset_counts()
            logits = batch()
            torch.cuda.synchronize()
            _no_hand_kernels(f"zoo {what}")
            if logits.shape != (Bn, m.spec.num_classes) or not \
                    torch.isfinite(logits).all():
                raise AssertionError(f"zoo {what}: logits {logits.shape}, "
                                     f"or non-finite")
            torch.cuda.reset_peak_memory_stats()
            ms, all_ms = _zoo_batches(batch, ZOO_TIMED)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = _profile(f"zoo_{name}_{img}", batch, reps=1)
            flops = _conv_flops(batch)
            moved = _eager_bytes(batch)
        b_ms, _ = bound(flops, 0.0, "bf16")
        gb_ms, _ = bound(0.0, moved, "bf16")
        out[what] = {"batch_ms": ms, "batch_ms_all": all_ms,
                    "images_per_s": Bn / ms * 1e3, "peak_gib": peak,
                    "idle_share": prof["idle_share"],
                    "device_busy_ms": prof["device_busy_ms"],
                    "top_kernels": prof["kernels"][:6],
                    "tflop": flops / 1e12, "flops_bound_ms": b_ms,
                    "eager_gb": moved / 1e9, "eager_bytes_ms": gb_ms,
                    "logits_scale": logits.float().abs().max().item()}
        log(f"[{tag}] {what}: {Bn / ms * 1e3:.2f} images/s ({ms:.3f} ms a "
            f"batch of {Bn}, median of {ZOO_TIMED}), peak {peak:.2f} GiB, "
            f"idle share {prof['idle_share']:.4f} (busy "
            f"{prof['device_busy_ms']:.3f} ms), {flops / 1e12:.3f} TFLOP a "
            f"batch (bound {b_ms:.3f} ms at the bf16 peak), eager ops move "
            f"{moved / 1e9:.1f} GB ({gb_ms:.3f} ms at the memory rate); no "
            f"hand-kernel launch on {smi}")
        del m, x, logits
        torch.cuda.empty_cache()
    return out


def phase_zoo_train(dev, smi, Bn=None, case=None, tag="zoo2-train"):
    """The zoo's train mode on the card: forward + backward of `case`
    (ZOO_TRAIN: efficientnet_b3 at 300 px, drop-path 0.2; ZOO_TRAIN_2B:
    resnest50d at 224; ZOO_TRAIN_2C: hrnet_w18 at 224; B=64 bf16, BatchNorm on batch statistics,
    cross-entropy on seeded labels) under zoo_train_mode with a CUDA
    generator: no hand-kernel launch, finite loss and gradients, the
    case's running statistic moved; images/s (median of ZOO_TIMED steps
    by CUDA events), peak memory, the idle share."""
    from vitcap_tpu_torch import ops
    from vitcap_tpu_torch.models import backbones as TB
    from vitcap_tpu_torch.models import registry as TR
    Bn = Bn or ZOO_B
    name, img, dpr, watch = case or ZOO_TRAIN + ("bn2.running_mean",)
    m = TR.create_model(name, dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(SEED))
    model = m.params.requires_grad_(True)
    x = _zoo_images(Bn, img, SEED + 49, dev)
    labels = torch.from_numpy(np.random.RandomState(SEED + 50).randint(
        0, m.spec.num_classes, Bn)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    before = model.get_buffer(watch).clone()

    def step():
        model.zero_grad(set_to_none=True)
        with TB.zoo_train_mode(model, gen, drop_path_rate=dpr):
            logits = m.apply(model, x, head=True)
        loss = F.cross_entropy(logits.float(), labels)
        loss.backward()
        return loss
    ops.reset_counts()
    loss = step()
    torch.cuda.synchronize()
    _no_hand_kernels(f"zoo train {name}")
    grads = [p.grad for p in model.parameters()]
    if not torch.isfinite(loss) or any(
            g is None or not torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"zoo train {name}: non-finite loss or grads")
    if torch.equal(before, model.get_buffer(watch)) or model.training:
        raise AssertionError(f"zoo train {name}: running statistics did not "
                             f"move, or the model stayed in train mode")
    torch.cuda.reset_peak_memory_stats()
    ms, all_ms = _zoo_batches(step, ZOO_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = _profile(f"zoo_train_{name}_{img}", step, reps=1)
    res = {"step_ms": ms, "step_ms_all": all_ms,
           "images_per_s": Bn / ms * 1e3, "peak_gib": peak,
           "idle_share": prof["idle_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "top_kernels": prof["kernels"][:6], "loss": loss.item()}
    log(f"[{tag}] {name}@{img}: {Bn / ms * 1e3:.2f} images/s ({ms:.3f} "
        f"ms a forward + backward of {Bn}, drop-path {dpr}, median of "
        f"{ZOO_TIMED}), peak {peak:.2f} GiB, idle share "
        f"{prof['idle_share']:.4f}; no hand-kernel launch on {smi}")
    del m, model, x, grads
    torch.cuda.empty_cache()
    return res


@torch.no_grad()
def _perturb_norms(model, seed):
    """Every norm's affine and running statistics, every bias and NFNet
    gain redrawn from a seed: no identity norm or zero-initialised branch
    hides a fault."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        norm = isinstance(mod, (torch.nn.BatchNorm2d, torch.nn.GroupNorm))
        for name, t in [*mod.named_parameters(recurse=False),
                        *mod.named_buffers(recurse=False)]:
            if not t.is_floating_point():
                continue
            r = torch.randn(t.shape, generator=g).to(t.device)
            if name == "running_var":
                t.copy_(1.0 + 0.2 * r.abs())
            elif name in ("running_mean", "bias"):
                t.copy_(0.1 * r)
            elif name == "gain" or (norm and name == "weight"):
                t.copy_(1.0 + 0.1 * r)
    return model


def _within_scale(what, got, want, rel=1e-4, scale=None):
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.abs().max().item() if scale is None else scale
    err = (got - want).abs().max().item()
    if not err <= rel * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {rel} x "
                             f"{scale:.3e}")
    return err, scale


def _zoo_cnn_parity(cases, devices, tag):
    """f32 feature maps and logits of each (name, image size, stages kept)
    in `cases` on devices[0] against devices[1], the same weights (norms
    perturbed from a seed) and images, B=2, within 1e-4 of their scale."""
    from vitcap_tpu_torch.models import registry as TR
    res = {}
    for name, img, ns in cases:
        spec = TR.model_spec(name)
        model = _perturb_norms(TR.init_pooled_cnn_params(
            spec, torch.Generator().manual_seed(SEED + 52), "cpu", ns),
            SEED + 53)
        x = _zoo_images(2, img, SEED + 54, "cpu")
        outs = []
        for d in devices:
            md = copy.deepcopy(model).to(d)
            with torch.no_grad():
                outs.append([TR.pooled_cnn_forward(md, x.to(d), spec,
                                                   head=h).float().cpu()
                             for h in (False, True)])
            del md
        (ef, sf), (el, sl) = [_within_scale(f"{tag} {name} {w}", a, b)
                              for w, a, b in zip(("features", "logits"),
                                                 outs[0], outs[1])]
        res[name] = {"stages": ns, "img": img, "features_err": ef,
                     "features_scale": sf, "logits_err": el,
                     "logits_scale": sl}
        log(f"[{tag}] {name} ({ns} stages, {img} px) f32 card vs CPU: "
            f"features err {ef:.3e} (scale {sf:.3f}), logits err {el:.3e} "
            f"(scale {sl:.3f})")
    return res


def phase_zoo_cnn2_parity(dev, devices=None):
    """f32, the card (cuDNN, TF32 off) against the CPU, the same weights
    (norms perturbed from a seed) and images, B=2: each family of part 2a
    at a reduced depth (ZOO_CNN2_PARITY), the feature map and the logits
    within 1e-4 of their scale; then efficientnet_b0's first two stages
    in train mode (batch statistics): the logits and every updated running
    statistic within 1e-4 of its scale, every parameter's gradient (of
    sum(logits * r)) within 1e-4 of the largest."""
    from vitcap_tpu_torch.models import registry as TR
    devices = devices or (dev, torch.device("cpu"))
    res = _zoo_cnn_parity(ZOO_CNN2_PARITY, devices, "zoo2-parity")
    spec = TR.model_spec("efficientnet_b0")
    model = _perturb_norms(TR.init_pooled_cnn_params(
        spec, torch.Generator().manual_seed(SEED + 55), "cpu", 2), SEED + 56)
    x = _zoo_images(2, 224, SEED + 57, "cpu")
    r = torch.randn(2, spec.num_classes,
                    generator=torch.Generator().manual_seed(SEED + 58))
    runs = []
    for d in devices:
        md = copy.deepcopy(model).to(d).requires_grad_(True).train()
        logits = TR.pooled_cnn_forward(md, x.to(d), spec, head=True)
        (logits * r.to(d)).sum().backward()
        md.eval()
        runs.append((logits.detach().cpu(),
                     {k: v.cpu() for k, v in md.state_dict().items()
                      if "running" in k},
                     {k: p.grad.cpu() for k, p in md.named_parameters()}))
        del md
    (lg, stats, grads), (lg0, stats0, grads0) = runs
    el, _ = _within_scale("zoo2 train parity logits", lg, lg0)
    es = max(_within_scale(f"zoo2 train parity {k}", stats[k], stats0[k])[0]
             for k in stats0)
    top = max(g.abs().max().item() for g in grads0.values())
    eg = max(_within_scale(f"zoo2 train parity grad {k}", grads[k],
                           grads0[k], scale=top)[0] for k in grads0)
    res["train:efficientnet_b0"] = {"stages": 2, "logits_err": el,
                                    "running_stats_err": es,
                                    "grads_err": eg, "grads_top": top}
    log(f"[zoo2-parity] efficientnet_b0 train mode (2 stages) f32 card vs "
        f"CPU: logits err {el:.3e}, running statistics err {es:.3e}, "
        f"gradients err {eg:.3e} (largest {top:.3e})")
    return res


# ---------------------------------------------------------------------------
# phase 19: the host side (vitcap_tpu_torch/native, data/grain_loader.py,
# the profiler hooks)
# ---------------------------------------------------------------------------

HOST_IMAGES = 128            # seeded JPEGs of the decode timing and predict
HOST_HW = (480, 640)         # their (height, width)
HOST_TSV_BYTES = 200 << 20   # the line-index TSV
HOST_TRAIN = 2 * B           # train images of the loader and profiler runs


def phase_host_build():
    """a. Build the host libraries from the port's sources with g++ (the
    image decoder only where the host has libjpeg's headers); the seconds
    each took, and whether it was built or found."""
    from vitcap_tpu_torch import native
    names = ["tsvtools", "cider"] + (["imageproc"] if _jpeg_headers()
                                     else [])
    for name in names:
        native.library(name)
    out = {n: dict(native.build_info[n]) for n in names}
    for n, info in out.items():
        log(f"[host19] g++ {n}: {info['seconds']:.2f} s "
            f"({'built' if info['built'] else 'found built'}) -> "
            f"{info['path']}")
    if not _jpeg_headers():
        log("[host19] the native image decoder is unavailable on this host: "
            "g++ finds no jpeglib.h (libjpeg's headers), so "
            "vitcap_tpu_torch/native/imageproc.cpp cannot be built; phases "
            "14, 16 and 19c run image_backend: pil")
    return out


def phase_host_cider(dev, smi, scst13):
    """b. CIDEr-D at SCST's shape (B=64, K=2: 192 hypotheses, 5 references
    each, 6-12 seeded words of PIPE_WORDS, so that n-grams overlap and
    the scores are not 0): the native scorer against the Python one (rtol
    1e-9), ms of each (median of 3, in turns), beside phase 13's SCST step,
    which rewards with the native scorer (the default route)."""
    from vitcap_tpu_torch.evals.metrics import CiderD
    rs = np.random.RandomState(SEED + 90)
    n = B * (SCST_K + 1)

    def cap():
        return " ".join(rs.choice(PIPE_WORDS, rs.randint(6, 13)))
    gts = {i: [cap() for _ in range(5)] for i in range(n)}
    res = {i: [cap()] for i in range(n)}
    ms = {"python": [], "native": []}
    scores = {}
    for native in (False, True, True, False, False, True):
        with _cider_env(native):
            t0 = time.perf_counter()
            mean, sc = CiderD().compute_score(gts, res)
            ms["native" if native else "python"].append(
                (time.perf_counter() - t0) * 1e3)
        scores[native] = (mean, sc)
    (pm, ps), (nm, ns) = scores[False], scores[True]
    if not (np.allclose(ns, ps, rtol=1e-9, atol=1e-12)
            and math.isclose(nm, pm, rel_tol=1e-9) and nm > 0):
        raise AssertionError(f"native CIDEr-D {nm} vs Python {pm}: max "
                             f"difference {np.abs(ns - ps).max():.3e}")
    med = {k: sorted(v)[1] for k, v in ms.items()}
    log(f"[host19] CIDEr-D of {n} hypotheses x 5 references: Python "
        f"{med['python']:.2f} ms, native {med['native']:.2f} ms (median of "
        f"3, in turns; {med['python'] / med['native']:.1f}x); corpus score "
        f"{nm:.6f}, max |native - Python| {np.abs(ns - ps).max():.3e}")
    a = scst13["median"]
    log(f"[host19] phase 13's SCST step with the native reward: reward "
        f"{a['reward_ms']:.1f} ms, decode {a['decode_ms']:.1f} ms, grad "
        f"{a['grad_ms']:.1f} ms, {scst13['images_per_s']:.2f} images/s "
        f"(B={B}, K={SCST_K}) on {smi}")
    return {"cider_ms": ms, "cider_median_ms": med, "score": nm,
            "max_abs_diff": float(np.abs(ns - ps).max()),
            "scst_native_median": a,
            "scst_native_images_per_s": scst13["images_per_s"]}


def _tsv_payloads(path):
    import base64
    from vitcap_tpu_torch.data.tsv import tsv_reader
    return [base64.b64decode(r[-1]) for r in tsv_reader(path)]


def phase_host_images(dev, smi, root):
    """c. HOST_IMAGES seeded 640x480 JPEGs (_pipeline_dataset's smooth
    images with noise) through the test transform at 384: PIL, native
    exact and native fast, ms per image (best of 2 passes in turns);
    exact bit-equal to PIL, fast within 1 LSB of exact on average.  Then
    the fused predict of those images (the flagship, random weights from
    the seed, written as a snapshot) on each image_backend: captions/s,
    the idle share (_profile, model load included) and the .speed.yaml's
    prep_time.  Without libjpeg's headers only PIL runs."""
    import io
    from PIL import Image
    from vitcap_tpu_torch import run as TR
    from vitcap_tpu_torch.data.transforms import TestImageTransform
    from vitcap_tpu_torch.models.vitcap import init_params
    _pipeline_dataset(root, SEED + 91, n_train=B, n_test=HOST_IMAGES,
                      hw=HOST_HW)
    data = _tsv_payloads(os.path.join(root, "data", "synthcoco",
                                      "test.tsv"))
    pil = TestImageTransform(crop_size=384, emit_uint8=True, backend="pil")
    modes = {"pil": lambda d: pil(Image.open(io.BytesIO(d)).convert("RGB"))}
    if _jpeg_headers():
        exact = TestImageTransform(crop_size=384, emit_uint8=True)
        fast = TestImageTransform(crop_size=384, emit_uint8=True,
                                  fast_decode=True)
        modes.update(native=exact.from_jpeg_bytes, fast=fast.from_jpeg_bytes)
    ms, outs = {m: [] for m in modes}, {}
    for _ in range(2):
        for m, fn in modes.items():
            t0 = time.perf_counter()
            outs[m] = [fn(d) for d in data]
            ms[m].append((time.perf_counter() - t0) * 1e3 / len(data))
    per_image = {m: min(v) for m, v in ms.items()}
    res = {"ms_per_image": per_image, "images": len(data),
           "native_available": _jpeg_headers()}
    if _jpeg_headers():
        bad = [i for i, (a, b) in enumerate(zip(outs["native"], outs["pil"]))
               if not np.array_equal(a, b)]
        if bad:
            raise AssertionError(f"native exact decode differs from PIL on "
                                 f"images {bad[:8]}")
        lsb = float(np.mean([np.abs(f.astype(np.int16) - e).mean()
                             for f, e in zip(outs["fast"], outs["native"])]))
        if not lsb < 1.0:
            raise AssertionError(f"native fast decode: mean |fast - exact| "
                                 f"{lsb:.3f} LSB, not under 1")
        res["fast_mean_abs_lsb"] = lsb
        log(f"[host19] decode+resize+crop of {len(data)} {HOST_HW[1]}x"
            f"{HOST_HW[0]} JPEGs to 384: PIL {per_image['pil']:.2f}, native "
            f"{per_image['native']:.2f}, fast {per_image['fast']:.2f} ms an "
            f"image (one host thread); native bit-equal to PIL, fast within "
            f"{lsb:.3f} LSB of exact on average")
    else:
        log(f"[host19] decode+resize+crop of {len(data)} {HOST_HW[1]}x"
            f"{HOST_HW[0]} JPEGs to 384: PIL {per_image['pil']:.2f} ms an "
            f"image (one host thread); native and fast: not measured (the "
            f"native decoder is unavailable on this host)")
    # the fused predict of these images on each backend
    param = _pipeline_param(root, expid="phase19", max_iter=1,
                            force_predict=1)
    pip = TR.create_pipeline(dict(param, **PIPE_TEST_DATA[0]))
    model = init_params(pip.model_cfg, torch.Generator().manual_seed(
        SEED + 92), dev)
    os.makedirs(pip.model_folder, exist_ok=True)
    torch.save({"model": model.state_dict()}, pip.get_checkpoint_file())
    del model
    torch.cuda.empty_cache()
    res["predict"] = {}
    for backend in ["pil"] + (["native"] if _jpeg_headers() else []):
        pd = TR.create_pipeline(dict(param, image_backend=backend,
                                     **PIPE_TEST_DATA[0]))
        with _engine(fused=True):
            prof = _profile(f"host19_predict_{backend}", pd.ensure_predict,
                            reps=1)
        _predict_rows(pd, HOST_IMAGES)
        speed = _read_yaml(pd.get_predict_file() + ".speed.yaml")
        res["predict"][backend] = {
            "captions_per_s": HOST_IMAGES / prof["wall_ms"] * 1e3,
            "idle_share": prof["idle_share"], "wall_ms": prof["wall_ms"],
            "prep_time": speed["prep_time"],
            "pipeline_time": speed["pipeline_time"]}
        log(f"[host19] fused predict, image_backend {backend}: "
            f"{HOST_IMAGES / prof['wall_ms'] * 1e3:.2f} captions/s, idle "
            f"share {prof['idle_share']:.4f}, prep_time "
            f"{speed['prep_time']}, pipeline_time {speed['pipeline_time']} "
            f"(B={B}, model load included) on {smi}")
        del pd
    if not _jpeg_headers():
        log("[host19] fused predict, image_backend native: not measured "
            "(the native decoder is unavailable on this host)")
    return res


def phase_host_lineidx(root):
    """d. A seeded TSV of HOST_TSV_BYTES (rows of 20-2000 letters with a
    tab, the page cache warm: the file was just written): the native
    .lineidx.8b against the Python line scan's offsets, ms of each (best
    of 2, in turns)."""
    from vitcap_tpu_torch.data.native_tsv import build_lineidx_8b
    from vitcap_tpu_torch.data.tsv import generate_lineidx
    rs = np.random.RandomState(SEED + 93)
    lens = rs.randint(20, 2001, HOST_TSV_BYTES // 1000)
    ends = np.cumsum(lens)
    buf = rs.randint(97, 123, int(ends[-1]), dtype=np.uint8)
    buf[ends - 1] = ord("\n")
    buf[ends - lens + 8] = ord("\t")
    tsv = os.path.join(root, "lines.tsv")
    buf.tofile(tsv)
    want = np.concatenate([[0], ends[:-1]]).astype("<u8")
    ms = {"python": [], "native": []}
    for kind in ("python", "native", "native", "python"):
        t0 = time.perf_counter()
        if kind == "native":
            n = build_lineidx_8b(tsv, tsv + ".8b")
        else:
            generate_lineidx(tsv, tsv + ".lineidx")
        ms[kind].append((time.perf_counter() - t0) * 1e3)
    got = np.fromfile(tsv + ".8b", "<u8")
    with open(tsv + ".lineidx") as f:
        scan = np.asarray(f.read().split(), np.uint64)
    if n != len(lens) or not (np.array_equal(got, want)
                              and np.array_equal(scan, want)):
        raise AssertionError(f"line index: {n} lines, native "
                             f"{np.array_equal(got, want)}, Python scan "
                             f"{np.array_equal(scan, want)}")
    best = {k: min(v) for k, v in ms.items()}
    ratio = best["python"] / best["native"]
    log(f"[host19] .lineidx.8b of a {buf.size / 2 ** 20:.1f} MiB TSV "
        f"({n} lines, warm page cache): Python scan {best['python']:.1f} ms, "
        f"native {best['native']:.1f} ms ({ratio:.1f}x); offsets equal")
    os.remove(tsv)
    return {"mib": buf.size / 2 ** 20, "lines": n, "ms": ms, "best_ms": best}


def _train_keys(rec):
    """Wrap CaptionUniPipeline._device_train_batch to record each train
    batch's image keys into rec."""
    def wrap(orig):
        def f(self, batch):
            rec.append(list(batch["key"]))
            return orig(self, batch)
        return f
    return wrap


def phase_host_loader(dev, smi, root):
    """e. 4 flagship train steps through the pipeline with `loader: grain`
    and grain_workers 2 (spawned processes; the thread-pool loader's
    prefetch does not apply): the first 3 batches' image keys equal a
    grain_workers 0 loader's; train img/s over steps 2-3 and the host gap
    before each step (loader wait + batch copy); f. in the same run, step
    4 under jax_profile_dir (jax_profile_start 3, jax_profile_steps 1),
    whose Chrome trace holds CUDA kernel events of the port's gemm and
    attention."""
    from vitcap_tpu_torch import run as TR
    from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
    _pipeline_dataset(root, SEED + 94, n_train=HOST_TRAIN, n_test=8,
                      name="grain")
    prof = Path(root) / "trace"
    param = dict(_pipeline_param(root, data="grain", test_data="grain",
                                 expid="phase19_grain", max_iter=4,
                                 snapshot_steps=100, log_step=1,
                                 loader="grain", grain_workers=2,
                                 jax_profile_dir=str(prof),
                                 jax_profile_start=3, jax_profile_steps=1),
                 test_split="test")
    keys = []
    pip = TR.create_pipeline(param)
    with _pipeline_probes({}) as rec, _wrapped(
            TCP.CaptionUniPipeline, "_device_train_batch", _train_keys(keys)):
        t0 = time.perf_counter()
        pip.ensure_train()
        run_s = time.perf_counter() - t0
    steps = rec["steps"]
    losses = [s["loss"].item() for s in steps]
    if len(steps) != 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"grain train: losses {losses}")
    keys = keys[:3]
    p0 = TR.create_pipeline(dict(param, grain_workers=0))
    want = []
    for batch in p0.get_data_loader(is_train=True):
        want.append(list(batch["key"]))
        if len(want) == 3:
            break
    if keys != want:
        raise AssertionError(f"grain_workers 2 batches {keys} differ from "
                             f"grain_workers 0's {want}")
    gap_ms = [(steps[i]["t0"] - steps[i - 1]["t1"]) * 1e3 for i in (1, 2)]
    rate = B * 2 / (steps[2]["t1"] - steps[1]["t0"])
    log(f"[host19] loader: grain, grain_workers 2: 4 train steps in "
        f"{run_s:.1f} s (workers' start, the traced step 4 and the final "
        f"snapshot included); "
        f"{rate:.2f} img/s over steps 2-3; host gap before steps 2-3 "
        f"{[round(v, 1) for v in gap_ms]} ms; step ms "
        f"{[round((s['t1'] - s['t0']) * 1e3, 1) for s in steps]}; losses "
        f"{[round(v, 4) for v in losses]}; batches equal grain_workers 0's "
        f"(B={B}, bf16) on {smi}")
    return {"img_per_s_steps_2_3": rate, "host_gap_ms": gap_ms,
            "run_s": run_s, "losses": losses, "batches": keys,
            "profiler": _host_trace(prof)}


def _host_trace(prof):
    """f. The train window's Chrome trace under `prof`: one file, with
    CUDA kernel events of the port's gemm and attention kernels."""
    traces = sorted(prof.glob("train_rank0_*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profiler: traces {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    gemm = [k for k in kernels if "gemm_wide_kernel" in k
            or "gemm_split_kernel" in k]
    attn = [k for k in kernels if "attention_wgmma" in k]
    if not gemm or not attn:
        raise AssertionError(f"profiler trace: {len(kernels)} kernel events,"
                             f" {len(gemm)} gemm, {len(attn)} attention")
    size = traces[0].stat().st_size
    log(f"[host19] jax_profile_dir: train step 4 of 4 traced "
        f"-> {traces[0].name} ({size / 2 ** 20:.1f} MiB): {len(kernels)} "
        f"CUDA kernel events, {len(gemm)} of the port's gemm and "
        f"{len(attn)} of its attention")
    return {"trace_mib": size / 2 ** 20, "kernel_events": len(kernels),
            "gemm_events": len(gemm), "attention_events": len(attn)}


def phase_host_side(dev, smi, scst13):
    """Phase 19 (a-f), under a temporary directory of build/."""
    import tempfile
    from vitcap_tpu_torch.utils import common as UC
    UC._LOGGING_INITED = True
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_host_", dir=ROOT / "build")
    out = {}
    try:
        t0 = time.perf_counter()
        out["build"] = phase_host_build()
        out["cider"] = phase_host_cider(dev, smi, scst13)
        out["images"] = phase_host_images(dev, smi, root)
        out["lineidx"] = phase_host_lineidx(root)
        out["loader"] = phase_host_loader(dev, smi, root)
        out["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: tensor parallelism (parallel/mesh.py, parallel/tensor_parallel.py)
# ---------------------------------------------------------------------------

TP_B = 16                    # flagship train rows and bf16 decode images
TP_F32_B = 4                 # f32 train rows and decode images
TP_F32_DEPTH = dict(num_hidden_layers=4, split_blocks=2, decoder_layers=2)
TP_HEADS = (6, 6, 12)        # rank 1's heads: 6 from head 6 of 12


def _tp_cfg(dtype, **kw):
    """The bench training line (its dropouts 0.1 on) in `dtype`."""
    from vitcap_tpu_torch.models.config import ModelConfig
    return ModelConfig(dtype=dtype, tag_loss_weight=1.0, **kw)


def phase_tp_kernels(dev, rows):
    """a. attention and attention_bwd with prob dropout 0.1 on a tensor-
    parallel rank's head slice (heads 6-11 of 12: the salt b * 12 + 6 + h)
    against their plain versions, at the flagship decoder's train shape
    on one rank of the (1, 2) grid (B=TP_B, L 648, Lp 656, the bias),
    bf16 (2e-2 of scale, >= 99% bit-equal) and f32 (1e-4)."""
    from vitcap_tpu_torch.ops.attention import attention, attention_plain
    from vitcap_tpu_torch.ops.attention_bwd import (attention_bwd,
                                                    attention_bwd_plain)
    g = torch.Generator().manual_seed(SEED + 110)
    nh, off, total = TP_HEADS
    hd, L, Lp, rate, Bn = 64, 648, 656, 0.1, TP_B
    H = nh * hd
    first = len(rows)
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        es = 2 if dtype == torch.bfloat16 else 4
        slab = torch.randn(Bn, Lp, 3 * H, generator=g).to(dev, dtype)
        up = torch.randn(Bn, Lp, H, generator=g).to(dev, dtype)
        up[:, L:] = 0.0
        bias = _bert_train_bias(Bn, L, Lp, dev)
        mask = torch.zeros(Bn, 1, Lp, Lp, device=dev, dtype=dtype)
        mask[..., L:] = float("-inf")
        mask = mask + bias.to(dtype)
        salt = (total, off)
        out = attention(slab, nh, L, bias, rate, 4243, *salt)
        ref = attention_plain(slab, nh, L, bias, rate, 4243, *salt)
        err = compare(f"attention[tp] {dn}", out, ref, dtype)
        eq = _bits("attention[tp]", out, ref)
        ms, pms = _time_pair(
            lambda i: attention(slab, nh, L, bias, rate, 4243, *salt),
            lambda i: attention_plain(slab, nh, L, bias, rate, 4243, *salt),
            5, 2)
        qkv = slab.view(Bn, Lp, 3, nh, hd).permute(2, 0, 3, 1, 4)
        lms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qkv[0], qkv[1], qkv[2], attn_mask=mask, dropout_p=rate), 5)
        _row(rows, "attention[tp]", "bert train heads 6-11", dn,
             f"B={Bn} L={L} Lp={Lp} heads=6x64 of 12 rate={rate}", err, ms,
             pms, lms, 4.0 * Bn * nh * Lp * L * hd,
             es * Bn * Lp * 4 * H + 4 * Bn * Lp * Lp)
        rows[-1]["bit_equal"] = eq
        got = attention_bwd(slab, up, nh, L, bias, rate, 778, *salt)
        want = attention_bwd_plain(slab, up, nh, L, bias, rate, 778, *salt)
        err, eqs = 0.0, []
        for part, o, r in zip("qkv", got, want):
            name = f"attention_bwd[tp] d{part} {dn}"
            err = max(err, compare(name, o, r, dtype))
            eqs.append(_bits(name, o, r))
        del got, want
        ms, pms = _time_pair(
            lambda i: attention_bwd(slab, up, nh, L, bias, rate, 778, *salt),
            lambda i: attention_bwd_plain(slab, up, nh, L, bias, rate, 778,
                                          *salt), 3, 2)
        qkv = [t.detach().contiguous().requires_grad_(True) for t in qkv]
        o = F.scaled_dot_product_attention(*qkv, attn_mask=mask,
                                           dropout_p=rate)
        go = up.view(Bn, Lp, nh, hd).transpose(1, 2)
        lms = cuda_ms(lambda i: torch.autograd.grad(o, qkv, go,
                                                    retain_graph=True), 3)
        _row(rows, "attention_bwd[tp]", "bert train heads 6-11", dn,
             f"B={Bn} L={L} Lp={Lp} heads=6x64 of 12 rate={rate}", err, ms,
             pms, lms, 10.0 * Bn * nh * Lp * L * hd,
             es * Bn * Lp * 7 * H + 4 * Bn * Lp * Lp)
        rows[-1]["bit_equal"] = min(e for e in eqs if e is not None) \
            if dtype == torch.bfloat16 else None
        del slab, up, bias, mask, qkv, o
        torch.cuda.empty_cache()
    for r in rows[first:]:
        log(f"[tp20] {r['kernel']:18s} {r['case']:22s} {r['dtype']:4s} err "
            f"{r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f"  bit-equal {r['bit_equal']:.5f}" if r.get("bit_equal")
               else ""))


def _tp_decode(cfg, model, dev, Bn):
    """One greedy and one beam-3 batch of Bn seeded uint8 images on the
    fused engine, and the first step's f32 logits -> (ids, logits, the
    launches of each batch)."""
    from vitcap_tpu_torch.models import decode as TD
    rs = np.random.RandomState(SEED + 104)
    imgs = torch.from_numpy(rs.randint(0, 256, (Bn, cfg.img_size,
                                                cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.from_numpy(rs.randint(1, 9000, (Bn, cfg.max_seq_len
                                               - cfg.max_seq_a_len))).to(dev)
    sl = torch.from_numpy(rs.randint(cfg.max_seq_a_len + 1,
                                     cfg.max_seq_len + 1, Bn)).to(dev)
    opts = _opts(cfg)
    with _engine(True):
        g, cg = _counted(lambda: TD.generate_greedy(model, imgs, od, None, sl,
                                                    cfg, opts))
        b, cb = _counted(lambda: TD.generate_beam(model, imgs, od, None, sl,
                                                  cfg, _opts(cfg,
                                                             num_beams=3)))
        with torch.inference_mode():
            ctx = TD.build_decode_context(model, imgs, od, None, sl, cfg,
                                          opts)
            init, step, _ = TD._decode_engine(model, ctx, cfg, opts, Bn)
            logits = step(init(), torch.full((Bn,), cfg.cls_token_id,
                                             device=dev), 1)[0]
    return ({"greedy": g["ids"].cpu().tolist(),
             "beam": b["ids"].cpu().tolist()}, logits.float().cpu(),
            {"greedy": {k: n for k, n in cg.items() if n},
             "beam": {k: n for k, n in cb.items() if n}})


def _tp_train(cfg, dev, Bn, decode_b, steps, batch_seed, mesh=None):
    """Build the seed's model (split over `mesh`'s model axis when given),
    decode one greedy and one beam-3 batch with it, then take `steps` train
    steps of Bn rows (dropout from the seed's generator; the all-reduces
    of the last step timed) -> dict of losses, launches a step, step ms,
    the model axis's all-reduce stats a step, the decode's, and the
    state."""
    from vitcap_tpu_torch.models.vitcap import init_params
    from vitcap_tpu_torch.parallel import tensor_parallel as TP
    from vitcap_tpu_torch.parallel.mesh import rank_seed, shard_params
    from vitcap_tpu_torch.solver.train_step import (TrainHyper,
                                                    init_train_state,
                                                    make_train_step)
    model = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    if mesh is not None:
        shard_params(model, mesh, tensor_parallel=True)
    ids, logits, dec_launches = _tp_decode(cfg, model, dev, decode_b)
    state = init_train_state(
        model, torch.Generator().manual_seed(rank_seed(SEED + 9)))
    step = make_train_step(cfg, TrainHyper(base_lr=1e-4, max_iter=1000))
    batch = _train_batch(cfg, Bn, batch_seed, dev)
    out = {"losses": [], "launches": [], "step_ms": [], "all_reduce": [],
           "ids": ids, "logits": logits, "decode_launches": dec_launches}
    for i in range(steps):
        TP.reset_stats()
        TP.timed = i == steps - 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), c = _counted(lambda: step(state, batch, False))
        loss = m["loss"].item()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["launches"].append({k: n for k, n in c.items() if n})
        out["all_reduce"].append(dict(TP.stats))
    TP.timed = False
    return out, state


def tp_worker(rank, world, port, workdir):
    """One rank of phase 20 (`chip_smoke.py --tp-worker RANK WORLD PORT
    DIR`), its job in DIR/job.json (the device, both configs and their
    rows): joins a Gloo group on the job's device with the other rank
    (cuda:0 for both: NCCL refuses two ranks on one card), makes the (1,
    world) grid and runs _tp_train's bf16 (2 steps) and f32 (1 step) runs
    on its shard; holds the f32 run's gathered parameters to
    DIR/f32_ref.pt (rtol 2e-4 / atol 1e-6); writes DIR/tp_<rank>.json and
    DIR/tp_logits_<rank>.pt."""
    rank, world = int(rank), int(world)
    sys.path.insert(0, str(ROOT))
    from vitcap_tpu_torch.models.config import ModelConfig
    from vitcap_tpu_torch.parallel import distributed as PD
    from vitcap_tpu_torch.parallel.mesh import gather_params, make_mesh
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    PD.ensure_init_distributed(f"127.0.0.1:{port}", world, rank,
                               backend="gloo", device=dev)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    logits = {}
    try:
        cfg = ModelConfig(**job["bf16_cfg"])
        mesh = make_mesh(1, world, cfg)
        t0 = time.perf_counter()
        run, state = _tp_train(cfg, dev, job["rows"], job["rows"], 2,
                               SEED + 101, mesh)
        out["bf16_s"] = time.perf_counter() - t0
        logits["bf16"] = run.pop("logits")
        out["bf16"] = run
        out["local_heads"] = state.model.bert.decoder.layer[0].tp.heads
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg = ModelConfig(**job["f32_cfg"])
        t0 = time.perf_counter()
        run, state = _tp_train(cfg, dev, job["f32_rows"], job["f32_rows"], 1,
                               SEED + 102, mesh)
        out["f32_s"] = time.perf_counter() - t0
        logits["f32"] = run.pop("logits")
        full = gather_params(state.model)
        ref = torch.load(os.path.join(workdir, "f32_ref.pt"),
                         weights_only=True)
        bad, worst = [], 0.0
        for n, want in ref.items():
            got = full[n].float().cpu()
            worst = max(worst, (got - want).abs().max().item())
            if not torch.allclose(got, want, rtol=2e-4, atol=1e-6):
                bad.append(n)
        out["f32"] = dict(run, param_max_abs_diff=worst, params_off=bad,
                          n_params=len(ref))
        del state, full
        PD.barrier()
    finally:
        PD.shutdown()
    torch.save(logits, os.path.join(workdir, f"tp_logits_{rank}.pt"))
    with open(os.path.join(workdir, f"tp_{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


def phase_tp(dev, smi, rows):
    """Tensor parallelism over a (1, 2) grid: two ranks on cuda:0 over
    Gloo (tp_worker), against this process's unsplit runs:
    a. phase_tp_kernels (the salted attention kernels);
    b. the flagship (ViT-B/16-384, 12 + 4 blocks, 4 decoder layers, bf16,
       dropout 0.1) at TP_B rows, 2 steps: losses within 2e-2 relative,
       each rank's launches a step (the unsplit step's kernels, on 6 heads)
       equal to the unsplit step's; the model axis's all-reduces a step
       (calls, MiB, ms, synchronised); then f32 at a reduced depth
       (TP_F32_DEPTH, TP_F32_B rows, 1 step): loss rtol 1e-5, the gathered
       parameters rtol 2e-4 / atol 1e-6 (tests/test_solver.py:162's bound);
    c. before each run's training, one greedy and one beam-3 batch on the
       fused engine: in f32 the tokens equal the unsplit tokens; in bf16
       the first step's logits within 2e-2 of their scale, the token
       agreement printed.
    Two ranks on one card prove the split's correctness and measure the
    collectives' cost, not scaling."""
    import dataclasses
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=ROOT / "build")
    res = {}
    try:
        t0 = time.perf_counter()
        phase_tp_kernels(dev, rows)
        res["kernels_s"] = time.perf_counter() - t0
        cfg16, cfg32 = _tp_cfg("bfloat16"), _tp_cfg("float32", **TP_F32_DEPTH)
        t0 = time.perf_counter()
        ref, state = _tp_train(cfg16, dev, TP_B, TP_B, 2, SEED + 101)
        del state
        torch.cuda.empty_cache()
        ref32, state = _tp_train(cfg32, dev, TP_F32_B, TP_F32_B, 1,
                                 SEED + 102)
        torch.save({n: p.detach().float().cpu()
                    for n, p in state.model.named_parameters()},
                   Path(root) / "f32_ref.pt")
        del state
        torch.cuda.empty_cache()
        res["unsplit_s"] = time.perf_counter() - t0
        (Path(root) / "job.json").write_text(json.dumps({
            "device": str(dev), "rows": TP_B, "f32_rows": TP_F32_B,
            "bf16_cfg": dataclasses.asdict(cfg16),
            "f32_cfg": dataclasses.asdict(cfg32)}))
        port = str(_free_port())
        t0 = time.perf_counter()
        _run_children([[sys.executable, str(ROOT / "chip_smoke.py"),
                        "--tp-worker", str(r), "2", port, root]
                       for r in range(2)], dict(os.environ), "tp ranks",
                      root)
        res["ranks_s"] = time.perf_counter() - t0
        w = [json.loads((Path(root) / f"tp_{r}.json").read_text())
             for r in range(2)]
        lg = [torch.load(Path(root) / f"tp_logits_{r}.pt", weights_only=True)
              for r in range(2)]
        base = ("gemm", "layer_norm", "attention", "attention_bwd")
        for x, logits in zip(w, lg):
            r = x["rank"]
            if x["backend"] != "gloo" or x["local_heads"] != 6:
                raise AssertionError(f"tp rank {r}: {x['backend']}, "
                                     f"{x['local_heads']} heads")
            bf, f32 = x["bf16"], x["f32"]
            rel = [abs(a - b) / abs(b) for a, b in zip(bf["losses"],
                                                        ref["losses"])]
            if max(rel) > 2e-2:
                raise AssertionError(f"tp rank {r}: bf16 losses "
                                     f"{bf['losses']} vs {ref['losses']}")
            for c in bf["launches"]:
                if any(c.get(k, 0) != ref["launches"][0].get(k, 0)
                       for k in base) or (dev.type == "cuda"
                                          and not c.get("attention[tp]")):
                    raise AssertionError(f"tp rank {r}: launches {c} vs the "
                                         f"unsplit step's "
                                         f"{ref['launches'][0]}")
            if not math.isclose(f32["losses"][0], ref32["losses"][0],
                                rel_tol=1e-5):
                raise AssertionError(f"tp rank {r}: f32 loss "
                                     f"{f32['losses'][0]} vs "
                                     f"{ref32['losses'][0]}")
            if f32["params_off"]:
                raise AssertionError(
                    f"tp rank {r}: {len(f32['params_off'])} of "
                    f"{f32['n_params']} f32 parameters past rtol 2e-4 / atol "
                    f"1e-6 (max abs diff {f32['param_max_abs_diff']:.3e}): "
                    f"{f32['params_off'][:6]}")
            if f32["ids"] != ref32["ids"]:
                raise AssertionError(f"tp rank {r}: f32 tokens differ from "
                                     f"the unsplit tokens")
            err = (logits["bf16"] - ref["logits"]).abs().max().item()
            scale = ref["logits"].abs().max().item()
            if not err <= BF16_TOL * scale:
                raise AssertionError(f"tp rank {r}: bf16 first-step logits "
                                     f"off by {err:.3g} (scale {scale:.3g})")
            agree = {k: float(np.mean(np.asarray(bf["ids"][k])
                                      == np.asarray(ref["ids"][k])))
                     for k in ("greedy", "beam")}
            x.update(bf16_logit_err=err, bf16_logit_scale=scale,
                     bf16_token_agreement=agree,
                     f32_logit_err=(logits["f32"] - ref32["logits"]).abs()
                     .max().item())
        if w[0]["bf16"]["ids"] != w[1]["bf16"]["ids"]:
            raise AssertionError("tp: the two ranks picked other tokens")
        ar = w[0]["bf16"]["all_reduce"][-1]
        res.update(workers=w, unsplit={k: v for k, v in ref.items()
                                       if k != "logits"},
                   unsplit_f32={k: v for k, v in ref32.items()
                                if k != "logits"})
        log(f"[tp20] a. salted attention / attention_bwd held to their plain "
            f"versions ({res['kernels_s']:.1f} s)")
        log(f"[tp20] unsplit references (bf16 2 steps of {TP_B}, f32 4+2+2 "
            f"blocks 1 step of {TP_F32_B}, their decodes) "
            f"{res['unsplit_s']:.1f} s; 2 ranks over Gloo on cuda:0 "
            f"{res['ranks_s']:.1f} s")
        for x in w:
            log(f"[tp20] b. rank {x['rank']}: bf16 losses "
                f"{[round(v, 5) for v in x['bf16']['losses']]} vs unsplit "
                f"{[round(v, 5) for v in ref['losses']]}; step ms "
                f"{[round(v, 1) for v in x['bf16']['step_ms']]} vs "
                f"{[round(v, 1) for v in ref['step_ms']]}; launches a step "
                f"{x['bf16']['launches'][-1]}")
            log(f"[tp20] b. rank {x['rank']}: f32 loss "
                f"{x['f32']['losses'][0]:.7f} vs {ref32['losses'][0]:.7f}, "
                f"{x['f32']['n_params']} gathered parameters within rtol "
                f"2e-4 / atol 1e-6 (max abs diff "
                f"{x['f32']['param_max_abs_diff']:.3e})")
            log(f"[tp20] c. rank {x['rank']}: f32 greedy and beam-3 tokens "
                f"== unsplit (first-step logits max abs diff "
                f"{x['f32_logit_err']:.3e}); bf16 first-step logits max abs "
                f"diff {x['bf16_logit_err']:.4g} of scale "
                f"{x['bf16_logit_scale']:.4g}, token agreement "
                f"{x['bf16_token_agreement']}; launches a batch "
                f"{x['bf16']['decode_launches']}")
        log(f"[tp20] b. the model axis's all-reduces in one bf16 train step "
            f"(rank 0, Gloo, the card's tensors through the host, "
            f"synchronised): {ar['calls']} calls, "
            f"{ar['bytes'] / 2 ** 20:.1f} MiB, {ar['seconds'] * 1e3:.1f} ms, "
            f"on {smi}; two ranks on one card measure the collectives' "
            f"cost, not scaling")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def _timed(name, fn, *args):
    """fn(*args), its seconds logged under `name`."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
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
    kernel_launch = phase_build()
    rows = []
    _timed("kernels", phase_kernels, dev, rows)
    _timed("decode-gemm", phase_decode_gemm, dev, rows)
    _timed("decode-ln", phase_decode_layer_norm, dev, rows)
    _timed("decode-attention", phase_decode_attention, dev, rows)
    _timed("decode-attention-long", phase_decode_attention_long, dev, rows)
    sweep = _timed("sweep", phase_decode_attention_sweep, dev)
    _timed("blocks", phase_blocks, dev, rows)
    _timed("decode-step", phase_decode_step, dev, rows)
    greedy_counts, greedy = _timed("main-path", phase_main_path, dev, smi)
    counts, beam = _timed("beam-path", phase_beam_path, dev, smi)
    log(f"[beam] beam-3 fused {beam['beam3_fused']['captions_per_s']:.2f} "
        f"captions/s; greedy fused "
        f"{beam['greedy_fused']['captions_per_s']:.2f} vs greedy eager "
        f"{greedy['captions_per_s']:.2f} captions/s (B={B}, bf16) on {smi}")
    _timed("parity", phase_parity, dev)
    prof = _timed("profile", phase_profile, dev)
    t_train = time.perf_counter()
    phase_train_kernels(dev, rows)
    phase_train_blocks(dev, rows)
    train_counts, train, train_run = phase_train_step(dev, smi)
    train["parity"] = phase_train_parity(dev)
    prof["train_step"] = phase_train_profile(train_run)
    del train_run
    torch.cuda.empty_cache()
    train["fused_blocks"] = _timed("train-fused", phase_train_fused, dev,
                                   smi, train, prof["train_step"])
    log(f"[train] phases took {time.perf_counter() - t_train:.1f} s")
    t_high = time.perf_counter()
    phase_highres_kernels(dev, rows)
    phase_highres_blocks(dev, rows)
    high_counts, high = phase_highres_path(dev, smi)
    high["parity"] = phase_highres_parity(dev)
    log(f"[highres] phases took {time.perf_counter() - t_high:.1f} s")
    t_512 = time.perf_counter()
    train512_counts, train512 = phase_train512(dev, smi, rows)
    log(f"[train512] phases took {time.perf_counter() - t_512:.1f} s")
    t_flash = time.perf_counter()
    flash_counts, flash_parity = phase_flash(dev, rows)
    log(f"[flash] phases took {time.perf_counter() - t_flash:.1f} s")
    t_ck = time.perf_counter()
    ckpt = phase_checkpoint(dev, smi)
    log(f"[checkpoint] phase took {time.perf_counter() - t_ck:.1f} s")
    t_scst = time.perf_counter()
    phase_scst_kernels(dev, rows)
    scst_counts, scst = phase_scst(dev, smi, native_cider=True)
    scst["parity"] = phase_scst_parity(dev)
    log(f"[scst] phases took {time.perf_counter() - t_scst:.1f} s")
    for name in ("gemm", "layer_norm", "attention", "attention_bwd",
                 "decode_attention"):
        if scst_counts[name] == 0:
            raise AssertionError(f"{name}: no launch on the SCST path")
    t_pipe = time.perf_counter()
    pipe_counts, pipe = phase_pipeline(dev, smi, train["img_per_s"])
    log(f"[pipeline] phase took {time.perf_counter() - t_pipe:.1f} s")
    t_cbs = time.perf_counter()
    phase_cbs_kernels(dev, rows)
    cbs_counts, cbs = phase_cbs(dev, smi)
    cbs["parity"] = phase_cbs_parity(dev)
    log(f"[cbs] phases took {time.perf_counter() - t_cbs:.1f} s")
    t_dp = time.perf_counter()
    dp = phase_dp(dev, smi)
    log(f"[dp] phase took {time.perf_counter() - t_dp:.1f} s")
    t_m12 = time.perf_counter()
    module12 = {"pretrained": phase_pretrained(dev, smi),
                "scan": phase_scan(dev, smi)}
    log(f"[module12] phases took {time.perf_counter() - t_m12:.1f} s")
    t_zoo = time.perf_counter()
    phase_zoo_kernels(dev, rows)
    zoo = phase_zoo(dev, smi)
    zoo["parity"] = phase_zoo_parity(dev)
    log(f"[zoo] phases took {time.perf_counter() - t_zoo:.1f} s")
    t_zoo2 = time.perf_counter()
    zoo["cnn2"] = phase_zoo_cnn2(dev, smi)
    zoo["train"] = phase_zoo_train(dev, smi)
    zoo["cnn2_parity"] = phase_zoo_cnn2_parity(dev)
    log(f"[zoo2] phases took {time.perf_counter() - t_zoo2:.1f} s")
    t_zoo2b = time.perf_counter()
    zoo["cnn2b"] = phase_zoo_cnn2(dev, smi, models=ZOO_CNN2B, tag="zoo2b")
    zoo["train2b"] = phase_zoo_train(dev, smi, case=ZOO_TRAIN_2B,
                                     tag="zoo2b-train")
    zoo["cnn2b_parity"] = _zoo_cnn_parity(
        ZOO_CNN2B_PARITY, (dev, torch.device("cpu")), "zoo2b-parity")
    log(f"[zoo2b] phases took {time.perf_counter() - t_zoo2b:.1f} s")
    t_zoo2c = time.perf_counter()
    zoo["cnn2c"] = phase_zoo_cnn2(dev, smi, models=ZOO_CNN2C, tag="zoo2c")
    zoo["train2c"] = phase_zoo_train(dev, smi, case=ZOO_TRAIN_2C,
                                     tag="zoo2c-train")
    zoo["cnn2c_parity"] = _zoo_cnn_parity(
        ZOO_CNN2C_PARITY, (dev, torch.device("cpu")), "zoo2c-parity")
    log(f"[zoo2c] phases took {time.perf_counter() - t_zoo2c:.1f} s")
    t_host = time.perf_counter()
    host = phase_host_side(dev, smi, scst)
    log(f"[host19] phase took {time.perf_counter() - t_host:.1f} s")
    t_tp = time.perf_counter()
    tp = phase_tp(dev, smi, rows)
    tp["seconds"] = time.perf_counter() - t_tp
    log(f"[tp20] phase took {tp['seconds']:.1f} s")

    for name, n in counts.items():
        if n == 0 and name != "attention_bwd":
            raise AssertionError(f"{name}: no launch on the beam path")
    for name, n in train_counts.items():
        if n == 0 and name not in ("decode_attention", "attention[long]",
                                   "attention[non_slab]",
                                   "attention_bwd[long]",
                                   "attention_bwd[non_slab]",
                                   "attention[heads]", "attention[online]",
                                   "attention_bwd[heads]",
                                   "decode_attention[groups]",
                                   "attention[hd>64]", "layer_norm[wide]",
                                   "attention[tp]", "attention_bwd[tp]"):
            raise AssertionError(f"{name}: no launch on the train path")
    kernels = summarise(rows, counts, dict(
        train_counts, **{"attention[long]": high_counts["attention[long]"]},
        **{k: train512_counts[k] for k in ("attention[non_slab]",
                                           "attention_bwd[non_slab]")},
        **{k: flash_counts[k] for k in ("attention[heads]",
                                        "attention[online]",
                                        "attention_bwd[heads]",
                                        "fused_vit_attn", "tail_train")},
        **{"decode_attention[groups]":
           cbs_counts["decode_attention[groups]"]},
        **{k: zoo["mode_launches"][k] for k in ("attention[hd>64]",
                                                "layer_norm[wide]")},
        **{k: tp["workers"][0]["bf16"]["launches"][0][k]
           for k in ("attention[tp]", "attention_bwd[tp]")}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernel_launch": kernel_launch, "rows": rows,
         "greedy_path": greedy,
         "greedy_launches": greedy_counts, "beam_path": beam,
         "launches": counts, "train": train, "train_launches": train_counts,
         "profile": prof, "highres": high, "highres_launches": high_counts,
         "train512": train512, "train512_launches": train512_counts,
         "flash_launches": flash_counts, "flash_parity": flash_parity,
         "checkpoint": ckpt, "scst": scst, "scst_launches": scst_counts,
         "decode_attention_sweep": sweep, "pipeline": pipe,
         "pipeline_launches": pipe_counts, "cbs": cbs,
         "cbs_launches": cbs_counts, "dp": dp, "module12": module12,
         "zoo": zoo, "host_side": host, "tp": tp,
         "kernels": kernels},
        indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--zoo-counts"]:
        sys.path.insert(0, str(ROOT))
        zoo_counts(ZOO_CNN2C + [ZOO_TRAIN_2C[:2]])
        sys.exit(0)
    sys.exit(main())
