#!/usr/bin/env python3
"""Compare the gemm and attention kernels of two checkouts on one NVIDIA GPU.

    python3 chip_ab.py PARENT_TREE . . PARENT_TREE

Runs each tree's chip_smoke.py kernel phases, one process per argument and
in the order given (parent, change, change, parent puts both on the same
card in turns): phase 3 (phase_kernels: the gemm's encoder products and
LayerNorm at B * 592 rows, the slab attention at the ViT, the prefill and
a ragged shape), the gemm at the fused decode step's four products (M =
128 greedy and 384 beam-3 rows; phase_decode_gemm, this script's own copy
for a tree that lacks it), the LayerNorm at the step's post-LN shapes
(the same rows, f32 in, bf16 out; phase_decode_layer_norm, likewise),
decode_attention at 384 px (the tree's phase_decode_attention: greedy and
beam-3, back-to-back launches) and, for every tree the same way, bf16
decode_attention per call from a CUDA graph at 384 and 512 px (greedy and
beam-3; rows "decode_attention" case "graph ...") and the LayerNorm per
call from CUDA graphs at the encoder, train and 512-px rows (rows
"layer_norm" case "graph ..."; back-to-back launches of a kernel this
short can time the host), phase 8 (phase_train_kernels: gemm[pre_out],
gemm[dropout], attention with prob dropout and attention_bwd), phase 9
(phase_highres_kernels: the gemm, LayerNorm and decode_attention rows at
512 px, the slab attention past 1024 tokens), phase 10
(phase_train512_kernels: the strided kernels on separate q, k, v past 1024
tokens) and phase 11 (phase_flash_kernels: K9's forward on per-head views,
rows attention[heads] at 577 and attention[online] at 1025, and its
backward).  Then three flagship fused batches (B=64, bf16,
VITCAP_DECODE_FUSED=1): greedy and beam-3 at 384 px, greedy on 512x512
images against the 384-px weights (host clock around synchronised work,
median of 3 after warm-ups, encode + prefill timed alone the same way;
device busy time and idle share from torch.profiler over one more batch,
the tree's _profile), and the
flagship train step at 384 px and at 512 px (B=64, bf16, attention
dropout 0.1), each built and checked by the tree's own phase_train_step
(one warm-up step and its timed steps, with their exact launch counts;
the parity checks are skipped), then STEPS more steps timed one by one
(host clock around synchronised work): the median is the step's ms.  Each
process builds its tree's kernels into that tree's build/ directory.
Prints one line per gemm and attention row, serving batch and train step
per run, then each row's times across the runs, and writes every row to
chiprun_out/chip_ab.json.  Exits non-zero without a CUDA device or when
any check of a phase fails.

    python3 chip_ab.py --decode-attention PARENT_TREE . . PARENT_TREE

runs only the build, the CUDA-graph decode_attention rows (DECODE_GRAPH:
greedy and beam-3 at 384 and 512 px, constrained beam search's 160 beams
an image at 384 px) and the bf16 attention at the model zoo's head dims 80
and 96 (ZOO_ATTENTION: ViT-H/14 and the old ViT-S/16 at B=64, back to back,
with SDPA on the same inputs) in each process: a quick comparison of those
kernels alone.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
STEPS = 6                     # train steps timed one by one per size
# the rows printed per run and across the runs
SHOWN = ("gemm", "attention", "decode_attention", "layer_norm", "serve",
         "train_step")
# (case, context keys S, beams) of the CUDA-graph decode_attention rows
DECODE_GRAPH = (("graph greedy 384", 628, 1), ("graph beam3 384", 628, 3),
                ("graph greedy 512", 1076, 1), ("graph beam3 512", 1076, 3),
                ("graph cbs160 384", 628, 160))
# (case, heads, head dim, l_actual) of the zoo's attention rows, B=64 bf16
ZOO_ATTENTION = (("zoo hd80", 16, 80, 257), ("zoo hd96", 8, 96, 197))


def train_step_ms(cs, dev, smi, img=None):
    """The tree's flagship train step at img x img (default 384): built,
    warmed up and checked by its phase_train_step, then STEPS steps timed
    one by one; (median ms, the phase's own mean ms)."""
    import torch
    kw = {}
    if img is not None:
        kw = dict(img=img, per_step_want=cs.TRAIN_512_PER_STEP,
                  modes_want=cs.TRAIN_512_MODES_PER_STEP, steps=STEPS,
                  tag="train512")
    _, out, (state, step, batch) = cs.phase_train_step(dev, smi, **kw)
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, batch, False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del state, step, batch
    torch.cuda.empty_cache()
    return statistics.median(times), out["step_ms"]


def fused_batches(cs, dev):
    """Flagship fused batches on the tree's model code: greedy and beam-3
    at 384 px, greedy on 512x512 images.  Per batch (case, batch ms,
    encode + prefill ms, device busy ms, idle share): the batch and the
    prefill each the median of 3 synchronised calls after a warm-up; the
    busy time and idle share from the tree's _profile (its own median of
    3, then one profiled batch)."""
    import numpy as np
    import torch
    from vitcap_tpu_torch.models import decode as TD
    cfg, model = cs._flagship(dev)
    out = []
    for case, img, beams in (("greedy fused 384", cfg.img_size, 1),
                             ("beam3 fused 384", cfg.img_size, 3),
                             ("greedy fused 512", cs.HIGHRES, 1)):
        rs = np.random.RandomState(cs.SEED + 3)
        imgs = torch.from_numpy(rs.randint(0, 256, (cs.B, img, img, 3))
                                .astype(np.uint8)).to(dev)
        od = torch.zeros(cs.B, cfg.max_seq_len - cfg.max_seq_a_len,
                         dtype=torch.long, device=dev)
        sl = torch.full((cs.B,), cfg.max_seq_a_len, device=dev)
        opts = cs._opts(cfg, num_beams=beams) if beams > 1 else cs._opts(cfg)
        with cs._engine(True):
            TD.generate(model, imgs, od, None, sl, cfg, opts)
            prefill = cs._median_ms(lambda: TD.build_decode_context(
                model, imgs, od, None, sl, cfg, opts))
            batch = cs._median_ms(lambda: TD.generate(model, imgs, od, None,
                                                      sl, cfg, opts))
            prof = cs._profile(f"ab_{case.replace(' ', '_')}",
                               lambda: TD.generate(model, imgs, od, None, sl,
                                                   cfg, opts))
        out.append((case, batch, prefill, prof["device_busy_ms"],
                    prof["idle_share"]))
        del imgs
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return out


def layer_norm_graph(own, dev, rows):
    """The tree's layer_norm per call from a CUDA graph of 50 calls
    (own.graph_ms) at the rows of phase_kernels, phase_train_kernels and
    phase_highres_kernels (B=64, H=768): ln and post-ln f32-in at 592 and
    1152 tokens an image, in bf16 and f32; with stats at 592 and 656
    tokens; rows "graph ...", checked against the plain version."""
    import torch
    from vitcap_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    g = torch.Generator().manual_seed(own.SEED + 17)
    H = 768
    cases = [(f"graph {name}{tag}", M, odt, idt or odt, st)
             for odt in (torch.bfloat16, torch.float32)
             for tag, M in (("", own.B * 592), (" long", own.B * 1152))
             for name, idt, st in (("ln", None, False),
                                   ("post-ln f32-in", torch.float32,
                                    False))]
    cases += [(f"graph stats {name}", own.B * L, odt, odt, True)
              for odt in (torch.bfloat16, torch.float32)
              for name, L in (("vit rows", 592), ("bert rows", 656))]
    for case, M, odt, idt, st in cases:
        x = (torch.randn(M, H, generator=g) * 3 + 1).to(dev, idt)
        gm = (torch.randn(H, generator=g) + 1).to(dev)
        bt = torch.randn(H, generator=g).to(dev)
        out = layer_norm(x, gm, bt, 1e-6, odt, stats=st)
        ref = layer_norm_plain(x, gm, bt, 1e-6, odt, stats=st)
        err = own.compare(f"layer_norm {case}", out[0] if st else out,
                          ref[0] if st else ref, odt)
        ms = own.graph_ms(lambda: layer_norm(x, gm, bt, 1e-6, odt,
                                             stats=st))
        rows.append(dict(kernel="layer_norm", case=case,
                         dtype="bf16" if odt == torch.bfloat16 else "f32",
                         ms=ms, max_abs_err=err))
        del x, out, ref
        torch.cuda.empty_cache()


def decode_attention_graph(own, dev, rows):
    """The tree's bf16 decode_attention per call from a CUDA graph of 20
    calls (own.graph_ms) at DECODE_GRAPH's geometries, own's flagship-
    width inputs (B=64, 12 heads of 64, A=20, t=10), checked against the
    plain version within the bf16 tolerance."""
    import torch
    from vitcap_tpu_torch.ops.decode_step import (decode_attention,
                                                  decode_attention_plain)
    g = torch.Generator().manual_seed(own.SEED + 5)
    dt, nh, A, t = torch.bfloat16, 12, 20, 10
    t_dev = torch.tensor([t], dtype=torch.int32, device=dev)
    for case, S, nb in DECODE_GRAPH:
        d = own._decode_attention_inputs(dev, dt, nb, t, S, A, 768, g)
        caps = [d["cap_k"].clone(), d["cap_v"].clone()]
        args = (d["ctx_k"], d["ctx_v"], d["bias"])
        out = decode_attention(d["qkv"], *caps, *args, t_dev, nh)
        ref = decode_attention_plain(d["qkv"], d["cap_k"], d["cap_v"], *args,
                                     t, nh)
        err = own.compare(f"decode_attention {case}", out, ref, dt)
        ms = own.graph_ms(lambda: decode_attention(d["qkv"], *caps, *args,
                                                   t_dev, nh),
                          20 if nb <= 16 else 5)
        rows.append(dict(kernel="decode_attention", case=case, dtype="bf16",
                         ms=ms, max_abs_err=err,
                         bit_equal=(out == ref).float().mean().item()))
        del d, caps, out, ref
        torch.cuda.empty_cache()


def zoo_attention(own, dev, rows):
    """The tree's bf16 slab attention at ZOO_ATTENTION's shapes (B=64,
    Lp = pad_len(L)), back to back over two inputs (own.cuda_ms), checked
    against the plain version within the bf16 tolerance, and SDPA on the
    same inputs (rows "sdpa <case>")."""
    import torch
    import torch.nn.functional as F
    from vitcap_tpu_torch.ops.attention import attention, attention_plain
    from vitcap_tpu_torch.ops.fused_block import pad_len
    g = torch.Generator().manual_seed(own.SEED + 40)
    Bn = own.ZOO_B
    for case, nh, hd, L in ZOO_ATTENTION:
        Lp, H = pad_len(L), nh * hd
        slab = [torch.randn(Bn, Lp, 3 * H, generator=g).to(dev,
                                                            torch.bfloat16)
                for _ in range(2)]
        out, ref = attention(slab[0], nh, L), attention_plain(slab[0], nh, L)
        err = own.compare(f"attention {case}", out, ref, torch.bfloat16)
        eq = (out == ref).float().mean().item()
        ms = own.cuda_ms(lambda i: attention(slab[i % 2], nh, L), 10)
        mask = torch.zeros(Bn, 1, Lp, Lp, device=dev, dtype=torch.bfloat16)
        mask[..., L:] = float("-inf")
        qkv = [x.view(Bn, Lp, 3, nh, hd).permute(2, 0, 3, 1, 4) for x in slab]
        lms = own.cuda_ms(lambda i: F.scaled_dot_product_attention(
            qkv[i % 2][0], qkv[i % 2][1], qkv[i % 2][2], attn_mask=mask), 10)
        rows.append(dict(kernel="attention", case=case, dtype="bf16", ms=ms,
                         max_abs_err=err, bit_equal=eq))
        rows.append(dict(kernel="attention", case=f"sdpa {case}",
                         dtype="bf16", ms=lms))
        del slab, qkv, mask, out, ref
        torch.cuda.empty_cache()


def _own_chip_smoke():
    """This script's sibling chip_smoke.py, for what an older tree's copy
    lacks."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, decode_only: bool = False) -> None:
    """In this process: the kernel phases of `tree`'s chip_smoke.py and
    its train steps at 384 and 512 px (decode_only: the CUDA-graph
    decode_attention rows alone); the rows as one JSON line on stdout."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    sys.path.insert(0, str(Path(tree).resolve()))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    cs.phase_build()
    rows = []
    own = _own_chip_smoke()
    if decode_only:
        decode_attention_graph(own, dev, rows)
        zoo_attention(own, dev, rows)
        print("ROWS " + json.dumps(rows), flush=True)
        return
    cs.phase_kernels(dev, rows)
    decode_gemm = getattr(cs, "phase_decode_gemm", None)
    (decode_gemm or own.phase_decode_gemm)(dev, rows)
    decode_ln = getattr(cs, "phase_decode_layer_norm", None)
    (decode_ln or own.phase_decode_layer_norm)(dev, rows)
    cs.phase_decode_attention(dev, rows)
    decode_attention_graph(own, dev, rows)
    layer_norm_graph(own, dev, rows)
    cs.phase_train_kernels(dev, rows)
    cs.phase_highres_kernels(dev, rows)
    cs.phase_train512_kernels(dev, rows)
    cs.phase_flash_kernels(dev, rows)
    torch.cuda.empty_cache()
    smi = cs.phase_host()
    for case, batch, prefill, busy, idle in fused_batches(cs, dev):
        rows.append(dict(kernel="serve", case=case, dtype="bf16", ms=batch,
                         device_busy_ms=busy, idle_share=idle))
        rows.append(dict(kernel="serve", case=f"encode+prefill "
                         f"{case.split()[-1]} {case.split()[0]}",
                         dtype="bf16", ms=prefill))
        rows.append(dict(kernel="serve", case=f"{case} busy", dtype="bf16",
                         ms=busy))
    for case, img in (("384 px", None), ("512 px", cs.HIGHRES)):
        med, mean = train_step_ms(cs, dev, smi, img)
        rows.append(dict(kernel="train_step", case=case, dtype="bf16",
                         ms=med, phase_mean_ms=mean))
    print("ROWS " + json.dumps(rows), flush=True)


def main() -> int:
    trees = sys.argv[1:]
    flags = [a for a in trees if a == "--decode-attention"]
    trees = [a for a in trees if a not in flags]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ab] card: {smi}", flush=True)
    runs = []
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", tree, *flags],
                              capture_output=True, text=True,
                              env=dict(os.environ))
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"chip_ab: run {i} ({tree}) failed")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("ROWS "))
        rows = json.loads(line[5:])
        runs.append({"run": i, "tree": tree, "rows": rows})
        for r in rows:
            if r["kernel"].startswith(SHOWN):
                idle = (f"  idle share {r['idle_share']:.4f}"
                        if "idle_share" in r else "")
                print(f"[ab] run {i} {tree:24s} {r['kernel']:24s} "
                      f"{r['case']:24s} {r['dtype']:4s} {r['ms']:.4f} ms"
                      f"{idle}", flush=True)
    print("[ab] ms per run, in the order given", flush=True)
    by_run = [{(r["kernel"], r["case"], r["dtype"]): r["ms"]
               for r in run["rows"]} for run in runs]
    for r in runs[0]["rows"]:
        if r["kernel"].startswith(SHOWN):
            key = (r["kernel"], r["case"], r["dtype"])
            ms = " / ".join(f"{t[key]:.4f}" if key in t else "-"
                            for t in by_run)
            print(f"[ab] {r['kernel']:24s} {r['case']:28s} {r['dtype']:4s} "
                  f"{ms}", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_ab.json").write_text(json.dumps(
        {"card": smi, "runs": runs}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], "--decode-attention" in sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
