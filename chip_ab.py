#!/usr/bin/env python3
"""Compare the gemm and attention kernels of two checkouts on one NVIDIA GPU.

    python3 chip_ab.py PARENT_TREE . . PARENT_TREE

Runs each tree's chip_smoke.py kernel phases, one process per argument and
in the order given (parent, change, change, parent puts both on the same
card in turns): phase 3 (phase_kernels: the gemm's encoder products and
LayerNorm at B * 592 rows, the slab attention at the ViT, the prefill and
a ragged shape), the gemm at the fused decode step's four products (M =
128 greedy and 384 beam-3 rows; phase_decode_gemm, this script's own copy
for a tree that lacks it), phase 8 (phase_train_kernels: gemm[pre_out],
gemm[dropout], attention with prob dropout and attention_bwd), phase 9
(phase_highres_kernels: the gemm, LayerNorm and decode_attention rows at
512 px, the slab attention past 1024 tokens), phase 10
(phase_train512_kernels: the strided kernels on separate q, k, v past 1024
tokens) and phase 11 (phase_flash_kernels: K9's forward on per-head views,
rows attention[heads] at 577 and attention[online] at 1025, and its
backward).  Then one flagship fused greedy batch at 384 px (B=64, bf16,
VITCAP_DECODE_FUSED=1; host clock around synchronised work, median of 3
after a warm-up, encode + prefill timed alone the same way), and the
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
SHOWN = ("gemm", "attention", "serve", "train_step")


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


def fused_greedy_ms(cs, dev):
    """One flagship fused greedy batch at 384 px on the tree's model code:
    (batch ms, encode + prefill ms), each the median of 3 synchronised
    calls after a warm-up batch."""
    import numpy as np
    import torch
    from vitcap_tpu_torch.models import decode as TD
    cfg, model = cs._flagship(dev)
    rs = np.random.RandomState(cs.SEED + 3)
    imgs = torch.from_numpy(rs.randint(0, 256, (cs.B, cfg.img_size,
                                                 cfg.img_size, 3))
                            .astype(np.uint8)).to(dev)
    od = torch.zeros(cs.B, cfg.max_seq_len - cfg.max_seq_a_len,
                     dtype=torch.long, device=dev)
    sl = torch.full((cs.B,), cfg.max_seq_a_len, device=dev)
    opts = cs._opts(cfg)
    with cs._engine(True):
        TD.generate(model, imgs, od, None, sl, cfg, opts)
        prefill = cs._median_ms(lambda: TD.build_decode_context(
            model, imgs, od, None, sl, cfg, opts))
        batch = cs._median_ms(lambda: TD.generate(model, imgs, od, None, sl,
                                                  cfg, opts))
    del model
    torch.cuda.empty_cache()
    return batch, prefill


def _own_chip_smoke():
    """This script's sibling chip_smoke.py, for what an older tree's copy
    lacks."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str) -> None:
    """In this process: the kernel phases of `tree`'s chip_smoke.py and
    its train steps at 384 and 512 px; the rows as one JSON line on
    stdout."""
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
    cs.phase_kernels(dev, rows)
    decode_gemm = getattr(cs, "phase_decode_gemm", None)
    (decode_gemm or _own_chip_smoke().phase_decode_gemm)(dev, rows)
    cs.phase_train_kernels(dev, rows)
    cs.phase_highres_kernels(dev, rows)
    cs.phase_train512_kernels(dev, rows)
    cs.phase_flash_kernels(dev, rows)
    torch.cuda.empty_cache()
    smi = cs.phase_host()
    batch, prefill = fused_greedy_ms(cs, dev)
    rows.append(dict(kernel="serve", case="greedy fused 384", dtype="bf16",
                     ms=batch))
    rows.append(dict(kernel="serve", case="encode+prefill 384",
                     dtype="bf16", ms=prefill))
    for case, img in (("384 px", None), ("512 px", cs.HIGHRES)):
        med, mean = train_step_ms(cs, dev, smi, img)
        rows.append(dict(kernel="train_step", case=case, dtype="bf16",
                         ms=med, phase_mean_ms=mean))
    print("ROWS " + json.dumps(rows), flush=True)


def main() -> int:
    trees = sys.argv[1:]
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
                               "--worker", tree], capture_output=True,
                              text=True, env=dict(os.environ))
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"chip_ab: run {i} ({tree}) failed")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("ROWS "))
        rows = json.loads(line[5:])
        runs.append({"run": i, "tree": tree, "rows": rows})
        for r in rows:
            if r["kernel"].startswith(SHOWN):
                print(f"[ab] run {i} {tree:24s} {r['kernel']:24s} "
                      f"{r['case']:24s} {r['dtype']:4s} {r['ms']:.4f} ms",
                      flush=True)
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
        worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
