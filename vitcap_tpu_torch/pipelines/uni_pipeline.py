"""Experiment orchestration: the UniPipeline lifecycle, the port of
vitcap_tpu/pipelines/uni_pipeline.py (reference ViTCAP
src/pipelines/uni_pipeline.py:91-1130):

- the same experiment layout (`output/<full_expid>/snapshot`,
  `model_iter_{:07d}`), artifact naming (`<ckpt>.<data>.<split>…predict.tsv`,
  `<predict>.report`), mtime caching (`worth_create`), `parameters_*.yaml`
  snapshots, `.speed.yaml` and `.info.yaml`, `30e`-style iteration parsing;
- pipelines run on the card (`device: cuda`, the default) unless the
  config says `device: cpu`; asking for the card on a host without one
  raises, nothing falls back to the CPU;
- one process a device under `python -m torch.distributed.run
  --nproc_per_node N`: each rank runs on cuda:LOCAL_RANK (or the device the
  config names) in one process group (parallel/distributed.py), trains on
  its rows of each global batch and predicts its shard of the test set;
  rank 0 alone saves the parameters and snapshots, writes the
  `.info.yaml`, merges the per-rank predict shards (concatenated, the
  sampler's duplicated tail dropped, the dataset's key order restored)
  and evaluates;
- `loader: grain` (data/grain_loader.py, `grain_workers` processes) in
  place of the thread-pool DataLoader; `jax_profile_dir` (the YAML key the
  JAX package shares) writes a torch.profiler Chrome trace of the whole
  predict, and of a window of train steps (caption_pipeline.py).
"""

from __future__ import annotations

import json
import logging
import os
import os.path as op
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..data.dataset import (
    BatchSampler, DataLoader, DatasetPlusTransform, DistributedSampler,
    IterationBasedBatchSampler,
)
from ..data.tsv import (
    concat_tsv_files, delete_tsv_files, reorder_tsv_keys, tsv_writer,
)
from ..parallel import distributed
from ..parallel.mesh import data_rank, data_size, rank_device
from ..utils.common import (
    Config, ensure_directory, get_mpi_local_rank, get_mpi_rank, get_mpi_size,
    init_logging, save_parameters, worth_create, write_to_yaml_file,
)
from ..utils.meters import MetricLogger


class ProfileWindow:
    """The torch.profiler window behind `jax_profile_dir`: CPU activity,
    plus CUDA activity on the card.  stop() (or leaving the `with` block,
    an exception included) ends it and writes a Chrome trace
    `<folder>/<name>_<time>_<pid>.pt.trace.json`, whose path it returns."""

    def __init__(self, folder: str, name: str, device: torch.device):
        self.folder, self.name, self.device = folder, name, device
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        ensure_directory(self.folder)
        path = op.join(self.folder, f"{self.name}_"
                       f"{time.strftime('%Y%m%d_%H%M%S')}_"
                       f"{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        logging.info("profiler trace: %s", path)
        return path

    def __enter__(self) -> "ProfileWindow":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class UniPipeline:
    def __init__(self, **kwargs: Any):
        self._default: Dict[str, Any] = {
            "snapshot_steps": 5000,
            "test_batch_size": 1,
            "effective_batch_size": 8,
            "data": "Unknown",
            "net": "Unknown",
            "expid": "Unknown",
            "log_step": 100,
            "test_split": "test",
            "num_workers": 8,
            "base_lr": 0.1,
            "max_iter": 10,
            "random_seed": 88,
            "train_crop_size": 224,
            "test_crop_size": 224,
            "train_shuffle": True,
            "weight_decay": 1e-4,
            "scheduler_type": "linear",
            "warmup_steps": 0,
            "max_gen_length": 20,
            "crop_pct": 1.0,
            "force_train": False,
            "force_predict": False,
            "ignore_predict": False,
            "ignore_evaluate": False,
            "test_max_iter": None,
            "data_root": None,
            "output_root": "output",
            "basemodel": None,
            "train_label_version": None,
            "monitor_after": False,
            "device": "cuda",
        }
        self.kwargs = kwargs
        self.cfg = Config(self._default, kwargs)
        self.full_expid = kwargs.get("full_expid") or "_".join(
            [self.cfg.data, self.cfg.net, self.cfg.expid])
        self.output_folder = op.join(self.cfg.output_root, self.full_expid)
        self.model_folder = op.join(self.output_folder, "snapshot")
        self.mpi_rank = get_mpi_rank()
        self.mpi_size = get_mpi_size()
        self._max_iter: Optional[int] = None
        self.initialized = False

    @property
    def device(self) -> torch.device:
        """'cuda' -> cuda:LOCAL_RANK; 'cuda:N' and 'cpu' as named.  The card
        on a host without one, or past its count, raises RuntimeError."""
        return rank_device(self.cfg.device, get_mpi_local_rank())

    # ------------------------------------------------------------------
    # config / naming
    # ------------------------------------------------------------------

    @property
    def max_iter(self) -> int:
        if self._max_iter is None:
            self._max_iter = self.parse_iter(self.cfg.max_iter)
        return self._max_iter

    def parse_iter(self, i) -> int:
        """'30e' -> iterations from epochs (reference uni_pipeline.py:253)."""
        if isinstance(i, str) and i.endswith("e"):
            n = len(self.get_len_dataset(is_train=True))
            iter_each_epoch = n / self.cfg.effective_batch_size
            return int(float(i[:-1]) * iter_each_epoch)
        return int(i)

    def get_checkpoint_file(self, iteration: Optional[int] = None) -> str:
        if iteration is None:
            iteration = self.max_iter
        suffix = ".orbax" if self.cfg.get("checkpoint_backend") == "orbax" \
            else ".ckpt"
        path = op.join(self.model_folder,
                       f"model_iter_{iteration:07d}{suffix}")
        if not op.exists(path):
            # a released torch checkpoint dropped into the snapshot dir as
            # model_iter_*.pt evaluates through the bridge
            pt = op.join(self.model_folder, f"model_iter_{iteration:07d}.pt")
            if op.exists(pt):
                return pt
        return path

    def append_predict_param(self, cc: list) -> None:
        if self.cfg.test_max_iter is not None:      # speed-test predicate
            cc.append(f"max_iter{self.cfg.test_max_iter}")
            cc.append(f"BS{self.cfg.test_batch_size}")
        if self.cfg.max_gen_length != 20:
            cc.append(f"max_token{self.cfg.max_gen_length}")
        if self.cfg.test_crop_size and self.cfg.test_crop_size != 224:
            cc.append(f"crop{self.cfg.test_crop_size}")

    def get_predict_file(self, model_file: Optional[str] = None) -> str:
        if model_file is None:
            model_file = self.get_checkpoint_file()
        cc = [model_file, self.cfg.test_data, self.cfg.test_split]
        self.append_predict_param(cc)
        cc += ["predict", "tsv"]
        return ".".join(cc)

    def get_evaluate_file(self, predict_file: Optional[str] = None) -> str:
        if predict_file is None:
            predict_file = self.get_predict_file()
        assert predict_file.endswith(".tsv")
        return op.splitext(predict_file)[0] + ".report"

    def is_train_finished(self) -> bool:
        return op.exists(self.get_checkpoint_file())

    # ------------------------------------------------------------------
    # factories (subclass hooks)
    # ------------------------------------------------------------------

    def get_len_dataset(self, is_train: bool):
        raise NotImplementedError

    def get_transform(self, is_train: bool):
        raise NotImplementedError

    def get_dataset(self, is_train: bool):
        return DatasetPlusTransform(self.get_len_dataset(is_train),
                                    self.get_transform(is_train))

    def get_data_loader(self, is_train: bool, start_iter: int = 0,
                        dataset=None):
        if dataset is None:
            dataset = self.get_dataset(is_train)
        # the rows are the data axis's: the ranks of one model group (none
        # here without a grid) take the same rows
        rank, size = data_rank(), data_size()
        if is_train and self.cfg.effective_batch_size % size:
            raise ValueError(
                f"effective_batch_size {self.cfg.effective_batch_size} "
                f"does not divide over {size} ranks")
        per_rank = (self.cfg.effective_batch_size // size
                    if is_train else self.cfg.test_batch_size)
        if self.cfg.get("loader") == "grain":
            from ..data.grain_loader import GrainDataLoader
            return GrainDataLoader(
                dataset, per_rank,
                shuffle=is_train and bool(self.cfg.train_shuffle),
                seed=int(self.cfg.get("seed") or self.cfg.random_seed or 0),
                infinite=is_train,
                max_iter=self.max_iter if is_train else None,
                start_iter=start_iter,
                shard_index=rank, shard_count=size,
                num_workers=int(self.cfg.get("grain_workers") or 0))
        if is_train:
            sampler = DistributedSampler(dataset, size, rank,
                                         shuffle=self.cfg.train_shuffle)
            bs = BatchSampler(sampler, per_rank, drop_last=True)
            ibs = IterationBasedBatchSampler(bs, self.max_iter, start_iter)
            return DataLoader(dataset, ibs,
                              num_workers=self.cfg.num_workers)
        sampler = DistributedSampler(dataset, size, rank, shuffle=False)
        bs = BatchSampler(sampler, self.cfg.test_batch_size, drop_last=False)
        return DataLoader(dataset, bs, num_workers=self.cfg.num_workers)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _ensure_initialized(self) -> None:
        if self.initialized:
            return
        distributed.ensure_init_distributed(device=self.device)
        self.mpi_rank = distributed.rank()
        self.mpi_size = distributed.world_size()
        ensure_directory(self.output_folder)
        ensure_directory(self.model_folder)
        init_logging(self.mpi_rank, self.output_folder)
        np.random.seed(self.cfg.random_seed)
        self.initialized = True

    def ensure_train(self):
        self._ensure_initialized()
        last = self.get_checkpoint_file()
        if op.exists(last) and not self.cfg.force_train:
            logging.info("skip to train: %s exists", last)
            return
        if self.mpi_rank == 0:
            save_parameters(self.kwargs, self.output_folder)
        out = self.train()
        # every rank leaves training once rank 0's final snapshot is
        # written: a fast peer would otherwise find no model file and skip
        # predicting, and the predict merge's barriers would not pair up
        self._barrier()
        return out

    def train(self):
        raise NotImplementedError

    def ensure_predict(self, model_file: Optional[str] = None) -> str:
        if self.cfg.ignore_predict:
            return ""
        self._ensure_initialized()
        if model_file is None:
            model_file = self.get_checkpoint_file()
        predict_file = self.get_predict_file(model_file)
        if not op.exists(model_file):
            logging.info("no model file %s; skip predict", model_file)
            return predict_file
        if not worth_create(model_file, predict_file) \
                and not self.cfg.force_predict:
            logging.info("cached: %s", predict_file)
            return predict_file
        self.predict(model_file, predict_file)
        return predict_file

    def get_rank_specific_tsv(self, f: str, rank: int) -> str:
        return f"{f}_{rank}_{self.mpi_size}.tsv"

    def predict(self, model_file: str, predict_file: str) -> str:
        """Each rank writes its shard (`<predict>_<rank>_<world>.tsv`, with
        its `.speed.yaml`); between two barriers rank 0 concatenates the
        shards, drops the sampler's duplicated tail, restores the dataset's
        key order into `predict_file` and deletes the shards."""
        sub_file = predict_file if self.mpi_size == 1 else \
            self.get_rank_specific_tsv(predict_file, self.mpi_rank)
        model = self.load_test_model(model_file)
        dataset = self.get_dataset(is_train=False)
        loader = self.get_data_loader(is_train=False, dataset=dataset)
        meters = MetricLogger()
        profile_dir = self.cfg.get("jax_profile_dir")
        if profile_dir:                   # a trace of the whole predict
            with ProfileWindow(profile_dir, f"predict_rank{self.mpi_rank}",
                               self.device):
                tsv_writer(self.predict_iter(loader, model, meters),
                           sub_file)
        else:
            tsv_writer(self.predict_iter(loader, model, meters), sub_file)
        logging.info(str(meters))
        # per-prediction speed report (reference .speed.yaml,
        # uni_pipeline.py:804-805); `module_time` carries the per-stage
        # device table when the pipeline measured one (`speed_breakdown`)
        speed = meters.get_info()
        if getattr(self, "speed_info", None):
            speed["module_time"] = self.speed_info
        write_to_yaml_file(speed, sub_file + ".speed.yaml")
        if self.mpi_rank == 0:
            write_to_yaml_file(self.kwargs, predict_file + ".info.yaml")
        self._barrier()
        if self.mpi_size > 1 and self.mpi_rank == 0:
            shards = [self.get_rank_specific_tsv(predict_file, i)
                      for i in range(self.mpi_size)]
            before = predict_file + ".before.reorder.tsv"
            concat_tsv_files(shards, before)
            reorder_tsv_keys(before, dataset.get_keys(), predict_file)
            delete_tsv_files(shards + [before])
        self._barrier()
        return predict_file

    def _barrier(self) -> None:
        distributed.barrier("vitcap_pipeline")

    def load_test_model(self, model_file: str):
        raise NotImplementedError

    def predict_iter(self, dataloader, model, meters) -> Iterator:
        raise NotImplementedError

    def ensure_evaluate(self, predict_file: Optional[str] = None
                        ) -> Optional[Dict[str, float]]:
        """Rank 0 evaluates; the other ranks return None."""
        if self.mpi_rank != 0:
            return None
        if self.cfg.ignore_evaluate or self.cfg.ignore_predict:
            return None
        self._ensure_initialized()
        if predict_file is None:
            predict_file = self.get_predict_file()
        evaluate_file = self.get_evaluate_file(predict_file)
        if not worth_create(predict_file, evaluate_file) \
                and not self.cfg.force_predict:
            logging.info("cached: %s", evaluate_file)
            with open(evaluate_file) as f:
                return json.load(f)
        return self.evaluate(predict_file, evaluate_file)

    def evaluate(self, predict_file: str, evaluate_file: str):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # monitor: evaluate every intermediate checkpoint
    # ------------------------------------------------------------------

    def intermediate_checkpoints(self):
        import glob
        pat = op.join(self.model_folder, "model_iter_*.ckpt")
        final = self.get_checkpoint_file()
        for f in sorted(glob.glob(pat)):
            if f != final:
                yield f

    def monitor_train(self) -> None:
        """predict+evaluate each intermediate snapshot, then plot
        metric-vs-iteration PNGs and export TensorBoard scalars
        (reference uni_pipeline.py:1021-1079, plot_to_file common.py:449)."""
        self._ensure_initialized()
        by_iter: Dict[int, Dict[str, float]] = {}
        for ckpt in self.intermediate_checkpoints():
            pf = self.ensure_predict(model_file=ckpt)
            if pf and op.isfile(pf):
                rep = self.ensure_evaluate(pf)
                if rep:
                    it = int(op.basename(ckpt).split("_")[-1]
                             .split(".")[0])
                    by_iter[it] = rep
        if by_iter:
            self._plot_and_tensorboard(by_iter)

    def _plot_and_tensorboard(self, by_iter: Dict[int, Dict[str, float]]
                              ) -> None:
        iters = sorted(by_iter)
        metrics = sorted({k for r in by_iter.values() for k in r
                          if isinstance(r[k], (int, float))})
        img_dir = op.join(self.output_folder, "images")
        ensure_directory(img_dir)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            for m in metrics:
                xs = [i for i in iters if m in by_iter[i]]
                ys = [by_iter[i][m] for i in xs]
                fig, ax = plt.subplots()
                ax.plot(xs, ys, marker="o")
                ax.set_xlabel("iteration")
                ax.set_ylabel(m)
                ax.grid(True)
                fig.savefig(op.join(
                    img_dir,
                    f"map_{self.cfg.test_data}_{self.cfg.test_split}_{m}.png"))
                plt.close(fig)
        except Exception as e:                     # pragma: no cover
            logging.info("plotting unavailable: %s", e)
        try:
            from torch.utils.tensorboard import SummaryWriter
            with SummaryWriter(op.join(self.output_folder,
                                       "tensorboard")) as w:
                for i in iters:
                    for m, v in by_iter[i].items():
                        if isinstance(v, (int, float)):
                            w.add_scalar(m, v, i)
        except Exception as e:                     # pragma: no cover
            logging.info("tensorboard unavailable: %s", e)
