"""Datasets, dict-transform ops, samplers, and a prefetching host loader:
the port's copy of vitcap_tpu/data/dataset.py, so that the port's batches
are the JAX package's, batch for batch.

Re-implementation of the reference data layer (ViTCAP
src/data_layer/dataset.py:8-110, transform.py:84-288, samplers.py:8-152,
builder.py:4-39):

- samples/batches are plain numpy (NHWC images), moved to the device by
  the pipeline;
- the loader is a thread-pool prefetcher (JPEG decode + PIL resize release
  the GIL) rather than forked torch DataLoader workers.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .tsv import TSVDataset, TSVSplitProperty
from .transforms import img_from_base64


class Compose:
    def __init__(self, ops: Sequence[Callable]):
        self.ops = list(ops)

    def __call__(self, data):
        for op in self.ops:
            data = op(data)
        return data


class DatasetPlusTransform:
    def __init__(self, dataset, transform):
        self.dataset = dataset
        self.transform = transform

    def get_keys(self):
        return self.dataset.get_keys()

    def __getitem__(self, idx):
        data = self.dataset[idx]
        if self.transform is not None:
            data = self.transform(data)
        return data

    def __len__(self):
        return len(self.dataset)


class CaptionIdxTSVDataset:
    """Train index: one sample per (image, caption) pair, built from the
    `num_caption` TSV (reference dataset.py:35-75)."""

    def __init__(self, data: str, split: str,
                 caption_version: Optional[str] = None,
                 data_root: Optional[str] = None):
        self.data, self.split = data, split
        num_cap = TSVSplitProperty(data, split, "num_caption",
                                   version=caption_version,
                                   data_root=data_root)
        self.k_img_cap = [
            (row[0], idx_img, idx_cap)
            for idx_img, row in enumerate(num_cap)
            for idx_cap in range(int(row[1]))]

    def __getitem__(self, idx):
        key, idx_img, idx_cap = self.k_img_cap[idx]
        return {"idx": idx, "idx_img": idx_img, "idx_cap": idx_cap}

    def get_keys(self):
        return [k for k, _, _ in self.k_img_cap]

    def __len__(self):
        return len(self.k_img_cap)


class ImageIdxTSVDataset:
    """Test index: one sample per image row (reference dataset.py:78-109)."""

    def __init__(self, data: str, split: str,
                 data_root: Optional[str] = None):
        self.data, self.split = data, split
        self.data_root = data_root
        tsv = TSVSplitProperty(data, split, data_root=data_root)
        self.total_num = len(tsv)
        ds = TSVDataset(data, data_root=data_root)
        if ds.has(split, "hw"):
            self.keys = [k for k, _ in ds.iter_data(split, "hw")]
        else:
            self.keys = [tsv.seek_first_column(i)
                         for i in range(self.total_num)]

    def get_keys(self):
        return self.keys

    def __getitem__(self, idx):
        return {"idx": idx, "idx_img": idx, "key": self.keys[idx]}

    def __len__(self):
        return self.total_num


# ---------------------------------------------------------------------------
# dict-in / dict-out transform ops (reference transform.py:84-288)
# ---------------------------------------------------------------------------

class LoadHW:
    def __init__(self, data, split, data_root=None):
        self.tsv = TSVSplitProperty(data, split, "hw", data_root=data_root)

    def __call__(self, data):
        key, str_hw = self.tsv[data["idx_img"]]
        data.setdefault("key", key)
        try:
            info = json.loads(str_hw)
            if isinstance(info, list):
                info = info[0]
            data.update(info)
        except ValueError:
            h, w = map(int, str_hw.split(" "))
            data["height"], data["width"] = h, w
        return data


class LoadImage:
    """base64 column -> PIL RGB -> `image_transform` -> float32 HWC."""

    def __init__(self, data, split, image_transform=None, data_root=None,
                 add_key=False):
        self.tsv = TSVSplitProperty(data, split, data_root=data_root)
        self.image_transform = image_transform
        self.add_key = add_key

    def __call__(self, data):
        row = self.tsv[data["idx_img"]]
        img = None
        tf = self.image_transform
        if tf is not None and hasattr(tf, "from_jpeg_bytes"):
            # the fused native decode+resize+crop (transforms.py); None
            # for a payload libjpeg refuses or under image_backend: pil
            img = tf.from_jpeg_bytes(base64.b64decode(row[-1]))
        if img is None:
            img = img_from_base64(row[-1])
            if tf is not None:
                img = tf(img)
        data["image"] = img
        if self.add_key:
            data["key"] = row[0]
        return data


class LoadCaption:
    def __init__(self, data, split, version=None, data_root=None):
        self.tsv = TSVSplitProperty(data, split, "caption", version=version,
                                    data_root=data_root)

    def __call__(self, data):
        _, str_cap = self.tsv[data["idx_img"]]
        data["caption"] = json.loads(str_cap)[data["idx_cap"]]
        return data

    def get_captions_by_key(self, img_idx):
        return [c["caption"] for c in json.loads(self.tsv[img_idx][1])]


class LoadCaptionTags:
    """Offline-precomputed POS tag words per (image, caption) from
    `<split>.caption_tags.tsv` (tools/precompute_tags.py); replaces
    per-sample nltk tagging in the loader hot path."""

    def __init__(self, data, split, version=None, data_root=None):
        self.tsv = TSVSplitProperty(data, split, "caption_tags",
                                    version=version, data_root=data_root)

    def __call__(self, data):
        _, str_tags = self.tsv[data["idx_img"]]
        data["caption_tags"] = json.loads(str_tags)[data["idx_cap"]]
        return data


class LoadLabel:
    def __init__(self, data, split, version=None, data_root=None):
        self.tsv = TSVSplitProperty(data, split, "label", version=version,
                                    data_root=data_root)

    def __call__(self, data):
        _, str_label = self.tsv[data["idx_img"]]
        data["label"] = json.loads(str_label)
        return data


class IdentifyTextAB:
    """caption -> text_a; od labels (conf-filtered, conf-sorted, optionally
    deduped) -> text_b (reference transform.py:197-253).  NOTE: the live
    ViTCAP pipeline constructs this with add_od_labels=False, so text_b is
    always '' and the od/tag text slots stay PAD + unattended."""

    def __init__(self, add_od_labels: bool, od_label_conf: float,
                 label_sort_by_conf: bool = True,
                 unique_labels_on: bool = False):
        self.add_od_labels = add_od_labels
        self.od_label_conf = od_label_conf
        self.sort_by_conf = label_sort_by_conf
        self.unique_labels_on = unique_labels_on

    def __call__(self, data):
        if self.add_od_labels:
            info = data["label"]
            for lab in info:
                lab.setdefault("conf", 1.0)
            if info and self.od_label_conf > 0 and "conf" in info[0]:
                info = [l for l in info if l["conf"] >= self.od_label_conf]
            if self.sort_by_conf:
                info = sorted(info, key=lambda x: -x["conf"])
            if self.unique_labels_on:
                seen: List[str] = []
                for lab in info:
                    if lab["class"].lower() not in seen:
                        seen.append(lab["class"].lower())
                od_labels = " ".join(seen)
            else:
                od_labels = " ".join(l["class"].lower() for l in info)
        else:
            od_labels = ""
        cap = data.get("caption")
        data["text_a"] = cap["caption"] if cap else ""
        data["text_b"] = od_labels
        return data


class TransCaptionTensorizer:
    def __init__(self, tensorizer, real_text_a_in_test=False):
        self.tensorizer = tensorizer
        self.real_text_a_in_test = real_text_a_in_test

    def __call__(self, data):
        x = self.tensorizer.tensorize_ab(
            data["text_a"], text_b=data["text_b"],
            real_text_a_in_test=self.real_text_a_in_test)
        data.update(x)
        return data


class TagTensorize:
    def __init__(self, tensorizer):
        self.tensorizer = tensorizer

    def __call__(self, data):
        labels = data["label"]
        if isinstance(labels, dict) and "objects" in labels:
            labels = labels["objects"]
        cap = data.get("caption")
        kw = {}
        if "caption_tags" in data:
            kw["tag_words"] = data["caption_tags"]
        x = self.tensorizer.tensorize(
            labels, cap["caption"] if cap else None, **kw)
        data.update(x)
        return data


class RemoveUselessKeys:
    def __init__(self, keys):
        self.keys = keys

    def __call__(self, data):
        for k in self.keys:
            data.pop(k, None)
        return data


class RenameKey:
    def __init__(self, ft: Dict[str, str]):
        self.ft = ft

    def __call__(self, data):
        for k, k1 in self.ft.items():
            if k in data:
                data[k1] = data.pop(k)
        return data


# ---------------------------------------------------------------------------
# samplers (reference samplers.py)
# ---------------------------------------------------------------------------

class DistributedSampler:
    """Epoch-seeded shuffle, tail-duplicated to divisible length, contiguous
    per-rank slice (reference samplers.py:86-152)."""

    def __init__(self, dataset, num_replicas: int, rank: int,
                 shuffle: bool = True, length_divisible: int = 1):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        if length_divisible > 1:
            self.num_samples = -(-self.num_samples // length_divisible) \
                * length_divisible
        self.total_size = self.num_samples * num_replicas
        self.shuffle = shuffle

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]
        off = self.num_samples * self.rank
        return iter(indices[off: off + self.num_samples])

    def __len__(self):
        return self.num_samples


class BatchSampler:
    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch: List[int] = []
        for i in self.sampler:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)


class IterationBasedBatchSampler:
    """Re-iterates until num_iterations, bumping the epoch each pass
    (reference samplers.py:57-83; note: set_epoch is called per-iteration
    there, we keep per-pass which gives the same no-repeat guarantee)."""

    def __init__(self, batch_sampler, num_iterations: int, start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        iteration = self.start_iter
        epoch = 0
        while iteration < self.num_iterations:
            if hasattr(self.batch_sampler.sampler, "set_epoch"):
                self.batch_sampler.sampler.set_epoch(epoch)
            epoch += 1
            yielded = False
            for batch in self.batch_sampler:
                yielded = True
                if iteration >= self.num_iterations:
                    break
                yield batch
                iteration += 1
            if not yielded:
                # e.g. drop_last with batch_size > dataset size: every
                # epoch is empty and the while-loop would spin forever
                raise RuntimeError(
                    "batch sampler produced no batches (batch_size larger "
                    "than the per-rank dataset with drop_last?)")

    def __len__(self):
        return self.num_iterations


# ---------------------------------------------------------------------------
# collate + prefetching loader
# ---------------------------------------------------------------------------

def collate_numpy(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array/scalar fields; keep strings/objects as lists
    (reference builder.py:4-39 without the ragged-pad branch: pad_to_max
    is the live default so shapes are already static)."""
    out: Dict[str, Any] = {}
    first = samples[0]
    for k in first:
        vals = [s[k] for s in samples]
        v0 = vals[0]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(v0, (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


def pert_collate(samples: List[Dict[str, Any]], prob: float,
                 rng: Optional[np.random.RandomState] = None
                 ) -> Dict[str, Any]:
    """ITM-negative collate: shuffle the first int(n * prob) + 1 images so
    caption/image pairs mismatch; emits `matched` bool per row (reference
    pert_collate_fn dataset.py:846-856)."""
    rng = rng or np.random
    batch = collate_numpy(samples)
    n = batch["image"].shape[0]
    shuffle_len = int(n * prob) + 1
    idx = np.concatenate([rng.permutation(shuffle_len),
                          np.arange(shuffle_len, n)])
    batch["image"] = batch["image"][idx]
    batch["matched"] = idx == np.arange(n)
    return batch


class DataLoader:
    """Thread-pool prefetching loader: maps sample indices through the
    dataset transform in parallel and collates; keeps `prefetch` batches in
    flight to overlap host preprocessing with device steps."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 8,
                 collate_fn: Callable = collate_numpy, prefetch: int = 4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.collate_fn = collate_fn
        self.prefetch = prefetch

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            def load(batch_idx):
                return self.collate_fn(
                    [self.dataset[i] for i in batch_idx])

            pending = []
            it = iter(self.batch_sampler)
            try:
                for _ in range(self.prefetch):
                    pending.append(ex.submit(load, next(it)))
            except StopIteration:
                pass
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(ex.submit(load, next(it)))
                except StopIteration:
                    pass
                yield fut.result()
