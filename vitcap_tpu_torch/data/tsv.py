"""TSV storage engine, binary-compatible with the reference format: the
port's copy of vitcap_tpu/data/tsv.py.  A missing index is built as
`.lineidx.8b` by the native scanner (data/native_tsv.py); the Python line
scan `generate_lineidx` is its plain version.

Behavioral reference: ViTCAP src/tools/tsv/tsv_io.py — TSVFile (:174-370)
with sidecar `.lineidx` (ascii offsets :294-308) and `.lineidx.8b`
(little-endian u64 offsets :267-286), CompositeTSVFile (:80-171), TSVDataset
naming conventions (:373-833), atomic tmp-then-rename writers (:959-997),
concat/reorder (:1036/:54), iter_caption_to_json (:934-956).

Offsets are memory-mapped numpy arrays (no per-line python parsing), files
re-open on fork (PID change), and random access is O(1) via pread-style
seeks.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import os.path as op
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.common import ensure_directory, ensure_remove_file


def generate_lineidx(tsv_path: str, idx_path: str) -> None:
    """Scan a TSV and write ascii line offsets."""
    offsets = []
    with open(tsv_path, "rb") as fp:
        pos = 0
        for line in fp:
            offsets.append(pos)
            pos += len(line)
    tmp = idx_path + ".tmp"
    with open(tmp, "w") as fo:
        fo.write("\n".join(str(o) for o in offsets))
        if offsets:
            fo.write("\n")
    os.replace(tmp, idx_path)


class TSVFile:
    """Random-access TSV with `.lineidx.8b` (preferred) / `.lineidx` sidecars.

    Fork-safe (the reference re-opens on PID change, tsv_io.py:355-370) AND
    thread-safe: file handles are per-(pid, thread) via threading.local so
    the thread-pool DataLoader can seek concurrently without corrupting
    reads.
    """

    def __init__(self, tsv_path: str, generate_index: bool = True):
        self.tsv_path = tsv_path
        self.lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
        self.lineidx_8b_path = self.lineidx_path + ".8b"
        self._local = threading.local()
        self._offsets: Optional[np.ndarray] = None
        self._generate_index = generate_index

    def _ensure_offsets(self) -> None:
        if self._offsets is not None:
            return
        if not op.isfile(self.lineidx_8b_path) and not op.isfile(self.lineidx_path):
            if not self._generate_index:
                raise FileNotFoundError(
                    f"no lineidx for {self.tsv_path}")
            # the C++ scanner writes .lineidx.8b at disk speed
            from .native_tsv import build_lineidx_8b
            build_lineidx_8b(self.tsv_path, self.lineidx_8b_path)
        if op.isfile(self.lineidx_8b_path):
            if os.path.getsize(self.lineidx_8b_path) == 0:
                # empty TSV: memmap refuses 0-byte files
                self._offsets = np.empty(0, dtype=np.int64)
            else:
                self._offsets = np.memmap(self.lineidx_8b_path, dtype="<u8",
                                          mode="r")
        else:
            self._offsets = np.loadtxt(self.lineidx_path, dtype=np.int64,
                                       ndmin=1)

    @property
    def _fp(self):
        return getattr(self._local, "fp", None)

    def _ensure_fp(self) -> None:
        if self._fp is None or getattr(self._local, "pid", None) != os.getpid():
            if self._fp is not None:
                try:
                    self._local.fp.close()
                except Exception:
                    pass
            self._local.fp = open(self.tsv_path, "rb")
            self._local.pid = os.getpid()

    def num_rows(self) -> int:
        self._ensure_offsets()
        return len(self._offsets)

    __len__ = num_rows

    def seek(self, idx: int) -> List[str]:
        self._ensure_offsets()
        self._ensure_fp()
        if idx < 0 or idx >= len(self._offsets):
            raise IndexError(f"row {idx} out of range [0, {len(self._offsets)})")
        self._fp.seek(int(self._offsets[idx]))
        return self._fp.readline().decode("utf-8").rstrip("\r\n").split("\t")

    def seek_first_column(self, idx: int) -> str:
        self._ensure_offsets()
        self._ensure_fp()
        self._fp.seek(int(self._offsets[idx]))
        # read in chunks until the first tab
        buf = b""
        while True:
            chunk = self._fp.read(4096)
            if not chunk:
                break
            buf += chunk
            for sep in (b"\t", b"\n"):
                i = buf.find(sep)
                if i >= 0:
                    return buf[:i].decode("utf-8")
        return buf.decode("utf-8")

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def __iter__(self) -> Iterator[List[str]]:
        for i in range(self.num_rows()):
            yield self.seek(i)

    def close(self) -> None:
        if self._fp is not None:
            self._local.fp.close()
            self._local.fp = None

    def __getstate__(self):
        """Picklable for process-based loaders (data/grain_loader.py
        workers): drop the per-thread handles and the offset memmap (a
        memmap would pickle by value, the handles not at all); both
        rebuild lazily in the worker."""
        state = self.__dict__.copy()
        state["_local"] = None
        state["_offsets"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()


class CompositeTSVFile:
    """A dataset sharded across many TSVs, indexed via a list file plus a
    (shard, row) seq file (reference tsv_io.py:80-171)."""

    def __init__(self, list_file, seq_file, root: str = "."):
        if isinstance(list_file, str):
            with open(list_file) as fp:
                self.file_list = [l.strip() for l in fp if l.strip()]
        else:
            self.file_list = list(list_file)
        self.root = root
        if isinstance(seq_file, str):
            self.seq: List[Tuple[int, int]] = []
            with open(seq_file) as fp:
                for line in fp:
                    a, b = line.split("\t")[:2]
                    self.seq.append((int(a), int(b)))
        else:
            self.seq = [(int(a), int(b)) for a, b in seq_file]
        self._tsvs: List[Optional[TSVFile]] = [None] * len(self.file_list)

    def _shard(self, i: int) -> TSVFile:
        if self._tsvs[i] is None:
            self._tsvs[i] = TSVFile(op.join(self.root, self.file_list[i]))
        return self._tsvs[i]

    def num_rows(self) -> int:
        return len(self.seq)

    __len__ = num_rows

    def seek(self, idx: int) -> List[str]:
        shard, row = self.seq[idx]
        return self._shard(shard).seek(row)

    __getitem__ = seek

    def __iter__(self) -> Iterator[List[str]]:
        for i in range(len(self.seq)):
            yield self.seek(i)


# ---------------------------------------------------------------------------
# writers (atomic tmp-then-rename, emitting .lineidx and .lineidx.8b)
# ---------------------------------------------------------------------------

def tsv_writer(values: Iterable[Sequence], tsv_path: str, sep: str = "\t") -> None:
    """Write rows atomically; emits `.lineidx` and `.lineidx.8b` sidecars
    (reference tsv_io.py:959-997)."""
    ensure_directory(op.dirname(tsv_path))
    idx_path = op.splitext(tsv_path)[0] + ".lineidx"
    idx8b_path = idx_path + ".8b"
    tmp_tsv, tmp_idx, tmp_8b = (p + ".tmp" for p in (tsv_path, idx_path, idx8b_path))
    offsets = []
    pos = 0
    sep_b = sep.encode()
    with open(tmp_tsv, "wb") as fp:
        for row in values:
            assert row is not None
            cells = [v.decode() if isinstance(v, bytes) else str(v) for v in row]
            line = sep.join(cells).encode("utf-8") + b"\n"
            offsets.append(pos)
            fp.write(line)
            pos += len(line)
    with open(tmp_idx, "w") as fp:
        fp.write("\n".join(str(o) for o in offsets))
        if offsets:
            fp.write("\n")
    np.asarray(offsets, dtype="<u8").tofile(tmp_8b)
    # rename last so readers never see a tsv without a consistent index
    os.replace(tmp_idx, idx_path)
    os.replace(tmp_8b, idx8b_path)
    os.replace(tmp_tsv, tsv_path)


def tsv_reader(tsv_path: str) -> Iterator[List[str]]:
    with open(tsv_path, "r") as fp:
        for line in fp:
            yield line.rstrip("\r\n").split("\t")


def concat_tsv_files(tsvs: List[str], out_tsv: str) -> None:
    def gen():
        for t in tsvs:
            yield from tsv_reader(t)
    tsv_writer(gen(), out_tsv)


def delete_tsv_files(tsvs: List[str]) -> None:
    for t in tsvs:
        ensure_remove_file(t)
        base = op.splitext(t)[0]
        ensure_remove_file(base + ".lineidx")
        ensure_remove_file(base + ".lineidx.8b")


def reorder_tsv_keys(in_tsv: str, ordered_keys: List[str], out_tsv: str) -> None:
    """Reorder (and implicitly de-duplicate) rows by first-column key
    (reference tsv_io.py:54-64); used to merge per-host prediction shards."""
    tsv = TSVFile(in_tsv)
    key_to_idx = {}
    for i in range(len(tsv)):
        key_to_idx[tsv.seek_first_column(i)] = i  # last occurrence wins
    def gen():
        for k in ordered_keys:
            yield tsv.seek(key_to_idx[k])
    tsv_writer(gen(), out_tsv)


# ---------------------------------------------------------------------------
# dataset naming conventions: data/<name>/{split}[.<type>][.v<N>].tsv
# ---------------------------------------------------------------------------

class TSVDataset:
    """Versioned-TSV dataset layout (reference tsv_io.py:373-833)."""

    def __init__(self, name: str, data_root: Optional[str] = None):
        self.name = name
        root = data_root or op.join(os.environ.get("VITCAP_DATA_ROOT", "data"))
        self._data_root = op.join(root, name)

    def get_data(self, split: str, t: Optional[str] = None,
                 version=None) -> str:
        """Name resolution incl. string versions ('vinvl' -> .vvinvl.) and
        version=-1 = latest (reference tsv_io.py:529-553)."""
        if t is None:
            version = None                 # image split has no version
        if version is None or version in (0, "0", "None"):
            parts = [split] + ([t] if t is not None else [])
            return op.join(self._data_root, ".".join(parts) + ".tsv")
        if version == -1:
            base = self.get_data(split, t)
            if not op.isfile(base):
                return base
            vs = [int(f.split(".v")[-1].split(".")[0])
                  for f in os.listdir(self._data_root)
                  if f.startswith(f"{split}.{t}.v") and f.endswith(".tsv")
                  and f.split(".v")[-1].split(".")[0].isdigit()]
            return self.get_data(split, t, max(vs)) if vs else base
        return op.join(self._data_root, f"{split}.{t}.v{version}.tsv")

    def has(self, split: str, t: Optional[str] = None,
            version: Optional[int] = None) -> bool:
        return op.isfile(self.get_data(split, t, version))

    def iter_data(self, split: str, t: Optional[str] = None,
                  version: Optional[int] = None) -> Iterator[List[str]]:
        yield from tsv_reader(self.get_data(split, t, version))

    def num_rows(self, split: str, t: Optional[str] = None,
                 version: Optional[int] = None) -> int:
        return TSVFile(self.get_data(split, t, version)).num_rows()


class TSVSplitProperty:
    """Random access to one (data, split, type, version) TSV, resolving
    composite `trainX` list/seq files when present
    (reference tsv_io.py:836-888)."""

    def __init__(self, data: str, split: str, t: Optional[str] = None,
                 version: Optional[int] = None, data_root: Optional[str] = None):
        self.dataset = TSVDataset(data, data_root)
        tsv_path = self.dataset.get_data(split, t, version)
        if op.isfile(tsv_path):
            self.tsv = TSVFile(tsv_path)
        else:
            # composite: {split}.{t}.tsvlist + {split}.{t}.seq
            base = op.splitext(tsv_path)[0]
            list_file, seq_file = base + ".tsvlist", base + ".seq"
            if not (op.isfile(list_file) and op.isfile(seq_file)):
                raise FileNotFoundError(tsv_path)
            self.tsv = CompositeTSVFile(list_file, seq_file,
                                        root=self.dataset._data_root)

    def __len__(self) -> int:
        return len(self.tsv)

    def __getitem__(self, idx: int) -> List[str]:
        return self.tsv[idx]

    def seek_first_column(self, idx: int) -> str:
        if isinstance(self.tsv, TSVFile):
            return self.tsv.seek_first_column(idx)
        return self.tsv[idx][0]


def iter_caption_to_json(iter_caption: Iterable[Sequence[str]],
                         json_file: str) -> None:
    """Convert a caption TSV (key, json-list-of-{caption}) to COCO-format
    json (reference tsv_io.py:934-956)."""
    key_captions = [(row[0], json.loads(row[1])) for row in iter_caption]
    info = {"description": "ground truth captions", "version": "1.0"}
    licenses = [{"id": 1, "name": "unknown", "url": "unknown"}]
    images = [{"id": k, "file_name": k} for k, _ in key_captions]
    annotations = []
    for k, caps in key_captions:
        for i, c in enumerate(caps):
            annotations.append({
                "image_id": k,
                "caption": c["caption"],
                "id": f"{k}_{i}",
            })
    result = {"info": info, "licenses": licenses, "type": "captions",
              "images": images, "annotations": annotations}
    ensure_directory(op.dirname(json_file))
    tmp = json_file + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(result, fp)
    os.replace(tmp, json_file)
    logging.info("wrote %s", json_file)
