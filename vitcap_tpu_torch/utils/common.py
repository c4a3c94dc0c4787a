"""Core config/dict/YAML machinery, the port's copy of
vitcap_tpu/utils/common.py (the port imports nothing of the JAX package).

PyYAML is imported where a YAML file or string is read or written, so a
host without it still runs a pipeline given its parameters as a dict.
The JAX package's enable_compilation_cache (an XLA setting) has no
counterpart here.

Behavioral reference: ViTCAP src/tools/common.py (dict_*_path_* :111-131/181-224/
323-400, load_from_yaml_file :227-240, parse_general_args :282-320) and
src/pipelines/uni_pipeline.py Config (:63-84).  Re-designed: same YAML surface
(`_base_` inheritance, `$`-separated paths, -c/-p/-bp CLI) but unknown config
keys raise instead of silently returning None.
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import os
import os.path as op
import time
from typing import Any, Dict, Iterator, Optional


# ---------------------------------------------------------------------------
# $-separated dict path access
# ---------------------------------------------------------------------------

def dict_has_path(d: Dict, path: str) -> bool:
    cur = d
    for part in path.split("$"):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return False
    return True


def dict_get_path_value(d: Dict, path: str, with_default: bool = False,
                        default: Any = None) -> Any:
    cur = d
    for part in path.split("$"):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif with_default:
            return default
        else:
            raise KeyError(f"path {path!r} not found (missing {part!r})")
    return cur


def dict_set_path_value(d: Dict, path: str, value: Any) -> None:
    parts = path.split("$")
    cur = d
    for part in parts[:-1]:
        if part not in cur or not isinstance(cur[part], dict):
            cur[part] = {}
        cur = cur[part]
    cur[parts[-1]] = value


def dict_remove_path(d: Dict, path: str) -> None:
    """Remove the '$'-path's leaf, then every parent it left empty (a
    missing path is a no-op)."""
    parts = path.split("$")
    cur = d
    stack = []
    for part in parts[:-1]:
        if not isinstance(cur, dict) or part not in cur:
            return
        stack.append((cur, part))
        cur = cur[part]
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)
    while stack:
        parent, key = stack.pop()
        if isinstance(parent[key], dict) and not parent[key]:
            del parent[key]
        else:
            break


def iter_dict_paths(d: Dict, prefix: str = "") -> Iterator[str]:
    """The '$'-paths of every leaf (an empty dict is a leaf)."""
    for k, v in d.items():
        path = f"{prefix}${k}" if prefix else str(k)
        if isinstance(v, dict) and v:
            yield from iter_dict_paths(v, path)
        else:
            yield path


def dict_update_nested(base: Dict, overwrite: Dict) -> Dict:
    """Recursively merge ``overwrite`` into ``base`` (in place), returning base."""
    for k, v in overwrite.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            dict_update_nested(base[k], v)
        else:
            base[k] = v
    return base


# ---------------------------------------------------------------------------
# YAML loading with `_base_` inheritance
# ---------------------------------------------------------------------------

def load_from_yaml_str(s: str) -> Any:
    import yaml
    return yaml.safe_load(s)


def load_from_yaml_file(fname: str) -> Dict:
    """Load YAML; a `_base_` key (str or list of str, relative to the file)
    is recursively loaded and nested-merged underneath."""
    import yaml
    with open(fname, "r") as fp:
        data = yaml.safe_load(fp)
    if data is None:
        data = {}
    bases = data.pop("_base_", None)
    if bases is None:
        return data
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict = {}
    for b in bases:
        bpath = b if op.isabs(b) else op.join(op.dirname(fname), b)
        dict_update_nested(merged, load_from_yaml_file(bpath))
    dict_update_nested(merged, data)
    return merged


def write_to_yaml_file(data: Any, fname: str) -> None:
    import yaml
    ensure_directory(op.dirname(fname))
    with open(fname, "w") as fp:
        yaml.safe_dump(data, fp, default_flow_style=False)


def ensure_directory(path: str) -> str:
    if path and not op.isdir(path):
        os.makedirs(path, exist_ok=True)
    return path


def ensure_remove_file(path: str) -> None:
    if op.isfile(path) or op.islink(path):
        try:
            os.remove(path)
        except OSError:
            pass


def ensure_remove_dir(d: str) -> None:
    """rm -rf semantics, missing-ok (reference `ensure_remove_dir`)."""
    import shutil
    if op.isdir(d):
        shutil.rmtree(d, ignore_errors=True)


def write_to_file(contents: str, fname: str, append: bool = False) -> None:
    ensure_directory(op.dirname(fname))
    with open(fname, "a" if append else "w") as fp:
        fp.write(contents)


def read_to_buffer(fname: str) -> bytes:
    with open(fname, "rb") as fp:
        return fp.read()


def hash_sha1(s: Any) -> str:
    """sha1 hex digest of a string, or of anything else as sorted JSON."""
    import hashlib
    if not isinstance(s, str):
        s = json.dumps(s, sort_keys=True, default=str)
    return hashlib.sha1(s.encode()).hexdigest()


class acquire_lock:
    """Exclusive fcntl lock on a lockfile, as a context manager (reference
    `acquireLock`/`releaseLock`, common.py:515-527); guards multi-process
    critical sections on a shared filesystem.  The default lockfile lies
    in the temporary directory (tempfile.gettempdir())."""

    def __init__(self, lock_path: Optional[str] = None):
        if lock_path is None:
            import tempfile
            lock_path = op.join(tempfile.gettempdir(),
                                "vitcap_lockfile.LOCK")
        self.lock_path = lock_path
        self._fp = None

    def __enter__(self):
        import fcntl
        self._fp = open(self.lock_path, "a")
        fcntl.flock(self._fp.fileno(), fcntl.LOCK_EX)
        return self._fp

    def __exit__(self, *exc):
        import fcntl
        fcntl.flock(self._fp.fileno(), fcntl.LOCK_UN)
        self._fp.close()
        return False


def exclusive_open_to_read(fname: str, mode: str = "r"):
    """Open with an fcntl shared lock on a sidecar lockfile (reference
    common.py:591-607); protects shared-FS reads.  On a read-only
    filesystem (no lockfile can be made) it opens plainly."""
    import fcntl

    def _open():
        lock_fp = open(fname + ".lock", "a")
        fcntl.flock(lock_fp.fileno(), fcntl.LOCK_SH)
        try:
            return open(fname, mode)
        finally:
            fcntl.flock(lock_fp.fileno(), fcntl.LOCK_UN)
            lock_fp.close()

    try:
        return _open()
    except PermissionError:
        return open(fname, mode)


def limited_retry_agent(n_retry: int, func, *args, sleep_s: float = 1.0,
                        **kwargs):
    """Retry ``func`` up to n_retry times, the last failure raised
    (reference common.py:568-580)."""
    for i in range(n_retry):
        try:
            return func(*args, **kwargs)
        except Exception:
            if i == n_retry - 1:
                raise
            logging.exception("retry %d/%d for %s", i + 1, n_retry, func)
            time.sleep(sleep_s)


def try_once(func):
    """Best-effort wrapper: log and swallow exceptions, returning None
    (reference trainer.py:10-12, used for snapshot saving)."""
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception:
            logging.exception("ignored failure in %s",
                              getattr(func, "__name__", func))
    return wrapper


# ---------------------------------------------------------------------------
# packaged data assets (tokenizer vocab, BertConfig jsons, vinvl labels)
# ---------------------------------------------------------------------------

def asset_path(*parts: str) -> str:
    """Path into the port's own ``vitcap_tpu_torch/assets/`` data directory
    (the framework-shipped equivalents of the reference's yaml/ data files:
    VILT-* vocab.txt/config.json, vinvl_label.json, the pruned-variant
    manifests)."""
    return op.join(op.dirname(op.dirname(op.abspath(__file__))), "assets",
                   *parts)


def resolve_asset(path: str) -> str:
    """Return ``path`` if it exists; otherwise remap to the packaged asset
    with the same basename.  Lets reference YAMLs that say
    ``./yaml/VILT-L12-H784-uncased_16_384`` or ``./yaml/vinvl_label.json``
    run unmodified from any working directory."""
    if not path or op.exists(path):
        return path
    cand = asset_path(op.basename(path.rstrip("/")))
    return cand if op.exists(cand) else path


# ---------------------------------------------------------------------------
# artifact caching semantics (worth_create, reference common.py:419-428)
# ---------------------------------------------------------------------------

def worth_create(base: str, derived: str, buf_sec: float = 0.0) -> bool:
    """True if ``derived`` should be (re)created from ``base``:
    derived missing, or older than base (with slack buf_sec)."""
    if not op.isfile(derived) and not op.islink(derived) and not op.isdir(derived):
        return True
    if not op.isfile(base) and not op.isdir(base):
        return False
    return os.path.getmtime(derived) + buf_sec < os.path.getmtime(base)


# ---------------------------------------------------------------------------
# Config: defaults + overwrite with $-path attribute access
# ---------------------------------------------------------------------------

class Config:
    """Two-layer config: ``overwrite`` (from YAML/CLI) wins over ``default``.

    Unlike the reference (uni_pipeline.py:63-84), attribute access for a key
    that exists in neither layer raises AttributeError; use .get() for the
    permissive behavior.  `$`-separated paths address nested keys.
    """

    def __init__(self, default: Optional[Dict] = None,
                 overwrite: Optional[Dict] = None):
        object.__setattr__(self, "_default", default or {})
        object.__setattr__(self, "_overwrite", overwrite or {})

    def get(self, key: str, default: Any = None) -> Any:
        if dict_has_path(self._overwrite, key):
            return dict_get_path_value(self._overwrite, key)
        if dict_has_path(self._default, key):
            return dict_get_path_value(self._default, key)
        return default

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        if dict_has_path(self._overwrite, key):
            return dict_get_path_value(self._overwrite, key)
        if dict_has_path(self._default, key):
            return dict_get_path_value(self._default, key)
        raise AttributeError(
            f"unknown config key {key!r}; declare a default for it")

    def __setattr__(self, key: str, value: Any) -> None:
        dict_set_path_value(self._overwrite, key, value)

    def set(self, key: str, value: Any) -> None:
        dict_set_path_value(self._overwrite, key, value)

    def update_default(self, d: Dict) -> None:
        dict_update_nested(self._default, d)

    def has(self, key: str) -> bool:
        return (dict_has_path(self._overwrite, key)
                or dict_has_path(self._default, key))

    def as_dict(self) -> Dict:
        merged = copy.deepcopy(self._default)
        dict_update_nested(merged, copy.deepcopy(self._overwrite))
        return merged

    def __repr__(self) -> str:
        return f"Config({json.dumps(self.as_dict(), indent=2, default=str)})"


# ---------------------------------------------------------------------------
# CLI arg handling (reference parse_general_args common.py:282-320)
# ---------------------------------------------------------------------------

def parse_general_args(argv: Optional[list] = None) -> Dict:
    import argparse
    parser = argparse.ArgumentParser(description="vitcap_tpu_torch experiment runner")
    parser.add_argument("-c", "--config_file", type=str, default=None,
                        help="YAML config file")
    parser.add_argument("-p", "--param", type=str, default=None,
                        help="YAML string merged over the config file")
    parser.add_argument("-bp", "--base64_param", type=str, default=None,
                        help="base64-encoded YAML string merged last")
    args = parser.parse_args(argv)
    kwargs: Dict = {}
    if args.config_file:
        dict_update_nested(kwargs, load_from_yaml_file(args.config_file))
    if args.param:
        dict_update_nested(kwargs, load_from_yaml_str(args.param))
    if args.base64_param:
        dict_update_nested(
            kwargs, load_from_yaml_str(
                base64.b64decode(args.base64_param).decode()))
    return kwargs


def execute_func(info: Dict, **kwargs: Any) -> Any:
    """Import `info['from']` and call/instantiate `info['import']` with
    info['param'] (reference tools/common.py:133-139)."""
    import importlib
    mod = importlib.import_module(info["from"])
    fn = getattr(mod, info["import"])
    param = dict(info.get("param", {}))
    param.update(kwargs)
    return fn(**param)


def save_parameters(param: Dict, out_folder: str) -> str:
    ts = time.strftime("%Y_%m_%d_%H_%M_%S")
    fname = op.join(out_folder, f"parameters_{ts}.yaml")
    to_save = {k: (v if _yaml_friendly(v) else str(v)) for k, v in param.items()}
    write_to_yaml_file(to_save, fname)
    write_to_yaml_file(dict(os.environ), op.join(out_folder, f"env_{ts}.yaml"))
    return fname


def load_latest_parameters(folder: str) -> Dict:
    import glob
    files = sorted(glob.glob(op.join(folder, "parameters_*.yaml")))
    if not files:
        return {}
    return load_from_yaml_file(files[-1])


def _yaml_friendly(v: Any) -> bool:
    import yaml
    try:
        yaml.safe_dump(v)
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

_LOGGING_INITED = False


def init_logging(rank: int = 0, output_dir: Optional[str] = None) -> None:
    """stdout (rank-0 only) + optional per-rank file handler
    (reference common.py:157-169, uni_pipeline.py:380-401)."""
    global _LOGGING_INITED
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d %(filename)s:%(lineno)s %(funcName)10s(): "
        "%(message)s", datefmt="%m-%d %H:%M:%S")
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    if not _LOGGING_INITED:
        import sys
        if rank == 0:
            h = logging.StreamHandler(sys.stdout)
            h.setFormatter(fmt)
            root.addHandler(h)
        _LOGGING_INITED = True
    if output_dir:
        ensure_directory(output_dir)
        ts = time.strftime("%Y_%m_%d_%H_%M_%S")
        fh = logging.FileHandler(
            op.join(output_dir, f"log_{ts}_rank{rank}.txt"))
        fh.setFormatter(fmt)
        root.addHandler(fh)


def get_mpi_rank() -> int:
    return int(os.environ.get("RANK", os.environ.get("OMPI_COMM_WORLD_RANK", "0")))


def get_mpi_size() -> int:
    return int(os.environ.get("WORLD_SIZE",
                              os.environ.get("OMPI_COMM_WORLD_SIZE", "1")))


def get_mpi_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK",
                              os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")))


