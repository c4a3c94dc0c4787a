"""The native `.lineidx.8b` scanner (vitcap_tpu_torch/native/tsvtools.cpp),
the port's copy of vitcap_tpu/data/native_tsv.py.

Python's per-line offset scan (tsv.generate_lineidx, the reference's
tsv_io.py:294-308) takes minutes on multi-GB TSVs; the C++ scanner reads
8 MB blocks with memchr and writes the little-endian u64 sidecar through
a per-process temporary file and a rename.  TSVFile builds a missing index
with it; generate_lineidx stays as its plain version.
"""

from __future__ import annotations

import os

from ..native import library


def build_lineidx_8b(tsv_path: str, out_path: str) -> int:
    """Write the `.lineidx.8b` sidecar of `tsv_path` to `out_path`; returns
    the number of lines.  Raises if the library cannot be built or the
    files cannot be read or written."""
    n = library("tsvtools").build_lineidx_8b(os.fsencode(tsv_path),
                                             os.fsencode(out_path))
    if n < 0:
        raise OSError(f"could not index {tsv_path} into {out_path}")
    return int(n)
