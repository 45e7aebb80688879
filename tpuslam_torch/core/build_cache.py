"""The build cache shared by the port's compiled libraries: the CUDA
kernels (``kernels/build.py``) and the native cloud reader and writer
(``native/bindings.py``).

A library is compiled into a temporary directory beside its target and
renamed into place, so a concurrent process never loads a half-written
file, and a hash of the compiler flags and the sources is kept beside it
(``<library>.sha256``): while that hash matches, the library on disk is
used as it is.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Callable, Iterable


def digest(flags: Iterable[str], root: Path, files: Iterable[Path]) -> str:
    """Hash of the flags and of each file's name (relative to ``root``)
    and bytes, in the order given."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(str(f.relative_to(root)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def current(lib_path: Path, digest_: str) -> bool:
    """Whether ``lib_path`` exists and was built from ``digest_``."""
    stamp = lib_path.with_name(lib_path.name + ".sha256")
    return lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest_


def build_into(lib_path: Path, digest_: str, compile_: Callable[[Path, Path], None]) -> Path:
    """Run ``compile_(tmp_dir, tmp_lib)``, which writes the library to
    ``tmp_lib``, then move it to ``lib_path`` and stamp it with
    ``digest_``.  An exception from ``compile_`` leaves the old library
    and stamp as they were."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp_dir:
        tmp_lib = Path(tmp_dir) / lib_path.name
        compile_(Path(tmp_dir), tmp_lib)
        os.replace(tmp_lib, lib_path)
    lib_path.with_name(lib_path.name + ".sha256").write_text(digest_ + "\n")
    return lib_path
