"""Host C++ libraries of the data path, built with g++ at first use.

A library is built from one source in `csrc/` into a directory under the
git-ignored `build/` beside the package, named by a hash of the source
and the flags, so an edited source rebuilds; nothing is built at import
time.  The build writes into a temporary directory and renames, so
processes building at once never load a half-written library.  A failed
build raises: the callers have no other implementation to fall back to.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"


def library_path(source: Path, build_dir: Path, flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return build_dir / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path, flags) -> Path:
    """Compile `source` into a shared library (once per source and flags);
    raises when g++ fails."""
    out = library_path(source, build_dir, flags)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        so_tmp = Path(tmp) / out.name
        run = subprocess.run(["g++", *flags, str(source), "-o", str(so_tmp)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source.name}\n"
                               + run.stdout)
        os.replace(so_tmp, out)
    return out
