"""Builds of the native sources that the port loads with ``ctypes``.

Each library is compiled at first use into ``build/`` at the repository
root (git-ignored), named after its source and a hash of the source and
the compile command, so an edit to either builds anew and a stale
``build/`` is harmless.  A missing compiler or a failed compile raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_BUILD_LOCK = threading.Lock()


def find_tool(name: str, fallback: str | None = None, why: str = "") -> str:
    """The path of the executable ``name`` (or ``fallback``), else raise."""
    path = shutil.which(name) or fallback
    if not path or not os.path.exists(path):
        raise RuntimeError(f"{name} not found{': ' + why if why else ''}")
    return path


def build_library(src: Path, compiler: str, flags: Sequence[str], libs: Sequence[str] = (),
                  verbose: bool = False) -> Path:
    """Compile ``src`` with ``compiler flags -o OUT src libs`` into
    ``build/lib<stem>_<hash>.so`` unless it is already there.  Returns its
    path."""
    command = [*flags, *libs]
    digest = hashlib.sha256(src.read_bytes() + " ".join(command).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    with _BUILD_LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([compiler, *flags, "-o", str(tmp), str(src), *libs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{os.path.basename(compiler)} failed on {src.name} "
                               f"({res.returncode}):\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, out)
    return out
