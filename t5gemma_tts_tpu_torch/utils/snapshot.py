"""Codebase snapshot for run provenance.

An own copy of ``t5gemma_tts_tpu/utils/snapshot.py`` (reference:
copy_codebase.py:67-115): copies the package's source into the
experiment directory when training starts, honoring .gitignore-style
exclusions, so every run records the code that produced it. It also
leaves out ``_build``, where ``ops/cuda_build.py`` puts the compiled
kernels inside the package.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import shutil
from typing import Iterable, Optional, Sequence

log = logging.getLogger(__name__)

DEFAULT_EXCLUDES = (
    "__pycache__", "*.pyc", ".git", ".pytest_cache", "*.so", "exp*",
    "generated_tts", "*.wav", "*.npy", "tb", "_build",
)


def _load_gitignore(root: str) -> Sequence[str]:
    path = os.path.join(root, ".gitignore")
    if not os.path.isfile(path):
        return ()
    with open(path) as f:
        return tuple(
            line.strip().rstrip("/") for line in f
            if line.strip() and not line.startswith("#")
        )


def copy_codebase(src_root: str, exp_dir: str,
                  extra_excludes: Iterable[str] = ()) -> Optional[str]:
    """Snapshot ``src_root`` into ``exp_dir/codebase``; returns the
    destination, or None on failure (a snapshot never stops training)."""
    patterns = tuple(DEFAULT_EXCLUDES) + tuple(extra_excludes) + \
        _load_gitignore(src_root)

    def ignore(directory, names):
        return [n for n in names
                if any(fnmatch.fnmatch(n, p) for p in patterns)]

    dest = os.path.join(exp_dir, "codebase")
    try:
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(src_root, dest, ignore=ignore)
        log.info("codebase snapshot -> %s", dest)
        return dest
    except OSError as exc:
        log.warning("codebase snapshot failed: %s", exc)
        return None
