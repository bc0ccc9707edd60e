"""The run's environment: the program's caches at fixed paths inside the
checkout, the library switches that keep JAX out, and the check that no
module of JAX or of the JAX package was loaded."""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

# top-level module names a run may not load: JAX, its libraries, and the
# JAX package the port was made from (``repro``; the port is
# ``repro_torch``, so names are compared whole, never by prefix)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> dict:
    """Every build and kernel cache of the program at a fixed path in the
    checkout, so that only a cell's first run there builds."""
    build = Path(root) / "build"
    return {
        "REPRO_TORCH_BUILD_DIR": str(build / "repro_torch"),
        "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
        "TRITON_CACHE_DIR": str(build / "triton"),
        # keep libraries that can load JAX on their own from doing so
        "USE_FLAX": "0",
        "USE_JAX": "0",
    }


def prepare(root: Path) -> None:
    os.environ.update(cache_env(root))
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    bench_parent = str(Path(root))
    if bench_parent not in sys.path:
        sys.path.insert(0, bench_parent)


def steady_host() -> None:
    """Keep freed host memory in the process (glibc's heap) instead of
    handing it back to the system and faulting it in again on the next
    large allocation: every run's host work then costs the same, where a
    page fault's price depends on the other machines on the host."""
    import ctypes
    import ctypes.util
    name = ctypes.util.find_library("c")
    if not name:
        return
    libc = ctypes.CDLL(name)
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt(m_mmap_threshold, 32 << 20)   # glibc's largest
    libc.mallopt(m_trim_threshold, 1 << 30)


def forbidden_loaded(names: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name (the part before the
    first dot) is one of ``FORBIDDEN``, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
