"""Host-memory tuning for hosts where page faults are dear.

Where first-touch of a fresh 4K page is slow (sandboxed kernels), numpy
pipelines that allocate large temporaries re-fault their working set at
every stage: glibc returns mmap'd allocations (>= 128K by default) to the
OS on free. Raising M_MMAP_THRESHOLD makes malloc serve big blocks from
the retained heap instead: pages fault once per high-water mark and stay
warm for the life of the process (the JAX package's copy of this module
measured repeat calls of data/blocks.py::whole_scene_grid_blocks on a
1M-point scene at 7.0 s -> 0.55 s on its CPU host). The cost is that freed
memory is not returned to the OS until exit (peak-RSS high-water
retention): call only from long-running drivers that own the machine
(inference or training), never at import time.
"""

from __future__ import annotations

import ctypes
import sys

_done = False


def retain_freed_pages() -> bool:
    """Tune glibc malloc to retain freed big blocks (see module docstring).

    Idempotent; returns True if the tuning was applied. No-op (False) off
    glibc/Linux.
    """
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        # M_MMAP_THRESHOLD = -3, M_TRIM_THRESHOLD = -1 (glibc malloc.h)
        ok = libc.mallopt(-3, 1 << 30) == 1 and libc.mallopt(-1, 2**31 - 1) == 1
    except OSError:
        return False
    _done = bool(ok)
    return _done
