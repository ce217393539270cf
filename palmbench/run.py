"""One cell of the port's benchmark: ``python3 palmbench/run.py --workload
NAME --seed N --seconds S --trace 0|1`` from the root of a checkout, on a
machine with the card(s) the cell asks for. The last line of standard
output is the result as JSON; the numbers compared for ``correct`` are the
last lines of standard error."""
import time

T_START = time.perf_counter()

import ctypes  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def keep_freed_memory() -> None:
    """Let glibc keep what the process frees for its next allocations.

    By default it hands every block above a moving threshold back to the
    kernel when freed (munmap, heap trim), so each request of the window
    faults its pages in afresh; on the card's machine, whose sandboxed
    kernel takes those faults, that cost drifted from run to run. Blocks
    of up to 2 GiB now come from the heap and stay there."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    for option in (m_mmap_threshold, m_trim_threshold):
        libc.mallopt(option, 2**31 - 1)


keep_freed_memory()

from palmbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
