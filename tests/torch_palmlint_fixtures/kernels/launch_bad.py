"""Bad fixture (under kernels/): host hazards reachable from launch wrappers."""
import numpy as np

LAUNCHES = {"screen": 0}


class Engine:
    def __init__(self, lock):
        self._lock = lock


def _launch_screen(engine, q):
    with engine._lock:  # BAD: a lock inside a launch wrapper
        pass
    return q


def screen(q, lib):
    noise = np.random.default_rng(0)  # BAD: host RNG in a counted launch
    lib.coconut_screen(q)
    LAUNCHES["screen"] += 1
    return staged(q), noise


def staged(q):
    jitter = np.random.rand()  # BAD: reachable from the launch via the call graph
    return q + jitter
