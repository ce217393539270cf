"""Good fixture (under kernels/): launch wrappers take their inputs as given."""
import threading

LAUNCHES = {"screen": 0}
_LOCK = threading.Lock()  # the library build's module lock, not an instance lock


def _library():
    with _LOCK:
        return object()


def _launch_screen(q, gen):
    lib = _library()
    return lib, q, gen


def screen(q, lib):
    lib.coconut_screen(q)
    LAUNCHES["screen"] += 1
    return q
