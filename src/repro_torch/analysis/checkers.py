"""Import-side-effect module: loading it registers every rule family.

Split out so ``base`` stays import-cycle-free and adding a checker is one
import line here plus its module.
"""
from . import lock_discipline  # noqa: F401
from . import precision  # noqa: F401
from . import snapshot_immutability  # noqa: F401
from . import trace_safety  # noqa: F401
