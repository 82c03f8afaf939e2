"""gpubench/tests/test_gpubench_static.py under tier-1 (tests/gpubench_tier1.py)."""

from gpubench.tests.test_gpubench_static import *  # noqa: F401,F403
