"""gpubench/tests/test_gpubench_yardstick.py under tier-1 (tests/gpubench_tier1.py)."""

from gpubench.tests.test_gpubench_yardstick import *  # noqa: F401,F403
