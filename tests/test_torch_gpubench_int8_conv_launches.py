"""gpubench/tests/test_gpubench_int8_conv_launches.py under tier-1 (tests/gpubench_tier1.py)."""

from gpubench.tests.test_gpubench_int8_conv_launches import *  # noqa: F401,F403
