"""gpubench/tests/test_gpubench_models.py under tier-1 (tests/gpubench_tier1.py)."""

from gpubench.tests.test_gpubench_models import *  # noqa: F401,F403
