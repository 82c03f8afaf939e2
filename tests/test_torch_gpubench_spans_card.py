"""gpubench/tests/test_gpubench_spans_card.py under tier-1 (tests/gpubench_tier1.py)."""

from gpubench.tests.test_gpubench_spans_card import *  # noqa: F401,F403
