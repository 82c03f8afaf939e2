"""gpubench/tests/test_gpubench_graph_replays.py under tier-1, each test run by a
fresh interpreter (tests/gpubench_tier1.py)."""

from gpubench.tests import test_gpubench_graph_replays
from tests.gpubench_tier1 import in_fresh_interpreter

in_fresh_interpreter(test_gpubench_graph_replays, globals())
