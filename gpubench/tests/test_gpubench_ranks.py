"""The launch of one rank per card, on the CPU: a tiny cell as a cell of
two chips, two processes on gloo meeting at a free localhost port, each
running the fused exchange on its own servers of the group."""
import pytest

from gpubench_tiny import spec, tiny_tree
from harness import ranks


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_on_gloo(tmp_path, trace):
    root = tiny_tree(tmp_path, chips=2)
    cell = spec(root, "er-1m.pagerank")
    assert cell.chips == 2
    res = ranks.run(cell, 2**31 + 3, 0.5, trace, 0.0, backend="gloo",
                    device_type="cpu")
    assert res["correct"] is True
    assert res["device"]["count"] == 2
    assert res["attempted"] > 0
    assert ("iter_ms" in res["metrics"]) != trace
