"""``chip_smoke.py``'s elastic hold phase (``phase_elastic_hold_flagship``)
rehearsed on the CPU, so that a phase that cannot run (a ``NameError``, a
wrong key) fails here and not on the card: a two-layer narrow model at
``device="cpu"``, with every gate of the phase applied (the CPU runs
K2-K4's plain version, so its launch gates want 0 there).  The phase's
own traffic (4 partitions of 32 rows, two epochs, the hold after 2 steps
of executor 1 and the release after 4 of the survivor) runs unchanged.

The fleet phase's self-healing job (``fleet_remediation``, part 2 of
phase 36) is rehearsed with the rest of that phase in
``tests/test_torch_fleet_rehearsal.py``.

The script is imported by its module name from the repository root.
"""

import importlib
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=256, num_layers=2, num_heads=2, head_dim=16,
            embed_dim=32, mlp_dim=64, max_seq_len=64, dtype="float32")


def test_elastic_hold_phase_rehearses_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setenv("TFOS_BLACKBOX_DIR", str(tmp_path / "blackbox"))
    smoke = importlib.import_module("chip_smoke")
    line = smoke.phase_elastic_hold_flagship(config=TINY, device="cpu")
    assert line["held"] is True and line["released"] is True
    assert {"executor_held", "executor_released"} <= set(line["journal"])
    assert 1 not in line["marked_dead"]
    assert line["restarts"] == [0, 0] and line["restart_events"] >= 2
    assert all(g >= 2 for g in line["generations"].values())
    assert line["uncommitted"] == []
    assert line["hold_launches"] == {
        n: {"survivor": 0, "released": 0} for n in ("fwd", "dq", "dkv")}
    assert line["hold_to_reduced_sec"] > 0
    assert line["release_to_regrown_sec"] > 0
