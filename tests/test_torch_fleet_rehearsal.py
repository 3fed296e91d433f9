"""``chip_smoke.py``'s fleet phase (``phase_fleet_serve_flagship``)
rehearsed on the CPU, so that a phase that cannot run (a ``NameError``, a
wrong key) fails here and not on the card: a two-layer narrow model for
the flagship part and its first layer for the fault, deploy and affinity
parts (the self-healing job under the remediation engine among the
faults), at ``device="cpu"``, with every gate of the phase applied (the CPU
runs K1's plain version, so its launch gate wants 0 there).  The phase's
own traffic (24 requests of 16-448 prompt tokens, 64 new tokens, 8 slots
a replica) runs unchanged.

The script is imported by its module name from the repository root.
"""

import importlib
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=256, num_layers=2, num_heads=2, head_dim=16,
            embed_dim=32, mlp_dim=64, max_seq_len=512, dtype="float32")


def test_fleet_phase_rehearses_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setenv("TFOS_BLACKBOX_DIR", str(tmp_path / "blackbox"))
    smoke = importlib.import_module("chip_smoke")
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    tree = convert.init_params_tree(transformer.TransformerConfig(**TINY),
                                    seed=0)
    # the fault jobs' re-admission rides wall-clock latencies: a loaded
    # CPU may need more streams than the card
    line = smoke.phase_fleet_serve_flagship(
        tree, smoke.draft_tree(tree, 1), config=TINY,
        cut_config=dict(TINY, num_layers=1), device="cpu", max_streams=12)
    assert line["ok"] and line["launches"] == 0
    assert line["replicas"] == 3 and line["requests"] == 24
    assert line["faults"]["kill_replica"]["fault_kind"] == "kill_replica"
    assert line["rolling_deploy"]["deploy"]["generations"] == [1, 1, 1]
    assert line["rolling_deploy"]["corrupt_deploy"]["halted"]["kind"] == \
        "shape_mismatch"
    assert line["affinity"]["prefix_affinity"]["prefix_hits"] > \
        line["affinity"]["random"]["prefix_hits"]
    # the self-healing job: one executed spawn by fault-response, two live
    # replicas again, the spawned one served the healed stream
    heal = line["faults"]["remediation"]
    assert [d["action"] for d in heal["decisions"] if d["executed"]] == [
        "spawn_replica"]
    assert heal["live"] == 2 and heal["replicas_after"] == 3
    assert heal["healed_admitted"][-1] >= 1 and heal["launches"] == 0
