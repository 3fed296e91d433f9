"""``chip_smoke.py``'s two async-PS phases rehearsed on the CPU, so a
phase that cannot run (a ``NameError``, a wrong key) fails here and not
on the card: ``phase_ps_lm_flagship`` with a one-layer narrow LM and two
timed steps, ``phase_ps_mnist_flagship`` with 4 MNIST steps, both at
``device="cpu"``, every gate of both phases applied (the CPU runs the
flash kernels' plain versions, so the launch gate wants 0 there).

The script is imported by its module name from the repository root (the
MNIST phase's cluster fn travels to the executors by reference).
"""

import importlib
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=256, num_layers=1, num_heads=2, head_dim=16,
            embed_dim=32, mlp_dim=64, max_seq_len=64, dtype="float32")


def _smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    return importlib.import_module("chip_smoke")


def test_ps_lm_phase_rehearses_on_the_cpu(monkeypatch):
    line = _smoke(monkeypatch).phase_ps_lm_flagship(config=TINY,
                                                    device="cpu", timed=2)
    assert set(line["variants"]) == {"async_pipelined", "async_unpipelined",
                                     "async_compressed"}
    assert line["overlap_readback"]["equal"]
    assert line["push_ratio"] <= 0.27


def test_ps_mnist_phase_rehearses_on_the_cpu(monkeypatch):
    line = _smoke(monkeypatch).phase_ps_mnist_flagship(device="cpu", steps=4)
    assert line["roles"] == ["evaluator", "ps", "worker", "worker"]
    assert line["eval_scores"] >= 2 and line["tensorboard_gone"]
