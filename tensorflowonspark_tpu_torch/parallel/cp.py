"""Sequence (context) parallelism: long-context attention over the mesh
(port of the JAX package's ``parallel/cp.py``).

Two interchangeable strategies over the ``seq`` axis of a
:class:`..parallel.mesh.Mesh`:

- **ring attention** (:func:`ring_attention_sharded`): kv chunks rotate
  around the ring by point-to-point hops while each rank keeps its
  queries; memory stays O(seq/ranks);
- **Ulysses** (:func:`ulysses_attention_sharded`): all-to-alls re-shard
  from sequence-split to head-split and back, one pair per attention.
"""

from tensorflowonspark_tpu_torch.ops.ring_attention import (  # noqa: F401
    ring_attention,
    ring_attention_sharded,
)
from tensorflowonspark_tpu_torch.ops.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_attention_sharded,
)

STRATEGIES = {
    "ring": ring_attention_sharded,
    "ulysses": ulysses_attention_sharded,
}


def context_parallel_attention(q, k, v, mesh, strategy="ring", **kwargs):
    """Dispatch sequence-parallel attention by strategy name on this
    rank's shards.  ``strategy="auto"`` picks via :func:`choose_strategy`
    (``seq_len`` is the global length: the shard's times the axis)."""
    seq_devices = mesh.shape.get(kwargs.get("axis_name", "seq"), 1)
    if strategy == "auto":
        strategy = choose_strategy(
            seq_len=q.shape[1] * seq_devices,
            num_heads=q.shape[2],
            head_dim=q.shape[3],
            seq_devices=seq_devices,
        )
    if strategy not in STRATEGIES:
        raise ValueError(
            "unknown context-parallel strategy {0!r}; options: {1}".format(
                strategy, sorted(STRATEGIES)
            )
        )
    return STRATEGIES[strategy](q, k, v, mesh, **kwargs)


def choose_strategy(seq_len, num_heads, head_dim, seq_devices):
    """Pick ring vs Ulysses for a ``seq``-sharded attention (the
    reference's policy, see its docstring): Ulysses when the head count
    divides by the seq width and the per-rank sequence is under 4096
    tokens (ring's compute per hop could not hide its transfers); ring
    otherwise."""
    if seq_devices <= 1:
        return "ring"  # degenerates to plain attention either way
    ulysses_ok = num_heads % seq_devices == 0
    local_seq = seq_len // max(1, seq_devices)
    if ulysses_ok and local_seq < 4096:
        return "ulysses"
    return "ring"


def plan(seq_len, batch, num_heads, head_dim, seq_devices, dtype_bytes=2):
    """Per-rank memory and communication plan for context-parallel
    attention: local sequence, Q/K/V bytes, the score working set a
    naive (unsharded) computation would need, and each strategy's
    communication volume per call."""
    local_seq = -(-seq_len // seq_devices)
    qkv_bytes = 3 * batch * local_seq * num_heads * head_dim * dtype_bytes
    n = max(1, seq_devices)
    ring_hop = 2 * batch * local_seq * num_heads * head_dim * dtype_bytes
    return {
        "local_seq": local_seq,
        "qkv_bytes_per_device": qkv_bytes,
        "naive_scores_bytes": batch * num_heads * seq_len * seq_len * 4,
        "ring_bytes_per_call": ring_hop * (n - 1),
        "ring_hops": n - 1,
        "ulysses_bytes_per_call": (
            4 * batch * local_seq * num_heads * head_dim * dtype_bytes
            * (n - 1) // n
        ),
        "ulysses_valid": num_heads % n == 0,
        "recommended": choose_strategy(
            seq_len, num_heads, head_dim, seq_devices
        ),
    }
