"""Executor-local environment helpers (copy of the JAX package's
``utils/env.py``, cut to the executor-id files).

The executor-id file handshake lets separate jobs landing on the same
executor (the cluster-start job vs later feed jobs) discover which
logical node lives there (original: tensorflowonspark/util.py:77-85).
"""

import os

_EXECUTOR_ID_FILE = "executor_id"


def write_executor_id(num, working_dir=None):
    """Persist this executor's logical id (original: util.py:77-80)."""
    path = os.path.join(working_dir or os.getcwd(), _EXECUTOR_ID_FILE)
    with open(path, "w") as f:
        f.write(str(num))


def read_executor_id(working_dir=None):
    """Read back the executor id written by the start job
    (original: util.py:82-85)."""
    path = os.path.join(working_dir or os.getcwd(), _EXECUTOR_ID_FILE)
    with open(path, "r") as f:
        return int(f.read())
