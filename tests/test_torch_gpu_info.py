"""The port's GPU discovery and allocation (``cluster/gpu_info.py`` and
``node.allocate_gpus``) on canned ``nvidia-smi`` output: the five cases
of ``tests/test_tpu_info.py`` for the JAX package's chip allocation,
plus the node's host-local-rank allocation, the choice among the cards
an inherited ``CUDA_VISIBLE_DEVICES`` lists, and the refusal to run
without ``nvidia-smi``."""

import os

import pytest

from tensorflowonspark_tpu_torch.cluster import gpu_info, node

#: ``nvidia-smi --query-gpu=index,uuid,memory.used,memory.total
#: --format=csv,noheader,nounits`` on a host with four idle 80 GB cards
FOUR_IDLE = "".join("{0}, GPU-{1}{1}-0{0}, 1, 81559\n".format(i, c)
                    for i, c in enumerate("abcd"))


@pytest.fixture()
def smi(monkeypatch):
    """Answer ``nvidia-smi`` with the text that ``set`` is given."""
    out = {"text": FOUR_IDLE}
    monkeypatch.setattr(gpu_info, "_nvidia_smi_output", lambda: out["text"])
    return out


@pytest.fixture()
def env(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
    monkeypatch.setattr(gpu_info, "_inherited", {})
    return os.environ


def test_get_device_info_parses_nvidia_smi(smi):
    info = gpu_info.get_device_info()
    assert info["platform"] == "gpu"
    assert info["num_devices"] == 4
    assert info["devices"][2] == {"index": 2, "uuid": "GPU-cc-02",
                                  "memory_used_mib": 1,
                                  "memory_total_mib": 81559}


def test_gpu_allocation_deterministic(smi, env):
    assert gpu_info.get_gpus(1, worker_index=0) == [0]
    assert gpu_info.get_gpus(1, worker_index=1) == [1]
    assert gpu_info.get_gpus(2, worker_index=1) == [2, 3]
    assert gpu_info.get_gpus(4, worker_index=0) == [0, 1, 2, 3]


def test_gpu_allocation_overflow(smi, env):
    with pytest.raises(RuntimeError):
        gpu_info.get_gpus(8, worker_index=0)


def test_gpu_allocation_wrap_collision_raises(smi, env):
    # a wrapped window would collide with worker 0's cards: loud failure
    with pytest.raises(RuntimeError):
        gpu_info.get_gpus(3, worker_index=1)


def test_set_visible_gpus(env):
    gpu_info.set_visible_gpus([0, 2])
    assert env["CUDA_VISIBLE_DEVICES"] == "0,2"
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"


def test_busy_gpu_is_skipped(smi, env):
    # card 1 is 3/4 full (another process holds it): not handed out
    smi["text"] = ("0, GPU-a, 10, 81559\n1, GPU-b, 61000, 81559\n"
                   "2, GPU-c, 10, 81559\n")
    assert gpu_info.get_gpus(1, worker_index=1) == [2]
    with pytest.raises(RuntimeError, match="2 free of 3"):
        gpu_info.get_gpus(1, worker_index=2)


def test_inherited_indices_restrict_the_choice(smi, env):
    # the process was given cards 3 and 1, in that order: it allocates
    # only among them, and names them as it was given them
    env["CUDA_VISIBLE_DEVICES"] = "3,1"
    assert gpu_info.get_gpus(1, worker_index=0) == [3]
    assert gpu_info.get_gpus(1, worker_index=1) == [1]
    with pytest.raises(RuntimeError, match="2 free of 2"):
        gpu_info.get_gpus(1, worker_index=2)
    # a second allocation in the same process chooses among the cards
    # it was given, not among the ones the first one set visible
    gpu_info.set_visible_gpus([3])
    assert gpu_info.get_gpus(2, worker_index=0) == [3, 1]


def test_inherited_uuids_restrict_the_choice(smi, env):
    # card c (index 2) is 3/4 full: skipped, though it was given
    smi["text"] = smi["text"].replace("GPU-cc-02, 1,", "GPU-cc-02, 61000,")
    env["CUDA_VISIBLE_DEVICES"] = "GPU-cc,GPU-dd"
    assert node.allocate_gpus(1, _nodes("a"), "a", 0) == ["GPU-dd"]
    assert env["CUDA_VISIBLE_DEVICES"] == "GPU-dd"
    assert [g["index"] for g in gpu_info.allocatable_gpus()] == [2, 3]


@pytest.mark.parametrize("given", ["MIG-1234", "7", "GPU-"])
def test_inherited_entry_that_names_no_single_card_raises(smi, env, given):
    env["CUDA_VISIBLE_DEVICES"] = given
    with pytest.raises(gpu_info.GPUDiscoveryError, match="entry"):
        gpu_info.get_gpus(1, worker_index=0)


def test_inherited_empty_value_gives_no_card(smi, env):
    env["CUDA_VISIBLE_DEVICES"] = ""
    with pytest.raises(RuntimeError, match="0 free of 0"):
        gpu_info.get_gpus(1, worker_index=0)


def _nodes(*hosts):
    return [{"executor_id": i, "host": h} for i, h in enumerate(hosts)]


def test_node_allocates_by_host_local_rank(smi, env):
    # executors 0 and 2 share host "a"; 2 is second there, so it takes
    # the second window even though its global id is 2
    info = _nodes("a", "b", "a")
    assert node.allocate_gpus(2, info, "a", 2) == [2, 3]
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert node.allocate_gpus(2, info, "b", 1) == [0, 1]
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1"


def test_missing_nvidia_smi_raises_only_when_gpus_are_asked_for(
        monkeypatch, env):
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(gpu_info.GPUDiscoveryError, match="nvidia-smi"):
        node.allocate_gpus(1, _nodes("a"), "a", 0)
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert node.allocate_gpus(None, _nodes("a"), "a", 0) is None
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert node._safe_device_info() == {"platform": "unknown",
                                        "num_devices": 0}
