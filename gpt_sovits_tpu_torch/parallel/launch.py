"""Process-group launch and data distribution for data-parallel training
(port of gpt_sovits_tpu/parallel/launch.py).

One process a card: each calls `init` with the same address and process
count and its own id, then runs a trainer with `data_parallel=True`
(run.py). The group is NCCL on CUDA and gloo on the CPU; nothing is read
from the environment. One process is a no-op, and a trainer then runs as
without data parallelism.

    # on each of n processes, i = 0..n-1:
    launch.init("tcp://localhost:29511", n, i)
    run_train_s2(exp_dir, ckpt_dir, batch_size=8, data_parallel=True)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, *, device=None) -> None:
    """Join the process group (no-op for one process). coordinator_address
    is "tcp://host:port" or "host:port", the same for every process;
    device None means CUDA (NCCL, on card process_id % device count), "cpu"
    gloo."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init: give coordinator_address, num_processes and process_id together")
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=url, world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_info() -> dict:
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": process_index(), "process_count": process_count(), "local_devices": local,
            "global_devices": local * process_count()}


def host_shard(items: list, *, shuffle_seed: Optional[int] = None) -> list:
    """This process's share of a global work list, items[index::count]
    (the reference's lines[i_part::all_parts]), after a seeded shuffle."""
    if shuffle_seed is not None:
        order = np.random.default_rng(shuffle_seed).permutation(len(items))
        items = [items[i] for i in order]
    return items[process_index() :: process_count()]
