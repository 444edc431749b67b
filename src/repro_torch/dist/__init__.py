"""Coded all-reduce on torch.distributed (NCCL on the card, gloo on the
CPU): the paper's Algorithm 1/2 aggregation over the ranks of a process
group."""

from .coded_allreduce import (  # noqa: F401
    CodedAllReduce,
    DevicePartition,
    partition_workers,
)
