"""PyTorch + CUDA port of the distributed HashGraph (``repro`` is the JAX reference).

The D shards of a table live on one device as tensors with a leading shard
axis; the all-to-all exchange is a transpose of that axis.  Every Pallas
kernel the main path runs has a hand-written CUDA counterpart under
``csrc/`` that is built with ``nvcc`` at first use (see
``repro_torch.kernels.build``); on CPU tensors each wrapper takes its plain
PyTorch twin instead.
"""
from repro_torch.core.schema import TableSchema
from repro_torch.core.table import (
    DistributedHashTable,
    join_to_pairs,
    retrieval_to_lists,
)

__all__ = [
    "DistributedHashTable",
    "TableSchema",
    "join_to_pairs",
    "retrieval_to_lists",
]
