"""KV-cache subsystem: serving-cache semantics over the versioned table
(port of ``repro.cache``).

Upsert (insert-or-replace) resolved through the delta and tombstone
machinery, per-row TTLs on the state's logical clock, policy-driven
eviction that reclaims capacity, and a YCSB-style workload generator.

* :class:`KVCache`: the eager cache facade (put/get/delete/advance/
  maintain) over one ``TableState``, on its table's device.
* :mod:`repro_torch.cache.workload`: zipfian YCSB A–F op-stream
  generators (numpy, the reference's streams).
"""
from repro_torch.cache.kvcache import KVCache
from repro_torch.cache.workload import (
    WORKLOADS,
    WorkloadSpec,
    YCSBWorkload,
    ZipfianGenerator,
    key_of,
)

__all__ = [
    "KVCache",
    "WORKLOADS",
    "WorkloadSpec",
    "YCSBWorkload",
    "ZipfianGenerator",
    "key_of",
]
