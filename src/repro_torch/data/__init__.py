"""Data substrate: synthetic corpus, packing, HashGraph dedup, loader
(port of ``repro.data``)."""
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.data.packing import pack_documents
from repro_torch.data.dedup import sequence_fingerprints, dedup_mask, dedup_mask_distributed
from repro_torch.data.loader import ShardedLoader, LoaderState

__all__ = [
    "SyntheticCorpus",
    "pack_documents",
    "sequence_fingerprints",
    "dedup_mask",
    "dedup_mask_distributed",
    "ShardedLoader",
    "LoaderState",
]
