"""The launch geometry of kernels 1-5 and its resolver (port of
``repro.kernels.common``).

``block_rows`` keeps the reference's meaning: a CTA's tile in rows of 128
elements (keys, bins, routed slots or output slots), what one Pallas grid
step covered.  Each kernel turns it into a block of threads:

- ``murmur`` (kernel 1, ``csrc/murmur.cu``): a thread moves one 16-byte
  vector of four words, so ``block_rows x 32`` threads, a launch argument;
- ``bin_histogram`` (kernel 2, ``csrc/histogram.cu``): four ids a thread,
  ``block_rows x 32`` threads, a launch argument;
- ``csr_gather`` / ``csr_gather_batched`` (kernels 3-4,
  ``csrc/csr_gather.cu``): eight output slots a thread, ``block_rows x 16``
  threads, a compile-time constant (``__launch_bounds__`` and the register
  arrays), so one template instance per candidate: 128, 256 and 512 threads
  for each of the kernel's column counts;
- ``bucket_probe`` (kernel 5, ``csrc/bucket_probe.cu``): four routed slots
  a thread, ``block_rows x 32`` threads, template instances at 128 and 256.

:data:`DEFAULT_BLOCK_ROWS` is the geometry each kernel launched with before
the resolver existed (256 x 4 keys, 512 x 4 bins, 256 x 8 slots, 256 x 4
slots), so an untuned launch is the same launch.  The reference's table
(64 / 8 / 8 / 8 / 8) sized TPU tiles; these size CTAs.  The owner and
querier sides of a retrieve (``csr_gather_owners`` / ``_queriers``) run the
gather's routine over many CSRs and resolve under ``csr_gather_batched``;
the probe's layer entry resolves under ``bucket_probe``.

The reference's ``use_interpret_mode``, ``pad_to_block_1d`` and
``as_lanes`` serve the TPU's (rows, 128) lane layout and Pallas's interpret
mode; the CUDA kernels take flat arrays of any length and have no
interpret mode, so the port has no counterpart of them.
"""
from __future__ import annotations

from typing import Optional

DEFAULT_BLOCK_ROWS = {
    "murmur": 8,
    "bin_histogram": 16,
    "bucket_probe": 8,
    "csr_gather": 16,
    "csr_gather_batched": 16,
}

# The block_rows each kernel can launch with, and threads per row of 128.
CANDIDATES = {
    "murmur": (1, 2, 4, 8, 16, 32),
    "bin_histogram": (1, 2, 4, 8, 16, 32),
    "bucket_probe": (4, 8),
    "csr_gather": (8, 16, 32),
    "csr_gather_batched": (8, 16, 32),
}
_THREADS_PER_ROW = {
    "murmur": 32,
    "bin_histogram": 32,
    "bucket_probe": 32,
    "csr_gather": 16,
    "csr_gather_batched": 16,
}


def resolve_block_rows(
    kernel: str,
    override: Optional[int] = None,
    *,
    n: Optional[int] = None,
    width: int = 1,
) -> int:
    """The ``block_rows`` a wrapper launches ``kernel`` with for one call.

    Resolution order: explicit ``override`` -> autotuned winner (the
    in-process cache of :mod:`repro_torch.kernels.autotune`, seeded from its
    JSON file) -> :data:`DEFAULT_BLOCK_ROWS`.  ``n`` is the call's dominant
    size (keys, ids, slots or capacity) and ``width`` its columns or lanes:
    together they pick the cache's bucket.  The wrappers resolve at every
    launch, so a cache loaded later takes effect on the next call.
    """
    if override is not None:
        return int(override)
    from repro_torch.kernels import autotune  # local import: autotune drives the wrappers

    tuned = autotune.cached_block_rows(kernel, n=n, width=width)
    if tuned is not None:
        return int(tuned)
    return DEFAULT_BLOCK_ROWS[kernel]


def threads_for(kernel: str, block_rows: int) -> int:
    """The CTA's threads for ``block_rows`` of ``kernel``; ``ValueError`` for
    a tile the kernel was not built for (:data:`CANDIDATES`)."""
    if int(block_rows) not in CANDIDATES[kernel]:
        raise ValueError(f"{kernel}: block_rows {block_rows} is not one of "
                         f"{CANDIDATES[kernel]}")
    return int(block_rows) * _THREADS_PER_ROW[kernel]


def launch_threads(kernel: str, block_rows: Optional[int], *, n: int, width: int = 1) -> int:
    """:func:`resolve_block_rows` then :func:`threads_for`: what a wrapper
    passes its kernel on the card."""
    return threads_for(kernel, resolve_block_rows(kernel, block_rows, n=n, width=width))
