"""Parity of the port's CSR gathers (kernels 3 and 4 and their entry points)
with the JAX package's Pallas kernels in interpret mode and its jnp gather.

Cases: zero-count rows (they share an offset, and the side=right bisection
must pick the row JAX picks), ``num_rows == 0``, overflow
(``num_dropped > 0``), a uint32 table with ``fill=-1``, and the layered
gather's interleave order.  All comparisons are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import hashgraph as jhashgraph
from repro.kernels import ops as jops
from repro_torch.core import hashgraph
from repro_torch.kernels import build, csr_gather, ops


def _runs(rng, n_rows: int, table_len: int, zero_every: int = 3, max_count: int = 5):
    counts = rng.integers(0, max_count, size=n_rows).astype(np.int32)
    counts[::zero_every] = 0
    starts = np.zeros(n_rows, np.int32)
    if n_rows:
        starts = rng.integers(0, max(1, table_len - max_count), size=n_rows).astype(np.int32)
    return starts, counts


def _assert_same(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        np.testing.assert_array_equal(p, np.asarray(r))


CASES = [
    # (n_rows, table_len, capacity): fits, exact fit region, overflow, empty
    (40, 300, 512),
    (200, 1000, 256),  # total > capacity: num_dropped > 0
    (1, 8, 16),
    (0, 16, 64),
]


@pytest.mark.parametrize("n_rows,table_len,capacity", CASES)
def test_csr_gather_matches_pallas_and_jnp(n_rows, table_len, capacity):
    rng = np.random.default_rng(n_rows * 7 + capacity)
    starts, counts = _runs(rng, n_rows, table_len)
    table = rng.integers(-1000, 1000, size=table_len, dtype=np.int32)
    port = ops.csr_gather(
        torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table),
        capacity=capacity,
    )
    if n_rows == 0:
        # Both JAX gathers raise on an empty row axis; the contract is still
        # defined: no valid slot, nothing read.
        _assert_same(port, ([0], [-1] * capacity, [-1] * capacity, 0))
        return
    ref_jnp = jhashgraph.csr_gather(
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(table), capacity
    )
    _assert_same(port, ref_jnp)
    ref_pallas = jops.csr_gather(
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(table),
        capacity=capacity, interpret=True,
    )
    _assert_same(port, ref_pallas)
    # The plain full-contract gather is the same function.
    _assert_same(
        hashgraph.csr_gather(
            torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table), capacity
        ),
        ref_jnp,
    )
    if n_rows == 200:
        assert int(port[3]) > 0


def test_csr_gather_zero_count_rows_pick_the_reference_row():
    # Rows 1..3 are empty and share offset 2 with row 4's first slot.
    starts = np.array([0, 5, 6, 7, 10, 0], np.int32)
    counts = np.array([2, 0, 0, 0, 3, 0], np.int32)
    table = np.arange(100, 120, dtype=np.int32)
    port = ops.csr_gather(
        torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table), capacity=8
    )
    ref = jops.csr_gather(
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(table), capacity=8, interpret=True
    )
    _assert_same(port, ref)
    assert port[1].tolist() == [0, 0, 4, 4, 4, -1, -1, -1]


def test_csr_gather_uint32_table_fill_is_all_ones():
    rng = np.random.default_rng(5)
    starts, counts = _runs(rng, 30, 200)
    table = rng.integers(0, 2**32, size=200, dtype=np.uint64).astype(np.uint32)
    port = ops.csr_gather(
        torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table),
        capacity=256, fill=-1,
    )
    assert port[2].dtype == torch.uint32
    ref = jops.csr_gather(
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(table),
        capacity=256, fill=-1, interpret=True,
    )
    np.testing.assert_array_equal(port[2].view(torch.int32).numpy().view(np.uint32), np.asarray(ref[2]))
    assert port[2].view(torch.int32).numpy().view(np.uint32)[-1] == 0xFFFFFFFF
    _assert_same(port[:2], ref[:2])


@pytest.mark.parametrize("n_rows,table_len,capacity", CASES[:3])
def test_csr_gather_batched_matches_pallas(n_rows, table_len, capacity):
    rng = np.random.default_rng(n_rows + 11)
    pairs = [_runs(rng, n_rows, table_len) for _ in range(3)]
    starts = np.stack([p[0] for p in pairs])
    counts = np.stack([p[1] for p in pairs])
    counts[1] = 0  # one source with no results at all
    table = rng.integers(-1000, 1000, size=table_len, dtype=np.int32)
    port = ops.csr_gather_batched(
        torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table),
        capacity=capacity,
    )
    ref = jops.csr_gather_batched(
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(table),
        capacity=capacity, interpret=True,
    )
    _assert_same(port, ref)


@pytest.mark.parametrize("layers", [1, 2])
def test_csr_gather_layers_matches_pallas(layers):
    rng = np.random.default_rng(layers)
    sources, n, cap = 4, 24, 96
    tables = [rng.integers(-500, 500, size=60 + 10 * i, dtype=np.int32) for i in range(layers)]
    starts, counts, off = [], [], 0
    for t in tables:
        s, c = zip(*[_runs(rng, n, t.shape[0]) for _ in range(sources)])
        starts.append(np.stack(s) + off)
        counts.append(np.stack(c))
        off += t.shape[0]
    starts, counts = np.stack(starts), np.stack(counts)
    port = ops.csr_gather_layers(
        torch.from_numpy(starts), torch.from_numpy(counts),
        tuple(torch.from_numpy(t) for t in tables), capacity=cap,
    )
    ref = jops.csr_gather_layers(
        jnp.asarray(starts), jnp.asarray(counts), tuple(jnp.asarray(t) for t in tables),
        capacity=cap, interpret=True,
    )
    _assert_same(port, ref)
    _assert_same(
        ops.interleave_layer_runs(
            torch.from_numpy(starts), torch.from_numpy(counts),
            tuple(torch.from_numpy(t) for t in tables),
        ),
        jops.interleave_layer_runs(
            jnp.asarray(starts), jnp.asarray(counts), tuple(jnp.asarray(t) for t in tables)
        ),
    )


def test_gather_wrappers_check_inputs_and_count_no_cpu_launch():
    before = dict(build.LAUNCHES)
    off = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    st = torch.tensor([1, 0, 3], dtype=torch.int32)
    table = torch.arange(10, dtype=torch.int32)
    vals, rows = csr_gather.csr_gather_2d(off, st, table, 6)
    assert vals.tolist() == [1, 2, 3, 4, 5, -1] and rows.tolist() == [0, 0, 2, 2, 2, -1]
    assert dict(build.LAUNCHES) == before
    with pytest.raises(ValueError):
        csr_gather.csr_gather_2d(off[:-1], st, table, 6)
    with pytest.raises(TypeError):
        csr_gather.csr_gather_2d(off.long(), st, table, 6)
    with pytest.raises(ValueError):
        csr_gather.csr_gather_batched_2d(off, st, table, 6)
