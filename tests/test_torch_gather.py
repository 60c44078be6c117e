"""Parity of the port's CSR gathers (kernels 3 and 4 and their entry points)
with the JAX package's Pallas kernels in interpret mode and its jnp gather.

Cases: zero-count rows (they share an offset, and the side=right bisection
must pick the row JAX picks), ``num_rows == 0``, overflow
(``num_dropped > 0``), a uint32 table with ``fill=-1``, and the layered
gather's interleave order.  The table path's owner and querier entries
(one launch per side) are held, through their plain twins, against the
compositions the path ran before (``interleave_layer_runs`` ->
``csr_gather_batched`` per owner, ``csr_gather`` per querier) and the JAX
package's jnp gathers, at 1, 3 and 7 layers and 1 and 4 shards, with empty
rows and tables, overflow, capacities that are not a multiple of 8, uint32
tables and one key with many duplicates.  All comparisons are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core import hashgraph as jhashgraph
from repro.core import multi_hashgraph as jmhg
from repro.kernels import ops as jops
from repro_torch.core import hashgraph
from repro_torch.kernels import build, csr_gather, ops
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


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


# --- The table path's entries: one owner launch, one querier launch -------


def _owner_case(seed, nl, d, r, widths=None, zero_frac=0.4, max_count=5, dup=None):
    """(L, D, D, R) per-layer runs inside each layer's own (D, M_l) table.

    ``dup`` gives one slot of owner 0 a run of that many words (one key with
    many duplicates), from the start of layer 0's table."""
    rng = np.random.default_rng(seed)
    widths = widths or [int(rng.integers(20, 200)) for _ in range(nl)]
    tables = [rng.integers(-1000, 1000, size=(d, w), dtype=np.int32) for w in widths]
    starts = np.zeros((nl, d, d, r), np.int32)
    counts = np.zeros((nl, d, d, r), np.int32)
    for i, w in enumerate(widths):
        if w == 0:
            continue
        c = rng.integers(0, max_count, size=(d, d, r)).astype(np.int32)
        c[rng.random((d, d, r)) < zero_frac] = 0
        starts[i] = rng.integers(0, w, size=(d, d, r))
        counts[i] = np.minimum(c, w - starts[i])
    if dup is not None:
        starts[0, 0, 0, r // 2], counts[0, 0, 0, r // 2] = 0, min(dup, widths[0])
    return starts, counts, tables


def _owners_today(starts, counts, tables, cap):
    """The composition the table path ran per owner before: starts rebased
    into the concatenated tables, ``interleave_layer_runs`` ->
    ``csr_gather_batched``, stacked."""
    widths = [t.shape[1] for t in tables]
    base = np.cumsum([0] + widths[:-1]).astype(np.int32).reshape(-1, 1, 1)
    segs, dropped = [], 0
    for o in range(counts.shape[1]):
        st, ct, table = ops.interleave_layer_runs(
            torch.from_numpy(starts[:, o] + base), torch.from_numpy(counts[:, o]),
            tuple(torch.from_numpy(t[o]) for t in tables),
        )
        _, _, seg, drop = ops.csr_gather_batched(st, ct, table, capacity=cap)
        segs.append(seg)
        dropped += int(drop)
    return torch.stack(segs), dropped


OWNER_CASES = [
    # (L, D, R, seg_capacity, options)
    (1, 1, 60, 128, {}),
    (3, 1, 80, 403, {}),
    (7, 1, 50, 640, {}),
    (1, 4, 40, 64, {}),
    (3, 4, 30, 210, {}),
    (7, 4, 20, 300, {}),
    (3, 4, 30, 37, {"overflow": True}),  # a capacity that is not a multiple of 8
    (3, 1, 40, 96, {"widths": [0, 60, 0]}),  # empty layer tables
    (3, 1, 40, 96, {"widths": [0, 0, 0]}),  # every table empty
    (1, 1, 0, 16, {}),  # no routed slot
    (3, 1, 30, 700, {"widths": [600, 40, 40], "dup": 600}),  # one key, many duplicates
    (7, 1, 400, 64, {"zero_frac": 0.97, "overflow": True}),  # mostly empty rows
    (70, 2, 12, 1100, {}),  # deeper than a launch's parameters could list
]


@pytest.mark.parametrize("nl,d,r,cap,kw", OWNER_CASES)
def test_owner_entry_twin_matches_todays_composition_and_jax(nl, d, r, cap, kw):
    kw = dict(kw)
    overflow = kw.pop("overflow", False)
    starts, counts, tables = _owner_case(nl * 100 + d * 10 + r, nl, d, r, **kw)
    seg, dropped, slot_counts = csr_gather.csr_gather_owners_plain(
        torch.from_numpy(starts), torch.from_numpy(counts),
        tuple(torch.from_numpy(t) for t in tables), cap,
    )
    assert seg.shape == (d, d, cap) and dropped.shape == (d, d)
    np.testing.assert_array_equal(slot_counts.numpy(), counts.sum(0))
    assert slot_counts.dtype == torch.int32
    want_seg, want_dropped = _owners_today(starts, counts, tables, cap)
    assert torch.equal(seg, want_seg)
    totals = counts.sum((0, 3)).astype(np.int64)
    np.testing.assert_array_equal(dropped.numpy(), np.maximum(totals - cap, 0))
    assert int(dropped.sum()) == want_dropped
    assert (int(dropped.sum()) > 0) == overflow
    # The wrapper and the ops entry take the twin on the CPU, launching nothing.
    before = dict(build.LAUNCHES)
    got = ops.csr_gather_owners(
        torch.from_numpy(starts), torch.from_numpy(counts),
        tuple(torch.from_numpy(t) for t in tables), capacity=cap,
    )
    assert torch.equal(got[0], seg) and int(got[1]) == int(dropped.sum())
    assert torch.equal(got[2], slot_counts)
    assert dict(build.LAUNCHES) == before
    if r == 0 or all(t.shape[1] == 0 for t in tables):
        assert bool((seg == -1).all())
        return
    # The JAX package's jnp layered gather, owner by owner.
    widths = [t.shape[1] for t in tables]
    base = np.cumsum([0] + widths[:-1]).astype(np.int32).reshape(-1, 1, 1)
    for o in range(d):
        ref_seg, ref_dropped = jmhg._csr_gather_layers_ref(
            jnp.asarray(starts[:, o] + base), jnp.asarray(counts[:, o]),
            tuple(jnp.asarray(t[o]) for t in tables), cap,
        )
        np.testing.assert_array_equal(seg[o].numpy(), np.asarray(ref_seg))
        assert int(dropped[o].sum()) == int(ref_dropped)


def test_owner_entry_uint32_tables_fill_all_ones():
    starts, counts, tables = _owner_case(7, 3, 2, 30)
    utables = tuple(torch.from_numpy(t.view(np.uint32) | np.uint32(0x80000000)) for t in tables)
    seg, _, _ = ops.csr_gather_owners(
        torch.from_numpy(starts), torch.from_numpy(counts), utables, capacity=128,
    )
    assert seg.dtype == torch.uint32
    as_u = seg.view(torch.int32).numpy().view(np.uint32)
    want, _ = _owners_today(starts, counts, [t.numpy().view(np.int32) for t in utables], 128)
    np.testing.assert_array_equal(as_u, want.numpy().view(np.uint32))
    assert as_u[0, 0, -1] == 0xFFFFFFFF and (as_u[as_u != 0xFFFFFFFF] >= 0x80000000).all()


def _querier_case(seed, d, n, width, zero_frac=0.4, max_count=5, dup=None):
    rng = np.random.default_rng(seed)
    table = rng.integers(-1000, 1000, size=(d, width), dtype=np.int32)
    starts = np.zeros((d, n), np.int32)
    counts = np.zeros((d, n), np.int32)
    if width:
        c = rng.integers(0, max_count, size=(d, n)).astype(np.int32)
        c[rng.random((d, n)) < zero_frac] = 0
        starts = rng.integers(0, width, size=(d, n)).astype(np.int32)
        counts = np.minimum(c, width - starts).astype(np.int32)
    if dup is not None:
        starts[0, n // 3], counts[0, n // 3] = 0, min(dup, width)
    return starts, counts, table


def _queriers_today(starts, counts, table, cap):
    """What the table path ran before: ``ops.csr_gather`` querier by querier."""
    parts = [
        ops.csr_gather(torch.from_numpy(starts[q]), torch.from_numpy(counts[q]),
                       torch.from_numpy(table[q]), capacity=cap)
        for q in range(counts.shape[0])
    ]
    off, rows, vals, drop = zip(*parts)
    return torch.stack(off), torch.stack(rows), torch.stack(vals), sum(int(x) for x in drop)


QUERIER_CASES = [
    # (D, layers interleaved per query, queries, seg width, out capacity, options)
    (1, 1, 60, 300, 256, {}),
    (4, 1, 40, 200, 128, {}),
    (1, 3, 50, 400, 512, {}),
    (4, 3, 30, 300, 200, {}),
    (1, 7, 20, 500, 400, {}),
    (4, 7, 10, 300, 77, {"overflow": True}),  # a capacity that is not a multiple of 8
    (2, 1, 30, 0, 16, {}),  # empty segments (seg_capacity 0)
    (1, 1, 0, 16, 16, {}),  # no query rows
    (2, 1, 20, 900, 1000, {"dup": 900}),  # one key, many duplicates
    (1, 3, 300, 100, 64, {"zero_frac": 0.98}),  # mostly empty rows
]


@pytest.mark.parametrize("d,nl,n,width,cap,kw", QUERIER_CASES)
def test_querier_entry_twin_matches_todays_gathers_and_jax(d, nl, n, width, cap, kw):
    kw = dict(kw)
    overflow = kw.pop("overflow", False)
    starts, counts, table = _querier_case(d * 1000 + nl * 10 + n, d, n * nl, width, **kw)
    got = csr_gather.csr_gather_queriers_plain(
        torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table), cap
    )
    off, rows, vals, dropped = _queriers_today(starts, counts, table, cap)
    _assert_same(got[:3], (off, rows, vals))
    totals = counts.sum(1).astype(np.int64)
    np.testing.assert_array_equal(got[3].numpy(), np.maximum(totals - cap, 0))
    assert int(got[3].sum()) == dropped
    assert (dropped > 0) == overflow
    before = dict(build.LAUNCHES)
    entry = ops.csr_gather_queriers(
        torch.from_numpy(starts), torch.from_numpy(counts), torch.from_numpy(table), capacity=cap
    )
    _assert_same(entry[:3], got[:3])
    assert int(entry[3]) == dropped and dict(build.LAUNCHES) == before
    if n == 0 or width == 0:
        assert bool((vals == -1).all())
        return
    for q in range(d):
        ref = jhashgraph.csr_gather(
            jnp.asarray(starts[q]), jnp.asarray(counts[q]), jnp.asarray(table[q]), cap
        )
        _assert_same(tuple(x[q] for x in got), ref)


def test_querier_entry_uint32_table_fill_all_ones():
    starts, counts, table = _querier_case(3, 2, 40, 200)
    utable = torch.from_numpy(table.view(np.uint32))
    _, rows, vals, _ = ops.csr_gather_queriers(
        torch.from_numpy(starts), torch.from_numpy(counts), utable, capacity=128
    )
    assert vals.dtype == torch.uint32
    got = vals.view(torch.int32).numpy().view(np.uint32)
    _, _, want, _ = _queriers_today(starts, counts, table, 128)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
    assert got[0, -1] == 0xFFFFFFFF and rows[0, -1] == -1


def test_table_path_entries_check_their_inputs():
    starts, counts, tables = _owner_case(1, 2, 2, 10)
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    tabs = tuple(torch.from_numpy(t) for t in tables)
    with pytest.raises(ValueError):
        csr_gather.csr_gather_owners(st, ct, tabs[:1], 16)  # one table short
    with pytest.raises(ValueError):
        csr_gather.csr_gather_owners(st[:0], ct[:0], (), 16)  # no layer
    with pytest.raises(ValueError):
        csr_gather.csr_gather_owners(st, ct, tuple(t[:1] for t in tabs), 16)  # one owner's rows
    with pytest.raises(TypeError):
        csr_gather.csr_gather_owners(st.long(), ct, tabs, 16)
    with pytest.raises(ValueError):
        csr_gather.csr_gather_owners(st, ct, tabs, -1)
    with pytest.raises(ValueError):
        csr_gather.csr_gather_queriers(st[0, 0], ct[0, 0], tabs[0][:1], 16)
    with pytest.raises(TypeError):
        csr_gather.csr_gather_queriers(st[0, 0], ct[0, 0].long(), tabs[0], 16)
