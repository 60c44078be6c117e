"""The port's versioned table against the JAX package: the routing variants
(the fused path, ``fused_routing=False`` and a mixed-split stack) and the
skew-guard fallback, step by step as ``test_torch_state.py`` holds the
rest.  Tolerance: none; every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch import DistributedHashTable
from test_torch_state import HASH_RANGE, MESHES, Pair, _mesh, _narrow_batch, _np
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


def _four_layer(p, rng):
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    p.init(keys)
    for _ in range(3):
        p.apply("insert", rng.integers(0, 1 << 14, 64, dtype=np.uint32))
    return p.apply("delete", keys[:16])


@pytest.fixture(scope="module")
def fused_stack():
    """``fused_stack(d)``: the port's default (fused, coherent) stack of
    ``_four_layer``, built once per mesh; each variant's reads are held
    against it (each case builds and checks its own pair against the
    reference)."""
    made = {}

    def get(d: int):
        if d not in made:
            rng = np.random.default_rng(29)
            pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu")
            keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
            ps = pt.init(keys)
            for _ in range(3):
                ps = ps.insert(rng.integers(0, 1 << 14, 64, dtype=np.uint32))
            made[d] = (pt, ps.delete(keys[:16]))
        return made[d]

    return get


@MESHES
@pytest.mark.parametrize(
    "variant", ["fused", "forced-per-layer", "mixed-splits"]
)
def test_routing_variants_match_reference_and_each_other(d, variant, request, fused_stack):
    """The fused path, ``fused_routing=False`` on the same coherent stack and
    a mixed-split stack (``coherent_deltas=False``) give the reference's
    results, and the same results as each other."""
    kw = {"fused": {}, "forced-per-layer": {"fused_routing": False},
          "mixed-splits": {"coherent_deltas": False}}[variant]
    p = _four_layer(Pair(_mesh(request, d), d, **kw), np.random.default_rng(29))
    assert p.ps.coherent == (variant != "mixed-splits")
    q = np.random.default_rng(30).integers(0, 1 << 14, 256, dtype=np.uint32)
    p.check(q)
    fused_pt, fused_ps = fused_stack(d)
    np.testing.assert_array_equal(_np(p.pt.query(p.ps, q)), _np(fused_pt.query(fused_ps, q)))
    got, want = p.pt.retrieve(p.ps, q), fused_pt.retrieve(fused_ps, q)
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)))


@pytest.mark.parametrize("guard", [True, False], ids=["guard", "no-guard"])
def test_skew_guard_fallback(mesh8, guard):
    """A batch skewed onto one owner would overflow the frozen-splits
    dispatch: the guard builds it on its own splits (incoherent, no drops);
    without the guard both packages drop the same rows."""
    p = Pair(mesh8, 8, skew_guard=guard)
    keys = np.random.default_rng(23).integers(0, 1 << 14, 512, dtype=np.uint32)
    p.init(keys)
    narrow = _narrow_batch(p.js, HASH_RANGE, p.jt.seed, 512)
    p.apply("insert", narrow)
    assert p.pt.skew_fallbacks == p.jt.skew_fallbacks == int(guard)
    assert p.ps.coherent == (not guard)
    assert (int(p.ps.num_dropped) == 0) == guard
    p.check(np.concatenate([narrow[:64], keys[:64]]))
    if guard:  # a well-spread batch keeps the stack's routing
        spread = np.random.default_rng(24).integers(0, 1 << 14, 512, dtype=np.uint32)
        p.apply("insert", spread)
        assert p.pt.skew_fallbacks == 1 and not p.ps.coherent
