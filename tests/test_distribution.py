import numpy as np
import pytest

from coala_gnn.coloring import generate_color_metadata
from coala_gnn.distribution import (
    DistributionScheduler,
    SeedDistributor,
    greedy_affinity_assign,
)


@pytest.fixture(scope="module")
def colored(request):
    ds = request.getfixturevalue("small_dataset")
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02, seed=0)
    return ds, meta


# make module-scoped fixture able to see session fixture
@pytest.fixture(scope="module")
def small_dataset():
    from coala_gnn.graph.datasets import synthetic_graph
    return synthetic_graph(num_nodes=2000, avg_degree=10, feature_dim=32,
                           num_classes=8, seed=7)


def test_greedy_native_matches_python(colored):
    ds, meta = colored
    num_parts, cap = 4, 64
    rng = np.random.default_rng(0)
    cache_meta = rng.integers(0, 50, size=(num_parts, meta.num_colors + 1)).astype(np.int32)
    seeds = ds.train_idx[: num_parts * cap]
    a_native = greedy_affinity_assign(seeds, meta.color, meta.topk, meta.score,
                                      cache_meta, cap, use_native=True)
    a_py = greedy_affinity_assign(seeds, meta.color, meta.topk, meta.score,
                                  cache_meta, cap, use_native=False)
    np.testing.assert_array_equal(a_native, a_py)


def test_greedy_respects_capacity_and_scores(colored):
    ds, meta = colored
    num_parts, cap = 3, 50
    # Part 1's cache is crammed with every color -> should win most seeds
    # until it hits capacity.
    cache_meta = np.zeros((num_parts, meta.num_colors + 1), dtype=np.int32)
    cache_meta[1, :] = 100
    seeds = ds.train_idx[: num_parts * cap]
    assign = greedy_affinity_assign(seeds, meta.color, meta.topk, meta.score,
                                    cache_meta, cap)
    counts = np.bincount(assign, minlength=num_parts)
    assert counts[1] == cap                      # filled first
    assert counts.sum() == num_parts * cap
    assert (counts <= cap).all()


def test_distributor_baseline_striping(colored):
    ds, _ = colored
    d = SeedDistributor(ds.train_idx, batch_size=8, local_size=2, num_parts=2,
                        mode="baseline", shuffle_seed=1)
    out = d.distribute(0)
    assert out.shape == (2, 16)
    window = d.items[:32]
    np.testing.assert_array_equal(out[0], window[:16])
    np.testing.assert_array_equal(out[1], window[16:])
    # device slices partition the domain
    np.testing.assert_array_equal(d.device_slice(out[0], 0), out[0][:8])
    np.testing.assert_array_equal(d.device_slice(out[0], 1), out[0][8:])


def test_distributor_node_color_partitions_window(colored):
    ds, meta = colored
    d = SeedDistributor(ds.train_idx, batch_size=8, local_size=2, num_parts=2,
                        mode="node_color", color=meta.color,
                        topk_colors=meta.topk, affinity=meta.score,
                        shuffle_seed=1)
    cache_meta = np.random.default_rng(3).integers(
        0, 20, size=(2, meta.num_colors + 1)).astype(np.int32)
    out = d.distribute(0, cache_meta)
    window = d.items[: d.global_batch]
    # the two domain slices are a permutation of the window
    np.testing.assert_array_equal(np.sort(out.reshape(-1)), np.sort(window))


def test_distributor_deterministic_across_replicas(colored):
    """Two independently-constructed distributors (as on two hosts) must
    produce identical assignments from identical inputs."""
    ds, meta = colored
    mk = lambda: SeedDistributor(ds.train_idx, batch_size=8, local_size=2,
                                 num_parts=2, mode="node_color",
                                 color=meta.color, topk_colors=meta.topk,
                                 affinity=meta.score, shuffle_seed=9)
    cache_meta = np.random.default_rng(5).integers(
        0, 20, size=(2, meta.num_colors + 1)).astype(np.int32)
    np.testing.assert_array_equal(mk().distribute(3, cache_meta),
                                  mk().distribute(3, cache_meta))


def test_scheduler_pipeline_covers_stream(colored):
    ds, meta = colored
    B, L, P = 8, 2, 2
    d = SeedDistributor(ds.train_idx, batch_size=B, local_size=L, num_parts=P,
                        mode="node_color", color=meta.color,
                        topk_colors=meta.topk, affinity=meta.score,
                        shuffle_seed=0)
    meta_calls = []

    def meta_fn():
        meta_calls.append(1)
        return np.ones(meta.num_colors + 1, dtype=np.int32)

    sched = DistributionScheduler(d, part_id=0, local_rank=1,
                                  meta_fn=meta_fn, refresh_counter=4)
    seen = []
    n = min(d.num_iters, 9)
    for _ in range(n):
        seeds = sched.run()
        assert seeds.shape == (B,)
        seen.append(seeds)
    # refresh cadence: ceil(n/4) exchanges
    assert len(meta_calls) == (n + 3) // 4
    sched.reset()
    s2 = sched.run()
    assert s2.shape == (B,)


def test_drop_tail_false_visits_every_seed():
    """Exact-epoch mode: ceil iteration count, final window wrap-padded,
    and the union of all windows covers every train seed."""
    from coala_gnn.distribution import SeedDistributor

    ids = np.arange(1000, 1103)           # 103 seeds, global_batch = 16
    d = SeedDistributor(ids, batch_size=4, local_size=2, num_parts=2,
                        shuffle_seed=0, drop_tail=False)
    assert d.num_iters == -(-103 // 16)   # ceil -> 7
    seen = set()
    for it in range(d.num_iters):
        parts = d.distribute(it)
        assert parts.shape == (2, 8)
        seen.update(parts.reshape(-1).tolist())
    assert seen == set(ids.tolist())

    # reference-parity default still drops the tail
    d2 = SeedDistributor(ids, batch_size=4, local_size=2, num_parts=2,
                         shuffle_seed=0)
    assert d2.num_iters == 103 // 16


def test_drop_tail_false_tiny_dataset_wraps():
    from coala_gnn.distribution import SeedDistributor

    d = SeedDistributor(np.arange(5), batch_size=4, local_size=2,
                        num_parts=1, shuffle_seed=1, drop_tail=False)
    assert d.num_iters == 1
    parts = d.distribute(0)
    assert parts.shape == (1, 8)
    assert set(parts.reshape(-1).tolist()) == set(range(5))


def test_valid_mask_marks_wrapped_slots():
    """valid_mask(it) flags exactly the real (non-wrap-padded) slots, in
    distribute()'s [num_parts, domain_batch] layout (eval tail
    masks must come from the distributor, not a caller-side arange)."""
    from coala_gnn.distribution import SeedDistributor

    ids = np.arange(1000, 1103)           # 103 seeds, global_batch = 16
    d = SeedDistributor(ids, batch_size=4, local_size=2, num_parts=2,
                        shuffle_seed=0, drop_tail=False)
    total_valid = 0
    for it in range(d.num_iters):
        m = d.valid_mask(it)
        assert m.shape == (2, 8)
        total_valid += int(m.sum())
        if it < d.num_iters - 1:
            assert m.all()
        else:
            # baseline striping preserves window order: the valid slots of
            # the final window are exactly its leading 103 % 16 positions
            assert int(m.sum()) == 103 % 16
            parts = d.distribute(it)
            real = parts.reshape(-1)[m.reshape(-1)]
            assert len(set(real.tolist())) == len(real)  # no duplicates
    assert total_valid == len(ids)


def test_valid_mask_refuses_reordering_mode(colored):
    """Positional tail masks are unsound under node_color reordering —
    valid_mask must refuse rather than miscount."""
    import pytest
    from coala_gnn.distribution import SeedDistributor

    _, meta = colored
    d = SeedDistributor(np.arange(64), batch_size=4, local_size=2,
                        num_parts=2, mode="node_color", color=meta.color,
                        topk_colors=meta.topk, affinity=meta.score,
                        shuffle_seed=0, drop_tail=False)
    with pytest.raises(ValueError):
        d.valid_mask(0)


def test_distribute_return_valid_baseline_matches_mask():
    """distribute(return_valid=True) equals the positional valid_mask in
    baseline mode, and the valid slots cover every seed exactly once."""
    ids = np.arange(1000, 1103)           # 103 seeds, global_batch = 16
    d = SeedDistributor(ids, batch_size=4, local_size=2, num_parts=2,
                        shuffle_seed=0, drop_tail=False)
    seen = []
    for it in range(d.num_iters):
        out, valid = d.distribute(it, return_valid=True)
        np.testing.assert_array_equal(valid, d.valid_mask(it))
        np.testing.assert_array_equal(out, d.distribute(it))
        seen.extend(out[valid].tolist())
    assert sorted(seen) == ids.tolist()


def test_distribute_return_valid_node_color(colored):
    """Validity rides THROUGH the node_color reordering: across an epoch
    the valid slots name every seed exactly once, and the final window's
    invalid slots hold only wrapped duplicates (the case positional
    valid_mask refuses)."""
    _, meta = colored
    rng = np.random.default_rng(3)
    ids = np.arange(100)                   # global_batch = 16 -> tail of 4
    d = SeedDistributor(ids, batch_size=4, local_size=2, num_parts=2,
                        mode="node_color", color=meta.color,
                        topk_colors=meta.topk, affinity=meta.score,
                        shuffle_seed=0, drop_tail=False)
    cache_meta = rng.integers(
        0, 50, size=(2, meta.num_colors + 1)).astype(np.int32)
    seen = []
    for it in range(d.num_iters):
        out, valid = d.distribute(it, cache_meta, return_valid=True)
        assert out.shape == valid.shape == (2, 8)
        if it < d.num_iters - 1:
            assert valid.all()
        else:
            assert int(valid.sum()) == 100 % 16
            # wrapped duplicates are real epoch seeds seen before
            assert set(out[~valid].tolist()) <= set(seen)
        seen.extend(out[valid].tolist())
    assert sorted(seen) == ids.tolist()


def test_scheduler_threads_domain_valid():
    """The pipelined scheduler exposes each run_domain() slice's validity
    (computed with the same one-iteration-ahead distribution)."""
    ids = np.arange(103)
    d = SeedDistributor(ids, batch_size=4, local_size=2, num_parts=1,
                        shuffle_seed=0, drop_tail=False)
    s = DistributionScheduler(d, part_id=0, local_rank=0)
    seen = []
    for _ in range(d.num_iters):
        dom = s.run_domain()
        v = s.domain_valid
        assert v is not None and v.shape == dom.shape
        seen.extend(dom[v].tolist())
    assert sorted(seen) == ids.tolist()
    s.reset()
    dom = s.run_domain()                  # restart: first window all-valid
    assert s.domain_valid is not None and s.domain_valid.all()
