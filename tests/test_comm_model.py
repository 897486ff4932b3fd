"""Communication byte-accounting model.

The wire traffic of the exchange is shape-determined (fixed buckets ride
the all_to_all, padding included), so the model is checked against the
ACTUAL shapes the cache compiles, and its mode split against the measured
group-scoping behavior on the virtual mesh."""

import numpy as np
import pytest

from coala_gnn.cache import feature_cache as fc
from coala_gnn.parallel import comm_model as cm
from coala_gnn.parallel.mesh import make_mesh
from coala_gnn.parallel.sharded_cache import ShardedFeatureCache


def test_bucket_cap_is_the_kernel_sizing():
    """The model's sizes must BE the kernels' sizes — enforced structurally:
    both import the same parallel/sizing helpers (no mirrored formulas to
    drift), and the kernels build without error from them."""
    from coala_gnn.parallel import sizing
    assert cm.bucket_cap is sizing.lookup_bucket_cap
    assert cm.fill_bucket_cap is sizing.fill_bucket_cap
    assert cm.ceil_pow2 is sizing.ceil_pow2

    mesh = make_mesh()
    n_dev = mesh.devices.size
    cfg = fc.CacheConfig(num_sets=8, ways=fc.WAYS, dim=16,
                         cache_dim=128, num_colors=0, num_shards=n_dev)
    cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="sharded")
    cache._lookup_kernel(96)      # compiles with sizing.lookup_bucket_cap
    cache._miss_kernels(96, 64)   # compiles with sizing.fill_bucket_cap


def test_fill_bytes_sized_from_miss_count_not_n_req():
    """Fill buckets follow the pow2-rounded MISS count (sharded_cache.fetch:
    m_cap = _ceil_pow2(m_max)), not the request capacity; warm steps ship
    zero fill bytes."""
    kw = dict(n_req=7680, n_dev=8, local=4, dim=256)
    warm = cm.step_traffic("sharded", **kw)
    assert warm["fill_miss_step"] == {"off_device": 0, "cross_host": 0}

    t = cm.step_traffic("sharded", misses=512, **kw)
    fill_cap = cm.fill_bucket_cap(cm.ceil_pow2(512), 8)  # = min(512, 256)
    assert fill_cap == 256
    per_peer = fill_cap * (4 + 256 * 4 + 4)     # ids + f32 row + color
    assert t["fill_miss_step"]["off_device"] == 7 * per_peer
    assert t["fill_miss_step"]["cross_host"] == 4 * per_peer


def test_meta_bytes_are_per_device():
    """meta_allgather_bytes is a per-HOST bill; step_traffic's per-device
    totals must carry only this device's share of it."""
    kw = dict(n_req=7680, n_dev=8, local=4, dim=256, num_colors=2000,
              refresh_counter=8)
    t = cm.step_traffic("node_local", **kw)
    host_bill = cm.meta_allgather_bytes(2000, 2)
    assert t["meta_host_per_refresh"] == host_bill
    assert t["meta_per_step"] == pytest.approx(host_bill / 8 / 4)
    # summing device totals over one host reproduces the host bill exactly
    assert 4 * t["meta_per_step"] * 8 == pytest.approx(host_bill)


def test_mode_split_identities():
    """off_device = intra_host + cross_host per phase; node_local crosses
    ZERO feature bytes; sharded on 2 hosts crosses (G - local)/(G - 1) of
    its off-device bytes; isolated moves nothing."""
    kw = dict(n_req=7680, n_dev=8, local=4, dim=256, param_bytes=4_000_000,
              num_colors=1000)
    sh = cm.step_traffic("sharded", **kw)
    nl = cm.step_traffic("node_local", **kw)
    iso = cm.step_traffic("isolated", **kw)

    for t in (sh, nl):
        ex = t["exchange"]
        for k in ("request", "response", "hitbits", "total"):
            assert ex["off_device"][k] == ex["intra_host"][k] + \
                ex["cross_host"][k]

    # node_local: exchange + fill never cross hosts; only grad psum + meta do
    assert nl["exchange"]["cross_host"]["total"] == 0
    assert nl["fill_miss_step"]["cross_host"] == 0
    assert nl["cross_host_total"] == nl["grad_psum"]["cross_host"] + \
        nl["meta_per_step"]

    # sharded: cross share of exchange = (G - local)/(G - 1) exactly
    ex = sh["exchange"]
    assert ex["cross_host"]["total"] * (8 - 1) == \
        ex["off_device"]["total"] * (8 - 4)

    # isolated: no exchange traffic at all
    assert iso["exchange"]["off_device"]["total"] == 0
    assert iso["cross_host_total"] == iso["grad_psum"]["cross_host"] + \
        iso["meta_per_step"]

    # and the headline claim: the CACHE's cross-host traffic (exchange +
    # fill; grad psum is mode-independent) drops from sharded's MB/step to
    # control-plane size (the amortized meta allgather) under node_local
    nl_cache_cross = nl["exchange"]["cross_host"]["total"] + \
        nl["meta_per_step"]
    sh_cache_cross = sh["exchange"]["cross_host"]["total"] + \
        sh["meta_per_step"]
    assert nl["exchange"]["cross_host"]["total"] == 0
    assert nl_cache_cross == nl["meta_per_step"]      # ~250 B/device here
    assert nl_cache_cross < sh_cache_cross / 1000


def test_int8_response_shrinks_response_bytes():
    kw = dict(n_req=7680, n_dev=8, local=4, dim=256)
    f32 = cm.step_traffic("sharded", **kw)
    i8 = cm.step_traffic("sharded", int8_response=True, **kw)
    r32 = f32["exchange"]["off_device"]["response"]
    r8 = i8["exchange"]["off_device"]["response"]
    # dim*4 bytes -> dim (int8 line) + 4 (its f32 scale, second a2a) per
    # slot — exactly what exchange_lookup ships (resp_q + resp_sc, once)
    assert r32 / r8 == pytest.approx(256 * 4 / (256 + 4), rel=1e-6)


def test_projection_monotone_in_bandwidth():
    p_slow = cm.project_efficiency(2.3e-3, cross_bytes=10_000_000,
                                   intra_bytes=50_000_000,
                                   dcn_gbps=6.25, ici_gbps=45)
    p_fast = cm.project_efficiency(2.3e-3, cross_bytes=0,
                                   intra_bytes=50_000_000,
                                   dcn_gbps=6.25, ici_gbps=45)
    assert 0 < p_slow["efficiency"] < p_fast["efficiency"] <= 1.0


def test_bytes_accounting_flagship_table():
    """The artifact generator's byte table: node_local must project above
    the >80% 1->2 host target while flat sharded pays a DCN exchange."""
    import sys
    sys.path.insert(0, "examples")
    import bytes_accounting as ba

    t = ba.flagship_bytes(step_ms=2.18, dcn_gbps=6.25, ici_gbps=45.0)
    rows = t["topologies"]["2hosts_x_4dev"]
    nl, sh = rows["node_local"], rows["sharded"]
    assert nl["exchange_cross_host_bytes"]["total"] == 0
    assert sh["exchange_cross_host_bytes"]["total"] > 10_000_000  # ~MBs
    eff = t["efficiency_1_to_2_hosts"]
    assert eff["node_local_f32_response"]["efficiency"] > 0.80
    assert eff["node_local_f32_response"]["efficiency"] > \
        eff["sharded_f32_response"]["efficiency"]
    # int8 responses shrink the DCN bill, lifting flat-sharded efficiency
    assert eff["sharded_int8_response"]["efficiency"] > \
        eff["sharded_f32_response"]["efficiency"]
