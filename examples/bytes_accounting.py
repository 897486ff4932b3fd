#!/usr/bin/env python
"""Scaling evidence via exact byte accounting.

Virtual-device wall-clock says nothing about the links between real
devices, so this artifact carries what IS knowable without a cluster:

1. EXACT per-step wire bytes of the cache exchange per mode — the traffic
   is shape-determined (fixed all_to_all buckets, padding included), so
   these are closed-form, not estimates (coala_gnn/parallel/comm_model).
   Split intra-host vs cross-host (DCN) for the flagship bench
   shapes on a 2-host x 4-device topology and the reference's 4x4.
2. A measured virtual-mesh A/B: clustered graph, 2 emulated hosts, affinity
   (node_color) vs striping (baseline) seed distribution over node_local
   caches — evidence that hit ratio HOLDS when the exchange is host-scoped
   and seeds are steered by color affinity (the reference's whole design:
   nvshmem_manager.cuh:15-28 + node_distributor_pybind.cuh:150-222).
3. A 1 -> 2 host efficiency projection: measured single-chip step time
   (pass --step_ms from the live bench) + the byte model + the link
   bandwidths you state, against BASELINE.md's >80% target.

  COALA_CPU_DEVICES=8 python examples/bytes_accounting.py --platform cpu \
      --step_ms <bench ms/step> --dcn_gbps <GB/s> --ici_gbps <GB/s> \
      --out scaling.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def flagship_bytes(step_ms: float, dcn_gbps: float, ici_gbps: float):
    """Byte table + projection for the flagship bench config."""
    from coala_gnn.parallel import comm_model as cm
    from coala_gnn.sampling.neighbor import block_capacities

    B, fanouts, dim = 1024, [10, 5], 256
    caps = block_capacities(B, fanouts)
    n_req = caps[0][1]
    # SAGE 2-layer param bytes at hidden 256: W1 [2*256,256]+W2 [2*256,256]
    # + head — measure exactly would need the model; the dominant term:
    param_bytes = (2 * dim * 256 + 2 * 256 * 256 + 256 * 16) * 4

    out = {"config": {"batch": B, "fanout": fanouts, "dim": dim,
                      "n_req_per_device": int(n_req),
                      "param_bytes": int(param_bytes)},
           "topologies": {}, "efficiency_1_to_2_hosts": {}}
    for (n_dev, local) in ((4, 4), (8, 4), (16, 4)):
        hosts = n_dev // local
        rows = {}
        # representative miss step: 5% of request slots miss (fill buckets
        # size from the pow2 miss count, NOT n_req — warm steps ship zero)
        miss_rep = max(int(0.05 * n_req), 1)
        for mode in ("sharded", "node_local", "isolated"):
            t = cm.step_traffic(mode, n_req=n_req, n_dev=n_dev, local=local,
                                dim=dim, num_colors=2000,
                                param_bytes=param_bytes, misses=miss_rep)
            ts = cm.step_time(step_ms / 1e3, t, dcn_gbps, ici_gbps)
            rows[mode] = {
                "exchange_off_device_bytes": t["exchange"]["off_device"],
                "exchange_cross_host_bytes": t["exchange"]["cross_host"],
                "grad_psum_bytes": t["grad_psum"],
                "meta_cross_host_bytes_per_step_per_device":
                    round(t["meta_per_step"], 1),
                "fill_bytes_at_5pct_miss_step": t["fill_miss_step"],
                "cross_host_total_bytes": int(t["cross_host_total"]),
                "serialized_step": {k: round(v, 6) for k, v in ts.items()},
            }
        out["topologies"][f"{hosts}hosts_x_{local}dev"] = rows
    # the BASELINE.md >80% metric: per-device throughput 2 hosts vs 1 host
    # (weak scaling; 1 host already pays the full intra-host exchange)
    for mode in ("sharded", "node_local", "isolated"):
        for tag, i8 in (("f32_response", False), ("int8_response", True)):
            e = cm.efficiency_1_to_2_hosts(
                mode, step_ms / 1e3, n_req=n_req, local=4, dim=dim,
                dcn_gbps=dcn_gbps, ici_gbps=ici_gbps, num_colors=2000,
                param_bytes=param_bytes, int8_response=i8)
            out["efficiency_1_to_2_hosts"][f"{mode}_{tag}"] = {
                "efficiency": round(e["efficiency"], 4),
                "t_1host_ms": round(e["t_1host"]["t_step_s"] * 1e3, 3),
                "t_2hosts_ms": round(e["t_2hosts"]["t_step_s"] * 1e3, 3),
            }
    return out


def node_local_ab(seed=3, iters=40, refresh=8, cache_mb=1):
    """Measured on the 8-virtual-device mesh as 4 emulated hosts of 2:
    node_local caches + {baseline, node_color} seed distribution. Returns
    aggregate hit ratios; cross-host feature bytes are ZERO by construction
    in this mode (test_sharded_cache.py::test_node_local_scopes_residency
    proves the scoping; here we show the hit ratio HOLDS — and affinity
    steering still wins — when groups can't see each other's caches.

    Regime notes (both must hold or the A/B degenerates): per-group
    capacity well under the node count (else no pressure), and per-group
    request volume per iter well under capacity (else total turnover every
    step and nothing persists for affinity to exploit)."""
    from coala_gnn.cache import feature_cache as fc
    from coala_gnn.cache.host_tier import HostFeatureStore
    from coala_gnn.coloring import generate_color_metadata
    from coala_gnn.distribution import SeedDistributor
    from coala_gnn.graph.datasets import clustered_graph
    from coala_gnn.parallel.mesh import make_mesh
    from coala_gnn.parallel.sharded_cache import ShardedFeatureCache
    from coala_gnn.sampling.neighbor import NeighborSampler

    mesh = make_mesh()
    n_dev = mesh.devices.size
    if n_dev < 4:
        raise SystemExit("node_local_ab needs >= 4 devices; run with "
                         "COALA_CPU_DEVICES=8 --platform cpu")
    L = 2
    P = n_dev // L
    ds = clustered_graph(num_nodes=8000, num_communities=32, avg_degree=8,
                         p_intra=0.95, feature_dim=32, seed=seed)
    meta = generate_color_metadata(ds.graph, ds.train_idx, seed=seed)
    store = HostFeatureStore(ds.features)
    B = 32
    fanouts = [4, 4]
    sampler_by_dev = [NeighborSampler(ds.graph, fanouts, B, seed=seed + d)
                      for d in range(n_dev)]
    results = {}
    for mode in ("baseline", "node_color"):
        cfg = fc.make_config(cache_mb=cache_mb, dim=32,
                             num_colors=meta.num_colors, num_shards=L)
        cache = ShardedFeatureCache(cfg=cfg, mesh=mesh, mode="node_local",
                                    group_size=L)
        dist = SeedDistributor(ds.train_idx, batch_size=B, local_size=L,
                               num_parts=P, mode=mode,
                               color=meta.color, topk_colors=meta.topk,
                               affinity=meta.score, shuffle_seed=seed)
        cmeta = np.zeros((P, meta.num_colors + 1), np.int32)
        n_iters = min(iters, dist.num_iters)
        for it in range(n_iters):
            if it % refresh == 0:
                # per-GROUP color counters steer the distributor — the
                # cross-host allgather is (C+1)*4 bytes, the only DCN state
                cc = cache._read_local(cache.state.color_counts)
                cmeta = cc.reshape(P, L, -1).sum(axis=1).astype(np.int32)
            domains = dist.distribute(it, cmeta if mode == "node_color"
                                      else None)
            ids = np.zeros((n_dev, sampler_by_dev[0].caps[0][1]), np.int32)
            nv = np.zeros(n_dev, np.int32)
            for g in range(P):
                for j in range(L):
                    d = g * L + j
                    b = sampler_by_dev[d].sample(
                        dist.device_slice(domains[g], j))
                    ids[d, : len(b.input_ids)] = b.input_ids
                    nv[d] = b.num_input
            cache.fetch(ids, nv, store.fetch, colors=meta.color)
        s = cache.stats()
        results[mode] = {"hit_ratio": round(s["hit_ratio"], 4),
                         "iters": n_iters}
    results["config"] = {"nodes": 8000, "communities": 32, "groups": P,
                         "group_size": L, "group_capacity_lines":
                         cfg.capacity * L, "batch_per_device": B}
    results["hit_ratio_gain"] = round(
        results["node_color"]["hit_ratio"]
        - results["baseline"]["hit_ratio"], 4)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="gpu")
    p.add_argument("--step_ms", type=float, required=True,
                   help="measured single-chip flagship step time (from "
                        "bench.py: edges/step / edges/s)")
    p.add_argument("--dcn_gbps", type=float, required=True,
                   help="per-host cross-host network bandwidth GB/s")
    p.add_argument("--ici_gbps", type=float, required=True,
                   help="per-device intra-host link bandwidth GB/s")
    p.add_argument("--reconcile", default="",
                   help="path to examples/comm_reconcile.py output; embeds "
                        "the model-vs-compiled-HLO byte columns so the "
                        "byte model in this artifact is falsifiable")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from coala_gnn.utils.jaxconfig import setup
    setup(args.platform)

    art = {
        "method": "exact shape-determined wire bytes (comm_model, "
                  "reconciled 1:1 against compiled-HLO collective bytes — "
                  "see hlo_reconciliation) + virtual-mesh node_local "
                  "affinity A/B + projection; replaces the r3 "
                  "virtual-device wall-clock emulation",
        "link_params": {"dcn_gbps": args.dcn_gbps, "ici_gbps": args.ici_gbps,
                        "step_ms_measured_single_chip": args.step_ms},
        "bytes": flagship_bytes(args.step_ms, args.dcn_gbps, args.ici_gbps),
        "node_local_affinity_ab_virtual_mesh": node_local_ab(),
        "target": {"scaling_efficiency_1_to_2_hosts": ">0.80 (BASELINE.md)"},
    }
    if args.reconcile:
        with open(args.reconcile) as f:
            art["hlo_reconciliation"] = json.load(f)
    txt = json.dumps(art, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    return art


if __name__ == "__main__":
    main()
