"""Per-step roofline accounting for the resident training pipeline.

Ties a measured edges/s number to the hardware limit it is judged against
(BASELINE.md "SpMM/SDDMM at speed-of-light per chip"). The model derives,
from shapes alone, the step's unavoidable work in three resource classes
and divides by the device's peak for each class:

  rand   — random row-gather bytes (cache lookup serving the frontier):
           frontier x cache-line bytes.
  stream — streaming aggregation + activation bytes (lower-bound traffic:
           each src row read once, each dst row written once per layer).
  mm     — model matmul FLOPs (fwd + dgrad + wgrad = 3x fwd).

The bound assumes PERFECT overlap of the classes (roofline semantics):
t_bound = max_class(work / peak). Sampling PRNG compute is intentionally
not a class — it is not a hardware-resource lower bound (any sampler is
free to spend fewer FLOPs) — so the bound is optimistic; the per-class
milliseconds let the gap be itemized.

Peaks are the published ones, keyed by ``jax.Device.device_kind``
(``PEAKS``). Both byte classes are judged against the memory bandwidth; a
random row gather reaches less of it than a stream, which the measured
share shows. A device missing from the table is an error, not a default.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from coala_gnn.sampling.neighbor import block_capacities

# NVIDIA H100 SXM data sheet: dense rates (no sparsity) at the 700 W power
# limit; a card set to a lower limit cannot hold these under load.
_H100_SXM = {"hbm_gbps": 3350.0, "bf16_tflops": 989.0, "tf32_tflops": 495.0,
             "f32_tflops": 67.0,
             "source": "NVIDIA H100 SXM data sheet (dense, 700 W)"}

PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM}


def published_peaks(device_kind: str, model_bytes: int = 4) -> dict:
    """``bound``'s peak dict for a device kind and model element width.

    Float32 models run their matmuls at JAX's default precision, which on
    this card is TF32 (tensor cores); bfloat16 models at the bf16 rate.
    Raises KeyError for a device not in ``PEAKS``."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add them to roofline.PEAKS")
    pk = PEAKS[device_kind]
    return {"rand_gbps": pk["hbm_gbps"], "stream_gbps": pk["hbm_gbps"],
            "mm_tflops": pk["bf16_tflops"] if model_bytes == 2
            else pk["tf32_tflops"],
            "source": pk["source"]}


def layer_dims(dim: int, hidden: int, num_classes: int,
               num_layers: int) -> List[tuple]:
    """[(d_in, d_out)] per layer, input-most first (models/gnn.py stacks
    hidden for all but the last layer, which maps to num_classes)."""
    dims = []
    d_in = dim
    for layer in range(num_layers):
        d_out = num_classes if layer == num_layers - 1 else hidden
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def step_cost(batch: int, fanouts: Sequence[int], dim: int, hidden: int,
              num_classes: int, *, model: str = "sage", heads: int = 4,
              line_bytes: int = 4, model_bytes: int = 4,
              nbr_cap: Optional[int] = None) -> dict:
    """Model-derived per-training-step work.

    line_bytes: cache-line element width (4 f32, 2 bf16, 1 int8).
    model_bytes: activation/matmul element width (4 f32, 2 bf16).
    GAT (reference parity, examples/models.py:126-178): ``hidden`` is
    PER-HEAD width, heads flatten between layers — so hidden layers are
    heads x wider than SAGE's at the same flag, and the fc applies to ALL
    src rows.
    Returns {"rand_bytes", "stream_bytes", "flops"} — see module docstring
    for what each class contains.
    """
    caps = block_capacities(batch, list(fanouts))
    n_frontier = caps[0][1]
    num_layers = len(fanouts)

    # cache lookup: one random row per frontier id (flat tier = exactly one
    # gather; the associative tier's tag probe adds ~8B/id, ignored)
    rand = n_frontier * dim * line_bytes
    # topology reads: CSR = 8B indptr pair + 4B per sampled index, random;
    # padded table = one aligned nbr_cap x 4B row per dst (streaming-ish,
    # still counted rand — it is gather-addressed)
    for (cap_dst, _), f in zip(caps, fanouts):
        rand += cap_dst * (nbr_cap * 4 if nbr_cap else 8 + f * 4)

    if model == "gat":
        dims, d_in = [], dim
        for layer in range(num_layers):
            last = layer == num_layers - 1
            d_out = heads * (num_classes if last else hidden)
            dims.append((d_in, d_out))
            d_in = d_out   # heads flatten between layers
    else:
        dims = layer_dims(dim, hidden, num_classes, num_layers)
    stream = 0
    flops = 0
    for (cap_dst, cap_src), (d_in, d_out), f in zip(caps, dims, fanouts):
        if model == "gat":
            # fc over ALL src rows (h_dst prefix contract) + attn einsums
            flops += 2 * cap_src * d_in * d_out + 4 * cap_src * d_out
            # fc activations + the weighted combine streaming each post-fc
            # src row once at width d_out, dst written once
            stream += (cap_src * d_in + cap_src * d_out
                       + cap_dst * d_out) * model_bytes
        else:
            # SAGE: fc_self + fc_neigh on cap_dst (GCN: one fc — close
            # enough at this granularity; it shares the sage entry).
            # Aggregation lower bound: each src row read once, dst written.
            flops += 2 * 2 * cap_dst * d_in * d_out
            stream += (cap_src * d_in + cap_dst * d_out) * model_bytes
    # train multipliers. FLOPs: fwd + dgrad + wgrad each pay the full
    # matmul (exact). Stream: 2x is the LOWER bound — fwd touches each
    # activation row once, bwd must re-read it (or its recompute) and
    # write its grad; XLA fusion cannot go below that, but it routinely
    # beats a 3x accounting by never materializing fused intermediates,
    # which would push a "bound" past 100% of measured.
    flops *= 3
    stream *= 2

    return {"rand_bytes": int(rand), "stream_bytes": int(stream),
            "flops": int(flops)}


def bound(cost: dict, peaks: dict) -> dict:
    """Roofline bound for a step cost against device peaks.

    peaks: {"rand_gbps", "stream_gbps", "mm_tflops"} (``published_peaks``
    picks the rates matching the config's dtypes).
    Returns per-class ms, the binding class, t_bound ms.
    """
    t_rand = cost["rand_bytes"] / (peaks["rand_gbps"] * 1e9) * 1e3
    t_stream = cost["stream_bytes"] / (peaks["stream_gbps"] * 1e9) * 1e3
    t_mm = cost["flops"] / (peaks["mm_tflops"] * 1e12) * 1e3
    comp = {"rand_ms": t_rand, "stream_ms": t_stream, "mm_ms": t_mm}
    binding = max(comp, key=comp.get)
    return {"components_ms": {k: round(v, 4) for k, v in comp.items()},
            "binding": binding.replace("_ms", ""),
            "t_bound_ms": round(comp[binding], 4)}


def report(cost: dict, peaks: dict, ms_step: float) -> dict:
    """Full roofline row: bound + measured + fraction-of-roofline."""
    b = bound(cost, peaks)
    b["ms_step_measured"] = round(ms_step, 4)
    b["roofline_pct"] = round(100.0 * b["t_bound_ms"] / ms_step, 1) \
        if ms_step > 0 else None
    b["peaks"] = peaks
    return b
