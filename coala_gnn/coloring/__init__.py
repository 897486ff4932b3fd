from coala_gnn.coloring.coloring import (
    ColorMetadata,
    color_graph,
    color_affinity,
    generate_color_metadata,
    save_color_metadata,
    load_color_metadata,
    GLOBAL_MAX_HOP,
    GLOBAL_SAMPLING_RATE,
    DEFAULT_TOPK,
)

__all__ = [
    "ColorMetadata",
    "color_graph",
    "color_affinity",
    "generate_color_metadata",
    "save_color_metadata",
    "load_color_metadata",
    "GLOBAL_MAX_HOP",
    "GLOBAL_SAMPLING_RATE",
    "DEFAULT_TOPK",
]
