from coala_gnn.models.layers import DeviceBlock, SAGEConv, GraphConv, GATConv, blocks_to_device
from coala_gnn.models.gnn import SAGE, GCN, GAT, make_model

__all__ = [
    "DeviceBlock",
    "SAGEConv",
    "GraphConv",
    "GATConv",
    "blocks_to_device",
    "SAGE",
    "GCN",
    "GAT",
    "make_model",
]
