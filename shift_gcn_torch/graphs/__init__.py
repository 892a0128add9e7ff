from shift_gcn_torch.graphs.topology import (  # noqa: F401
    MEDIAPIPE_POSE,
    NTU120_RGB_D,
    NTU_RGB_D,
    SkeletonGraph,
    edge_matrix,
    get_graph,
    normalize_columns,
    register_graph,
    spatial_adjacency,
)
