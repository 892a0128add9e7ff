from shift_gcn_torch.graphs.topology import (  # noqa: F401
    MEDIAPIPE_POSE,
    NTU120_RGB_D,
    NTU_RGB_D,
    SkeletonGraph,
    get_graph,
)
