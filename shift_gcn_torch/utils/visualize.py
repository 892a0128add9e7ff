"""Visual inspection helpers (matplotlib-gated).

A copy of the reference package's ``utils/visualize.py`` over this
package's graphs: the reference's eyeball tools, skeleton sequence
animation (feeders/feeder.py:106-185) and adjacency heatmaps
(graph/ntu_rgb_d.py:36-45).  Matplotlib imports lazily so headless
training hosts don't need it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from shift_gcn_torch.graphs import SkeletonGraph, get_graph


def plot_adjacency(graph_name: str, save_path: Optional[str] = None):
    """Render the three adjacency subsets (I / inward / outward)."""
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    graph = get_graph(graph_name)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, mat, title in zip(axes, graph.A, ("I", "inward", "outward")):
        ax.imshow(mat, cmap="gray")
        ax.set_title(f"{graph.name}: {title}")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    plt.show()
    return None


def animate_skeleton(
    clip: np.ndarray,
    graph: "SkeletonGraph | str",
    save_path: Optional[str] = None,
    fps: int = 25,
):
    """Animate one (C, T, V, M) clip as a 2D stick figure.

    ``graph``: a SkeletonGraph or a registry name.  With save_path,
    writes an mp4/gif (matplotlib.animation); otherwise opens an
    interactive window.
    """
    if isinstance(graph, str):
        graph = get_graph(graph)
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    c, t, v, m = clip.shape
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.axis([-1, 1, -1, 1])
    lines = []
    for person in range(m):
        lines.append([ax.plot([], [], "-")[0] for _ in graph.inward])

    def update(frame):
        for person in range(m):
            for line, (a, b) in zip(lines[person], graph.inward):
                xa, ya = clip[0, frame, a, person], clip[1, frame, a, person]
                xb, yb = clip[0, frame, b, person], clip[1, frame, b, person]
                if (abs(xa) + abs(ya) > 0) or (abs(xb) + abs(yb) > 0):
                    line.set_data([xa, xb], [ya, yb])
                else:
                    line.set_data([], [])
        return [l for group in lines for l in group]

    anim = animation.FuncAnimation(
        fig, update, frames=t, interval=1000 / fps, blit=True)
    if save_path:
        anim.save(save_path, fps=fps)
        plt.close(fig)
        return save_path
    plt.show()
    return None
