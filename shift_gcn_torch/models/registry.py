"""Model-family registry: the config's ``model`` string -> a family.

A port of the reference package's ``models/registry.py``.  Each family
gives ``build_config(model_args)`` and ``build(config, device)``, a
module with ``init_weights(generator)`` whose ``forward`` maps (N, C, T,
V, M) clips to logits.  ``skeleton`` says whether its config names a
skeleton graph, which four-stream training needs to derive the bone
streams (the reference's ``fourstream.graph_for_config``), and
``edge_strategies`` the edge-partition strategies its model takes
(``parallel/edge_partition.py``: ST-GCN's edge path ``gather``, the
ring-GNN's node shards ``ring``; the reference's test for an ``edges``
or ``ring_steps`` parameter of its apply).  The names the
reference resolves (its family names, its aliases and its module paths)
resolve here to the same families, beside this package's module paths,
so its YAML configs train here unchanged.  ``agcn2s`` (2s-AGCN's joint
stream, ``models/agcn.py``) is the port's own family, with no counterpart
in the reference package; 2s-AGCN's ``model.agcn.Model`` names it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

from torch import nn

from shift_gcn_torch.models import agcn, ring_gnn, shift_gcn, stgcn


class ModelFamily(NamedTuple):
    name: str
    build_config: Callable[[Dict[str, Any]], Any]
    build: Callable[..., nn.Module]
    skeleton: bool
    edge_strategies: Tuple[str, ...] = ()


_REGISTRY: Dict[str, ModelFamily] = {}


def register_model(family: ModelFamily) -> None:
    _REGISTRY[family.name] = family


register_model(ModelFamily(
    name="shift_gcn",
    build_config=shift_gcn.config_from_reference_args,
    build=shift_gcn.Model,
    skeleton=True,
))
register_model(ModelFamily(
    name="stgcn",
    build_config=stgcn.config_from_args,
    build=stgcn.Model,
    skeleton=True,
    edge_strategies=("gather",),
))
register_model(ModelFamily(
    name="agcn2s",
    build_config=agcn.config_from_args,
    build=agcn.Model,
    skeleton=True,
))
register_model(ModelFamily(
    name="ring_gnn",
    build_config=ring_gnn.config_from_args,
    build=ring_gnn.Model,
    skeleton=False,
    edge_strategies=("ring",),
))

# the reference torch repo's model path and the reference's short alias
# (``agcn`` names ST-GCN, as in the reference package); 2s-AGCN's own
# repository's path and this package's module of it; a module path
# <package>.models.<family> (the reference package's, as its YAML
# configs name them, or this package's) names <family>
_ALIASES = {
    "model.shift_gcn.Model": "shift_gcn",
    "agcn": "stgcn",
    "model.agcn.Model": "agcn2s",
    "shift_gcn_torch.models.agcn": "agcn2s",
}


def get_model(name: str) -> ModelFamily:
    key = _ALIASES.get(name, name)
    parts = key.split(".")
    if len(parts) >= 3 and parts[-2] == "models":
        key = parts[-1]
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown model family {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
