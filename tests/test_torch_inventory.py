"""Every public name of the reference package (``shift_gcn_tpu/``) has its
counterpart in the port (``shift_gcn_torch/``), or is a listed exception.

Both packages are parsed with ``ast``; neither is imported.  A public name
is a top-level function or class whose name does not start with an
underscore, or a public method of such a class (``__init__`` included),
keyed ``<module path>::<name>`` (``<Class>.<method>`` for a method).  It
has a counterpart when the port defines the same name in the module at
the same path, or else in any of its modules.  For every function with a
counterpart, each keyword parameter of the reference's function must be a
parameter of the port's (the one at the same path, else any of the same
name); a ``**kwargs`` of the port's accepts none here.

``EXCEPTIONS`` is the list of deliberate API differences: each entry maps
a name (``<module>::<name>``) or a keyword (``<module>::<func>(<param>)``)
to the port's counterpart, or to the reason none exists.  Most are the
reference package's JAX idiom: functional parameters and pytrees where the
port has ``nn.Module``s, shardings where it has process groups, the XLA
formulations the port records as knobs (``ops/lowering.py``) and the Pallas
wrappers its CUDA kernels replace.  An entry that the reference package no
longer has, or that the port now defines, fails as stale.
"""

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "shift_gcn_tpu"
PORT = ROOT / "shift_gcn_torch"

_MODEL_API = ("the weights live in the module's parameters and buffers, "
              "not in a pytree")

EXCEPTIONS = {
    # the functional model API: the port's models are nn.Modules
    "models/shift_gcn.py::init_params":
        "Model(config).init_weights(generator) (models/shift_gcn.py): "
        + _MODEL_API,
    "models/shift_gcn.py::apply":
        "Model.forward (models/shift_gcn.py); train or eval by "
        "Model.train() / Model.eval()",
    "models/shift_gcn.py::make_model":
        "Model(config) (models/shift_gcn.py) is the (init, apply) pair",
    "models/shift_gcn.py::param_count":
        "sum(p.numel() for p in model.parameters()), torch's idiom",
    "models/stgcn.py::init_params":
        "Model(config).init_weights(generator) (models/stgcn.py): "
        + _MODEL_API,
    "models/stgcn.py::apply":
        "Model.forward (models/stgcn.py); the edge partition's path by "
        "parallel/edge_partition.attach",
    "models/stgcn.py::param_count":
        "sum(p.numel() for p in model.parameters()), torch's idiom",
    "models/ring_gnn.py::init_params":
        "Model(config).init_weights(generator) (models/ring_gnn.py): "
        + _MODEL_API,
    "models/ring_gnn.py::apply":
        "Model.forward (models/ring_gnn.py); the ring path's node shards "
        "by parallel/edge_partition.attach",
    "models/ring_gnn.py::param_count":
        "sum(p.numel() for p in model.parameters()), torch's idiom",
    # optimizer and train state pytrees
    "train/optim.py::SGDState":
        "torch.optim.SGD's momentum buffers (optimizer.state[p])",
    "train/optim.py::init_sgd":
        "build_optimizer (train/optim.py): torch.optim.SGD, nesterov, "
        "momentum 0.9",
    "train/optim.py::sgd_update":
        "optimizer.step() of build_optimizer's torch.optim.SGD",
    "train/optim.py::weight_decay_for_path":
        "weight_decay_for_name (train/optim.py), keyed by state_dict name",
    "train/optim.py::build_weight_decay_tree":
        "build_param_groups (train/optim.py): one SGD parameter group per "
        "decay",
    "train/state.py::TrainState":
        "the model, its optimizer and the Trainer's counters "
        "(train/trainer.py)",
    "train/state.py::create_train_state":
        "Model(config).init_weights(generator) and build_optimizer",
    "train/state.py::make_train_step":
        "train_step (train/state.py), an eager step: nothing to build",
    "train/state.py::make_eval_step":
        "eval_step (train/state.py), an eager step: nothing to build",
    "train/transfer.py::restore_batch_fp32":
        "BatchTransfer.receive (train/trainer.py) casts the data back to "
        "fp32 on the device",
    # shardings and sharded-step factories: process groups in the port
    "parallel/mesh.py::batch_sharding":
        "Mesh.batch_rows / Mesh.local (parallel/mesh.py): each rank keeps "
        "its rows of the host batch",
    "parallel/mesh.py::param_spec":
        "parallel/tensor.py's sharded_axis cuts each rank's slice of "
        "Linear_weight and temporal_linear",
    "parallel/mesh.py::replicated":
        "a tensor on a rank's own device is replicated by construction",
    "parallel/mesh.py::shard_batch":
        "Mesh.local (parallel/mesh.py) and BatchTransfer.stage "
        "(train/trainer.py): each rank moves its own shard",
    "parallel/mesh.py::state_shardings":
        "parallel/tensor.py local_state_dict: each rank holds its slices",
    "parallel/seqpar.py::make_time_sharded_train_step":
        "seqpar.attach then seqpar.train_step (parallel/seqpar.py)",
    "parallel/seqpar.py::make_time_sharded_eval_step":
        "seqpar.attach then seqpar.eval_step (parallel/seqpar.py)",
    "parallel/edge_partition.py::make_edge_sharded_apply":
        "edge_partition.attach then Model.forward "
        "(parallel/edge_partition.py)",
    "parallel/edge_partition.py::make_edge_sharded_train_step":
        "edge_partition.attach then edge_partition.train_step",
    "parallel/edge_partition.py::make_edge_sharded_eval_step":
        "edge_partition.attach then edge_partition.eval_step",
    "parallel/edge_partition.py::make_ring_sharded_apply":
        "edge_partition.attach with the ring strategy, then Model.forward",
    "parallel/halo.py::sharded_temporal_shift_train":
        "sharded_temporal_shift (parallel/halo.py): its autograd Function "
        "carries the constraint backward in training",
    "train/fourstream.py::create_fourstream_state":
        "create_models (train/fourstream.py): four modules, not one "
        "stacked pytree",
    "train/fourstream.py::make_fourstream_train_step":
        "train_step (train/fourstream.py), an eager step",
    "train/fourstream.py::make_fourstream_eval_step":
        "eval_step (train/fourstream.py), an eager step",
    "train/fourstream.py::stack_streams":
        "the four streams stay four modules; the checkpoint keeps them "
        "by name (utils/checkpoint.py save_fourstream_checkpoint)",
    "train/fourstream.py::unstack_stream":
        "the four streams stay four modules "
        "(utils/checkpoint.py load_fourstream_checkpoint)",
    "train/fourstream.py::graph_for_config":
        "get_graph(config.graph) (graphs/topology.py), which the Trainer "
        "calls for the bone parents",
    # XLA formulations, recorded as knobs of ops/lowering.py
    "ops/spatial_shift.py::spatial_shift_roll":
        "an XLA formulation of spatial_shift; the port has one gather "
        "(ops/spatial_shift.py) and K4/K5/K6 fuse the shifts",
    "ops/spatial_shift.py::spatial_shift_onehot":
        "an XLA formulation of spatial_shift; the port has one gather "
        "(ops/spatial_shift.py) and K4/K5/K6 fuse the shifts",
    "ops/spatial_shift.py::shift_gcn_transform_circconv":
        "an XLA formulation (sgcn_impl knob, ops/lowering.py) that the "
        "fused_shift_gcn kernel replaces",
    "ops/spatial_shift.py::shift_gcn_transform_dft":
        "an XLA formulation (sgcn_impl knob, ops/lowering.py) that the "
        "fused_shift_gcn kernel replaces",
    "ops/temporal_shift.py::temporal_shift_linear":
        "an XLA formulation (tshift_impl knob, ops/lowering.py): K1 then "
        "the 1x1 conv in the port",
    "ops/temporal_shift.py::temporal_shift_linear_dft":
        "an XLA formulation (tshift_impl knob, ops/lowering.py): K1 then "
        "the 1x1 conv in the port",
    "ops/temporal_shift.py::bn_shift_linear":
        "an XLA formulation (BN folded into the shift's matmul); the "
        "port runs BatchNorm, K1 and the 1x1 conv",
    "ops/temporal_shift.py::get_impl":
        "the temporal-shift lowering selector; the port has one path, "
        "the K1/K2+K3 kernels (ops/temporal_shift.py)",
    "ops/temporal_shift.py::temporal_shift_inference":
        "temporal_shift (ops/temporal_shift.py) under torch.no_grad(): "
        "the same forward kernel",
    "ops/batchnorm.py::bn_affine_coeffs":
        "the lp branch of the port's BN normalize pass (ops/batchnorm.py "
        "_normalize), x * a + b with a and b in fp32",
    "ops/batchnorm.py::init_bn":
        "BatchNorm(num_features) (ops/batchnorm.py); bn_init's scale in "
        "Model.init_weights",
    # the Pallas wrappers, replaced by csrc/
    "ops/pallas/shift_gcn_kernel.py::pick_row_block":
        "the Pallas row tile; the CUDA kernels choose their tiles "
        "(csrc/shift_gcn.cu, ops/shift_gcn_kernel.py)",
    "ops/pallas/temporal_shift_kernel.py::temporal_shift_pallas":
        "temporal_shift_forward (ops/temporal_shift.py), K1 of "
        "csrc/temporal_shift.cu",
    # Orbax and pytree checkpoints, which the port does not read
    "utils/checkpoint.py::restore_checkpoint":
        "the port reads reference .pt checkpoints "
        "(load_reference_checkpoint), not the Orbax directories",
    "utils/checkpoint.py::export_reference_checkpoint":
        "the port writes the reference .pt format natively "
        "(save_checkpoint / write_checkpoint)",
    "utils/checkpoint.py::pytrees_to_torch_state_dict":
        "the port's weights are a state_dict already; state_dict_from_"
        "arrays builds one from numpy arrays",
    "utils/checkpoint.py::torch_state_dict_to_pytrees":
        "the port's models load a state_dict as it is "
        "(load_state_dict(strict=True))",
    # keywords
    "ops/batchnorm.py::batch_norm(params)":
        "the port's batch_norm takes weight and bias as tensors",
    "ops/batchnorm.py::batch_norm(state)":
        "the port's batch_norm takes running_mean and running_var as "
        "tensors",
    "ops/batchnorm.py::batch_norm(reduce_axes)":
        "feature_dims: the port names the trailing feature axes",
    "ops/batchnorm.py::batch_norm(training)":
        "batch_norm_train (ops/batchnorm.py); BatchNorm.forward picks "
        "by module.training",
    "ops/batchnorm.py::batch_norm(momentum)":
        "batch_norm_train(momentum=) (ops/batchnorm.py)",
    "ops/batchnorm.py::batch_norm(axis_name)":
        "batch_norm_train(group=): sync BN over a process group",
    "ops/conv.py::temporal_conv(compute_dtype)":
        "the reference ignores it in this conv; the port's conv has none",
    "ops/spatial_shift.py::spatial_shift(impl)":
        "the XLA formulation; the port has one gather",
    "ops/spatial_shift.py::shift_gcn_transform(feature_mask)":
        "gate = tanh(Feature_Mask) + 1, which the caller computes once "
        "(models/shift_gcn.py ShiftGCN)",
    "ops/spatial_shift.py::shift_gcn_transform(compute_dtype)":
        "the fused kernel ignores compute_dtype, as the reference's "
        "Pallas path does; the plain version computes in fp32",
    "ops/spatial_shift.py::shift_gcn_transform(impl)":
        "the XLA formulation (sgcn_impl knob, ops/lowering.py)",
    "ops/spatial_shift.py::shift_gcn_transform(sshift_impl)":
        "the XLA formulation of the two shifts (sshift_impl knob)",
    "ops/temporal_shift.py::temporal_shift(low)":
        "the Lowering picks an XLA formulation; its one numeric knob "
        "reaches the kernel as exact_xpos",
    "ops/pallas/shift_gcn_kernel.py::fused_shift_gcn(row_block)":
        "the Pallas row tile; the CUDA kernel chooses its tile",
    "inference/export.py::export_eval(params)":
        "state_dict: the port exports a state_dict's weights",
    "inference/export.py::export_eval(bn_state)":
        "state_dict holds the BN buffers too",
    "inference/export.py::export_eval_baked(params)":
        "state_dict: the port exports a state_dict's weights",
    "inference/export.py::export_eval_baked(bn_state)":
        "state_dict holds the BN buffers too",
    "inference/export.py::load_exported(blob)":
        "source: a .pt2 path or its bytes",
    "parallel/edge_partition.py::edge_partitioned_aggregate(axis_name)":
        "group: the model ranks' process group",
    "parallel/edge_partition.py::make_sharded_aggregator(axis_name)":
        "the mesh's model group (Mesh.model_group) carries the edges",
    "parallel/edge_partition.py::ring_aggregate(axis_name)":
        "group: the model ranks' process group",
    "parallel/halo.py::halo_exchange(halo_lo)":
        "lo, with mesh in place of axis_name",
    "parallel/halo.py::halo_exchange(halo_hi)":
        "hi, with mesh in place of axis_name",
    "parallel/halo.py::halo_exchange(axis_name)":
        "mesh: the time ranks' process group (Mesh.time_group)",
    "parallel/halo.py::sharded_temporal_shift(axis_name)":
        "mesh: the time ranks' process group (Mesh.time_group)",
    "parallel/mesh.py::make_mesh(devices)":
        "one device per rank, the process group's world "
        "(parallel/launch.py picks LOCAL_RANK's card)",
    "utils/checkpoint.py::latest_checkpoint(directory)":
        "save_dir: the reference's .pt save directory, not an Orbax one",
    "utils/checkpoint.py::save_checkpoint(directory)":
        "save_dir: the reference's .pt save directory, not an Orbax one",
    "utils/checkpoint.py::save_checkpoint(step)":
        "epoch and global_step of the reference's .pt checkpoint",
    "utils/checkpoint.py::save_checkpoint(payload)":
        "model and optimizer: the port saves their state_dicts",
}


def _modules(package: Path):
    """Relative path -> parsed module, for every .py of ``package``
    outside directories named with a leading underscore or dot."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package)
        if any(part.startswith(("_", ".")) for part in rel.parts[:-1]):
            continue
        out[rel.as_posix()] = ast.parse(path.read_text(), str(path))
    return out


def _public(tree: ast.Module):
    """(name, node) of every public function, class and method."""
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, funcs) and not node.name.startswith("_"):
            yield node.name, node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            yield node.name, node
            for sub in node.body:
                if isinstance(sub, funcs) and (
                        not sub.name.startswith("_")
                        or sub.name == "__init__"):
                    yield f"{node.name}.{sub.name}", sub


@functools.lru_cache(maxsize=None)
def _inventory(package: Path):
    """{(module, name): node} and {name: [node, ...]} of ``package``."""
    defs, by_name = {}, {}
    for rel, tree in _modules(package).items():
        for name, node in _public(tree):
            defs[(rel, name)] = node
            by_name.setdefault(name, []).append(node)
    return defs, by_name


def _keywords(node) -> list:
    """The parameters that a caller can pass by keyword."""
    args = node.args
    return [a.arg for a in args.args + args.kwonlyargs
            if a.arg not in ("self", "cls")]


def _counterparts(rel: str, name: str) -> list:
    port, port_by_name = _inventory(PORT)
    if (rel, name) in port:
        return [port[(rel, name)]]
    return port_by_name.get(name, [])


def _reference_modules():
    return sorted({rel for rel, _ in _inventory(REFERENCE)[0]})


def _gaps(rel: str):
    """The reference module's names without a counterpart, and the
    keywords of its functions that their counterparts lack."""
    reference, _ = _inventory(REFERENCE)
    names, keywords = [], []
    for (module, name), node in sorted(reference.items(),
                                       key=lambda kv: kv[0]):
        if module != rel:
            continue
        found = _counterparts(rel, name)
        if not found:
            names.append(f"{rel}::{name}")
            continue
        if isinstance(node, ast.ClassDef):
            continue
        accepted = set().union(*(_keywords(f) for f in found))
        keywords += [f"{rel}::{name}({p})" for p in _keywords(node)
                     if p not in accepted]
    return names, keywords


def test_the_packages_parse():
    """The walk finds both packages' modules, and the reference package's
    public surface is not empty."""
    assert len(_modules(REFERENCE)) > 40
    assert len(_modules(PORT)) > 40
    assert len(_inventory(REFERENCE)[0]) > 200
    assert "data/augmentations.py" in _reference_modules()


@pytest.mark.parametrize("rel", _reference_modules())
def test_every_public_name_has_a_counterpart(rel):
    names, _ = _gaps(rel)
    missing = [n for n in names if n not in EXCEPTIONS]
    assert not missing, (
        f"public names of shift_gcn_tpu/{rel} with no counterpart in "
        f"shift_gcn_torch/ and no entry in EXCEPTIONS: {missing}")


@pytest.mark.parametrize("rel", _reference_modules())
def test_every_keyword_has_a_counterpart(rel):
    _, keywords = _gaps(rel)
    missing = [k for k in keywords if k not in EXCEPTIONS]
    assert not missing, (
        f"keywords of shift_gcn_tpu/{rel} that the port's functions lack, "
        f"with no entry in EXCEPTIONS: {missing}")


def test_no_exception_is_stale():
    """Every entry is still a gap: the reference package has the name
    (or the function and its keyword), and the port lacks it."""
    gaps = set()
    for rel in _reference_modules():
        names, keywords = _gaps(rel)
        gaps.update(names, keywords)
    stale = sorted(set(EXCEPTIONS) - gaps)
    assert not stale, (
        f"EXCEPTIONS entries that are no longer gaps (the reference "
        f"package lacks them, or the port now defines them): {stale}")


def test_every_exception_gives_a_counterpart_or_a_reason():
    short = [k for k, v in EXCEPTIONS.items()
             if not isinstance(v, str) or len(v.strip()) < 20]
    assert not short, f"EXCEPTIONS entries without a reason: {short}"
