"""One rank of the port's multi-process CPU tests (gloo).

    RANK=r WORLD_SIZE=w MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_ranks.py <job> <workdir>

Reads ``<workdir>/inputs.pkl`` (numpy arrays made by the test from a
seed), runs ``<job>`` and writes ``<workdir>/out_<rank>.pkl``.  It imports
the port only, never the reference package: the tests hold what it
writes against the reference package in their own process.  Jobs:

- ``ops``: the sharded temporal shift (forward and backward), the global
  constraint, sync BN, and the [2, 2] sequence-parallel train and eval
  steps (4 ranks);
- ``steps``: the data-parallel [2, 1] and sequence-parallel [1, 2] train
  and eval steps, each also with ``remat``, and the four-stream
  data-parallel step (2 ranks);
- ``trainer``: ``cli.train.main`` under the launcher's environment, with
  each epoch's statistics and the final weights recorded (2 ranks);
- ``tp``: the channel gather's forward and adjoint, and the
  tensor-parallel [1, 2] train and eval steps of the Shift-GCN model
  (also with ``remat``), of the four streams and of ST-GCN, each beside
  the one-process step from the same weights (2 ranks);
- ``tp22``: the tensor-parallel [2, 2] train and eval steps (4 ranks);
- ``edge``: the edge partition's aggregators (``gather`` and ``ring``)
  with their adjoints, and its train and eval steps: ST-GCN under
  ``gather`` at [2, 2] and [1, 4], the ring-GNN under ``ring`` at
  [1, 4], with rank 0's one-process steps from the same weights (4
  ranks).
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from shift_gcn_torch.models.shift_gcn import (  # noqa: E402
    Model, config_from_reference_args)
from shift_gcn_torch.ops import temporal_shift as ts  # noqa: E402
from shift_gcn_torch.ops.batchnorm import batch_norm_train  # noqa: E402
from shift_gcn_torch.models import ring_gnn, stgcn  # noqa: E402
from shift_gcn_torch.parallel import (  # noqa: E402
    comm, edge_partition, halo, seqpar, tensor)
from shift_gcn_torch.parallel.mesh import make_mesh  # noqa: E402
from shift_gcn_torch.train import fourstream, optim, state  # noqa: E402
from shift_gcn_torch.utils.checkpoint import (  # noqa: E402
    state_dict_from_arrays, stream_state_dicts_from_arrays)


def shard(a, mesh, t_axis=1):
    """This rank's rows, and frames along ``t_axis`` (None: all)."""
    a = a[mesh.batch_rows(a.shape[0])]
    if t_axis is None:
        return a
    index = [slice(None)] * a.ndim
    index[t_axis] = mesh.time_frames(a.shape[t_axis])
    return a[tuple(index)]


def _params(c):
    return (torch.nn.Parameter(torch.from_numpy(c["xpos"])),
            torch.nn.Parameter(torch.from_numpy(c["ypos"])))


def shift_case(c, mesh, sharded):
    """One temporal shift forward and backward on this rank's block."""
    x = shard(torch.from_numpy(c["x"]), mesh,
              1 if sharded else None).requires_grad_(True)
    g = shard(torch.from_numpy(c["g"]), mesh, 1 if sharded else None)
    xpos, ypos = _params(c)
    if sharded:
        out = halo.sharded_temporal_shift(x, ypos, c["stride"], mesh,
                                          c["max_shift"], xpos=xpos)
    else:
        out = ts.temporal_shift(x, ypos, c["stride"], xpos=xpos, mesh=mesh)
    out.backward(g)
    with torch.no_grad():
        # the rank's own gy_raw, before the reduction: on the
        # halo-extended block under sequence parallelism
        xl, gl, s = x.detach(), g, c["stride"]
        if sharded:
            lo, hi = halo.halo_sizes(c["max_shift"], s)
            xl = halo.halo_exchange(xl, lo, hi, mesh)
            gl = torch.nn.functional.pad(
                gl, (0, 0, 0, 0, lo // s, xl.shape[1] // s - lo // s
                     - gl.shape[1]))
        local = ts.temporal_shift_position_grad(xl, gl, ypos.detach(), s)
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(),
            "gy": ypos.grad.numpy(), "gx": xpos.grad.numpy(),
            "local_gy_raw": local.numpy()}


def bn_case(c, mesh):
    x = shard(torch.from_numpy(c["x"]), mesh,
              1 if mesh.model > 1 else None).requires_grad_(True)
    cot = shard(torch.from_numpy(c["cot"]), mesh,
                1 if mesh.model > 1 else None)
    w = torch.nn.Parameter(torch.from_numpy(c["weight"]))
    b = torch.nn.Parameter(torch.from_numpy(c["bias"]))
    rm, rv = (torch.from_numpy(c[k].copy()) for k in ("rm", "rv"))
    nbt = torch.zeros((), dtype=torch.long)
    out = batch_norm_train(x, w, b, rm, rv, nbt,
                           feature_dims=c["feature_dims"],
                           group=mesh.world_group)
    (out * cot).sum().backward()
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(),
            "dw": w.grad.numpy(), "db": b.grad.numpy(), "rm": rm.numpy(),
            "rv": rv.numpy(), "nbt": int(nbt)}


def _model(args, params, bn_state, remat=False):
    model = Model(dataclasses.replace(config_from_reference_args(args),
                                      remat=remat), device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, bn_state))
    return model


def _batch(c, *keys):
    out = {"data": torch.from_numpy(c["data"]),
           "label": torch.from_numpy(c["label"]).long()}
    if "mask" in keys:
        out["mask"] = torch.from_numpy(c["mask"])
    return out


def model_case(c, shape, shard_time, remat=False):
    """Eval step from the loaded weights, then one train step."""
    mesh = make_mesh(shape)
    model = seqpar.attach(_model(c["args"], c["params"], c["bn_state"],
                                 remat), mesh, shard_time)
    logits, loss_sum, n = seqpar.eval_step(model, _batch(c, "mask"), mesh,
                                           shard_time)
    opt = optim.build_optimizer(model, c["lr"])
    loss, acc = seqpar.train_step(model, opt, _batch(c), c["lr"], mesh,
                                  shard_time)
    return {"loss": float(loss), "acc": float(acc),
            "logits": logits, "loss_sum": loss_sum, "n": n,
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()},
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "momentum": {k: opt.state[p]["momentum_buffer"].numpy()
                         for k, p in model.named_parameters()}}


def fourstream_case(c, shape=(2, 1), tensor_parallel=False):
    mesh = make_mesh(list(shape), tensor_parallel=tensor_parallel)
    dicts = stream_state_dicts_from_arrays(c["params4"], c["bn4"],
                                           fourstream.STREAMS)
    models, opts = {}, {}
    for stream in fourstream.STREAMS:
        models[stream] = Model(config_from_reference_args(c["args"]),
                               device="cpu")
        models[stream].load_state_dict(dicts[stream])
        seqpar.attach(models[stream], mesh)
        opts[stream] = optim.build_optimizer(models[stream], c["lr"])
    rows = mesh.batch_rows(len(c["label"]))
    batch = {"data": shard(torch.from_numpy(c["data"]), mesh, None),
             "label": torch.from_numpy(c["label"][rows]).long()}
    losses, _ = fourstream.train_step(models, opts, batch, c["lr"],
                                      c["parents"], mesh=mesh)
    return {"losses": losses.numpy(),
            "grads": {s: full_grads(m, mesh) for s, m in models.items()},
            "state": {s: {k: v.numpy() for k, v in
                          tensor.full_state_dict(m, mesh).items()}
                      if mesh.tensor_parallel else
                      {k: v.numpy() for k, v in m.state_dict().items()}
                      for s, m in models.items()}}


def full_grads(model, mesh):
    """The model's gradients, a tensor-parallel rank's slices gathered
    over the model ranks."""
    out = {}
    for k, p in model.named_parameters():
        axis = tensor.sharded_axis(k) if mesh.tensor_parallel else None
        g = p.grad if axis is None else torch.cat(
            comm.all_gather(p.grad, mesh.model_group), axis)
        out[k] = g.numpy().copy()
    return out


def one_process_step(model, c, batch):
    opt = optim.build_optimizer(model, c["lr"])
    loss, _ = state.train_step(model, opt, batch, c["lr"])
    return {"loss": float(loss), "grads": {
        k: p.grad.numpy().copy() for k, p in model.named_parameters()},
        "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def tp_case(c, shape, build, single=True):
    """The tensor-parallel eval step and one train step at ``shape`` of the
    model ``build()`` gives, with the local shapes of its sharded
    parameters and, in the full layout, its gradients, state and
    momentum; and, with ``single``, the one-process train step of
    another ``build()``."""
    mesh = make_mesh(shape, tensor_parallel=True)
    model = seqpar.attach(build(), mesh)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()
              if tensor.sharded_axis(k) is not None}
    logits, loss_sum, n = seqpar.eval_step(model, _batch(c, "mask"), mesh)
    opt = optim.build_optimizer(model, c["lr"])
    loss, acc = seqpar.train_step(model, opt, _batch(c), c["lr"], mesh)
    entry = tensor.full_entry(model, opt, mesh)
    names = tensor._slot_names(model, opt)
    return {"loss": float(loss), "logits": logits, "loss_sum": loss_sum,
            "n": n, "shapes": shapes, "grads": full_grads(model, mesh),
            "state": {k: v.numpy()
                      for k, v in entry["model_state_dict"].items()},
            "momentum": {names[i]: v["momentum_buffer"].cpu().numpy()
                         for i, v in entry["optimizer_state_dict"][
                             "state"].items()},
            "single": single and one_process_step(build(), c, _batch(c))}


def gather_case(c, mesh):
    """gather_channels of this rank's slice, and its adjoint under a
    cotangent that differs by rank."""
    x = torch.from_numpy(c["x"])
    cols = tensor.columns(mesh, x.shape[-1] // mesh.model)
    local = x[..., cols].clone().requires_grad_(True)
    out = comm.gather_channels(local, mesh.model_group)
    (out * torch.from_numpy(c["cot"][mesh.rank])).sum().backward()
    return {"out": out.detach().numpy(), "grad": local.grad.numpy()}


def job_ops(inp):
    meshes = {shape: make_mesh(list(shape))
              for shape in ((1, 4), (2, 2), (4, 1))}
    return {
        "halo": {k: shift_case(c, meshes[c["mesh"]], True)
                 for k, c in inp["halo"].items()},
        "constraint": {k: shift_case(c, meshes[c["mesh"]], c["sharded"])
                       for k, c in inp["constraint"].items()},
        "bn": {k: bn_case(c, meshes[c["mesh"]])
               for k, c in inp["bn"].items()},
        "seqpar22": model_case(inp["model"], [2, 2], True),
    }


def job_steps(inp):
    return {"dp21": model_case(inp["model"], [2, 1], False),
            "seqpar12": model_case(inp["model"], [1, 2], True),
            "dp21_remat": model_case(inp["model"], [2, 1], False, True),
            "seqpar12_remat": model_case(inp["model"], [1, 2], True, True),
            "fourstream": fourstream_case(inp["fourstream"])}


def job_trainer(inp):
    """On rank 0 alone, each config of ``inp["before"]`` (argv) in one
    process without a mesh (the other ranks wait at the next group's
    rendezvous); then each of ``inp["runs"]`` ({"argv", "env"}) through
    the CLI in turn; then, on rank 0 alone, each config of
    ``inp["single"]`` likewise: per run, the epochs' losses, the mesh and
    the final weights.  A run's group rendezvous on a port of its own
    (``env``): a store left on the port of a destroyed group can hang the
    next one."""
    from shift_gcn_torch.cli import train as cli_train
    from shift_gcn_torch.train import config
    from shift_gcn_torch.train.trainer import Trainer

    epochs, trainers = [], []
    train_epoch, start = Trainer.train_epoch, Trainer.start

    def recording_epoch(self, epoch):
        stats = train_epoch(self, epoch)
        epochs.append(stats)
        return stats

    def recording_start(self):
        trainers.append(self)
        return start(self)

    Trainer.train_epoch, Trainer.start = recording_epoch, recording_start
    def record(start_run):
        epochs.clear()
        trainers.clear()
        start_run()
        trainer = trainers[0]
        mesh = trainer.mesh
        return {"losses": [e["losses"] for e in epochs],
                "mesh": mesh and (mesh.data, mesh.model, mesh.hosts),
                "state": {k: v.numpy()
                          for k, v in trainer.model.state_dict().items()}}

    def single(argvs):
        out = []
        if os.environ["RANK"] == "0":
            for argv in argvs:
                cfg = config.load_config(argv)
                cfg.mesh_shape, cfg.shard_time = None, False
                out.append(record(lambda: Trainer(cfg, device="cpu")
                                  .start()))
        return out

    results = single(inp.get("before", []))
    for run in inp["runs"]:
        os.environ.update(run.get("env", {}))
        results.append(record(lambda: cli_train.main(run["argv"])))
    return results + single(inp.get("single", []))


def job_tp(inp):
    m = inp["model"]
    s = inp["stgcn"]

    def shift_gcn():
        return _model(m["args"], m["params"], m["bn_state"])

    def st_gcn():
        return stgcn.Model(stgcn.config_from_args(s["args"]),
                           device="cpu").init_weights(
            torch.Generator().manual_seed(s["seed"]))

    return {"gather": gather_case(inp["gather"], make_mesh([1, 2], True)),
            "tp12": tp_case(m, [1, 2], shift_gcn),
            "tp12_remat": tp_case(m, [1, 2], lambda: _model(
                m["args"], m["params"], m["bn_state"], remat=True),
                single=False),
            "fourstream": fourstream_case(inp["fourstream"], (1, 2), True),
            "stgcn": tp_case(s, [1, 2], st_gcn)}


def job_tp22(inp):
    m = inp["model"]
    return {"tp22": tp_case(m, [2, 2], lambda: _model(
        m["args"], m["params"], m["bn_state"]))}


def edge_aggregator_case(c, mesh):
    """Both standalone aggregators on the whole x; the gather's adjoint
    under a cotangent that differs by rank, and ``ring_aggregate``'s on
    this rank's padded node block under its block of one cotangent."""
    x = torch.from_numpy(c["x"])
    cot = torch.from_numpy(c["cot"])
    xg = x.clone().requires_grad_(True)
    out = edge_partition.make_sharded_aggregator(
        c["edges"], c["v"], mesh, "gather", device="cpu")(xg)
    (out * cot[mesh.coords[1]]).sum().backward()
    ring = edge_partition.make_sharded_aggregator(c["edges"], c["v"], mesh,
                                                  "ring", device="cpu")(x)
    steps, v_pad, v_loc = edge_partition.partition_edges_ring(
        c["edges"], mesh.model, c["v"])
    m = mesh.coords[1]
    local = [{k: torch.from_numpy(a[m]) for k, a in step.items()}
             for step in steps]
    rows = slice(m * v_loc, (m + 1) * v_loc)
    pad = (0, 0, 0, v_pad - c["v"])
    block = torch.nn.functional.pad(x, pad)[:, rows].clone()
    block.requires_grad_(True)
    got = edge_partition.ring_aggregate(block, local, mesh.model_group)
    (got * torch.nn.functional.pad(cot.sum(0), pad)[:, rows]).sum(
        ).backward()
    return {"gather": out.detach().numpy(), "gather_dx": xg.grad.numpy(),
            "ring": ring.numpy(), "ring_block": got.detach().numpy(),
            "ring_dx": block.grad.numpy()}


def edge_model_case(c, mesh, build, strategy):
    """The edge-partitioned eval step from the loaded weights, then one
    train step."""
    model = edge_partition.attach(build(), mesh, strategy)
    logits, loss_sum, n = edge_partition.eval_step(model, _batch(c, "mask"),
                                                   mesh)
    opt = optim.build_optimizer(model, c["lr"])
    loss, acc = edge_partition.train_step(model, opt, _batch(c), c["lr"],
                                          mesh)
    return {"loss": float(loss), "acc": float(acc), "logits": logits,
            "loss_sum": loss_sum, "n": n,
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()},
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def job_edge(inp):
    s, r = inp["stgcn"], inp["ring"]

    def st_gcn():
        model = stgcn.Model(stgcn.config_from_args(s["args"]), device="cpu")
        model.load_state_dict(state_dict_from_arrays(s["params"],
                                                     s["bn_state"]))
        return model

    def ring():
        model = ring_gnn.Model(ring_gnn.config_from_args(r["args"]),
                               device="cpu")
        model.load_state_dict(state_dict_from_arrays(r["params"], {}))
        return model

    m14, m22 = make_mesh([1, 4]), make_mesh([2, 2])
    out = {"agg": edge_aggregator_case(inp["agg"], m14),
           "stgcn22": edge_model_case(s, m22, st_gcn, "gather"),
           "stgcn14": edge_model_case(s, m14, st_gcn, "gather"),
           "ring14": edge_model_case(r, m14, ring, "ring")}
    if m14.rank == 0:
        out["single"] = {"stgcn": one_process_step(st_gcn(), s, _batch(s)),
                         "ring": one_process_step(ring(), r, _batch(r))}
    return out


JOBS = {"ops": job_ops, "steps": job_steps, "trainer": job_trainer,
        "tp": job_tp, "tp22": job_tp22, "edge": job_edge}


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(job, workdir, world, inputs, timeout=240, env=None):
    """Run ``job`` in ``world`` fresh processes (spawned, never forked)
    on a free port; returns every rank's output in rank order.  A rank
    that fails or outlives ``timeout`` seconds fails the run, with every
    rank's output in the message."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    procs = []
    for rank in range(world):
        rank_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, workdir],
            env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = [], False
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            logs.append(proc.communicate()[0] + "\n(timed out)")
        logs[-1] += f"\n(exit code {proc.returncode})"
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"{job}: a rank failed\n" + "\n----\n".join(
            logs))
    outs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def main():
    # as in tests/test_torch_train.py: torch's oneDNN convolution backward
    # has been seen corrupting the heap in this test environment; torch's
    # native convolution has the same arithmetic
    torch.backends.mkldnn.enabled = False
    job, workdir = sys.argv[1:3]
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    own_group = job != "trainer"  # the trainer's CLI joins on its own
    if own_group:
        dist.init_process_group("gloo", init_method="env://")
    rank = int(os.environ["RANK"])
    out = JOBS[job](inp)
    path = os.path.join(workdir, f"out_{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)
    if own_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
