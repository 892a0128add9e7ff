"""Trainer: the reference Processor (main.py:172-546) on one device, or
on one device per process of a ``torch.distributed`` run.

The config's ``model`` names a family of ``models/registry.py``
(Shift-GCN, ST-GCN, ring-GNN), which builds the model config from
``model_args`` and the model itself.  ``compute_dtype`` and
``activation_dtype`` reach the model config only where the family's
config has that field (Shift-GCN's).  The lowering is the config's
``lowering`` merged over ``model_args.lowering`` (the top level wins),
with the ``SGT_*`` environment overrides applied; the resolved dict is
written into the run's config snapshot.  A family with no lowering field
refuses a configured lowering, as the reference's trainer does.

Behavior follows the reference package's trainer: per-epoch step-decay
LR with warmup (main.py:342-353), the per-parameter weight-decay table
(main.py:307-317), the save / eval cadence, the best-accuracy and
per-epoch score pickles the ensemble tools read (main.py:493-515), the
wrong/right prediction files of the test phase (main.py:534-546), resume
from the newest checkpoint (``resume: auto``), the shift tap-radius
check at every save and eval, and the device guard after every train
epoch (``utils/device_guard.py``).  Checkpoints are the reference's torch
resume dicts (``utils/checkpoint.py``).

``remat`` reaches the model config where the family's config has that
field (Shift-GCN's; four-stream training gives it to each stream's
model): each unit is recomputed in the backward.  ``profile_dir``
traces the first ``profile_steps`` steps of the run's first epoch with
``torch.profiler`` (CPU activity, and CUDA activity on a card) into a
TensorBoard directory, one ``rank<r>.<time>.pt.trace.json`` a rank, each
step a ``ProfilerStep#<i>`` span (the reference package writes its
profiler's trace there).  ``debug_nans`` (the reference package's NaN
debugging mode) raises ``FloatingPointError`` at the first module
whose forward output holds a NaN, by a forward hook on every module, and
at the first backward function that returns one
(``torch.autograd.detect_anomaly``); off, nothing is registered and no
step waits for the device.

``fourstream: true`` trains the joint, bone, joint-motion and
bone-motion models in one run from the joint data (``train/fourstream.py``):
per-stream and ensemble score pickles, one four-stream checkpoint.

``device`` defaults to CUDA, where the model runs the hand-written
kernels; ``device="cpu"`` runs their plain versions and must be asked
for.  The train iterator's producer thread builds the batches
(``data/feeder.py``), and a worker thread takes step b+1's and starts
its host-to-device copy while step b runs (``BatchTransfer``).  With
bf16 transfer (``transfer_dtype``, 'auto' under bf16 activations) each
batch is rounded to bf16 on the host, moved, and cast back to fp32 on
the device before ``data_bn`` (and before the four-stream derivation),
as the reference package does.

Under a default process group (``cli/train.py`` initializes it under
torchrun, SLURM or Open MPI) the run is data parallel over
``mesh_shape`` [D, 1] (the default: every rank on 'data'), data and
sequence parallel over [D, M] with ``shard_time``, data and tensor
parallel over [D, M] with M > 1 and no ``shard_time``, or data parallel
with the graph's edges over the M model ranks under ``edge_partition``
(``gather``: ST-GCN; ``ring``: the ring-GNN's node shards)
(``parallel/``), as the reference trainer's multi-process layouts
(trainer.py:124-160) and its ``_build_steps`` (:210-291):

- every rank builds the model from the same seed and attaches the
  mesh's collectives (sync BN, the global constraint, the T shards, the
  sharded output channels, cut to the rank's slices, or the rank's
  edge slice or ring buckets, with BN over the data ranks);
- a node's feeders give its share of the epoch (``hosts`` > 1, when
  several nodes feed D > 1 data ranks), or every rank's feeder gives
  the whole batch; each rank keeps its rows (and frames, or under
  ``ring`` joints) and moves only those to its card;
- eval gathers the logits, labels, indices and masks of every data
  rank and the loss sums, so every rank scores the whole split the
  same way; in dataset order;
- rank 0 writes the run's files (config snapshot, checkpoints, score
  pickles, logs) and a barrier follows each write; every rank resumes
  from the same checkpoint and makes the same resumed-past-the-end
  decision.  Checkpoints keep the full reference layout: under tensor
  parallelism every rank gathers its slices for rank 0 to write, and
  ``resume`` and ``weights`` cut a full file to each rank's slices, so
  a file moves between any layouts and one process;
- a device the guard finds unhealthy raises on its rank: the guard's
  re-exec restarts one process, not a group.
"""

from __future__ import annotations

import dataclasses
import glob
import inspect
import os
import pickle
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, closing, contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from shift_gcn_torch.data.feeder import BatchIterator, Feeder
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.models.registry import get_model
from shift_gcn_torch.models.shift_gcn import check_shift_range
from shift_gcn_torch.ops import lowering as lowering_lib
from shift_gcn_torch.parallel import edge_partition, launch, seqpar, tensor
from shift_gcn_torch.parallel.mesh import make_mesh
from shift_gcn_torch.train import config as config_lib
from shift_gcn_torch.train import fourstream
from shift_gcn_torch.train import state as state_lib
from shift_gcn_torch.train.optim import build_optimizer, step_decay_lr
from shift_gcn_torch.utils import checkpoint as ckpt_lib
from shift_gcn_torch.utils import device_guard, trace
from shift_gcn_torch.utils.device import resolve_device
from shift_gcn_torch.utils.logging import RunLogger


def resolve_transfer_dtype(setting: str,
                           activation_dtype: Optional[str]) -> torch.dtype:
    """Batch dtype on its way to the device: 'auto' is bf16 exactly when
    the model runs bf16 activations."""
    if setting == "auto":
        setting = ("bfloat16" if activation_dtype == "bfloat16"
                   else "float32")
    if setting in ("float32", "fp32"):
        return torch.float32
    if setting == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"transfer_dtype={setting!r}: expected 'auto', "
                     "'bfloat16' or 'float32'")


class BatchTransfer:
    """Host batches -> device tensors.

    ``stage`` (the prefetch thread) casts each array to its transfer type
    on the host and starts its copy; ``receive`` (the step's thread)
    returns the tensors ready for the step, data cast back to fp32 on the
    device.  On CUDA the copies come from page-locked host buffers, SLOTS
    of them used in turn, on a side stream made for the trainer's device;
    an event recorded after the copies is what the step's stream waits
    on, and ``record_stream`` keeps the caching allocator from reusing the
    tensors' memory before the step is done with them.  A slot is
    refilled only after its previous copy has finished.  On the CPU the
    same casts run with no pinning.
    """

    SLOTS = 2

    def __init__(self, device: torch.device, data_dtype: torch.dtype):
        self.device = device
        self.data_dtype = data_dtype
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._slots = [None] * self.SLOTS
        self._turn = 0

    def stage(self, data: np.ndarray, label: np.ndarray,
              mask: Optional[np.ndarray] = None):
        arrays = {"data": (data, self.data_dtype),
                  "label": (label, torch.long)}
        if mask is not None:
            arrays["mask"] = (mask, torch.float32)
        if self.stream is None:
            return {k: torch.from_numpy(a).to(dtype)
                    for k, (a, dtype) in arrays.items()}, None
        i = self._turn
        self._turn = (i + 1) % self.SLOTS
        slot = self._slots[i]
        if slot is None:
            slot = self._slots[i] = {"done": torch.cuda.Event()}
        slot["done"].synchronize()  # this slot's last copy has finished
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for key, (array, dtype) in arrays.items():
                buf = slot.get(key)
                if buf is None or buf.shape != array.shape:
                    buf = slot[key] = torch.empty(array.shape, dtype=dtype,
                                                  pin_memory=True)
                buf.copy_(torch.from_numpy(array))
                out[key] = buf.to(self.device, non_blocking=True)
            slot["done"].record(self.stream)
        return out, slot["done"]

    def receive(self, staged) -> Dict[str, torch.Tensor]:
        tensors, done = staged
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for tensor in tensors.values():
                tensor.record_stream(current)
        tensors["data"] = tensors["data"].float()
        return tensors


def watch_nans(model: torch.nn.Module, prefix: str = "") -> None:
    """A forward hook on every module of ``model`` that raises
    ``FloatingPointError`` naming the module (``prefix`` before its
    name) when its output holds a NaN."""
    for name, module in model.named_modules():
        label = ".".join(p for p in (prefix, name) if p) or "model"

        def hook(module, inputs, output, label=label):
            outputs = output if isinstance(output, (tuple, list)) else [
                output]
            for out in outputs:
                if (torch.is_tensor(out) and out.is_floating_point()
                        and bool(torch.isnan(out).any())):
                    raise FloatingPointError(
                        f"NaN in the forward output of {label} "
                        f"({type(module).__name__})")

        module.register_forward_hook(hook)


@contextmanager
def nan_check():
    """Autograd's anomaly mode with the NaN check: a backward function
    that returns a NaN raises ``FloatingPointError`` naming it."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as err:
        if "nan values" not in str(err):
            raise
        raise FloatingPointError(str(err)) from err


class Trainer:
    def __init__(self, cfg: config_lib.ExperimentConfig, device="cuda"):
        distributed = dist.is_available() and dist.is_initialized()
        config_lib.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(
            launch.rank_device(device) if distributed else device)
        if distributed and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.shard_time = bool(cfg.shard_time)
        self.edge_partition = bool(cfg.edge_partition)
        # the ring's ranks hold joints of every clip
        self.shard_nodes = (self.edge_partition
                            and cfg.edge_strategy == "ring")
        # raises unless mesh_shape covers the ranks (one without a group);
        # the model ranks hold T shards, edges or channel slices
        mesh = make_mesh(cfg.mesh_shape,
                         launch.node_count() if distributed else 1,
                         tensor_parallel=not (self.shard_time
                                              or self.edge_partition))
        # the parallel.mesh.Mesh of a multi-process run, else None; a
        # node's feeder gives its shard of the epoch when hosts > 1
        self.mesh = mesh if distributed else None
        self.host, self.hosts, self.world = mesh.host, mesh.hosts, mesh.world
        for n in (cfg.batch_size, cfg.test_batch_size):
            mesh.batch_rows(n)  # raises unless n splits
        self.rank0 = mesh.rank == 0
        self.work_dir = cfg.resolved_work_dir()
        self.save_dir = cfg.resolved_save_dir()
        self.logger = RunLogger(self.work_dir,
                                to_file=cfg.print_log and self.rank0,
                                echo=self.rank0)
        self.logger.log(f"Device: {self.device}")
        os.makedirs(os.path.join(self.work_dir, "eval_results"),
                    exist_ok=True)
        self.family = get_model(cfg.model)
        if self.rank0:
            # the model source beside the run (reference: main.py:257)
            shutil.copy2(inspect.getfile(self.family.build), self.work_dir)

        # resolve `resume: auto` before any overwrite cleanup, so a rerun
        # never deletes the checkpoint it is about to continue from
        resume = cfg.resume
        if resume == "auto":
            resume = ckpt_lib.latest_checkpoint(self.save_dir)
            if resume:
                self.logger.log(f"Auto-resume found checkpoint: {resume}")
        self._resume_path = resume
        if cfg.phase == "train" and cfg.overwrite and self.rank0:
            self._cleanup_previous_run()
        self._barrier()

        self.lowering, self.model_config = self._build_model_config()
        if self.rank0:
            config_lib.save_config(cfg, os.path.join(self.work_dir,
                                                     "config.yaml"))
        self.transfer_dtype = resolve_transfer_dtype(
            cfg.transfer_dtype,
            getattr(self.model_config, "activation_dtype", None))
        self.transfer = BatchTransfer(self.device, self.transfer_dtype)

        self.fourstream = bool(cfg.fourstream)
        if self.fourstream and not self.family.skeleton:
            raise ValueError(
                f"fourstream is not supported by model family {cfg.model!r}:"
                " the bone streams need a skeleton graph in its config")
        if self.fourstream:
            self.models = fourstream.create_models(
                self.model_config, cfg.seed, self.device,
                build=self.family.build)
            self.optimizers = {stream: build_optimizer(model, cfg.base_lr)
                               for stream, model in self.models.items()}
            self.parents = torch.as_tensor(
                get_graph(self.model_config.graph).bone_parents(),
                device=self.device)
        else:
            self.model = self.family.build(self.model_config,
                                           device=self.device)
            self.model.init_weights(torch.Generator().manual_seed(cfg.seed))
            self.optimizer = build_optimizer(self.model, cfg.base_lr)
        if cfg.debug_nans:
            for prefix, model in (self.models.items() if self.fourstream
                                  else [("", self.model)]):
                watch_nans(model, prefix)
        if self.mesh is not None and self.edge_partition:
            edge_partition.attach(self.model, self.mesh, cfg.edge_strategy)
        elif self.mesh is not None:
            # same-seed weights on every rank; the collectives attached
            for model in (self.models.values() if self.fourstream
                          else [self.model]):
                seqpar.attach(model, self.mesh, self.shard_time)
        self.global_step = 0
        self.best_acc = 0.0
        self.start_epoch = cfg.start_epoch

        if cfg.weights:
            self._load_weights(cfg.weights, cfg.ignore_weights)
        if self._resume_path:
            self._resume(self._resume_path)
        self._load_data()

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _build_model_config(self):
        """(the resolved lowering, the family's model config from
        ``model_args`` with the run's dtypes and that lowering where its
        config has those fields); records the resolved lowering in
        ``cfg.lowering`` (reference package trainer.py:55-111)."""
        cfg = self.cfg
        explicit = {**(cfg.model_args.get("lowering") or {}),
                    **(cfg.lowering or {})}
        low = lowering_lib.resolve(lowering_lib.from_dict(explicit))
        model_config = self.family.build_config(cfg.model_args)
        fields = {f.name for f in dataclasses.fields(model_config)}
        overrides = {}
        if cfg.compute_dtype and "compute_dtype" in fields:
            overrides["compute_dtype"] = cfg.compute_dtype
        if cfg.activation_dtype and "activation_dtype" in fields:
            overrides["activation_dtype"] = cfg.activation_dtype
        if cfg.remat and "remat" in fields:
            overrides["remat"] = True
        if "lowering" in fields:
            overrides["lowering"] = low
            cfg.lowering = lowering_lib.as_dict(low)
        elif explicit:
            raise ValueError(
                f"model family {cfg.model!r} has no lowering surface "
                f"(its config has no 'lowering' field); configured "
                f"lowering keys {sorted(explicit)} would be ignored.  "
                "Remove the 'lowering' config key, or use the shift_gcn "
                "family.")
        else:
            cfg.lowering = {}
        return low, dataclasses.replace(model_config, **overrides)

    def _cleanup_previous_run(self) -> None:
        # reference: main.py:183-206; the resolved resume path is kept
        resume_abs = (os.path.abspath(self._resume_path)
                      if self._resume_path else None)
        for path in glob.glob(os.path.join(self.save_dir, "*.pt")):
            if os.path.abspath(path) != resume_abs:
                os.remove(path)
        for pkl in glob.glob(os.path.join(self.work_dir, "eval_results",
                                          "*.pkl")):
            os.remove(pkl)

    def _load_data(self) -> None:
        cfg = self.cfg
        self.feeders: Dict[str, Feeder] = {}
        self.iterators: Dict[str, BatchIterator] = {}
        extra = {"native": True} if cfg.native_loader else {}
        # a node's shard of the epoch when several nodes feed the data
        # ranks; otherwise every feeder gives the whole batch
        shards = {"seed": cfg.seed, "host_id": self.host,
                  "num_hosts": self.hosts}
        if cfg.phase == "train":
            self.feeders["train"] = Feeder(**cfg.train_feeder_args, **extra)
            self.iterators["train"] = BatchIterator(
                self.feeders["train"], cfg.batch_size, shuffle=True,
                drop_last=True, **shards)
        self.feeders["test"] = Feeder(**cfg.test_feeder_args, **extra)
        self.iterators["test"] = BatchIterator(
            self.feeders["test"], cfg.test_batch_size, shuffle=False,
            drop_last=False, **shards)
        if self.shard_time:
            for feeder in self.feeders.values():
                seqpar.check_batch(self.model, feeder.get(0).shape[1],
                                   self.mesh, True)

    @property
    def _tensor_parallel(self) -> bool:
        return self.mesh is not None and self.mesh.tensor_parallel

    def _local_weights(self, weights: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """A full-layout state_dict cut to this rank's slices under
        tensor parallelism (else as it is)."""
        if not self._tensor_parallel:
            return weights
        return tensor.local_state_dict(weights, self.mesh)

    def _load_entry(self, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, entry) -> None:
        """Load a full-layout resume entry (model and optimizer state)."""
        osd = entry["optimizer_state_dict"]
        if self._tensor_parallel:
            osd = tensor.local_optimizer_state(model, optimizer, osd,
                                               self.mesh)
        model.load_state_dict(
            self._local_weights(entry["model_state_dict"]), strict=True)
        optimizer.load_state_dict(osd)

    def _local(self, *arrays):
        """This rank's rows (and frames or joints: data first) of a host
        batch."""
        if self.mesh is None:
            return arrays
        rows = self.mesh.batch_rows(len(arrays[0]))
        return (self.mesh.local(arrays[0], self.shard_time,
                                self.shard_nodes),
                *(a[rows] for a in arrays[1:]))

    def _put_batch(self, data: np.ndarray, label: np.ndarray,
                   mask: Optional[np.ndarray] = None
                   ) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors; data arrives fp32 on the device."""
        return self.transfer.receive(self.transfer.stage(data, label, mask))

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _load_weights(self, path: str, ignore: Optional[list] = None) -> None:
        """Load model weights from a reference .pt / .pkl / .pth
        (main.py:261-292): keys named in ``ignore`` are dropped, missing
        keys are reported and keep their initial values.  A four-stream
        run takes a four-stream checkpoint and loads it stream by stream,
        ``ignore`` applied to each."""
        self.logger.log(f"Load weights from {path}.")
        if not path.endswith((".pt", ".pkl", ".pth")):
            raise ValueError(f"weights {path!r}: expected a .pt, .pkl or "
                             ".pth file")
        if not self.fourstream:
            weights, _ = ckpt_lib.load_reference_checkpoint(path)
            self._merge_weights(self.model, weights, ignore)
            return
        if path.endswith(".pkl"):
            raise ValueError(f"weights {path!r}: a four-stream run takes a "
                             "four-stream checkpoint (.pt)")
        streams, _ = ckpt_lib.load_fourstream_checkpoint(path)
        missing = [s for s in fourstream.STREAMS if s not in streams]
        if missing:
            raise ValueError(f"weights {path!r}: streams {missing} are not "
                             "in this four-stream checkpoint")
        for stream, model in self.models.items():
            self.logger.log(f"  stream {stream}:")
            self._merge_weights(model, dict(
                streams[stream]["model_state_dict"]), ignore)

    def _merge_weights(self, model: torch.nn.Module,
                       weights: Dict[str, torch.Tensor],
                       ignore: Optional[list]) -> None:
        for name in ignore or []:
            for k in [k for k in weights if name in k]:
                weights.pop(k)
                self.logger.log(f"Successfully Remove Weights: {k}.")
        weights = self._local_weights(weights)
        own = model.state_dict()
        missing = sorted(set(own) - set(weights))
        if missing:
            self.logger.log("Can not find these weights:")
            for k in missing:
                self.logger.log("  " + k)
        for k, v in weights.items():
            if k in own and own[k].shape != v.shape:
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(own[k].shape)} vs {tuple(v.shape)}")
        model.load_state_dict(
            {k: v for k, v in weights.items() if k in own}, strict=False)

    def _resume(self, path: str) -> None:
        # reference: main.py:215-229
        self.logger.log(f"Resuming from checkpoint: {path}")
        if self.fourstream:
            streams, blob = ckpt_lib.load_fourstream_checkpoint(path)
            for stream, model in self.models.items():
                self._load_entry(model, self.optimizers[stream],
                                 streams[stream])
        else:
            blob = torch.load(path, map_location=self.device,
                              weights_only=True)
            self._load_entry(self.model, self.optimizer, blob)
        self.start_epoch = int(blob["epoch"]) + 1
        self.global_step = int(blob["global_step"])
        self.best_acc = float(blob["best_acc"])
        self.logger.log(
            f"  Resumed: epoch={self.start_epoch}, "
            f"global_step={self.global_step}, best_acc={self.best_acc:.4f}")

    # ------------------------------------------------------------------
    # phases
    # ------------------------------------------------------------------

    def start(self) -> float:
        cfg = self.cfg
        if cfg.phase == "train":
            self.logger.log(f"Parameters:\n{cfg}\n")
            for epoch in range(self.start_epoch, cfg.num_epoch):
                is_last = epoch + 1 == cfg.num_epoch
                self._guard_device(self.train_epoch(epoch))
                if is_last or (epoch + 1) % cfg.save_interval == 0:
                    self.save(epoch)
                if is_last or (epoch + 1) % cfg.eval_interval == 0:
                    self.evaluate(epoch)
            need_final_eval = not os.path.exists(os.path.join(
                self.work_dir, "eval_results", "best_acc.pkl"))
            if self.mesh is not None:
                # evaluate() runs collectives: every rank makes the same
                # call (reference trainer.py:503-515)
                need_final_eval = self.mesh.any_rank(need_final_eval)
            if need_final_eval:
                # a rerun resumed past the end (killed during the final
                # eval) still completes the score-pickle contract
                self.logger.log(
                    "No best-score pickle found after training; running "
                    "the final evaluation")
                self.evaluate(cfg.num_epoch - 1)
            self.logger.log(f"best accuracy: {self.best_acc} "
                            f"model_name: {self.save_dir}")
        elif cfg.phase == "test":
            if cfg.weights is None:
                raise ValueError("Please appoint --weights.")
            wrong_file = result_file = None
            if not cfg.test_feeder_args.get("debug", False):
                wrong_file = os.path.join(self.work_dir, "wrong.txt")
                result_file = os.path.join(self.work_dir, "right.txt")
            self.logger.log(f"Model:   {cfg.model}.")
            self.logger.log(f"Weights: {cfg.weights}.")
            self.evaluate(0, wrong_file=wrong_file, result_file=result_file)
            self.logger.log("Done.\n")
        return self.best_acc

    def _train_step(self, batch: Dict[str, torch.Tensor],
                    lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step: (loss, acc) device tensors, (4,) under fourstream."""
        if self.cfg.debug_nans:
            with nan_check():
                return self._step(batch, lr)
        return self._step(batch, lr)

    def _step(self, batch: Dict[str, torch.Tensor],
              lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fourstream:
            return fourstream.train_step(self.models, self.optimizers, batch,
                                         lr, self.parents, mesh=self.mesh)
        return state_lib.train_step(self.model, self.optimizer, batch, lr,
                                    mesh=self.mesh)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; the prefetch thread takes step b+1's batch from the
        iterator's producer thread and starts its copy while step b runs
        (reference package trainer.py:555-588).  The epoch is timed as
        the ``train.*`` spans of ``utils/trace.py``; ``dataloader_share``
        is the share of the epoch spent before the first batch was in
        hand (``train.epoch_start``) and waiting for each later one
        (``train.feeder_wait``).  The run's first epoch is traced through
        step ``profile_steps`` under ``profile_dir``."""
        cfg = self.cfg

        def fetch_next():
            for data, label, _, _ in batches:
                return self.transfer.stage(*self._local(data, label))
            return None

        # per-step metrics stay on the device until the epoch ends: reading
        # one would wait for the device every step
        losses, accs = [], []
        t0 = time.perf_counter_ns()
        # closing: a step that raises stops the producer thread too
        with ExitStack() as stack:
            with trace.span("train.epoch_start") as opening:
                self.logger.log(f"Training epoch: {epoch + 1}")
                lr = step_decay_lr(epoch, cfg.base_lr, cfg.step,
                                   cfg.warm_up_epoch)
                it = self.iterators["train"]
                nb = it.batches_per_epoch()
                batches = stack.enter_context(closing(it.epoch(epoch)))
                profiler = (self._start_profiler()
                            if cfg.profile_dir and epoch == self.start_epoch
                            else None)
                pool = stack.enter_context(ThreadPoolExecutor(max_workers=1))
                staged = pool.submit(fetch_next).result()
            waited_ns = opening.ns
            b = 0
            while staged is not None:
                pending = pool.submit(fetch_next)
                with trace.span("train.step"):
                    loss, acc = self._train_step(
                        self.transfer.receive(staged), lr)
                losses.append(loss)
                accs.append(acc)
                if profiler is not None:
                    if b + 1 < cfg.profile_steps:
                        profiler.step()
                    else:
                        self._write_trace(profiler)
                        profiler = None
                self.global_step += 1
                if self.global_step % cfg.log_interval == 0:
                    streams = loss.reshape(-1).tolist()
                    extra = ("  streams:" + "/".join(f"{v:.3f}"
                                                     for v in streams)
                             if self.fourstream else "")
                    self.logger.log(f"\tBatch({b}/{nb}) done. Loss: "
                                    f"{np.mean(streams):.4f}  "
                                    f"lr:{lr:.6f}{extra}")
                b += 1
                with trace.span("train.feeder_wait") as wait:
                    staged = pending.result()
                waited_ns += wait.ns
        if profiler is not None:  # an epoch shorter than profile_steps
            self._write_trace(profiler)
        with trace.span("train.epoch_end"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            per_step = torch.stack(losses).cpu().numpy() if losses else None
        dt = (time.perf_counter_ns() - t0) * 1e-9
        # under fourstream a step's loss is the mean over the streams, as
        # the reference package logs it
        losses = [] if per_step is None else (
            per_step.mean(-1) if self.fourstream else per_step).tolist()
        accs = (torch.stack(accs).reshape(len(accs), -1).mean(-1).tolist()
                if accs else [])
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        mean_acc = float(np.mean(accs)) if accs else float("nan")
        share = waited_ns * 1e-9 / dt
        proportion = {k: f"{int(round(v * 100)):02d}%"
                      for k, v in (("dataloader", share),
                                   ("model", 1.0 - share))}
        clips = nb * cfg.batch_size * self.hosts
        self.logger.log(
            f"\tMean training loss: {mean_loss:.4f}  acc: {mean_acc:.4f}  "
            f"({clips / dt:.1f} clips/s)  time: {proportion}")
        stats = {"loss": mean_loss, "acc": mean_acc, "losses": losses,
                 "clips_per_sec": clips / dt, "dataloader_share": share}
        if self.fourstream and per_step is not None:
            stats["stream_losses"] = per_step.tolist()
        return stats

    def _start_profiler(self):
        from torch.profiler import (ProfilerAction, ProfilerActivity,
                                    profile, tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        rank = 0 if self.mesh is None else self.mesh.rank
        profiler = profile(
            activities=activities,
            # a schedule, so that each step() closes a ProfilerStep span;
            # stop() writes the trace
            schedule=lambda step: ProfilerAction.RECORD,
            on_trace_ready=tensorboard_trace_handler(
                self.cfg.profile_dir, worker_name=f"rank{rank}"))
        profiler.start()
        return profiler

    def _write_trace(self, profiler) -> None:
        """Stop ``profiler`` once the device has finished the traced
        steps, which writes the trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        self.logger.log(
            f"\tProfiler trace written to {self.cfg.profile_dir}")

    def _guard_device(self, epoch_stats: Dict[str, float]) -> None:
        """After a train epoch: an implausibly fast epoch or a non-finite
        mean loss triggers the device check; a device that stays
        unhealthy cannot be trusted to save the train state, so the run
        restarts in a fresh process from its last checkpoint (reference
        package trainer.py:743-768)."""
        if not self.cfg.device_guard:
            return
        suspicious = (
            not device_guard.plausible_throughput(
                epoch_stats.get("clips_per_sec", 0.0)
                / self.world)
            or not np.isfinite(epoch_stats.get("loss", 0.0)))
        if not suspicious:
            return
        self.logger.log(
            "\tSuspicious epoch reading "
            f"({epoch_stats.get('clips_per_sec', 0):.0f} clips/s, "
            f"loss={epoch_stats.get('loss', float('nan'))}); "
            "checking device health")
        try:
            device_guard.check(logger=self.logger, device=self.device)
        except device_guard.DeviceUnhealthyError:
            if self.mesh is not None:
                # a re-exec restarts this process alone, not the group
                raise
            device_guard.reexec_with_resume(logger=self.logger,
                                            device=self.device)

    def evaluate(self, epoch: int, wrong_file: Optional[str] = None,
                 result_file: Optional[str] = None) -> float:
        """Score the test split.  Under fourstream the pickles are the
        ensemble's (best_acc.pkl, epoch_<e>_<acc>.pkl) plus each stream's
        (epoch_<e>_<stream>.pkl, and best_acc_<stream>.pkl beside every
        write of best_acc.pkl), and the wrong/right files hold the
        ensemble's predictions (reference package trainer.py:770-884)."""
        self.check_shift_range()
        cfg = self.cfg
        self.logger.log(f"Eval epoch: {epoch + 1}"
                        + (" (four-stream)" if self.fourstream else ""))
        feeder = self.feeders["test"]
        outputs = []
        for data, label, index, mask in self.iterators["test"].epoch(0):
            data, label, index, mask = self._local(data, label, index, mask)
            batch = self._put_batch(data, label, mask)
            if self.fourstream:
                logits4, logits, lsum, n = fourstream.eval_step(
                    self.models, batch, self.parents)
            else:
                logits, lsum, n = state_lib.eval_step(self.model, batch)
                logits4, lsum, n = logits[None], lsum[None], n[None]
            outputs.append((logits4.transpose(0, 1), logits,
                            torch.cat([lsum.double(), n.double()])[None],
                            label, index, mask))
        # per row: stream logits (B, S, K), logits, label, index, mask; per
        # batch: loss and mask sums (1, 2S)
        logits4, logits, sums, label, index, mask = (
            np.concatenate([o.cpu().numpy() if torch.is_tensor(o) else o
                            for o in column]) for column in zip(*outputs))
        if self.mesh is not None and self.mesh.data > 1:
            logits4, logits, sums, label, index, mask = self.mesh.gather_rows(
                [logits4, logits, sums, label, index, mask])
        valid = mask > 0
        # dataset order: the data ranks' rows interleave
        order = np.argsort(index[valid], kind="stable")
        score = logits[valid][order]
        stream_scores = logits4[valid][order].transpose(1, 0, 2)
        label, index = label[valid][order], index[valid][order]
        n_streams = logits4.shape[1]
        loss_sum = sums[:, :n_streams].sum(0)
        n_sum = float(sums[:, n_streams].sum())
        if self.rank0 and (wrong_file or result_file):
            with ExitStack() as files:
                f_w = f_r = None
                if wrong_file:
                    f_w = files.enter_context(open(wrong_file, "w"))
                if result_file:
                    f_r = files.enter_context(open(result_file, "w"))
                preds = score.argmax(-1)
                for i in range(len(score)):
                    if f_r:
                        f_r.write(f"{preds[i]},{label[i]}\n")
                    if f_w and preds[i] != label[i]:
                        f_w.write(f"{index[i]},{preds[i]},{label[i]}\n")
        accuracy = feeder.top_k(score, 1)
        eval_dir = os.path.join(self.work_dir, "eval_results")

        def dump(scores_, name):
            if self.rank0:
                with open(os.path.join(eval_dir, name), "wb") as f:
                    pickle.dump(dict(zip(feeder.sample_name, scores_)), f)

        if self.fourstream:
            for stream, s in zip(fourstream.STREAMS, stream_scores):
                i = fourstream.STREAMS.index(stream)
                self.logger.log(
                    f"\t{stream}: loss {loss_sum[i] / max(n_sum, 1):.4f}  "
                    f"top1 {100 * feeder.top_k(s, 1):.2f}%")
                dump(s, f"epoch_{epoch}_{stream}.pkl")
            self.logger.log(f"\tensemble top1: {100 * accuracy:.2f}%")
        else:
            self.logger.log(
                f"\tMean test loss: {loss_sum[0] / max(n_sum, 1):.4f}.")
        if accuracy > self.best_acc or not os.path.exists(
                os.path.join(eval_dir, "best_acc.pkl")):
            # on improvement, or to restore a best pickle that is gone
            # (best_acc keeps the historical value then)
            self.best_acc = max(self.best_acc, accuracy)
            dump(score, "best_acc.pkl")
            if self.fourstream:
                for stream, s in zip(fourstream.STREAMS, stream_scores):
                    dump(s, f"best_acc_{stream}.pkl")
        for k in cfg.show_topk:
            self.logger.log(f"\tTop{k}: {100 * feeder.top_k(score, k):.2f}%")
        dump(score, f"epoch_{epoch}_{accuracy}.pkl")
        self._barrier()
        return accuracy

    def check_shift_range(self) -> None:
        """Every ypos must stay inside the tap radius of the run's
        lowering (``max_shift``), which the kernels agree with by
        construction (reference package trainer.py:886-901).  A family
        without shifts has no ypos to check."""
        models = self.models if self.fourstream else {"": self.model}
        for stream, model in models.items():
            check_shift_range(
                ((f"{stream}.{name}" if stream else name, param)
                 for name, param in model.named_parameters()),
                self.lowering.max_shift)

    def save(self, epoch: int) -> str:
        self.check_shift_range()
        path = ckpt_lib.checkpoint_path(self.save_dir,
                                        self.cfg.Experiment_name, epoch,
                                        self.global_step)
        # under tensor parallelism every rank gathers its slices
        if self.rank0 or self._tensor_parallel:
            models = self.models if self.fourstream else {"": self.model}
            optimizers = (self.optimizers if self.fourstream
                          else {"": self.optimizer})
            entries = {
                stream: (tensor.full_entry(model, optimizers[stream],
                                           self.mesh)
                         if self._tensor_parallel
                         else ckpt_lib.resume_entry(model,
                                                    optimizers[stream]))
                for stream, model in models.items()}
            if self.rank0:
                ckpt_lib.write_checkpoint(
                    self.save_dir, self.cfg.Experiment_name, epoch,
                    self.global_step, float(self.best_acc),
                    entries if self.fourstream else entries[""])
                self.logger.log(f"\tSaved checkpoint: {path}")
        self._barrier()
        return path
