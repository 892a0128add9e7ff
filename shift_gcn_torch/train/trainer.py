"""Single-process Trainer: the reference Processor (main.py:172-546) on
one device.

Behavior follows the reference package's trainer: per-epoch step-decay
LR with warmup (main.py:342-353), the per-parameter weight-decay table
(main.py:307-317), the save / eval cadence, the best-accuracy and
per-epoch score pickles the ensemble tools read (main.py:493-515), the
wrong/right prediction files of the test phase (main.py:534-546), resume
from the newest checkpoint (``resume: auto``), and the shift tap-radius
check at every save and eval.  Checkpoints are the reference's torch
resume dicts (``utils/checkpoint.py``).

``device`` defaults to CUDA, where the model runs the hand-written
kernels; ``device="cpu"`` runs their plain versions and must be asked
for.  With bf16 transfer (``transfer_dtype``, 'auto' under bf16
activations) each batch is rounded to bf16 on the host, moved, and cast
back to fp32 on the device before ``data_bn``, as the reference package
does.
"""

from __future__ import annotations

import dataclasses
import glob
import inspect
import os
import pickle
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from shift_gcn_torch.data.feeder import BatchIterator, Feeder
from shift_gcn_torch.models import shift_gcn
from shift_gcn_torch.ops.temporal_shift import assert_in_range
from shift_gcn_torch.train import config as config_lib
from shift_gcn_torch.train import state as state_lib
from shift_gcn_torch.train.optim import build_optimizer, step_decay_lr
from shift_gcn_torch.utils import checkpoint as ckpt_lib
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


class Trainer:
    def __init__(self, cfg: config_lib.ExperimentConfig, device="cuda"):
        config_lib.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.work_dir = cfg.resolved_work_dir()
        self.save_dir = cfg.resolved_save_dir()
        self.logger = RunLogger(self.work_dir, to_file=cfg.print_log)
        os.makedirs(os.path.join(self.work_dir, "eval_results"),
                    exist_ok=True)
        # the model source beside the run (reference: main.py:257)
        shutil.copy2(inspect.getfile(shift_gcn), self.work_dir)

        # resolve `resume: auto` before any overwrite cleanup, so a rerun
        # never deletes the checkpoint it is about to continue from
        resume = cfg.resume
        if resume == "auto":
            resume = ckpt_lib.latest_checkpoint(self.save_dir)
            if resume:
                self.logger.log(f"Auto-resume found checkpoint: {resume}")
        self._resume_path = resume
        if cfg.phase == "train" and cfg.overwrite:
            self._cleanup_previous_run()

        self.model_config = shift_gcn.config_from_reference_args(
            cfg.model_args)
        if cfg.activation_dtype:
            self.model_config = dataclasses.replace(
                self.model_config, activation_dtype=cfg.activation_dtype)
        config_lib.save_config(cfg, os.path.join(self.work_dir,
                                                 "config.yaml"))
        self.transfer_dtype = resolve_transfer_dtype(
            cfg.transfer_dtype, self.model_config.activation_dtype)

        self.model = shift_gcn.Model(self.model_config, device=self.device)
        self.model.init_weights(torch.Generator().manual_seed(cfg.seed))
        self.optimizer = build_optimizer(self.model, cfg.base_lr)
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
        if cfg.phase == "train":
            self.feeders["train"] = Feeder(**cfg.train_feeder_args)
            self.iterators["train"] = BatchIterator(
                self.feeders["train"], cfg.batch_size, shuffle=True,
                drop_last=True, seed=cfg.seed)
        self.feeders["test"] = Feeder(**cfg.test_feeder_args)
        self.iterators["test"] = BatchIterator(
            self.feeders["test"], cfg.test_batch_size, shuffle=False,
            drop_last=False, seed=cfg.seed)

    def _put_batch(self, data: np.ndarray, label: np.ndarray,
                   mask: Optional[np.ndarray] = None
                   ) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors; data arrives fp32 on the device."""
        x = torch.from_numpy(data).to(self.transfer_dtype)
        batch = {"data": x.to(self.device).float(),
                 "label": torch.from_numpy(label).long().to(self.device)}
        if mask is not None:
            batch["mask"] = torch.from_numpy(mask).to(self.device)
        return batch

    def _load_weights(self, path: str, ignore: Optional[list] = None) -> None:
        """Load model weights from a reference .pt / .pkl / .pth
        (main.py:261-292): keys named in ``ignore`` are dropped, missing
        keys are reported and keep their initial values."""
        self.logger.log(f"Load weights from {path}.")
        if not path.endswith((".pt", ".pkl", ".pth")):
            raise ValueError(f"weights {path!r}: expected a .pt, .pkl or "
                             ".pth file")
        weights, _ = ckpt_lib.load_reference_checkpoint(path)
        for name in ignore or []:
            for k in [k for k in weights if name in k]:
                weights.pop(k)
                self.logger.log(f"Successfully Remove Weights: {k}.")
        own = self.model.state_dict()
        missing = sorted(set(own) - set(weights))
        if missing:
            self.logger.log("Can not find these weights:")
            for k in missing:
                self.logger.log("  " + k)
        for k, v in weights.items():
            if k in own and own[k].shape != v.shape:
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(own[k].shape)} vs {tuple(v.shape)}")
        self.model.load_state_dict(
            {k: v for k, v in weights.items() if k in own}, strict=False)

    def _resume(self, path: str) -> None:
        # reference: main.py:215-229
        self.logger.log(f"Resuming from checkpoint: {path}")
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["model_state_dict"], strict=True)
        self.optimizer.load_state_dict(blob["optimizer_state_dict"])
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
                self.train_epoch(epoch)
                if is_last or (epoch + 1) % cfg.save_interval == 0:
                    self.save(epoch)
                if is_last or (epoch + 1) % cfg.eval_interval == 0:
                    self.evaluate(epoch)
            if not os.path.exists(os.path.join(
                    self.work_dir, "eval_results", "best_acc.pkl")):
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

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.logger.log(f"Training epoch: {epoch + 1}")
        lr = step_decay_lr(epoch, cfg.base_lr, cfg.step, cfg.warm_up_epoch)
        it = self.iterators["train"]
        nb = it.batches_per_epoch()
        timer = {"dataloader": 1e-3, "model": 1e-3}
        # per-step metrics stay on the device until the epoch ends: reading
        # one would wait for the device every step
        losses, accs = [], []
        t0 = mark = time.time()
        for b, (data, label, _, _) in enumerate(it.epoch(epoch)):
            batch = self._put_batch(data, label)
            now = time.time()
            timer["dataloader"] += now - mark
            loss, acc = state_lib.train_step(self.model, self.optimizer,
                                             batch, lr)
            losses.append(loss)
            accs.append(acc)
            self.global_step += 1
            if self.global_step % cfg.log_interval == 0:
                self.logger.log(f"\tBatch({b}/{nb}) done. Loss: "
                                f"{float(loss):.4f}  lr:{lr:.6f}")
            mark = time.time()
            timer["model"] += mark - now
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timer["model"] += time.time() - mark
        dt = time.time() - t0
        losses = torch.stack(losses).tolist() if losses else []
        accs = torch.stack(accs).tolist() if accs else []
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        mean_acc = float(np.mean(accs)) if accs else float("nan")
        total = sum(timer.values())
        proportion = {k: f"{int(round(v * 100 / total)):02d}%"
                      for k, v in timer.items()}
        clips = nb * cfg.batch_size
        self.logger.log(
            f"\tMean training loss: {mean_loss:.4f}  acc: {mean_acc:.4f}  "
            f"({clips / max(dt, 1e-9):.1f} clips/s)  time: {proportion}")
        return {"loss": mean_loss, "acc": mean_acc, "losses": losses,
                "clips_per_sec": clips / max(dt, 1e-9),
                "dataloader_share": timer["dataloader"] / total}

    def evaluate(self, epoch: int, wrong_file: Optional[str] = None,
                 result_file: Optional[str] = None) -> float:
        self.check_shift_range()
        cfg = self.cfg
        self.logger.log(f"Eval epoch: {epoch + 1}")
        feeder = self.feeders["test"]
        outputs = []
        for data, label, index, mask in self.iterators["test"].epoch(0):
            logits, lsum, n = state_lib.eval_step(
                self.model, self._put_batch(data, label, mask))
            outputs.append((logits, lsum, n, label, index, mask))
        scores = []
        loss_sum = n_sum = 0.0
        f_w = open(wrong_file, "w") if wrong_file else None
        f_r = open(result_file, "w") if result_file else None
        try:
            for logits, lsum, n, label, index, mask in outputs:
                logits = logits.cpu().numpy()
                valid = mask > 0
                scores.append(logits[valid])
                loss_sum += float(lsum)
                n_sum += float(n)
                if f_w or f_r:
                    preds = logits.argmax(-1)
                    for i in np.nonzero(valid)[0]:
                        if f_r:
                            f_r.write(f"{preds[i]},{label[i]}\n")
                        if f_w and preds[i] != label[i]:
                            f_w.write(f"{index[i]},{preds[i]},{label[i]}\n")
        finally:
            if f_w:
                f_w.close()
            if f_r:
                f_r.close()
        score = np.concatenate(scores)
        accuracy = feeder.top_k(score, 1)
        score_dict = dict(zip(feeder.sample_name, score))
        eval_dir = os.path.join(self.work_dir, "eval_results")
        best_pkl = os.path.join(eval_dir, "best_acc.pkl")
        if accuracy > self.best_acc or not os.path.exists(best_pkl):
            # on improvement, or to restore a best pickle that is gone
            # (best_acc keeps the historical value then)
            self.best_acc = max(self.best_acc, accuracy)
            with open(best_pkl, "wb") as f:
                pickle.dump(score_dict, f)
        self.logger.log(f"\tMean test loss: {loss_sum / max(n_sum, 1):.4f}.")
        for k in cfg.show_topk:
            self.logger.log(f"\tTop{k}: {100 * feeder.top_k(score, k):.2f}%")
        with open(os.path.join(eval_dir, f"epoch_{epoch}_{accuracy}.pkl"),
                  "wb") as f:
            pickle.dump(score_dict, f)
        return accuracy

    def check_shift_range(self) -> None:
        """Every ypos must stay inside the reference lowering's tap
        radius, which the kernels agree with by construction."""
        for name, param in self.model.named_parameters():
            if name.endswith("ypos"):
                assert_in_range(param, name)

    def save(self, epoch: int) -> str:
        self.check_shift_range()
        path = ckpt_lib.save_checkpoint(
            self.save_dir, self.cfg.Experiment_name, epoch, self.global_step,
            float(self.best_acc), self.model, self.optimizer)
        self.logger.log(f"\tSaved checkpoint: {path}")
        return path
