"""One-off check of the synthetic multi-GPU runs' chance-level evaluation
(scripts/torch_multigpu_smoke.sh): the reference package and the port
train the full-width MediaPipe model (configs/mediapipe/train_seqpar.yaml's
model, fp32, one process) from the same initial weights for 16 steps at
lr 0.1 on that script's clip generator, at a reduced T, then score the
same validation clips in eval mode (BN's running statistics).

    python tests/torch_eval_lag_check.py [--t 64] [--batch 8]

Prints, for each side, the eval logits' largest magnitude, the top-1
accuracy and the mean test loss, the train-mode logits' largest
magnitude on the same clips (batch statistics), and the gap between the
two sides' eval logits.  The two runs agree step for step only up to the
first constraint tie (docs/PARITY.md), so the comparison is of the
envelope: the same order of magnitude and the same accuracy."""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from shift_gcn_tpu.models import shift_gcn as jax_model  # noqa: E402
from shift_gcn_tpu.train import state as jax_state  # noqa: E402
from shift_gcn_tpu.train.optim import build_weight_decay_tree  # noqa: E402
from shift_gcn_torch.models.shift_gcn import (  # noqa: E402
    Model, config_from_reference_args)
from shift_gcn_torch.train import optim, state  # noqa: E402
from shift_gcn_torch.utils.checkpoint import (  # noqa: E402
    state_dict_from_arrays)

MODEL_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
              "graph": "mediapipe_pose"}
STEPS, LR = 16, 0.1


def clips(rng, n, t):
    """scripts/torch_multigpu_smoke.sh's generator at T=t."""
    labels = rng.integers(0, 2, n)
    data = (rng.standard_normal((n, 3, t, 33, 1)) * 0.1).astype(np.float32)
    data[:, 0] += (labels * 0.3)[:, None, None, None].astype(np.float32)
    return data, labels.astype(np.int32)


def summary(name, eval_logits, train_logits, labels):
    logp = eval_logits - np.log(np.exp(
        eval_logits - eval_logits.max(1, keepdims=True)).sum(1, keepdims=True)
    ) - eval_logits.max(1, keepdims=True)
    loss = float(-logp[np.arange(len(labels)), labels].mean())
    top1 = float((eval_logits.argmax(1) == labels).mean())
    print(f"{name}: eval logits max |.| {np.abs(eval_logits).max():.6g}, "
          f"top-1 {100 * top1:.2f}%, test loss {loss:.6g}; train-mode "
          f"logits on the same clips max |.| "
          f"{np.abs(train_logits).max():.6g}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    torch.backends.mkldnn.enabled = False
    rng = np.random.default_rng(0)
    train, train_labels = clips(rng, STEPS * args.batch, args.t)
    val, val_labels = clips(rng, 4 * args.batch, args.t)

    cfg = jax_model.config_from_reference_args(MODEL_ARGS)
    jstate = jax_state.create_train_state(jax.random.key(1), cfg)
    model = Model(config_from_reference_args(MODEL_ARGS), device="cpu")
    model.load_state_dict(state_dict_from_arrays(*(
        jax.tree_util.tree_map(np.asarray, t)
        for t in (jstate.params, jstate.bn_state))))
    step = jax.jit(jax_state.make_train_step(
        cfg, build_weight_decay_tree(jstate.params)))
    opt = optim.build_optimizer(model, LR)
    for i in range(STEPS):
        rows = slice(i * args.batch, (i + 1) * args.batch)
        jstate, metrics = step(jstate, {"data": jnp.asarray(train[rows]),
                                        "label": jnp.asarray(
                                            train_labels[rows])},
                               jnp.float32(LR))
        loss, _ = state.train_step(model, opt, {
            "data": torch.from_numpy(train[rows]),
            "label": torch.from_numpy(train_labels[rows]).long()}, LR)
        print(f"step {i}: loss reference {float(metrics['loss']):.6g}, "
              f"port {float(loss):.6g}")

    evaluate = jax.jit(jax_state.make_eval_step(cfg))
    j_eval, _, _ = evaluate(jstate.params, jstate.bn_state, {
        "data": jnp.asarray(val), "label": jnp.asarray(val_labels),
        "mask": jnp.ones(len(val_labels))})
    j_train, _ = jax.jit(lambda p, s, x: jax_model.apply(
        p, s, x, cfg, training=True))(jstate.params, jstate.bn_state,
                                      jnp.asarray(val))
    t_eval, _, _ = state.eval_step(model, {
        "data": torch.from_numpy(val),
        "label": torch.from_numpy(val_labels).long()})
    model.train()
    with torch.no_grad():
        t_train = model(torch.from_numpy(val))
    j_eval, j_train = np.asarray(j_eval), np.asarray(j_train)
    t_eval, t_train = t_eval.numpy(), t_train.numpy()
    summary("reference", j_eval, j_train, val_labels)
    summary("port", t_eval, t_train, val_labels)
    gap = np.abs(j_eval - t_eval).max() / np.abs(j_eval).max()
    print(f"eval logits: max |reference - port| {gap:.6g} of the "
          f"reference's scale; predictions equal on "
          f"{int((j_eval.argmax(1) == t_eval.argmax(1)).sum())} of "
          f"{len(val_labels)} clips")


if __name__ == "__main__":
    main()
