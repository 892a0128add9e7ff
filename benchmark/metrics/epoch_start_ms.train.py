"""The median time from the entry to ``Trainer.train_epoch`` until its
first batch is in hand (the program's ``train.epoch_start`` span), in
ms, over the run's epochs."""

from benchmark.metrics import _spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return _spans.median_ms("train.epoch_start")
