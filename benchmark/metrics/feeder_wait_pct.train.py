"""The share of the window's epochs that the Trainer's step loop spent
waiting for its prefetch thread's next batch (``Trainer.train_epoch``'s
``dataloader`` timer over its epoch time; rank 0 on several cards)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return 100.0 * ctx["window"]["loader_share"]
