"""Clips of every whole epoch of the window over its time, as
``train_clips_per_s`` takes them, in a training cell whose rate is set
by the host's dispatch: there the host's speed moves it by more than
any bound could hold, so it is read per layer."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["clips_per_s"]
