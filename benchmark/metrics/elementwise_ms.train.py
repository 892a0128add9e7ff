"""Device ms per step in PyTorch's elementwise and reduction kernels
(every kernel that is neither the port's, a library's nor a copy), in
the profiled epoch of rank 0.  A fused BN moves it."""

from benchmark.metrics import _common


def read(ctx):
    prof = _common.profile(ctx)
    if ctx.get("kind") != "train" or prof is None:
        return None
    return 1e3 * _common.other_seconds(prof, ctx["kernel_names"]) / \
        prof["units"]
