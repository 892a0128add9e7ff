"""Helpers that the per-layer readers share: the rank-0 profile, kernel
time by group, and the elementwise remainder."""

from benchmark import costs

PORT_OPS = ("K1", "K23", "K4", "K5", "K6")


def profile(ctx):
    profiles = ctx.get("profiles") or []
    return profiles[0] if profiles and profiles[0] else None


def _matches(name, patterns):
    return any(p in name for p in patterns)


def group_seconds(prof, names, groups):
    patterns = [p for g in groups for p in names.get(g, [])]
    return sum(s for k, s in prof["kernels"].items() if _matches(k, patterns))


def other_seconds(prof, names):
    """Kernels that are neither the port's, a library's (cuBLAS, cuDNN,
    NCCL) nor a copy: PyTorch's elementwise and reduction kernels."""
    known = [p for patterns in names.values() for p in patterns]
    return sum(s for k, s in prof["kernels"].items()
               if not _matches(k, known))


def roofline_pct(ctx, ops_list, groups):
    """Bound time of the ops over the device time of the groups'
    kernels, in percent; None without a profile, peaks or kernel time."""
    prof = profile(ctx)
    if prof is None or ctx.get("peaks") is None:
        return None
    spent = group_seconds(prof, ctx["kernel_names"], groups)
    if spent <= 0:
        return None
    dtype = ctx["dtype"]
    return 100.0 * costs.bound_s(ops_list, ctx["peaks"], dtype) / spent


def idle_pct(ctx):
    profiles = [p for p in ctx.get("profiles") or [] if p]
    if not profiles:
        return None
    return 100.0 * sum(1.0 - p["busy_s"] / p["window_s"]
                       for p in profiles) / len(profiles)
