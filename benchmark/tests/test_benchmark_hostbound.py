"""The per-layer metrics of a host-bound training cell
(``metrics/*.train_hostbound.py``): each reads what its ``.train``
namesake reads, and the rate reads the window's clips/s."""

import json

import pytest

from benchmark import manifest
from shift_gcn_torch.utils import trace

HOSTBOUND = sorted(m["name"] for m in manifest.load_manifest()["per_layer"]
                   if m["name"].endswith(".train_hostbound"))
NAMESAKES = [n for n in HOSTBOUND if not n.startswith("clips_per_s.")]


def context(profiled: bool) -> dict:
    config = json.loads((manifest.ROOT / "benchmark" / "configs"
                         / "mediapipe_fall.json").read_text())
    prof = {"kernels": {"shift_gcn_mma_kernel<float>": 0.004,
                        "tshift_forward_kernel<float>": 0.002,
                        "sm80_xmma_gemm_f32": 0.003,
                        "vectorized_elementwise_kernel": 0.005},
            "busy_s": 0.75, "window_s": 1.25, "gaps": [], "units": 26,
            "host_cost_s": 0.0}
    return {"kind": "train", "config": config, "clips_per_s": 1234.5,
            "window": {"loader_share": 0.0125}, "dtype": "bfloat16",
            "world": 1, "batch": 64,
            "peaks": manifest.peaks("NVIDIA H100 80GB HBM3"),
            "kernel_names": manifest.kernel_names(),
            "profiles": [prof if profiled else None]}


def test_every_train_metric_has_a_host_bound_namesake():
    train = sorted(m["name"] for m in manifest.load_manifest()["per_layer"]
                   if m["name"].endswith(".train"))
    assert [n.replace(".train_hostbound", ".train") for n in NAMESAKES] \
        == train


@pytest.mark.parametrize("profiled", [True, False])
@pytest.mark.parametrize("name", NAMESAKES)
def test_a_namesake_reads_as_its_train_metric(name, profiled):
    trace.reset()
    with trace.span("train.epoch_start"):
        pass
    ctx = context(profiled)
    base = manifest.metric_reader(name.replace(".train_hostbound",
                                               ".train"))(ctx)
    assert manifest.metric_reader(name)(ctx) == base
    assert manifest.metric_reader(name)(dict(ctx, kind="report")) is None
    trace.reset()


def test_the_rate_is_the_windows():
    read = manifest.metric_reader("clips_per_s.train_hostbound")
    assert read(context(False)) == 1234.5
    assert read(dict(context(False), kind="report")) is None
