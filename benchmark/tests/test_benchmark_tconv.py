"""2s-AGCN's 9-tap temporal conv readings: the name file
(``metrics/kernel_names/agcn_tconv.json``) and the two readers
(``temporal_conv_ms.train``, ``temporal_conv_roofline.train``) on toy
profiles.  The convs' kernels match no other group, so that the
elementwise remainder leaves them out and no accepted cell's reading
moves; the readers read nothing where the profile holds none of them (a
commit before the kernels) or the family runs no such conv."""

import json

import pytest

from benchmark import costs, manifest

CELL = "agcn_ntu60_train_b64"
METRICS = ["temporal_conv_ms.train", "temporal_conv_roofline.train"]
# the kernels as the profiler names them (csrc/agcn_tconv.cu)
FORWARD = ["void (anonymous namespace)::agcn_tconv_forward_kernel<2>"
           "((anonymous namespace)::ConvArgs)",
           "(anonymous namespace)::agcn_tconv_forward_pack_kernel("
           "float const*, uint4*, int, int, int, int, int, int)"]
BACKWARD = ["void (anonymous namespace)::agcn_tconv_backward_data_kernel<1>"
            "((anonymous namespace)::ConvArgs)",
            "(anonymous namespace)::agcn_tconv_backward_pack_kernel("
            "float const*, uint4*, int, int, int, int, int, int)",
            "(anonymous namespace)::agcn_tconv_backward_weight_kernel("
            "float const*, float const*, float*, float*, int, int, int, "
            "int, int, int, int)",
            "(anonymous namespace)::agcn_tconv_backward_weight_final_kernel("
            "float const*, float const*, float*, float*, int, int, int)"]
# what else a 2s-AGCN step's profile holds: cuDNN's convs (a commit
# before the kernels), cuBLAS, the adjacency and BN kernels, stock ops
OTHERS = {"cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>":
          0.5,
          "wgrad_alg0_engine_NHWC<float, 128, 6, 8, 3, 3, 5, false, 512>":
          0.25,
          "sm80_xmma_fprop_implicit_gemm_indexed_f32f32": 0.2,
          "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n": 0.3,
          "agcn_adjacency_backward_kernel": 0.01,
          "bnorm_stats_kernel<float>": 0.02,
          "void at::native::vectorized_elementwise_kernel<4, add>": 0.1}
UNITS = 26


def config_of(name: str) -> dict:
    return json.loads((manifest.ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def context(kernels: dict, config="agcn_ntu60_xsub", kind="train") -> dict:
    prof = {"kernels": kernels, "busy_s": 1.0, "window_s": 1.0, "gaps": [],
            "units": UNITS, "host_cost_s": 0.0}
    return {"kind": kind, "config": config_of(config), "dtype": "float32",
            "world": 1, "batch": 64,
            "peaks": manifest.peaks("NVIDIA H100 80GB HBM3"),
            "kernel_names": manifest.kernel_names(), "profiles": [prof]}


def with_convs(seconds=(0.8, 0.3, 0.5, 0.01, 0.9, 0.02)) -> dict:
    return {**OTHERS, **dict(zip(FORWARD + BACKWARD, seconds))}


def read(name, ctx):
    return manifest.metric_reader(name)(ctx)


def test_the_name_file_holds_two_groups_of_its_own():
    names = manifest.kernel_names()
    assert names["tconv"] == ["agcn_tconv_forward"]
    assert names["tconv_grad"] == ["agcn_tconv_backward"]
    other = [p for group, patterns in names.items()
             if group not in ("tconv", "tconv_grad") for p in patterns]
    for kernel in FORWARD + BACKWARD:
        assert not [p for p in other if p in kernel], kernel
    for kernel in OTHERS:
        assert "agcn_tconv" not in kernel


@pytest.mark.parametrize("group, kernels", [("tconv", FORWARD),
                                            ("tconv_grad", BACKWARD)])
def test_each_kernel_lands_in_its_group_alone(group, kernels):
    names = manifest.kernel_names()
    for kernel in kernels:
        assert [g for g, patterns in names.items()
                if any(p in kernel for p in patterns)] == [group]


def test_elementwise_leaves_the_convs_out():
    """The stock-op remainder of a profile with the conv kernels equals
    that of the same profile without them."""
    with_kernels = read("elementwise_ms.train", context(with_convs()))
    without = read("elementwise_ms.train", context(dict(OTHERS)))
    assert with_kernels == pytest.approx(without)
    # cuDNN's wgrad engine, which no pattern names, is counted there, as
    # are the BN kernels and the stock add
    assert without == pytest.approx(1e3 * (0.25 + 0.02 + 0.1) / UNITS)


def test_ms_reads_the_conv_kernels_a_step():
    seconds = (0.8, 0.3, 0.5, 0.01, 0.9, 0.02)
    got = read("temporal_conv_ms.train", context(with_convs(seconds)))
    assert got == pytest.approx(1e3 * sum(seconds) / UNITS)


def test_roofline_is_the_convs_bound_over_their_time():
    """4.67 TFLOP and 16.2 GB a step of 64 clips: the bound at the TF32
    rate, 9.48 ms, over the kernels' device time."""
    config = config_of("agcn_ntu60_xsub")
    reader = manifest.metric_reader("temporal_conv_roofline.train")
    ops = reader.__globals__["conv_ops"](config, 64, 4)
    assert [op for op, _, _ in ops] == ["tconv", "tconv_grad",
                                        "tconv_grad"] * 10
    flops = sum(f for _, _, f in ops)
    # per unit 2 N'V T' C^2 9, three times; N'V = 3200
    hand = 3 * 2 * 3200 * 9 * (4 * 300 * 64 ** 2 + 150 * 128 ** 2
                               + 2 * 150 * 128 ** 2 + 75 * 256 ** 2
                               + 2 * 75 * 256 ** 2)
    assert flops == hand == pytest.approx(4.6714e12, rel=1e-4)
    peaks = manifest.peaks("NVIDIA H100 80GB HBM3")
    bound = costs.bound_s(ops, peaks, "float32")
    # FLOPs at the TF32 rate but where an op's bytes take longer (unit
    # 1-4's weight gradient: 0.49 GB against 70.8 GFLOP)
    assert bound == pytest.approx(sum(max(b / 3.35e12, f / 495e12)
                                      for _, b, f in ops))
    assert flops / 495e12 < bound < 1.01 * flops / 495e12
    seconds = (0.8, 0.3, 0.5, 0.01, 0.9, 0.02)
    got = read("temporal_conv_roofline.train", context(with_convs(seconds)))
    assert got == pytest.approx(100 * bound * UNITS / sum(seconds))


@pytest.mark.parametrize("name", METRICS)
def test_readers_read_nothing_without_the_kernels(name):
    """A profile of a commit before the kernels (cuDNN's convs), another
    family's cell, a report cell, or no profile: None, and no error."""
    assert read(name, context(dict(OTHERS))) is None
    assert read(name, context(with_convs(), kind="report")) is None
    ctx = context(with_convs())
    ctx["profiles"] = [None]
    assert read(name, ctx) is None


def test_roofline_reads_nothing_for_another_family():
    assert read("temporal_conv_roofline.train",
                context(with_convs(), config="ntu60_xsub")) is None


def test_the_manifest_lists_both_for_the_cell_alone():
    entries = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for name in METRICS:
        entry = entries[name]
        assert entry["workloads"] == [CELL]
        assert entry["layer"] == "port kernels"
        assert entry["moves"] == "train_clips_per_s"
        assert entry["source"] == "device_trace"
