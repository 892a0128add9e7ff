"""The plain reference against the port, on the CPU at small sizes (the
port runs its kernels' plain versions there)."""

import json

import numpy as np
import pytest
import torch

from benchmark import checks, generate, weights
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train
from benchmark.tests import toy


def configs():
    return {name: toy.small_config(json.loads(
        (toy.ROOT / "benchmark" / "configs" / f"{name}.json").read_text()))
        for name in ("mediapipe_fall", "ntu60_xsub")}


def port_model(config, state):
    from shift_gcn_torch.models.shift_gcn import (Model,
                                                  config_from_reference_args)

    model = Model(config_from_reference_args(config["model_args"]),
                  device="cpu")
    model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("name", ["mediapipe_fall", "ntu60_xsub"])
def test_eval_forward_matches_the_port(name, cpu_torch):
    config = configs()[name]
    state = weights.make(config, 3, "cpu")
    clips, _ = generate.clips(config, 6, 4)
    x = torch.from_numpy(clips)
    with torch.no_grad():
        port = port_model(config, state).eval()(x)
        mine = ref_model.forward(state, x, config, False)
    assert torch.allclose(port, mine, rtol=1e-5, atol=1e-5 * port.abs().max())


@pytest.mark.parametrize("name", ["mediapipe_fall", "ntu60_xsub"])
def test_three_training_steps_match_the_port(name, cpu_torch):
    from shift_gcn_torch.train import state as step_lib
    from shift_gcn_torch.train.optim import build_optimizer

    config = configs()[name]
    state = weights.make(config, 5, "cpu")
    model = port_model(config, state)
    optimizer = build_optimizer(model, config["train"]["base_lr"])
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    outputs = []
    model.register_forward_hook(
        lambda module, inputs, out: outputs.append(out.detach().numpy()))
    batches = [generate.clips(config, 8, s) for s in (10, 11, 12)]
    losses = []
    for i, (x, y) in enumerate(batches):
        loss, _ = step_lib.train_step(
            model, optimizer, {"data": torch.from_numpy(x),
                               "label": torch.from_numpy(y)},
            config["train"]["base_lr"])
        losses.append(float(loss))
        if i == 0:
            first = {k: float(optimizer.state[p]["momentum_buffer"].norm())
                     for k, p in model.named_parameters()}
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in model.named_parameters()}
    ref = ref_train.steps(state, batches, config,
                          config["train"]["base_lr"], "cpu")
    numbers = checks.train_numbers(
        {"losses": losses, "first_grad": first, "change": change,
         "logits": outputs[0], "clips": 8}, ref)
    # fp32 both sides: rounding apart (position steps may flip sign where
    # their gradient is within rounding of zero)
    assert numbers["loss_gap"] < 1e-5 and numbers["clip_loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 5e-2


def test_float32_reference_is_within_rounding_of_float64(cpu_torch):
    config = configs()["mediapipe_fall"]
    state = weights.make(config, 6, "cpu")
    batches = [generate.clips(config, 8, s) for s in (1, 2)]
    lr = config["train"]["base_lr"]
    r32 = ref_train.steps(state, batches, config, lr, "cpu")
    r64 = ref_train.steps(state, batches, config, lr, "cpu",
                          dtype=torch.float64)
    numbers = checks.train_numbers(r32, r64)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4


def test_report_path_matches_the_port(cpu_torch):
    from shift_gcn_torch.data.modalities import derive_modalities
    from shift_gcn_torch.data.preprocess import pre_normalization
    from shift_gcn_torch.graphs import get_graph
    from shift_gcn_torch.inference import pipeline
    from shift_gcn_torch.models.shift_gcn import config_from_reference_args

    from benchmark.drivers import report

    config = configs()["mediapipe_fall"]
    mix = dict(json.loads((toy.ROOT / "benchmark" / "traffic"
                           / "report_tracks.json").read_text()),
               pool=4, frames_min=300, frames_max=800, calibration_windows=8)
    pool = generate.tracks(config, mix, 2 ** 31 + 3)
    assert sorted(t.shape[1] for t in pool) == sorted(
        generate.track_lengths(mix))
    assert any((t.reshape(3, t.shape[1], -1) == 0).all((0, 2)).any()
               for t in pool)
    graph = get_graph("mediapipe_pose")
    for track in pool:
        mine, spans = ref_serve.windows(track, 300, 150)
        port, port_spans = pipeline.create_sliding_windows(track, 300, 150)
        assert spans == port_spans and np.array_equal(mine, port)
        port_norm = pre_normalization(
            port.copy(), zaxis=graph.zaxis, xaxis=graph.xaxis,
            center_joint=list(graph.center_joint))
        mine_norm = ref_serve.pre_normalize(mine, config["graph"])
        np.testing.assert_allclose(mine_norm, port_norm, rtol=1e-5,
                                   atol=1e-5)
        streams = derive_modalities(port_norm, graph)
        for k, v in ref_serve.streams(mine_norm, config["graph"]).items():
            np.testing.assert_allclose(v, streams[k], rtol=1e-5, atol=1e-5)
    state = report.calibrated_weights(config, mix, pool, 9, "cpu")
    predictor = pipeline.EnsemblePredictor(
        state, model_config=config_from_reference_args(config["model_args"]),
        alpha=config["alpha"], device="cpu")
    served = [pipeline.run_on_landmarks(t, predictor) for t in pool]
    ref = ref_serve.frame_probabilities(pool, state, config, mix, "cpu")
    numbers = checks.report_numbers(
        [dict(r, expected_windows=report.window_count(t.shape[1], mix))
         for r, t in zip(served, pool)], ref)
    assert numbers["shape_mismatches"] == 0
    assert numbers["prob_gap"] < 1e-5
    probs = np.concatenate(ref)
    assert 0.02 < probs.mean() < 0.98, "probabilities saturate"
